// Device helpers shared by the port's CUDA kernels: f32 conversions,
// 16-byte vector packing and unpacking, warp reductions, and the Hopper
// tensor-core primitives (inline PTX: cp.async copies into shared memory,
// ldmatrix, bf16 mma.sync m16n8k16 with f32 accumulate, int8 -> bf16).  Included by
// path from each kernel's csrc/; repro_torch/kernels/_build.py keys every
// library on this header's content too.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// 16 bytes <-> 16 / sizeof(T) floats (little-endian: the element at the
// lower address sits in the lower bits); pack rounds to nearest even.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int n = 4;
  static __device__ __forceinline__ void unpack(const uint4& r, float* o) {
    o[0] = __uint_as_float(r.x);
    o[1] = __uint_as_float(r.y);
    o[2] = __uint_as_float(r.z);
    o[3] = __uint_as_float(r.w);
  }
  static __device__ __forceinline__ uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int n = 8;
  static __device__ __forceinline__ void unpack(const uint4& r, float* o) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      o[2 * i] = __uint_as_float(w[i] << 16);
      o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ uint4 pack(const float* f) {
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<const unsigned*>(&h);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};
template <>
struct Vec<int8_t> {
  static constexpr int n = 16;
  static __device__ __forceinline__ void unpack(const uint4& r, float* o) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) o[4 * i + k] = static_cast<float>(static_cast<int8_t>(w[i] >> (8 * k)));
  }
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

// Sum over aligned groups of W lanes (W a power of two up to 32): every
// lane of a group gets its group's sum.  All 32 lanes must take part.
template <int W = 32>
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = W / 2; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// ---------------------------------------------------------------- tensor cores
// cp.async.cg: 16 bytes from global to shared memory, bypassing L1.  With
// `pred` false nothing is read (src-size 0) and the 16 bytes are zeroed, so
// ragged edges land as zeros; `gmem` must still be a valid address.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(pred ? 16 : 0));
}
// cp.async.ca: 4 bytes (a scale), zeroed when `pred` is false.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(pred ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ldmatrix .x4: four 8 x 8 b16 matrices; lanes 8i..8i+7 give the row
// addresses (16 bytes each) of matrix i, and r[i] receives, in lane l, row
// l / 4, columns 2 (l % 4) and 2 (l % 4) + 1 of matrix i (.trans: column
// l / 4, rows 2 (l % 4) and 2 (l % 4) + 1).
__device__ __forceinline__ void ldmatrix_x4(unsigned r[4], const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned r[4], const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// c += a b on the tensor cores, one warp: a 16 x 16 bf16 (row-major
// fragment), b 16 x 8 bf16 (column-major), c 16 x 8 f32.  With g = lane / 4
// and t = lane % 4: a = {(g, 2t..2t+1), (g + 8, 2t..), (g, 2t + 8..),
// (g + 8, 2t + 8..)}; b = {(2t..2t+1, g), (2t + 8.., g)}; c = {(g, 2t),
// (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)}.
__device__ __forceinline__ void mma_bf16_16816(float c[4], const unsigned a[4], unsigned b0,
                                               unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four int8 values (one 32-bit word, the lowest byte first) as two bf16
// pairs, exactly (|v| <= 128 fits bf16's 8 bits of mantissa): each byte
// + 128 becomes the low byte of the float 2^23 + byte, from which 2^23 +
// 128 is subtracted.
__device__ __forceinline__ void int8x4_to_bf16(unsigned w, unsigned& lo, unsigned& hi) {
  const unsigned u = w ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    f[k] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440u | k)) - 8388736.f;
  __nv_bfloat162 a = __floats2bfloat162_rn(f[0], f[1]), b = __floats2bfloat162_rn(f[2], f[3]);
  lo = *reinterpret_cast<const unsigned*>(&a);
  hi = *reinterpret_cast<const unsigned*>(&b);
}

// Two floats as a bf16 pair in one register (lo in the lower half, the
// element of the lower column), rounded to nearest even.
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

}  // namespace repro_torch
