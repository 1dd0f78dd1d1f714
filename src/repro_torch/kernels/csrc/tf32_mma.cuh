// TF32 tensor-core helpers of the WKV kernels (rwkv6/csrc/wkv.cu's
// wkv_forward_mma and rwkv6/csrc/wkv_bwd.cu's wkv_backward_mma): the hi + lo
// split of an f32 operand, ex2, mma.sync m16n8k8 TF32, a shuffle
// reduce-scatter, the mma column order of a channel, and bf16 as TF32 bits.
// Kept in kernels/csrc/ so that repro_torch/kernels/_build.py keys both
// libraries on it.
#pragma once

#include "common.cuh"

namespace repro_torch {

constexpr int kTile = 16;  // tokens of a row tile of the intra-chunk weights
constexpr int kHalf = 8;   // tokens of a diagonal half (per-element weights)

// x = hi + lo as TF32 bit patterns: hi rounded to nearest (ties away from
// zero, as cvt.rna.tf32 rounds a finite x, but in two integer operations),
// lo = x - hi (exact in f32) truncated to TF32, within 2^-21 of x in all.
__device__ __forceinline__ void split_tf32(float x, unsigned& hi, unsigned& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
// c += a b on the tensor cores, one warp: a 16 x 8 TF32 (row), b 8 x 8
// (col), c 16 x 8 f32.  With g = lane / 4, q = lane % 4: a = {(g, q),
// (g + 8, q), (g, q + 4), (g + 8, q + 4)}; b = {(q, g), (q + 4, g)};
// c = {(g, 2q), (g, 2q + 1), (g + 8, 2q), (g + 8, 2q + 1)}.
__device__ __forceinline__ void mma_tf32(float c[4], const unsigned a[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// One level of a reduce-scatter over the lanes: of the 2M values acc[0..2M),
// a lane keeps (summed with lane ^ M's) the half whose index has bit M of
// its lane, in acc[0..M).  After levels 16, 8, 4, 2, 1, lane l holds the sum
// over the warp of value l.  One template per level, so every index is a
// constant and acc stays in registers; the halves swap by bit select.
template <int M>
__device__ __forceinline__ void reduce_scatter(float* acc, int lane) {
  const unsigned up = (lane & M) ? ~0u : 0u;
#pragma unroll
  for (int x = 0; x < M; ++x) {
    const unsigned a = __float_as_uint(acc[x]), c = __float_as_uint(acc[x + M]);
    const float give = __uint_as_float((a & up) | (c & ~up));
    const float keep = __uint_as_float((c & up) | (a & ~up));
    acc[x] = keep + __shfl_xor_sync(kFull, give, M);
  }
}
// Column of channel d in the shared tensor-core operands: inside each group
// of 8, channel 2j sits at j and 2j + 1 at j + 4, so that an mma
// accumulator's two adjacent columns are one A fragment's k and k + 4.
__device__ __forceinline__ int perm8(int d) { return (d & ~7) | ((d & 1) << 2) | ((d & 7) >> 1); }
__device__ __forceinline__ unsigned bf16_bits(__nv_bfloat16 x) {
  return (unsigned)__bfloat16_as_ushort(x) << 16;
}

}  // namespace repro_torch
