// RMSNorm over the last axis, optionally of x + residual: the model's norm
// on both serving paths (every layer's two norms, qk-norm, the final norm).
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm/kernel.py::
// _rmsnorm_kernel (Pallas, launched by rmsnorm_call).  Same function, row
// by row, in f32:
//     s = x [+ r]
//     y = s * rsqrt(mean(s^2) + eps) * (1 + scale)
// cast to x's type.  The sum s is not returned (as in the TPU kernel).
//
// Bound on an H100 SXM: bytes.  About 4 flops per element against 4 (bf16)
// or 8 (f32) bytes moved: x read once and y written once (r read once) at
// 3.35 TB/s; scale is d floats that every row reads from L2.  Design:
//   * one warp per row, 8 rows per 256-thread CTA: no shared memory and no
//     barrier, the sum of squares is a per-lane f32 sum reduced by
//     shuffles, and the card keeps 64 warps of loads in flight per SM;
//   * 16-byte vector loads and stores when every row starts 16-byte
//     aligned and d fills whole vectors (every width the model uses: d_model
//     576 to 12288, d_head 128); otherwise one element per lane per step
//     (e.g. d = 33 f32, whose rows start 132 bytes apart);
//   * a lane keeps the first NV vectors it loads in registers (NV up to 16:
//     a whole row up to d = 4096 bf16 / 2048 f32), so such a row is read
//     from device memory once; a wider row re-reads the rest in the second
//     pass, from L1/L2, which the warp filled a moment before;
//   * rows are indexed (outer, inner) with an element stride each, so the
//     qk-norm input, a (B, S, H, D) view of the fused QKV projection whose
//     tokens sit (H + 2 KV) D elements apart, is read in place with no
//     copy.  The output (and the residual) is dense: row r at r * d.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (repro_torch/kernels/_build.py).  Plain C entry
// point, bound with ctypes by repro_torch/kernels/rmsnorm/kernel.py.

#include "../../csrc/common.cuh"

namespace {

using namespace repro_torch;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

// Row r = o * inner + i of x starts at o * so + i * si elements.
struct Rows {
  long long n;
  int inner;
  long long so, si;
};

template <typename T>
__device__ __forceinline__ const T* row_start(const T* x, const Rows& rows, long long r) {
  const long long o = r / rows.inner;
  return x + o * rows.so + (r - o * rows.inner) * rows.si;
}

// Vector j of the row as floats, plus the residual's vector j.
template <typename T>
__device__ __forceinline__ void widen(const uint4& raw, const T* rr, int j, float* f) {
  constexpr int VEC = Vec<T>::n;
  Vec<T>::unpack(raw, f);
  if (rr != nullptr) {
    float g[VEC];
    Vec<T>::unpack(*reinterpret_cast<const uint4*>(rr + j * VEC), g);
#pragma unroll
    for (int e = 0; e < VEC; ++e) f[e] += g[e];
  }
}

template <typename T>
__device__ __forceinline__ void finish(float* f, const float* __restrict__ scale, int j,
                                       float inv, T* yr) {
  constexpr int VEC = Vec<T>::n;
  float s[VEC];
#pragma unroll
  for (int q = 0; q < VEC / 4; ++q) {
    const float4 s4 = *reinterpret_cast<const float4*>(scale + j * VEC + 4 * q);
    s[4 * q] = s4.x;
    s[4 * q + 1] = s4.y;
    s[4 * q + 2] = s4.z;
    s[4 * q + 3] = s4.w;
  }
#pragma unroll
  for (int e = 0; e < VEC; ++e) f[e] = f[e] * inv * (1.f + s[e]);
  *reinterpret_cast<uint4*>(yr + j * VEC) = Vec<T>::pack(f);
}

// 16-byte vectors; each lane holds its first NV vectors in registers.
template <typename T, int NV>
__global__ void __launch_bounds__(kThreads)
rmsnorm_vec_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                   const T* __restrict__ res, T* __restrict__ out, Rows rows, int d, float eps) {
  constexpr int VEC = Vec<T>::n;
  const int lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= rows.n) return;  // warp-uniform
  const T* xr = row_start(x, rows, r);
  const T* rr = res != nullptr ? res + r * d : nullptr;
  T* yr = out + r * d;
  const int nvec = d / VEC;

  uint4 held[NV];
  float ss = 0.f;
#pragma unroll
  for (int t = 0; t < NV; ++t) {
    const int j = lane + 32 * t;
    if (j < nvec) {
      held[t] = *reinterpret_cast<const uint4*>(xr + j * VEC);
      float f[VEC];
      widen(held[t], rr, j, f);
#pragma unroll
      for (int e = 0; e < VEC; ++e) ss += f[e] * f[e];
    }
  }
  for (int j = lane + 32 * NV; j < nvec; j += 32) {
    float f[VEC];
    widen(*reinterpret_cast<const uint4*>(xr + j * VEC), rr, j, f);
#pragma unroll
    for (int e = 0; e < VEC; ++e) ss += f[e] * f[e];
  }
  const float inv = 1.f / sqrtf(warp_sum(ss) / (float)d + eps);

#pragma unroll
  for (int t = 0; t < NV; ++t) {
    const int j = lane + 32 * t;
    if (j < nvec) {
      float f[VEC];
      widen(held[t], rr, j, f);
      finish(f, scale, j, inv, yr);
    }
  }
  for (int j = lane + 32 * NV; j < nvec; j += 32) {
    float f[VEC];
    widen(*reinterpret_cast<const uint4*>(xr + j * VEC), rr, j, f);
    finish(f, scale, j, inv, yr);
  }
}

// One element per lane per step: rows of any alignment and width.
template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_scalar_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                      const T* __restrict__ res, T* __restrict__ out, Rows rows, int d,
                      float eps) {
  const int lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= rows.n) return;
  const T* xr = row_start(x, rows, r);
  const T* rr = res != nullptr ? res + r * d : nullptr;
  T* yr = out + r * d;
  float ss = 0.f;
  for (int j = lane; j < d; j += 32) {
    const float f = to_f32(xr[j]) + (rr != nullptr ? to_f32(rr[j]) : 0.f);
    ss += f * f;
  }
  const float inv = 1.f / sqrtf(warp_sum(ss) / (float)d + eps);
  for (int j = lane; j < d; j += 32) {
    const float f = to_f32(xr[j]) + (rr != nullptr ? to_f32(rr[j]) : 0.f);
    store(yr + j, f * inv * (1.f + scale[j]));
  }
}

template <typename T>
int launch(const void* x, const void* scale, const void* res, void* out, Rows rows, int d,
           float eps, int vec, cudaStream_t stream) {
  const unsigned grid = (unsigned)((rows.n + kWarps - 1) / kWarps);
  const T* xp = static_cast<const T*>(x);
  const float* sp = static_cast<const float*>(scale);
  const T* rp = static_cast<const T*>(res);
  T* op = static_cast<T*>(out);
  if (!vec) {
    rmsnorm_scalar_kernel<T><<<grid, kThreads, 0, stream>>>(xp, sp, rp, op, rows, d, eps);
  } else {
    const int per_lane = (d / Vec<T>::n + 31) / 32;
#define RMS_LAUNCH(NV) \
  rmsnorm_vec_kernel<T, NV><<<grid, kThreads, 0, stream>>>(xp, sp, rp, op, rows, d, eps)
    if (per_lane <= 1)
      RMS_LAUNCH(1);
    else if (per_lane <= 2)
      RMS_LAUNCH(2);
    else if (per_lane <= 4)
      RMS_LAUNCH(4);
    else if (per_lane <= 8)
      RMS_LAUNCH(8);
    else
      RMS_LAUNCH(16);
#undef RMS_LAUNCH
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x: rows (outer, inner) of d elements with unit stride, row (o, i) at
// o * so + i * si elements from x; residual (may be null) and out: dense
// (outer * inner, d); scale: d f32.  dtype 0 = f32, 1 = bf16 for x,
// residual and out.  vec != 0 promises 16-byte aligned rows (x, residual,
// out, scale) and d a multiple of 16 bytes.  Returns 0 or a CUDA error
// code (negative for bad arguments); launches on `stream` and does not
// synchronise.
extern "C" int rmsnorm_forward(const void* x, const void* scale, const void* residual,
                               void* out, long long outer, int inner, int d, long long so,
                               long long si, float eps, int vec, int dtype, void* stream) {
  if (outer <= 0 || inner <= 0 || d <= 0) return -3;
  const Rows rows{outer * inner, inner, so, si};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, scale, residual, out, rows, d, eps, vec, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, scale, residual, out, rows, d, eps, vec, s);
  return -1;
}
