// RMSNorm backward: dx and d(scale) of the model's norm, for training.
//
// The gradient of the function src/repro/kernels/rmsnorm/kernel.py::
// _rmsnorm_kernel computes (the JAX package takes it by autodiff of
// repro.models.layers.rmsnorm; the forward kernel is csrc/rmsnorm.cu).
// Row by row, in f32, with s = x [+ r], inv = 1 / sqrt(mean(s^2) + eps)
// (the forward's), w = 1 + scale and g = dy w:
//     dx       = inv g - s inv^3 mean(g s)     (also d(residual))
//     d(scale) = sum over rows of dy s inv
// dx in x's type; d(scale) f32.
//
// Bound on an H100 SXM: bytes.  About 10 flops per element against x and
// dy read and dx written once (4 + 2 bytes per element and pass in bf16) at
// 3.35 TB/s.  Three launches on one stream:
//   * dx: a warp a row, 16-byte vectors where the rows allow (else one
//     element a lane a step): one pass sums s^2 and g s, the second writes
//     dx (the row is re-read from L1/L2); each row's inv goes to an f32
//     scratch;
//   * d(scale) partials: CTAs of 32 columns x 8 row lanes, each summing
//     dy s inv over a chunk of rows (coalesced 32-column loads), reduced
//     over the 8 lanes in a fixed order into a (chunks, d) scratch;
//   * d(scale): the chunks summed in order.  No atomics: the result is
//     the same on every run.
// The d(scale) pass reads x and dy a second time: twice the byte bound's
// reads, the price of a deterministic column sum in a simple kernel.
// x is read in the forward's strided layout (rows (outer, inner) with an
// element stride each: qk-norm's q and k views of the fused projection);
// dy, the residual and dx are dense.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (repro_torch/kernels/_build.py).  Plain C entry
// point, bound with ctypes by repro_torch/kernels/rmsnorm/kernel.py.

#include "../../csrc/common.cuh"

namespace {

using namespace repro_torch;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kCols = 32;   // columns of a d(scale) CTA
constexpr int kLanes = 8;   // row lanes of a d(scale) CTA

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

// Elements j*VEC .. j*VEC + VEC - 1 of a row as floats: one 16-byte load
// (VEC == Vec<T>::n), or one element (VEC == 1).
template <typename T, int VEC>
__device__ __forceinline__ void load(const T* p, int j, float* f) {
  if constexpr (VEC == 1) {
    f[0] = to_f32(p[j]);
  } else {
    Vec<T>::unpack(*reinterpret_cast<const uint4*>(p + j * VEC), f);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, int j, const float* f) {
  if constexpr (VEC == 1) {
    store(p + j, f[0]);
  } else {
    *reinterpret_cast<uint4*>(p + j * VEC) = Vec<T>::pack(f);
  }
}

// s (= x [+ r]) and w (= 1 + scale) of vector j.
template <typename T, int VEC>
__device__ __forceinline__ void s_and_w(const T* xr, const T* rr, const float* scale, int j,
                                        float* s, float* w) {
  load<T, VEC>(xr, j, s);
  if (rr != nullptr) {
    float g[VEC];
    load<T, VEC>(rr, j, g);
#pragma unroll
    for (int e = 0; e < VEC; ++e) s[e] += g[e];
  }
#pragma unroll
  for (int e = 0; e < VEC; ++e) w[e] = 1.f + scale[j * VEC + e];
}

// A warp a row: dx and the row's inv.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
dx_kernel(const T* __restrict__ x, const float* __restrict__ scale, const T* __restrict__ res,
          const T* __restrict__ dy, T* __restrict__ dx, float* __restrict__ rstd, Rows rows,
          int d, float eps) {
  const long long r = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= rows.n) return;  // warp-uniform
  const T* xr = row_start(x, rows, r);
  const T* rr = res != nullptr ? res + r * d : nullptr;
  const T* gr = dy + r * d;
  const int n = d / VEC;
  float ss = 0.f, gs = 0.f;
  for (int j = lane; j < n; j += 32) {
    float s[VEC], w[VEC], g[VEC];
    s_and_w<T, VEC>(xr, rr, scale, j, s, w);
    load<T, VEC>(gr, j, g);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      ss += s[e] * s[e];
      gs += g[e] * w[e] * s[e];
    }
  }
  const float inv = 1.f / sqrtf(warp_sum(ss) / (float)d + eps);
  const float c = inv * inv * inv * warp_sum(gs) / (float)d;
  if (lane == 0) rstd[r] = inv;
  T* out = dx + r * d;
  for (int j = lane; j < n; j += 32) {
    float s[VEC], w[VEC], g[VEC];
    s_and_w<T, VEC>(xr, rr, scale, j, s, w);
    load<T, VEC>(gr, j, g);
#pragma unroll
    for (int e = 0; e < VEC; ++e) g[e] = inv * g[e] * w[e] - s[e] * c;
    store_vec<T, VEC>(out, j, g);
  }
}

// Partial d(scale) of columns blockIdx.x * 32 + tx over the rows of chunk
// blockIdx.y, into partial[chunk][column].
template <typename T>
__global__ void __launch_bounds__(kCols * kLanes)
dscale_partial_kernel(const T* __restrict__ x, const T* __restrict__ res,
                      const T* __restrict__ dy, const float* __restrict__ rstd,
                      float* __restrict__ partial, Rows rows, int d, long long rows_a_chunk) {
  __shared__ float sum[kLanes][kCols];
  const int tx = threadIdx.x % kCols, ty = threadIdx.x / kCols;
  const int c = blockIdx.x * kCols + tx;
  const long long r0 = blockIdx.y * rows_a_chunk;
  const long long r1 = min(rows.n, r0 + rows_a_chunk);
  float acc = 0.f;
  if (c < d) {
    for (long long r = r0 + ty; r < r1; r += kLanes) {
      float s = to_f32(row_start(x, rows, r)[c]);
      if (res != nullptr) s += to_f32(res[r * d + c]);
      acc += to_f32(dy[r * d + c]) * s * rstd[r];
    }
  }
  sum[ty][tx] = acc;
  __syncthreads();
  if (ty == 0 && c < d) {
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < kLanes; ++k) t += sum[k][tx];
    partial[blockIdx.y * (long long)d + c] = t;
  }
}

// d(scale)[c] = the chunks' partial sums, in chunk order.
__global__ void __launch_bounds__(kThreads)
dscale_kernel(const float* __restrict__ partial, float* __restrict__ dscale, int d, int chunks) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= d) return;
  float t = 0.f;
  for (int k = 0; k < chunks; ++k) t += partial[(long long)k * d + c];
  dscale[c] = t;
}

template <typename T>
int launch(const void* x, const void* scale, const void* res, const void* dy, void* dx,
           float* rstd, float* partial, float* dscale, Rows rows, int d, float eps, int vec,
           int chunks, cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const T* rp = static_cast<const T*>(res);
  const T* gp = static_cast<const T*>(dy);
  const float* sp = static_cast<const float*>(scale);
  const unsigned grid = (unsigned)((rows.n + kWarps - 1) / kWarps);
  if (vec)
    dx_kernel<T, Vec<T>::n><<<grid, kThreads, 0, stream>>>(xp, sp, rp, gp, static_cast<T*>(dx),
                                                           rstd, rows, d, eps);
  else
    dx_kernel<T, 1><<<grid, kThreads, 0, stream>>>(xp, sp, rp, gp, static_cast<T*>(dx), rstd,
                                                   rows, d, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long per = (rows.n + chunks - 1) / chunks;
  dscale_partial_kernel<T><<<dim3((d + kCols - 1) / kCols, chunks), kCols * kLanes, 0, stream>>>(
      xp, rp, gp, rstd, partial, rows, d, per);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dscale_kernel<<<(d + kThreads - 1) / kThreads, kThreads, 0, stream>>>(partial, dscale, d,
                                                                       chunks);
  return (int)cudaGetLastError();
}

}  // namespace

// x: rows (outer, inner) of d elements with unit stride, row (o, i) at
// o * so + i * si elements from x; residual (may be null), dy and dx: dense
// (outer * inner, d); scale: d f32; rstd: outer * inner f32 scratch;
// partial: (chunks, d) f32 scratch; dscale: d f32 output.  dtype 0 = f32,
// 1 = bf16 for x, residual, dy and dx.  vec != 0 promises 16-byte aligned
// rows (x, residual, dy) and d a multiple of 16 bytes.  Returns 0 or a
// CUDA error code (negative for bad arguments); launches on `stream` and
// does not synchronise.
extern "C" int rmsnorm_backward(const void* x, const void* scale, const void* residual,
                                const void* dy, void* dx, float* rstd, float* partial,
                                float* dscale, long long outer, int inner, int d, long long so,
                                long long si, float eps, int vec, int dtype, int chunks,
                                void* stream) {
  if (outer <= 0 || inner <= 0 || d <= 0 || chunks <= 0 || chunks > 65535) return -3;
  const Rows rows{outer * inner, inner, so, si};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, scale, residual, dy, dx, rstd, partial, dscale, rows, d, eps, vec,
                         chunks, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, scale, residual, dy, dx, rstd, partial, dscale, rows, d,
                                 eps, vec, chunks, s);
  return -1;
}
