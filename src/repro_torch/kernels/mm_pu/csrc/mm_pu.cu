// MM PU: (M, K) @ (K, N) with f32 accumulation and a fused epilogue, for
// the int8 weight-only FFN stage and the mm_pu entry point.
//
// Replaces the TPU kernel src/repro/kernels/mm_pu/kernel.py::_mm_kernel
// (Pallas, launched by mm_pu_call).  Same function:
//     acc = x @ w                     (f32; int8 w converted to f32)
//     out = act(acc * w_scale[n] + bias[n]) + residual[m, n]
// each term optional, in this order, cast to the output type; act is
// gelu (tanh form), silu, relu, relu^2 or none.
//
// Bound on an H100 SXM: at the FFN stage's shapes, operations: 2 M N K
// flops.  For bf16 x with int8 or bf16 w every operand is exact in bf16 and
// every product exact in f32, so the reference's f32 product is what a bf16
// tensor-core mma with f32 accumulate gives, at 989 TFLOP/s; bytes (x, w,
// the output, each once) take far less at 3.35 TB/s.  This first version
// runs f32 FMAs on CUDA cores (67 TFLOP/s at most), which f32 x needs in
// any case (the reference holds it to 1e-5, which TF32 would miss).
// Design:
//   * one 128 x 128 output tile per 256-thread CTA, 8 x 8 outputs per
//     thread held in registers (two 4 x 4 blocks 64 rows/columns apart, so
//     the shared-memory reads are float4 and free of bank conflicts);
//   * K walked in 16-deep slices staged in shared memory as f32, x stored
//     k-major; each thread loads the next slice from device memory into
//     registers before it computes on the current one;
//   * int8 w is converted to f32 as it is staged (weight-only int8: the
//     reference upcasts both operands, so this is no s8 x s8 product), and
//     the per-column scale multiplies each output once, in the epilogue, as
//     the TPU kernel does;
//   * ragged M, N and K are masked in the loads (zeros) and the stores, so
//     the wrapper pads nothing (the JAX wrapper pads to tile multiples);
//   * only the operand types are template parameters; bias, residual,
//     activation and the output type are runtime flags read in the
//     epilogue, so four instantiations cover every call.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (repro_torch/kernels/_build.py).  Plain C entry
// point, bound with ctypes by repro_torch/kernels/mm_pu/kernel.py.

#include "../../csrc/common.cuh"

namespace {

using namespace repro_torch;

constexpr int BM = 128, BN = 128, BK = 16;
constexpr int kThreads = 256;
constexpr int XPAD = 4;                      // Xs row padding: 2-way staging conflicts at most
constexpr int XL = BM * BK / kThreads;       // x values a thread stages per slice (8)
constexpr int WL = BK * BN / kThreads;       // w values a thread stages per slice (8)

enum Act { kNone = 0, kGelu = 1, kSilu = 2, kRelu = 3, kRelu2 = 4 };

__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case kGelu: {
      const float c = 0.7978845608028654f;  // sqrt(2 / pi)
      return v * (0.5f * (1.f + tanhf(c * (v + 0.044715f * (v * v * v)))));
    }
    case kSilu:
      return v / (1.f + expf(-v));
    case kRelu:
      return fmaxf(v, 0.f);
    case kRelu2: {
      const float r = fmaxf(v, 0.f);
      return r * r;
    }
  }
  return v;
}

// Slice k0 of x and w into registers, zeros outside (M, K) and (K, N).
// x: thread t stages k = t % 16 of rows t / 16 + 16 e; w: k = t / 16 of
// columns t % 16 + 16 e (e < 8): neighbouring threads read neighbouring
// addresses.
template <typename TX, typename TW>
__device__ __forceinline__ void load_slice(const TX* __restrict__ x, const TW* __restrict__ w,
                                           int M, int N, int K, int m0, int n0, int k0,
                                           float* xr, float* wr) {
  const int t = threadIdx.x;
  const int xk = k0 + (t & 15), wk = k0 + (t >> 4);
#pragma unroll
  for (int e = 0; e < XL; ++e) {
    const int m = m0 + (t >> 4) + 16 * e;
    xr[e] = (m < M && xk < K) ? to_f32(x[(long long)m * K + xk]) : 0.f;
  }
#pragma unroll
  for (int e = 0; e < WL; ++e) {
    const int n = n0 + (t & 15) + 16 * e;
    wr[e] = (wk < K && n < N) ? to_f32(w[(long long)wk * N + n]) : 0.f;
  }
}

template <typename TX, typename TW>
__global__ void __launch_bounds__(kThreads)
mm_pu_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
             const float* __restrict__ w_scale, const float* __restrict__ bias,
             const void* __restrict__ res, void* __restrict__ out, int M, int N, int K, int act,
             int res_bf16, int out_bf16) {
  __shared__ __align__(16) float Xs[BK][BM + XPAD];
  __shared__ __align__(16) float Ws[BK][BN];
  const int t = threadIdx.x;
  const int tx = t & 15, ty = t >> 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  float xr[XL], wr[WL];
  load_slice(x, w, M, N, K, m0, n0, 0, xr, wr);
  const int nk = (K + BK - 1) / BK;
  for (int s = 0; s < nk; ++s) {
#pragma unroll
    for (int e = 0; e < XL; ++e) Xs[t & 15][(t >> 4) + 16 * e] = xr[e];
#pragma unroll
    for (int e = 0; e < WL; ++e) Ws[t >> 4][(t & 15) + 16 * e] = wr[e];
    __syncthreads();
    if (s + 1 < nk) load_slice(x, w, M, N, K, m0, n0, (s + 1) * BK, xr, wr);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&Xs[kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&Xs[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Ws[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Ws[kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (n >= N) continue;
      float v = acc[i][j];
      if (w_scale != nullptr) v *= w_scale[n];
      if (bias != nullptr) v += bias[n];
      v = activate(v, act);
      const long long o = (long long)m * N + n;
      if (res != nullptr)
        v += res_bf16 ? to_f32(static_cast<const __nv_bfloat16*>(res)[o])
                      : static_cast<const float*>(res)[o];
      if (out_bf16)
        store(static_cast<__nv_bfloat16*>(out) + o, v);
      else
        store(static_cast<float*>(out) + o, v);
    }
  }
}

template <typename TX, typename TW>
int launch(const void* x, const void* w, const void* w_scale, const void* bias,
           const void* res, void* out, int M, int N, int K, int act, int res_bf16,
           int out_bf16, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  mm_pu_kernel<TX, TW><<<grid, kThreads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w),
      static_cast<const float*>(w_scale), static_cast<const float*>(bias), res, out, M, N, K,
      act, res_bf16, out_bf16);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (M, K) row-major; w: (K, N) row-major; w_scale, bias: N f32 each or
// null; residual: (M, N) row-major or null; out: (M, N) row-major.  Types:
// 0 = f32, 1 = bf16, 2 = int8 (w only).  w is x's type, or int8 with a
// w_scale.  act: 0 none, 1 gelu (tanh), 2 silu, 3 relu, 4 relu^2.  Returns
// 0 or a CUDA error code (negative for bad arguments); launches on `stream`
// and does not synchronise.
extern "C" int mm_pu_forward(const void* x, const void* w, const void* w_scale,
                             const void* bias, const void* residual, void* out, int M, int N,
                             int K, int x_dtype, int w_dtype, int res_dtype, int out_dtype,
                             int act, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || act < kNone || act > kRelu2) return -3;
  if ((res_dtype != 0 && res_dtype != 1) || (out_dtype != 0 && out_dtype != 1)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MM_ARGS x, w, w_scale, bias, residual, out, M, N, K, act, res_dtype, out_dtype, s
  if (w_dtype == 2 && w_scale == nullptr) return -1;
  if (x_dtype == 0 && w_dtype == 0) return launch<float, float>(MM_ARGS);
  if (x_dtype == 1 && w_dtype == 1) return launch<__nv_bfloat16, __nv_bfloat16>(MM_ARGS);
  if (x_dtype == 0 && w_dtype == 2) return launch<float, int8_t>(MM_ARGS);
  if (x_dtype == 1 && w_dtype == 2) return launch<__nv_bfloat16, int8_t>(MM_ARGS);
#undef MM_ARGS
  return -1;
}
