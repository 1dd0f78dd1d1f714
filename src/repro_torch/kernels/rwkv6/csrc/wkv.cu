// Chunked RWKV-6 WKV recurrence with its D x D state carried in f32.
//
// Replaces the TPU kernel src/repro/kernels/rwkv6/kernel.py::_wkv_kernel
// (Pallas, launched by wkv_call).  It computes what the model runs,
// repro/models/rwkv6.py::wkv_chunked, in the model layout: per (b, h), with
// decay w_t in (0, 1) per channel, bonus u and state S (D_k x D_v),
//
//     o_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
//     S_t = diag(w_t) S_{t-1} + k_t v_t^T,
//
// from an optional initial state (zero by default), and optionally writes
// the state after the last token (the prefill's decode cache).  r/k/v come
// in f32 or bf16, w in f32, u is (H, D) f32; the output is f32.
//
// Bound on an H100 SXM: at the model's shapes, operations.  The sequential
// recurrence costs ~6 * D^2 flops per token and head in f32 (the state is
// f32, so CUDA cores at 67 TFLOP/s), against reading r, k, v, w and writing
// the f32 output once (~14 bytes per channel at bf16 inputs) at 3.35 TB/s.
// Design against that bound, simple first:
//   * one CTA per (b, h); the TPU's sequential chunk grid axis becomes a
//     loop inside the CTA, and the state lives in shared memory for the
//     whole sequence (16 KB at D = 64), so it never goes to device memory;
//   * per chunk of C tokens: stage r, k, v and log w in shared memory, take
//     the inclusive cumsum L of log w per channel, then
//       intra  att[t][s] = sum_d r[t,d] k[s,d] exp(L_{t-1}[d] - L_s[d]), s < t
//       bonus  att[t][t] = sum_d r[t,d] u[d] k[t,d]
//       out    o[t] = att[t] @ v + (r[t] * exp(L_{t-1})) @ S
//       state  S = diag(exp(L_C)) S + (k * exp(L_C - L))^T v;
//     every exponent is a decay over a span of tokens, <= 0, so nothing
//     overflows however strong the decay (the factored exp(L) * exp(-L)
//     form would; see kernel.py:47-53);
//   * shared rows read down d are padded to D + 1 floats, so the lanes of a
//     warp (one per key s, or per output channel e) hit distinct banks.
// No tensor cores: the exponent-weighted c x c x D contraction is not a
// plain product, and this first version keeps the arithmetic of the plain
// version.  A ragged last chunk is padded with r = k = v = 0, log w = 0,
// which leaves the state and the written outputs unchanged.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (repro_torch/kernels/_build.py).  Plain C entry
// point, bound with ctypes by repro_torch/kernels/rwkv6/kernel.py.

#include "../../csrc/common.cuh"

namespace {

using namespace repro_torch;

constexpr int kThreads = 256;

template <int D, int C>
struct Smem {
  static constexpr int P = D + 1;  // padded row of a C x D array read down d
  static constexpr int S = 0;                  // D x D state
  static constexpr int R = S + D * D;          // C x P  r
  static constexpr int K = R + C * P;          // C x P  k
  static constexpr int L = K + C * P;          // C x P  inclusive cumsum of log w
  static constexpr int LQ = L + C * P;         // C x P  L_{t-1} (log w while loading)
  static constexpr int V = LQ + C * P;         // C x D  v
  static constexpr int RDEC = V + C * D;       // C x D  r * exp(L_{t-1})
  static constexpr int KFUT = RDEC + C * D;    // C x D  k * exp(L_C - L)
  static constexpr int ATT = KFUT + C * D;     // C x (C + 1)
  static constexpr int U = ATT + C * (C + 1);  // D      bonus u[h]
  static constexpr int DEC = U + D;            // D      exp(L_C)
  static constexpr int TOTAL = DEC + D;
};

template <typename T, int D, int C>
__global__ void __launch_bounds__(kThreads)
wkv_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
           const float* __restrict__ w, const float* __restrict__ u,
           const float* __restrict__ state_in, float* __restrict__ out,
           float* __restrict__ state_out, int S, int H) {
  using M = Smem<D, C>;
  constexpr int P = M::P;
  extern __shared__ float smem[];
  float* St = smem + M::S;
  float* Rs = smem + M::R;
  float* Ks = smem + M::K;
  float* Ls = smem + M::L;
  float* Lq = smem + M::LQ;
  float* Vs = smem + M::V;
  float* Rdec = smem + M::RDEC;
  float* Kfut = smem + M::KFUT;
  float* Att = smem + M::ATT;
  float* Us = smem + M::U;
  float* Dec = smem + M::DEC;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  const int64_t sD = (int64_t)H * D;                      // stride of one token
  const int64_t base = (int64_t)b * S * sD + (int64_t)h * D;  // token 0 of (b, h)
  const int64_t sbase = (int64_t)bh * D * D;

  for (int i = tid; i < D * D; i += kThreads) St[i] = state_in ? state_in[sbase + i] : 0.f;
  for (int i = tid; i < D; i += kThreads) Us[i] = u[h * D + i];

  for (int t0 = 0; t0 < S; t0 += C) {
    const int nt = min(C, S - t0);  // live tokens of this chunk
    // 1. stage the chunk (padding rows: r = k = v = 0, log w = 0)
    for (int i = tid; i < C * D; i += kThreads) {
      const int t = i / D, d = i % D;
      float rv = 0.f, kv = 0.f, vv = 0.f, lw = 0.f;
      if (t < nt) {
        const int64_t g = base + (int64_t)(t0 + t) * sD + d;
        rv = to_f32(r[g]);
        kv = to_f32(k[g]);
        vv = to_f32(v[g]);
        lw = logf(fmaxf(w[g], 1e-12f));
      }
      Rs[t * P + d] = rv;
      Ks[t * P + d] = kv;
      Vs[t * D + d] = vv;
      Lq[t * P + d] = lw;
    }
    __syncthreads();
    // 2. inclusive cumsum of log w per channel; L_{t-1} = L_t - log w_t
    for (int d = tid; d < D; d += kThreads) {
      float acc = 0.f;
      for (int t = 0; t < C; ++t) {
        const float lw = Lq[t * P + d];
        acc += lw;
        Ls[t * P + d] = acc;
        Lq[t * P + d] = acc - lw;
      }
      Dec[d] = expf(acc);
    }
    __syncthreads();
    // 3. decayed r and k, and the intra-chunk + bonus weights
    for (int i = tid; i < C * D; i += kThreads) {
      const int t = i / D, d = i % D;
      Rdec[i] = Rs[t * P + d] * expf(Lq[t * P + d]);
      Kfut[i] = Ks[t * P + d] * expf(Ls[(C - 1) * P + d] - Ls[t * P + d]);
    }
    for (int i = tid; i < C * C; i += kThreads) {
      const int t = i / C, s = i % C;
      float a = 0.f;
      if (s < t) {
#pragma unroll 8
        for (int d = 0; d < D; ++d)
          a += Rs[t * P + d] * Ks[s * P + d] * expf(Lq[t * P + d] - Ls[s * P + d]);
      } else if (s == t) {
#pragma unroll 8
        for (int d = 0; d < D; ++d) a += Rs[t * P + d] * Us[d] * Ks[t * P + d];
      }
      Att[t * (C + 1) + s] = a;
    }
    __syncthreads();
    // 4. outputs of the live tokens: att @ v + rdec @ S
    for (int i = tid; i < nt * D; i += kThreads) {
      const int t = i / D, e = i % D;
      float o = 0.f;
#pragma unroll 8
      for (int s = 0; s <= t; ++s) o += Att[t * (C + 1) + s] * Vs[s * D + e];
      float x = 0.f;
#pragma unroll 8
      for (int kk = 0; kk < D; ++kk) x += Rdec[t * D + kk] * St[kk * D + e];
      out[base + (int64_t)(t0 + t) * sD + e] = o + x;
    }
    __syncthreads();
    // 5. carry the state to the end of the chunk
    for (int i = tid; i < D * D; i += kThreads) {
      const int kk = i / D, e = i % D;
      float x = 0.f;
#pragma unroll 8
      for (int s = 0; s < C; ++s) x += Kfut[s * D + kk] * Vs[s * D + e];
      St[i] = Dec[kk] * St[i] + x;
    }
    __syncthreads();
  }
  if (state_out)
    for (int i = tid; i < D * D; i += kThreads) state_out[sbase + i] = St[i];
}

template <typename T, int D, int C>
int launch(const void* r, const void* k, const void* v, const void* w, const void* u,
           const void* state_in, void* out, void* state_out, int B, int S, int H,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * Smem<D, C>::TOTAL;
  auto kernel = wkv_kernel<T, D, C>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B * H, kThreads, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(w), static_cast<const float*>(u),
      static_cast<const float*>(state_in), static_cast<float*>(out),
      static_cast<float*>(state_out), S, H);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_c(int chunk, const void* r, const void* k, const void* v, const void* w,
             const void* u, const void* state_in, void* out, void* state_out, int B, int S,
             int H, cudaStream_t stream) {
  switch (chunk) {
    case 16: return launch<T, D, 16>(r, k, v, w, u, state_in, out, state_out, B, S, H, stream);
    case 32: return launch<T, D, 32>(r, k, v, w, u, state_in, out, state_out, B, S, H, stream);
    case 64: return launch<T, D, 64>(r, k, v, w, u, state_in, out, state_out, B, S, H, stream);
  }
  return -2;
}

template <typename T>
int launch_d(int D, int chunk, const void* r, const void* k, const void* v, const void* w,
             const void* u, const void* state_in, void* out, void* state_out, int B, int S,
             int H, cudaStream_t stream) {
  switch (D) {
    case 32: return launch_c<T, 32>(chunk, r, k, v, w, u, state_in, out, state_out, B, S, H, stream);
    case 64: return launch_c<T, 64>(chunk, r, k, v, w, u, state_in, out, state_out, B, S, H, stream);
  }
  return -2;
}

}  // namespace

// r, k, v: (B, S, H, D) contiguous, f32 (in_dtype 0) or bf16 (1); w: the
// same shape, f32 decay in (0, 1); u: (H, D) f32; state_in (may be null)
// and state_out (may be null): (B, H, D, D) f32; out: (B, S, H, D) f32.
// D in {32, 64}; chunk (tokens per step of the CTA's loop) in {16, 32, 64}.
// Returns 0 or a CUDA error code (negative for an unsupported D, chunk or
// dtype); launches on `stream` and does not synchronise.
extern "C" int wkv_forward(const void* r, const void* k, const void* v, const void* w,
                           const void* u, const void* state_in, void* out, void* state_out,
                           int B, int S, int H, int D, int chunk, int in_dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return -3;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0)
    return launch_d<float>(D, chunk, r, k, v, w, u, state_in, out, state_out, B, S, H, s);
  if (in_dtype == 1)
    return launch_d<__nv_bfloat16>(D, chunk, r, k, v, w, u, state_in, out, state_out, B, S,
                                   H, s);
  return -1;
}
