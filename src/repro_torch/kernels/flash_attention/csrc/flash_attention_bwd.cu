// Flash-attention backward: dq, dk and dv of masked softmax attention from
// the forward's saved (q, k, v, o, lse), for training.
//
// The kernel counterpart of src/repro/kernels/flash_attention/backward.py::
// _vjp_bwd (line 69), the jnp backward of the custom_vjp around the TPU
// kernel src/repro/kernels/flash_attention/kernel.py::_flash_kernel.  Same
// function, per (batch, head), with G = H / KH query heads per kv head:
//     delta_i = sum_d dO_id O_id
//     P_ij    = exp(scale q_i . k_j - lse_i)  where query i sees key j, else 0
//     dV_j    = sum_i P_ij dO_i
//     dS_ij   = P_ij (dO_i . v_j - delta_i) scale
//     dQ_i    = sum_j dS_ij k_j
//     dK_j    = sum_i dS_ij q_i
// with dK and dV summed over the G query heads of each kv head.  lse is the
// forward kernels' logsumexp in natural-log units (csrc/flash_attention.cu).
// Query i sees key j as in the forward: causal j <= i or j < prefix; window
// i - j < window; neither for bidirectional and cross (Sq != Sk) attention.
// Inputs f32 or bf16, read as f32; every sum in f32; dq, dk, dv in the
// inputs' type.  D 32, 64 or 128.
//
// Bound on an H100 SXM: operations.  The least work is 10 D flops per
// visible (query, key) pair and head (recompute q.k, dO.v; then dV, dK, dQ)
// at the bf16 tensor-core rate of 989 TFLOP/s, against q, k, v, o, dO and
// lse read and dq, dk, dv written once at 3.35 TB/s.  This first kernel
// runs on CUDA cores (at most 67 TFLOP/s of f32) and recomputes the scores
// and dO.v in both of its passes (14 D flops a pair), so it sits well off
// that bound; tensor cores (mma.sync, as the forward's bf16 entry) are the
// next step.  Design, three launches on one stream:
//   * delta: a warp per (batch, position, head) row, rowsum(dO o) into an
//     f32 (B, H, Sq) scratch;
//   * dk/dv: one CTA of 4 warps per (32-key block, kv head, batch row)
//     holds its K and V tiles in shared memory and walks the G query heads
//     and every 32-position query tile that sees the block (causal: from
//     the block's first key on; window: up to its last key + window - 1),
//     so the GQA fold is a sum in registers: no atomics, deterministic;
//   * dq: one CTA per (32-position query block, head, batch row) walks the
//     key tiles its rows see and sums dS K in registers.
// A tile step first computes P and dS for 32 rows x 32 keys (lane = key,
// warp = 8 rows; 16-byte shared loads, K/V rows padded by 4 floats so the
// lanes' vectors fall in distinct banks) into shared memory, then each
// thread adds its share of dK and dV (keys 8w..8w+7, columns lane + 32e) or
// of dQ (rows 8w..8w+7, the same columns).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (repro_torch/kernels/_build.py).  Plain C entry
// point, bound with ctypes by repro_torch/kernels/flash_attention/kernel.py.

#include "../../csrc/common.cuh"

namespace {

using namespace repro_torch;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kT = 32;                // query positions and keys a tile
constexpr int kRows = kT / kWarps;    // rows (or keys) a warp owns in a product
constexpr int kLdp = kT + 4;          // P and dS row stride (floats)

struct Mask {
  int causal, window, prefix;
};

__device__ __forceinline__ bool visible(int i, int j, int Sq, int Sk, const Mask& mk) {
  if (i >= Sq || j >= Sk) return false;
  bool ok = true;
  if (mk.causal) ok = j <= i || j < mk.prefix;
  if (mk.window > 0) ok = ok && i - j < mk.window;
  return ok;
}

// Padded row stride of the K, V, Q and dO tiles: 16-byte rows whose
// stride is 16 bytes past a multiple of 128, so 8 lanes reading rows
// 8n..8n+7 at one column hit distinct banks.
template <int D>
constexpr int kLd = D + 4;

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (4 * kT * kLd<D> + 2 * kT * kLdp + 2 * kT);
}

// kT rows of D elements into dst (row stride kLd<D>, f32); row r at
// src + r * ts; rows >= n are zeros.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int64_t ts, int n) {
  constexpr int VEC = Vec<T>::n;
  constexpr int VPR = D / VEC;
  for (int idx = threadIdx.x; idx < kT * VPR; idx += kThreads) {
    const int r = idx / VPR, c = (idx % VPR) * VEC;
    float f[VEC];
    if (r < n) {
      Vec<T>::unpack(*reinterpret_cast<const uint4*>(src + r * ts + c), f);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) f[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VEC; e += 4)
      *reinterpret_cast<float4*>(dst + r * kLd<D> + c + e) =
          make_float4(f[e], f[e + 1], f[e + 2], f[e + 3]);
  }
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// P and dS of query rows i0.. (Qs, dOs, lse_s, delta_s) against keys j0..
// (Ks, Vs), into Ps and dSs (row r, key j at r * kLdp + j).  Lane = key,
// warp w = rows 8w..8w+7.
template <int D>
__device__ __forceinline__ void p_and_ds(const float* Qs, const float* dOs, const float* Ks,
                                         const float* Vs, const float* lse_s,
                                         const float* delta_s, float* Ps, float* dSs, int i0,
                                         int j0, int Sq, int Sk, const Mask& mk, float scale) {
  constexpr int LD = kLd<D>;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  float s[kRows], dp[kRows];
#pragma unroll
  for (int t = 0; t < kRows; ++t) s[t] = dp[t] = 0.f;
  const float* kr = Ks + lane * LD;
  const float* vr = Vs + lane * LD;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    const float4 kk = *reinterpret_cast<const float4*>(kr + d);
    const float4 vv = *reinterpret_cast<const float4*>(vr + d);
#pragma unroll
    for (int t = 0; t < kRows; ++t) {
      const int r = w * kRows + t;
      s[t] = dot4(*reinterpret_cast<const float4*>(Qs + r * LD + d), kk, s[t]);
      dp[t] = dot4(*reinterpret_cast<const float4*>(dOs + r * LD + d), vv, dp[t]);
    }
  }
  const int j = j0 + lane;
#pragma unroll
  for (int t = 0; t < kRows; ++t) {
    const int r = w * kRows + t;
    const float p = visible(i0 + r, j, Sq, Sk, mk) ? expf(s[t] * scale - lse_s[r]) : 0.f;
    Ps[r * kLdp + lane] = p;
    dSs[r * kLdp + lane] = p * (dp[t] - delta_s[r]) * scale;
  }
}

// rowsum(dO o) of every (batch, position, head) row into delta (B, H, Sq).
template <typename T>
__global__ void __launch_bounds__(kThreads)
delta_kernel(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ delta,
             long long rows, int Sq, int H, int D) {
  const long long r = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;  // warp-uniform
  float s = 0.f;
  for (int d = lane; d < D; d += 32) s += to_f32(o[r * D + d]) * to_f32(dout[r * D + d]);
  s = warp_sum(s);
  if (lane == 0) {
    const long long bi = r / H;
    const int h = (int)(r - bi * H);
    const long long b = bi / Sq;
    const int i = (int)(bi - b * Sq);
    delta[(b * H + h) * Sq + i] = s;
  }
}

// One CTA per (32-key block, kv head, batch row): dK and dV of its keys,
// summed over the G query heads and every query tile that sees them.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const float* __restrict__ lse, const T* __restrict__ dout,
            const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int Sq,
            int Sk, int H, int KH, int64_t q_ts, int64_t k_ts, int64_t v_ts, Mask mk,
            float scale) {
  constexpr int LD = kLd<D>;
  constexpr int DL = D / 32;
  extern __shared__ __align__(16) float smem[];
  float* const Ks = smem;
  float* const Vs = Ks + kT * LD;
  float* const Qs = Vs + kT * LD;
  float* const dOs = Qs + kT * LD;
  float* const Ps = dOs + kT * LD;
  float* const dSs = Ps + kT * kLdp;
  float* const lse_s = dSs + kT * kLdp;
  float* const delta_s = lse_s + kT;

  const int b = blockIdx.z, kh = blockIdx.y;
  const int j0 = blockIdx.x * kT;
  const int nk = min(kT, Sk - j0);
  const int G = H / KH;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  load_tile<T, D>(Ks, k + ((int64_t)b * Sk + j0) * k_ts + (int64_t)kh * D, k_ts, nk);
  load_tile<T, D>(Vs, v + ((int64_t)b * Sk + j0) * v_ts + (int64_t)kh * D, v_ts, nk);

  // Queries that see a key of this block: [i_lo, i_hi].
  const int i_lo = mk.causal && j0 >= mk.prefix ? j0 : 0;
  const int i_hi = mk.window > 0 ? min(Sq - 1, j0 + nk - 1 + mk.window - 1) : Sq - 1;

  float dk_acc[kRows][DL], dv_acc[kRows][DL];
#pragma unroll
  for (int t = 0; t < kRows; ++t)
#pragma unroll
    for (int e = 0; e < DL; ++e) dk_acc[t][e] = dv_acc[t][e] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    for (int i0 = i_lo; i0 <= i_hi; i0 += kT) {
      const int nq = min(kT, Sq - i0);
      __syncthreads();  // the previous tile is consumed
      load_tile<T, D>(Qs, q + ((int64_t)b * Sq + i0) * q_ts + (int64_t)h * D, q_ts, nq);
      load_tile<T, D>(dOs, dout + (((int64_t)b * Sq + i0) * H + h) * D, (int64_t)H * D, nq);
      if (threadIdx.x < kT) {
        const int r = threadIdx.x;
        const int64_t row = ((int64_t)b * H + h) * Sq + i0 + r;
        lse_s[r] = r < nq ? lse[row] : 0.f;
        delta_s[r] = r < nq ? delta[row] : 0.f;
      }
      __syncthreads();
      p_and_ds<D>(Qs, dOs, Ks, Vs, lse_s, delta_s, Ps, dSs, i0, j0, Sq, Sk, mk, scale);
      __syncthreads();
      // keys 8w..8w+7, columns lane + 32e: sum over the tile's rows
#pragma unroll 2
      for (int r = 0; r < kT; ++r) {
        const float4 p0 = *reinterpret_cast<const float4*>(Ps + r * kLdp + w * kRows);
        const float4 p1 = *reinterpret_cast<const float4*>(Ps + r * kLdp + w * kRows + 4);
        const float4 s0 = *reinterpret_cast<const float4*>(dSs + r * kLdp + w * kRows);
        const float4 s1 = *reinterpret_cast<const float4*>(dSs + r * kLdp + w * kRows + 4);
        const float p[kRows] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
        const float ds[kRows] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
#pragma unroll
        for (int e = 0; e < DL; ++e) {
          const float od = dOs[r * LD + lane + 32 * e];
          const float qd = Qs[r * LD + lane + 32 * e];
#pragma unroll
          for (int t = 0; t < kRows; ++t) {
            dv_acc[t][e] = fmaf(p[t], od, dv_acc[t][e]);
            dk_acc[t][e] = fmaf(ds[t], qd, dk_acc[t][e]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int t = 0; t < kRows; ++t) {
    const int key = w * kRows + t;
    if (key >= nk) continue;
    const int64_t off = (((int64_t)b * Sk + j0 + key) * KH + kh) * D;
#pragma unroll
    for (int e = 0; e < DL; ++e) {
      store(dk + off + lane + 32 * e, dk_acc[t][e]);
      store(dv + off + lane + 32 * e, dv_acc[t][e]);
    }
  }
}

// One CTA per (32-position query block, head, batch row): dQ of its rows,
// summed over the key tiles they see.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const float* __restrict__ lse, const T* __restrict__ dout,
          const float* __restrict__ delta, T* __restrict__ dq, int Sq, int Sk, int H, int KH,
          int64_t q_ts, int64_t k_ts, int64_t v_ts, Mask mk, float scale) {
  constexpr int LD = kLd<D>;
  constexpr int DL = D / 32;
  extern __shared__ __align__(16) float smem[];
  float* const Ks = smem;
  float* const Vs = Ks + kT * LD;
  float* const Qs = Vs + kT * LD;
  float* const dOs = Qs + kT * LD;
  float* const Ps = dOs + kT * LD;
  float* const dSs = Ps + kT * kLdp;
  float* const lse_s = dSs + kT * kLdp;
  float* const delta_s = lse_s + kT;

  const int b = blockIdx.z, h = blockIdx.y;
  const int i0 = blockIdx.x * kT;
  const int nq = min(kT, Sq - i0);
  const int kh = h / (H / KH);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  load_tile<T, D>(Qs, q + ((int64_t)b * Sq + i0) * q_ts + (int64_t)h * D, q_ts, nq);
  load_tile<T, D>(dOs, dout + (((int64_t)b * Sq + i0) * H + h) * D, (int64_t)H * D, nq);
  if (threadIdx.x < kT) {
    const int r = threadIdx.x;
    const int64_t row = ((int64_t)b * H + h) * Sq + i0 + r;
    lse_s[r] = r < nq ? lse[row] : 0.f;
    delta_s[r] = r < nq ? delta[row] : 0.f;
  }

  // Keys any row of this block sees: [j_lo, j_hi].
  int j_hi = Sk - 1;
  if (mk.causal) j_hi = min(j_hi, max(i0 + nq - 1, mk.prefix - 1));
  const int j_lo = mk.window > 0 ? max(0, i0 - mk.window + 1) : 0;

  float dq_acc[kRows][DL];
#pragma unroll
  for (int t = 0; t < kRows; ++t)
#pragma unroll
    for (int e = 0; e < DL; ++e) dq_acc[t][e] = 0.f;

  for (int j0 = j_lo; j0 <= j_hi; j0 += kT) {
    const int nk = min(kT, Sk - j0);
    __syncthreads();  // the previous tile is consumed (and Qs, dOs are written)
    load_tile<T, D>(Ks, k + ((int64_t)b * Sk + j0) * k_ts + (int64_t)kh * D, k_ts, nk);
    load_tile<T, D>(Vs, v + ((int64_t)b * Sk + j0) * v_ts + (int64_t)kh * D, v_ts, nk);
    __syncthreads();
    p_and_ds<D>(Qs, dOs, Ks, Vs, lse_s, delta_s, Ps, dSs, i0, j0, Sq, Sk, mk, scale);
    __syncthreads();
    // rows 8w..8w+7, columns lane + 32e: sum over the tile's keys
#pragma unroll 2
    for (int j = 0; j < kT; ++j) {
      float kd[DL];
#pragma unroll
      for (int e = 0; e < DL; ++e) kd[e] = Ks[j * LD + lane + 32 * e];
#pragma unroll
      for (int t = 0; t < kRows; ++t) {
        const float ds = dSs[(w * kRows + t) * kLdp + j];
#pragma unroll
        for (int e = 0; e < DL; ++e) dq_acc[t][e] = fmaf(ds, kd[e], dq_acc[t][e]);
      }
    }
  }
#pragma unroll
  for (int t = 0; t < kRows; ++t) {
    const int r = w * kRows + t;
    if (r >= nq) continue;
    T* out = dq + (((int64_t)b * Sq + i0 + r) * H + h) * D;
#pragma unroll
    for (int e = 0; e < DL; ++e) store(out + lane + 32 * e, dq_acc[t][e]);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* o, const float* lse,
           const void* dout, void* dq, void* dk, void* dv, float* delta, int B, int Sq, int Sk,
           int H, int KH, long long q_ts, long long k_ts, long long v_ts, Mask mk, float scale,
           cudaStream_t stream) {
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* dop = static_cast<const T*>(dout);
  const long long rows = (long long)B * Sq * H;
  delta_kernel<T><<<(unsigned)((rows + kWarps - 1) / kWarps), kThreads, 0, stream>>>(
      static_cast<const T*>(o), dop, delta, rows, Sq, H, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  constexpr size_t smem = smem_bytes<D>();
  auto dkdv = dkdv_kernel<T, D>;
  auto dqk = dq_kernel<T, D>;
  err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dkdv<<<dim3((Sk + kT - 1) / kT, KH, B), kThreads, smem, stream>>>(
      qp, kp, vp, lse, dop, delta, static_cast<T*>(dk), static_cast<T*>(dv), Sq, Sk, H, KH, q_ts,
      k_ts, v_ts, mk, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dqk<<<dim3((Sq + kT - 1) / kT, H, B), kThreads, smem, stream>>>(
      qp, kp, vp, lse, dop, delta, static_cast<T*>(dq), Sq, Sk, H, KH, q_ts, k_ts, v_ts, mk,
      scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(int D, const void* q, const void* k, const void* v, const void* o,
             const float* lse, const void* dout, void* dq, void* dk, void* dv, float* delta,
             int B, int Sq, int Sk, int H, int KH, long long q_ts, long long k_ts,
             long long v_ts, Mask mk, float scale, cudaStream_t stream) {
#define FA_BWD_ARGS \
  q, k, v, o, lse, dout, dq, dk, dv, delta, B, Sq, Sk, H, KH, q_ts, k_ts, v_ts, mk, scale, stream
  switch (D) {
    case 32: return launch<T, 32>(FA_BWD_ARGS);
    case 64: return launch<T, 64>(FA_BWD_ARGS);
    case 128: return launch<T, 128>(FA_BWD_ARGS);
  }
#undef FA_BWD_ARGS
  return -2;
}

}  // namespace

// q: (B, Sq, H, D), k and v: (B, Sk, KH, D), each with unit stride over D, D
// elements between heads and q_ts / k_ts / v_ts elements between tokens
// (batch rows S * ts apart), 16-byte aligned rows (the forward's layouts);
// o and dout: (B, Sq, H, D) contiguous; lse: (B, H, Sq) f32, the forward's
// logsumexp (natural log); dq (B, Sq, H, D), dk and dv (B, Sk, KH, D):
// contiguous outputs; delta: (B, H, Sq) f32 scratch.  dtype 0 = f32, 1 =
// bf16 for q, k, v, o, dout, dq, dk, dv.  D 32, 64 or 128.  Returns 0 or a
// CUDA error code (negative for bad arguments); launches on `stream` and
// does not synchronise.
extern "C" int flash_attention_backward(const void* q, const void* k, const void* v,
                                        const void* o, const float* lse, const void* dout,
                                        void* dq, void* dk, void* dv, float* delta, int B,
                                        int Sq, int Sk, int H, int KH, int D, long long q_ts,
                                        long long k_ts, long long v_ts, int causal, int window,
                                        int prefix, int dtype, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KH <= 0 || H % KH != 0 || B > 65535 || H > 65535)
    return -3;
  const Mask mk{causal, window, prefix};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(D, q, k, v, o, lse, dout, dq, dk, dv, delta, B, Sq, Sk, H, KH, q_ts,
                           k_ts, v_ts, mk, scale, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(D, q, k, v, o, lse, dout, dq, dk, dv, delta, B, Sq, Sk, H,
                                   KH, q_ts, k_ts, v_ts, mk, scale, s);
  return -1;
}
