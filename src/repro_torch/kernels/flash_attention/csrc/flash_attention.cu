// Flash-attention forward: masked softmax attention with an online softmax,
// for the prefill of the eager serving path.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py::
// _flash_kernel (Pallas, launched by flash_attention_call).  Same function:
// q (B, Sq, H, D) attends to k/v (B, Sk, KH, D), q head h reading kv head
// h / G (G = H / KH); query row i sees key j where
//     causal:  j <= i, or j < prefix (prefix-LM: the prefix is bidirectional)
//     window:  i - j < window (window > 0)
// masked scores are -1e30, the softmax runs in f32 with the (m, l, acc)
// carry over key tiles, l is floored at 1e-30, and the output has q's type.
// A row that sees no key at all comes back 0 (no model path makes one).
//
// Bound on an H100 SXM: at the prefill's shapes, operations.  The least
// work is 4 * D flops per visible (query, key) pair and head, at the bf16
// tensor-core rate of 989 TFLOP/s, against reading q, k, v and writing the
// output once at 3.35 TB/s.  This first version runs on CUDA cores in f32
// (67 TFLOP/s at most), so it stays well above that bound; tensor cores
// (mma/wgmma on the 64-row tile) are later work.  Design:
//   * one CTA per (block of query positions, kv head, batch row).  The CTA
//     takes the G query heads of its kv head together (GQA, as the paged
//     kernel does), 64 (position, head) rows in all, so every K/V tile it
//     loads serves 64 rows;
//   * the CTA walks only the key tiles its rows can see: from the window's
//     lower edge to the causal (or prefix) upper edge, never the masked
//     remainder of the sequence;
//   * it reads the model's (B, S, H, D) layout directly, with a token
//     stride per tensor, so q, k and v may be views of the fused QKV
//     projection: the wrapper pays no transpose and no copy;
//   * 32-key tiles are staged in shared memory as f32 with 16-byte vector
//     loads (K rows padded to D + 1 floats so lane j reads key j without
//     bank conflicts); m, l and the f32 accumulator stay in registers;
//     ragged ends (Sq, Sk not multiples of a tile) are masked here.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (repro_torch/kernels/_build.py).  Plain C entry
// point, bound with ctypes by repro_torch/kernels/flash_attention/kernel.py.

#include "../../csrc/common.cuh"

namespace {

using namespace repro_torch;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 32;        // keys per tile: one per lane
constexpr int kRowsMax = 64;     // query rows (G heads x positions) per CTA
constexpr int kRowBlock = 4;     // rows a warp scores together
constexpr int kChunks = kRowsMax / (kWarps * kRowBlock);
constexpr float kNegInf = -1e30f;

// T: element type of q, k, v and out.  DL = D / 32: the head-dim elements
// each lane owns in the accumulator.  q_ts, k_ts, v_ts: elements between
// consecutive tokens of one batch row (heads sit D apart within a token).
template <typename T, int DL>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int Sq, int Sk, int H,
                       int KH, int64_t q_ts, int64_t k_ts, int64_t v_ts, int causal,
                       int window, int prefix, int rows_per_cta, float scale) {
  constexpr int D = DL * 32;
  extern __shared__ float smem[];
  float* Qs = smem;                       // kRowsMax x D
  float* Ks = Qs + kRowsMax * D;          // kTile x (D + 1)
  float* Vs = Ks + kTile * (D + 1);       // kTile x D

  const int b = blockIdx.z;
  const int kh = blockIdx.y;
  const int i0 = blockIdx.x * rows_per_cta;
  const int G = H / KH;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const int nq = min(rows_per_cta, Sq - i0);  // query positions here
  const int nrows = G * nq;                   // (position, head) rows

  for (int idx = tid; idx < kRowsMax * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    float x = 0.f;
    if (r < nrows) {
      const int i = i0 + r / G, h = kh * G + r % G;
      x = to_f32(q[((int64_t)b * Sq + i) * q_ts + (int64_t)h * D + d]);
    }
    Qs[idx] = x;
  }

  // Keys any row of this CTA can see.
  int hi = Sk - 1;
  if (causal) hi = min(hi, max(i0 + nq - 1, prefix - 1));
  const int lo = window > 0 ? max(0, i0 - window + 1) : 0;
  const T* kb = k + (int64_t)b * Sk * k_ts + (int64_t)kh * D;
  const T* vb = v + (int64_t)b * Sk * v_ts + (int64_t)kh * D;

  float m[kChunks][kRowBlock], l[kChunks][kRowBlock], acc[kChunks][kRowBlock][DL];
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int kk = 0; kk < kRowBlock; ++kk) {
      m[c][kk] = kNegInf;
      l[c][kk] = 0.f;
#pragma unroll
      for (int e = 0; e < DL; ++e) acc[c][kk][e] = 0.f;
    }

  constexpr int VEC = Vec<T>::n;
  constexpr int VPR = D / VEC;  // 16-byte vectors per key row
  constexpr int NV = kTile * VPR;
  constexpr int NVT = (NV + kThreads - 1) / kThreads;

  for (int t0 = lo; t0 <= hi; t0 += kTile) {
    __syncthreads();  // the previous tile is consumed (and Qs is written)
    // All of this thread's 16-byte loads are issued before any is used.
    uint4 kr[NVT], vr[NVT];
#pragma unroll
    for (int it = 0; it < NVT; ++it) {
      const int vi = tid + it * kThreads;
      kr[it] = vr[it] = make_uint4(0u, 0u, 0u, 0u);
      const int p = t0 + vi / VPR;
      if ((NV % kThreads == 0 || vi < NV) && p <= hi) {
        const int off = (vi % VPR) * VEC;
        kr[it] = *reinterpret_cast<const uint4*>(kb + p * k_ts + off);
        vr[it] = *reinterpret_cast<const uint4*>(vb + p * v_ts + off);
      }
    }
#pragma unroll
    for (int it = 0; it < NVT; ++it) {
      const int vi = tid + it * kThreads;
      if (NV % kThreads == 0 || vi < NV) {
        const int j = vi / VPR, d0 = (vi % VPR) * VEC;
        float kf[VEC], vf[VEC];
        Vec<T>::unpack(kr[it], kf);
        Vec<T>::unpack(vr[it], vf);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          Ks[j * (D + 1) + d0 + e] = kf[e];
          Vs[j * D + d0 + e] = vf[e];
        }
      }
    }
    __syncthreads();

    const int p = t0 + lane;  // this lane's key
    const float* krow = Ks + lane * (D + 1);
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int rb = c * kWarps * kRowBlock + warp * kRowBlock;
      if (rb >= nrows) continue;  // warp-uniform
      float s[kRowBlock];
#pragma unroll
      for (int kk = 0; kk < kRowBlock; ++kk) s[kk] = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        const float kd = krow[d];
#pragma unroll
        for (int kk = 0; kk < kRowBlock; ++kk) s[kk] += Qs[(rb + kk) * D + d] * kd;
      }
      float pr[kRowBlock];
#pragma unroll
      for (int kk = 0; kk < kRowBlock; ++kk) {
        const int r = rb + kk;
        const int pos = i0 + r / G;
        bool valid = r < nrows && p <= hi;
        if (causal) valid = valid && (p <= pos || p < prefix);
        if (window > 0) valid = valid && (pos - p < window);
        const float sv = valid ? s[kk] * scale : kNegInf;
        const float m_new = fmaxf(m[c][kk], warp_max(sv));
        const float pk = valid ? expf(sv - m_new) : 0.f;
        const float corr = expf(m[c][kk] - m_new);
        l[c][kk] = l[c][kk] * corr + warp_sum(pk);
#pragma unroll
        for (int e = 0; e < DL; ++e) acc[c][kk][e] *= corr;
        m[c][kk] = m_new;
        pr[kk] = pk;
      }
#pragma unroll 4
      for (int j = 0; j < kTile; ++j) {
        float vj[DL];
#pragma unroll
        for (int e = 0; e < DL; ++e) vj[e] = Vs[j * D + lane + 32 * e];
#pragma unroll
        for (int kk = 0; kk < kRowBlock; ++kk) {
          const float pj = __shfl_sync(kFull, pr[kk], j);
#pragma unroll
          for (int e = 0; e < DL; ++e) acc[c][kk][e] += pj * vj[e];
        }
      }
    }
  }

#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int rb = c * kWarps * kRowBlock + warp * kRowBlock;
#pragma unroll
    for (int kk = 0; kk < kRowBlock; ++kk) {
      const int r = rb + kk;
      if (r >= nrows) continue;
      const int i = i0 + r / G, h = kh * G + r % G;
      const float inv = 1.f / fmaxf(l[c][kk], 1e-30f);
      T* o = out + (((int64_t)b * Sq + i) * H + h) * D;
#pragma unroll
      for (int e = 0; e < DL; ++e) store(o + lane + 32 * e, acc[c][kk][e] * inv);
    }
  }
}

template <typename T, int DL>
int launch(const void* q, const void* k, const void* v, void* out, int B, int Sq, int Sk,
           int H, int KH, long long q_ts, long long k_ts, long long v_ts, int causal,
           int window, int prefix, int rows_per_cta, float scale, cudaStream_t stream) {
  constexpr int D = DL * 32;
  const size_t smem = sizeof(float) * (kRowsMax * D + kTile * (D + 1) + kTile * D);
  auto kernel = flash_attention_kernel<T, DL>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + rows_per_cta - 1) / rows_per_cta, KH, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), Sq, Sk, H, KH, q_ts, k_ts, v_ts, causal, window, prefix,
      rows_per_cta, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(int D, const void* q, const void* k, const void* v, void* out, int B, int Sq,
             int Sk, int H, int KH, long long q_ts, long long k_ts, long long v_ts,
             int causal, int window, int prefix, int rows_per_cta, float scale,
             cudaStream_t stream) {
#define FA_ARGS \
  q, k, v, out, B, Sq, Sk, H, KH, q_ts, k_ts, v_ts, causal, window, prefix, rows_per_cta, scale, stream
  switch (D) {
    case 32: return launch<T, 1>(FA_ARGS);
    case 64: return launch<T, 2>(FA_ARGS);
    case 128: return launch<T, 4>(FA_ARGS);
  }
#undef FA_ARGS
  return -2;
}

}  // namespace

// q: (B, Sq, H, D), k and v: (B, Sk, KH, D), each with unit stride over D,
// D elements between heads and q_ts / k_ts / v_ts elements between tokens
// (batch rows S * ts apart), 16-byte aligned rows; out: (B, Sq, H, D)
// contiguous.  All f32 (dtype 0) or all bf16 (1).  G = H / KH query heads
// per kv head; q head h = kh * G + g.  rows_per_cta query positions per
// CTA, with G * rows_per_cta <= 64.  Returns 0 or a CUDA error code
// (negative for an unsupported D, dtype or grouping); launches on `stream`
// and does not synchronise.
extern "C" int flash_attention_forward(const void* q, const void* k, const void* v, void* out,
                                       int B, int Sq, int Sk, int H, int KH, int D,
                                       long long q_ts, long long k_ts, long long v_ts,
                                       int causal, int window, int prefix, int rows_per_cta,
                                       float scale, int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KH <= 0 || H % KH != 0 || rows_per_cta <= 0 ||
      (H / KH) * rows_per_cta > kRowsMax)
    return -3;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(D, q, k, v, out, B, Sq, Sk, H, KH, q_ts, k_ts, v_ts, causal,
                           window, prefix, rows_per_cta, scale, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(D, q, k, v, out, B, Sq, Sk, H, KH, q_ts, k_ts, v_ts,
                                   causal, window, prefix, rows_per_cta, scale, s);
  return -1;
}
