// Paged attention for the unified mixed prefill/decode serve step, read
// straight off the block table.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention/kernel.py::
// _paged_kernel (Pallas, launched by paged_attention_call).  Same function:
// slot b owns the query rows i < q_lens[b] of a W-row slab, row i sits at
// absolute position lens[b] + i and attends to keys j <= lens[b] + i (and
// lens[b] + i - j < window for sliding-window layers), reading K/V pages of
// the pool through the slot's block-table row; int8 pages are dequantized
// here with their per-(token, kv-head) f32 scales; rows i >= q_lens[b] come
// back exactly 0.
//
// Bound on an H100 SXM: bytes.  The least work is reading each live slot's
// K and V pages once per kv head, sum_b ctx_b * KH * D * 2 * bytes, at
// 3.35 TB/s; the arithmetic (4 * D flops per query row per key) is far below
// the card's rate at these shapes.  Design against that bound:
//   * one CTA per (block of slab rows, kv head, slot).  The CTA takes the G
//     query heads of its kv head together (GQA), so every page it loads
//     serves G * rows queries;
//   * the CTA loads its own page ids from the table and walks only the keys
//     its live rows can see, max(0, lens - window + 1) .. lens + q_len - 1:
//     the loop replaces the TPU's sequential table-tile grid axis, and work
//     follows the live context, not the table width;
//   * a CTA whose rows are all dead (decode slots own 1 live row of the
//     slab, idle slots none) writes zeros and exits before touching a page;
//   * tiles of 32 keys are staged in shared memory as f32 (K rows padded to
//     D + 1 floats so lane j reads key j without bank conflicts): the
//     tile's page slots are resolved once, then every thread issues all of
//     its 16-byte loads before using any; the online-softmax state m, l and
//     the f32 accumulator stay in registers.
// It is a simple CUDA-core kernel: no tensor cores, TMA or pipelining yet.
//
// Numerics follow the TPU kernel: scale 1/sqrt(D) (passed in), masked
// scores -1e30, masked probabilities exactly 0 so fully masked rows stay 0,
// l floored at 1e-30, and q rounded to bf16 before the dot for bf16 pages.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (repro_torch/kernels/_build.py).  Plain C entry
// point, bound with ctypes by repro_torch/kernels/paged_attention/kernel.py.

#include <type_traits>

#include "../../csrc/common.cuh"

namespace {

using namespace repro_torch;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 32;        // keys per tile: one per lane
constexpr int kRowsMax = 64;     // query rows (G heads x slab rows) per CTA
constexpr int kRowBlock = 4;     // rows a warp scores together
constexpr int kChunks = kRowsMax / (kWarps * kRowBlock);
constexpr float kNegInf = -1e30f;

// TQ: q / out element type.  TKV: page element type.  DL = D / 32: the
// head-dim elements each lane owns in the accumulator.
template <typename TQ, typename TKV, int DL>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k_pages,
                       const TKV* __restrict__ v_pages, const float* __restrict__ k_scale,
                       const float* __restrict__ v_scale, const int* __restrict__ table,
                       const int* __restrict__ lens, const int* __restrict__ q_lens,
                       TQ* __restrict__ out, int W, int H, int KH, int block_size,
                       int max_blocks, int window, int rows_per_cta, float scale) {
  constexpr int D = DL * 32;
  constexpr bool kQuant = std::is_same<TKV, int8_t>::value;
  constexpr bool kRoundQ = std::is_same<TKV, __nv_bfloat16>::value;
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

  const int base = lens[b];
  const int nl = min(rows_per_cta, q_lens[b] - i0);  // live slab rows here
  const int nrows = nl > 0 ? G * nl : 0;             // live (g, i) rows
  const int rows_here = G * min(rows_per_cta, W - i0);

  // Dead rows of this CTA (all of them when nl <= 0) come back exactly 0.
  for (int idx = nrows * D + tid; idx < rows_here * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    const int i = i0 + r / G, h = kh * G + r % G;
    store(out + ((int64_t)(b * W + i) * H + h) * D + d, 0.f);
  }
  if (nrows == 0) return;

  for (int idx = tid; idx < kRowsMax * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    float x = 0.f;
    if (r < nrows) {
      const int i = i0 + r / G, h = kh * G + r % G;
      x = to_f32(q[((int64_t)(b * W + i) * H + h) * D + d]);
      if (kRoundQ) x = __bfloat162float(__float2bfloat16(x));
    }
    Qs[idx] = x;
  }

  // Keys any live row of this CTA can see.
  int hi = base + i0 + nl - 1;
  hi = min(hi, max_blocks * block_size - 1);
  const int lo = window > 0 ? max(0, base + i0 - window + 1) : 0;
  const int* trow = table + (int64_t)b * max_blocks;

  float m[kChunks][kRowBlock], l[kChunks][kRowBlock], acc[kChunks][kRowBlock][DL];
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int k = 0; k < kRowBlock; ++k) {
      m[c][k] = kNegInf;
      l[c][k] = 0.f;
#pragma unroll
      for (int e = 0; e < DL; ++e) acc[c][k][e] = 0.f;
    }

  // Per tile: the pool slot of each of its keys (-1 past hi) and, for
  // int8 pages, their scales, resolved once.
  __shared__ int64_t slot_s[kTile];
  __shared__ float ksc_s[kTile], vsc_s[kTile];
  constexpr int VEC = Vec<TKV>::n;
  constexpr int VPR = D / VEC;  // 16-byte vectors per key row
  constexpr int NV = kTile * VPR;
  constexpr int NVT = (NV + kThreads - 1) / kThreads;

  for (int t0 = lo; t0 <= hi; t0 += kTile) {
    __syncthreads();  // the previous tile is consumed (and Qs is written)
    if (tid < kTile) {
      const int p = t0 + tid;
      int64_t slot = -1;
      if (p <= hi) slot = ((int64_t)trow[p / block_size] * block_size + p % block_size) * KH + kh;
      slot_s[tid] = slot;
      if (kQuant) {
        ksc_s[tid] = slot >= 0 ? k_scale[slot] : 0.f;
        vsc_s[tid] = slot >= 0 ? v_scale[slot] : 0.f;
      }
    }
    __syncthreads();
    // All of this thread's 16-byte loads are issued before any is used.
    uint4 kr[NVT], vr[NVT];
#pragma unroll
    for (int it = 0; it < NVT; ++it) {
      const int v = tid + it * kThreads;
      kr[it] = vr[it] = make_uint4(0u, 0u, 0u, 0u);
      if (NV % kThreads == 0 || v < NV) {
        const int64_t slot = slot_s[v / VPR];
        if (slot >= 0) {
          const int64_t off = slot * D + (v % VPR) * VEC;
          kr[it] = *reinterpret_cast<const uint4*>(k_pages + off);
          vr[it] = *reinterpret_cast<const uint4*>(v_pages + off);
        }
      }
    }
#pragma unroll
    for (int it = 0; it < NVT; ++it) {
      const int v = tid + it * kThreads;
      if (NV % kThreads == 0 || v < NV) {
        const int j = v / VPR, d0 = (v % VPR) * VEC;
        float kf[VEC], vf[VEC];
        Vec<TKV>::unpack(kr[it], kf);
        Vec<TKV>::unpack(vr[it], vf);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          Ks[j * (D + 1) + d0 + e] = kQuant ? kf[e] * ksc_s[j] : kf[e];
          Vs[j * D + d0 + e] = kQuant ? vf[e] * vsc_s[j] : vf[e];
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
      for (int k = 0; k < kRowBlock; ++k) s[k] = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        const float kd = krow[d];
#pragma unroll
        for (int k = 0; k < kRowBlock; ++k) s[k] += Qs[(rb + k) * D + d] * kd;
      }
      float pr[kRowBlock];
#pragma unroll
      for (int k = 0; k < kRowBlock; ++k) {
        const int r = rb + k;
        const int pos = base + i0 + r / G;
        bool valid = r < nrows && p <= hi && p <= pos;
        if (window > 0) valid = valid && (pos - p < window);
        const float sv = valid ? s[k] * scale : kNegInf;
        const float m_new = fmaxf(m[c][k], warp_max(sv));
        const float pk = valid ? expf(sv - m_new) : 0.f;
        const float corr = expf(m[c][k] - m_new);
        l[c][k] = l[c][k] * corr + warp_sum(pk);
#pragma unroll
        for (int e = 0; e < DL; ++e) acc[c][k][e] *= corr;
        m[c][k] = m_new;
        pr[k] = pk;
      }
#pragma unroll 4
      for (int j = 0; j < kTile; ++j) {
        float vj[DL];
#pragma unroll
        for (int e = 0; e < DL; ++e) vj[e] = Vs[j * D + lane + 32 * e];
#pragma unroll
        for (int k = 0; k < kRowBlock; ++k) {
          const float pj = __shfl_sync(kFull, pr[k], j);
#pragma unroll
          for (int e = 0; e < DL; ++e) acc[c][k][e] += pj * vj[e];
        }
      }
    }
  }

#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int rb = c * kWarps * kRowBlock + warp * kRowBlock;
#pragma unroll
    for (int k = 0; k < kRowBlock; ++k) {
      const int r = rb + k;
      if (r >= nrows) continue;
      const int i = i0 + r / G, h = kh * G + r % G;
      const float inv = 1.f / fmaxf(l[c][k], 1e-30f);
      TQ* o = out + ((int64_t)(b * W + i) * H + h) * D;
#pragma unroll
      for (int e = 0; e < DL; ++e) store(o + lane + 32 * e, acc[c][k][e] * inv);
    }
  }
}

template <typename TQ, typename TKV, int DL>
int launch(const void* q, const void* k_pages, const void* v_pages, const void* k_scale,
           const void* v_scale, const void* table, const void* lens, const void* q_lens,
           void* out, int B, int W, int H, int KH, int block_size, int max_blocks,
           int window, int rows_per_cta, float scale, cudaStream_t stream) {
  constexpr int D = DL * 32;
  const size_t smem = sizeof(float) * (kRowsMax * D + kTile * (D + 1) + kTile * D);
  auto kernel = paged_attention_kernel<TQ, TKV, DL>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + rows_per_cta - 1) / rows_per_cta, KH, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k_pages),
      static_cast<const TKV*>(v_pages), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(table),
      static_cast<const int*>(lens), static_cast<const int*>(q_lens), static_cast<TQ*>(out),
      W, H, KH, block_size, max_blocks, window, rows_per_cta, scale);
  return (int)cudaGetLastError();
}

template <typename TQ, int DL>
int launch_kv(int kv_dtype, const void* q, const void* k_pages, const void* v_pages,
              const void* k_scale, const void* v_scale, const void* table, const void* lens,
              const void* q_lens, void* out, int B, int W, int H, int KH, int block_size,
              int max_blocks, int window, int rows_per_cta, float scale,
              cudaStream_t stream) {
#define PA_ARGS                                                                         \
  q, k_pages, v_pages, k_scale, v_scale, table, lens, q_lens, out, B, W, H, KH, block_size, \
      max_blocks, window, rows_per_cta, scale, stream
  switch (kv_dtype) {
    case 0: return launch<TQ, float, DL>(PA_ARGS);
    case 1: return launch<TQ, __nv_bfloat16, DL>(PA_ARGS);
    case 2: return launch<TQ, int8_t, DL>(PA_ARGS);
  }
#undef PA_ARGS
  return -1;
}

template <typename TQ>
int launch_d(int D, int kv_dtype, const void* q, const void* k_pages, const void* v_pages,
             const void* k_scale, const void* v_scale, const void* table, const void* lens,
             const void* q_lens, void* out, int B, int W, int H, int KH, int block_size,
             int max_blocks, int window, int rows_per_cta, float scale,
             cudaStream_t stream) {
#define PA_ARGS                                                                        \
  kv_dtype, q, k_pages, v_pages, k_scale, v_scale, table, lens, q_lens, out, B, W, H, KH, \
      block_size, max_blocks, window, rows_per_cta, scale, stream
  switch (D) {
    case 32: return launch_kv<TQ, 1>(PA_ARGS);
    case 64: return launch_kv<TQ, 2>(PA_ARGS);
    case 128: return launch_kv<TQ, 4>(PA_ARGS);
  }
#undef PA_ARGS
  return -2;
}

}  // namespace

// q, out: (B, W, H, D) contiguous, f32 (q_dtype 0) or bf16 (1).  Pages
// k, v: (N, block_size, KH, D) f32 (kv_dtype 0), bf16 (1) or int8 (2) with
// (N, block_size, KH, 1) f32 scales for int8 (ignored otherwise); pages
// 16-byte aligned.  table
// (B, max_blocks), lens and q_lens (B,) int32.  G = H / KH query heads per
// kv head; q head h = kh * G + g.  rows_per_cta slab rows per CTA, with
// G * rows_per_cta <= 64.  Returns 0 or a CUDA error code (negative for an
// unsupported D or dtype); launches on `stream` and does not synchronise.
extern "C" int paged_attention_forward(const void* q, const void* k_pages, const void* v_pages,
                                       const void* k_scale, const void* v_scale,
                                       const void* table, const void* lens, const void* q_lens,
                                       void* out, int B, int W, int H, int KH, int D,
                                       int block_size, int max_blocks, int window,
                                       int rows_per_cta, float scale, int q_dtype,
                                       int kv_dtype, void* stream) {
  if (KH <= 0 || H % KH != 0 || rows_per_cta <= 0 || (H / KH) * rows_per_cta > kRowsMax)
    return -3;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0)
    return launch_d<float>(D, kv_dtype, q, k_pages, v_pages, k_scale, v_scale, table, lens,
                           q_lens, out, B, W, H, KH, block_size, max_blocks, window,
                           rows_per_cta, scale, s);
  if (q_dtype == 1)
    return launch_d<__nv_bfloat16>(D, kv_dtype, q, k_pages, v_pages, k_scale, v_scale, table,
                                   lens, q_lens, out, B, W, H, KH, block_size, max_blocks,
                                   window, rows_per_cta, scale, s);
  return -1;
}
