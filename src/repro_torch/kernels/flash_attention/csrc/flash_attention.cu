// Flash-attention forward: masked softmax attention with an online softmax,
// for the prefill of the eager serving path.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py::
// _flash_kernel (Pallas, launched by flash_attention_call).  Same function:
// q (B, Sq, H, D) attends to k/v (B, Sk, KH, D), q head h reading kv head
// h / G (G = H / KH), D 32, 64, 128 or 256; query row i sees key j where
//     causal:  j <= i, or j < prefix (prefix-LM: the prefix is bidirectional)
//     window:  i - j < window (window > 0)
// and every key j < Sk with neither (bidirectional encoders, and decoder ->
// encoder cross-attention, where Sq != Sk and Sq may be 1).
// masked scores are -1e30, the softmax runs in f32 with the (m, l, acc)
// carry over key tiles, l is floored at 1e-30, and the output has q's type.
// A row that sees no key at all comes back 0 (no model path makes one).
// Given an lse buffer (training: ops.FlashAttention saves it for the
// backward kernel, csrc/flash_attention_bwd.cu), each entry also writes
// every row's logsumexp of its scaled, masked scores, in natural-log units
// (the bf16 entry keeps its running max in log2 units and converts once, at
// the store); the serving paths pass null and nothing is written.
//
// Bound on an H100 SXM: at the prefill's shapes, operations.  The least
// work is 4 * D flops per visible (query, key) pair and head, at the bf16
// tensor-core rate of 989 TFLOP/s, against reading q, k, v and writing the
// output once at 3.35 TB/s.  Two kernels, chosen by the wrapper from the
// dtype alone (ops.flash_attention; never a fallback):
//
// bf16 (flash_attention_forward_mma, the model's path): tensor cores.
//   * one CTA of 4 warps per (64 (position, head) rows of one kv head,
//     batch row): the G query heads of a kv head go together (GQA), so every
//     K/V tile serves 64 rows; each warp owns 16 rows;
//   * q is copied once into shared memory (cp.async), then, up to D 128,
//     held in registers as mma A fragments (ldmatrix).  At D 256 the
//     output accumulator alone takes 128 f32 registers a thread and q's
//     fragments would add 64: q keeps its own shared region after the K/V
//     ring and each k-step of Q K^T reads its A fragment there by
//     ldmatrix; and K/V tiles hold 32 keys, not 64, so the 16 score
//     registers fit beside the output's without spilling (101,376 bytes of
//     shared memory in all);
//   * 64-key (D 256: 32-key) tiles of K and V stream through a 2-stage
//     cp.async ring: tile
//     j + 1 is in flight while tile j is computed.  S = Q K^T by
//     mma.sync m16n8k16 (K fragments by ldmatrix), O += P V (V fragments by
//     ldmatrix.trans), f32 accumulators throughout;
//   * the online softmax runs in the accumulator layout: each thread holds
//     2 rows, row max and sum are reduced over the 4 lanes of a quad; l is
//     summed from the f32 p.  P enters P V as bf16 hi + lo (hi = bf16(p),
//     lo = bf16(p - hi), two mma into the one f32 accumulator): a single
//     bf16 rounding of p puts ~2% of the outputs more than one bf16 step
//     from the f32-P reference; the split keeps them within it, for 1.5x
//     the least tensor-core work;
//   * only tiles a mask cuts (causal diagonal, window edge, ragged end) are
//     masked element by element; the CTA visits only the key tiles its
//     rows can see (window lower edge to causal or prefix upper edge);
//   * causal grids launch the query blocks with the most key tiles first;
//   * rows in shared memory are padded by 16 bytes, so the 8 rows an
//     ldmatrix reads fall in distinct banks;
//   * mma.sync, not wgmma/TMA: one warp per 16 rows keeps the softmax in
//     the accumulator registers without a warpgroup's 64-row tiling of a
//     G-interleaved row block; wgmma and warp specialisation are later work.
//
// f32 (flash_attention_forward): CUDA cores, exact f32 FMAs (the f32
// tolerance, 2e-5, does not admit TF32):
//   * one CTA per (block of query positions, kv head, batch row), 64
//     (position, head) rows in all, so every K/V tile it loads serves 64
//     rows; it walks only the key tiles its rows can see;
//   * 32-key tiles are staged in shared memory as f32 with 16-byte vector
//     loads (K rows padded to D + 1 floats so lane j reads key j without
//     bank conflicts); m, l and the f32 accumulator stay in registers;
//     ragged ends (Sq, Sk not multiples of a tile) are masked here.  At D
//     256 a thread's 32 loads of a tile go in 4 batches of 8, not all at
//     once beside the 128-float accumulator (ptxas still reports a
//     32-byte spill there, with batches of 4 too).
//
// Both read the model's (B, S, H, D) layout directly, with a token stride
// per tensor, so q, k and v may be views of the fused QKV projection: the
// wrapper pays no transpose and no copy.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (repro_torch/kernels/_build.py).  Plain C entry
// points, bound with ctypes by repro_torch/kernels/flash_attention/kernel.py.

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
                       const T* __restrict__ v, T* __restrict__ out,
                       float* __restrict__ lse, int Sq, int Sk, int H,
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
  constexpr int NVB = NVT > 8 ? 4 : NVT;  // of k and of v, in flight at once
  static_assert(NVT % NVB == 0, "load batches");

  for (int t0 = lo; t0 <= hi; t0 += kTile) {
    __syncthreads();  // the previous tile is consumed (and Qs is written)
#pragma unroll
    for (int ib = 0; ib < NVT; ib += NVB) {
      // All of a batch's 16-byte loads are issued before any is used.
      uint4 kr[NVB], vr[NVB];
#pragma unroll
      for (int it = 0; it < NVB; ++it) {
        const int vi = tid + (ib + it) * kThreads;
        kr[it] = vr[it] = make_uint4(0u, 0u, 0u, 0u);
        const int p = t0 + vi / VPR;
        if ((NV % kThreads == 0 || vi < NV) && p <= hi) {
          const int off = (vi % VPR) * VEC;
          kr[it] = *reinterpret_cast<const uint4*>(kb + p * k_ts + off);
          vr[it] = *reinterpret_cast<const uint4*>(vb + p * v_ts + off);
        }
      }
#pragma unroll
      for (int it = 0; it < NVB; ++it) {
        const int vi = tid + (ib + it) * kThreads;
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
      if (lse != nullptr && lane == 0)
        lse[((int64_t)b * H + h) * Sq + i] = m[c][kk] + logf(fmaxf(l[c][kk], 1e-30f));
      T* o = out + (((int64_t)b * Sq + i) * H + h) * D;
#pragma unroll
      for (int e = 0; e < DL; ++e) store(o + lane + 32 * e, acc[c][kk][e] * inv);
    }
  }
}

template <typename T, int DL>
int launch(const void* q, const void* k, const void* v, void* out, float* lse, int B, int Sq,
           int Sk, int H, int KH, long long q_ts, long long k_ts, long long v_ts, int causal,
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
      static_cast<T*>(out), lse, Sq, Sk, H, KH, q_ts, k_ts, v_ts, causal, window, prefix,
      rows_per_cta, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- bf16, tensor cores
namespace tc {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kWarps * 16;  // (position, head) rows per CTA
constexpr int kKeys = 64;           // keys per tile
constexpr int kStages = 2;          // K/V ring depth
static_assert(kRows <= 2 * kKeys, "q is staged in stage 1 (its K and V tiles are adjacent)");

// Up to D 128 q is staged in stage 1 of the ring and then held in
// registers; at D 256 it keeps its own region after the ring.
template <int D>
constexpr bool kQInSmem = D > 128;

// Keys per tile: kKeys, and half as many at D 256, where a 64-key tile's
// 32 score accumulators beside the output's 128 spilled the 255 registers
// a thread has (ptxas: 124 bytes).
template <int D>
constexpr int kTileKeys = D > 128 ? kKeys / 2 : kKeys;

__device__ __forceinline__ float minus_inf() { return -__uint_as_float(0x7f800000u); }

using bf16 = __nv_bfloat16;

// Shared memory: kStages x (K tile, V tile), rows of D + 8 elements, and at
// D 256 kRows rows of q after them (D 256: 101,376 bytes).
template <int D>
constexpr size_t smem_bytes() {
  return sizeof(bf16) * (kStages * 2 * kTileKeys<D> + (kQInSmem<D> ? kRows : 0)) * (D + 8);
}

// (kThreads, 1): without the minimum of one CTA, ptxas held D 64 to 128
// registers and spilled.  At D 256 shared memory allows one CTA an SM.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, bf16* __restrict__ out,
                           float* __restrict__ lse, int B, int Sq,
                           int Sk, int H, int KH, int64_t q_ts, int64_t k_ts, int64_t v_ts,
                           int causal, int window, int prefix, int rows_per_cta, int n_qblocks,
                           float scale_log2) {
  constexpr int LD = D + 8;       // shared row stride (elements): +16 bytes
  constexpr int KD = D / 16;      // mma k-steps over d
  constexpr int CH = D / 8;       // 16-byte chunks per row
  constexpr bool kQs = kQInSmem<D>;
  constexpr int KN = kTileKeys<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* const sm = reinterpret_cast<bf16*>(smem_raw);
  auto k_tile = [&](int st) { return sm + (2 * st) * KN * LD; };
  auto v_tile = [&](int st) { return sm + (2 * st + 1) * KN * LD; };

  const int kh = blockIdx.x % KH;
  const int b = blockIdx.x / KH;
  const int qb = causal ? n_qblocks - 1 - (int)blockIdx.y : (int)blockIdx.y;  // longest first
  const int i0 = qb * rows_per_cta;
  const int G = H / KH;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int nq = min(rows_per_cta, Sq - i0);
  const int nrows = G * nq;

  // Keys any row of this CTA can see: [lo, hi].
  int hi = Sk - 1;
  if (causal) hi = min(hi, max(i0 + nq - 1, prefix - 1));
  const int lo = window > 0 ? max(0, i0 - window + 1) : 0;
  const int n_tiles = hi >= lo ? (hi - lo) / KN + 1 : 0;
  const bf16* kb = k + (int64_t)b * Sk * k_ts + (int64_t)kh * D;
  const bf16* vb = v + (int64_t)b * Sk * v_ts + (int64_t)kh * D;

  auto load_tile = [&](int tile, int st) {
    const int t0 = lo + tile * KN;
    bf16* ks = k_tile(st);
    bf16* vs = v_tile(st);
#pragma unroll
    for (int c = tid; c < KN * CH; c += kThreads) {
      const int j = c / CH, d0 = (c % CH) * 8;
      const int p = t0 + j;
      const bool ok = p <= hi;
      const int64_t pp = ok ? p : 0;
      cp_async16(ks + j * LD + d0, kb + pp * k_ts + d0, ok);
      cp_async16(vs + j * LD + d0, vb + pp * v_ts + d0, ok);
    }
  };

  // q rows -> shared memory (stage 1, or its own region), then tile 0; both
  // awaited.
  bf16* const qs = kQs ? sm + kStages * 2 * KN * LD : k_tile(1);
  {
#pragma unroll
    for (int c = tid; c < kRows * CH; c += kThreads) {
      const int r = c / CH, d0 = (c % CH) * 8;
      const bool ok = r < nrows;
      const int i = ok ? i0 + r / G : 0, h = ok ? kh * G + r % G : 0;
      cp_async16(qs + r * LD + d0, q + ((int64_t)b * Sq + i) * q_ts + (int64_t)h * D + d0, ok);
    }
  }
  if (n_tiles > 0) load_tile(0, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // this warp's 16 rows as A fragments: where ldmatrix reads them, and,
  // up to D 128, in registers
  const bf16* const q_frag = qs + (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
  unsigned qf[kQs ? 1 : KD][4];
  if constexpr (!kQs) {
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) ldmatrix_x4(qf[kk], q_frag + kk * 16);
    __syncthreads();  // stage 1 is free for the ring
  }

  // This thread's two rows: r0 = warp * 16 + g and r0 + 8.
  const int r0 = warp * 16 + g;
  const int pos[2] = {i0 + r0 / G, i0 + (r0 + 8) / G};
  const bool live[2] = {r0 < nrows, r0 + 8 < nrows};
  const int i_max = i0 + nq - 1;

  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {minus_inf(), minus_inf()};  // running max, in log2 units
  float l[2] = {0.f, 0.f};              // this thread's share of the row sum

  for (int tile = 0; tile < n_tiles; ++tile) {
    if (tile + 1 < n_tiles) load_tile(tile + 1, (tile + 1) % kStages);
    cp_async_commit();
    cp_async_wait<1>();  // tile `tile` has landed (for this thread) ...
    __syncthreads();     // ... and for every thread
    const bf16* ks = k_tile(tile % kStages);
    const bf16* vs = v_tile(tile % kStages);
    const int t0 = lo + tile * KN;

    // S = Q K^T: 16 rows x 64 keys per warp, 8 n-blocks of 8 keys.
    float s[KN / 8][4];
#pragma unroll
    for (int j = 0; j < KN / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      unsigned qa[4];
      if constexpr (kQs) {
        ldmatrix_x4(qa, q_frag + kk * 16);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) qa[e] = qf[kk][e];
      }
#pragma unroll
      for (int np = 0; np < KN / 16; ++np) {
        unsigned kf[4];  // keys np*16 + {0..7, 8..15} x d kk*16 + {0..7, 8..15}
        ldmatrix_x4(kf, ks + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LD + kk * 16 +
                            ((lane >> 3) & 1) * 8);
        mma_bf16_16816(s[2 * np], qa, kf[0], kf[1]);
        mma_bf16_16816(s[2 * np + 1], qa, kf[2], kf[3]);
      }
    }

    // Scores in log2 units; masked ones -inf, only in tiles a mask cuts.
    const int t_end = t0 + KN - 1;
    const bool cut = t_end > hi || (causal && t_end > i0 && t_end >= prefix) ||
                     (window > 0 && i_max - t0 >= window);
#pragma unroll
    for (int j = 0; j < KN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (cut) {
          const int p = t0 + 8 * j + 2 * t4 + (e & 1);
          const int i = pos[e >> 1];
          bool ok = live[e >> 1] && p <= hi;
          if (causal) ok = ok && (p <= i || p < prefix);
          if (window > 0) ok = ok && (i - p < window);
          if (!ok) x = minus_inf();
        }
        s[j][e] = x;
      }

    // Online softmax in the accumulator layout (row max over the quad).
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = m[h];
#pragma unroll
      for (int j = 0; j < KN / 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      const float base = mx == minus_inf() ? 0.f : mx;  // a row with nothing seen yet
      corr[h] = exp2f(m[h] - base);
      m[h] = mx;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < KN / 8; ++j) {
        s[j][2 * h] = exp2f(s[j][2 * h] - base);
        s[j][2 * h + 1] = exp2f(s[j][2 * h + 1] - base);
        sum += s[j][2 * h] + s[j][2 * h + 1];
      }
      l[h] = l[h] * corr[h] + sum;
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[j][0] *= corr[0];
      o[j][1] *= corr[0];
      o[j][2] *= corr[1];
      o[j][3] *= corr[1];
    }

    // O += P V with P = hi + lo in bf16: the C fragments of key n-blocks
    // 2 kb and 2 kb + 1 are the A fragment of key step kb.
#pragma unroll
    for (int kb2 = 0; kb2 < KN / 16; ++kb2) {
      unsigned ph[4], pl[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float* src = s[2 * kb2 + (a >> 1)] + 2 * (a & 1);
        const __nv_bfloat162 h2 = __floats2bfloat162_rn(src[0], src[1]);
        ph[a] = *reinterpret_cast<const unsigned*>(&h2);
        pl[a] = pack_bf16(src[0] - __low2float(h2), src[1] - __high2float(h2));
      }
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        unsigned vf[4];  // keys kb2*16 + {0..7, 8..15} x d dp*16 + {0..7, 8..15}, transposed
        ldmatrix_x4_trans(vf, vs + (kb2 * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                  dp * 16 + (lane >> 4) * 8);
        mma_bf16_16816(o[2 * dp], ph, vf[0], vf[1]);
        mma_bf16_16816(o[2 * dp], pl, vf[0], vf[1]);
        mma_bf16_16816(o[2 * dp + 1], ph, vf[2], vf[3]);
        mma_bf16_16816(o[2 * dp + 1], pl, vf[2], vf[3]);
      }
    }
    __syncthreads();  // this stage is consumed before the next load refills it
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lt = l[h];
    lt += __shfl_xor_sync(kFull, lt, 1);
    lt += __shfl_xor_sync(kFull, lt, 2);
    if (!live[h]) continue;
    const int r = r0 + 8 * h;
    const int hd = kh * G + r % G;
    const float inv = 1.f / fmaxf(lt, 1e-30f);
    if (lse != nullptr && t4 == 0)  // m is in log2 units: convert once, here
      lse[((int64_t)b * H + hd) * Sq + pos[h]] =
          (m[h] + log2f(fmaxf(lt, 1e-30f))) * 0.6931471805599453f;
    bf16* orow = out + (((int64_t)b * Sq + pos[h]) * H + hd) * D + 2 * t4;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(o[j][2 * h] * inv, o[j][2 * h + 1] * inv);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, float* lse, int B, int Sq,
           int Sk, int H, int KH, long long q_ts, long long k_ts, long long v_ts, int causal,
           int window, int prefix, int rows_per_cta, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto kernel = flash_attention_mma_kernel<D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_qblocks = (Sq + rows_per_cta - 1) / rows_per_cta;
  if (n_qblocks > 65535) return -3;
  dim3 grid(B * KH, n_qblocks);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), lse, B, Sq, Sk, H, KH, q_ts, k_ts, v_ts, causal, window, prefix,
      rows_per_cta, n_qblocks, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace tc

int launch_f32(int D, const void* q, const void* k, const void* v, void* out, float* lse, int B,
               int Sq,
               int Sk, int H, int KH, long long q_ts, long long k_ts, long long v_ts,
               int causal, int window, int prefix, int rows_per_cta, float scale,
               cudaStream_t stream) {
#define FA_ARGS \
  q, k, v, out, lse, B, Sq, Sk, H, KH, q_ts, k_ts, v_ts, causal, window, prefix, rows_per_cta, \
      scale, stream
  switch (D) {
    case 32: return launch<float, 1>(FA_ARGS);
    case 64: return launch<float, 2>(FA_ARGS);
    case 128: return launch<float, 4>(FA_ARGS);
    case 256: return launch<float, 8>(FA_ARGS);
  }
  return -2;
}

int launch_bf16(int D, const void* q, const void* k, const void* v, void* out, float* lse, int B,
                int Sq,
                int Sk, int H, int KH, long long q_ts, long long k_ts, long long v_ts,
                int causal, int window, int prefix, int rows_per_cta, float scale,
                cudaStream_t stream) {
  switch (D) {
    case 32: return tc::launch<32>(FA_ARGS);
    case 64: return tc::launch<64>(FA_ARGS);
    case 128: return tc::launch<128>(FA_ARGS);
    case 256: return tc::launch<256>(FA_ARGS);
  }
#undef FA_ARGS
  return -2;
}

bool bad_grouping(int B, int Sq, int Sk, int H, int KH, int rows_per_cta) {
  return B <= 0 || Sq <= 0 || Sk <= 0 || KH <= 0 || H % KH != 0 || rows_per_cta <= 0 ||
         (H / KH) * rows_per_cta > kRowsMax;
}

}  // namespace

// q: (B, Sq, H, D), k and v: (B, Sk, KH, D), D 32, 64, 128 or 256, each
// with unit stride over D,
// D elements between heads and q_ts / k_ts / v_ts elements between tokens
// (batch rows S * ts apart), 16-byte aligned rows; out: (B, Sq, H, D)
// contiguous; lse: null, or (B, H, Sq) f32 contiguous, which receives each
// row's logsumexp (natural log).  G = H / KH query heads per kv head; q head
// h = kh * G + g.
// rows_per_cta query positions per CTA, with G * rows_per_cta <= 64.
// flash_attention_forward takes f32 (CUDA cores), flash_attention_forward_mma
// bf16 (tensor cores).  Each returns 0 or a CUDA error code (negative for an
// unsupported D or grouping); launches on `stream` and does not synchronise.
extern "C" int flash_attention_forward(const void* q, const void* k, const void* v, void* out,
                                       float* lse, int B, int Sq, int Sk, int H, int KH, int D,
                                       long long q_ts, long long k_ts, long long v_ts,
                                       int causal, int window, int prefix, int rows_per_cta,
                                       float scale, void* stream) {
  if (bad_grouping(B, Sq, Sk, H, KH, rows_per_cta)) return -3;
  return launch_f32(D, q, k, v, out, lse, B, Sq, Sk, H, KH, q_ts, k_ts, v_ts, causal, window,
                    prefix, rows_per_cta, scale, static_cast<cudaStream_t>(stream));
}

extern "C" int flash_attention_forward_mma(const void* q, const void* k, const void* v,
                                           void* out, float* lse, int B, int Sq, int Sk, int H,
                                           int KH, int D, long long q_ts, long long k_ts,
                                           long long v_ts, int causal, int window, int prefix,
                                           int rows_per_cta, float scale, void* stream) {
  if (bad_grouping(B, Sq, Sk, H, KH, rows_per_cta)) return -3;
  return launch_bf16(D, q, k, v, out, lse, B, Sq, Sk, H, KH, q_ts, k_ts, v_ts, causal, window,
                     prefix, rows_per_cta, scale, static_cast<cudaStream_t>(stream));
}
