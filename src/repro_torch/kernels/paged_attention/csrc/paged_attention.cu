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
// K and V pages once per kv head, sum_b ctx_b * KH * D * 2 * bytes (int8
// pages: 1 byte a value plus 4 / D bytes of its f32 scale), and writing
// the (B, W, H, D) output once, at 3.35 TB/s; the arithmetic (4 * D flops
// per query row per key) is far below the card's rate at these shapes.
// Two kernels, chosen by the wrapper from the (q, page) dtypes alone
// (ops.ENTRIES; never a fallback):
//
// bf16 q with bf16 or int8 pages (paged_attention_forward_mma; qwen3-1.7b's
// plan serves bf16 pages, qwen3-moe-30b-a3b's int8): tensor cores, three
// passes in one call.
//   * a prologue builds a work list on the device from lens / q_lens (no
//     host sync) and writes zeros into the dead rows: only (slot, row block)
//     or (slot, key split) pairs with live rows become items, so no CTA is
//     launched, or reserves shared memory, for a dead row block (the decode
//     slab has one live row a slot);
//   * the main pass is a persistent grid (SMs x resident CTAs) that takes
//     (item, kv head) pairs off the list by an atomic counter, prefill row
//     blocks first (the longest);
//   * a slot whose G * q_len rows fit one 16-row mma block is a decode slot:
//     its keys are cut at absolute multiples of `split` (flash-decoding),
//     one item a split, and the four warps of the CTA all hold its rows and
//     each takes a quarter of every 64-key tile, their (m, l, o) merged in
//     warp order at the end; with one split the CTA writes the output, with
//     several it writes f32 partials, which the combine pass merges in split
//     order (deterministic);
//   * other slots' row blocks hold 64 (slab row, head) rows of one kv head,
//     16 a warp, over every tile they can see;
//   * 64-key tiles stream through a 2-stage cp.async ring; each tile's page
//     slots are resolved from the block table once, a tile ahead; keys
//     outside the item's range land as zeros.  bf16 tiles are read by
//     ldmatrix in place.  int8 tiles move half the bytes: the threads that
//     resolve a tile's slots also copy its 64 k and v scales (cp.async, 4
//     bytes each) into the ring beside it, and once a tile lands the whole
//     CTA widens it to bf16 (exact: |v| <= 127) into one (K, V) pair in
//     shared memory, which the warps read as they read a bf16 stage
//     (widening in registers after ldmatrix instead ties at decode and
//     loses at the mixed shape: scripts/kernel_variants.py paged_int8).
//     Shared memory at D 128: bf16 69,632 bytes (the ring); int8 68,608
//     (ring 32,768, widened pair 34,816, scales 1,024): 3 CTAs an SM;
//   * S = Q K^T and O += P V by mma.sync m16n8k16 (ldmatrix, ldmatrix.trans),
//     the online softmax in the accumulator layout, P as bf16 hi + lo (a
//     single rounding of P puts a few percent of the outputs outside one
//     bf16 step), l from the f32 p; masks only on tiles a mask cuts.  int8
//     pages: S's columns are multiplied by k_scale after the mma (q . (k
//     k_scale) reassociated), P's by v_scale before the hi + lo split, and l
//     sums the unscaled p.
//
// f32 q with any pages, and bf16 q with f32 pages (paged_attention_forward):
// CUDA cores (f32's tolerance rules out rounding q or f32 pages to bf16).
//   * one CTA per (block of slab rows, kv head, slot).  The CTA takes the G
//     query heads of its kv head together (GQA), so every page it loads
//     serves G * rows queries;
//   * the CTA loads its own page ids from the table and walks only the keys
//     its live rows can see, max(0, lens - window + 1) .. lens + q_len - 1:
//     the loop replaces the TPU's sequential table-tile grid axis, and work
//     follows the live context, not the table width;
//   * a CTA whose rows are all dead writes zeros and exits before touching
//     a page;
//   * tiles of 32 keys are staged in shared memory as f32 (K rows padded to
//     D + 1 floats so lane j reads key j without bank conflicts): the
//     tile's page slots are resolved once, then every thread issues all of
//     its 16-byte loads before using any; the online-softmax state m, l and
//     the f32 accumulator stay in registers.
//
// Numerics follow the TPU kernel: scale 1/sqrt(D) (passed in), masked
// probabilities exactly 0 so fully masked rows stay 0, l floored at 1e-30,
// and q rounded to bf16 before the dot for bf16 pages.  The tensor-core
// kernel keeps P V's P at f32 accuracy (hi + lo), where the TPU kernel
// rounds it once to bf16 (bf16 pages) or computes in f32 (int8 pages);
// ref.paged_attention_split_ref emulates its scheme on the CPU.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (repro_torch/kernels/_build.py).  Plain C entry
// points, bound with ctypes by repro_torch/kernels/paged_attention/kernel.py.

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

// ---------------------------------------------------------------- bf16 q, tensor cores
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kWarps * 16;  // (slab row, head) rows of a prefill item
constexpr int kDecRows = 16;        // rows of a decode item: one mma row block
constexpr int kKeys = 64;           // keys per tile
constexpr int kStages = 2;          // K/V ring depth
constexpr int kPlanThreads = 256;   // threads of the prologue's CTAs
static_assert(kRows <= kKeys, "q is staged in one K tile");

__device__ __forceinline__ float minus_inf() { return -__uint_as_float(0x7f800000u); }

// Shared memory, in bytes from its start.  bf16 pages: the ring, kStages x
// (K tile, V tile) of kKeys rows of D + 8 bf16 (+16 bytes a row: the 8 rows
// an ldmatrix reads fall in distinct banks), q staged in its last K tile.
// int8 pages: the ring of int8 tiles (kKeys rows of D bytes: a quarter-warp
// of 16-byte copies covers 128 bytes, no conflict), then one widened bf16
// (K, V) pair laid out as a bf16 stage (q staged in its K tile), then the
// ring's scales, kStages x (k, v) x kKeys f32.  The decode merge reuses the
// start.  At D 128: 69,632 bytes (bf16), 32,768 + 34,816 + 1,024 = 68,608
// (int8); 3 CTAs an SM by shared memory.
template <int D, typename TKV>
struct Smem {
  static constexpr bool kQuant = std::is_same<TKV, int8_t>::value;
  static constexpr int LD = D + 8;
  static constexpr size_t kTileBytes = (size_t)kKeys * D * sizeof(TKV);  // a ring tile (int8)
  static constexpr size_t kPair = 2 * (size_t)kKeys * LD * sizeof(bf16);  // a bf16 (K, V) pair
  static constexpr size_t kRing = kQuant ? kStages * 2 * kTileBytes : kStages * kPair;
  static constexpr size_t kWide = kRing;  // the widened pair (int8)
  static constexpr size_t kScales = kWide + (kQuant ? kPair : 0);
  static constexpr size_t kBytes = kScales + (kQuant ? kStages * 2 * kKeys * sizeof(float) : 0);
  static_assert(kBytes >= (size_t)4 * kDecRows * (D + 2) * sizeof(float), "decode merge");
};

// What every pass derives from a slot's lens / q_lens alike.
struct Slot {
  int base;    // absolute position of slab row 0
  int nq;      // live slab rows
  int lo, hi;  // keys any live row sees (hi < lo: none)
  bool dec;    // a decode item: all G * nq rows fit one mma row block
};

struct Args {
  const bf16* q;
  const void* k;        // bf16 or int8 pages
  const void* v;
  const float* k_scale;  // int8 pages: (N, block_size, KH) f32; null for bf16
  const float* v_scale;
  const int* table;
  const int* lens;
  const int* q_lens;
  bf16* out;
  float* part;     // (B, KH, n_splits, kDecRows, D + 2) f32: decode partials, o then (m, l)
  int* work;       // [0] items, [1] next item, [2..] items as (slot, code)
  int B, W, H, KH, block_size, max_blocks, window, rows_per_cta, split, n_splits;
  float scale_log2;
};

// The first key a row at absolute position `pos` (or after it) can see.
__device__ __forceinline__ int window_lo(const Args& a, int pos) {
  return a.window > 0 ? max(0, pos - a.window + 1) : 0;
}

__device__ __forceinline__ Slot slot_of(const Args& a, int b) {
  Slot s;
  s.base = a.lens[b];
  s.nq = a.q_lens[b];
  s.hi = min(s.base + s.nq - 1, a.max_blocks * a.block_size - 1);
  s.lo = window_lo(a, s.base);
  s.dec = s.nq > 0 && (a.H / a.KH) * s.nq <= kDecRows;
  return s;
}

// Items of a slot: prefill row blocks, or decode splits (those its keys
// reach, in absolute multiples of `split`); none for an idle slot.
__device__ __forceinline__ int prefill_items(const Args& a, const Slot& s) {
  return s.nq > 0 && !s.dec && s.hi >= s.lo ? (s.nq + a.rows_per_cta - 1) / a.rows_per_cta : 0;
}
__device__ __forceinline__ int decode_items(const Args& a, const Slot& s) {
  return s.dec && s.hi >= s.lo ? s.hi / a.split - s.lo / a.split + 1 : 0;
}

// Exclusive scan of x over the CTA (kPlanThreads threads); returns this
// thread's offset, and the total in *total.
__device__ int cta_scan(int x, int* buf, int* total) {
  const int tid = threadIdx.x;
  buf[tid] = x;
  __syncthreads();
  for (int o = 1; o < kPlanThreads; o <<= 1) {
    const int y = tid >= o ? buf[tid - o] : 0;
    __syncthreads();
    buf[tid] += y;
    __syncthreads();
  }
  const int incl = buf[tid];
  *total = buf[kPlanThreads - 1];
  __syncthreads();
  return incl - x;
}

// The prologue.  CTA 0 builds the work list (prefill row blocks first, the
// longest items, then decode splits, slot by slot) and resets the item
// counter; every CTA writes zeros into the rows no item writes (dead rows,
// and live rows of a slot whose keys lie outside the table).
template <int D>
__global__ void __launch_bounds__(kPlanThreads) plan_kernel(Args a) {
  if (blockIdx.x == 0) {
    __shared__ int buf[kPlanThreads];
    int n_pre = 0, total;
    for (int b0 = 0; b0 < a.B; b0 += kPlanThreads) {
      const int b = b0 + threadIdx.x;
      cta_scan(b < a.B ? prefill_items(a, slot_of(a, b)) : 0, buf, &total);
      n_pre += total;
    }
    int pre = 0, dec = 0;  // items written so far of each kind
    int2* items = reinterpret_cast<int2*>(a.work + 2);
    for (int b0 = 0; b0 < a.B; b0 += kPlanThreads) {
      const int b = b0 + threadIdx.x;
      Slot s{};
      int np = 0, nd = 0;
      if (b < a.B) {
        s = slot_of(a, b);
        np = prefill_items(a, s);
        nd = decode_items(a, s);
      }
      int tp, td;
      const int op = pre + cta_scan(np, buf, &tp);
      const int od = n_pre + dec + cta_scan(nd, buf, &td);
      for (int r = 0; r < np; ++r) items[op + r] = make_int2(b, r);
      for (int r = 0; r < nd; ++r) items[od + r] = make_int2(b, -(s.lo / a.split + r) - 1);
      pre += tp;
      dec += td;
    }
    if (threadIdx.x == 0) {
      a.work[0] = pre + dec;
      a.work[1] = 0;
    }
  }
  // zeros: a warp a (slot, slab row) of H * D elements, 16 bytes a lane a step
  const int vpr = a.H * D / 8;
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * (kPlanThreads / 32);
  for (int row = blockIdx.x * (kPlanThreads / 32) + (threadIdx.x >> 5); row < a.B * a.W;
       row += warps) {
    const int b = row / a.W, i = row % a.W;
    bool zero = i >= a.q_lens[b];
    if (!zero) {
      const Slot s = slot_of(a, b);
      zero = s.hi < s.lo;
    }
    if (zero) {
      uint4* o = reinterpret_cast<uint4*>(a.out) + (long long)row * vpr;
      for (int v = lane; v < vpr; v += 32) o[v] = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// One warp's share of a tile: rows roff..roff+15 of the item against keys
// koff..koff+NK-1 of the tile (NK 64: a prefill warp's whole tile; 16: a
// decode warp's quarter).  S = Q K^T and O += P V on the tensor cores, the
// online softmax in the accumulator layout (m in log2 units), P as bf16
// hi + lo, l from the f32 p.  Masks only where `cut`.  int8 pages (kScaled):
// ks / vs hold the tile's integer values as bf16 and ksc / vsc its keys'
// scales: S's column j times ksc[j] before the softmax, P's column j times
// vsc[j] before the hi + lo split (l stays the sum of the unscaled p).
template <int D, int NK, bool kScaled>
__device__ __forceinline__ void attend_tile(const bf16* ks, const bf16* vs, const float* ksc,
                                            const float* vsc, unsigned (*qf)[4], int koff,
                                            int t0, bool cut, const int* pos, const bool* live,
                                            int k_lo, int k_hi, int window, float scale_log2,
                                            float (*o)[4], float* m, float* l) {
  constexpr int LD = D + 8;
  constexpr int KD = D / 16;
  const int lane = threadIdx.x & 31;
  const int t4 = lane & 3;
  float s[NK / 8][4];
#pragma unroll
  for (int j = 0; j < NK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
    for (int np = 0; np < NK / 16; ++np) {
      unsigned kf[4];  // keys np*16 + {0..7, 8..15} x d kk*16 + {0..7, 8..15}
      ldmatrix_x4(kf, ks + (koff + np * 16 + (lane & 7) + (lane >> 4) * 8) * LD + kk * 16 +
                          ((lane >> 3) & 1) * 8);
      mma_bf16_16816(s[2 * np], qf[kk], kf[0], kf[1]);
      mma_bf16_16816(s[2 * np + 1], qf[kk], kf[2], kf[3]);
    }
  }
#pragma unroll
  for (int j = 0; j < NK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[j][e];
      if (kScaled) x *= ksc[koff + 8 * j + 2 * t4 + (e & 1)];
      x *= scale_log2;
      if (cut) {
        const int p = t0 + 8 * j + 2 * t4 + (e & 1);
        const int i = pos[e >> 1];
        bool ok = live[e >> 1] && p >= k_lo && p <= k_hi && p <= i;
        if (window > 0) ok = ok && (i - p < window);
        if (!ok) x = minus_inf();
      }
      s[j][e] = x;
    }
  float corr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = m[h];
#pragma unroll
    for (int j = 0; j < NK / 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
    const float base = mx == minus_inf() ? 0.f : mx;  // a row with nothing seen yet
    corr[h] = exp2f(m[h] - base);
    m[h] = mx;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < NK / 8; ++j) {
      s[j][2 * h] = exp2f(s[j][2 * h] - base);
      s[j][2 * h + 1] = exp2f(s[j][2 * h + 1] - base);
      sum += s[j][2 * h] + s[j][2 * h + 1];
    }
    l[h] = l[h] * corr[h] + sum;
  }
  if (kScaled) {
#pragma unroll
    for (int j = 0; j < NK / 8; ++j) {
      const float2 vc = *reinterpret_cast<const float2*>(vsc + koff + 8 * j + 2 * t4);
      s[j][0] *= vc.x;
      s[j][1] *= vc.y;
      s[j][2] *= vc.x;
      s[j][3] *= vc.y;
    }
  }
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    o[j][0] *= corr[0];
    o[j][1] *= corr[0];
    o[j][2] *= corr[1];
    o[j][3] *= corr[1];
  }
  // O += P V, P = hi + lo in bf16: the C fragments of key n-blocks 2 kb and
  // 2 kb + 1 are the A fragment of key step kb.
#pragma unroll
  for (int kb2 = 0; kb2 < NK / 16; ++kb2) {
    unsigned ph[4], pl[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float* src = s[2 * kb2 + (q >> 1)] + 2 * (q & 1);
      const __nv_bfloat162 h2 = __floats2bfloat162_rn(src[0], src[1]);
      ph[q] = *reinterpret_cast<const unsigned*>(&h2);
      pl[q] = pack_bf16(src[0] - __low2float(h2), src[1] - __high2float(h2));
    }
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      unsigned vf[4];  // keys kb2*16 + {0..7, 8..15} x d dp*16 + {0..7, 8..15}, transposed
      ldmatrix_x4_trans(vf, vs + (koff + kb2 * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                dp * 16 + (lane >> 4) * 8);
      mma_bf16_16816(o[2 * dp], ph, vf[0], vf[1]);
      mma_bf16_16816(o[2 * dp], pl, vf[0], vf[1]);
      mma_bf16_16816(o[2 * dp + 1], ph, vf[2], vf[3]);
      mma_bf16_16816(o[2 * dp + 1], pl, vf[2], vf[3]);
    }
  }
}

// The main pass: a persistent grid whose CTAs take items off the work list
// (one (item, kv head) pair at a time, by an atomic counter) until it is
// empty.  Prefill items: 4 warps x 16 (slab row, head) rows over every key
// tile.  Decode items: all 4 warps on the same 16 rows, each on a quarter
// of every tile's keys, merged at the end; a slot whose keys span one split
// writes its output here, one of several splits writes f32 partials.  int8
// pages: each landed tile (and its scales) is widened to bf16 in shared
// memory by the whole CTA before the warps read it.
template <int D, typename TKV>
__global__ void __launch_bounds__(kThreads, 1) paged_mma_kernel(Args a) {
  using S = Smem<D, TKV>;
  constexpr bool kQuant = S::kQuant;
  constexpr int LD = D + 8;
  constexpr int KD = D / 16;
  constexpr int EV = 16 / sizeof(TKV);  // page elements a 16-byte copy
  constexpr int CH = D / EV;            // 16-byte copies a page row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the bf16 (K, V) pair the warps read: ring stage st (bf16 pages) or the
  // widened pair (int8 pages)
  auto k_tile = [&](int st) {
    return reinterpret_cast<bf16*>(smem_raw + (kQuant ? (int)S::kWide : st * (int)S::kPair));
  };
  auto v_tile = [&](int st) { return k_tile(st) + kKeys * LD; };
  // int8 pages: ring stage st's tiles and scales
  auto k_ring = [&](int st) { return smem_raw + 2 * st * (int)S::kTileBytes; };
  auto v_ring = [&](int st) { return k_ring(st) + S::kTileBytes; };
  auto k_sc = [&](int st) {
    return reinterpret_cast<float*>(smem_raw + (int)S::kScales) + 2 * st * kKeys;
  };
  auto v_sc = [&](int st) { return k_sc(st) + kKeys; };
  __shared__ int tok_s[kStages][kKeys];  // each tile key's token row in the pool, or -1
  __shared__ int item_s;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int G = a.H / a.KH;
  const int n_work = a.work[0] * a.KH;
  const int2* items = reinterpret_cast<const int2*>(a.work + 2);

  for (;;) {
    __syncthreads();  // the previous item is done with shared memory and item_s
    if (tid == 0) item_s = atomicAdd(a.work + 1, 1);
    __syncthreads();
    const int t = item_s;
    if (t >= n_work) break;
    const int2 it = items[t / a.KH];
    const int kh = t % a.KH;
    const int b = it.x;
    const Slot sl = slot_of(a, b);
    const bool dec = it.y < 0;
    const int split = dec ? -it.y - 1 : 0;
    const int i0 = dec ? 0 : it.y * a.rows_per_cta;
    const int nl = dec ? sl.nq : min(a.rows_per_cta, sl.nq - i0);
    const int nrows = G * nl;
    // keys of this item: [k_lo, k_hi], tiles aligned to absolute multiples of kKeys
    int k_lo = window_lo(a, sl.base + i0), k_hi = min(sl.base + i0 + nl - 1, sl.hi);
    if (dec) {
      k_lo = max(k_lo, split * a.split);
      k_hi = min(k_hi, (split + 1) * a.split - 1);
    }
    const int t_first = k_lo / kKeys * kKeys;
    const int n_tiles = k_hi >= k_lo ? (k_hi - t_first) / kKeys + 1 : 0;
    const int* trow = a.table + (long long)b * a.max_blocks;
    const TKV* kb = static_cast<const TKV*>(a.k) + (long long)kh * D;
    const TKV* vb = static_cast<const TKV*>(a.v) + (long long)kh * D;

    auto resolve = [&](int tile, int st) {  // threads 0..kKeys-1
      const int p = t_first + tile * kKeys + tid;
      tok_s[st][tid] = p >= k_lo && p <= k_hi
                           ? trow[p / a.block_size] * a.block_size + p % a.block_size
                           : -1;
    };
    auto load_tile = [&](int st) {
#pragma unroll
      for (int c = tid; c < kKeys * CH; c += kThreads) {
        const int j = c / CH, d0 = (c % CH) * EV;
        const int tok = tok_s[st][j];
        const long long off = (long long)(tok >= 0 ? tok : 0) * a.KH * D + d0;
        if constexpr (kQuant) {
          cp_async16(k_ring(st) + j * D + d0, kb + off, tok >= 0);
          cp_async16(v_ring(st) + j * D + d0, vb + off, tok >= 0);
        } else {
          cp_async16(k_tile(st) + j * LD + d0, kb + off, tok >= 0);
          cp_async16(v_tile(st) + j * LD + d0, vb + off, tok >= 0);
        }
      }
      if constexpr (kQuant) {
        if (tid < kKeys) {  // the threads that resolved the slots: the scales
          const int tok = tok_s[st][tid];
          const long long at = (long long)(tok >= 0 ? tok : 0) * a.KH + kh;
          cp_async4(k_sc(st) + tid, a.k_scale + at, tok >= 0);
          cp_async4(v_sc(st) + tid, a.v_scale + at, tok >= 0);
        }
      }
    };
    // int8 pages: ring stage st widened into the bf16 pair, 16 values a step
    auto widen = [&](int st) {
#pragma unroll
      for (int c = tid; c < 2 * kKeys * CH; c += kThreads) {
        const int kv = c / (kKeys * CH), j = c / CH % kKeys, d0 = (c % CH) * EV;
        const uint4 w = *reinterpret_cast<const uint4*>((kv ? v_ring(st) : k_ring(st)) +
                                                        j * D + d0);
        uint4 lo, hi;
        int8x4_to_bf16(w.x, lo.x, lo.y);
        int8x4_to_bf16(w.y, lo.z, lo.w);
        int8x4_to_bf16(w.z, hi.x, hi.y);
        int8x4_to_bf16(w.w, hi.z, hi.w);
        uint4* dst = reinterpret_cast<uint4*>((kv ? v_tile(0) : k_tile(0)) + j * LD + d0);
        dst[0] = lo;
        dst[1] = hi;
      }
    };

    // Prologue: page slots of the first kStages tiles; q rows into a K tile
    // the ring's first tiles do not use (the last stage's, or the widened
    // one) and the first kStages - 1 tiles into the ring.
    if (tid < kKeys)
      for (int st = 0; st < kStages; ++st)
        if (st < n_tiles) resolve(st, st);
    {
      bf16* qs = k_tile(kStages - 1);
      for (int c = tid; c < kRows * (D / 8); c += kThreads) {  // bf16 q: 8 a copy
        const int r = c / (D / 8), d0 = c % (D / 8) * 8;
        const bool ok = r < nrows;
        const int i = ok ? i0 + r / G : 0, h = ok ? kh * G + r % G : 0;
        cp_async16(qs + r * LD + d0, a.q + (((long long)b * a.W + i) * a.H + h) * D + d0, ok);
      }
    }
    __syncthreads();  // tok_s is visible
#pragma unroll
    for (int st = 0; st < kStages - 1; ++st) {
      if (st < n_tiles) load_tile(st);
      cp_async_commit();
    }
    cp_async_wait<kStages - 2>();  // q (and tile 0) have landed
    __syncthreads();
    const int roff = dec ? 0 : warp * 16;
    unsigned qf[KD][4];
    {
      const bf16* qs = k_tile(kStages - 1) + (roff + (lane & 15)) * LD + (lane >> 4) * 8;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) ldmatrix_x4(qf[kk], qs + kk * 16);
    }
    __syncthreads();  // the q tile is free for the ring (or the widening)

    const int r0 = roff + g;  // this thread's rows: r0 and r0 + 8
    const int pos[2] = {sl.base + i0 + r0 / G, sl.base + i0 + (r0 + 8) / G};
    const bool live[2] = {r0 < nrows, r0 + 8 < nrows};
    const int pos_min = sl.base + i0, pos_max = sl.base + i0 + nl - 1;
    float o[D / 8][4];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
    float m[2] = {minus_inf(), minus_inf()};
    float l[2] = {0.f, 0.f};
    const bool warp_live = roff < nrows;  // prefill warps past the live rows idle

    for (int tile = 0; tile < n_tiles; ++tile) {
      const int nt = tile + kStages - 1;
      if (nt < n_tiles) load_tile(nt % kStages);
      cp_async_commit();
      cp_async_wait<kStages - 1>();  // tile `tile` has landed (for this thread) ...
      __syncthreads();                // ... and for every thread
      if (tid < kKeys && tile + kStages < n_tiles) resolve(tile + kStages, tile % kStages);
      const int st = tile % kStages;
      if constexpr (kQuant) {
        widen(st);
        __syncthreads();  // the widened pair is complete
      }
      const int koff = dec ? warp * 16 : 0;
      const int t0 = t_first + tile * kKeys + koff;
      const int t_end = t0 + (dec ? 16 : kKeys) - 1;
      const bool cut = t0 < k_lo || t_end > k_hi || t_end > pos_min ||
                       (a.window > 0 && pos_max - t0 >= a.window);
      if (dec)
        attend_tile<D, 16, kQuant>(k_tile(st), v_tile(st), k_sc(st), v_sc(st), qf, koff, t0,
                                   cut, pos, live, k_lo, k_hi, a.window, a.scale_log2, o, m, l);
      else if (warp_live)
        attend_tile<D, kKeys, kQuant>(k_tile(st), v_tile(st), k_sc(st), v_sc(st), qf, 0, t0,
                                      cut, pos, live, k_lo, k_hi, a.window, a.scale_log2, o, m,
                                      l);
      __syncthreads();  // this stage (and the widened pair) is consumed before a refill
    }
    cp_async_wait<0>();  // no copy is left in flight into shared memory

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(kFull, l[h], 1);
      l[h] += __shfl_xor_sync(kFull, l[h], 2);
    }
    const int ns = dec ? decode_items(a, sl) : 1;
    if (dec) {
      // merge the four warps' (m, l, o), in warp order, through shared memory
      float* ms = reinterpret_cast<float*>(smem_raw);  // [warp][row]
      float* ls = ms + kWarps * kDecRows;               // [warp][row]
      float* os = ls + kWarps * kDecRows;               // [warp][row][D]
      if (t4 == 0)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          ms[warp * kDecRows + g + 8 * h] = m[h];
          ls[warp * kDecRows + g + 8 * h] = l[h];
        }
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(os + (warp * kDecRows + g + 8 * h) * D + 8 * j + 2 * t4) =
              make_float2(o[j][2 * h], o[j][2 * h + 1]);
      __syncthreads();
      const long long part = (((long long)b * a.KH + kh) * a.n_splits + split) * kDecRows;
      for (int e = tid; e < nrows * D; e += kThreads) {
        const int r = e / D, d = e % D;
        float mx = minus_inf();
#pragma unroll
        for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, ms[w * kDecRows + r]);
        const float base = mx == minus_inf() ? 0.f : mx;
        float lt = 0.f, ot = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          const float c = exp2f(ms[w * kDecRows + r] - base);
          lt += c * ls[w * kDecRows + r];
          ot += c * os[(w * kDecRows + r) * D + d];
        }
        if (ns == 1) {
          const int i = r / G, hd = kh * G + r % G;
          a.out[(((long long)b * a.W + i) * a.H + hd) * D + d] =
              __float2bfloat16(ot / fmaxf(lt, 1e-30f));
        } else {
          float* pr = a.part + (part + r) * (D + 2);
          pr[d] = ot;
          if (d == 0) {
            pr[D] = mx;
            pr[D + 1] = lt;
          }
        }
      }
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (!live[h]) continue;
        const int r = r0 + 8 * h;
        const int i = i0 + r / G, hd = kh * G + r % G;
        const float inv = 1.f / fmaxf(l[h], 1e-30f);
        bf16* orow = a.out + (((long long)b * a.W + i) * a.H + hd) * D + 2 * t4;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
              __floats2bfloat162_rn(o[j][2 * h] * inv, o[j][2 * h + 1] * inv);
      }
    }
  }
}

// The combine pass: for each (slot, kv head) whose decode keys span several
// splits, the output from the f32 partials, merged in split order.
template <int D>
__global__ void __launch_bounds__(kThreads) combine_kernel(Args a) {
  const int b = blockIdx.x / a.KH, kh = blockIdx.x % a.KH;
  const Slot sl = slot_of(a, b);
  const int ns = decode_items(a, sl);
  if (ns < 2) return;
  const int G = a.H / a.KH;
  const int s0 = sl.lo / a.split;
  const long long part = ((long long)b * a.KH + kh) * a.n_splits * kDecRows;
  for (int e = threadIdx.x; e < G * sl.nq * D; e += kThreads) {
    const int r = e / D, d = e % D;
    float mx = minus_inf();
    for (int s = s0; s < s0 + ns; ++s) mx = fmaxf(mx, a.part[(part + s * kDecRows + r) * (D + 2) + D]);
    const float base = mx == minus_inf() ? 0.f : mx;
    float lt = 0.f, ot = 0.f;
    for (int s = s0; s < s0 + ns; ++s) {  // in split order: deterministic
      const float* pr = a.part + (part + s * kDecRows + r) * (D + 2);
      const float c = exp2f(pr[D] - base);
      lt += c * pr[D + 1];
      ot += c * pr[d];
    }
    const int i = r / G, hd = kh * G + r % G;
    a.out[(((long long)b * a.W + i) * a.H + hd) * D + d] = __float2bfloat16(ot / fmaxf(lt, 1e-30f));
  }
}

template <int D, typename TKV>
int launch(Args a, cudaStream_t stream) {
  constexpr size_t smem = Smem<D, TKV>::kBytes;
  auto kernel = paged_mma_kernel<D, TKV>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem)) !=
      cudaSuccess)
    return (int)err;
  if (per_sm < 1) return -5;
  // the prologue: a warp a slab row to zero, at most 8 CTAs an SM
  const int rows_ctas = (a.B * a.W + kPlanThreads / 32 - 1) / (kPlanThreads / 32);
  const int plan_grid = rows_ctas < sms * 8 ? rows_ctas : sms * 8;
  plan_kernel<D><<<plan_grid, kPlanThreads, 0, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  kernel<<<sms * per_sm, kThreads, smem, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  combine_kernel<D><<<a.B * a.KH, kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace tc

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

// bf16 q on the tensor cores, with bf16 (kv_dtype 1) or int8 (2) pages.
// q, out: (B, W, H, D) contiguous bf16; k, v: (N, block_size, KH, D),
// 16-byte aligned, with (N, block_size, KH, 1) f32 scales for int8 (null
// for bf16); table (B, max_blocks), lens and q_lens (B,) int32.
// rows_per_cta slab rows per prefill item (G * rows_per_cta <= 64); split
// keys per decode split, a multiple of 64, and n_splits >= max_blocks *
// block_size / split.  Scratch the caller allocates: part (B, KH, n_splits,
// 16, D + 2) f32 and work: 2 + 2 x (B x max(ceil(W / rows_per_cta),
// n_splits)) int32.  Three kernels on `stream` (the plan and zeros, the
// persistent main pass, the combine); returns 0 or a CUDA error code
// (negative for an unsupported D, page type or arguments); does not
// synchronise.
extern "C" int paged_attention_forward_mma(const void* q, const void* k_pages,
                                           const void* v_pages, const void* k_scale,
                                           const void* v_scale, const void* table,
                                           const void* lens, const void* q_lens, void* out,
                                           void* part, void* work, int B, int W,
                                           int H, int KH, int D, int block_size, int max_blocks,
                                           int window, int rows_per_cta, int split, int n_splits,
                                           int kv_dtype, float scale, void* stream) {
  if (B <= 0 || W <= 0 || (long long)B * W > 0x7fffffff || KH <= 0 || H % KH != 0 ||
      rows_per_cta <= 0 ||
      (H / KH) * rows_per_cta > tc::kRows || split <= 0 || split % tc::kKeys != 0 ||
      (long long)n_splits * split < (long long)max_blocks * block_size ||
      (kv_dtype == 2 && (k_scale == nullptr || v_scale == nullptr)))
    return -3;
  tc::Args a{static_cast<const __nv_bfloat16*>(q), k_pages, v_pages,
             static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
             static_cast<const int*>(table), static_cast<const int*>(lens),
             static_cast<const int*>(q_lens), static_cast<__nv_bfloat16*>(out),
             static_cast<float*>(part), static_cast<int*>(work), B, W, H, KH, block_size,
             max_blocks, window, rows_per_cta, split, n_splits, scale * 1.4426950408889634f};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kv_dtype == 1) {
    switch (D) {
      case 32: return tc::launch<32, __nv_bfloat16>(a, s);
      case 64: return tc::launch<64, __nv_bfloat16>(a, s);
      case 128: return tc::launch<128, __nv_bfloat16>(a, s);
    }
    return -2;
  }
  if (kv_dtype == 2) {
    switch (D) {
      case 32: return tc::launch<32, int8_t>(a, s);
      case 64: return tc::launch<64, int8_t>(a, s);
      case 128: return tc::launch<128, int8_t>(a, s);
    }
    return -2;
  }
  return -1;
}
