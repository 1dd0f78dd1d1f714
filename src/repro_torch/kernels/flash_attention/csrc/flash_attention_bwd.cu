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
// Every sum in f32; dq, dk, dv in the inputs' type.  D 32, 64, 128 or 256.
//
// Bound on an H100 SXM: operations.  The least work is 10 D flops per
// visible (query, key) pair and head (q.k and dO.v once, then dV, dK, dQ)
// at the bf16 tensor-core rate of 989 TFLOP/s (chip_smoke.flash_bwd_bound),
// against q, k, v, o, dO and lse read and dq, dk, dv written once at 3.35
// TB/s.  Three launches on one stream, the first shared by both dtypes:
//   * delta: a warp per (batch, position, head) row, rowsum(dO o) into an
//     f32 (B, H, Sq) scratch;
//   * dk/dv: one CTA per (key block, kv head, batch row; f32 at D 256:
//     and column half) walks the G query heads and every query position
//     that sees its keys (causal: from the block's first key on; window: up
//     to its last key + window - 1), so the GQA fold is a sum in registers:
//     no atomics, and a rerun gives the same bits;
//   * dq: one CTA per query block walks the key tiles its rows see and sums
//     dS K in registers.
//
// bf16 (the model's path): tensor cores, mma.sync m16n8k16 bf16 with f32
// accumulators, FlashAttention-2's backward without its atomics.
//   * dk/dv pass: 4 warps of 16 keys each (64 keys a CTA).  The block's K
//     and V stay in shared memory; tiles of 32 (position, head) rows of q
//     and dO (the G heads of a position side by side, as they lie in
//     memory) stream through a 2-stage cp.async ring with their lse and
//     delta.  A warp computes S^T = K Q^T and dP^T = V dO^T for its 16 keys
//     x 32 rows (K, V as A fragments, Q, dO as B fragments, by ldmatrix),
//     then P^T = exp2(scale log2e S^T - lse log2e) and dS^T = P^T (dP^T -
//     delta) in the accumulator registers, and adds dV += P^T dO and dK +=
//     dS^T Q: the C fragments of P^T and dS^T are the A fragments of those
//     products as they stand (as the forward's P), dO and Q come by
//     ldmatrix.trans, nothing goes through shared memory.  Rows past the
//     range load as zeros: with dO 0 they add nothing.  The grid runs
//     every batch row's and kv head's first key blocks (causal: the most
//     rows) first.
//   * dq pass: the forward's CTA: 64 (position, head) rows of one kv head,
//     16 a warp, q and dO in shared memory (A fragments by ldmatrix at each
//     k-step), 64-key tiles of K and V (D 256: 16) through a 2-stage
//     cp.async ring; S = Q K^T, dP = dO V^T, P and dS in registers, dQ +=
//     dS K (K by ldmatrix.trans); causal grids launch the query blocks with
//     the most key tiles first.
//   * P and dS enter their products as bf16 hi + lo (hi = bf16(x), lo =
//     bf16(x - hi), two mma into one f32 accumulator): rounded once,
//     0.1-5% of dq, dk or dv fall more than one bf16 step from the f32
//     backward (ref.flash_backward_mma_ref, tests/test_torch_flash_backward.py;
//     chip_smoke.py phase 29's control); split, none does.
//   * Only tiles a mask cuts (causal diagonal, window edge, ragged end) are
//     masked element by element; each CTA visits only the tiles its rows
//     or keys can see.  Shared rows are padded by 16 bytes, so the 8 rows
//     an ldmatrix reads fall in distinct banks.  A row's position and head
//     come from a multiply by a reciprocal of G (DivG), not a division.
//   * Registers (a thread): the dk/dv pass holds dK and dV of 16 keys x DC
//     columns, 2 x DC / 2 f32, and S^T and dP^T of 16 keys x 32 rows, 2 x
//     16; at D 128 that is 160 f32 beside the fragments.  At D 256 the 256
//     accumulators of all columns cannot fit the 255 registers a thread
//     has, so the CTA has two groups of 4 warps on the same 64 keys, one
//     for each 128-column half (DC 128, the D 128 budget); group 0
//     computes S^T and P^T, group 1 dP^T, and each thread hands its
//     fragment to the same thread of the other group through shared
//     memory.  The dq pass holds dQ (D / 2) and S and dP of 16 rows x 64
//     keys (2 x 32); at D 256 its 16-key tiles keep that to 128 + 16.
//   * Work done: the dk/dv pass 12 D flops a visible pair (S, dP, and dV,
//     dK each twice for hi + lo), the dq pass 8 D (S, dP again, dQ twice):
//     20 D, twice the least, plus the masked halves of cut tiles.
//   * Shared memory: dk/dv 70,144 bytes at D 128 (two CTAs an SM) and
//     152,064 at D 256 (one CTA of 8 warps); dq 104,448 (two CTAs) and
//     101,376 (two CTAs).
//   * mma.sync, not wgmma/TMA, as the forward.
//
// f32: CUDA cores, exact f32 FMAs (the f32 tolerance rules out TF32).  The
// dk/dv pass takes 32-key blocks and the dq pass 32-position blocks, 4
// warps: a tile step first computes P and dS for 32 rows x 32 keys (lane =
// key, warp = 8 rows; 16-byte shared loads, K/V rows padded by 4 floats so
// the lanes' vectors fall in distinct banks) into shared memory, then each
// thread adds its share of dK and dV (keys 8w..8w+7, columns lane + 32e) or
// of dQ (rows 8w..8w+7, the same columns).  At D 256 the dk/dv pass splits
// each key block into two CTAs of 128 columns (8 x 8 x 2 accumulators
// would be 128 registers a thread).
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

// dK / dV columns one CTA of the dk/dv pass owns: all of them up to D 128,
// half at D 256 (both entries).
template <int D>
constexpr int kCols = D > 128 ? 128 : D;

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

// One CTA per (32-key block, column slice, kv head, batch row): dK and dV
// of its keys in its kCols<D> columns, summed over the G query heads and
// every query tile that sees them.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const float* __restrict__ lse, const T* __restrict__ dout,
            const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int Sq,
            int Sk, int H, int KH, int64_t q_ts, int64_t k_ts, int64_t v_ts, Mask mk,
            float scale) {
  constexpr int LD = kLd<D>;
  constexpr int DC = kCols<D>;
  constexpr int NC = D / DC;
  constexpr int DL = DC / 32;
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
  const int j0 = (blockIdx.x / NC) * kT;
  const int c0 = (blockIdx.x % NC) * DC;
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
      // keys 8w..8w+7, columns c0 + lane + 32e: sum over the tile's rows
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
          const float od = dOs[r * LD + c0 + lane + 32 * e];
          const float qd = Qs[r * LD + c0 + lane + 32 * e];
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
    const int64_t off = (((int64_t)b * Sk + j0 + key) * KH + kh) * D + c0;
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
  dkdv<<<dim3((Sk + kT - 1) / kT * (D / kCols<D>), KH, B), kThreads, smem, stream>>>(
      qp, kp, vp, lse, dop, delta, static_cast<T*>(dk), static_cast<T*>(dv), Sq, Sk, H, KH, q_ts,
      k_ts, v_ts, mk, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dqk<<<dim3((Sq + kT - 1) / kT, H, B), kThreads, smem, stream>>>(
      qp, kp, vp, lse, dop, delta, static_cast<T*>(dq), Sq, Sk, H, KH, q_ts, k_ts, v_ts, mk,
      scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- bf16, tensor cores
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kRows = 64;    // dq pass: (position, head) rows a CTA, 16 a warp
constexpr int kStages = 2;   // ring depth of both passes
constexpr float kLog2e = 1.4426950408889634f;

// dk/dv pass: warps along the keys (16 keys each), and (position, head)
// rows a q/dO tile.  A CTA has kKeyWarps x D / kCols<D> warps: at D 256
// two groups of kKeyWarps, one for each column half of the same keys.
template <int D>
constexpr int kKeyWarps = 4;
template <int D>
constexpr int kQRows = 32;

// dq pass: keys a K/V tile (D 256: 16, so that S and dP fit beside dQ's
// 128 registers and two CTAs' shared memory fit an SM).
template <int D>
constexpr int kTileKeys = D > 128 ? 16 : 64;

__device__ __forceinline__ float plus_inf() { return __uint_as_float(0x7f800000u); }

// 4 bytes from global to shared memory (zeros with `pred` false).
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(pred ? 4 : 0));
}

// v / G by a multiply and a shift, exact for 0 <= v < 2^32 / G (the entry
// checks Sq G^2 < 2^32): m = ceil(2^32 / G).
struct DivG {
  unsigned long long m;
  __device__ explicit DivG(int G) : m((0x100000000ull + G - 1) / G) {}
  __device__ int operator()(int v) const {
    return (int)(((unsigned long long)(unsigned)v * m) >> 32);
  }
};

// dk/dv pass: K, V; the q/dO ring; lse and delta per stage; at D 256 the
// exchange of P^T and dP^T between the two column groups.
template <int D>
constexpr size_t dkdv_smem() {
  return sizeof(bf16) * (2 * 16 * kKeyWarps<D> + kStages * 2 * kQRows<D>) * (D + 8) +
         sizeof(float) * kStages * 2 * kQRows<D> +
         (D > kCols<D> ? sizeof(float) * 2 * kKeyWarps<D> * 32 * kQRows<D> / 2 : 0);
}

template <int D>
constexpr size_t dq_smem() {  // q, dO; the K/V ring
  return sizeof(bf16) * (2 * kRows + kStages * 2 * kTileKeys<D>) * (D + 8);
}

// The A fragments of key step kb of x (16 rows x 16 columns of the C
// fragments of n-blocks 2 kb and 2 kb + 1) as bf16 hi and lo.
__device__ __forceinline__ void split_a(const float (*x)[4], int kb, unsigned hi[4],
                                        unsigned lo[4]) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const float* src = x[2 * kb + (a >> 1)] + 2 * (a & 1);
    const __nv_bfloat162 h2 = __floats2bfloat162_rn(src[0], src[1]);
    hi[a] = *reinterpret_cast<const unsigned*>(&h2);
    lo[a] = pack_bf16(src[0] - __low2float(h2), src[1] - __high2float(h2));
  }
}

// c[2 n], c[2 n + 1] += (hi + lo) f with f the four ldmatrix.trans
// registers of columns 16 n .. 16 n + 15.
__device__ __forceinline__ void mma_hi_lo(float (*c)[4], int n, const unsigned hi[4],
                                          const unsigned lo[4], const unsigned f[4]) {
  mma_bf16_16816(c[2 * n], hi, f[0], f[1]);
  mma_bf16_16816(c[2 * n], lo, f[0], f[1]);
  mma_bf16_16816(c[2 * n + 1], hi, f[2], f[3]);
  mma_bf16_16816(c[2 * n + 1], lo, f[2], f[3]);
}

// One CTA per (kv head and batch row, block of 16 kKeyWarps keys): dK and
// dV of its keys, each warp 16 keys in kCols<D> columns.
template <int D>
__global__ void __launch_bounds__(32 * kKeyWarps<D> * (D / kCols<D>), 1)
dkdv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const float* __restrict__ lse,
                const bf16* __restrict__ dout, const float* __restrict__ delta,
                bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Sk, int H, int KH,
                int64_t q_ts, int64_t k_ts, int64_t v_ts, Mask mk, float scale_log2,
                float scale) {
  constexpr int LD = D + 8;   // shared row stride (elements): +16 bytes
  constexpr int KD = D / 16;  // mma k-steps over d
  constexpr int CH = D / 8;   // 16-byte chunks a row
  constexpr int DC = kCols<D>;
  constexpr int KW = kKeyWarps<D>;
  constexpr int KEYS = 16 * KW;
  constexpr int NT = 32 * KW * (D / DC);  // threads
  constexpr int NR = kQRows<D> / 8;  // n-blocks of a tile's rows
  constexpr bool kShare = D > DC;     // two column groups split S^T and dP^T
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* const Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* const Vs = Ks + KEYS * LD;
  bf16* const ring = Vs + KEYS * LD;
  float* const stats = reinterpret_cast<float*>(ring + kStages * 2 * kQRows<D> * LD);
  // D 256: [element][key warp][lane] of each thread's P^T (group 0) and dP^T
  float* const xch = stats + kStages * 2 * kQRows<D>;
  auto q_tile = [&](int st) { return ring + (2 * st) * kQRows<D> * LD; };
  auto do_tile = [&](int st) { return ring + (2 * st + 1) * kQRows<D> * LD; };
  auto lse_tile = [&](int st) { return stats + (2 * st) * kQRows<D>; };
  auto delta_tile = [&](int st) { return stats + (2 * st + 1) * kQRows<D>; };

  const int kh = blockIdx.x % KH, b = blockIdx.x / KH;
  const int j0 = blockIdx.y * KEYS;  // causal: every batch row's heaviest blocks first
  const int nk = min(KEYS, Sk - j0);
  const int G = H / KH;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kw = warp % KW, cw = warp / KW;  // this warp's keys and column group
  const int c0 = cw * DC;
  const int g = lane >> 2, t4 = lane & 3;
  const DivG by_g(G);

  // Positions that see a key of this block, [i_lo, i_hi], as rows R = i G +
  // head (the G heads of a position side by side).
  const int i_lo = mk.causal && j0 >= mk.prefix ? j0 : 0;
  const int i_hi = mk.window > 0 ? min(Sq - 1, j0 + nk - 1 + mk.window - 1) : Sq - 1;
  const int R_lo = i_lo * G;
  const int n_rows = i_hi >= i_lo ? (i_hi - i_lo + 1) * G : 0;
  const int n_tiles = (n_rows + kQRows<D> - 1) / kQRows<D>;

  const bf16* kb = k + ((int64_t)b * Sk + j0) * k_ts + (int64_t)kh * D;
  const bf16* vb = v + ((int64_t)b * Sk + j0) * v_ts + (int64_t)kh * D;
#pragma unroll
  for (int c = tid; c < KEYS * CH; c += NT) {
    const int j = c / CH, d0 = (c % CH) * 8;
    const bool ok = j < nk;
    const int64_t jj = ok ? j : 0;
    cp_async16(Ks + j * LD + d0, kb + jj * k_ts + d0, ok);
    cp_async16(Vs + j * LD + d0, vb + jj * v_ts + d0, ok);
  }

  // Tile t of rows (q, dO, lse, delta) into stage st; rows past the range
  // are zeros, so with dO 0 they add nothing to dV or dK (dS = P (0 - 0)).
  auto load_rows = [&](int t, int st) {
    const int R0 = R_lo + t * kQRows<D>;
    bf16* qs = q_tile(st);
    bf16* ds = do_tile(st);
#pragma unroll
    for (int c = tid; c < kQRows<D> * CH; c += NT) {
      const int r = c / CH, d0 = (c % CH) * 8;
      const int R = R0 + r;
      const bool ok = R - R_lo < n_rows;
      const int i = ok ? by_g(R) : 0, h = ok ? kh * G + R - i * G : 0;
      cp_async16(qs + r * LD + d0, q + ((int64_t)b * Sq + i) * q_ts + (int64_t)h * D + d0, ok);
      cp_async16(ds + r * LD + d0, dout + (((int64_t)b * Sq + i) * H + h) * D + d0, ok);
    }
    if (tid < kQRows<D>) {
      const int R = R0 + tid;
      const bool ok = R - R_lo < n_rows;
      const int i = ok ? by_g(R) : 0;
      const int64_t row = ok ? ((int64_t)b * H + kh * G + R - i * G) * Sq + i : 0;
      cp_async4(lse_tile(st) + tid, lse + row, ok);
      cp_async4(delta_tile(st) + tid, delta + row, ok);
    }
  };

  if (n_tiles > 0) load_rows(0, 0);
  cp_async_commit();

  float dv_acc[DC / 8][4], dk_acc[DC / 8][4];
#pragma unroll
  for (int j = 0; j < DC / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dv_acc[j][e] = dk_acc[j][e] = 0.f;

  // this warp's 16 keys as A fragments (ldmatrix at each k-step)
  const int a_off = (kw * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
  // B fragments (rows x d, non-transposed) and transposed ones
  const int b_off = ((lane & 7) + (lane >> 4) * 8) * LD + ((lane >> 3) & 1) * 8;
  const int bt_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8;
  const int key_lo = j0 + kw * 16 + g;  // this thread's keys: key_lo, key_lo + 8
  const int j_last = j0 + KEYS - 1;

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) load_rows(t + 1, (t + 1) % kStages);
    cp_async_commit();
    cp_async_wait<1>();  // tile t (and K, V) has landed for this thread ...
    __syncthreads();     // ... and for every thread
    const bf16* qs = q_tile(t % kStages);
    const bf16* ds = do_tile(t % kStages);
    const float* lses = lse_tile(t % kStages);
    const float* dls = delta_tile(t % kStages);

    // S^T = K Q^T and dP^T = V dO^T: 16 keys x 32 rows a warp; at D 256
    // column group 0 computes S^T and group 1 dP^T, and they swap below
    float s[NR][4], dp[NR][4];
#pragma unroll
    for (int j = 0; j < NR; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    auto scores = [&](float (*acc)[4], const bf16* a, const bf16* rows) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        unsigned fa[4];
        ldmatrix_x4(fa, a + a_off + kk * 16);
#pragma unroll
        for (int np = 0; np < kQRows<D> / 16; ++np) {
          unsigned f[4];  // rows np*16 + {0..7, 8..15} x d kk*16 + {0..7, 8..15}
          ldmatrix_x4(f, rows + np * 16 * LD + b_off + kk * 16);
          mma_bf16_16816(acc[2 * np], fa, f[0], f[1]);
          mma_bf16_16816(acc[2 * np + 1], fa, f[2], f[3]);
        }
      }
    };
    if (!kShare || cw == 0) scores(s, Ks, qs);
    if (!kShare || cw == 1) scores(dp, Vs, ds);

    // P^T (scale applied at the store); mask only a cut tile
    const int R0 = R_lo + t * kQRows<D>;
    if (!kShare || cw == 0) {
      const int p_min = by_g(R0);
      const int p_max = min(i_hi, by_g(R0 + kQRows<D> - 1));
      const bool cut = j_last >= Sk || (mk.causal && p_min < j_last && j_last >= mk.prefix) ||
                       (mk.window > 0 && p_max - j0 >= mk.window);
#pragma unroll
      for (int j = 0; j < NR; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 8 * j + 2 * t4 + (e & 1);
          float x = fmaf(s[j][e], scale_log2, -kLog2e * lses[r]);
          if (cut && !visible(by_g(R0 + r), key_lo + 8 * (e >> 1), Sq, Sk, mk))
            x = -plus_inf();
          s[j][e] = exp2f(x);
        }
    }
    if constexpr (kShare) {  // each thread's fragment, by the same thread of the other group
      float* const mine = xch + (cw * 4 * NR * KW + kw) * 32 + lane;
      const float* const theirs = xch + ((1 - cw) * 4 * NR * KW + kw) * 32 + lane;
#pragma unroll
      for (int j = 0; j < NR; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mine[(4 * j + e) * KW * 32] = cw == 0 ? s[j][e] : dp[j][e];
      __syncthreads();
#pragma unroll
      for (int j = 0; j < NR; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = theirs[(4 * j + e) * KW * 32];
          if (cw == 0) dp[j][e] = x; else s[j][e] = x;
        }
    }
    // dS^T
#pragma unroll
    for (int j = 0; j < NR; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[j][e] = s[j][e] * (dp[j][e] - dls[8 * j + 2 * t4 + (e & 1)]);

    // dV += P^T dO, dK += dS^T Q over the CTA's columns, hi + lo
#pragma unroll
    for (int kb2 = 0; kb2 < kQRows<D> / 16; ++kb2) {
      unsigned ph[4], pl[4], sh[4], sl[4];
      split_a(s, kb2, ph, pl);
      split_a(dp, kb2, sh, sl);
#pragma unroll
      for (int n = 0; n < DC / 16; ++n) {
        unsigned f[4];  // rows kb2*16 + {0..7, 8..15} x d c0 + n*16 + {0..7, 8..15}, transposed
        ldmatrix_x4_trans(f, ds + kb2 * 16 * LD + bt_off + c0 + n * 16);
        mma_hi_lo(dv_acc, n, ph, pl, f);
        ldmatrix_x4_trans(f, qs + kb2 * 16 * LD + bt_off + c0 + n * 16);
        mma_hi_lo(dk_acc, n, sh, sl, f);
      }
    }
    __syncthreads();  // this stage is consumed before the next load refills it
  }
  cp_async_wait<0>();  // K and V, where no tile was visited

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = key_lo + 8 * h;
    if (key >= Sk) continue;
    const int64_t off = (((int64_t)b * Sk + key) * KH + kh) * D + c0 + 2 * t4;
#pragma unroll
    for (int j = 0; j < DC / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dv + off + 8 * j) =
          __floats2bfloat162_rn(dv_acc[j][2 * h], dv_acc[j][2 * h + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dk + off + 8 * j) =
          __floats2bfloat162_rn(dk_acc[j][2 * h] * scale, dk_acc[j][2 * h + 1] * scale);
    }
  }
}

// One CTA per (64 (position, head) rows of one kv head, batch row): dQ of
// its rows over the key tiles they see.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
              const float* __restrict__ lse, const bf16* __restrict__ dout,
              const float* __restrict__ delta, bf16* __restrict__ dq, int Sq, int Sk, int H,
              int KH, int64_t q_ts, int64_t k_ts, int64_t v_ts, Mask mk, int rows_per_cta,
              int n_qblocks, float scale_log2, float scale) {
  constexpr int LD = D + 8;
  constexpr int KD = D / 16;
  constexpr int CH = D / 8;
  constexpr int KN = kTileKeys<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* const Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* const dOs = Qs + kRows * LD;
  bf16* const ring = dOs + kRows * LD;
  auto k_tile = [&](int st) { return ring + (2 * st) * KN * LD; };
  auto v_tile = [&](int st) { return ring + (2 * st + 1) * KN * LD; };

  const int kh = blockIdx.x % KH;
  const int b = blockIdx.x / KH;
  const int qb = mk.causal ? n_qblocks - 1 - (int)blockIdx.y : (int)blockIdx.y;  // longest first
  const int i0 = qb * rows_per_cta;
  const int G = H / KH;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int nq = min(rows_per_cta, Sq - i0);
  const int nrows = G * nq;

  // Keys any row of this CTA can see: [lo, hi].
  int hi = Sk - 1;
  if (mk.causal) hi = min(hi, max(i0 + nq - 1, mk.prefix - 1));
  const int lo = mk.window > 0 ? max(0, i0 - mk.window + 1) : 0;
  const int n_tiles = hi >= lo ? (hi - lo) / KN + 1 : 0;
  const bf16* kb = k + (int64_t)b * Sk * k_ts + (int64_t)kh * D;
  const bf16* vb = v + (int64_t)b * Sk * v_ts + (int64_t)kh * D;

  auto load_keys = [&](int tile, int st) {
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

  // q and dO rows, then key tile 0; both awaited.
#pragma unroll
  for (int c = tid; c < kRows * CH; c += kThreads) {
    const int r = c / CH, d0 = (c % CH) * 8;
    const bool ok = r < nrows;
    const int i = ok ? i0 + r / G : 0, h = ok ? kh * G + r % G : 0;
    cp_async16(Qs + r * LD + d0, q + ((int64_t)b * Sq + i) * q_ts + (int64_t)h * D + d0, ok);
    cp_async16(dOs + r * LD + d0, dout + (((int64_t)b * Sq + i) * H + h) * D + d0, ok);
  }
  if (n_tiles > 0) load_keys(0, 0);
  cp_async_commit();

  // This thread's two rows: r0 = warp * 16 + g and r0 + 8; a dead row gets
  // lse +inf, so its P is 0.
  const int r0 = warp * 16 + g;
  int pos[2];
  float l2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    pos[h] = i0 + r / G;
    l2[h] = plus_inf();
    dl[h] = 0.f;
    if (r < nrows) {
      const int64_t row = ((int64_t)b * H + kh * G + r % G) * Sq + pos[h];
      l2[h] = lse[row] * kLog2e;
      dl[h] = delta[row];
    }
  }
  const int i_max = i0 + nq - 1;
  const int a_off = (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
  const int b_off = ((lane & 7) + (lane >> 4) * 8) * LD + ((lane >> 3) & 1) * 8;
  const int bt_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8;

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    if (tile + 1 < n_tiles) load_keys(tile + 1, (tile + 1) % kStages);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* ks = k_tile(tile % kStages);
    const bf16* vs = v_tile(tile % kStages);
    const int t0 = lo + tile * KN;

    // S = Q K^T and dP = dO V^T: 16 rows x KN keys a warp
    float s[KN / 8][4], dp[KN / 8][4];
#pragma unroll
    for (int j = 0; j < KN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      unsigned qa[4], da[4];
      ldmatrix_x4(qa, Qs + a_off + kk * 16);
      ldmatrix_x4(da, dOs + a_off + kk * 16);
#pragma unroll
      for (int np = 0; np < KN / 16; ++np) {
        unsigned f[4];  // keys np*16 + {0..7, 8..15} x d kk*16 + {0..7, 8..15}
        ldmatrix_x4(f, ks + np * 16 * LD + b_off + kk * 16);
        mma_bf16_16816(s[2 * np], qa, f[0], f[1]);
        mma_bf16_16816(s[2 * np + 1], qa, f[2], f[3]);
        ldmatrix_x4(f, vs + np * 16 * LD + b_off + kk * 16);
        mma_bf16_16816(dp[2 * np], da, f[0], f[1]);
        mma_bf16_16816(dp[2 * np + 1], da, f[2], f[3]);
      }
    }

    // P and dS (scale applied at the store); mask only a cut tile
    const int t_end = t0 + KN - 1;
    const bool cut = t_end > hi || (mk.causal && t_end > i0 && t_end >= mk.prefix) ||
                     (mk.window > 0 && i_max - t0 >= mk.window);
#pragma unroll
    for (int j = 0; j < KN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        float x = s[j][e] * scale_log2 - l2[h];
        if (cut) {
          const int p = t0 + 8 * j + 2 * t4 + (e & 1);
          if (p > hi || !visible(pos[h], p, Sq, Sk, mk)) x = -plus_inf();
        }
        const float pr = exp2f(x);
        dp[j][e] = pr * (dp[j][e] - dl[h]);
      }

    // dQ += dS K, hi + lo
#pragma unroll
    for (int kb2 = 0; kb2 < KN / 16; ++kb2) {
      unsigned sh[4], sl[4];
      split_a(dp, kb2, sh, sl);
#pragma unroll
      for (int n = 0; n < D / 16; ++n) {
        unsigned f[4];  // keys kb2*16 + {0..7, 8..15} x d n*16 + {0..7, 8..15}, transposed
        ldmatrix_x4_trans(f, ks + kb2 * 16 * LD + bt_off + n * 16);
        mma_hi_lo(acc, n, sh, sl, f);
      }
    }
    __syncthreads();  // this stage is consumed before the next load refills it
  }
  cp_async_wait<0>();  // q and dO, where no tile was visited

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (r >= nrows) continue;
    bf16* orow = dq + (((int64_t)b * Sq + pos[h]) * H + kh * G + r % G) * D + 2 * t4;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(acc[j][2 * h] * scale, acc[j][2 * h + 1] * scale);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o, const float* lse,
           const void* dout, void* dq, void* dk, void* dv, float* delta, int B, int Sq, int Sk,
           int H, int KH, long long q_ts, long long k_ts, long long v_ts, Mask mk, float scale,
           cudaStream_t stream) {
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const bf16* dop = static_cast<const bf16*>(dout);
  const long long rows = (long long)B * Sq * H;
  delta_kernel<bf16><<<(unsigned)((rows + kWarps - 1) / kWarps), kThreads, 0, stream>>>(
      static_cast<const bf16*>(o), dop, delta, rows, Sq, H, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int G = H / KH;
  const int rows_per_cta = kRows / G;
  const int n_qblocks = (Sq + rows_per_cta - 1) / rows_per_cta;
  if (rows_per_cta < 1 || n_qblocks > 65535) return -3;
  constexpr size_t smem_kv = dkdv_smem<D>();
  constexpr size_t smem_q = dq_smem<D>();
  auto dkdv = dkdv_mma_kernel<D>;
  auto dqk = dq_mma_kernel<D>;
  err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_kv);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_q);
  if (err != cudaSuccess) return (int)err;
  const float scale_log2 = scale * kLog2e;
  constexpr int keys = 16 * kKeyWarps<D>;
  if ((Sk + keys - 1) / keys > 65535) return -3;
  dkdv<<<dim3(B * KH, (Sk + keys - 1) / keys), keys * 2 * (D / kCols<D>), smem_kv, stream>>>(
      qp, kp, vp, lse, dop, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), Sq, Sk, H,
      KH, q_ts, k_ts, v_ts, mk, scale_log2, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dqk<<<dim3(B * KH, n_qblocks), kThreads, smem_q, stream>>>(
      qp, kp, vp, lse, dop, delta, static_cast<bf16*>(dq), Sq, Sk, H, KH, q_ts, k_ts, v_ts, mk,
      rows_per_cta, n_qblocks, scale_log2, scale);
  return (int)cudaGetLastError();
}

}  // namespace tc

#define FA_BWD_ARGS \
  q, k, v, o, lse, dout, dq, dk, dv, delta, B, Sq, Sk, H, KH, q_ts, k_ts, v_ts, mk, scale, stream

int launch_f32(int D, const void* q, const void* k, const void* v, const void* o,
               const float* lse, const void* dout, void* dq, void* dk, void* dv, float* delta,
               int B, int Sq, int Sk, int H, int KH, long long q_ts, long long k_ts,
               long long v_ts, Mask mk, float scale, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<float, 32>(FA_BWD_ARGS);
    case 64: return launch<float, 64>(FA_BWD_ARGS);
    case 128: return launch<float, 128>(FA_BWD_ARGS);
    case 256: return launch<float, 256>(FA_BWD_ARGS);
  }
  return -2;
}

int launch_bf16(int D, const void* q, const void* k, const void* v, const void* o,
                const float* lse, const void* dout, void* dq, void* dk, void* dv, float* delta,
                int B, int Sq, int Sk, int H, int KH, long long q_ts, long long k_ts,
                long long v_ts, Mask mk, float scale, cudaStream_t stream) {
  switch (D) {
    case 32: return tc::launch<32>(FA_BWD_ARGS);
    case 64: return tc::launch<64>(FA_BWD_ARGS);
    case 128: return tc::launch<128>(FA_BWD_ARGS);
    case 256: return tc::launch<256>(FA_BWD_ARGS);
  }
  return -2;
}

#undef FA_BWD_ARGS

}  // namespace

// q: (B, Sq, H, D), k and v: (B, Sk, KH, D), each with unit stride over D, D
// elements between heads and q_ts / k_ts / v_ts elements between tokens
// (batch rows S * ts apart), 16-byte aligned rows (the forward's layouts);
// o and dout: (B, Sq, H, D) contiguous; lse: (B, H, Sq) f32, the forward's
// logsumexp (natural log); dq (B, Sq, H, D), dk and dv (B, Sk, KH, D):
// contiguous outputs; delta: (B, H, Sq) f32 scratch.  dtype 0 = f32 (CUDA
// cores), 1 = bf16 (tensor cores) for q, k, v, o, dout, dq, dk, dv; H / KH
// <= 64.  D 32, 64, 128 or 256.  Returns 0 or a CUDA error code (negative
// for bad arguments); launches on `stream` and does not synchronise.
extern "C" int flash_attention_backward(const void* q, const void* k, const void* v,
                                        const void* o, const float* lse, const void* dout,
                                        void* dq, void* dk, void* dv, float* delta, int B,
                                        int Sq, int Sk, int H, int KH, int D, long long q_ts,
                                        long long k_ts, long long v_ts, int causal, int window,
                                        int prefix, int dtype, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KH <= 0 || H % KH != 0 || H / KH > 64 || B > 65535 ||
      H > 65535 || (long long)Sq * (H / KH) * (H / KH) >= (1ll << 32))
    return -3;
  const Mask mk{causal, window, prefix};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_f32(D, q, k, v, o, lse, dout, dq, dk, dv, delta, B, Sq, Sk, H, KH, q_ts, k_ts,
                      v_ts, mk, scale, s);
  if (dtype == 1)
    return launch_bf16(D, q, k, v, o, lse, dout, dq, dk, dv, delta, B, Sq, Sk, H, KH, q_ts,
                       k_ts, v_ts, mk, scale, s);
  return -1;
}
