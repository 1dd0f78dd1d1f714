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
// the state after the last token (the prefill's decode cache).  w is f32,
// u is (H, D) f32; the output is f32.  Two entries of one signature:
//
// wkv_forward_mma (bf16 r/k/v, the model's prefill): tensor cores.
//   Bound on an H100 SXM at the rwkv6-1.6b prefill (B 8, S 2048, H 32,
//   D 64): bytes, 470 MB (r/k/v bf16, w and the output f32) at 3.35 TB/s,
//   0.141 ms; the ~6 D^2 flops a token and head, at a third of the TF32
//   tensor-core peak (3xTF32), take 0.078 ms.  Design:
//   * one CTA per (b, h), 8 warps at D 64: o_t[e] and S[:, e] read only
//     column e of S and v, so the value columns split into 16-column slices,
//     two warps a slice, each holding the slice's 16 x D S^T in registers as
//     mma accumulators for the whole sequence (both update it, bit for bit
//     alike; they split the chunk's output tokens); the chunk's c x c
//     weights are computed once and shared through shared memory;
//   * per chunk (c = 16, 32 or 64 tokens; the TPU's sequential chunk axis
//     is the CTA's loop), in four phases between barriers:
//     1. log2 w (w read into registers a chunk ahead) and its cumsum L, a
//        channel's tokens over four adjacent lanes, joined by shuffles;
//     2. the decayed operands, every exponent <= 0 (ex2.approx): 16-token
//        tiles factor at their edges, 2^(Lq_t - L_s) = 2^(Lq_t - P_T)
//        2^(P_T - E_s) 2^(E_s - L_s) for s in an earlier tile (P_T = Lq at
//        T's first token, E_s = L at the end of s's tile), a tile's second
//        half against its first at the first half's last token the same
//        way; rdec = rhat 2^P_T and kfut = kbar 2^(Lc - E_T) by
//        multiplication (rhat = r 2^(Lq - P_T), kbar = k 2^(E_T - L));
//     3. the weights A: the factored blocks as products on the tensor
//        cores; only 8-token diagonal halves keep the per-element form
//        sum_d r k 2^(Lq_t - L_s), a warp a half, a lane a channel, the
//        28 pair sums reduced across the lanes by a shuffle reduce-scatter;
//     4. o^T = S^T rdec^T + v^T A^T and S^T = S^T diag(2^Lc) + v^T kfut,
//        with S^T's accumulator fragments reused as the next A operand (the
//        contraction index permuted inside each 8-column group, and the
//        shared operands stored in that order);
//     nothing overflows however strong the decay (kernel.py:10-12);
//   * precision: mma.sync m16n8k8 TF32 with every operand that carries a
//     decay (or S) split into TF32 hi + lo (hi rounded, lo truncated, by
//     integer operations: cvt.rna.tf32 costs ~10 instructions on sm_90a):
//     hi.hi + hi.lo + lo.hi, ~2^-21 of each product; bf16 v is exact in
//     TF32, so its products take two mma, not three.  One rounding misses
//     the 1e-5 tolerance (~3e-4);
//   * cp.async double-buffers the next chunk's r/k/v while this one runs.
//   A ragged last chunk is zero-filled (r = k = v = 0) with log w = 0, which
//   leaves the state and the written outputs unchanged.
//
// wkv_forward (f32 r/k/v): CUDA cores, one CTA per (b, h),
//   the state in shared memory, the exponent-weighted c x c x D contraction
//   per element (the first port's design, kept for f32, whose inputs the
//   tensor cores would round).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (repro_torch/kernels/_build.py).  Plain C entry
// points, bound with ctypes by repro_torch/kernels/rwkv6/kernel.py.

#include "../../csrc/tf32_mma.cuh"

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

template <int D, int C>
__global__ void __launch_bounds__(kThreads)
wkv_kernel(const float* __restrict__ r, const float* __restrict__ k, const float* __restrict__ v,
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
        rv = r[g];
        kv = k[g];
        vv = v[g];
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

template <int D, int C>
int launch(const void* r, const void* k, const void* v, const void* w, const void* u,
           const void* state_in, void* out, void* state_out, int B, int S, int H,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * Smem<D, C>::TOTAL;
  auto kernel = wkv_kernel<D, C>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B * H, kThreads, smem, stream>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(w), static_cast<const float*>(u),
      static_cast<const float*>(state_in), static_cast<float*>(out),
      static_cast<float*>(state_out), S, H);
  return (int)cudaGetLastError();
}

template <int D>
int launch_c(int chunk, const void* r, const void* k, const void* v, const void* w,
             const void* u, const void* state_in, void* out, void* state_out, int B, int S,
             int H, cudaStream_t stream) {
  switch (chunk) {
    case 16: return launch<D, 16>(r, k, v, w, u, state_in, out, state_out, B, S, H, stream);
    case 32: return launch<D, 32>(r, k, v, w, u, state_in, out, state_out, B, S, H, stream);
    case 64: return launch<D, 64>(r, k, v, w, u, state_in, out, state_out, B, S, H, stream);
  }
  return -2;
}

int launch_d(int D, int chunk, const void* r, const void* k, const void* v, const void* w,
             const void* u, const void* state_in, void* out, void* state_out, int B, int S,
             int H, cudaStream_t stream) {
  switch (D) {
    case 32: return launch_c<32>(chunk, r, k, v, w, u, state_in, out, state_out, B, S, H, stream);
    case 64: return launch_c<64>(chunk, r, k, v, w, u, state_in, out, state_out, B, S, H, stream);
  }
  return -2;
}

// ---------------------------------------------------------------- tensor cores
// wkv_forward_mma: bf16 r/k/v, TF32 mma.sync with hi + lo operands (the
// helpers, kTile and kHalf in kernels/csrc/tf32_mma.cuh, shared with the
// backward).

using bf16 = __nv_bfloat16;

template <int D, int C>
struct MmaSmem {
  static constexpr int NT = C / kTile;
  static constexpr int THREADS = 64 * (D / 16);  // two warps a 16-column slice
  static constexpr int RB = D + 8;   // bf16 row of staged r, k, v (16-byte multiple)
  static constexpr int PR = D + 4;   // f32 row read as fragment rows g (conflict-free)
  static constexpr int PK = D + 8;   // f32 row read as fragment rows q
  static constexpr int PA = C + 4;   // f32 row of the weights A
  // bytes of one cp.async stage: r, k, v
  static constexpr int SR = 0, SK = SR + C * RB * 2, SV = SK + C * RB * 2;
  static constexpr int STAGE = SV + C * RB * 2;
  // f32 (or TF32 bit) arrays after the two stages, offsets in floats.  rhat
  // has rows for tiles 1.., kbar for tiles ..NT-2 (the off-diagonal tiles'
  // operands); rdec and kfut are stored as TF32 hi and lo.
  static constexpr int LQ = 0, L = LQ + C * PR, RH = L + C * PR, KB = RH + (C - kTile) * PR;
  static constexpr int RT = KB + (C - kTile) * PK, KT = RT + C / 2 * PR;
  static constexpr int RDH = KT + C / 2 * PK, RDL = RDH + C * PR;
  static constexpr int KFH = RDL + C * PR, KFL = KFH + C * PK;
  static constexpr int A = KFL + C * PK, PDEC = A + C * PA, KDEC = PDEC + NT * D;
  static constexpr int CROSS = KDEC + NT * D, SDEC = CROSS + NT * NT * D;
  static constexpr int U = SDEC + D, BONUS = U + D, FLOATS = BONUS + 2 * C;
  static constexpr int BYTES = 2 * STAGE + 4 * FLOATS;
};

template <int D, int C>
__global__ void __launch_bounds__(MmaSmem<D, C>::THREADS, C <= 32 ? 2 : 1)
wkv_mma_kernel(const bf16* __restrict__ r, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const float* __restrict__ w,
               const float* __restrict__ u, const float* __restrict__ state_in,
               float* __restrict__ out, float* __restrict__ state_out, int S, int H) {
  using M = MmaSmem<D, C>;
  constexpr int NT = M::NT, RB = M::RB;
  constexpr int PR = M::PR, PK = M::PK, PA = M::PA;
  constexpr int kT = M::THREADS, kW = kT / 32;
  constexpr int NSL = D / 16;      // 16-column slices; warps w and w + NSL share one
  constexpr int KS = D / 8;        // 8-channel k-steps
  constexpr int CT = C / 8;        // 8-token blocks of a chunk
  constexpr int CH = CT / 2;       // blocks of each warp of a slice's pair
  constexpr int TPC = kT / D;      // scan threads a channel
  constexpr int TOK = C / TPC;     // tokens a scan thread
  static_assert(D % 16 == 0 && C % kTile == 0 && kT % D == 0 && C % TPC == 0, "shapes");
  extern __shared__ __align__(16) unsigned char smem_mma[];
  float* F = reinterpret_cast<float*>(smem_mma + 2 * M::STAGE);
  float* Lq = F + M::LQ;
  float* L = F + M::L;
  float* Rh = F + M::RH;
  float* Kb = F + M::KB;
  float* Rt = F + M::RT;
  float* Kt = F + M::KT;
  unsigned* RdH = reinterpret_cast<unsigned*>(F + M::RDH);
  unsigned* RdL = reinterpret_cast<unsigned*>(F + M::RDL);
  unsigned* KfH = reinterpret_cast<unsigned*>(F + M::KFH);
  unsigned* KfL = reinterpret_cast<unsigned*>(F + M::KFL);
  float* A = F + M::A;
  float* Pdec = F + M::PDEC;
  float* Kdec = F + M::KDEC;
  float* Cross = F + M::CROSS;
  float* Sdec = F + M::SDEC;
  float* Us = F + M::U;
  float* Bonus = F + M::BONUS;  // the bonus's partial sums: (D / 32) x C

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int64_t sD = (int64_t)H * D;                          // stride of one token
  const int64_t base = (int64_t)b * S * sD + (int64_t)h * D;  // token 0 of (b, h)
  const int64_t sbase = (int64_t)bh * D * D;
  const int e0 = (warp % NSL) * 16;  // this warp's 16 value columns
  const int x0 = (warp / NSL) * CH;  // this warp's first 8-token block of the outputs

  for (int i = tid; i < C * PA; i += kT) A[i] = 0.f;  // the upper triangle stays 0
  for (int i = tid; i < D; i += kT) Us[i] = u[h * D + i];

  // S^T (the slice's 16 value columns x D channels) as accumulators: St[j]
  // holds columns e0 + g, e0 + g + 8 and channels 8j + 2q, 8j + 2q + 1.  Both
  // warps of a slice carry it (the same products, bit for bit).
  float St[KS][4];
#pragma unroll
  for (int j = 0; j < KS; ++j) {
    const int64_t i0 = sbase + (int64_t)(8 * j + 2 * q) * D + e0 + g;
    St[j][0] = state_in ? state_in[i0] : 0.f;
    St[j][1] = state_in ? state_in[i0 + D] : 0.f;
    St[j][2] = state_in ? state_in[i0 + 8] : 0.f;
    St[j][3] = state_in ? state_in[i0 + D + 8] : 0.f;
  }

  auto load = [&](int chunk, int stage) {
    unsigned char* st = smem_mma + stage * M::STAGE;
    const int t0 = chunk * C, nt = min(C, S - t0);
    // trip counts known at compile time (kT divides them or exceeds them)
#pragma unroll
    for (int i0 = 0; i0 < C * (D / 8); i0 += kT) {
      const int i = i0 + tid;
      const int t = i / (D / 8), p = (i % (D / 8)) * 8;
      const bool ok = t < nt && i < C * (D / 8);
      const int64_t gi = ok ? base + (int64_t)(t0 + t) * sD + p : base;
      if (i < C * (D / 8)) {
        cp_async16(reinterpret_cast<bf16*>(st + M::SR) + t * RB + p, r + gi, ok);
        cp_async16(reinterpret_cast<bf16*>(st + M::SK) + t * RB + p, k + gi, ok);
        cp_async16(reinterpret_cast<bf16*>(st + M::SV) + t * RB + p, v + gi, ok);
      }
    }
  };
  // The scan threads: channel sd_ of the decay, tokens part * TOK.., lanes
  // of one channel adjacent.  w goes to registers a chunk ahead.
  const int dch = tid / TPC, part = tid % TPC;
  float wr[TOK];
  auto load_w = [&](int chunk) {
    const int t0 = chunk * C, nt = min(C, S - t0);
#pragma unroll
    for (int i = 0; i < TOK; ++i) {
      const int t = part * TOK + i;
      wr[i] = t < nt ? w[base + (int64_t)(t0 + t) * sD + dch] : 1.f;  // log w = 0 past S
    }
  };

  const int N = (S + C - 1) / C;
  load(0, 0);
  cp_async_commit();
  load_w(0);
  for (int n = 0; n < N; ++n) {
    const int stage = n & 1;
    if (n + 1 < N) load(n + 1, stage ^ 1);
    cp_async_commit();
    const unsigned char* st = smem_mma + stage * M::STAGE;
    const bf16* rs = reinterpret_cast<const bf16*>(st + M::SR);
    const bf16* ks = reinterpret_cast<const bf16*>(st + M::SK);
    const bf16* vs = reinterpret_cast<const bf16*>(st + M::SV);
    const int t0 = n * C, nt = min(C, S - t0);

    // 1. log2 w and its chunk cumsums L (inclusive) and Lq = L - log2 w:
    //    each thread over its tokens in registers, then across the TPC
    //    threads of the channel by shuffles.
    {
      float lw[TOK], tot = 0.f;
#pragma unroll
      for (int i = 0; i < TOK; ++i) {
        lw[i] = log2f(fmaxf(wr[i], 1e-12f));
        tot += lw[i];
      }
      float incl = tot;
#pragma unroll
      for (int o = 1; o < TPC; o <<= 1) {
        const float y = __shfl_up_sync(kFull, incl, o, TPC);
        if (part >= o) incl += y;
      }
      // a part holds whole tiles (TOK >= 16) or a tile spans whole parts
      constexpr int TPP = TOK >= kTile ? TOK / kTile : 1;  // tiles of a part
      float acc = incl - tot, lp[TPP], le[TPP];
#pragma unroll
      for (int i = 0; i < TOK; ++i) {
        const int t = part * TOK + i;
        if (i % kTile == 0) lp[i / kTile] = acc;
        Lq[t * PR + dch] = acc;
        acc += lw[i];
        L[t * PR + dch] = acc;
        if (i % kTile == kTile - 1 || i == TOK - 1) le[i / kTile] = acc;
      }
      // the channel's tile decays, P_T (Lq at T's first token) and E_T (L at
      // its last) from the part that holds that token: 2^P_T, 2^(Lc - E_T),
      // 2^(P_T - E_tau) and 2^Lc, stored in mma column order.  Every one of
      // them is a value stored in Lq / L (Lc: L at the last token), so the
      // factors of a weight cancel exactly: |L| reaches ~250 under strong
      // decay, where two roundings of one cumsum differ by 1.5e-5
      const float lc = __shfl_sync(kFull, acc, TPC - 1, TPC);
      float P[NT], Et[NT];
#pragma unroll
      for (int T = 0; T < NT; ++T) {
        const int t0T = T * kTile, t1T = T * kTile + kTile - 1;
        P[T] = __shfl_sync(kFull, lp[(t0T % TOK) / kTile], t0T / TOK, TPC);
        Et[T] = __shfl_sync(kFull, le[(t1T % TOK) / kTile], t1T / TOK, TPC);
      }
      if (part == 0) {
        const int sd = perm8(dch);
#pragma unroll
        for (int T = 0; T < NT; ++T) {
          Pdec[T * D + sd] = ex2(P[T]);
          Kdec[T * D + sd] = ex2(lc - Et[T]);
#pragma unroll
          for (int tau = 0; tau < T; ++tau) Cross[(T * NT + tau) * D + sd] = ex2(P[T] - Et[tau]);
        }
        Sdec[dch] = ex2(lc);
      }
    }
    if (n + 1 < N) load_w(n + 1);
    cp_async_wait<1>();  // this chunk's r, k, v have landed (for this thread) ...
    __syncthreads();     // ... and for every thread; L and Lq are written

    // 2. the decayed operands, a token and 8 channels a thread, every
    //    exponent <= 0: rhat = r 2^(Lq - P_T) and kbar = k 2^(E_T - L) (the
    //    off-diagonal tiles' operands: rhat of tiles 1.., kbar of tiles
    //    ..NT-2), rdec = rhat 2^P_T and kfut = kbar 2^(Lc - E_T) as TF32 hi +
    //    lo; in each tile's halves rtil = r 2^(Lq - Q_T) (second half) and
    //    ktil = k 2^(Q_T - L) (first).  Stored columns in mma order (perm8:
    //    even channels of a group of 8 first).  A quarter warp takes 8
    //    tokens of one channel group: its row loads and stores hit distinct
    //    banks, and the tile rows and decay vectors are one broadcast.
    constexpr int G = D / 8;  // channel groups
#pragma unroll
    for (int i0 = 0; i0 < C * G; i0 += kT) {
      const int i = i0 + tid;
      if (i >= C * G) break;  // whole warps
      const int t = i % 8 + 8 * (i / (8 * G)), d0 = (i / 8) % G * 8;
      const int T = t / kTile, T0 = T * kTile, tt = t % kTile;
      float rv[8], kv[8], lq[8], l[8], p[8], e[8], qm[8], pd[8], kd[8];
      Vec<bf16>::unpack(*reinterpret_cast<const uint4*>(rs + t * RB + d0), rv);
      Vec<bf16>::unpack(*reinterpret_cast<const uint4*>(ks + t * RB + d0), kv);
      auto row8 = [&](const float* src, float* dst) {
        const float4 a = *reinterpret_cast<const float4*>(src);
        const float4 c = *reinterpret_cast<const float4*>(src + 4);
        dst[0] = a.x; dst[1] = a.y; dst[2] = a.z; dst[3] = a.w;
        dst[4] = c.x; dst[5] = c.y; dst[6] = c.z; dst[7] = c.w;
      };
      // a vector stored in mma order: positions 0..3 hold the even channels
      auto vec8 = [&](const float* src, float* dst) {
        const float4 a = *reinterpret_cast<const float4*>(src);
        const float4 c = *reinterpret_cast<const float4*>(src + 4);
        dst[0] = a.x; dst[2] = a.y; dst[4] = a.z; dst[6] = a.w;
        dst[1] = c.x; dst[3] = c.y; dst[5] = c.z; dst[7] = c.w;
      };
      row8(Lq + t * PR + d0, lq);
      row8(L + t * PR + d0, l);
      row8(Lq + T0 * PR + d0, p);
      row8(L + (T0 + kTile - 1) * PR + d0, e);
      row8(L + (T0 + kHalf - 1) * PR + d0, qm);
      vec8(Pdec + T * D + d0, pd);
      vec8(Kdec + T * D + d0, kd);
      // stored position of channel d0 + x: perm8 puts even x at x / 2 and odd
      // x at 4 + x / 2, so the eight values go out as two float4
      auto put8 = [&](float* dst, const float* val) {
        *reinterpret_cast<float4*>(dst) = make_float4(val[0], val[2], val[4], val[6]);
        *reinterpret_cast<float4*>(dst + 4) = make_float4(val[1], val[3], val[5], val[7]);
      };
      float rh[8], kb[8], a8[8], b8[8];
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        rh[x] = rv[x] * ex2(lq[x] - p[x]);
        kb[x] = kv[x] * ex2(e[x] - l[x]);
      }
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        unsigned hi, lo;
        split_tf32(rh[x] * pd[x], hi, lo);
        a8[x] = __uint_as_float(hi);
        b8[x] = __uint_as_float(lo);
      }
      put8(reinterpret_cast<float*>(RdH) + t * PR + d0, a8);
      put8(reinterpret_cast<float*>(RdL) + t * PR + d0, b8);
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        unsigned hi, lo;
        split_tf32(kb[x] * kd[x], hi, lo);
        a8[x] = __uint_as_float(hi);
        b8[x] = __uint_as_float(lo);
      }
      put8(reinterpret_cast<float*>(KfH) + t * PK + d0, a8);
      put8(reinterpret_cast<float*>(KfL) + t * PK + d0, b8);
      if (T >= 1) put8(Rh + (t - kTile) * PR + d0, rh);
      if (T < NT - 1) put8(Kb + t * PK + d0, kb);
      const int hr = T * kHalf + tt % kHalf;  // row of rtil / ktil
      if (tt >= kHalf) {
#pragma unroll
        for (int x = 0; x < 8; ++x) a8[x] = rv[x] * ex2(lq[x] - qm[x]);
        put8(Rt + hr * PR + d0, a8);
      } else {
#pragma unroll
        for (int x = 0; x < 8; ++x) a8[x] = kv[x] * ex2(qm[x] - l[x]);
        put8(Kt + hr * PK + d0, a8);
      }
      // the bonus A[t][t] = sum_d r u k: this warp's four groups by
      // shuffles, the D / 32 warps of a token set summed in phase 3
      float bonus = 0.f;
#pragma unroll
      for (int x = 0; x < 8; ++x) bonus += rv[x] * Us[d0 + x] * kv[x];
      bonus += __shfl_xor_sync(kFull, bonus, 8);
      bonus += __shfl_xor_sync(kFull, bonus, 16);
      if (lane < 8) Bonus[d0 / 32 * C + t] = bonus;
    }
    __syncthreads();

    // 3. the weights A, a warp an item: (a) on the tensor cores, tile T
    //    against each earlier 8-token block j, then each tile's second half
    //    against its first, the three products of a 3xTF32 step in three
    //    accumulators; (b) each 8-token diagonal half per element, s < t:
    //    sum_d r k 2^(Lq_t - L_s), a lane a channel (conflict-free rows),
    //    the 28 pair sums reduced over the lanes by a shuffle reduce-scatter.
    constexpr int kOff = NT * (NT - 1);
    for (int t = tid; t < C; t += kT) {
      float bonus = Bonus[t];
#pragma unroll
      for (int x = 1; x < D / 32; ++x) bonus += Bonus[x * C + t];
      A[t * PA + t] = bonus;
    }
    for (int it = warp; it < kOff + NT + CT; it += kW) {
      if (it >= kOff + NT) {
        const int h0 = (it - kOff - NT) * kHalf;
        float acc[32];
#pragma unroll
        for (int x = 0; x < 32; ++x) acc[x] = 0.f;
#pragma unroll
        for (int d = lane; d < D; d += 32) {
          float rv[kHalf], kv[kHalf], lq[kHalf], lv[kHalf];
#pragma unroll
          for (int x = 0; x < kHalf; ++x) {
            rv[x] = to_f32(rs[(h0 + x) * RB + d]);
            kv[x] = to_f32(ks[(h0 + x) * RB + d]);
            lq[x] = Lq[(h0 + x) * PR + d];
            lv[x] = L[(h0 + x) * PR + d];
          }
#pragma unroll
          for (int t = 1; t < kHalf; ++t)
#pragma unroll
            for (int s = 0; s < t; ++s)
              acc[t * (t - 1) / 2 + s] += rv[t] * kv[s] * ex2(lq[t] - lv[s]);
        }
        reduce_scatter<16>(acc, lane);
        reduce_scatter<8>(acc, lane);
        reduce_scatter<4>(acc, lane);
        reduce_scatter<2>(acc, lane);
        reduce_scatter<1>(acc, lane);
        if (lane < kHalf * (kHalf - 1) / 2) {
          int t = 1, s = lane;
          while (s >= t) {
            s -= t;
            ++t;
          }
          A[(h0 + t) * PA + h0 + s] = acc[0];
        }
        continue;
      }
      float c[3][4] = {};
      unsigned ah[4], al[4], bh0, bh1, bl0, bl1;
      if (it < kOff) {
        int T = 1, j = it;
        while (j >= 2 * T) {
          j -= 2 * T;
          ++T;
        }
        const float* ra = Rh + ((T - 1) * kTile + g) * PR;
        const float* kb = Kb + (j * 8 + g) * PK;
        const float* cr = Cross + (T * NT + j / 2) * D;
#pragma unroll
        for (int s = 0; s < KS; ++s) {
          const int c0 = 8 * s + q;
          split_tf32(ra[c0], ah[0], al[0]);
          split_tf32(ra[8 * PR + c0], ah[1], al[1]);
          split_tf32(ra[c0 + 4], ah[2], al[2]);
          split_tf32(ra[8 * PR + c0 + 4], ah[3], al[3]);
          split_tf32(kb[c0] * cr[c0], bh0, bl0);
          split_tf32(kb[c0 + 4] * cr[c0 + 4], bh1, bl1);
          mma_tf32(c[0], al, bh0, bh1);
          mma_tf32(c[1], ah, bl0, bl1);
          mma_tf32(c[2], ah, bh0, bh1);
        }
        float* a = A + (T * kTile + g) * PA + j * 8 + 2 * q;
        a[0] = c[0][0] + c[1][0] + c[2][0];
        a[1] = c[0][1] + c[1][1] + c[2][1];
        a[8 * PA] = c[0][2] + c[1][2] + c[2][2];
        a[8 * PA + 1] = c[0][3] + c[1][3] + c[2][3];
      } else {
        const int T = it - kOff;  // mma rows 0..7: the second half; 8..15 unused
        const float* ra = Rt + (T * kHalf + g) * PR;
        const float* kb = Kt + (T * kHalf + g) * PK;
        ah[1] = ah[3] = al[1] = al[3] = 0u;
#pragma unroll
        for (int s = 0; s < KS; ++s) {
          const int c0 = 8 * s + q;
          split_tf32(ra[c0], ah[0], al[0]);
          split_tf32(ra[c0 + 4], ah[2], al[2]);
          split_tf32(kb[c0], bh0, bl0);
          split_tf32(kb[c0 + 4], bh1, bl1);
          mma_tf32(c[0], al, bh0, bh1);
          mma_tf32(c[1], ah, bl0, bl1);
          mma_tf32(c[2], ah, bh0, bh1);
        }
        float* a = A + (T * kTile + kHalf + g) * PA + T * kTile + 2 * q;
        a[0] = c[0][0] + c[1][0] + c[2][0];
        a[1] = c[0][1] + c[1][1] + c[2][1];
      }
    }
    __syncthreads();

    // 4. the slice's 16 value columns.  v^T fragments (rows e, columns s),
    //    exact in TF32 (bf16 widened), serve both products below.
    unsigned vf[CT][4];
#pragma unroll
    for (int j = 0; j < CT; ++j) {
      const bf16* vp = vs + (8 * j + q) * RB + e0 + g;
      vf[j][0] = bf16_bits(vp[0]);
      vf[j][1] = bf16_bits(vp[8]);
      vf[j][2] = bf16_bits(vp[4 * RB]);
      vf[j][3] = bf16_bits(vp[4 * RB + 8]);
    }
    // o^T for this warp's token blocks x0..x0+CH-1: S^T rdec^T (S and rdec
    // as hi + lo, three accumulators) ...
    float o[CH][3][4];
#pragma unroll
    for (int x = 0; x < CH; ++x)
#pragma unroll
      for (int y = 0; y < 3; ++y) o[x][y][0] = o[x][y][1] = o[x][y][2] = o[x][y][3] = 0.f;
#pragma unroll
    for (int j = 0; j < KS; ++j) {
      unsigned sh[4], sl[4];
      split_tf32(St[j][0], sh[0], sl[0]);
      split_tf32(St[j][2], sh[1], sl[1]);
      split_tf32(St[j][1], sh[2], sl[2]);
      split_tf32(St[j][3], sh[3], sl[3]);
#pragma unroll
      for (int x = 0; x < CH; ++x) {
        const int i0 = (8 * (x0 + x) + g) * PR + 8 * j + q;
        mma_tf32(o[x][0], sl, RdH[i0], RdH[i0 + 4]);
        mma_tf32(o[x][1], sh, RdL[i0], RdL[i0 + 4]);
        mma_tf32(o[x][2], sh, RdH[i0], RdH[i0 + 4]);
      }
    }
    // ... + v^T A^T (A as hi + lo), over the 8-token blocks s <= t
#pragma unroll
    for (int x = 0; x < CH; ++x)
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        if (j > x0 + x) continue;
        const float* ap = A + (8 * (x0 + x) + g) * PA + 8 * j + q;
        unsigned bh0, bh1, bl0, bl1;
        split_tf32(ap[0], bh0, bl0);
        split_tf32(ap[4], bh1, bl1);
        mma_tf32(o[x][1], vf[j], bl0, bl1);
        mma_tf32(o[x][2], vf[j], bh0, bh1);
      }
    // the live tokens' outputs: columns e0 + g (+ 8), tokens 8x + 2q (+ 1)
#pragma unroll
    for (int x = 0; x < CH; ++x)
#pragma unroll
      for (int y = 0; y < 2; ++y) {
        const int t = 8 * (x0 + x) + 2 * q + y;
        if (t < nt) {
          float* op = out + base + (int64_t)(t0 + t) * sD + e0 + g;
          op[0] = o[x][0][y] + o[x][1][y] + o[x][2][y];
          op[8] = o[x][0][2 + y] + o[x][1][2 + y] + o[x][2][2 + y];
        }
      }
    // S^T = S^T diag(2^Lc) + v^T kfut (kfut as hi + lo), all token blocks
#pragma unroll
    for (int j = 0; j < KS; ++j) {
      const float d0 = Sdec[8 * j + 2 * q], d1 = Sdec[8 * j + 2 * q + 1];
      St[j][0] *= d0;
      St[j][1] *= d1;
      St[j][2] *= d0;
      St[j][3] *= d1;
    }
#pragma unroll
    for (int x = 0; x < CT; ++x)
#pragma unroll
      for (int j = 0; j < KS; ++j) {
        const int i0 = (8 * x + q) * PK + 8 * j + perm8(g);  // channel 8j + g
        mma_tf32(St[j], vf[x], KfL[i0], KfL[i0 + 4 * PK]);
        mma_tf32(St[j], vf[x], KfH[i0], KfH[i0 + 4 * PK]);
      }
    __syncthreads();  // the stage and the chunk's arrays are free
  }
  if (state_out && warp < NSL) {
#pragma unroll
    for (int j = 0; j < KS; ++j) {
      float* s0 = state_out + sbase + (int64_t)(8 * j + 2 * q) * D + e0 + g;
      s0[0] = St[j][0];
      s0[D] = St[j][1];
      s0[8] = St[j][2];
      s0[D + 8] = St[j][3];
    }
  }
}

template <int D, int C>
int launch_mma(const void* r, const void* k, const void* v, const void* w, const void* u,
               const void* state_in, void* out, void* state_out, int B, int S, int H,
               cudaStream_t stream) {
  using M = MmaSmem<D, C>;
  auto kernel = wkv_mma_kernel<D, C>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         M::BYTES);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B * H, M::THREADS, M::BYTES, stream>>>(
      static_cast<const bf16*>(r), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(w), static_cast<const float*>(u),
      static_cast<const float*>(state_in), static_cast<float*>(out),
      static_cast<float*>(state_out), S, H);
  return (int)cudaGetLastError();
}

template <int D>
int launch_mma_c(int chunk, const void* r, const void* k, const void* v, const void* w,
                 const void* u, const void* state_in, void* out, void* state_out, int B, int S,
                 int H, cudaStream_t stream) {
  switch (chunk) {
    case 16: return launch_mma<D, 16>(r, k, v, w, u, state_in, out, state_out, B, S, H, stream);
    case 32: return launch_mma<D, 32>(r, k, v, w, u, state_in, out, state_out, B, S, H, stream);
    case 64: return launch_mma<D, 64>(r, k, v, w, u, state_in, out, state_out, B, S, H, stream);
  }
  return -2;
}

}  // namespace

// r, k, v: (B, S, H, D) contiguous, f32 (in_dtype 0); w: the
// same shape, f32 decay in (0, 1); u: (H, D) f32; state_in (may be null)
// and state_out (may be null): (B, H, D, D) f32; out: (B, S, H, D) f32.
// D in {32, 64}; chunk (tokens per step of the CTA's loop) in {16, 32, 64}.
// Returns 0 or a CUDA error code (negative for an unsupported D, chunk or
// dtype: bf16 goes to wkv_forward_mma); launches on `stream` and does not
// synchronise.
extern "C" int wkv_forward(const void* r, const void* k, const void* v, const void* w,
                           const void* u, const void* state_in, void* out, void* state_out,
                           int B, int S, int H, int D, int chunk, int in_dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return -3;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype != 0) return -1;
  return launch_d(D, chunk, r, k, v, w, u, state_in, out, state_out, B, S, H, s);
}

// The tensor-core entry: the arguments of wkv_forward, r/k/v bf16 only
// (in_dtype 1), every pointer 16-byte aligned (cp.async).  Chunk in {16,
// 32, 64}, D in {32, 64}.
extern "C" int wkv_forward_mma(const void* r, const void* k, const void* v, const void* w,
                               const void* u, const void* state_in, void* out,
                               void* state_out, int B, int S, int H, int D, int chunk,
                               int in_dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return -3;
  if (in_dtype != 1) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch_mma_c<32>(chunk, r, k, v, w, u, state_in, out, state_out, B, S, H, s);
    case 64: return launch_mma_c<64>(chunk, r, k, v, w, u, state_in, out, state_out, B, S, H, s);
  }
  return -2;
}
