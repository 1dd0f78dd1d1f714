// RWKV-6 WKV backward: the gradients of the chunked WKV recurrence, for
// training.
//
// The backward of the function src/repro/kernels/rwkv6/kernel.py::
// _wkv_kernel computes (the forward kernel is csrc/wkv.cu).  JAX has no
// Pallas backward: it differentiates repro/models/rwkv6.py::wkv_chunked by
// autodiff; this kernel computes what that autodiff computes.  Per (b, h),
// with o_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T) and S_t = diag(w_t) S_{t-1}
// + k_t v_t^T, given dO and optionally d(state out), it returns dr, dk, dv
// (r's type), d(log w) (f32, the gradient of log(max(w, 1e-12)): the
// wrapper divides by w), du (H, D) f32 and d(state in) (f32, when a state
// was passed).  Two entries of one signature (ops.BWD_ENTRIES picks by r's
// dtype): wkv_backward_mma (bf16 r/k/v, tensor cores) and wkv_backward
// (f32 r/k/v, CUDA cores; bf16 too, widened in shared memory).
//
// Bound on an H100 SXM at rwkv6-1.6b's training shape (B 8, S 2048, H 32,
// D 64, bf16 r/k/v): bytes, ~805 MB (r/k/v bf16, w and dO f32 read, dr/dk/dv
// bf16 and d(log w) f32 written once) at 3.35 TB/s, 0.240 ms, which bounds
// it; the four D x D products a token and head (S dO, G v, G^T kfut, the
// transposed state update: 8 D^2 flops) as 3xTF32 on the tensor cores (a
// third of the TF32 peak), 0.104 ms.  Both designs below add a transient
// chunk-state scratch, (B, H, N, D, D) f32, written and read once: 537 MB
// more traffic (0.160 ms) at the training shape.
//
// The math, per (b, h), shared by both entries:
//   1. a forward pass over the chunks recomputes each chunk's start state S0
//      and keeps it in the scratch (268 MB at the training shape).  The
//      alternative, S0 saved by the forward kernel, would hold that buffer
//      from the forward to the backward for every layer (24 x 268 MB on
//      rwkv6-1.6b without remat) and change the serving kernel; recomputing
//      costs one more read of k, v and w;
//   2. a reverse pass over the chunks carries G, the gradient of the state
//      after the chunk (d(state out), or 0, after the last; G <- 2^Lc G +
//      (r 2^Lq)^T dO, the transposed state update).  Per chunk, with L the
//      inclusive cumsum of log2 w and Lq = L - log2 w (every exponent <= 0),
//      M = dO V^T and E_ts = 2^(Lq_t - L_s) per channel (s < t):
//        dr_t = 2^Lq_t S0 dO_t + sum_{s<t} M_ts E_ts k_s + u k_t M_tt
//        dk_s = 2^(Lc - L_s) G v_s + sum_{t>s} M_ts E_ts r_t + u r_s M_ss
//        dv   = A^T dO + kfut^T G   (A the forward's weights, bonus on the
//                                    diagonal; kfut = k 2^(Lc - L))
//        du   = sum of r k M_tt: a CTA's partial row, then du_sum_kernel
//               sums the B rows of each head in order (no atomics: a rerun
//               gives the same bits);
//   3. d(log w)_i = w_i sum_e G_i S_{i-1} (the direct form, G_i the
//      gradient of the state after token i), expanded over the chunk into
//      four parts, none a small difference of large terms: 2^Lc sum_e G S0
//      (pairs across the whole chunk); the suffix over t > i of r 2^Lq S0 dO
//      and the prefix over s < i of k 2^(Lc - L) G v (pairs with one end
//      outside); and the pairs inside the chunk, as the suffix of a minus
//      the suffix of b, where a_t and b_s are dr's and dk's intra sums times
//      r and k without the adjacent pairs (s = t - 1), which straddle no
//      token (their decay is 2^0).  Under strong decay those adjacent pairs
//      are the large ones; kept in, the difference loses ~1e-4 of d(w) in
//      f32 (ref.wkv_backward_split_ref's keep_adjacent control).
// A ragged last chunk is zero-filled (r = k = v = dO = 0, log w = 0), which
// adds nothing; only live tokens are written.
//
// wkv_backward (CUDA cores, the first port's design): one CTA per (b, h),
//   1024 threads at C = 32 and 512 at C = 16 and 64, every product a scalar
//   loop over shared memory, the intra-chunk sums per element; shared
//   memory: the chunk's operands, M and A, G, and S0 (in the a / b arrays'
//   place when it fits): 116 KB at C 32, D 64 (one CTA an SM), 231 KB at C 64.
//
// wkv_backward_mma (tensor cores): one CTA per (b, h), 8 warps at D 64, C
//   32, two CTAs an SM (<= 113 KB of shared memory, <= 128 registers), so
//   rwkv6-1.6b's 256 (b, h) run in one wave and each CTA hides the other's
//   barriers (on an H100 SXM at the training shape, one CTA an SM with 16
//   warps, or with the registers unbounded, took 1.9 ms; a split into a
//   state kernel and a fully parallel per-chunk kernel 1.84 ms, its G
//   scratch another 537 MB of traffic; this design 1.42 ms);
//   * the state is split by key rows, not value columns (the forward's
//     split): every state product but dv's kfut G keeps a key row d local,
//     so a warp holds a 16-row x EW tile of S (forward pass) and of G
//     (reverse pass) in registers as mma accumulators; G goes to shared
//     memory once a chunk for the products that read other rows;
//   * every product on mma.sync m16n8k8 TF32, f32 operands split into TF32
//     hi + lo by integer operations (hi.hi + hi.lo + lo.hi, ~2^-21 of each
//     product), bf16 r/k/v exact (two mma): the forward pass's kfut^T v,
//     X = dO S0^T and Y = v G^T (a warp's tiles share a key slice, so S0's
//     and G's fragments are split once for both), M = dO v^T, dv's kfut G
//     and A^T dO (a warp's tiles share their tokens), A, dr's and dk's
//     intra sums, G's update;
//   * the intra-chunk sums in the forward's factored form (wkv.cu): 16-token
//     tiles factor at their edges (dr: 2^(Lq_t - P_T) (M' block) (kbar
//     2^(P_T - E_s)); dk: the same with M'^T and rhat), each tile's second
//     half against its first at Q_T, only 8-token diagonal halves per
//     element (a thread a channel and a half: 21 pairs, one exponent each);
//     M' is M with its first sub-diagonal zeroed, the adjacent pairs added
//     per element (M[t][t-1] k_{t-1}, M[t+1][t] r_{t+1});
//   * d(log w)'s scans: a thread a channel and an 8-token half, the halves
//     of a channel joined by shuffles;
//   * dr, dk and d(log w) staged [d][t] over S0 and G once those are read,
//     dv in the til array, then written as 16-byte vectors;
//   * a 64-token chunk runs as two of 32 (the arrays of 64 would not fit two
//     CTAs an SM; the gradients do not depend on the chunk beyond rounding).
//   Its CPU emulation is ref.wkv_backward_split_ref.

// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (repro_torch/kernels/_build.py).  Plain C entry
// points, bound with ctypes by repro_torch/kernels/rwkv6/kernel.py.

#include "../../csrc/tf32_mma.cuh"

namespace {

using namespace repro_torch;


// Offsets (floats) of the shared arrays.  Arrays read down a column by
// consecutive lanes (K, V, L, G, S0) have rows padded to D + 1.
template <int D, int C>
struct Lay {
  // threads a CTA, the fastest of 256 / 512 / 1024 at each chunk on the
  // H100 (every count gives the same bits: each output keeps its thread's
  // loop); 1024 leaves 64 registers a thread, too few at chunk 64
  static constexpr int kThreads = C == 32 ? 1024 : 512;
  static constexpr int P = D + 1;
  static constexpr int R = 0;              // C x D  r
  static constexpr int DO = R + C * D;     // C x D  dO
  static constexpr int LQ = DO + C * D;    // C x D  Lq (log2)
  static constexpr int KF = LQ + C * D;    // C x D  kfut = k 2^(Lc - L)
  static constexpr int RD = KF + C * D;    // C x D  rdec = r 2^Lq
  static constexpr int K = RD + C * D;     // C x P  k
  static constexpr int V = K + C * P;      // C x P  v
  static constexpr int L = V + C * P;      // C x P  L (log2; log2 w while loading)
  static constexpr int M = L + C * P;      // C x C  dO V^T (s <= t)
  static constexpr int A = M + C * C;      // C x C  the forward's weights
  static constexpr int G = A + C * C;      // D x P  G (the state, in the forward pass)
  static constexpr int SA = G + D * P;     // C x D  a + r 2^Lq S0 dO
  static constexpr int BC = SA + C * D;    // C x D  k 2^(Lc - L) G v, then its prefix
  static constexpr int BF = BC + C * D;    // C x D  b
  static constexpr bool kAlias = 3 * C * D >= D * P;  // S0 in SA..BF's place
  static constexpr int S0 = kAlias ? SA : BF + C * D;  // D x P
  static constexpr int U = kAlias ? BF + C * D : S0 + D * P;
  static constexpr int LC = U + D, DEC = LC + D, Z = DEC + D, FLOATS = Z + D;
  static constexpr int BYTES = 4 * FLOATS;
  static constexpr int NJ = C * D / kThreads;                   // (token, channel) items a thread
  static constexpr int TS = kThreads / D;                       // token stride between them
  static constexpr int NM = (C * C + kThreads - 1) / kThreads;  // (t, s) items a thread
  static_assert(kThreads % D == 0 && (C * D) % kThreads == 0, "shapes");
  static_assert(BYTES <= 232448, "shared memory");
};

template <typename T, int D, int C>
__global__ void __launch_bounds__(Lay<D, C>::kThreads)
wkv_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
               const float* __restrict__ w, const float* __restrict__ u,
               const float* __restrict__ state_in, const float* __restrict__ dout,
               const float* __restrict__ dstate_out, T* __restrict__ dr, T* __restrict__ dk,
               T* __restrict__ dv, float* __restrict__ dlogw, float* __restrict__ dstate_in,
               float* __restrict__ states, float* __restrict__ du_part, int S, int H) {
  using Y_ = Lay<D, C>;
  constexpr int P = Y_::P, NJ = Y_::NJ, TS = Y_::TS, NM = Y_::NM, kThreads = Y_::kThreads;
  extern __shared__ float sm[];
  float* Rs = sm + Y_::R;
  float* DOs = sm + Y_::DO;
  float* LQs = sm + Y_::LQ;
  float* KFs = sm + Y_::KF;
  float* RDs = sm + Y_::RD;
  float* Ks = sm + Y_::K;
  float* Vs = sm + Y_::V;
  float* Ls = sm + Y_::L;
  float* Ms = sm + Y_::M;
  float* As = sm + Y_::A;
  float* Gs = sm + Y_::G;
  float* SAs = sm + Y_::SA;
  float* BCs = sm + Y_::BC;
  float* BFs = sm + Y_::BF;
  float* S0s = sm + Y_::S0;
  float* Us = sm + Y_::U;
  float* LCs = sm + Y_::LC;
  float* DECs = sm + Y_::DEC;
  float* Zs = sm + Y_::Z;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  const int kq = tid % D, tb = tid / D;  // a (token, channel) item's channel and first token
  const int64_t sD = (int64_t)H * D;                          // stride of one token
  const int64_t base = (int64_t)b * S * sD + (int64_t)h * D;  // token 0 of (b, h)
  const int64_t sbase = (int64_t)bh * D * D;
  const int N = (S + C - 1) / C;
  float* st = states + (int64_t)bh * N * D * D;

  for (int i = tid; i < D; i += kThreads) Us[i] = u[h * D + i];

  // Stage chunk n's operands (padding rows: zeros, log2 w = 0); r and dO
  // only in the reverse pass.
  auto stage = [&](int n, bool reverse) {
    const int t0 = n * C, nt = min(C, S - t0);
    for (int i = tid; i < C * D; i += kThreads) {
      const int t = i / D, d = i % D;
      float rv = 0.f, kv = 0.f, vv = 0.f, dov = 0.f, lw = 0.f;
      if (t < nt) {
        const int64_t g = base + (int64_t)(t0 + t) * sD + d;
        kv = to_f32(k[g]);
        vv = to_f32(v[g]);
        lw = log2f(fmaxf(w[g], 1e-12f));
        if (reverse) {
          rv = to_f32(r[g]);
          dov = dout[g];
        }
      }
      Ks[t * P + d] = kv;
      Vs[t * P + d] = vv;
      Ls[t * P + d] = lw;
      if (reverse) {
        Rs[t * D + d] = rv;
        DOs[t * D + d] = dov;
      }
    }
  };
  // The cumsums of log2 w, a thread a channel: L (inclusive), Lq = the sum
  // before the token (so Lq_t is L_{t-1} exactly), Lc and 2^Lc.
  auto cumsum = [&]() {
    if (tid < D) {
      float acc = 0.f;
      for (int t = 0; t < C; ++t) {
        const float lw = Ls[t * P + tid];
        LQs[t * D + tid] = acc;
        acc += lw;
        Ls[t * P + tid] = acc;
      }
      LCs[tid] = acc;
      DECs[tid] = exp2f(acc);
    }
  };

  // ---- 1. forward pass: each chunk's start state to the scratch buffer
  for (int i = tid; i < D * D; i += kThreads)
    Gs[(i / D) * P + i % D] = state_in ? state_in[sbase + i] : 0.f;
  __syncthreads();
  for (int n = 0; n < N; ++n) {
    stage(n, false);
    for (int i = tid; i < D * D; i += kThreads) st[(int64_t)n * D * D + i] = Gs[(i / D) * P + i % D];
    __syncthreads();
    if (n == N - 1) break;  // the last chunk's end state is not needed
    cumsum();
    __syncthreads();
    for (int i = tid; i < C * D; i += kThreads) {
      const int t = i / D, d = i % D;
      KFs[i] = Ks[t * P + d] * exp2f(LCs[d] - Ls[t * P + d]);
    }
    __syncthreads();
    for (int i = tid; i < D * D; i += kThreads) {
      const int kk = i / D, e = i % D;
      float x = DECs[kk] * Gs[kk * P + e];
#pragma unroll 8
      for (int s = 0; s < C; ++s) x += KFs[s * D + kk] * Vs[s * P + e];
      Gs[kk * P + e] = x;
    }
    __syncthreads();
  }

  // ---- 2. reverse pass: G from d(state out)
  for (int i = tid; i < D * D; i += kThreads)
    Gs[(i / D) * P + i % D] = dstate_out ? dstate_out[sbase + i] : 0.f;
  float du_acc = 0.f;  // channel tid's du (tid < D)
  for (int n = N - 1; n >= 0; --n) {
    const int t0 = n * C, nt = min(C, S - t0);
    stage(n, true);
    for (int i = tid; i < D * D; i += kThreads) S0s[(i / D) * P + i % D] = st[(int64_t)n * D * D + i];
    __syncthreads();
    cumsum();
    __syncthreads();

    // (a) X = S0 dO_t and Y = G v_t for this thread's items (registers),
    //     Z = 2^Lc sum_e G S0, kfut and rdec; M and A, a thread a (t, s).
    float X[NJ], Y[NJ], z = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) X[j] = Y[j] = 0.f;
    for (int e = 0; e < D; ++e) {
      const float s0 = S0s[kq * P + e], g = Gs[kq * P + e];
      z += g * s0;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int t = tb + j * TS;
        X[j] += s0 * DOs[t * D + e];
        Y[j] += g * Vs[t * P + e];
      }
    }
    if (tb == 0) Zs[kq] = DECs[kq] * z;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int t = tb + j * TS;
      KFs[t * D + kq] = Ks[t * P + kq] * exp2f(LCs[kq] - Ls[t * P + kq]);
      RDs[t * D + kq] = Rs[t * D + kq] * exp2f(LQs[t * D + kq]);
    }
#pragma unroll
    for (int jm = 0; jm < NM; ++jm) {
      const int idx = tid + jm * kThreads;
      if (idx < C * C) {
        const int t = idx / C, s = idx % C;
        float m = 0.f, a = 0.f;
        if (s <= t) {
#pragma unroll 8
          for (int e = 0; e < D; ++e) m += DOs[t * D + e] * Vs[s * P + e];
        }
        if (s < t) {
#pragma unroll 8
          for (int d = 0; d < D; ++d)
            a += Rs[t * D + d] * Ks[s * P + d] * exp2f(LQs[t * D + d] - Ls[s * P + d]);
        } else if (s == t) {
#pragma unroll 8
          for (int d = 0; d < D; ++d) a += Rs[t * D + d] * Us[d] * Ks[t * P + d];
        }
        Ms[idx] = m;
        As[idx] = a;
      }
    }
    __syncthreads();

    // (b) dr and dk of this thread's items, and the parts of d(log w);
    //     dv, a thread a (token, value column); du.
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int t = tb + j * TS;
      const float lq = LQs[t * D + kq], l = Ls[t * P + kq];
      const float rv = Rs[t * D + kq], kv = Ks[t * P + kq], mtt = Ms[t * C + t];
      float far = 0.f, far2 = 0.f;
      for (int s = 0; s + 1 < t; ++s) far += Ms[t * C + s] * Ks[s * P + kq] * exp2f(lq - Ls[s * P + kq]);
      const float adj = t ? Ms[t * C + t - 1] * Ks[(t - 1) * P + kq] * exp2f(lq - Ls[(t - 1) * P + kq])
                          : 0.f;
      for (int t2 = t + 2; t2 < C; ++t2)
        far2 += Ms[t2 * C + t] * Rs[t2 * D + kq] * exp2f(LQs[t2 * D + kq] - l);
      const float adj2 = t + 1 < C ? Ms[(t + 1) * C + t] * Rs[(t + 1) * D + kq] *
                                         exp2f(LQs[(t + 1) * D + kq] - l)
                                   : 0.f;
      const float cr = exp2f(lq) * X[j], ck = exp2f(LCs[kq] - l) * Y[j];
      SAs[t * D + kq] = rv * (cr + far);
      BCs[t * D + kq] = kv * ck;
      BFs[t * D + kq] = kv * far2;
      if (t < nt) {
        const int64_t g = base + (int64_t)(t0 + t) * sD + kq;
        store(dr + g, cr + far + adj + Us[kq] * kv * mtt);
        store(dk + g, ck + far2 + adj2 + Us[kq] * rv * mtt);
      }
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int s = tb + j * TS, e = kq;
      float acc = 0.f;
#pragma unroll 8
      for (int kk = 0; kk < D; ++kk) acc += KFs[s * D + kk] * Gs[kk * P + e];
      for (int t = s; t < C; ++t) acc += As[t * C + s] * DOs[t * D + e];
      if (s < nt) store(dv + base + (int64_t)(t0 + s) * sD + e, acc);
    }
    if (tid < D)
      for (int t = 0; t < C; ++t) du_acc += Rs[t * D + tid] * Ks[t * P + tid] * Ms[t * C + t];
    __syncthreads();

    // (c) G <- 2^Lc G + rdec^T dO; d(log w), a thread a channel: the
    //     prefix of k 2^(Lc - L) G v, then, from the last token, the
    //     suffixes.
    for (int i = tid; i < D * D; i += kThreads) {
      const int kk = i / D, e = i % D;
      float x = DECs[kk] * Gs[kk * P + e];
#pragma unroll 8
      for (int t = 0; t < C; ++t) x += RDs[t * D + kk] * DOs[t * D + e];
      Gs[kk * P + e] = x;
    }
    if (tid < D) {
      float pb = 0.f;
      for (int i = 0; i < C; ++i) {
        const float x = BCs[i * D + tid];
        BCs[i * D + tid] = pb;
        pb += x;
      }
      float sa = 0.f, sb = 0.f;
      const float zz = Zs[tid];
      for (int i = C - 1; i >= 0; --i) {
        sb += BFs[i * D + tid];
        if (i < nt) dlogw[base + (int64_t)(t0 + i) * sD + tid] = zz + sa + BCs[i * D + tid] - sb;
        sa += SAs[i * D + tid];
      }
    }
    __syncthreads();
  }
  if (tid < D) du_part[(int64_t)bh * D + tid] = du_acc;
  if (dstate_in)
    for (int i = tid; i < D * D; i += kThreads) dstate_in[sbase + i] = Gs[(i / D) * P + i % D];
}

// du[i] = the sum of the B partial rows' element i, in row order.
__global__ void du_sum_kernel(const float* __restrict__ part, float* __restrict__ du, int B,
                              int HD) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= HD) return;
  float acc = 0.f;
  for (int b = 0; b < B; ++b) acc += part[(int64_t)b * HD + i];
  du[i] = acc;
}

struct Args {
  const void *r, *k, *v, *w, *u, *state_in, *dout, *dstate_out;
  void *dr, *dk, *dv, *dlogw, *du, *dstate_in, *states, *du_part;
  int B, S, H;
};

template <typename T, int D, int C>
int launch(const Args& a, cudaStream_t stream) {
  auto kernel = wkv_bwd_kernel<T, D, C>;
  constexpr int bytes = Lay<D, C>::BYTES, threads = Lay<D, C>::kThreads;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<a.B * a.H, threads, bytes, stream>>>(
      static_cast<const T*>(a.r), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const float*>(a.w), static_cast<const float*>(a.u),
      static_cast<const float*>(a.state_in), static_cast<const float*>(a.dout),
      static_cast<const float*>(a.dstate_out), static_cast<T*>(a.dr), static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), static_cast<float*>(a.dlogw), static_cast<float*>(a.dstate_in),
      static_cast<float*>(a.states), static_cast<float*>(a.du_part), a.S, a.H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int HD = a.H * D;
  du_sum_kernel<<<(HD + 255) / 256, 256, 0, stream>>>(static_cast<const float*>(a.du_part),
                                                      static_cast<float*>(a.du), a.B, HD);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_c(int chunk, const Args& a, cudaStream_t s) {
  switch (chunk) {
    case 16: return launch<T, D, 16>(a, s);
    case 32: return launch<T, D, 32>(a, s);
    case 64: return launch<T, D, 64>(a, s);
  }
  return -2;
}

template <typename T>
int launch_d(int D, int chunk, const Args& a, cudaStream_t s) {
  switch (D) {
    case 32: return launch_c<T, 32>(chunk, a, s);
    case 64: return launch_c<T, 64>(chunk, a, s);
  }
  return -2;
}


// ---------------------------------------------------------------- tensor cores
// wkv_backward_mma: bf16 r/k/v, TF32 mma.sync with hi + lo operands (the
// helpers in kernels/csrc/tf32_mma.cuh, shared with wkv.cu's forward).

using bf16 = __nv_bfloat16;

// The chunk this entry runs: 16 or 32 tokens (a 64-token chunk runs as two
// of 32: its arrays would not fit two CTAs an SM).
constexpr int kMmaChunk = 32;

// Stage chunk c of the rows named (16-byte cp.async copies; tokens past S
// read as zeros).  f32 rows of D floats, bf16 rows of D values.
template <typename T, int D, int C>
__device__ __forceinline__ void stage_rows(T* dst, int pitch, const T* src, int64_t base,
                                           int64_t sD, int t0, int nt, int tid, int threads) {
  constexpr int V = 16 / sizeof(T);  // values a copy
  for (int i = tid; i < C * (D / V); i += threads) {
    const int t = i / (D / V), p = (i % (D / V)) * V;
    const bool ok = t < nt;
    cp_async16(dst + t * pitch + p, src + (ok ? base + (int64_t)(t0 + t) * sD + p : base), ok);
  }
}

// threadIdx.x through asm volatile: a value the compiler cannot move out of
// a loop.
__device__ __forceinline__ int opaque_tid() {
  int t;
  asm volatile("mov.u32 %0, %%tid.x;\n" : "=r"(t));
  return t;
}

// L, the inclusive cumsum of log2 w over the chunk, at a thread's TOK
// tokens (its lanes' part of the channel, the TPC lanes of a channel
// adjacent, joined by shuffles); returns Lc.  Lq_t is read back as L_{t-1},
// exactly the sum before the token's term.
template <int TOK, int TPC>
__device__ __forceinline__ float chunk_cumsum(const float (&wr)[TOK], int part, float (&lv)[TOK]) {
  float tot = 0.f;
#pragma unroll
  for (int i = 0; i < TOK; ++i) {
    lv[i] = log2f(fmaxf(wr[i], 1e-12f));
    tot += lv[i];
  }
  float incl = tot;
#pragma unroll
  for (int o = 1; o < TPC; o <<= 1) {
    const float y = __shfl_up_sync(kFull, incl, o, TPC);
    if (part >= o) incl += y;
  }
  float acc = incl - tot;
#pragma unroll
  for (int i = 0; i < TOK; ++i) {
    acc += lv[i];
    lv[i] = acc;
  }
  return __shfl_sync(kFull, acc, TPC - 1, TPC);
}

// Shared memory of wkv_bwd_mma_kernel (bytes, then floats).  Pitches: P8
// = D + 8 (= 8 mod 32) for f32 arrays read as fragment rows q (or float2 at
// rows g), P4 = D + 4 for those read at rows g, PM for the C x C ones, PT =
// C + 1 for the staged outputs ([d][t], read a channel a lane group by the
// scans).  At most 113 KB, so that two CTAs share an SM.
template <int D, int C>
struct MmaSmem {
  static constexpr int NSL = D / 16, THREADS = C * D / 8, NW = THREADS / 32;
  static constexpr int NEP = NW / NSL, EW = D / NEP, NXE = EW / 8;  // a warp's G tile: 16 x EW
  static constexpr int NT = C / kTile, CT = C / 8, TPC = C / kHalf, TOK = kHalf;
  static constexpr int NXY = NSL * CT, XYT = NXY / NW;      // X / Y tiles, a warp's
  static constexpr int NDV = (C / 16) * (D / 8), DVT = NDV / NW;  // dv tiles, a warp's
  static constexpr int RB = D + 8, P8 = D + 8, P4 = D + 4, PM = (C + 31) / 32 * 32 + 4;
  static constexpr int PT = C + 1;
  static constexpr int SR = 0, SK = SR + C * RB * 2, SV = SK + C * RB * 2, SO = SV + C * RB * 2;
  static constexpr int SS = SO + C * P8 * 4, SG = SS + D * P8 * 4, FB = SG + D * P4 * 4;
  // The stage: r, k, v (bf16), dO, S0 and G (f32; G from the warps'
  // registers).  f32 arrays from FB (floats): L; rhat, kbar, til (rtil in
  // second-half rows, ktil in first-half rows; later dv); M' and M'^T (the
  // first sub-diagonal zeroed); A^T; u; 2^Lc, 2^P_T, 2^(P_T - E_tau); M's
  // diagonal and sub-diagonal.  The forward pass keeps k and v
  // in the r / k / v / dO slots (two buffers) and kfut's hi / lo in RH / KB.
  static constexpr int L = 0, RH = L + C * P4, KB = RH + C * P8, TI = KB + C * P8;
  static constexpr int MP = TI + C * P8, MT = MP + C * PM, AT = MT + C * PM, U = AT + C * PM;
  static constexpr int SDEC = U + D, PDEC = SDEC + D, CROSS = PDEC + NT * D;
  static constexpr int MDIAG = CROSS + NT * NT * D, MSUB = MDIAG + C, FLOATS = MSUB + C + 4;
  // dr, dk and d(log w) staged [d][t] over S0 and G (floats from the
  // start), or after the f32 arrays where they do not fit there (D 32, C 32)
  static constexpr bool kOver = 3 * D * PT * 4 <= FB - SS;
  static constexpr int XR = kOver ? SS / 4 : FB / 4 + FLOATS, YK = XR + D * PT, FK = YK + D * PT;
  static constexpr int BYTES = kOver ? FB + 4 * FLOATS : 4 * (FK + D * PT);
  static_assert(D % 16 == 0 && C % kTile == 0 && XYT * NW == NXY && DVT * NW == NDV &&
                    (D / 8) % DVT == 0, "shapes");
  static_assert(BYTES <= 115712, "two CTAs an SM");
};

// One CTA per (b, h), two an SM (all 256 of rwkv6-1.6b's training shape in
// one wave; each hides the other's barriers), 8 warps at D 64, C 32.
//   1. forward pass: S <- 2^Lc S + kfut^T v (kfut = k 2^(Lc - L) as TF32 hi
//      + lo, v exact), a warp a 16 x EW tile of S in registers; each chunk's
//      start state S0 to the scratch (k, v double-buffered by cp.async);
//   2. reverse pass, per chunk from the last: G (the gradient of the state
//      after the chunk, a warp a 16 x EW tile in registers) to shared memory,
//      then every product of the chunk on the tensor cores (P2-P4), the
//      per-element sums and d(log w)'s scans (P5), the outputs (P6), and G
//      <- 2^Lc G + rdec^T dO.
template <int D, int C>
__global__ void __launch_bounds__(MmaSmem<D, C>::THREADS, 2)
wkv_bwd_mma_kernel(const bf16* __restrict__ r, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const float* __restrict__ w,
                   const float* __restrict__ u, const float* __restrict__ state_in,
                   const float* __restrict__ dout, const float* __restrict__ dstate_out,
                   bf16* __restrict__ dr, bf16* __restrict__ dk, bf16* __restrict__ dv,
                   float* __restrict__ dlogw, float* __restrict__ dstate_in,
                   float* __restrict__ states, float* __restrict__ du_part, int S, int H) {
  using Y_ = MmaSmem<D, C>;
  constexpr int NSL = Y_::NSL, NW = Y_::NW, kT = Y_::THREADS, NT = Y_::NT, CT = Y_::CT;
  constexpr int TPC = Y_::TPC, TOK = Y_::TOK, XYT = Y_::XYT, DVT = Y_::DVT;
  constexpr int EW = Y_::EW, NXE = Y_::NXE;
  constexpr int RB = Y_::RB, P8 = Y_::P8, P4 = Y_::P4, PM = Y_::PM, PT = Y_::PT;
  constexpr int KS = D / 8;  // 8-channel k-steps
  extern __shared__ __align__(16) unsigned char smem_ch[];
  const bf16* rs = reinterpret_cast<const bf16*>(smem_ch + Y_::SR);
  const bf16* ks = reinterpret_cast<const bf16*>(smem_ch + Y_::SK);
  const bf16* vs = reinterpret_cast<const bf16*>(smem_ch + Y_::SV);
  const float* Os = reinterpret_cast<const float*>(smem_ch + Y_::SO);
  const float* S0s = reinterpret_cast<const float*>(smem_ch + Y_::SS);
  float* Gs = reinterpret_cast<float*>(smem_ch + Y_::SG);
  float* F = reinterpret_cast<float*>(smem_ch + Y_::FB);
  float* Ls = F + Y_::L;
  float* Rh = F + Y_::RH;
  float* Kb = F + Y_::KB;
  float* Ti = F + Y_::TI;
  float* Mp = F + Y_::MP;
  float* Mt = F + Y_::MT;
  float* At = F + Y_::AT;
  float* Us = F + Y_::U;
  float* Sdec = F + Y_::SDEC;
  float* Pdec = F + Y_::PDEC;
  float* Cross = F + Y_::CROSS;
  float* Mdiag = F + Y_::MDIAG;
  float* Msub = F + Y_::MSUB;  // Msub[t] = M[t][t - 1]; 0 at t = 0 and t = C
  float* Xr = reinterpret_cast<float*>(smem_ch) + Y_::XR;
  float* Yk = reinterpret_cast<float*>(smem_ch) + Y_::YK;
  float* Fk = reinterpret_cast<float*>(smem_ch) + Y_::FK;
  unsigned* KfH = reinterpret_cast<unsigned*>(Rh);  // the forward pass's kfut, hi and lo
  unsigned* KfL = reinterpret_cast<unsigned*>(Kb);

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int64_t sD = (int64_t)H * D;
  const int64_t base = (int64_t)b * S * sD + (int64_t)h * D;
  const int64_t sbase = (int64_t)bh * D * D;
  const int N = (S + C - 1) / C;
  float* st = states + (int64_t)bh * N * D * D;
  const int d0 = (warp % NSL) * 16, e0 = (warp / NSL) * EW;  // this warp's state tile
  const int dch = tid / TPC, part = tid % TPC;  // scan thread: channel, 8-token half

  for (int i = tid; i < C * PM; i += kT) At[i] = 0.f;  // A^T's upper part (t < s) stays 0
  for (int i = tid; i < D; i += kT) Us[i] = u[h * D + i];
  if (tid == 0) Msub[0] = Msub[C] = 0.f;

  // the 16 x EW tile at rows d0, columns e0 of a D x D f32 matrix in mma
  // accumulator layout; a null source reads zeros
  auto tile_load = [&](float (&t)[NXE][4], const float* src) {
#pragma unroll
    for (int x = 0; x < NXE; ++x) {
      const int i0 = (d0 + g) * D + e0 + 8 * x + 2 * q;
      const float2 a = src ? *reinterpret_cast<const float2*>(src + i0) : make_float2(0.f, 0.f);
      const float2 c = src ? *reinterpret_cast<const float2*>(src + i0 + 8 * D) : make_float2(0.f, 0.f);
      t[x][0] = a.x; t[x][1] = a.y; t[x][2] = c.x; t[x][3] = c.y;
    }
  };
  auto tile_store = [&](const float (&t)[NXE][4], float* dst) {
#pragma unroll
    for (int x = 0; x < NXE; ++x) {
      const int i0 = (d0 + g) * D + e0 + 8 * x + 2 * q;
      *reinterpret_cast<float2*>(dst + i0) = make_float2(t[x][0], t[x][1]);
      *reinterpret_cast<float2*>(dst + i0 + 8 * D) = make_float2(t[x][2], t[x][3]);
    }
  };
  float wr[TOK];  // w of channel dch's half, a chunk ahead
  auto load_w = [&](int c) {
    const int t0 = c * C, nt = min(C, S - t0);
#pragma unroll
    for (int i = 0; i < TOK; ++i) {
      const int t = part * TOK + i;
      wr[i] = t < nt ? w[base + (int64_t)(t0 + t) * sD + dch] : 1.f;  // log w = 0 past S
    }
  };
  // ---- 1. forward pass: S0 of chunks 0..N-1 to the scratch.  k and v of
  //         chunk n in buffer n & 1: the k / v slots, or the r / dO slots.
  {
    auto fwd_load = [&](int c, int buf) {
      const int t0 = c * C, nt = min(C, S - t0);
      stage_rows<bf16, D, C>(reinterpret_cast<bf16*>(smem_ch + (buf ? Y_::SR : Y_::SK)), RB, k,
                             base, sD, t0, nt, tid, kT);
      stage_rows<bf16, D, C>(reinterpret_cast<bf16*>(smem_ch + (buf ? Y_::SO : Y_::SV)), RB, v,
                             base, sD, t0, nt, tid, kT);
    };
    float Sr[NXE][4];
    tile_load(Sr, state_in ? state_in + sbase : nullptr);
    fwd_load(0, 0);
    cp_async_commit();
    load_w(0);
    for (int n = 0; n < N; ++n) {
      if (n + 1 < N) fwd_load(n + 1, (n + 1) & 1);
      cp_async_commit();
      tile_store(Sr, st + (int64_t)n * D * D);
      if (n == N - 1) break;  // the last chunk's end state is not needed
      cp_async_wait<1>();
      __syncthreads();  // chunk n's k, v have landed for every thread
      const bf16* kf = reinterpret_cast<const bf16*>(smem_ch + (n & 1 ? Y_::SR : Y_::SK));
      const bf16* vf = reinterpret_cast<const bf16*>(smem_ch + (n & 1 ? Y_::SO : Y_::SV));
      {
        float lv[TOK];
        const float lc = chunk_cumsum<TOK, TPC>(wr, part, lv);
#pragma unroll
        for (int i = 0; i < TOK; ++i) {
          const int t = part * TOK + i;
          unsigned hi, lo;
          split_tf32(to_f32(kf[t * RB + dch]) * ex2(lc - lv[i]), hi, lo);
          KfH[t * P8 + dch] = hi;
          KfL[t * P8 + dch] = lo;
        }
        if (part == 0) Sdec[dch] = ex2(lc);
      }
      if (n + 1 < N) load_w(n + 1);
      __syncthreads();
      // S = 2^Lc S + kfut^T v: kfut ([t][d] hi / lo) the A operand, rows
      // d0.., tokens as k; v (bf16, exact: two mma) columns e0..
      const float dec0 = Sdec[d0 + g], dec1 = Sdec[d0 + g + 8];
#pragma unroll
      for (int x = 0; x < NXE; ++x)
#pragma unroll
        for (int y = 0; y < 4; ++y) Sr[x][y] *= y < 2 ? dec0 : dec1;
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        unsigned ah[4], al[4];
        const int i0 = (8 * j + q) * P8 + d0 + g;
        ah[0] = KfH[i0]; ah[1] = KfH[i0 + 8]; ah[2] = KfH[i0 + 4 * P8]; ah[3] = KfH[i0 + 4 * P8 + 8];
        al[0] = KfL[i0]; al[1] = KfL[i0 + 8]; al[2] = KfL[i0 + 4 * P8]; al[3] = KfL[i0 + 4 * P8 + 8];
#pragma unroll
        for (int x = 0; x < NXE; ++x) {
          const bf16* vp = vf + (8 * j + q) * RB + e0 + 8 * x + g;
          const unsigned b0 = bf16_bits(vp[0]), b1 = bf16_bits(vp[4 * RB]);
          mma_tf32(Sr[x], al, b0, b1);
          mma_tf32(Sr[x], ah, b0, b1);
        }
      }
      __syncthreads();  // kfut and the buffer are free
    }
    cp_async_wait<0>();
    __threadfence();  // the scratch states, read back by cp.async below
    __syncthreads();
  }

  // ---- 2. reverse pass
  auto rev_load = [&](int c) {  // r, k, v, dO of chunk c
    const int t0 = c * C, nt = min(C, S - t0);
    stage_rows<bf16, D, C>(reinterpret_cast<bf16*>(smem_ch + Y_::SR), RB, r, base, sD, t0, nt, tid, kT);
    stage_rows<bf16, D, C>(reinterpret_cast<bf16*>(smem_ch + Y_::SK), RB, k, base, sD, t0, nt, tid, kT);
    stage_rows<bf16, D, C>(reinterpret_cast<bf16*>(smem_ch + Y_::SV), RB, v, base, sD, t0, nt, tid, kT);
    stage_rows<float, D, C>(reinterpret_cast<float*>(smem_ch + Y_::SO), P8, dout, base, sD, t0, nt,
                            tid, kT);
  };
  auto s0_load = [&](int c) {  // chunk c's start state
    for (int i = tid; i < D * (D / 4); i += kT) {
      const int row = i / (D / 4), p = (i % (D / 4)) * 4;
      cp_async16(reinterpret_cast<float*>(smem_ch + Y_::SS) + row * P8 + p,
                 st + (int64_t)c * D * D + row * D + p, true);
    }
  };
  float Gr[NXE][4];
  tile_load(Gr, dstate_out ? dstate_out + sbase : nullptr);
  rev_load(N - 1);
  s0_load(N - 1);
  cp_async_commit();
  load_w(N - 1);
  float du_acc = 0.f;  // channel dch's du (all TPC threads)
  for (int it = 0; it < N; ++it) {
  const int n = N - 1 - it;
  const int t0 = n * C, nt = min(C, S - t0);
  // the thread's indices again, opaque to the compiler: what it derives
  // from them (shared-memory addresses) is recomputed in each chunk, not
  // hoisted out of the loop and spilled (128 registers at two CTAs an SM)
  const int tid = opaque_tid(), warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int d0 = (warp % NSL) * 16, e0 = (warp / NSL) * EW;
  const int dch = tid / TPC, part = tid % TPC;
  // this warp's dv tiles: tokens 16 dm.., value columns 8 (dy + z)
  const int dm = warp / (D / 8 / DVT), dy = warp % (D / 8 / DVT) * DVT;
  // L of this thread's half (channel dch); G to shared memory
  float lc;
  {
    float lv[TOK];
    lc = chunk_cumsum<TOK, TPC>(wr, part, lv);
#pragma unroll
    for (int i = 0; i < TOK; ++i) Ls[(part * TOK + i) * P4 + dch] = lv[i];
  }
#pragma unroll
  for (int x = 0; x < NXE; ++x) {
    float* gp = Gs + (d0 + g) * P4 + e0 + 8 * x + 2 * q;
    *reinterpret_cast<float2*>(gp) = make_float2(Gr[x][0], Gr[x][1]);
    *reinterpret_cast<float2*>(gp + 8 * P4) = make_float2(Gr[x][2], Gr[x][3]);
  }
  cp_async_wait<0>();
  __syncthreads();  // [S1] the chunk's stage has landed

  // P2. (a) the decay vectors: 2^Lc, 2^P_T, 2^(P_T - E_tau) (P_T =
  //     Lq at tile T's first token, E_T = L at its last; every one a value
  //     of L, so the factors of a term cancel exactly)
  for (int d = tid; d < D; d += kT) {
    const float l_c = Ls[(C - 1) * P4 + d];
    Sdec[d] = ex2(l_c);
#pragma unroll
    for (int T = 0; T < NT; ++T) {
      const float pT = T ? Ls[(T * kTile - 1) * P4 + d] : 0.f;
      Pdec[T * D + d] = ex2(pT);
#pragma unroll
      for (int tau = 0; tau < T; ++tau)
        Cross[(T * NT + tau) * D + d] = ex2(pT - Ls[(tau * kTile + kTile - 1) * P4 + d]);
    }
  }
  //     (b) the decayed operands, a token and 4 channels a thread, every
  //     exponent <= 0: rhat = r 2^(Lq - P_T), kbar = k 2^(E_T - L), and in
  //     each tile rtil = r 2^(Lq - Q_T) (second half) or ktil = k 2^(Q_T -
  //     L) (first half), Q_T = L at the first half's last token
  for (int i = tid; i < C * (D / 4); i += kT) {
    const int t = i / (D / 4), p = (i % (D / 4)) * 4, T = t / kTile;
    const uint2 rw = *reinterpret_cast<const uint2*>(rs + t * RB + p);
    const uint2 kw = *reinterpret_cast<const uint2*>(ks + t * RB + p);
    const float rv[4] = {__uint_as_float(rw.x << 16), __uint_as_float(rw.x & 0xffff0000u),
                         __uint_as_float(rw.y << 16), __uint_as_float(rw.y & 0xffff0000u)};
    const float kv[4] = {__uint_as_float(kw.x << 16), __uint_as_float(kw.x & 0xffff0000u),
                         __uint_as_float(kw.y << 16), __uint_as_float(kw.y & 0xffff0000u)};
    const float4 l4 = *reinterpret_cast<const float4*>(Ls + t * P4 + p);
    const float4 lq4 = t ? *reinterpret_cast<const float4*>(Ls + (t - 1) * P4 + p)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 p4 = T ? *reinterpret_cast<const float4*>(Ls + (T * kTile - 1) * P4 + p)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 e4 = *reinterpret_cast<const float4*>(Ls + (T * kTile + kTile - 1) * P4 + p);
    const float4 q4 = *reinterpret_cast<const float4*>(Ls + (T * kTile + kHalf - 1) * P4 + p);
    const float l[4] = {l4.x, l4.y, l4.z, l4.w}, lq[4] = {lq4.x, lq4.y, lq4.z, lq4.w};
    const float pp[4] = {p4.x, p4.y, p4.z, p4.w}, ee[4] = {e4.x, e4.y, e4.z, e4.w};
    const float qq[4] = {q4.x, q4.y, q4.z, q4.w};
    const bool second = t % kTile >= kHalf;
    float rh[4], kb[4], ti[4];
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      rh[x] = rv[x] * ex2(lq[x] - pp[x]);
      kb[x] = kv[x] * ex2(ee[x] - l[x]);
      ti[x] = second ? rv[x] * ex2(lq[x] - qq[x]) : kv[x] * ex2(qq[x] - l[x]);
    }
    *reinterpret_cast<float4*>(Rh + t * P8 + p) = make_float4(rh[0], rh[1], rh[2], rh[3]);
    *reinterpret_cast<float4*>(Kb + t * P8 + p) = make_float4(kb[0], kb[1], kb[2], kb[3]);
    *reinterpret_cast<float4*>(Ti + t * P8 + p) = make_float4(ti[0], ti[1], ti[2], ti[3]);
  }
  //     (c) M = dO v^T on the tensor cores (16-token rows x 8-token columns
  //     at or below the diagonal; dO as hi + lo, v exact), stored as M' and
  //     M'^T with the first sub-diagonal zeroed (Msub keeps it) and its
  //     diagonal
  for (int item = warp; item < NT * (NT + 1); item += NW) {
    int m = 0;
    while (item >= (m + 1) * (m + 2)) ++m;
    const int x = item - m * (m + 1);  // 8-token column block, <= 2m + 1
    float c[2][4] = {};
#pragma unroll
    for (int j = 0; j < KS; ++j) {
      const float* op = Os + (16 * m + g) * P8 + 8 * j + 2 * q;
      const float2 a01 = *reinterpret_cast<const float2*>(op);
      const float2 a23 = *reinterpret_cast<const float2*>(op + 8 * P8);
      unsigned ah[4], al[4];
      split_tf32(a01.x, ah[0], al[0]);
      split_tf32(a23.x, ah[1], al[1]);
      split_tf32(a01.y, ah[2], al[2]);
      split_tf32(a23.y, ah[3], al[3]);
      const unsigned vw = *reinterpret_cast<const unsigned*>(vs + (8 * x + g) * RB + 8 * j + 2 * q);
      const unsigned b0 = vw << 16, b1 = vw & 0xffff0000u;
      mma_tf32(c[0], al, b0, b1);
      mma_tf32(c[1], ah, b0, b1);
    }
#pragma unroll
    for (int y = 0; y < 4; ++y) {
      const int t = 16 * m + g + (y >> 1) * 8, s = 8 * x + 2 * q + (y & 1);
      const float val = c[0][y] + c[1][y];
      if (s == t) Mdiag[t] = val;
      if (s == t - 1) Msub[t] = val;
      const float mv = s == t - 1 ? 0.f : val;
      Mp[t * PM + s] = mv;
      Mt[s * PM + t] = mv;
    }
  }
  //     (d) the bonus sum_d r u k on A's diagonal, into A^T
  for (int t = warp; t < C; t += NW) {
    float bonus = 0.f;
#pragma unroll
    for (int d = lane; d < D; d += 32) bonus += to_f32(rs[t * RB + d]) * Us[d] * to_f32(ks[t * RB + d]);
    bonus = warp_sum(bonus);
    if (lane == 0) At[t * PM + t] = bonus;
  }
  //     (e) X^T = S0 dO^T and Y^T = G v^T, a 16-row key slice x 8 tokens a
  //     tile (S0, dO, G as hi + lo; v exact), kept in registers for P3
  //     (the warp's XYT tiles share the key slice, so the S0 and G
  //     fragments are split once for all of them)
  float cx[XYT][4] = {}, cy[XYT][4] = {};
  {
    const int dd = (warp % NSL) * 16;
    static_assert(NW % NSL == 0, "a warp's tiles share its key slice");
#pragma unroll
    for (int j = 0; j < KS; ++j) {
      const float* sp = S0s + (dd + g) * P8 + 8 * j + 2 * q;
      const float2 s01 = *reinterpret_cast<const float2*>(sp);
      const float2 s23 = *reinterpret_cast<const float2*>(sp + 8 * P8);
      unsigned sh[4], sl[4];
      split_tf32(s01.x, sh[0], sl[0]);
      split_tf32(s23.x, sh[1], sl[1]);
      split_tf32(s01.y, sh[2], sl[2]);
      split_tf32(s23.y, sh[3], sl[3]);
      const float* gp = Gs + (dd + g) * P4 + 8 * j + q;
      unsigned gh[4], gl[4];
      split_tf32(gp[0], gh[0], gl[0]);
      split_tf32(gp[8 * P4], gh[1], gl[1]);
      split_tf32(gp[4], gh[2], gl[2]);
      split_tf32(gp[8 * P4 + 4], gh[3], gl[3]);
#pragma unroll
      for (int z = 0; z < XYT; ++z) {
        const int x = (warp + z * NW) / NSL;  // the tile's 8-token block
        const float2 o = *reinterpret_cast<const float2*>(Os + (8 * x + g) * P8 + 8 * j + 2 * q);
        unsigned bh0, bl0, bh1, bl1;
        split_tf32(o.x, bh0, bl0);
        split_tf32(o.y, bh1, bl1);
        mma_tf32(cx[z], sl, bh0, bh1);
        mma_tf32(cx[z], sh, bl0, bl1);
        mma_tf32(cx[z], sh, bh0, bh1);
        const bf16* vp = vs + (8 * x + g) * RB + 8 * j + q;
        const unsigned b0 = bf16_bits(vp[0]), b1 = bf16_bits(vp[4]);
        mma_tf32(cy[z], gl, b0, b1);
        mma_tf32(cy[z], gh, b0, b1);
      }
    }
  }
  //     (f) dv's state part, kfut G (kfut = k 2^(Lc - L) and G as hi + lo),
  //     16 tokens x 8 value columns a tile; a warp's DVT tiles share their
  //     tokens, so kfut's fragments are built once for all of them
  float dvr[DVT][4];
  {
    float c[DVT][4] = {};
#pragma unroll
    for (int j = 0; j < KS; ++j) {
      const int c0 = 8 * j + 2 * q;
      const float2 lc2 = *reinterpret_cast<const float2*>(Ls + (C - 1) * P4 + c0);
      const float2 l01 = *reinterpret_cast<const float2*>(Ls + (16 * dm + g) * P4 + c0);
      const float2 l23 = *reinterpret_cast<const float2*>(Ls + (16 * dm + g + 8) * P4 + c0);
      const unsigned k01 = *reinterpret_cast<const unsigned*>(ks + (16 * dm + g) * RB + c0);
      const unsigned k23 = *reinterpret_cast<const unsigned*>(ks + (16 * dm + g + 8) * RB + c0);
      unsigned ah[4], al[4];
      split_tf32(__uint_as_float(k01 << 16) * ex2(lc2.x - l01.x), ah[0], al[0]);
      split_tf32(__uint_as_float(k23 << 16) * ex2(lc2.x - l23.x), ah[1], al[1]);
      split_tf32(__uint_as_float(k01 & 0xffff0000u) * ex2(lc2.y - l01.y), ah[2], al[2]);
      split_tf32(__uint_as_float(k23 & 0xffff0000u) * ex2(lc2.y - l23.y), ah[3], al[3]);
#pragma unroll
      for (int z = 0; z < DVT; ++z) {
        const int col = 8 * (dy + z) + g;  // G rows c0, c0 + 1
        unsigned bh0, bh1, bl0, bl1;
        split_tf32(Gs[c0 * P4 + col], bh0, bl0);
        split_tf32(Gs[(c0 + 1) * P4 + col], bh1, bl1);
        mma_tf32(c[z], al, bh0, bh1);
        mma_tf32(c[z], ah, bl0, bl1);
        mma_tf32(c[z], ah, bh0, bh1);
      }
    }
#pragma unroll
    for (int z = 0; z < DVT; ++z)
#pragma unroll
      for (int e = 0; e < 4; ++e) dvr[z][e] = c[z][e];
  }
  //     (g) Z = 2^Lc sum_e G S0 of channel dch, over its TPC threads
  float zsum = 0.f;
#pragma unroll
  for (int e = part * (D / TPC); e < (part + 1) * (D / TPC); ++e)
    zsum += Gs[dch * P4 + e] * S0s[dch * P8 + e];
  zsum = warp_sum<TPC>(zsum) * ex2(lc);
  __syncthreads();  // [S2] S0 and G are no longer read

  // P3. (a) A's factored blocks (tile T against each earlier 8-token block;
  //     each tile's second half against its first), into A^T
  constexpr int kOff = NT * (NT - 1);
  for (int item = warp; item < kOff + NT; item += NW) {
    float c[3][4] = {};
    unsigned ah[4], al[4], bh0, bh1, bl0, bl1;
    if (item < kOff) {
      int T = 1, j = item;
      while (j >= 2 * T) {
        j -= 2 * T;
        ++T;
      }
      const float* ra = Rh + (T * kTile + g) * P8;
      const float* kb = Kb + (8 * j + g) * P8;
      const float* cr = Cross + (T * NT + j / 2) * D;
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        const int c0 = 8 * s + 2 * q;
        const float2 a01 = *reinterpret_cast<const float2*>(ra + c0);
        const float2 a23 = *reinterpret_cast<const float2*>(ra + 8 * P8 + c0);
        const float2 kk = *reinterpret_cast<const float2*>(kb + c0);
        const float2 cc = *reinterpret_cast<const float2*>(cr + c0);
        split_tf32(a01.x, ah[0], al[0]);
        split_tf32(a23.x, ah[1], al[1]);
        split_tf32(a01.y, ah[2], al[2]);
        split_tf32(a23.y, ah[3], al[3]);
        split_tf32(kk.x * cc.x, bh0, bl0);
        split_tf32(kk.y * cc.y, bh1, bl1);
        mma_tf32(c[0], al, bh0, bh1);
        mma_tf32(c[1], ah, bl0, bl1);
        mma_tf32(c[2], ah, bh0, bh1);
      }
      const int t = T * kTile + g, s = 8 * j + 2 * q;
      At[s * PM + t] = c[0][0] + c[1][0] + c[2][0];
      At[(s + 1) * PM + t] = c[0][1] + c[1][1] + c[2][1];
      At[s * PM + t + 8] = c[0][2] + c[1][2] + c[2][2];
      At[(s + 1) * PM + t + 8] = c[0][3] + c[1][3] + c[2][3];
    } else {
      const int T = item - kOff;  // mma rows 0..7: the second half; 8..15 unused
      const float* ra = Ti + (T * kTile + kHalf + g) * P8;
      const float* kb = Ti + (T * kTile + g) * P8;
      ah[1] = ah[3] = al[1] = al[3] = 0u;
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        const int c0 = 8 * s + 2 * q;
        const float2 a = *reinterpret_cast<const float2*>(ra + c0);
        const float2 kk = *reinterpret_cast<const float2*>(kb + c0);
        split_tf32(a.x, ah[0], al[0]);
        split_tf32(a.y, ah[2], al[2]);
        split_tf32(kk.x, bh0, bl0);
        split_tf32(kk.y, bh1, bl1);
        mma_tf32(c[0], al, bh0, bh1);
        mma_tf32(c[1], ah, bl0, bl1);
        mma_tf32(c[2], ah, bh0, bh1);
      }
      const int t = T * kTile + kHalf + g, s = T * kTile + 2 * q;
      At[s * PM + t] = c[0][0] + c[1][0] + c[2][0];
      At[(s + 1) * PM + t] = c[0][1] + c[1][1] + c[2][1];
    }
  }
  //     (b) A's 8-token diagonal halves per element (a warp a half, a lane
  //     a channel, the 28 pair sums by a shuffle reduce-scatter), into A^T,
  //     on the last warps (the first ones take (a))
  for (int item = NW - 1 - warp; item < CT; item += NW) {
    const int h0 = item * kHalf;
    float acc[32];
#pragma unroll
    for (int x = 0; x < 32; ++x) acc[x] = 0.f;
#pragma unroll 1
    for (int d = lane; d < D; d += 32) {
      float rv[kHalf], kv[kHalf], lq[kHalf], lw[kHalf];
#pragma unroll
      for (int x = 0; x < kHalf; ++x) {
        rv[x] = to_f32(rs[(h0 + x) * RB + d]);
        kv[x] = to_f32(ks[(h0 + x) * RB + d]);
        lq[x] = h0 + x ? Ls[(h0 + x - 1) * P4 + d] : 0.f;
        lw[x] = Ls[(h0 + x) * P4 + d];
      }
#pragma unroll
      for (int t = 1; t < kHalf; ++t)
#pragma unroll
        for (int s = 0; s < t; ++s) acc[t * (t - 1) / 2 + s] += rv[t] * kv[s] * ex2(lq[t] - lw[s]);
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
      At[(h0 + s) * PM + h0 + t] = acc[0];
    }
  }
  //     (c) dr's and dk's intra sums on X's and Y's tiles: dr's 2^(Lq_t -
  //     P_T) sum_s M'_ts kbar_s 2^(P_T - E_s) against earlier tiles and
  //     2^(Lq_t - Q_T) sum_s M'_ts ktil_s inside the tile, added to 2^Lq X;
  //     dk's 2^(E_s - L_s) sum_t M'_ts rhat_t 2^(P_t - E_s) and 2^(Q_s -
  //     L_s) sum_t M'_ts rtil_t beside 2^(Lc - L) Y; staged [d][t] over S0
  //     and G (no longer read).  One tile at a time (selects, not indices,
  //     pick its X and Y), so that the two do not share the registers.
#pragma unroll 1
  for (int z = 0; z < XYT; ++z) {
    const int item = warp + z * NW, dd = (item % NSL) * 16, x = item / NSL, T = x / 2;
    float xz[4], yz[4];
#pragma unroll
    for (int y = 0; y < 4; ++y) {
      xz[y] = cx[0][y];
      yz[y] = cy[0][y];
#pragma unroll
      for (int zz = 1; zz < XYT; ++zz) {
        xz[y] = z == zz ? cx[zz][y] : xz[y];
        yz[y] = z == zz ? cy[zz][y] : yz[y];
      }
    }
    const bool second = x & 1;
    unsigned ah[4], al[4], bh0, bh1, bl0, bl1;
    // A operand: rows dd + g, dd + g + 8 (channels); columns 8j + q, + 4
    // (tokens) of src[token][channel] times cr[channel]
    auto frag = [&](const float* src, int j, const float* cr) {
      const float* p = src + (8 * j + q) * P8 + dd + g;
      const float c0 = cr ? cr[dd + g] : 1.f, c1 = cr ? cr[dd + g + 8] : 1.f;
      split_tf32(p[0] * c0, ah[0], al[0]);
      split_tf32(p[8] * c1, ah[1], al[1]);
      split_tf32(p[4 * P8] * c0, ah[2], al[2]);
      split_tf32(p[4 * P8 + 8] * c1, ah[3], al[3]);
    };
    // B operand: rows 8j + q, + 4, column 8x + g of M' (via mp[column][row])
    auto mfrag = [&](const float* mp, int j) {
      const float* p = mp + (8 * x + g) * PM + 8 * j + q;
      split_tf32(p[0], bh0, bl0);
      split_tf32(p[4], bh1, bl1);
    };
    // c[0] the lo products, c[1] hi.hi (two chains)
    auto step = [&](float (&c)[2][4]) {
      mma_tf32(c[0], al, bh0, bh1);
      mma_tf32(c[0], ah, bl0, bl1);
      mma_tf32(c[1], ah, bh0, bh1);
    };
    float fc[2][4] = {}, fh[2][4] = {};
    for (int j = 0; j < 2 * T; ++j) {  // dr: earlier tiles' tokens
      frag(Kb, j, Cross + (T * NT + j / 2) * D);
      mfrag(Mp, j);
      step(fc);
    }
    if (second) {  // dr: the tile's first half
      frag(Ti, 2 * T, nullptr);
      mfrag(Mp, 2 * T);
      step(fh);
    }
    float gc[2][4] = {}, gh[2][4] = {};
    for (int j = 2 * T + 2; j < CT; ++j) {  // dk: later tiles' tokens
      frag(Rh, j, Cross + ((j / 2) * NT + T) * D);
      mfrag(Mt, j);
      step(gc);
    }
    if (!second) {  // dk: the tile's second half
      frag(Ti, 2 * T + 1, nullptr);
      mfrag(Mt, 2 * T + 1);
      step(gh);
    }
#pragma unroll
    for (int y = 0; y < 4; ++y) {
      const int d = dd + g + (y >> 1) * 8, t = 8 * x + 2 * q + (y & 1);
      const float lq = t ? Ls[(t - 1) * P4 + d] : 0.f, l = Ls[t * P4 + d];
      float a = ex2(lq) * xz[y];
      if (T) a += ex2(lq - Ls[(T * kTile - 1) * P4 + d]) * (fc[0][y] + fc[1][y]);
      if (second) a += ex2(lq - Ls[(T * kTile + kHalf - 1) * P4 + d]) * (fh[0][y] + fh[1][y]);
      float f = 0.f;
      if (T < NT - 1) f += ex2(Ls[(T * kTile + kTile - 1) * P4 + d] - l) * (gc[0][y] + gc[1][y]);
      if (!second) f += ex2(Ls[(T * kTile + kHalf - 1) * P4 + d] - l) * (gh[0][y] + gh[1][y]);
      const int i0 = d * PT + t;
      Xr[i0] = a;
      Yk[i0] = ex2(Ls[(C - 1) * P4 + d] - l) * yz[y];
      Fk[i0] = f;
    }
  }
  //     (d) G <- 2^Lc G + rdec^T dO (rdec = rhat 2^P_T and dO as hi + lo),
  //     this warp's tile in registers
  {
    const float dec0 = Sdec[d0 + g], dec1 = Sdec[d0 + g + 8];
#pragma unroll
    for (int x = 0; x < NXE; ++x)
#pragma unroll
      for (int y = 0; y < 4; ++y) Gr[x][y] *= y < 2 ? dec0 : dec1;
#pragma unroll
    for (int j = 0; j < CT; ++j) {
      const float* pd = Pdec + (j / 2) * D + d0 + g;
      const float p0 = pd[0], p1 = pd[8];
      const float* rp = Rh + (8 * j + q) * P8 + d0 + g;
      unsigned ah[4], al[4];
      split_tf32(rp[0] * p0, ah[0], al[0]);
      split_tf32(rp[8] * p1, ah[1], al[1]);
      split_tf32(rp[4 * P8] * p0, ah[2], al[2]);
      split_tf32(rp[4 * P8 + 8] * p1, ah[3], al[3]);
#pragma unroll
      for (int x = 0; x < NXE; ++x) {
        const float* op = Os + (8 * j + q) * P8 + e0 + 8 * x + g;
        unsigned bh0, bl0, bh1, bl1;
        split_tf32(op[0], bh0, bl0);
        split_tf32(op[4 * P8], bh1, bl1);
        mma_tf32(Gr[x], al, bh0, bh1);
        mma_tf32(Gr[x], ah, bl0, bl1);
        mma_tf32(Gr[x], ah, bh0, bh1);
      }
    }
  }
  __syncthreads();  // [S3]

  // P4. dv += A^T dO over the token blocks at or after the tiles' (A and dO
  //     as hi + lo; A's fragments shared by the warp's tiles), staged
  //     [t][e] in TI (its til is no longer read)
  {
    float c[DVT][4] = {};
    for (int j = 2 * dm; j < CT; ++j) {
      const float* ap = At + (16 * dm + g) * PM + 8 * j + q;
      unsigned ah[4], al[4];
      split_tf32(ap[0], ah[0], al[0]);
      split_tf32(ap[8 * PM], ah[1], al[1]);
      split_tf32(ap[4], ah[2], al[2]);
      split_tf32(ap[8 * PM + 4], ah[3], al[3]);
#pragma unroll
      for (int z = 0; z < DVT; ++z) {
        const float* op = Os + (8 * j + q) * P8 + 8 * (dy + z) + g;
        unsigned bh0, bh1, bl0, bl1;
        split_tf32(op[0], bh0, bl0);
        split_tf32(op[4 * P8], bh1, bl1);
        mma_tf32(c[z], al, bh0, bh1);
        mma_tf32(c[z], ah, bl0, bl1);
        mma_tf32(c[z], ah, bh0, bh1);
      }
    }
#pragma unroll
    for (int z = 0; z < DVT; ++z) {
      float* tp = Ti + (16 * dm + g) * P8 + 8 * (dy + z) + 2 * q;
      *reinterpret_cast<float2*>(tp) = make_float2(dvr[z][0] + c[z][0], dvr[z][1] + c[z][1]);
      *reinterpret_cast<float2*>(tp + 8 * P8) = make_float2(dvr[z][2] + c[z][2], dvr[z][3] + c[z][3]);
    }
  }
  __syncthreads();  // [S4]

  // P5. channel dch, the 8 tokens of half `part`: the half's per-element
  //     sums (pairs s < t - 1, one exponent a pair), the adjacent pairs
  //     (decay 2^0: M[t][t-1] k_{t-1} and M[t+1][t] r_{t+1}) and the bonus;
  //     dr and dk; then d(log w) = Z + sum_{t' > t} a + sum_{s < t} bc -
  //     sum_{s >= t} bf across the channel's TPC threads by shuffles
  {
    const int h0 = part * kHalf;
    float rv[kHalf], kv[kHalf], lv[kHalf], lqv[kHalf], sr[kHalf], sk[kHalf];
#pragma unroll
    for (int x = 0; x < kHalf; ++x) {
      rv[x] = to_f32(rs[(h0 + x) * RB + dch]);
      kv[x] = to_f32(ks[(h0 + x) * RB + dch]);
      lv[x] = Ls[(h0 + x) * P4 + dch];
      lqv[x] = h0 + x ? Ls[(h0 + x - 1) * P4 + dch] : 0.f;
      sr[x] = sk[x] = 0.f;
    }
#pragma unroll
    for (int t = 2; t < kHalf; ++t)
#pragma unroll
      for (int s = 0; s + 1 < t; ++s) {
        const float m = Mp[(h0 + t) * PM + h0 + s] * ex2(lqv[t] - lv[s]);
        sr[t] += m * kv[s];
        sk[s] += m * rv[t];
      }
    const float ud = Us[dch];
    const float kprev = h0 ? to_f32(ks[(h0 - 1) * RB + dch]) : 0.f;
    const float rnext = h0 + kHalf < C ? to_f32(rs[(h0 + kHalf) * RB + dch]) : 0.f;
    float av[kHalf], bc[kHalf], bf[kHalf], dul = 0.f;
#pragma unroll
    for (int x = 0; x < kHalf; ++x) {
      const int t = h0 + x, i0 = dch * PT + t;
      const float mtt = Mdiag[t];
      const float r_sum = Xr[i0] + sr[x];
      const float ky = Yk[i0], k_far = Fk[i0] + sk[x];
      Xr[i0] = r_sum + Msub[t] * (x ? kv[x - 1] : kprev) + ud * kv[x] * mtt;
      Yk[i0] = ky + k_far + Msub[t + 1] * (x + 1 < kHalf ? rv[x + 1] : rnext) + ud * rv[x] * mtt;
      av[x] = rv[x] * r_sum;
      bc[x] = kv[x] * ky;
      bf[x] = kv[x] * k_far;
      dul += rv[x] * kv[x] * mtt;
    }
    du_acc += warp_sum<TPC>(dul);
    float ta_ = 0.f, tbc = 0.f, tbf = 0.f;
#pragma unroll
    for (int x = 0; x < kHalf; ++x) {
      ta_ += av[x];
      tbc += bc[x];
      tbf += bf[x];
    }
    float pbc = tbc, sa = ta_, sbf = tbf;  // inclusive prefix of bc, suffixes of a and bf
#pragma unroll
    for (int o = 1; o < TPC; o <<= 1) {
      const float y0 = __shfl_up_sync(kFull, pbc, o, TPC);
      const float y1 = __shfl_down_sync(kFull, sa, o, TPC);
      const float y2 = __shfl_down_sync(kFull, sbf, o, TPC);
      if (part >= o) pbc += y0;
      if (part + o < TPC) {
        sa += y1;
        sbf += y2;
      }
    }
    float before_bc = __shfl_up_sync(kFull, pbc, 1, TPC);
    float after_a = __shfl_down_sync(kFull, sa, 1, TPC);
    float after_bf = __shfl_down_sync(kFull, sbf, 1, TPC);
    if (part == 0) before_bc = 0.f;
    if (part == TPC - 1) after_a = after_bf = 0.f;
    float dl[kHalf];
#pragma unroll
    for (int x = 0; x < kHalf; ++x) {
      dl[x] = zsum + before_bc;
      before_bc += bc[x];
    }
#pragma unroll
    for (int x = kHalf - 1; x >= 0; --x) {
      after_bf += bf[x];
      dl[x] += after_a - after_bf;
      after_a += av[x];
    }
#pragma unroll
    for (int x = 0; x < kHalf; ++x) Fk[dch * PT + h0 + x] = dl[x];
  }
  __syncthreads();  // [S5] r, k, v and dO are no longer read
  if (n > 0) {
    rev_load(n - 1);
    cp_async_commit();
    load_w(n - 1);
  }

  // P6. dr, dk, dv and d(log w) of the live tokens to device memory
  for (int i = tid; i < nt * (D / 8); i += kT) {
    const int t = i / (D / 8), p = (i % (D / 8)) * 8;
    const int64_t gi = base + (int64_t)(t0 + t) * sD + p;
    float x[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) x[j] = Xr[(p + j) * PT + t];
    *reinterpret_cast<uint4*>(dr + gi) = Vec<bf16>::pack(x);
#pragma unroll
    for (int j = 0; j < 8; ++j) x[j] = Yk[(p + j) * PT + t];
    *reinterpret_cast<uint4*>(dk + gi) = Vec<bf16>::pack(x);
    const float4 a = *reinterpret_cast<const float4*>(Ti + t * P8 + p);
    const float4 c4 = *reinterpret_cast<const float4*>(Ti + t * P8 + p + 4);
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = c4.x; x[5] = c4.y; x[6] = c4.z; x[7] = c4.w;
    *reinterpret_cast<uint4*>(dv + gi) = Vec<bf16>::pack(x);
#pragma unroll
    for (int j = 0; j < 8; ++j) x[j] = Fk[(p + j) * PT + t];
    *reinterpret_cast<float4*>(dlogw + gi) = make_float4(x[0], x[1], x[2], x[3]);
    *reinterpret_cast<float4*>(dlogw + gi + 4) = make_float4(x[4], x[5], x[6], x[7]);
  }
  __syncthreads();  // [S6] the staged outputs (over S0 and G) are read
  if (n > 0) {
    s0_load(n - 1);
    cp_async_commit();
  }
  }
  if (part == 0) du_part[(int64_t)bh * D + dch] = du_acc;
  if (dstate_in) tile_store(Gr, dstate_in + sbase);
}

template <int D, int C>
int launch_mma(const Args& a, cudaStream_t stream) {
  using Y_ = MmaSmem<D, C>;
  auto kernel = wkv_bwd_mma_kernel<D, C>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Y_::BYTES);
  if (err != cudaSuccess) return (int)err;
  kernel<<<a.B * a.H, Y_::THREADS, Y_::BYTES, stream>>>(
      static_cast<const bf16*>(a.r), static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
      static_cast<const float*>(a.w), static_cast<const float*>(a.u),
      static_cast<const float*>(a.state_in), static_cast<const float*>(a.dout),
      static_cast<const float*>(a.dstate_out), static_cast<bf16*>(a.dr), static_cast<bf16*>(a.dk),
      static_cast<bf16*>(a.dv), static_cast<float*>(a.dlogw), static_cast<float*>(a.dstate_in),
      static_cast<float*>(a.states), static_cast<float*>(a.du_part), a.S, a.H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int HD = a.H * D;
  du_sum_kernel<<<(HD + 255) / 256, 256, 0, stream>>>(static_cast<const float*>(a.du_part),
                                                      static_cast<float*>(a.du), a.B, HD);
  return (int)cudaGetLastError();
}

template <int D>
int launch_mma_c(int chunk, const Args& a, cudaStream_t s) {
  switch (chunk) {
    case 16: return launch_mma<D, 16>(a, s);
    case 32:
    case 64: return launch_mma<D, kMmaChunk>(a, s);
  }
  return -2;
}

}  // namespace

// r, k, v: (B, S, H, D) contiguous, f32 (in_dtype 0) or bf16 (1); w: the
// same shape, f32 decay; u: (H, D) f32; state_in (may be null): (B, H, D,
// D) f32; dout: (B, S, H, D) f32; dstate_out (may be null): (B, H, D, D)
// f32.  Writes dr, dk, dv (r's type), dlogw (f32, the shape of w), du (H,
// D) f32 and, when state_in is given, dstate_in (B, H, D, D) f32.  Scratch:
// states (B, H, ceil(S / chunk), D, D) f32 and du_part (B, H, D) f32.  D in
// {32, 64}; chunk in {16, 32, 64}.  Returns 0 or a CUDA error code
// (negative for an unsupported D, chunk or dtype); launches on `stream`
// and does not synchronise.
extern "C" int wkv_backward(const void* r, const void* k, const void* v, const void* w,
                            const void* u, const void* state_in, const void* dout,
                            const void* dstate_out, void* dr, void* dk, void* dv, void* dlogw,
                            void* du, void* dstate_in, void* states, void* du_part, int B, int S,
                            int H, int D, int chunk, int in_dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return -3;
  const Args a{r, k, v, w, u, state_in, dout, dstate_out, dr, dk, dv, dlogw, du,
               state_in ? dstate_in : nullptr, states, du_part, B, S, H};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (in_dtype) {
    case 0: return launch_d<float>(D, chunk, a, s);
    case 1: return launch_d<__nv_bfloat16>(D, chunk, a, s);
  }
  return -1;
}

// The tensor-core entry: the arguments of wkv_backward, r/k/v bf16 only
// (in_dtype 1), every pointer 16-byte aligned (cp.async and 16-byte
// stores).  A chunk of 64 runs as 32 (kMmaChunk), so the scratch `states`
// holds ceil(S / min(chunk, 32)) chunk states (ops.scratch_chunk).  D in
// {32, 64}.
extern "C" int wkv_backward_mma(const void* r, const void* k, const void* v, const void* w,
                                const void* u, const void* state_in, const void* dout,
                                const void* dstate_out, void* dr, void* dk, void* dv,
                                void* dlogw, void* du, void* dstate_in, void* states,
                                void* du_part, int B, int S, int H, int D, int chunk,
                                int in_dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return -3;
  if (in_dtype != 1) return -1;
  const Args a{r, k, v, w, u, state_in, dout, dstate_out, dr, dk, dv, dlogw, du,
               state_in ? dstate_in : nullptr, states, du_part, B, S, H};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch_mma_c<32>(chunk, a, s);
    case 64: return launch_mma_c<64>(chunk, a, s);
  }
  return -2;
}
