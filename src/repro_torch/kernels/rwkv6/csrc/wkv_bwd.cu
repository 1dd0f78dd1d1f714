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
// was passed).  r/k/v f32 or bf16 (widened to f32 in shared memory); all
// arithmetic f32 on the CUDA cores.
//
// Bound on an H100 SXM at rwkv6-1.6b's training shape (B 8, S 2048, H 32,
// D 64, bf16 r/k/v): bytes, ~805 MB (r/k/v bf16, w and dO f32 read, dr/dk/dv
// bf16 and d(log w) f32 written once) at 3.35 TB/s, 0.240 ms, which bounds
// it; the four D x D products a token and head (S dO, G v, G^T kfut, the
// transposed state update: 8 D^2 flops) as 3xTF32 on the tensor cores (a
// third of the TF32 peak), 0.104 ms.  This first kernel is CUDA cores
// only (the same flops at the f32 CUDA-core peak: 0.256 ms); a
// tensor-core pass is later work.
//
// Design: one CTA per (b, h), 1024 threads at C = 32 and 512 at C = 16
// and 64, the sequence's chunks (C = 16, 32 or 64 tokens, the forward's
// chunk) in a loop inside the CTA:
//   1. a forward pass over the chunks recomputes each chunk's start state S0
//      and keeps it in a scratch buffer (B, H, N, D, D) f32 (268 MB at the
//      training shape, written and read once).  The alternative, S0 saved
//      by the forward kernel, would hold that buffer from the forward to the
//      backward for every layer (24 x 268 MB on rwkv6-1.6b without remat)
//      and change the serving kernel; recomputing costs one more read of k,
//      v and w;
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
//      token.  Under strong decay those adjacent pairs are the large ones;
//      kept in (the suffix identity over the whole sequence), the difference
//      loses ~1e-4 of d(w) in f32.
// A ragged last chunk is zero-filled (r = k = v = dO = 0, log w = 0), which
// adds nothing; only live tokens are written.  Shared memory: the chunk's
// operands, M and A, G, and S0 (in the a / b arrays' place when it fits):
// 116 KB at C 32, D 64 (one CTA an SM, so the threads a CTA are many),
// 231 KB at C 64.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (repro_torch/kernels/_build.py).  Plain C entry
// point, bound with ctypes by repro_torch/kernels/rwkv6/kernel.py.

#include "../../csrc/common.cuh"

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
