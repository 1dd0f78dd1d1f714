// MM PU: (M, K) @ (K, N) with f32 accumulation and a fused epilogue, for
// the int8 weight-only FFN stage and the mm_pu entry point.
//
// Replaces the TPU kernel src/repro/kernels/mm_pu/kernel.py::_mm_kernel
// (Pallas, launched by mm_pu_call).  Same function:
//     acc = x @ w                     (f32; int8 w converted to f32)
//     out = act(acc * w_scale[n] + bias[n]) + residual[m, n]
// each term optional, in this order, cast to the output type; act is
// gelu (tanh form), silu, relu, relu^2 or none.
//
// Bound on an H100 SXM: at the FFN stage's shapes, operations: 2 M N K
// flops at the bf16 tensor-core rate of 989 TFLOP/s; bytes (x, w, the
// output, each once) take far less at 3.35 TB/s.  Two kernels, chosen by the
// wrapper from x's dtype alone (ops.mm_pu; never a fallback):
//
// bf16 x, bf16 or int8 w (mm_pu_forward_mma): tensor cores.  Every operand
// is exact in bf16 (int8 too: 8 significant bits) and every product exact in
// f32, so a bf16 mma with f32 accumulate differs from the reference's f32
// product only in the order of the sums.
//   * a 128 x 128 output tile per 256-thread CTA, K in 64-deep slices; 8
//     warps as 2 x 4, each 64 x 32 outputs (4 x 4 mma.sync m16n8k16 tiles,
//     64 f32 accumulators a thread);
//   * a 3-stage cp.async ring (16-byte copies) keeps two slices in flight
//     while one is computed; x fragments by ldmatrix, bf16 w by
//     ldmatrix.trans (w is k-major); shared rows are padded by 16 bytes so
//     the 8 rows of an ldmatrix fall in distinct banks;
//   * int8 w arrives as bytes and is widened to bf16 (exact) once per CTA
//     and slice, one slice ahead into a second bf16 tile and after the
//     slice's mma, so a slice costs one barrier; this stays a weight-only
//     product (no s8 x s8 IMMA: the reference upcasts both);
//   * the f32 tile leaves through shared memory, so the epilogue reads and
//     writes whole rows (8- or 16-byte stores);
//   * narrow grids split K (ops.launch_plan picks the splits so the grid
//     covers the 132 SMs): each split writes f32 partials to a workspace and
//     a second kernel sums them in a fixed order (deterministic) before the
//     epilogue, which is nonlinear and must see the whole sum;
//   * rows that are not 16-byte aligned (K or N not a multiple of 8 bf16 /
//     16 int8, or an unaligned base) take the same kernel with element
//     copies instead of cp.async (template flag kVec);
//   * mma.sync, not wgmma/TMA: the warp-level tile keeps one code path for
//     ragged, unaligned and split shapes; wgmma with TMA and warp
//     specialisation is later work.
//
// f32 x, f32 or int8 w (mm_pu_forward): CUDA cores, exact f32 FMAs (the
// reference holds f32 to 1e-5, which TF32 would miss):
//   * one 128 x 128 output tile per 256-thread CTA, 8 x 8 outputs per
//     thread held in registers (two 4 x 4 blocks 64 rows/columns apart, so
//     the shared-memory reads are float4 and free of bank conflicts);
//   * K walked in 16-deep slices staged in shared memory as f32, x stored
//     k-major; each thread loads the next slice from device memory into
//     registers before it computes on the current one;
//   * int8 w is converted to f32 as it is staged.
//
// Both apply the per-column scale once per output, in the epilogue, as the
// TPU kernel does, and mask ragged M, N and K themselves, so the wrapper
// pads nothing (the JAX wrapper pads to tile multiples).  Bias, residual,
// activation and the output type are runtime flags.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (repro_torch/kernels/_build.py).  Plain C entry
// points, bound with ctypes by repro_torch/kernels/mm_pu/kernel.py.

#include <type_traits>

#include "../../csrc/common.cuh"

namespace {

using namespace repro_torch;

constexpr int BM = 128, BN = 128, BK = 16;
constexpr int kThreads = 256;
constexpr int XPAD = 4;                      // Xs row padding: 2-way staging conflicts at most
constexpr int XL = BM * BK / kThreads;       // x values a thread stages per slice (8)
constexpr int WL = BK * BN / kThreads;       // w values a thread stages per slice (8)

enum Act { kNone = 0, kGelu = 1, kSilu = 2, kRelu = 3, kRelu2 = 4 };

__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case kGelu: {
      const float c = 0.7978845608028654f;  // sqrt(2 / pi)
      return v * (0.5f * (1.f + tanhf(c * (v + 0.044715f * (v * v * v)))));
    }
    case kSilu:
      return v / (1.f + expf(-v));
    case kRelu:
      return fmaxf(v, 0.f);
    case kRelu2: {
      const float r = fmaxf(v, 0.f);
      return r * r;
    }
  }
  return v;
}

// Slice k0 of x and w into registers, zeros outside (M, K) and (K, N).
// x: thread t stages k = t % 16 of rows t / 16 + 16 e; w: k = t / 16 of
// columns t % 16 + 16 e (e < 8): neighbouring threads read neighbouring
// addresses.
template <typename TX, typename TW>
__device__ __forceinline__ void load_slice(const TX* __restrict__ x, const TW* __restrict__ w,
                                           int M, int N, int K, int m0, int n0, int k0,
                                           float* xr, float* wr) {
  const int t = threadIdx.x;
  const int xk = k0 + (t & 15), wk = k0 + (t >> 4);
#pragma unroll
  for (int e = 0; e < XL; ++e) {
    const int m = m0 + (t >> 4) + 16 * e;
    xr[e] = (m < M && xk < K) ? to_f32(x[(long long)m * K + xk]) : 0.f;
  }
#pragma unroll
  for (int e = 0; e < WL; ++e) {
    const int n = n0 + (t & 15) + 16 * e;
    wr[e] = (wk < K && n < N) ? to_f32(w[(long long)wk * N + n]) : 0.f;
  }
}

template <typename TX, typename TW>
__global__ void __launch_bounds__(kThreads)
mm_pu_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
             const float* __restrict__ w_scale, const float* __restrict__ bias,
             const void* __restrict__ res, void* __restrict__ out, int M, int N, int K, int act,
             int res_bf16, int out_bf16) {
  __shared__ __align__(16) float Xs[BK][BM + XPAD];
  __shared__ __align__(16) float Ws[BK][BN];
  const int t = threadIdx.x;
  const int tx = t & 15, ty = t >> 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  float xr[XL], wr[WL];
  load_slice(x, w, M, N, K, m0, n0, 0, xr, wr);
  const int nk = (K + BK - 1) / BK;
  for (int s = 0; s < nk; ++s) {
#pragma unroll
    for (int e = 0; e < XL; ++e) Xs[t & 15][(t >> 4) + 16 * e] = xr[e];
#pragma unroll
    for (int e = 0; e < WL; ++e) Ws[t >> 4][(t & 15) + 16 * e] = wr[e];
    __syncthreads();
    if (s + 1 < nk) load_slice(x, w, M, N, K, m0, n0, (s + 1) * BK, xr, wr);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&Xs[kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&Xs[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Ws[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Ws[kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (n >= N) continue;
      float v = acc[i][j];
      if (w_scale != nullptr) v *= w_scale[n];
      if (bias != nullptr) v += bias[n];
      v = activate(v, act);
      const long long o = (long long)m * N + n;
      if (res != nullptr)
        v += res_bf16 ? to_f32(static_cast<const __nv_bfloat16*>(res)[o])
                      : static_cast<const float*>(res)[o];
      if (out_bf16)
        store(static_cast<__nv_bfloat16*>(out) + o, v);
      else
        store(static_cast<float*>(out) + o, v);
    }
  }
}

// The epilogue of output (m, n): scale, bias, activation, residual.
__device__ __forceinline__ float epilogue(float v, long long o, int n,
                                          const float* __restrict__ w_scale,
                                          const float* __restrict__ bias,
                                          const void* __restrict__ res, int act, int res_bf16) {
  if (w_scale != nullptr) v *= w_scale[n];
  if (bias != nullptr) v += bias[n];
  v = activate(v, act);
  if (res != nullptr)
    v += res_bf16 ? to_f32(static_cast<const __nv_bfloat16*>(res)[o])
                  : static_cast<const float*>(res)[o];
  return v;
}

// Outputs (m, n..n+3), those below N: the epilogue, then one 8-byte (bf16)
// or 16-byte (f32) store where all four are in range and aligned.
__device__ __forceinline__ void finish4(float4 v, int m, int n, int N,
                                        const float* __restrict__ w_scale,
                                        const float* __restrict__ bias,
                                        const void* __restrict__ res, void* __restrict__ out,
                                        int act, int res_bf16, int out_bf16) {
  const long long o = (long long)m * N + n;
  float e[4] = {v.x, v.y, v.z, v.w};
  const int cnt = min(4, N - n);
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (q < cnt) e[q] = epilogue(e[q], o + q, n + q, w_scale, bias, res, act, res_bf16);
  if (cnt == 4 && (o & 3) == 0) {
    if (out_bf16)
      *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(out) + o) =
          make_uint2(pack_bf16(e[0], e[1]), pack_bf16(e[2], e[3]));
    else
      *reinterpret_cast<float4*>(static_cast<float*>(out) + o) = make_float4(e[0], e[1], e[2], e[3]);
    return;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (q >= cnt) break;
    if (out_bf16)
      store(static_cast<__nv_bfloat16*>(out) + o + q, e[q]);
    else
      store(static_cast<float*>(out) + o + q, e[q]);
  }
}

// ---------------------------------------------------------------- bf16 x, tensor cores
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int BM = 128, BN = 128, BK = 64;
constexpr int kStages = 3;
constexpr int kWarpsM = 2, kWarpsN = 4;  // warp grid over the CTA tile
constexpr int kThreads = kWarpsM * kWarpsN * 32;
constexpr int WM = BM / kWarpsM, WN = BN / kWarpsN;  // one warp's outputs
constexpr int MI = WM / 16, NJ = WN / 8;             // its m16 x n8 mma tiles
static_assert(MI >= 1 && NJ % 2 == 0 && BK % 16 == 0 && kStages >= 3, "tile shape");
constexpr int XLD = BK + 8;  // shared row strides (elements): +16 bytes
constexpr int CLD = BN + 4;  // f32 output tile row stride (elements)
constexpr int WLD = BN + 8;
constexpr int kXStage = BM * XLD;  // bf16 elements
constexpr int kWStage = BK * WLD;  // bf16 elements
constexpr int kW8Stage = BK * BN;  // int8 bytes

// x stages, then w stages: bf16, or int8 plus two widened bf16 tiles;
// after the K loop the same bytes hold the f32 output tile.
template <bool kInt8>
constexpr size_t smem_bytes() {
  constexpr size_t ring = sizeof(bf16) * kStages * kXStage +
                          (kInt8 ? kStages * kW8Stage + 2 * sizeof(bf16) * kWStage
                                 : sizeof(bf16) * kStages * kWStage);
  constexpr size_t c_tile = sizeof(float) * BM * CLD;
  return ring > c_tile ? ring : c_tile;
}

// 16 int8 of an int8 stage row -> 16 bf16 of a widened row, exactly: each
// byte b goes into the f32 2^23 + (b + 128) by a byte permute, 2^23 + 128
// is subtracted (exact), and the upper half of the f32 is b's bf16 (an
// integer of at most 8 significant bits leaves the lower 16 bits zero).
__device__ __forceinline__ void widen16(const int8_t* src, bf16* dst) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
  unsigned o[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const unsigned u = w[i] ^ 0x80808080u;  // b + 128 in each byte
    float f[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      f[k] = __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7540u + k)) - 8388736.f;
    o[2 * i] = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632u);
    o[2 * i + 1] = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632u);
  }
  uint4* d = reinterpret_cast<uint4*>(dst);
  d[0] = make_uint4(o[0], o[1], o[2], o[3]);
  d[1] = make_uint4(o[4], o[5], o[6], o[7]);
}

// Slice [k0, k0 + BK) of x (rows m0..) and w (columns n0..) into one stage;
// zeros outside (M, k_end) and (k_end, N).  kVec: 16-byte cp.async copies
// (rows 16-byte aligned); otherwise element copies.
template <bool kInt8, bool kVec>
__device__ __forceinline__ void load_slice(const bf16* __restrict__ x, const void* __restrict__ w,
                                           int M, int N, int K, int k_end, int m0, int n0,
                                           int k0, bf16* xs, void* ws) {
  const int tid = threadIdx.x;
  using TW = typename std::conditional<kInt8, int8_t, bf16>::type;
  const TW* wt = static_cast<const TW*>(w);
  TW* wst = static_cast<TW*>(ws);
  constexpr int wld = kInt8 ? BN : WLD;
  if constexpr (kVec) {
#pragma unroll
    for (int c = tid; c < BM * BK / 8; c += kThreads) {
      const int r = c / (BK / 8), kc = (c % (BK / 8)) * 8;
      const int m = m0 + r, kk = k0 + kc;
      const bool ok = m < M && kk < k_end;
      cp_async16(xs + r * XLD + kc, ok ? x + (long long)m * K + kk : x, ok);
    }
    constexpr int per = 16 / sizeof(TW);  // elements per 16-byte chunk
#pragma unroll
    for (int c = tid; c < BK * BN / per; c += kThreads) {
      const int r = c / (BN / per), nc = (c % (BN / per)) * per;
      const int kk = k0 + r, n = n0 + nc;
      const bool ok = kk < k_end && n < N;
      cp_async16(wst + r * wld + nc, ok ? wt + (long long)kk * N + n : wt, ok);
    }
  } else {
    for (int e = tid; e < BM * BK; e += kThreads) {
      const int r = e / BK, kc = e % BK;
      const int m = m0 + r, kk = k0 + kc;
      xs[r * XLD + kc] = (m < M && kk < k_end) ? x[(long long)m * K + kk] : __float2bfloat16(0.f);
    }
    for (int e = tid; e < BK * BN; e += kThreads) {
      const int r = e / BN, nc = e % BN;
      const int kk = k0 + r, n = n0 + nc;
      wst[r * wld + nc] = (kk < k_end && n < N) ? wt[(long long)kk * N + n] : TW{};
    }
  }
}

// grid (N tiles, M tiles, splits); split z covers K [z kps, min(K, (z+1) kps)).
// splits == 1: the epilogue is applied here; else f32 partials go to
// ws[z][M][N] for mm_pu_splitk_reduce.
template <bool kInt8, bool kVec>
__global__ void __launch_bounds__(kThreads)
mm_pu_mma_kernel(const bf16* __restrict__ x, const void* __restrict__ w,
                 const float* __restrict__ w_scale, const float* __restrict__ bias,
                 const void* __restrict__ res, void* __restrict__ out, float* __restrict__ ws,
                 int M, int N, int K, int kps, int act, int res_bf16, int out_bf16) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* const xs = reinterpret_cast<bf16*>(smem_raw);
  unsigned char* const wbase = smem_raw + sizeof(bf16) * kStages * kXStage;
  // int8: two widened bf16 tiles after the int8 stages
  bf16* const wb = reinterpret_cast<bf16*>(wbase + (kInt8 ? kStages * kW8Stage : 0));
  auto w_stage = [&](int st) -> void* {
    return kInt8 ? static_cast<void*>(wbase + st * kW8Stage)
                 : static_cast<void*>(reinterpret_cast<bf16*>(wbase) + st * kWStage);
  };
  // int8: the slice's BK x BN bytes, 16 at a time, into widened tile sl & 1
  auto widen = [&](int sl) {
    const int8_t* src = static_cast<const int8_t*>(w_stage(sl % kStages));
    bf16* dst = wb + (sl & 1) * kWStage;
#pragma unroll
    for (int c = threadIdx.x; c < BK * BN / 16; c += kThreads) {
      const int r = c / (BN / 16), col = (c % (BN / 16)) * 16;
      widen16(src + r * BN + col, dst + r * WLD + col);
    }
  };

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;  // this warp's WM x WN outputs
  const int g = lane >> 2, t4 = lane & 3;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int k_begin = blockIdx.z * kps;
  const int k_end = min(K, k_begin + kps);
  const int nk = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  float acc[MI][NJ][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nk)
      load_slice<kInt8, kVec>(x, w, M, N, K, k_end, m0, n0, k_begin + st * BK, xs + st * kXStage,
                              w_stage(st));
    cp_async_commit();
  }
  if constexpr (kInt8) {  // slice 0 widened ahead of the loop
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (nk > 0) widen(0);
  }
  // Slice sl: x from its stage, w from its stage (bf16) or from widened
  // tile sl & 1 (int8), which iteration sl - 1 filled.  After its mma,
  // iteration sl widens slice sl + 1 into the other tile (read by iteration
  // sl - 1, before this iteration's barrier).  A thread widens exactly the
  // 16-byte chunks it copied itself (load_slice's chunk map is widen's), so
  // its own cp.async wait suffices; the element-copy path stored slice
  // sl + 1 before this iteration's barrier.  One barrier per slice.
  for (int sl = 0; sl < nk; ++sl) {
    cp_async_wait<kStages - 2>();  // slice sl has landed (this thread's copies) ...
    __syncthreads();               // ... every thread's, and slice sl - 1 is consumed
    {
      const int nxt = sl + kStages - 1;
      if (nxt < nk)
        load_slice<kInt8, kVec>(x, w, M, N, K, k_end, m0, n0, k_begin + nxt * BK,
                                xs + (nxt % kStages) * kXStage, w_stage(nxt % kStages));
      cp_async_commit();
    }
    const bf16* xt = xs + (sl % kStages) * kXStage;
    const bf16* wt = kInt8 ? wb + (sl & 1) * kWStage
                           : static_cast<const bf16*>(w_stage(sl % kStages));
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      unsigned af[MI][4], bfr[NJ / 2][4];
#pragma unroll
      for (int i = 0; i < MI; ++i)
        ldmatrix_x4(af[i], xt + (wm * WM + i * 16 + (lane & 15)) * XLD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int jp = 0; jp < NJ / 2; ++jp)
        ldmatrix_x4_trans(bfr[jp], wt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * WLD +
                                       wn * WN + jp * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          mma_bf16_16816(acc[i][j], af[i], bfr[j >> 1][2 * (j & 1)], bfr[j >> 1][2 * (j & 1) + 1]);
    }
    if constexpr (kInt8) {
      if (sl + 1 < nk) {
        cp_async_wait<kStages - 2>();  // slice sl + 1's chunks this thread copied have landed
        widen(sl + 1);
      }
    }
  }
  // The f32 tile goes through shared memory, so that rows leave in
  // coalesced runs: each warp then takes one row of 128 outputs at a time,
  // 4 adjacent columns a lane.
  cp_async_wait<0>();
  __syncthreads();
  float* const cs = reinterpret_cast<float*>(smem_raw);
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        *reinterpret_cast<float2*>(cs + (wm * WM + i * 16 + g + 8 * h) * CLD + wn * WN + j * 8 +
                                   2 * t4) = make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
  __syncthreads();
  for (int r = warp; r < BM; r += kThreads / 32) {
    const int m = m0 + r;
    if (m >= M) break;
#pragma unroll
    for (int c = 4 * lane; c < BN; c += 128) {
      const int n = n0 + c;
      if (n >= N) break;
      const float4 v = *reinterpret_cast<const float4*>(cs + r * CLD + c);
      if (ws != nullptr) {
        float* p = ws + ((long long)blockIdx.z * M + m) * N + n;
        const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (n + q < N) p[q] = e[q];
      } else {
        finish4(v, m, n, N, w_scale, bias, res, out, act, res_bf16, out_bf16);
      }
    }
  }
}

// out[m, n] = epilogue(sum over z = 0, 1, ... of ws[z][m][n]), in that order.
__global__ void mm_pu_splitk_reduce(const float* __restrict__ ws, int splits,
                                    const float* __restrict__ w_scale,
                                    const float* __restrict__ bias, const void* __restrict__ res,
                                    void* __restrict__ out, int M, int N, int act, int res_bf16,
                                    int out_bf16) {
  const long long mn = (long long)M * N;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= mn) return;
  float v = 0.f;
  for (int z = 0; z < splits; ++z) v += ws[z * mn + idx];
  const long long o = idx;
  v = epilogue(v, o, (int)(idx % N), w_scale, bias, res, act, res_bf16);
  if (out_bf16)
    store(static_cast<__nv_bfloat16*>(out) + o, v);
  else
    store(static_cast<float*>(out) + o, v);
}

template <bool kInt8, bool kVec>
int launch(const void* x, const void* w, const void* w_scale, const void* bias, const void* res,
           void* out, void* ws, int M, int N, int K, int splits, int kps, int act, int res_bf16,
           int out_bf16, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<kInt8>();
  auto kernel = mm_pu_mma_kernel<kInt8, kVec>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  float* part = splits > 1 ? static_cast<float*>(ws) : nullptr;
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(x), w, static_cast<const float*>(w_scale),
      static_cast<const float*>(bias), res, out, part, M, N, K, kps, act, res_bf16, out_bf16);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long mn = (long long)M * N;
  mm_pu_splitk_reduce<<<(unsigned)((mn + 255) / 256), 256, 0, stream>>>(
      part, splits, static_cast<const float*>(w_scale), static_cast<const float*>(bias), res,
      out, M, N, act, res_bf16, out_bf16);
  return (int)cudaGetLastError();
}

}  // namespace tc

template <typename TX, typename TW>
int launch(const void* x, const void* w, const void* w_scale, const void* bias,
           const void* res, void* out, int M, int N, int K, int act, int res_bf16,
           int out_bf16, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  mm_pu_kernel<TX, TW><<<grid, kThreads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w),
      static_cast<const float*>(w_scale), static_cast<const float*>(bias), res, out, M, N, K,
      act, res_bf16, out_bf16);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (M, K) row-major; w: (K, N) row-major; w_scale, bias: N f32 each or
// null; residual: (M, N) row-major or null; out: (M, N) row-major.  Types:
// 0 = f32, 1 = bf16, 2 = int8 (w only).  act: 0 none, 1 gelu (tanh), 2 silu,
// 3 relu, 4 relu^2.  Each entry returns 0 or a CUDA error code (negative
// for bad arguments); launches on `stream` and does not synchronise.
//
// mm_pu_forward: f32 x (CUDA cores); w f32, or int8 with a w_scale.
extern "C" int mm_pu_forward(const void* x, const void* w, const void* w_scale,
                             const void* bias, const void* residual, void* out, int M, int N,
                             int K, int x_dtype, int w_dtype, int res_dtype, int out_dtype,
                             int act, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || act < kNone || act > kRelu2) return -3;
  if ((res_dtype != 0 && res_dtype != 1) || (out_dtype != 0 && out_dtype != 1)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MM_ARGS x, w, w_scale, bias, residual, out, M, N, K, act, res_dtype, out_dtype, s
  if (w_dtype == 2 && w_scale == nullptr) return -1;
  if (x_dtype == 0 && w_dtype == 0) return launch<float, float>(MM_ARGS);
  if (x_dtype == 0 && w_dtype == 2) return launch<float, int8_t>(MM_ARGS);
#undef MM_ARGS
  return -1;
}

// mm_pu_forward_mma: bf16 x (tensor cores); w bf16, or int8 with a
// w_scale.  splits K-splits of k_per_split (a multiple of 64) each; with
// splits > 1, workspace holds splits * M * N f32.  vec: x and w rows and
// bases are 16-byte aligned (cp.async copies), else element copies.
extern "C" int mm_pu_forward_mma(const void* x, const void* w, const void* w_scale,
                                 const void* bias, const void* residual, void* out,
                                 void* workspace, int M, int N, int K, int w_dtype,
                                 int res_dtype, int out_dtype, int act, int splits,
                                 int k_per_split, int vec, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || act < kNone || act > kRelu2) return -3;
  if (splits < 1 || splits > 65535 || k_per_split <= 0 || k_per_split % tc::BK != 0 ||
      (long long)splits * k_per_split < K || (splits > 1 && workspace == nullptr))
    return -3;
  if ((res_dtype != 0 && res_dtype != 1) || (out_dtype != 0 && out_dtype != 1)) return -1;
  if (w_dtype == 2 && w_scale == nullptr) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MM_ARGS \
  x, w, w_scale, bias, residual, out, workspace, M, N, K, splits, k_per_split, act, res_dtype, \
      out_dtype, s
  if (w_dtype == 1) return vec ? tc::launch<false, true>(MM_ARGS) : tc::launch<false, false>(MM_ARGS);
  if (w_dtype == 2) return vec ? tc::launch<true, true>(MM_ARGS) : tc::launch<true, false>(MM_ARGS);
#undef MM_ARGS
  return -1;
}
