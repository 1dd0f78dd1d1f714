// RMSNorm backward: dx and d(scale) of the model's norm, for training.
//
// The gradient of the function src/repro/kernels/rmsnorm/kernel.py::
// _rmsnorm_kernel computes (the JAX package takes it by autodiff of
// repro.models.layers.rmsnorm; the forward kernel is csrc/rmsnorm.cu).
// Row by row, in f32, with s = x [+ r], inv = 1 / sqrt(mean(s^2) + eps)
// (the forward's), w = 1 + scale and g = dy w:
//     dx       = inv g - s inv^3 mean(g s)     (also d(residual))
//     d(scale) = sum over rows of dy s inv
// dx in x's type; d(scale) f32.
//
// Bound on an H100 SXM: bytes.  About 10 flops per element against x and
// dy read once and dx written once (6 bytes an element in bf16) at 3.35
// TB/s; d(scale)'s f32 partial rows add grid x d x 4 bytes (~1 MB at d
// 2048, under 1% of the rows' bytes).  One pass over the rows
// (bwd_vec_kernel, 16-byte rows; ops.backward_launch_plan's schedule):
//   * a group of GL lanes takes a row: GL = 8 or 16 when the row is at most
//     that many 16-byte vectors (d_head 128 bf16: 16 lanes, two rows a
//     warp, one vector a lane), 32 up to 8 vectors a lane (d 2048 bf16),
//     the whole CTA (256 lanes) for wider rows (d 4096 bf16: 2 vectors a
//     lane); a lane holds NV vectors of the row's s and dy in registers, R
//     rows at once (4 / NV, at least 1; 1 for CTA rows);
//   * dx: the group loads its rows' x and dy once, sums s^2 and g s within
//     the group (shuffles; CTA rows through shared memory) and writes dx
//     from the registers: x and dy are read from device memory once (a
//     residual, off every model path, is read again from L2 for dx);
//   * d(scale): each lane adds dy s inv into f32 accumulators for its own
//     columns, which stay the same for every row it visits (64 columns at
//     d 2048, 8 at d_head 128); a resident wave of CTAs strides over the
//     rows, so a CTA's accumulators cover many rows;
//   * at the end each CTA sums its groups' accumulators in shared memory in
//     group order and writes one f32 partial row (CTA, d); dscale_sum_kernel
//     sums the partial rows, 8 lanes a column over fixed residues of the CTA
//     index, then the 8 lanes in order.  No atomics: a rerun gives the same
//     bits.
// Rows that are not 16-byte aligned, or wider than 256 x 8 vectors (f32 d
// above 8192), take bwd_scalar_kernel: a CTA a row, one element a thread a
// step, two passes (the second re-reads the row from L1/L2), d(scale)
// accumulated in shared memory by the thread that owns each column.
// x is read in the forward's strided layout (rows (outer, inner) with an
// element stride each: qk-norm's q and k views of the fused projection);
// dy, the residual and dx are dense (dy arrives dense from autograd on
// every model path).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (repro_torch/kernels/_build.py).  Plain C entry
// point, bound with ctypes by repro_torch/kernels/rmsnorm/kernel.py.

#include "../../csrc/common.cuh"

namespace {

using namespace repro_torch;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kSumCols = 32;   // columns of a dscale_sum_kernel CTA
constexpr int kSumLanes = 8;   // partial rows it sums at once, one a lane
constexpr int kStaticSmem = 48 * 1024;  // shared memory without opting in

// Row r = o * inner + i of x starts at o * so + i * si elements.
struct Rows {
  long long n;
  int inner;
  long long so, si;
};

template <typename T>
__device__ __forceinline__ const T* row_start(const T* x, const Rows& rows, long long r) {
  if (rows.inner == 1) return x + r * rows.so;
  const long long o = r <= 0x7fffffff ? (long long)((unsigned)r / (unsigned)rows.inner)
                                      : r / rows.inner;  // 32-bit division where it fits
  return x + o * rows.so + (r - o * rows.inner) * rows.si;
}

// The sum of (a, b) over the CTA's 8 warps, in warp order (every thread
// gets it); `red` holds kWarps x 2 floats.  Two barriers.
__device__ __forceinline__ float2 cta_sum2(float a, float b, float* red) {
  a = warp_sum(a);
  b = warp_sum(b);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    red[2 * warp] = a;
    red[2 * warp + 1] = b;
  }
  __syncthreads();
  float2 t = make_float2(0.f, 0.f);
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    t.x += red[2 * w];
    t.y += red[2 * w + 1];
  }
  __syncthreads();  // red is free for the next row
  return t;
}

// 16-byte vectors.  GL lanes a row (8, 16, 32, or kThreads: the CTA), NV
// vectors of it a lane held in registers (s and dy), R rows a group at
// once: group g of warp w takes rows r0 + g + 32 / GL x k (r0 the warp's
// first row; the CTA's for CTA rows) and strides over the rows by the
// whole grid's.  Each lane's d(scale) columns are its vectors' columns.
template <typename T, int GL, int NV, int R>
__global__ void __launch_bounds__(kThreads, NV * R >= 8 ? 1 : 2)
bwd_vec_kernel(const T* __restrict__ x, const float* __restrict__ scale,
               const T* __restrict__ res, const T* __restrict__ dy, T* __restrict__ dx,
               float* __restrict__ partial, Rows rows, int d, float eps) {
  constexpr int VEC = Vec<T>::n;
  constexpr bool kCta = GL == kThreads;
  constexpr int GPW = kCta ? 1 : 32 / GL;        // groups a warp
  constexpr int GPC = kCta ? 1 : kWarps * GPW;   // groups a CTA
  static_assert(GL < 32 ? NV == 1 : true, "a sub-warp group holds one vector a lane");
  extern __shared__ float acc_s[];  // d floats: the groups' sums, in group order
  __shared__ float red[2 * kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gl = kCta ? tid : lane & (GL - 1);
  const int grp = kCta ? 0 : lane / GL;
  const int nvec = d / VEC;

  // 1 + scale of a sub-warp lane's one vector, in registers; wider groups
  // read it through L1 (d floats, the same for every row)
  float w1[GL < 32 ? VEC : 1];
  if constexpr (GL < 32) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) w1[e] = gl < nvec ? 1.f + scale[gl * VEC + e] : 0.f;
  }
  auto one_plus = [&](int j, float* w) {
    if constexpr (GL < 32) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) w[e] = w1[e];
    } else {
#pragma unroll
      for (int q = 0; q < VEC / 4; ++q) {
        const float4 s4 = __ldg(reinterpret_cast<const float4*>(scale + j * VEC) + q);
        w[4 * q] = 1.f + s4.x;
        w[4 * q + 1] = 1.f + s4.y;
        w[4 * q + 2] = 1.f + s4.z;
        w[4 * q + 3] = 1.f + s4.w;
      }
    }
  };
  // s of vector j from its raw x (plus the residual's vector j)
  auto s_of = [&](const uint4& raw, long long r, int j, float* s) {
    Vec<T>::unpack(raw, s);
    if (res != nullptr) {
      float g[VEC];
      Vec<T>::unpack(*reinterpret_cast<const uint4*>(res + r * d + j * VEC), g);
#pragma unroll
      for (int e = 0; e < VEC; ++e) s[e] += g[e];
    }
  };

  float acc[NV][VEC];
#pragma unroll
  for (int t = 0; t < NV; ++t)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[t][e] = 0.f;

  const long long stride = (long long)gridDim.x * GPC * R;
  long long r0 = kCta ? (long long)blockIdx.x * R
                      : ((long long)blockIdx.x * kWarps + warp) * GPW * R;
  for (; r0 < rows.n; r0 += stride) {  // warp-uniform (CTA-uniform for CTA rows)
    uint4 xv[R][NV], gv[R][NV];
#pragma unroll
    for (int k = 0; k < R; ++k) {  // every load of the R rows before any use
      const long long r = r0 + grp + GPW * k;
      if (r < rows.n) {
        const T* xr = row_start(x, rows, r);
        const T* gr = dy + r * d;
#pragma unroll
        for (int t = 0; t < NV; ++t) {
          const int j = gl + GL * t;
          if (j < nvec) {
            xv[k][t] = *reinterpret_cast<const uint4*>(xr + j * VEC);
            gv[k][t] = *reinterpret_cast<const uint4*>(gr + j * VEC);
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const long long r = r0 + grp + GPW * k;
      const bool live = r < rows.n;
      float ss = 0.f, gs = 0.f;
      if (live) {
#pragma unroll
        for (int t = 0; t < NV; ++t) {
          const int j = gl + GL * t;
          if (j < nvec) {
            float s[VEC], g[VEC], w[VEC];
            s_of(xv[k][t], r, j, s);
            Vec<T>::unpack(gv[k][t], g);
            one_plus(j, w);
#pragma unroll
            for (int e = 0; e < VEC; ++e) {
              ss += s[e] * s[e];
              gs += g[e] * w[e] * s[e];
            }
          }
        }
      }
      if constexpr (kCta) {
        const float2 t = cta_sum2(ss, gs, red);
        ss = t.x;
        gs = t.y;
      } else {
        ss = warp_sum<GL>(ss);
        gs = warp_sum<GL>(gs);
      }
      if (!live) continue;
      const float inv = 1.f / sqrtf(ss / (float)d + eps);
      const float c = inv * inv * inv * gs / (float)d;
      T* out = dx + r * d;
#pragma unroll
      for (int t = 0; t < NV; ++t) {
        const int j = gl + GL * t;
        if (j < nvec) {
          float s[VEC], g[VEC], w[VEC], o[VEC];
          s_of(xv[k][t], r, j, s);
          Vec<T>::unpack(gv[k][t], g);
          one_plus(j, w);
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            o[e] = inv * g[e] * w[e] - s[e] * c;
            acc[t][e] += g[e] * s[e] * inv;
          }
          *reinterpret_cast<uint4*>(out + j * VEC) = Vec<T>::pack(o);
        }
      }
    }
  }

  // The CTA's partial row: its groups' accumulators summed in group order.
  float* prow = partial + (long long)blockIdx.x * d;
  if constexpr (kCta) {
#pragma unroll
    for (int t = 0; t < NV; ++t) {
      const int j = gl + GL * t;
      if (j < nvec)
#pragma unroll
        for (int e = 0; e < VEC; ++e) prow[j * VEC + e] = acc[t][e];
    }
  } else {
    const int me = warp * GPW + grp;
    for (int g = 0; g < GPC; ++g) {
      if (me == g) {
#pragma unroll
        for (int t = 0; t < NV; ++t) {
          const int j = gl + GL * t;
          if (j < nvec)
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              acc_s[j * VEC + e] = (g == 0 ? 0.f : acc_s[j * VEC + e]) + acc[t][e];
        }
      }
      __syncthreads();
    }
    for (int c = tid; c < d; c += kThreads) prow[c] = acc_s[c];
  }
}

// A CTA a row, one element a thread a step: rows of any alignment and
// width.  Pass 1 sums s^2 and g s, pass 2 (re-reading the row) writes dx
// and adds dy s inv into the thread's own columns of acc_s.
template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_scalar_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                  const T* __restrict__ res, const T* __restrict__ dy, T* __restrict__ dx,
                  float* __restrict__ partial, Rows rows, int d, float eps) {
  extern __shared__ float acc_s[];  // d floats; column c is thread c % kThreads's
  __shared__ float red[2 * kWarps];
  const int tid = threadIdx.x;
  for (int c = tid; c < d; c += kThreads) acc_s[c] = 0.f;
  for (long long r = blockIdx.x; r < rows.n; r += gridDim.x) {
    const T* xr = row_start(x, rows, r);
    const T* rr = res != nullptr ? res + r * d : nullptr;
    const T* gr = dy + r * d;
    float ss = 0.f, gs = 0.f;
    for (int j = tid; j < d; j += kThreads) {
      const float s = to_f32(xr[j]) + (rr != nullptr ? to_f32(rr[j]) : 0.f);
      ss += s * s;
      gs += to_f32(gr[j]) * (1.f + scale[j]) * s;
    }
    const float2 t = cta_sum2(ss, gs, red);
    const float inv = 1.f / sqrtf(t.x / (float)d + eps);
    const float c = inv * inv * inv * t.y / (float)d;
    T* out = dx + r * d;
    for (int j = tid; j < d; j += kThreads) {
      const float s = to_f32(xr[j]) + (rr != nullptr ? to_f32(rr[j]) : 0.f);
      const float g = to_f32(gr[j]);
      store(out + j, inv * g * (1.f + scale[j]) - s * c);
      acc_s[j] += g * s * inv;
    }
  }
  float* prow = partial + (long long)blockIdx.x * d;
  for (int c = tid; c < d; c += kThreads) prow[c] = acc_s[c];
}

// d(scale)[c] = the `parts` partial rows summed: lane l of a column adds
// rows l, l + 8, ... in order, then the 8 lanes are added in order.
__global__ void __launch_bounds__(kSumCols * kSumLanes)
dscale_sum_kernel(const float* __restrict__ partial, float* __restrict__ dscale, int d,
                  int parts) {
  __shared__ float sum[kSumLanes][kSumCols];
  const int tx = threadIdx.x % kSumCols, ty = threadIdx.x / kSumCols;
  const int c = blockIdx.x * kSumCols + tx;
  float t = 0.f;
  if (c < d)
    for (int p = ty; p < parts; p += kSumLanes) t += partial[(long long)p * d + c];
  sum[ty][tx] = t;
  __syncthreads();
  if (ty == 0 && c < d) {
    float total = 0.f;
#pragma unroll
    for (int k = 0; k < kSumLanes; ++k) total += sum[k][tx];
    dscale[c] = total;
  }
}

// Dynamic shared memory past 48 KB less the kernels' static arrays needs
// opting in (d 12288 f32: 48 KB of column sums).
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  return smem + 1024 > kStaticSmem
             ? cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)smem)
             : cudaSuccess;
}

template <typename T, int GL, int NV, int R>
int launch_vec(const T* x, const float* scale, const T* res, const T* dy, T* dx, float* partial,
               Rows rows, int d, float eps, int grid, cudaStream_t stream) {
  auto kernel = bwd_vec_kernel<T, GL, NV, R>;
  const size_t smem = GL == kThreads ? 0 : sizeof(float) * d;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, smem, stream>>>(x, scale, res, dy, dx, partial, rows, d, eps);
  return (int)cudaGetLastError();
}

// R rows a group at once: 4 / NV, at least 1; 1 for CTA rows
// (ops.backward_launch_plan's).
template <int GL, int NV>
constexpr int kRows = GL == kThreads || NV >= 4 ? 1 : 4 / NV;

template <typename T>
int launch(const void* x, const void* scale, const void* res, const void* dy, void* dx,
           float* partial, float* dscale, Rows rows, int d, float eps, int vec, int group,
           int nv, int r, int grid, cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const float* sp = static_cast<const float*>(scale);
  const T* rp = static_cast<const T*>(res);
  const T* gp = static_cast<const T*>(dy);
  T* op = static_cast<T*>(dx);
  int rc = -4;
  if (!vec) {
    auto kernel = bwd_scalar_kernel<T>;
    const size_t smem = sizeof(float) * d;
    const cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, kThreads, smem, stream>>>(xp, sp, rp, gp, op, partial, rows, d, eps);
    rc = (int)cudaGetLastError();
  } else {
    // every lane's columns together cover the row: group x nv >= its vectors
    const long long nvec = d / Vec<T>::n;
    if ((long long)group * nv < nvec || (group < 32 && nv != 1)) return -4;
#define RMS_BWD(GL, NV)                                                                      \
  rc = r == kRows<GL, NV> ? launch_vec<T, GL, NV, kRows<GL, NV>>(xp, sp, rp, gp, op, partial, \
                                                                rows, d, eps, grid, stream)  \
                          : -4
    if (group == 8 && nv == 1) RMS_BWD(8, 1);
    if (group == 16 && nv == 1) RMS_BWD(16, 1);
    if (group == 32) {
      switch (nv) {
        case 1: RMS_BWD(32, 1); break;
        case 2: RMS_BWD(32, 2); break;
        case 4: RMS_BWD(32, 4); break;
        case 8: RMS_BWD(32, 8); break;
      }
    }
    if (group == kThreads) {
      switch (nv) {
        case 1: RMS_BWD(kThreads, 1); break;
        case 2: RMS_BWD(kThreads, 2); break;
        case 4: RMS_BWD(kThreads, 4); break;
        case 8: RMS_BWD(kThreads, 8); break;
      }
    }
#undef RMS_BWD
  }
  if (rc != 0) return rc;
  dscale_sum_kernel<<<(d + kSumCols - 1) / kSumCols, kSumCols * kSumLanes, 0, stream>>>(
      partial, dscale, d, grid);
  return (int)cudaGetLastError();
}

}  // namespace

// x: rows (outer, inner) of d elements with unit stride, row (o, i) at
// o * so + i * si elements from x; residual (may be null), dy and dx: dense
// (outer * inner, d); scale: d f32; partial: (grid, d) f32 scratch (every
// element is written); dscale: d f32 output.  dtype 0 = f32, 1 = bf16 for
// x, residual, dy and dx.  vec != 0 promises 16-byte aligned rows (x,
// residual, dy, dx, scale) and d a multiple of 16 bytes.  The launch plan
// (ops.backward_launch_plan): vec rows take `group` lanes a row (8, 16, 32
// or 256: the CTA), `nv` vectors a lane (1 below 32 lanes; 1, 2, 4 or 8)
// and `rows_a_group` rows a group at once; scalar rows a CTA a row; both
// over `grid` CTAs of 8 warps that stride over the rows.  Two launches (the
// pass over the rows, the sum of the partial rows).  Returns 0 or a CUDA
// error code (negative for bad arguments); launches on `stream` and does
// not synchronise.
extern "C" int rmsnorm_backward(const void* x, const void* scale, const void* residual,
                                const void* dy, void* dx, float* partial, float* dscale,
                                long long outer, int inner, int d, long long so, long long si,
                                float eps, int vec, int dtype, int group, int nv,
                                int rows_a_group, int grid, void* stream) {
  if (outer <= 0 || inner <= 0 || d <= 0 || grid <= 0) return -3;
  const Rows rows{outer * inner, inner, so, si};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, scale, residual, dy, dx, partial, dscale, rows, d, eps, vec, group,
                         nv, rows_a_group, grid, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, scale, residual, dy, dx, partial, dscale, rows, d, eps, vec,
                                 group, nv, rows_a_group, grid, s);
  return -1;
}
