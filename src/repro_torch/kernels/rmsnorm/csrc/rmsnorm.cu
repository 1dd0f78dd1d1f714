// RMSNorm over the last axis, optionally of x + residual: the model's norm
// on both serving paths (every layer's two norms, qk-norm, the final norm).
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm/kernel.py::
// _rmsnorm_kernel (Pallas, launched by rmsnorm_call).  Same function, row
// by row, in f32:
//     s = x [+ r]
//     y = s * rsqrt(mean(s^2) + eps) * (1 + scale)
// cast to x's type.  The sum s is not returned (as in the TPU kernel).
//
// Bound on an H100 SXM: bytes.  About 4 flops per element against 4 (bf16)
// or 8 (f32) bytes moved: x read once and y written once (r read once) at
// 3.35 TB/s.  Design (16-byte rows, rmsnorm_vec_kernel):
//   * a group of GL lanes takes a row: GL = 8 or 16 when the row is at
//     most 8 or 16 vectors of 16 bytes (d_head 128 bf16 is 16: two rows a
//     warp, one vector a lane, no idle lane), 32 otherwise.  The sum of
//     squares is a per-lane f32 sum reduced by shuffles inside the group;
//     no barrier between rows;
//   * a grid-stride loop over the rows; ops.launch_plan sizes the grid:
//     for sub-warp rows one wave of resident CTAs (the SM count x 2), so
//     each group walks many rows and loads its vector of `1 + scale` into
//     registers once (a lane always touches the same vector of every row);
//     for full-warp rows one pass (measured faster on the H100), each CTA
//     staging `1 + scale` once in shared memory for its 8 warps' rows,
//     instead of once per element per row;
//   * rows in flight: a group takes R rows at once (4 / NV, at least 1);
//     a sub-warp group issues its next R rows' 16-byte loads before the
//     current ones are reduced, scaled and stored;
//   * a lane keeps NV vectors of a row in registers (a whole row up to
//     d = 4096 bf16 / 2048 f32), so such a row is read from device memory
//     once; a wider row re-reads the rest in the second pass from L1/L2;
//   * rows are indexed (outer, inner) with an element stride each, so the
//     qk-norm input, a (B, S, H, D) view of the fused QKV projection whose
//     tokens sit (H + 2 KV) D elements apart, is read in place with no
//     copy.  The output (and the residual) is dense: row r at r * d.
// Rows that are not 16-byte aligned (e.g. d = 33 f32, rows 132 bytes apart)
// take rmsnorm_scalar_kernel: one warp a row, one element a lane a step.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (repro_torch/kernels/_build.py).  Plain C entry
// point, bound with ctypes by repro_torch/kernels/rmsnorm/kernel.py.

#include "../../csrc/common.cuh"

namespace {

using namespace repro_torch;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kStaticSmem = 48 * 1024;  // dynamic shared memory without opting in

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

// Vector j of the row as floats, plus the residual's vector j.
template <typename T>
__device__ __forceinline__ void widen(const uint4& raw, const T* rr, int j, float* f) {
  constexpr int VEC = Vec<T>::n;
  Vec<T>::unpack(raw, f);
  if (rr != nullptr) {
    float g[VEC];
    Vec<T>::unpack(*reinterpret_cast<const uint4*>(rr + j * VEC), g);
#pragma unroll
    for (int e = 0; e < VEC; ++e) f[e] += g[e];
  }
}

// f * inv * (1 + scale), with the VEC values of 1 + scale as VEC / 4
// float4 at one_plus[0], one_plus[qs], ..., stored as vector j of yr.
template <typename T>
__device__ __forceinline__ void finish(float* f, const float4* one_plus, int qs, int j,
                                       float inv, T* yr) {
  constexpr int VEC = Vec<T>::n;
#pragma unroll
  for (int q = 0; q < VEC / 4; ++q) {
    const float4 s = one_plus[q * qs];
    f[4 * q] = f[4 * q] * inv * s.x;
    f[4 * q + 1] = f[4 * q + 1] * inv * s.y;
    f[4 * q + 2] = f[4 * q + 2] * inv * s.z;
    f[4 * q + 3] = f[4 * q + 3] * inv * s.w;
  }
  *reinterpret_cast<uint4*>(yr + j * VEC) = Vec<T>::pack(f);
}

// 16-byte vectors.  GL lanes a row (8, 16 or 32), NV vectors of it a lane
// held in registers, R rows a group at once: a warp takes 32 / GL x R rows
// an iteration (group g row r0 + g + 32 / GL x k, so the warp's k-th load
// covers adjacent rows) and strides over the rows by the whole grid's.
// 1 + scale sits in registers (GL < 32: one vector a lane) or in dynamic
// shared memory (GL == 32: d floats).  NV x R vectors a lane are in flight.
template <typename T, int GL, int NV, int R>
__global__ void __launch_bounds__(kThreads, NV * R >= 16 ? 1 : 2)
rmsnorm_vec_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                   const T* __restrict__ res, T* __restrict__ out, Rows rows, int d, float eps) {
  constexpr int VEC = Vec<T>::n;
  constexpr int GPW = 32 / GL;  // groups a warp
  static_assert(GL == 32 || NV == 1, "a sub-warp group holds one vector a lane");
  extern __shared__ float4 smem4[];
  const int lane = threadIdx.x & 31;
  const int gl = lane & (GL - 1), grp = lane / GL;
  const int nvec = d / VEC;
  const bool tail = nvec > GL * NV;  // the rest of a wider row is re-read
  // Sub-warp groups stride over many rows and keep their next rows in
  // flight; full-warp rows take one pass (ops.launch_plan), with nothing
  // ahead to load.
  constexpr bool kAhead = GL < 32;

  float4 one_plus_r[GL < 32 ? VEC / 4 : 1];
  if constexpr (GL < 32) {
    if (gl < nvec) {
#pragma unroll
      for (int q = 0; q < VEC / 4; ++q) {
        const float4 s = reinterpret_cast<const float4*>(scale + gl * VEC)[q];
        one_plus_r[q] = make_float4(1.f + s.x, 1.f + s.y, 1.f + s.z, 1.f + s.w);
      }
    }
  }
  // Shared memory holds quarter q of vector j's 1 + scale (4 floats) at
  // float4 q * nvec + j, so the lanes of a warp read adjacent 16 bytes.
  float4* const one_plus_s = smem4;
  auto one_plus = [&](int j) -> const float4* {
    if constexpr (GL < 32) {
      return one_plus_r;
    } else {
      return one_plus_s + j;
    }
  };
  const int qs = GL < 32 ? 1 : nvec;  // float4 between the quarters of a vector

  auto load = [&](uint4 (*v)[NV], long long r0) {  // the R rows of an iteration
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const long long r = r0 + grp + GPW * k;
      if (r < rows.n) {
        const T* xr = row_start(x, rows, r);
#pragma unroll
        for (int t = 0; t < NV; ++t) {
          const int j = gl + GL * t;
          if (j < nvec) v[k][t] = *reinterpret_cast<const uint4*>(xr + j * VEC);
        }
      }
    }
  };

  const long long stride = (long long)gridDim.x * kWarps * GPW * R;
  long long r0 = ((long long)blockIdx.x * kWarps + (threadIdx.x >> 5)) * GPW * R;
  uint4 cur[R][NV];
  if constexpr (kAhead) load(cur, r0);
  if constexpr (GL == 32) {
    for (int i = threadIdx.x; i < d / 4; i += kThreads) {
      const float4 s = reinterpret_cast<const float4*>(scale)[i];
      smem4[(i % (VEC / 4)) * nvec + i / (VEC / 4)] =
          make_float4(1.f + s.x, 1.f + s.y, 1.f + s.z, 1.f + s.w);
    }
    __syncthreads();
  }
  for (; r0 < rows.n; r0 += stride) {  // warp-uniform: every lane shuffles
    uint4 nxt[R][NV];
    if constexpr (kAhead) {
      if (r0 + stride < rows.n) load(nxt, r0 + stride);  // the next rows are in flight
    } else {
      load(cur, r0);
    }
    float ss[R];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const long long r = r0 + grp + GPW * k;
      ss[k] = 0.f;
      if (r < rows.n) {
        const T* rr = res != nullptr ? res + r * d : nullptr;
#pragma unroll
        for (int t = 0; t < NV; ++t) {
          const int j = gl + GL * t;
          if (j < nvec) {
            float f[VEC];
            widen(cur[k][t], rr, j, f);
#pragma unroll
            for (int e = 0; e < VEC; ++e) ss[k] += f[e] * f[e];
          }
        }
        if (tail) {
          const T* xr = row_start(x, rows, r);
          for (int j = gl + GL * NV; j < nvec; j += GL) {
            float f[VEC];
            widen(*reinterpret_cast<const uint4*>(xr + j * VEC), rr, j, f);
#pragma unroll
            for (int e = 0; e < VEC; ++e) ss[k] += f[e] * f[e];
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const long long r = r0 + grp + GPW * k;
      const float inv = 1.f / sqrtf(warp_sum<GL>(ss[k]) / (float)d + eps);
      if (r < rows.n) {
        const T* rr = res != nullptr ? res + r * d : nullptr;
        T* yr = out + r * d;
#pragma unroll
        for (int t = 0; t < NV; ++t) {
          const int j = gl + GL * t;
          if (j < nvec) {
            float f[VEC];
            widen(cur[k][t], rr, j, f);
            finish(f, one_plus(j), qs, j, inv, yr);
          }
        }
        if (tail) {
          const T* xr = row_start(x, rows, r);
          for (int j = gl + GL * NV; j < nvec; j += GL) {
            float f[VEC];
            widen(*reinterpret_cast<const uint4*>(xr + j * VEC), rr, j, f);
            finish(f, one_plus(j), qs, j, inv, yr);
          }
        }
      }
    }
    if constexpr (kAhead) {
#pragma unroll
      for (int k = 0; k < R; ++k)
#pragma unroll
        for (int t = 0; t < NV; ++t) cur[k][t] = nxt[k][t];
    }
  }
}

// One element per lane per step: rows of any alignment and width.
template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_scalar_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                      const T* __restrict__ res, T* __restrict__ out, Rows rows, int d,
                      float eps) {
  const int lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= rows.n) return;
  const T* xr = row_start(x, rows, r);
  const T* rr = res != nullptr ? res + r * d : nullptr;
  T* yr = out + r * d;
  float ss = 0.f;
  for (int j = lane; j < d; j += 32) {
    const float f = to_f32(xr[j]) + (rr != nullptr ? to_f32(rr[j]) : 0.f);
    ss += f * f;
  }
  const float inv = 1.f / sqrtf(warp_sum(ss) / (float)d + eps);
  for (int j = lane; j < d; j += 32) {
    const float f = to_f32(xr[j]) + (rr != nullptr ? to_f32(rr[j]) : 0.f);
    store(yr + j, f * inv * (1.f + scale[j]));
  }
}

template <typename T, int GL, int NV, int R>
int launch_vec(const T* x, const float* scale, const T* res, T* out, Rows rows, int d,
               float eps, int grid, cudaStream_t stream) {
  auto kernel = rmsnorm_vec_kernel<T, GL, NV, R>;
  const size_t smem = GL == 32 ? sizeof(float) * d : 0;
  if (smem > kStaticSmem) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<grid, kThreads, smem, stream>>>(x, scale, res, out, rows, d, eps);
  return (int)cudaGetLastError();
}

// R rows a group at once: 4 / NV, at least 1 (ops.launch_plan's).
template <int NV>
constexpr int kRows = NV >= 4 ? 1 : 4 / NV;

template <typename T>
int launch(const void* x, const void* scale, const void* res, void* out, Rows rows, int d,
           float eps, int vec, int group, int nv, int r, int grid, cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const float* sp = static_cast<const float*>(scale);
  const T* rp = static_cast<const T*>(res);
  T* op = static_cast<T*>(out);
  if (!vec) {
    rmsnorm_scalar_kernel<T><<<grid, kThreads, 0, stream>>>(xp, sp, rp, op, rows, d, eps);
    return (int)cudaGetLastError();
  }
  // A sub-warp group holds its whole row: one vector a lane.
  const int nvec = d / Vec<T>::n;
  if (group < 32 && (nv != 1 || nvec > group)) return -4;
#define RMS_VEC(GL, NV)                                                                     \
  return r == kRows<NV> ? launch_vec<T, GL, NV, kRows<NV>>(xp, sp, rp, op, rows, d, eps, grid, \
                                                          stream)                           \
                        : -4
  if (group == 8) RMS_VEC(8, 1);
  if (group == 16) RMS_VEC(16, 1);
  if (group == 32) {
    switch (nv) {
      case 1: RMS_VEC(32, 1);
      case 2: RMS_VEC(32, 2);
      case 4: RMS_VEC(32, 4);
      case 8: RMS_VEC(32, 8);
      case 16: RMS_VEC(32, 16);
    }
  }
#undef RMS_VEC
  return -4;
}

}  // namespace

// x: rows (outer, inner) of d elements with unit stride, row (o, i) at
// o * so + i * si elements from x; residual (may be null) and out: dense
// (outer * inner, d); scale: d f32.  dtype 0 = f32, 1 = bf16 for x,
// residual and out.  vec != 0 promises 16-byte aligned rows (x, residual,
// out, scale) and d a multiple of 16 bytes.  The launch plan
// (ops.launch_plan): vec rows take `group` lanes (8, 16 or 32) a row,
// `nv` vectors a lane in registers (1 below 32 lanes; 1, 2, 4, 8 or 16)
// and `rows_a_group` rows a group at once (4 / nv, at least 1), over
// `grid` CTAs of 8 warps that stride over the rows; scalar rows take a warp
// a row, `grid` covering them all.  Returns 0 or a CUDA error code
// (negative for bad arguments); launches on `stream` and does not
// synchronise.
extern "C" int rmsnorm_forward(const void* x, const void* scale, const void* residual,
                               void* out, long long outer, int inner, int d, long long so,
                               long long si, float eps, int vec, int dtype, int group, int nv,
                               int rows_a_group, int grid, void* stream) {
  if (outer <= 0 || inner <= 0 || d <= 0 || grid <= 0) return -3;
  const Rows rows{outer * inner, inner, so, si};
  if (!vec && (long long)grid * kWarps < rows.n) return -3;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, scale, residual, out, rows, d, eps, vec, group, nv, rows_a_group,
                         grid, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, scale, residual, out, rows, d, eps, vec, group, nv,
                                 rows_a_group, grid, s);
  return -1;
}
