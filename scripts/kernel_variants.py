"""Time variants of the port's CUDA kernels on one CUDA card, against the
committed sources, in one process.

    python3 scripts/kernel_variants.py [flash] [flash_bwd] [mm_pu] [paged] [paged_int8]
        [rmsnorm] [rmsnorm_bwd] [wkv]

(no argument: all eight).  Each variant is the committed source with a few
lines replaced (``VARIANTS`` below: other tile constants, and diagnostics
that leave a part out, whose results may be wrong by design), or the
committed library launched with other runtime arguments (``RUNS``: the
paged kernel's key split, the norm's launch plan).  All sources are built
in parallel (one ``nvcc`` each, under ``build/kernel_variants/``), bound
with ``ctypes`` and launched through the wrappers' own ``launch`` on the
main shapes: flash at the qwen3-1.7b prefill (B 8, S 2048, H 16, KH 8,
D 128, bf16, causal) and recurrentgemma-9b's local layers (B 8, S 2048, H
16, KH 1, D 256, window 2048); the flash backward's bf16 entry at the
qwen3-1.7b and paligemma-3b training shapes (B 8, S 2048, causal; H 16,
KH 8, D 128 and H 8, KH 1, D 256) and recurrentgemma-9b's (B 2, S 4096, H
16, KH 1, D 256, window 2048), with a profiler split of its three
kernels for each variant; MM PU at the int8 FFN stage's T=2048 ``w1`` (2048 x
2048 @ 2048 x 6144, silu) and T=256 ``w2`` (256 x 6144 @ 6144 x 2048)
products, int8 and bf16 w; paged attention at ``chip_smoke.py`` phase 6's
decode and mixed shapes (256 slots x 256-row slab, bf16 pages), with the
CUDA-core entry (``paged_attention_forward``) and, as a diagnostic, its grid
cut to row block 0 (the gap is what its dead CTAs cost); bf16 q with int8
pages at qwen3-moe-30b-a3b's plan (128 slots x 256 rows, G 8; phase 16's
decode and mixed shapes, phase 20's verify rows at q_len 5): the
tensor-core entry with ring depth 2 and 3, widened in shared memory or
after ldmatrix, against the CUDA-core entry (the earlier route), and the
committed entry's three kernels' device times; the RMSNorm backward at
qwen3-1.7b's training rows (the norm rows and the q / k views): the
resident wave against one pass, rows a group halved and doubled (each with
its two kernels' device times), and ``F.rms_norm``'s autograd backward;
RMSNorm at the
continuous slab (65,536 x 2048 bf16), the prefill rows (16,384 x 2048) and
the slab's q view (65,536 x 16 x 128, token stride 4096); WKV at the
rwkv6-1.6b prefill (B 8, S 2048, H 32, D 64): the tensor-core entry on bf16
r/k/v at chunk 16/32/64, diagnostics that leave one of its phases out, and
the CUDA-core entry (``wkv_forward``) on the same values in f32 with its own
diagnostics (the per-element weights, the outputs or the state carry left
out, fast ``__expf``), which attribute its time.  Each variant is
timed twice, the list in order and then reversed (A..Z..A), so that the
order of the runs favours none.  Prints the card's name and power limit,
each variant's registers and spills, and per shape and variant: whether it
matches the plain version within one bf16 step, and its two times.
"""
from __future__ import annotations

import ctypes
import hashlib
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

MM_TILE = "constexpr int BM = 128, BN = 128, BK = 64;"
MM_STAGES = "constexpr int kStages = 3;"
MM_WARPS = "constexpr int kWarpsM = 2, kWarpsN = 4;"
FLASH_STAGES = "constexpr int kStages = 2;          // K/V ring depth"
FLASH_KEYS = "constexpr int kKeys = 64;           // keys per tile"
FLASH_BOUNDS = "__launch_bounds__(kThreads, 1)\nflash_attention_mma_kernel("
FLASH_D256_KEYS = "constexpr int kTileKeys = D > 128 ? kKeys / 2 : kKeys;"
FLASH_F32_LOADS = "constexpr int NVB = NVT > 8 ? 4 : NVT;"
PAGED_STAGES = "constexpr int kStages = 2;          // K/V ring depth"
PAGED_GRID = "dim3 grid((W + rows_per_cta - 1) / rows_per_cta, KH, B);"
RMS_AHEAD = "constexpr bool kAhead = GL < 32;"
BWD_ROWS = "constexpr int kRows = GL == kThreads || NV >= 4 ? 1 : 4 / NV;"
RMS_ROWS = "constexpr int kRows = NV >= 4 ? 1 : 4 / NV;"
RMS_LOAD = "if (j < nvec) v[k][t] = *reinterpret_cast<const uint4*>(xr + j * VEC);"
RMS_STORE = "  *reinterpret_cast<uint4*>(yr + j * VEC) = Vec<T>::pack(f);"
WKV_SCAN = "    {\n      float lw[TOK], tot = 0.f;"
BWD_QROWS = "template <int D>\nconstexpr int kQRows = 32;"
BWD_DQ_KEYS = "template <int D>\nconstexpr int kTileKeys = D > 128 ? 16 : 64;"
BWD_SHARE = "constexpr bool kShare = D > DC;"
BWD_GRID = ("  const int kh = blockIdx.x % KH, b = blockIdx.x / KH;\n"
            "  const int j0 = blockIdx.y * KEYS;")
BWD_LAUNCH = "dkdv<<<dim3(B * KH, (Sk + keys - 1) / keys),"
WKV_FACTORS = "    for (int i0 = 0; i0 < C * G; i0 += kT) {\n      const int i = i0 + tid;\n      if (i >= C"
WKV_TC = "      float c[3][4] = {};\n"
WKV_HALVES = "      if (it >= kOff + NT) {\n"
WKV_OUT_S = "    for (int j = 0; j < KS; ++j) {\n      unsigned sh[4], sl[4];"
WKV_OUT_A = "        if (j > x0 + x) continue;"
WKV_STATE = ("        mma_tf32(St[j], vf[x], KfL[i0], KfL[i0 + 4 * PK]);\n"
             "        mma_tf32(St[j], vf[x], KfH[i0], KfH[i0 + 4 * PK]);")
# The clock probe: per-phase clock64() sums of thread 0 (phases end at a
# barrier, so they include the wait for the slowest warp; phase 4's parts
# are warp 0's own), written over the first PROBES floats of each CTA's
# final state.
PROBE = "{{ const long long c_ = clock64(); ph_[{}] += c_ - tc_; tc_ = c_; }}\n"
PROBES = ("1: cp.async issue", "1: log2 / cumsum", "1: w loads issue", "1: wait for r/k/v",
          "1: barrier", "2: decayed operands", "3: weights (tensor cores, halves) + barrier",
          "4: v fragments", "4a: S^T rdec^T", "4b: v^T A^T",
          "4: output stores", "4d: state update", "end-of-chunk barrier")
WKV_PROBE = [
    ("  const int N = (S + C - 1) / C;\n",
     "  const int N = (S + C - 1) / C;\n  long long ph_[13] = {}, tc_ = clock64();\n"),
    ("    cp_async_commit();\n    const unsigned char* st = smem_mma",
     "    cp_async_commit();\n" + PROBE.format(0) + "    const unsigned char* st = smem_mma"),
    ("    if (n + 1 < N) load_w(n + 1);\n",
     PROBE.format(1) + "    if (n + 1 < N) load_w(n + 1);\n" + PROBE.format(2)),
    ("    cp_async_wait<1>();  // this chunk's r, k, v have landed (for this thread) ...\n",
     "    cp_async_wait<1>();\n" + PROBE.format(3)),
    ("    __syncthreads();     // ... and for every thread; L and Lq are written\n",
     "    __syncthreads();\n" + PROBE.format(4)),
    ("      if (lane < 8) Bonus[d0 / 32 * C + t] = bonus;\n    }\n    __syncthreads();\n",
     "      if (lane < 8) Bonus[d0 / 32 * C + t] = bonus;\n    }\n    __syncthreads();\n"
     + PROBE.format(5)),
    ("        a[1] = c[0][1] + c[1][1] + c[2][1];\n      }\n    }\n    __syncthreads();\n",
     "        a[1] = c[0][1] + c[1][1] + c[2][1];\n      }\n    }\n    __syncthreads();\n"
     + PROBE.format(6)),
    ("    // o^T for this warp's token blocks", PROBE.format(7) + "    // o^T for this warp's token blocks"),
    ("    // ... + v^T A^T", PROBE.format(8) + "    // ... + v^T A^T"),
    ("    // the live tokens' outputs", PROBE.format(9) + "    // the live tokens' outputs"),
    ("    // S^T = S^T diag(2^Lc)", PROBE.format(10) + "    // S^T = S^T diag(2^Lc)"),
    ("    __syncthreads();  // the stage and the chunk's arrays are free\n",
     PROBE.format(11) + "    __syncthreads();\n" + PROBE.format(12)),
    ("      s0[D + 8] = St[j][3];\n    }\n  }\n}",
     "      s0[D + 8] = St[j][3];\n    }\n  }\n  __syncthreads();\n"
     "  if ((tid == 0 || tid == 128) && state_out)\n"
     "    for (int i = 0; i < 13; ++i) state_out[sbase + tid / 128 * 16 + i] = (float)ph_[i];\n}"),
]
WKV_STORE = "        if (t < nt) {\n          float* op = out"
WKV_WLOAD = "      wr[i] = t < nt ? w[base + (int64_t)(t0 + t) * sD + dch] : 1.f;  // log w = 0 past S"
WKV_COPY = "  auto load = [&](int chunk, int stage) {\n"
OLD_INTRA = "      if (s < t) {"
OLD_OUT = "    for (int i = tid; i < nt * D; i += kThreads) {"
OLD_CARRY = "    for (int i = tid; i < D * D; i += kThreads) {\n      const int kk = i / D, e = i % D;"
OLD_EXP = "expf(Lq[t * P + d] - Ls[s * P + d])"
# int8 pages widened after ldmatrix instead of in shared memory: the ring's
# int8 rows padded to D + 16 bytes (ldmatrix reads 8 rows of 16 bytes at
# once), no widening pass, K fragments read by ldmatrix from the int8 rows
# (b16 pairs: a thread gets d 4t..4t+3 of a key) and widened in registers,
# q's fragments loaded with the same permutation of d; V by ldmatrix.trans
# (a thread gets keys 2t, 2t+1 at d 2g, 2g+1), split into the even- and
# odd-d column blocks, so O's column blocks hold d 16c + 4t + {0, 2} and
# + {1, 3}, which the two epilogues write back in place.
PA_QF = ("      const bf16* qs = k_tile(kStages - 1) + (roff + (lane & 15)) * LD + "
         "(lane >> 4) * 8;\n"
         "#pragma unroll\n"
         "      for (int kk = 0; kk < KD; ++kk) ldmatrix_x4(qf[kk], qs + kk * 16);\n")
PA_S = """#pragma unroll
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
"""
PA_S_REGS = """  if constexpr (kScaled) {
    const unsigned char* k8 = reinterpret_cast<const unsigned char*>(ks);
#pragma unroll
    for (int kk = 0; kk < KD; kk += 2) {
#pragma unroll
      for (int np = 0; np < NK / 16; ++np) {
        unsigned kf[4];  // keys np*16 + {0..7, 8..15} x d chunks kk, kk + 1
        ldmatrix_x4(kf, k8 + (koff + np * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * (D + 16) +
                            (kk + (lane >> 4)) * 16);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          unsigned b0, b1;
          int8x4_to_bf16(kf[i], b0, b1);
          mma_bf16_16816(s[2 * np + (i & 1)], qf[kk + (i >> 1)], b0, b1);
        }
      }
    }
  } else {
""" + PA_S + "  }\n"
PA_PV = """#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      unsigned vf[4];  // keys kb2*16 + {0..7, 8..15} x d dp*16 + {0..7, 8..15}, transposed
      ldmatrix_x4_trans(vf, vs + (koff + kb2 * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                dp * 16 + (lane >> 4) * 8);
      mma_bf16_16816(o[2 * dp], ph, vf[0], vf[1]);
      mma_bf16_16816(o[2 * dp], pl, vf[0], vf[1]);
      mma_bf16_16816(o[2 * dp + 1], ph, vf[2], vf[3]);
      mma_bf16_16816(o[2 * dp + 1], pl, vf[2], vf[3]);
    }
"""
PA_PV_REGS = """    if constexpr (kScaled) {
      const unsigned char* v8 = reinterpret_cast<const unsigned char*>(vs);
#pragma unroll
      for (int dp = 0; dp < D / 16; dp += 2) {
        unsigned vf[4];  // keys kb2*16 + {0..7, 8..15} x d chunks dp, dp + 1, as b16, transposed
        ldmatrix_x4_trans(vf, v8 + (koff + kb2 * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) *
                                       (D + 16) + (dp + (lane >> 4)) * 16);
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          unsigned e0, o0, e1, o1;
          int8x4_even_odd(vf[2 * c], e0, o0);
          int8x4_even_odd(vf[2 * c + 1], e1, o1);
          mma_bf16_16816(o[2 * (dp + c)], ph, e0, e1);
          mma_bf16_16816(o[2 * (dp + c)], pl, e0, e1);
          mma_bf16_16816(o[2 * (dp + c) + 1], ph, o0, o1);
          mma_bf16_16816(o[2 * (dp + c) + 1], pl, o0, o1);
        }
      }
    } else {
""" + PA_PV + "    }\n"
PA_STORE = """#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
              __floats2bfloat162_rn(o[j][2 * h] * inv, o[j][2 * h + 1] * inv);
"""
PA_MERGE = """#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(os + (warp * kDecRows + g + 8 * h) * D + 8 * j + 2 * t4) =
              make_float2(o[j][2 * h], o[j][2 * h + 1]);
"""
PA_MINF = "__device__ __forceinline__ float minus_inf() { return -__uint_as_float(0x7f800000u); }\n"
PAGED_INT8_REGS = [
    (PA_MINF, PA_MINF + """// bytes 0 and 2 (even), 1 and 3 (odd) of an int8 word as bf16 pairs
__device__ __forceinline__ void int8x4_even_odd(unsigned w, unsigned& ev, unsigned& od) {
  unsigned lo, hi;
  int8x4_to_bf16(w, lo, hi);
  ev = __byte_perm(lo, hi, 0x5410);
  od = __byte_perm(lo, hi, 0x7632);
}
"""),
    ("kTileBytes = (size_t)kKeys * D * sizeof(TKV);",
     "kTileBytes = (size_t)kKeys * (D + 16) * sizeof(TKV);"),
    ("cp_async16(k_ring(st) + j * D + d0,", "cp_async16(k_ring(st) + j * (D + 16) + d0,"),
    ("cp_async16(v_ring(st) + j * D + d0,", "cp_async16(v_ring(st) + j * (D + 16) + d0,"),
    ("        widen(st);\n        __syncthreads();  // the widened pair is complete\n", ""),
    ("attend_tile<D, 16, kQuant>(k_tile(st), v_tile(st),",
     "attend_tile<D, 16, kQuant>(kQuant ? reinterpret_cast<const bf16*>(k_ring(st)) : k_tile(st), "
     "kQuant ? reinterpret_cast<const bf16*>(v_ring(st)) : v_tile(st),"),
    ("attend_tile<D, kKeys, kQuant>(k_tile(st), v_tile(st),",
     "attend_tile<D, kKeys, kQuant>(kQuant ? reinterpret_cast<const bf16*>(k_ring(st)) : "
     "k_tile(st), kQuant ? reinterpret_cast<const bf16*>(v_ring(st)) : v_tile(st),"),
    (PA_QF, """      if constexpr (kQuant) {  // d permuted as K's: 4t, 4t+1 | 4t+2, 4t+3
        const bf16* q0 = k_tile(kStages - 1) + (roff + g) * LD + 4 * t4;
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
          const uint2 u = *reinterpret_cast<const uint2*>(q0 + kk * 16);
          const uint2 w = *reinterpret_cast<const uint2*>(q0 + 8 * LD + kk * 16);
          qf[kk][0] = u.x;
          qf[kk][1] = w.x;
          qf[kk][2] = u.y;
          qf[kk][3] = w.y;
        }
      } else {
""" + PA_QF + "      }\n"),
    (PA_S, PA_S_REGS),
    (PA_PV, PA_PV_REGS),
    (PA_STORE, """        if constexpr (kQuant) {  // o[2c]: d 16c + 4t + {0, 2}, o[2c + 1] {1, 3}
#pragma unroll
          for (int c = 0; c < D / 16; ++c) {
            auto* p = reinterpret_cast<__nv_bfloat162*>(orow - 2 * t4 + 16 * c + 4 * t4);
            p[0] = __floats2bfloat162_rn(o[2 * c][2 * h] * inv, o[2 * c + 1][2 * h] * inv);
            p[1] = __floats2bfloat162_rn(o[2 * c][2 * h + 1] * inv, o[2 * c + 1][2 * h + 1] * inv);
          }
        } else {
""" + PA_STORE + "        }\n"),
    (PA_MERGE, """      if constexpr (kQuant) {
#pragma unroll
        for (int c = 0; c < D / 16; ++c)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<float4*>(os + (warp * kDecRows + g + 8 * h) * D + 16 * c + 4 * t4) =
                make_float4(o[2 * c][2 * h], o[2 * c + 1][2 * h], o[2 * c][2 * h + 1],
                            o[2 * c + 1][2 * h + 1]);
      } else {
""" + PA_MERGE + "      }\n"),
]
VARIANTS = {
    "flash": {
        "committed": [],
        "3 stages": [(FLASH_STAGES, FLASH_STAGES.replace("2;", "3;"))],
        "32-key tiles, 3 CTAs an SM": [
            (FLASH_KEYS, FLASH_KEYS.replace("64;", "32;")),
            (FLASH_BOUNDS, FLASH_BOUNDS.replace("kThreads, 1", "kThreads, 3"))],
        "32-key tiles": [(FLASH_KEYS, FLASH_KEYS.replace("64;", "32;"))],
        "64-key tiles at D 256": [(FLASH_D256_KEYS, "constexpr int kTileKeys = kKeys;")],
        # the CUDA-core entry (f32 only; read its registers and spills)
        "f32 D 256: 2 + 2 loads in flight": [(FLASH_F32_LOADS, FLASH_F32_LOADS.replace("4 :", "2 :"))],
    },
    "flash_bwd": {
        "committed": [],
        # the dk/dv grid with the key block fastest: each batch row's heavy
        # causal blocks spread over the run instead of first
        "dk/dv grid (key block, kv head x batch)": [
            (BWD_GRID, BWD_GRID.replace("blockIdx.x", "blockIdx.T").replace(
                "blockIdx.y", "blockIdx.x").replace("blockIdx.T", "blockIdx.y")),
            (BWD_LAUNCH, "dkdv<<<dim3((Sk + keys - 1) / keys, B * KH),")],
        "64-row q/dO tiles up to D 128": [
            (BWD_QROWS, BWD_QROWS.replace("32;", "D > 128 ? 32 : 64;"))],
        "D 256: 16-row q/dO tiles": [(BWD_QROWS, BWD_QROWS.replace("32;", "D > 128 ? 16 : 32;"))],
        "D 256: each column group computes S^T and dP^T": [
            (BWD_SHARE, "constexpr bool kShare = false;")],
        "D 256: 32-key dq tiles": [(BWD_DQ_KEYS, BWD_DQ_KEYS.replace("? 16", "? 32"))],
    },
    "mm_pu": {
        "committed": [],
        "32-deep slices, 4 stages": [(MM_TILE, MM_TILE.replace("BK = 64", "BK = 32")),
                                     (MM_STAGES, "constexpr int kStages = 4;")],
        "64 x 64 warp tiles (4 warps)": [(MM_WARPS, MM_WARPS.replace("kWarpsN = 4", "kWarpsN = 2"))],
        "128 x 256 CTA tile (16 warps)": [(MM_TILE, MM_TILE.replace("BN = 128", "BN = 256")),
                                          (MM_WARPS, MM_WARPS.replace("kWarpsN = 4", "kWarpsN = 8"))],
        "diagnostic: no loads in the K loop": [
            ("      if (nxt < nk)\n        load_slice", "      if (nxt < nk && sl < 0)\n        load_slice")],
        "diagnostic: no epilogue": [
            ("        finish4(v, m, n, N,", "        if (v.x == 12345.f) finish4(v, m, n, N,")],
        "diagnostic: no mma": [
            ("          mma_bf16_16816(acc[i][j], af[i], bfr[j >> 1][2 * (j & 1)], "
             "bfr[j >> 1][2 * (j & 1) + 1]);",
             "          acc[i][j][0] += __uint_as_float(af[i][0] ^ bfr[j >> 1][2 * (j & 1)]);")],
    },
    "paged": {
        "committed": [],
        "ring depth 3": [(PAGED_STAGES, PAGED_STAGES.replace("2;", "3;"))],
        "CUDA-core entry, grid cut to row block 0 (diagnostic)": [(PAGED_GRID,
                                                                   "dim3 grid(1, KH, B);")],
    },
    # bf16 q with int8 pages on the tensor-core entry
    "paged_int8": {
        "committed": [],
        "ring depth 3": [(PAGED_STAGES, PAGED_STAGES.replace("2;", "3;"))],
        "widened after ldmatrix": PAGED_INT8_REGS,
    },
    "rmsnorm_bwd": {
        "committed": [],
        "twice the rows a group": [
            (BWD_ROWS, "constexpr int kRows = GL == kThreads ? 1 : NV >= 8 ? 2 : 8 / NV;")],
        "half the rows a group": [
            (BWD_ROWS, "constexpr int kRows = GL == kThreads || NV >= 2 ? 1 : 2 / NV;")],
    },
    "rmsnorm": {
        "committed": [],
        "rows in flight ahead on every row": [(RMS_AHEAD, "constexpr bool kAhead = true;")],
        "no rows in flight ahead": [(RMS_AHEAD, "constexpr bool kAhead = false;")],
        "half the rows a group": [(RMS_ROWS, "constexpr int kRows = NV >= 2 ? 1 : 2 / NV;")],
        "twice the rows a group": [
            (RMS_ROWS, "constexpr int kRows = NV >= 16 ? 1 : NV >= 4 ? 2 : 8 / NV;")],
        "evict-first loads and stores (.cs)": [
            (RMS_LOAD, RMS_LOAD.replace("*reinterpret_cast<const uint4*>(xr + j * VEC)",
                                        "__ldcs(reinterpret_cast<const uint4*>(xr + j * VEC))")),
            (RMS_STORE, "  __stcs(reinterpret_cast<uint4*>(yr + j * VEC), Vec<T>::pack(f));")],
    },
    "wkv": {
        "committed": [],
        "diagnostic: no log2 / cumsum phase": [(WKV_SCAN, WKV_SCAN.replace("{", "if (n < 0) {", 1))],
        "diagnostic: no decayed r / k phase": [(WKV_FACTORS,
                                                WKV_FACTORS.replace("i0 < C * G", "i0 < 0"))],
        "diagnostic: no tensor-core weights": [(WKV_TC, "      continue;\n" + WKV_TC)],
        "diagnostic: no per-element halves": [(WKV_HALVES, WKV_HALVES + "        continue;\n")],
        "diagnostic: no output products": [(WKV_OUT_S, WKV_OUT_S.replace("j < KS", "j < 0")),
                                           (WKV_OUT_A, "        if (j >= 0) continue;")],
        "diagnostic: no state update products": [(WKV_STATE, "")],
        "diagnostic: lg2.approx for log2f": [("log2f(fmaxf(", "__log2f(fmaxf(")],
        "diagnostic: clock probe": WKV_PROBE,
        "diagnostic: no output stores (kept computed)": [(WKV_STORE, WKV_STORE.replace(
            "if (t < nt) {", "if (t < nt && o[x][0][y] != o[x][0][y]) {"))],
        "diagnostic: no w loads": [(WKV_WLOAD, "      wr[i] = t < nt ? 0.9f : 1.f;")],
        "diagnostic: no r/k/v copies (stale shared memory)": [(WKV_COPY, WKV_COPY + "    return;\n")],
        "CUDA-core entry: no per-element weights (diagnostic)": [(OLD_INTRA,
                                                                  "      if (s < 0) {")],
        "CUDA-core entry: no outputs (diagnostic)": [(OLD_OUT, OLD_OUT.replace("nt * D", "0"))],
        "CUDA-core entry: no state carry (diagnostic)": [(OLD_CARRY,
                                                          OLD_CARRY.replace("D * D;", "0;"))],
        "CUDA-core entry: __expf in the weights": [(OLD_EXP, "__" + OLD_EXP)],
    },
}
# Runs of a built variant with other runtime arguments: tag -> (variant, arguments).
RUNS = {
    "paged": {
        "committed": ("committed", {}),
        "split 256": ("committed", {"split": 256}),
        "split 1024": ("committed", {"split": 1024}),
        "ring depth 3": ("ring depth 3", {}),
        "CUDA-core entry": ("committed", {"core": True}),
        "CUDA-core entry, grid cut to row block 0 (diagnostic)": (
            "CUDA-core entry, grid cut to row block 0 (diagnostic)", {"core": True}),
    },
    "paged_int8": {
        "committed (widened in shared memory, ring depth 2)": ("committed", {}),
        "ring depth 3": ("ring depth 3", {}),
        "widened after ldmatrix (int8 rows of D + 16 bytes)": ("widened after ldmatrix", {}),
        "CUDA-core entry (the earlier route)": ("committed", {"core": True}),
    },
    "rmsnorm_bwd": {
        "committed (one wave of resident CTAs)": ("committed", {}),
        "one pass, no grid stride (a CTA for each CTA's rows at once)": ("committed",
                                                                         {"one_pass": True}),
        "twice the rows a group": ("twice the rows a group", {"rows": 2}),
        "half the rows a group": ("half the rows a group", {"rows": 0.5}),
        "F.rms_norm autograd backward (library call)": (None, {}),
    },
    "rmsnorm": {
        "committed": ("committed", {}),
        "F.rms_norm (library call)": (None, {}),
        "half the rows a group": ("half the rows a group", {"rows": 0.5}),
        "twice the rows a group": ("twice the rows a group", {"rows": 2}),
        "one wave of resident CTAs (2 an SM), grid stride": ("committed", {"ctas_per_sm": 2}),
        "one pass, no grid stride (a CTA per 8 warps' rows)": ("committed", {"ctas_per_sm": 0}),
        "rows in flight ahead on every row": ("rows in flight ahead on every row", {}),
        "no rows in flight ahead": ("no rows in flight ahead", {}),
        "evict-first loads and stores (.cs)": ("evict-first loads and stores (.cs)", {}),
    },
    "wkv": {
        **{tag: (tag, {}) for tag in VARIANTS["wkv"] if not tag.startswith("CUDA-core")},
        "chunk 64": ("committed", {"chunk": 64}),
        "chunk 16": ("committed", {"chunk": 16}),
        "CUDA-core entry (wkv_forward), f32": ("committed", {"f32": True}),
        "CUDA-core entry, f32, chunk 64": ("committed", {"f32": True, "chunk": 64}),
        **{tag: (tag, {"f32": True}) for tag in VARIANTS["wkv"] if tag.startswith("CUDA-core")},
    },
}


def write_variant(source: Path, tag: str, subs) -> Path:
    """``source`` with ``subs`` applied, under build/kernel_variants/."""
    common = ROOT / "src/repro_torch/kernels/csrc"
    text = re.sub(r'#include "\.\./\.\./csrc/(\w+\.cuh)"', lambda m: f'#include "{common / m[1]}"',
                  source.read_text())
    for old, new in subs:
        if old not in text:
            raise ValueError(f"variant {tag!r}: {old!r} is not in {source.name}")
        text = text.replace(old, new)
    slug = hashlib.sha1(tag.encode()).hexdigest()[:8]
    path = ROOT / "build/kernel_variants" / f"{source.stem}-{slug}" / source.name
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)
    return path


def bind(path: Path, argtypes: dict) -> ctypes.CDLL:
    from repro_torch.kernels import _build

    lib = ctypes.CDLL(str(_build.library_path(path)))
    for name, types in argtypes.items():
        getattr(lib, name).argtypes = types
        getattr(lib, name).restype = ctypes.c_int
    return lib


def timed(variants: dict, make_run, want) -> None:
    """Each variant: (matches within one bf16 step, max abs error), then
    its times in list order and in reversed order."""
    import chip_smoke as cs

    times = {tag: [] for tag in variants}
    for order in (list(variants), list(reversed(variants))):
        for tag in order:
            times[tag].append(cs.time_ms(make_run(variants[tag])))
    for tag, lib in variants.items():
        ok, err, _ = cs.within(make_run(lib)(), want, cs.BF16_TOL)
        print(f"    {tag}: matches {ok} (max abs err {err:.3g}), ms {times[tag][0]:.4f} / "
              f"{times[tag][1]:.4f}", flush=True)


def kernel_parts(fn, n: int = 5) -> str:
    """Device ms of each kernel ``fn`` launches, a call (torch.profiler over
    ``n`` calls)."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    parts = []
    for e in prof.key_averages():
        if e.device_time_total > 0:
            m = re.search(r"(\w+_kernel)", e.key)
            parts.append(f"{m.group(1) if m else e.key[:40]} {e.device_time_total / n / 1e3:.3f}")
    return "; ".join(parts) + " ms"


def run_flash_bwd(libs: dict) -> None:
    """The backward's bf16 entry of each variant at the training shapes:
    dq, dk, dv within one bf16 step of the plain backward (chip_smoke's
    GRAD_BF16_TOL), times A..Z..A, and each variant's three kernels'
    device times (torch.profiler)."""
    import torch

    import chip_smoke as cs
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import flash_backward_ref

    stream = torch.cuda.current_stream().cuda_stream
    for B, S, H, KH, D, window in ((8, 2048, 16, 8, 128, 0), (8, 2048, 8, 1, 256, 0),
                                   (2, 4096, 16, 1, 256, 2048)):
        kw = dict(causal=True, window=window, prefix=0)
        q, k, v = cs.fused_qkv(B, S, H, KH, D, torch.bfloat16, seed=95)
        o, lse = ops.forward_with_lse(q, k, v, with_lse=True, **kw)
        g = torch.Generator(device="cuda").manual_seed(96)
        do = torch.randn(o.shape, generator=g, device="cuda").to(q.dtype)
        want = flash_backward_ref(q, k, v, o, lse, do, **kw)
        print(f"  flash backward, B {B} S {S} H {H} KH {KH} D {D} bf16 causal window {window}:",
              flush=True)
        run = lambda lib: lambda: ops.launch_backward(lib, q, k, v, o, lse, do,  # noqa: E731
                                                      **kw, stream=stream)
        times = {tag: [] for tag in libs}
        for order in (list(libs), list(reversed(libs))):
            for tag in order:
                times[tag].append(cs.time_ms(run(libs[tag]), reps=10, warmup=2))
        for tag, lib in libs.items():
            ok = all(cs.grad_within(a, b, cs.GRAD_BF16_TOL)[0] for a, b in zip(run(lib)(), want))
            print(f"    {tag}: matches {ok}, ms {times[tag][0]:.4f} / {times[tag][1]:.4f}; "
                  f"{kernel_parts(run(lib))}", flush=True)
        del q, k, v, o, lse, do, want
        torch.cuda.empty_cache()


def paged_core(lib, q, entry, table, lens, q_lens, bs, stream):
    """The CUDA-core entry (``paged_attention_forward``) on bf16 q with bf16
    or int8 pages, as the wrapper launched it before the tensor-core
    entry took them."""
    import math

    import torch

    B, W, H, D = q.shape
    KH = entry["k"].shape[2]
    out = torch.empty_like(q)
    quant = entry["k"].dtype == torch.int8
    scales = (entry["k_scale"].data_ptr(), entry["v_scale"].data_ptr()) if quant else (None, None)
    rc = lib.paged_attention_forward(
        q.data_ptr(), entry["k"].data_ptr(), entry["v"].data_ptr(), *scales, table.data_ptr(),
        lens.data_ptr(), q_lens.data_ptr(), out.data_ptr(), B, W, H, KH, D, bs, table.shape[1],
        0, 64 // (H // KH), 1.0 / math.sqrt(D), 1, 2 if quant else 1, stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention_forward failed (code {rc})")
    return out


def run_paged(libs: dict) -> None:
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attention import ops as pops

    cfg = get_config("qwen3-1.7b")
    H, KH, D, bs, W, MB = cfg.n_heads, cfg.n_kv_heads, cfg.d_head, 16, 256, 128
    stream = torch.cuda.current_stream().cuda_stream
    for name, n_prefill, seed in (("decode", 0, 40), ("mixed", 32, 41)):
        lens, q_lens = cs.main_path_lens(256, W, n_prefill, seed)
        q, entry, table, lens_t, q_lens_t = cs.make_inputs(
            256, W, H, KH, D, bs, MB, "bfloat16", lens, q_lens, q_dtype=torch.bfloat16, seed=seed)
        want = cs.plain((q, entry, table, lens_t, q_lens_t), bs=bs)

        def make_run(run, q=q, entry=entry, table=table, lens_t=lens_t, q_lens_t=q_lens_t):
            lib, kw = run
            if kw.get("core"):
                return lambda: paged_core(lib, q, entry, table, lens_t, q_lens_t, bs, stream)
            return lambda: pops.launch(lib, q, entry, table, lens_t, q_lens_t, block_size=bs,
                                       window=0, rows_per_cta=0, stream=stream, **kw)

        print(f"  paged attention, {name} shape (256 slots x {W} rows, {n_prefill} prefill "
              f"slots, bf16 pages):", flush=True)
        timed({tag: (libs[v], kw) for tag, (v, kw) in RUNS["paged"].items()}, make_run, want)
        del q, entry, want
        torch.cuda.empty_cache()


def run_paged_int8(libs: dict) -> None:
    """bf16 q with int8 pages at qwen3-moe-30b-a3b's plan (128 slots x 256
    rows, H 32, KH 4, D 128): chip_smoke phase 16's decode and mixed shapes
    and phase 20's verify rows (every slot at q_len 5)."""
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attention import ops as pops

    cfg = get_config("qwen3-moe-30b-a3b")
    H, KH, D, bs, W, MB = cfg.n_heads, cfg.n_kv_heads, cfg.d_head, 16, 256, 128
    stream = torch.cuda.current_stream().cuda_stream
    for name, n_prefill, seed, q_len in (("decode", 0, 60, 1), ("mixed", 16, 61, 1),
                                         ("verify, q_len 5", 0, 74, 5)):
        lens, q_lens = cs.main_path_lens(128, W, n_prefill, seed, q_len=q_len)
        q, entry, table, lens_t, q_lens_t = cs.make_inputs(
            128, W, H, KH, D, bs, MB, "int8", lens, q_lens, q_dtype=torch.bfloat16, seed=seed)
        want = cs.plain((q, entry, table, lens_t, q_lens_t), bs=bs)

        def make_run(run, q=q, entry=entry, table=table, lens_t=lens_t, q_lens_t=q_lens_t):
            lib, kw = run
            if kw.get("core"):
                return lambda: paged_core(lib, q, entry, table, lens_t, q_lens_t, bs, stream)
            return lambda: pops.launch(lib, q, entry, table, lens_t, q_lens_t, block_size=bs,
                                       window=0, rows_per_cta=0, stream=stream)

        print(f"  paged attention, int8 pages, {name} (128 slots x {W} rows, {n_prefill} "
              f"prefill slots, G {H // KH}):", flush=True)
        runs = {tag: (libs[v], kw) for tag, (v, kw) in RUNS["paged_int8"].items()}
        timed(runs, make_run, want)
        print(f"    committed, by kernel: {kernel_parts(make_run(next(iter(runs.values()))))}",
              flush=True)
        del q, entry, want
        torch.cuda.empty_cache()


def run_rmsnorm_bwd(libs: dict) -> None:
    """The RMSNorm backward at qwen3-1.7b's training rows (B 8 x S 2048):
    the norm rows (16,384 x 2048) and the q / k views of the fused
    projection (16 and 8 heads of 128), bf16: dx and d(scale) against the
    plain backward (chip_smoke's GRAD_BF16_TOL; d(scale) 1e-4 of its
    largest), times A..Z..A."""
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from repro_torch.kernels.rmsnorm import ops as rops
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_backward_ref

    stream = torch.cuda.current_stream().cuda_stream
    qv, kv = cs.qkv_views(8, 2048, 16, 8, 128, torch.bfloat16, 122)
    sq = torch.randn(128, device="cuda") * 0.1
    shapes = {"norm rows (16384, 2048)": cs.rms_inputs((8 * 2048, 2048), torch.bfloat16, 123),
              "q view (8, 2048, 16, 128)": (qv, sq), "k view (8, 2048, 8, 128)": (kv, sq)}
    g = torch.Generator(device="cuda").manual_seed(10)
    for name, (x, sc) in shapes.items():
        d = x.shape[-1]
        rows = x.numel() // d
        dy = torch.randn(x.shape, generator=g, device="cuda").to(x.dtype)
        want = rmsnorm_backward_ref(x, sc, dy)
        plan = rops.backward_launch_plan(rows, d, 2, True)

        def make_run(run, x=x, sc=sc, dy=dy, plan=plan, rows=rows, d=d):
            lib, kw = run
            if lib is None:
                xl = x.detach().contiguous().requires_grad_()
                wl = (1.0 + sc).to(x.dtype).requires_grad_()
                y = F.rms_norm(xl, (d,), wl, 1e-6)
                return lambda: torch.autograd.grad(y, (xl, wl), dy, retain_graph=True)
            group, nv, r, grid = plan
            r = max(1, int(r * kw.get("rows", 1))) if group != rops.CTA_ROW else r
            per_cta = rops.CTA_ROW // group * r
            grid = -(-rows // per_cta) if kw.get("one_pass") else min(
                -(-rows // per_cta), rops.N_SMS * rops.backward_resident_ctas(nv, r))
            return lambda: rops.launch_backward(lib, x, sc, dy, eps=1e-6, stream=stream,
                                                plan=(group, nv, r, grid))

        print(f"  rmsnorm backward, {name} bf16, plan (lanes a row, vectors a lane, rows a "
              f"group, CTAs) {plan}:", flush=True)
        runs = {tag: (libs[v], kw) for tag, (v, kw) in RUNS["rmsnorm_bwd"].items()}
        times = {tag: [] for tag in runs}
        for order in (list(runs), list(reversed(runs))):
            for tag in order:
                times[tag].append(cs.time_ms(make_run(runs[tag])))
        for tag, run in runs.items():
            ok = "n/a"
            if run[0] is not None:
                dx, ds = make_run(run)()
                dx2, ds2 = make_run(run)()
                ok = (cs.grad_within(dx, want[0], cs.GRAD_BF16_TOL)[0]
                      and cs.grad_within(ds, want[1], (1e-4, 1e-4), unit_floor=False)[0]
                      and torch.equal(dx, dx2) and torch.equal(ds, ds2))
            parts = f"; {kernel_parts(make_run(run))}" if run[0] is not None else ""
            print(f"    {tag}: matches (and reruns bit-identical) {ok}, ms {times[tag][0]:.4f} / "
                  f"{times[tag][1]:.4f}{parts}", flush=True)
        del dy, want
        torch.cuda.empty_cache()


def run_rmsnorm(libs: dict) -> None:
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from repro_torch.kernels.rmsnorm import ops as rops
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

    stream = torch.cuda.current_stream().cuda_stream
    q, _ = cs.qkv_views(256, 256, 16, 8, 128, torch.bfloat16, 54)
    qp, _ = cs.qkv_views(8, 2048, 16, 8, 128, torch.bfloat16, 51)
    sq = cs.rms_inputs((128,), torch.float32, 55)[1]
    shapes = {"slab (65536, 2048)": cs.rms_inputs((256 * 256, 2048), torch.bfloat16, 53),
              "prefill rows (16384, 2048)": cs.rms_inputs((8 * 2048, 2048), torch.bfloat16, 50),
              "slab q view (256, 256, 16, 128)": (q, sq),
              "prefill q view (8, 2048, 16, 128)": (qp, sq)}
    for name, (x, sc) in shapes.items():
        d = x.shape[-1]
        group, nv, r, grid = rops.launch_plan(x.numel() // d, d, 2, True)

        def make_run(run, x=x, sc=sc, group=group, nv=nv, r=r, grid=grid):
            lib, kw = run
            if lib is None:
                w = (1.0 + sc).to(x.dtype)
                return lambda: F.rms_norm(x, (d,), w, 1e-6)
            rr = max(1, int(r * kw.get("rows", 1)))
            per_cta = rops.WARPS * (32 // group) * rr
            g = -(-(x.numel() // d) // per_cta)  # one pass
            if kw.get("ctas_per_sm"):
                g = min(g, rops.N_SMS * kw["ctas_per_sm"])
            elif "ctas_per_sm" not in kw:
                g = rops.launch_plan(x.numel() // d, d, 2, True)[3] if rr == r else (
                    g if group == 32 else min(g, rops.N_SMS * rops.resident_ctas(nv, rr)))
            return lambda: rops.launch(lib, x, sc, eps=1e-6, stream=stream, plan=(group, nv, rr, g))

        print(f"  rmsnorm, {name} bf16, plan (lanes a row, vectors a lane, rows a group, CTAs) "
              f"{(group, nv, r, grid)}:", flush=True)
        timed({tag: (libs[v], kw) for tag, (v, kw) in RUNS["rmsnorm"].items()}, make_run,
              rmsnorm_ref(x, sc))


def run_wkv(libs: dict) -> None:
    """WKV at the rwkv6-1.6b prefill: every run against the plain version
    (``wkv_chunked``) by the JAX test's measure, max |error| over max |output|;
    diagnostics are wrong by design.  The CUDA-core entry takes f32 r/k/v
    (``ops.ENTRIES``): it runs on the bf16 inputs' values widened to f32."""
    import torch

    import chip_smoke as cs
    from repro_torch.kernels.rwkv6 import ops as wops
    from repro_torch.models.rwkv6 import wkv_chunked

    stream = torch.cuda.current_stream().cuda_stream
    args = cs.wkv_inputs(8, 2048, 32, 64, dtype=torch.bfloat16, seed=7)
    args32 = tuple(a.float() for a in args[:3]) + args[3:]
    want = wkv_chunked(*args)

    def make_run(run):
        lib, kw = run
        a = args32 if kw.get("f32") else args
        return lambda: wops.launch(lib, *a, chunk=kw.get("chunk", 32), state=None,
                                   return_state=True, stream=stream)

    runs = {tag: (libs[v], kw) for tag, (v, kw) in RUNS["wkv"].items()}
    times = {tag: [] for tag in runs}
    for order in (list(runs), list(reversed(runs))):
        for tag in order:
            times[tag].append(cs.time_ms(make_run(runs[tag])))
    print("  wkv, B 8 S 2048 H 32 D 64 bf16 (ms: list order / reversed):", flush=True)
    for tag, run in runs.items():
        out, st = make_run(run)()
        err = cs.rel_err(out, want)
        print(f"    {tag}: rel err {err:.3g}, ms {times[tag][0]:.4f} / {times[tag][1]:.4f}",
              flush=True)
        if tag == "diagnostic: clock probe":  # cycles a chunk, mean over the CTAs
            flat = st.reshape(st.shape[0] * st.shape[1], -1).double()
            n_chunks = args[0].shape[1] // 32
            for w, off in (("warp 0", 0), ("warp 4", 16)):
                cyc = flat[:, off:off + len(PROBES)].mean(0) / n_chunks
                print(f"      {w}, cycles a chunk: " + "; ".join(
                    f"{name} {c:.0f}" for name, c in zip(PROBES, cyc.tolist())), flush=True)


def main(argv: list) -> int:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.mm_pu import kernel as mk
    from repro_torch.kernels.mm_pu import ops as mops
    from repro_torch.kernels.mm_pu.ref import mm_pu_ref, quantize_weights_int8
    from repro_torch.kernels.paged_attention import kernel as pk
    from repro_torch.kernels.rmsnorm import kernel as rk
    from repro_torch.kernels.rwkv6 import kernel as wk

    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device visible", flush=True)
        return 2
    which = argv or list(VARIANTS)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    sources = {"flash": fk.SOURCE, "flash_bwd": fk.BACKWARD_SOURCE, "mm_pu": mk.SOURCE,
               "paged": pk.SOURCE, "paged_int8": pk.SOURCE, "rmsnorm": rk.SOURCE,
               "rmsnorm_bwd": rk.BACKWARD_SOURCE, "wkv": wk.SOURCE}
    paths = {(k, tag): write_variant(sources[k], tag, subs)
             for k in which for tag, subs in VARIANTS[k].items()}
    t0 = time.time()
    _build.build_all(list(dict.fromkeys(paths.values())))  # paged and paged_int8 share some
    print(f"built {len(paths)} variants in {time.time() - t0:.1f} s", flush=True)
    for (k, tag), path in paths.items():
        log = _build.library_path(path).with_suffix(".log").read_text().splitlines()
        regs = [ln.split("Used ")[1].split(" reg")[0] for ln in log if "Used" in ln]
        spills = [ln.strip() for ln in log if "spill" in ln and " 0 bytes spill stores" not in ln]
        print(f"  {k} {tag}: {log[0]}; registers {regs}; spills {spills}", flush=True)
    stream = torch.cuda.current_stream().cuda_stream

    if "flash" in which:
        libs = {tag: bind(paths[("flash", tag)], {n: fk._ARGTYPES for n in fk.ENTRIES})
                for tag in VARIANTS["flash"]}
        q, k, v = cs.flash_inputs(8, 2048, 16, 8, 128, torch.bfloat16, seed=20)
        print("  flash, B 8 S 2048 H 16 KH 8 D 128 bf16 causal:", flush=True)
        timed(libs, lambda lib: lambda: fops.launch(lib, q, k, v, causal=True, window=0,
                                                    prefix=0, stream=stream),
              cs.flash_plain(q, k, v))
        del q, k, v
        q, k, v = cs.flash_inputs(8, 2048, 16, 1, 256, torch.bfloat16, seed=70)
        print("  flash, B 8 S 2048 H 16 KH 1 D 256 bf16 causal, window 2048 "
              "(recurrentgemma-9b's local layers):", flush=True)
        timed(libs, lambda lib: lambda: fops.launch(lib, q, k, v, causal=True, window=2048,
                                                    prefix=0, stream=stream),
              cs.flash_plain(q, k, v, window=2048))
        del q, k, v

    if "flash_bwd" in which:
        fk.library()
        run_flash_bwd({tag: bind(paths[("flash_bwd", tag)],
                                 {"flash_attention_backward": fk.BACKWARD_ARGTYPES})
                       for tag in VARIANTS["flash_bwd"]})

    if "mm_pu" in which:
        libs = {tag: bind(paths[("mm_pu", tag)], mk._ARGTYPES) for tag in VARIANTS["mm_pu"]}
        g = torch.Generator(device="cuda").manual_seed(0)
        for name, (m, kk, n) in {"T=2048 w1": (2048, 2048, 6144),
                                 "T=256 w2": (256, 6144, 2048)}.items():
            x = torch.randn((m, kk), generator=g, device="cuda").to(torch.bfloat16)
            w = (torch.randn((kk, n), generator=g, device="cuda") * 0.05).to(torch.bfloat16)
            qw, s = quantize_weights_int8(w)
            for wname, ww, sc in (("int8", qw, s), ("bf16", w, None)):
                print(f"  mm_pu {name} ({m}, {kk}) @ ({kk}, {n}) {wname} w, silu:", flush=True)
                timed(libs, lambda lib: lambda: mops.launch(lib, x, ww, bias=None, residual=None,
                                                             w_scale=sc, activation="silu",
                                                             out_dtype=None, stream=stream),
                      mm_pu_ref(x, ww, w_scale=sc, activation="silu"))
        torch.cuda.empty_cache()

    if "paged" in which:
        run_paged({tag: bind(paths[("paged", tag)], pk._ARGTYPES) for tag in VARIANTS["paged"]})
    if "paged_int8" in which:
        run_paged_int8({tag: bind(paths[("paged_int8", tag)], pk._ARGTYPES)
                        for tag in VARIANTS["paged_int8"]})
    if "rmsnorm" in which:
        libs = {tag: bind(paths[("rmsnorm", tag)], {"rmsnorm_forward": rk._ARGTYPES})
                for tag in VARIANTS["rmsnorm"]}
        run_rmsnorm({**libs, None: None})
    if "rmsnorm_bwd" in which:
        libs = {tag: bind(paths[("rmsnorm_bwd", tag)], {"rmsnorm_backward": rk.BACKWARD_ARGTYPES})
                for tag in VARIANTS["rmsnorm_bwd"]}
        run_rmsnorm_bwd({**libs, None: None})
    if "wkv" in which:
        run_wkv({tag: bind(paths[("wkv", tag)], {n: wk._ARGTYPES for n in wk.ENTRIES})
                 for tag in VARIANTS["wkv"]})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
