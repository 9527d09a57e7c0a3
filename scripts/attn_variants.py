#!/usr/bin/env python3
"""Where the attention kernels' time goes on the card: variants of the source, timed in turns.

Run from the root of a checkout on a machine with a Hopper GPU and the CUDA toolkit:

    python3 scripts/attn_variants.py [window] [global] [window_f32] [global_f32]

Builds variants of ``tmr_tpu_torch/csrc/attn.cu`` (``window``, ``global``: bf16) and
``csrc/attn_f32.cu`` (``window_f32``, ``global_f32``: f32, ``compute_dtype="float32"``)
made by text edits of the source (one table per kernel below: phases cut out of a
kernel, other K/V rings, design alternatives), one ``nvcc -Xptxas -v`` each, all
started together, into the git-ignored ``tmr_tpu_torch/_build/variants/``. Prints each
variant's registers and spills, times the variants in turns over three rounds with CUDA
events, and holds each against the plain version (the per-element tolerances of
``chip_smoke.py``: the bf16 one, or 2e-5 x max|want| in f32); a variant that cuts a phase
out computes garbage and is marked so. Shapes: the windowed kernels on SAM ViT-B's 1200
window-heads of 14x14 tokens at head dim 64 and ViT-H's 1600 at head dim 80 (and its 1536
bucket's 3136, and 7x7 and 16x16 windows at 1600); the global
kernels on ViT-B's 48 x 4096 with and without the bias, on the 1536 bucket's 96x96 grid
(bf16: one image and the eval batch of 4, and ViT-H's batch of 4 at head dim 80; f32:
batch 4), on ViT-H's 64 x 4096 (head dim 80) with and without the bias, and (bf16) on
the grids off ViT-H's path, 24x40, 5x7 and 7x64, at its BH 64, both ways. Prints the
card, one line per kernel, shape and variant, and a JSON line of the times. ``--src``
compares several versions of the selected kernels' source file (for example a parent
commit's, unpacked beside this one: ``git show <commit>:tmr_tpu_torch/csrc/attn.cu >
_archive/attn_parent.cu``) under every variant, in the same turns; a source of another
design than this one's runs as it is, under the name ``full``, and an f32 source whose
global entry takes no ``has_bias`` (the first f32 design's) runs the shapes with the bias
only.

Imports nothing of JAX or ``tmr_tpu``; exits 2 without a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent.parent
P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _sub(src: str, old: str, new: str) -> str:
    if old not in src:
        raise SystemExit(f"attn_variants: the source no longer contains {old!r}")
    return src.replace(old, new)


# windowed kernel window_attn_kernel<D, NTW> (head dim 64, and 80 past 16x16 windows):
# cp.async of Q, then of K and V; the bias projections (after Q lands, with K and V in
# flight); the attention strips
_N_PROJ = "  window_projections<D>(sQ, rh, rw, sRH, sRW, gh, gw, st_h, GWP);\n"
_N_STRIPS = "strip * 16 < sp; strip += WIN_WARPS<D>"
_N_Q_LOOP = "  for (int i = threadIdx.x; i < sp * CH; i += blockDim.x) {"
_N_KV_LOOP = "  for (int i = threadIdx.x; i < nkey * CH; i += blockDim.x) {"
_N_COMMIT = "  cp_async_commit();\n"
_N_QREGS = "constexpr bool WIN_Q_REGS = D == 64;"


def _ntw_variants(src: str) -> dict:
    """Phase cuts of window_attn_kernel<D, NTW> (row 4 at head dim 64), and at head dim 64
    Q re-read from shared memory for each key chunk (shipped: in registers)."""
    kv0 = src.index(_N_KV_LOOP)
    kv1 = src.index(_N_COMMIT, kv0) + len(_N_COMMIT)
    no_strips = _sub(src, _N_STRIPS, "strip * 16 < 0; strip += WIN_WARPS<D>")
    kv_after = _sub(src[:kv0] + src[kv1:], "  cp_async_wait<1>();\n  __syncthreads();",
                    "  cp_async_wait<0>();\n  __syncthreads();")
    kv_after = _sub(kv_after, _N_PROJ, _N_PROJ + src[kv0:kv1])
    q0 = src.index(_N_Q_LOOP)
    return {
        "full": src,
        "loads_only": _sub(no_strips, _N_PROJ, ""),
        "loads_projections": no_strips,
        "loads_strips": _sub(src, _N_PROJ, ""),
        "strips_only": _sub(src[:q0] + src[kv1:], _N_PROJ, ""),
        "kv_after_projections": kv_after,
        "d64_qsmem": _sub(src, _N_QREGS, "constexpr bool WIN_Q_REGS = false;"),
    }


# the head-dim-80 windowed kernel (window_attn_kernel_wg): the producer's TMA of K and V,
# then of Q; the projection warpgroup's work (one window-head ahead); the strips
_W_KV_WAIT = "          if (i) mbar_wait(kvempty, (i - 1) & 1);\n"
_W_KV = ("          mbar_expect_tx(kvfull, 2 * KVBYTES);\n"
         "          tma_load_4d(sKV, &tm.k, kvfull, 0, 0, 0, bh);\n"
         "          tma_load_4d(sKV + NSLOT * 128, &tm.k16, kvfull, 64, 0, 0, bh);\n"
         "          tma_load_4d(sKV + KVBYTES, &tm.v, kvfull, 0, 0, 0, bh);\n"
         "          tma_load_4d(sKV + KVBYTES + NSLOT * 128, &tm.v16, kvfull, 64, 0, 0, bh);\n")
_W_Q = ("          mbar_expect_tx(qfull, QBYTES);\n"
        "          tma_load_3d(sQ, &tm.q, qfull, 0, 0, bh);\n"
        "          tma_load_3d(sQ + WQ * 128, &tm.q16, qfull, 64, 0, bh);\n")
_W_PROJ = ("        window_projections_ahead(q + (size_t)bh * S * 80, rh, rw, sRH, sRH + S * sth, "
           "gh, gw,\n                                 sth, stw, warp - 1);\n")
_W_NK = "    const int nk = (((S + 63) >> 6) + 1) >> 1;\n"
_W_SOFTMAX = ("        window_softmax<NSLOT, GWP>(s, p, sRH + q0 * sth, sRH + q1 * sth, rw0, "
              "rw1, gh,\n                                   scale_log2);\n")
# a cut of the strips: each consumer warp releases Q, the projections and K/V at once
_W_NO_STRIPS = ("    for (int bh = blockIdx.x, i = 0; bh < BH; bh += gridDim.x, ++i) {\n"
                "      mbar_wait(qfull, i & 1);\n"
                "      mbar_wait(&pfull[i & 1], (i >> 1) & 1);\n"
                "      mbar_wait(kvfull, i & 1);\n"
                "      release(qempty);\n      release(&pempty[i & 1]);\n"
                "      release(kvempty);\n    }\n    if (nk > 0) return;\n")
_W_UNITS = "    for (int k = 0; k < 2; ++k) {\n      const int u = u0 + W_PROJ_WARPS * k;\n"
# a second K/V stage (shipped: one): window-head i takes stage i & 1, stage 1's two
# mbarriers after the shipped eight, the projection buffers 32 bytes on
_W_STAGES2 = (
    ("  uint64_t* bars = reinterpret_cast<uint64_t*>(sKV + 2 * KVBYTES);",
     "  uint64_t* bars = reinterpret_cast<uint64_t*>(sKV + 4 * KVBYTES);"),
    ("  float* sP = reinterpret_cast<float*>(bars + 8);",
     "  float* sP = reinterpret_cast<float*>(bars + 10);"),
    ("    mbar_init(kvempty, 8);\n",
     "    mbar_init(kvempty, 8);\n    mbar_init(bars + 8, 1);\n    mbar_init(bars + 9, 8);\n"),
    (_W_KV_WAIT + _W_KV,
     "          unsigned char* sK = sKV + (i & 1) * 2 * KVBYTES;\n"
     "          uint64_t* kf = i & 1 ? bars + 8 : kvfull;\n"
     "          if (i >= 2) mbar_wait(i & 1 ? bars + 9 : kvempty, ((i >> 1) - 1) & 1);\n"
     + _W_KV.replace("sKV", "sK").replace("kvfull", "kf")),
    ("      mbar_wait(kvfull, i & 1);\n",
     "      unsigned char* const sKV = sQ + QBYTES + (i & 1) * 2 * KVBYTES;\n"
     "      mbar_wait(i & 1 ? bars + 8 : kvfull, (i >> 1) & 1);\n"),
    ("        if (last) release(kvempty);", "        if (last) release(i & 1 ? bars + 9 : kvempty);"),
    ("  const size_t smem = window_wg_smem(NSLOT, S, gh, gw);",
     "  const size_t smem = window_wg_smem(NSLOT, S, gh, gw) + 2 * NSLOT * 160 + 2 * 8;"),
)

def _maxnreg(producer: int, consumer: int) -> tuple:
    """Edits that hand registers from warpgroup 0 to the consumer warpgroups."""
    def setmaxnreg(kind: str, regs: int) -> str:
        return f'    asm volatile("setmaxnreg.{kind}.sync.aligned.u32 {regs};\\n");\n'

    return (("  if (wg == 0) {\n    if (warp == 0) {  // producer",
             "  if (wg == 0) {\n" + setmaxnreg("dec", producer)
             + "    if (warp == 0) {  // producer"),
            ("  } else {  // consumers\n    const int c = wg - 1, g",
             "  } else {  // consumers\n" + setmaxnreg("inc", consumer)
             + "    const int c = wg - 1, g"))


#: head-dim-80 windowed kernel: name -> text edits. The phase cuts keep every mbarrier's
#: arrivals (a cut of the loads arrives on the full barriers with no bytes; a cut of the
#: strips releases Q, K, V and the projections at once), so each runs to its end on garbage.
_W_EDITS = {
    "full": (),
    "loads_only": ((_W_NK, _W_NK + _W_NO_STRIPS), (_W_PROJ, "")),
    "loads_projections": ((_W_NK, _W_NK + _W_NO_STRIPS),),
    "loads_strips": ((_W_PROJ, ""),),
    "strips_only": ((_W_KV, "          mbar_arrive(kvfull);\n"),
                    (_W_Q, "          mbar_arrive(qfull);\n")),
    # two K/V stages (shipped: one); refused at launch where they do not fit 227 KB (16x16)
    "stages2": _W_STAGES2,
    # the strips without their softmax (p is the raw scores' bits) or without q.k (the
    # softmax runs on unset accumulators)
    "no_softmax": ((_W_SOFTMAX, "#pragma unroll\n        for (int kk = 0; kk < NSLOT / 16;"
                                " ++kk) p[kk][0] = p[kk][1] = p[kk][2] = p[kk][3] = "
                                "__float_as_uint(s[8 * kk] + s[8 * kk + 5]);\n"),),
    "no_qk": (("          wgmma_ss<NSLOT>(s, a, bk, kk > 0);\n", ""),),
    # the consumers' releases and stores under predicates, not branches on the strip or the
    # row (shipped): ptxas then issues the strips' wgmma without serializing them (no
    # C7520 note), and spills
    "release_pred": (
        ("    if (lane == 0) mbar_arrive(bar);\n  };",
         "    if (lane == 0) mbar_arrive(bar);\n  };\n"
         "  auto release_if = [lane](uint64_t* bar, bool when) {\n    __syncwarp();\n"
         "    asm volatile(\"{\\n.reg .pred p;\\nsetp.ne.b32 p, %1, 0;\\n@p mbarrier.arrive."
         "shared::cta.b64 _, [%0];\\n}\\n\" ::\"r\"(smem_addr(bar)), \"r\"((int)(lane == 0 "
         "&& when)) : \"memory\");\n  };"),
        *((f"        if (last) release({b});", f"        release_if({b}, last);")
          for b in ("qempty", "&pempty[b]", "kvempty")),
        *((f"          if ({r} < S) *reinterpret_cast<uint32_t*>({o} + col) = pack_bf16({x});",
           f"          asm volatile(\"{{\\n.reg .pred p;\\nsetp.ne.b32 p, %2, 0;\\n@p "
           f"st.global.b32 [%0], %1;\\n}}\\n\" ::\"l\"({o} + col), \"r\"(pack_bf16({x})), "
           f"\"r\"((int)({r} < S)) : \"memory\");")
          for r, o, x in (("r0", "o0", "x0, x1"), ("r1", "o1", "x2, x3")))),
    # registers handed from warpgroup 0 (producer, projections) to the consumers by
    # setmaxnreg, 104 / 200 (128 x 104 + 256 x 200 = the launch's 384 x 168), with one
    # projection unit a trip
    "maxnreg": ((_W_UNITS, _W_UNITS.replace("k < 2", "k < 1")),
                ("for (int u0 = pw; u0 < units; u0 += 2 * W_PROJ_WARPS) {",
                 "for (int u0 = pw; u0 < units; u0 += W_PROJ_WARPS) {"),
                *_maxnreg(104, 200)),
    # the projections without their table loads (constant B fragments) or their q loads
    "proj_no_tables": (("          x[k][h][kk] = ok ? *reinterpret_cast<const float4*>(brow + kk * 16)\n"
                        "                           : make_float4(0.f, 0.f, 0.f, 0.f);",
                        "          x[k][h][kk] = make_float4(__uint_as_float(a[k][kk][0]), (float)ok,"
                        " (float)h, (float)kk);"),),
    "proj_no_q": (("        const uint2 r0 = live ? *reinterpret_cast<const uint2*>(q0 + 16 * kk) : "
                   "make_uint2(0, 0);\n        const uint2 r1 = live ? *reinterpret_cast<const "
                   "uint2*>(q1 + 16 * kk) : make_uint2(0, 0);",
                   "        const uint2 r0 = make_uint2(kk + (live ? t : 0), g), r1 = make_uint2(kk,"
                   " t + 1);"),),
    # the projection warps take one unit a trip to memory (shipped: two)
    "proj_1unit": (("for (int u0 = pw; u0 < units; u0 += 2 * W_PROJ_WARPS) {",
                    "for (int u0 = pw; u0 < units; u0 += W_PROJ_WARPS) {"),
                   (_W_UNITS, _W_UNITS.replace("k < 2", "k < 1"))),
}


def window_variants(src: str) -> dict:
    """Both windowed kernels' edits, by name: a name both tables hold (``full`` and the
    phase cuts) edits both kernels in one build, so that each shape reads the cut of the
    kernel it runs (head dim 64 window_attn_kernel<64, 2>, head dim 80 the wgmma kernel).
    A source without the wgmma kernel (``--src``: an earlier checkout's, whose head dim 80
    ran window_attn_kernel<80, 2> at 14x14) takes window_attn_kernel<D, NTW>'s edits only."""
    ntw = _ntw_variants(src)
    if "window_attn_kernel_wg" not in src:
        return ntw
    out = {}
    for name in {**ntw, **_W_EDITS}:
        text = ntw.get(name, src)
        for old, new in _W_EDITS.get(name, ()):
            text = _sub(text, old, new)
        out[name] = text
    return out


_G_SOFTMAX = "global_softmax<BK, HAS_BIAS, GW, {}>(s, m, l, a, rw0, rw1, rows, kt);"
_G_STAGES = "static constexpr int NS = D == 64 ? (BK == 128 ? 3 : 4) : (BK == 64 ? 4 : 3);"
_G_BK = "constexpr int BK = GW == 96 ? 96 : GW == 64 ? 128 : 64;"
_G_ROW96 = "  if (gw == 96 && global_smem<D, 96, true>(gh, gw) <= G_SMEM_LIMIT)"
_G_RW = ("        v0 = fmaf(s[4 * j + e], rows.scale_log2, rw0[j % JG][e]);\n"
         "        v1 = fmaf(s[4 * j + 2 + e], rows.scale_log2, rw1[j % JG][e]);\n")


def _stages(d64: str, d80: str = "(BK == 64 ? 4 : 3)") -> tuple:
    """The K/V ring's depth edited: at head dim 64 and at 80."""
    return (_G_STAGES, f"static constexpr int NS = D == 64 ? {d64} : {d80};")


#: global kernel: name -> text edits
_G_EDITS = {
    "full": (),
    # deeper K/V rings at head dim 64: 4 stages of 128 keys on 64-token rows (128 KB) in
    # place of 3, and 6 stages of 64 keys elsewhere (96 KB) in place of 4
    "stages4_128": (_stages("4"),),
    "stages6_64": (_stages("(BK == 64 ? 6 : BK == 128 ? 3 : 4)"),),
    # 96-token rows (the 1536 bucket) at head dim 64: 3 stages of 96-key tiles (72 KB) in
    # place of 4
    "row96_stages3": (_stages("(BK == 64 ? 4 : 3)"),),
    # row tiles reading each key's rel-w term from shared memory (one read per 8-key
    # group and query row, no (ky, kx) division) in place of the registers held for the
    # whole loop
    "rw_shared": ((_G_RW,
                   "        v0 = fmaf(s[4 * j + e], rows.scale_log2,\n"
                   "                  rows.rw0[8 * (j % JG) + 2 * t + e]);\n"
                   "        v1 = fmaf(s[4 * j + 2 + e], rows.scale_log2,\n"
                   "                  rows.rw1[8 * (j % JG) + 2 * t + e]);\n"),),
    # 96-token rows on the general bias path (64-key tiles, (ky, kx) per key), both head
    # dims: the route before the row tiles
    "row96_general": ((_G_ROW96, "  if (false)"),),
    # 64-key tiles on 64-token rows in place of 128, at both head dims
    "bk64": ((_G_BK, "constexpr int BK = GW == 96 ? 96 : 64;"),),
    # head dim 80: without the bias 128-key tiles (3 stages, 120 KB) in place of 64; on
    # 96-token rows 2 stages of 96 keys in place of 3; 3 stages of 64 keys in place of 4
    "d80_nobias_bk128": ((_G_BK, "constexpr int BK = GW == 96 ? 96 : GW == 64 || "
                                 "(D == 80 && !HAS_BIAS) ? 128 : 64;"),),
    "d80_row96_stages2": (_stages("(BK == 128 ? 3 : 4)",
                                  "(BK == 64 ? 4 : BK == 96 ? 2 : 3)"),),
    "d80_stages3_64": (_stages("(BK == 128 ? 3 : 4)", "3"),),
    # the consumer warpgroups' turn-taking flipped: none with the bias, turns without it
    "turns_flipped": (("constexpr bool TURNS = HAS_BIAS;",
                       "constexpr bool TURNS = !HAS_BIAS;"),),
    # the key loop without its softmax (p is the raw scores): products, copies, barriers
    "no_softmax": ((_G_SOFTMAX.format("false"), ";"), (_G_SOFTMAX.format("true"), ";"),
                   ("    float a[2];", "    float a[2] = {1.f, 1.f};")),
    # the key loop without its products (the softmax reruns on stale scores)
    "no_mma": (("issue_qk<D, BK>(s, qa, sKV + st * 2 * KVBYTES);", ""),
               ("issue_pv<D, BK>(o, ot, p, sKV + prev * 2 * KVBYTES + KVBYTES);", "")),
    # no bias projections before the key loop (the bias reads unset shared memory)
    "no_projections": (("global_projection<D>(sQ, lr0, rph, gh, ya, yb, yf, yl, sRh, sth);",
                        ""),
                       ("global_projection<D>(sQ, lr0, rpw, gw, ta - ya * gw",
                        "if (0) global_projection<D>(sQ, lr0, rpw, gw, ta - ya * gw")),
    # the softmax without its exponentials (one MUFU instruction per score)
    "no_exp": tuple((f"ex2(s[4 * j{i}]", f"(s[4 * j{i}]")
                    for i in ("", " + 1", " + 2", " + 3")),
}


def _edited(src: str, table: dict) -> dict:
    out = {}
    for name, edits in table.items():
        text = src
        for old, new in edits:
            text = _sub(text, old, new)
        out[name] = text
    return out


def global_variants(src: str) -> dict:
    """The global edits apply to this design's source (row tiles of GW-token grid rows,
    head dim 80 at its 80 columns); another design (``--src``: the general path's on
    96-token rows, or head dim 80 in two 64-column panels) runs as it is, under the name
    ``full``."""
    return _edited(src, _G_EDITS) if "sw32_desc" in src else {"full": src}


_F_QK = ("          wgmma_n32(sc, ql[kk], bhi, kk > 0);\n"
         "          wgmma_n32(sc, qh[kk], blo, 1);\n"
         "          wgmma_n32(sc, qh[kk], bhi, 1);\n")
_F_PV = ("            wgmma_pv<PV_N>(acc, pl[j], bhi, j > 0);\n"
         "            wgmma_pv<PV_N>(acc, ph[j], blo, 1);\n"
         "            wgmma_pv<PV_N>(acc, ph[j], bhi, 1);\n")
#: f32 kernels (csrc/attn_f32.cu, one kernel function for both entries): name -> text edits
_F_EDITS = {
    "full": (),
    # the ring's depth fixed (shipped: the deepest of 4, 3, 2 stages that fits)
    "stages2": (("  int ns = 4;\n", "  int ns = 2;\n"),),
    "stages3": (("  int ns = 4;\n", "  int ns = 3;\n"),),
    # the key loop without its products (the softmax runs on stale scores)
    "no_mma": ((_F_QK, ""), (_F_PV, "")),
    # no split: the consumers read the raw K tile and unwritten V^T planes; or no V^T
    # only (the p.v operands left unwritten)
    "no_split": (("        split_stage<D>(stages + (size_t)s * G::STAGE, sid);\n", ""),),
    "no_vt": (("      split_tf32(xs[i], vt[wd], vtlo[wd]);\n", ""),),
    # no bias projections (the bias reads unset shared memory)
    "no_projections": (("      projections<D, BIAS>(qb, th, tw, sRh, sRw, q0, S, gh, gw, sth, "
                        "stw, inv_gw,\n                           threadIdx.x - 128);\n", ""),),
    # K's hi not written: the tensor cores read the raw word as a truncated hi, and lo is
    # x - trunc(x) (right only if the tensor cores truncate the low 13 bits)
    "k_truncated_hi": (
        ("// K's 16 bytes at k: hi over the raw words, lo into klo\n",
         "__device__ __forceinline__ void split_trunc(float x, uint32_t& hi, uint32_t& lo) {\n"
         "  hi = __float_as_uint(x) & 0xFFFFE000u;\n"
         "  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi)));\n}\n"),
        ("  split_tf32(__uint_as_float(x.x), h.x, l.x);\n"
         "  split_tf32(__uint_as_float(x.y), h.y, l.y);\n"
         "  split_tf32(__uint_as_float(x.z), h.z, l.z);\n"
         "  split_tf32(__uint_as_float(x.w), h.w, l.w);\n"
         "  *k = h;\n",
         "  split_trunc(__uint_as_float(x.x), h.x, l.x);\n"
         "  split_trunc(__uint_as_float(x.y), h.y, l.y);\n"
         "  split_trunc(__uint_as_float(x.z), h.z, l.z);\n"
         "  split_trunc(__uint_as_float(x.w), h.w, l.w);\n")),
    # the registers handed over: 72 for the loading warpgroup and 216 for each consumer
    # thread (shipped: 56 / 224)
    "regs72": (("setmaxnreg.dec.sync.aligned.u32 56", "setmaxnreg.dec.sync.aligned.u32 72"),
               ("setmaxnreg.inc.sync.aligned.u32 224", "setmaxnreg.inc.sync.aligned.u32 216")),
    # the softmax without its exponentials of p (p is the biased scores)
    "no_exp": (("const float p0 = ex2(sc[4 * j] - mx0), p1 = ex2(sc[4 * j + 1] - mx0);",
                "const float p0 = sc[4 * j], p1 = sc[4 * j + 1];"),
               ("const float p2 = ex2(sc[4 * j + 2] - mx1), p3 = ex2(sc[4 * j + 3] - mx1);",
                "const float p2 = sc[4 * j + 2], p3 = sc[4 * j + 3];")),
}


def f32_variants(src: str) -> dict:
    """The f32 edits apply to this design's source; another design (``--src``) runs as it
    is, under the name ``full``."""
    return _edited(src, _F_EDITS) if "split_stage<D>" in src else {"full": src}


def _has_bias_arg(src: str) -> bool:
    """Whether an attn_f32.cu source's global entry takes ``has_bias`` (the first f32
    design's does not)."""
    return "float scale, int has_bias, void* stream" in src


#: name -> source file, dtype, entry point, its argtypes, the variants, the shapes (gh, gw,
#: batch*heads, bias, head dim), launches per timing, and the entry's arguments before the
#: stream for inputs x
KERNELS = {
    "window": SimpleNamespace(
        source="attn.cu", f32=False,
        entry="tmr_window_attn", argtypes=[P, P, P, P, P, P, I, I, I, I, I, F, P],
        variants=window_variants,
        shapes=((14, 14, 4 * 25 * 12, True, 64), (14, 14, 4 * 25 * 16, True, 80),
                (14, 14, 4 * 49 * 16, True, 80), (7, 7, 4 * 25 * 16, True, 80),
                (16, 16, 4 * 25 * 16, True, 80)), reps=50,
        args=lambda x: (*x.qkv, *x.expanded, x.out, x.bh, x.s, x.gh, x.gw, x.d, x.scale)),
    "global": SimpleNamespace(
        source="attn.cu", f32=False,
        entry="tmr_global_attn", argtypes=[P, P, P, P, P, P, I, I, I, I, I, F, I, P],
        variants=global_variants,
        shapes=((64, 64, 48, True, 64), (64, 64, 48, False, 64), (96, 96, 12, True, 64),
                (96, 96, 48, True, 64), (64, 64, 64, True, 80), (64, 64, 64, False, 80),
                (96, 96, 64, True, 80), (24, 40, 64, True, 80), (24, 40, 64, False, 80),
                (5, 7, 64, True, 80), (5, 7, 64, False, 80), (7, 64, 64, True, 80),
                (7, 64, 64, False, 80)), reps=20,
        args=lambda x: (*x.qkv, *(x.compact if x.bias else (None, None)), x.out, x.bh, x.s,
                        x.gh, x.gw, x.d, x.scale, int(x.bias))),
    "window_f32": SimpleNamespace(
        source="attn_f32.cu", f32=True,
        entry="tmr_window_attn_f32", argtypes=[P, P, P, P, P, P, I, I, I, I, I, F, P],
        variants=f32_variants,
        shapes=((14, 14, 4 * 25 * 12, True, 64), (14, 14, 4 * 25 * 16, True, 80)), reps=20,
        args=lambda x: (*x.qkv, *x.expanded, x.out, x.bh, x.s, x.gh, x.gw, x.d, x.scale)),
    "global_f32": SimpleNamespace(
        source="attn_f32.cu", f32=True,
        entry="tmr_global_attn_f32", argtypes=[P, P, P, P, P, P, I, I, I, I, I, F, I, P],
        old_argtypes=[P, P, P, P, P, P, I, I, I, I, I, F, P],
        variants=f32_variants,
        shapes=((64, 64, 48, True, 64), (64, 64, 48, False, 64), (96, 96, 48, True, 64),
                (64, 64, 64, True, 80), (64, 64, 64, False, 80)), reps=5,
        args=lambda x: (*x.qkv, *(x.compact if x.bias else (None, None)), x.out, x.bh, x.s,
                        x.gh, x.gw, x.d, x.scale) + ((int(x.bias),) if x.has_bias_arg
                                                     else ())),
}


def build(sources: dict, out: Path, flags) -> dict:
    """sources: (kernel, name) -> source text. One nvcc each, all started together;
    returns (kernel, name) -> the loaded library, its entry's argtypes set."""
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for (kernel, name), text in sources.items():
        stem = f"{kernel}_{name}".replace("/", "_")
        (out / f"{stem}.cu").write_text(text)
        cmd = ["/usr/local/cuda/bin/nvcc", *flags, "-Xptxas", "-v",
               "-o", str(out / f"lib{stem}.so"), str(out / f"{stem}.cu")]
        procs[kernel, name] = stem, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for (kernel, name), (stem, proc) in procs.items():
        text = sources[kernel, name]
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for the {kernel} {name} variant:\n{log}")
        lines = log.splitlines()
        spec = KERNELS[kernel]
        tag = "attn_f32_kernel" if spec.f32 else f"{kernel}_attn_kernel"
        for i, line in enumerate(lines):  # this kernel's entries: spills, registers
            if "Compiling entry function" in line and tag in line:
                stats = " | ".join(x.strip() for x in lines[i + 2:i + 4])
                print(f"ptxas {kernel} {name} {line.split(tag)[1][:18]}: {stats}", flush=True)
        lib = ctypes.CDLL(str(out / f"lib{stem}.so"))
        lib.has_bias_arg = not spec.f32 or _has_bias_arg(text)
        getattr(lib, spec.entry).argtypes = (
            spec.argtypes if lib.has_bias_arg else getattr(spec, "old_argtypes", spec.argtypes))
        libs[kernel, name] = lib
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("kernels", nargs="*", default=list(KERNELS),
                    help=f"kernels to vary, of {', '.join(KERNELS)} (default: all)")
    ap.add_argument("--variants", nargs="+",
                    help="variant names to build (default: every variant of each kernel)")
    ap.add_argument("--src", nargs="+", type=Path,
                    help="sources of the selected kernels' file (attn.cu or attn_f32.cu) to "
                         "compare, each under every variant (default: this checkout's); "
                         "variants of the i-th are named i/<variant>")
    args = ap.parse_args(argv)
    if set(args.kernels) - set(KERNELS):
        ap.error(f"unknown kernels {sorted(set(args.kernels) - set(KERNELS))}")
    import torch

    if not torch.cuda.is_available():
        print("attn_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from tmr_tpu_torch.ops import _build, cuda_attn

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    sources = {}
    for kernel in args.kernels:
        srcs = args.src or [_build.CSRC / KERNELS[kernel].source]
        for i, src in enumerate(srcs):
            print(f"{kernel} source {i}: {src}", flush=True)
            for name, text in KERNELS[kernel].variants(src.read_text()).items():
                if args.variants is None or name in args.variants:
                    sources[kernel, f"{i}/{name}" if len(srcs) > 1 else name] = text
    if not sources:
        raise SystemExit(f"attn_variants: no variant named {args.variants}")
    libs = build(sources, _build.BUILD_DIR / "variants", _build.NVCC_FLAGS)
    stream = torch.cuda.current_stream().cuda_stream
    times = {}
    for kernel in args.kernels:
        spec = KERNELS[kernel]
        mine = {name: getattr(lib, spec.entry)
                for (k, name), lib in libs.items() if k == kernel}
        for gh, gw, bh, bias, d in spec.shapes:
            gen = torch.Generator(device="cuda").manual_seed(0)
            s, scale = gh * gw, d ** -0.5
            dtype = torch.float32 if spec.f32 else torch.bfloat16
            q, k, v = (torch.randn(bh, s, d, generator=gen, device="cuda").to(dtype)
                       for _ in range(3))
            compact = (torch.randn(2 * gh - 1, d, generator=gen, device="cuda") * 0.1,
                       torch.randn(2 * gw - 1, d, generator=gen, device="cuda") * 0.1)
            expanded = tuple(cuda_attn.get_rel_pos(g, g, t) for g, t in zip((gh, gw), compact))
            rel = cuda_attn.bias_projections(q, *expanded, (gh, gw)) if bias else (None, None)
            with chip_smoke.exact_f32(torch):
                # in BH chunks of 12: a 96x96 grid's dense f32 scores at BH 48 take 16 GB
                want = torch.cat([cuda_attn.attention_plain(
                    q[i:i + 12], k[i:i + 12], v[i:i + 12],
                    *(None if r is None else r[i:i + 12] for r in rel), (gh, gw),
                    scale).float() for i in range(0, bh, 12)])
            if spec.f32:
                limit = chip_smoke.ATTN_F32_TOL * want.abs().max()
            else:
                limit = (chip_smoke.ATTN_REL_TOL * want.abs()
                         + chip_smoke.ATTN_ABS_TOL * want.abs().max())
            out = torch.empty_like(q)
            runs = {name: fn for name, fn in mine.items()
                    if bias or libs[kernel, name].has_bias_arg}

            def call(name, fn) -> int:
                x = SimpleNamespace(
                    qkv=(q.data_ptr(), k.data_ptr(), v.data_ptr()), out=out.data_ptr(),
                    compact=tuple(t.data_ptr() for t in compact),
                    expanded=tuple(t.data_ptr() for t in expanded),
                    bh=bh, s=s, gh=gh, gw=gw, d=d, scale=scale, bias=bias,
                    has_bias_arg=libs[kernel, name].has_bias_arg)
                return fn(*spec.args(x), stream)

            def launch(name, fn):
                rc = call(name, fn)
                if rc:
                    raise SystemExit(f"attn_variants: {kernel} {name} error {rc} at launch")

            key = f"{kernel} d={d} {gh}x{gw} BH={bh} {'bias' if bias else 'no bias'}"
            # a variant whose ring and projections do not fit this shape's shared memory
            # is refused at launch (the entry's return code): it sits this shape out
            for name, fn in list(runs.items()):
                rc = call(name, fn)
                if rc:
                    print(f"{key:36s} {name:22s} not run: error {rc} at launch", flush=True)
                    del runs[name]
            times[key] = {name: [] for name in runs}
            for _ in range(3):
                for name, fn in runs.items():
                    times[key][name].append(
                        chip_smoke.cuda_ms(lambda: launch(name, fn), spec.reps, 3))
            for name, fn in runs.items():
                launch(name, fn)
                torch.cuda.synchronize()
                worst = ((out.float() - want).abs() / limit).max().item()
                ms = " ".join(f"{t:.4f}" for t in times[key][name])
                print(f"{key:36s} {name:22s} ms {ms} worst err/limit {worst:.3f}"
                      f"{'' if worst <= 1 else ' (garbage: a phase is cut out)'}", flush=True)
    print(f"card: {card}")
    print(json.dumps({"card": card, "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
