#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``tmr_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout on a machine with a Hopper GPU and the CUDA toolkit:

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):

1. device: the card's name and power limit (``nvidia-smi``);
2. build: every CUDA kernel of the port, compiled from ``tmr_tpu_torch/csrc``; then the
   toolchain probe ``add1`` runs, before any other kernel, and its event-bracketed time
   is printed beside its profiled device time and the host's cost per launch;
3. kernels: each kernel at the main path's shapes against its plain PyTorch version on
   the same inputs, with the tolerance stated, timed beside its plain version, a
   PyTorch library call computing the same function (timed here, never used by the
   port) and its bound (bytes or operations over the card's peak); each attention
   kernel is one launch that makes its own bias projections (kernel = wrapper), timed
   beside SDPA with the bias mask precomputed and, printed with it, what SDPA's time
   leaves out: ``bias_projections`` and the mask build; the global kernel, with and
   without the bias, is also held to its plain version on 24x40, 96x96 (one image),
   20x20, 28x28 and 5x7 token grids, the windowed kernel at 7x7 and 16x16 windows; the
   f32 correlation at T = 1 to 65 on the matcher's map with its 3xTF32 tensor bound and
   its f32 bound, and on 96^2 and 64^2 maps, a ragged map, a bf16-valued feature and a
   feature with non-finite values planted; the int8 correlation at T = 1 to 65 on the
   matcher's map, timed in turns with the CUDA-core kernel it replaced, beside the
   function's bound and the band's, and on two ragged maps and a map of -128/-127/127
   only (0 mismatches everywhere); the fused int8 3x3 layer at the int8 tail's
   shape and a ragged one, timed in turns with the per-tap composition it replaces,
   beside the bare ``torch._int_mm`` of the im2col'd product and its ``-Xptxas -v``;
4. main path: ``Predictor(preset("TMR_FSCD147"))`` (SAM ViT-B at 1024, batch 4, bf16)
   with seeded random weights answers 3 batches of 4 synthetic images whose exemplars
   hit the 9/17/33 template buckets; every kernel's launch count over those batches
   must be > 0 (``window_attn`` exactly 24: one per windowed block), nothing may call
   ``bias_projections`` (both attention kernels make their own projections), and image
   0's objectness map must agree with an f32 CPU run of the same port and weights;
4b. the int8 path: the same preset with ``quant="int8", quant_storage="int8",
   quant_kernel="int8"`` and phase 4's weights (stored as int8) answers the same 3
   batches; its launch counts must be exactly those of its path; its decoder tail on
   one ``f_cat`` must equal the same tail run with the int8 kernels' plain versions on
   the card; the activation quantization passes are timed on that ``f_cat``; the int8
   tail must lie within the JAX package's output tier (5e-2) of the
   exact tail on that tier's inputs at the production geometry, and the stored-weight
   path with the dequant arm within it of phase 4's objectness map; the int8 path's
   objectness is printed beside phase 4's and held to a bound on gross faults (its
   difference over both maps, the tier's measure, is printed too), and so are the
   statistics of image 0's ``f_cat`` and the int8 tail's error on it;
5. a ``{"kernels": [...]}`` JSON line, then the card line, then the last line
   ``{"ok": true, "device": {...}}``.

Imports nothing of JAX or ``tmr_tpu``. Exits non-zero without a result when there is
no CUDA device or when the port's sources are not beside this file.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

#: published peaks of one H100 SXM (dense): bf16, TF32 and int8 tensor cores, f32 CUDA
#: cores, HBM. An int8 x int8 -> int32 sum is bounded at the int8 rate whatever
#: instruction a kernel uses for it
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_INT8_OPS = 1979e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# attention, per element: |got - want| <= ATTN_REL_TOL |want| + ATTN_ABS_TOL max|want|
# (one bf16 ulp of the element, plus a floor for the noise of p's bf16 rounding on
# elements that cancel to near zero: p and the output round to bf16 at different
# points of the two softmaxes); and mean |got - want| <= ATTN_MEAN_TOL mean |want|
ATTN_REL_TOL = 2.0 ** -7
ATTN_ABS_TOL = 2.0 ** -9
ATTN_MEAN_TOL = 2.0 ** -8
#: the f32 correlation (3xTF32 on the tensor cores, about 2^-21 per product) vs its
#: plain version's f32 sums of T^2 products in another order, relative to max|want|
XCORR_REL_TOL = 2e-5
#: templates the f32 correlation is held at on the matcher's map; the main path takes
#: 9, 17 and 33, the direct path every odd T up to 65
XCORR_TS = (1, 3, 9, 17, 33, 65)
#: other maps, (B, C, H, W, templates, feature rounded to bf16): the 768 and 512 inputs'
#: 96^2 and 64^2 maps, a ragged map with 7 planes, and the main path's bf16 feature
#: (``fp.float()`` of a bf16 map, exact in tf32)
XCORR_MAPS = ((4, 512, 96, 96, (9, 17, 33, 65), False),
              (4, 512, 64, 64, (9, 17, 33, 65), False),
              (1, 7, 100, 76, XCORR_TS, False),
              (4, 512, 128, 128, (9, 33, 65), True))
OBJ_REL_TOL = 5e-2  # bf16 network vs f32 CPU network, relative to the map's max
#: tmr_tpu/ops/quant.py OUTPUT_TIER_REL: the int8 tail vs the exact tail on the JAX
#: package's own tier inputs (quant_int8dot_ok), and the stored-weight (dequant) path's
#: objectness vs the bf16 path's
QUANT_TIER_REL = 5e-2
#: the int8 path's objectness vs the bf16 path's, relative to the objectness map's own
#: max: a bound on faults of the composition (a wrong scale or layout moves the map by
#: its whole size), not a tier. The int8 arm's one activation scale per image is set by
#: f_cat's per-channel offsets and outliers, and the map follows the channels' small
#: spatial variation, so the JAX function itself reads ~0.1 on this measure here (and
#: within 5e-2 on its tier's, both maps; tests/test_torch_quant.py, PERF.md)
INT8_PATH_OBJ_BOUND = 0.25
#: launches of the int8 path over its 3 batches: one fused 3x3 layer and one head
#: matmul, one int8 correlation, 4 global and 8 windowed attention blocks, one NMS per
#: batch
QUANT_LAUNCHES = {"global_attn": 12, "window_attn": 24, "xcorr": 0, "nms": 3,
                  "xcorr_int8": 3, "int8_mm": 3, "int8_conv": 3, "add1": 0}
#: the fused int8 3x3 layer's shapes (B, H, W, C_in, N): the int8 tail's (4 x 128^2,
#: 1024 -> 2048 [objectness | bbox]) and a ragged one (W past no tile edge, N not a
#: multiple of 8, C_in not of 128)
INT8_CONV_SHAPES = ((4, 128, 128, 1024, 2048), (1, 37, 53, 48, 20))
BUCKET_SIDES_PX = {9: 56, 17: 120, 33: 240}  # exemplar sides that land in each bucket
SEED = 0  # weights, images and kernel inputs are all drawn from it


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


@contextlib.contextmanager
def exact_f32(torch):
    """TF32 off for the kernel checks' f32 products and library yardsticks, restored
    after, so the main path runs under the settings a caller of the port has."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@contextlib.contextmanager
def call_count(module, name: str):
    """Counts the calls of ``module.name`` made through the module while the block runs."""
    calls = [0]
    orig = getattr(module, name)

    def counted(*args, **kwargs):
        calls[0] += 1
        return orig(*args, **kwargs)

    setattr(module, name, counted)
    try:
        yield calls
    finally:
        setattr(module, name, orig)


def bound(flops: float, nbytes: float, peak_flops: float):
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def check_attention(torch, F, cuda_attn, windowed: bool, has_bias: bool, seed: int,
                    grid=(64, 64), bh=None):
    """One attention kernel vs its plain version, by default at the main path's batch (4
    images, 12 heads; windowed: 25 windows each). The global kernel takes compact
    (2g - 1, 64) tables, the windowed kernel expanded (g, g, 64) ones; the plain version
    and the yardstick use the expanded tables. Times, on the same inputs: the kernel
    (one launch, projections inside), ``bias_projections`` alone, the bf16 mask built
    from the projections, and SDPA with that mask precomputed."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    (gh, gw), d = grid, 64
    bh = bh or (4 * 25 * 12 if windowed else 4 * 12)
    s = gh * gw
    q, k, v = (torch.randn(bh, s, d, generator=gen, device="cuda").bfloat16()
               for _ in range(3))
    tab = rh = rw = None
    if has_bias and windowed:
        rh = torch.randn(gh, gh, d, generator=gen, device="cuda") * 0.1
        rw = torch.randn(gw, gw, d, generator=gen, device="cuda") * 0.1
        tab = rh, rw
    elif has_bias:
        tab = (torch.randn(2 * gh - 1, d, generator=gen, device="cuda") * 0.1,
               torch.randn(2 * gw - 1, d, generator=gen, device="cuda") * 0.1)
        rh, rw = (cuda_attn.get_rel_pos(g, g, t) for g, t in zip(grid, tab))
    tab = tab or (None, None)
    scale = d ** -0.5
    fn = cuda_attn.window_attention if windowed else cuda_attn.global_attention
    rel = cuda_attn.bias_projections(q, rh, rw, (gh, gw)) if has_bias else (None, None)
    got = fn(q, k, v, *tab, (gh, gw), scale)
    want = cuda_attn.attention_plain(q, k, v, *rel, (gh, gw), scale)
    torch.cuda.synchronize()
    diff, ref = (got.float() - want.float()).abs(), want.float().abs()
    limit = ATTN_REL_TOL * ref + ATTN_ABS_TOL * ref.max()
    acc = dict(max_abs_err=diff.max().item(), mean_abs_err=diff.mean().item(),
               mean_abs_want=ref.mean().item(), max_abs_want=ref.max().item(),
               worst_err_over_limit=(diff / limit).max().item())
    acc["ok"] = (acc["worst_err_over_limit"] <= 1.0
                 and acc["mean_abs_err"] <= ATTN_MEAN_TOL * acc["mean_abs_want"])
    t = dict(ms=cuda_ms(lambda: fn(q, k, v, *tab, (gh, gw), scale)))
    t["plain_ms"] = cuda_ms(lambda: cuda_attn.attention_plain(q, k, v, *rel, (gh, gw),
                                                              scale), reps=3, warmup=1)
    mask = None
    if has_bias:
        t["proj_ms"] = cuda_ms(lambda: cuda_attn.bias_projections(q, rh, rw, (gh, gw)))

        def build_mask():
            m = (rel[0][..., :, None] + rel[1][..., None, :]).reshape(bh, s, s)
            return m.to(torch.bfloat16)[None]

        t["mask_ms"] = cuda_ms(build_mask, reps=5, warmup=1)
        mask = build_mask()
    t["lib_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
        q[None], k[None], v[None], attn_mask=mask, scale=scale), reps=5, warmup=1)
    flops = 4.0 * bh * s * s * d
    # q, k, v read and out written once, and the tables the kernel reads (the windowed
    # kernel's expanded ones, the global kernel's compact ones)
    nbytes = 4 * bh * s * d * 2 + (sum(t.numel() for t in tab) * 4 if has_bias else 0)
    return acc, t, bound(flops, nbytes, PEAK_BF16_FLOPS)


#: token grids off the main path, each with and without the bias, (gh, gw, batch*heads):
#: rows that are not one key tile (24x40), the 1536 bucket at one image (the plain
#: version's dense f32 scores take 4 GB), the 320^2 and 448^2 inputs' grids whose token
#: counts are not multiples of 64 (20x20, 28x28), one partial tile (5x7), and 64-token
#: rows in an odd count (7x64: the main path's 128-key tiles end half empty)
GLOBAL_GRIDS = ((24, 40, 48), (96, 96, 12), (20, 20, 48), (28, 28, 48), (5, 7, 48),
                (7, 64, 48))


def check_global_grids(torch, F, cuda_attn) -> None:
    """The global kernel against its plain version on GLOBAL_GRIDS."""
    for gh, gw, bh in GLOBAL_GRIDS:
        for has_bias in (True, False):
            acc, t, (bms, bby) = check_attention(torch, F, cuda_attn, False, has_bias, SEED,
                                                 (gh, gw), bh)
            what = f"global_attn{'' if has_bias else '_nobias'} {gh}x{gw} grid, BH={bh}"
            print(f"kernel {what}: {attn_accuracy(acc)} {attn_times(t)} bound_ms "
                  f"{bms:.4f} ({bby})", flush=True)
            if not acc["ok"]:
                fail(f"{what} disagrees with its plain version: {acc}")


def attn_times(t: dict) -> str:
    extra = (f" bias_projections_ms {t['proj_ms']:.4f} mask_build_ms {t['mask_ms']:.4f}"
             if "proj_ms" in t else "")
    return (f"kernel_ms {t['ms']:.4f} (one launch) plain_ms "
            f"{t['plain_ms']:.4f} library_ms {t['lib_ms']:.4f} (SDPA, mask precomputed)"
            + extra)


def attn_accuracy(acc: dict) -> str:
    return (f"max_err {acc['max_abs_err']:.3e} mean_err {acc['mean_abs_err']:.3e} "
            f"(limit {ATTN_REL_TOL:g}|want| + {ATTN_ABS_TOL:g} max|want| per element, "
            f"mean_err <= {ATTN_MEAN_TOL:g} mean|want|; mean|want| "
            f"{acc['mean_abs_want']:.3e}, max|want| {acc['max_abs_want']:.3e}, worst "
            f"err/limit {acc['worst_err_over_limit']:.3f})")


def check_xcorr(torch, F, cuda_xcorr, t: int, seed: int, shape=(4, 512, 128, 128),
                bf16: bool = False, yardsticks: bool = True) -> dict:
    """The f32 correlation vs its plain version on one map; its time, and with
    ``yardsticks`` the plain version's and a grouped ``F.conv2d``'s. Bounds of the
    useful products: 3xTF32 at the TF32 tensor peak (the kernel's) and f32 at the CUDA
    cores' peak, each against the bytes."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    b, c, h, w = shape
    feat = torch.randn(b, c, h, w, generator=gen, device="cuda")
    if bf16:
        feat = feat.bfloat16().float()
    tmpl = torch.randn(b, c, t, t, generator=gen, device="cuda")
    got = cuda_xcorr.xcorr(feat, tmpl)
    want = cuda_xcorr.xcorr_plain(feat, tmpl)
    torch.cuda.synchronize()
    r = dict(err=(got - want).abs().max().item(),
             tol=XCORR_REL_TOL * want.abs().max().item(),
             ms=cuda_ms(lambda: cuda_xcorr.xcorr(feat, tmpl)), plain_ms=None, lib_ms=None)
    if yardsticks:
        r["plain_ms"] = cuda_ms(lambda: cuda_xcorr.xcorr_plain(feat, tmpl), reps=1,
                                warmup=0)
        r["lib_ms"] = cuda_ms(lambda: F.conv2d(feat.view(1, b * c, h, w),
                                               tmpl.view(b * c, 1, t, t), padding=t // 2,
                                               groups=b * c))
    flops = 2.0 * b * c * h * w * t * t
    nbytes = (2 * b * c * h * w + b * c * t * t) * 4
    r["tensor_bound"] = bound(3 * flops, nbytes, PEAK_TF32_FLOPS)
    r["f32_bound"] = bound(flops, nbytes, PEAK_F32_FLOPS)
    return r


def check_xcorr_maps(torch, F, cuda_xcorr) -> None:
    """The f32 correlation against its plain version on XCORR_MAPS."""
    for b, c, h, w, ts, bf16 in XCORR_MAPS:
        for t in ts:
            r = check_xcorr(torch, F, cuda_xcorr, t, SEED, (b, c, h, w), bf16, False)
            what = f"xcorr {b}x{c}x{h}x{w}{' bf16 feature' if bf16 else ''} T={t}"
            print(f"kernel {what}: max_err {r['err']:.3e} tol {r['tol']:.3e} kernel_ms "
                  f"{r['ms']:.4f} bound_ms {r['tensor_bound'][0]:.4f} (3xTF32)", flush=True)
            if not r["err"] <= r["tol"]:
                fail(f"{what} disagrees with its plain version: {r['err']} > {r['tol']}")
    # non-finite inputs: every output the plain version makes non-finite is NaN or
    # infinite from the kernel too (which spreads them over the band), the rest agree
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    feat = torch.randn(1, 7, 100, 76, generator=gen, device="cuda")
    feat[0, 1, 40, 30], feat[0, 4, 3, 70], feat[0, 6, 99, 0] = math.nan, math.inf, -math.inf
    tmpl = torch.randn(1, 7, 9, 9, generator=gen, device="cuda")
    got, want = cuda_xcorr.xcorr(feat, tmpl), cuda_xcorr.xcorr_plain(feat, tmpl)
    lost = int((~want.isfinite() & got.isfinite()).sum().item())
    both = got.isfinite() & want.isfinite()
    err = (got - want)[both].abs().max().item()
    tol = XCORR_REL_TOL * want[both].abs().max().item()
    print(f"kernel xcorr 1x7x100x76 T=9, a NaN and two infinities planted: non-finite "
          f"outputs {int((~want.isfinite()).sum())} plain, {int((~got.isfinite()).sum())} "
          f"kernel, {lost} lost (must be 0); max_err where both are finite {err:.3e} tol "
          f"{tol:.3e}", flush=True)
    if lost or not err <= tol:
        fail("xcorr loses a non-finite output or disagrees beside one")


def int8_xcorr_inputs(torch, shape, t: int, seed: int, extreme: bool = False):
    """(feature, template, f_scale, t_scale) of the int8 correlation: int8 values drawn
    over [-128, 127], or with ``extreme`` from {-128, -127, 127} only (full magnitude of
    both signs; -128 never comes from the quantizer but the kernel takes any int8)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    b, c, h, w = shape

    def i8(*dims):
        if extreme:
            vals = torch.tensor([-128, -127, 127], dtype=torch.int8, device="cuda")
            return vals[torch.randint(0, 3, dims, generator=gen, device="cuda")]
        return torch.randint(-128, 128, dims, generator=gen, device="cuda",
                             dtype=torch.int8)

    feat, tmpl = i8(b, c, h, w), i8(b, c, t, t)
    fs = torch.rand(b, c, 1, 1, generator=gen, device="cuda") * 0.01 + 1e-4
    ts = torch.rand(b, c, 1, 1, generator=gen, device="cuda") * 0.01 + 1e-4
    return feat, tmpl, fs, ts


def check_xcorr_int8(torch, F, cuda_xcorr, _build, t: int, seed: int,
                     shape=(4, 512, 128, 128), extreme: bool = False,
                     yardsticks: bool = True) -> dict:
    """The int8 correlation vs its int32 plain version: the sums are exact in both, so
    the f32 results must be equal (0 mismatches). With ``yardsticks``: timed in turns
    with the CUDA-core kernel it replaced (``tmr_xcorr_int8_cuda_cores``, same inputs,
    its mismatches counted too), beside the plain version and the library yardstick, a
    float64 grouped ``F.conv2d`` of the int8 values (the sums stay below 2^53, so it is
    exact too) and the same epilogue. Bounds: the function's (the map in and out once,
    the useful products at the int8 peak) and the band's (the products the kernel
    performs, the band's depth per output and template row)."""
    b, c, h, w = shape
    feat, tmpl, fs, ts = int8_xcorr_inputs(torch, shape, t, seed, extreme)
    got = cuda_xcorr.xcorr_int8(feat, tmpl, fs, ts)
    want = cuda_xcorr.xcorr_int8_plain(feat, tmpl, fs, ts)
    torch.cuda.synchronize()
    r = dict(mism=int((got != want).sum().item()), err=(got - want).abs().max().item())
    del want
    kernel = lambda: cuda_xcorr.xcorr_int8(feat, tmpl, fs, ts)  # noqa: E731
    if not yardsticks:
        r["ms"] = cuda_ms(kernel)
        return r
    old_fn = _build.lib("xcorr").tmr_xcorr_int8_cuda_cores
    stream = _build.stream_of(feat)

    def old():
        out = torch.empty(feat.shape, dtype=torch.float32, device="cuda")
        rc = old_fn(feat.data_ptr(), tmpl.data_ptr(), fs.data_ptr(), ts.data_ptr(),
                    out.data_ptr(), b * c, h, w, t, stream)
        if rc:
            fail(f"tmr_xcorr_int8_cuda_cores: CUDA error {rc} at launch")
        return out

    r["old_mism"] = int((old() != got).sum().item())
    ms, old_ms = [], []
    for fn, dst in ((kernel, ms), (old, old_ms), (old, old_ms), (kernel, ms)):
        dst.append(cuda_ms(fn))
    r.update(ms=min(ms), ms_turns=ms, old_ms=min(old_ms), old_turns=old_ms)
    r["plain_ms"] = cuda_ms(lambda: cuda_xcorr.xcorr_int8_plain(feat, tmpl, fs, ts), reps=1,
                            warmup=0)

    def library():
        acc = F.conv2d(feat.view(1, b * c, h, w).double(),
                       tmpl.view(b * c, 1, t, t).double(), padding=t // 2, groups=b * c)
        return acc.view(b, c, h, w).float() * (fs * ts)

    r["lib_mism"] = int((library() != got).sum().item())
    r["lib_ms"] = cuda_ms(library, reps=3, warmup=1)
    depth = cuda_xcorr.int8_geometry(t)["depth"]
    nbytes = b * c * h * w * (1 + 4) + b * c * t * t + 2 * b * c * 4
    r["bound"] = bound(2.0 * b * c * h * w * t * t, nbytes, PEAK_INT8_OPS)
    r["band_bound"] = bound(2.0 * b * c * h * w * depth * t, nbytes, PEAK_INT8_OPS)
    return r


#: other maps of the int8 correlation, (B, C, H, W, extreme values): ragged maps whose
#: rows are not 16-byte aligned (staged bytewise), and a map of -128/-127/127 only
XCORR_INT8_MAPS = ((1, 7, 100, 76, False), (1, 3, 37, 53, False), (2, 4, 64, 64, True))


def int8_mm_inputs(torch, kind: str, seed: int):
    """(x_q, w_q, x_scale, w_scale) of one int8_mm shape: a 3x3 tap
    of the stacks' first layer (its shifted window of the padded activation, as the tail
    passes it), the block-diagonal heads, or a ragged shape."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def i8(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device="cuda",
                             dtype=torch.int8)

    def scales(*shape):
        return torch.rand(*shape, generator=gen, device="cuda") * 0.01 + 1e-4

    if kind == "tap":  # M = 4 * 128^2, K = 1024, N = 2048
        x = i8(4, 130, 130, 1024)[:, 1:129, 2:130, :]
        sx = scales(4)[:, None, None].expand(4, 128, 128).contiguous()
        w, sw = i8(2048, 1024), scales(2048)
    elif kind == "head":  # M = 4 * 128^2, K = 2048, N = 5
        x = i8(4, 128, 128, 2048)
        sx = scales(4)[:, None, None].expand(4, 128, 128).contiguous()
        w, sw = i8(5, 2048), scales(5)
    else:  # ragged M, N and a K that is not a multiple of 16
        x, sx, w, sw = i8(1000, 1000), scales(1000), i8(200, 1000), scales(200)
    return x, w, sx, sw


def check_int8_mm(torch, cuda_int8, kind: str, seed: int):
    """int8_mm vs its plain version (exact int32 sums, the same epilogue): equal bit for
    bit. The library yardstick is ``torch._int_mm`` times the broadcast row and column
    scales, on a contiguous copy of x (it takes no strided rows); the bare ``_int_mm``
    (int32 out) is timed beside it. None where its shape rules refuse (N must be a
    multiple of 8)."""
    x, w, sx, sw = int8_mm_inputs(torch, kind, seed)
    got = cuda_int8.int8_mm(x, w, sx, sw)
    want = cuda_int8.int8_mm_plain(x, w, sx, sw)
    torch.cuda.synchronize()
    mism = int((got != want).sum().item())
    err = (got - want).abs().max().item()
    ms = cuda_ms(lambda: cuda_int8.int8_mm(x, w, sx, sw))
    plain_ms = cuda_ms(lambda: cuda_int8.int8_mm_plain(x, w, sx, sw), reps=1, warmup=0)
    n, k = w.shape
    m = sx.numel()
    lib_ms = bare_ms = None
    if n % 8 == 0 and k % 8 == 0 and m > 16:
        x2, wt = x.reshape(m, k).contiguous(), w.t()
        sx2, sw2 = sx.reshape(m, 1), sw.reshape(1, n)
        lib_ms = cuda_ms(lambda: torch._int_mm(x2, wt) * sx2 * sw2)
        bare_ms = cuda_ms(lambda: torch._int_mm(x2, wt))
    ops = 2.0 * m * n * k
    nbytes = m * k + n * k + 4 * (m + n) + 4 * m * n
    return ((m, n, k), mism, err, ms, plain_ms, lib_ms, bare_ms,
            bound(ops, nbytes, PEAK_INT8_OPS))


def sass_opcodes(lib_path, kernel: str, opcode: str):
    """{function: count} of the SASS instructions starting with ``opcode`` in each function
    of the library whose name contains ``kernel`` (``cuobjdump -sass``), or None where the
    toolkit has no ``cuobjdump``."""
    tool = Path("/usr/local/cuda/bin/cuobjdump")
    if not tool.exists():
        return None
    sass = subprocess.run([str(tool), "-sass", str(lib_path)], capture_output=True, text=True,
                          timeout=300).stdout
    counts = {}
    for part in sass.split("Function : ")[1:]:
        name, body = part.split("\n", 1)
        if kernel in name:
            # an instruction line: /*addr*/ [@predicate] OPCODE.modifiers operands ; /*code*/
            counts[name.strip()] = sum(
                1 for line in body.splitlines()
                if re.match(rf"\s*/\*[0-9a-f]+\*/\s*(@!?U?P\w+\s+)?{opcode}\b", line))
    return counts


def ptxas_info(log, kernel: str) -> str:
    """Registers, shared memory and spills that ``-Xptxas -v`` reported for ``kernel``."""
    if not log:
        return "not rebuilt in this run"
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and kernel in line:
            return " | ".join(x.split(":", 1)[-1].strip() for x in lines[i + 1:i + 4]
                              if "bytes" in x or "Used" in x)
    return "not in the log"


def check_int8_conv(torch, F, cuda_int8, shape, seed: int) -> dict:
    """The fused 3x3 layer vs its plain version on random int8 operands: exact int32
    sums and the same f32 steps, so equal bit for bit (0 mismatches). Timed in turns
    with the composition it replaces on the int8 path (9 ``int8_mm`` launches on the
    zero-padded activation, the f32 tap adds, the bias and ``leaky_relu``; its
    mismatches against the kernel are counted too). The rate yardstick is the bare
    ``torch._int_mm`` of the im2col'd product, (B H W x 9 C_in) . (9 C_in x N): not the
    same function (no per-tap scales), None where its shape rules refuse."""
    b, h, w, c, n = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    xq = torch.randint(-127, 128, (b, h, w, c), generator=gen, device="cuda",
                       dtype=torch.int8)
    wq = torch.randint(-127, 128, (3, 3, n, c), generator=gen, device="cuda",
                       dtype=torch.int8)
    sx = torch.rand(b, generator=gen, device="cuda") * 0.01 + 1e-4
    sw = torch.rand(3, 3, n, generator=gen, device="cuda") * 0.01 + 1e-4
    bias = torch.randn(n, generator=gen, device="cuda") * 0.1
    slope = 0.01

    def kernel():
        return cuda_int8.int8_conv3x3(xq, sx, wq, sw, bias, slope)

    def composition():
        xp = F.pad(xq, (0, 0, 1, 1, 1, 1))
        rows = sx[:, None, None].expand(b, h, w).contiguous()
        acc = None
        for dy in range(3):
            for dx in range(3):
                tap = cuda_int8.int8_mm(xp[:, dy:dy + h, dx:dx + w], wq[dy, dx], rows,
                                        sw[dy, dx])
                acc = tap if acc is None else acc.add_(tap)
        return F.leaky_relu(acc + bias, slope)

    got = kernel()
    want = cuda_int8.int8_conv3x3_plain(xq, sx, wq, sw, bias, slope)
    comp = composition()
    torch.cuda.synchronize()
    r = dict(mism=int((got != want).sum().item()), err=(got - want).abs().max().item(),
             comp_mism=int((comp != got).sum().item()), negative=(got < 0).float().mean()
             .item())
    reps = 10 if b * h * w > 4096 else 50
    ms, comp_ms = [], []
    for fn, dst in ((kernel, ms), (composition, comp_ms), (composition, comp_ms),
                    (kernel, ms)):
        dst.append(cuda_ms(fn, reps=reps))
    r.update(ms=min(ms), ms_turns=ms, comp_ms=min(comp_ms), comp_turns=comp_ms,
             plain_ms=cuda_ms(lambda: cuda_int8.int8_conv3x3_plain(xq, sx, wq, sw, bias,
                                                                   slope), reps=1, warmup=0))
    m = b * h * w
    r["bare_ms"] = None
    if n % 8 == 0 and c % 8 == 0 and m > 16:
        xp = F.pad(xq, (0, 0, 1, 1, 1, 1))
        cols = torch.cat([xp[:, dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)],
                         dim=-1).reshape(m, 9 * c)
        wt = wq.permute(2, 0, 1, 3).reshape(n, 9 * c).t()
        r["bare_ms"] = cuda_ms(lambda: torch._int_mm(cols, wt))
        del cols
    ops = 2.0 * m * n * 9 * c
    nbytes = m * c + 9 * n * c + 4 * (b + 9 * n + n) + 4 * m * n
    r["bound"] = bound(ops, nbytes, PEAK_INT8_OPS)
    return r


def nms_inputs(torch, seed: int, b: int = 4, n: int = 2000):
    """Dense overlapping boxes with planted ties: identical boxes with tied scores, and
    pairs at IoU exactly 0.5 (kept: the rule is strict)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    cxy = rng.uniform(0.2, 0.5, (b, n, 2))
    wh = rng.uniform(0.02, 0.15, (b, n, 2))
    boxes = np.concatenate([cxy - wh / 2, cxy + wh / 2], -1).astype(np.float32)
    scores = rng.uniform(0.3, 1.0, (b, n)).astype(np.float32)
    boxes[:, 100:150] = boxes[:, 50:100]  # identical boxes ...
    scores[:, 100:150] = scores[:, 50:100]  # ... with tied scores
    boxes[:, 200:250] = np.array([0.0, 0.0, 0.5, 0.25], np.float32)  # area 1/8
    boxes[:, 250:300] = np.array([0.0, 0.0, 0.25, 0.25], np.float32)  # IoU 0.5 with it
    valid = rng.uniform(size=(b, n)) > 0.1
    return (torch.as_tensor(boxes), torch.as_tensor(scores), torch.as_tensor(valid))


def check_nms(torch, cuda_nms, thr: float, seed: int):
    boxes, scores, valid = nms_inputs(torch, seed)
    order = torch.sort(torch.where(valid, scores, torch.full_like(scores, -math.inf)),
                       dim=1, descending=True, stable=True).indices
    sb = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4)).cuda()
    sv = torch.gather(valid, 1, order).cuda()
    got = cuda_nms.greedy_keep_sorted(sb, sv, thr)
    want = cuda_nms.greedy_keep_sorted_plain(sb, sv, thr)
    want_cpu = cuda_nms.greedy_keep_sorted_plain(sb.cpu(), sv.cpu(), thr)
    torch.cuda.synchronize()
    mismatches = int((got != want).sum().item()) + int((got.cpu() != want_cpu).sum().item())
    ms = cuda_ms(lambda: cuda_nms.greedy_keep_sorted(sb, sv, thr))
    plain_ms = cuda_ms(lambda: cuda_nms.greedy_keep_sorted_plain(sb, sv, thr),
                       reps=1, warmup=0)
    # operations this data needs: one ~12-flop IoU per (kept i, later j) pair
    keep = want_cpu.numpy()
    n = keep.shape[1]
    pairs = sum(int((n - 1 - keep_i.nonzero()[0]).sum()) for keep_i in keep)
    nbytes = sb.numel() * 4 + sv.numel() * 4 * 2
    return mismatches, int(want_cpu.sum()), ms, plain_ms, bound(12.0 * pairs, nbytes,
                                                                PEAK_F32_FLOPS)


def synthetic_batch(np, rng, side_px: int, b: int = 4, size: int = 1024):
    """Dark noisy images with bright squares of ``side_px``; exemplar = the first."""
    imgs = rng.normal(-1.0, 0.1, (b, size, size, 3)).astype(np.float32)
    exemplars = np.zeros((b, 1, 4), np.float32)
    cells = (size - side_px) // 8
    for i in range(b):
        for j in range(6):
            y, x = (rng.integers(0, cells, 2) * 8).tolist()
            imgs[i, y:y + side_px, x:x + side_px] = 2.0
            if j == 0:
                exemplars[i, 0] = [x / size, y / size, (x + side_px) / size,
                                   (y + side_px) / size]
    return imgs, exemplars


def profile_batch(torch, pred, imgs, ex) -> None:
    """torch.profiler over one batch: device time by kernel name and the device's busy
    share of the batch's wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pred(imgs, ex)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms, count = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, count + 1)
    busy_ms = sum(ms for ms, _ in by_name.values())
    path = "int8 path" if pred.cfg.quant != "off" else "main path"
    print(f"profile {path} (one batch of 4, bucket 33): wall {wall_ms:.1f} ms, device kernel "
          f"time {busy_ms:.1f} ms, busy share {busy_ms / wall_ms:.3f}", flush=True)
    for name, (ms, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:25]:
        print(f"profile  {ms:9.3f} ms  x{count:<5d} {name[:110]}", flush=True)


def check_kernels(torch, F, cuda_attn, cuda_xcorr, cuda_nms, cuda_int8,
                  thr: float) -> dict:
    """Each kernel at the main path's shapes against its plain version; returns the
    kernels line's entries (all but the launch counts)."""
    from tmr_tpu_torch.ops import _build

    entries = {}
    for name, windowed, has_bias, grid in (("global_attn", False, True, (64, 64)),
                                           ("global_attn_nobias", False, False, (64, 64)),
                                           ("window_attn", True, True, (14, 14))):
        acc, t, (bms, bby) = check_attention(torch, F, cuda_attn, windowed, has_bias, SEED,
                                             grid)
        print(f"kernel {name}: {attn_accuracy(acc)} {attn_times(t)} bound_ms {bms:.4f} "
              f"({bby})", flush=True)
        if not acc["ok"]:
            fail(f"{name} disagrees with its plain version: {acc}")
        entries[name] = dict(max_abs_err=acc["max_abs_err"], ms=t["ms"],
                             plain_ms=t["plain_ms"], bound_ms=bms, bound_by=bby,
                             library_ms=t["lib_ms"])
    check_global_grids(torch, F, cuda_attn)
    # the windowed kernel at 7x7 windows (8-slot key rows, a pad key row, 64 query rows)
    # and 16x16 (full 16-slot key rows, one CTA per SM)
    for grid in ((7, 7), (16, 16)):
        acc, t, (bms, _) = check_attention(torch, F, cuda_attn, True, True, SEED, grid)
        print(f"kernel window_attn {grid[0]}x{grid[1]} windows: {attn_accuracy(acc)} "
              f"{attn_times(t)} bound_ms {bms:.4f}", flush=True)
        if not acc["ok"]:
            fail(f"window_attn at {grid} windows disagrees with its plain version: {acc}")
    for t in XCORR_TS:
        r = check_xcorr(torch, F, cuda_xcorr, t, SEED)
        (bms, bby), (f32ms, f32by) = r["tensor_bound"], r["f32_bound"]
        print(f"kernel xcorr T={t}: max_err {r['err']:.3e} tol {r['tol']:.3e} kernel_ms "
              f"{r['ms']:.4f} plain_ms {r['plain_ms']:.4f} library_ms {r['lib_ms']:.4f} "
              f"(grouped F.conv2d) bound_ms {bms:.4f} ({bby}, 3xTF32 at the TF32 peak) "
              f"f32_bound_ms {f32ms:.4f} ({f32by}, f32 CUDA cores)", flush=True)
        if not r["err"] <= r["tol"]:
            fail(f"xcorr T={t} disagrees with its plain version: {r['err']} > {r['tol']}")
        if t == 33:
            entries["xcorr"] = dict(max_abs_err=r["err"], ms=r["ms"],
                                    plain_ms=r["plain_ms"], bound_ms=bms, bound_by=bby,
                                    library_ms=r["lib_ms"])
    check_xcorr_maps(torch, F, cuda_xcorr)
    mism, kept, ms, plain_ms, (bms, bby) = check_nms(torch, cuda_nms, thr, SEED)
    print(f"kernel nms: keep mismatches {mism} (must be 0), kept {kept} of 4x2000, "
          f"kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms null "
          f"bound_ms {bms:.6f} ({bby})", flush=True)
    if mism:
        fail(f"nms keep masks differ from the plain version in {mism} slots")
    entries["nms"] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                          bound_by=bby, library_ms=None)
    for kb in (1, 2, 3):
        for k16 in (0, 1):
            info = ptxas_info(_build.LOGS.get("xcorr"), f"xcorr_int8_kernelILi{kb}ELb{k16}E")
            print(f"ptxas xcorr_int8_kernel<{kb}, {bool(k16)}>: {info}", flush=True)
    # the products are tensor-core s8 MMAs: IMMA in the SASS of every instantiation
    imma = sass_opcodes(_build._lib_path("xcorr"), "xcorr_int8_kernel", "IMMA")
    if imma is None:
        print("sass xcorr_int8_kernel: cuobjdump not found, IMMA not counted", flush=True)
    else:
        print(f"sass xcorr_int8_kernel IMMA per instantiation: "
              f"{json.dumps(sorted(imma.values()))}", flush=True)
        if len(imma) != 6 or not all(imma.values()):
            fail(f"xcorr_int8_kernel: expected IMMA in all 6 instantiations, got {imma}")
    for t in XCORR_TS:
        r = check_xcorr_int8(torch, F, cuda_xcorr, _build, t, SEED)
        (bms, bby), (band_ms, band_by) = r["bound"], r["band_bound"]
        turns = lambda v: " ".join(f"{x:.4f}" for x in v)  # noqa: E731
        print(f"kernel xcorr_int8 T={t}: mismatches {r['mism']} (must be 0), max_err "
              f"{r['err']:.3e} kernel_ms {r['ms']:.4f} (turns {turns(r['ms_turns'])}) "
              f"replaced CUDA-core kernel_ms {r['old_ms']:.4f} (turns "
              f"{turns(r['old_turns'])}; {r['old_mism']} mismatches) plain_ms "
              f"{r['plain_ms']:.4f} library_ms {r['lib_ms']:.4f} (float64 grouped F.conv2d "
              f"+ scales, {r['lib_mism']} mismatches) bound_ms {bms:.4f} ({bby}, int8 peak) "
              f"band_bound_ms {band_ms:.4f} ({band_by}, the band's performed products)",
              flush=True)
        if r["mism"] or r["old_mism"]:
            fail(f"xcorr_int8 T={t} differs from its plain version in {r['mism']} outputs "
                 f"and from the replaced kernel in {r['old_mism']}")
        if t == 33:
            entries["xcorr_int8"] = dict(max_abs_err=r["err"], ms=r["ms"],
                                         plain_ms=r["plain_ms"], bound_ms=bms, bound_by=bby,
                                         library_ms=r["lib_ms"])
    for b, c, h, w, extreme in XCORR_INT8_MAPS:
        for t in XCORR_TS:
            r = check_xcorr_int8(torch, F, cuda_xcorr, _build, t, SEED, (b, c, h, w),
                                 extreme, False)
            what = f"xcorr_int8 {b}x{c}x{h}x{w}{' -128/-127/127 only' if extreme else ''} T={t}"
            print(f"kernel {what}: mismatches {r['mism']} (must be 0), max_err "
                  f"{r['err']:.3e} kernel_ms {r['ms']:.4f}", flush=True)
            if r["mism"]:
                fail(f"{what} differs from its plain version in {r['mism']} outputs")
    for kind in ("tap", "head", "ragged"):
        (m, n, k), mism, err, ms, plain_ms, lib_ms, bare_ms, (bms, bby) = check_int8_mm(
            torch, cuda_int8, kind, SEED)
        lib, bare = ("null" if v is None else f"{v:.4f}" for v in (lib_ms, bare_ms))
        print(f"kernel int8_mm {kind} M={m} N={n} K={k}: mismatches {mism} (must be 0), "
              f"max_err {err:.3e} kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} "
              f"library_ms {lib} (torch._int_mm x scales; bare _int_mm {bare}) "
              f"bound_ms {bms:.4f} ({bby})", flush=True)
        if mism:
            fail(f"int8_mm {kind} differs from its plain version in {mism} outputs")
        if kind == "head":  # the int8 path's one launch of it per batch
            entries["int8_mm"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                      bound_ms=bms, bound_by=bby, library_ms=lib_ms)
    print(f"ptxas int8_conv3x3_kernel: {ptxas_info(_build.LOGS.get('int8_mm'), 'int8_conv')}",
          flush=True)
    for shape in INT8_CONV_SHAPES:
        r = check_int8_conv(torch, F, cuda_int8, shape, SEED)
        (bms, bby), bare = r["bound"], r["bare_ms"]
        turns = lambda v: " ".join(f"{x:.4f}" for x in v)  # noqa: E731
        print(f"kernel int8_conv3x3 {'x'.join(map(str, shape[:4]))} -> {shape[4]}: "
              f"mismatches {r['mism']} (must be 0), max_err {r['err']:.3e}, negative share "
              f"{r['negative']:.3f}; kernel_ms {r['ms']:.4f} (turns {turns(r['ms_turns'])}) "
              f"replaced composition_ms {r['comp_ms']:.4f} (turns {turns(r['comp_turns'])}; "
              f"9 int8_mm + f32 adds + bias + leaky_relu, {r['comp_mism']} mismatches) "
              f"plain_ms {r['plain_ms']:.4f} bare _int_mm over the im2col'd product "
              f"{'null' if bare is None else f'{bare:.4f}'} (not the same function: no "
              f"per-tap scales) bound_ms {bms:.4f} ({bby}, int8 peak)", flush=True)
        if r["mism"] or r["comp_mism"]:
            fail(f"int8_conv3x3 at {shape} differs from its plain version in {r['mism']} "
                 f"outputs and from the composition in {r['comp_mism']}")
        if shape == INT8_CONV_SHAPES[0]:
            entries["int8_conv"] = dict(max_abs_err=r["err"], ms=r["ms"],
                                        plain_ms=r["plain_ms"], bound_ms=bms, bound_by=bby,
                                        library_ms=None)
    return entries


def profiled_device_ms(torch, fn, reps: int = 20):
    """Device time per call of ``fn`` from torch.profiler's kernel records, or None when
    the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    return us / 1e3 / reps if us > 0 else None


def host_us(torch, fn, reps: int = 200) -> float:
    """Host time per call of ``fn`` (its enqueue: no synchronize inside the window)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def run_probe(torch, probe, _build) -> dict:
    """The toolchain probe: add1 on a 256^2 f32 block, the first kernel of the run. Its
    event-bracketed time (10 launches back to back) is printed beside its device time
    from the profiler and the host's cost per launch, its own and torch.add's, so the
    gap to torch.add reads as host or device time."""
    _build.reset_launches()
    x = torch.zeros(256, 256, device="cuda")
    y = probe.add1(x)
    torch.cuda.synchronize()
    launches = _build.LAUNCHES["add1"]
    mism = int((y != probe.add1_plain(x)).sum().item())
    if mism or launches != 1:
        fail(f"add1 probe: {mism} mismatches, {launches} launches")
    ms = cuda_ms(lambda: probe.add1(x))
    plain_ms = cuda_ms(lambda: probe.add1_plain(x))
    lib_ms = cuda_ms(lambda: torch.add(x, 1.0))
    out = torch.empty_like(x)
    args = (x.data_ptr(), out.data_ptr(), x.numel(), _build.stream_of(x))

    def unbound():  # each launch looks its C function up again, under lib()'s lock
        _build._FNS.clear()
        probe.add1(x)

    # host cost per call, in turns over 3 rounds (median): the wrapper, the wrapper with
    # the lookup of the C function each launch, torch.add, and the wrapper's parts
    calls = {"wrapper": lambda: probe.add1(x), "wrapper_lookup_each": unbound,
             "torch_add": lambda: torch.add(x, 1.0),
             "stream_lookup": lambda: _build.stream_of(x),
             "empty_like": lambda: torch.empty_like(x),
             "c_call": lambda: _build.launch("add1", "probe", "tmr_add1", *args)}
    rounds = {name: [] for name in calls}
    for _ in range(3):
        for name, fn in calls.items():
            rounds[name].append(host_us(torch, fn))
    host = {name: sorted(v)[1] for name, v in rounds.items()}
    dev, lib_dev = (profiled_device_ms(torch, fn)
                    for fn in (lambda: probe.add1(x), lambda: torch.add(x, 1.0)))
    bms, bby = bound(float(x.numel()), 2.0 * x.numel() * 4, PEAK_F32_FLOPS)
    dev_s, lib_dev_s = ("not measured" if v is None else f"{v:.4f}" for v in (dev, lib_dev))
    print(f"probe add1 256x256: mismatches 0, kernel_ms {ms:.4f} (events, 10 launches back "
          f"to back) device_ms {dev_s} (profiler) plain_ms {plain_ms:.4f} library_ms "
          f"{lib_ms:.4f} (torch.add; device_ms {lib_dev_s}) bound_ms {bms:.6f} ({bby})",
          flush=True)
    print("probe host_us per call (median of 3 rounds in turns): "
          + ", ".join(f"{name} {us:.2f}" for name, us in host.items()), flush=True)
    return dict(launches=launches, max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                bound_ms=bms, bound_by=bby, library_ms=lib_ms)


def run_batches(torch, pred, batches, detections_to_numpy, _build):
    """One warm-up batch, then the launch counts reset and the batches timed."""
    pred(*batches[0])  # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()
    _build.reset_launches()
    times, outs = [], []
    for imgs, ex in batches:
        t0 = time.perf_counter()
        dets = pred(imgs, ex)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        outs.append(detections_to_numpy(dets))
    return times, outs, dict(_build.LAUNCHES)


def report_batches(np, name, caps, times, outs, card):
    for i, per_img in enumerate(outs):
        counts = [len(d["boxes"]) for d in per_img]
        print(f"{name} batch {i} (bucket {caps[i]}): detections per image {counts}, "
              f"{times[i]:.1f} ms, {4e3 / times[i]:.2f} img/s [{card}]", flush=True)
        for d in per_img:
            if not (np.isfinite(d["boxes"]).all() and np.isfinite(d["scores"]).all()):
                fail(f"{name}: non-finite detections")
    print(f"{name}: {sum(times) / len(times):.1f} ms per batch of 4 "
          f"(mean of 3), {4e3 * len(times) / sum(times):.2f} img/s, "
          f"steady (batches 1-2) {sum(times[1:]) / 2:.1f} ms [{card}]", flush=True)


def int8_tier(torch, np, fused_heads, h: int = 128, c: int = 1024) -> float:
    """The output tier of the int8 arm as ``tmr_tpu/ops/quant.py`` quant_int8dot_ok
    defines it, at the production geometry: the stored-int8 tail with the int8 kernels
    vs the exact fused tail, max abs error over both maps / their max."""
    from tmr_tpu_torch.ops.quant import quantize_conv

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((1, h, h, c)).astype(np.float32))
    x = x.cuda().bfloat16()

    def kernel(*shape):  # HWIO draws, as the JAX tier makes them, then OIHW
        w = (rng.standard_normal(shape) * 0.01).astype(np.float32)
        return torch.from_numpy(w).permute(3, 2, 0, 1).contiguous().cuda()

    wo, wb, w1, w4 = kernel(3, 3, c, c), kernel(3, 3, c, c), kernel(1, 1, c, 1), kernel(
        1, 1, c, 4)
    exact, stored = [], []
    for w, n in zip((wo, wb, w1, w4), (c, c, 1, 4)):
        bias = torch.zeros(n, device="cuda")
        q, scale = quantize_conv(w)
        exact.append((w, bias))
        stored.append((q, bias, scale))
    with torch.inference_mode():
        oe, re = fused_heads.fused_decoder_heads(x, [exact[0]], [exact[1]], exact[2],
                                                 exact[3], dtype=torch.bfloat16)
        oq, rq = fused_heads.fused_decoder_heads(x, [stored[0]], [stored[1]], stored[2],
                                                 stored[3], dtype=torch.bfloat16,
                                                 quant="stored", kernel_arm="int8")
    scale = max(oe.abs().max().item(), re.abs().max().item())
    return max((oq - oe).abs().max().item(), (rq - re).abs().max().item()) / scale


def int8_arm_on_fcat(torch, pred, qpred, f_cat, fused_heads) -> None:
    """The int8 arm on image 0 of this run's ``f_cat``: the statistics of each half (the
    per-image int8 step is amax / 127), and the int8 tail vs the exact fused tail of
    phase 4's f32 weights, on the objectness map alone and over both maps (the tier's
    measure). Printed, not held to a limit: the JAX function reads the same on such
    inputs (tests/test_torch_quant.py)."""
    x = f_cat[:1].permute(0, 2, 3, 1)
    xf = x.float()
    half = xf.shape[-1] // 2
    for name, v in (("projection", xf[..., :half]), ("matcher", xf[..., half:])):
        sd = v.std(dim=(0, 1, 2))
        print(f"f_cat image 0, {name} half: amax {v.abs().max().item():.3f}, amax/std "
              f"{(v.abs().max() / v.std()).item():.2f}, channel offsets rms "
              f"{v.mean(dim=(0, 1, 2)).pow(2).mean().sqrt().item():.3f}, spatial std per "
              f"channel mean {sd.mean().item():.3f} max {sd.max().item():.3f}", flush=True)
    with torch.inference_mode():
        oe, re = fused_heads.fused_decoder_heads(x, *pred.model._tail_params(),
                                                 dtype=pred.model.compute_dtype)
        q = qpred.model.heads(f_cat[:1])
    d_obj = (q["objectness"] - oe[..., 0]).abs().max().item()
    d_reg = (q["regressions"] - re).abs().max().item()
    obj_max = oe.abs().max().item()
    both = max(d_obj, d_reg) / max(obj_max, re.abs().max().item())
    print(f"int8 tail vs the exact fused tail on that f_cat, same weights: objectness map "
          f"{d_obj / obj_max:.4f} of its max, both maps {both:.4f} (the tier's measure)",
          flush=True)


def check_quant_path(torch, np, pred, batches, caps, obj, reg, card, modules) -> dict:
    """Phase 4b: the int8-storage path on phase 4's weights."""
    from tmr_tpu_torch.config import preset
    from tmr_tpu_torch.inference import Predictor, detections_to_numpy

    _build, cuda_int8, fused_heads = modules
    qcfg = preset("TMR_FSCD147", quant="int8", quant_storage="int8", quant_kernel="int8")
    qpred = Predictor(qcfg, device="cuda")
    qpred.load_state_dict(pred.model.state_dict())
    stamp = qpred.quant_stamp()
    print(f"int8 storage: {stamp['quantized_leaves']} kernels, {stamp['weight_bytes']} "
          f"int8 bytes for {stamp['f32_weight_bytes']} f32 bytes", flush=True)
    times, outs, launches = run_batches(torch, qpred, batches, detections_to_numpy, _build)
    report_batches(np, "int8 path", caps, times, outs, card)
    print(f"int8 path launches over the 3 batches: {json.dumps(launches)}", flush=True)
    if launches != QUANT_LAUNCHES:
        fail(f"int8 path launches {launches}, expected {QUANT_LAUNCHES}")

    imgs, ex = batches[0]
    scale = obj.abs().max().item()
    qout = qpred.forward(imgs, ex)
    qobj = qout["objectness"][0].float().cpu()
    rel = (qobj - obj).abs().max().item() / scale
    both = max((qobj - obj).abs().max().item(),
               (qout["regressions"][0].float().cpu() - reg).abs().max().item())
    both /= max(scale, reg.abs().max().item())
    dcfg = preset("TMR_FSCD147", quant="int8", quant_storage="int8")
    dpred = Predictor(dcfg, device="cuda")
    dpred.load_state_dict(pred.model.state_dict())
    drel = (dpred.forward(imgs, ex)["objectness"][0].float().cpu() - obj).abs().max().item()
    drel /= scale
    del dpred
    print(f"objectness image 0 vs the bf16 path, max_abs_diff / map max {scale:.4e}: int8 "
          f"path {rel:.4f} (bound {INT8_PATH_OBJ_BOUND}; over both maps, the tier's "
          f"measure, {both:.4f}), stored weights with the dequant arm {drel:.4f} (tier "
          f"{QUANT_TIER_REL})", flush=True)
    if not (torch.isfinite(qobj).all() and qobj.shape == (128, 128)
            and rel <= INT8_PATH_OBJ_BOUND):
        fail("int8 path objectness map is not finite or far from the bf16 path's")
    if not drel <= QUANT_TIER_REL:
        fail("the stored-weight path's objectness is outside the output tier")
    tier = int8_tier(torch, np, fused_heads)
    print(f"int8 tail vs the exact tail on the tier's inputs (quant_int8dot_ok: 1 x 128^2 x "
          f"1024 normal bf16 input, N(0, 0.01) weights): rel {tier:.4f} (tier "
          f"{QUANT_TIER_REL})", flush=True)
    if not 0 < tier < QUANT_TIER_REL:
        fail("the int8 tail is outside the output tier at the production geometry")

    with torch.inference_mode():
        image, exemplars, cap = qpred._inputs(imgs, ex)
        f_cat = qpred.model.match(image, exemplars, cap)
        got = qpred.model.heads(f_cat)
        want = fused_heads.fused_decoder_heads(
            f_cat.permute(0, 2, 3, 1), *qpred.model._tail_params(),
            dtype=qpred.model.compute_dtype, quant="stored", kernel_arm="int8",
            int8_matmul=cuda_int8.int8_mm_plain, int8_conv=cuda_int8.int8_conv3x3_plain)
        torch.cuda.synchronize()
    tail_diff = max((got["objectness"] - want[0][..., 0]).abs().max().item(),
                    (got["regressions"] - want[1]).abs().max().item())
    print(f"int8 tail on one f_cat {tuple(f_cat.shape)}, kernels vs plain versions on the "
          f"card: max_abs_diff {tail_diff:.3e} (tol 0: exact int32 sums, the same "
          f"epilogue and tap order)", flush=True)
    if tail_diff != 0.0:
        fail(f"int8 tail with the kernels differs from the plain tail: {tail_diff}")
    with torch.inference_mode():
        x = f_cat.permute(0, 2, 3, 1)
        act = torch.randn(*x.shape[:3], 2 * x.shape[3], device="cuda")
        q_in = cuda_ms(lambda: fused_heads._quant_act(x.to(qpred.model.compute_dtype)))
        q_head = cuda_ms(lambda: fused_heads._quant_act(act))
    print(f"int8 tail's activation quantization (_quant_act) per batch: the layer's input "
          f"{tuple(x.shape)} {x.dtype} {q_in:.4f} ms, the heads' input {tuple(act.shape)} "
          f"f32 {q_head:.4f} ms", flush=True)
    int8_arm_on_fcat(torch, pred, qpred, f_cat, fused_heads)
    return launches, qpred


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="after the main path, print a torch.profiler breakdown of "
                         "one batch (device time by kernel, device busy share)")
    args = ap.parse_args(argv)

    root = Path(__file__).resolve().parent
    if not (root / "tmr_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: tmr_tpu_torch/ is not beside this script", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(root))
    import numpy as np
    import torch.nn.functional as F

    from tmr_tpu_torch.config import preset
    from tmr_tpu_torch.inference import Predictor, detections_to_numpy
    from tmr_tpu_torch.ops import (_build, cuda_attn, cuda_int8, cuda_nms, cuda_xcorr,
                                   fused_heads, probe)

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown"
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    # 2. build, then the toolchain probe
    build_s = _build.build()
    for name in _build.SIGNATURES:
        _build.lib(name)
    print(f"build: {build_s:.1f} s for {len(_build.SIGNATURES)} sources", flush=True)
    entries = {"add1": run_probe(torch, probe, _build)}
    probe_launches = entries["add1"].pop("launches")

    # 3. kernels at main-path shapes
    with exact_f32(torch):
        entries.update(check_kernels(torch, F, cuda_attn, cuda_xcorr, cuda_nms, cuda_int8,
                                     preset("TMR_FSCD147").NMS_iou_threshold))

    # 4. main path
    cfg = preset("TMR_FSCD147")
    pred = Predictor(cfg, device="cuda")
    pred.init_params(SEED)
    rng = np.random.default_rng(SEED)
    batches = [synthetic_batch(np, rng, BUCKET_SIDES_PX[b]) for b in (9, 17, 33)]
    caps = [pred.pick_capacity(ex, 1024) for _, ex in batches]
    if caps != [9, 17, 33]:
        fail(f"exemplars picked buckets {caps}, expected [9, 17, 33]")
    with call_count(cuda_attn, "bias_projections") as proj_calls:
        times, outs, launches = run_batches(torch, pred, batches, detections_to_numpy,
                                            _build)
    report_batches(np, "main path", caps, times, outs, card)
    print(f"launches over the 3 batches: {json.dumps(launches)}", flush=True)
    # both attention kernels make their own projections: no f32 copy of q and no
    # projection products on the main path
    print(f"bias_projections calls over the warm-up and 3 batches: {proj_calls[0]} "
          f"(expected 0)", flush=True)
    if proj_calls[0]:
        fail(f"bias_projections ran {proj_calls[0]} times on the card, expected 0")
    if launches["window_attn"] != 24:
        fail(f"window_attn launched {launches['window_attn']} times, expected 24")
    missing = [k for k in ("global_attn", "window_attn", "xcorr", "nms") if launches[k] <= 0]
    if missing:
        fail(f"kernels never launched on the main path: {missing}")
    stray = [k for k in ("xcorr_int8", "int8_mm", "int8_conv", "add1") if launches[k]]
    if stray:
        fail(f"int8 or probe kernels launched on the unquantized path: {stray}")

    imgs, ex = batches[0]
    out = pred.forward(imgs, ex)
    obj = out["objectness"][0].float().cpu()
    reg = out["regressions"][0].float().cpu()
    ref_cfg = preset("TMR_FSCD147", compute_dtype="float32")
    ref = Predictor(ref_cfg, device="cpu")
    ref.model.load_state_dict({k: v.cpu() for k, v in pred.model.state_dict().items()})
    t0 = time.perf_counter()
    ref_obj = ref.forward(imgs[:1], ex[:1])["objectness"][0]
    diff = (obj - ref_obj).abs().max().item()
    scale = ref_obj.abs().max().item()
    print(f"objectness image 0 vs f32 CPU run: max_abs_diff {diff:.4e}, map max "
          f"{scale:.4e}, tol {OBJ_REL_TOL} x max ({time.perf_counter() - t0:.1f} s "
          f"on the CPU)", flush=True)
    if not (torch.isfinite(obj).all() and obj.shape == (128, 128)
            and diff <= OBJ_REL_TOL * scale):
        fail("objectness map disagrees with the f32 CPU reference")
    del ref

    # 4b. the int8-storage path on the same weights
    qlaunches, qpred = check_quant_path(torch, np, pred, batches, caps, obj, reg, card,
                                        (_build, cuda_int8, fused_heads))
    if args.profile:
        profile_batch(torch, pred, *batches[2])
        profile_batch(torch, qpred, *batches[2])

    # 5. the kernels line
    meta = {
        "global_attn": ("tmr_tpu_torch/csrc/attn.cu", "tmr_tpu/ops/pallas_attn.py:59"),
        "window_attn": ("tmr_tpu_torch/csrc/attn.cu", "tmr_tpu/ops/pallas_attn.py:350"),
        "xcorr": ("tmr_tpu_torch/csrc/xcorr.cu", "tmr_tpu/ops/pallas_xcorr.py:47"),
        "nms": ("tmr_tpu_torch/csrc/nms.cu", "tmr_tpu/ops/pallas_nms.py:32"),
        "xcorr_int8": ("tmr_tpu_torch/csrc/xcorr.cu", "tmr_tpu/ops/xcorr.py:171"),
        "int8_mm": ("tmr_tpu_torch/csrc/int8_mm.cu", "tmr_tpu/ops/pallas_int8.py:50"),
        "int8_conv": ("tmr_tpu_torch/csrc/int8_mm.cu", "tmr_tpu/ops/pallas_int8.py:50"),
        "add1": ("tmr_tpu_torch/csrc/probe.cu", "scripts/gate_probe.py:84"),
    }
    path_launches = dict(launches, xcorr_int8=qlaunches["xcorr_int8"],
                         int8_mm=qlaunches["int8_mm"], int8_conv=qlaunches["int8_conv"],
                         add1=probe_launches)
    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=path_launches[name], **entries[name])
               for name, (src, rep) in meta.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
