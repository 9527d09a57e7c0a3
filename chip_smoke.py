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
   20x20, 28x28, 5x7 and 7x64 token grids, the windowed kernel at 7x7 and 16x16 windows;
   both attention kernels again at head dim 80 (SAM ViT-H: the global kernel at 64x64
   with BH 64, with and without the bias, beside the bound of the products it performs,
   and at 24x40, 5x7 and 7x64; the windowed kernel at 14x14 with BH 1600, 7x7 and 16x16),
   with ``-Xptxas -v`` of every attention instantiation; the f32 correlation at T = 1 to 65
   on the matcher's map with its 3xTF32 tensor bound and its f32 bound, and on 96^2 and 64^2
   maps, a ragged map, a bf16-valued feature, the multi path's 12 rows and a feature with
   non-finite values planted; the int8 correlation at T = 1 to 65 on the matcher's map,
   timed in turns with the CUDA-core kernel it replaced, beside the function's bound and the
   band's, and on two ragged maps, a map of -128/-127/127 only and the multi path's 12 rows
   (0 mismatches everywhere); the int8 matmul at the heads' shape for 4 and 12 rows, a tap's
   and a ragged one; greedy NMS (an IoU bitmask and a block scan, two launches a call) on 4
   x 2000 boxes with planted ties at IoU 0.5 and 0.15 (keep masks equal to the plain
   version's on the card and on the CPU), timed in turns with the sequential kernel it
   replaced, its launches split by the profiler, beside the function's bound and the
   design's, with both kernels' ``-Xptxas -v``, and on a ragged 2 x 2001, 1 x 63, 1 x 65, 1
   x 12000 (past the old 9000-box cap), an all-invalid batch, 2000 identical boxes and a
   chain of 2000 (0 mismatches), and on the unions of the multi-exemplar path, 4 x 6000 (k
   3) and 1 x 16000 (k bucket 8), each timed beside its bound (0 mismatches); the fused int8
   3x3 layer at the int8 tail's shape, a ragged one and the multi path's 12 rows, timed in
   turns with the per-tap composition it replaces, beside the bare ``torch._int_mm`` of the
   im2col'd product and its ``-Xptxas -v``; and the 1536 bucket's shapes: the global
   kernel on 96^2 tokens at batch 4 (BH 48, the plain version in chunks), the windowed
   kernel on 4 x 49 windows, the f32 correlation on 4 x 512 x 192^2 at T = 9, 17, 33 and
   on the multi path's 3 x 512 x 192^2 at T = 9, each beside its bound and library call;
4. main path: ``Predictor(preset("TMR_FSCD147"))`` (SAM ViT-B at 1024, batch 4, bf16)
   with seeded random weights answers 3 batches of 4 synthetic images whose exemplars
   hit the 9/17/33 template buckets; every kernel's launch count over those batches
   must be > 0 (``window_attn`` exactly 24: one per windowed block; the head dim 80
   counters and the int8 kernels' 0), nothing may call
   ``bias_projections`` (both attention kernels make their own projections), batch 0's
   keep mask must equal the plain version's on the same detections, and image 0's
   objectness map must agree with an f32 CPU run of the same port and weights;
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
4c. the ViT-H path: ``Predictor(preset("TMR_FSCD147", backbone="sam_vit_h"))`` (SAM
   ViT-H at 1024: 32 blocks of 1280 over 16 heads of 80, global at 7/15/23/31, batch 4,
   bf16) with seeded random weights answers the same 3 batches; its launches must be
   exactly ``global_attn_d80`` 12, ``window_attn_d80`` 84, ``xcorr`` 3, ``nms`` 3 and 0
   for every other kernel, nothing may call ``bias_projections``, batch 0's keep mask
   must equal the plain version's, and image 0's objectness must agree with an f32 CPU
   run of the same port and weights (its seconds printed); printed beside it, the same
   map from the bf16 network with its attention through ``attention_plain`` on the card
   (a yardstick of this script, never a path of the port), which separates bf16 drift
   over 32 blocks from kernel error;
4d. the multi-exemplar path (run after 4b, on phase 4's and 4b's predictors): the same
   images, each carrying 3 exemplars (phase 4's first, then two more squares of its
   size; k bucket 3, real rows (3, 3, 2, 1), padded with the last real row), through
   ``predict_multi_batch``: its launches over the 3 batches must be exactly global 12,
   window 24, xcorr 3, nms 3 and 0 else (the encoder once per image); each batch's union
   keep mask must equal the plain version's on the same merged detections; row
   (image b, exemplar 0)'s objectness must lie within 1e-2 x the max of phase 4's map
   for image b, and every real row within 1e-2 x max of ``predict_multi_exemplar`` on
   image b alone; ``_get_heads_fn(cap, 1024)(_get_backbone_fn()(images), exemplars)``
   must equal ``pred(images, exemplars)`` bit for bit (backbone and heads timed apart);
   ``decode_tail="device"`` must give the host tail's per-image lists; and one batch on
   the int8 path must launch exactly int8_conv 1, int8_mm 1, xcorr_int8 1, global 4,
   window 8 and nms 1, with its union keep mask equal to the plain version's. Its ms
   per batch of 4 images x 3 exemplars is printed beside phase 4's;
5. eval (run after 4d, on phase 4's weights, before 4c):
   ``tmr_tpu_torch.train.loop.Trainer.test(params=...)`` over a synthetic FSCD-147-layout
   test split of 12 images of 384 x 512 (annotation files written to a temporary
   directory, the images kept in memory and handed over by the reader's decode step):
   8 with objects of 30-46 px (the 1024 bucket) and 4 with objects of 12-16 px, which
   the small-object rule sends to the 1536 bucket (96^2 tokens, 7 x 7 windows after
   padding to 98, 192^2 matcher maps); at ``num_exemplars=1``, ``eval_batch_size=4``
   and at ``num_exemplars=3`` (one image a batch), each twice (cold, then warm). Printed:
   the loader's host ms per image in each bucket, the metrics, and per bucket the
   images, the program's ms per batch and images/s beside phase 4's. Checks: every
   batch launches exactly global 4, window 8, xcorr 1, nms 1 and nothing else; its
   detections equal ``Predictor.__call__`` (or ``predict_multi_exemplar``) on the same
   tensors bit for bit; its losses equal ``compute_losses`` on the same model outputs
   and are finite; MAE and RMSE equal those of the detection counts; the 1536 batch
   takes the template bucket phase 3 checks on 192^2 maps; and image 0 of the 1536
   batch has its objectness within 5e-2 x max of an f32 CPU run;
5b. training (run after 5, on phase 4's weights): first each attention Function's
   backward (PyTorch, recomputing the scores in query bands) at main-path shapes, the
   global one at BH 48 on 64x64 tokens with and without the bias and the windowed one at
   BH 1200 on 14x14, both again at head dim 80 (BH 64 and 1600): dq, dk, dv and the
   compact tables' gradients against ``torch.autograd.grad`` of ``attention_plain`` in
   f32 on the card, each within 2^-7 (the tables' 1e-4) of its largest element, the
   backward's ms printed
   beside the kernel forward's and its bound (2.5x the forward's operations); then
   ``Trainer.fit`` of ``preset("TMR_FSCD147")`` (SAM ViT-B at 1024, batch 4, bf16, frozen
   backbone) from phase 4's weights on a synthetic FSCD-147-layout split of 8 train and
   4 val images, 3 epochs in one run and 2 then a resumed 1 in another. Checks: every
   train step launches exactly global 4 and window 8 and no correlation (its template
   capacity is 191, the FFT route), NMS or int8 kernel; each validation batch phase 5's
   launches; the loss is finite and no step skipped; the backbone is phase 4's bit for
   bit while the head moves; the resumed run's head within 1e-2 of what the run moved it
   from the uninterrupted run's; the gradient's global norm within 2e-2 of the same step
   through ``attention_plain`` on the card (a yardstick of this script, never a path of
   the port); 8 steps on one batch lower its loss; a non-finite gradient is discarded;
   ``xcorr`` on a tensor that requires grad raises. Printed: ms per step warm, images/s,
   peak device memory, and a ``{"train": ..., "backward": [...]}`` JSON line;
6. a ``{"kernels": [...]}`` JSON line, then the card line, then the last line
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
#: 96^2 and 64^2 maps, a ragged map with 7 planes, the main path's bf16 feature
#: (``fp.float()`` of a bf16 map, exact in tf32), and the multi-exemplar path's 12 rows
#: (4 images x 3 exemplars)
XCORR_MAPS = ((4, 512, 96, 96, (9, 17, 33, 65), False),
              (4, 512, 64, 64, (9, 17, 33, 65), False),
              (1, 7, 100, 76, XCORR_TS, False),
              (4, 512, 128, 128, (9, 33, 65), True),
              (12, 512, 128, 128, (33,), True))
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
                  "xcorr_int8": 3, "int8_mm": 3, "int8_conv": 3, "add1": 0,
                  "global_attn_d80": 0, "window_attn_d80": 0}
#: launches of the ViT-H path over its 3 batches: 4 global and 28 windowed attention
#: blocks at head dim 80, one f32 correlation and one NMS per batch
VIT_H_LAUNCHES = {"global_attn": 0, "window_attn": 0, "xcorr": 3, "nms": 3,
                  "xcorr_int8": 0, "int8_mm": 0, "int8_conv": 0, "add1": 0,
                  "global_attn_d80": 12, "window_attn_d80": 84}
#: the multi-exemplar path (phase 4d): real exemplar rows of the 4 images of a batch, in
#: k bucket 3; its launches over the 3 batches (the encoder once per image, the heads,
#: correlation and NMS once per batch); the int8 path's over one batch; the bound on each
#: row's objectness against the same row run another way (phase 4's batch of 4, or
#: ``predict_multi_exemplar`` alone), relative to that map's max: the heads run at 12
#: rows against 4 or k, so cuDNN and cuBLAS may pick other algorithms under bf16 rounding
MULTI_K_REAL = (3, 3, 2, 1)
MULTI_LAUNCHES = {"global_attn": 12, "window_attn": 24, "xcorr": 3, "nms": 3,
                  "xcorr_int8": 0, "int8_mm": 0, "int8_conv": 0, "add1": 0,
                  "global_attn_d80": 0, "window_attn_d80": 0}
MULTI_INT8_LAUNCHES = {name: n // 3 for name, n in QUANT_LAUNCHES.items()}
MULTI_ROW_TOL = 1e-2
#: the NMS kernel at the multi-exemplar path's unions (images, slots): k 3 at batch 4,
#: and one image at k bucket 8
NMS_UNIONS = ((4, 6000), (1, 16000))
#: the fused int8 3x3 layer's shapes (B, H, W, C_in, N): the int8 tail's (4 x 128^2,
#: 1024 -> 2048 [objectness | bbox]), a ragged one (W past no tile edge, N not a
#: multiple of 8, C_in not of 128), and the multi-exemplar path's 12 rows
INT8_CONV_SHAPES = ((4, 128, 128, 1024, 2048), (1, 37, 53, 48, 20),
                    (12, 128, 128, 1024, 2048))
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
    """Records the calls of ``module.name`` made through the module while the block runs,
    as (args, kwargs), in order."""
    calls = []
    orig = getattr(module, name)

    def counted(*args, **kwargs):
        calls.append((args, kwargs))
        return orig(*args, **kwargs)

    setattr(module, name, counted)
    try:
        yield calls
    finally:
        setattr(module, name, orig)


def bound(flops: float, nbytes: float, peak_flops: float):
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


#: heads of the SAM ViT with each head dim the kernels take: ViT-B 12 x 64, ViT-H 16 x 80
VIT_HEADS = {64: 12, 80: 16}


def check_attention(torch, F, cuda_attn, windowed: bool, has_bias: bool, seed: int,
                    grid=(64, 64), bh=None, d: int = 64, chunk=None):
    """One attention kernel vs its plain version at head dim ``d``, by default at the
    batch of the ViT with that head dim (4 images of 12 heads for ViT-B, 16 for ViT-H;
    windowed: 25 windows each). The global kernel takes compact (2g - 1, d) tables, the
    windowed kernel expanded (g, g, d) ones; the plain version and the yardstick use the
    expanded tables. Times, on the same inputs: the kernel (one launch, projections
    inside), ``bias_projections`` alone, the bf16 mask built from the projections, and
    SDPA with that mask precomputed. With ``chunk``, the plain version runs over that
    many rows of BH at a time (its dense f32 scores of a 96^2 grid at BH 48 would take
    16 GB), its time the sum of the chunks'."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    gh, gw = grid
    bh = bh or (4 * VIT_HEADS[d] * (25 if windowed else 1))
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
    chunk = chunk or bh
    parts = [slice(i, i + chunk) for i in range(0, bh, chunk)]

    def plain(part):
        return cuda_attn.attention_plain(q[part], k[part], v[part],
                                         *(None if r is None else r[part] for r in rel),
                                         (gh, gw), scale)

    want = torch.cat([plain(part) for part in parts])
    torch.cuda.synchronize()
    diff, ref = (got.float() - want.float()).abs(), want.float().abs()
    limit = ATTN_REL_TOL * ref + ATTN_ABS_TOL * ref.max()
    acc = dict(max_abs_err=diff.max().item(), mean_abs_err=diff.mean().item(),
               mean_abs_want=ref.mean().item(), max_abs_want=ref.max().item(),
               worst_err_over_limit=(diff / limit).max().item())
    acc["ok"] = (acc["worst_err_over_limit"] <= 1.0
                 and acc["mean_abs_err"] <= ATTN_MEAN_TOL * acc["mean_abs_want"])
    t = dict(ms=cuda_ms(lambda: fn(q, k, v, *tab, (gh, gw), scale)))
    del want, diff, ref, limit
    t["plain_ms"] = sum(cuda_ms(lambda: plain(part), reps=3 if len(parts) == 1 else 1,
                                warmup=1 if len(parts) == 1 else 0) for part in parts)
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
#: the same at head dim 80 (ViT-H's 16 heads of 4 images)
GLOBAL_GRIDS_D80 = ((24, 40, 64), (5, 7, 64), (7, 64, 64))


def check_global_grids(torch, F, cuda_attn, d: int = 64, grids=GLOBAL_GRIDS) -> None:
    """The global kernel at head dim ``d`` against its plain version on ``grids``."""
    for gh, gw, bh in grids:
        for has_bias in (True, False):
            acc, t, (bms, bby) = check_attention(torch, F, cuda_attn, False, has_bias, SEED,
                                                 (gh, gw), bh, d)
            what = (f"global_attn{'' if has_bias else '_nobias'}{'' if d == 64 else f'_d{d}'}"
                    f" {gh}x{gw} grid, BH={bh}")
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


#: the 1536 bucket (phase 5's test images with objects under 25 px): the global kernel
#: on 96^2 tokens at batch 4 (BH 48; the plain version in chunks of BH 12), the windowed
#: kernel on 4 x 49 windows (96 tokens padded to 98) of 12 heads, and the correlation on
#: 192^2 maps, at 4 images and at the multi path's 3 rows of one image, for the bucket
#: phase 5's 1536 images take (:data:`EVAL_1536_BUCKETS`) and, for the band maths at
#: W = 192, the larger ones of the direct path
ATTN_1536 = (("global_attn", False, (96, 96), 48, 12),
             ("window_attn", True, (14, 14), 4 * 12 * 49, None))
XCORR_1536 = (((4, 512, 192, 192), (9, 17, 33)), ((3, 512, 192, 192), (9,)))


def check_1536(torch, F, cuda_attn, cuda_xcorr) -> None:
    """Kernels 1, 4 and 5 at the 1536 bucket's shapes against their plain versions, each
    beside its bound and the library call."""
    for name, windowed, grid, bh, chunk in ATTN_1536:
        acc, t, (bms, bby) = check_attention(torch, F, cuda_attn, windowed, True, SEED,
                                             grid, bh, chunk=chunk)
        what = (f"{name} 1536 bucket, {grid[0]}x{grid[1]} "
                f"{'windows' if windowed else 'grid'}, BH={bh}")
        print(f"kernel {what}: {attn_accuracy(acc)} {attn_times(t)} bound_ms {bms:.4f} "
              f"({bby})", flush=True)
        if not acc["ok"]:
            fail(f"{what} disagrees with its plain version: {acc}")
        torch.cuda.empty_cache()
    for shape, ts in XCORR_1536:
        for t in ts:
            r = check_xcorr(torch, F, cuda_xcorr, t, SEED, shape)
            (bms, bby), (f32ms, f32by) = r["tensor_bound"], r["f32_bound"]
            what = f"xcorr 1536 bucket {'x'.join(map(str, shape))} T={t}"
            print(f"kernel {what}: max_err {r['err']:.3e} tol {r['tol']:.3e} kernel_ms "
                  f"{r['ms']:.4f} plain_ms {r['plain_ms']:.4f} library_ms "
                  f"{r['lib_ms']:.4f} (grouped F.conv2d) bound_ms {bms:.4f} ({bby}, "
                  f"3xTF32 at the TF32 peak) f32_bound_ms {f32ms:.4f} ({f32by})", flush=True)
            if not r["err"] <= r["tol"]:
                fail(f"{what} disagrees with its plain version: {r['err']} > {r['tol']}")


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
#: the int8 correlation at the multi-exemplar path's 12 rows (4 images x 3 exemplars)
XCORR_INT8_MULTI = (12, 512, 128, 128)


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
    elif kind in ("head", "head12"):  # M = B * 128^2, K = 2048, N = 5
        b = 4 if kind == "head" else 12  # 12: the multi path's rows
        x = i8(b, 128, 128, 2048)
        sx = scales(b)[:, None, None].expand(b, 128, 128).contiguous()
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
    pairs at IoU exactly 0.5 (kept: the rule is strict); 10% invalid."""
    import numpy as np

    rng = np.random.default_rng(seed)
    cxy = rng.uniform(0.2, 0.5, (b, n, 2))
    wh = rng.uniform(0.02, 0.15, (b, n, 2))
    boxes = np.concatenate([cxy - wh / 2, cxy + wh / 2], -1).astype(np.float32)
    scores = rng.uniform(0.3, 1.0, (b, n)).astype(np.float32)
    s = min(50, n // 6)  # the planted runs' length: 50 from n = 300 on
    boxes[:, 2 * s:3 * s] = boxes[:, s:2 * s]  # identical boxes ...
    scores[:, 2 * s:3 * s] = scores[:, s:2 * s]  # ... with tied scores
    boxes[:, 4 * s:5 * s] = np.array([0.0, 0.0, 0.5, 0.25], np.float32)  # area 1/8
    boxes[:, 5 * s:6 * s] = np.array([0.0, 0.0, 0.25, 0.25], np.float32)  # IoU 0.5 with it
    valid = rng.uniform(size=(b, n)) > 0.1
    return (torch.as_tensor(boxes), torch.as_tensor(scores), torch.as_tensor(valid))


def nms_sorted(torch, boxes, scores, valid):
    """The order ``ops/nms.py`` sorts by (descending score, invalid last, ties by index),
    and the sorted boxes and valid flags."""
    order = torch.sort(torch.where(valid, scores, torch.full_like(scores, -math.inf)),
                       dim=1, descending=True, stable=True).indices
    return (order, torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4)),
            torch.gather(valid, 1, order))


#: the NMS kernel's other inputs, name -> (images, boxes, how they are made): a ragged
#: batch, the word edges, a count past the sequential kernel's shared-memory cap (9000),
#: an all-invalid batch, identical boxes with tied scores (the first suppresses all), and
#: a chain of boxes sliding by 0.3 of their width (greedy keeps every other box, and the
#: scan's fixed point runs out of passes in every block)
NMS_CASES = (("2x2001", 2, 2001, "random"), ("1x63", 1, 63, "random"),
             ("1x65", 1, 65, "random"), ("1x12000", 1, 12000, "random"),
             ("4x2000 all invalid", 4, 2000, "invalid"),
             ("1x2000 identical", 1, 2000, "identical"), ("1x2000 chain", 1, 2000, "chain"))


def nms_sequential(torch, _build, sb, sv, thr: float):
    """The sequential kernel the bitmask design replaced (``tmr_nms_sequential``), called
    as the port called it before: int32 valid and keep flags, converted each call."""
    valid_i = sv.to(torch.int32).contiguous()
    keep = torch.empty_like(valid_i)
    rc = _build.lib("nms").tmr_nms_sequential(sb.data_ptr(), valid_i.data_ptr(),
                                              keep.data_ptr(), sb.shape[0], sb.shape[1],
                                              thr, _build.stream_of(sb))
    if rc:
        fail(f"tmr_nms_sequential: CUDA error {rc} at launch")
    return keep.bool()


def nms_bounds(b: int, n: int, keep) -> tuple:
    """The function's bound (one ~12-flop IoU per (kept i, later j) pair that this data
    needs; boxes and valid flags in, keep flags out) and the design's (every pair j > i of
    each image, and the bitmask written and read once)."""
    keep = keep.cpu().numpy()
    pairs = sum(int((n - 1 - keep_i.nonzero()[0]).sum()) for keep_i in keep)
    nbytes = b * n * (16 + 1 + 1)  # the boxes, the valid and keep flags (one byte each)
    mask_bytes = 2 * b * n * ((n + 63) // 64) * 8
    return (bound(12.0 * pairs, nbytes, PEAK_F32_FLOPS),
            bound(12.0 * b * n * (n - 1) / 2, nbytes + mask_bytes, PEAK_F32_FLOPS))


def check_nms(torch, cuda_nms, _build, thr: float, seed: int) -> dict:
    """The NMS kernel vs its plain version (on the card, and on the CPU) on 4 x 2000
    boxes: keep masks equal; timed in turns with the sequential kernel it replaced (whose
    masks must be equal too), its two launches split by the profiler."""
    boxes, scores, valid = nms_inputs(torch, seed)
    _, sb, sv = (t.cuda() for t in nms_sorted(torch, boxes, scores, valid))
    got = cuda_nms.greedy_keep_sorted(sb, sv, thr)
    want = cuda_nms.greedy_keep_sorted_plain(sb, sv, thr)
    want_cpu = cuda_nms.greedy_keep_sorted_plain(sb.cpu(), sv.cpu(), thr)
    old = nms_sequential(torch, _build, sb, sv, thr)
    torch.cuda.synchronize()
    r = dict(mism=int((got != want).sum().item()) + int((got.cpu() != want_cpu).sum().item()),
             old_mism=int((old != want).sum().item()), kept=int(want_cpu.sum()))
    kernel = lambda: cuda_nms.greedy_keep_sorted(sb, sv, thr)  # noqa: E731
    sequential = lambda: nms_sequential(torch, _build, sb, sv, thr)  # noqa: E731
    ms, old_ms = [], []
    for fn, dst in ((kernel, ms), (sequential, old_ms), (sequential, old_ms), (kernel, ms)):
        dst.append(cuda_ms(fn))
    r.update(ms=min(ms), ms_turns=ms, old_ms=min(old_ms), old_turns=old_ms)
    r["plain_ms"] = cuda_ms(lambda: cuda_nms.greedy_keep_sorted_plain(sb, sv, thr), reps=1,
                            warmup=0)
    phases = {}
    for name, kernel_ms in profiled_kernels_ms(torch, kernel).items():
        key = next((k for k in ("nms_mask_kernel", "nms_scan_kernel") if k in name),
                   "other")
        phases[key] = phases.get(key, 0.0) + kernel_ms
    r["phases"] = phases
    r["bound"], r["design_bound"] = nms_bounds(*sb.shape[:2], want)
    return r


def check_nms_cases(torch, cuda_nms, thr: float, seed: int) -> None:
    """The NMS kernel vs its plain version on the card on :data:`NMS_CASES`: 0
    mismatches."""
    for name, b, n, kind in NMS_CASES:
        boxes, scores, valid = nms_inputs(torch, seed, b, n)
        if kind == "invalid":
            valid = torch.zeros_like(valid)
        elif kind == "identical":
            boxes[:] = torch.tensor([0.1, 0.2, 0.4, 0.6])
            scores[:] = 0.5
            valid[:] = True
        elif kind == "chain":
            x = torch.arange(n, dtype=torch.float64)[None, :, None] * 0.3
            boxes = torch.cat([x, torch.zeros_like(x), x + 1.0, torch.ones_like(x)],
                              -1).float().expand(b, -1, -1).contiguous()
            scores = torch.linspace(1.0, 0.5, n).expand(b, -1).contiguous()
            valid[:] = True
        _, sb, sv = (t.cuda() for t in nms_sorted(torch, boxes, scores, valid))
        got = cuda_nms.greedy_keep_sorted(sb, sv, thr)
        want = cuda_nms.greedy_keep_sorted_plain(sb, sv, thr)
        torch.cuda.synchronize()
        mism = int((got != want).sum().item())
        ms = cuda_ms(lambda: cuda_nms.greedy_keep_sorted(sb, sv, thr))
        print(f"kernel nms {name} IoU {thr}: keep mismatches {mism} (must be 0), kept "
              f"{int(want.sum())} of {int(sv.sum())} valid, kernel_ms {ms:.4f}", flush=True)
        if mism:
            fail(f"nms {name} keep masks differ from the plain version in {mism} slots")


def check_nms_unions(torch, cuda_nms, thr: float, seed: int) -> None:
    """The NMS kernel vs its plain version on the card at :data:`NMS_UNIONS`, the
    multi-exemplar path's slot counts: 0 mismatches; timed beside the plain version and
    both bounds."""
    for b, n in NMS_UNIONS:
        boxes, scores, valid = nms_inputs(torch, seed, b, n)
        _, sb, sv = (t.cuda() for t in nms_sorted(torch, boxes, scores, valid))
        got = cuda_nms.greedy_keep_sorted(sb, sv, thr)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = cuda_nms.greedy_keep_sorted_plain(sb, sv, thr)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        mism = int((got != want).sum().item())
        ms = cuda_ms(lambda: cuda_nms.greedy_keep_sorted(sb, sv, thr))
        (bms, bby), (dms, dby) = nms_bounds(b, n, want)
        print(f"kernel nms union {b}x{n} IoU {thr}: keep mismatches {mism} (must be 0), "
              f"kept {int(want.sum())} of {int(sv.sum())} valid, kernel_ms {ms:.4f} "
              f"plain_ms {plain_ms:.1f} bound_ms {bms:.6f} ({bby}, the pairs this data "
              f"needs) design_bound_ms {dms:.6f} ({dby}, every pair and the bitmask), "
              f"workspace {b * n * cuda_nms.mask_words(n) * 8} bytes", flush=True)
        if mism:
            fail(f"nms union {b}x{n} keep masks differ from the plain version in {mism} "
                 f"slots")


def synthetic_batch(np, rng, side_px: int, b: int = 4, size: int = 1024, k: int = 1):
    """Dark noisy images with bright squares of ``side_px``; exemplars = the first k
    squares (the draws do not depend on k)."""
    imgs = rng.normal(-1.0, 0.1, (b, size, size, 3)).astype(np.float32)
    exemplars = np.zeros((b, k, 4), np.float32)
    cells = (size - side_px) // 8
    for i in range(b):
        for j in range(6):
            y, x = (rng.integers(0, cells, 2) * 8).tolist()
            imgs[i, y:y + side_px, x:x + side_px] = 2.0
            if j < k:
                exemplars[i, j] = [x / size, y / size, (x + side_px) / size,
                                   (y + side_px) / size]
    return imgs, exemplars


def pad_exemplar_rows(ex, k_real):
    """(B, k, 4) exemplars with rows past each image's k_real set to its last real row,
    as ``predict_multi_exemplar`` pads them."""
    out = ex.copy()
    for i, k in enumerate(k_real):
        out[i, k:] = ex[i, k - 1]
    return out


def profile_batch(torch, run, path: str, what: str = "one batch of 4, bucket 33") -> None:
    """torch.profiler over one batch, ``run()``: device time by kernel name (the top 25 and
    the NMS kernels) and the device's busy share of the batch's wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms, count = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, count + 1)
    busy_ms = sum(ms for ms, _ in by_name.values())
    print(f"profile {path} ({what}): wall {wall_ms:.1f} ms, device kernel "
          f"time {busy_ms:.1f} ms, busy share {busy_ms / wall_ms:.3f}", flush=True)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    # the top 25, and the NMS kernels wherever they rank
    for rank, (name, (ms, count)) in enumerate(ranked):
        if rank < 25 or "nms_" in name:
            print(f"profile  {ms:9.3f} ms  x{count:<5d} {name[:110]}", flush=True)


def check_kernels(torch, F, cuda_attn, cuda_xcorr, cuda_nms, cuda_int8,
                  thr: float) -> dict:
    """Each kernel at the main path's shapes against its plain version; returns the
    kernels line's entries (all but the launch counts)."""
    from tmr_tpu_torch.ops import _build

    entries = {}
    for name, windowed, has_bias, grid, d in (
            ("global_attn", False, True, (64, 64), 64),
            ("global_attn_nobias", False, False, (64, 64), 64),
            ("window_attn", True, True, (14, 14), 64),
            ("global_attn_d80", False, True, (64, 64), 80),
            ("global_attn_nobias_d80", False, False, (64, 64), 80),
            ("window_attn_d80", True, True, (14, 14), 80)):
        acc, t, (bms, bby) = check_attention(torch, F, cuda_attn, windowed, has_bias, SEED,
                                             grid, d=d)
        extra = ""
        if d == 80 and not windowed:  # p.v over two 64-column panels: 128 of 80 columns
            bh, s = 4 * VIT_HEADS[d], grid[0] * grid[1]
            pms, pby = bound(2.0 * bh * s * s * (d + 128), 4 * bh * s * d * 2,
                             PEAK_BF16_FLOPS)
            extra = f" performed_work_bound_ms {pms:.4f} ({pby}: p.v over 128 columns)"
        print(f"kernel {name}: {attn_accuracy(acc)} {attn_times(t)} bound_ms {bms:.4f} "
              f"({bby}){extra}", flush=True)
        if not acc["ok"]:
            fail(f"{name} disagrees with its plain version: {acc}")
        entries[name] = dict(max_abs_err=acc["max_abs_err"], ms=t["ms"],
                             plain_ms=t["plain_ms"], bound_ms=bms, bound_by=bby,
                             library_ms=t["lib_ms"])
    check_global_grids(torch, F, cuda_attn)
    check_global_grids(torch, F, cuda_attn, 80, GLOBAL_GRIDS_D80)
    # the windowed kernel at 7x7 windows (8-slot key rows, a pad key row, 64 query rows)
    # and 16x16 (full 16-slot key rows, one CTA per SM), at both head dims
    for d in (64, 80):
        for grid in ((7, 7), (16, 16)):
            acc, t, (bms, _) = check_attention(torch, F, cuda_attn, True, True, SEED, grid,
                                               d=d)
            what = f"window_attn{'' if d == 64 else f'_d{d}'} {grid[0]}x{grid[1]} windows"
            print(f"kernel {what}: {attn_accuracy(acc)} {attn_times(t)} bound_ms {bms:.4f}",
                  flush=True)
            if not acc["ok"]:
                fail(f"{what} disagrees with its plain version: {acc}")
    # -Xptxas -v of every attention instantiation: registers and spills
    log = _build.LOGS.get("attn")
    for d in (64, 80):
        bk = 128 if d == 64 else 64
        for bias, row_tile, tiles in ((1, 1, bk), (1, 0, 64), (0, 0, 64)):
            inst = f"global_attn_kernelILi{d}ELi{tiles}ELb{bias}ELb{row_tile}E"
            print(f"ptxas global_attn_kernel<{d}, {tiles}, {bool(bias)}, {bool(row_tile)}>: "
                  f"{ptxas_info(log, inst)}", flush=True)
        for ntw in (1, 2, 4, 8):
            print(f"ptxas window_attn_kernel<{d}, {ntw}>: "
                  f"{ptxas_info(log, f'window_attn_kernelILi{d}ELi{ntw}E')}", flush=True)
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
    check_1536(torch, F, cuda_attn, cuda_xcorr)
    print(f"ptxas nms_mask_kernel: {ptxas_info(_build.LOGS.get('nms'), 'nms_mask_kernel')}",
          flush=True)
    print(f"ptxas nms_scan_kernel: {ptxas_info(_build.LOGS.get('nms'), 'nms_scan_kernel')}",
          flush=True)
    for nms_thr in (thr, 0.15):
        r = check_nms(torch, cuda_nms, _build, nms_thr, SEED)
        (bms, bby), (dms, dby) = r["bound"], r["design_bound"]
        turns = lambda v: " ".join(f"{x:.4f}" for x in v)  # noqa: E731
        phases = ", ".join(f"{k} {v:.4f}" for k, v in r["phases"].items()) or "not measured"
        print(f"kernel nms 4x2000 IoU {nms_thr}: keep mismatches {r['mism']} (must be 0), "
              f"kept {r['kept']} of 4x2000, kernel_ms {r['ms']:.4f} (turns "
              f"{turns(r['ms_turns'])}; 2 launches, device ms per call by the profiler: "
              f"{phases}) replaced sequential kernel_ms {r['old_ms']:.4f} (turns "
              f"{turns(r['old_turns'])}; {r['old_mism']} mismatches; "
              f"{r['old_ms'] / r['ms']:.1f}x the kernel's) plain_ms "
              f"{r['plain_ms']:.4f} library_ms null bound_ms {bms:.6f} ({bby}, the pairs "
              f"this data needs) design_bound_ms {dms:.6f} ({dby}, every pair and the "
              f"bitmask)", flush=True)
        if r["mism"] or r["old_mism"]:
            fail(f"nms keep masks differ from the plain version in {r['mism']} slots and "
                 f"the sequential kernel's in {r['old_mism']}")
        if nms_thr == thr:
            entries["nms"] = dict(max_abs_err=0.0, ms=r["ms"], plain_ms=r["plain_ms"],
                                  bound_ms=bms, bound_by=bby, library_ms=None)
    check_nms_cases(torch, cuda_nms, thr, SEED)
    check_nms_unions(torch, cuda_nms, thr, SEED)
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
              f"{turns(r['old_turns'])}; {r['old_mism']} mismatches; "
              f"{r['old_ms'] / r['ms']:.1f}x the kernel's) plain_ms "
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
    r = check_xcorr_int8(torch, F, cuda_xcorr, _build, 33, SEED, XCORR_INT8_MULTI,
                         yardsticks=False)
    shape = "x".join(map(str, XCORR_INT8_MULTI))
    print(f"kernel xcorr_int8 {shape} (the multi path's rows) T=33: mismatches {r['mism']} (must be 0), kernel_ms {r['ms']:.4f}", flush=True)
    if r["mism"]:
        fail(f"xcorr_int8 at the multi path's rows differs in {r['mism']} outputs")
    for kind in ("tap", "head", "head12", "ragged"):
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


def profiled_kernels_ms(torch, fn, reps: int = 20) -> dict:
    """Device time per call of ``fn`` by kernel name from torch.profiler's kernel records
    (empty when the profiler records no device time)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / reps
    return {k: v for k, v in by_name.items() if v > 0}


def profiled_device_ms(torch, fn, reps: int = 20):
    """Device time per call of ``fn`` from torch.profiler's kernel records, or None when
    the profiler records no device time."""
    return sum(profiled_kernels_ms(torch, fn, reps).values()) or None


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


def check_main_path_nms(torch, run, cuda_nms, name: str = "main path batch 0") -> dict:
    """A batch once more through a path, ``run()``, its detections caught on their way
    into ``batched_nms``: the keep mask the kernel gave must equal the plain version's on
    the card on the same detections. Returns the path's output."""
    from tmr_tpu_torch import inference

    with call_count(inference, "batched_nms") as calls:
        out = run()
    (dets, thr), _ = calls[0]
    order, sb, sv = nms_sorted(torch, dets["boxes"].float(), dets["scores"], dets["valid"])
    keep = torch.zeros_like(sv).scatter(
        1, order, cuda_nms.greedy_keep_sorted_plain(sb, sv, thr))
    want = dets["valid"] & keep
    mism = int((out["valid"] != want).sum().item())
    print(f"{name} NMS, {tuple(sv.shape)} slots at IoU {thr}: valid "
          f"{sv.sum(1).tolist()}, kept {want.sum(1).tolist()}, keep mismatches vs the "
          f"plain version {mism} (must be 0)", flush=True)
    if mism:
        fail(f"the {name}'s NMS differs from the plain version in {mism} slots")
    return out


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


def max_rel(torch, got, want) -> float:
    """max |got - want| over want's max |.|, both moved to the CPU as f32."""
    got, want = got.float().cpu(), want.float().cpu()
    return (got - want).abs().max().item() / want.abs().max().item()


def lists_equal(np, a, b) -> bool:
    """Per-image detection lists equal bit for bit."""
    return len(a) == len(b) and all(
        np.array_equal(x[name], y[name]) for x, y in zip(a, b)
        for name in ("boxes", "scores", "refs"))


def check_multi_path(torch, np, pred, qpred, multi_batches, caps, phase4_ms, card,
                     modules) -> None:
    """Phase 4d: ``predict_multi_batch`` on phase 4's weights over the same images with 3
    exemplars each (k bucket 3, real rows :data:`MULTI_K_REAL`); its launches, union
    keep masks, rows against phase 4 and ``predict_multi_exemplar``, the split programs,
    the device tail, and one batch on phase 4b's int8 predictor."""
    import dataclasses

    from tmr_tpu_torch.inference import Predictor, detections_to_numpy

    _build, cuda_nms = modules
    k_real = np.array(MULTI_K_REAL, np.int32)
    size = multi_batches[0][0].shape[1]
    mcaps = [pred.pick_capacity(ex, size) for _, ex in multi_batches]
    if mcaps != caps:
        fail(f"multi path: exemplars picked buckets {mcaps}, expected {caps}")
    pred.predict_multi_batch(*multi_batches[0], k_real)  # warm-up: cuDNN plans at 12 rows
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    times, outs = [], []
    for imgs, ex in multi_batches:
        t0 = time.perf_counter()
        dets = pred.predict_multi_batch(imgs, ex, k_real)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        outs.append(detections_to_numpy(dets))
    launches = dict(_build.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for i, per_img in enumerate(outs):
        counts = [len(d["boxes"]) for d in per_img]
        print(f"multi path batch {i} (bucket {caps[i]}, k_real {MULTI_K_REAL}): detections "
              f"per image {counts}, {times[i]:.1f} ms [{card}]", flush=True)
        for d in per_img:
            if not (np.isfinite(d["boxes"]).all() and np.isfinite(d["scores"]).all()):
                fail("multi path: non-finite detections")
    mean = sum(times) / len(times)
    print(f"multi path: {mean:.1f} ms per batch of 4 images x 3 exemplars (mean of 3; "
          f"steady, batches 1-2, {sum(times[1:]) / 2:.1f}) beside phase 4's "
          f"{phase4_ms:.1f} ms per batch of 4 ({mean / phase4_ms:.2f}x); peak device memory {peak_gb:.2f} "
          f"GB [{card}]", flush=True)
    print(f"multi path launches over the 3 batches: {json.dumps(launches)}", flush=True)
    if launches != MULTI_LAUNCHES:
        fail(f"multi path launches {launches}, expected {MULTI_LAUNCHES}")

    # union keep masks, row 0 against phase 4, every real row against
    # predict_multi_exemplar on its image alone
    worst0 = worst1 = 0.0
    for i, (imgs, ex) in enumerate(multi_batches):
        with call_count(Predictor, "_decode") as dec:
            out = check_main_path_nms(
                torch, lambda: pred.predict_multi_batch(imgs, ex, k_real), cuda_nms,
                f"multi path batch {i}")
        obj = dec[0][0][1]["objectness"]
        obj = obj.reshape(4, 3, *obj.shape[1:])
        ref = pred.forward(imgs, ex[:, :1])["objectness"]
        row0 = [max_rel(torch, obj[b, 0], ref[b]) for b in range(4)]
        alone, counts = [], []
        for b in range(4):
            with call_count(Predictor, "_decode") as dec1:
                one = pred.predict_multi_exemplar(imgs[b:b + 1], ex[b], k_real=k_real[b])
            one_obj = dec1[0][0][1]["objectness"]
            alone.append(max(max_rel(torch, obj[b, j], one_obj[j])
                             for j in range(k_real[b])))
            counts.append((int(one["valid"].sum()), int(out["valid"][b].sum())))
        worst0, worst1 = max(worst0, *row0), max(worst1, *alone)
        print(f"multi path batch {i}: row (b, exemplar 0) objectness vs phase 4's map for "
              f"image b, max_abs_diff / max: {' '.join(f'{v:.2e}' for v in row0)}; real "
              f"rows vs predict_multi_exemplar on image b alone: "
              f"{' '.join(f'{v:.2e}' for v in alone)} (tol {MULTI_ROW_TOL}); valid "
              f"detections alone / in the batch: {counts}", flush=True)
    if not worst0 <= MULTI_ROW_TOL or not worst1 <= MULTI_ROW_TOL:
        fail(f"multi path rows disagree: vs phase 4 {worst0:.3e}, vs "
             f"predict_multi_exemplar {worst1:.3e}, tol {MULTI_ROW_TOL}")

    # the split programs on batch 0, phase 4's exemplars
    imgs, ex = multi_batches[0]
    ex1 = ex[:, :1].copy()
    cap = pred.pick_capacity(ex1, size)
    backbone, heads = pred._get_backbone_fn(), pred._get_heads_fn(cap, size)
    feats = backbone(imgs)
    split, fused = heads(feats, ex1), pred(imgs, ex1)
    torch.cuda.synchronize()
    diff = [name for name in ("boxes", "scores", "refs", "valid")
            if not torch.equal(split[name], fused[name])]
    img_dev = torch.as_tensor(imgs, device="cuda")
    backbone_ms = cuda_ms(lambda: backbone(img_dev))
    heads_ms = cuda_ms(lambda: heads(feats, ex1))
    fused_ms = cuda_ms(lambda: pred(img_dev, ex1))
    print(f"split programs, batch 0 (features {tuple(feats.shape)} {feats.dtype}): heads "
          f"on the backbone's features vs the fused call, fields that differ bit for bit: "
          f"{diff or 'none'} (must be none); backbone {backbone_ms:.2f} ms, heads (a "
          f"feature-cache hit) {heads_ms:.2f} ms, fused {fused_ms:.2f} ms per batch of 4, "
          f"images on the card [{card}]", flush=True)
    if diff:
        fail(f"the split programs differ from the fused call in {diff}")

    # the device tail on the same model
    dpred = Predictor(dataclasses.replace(pred.cfg, decode_tail="device"), device="cuda",
                      model=pred.model)
    for name, run in (("__call__", lambda p: p(imgs, ex1)),
                      ("predict_multi_batch",
                       lambda p: p.predict_multi_batch(imgs, ex, k_real))):
        host, dev = run(pred), run(dpred)
        same = lists_equal(np, detections_to_numpy(host), detections_to_numpy(dev))
        print(f"device tail, {name} batch 0: count {dev['count'].tolist()}, per-image "
              f"lists equal to the host tail's: {same}", flush=True)
        if not same:
            fail(f"the device tail's lists differ from the host tail's ({name})")

    # one batch on the int8 path: 12 rows through the int8 kernels
    _build.reset_launches()
    check_main_path_nms(torch, lambda: qpred.predict_multi_batch(imgs, ex, k_real),
                        cuda_nms, "int8 multi path batch 0")
    qlaunches = dict(_build.LAUNCHES)
    print(f"int8 multi path launches over one batch: {json.dumps(qlaunches)}", flush=True)
    if qlaunches != MULTI_INT8_LAUNCHES:
        fail(f"int8 multi path launches {qlaunches}, expected {MULTI_INT8_LAUNCHES}")


#: phase 5's synthetic FSCD-147-layout test split: images of FSC-147's 384-px height,
#: EVAL_OBJECTS squares each, on a 64-px cell grid so none overlap; object sides of the
#: images that stay at 1024 (>= 25 px; template bucket 17 or 9 on the 128^2 map) and of
#: those the small-object rule sends to 1536 (< 25 px in both sides; bucket 9 on the
#: 192^2 map), interleaved so the loader fills a batch of 4 in each bucket
EVAL_HW = (384, 512)
EVAL_OBJECTS = 8
EVAL_SIDES = (30, 38, 12, 46, 34, 14, 42, 30, 16, 38, 46, 16)
EVAL_1536_BUCKETS = (9,)  # checked in phase 3 on 192^2 maps (XCORR_1536)
#: launches of one eval batch (4 images at eval_batch_size 4, or one image with its 3
#: exemplars at num_exemplars 3): the encoder's 4 global and 8 windowed blocks, one
#: correlation, one NMS
EVAL_LAUNCHES = {"global_attn": 4, "window_attn": 8, "xcorr": 1, "nms": 1,
                 "xcorr_int8": 0, "int8_mm": 0, "int8_conv": 0, "add1": 0,
                 "global_attn_d80": 0, "window_attn_d80": 0}


def eval_split(np, root: str, sides=EVAL_SIDES, n_train: int = 0) -> dict:
    """Write phase 5's annotation files (FSCD-147 layout: the exemplar json, the split
    json and COCO instances for every split) under ``root``, an image for each object
    side in ``sides``; returns the images, by name, as (H, W, 3) uint8 arrays kept in
    memory. Every split holds every image, or with ``n_train`` the first ``n_train``
    images are the train split and the rest the val and test splits (phase 5b)."""
    import os

    rng = np.random.default_rng(SEED + 5)
    h, w = EVAL_HW
    cells = [(y, x) for y in range(0, h, 64) for x in range(0, w, 64)]
    images, annos, instances = {}, {}, []
    for i, side in enumerate(sides):
        name = f"eval{i:02d}.jpg"
        arr = rng.uniform(0, 40, (h, w, 3)).astype(np.uint8)
        boxes = []
        for c in rng.choice(len(cells), EVAL_OBJECTS, replace=False):
            y, x = (v + int(o) for v, o in zip(cells[c], rng.integers(0, 64 - side, 2)))
            arr[y:y + side, x:x + side] = 220
            boxes.append([x, y, side, side])
        images[name] = arr
        annos[name] = {"box_examples_coordinates": [
            [[x, y], [x, y + bh], [x + bw, y + bh], [x + bw, y]]
            for x, y, bw, bh in boxes[:3]]}
        instances += [{"id": len(instances) + 1, "image_id": i, "bbox": b} for b in boxes]
    os.makedirs(os.path.join(root, "annotations"))
    names = sorted(images)

    def dump(name, obj):
        with open(os.path.join(root, "annotations", name), "w") as f:
            json.dump(obj, f)

    dump("annotation_FSC147_384.json", annos)
    held_out = names[n_train:] if n_train else names
    dump("Train_Test_Val_FSC_147.json", {"train": names[:n_train] if n_train else names,
                                         "val": held_out, "test": held_out})
    for split in ("train", "val", "test"):
        dump(f"instances_{split}.json", {
            "images": [{"id": i, "file_name": n} for i, n in enumerate(names)],
            "annotations": instances})
    return images


@contextlib.contextmanager
def in_memory_images(images: dict):
    """While the block runs, the port's registry builds its FSCD-147 reader as a
    subclass whose decode step returns the image kept in memory (no image library on
    the card's machine); the annotation JSON, ``_item``, the resize, the size bucket and
    the loader are the port's own code."""
    import os

    from tmr_tpu_torch.data import datasets

    base = datasets.FSCD147Dataset

    class InMemoryFSCD147(base):
        def decode(self, img_url):
            return images[os.path.basename(img_url)]

    datasets.FSCD147Dataset = InMemoryFSCD147
    try:
        yield
    finally:
        datasets.FSCD147Dataset = base


def run_eval(torch, cfg, model, state_dict, _build, device):
    """``Trainer.test(params=state_dict)`` with each eval batch recorded: the batch, its
    losses and detections, its launches and its time (synchronized around the batch's
    program). Returns (metrics, records, (wall seconds of the whole eval, of its end:
    the COCO files merged and the metrics computed), the trainer)."""
    from tmr_tpu_torch.train.loop import Trainer

    records, finish_s = [], []

    class RecordingTrainer(Trainer):
        def _eval_batch(self, batch):
            torch.cuda.synchronize()
            before = dict(_build.LAUNCHES)
            t0 = time.perf_counter()
            losses, dets = super()._eval_batch(batch)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            launches = {k: v - before[k] for k, v in _build.LAUNCHES.items()}
            records.append(dict(batch=batch, losses=losses, dets=dets, ms=ms,
                                launches=launches))
            return losses, dets

        def _finish_eval(self, stage, sums, n):
            t0 = time.perf_counter()
            out = super()._finish_eval(stage, sums, n)
            finish_s.append(time.perf_counter() - t0)
            return out

    tr = RecordingTrainer(cfg, device=device, model=model)
    t0 = time.perf_counter()
    metrics = tr.test(params=state_dict)
    return metrics, records, (time.perf_counter() - t0, finish_s[0]), tr


def check_eval_path(torch, np, pred, card, phase4_ms, modules, profile=False) -> None:
    """Phase 5: ``Trainer.test(params=...)`` on phase 4's weights over a synthetic
    FSCD-147-layout test split of 12 images, 8 at 1024 and 4 escalated to 1536, at
    num_exemplars 1 (eval_batch_size 4) and 3 (forced to 1), each twice: the first run
    pays the first calls at the eval's shapes (cold), the second is timed warm. With
    ``profile``, a torch.profiler breakdown of the 1536 batch's program."""
    import dataclasses
    import os
    import tempfile

    from tmr_tpu_torch.config import preset
    from tmr_tpu_torch.data import datasets
    from tmr_tpu_torch.inference import Predictor, detections_to_numpy
    from tmr_tpu_torch.train.loop import Trainer
    from tmr_tpu_torch.train.state import compute_losses

    _build, = modules
    with tempfile.TemporaryDirectory() as tmp:
        images = eval_split(np, os.path.join(tmp, "fsc"))
        base = preset("TMR_FSCD147", datapath=os.path.join(tmp, "fsc"), eval=True,
                      num_workers=4)
        state_dict = pred.model.state_dict()
        with in_memory_images(images):
            # the loader's host cost per image, decode excluded (the images are in memory)
            ds = datasets.build_dataset(base, "test")
            host = {}
            for i in range(len(ds)):
                t0 = time.perf_counter()
                item = ds[i]
                host.setdefault(item["image"].shape[0], []).append(
                    (time.perf_counter() - t0) * 1e3)
            print("eval loader host ms per image (384x512 source, decode excluded: the "
                  "images are in memory): " + ", ".join(
                      f"-> {s}: {sum(v) / len(v):.1f} ms (mean of {len(v)})"
                      for s, v in sorted(host.items())), flush=True)
            if sorted(host) != [1024, 1536] or len(host[1536]) != 4:
                fail(f"eval split: images per bucket {({k: len(v) for k, v in host.items()})}"
                     ", expected 8 at 1024 and 4 at 1536")
            for k, run in ((1, "cold"), (1, "warm"), (3, "cold"), (3, "warm")):
                cfg = dataclasses.replace(base, logpath=os.path.join(tmp, f"log{k}{run}"),
                                          num_exemplars=k, eval_batch_size=4)
                torch.cuda.reset_peak_memory_stats()
                metrics, records, wall, tr = run_eval(torch, cfg, pred.model,
                                                      state_dict, _build, pred.device)
                name = f"eval num_exemplars={k} ({run})"
                print(f"{name}: peak device memory "
                      f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB [{card}]",
                      flush=True)
                check_eval_run(torch, np, pred, tr, name, metrics, records, wall,
                               phase4_ms, card, compute_losses, detections_to_numpy)
                if k == 1:  # the 1536 batch of 4, for the objectness check below
                    big = next(r["batch"] for r in records
                               if r["batch"]["image"].shape[1] == 1536)
                    if profile and run == "warm":
                        profile_batch(torch, lambda: Trainer._eval_batch(tr, big),
                                      "eval 1536 bucket", "one batch of 4 with its losses, "
                                      "bucket 9")
                del records, tr
    # the 1536 bucket's objectness against an f32 CPU run (phase 4's measure)
    check_1536_objectness(torch, pred, Predictor, big["image"], big["exemplars"])


def check_eval_run(torch, np, pred, tr, name, metrics, records, wall, phase4_ms, card,
                   compute_losses, detections_to_numpy) -> None:
    """The checks of one eval run: launches per batch, detections equal to the port
    Predictor's on the same tensors, losses equal to ``compute_losses`` on the same
    model outputs and finite, MAE/RMSE equal to those of the detection counts."""
    cfg = tr.cfg
    k = cfg.num_exemplars
    print(f"{name}: metrics {json.dumps(metrics)}", flush=True)
    n_img = sum(r["batch"]["image"].shape[0] for r in records)
    wall, finish = wall
    prog = sum(r["ms"] for r in records) / 1e3
    print(f"{name}: {n_img} images in {wall:.2f} s end to end, {n_img / wall:.2f} img/s: "
          f"the programs {prog:.2f} s, the end (COCO files merged, AP and MAE/RMSE) "
          f"{finish:.2f} s, the rest (loader waits, per-image JSONs) "
          f"{wall - prog - finish:.2f} s [{card}]", flush=True)
    by_size = {}
    for r in records:
        by_size.setdefault(r["batch"]["image"].shape[1], []).append(r)
    for size, rs in sorted(by_size.items()):
        imgs = sum(r["batch"]["image"].shape[0] for r in rs)
        ms = [r["ms"] for r in rs]
        print(f"{name} bucket {size}: {imgs} images in {len(rs)} batches of "
              f"{rs[0]['batch']['image'].shape[0]}, program ms per batch "
              f"{' '.join(f'{v:.1f}' for v in ms)} (losses and detections, synchronized), "
              f"{imgs * 1e3 / sum(ms):.2f} img/s; phase 4's {phase4_ms:.1f} ms per batch "
              f"of 4 at 1024 [{card}]", flush=True)
    if sorted(by_size) != [1024, 1536]:
        fail(f"{name}: buckets {sorted(by_size)}, expected [1024, 1536]")
    counts = []
    for i, r in enumerate(records):
        batch, b = r["batch"], r["batch"]["image"].shape[0]
        if r["launches"] != EVAL_LAUNCHES:
            fail(f"{name} batch {i} ({b} x {batch['image'].shape[1]}^2): launches "
                 f"{r['launches']}, expected {EVAL_LAUNCHES}")
        extra = (batch["gt_boxes"], batch["gt_valid"])
        thr = (cfg.positive_threshold, cfg.negative_threshold)
        if k == 1:
            cap = pred.pick_capacity(batch["exemplars"], batch["image"].shape[1])
            if batch["image"].shape[1] == 1536 and cap not in EVAL_1536_BUCKETS:
                fail(f"{name}: a 1536 batch took bucket {cap}, phase 3 checks "
                     f"{EVAL_1536_BUCKETS}")
            want = pred(batch["image"], batch["exemplars"])
            out = pred.forward(batch["image"], batch["exemplars"])
            loss = compute_losses(out, {"exemplars": batch["exemplars"],
                                        "gt_boxes": extra[0], "gt_valid": extra[1]}, *thr)
        else:
            meta = batch["meta"][0]
            ex = meta["orig_exemplars"] / np.array(meta["img_size"].tolist() * 2, np.float32)
            want = pred.predict_multi_exemplar(batch["image"], ex)
            cap = pred.pick_capacity(ex, batch["image"].shape[1])
            if batch["image"].shape[1] == 1536 and cap not in EVAL_1536_BUCKETS:
                fail(f"{name}: a 1536 image took bucket {cap}, phase 3 checks "
                     f"{EVAL_1536_BUCKETS}")
            _, out, rows = pred._multi(batch["image"], ex[None], [len(ex)], cap)
            per_row = [compute_losses({n: v[j:j + 1] for n, v in out.items()},
                                      {"exemplars": rows[j:j + 1, None],
                                       "gt_boxes": extra[0], "gt_valid": extra[1]}, *thr)
                       for j in range(len(ex))]
            loss = {n: torch.stack([p[n] for p in per_row]).sum() for n in per_row[0]}
        diff = [f for f in ("boxes", "scores", "refs", "valid")
                if not torch.equal(r["dets"][f], want[f])]
        bad_loss = [n for n in loss if not (torch.equal(loss[n], r["losses"][n])
                                            and torch.isfinite(loss[n]))]
        if diff or bad_loss:
            fail(f"{name} batch {i}: detections differ from the Predictor's in {diff}, "
                 f"losses differ from compute_losses (or are not finite) in {bad_loss}")
        for meta, d in zip(batch["meta"], detections_to_numpy(r["dets"])):
            counts.append((len(meta["orig_boxes"]), max(len(d["boxes"]), 1)))
    err = np.array([g - p for g, p in counts], np.float64)
    mae, rmse = float(np.abs(err).mean()), float(np.sqrt((err ** 2).mean()))
    print(f"{name}: {len(records)} batches, launches each {json.dumps(EVAL_LAUNCHES)}, "
          f"detections equal to the Predictor's bit for bit, losses equal to "
          f"compute_losses; (GT, detections) per image {counts}; MAE {mae:.4f} RMSE "
          f"{rmse:.4f} from the counts vs {metrics['test/MAE']:.4f} "
          f"{metrics['test/RMSE']:.4f} from the COCO files", flush=True)
    if abs(mae - metrics["test/MAE"]) > 1e-9 or abs(rmse - metrics["test/RMSE"]) > 1e-9:
        fail(f"{name}: MAE/RMSE of the COCO files differ from the detection counts'")
    if not all(math.isfinite(v) for v in metrics.values()):
        fail(f"{name}: non-finite metrics {metrics}")


#: phase 5b's attention backward against ``torch.autograd.grad`` of ``attention_plain``
#: in f32 on the same card, per element of each gradient relative to that gradient's
#: largest element: dq, dk and dv within one bf16 ulp (the port rounds them to bf16, up
#: to 2^-8 of an element, and its dv takes the forward's bf16-rounded p, where the f32
#: reference rounds nothing); the tables' gradients, f32 on both sides, within 1e-4 (f32
#: sums over BH x S in another order)
BWD_TOL = 2.0 ** -7
BWD_TABLE_TOL = 1e-4
#: the backward checks at main-path shapes: (windowed, bias, head dim, grid, BH): the 4
#: global blocks and the 8 windowed blocks of a batch of 4 at 1024 (ViT-B 12 heads of 64,
#: ViT-H 16 of 80; 25 windows of 14x14 an image), the global kernel also without its bias
BWD_CASES = ((False, True, 64, (64, 64), 48), (False, False, 64, (64, 64), 48),
             (True, True, 64, (14, 14), 1200), (False, True, 80, (64, 64), 64),
             (False, False, 80, (64, 64), 64), (True, True, 80, (14, 14), 1600))
#: phase 5b's synthetic train split: 8 train images, then 4 val images, objects of 30-46
#: px on FSC-147's 384 x 512 (all at 1024: training takes no small-object bucket)
TRAIN_SIDES = (30, 38, 46, 34, 42, 30, 38, 46, 32, 40, 44, 36)
TRAIN_IMAGES = 8
#: launches of one train step of 4 images: the encoder's 4 global and 8 windowed blocks
#: forward (the backward is PyTorch), and no correlation (the train forward's template
#: capacity is 191, the FFT route), NMS or int8 kernel
TRAIN_STEP_LAUNCHES = {"global_attn": 4, "window_attn": 8, "xcorr": 0, "nms": 0,
                       "xcorr_int8": 0, "int8_mm": 0, "int8_conv": 0, "add1": 0,
                       "global_attn_d80": 0, "window_attn_d80": 0}
#: the gradient's global norm through the kernels against the same step with the
#: attention through ``attention_plain`` on the card, relative: both are bf16 networks
#: (12 blocks of bf16 activations; the two attentions round p at other points)
GRAD_NORM_TOL = 2e-2
#: a resumed run (2 epochs, then 1) against 3 uninterrupted epochs: ||p_R - p_U|| over
#: the head's parameters relative to ||p_U - p_0||, what the run moved them. The card's
#: atomics (the gathers' and the interpolations' backward, cuDNN's weight gradients) sum
#: in a varying order, and Adam's first updates are +-lr for any gradient above eps, so
#: a gradient near 0 can flip an element's step; the bulk must agree
RESUME_TOL = 1e-2


def check_attention_backward(torch, cuda_attn, windowed: bool, has_bias: bool, d: int,
                             grid, bh: int, seed: int) -> dict:
    """One attention Function's backward (``attention_backward``, PyTorch on the card)
    at a main-path shape against ``torch.autograd.grad`` of ``attention_plain`` in f32 on
    the same inputs: dq, dk, dv and the gradients of the compact (2g - 1, d) tables
    (through ``get_rel_pos``, as the ViT passes them), each within BWD_TOL of its
    largest element. Times the kernel forward, the backward and the f32 reference's
    backward; the bound is the backward's operations, 2.5x the forward's (the scores
    recomputed, dp, dv, dq and dk: five products of the forward's two), at the bf16
    peak, and the same at the f32 peak of the f32 products it performs."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    gh, gw = grid
    s = gh * gw
    scale = d ** -0.5
    q, k, v, g = (torch.randn(bh, s, d, generator=gen, device="cuda").bfloat16()
                  for _ in range(4))
    tabs = [torch.randn(2 * n - 1, d, generator=gen, device="cuda") * 0.1
            for n in grid] if has_bias else []
    leaves = [t.requires_grad_() for t in (q, k, v, *tabs)]
    f32 = [t.detach().float().requires_grad_() for t in leaves]

    def run(qkv, tables, plain=False):
        rel = [cuda_attn.get_rel_pos(n, n, t) for n, t in zip(grid, tables)]
        if plain:
            proj = cuda_attn.bias_projections(qkv[0], *rel, grid) if rel else (None, None)
            return cuda_attn.attention_plain(*qkv, *proj, grid, scale)
        if windowed:
            return cuda_attn.window_attention(*qkv, *rel, grid, scale)
        return cuda_attn.global_attention(*qkv, *(tables or (None, None)), grid, scale)

    out = run(leaves[:3], leaves[3:])
    got = torch.autograd.grad(out, leaves, g, retain_graph=True)
    want_out = run(f32[:3], f32[3:], plain=True)
    want = torch.autograd.grad(want_out, f32, g.float(), retain_graph=True)
    torch.cuda.synchronize()
    names = ("dq", "dk", "dv", "d_rel_pos_h", "d_rel_pos_w")
    errs = {}
    for name, a, b in zip(names, got, want):
        errs[name] = ((a.float() - b).abs().max() / b.abs().max()).item()
    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: run(leaves[:3], leaves[3:]), reps=5, warmup=1)
    bwd_ms = cuda_ms(lambda: torch.autograd.grad(out, leaves, g, retain_graph=True),
                     reps=5, warmup=1)
    plain_ms = cuda_ms(lambda: torch.autograd.grad(want_out, f32, g.float(),
                                                   retain_graph=True), reps=3, warmup=1)
    del out, want_out, got, want
    torch.cuda.empty_cache()
    flops = 2.5 * 4.0 * bh * s * s * d
    nbytes = 7 * bh * s * d * 2 + sum(t.numel() for t in tabs) * 4 * 2
    ok = all(e <= (BWD_TOL if n in names[:3] else BWD_TABLE_TOL) for n, e in errs.items())
    return dict(errs=errs, ok=ok, fwd_ms=fwd_ms,
                bwd_ms=bwd_ms, plain_bwd_ms=plain_ms,
                bound=bound(flops, nbytes, PEAK_BF16_FLOPS),
                bound_f32=bound(flops, nbytes, PEAK_F32_FLOPS))


def check_backward_kernels(torch, cuda_attn, card) -> list:
    """Phase 5b, first part: every BWD_CASES backward; returns their records."""
    records = []
    for i, (windowed, has_bias, d, grid, bh) in enumerate(BWD_CASES):
        r = check_attention_backward(torch, cuda_attn, windowed, has_bias, d, grid, bh,
                                     SEED + 50 + i)
        name = (f"{'window' if windowed else 'global'}_attn"
                f"{'' if has_bias else '_nobias'}{'' if d == 64 else f'_d{d}'}")
        (b_ms, by), (f32_ms, _) = r["bound"], r["bound_f32"]
        print(f"backward {name} BH {bh}, {grid[0]}x{grid[1]}, D {d}: backward "
              f"{r['bwd_ms']:.4f} ms beside the kernel forward {r['fwd_ms']:.4f} ms; bound "
              f"{b_ms:.4f} ms ({by}, bf16 peak; {f32_ms:.4f} ms at the f32 peak of its f32 "
              f"products); f32 autograd of attention_plain {r['plain_bwd_ms']:.4f} ms; "
              "error / max: " + ", ".join(f"{k} {v:.3e}" for k, v in r["errs"].items())
              + f" (tol {BWD_TOL:.3e}; tables {BWD_TABLE_TOL:.0e}) [{card}]", flush=True)
        if not r["ok"]:
            fail(f"the {name} backward disagrees with the f32 autograd of attention_plain")
        records.append(dict(name=name, route="pytorch", source="tmr_tpu_torch/ops/cuda_attn.py",
                            bh=bh, grid=list(grid), d=d, bwd_ms=r["bwd_ms"],
                            fwd_ms=r["fwd_ms"], plain_bwd_ms=r["plain_bwd_ms"],
                            bound_ms=b_ms, bound_by=by, bound_f32_ms=f32_ms,
                            max_rel_err=max(r["errs"].values())))
    return records


def head_diff(torch, a: dict, b: dict, names) -> float:
    """||a - b|| over ``names``."""
    return math.sqrt(sum((a[n].float() - b[n].float()).pow(2).sum().item() for n in names))


def grad_norm(torch, model, batch, cfg, capacity: int) -> float:
    """The global norm of the loss's gradient over every parameter, frozen included."""
    from tmr_tpu_torch.train.state import compute_losses

    model.zero_grad(set_to_none=True)
    dev = next(model.parameters()).device
    ex = torch.as_tensor(batch["exemplars"], device=dev)
    out = model(torch.as_tensor(batch["image"], device=dev), ex, capacity)
    loss = compute_losses(out, {"exemplars": ex, "gt_boxes": batch["gt_boxes"],
                                "gt_valid": batch["gt_valid"]},
                          cfg.positive_threshold, cfg.negative_threshold)["loss"]
    loss.backward()
    norm = math.sqrt(sum(p.grad.float().pow(2).sum().item() for p in model.parameters()
                         if p.grad is not None))
    model.zero_grad(set_to_none=True)
    return norm


def step_parts(torch, ts, model, cfg, batch, capacity: int, reps: int = 3) -> dict:
    """One train step cut in three, each synchronized: the forward with the losses, the
    backward, the optimizer (``apply_gradients``: the finite check, the clip, AdamW);
    mean ms over ``reps`` steps on ``batch``."""
    from tmr_tpu_torch.train.state import compute_losses

    dev = next(model.parameters()).device
    img = torch.as_tensor(batch["image"], device=dev)
    ex = torch.as_tensor(batch["exemplars"], device=dev)
    t = {"forward": 0.0, "backward": 0.0, "optimizer": 0.0}
    for _ in range(reps):
        for p in ts.params.values():
            p.grad = None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = model(img, ex, capacity)
        loss = compute_losses(out, {"exemplars": ex, "gt_boxes": batch["gt_boxes"],
                                    "gt_valid": batch["gt_valid"]},
                              cfg.positive_threshold, cfg.negative_threshold)["loss"]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        ts.apply_gradients({n: torch.zeros_like(p) if p.grad is None else p.grad
                            for n, p in ts.params.items()}, loss)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for key, dt in zip(t, (t1 - t0, t2 - t1, t3 - t2)):
            t[key] += dt * 1e3 / reps
    for p in ts.params.values():
        p.grad = None
    return t


def check_train_path(torch, np, pred, card, modules, backward=(), profile=False) -> dict:
    """Phase 5b, second part: ``Trainer.fit`` of ``preset("TMR_FSCD147")`` (SAM ViT-B at
    1024, batch 4, bf16, frozen backbone) from phase 4's weights on a synthetic
    FSCD-147-layout train split of 8 images (2 steps an epoch) with 4 val images: 3
    epochs in one run, and 2 epochs then a resumed run to 3. Every step must launch
    exactly TRAIN_STEP_LAUNCHES and every validation batch EVAL_LAUNCHES; the backbone
    must stay bit for bit phase 4's while the head moves; the resumed run must reach the
    uninterrupted one's parameters within RESUME_TOL; the gradient's norm must agree
    with the same step through ``attention_plain``; 8 steps on one batch must lower its
    loss; ``xcorr`` on a tensor that requires grad must raise, and a non-finite gradient
    must be discarded. Returns the numbers PERF.md keeps."""
    import dataclasses
    import os
    import tempfile

    from tmr_tpu_torch.config import preset
    from tmr_tpu_torch.train import loop
    from tmr_tpu_torch.train.state import TrainState

    _build, cuda_attn, cuda_xcorr = modules
    p4 = {k: v.detach().clone() for k, v in pred.model.state_dict().items()}
    steps, evals = [], []
    make_step = loop.make_train_step

    def recording_make_step(model, cfg):
        step = make_step(model, cfg)

        def run(state, batch):
            torch.cuda.synchronize()
            before = dict(_build.LAUNCHES)
            t0 = time.perf_counter()
            losses = step(state, batch)
            torch.cuda.synchronize()
            steps.append(dict(ms=(time.perf_counter() - t0) * 1e3,
                              launches={k: v - before[k] for k, v in _build.LAUNCHES.items()},
                              loss=float(losses["loss"]),
                              skipped=float(losses["skipped_nonfinite"])))
            return losses

        return run

    class RecordingTrainer(loop.Trainer):
        def _eval_batch(self, batch):
            torch.cuda.synchronize()
            before = dict(_build.LAUNCHES)
            out = super()._eval_batch(batch)
            torch.cuda.synchronize()
            evals.append({k: v - before[k] for k, v in _build.LAUNCHES.items()})
            return out

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        images = eval_split(np, os.path.join(tmp, "fsc"), TRAIN_SIDES, TRAIN_IMAGES)
        base = preset("TMR_FSCD147", datapath=os.path.join(tmp, "fsc"), num_workers=4,
                      seed=SEED, eval_batch_size=4, nowandb=True)

        def fit(tag, epochs, resume=False):
            cfg = dataclasses.replace(base, logpath=os.path.join(tmp, tag),
                                      max_epochs=epochs, resume=resume)
            tr = RecordingTrainer(cfg, device="cuda")
            n0 = len(steps)
            t0 = time.perf_counter()
            tr.fit(params=p4)
            return tr, steps[n0:], time.perf_counter() - t0

        loop.make_train_step = recording_make_step
        try:
            with in_memory_images(images):
                torch.cuda.reset_peak_memory_stats()
                _build.reset_launches()
                whole, w_steps, w_s = fit("whole", 3)
                launches = dict(_build.LAUNCHES)
                peak_gb = torch.cuda.max_memory_allocated() / 1e9
                part, p_steps, _ = fit("part", 2)
                del part
                resumed, r_steps, _ = fit("part", 3, resume=True)
                it = iter(whole._loaders()[0])
                batch = next(it)
                it.close()
        finally:
            loop.make_train_step = make_step
    all_steps = w_steps + p_steps + r_steps
    print(f"train path launches over the uninterrupted run ({len(w_steps)} steps, one "
          f"validation batch): {json.dumps(launches)}", flush=True)
    bad = [i for i, r in enumerate(all_steps) if r["launches"] != TRAIN_STEP_LAUNCHES]
    if bad or len(all_steps) != 12:
        fail(f"train steps {bad} of {len(all_steps)} launched other than "
             f"{TRAIN_STEP_LAUNCHES}: {[all_steps[i]['launches'] for i in bad]}")
    if len(evals) != 2 or any(e != EVAL_LAUNCHES for e in evals):
        fail(f"validation batches launched {evals}, expected 2 x {EVAL_LAUNCHES}")
    losses = [r["loss"] for r in all_steps]
    if not all(math.isfinite(x) for x in losses) or any(r["skipped"] for r in all_steps):
        fail(f"train losses {losses}, skipped {[r['skipped'] for r in all_steps]}")
    warm = [r["ms"] for r in w_steps[1:]]
    ms = sum(warm) / len(warm)
    out.update(step_ms=ms, first_step_ms=w_steps[0]["ms"], images_per_s=4e3 / ms,
               peak_gb=peak_gb, fit_s=w_s, losses=losses)
    print(f"train path: ms per step of 4 images at 1024 (warm, the uninterrupted run's "
          f"steps 1-5): {ms:.1f} (steps {', '.join(f'{x:.1f}' for x in warm)}; first "
          f"{w_steps[0]['ms']:.1f}) = {4e3 / ms:.2f} images/s; peak device memory "
          f"{peak_gb:.2f} GB; 3 epochs with validation at epoch 0 {w_s:.1f} s; losses "
          f"{', '.join(f'{x:.3f}' for x in losses[:6])} [{card}]", flush=True)

    # the frozen backbone bit for bit, the head moved
    got = {k: v.detach() for k, v in whole.model.state_dict().items()}
    head = [n for n, lab in whole.state.labels.items() if lab == "head"]
    frozen = [n for n, lab in whole.state.labels.items() if lab == "frozen"]
    moved_bb = [n for n in frozen if not torch.equal(got[n], p4[n])]
    moved = [n for n in head if not torch.equal(got[n], p4[n])]
    print(f"train path: {len(frozen)} backbone tensors, {len(moved_bb)} moved; {len(head)} "
          f"head tensors, {len(moved)} moved; {whole.state.count} updates", flush=True)
    if moved_bb or len(moved) < len(head) // 2 or not frozen:
        fail(f"frozen backbone moved ({moved_bb[:3]}) or head did not ({len(moved)})")

    # resume against the uninterrupted run
    res = {k: v.detach() for k, v in resumed.model.state_dict().items()}
    span = head_diff(torch, got, p4, head)
    diff = head_diff(torch, res, got, head)
    worst = max((res[n].float() - got[n].float()).abs().max().item() for n in head)
    lr = whole.cfg.lr
    print(f"train path resume: ||resumed - whole|| over the head {diff:.4e} = "
          f"{diff / span:.4e} of ||whole - phase 4|| ({span:.4e}), tol {RESUME_TOL}; largest "
          f"element {worst:.3e} ({worst / lr:.3f} lr)", flush=True)
    if diff > RESUME_TOL * span or any(not torch.equal(res[n], p4[n]) for n in frozen):
        fail("the resumed run does not reach the uninterrupted run's parameters")
    out.update(resume_rel=diff / span)
    del resumed

    # the gradient through the kernels against attention_plain on the card
    model = whole.model
    model.load_state_dict(p4)
    cap = max(whole.cfg.template_buckets)
    norm = grad_norm(torch, model, batch, whole.cfg, cap)
    with plain_attention(cuda_attn):
        plain_norm = grad_norm(torch, model, batch, whole.cfg, cap)
    torch.cuda.empty_cache()
    print(f"train path gradient global norm (phase 4's weights, one batch of 4): kernels "
          f"{norm:.6e}, attention_plain on the card {plain_norm:.6e}, relative "
          f"{abs(norm - plain_norm) / plain_norm:.3e} (tol {GRAD_NORM_TOL})", flush=True)
    if not (math.isfinite(norm) and abs(norm - plain_norm) <= GRAD_NORM_TOL * plain_norm):
        fail("the train step's gradient norm disagrees with attention_plain's")
    out.update(grad_norm=norm, plain_grad_norm=plain_norm)

    # 8 steps on one batch lower its loss; a non-finite gradient moves nothing
    ts = TrainState(model, whole.cfg, steps_per_epoch=100)
    step = make_step(model, whole.cfg)
    fixed = [float(step(ts, batch)["loss"]) for _ in range(8)]
    print(f"train path, 8 steps on one batch: losses {', '.join(f'{x:.4f}' for x in fixed)}",
          flush=True)
    if not (all(math.isfinite(x) for x in fixed) and fixed[-1] < fixed[0]):
        fail("8 steps on one batch did not lower its loss")
    before = {n: p.detach().clone() for n, p in ts.params.items() if ts.labels[n] == "head"}
    nan = {n: torch.full_like(p, float("nan")) if i == 0 else torch.zeros_like(p)
           for i, (n, p) in enumerate(ts.params.items())}
    if ts.apply_gradients(nan) or ts.count != 8 or any(
            not torch.equal(ts.params[n], p) for n, p in before.items()):
        fail("a non-finite gradient was not discarded")

    # where a step's time goes: forward, backward (the attention's share from the
    # backward checks at the same shapes), optimizer
    parts = step_parts(torch, ts, model, whole.cfg, batch, cap)
    per_call = {r["name"]: r["bwd_ms"] for r in backward}
    attn_bwd = 4 * per_call.get("global_attn", 0.0) + 8 * per_call.get("window_attn", 0.0)
    total = sum(parts.values())
    print(f"train path step parts (one batch of 4, synchronized, mean of 3): "
          + ", ".join(f"{k} {v:.1f} ms" for k, v in parts.items())
          + f"; backward share {parts['backward'] / total:.3f}; the attention backward "
          f"(4 global + 8 windowed calls at phase 5b's per-call times) {attn_bwd:.1f} ms = "
          f"{attn_bwd / parts['backward']:.3f} of the backward [{card}]", flush=True)
    out.update(parts_ms=parts, attn_bwd_ms=attn_bwd)
    if profile:
        profile_batch(torch, lambda: step(ts, batch), "train path",
                      "one train step of 4 images at 1024, bucket 191 (FFT)")

    # a kernel without a backward refuses an input that requires grad
    f = torch.randn(1, 2, 16, 16, device="cuda", requires_grad=True)
    try:
        cuda_xcorr.xcorr(f, torch.randn(1, 2, 3, 3, device="cuda"))
    except RuntimeError as e:
        print(f"train path: xcorr on a tensor that requires grad raises: {e}", flush=True)
    else:
        fail("xcorr took a tensor that requires grad and cut the graph")
    del whole, model, ts
    torch.cuda.empty_cache()
    return out


def check_1536_objectness(torch, pred, Predictor, imgs, ex) -> None:
    """Image 0 of a 1536 batch of 4: its objectness on the card against an f32 CPU run of
    the same port and weights, within OBJ_REL_TOL of the map's max."""
    from tmr_tpu_torch.config import preset

    obj = pred.forward(imgs, ex)["objectness"][0].float().cpu()
    ref = Predictor(preset("TMR_FSCD147", compute_dtype="float32"), device="cpu")
    ref.model.load_state_dict({k: v.cpu() for k, v in pred.model.state_dict().items()})
    t0 = time.perf_counter()
    ref_obj = ref.forward(imgs[:1], ex[:1])["objectness"][0]
    cpu_s = time.perf_counter() - t0
    diff = (obj - ref_obj).abs().max().item()
    scale = ref_obj.abs().max().item()
    print(f"eval 1536 bucket objectness image 0 vs f32 CPU run: shape "
          f"{tuple(obj.shape)}, max_abs_diff {diff:.4e}, map max {scale:.4e}, "
          f"{diff / scale:.4f} of the max, tol {OBJ_REL_TOL} ({cpu_s:.1f} s on the CPU)",
          flush=True)
    if not (torch.isfinite(obj).all() and obj.shape == (192, 192)
            and diff <= OBJ_REL_TOL * scale):
        fail("the 1536 bucket's objectness map disagrees with the f32 CPU reference")


@contextlib.contextmanager
def plain_attention(cuda_attn):
    """While the block runs, the ViT's attention blocks call ``attention_plain`` on the
    card (projections by ``bias_projections``, dense f32 scores) in place of the kernels:
    a yardstick of this script, never a path of the port."""
    from tmr_tpu_torch.models import vit

    def plain(q, k, v, rh, rw, grid, scale, expand):
        if expand:  # the global blocks pass the compact tables
            rh, rw = (cuda_attn.get_rel_pos(g, g, t) for g, t in zip(grid, (rh, rw)))
        rel = cuda_attn.bias_projections(q, rh, rw, grid)
        return cuda_attn.attention_plain(q, k, v, *rel, grid, scale)

    saved = vit.global_attention, vit.window_attention
    vit.global_attention = lambda *a: plain(*a, expand=True)
    vit.window_attention = lambda *a: plain(*a, expand=False)
    try:
        yield
    finally:
        vit.global_attention, vit.window_attention = saved


def check_vit_h_path(torch, np, batches, caps, card, modules):
    """Phase 4c: ``preset("TMR_FSCD147", backbone="sam_vit_h")`` (SAM ViT-H at 1024, 32
    blocks of 1280 over 16 heads of 80, batch 4, bf16) with seeded random weights on the
    phase 4 batches; returns its launches and the predictor."""
    from tmr_tpu_torch.config import preset
    from tmr_tpu_torch.inference import Predictor, detections_to_numpy

    _build, cuda_attn, cuda_nms = modules
    t0 = time.perf_counter()
    hpred = Predictor(preset("TMR_FSCD147", backbone="sam_vit_h"), device="cuda")
    hpred.init_params(SEED)
    torch.cuda.synchronize()
    n_enc = sum(p.numel() for p in hpred.model.backbone.parameters())
    n_all = sum(p.numel() for p in hpred.model.parameters())
    print(f"ViT-H path: {n_enc} encoder parameters ({n_all} in all), built and initialized "
          f"on the card in {time.perf_counter() - t0:.1f} s", flush=True)
    hcaps = [hpred.pick_capacity(ex, 1024) for _, ex in batches]
    if hcaps != caps:
        fail(f"ViT-H path: exemplars picked buckets {hcaps}, expected {caps}")
    with call_count(cuda_attn, "bias_projections") as proj_calls:
        times, outs, launches = run_batches(torch, hpred, batches, detections_to_numpy,
                                            _build)
    report_batches(np, "ViT-H path", caps, times, outs, card)
    print(f"ViT-H path launches over the 3 batches: {json.dumps(launches)}", flush=True)
    print(f"ViT-H path bias_projections calls over the warm-up and 3 batches: "
          f"{len(proj_calls)} (expected 0)", flush=True)
    if proj_calls:
        fail(f"bias_projections ran {len(proj_calls)} times on the ViT-H path, expected 0")
    if launches != VIT_H_LAUNCHES:
        fail(f"ViT-H path launches {launches}, expected {VIT_H_LAUNCHES}")
    check_main_path_nms(torch, lambda: hpred(*batches[0]), cuda_nms, "ViT-H path batch 0")

    imgs, ex = batches[0]
    obj = hpred.forward(imgs, ex)["objectness"][0].float().cpu()
    with plain_attention(cuda_attn), torch.inference_mode():
        plain_obj = hpred.forward(imgs[:1], ex[:1])["objectness"][0].float().cpu()
    torch.cuda.empty_cache()
    ref = Predictor(preset("TMR_FSCD147", backbone="sam_vit_h", compute_dtype="float32"),
                    device="cpu")
    ref.model.load_state_dict({k: v.cpu() for k, v in hpred.model.state_dict().items()})
    t0 = time.perf_counter()
    with torch.inference_mode():
        ref_obj = ref.forward(imgs[:1], ex[:1])["objectness"][0]
    cpu_s = time.perf_counter() - t0
    del ref
    scale = ref_obj.abs().max().item()
    diff = (obj - ref_obj).abs().max().item()
    plain_diff = (plain_obj - ref_obj).abs().max().item()
    kernel_plain = (obj - plain_obj).abs().max().item()
    print(f"ViT-H objectness image 0 vs an f32 CPU run ({cpu_s:.1f} s on the CPU), map max "
          f"{scale:.4e}: kernels (bf16, batch of 4) max_abs_diff {diff:.4e} = "
          f"{diff / scale:.4f} of the max, tol {OBJ_REL_TOL}; the same bf16 network with "
          f"the attention through attention_plain on the card (image 0 alone) "
          f"{plain_diff:.4e} = {plain_diff / scale:.4f}; kernels vs that run "
          f"{kernel_plain:.4e} = {kernel_plain / scale:.4f}", flush=True)
    if not (torch.isfinite(obj).all() and obj.shape == (128, 128)
            and diff <= OBJ_REL_TOL * scale):
        fail("ViT-H objectness map disagrees with the f32 CPU reference")
    return launches, hpred


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="after each path, print a torch.profiler breakdown of "
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
    # 3 exemplars an image for phase 4d; phase 4 takes the first
    multi_batches = [synthetic_batch(np, rng, BUCKET_SIDES_PX[b], k=3) for b in (9, 17, 33)]
    batches = [(imgs, ex[:, :1].copy()) for imgs, ex in multi_batches]
    multi_batches = [(imgs, pad_exemplar_rows(ex, MULTI_K_REAL))
                     for imgs, ex in multi_batches]
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
    print(f"bias_projections calls over the warm-up and 3 batches: {len(proj_calls)} "
          f"(expected 0)", flush=True)
    if proj_calls:
        fail(f"bias_projections ran {len(proj_calls)} times on the card, expected 0")
    if launches["window_attn"] != 24:
        fail(f"window_attn launched {launches['window_attn']} times, expected 24")
    missing = [k for k in ("global_attn", "window_attn", "xcorr", "nms") if launches[k] <= 0]
    if missing:
        fail(f"kernels never launched on the main path: {missing}")
    stray = [k for k in ("xcorr_int8", "int8_mm", "int8_conv", "add1", "global_attn_d80",
                         "window_attn_d80") if launches[k]]
    if stray:
        fail(f"int8, probe or head dim 80 kernels launched on the ViT-B bf16 path: {stray}")
    check_main_path_nms(torch, lambda: pred(*batches[0]), cuda_nms)

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
    # 4d. the multi-exemplar path on the same weights
    check_multi_path(torch, np, pred, qpred, multi_batches, caps,
                     sum(times) / len(times), card, (_build, cuda_nms))
    if args.profile:
        profile_batch(torch, lambda: pred(*batches[2]), "main path")
        profile_batch(torch, lambda: qpred(*batches[2]), "int8 path")
        profile_batch(torch, lambda: pred.predict_multi_batch(
            *multi_batches[2], np.array(MULTI_K_REAL, np.int32)), "multi path",
            "one batch of 4 images x 3 exemplars, bucket 33")
    del qpred
    torch.cuda.empty_cache()

    # 5. eval through Trainer.test on the same weights, both size buckets
    check_eval_path(torch, np, pred, card, sum(times) / len(times), (_build,),
                    args.profile)
    # 5b. training: the attention backward at main-path shapes, then Trainer.fit from the
    # same weights
    backward = check_backward_kernels(torch, cuda_attn, card)
    train = check_train_path(torch, np, pred, card, (_build, cuda_attn, cuda_xcorr),
                             backward, args.profile)
    print(json.dumps({"train": train, "backward": backward}), flush=True)
    del pred
    torch.cuda.empty_cache()

    # 4c. SAM ViT-H (head dim 80) on the same batches
    hlaunches, hpred = check_vit_h_path(torch, np, batches, caps, card,
                                        (_build, cuda_attn, cuda_nms))
    if args.profile:
        profile_batch(torch, lambda: hpred(*batches[2]), "ViT-H path")
    del hpred

    # 6. the kernels line
    meta = {
        "global_attn": ("tmr_tpu_torch/csrc/attn.cu", "tmr_tpu/ops/pallas_attn.py:59"),
        "window_attn": ("tmr_tpu_torch/csrc/attn.cu", "tmr_tpu/ops/pallas_attn.py:350"),
        "global_attn_d80": ("tmr_tpu_torch/csrc/attn.cu", "tmr_tpu/ops/pallas_attn.py:59"),
        "window_attn_d80": ("tmr_tpu_torch/csrc/attn.cu", "tmr_tpu/ops/pallas_attn.py:350"),
        "xcorr": ("tmr_tpu_torch/csrc/xcorr.cu", "tmr_tpu/ops/pallas_xcorr.py:47"),
        "nms": ("tmr_tpu_torch/csrc/nms.cu", "tmr_tpu/ops/pallas_nms.py:32"),
        "xcorr_int8": ("tmr_tpu_torch/csrc/xcorr.cu", "tmr_tpu/ops/xcorr.py:171"),
        "int8_mm": ("tmr_tpu_torch/csrc/int8_mm.cu", "tmr_tpu/ops/pallas_int8.py:50"),
        "int8_conv": ("tmr_tpu_torch/csrc/int8_mm.cu", "tmr_tpu/ops/pallas_int8.py:50"),
        "add1": ("tmr_tpu_torch/csrc/probe.cu", "scripts/gate_probe.py:84"),
    }
    path_launches = dict(launches, xcorr_int8=qlaunches["xcorr_int8"],
                         int8_mm=qlaunches["int8_mm"], int8_conv=qlaunches["int8_conv"],
                         add1=probe_launches,
                         global_attn_d80=hlaunches["global_attn_d80"],
                         window_attn_d80=hlaunches["window_attn_d80"])
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
