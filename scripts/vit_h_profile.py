#!/usr/bin/env python3
"""Where a SAM ViT-H batch's device time goes, with one or more versions of the attention
kernels' source, in turns on one card.

Run from the root of a checkout on a machine with a Hopper GPU and the CUDA toolkit:

    python3 scripts/vit_h_profile.py [--src A.cu B.cu ...] [--rounds 2]

Builds each ``attn.cu`` source given (default: this checkout's
``tmr_tpu_torch/csrc/attn.cu``) into its own library, one ``nvcc`` each, all started
together, into the git-ignored ``tmr_tpu_torch/_build/variants/``. Then builds phase 4c's
predictor of ``chip_smoke.py`` (``preset("TMR_FSCD147", backbone="sam_vit_h")``, seeded
weights) and its third batch (4 images at 1024, bucket 33), and for each round and each
source in turn (A B, then B A, ...) loads that source's library in place of the port's
attention library, runs the batch twice (warm-up), and profiles it once with
``chip_smoke.profile_batch`` (wall, device kernel time, busy share, the top kernels). Every
source must have the C interface of this checkout's (``tmr_global_attn``,
``tmr_window_attn``). Prints the card. Imports nothing of JAX or ``tmr_tpu``; exits 2
without a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", nargs="+", type=Path,
                    help="attn.cu sources to profile in turns (default: this checkout's)")
    ap.add_argument("--rounds", type=int, default=2,
                    help="rounds over the sources, every other one in reverse order")
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("vit_h_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from tmr_tpu_torch.config import preset
    from tmr_tpu_torch.inference import Predictor
    from tmr_tpu_torch.ops import _build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    srcs = args.src or [_build.CSRC / "attn.cu"]
    out = _build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = []
    for i, src in enumerate(srcs):
        so = out / f"libattn_profile_{i}.so"
        cmd = ["/usr/local/cuda/bin/nvcc", *_build.NVCC_FLAGS, "-o", str(so), str(src)]
        procs.append((src, so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
    libs = []
    for src, so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {src}:\n{log}")
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in _build.SIGNATURES["attn"].items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        libs.append(lib)

    pred = Predictor(preset("TMR_FSCD147", backbone="sam_vit_h"), device="cuda")
    pred.init_params(chip_smoke.SEED)
    rng = np.random.default_rng(chip_smoke.SEED)
    # phase 4's draws: the batches of buckets 9, 17 and 33 (3 exemplars each); the third
    imgs, ex = [chip_smoke.synthetic_batch(np, rng, chip_smoke.BUCKET_SIDES_PX[b], k=3)
                for b in (9, 17, 33)][2]
    ex = ex[:, :1].copy()
    for r in range(args.rounds):
        order = range(len(srcs)) if r % 2 == 0 else reversed(range(len(srcs)))
        for i in order:
            with _build._LOCK:
                _build._LIBS["attn"] = libs[i]
                for fn in _build.SIGNATURES["attn"]:
                    _build._FNS.pop(fn, None)
            for _ in range(2):
                pred(imgs, ex)
            chip_smoke.profile_batch(torch, lambda: pred(imgs, ex), f"ViT-H path, {srcs[i]}",
                                     f"one batch of 4, bucket 33, round {r}")
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
