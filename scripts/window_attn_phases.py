#!/usr/bin/env python3
"""Where the windowed attention kernel's time goes on the card.

Run from the root of a checkout on a machine with a Hopper GPU and the CUDA toolkit:

    python3 scripts/window_attn_phases.py

Builds variants of ``tmr_tpu_torch/csrc/attn.cu`` in which the windowed kernel skips
phases (text edits of the source, one ``nvcc`` each, started together, into the
git-ignored ``tmr_tpu_torch/_build/phases/``), and times each on SAM's main-path shape
(1200 window-heads of 14x14 tokens, head dim 64, bf16) with CUDA events, the variants
in turns over three rounds. Variants that skip a phase compute garbage; only ``full``
and ``kv_after_projections`` are held to the plain version (printed max error). Prints
the card, one line per variant, and a JSON line of the times.

Imports nothing of JAX or ``tmr_tpu``; exits 2 without a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PROJ = "  window_projections(sQ, rh, rw, sRH, sRW, gh, gw, st_h, GWP);\n"
STRIPS = "strip * 16 < sp; strip += WIN_WARPS"
Q_LOOP = "  for (int i = threadIdx.x; i < sp * 8; i += blockDim.x) {"
KV_LOOP = "  for (int i = threadIdx.x; i < nkey * 8; i += blockDim.x) {"
COMMIT = "  cp_async_commit();\n"


def _sub(src: str, old: str, new: str) -> str:
    if old not in src:
        raise SystemExit(f"window_attn_phases: attn.cu no longer contains {old!r}")
    return src.replace(old, new)


def variants(src: str) -> dict:
    """name -> source. The kernel's phases: cp.async of Q, then of K and V; the bias
    projections (after Q lands, with K and V in flight); the attention strips."""
    kv0 = src.index(KV_LOOP)
    kv1 = src.index(COMMIT, kv0) + len(COMMIT)
    kv = src[kv0:kv1]
    no_strips = _sub(src, STRIPS, "strip * 16 < 0; strip += WIN_WARPS")
    kv_after = _sub(src[:kv0] + src[kv1:], "  cp_async_wait<1>();\n  __syncthreads();",
                    "  cp_async_wait<0>();\n  __syncthreads();")
    kv_after = _sub(kv_after, PROJ, PROJ + kv)
    q0 = src.index(Q_LOOP)
    return {
        "full": src,
        "loads_only": _sub(no_strips, PROJ, ""),
        "loads_projections": no_strips,
        "loads_strips": _sub(src, PROJ, ""),
        "strips_only": _sub(src[:q0] + src[kv1:], PROJ, ""),
        "kv_after_projections": kv_after,
    }


def build(srcs: dict, out: Path, flags) -> dict:
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in srcs.items():
        cu = out / f"{name}.cu"
        cu.write_text(text)
        cmd = ["/usr/local/cuda/bin/nvcc", *flags, "-o", str(out / f"lib{name}.so"), str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for the {name} variant:\n{log}")
        lib = ctypes.CDLL(str(out / f"lib{name}.so"))
        lib.tmr_window_attn.argtypes = [P, P, P, P, P, P, I, I, I, I, F, P]
        libs[name] = lib
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=50, help="launches per timing")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("window_attn_phases: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from tmr_tpu_torch.ops import _build, cuda_attn

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    srcs = variants((_build.CSRC / "attn.cu").read_text())
    libs = build(srcs, _build.BUILD_DIR / "phases", _build.NVCC_FLAGS)

    gen = torch.Generator(device="cuda").manual_seed(0)
    bh, g, d, scale = 4 * 25 * 12, 14, 64, 64 ** -0.5
    q, k, v = (torch.randn(bh, g * g, d, generator=gen, device="cuda").bfloat16()
               for _ in range(3))
    rh, rw = (torch.randn(g, g, d, generator=gen, device="cuda") * 0.1 for _ in range(2))
    want = cuda_attn.attention_plain(q, k, v, *cuda_attn.bias_projections(q, rh, rw, (g, g)),
                                     (g, g), scale).float()
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream

    def launch(lib):
        rc = lib.tmr_window_attn(q.data_ptr(), k.data_ptr(), v.data_ptr(), rh.data_ptr(),
                                 rw.data_ptr(), out.data_ptr(), bh, g * g, g, g, scale, stream)
        if rc:
            raise SystemExit(f"window_attn_phases: CUDA error {rc} at launch")

    def ms(lib) -> float:
        for _ in range(3):
            launch(lib)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(args.reps):
            launch(lib)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / args.reps

    times = {name: [] for name in libs}
    for _ in range(3):
        for name, lib in libs.items():
            times[name].append(ms(lib))
    print(f"card: {card}")
    for name, lib in libs.items():
        err = ""
        if name in ("full", "kv_after_projections"):
            launch(lib)
            torch.cuda.synchronize()
            err = f" max_err vs plain {(out.float() - want).abs().max().item():.3e}"
        print(f"{name:22s} ms " + " ".join(f"{t:.4f}" for t in times[name]) + err)
    print(json.dumps({"card": card, "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
