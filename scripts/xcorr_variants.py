#!/usr/bin/env python3
"""Where the f32 correlation kernel's time goes on the card: variants of the source, timed in turns.

Run from the root of a checkout on a machine with a Hopper GPU and the CUDA toolkit:

    python3 scripts/xcorr_variants.py [--variants NAME ...] [--baseline XCORR_CU ...]

Builds variants of ``tmr_tpu_torch/csrc/xcorr.cu`` made by text edits of the source
(:data:`EDITS`: phases cut out of the kernel, another warp or CTA tile), one ``nvcc
-Xptxas -v`` each, all started together, into the git-ignored
``tmr_tpu_torch/_build/variants/``. ``--baseline`` adds other sources of the same C
interface unedited (for example a parent commit's ``xcorr.cu``, unpacked beside this
checkout), named ``baseline<i>``. Prints each variant's registers and spills per
instantiation, times every variant in turns over three rounds with CUDA events on the
matcher's map (4 x 512 x 128^2 f32, T = 9, 17, 33, 65), and holds each against the plain
version with ``chip_smoke.py``'s tolerance (2e-5 x max); a variant that cuts a phase out
computes garbage and is marked so. Prints the card, one line per template size and
variant, and a JSON line of the times.

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
P, I = ctypes.c_void_p, ctypes.c_int

_MMA_OP = '"mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "\n        '
_MMA_FIRST = _MMA_OP + '"{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};"'
_MMA_ACC = _MMA_OP + '"{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"'
_PASS_LO_HI = "          mma_tf32<false>(part[mt][nb], ah, bl[kb][0], bl[kb][1]);\n"
_PASS_HI_HI = "          mma_tf32<false>(part[mt][nb], ah, bh[kb][0], bh[kb][1]);\n"
_WARPS = "constexpr int WARPS_M = 4, WARPS_N = 1;"
_STAGE = "      cp_async4(sW + r * LD + k, ok ? frow + x : fp, ok);\n"
_A_LOADS = """        const float2 top = *reinterpret_cast<const float2*>(a_row + mt * 16 * LD + 8 * s);
        const float2 bot =
            *reinterpret_cast<const float2*>(a_row + (mt * 16 + 8) * LD + 8 * s);
        uint32_t ah[4], al[4];
        split_tf32(top.x, ah[0], al[0]);
        split_tf32(bot.x, ah[1], al[1]);
        split_tf32(top.y, ah[2], al[2]);
        split_tf32(bot.y, ah[3], al[3]);
"""
_WARP_TILE = "constexpr int WM = 1, WN = 8;"

#: name -> text edits (old, new) of xcorr.cu
EDITS = {
    "full": (),
    # the products cut out: each mma becomes an empty asm that still takes its operands,
    # so the A-fragment loads and splits and the B gathers stay (garbage output)
    "no_products": ((f"asm({_MMA_FIRST}", 'asm volatile(""'),
                    (f"asm({_MMA_ACC}", 'asm volatile(""')),
    # the products alone: A operands made in registers, one xor each and distinct for
    # every s (so no two accumulators' chains are the same and none is merged), in place
    # of the A-fragment loads and splits; no staging copies (garbage output)
    "products_only": ((_A_LOADS, "        uint32_t ah[4], al[4];\n"
                                 "#pragma unroll\n"
                                 "        for (int q = 0; q < 4; ++q) {\n"
                                 "          ah[q] = bh[0][q & 1] ^ (s + 1);\n"
                                 "          al[q] = bl[0][q & 1] ^ (s + 1);\n"
                                 "        }\n"),
                      (_STAGE, "")),
    # no staging copies: the window holds whatever shared memory held (garbage output)
    "no_staging": ((_STAGE, ""),),
    # one pass in place of three: hi * hi only (1xTF32; fails the tolerance)
    "one_pass": (("<true>(part[mt][nb], al, bh", "<true>(part[mt][nb], ah, bh"),
                 ("<false>(part[mt][nb], al, bh", "<false>(part[mt][nb], ah, bh"),
                 (_PASS_LO_HI + _PASS_HI_HI, "")),
    # the tf32 rounding by cvt.rna in place of the integer add and mask
    "cvt_rna": (("  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;",
                 '  uint32_t r;\n  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));\n'
                 "  return r;"),),
    # the staged window without its NaNs made canonical
    "no_nan_pass": (("    for (int k = lane; k < COLS; k += 32) sW[r * LD + k] = "
                     "canonical_nan(sW[r * LD + k]);\n", "    ;\n"),),
    # a register cap of 128 a thread (4 CTAs of 128 threads per SM)
    "min_blocks4": (("__global__ void __launch_bounds__(THREADS)\n    xcorr_tf32_kernel",
                     "__global__ void __launch_bounds__(THREADS, 4)\n    xcorr_tf32_kernel"),),
    # another warp tile: 32 rows x 32 columns (2 m16 x 4 n8), 2 x 2 warps, same CTA tile
    "warp_32x32": ((_WARPS, "constexpr int WARPS_M = 2, WARPS_N = 2;"),
                   (_WARP_TILE, "constexpr int WM = 2, WN = 4;")),
    # a taller CTA: 8 warps of 16 x 64, 128 x 64 outputs (less halo per output)
    "cta_128x64": ((_WARPS, "constexpr int WARPS_M = 8, WARPS_N = 1;"),),
}

TS = (9, 17, 33, 65)
SHAPE = (4, 512, 128, 128)


def _sub(src: str, old: str, new: str) -> str:
    if old not in src:
        raise SystemExit(f"xcorr_variants: xcorr.cu no longer contains {old!r}")
    return src.replace(old, new)


def variants(src: str) -> dict:
    out = {}
    for name, edits in EDITS.items():
        text = src
        for old, new in edits:
            text = _sub(text, old, new)
        out[name] = text
    return out


def build(sources: dict, out: Path, flags) -> dict:
    """sources: name -> source text. One nvcc each, all started together; returns name ->
    the loaded library's ``tmr_xcorr``, its argtypes set."""
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        (out / f"xcorr_{name}.cu").write_text(text)
        cmd = ["/usr/local/cuda/bin/nvcc", *flags, "-Xptxas", "-v",
               "-o", str(out / f"libxcorr_{name}.so"), str(out / f"xcorr_{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for the {name} variant:\n{log}")
        lines = log.splitlines()
        for i, line in enumerate(lines):  # the f32 kernels' entries: spills, registers
            if "Compiling entry function" in line and "int8" not in line:
                inst = line.split("'")[1][-24:]
                stats = " | ".join(x.strip() for x in lines[i + 2:i + 4])
                print(f"ptxas {name} ...{inst}: {stats}", flush=True)
        fn = ctypes.CDLL(str(out / f"libxcorr_{name}.so")).tmr_xcorr
        fn.argtypes = [P, P, P, I, I, I, I, P]
        fns[name] = fn
    return fns


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", nargs="+", choices=list(EDITS),
                    help="variants to build (default: all)")
    ap.add_argument("--baseline", nargs="+", type=Path, default=[],
                    help="other xcorr.cu sources with the same C interface, timed unedited")
    ap.add_argument("--ts", nargs="+", type=int, default=list(TS),
                    help=f"template sizes (default: {' '.join(map(str, TS))})")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("xcorr_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from tmr_tpu_torch.ops import _build, cuda_xcorr

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    sources = {name: text for name, text in variants((_build.CSRC / "xcorr.cu").read_text())
               .items() if args.variants is None or name in args.variants}
    for i, path in enumerate(args.baseline):
        print(f"baseline{i}: {path}", flush=True)
        sources[f"baseline{i}"] = path.read_text()
    fns = build(sources, _build.BUILD_DIR / "variants", _build.NVCC_FLAGS)
    stream = torch.cuda.current_stream().cuda_stream
    b, c, h, w = SHAPE
    times = {}
    for t in args.ts:
        gen = torch.Generator(device="cuda").manual_seed(0)
        feat = torch.randn(b, c, h, w, generator=gen, device="cuda")
        tmpl = torch.randn(b, c, t, t, generator=gen, device="cuda")
        want = cuda_xcorr.xcorr_plain(feat, tmpl)
        tol = chip_smoke.XCORR_REL_TOL * want.abs().max().item()
        out = torch.empty_like(feat)

        def launch(fn):
            rc = fn(feat.data_ptr(), tmpl.data_ptr(), out.data_ptr(), b * c, h, w, t, stream)
            if rc:
                raise SystemExit(f"xcorr_variants: error {rc} at launch")

        key = f"T={t}"
        times[key] = {name: [] for name in fns}
        for _ in range(3):
            for name, fn in fns.items():
                times[key][name].append(chip_smoke.cuda_ms(lambda: launch(fn), 10, 2))
        first = None
        for name, fn in fns.items():
            out.zero_()
            launch(fn)
            torch.cuda.synchronize()
            err = (out - want).abs().max().item()
            first = out.clone() if first is None else first
            same = int((out != first).sum().item())
            ms = " ".join(f"{x:.4f}" for x in times[key][name])
            print(f"{b}x{c}x{h}x{w} {key:5s} {name:13s} ms {ms} max_err {err:.3e} tol "
                  f"{tol:.3e}{'' if err <= tol else ' (fails the tolerance)'}, {same} "
                  f"outputs differ from the first variant's", flush=True)
    print(f"card: {card}")
    print(json.dumps({"card": card, "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
