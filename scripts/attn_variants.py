#!/usr/bin/env python3
"""Where the attention kernels' time goes on the card: variants of the source, timed in turns.

Run from the root of a checkout on a machine with a Hopper GPU and the CUDA toolkit:

    python3 scripts/attn_variants.py [window] [global]

Builds variants of ``tmr_tpu_torch/csrc/attn.cu`` made by text edits of the source (one
table per kernel below: phases cut out of a kernel, deeper K/V rings, design
alternatives), one ``nvcc -Xptxas -v`` each, all started together, into the git-ignored
``tmr_tpu_torch/_build/variants/``. Prints each variant's registers and spills, times
the variants in turns over three rounds with CUDA events, and holds each against the
plain version (the per-element attention tolerance of ``chip_smoke.py``); a variant that
cuts a phase out computes garbage and is marked so. Shapes, bf16: the windowed kernel on
SAM ViT-B's 1200 window-heads of 14x14 tokens at head dim 64 and ViT-H's 1600 at head dim
80; the global kernel on ViT-B's 48 x 4096 with and without the bias, on the 1536
bucket's 96x96 grid at one image, and on ViT-H's 64 x 4096 (head dim 80) with and
without the bias. Prints the card, one line per kernel, shape and variant, and a JSON line of the
times. ``--src`` compares several versions of the source (for example a parent commit's,
unpacked beside this one) under every variant, in the same turns.

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
        raise SystemExit(f"attn_variants: attn.cu no longer contains {old!r}")
    return src.replace(old, new)


# windowed kernel: cp.async of Q, then of K and V; the bias projections (after Q lands,
# with K and V in flight); the attention strips
_W_PROJ = "  window_projections<D>(sQ, rh, rw, sRH, sRW, gh, gw, st_h, GWP);\n"
_W_STRIPS = "strip * 16 < sp; strip += WIN_WARPS<D>"
_W_Q_LOOP = "  for (int i = threadIdx.x; i < sp * CH; i += blockDim.x) {"
_W_KV_LOOP = "  for (int i = threadIdx.x; i < nkey * CH; i += blockDim.x) {"
_W_COMMIT = "  cp_async_commit();\n"
_W_WARPS = "constexpr int WIN_WARPS = D == 64 ? 8 : 16;"
_W_QREGS = "constexpr bool WIN_Q_REGS = D == 64;"


def window_variants(src: str) -> dict:
    kv0 = src.index(_W_KV_LOOP)
    kv1 = src.index(_W_COMMIT, kv0) + len(_W_COMMIT)
    no_strips = _sub(src, _W_STRIPS, "strip * 16 < 0; strip += WIN_WARPS<D>")
    kv_after = _sub(src[:kv0] + src[kv1:], "  cp_async_wait<1>();\n  __syncthreads();",
                    "  cp_async_wait<0>();\n  __syncthreads();")
    kv_after = _sub(kv_after, _W_PROJ, _W_PROJ + src[kv0:kv1])
    q0 = src.index(_W_Q_LOOP)
    # the windowed CTA's warps and where a warp keeps its strip's Q fragments, at D = 80
    # (shipped: 16 warps, Q re-read from shared memory for each key chunk): the first
    # D = 80 build (8 warps, Q in registers), 16 warps with Q in registers (over 128
    # registers: spills), 12 warps; and at D = 64 Q re-read (shipped: in registers)
    q_regs = "constexpr bool WIN_Q_REGS = true;"
    warps = {
        "d80_first": _sub(_sub(src, _W_WARPS, "constexpr int WIN_WARPS = 8;"), _W_QREGS, q_regs),
        "d80_qregs": _sub(src, _W_QREGS, q_regs),
        "d80_warps12": _sub(src, _W_WARPS, "constexpr int WIN_WARPS = D == 64 ? 8 : 12;"),
        "d64_qsmem": _sub(src, _W_QREGS, "constexpr bool WIN_Q_REGS = false;"),
    }
    return {
        "full": src,
        "loads_only": _sub(no_strips, _W_PROJ, ""),
        "loads_projections": no_strips,
        "loads_strips": _sub(src, _W_PROJ, ""),
        "strips_only": _sub(src[:q0] + src[kv1:], _W_PROJ, ""),
        "kv_after_projections": kv_after,
        **warps,
    }


_G_SOFTMAX = "global_softmax<BK, HAS_BIAS, ROW_TILE, {}>(s, m, l, a, rw0, rw1, rows, kt);"
_G_STAGES = "static constexpr int NS = GPanels<D>::NP == 1 ? (BK == 64 ? 4 : 3) : 3;"
_G_BK = "constexpr int BK = HAS_BIAS && ROW_TILE && D == 64 ? 128 : 64;"
#: global kernel: name -> text edits
_G_EDITS = {
    "full": (),
    # deeper K/V rings at head dim 64: 4 stages of 128 keys on the main path (128 KB) in
    # place of 3, and 6 stages of 64 keys elsewhere (96 KB) in place of 4
    "stages4_128": ((_G_STAGES, "static constexpr int NS = GPanels<D>::NP == 1 ? 4 : 3;"),),
    "stages6_64": ((_G_STAGES,
                    "static constexpr int NS = GPanels<D>::NP == 1 ? (BK == 64 ? 6 : 3) : 3;"),),
    # 64-key tiles on the main path in place of 128 at head dim 64
    "bk64": ((_G_BK, "constexpr int BK = 64;"),),
    # head dim 80 (two panels): 4 stages of 64 keys (128 KB; 231,496 B with the 64x64
    # projections) in place of 3, or 2 stages of 128-key tiles on 64-token grid rows
    "d80_stages4": ((_G_STAGES,
                     "static constexpr int NS = GPanels<D>::NP == 1 ? (BK == 64 ? 4 : 3) : 4;"),),
    "d80_bk128": ((_G_STAGES,
                   "static constexpr int NS = GPanels<D>::NP == 1 ? (BK == 64 ? 4 : 3) "
                   ": (BK == 64 ? 3 : 2);"),
                  (_G_BK, "constexpr int BK = HAS_BIAS && ROW_TILE ? 128 : 64;")),
    # the consumer warpgroups' turn-taking flipped: none with the bias, turns without it
    "turns_flipped": (("constexpr bool TURNS = HAS_BIAS;",
                       "constexpr bool TURNS = !HAS_BIAS;"),),
    # the key loop without its softmax (p is the raw scores): products, copies, barriers
    "no_softmax": ((_G_SOFTMAX.format("false"), ";"), (_G_SOFTMAX.format("true"), ";"),
                   ("    float a[2];", "    float a[2] = {1.f, 1.f};")),
    # the key loop without its products (the softmax reruns on stale scores)
    "no_mma": (("issue_qk<D, BK>(s, qa, sKV + st * 2 * KVBYTES);", ""),
               ("issue_pv<D, BK>(o, p, sKV + prev * 2 * KVBYTES + KVBYTES);", "")),
    # no bias projections before the key loop (the bias reads unset shared memory)
    "no_projections": (("global_projection<D>(sQ, lr0, rph, gh, ya, yb, yf, yl, sRh, sth);",
                        ""),
                       ("global_projection<D>(sQ, lr0, rpw, gw, ta - ya * gw",
                        "if (0) global_projection<D>(sQ, lr0, rpw, gw, ta - ya * gw")),
    # the softmax without its exponentials (one MUFU instruction per score)
    "no_exp": tuple((f"ex2(s[4 * j{i}]", f"(s[4 * j{i}]")
                    for i in ("", " + 1", " + 2", " + 3")),
}


def global_variants(src: str) -> dict:
    out = {}
    for name, edits in _G_EDITS.items():
        text = src
        for old, new in edits:
            text = _sub(text, old, new)
        out[name] = text
    return out


#: name -> entry point, its argtypes, the variants, the shapes (gh, gw, batch*heads, bias,
#: head dim), launches per timing, and the entry's arguments before the stream for inputs x
KERNELS = {
    "window": SimpleNamespace(
        entry="tmr_window_attn", argtypes=[P, P, P, P, P, P, I, I, I, I, I, F, P],
        variants=window_variants,
        shapes=((14, 14, 4 * 25 * 12, True, 64), (14, 14, 4 * 25 * 16, True, 80),
                (7, 7, 4 * 25 * 16, True, 80), (16, 16, 4 * 25 * 16, True, 80)), reps=50,
        args=lambda x: (*x.qkv, *x.expanded, x.out, x.bh, x.s, x.gh, x.gw, x.d, x.scale)),
    "global": SimpleNamespace(
        entry="tmr_global_attn", argtypes=[P, P, P, P, P, P, I, I, I, I, I, F, I, P],
        variants=global_variants,
        shapes=((64, 64, 48, True, 64), (64, 64, 48, False, 64), (96, 96, 12, True, 64),
                (64, 64, 64, True, 80), (64, 64, 64, False, 80)), reps=20,
        args=lambda x: (*x.qkv, *(x.compact if x.bias else (None, None)), x.out, x.bh, x.s,
                        x.gh, x.gw, x.d, x.scale, int(x.bias))),
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
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for the {kernel} {name} variant:\n{log}")
        lines = log.splitlines()
        tag = f"{kernel}_attn_kernel"
        for i, line in enumerate(lines):  # this kernel's entries: spills, registers
            if "Compiling entry function" in line and tag in line:
                stats = " | ".join(x.strip() for x in lines[i + 2:i + 4])
                print(f"ptxas {kernel} {name} {line.split(tag)[1][:18]}: {stats}", flush=True)
        lib = ctypes.CDLL(str(out / f"lib{stem}.so"))
        spec = KERNELS[kernel]
        getattr(lib, spec.entry).argtypes = spec.argtypes
        libs[kernel, name] = lib
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("kernels", nargs="*", default=list(KERNELS),
                    help=f"kernels to vary, of {', '.join(KERNELS)} (default: all)")
    ap.add_argument("--variants", nargs="+",
                    help="variant names to build (default: every variant of each kernel)")
    ap.add_argument("--src", nargs="+", type=Path,
                    help="attn.cu sources to compare, each under every variant (default: "
                         "this checkout's); variants of the i-th are named i/<variant>")
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
    srcs = args.src or [_build.CSRC / "attn.cu"]
    sources = {}
    for i, src in enumerate(srcs):
        print(f"source {i}: {src}", flush=True)
        for kernel in args.kernels:
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
            q, k, v = (torch.randn(bh, s, d, generator=gen, device="cuda").bfloat16()
                       for _ in range(3))
            compact = (torch.randn(2 * gh - 1, d, generator=gen, device="cuda") * 0.1,
                       torch.randn(2 * gw - 1, d, generator=gen, device="cuda") * 0.1)
            expanded = tuple(cuda_attn.get_rel_pos(g, g, t) for g, t in zip((gh, gw), compact))
            rel = cuda_attn.bias_projections(q, *expanded, (gh, gw)) if bias else (None, None)
            with chip_smoke.exact_f32(torch):
                want = cuda_attn.attention_plain(q, k, v, *rel, (gh, gw), scale).float()
            limit = (chip_smoke.ATTN_REL_TOL * want.abs()
                     + chip_smoke.ATTN_ABS_TOL * want.abs().max())
            out = torch.empty_like(q)
            x = SimpleNamespace(
                qkv=(q.data_ptr(), k.data_ptr(), v.data_ptr()), out=out.data_ptr(),
                compact=tuple(t.data_ptr() for t in compact),
                expanded=tuple(t.data_ptr() for t in expanded),
                bh=bh, s=s, gh=gh, gw=gw, d=d, scale=scale, bias=bias)

            def launch(fn):
                rc = fn(*spec.args(x), stream)
                if rc:
                    raise SystemExit(f"attn_variants: {kernel} error {rc} at launch")

            key = f"{kernel} d={d} {gh}x{gw} BH={bh} {'bias' if bias else 'no bias'}"
            times[key] = {name: [] for name in mine}
            for _ in range(3):
                for name, fn in mine.items():
                    times[key][name].append(
                        chip_smoke.cuda_ms(lambda: launch(fn), spec.reps, 3))
            for name, fn in mine.items():
                launch(fn)
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
