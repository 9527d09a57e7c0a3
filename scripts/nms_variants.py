#!/usr/bin/env python3
"""Where the NMS kernel's time goes on the card: variants of the source, timed in turns.

Run from the root of a checkout on a machine with a Hopper GPU and the CUDA toolkit:

    python3 scripts/nms_variants.py [--variants NAME ...] [--src NMS_CU ...] [--b 4]
                                    [--n 2000] [--thr 0.5]

Builds variants of ``tmr_tpu_torch/csrc/nms.cu`` made by text edits of the source
(:data:`EDITS`: one of the two launches cut out, phases of the scan cut out, other
pass budgets of the scan's fixed point, other pipeline depths, block widths and splits
of the warps, the mask without its skip of disjoint pairs or without its IoUs;
clock64() per part of the scan), one ``nvcc -Xptxas -v`` each, all
started together, into the git-ignored ``tmr_tpu_torch/_build/variants/``.
``--src`` adds other sources of the same C interface, unedited, named ``src<i>``.
Prints each variant's registers and spills, times every variant's ``tmr_nms`` (the C
call alone, on buffers made once) in turns over three rounds with CUDA events on
``chip_smoke.py``'s NMS boxes (B x N, planted ties, sorted as the port sorts them),
beside the sequential kernel it replaced (``tmr_nms_sequential`` of the first variant),
and counts each variant's keep flags that differ from the plain version (0 for a variant
that computes the same function; a variant that cuts a phase out computes garbage and
is marked so). ``scan_only`` reads the bitmask the other variants left in the shared
workspace, so it is right. Prints the card, one line per variant, and a JSON line of
the times.

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
P, I, F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

_MASK_LAUNCH = """  nms_mask_kernel<<<dim3(W, W, B), BLK, 0, s>>>(
      (const float*)boxes, (const uint8_t*)valid, (u64*)mask, N, W, thr);
"""
_SCAN_LAUNCH = """  nms_scan_kernel<<<B, SCAN_THREADS, smem, s>>>((const u64*)mask, (const uint8_t*)valid,
                                                (uint8_t*)keep, N, W);
"""


def _const(name: str, old: int, new: int) -> tuple:
    return (f"constexpr int {name} = {old};", f"constexpr int {name} = {new};")


#: name -> text edits (old, new) of nms.cu
EDITS = {
    "full": (),
    # one launch: the mask alone (keep is garbage), the scan alone (on the bitmask the
    # other variants left in the workspace: right)
    "mask_only": ((_SCAN_LAUNCH, ""),),
    "scan_only": ((_MASK_LAUNCH, ""),),
    # warps 4-15 load and OR nothing (garbage): the resolver, warp 1, the ring's copies
    # and the barriers
    "no_workers": (("    } else {\n      const int wt = tid - 128;",
                    "    } else if (false) {\n      const int wt = tid - 128;"),),
    # no box is resolved, so none is kept and the workers have nothing to OR (garbage):
    # the barriers, the ring's copies and the keep stores
    "no_resolve": (("      if (any) {", "      if (false) {"),),
    # every block box by box (no fixed-point passes), or with other pass budgets
    "box_by_box": (_const("FIXPOINT_PASSES", 8, 0),),
    "passes4": (_const("FIXPOINT_PASSES", 8, 4),),
    "passes16": (_const("FIXPOINT_PASSES", 8, 16),),
    # ring copies read one step after they are issued, or three
    "depth1": (_const("DEPTH", 2, 1),),
    "depth3": (_const("DEPTH", 2, 3),),
    # scan blocks of one word (64 boxes a step; four words' ring outgrows static shared
    # memory)
    "bw1": (_const("BW", 2, 1),),
    # the ring's copies by warps 2-5, the workers 6-15
    "copiers4": (("constexpr int SCAN_WORKERS = SCAN_THREADS - 128;",
                  "constexpr int SCAN_WORKERS = SCAN_THREADS - 192;"),
                 ("    } else if (warp < 4) {", "    } else if (warp < 6) {"),
                 ("        for (int e = tid - 64; e < ROW_WORDS * SB; e += 64) {",
                  "        for (int e = tid - 64; e < ROW_WORDS * SB; e += 128) {"),
                 ("      const int wt = tid - 128;", "      const int wt = tid - 192;")),
    # 8 warps, not 16 (4 workers, not 12)
    "threads256": (_const("SCAN_THREADS", 512, 256),),
    # the mask divides for every pair, disjoint ones too
    "mask_divide": (("iou_of<true>(bi, ai, sB[u], sA[u])",
                     "iou_of<false>(bi, ai, sB[u], sA[u])"),),
}

_MASK_BODY = """  u64 word = 0;
  for (int u = (cb == rb) ? t + 1 : 0; u < ncol; ++u)  // j > i
    if (iou_of<true>(bi, ai, sB[u], sA[u]) > thr) word |= 1ull << u;
"""
# the mask: no IoU at all (a cheap comparison in its place: garbage), the mask's loads,
# barriers and stores alone; no inner loop at all (garbage)
EDITS["mask_no_iou"] = (("if (iou_of<true>(bi, ai, sB[u], sA[u]) > thr)",
                         "if (sB[u].x > bi.x + thr)"),)
EDITS["mask_only_no_iou"] = EDITS["mask_only"] + EDITS["mask_no_iou"]
EDITS["mask_only_no_loop"] = EDITS["mask_only"] + ((_MASK_BODY, "  u64 word = ncol;\n"),)

# clock64() per step of image 0 for one thread of each part (warp 0, warp 1, the ring's
# copies, the workers): its own work and its wait at the barrier; apart, warp 0's fixed
# point (with its passes and box-by-box fallbacks) and the workers' ORs of the words
# they held; printed at the end of each call
EDITS["clocks"] = (
    ("  auto step = [&](int w, u64(&held)[HELD], int& held_col) {\n    if (warp == 0) {",
     "  long long work = 0, fix = 0, bar = 0;\n  int npass = 0, nfall = 0;\n"
     "  auto step = [&](int w, u64(&held)[HELD], int& held_col) {\n"
     "    const long long ta = clock64();\n    if (warp == 0) {"),
    ("          settled = true;\n", "          settled = true;\n          ++npass;\n"),
    ("        if (!settled) {  // a chain deeper than the passes: box by box\n",
     "        if (!settled) {  // a chain deeper than the passes: box by box\n"
     "          ++nfall;\n"),
    ("      // the kept rows' words at block w + 1\n",
     "      fix += clock64() - ta;\n      // the kept rows' words at block w + 1\n"),
    ("    __syncthreads();\n  };\n",
     "    const long long tb = clock64();\n    work += tb - ta;\n"
     "    __syncthreads();\n    bar += clock64() - tb;\n  };\n"),
    ("  if (warp == 1) {\n    u64 kept[BW];",
     "  if (blockIdx.x == 0 && (tid == 0 || tid == 32 || tid == 64 || tid == 128))\n"
     "    printf(\"clocks tid %d per step: work %lld barrier %lld fixpoint %lld | passes %d "
     "fallbacks %d over %d steps\\n\", tid, work / NB, bar / NB, fix / NB, npass, nfall, NB);\n"
     "  if (warp == 1) {\n    u64 kept[BW];"),
    ("      if (v) or_word(&removed[held_col], v);\n",
     "      if (v) or_word(&removed[held_col], v);\n      fix += clock64() - ta;\n"),
    ("#include <stdint.h>\n", "#include <stdint.h>\n#include <cstdio>\n"),
)

#: variants whose keep flags are garbage by construction
GARBAGE = {"mask_only", "no_workers", "no_resolve", "mask_no_iou", "mask_only_no_iou",
           "mask_only_no_loop"}


def _sub(src: str, old: str, new: str) -> str:
    if old not in src:
        raise SystemExit(f"nms_variants: nms.cu no longer contains {old!r}")
    return src.replace(old, new)


def variants(src: str) -> dict:
    out = {}
    for name, edits in EDITS.items():
        text = src
        for old, new in edits:
            text = _sub(text, old, new)
        out[name] = text
    return out


def build(sources: dict, out: Path, flags, ptxas_info) -> dict:
    """sources: name -> source text. One nvcc each, all started together; returns name ->
    the loaded library, ``tmr_nms`` and ``tmr_nms_sequential`` bound."""
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        (out / f"nms_{name}.cu").write_text(text)
        cmd = ["/usr/local/cuda/bin/nvcc", *flags, "-Xptxas", "-v",
               "-o", str(out / f"libnms_{name}.so"), str(out / f"nms_{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for the {name} variant:\n{log}")
        print(f"ptxas {name}: mask {ptxas_info(log, 'nms_mask_kernel')}; scan "
              f"{ptxas_info(log, 'nms_scan_kernel')}", flush=True)
        lib = ctypes.CDLL(str(out / f"libnms_{name}.so"))
        lib.tmr_nms.argtypes = [P, P, P, P, I, I, F32, P]
        lib.tmr_nms_sequential.argtypes = [P, P, P, I, I, F32, P]
        libs[name] = lib
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", nargs="+", choices=list(EDITS),
                    help="variants to build (default: all)")
    ap.add_argument("--src", nargs="+", type=Path, default=[],
                    help="other nms.cu sources with the same C interface, timed unedited")
    ap.add_argument("--b", type=int, default=4, help="images")
    ap.add_argument("--n", type=int, default=2000, help="boxes per image")
    ap.add_argument("--thr", type=float, default=0.5, help="IoU threshold")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("nms_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from tmr_tpu_torch.ops import _build, cuda_nms

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    names = ["full"] + [n for n in EDITS if n != "full" and (args.variants is None
                                                             or n in args.variants)]
    sources = {name: text for name, text in variants((_build.CSRC / "nms.cu").read_text())
               .items() if name in names}
    for i, path in enumerate(args.src):
        print(f"src{i}: {path}", flush=True)
        sources[f"src{i}"] = path.read_text()
    libs = build(sources, _build.BUILD_DIR / "variants", _build.NVCC_FLAGS,
                 chip_smoke.ptxas_info)
    stream = torch.cuda.current_stream().cuda_stream
    b, n, thr = args.b, args.n, args.thr
    boxes, scores, valid = chip_smoke.nms_inputs(torch, chip_smoke.SEED, b, n)
    _, sb, sv = (t.cuda() for t in chip_smoke.nms_sorted(torch, boxes, scores, valid))
    sb = sb.contiguous()
    want = cuda_nms.greedy_keep_sorted_plain(sb, sv, thr)
    sv = sv.contiguous()
    keep = torch.empty_like(sv)
    mask = torch.empty((b, n, cuda_nms.mask_words(n)), dtype=torch.int64, device="cuda")
    valid_i = sv.to(torch.int32)  # the sequential kernel's int32 flags
    keep_i = torch.empty_like(valid_i)

    def call(fn):
        rc = fn(sb.data_ptr(), sv.data_ptr(), keep.data_ptr(), mask.data_ptr(), b, n, thr,
                stream)
        if rc:
            raise SystemExit(f"nms_variants: error {rc} at launch")

    def sequential():
        rc = libs["full"].tmr_nms_sequential(sb.data_ptr(), valid_i.data_ptr(),
                                             keep_i.data_ptr(), b, n, thr, stream)
        if rc:
            raise SystemExit(f"nms_variants: sequential kernel error {rc} at launch")

    call(libs["full"].tmr_nms)  # the bitmask that scan_only reads
    fns = {name: (lambda lib=lib: call(lib.tmr_nms)) for name, lib in libs.items()}
    if n * 24 <= 227 * 1024:
        fns["sequential"] = sequential
    times = {name: [] for name in fns}
    for _ in range(3):
        for name, fn in fns.items():
            times[name].append(chip_smoke.cuda_ms(fn, 20, 2))
    print(f"{b} x {n} boxes, IoU {thr}: {int(want.sum())} kept of {int(sv.sum())} valid",
          flush=True)
    for name, fn in fns.items():
        keep.fill_(True)
        keep_i.fill_(1)
        fn()
        torch.cuda.synchronize()
        mism = int(((keep_i.bool() if name == "sequential" else keep) != want).sum().item())
        ms = " ".join(f"{x:.4f}" for x in times[name])
        note = " (garbage by construction)" if name in GARBAGE else ""
        print(f"{name:17s} ms {ms} mismatches vs plain {mism}{note}", flush=True)
    print(f"card: {card}")
    print(json.dumps({"card": card, "b": b, "n": n, "thr": thr, "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
