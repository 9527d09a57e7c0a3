#!/usr/bin/env python3
"""Where the fused int8 3x3 layer's time goes on the card: variants of the source, timed in turns.

Run from the root of a checkout on a machine with a Hopper GPU and the CUDA toolkit:

    python3 scripts/int8_variants.py [--variants NAME ...] [--baseline INT8_MM_CU ...]

Builds variants of ``tmr_tpu_torch/csrc/int8_mm.cu`` made by text edits of the source
(:data:`EDITS`: phases cut out of ``int8_conv3x3_kernel``, another raster of the tile
walk, other ring depths, a 2-CTA cluster that multicasts the shared activation panel),
one ``nvcc -Xptxas -v`` each, all started together, into the git-ignored
``tmr_tpu_torch/_build/variants/``. ``--baseline`` adds other sources of the same C
interface unedited, named ``baseline<i>``. Prints each variant's registers and spills,
times every variant in turns over three rounds with CUDA events on the int8 tail's layer
(4 x 128^2 pixels, 1024 -> 2048 channels, random int8 operands), and counts each
variant's outputs that differ from the plain version (0 for a variant that computes the
same function; a variant that cuts a phase out computes garbage and is marked so).
Prints the card, one line per variant, and a JSON line of the times.

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

_KERNEL_DECL = "__global__ void __launch_bounds__(CV_THREADS, 1)\n    int8_conv3x3_kernel("
_A_LOAD = ("            tma_load_4d(st, &ta, &full[s], kp * CV_BK, tl.x0 + dx - 1, "
           "tl.y + dy - 1, tl.b);\n")
_LOADS = ("            mbar_expect_tx(&full[s], CV_STAGE);\n" + _A_LOAD +
          "            tma_load_3d(st + CV_A, &tb, &full[s], kp * CV_BK, tl.n0, t);\n")
_RELEASE = "if (lane == 0) mbar_arrive(&empty[(it - 1) % CV_NS]);"
_FOLD = """          f[e] = __fadd_rn(f[e], __fmul_rn(__int2float_rn(acc[e]), s2.x));
          f[e + 1] = __fadd_rn(f[e + 1], __fmul_rn(__int2float_rn(acc[e + 1]), s2.y));
"""
_TILE = """__device__ __forceinline__ ConvTile conv_tile(int i, int nt, int xt, int H) {
  const int ni = i % nt, m = i / nt;"""
_GRID = "  const int grid = (int)(tiles < sms ? tiles : sms);\n"
_CLUSTER_GRID = """  cudaLaunchConfig_t occ = {};
  occ.gridDim = dim3(sms);
  occ.blockDim = dim3(CV_THREADS);
  occ.dynamicSmemBytes = smem;
  int clusters = 0;
  if ((err = cudaOccupancyMaxActiveClusters(&clusters, int8_conv3x3_kernel, &occ)) !=
      cudaSuccess)
    return (int)err;
  static bool said = false;
  if (!said) fprintf(stderr, "cluster2_mcast: %d clusters of 2 resident\\n", clusters);
  said = true;
  const int grid = (int)(tiles < 2 * clusters ? tiles : 2 * clusters);
"""
# the cluster helpers: a barrier over both CTAs, this CTA's rank, an arrive on this
# CTA's and the peer's mbarrier, and a TMA load multicast to both CTAs
_CLUSTER_HELPERS = r"""__device__ __forceinline__ void cluster_sync_all() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t cta_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void release2(uint64_t* bar, uint32_t rank) {
  mbar_arrive(bar);
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote) : "r"(smem_addr(bar)), "r"(rank ^ 1u));
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n"
               :: "r"(remote) : "memory");
}

__device__ __forceinline__ void tma_load_4d_mc(void* dst, const CUtensorMap* map,
                                               uint64_t* bar, int c0, int c1, int c2,
                                               int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%2, %3, %4, %5}], [%6], %7;\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_addr(bar)), "h"((unsigned short)3)
      : "memory");
}

struct ConvTile {"""

#: name -> text edits (old, new) of int8_mm.cu
EDITS = {
    "full": (),
    # the products cut out: each wgmma becomes a PTX comment that still names its
    # operands, so the ring, the waits and the folds stay (garbage output)
    "no_products": (('"wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "', '"// "'),),
    # no TMA loads: the producer only arrives on each full barrier, so the products run
    # on whatever shared memory holds (garbage output): the tensor cores and the folds
    "no_loads": ((_LOADS, "            mbar_arrive(&full[s]);\n"),),
    # the per-tap fold's arithmetic cut out: f takes the accumulator's bits, so the
    # accumulator stays read (ptxas removes a wgmma chain whose result is never read)
    # and no conversion, multiply or add runs (garbage output)
    "no_fold": ((_FOLD, "          f[e] = __int_as_float(acc[e]);\n"
                        "          f[e + 1] = __int_as_float(acc[e + 1]);\n"),),
    # the pixel tiles fastest: the CTAs in flight share a B panel, not an A panel
    "pixel_fastest": ((_TILE, _TILE.replace("int H) {", "int H, int tiles) {")
                       .replace("const int ni = i % nt, m = i / nt;",
                                "const int mtiles = tiles / nt, ni = i / mtiles, "
                                "m = i % mtiles;")),
                      ("conv_tile(i, nt, xt, H)", "conv_tile(i, nt, xt, H, tiles)")),
    "stages4": (("constexpr int CV_NS = 5;", "constexpr int CV_NS = 4;"),),
    "stages6": (("constexpr int CV_NS = 5;", "constexpr int CV_NS = 6;"),),
    # a 2-CTA cluster on two N tiles of one pixel segment (the walk pairs them: tiles
    # 2p and 2p + 1 when the grid and the N tile count are even): each CTA loads half of
    # the A panel and multicasts it to both, so the A traffic from L2 halves; a stage is
    # refilled once both CTAs' consumers have released it
    "cluster2_mcast": (
        ("struct ConvTile {", _CLUSTER_HELPERS),
        (_KERNEL_DECL, _KERNEL_DECL.replace("__global__ void ",
                                            "__global__ void __cluster_dims__(2, 1, 1) ")),
        ("mbar_init(&empty[s], CV_CONSUMERS / 32);", "mbar_init(&empty[s], CV_CONSUMERS / 16);"),
        ("  __syncthreads();\n\n  if (warp == CV_CONSUMERS / 32) {",
         "  cluster_sync_all();\n  const uint32_t rank = cta_rank();\n\n"
         "  if (warp == CV_CONSUMERS / 32) {"),
        (_A_LOAD, "            tma_load_4d_mc(st + rank * (CV_A / 2), &ta, &full[s], kp * CV_BK, "
                  "tl.x0 + rank * (CV_BM / 2) + dx - 1, tl.y + dy - 1, tl.b);\n"),
        ("    return;\n  }\n\n  // consumers:", "    cluster_sync_all();\n    return;\n  }\n\n"
                                             "  // consumers:"),
        (_RELEASE, "if (lane == 0) release2(&empty[(it - 1) % CV_NS], rank);"),
        ("  }\n}\n\ntypedef CUresult", "  }\n  cluster_sync_all();\n}\n\ntypedef CUresult"),
        ("(e = int8_map(&ta, xq, 4, adims, astrides, CV_BM))",
         "(e = int8_map(&ta, xq, 4, adims, astrides, CV_BM / 2))"),
        # the persistent grid sized to the clusters that can be resident at once (a
        # cluster's two CTAs need two free SMs of one GPC): a cluster left out of the
        # first wave would run its whole tile list after it
        (_GRID, _CLUSTER_GRID),
        ("#include <cuda.h>\n", "#include <cuda.h>\n#include <cstdio>\n"),
    ),
}
EDITS["no_loads_no_fold"] = EDITS["no_loads"] + EDITS["no_fold"]
_REMOTE_ARRIVE = "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];"
# the cluster's remote release at the default (CTA) scope
EDITS["cluster2_mcast_cta"] = EDITS["cluster2_mcast"] + (
    (_REMOTE_ARRIVE, "mbarrier.arrive.shared::cluster.b64 _, [%0];"),)
# and one remote arrive per consumer warpgroup (its first warp's, after its own wait on
# the warpgroup's products) in place of one per warp: 8 local + 2 remote arrivals
EDITS["cluster2_mcast_wg"] = EDITS["cluster2_mcast_cta"] + (
    ("mbar_init(&empty[s], CV_CONSUMERS / 16);", "mbar_init(&empty[s], CV_CONSUMERS / 32 + 2);"),
    ("__device__ __forceinline__ void release2(uint64_t* bar, uint32_t rank) {\n"
     "  mbar_arrive(bar);\n",
     "__device__ __forceinline__ void release2(uint64_t* bar, uint32_t rank) {\n"
     "  mbar_arrive(bar);\n  if ((threadIdx.x >> 5) & 3) return;\n"),
)
# warpgroup 1 starts each tile two stages after warpgroup 0 (named barrier 2), so that
# their per-tap folds (I2F at 16 a clock per SM) fall on each other's products rather
# than on the same idle tensor cores (needs C_in > 128: the variants' shape has 1024)
EDITS["lag2"] = (
    ("    consumer_sync();\n    // -0 + v == v",
     '    consumer_sync();\n    if (c == 1) asm volatile("bar.sync 2, 256;\\n" ::: "memory");\n'
     "    // -0 + v == v"),
    ("        wg_commit();\n        if (kp > 0) {",
     "        wg_commit();\n        if (c == 0 && t == 0 && kp == 1)\n"
     '          asm volatile("bar.arrive 2, 256;\\n" ::: "memory");\n'
     "        if (kp > 0) {"),
)
EDITS["lag2_stages6"] = EDITS["lag2"] + EDITS["stages6"]
EDITS["cluster2_mcast_cta_no_fold"] = EDITS["cluster2_mcast_cta"] + EDITS["no_fold"]

#: variants whose output is garbage by construction
GARBAGE = {"no_products", "no_loads", "no_fold", "no_loads_no_fold",
           "cluster2_mcast_cta_no_fold"}
SHAPE = (4, 128, 128, 1024, 2048)  # B, H, W, C_in, N


def _sub(src: str, old: str, new: str) -> str:
    if old not in src:
        raise SystemExit(f"int8_variants: int8_mm.cu no longer contains {old!r}")
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
    the loaded library's ``tmr_int8_conv3x3``, its argtypes set. ``ptxas_info(log,
    kernel)`` picks the fused kernel's registers and spills out of nvcc's output."""
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        (out / f"int8_{name}.cu").write_text(text)
        cmd = ["/usr/local/cuda/bin/nvcc", *flags, "-Xptxas", "-v",
               "-o", str(out / f"libint8_{name}.so"), str(out / f"int8_{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for the {name} variant:\n{log}")
        print(f"ptxas {name}: {ptxas_info(log, 'int8_conv3x3')}", flush=True)
        fn = ctypes.CDLL(str(out / f"libint8_{name}.so")).tmr_int8_conv3x3
        fn.argtypes = [P, P, P, P, P, P, I, I, I, I, I, F32, P]
        fns[name] = fn
    return fns


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", nargs="+", choices=list(EDITS),
                    help="variants to build (default: all)")
    ap.add_argument("--baseline", nargs="+", type=Path, default=[],
                    help="other int8_mm.cu sources with the same C interface, timed unedited")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("int8_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from tmr_tpu_torch.ops import _build, cuda_int8

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    sources = {name: text for name, text in variants((_build.CSRC / "int8_mm.cu").read_text())
               .items() if args.variants is None or name in args.variants}
    for i, path in enumerate(args.baseline):
        print(f"baseline{i}: {path}", flush=True)
        sources[f"baseline{i}"] = path.read_text()
    fns = build(sources, _build.BUILD_DIR / "variants", _build.NVCC_FLAGS,
                chip_smoke.ptxas_info)
    stream = torch.cuda.current_stream().cuda_stream
    b, h, w, c, n = SHAPE
    gen = torch.Generator(device="cuda").manual_seed(0)
    xq = torch.randint(-127, 128, (b, h, w, c), generator=gen, device="cuda", dtype=torch.int8)
    wq = torch.randint(-127, 128, (3, 3, n, c), generator=gen, device="cuda", dtype=torch.int8)
    sx = torch.rand(b, generator=gen, device="cuda") * 0.01 + 1e-4
    sw = torch.rand(3, 3, n, generator=gen, device="cuda") * 0.01 + 1e-4
    bias = torch.randn(n, generator=gen, device="cuda") * 0.1
    want = cuda_int8.int8_conv3x3_plain(xq, sx, wq, sw, bias, 0.01)
    out = torch.empty_like(want)

    def launch(fn):
        rc = fn(xq.data_ptr(), sx.data_ptr(), wq.data_ptr(), sw.data_ptr(), bias.data_ptr(),
                out.data_ptr(), b, h, w, c, n, 0.01, stream)
        if rc:
            raise SystemExit(f"int8_variants: error {rc} at launch")

    times = {name: [] for name in fns}
    for _ in range(3):
        for name, fn in fns.items():
            times[name].append(chip_smoke.cuda_ms(lambda: launch(fn), 10, 2))
    ops = 2.0 * b * h * w * n * 9 * c
    for name, fn in fns.items():
        out.zero_()
        launch(fn)
        torch.cuda.synchronize()
        mism = int((out != want).sum().item())
        ms = " ".join(f"{x:.4f}" for x in times[name])
        note = " (garbage by construction)" if name in GARBAGE else ""
        print(f"{b}x{h}x{w}x{c} -> {n} {name:15s} ms {ms} ({ops / min(times[name]) / 1e9:.0f} "
              f"TOPS) mismatches vs plain {mism}{note}", flush=True)
    print(f"card: {card}")
    print(json.dumps({"card": card, "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
