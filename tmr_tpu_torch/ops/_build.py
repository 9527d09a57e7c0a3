"""Build the port's CUDA kernels from ``tmr_tpu_torch/csrc`` and bind them.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled with ``nvcc`` for
``sm_90a`` into its own shared library under ``tmr_tpu_torch/_build/``, then loaded
with ``ctypes``; no PyTorch header is compiled, so a build takes seconds. All sources
are compiled in parallel (one ``nvcc`` each). Libraries are keyed by a hash of their
source and flags, so an edited source is rebuilt and never served stale.

Nothing here runs at import: the CPU tests import every module of the port on
machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float

#: exported C functions of each source, with their ctypes signatures
SIGNATURES: Dict[str, Dict[str, tuple]] = {
    "attn": {
        "tmr_global_attn": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P),
        "tmr_window_attn": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P),
    },
    "xcorr": {
        "tmr_xcorr": (_P, _P, _P, _I, _I, _I, _I, _P),
        "tmr_xcorr_int8": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
        "tmr_xcorr_int8_cuda_cores": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    },
    "nms": {
        "tmr_nms": (_P, _P, _P, _P, _I, _I, _F, _P),
        "tmr_nms_sequential": (_P, _P, _P, _I, _I, _F, _P),
    },
    "int8_mm": {
        "tmr_int8_mm": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _L, _L, _L, _P),
        "tmr_int8_conv3x3": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P),
    },
    "probe": {"tmr_add1": (_P, _P, _L, _P)},
}

NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
    "-Xcompiler", "-fPIC", "-lineinfo",
)

#: what a C entry returns for an argument its kernels do not take (``csrc/attn.cu``
#: ``ERR_ARGUMENT``); :func:`launch` raises ``ValueError`` for it
ERR_ARGUMENT = 2000

#: launches of each kernel since the last ``reset_launches()``; each wrapper adds one
#: where it launches its kernel, and nowhere else
LAUNCHES: Dict[str, int] = {
    "global_attn": 0, "window_attn": 0, "xcorr": 0, "nms": 0,
    "xcorr_int8": 0, "int8_mm": 0, "int8_conv": 0, "add1": 0,
    "global_attn_d80": 0, "window_attn_d80": 0,
}

#: nvcc's output (``-Xptxas -v``: registers, shared memory and spills per kernel) of each
#: source this process built; a library found already built has no entry
LOGS: Dict[str, str] = {}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
#: bound C functions by name, kept after the first launch so that later launches skip
#: ``lib()``'s lock and the attribute lookup
_FNS: Dict[str, ctypes._CFuncPtr] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the port's CUDA kernels "
            "are built from tmr_tpu_torch/csrc on a machine with the CUDA toolkit"
        )
    return path


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str] = tuple(SIGNATURES)) -> float:
    """Compile every named source that has no current library, all ``nvcc`` runs
    started together. Returns the wall seconds spent. Raises with the compiler's
    output when a build fails."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return 0.0
    nvcc = _nvcc()
    procs = []
    for name in todo:
        out = _lib_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        LOGS[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}.cu (rc {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        handle = _LIBS.get(name)
        if handle is None:
            build((name,))
            handle = ctypes.CDLL(str(_lib_path(name)))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(handle, fn).argtypes = list(argtypes)
                getattr(handle, fn).restype = ctypes.c_int
            _LIBS[name] = handle
        return handle


def launch(kernel: str, lib_name: str, fn: str, *args) -> None:
    """Call one C launcher, raise on its error code (``ValueError`` for an argument the
    kernel does not take, else ``RuntimeError``), count the launch."""
    bound = _FNS.get(fn)
    if bound is None:
        bound = _FNS[fn] = getattr(lib(lib_name), fn)
    rc = bound(*args)
    if rc == ERR_ARGUMENT:
        raise ValueError(f"{fn}: an argument the kernel does not take")
    if rc != 0:
        raise RuntimeError(f"{fn}: CUDA error {rc} at launch")
    LAUNCHES[kernel] += 1


def refuse_grad(what: str, *tensors) -> None:
    """Raise where a kernel without a backward would cut the autograd graph: its output,
    written through a pointer, has no ``grad_fn``, so a loss behind it would train
    nothing before it. Called by such wrappers on a CUDA input while grad mode is on."""
    import torch

    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what}: the kernel has no backward, and an input requires grad; run it "
            "under torch.no_grad() / inference_mode(), or see ROADMAP A8 for the "
            "gradients that are not ported")


def stream_of(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
