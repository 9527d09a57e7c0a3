"""ctypes binding to the native tar-streaming runtime (counterpart of
``tmr_tpu/data/native_io.py``; the C++ source is the repo's ``native/tmr_io.cc``).

A C++ thread pool streams tar shards with inline ustar parsing and a bounded prefetch
queue, outside the GIL; Python receives (shard index, member name, payload bytes) and
decodes the images itself. The port builds its own copy of the library with ``g++`` at
first use, into the git-ignored ``tmr_tpu_torch/_build/`` keyed by a hash of the source
and flags (never into ``native/``), with the compiler's output captured so that nothing
reaches stdout. Without ``g++`` :func:`available` is False and the map phase reads
tars with Python's ``tarfile``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Iterator, Optional, Sequence, Tuple

SOURCE = Path(__file__).resolve().parents[2] / "native" / "tmr_io.cc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared")

_lib = None
_LOCK = threading.Lock()


class _Item(ctypes.Structure):
    _fields_ = [
        ("name", ctypes.c_char_p),
        ("data", ctypes.POINTER(ctypes.c_uint8)),
        ("size", ctypes.c_int64),
        ("shard", ctypes.c_int32),
    ]


def _lib_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libtmr_io-{digest.hexdigest()[:16]}.so"


def ensure_built() -> Optional[str]:
    """Build the library if it is missing; its path, or None (no source or no g++, or
    the build failed)."""
    if not SOURCE.is_file():
        return None
    out = _lib_path()
    if out.exists():
        return str(out)
    cxx = shutil.which("g++")
    if cxx is None:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, out)
    return str(out)


def _load():
    global _lib
    with _LOCK:
        if _lib is not None:
            return _lib
        path = ensure_built()
        if path is None:
            raise OSError("native IO library unavailable (no native/tmr_io.cc or no g++)")
        lib = ctypes.CDLL(path)
        lib.tmr_io_open.restype = ctypes.c_void_p
        lib.tmr_io_open.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                                    ctypes.c_int, ctypes.c_int]
        lib.tmr_io_next.restype = ctypes.c_int
        lib.tmr_io_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(_Item)]
        lib.tmr_io_free_item.argtypes = [ctypes.POINTER(_Item)]
        lib.tmr_io_error.restype = ctypes.c_int
        lib.tmr_io_error.argtypes = [ctypes.c_void_p]
        lib.tmr_io_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


def available() -> bool:
    try:
        _load()
        return True
    except OSError:
        return False


class NativeTarStream:
    """Iterate (shard index, member name, payload bytes) over tar shards, parsed and
    prefetched by the C++ thread pool. Unreadable shards are skipped and counted
    (``errors``)."""

    def __init__(self, paths: Sequence[str], threads: int = 4, queue_cap: int = 64):
        self._lib = _load()
        self._errors_at_close = 0
        self._handle = None
        self._paths = [os.fsencode(p) for p in paths]
        arr = (ctypes.c_char_p * len(self._paths))(*self._paths)
        self._handle = self._lib.tmr_io_open(arr, len(self._paths), threads, queue_cap)
        if not self._handle:
            raise OSError("tmr_io_open failed")

    def __iter__(self) -> Iterator[Tuple[int, str, bytes]]:
        item = _Item()
        while True:
            if self._lib.tmr_io_next(self._handle, ctypes.byref(item)) == 0:
                return
            try:
                name = item.name.decode("utf-8", "replace")
                data = ctypes.string_at(item.data, item.size)
            finally:
                self._lib.tmr_io_free_item(ctypes.byref(item))
            yield int(item.shard), name, data

    @property
    def errors(self) -> int:
        if self._handle is None:
            return self._errors_at_close
        return int(self._lib.tmr_io_error(self._handle))

    def close(self) -> None:
        if self._handle:
            self._errors_at_close = int(self._lib.tmr_io_error(self._handle))
            self._lib.tmr_io_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
