"""Crash-safe file writes (counterpart of ``tmr_tpu/utils/atomicio.py``): tmp file +
``os.replace``.

A crash mid-write leaves the previous file (or none), never a truncated one, and a
re-run replaces rather than appends. ``fsync=True`` (the default) forces the data to
storage before the rename and fsyncs the parent directory after it, so the rename is
durable too: required where a later write commits for this one (the map journal's
done-marker vouches for the shard's feature files). A failed write unlinks its temp
file.
"""

from __future__ import annotations

import os
from typing import IO, Callable, Optional


def fsync_dir(path: str) -> None:
    """Best-effort fsync of a directory, making the renames inside it durable (not every
    filesystem opens directories)."""
    try:
        dfd = os.open(path or ".", os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(dfd)
    except OSError:
        pass
    finally:
        os.close(dfd)


def atomic_write(path: str, write_fn: Callable[[IO], None], mode: str = "w",
                 fsync: bool = True, sync_dir: Optional[bool] = None) -> None:
    """Write ``path`` by calling ``write_fn(file)`` on a temp file in the same directory,
    then renaming it into place. ``sync_dir`` (default: follow ``fsync``) is the parent
    directory's fsync; writers of many files in one directory pass False and call
    :func:`fsync_dir` once for all of them."""
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, mode) as f:
            write_fn(f)
            if fsync:
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    if fsync if sync_dir is None else sync_dir:
        fsync_dir(os.path.dirname(path))
