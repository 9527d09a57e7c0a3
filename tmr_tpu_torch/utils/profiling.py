"""The stderr logging protocol (counterpart of the logging half of
``tmr_tpu/utils/profiling.py``; reference reducer.py:29-94): one ``[LEVEL] message`` line
on stderr, so that stdout stays free for a command's records and results (the map
phase's stdout is its record protocol)."""

from __future__ import annotations

import sys


def _emit(level: str, msg: str) -> None:
    print(f"[{level}] {msg}", file=sys.stderr, flush=True)


def log_info(msg: str) -> None:
    _emit("INFO", msg)


def log_warning(msg: str) -> None:
    _emit("WARNING", msg)


def log_error(msg: str) -> None:
    _emit("ERROR", msg)


def log_progress(msg: str) -> None:
    _emit("PROGRESS", msg)
