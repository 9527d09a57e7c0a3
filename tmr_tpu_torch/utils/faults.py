"""Deterministic fault injection (counterpart of ``tmr_tpu/utils/faults.py``, the same
``TMR_FAULTS`` grammar and behaviour, so that a drill written for the JAX package runs
unchanged against the port).

Injection points (``POINTS``), and where the port fires them:

    point       fires at                                    extra actions
    ---------   -----------------------------------------   -------------
    tar.open    parallel/mapreduce: a shard's tar is opened
    tar.member  parallel/mapreduce: one member's payload    corrupt=1
                was read out of the tar
    decode      parallel/mapreduce: one image payload       corrupt=1
                enters the decode
    encode      parallel/mapreduce: one batch enters /      nan=1
                leaves the encoder
    save        parallel/mapreduce: one per-image feature
                .npy is about to be written
    journal     parallel/journal: a shard's done-marker is
                about to be committed
    lease       parallel/elastic: the coordinator is about
                to grant a shard lease (a raise re-queues
                the shard; the attempt key is the epoch)
    heartbeat   parallel/elastic: a worker's lease beat is
                about to be sent (a latency stalls beats
                as a SIGSTOP would)
    steal       parallel/elastic: the coordinator elected a
                straggler for a duplicate lease (a raise
                vetoes the election)

The other names (``fleet.route``, ``fleet.commit``, ``fleet.recruit``, ``serve.link``,
``gallery.replica``, ``gallery.beat``) belong to the serving fleet and the gallery, which
the port does not have yet (ROADMAP A7); a schedule naming them parses and never fires.

A schedule is a ``;``-separated list of specs, each ``point[:key=value]*``, installed
from the ``TMR_FAULTS`` env var (``install_from_env``, seed ``TMR_FAULTS_SEED``) or by
``configure``::

    TMR_FAULTS="tar.open:shard=3:attempts=2:raise=OSError;encode:shard=7:latency=30"

Keys: ``shard=N`` (only shard index N of the run's list), ``attempts=M`` (only while
the attempt number is < M), ``raise=Exc`` (from the closed vocabulary ``_EXC``),
``latency=S`` (sleep S seconds), ``corrupt=1`` (corrupt the payload bytes),
``nan=1`` (NaN-poison the arrays). Corruption derives from a generator seeded on
(seed, point, shard, attempt), so a schedule replays exactly; every applied action is
appended to the ``fired()`` log. With no schedule installed every hook is one falsy
dict check.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time
from typing import Dict, Iterator, List, Optional

#: the closed set of injection point names threaded through the map
#: phase (mapreduce.py / journal.py / elastic.py) — see the module
#: docstring's point table; tests pin the parity both ways
POINTS = (
    "tar.open", "tar.member", "decode", "encode", "save", "journal",
    "lease", "heartbeat", "steal",
    "fleet.route", "fleet.commit", "fleet.recruit",
    "serve.link", "gallery.replica", "gallery.beat",
)


class InjectedFault(Exception):
    """Default exception class for ``raise=InjectedFault`` specs."""


#: closed vocabulary for ``raise=`` — a typo'd class name must fail at
#: configure time, not silently never fire. KeyboardInterrupt/SystemExit
#: are included on purpose: the executor treats them as a process crash
#: (no retry/quarantine), which is how the crash-resume tests die mid-run.
_EXC = {
    "InjectedFault": InjectedFault,
    "OSError": OSError,
    "IOError": OSError,
    "ValueError": ValueError,
    "RuntimeError": RuntimeError,
    "TimeoutError": TimeoutError,
    "EOFError": EOFError,
    "KeyboardInterrupt": KeyboardInterrupt,
    "SystemExit": SystemExit,
}


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    point: str
    shard: Optional[int] = None
    attempts: Optional[int] = None
    raise_: Optional[str] = None
    latency: float = 0.0
    corrupt: bool = False
    nan: bool = False


#: point -> [FaultSpec]; EMPTY dict == injection disabled — every hook
#: bails on `if not _SCHEDULE` before touching anything else
_SCHEDULE: Dict[str, List[FaultSpec]] = {}
_SEED = 0
_FIRED: List[dict] = []

#: guards the mutable module state above: ``_record`` appends from the
#: executor's load/heartbeat threads while the main thread reads
#: ``fired()`` (chaos_probe's accounting), and a racing ``configure``
#: must never interleave with a half-applied schedule. RLock because
#: ``configure`` calls ``clear`` under it. The hot-path contract is
#: untouched: with no schedule installed every hook still exits on one
#: falsy-dict READ before any lock is reached (the lock-discipline
#: analysis pass whitelists nothing here — all writes hold it).
_LOCK = threading.RLock()

# ambient (shard, attempt) for the code currently running — set by the
# executor around each shard attempt, on whichever thread does the work
_TLS = threading.local()


def parse_schedule(text: str) -> List[FaultSpec]:
    """Parse a ``TMR_FAULTS`` schedule string; raises ValueError on any
    unknown point, key, or exception class."""
    specs: List[FaultSpec] = []
    for chunk in text.split(";"):
        chunk = chunk.strip()
        if not chunk:
            continue
        fields = chunk.split(":")
        point = fields[0].strip()
        if point not in POINTS:
            raise ValueError(
                f"unknown fault point {point!r} (expected one of {POINTS})"
            )
        kw: dict = {"point": point}
        for field in fields[1:]:
            if "=" not in field:
                raise ValueError(f"malformed fault field {field!r} in {chunk!r}")
            key, val = field.split("=", 1)
            key = key.strip()
            val = val.strip()
            if key == "shard":
                kw["shard"] = int(val)
            elif key == "attempts":
                kw["attempts"] = int(val)
            elif key == "raise":
                if val not in _EXC:
                    raise ValueError(
                        f"unknown exception {val!r} (expected one of "
                        f"{sorted(_EXC)})"
                    )
                kw["raise_"] = val
            elif key == "latency":
                kw["latency"] = float(val)
            elif key == "corrupt":
                kw["corrupt"] = bool(int(val))
            elif key == "nan":
                kw["nan"] = bool(int(val))
            else:
                raise ValueError(f"unknown fault key {key!r} in {chunk!r}")
        specs.append(FaultSpec(**kw))
    return specs


def configure(text: str, seed: int = 0) -> None:
    """Install a schedule (replacing any current one) and reset the fired
    log. Empty/whitespace text clears."""
    global _SEED
    specs = parse_schedule(text)  # parse OUTSIDE the lock: a bad
    with _LOCK:  # schedule must not leave a half-cleared state behind
        clear()
        _SEED = seed
        for spec in specs:
            _SCHEDULE.setdefault(spec.point, []).append(spec)


def clear() -> None:
    with _LOCK:
        _SCHEDULE.clear()
        _FIRED.clear()


def active() -> bool:
    return bool(_SCHEDULE)


def install_from_env(environ=None) -> bool:
    """Install the schedule from ``TMR_FAULTS`` / ``TMR_FAULTS_SEED``;
    returns True when one was installed."""
    env = os.environ if environ is None else environ
    text = env.get("TMR_FAULTS", "")
    if not text.strip():
        return False
    configure(text, seed=int(env.get("TMR_FAULTS_SEED", "0")))
    return True


@contextlib.contextmanager
def shard_scope(shard: Optional[int], attempt: Optional[int]) -> Iterator[None]:
    """Declare the ambient (shard index, attempt number) for the enclosed
    work — the executor wraps each shard attempt (load thread AND the
    main-thread encode half) so specs can scope by shard/attempt."""
    prev = (getattr(_TLS, "shard", None), getattr(_TLS, "attempt", None))
    _TLS.shard, _TLS.attempt = shard, attempt
    try:
        yield
    finally:
        _TLS.shard, _TLS.attempt = prev


def _match(point: str) -> Optional[FaultSpec]:
    shard = getattr(_TLS, "shard", None)
    attempt = getattr(_TLS, "attempt", None)
    for spec in _SCHEDULE.get(point, ()):
        if spec.shard is not None and spec.shard != shard:
            continue
        if spec.attempts is not None and (
            attempt is None or attempt >= spec.attempts
        ):
            continue
        return spec
    return None


def _record(spec: FaultSpec, action: str) -> None:
    rec = {
        "point": spec.point,
        "shard": getattr(_TLS, "shard", None),
        "attempt": getattr(_TLS, "attempt", None),
        "action": action,
    }
    with _LOCK:
        _FIRED.append(rec)


def fired() -> List[dict]:
    """Log of every applied fault action (oldest first), not cleared."""
    with _LOCK:
        return list(_FIRED)


def fire(point: str) -> None:
    """Apply latency / raise actions scheduled at ``point``."""
    if not _SCHEDULE:
        return
    spec = _match(point)
    if spec is None:
        return
    if spec.latency:
        _record(spec, "latency")
        time.sleep(spec.latency)
    if spec.raise_ is not None:
        _record(spec, "raise")
        raise _EXC[spec.raise_](
            f"injected fault at {point} "
            f"(shard={getattr(_TLS, 'shard', None)}, "
            f"attempt={getattr(_TLS, 'attempt', None)})"
        )


def corrupt_bytes(point: str, data: bytes) -> bytes:
    """Return ``data``, deterministically corrupted when a ``corrupt=1``
    spec matches at ``point``."""
    if not _SCHEDULE:
        return data
    spec = _match(point)
    if spec is None or not spec.corrupt:
        return data
    _record(spec, "corrupt")
    import numpy as np

    shard = getattr(_TLS, "shard", None) or 0
    attempt = getattr(_TLS, "attempt", None) or 0
    rng = np.random.default_rng(
        [_SEED, sum(point.encode()), shard, attempt]
    )
    buf = bytearray(data)
    n = min(64, len(buf))
    buf[:n] = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    return bytes(buf)


def poison(point: str, *arrays):
    """Return the arrays, NaN-poisoned when a ``nan=1`` spec matches at
    ``point`` (every element of every array — the whole batch reads as a
    non-finite encoder output)."""
    if not _SCHEDULE:
        return arrays if len(arrays) != 1 else arrays[0]
    spec = _match(point)
    if spec is None or not spec.nan:
        return arrays if len(arrays) != 1 else arrays[0]
    _record(spec, "nan")
    import numpy as np

    out = tuple(np.full_like(np.asarray(a), np.nan) for a in arrays)
    return out if len(out) != 1 else out[0]
