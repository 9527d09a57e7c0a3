"""Adaptive degradation ladder (counterpart of ``tmr_tpu/serve/degrade.py``): elect
cheaper request variants under overload instead of shedding blindly.

When the health watch says the engine is drowning (queue saturation, p99 regression),
the controller climbs a ladder of degrade steps the engine supports, and steps back down
once the pressure clears:

- level 1 ``truncate_k``: multi-exemplar requests run with k_real=1;
- level 2 ``prefer_heads``: images promote into the feature cache on their FIRST
  sighting instead of the second, so repeats reach the heads-only program earlier;
- level 3 ``downscale``: the image routes to the half-resolution bucket (2x2 subsample
  on the host; exemplar boxes are normalized, so detections stay in the same
  coordinate space).

A degrade step is never silent: every result served with a step active carries
``degrade_steps`` listing exactly which fired, and with the ladder off (``TMR_DEGRADE``
unset, the default) requests take the undegraded path.

The controller is driven by ``ServeEngine.health()`` passes (the heartbeat's interval is
the control interval): anomalies escalate one level per pass, ``cooldown`` consecutive
calm passes de-escalate one level. ``TMR_DEGRADE`` accepts ``auto`` (anomaly-driven) or a
forced integer level.
"""

from __future__ import annotations

import os
import threading
from typing import List, Optional, Sequence

#: the ladder, in escalation order — level N activates steps [:N]
DEGRADE_STEPS = ("truncate_k", "prefer_heads", "downscale")

#: health anomaly kinds that signal overload (the ladder's escalation
#: triggers; ``mfu_drop`` has no input in the port until ROADMAP A8);
#: recompile_storm / cache_hit_collapse are efficiency bugs, not load,
#: and must not shrink user results
OVERLOAD_ANOMALY_KINDS = (
    "queue_saturation",
    "latency_regression",
    "mfu_drop",
)


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


class DegradeController:
    """The degrade-ladder state machine.

    ``mode``: "off" (default; the controller is inert and the engine
    path is untouched), "auto" (anomaly-driven escalation), or an
    integer string — a forced, pinned level. Resolution order:
    constructor arg > ``TMR_DEGRADE`` env > off.
    """

    def __init__(self, mode: Optional[str] = None,
                 max_level: Optional[int] = None,
                 cooldown: Optional[int] = None,
                 min_size: Optional[int] = None):
        mode = (os.environ.get("TMR_DEGRADE", "off") or "off") \
            if mode is None else str(mode)
        self.max_level = (
            max(min(_env_int("TMR_DEGRADE_MAX_LEVEL", len(DEGRADE_STEPS)),
                    len(DEGRADE_STEPS)), 1)
            if max_level is None
            else max(min(int(max_level), len(DEGRADE_STEPS)), 1)
        )
        self.cooldown = (
            max(_env_int("TMR_DEGRADE_COOLDOWN", 2), 1)
            if cooldown is None else max(int(cooldown), 1)
        )
        #: downscale floor: images at/below this size never downscale
        #: (the feature grid must stay meaningful)
        self.min_size = (
            max(_env_int("TMR_DEGRADE_MIN_SIZE", 128), 2)
            if min_size is None else max(int(min_size), 2)
        )
        self._lock = threading.Lock()
        self._calm = 0
        self._level = 0
        self._forced: Optional[int] = None
        if mode in ("off", "0", "", "false"):
            self.enabled = False
            self.mode = "off"
        elif mode == "auto":
            self.enabled = True
            self.mode = "auto"
        else:
            try:
                forced = int(mode)
            except ValueError:
                raise ValueError(
                    f"TMR_DEGRADE={mode!r}: expected off|auto|<level int>"
                )
            self.enabled = forced > 0
            self.mode = "forced"
            self._forced = max(min(forced, self.max_level), 0)
            self._level = self._forced

    @property
    def level(self) -> int:
        with self._lock:
            return self._level

    def active_steps(self) -> Sequence[str]:
        """The steps the current level activates (escalation order)."""
        if not self.enabled:
            return ()
        with self._lock:
            return DEGRADE_STEPS[:self._level]

    def observe(self, anomalies: Sequence[dict]) -> int:
        """One control pass over a health snapshot's anomaly records:
        any overload-signaling anomaly escalates one level; a calm pass
        counts toward de-escalation (``cooldown`` consecutive calm
        passes step the ladder down one level). Returns the level after
        the pass. Forced mode never moves."""
        if not self.enabled or self._forced is not None:
            return self.level
        overload = any(
            rec.get("anomaly") in OVERLOAD_ANOMALY_KINDS
            for rec in (anomalies or ())
        )
        with self._lock:
            if overload:
                self._calm = 0
                if self._level < self.max_level:
                    self._level += 1
            else:
                self._calm += 1
                if self._calm >= self.cooldown and self._level > 0:
                    self._level -= 1
                    self._calm = 0
            return self._level

    def stats(self) -> dict:
        with self._lock:
            return {
                "enabled": self.enabled,
                "mode": self.mode,
                "level": self._level,
                "max_level": self.max_level,
                "cooldown": self.cooldown,
                "steps": list(DEGRADE_STEPS[:self._level]),
            }


def downscale_image(image, factor: int = 2):
    """Host-side 2x2 (or ``factor``^2) subsample onto the lower-
    resolution bucket: a strided view's copy, no filtering, so the
    degrade path costs ~zero host work. Exemplar boxes are normalized
    coordinates, so they transfer unchanged."""
    import numpy as np

    return np.ascontiguousarray(image[::factor, ::factor])


__all__: List[str] = [
    "DEGRADE_STEPS",
    "OVERLOAD_ANOMALY_KINDS",
    "DegradeController",
    "downscale_image",
]
