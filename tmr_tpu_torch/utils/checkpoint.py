"""Checkpoints: the best model, the last train state and resume (counterpart of
``tmr_tpu/utils/checkpoint.py``; reference callbacks.py CustomCheckpoint, Lightning's
resume and main.py:122-130).

:class:`CheckpointManager` keeps the JAX manager's rules (callbacks.py:9-45):

- the monitored metric is ``val/AP``, maximized, or ``val/MAE``, minimized, when
  ``best_model_count`` is set (:16-29);
- on the cadence epochs (epoch 0 and every ``AP_term``-th) an improvement is saved as a
  new best version, and earlier versions are kept; ``last`` is saved every epoch
  (save_last=True);
- ``ckpt_meta.json`` (``best_value``, ``best_version``, ``last_epoch``) is replaced
  atomically, and a corrupt one restarts from the defaults with a warning;
- a fresh training run refuses a directory that holds checkpoints (callbacks.py:12-13).

The files are the reference's, not the JAX package's orbax directories: a best version
is ``best_model.ckpt`` (version 0) or ``best_model-v{k}.ckpt``, a Lightning checkpoint
whose ``state_dict`` holds the model under the reference's ``model.*`` keys
(``utils/convert.lightning_state_dict``), which the reference and
``convert.load_matching_net`` read; ``last.ckpt`` holds the whole train state
(``train/state.TrainState.state_dict``) for ``--resume``. :func:`best_checkpoint` resolves
the highest version under ``logpath`` or ``logpath/checkpoints`` for eval; the orbax
directories the JAX package writes are that package's own format, read only through
JAX, so they are not read here.
"""

from __future__ import annotations

import json
import os
import re
import sys
import tempfile
from typing import Optional

import torch

from tmr_tpu_torch.utils.convert import lightning_state_dict

_BEST = re.compile(r"^best_model(?:-v(\d+))?\.ckpt$")


def best_checkpoint(logpath: str) -> Optional[str]:
    """The highest-version ``best_model*.ckpt`` file under ``logpath`` or
    ``logpath/checkpoints``; None when there is none."""
    found = []
    for d in (logpath, os.path.join(logpath, "checkpoints")):
        if not os.path.isdir(d):
            continue
        for name in os.listdir(d):
            m = _BEST.match(name)
            path = os.path.join(d, name)
            if m and os.path.isfile(path):
                found.append((int(m.group(1) or 0), path))
    return max(found)[1] if found else None


def best_name(version: int) -> str:
    """Lightning's name of best version ``version``."""
    return "best_model.ckpt" if version == 0 else f"best_model-v{version}.ckpt"


def _atomic_save(write, path: str) -> None:
    """``write(file)`` into a temporary file beside ``path``, then renamed over it: a
    crash mid-write leaves the previous file whole."""
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), prefix=".tmp-")
    try:
        with os.fdopen(fd, "wb") as f:
            write(f)
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


class CheckpointManager:
    def __init__(self, directory: str, monitor: str = "val/AP", mode: str = "max",
                 every_n_epochs: int = 1, fresh_guard: bool = False):
        """``fresh_guard``: refuse to start a fresh run into a directory that holds
        checkpoints already. Nothing is written until the first save."""
        self.directory = os.path.abspath(directory)
        self._meta_path = os.path.join(self.directory, "ckpt_meta.json")
        self._last = os.path.join(self.directory, "last.ckpt")
        if fresh_guard and (os.path.exists(self._meta_path) or os.path.exists(self._last)):
            raise FileExistsError(
                f"logpath {self.directory} already contains checkpoints; pass resume=True "
                "or choose a fresh logpath")
        self.monitor = monitor
        self.mode = mode
        self.every_n_epochs = max(1, every_n_epochs)
        self.meta = {"best_value": None, "best_version": -1, "last_epoch": -1}
        if os.path.exists(self._meta_path):
            try:
                with open(self._meta_path) as f:
                    loaded = json.load(f)
                if not isinstance(loaded, dict):
                    raise ValueError(f"expected a dict, got {type(loaded)}")
                self.meta.update(loaded)
            except (OSError, ValueError) as e:
                print(f"warning: unparseable {self._meta_path} ({e}); falling back to "
                      "default checkpoint metadata", file=sys.stderr, flush=True)

    def _is_better(self, value: float) -> bool:
        best = self.meta["best_value"]
        if best is None:
            return True
        return value > best if self.mode == "max" else value < best

    def save_epoch(self, state, epoch: int, metrics: dict) -> None:
        """Save ``last`` every call; on the cadence epochs, a new best version when the
        monitored metric improves. ``state`` is a ``TrainState``."""
        os.makedirs(self.directory, exist_ok=True)
        _atomic_save(lambda f: torch.save({**state.state_dict(), "epoch": epoch}, f),
                     self._last)
        self.meta["last_epoch"] = epoch
        value = metrics.get(self.monitor)
        on_cadence = (epoch + 1) % self.every_n_epochs == 0 or epoch == 0
        if value is not None and on_cadence and self._is_better(float(value)):
            self.meta["best_value"] = float(value)
            self.meta["best_version"] += 1
            ckpt = {"state_dict": lightning_state_dict(state.model.state_dict()),
                    "epoch": epoch, "global_step": state.step,
                    "monitor": self.monitor, "best_value": float(value)}
            _atomic_save(lambda f: torch.save(ckpt, f), os.path.join(
                self.directory, best_name(self.meta["best_version"])))
        _atomic_save(lambda f: f.write(json.dumps(self.meta).encode()), self._meta_path)

    def best_path(self) -> Optional[str]:
        """The highest-version best checkpoint this manager saved (callbacks.py:40-45)."""
        v = self.meta["best_version"]
        return None if v < 0 else os.path.join(self.directory, best_name(v))

    def last_path(self) -> Optional[str]:
        return self._last if os.path.isfile(self._last) else None

    def restore(self, path: str, state):
        """Load a ``last.ckpt`` into ``state`` (a ``TrainState``: the model, the moments,
        the counts and the accumulation state) and return it."""
        device = next(state.model.parameters()).device
        state.load_state_dict(torch.load(path, map_location=device, weights_only=True))
        return state
