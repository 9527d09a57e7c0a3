"""Optional wandb metrics sink (counterpart of ``tmr_tpu/utils/wandb_logger.py``; the
reference's main.py:113 logs to wandb unless ``--nowandb``).

The CSV logger of ``train/loop.py`` always runs; this sink mirrors each epoch row to wandb
when the user did not pass ``--nowandb`` and the ``wandb`` package exists. A missing
package or a failed ``init`` degrades to a warning and CSV-only logging, never an error:
the card's machines have no network.
"""

from __future__ import annotations

import sys
from typing import Dict, Optional


def _warn(msg: str) -> None:
    print(f"warning: {msg}", file=sys.stderr, flush=True)


class WandbLogger:
    """Best-effort wandb run; ``enabled`` is False when wandb is missing or refused."""

    def __init__(self, project: str, name: Optional[str] = None,
                 config: Optional[dict] = None):
        self._run = None
        try:
            import wandb
        except ImportError:
            _warn("wandb requested (no --nowandb) but the package is not installed; "
                  "logging to metrics.csv only")
            return
        try:
            self._run = wandb.init(project=project, name=name, config=config or {})
        except Exception as e:  # offline or unauthenticated: the run goes on without it
            _warn(f"wandb.init failed ({e}); logging to metrics.csv only")

    @property
    def enabled(self) -> bool:
        return self._run is not None

    def log(self, row: Dict[str, float], step: Optional[int] = None) -> None:
        if self._run is None:
            return
        try:
            self._run.log({k: v for k, v in row.items() if k != "epoch"}, step=step)
        except Exception as e:  # a network fault must not stop training
            _warn(f"wandb.log failed ({e})")

    def finish(self) -> None:
        if self._run is not None:
            try:
                self._run.finish()
            finally:
                self._run = None
