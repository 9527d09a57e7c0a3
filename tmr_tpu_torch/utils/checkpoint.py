"""Best-checkpoint resolution for eval (counterpart of the ``best_path`` half of
``tmr_tpu/utils/checkpoint.py``; reference callbacks.py:40-45 and main.py:122-130).

The reference's eval loads the highest-version Lightning ``best_model*.ckpt``
(``best_model.ckpt`` is version 0, ``best_model-v{k}.ckpt`` version k) and fails when
none resolves. The port looks in ``logpath`` and in ``logpath/checkpoints``. The orbax
directories the JAX package writes (``checkpoints/best_model-v{k}/``) are that
package's own format, read only through JAX, so they are not read here.
"""

from __future__ import annotations

import os
import re
from typing import Optional

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
