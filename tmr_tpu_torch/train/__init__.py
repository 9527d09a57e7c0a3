"""The training package (counterpart of ``tmr_tpu/train``): target assignment, the
criterion and ``compute_losses``, ``TrainState`` and the train step (``state.py``), and
the ``Trainer`` (``loop.py``) with its eval entry points and ``fit``."""
