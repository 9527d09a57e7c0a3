"""The eval half of the training package (counterpart of ``tmr_tpu/train``): target
assignment, the criterion, ``compute_losses`` and the ``Trainer``'s eval entry points.
Training itself (``TrainState``, the train step, ``Trainer.fit``) is not ported yet."""
