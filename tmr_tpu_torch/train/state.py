"""Losses of one forward (counterpart of ``compute_losses`` in
``tmr_tpu/train/state.py``). ``TrainState``, the optimizer and the train step belong to
training and are not ported yet."""

from __future__ import annotations

import torch

from tmr_tpu_torch.train.criterion import criterion
from tmr_tpu_torch.train.targets import assign_targets


def _levels(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def compute_losses(model_out: dict, batch: dict, positive_threshold: float,
                   negative_threshold: float, use_focal_loss: bool = False,
                   scale_imgsize: bool = False, scale_wh_only: bool = False) -> dict:
    """Model outputs + batch -> loss dict (the body of reference trainer.py:132-137).

    model_out: objectness (B, H, W) and regressions (B, H, W, 4) or None, the port's
    single level, or lists of levels as the JAX package gives them. batch: exemplars
    (B, K, 4) (the first is used), gt_boxes (B, M, 4) normalized xyxy padded, gt_valid
    (B, M) bool."""
    objectness = _levels(model_out["objectness"])
    regressions = _levels(model_out["regressions"])
    dev = objectness[0].device
    ex0 = torch.as_tensor(batch["exemplars"], device=dev)[:, 0, :].float()
    gt_boxes = torch.as_tensor(batch["gt_boxes"], device=dev)
    gt_valid = torch.as_tensor(batch["gt_valid"], device=dev)
    targets = [assign_targets(gt_boxes, gt_valid, ex0, obj.shape[1], obj.shape[2],
                              positive_threshold, negative_threshold,
                              is_last_level=(lvl == len(objectness) - 1))
               for lvl, obj in enumerate(objectness)]
    return criterion(objectness, regressions, targets, ex0, use_focal_loss=use_focal_loss,
                     scale_imgsize=scale_imgsize, scale_wh_only=scale_wh_only)
