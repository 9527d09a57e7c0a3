"""Losses, the optimizer and the train step (counterpart of ``tmr_tpu/train/state.py``;
reference trainer.py:208-236 and the Lightning wiring).

The reference's recipe: AdamW with two learning-rate groups, the backbone at
``lr_backbone`` (0 in every published script, so frozen) and everything else at ``lr``,
weight decay 1e-4, a global-norm gradient clip of 0.1 (main.py:116) and a x0.1 drop at 60%
of training under ``lr_drop`` (trainer.py:227-234). The JAX package expresses it as one
optax chain, ``clip_by_global_norm -> multi_transform{head: adamw, backbone: adamw |
set_to_zero}``, wrapped in ``MultiSteps`` for ``grad_accum_steps`` > 1; this module keeps
its order:

- gradients are taken for every parameter, the frozen backbone's too, and the clip's
  global norm and the non-finite check run over all of them;
- the frozen group (``set_to_zero``) has no moments and no weight decay, and never moves;
- the drop lands on the update whose count reaches ``int(max_epochs * 0.6) *
  updates_per_epoch`` (optax's ``piecewise_constant_schedule``), counted in optimizer
  updates, not in data steps;
- with k > 1 micro-steps the clip and the update take the running mean of k micro
  gradients (optax's Welford mean), one update every k;
- a step whose loss or any gradient is non-finite is discarded whole: parameters,
  moments, the update count and the accumulation state keep their values, and the step
  reports ``skipped_nonfinite``.

The AdamW of each group is ``torch.optim.AdamW`` (optax's ``adamw`` update in the same
algebra: the decay on the parameter before the step, the bias-corrected moments, eps
outside the root). Parameters stay f32 masters: the bf16 compute casts of
``models/common.py`` are differentiable as they are. Unlike the JAX step, which returns a
new state, :class:`TrainState` and the step update the model's parameters in place.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional

import torch

from tmr_tpu_torch.train.criterion import criterion
from tmr_tpu_torch.train.targets import assign_targets

#: optax ``adamw``'s defaults, which ``make_optimizer`` of the JAX package keeps
ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


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


def frozen_backbone(cfg) -> bool:
    """The backbone is frozen at ``lr_backbone == 0`` or for a ``*_FRZ`` backbone name."""
    return cfg.lr_backbone == 0 or cfg.backbone.endswith("_FRZ")


def param_labels(model: torch.nn.Module, frozen: bool) -> Dict[str, str]:
    """Each parameter's group: ``"backbone"`` (``"frozen"`` when ``frozen``) under the
    top-level ``backbone`` module, else ``"head"`` (the reference matches parameter names
    on 'backbone', trainer.py:210-225). The JAX package's third case, FrozenBatchNorm
    statistics, are buffers here and never reach the optimizer."""
    return {name: ("frozen" if frozen else "backbone") if name.split(".")[0] == "backbone"
            else "head" for name, _ in model.named_parameters()}


def lr_milestone(cfg, steps_per_epoch: int) -> int:
    """The optimizer update from which the learning rates are x0.1: ``int(max_epochs *
    0.6)`` epochs of updates under ``lr_drop``, else past the end of training."""
    updates_per_epoch = max(steps_per_epoch // max(cfg.grad_accum_steps, 1), 1)
    if cfg.lr_drop:
        return int(cfg.max_epochs * 0.6) * updates_per_epoch
    return (cfg.max_epochs + 1) * updates_per_epoch


def scheduled_lr(base: float, count: int, milestone: int) -> float:
    """optax ``piecewise_constant_schedule(base, {milestone: 0.1})`` at update ``count``."""
    return base * 0.1 if count >= milestone else base


class TrainState:
    """The optimizer state of one model: AdamW over the head (and the backbone when it
    trains), the update count the schedule reads, the micro-step accumulation, and the
    count of train steps applied (the JAX ``TrainState.step``)."""

    def __init__(self, model: torch.nn.Module, cfg, steps_per_epoch: int):
        self.model = model
        self.params = dict(model.named_parameters())
        self.labels = param_labels(model, frozen_backbone(cfg))
        self.bases = {"head": cfg.lr, "backbone": cfg.lr_backbone}
        groups = [{"params": [p for n, p in self.params.items() if self.labels[n] == name],
                   "lr": base, "name": name}
                  for name, base in self.bases.items()
                  if name in self.labels.values()]
        self.optimizer = torch.optim.AdamW(groups, betas=ADAM_BETAS, eps=ADAM_EPS,
                                           weight_decay=cfg.weight_decay)
        self.clip_max_norm = cfg.clip_max_norm
        self.milestone = lr_milestone(cfg, steps_per_epoch)
        self.accum = max(cfg.grad_accum_steps, 1)
        self.count = 0
        self.step = 0
        self.mini_step = 0
        self.acc: Optional[Dict[str, torch.Tensor]] = None

    def apply_gradients(self, grads: Mapping[str, torch.Tensor],
                        loss: Optional[torch.Tensor] = None) -> bool:
        """One train step's gradients (every parameter's, by name): discarded whole when
        they or ``loss`` hold a non-finite value (returns False), else accumulated and,
        on the k-th micro-step, clipped and applied."""
        leaves = [g.detach() for g in grads.values()]
        checks = torch.stack(torch._foreach_norm(leaves, float("inf")))
        if loss is not None:
            checks = torch.cat([checks, loss.detach().float().reshape(1)])
        if not bool(torch.isfinite(checks).all()):
            return False
        self.step += 1
        if self.accum > 1:
            if self.acc is None:
                self.acc = {n: torch.zeros_like(p) for n, p in self.params.items()}
            for n, g in grads.items():
                self.acc[n].add_((g.detach() - self.acc[n]) / (self.mini_step + 1))
            self.mini_step += 1
            if self.mini_step < self.accum:
                return True
            self.mini_step = 0
            grads = self.acc
        self._update(grads)
        if self.acc is not None:
            for a in self.acc.values():
                a.zero_()
        return True

    def _update(self, grads: Mapping[str, torch.Tensor]) -> None:
        """The global-norm clip over all gradients, then AdamW at the scheduled rates."""
        norm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm([g.detach() for g in grads.values()])))
        clip = norm >= self.clip_max_norm
        for name, g in grads.items():
            if self.labels[name] != "frozen":
                g = g.detach()
                self.params[name].grad = torch.where(clip, g / norm * self.clip_max_norm, g)
        for group in self.optimizer.param_groups:
            group["lr"] = scheduled_lr(self.bases[group["name"]], self.count, self.milestone)
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.count += 1

    def state_dict(self) -> dict:
        """Everything a resumed run needs: the model's parameters, the moments, the
        counts and the accumulation state."""
        return {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(),
                "count": self.count, "step": self.step, "mini_step": self.mini_step,
                "acc": self.acc}

    def load_state_dict(self, sd: Mapping) -> None:
        self.model.load_state_dict(sd["model"])
        self.optimizer.load_state_dict(sd["optimizer"])
        self.count, self.step, self.mini_step = sd["count"], sd["step"], sd["mini_step"]
        self.acc = (None if sd["acc"] is None else
                    {n: sd["acc"][n].to(p.device) for n, p in self.params.items()})


def make_train_step(model: torch.nn.Module, cfg) -> Callable[[TrainState, dict], dict]:
    """The train step: ``(state, batch) -> losses``, applying the step to ``state`` in
    place. The forward runs at the largest template bucket, as the JAX trainer builds its
    model with ``template_capacity=max(template_buckets)`` (191 correlates through the
    FFT path, which autograd differentiates). Every parameter gets its gradient; the
    losses come back detached, with ``skipped_nonfinite``."""
    capacity = int(max(cfg.template_buckets))

    def train_step(state: TrainState, batch: dict) -> dict:
        device = next(model.parameters()).device
        image = torch.as_tensor(batch["image"], dtype=torch.float32, device=device)
        exemplars = torch.as_tensor(batch["exemplars"], dtype=torch.float32, device=device)
        for p in state.params.values():
            p.grad = None
        out = model(image, exemplars, capacity)
        losses = compute_losses(
            out, {"exemplars": exemplars, "gt_boxes": batch["gt_boxes"],
                  "gt_valid": batch["gt_valid"]},
            cfg.positive_threshold, cfg.negative_threshold, use_focal_loss=cfg.focal_loss,
            scale_imgsize=cfg.regression_scaling_imgsize,
            scale_wh_only=cfg.regression_scaling_WH_only)
        losses["loss"].backward()
        grads = {n: torch.zeros_like(p) if p.grad is None else p.grad
                 for n, p in state.params.items()}
        ok = state.apply_gradients(grads, losses["loss"])
        for p in state.params.values():
            p.grad = None
        losses = {k: v.detach() for k, v in losses.items()}
        losses["skipped_nonfinite"] = torch.tensor(0.0 if ok else 1.0, device=device)
        return losses

    return train_step
