"""The train and eval loops (counterpart of ``tmr_tpu/train/loop.py``; reference
trainer.py Matching_Trainer and main.py's run).

``Trainer.fit`` trains from a seeded init (or given weights): per epoch the train
loader's batches through ``train/state.make_train_step``, the mean losses and the phase
times in one row of ``metrics.csv`` (the JAX row keys), validation at epoch 0 and every
``AP_term``-th epoch (trainer.py:68-73), then ``last.ckpt`` and, on an improvement, a new
``best_model*.ckpt`` (``utils/checkpoint.CheckpointManager``). ``resume`` restores the
last train state and goes on at the next epoch; ``profile_dir`` takes a torch.profiler
trace of the first epoch it trains. wandb mirrors the rows when it is installed and
``nowandb`` is off.

``Trainer.test`` runs the reference's eval chain over the test split: one forward per
batch gives both the losses and the detections (forward -> loss -> decode -> NMS,
trainer.py:123-153), the detections go to per-image JSONs, and the epoch ends by merging
them into COCO-style files and computing AP, AP50, AP75, MAE and RMSE from those
(trainer.py:172-206). Multi-exemplar eval (trainer.py:75-121) runs one image at a time
with its losses summed over the real exemplars. ``eval_batch_size`` > 1 batches images
of one size bucket (forced to 1 when ``num_exemplars`` > 1); a ragged tail is split to
B = 1, and each batch's losses weigh by its image count. The criterion normalizes by the
batch's total positive count, so batched losses differ from B = 1 ones, as in the JAX
package.
"""

from __future__ import annotations

import contextlib
import csv
import dataclasses
import os
import sys
import time
from typing import Dict, Iterator, Mapping, Optional

import numpy as np
import torch

from tmr_tpu_torch.data import DataLoader, build_dataset
from tmr_tpu_torch.inference import Predictor, detections_to_numpy
from tmr_tpu_torch.train.state import TrainState, compute_losses, make_train_step
from tmr_tpu_torch.utils.checkpoint import CheckpointManager, best_checkpoint
from tmr_tpu_torch.utils.convert import load_matching_net
from tmr_tpu_torch.utils.metrics import (coco_style_annotation_generator,
                                         del_img_log_path, get_ap_scores, get_mae_rmse,
                                         image_info_collector)
from tmr_tpu_torch.utils.wandb_logger import WandbLogger
from tmr_tpu_torch.utils.weights import init_params, params_from_jax


def log_info(msg: str) -> None:
    """Progress lines go to stderr; stdout is left to the caller's results."""
    print(msg, file=sys.stderr, flush=True)


class CSVLogger:
    """Epoch metrics CSV (``logpath/metrics.csv``). Rows have varying key sets (val
    metrics only on AP_term epochs), so the file is rewritten with the union of keys,
    never truncating earlier epochs; an existing file's rows are kept (resume)."""

    def __init__(self, logpath: str):
        os.makedirs(logpath, exist_ok=True)
        self.path = os.path.join(logpath, "metrics.csv")
        self._rows: list = []
        if os.path.exists(self.path):
            with open(self.path, newline="") as f:
                self._rows = list(csv.DictReader(f))

    def log(self, row: Dict[str, float]) -> None:
        self._rows.append({k: str(v) for k, v in row.items()})
        keys = sorted({k for r in self._rows for k in r})
        with open(self.path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=keys)
            w.writeheader()
            for r in self._rows:
                w.writerow(r)


class PhaseTimer:
    """Host seconds by phase name over one epoch (the JAX ``PhaseTimer``'s totals)."""

    def __init__(self):
        self.totals: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] = self.totals.get(name, 0.0) + time.perf_counter() - t0

    def as_dict(self, prefix: str = "time/") -> Dict[str, float]:
        """Totals keyed for the metrics CSV (``time/<phase>`` seconds)."""
        return {f"{prefix}{k}": v for k, v in self.totals.items()}


@contextlib.contextmanager
def trace(logdir: Optional[str]) -> Iterator[None]:
    """A torch.profiler trace of the block (host and, with a card, device activity) into
    ``logdir/trace.json``; nothing when ``logdir`` is None."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class Trainer:
    """The train and eval loops over one ``Config``, on ``device`` (``None``: the GPU,
    raising without one; ``"cpu"`` runs the plain versions). ``model`` overrides the
    registry's detector (the tests pass a narrow one)."""

    def __init__(self, cfg, device=None, model: Optional[torch.nn.Module] = None):
        if cfg.refine_box:
            raise NotImplementedError("--refine_box: the SAM refiner is not ported yet "
                                      "(ROADMAP A6)")
        if cfg.visualize:
            raise NotImplementedError("--visualize: the triptychs and PR curves are not "
                                      "ported yet (ROADMAP A4)")
        self.cfg = cfg
        self.predictor = Predictor(cfg, device=device, model=model)
        self.model = self.predictor.model
        self._shared_loss_fn = None
        self.logger = CSVLogger(cfg.logpath)
        self.wandb = None
        if not cfg.nowandb and not cfg.eval:
            self.wandb = WandbLogger(cfg.project_name, name=os.path.basename(cfg.logpath),
                                     config=dataclasses.asdict(cfg))
        self.ckpt = CheckpointManager(
            os.path.join(cfg.logpath, "checkpoints"),
            monitor="val/MAE" if cfg.best_model_count else "val/AP",
            mode="min" if cfg.best_model_count else "max", every_n_epochs=cfg.AP_term,
            # reference callbacks.py:12-13: a fresh training run refuses to clobber a
            # logpath that holds checkpoints
            fresh_guard=not cfg.resume and not cfg.eval)
        self.state: Optional[TrainState] = None

    # ------------------------------------------------------------ plumbing
    def _loaders(self):
        """(train, val, test) loaders. The reference pins val/test to batch size 1;
        ``eval_batch_size`` > 1 is the throughput mode, forced to 1 for multi-exemplar
        eval (its plumbing is per image)."""
        cfg = self.cfg
        train = DataLoader(build_dataset(cfg, "train", eval_mode=False),
                           batch_size=cfg.batch_size, shuffle=True, seed=cfg.seed,
                           max_gt=cfg.max_gt_boxes, max_exemplars=cfg.num_exemplars,
                           num_workers=cfg.num_workers, drop_last=True)
        eval_bs = cfg.eval_batch_size if cfg.num_exemplars == 1 else 1
        if eval_bs != cfg.eval_batch_size:
            log_info(f"--eval_batch_size {cfg.eval_batch_size} forced to 1: "
                     f"multi-exemplar eval is per-image (num_exemplars="
                     f"{cfg.num_exemplars})")
        val_split = "val" if cfg.dataset == "FSCD147" else "test"
        val, test = (DataLoader(build_dataset(cfg, split), batch_size=eval_bs,
                                shuffle=False, seed=cfg.seed, max_gt=cfg.max_gt_boxes,
                                max_exemplars=cfg.num_exemplars,
                                num_workers=cfg.num_workers)
                     for split in (val_split, "test"))
        return train, val, test

    def _loss_fn(self):
        """(model_out, exemplars (B, K, 4), gt_boxes, gt_valid) -> loss dict, built
        once."""
        if self._shared_loss_fn is None:
            cfg = self.cfg

            def loss_fn(out, exemplars, gt_boxes, gt_valid):
                return compute_losses(
                    out, {"exemplars": exemplars, "gt_boxes": gt_boxes,
                          "gt_valid": gt_valid},
                    cfg.positive_threshold, cfg.negative_threshold,
                    use_focal_loss=cfg.focal_loss,
                    scale_imgsize=cfg.regression_scaling_imgsize,
                    scale_wh_only=cfg.regression_scaling_WH_only)

            self._shared_loss_fn = loss_fn
        return self._shared_loss_fn

    def _set_params(self, params) -> None:
        """Weights for the eval: a flax param tree (nested mappings, as
        ``tmr_tpu``'s ``Trainer.test`` takes) or the port's flat ``state_dict``."""
        if any(isinstance(v, Mapping) for v in params.values()):
            params = params_from_jax(params)
        self.predictor.load_state_dict(params)

    # ---------------------------------------------------------------- train
    def fit(self, max_steps_per_epoch: Optional[int] = None, params=None) -> None:
        """Train ``max_epochs`` epochs (from ``last_epoch + 1`` under ``resume``) from
        ``params`` (see :meth:`_set_params`; None: the seeded init of ``cfg.seed``)."""
        cfg = self.cfg
        if cfg.quant != "off" or cfg.quant_storage != "off":
            raise ValueError("fit: training runs the exact weights; quant and "
                             "quant_storage are inference-only (main scrubs them)")
        train, val, _ = self._loaders()
        steps = len(train) if max_steps_per_epoch is None else min(
            len(train), max_steps_per_epoch)
        if params is None:
            init_params(self.model, cfg.seed)
        else:
            self._set_params(params)
        self.state = TrainState(self.model, cfg, steps)
        start_epoch = 0
        if cfg.resume and self.ckpt.last_path():
            self.ckpt.restore(self.ckpt.last_path(), self.state)
            start_epoch = self.ckpt.meta["last_epoch"] + 1
            log_info(f"resumed from epoch {start_epoch}")
        step_fn = make_train_step(self.model, cfg)
        for epoch in range(start_epoch, cfg.max_epochs):
            train.set_epoch(epoch)
            t0 = time.time()
            sums: Optional[dict] = None
            n = 0
            timers = PhaseTimer()
            with trace(cfg.profile_dir if epoch == start_epoch else None):
                it = iter(train)
                try:
                    with timers.phase("data"):
                        nxt = next(it, None)
                    for i in range(steps):
                        if nxt is None:
                            break
                        batch = nxt
                        with timers.phase("step"):
                            losses = step_fn(self.state, batch)
                        with timers.phase("data"):
                            nxt = next(it, None) if i + 1 < steps else None
                        with timers.phase("metrics"):
                            sums = losses if sums is None else {
                                k: sums[k] + losses[k] for k in sums}
                        n += 1
                finally:
                    it.close()
            sums_host = {} if sums is None else {k: float(v) for k, v in sums.items()}
            row = {f"train/{k}": v / max(n, 1) for k, v in sums_host.items()}
            row["epoch"] = epoch
            row["train/sec"] = time.time() - t0
            row.update(timers.as_dict())
            if epoch == 0 or epoch % cfg.AP_term == cfg.AP_term - 1:
                row.update(self.eval_epoch(val, "val"))
            self.logger.log(row)
            if self.wandb is not None:
                self.wandb.log(row, step=epoch)
            log_info(f"Epoch {epoch}: | " + " | ".join(
                f"{k}: {v:.4f}" for k, v in sorted(row.items()) if k != "epoch"))
            self.ckpt.save_epoch(self.state, epoch, row)
        if self.wandb is not None:
            self.wandb.finish()

    # ----------------------------------------------------------------- eval
    @staticmethod
    def _split_per_image(batch: dict):
        """A ragged tail batch -> B = 1 sub-batches."""
        for i in range(batch["image"].shape[0]):
            yield {k: (v[i:i + 1] if k != "meta" else [v[i]]) for k, v in batch.items()}

    def eval_epoch(self, loader, stage: str, params=None) -> Dict[str, float]:
        """The eval loop over ``loader`` with ``params`` (see :meth:`_set_params`; None
        keeps the model's weights). Batch k's detections are fetched only after batch
        k + 1 has been handed to the device."""
        cfg = self.cfg
        if params is not None:
            self._set_params(params)
        sums: Optional[dict] = None
        n = 0
        pending = None

        def collect(p):
            nonlocal sums, n
            bsz, meta, losses, dets = p
            scaled = {k: v * float(bsz) for k, v in losses.items()}
            sums = scaled if sums is None else {k: sums[k] + scaled[k] for k in sums}
            n += bsz
            image_info_collector(cfg.logpath, stage, meta, detections_to_numpy(dets))

        for full_batch in loader:
            b = full_batch["image"].shape[0]
            if cfg.num_exemplars == 1 and b not in (1, cfg.eval_batch_size):
                sub_batches = self._split_per_image(full_batch)
            else:
                sub_batches = [full_batch]
            for batch in sub_batches:
                losses, dets = self._eval_batch(batch)
                if pending is not None:
                    collect(pending)
                pending = (int(batch["image"].shape[0]), batch["meta"], losses, dets)
        if pending is not None:
            collect(pending)
        return self._finish_eval(stage, sums, n)

    def _eval_batch(self, batch: dict):
        """(losses, detections) of one batch: the multi-exemplar program with exemplars
        taken from the image's pixel annotations (``orig_exemplars / img_size``), or
        the single-exemplar program with the losses of the same forward."""
        pred = self.predictor
        if self.cfg.num_exemplars > 1:
            meta = batch["meta"][0]
            exemplars = meta["orig_exemplars"] / np.array(
                meta["img_size"].tolist() * 2, np.float32)
            return pred.predict_multi_exemplar(
                batch["image"], exemplars, loss_fn=self._loss_fn(),
                loss_args=(batch["gt_boxes"], batch["gt_valid"]))
        cap = pred.pick_capacity(batch["exemplars"], int(batch["image"].shape[1]))
        fn = pred._get_fn(cap, loss_fn=self._loss_fn())
        return fn(batch["image"], batch["exemplars"], batch["gt_boxes"],
                  batch["gt_valid"])

    def _finish_eval(self, stage: str, sums: Optional[dict], n: int) -> Dict[str, float]:
        """Loss means, then the per-image JSONs merged into COCO-style files and the
        metrics computed from them; the per-image JSONs are removed after."""
        cfg = self.cfg
        sums_host = {} if sums is None else {k: float(v) for k, v in sums.items()}
        metrics = {f"{stage}/{k}": v / max(n, 1) for k, v in sums_host.items()}
        coco_style_annotation_generator(cfg.logpath, stage)
        mae, rmse = get_mae_rmse(cfg.logpath, stage)
        ap, ap50, ap75 = get_ap_scores(cfg.logpath, stage)
        metrics.update({f"{stage}/AP": ap, f"{stage}/AP50": ap50, f"{stage}/AP75": ap75,
                        f"{stage}/MAE": mae, f"{stage}/RMSE": rmse})
        log_info(f"{stage}/AP: {ap:.2f} | {stage}/AP50: {ap50:.2f} | {stage}/AP75: "
                 f"{ap75:.2f} | {stage}/MAE: {mae:.2f} | {stage}/RMSE: {rmse:.2f}")
        del_img_log_path(cfg.logpath, stage)
        return metrics

    def test(self, params=None) -> Dict[str, float]:
        """The eval entry (reference main.py:122-130): with no ``params``, the
        highest-version Lightning ``best_model*.ckpt`` under ``cfg.logpath`` (or its
        ``checkpoints/``, where ``fit`` writes them) is loaded; none raises
        ``FileNotFoundError``."""
        _, _, test = self._loaders()
        if params is None:
            best = best_checkpoint(self.cfg.logpath)
            if best is None:
                raise FileNotFoundError(
                    f"--eval: no best_model*.ckpt under {self.cfg.logpath} or its "
                    "checkpoints/ (orbax directories of the JAX package are not read); "
                    "pass params or put the reference's checkpoint there")
            log_info(f"--eval: loading {best}")
            params = load_matching_net(best)
        return self.eval_epoch(test, "test", params)
