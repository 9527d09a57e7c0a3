"""The eval loop (counterpart of the eval half of ``tmr_tpu/train/loop.py``; reference
trainer.py Matching_Trainer's test path and main.py's ``--eval``).

``Trainer.test`` runs the reference's eval chain over the test split: one forward per
batch gives both the losses and the detections (forward -> loss -> decode -> NMS,
trainer.py:123-153), the detections go to per-image JSONs, and the epoch ends by merging
them into COCO-style files and computing AP, AP50, AP75, MAE and RMSE from those
(trainer.py:172-206). Multi-exemplar eval (trainer.py:75-121) runs one image at a time
with its losses summed over the real exemplars. ``eval_batch_size`` > 1 batches images
of one size bucket (forced to 1 when ``num_exemplars`` > 1); a ragged tail is split to
B = 1, and each batch's losses weigh by its image count. The criterion normalizes by the
batch's total positive count, so batched losses differ from B = 1 ones, as in the JAX
package. Training (``fit``, checkpoint saving, the CSV and wandb loggers) is not ported
yet (ROADMAP A8).
"""

from __future__ import annotations

import sys
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from tmr_tpu_torch.data import DataLoader, build_dataset
from tmr_tpu_torch.inference import Predictor, detections_to_numpy
from tmr_tpu_torch.train.state import compute_losses
from tmr_tpu_torch.utils.checkpoint import best_checkpoint
from tmr_tpu_torch.utils.convert import load_matching_net
from tmr_tpu_torch.utils.metrics import (coco_style_annotation_generator,
                                         del_img_log_path, get_ap_scores, get_mae_rmse,
                                         image_info_collector)
from tmr_tpu_torch.utils.weights import params_from_jax


def log_info(msg: str) -> None:
    """Progress lines go to stderr; stdout is left to the caller's results."""
    print(msg, file=sys.stderr, flush=True)


class Trainer:
    """The eval loop over one ``Config``, on ``device`` (``None``: the GPU, raising
    without one; ``"cpu"`` runs the plain versions). ``model`` overrides the registry's
    detector (the tests pass a narrow one)."""

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
        ``checkpoints/``) is loaded; none raises ``FileNotFoundError``."""
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
