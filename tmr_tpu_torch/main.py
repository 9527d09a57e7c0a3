"""Command-line entry of the port (counterpart of the repo's ``main.py``; reference
main.py:14-130), to train and to eval:

    python -m tmr_tpu_torch.main --dataset FSCD147 --datapath DIR --logpath DIR \
        --backbone sam_vit_b --emb_dim 512 --fusion --feature_upsample --lr_drop ...
    python -m tmr_tpu_torch.main --eval [the same flags]

Without ``--backbone`` the detector is ``main.py``'s default: ResNet-50 with DC5
(``--dilation``; an empty value turns it off, as in ``main.py``), computed in f32;
``--backbone resnet50_layer{1,2,3}[_FRZ]`` truncates it (``_FRZ`` freezes it), and
``--template_type prototype`` correlates a 1 x 1 crop-mean template.

The flags are those of ``main.py`` that training and eval read (and that the scripts in
``scripts/train/`` and ``scripts/eval/`` pass), under the same names and defaults.
Without ``--eval`` it trains (``Trainer.fit``: checkpoints and ``metrics.csv`` under
``--logpath``, ``--resume`` to go on from ``last.ckpt``), then evaluates the best
checkpoint on the test split; the quantization fields, inference-only, are forced off
for training and what was forced is logged. ``--eval`` loads the highest-version
Lightning ``best_model*.ckpt`` under ``--logpath`` (or its ``checkpoints/``). Either way
the test metrics are printed as one JSON line. ``--device`` defaults to the GPU
(``cuda``) and raises without one; ``--device cpu`` runs the plain CPU versions.
``--refine_box`` refines every eval program's detections with the SAM refiner before NMS
(``--refiner_checkpoint``: a SAM ``.pth``; without it, seeded weights and a warning).
``--compute_dtype float32`` runs the SAM encoder in f32 on the card too (the f32
attention kernels, ``csrc/attn_f32.cu``). ``--visualize`` writes each eval's triptychs
(and its PR curves where matplotlib is installed) under ``--logpath``'s
``visualizations/{stage}/``. The mesh flags, ``--pp_microbatches`` and ``--autotune``
raise, each naming its ROADMAP item; ``--eval_multi_scale`` is accepted and unused, as
in ``main.py``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import random
import sys

import numpy as np


def config_parser(argv=None):
    p = argparse.ArgumentParser(description="Matching Network (PyTorch port)")
    p.add_argument("--seed", default=42, type=int)

    # logging
    p.add_argument("--project_name", type=str, default="Few-Shot Pattern Detection")
    p.add_argument("--logpath", type=str, default="./outputs/default")
    p.add_argument("--nowandb", action="store_true",
                   help="training logs to metrics.csv only (wandb is used when installed)")
    p.add_argument("--AP_term", default=5, type=int)
    p.add_argument("--best_model_count", action="store_true")

    # dataset
    p.add_argument("--datapath", type=str, default="/home/")
    p.add_argument("--dataset", type=str, default="RPINE")
    p.add_argument("--batch_size", default=1, type=int)
    p.add_argument("--eval_batch_size", default=1, type=int,
                   help="batch size for val/test (the reference pins 1; forced to 1 when "
                        "--num_exemplars > 1)")
    p.add_argument("--num_workers", default=8, type=int)
    p.add_argument("--num_exemplars", default=1, type=int)
    p.add_argument("--image_size", default=1024, type=int)

    # training
    p.add_argument("--resume", action="store_true")
    p.add_argument("--max_epochs", default=30, type=int)

    # optimizer
    p.add_argument("--weight_decay", default=1e-4, type=float)
    p.add_argument("--clip_max_norm", default=0.1, type=float)
    p.add_argument("--lr_drop", action="store_true")
    p.add_argument("--lr", default=1e-4, type=float)
    p.add_argument("--lr_backbone", default=1e-5, type=float)
    p.add_argument("--grad_accum_steps", default=1, type=int,
                   help="accumulate gradients over k micro-steps before one optimizer "
                        "update")

    # eval / vis
    p.add_argument("--eval", action="store_true")
    p.add_argument("--visualize", action="store_true")

    # model
    p.add_argument("--modeltype", type=str, default="matching_net")
    p.add_argument("--emb_dim", default=512, type=int)
    p.add_argument("--no_matcher", action="store_true")
    p.add_argument("--squeeze", action="store_true")
    p.add_argument("--fusion", action="store_true")
    p.add_argument("--positive_threshold", default=0.7, type=float)
    p.add_argument("--negative_threshold", default=0.7, type=float)
    p.add_argument("--NMS_cls_threshold", default=0.1, type=float)
    p.add_argument("--NMS_iou_threshold", default=0.15, type=float)
    p.add_argument("--refine_box", action="store_true")
    p.add_argument("--refiner_checkpoint", default=None, type=str)
    p.add_argument("--ablation_no_box_regression", action="store_true")
    p.add_argument("--template_type", type=str, default="roi_align")
    p.add_argument("--feature_upsample", action="store_true")
    p.add_argument("--eval_multi_scale", action="store_true",
                   help="accepted and unused, as in the reference and the JAX package")
    p.add_argument("--regression_scaling_imgsize", action="store_true")
    p.add_argument("--regression_scaling_WH_only", action="store_true")
    p.add_argument("--focal_loss", action="store_true")

    # backbone / heads
    p.add_argument("--backbone", default="resnet50", type=str)
    p.add_argument("--encoder", default="original", type=str)
    p.add_argument("--dilation", default=True)
    p.add_argument("--decoder_num_layer", default=1, type=int)
    p.add_argument("--decoder_kernel_size", default=3, type=int)

    # the port's device, and main.py's additions that eval reads
    p.add_argument("--device", default="cuda", type=str,
                   help="'cuda' (default; raises without a GPU) or 'cpu'")
    p.add_argument("--multi_gpu", action="store_true")
    p.add_argument("--mesh_data", default=-1, type=int)
    p.add_argument("--mesh_model", default=1, type=int)
    p.add_argument("--mesh_seq", default=1, type=int)
    p.add_argument("--mesh_pipe", default=1, type=int)
    p.add_argument("--pp_microbatches", default=0, type=int,
                   help="pipeline microbatches: not ported yet, raises (ROADMAP A7)")
    p.add_argument("--compute_dtype", default="bfloat16", type=str)
    p.add_argument("--max_detections", default=2000, type=int)
    p.add_argument("--profile_dir", default=None, type=str,
                   help="a torch.profiler trace of the first trained epoch goes here")
    p.add_argument("--remat_backbone", action="store_true",
                   help="recompute each ViT block on the backward pass")
    p.add_argument("--autotune", action="store_true",
                   help="kernel-formulation autotuning: not ported yet, raises "
                        "(ROADMAP A8)")
    return p.parse_args(argv)


#: flags of ``main.py`` the port refuses, their values that change nothing, and the
#: ROADMAP item that ports them: the mesh flags (multi-device runs), the pipeline's
#: microbatches and the autotuner
_REFUSED_DEFAULTS = {"multi_gpu": (False, "A7"), "mesh_data": (-1, "A7"),
                     "mesh_model": (1, "A7"), "mesh_seq": (1, "A7"),
                     "mesh_pipe": (1, "A7"), "pp_microbatches": (0, "A7"),
                     "autotune": (False, "A8")}


def to_config(args):
    from tmr_tpu_torch.config import Config

    fields = {f.name for f in dataclasses.fields(Config)}
    kw = {k: v for k, v in vars(args).items() if k in fields}
    kw["dilation"] = bool(args.dilation)
    return Config(**kw)


#: the inference-only quantization fields a training run must not take, and their
#: exact-weight values (``main.py``'s ``_TRAINING_SCRUB_KNOBS``: quantized rounding has
#: (near-)zero gradient, and an optimizer must never update an int8 stored leaf)
_TRAINING_SCRUB = {"quant": "off", "quant_storage": "off", "quant_kernel": "dequant"}


def scrub_training_config(cfg):
    """``cfg`` with the quantization fields forced to exact weights, and the names of
    the fields that were changed (``main.py``'s ``scrub_training_env``)."""
    scrubbed = [k for k, v in _TRAINING_SCRUB.items() if getattr(cfg, k) != v]
    return dataclasses.replace(cfg, **_TRAINING_SCRUB), scrubbed


def main(argv=None) -> dict:
    args = config_parser(argv)
    refused = [(k, item) for k, (v, item) in _REFUSED_DEFAULTS.items()
               if getattr(args, k) != v]
    if refused:
        raise NotImplementedError(
            "; ".join(f"--{k}: not ported yet (ROADMAP {item})" for k, item in refused)
            + " (the multi-device runs and the pipeline are A7, the autotuner A8)")
    import torch

    from tmr_tpu_torch.train.loop import Trainer

    # seed_everything (reference main.py:86)
    random.seed(args.seed)
    np.random.seed(args.seed)
    torch.manual_seed(args.seed)
    cfg = to_config(args)
    if cfg.eval:
        metrics = Trainer(cfg, device=args.device).test()
    else:
        cfg, scrubbed = scrub_training_config(cfg)
        if scrubbed:
            print(f"{'/'.join(scrubbed)} ignored for training (inference-only); running "
                  "exact weights", file=sys.stderr, flush=True)
        trainer = Trainer(cfg, device=args.device)
        trainer.fit()
        metrics = trainer.test()
    print(json.dumps(metrics), flush=True)
    return metrics


if __name__ == "__main__":
    main()
