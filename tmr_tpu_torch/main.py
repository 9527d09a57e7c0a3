"""Command-line entry of the port (counterpart of the repo's ``main.py``; reference
main.py:14-130), for eval:

    python -m tmr_tpu_torch.main --eval --dataset FSCD147 --datapath DIR \
        --logpath DIR --backbone sam_vit_b --emb_dim 512 --fusion --feature_upsample ...

The flags are those of ``main.py`` that eval reads (and that the eval scripts in
``scripts/eval/`` pass), under the same names and defaults. ``--eval`` loads the
highest-version Lightning ``best_model*.ckpt`` under ``--logpath`` (or its
``checkpoints/``), runs the test split and prints the metrics as one JSON line.
``--device`` defaults to the GPU (``cuda``) and raises without one; ``--device cpu`` runs
the plain CPU versions. Without ``--eval`` it exits: training is not ported yet (ROADMAP
A8). ``--refine_box``, ``--visualize`` and the mesh flags raise, each naming its ROADMAP
item.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import random

import numpy as np


def config_parser(argv=None):
    p = argparse.ArgumentParser(description="Matching Network (PyTorch port), eval")
    p.add_argument("--seed", default=42, type=int)

    # logging
    p.add_argument("--project_name", type=str, default="Few-Shot Pattern Detection")
    p.add_argument("--logpath", type=str, default="./outputs/default")
    p.add_argument("--nowandb", action="store_true",
                   help="kept for parity; eval logs to stderr and its JSON files")

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
    p.add_argument("--compute_dtype", default="bfloat16", type=str)
    p.add_argument("--max_detections", default=2000, type=int)
    return p.parse_args(argv)


#: mesh flags and their single-device values: any other value raises (ROADMAP A9)
_MESH_DEFAULTS = {"multi_gpu": False, "mesh_data": -1, "mesh_model": 1, "mesh_seq": 1,
                  "mesh_pipe": 1}


def to_config(args):
    from tmr_tpu_torch.config import Config

    fields = {f.name for f in dataclasses.fields(Config)}
    kw = {k: v for k, v in vars(args).items() if k in fields}
    kw["dilation"] = bool(args.dilation)
    return Config(**kw)


def main(argv=None) -> dict:
    args = config_parser(argv)
    if not args.eval:
        raise SystemExit("tmr_tpu_torch.main runs --eval only: training is not ported "
                         "yet (ROADMAP A8)")
    meshed = [k for k, v in _MESH_DEFAULTS.items() if getattr(args, k) != v]
    if meshed:
        raise NotImplementedError(f"--{' --'.join(meshed)}: multi-device runs are not "
                                  "ported yet (ROADMAP A9)")
    import torch

    from tmr_tpu_torch.train.loop import Trainer

    # seed_everything (reference main.py:86)
    random.seed(args.seed)
    np.random.seed(args.seed)
    torch.manual_seed(args.seed)
    metrics = Trainer(to_config(args), device=args.device).test()
    print(json.dumps(metrics), flush=True)
    return metrics


if __name__ == "__main__":
    main()
