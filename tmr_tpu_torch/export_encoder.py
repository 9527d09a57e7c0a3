"""Export the SAM encoder, or the whole detector, as a ``torch.export`` artifact
(counterpart of the repo's ``export_encoder.py``; reference ``export_onnx.py``).

The reference exports its encoder with ``torch.onnx.export`` (opset 12, a dynamic batch
axis; export_onnx.py:76-89) for onnxruntime on the Hadoop workers. Here the encoder is
traced with a symbolic batch into a ``.pt2`` program (``utils/export.py``) that the map
phase's workers load with ``--artifact`` (``parallel/mapreduce.py``, ``elastic_map.py``,
``extract_feature.py``): no model code and no weights on the worker, only the port's ops
package. The program is traced on ``--device`` (the card by default, which raises
without one; ``--device cpu`` when asked) and carries its weights on that device.

Like export_onnx.py:39-52, an optional SAM(-HQ) ``.pth`` (``image_encoder.*`` keys,
``utils/convert.sam_vit_state_dict``) gives the encoder its weights; without one they are
seeded (the reference exports without weights too, export_onnx.py:27).

``--detector`` exports the whole detector instead (encoder, matcher, heads, decode, NMS:
the Predictor's own program) at one static template capacity and batch 1, with the
weights of ``--tmr_checkpoint``, a Lightning ``best_model*.ckpt`` as ``main --eval``
reads it (the JAX package's orbax directories are not read), or seeded ones.

Usage:
  python -m tmr_tpu_torch.export_encoder --model_type vit_b \\
      [--checkpoint checkpoints/sam_hq_vit_b.pth] \\
      [--output exported/sam_vit_b_encoder.pt2] [--image_size 1024] [--device cuda]
  python -m tmr_tpu_torch.export_encoder --detector [--tmr_checkpoint best_model.ckpt] \\
      [--template_capacity 17] [--n_exemplars 1]
"""

from __future__ import annotations

import argparse
import os
import time

import torch

#: the encoder names of ``--model_type`` and the detector's backbone each one builds
BACKBONES = {"vit_b": "sam_vit_b", "vit_h": "sam_vit_h"}


def _write(program, output: str) -> float:
    from tmr_tpu_torch.utils.export import save_exported

    os.makedirs(os.path.dirname(output) or ".", exist_ok=True)
    save_exported(program, output)
    return os.path.getsize(output) / 1e6


def export_model(model_type: str = "vit_b", checkpoint: str | None = None,
                 output: str = "exported/sam_vit_b_encoder.pt2", image_size: int = 1024,
                 compute_dtype: str = "bfloat16", device=None) -> str:
    """The SAM encoder's artifact: input ``(b, S, S, 3)`` f32 NHWC, ``b`` symbolic."""
    from tmr_tpu_torch.models import build_sam_encoder
    from tmr_tpu_torch.utils.export import export_encoder

    dtype = torch.bfloat16 if compute_dtype == "bfloat16" else torch.float32
    model = build_sam_encoder(model_type, checkpoint, dtype=dtype, device=device)
    print(f"weights: {'converted from ' + checkpoint if checkpoint else 'seeded (seed 0)'}")
    t0 = time.perf_counter()
    program = export_encoder(model, image_size=image_size)
    mb = _write(program, output)
    print(f"wrote {output} ({mb:.1f} MB, {time.perf_counter() - t0:.1f} s; symbolic "
          f"batch, input (b, {image_size}, {image_size}, 3) float32, traced on "
          f"{next(model.parameters()).device})")
    return output


def export_detector_artifact(model_type: str = "vit_b", tmr_checkpoint: str | None = None,
                             output: str = "exported/tmr_detector.pt2",
                             image_size: int = 1024, compute_dtype: str = "bfloat16",
                             template_capacity: int = 17, n_exemplars: int = 1,
                             device=None, **preset_overrides) -> str:
    """The whole detector's artifact at ``template_capacity``, batch 1: ``(image (1, S, S,
    3), exemplars (1, 1, 4)) -> (boxes, scores, valid)``, or with ``n_exemplars > 1``
    ``(image, exemplars (K, 4), k_real () int32)``. Thresholds and caps come from
    ``preset("TMR_FSCD147")``; ``preset_overrides`` override them."""
    from tmr_tpu_torch.config import preset
    from tmr_tpu_torch.inference import Predictor
    from tmr_tpu_torch.utils.convert import load_matching_net
    from tmr_tpu_torch.utils.export import export_detector

    cfg = preset("TMR_FSCD147", backbone=BACKBONES[model_type], image_size=image_size,
                 compute_dtype=compute_dtype, **preset_overrides)
    predictor = Predictor(cfg, device=device)
    if tmr_checkpoint:
        predictor.load_state_dict(load_matching_net(tmr_checkpoint))
    else:
        predictor.init_params(0)
    print(f"weights: {'restored from ' + tmr_checkpoint if tmr_checkpoint else 'seeded (seed 0)'}")
    t0 = time.perf_counter()
    program = export_detector(predictor, template_capacity, image_size=image_size,
                              n_exemplars=n_exemplars)
    mb = _write(program, output)
    sig = (f"(1, {image_size}, {image_size}, 3) f32 + (1, 1, 4) f32" if n_exemplars == 1
           else f"(1, {image_size}, {image_size}, 3) f32 + ({n_exemplars}, 4) f32 + k_real "
                "() int32")
    print(f"wrote {output} ({mb:.1f} MB, {time.perf_counter() - t0:.1f} s; batch 1, "
          f"inputs {sig}, capacity {template_capacity}, traced on {predictor.device})")
    return output


def main(argv=None) -> str:
    p = argparse.ArgumentParser(prog="python -m tmr_tpu_torch.export_encoder",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model_type", default="vit_b", choices=sorted(BACKBONES))
    p.add_argument("--checkpoint", default=None,
                   help="SAM(-HQ) .pth with image_encoder.* keys (the encoder export)")
    p.add_argument("--output", default=None)
    p.add_argument("--image_size", default=1024, type=int)
    p.add_argument("--compute_dtype", default="bfloat16", choices=("bfloat16", "float32"))
    p.add_argument("--detector", action="store_true",
                   help="export the whole detector (encoder, matcher, heads, decode, NMS) "
                        "instead of the encoder alone")
    p.add_argument("--tmr_checkpoint", default=None,
                   help="Lightning best_model*.ckpt for --detector's weights (what main "
                        "--eval reads)")
    p.add_argument("--template_capacity", default=17, type=int,
                   help="the detector artifact's static template bucket; export one "
                        "artifact per bucket and route by exemplar span when serving")
    p.add_argument("--n_exemplars", default=1, type=int,
                   help="the detector artifact's static exemplar-row count")
    p.add_argument("--device", default="cuda",
                   help="the device to trace on and to hold the weights: 'cuda' "
                        "(default; raises without a GPU) or 'cpu'")
    args = p.parse_args(argv)
    if args.detector:
        if args.checkpoint:
            p.error("--checkpoint (a SAM .pth) is the encoder export's; --detector takes "
                    "--tmr_checkpoint")
        return export_detector_artifact(
            args.model_type, args.tmr_checkpoint,
            args.output or "exported/tmr_detector.pt2", args.image_size,
            args.compute_dtype, args.template_capacity, args.n_exemplars, args.device)
    return export_model(args.model_type, args.checkpoint,
                        args.output or f"exported/sam_{args.model_type}_encoder.pt2",
                        args.image_size, args.compute_dtype, args.device)


if __name__ == "__main__":
    main()
