"""Single-image SAM-encoder feature extraction and statistics (counterpart of the repo's
``extract_feature.py``; reference extract_feature.py:12-123).

Load an image, SAM's preprocessing (the longest side resized to 1024, SAM pixel
normalization, zero padding: ``data/transforms.sam_longest_side_preprocess``), the
encoder, the 4 statistics (mean, std, max, sparsity = share <= 0; :78-82), the analysis
table with the rule-based Easy/Hard verdict (thresholds 0.0130 / 0.0137; :95-100), and
the features dumped as ``<name>_feature.npy``, float32 NHWC ``(1, 64, 64, 256)``
(:107-118). A missing image becomes a 720 x 1280 black one (:116-121).

Usage:
  python -m tmr_tpu_torch.extract_feature [image.jpg] [--output_dir feature]
      [--backbone sam_vit_b|sam_vit_h] [--checkpoint sam_hq_vit_b.pth |
      --artifact exported/sam_vit_b_encoder.pt2] [--device cuda|cpu]

``--artifact`` runs an exported encoder (``python -m tmr_tpu_torch.export_encoder``) in
place of the model: no model is built and no checkpoint is read.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

HARD_THRESHOLD = 0.0130  # extract_feature.py:96
EASY_THRESHOLD = 0.0137  # extract_feature.py:98


def analyze(features: np.ndarray) -> dict:
    """The 4 statistics of extract_feature.py:78-82 (sparsity counts elements <= 0)."""
    f = np.asarray(features, np.float32)
    return {
        "mean": float(f.mean()),
        "std": float(f.std()),
        "max": float(f.max()),
        "sparsity": float((f <= 0).mean()),
    }


def verdict(mean: float) -> str:
    """Rule-based verdict (extract_feature.py:95-100)."""
    if mean < HARD_THRESHOLD:
        return "HARD (low information)"
    if mean > EASY_THRESHOLD:
        return "EASY/NORMAL"
    return "MEDIUM"


def load_or_dummy(image_path: str) -> tuple[np.ndarray, str]:
    """The image as uint8 RGB (``transforms.decode_image``); a 720 x 1280 black image
    when it is absent (extract_feature.py:116-121)."""
    from tmr_tpu_torch.data import transforms

    if os.path.exists(image_path):
        with open(image_path, "rb") as f:
            return transforms.decode_image(f.read()), image_path
    print(f"[1/4] {image_path} not found -> using a synthesized test image")
    return np.zeros((720, 1280, 3), np.uint8), "test_image.jpg"


def run_extraction_and_analyze(image_path: str, output_dir: str = "feature",
                               backbone: str = "sam_vit_b", checkpoint: str | None = None,
                               artifact: str | None = None, model=None,
                               image_size: int = 1024, device=None) -> dict:
    """The whole pipeline; returns the statistics (also printed) with ``save_path``.
    ``artifact`` runs an exported encoder (``utils/export.load_exported``) on ``device``;
    otherwise ``model`` may be given (a ``SamViT``; tests, preloaded weights), or
    ``models.build_sam_encoder(backbone, checkpoint, device=device)`` builds it; on the
    card unless ``device`` says otherwise."""
    from tmr_tpu_torch.data.transforms import sam_longest_side_preprocess
    from tmr_tpu_torch.models import build_sam_encoder, resolve_device
    from tmr_tpu_torch.models.vit import nhwc_features

    image, image_path = load_or_dummy(image_path)
    print(f"[2/4] preprocessing {image_path} ({image.shape[1]}x{image.shape[0]})")
    x = sam_longest_side_preprocess(image, target=image_size)[None]
    if artifact is not None:
        from tmr_tpu_torch.utils.export import load_exported

        dev = resolve_device(device)
        encode = load_exported(artifact, dev)
    else:
        if model is None:
            if not checkpoint:
                print("      no checkpoint: random weights (stats are still well-defined, "
                      "like the reference without weights)")
            model = build_sam_encoder(backbone, checkpoint, device=device)
        dev = next(model.parameters()).device

        def encode(images):
            return nhwc_features(model, images)

    print(f"[3/4] encoding on {dev.type}" + (f" (artifact {artifact})" if artifact else ""))
    with torch.inference_mode():
        feats = encode(torch.from_numpy(x).to(dev)).cpu().numpy()
    stats = analyze(feats)

    print("=" * 60)
    print(f" FEATURE ANALYSIS: {os.path.basename(image_path)}")
    print("=" * 60)
    print(f" 1. AVG ACTIVATION : {stats['mean']:.6f}")
    print(f" 2. STD            : {stats['std']:.6f}")
    print(f" 3. MAX CONFIDENCE : {stats['max']:.6f}")
    print(f" 4. SPARSITY       : {stats['sparsity'] * 100:.2f}%")
    print("-" * 60)
    print(f" => VERDICT: {verdict(stats['mean'])}")
    print("=" * 60)

    os.makedirs(output_dir, exist_ok=True)
    base = os.path.basename(image_path).split(".")[0]
    save_path = os.path.join(output_dir, f"{base}_feature.npy")
    np.save(save_path, feats)
    print(f"[4/4] saved features to {save_path}")
    stats["save_path"] = save_path
    return stats


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("image", nargs="?", default="demo/1.jpg")
    p.add_argument("--output_dir", default="feature")
    p.add_argument("--backbone", default="sam_vit_b",
                   help="sam_vit_b | sam_vit_h | sam (alias for vit_h)")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--artifact", default=None,
                   help="exported encoder (.pt2, python -m tmr_tpu_torch.export_encoder) "
                        "in place of the model")
    p.add_argument("--image_size", default=1024, type=int)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a GPU) or 'cpu'")
    args = p.parse_args(argv)
    return run_extraction_and_analyze(args.image, args.output_dir, args.backbone,
                                      args.checkpoint, args.artifact,
                                      image_size=args.image_size, device=args.device)


if __name__ == "__main__":
    main()
