"""Model registry (counterpart of ``tmr_tpu/models/__init__.py``)."""

from __future__ import annotations

import torch

from tmr_tpu_torch.models.matching_net import MatchingNet, select_capacity_bucket  # noqa: F401
from tmr_tpu_torch.models.vit import SamViT, build_sam_vit  # noqa: F401


def compute_dtype(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU; a CUDA device raises when there is none."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU; pass device='cpu' to run "
            "the plain CPU versions explicitly")
    return device


def build_backbone(cfg, device=None) -> SamViT:
    """'sam'/'sam_vit_h' -> ViT-H (32 blocks, 16 heads of 80), 'sam_vit_b' -> ViT-B (12
    blocks, 12 heads of 64) (the port's slice has the SAM backbones only), built on
    ``device`` (:func:`resolve_device`)."""
    kind = {"sam": "vit_h", "sam_vit_h": "vit_h", "sam_vit_b": "vit_b"}.get(cfg.backbone)
    if kind is None:
        raise KeyError(f"backbone {cfg.backbone!r} is not ported yet")
    with resolve_device(device):
        return build_sam_vit(kind, dtype=compute_dtype(cfg))


def build_model(cfg, backbone=None, device=None) -> MatchingNet:
    """The detector for ``cfg`` on ``device`` (:func:`resolve_device`); ``backbone``
    overrides the registry's encoder (the tests pass a narrow SamViT)."""
    if cfg.modeltype != "matching_net":
        raise KeyError(f"unknown modeltype {cfg.modeltype!r}")
    device = resolve_device(device)
    if backbone is None:
        backbone = build_backbone(cfg, device)
    with device:
        model = MatchingNet(
            backbone=backbone,
            emb_dim=cfg.emb_dim,
            fusion=cfg.fusion,
            squeeze=cfg.squeeze,
            box_reg=cfg.box_reg,
            no_matcher=cfg.no_matcher,
            feature_upsample=cfg.feature_upsample,
            template_type=cfg.template_type,
            decoder_num_layer=cfg.decoder_num_layer,
            decoder_kernel_size=cfg.decoder_kernel_size,
            dtype=compute_dtype(cfg),
            quant=cfg.quant,
            quant_kernel=cfg.quant_kernel,
        )
    return model.to(device)
