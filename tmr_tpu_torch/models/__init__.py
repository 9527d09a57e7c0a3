"""Model registry (counterpart of ``tmr_tpu/models/__init__.py``)."""

from __future__ import annotations

import torch

from tmr_tpu_torch.models.matching_net import MatchingNet, select_capacity_bucket  # noqa: F401
from tmr_tpu_torch.models.resnet import RESNET_VARIANTS, ResNet50, build_resnet  # noqa: F401
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


def build_backbone(cfg, device=None) -> torch.nn.Module:
    """'sam'/'sam_vit_h' -> ViT-H (32 blocks, 16 heads of 80), 'sam_vit_b' -> ViT-B (12
    blocks, 12 heads of 64), its blocks recomputed on the backward pass under
    ``cfg.remat_backbone``; the ``RESNET_VARIANTS`` names -> the ResNet-50 family (f32,
    ``cfg.dilation``: DC5), which has no block rematerialization (``ValueError`` with
    ``remat_backbone``, as in the JAX package). Built on ``device``
    (:func:`resolve_device`)."""
    name = cfg.backbone
    if name in RESNET_VARIANTS:
        if cfg.remat_backbone:
            raise ValueError("--remat_backbone applies to SAM-ViT backbones only; the "
                             "resnet variants have no block rematerialization")
        with resolve_device(device):
            return build_resnet(name, dilation=cfg.dilation)
    kind = {"sam": "vit_h", "sam_vit_h": "vit_h", "sam_vit_b": "vit_b"}.get(name)
    if kind is None:
        raise KeyError(f"unknown backbone {name!r}")
    with resolve_device(device):
        return build_sam_vit(kind, dtype=compute_dtype(cfg), remat=cfg.remat_backbone)


#: the SAM encoder names the entry points take (reference models/backbone/__init__.py:22:
#: 'sam' is ViT-H)
SAM_ALIASES = {"sam": "vit_h", "sam_vit_h": "vit_h", "sam_vit_b": "vit_b",
               "vit_h": "vit_h", "vit_b": "vit_b"}


def build_sam_encoder(model_type: str = "vit_b", checkpoint: str = None,
                      dtype: torch.dtype = torch.bfloat16, device=None) -> SamViT:
    """The standalone SAM encoder of the map phase and ``extract_feature`` (counterpart
    of ``tmr_tpu.models.build_sam_encoder``), in eval mode on ``device``
    (:func:`resolve_device`). With ``checkpoint`` the weights come from a SAM(-HQ)
    ``.pth`` through ``utils.convert.sam_vit_state_dict`` (under ``image_encoder.`` when
    any key has that prefix, else a bare encoder export); otherwise they are seeded
    (``utils.weights.init_params`` with seed 0)."""
    from tmr_tpu_torch.utils.convert import load_torch_state_dict, sam_vit_state_dict
    from tmr_tpu_torch.utils.weights import init_params

    kind = SAM_ALIASES.get(model_type)
    if kind is None:
        raise KeyError(f"unknown SAM encoder {model_type!r} (one of {sorted(SAM_ALIASES)})")
    device = resolve_device(device)
    with device:
        model = build_sam_vit(kind, dtype=dtype)
    if checkpoint:
        sd = load_torch_state_dict(checkpoint)
        prefix = "image_encoder." if any(k.startswith("image_encoder.") for k in sd) else ""
        model.load_state_dict(sam_vit_state_dict(sd, prefix))
    else:
        init_params(model, 0)
    return model.eval()


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
