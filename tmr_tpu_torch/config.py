"""Typed configuration for the PyTorch port.

Counterpart of ``tmr_tpu/config.py`` (``Config`` and ``preset``): the same
fields with the same defaults, so a preset names the same model in both
packages. The JAX package's ``TMR_*`` environment-knob registry has no
counterpart here: the port selects nothing through the environment.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass
class Config:
    seed: int = 42

    # logging
    project_name: str = "Few-Shot Pattern Detection"
    logpath: str = "./outputs/default"
    nowandb: bool = True
    AP_term: int = 5
    best_model_count: bool = False

    # dataset
    datapath: str = "/home/"
    dataset: str = "RPINE"
    batch_size: int = 1
    eval_batch_size: int = 1
    num_workers: int = 8
    num_exemplars: int = 1
    image_size: int = 1024

    # training
    resume: bool = False
    max_epochs: int = 30
    multi_gpu: bool = False

    # optimizer
    weight_decay: float = 1e-4
    clip_max_norm: float = 0.1
    lr_drop: bool = False
    lr: float = 1e-4
    lr_backbone: float = 1e-5
    grad_accum_steps: int = 1

    # eval / viz
    eval: bool = False
    visualize: bool = False

    # model
    modeltype: str = "matching_net"
    emb_dim: int = 512
    no_matcher: bool = False
    squeeze: bool = False
    fusion: bool = False
    positive_threshold: float = 0.7
    negative_threshold: float = 0.7
    NMS_cls_threshold: float = 0.1
    NMS_iou_threshold: float = 0.15
    refine_box: bool = False
    refiner_checkpoint: Optional[str] = None
    ablation_no_box_regression: bool = False
    template_type: str = "roi_align"
    feature_upsample: bool = False
    eval_multi_scale: bool = False
    regression_scaling_imgsize: bool = False
    regression_scaling_WH_only: bool = False
    focal_loss: bool = False

    # backbone
    backbone: str = "resnet50"
    encoder: str = "original"
    dilation: bool = True

    # heads
    decoder_num_layer: int = 1
    decoder_kernel_size: int = 3

    # static template-kernel capacities (odd); > 65 runs the FFT path
    template_buckets: Tuple[int, ...] = (9, 17, 33, 65, 127, 191)
    # fixed detection capacity per image
    max_detections: int = 2000
    # padding capacity for GT boxes per image (the eval loader's collate)
    max_gt_boxes: int = 800
    # compute dtype for the encoder and heads ("bfloat16" or "float32")
    compute_dtype: str = "bfloat16"

    # int8 quantization of the decoder tail and the matcher (inference only).
    # ``quant`` mirrors TMR_QUANT: "int8" runs the decoder stacks and heads as the
    # fused channel-tiled matmuls (ops/fused_heads.py) on int8-grid weights, and the
    # correlation on an int8-grid template. ``quant_storage`` mirrors
    # TMR_QUANT_STORAGE: "int8" makes the model hold those weights as int8 with f32
    # scales (quantized once, when the weights are set). ``quant_kernel`` mirrors
    # TMR_QUANT_KERNEL: "dequant" widens the int8 operand next to an f32-accumulated
    # product; "int8" quantizes the activation too and contracts on the int8 grid
    # through the hand-written kernels (the JAX package's int8dot and pallas arms,
    # which compute the same function). Combinations the JAX package would refuse
    # and fall back from raise ValueError here.
    quant: str = "off"
    quant_storage: str = "off"
    quant_kernel: str = "dequant"

    # the detections' tail, mirroring TMR_DECODE_TAIL: "host" leaves NMS's survivors in
    # their slots for the host to filter by ``valid``; "device" compacts them to the
    # leading slots with a ``count`` per image (ops/postprocess.compact_detections).
    # The JAX package admits "device" through a self-check and falls back to "host";
    # the port has no gate and no fallback: "device" always compacts.
    decode_tail: str = "host"

    def __post_init__(self):
        for name, legal in (("quant", ("off", "int8")), ("quant_storage", ("off", "int8")),
                            ("quant_kernel", ("dequant", "int8")),
                            ("decode_tail", ("host", "device"))):
            if getattr(self, name) not in legal:
                raise ValueError(f"{name}={getattr(self, name)!r}: expected "
                                 + " | ".join(legal))
        if self.quant_storage != "off" and self.quant != "int8":
            raise ValueError("quant_storage='int8' needs quant='int8' (stored weights "
                             "ride the int8 decoder tail)")
        if self.quant_kernel != "dequant" and self.quant != "int8":
            raise ValueError("quant_kernel='int8' needs quant='int8'")
        if self.quant != "off" and not self.box_reg:
            raise ValueError("quant='int8' needs box_reg: the int8 tail is the "
                             "two-stack fused formulation")

    @property
    def box_reg(self) -> bool:
        return not self.ablation_no_box_regression


def preset(name: str, **overrides) -> Config:
    """Named presets, the same as ``tmr_tpu.config.preset``."""
    base = dict(
        backbone="sam_vit_b",
        emb_dim=512,
        template_type="roi_align",
        feature_upsample=True,
        fusion=True,
        positive_threshold=0.5,
        negative_threshold=0.5,
        lr=1e-4,
        lr_backbone=0.0,
        lr_drop=True,
        max_epochs=200,
        batch_size=4,
    )
    presets = {
        "TMR_FSCD147": dict(dataset="FSCD147", NMS_cls_threshold=0.25,
                            NMS_iou_threshold=0.5),
        "TMR_RPINE": dict(dataset="RPINE", NMS_cls_threshold=0.4,
                          NMS_iou_threshold=0.5),
        "TMR_FSCD_LVIS_Seen": dict(dataset="FSCD_LVIS_Seen",
                                   NMS_cls_threshold=0.1,
                                   NMS_iou_threshold=0.5),
        "TMR_FSCD_LVIS_Unseen": dict(dataset="FSCD_LVIS_Unseen",
                                     NMS_cls_threshold=0.1,
                                     NMS_iou_threshold=0.5),
    }
    if name not in presets:
        raise KeyError(f"unknown preset {name!r}; options: {sorted(presets)}")
    base.update(presets[name])
    base.update(overrides)
    return Config(**base)
