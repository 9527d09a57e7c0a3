"""The TMR detector (counterpart of ``tmr_tpu/models/matching_net.py``).

encoder (a SAM ViT or a ResNet-50) -> [2x bilinear upsample] -> 1x1 input_proj to
emb_dim -> template matcher (RoIAlign or prototype template, f32, learnable scalar
scale) -> [fusion concat] -> decoder conv stacks -> objectness (1 ch) + ltrb (4 ch)
heads. NCHW inside; the outputs keep the JAX package's layouts: objectness (B, H, W),
regressions (B, H, W, 4), both f32.

The tail's dispatch mirrors ``tmr_tpu/models/matching_net.py:156-226`` without gates:
``quant="off"`` runs the cuDNN ``Decoder``/heads; ``quant="int8"`` runs
``ops/fused_heads.fused_decoder_heads`` on the same parameters (fake quantization), and
after :meth:`MatchingNet.store_int8` on the stored int8 kernels (``quant="stored"``,
with ``quant_kernel`` picking the matmul arm). The matcher takes its int8 arm from the
same two fields.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from tmr_tpu_torch.models.common import Conv2d
from tmr_tpu_torch.models.heads import BboxesHead, Decoder, Int8Conv2d, ObjectnessHead
from tmr_tpu_torch.ops.fused_heads import fused_decoder_heads
from tmr_tpu_torch.ops.xcorr import cross_correlation, extract_prototype, extract_template


class TemplateMatcher(nn.Module):
    """The exemplar's template, depthwise correlation, learnable scale. ``template_type``
    ``"roi_align"`` RoIAligns exemplar 0 into the capacity bucket; ``"prototype"`` means
    the feature over its integer crop into a 1 x 1 template, which correlates at T = 1
    whatever the bucket (``tmr_tpu/models/matching_net.py:51-57``)."""

    def __init__(self, template_type: str = "roi_align", squeeze: bool = False,
                 quant: str = "off", quant_kernel: str = "dequant"):
        super().__init__()
        if template_type not in ("roi_align", "prototype"):
            raise ValueError(f"unknown template_type {template_type!r}")
        self.scale = nn.Parameter(torch.ones(1))
        self.template_type = template_type
        self.squeeze = squeeze
        self.quant = quant
        self.quant_kernel = quant_kernel

    def forward(self, feature: torch.Tensor, exemplars: torch.Tensor,
                capacity: int) -> torch.Tensor:
        """feature (B, C, H, W) f32; exemplars (B, 4) normalized xyxy."""
        if self.template_type == "prototype":
            templates, thw = extract_prototype(feature, exemplars, 1)
        else:
            templates, thw = extract_template(feature, exemplars, capacity)
        out = cross_correlation(feature, templates, thw, squeeze=self.squeeze,
                                quant=self.quant, kernel=self.quant_kernel)
        return out * self.scale


class MatchingNet(nn.Module):
    def __init__(self, backbone: nn.Module, emb_dim: int = 512, fusion: bool = False,
                 squeeze: bool = False, box_reg: bool = True, no_matcher: bool = False,
                 feature_upsample: bool = False, template_type: str = "roi_align",
                 decoder_num_layer: int = 1, decoder_kernel_size: int = 3,
                 dtype: torch.dtype = torch.float32, quant: str = "off",
                 quant_kernel: str = "dequant"):
        super().__init__()
        self.backbone = backbone
        self.compute_dtype = dtype
        self.quant = quant
        self.quant_kernel = quant_kernel
        self.stored = False
        self.fusion = fusion
        self.box_reg = box_reg
        self.no_matcher = no_matcher
        self.feature_upsample = feature_upsample
        # the encoder's width: a SamViT's out_chans, a ResNet's num_channels (the JAX
        # BackboneEncoder's rule)
        width = getattr(backbone, "out_chans", None) or getattr(backbone, "num_channels",
                                                                 None)
        if width is None:
            raise AttributeError(f"{type(backbone).__name__} exposes neither out_chans "
                                 "nor num_channels")
        self.input_proj_0 = Conv2d(width, emb_dim, 1, dtype=dtype)
        if not no_matcher:
            self.matcher = TemplateMatcher(template_type, squeeze=squeeze, quant=quant,
                                           quant_kernel=quant_kernel)
        tm_ch = 1 if squeeze and not no_matcher else emb_dim
        c_cat = emb_dim + tm_ch if fusion else tm_ch
        if box_reg:
            self.decoder_b_0 = Decoder(c_cat, decoder_num_layer, decoder_kernel_size,
                                       dtype)
            self.ltrbs_head_0 = BboxesHead(c_cat, dtype)
        self.decoder_o_0 = Decoder(c_cat, decoder_num_layer, decoder_kernel_size, dtype)
        self.objectness_head_0 = ObjectnessHead(c_cat, dtype)

    def _tail_convs(self):
        """The decoder and head convs in the fused tail's order: (stack o, stack b,
        head o, head b), as (module's parent, attribute name) pairs."""
        stacks = [[(d, f"conv_{i}") for i in range(d.num_layers)]
                  for d in (self.decoder_o_0, self.decoder_b_0)]
        return (*stacks, [(self.objectness_head_0, "conv")], [(self.ltrbs_head_0, "conv")])

    @torch.no_grad()
    def store_int8(self) -> dict:
        """Replace every decoder and head kernel by its int8 storage (Int8Conv2d), once,
        after the weights are set; returns the byte counts of
        ``QuantizedParams.stamp()`` (int8 bytes and the f32 bytes they replace)."""
        if self.quant == "off":
            raise ValueError("store_int8 needs quant='int8'")
        if self.stored:
            raise RuntimeError("the tail's kernels are already stored as int8")
        n = 0
        for group in self._tail_convs():
            for parent, name in group:
                stored = Int8Conv2d(getattr(parent, name))
                setattr(parent, name, stored)
                n += stored.qweight.numel()
        self.stored = True
        return {"mode": "int8", "storage": "int8",
                "quantized_leaves": sum(len(g) for g in self._tail_convs()),
                "weight_bytes": n, "f32_weight_bytes": 4 * n}

    def _tail_params(self):
        def entry(parent, name):
            conv = getattr(parent, name)
            if isinstance(conv, Int8Conv2d):
                return conv.qweight, conv.bias, conv.scale
            return conv.weight, conv.bias

        dec_o, dec_b, (head_o,), (head_b,) = (
            [entry(*pn) for pn in group] for group in self._tail_convs())
        return dec_o, dec_b, head_o, head_b

    def backbone_features(self, image: torch.Tensor) -> torch.Tensor:
        """The encoder alone: image (B, S, S, 3) -> its pre-upsample output (B, h, w, C)
        NHWC, the layout the JAX package's backbone program returns and a feature cache
        keeps."""
        return self.backbone(image).permute(0, 2, 3, 1).contiguous()

    def _encode(self, image: Optional[torch.Tensor],
                features: Optional[torch.Tensor]) -> torch.Tensor:
        """The encoder's output (B, C, h, w), or ``features`` (B, h, w, C) in its place;
        one layout either way (a contiguous copy, made in every case: the SAM encoder's
        output is channels-last on the card, and a ``torch.export`` trace would drop a
        ``contiguous()`` that it sees on a contiguous fake tensor), so the split programs
        and an exported program run the fused one's ops on the same layout, bit for
        bit."""
        f = self.backbone(image) if features is None else features.permute(0, 3, 1, 2)
        return f.clone(memory_format=torch.contiguous_format)

    def match(self, image: Optional[torch.Tensor], exemplars: torch.Tensor,
              capacity: int, features: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Encoder, projection, matcher and fusion: ``f_cat`` (B, C, H, W), the tail's
        input. With ``features`` (B, h, w, C), the output of :meth:`backbone_features`,
        the encoder is skipped and ``image`` is not read."""
        return self._match(self._encode(image, features), exemplars, capacity)

    def _match(self, f: torch.Tensor, exemplars: torch.Tensor,
               capacity: int) -> torch.Tensor:
        if self.feature_upsample:
            f = F.interpolate(f, scale_factor=2, mode="bilinear", align_corners=False)
        fp = self.input_proj_0(f)
        if self.no_matcher:
            f_tm = fp
        else:
            f_tm = self.matcher(fp.float(), exemplars[:, 0, :], capacity).to(fp.dtype)
        return torch.cat([fp, f_tm], dim=1) if self.fusion else f_tm

    def heads(self, f_cat: torch.Tensor) -> dict:
        """The decoder tail on ``f_cat``: objectness (B, H, W) and regressions
        (B, H, W, 4) (None without box_reg), f32."""
        if self.quant != "off":
            o, r = fused_decoder_heads(
                f_cat.permute(0, 2, 3, 1), *self._tail_params(), dtype=self.compute_dtype,
                quant="stored" if self.stored else True, kernel_arm=self.quant_kernel)
            return {"objectness": o[..., 0], "regressions": r}
        out = {"regressions": None}
        if self.box_reg:
            b = self.ltrbs_head_0(self.decoder_b_0(f_cat))
            out["regressions"] = b.float().permute(0, 2, 3, 1)
        o = self.objectness_head_0(self.decoder_o_0(f_cat))
        out["objectness"] = o[:, 0].float()
        return out

    def forward(self, image: Optional[torch.Tensor], exemplars: torch.Tensor,
                capacity: int, features: Optional[torch.Tensor] = None) -> dict:
        """image (B, S, S, 3) NHWC; exemplars (B, K, 4) (the matcher uses exemplar 0);
        ``capacity`` is the odd template bucket; ``features`` as in :meth:`match`. The
        heads' maps, and ``backbone_feature`` (B, h, w, C): the encoder's output before
        the upsample, NHWC (a view), which the SAM refiner reads
        (``tmr_tpu/models/matching_net.py:111,129``)."""
        f = self._encode(image, features)
        out = self.heads(self._match(f, exemplars, capacity))
        out["backbone_feature"] = f.permute(0, 2, 3, 1)
        return out


def select_capacity_bucket(exemplar, feat_h: int, feat_w: int, buckets) -> int:
    """Host-side bucket choice: the smallest bucket holding the odd-ified exemplar
    span. exemplar: (4,) normalized xyxy; buckets: ascending odd ints."""
    x1 = min(1.0, max(0.0, float(exemplar[0]))) * feat_w
    y1 = min(1.0, max(0.0, float(exemplar[1]))) * feat_h
    x2 = min(1.0, max(0.0, float(exemplar[2]))) * feat_w
    y2 = min(1.0, max(0.0, float(exemplar[3]))) * feat_h
    wt = math.ceil(x2) - math.floor(x1)
    ht = math.ceil(y2) - math.floor(y1)
    wt -= wt % 2 == 0
    ht -= ht % 2 == 0
    need = max(1, ht, wt)
    for b in buckets:
        if b >= need:
            return b
    raise ValueError(
        f"exemplar needs a {need}-cell template but the largest bucket is "
        f"{buckets[-1]}; extend cfg.template_buckets"
    )
