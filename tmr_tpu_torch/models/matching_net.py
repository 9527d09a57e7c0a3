"""The TMR detector (counterpart of ``tmr_tpu/models/matching_net.py``).

encoder -> [2x bilinear upsample] -> 1x1 input_proj to emb_dim -> template matcher
(f32, learnable scalar scale) -> [fusion concat] -> decoder conv stacks ->
objectness (1 ch) + ltrb (4 ch) heads. NCHW inside; the outputs keep the JAX
package's layouts: objectness (B, H, W), regressions (B, H, W, 4), both f32.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from tmr_tpu_torch.models.common import Conv2d
from tmr_tpu_torch.models.heads import BboxesHead, Decoder, ObjectnessHead
from tmr_tpu_torch.ops.xcorr import cross_correlation, extract_template


class TemplateMatcher(nn.Module):
    """RoIAlign template of exemplar 0, depthwise correlation, learnable scale."""

    def __init__(self, squeeze: bool = False):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(1))
        self.squeeze = squeeze

    def forward(self, feature: torch.Tensor, exemplars: torch.Tensor,
                capacity: int) -> torch.Tensor:
        """feature (B, C, H, W) f32; exemplars (B, 4) normalized xyxy."""
        templates, thw = extract_template(feature, exemplars, capacity)
        out = cross_correlation(feature, templates, thw, squeeze=self.squeeze)
        return out * self.scale


class MatchingNet(nn.Module):
    def __init__(self, backbone: nn.Module, emb_dim: int = 512, fusion: bool = False,
                 squeeze: bool = False, box_reg: bool = True, no_matcher: bool = False,
                 feature_upsample: bool = False, template_type: str = "roi_align",
                 decoder_num_layer: int = 1, decoder_kernel_size: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if template_type != "roi_align":
            raise NotImplementedError(
                f"template_type {template_type!r}: the port has roi_align templates only")
        self.backbone = backbone
        self.fusion = fusion
        self.box_reg = box_reg
        self.no_matcher = no_matcher
        self.feature_upsample = feature_upsample
        self.input_proj_0 = Conv2d(backbone.out_chans, emb_dim, 1, dtype=dtype)
        if not no_matcher:
            self.matcher = TemplateMatcher(squeeze=squeeze)
        tm_ch = 1 if squeeze and not no_matcher else emb_dim
        c_cat = emb_dim + tm_ch if fusion else tm_ch
        if box_reg:
            self.decoder_b_0 = Decoder(c_cat, decoder_num_layer, decoder_kernel_size,
                                       dtype)
            self.ltrbs_head_0 = BboxesHead(c_cat, dtype)
        self.decoder_o_0 = Decoder(c_cat, decoder_num_layer, decoder_kernel_size, dtype)
        self.objectness_head_0 = ObjectnessHead(c_cat, dtype)

    def forward(self, image: torch.Tensor, exemplars: torch.Tensor,
                capacity: int) -> dict:
        """image (B, S, S, 3) NHWC; exemplars (B, K, 4) (the matcher uses exemplar 0);
        ``capacity`` is the odd template bucket."""
        f = self.backbone(image)
        if self.feature_upsample:
            f = F.interpolate(f, scale_factor=2, mode="bilinear", align_corners=False)
        fp = self.input_proj_0(f)
        if self.no_matcher:
            f_tm = fp
        else:
            f_tm = self.matcher(fp.float(), exemplars[:, 0, :], capacity).to(fp.dtype)
        f_cat = torch.cat([fp, f_tm], dim=1) if self.fusion else f_tm
        out = {"regressions": None}
        if self.box_reg:
            b = self.ltrbs_head_0(self.decoder_b_0(f_cat))
            out["regressions"] = b.float().permute(0, 2, 3, 1)
        o = self.objectness_head_0(self.decoder_o_0(f_cat))
        out["objectness"] = o[:, 0].float()
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
