"""The ResNet-50 backbone family (counterpart of ``tmr_tpu/models/resnet.py``; reference
models/backbone/resnet.py).

Seven variants (:data:`RESNET_VARIANTS`): the full ``resnet50`` (2048 channels) and its
truncations after layer1/2/3 (256/512/1024 channels), each also as ``_FRZ``, whose whole
backbone the optimizer leaves alone (``train/state.frozen_backbone``). Module names are
torchvision's (``conv1``, ``bn1``, ``layer{s}.{b}.conv{1,2,3}`` / ``bn{1,2,3}``,
``downsample.0/1``), so a torchvision or reference state dict loads after a prefix strip
(``utils/convert.resnet50_state_dict``).

The network computes in f32 whatever ``compute_dtype`` says: the JAX ResNet's convs take
no dtype (only ``input_proj`` and the heads run in the compute dtype). On the card the
convolutions are cuDNN's, under whatever TF32 setting the caller has; the module sets
nothing global.

``FrozenBatchNorm`` is torchvision's FrozenBatchNorm2d: ``x * scale + (bias - mean *
scale)`` with ``scale = weight / sqrt(var + eps)``. Its running statistics are
parameters, as in the JAX package, so that their gradients enter the train step's global
norm; ``train/state.param_labels`` puts them in the ``"frozen"`` group, which never moves.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from tmr_tpu_torch.models.common import Conv2d


class FrozenBatchNorm(nn.Module):
    """Batch norm with fixed statistics over the channel axis of an NCHW map."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.running_mean = nn.Parameter(torch.zeros(channels))
        self.running_var = nn.Parameter(torch.ones(channels))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = self.weight / torch.sqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * scale
        return x * scale[:, None, None] + shift[:, None, None]


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride, dilation) -> 1x1 x4, each followed by a frozen batch norm, plus
    the identity or a strided 1x1 projection of it."""

    expansion = 4

    def __init__(self, in_ch: int, planes: int, stride: int = 1, dilation: int = 1,
                 downsample: bool = False):
        super().__init__()
        out_ch = planes * self.expansion
        self.conv1 = Conv2d(in_ch, planes, 1, bias=False)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = Conv2d(planes, planes, 3, stride=stride, padding=dilation,
                            dilation=dilation, bias=False)
        self.bn2 = FrozenBatchNorm(planes)
        self.conv3 = Conv2d(planes, out_ch, 1, bias=False)
        self.bn3 = FrozenBatchNorm(out_ch)
        self.downsample = (nn.Sequential(Conv2d(in_ch, out_ch, 1, stride=stride, bias=False),
                                         FrozenBatchNorm(out_ch))
                           if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class ResNet50(nn.Module):
    """Truncatable ResNet-50: (B, S, S, 3) NHWC image -> (B, num_channels, S / stride,
    S / stride) f32. ``out_layer`` in 1..4; ``dilation`` (the reference's DC5 flag) trades
    layer4's stride for dilation 2 in its later blocks: its first block keeps dilation 1,
    torchvision's ``previous_dilation``."""

    def __init__(self, out_layer: int = 4, dilation: bool = True,
                 layers: Sequence[int] = (3, 4, 6, 3)):
        super().__init__()
        self.out_layer = out_layer
        self.dilation = dilation
        self.layers = tuple(layers)
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm(64)
        # (planes, stride, first block's dilation, later blocks' dilation)
        stages = [(64, 1, 1, 1), (128, 2, 1, 1), (256, 2, 1, 1),
                  (512, 1 if dilation else 2, 1, 2 if dilation else 1)]
        in_ch = 64
        for s, (planes, stride, dil0, dil) in enumerate(stages[:out_layer], start=1):
            blocks = []
            for b in range(self.layers[s - 1]):
                blocks.append(Bottleneck(in_ch, planes, stride if b == 0 else 1,
                                         dil0 if b == 0 else dil, downsample=b == 0))
                in_ch = planes * Bottleneck.expansion
            setattr(self, f"layer{s}", nn.Sequential(*blocks))

    @property
    def num_channels(self) -> int:
        return {1: 256, 2: 512, 3: 1024, 4: 2048}[self.out_layer]

    @property
    def feature_stride(self) -> int:
        """Input-to-feature downsampling: 4 after the stem, x2 a later stage, and 16 for
        layer4 under DC5."""
        if self.out_layer == 4 and self.dilation:
            return 16
        return {1: 4, 2: 8, 3: 16, 4: 32}[self.out_layer]

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(image.permute(0, 3, 1, 2).float())))
        x = F.max_pool2d(x, 3, stride=2, padding=1)  # pads with -inf
        for s in range(1, self.out_layer + 1):
            x = getattr(self, f"layer{s}")(x)
        return x


#: name -> the variant's ``ResNet50`` arguments (reference resnet.py:11-140; the ``_FRZ``
#: names freeze the whole backbone, ``train/state.frozen_backbone``)
RESNET_VARIANTS = {
    "resnet50": dict(out_layer=4),
    "resnet50_layer1": dict(out_layer=1),
    "resnet50_layer2": dict(out_layer=2),
    "resnet50_layer3": dict(out_layer=3),
    "resnet50_layer1_FRZ": dict(out_layer=1),
    "resnet50_layer2_FRZ": dict(out_layer=2),
    "resnet50_layer3_FRZ": dict(out_layer=3),
}


def build_resnet(name: str, dilation: bool = True) -> ResNet50:
    return ResNet50(dilation=dilation, **RESNET_VARIANTS[name])
