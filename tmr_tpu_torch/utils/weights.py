"""Weights for the port: the bridge from the JAX param tree, and a seeded random init.

:func:`params_from_jax` is the inverse of ``tmr_tpu/utils/convert.py``
(``convert_sam_vit``, ``convert_matching_net``): it turns the flax param tree of
``tmr_tpu.inference.Predictor.init_params()``, given as numpy arrays, into this
package's ``state_dict``. The port's modules carry the flax names, so the mapping is
mechanical: conv kernels HWIO -> OIHW, dense kernels (in, out) -> (out, in), the fused
``qkv`` stays one linear, flax LayerNorm ``scale`` -> ``weight``, ``blocks_<i>`` ->
``blocks.<i>``; everything else is copied (``pos_embed`` keeps its (1, g, g, C) layout).
"""

from __future__ import annotations

import math
import re
from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn as nn

from tmr_tpu_torch.models.common import Conv2d, LayerNorm2d, Linear

_HEAD_PREFIXES = ("decoder_", "objectness_head_", "ltrbs_head_")


def params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Flax param tree (nested dicts of arrays) -> the port's ``state_dict``."""
    sd: Dict[str, torch.Tensor] = {}

    def walk(node: Mapping, path: list) -> None:
        for name, val in node.items():
            if isinstance(val, Mapping):
                walk(val, path + [re.sub(r"^blocks_(\d+)$", r"blocks.\1", name)])
                continue
            arr = np.asarray(val, dtype=np.float32)
            leaf = name
            if name == "kernel":
                leaf = "weight"
                arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
            elif name == "scale" and path and path[-1].startswith("norm"):
                leaf = "weight"
            sd[".".join(path + [leaf])] = torch.from_numpy(np.array(arr, order="C"))

    walk(tree, [])
    return sd


@torch.no_grad()
def init_params(model: nn.Module, seed: int) -> None:
    """Seeded random weights, drawn on the model's device with a ``torch.Generator``.

    Linear/conv kernels: lecun-normal (std 1/sqrt(fan_in), cut at 2 std), the flax
    default; decoder and head convs: N(0, 0.01); biases 0; norms 1/0; matcher scale 1.
    The rel-pos tables and the position embedding (zero at flax init) get N(0, 0.02)
    so that the bias path of the attention kernels does real work."""
    device = next(model.parameters()).device
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def randn(t: torch.Tensor) -> torch.Tensor:
        return torch.randn(t.shape, generator=gen, device=device, dtype=t.dtype)

    for mod_name, mod in model.named_modules():
        if isinstance(mod, (Linear, Conv2d)):
            if mod_name.startswith(_HEAD_PREFIXES):
                mod.weight.copy_(randn(mod.weight) * 0.01)
            else:
                fan_in = mod.weight[0].numel()
                mod.weight.copy_(randn(mod.weight).clamp_(-2.0, 2.0)
                                 * (1.0 / math.sqrt(fan_in) / 0.87962566))
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, (nn.LayerNorm, LayerNorm2d)):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
    for name, p in model.named_parameters():
        if name.endswith(("rel_pos_h", "rel_pos_w", "pos_embed")):
            p.copy_(randn(p) * 0.02)
        elif name.endswith("matcher.scale"):
            p.fill_(1.0)
