"""The reference's PyTorch checkpoints, read straight into the port's ``state_dict``
(counterpart of ``tmr_tpu/utils/convert.py``, with no flax tree in between).

Layouts:

- SAM encoder checkpoints (``sam_hq_vit_{b,h}.pth``, ``sam_vit_h_4b8939.pth``): keys
  ``image_encoder.*`` (reference models/backbone/sam/sam.py:63-65) ->
  :func:`sam_vit_state_dict`, the ``SamViT`` module's keys;
- Lightning training checkpoints (``best_model*.ckpt``): ``state_dict`` -> ``model.*``
  over matching_net (demo.py:154-155) -> :func:`matching_net_state_dict`, the
  ``MatchingNet``'s keys.

The port's modules keep torch's layouts (conv kernels OIHW, linear weights (out, in)),
so every tensor is copied as it is, in f32; only the keys change. The result equals
``params_from_jax(tmr_tpu.utils.convert.convert_matching_net(sd))`` key for key and bit
for bit. torchvision ``resnet50`` state dicts (the ResNet backbones, ROADMAP A3) and the
SAM refiner's ``prompt_encoder.*`` / ``mask_decoder.*`` (ROADMAP A6) wait for their
modules and raise.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import torch

_SAM_RENAMES = (("patch_embed.proj.", "patch_embed."), ("neck.0.", "neck_0."),
                ("neck.1.", "neck_1."), ("neck.2.", "neck_2."), ("neck.3.", "neck_3."))
#: per-block keys the SAM encoder carries, under the same names in the port
_SAM_BLOCK_KEYS = ("norm1.weight", "norm1.bias", "norm2.weight", "norm2.bias",
                   "attn.qkv.weight", "attn.qkv.bias", "attn.proj.weight", "attn.proj.bias",
                   "attn.rel_pos_h", "attn.rel_pos_w", "mlp.lin1.weight", "mlp.lin1.bias",
                   "mlp.lin2.weight", "mlp.lin2.bias")
_SAM_TOP_KEYS = ("patch_embed.proj.weight", "patch_embed.proj.bias", "pos_embed",
                 "neck.0.weight", "neck.1.weight", "neck.1.bias", "neck.2.weight",
                 "neck.3.weight", "neck.3.bias")


def _f32(t) -> torch.Tensor:
    return torch.as_tensor(t).detach().to("cpu", torch.float32).contiguous()


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A .pth/.ckpt as a flat {key: tensor} dict (a Lightning checkpoint's
    ``state_dict``), on the CPU."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {k: v for k, v in obj.items() if torch.is_tensor(v)}


def sam_vit_state_dict(sd: Mapping[str, torch.Tensor],
                       prefix: str = "image_encoder.") -> Dict[str, torch.Tensor]:
    """The SAM encoder's keys under ``prefix`` -> the port's ``SamViT`` state_dict."""
    sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    depth = 1 + max(int(m.group(1)) for k in sd if (m := re.match(r"blocks\.(\d+)\.", k)))
    out = {}
    for key in _SAM_TOP_KEYS:
        mine = key
        for old, new in _SAM_RENAMES:
            if key.startswith(old):
                mine = new + key[len(old):]
        out[mine] = _f32(sd[key])
    for i in range(depth):
        for key in _SAM_BLOCK_KEYS:
            out[f"blocks.{i}.{key}"] = _f32(sd[f"blocks.{i}.{key}"])
    return out


def matching_net_state_dict(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A Lightning ``model.*`` state_dict -> the port's ``MatchingNet`` state_dict.

    Reference module paths (trainer.py:21 / matching_net.py):
      model.encoder.backbone.backbone.*  -> backbone.*          (SAM ViT)
      model.input_proj.{i}.*             -> input_proj_{i}.*
      model.matcher.scale                -> matcher.scale
      model.decoder_o.layer.{2j}.*       -> decoder_o_0.conv_{j}.*
      model.decoder_b.layer.{2j}.*       -> decoder_b_0.conv_{j}.*
      model.objectness_head.head.0.*     -> objectness_head_0.conv.*
      model.ltrbs_head.head.0.*          -> ltrbs_head_0.conv.*
    """
    sd = {k[len("model."):]: v for k, v in sd.items() if k.startswith("model.")}
    enc = "encoder.backbone.backbone."
    if enc + "patch_embed.proj.weight" not in sd:
        if any(k.startswith(enc + "layer1.") for k in sd):
            raise NotImplementedError(
                "a ResNet matching_net checkpoint: the port has the SAM backbones only "
                "(the ResNet backbones are ROADMAP A3)")
        raise KeyError(f"matching_net checkpoint has no {enc}patch_embed.* keys")
    out = {"backbone." + k: v for k, v in sam_vit_state_dict(sd, prefix=enc).items()}
    i = 0
    while f"input_proj.{i}.weight" in sd:
        out[f"input_proj_{i}.weight"] = _f32(sd[f"input_proj.{i}.weight"])
        out[f"input_proj_{i}.bias"] = _f32(sd[f"input_proj.{i}.bias"])
        i += 1
    if "matcher.scale" in sd:
        out["matcher.scale"] = _f32(sd["matcher.scale"])
    for dec in ("decoder_o", "decoder_b"):
        j = 0
        while f"{dec}.layer.{2 * j}.weight" in sd:
            for leaf in ("weight", "bias"):
                out[f"{dec}_0.conv_{j}.{leaf}"] = _f32(sd[f"{dec}.layer.{2 * j}.{leaf}"])
            j += 1
    for head, mine in (("objectness_head", "objectness_head_0"),
                       ("ltrbs_head", "ltrbs_head_0")):
        if f"{head}.head.0.weight" in sd:
            for leaf in ("weight", "bias"):
                out[f"{mine}.conv.{leaf}"] = _f32(sd[f"{head}.head.0.{leaf}"])
    return out


def lightning_state_dict(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`matching_net_state_dict`: the port's ``MatchingNet``
    state_dict under the reference's Lightning ``model.*`` keys, which
    ``torch.save({"state_dict": ...}, "best_model.ckpt")`` makes into a checkpoint both
    this package and the reference read."""
    out = {}
    for key, v in state_dict.items():
        if key.startswith("backbone."):
            key = key[len("backbone."):]
            for old, new in _SAM_RENAMES:
                if key.startswith(new):
                    key = old + key[len(new):]
            key = "encoder.backbone.backbone." + key
        else:
            key = re.sub(r"^input_proj_(\d+)\.", r"input_proj.\1.", key)
            key = re.sub(r"^(decoder_[ob])_0\.conv_(\d+)\.",
                         lambda m: f"{m.group(1)}.layer.{2 * int(m.group(2))}.", key)
            key = re.sub(r"^(objectness_head|ltrbs_head)_0\.conv\.", r"\1.head.0.", key)
        out["model." + key] = v.detach().cpu()
    return out


def checkpoint_kind(sd: Mapping[str, torch.Tensor]) -> str:
    """The layout of a loaded checkpoint: ``"matching_net"`` or ``"sam_vit"``; the
    layouts whose modules are not ported raise, naming their ROADMAP item."""
    if any(k.startswith("model.") for k in sd):
        return "matching_net"
    if any(k.startswith("image_encoder.") for k in sd):
        return "sam_vit"
    if any(k.startswith("layer1.") for k in sd):
        raise NotImplementedError("a torchvision resnet50 state_dict: the ResNet "
                                  "backbones are not ported yet (ROADMAP A3)")
    if any(k.startswith(("prompt_encoder.", "mask_decoder.")) for k in sd):
        raise NotImplementedError("a SAM refiner checkpoint: the refiner is not ported "
                                  "yet (ROADMAP A6)")
    raise KeyError(f"cannot tell the checkpoint's layout from keys like {sorted(sd)[:3]}")


def load_matching_net(path: str) -> Dict[str, torch.Tensor]:
    """A Lightning ``best_model*.ckpt`` straight into the port's ``MatchingNet``
    state_dict."""
    sd = load_torch_state_dict(path)
    kind = checkpoint_kind(sd)
    if kind != "matching_net":
        raise ValueError(f"{path} holds a {kind} checkpoint, not a Lightning "
                         "matching_net one")
    return matching_net_state_dict(sd)
