"""The reference's PyTorch checkpoints, read straight into the port's ``state_dict``
(counterpart of ``tmr_tpu/utils/convert.py``, with no flax tree in between).

Layouts:

- SAM encoder checkpoints (``sam_hq_vit_{b,h}.pth``, ``sam_vit_h_4b8939.pth``): keys
  ``image_encoder.*`` (reference models/backbone/sam/sam.py:63-65) ->
  :func:`sam_vit_state_dict`, the ``SamViT`` module's keys;
- Lightning training checkpoints (``best_model*.ckpt``): ``state_dict`` -> ``model.*``
  over matching_net (demo.py:154-155) -> :func:`matching_net_state_dict`, the
  ``MatchingNet``'s keys;
- the SAM prompt encoder and mask decoder (``prompt_encoder.*`` / ``mask_decoder.*``
  of a full ``sam_vit_{b,h}`` checkpoint, which the reference's refiner loads,
  box_refine.py:41-60) -> :func:`sam_refiner_state_dict`, the keys of
  ``refine.SamRefineModule`` (and of ``sam.Sam`` beside its ``image_encoder.*``);
- torchvision ``resnet50`` state dicts (``conv1.*``, ``bn1.*``, ``layer{s}.{b}.*``) and a
  Lightning checkpoint's ResNet encoder -> :func:`resnet50_state_dict`, the
  ``models.resnet.ResNet50`` keys (the same names; ``fc.*`` and ``num_batches_tracked``
  are left out, and a truncated net's missing blocks are skipped).

The port's modules keep torch's layouts (conv kernels OIHW, linear weights (out, in)),
so every tensor is copied as it is, in f32; only the keys change, except that the
prompt encoder's four point embeddings become one (4, C) parameter and a
``ConvTranspose2d`` weight (C_in, C_out, 2, 2) becomes ``UpConv2x``'s (C_out, C_in, 2, 2).
The results equal ``params_from_jax`` of the JAX package's ``convert_matching_net`` /
``convert_sam_refiner`` / ``convert_resnet50`` of the same checkpoint key for key and bit
for bit.
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


def _prefixed(sd: Mapping[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


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
    sd = _prefixed(sd, prefix)
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


#: blocks per stage of ResNet-50 (the JAX ``convert_resnet50`` reads these and skips a
#: truncated checkpoint's missing ones)
_RESNET_LAYERS = (3, 4, 6, 3)
_BN_LEAVES = ("weight", "bias", "running_mean", "running_var")


def resnet50_state_dict(sd: Mapping[str, torch.Tensor],
                        prefix: str = "") -> Dict[str, torch.Tensor]:
    """A torchvision ``resnet50`` state_dict under ``prefix`` -> the port's ``ResNet50``
    state_dict (the JAX ``convert_resnet50``): the stem, then every block of the four
    stages the checkpoint holds."""
    sd = _prefixed(sd, prefix)
    out = {"conv1.weight": _f32(sd["conv1.weight"])}

    def bn(key: str) -> None:
        for leaf in _BN_LEAVES:
            out[f"{key}.{leaf}"] = _f32(sd[f"{key}.{leaf}"])

    bn("bn1")
    for stage, blocks in enumerate(_RESNET_LAYERS, start=1):
        for block in range(blocks):
            t = f"layer{stage}.{block}."
            if t + "conv1.weight" not in sd:
                continue  # truncated checkpoint
            for i in (1, 2, 3):
                out[f"{t}conv{i}.weight"] = _f32(sd[f"{t}conv{i}.weight"])
                bn(f"{t}bn{i}")
            if t + "downsample.0.weight" in sd:
                out[t + "downsample.0.weight"] = _f32(sd[t + "downsample.0.weight"])
                bn(t + "downsample.1")
    return out


def matching_net_state_dict(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A Lightning ``model.*`` state_dict -> the port's ``MatchingNet`` state_dict.

    Reference module paths (trainer.py:21 / matching_net.py):
      model.encoder.backbone.backbone.*  -> backbone.*          (SAM ViT or ResNet-50)
      model.input_proj.{i}.*             -> input_proj_{i}.*
      model.matcher.scale                -> matcher.scale
      model.decoder_o.layer.{2j}.*       -> decoder_o_0.conv_{j}.*
      model.decoder_b.layer.{2j}.*       -> decoder_b_0.conv_{j}.*
      model.objectness_head.head.0.*     -> objectness_head_0.conv.*
      model.ltrbs_head.head.0.*          -> ltrbs_head_0.conv.*
    """
    sd = _prefixed(sd, "model.")
    enc = "encoder.backbone.backbone."
    if enc + "patch_embed.proj.weight" in sd:
        backbone = sam_vit_state_dict(sd, prefix=enc)
    elif enc + "conv1.weight" in sd:
        backbone = resnet50_state_dict(sd, prefix=enc)
    else:
        raise KeyError(f"matching_net checkpoint has neither {enc}patch_embed.* (SAM) nor "
                       f"{enc}conv1.* (ResNet) keys")
    out = {"backbone." + k: v for k, v in backbone.items()}
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


def prompt_encoder_state_dict(sd: Mapping[str, torch.Tensor],
                              prefix: str = "prompt_encoder.") -> Dict[str, torch.Tensor]:
    """A SAM ``prompt_encoder.*`` subtree -> ``models.sam_decoder.PromptEncoder``'s keys
    (the JAX ``convert_prompt_encoder``): the four ``point_embeddings.{i}.weight``
    (1, C) become one (4, C) parameter, ``mask_downscaling.{i}`` ``mask_down_{i}``."""
    sd = _prefixed(sd, prefix)
    out = {"pe_layer.positional_encoding_gaussian_matrix":
           _f32(sd["pe_layer.positional_encoding_gaussian_matrix"]),
           "point_embeddings": torch.cat([_f32(sd[f"point_embeddings.{i}.weight"])
                                          for i in range(4)], dim=0),
           "not_a_point_embed": _f32(sd["not_a_point_embed.weight"]),
           "no_mask_embed": _f32(sd["no_mask_embed.weight"])}
    for i in (0, 1, 3, 4, 6):
        for leaf in ("weight", "bias"):
            out[f"mask_down_{i}.{leaf}"] = _f32(sd[f"mask_downscaling.{i}.{leaf}"])
    return out


def mask_decoder_state_dict(sd: Mapping[str, torch.Tensor], prefix: str = "mask_decoder.",
                            depth: int = 2) -> Dict[str, torch.Tensor]:
    """A SAM ``mask_decoder.*`` subtree -> ``models.sam_decoder.MaskDecoder``'s keys
    (the JAX ``convert_mask_decoder``, which reads the same keys and no others):
    ``transformer.layers.{i}`` -> ``transformer.layers_{i}`` (``mlp.lin*`` ->
    ``mlp_lin*``), ``output_upscaling.{0,1,3}`` -> ``upscale_{0,1,3}`` (the transposed
    convs' weights as ``UpConv2x`` reads them), ``output_hypernetworks_mlps.{t}`` ->
    ``hyper_mlps_{t}`` and ``layers.{j}`` of each MLP head -> ``layers_{j}``."""
    sd = _prefixed(sd, prefix)
    out = {"iou_token": _f32(sd["iou_token.weight"]),
           "mask_tokens": _f32(sd["mask_tokens.weight"])}

    def copy(theirs: str, mine: str, leaves=("weight", "bias")) -> None:
        for leaf in leaves:
            out[f"{mine}.{leaf}"] = _f32(sd[f"{theirs}.{leaf}"])

    attn = ("self_attn", "cross_attn_token_to_image", "cross_attn_image_to_token")
    for i in range(depth):
        theirs, mine = f"transformer.layers.{i}", f"transformer.layers_{i}"
        for name in attn:
            for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                copy(f"{theirs}.{name}.{proj}", f"{mine}.{name}.{proj}")
        for norm in ("norm1", "norm2", "norm3", "norm4"):
            copy(f"{theirs}.{norm}", f"{mine}.{norm}")
        copy(f"{theirs}.mlp.lin1", f"{mine}.mlp_lin1")
        copy(f"{theirs}.mlp.lin2", f"{mine}.mlp_lin2")
    for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
        copy(f"transformer.final_attn_token_to_image.{proj}",
             f"transformer.final_attn_token_to_image.{proj}")
    copy("transformer.norm_final_attn", "transformer.norm_final_attn")
    for i in (0, 3):  # ConvTranspose2d (C_in, C_out, 2, 2) -> (C_out, C_in, 2, 2)
        out[f"upscale_{i}.weight"] = _f32(sd[f"output_upscaling.{i}.weight"]).permute(
            1, 0, 2, 3).contiguous()
        copy(f"output_upscaling.{i}", f"upscale_{i}", ("bias",))
    copy("output_upscaling.1", "upscale_1")
    for j in range(3):
        copy(f"iou_prediction_head.layers.{j}", f"iou_prediction_head.layers_{j}")
    for t in range(out["mask_tokens"].shape[0]):
        for j in range(3):
            copy(f"output_hypernetworks_mlps.{t}.layers.{j}", f"hyper_mlps_{t}.layers_{j}")
    return out


def sam_refiner_state_dict(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A full ``sam_vit_{b,h}``-style checkpoint (or its ``prompt_encoder.*`` /
    ``mask_decoder.*`` alone) -> ``refine.SamRefineModule``'s state_dict (the JAX
    ``convert_sam_refiner``)."""
    out = {"prompt_encoder." + k: v for k, v in prompt_encoder_state_dict(sd).items()}
    out.update({"mask_decoder." + k: v for k, v in mask_decoder_state_dict(sd).items()})
    return out


def checkpoint_kind(sd: Mapping[str, torch.Tensor]) -> str:
    """The layout of a loaded checkpoint: ``"matching_net"``, ``"sam_vit"`` (a SAM
    checkpoint with its encoder: a full one also holds the refiner's subtrees, which
    :func:`sam_refiner_state_dict` reads), ``"resnet50"`` (a torchvision state dict,
    :func:`resnet50_state_dict`) or ``"sam_refiner"`` (the prompt encoder and mask
    decoder alone), sniffed as the JAX package's ``convert`` CLI does."""
    if any(k.startswith("model.") for k in sd):
        return "matching_net"
    if any(k.startswith("image_encoder.") for k in sd):
        return "sam_vit"
    if any(k.startswith("layer1.") for k in sd):
        return "resnet50"
    if any(k.startswith(("prompt_encoder.", "mask_decoder.")) for k in sd):
        return "sam_refiner"
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
