"""Greedy NMS over score-sorted boxes: a hand-written CUDA kernel and its plain version.

Replaces ``tmr_tpu/ops/pallas_nms.py`` (``nms_keep_mask_pallas`` / ``_nms_kernel``):
boxes arrive sorted by descending score; box i, while kept, suppresses every later box
whose IoU with it is strictly above the threshold. Areas clamp at 0, the union at
``1e-12``. Sorting and unsorting stay outside (``ops/nms.py``), as in the JAX wrapper.

The kernel is a registered ``torch.library`` op, ``tmr::nms``, which ``torch.export``
records by name: its CPU kernel is the plain version (whose early exit reads the data,
inside the op and never in a traced program), its CUDA kernel launches ``csrc/nms.cu`` or
raises, and its fake implementation gives the (B, N) bool keep mask. There the work is an IoU bitmask of every (i, j > i) pair,
made in parallel into a workspace of :func:`mask_words` 64-bit words per box, then a
short scan over those words per image that decides the keeps (two kernel launches per
call, counted as one). The IoU is explicitly rounded, so keep decisions equal the plain
version's bit for bit. Any N is taken whose workspace fits in device memory; past that
the workspace's allocation raises. Boxes that require grad raise on the card while grad
mode is on (``_build.refuse_grad``): a keep mask has no gradient to pass.
"""

from __future__ import annotations

import torch

from tmr_tpu_torch.ops import _build


def mask_words(n: int) -> int:
    """64-bit words in one row of the kernel's IoU bitmask: one bit per box."""
    return (n + 63) // 64


def greedy_keep_sorted_plain(boxes: torch.Tensor, valid: torch.Tensor,
                             iou_threshold: float) -> torch.Tensor:
    """boxes (B, N, 4) f32 sorted per image, valid (B, N) bool -> keep (B, N) bool."""
    n = boxes.shape[1]
    x1, y1, x2, y2 = boxes.float().unbind(-1)
    area = (x2 - x1).clamp_min(0.0) * (y2 - y1).clamp_min(0.0)
    keep = valid.clone()
    idx = torch.arange(n, device=boxes.device)
    for i in range(n):
        alive = keep[:, i:i + 1]
        if not bool(alive.any()):
            continue
        iw = (torch.minimum(x2, x2[:, i:i + 1])
              - torch.maximum(x1, x1[:, i:i + 1])).clamp_min(0.0)
        ih = (torch.minimum(y2, y2[:, i:i + 1])
              - torch.maximum(y1, y1[:, i:i + 1])).clamp_min(0.0)
        inter = iw * ih
        iou = inter / ((area + area[:, i:i + 1]) - inter).clamp_min(1e-12)
        keep = keep & ~(alive & (idx > i) & (iou > iou_threshold))
    return keep


def greedy_keep_sorted(boxes: torch.Tensor, valid: torch.Tensor,
                       iou_threshold: float) -> torch.Tensor:
    """Greedy NMS keep mask in the sorted order, one call of the kernel for the whole
    batch."""
    b, n, four = boxes.shape
    if four != 4 or valid.shape != (b, n):
        raise ValueError(f"nms: boxes {tuple(boxes.shape)} / valid {tuple(valid.shape)}")
    if boxes.device.type != "cpu":
        _build.refuse_grad("nms", boxes)
    return torch.ops.tmr.nms(boxes, valid, float(iou_threshold))


@torch.library.custom_op("tmr::nms", mutates_args=(), device_types="cpu",
                         schema="(Tensor boxes, Tensor valid, float iou_threshold) -> Tensor")
def _nms_op(boxes, valid, iou_threshold):
    """The op of :func:`greedy_keep_sorted`; this, its CPU kernel, is the plain
    version."""
    return greedy_keep_sorted_plain(boxes, valid, iou_threshold)


@_nms_op.register_fake
def _nms_fake(boxes, valid, iou_threshold):
    return valid.new_empty(valid.shape, dtype=torch.bool)


@_nms_op.register_kernel("cuda")
def _nms_cuda(boxes, valid, iou_threshold):
    """The op's CUDA kernel: the mask and scan launches of ``tmr_nms`` (counted as one),
    or ``ValueError`` for boxes the kernel does not take."""
    b, n, _ = boxes.shape
    if boxes.dtype != torch.float32:
        raise ValueError("nms: the kernel takes f32 boxes")
    boxes = boxes.contiguous()
    valid = valid.to(torch.bool).contiguous()
    keep = torch.empty_like(valid)
    if keep.numel() == 0:
        return keep
    mask = torch.empty((b, n, mask_words(n)), dtype=torch.int64, device=boxes.device)
    _build.launch("nms", "nms", "tmr_nms", boxes.data_ptr(), valid.data_ptr(),
                  keep.data_ptr(), mask.data_ptr(), b, n, float(iou_threshold),
                  _build.stream_of(boxes))
    return keep
