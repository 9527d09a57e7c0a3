"""Greedy NMS keep masks (counterpart of ``tmr_tpu/ops/nms.py``).

Keep a box iff no higher-scored kept box overlaps it above the IoU threshold. Boxes
are sorted by descending score (invalid entries sink with ``-inf``; ties keep the
lower index first, a stable sort like ``jnp.argsort``), the greedy sweep runs in
``ops/cuda_nms.py`` (kernel on the card, plain version on the CPU), and the mask is
scattered back to the original order.

:func:`nms_topk` (``tmr_tpu/ops/pallas_nms.py:111``) is the same keep mask with the
survivors ranked and compacted into a fixed number of slots.
"""

from __future__ import annotations

from typing import Optional

import torch

from tmr_tpu_torch.ops.cuda_nms import greedy_keep_sorted


def batched_keep_mask(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
                      valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """boxes (B, N, 4), scores (B, N), valid (B, N) bool -> keep (B, N) bool in the
    original order."""
    if valid is None:
        valid = torch.ones(scores.shape, dtype=torch.bool, device=scores.device)
    sort_scores = torch.where(valid, scores, torch.full_like(scores, float("-inf")))
    order = torch.sort(sort_scores, dim=1, descending=True, stable=True).indices
    b = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4)).float()
    v = torch.gather(valid, 1, order)
    keep_sorted = greedy_keep_sorted(b, v, iou_threshold)
    return torch.zeros_like(valid).scatter(1, order, keep_sorted)


def nms_keep_mask(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
                  valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One image: boxes (N, 4), scores (N,), valid (N,) -> keep (N,) bool."""
    return batched_keep_mask(boxes[None], scores[None], iou_threshold,
                             None if valid is None else valid[None])[0]


def nms_topk(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
             valid: Optional[torch.Tensor] = None, k: Optional[int] = None,
             interpret: Optional[bool] = None, backend: str = "auto") -> dict:
    """Batched greedy NMS with a fixed-size compact output: boxes (B, N, 4), scores
    (B, N), valid (B, N) bool -> {"count" (B,) int32, "boxes" (B, k, 4), "scores" (B, k),
    "index" (B, k) int32}: each image's survivors in descending score order (ties toward
    the lower input slot, as ``lax.top_k`` breaks them: a stable sort), in the leading
    ``count`` slots; past ``count`` boxes and scores are zero and the index -1. ``k``
    defaults to N; a larger ``k`` pads. The keep mask is :func:`batched_keep_mask`
    (kernel 6 on the card, the plain version on the CPU).

    ``interpret`` and ``backend`` keep the JAX signature: the port has one route, so
    ``backend`` takes ``"auto"`` only and ``interpret`` changes nothing."""
    if backend != "auto":
        raise ValueError(f"nms_topk: backend={backend!r}: the port has one route "
                         "(kernel 6 on the card, its plain version on the CPU); pass "
                         "'auto'")
    b, n = scores.shape
    k = n if k is None else int(k)
    keep = batched_keep_mask(boxes, scores, iou_threshold, valid)
    ranked = torch.where(keep, scores, torch.full_like(scores, float("-inf")))
    order = torch.sort(ranked, dim=1, descending=True, stable=True)
    top_scores, top_idx = order.values[:, :k], order.indices[:, :k]
    if k > n:  # more output slots than inputs: pad the gather itself
        top_scores = torch.nn.functional.pad(top_scores, (0, k - n), value=float("-inf"))
        top_idx = torch.nn.functional.pad(top_idx, (0, k - n))
    count = keep.sum(dim=1).clamp_max(k).to(torch.int32)
    ok = torch.arange(k, device=scores.device)[None, :] < count[:, None]
    gathered = torch.gather(boxes, 1, top_idx[..., None].expand(-1, -1, 4))
    return {
        "count": count,
        "boxes": torch.where(ok[..., None], gathered, torch.zeros_like(gathered)),
        "scores": torch.where(ok, top_scores, torch.zeros_like(top_scores)),
        "index": torch.where(ok, top_idx, torch.full_like(top_idx, -1)).to(torch.int32),
    }
