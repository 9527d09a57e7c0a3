"""Mask-proposal utilities for the automatic mask generator (the port's own copy of
``tmr_tpu/sam_amg.py``; reference utils/segment_anything/utils/amg.py).

numpy and scipy only, as in the JAX package: batched records are a plain dict of numpy
arrays (``cat_records`` / ``filter_records`` in place of the reference's MaskData), RLE
encoding is vectorized numpy, connected components come from scipy.ndimage (no cv2).

Parity contracts (reference file:line):
- point grids: amg.py:179-197;
- crop pyramid: amg.py:200-234 (layer i has (2^i)^2 boxes, overlap scaled);
- uncrop helpers: amg.py:237-265;
- crop-edge filter: amg.py:78-89 (near crop edge but not image edge);
- uncompressed RLE: amg.py:107-152, column-major (Fortran) runs starting with a
  background count, pycocotools-compatible;
- small-region removal: amg.py:267-291 (holes/islands via 8-connectivity);
- stability score: amg.py:156-177.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np


# ----------------------------------------------------------- batched records
def cat_records(*records: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Concatenate dicts of arrays/lists along axis 0 (MaskData.cat)."""
    records = [r for r in records if r]
    if not records:
        return {}
    out: Dict[str, np.ndarray] = {}
    for k in records[0]:
        vals = [r[k] for r in records]
        if isinstance(vals[0], list):
            out[k] = [x for v in vals for x in v]
        else:
            out[k] = np.concatenate(vals, axis=0)
    return out


def filter_records(
    records: Dict[str, np.ndarray], keep: np.ndarray
) -> Dict[str, np.ndarray]:
    """Row-filter every field by a boolean or index array (MaskData.filter)."""
    out = {}
    idx = np.nonzero(keep)[0] if keep.dtype == bool else keep
    for k, v in records.items():
        if isinstance(v, list):
            out[k] = [v[i] for i in idx]
        else:
            out[k] = v[idx]
    return out


def batch_iterator(batch_size: int, *args):
    """Yield aligned slices of length <= batch_size (amg.py:98-104)."""
    n = len(args[0])
    assert all(len(a) == n for a in args)
    for b in range(0, n, batch_size):
        yield [a[b : b + batch_size] for a in args]


# ----------------------------------------------------------------- geometry
def build_point_grid(n_per_side: int) -> np.ndarray:
    """(n^2, 2) evenly spaced points in [0,1]^2 (amg.py:179-186)."""
    offset = 1.0 / (2 * n_per_side)
    side = np.linspace(offset, 1.0 - offset, n_per_side)
    xs = np.tile(side[None, :], (n_per_side, 1))
    ys = np.tile(side[:, None], (1, n_per_side))
    return np.stack([xs, ys], axis=-1).reshape(-1, 2)


def build_all_layer_point_grids(
    n_per_side: int, n_layers: int, scale_per_layer: int
) -> List[np.ndarray]:
    """Per-crop-layer grids, downscaled by scale^layer (amg.py:189-197)."""
    return [
        build_point_grid(max(1, int(n_per_side / (scale_per_layer**i))))
        for i in range(n_layers + 1)
    ]


def generate_crop_boxes(
    im_size: Tuple[int, int], n_layers: int, overlap_ratio: float
) -> Tuple[List[List[int]], List[int]]:
    """Crop pyramid: full image + (2^i)^2 overlapping crops per layer
    (amg.py:200-234). Returns (xyxy crop boxes, layer index per box)."""
    im_h, im_w = im_size
    short_side = min(im_h, im_w)
    crop_boxes: List[List[int]] = [[0, 0, im_w, im_h]]
    layer_idxs: List[int] = [0]

    def crop_len(orig_len: int, n_crops: int, overlap: int) -> int:
        return int(math.ceil((overlap * (n_crops - 1) + orig_len) / n_crops))

    for i_layer in range(n_layers):
        n_side = 2 ** (i_layer + 1)
        overlap = int(overlap_ratio * short_side * (2 / n_side))
        crop_w = crop_len(im_w, n_side, overlap)
        crop_h = crop_len(im_h, n_side, overlap)
        x0s = [int((crop_w - overlap) * i) for i in range(n_side)]
        y0s = [int((crop_h - overlap) * i) for i in range(n_side)]
        for x0 in x0s:
            for y0 in y0s:
                crop_boxes.append(
                    [x0, y0, min(x0 + crop_w, im_w), min(y0 + crop_h, im_h)]
                )
                layer_idxs.append(i_layer + 1)
    return crop_boxes, layer_idxs


def uncrop_boxes_xyxy(boxes: np.ndarray, crop_box: Sequence[int]) -> np.ndarray:
    x0, y0 = crop_box[0], crop_box[1]
    return boxes + np.array([[x0, y0, x0, y0]], boxes.dtype)


def uncrop_points(points: np.ndarray, crop_box: Sequence[int]) -> np.ndarray:
    x0, y0 = crop_box[0], crop_box[1]
    return points + np.array([[x0, y0]], points.dtype)


def uncrop_mask(
    mask: np.ndarray, crop_box: Sequence[int], orig_h: int, orig_w: int
) -> np.ndarray:
    """Place a crop-frame mask into the full-image frame (amg.py:255-265)."""
    x0, y0, x1, y1 = crop_box
    if x0 == 0 and y0 == 0 and x1 == orig_w and y1 == orig_h:
        return mask
    out = np.zeros((orig_h, orig_w), mask.dtype)
    out[y0:y1, x0:x1] = mask[: y1 - y0, : x1 - x0]
    return out


def is_box_near_crop_edge(
    boxes: np.ndarray,
    crop_box: Sequence[int],
    orig_box: Sequence[int],
    atol: float = 20.0,
) -> np.ndarray:
    """True for boxes touching the crop edge but not the image edge
    (amg.py:78-89); such masks are partial objects cut by the crop."""
    boxes = uncrop_boxes_xyxy(boxes.astype(np.float64), crop_box)
    near_crop = np.isclose(
        boxes, np.asarray(crop_box, np.float64)[None], atol=atol, rtol=0
    )
    near_image = np.isclose(
        boxes, np.asarray(orig_box, np.float64)[None], atol=atol, rtol=0
    )
    return np.any(near_crop & ~near_image, axis=1)


def box_xyxy_to_xywh(box: np.ndarray) -> np.ndarray:
    out = np.array(box, dtype=np.float64, copy=True)
    out[..., 2] = out[..., 2] - out[..., 0]
    out[..., 3] = out[..., 3] - out[..., 1]
    return out


# ----------------------------------------------------------------------- RLE
def mask_to_rle(mask: np.ndarray) -> Dict[str, object]:
    """Binary (H, W) mask -> pycocotools-style uncompressed RLE
    (amg.py:107-135): Fortran-order runs, first count = leading background.
    """
    h, w = mask.shape
    flat = np.asarray(mask, bool).transpose().reshape(-1)  # column-major
    change = np.nonzero(flat[1:] != flat[:-1])[0] + 1
    idx = np.concatenate([[0], change, [h * w]])
    counts = np.diff(idx).tolist()
    if flat[0]:
        counts = [0] + counts
    return {"size": [h, w], "counts": counts}


def rle_to_mask(rle: Dict[str, object]) -> np.ndarray:
    """Uncompressed RLE -> binary (H, W) mask (amg.py:138-149)."""
    h, w = rle["size"]
    flat = np.zeros(h * w, bool)
    idx = 0
    parity = False
    for count in rle["counts"]:
        if parity:
            flat[idx : idx + count] = True
        idx += count
        parity = not parity
    return flat.reshape(w, h).transpose()


def area_from_rle(rle: Dict[str, object]) -> int:
    return int(sum(rle["counts"][1::2]))


def coco_encode_rle(uncompressed_rle: Dict[str, object]) -> Dict[str, object]:
    """Compressed COCO RLE (amg.py:294-300). Requires pycocotools, imported here and
    only here (the reference imports it lazily too); without it this raises."""
    from pycocotools import mask as mask_utils  # noqa: F401

    h, w = uncompressed_rle["size"]
    rle = mask_utils.frPyObjects(uncompressed_rle, h, w)
    rle["counts"] = rle["counts"].decode("utf-8")
    return rle


# ----------------------------------------------------------- mask hygiene
def remove_small_regions(
    mask: np.ndarray, area_thresh: float, mode: str
) -> Tuple[np.ndarray, bool]:
    """Drop small disconnected islands or fill small holes (amg.py:267-291).

    8-connectivity components via scipy.ndimage (the reference uses
    cv2.connectedComponentsWithStats). Returns (mask, changed).
    """
    from scipy import ndimage

    assert mode in ("holes", "islands")
    correct_holes = mode == "holes"
    working = (mask ^ correct_holes).astype(np.uint8)
    labels, n = ndimage.label(working, structure=np.ones((3, 3), np.uint8))
    if n == 0:
        return mask, False
    sizes = ndimage.sum_labels(working, labels, index=np.arange(1, n + 1))
    small = [i + 1 for i, s in enumerate(sizes) if s < area_thresh]
    if not small:
        return mask, False
    fill = [0] + small
    if not correct_holes:
        fill = [i for i in range(n + 1) if i not in fill]
        if not fill:  # every island below threshold: keep the largest
            fill = [int(np.argmax(sizes)) + 1]
    return np.isin(labels, fill), True


def calculate_stability_score(
    mask_logits: np.ndarray, mask_threshold: float, threshold_offset: float
) -> np.ndarray:
    """IoU between high- and low-threshold binarizations (amg.py:156-177)."""
    inter = (mask_logits > (mask_threshold + threshold_offset)).sum((-1, -2))
    union = (mask_logits > (mask_threshold - threshold_offset)).sum((-1, -2))
    return inter / np.maximum(union, 1)
