"""Image preprocessing (counterpart of ``tmr_tpu/data/transforms.py``: the eval half).

The reference's eval transform is Resize(S, S) with cv2 ``INTER_LINEAR`` on the uint8
image, ImageNet Normalize and a CHW tensor; the JAX package emits NHWC float32. The port
keeps NHWC float32 and does the resize itself in numpy (:func:`resize_linear_u8`), with
cv2's fixed-point arithmetic for 8-bit images: half-pixel centres, 11-bit interpolation
coefficients rounded half to even, a horizontal pass into int32 rows and a vertical pass
``((b0 * (r0 >> 4)) >> 16) + ((b1 * (r1 >> 4)) >> 16) + 2) >> 2``. cv2 is not imported.
``gt_based_random_crop`` and the SAM longest-side preprocessing belong to training and to
the feature extractor and are not ported yet.
"""

from __future__ import annotations

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

#: cv2's ``INTER_RESIZE_COEF_BITS``: interpolation weights are integers over 2^11
COEF_SCALE = 1 << 11


def _rgb(image: np.ndarray) -> np.ndarray:
    img = np.asarray(image)
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    if img.shape[-1] == 4:
        img = img[..., :3]
    return img


def normalize_image(image: np.ndarray) -> np.ndarray:
    """uint8/float HWC RGB -> ImageNet-normalized float32 HWC (x / 255 for integer
    input, then (x - mean) / std; float input is taken as [0, 1] already)."""
    img = _rgb(image)
    if np.issubdtype(img.dtype, np.integer):
        img = img.astype(np.float32) / 255.0
    else:
        img = img.astype(np.float32)
    return (img - IMAGENET_MEAN) / IMAGENET_STD


def _taps(src: int, dst: int):
    """Source index and weight pair of each output coordinate, as cv2 computes them:
    ``f = float32((d + 0.5) * src / dst - 0.5)``, ``s = floor(f)``, weights
    ``rint((1 - frac) * 2048)`` and ``rint(frac * 2048)`` in float32."""
    scale = src / dst
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    frac = (f - s.astype(np.float32)).astype(np.float32)
    return s, frac


def _weights(frac: np.ndarray):
    w0 = np.rint((np.float32(1.0) - frac) * np.float32(COEF_SCALE)).astype(np.int32)
    w1 = np.rint(frac * np.float32(COEF_SCALE)).astype(np.int32)
    return w0, w1


def _resized_planes(img: np.ndarray, height: int, width: int):
    """cv2.resize with ``INTER_LINEAR`` of a uint8 (H, W, C) image to (height, width),
    in its fixed-point form, one channel at a time: yields (c, int32 plane of values
    0..255). Columns out of range clamp with a zero fraction; rows out of range clamp
    their index and keep their weights, as cv2 does. Every sum fits int32 (255 * 2048
    before the shift, 2048 * 32640 after it)."""
    if img.dtype != np.uint8:
        raise TypeError(f"the resize takes uint8 images, got {img.dtype}")
    h, w = img.shape[:2]
    sx, fx = _taps(w, width)
    fx = np.where((sx < 0) | (sx >= w - 1), np.float32(0.0), fx)
    sx = np.clip(sx, 0, w - 1)
    sx1 = np.minimum(sx + 1, w - 1)
    ax0, ax1 = _weights(fx)
    sy, fy = _taps(h, height)
    sy0, sy1 = np.clip(sy, 0, h - 1), np.clip(sy + 1, 0, h - 1)
    by0, by1 = (b[:, None] for b in _weights(fy))
    for c in range(img.shape[2]):
        src = img[..., c].astype(np.int32)
        cols = src[:, sx] * ax0
        cols += src[:, sx1] * ax1
        cols >>= 4
        out = (by0 * cols[sy0]) >> 16
        out += (by1 * cols[sy1]) >> 16
        out += 2
        out >>= 2
        yield c, out


def resize_linear_u8(image: np.ndarray, height: int, width: int) -> np.ndarray:
    """Bilinear resize of a uint8 (H, W, C) image to (height, width, C), bit for bit
    cv2.resize with ``INTER_LINEAR``."""
    img = np.asarray(image)
    out = np.empty((height, width, img.shape[2]), np.uint8)
    for c, plane in _resized_planes(img, height, width):
        out[..., c] = plane
    return out


#: normalize_image of every uint8 value, per channel (3, 256): the same float32
#: operations, so a lookup gives the same values
_NORM_LUT = np.ascontiguousarray(
    ((np.arange(256, dtype=np.float32)[:, None] / 255.0 - IMAGENET_MEAN)
     / IMAGENET_STD).astype(np.float32).T)


def resize_normalize(image: np.ndarray, size: int) -> np.ndarray:
    """Resize a uint8 image to (size, size) as :func:`resize_linear_u8` does, then
    normalize, through a lookup of :func:`normalize_image`'s values: float32 (S, S, 3)."""
    img = _rgb(image)
    out = np.empty((size, size, 3), np.float32)
    for c, plane in _resized_planes(img, size, size):
        out[..., c] = _NORM_LUT[c][plane]
    return out


def pick_image_size(orig_boxes: np.ndarray, base: int = 1024, large: int = 1536,
                    eval_mode: bool = False, split: str = "train") -> int:
    """The small-object escape hatch (reference FSCD147.py:148-150, RPINE.py:123-125):
    eval images of the test split whose smallest GT box is under 25 px in both sides run
    at ``large``, every other image at ``base``."""
    if split != "test" or not eval_mode or len(orig_boxes) == 0:
        return base
    w = orig_boxes[:, 2] - orig_boxes[:, 0]
    h = orig_boxes[:, 3] - orig_boxes[:, 1]
    if w.min() < 25 and h.min() < 25:
        return large
    return base
