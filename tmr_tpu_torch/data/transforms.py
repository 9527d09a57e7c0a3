"""Image preprocessing (counterpart of ``tmr_tpu/data/transforms.py``: the eval half).

The reference's eval transform is Resize(S, S) with cv2 ``INTER_LINEAR`` on the uint8
image, ImageNet Normalize and a CHW tensor; the JAX package emits NHWC float32. The port
keeps NHWC float32 and does the resize itself in numpy (:func:`resize_linear_u8`), with
cv2's fixed-point arithmetic for 8-bit images: half-pixel centres, 11-bit interpolation
coefficients rounded half to even, a horizontal pass into int32 rows and a vertical pass
``((b0 * (r0 >> 4)) >> 16) + ((b1 * (r1 >> 4)) >> 16) + 2) >> 2``; float planes take
cv2's float form of the same taps (:func:`resize_linear_f32`). cv2 is not imported.
The map phase's mapper resizes with Pillow's ``Image.resize((S, S))`` (BICUBIC for RGB);
:func:`resize_bicubic_u8` is that resample in numpy, in Pillow's fixed-point form, and
:func:`decode_image` is the one place of this module that imports PIL.
:func:`sam_longest_side_preprocess` is the feature extractor's SAM preprocessing.
The JAX module's ``gt_based_random_crop`` is not ported: nothing in ``tmr_tpu`` calls
it, so the JAX trainer does not run it either.
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


def _lerp_f32(p0: np.ndarray, p1: np.ndarray, frac: np.ndarray) -> np.ndarray:
    """``fma(p1 - p0, frac, p0)`` in float32: the difference rounded to float32, the
    product and the sum taken in float64 (the product is exact there) and rounded once
    more to float32."""
    d = (p1 - p0).astype(np.float64)
    return (p0.astype(np.float64) + d * frac.astype(np.float64)).astype(np.float32)


def _taps_f64(src: int, dst: int):
    """Source index and float32 fraction of each output coordinate as cv2's float path
    computes them: ``f = (d + 0.5) * src / dst - 0.5`` and its fraction in float64."""
    f = (np.arange(dst, dtype=np.float64) + 0.5) * (src / dst) - 0.5
    s = np.floor(f).astype(np.int64)
    return s, (f - s).astype(np.float32)


def resize_linear_f32(plane: np.ndarray, height: int, width: int) -> np.ndarray:
    """cv2.resize with ``INTER_LINEAR`` of a float32 (H, W) plane to (height, width), in
    cv2's float form (bit for bit against cv2 5.0 on planes of 2 x 2 and more):
    fractions taken in float64 (:func:`_taps_f64`, not the float32 taps of the uint8
    path, nor its 2048-scaled weights), each pass a fused ``p0 + (p1 - p0) * frac``
    (:func:`_lerp_f32`), the horizontal pass first; columns out of range clamp with a
    zero fraction, rows out of range clamp their index (SAM's mask postprocessing,
    ``sam.SamPredictor``)."""
    src = np.asarray(plane, np.float32)
    h, w = src.shape
    if (h, w) == (height, width):
        return src.copy()
    sx, fx = _taps_f64(w, width)
    fx = np.where((sx < 0) | (sx >= w - 1), np.float32(0.0), fx)
    sx = np.clip(sx, 0, w - 1)
    cols = _lerp_f32(src[:, sx], src[:, np.minimum(sx + 1, w - 1)], fx)
    sy, fy = _taps_f64(h, height)
    return _lerp_f32(cols[np.clip(sy, 0, h - 1)], cols[np.clip(sy + 1, 0, h - 1)],
                     fy[:, None])


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


def decode_image(data: bytes) -> np.ndarray:
    """Encoded image bytes -> uint8 (H, W, 3) RGB (PIL's ``convert("RGB")``). The one
    function of the map phase that imports PIL: a caller without it swaps this out."""
    import io

    from PIL import Image

    with Image.open(io.BytesIO(data)) as img:
        return np.asarray(img.convert("RGB"))


#: Pillow's ``PRECISION_BITS`` for 8-bit resampling: coefficients are integers over 2^22
_BICUBIC_BITS = 32 - 8 - 2


def _bicubic(x: np.ndarray) -> np.ndarray:
    """Pillow's ``bicubic_filter`` (a = -0.5), in float64 with its operation order."""
    a = -0.5
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def _bicubic_taps(src: int, dst: int):
    """Pillow's ``precompute_coeffs`` for BICUBIC (support 2) and
    ``normalize_coeffs_8bpc``: the first source index of each output coordinate (dst,),
    and its int64 weights over 2^22 (dst, ksize), zero past each coordinate's taps."""
    scale = float(np.float32(src)) / dst
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(dst, dtype=np.float64) + 0.5) * scale
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.trunc(center + support + 0.5), src).astype(np.int64) - xmin
    x = np.arange(ksize, dtype=np.int64)[None, :]
    live = x < xmax[:, None]
    w = _bicubic(((x + xmin[:, None]) - center[:, None] + 0.5) * (1.0 / filterscale))
    w = np.where(live, w, 0.0)
    ww = np.cumsum(w, axis=1)[:, -1:]  # summed in tap order, as Pillow does
    w = np.where(ww != 0.0, w / np.where(ww != 0.0, ww, 1.0), w)
    scaled = w * float(1 << _BICUBIC_BITS)
    k = np.where(w < 0, np.trunc(-0.5 + scaled), np.trunc(0.5 + scaled)).astype(np.int64)
    return xmin, np.where(live, k, 0)


def _bicubic_rows(img: np.ndarray, size: int) -> np.ndarray:
    """One of Pillow's 8-bit passes along the first axis of a uint8 (src, ...) array:
    per output row a rounding bias of 2^21 plus its taps' rows times their int32
    weights, then ``clip8`` (the top bits, by arithmetic shift, clipped to 0..255).
    Every product and partial sum stays below 2^31, as in Pillow's int32 sums."""
    src = img.shape[0]
    xmin, k = _bicubic_taps(src, size)
    k = k.astype(np.int32).reshape(size, k.shape[1], *([1] * (img.ndim - 1)))
    acc = np.full((size,) + img.shape[1:], 1 << (_BICUBIC_BITS - 1), np.int32)
    for t in range(k.shape[1]):
        tap = img[np.minimum(xmin + t, src - 1)].astype(np.int32)
        tap *= k[:, t]
        acc += tap
    acc >>= _BICUBIC_BITS
    return np.clip(acc, 0, 255).astype(np.uint8)


def resize_bicubic_u8(image: np.ndarray, height: int, width: int) -> np.ndarray:
    """Resize a uint8 (H, W, 3) RGB image to (height, width, 3), bit for bit Pillow's
    ``Image.resize((width, height))`` (BICUBIC, the default for RGB): the horizontal pass
    first (on the transposed image, so that both passes gather whole rows), then the
    vertical, each skipped when its size does not change."""
    img = _rgb(image)
    if img.dtype != np.uint8:
        raise TypeError(f"the resize takes uint8 images, got {img.dtype}")
    if img.shape[1] != width:
        cols = np.ascontiguousarray(img.transpose(1, 0, 2))
        img = _bicubic_rows(cols, width).transpose(1, 0, 2)
    if img.shape[0] != height:
        img = _bicubic_rows(img, height)
    return np.ascontiguousarray(img)


SAM_PIXEL_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
SAM_PIXEL_STD = np.array([58.395, 57.12, 57.375], np.float32)


def sam_longest_side_preprocess(image: np.ndarray, target: int = 1024) -> np.ndarray:
    """SAM's preprocessing (reference extract_feature.py:50-64): the longest side resized
    to ``target`` (ResizeLongestSide: ``int(x + 0.5)`` of each scaled side, cv2's
    ``INTER_LINEAR`` through :func:`resize_linear_u8`), normalized with the SAM pixel mean
    and std on 0-255 values, zero-padded bottom and right: float32 (target, target, 3)."""
    img = _rgb(image)
    h, w = img.shape[:2]
    scale = target / max(h, w)
    nh, nw = int(h * scale + 0.5), int(w * scale + 0.5)
    img = resize_linear_u8(np.ascontiguousarray(img, np.uint8), nh, nw)
    out = np.zeros((target, target, 3), np.float32)
    out[:nh, :nw] = (img.astype(np.float32) - SAM_PIXEL_MEAN) / SAM_PIXEL_STD
    return out
