"""Template extraction and cross-correlation (counterpart of ``tmr_tpu/ops/xcorr.py``).

- :func:`template_geometry` / :func:`extract_template`: RoIAlign the exemplar into an
  odd (ht, wt) template centred in a static (T, T) capacity (template_matching.py:55-76);
- :func:`extract_prototype`: the mean of the feature over the exemplar's integer crop as
  a 1 x 1 template (template_matching.py:43-53);
- :func:`cross_correlation`: depthwise SAME correlation with per-image templates,
  divided by ``ht * wt + 1e-14``, the ``(ht // 2, wt // 2)`` border band zeroed, an
  optional channel sum. Buckets up to :data:`FFT_CAPACITY_THRESHOLD` run the direct
  correlation (``ops/cuda_xcorr.py``; the f32 arm through its autograd Function
  ``XCorr``, so that a loss behind it trains what is before it); larger ones the
  correlation theorem with ``torch.fft``, whose cost does not grow with T. With
  ``quant="int8"`` the direct path takes the int8 arms of ``tmr_tpu/ops/xcorr.py`` (no
  gates): ``"dequant"``, a bf16 feature and the int8-grid template through the f32
  kernel (products of bf16 values are exact in f32); ``"int8"``, both operands quantized
  per (image, channel) through the int8 kernel. The FFT path is f32 whatever ``quant``
  says, as in JAX.

- :func:`match_templates`: the full matcher (template_matching.py:79-93) without the
  learnable scale: template extraction, then the correlation;
- :func:`coarse_prefilter_scores`: the gallery tier's coarse prefilter, the same
  correlation on a channel sketch of the feature at reduced resolution. Its sign table is
  the JAX package's ``jax.random.bernoulli(jax.random.key(20260804), 0.5, (C, G))`` bit
  for bit, drawn here by a numpy Threefry-2x32 (:func:`sketch_signs`), never by
  ``torch.Generator``.
"""

from __future__ import annotations

import functools
import threading

import numpy as np
import torch
import torch.nn.functional as F

from tmr_tpu_torch.ops.cuda_xcorr import XCorr, xcorr, xcorr_int8
from tmr_tpu_torch.ops.quant import quantize_int8, quantize_int8_template, quantize_template
from tmr_tpu_torch.ops.roi_align import sampling_matrix

FFT_CAPACITY_THRESHOLD = 65


def template_geometry(exemplars: torch.Tensor, feat_h: int, feat_w: int) -> dict:
    """(B, 4) normalized xyxy -> feature-space x1/y1/x2/y2 (f32) and odd ht/wt (int)."""
    ex = exemplars.float().clamp(0.0, 1.0)
    x1, x2 = ex[:, 0] * feat_w, ex[:, 2] * feat_w
    y1, y2 = ex[:, 1] * feat_h, ex[:, 3] * feat_h
    wt = torch.ceil(x2).to(torch.int32) - torch.floor(x1).to(torch.int32)
    ht = torch.ceil(y2).to(torch.int32) - torch.floor(y1).to(torch.int32)
    wt = (wt - (wt % 2 == 0).to(torch.int32)).clamp_min(1)
    ht = (ht - (ht % 2 == 0).to(torch.int32)).clamp_min(1)
    return {"x1": x1, "y1": y1, "x2": x2, "y2": y2, "ht": ht, "wt": wt}


def extract_template(feature: torch.Tensor, exemplars: torch.Tensor, capacity: int):
    """feature (B, C, H, W), exemplars (B, 4) -> (templates (B, C, T, T) f32,
    thw (B, 2) int32 true sizes, clamped to the capacity)."""
    _, _, h, w = feature.shape
    g = template_geometry(exemplars, h, w)
    ht = g["ht"].clamp_max(capacity)
    wt = g["wt"].clamp_max(capacity)
    ay = sampling_matrix(g["y1"] - 0.5, g["y2"] - g["y1"], ht, capacity, h,
                         offset=torch.div(capacity - ht, 2, rounding_mode="floor"),
                         sampling_ratio=-1, max_ratio=2)
    ax = sampling_matrix(g["x1"] - 0.5, g["x2"] - g["x1"], wt, capacity, w,
                         offset=torch.div(capacity - wt, 2, rounding_mode="floor"),
                         sampling_ratio=-1, max_ratio=2)
    template = torch.matmul(torch.matmul(ay[:, None], feature.float()),
                            ax[:, None].transpose(-1, -2))
    return template, torch.stack([ht, wt], dim=1)


def extract_prototype(feature: torch.Tensor, exemplars: torch.Tensor, capacity: int = 1):
    """feature (B, C, H, W), exemplars (B, 4) -> (templates (B, C, T, T): the mean of the
    feature over the crop [floor(y1 H), ceil(y2 H)) x [floor(x1 W), ceil(x2 W)) at the
    centre of a zero (T, T) kernel, T = ``capacity``; thw (B, 2) int32 ones)."""
    b, _, h, w = feature.shape
    g = template_geometry(exemplars, h, w)
    dev = feature.device
    xs = torch.arange(w, device=dev)[None, :]
    ys = torch.arange(h, device=dev)[None, :]
    mx = ((xs >= torch.floor(g["x1"]).to(torch.int32)[:, None])
          & (xs < torch.ceil(g["x2"]).to(torch.int32)[:, None]))
    my = ((ys >= torch.floor(g["y1"]).to(torch.int32)[:, None])
          & (ys < torch.ceil(g["y2"]).to(torch.int32)[:, None]))
    mask = (my[:, :, None] & mx[:, None, :]).to(feature.dtype)
    denom = mask.sum(dim=(1, 2)).clamp_min(1.0)
    proto = (feature * mask[:, None]).sum(dim=(2, 3)) / denom[:, None]
    c = capacity // 2
    template = F.pad(proto[:, :, None, None], (c, capacity - 1 - c, c, capacity - 1 - c))
    return template, torch.ones((b, 2), dtype=torch.int32, device=dev)


def _fft_size(n: int) -> int:
    """Smallest 2^a * 3^b >= n."""
    best = 1 << (n - 1).bit_length()
    for b in (1, 3, 9):
        m = b
        while m < n:
            m *= 2
        if n <= m < best:
            best = m
    return best


def _xcorr_fft(feature: torch.Tensor, template: torch.Tensor) -> torch.Tensor:
    """Exact linear SAME correlation via the correlation theorem (f32)."""
    _, _, h, w = feature.shape
    t = template.shape[-1]
    c = t // 2
    n = _fft_size(max(h, w) + t - 1)
    ff = torch.fft.rfft2(feature.float(), s=(n, n))
    ft = torch.fft.rfft2(template.float(), s=(n, n))
    corr = torch.fft.irfft2(ff * torch.conj(ft), s=(n, n))
    ys = (torch.arange(h, device=feature.device) - c) % n
    xs = (torch.arange(w, device=feature.device) - c) % n
    return corr[:, :, ys][:, :, :, xs]


def xcorr_int8dot(feature: torch.Tensor, template: torch.Tensor) -> torch.Tensor:
    """Both operands on the int8 grid (``_xcorr_int8dot``): the feature quantized per
    (image, channel) over H*W, the template as :func:`quantize_int8_template`."""
    b, c, h, w = feature.shape
    fq, fs = quantize_int8(feature.float().reshape(b, c, h * w), -1)
    tq, ts = quantize_int8_template(template)
    return xcorr_int8(fq.reshape(b, c, h, w), tq, fs.reshape(b, c, 1, 1), ts)


def cross_correlation(feature: torch.Tensor, template: torch.Tensor,
                      template_hw: torch.Tensor, squeeze: bool = False,
                      quant: str = "off", kernel: str = "dequant") -> torch.Tensor:
    """feature (B, C, H, W) f32; template (B, C, T, T); template_hw (B, 2) int ->
    (B, C, H, W), or (B, 1, H, W) with ``squeeze``. ``quant``/``kernel``: the
    ``Config`` fields of the same names."""
    _, _, h, w = feature.shape
    t = template.shape[-1]
    if t > FFT_CAPACITY_THRESHOLD:
        out = _xcorr_fft(feature, template)
    elif quant == "int8" and kernel == "int8":
        out = xcorr_int8dot(feature, template)
    elif quant == "int8":
        out = xcorr(feature.to(torch.bfloat16).float(),
                    quantize_template(template, torch.bfloat16).float())
    else:
        out = XCorr.apply(feature.float(), template.float())
    ht = template_hw[:, 0]
    wt = template_hw[:, 1]
    out = out / (ht * wt + 1e-14).to(out.dtype)[:, None, None, None]
    ph = torch.div(ht, 2, rounding_mode="floor")[:, None]
    pw = torch.div(wt, 2, rounding_mode="floor")[:, None]
    ys = torch.arange(h, device=feature.device)[None, :]
    xs = torch.arange(w, device=feature.device)[None, :]
    row_ok = (ys >= ph) & (ys < h - ph)
    col_ok = (xs >= pw) & (xs < w - pw)
    mask = row_ok[:, None, :, None] & col_ok[:, None, None, :]
    out = torch.where(mask, out, torch.zeros_like(out))
    if squeeze:
        out = out.sum(dim=1, keepdim=True)
    return out


def match_templates(feature: torch.Tensor, exemplars: torch.Tensor, capacity: int,
                    template_type: str = "roi_align",
                    squeeze: bool = False) -> torch.Tensor:
    """The full matcher (template_matching.py:79-93) without the learnable scale:
    feature (B, C, H, W), exemplars (B, 4) normalized first-exemplar boxes -> the
    correlation (B, C, H, W), or (B, 1, H, W) with ``squeeze``."""
    roi = template_type == "roi_align"
    extract = extract_template if roi else extract_prototype
    templates, thw = extract(feature, exemplars, capacity if roi else 1)
    return cross_correlation(feature, templates, thw, squeeze=squeeze)


#: sketch width of the coarse prefilter: the C feature channels project onto this many
#: fixed +-1 sketch channels before the low-resolution correlation
COARSE_SKETCH_CHANNELS = 32
#: the key of the JAX package's sketch draw (``jax.random.key(20260804)``)
SKETCH_SEED = 20260804

_U32 = np.uint32


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << _U32(r)) | (x >> _U32(32 - r))


def threefry2x32(key: tuple, x0: np.ndarray, x1: np.ndarray) -> tuple:
    """Threefry-2x32 with 20 rounds (Salmon et al. 2011; JAX's ``threefry2x32_p``) of
    the counter words ``(x0, x1)`` (uint32 arrays) under ``key`` (two uint32 words)."""
    k0, k1 = _U32(key[0]), _U32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _U32(0x1BD11BDA))
    rotations = ((13, 15, 26, 6), (17, 29, 16, 24))
    with np.errstate(over="ignore"):
        x0 = x0.astype(np.uint32) + ks[0]
        x1 = x1.astype(np.uint32) + ks[1]
        for i in range(5):
            for r in rotations[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + _U32(i + 1)
    return x0, x1


@functools.lru_cache(maxsize=None)
def sketch_signs(c: int, g: int, seed: int = SKETCH_SEED) -> np.ndarray:
    """The prefilter's (c, g) f32 sign table, +-1 / sqrt(g): the signs are
    ``jax.random.bernoulli(jax.random.key(seed), 0.5, (c, g))`` bit for bit (JAX's
    partitionable Threefry: the flat index split into (hi, lo) words as the counter, key
    words (0, seed), the two output words XORed, the top 23 bits as a uniform in [0, 1),
    true below 0.5). Built once per (c, g)."""
    idx = np.arange(c * g, dtype=np.uint64)
    a, b = threefry2x32((0, seed), (idx >> np.uint64(32)).astype(np.uint32),
                        (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    bits = a ^ b
    uniform = ((bits >> _U32(9)) | _U32(0x3F800000)).view(np.float32) - np.float32(1.0)
    signs = np.where(uniform < np.float32(0.5), np.float32(1.0), np.float32(-1.0))
    signs = signs / np.sqrt(np.float32(g))
    signs.setflags(write=False)
    return signs.reshape(c, g)


_SIGNS_ON_DEVICE: dict = {}
_SIGNS_LOCK = threading.Lock()


def _signs_on(c: int, g: int, device: torch.device) -> torch.Tensor:
    """:func:`sketch_signs` on ``device``, copied there once (a per-call copy from host
    memory would stall the host on every frame)."""
    key = (c, g, str(device))
    with _SIGNS_LOCK:
        t = _SIGNS_ON_DEVICE.get(key)
        if t is None:
            t = _SIGNS_ON_DEVICE[key] = torch.from_numpy(
                sketch_signs(c, g).copy()).to(device)
    return t


def coarse_prefilter_scores(feature: torch.Tensor, exemplars: torch.Tensor,
                            k_real: torch.Tensor, n_real, pool: int = 2,
                            sketch: int = COARSE_SKETCH_CHANNELS) -> torch.Tensor:
    """Channel-sketched, low-resolution correlation score per gallery bank entry, the
    gallery tier's coarse prefilter (``tmr_tpu/ops/xcorr.py:532``, a ranking heuristic
    only: prefilter off is exact).

    The C channels project onto ``sketch`` fixed +-1 channels (:func:`sketch_signs`), the
    map average-pools ``pool`` x (1 below 8 coarse cells per axis) and is zero-meaned per
    sketch channel; each entry's boxes extract sketch templates at the largest odd
    capacity the coarse grid holds, correlated channel-summed through
    :func:`cross_correlation` (kernel 5 on the card at T <= 65); an entry's score is the
    max over its real rows' peaks.

    feature (1, H, W, C) NHWC; exemplars (N, K, 4) normalized xyxy; k_real (N,) real rows
    per entry; n_real the real entries. Returns (N,) f32 with padded entries at -inf."""
    c = int(feature.shape[-1])
    g = max(min(int(sketch), c), 1)
    dev = feature.device
    f = torch.einsum("bhwc,cg->bghw", feature.float(), _signs_on(c, g, dev))
    if min(int(feature.shape[1]), int(feature.shape[2])) < 8 * pool:
        pool = 1
    if pool > 1:
        h, w = f.shape[2] - f.shape[2] % pool, f.shape[3] - f.shape[3] % pool
        f = f[:, :, :h, :w].reshape(1, g, h // pool, pool, w // pool, pool)
        f = f.mean(dim=(3, 5))
    f = f - f.mean(dim=(2, 3), keepdim=True)
    h, w = int(f.shape[2]), int(f.shape[3])
    m = max(h, w)
    cap = m - (1 - m % 2)  # the largest odd capacity the coarse grid holds
    n, k = int(exemplars.shape[0]), int(exemplars.shape[1])
    # dense planes: the correlation kernel takes no stride-0 batch
    fm = f.expand(n * k, g, h, w).contiguous()
    templates, thw = extract_template(fm, exemplars.reshape(n * k, 4).float(), cap)
    corr = cross_correlation(fm, templates, thw, squeeze=True)
    scores = corr.reshape(n * k, -1).amax(dim=1).reshape(n, k)
    neg = torch.full_like(scores, float("-inf"))
    row_ok = torch.arange(k, device=dev)[None, :] < k_real.to(dev)[:, None]
    scores = torch.where(row_ok, scores, neg).amax(dim=1)
    entry_ok = torch.arange(n, device=dev) < n_real
    return torch.where(entry_ok, scores, neg[:, 0])
