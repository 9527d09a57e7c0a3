"""Visual-inspection outputs of eval (counterpart of ``tmr_tpu/utils/visualize.py``;
reference utils/log_utils.py:311-531 and trainer.py:155-170).

Per-image GT | Pred | combined triptychs with a per-image AP50 caption
(:func:`save_triptychs`), precision-recall curves per IoU threshold
(:func:`plot_pr_curves`) and objectness heat maps (:func:`save_presence_maps`), all
post-processing of the merged COCO-style jsons eval writes: nothing here runs on the
program's path. ``--visualize`` turns them on; they land under
``{logpath}/visualizations/{stage}/``, with the JAX module's colours, line widths and
file names.

The JAX module draws and writes with cv2; here the rectangles are numpy (a box's
outline grows inward from its corners, ``thickness`` pixels wide) and PIL writes the
PNGs and the caption, so no cv2 is needed. matplotlib is optional, as there:
:func:`plot_pr_curves` returns None without it.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

GT_COLOR = (80, 220, 80)      # green (RGB)
PRED_COLOR = (255, 80, 80)    # red
EX_COLOR = (80, 120, 255)     # blue
CAPTION_COLOR = (255, 255, 0)
CAPTION_XY = (8, 24)          # the caption's left end, on its baseline


def _draw_xywh(img: np.ndarray, boxes, color, thickness: int = 2) -> np.ndarray:
    """``img`` (H, W, 3) uint8 with each xywh box's outline drawn in ``color``: the
    corners at (int(x), int(y)) and (int(x + w), int(y + h)), both included, the outline
    ``thickness`` pixels wide inside them, clipped to the image. Draws in place and
    returns ``img``."""
    h, w = img.shape[:2]
    for bx, by, bw, bh in np.asarray(boxes, np.float64).reshape(-1, 4):
        x0, x1 = sorted((int(bx), int(bx + bw)))
        y0, y1 = sorted((int(by), int(by + bh)))
        t = max(1, thickness)
        for ys, xs in ((slice(y0, min(y0 + t, y1 + 1)), slice(x0, x1 + 1)),
                       (slice(max(y1 - t + 1, y0), y1 + 1), slice(x0, x1 + 1)),
                       (slice(y0, y1 + 1), slice(x0, min(x0 + t, x1 + 1))),
                       (slice(y0, y1 + 1), slice(max(x1 - t + 1, x0), x1 + 1))):
            ys = slice(max(ys.start, 0), max(min(ys.stop, h), 0))
            xs = slice(max(xs.start, 0), max(min(xs.stop, w), 0))
            img[ys, xs] = color
    return img


def _caption(img: np.ndarray, text: str) -> np.ndarray:
    """``img`` with ``text`` written in :data:`CAPTION_COLOR` at :data:`CAPTION_XY` (PIL's
    default font), as a new array."""
    from PIL import Image, ImageDraw, ImageFont

    pil = Image.fromarray(np.ascontiguousarray(img))
    font = ImageFont.load_default()
    left, top, _, bottom = ImageDraw.Draw(pil).textbbox((0, 0), text, font=font)
    x, y = CAPTION_XY
    ImageDraw.Draw(pil).text((x - left, y - bottom), text, fill=CAPTION_COLOR, font=font)
    return np.asarray(pil)


def _write_png(path: str, img: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray(np.ascontiguousarray(img)).save(path)


def per_image_ap50(gt_xywh: np.ndarray, pred_xywh: np.ndarray, scores: np.ndarray) -> float:
    """Single-image AP@0.5 by greedy score-ordered matching (the reference's per-image
    caption, log_utils.py:493-531), 101-point interpolated, in percent."""
    from tmr_tpu_torch.utils.coco_eval import iou_xywh

    gt = np.asarray(gt_xywh, np.float64).reshape(-1, 4)
    pred = np.asarray(pred_xywh, np.float64).reshape(-1, 4)
    scores = np.asarray(scores, np.float64).reshape(-1)
    if len(gt) == 0:
        return 0.0 if len(pred) else 100.0
    if len(pred) == 0:
        return 0.0
    order = np.argsort(-scores)
    iou = iou_xywh(pred[order], gt)
    matched = np.zeros(len(gt), bool)
    tp = np.zeros(len(pred))
    for d in range(len(pred)):
        best, best_iou = -1, 0.5
        for g in range(len(gt)):
            if not matched[g] and iou[d, g] >= best_iou:
                best, best_iou = g, iou[d, g]
        if best >= 0:
            matched[best] = True
            tp[d] = 1
    cum_tp = np.cumsum(tp)
    recall = cum_tp / len(gt)
    precision = cum_tp / np.arange(1, len(pred) + 1)
    ap = 0.0
    for r in np.linspace(0, 1, 101):
        p = precision[recall >= r]
        ap += (p.max() if len(p) else 0.0) / 101
    return float(ap * 100)


def save_triptychs(log_path: str, stage: str, max_images: Optional[int] = None,
                   image_loader=None) -> List[str]:
    """GT | Pred | combined panels per image (log_utils.py:311-377) as
    ``{file name}_triptych.png``, captioned ``GT n | Pred m | AP50 a``.

    Reads the merged instances/predictions jsons; the pixels come from each image's
    ``img_url`` through PIL, or from ``image_loader(img_info) -> (H, W, 3) uint8`` (eval
    passes its dataset's reader). An image whose pixels cannot be loaded is skipped:
    visualization never fails an eval run. Returns the paths written."""
    from tmr_tpu_torch.utils.metrics import GTS_NAME_FORMAT, PRED_NAME_FORMAT

    with open(os.path.join(log_path, f"{GTS_NAME_FORMAT}_{stage}.json")) as f:
        gts = json.load(f)
    with open(os.path.join(log_path, f"{PRED_NAME_FORMAT}_{stage}.json")) as f:
        preds = json.load(f)

    g_by_img: Dict[object, list] = {}
    for a in gts["annotations"]:
        g_by_img.setdefault(a["image_id"], []).append(a["bbox"])
    p_by_img: Dict[object, list] = {}
    s_by_img: Dict[object, list] = {}
    for a in preds["annotations"]:
        p_by_img.setdefault(a["image_id"], []).append(a["bbox"])
        s_by_img.setdefault(a["image_id"], []).append(a["score"])

    out_dir = os.path.join(log_path, "visualizations", stage)
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for img_info in preds["images"][: max_images or len(preds["images"])]:
        try:
            if image_loader is not None:
                img = np.asarray(image_loader(img_info), np.uint8)
            else:
                from PIL import Image

                with Image.open(img_info["img_url"]) as im:
                    img = np.asarray(im.convert("RGB"))
        except Exception:
            continue
        i = img_info["id"]
        gt = g_by_img.get(i, [])
        pd = p_by_img.get(i, [])
        sc = s_by_img.get(i, [])
        ap = per_image_ap50(gt, pd, sc)

        panel_gt = _draw_xywh(img.copy(), gt, GT_COLOR)
        panel_gt = _draw_xywh(panel_gt, img_info.get("exemplar_boxes", []), EX_COLOR, 3)
        panel_pred = _draw_xywh(img.copy(), pd, PRED_COLOR)
        panel_both = _draw_xywh(_draw_xywh(img.copy(), gt, GT_COLOR), pd, PRED_COLOR)
        trip = np.concatenate([panel_gt, panel_pred, panel_both], axis=1)
        trip = _caption(trip, f"GT {len(gt)} | Pred {len(pd)} | AP50 {ap:.1f}")
        name = os.path.splitext(os.path.basename(str(img_info.get("file_name", i))))[0]
        path = os.path.join(out_dir, f"{name}_triptych.png")
        _write_png(path, trip)
        written.append(path)
    return written


def plot_pr_curves(log_path: str, stage: str) -> Optional[str]:
    """Precision-recall curves at IoU .5/.75/.95 (log_utils.py:447-491) from the
    evaluator's accumulated precision, as ``pr_curves.png``; None without matplotlib."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None

    from tmr_tpu_torch.utils.coco_eval import COCOEvalLite
    from tmr_tpu_torch.utils.metrics import _load_by_image

    g, p, _, _ = _load_by_image(log_path, stage)
    ev = COCOEvalLite(g, p).run()
    rec = ev.rec_thrs
    fig, ax = plt.subplots(figsize=(6, 5))
    for ti, thr in enumerate(ev.iou_thrs):
        if not any(np.isclose(thr, t) for t in (0.5, 0.75, 0.95)):
            continue
        pr = ev.precision[ti, :, 0, -1]
        pr = np.where(pr >= 0, pr, 0.0)
        ax.plot(rec, pr, label=f"IoU {thr:.2f}")
    ax.set_xlabel("recall")
    ax.set_ylabel("precision")
    ax.set_title(f"{stage} PR curves")
    ax.legend()
    out_dir = os.path.join(log_path, "visualizations", stage)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "pr_curves.png")
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)
    return path


def save_presence_maps(objectness_maps, out_dir: str, step: int,
                       prefix: str = "presence") -> List[str]:
    """Objectness heat maps (trainer.py:155-170): each level's logits through a sigmoid,
    the first image of a batch, as grayscale PNGs ``{prefix}_step{step}_lvl{level}.png``."""
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for lvl, m in enumerate(objectness_maps):
        arr = np.asarray(m, np.float32)
        if arr.ndim == 3:  # (B, H, W) -> the first image
            arr = arr[0]
        arr = 1.0 / (1.0 + np.exp(-arr))
        img = (arr * 255).clip(0, 255).astype(np.uint8)
        path = os.path.join(out_dir, f"{prefix}_step{step}_lvl{lvl}.png")
        _write_png(path, img)
        written.append(path)
    return written
