"""Eval metrics (counterpart of ``tmr_tpu/utils/metrics.py``; reference
utils/log_utils.py without pycocotools).

The reference's filesystem protocol: per-image JSONs, merged into COCO-style instances
and predictions files, from which every metric is computed (log_utils.py:21-52,
214-309, 110-205):

  {logpath}/logged_datas/{stage}/{img_id}.json   per-image dumps
  {logpath}/instances_{stage}.json               merged GT (COCO layout)
  {logpath}/predictions_{stage}.json             merged predictions (COCO layout)

AP comes from :class:`COCOEvalLite` with maxDets [900, 1000, 1100].
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Dict, List, Sequence

import numpy as np

from tmr_tpu_torch.utils.coco_eval import COCOEvalLite

IMG_LOG_PATH = "logged_datas"
GTS_NAME_FORMAT = "instances"
PRED_NAME_FORMAT = "predictions"


def image_info_collector(
    log_path: str,
    stage: str,
    batch_meta: List[dict],
    detections: List[dict],
) -> None:
    """Per-image JSON dump (log_utils.py:21-52).

    batch_meta: per image {img_name, img_url, img_id, img_size (w, h),
    orig_boxes (N, 4) xyxy px, orig_exemplars (K, 4) xyxy px}.
    detections: per image {boxes (D, 4) normalized xyxy, scores (D,),
    refs (D, 2) normalized} — the Predictor's ragged output.
    """
    out_dir = os.path.join(log_path, IMG_LOG_PATH, stage)
    os.makedirs(out_dir, exist_ok=True)

    for meta, det in zip(batch_meta, detections):
        w, h = meta["img_size"]
        orig_boxes = np.asarray(meta["orig_boxes"], np.float64).reshape(-1, 4)
        orig_ex = np.asarray(meta["orig_exemplars"], np.float64).reshape(-1, 4)
        gt_xywh = np.concatenate(
            [orig_boxes[:, :2], orig_boxes[:, 2:] - orig_boxes[:, :2]], axis=1
        )
        ex_xywh = np.concatenate(
            [orig_ex[:, :2], orig_ex[:, 2:] - orig_ex[:, :2]], axis=1
        )

        boxes = np.asarray(det["boxes"], np.float64).reshape(-1, 4).copy()
        boxes[:, [0, 2]] *= w
        boxes[:, [1, 3]] *= h
        boxes = np.round(boxes).astype(int)
        bxywh = np.concatenate([boxes[:, :2], boxes[:, 2:] - boxes[:, :2]], axis=1)

        refs = np.asarray(det["refs"], np.float64).reshape(-1, 2).copy()
        refs[:, 0] *= w
        refs[:, 1] *= h
        refs = np.round(refs).astype(int)

        scores = np.asarray(det["scores"], np.float64).reshape(-1)
        # reference stores two-class logits [p, 0] (TM_utils.py:260-261)
        logits = [[float(s), 0.0] for s in scores]
        if len(scores) == 0:
            # reference parity: Get_pred_boxes emits a degenerate dummy
            # detection for empty images (TM_utils.py:288-291), which counts
            # as 1 prediction in MAE and a score-0 entry in AP.
            bxywh = np.zeros((1, 4), int)
            refs = np.zeros((1, 2), int)
            logits = [[0.0, 0.0]]

        with open(os.path.join(out_dir, f"{meta['img_id']}.json"), "w") as f:
            json.dump(
                {
                    "img_name": meta["img_name"],
                    "img_url": meta.get("img_url", ""),
                    "img_id": meta["img_id"],
                    "img_size": [int(w), int(h)],
                    "orig_boxes": np.round(gt_xywh).astype(int).tolist(),
                    "orig_exemplars": np.round(ex_xywh).astype(int).tolist(),
                    "logits": logits,
                    "bboxes": bxywh.tolist(),
                    "points": refs.tolist(),
                },
                f,
                indent=4,
            )


def coco_style_annotation_generator(log_path: str, stage: str) -> None:
    """Merge per-image JSONs into COCO-style gts/preds (log_utils.py:214-309)."""
    img_dir = os.path.join(log_path, IMG_LOG_PATH, stage)
    files = sorted(os.listdir(img_dir))

    predictions = {"categories": [{"name": "fg", "id": 1}], "images": [],
                   "annotations": []}
    gts = {"categories": [{"name": "fg", "id": 1}], "images": [],
           "annotations": []}
    pred_anno_id = 1
    gt_anno_id = 1

    for name in files:
        with open(os.path.join(img_dir, name)) as f:
            d = json.load(f)
        img_info = {
            "id": d["img_id"],
            "height": d["img_size"][1],
            "width": d["img_size"][0],
            "file_name": d["img_name"],
            "img_url": d["img_url"],
            "exemplar_boxes": d["orig_exemplars"],
        }
        for x, y, w, h in d["orig_boxes"]:
            gts["annotations"].append(
                {"id": gt_anno_id, "image_id": img_info["id"],
                 "area": int(w * h), "iscrowd": 0,
                 "bbox": [int(x), int(y), int(w), int(h)], "category_id": 1}
            )
            gt_anno_id += 1
        gts["images"].append(img_info)

        for logit, (x, y, w, h), (cx, cy) in zip(
            d["logits"], d["bboxes"], d["points"]
        ):
            predictions["annotations"].append(
                {"id": pred_anno_id, "image_id": img_info["id"],
                 "area": int(w * h),
                 "bbox": [int(x), int(y), int(w), int(h)], "category_id": 1,
                 "score": float(logit[0]), "point": [int(cx), int(cy)]}
            )
            pred_anno_id += 1
        predictions["images"].append(img_info)

    if len(predictions["annotations"]) == 0 and predictions["images"]:
        predictions["annotations"].append(
            {"id": pred_anno_id, "image_id": predictions["images"][0]["id"],
             "area": 0, "bbox": [0, 0, 0, 0], "category_id": 1,
             "score": 0.0, "point": [0, 0]}
        )

    with open(os.path.join(log_path, f"{GTS_NAME_FORMAT}_{stage}.json"), "w") as f:
        json.dump(gts, f, indent=4)
    with open(os.path.join(log_path, f"{PRED_NAME_FORMAT}_{stage}.json"), "w") as f:
        json.dump(predictions, f, indent=4)


def _load_by_image(log_path: str, stage: str):
    with open(os.path.join(log_path, f"{GTS_NAME_FORMAT}_{stage}.json")) as f:
        gts = json.load(f)
    with open(os.path.join(log_path, f"{PRED_NAME_FORMAT}_{stage}.json")) as f:
        preds = json.load(f)
    img_ids = [im["id"] for im in preds["images"]]
    g: Dict[object, list] = {i: [] for i in img_ids}
    p: Dict[object, list] = {i: [] for i in img_ids}
    for a in gts["annotations"]:
        g.setdefault(a["image_id"], []).append(a)
    for a in preds["annotations"]:
        p.setdefault(a["image_id"], []).append(a)
    names = {im["id"]: im["file_name"] for im in preds["images"]}
    return g, p, img_ids, names


def get_mae_rmse(log_path: str, stage: str):
    """Counting metrics by annotation-count diff (log_utils.py:110-136)."""
    g, p, img_ids, names = _load_by_image(log_path, stage)
    error, squared = 0.0, 0.0
    lines = []
    for i in img_ids:
        ng, np_ = len(g.get(i, [])), len(p.get(i, []))
        error += abs(ng - np_)
        squared += (ng - np_) ** 2
        lines.append(f"{names[i]}\t\t{ng}\t\t{np_}\t\t{abs(ng - np_)}\t\t{(ng - np_) ** 2}")
    with open(os.path.join(log_path, f"MAE_RMSE_{stage}.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    n = max(len(img_ids), 1)
    return error / n, float(np.sqrt(squared / n))


def get_ap_scores(
    log_path: str, stage: str, max_dets: Sequence[int] = (900, 1000, 1100)
):
    """AP/AP50/AP75 x100 (log_utils.py:138-150)."""
    g, p, img_ids, _ = _load_by_image(log_path, stage)
    ev = COCOEvalLite(g, p, max_dets=max_dets).run()
    vals = [s * 100 if s >= 0 else 0.0 for s in ev.stats[:3]]
    return tuple(float(v) for v in vals)


def del_img_log_path(log_path: str, stage: str) -> None:
    p = os.path.join(log_path, IMG_LOG_PATH, stage)
    if os.path.exists(p):
        shutil.rmtree(p)
