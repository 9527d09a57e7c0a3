"""Single-category COCO-style AP evaluation in numpy (counterpart of
``tmr_tpu/utils/coco_eval.py``, kept as its own copy: the port imports nothing of the JAX
package).

The COCOeval algorithm without pycocotools, for the single-foreground-category task the
reference evaluates (log_utils.py:192-197, COCOevalMaxDets with maxDets [900, 1000,
1100]): IoU on xywh boxes; detections sorted by score (stable) and cut at maxDet; per
IoU threshold each detection greedily takes the best still-unmatched GT with IoU >= the
threshold, equal IoUs going to the last qualifying GT as in cocoeval.py; GTs outside
the area range are ignored, and so are unmatched detections outside it; precision made
non-increasing and sampled at 101 recall points; ``stats[0:3]`` = AP, AP50, AP75.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

AREA_RNG = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}
AREA_LBL = ("all", "small", "medium", "large")


def iou_xywh(dets: np.ndarray, gts: np.ndarray) -> np.ndarray:
    """(D, 4) x (G, 4) xywh -> (D, G) IoU (maskUtils.iou, iscrowd=0)."""
    if len(dets) == 0 or len(gts) == 0:
        return np.zeros((len(dets), len(gts)))
    dx1, dy1 = dets[:, 0], dets[:, 1]
    dx2, dy2 = dets[:, 0] + dets[:, 2], dets[:, 1] + dets[:, 3]
    gx1, gy1 = gts[:, 0], gts[:, 1]
    gx2, gy2 = gts[:, 0] + gts[:, 2], gts[:, 1] + gts[:, 3]
    ix = np.clip(
        np.minimum(dx2[:, None], gx2[None]) - np.maximum(dx1[:, None], gx1[None]),
        0, None,
    )
    iy = np.clip(
        np.minimum(dy2[:, None], gy2[None]) - np.maximum(dy1[:, None], gy1[None]),
        0, None,
    )
    inter = ix * iy
    union = (dets[:, 2] * dets[:, 3])[:, None] + (gts[:, 2] * gts[:, 3])[None] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


class COCOEvalLite:
    """gts/preds: {img_id: list of dicts}. GT dicts carry 'bbox' (xywh) and
    optionally 'area'; pred dicts carry 'bbox' and 'score'."""

    def __init__(
        self,
        gts: Dict[object, List[dict]],
        preds: Dict[object, List[dict]],
        max_dets: Sequence[int] = (900, 1000, 1100),
    ):
        self.img_ids = sorted(set(gts) | set(preds), key=str)
        self.gts = {i: gts.get(i, []) for i in self.img_ids}
        self.preds = {i: preds.get(i, []) for i in self.img_ids}
        self.max_dets = list(max_dets)
        self.iou_thrs = np.linspace(0.5, 0.95, 10)
        self.rec_thrs = np.linspace(0.0, 1.0, 101)
        self.eval_imgs = None
        self.precision = None
        self.recall = None
        self.stats = None

    # ------------------------------------------------------------- evaluate
    def _evaluate_img(self, img_id, area_lbl: str, max_det: int):
        gts = self.gts[img_id]
        preds = self.preds[img_id]
        if len(gts) == 0 and len(preds) == 0:
            return None
        lo, hi = AREA_RNG[area_lbl]

        g_boxes = np.array([g["bbox"] for g in gts], np.float64).reshape(-1, 4)
        g_area = np.array(
            [g.get("area", g["bbox"][2] * g["bbox"][3]) for g in gts], np.float64
        )
        gt_ig = (g_area < lo) | (g_area > hi)

        d_scores = np.array([d["score"] for d in preds], np.float64)
        d_order = np.argsort(-d_scores, kind="mergesort")[:max_det]
        d_boxes = np.array([preds[i]["bbox"] for i in d_order], np.float64).reshape(
            -1, 4
        )
        d_scores = d_scores[d_order]

        g_order = np.argsort(gt_ig, kind="mergesort")  # non-ignored first
        g_boxes = g_boxes[g_order]
        gt_ig = gt_ig[g_order]

        ious = iou_xywh(d_boxes, g_boxes)

        T = len(self.iou_thrs)
        D = len(d_boxes)
        G = len(g_boxes)
        dtm = np.zeros((T, D), np.int64)  # 1 + matched gt index, 0 = none
        gtm = np.zeros((T, G), np.int64)
        dt_ig = np.zeros((T, D), bool)
        # Greedy matching, vectorized over (thresholds x gts) with one loop
        # over detections (the det loop is inherently sequential — each
        # match consumes a gt). Replicates cocoeval.py's scan EXACTLY:
        # candidates need iou >= min(t, 1-1e-10); the running `iou < best:
        # continue` update means equal IoUs hand the match to the LAST
        # qualifying gt; gts are sorted non-ignored-first and the scan
        # breaks on entering the ignored section with a real match in hand,
        # so ignored gts are a fallback tier, not competitors.
        if D and G:
            t_eff = np.minimum(self.iou_thrs, 1.0 - 1e-10)  # (T,)
            ig_row = gt_ig[None, :]  # (1, G)
            any_ig = bool(gt_ig.any())
            for d in range(D):
                cand = np.broadcast_to(ious[d][None, :], (T, G))
                avail = gtm == 0
                # tier A: non-ignored unmatched gts
                a = np.where(avail & ~ig_row, cand, -1.0)
                a_max = a.max(axis=1)
                a_m = G - 1 - np.argmax(a[:, ::-1], axis=1)  # last-tie-wins
                use_a = a_max >= t_eff
                if any_ig:
                    # tier B: ignored unmatched gts (only when A found none)
                    b = np.where(avail & ig_row, cand, -1.0)
                    b_max = b.max(axis=1)
                    b_m = G - 1 - np.argmax(b[:, ::-1], axis=1)
                    use_b = ~use_a & (b_max >= t_eff)
                    m = np.where(use_a, a_m, np.where(use_b, b_m, -1))
                else:
                    m = np.where(use_a, a_m, -1)
                rows = np.nonzero(m >= 0)[0]
                if rows.size:
                    mg = m[rows]
                    dtm[rows, d] = mg + 1
                    gtm[rows, mg] = d + 1
                    dt_ig[rows, d] = gt_ig[mg]
        # unmatched dets outside the area range are ignored
        d_area = d_boxes[:, 2] * d_boxes[:, 3]
        out_rng = (d_area < lo) | (d_area > hi)
        dt_ig = dt_ig | ((dtm == 0) & out_rng[None, :])

        return {
            "dt_matches": dtm,
            "dt_ignore": dt_ig,
            "dt_scores": d_scores,
            "num_gt": int((~gt_ig).sum()),
        }

    # ----------------------------------------------------------- accumulate
    def accumulate(self):
        T = len(self.iou_thrs)
        R = len(self.rec_thrs)
        A = len(AREA_LBL)
        M = len(self.max_dets)
        precision = -np.ones((T, R, 1, A, M))
        recall = -np.ones((T, 1, A, M))

        # evaluate at the largest maxDet once per area, truncate per M below
        per_area = {
            a: [self._evaluate_img(i, a, self.max_dets[-1]) for i in self.img_ids]
            for a in AREA_LBL
        }

        for ai, a in enumerate(AREA_LBL):
            imgs = [e for e in per_area[a] if e is not None]
            for mi, max_det in enumerate(self.max_dets):
                scores = np.concatenate(
                    [e["dt_scores"][:max_det] for e in imgs]
                ) if imgs else np.zeros(0)
                order = np.argsort(-scores, kind="mergesort")
                scores = scores[order]
                if imgs:
                    dtm = np.concatenate(
                        [e["dt_matches"][:, :max_det] for e in imgs], axis=1
                    )[:, order]
                    dt_ig = np.concatenate(
                        [e["dt_ignore"][:, :max_det] for e in imgs], axis=1
                    )[:, order]
                else:
                    dtm = np.zeros((T, 0), np.int64)
                    dt_ig = np.zeros((T, 0), bool)
                npig = sum(e["num_gt"] for e in imgs)
                if npig == 0:
                    continue
                tps = (dtm > 0) & ~dt_ig
                fps = (dtm == 0) & ~dt_ig
                tp_sum = np.cumsum(tps, axis=1).astype(np.float64)
                fp_sum = np.cumsum(fps, axis=1).astype(np.float64)
                for ti in range(T):
                    tp = tp_sum[ti]
                    fp = fp_sum[ti]
                    nd = len(tp)
                    rc = tp / npig
                    pr = tp / (fp + tp + np.spacing(1))
                    recall[ti, 0, ai, mi] = rc[-1] if nd else 0.0
                    q = np.zeros(R)
                    # right-to-left monotone envelope (the cocoeval.py
                    # backward loop) == reversed cumulative maximum
                    pr = np.maximum.accumulate(pr[::-1])[::-1]
                    inds = np.searchsorted(rc, self.rec_thrs, side="left")
                    ok = inds < nd
                    q[ok] = pr[inds[ok]]
                    precision[ti, :, 0, ai, mi] = q

        self.precision = precision
        self.recall = recall
        return self

    # ------------------------------------------------------------ summarize
    def _summarize(self, ap: int, iou_thr=None, area="all", max_det=None):
        max_det = max_det if max_det is not None else self.max_dets[-1]
        ai = AREA_LBL.index(area)
        mi = self.max_dets.index(max_det)
        if ap:
            s = self.precision
            if iou_thr is not None:
                s = s[np.where(np.isclose(self.iou_thrs, iou_thr))[0]]
            s = s[:, :, :, ai, mi]
        else:
            s = self.recall
            if iou_thr is not None:
                s = s[np.where(np.isclose(self.iou_thrs, iou_thr))[0]]
            s = s[:, :, ai, mi]
        valid = s[s > -1]
        return float(valid.mean()) if valid.size else -1.0

    def summarize(self):
        """stats layout of COCOevalMaxDets._summarizeDets (log_utils.py:423-438)."""
        md = self.max_dets
        self.stats = np.array(
            [
                self._summarize(1, max_det=md[2] if len(md) > 2 else md[-1]),
                self._summarize(1, iou_thr=0.5, max_det=md[-1]),
                self._summarize(1, iou_thr=0.75, max_det=md[-1]),
                self._summarize(1, area="small", max_det=md[-1]),
                self._summarize(1, area="medium", max_det=md[-1]),
                self._summarize(1, area="large", max_det=md[-1]),
                self._summarize(0, max_det=md[0]),
                self._summarize(0, max_det=md[min(1, len(md) - 1)]),
                self._summarize(0, max_det=md[-1]),
                self._summarize(0, area="small", max_det=md[-1]),
                self._summarize(0, area="medium", max_det=md[-1]),
                self._summarize(0, area="large", max_det=md[-1]),
            ]
        )
        return self.stats

    def run(self):
        self.accumulate()
        self.summarize()
        return self
