"""Minimal COCO annotation index (counterpart of ``tmr_tpu/data/coco_index.py``): the
read paths the reference takes from ``pycocotools.coco.COCO`` (imgs, getImgIds,
getAnnIds, loadAnns), without pycocotools."""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, List


class COCOIndex:
    def __init__(self, annotation_file: str):
        with open(annotation_file) as f:
            data = json.load(f)
        self.dataset = data
        self.imgs: Dict[object, dict] = {im["id"]: im for im in data.get("images", [])}
        self.anns: Dict[object, dict] = {a["id"]: a for a in data.get("annotations", [])}
        self._img_to_anns: Dict[object, List[dict]] = defaultdict(list)
        for a in data.get("annotations", []):
            self._img_to_anns[a["image_id"]].append(a)

    def get_img_ids(self) -> list:
        return list(self.imgs.keys())

    def get_ann_ids(self, img_ids) -> list:
        out = []
        for i in img_ids:
            out.extend(a["id"] for a in self._img_to_anns.get(i, []))
        return out

    def load_anns(self, ann_ids) -> list:
        return [self.anns[i] for i in ann_ids]

    def anns_for_image(self, img_id) -> list:
        return list(self._img_to_anns.get(img_id, []))
