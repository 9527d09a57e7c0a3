"""Dataset readers (counterpart of ``tmr_tpu/data/datasets.py``; reference
datamodules/datasets/*).

Each item is the JAX package's dict: the NHWC normalized image, [0, 1]-normalized boxes
and exemplars, and the metadata the eval logs. The <25 px small-object escape hatch
picks the 1536 bucket at eval (:func:`transforms.pick_image_size`). Decoding is one
method, :meth:`_Base.decode`, which returns an (H, W, 3) uint8 RGB array; it is the one
place that imports PIL, so a subclass that makes its images in memory needs no image
library at all.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Optional

import numpy as np

from tmr_tpu_torch.data.coco_index import COCOIndex
from tmr_tpu_torch.data.transforms import pick_image_size, resize_normalize


def _load_json(path):
    with open(path) as f:
        return json.load(f)


def _xywh_to_xyxy(anns) -> np.ndarray:
    """COCO ``bbox`` [x, y, w, h] -> integer-truncated xyxy pixel boxes (N, 4) f32."""
    return np.array([[int(a["bbox"][0]), int(a["bbox"][1]),
                      int(a["bbox"][0] + a["bbox"][2]), int(a["bbox"][1] + a["bbox"][3])]
                     for a in anns], np.float32).reshape(-1, 4)


class _Base:
    """Shared per-item pipeline: decode -> normalize boxes -> size bucket ->
    resize + normalize -> item dict."""

    def __init__(self, image_size: int = 1024, max_exemplars: int = 1,
                 split: str = "train", eval_mode: bool = False):
        self.image_size = image_size
        self.max_exemplars = max_exemplars
        self.split = split
        self.eval_mode = eval_mode

    def decode(self, img_url: str) -> np.ndarray:
        """The image at ``img_url`` as an (H, W, 3) uint8 RGB array."""
        from PIL import Image

        with Image.open(img_url) as im:
            return np.asarray(im.convert("RGB"))

    def _item(self, idx, img_name, img_url, image: np.ndarray, bboxes, exemplars):
        img_h, img_w = image.shape[:2]
        img_res = np.array([img_w, img_h, img_w, img_h], np.float32)
        size = pick_image_size(bboxes, base=self.image_size, eval_mode=self.eval_mode,
                               split=self.split)
        return {
            "image": resize_normalize(image, size),  # (S, S, 3) float32 NHWC
            "boxes": (bboxes / img_res[None, :]).astype(np.float32),
            "exemplars": (exemplars / img_res[None, :]).astype(np.float32),
            "img_name": img_name,
            "img_url": img_url,
            "img_id": idx,
            "img_size": np.array([img_w, img_h]),
            "orig_boxes": bboxes,
            "orig_exemplars": exemplars,
        }


class FSCD147Dataset(_Base):
    """FSC-147 exemplar json + COCO instance annotations + split json
    (reference FSCD147.py:12-173)."""

    def __init__(self, root: str, split: str = "val", **kw):
        super().__init__(split=split, **kw)
        inst = {"train": "instances_train.json", "val": "instances_val.json",
                "test": "instances_test.json"}[split]
        self.im_dir = os.path.join(root, "images_384_VarV2")
        self.annotations = _load_json(
            os.path.join(root, "annotations", "annotation_FSC147_384.json"))
        self.data_split = _load_json(
            os.path.join(root, "annotations", "Train_Test_Val_FSC_147.json"))[split]
        self.instances = COCOIndex(os.path.join(root, "annotations", inst))
        self.name_to_id = {v["file_name"]: v["id"] for v in self.instances.imgs.values()}
        if self.max_exemplars > 3:
            raise ValueError("FSCD147 has maximum 3 exemplars per image")

    def __len__(self):
        return len(self.data_split)

    def __getitem__(self, idx):
        img_name = self.data_split[idx]
        img_url = os.path.join(self.im_dir, img_name)
        bboxes = _xywh_to_xyxy(self.instances.anns_for_image(self.name_to_id[img_name]))
        # corner-list layout of FSCD147.py:85-90
        ex = [[box[0][0], box[0][1], box[2][0], box[2][1]] for box in
              self.annotations[img_name]["box_examples_coordinates"][:self.max_exemplars]]
        exemplars = np.array(ex, np.float32).reshape(-1, 4)
        return self._item(idx, img_name, img_url, self.decode(img_url), bboxes, exemplars)


class FSCDLVISDataset(_Base):
    """FSCD-LVIS with seen/unseen split selection (reference FSCD_LVIS.py:12-183)."""

    def __init__(self, root: str, split: str = "train", unseen: bool = False, **kw):
        super().__init__(split=split, **kw)
        pre = "unseen_" if unseen else ""
        part = "train" if split == "train" else "test"
        self.im_dir = os.path.join(root, "images")
        self.instances = COCOIndex(
            os.path.join(root, "annotations", f"{pre}instances_{part}.json"))
        counts = _load_json(os.path.join(root, "annotations", f"{pre}count_{part}.json"))
        # label_organizer (FSCD_LVIS.py:58-77): join images and annotations by id
        lib = {im["id"]: dict(im) for im in counts["images"]}
        for a in counts["annotations"]:
            lib[a["id"]].update(boxes=a["boxes"], points=a.get("points"),
                                image_id=a["image_id"])
        self.count_anno = {v["image_id"]: v for v in lib.values() if "image_id" in v}
        self.image_ids = self.instances.get_img_ids()

    def __len__(self):
        return len(self.image_ids)

    def __getitem__(self, idx):
        img_id = self.image_ids[idx]
        anno = self.count_anno[img_id]
        img_name = anno["file_name"]
        img_url = os.path.join(self.im_dir, img_name)
        bboxes = _xywh_to_xyxy(self.instances.anns_for_image(img_id))
        exemplars = np.array([[int(x), int(y), int(x + w), int(y + h)]
                              for x, y, w, h in anno["boxes"][:self.max_exemplars]],
                             np.float32).reshape(-1, 4)
        return self._item(idx, img_name, img_url, self.decode(img_url), bboxes, exemplars)


class RPINEDataset(_Base):
    """RPINE: txt label files + exemplars.json, extension-sniffing image lookup
    (reference RPINE.py:11-148)."""

    def __init__(self, root: str, split: str = "test", **kw):
        super().__init__(split=split, **kw)
        self.image_path = os.path.join(root, "images")
        self.labels = sorted(glob.glob(os.path.join(root, "labels", "*")))
        self.exemplars_dict = _load_json(os.path.join(root, "exemplars.json"))

    def __len__(self):
        return len(self.labels)

    def _img_url(self, img_name):
        for ext in (".jpg", ".jpeg", ".png"):
            p = os.path.join(self.image_path, img_name + ext)
            if os.path.exists(p):
                return p
        return os.path.join(self.image_path, img_name)

    def __getitem__(self, idx):
        label_file = self.labels[idx]
        img_name = os.path.basename(label_file).split(".")[0]
        img_url = self._img_url(img_name)
        rows = []
        with open(label_file) as f:
            for line in f:
                parts = line.split()
                if len(parts) == 4:
                    rows.append([int(v) for v in parts])
        bboxes = np.array(rows, np.float32).reshape(-1, 4)
        ex = self.exemplars_dict[img_name][:self.max_exemplars]
        exemplars = np.array(ex, np.float32).reshape(-1, 4)
        return self._item(idx, img_name, img_url, self.decode(img_url), bboxes, exemplars)


def build_dataset(cfg, split: str, eval_mode: Optional[bool] = None):
    """Dataset registry (reference datamodules/__init__.py:3-20), with the reference's
    spellings of the FSCD-LVIS names (``FSCD_LVIS_seen``/``FSCD_LVIS_unseen``)."""
    eval_mode = cfg.eval if eval_mode is None else eval_mode
    kw = dict(image_size=cfg.image_size, max_exemplars=cfg.num_exemplars,
              eval_mode=eval_mode)
    name = {"FSCD_LVIS_seen": "FSCD_LVIS_Seen",
            "FSCD_LVIS_unseen": "FSCD_LVIS_Unseen"}.get(cfg.dataset, cfg.dataset)
    if name == "FSCD147":
        return FSCD147Dataset(cfg.datapath, split=split, **kw)
    if name == "FSCD_LVIS_Seen":
        return FSCDLVISDataset(cfg.datapath, split=split, unseen=False, **kw)
    if name == "FSCD_LVIS_Unseen":
        return FSCDLVISDataset(cfg.datapath, split=split, unseen=True, **kw)
    if name == "RPINE":
        sub = "train" if split == "train" else "val"
        return RPINEDataset(os.path.join(cfg.datapath, sub),
                            split="train" if split == "train" else "test", **kw)
    raise KeyError(f"unknown dataset {name!r}")
