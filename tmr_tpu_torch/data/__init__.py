"""Datasets, preprocessing and host-side loading (counterpart of ``tmr_tpu/data``)."""

from tmr_tpu_torch.data.coco_index import COCOIndex  # noqa: F401
from tmr_tpu_torch.data.datasets import (  # noqa: F401
    FSCD147Dataset,
    FSCDLVISDataset,
    RPINEDataset,
    build_dataset,
)
from tmr_tpu_torch.data.loader import DataLoader, collate  # noqa: F401
from tmr_tpu_torch.data.transforms import normalize_image, resize_normalize  # noqa: F401
