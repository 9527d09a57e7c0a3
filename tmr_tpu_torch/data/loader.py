"""Host-side data loading (counterpart of ``tmr_tpu/data/loader.py``): seeded shuffling,
thread prefetch with a bounded submit-ahead window, padded collate.

Replaces the reference's torch DataLoader + custom_collate (datamodules/collate.py:3-21):
the collate pads GT boxes to a power-of-two capacity with a validity mask and exemplars
to ``max_exemplars``; metadata stays a Python list. Eval batches are shape-uniform:
items are grouped by their resolved image size (1024 or the 1536 escape hatch), and a
group flushes when it holds ``batch_size`` items, the rest at the end.
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np


def _gt_capacity(n: int, floor: int) -> int:
    """Smallest power-of-two multiple of ``floor`` (at least 1) holding ``n`` boxes. GT
    boxes are never truncated: a dropped box would turn a real object into negative
    supervision."""
    cap = max(1, floor)
    while cap < n:
        cap *= 2
    return cap


def collate(items: list, max_gt: int, max_exemplars: int) -> dict:
    b = len(items)
    image = np.stack([it["image"] for it in items])
    counts = [len(np.asarray(it["boxes"]).reshape(-1, 4)) for it in items]
    cap = _gt_capacity(max(counts, default=0), max_gt)
    gt_boxes = np.zeros((b, cap, 4), np.float32)
    gt_valid = np.zeros((b, cap), bool)
    exemplars = np.zeros((b, max_exemplars, 4), np.float32)
    for i, it in enumerate(items):
        boxes = np.asarray(it["boxes"], np.float32).reshape(-1, 4)
        gt_boxes[i, :len(boxes)] = boxes
        gt_valid[i, :len(boxes)] = True
        ex = np.asarray(it["exemplars"], np.float32).reshape(-1, 4)
        k = min(len(ex), max_exemplars)
        if k == 0:
            raise ValueError(f"item {it['img_name']} has no exemplars")
        exemplars[i, :k] = ex[:k]
        exemplars[i, k:] = ex[k - 1]  # the last exemplar repeated into the padding
    meta = [{k: it[k] for k in ("img_name", "img_url", "img_id", "img_size",
                                "orig_boxes", "orig_exemplars")} for it in items]
    return {"image": image, "exemplars": exemplars, "gt_boxes": gt_boxes,
            "gt_valid": gt_valid, "meta": meta}


class DataLoader:
    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False,
                 seed: int = 42, max_gt: int = 800, max_exemplars: int = 1,
                 num_workers: int = 4, drop_last: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.max_gt = max_gt
        self.max_exemplars = max_exemplars
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[dict]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            order = np.random.default_rng((self.seed, self.epoch)).permutation(n)
        # bounded submit-ahead: decoded images are MBs each, so at most two per worker
        # wait in the queue
        window = self.num_workers * 2
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            queue: deque = deque()
            idx_iter = iter(order.tolist())
            for idx in idx_iter:
                queue.append(pool.submit(self.dataset.__getitem__, idx))
                if len(queue) >= window:
                    break
            pending: dict = {}
            while queue:
                it = queue.popleft().result()
                nxt = next(idx_iter, None)
                if nxt is not None:
                    queue.append(pool.submit(self.dataset.__getitem__, nxt))
                size = it["image"].shape[0]
                pending.setdefault(size, []).append(it)
                if len(pending[size]) == self.batch_size:
                    yield collate(pending.pop(size), self.max_gt, self.max_exemplars)
            if not self.drop_last:
                for group in pending.values():
                    if group:
                        yield collate(group, self.max_gt, self.max_exemplars)
