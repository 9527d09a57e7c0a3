"""The port's eval data path on the CPU against the JAX package's: the resize (held to
``cv2.resize`` itself), ``pick_image_size``, a dataset item, ``collate``, the loader's
batches, the synthetic fixture, ``COCOEvalLite`` and the metrics files.

Tolerances: the resize is held to cv2 bit for bit, within the stated limit of one grey
level (:data:`RESIZE_LIMIT`); everything else here is numpy on the same inputs and must
be equal."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

from tmr_tpu.data import datasets as j_datasets  # noqa: E402
from tmr_tpu.data import loader as j_loader  # noqa: E402
from tmr_tpu.data import transforms as j_transforms  # noqa: E402
from tmr_tpu.data.synthetic import write_synthetic_fscd147 as j_write  # noqa: E402
from tmr_tpu.utils import coco_eval as j_coco_eval  # noqa: E402
from tmr_tpu.utils import metrics as j_metrics  # noqa: E402
from tmr_tpu_torch.data import datasets, loader, transforms  # noqa: E402
from tmr_tpu_torch.data.synthetic import (synthetic_images,  # noqa: E402
                                          write_synthetic_fscd147)
from tmr_tpu_torch.utils import coco_eval, metrics  # noqa: E402

#: the most the port's resize may differ from cv2.resize on any pixel, in grey levels
#: (cv2 interpolates in 11-bit fixed point; the port does the same arithmetic, so it
#: meets the limit with 0)
RESIZE_LIMIT = 1


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    """Two JAX-written FSCD-147 fixtures at 128 px: 28-px objects (the 1024 bucket
    rule keeps the base size) and 10-px objects (under 25 px: the test split escalates
    to 1536)."""
    root = tmp_path_factory.mktemp("fscd")
    j_write(str(root / "big"), n_train=2, n_val=3, image_size=128, square=28, seed=0)
    j_write(str(root / "small"), n_train=1, n_val=2, image_size=128, square=10, seed=1)
    return root


@pytest.mark.parametrize("src_hw,size", [((384, 512), 1024), ((384, 512), 1536),
                                         ((900, 1200), 1024), ((7, 5), 64)])
def test_resize_matches_cv2(src_hw, size):
    rng = np.random.default_rng(sum(src_hw) + size)
    h, w = src_hw
    for img in (rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
                (np.sin(np.arange(h)[:, None, None] / 7.0) * 100 + 120
                 + np.cos(np.arange(w)[None, :, None] / 5.0) * 30
                 + np.arange(3)).astype(np.uint8)):
        want = cv2.resize(img, (size, size), interpolation=cv2.INTER_LINEAR)
        got = transforms.resize_linear_u8(img, size, size)
        assert got.dtype == np.uint8 and got.shape == want.shape
        assert np.abs(got.astype(int) - want.astype(int)).max() <= RESIZE_LIMIT
        np.testing.assert_array_equal(got, want)
        # normalized: the JAX package's cv2 path, bit for bit
        np.testing.assert_array_equal(transforms.resize_normalize(img, size),
                                      j_transforms.resize_normalize(img, size))


def test_normalize_image_matches_jax():
    rng = np.random.default_rng(3)
    for img in (rng.integers(0, 256, (9, 7, 3), dtype=np.uint8),
                rng.integers(0, 256, (9, 7), dtype=np.uint8),
                rng.integers(0, 256, (9, 7, 4), dtype=np.uint8),
                rng.random((5, 6, 3)).astype(np.float32)):
        np.testing.assert_array_equal(transforms.normalize_image(img),
                                      j_transforms.normalize_image(img))


@pytest.mark.parametrize("kw", [dict(eval_mode=True, split="test"),
                                dict(eval_mode=False, split="test"),
                                dict(eval_mode=True, split="val"),
                                dict(eval_mode=True, split="test", base=128)])
def test_pick_image_size_matches_jax(kw):
    cases = [np.zeros((0, 4), np.float32),
             np.array([[0, 0, 30, 30], [5, 5, 29, 40]], np.float32),  # 24 x 35: not both
             np.array([[0, 0, 30, 30], [5, 5, 29, 28]], np.float32),  # 24 x 23: escalate
             np.array([[0, 0, 25, 24]], np.float32),  # exactly 25 wide: base
             np.array([[3, 3, 27.5, 27.9]], np.float32)]
    for boxes in cases:
        assert transforms.pick_image_size(boxes, **kw) == j_transforms.pick_image_size(
            boxes, **kw)
    assert transforms.pick_image_size(cases[2], eval_mode=True, split="test") == 1536


def _assert_items_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert got[k] == want[k], k


@pytest.mark.parametrize("which,size", [("big", 128), ("small", 1536)])
def test_dataset_item_matches_jax(fixtures, which, size):
    """One FSCD-147 test item, eval mode, in both buckets: 10-px objects escalate the
    128-px image to the 1536 bucket (the resize, not a forward)."""
    kw = dict(split="test", image_size=128, max_exemplars=3, eval_mode=True)
    got = datasets.FSCD147Dataset(str(fixtures / which), **kw)[0]
    want = j_datasets.FSCD147Dataset(str(fixtures / which), **kw)[0]
    assert got["image"].shape == (size, size, 3)
    _assert_items_equal(got, want)


def test_build_dataset_names_match_jax(fixtures):
    from tmr_tpu.config import Config as JConfig
    from tmr_tpu_torch.config import Config

    for name in ("FSCD147",):
        kw = dict(dataset=name, datapath=str(fixtures / "big"), image_size=128,
                  num_exemplars=2, eval=True)
        got = datasets.build_dataset(Config(**kw), "test")
        want = j_datasets.build_dataset(JConfig(**kw), "test")
        assert type(got).__name__ == type(want).__name__
        assert len(got) == len(want) == 3
    with pytest.raises(KeyError):
        datasets.build_dataset(Config(dataset="nope"), "test")


class _Items:
    """A stand-in dataset of small items in two size buckets."""

    def __init__(self, n=7):
        rng = np.random.default_rng(5)
        self.items = []
        for i in range(n):
            s = 8 if i % 3 else 12
            nb = int(rng.integers(0, 5))
            self.items.append({
                "image": rng.standard_normal((s, s, 3)).astype(np.float32),
                "boxes": rng.random((nb, 4)).astype(np.float32),
                "exemplars": rng.random((1 + i % 3, 4)).astype(np.float32),
                "img_name": f"im{i}", "img_url": f"u{i}", "img_id": i,
                "img_size": np.array([s, s]), "orig_boxes": rng.random((nb, 4)),
                "orig_exemplars": rng.random((1 + i % 3, 4))})

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def _assert_batches_equal(got, want):
    assert set(got) == set(want)
    for k in ("image", "exemplars", "gt_boxes", "gt_valid"):
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert len(got["meta"]) == len(want["meta"])
    for a, b in zip(got["meta"], want["meta"]):
        _assert_items_equal(a, b)


@pytest.mark.parametrize("max_gt,max_ex", [(2, 1), (4, 3), (800, 2)])
def test_collate_matches_jax(max_gt, max_ex):
    items = _Items().items
    for group in (items[1:3], items[3:4], [items[i] for i in (1, 2, 4, 5)]):
        _assert_batches_equal(loader.collate(group, max_gt, max_ex),
                              j_loader.collate(group, max_gt, max_ex))
    for n in (0, 1, 3, 800, 801, 5000):
        assert loader._gt_capacity(n, max_gt) == j_loader._gt_capacity(n, max_gt)


@pytest.mark.parametrize("kw", [dict(batch_size=2), dict(batch_size=3, shuffle=True),
                                dict(batch_size=2, drop_last=True, shuffle=True,
                                     seed=7, num_workers=2)])
def test_loader_batches_match_jax(kw):
    """Size-bucket grouping, the ragged tails and the seeded order."""
    common = dict(max_gt=4, max_exemplars=2, num_workers=kw.pop("num_workers", 1))
    got_loader = loader.DataLoader(_Items(), **common, **kw)
    want_loader = j_loader.DataLoader(_Items(), **common, **kw)
    for epoch in (0, 1):
        got_loader.set_epoch(epoch)
        want_loader.set_epoch(epoch)
        got, want = list(got_loader), list(want_loader)
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            _assert_batches_equal(g, w)
    assert len(got_loader) == len(want_loader)


def test_loader_over_the_fixture_matches_jax(fixtures):
    kw = dict(split="test", image_size=128, max_exemplars=2, eval_mode=True)
    got = list(loader.DataLoader(datasets.FSCD147Dataset(str(fixtures / "big"), **kw),
                                 batch_size=2, max_exemplars=2))
    want = list(j_loader.DataLoader(j_datasets.FSCD147Dataset(str(fixtures / "big"), **kw),
                                    batch_size=2, max_exemplars=2))
    assert [b["image"].shape[0] for b in got] == [2, 1]
    for g, w in zip(got, want):
        _assert_batches_equal(g, w)


def test_synthetic_fixture_matches_jax_layout(tmp_path):
    """The port's fixture: the JAX fixture's annotations (names .png in place of .jpg),
    and lossless PNG images that decode to the drawn arrays."""
    from PIL import Image

    names = write_synthetic_fscd147(str(tmp_path / "port"), 2, 2, 64, 10, 3)
    j_names = j_write(str(tmp_path / "jax"), 2, 2, 64, 10, 3)
    assert names == [n.replace(".jpg", ".png") for n in j_names]
    for f in ("annotation_FSC147_384.json", "Train_Test_Val_FSC_147.json",
              "instances_test.json"):
        got = json.load(open(tmp_path / "port" / "annotations" / f))
        want = json.loads(open(tmp_path / "jax" / "annotations" / f).read()
                          .replace(".jpg", ".png"))
        assert got == want, f
    for name, (arr, _) in zip(names, synthetic_images(4, 64, 10, 3)):
        with Image.open(tmp_path / "port" / "images_384_VarV2" / name) as im:
            np.testing.assert_array_equal(np.asarray(im.convert("RGB")), arr)
    item = datasets.FSCD147Dataset(str(tmp_path / "port"), split="test", image_size=64,
                                   eval_mode=True)[0]
    assert item["image"].shape == (1536, 1536, 3)  # 10-px objects escalate


def _random_detections(rng, n_img):
    dets, meta = [], []
    for i in range(n_img):
        n_gt, n_det = int(rng.integers(0, 6)), int(rng.integers(0, 8))
        xy = rng.uniform(0, 80, (n_gt, 2))
        gt = np.concatenate([xy, xy + rng.uniform(5, 30, (n_gt, 2))], 1)
        # detections near the GT boxes, and some anywhere
        picks = gt[rng.integers(0, max(n_gt, 1), n_det)] if n_gt else np.zeros((n_det, 4))
        boxes = np.clip((picks + rng.normal(0, 3, (n_det, 4))) / 100.0, 0, 1)
        dets.append({"boxes": boxes.astype(np.float32),
                     "scores": rng.random(n_det).astype(np.float32),
                     "refs": rng.random((n_det, 2)).astype(np.float32)})
        meta.append({"img_name": f"im{i}.jpg", "img_url": f"/x/im{i}.jpg", "img_id": i,
                     "img_size": np.array([100, 100]), "orig_boxes": gt,
                     "orig_exemplars": gt[:1] if n_gt else np.zeros((0, 4))})
    return meta, dets


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_files_and_scores_match_jax(tmp_path, seed):
    """The per-image JSONs, the merged COCO files and AP/AP50/AP75/MAE/RMSE: equal."""
    meta, dets = _random_detections(np.random.default_rng(seed), 6)
    for mod, d in ((metrics, tmp_path / "port"), (j_metrics, tmp_path / "jax")):
        mod.image_info_collector(str(d), "test", meta[:4], dets[:4])
        mod.image_info_collector(str(d), "test", meta[4:], dets[4:])
        mod.coco_style_annotation_generator(str(d), "test")
    for f in sorted(os.listdir(tmp_path / "jax" / "logged_datas" / "test")) + [
            "../../instances_test.json", "../../predictions_test.json"]:
        got = open(tmp_path / "port" / "logged_datas" / "test" / f).read()
        assert got == open(tmp_path / "jax" / "logged_datas" / "test" / f).read(), f
    assert (metrics.get_mae_rmse(str(tmp_path / "port"), "test")
            == j_metrics.get_mae_rmse(str(tmp_path / "jax"), "test"))
    assert (metrics.get_ap_scores(str(tmp_path / "port"), "test")
            == j_metrics.get_ap_scores(str(tmp_path / "jax"), "test"))
    metrics.del_img_log_path(str(tmp_path / "port"), "test")
    assert not (tmp_path / "port" / "logged_datas" / "test").exists()


@pytest.mark.parametrize("max_dets", [(900, 1000, 1100), (1, 2, 3)])
def test_coco_eval_lite_matches_jax(max_dets):
    rng = np.random.default_rng(11)
    gts, preds = {}, {}
    for i in range(8):
        g = [{"bbox": rng.uniform(0, 120, 4).tolist(), "area": float(a)}
             for a in rng.uniform(0, 150 ** 2, int(rng.integers(0, 7)))]
        p = [{"bbox": (np.asarray(x["bbox"]) + rng.normal(0, 4, 4)).tolist(),
              "score": float(rng.random())} for x in g for _ in range(2)]
        p += [{"bbox": rng.uniform(0, 120, 4).tolist(), "score": float(rng.random())}
              for _ in range(int(rng.integers(0, 4)))]
        gts[i], preds[i] = g, p
    got = coco_eval.COCOEvalLite(gts, preds, max_dets=max_dets).run()
    want = j_coco_eval.COCOEvalLite(gts, preds, max_dets=max_dets).run()
    np.testing.assert_array_equal(got.stats, want.stats)
    np.testing.assert_array_equal(got.precision, want.precision)
    assert got.stats[0] > 0
