"""``--visualize`` outputs of the port (``tmr_tpu_torch/utils/visualize.py``) on the CPU:
the per-image AP50 caption against the JAX function on seeded cases (exactly: both are the
same numpy steps), the triptychs' box pixels (positions, colours, line widths) and
caption, the presence maps, and the PR curves' absence without matplotlib.
``Trainer.test`` with ``visualize`` writing one triptych per image is
``tests/test_torch_eval.py::test_trainer_refuses_unported_options[visualize]``."""

import importlib.util
import json

import numpy as np
import pytest

from tmr_tpu.utils.visualize import per_image_ap50 as jax_per_image_ap50
from tmr_tpu_torch.utils import visualize as vis

H, W = 64, 96


def _boxes(rng, n):
    xy = rng.uniform(0, 40, (n, 2))
    return np.concatenate([xy, rng.uniform(3, 20, (n, 2))], 1)


@pytest.mark.parametrize("seed", range(6))
def test_per_image_ap50_matches_jax(seed):
    rng = np.random.default_rng(seed)
    gt = _boxes(rng, int(rng.integers(1, 9)))
    # predictions near some GT boxes, some far, in random score order
    near = gt[rng.integers(0, len(gt), 5)] + rng.normal(0, 2, (5, 4))
    pred = np.concatenate([near, _boxes(rng, 4)])
    scores = rng.random(len(pred))
    assert vis.per_image_ap50(gt, pred, scores) == jax_per_image_ap50(gt, pred, scores)


@pytest.mark.parametrize("case", ["no_gt_no_pred", "no_gt", "no_pred", "exact"])
def test_per_image_ap50_edges_match_jax(case):
    gt = np.array([[4, 4, 10, 10], [30, 20, 8, 6]], np.float64)
    pred = {"no_gt_no_pred": np.zeros((0, 4)), "no_gt": gt, "no_pred": np.zeros((0, 4)),
            "exact": gt}[case]
    g = np.zeros((0, 4)) if case.startswith("no_gt") else gt
    scores = np.linspace(1, 0.5, len(pred))
    got = vis.per_image_ap50(g, pred, scores)
    assert got == jax_per_image_ap50(g, pred, scores)
    assert got == pytest.approx({"no_gt_no_pred": 100.0, "no_gt": 0.0, "no_pred": 0.0,
                                 "exact": 100.0}[case])


def test_draw_xywh_outline_inside_the_corners():
    img = np.zeros((H, W, 3), np.uint8)
    vis._draw_xywh(img, [[10.7, 5.2, 20, 12]], (1, 2, 3), 2)
    x0, y0, x1, y1 = 10, 5, 30, 17  # int(x), int(y), int(x + w), int(y + h)
    mask = np.zeros((H, W), bool)
    mask[y0:y1 + 1, x0:x1 + 1] = True
    mask[y0 + 2:y1 - 1, x0 + 2:x1 - 1] = False
    assert (img[mask] == (1, 2, 3)).all()
    assert (img[~mask] == 0).all()


def test_draw_xywh_clips_and_takes_degenerate_boxes():
    img = np.zeros((H, W, 3), np.uint8)
    vis._draw_xywh(img, [[-5, -5, 12, 12], [60, 40, 30, 30], [20, 20, 0, 0]], (9, 9, 9), 3)
    assert (img[5:8, 0:8] == 9).all() and (img[0:8, 5:8] == 9).all()
    assert (img[0:5, 0:5] == 0).all() and (img[8:, :5] == 0).all()
    assert (img[40:43, 60:91] == 9).all() and (img[43:, 60:63] == 9).all()
    assert (img[43:, 88:91] == 9).all() and (img[43:, 63:88] == 0).all()
    assert (img[20, 20] == 9).all() and img[19:22, 19:22].sum() == 27


def _write_merged(tmp_path, stage="test"):
    """Merged COCO-style files of two images (one GT box, an exemplar, two predictions)."""
    gts = {"images": [], "annotations": [
        {"id": 1, "image_id": 0, "bbox": [5, 34, 12, 10], "category_id": 1},
        {"id": 2, "image_id": 1, "bbox": [30, 50, 10, 8], "category_id": 1}]}
    preds = {"images": [
        {"id": 0, "file_name": "a.jpg", "img_url": "missing/a.jpg",
         "exemplar_boxes": [[60, 40, 8, 8]]},
        {"id": 1, "file_name": "dir/b.png", "img_url": "missing/b.png"}],
        "annotations": [
            {"id": 1, "image_id": 0, "bbox": [5, 34, 12, 10], "score": 0.9,
             "category_id": 1},
            {"id": 2, "image_id": 0, "bbox": [40, 30, 10, 10], "score": 0.5,
             "category_id": 1}]}
    (tmp_path / f"instances_{stage}.json").write_text(json.dumps(gts))
    (tmp_path / f"predictions_{stage}.json").write_text(json.dumps(preds))


def test_save_triptychs_draws_the_boxes_and_caption(tmp_path):
    Image = pytest.importorskip("PIL.Image")
    _write_merged(tmp_path)
    base = np.full((H, W, 3), 7, np.uint8)
    paths = vis.save_triptychs(str(tmp_path), "test", image_loader=lambda info: base)
    out = tmp_path / "visualizations" / "test"
    assert [p for p in paths] == [str(out / "a_triptych.png"), str(out / "b_triptych.png")]
    with Image.open(paths[0]) as im:
        trip = np.asarray(im.convert("RGB"))
    assert trip.shape == (H, 3 * W, 3)
    gt, ex, pd = vis.GT_COLOR, vis.EX_COLOR, vis.PRED_COLOR
    # panel 0: GT (width 2) and the exemplar (width 3); panel 1: predictions; panel 2:
    # GT, then the predictions over it; the boxes lie below the caption
    assert (trip[44, 5] == gt).all() and (trip[44, 6] == gt).all()
    assert (trip[43, 6] == gt).all() and (trip[39, 11] == 7).all()
    assert (trip[48, 65] == ex).all() and (trip[40, 62] == ex).all()
    assert (trip[44, 64] == 7).all() and (trip[45, 62] == ex).all()
    assert (trip[44, W + 5] == pd).all() and (trip[35, W + 40] == pd).all()
    assert (trip[45, W + 61] == 7).all()  # no exemplar on the prediction panel
    assert (trip[44, 2 * W + 10] == pd).all()  # the prediction covers the equal GT box
    assert (trip[34, 2 * W + 17] == pd).all() and (trip[54, 2 * W + 30] == 7).all()
    # the caption: above its baseline, right of its left end, in the caption colour
    # blended into the image (antialiased: red = green above the image's 7, blue below)
    changed = (trip[:30] != 7).any(-1)
    ys, xs = np.nonzero(changed)
    assert len(ys) > 20 and ys.max() <= vis.CAPTION_XY[1] and xs.min() >= vis.CAPTION_XY[0]
    px = trip[:30][changed].astype(int)
    assert (px[:, 0] == px[:, 1]).all() and (px[:, 0] > 7).all() and (px[:, 2] <= 7).all()


def test_save_triptychs_skips_images_it_cannot_read(tmp_path):
    pytest.importorskip("PIL.Image")
    _write_merged(tmp_path)
    assert vis.save_triptychs(str(tmp_path), "test") == []  # the img_urls do not exist

    def loader(info):
        if info["id"] == 0:
            raise OSError("unreadable")
        return np.zeros((H, W, 3), np.uint8)

    paths = vis.save_triptychs(str(tmp_path), "test", image_loader=loader)
    assert [p.rsplit("/", 1)[-1] for p in paths] == ["b_triptych.png"]
    assert len(vis.save_triptychs(str(tmp_path), "test", max_images=1,
                                  image_loader=lambda info: np.zeros((H, W, 3)))) == 1


def test_save_presence_maps_writes_sigmoid_grayscale(tmp_path):
    Image = pytest.importorskip("PIL.Image")
    logits = np.array([[[-50.0, 0.0], [50.0, np.log(3.0)]]], np.float32)
    paths = vis.save_presence_maps([logits, logits[0] * 0], str(tmp_path), 7)
    assert [p.rsplit("/", 1)[-1] for p in paths] == ["presence_step7_lvl0.png",
                                                     "presence_step7_lvl1.png"]
    with Image.open(paths[0]) as im:
        assert im.mode == "L"
        np.testing.assert_array_equal(np.asarray(im), [[0, 127], [255, 191]])


def test_plot_pr_curves_needs_matplotlib(tmp_path):
    _write_merged(tmp_path)
    got = vis.plot_pr_curves(str(tmp_path), "test")
    if importlib.util.find_spec("matplotlib") is None:
        assert got is None
    else:
        assert got == str(tmp_path / "visualizations" / "test" / "pr_curves.png")
