"""The port's copy of the mask generator's helpers (``tmr_tpu_torch/sam_amg.py``) against
``tmr_tpu/sam_amg.py``, function by function, on numpy inputs from a seed (both are numpy
and scipy: the results are equal, arrays bit for bit); and the float ``INTER_LINEAR`` of
``data/transforms.resize_linear_f32`` against cv2 (bit for bit), which
``SamPredictor._to_original`` takes in place of cv2 on the card's machine."""

import numpy as np
import pytest

from tmr_tpu import sam_amg as j_amg
from tmr_tpu_torch import sam_amg
from tmr_tpu_torch.data.transforms import resize_linear_f32

RNG = np.random.default_rng(0)


def _equal(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def _masks(seed, n=4, h=23, w=31):
    rng = np.random.default_rng(seed)
    m = rng.random((n, h, w)) > 0.6
    m[0] = False
    m[1] = True
    return m


CASES = {
    "build_point_grid": lambda f: f.build_point_grid(5),
    "build_all_layer_point_grids": lambda f: f.build_all_layer_point_grids(8, 2, 2),
    "generate_crop_boxes": lambda f: f.generate_crop_boxes((600, 900), 2, 512 / 1500),
    "generate_crop_boxes_portrait": lambda f: f.generate_crop_boxes((700, 300), 1, 0.3),
    "uncrop_boxes_xyxy": lambda f: f.uncrop_boxes_xyxy(
        np.array([[1.0, 2.0, 3.0, 4.0]], np.float32), [10, 20, 50, 60]),
    "uncrop_points": lambda f: f.uncrop_points(np.array([[5.0, 6.0]], np.float32),
                                               [10, 20, 50, 60]),
    "uncrop_mask": lambda f: f.uncrop_mask(_masks(1)[2], [5, 7, 36, 30], 40, 50),
    "is_box_near_crop_edge": lambda f: f.is_box_near_crop_edge(
        np.array([[5.0, 5.0, 49.0, 30.0], [5.0, 5.0, 30.0, 30.0], [0.0, 0.0, 30.0, 30.0]],
                 np.float32), [0, 0, 50, 50], [0, 0, 100, 100], atol=5.0),
    "box_xyxy_to_xywh": lambda f: f.box_xyxy_to_xywh(np.array([3.0, 4.0, 10.0, 20.0])),
    "mask_to_rle": lambda f: [f.mask_to_rle(m) for m in _masks(2)],
    "rle_to_mask": lambda f: [f.rle_to_mask(j_amg.mask_to_rle(m)) for m in _masks(3)],
    "area_from_rle": lambda f: [f.area_from_rle(j_amg.mask_to_rle(m)) for m in _masks(4)],
    "remove_small_regions_holes": lambda f: f.remove_small_regions(_masks(5)[2], 4, "holes"),
    "remove_small_regions_islands": lambda f: f.remove_small_regions(_masks(5)[3], 4,
                                                                     "islands"),
    "calculate_stability_score": lambda f: f.calculate_stability_score(
        np.random.default_rng(6).standard_normal((3, 16, 16)).astype(np.float32), 0.0, 1.0),
    "cat_and_filter_records": lambda f: f.filter_records(
        f.cat_records({"a": np.arange(3), "b": ["x", "y", "z"]}, {},
                      {"a": np.arange(2), "b": ["u", "v"]}),
        np.array([True, False, True, True, False])),
    "batch_iterator": lambda f: list(f.batch_iterator(2, np.arange(5), list("abcde"))),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_helper_matches_jax(name):
    _equal(CASES[name](sam_amg), CASES[name](j_amg))


def test_coco_rle_needs_pycocotools():
    """Both import pycocotools inside the function and raise without it; with it, the
    compressed RLE."""
    rle = sam_amg.mask_to_rle(_masks(7)[2])
    try:
        import pycocotools  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError):
            sam_amg.coco_encode_rle(rle)
        with pytest.raises(ImportError):
            j_amg.coco_encode_rle(rle)
        return
    assert sam_amg.coco_encode_rle(rle) == j_amg.coco_encode_rle(rle)


@pytest.mark.parametrize("hw,out", [((576, 1024), (720, 1280)), ((43, 64), (85, 128)),
                                    ((100, 80), (37, 29)), ((64, 64), (32, 32)),
                                    ((10, 7), (33, 21)), ((32, 64), (32, 64))])
def test_float_resize_matches_cv2(hw, out):
    """Up, down, by exactly 2 and to the same size, on values of both signs."""
    cv2 = pytest.importorskip("cv2")
    x = (RNG.standard_normal(hw) * 5).astype(np.float32)
    want = cv2.resize(x, out[::-1], interpolation=cv2.INTER_LINEAR)
    got = resize_linear_f32(x, *out)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
