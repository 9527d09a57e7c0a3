"""Port heads and detection tail (decoder/heads, peaks, decode, greedy NMS through the
kernel's plain version, batched NMS, compaction) vs ``tmr_tpu`` on the same inputs.

NMS keep masks must be equal, ties included (identical boxes with tied scores, a pair
at IoU exactly the threshold, a suppression chain). Decoded scores/boxes: 1e-6 (the
same f32 arithmetic); convolutions: 1e-4 (f32 sums in another order)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tmr_tpu.models import heads as jheads  # noqa: E402
from tmr_tpu.ops import postprocess as jpost  # noqa: E402
from tmr_tpu.ops.nms import nms_keep_mask as j_nms  # noqa: E402
from tmr_tpu.ops.pallas_nms import nms_keep_mask_pallas  # noqa: E402
from tmr_tpu.ops.peaks import adaptive_kernel as j_adaptive  # noqa: E402
from tmr_tpu.ops.peaks import masked_maxpool3x3 as j_maxpool  # noqa: E402
from tmr_tpu_torch.models import heads  # noqa: E402
from tmr_tpu_torch.ops import cuda_nms, nms, peaks, postprocess  # noqa: E402
from tmr_tpu_torch.utils.weights import params_from_jax  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


def _boxes_with_ties(n, seed):
    """Dense random boxes plus planted ties: identical boxes with tied scores, a pair
    at IoU exactly 0.5, and a suppression chain a > b > c."""
    rng = np.random.default_rng(seed)
    cxy = rng.uniform(0.3, 0.6, (n, 2))  # random boxes stay inside [0.2, 0.7]^2,
    wh = rng.uniform(0.05, 0.2, (n, 2))  # away from the planted ones
    boxes = np.concatenate([cxy - wh / 2, cxy + wh / 2], -1).astype(np.float32)
    scores = rng.uniform(0.1, 0.9, n).astype(np.float32)
    boxes[10:14] = boxes[4]
    scores[10:14] = scores[4]
    boxes[20] = [0.0, 0.0, 0.5, 0.125]
    boxes[21] = [0.0, 0.0, 0.25, 0.125]  # IoU with box 20 is exactly 0.5
    scores[20], scores[21] = 0.95, 0.94
    # IoU(a, b) = IoU(b, c) = 0.15 / 0.65, IoU(a, c) = 0
    boxes[30:33] = [[0.0, 0.85, 0.4, 1.0], [0.25, 0.85, 0.65, 1.0], [0.5, 0.85, 0.9, 1.0]]
    scores[30:33] = [0.99, 0.98, 0.97]
    valid = rng.uniform(size=n) > 0.15
    valid[[4, 10, 11, 12, 13, 20, 21, 30, 31, 32]] = True
    return boxes, scores, valid


@pytest.mark.parametrize("n,seed,thr", [(96, 0, 0.5), (128, 1, 0.2)])
def test_nms_keep_mask_matches_pallas_and_xla(n, seed, thr):
    boxes, scores, valid = _boxes_with_ties(n, seed)
    jb, js, jv = jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid)
    want_pallas = np.asarray(nms_keep_mask_pallas(jb, js, thr, jv, interpret=True))
    want_xla = np.asarray(j_nms(jb, js, thr, jv))
    got = nms.nms_keep_mask(torch.from_numpy(boxes), torch.from_numpy(scores), thr,
                            torch.from_numpy(valid)).numpy()
    np.testing.assert_array_equal(got, want_pallas)
    np.testing.assert_array_equal(got, want_xla)
    # IoU == thr is not a suppression (the rule is strict)
    assert got[20] and got[21] == (thr >= 0.5)
    assert not got[10:14].any()  # tied duplicates: only the lowest index may survive
    # the chain: b falls to a below IoU 0.23, and c then survives the dead b
    assert got[30] and got[32] and got[31] == (thr >= 0.15 / 0.65)


def test_greedy_keep_sorted_batches_images_independently():
    b0, _, v0 = _boxes_with_ties(64, 3)
    b1, _, v1 = _boxes_with_ties(64, 4)
    both = cuda_nms.greedy_keep_sorted(torch.from_numpy(np.stack([b0, b1])),
                                       torch.from_numpy(np.stack([v0, v1])), 0.5)
    one = cuda_nms.greedy_keep_sorted(torch.from_numpy(b1[None]),
                                      torch.from_numpy(v1[None]), 0.5)
    np.testing.assert_array_equal(both[1].numpy(), one[0].numpy())


def _dets(b, k, seed):
    rng = np.random.default_rng(seed)
    boxes = np.stack([_boxes_with_ties(k, seed + i)[0] for i in range(b)])
    scores = rng.uniform(0, 1, (b, k)).astype(np.float32)
    valid = scores > 0.2
    return {"boxes": boxes, "scores": np.where(valid, scores, 0.0).astype(np.float32),
            "refs": rng.uniform(0, 1, (b, k, 2)).astype(np.float32), "valid": valid}


def test_batched_nms_and_compaction_match_jax():
    d = _dets(3, 64, 7)
    jd = {k: jnp.asarray(v) for k, v in d.items()}
    td = {k: torch.from_numpy(v) for k, v in d.items()}
    want = jpost.batched_nms(jd, 0.4, backend="xla")
    got = postprocess.batched_nms(td, 0.4)
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
    np.testing.assert_array_equal(got["scores"].numpy(), np.asarray(want["scores"]))
    want_c = jpost.compact_detections(want)
    got_c = postprocess.compact_detections(got)
    for name in ("boxes", "scores", "refs", "valid", "count"):
        np.testing.assert_array_equal(got_c[name].numpy(), np.asarray(want_c[name]))


def test_peaks_match_jax():
    rng = np.random.default_rng(5)
    x = rng.uniform(0, 1, (5, 9, 11)).astype(np.float32)
    ex_h = np.array([0.05, 0.2, 0.05, 0.5, 0.3], np.float32)
    ex_w = np.array([0.05, 0.05, 0.3, 0.5, 0.15], np.float32)
    masks = peaks.adaptive_kernel(torch.from_numpy(ex_h), torch.from_numpy(ex_w), 9, 11)
    got = peaks.masked_maxpool3x3(torch.from_numpy(x), masks).numpy()
    for i in range(5):
        jm = j_adaptive(jnp.float32(ex_h[i]), jnp.float32(ex_w[i]), 9, 11)
        np.testing.assert_array_equal(masks[i].numpy(), np.asarray(jm))
        np.testing.assert_array_equal(got[i], np.asarray(j_maxpool(jnp.asarray(x[i]), jm)))


@pytest.mark.parametrize("box_reg", [True, False])
def test_decode_detections_matches_jax(box_reg):
    rng = np.random.default_rng(11)
    obj = rng.standard_normal((2, 12, 12)).astype(np.float32) * 3
    reg = rng.standard_normal((2, 12, 12, 4)).astype(np.float32) * 0.3
    ex = np.array([[0.1, 0.2, 0.3, 0.35], [0.5, 0.5, 0.55, 0.58]], np.float32)
    want = jpost.decode_detections([jnp.asarray(obj)], [jnp.asarray(reg)],
                                   jnp.asarray(ex), cls_threshold=0.25,
                                   max_detections=100, box_reg=box_reg)
    got = postprocess.decode_detections(torch.from_numpy(obj), torch.from_numpy(reg),
                                        torch.from_numpy(ex), cls_threshold=0.25,
                                        max_detections=100, box_reg=box_reg)
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
    for name in ("scores", "boxes", "refs"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=1e-6, atol=1e-6)


def test_decoder_and_heads_match_flax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 8, 8, 6)).astype(np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    for jmod, mod in (
        (jheads.Decoder(num_layers=2, kernel_size=3), heads.Decoder(6, 2, 3)),
        (jheads.ObjectnessHead(), heads.ObjectnessHead(6)),
        (jheads.BboxesHead(), heads.BboxesHead(6)),
    ):
        params = _np_tree(jmod.init(jax.random.key(0), jnp.asarray(x))["params"])
        want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
        mod.load_state_dict(params_from_jax(params))
        with torch.no_grad():
            got = mod(xt).permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
