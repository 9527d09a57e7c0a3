"""The NMS kernel's index maths (``tmr_tpu_torch/csrc/nms.cu``) as a numpy model, held
bit for bit to the port's plain version and to the JAX package's Pallas kernel
(interpret mode) and XLA fixpoint on the same boxes.

The model builds the IoU bitmask as ``nms_mask_kernel`` does (a CTA per column block
and row block, the upper triangle of 64 x 64 blocks at work, one 64-bit word per row
and column block, bit u of row i set iff j = 64 cb + u > i and IoU > thr; blocks whose
columns are all invalid, and the rows of invalid boxes, left as they were, here random
bits), then runs ``nms_scan_kernel``'s block scan (the removed bits start as the invalid
boxes and the slots past N; per scan block of BW words, warp-wide fixed-point passes
over the block's own words, or box by box for a chain deeper than the passes; the kept
rows' words at the next block carried into it, at the two after that ORed in the next
step, and the rest loaded in the next step and ORed two steps later). Keep decisions
must be equal, ties at the threshold included."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_tail import _boxes_with_ties  # noqa: E402
from tmr_tpu.ops.nms import nms_keep_mask as j_nms  # noqa: E402
from tmr_tpu.ops.pallas_nms import nms_keep_mask_pallas  # noqa: E402
from tmr_tpu_torch.ops import cuda_nms  # noqa: E402

BLK = 64
ALL = (1 << BLK) - 1
# nms.cu: a scan step resolves a block of BW words (64 BW boxes); its fixed point gets
# FIXPOINT_PASSES warp-wide passes before the box-by-box steps
BW, FIXPOINT_PASSES = 2, 8
# the references, each compiled whole once per box count (the threshold is traced)
_PALLAS = jax.jit(functools.partial(nms_keep_mask_pallas, interpret=True))
_XLA = jax.jit(j_nms)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _iou(bi, bj):
    """(rows, cols) IoU in f32, each operation rounded once, in the kernel's order."""
    zero = np.float32(0.0)

    def area(b):
        return np.maximum(b[:, 2] - b[:, 0], zero) * np.maximum(b[:, 3] - b[:, 1], zero)

    iw = np.maximum(np.minimum(bj[None, :, 2], bi[:, None, 2])
                    - np.maximum(bj[None, :, 0], bi[:, None, 0]), zero)
    ih = np.maximum(np.minimum(bj[None, :, 3], bi[:, None, 3])
                    - np.maximum(bj[None, :, 1], bi[:, None, 1]), zero)
    inter = iw * ih
    union = (area(bj)[None, :] + area(bi)[:, None]) - inter
    return inter / np.maximum(union, np.float32(1e-12))


def _bitmask(boxes, valid, thr, seed=0):
    """nms_mask_kernel: mask[i][cb] words as Python ints; words no CTA writes are
    random, as the wrapper's ``torch.empty`` workspace leaves them."""
    n = len(boxes)
    w = -(-n // BLK)
    rng = np.random.default_rng(seed)
    mask = [[int(x) for x in row]
            for row in rng.integers(0, 2 ** 64, (n, w), dtype=np.uint64, endpoint=False)]
    for cb in range(w):  # the grid: (column block, row block)
        cols = np.arange(cb * BLK, min(cb * BLK + BLK, n))
        for rb in range(w):
            if rb > cb or not valid[cols].any():
                continue
            rows = np.arange(rb * BLK, min(rb * BLK + BLK, n))
            bits = (cols[None, :] > rows[:, None]) & (_iou(boxes[rows], boxes[cols]) > thr)
            for r, i in enumerate(rows):
                if valid[i]:
                    mask[i][cb] = sum(1 << int(u) for u in np.nonzero(bits[r])[0])
    return mask


def _or_rows(rows, words):
    """The OR over the rows set in ``rows`` (BW bit words) of their words (a list of
    BW words a row): the warp's reduction."""
    out = [0] * len(words[0])
    for s, ws in enumerate(words):
        if (rows[s // BLK] >> (s % BLK)) & 1:
            out = [x | y for x, y in zip(out, ws)]
    return out


def _resolve(r, rows_words):
    """One scan block: its removed words ``r`` (BW of them, bit s of the block in word
    s // 64) and its rows' words at the block's columns -> the kept rows (BW words).
    Warp-wide passes of kept = alive & ~OR(kept rows' words) from kept = alive, to a pass
    that changes nothing; box by box after FIXPOINT_PASSES."""
    alive = [~x & ALL for x in r]
    kept = list(alive)
    for _ in range(FIXPOINT_PASSES):
        nx = [a & ~s for a, s in zip(alive, _or_rows(kept, rows_words))]
        if nx == kept:
            return kept
        kept = nx
    r, kept = list(r), [0] * BW
    for s, ws in enumerate(rows_words):
        if not (r[s // BLK] >> (s % BLK)) & 1:
            kept[s // BLK] |= 1 << (s % BLK)
            r = [x | y for x, y in zip(r, ws)]
    return kept


def _scan(mask, valid):
    """nms_scan_kernel's block scan over the words: keep (N,) bool."""
    n = len(valid)
    w_n = -(-n // BLK)
    n_b = -(-w_n // BW)  # scan blocks
    removed = [sum(1 << t for t in range(BLK) if c * BLK + t >= n or not valid[c * BLK + t])
               for c in range(n_b * BW)]

    def word(i, c):  # the ring: 0 past N, past the last word and left of the row's own
        return mask[i][c] if i < n and i // BLK <= c < w_n else 0

    def rows(b):
        return range(b * BW * BLK, (b + 1) * BW * BLK)

    def block_words(b, first):  # each row of block b: words of block ``first``
        return [[word(i, first * BW + k) for k in range(BW)] for i in rows(b)]

    keep = np.zeros(n, bool)
    kept, held, nxt = {}, {}, [0] * BW
    for b in range(n_b):
        # warps 4-15: the words loaded two steps before (block b - 3's kept rows,
        # blocks b + 1 on), then block b - 1's (blocks b + 3 on)
        for c, v in held.pop(b - 2, ()):
            removed[c] |= v
        held[b] = [(c, word(i, c)) for i in kept.get(b - 1, ())
                   for c in range((b + 3) * BW, w_n)]
        # warp 1: block b - 1's kept rows at blocks b + 1 and b + 2
        if b >= 1:
            for first in (b + 1, b + 2):
                bits = _or_rows(_bits(kept[b - 1], b - 1), block_words(b - 1, first))
                for k, v in enumerate(bits):
                    if first * BW + k < w_n:
                        removed[first * BW + k] |= v
        # warp 0: block b on its own words, then its kept rows' words at block b + 1
        r = [removed[b * BW + k] | nxt[k] for k in range(BW)]
        bits = _resolve(r, block_words(b, b))
        kept[b] = [i for s, i in enumerate(rows(b)) if (bits[s // BLK] >> (s % BLK)) & 1]
        nxt = _or_rows(bits, block_words(b, b + 1))
        keep[kept[b]] = True
    return keep


def _bits(kept_rows, b):
    """Block b's kept rows (indices) -> its BW bit words."""
    out = [0] * BW
    for i in kept_rows:
        s = i - b * BW * BLK
        out[s // BLK] |= 1 << (s % BLK)
    return out


def _bitmask_nms_model(boxes, valid, thr):
    """Keep mask of score-sorted boxes (N, 4) f32, valid (N,) bool, as the kernel
    decides it."""
    thr = np.float32(thr)
    return _scan(_bitmask(boxes, valid, thr), valid)


def _check(boxes, scores, valid, thr):
    order = np.argsort(-np.where(valid, scores, -np.inf), kind="stable")
    sb, sv = boxes[order], valid[order]
    got_sorted = _bitmask_nms_model(sb, sv, thr)
    plain = cuda_nms.greedy_keep_sorted_plain(torch.from_numpy(sb[None]),
                                              torch.from_numpy(sv[None]), thr)[0].numpy()
    np.testing.assert_array_equal(got_sorted, plain)
    got = np.zeros_like(valid)
    got[order] = got_sorted
    args = (jnp.asarray(boxes), jnp.asarray(scores), jnp.float32(thr), jnp.asarray(valid))
    np.testing.assert_array_equal(got, np.asarray(_PALLAS(*args)))
    np.testing.assert_array_equal(got, np.asarray(_XLA(*args)))
    return got


@pytest.mark.parametrize("thr", [0.5, 0.15])
@pytest.mark.parametrize("n", [63, 64, 65, 129])
def test_bitmask_model_matches_plain_pallas_and_xla(n, thr):
    boxes, scores, valid = _boxes_with_ties(n, n)
    got = _check(boxes, scores, valid, thr)
    assert got[20] and got[21] == (thr >= 0.5)  # IoU == thr does not suppress
    assert not got[10:14].any()  # tied duplicates of box 4
    assert got[30] and got[32] and got[31] == (thr >= 0.15 / 0.65)  # the chain


def test_bitmask_model_all_invalid():
    boxes, scores, _ = _boxes_with_ties(65, 1)
    got = _check(boxes, scores, np.zeros(65, bool), 0.5)
    assert not got.any()


def test_bitmask_model_all_identical():
    n = 129
    boxes = np.tile(np.array([[0.1, 0.2, 0.4, 0.6]], np.float32), (n, 1))
    got = _check(boxes, np.full(n, 0.5, np.float32), np.ones(n, bool), 0.5)
    assert got[0] and not got[1:].any()


def _chain(n):
    """Boxes sliding by 0.3 of their width, in score order: each overlaps the next at
    IoU 0.7 / 1.3 and the one after at 0.4 / 1.6, so greedy keeps every other box and
    a block's fixed point needs one pass per box."""
    x = (np.arange(n) * 0.3)[:, None]
    boxes = np.concatenate([x, np.zeros_like(x), x + 1.0, np.ones_like(x)], 1)
    return boxes.astype(np.float32), np.linspace(1.0, 0.5, n).astype(np.float32)


def test_bitmask_model_deep_chain():
    n = 129
    boxes, scores = _chain(n)
    valid = np.ones(n, bool)
    mask = _bitmask(boxes, valid, np.float32(0.5))
    block = [[mask[i][k] if i // BLK <= k else 0 for k in range(BW)] for i in range(BW * BLK)]
    kept, last = [ALL] * BW, None
    for _ in range(FIXPOINT_PASSES):  # the chain outlasts the passes: box by box
        kept, last = [ALL & ~s for s in _or_rows(kept, block)], kept
    assert kept != last
    got = _check(boxes, scores, valid, 0.5)
    np.testing.assert_array_equal(got, np.arange(n) % 2 == 0)


@pytest.mark.parametrize("n,words", [(9001, 141), (20000, 313)])
def test_kernel_takes_any_box_count(n, words, monkeypatch):
    """The kernel's only limit is its workspace, (B, N, mask_words(N)) 64-bit words:
    past the sequential kernel's shared-memory cap (9000 boxes) the wrapper still
    launches (driven here on shapes alone, ``meta`` tensors, the launch recorded)."""
    assert not hasattr(cuda_nms, "MAX_BOXES")
    assert cuda_nms.mask_words(n) == words
    assert words * BLK >= n > (words - 1) * BLK
    calls = []
    monkeypatch.setattr(cuda_nms._build, "launch", lambda *args: calls.append(args))
    monkeypatch.setattr(cuda_nms._build, "stream_of", lambda t: 0)
    boxes = torch.empty((2, n, 4), device="meta")
    keep = cuda_nms.greedy_keep_sorted(boxes, torch.empty((2, n), dtype=torch.bool,
                                                          device="meta"), 0.5)
    assert keep.shape == (2, n) and keep.dtype == torch.bool
    assert len(calls) == 1 and calls[0][:3] == ("nms", "nms", "tmr_nms")
    assert calls[0][-4:] == (2, n, 0.5, 0)
