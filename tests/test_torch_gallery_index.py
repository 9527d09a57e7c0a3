"""The gallery's sketch index in the port (``tmr_tpu_torch/serve/gallery_index.py``)
against the JAX package's (``tmr_tpu/serve/gallery_index.py``): the same geometry
vectors, distances, k-means, clusters, probes, stamps and digest for the same insertion
history, bit for bit, through register / evict churn; the JAX module's own cases; and the
bank's indexed selection against its linear scan (``serve/gallery.GalleryBank``) on the
TINY pair of ``tests/test_torch_predictor.py``. Host-side numpy only, but for the last."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tmr_tpu.serve import gallery_index as jidx  # noqa: E402
from tmr_tpu_torch.serve import gallery_index as pidx  # noqa: E402
from tmr_tpu_torch.serve.gallery_index import (SKETCH_DIMS, SketchIndex,  # noqa: E402
                                               entry_sketch)

FIELDS = ("boxes", "scores", "refs", "valid")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _vec(i):
    """A sketch-like vector: three well-separated blobs, so the clustering has structure
    to find."""
    rng = np.random.default_rng(1000 + i)
    center = np.asarray([0.2, 0.2, 0.5, 0.8][i % 4] * np.ones(4))
    return np.concatenate([center + rng.normal(0, 0.03, 4),
                           rng.normal(0, 0.01, 4)]).astype(np.float32)


def _fill(idx, names):
    for i, nm in enumerate(names):
        idx.add(nm, _vec(i))


def _state(idx):
    """Everything a query or a journal reads: the snapshot, the stats without the wall
    clock, the stamps without it."""
    stats = idx.stats()
    stats.pop("last_rebuild")
    stamps = [{k: v for k, v in s.items() if k != "wall_s"} for s in idx.stamps()]
    return idx.snapshot(), stats, stamps


# ------------------------------------------------------------ against JAX
def test_entry_sketch_and_distances_match_jax():
    rng = np.random.default_rng(0)
    for k in (1, 2, 3, 7):
        ex = rng.uniform(0, 1, (8, 4)).astype(np.float32)
        assert entry_sketch(ex, k).tobytes() == jidx.entry_sketch(ex, k).tobytes()
    x = rng.standard_normal((300, SKETCH_DIMS)).astype(np.float32)
    cent = rng.standard_normal((7, SKETCH_DIMS)).astype(np.float32)
    assert pidx._pairwise_d2(x, cent).tobytes() == jidx._pairwise_d2(x, cent).tobytes()
    for n_clusters in (1, 5, 17, 300):
        pc, pa = pidx._kmeans(x, n_clusters, 7)
        jc, ja = jidx._kmeans(x, n_clusters, 7)
        assert pc.tobytes() == jc.tobytes() and np.array_equal(pa, ja)


def test_index_matches_jax_through_churn():
    """The same scripted history into both indexes: adds, a build, adds and removes
    against the built clustering (a probe evicted, an entry re-registered), a rebuild
    past the churn threshold, then an emptied index."""
    rng = np.random.default_rng(3)
    a, b = SketchIndex(rebuild_frac=0.2), jidx.SketchIndex(rebuild_frac=0.2)
    history = [("add", f"p{i:03d}", _vec(i)) for i in range(40)] + [("rebuild",)]
    history += [("add", f"x{i}", _vec(100 + i)) for i in range(5)]
    history += [("remove", f"p{i:03d}") for i in rng.choice(40, 6, replace=False)]
    history += [("add", "p001", _vec(7)), ("remove", "nope"), ("rebuild",)]
    history += [("remove", n) for n in sorted({f"p{i:03d}" for i in range(40)}
                                              | {f"x{i}" for i in range(5)})]
    history += [("rebuild",)]
    for step in history:
        got = getattr(a, step[0])(*step[1:])
        want = getattr(b, step[0])(*step[1:])
        if step[0] == "rebuild":
            got, want = ({k: v for k, v in d.items() if k != "wall_s"} for d in (got, want))
        assert got == want, step
        assert a.needs_rebuild() == b.needs_rebuild(), step
        assert len(a) == len(b) and a.built == b.built
        assert _state(a) == _state(b), step


# ----------------------------------------------------------- the JAX cases
def test_entry_sketch_uses_only_real_rows():
    ex = np.asarray([[0.1, 0.1, 0.3, 0.4], [0.5, 0.5, 0.9, 0.9], [0.0, 0.0, 1.0, 1.0]],
                    np.float32)
    v2 = entry_sketch(ex, 2)
    assert v2.shape == (SKETCH_DIMS,) and v2.dtype == np.float32
    padded = np.concatenate([ex[:2], np.tile(ex[1:2], (5, 1))], axis=0)
    assert entry_sketch(padded, 2).tobytes() == v2.tobytes()
    assert entry_sketch(ex, 3).tobytes() != v2.tobytes()


def test_rebuild_deterministic_across_insertion_order():
    names = [f"p{i:03d}" for i in range(48)]
    a, b = SketchIndex(), SketchIndex()
    _fill(a, names)
    for i in reversed(range(len(names))):
        b.add(names[i], _vec(i))
    sa, sb = a.rebuild(), b.rebuild()
    assert sa["digest"] == sb["digest"]
    assert sa["entries"] == 48 and sa["centroids"] == sb["centroids"]
    assert a.snapshot() == b.snapshot()


def test_incremental_maintenance_is_order_independent():
    names = [f"p{i:03d}" for i in range(32)]
    a, b = SketchIndex(), SketchIndex()
    _fill(a, names)
    _fill(b, names)
    a.rebuild()
    b.rebuild()
    extra = [(f"x{i}", _vec(100 + i)) for i in range(6)]
    for nm, v in extra:
        a.add(nm, v)
    for nm, v in reversed(extra):
        b.add(nm, v)

    def probe_state(idx):
        snap = idx.snapshot()
        return snap["medoids"], snap["probes"], [sorted(m) for m in snap["members"]]

    assert probe_state(a) == probe_state(b)
    victim = a.snapshot()["probes"][0][0]
    assert a.remove(victim)
    assert victim not in [p for pl in a.snapshot()["probes"] for p in pl]
    a.add(victim, _vec(names.index(victim)))
    assert probe_state(a) == probe_state(b)


def test_removed_entries_leave_snapshot_immediately():
    names = [f"p{i:03d}" for i in range(20)]
    idx = SketchIndex()
    _fill(idx, names)
    idx.rebuild()
    for nm in names[:10]:
        assert idx.remove(nm)
    snap = idx.snapshot()
    gone = set(names[:10])
    assert not gone & {m for ms in snap["members"] for m in ms}
    assert not gone & {p for pl in snap["probes"] for p in pl}
    assert not idx.remove("p000")
    assert len(idx) == 10


def test_needs_rebuild_tracks_churn_threshold():
    idx = SketchIndex(rebuild_frac=0.25)
    assert not idx.needs_rebuild()
    idx.add("a", _vec(0))
    assert idx.needs_rebuild()
    names = [f"p{i:03d}" for i in range(40)]
    _fill(idx, names)
    idx.rebuild()
    assert not idx.needs_rebuild()
    for i in range(int(0.25 * (len(names) + 1))):
        idx.add(f"n{i}", _vec(200 + i))
    assert not idx.needs_rebuild()
    idx.remove("n0")
    assert idx.needs_rebuild()
    idx.rebuild(reason="test")
    assert not idx.needs_rebuild()
    assert idx.stamps()[-1]["reason"] == "test"


def test_stamps_journal_bounded_and_digest_pins_entry_set():
    idx = SketchIndex(max_stamps=4)
    _fill(idx, [f"p{i}" for i in range(9)])
    digests = set()
    for r in range(7):
        stamp = idx.rebuild(reason=f"r{r}")
        assert stamp["entries"] == 9 and stamp["centroids"] == 3 and stamp["wall_s"] >= 0
        digests.add(stamp["digest"])
    assert len(digests) == 1
    log = idx.stamps()
    assert [s["reason"] for s in log] == ["r3", "r4", "r5", "r6"]
    assert log[-1]["rebuild"] == 7
    assert idx.stats()["last_rebuild"]["digest"] == log[-1]["digest"]
    idx.remove("p0")
    assert idx.rebuild()["digest"] not in digests


def test_probes_are_medoid_plus_anti_medoid():
    idx = SketchIndex(min_centroids=1)
    base = np.zeros(SKETCH_DIMS, np.float32)
    for name, off in (("near", 0.01), ("mid", 0.05), ("far", 0.20)):
        idx.add(name, base + off)
    idx.rebuild()
    snap = idx.snapshot()
    flat = [p for pl in snap["probes"] for p in pl]
    assert "near" in flat and "far" in flat
    for medoid, probes in zip(snap["medoids"], snap["probes"]):
        assert probes[0] == medoid and 1 <= len(probes) <= 2


# ---------------------------------------------------- the bank, index vs scan
def _box(i):
    """Distinct well-separated crops on the 32 px frame."""
    x = 0.05 + 0.11 * (i % 8)
    y = 0.08 + 0.28 * (i // 8)
    w = 0.10 + 0.02 * (i % 5)
    return np.asarray([[x, y, x + w, y + w]], np.float32)


def _parity(got, want):
    assert set(got) == set(want)
    for nm in want:
        for k in FIELDS:
            assert np.array_equal(got[nm][k], want[nm][k]), (nm, k)
        assert got[nm].get("degrade_steps") == want[nm].get("degrade_steps"), nm


def test_index_selection_matches_linear_through_churn():
    """The JAX case through ``search``: at small C the automatic nprobe probes every
    cluster, so the indexed results equal the linear scan's bit for bit, labels
    included; an evicted entry is gone from the next search without a rebuild; churn past
    the threshold reclusters (counted, stamped); a bank fed the registry in reverse
    elects the same clustering."""
    from test_torch_predictor import TINY, _make_pair

    from tmr_tpu_torch.serve import GalleryBank

    _, pred, images = _make_pair(TINY)
    names = [f"n{i:02d}" for i in range(12)]
    linear = GalleryBank(pred, feature_cache=0, max_n_bucket=32, index=False)
    indexed = GalleryBank(pred, feature_cache=0, max_n_bucket=32, index=True,
                          index_min_n=1)
    for i, nm in enumerate(names):
        linear.register(nm, _box(i))
        indexed.register(nm, _box(i))
    img = images[0]
    _parity(indexed.search(img, prefilter_topk=3), linear.search(img, prefilter_topk=3))
    c = indexed.counters
    assert (c["index_queries"], c["index_fallbacks"], c["index_rebuilds"],
            c["index_candidates"]) == (1, 0, 1, 12)
    st = indexed.stats()["index"]
    assert st["enabled"] and st["built"] and st["entries"] == 12
    assert st["centroids"] == 3 and st["queries"] == 1
    assert len(indexed.index_stamps()) == 1 and linear.stats()["index"]["enabled"] is False
    for bank in (linear, indexed):
        assert bank.evict("n03") is True
    got = indexed.search(img, prefilter_topk=3)
    assert "n03" not in got
    _parity(got, linear.search(img, prefilter_topk=3))
    assert indexed.counters["index_rebuilds"] == 1
    for i in range(12, 16):
        linear.register(f"n{i:02d}", _box(i))
        indexed.register(f"n{i:02d}", _box(i))
    want = linear.search(img, prefilter_topk=3)
    _parity(indexed.search(img, prefilter_topk=3), want)
    assert indexed.counters["index_rebuilds"] == 2 and len(indexed.index_stamps()) == 2
    assert indexed.counters["index_fallbacks"] == 0
    live = [nm for nm in names + ["n12", "n13", "n14", "n15"] if nm != "n03"]
    mirror = GalleryBank(pred, feature_cache=0, max_n_bucket=32, index=True,
                         index_min_n=1)
    for nm in reversed(live):
        mirror.register(nm, _box(int(nm[1:])))
    _parity(mirror.search(img, prefilter_topk=3), want)
    assert mirror.index_stamps()[-1]["digest"] == indexed.index_stamps()[-1]["digest"]


def test_index_failure_falls_back_to_the_scan_counted(monkeypatch):
    from test_torch_predictor import TINY, _make_pair

    from tmr_tpu_torch.serve import GalleryBank

    _, pred, images = _make_pair(TINY)
    banks = [GalleryBank(pred, feature_cache=0, index=flag, index_min_n=1)
             for flag in (False, True)]
    for bank in banks:
        for i in range(6):
            bank.register(f"n{i}", _box(i))

    def broken(*a, **k):
        raise RuntimeError("index lost")

    monkeypatch.setattr(banks[1], "_index_select", broken)
    _parity(banks[1].search(images[1], prefilter_topk=2),
            banks[0].search(images[1], prefilter_topk=2))
    assert banks[1].counters["index_fallbacks"] == 1
