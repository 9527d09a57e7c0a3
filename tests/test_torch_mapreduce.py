"""The port's map phase (``tmr_tpu_torch.parallel.mapreduce`` and its modules) against
``tmr_tpu.parallel.mapreduce`` on the same shards, weights and fault schedules.

TINY geometry (``embed_dim 32, depth 2, window 2, out_chans 8`` at 32^2, as
``tests/test_mapreduce_cli.py``), the JAX weights brought across by ``params_from_jax``.
Tolerances: features and statistics within 1e-4 x the largest |value| at f32 (the
port's encoder parity bound) and 5e-2 x at bf16 (the repo's bf16 tier, as in
``chip_smoke.py``'s ``OBJ_REL_TOL``: the two encoders round their bf16 activations and
the attention's probabilities at other points, and the neck's LayerNorms rescale the
drift to the features' unit scale; the largest seen here is 3.4e-2); the table's counts, the report records, the fault logs,
the journal bytes and the preprocessed pixels exactly.
"""

import glob
import io
import json
import os
import re
import subprocess
import sys
import tarfile
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import tmr_tpu.parallel.mapreduce as jmr  # noqa: E402
from tmr_tpu.models.vit import SamViT as JSamViT  # noqa: E402
from tmr_tpu.parallel.journal import ShardJournal as JShardJournal  # noqa: E402
from tmr_tpu.utils import faults as jfaults  # noqa: E402
from tmr_tpu_torch.data import transforms  # noqa: E402
from tmr_tpu_torch.diagnostics import validate_map_report  # noqa: E402
from tmr_tpu_torch.models.vit import SamViT  # noqa: E402
from tmr_tpu_torch.parallel import mapreduce as mr  # noqa: E402
from tmr_tpu_torch.parallel.journal import ShardJournal  # noqa: E402
from tmr_tpu_torch.utils import faults  # noqa: E402
from tmr_tpu_torch.utils.weights import params_from_jax  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
TINY = dict(embed_dim=32, depth=2, num_heads=2, global_attn_indexes=(1,), window_size=2,
            out_chans=8, pretrain_img_size=32)
SIZE = 32
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
RECORD = re.compile(r"^(Easy|Normal|Hard|Unknown)\t[^,\s]+(,[^,\s]+){3},\d+$")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(autouse=True)
def _clean_schedules():
    faults.clear()
    jfaults.clear()
    yield
    faults.clear()
    jfaults.clear()


def _png(rng, h, w) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(buf, "PNG")
    return buf.getvalue()


def _make_tar(path, members):
    with tarfile.open(path, "w") as tar:
        for name, data in members:
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))
    return str(path)


@pytest.fixture
def shards(tmp_path):
    """Easy 5 images (a tail of 1 at batch 2), Normal 4, Hard 3 with one member that
    does not decode and a text file, a file that is not a tar, a tar cut inside its
    first member and a missing shard."""
    rng = np.random.default_rng(0)
    easy = [(f"img_{i}.png", _png(rng, 40, 48 + i)) for i in range(5)]
    normal = [(f"n{i}.PNG", _png(rng, 30 + i, 30)) for i in range(4)]
    hard = [("h0.png", _png(rng, 64, 20)), ("bad.jpg", b"not an image"),
            ("notes.txt", b"x"), ("h1.png", _png(rng, 33, 45)),
            ("h2.png", _png(rng, 32, 32))]
    (tmp_path / "broken.tar").write_bytes(b"definitely not a tar")
    cut = Path(_make_tar(tmp_path / "cut.tar", [("c.png", _png(rng, 64, 64))]))
    cut.write_bytes(cut.read_bytes()[:512 + 1000])
    return [_make_tar(tmp_path / "Easy_0.tar", easy),
            _make_tar(tmp_path / "Normal_0.tar", normal),
            _make_tar(tmp_path / "Hard_0.tar", hard),
            str(tmp_path / "broken.tar"), str(cut), str(tmp_path / "Normal_9.tar")]


def _randomize_tables(params, rng):
    """The flax init zeroes the rel-pos tables and pos_embed; give them values."""
    for name, val in params.items():
        if isinstance(val, dict):
            _randomize_tables(val, rng)
        elif name in ("rel_pos_h", "rel_pos_w", "pos_embed"):
            params[name] = (rng.standard_normal(np.shape(val)) * 0.3).astype(np.float32)
    return params


_ENCODERS = {}


def _encoders(dtype: str = "float32"):
    """(JAX encode fn, port encode fn, JAX model, its params, port model) on the same
    weights."""
    if dtype not in _ENCODERS:
        jmodel = JSamViT(**TINY, dtype=getattr(jnp, dtype))
        params = jmodel.init(jax.random.key(0), jnp.zeros((1, SIZE, SIZE, 3)))["params"]
        params = _randomize_tables(
            jax.tree_util.tree_map(lambda a: np.array(a, np.float32), params),
            np.random.default_rng(1))
        model = SamViT(**TINY, dtype=getattr(torch, dtype))
        model.load_state_dict(params_from_jax(params))
        model.eval()
        _ENCODERS[dtype] = (jmr.make_encode_stats_fn(jmodel, params),
                            mr.make_encode_stats_fn(model), jmodel, params, model)
    return _ENCODERS[dtype]


def _close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * np.abs(want).max(), \
        np.abs(got - want).max() / np.abs(want).max()


def _fast_retry(mod, **kw):
    kw.setdefault("max_attempts", 3)
    kw.setdefault("backoff_base", 0.001)
    kw.setdefault("backoff_jitter", 0.0)
    return mod.RetryPolicy(**kw)


def _tree(root):
    return {os.path.relpath(p, root): np.load(p)
            for p in sorted(glob.glob(os.path.join(root, "**", "*.npy"), recursive=True))}


def _records(doc):
    return [{k: v for k, v in r.items() if k != "wall_s"} for r in doc["shards"]]


def _run_both(shards, tmp_path, native=False, schedule=None, dtype="float32",
              retry_kw=None, save=True):
    """The same shards through both packages; returns ((table, doc, tree, fired) JAX,
    (...) port)."""
    jfn, fn = _encoders(dtype)[:2]
    out = []
    for tag, mod, fmod, enc in (("jax", jmr, jfaults, jfn), ("port", mr, faults, fn)):
        if schedule:
            fmod.configure(schedule)
        root = str(tmp_path / f"features_{tag}")
        if tag == "jax":
            from tmr_tpu.parallel.elastic import make_feature_sinks
        else:
            make_feature_sinks = mr.make_feature_sinks
        sinks = make_feature_sinks(root) if save else (None, None, None)
        report = mod.MapReport()
        run = mod.run_stream_native if native else mod.run_stream
        acc = run(shards, enc, batch_size=2, image_size=SIZE, save_features=sinks[0],
                  feeder_threads=2, retry=_fast_retry(mod, **(retry_kw or {})),
                  report=report, cleanup_features=sinks[1], sync_features=sinks[2])
        out.append((acc.table, report.document(), _tree(root) if save else {},
                    fmod.fired()))
        fmod.clear()
    return out


def _assert_same(jax_run, port_run, dtype="float32"):
    (jt, jdoc, jtree, jfired), (pt, pdoc, ptree, pfired) = jax_run, port_run
    np.testing.assert_array_equal(pt[:, 4], jt[:, 4])
    _close(pt, jt, TOL[dtype])
    assert _records(pdoc) == _records(jdoc)
    assert pdoc["quarantined"] == jdoc["quarantined"]
    assert pdoc["resumed"] == jdoc["resumed"]
    assert {k: v for k, v in pdoc["totals"].items() if k != "wall_s"} == \
        {k: v for k, v in jdoc["totals"].items() if k != "wall_s"}
    assert validate_map_report(pdoc) == []
    assert sorted(ptree) == sorted(jtree)
    for name in jtree:
        assert ptree[name].dtype == np.float32
        _close(ptree[name], jtree[name], TOL[dtype])
    key = lambda r: (r["point"], str(r["shard"]), str(r["attempt"]), r["action"])  # noqa: E731
    assert sorted(pfired, key=key) == sorted(jfired, key=key)


# ------------------------------------------------------------- statistics
def test_feature_stats_matches_jax():
    rng = np.random.default_rng(3)
    feats = rng.standard_normal((3, 4, 4, 8)).astype(np.float32)
    feats[1] = np.abs(feats[1])  # no element <= 0
    feats[2, :2] = 0.0  # zeros count as sparse
    want = np.asarray(jmr.feature_stats(jnp.asarray(feats)))
    got = mr.feature_stats(torch.from_numpy(feats)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got[:, 3], want[:, 3])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_stats_fn_matches_jax(dtype):
    jfn, fn = _encoders(dtype)[:2]
    images = np.random.default_rng(4).integers(0, 256, (2, SIZE, SIZE, 3), dtype=np.uint8)
    jfeats, jstats = jfn(jnp.asarray(images.astype(np.float32) / 255.0))
    feats, stats = fn(images)
    assert feats.dtype == torch.float32 and feats.shape == (2, 2, 2, TINY["out_chans"])
    _close(feats.numpy(), np.asarray(jfeats), TOL[dtype])
    _close(stats.numpy(), np.asarray(jstats), TOL[dtype])


# --------------------------------------------------------- preprocessing
@pytest.mark.parametrize("src,dst", [((480, 640), (1024, 1024)), ((37, 53), (64, 64)),
                                     ((64, 64), (13, 29)), ((101, 7), (50, 300)),
                                     ((720, 1280), (32, 32)), ((1, 5), (3, 3))])
def test_bicubic_resize_equals_pillow(src, dst):
    from PIL import Image

    rng = np.random.default_rng(sum(src) + sum(dst))
    noise = rng.integers(0, 256, src + (3,), dtype=np.uint8)
    edges = (rng.integers(0, 2, src + (3,)) * 255).astype(np.uint8)  # the clip8 ends
    for img in (noise, edges):
        want = np.asarray(Image.fromarray(img).resize(dst[::-1]))
        got = transforms.resize_bicubic_u8(img, *dst)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


def test_preprocess_image_matches_jax_bit_for_bit():
    from PIL import Image

    rng = np.random.default_rng(5)
    payloads = [_png(rng, 40, 52)]
    for mode in ("L", "RGBA"):
        buf = io.BytesIO()
        shape = (23, 31) if mode == "L" else (23, 31, 4)
        Image.fromarray(rng.integers(0, 256, shape, dtype=np.uint8), mode).save(buf, "PNG")
        payloads.append(buf.getvalue())
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (50, 60, 3), dtype=np.uint8)).save(buf, "JPEG")
    payloads.append(buf.getvalue())
    for data in payloads:
        want = jmr.preprocess_image(data, SIZE)
        got = mr.preprocess_image(data, SIZE)
        assert got.dtype == np.uint8 and got.shape == (SIZE, SIZE, 3)
        np.testing.assert_array_equal(got.astype(np.float32) / np.float32(255.0), want)
    assert mr.preprocess_image(b"not an image", SIZE) is None
    assert jmr.preprocess_image(b"not an image", SIZE) is None


@pytest.mark.parametrize("shape", [(720, 1280, 3), (480, 640, 3), (37, 53), (40, 30, 4)])
def test_sam_longest_side_preprocess_matches_jax(shape):
    from tmr_tpu.data.transforms import sam_longest_side_preprocess as jpre

    img = np.random.default_rng(6).integers(0, 256, shape, dtype=np.uint8)
    for target in (1024, 64):
        got = transforms.sam_longest_side_preprocess(img, target)
        assert got.dtype == np.float32 and got.shape == (target, target, 3)
        np.testing.assert_array_equal(got, jpre(img, target))


# ------------------------------------------------------------- the executor
@pytest.mark.parametrize("native", [False, True], ids=["tarfile", "native"])
def test_run_stream_matches_jax(shards, tmp_path, native):
    """Good shards with a padded tail, a corrupt tar, a missing shard and a member that
    does not decode: the same table, report records, feature tree and quarantines."""
    jax_run, port_run = _run_both(shards, tmp_path, native=native)
    _assert_same(jax_run, port_run)
    doc = port_run[1]
    # the native reader reads a 20-byte file as an empty tar, in both packages; a tar
    # cut inside a member fails both readers
    assert doc["quarantined"] == (["cut.tar", "Normal_9.tar"] if native else
                                  ["broken.tar", "cut.tar", "Normal_9.tar"])
    assert [r["attempts"] for r in doc["shards"]] == [1] * 6
    assert doc["totals"]["skipped_images"] == 1 and doc["totals"]["images"] == 12
    assert sorted(port_run[2])[0] == os.path.join("Easy", "Easy_0", "img_0.npy")
    assert port_run[2][os.path.join("Easy", "Easy_0", "img_4.npy")].shape == (2, 2, 8)


def test_run_stream_bf16_matches_jax(shards, tmp_path):
    jax_run, port_run = _run_both(shards[:3], tmp_path, dtype="bfloat16")
    _assert_same(jax_run, port_run, "bfloat16")


#: (schedule, retry policy) pairs run unchanged through both packages
SCHEDULES = {
    "transient": ("tar.open:shard=0:attempts=2:raise=OSError", {}),
    "permanent": ("tar.open:shard=1:raise=OSError", dict(max_attempts=2)),
    "hung": ("tar.open:shard=0:latency=0.8", dict(max_attempts=2, shard_timeout=0.2)),
    "nan": ("encode:shard=2:nan=1", {}),
    "save": ("save:shard=1:attempts=1:raise=OSError", {}),
    "slow": ("tar.member:shard=0:latency=0.2", dict(shard_timeout=0.5)),
    "corrupt": ("decode:shard=0:corrupt=1;tar.member:shard=1:attempts=1:corrupt=1", {}),
    "encode_retry": ("encode:shard=0:attempts=1:raise=RuntimeError", {}),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_fault_schedules_match_jax(shards, tmp_path, name):
    schedule, retry_kw = SCHEDULES[name]
    jax_run, port_run = _run_both(shards[:3], tmp_path, schedule=schedule,
                                  retry_kw=retry_kw)
    _assert_same(jax_run, port_run)
    assert port_run[3], "the schedule never fired"
    statuses = [r["status"] for r in port_run[1]["shards"]]
    assert statuses == (["ok", "quarantined", "ok"] if name == "permanent"
                        else ["quarantined", "ok", "ok"] if name == "hung"
                        else ["ok"] * 3)
    if name == "slow":  # longer than the stall budget, and never stalled
        assert port_run[1]["shards"][0]["wall_s"] > retry_kw["shard_timeout"]


@pytest.mark.parametrize("text", [
    "", " ; ", "tar.open", "tar.open:shard=3:attempts=2:raise=OSError",
    "tar.open:shard=3:attempts=2:raise=OSError;encode:shard=7:latency=30",
    "decode:corrupt=1;tar.member:corrupt=0", "encode:nan=1:shard=0",
    "journal:raise=KeyboardInterrupt", "save:raise=IOError:latency=0.5",
    "lease:shard=1:raise=InjectedFault", "gallery.beat:latency=2",
    "nope:shard=1", "tar.open:shard", "tar.open:color=red", "tar.open:raise=Boom",
    "tar.open:shard=x", "encode:latency=fast",
])
def test_parse_schedule_grammar_matches_jax(text):
    import dataclasses

    try:
        want = [dataclasses.astuple(s) for s in jfaults.parse_schedule(text)]
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            faults.parse_schedule(text)
        assert str(got.value) == str(e)
        return
    assert [dataclasses.astuple(s) for s in faults.parse_schedule(text)] == want


def test_env_schedule_and_fired_log():
    env = {"TMR_FAULTS": "tar.open:shard=0:raise=OSError", "TMR_FAULTS_SEED": "7"}
    assert faults.install_from_env(env) and faults.active()
    with faults.shard_scope(0, 0), pytest.raises(OSError, match="injected fault"):
        faults.fire("tar.open")
    with faults.shard_scope(1, 0):
        faults.fire("tar.open")
    assert faults.fired() == [dict(point="tar.open", shard=0, attempt=0, action="raise")]
    assert not faults.install_from_env({})


# -------------------------------------------------------------- the journal
def _marker_args(i):
    return dict(category=i % 3, sums=[0.1 * i, 1.0 / 3.0, 2.5e-7, 0.0, float(i + 1)],
                images=i + 1, skipped_images=i % 2, skipped_members=0,
                nonfinite_images=i % 3 == 1, attempts=2, wall_s=0.25)


def test_journal_markers_read_across_packages(tmp_path):
    """The same marker bytes from both packages; each reads the other's."""
    port, jax_ = ShardJournal(str(tmp_path / "p")), JShardJournal(str(tmp_path / "j"))
    for i, name in enumerate(("Easy_0.tar", "Hard_3.tar", "odd/name.tar")):
        port.record(name, **_marker_args(i))
        jax_.record(name, **_marker_args(i))
    for fn in sorted(os.listdir(tmp_path / "p")):
        assert (tmp_path / "p" / fn).read_bytes() == (tmp_path / "j" / fn).read_bytes()
    assert ShardJournal(str(tmp_path / "j")).load_all() == jax_.load_all()
    assert JShardJournal(str(tmp_path / "p")).load_all() == port.load_all()
    # an elastic worker's marker (worker, epoch: outside the digest) reads in the port
    jax_.record("Normal_4.tar", worker="w1", epoch=3, **_marker_args(4))
    entry = ShardJournal(str(tmp_path / "j")).done("Normal_4.tar")
    assert entry is not None and (entry["worker"], entry["epoch"]) == ("w1", 3)
    # a hand-edited marker fails the digest in both
    path = tmp_path / "p" / "Easy_0.json"
    path.write_text(path.read_text().replace('"images": 1', '"images": 2'))
    assert port.done("Easy_0.tar") is None and JShardJournal(str(tmp_path / "p")).done(
        "Easy_0.tar") is None


def test_port_resumes_from_a_jax_journal(shards, tmp_path):
    jfn, fn = _encoders()[:2]
    journal = str(tmp_path / "_journal")
    want = jmr.run_stream(shards[:3], jfn, batch_size=2, image_size=SIZE,
                          journal=JShardJournal(journal))
    report = mr.MapReport()
    got = mr.run_stream(shards[:3], fn, batch_size=2, image_size=SIZE,
                        journal=ShardJournal(journal), resume=True, report=report)
    assert got.table.tobytes() == want.table.tobytes()
    assert report.document()["resumed"] == ["Easy_0.tar", "Normal_0.tar", "Hard_0.tar"]


def test_crash_then_resume_is_byte_identical(shards, tmp_path):
    fn = _encoders()[1]
    ref = mr.run_stream(shards, fn, batch_size=2, image_size=SIZE, feeder_threads=2,
                        retry=_fast_retry(mr))
    journal = ShardJournal(str(tmp_path / "_journal"))
    faults.configure("tar.open:shard=2:raise=KeyboardInterrupt")
    with pytest.raises(KeyboardInterrupt):
        mr.run_stream(shards, fn, batch_size=2, image_size=SIZE, feeder_threads=2,
                      retry=_fast_retry(mr), journal=journal)
    faults.clear()
    assert sorted(journal.load_all()) == ["Easy_0.tar", "Normal_0.tar"]
    report = mr.MapReport()
    got = mr.run_stream(shards, fn, batch_size=2, image_size=SIZE, feeder_threads=2,
                        retry=_fast_retry(mr), journal=journal, resume=True,
                        report=report)
    assert got.table.tobytes() == ref.table.tobytes()
    assert report.document()["resumed"] == ["Easy_0.tar", "Normal_0.tar"]


def test_resume_after_a_run_that_is_not_a_prefix(shards, tmp_path):
    """Shards 1 and 2 journaled by a run over them alone; the resumed run over the full
    list encodes 0 and tries 3-5 and folds the sums in list order."""
    fn = _encoders()[1]
    ref = mr.run_stream(shards, fn, batch_size=2, image_size=SIZE, retry=_fast_retry(mr))
    journal = ShardJournal(str(tmp_path / "_journal"))
    mr.run_stream(shards[1:3], fn, batch_size=2, image_size=SIZE, journal=journal)
    report = mr.MapReport()
    got = mr.run_stream(shards, fn, batch_size=2, image_size=SIZE, retry=_fast_retry(mr),
                        journal=journal, resume=True, report=report)
    assert got.table.tobytes() == ref.table.tobytes()
    doc = report.document()
    assert [r["status"] for r in doc["shards"]] == ["ok", "resumed", "resumed"] + [
        "quarantined"] * 3


def test_quarantine_invalidates_marker_and_cleans_features(shards, tmp_path):
    fn = _encoders()[1]
    root = str(tmp_path / "features")
    save, cleanup, sync = mr.make_feature_sinks(root)
    journal = ShardJournal(str(tmp_path / "_journal"))
    mr.run_stream(shards[:3], fn, batch_size=2, image_size=SIZE, save_features=save,
                  journal=journal, cleanup_features=cleanup, sync_features=sync)
    assert journal.done("Easy_0.tar") is not None
    faults.configure("journal:shard=0:raise=OSError")
    report = mr.MapReport()
    acc = mr.run_stream(shards[:3], fn, batch_size=2, image_size=SIZE,
                        save_features=save, retry=_fast_retry(mr, max_attempts=2),
                        journal=journal, report=report, cleanup_features=cleanup,
                        sync_features=sync)
    assert report.document()["shards"][0]["images"] == 0 and acc.table[0, 4] == 0
    assert journal.done("Easy_0.tar") is None
    assert not os.path.exists(os.path.join(root, "Easy", "Easy_0"))
    assert not glob.glob(os.path.join(root, "**", "*.tmp.*"), recursive=True)


def test_duplicate_journal_keys_are_refused(shards, tmp_path):
    fn = _encoders()[1]
    other = tmp_path / "again"
    other.mkdir()
    dup = str(other / "Easy_0.tar")
    with pytest.raises(ValueError, match="duplicate shard journal keys"):
        mr.run_stream([shards[0], dup], fn, batch_size=2, image_size=SIZE,
                      journal=ShardJournal(str(tmp_path / "_journal")))


# ------------------------------------------------------------ report, refusals
def test_map_report_validator():
    doc = mr.MapReport().document()
    assert validate_map_report(doc) == []
    bad = dict(doc, shards=[{"shard": "a", "status": "lost", "causes": [{"cause": "x"}]}])
    problems = validate_map_report(bad)
    assert any("bad status" in p for p in problems)
    assert any("bad cause" in p for p in problems)
    assert any("missing 'attempts'" in p for p in problems)
    assert any("ROADMAP A8" in p for p in validate_map_report(dict(doc, metrics={})))


def test_unported_parts_are_refused_by_name(shards, tmp_path, monkeypatch, capsys):
    """allreduce stays refused. A ``tcp://`` target builds network sinks (the gallery's
    feature sink, ``tests/test_torch_gallery.py``), which raise for retry on a dead
    address: ``map`` retries the shard, quarantines it and commits no marker. The
    exported-encoder artifact is ported (``tests/test_torch_export.py`` runs it), and
    without a GPU ``map --artifact`` refuses the CPU unless ``--device cpu`` is given,
    before it reads the artifact."""
    import socket

    import tmr_tpu_torch.models

    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        mr.allreduce_stats(np.zeros((4, 5)))
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    dead = f"tcp://127.0.0.1:{s.getsockname()[1]}"
    s.close()
    save, cleanup, sync = mr.make_feature_sinks(dead)
    with pytest.raises(ConnectionError, match="unreachable"):
        save("Easy_0.tar", "img_0.png", np.zeros(3, np.float32))
    model = SamViT(**TINY, dtype=torch.float32).eval()
    monkeypatch.setattr(tmr_tpu_torch.models, "build_sam_encoder", lambda *a, **k: model)
    monkeypatch.setattr("sys.stdin", io.StringIO("Easy_0.tar\n"))
    report = tmp_path / "report.json"
    assert mr.main(["map", "--data_dir", str(tmp_path), "--features_out", dead,
                    "--journal_dir", str(tmp_path / "j"), "--device", "cpu",
                    "--image_size", str(SIZE), "--batch_size", "2", "--max_attempts", "2",
                    "--backoff_base", "0.01", "--report_out", str(report)]) == 0
    shard = json.loads(report.read_text())["shards"][0]
    assert (shard["shard"], shard["status"], shard["attempts"]) == \
        ("Easy_0.tar", "quarantined", 2)
    assert ShardJournal(str(tmp_path / "j")).load_all() == {}
    assert capsys.readouterr().out == ""
    assert "artifact" not in mr._REFUSED and "tcp" not in mr._REFUSED
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr("sys.stdin", io.StringIO(""))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mr.main(["map", "--artifact", str(tmp_path / "enc.pt2")])
    with pytest.raises(FileNotFoundError):
        mr.make_encode_stats_fn_from_artifact(str(tmp_path / "enc.pt2"), "cpu")


def test_native_reader_builds_into_the_port(tmp_path):
    from tmr_tpu_torch.data import native_io

    assert native_io.available()
    assert Path(native_io.ensure_built()).parent == REPO / "tmr_tpu_torch" / "_build"
    rng = np.random.default_rng(9)
    members = [(f"m{i}.png", _png(rng, 8, 8)) for i in range(3)]
    path = _make_tar(tmp_path / "Easy_1.tar", members)
    with native_io.NativeTarStream([path, str(tmp_path / "gone.tar")], threads=2) as s:
        got = sorted((name, data) for _, name, data in s)
        assert s.errors == 1
    assert got == sorted(members)


# --------------------------------------------------------------------- CLI
def test_map_reduce_cli_matches_jax(shards, tmp_path, monkeypatch, capsys):
    """``map`` then ``reduce`` with the TINY encoders swapped in for
    ``build_sam_encoder`` in both packages: stdout holds only records, the records and
    the report agree, and the reduce table equals the JAX one on the same records."""
    import tmr_tpu.models
    import tmr_tpu_torch.models

    _, _, jmodel, params, model = _encoders()
    monkeypatch.setattr(tmr_tpu.models, "build_sam_encoder",
                        lambda *a, **k: (jmodel, params))
    monkeypatch.setattr(tmr_tpu_torch.models, "build_sam_encoder", lambda *a, **k: model)
    names = "\n".join(os.path.basename(p) for p in shards) + "\n"
    out = {}
    for tag, mod in (("jax", jmr), ("port", mr)):
        monkeypatch.setattr("sys.stdin", io.StringIO(names))
        argv = ["map", "--data_dir", str(tmp_path), "--batch_size", "2",
                "--image_size", str(SIZE), "--features_out", str(tmp_path / f"f_{tag}"),
                "--report_out", str(tmp_path / f"{tag}.json"), "--backoff_base", "0.001"]
        if tag == "port":
            argv += ["--device", "cpu"]
        assert mod.main(argv) == 0
        out[tag] = capsys.readouterr().out.splitlines()
    assert out["port"] and all(RECORD.match(line) for line in out["port"]), out["port"]
    assert [r.split("\t")[0] for r in out["port"]] == [r.split("\t")[0] for r in out["jax"]]
    for got, want in zip(out["port"], out["jax"]):
        g, w = (np.array(r.split("\t")[1].split(","), np.float64) for r in (got, want))
        assert g[4] == w[4]
        _close(g, w, TOL["float32"])
    docs = {t: json.loads((tmp_path / f"{t}.json").read_text()) for t in ("jax", "port")}
    assert _records(docs["port"]) == _records(docs["jax"])
    assert sorted(_tree(str(tmp_path / "f_port"))) == sorted(_tree(str(tmp_path / "f_jax")))

    monkeypatch.setattr("sys.stdin", io.StringIO("\n".join(out["port"]) + "\n"))
    assert mr.main(["reduce"]) == 0
    table = capsys.readouterr().out
    assert table == jmr.format_stats_table(jmr.reduce_lines(out["port"])) + "\n"
    assert mr.reducer_table(np.zeros((4, 5))) == jmr.reducer_table(np.zeros((4, 5)))


def test_map_cli_resume_replays_the_same_records(shards, tmp_path, monkeypatch, capsys):
    import tmr_tpu_torch.models

    monkeypatch.setattr(tmr_tpu_torch.models, "build_sam_encoder",
                        lambda *a, **k: _encoders()[4])
    argv = ["map", "--data_dir", str(tmp_path), "--batch_size", "2", "--image_size",
            str(SIZE), "--features_out", str(tmp_path / "f"), "--device", "cpu",
            "--no_native", "--report_out", str(tmp_path / "r.json")]
    lines = []
    for extra in ([], ["--resume"]):
        monkeypatch.setattr("sys.stdin", io.StringIO("\n".join(shards[:3]) + "\n"))
        assert mr.main(argv + extra) == 0
        lines.append(capsys.readouterr().out)
    assert lines[0] == lines[1]
    assert json.loads((tmp_path / "r.json").read_text())["resumed"] == [
        "Easy_0.tar", "Normal_0.tar", "Hard_0.tar"]


def test_reduce_lines_tolerates_malformed_records():
    lines = ["Easy\t1.0,2.0,3.0,0.5,2", "garbage", "Easy\t1.0,2.0", "",
             "Hard\t0.1,0.2,0.3,0.9,1", "Easy\t3.0,2.0,1.0,0.5,2"]
    got = mr.reduce_lines(lines)
    want = jmr.reduce_lines(lines)
    assert sorted(got) == sorted(want) == ["Easy", "Hard"]
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert mr.format_stats_table(got) == jmr.format_stats_table(want)


def test_backoff_and_emit_lines_match_jax():
    for attempt in range(1, 6):
        for key in (0, 3, 1 << 20):
            assert mr.backoff_delay(attempt, 0.5, 4.0, 0.5, key) == jmr.backoff_delay(
                attempt, 0.5, 4.0, 0.5, key)
    assert mr.RetryPolicy(seed=2).delay(3, 2) == jmr.RetryPolicy(seed=2).delay(3, 2)
    table = np.arange(20, dtype=np.float64).reshape(4, 5) / 7.0
    table[1, 4] = 0.0
    acc, jacc = mr.StatAccumulator(), jmr.StatAccumulator()
    acc.table[:], jacc.table[:] = table, table
    assert acc.emit_lines() == jacc.emit_lines()
    assert [mr.category_of(n) for n in ("Easy_0.tar", "/x/Hard_2.tar", "Normal.tar",
                                        "EasyX_1.tar")] == [0, 2, 3, 3]


def test_map_cli_subprocess_stdout_is_records_only(tmp_path):
    """The real CLI (SAM ViT-B, seeded weights, on the CPU at 32^2) piped into
    ``reduce``: stdout carries the records and nothing else."""
    rng = np.random.default_rng(11)
    _make_tar(tmp_path / "Hard_0.tar", [(f"x{i}.png", _png(rng, 24, 36)) for i in range(3)])
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
    cmd = [sys.executable, "-m", "tmr_tpu_torch.parallel.mapreduce"]
    mapped = subprocess.run(
        cmd + ["map", "--data_dir", str(tmp_path), "--device", "cpu", "--image_size",
               "32", "--batch_size", "2", "--features_out", str(tmp_path / "f")],
        input="Hard_0.tar\n", capture_output=True, text=True, env=env, cwd=REPO,
        timeout=300)
    assert mapped.returncode == 0, mapped.stderr
    assert RECORD.match(mapped.stdout.strip()) and mapped.stdout.count("\n") == 1
    assert "[INFO] map: 1 shards from stdin" in mapped.stderr
    assert np.load(tmp_path / "f" / "Hard" / "Hard_0" / "x0.npy").shape == (2, 2, 256)
    reduced = subprocess.run(cmd + ["reduce"], input=mapped.stdout, capture_output=True,
                             text=True, env=env, cwd=REPO, timeout=300)
    assert reduced.returncode == 0
    assert reduced.stdout.splitlines()[2].startswith("Hard         |      3 |")
