"""The port's chaos gauntlets (``python -m tmr_tpu_torch.chaos_probe``, the counterpart
of ``scripts/chaos_probe.py``) pass, and the worker payload (``utils/package.py``) holds
what a worker needs.

- single-process: every injected fault retried to success or quarantined with a
  recorded cause, tables and feature bytes identical to the fault-free run,
  crash + resume byte-identical;
- elastic (``--elastic``): 3 worker processes over 8 shards with one kill -9'd
  mid-shard and one SIGSTOPped past the heartbeat window: the run completes, the table
  is byte-identical to the single-process run, the elastic_report/v1 reconciles exactly,
  and the SIGSTOP scenario ends in >= 1 fenced-commit rejection.

Each runs in a subprocess under its own timeout, on the CPU with the stand-in encoders.
"""

import os
import subprocess
import sys
import zipfile
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "tmr_tpu_torch"


def _env(**kw):
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO), **kw)
    env.pop("TMR_FAULTS", None)
    return env


@pytest.mark.parametrize("elastic", [False, True], ids=["single", "elastic"])
def test_chaos_probe_passes(tmp_path, elastic):
    argv = [sys.executable, "-m", "tmr_tpu_torch.chaos_probe", "--work_dir",
            str(tmp_path / "work")] + (["--elastic"] if elastic else [])
    res = subprocess.run(argv, cwd=REPO, env=_env(), capture_output=True, text=True,
                         timeout=240)
    assert res.returncode == 0, res.stderr[-4000:]
    assert "all checks passed" in res.stderr
    assert "[FAIL]" not in res.stderr


def _payload(tmp_path) -> Path:
    from tmr_tpu_torch.utils.package import package_modules

    return Path(package_modules(str(tmp_path / "Package_Modules.zip")))


def test_payload_holds_every_source_and_csrc(tmp_path):
    zip_path = _payload(tmp_path)
    with zipfile.ZipFile(zip_path) as z:
        names = set(z.namelist())
    want = {str(p.relative_to(REPO)) for p in PORT.rglob("*.py")
            if "__pycache__" not in p.parts and "_build" not in p.parts}
    want |= {str(p.relative_to(REPO)) for p in (PORT / "csrc").glob("*.cu")}
    assert names == want
    assert "tmr_tpu_torch/csrc/attn.cu" in names
    assert not [n for n in names if n.endswith((".so", ".pyc", ".pth"))]


def _run_isolated(code: str, cwd: Path) -> subprocess.CompletedProcess:
    """``python -c code`` where the repo is not importable (another cwd, no
    PYTHONPATH), so that every import comes from what ``code`` puts on sys.path."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_elastic_imports_from_the_zip_and_builds_refuse_there(tmp_path):
    zip_path = _payload(tmp_path)
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(zip_path)!r})\n"
        "import tmr_tpu_torch.parallel.elastic as e, tmr_tpu_torch.elastic_map\n"
        "assert '.zip' in e.__file__, e.__file__\n"
        "from tmr_tpu_torch.ops import _build\n"
        "for call in (lambda: _build.build(('probe',)), lambda: _build.lib('probe')):\n"
        "    try:\n"
        "        call()\n"
        "    except RuntimeError as err:\n"
        "        assert 'unpack the payload' in str(err), err\n"
        "    else:\n"
        "        raise AssertionError('a build from the zip did not raise')\n"
        "print('ok')\n")
    res = _run_isolated(code, tmp_path)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr[-3000:]


def test_unpacked_payload_runs_the_worker_cli(tmp_path):
    """The worker CLI from the unpacked payload, with a TINY exported encoder in place of
    weights (``--artifact``, ``--device cpu``), serves a coordinator in the same process:
    the table it leaves equals the in-process run of the encoder the artifact holds,
    byte for byte."""
    from tmr_tpu_torch.chaos_probe import make_tar
    from tmr_tpu_torch.models.vit import SamViT
    from tmr_tpu_torch.parallel import mapreduce as mr
    from tmr_tpu_torch.utils.export import export_encoder, save_exported
    from tmr_tpu_torch.utils.package import unpack_payload
    from tmr_tpu_torch.utils.weights import init_params

    dest = unpack_payload(str(_payload(tmp_path)), str(tmp_path / "payload"))
    encoder = SamViT(embed_dim=32, depth=2, num_heads=2, global_attn_indexes=(1,),
                     window_size=2, out_chans=8, pretrain_img_size=32)
    init_params(encoder, 0)
    encoder.eval()
    artifact = str(tmp_path / "enc.pt2")
    with torch.no_grad():
        save_exported(export_encoder(encoder, image_size=32), artifact)
    shard = make_tar(str(tmp_path), "Easy_0.tar", 3, seed=0)
    want = mr.run_stream([shard], mr.make_encode_stats_fn(encoder), 2, 32).emit_lines()
    code = (
        "import sys\n"
        f"sys.path.insert(0, {dest!r})\n"
        "from tmr_tpu_torch.ops import _build\n"
        f"assert _build.CSRC.is_dir() and str(_build.CSRC).startswith({dest!r})\n"
        "from tmr_tpu_torch import elastic_map\n"
        "from tmr_tpu_torch.parallel.elastic import ElasticCoordinator, ElasticPolicy\n"
        "from tmr_tpu_torch.parallel.mapreduce import StatAccumulator\n"
        f"coord = ElasticCoordinator([{shard!r}], {str(tmp_path / 'j')!r}, "
        f"features_out={str(tmp_path / 'f')!r}, image_size=32, batch_size=2, "
        "policy=ElasticPolicy(lease_ttl_s=10.0, hb_interval_s=0.5, check_interval_s=0.1, "
        "straggler_factor=0.0))\n"
        "host, port = coord.start()\n"
        "rc = elastic_map.main(['worker', '--coordinator', f'{host}:{port}', '--artifact', "
        f"{artifact!r}, '--device', 'cpu', '--max_idle_s', '5'])\n"
        "assert rc == 0 and coord.wait(timeout=60), rc\n"
        "acc = StatAccumulator()\n"
        "acc.table = coord.table()\n"
        "coord.stop()\n"
        "print('\\n'.join(acc.emit_lines()))\n")
    res = _run_isolated(code, tmp_path)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.splitlines() == want and len(want) == 1
