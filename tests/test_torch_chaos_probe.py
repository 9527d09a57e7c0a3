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
    from tmr_tpu_torch.utils.package import unpack_payload

    dest = unpack_payload(str(_payload(tmp_path)), str(tmp_path / "payload"))
    code = (
        "import sys\n"
        f"sys.path.insert(0, {dest!r})\n"
        "from tmr_tpu_torch.ops import _build\n"
        f"assert _build.CSRC.is_dir() and str(_build.CSRC).startswith({dest!r})\n"
        "from tmr_tpu_torch import elastic_map\n"
        "try:\n"
        "    elastic_map.main(['worker', '--coordinator', '127.0.0.1:9', '--artifact', "
        "'x'])\n"
        "except NotImplementedError as err:\n"
        "    assert 'ROADMAP A7' in str(err)\n"
        "print('ok')\n")
    res = _run_isolated(code, tmp_path)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr[-3000:]
