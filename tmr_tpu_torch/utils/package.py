"""The worker payload (counterpart of ``tmr_tpu/utils/package.py``; the reference's
``Package_Modules.zip``, which Hadoop shipped to its mappers).

    python -m tmr_tpu_torch.utils.package [-o Package_Modules.zip]

The zip holds the ``tmr_tpu_torch`` package's sources: every ``.py`` file and the CUDA
sources ``csrc/*.cu``, from which a worker builds its kernels at first use
(``ops/_build.py``). No build output, cache or weights go in.

**Unpack it on the worker before use** (``unzip Package_Modules.zip -d payload`` or
:func:`unpack_payload`, then ``PYTHONPATH=payload python -m tmr_tpu_torch.elastic_map
worker ...``). The pure-Python modules also import straight from the zip
(``sys.path.insert(0, "Package_Modules.zip")``, as the reference's were), but the kernels
cannot be built there: ``nvcc`` reads ``csrc/`` from a directory and the libraries are
written beside the package (``_build/``), so a kernel build from a zip import raises
and says to unpack.
"""

from __future__ import annotations

import argparse
import os
import zipfile

#: the package directory this module belongs to, and the directory that holds it
_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_BASE = os.path.dirname(_PKG)


def payload_members() -> list:
    """The payload's files as paths relative to the package's parent, sorted: every
    ``.py`` under the package (``__pycache__`` and the ``_build`` outputs skipped) and
    ``csrc/*.cu``."""
    out = []
    for dirpath, dirnames, filenames in os.walk(_PKG):
        dirnames[:] = [d for d in dirnames if d not in ("__pycache__", "_build")]
        in_csrc = dirpath == os.path.join(_PKG, "csrc")
        for name in filenames:
            if name.endswith(".py") or (in_csrc and name.endswith(".cu")):
                out.append(os.path.relpath(os.path.join(dirpath, name), _BASE))
    return sorted(out)


def package_modules(output: str = "Package_Modules.zip") -> str:
    """Write the payload zip to ``output``; returns its path."""
    with zipfile.ZipFile(output, "w", zipfile.ZIP_DEFLATED) as z:
        for rel in payload_members():
            z.write(os.path.join(_BASE, rel), rel)
    return output


def unpack_payload(zip_path: str, dest: str) -> str:
    """Unpack a payload zip under ``dest`` (created if missing); returns ``dest``, the
    directory to put on the worker's ``PYTHONPATH``."""
    os.makedirs(dest, exist_ok=True)
    with zipfile.ZipFile(zip_path) as z:
        z.extractall(dest)
    return dest


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m tmr_tpu_torch.utils.package",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-o", "--output", default="Package_Modules.zip")
    args = p.parse_args(argv)
    out = package_modules(args.output)
    from tmr_tpu_torch.utils.profiling import log_info

    log_info(f"wrote {out} ({os.path.getsize(out) / 1e3:.0f} kB)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
