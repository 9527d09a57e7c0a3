"""The toolchain probe: ``x + 1`` as a hand-written CUDA kernel and its plain version.

Replaces ``scripts/gate_probe.py``'s ``add1`` (a trivial Pallas kernel that showed
whether Mosaic lowers at all). Here it shows that ``nvcc`` builds for ``sm_90a``, that
``ctypes`` binds the library and that a kernel launches on PyTorch's stream;
``chip_smoke.py`` runs it before any other kernel.

The wrapper runs the plain version only for CPU tensors; a CUDA tensor launches
``csrc/probe.cu`` or raises.
"""

from __future__ import annotations

import torch

from tmr_tpu_torch.ops import _build


def add1_plain(x: torch.Tensor) -> torch.Tensor:
    return x + 1.0


def add1(x: torch.Tensor) -> torch.Tensor:
    """``x + 1`` for an f32 tensor."""
    if x.device.type == "cpu":
        return add1_plain(x)
    if x.dtype != torch.float32:
        raise ValueError("add1: the kernel takes f32")
    x = x.contiguous()
    out = torch.empty_like(x)
    _build.launch("add1", "probe", "tmr_add1", x.data_ptr(), out.data_ptr(), x.numel(),
                  _build.stream_of(x))
    return out
