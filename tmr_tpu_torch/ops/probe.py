"""The toolchain probe: ``x + 1`` as a hand-written CUDA kernel and its plain version.

Replaces ``scripts/gate_probe.py``'s ``add1`` (a trivial Pallas kernel that showed
whether Mosaic lowers at all). Here it shows that ``nvcc`` builds for ``sm_90a``, that
``ctypes`` binds the library and that a kernel launches on PyTorch's stream;
``chip_smoke.py`` runs it before any other kernel.

Like every kernel of the port it is a registered ``torch.library`` op, ``tmr::add1``: its
CPU kernel is the plain version, its CUDA kernel launches ``csrc/probe.cu`` or raises.
``chip_smoke.py`` times a call through the op beside the bare launch: the host's cost of
the dispatch.
"""

from __future__ import annotations

import torch

from tmr_tpu_torch.ops import _build


def add1_plain(x: torch.Tensor) -> torch.Tensor:
    return x + 1.0


def add1(x: torch.Tensor) -> torch.Tensor:
    """``x + 1`` for an f32 tensor."""
    return torch.ops.tmr.add1(x)


@torch.library.custom_op("tmr::add1", mutates_args=(), device_types="cpu",
                         schema="(Tensor x) -> Tensor")
def _add1_op(x):
    """The op of :func:`add1`; this, its CPU kernel, is the plain version."""
    return add1_plain(x)


@_add1_op.register_fake
def _add1_fake(x):
    return torch.empty_like(x)


@_add1_op.register_kernel("cuda")
def _add1_cuda(x):
    """The op's CUDA kernel: one launch of ``tmr_add1``."""
    if x.dtype != torch.float32:
        raise ValueError("add1: the kernel takes f32")
    x = x.contiguous()
    out = torch.empty_like(x)
    _build.launch("add1", "probe", "tmr_add1", x.data_ptr(), out.data_ptr(), x.numel(),
                  _build.stream_of(x))
    return out
