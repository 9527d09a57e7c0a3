"""``meta`` tensors standing for the card's in the port's CPU tests.

Each kernel of the port is a registered ``tmr::`` op: a CPU tensor runs its plain
version, a CUDA tensor its CUDA kernel (the launch code), and a ``meta`` tensor its fake
implementation (shapes only). While :class:`CardRoute` is active, a ``tmr::`` op called
on ``meta`` tensors runs its CUDA kernel instead, as a CUDA tensor would: with
``_build.launch`` stubbed by the test, that shows which kernel a call launches, with what
arguments, and what the kernel route refuses, on a machine without a card."""

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from tmr_tpu_torch.ops import cuda_attn, cuda_int8, cuda_nms, cuda_xcorr, probe


def cuda_kernels() -> dict:
    """Each ``tmr::`` op's CUDA kernel."""
    ops = torch.ops.tmr
    return {
        ops.global_attn.default: cuda_attn._global_attn_cuda,
        ops.window_attn.default: cuda_attn._window_attn_cuda,
        ops.xcorr.default: cuda_xcorr._xcorr_cuda,
        ops.xcorr_int8.default: cuda_xcorr._xcorr_int8_cuda,
        ops.nms.default: cuda_nms._nms_cuda,
        ops.int8_mm.default: cuda_int8._int8_mm_cuda,
        ops.int8_conv3x3.default: cuda_int8._int8_conv3x3_cuda,
        ops.add1.default: probe._add1_cuda,
    }


class CardRoute(TorchDispatchMode):
    """``tmr::`` ops run their CUDA kernels; every other op runs as it would."""

    def __init__(self):
        super().__init__()
        self.kernels = cuda_kernels()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        return self.kernels.get(func, func)(*args, **(kwargs or {}))
