"""PyTorch/CUDA port of ``tmr_tpu`` for NVIDIA Hopper GPUs.

A package of its own: it imports ``torch``, ``numpy`` and the standard library only,
never JAX and nothing of ``tmr_tpu``. Module names mirror ``tmr_tpu``'s, so each
counterpart is found under the same path. The hand-written CUDA kernels live in
``csrc/`` and are bound in ``ops/cuda_attn.py``, ``ops/cuda_xcorr.py`` and
``ops/cuda_nms.py``.
"""
