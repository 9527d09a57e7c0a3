"""Operators of the PyTorch port (counterpart of ``tmr_tpu/ops``)."""
