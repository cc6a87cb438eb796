"""Grouped-scale int8 quantization for the sparse value streams.

Port of the numpy half of ``repro.optim.compress`` (``INT8_GROUP``,
``quantize_int8_grouped``, ``dequantize_int8_grouped``), copied so that the
port never imports the reference.  Values are split into fixed-size groups
along the streaming axis; each group stores one f32 scale = max|v|/127 and
int8 codes q = round(v/scale).  The CSR-k tile view quantizes its value
stream with these helpers so the kernel moves 1 byte per nonzero value
instead of 4; accumulation stays f32 (dequantize-then-multiply in-kernel).
"""
from __future__ import annotations

import numpy as np

INT8_GROUP = 128   # one scale per 128 slots (tile slot counts are 128 multiples)


def quantize_int8_grouped(vals, group: int = INT8_GROUP):
    """Symmetric per-group int8 quantization along the last axis (host-side).

    Args:
      vals: numpy array whose last-axis length is a multiple of ``group``.
      group: values per scale group.

    Returns:
      ``(q, scales)`` — ``q`` int8 with ``vals.shape``; ``scales`` float32
      with the last axis reduced by ``group``.  All-zero groups get scale 1.0
      so dequantization stays exact for padding slots.
    """
    v = np.asarray(vals, np.float32)
    if v.shape[-1] % group:
        raise ValueError(f"last axis {v.shape[-1]} not a multiple of group {group}")
    g = v.reshape(v.shape[:-1] + (v.shape[-1] // group, group))
    amax = np.abs(g).max(axis=-1)
    scales = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    q = np.rint(g / scales[..., None]).clip(-127, 127).astype(np.int8)
    return q.reshape(v.shape), scales


def dequantize_int8_grouped(q, scales, group: int = INT8_GROUP):
    """Inverse of :func:`quantize_int8_grouped` (host-side numpy)."""
    q = np.asarray(q, np.float32)
    s = np.repeat(np.asarray(scales, np.float32), group, axis=-1)
    return q * s
