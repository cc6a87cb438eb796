"""SELL-C-σ chunk SpMV: the CUDA kernel's wrapper and its plain version.

Replaces ``repro.kernels.spmv_sellcs.spmv_sellcs_pallas`` together with the
``row_perm`` scatter of ``repro.kernels.ops.spmv_sellcs``.  On CUDA tensors
:func:`spmv_sellcs_chunks` launches the hand-written Hopper kernel in
``csrc/spmv_sellcs.cu`` (design notes there); on CPU tensors it runs the
plain PyTorch version :func:`repro_torch.kernels.ref.sellcs_chunk_rows`.
There is no fallback from one to the other: a CUDA input the kernel does
not take raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.spmv_csrk import X_KIND, check_operand

_VALUE_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built kernel library, with its C signature declared (once)."""
    lib = build.load("spmv_sellcs")
    lib.repro_spmv_sellcs.argtypes = [
        _I, _I, _P, _P, _P, _P, _P, _I, _P, ctypes.c_longlong, _I, _P, _I, _I, _I, _I, _P,
    ]
    lib.repro_spmv_sellcs.restype = _I
    lib.repro_sellcs_error_string.argtypes = [_I]
    lib.repro_sellcs_error_string.restype = ctypes.c_char_p
    return lib


def spmv_sellcs_chunks(
    vals: torch.Tensor,          # [T, C, W] f32 | bf16 | int8
    col_idx: torch.Tensor,       # [T, C, W] int32
    row_perm: torch.Tensor,      # [T·C] int32, sorted position → original row (pad → m)
    chunk_width: torch.Tensor,   # [T] int32 real lanes of each chunk
    x: torch.Tensor,             # [n] or [n, B] f32 | bf16
    val_scale: Optional[torch.Tensor] = None,   # [T, C, W/group] f32, int8 only
    *,
    m: int,
    out: Optional[torch.Tensor] = None,         # [m] or [m, B]
) -> torch.Tensor:
    """y = A x over all T chunks, in the original row order: ``[m]`` (``[m, B]``).

    The kernel reads lanes ``[0, chunk_width[t])`` of each chunk and writes
    row ``row_perm[i]`` of y; pad rows (``row_perm == m``) are not written.
    With ``out`` given, the rows are written there (and ``out`` returned)
    and every other row of ``out`` keeps its value, so launches over
    disjoint chunk subsets (``row_perm.view(T, C)[ids].reshape(-1)`` and
    ``chunk_width[ids]``) fill one y.  On CUDA ``x`` is float32 or bfloat16
    and y comes out in x's dtype (``out`` must have it), summed in f32 and
    rounded once.  CUDA launches add one to ``spmv_sellcs_chunks.launches``.
    """
    if x.device.type == "cpu":
        return ref.sellcs_chunk_rows(vals, col_idx, row_perm, x, val_scale, m=m, out=out)

    dev = x.device
    if vals.ndim != 3:
        raise ValueError(f"vals must be [T, C, W], got shape {tuple(vals.shape)}")
    T, C, W = vals.shape
    if x.ndim not in (1, 2):
        raise ValueError(f"x must be [n] or [n, B], got shape {tuple(x.shape)}")
    B = 1 if x.ndim == 1 else int(x.shape[1])
    check_operand("x", x, dev, tuple(X_KIND))
    check_operand("vals", vals, dev, tuple(_VALUE_KIND))
    check_operand("col_idx", col_idx, dev, (torch.int32,), (T, C, W))
    check_operand("row_perm", row_perm, dev, (torch.int32,), (T * C,))
    check_operand("chunk_width", chunk_width, dev, (torch.int32,), (T,))
    groups = 0
    if vals.dtype == torch.int8:
        if val_scale is None:
            raise ValueError("int8 values need val_scale")
        groups = int(val_scale.shape[-1])
        if groups == 0 or W % groups:
            raise ValueError(f"val_scale has {groups} groups for {W} lanes")
        check_operand("val_scale", val_scale, dev, (torch.float32,), (T, C, groups))
    elif val_scale is not None:
        raise ValueError(f"val_scale is only for int8 values, got {vals.dtype}")
    if out is None:
        out = torch.empty((m,) + tuple(x.shape[1:]), dtype=x.dtype, device=dev)
    else:
        check_operand("out", out, dev, (x.dtype,), (m,) + tuple(x.shape[1:]))
    if out.numel() == 0 or T == 0:
        return out

    lib = _library()
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = lib.repro_spmv_sellcs(
        _VALUE_KIND[vals.dtype], X_KIND[x.dtype], ptr(vals), ptr(col_idx), ptr(row_perm),
        ptr(chunk_width), ptr(val_scale), groups, ptr(x), int(x.shape[0]), B, ptr(out), m, T, C, W,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            f"spmv_sellcs kernel launch failed: {lib.repro_sellcs_error_string(err).decode()}"
        )
    spmv_sellcs_chunks.launches += 1
    return out


spmv_sellcs_chunks.launches = 0
