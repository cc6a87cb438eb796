"""Segmented-sum SpMV: the CUDA kernel's wrapper and its plain version.

Replaces ``repro.kernels.spmv_segsum.spmv_segsum_pallas`` together with the
carry scatter-add of ``repro.kernels.ops.spmv_segsum``.  On CUDA tensors
:func:`spmv_segsum_chunks` launches the hand-written Hopper kernel in
``csrc/spmv_segsum.cu`` (design notes there: a chunk pass that reads the
segment-start table in place of ``local_seg``, and a carry pass); on CPU
tensors it runs the plain PyTorch version
:func:`repro_torch.kernels.ref.segsum_table_rows`, which reads the same
table.  There is no fallback from one to the other: a CUDA input the kernel
does not take raises.
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
_LL = ctypes.c_longlong


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built kernel library, with its C signature declared (once)."""
    lib = build.load("spmv_segsum")
    lib.repro_spmv_segsum.argtypes = [
        _I, _I, _P, _P, _P, _P, _P, _I, _P, _I, _P, _LL, _I, _P, _P, _I, _I, _I, _I, _LL, _P,
    ]
    lib.repro_spmv_segsum.restype = _I
    lib.repro_segsum_error_string.argtypes = [_I]
    lib.repro_segsum_error_string.restype = ctypes.c_char_p
    return lib


def spmv_segsum_chunks(
    vals: torch.Tensor,          # [T, S] f32 | bf16 | int8
    col_idx: torch.Tensor,       # [T, S] int32
    seg_row: torch.Tensor,       # [T, R] int32, unused segments → m
    seg_start: torch.Tensor,     # [T + 1 + Σ_t L_t] int32 (SegSumCSR.seg_start)
    carry: torch.Tensor,         # [P, 3] int32 rows spanning chunks (SegSumCSR.carry)
    x: torch.Tensor,             # [n] or [n, B] f32 | bf16
    val_scale: Optional[torch.Tensor] = None,   # [T, S/group] f32, int8 only
    *,
    m: int,
    nnz: int,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """y = A x over all T chunks, in row order: ``[m]`` (``[m, B]``).

    ``nnz`` is the number of real slots (the container's ``nnz_real``): the
    kernel reads slots ``[0, nnz)`` of the flat stream and skips the tail
    chunk's padding.  ``seg_start`` is the segment-start table the kernel
    reads in place of ``local_seg`` (``[T + 1]`` offsets into itself, then
    each chunk's segment starts); ``carry`` lists the rows that
    span chunks, whose fragments the carry pass sums.  The kernel writes
    every row of y, empty rows as 0, so ``out`` (if given, ``[m]``/``[m, B]``
    in x's dtype on x's device) need not be cleared.  On CUDA ``x`` is
    float32 or bfloat16 and y comes out in x's dtype: each row is summed in
    f32 (the fragments of rows that span chunks too) and rounded once.
    CUDA calls add one to ``spmv_segsum_chunks.launches``; each is two CUDA
    launches, the chunk pass and the carry pass.
    """
    if x.device.type == "cpu":
        y = ref.segsum_table_rows(vals, col_idx, seg_row, seg_start, x, val_scale, m=m,
                                  nnz=nnz)
        return y if out is None else out.copy_(y)

    dev = x.device
    if vals.ndim != 2 or seg_row.ndim != 2:
        raise ValueError(f"vals must be [T, S] and seg_row [T, R], got shapes "
                         f"{tuple(vals.shape)} and {tuple(seg_row.shape)}")
    T, S = vals.shape
    R = int(seg_row.shape[1])
    if S % 128:
        raise ValueError(f"chunks must hold a multiple of 128 slots, got {S}")
    if x.ndim not in (1, 2):
        raise ValueError(f"x must be [n] or [n, B], got shape {tuple(x.shape)}")
    if not 0 <= nnz <= T * S:
        raise ValueError(f"nnz {nnz} does not fit {T} chunks of {S} slots")
    B = 1 if x.ndim == 1 else int(x.shape[1])
    check_operand("x", x, dev, tuple(X_KIND))
    check_operand("vals", vals, dev, tuple(_VALUE_KIND))
    check_operand("col_idx", col_idx, dev, (torch.int32,), (T, S))
    check_operand("seg_row", seg_row, dev, (torch.int32,), (T, R))
    least = T + 1 + -(-nnz // S)   # the offsets, and a start in every chunk with slots
    if seg_start is None or seg_start.ndim != 1 or seg_start.shape[0] < least:
        raise ValueError(f"seg_start must be a table of at least {least} entries, got "
                         f"{None if seg_start is None else tuple(seg_start.shape)}")
    check_operand("seg_start", seg_start, dev, (torch.int32,))
    if carry.ndim != 2 or carry.shape[1] != 3:
        raise ValueError(f"carry must be [P, 3], got shape {tuple(carry.shape)}")
    check_operand("carry", carry, dev, (torch.int32,))
    groups = 0
    if vals.dtype == torch.int8:
        if val_scale is None:
            raise ValueError("int8 values need val_scale")
        groups = int(val_scale.shape[-1])
        if groups == 0 or S % groups:
            raise ValueError(f"val_scale has {groups} groups for {S} slots")
        check_operand("val_scale", val_scale, dev, (torch.float32,), (T, groups))
    elif val_scale is not None:
        raise ValueError(f"val_scale is only for int8 values, got {vals.dtype}")
    if out is None:
        out = torch.empty((m,) + tuple(x.shape[1:]), dtype=x.dtype, device=dev)
    else:
        check_operand("out", out, dev, (x.dtype,), (m,) + tuple(x.shape[1:]))
    if out.numel() == 0:
        return out
    part = torch.empty((T, 2, B), dtype=torch.float32, device=dev)   # fragment sums

    lib = _library()
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = lib.repro_spmv_segsum(
        _VALUE_KIND[vals.dtype], X_KIND[x.dtype], ptr(vals), ptr(col_idx), ptr(seg_start),
        ptr(seg_row), ptr(carry), int(carry.shape[0]), ptr(val_scale), groups, ptr(x),
        int(x.shape[0]), B, ptr(out), ptr(part), m, T, S, R, int(nnz),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            f"spmv_segsum kernel launch failed: {lib.repro_segsum_error_string(err).decode()}"
        )
    spmv_segsum_chunks.launches += 1
    return out


spmv_segsum_chunks.launches = 0
