"""CSR-k tile SpMV: the CUDA kernel's wrapper and its plain version.

Replaces ``repro.kernels.spmv_csrk.spmv_csrk_tiles_pallas``.  On CUDA
tensors :func:`spmv_csrk_tiles` launches the hand-written Hopper kernel in
``csrc/spmv_csrk.cu`` (design notes there); on CPU tensors it runs the plain
PyTorch version :func:`repro_torch.kernels.ref.csrk_tile_rows`.  There is no
fallback from one to the other: a CUDA input the kernel does not take
raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build, ref

_VALUE_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
#: the dtypes a CUDA kernel takes for x, and writes y in: the kind passed to it
X_KIND = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built kernel library, with its C signatures declared (once)."""
    lib = build.load("spmv_csrk")
    lib.repro_spmv_csrk_tiles.argtypes = [
        _I, _I, _P, _P, _P, _P, _P, _I, _P, _P, _I, _P, ctypes.c_longlong, _I,
        _P, _I, _I, _I, _I, _P,
    ]
    lib.repro_spmv_csrk_tiles.restype = _I
    lib.repro_csrk_chunk.argtypes = [_I, _I, _I]
    lib.repro_csrk_chunk.restype = _I
    lib.repro_cuda_error_string.argtypes = [_I]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check_operand(name: str, t: Optional[torch.Tensor], device, dtypes, shape=None):
    if t is None:
        return
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected one of {dtypes}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def spmv_csrk_tiles(
    vals: torch.Tensor,        # [T, S] f32 | bf16 | int8
    local_col: torch.Tensor,   # [T, S] int32
    local_row: torch.Tensor,   # [T, S] int32
    win_block: torch.Tensor,   # [T] int32
    x: torch.Tensor,           # [n] or [n, B] f32 | bf16
    val_scale: Optional[torch.Tensor] = None,   # [T, S/group] f32, int8 only
    *,
    rows_per_tile: int,
    window: int,
    tile_nnz: Optional[torch.Tensor] = None,    # [T] int32 real slots per tile
    tile_ids: Optional[torch.Tensor] = None,    # [T] int32 home tile of each tile
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Run the CSR-k tile kernel over all T tiles.

    Returns ``[T·R]`` (``[T·R, B]``) rows, tile t at rows ``t·R``; with
    ``tile_ids`` and ``out`` (``[num_tiles·R(, B)]`` in x's dtype) tile t is written at
    rows ``tile_ids[t]·R`` of ``out`` instead, and ``out`` is returned — the
    bucketed layout's row scatter (``ops.combine_tile_rows``) done in place.
    ``tile_nnz`` lets the kernel skip each tile's trailing padding slots.
    Unlike the Pallas kernel, ``x`` need not be padded to the window grid:
    reads past its rows see zeros.  On CUDA ``x`` is float32 or bfloat16 and
    y comes out in x's dtype, summed in f32 and rounded once, as the Pallas
    kernel stores it.

    CUDA launches add one to ``spmv_csrk_tiles.launches``.
    """
    T, S = vals.shape
    R = rows_per_tile
    tail = tuple(x.shape[1:])
    if (tile_ids is None) != (out is None):
        raise ValueError("tile_ids and out go together")

    if x.device.type == "cpu":
        y = ref.csrk_tile_rows(
            vals, local_col, local_row, win_block, x, val_scale,
            rows_per_tile=R, window=window,
        )
        if out is None:
            return y
        out.view((-1, R) + tail).index_copy_(0, tile_ids.long(), y.view((T, R) + tail))
        return out

    dev = x.device
    if x.ndim not in (1, 2):
        raise ValueError(f"x must be [n] or [n, B], got shape {tuple(x.shape)}")
    B = 1 if x.ndim == 1 else int(x.shape[1])
    check_operand("x", x, dev, tuple(X_KIND))
    check_operand("vals", vals, dev, tuple(_VALUE_KIND))
    check_operand("local_col", local_col, dev, (torch.int32,), (T, S))
    check_operand("local_row", local_row, dev, (torch.int32,), (T, S))
    check_operand("win_block", win_block, dev, (torch.int32,), (T,))
    check_operand("tile_nnz", tile_nnz, dev, (torch.int32,), (T,))
    check_operand("tile_ids", tile_ids, dev, (torch.int32,), (T,))
    groups = 0
    if vals.dtype == torch.int8:
        if val_scale is None:
            raise ValueError("int8 values need val_scale")
        groups = int(val_scale.shape[1])
        if groups == 0 or S % groups:
            raise ValueError(f"val_scale has {groups} groups for {S} slots")
        check_operand("val_scale", val_scale, dev, (torch.float32,), (T, groups))
    elif val_scale is not None:
        raise ValueError(f"val_scale is only for int8 values, got {vals.dtype}")
    if out is None:
        out = torch.empty((T * R,) + tail, dtype=x.dtype, device=dev)
    else:
        check_operand("out", out, dev, (x.dtype,))
        if out.shape[1:] != x.shape[1:] or out.shape[0] % R:
            raise ValueError(f"out of shape {tuple(out.shape)} does not take {R}-row tiles")
    if T == 0:
        return out

    lib = _library()
    if lib.repro_csrk_chunk(S, R, B) == 0:
        raise ValueError(f"tile of {R} rows x {B} columns does not fit shared memory")
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = lib.repro_spmv_csrk_tiles(
        _VALUE_KIND[vals.dtype], X_KIND[x.dtype], ptr(vals), ptr(local_col), ptr(local_row),
        ptr(win_block), ptr(val_scale), groups, ptr(tile_nnz), ptr(tile_ids),
        out.shape[0] // R, ptr(x), int(x.shape[0]), B, ptr(out), T, S, R, int(window),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            f"spmv_csrk kernel launch failed: {lib.repro_cuda_error_string(err).decode()}"
        )
    spmv_csrk_tiles.launches += 1
    return out


spmv_csrk_tiles.launches = 0
