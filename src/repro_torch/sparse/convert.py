"""Build the port's containers from plain numpy arrays.

Any producer of CSR / CSR-k tile / SELL-C-σ / segmented-sum / DIA-hybrid /
ELL / BCSR / CSR5-like arrays (a file, another framework) can hand its
arrays to the port through these functions; the tests use them to push
identical tiles through both packages' kernels and oracles.  Results live on the CPU; move them with ``.to(device)``.  bf16
values may arrive as an ``ml_dtypes`` bfloat16 array (what ``np.asarray``
gives for a JAX bf16 array) and are reinterpreted bit for bit.
"""
from __future__ import annotations

from typing import Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.sparse.baselines import BCSRMatrix, CSR5LikeMatrix, ELLMatrix
from repro_torch.sparse.csr import CSRMatrix
from repro_torch.sparse.csrk import CSRkTileBuckets, CSRkTiles
from repro_torch.sparse.diahybrid import DIAHybridMatrix, remainder_rows
from repro_torch.sparse.segsum import SegSumCSR, carry_spans, segment_starts
from repro_torch.sparse.sellcs import SELLCSMatrix, SELLCSTiles


def tensor_from_numpy(a) -> torch.Tensor:
    """A CPU tensor with ``a``'s dtype and bits (bfloat16 included)."""
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def csr_from_numpy(row_ptr, col_idx, vals, shape: Tuple[int, int]) -> CSRMatrix:
    return CSRMatrix(
        tensor_from_numpy(np.asarray(row_ptr, np.int32)),
        tensor_from_numpy(np.asarray(col_idx, np.int32)),
        tensor_from_numpy(vals),
        (int(shape[0]), int(shape[1])),
    )


def tiles_from_numpy(
    vals, local_col, local_row, win_block, rem_row, rem_col, rem_val, *,
    shape: Tuple[int, int], rows_per_tile: int, window: int,
    val_scale=None, tile_nnz=None, value_dtype: str = "f32",
) -> CSRkTiles:
    """A :class:`CSRkTiles` from its array leaves and static fields."""
    opt = lambda a: None if a is None else tensor_from_numpy(a)  # noqa: E731
    return CSRkTiles(
        tensor_from_numpy(vals),
        tensor_from_numpy(np.asarray(local_col, np.int32)),
        tensor_from_numpy(np.asarray(local_row, np.int32)),
        tensor_from_numpy(np.asarray(win_block, np.int32)),
        tensor_from_numpy(np.asarray(rem_row, np.int32)),
        tensor_from_numpy(np.asarray(rem_col, np.int32)),
        tensor_from_numpy(rem_val),
        (int(shape[0]), int(shape[1])),
        int(rows_per_tile),
        int(window),
        val_scale=opt(val_scale),
        tile_nnz=opt(None if tile_nnz is None else np.asarray(tile_nnz, np.int32)),
        value_dtype=value_dtype,
    )


def buckets_from_numpy(
    buckets: Sequence[Mapping], tile_ids: Sequence, rem_row, rem_col, rem_val, *,
    shape: Tuple[int, int], rows_per_tile: int, window: int, num_tiles: int,
    value_dtype: str = "f32",
) -> CSRkTileBuckets:
    """A :class:`CSRkTileBuckets`; each entry of ``buckets`` holds the keyword
    arguments of :func:`tiles_from_numpy` for one bucket."""
    return CSRkTileBuckets(
        tuple(tiles_from_numpy(**b) for b in buckets),
        tuple(tensor_from_numpy(np.asarray(i, np.int32)) for i in tile_ids),
        tensor_from_numpy(np.asarray(rem_row, np.int32)),
        tensor_from_numpy(np.asarray(rem_col, np.int32)),
        tensor_from_numpy(rem_val),
        (int(shape[0]), int(shape[1])),
        int(rows_per_tile),
        int(window),
        int(num_tiles),
        value_dtype=value_dtype,
    )


def sellcs_from_numpy(
    vals, col_idx, slot_row, chunk_ptr, row_perm, *,
    shape: Tuple[int, int], C: int, sigma: int, nnz_real: int,
) -> SELLCSMatrix:
    """A canonical :class:`SELLCSMatrix` from its flat slot arrays."""
    i32 = lambda a: tensor_from_numpy(np.asarray(a, np.int32))  # noqa: E731
    return SELLCSMatrix(
        tensor_from_numpy(vals), i32(col_idx), i32(slot_row), i32(chunk_ptr),
        i32(row_perm), (int(shape[0]), int(shape[1])),
        C=int(C), sigma=int(sigma), nnz_real=int(nnz_real),
    )


def sell_tiles_from_numpy(
    vals, col_idx, row_perm, chunk_width, *, shape: Tuple[int, int], C: int,
    val_scale=None, value_dtype: str = "f32",
) -> SELLCSTiles:
    """A :class:`SELLCSTiles` from its ``[T, C, W]`` arrays; ``chunk_width``
    is each chunk's real width (``SELLCSMatrix.chunk_widths()``)."""
    i32 = lambda a: tensor_from_numpy(np.asarray(a, np.int32))  # noqa: E731
    return SELLCSTiles(
        tensor_from_numpy(vals), i32(col_idx), i32(row_perm), i32(chunk_width),
        (int(shape[0]), int(shape[1])), int(C),
        val_scale=None if val_scale is None else tensor_from_numpy(val_scale),
        value_dtype=value_dtype,
    )


def segsum_from_numpy(
    vals, col_idx, local_seg, seg_row, *, shape: Tuple[int, int], nnz_real: int,
    val_scale=None, value_dtype: str = "f32",
) -> SegSumCSR:
    """A :class:`SegSumCSR` from its ``[T, S]`` slot and ``[T, R]`` segment
    arrays; the port's ``seg_start`` table and ``carry`` list are derived
    from them."""
    i32 = lambda a: tensor_from_numpy(np.asarray(a, np.int32))  # noqa: E731
    local_seg, seg_row = np.asarray(local_seg, np.int32), np.asarray(seg_row, np.int32)
    return SegSumCSR(
        tensor_from_numpy(vals), i32(col_idx), i32(local_seg), i32(seg_row),
        i32(segment_starts(local_seg, nnz_real)),
        i32(carry_spans(local_seg, seg_row, nnz_real)),
        (int(shape[0]), int(shape[1])), nnz_real=int(nnz_real),
        val_scale=None if val_scale is None else tensor_from_numpy(val_scale),
        value_dtype=value_dtype,
    )


def diahybrid_from_numpy(
    diag_vals, offsets, rem_row_ptr, rem_col_idx, rem_vals, *, shape: Tuple[int, int],
    diag_nnz: int, value_dtype: str = "f32",
) -> DIAHybridMatrix:
    """A :class:`DIAHybridMatrix` from its ``[n_diag, m]`` plane (f32, or
    bf16 bits), its ascending offsets and its CSR remainder arrays; the
    port's row list is derived from ``rem_row_ptr``."""
    offsets = tuple(int(o) for o in offsets)
    return DIAHybridMatrix(
        tensor_from_numpy(diag_vals), offsets,
        csr_from_numpy(rem_row_ptr, rem_col_idx, np.asarray(rem_vals, np.float32), shape),
        (int(shape[0]), int(shape[1])),
        tensor_from_numpy(np.asarray(offsets, np.int32).reshape(-1)),
        *(tensor_from_numpy(a) for a in remainder_rows(rem_row_ptr)),
        diag_nnz=int(diag_nnz), value_dtype=value_dtype,
    )


def ell_from_numpy(col_idx, vals, *, shape: Tuple[int, int]) -> ELLMatrix:
    """An :class:`ELLMatrix` from its ``[m, kmax]`` column and value slabs."""
    return ELLMatrix(
        tensor_from_numpy(np.asarray(col_idx, np.int32)), tensor_from_numpy(vals),
        (int(shape[0]), int(shape[1])),
    )


def bcsr_from_numpy(block_row_ptr, block_col_idx, blocks, *,
                    shape: Tuple[int, int]) -> BCSRMatrix:
    """A :class:`BCSRMatrix` from its block pointers, block columns and
    ``[nblocks, bR, bC]`` blocks; ``shape`` is the padded shape."""
    i32 = lambda a: tensor_from_numpy(np.asarray(a, np.int32))  # noqa: E731
    return BCSRMatrix(i32(block_row_ptr), i32(block_col_idx), tensor_from_numpy(blocks),
                      (int(shape[0]), int(shape[1])))


def csr5_from_numpy(
    vals, col_idx, row_flag, tile_ptr, nonempty_rows, *, shape: Tuple[int, int],
    sigma: int, omega: int, nnz_real: int,
) -> CSR5LikeMatrix:
    """A :class:`CSR5LikeMatrix` from its padded slot arrays, bit flags, tile
    pointer and non-empty row list."""
    i32 = lambda a: tensor_from_numpy(np.asarray(a, np.int32))  # noqa: E731
    return CSR5LikeMatrix(
        tensor_from_numpy(vals), i32(col_idx), tensor_from_numpy(np.asarray(row_flag, bool)),
        i32(tile_ptr), i32(nonempty_rows), (int(shape[0]), int(shape[1])),
        int(sigma), int(omega), int(nnz_real),
    )


def to_numpy(t: Optional[torch.Tensor]):
    """Inverse of :func:`tensor_from_numpy` for comparisons: bf16 tensors come
    back as their raw uint16 bit patterns."""
    if t is None:
        return None
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()
