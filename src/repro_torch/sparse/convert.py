"""Build the port's containers from plain numpy arrays.

Any producer of CSR / CSR-k tile arrays (a file, another framework) can hand
its arrays to the port through these functions; the tests use them to push
identical tiles through both packages' kernels and oracles.  Results live on
the CPU; move them with ``.to(device)``.  bf16 values may arrive as an
``ml_dtypes`` bfloat16 array (what ``np.asarray`` gives for a JAX bf16
array) and are reinterpreted bit for bit.
"""
from __future__ import annotations

from typing import Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.sparse.csr import CSRMatrix
from repro_torch.sparse.csrk import CSRkTileBuckets, CSRkTiles


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


def to_numpy(t: Optional[torch.Tensor]):
    """Inverse of :func:`tensor_from_numpy` for comparisons: bf16 tensors come
    back as their raw uint16 bit patterns."""
    if t is None:
        return None
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()
