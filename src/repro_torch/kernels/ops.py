"""Public wrappers around the CSR-k kernel.

Port of the CSR-k half of ``repro.kernels.ops``: ``spmv_csrk`` (monolithic
tile view) and ``spmv_csrk_bucketed`` (one launch per slot bucket) run the
kernel and fold in the COO remainder.  ``_pad_x_to_blocks`` and
``combine_tile_rows`` keep the reference's helpers: the CUDA kernel bounds
its x reads and scatters bucket rows itself, so the CUDA path needs neither.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.spmv_csrk import spmv_csrk_tiles
from repro_torch.obs import annotated
from repro_torch.sparse import CSRkTileBuckets, CSRkTiles


def _pad_rows(x: torch.Tensor, target: int) -> torch.Tensor:
    """Zero-pad x along axis 0 to ``target`` rows ([n] and [n, B] alike)."""
    out = x.new_zeros((target,) + tuple(x.shape[1:]))
    out[: x.shape[0]] = x
    return out


def _pad_x_to_blocks(x: torch.Tensor, window: int) -> torch.Tensor:
    """Pad x so every (win_block, win_block+1) pair addresses valid blocks."""
    nblocks = -(-x.shape[0] // window)
    return _pad_rows(x, (nblocks + 1) * window)


def combine_tile_rows(parts, tile_ids, num_tiles: int, rows_per_tile: int,
                      dtype=None) -> torch.Tensor:
    """Scatter partial-tile-set kernel outputs back into contiguous rows.

    Each part is ``[T_sub · R (, B)]`` rows in subset order; ``tile_ids`` give
    each subset tile's home tile.  Tile row ranges are disjoint, so the result
    is the launch over the union of the subsets.  Ids equal to ``num_tiles``
    are a dump slot and are dropped; uncovered tiles are zero.
    """
    first = parts[0]
    tail = tuple(first.shape[1:])
    out = torch.zeros((num_tiles + 1, rows_per_tile) + tail,
                      dtype=dtype or first.dtype, device=first.device)
    for y, ids in zip(parts, tile_ids):
        out[ids.long()] = y.reshape((ids.shape[0], rows_per_tile) + tail).to(out.dtype)
    return out[:num_tiles].reshape((num_tiles * rows_per_tile,) + tail)


def _fold_remainder(y, rem_row, rem_col, rem_val, x):
    """y[rem_row] += rem_val · x[rem_col], in the same order on every call.

    ``index_add_`` on CUDA adds duplicate rows with atomics in an order that
    changes from run to run, so the entries are grouped by row (stable sort)
    and each row's entries are summed in entry order before one add per row.
    """
    if rem_val.numel() == 0:
        return y
    c = rem_val.to(y.dtype)
    if x.ndim == 2:
        c = c[:, None]
    c = c * x[rem_col.long()]
    rows, order = torch.sort(rem_row.long(), stable=True)
    c = c[order]
    uniq, counts = torch.unique_consecutive(rows, return_counts=True)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(rows.numel(), device=rows.device) - torch.repeat_interleave(starts, counts)
    group = torch.repeat_interleave(torch.arange(uniq.numel(), device=rows.device), counts)
    table = c.new_zeros((uniq.numel(), int(counts.max())) + tuple(c.shape[1:]))
    table[group, pos] = c
    y[uniq] = y[uniq] + table.sum(dim=1)
    return y


@annotated("repro_torch.spmv_csrk", count_section="kernels")
def spmv_csrk(tiles: CSRkTiles, x: torch.Tensor) -> torch.Tensor:
    """CSR-k SpMV over the monolithic tile view (+ COO remainder pass).

    ``x`` may be a vector ([n]) or a multi-vector block ([n, B]); the batched
    form streams the matrix tiles once for all B right-hand sides.
    """
    y = spmv_csrk_tiles(
        tiles.vals, tiles.local_col, tiles.local_row, tiles.win_block,
        x.contiguous(), tiles.val_scale,
        rows_per_tile=tiles.rows_per_tile, window=tiles.window,
        tile_nnz=tiles.tile_nnz,
    )[: tiles.shape[0]]
    return _fold_remainder(y, tiles.rem_row, tiles.rem_col, tiles.rem_val, x)


@annotated("repro_torch.spmv_csrk_bucketed", count_section="kernels")
def spmv_csrk_bucketed(buckets: CSRkTileBuckets, x: torch.Tensor) -> torch.Tensor:
    """Slot-bucketed CSR-k SpMV: one kernel launch per slot bucket.

    Each launch writes its tiles' rows at their global tile positions, so
    every row of the output is written by exactly one launch; the COO
    remainder is folded once.  ``x`` may be [n] or [n, B].
    """
    R = buckets.rows_per_tile
    xc = x.contiguous()
    y = torch.empty((buckets.num_tiles * R,) + tuple(x.shape[1:]),
                    dtype=x.dtype, device=x.device)
    for b, ids in zip(buckets.buckets, buckets.tile_ids):
        spmv_csrk_tiles(
            b.vals, b.local_col, b.local_row, b.win_block, xc, b.val_scale,
            rows_per_tile=R, window=buckets.window, tile_nnz=b.tile_nnz,
            tile_ids=ids, out=y,
        )
    y = y[: buckets.shape[0]]
    return _fold_remainder(y, buckets.rem_row, buckets.rem_col, buckets.rem_val, x)
