"""Public wrappers around the CSR-k, SELL-C-σ, segmented-sum, DIA-hybrid and
ELL kernels.

Port of ``repro.kernels.ops``:
``spmv_csrk`` (monolithic tile view) and ``spmv_csrk_bucketed`` (one launch
per slot bucket) run the CSR-k kernel and fold in the COO remainder;
``spmv_sellcs`` runs the SELL-C-σ kernel, which writes rows in the original
order itself; ``spmv_segsum`` runs the segmented-sum kernel, whose carry
pass sums the fragments of rows that span chunks; ``spmv_diahybrid`` runs the
DIA-hybrid kernel, which adds the CSR remainder itself; ``spmv_ell`` runs
the ELL baseline's kernel.  The ``*_ref`` names re-export the oracles, so a
caller can flip kernel and oracle at one import site.
``_pad_x_to_blocks`` and ``combine_tile_rows`` keep the reference's helpers:
the CUDA kernel bounds its x reads and scatters bucket rows itself, so the
CUDA path needs neither.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.spmv_csrk import spmv_csrk_tiles
from repro_torch.kernels.spmv_diahybrid import spmv_diahybrid_rows
from repro_torch.kernels.spmv_ell import spmv_ell_rows
from repro_torch.kernels.spmv_segsum import spmv_segsum_chunks
from repro_torch.kernels.spmv_sellcs import spmv_sellcs_chunks
from repro_torch.obs import annotated
from repro_torch.sparse import (
    CSRkTileBuckets,
    CSRkTiles,
    DIAHybridMatrix,
    ELLMatrix,
    SegSumCSR,
    SELLCSTiles,
)


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


@annotated("repro_torch.spmv_sellcs", count_section="kernels")
def spmv_sellcs(tiles: SELLCSTiles, x: torch.Tensor) -> torch.Tensor:
    """SELL-C-σ SpMV: ``[n]`` → ``[m]`` (``[n, B]`` → ``[m, B]``) in the
    original row order, one kernel launch per call.

    The reference pads x to a 128 multiple and scatters the σ-sorted kernel
    rows back by ``row_perm``; the CUDA kernel reads only in-range x rows and
    writes each row to ``y[row_perm[i]]`` itself, so neither step remains.
    """
    return spmv_sellcs_chunks(
        tiles.vals, tiles.col_idx, tiles.row_perm, tiles.chunk_width,
        x.contiguous(), tiles.val_scale, m=tiles.shape[0],
    )


@annotated("repro_torch.spmv_segsum", count_section="kernels")
def spmv_segsum(mat: SegSumCSR, x: torch.Tensor) -> torch.Tensor:
    """Speculative segmented-sum SpMV: ``[n]`` → ``[m]`` (``[n, B]`` →
    ``[m, B]``) in row order, one wrapper call per SpMV.

    The reference pads x to a 128 multiple, has the kernel emit ``[T · R]``
    speculative partials and scatter-adds them through ``seg_row``.  The
    CUDA kernel reads only in-range x rows and real slots, finds segments in
    the port's ``seg_start`` table instead of ``local_seg``, writes whole
    rows to y, and sums the fragments of rows that span chunks in a fixed
    order in its carry pass, so neither the padding nor the scatter remains.
    """
    return spmv_segsum_chunks(
        mat.vals, mat.col_idx, mat.seg_row, mat.seg_start, mat.carry, x.contiguous(),
        mat.val_scale, m=mat.m, nnz=mat.nnz_real,
    )


@annotated("repro_torch.spmv_diahybrid", count_section="kernels")
def spmv_diahybrid(mat: DIAHybridMatrix, x: torch.Tensor) -> torch.Tensor:
    """Partially-diagonal hybrid SpMV: ``[n]`` → ``[m]`` (``[n, B]`` →
    ``[m, B]``), one kernel launch per call.

    The reference extends x by a ``lead`` zero margin for its Pallas plane
    kernel and adds the CSR remainder through its oracle afterwards.  The
    CUDA kernel bounds its x reads, streams the plane rows that hold no
    remainder, and gives each row that does (found through the port's row
    list, ``rem_rows``/``rem_start``/``rem_mask``) to a group of lanes that
    sums its plane part and its remainder, so neither the padded copy nor the
    second pass remains.
    """
    r = mat.remainder
    return spmv_diahybrid_rows(mat.diag_vals, mat.offset_vec, mat.rem_rows, mat.rem_start,
                               mat.rem_mask, r.col_idx, r.vals, x.contiguous(), m=mat.m, n=mat.n)


@annotated("repro_torch.spmv_ell", count_section="kernels")
def spmv_ell(mat: ELLMatrix, x: torch.Tensor) -> torch.Tensor:
    """ELL SpMV: ``[n]`` → ``[m]``, one kernel launch per call; ``[n, B]``
    raises, as the reference has no batched ELL body.

    The reference pads the slab's rows to a multiple of its Pallas
    ``row_tile`` and slices y back; the CUDA kernel masks the last rows
    itself, so no padded copy remains (and neither do the TPU knobs
    ``row_tile`` and ``interpret``).
    """
    return spmv_ell_rows(mat.col_idx, mat.vals, x.contiguous(), m=mat.shape[0],
                         n=mat.shape[1])


# re-export oracles so callers can flip kernel↔oracle with one import site
spmv_csrk_ref = ref.spmv_csrk_tiles
spmv_ell_ref = ref.spmv_ell
spmv_sellcs_ref = ref.spmv_sellcs
spmv_segsum_ref = ref.spmv_segsum
spmv_diahybrid_ref = ref.spmv_diahybrid
spmm_csr_ref = ref.spmm_csr
