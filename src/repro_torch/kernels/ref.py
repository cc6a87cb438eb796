"""Plain PyTorch versions of the kernels, and the CSR oracles.

Port of ``repro.kernels.ref``.  These are the correctness references the
CUDA kernel is held against (on the card by ``chip_smoke.py``, on the CPU by
the tests against the JAX oracles), the path a kernel wrapper takes for CPU
tensors, and the "plain CSR" baseline.  They repeat the kernel's arithmetic
(f32 dequantize, f32 products, f32 sums) but not its summation order:
``index_add_`` sums in an order of its own (on CUDA with atomics), so they
agree with the kernel within rounding, not bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.obs import annotated
from repro_torch.sparse import CSRkTileBuckets, CSRkTiles, CSRMatrix


def _tile_vals_f32(vals: torch.Tensor, val_scale) -> torch.Tensor:
    """Tile values as f32: upcast bf16/f32, dequantize int8 grouped scales.

    Scale groups run along the last (slot) axis, one f32 scale per
    ``vals.shape[-1] // val_scale.shape[-1]`` slots.
    """
    v = vals.to(torch.float32)
    if val_scale is not None:
        g = v.shape[-1] // val_scale.shape[-1]
        v = v * torch.repeat_interleave(val_scale, g, dim=-1)
    return v


def _csr_rows(mat: CSRMatrix) -> torch.Tensor:
    return torch.repeat_interleave(
        torch.arange(mat.m, device=mat.vals.device), mat.row_lengths().long(),
        output_size=mat.nnz,
    )


@annotated("repro_torch.oracle.spmv_csr", count_section="oracles")
def spmv_csr(mat: CSRMatrix, x: torch.Tensor) -> torch.Tensor:
    """Row-segmented CSR SpMV — the canonical oracle."""
    contrib = mat.vals * x[mat.col_idx.long()]
    out = torch.zeros(mat.m, dtype=contrib.dtype, device=contrib.device)
    return out.index_add_(0, _csr_rows(mat), contrib)


@annotated("repro_torch.oracle.spmm_csr", count_section="oracles")
def spmm_csr(mat: CSRMatrix, X: torch.Tensor) -> torch.Tensor:
    """SpMM oracle (multi-vector SpMV), used by the CG block solver."""
    contrib = mat.vals[:, None] * X[mat.col_idx.long()]
    out = torch.zeros((mat.m, X.shape[1]), dtype=contrib.dtype, device=contrib.device)
    return out.index_add_(0, _csr_rows(mat), contrib)


def csrk_tile_rows(
    vals: torch.Tensor,
    local_col: torch.Tensor,
    local_row: torch.Tensor,
    win_block: torch.Tensor,
    x: torch.Tensor,
    val_scale=None,
    *,
    rows_per_tile: int,
    window: int,
) -> torch.Tensor:
    """Plain version of the CSR-k tile kernel: ``[T·R]`` (``[T·R, B]``) rows.

    Per tile t: ``y[t·R + r] = Σ_s [lr[t,s] = r] · dq(vals[t,s]) ·
    x[win_block[t]·W + lc[t,s]]``.  Columns are clamped to ``n − 1`` as in
    the reference oracle; only padding slots (value 0) can reach past x.
    """
    T, _ = vals.shape
    R = rows_per_tile
    v = _tile_vals_f32(vals, val_scale).to(x.dtype)
    col = win_block.long()[:, None] * window + local_col.long()
    col = col.clamp(max=x.shape[0] - 1)
    seg = (local_row.long() + torch.arange(T, device=vals.device)[:, None] * R).reshape(-1)
    if x.ndim == 2:
        contrib = (v[..., None] * x[col]).reshape(-1, x.shape[1])
        out = torch.zeros((T * R, x.shape[1]), dtype=x.dtype, device=x.device)
    else:
        contrib = (v * x[col]).reshape(-1)
        out = torch.zeros(T * R, dtype=x.dtype, device=x.device)
    return out.index_add_(0, seg, contrib)


def _add_remainder(y, rem_row, rem_col, rem_val, x):
    if rem_val.numel() == 0:
        return y
    rv = rem_val.to(y.dtype)
    if x.ndim == 2:
        rv = rv[:, None]
    return y.index_add_(0, rem_row.long(), rv * x[rem_col.long()])


@annotated("repro_torch.oracle.spmv_csrk_tiles", count_section="oracles")
def spmv_csrk_tiles(tiles: CSRkTiles, x: torch.Tensor) -> torch.Tensor:
    """Oracle for the padded-tile view: the tile rows plus the COO remainder.

    ``x`` may carry a trailing batch dimension ([n, B] → [m, B]).
    """
    y = csrk_tile_rows(
        tiles.vals, tiles.local_col, tiles.local_row, tiles.win_block, x,
        tiles.val_scale, rows_per_tile=tiles.rows_per_tile, window=tiles.window,
    )[: tiles.shape[0]]
    return _add_remainder(y, tiles.rem_row, tiles.rem_col, tiles.rem_val, x)


@annotated("repro_torch.oracle.spmv_csrk_buckets", count_section="oracles")
def spmv_csrk_buckets(buckets: CSRkTileBuckets, x: torch.Tensor) -> torch.Tensor:
    """Oracle for the slot-bucketed tile view: per-bucket tile rows placed at
    their global tiles, COO remainder folded once."""
    R = buckets.rows_per_tile
    tail = tuple(x.shape[1:])
    y_tiles = torch.zeros((buckets.num_tiles, R) + tail, dtype=x.dtype, device=x.device)
    for b, ids in zip(buckets.buckets, buckets.tile_ids):
        y_b = csrk_tile_rows(
            b.vals, b.local_col, b.local_row, b.win_block, x, b.val_scale,
            rows_per_tile=R, window=buckets.window,
        )
        y_tiles[ids.long()] = y_b.reshape((b.num_tiles, R) + tail)
    y = y_tiles.reshape((buckets.num_tiles * R,) + tail)[: buckets.shape[0]]
    return _add_remainder(y, buckets.rem_row, buckets.rem_col, buckets.rem_val, x)
