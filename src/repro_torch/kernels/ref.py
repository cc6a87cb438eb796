"""Plain PyTorch versions of the kernels, and the CSR oracles.

Port of ``repro.kernels.ref``.  These are the correctness references the
CUDA kernels are held against (on the card by ``chip_smoke.py``, on the CPU by
the tests against the JAX oracles), the path a kernel wrapper takes for CPU
tensors, and the "plain CSR" baseline.  They repeat the kernel's arithmetic
(f32 dequantize, f32 products, f32 sums) but not its summation order:
``index_add_`` sums in an order of its own (on CUDA with atomics), so they
agree with the kernel within rounding, not bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.obs import annotated
from repro_torch.sparse import (
    BCSRMatrix,
    COOMatrix,
    CSR5LikeMatrix,
    CSRkMatrix,
    CSRkTileBuckets,
    CSRkTiles,
    CSRMatrix,
    DIAHybridMatrix,
    ELLMatrix,
    SegSumCSR,
    SELLCSMatrix,
    SELLCSTiles,
)


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


def spmv_dense(dense: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return dense @ x


def spmv_coo(mat: COOMatrix, x: torch.Tensor) -> torch.Tensor:
    """COO SpMV: scatter-add (the paper's 'needs atomics' baseline)."""
    contrib = mat.vals * x[mat.col_idx.long()]
    out = torch.zeros(mat.shape[0], dtype=contrib.dtype, device=contrib.device)
    return out.index_add_(0, mat.row_idx.long(), contrib)


def spmv_csrk_loops(mat: CSRkMatrix, x: torch.Tensor) -> torch.Tensor:
    """Direct transcription of the paper's Listing 1 (CSR-3 CPU kernel).

    Nested SSR→SR→row→nnz Python loops, each row summed in slot order in the
    values' dtype: slow by design, a structural oracle for the hierarchy at
    test sizes only.  Rows no super-row covers stay 0.
    """
    row_ptr, col_idx = (t.tolist() for t in (mat.row_ptr, mat.col_idx))
    sr_ptr, ssr_ptr = mat.sr_ptr.tolist(), mat.ssr_ptr.tolist()
    vals = mat.vals.cpu().numpy()
    xv = x.cpu().numpy().astype(vals.dtype)
    y = np.zeros(mat.m, vals.dtype)
    for i in range(mat.num_ssr):
        for j in range(ssr_ptr[i], ssr_ptr[i + 1]):
            for k in range(sr_ptr[j], sr_ptr[j + 1]):
                temp = vals.dtype.type(0)
                for l in range(row_ptr[k], row_ptr[k + 1]):  # noqa: E741
                    temp = temp + vals[l] * xv[col_idx[l]]
                y[k] = temp
    return torch.from_numpy(y).to(x.device)


def spmv_ell(mat: ELLMatrix, x: torch.Tensor) -> torch.Tensor:
    """ELL SpMV: dense gather + row sum (paper Sec. 2.3)."""
    return (mat.vals * x[mat.col_idx.long()]).sum(dim=1)


def ell_rows(col_idx: torch.Tensor, vals: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain version of the ELL kernel: ``y[i] = Σ_k vals[i,k]·x[col[i,k]]``.

    Every slot is multiplied, padding included (column 0, value 0), with f32
    products summed in f32 and y in x's dtype, as the reference's Pallas
    kernel: an inf or NaN at ``x[0]`` reaches every row that holds padding.
    """
    xf = x.to(torch.float32)
    y = (vals.to(torch.float32) * xf[col_idx.long()]).sum(dim=1)
    return y.to(x.dtype)


def spmv_bcsr(mat: BCSRMatrix, x: torch.Tensor) -> torch.Tensor:
    """BCSR SpMV: per-block dense matvec + segmented add.  ``x`` has the
    padded column count ``mat.shape[1]``."""
    bR, bC = mat.block_shape
    mb = int(mat.block_row_ptr.shape[0]) - 1
    lengths = (mat.block_row_ptr[1:] - mat.block_row_ptr[:-1]).long()
    brow = torch.repeat_interleave(
        torch.arange(mb, device=mat.blocks.device), lengths,
        output_size=int(mat.blocks.shape[0]),
    )
    xb = x.reshape(-1, bC)[mat.block_col_idx.long()]            # [nblocks, bC]
    contrib = torch.einsum("brc,bc->br", mat.blocks, xb)        # [nblocks, bR]
    yb = torch.zeros((mb, bR), dtype=contrib.dtype, device=contrib.device)
    yb.index_add_(0, brow, contrib)
    return yb.reshape(-1)[: mat.shape[0]]


def spmv_csr5_like(mat: CSR5LikeMatrix, x: torch.Tensor) -> torch.Tensor:
    """CSR5-like SpMV: rows rebuilt from the bit-flag prefix sum (the
    format's defining trick), then a segmented sum (padded slots carry value
    0 and are inert)."""
    compact = (torch.cumsum(mat.row_flag.to(torch.int64), 0) - 1).clamp(
        0, mat.nonempty_rows.shape[0] - 1)
    rows = mat.nonempty_rows.long()[compact]
    contrib = mat.vals * x[mat.col_idx.long()]
    out = torch.zeros(mat.shape[0], dtype=contrib.dtype, device=contrib.device)
    return out.index_add_(0, rows, contrib)


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


def sellcs_chunk_rows(
    vals: torch.Tensor,
    col_idx: torch.Tensor,
    row_perm: torch.Tensor,
    x: torch.Tensor,
    val_scale=None,
    *,
    m: int,
) -> torch.Tensor:
    """Plain version of the SELL-C-σ kernel: ``[m]`` (``[m, B]``) rows.

    Per sorted row ``i = t·C + c``: ``y[row_perm[i]] = Σ_w dq(vals[t,c,w]) ·
    x[col[t,c,w]]`` over all W lanes (padding lanes hold value 0).  Columns
    are clamped to ``n − 1`` as in the reference oracle; C-alignment pad rows
    land on the dump row m, which is dropped.
    """
    v = _tile_vals_f32(vals, val_scale).to(x.dtype)
    cols = col_idx.long().clamp(max=x.shape[0] - 1)
    if x.ndim == 2:
        y_sorted = (v[..., None] * x[cols]).sum(dim=2).reshape(-1, x.shape[1])
    else:
        y_sorted = (v * x[cols]).sum(dim=2).reshape(-1)
    out = torch.zeros((m + 1,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    out[row_perm.long()] = y_sorted
    return out[:m]


@annotated("repro_torch.oracle.spmv_sellcs_tiles", count_section="oracles")
def spmv_sellcs_tiles(tiles: SELLCSTiles, x: torch.Tensor) -> torch.Tensor:
    """Oracle for the uniform-width SELL-C-σ view (value-dtype aware)."""
    return sellcs_chunk_rows(tiles.vals, tiles.col_idx, tiles.row_perm, x,
                             tiles.val_scale, m=tiles.shape[0])


@annotated("repro_torch.oracle.spmv_sellcs", count_section="oracles")
def spmv_sellcs(mat: SELLCSMatrix, x: torch.Tensor) -> torch.Tensor:
    """SELL-C-σ SpMV oracle over the canonical flat slot arrays.

    Per slot: contrib = vals · x[col]; slots are segment-summed by their
    σ-sorted row id, then scattered back to the original row order via
    ``row_perm`` (padding rows land in the dump row m and are dropped).
    ``x`` may carry a trailing batch dimension ([n, B] → [m, B]).
    """
    m = mat.shape[0]
    tail = tuple(x.shape[1:])
    v = mat.vals.to(x.dtype)
    contrib = (v[:, None] if x.ndim == 2 else v) * x[mat.col_idx.long()]
    y_sorted = torch.zeros((mat.m_pad,) + tail, dtype=x.dtype, device=x.device)
    y_sorted.index_add_(0, mat.slot_row.long(), contrib)
    out = torch.zeros((m + 1,) + tail, dtype=x.dtype, device=x.device)
    out[mat.row_perm.long()] = y_sorted
    return out[:m]


def segsum_chunk_rows(
    vals: torch.Tensor,
    col_idx: torch.Tensor,
    local_seg: torch.Tensor,
    seg_row: torch.Tensor,
    x: torch.Tensor,
    val_scale=None,
    *,
    m: int,
) -> torch.Tensor:
    """Plain version of the segmented-sum kernel and its carry: ``[m]``
    (``[m, B]``) rows.

    Per chunk t: the speculative partials ``p[t·R + k] = Σ_s [lseg[t,s] = k]
    · dq(vals[t,s]) · x[col[t,s]]`` over all S slots (the tail chunk's
    padding slots included, value 0); then the carry scatter-adds every
    partial to row ``seg_row[t, k]``, summing the fragments of rows that span
    chunks.  Unused and padding segments land on the dump row m, which is
    dropped; rows no segment covers stay 0.
    """
    T, S = vals.shape
    R = seg_row.shape[1]
    tail = tuple(x.shape[1:])
    v = _tile_vals_f32(vals, val_scale).to(x.dtype)
    cols = col_idx.long().clamp(max=x.shape[0] - 1)
    contrib = (v[..., None] if x.ndim == 2 else v) * x[cols]          # [T, S(, B)]
    seg = (local_seg.long() + torch.arange(T, device=vals.device)[:, None] * R).reshape(-1)
    partial = torch.zeros((T * R,) + tail, dtype=x.dtype, device=x.device)
    partial.index_add_(0, seg, contrib.reshape((T * S,) + tail))
    out = torch.zeros((m + 1,) + tail, dtype=x.dtype, device=x.device)
    return out.index_add_(0, seg_row.long().reshape(-1), partial)[:m]


@annotated("repro_torch.oracle.spmv_segsum", count_section="oracles")
def spmv_segsum(mat: SegSumCSR, x: torch.Tensor) -> torch.Tensor:
    """Speculative segmented-sum oracle (value-dtype aware).

    Per chunk t the slot contributions are segment-summed by local segment
    id into ``[T, R]`` speculative partials — what the reference's Pallas
    kernel emits — then the carry/patch pass scatter-adds every partial to
    its segment's global row, summing the fragments of rows that span chunks
    (padding segments land in the dump row m and are dropped).  ``x`` may
    carry a trailing batch dimension ([n, B] → [m, B]).
    """
    return segsum_chunk_rows(mat.vals, mat.col_idx, mat.local_seg, mat.seg_row, x,
                             mat.val_scale, m=mat.m)


def dia_plane_rows(
    diag_vals: torch.Tensor,
    offsets: torch.Tensor,
    x: torch.Tensor,
    *,
    m: int,
    n: int,
) -> torch.Tensor:
    """The DIA plane's part of y: ``[m]`` (``[m, B]``) rows.

    ``y[i] = Σ_k plane[k, i] · x[i + offsets[k]]`` with f32 products summed
    over the diagonal axis, as the reference's ``_dia_plane``.  Where
    ``i + offsets[k]`` falls outside ``[0, n)`` the product reads 0, which
    is the reference's zero ``lead`` margin; every in-range slot is
    multiplied, a 0 value included, so an inf or NaN in x reaches the rows
    it reaches there.  ``offsets`` is an int tensor on x's device (no host
    round trip, so the function can be captured in a CUDA graph).
    """
    tail = tuple(x.shape[1:])
    if diag_vals.shape[0] == 0:
        return torch.zeros((m,) + tail, dtype=x.dtype, device=x.device)
    col = torch.arange(m, device=x.device)[None, :] + offsets.long()[:, None]  # [n_diag, m]
    inside = (col >= 0) & (col < n)
    xf = x.to(torch.float32)
    xs = xf[col.clamp(0, max(n - 1, 0))]
    xs = torch.where(inside[..., None] if x.ndim == 2 else inside, xs, xs.new_zeros(()))
    vals = diag_vals.to(torch.float32)
    contrib = (vals[..., None] if x.ndim == 2 else vals) * xs
    return contrib.sum(dim=0).to(x.dtype)


def diahybrid_rows(
    diag_vals: torch.Tensor,
    offsets: torch.Tensor,
    rem_row_ptr: torch.Tensor,
    rem_col_idx: torch.Tensor,
    rem_vals: torch.Tensor,
    x: torch.Tensor,
    *,
    m: int,
    n: int,
) -> torch.Tensor:
    """Plain version of the DIA-hybrid kernel: ``[m]`` (``[m, B]``) rows.

    The plane part (:func:`dia_plane_rows`), then, when the remainder holds
    any entry, the remainder's CSR product added to it: the reference's
    two-part sum, ``ops.spmv_diahybrid`` in ``repro.kernels``.
    """
    y = dia_plane_rows(diag_vals, offsets, x, m=m, n=n)
    if rem_vals.numel():
        rem = CSRMatrix(rem_row_ptr, rem_col_idx, rem_vals, (m, n))
        y = y + (spmm_csr(rem, x) if x.ndim == 2 else spmv_csr(rem, x)).to(y.dtype)
    return y


def _dia_plane(mat: DIAHybridMatrix, x: torch.Tensor) -> torch.Tensor:
    """DIA-plane partial y of a container (see :func:`dia_plane_rows`)."""
    return dia_plane_rows(mat.diag_vals, mat.offset_vec, x, m=mat.m, n=mat.n)


@annotated("repro_torch.oracle.spmv_diahybrid", count_section="oracles")
def spmv_diahybrid(mat: DIAHybridMatrix, x: torch.Tensor) -> torch.Tensor:
    """Partially-diagonal hybrid oracle: the shifted DIA contraction plus the
    CSR remainder through the CSR oracle, in that order.  ``x`` may carry a
    trailing batch dimension ([n, B] → [m, B])."""
    r = mat.remainder
    return diahybrid_rows(mat.diag_vals, mat.offset_vec, r.row_ptr, r.col_idx, r.vals, x,
                          m=mat.m, n=mat.n)
