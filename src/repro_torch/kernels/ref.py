"""Plain PyTorch versions of the kernels, and the CSR oracles.

Port of ``repro.kernels.ref``.  These are the correctness references the
CUDA kernels are held against (on the card by ``chip_smoke.py``, on the CPU by
the tests against the JAX oracles), the path a kernel wrapper takes for CPU
tensors, and the "plain CSR" baseline.  They repeat the kernel's arithmetic
(f32 dequantize, f32 products, f32 sums) but not its summation order:
``index_add_`` sums in an order of its own (on CUDA with atomics), so they
agree with the kernel within rounding, not bit for bit.  The one exception,
:func:`csrk_tile_rows_in_order`, keeps the CSR-k kernel's order too.  They
compute in x's dtype: for a bf16 x most multiply and sum in bf16 (the
kernels sum in f32 and round once), and for a float64 x they give the
float64 product of the same dequantised values.
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
    A float64 x is multiplied and summed in float64 (the exact-as-can-be
    product the card's checks hold the kernel to).
    """
    work = _work_dtype(x)
    xf = x.to(work)
    y = (vals.to(work) * xf[col_idx.long()]).sum(dim=1)
    return y.to(x.dtype)


def _work_dtype(x: torch.Tensor) -> torch.dtype:
    """f32, the kernels' accumulation type, or f64 for a float64 x."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


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


def csrk_tile_rows_in_order(
    vals: torch.Tensor,
    local_col: torch.Tensor,
    local_row: torch.Tensor,
    win_block: torch.Tensor,
    x: torch.Tensor,
    val_scale=None,
    *,
    rows_per_tile: int,
    window: int,
    tile_nnz=None,
) -> torch.Tensor:
    """The CSR-k kernel's own summation order: ``[T·R]`` (``[T·R, B]``) rows.

    The same function as :func:`csrk_tile_rows`, computed as the CUDA kernel
    computes it: per tile and row, the f32 products ``dq(vals[t,s]) ·
    x[win_block[t]·W + lc[t,s]]`` of the slots ``s < tile_nnz[t]`` (all S
    without ``tile_nnz``) with ``lr[t,s] = r``, added from +0 in slot order.
    Every product and every sum is its own rounded f32 operation, so nothing
    fuses and the kernel's output is matched bit for bit.  As in the kernel,
    x reads outside ``[0, n)`` see 0 and rows outside ``[0, R)`` are dropped.
    The rows are f32 for an f32 x; for a bf16 x (read as f32) each row's f32
    sum is rounded to bf16 once, as the kernel stores it.
    """
    T, S = vals.shape
    R = rows_per_tile
    n = x.shape[0]
    tail = tuple(x.shape[1:])
    xf = x.to(torch.float32).reshape(n, -1)
    v = _tile_vals_f32(vals, val_scale)
    nslots = (torch.full((T,), S, device=vals.device) if tile_nnz is None
              else tile_nnz.long().clamp(0, S))
    lr = local_row.long()
    keep = ((torch.arange(S, device=vals.device)[None, :] < nslots[:, None])
            & (lr >= 0) & (lr < R))
    t_idx, s_idx = keep.nonzero(as_tuple=True)           # tile-major, slot order inside
    col = win_block.long()[t_idx] * window + local_col.long()[t_idx, s_idx]
    inside = (col >= 0) & (col < n)
    xg = torch.where(inside[:, None], xf[col.clamp(0, max(n - 1, 0))], 0.0)
    prod = v[t_idx, s_idx][:, None] * xg                   # [slots, B], rounded f32
    key, order = torch.sort(t_idx * R + lr[t_idx, s_idx], stable=True)
    prod = prod[order]
    counts = torch.bincount(key, minlength=T * R)
    pos = torch.arange(key.numel(), device=key.device) - (torch.cumsum(counts, 0) - counts)[key]
    out = torch.zeros((T * R, xf.shape[1]), dtype=torch.float32, device=x.device)
    for k in range(int(counts.max()) if key.numel() else 0):
        at = pos == k
        rows = key[at]
        out[rows] = out[rows] + prod[at]
    out = out.reshape((T * R,) + tail)
    return out if x.dtype == torch.float32 else out.to(x.dtype)


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
    out=None,
) -> torch.Tensor:
    """Plain version of the SELL-C-σ kernel: ``[m]`` (``[m, B]``) rows.

    Per sorted row ``i = t·C + c``: ``y[row_perm[i]] = Σ_w dq(vals[t,c,w]) ·
    x[col[t,c,w]]`` over all W lanes (padding lanes hold value 0).  Columns
    are clamped to ``n − 1`` as in the reference oracle; C-alignment pad rows
    land on the dump row m, which is dropped.  With ``out`` (``[m(, B)]`` in
    x's dtype) the rows are written there, every other row of ``out`` kept,
    and ``out`` is returned, as the kernel's wrapper does.
    """
    v = _tile_vals_f32(vals, val_scale).to(x.dtype)
    cols = col_idx.long().clamp(max=x.shape[0] - 1)
    if x.ndim == 2:
        y_sorted = (v[..., None] * x[cols]).sum(dim=2).reshape(-1, x.shape[1])
    else:
        y_sorted = (v * x[cols]).sum(dim=2).reshape(-1)
    if out is not None:
        real = row_perm < m
        out[row_perm[real].long()] = y_sorted[real]
        return out
    y = torch.zeros((m + 1,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    y[row_perm.long()] = y_sorted
    return y[:m]


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


def segsum_table_rows(
    vals: torch.Tensor,
    col_idx: torch.Tensor,
    seg_row: torch.Tensor,
    seg_start: torch.Tensor,
    x: torch.Tensor,
    val_scale=None,
    *,
    m: int,
    nnz: int,
) -> torch.Tensor:
    """Plain version of the segmented-sum kernel as the card runs it:
    ``[m]`` (``[m, B]``) rows, the chunks' segments read from the
    ``seg_start`` table (``SegSumCSR.seg_start``) and not from ``local_seg``.

    Chunk t's real slots ``[0, n_t)``, ``n_t = min(S, nnz − t·S)``, are cut
    at its listed starts; segment k runs from its start to the next (the
    last to ``n_t``) and adds to row ``seg_row[t, k]``.  Slots past ``n_t``
    are not read.  Per-segment partials are summed by ``index_add_``, then
    scattered to their rows as in :func:`segsum_chunk_rows`, which sums the
    fragments of rows that span chunks.
    """
    T, S = vals.shape
    R = seg_row.shape[1]
    dev = vals.device
    tail = tuple(x.shape[1:])
    table = seg_start.long()
    ptr = table[: T + 1]
    chunk = torch.repeat_interleave(torch.arange(T, device=dev), ptr[1:] - ptr[:-1])
    starts = torch.zeros((T, S), dtype=torch.long, device=dev)
    starts[chunk, table[int(ptr[0]):int(ptr[-1])]] = 1
    seg = starts.cumsum(1) - 1                         # local segment of each slot
    n_t = (nnz - torch.arange(T, device=dev) * S).clamp(0, S)
    real = torch.arange(S, device=dev)[None, :] < n_t[:, None]
    key = torch.where(real, seg + torch.arange(T, device=dev)[:, None] * R, T * R)
    v = _tile_vals_f32(vals, val_scale).to(x.dtype)
    cols = torch.where(real, col_idx.long(), 0).clamp(max=x.shape[0] - 1)
    contrib = (v[..., None] if x.ndim == 2 else v) * x[cols]          # [T, S(, B)]
    partial = torch.zeros((T * R + 1,) + tail, dtype=x.dtype, device=x.device)
    partial.index_add_(0, key.reshape(-1), contrib.reshape((T * S,) + tail))
    out = torch.zeros((m + 1,) + tail, dtype=x.dtype, device=x.device)
    return out.index_add_(0, seg_row.long().reshape(-1), partial[: T * R])[:m]


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
    round trip, so the function can be captured in a CUDA graph).  A float64
    x is multiplied and summed in float64.
    """
    tail = tuple(x.shape[1:])
    if diag_vals.shape[0] == 0:
        return torch.zeros((m,) + tail, dtype=x.dtype, device=x.device)
    col = torch.arange(m, device=x.device)[None, :] + offsets.long()[:, None]  # [n_diag, m]
    inside = (col >= 0) & (col < n)
    work = _work_dtype(x)
    xf = x.to(work)
    xs = xf[col.clamp(0, max(n - 1, 0))]
    xs = torch.where(inside[..., None] if x.ndim == 2 else inside, xs, xs.new_zeros(()))
    vals = diag_vals.to(work)
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


def diahybrid_list_rows(
    diag_vals: torch.Tensor,
    offsets: torch.Tensor,
    rem_rows: torch.Tensor,
    rem_start: torch.Tensor,
    rem_mask: torch.Tensor,
    rem_col_idx: torch.Tensor,
    rem_vals: torch.Tensor,
    x: torch.Tensor,
    *,
    m: int,
    n: int,
) -> torch.Tensor:
    """Plain version of the DIA-hybrid kernel as the card runs it: ``[m]``
    (``[m, B]``) rows, the remainder found through the port's row list
    (``DIAHybridMatrix.rem_rows``/``rem_start``/``rem_mask``) and not
    through its row pointer.

    Rows whose ``rem_mask`` bit is clear take the plane part alone
    (:func:`dia_plane_rows`); listed row ``rem_rows[j]`` takes its plane
    part plus its entries ``[rem_start[j], rem_start[j + 1])``, summed by
    ``index_add_``.  A row whose bit is set but which is not listed is NaN:
    the kernel would leave it unwritten.
    """
    plane = dia_plane_rows(diag_vals, offsets, x, m=m, n=n)
    bits = (rem_mask.long()[:, None] >> torch.arange(32, device=x.device)) & 1
    y = plane.masked_fill(bits.reshape(-1)[:m].bool().reshape((m,) + (1,) * (x.ndim - 1)),
                          float("nan"))
    rows = rem_rows.long()
    if rows.numel():
        start = rem_start.long()
        seg = torch.repeat_interleave(torch.arange(rows.numel(), device=x.device),
                                      start[1:] - start[:-1])
        e0, e1 = int(start[0]), int(start[-1])
        v = rem_vals[e0:e1].to(x.dtype)
        contrib = (v[:, None] if x.ndim == 2 else v) * x[rem_col_idx[e0:e1].long()]
        rem = torch.zeros((rows.numel(),) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
        rem.index_add_(0, seg, contrib)
        y[rows] = plane[rows] + rem
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
