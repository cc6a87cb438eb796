"""One-pass matrix statistics feeding the O(1) format selector.

Port of ``repro.sparse.stats`` (``MatrixStats``, ``compute_stats``, the
routing thresholds, and the distributed layer's ``compute_shard_stats`` and
``classify_tile_reach``).  The paper's constant-time tuner keys on mean row
density alone (Sec. 4); its evaluation restricts CSR-k's wins to *regular*
matrices (nnz-per-row variance ≤ 10, Sec. 6).  :func:`compute_stats` also
produces the row-length variance, the bandwidth, the dense-diagonal fraction
and the row skew, so the registry routes without ever running an SpMV.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.sparse._tree import host
from repro_torch.sparse.csr import CSRMatrix


@dataclasses.dataclass(frozen=True)
class MatrixStats:
    """Summary statistics of a CSR matrix (one O(nnz) pass, host-side)."""

    m: int              # rows
    n: int              # cols
    nnz: int
    rdensity: float     # mean nnz per row — the paper's tuner input
    row_var: float      # variance of nnz per row — the regularity signal
    row_max: int        # densest row
    bandwidth: int      # max |i - j| over nnz (post-Band-k if A was reordered)
    diag_fraction: float = 0.0  # nnz fraction on ≥DIAG_OCCUPANCY-occupied diagonals
    row_skew: float = 1.0       # row_max / mean row length (power-law signal)

    @property
    def is_regular(self) -> bool:
        """The paper's Sec. 6 regularity criterion (variance ≤ 10)."""
        return self.row_var <= REGULAR_ROW_VAR_MAX

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


#: Paper Sec. 6: CSR-k's wins are reported for matrices with nnz-per-row
#: variance at or below this; above it the matrix counts as irregular.
REGULAR_ROW_VAR_MAX = 10.0

#: A diagonal counts as *dense* when it fills at least this fraction of the
#: ``m`` slots a DIA plane row costs.
DIAG_OCCUPANCY = 0.9

#: Routing floor for the DIA/CSR hybrid (Fukaya et al., arXiv:2105.04937).
DIA_FRACTION_MIN = 0.9

#: Routing floor for the speculative segmented-sum path (Liu & Vinter,
#: arXiv:1504.06474): row_max must exceed the mean row length by this factor.
SEGSUM_ROW_SKEW_MIN = 16.0


def compute_stats(A: CSRMatrix) -> MatrixStats:
    """Compute :class:`MatrixStats` in a single pass over the CSR arrays.

    Bandwidth is measured on the matrix as given — run this *after* Band-k /
    RCM if the post-reordering bandwidth is wanted.
    """
    rp = host(A.row_ptr)
    ci = host(A.col_idx)
    m, n = A.m, A.n
    lengths = (rp[1:] - rp[:-1]).astype(np.int64)
    nnz = int(rp[-1])
    mean = nnz / max(m, 1)
    var = float(((lengths - mean) ** 2).mean()) if m else 0.0
    if nnz:
        rows_of_nnz = np.repeat(np.arange(m, dtype=np.int64), lengths)
        offsets = ci.astype(np.int64) - rows_of_nnz
        bandwidth = int(np.abs(offsets).max())
        # same-pass diagonal census against the m plane slots a DIA row costs
        counts = np.bincount(offsets + (m - 1), minlength=m + n - 1)
        dense = counts >= DIAG_OCCUPANCY * max(m, 1)
        diag_fraction = float(counts[dense].sum() / nnz)
    else:
        bandwidth = 0
        diag_fraction = 0.0
    row_max = int(lengths.max(initial=0))
    return MatrixStats(
        m=m,
        n=n,
        nnz=nnz,
        rdensity=float(mean),
        row_var=var,
        row_max=row_max,
        bandwidth=bandwidth,
        diag_fraction=diag_fraction,
        row_skew=float(row_max / max(mean, 1e-30)) if nnz else 1.0,
    )


def compute_shard_stats(
    A: CSRMatrix, num_shards: int, rows_per_shard: int | None = None
) -> list:
    """Per-shard :class:`MatrixStats` for a contiguous row partition.

    Rows are split into ``num_shards`` contiguous blocks of
    ``rows_per_shard`` rows (default ``ceil(m / num_shards)``) and each block
    gets its own one-pass statistics, so the format registry can make a
    *per-shard* selection.  The distributed layer passes its tile-granular
    ``rows_per_shard`` so the recorded decisions describe the rows each
    shard really executes.

    Args:
      A: the global CSR matrix (post-reordering if the caller reorders).
      num_shards: number of contiguous row blocks.
      rows_per_shard: rows per block; None means ``ceil(m / num_shards)``.

    Returns:
      A list of ``num_shards`` :class:`MatrixStats`, one per row block (empty
      trailing blocks get all-zero stats).
    """
    m = A.m
    if rows_per_shard is None:
        rows_per_shard = -(-m // max(int(num_shards), 1))
    out = []
    for d in range(num_shards):
        r0 = min(d * rows_per_shard, m)
        r1 = min((d + 1) * rows_per_shard, m)
        out.append(compute_stats(A.row_slice(r0, r1)))
    return out


def classify_tile_reach(
    col_lo,
    col_hi,
    *,
    tiles_per_shard: int,
    rows_per_shard: int,
    num_shards: int,
):
    """Split each shard's tiles into interior and boundary sets by column reach.

    A tile is **interior** when every real column it reads lies inside its
    shard's own x slice ``[d·rows_per_shard, (d+1)·rows_per_shard)``: its
    SpMV needs no x of another shard.  Everything else is **boundary** and
    needs the halo.  Tiles are assigned to shards contiguously (tile ``t`` →
    shard ``t // tiles_per_shard``).  Empty tiles (``col_hi < col_lo``: all
    padding) are inert and counted as interior, but excluded from
    ``interior_fraction``, the fraction of *non-empty* tiles that are
    interior.

    Args:
      col_lo / col_hi: per-tile real column reach (``CSRkTiles.col_reach`` /
        ``SELLCSTiles.col_reach``), in absolute column indices.
      tiles_per_shard: local tiles per shard (``ceil(T / num_shards)``).
      rows_per_shard: kernel-space rows (= x slice length) per shard.
      num_shards: number of shards.

    Returns:
      ``(interior_ids, boundary_ids, interior_fraction)``: two
      ``num_shards``-tuples of int32 arrays of *local* tile ids, plus the
      global non-empty interior fraction (1.0 when there are no real tiles).
    """
    col_lo = np.asarray(col_lo)
    col_hi = np.asarray(col_hi)
    T = int(col_lo.shape[0])
    interior, boundary = [], []
    n_interior = n_real = 0
    for d in range(num_shards):
        t0 = d * tiles_per_shard
        t1 = min(t0 + tiles_per_shard, T)
        x0 = d * rows_per_shard
        x1 = x0 + rows_per_shard
        ii, bb = [], []
        for t in range(t0, t1):
            if col_hi[t] < col_lo[t]:          # all-padding tile: inert
                ii.append(t - t0)
                continue
            n_real += 1
            if x0 <= col_lo[t] and col_hi[t] < x1:
                ii.append(t - t0)
                n_interior += 1
            else:
                bb.append(t - t0)
        interior.append(np.asarray(ii, np.int32))
        boundary.append(np.asarray(bb, np.int32))
    frac = n_interior / n_real if n_real else 1.0
    return tuple(interior), tuple(boundary), frac
