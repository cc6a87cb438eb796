"""One-pass matrix statistics feeding the O(1) format selector.

Port of ``repro.sparse.stats`` (``MatrixStats``, ``compute_stats`` and the
routing thresholds).  The paper's constant-time tuner keys on mean row
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
