"""Sparse-format subsystem of the port: containers, statistics, registry.

* :mod:`repro_torch.sparse.coo` / :mod:`repro_torch.sparse.csr` — interchange formats
* :mod:`repro_torch.sparse.csrk` — CSR-k + its padded tile view
* :mod:`repro_torch.sparse.sellcs` — SELL-C-σ + its uniform-width chunk view
* :mod:`repro_torch.sparse.segsum` — segmented-sum CSR (equal-nnz chunks)
* :mod:`repro_torch.sparse.diahybrid` — dense-diagonal DIA plane + CSR remainder
* :mod:`repro_torch.sparse.baselines` — ELL / BCSR / CSR5-like baselines
* :mod:`repro_torch.sparse.stats` — one-pass matrix statistics
* :mod:`repro_torch.sparse.registry` — O(1) ``select_format`` dispatch
* :mod:`repro_torch.sparse.convert` — containers from numpy arrays
"""
from repro_torch.sparse.coo import COOMatrix  # noqa: F401
from repro_torch.sparse.csr import CSRMatrix, csr_from_coo  # noqa: F401
from repro_torch.sparse.csrk import (  # noqa: F401
    CSRkMatrix,
    CSRkTileBuckets,
    CSRkTiles,
    bucket_tiles,
    build_csrk,
    tiles_from_csrk,
)
from repro_torch.sparse.sellcs import (  # noqa: F401
    SELLCSMatrix,
    SELLCSTiles,
    sellcs_from_csr,
    tiles_from_sellcs,
)
from repro_torch.sparse.segsum import SegSumCSR, segsum_from_csr  # noqa: F401
from repro_torch.sparse.diahybrid import (  # noqa: F401
    DIAHybridMatrix,
    dense_diagonals,
    diahybrid_from_csr,
)
from repro_torch.sparse.baselines import (  # noqa: F401
    BCSRMatrix,
    CSR5LikeMatrix,
    ELLMatrix,
    bcsr_from_csr,
    csr5_from_csr,
    ell_from_csr,
)
from repro_torch.sparse.stats import (  # noqa: F401
    DIA_FRACTION_MIN,
    DIAG_OCCUPANCY,
    REGULAR_ROW_VAR_MAX,
    SEGSUM_ROW_SKEW_MIN,
    MatrixStats,
    compute_stats,
)
from repro_torch.sparse.registry import (  # noqa: F401
    FormatSpec,
    available_formats,
    get_format,
    register_format,
    select_format,
)
