"""CSR-k heterogeneous SpMV — the paper's contribution, ported to PyTorch."""
from repro_torch.core.ordering import bandk, bandwidth, rcm  # noqa: F401
from repro_torch.core.tuner import TuningParams, fit_log_model, tune  # noqa: F401
from repro_torch.core.spmv import PreparedSpMV, prepare, spmm, spmv  # noqa: F401
from repro_torch.core.solvers import (  # noqa: F401
    block_cg,
    block_power_iteration,
    cg,
    jacobi_smoother,
    power_iteration,
)
