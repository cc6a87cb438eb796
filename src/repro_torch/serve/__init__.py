"""repro_torch.serve — the SpMV serving engine (continuous batching + operator cache).

Port of ``repro.serve``; the same public surface:

* :class:`ServeEngine` — step-driven request engine: ``add_matrix`` /
  ``submit`` / ``step`` / ``drain``, on a CUDA card unless the caller asks
  for the CPU.
* :class:`CoalescingScheduler`, :class:`Request`, :class:`Batch` — the
  deterministic batching decisions (injectable clock, no threads).
* :class:`OperatorCache` — fingerprint-keyed byte-budget LRU of
  :class:`~repro_torch.core.spmv.PreparedSpMV` operators.
* :class:`ServeStats`, :func:`percentile` — bounded serving statistics.
* :class:`SpMVFuture` — the per-request result slot.
"""
from repro_torch.serve.cache import OperatorCache
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.scheduler import (
    Batch,
    CoalescingScheduler,
    Request,
    SpMVFuture,
)
from repro_torch.serve.stats import RESERVOIR_CAP, ServeStats, emit_interval, percentile

__all__ = [
    "Batch",
    "CoalescingScheduler",
    "OperatorCache",
    "Request",
    "RESERVOIR_CAP",
    "ServeEngine",
    "ServeStats",
    "SpMVFuture",
    "emit_interval",
    "percentile",
]
