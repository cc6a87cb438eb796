"""Serving statistics: bounded aggregates the engine keeps per process.

Port of ``repro.serve.stats``, the same code: pure Python, kept as the
port's own copy because the port imports nothing of ``repro``.

The engine records every request/batch event here (plain Python counters and
capped reservoirs — no torch, no clocks of its own), and flushes a snapshot
into the :mod:`repro_torch.obs` registry per logging interval.  Keeping the raw
aggregation separate from the registry means the engine's accounting works
identically with telemetry disabled (the registry emission is the only part
that becomes a no-op), which is what the telemetry-off bit-for-bit test
pins.

Percentiles use the nearest-rank method over a bounded reservoir of the most
recent :data:`RESERVOIR_CAP` observations, so a long-running server keeps
O(1) memory and the percentiles track current traffic rather than all-time
history.
"""
from __future__ import annotations

import collections
from typing import Dict, Iterable, Optional, Sequence

#: Latency/batch reservoirs keep the most recent this-many observations.
RESERVOIR_CAP = 4096


def percentile(values: Sequence[float], q: float) -> float:
    """Nearest-rank percentile of ``values`` (q in [0, 100]); 0.0 if empty."""
    if not values:
        return 0.0
    ordered = sorted(values)
    rank = max(int(-(-q / 100.0 * len(ordered) // 1)), 1)  # ceil, >= 1
    return float(ordered[min(rank, len(ordered)) - 1])


class ServeStats:
    """Request/batch/latency accounting for one :class:`~repro_torch.serve.ServeEngine`.

    All counters are cumulative over the engine's lifetime; the latency and
    batch-width reservoirs are sliding windows of the most recent
    :data:`RESERVOIR_CAP` events.
    """

    def __init__(self) -> None:
        self.requests_submitted = 0
        self.requests_completed = 0
        self.batches_dispatched = 0
        self.columns_dispatched = 0
        self._latencies_s: collections.deque = collections.deque(
            maxlen=RESERVOIR_CAP
        )
        self._batch_cols: collections.deque = collections.deque(
            maxlen=RESERVOIR_CAP
        )

    # -- write side ----------------------------------------------------------
    def observe_latency(self, seconds: float) -> None:
        self._latencies_s.append(float(seconds))

    def observe_batch(self, cols: int) -> None:
        self.batches_dispatched += 1
        self.columns_dispatched += cols
        self._batch_cols.append(float(cols))

    # -- read side -----------------------------------------------------------
    def latency_percentiles_ms(
        self, qs: Iterable[float] = (50, 95, 99)
    ) -> Dict[str, float]:
        vals = list(self._latencies_s)
        return {f"p{int(q)}": percentile(vals, q) * 1e3 for q in qs}

    def mean_batch_cols(self) -> float:
        if not self._batch_cols:
            return 0.0
        return sum(self._batch_cols) / len(self._batch_cols)

    def snapshot(self) -> Dict[str, float]:
        """One flat dict of everything — what the CLI prints after a drain."""
        out = {
            "requests_submitted": float(self.requests_submitted),
            "requests_completed": float(self.requests_completed),
            "batches_dispatched": float(self.batches_dispatched),
            "columns_dispatched": float(self.columns_dispatched),
            "mean_batch_cols": self.mean_batch_cols(),
        }
        for k, v in self.latency_percentiles_ms().items():
            out[f"latency_{k}_ms"] = v
        return out


def emit_interval(
    reg,
    stats: ServeStats,
    *,
    queue_depth: int,
    cache,
    throughput_rps: Optional[float],
) -> None:
    """Flush one logging interval's view of the engine into the registry.

    Emits the record shapes tests/test_torch_serve_engine.py pins: a
    ``serve.queue_depth`` series point, latency-percentile gauges, the cache
    hit rate, and the prepare-amortization ratio (requests served per
    ``prepare()`` actually run — the number the paper's constant-time-tuning
    story is about).  No-op when the registry is disabled.
    """
    if not reg.enabled:
        return
    reg.observe("serve", "queue_depth", queue_depth, unit="count")
    for k, v in stats.latency_percentiles_ms().items():
        reg.gauge("serve", f"latency_{k}_ms", v, unit="ms")
    reg.gauge("serve", "mean_batch_cols", stats.mean_batch_cols(),
              unit="count")
    if throughput_rps is not None:
        reg.gauge("serve", "throughput_rps", throughput_rps, unit="req/s")
    lookups = cache.hits + cache.misses
    if lookups:
        reg.gauge("serve", "cache_hit_rate", cache.hits / lookups,
                  unit="fraction")
    if cache.prepares:
        reg.gauge("serve", "prepare_amortization",
                  stats.requests_completed / cache.prepares, unit="ratio")
