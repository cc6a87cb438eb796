"""Metrics registry: counters, gauges, timers and series for the sparse stack.

Port of ``repro.obs.registry``; identical apart from :func:`concrete`.

One process-global :class:`MetricsRegistry` (swap it with
:func:`set_registry` / :func:`using_registry`) accumulates everything the
instrumented layers emit — ``prepare()`` phase timings, kernel launch
counters, solver residual series, sharding decisions — and exports them as
the same ``{"section", "name", "value", "unit"}`` records the benchmark
harness already archives, so telemetry and perf tracking share one schema.

Design constraints, in order:

1. **Observation never changes results.**  The registry only reads values;
   instrumented code paths are identical whether telemetry is on or off
   (pinned bit-for-bit by ``tests/test_torch_spmv.py``).
2. **Only concrete values.**  :func:`concrete` maps anything that is not a
   number (or a one-element tensor) to None and the registry skips it.
3. **No-op when disabled.**  A disabled registry does no timing, allocates
   nothing, and hands out one shared null context for every timer.
4. **Bounded memory.**  Timers keep running aggregates (count/total/min/max),
   not per-call lists; series are capped at :data:`SERIES_CAP` elements with
   a drop counter, so a long-running server cannot grow without bound.

Disable globally by exporting ``REPRO_OBS=0`` before import, or at runtime
with :func:`disable`.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

#: Series keep at most this many points; later appends count as dropped.
SERIES_CAP = 4096

_NULL_CTX = contextlib.nullcontext()


def concrete(value) -> Optional[float]:
    """Return ``float(value)`` for a plain number or one-element tensor, else None.

    PyTorch runs eagerly, so there are no tracers to keep out (the JAX
    reference's reason for this function); reading a CUDA tensor here waits
    for the device, so instrumented code records device values only where
    the caller already synchronises.
    """
    if isinstance(value, (bool, int, float)):
        return float(value)
    try:
        return float(value)
    except (TypeError, ValueError, RuntimeError):
        return None


class _Timer:
    """Running aggregate for one timer metric (no per-call storage)."""

    __slots__ = ("count", "total", "min", "max")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = 0.0

    def add(self, seconds: float) -> None:
        self.count += 1
        self.total += seconds
        self.min = min(self.min, seconds)
        self.max = max(self.max, seconds)


class MetricsRegistry:
    """Thread-safe store of counters, gauges, timers and series.

    Keys are ``(section, name)`` pairs matching the benchmark record schema;
    :meth:`records` flattens everything into ``{"section", "name", "value",
    "unit"}`` dicts (timers export ``<name>_ms`` totals plus ``<name>_calls``;
    series export one record per element as ``<name>.<i>``).
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._counters: Dict[Tuple[str, str], Tuple[float, str]] = {}
        self._gauges: Dict[Tuple[str, str], Tuple[float, str]] = {}
        self._timers: Dict[Tuple[str, str], _Timer] = {}
        self._series: Dict[Tuple[str, str], Tuple[List[float], str, int]] = {}

    # -- write side ----------------------------------------------------------
    def counter(self, section: str, name: str, value: float = 1,
                unit: str = "count") -> None:
        """Add ``value`` to a monotonically accumulating counter."""
        if not self.enabled:
            return
        v = concrete(value)
        if v is None:
            return
        with self._lock:
            old, _ = self._counters.get((section, name), (0.0, unit))
            self._counters[(section, name)] = (old + v, unit)

    def gauge(self, section: str, name: str, value,
              unit: str = "scalar") -> None:
        """Set a last-value-wins gauge (non-numbers are silently skipped)."""
        if not self.enabled:
            return
        v = concrete(value)
        if v is None:
            return
        with self._lock:
            self._gauges[(section, name)] = (v, unit)

    def timer(self, section: str, name: str):
        """Context manager timing its block into a running aggregate.

        When the registry is disabled this returns one shared null context —
        no clock is read and nothing is allocated.
        """
        if not self.enabled:
            return _NULL_CTX
        return _TimerCtx(self, section, name)

    def _add_timing(self, section: str, name: str, seconds: float) -> None:
        with self._lock:
            t = self._timers.get((section, name))
            if t is None:
                t = self._timers[(section, name)] = _Timer()
            t.add(seconds)

    def series(self, section: str, name: str, values,
               unit: str = "scalar") -> None:
        """Append concrete elements of ``values`` to a capped series."""
        if not self.enabled:
            return
        pts = []
        for v in values:
            c = concrete(v)
            if c is None:
                return  # traced series: drop wholesale, keep nothing partial
            pts.append(c)
        with self._lock:
            cur, u, dropped = self._series.get((section, name), ([], unit, 0))
            room = SERIES_CAP - len(cur)
            cur = cur + pts[:room]
            dropped += max(len(pts) - room, 0)
            self._series[(section, name)] = (cur, u, dropped)

    def observe(self, section: str, name: str, value,
                unit: str = "scalar") -> None:
        """Append a single point to a series."""
        self.series(section, name, [value], unit=unit)

    def clear(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._timers.clear()
            self._series.clear()

    # -- read side -----------------------------------------------------------
    def get(self, section: str, name: str) -> Optional[float]:
        """Current value of a counter or gauge (None if absent)."""
        with self._lock:
            if (section, name) in self._counters:
                return self._counters[(section, name)][0]
            if (section, name) in self._gauges:
                return self._gauges[(section, name)][0]
        return None

    def get_series(self, section: str, name: str) -> List[float]:
        with self._lock:
            entry = self._series.get((section, name))
            return list(entry[0]) if entry else []

    def records(self) -> List[dict]:
        """Flatten everything into benchmark-schema records."""
        out = []
        with self._lock:
            for (sec, name), (v, unit) in sorted(self._counters.items()):
                out.append({"section": sec, "name": name, "value": v,
                            "unit": unit})
            for (sec, name), (v, unit) in sorted(self._gauges.items()):
                out.append({"section": sec, "name": name, "value": v,
                            "unit": unit})
            for (sec, name), t in sorted(self._timers.items()):
                out.append({"section": sec, "name": f"{name}_ms",
                            "value": t.total * 1e3, "unit": "ms"})
                out.append({"section": sec, "name": f"{name}_calls",
                            "value": float(t.count), "unit": "count"})
            for (sec, name), (pts, unit, dropped) in sorted(
                self._series.items()
            ):
                for i, p in enumerate(pts):
                    out.append({"section": sec, "name": f"{name}.{i}",
                                "value": p, "unit": unit})
                if dropped:
                    out.append({"section": sec, "name": f"{name}.dropped",
                                "value": float(dropped), "unit": "count"})
        return out


class _TimerCtx:
    """Re-entrant-per-use timing context feeding one registry aggregate."""

    __slots__ = ("_reg", "_section", "_name", "_t0")

    def __init__(self, reg: MetricsRegistry, section: str, name: str):
        self._reg = reg
        self._section = section
        self._name = name

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._reg._add_timing(
            self._section, self._name, time.perf_counter() - self._t0
        )
        return False


# -- process-global registry -------------------------------------------------

_registry = MetricsRegistry(
    enabled=os.environ.get("REPRO_OBS", "1") not in ("0", "false", "off")
)


def get_registry() -> MetricsRegistry:
    """The process-global registry every instrumented layer writes to."""
    return _registry


def set_registry(reg: MetricsRegistry) -> MetricsRegistry:
    """Swap the global registry; returns the previous one."""
    global _registry
    old, _registry = _registry, reg
    return old


@contextlib.contextmanager
def using_registry(reg: MetricsRegistry):
    """Scoped registry swap (tests and benchmark sections use this)."""
    old = set_registry(reg)
    try:
        yield reg
    finally:
        set_registry(old)


def enabled() -> bool:
    return _registry.enabled


def enable() -> None:
    _registry.enabled = True


def disable() -> None:
    _registry.enabled = False
