"""repro_torch.obs — telemetry for the port's sparse stack.

* :mod:`repro_torch.obs.registry` — process-global :class:`MetricsRegistry`
  of counters / gauges / timers / series; a strict no-op when disabled.
* :mod:`repro_torch.obs.trace` — :func:`annotate` / :func:`annotated`
  profiler scopes (``torch.profiler.record_function`` + NVTX).

Instrumentation contract: observing never changes a computed value.
"""
from repro_torch.obs.registry import (  # noqa: F401
    MetricsRegistry,
    SERIES_CAP,
    concrete,
    disable,
    enable,
    enabled,
    get_registry,
    set_registry,
    using_registry,
)
from repro_torch.obs.trace import annotate, annotated  # noqa: F401
