"""Trace annotations: name regions of the sparse stack for profilers.

Port of ``repro.obs.trace``.  :func:`annotate` stacks two scopes:

* ``torch.profiler.record_function`` — names the region on the host timeline
  of a ``torch.profiler`` capture, next to the kernels it launched;
* ``torch.cuda.nvtx.range`` — names it for NVTX-aware tools, only when CUDA
  is present.

Neither scope changes any computed value; when telemetry is disabled the
function returns one shared null context and touches nothing.
"""
from __future__ import annotations

import contextlib
import functools

import torch

from repro_torch.obs.registry import _NULL_CTX, get_registry


def annotate(name: str):
    """Context manager naming a region for profilers.

    Usage::

        with annotate("repro_torch.spmv_csrk"):
            y = spmv_csrk_tiles(...)

    Returns a shared null context when telemetry is disabled (no-op).
    """
    if not get_registry().enabled:
        return _NULL_CTX
    ctx = contextlib.ExitStack()
    ctx.enter_context(torch.profiler.record_function(name))
    if torch.cuda.is_available():
        ctx.enter_context(torch.cuda.nvtx.range(name))
    return ctx


def annotated(name: str, *, count_section: str | None = None):
    """Decorator form of :func:`annotate`, optionally counting invocations.

    ``count_section`` additionally bumps a ``<name>.calls`` counter in that
    section (one per Python-level call).
    """

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            reg = get_registry()
            if not reg.enabled:
                return fn(*args, **kwargs)
            if count_section is not None:
                reg.counter(count_section, f"{name}.calls")
            with annotate(name):
                return fn(*args, **kwargs)

        return wrapper

    return deco
