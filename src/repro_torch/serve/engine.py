"""The SpMV serving engine: continuous batching over cached operators.

Port of ``repro.serve.engine``.  A stream of ``(matrix_id, x)`` requests is
queued by a deterministic
:class:`~repro_torch.serve.scheduler.CoalescingScheduler`, coalesced into
``[n, B]`` SpMM blocks (the matrix stream is read once for the whole
block), executed through one :class:`~repro_torch.core.spmv.PreparedSpMV`
per matrix fingerprint held in a byte-budget LRU
:class:`~repro_torch.serve.cache.OperatorCache`, and scattered back to
per-request futures.  The operators live on ``device`` ("cuda" unless the
caller asks for the CPU), and every request's x is put there once, at
submit time.

**The bit-for-bit contract.**  Every request's result is bit-identical to a
direct call of the same prepared operator with that request's own payload,
no matter how requests are interleaved or coalesced.  This holds because
(a) engine operators are prepared with a fixed ``spmm_width``, so every
kernel launch is padded to one column width (the port's kernels also sum
each column in one order at any width, so (a) is kept for parity with the
reference); (b) the scheduler never mixes x dtypes in one block; and (c)
``prepare()`` is deterministic, so the cached operator equals a freshly
prepared one.  Pinned under randomized interleavings by
tests/test_torch_serve_engine.py.

**x dtypes.**  ``submit`` turns float64 x into float32, as the reference's
``jnp.asarray`` does with 64-bit types off.  The CUDA kernels take float32
and bfloat16 x (y comes out in x's dtype, summed in f32 and rounded once),
so on a CUDA engine ``submit`` raises for any other dtype (float16, integer
x) before the request is queued; the CPU engine serves what the plain
versions take.

**Determinism by construction.**  The engine owns no threads and reads no
wall clock of its own: ``clock`` is injected (default
``time.monotonic``) and work happens only inside explicit ``step()`` /
``drain()`` calls, so every scheduling behavior is unit-testable with a fake
clock and no sleeps.

Telemetry (queue-depth series, latency percentiles, throughput, cache hit
rate, prepare amortization) flows through the :mod:`repro_torch.obs`
registry per ``log_interval`` clock seconds; with the registry disabled the
engine makes no registry calls, adds no sync points, and returns
bit-identical results.
"""
from __future__ import annotations

import itertools
import time
from typing import Callable, Dict, Optional

import torch

from repro_torch.core.spmv import _resolve_device
from repro_torch.kernels.spmv_csrk import X_KIND
from repro_torch.obs import get_registry
from repro_torch.serve.cache import OperatorCache
from repro_torch.serve.scheduler import CoalescingScheduler, Request, SpMVFuture
from repro_torch.serve.stats import ServeStats, emit_interval


class ServeEngine:
    """Step-driven SpMV/SpMM server over a registered set of matrices.

    Args:
      max_batch: column budget per coalesced dispatch (a ``[n]`` request is
        one column, ``[n, B]`` is B; one wider request dispatches alone).
      max_wait: clock seconds a partial batch may wait for more same-matrix
        arrivals before dispatching anyway.  0.0 (default) never idles.
      cache_bytes: operator-cache byte budget (None = unbounded); evicted
        matrices are transparently re-prepared on their next request.
      clock: injectable monotonic clock, ``() -> float`` seconds.
      log_interval: clock seconds between registry emissions (0.0 = every
        step); None disables interval logging entirely.
      device: where requests are served, a ``torch.device`` or its name
        ("cuda" unless the caller asks for "cpu"); resolved here, so an
        engine built for a card that is missing raises at construction.
      prepare_fn / **prepare_kwargs: how operators are built on cache miss
        (defaults to :func:`repro_torch.core.spmv.prepare` on ``device``
        with its defaults — ``device_model`` names the tuner's model,
        ``"h100"`` unless given —
        plus ``spmm_width=max_batch`` unless overridden, the fixed launch
        width of the bit-for-bit contract).  A custom ``prepare_fn`` takes
        over both responsibilities: it must put its operators on
        ``device``.
    """

    def __init__(
        self,
        *,
        max_batch: int = 8,
        max_wait: float = 0.0,
        cache_bytes: Optional[int] = None,
        clock: Callable[[], float] = time.monotonic,
        log_interval: Optional[float] = 0.0,
        device="cuda",
        prepare_fn=None,
        **prepare_kwargs,
    ):
        self.device = _resolve_device(device)
        self._clock = clock
        self.scheduler = CoalescingScheduler(
            max_batch=max_batch, max_wait=max_wait
        )
        if prepare_fn is None:
            # fixed-width launches are what make coalescing bit-transparent
            prepare_kwargs.setdefault("spmm_width", max_batch)
            prepare_kwargs["device"] = self.device
        self.cache = OperatorCache(
            byte_budget=cache_bytes, prepare_fn=prepare_fn, **prepare_kwargs
        )
        self.stats = ServeStats()
        self._matrices: Dict[str, object] = {}
        self._fingerprints: Dict[str, str] = {}
        self._seq = itertools.count()
        self._log_interval = log_interval
        self._t_start: Optional[float] = None
        self._t_last_log: Optional[float] = None

    # -- matrix registry -----------------------------------------------------
    def add_matrix(self, matrix_id: str, A) -> str:
        """Register matrix content under ``matrix_id``; returns its fingerprint.

        The host CSR is retained so an evicted operator can be re-prepared on
        demand.  Re-registering an id with *different* content raises — ids
        are immutable bindings; two ids may freely share identical content
        (they then share one cached operator).
        """
        fp = A.fingerprint()
        old = self._fingerprints.get(matrix_id)
        if old is not None and old != fp:
            raise ValueError(
                f"matrix_id {matrix_id!r} already bound to different content"
            )
        self._matrices[matrix_id] = A
        self._fingerprints[matrix_id] = fp
        return fp

    @property
    def matrix_ids(self):
        return list(self._matrices)

    @property
    def queue_depth(self) -> int:
        return self.scheduler.queue_depth

    # -- request path --------------------------------------------------------
    def submit(self, matrix_id: str, x) -> SpMVFuture:
        """Queue y = A x; returns a future resolved by a later step().

        ``x`` (a tensor or numpy array) may be ``[n]`` or ``[n, B]``; it is
        put on the engine's device here, float64 becoming float32.  Requests
        coalesce only with same-matrix, same-dtype requests (mixing dtypes
        would upcast and break bit-identity), in arrival order.  Raises
        before queuing for a shape the matrix does not take, and on a CUDA
        engine for any x dtype but float32 and bfloat16.
        """
        if matrix_id not in self._matrices:
            raise KeyError(f"unregistered matrix_id {matrix_id!r}")
        A = self._matrices[matrix_id]
        x = torch.as_tensor(x)
        if x.dtype == torch.float64:
            x = x.to(torch.float32)
        if x.ndim not in (1, 2) or x.shape[0] != A.shape[1]:
            raise ValueError(
                f"x shape {tuple(x.shape)} does not match matrix n={A.shape[1]} "
                "(expected [n] or [n, B])"
            )
        if self.device.type == "cuda" and x.dtype not in X_KIND:
            raise TypeError(
                f"x has dtype {x.dtype}; the CUDA kernels take float32 or bfloat16 x"
            )
        x = x.to(self.device)
        now = self._clock()
        if self._t_start is None:
            self._t_start = now
        req = Request(
            seq=next(self._seq),
            matrix_id=matrix_id,
            key=(self._fingerprints[matrix_id], str(x.dtype)),
            x=x,
            cols=1 if x.ndim == 1 else int(x.shape[1]),
            t_submit=now,
            future=SpMVFuture(),
        )
        self.scheduler.submit(req)
        self.stats.requests_submitted += 1
        return req.future

    # -- step loop -----------------------------------------------------------
    def step(self, flush: bool = False) -> int:
        """Run one scheduling decision + dispatch; returns requests completed.

        Returns 0 when the scheduler decided to keep waiting (partial batch
        younger than ``max_wait``) or the queue is empty.  ``flush=True``
        overrides the wait — what ``drain()`` uses.  A cache miss prepares
        the matrix inside this call.
        """
        reg = get_registry()
        now = self._clock()
        batch = self.scheduler.next_batch(now, flush=flush)
        if batch is None:
            self._maybe_log(now)
            return 0
        op = self._operator(batch.matrix_id)
        reqs = batch.requests
        with reg.timer("serve", "dispatch"):
            if len(reqs) == 1:
                # exactly the direct call — no concat/slice round-trip
                outs = [op(reqs[0].x)]
            else:
                blocks = [r.x if r.x.ndim == 2 else r.x[:, None] for r in reqs]
                Y = op(torch.cat(blocks, dim=1))
                outs = []
                off = 0
                for r in reqs:
                    outs.append(
                        Y[:, off:off + r.cols] if r.x.ndim == 2 else Y[:, off]
                    )
                    off += r.cols
            if reg.enabled and self.device.type == "cuda":
                # timed dispatch wants a sync point; disabled runs keep
                # fully async dispatch
                torch.cuda.synchronize(self.device)
        t_done = self._clock()
        for r, y in zip(reqs, outs):
            r.future.set_result(y)
            self.stats.observe_latency(t_done - r.t_submit)
            reg.observe("serve", "latency_ms",
                        (t_done - r.t_submit) * 1e3, unit="ms")
        self.stats.requests_completed += len(reqs)
        self.stats.observe_batch(batch.cols)
        reg.counter("serve", "requests", len(reqs))
        reg.counter("serve", "batches")
        reg.observe("serve", "batch_cols", batch.cols, unit="count")
        self._maybe_log(t_done)
        return len(reqs)

    def drain(self) -> int:
        """Flush-step until the queue is empty; returns requests completed."""
        completed = 0
        while self.scheduler.queue_depth:
            completed += self.step(flush=True)
        return completed

    # -- internals -----------------------------------------------------------
    def _operator(self, matrix_id: str):
        op, _hit = self.cache.get_or_prepare(
            self._matrices[matrix_id],
            fingerprint=self._fingerprints[matrix_id],
        )
        return op

    def _maybe_log(self, now: float) -> None:
        if self._log_interval is None:
            return
        reg = get_registry()
        if not reg.enabled:
            return
        if (self._t_last_log is not None
                and now - self._t_last_log < self._log_interval):
            return
        self._t_last_log = now
        elapsed = (now - self._t_start) if self._t_start is not None else 0.0
        throughput = (
            self.stats.requests_completed / elapsed if elapsed > 0 else None
        )
        emit_interval(
            reg, self.stats,
            queue_depth=self.scheduler.queue_depth,
            cache=self.cache,
            throughput_rps=throughput,
        )
