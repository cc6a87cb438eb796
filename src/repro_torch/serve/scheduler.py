"""Deterministic continuous-batching scheduler for same-matrix SpMV requests.

Port of ``repro.serve.scheduler``, the same code and the same decisions:
pure Python, kept as the port's own copy because the port imports nothing
of ``repro``.

The scheduler owns only *decisions*: which pending requests to coalesce into
the next ``[n, B]`` SpMM block.  It holds no clock and no threads — every
method takes ``now`` explicitly (the engine injects its clock), so any
arrival/dispatch interleaving can be replayed in a unit test without sleeps
(tests/test_torch_serve_scheduler.py pins the rules below with a fake clock).

Coalescing rules, in order:

1. **Global FIFO across matrices.**  The queue whose head request arrived
   earliest is always served first — a burst on one matrix cannot starve an
   older request on another.
2. **Same key only.**  A batch takes consecutive requests from one queue
   key (matrix fingerprint + x dtype).  Mixing dtypes would silently upcast
   and break the engine's bit-for-bit contract, so it is structurally
   impossible here.
3. **Column budget.**  Requests are taken in arrival order while their total
   column count fits ``max_batch`` (a ``[n]`` request is 1 column, ``[n, B]``
   is B).  A single request wider than ``max_batch`` dispatches alone.
4. **Dispatch when full or aged.**  A batch is released when it cannot grow
   (budget reached, or a queued request doesn't fit), when the oldest member
   has waited ``max_wait`` clock seconds, or when the caller flushes.  With
   the default ``max_wait=0.0`` the scheduler never idles: whatever is
   queued goes out on the next step.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Deque, Dict, Hashable, List, Optional

import collections


class SpMVFuture:
    """Single-assignment result slot for one submitted request.

    The engine is step-driven and single-threaded by design, so this is a
    plain slot rather than a concurrent future: ``result()`` raises until
    the step that dispatches the request has run (``drain()`` guarantees it).
    """

    __slots__ = ("_value", "_done")

    def __init__(self) -> None:
        self._value = None
        self._done = False

    def set_result(self, value) -> None:
        if self._done:
            raise RuntimeError("future already resolved")
        self._value = value
        self._done = True

    def done(self) -> bool:
        return self._done

    def result(self):
        if not self._done:
            raise RuntimeError(
                "request not served yet — call engine.step()/drain() first"
            )
        return self._value


@dataclasses.dataclass
class Request:
    """One queued ``(matrix_id, x)`` multiply.

    ``seq`` is the global arrival index (the FIFO total order), ``cols`` the
    number of x columns this request contributes to a coalesced block, and
    ``key`` the coalescing bucket (matrix fingerprint + x dtype).
    """

    seq: int
    matrix_id: str
    key: Hashable
    x: Any
    cols: int
    t_submit: float
    future: SpMVFuture


@dataclasses.dataclass
class Batch:
    """A scheduler decision: these requests run as one SpMM dispatch."""

    matrix_id: str
    key: Hashable
    requests: List[Request]
    cols: int
    t_oldest: float


class CoalescingScheduler:
    """Continuous-batching queue with explicit-clock dispatch decisions."""

    def __init__(self, max_batch: int = 8, max_wait: float = 0.0):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_wait < 0:
            raise ValueError(f"max_wait must be >= 0, got {max_wait}")
        self.max_batch = max_batch
        self.max_wait = max_wait
        self._queues: Dict[Hashable, Deque[Request]] = {}

    # -- queue state ---------------------------------------------------------
    @property
    def queue_depth(self) -> int:
        """Number of pending requests (not columns)."""
        return sum(len(q) for q in self._queues.values())

    @property
    def pending_cols(self) -> int:
        return sum(r.cols for q in self._queues.values() for r in q)

    def submit(self, req: Request) -> None:
        self._queues.setdefault(req.key, collections.deque()).append(req)

    # -- the decision --------------------------------------------------------
    def next_batch(self, now: float, flush: bool = False) -> Optional[Batch]:
        """Return the next coalesced batch, or None if nothing is ready.

        Deterministic in (queue state, now, flush): no clock reads, no
        randomness.  Popping happens only when a batch is actually returned.
        """
        heads = [(q[0].seq, key) for key, q in self._queues.items() if q]
        if not heads:
            return None
        _, key = min(heads)
        q = self._queues[key]
        take = [q[0]]
        cols = q[0].cols
        for req in itertools.islice(q, 1, None):
            if cols + req.cols > self.max_batch:
                break
            take.append(req)
            cols += req.cols
        cannot_grow = cols >= self.max_batch or len(take) < len(q)
        aged = (now - take[0].t_submit) >= self.max_wait
        if not (flush or cannot_grow or aged):
            return None
        for _ in take:
            q.popleft()
        if not q:
            del self._queues[key]
        return Batch(
            matrix_id=take[0].matrix_id,
            key=key,
            requests=take,
            cols=cols,
            t_oldest=take[0].t_submit,
        )
