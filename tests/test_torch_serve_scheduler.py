"""Fake-clock tests of the port's serving scheduler and operator cache.

The reference's cases (``tests/test_serve_scheduler.py``) against
``repro_torch.serve``, with the same fake clock and hand-computed
expectations — no threads, no sleeps, no wall-time reads: max-batch /
max-wait coalescing rules, FIFO fairness across matrices, byte-budget LRU
eviction order, re-prepare after eviction, and hit/miss/prepare accounting.
Budgets come from the port's own ``resident_bytes``.  One more case sends a
seeded arrival stream through both packages' schedulers, which must cut the
same batches.
"""
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  one torch thread per test process

from repro.serve import CoalescingScheduler as JScheduler
from repro.serve import Request as JRequest
from repro.serve import SpMVFuture as JFuture

from repro_torch.configs.spmv_suite import grid_laplacian_2d
from repro_torch.core.spmv import prepare
from repro_torch.serve import (
    CoalescingScheduler,
    OperatorCache,
    Request,
    ServeEngine,
    SpMVFuture,
)


class FakeClock:
    """Manually-advanced monotonic clock."""

    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def _req(seq, mid="m", cols=1, t=0.0, key=None):
    return Request(
        seq=seq, matrix_id=mid, key=key or (mid, "torch.float32"),
        x=None, cols=cols, t_submit=t, future=SpMVFuture(),
    )


# -- scheduler: coalescing rules ---------------------------------------------

def test_full_batch_dispatches_immediately_partial_waits():
    s = CoalescingScheduler(max_batch=4, max_wait=10.0)
    for i in range(5):
        s.submit(_req(i, t=0.0))
    b = s.next_batch(now=0.0)
    assert b is not None and [r.seq for r in b.requests] == [0, 1, 2, 3]
    assert b.cols == 4
    # the leftover single request is partial and young: not ready
    assert s.next_batch(now=0.0) is None
    assert s.queue_depth == 1
    # ...until it ages past max_wait
    assert s.next_batch(now=9.999) is None
    b2 = s.next_batch(now=10.0)
    assert b2 is not None and [r.seq for r in b2.requests] == [4]
    assert s.queue_depth == 0


def test_flush_overrides_max_wait():
    s = CoalescingScheduler(max_batch=8, max_wait=100.0)
    s.submit(_req(0, t=0.0))
    assert s.next_batch(now=0.0) is None
    b = s.next_batch(now=0.0, flush=True)
    assert b is not None and b.cols == 1


def test_zero_max_wait_never_idles():
    s = CoalescingScheduler(max_batch=8, max_wait=0.0)
    s.submit(_req(0, t=5.0))
    b = s.next_batch(now=5.0)
    assert b is not None and [r.seq for r in b.requests] == [0]


def test_mixed_width_column_budget():
    # widths 2 + 3 fit max_batch=8; the 4-wide next does not → batch stops,
    # and since a queued request didn't fit, the batch is "as full as it
    # gets" and dispatches without waiting.
    s = CoalescingScheduler(max_batch=8, max_wait=50.0)
    s.submit(_req(0, cols=2, t=0.0))
    s.submit(_req(1, cols=3, t=0.0))
    s.submit(_req(2, cols=4, t=0.0))
    b = s.next_batch(now=0.0)
    assert b is not None
    assert [r.seq for r in b.requests] == [0, 1] and b.cols == 5
    # the 4-wide leftover is now a lone partial batch: waits for age
    assert s.next_batch(now=0.0) is None
    b2 = s.next_batch(now=50.0)
    assert [r.seq for r in b2.requests] == [2] and b2.cols == 4


def test_oversized_request_dispatches_alone():
    s = CoalescingScheduler(max_batch=4, max_wait=100.0)
    s.submit(_req(0, cols=16, t=0.0))
    s.submit(_req(1, cols=1, t=0.0))
    b = s.next_batch(now=0.0)
    assert [r.seq for r in b.requests] == [0] and b.cols == 16


def test_fifo_across_matrices_oldest_head_wins():
    s = CoalescingScheduler(max_batch=8, max_wait=0.0)
    s.submit(_req(0, mid="a", key=("a", "f32"), t=0.0))
    s.submit(_req(1, mid="b", key=("b", "f32"), t=1.0))
    s.submit(_req(2, mid="a", key=("a", "f32"), t=2.0))
    b1 = s.next_batch(now=2.0)
    assert b1.matrix_id == "a" and [r.seq for r in b1.requests] == [0, 2]
    b2 = s.next_batch(now=2.0)
    assert b2.matrix_id == "b" and [r.seq for r in b2.requests] == [1]
    assert s.next_batch(now=2.0) is None


def test_same_matrix_different_dtype_never_coalesces():
    s = CoalescingScheduler(max_batch=8, max_wait=0.0)
    s.submit(_req(0, mid="a", key=("a", "torch.float32")))
    s.submit(_req(1, mid="a", key=("a", "torch.bfloat16")))
    b1 = s.next_batch(now=0.0)
    b2 = s.next_batch(now=0.0)
    assert [r.seq for r in b1.requests] == [0]
    assert [r.seq for r in b2.requests] == [1]


@pytest.mark.parametrize("kwargs", [{"max_batch": 0}, {"max_wait": -1.0}],
                         ids=["max_batch", "max_wait"])
def test_scheduler_validates_params(kwargs):
    with pytest.raises(ValueError):
        CoalescingScheduler(**kwargs)


def test_schedulers_of_both_packages_cut_the_same_batches():
    """A seeded stream (mixed widths, two dtypes, three matrices, random
    clock steps, flushes and budgets) through the reference's and the port's
    schedulers: the same batches, in the same order."""
    rng = np.random.default_rng(20)
    for trial in range(6):
        max_batch, max_wait = int(rng.integers(1, 9)), float(rng.choice([0.0, 0.5, 2.0]))
        both = (JScheduler(max_batch=max_batch, max_wait=max_wait),
                CoalescingScheduler(max_batch=max_batch, max_wait=max_wait))
        made = (lambda seq, mid, key, cols, t: JRequest(seq, mid, key, None, cols, t, JFuture()),
                lambda seq, mid, key, cols, t: Request(seq, mid, key, None, cols, t, SpMVFuture()))
        cuts = ([], [])
        now = 0.0
        for seq in range(60):
            mid = ("a", "b", "c")[int(rng.integers(3))]
            dtype = "float32" if rng.random() < 0.7 else "bfloat16"
            cols = int(rng.choice([1, 1, 1, 2, 3, 5, 9]))
            for s, mk in zip(both, made):
                s.submit(mk(seq, mid, (mid, dtype), cols, now))
            now += float(rng.exponential(0.4))
            flush = bool(rng.random() < 0.1)
            for _ in range(int(rng.integers(0, 3))):
                got = [s.next_batch(now, flush=flush) for s in both]
                for out, b in zip(cuts, got):
                    out.append(None if b is None else
                               (b.matrix_id, [r.seq for r in b.requests], b.cols))
        for s, out in zip(both, cuts):
            while s.queue_depth:
                b = s.next_batch(now, flush=True)
                out.append((b.matrix_id, [r.seq for r in b.requests], b.cols))
        assert cuts[0] == cuts[1], trial
        assert sum(len(c[1]) for c in cuts[1] if c) == 60


# -- operator cache: LRU + byte budget ---------------------------------------

def _cpu_op(A):
    return prepare(A, "cpu", device="cpu", reorder="natural", format="csrk")


def _mats():
    # three distinct-content matrices with identical footprints
    out = []
    for shift in (0.0, 1.0, 2.0):
        A = grid_laplacian_2d(6, 6)
        out.append(
            type(A)(A.row_ptr, A.col_idx, A.vals + shift, A.shape)
        )
    return out


def test_cache_hit_miss_prepare_accounting():
    A, B, _ = _mats()
    cache = OperatorCache(prepare_fn=_cpu_op)
    op_a, hit = cache.get_or_prepare(A)
    assert not hit and cache.misses == 1 and cache.prepares == 1
    op_a2, hit = cache.get_or_prepare(A)
    assert hit and op_a2 is op_a
    assert (cache.hits, cache.misses, cache.prepares) == (1, 1, 1)
    cache.get_or_prepare(B)
    assert (cache.hits, cache.misses, cache.prepares) == (1, 2, 2)
    assert len(cache) == 2


def test_cache_byte_budget_evicts_lru_first():
    A, B, C = _mats()
    fa, fb, fc = A.fingerprint(), B.fingerprint(), C.fingerprint()
    one = _cpu_op(A).resident_bytes()
    cache = OperatorCache(byte_budget=2 * one, prepare_fn=_cpu_op)
    cache.get_or_prepare(A)
    cache.get_or_prepare(B)
    assert cache.bytes_in_use == 2 * one and cache.evictions == 0
    # touch A so B becomes LRU, then insert C → B must be the victim
    cache.get_or_prepare(A)
    cache.get_or_prepare(C)
    assert cache.evictions == 1
    assert cache.fingerprints_lru_order() == [fa, fc]
    assert fb not in cache and cache.bytes_in_use == 2 * one


def test_cache_reprepares_evicted_matrix():
    A, B, C = _mats()
    one = _cpu_op(A).resident_bytes()
    cache = OperatorCache(byte_budget=2 * one, prepare_fn=_cpu_op)
    for M in (A, B, C):  # C's insert evicts A
        cache.get_or_prepare(M)
    assert A.fingerprint() not in cache
    _, hit = cache.get_or_prepare(A)
    assert not hit and cache.prepares == 4 and cache.evictions == 2


def test_cache_single_entry_over_budget_is_kept():
    A, _, _ = _mats()
    cache = OperatorCache(byte_budget=1, prepare_fn=_cpu_op)
    op, _ = cache.get_or_prepare(A)
    assert len(cache) == 1 and cache.evictions == 0
    _, hit = cache.get_or_prepare(A)
    assert hit


def test_shared_content_shares_one_operator():
    A = grid_laplacian_2d(6, 6)
    A_alias = type(A)(A.row_ptr, A.col_idx, A.vals, A.shape)
    cache = OperatorCache(prepare_fn=_cpu_op)
    op1, _ = cache.get_or_prepare(A)
    op2, hit = cache.get_or_prepare(A_alias)
    assert hit and op2 is op1 and cache.prepares == 1


# -- engine-level fake-clock behavior ----------------------------------------

def _x(rng, n):
    return torch.from_numpy(rng.standard_normal(n).astype(np.float32))


def test_engine_max_wait_with_fake_clock(rng):
    clock = FakeClock()
    A = grid_laplacian_2d(6, 6)
    eng = ServeEngine(
        max_batch=4, max_wait=5.0, clock=clock, device="cpu",
        prepare_fn=_cpu_op, log_interval=None,
    )
    eng.add_matrix("a", A)
    fut = eng.submit("a", _x(rng, A.n))
    assert eng.step() == 0          # partial batch, younger than max_wait
    assert not fut.done()
    clock.advance(5.0)
    assert eng.step() == 1          # aged out → dispatched
    assert fut.done()


def test_engine_latency_accounting_with_fake_clock(rng):
    clock = FakeClock()
    A = grid_laplacian_2d(6, 6)
    eng = ServeEngine(max_batch=8, clock=clock, device="cpu", prepare_fn=_cpu_op,
                      log_interval=None)
    eng.add_matrix("a", A)
    eng.submit("a", _x(rng, A.n))
    clock.advance(2.0)
    eng.submit("a", _x(rng, A.n))
    clock.advance(1.0)
    assert eng.drain() == 2
    # latencies measured on the injected clock: 3s and 1s
    assert sorted(eng.stats._latencies_s) == [1.0, 3.0]
    p = eng.stats.latency_percentiles_ms()
    assert p["p50"] == 1000.0 and p["p95"] == 3000.0


def test_engine_eviction_then_reprepare_counts():
    A, B, C = _mats()
    one = _cpu_op(A).resident_bytes()
    eng = ServeEngine(max_batch=4, cache_bytes=2 * one, device="cpu",
                      prepare_fn=_cpu_op, log_interval=None)
    for mid, M in (("a", A), ("b", B), ("c", C)):
        eng.add_matrix(mid, M)
    x = {mid: torch.ones(M.n) for mid, M in (("a", A), ("b", B), ("c", C))}
    for mid in ("a", "b", "c", "a"):  # c evicts a → a re-prepares
        eng.submit(mid, x[mid])
        eng.drain()
    assert eng.cache.prepares == 4
    assert eng.cache.evictions == 2  # a evicted by c, then b evicted by a
    assert eng.cache.hits == 0
    for mid in ("a", "a"):
        eng.submit(mid, x[mid])
        eng.drain()
    assert eng.cache.hits == 2 and eng.cache.prepares == 4


def test_engine_rejects_bad_submissions():
    A = grid_laplacian_2d(6, 6)
    eng = ServeEngine(device="cpu", prepare_fn=_cpu_op, log_interval=None)
    eng.add_matrix("a", A)
    with pytest.raises(KeyError):
        eng.submit("nope", torch.zeros(A.n))
    with pytest.raises(ValueError):
        eng.submit("a", torch.zeros(A.n + 1))
    with pytest.raises(ValueError):
        eng.submit("a", torch.zeros((A.n, 2, 2)))
    assert eng.queue_depth == 0
    # re-binding an id to different content is an error; identical is fine
    eng.add_matrix("a", A)
    A2 = type(A)(A.row_ptr, A.col_idx, A.vals + 1.0, A.shape)
    with pytest.raises(ValueError):
        eng.add_matrix("a", A2)
