"""The port's serving engine, held to the reference's contract and to the
reference engine itself.

The contract under test: **every request's result is bit-for-bit identical
to a direct ``prepare(A)(x)`` call with that request's own payload**, no
matter how requests are interleaved across matrices, how the scheduler cuts
batch boundaries, which backend (csrk / sellcs) the matrix routes to, or
which value dtype (f32 / bf16) the operator stores.  The reference's cases
(``tests/test_serve_engine.py``) run against ``repro_torch.serve`` on the
CPU, where the kernels' plain versions serve.

Across the packages, one seeded stream and one fake clock go through both
engines: each result agrees within the per-row bound
``(2·k_i + 2)·eps_f32·(|A|·|x|)_i``, and the stats snapshot and cache counters
are equal.  And the port's own rules: float64 x becomes float32, a result fed
back is served, a CUDA engine raises at construction without a card and
refuses a non-float32 x before queuing it.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  one torch thread per test process

try:  # hypothesis is a dev-only dependency (requirements-dev.txt)
    from hypothesis import given, settings, strategies as st
except Exception:  # pragma: no cover - CI installs hypothesis
    from _hypothesis_fallback import given, settings, st

from repro.configs import spmv_suite as j_suite
from repro.obs import MetricsRegistry as JRegistry
from repro.obs import using_registry as j_using_registry
from repro.serve import ServeEngine as JServeEngine

from repro_torch.configs import spmv_suite as t_suite
from repro_torch.core.spmv import prepare
from repro_torch.obs import MetricsRegistry, using_registry
from repro_torch.serve import OperatorCache, ServeEngine
from repro_torch.sparse import CSRMatrix

EPS32 = float(np.finfo(np.float32).eps)
PREPARE_OPTS = dict(device_model="tpu_v5e", device="cpu", format="auto", spmm_width=8)


def _irregular(m, n, seed):
    """Skewed row lengths so format="auto" routes to SELL-C-σ."""
    r = np.random.default_rng(seed)
    dense = np.zeros((m, n), np.float32)
    for i in range(m):
        L = 1 + (i * 7) % 13 + (12 if i % 11 == 0 else 0)
        cols = r.choice(n, size=min(L, n), replace=False)
        dense[i, cols] = r.standard_normal(len(cols)).astype(np.float32)
    return CSRMatrix.fromdense(dense)


@functools.lru_cache(maxsize=None)
def _matrices():
    """2 regular (csrk route) + 2 irregular (sellcs route) test matrices."""
    A = t_suite.grid_laplacian_2d(6, 6)
    B_reg = type(A)(A.row_ptr, A.col_idx, A.vals * 0.5 + 1.0, A.shape)
    return {
        "reg1": A,
        "reg2": B_reg,
        "irr1": _irregular(40, 40, 0),
        "irr2": _irregular(48, 48, 7),
    }


@functools.lru_cache(maxsize=None)
def _direct_ops(value_dtype):
    """Freshly prepared operators — what the engine must match."""
    return {
        mid: prepare(A, value_dtype=value_dtype, **PREPARE_OPTS)
        for mid, A in _matrices().items()
    }


def _engine(value_dtype, max_batch, **kw):
    eng = ServeEngine(
        max_batch=max_batch, value_dtype=value_dtype,
        log_interval=None, **{**PREPARE_OPTS, **kw},
    )
    for mid, A in _matrices().items():
        eng.add_matrix(mid, A)
    return eng


def _bits(t):
    return t.contiguous().view(torch.uint8) if t.dtype != torch.uint8 else t


def test_route_preconditions():
    """The fixture matrices really do exercise both registry routes."""
    ops = _direct_ops("f32")
    assert ops["reg1"].backend == "csrk" and ops["reg2"].backend == "csrk"
    assert ops["irr1"].backend == "sellcs" and ops["irr2"].backend == "sellcs"


@settings(max_examples=5, deadline=None)
@given(seed=st.integers(0, 10**6), max_batch=st.integers(1, 5),
       vd=st.integers(0, 1))
def test_random_interleavings_bit_identical(seed, max_batch, vd):
    """Arbitrary submit/step interleavings: engine == direct, bit-for-bit,
    with 20% bf16 x (the CPU engine serves it)."""
    value_dtype = ("f32", "bf16")[vd]
    rng = np.random.default_rng(seed)
    direct = _direct_ops(value_dtype)
    eng = _engine(value_dtype, max_batch)
    mids = list(_matrices())
    pending = []
    for _ in range(14):
        mid = mids[rng.integers(len(mids))]
        n = _matrices()[mid].n
        width = [1, 1, 1, 2, 3][rng.integers(5)]
        xdtype = torch.bfloat16 if rng.random() < 0.2 else torch.float32
        shape = (n,) if width == 1 else (n, width)
        x = torch.from_numpy(rng.standard_normal(shape)).to(xdtype)
        pending.append((mid, x, eng.submit(mid, x)))
        if rng.random() < 0.4:  # interleave dispatches with arrivals
            eng.step()
    eng.drain()
    assert eng.queue_depth == 0
    for mid, x, fut in pending:
        got = fut.result()
        want = direct[mid](x)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(_bits(got), _bits(want)), (
            f"{mid} {value_dtype} x{tuple(x.shape)} mb={max_batch}")


@settings(max_examples=4, deadline=None)
@given(seed=st.integers(0, 10**6), max_batch=st.integers(2, 8))
def test_burst_same_matrix_coalesced_still_bit_identical(seed, max_batch):
    """A same-matrix burst exercises every batch-boundary cut ≤ max_batch."""
    rng = np.random.default_rng(seed)
    direct = _direct_ops("f32")
    eng = _engine("f32", max_batch)
    n = _matrices()["irr1"].n
    futs = []
    for _ in range(max_batch + 3):
        x = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
        futs.append((x, eng.submit("irr1", x)))
    eng.drain()
    # the burst really was coalesced (not served one by one)
    assert eng.stats.batches_dispatched < len(futs)
    for x, fut in futs:
        assert torch.equal(fut.result(), direct["irr1"](x))


def test_prepare_amortized_across_requests(rng):
    """N requests on 4 matrices → exactly 4 prepares, N−4 cache hits."""
    eng = _engine("f32", 4)
    N = 0
    for _ in range(3):
        for mid, A in _matrices().items():
            eng.submit(mid, rng.standard_normal(A.n).astype(np.float32))
            N += 1
    eng.drain()
    assert eng.stats.requests_completed == N
    assert eng.cache.prepares == len(_matrices())
    assert eng.cache.hits + eng.cache.misses == eng.stats.batches_dispatched
    assert eng.cache.misses == len(_matrices())


def test_aliased_matrix_ids_share_one_operator(rng):
    """Two ids with identical content → one prepare (fingerprint keying)."""
    A = _matrices()["reg1"]
    # max_batch=1 forces two dispatches → the second id must hit the cache
    eng = ServeEngine(max_batch=1, log_interval=None, **PREPARE_OPTS)
    eng.add_matrix("left", A)
    eng.add_matrix("right", type(A)(A.row_ptr, A.col_idx, A.vals, A.shape))
    x = torch.from_numpy(rng.standard_normal(A.n).astype(np.float32))
    f1, f2 = eng.submit("left", x), eng.submit("right", x)
    eng.drain()
    assert eng.cache.prepares == 1 and eng.cache.hits >= 1
    assert torch.equal(f1.result(), f2.result())


# -- telemetry ---------------------------------------------------------------

def _run_small_stream(eng, rng, make_x=torch.from_numpy):
    outs = []
    for i in range(6):
        mid = ("reg1", "irr1")[i % 2]
        n = _matrices()[mid].n
        x = make_x(rng.standard_normal(n).astype(np.float32))
        outs.append(eng.submit(mid, x))
        eng.step()
    eng.drain()
    return [np.asarray(f.result()) for f in outs]


def _j_matrices():
    """The reference's copies of ``_matrices()`` (equal fingerprints)."""
    from repro.sparse import CSRMatrix as JCSR

    out = {}
    for mid, A in _matrices().items():
        out[mid] = JCSR(jnp.asarray(A.row_ptr.numpy()), jnp.asarray(A.col_idx.numpy()),
                        jnp.asarray(A.vals.numpy()), A.shape)
        assert out[mid].fingerprint() == A.fingerprint()
    return out


def test_serve_registry_record_shapes():
    rng = np.random.default_rng(0)
    with using_registry(MetricsRegistry()) as reg:
        eng = ServeEngine(max_batch=4, log_interval=0.0, **PREPARE_OPTS)
        for mid, A in _matrices().items():
            eng.add_matrix(mid, A)
        _run_small_stream(eng, rng)
        recs = reg.records()
    serve = {r["name"]: r for r in recs if r["section"] == "serve"}
    # queue-depth series points (one per logging interval)
    assert "queue_depth.0" in serve and serve["queue_depth.0"]["unit"] == "count"
    # cache counters
    assert serve["cache_miss"]["value"] == 2.0       # reg1 + irr1
    assert serve["cache_hit"]["value"] >= 1.0
    assert serve["cache_bytes"]["value"] > 0
    # dispatch + prepare timer aggregates (total ms + call count)
    assert serve["dispatch_ms"]["unit"] == "ms"
    assert serve["dispatch_calls"]["value"] == serve["batches"]["value"]
    assert serve["prepare_calls"]["value"] == 2.0
    # per-request latency series + percentile gauges + amortization
    assert "latency_ms.0" in serve and serve["latency_ms.0"]["unit"] == "ms"
    assert "latency_p50_ms" in serve and "latency_p99_ms" in serve
    assert serve["requests"]["value"] == 6.0
    assert serve["prepare_amortization"]["value"] == 3.0  # 6 requests / 2
    assert serve["cache_hit_rate"]["unit"] == "fraction"
    assert serve["throughput_rps"]["unit"] == "req/s"

    # the reference engine on the same stream emits the same names and units
    with j_using_registry(JRegistry()) as jreg:
        jeng = JServeEngine(max_batch=4, log_interval=0.0, device="tpu_v5e", format="auto",
                            interpret=True, spmm_width=8)
        for mid, A in _j_matrices().items():
            jeng.add_matrix(mid, A)
        _run_small_stream(jeng, np.random.default_rng(0), make_x=jnp.asarray)
        jrecs = jreg.records()
    names = lambda rs: {(r["name"], r["unit"]) for r in rs if r["section"] == "serve"}  # noqa: E731
    assert names(recs) == names(jrecs)


def test_serve_telemetry_off_is_bit_identical_no_op():
    """Registry off: zero records, identical bits out."""
    runs = []
    for enabled in (True, False):
        rng = np.random.default_rng(123)
        with using_registry(MetricsRegistry(enabled=enabled)) as reg:
            eng = ServeEngine(max_batch=3, log_interval=0.0, **PREPARE_OPTS)
            for mid, A in _matrices().items():
                eng.add_matrix(mid, A)
            outs = _run_small_stream(eng, rng)
            runs.append(outs)
            if not enabled:
                assert reg.records() == []
    for y_on, y_off in zip(*runs):
        np.testing.assert_array_equal(y_on, y_off)


def test_drain_empty_engine_is_noop():
    eng = ServeEngine(log_interval=None, **PREPARE_OPTS)
    assert eng.drain() == 0 and eng.step() == 0


# -- the two packages on one stream ------------------------------------------

class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_engines_of_both_packages_agree_on_one_stream():
    """One seeded stream and one fake clock through the reference engine
    (Pallas in interpret mode) and the port's (plain versions on the CPU):
    results within the per-row bound, stats snapshots and cache counters
    equal."""
    W = 4
    fleet = {"grid": (t_suite.grid_laplacian_2d(8, 8), j_suite.grid_laplacian_2d(8, 8)),
             "fem": (t_suite.fem_block(16), j_suite.fem_block(16))}
    clock = FakeClock()
    t_eng = ServeEngine(max_batch=W, max_wait=0.5, clock=clock, log_interval=None,
                        device="cpu", device_model="tpu_v5e", format="auto")
    j_eng = JServeEngine(max_batch=W, max_wait=0.5, clock=clock, log_interval=None,
                         device="tpu_v5e", format="auto", interpret=True, spmm_width=W)
    for mid, (A, Aj) in fleet.items():
        assert t_eng.add_matrix(mid, A) == j_eng.add_matrix(mid, Aj)
    rng = np.random.default_rng(11)
    sent = []
    for _ in range(24):
        mid = ("grid", "fem")[int(rng.integers(2))]
        n = fleet[mid][0].n
        width = int(rng.integers(1, 4))
        x = rng.standard_normal((n,) if width == 1 else (n, width)).astype(np.float32)
        sent.append((mid, x, t_eng.submit(mid, torch.from_numpy(x)),
                     j_eng.submit(mid, jnp.asarray(x))))
        clock.t += float(rng.exponential(0.3))
        if rng.random() < 0.5:
            assert t_eng.step() == j_eng.step()
    assert t_eng.drain() == j_eng.drain()
    assert t_eng.stats.snapshot() == j_eng.stats.snapshot()
    counts = lambda c: (c.hits, c.misses, c.prepares, c.evictions)  # noqa: E731
    assert counts(t_eng.cache) == counts(j_eng.cache)

    backends = set()
    for mid, x, t_fut, j_fut in sent:
        op, _ = t_eng.cache.get_or_prepare(fleet[mid][0])
        backends.add(op.backend)
        # CSR-k results live in the Band-k order, the same in both packages
        mat = op.csr if op.backend == "csrk" else fleet[mid][0]
        dense = mat.todense().double().numpy()
        prod = np.abs(dense) @ np.abs(x.astype(np.float64))
        k = (dense != 0).sum(axis=1).astype(np.float64)
        bound = (2 * (k[:, None] if prod.ndim == 2 else k) + 2) * EPS32 * prod
        y_t = t_fut.result().double().numpy()
        y_j = np.asarray(j_fut.result(), np.float64)
        assert y_t.shape == y_j.shape
        assert np.all(np.abs(y_t - y_j) <= bound), (mid, np.abs(y_t - y_j).max())
    assert backends == {"csrk", "sellcs"}


# -- the port's own rules -------------------------------------------------------

def test_bf16_x_served_bit_equal_to_direct_call(rng):
    eng = _engine("f32", 4)
    direct = _direct_ops("f32")
    xs = [torch.from_numpy(rng.standard_normal(36)).to(torch.bfloat16) for _ in range(3)]
    futs = [eng.submit("reg1", x) for x in xs]
    eng.drain()
    assert eng.stats.batches_dispatched == 1
    for x, fut in zip(xs, futs):
        assert fut.result().dtype == torch.bfloat16
        assert torch.equal(_bits(fut.result()), _bits(direct["reg1"](x)))


def test_float64_numpy_becomes_float32(rng):
    eng = _engine("f32", 4)
    direct = _direct_ops("f32")
    x64 = rng.standard_normal(40)
    x32 = torch.from_numpy(x64.astype(np.float32))
    f64, f32 = eng.submit("irr1", x64), eng.submit("irr1", x32)
    eng.drain()
    assert eng.stats.batches_dispatched == 1      # one dtype key: they coalesce
    assert f64.result().dtype == torch.float32
    assert torch.equal(f64.result(), direct["irr1"](x32))
    assert torch.equal(f64.result(), f32.result())


def test_fed_back_result_is_served(rng):
    """A coalesced ``[n]`` result is a strided view of the block; fed back
    into the engine and into the operator it gives the contiguous copy's bits."""
    eng = _engine("f32", 4)
    op = _direct_ops("f32")["reg2"]
    futs = [eng.submit("reg2", rng.standard_normal(36).astype(np.float32)) for _ in range(3)]
    eng.drain()
    y = futs[1].result()
    assert not y.is_contiguous()
    again = eng.submit("reg2", y)
    eng.drain()
    want = op(y.contiguous())
    assert torch.equal(again.result(), want) and torch.equal(op(y), want)


def test_cuda_engine_and_cache_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServeEngine()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServeEngine(device="cuda", device_model="tpu_v5e")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        OperatorCache()


@pytest.mark.parametrize("dtype", [torch.float16, torch.int32])
def test_cuda_engine_refuses_non_float32_x_before_queuing(monkeypatch, dtype):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    eng = ServeEngine(device="cuda", log_interval=None)
    A = _matrices()["reg1"]
    eng.add_matrix("a", A)
    with pytest.raises(TypeError, match="float32"):
        eng.submit("a", torch.ones(A.n, dtype=dtype))
    assert eng.queue_depth == 0 and eng.stats.requests_submitted == 0


def test_cuda_engine_queues_bf16_x(monkeypatch):
    """A CUDA engine takes bfloat16 x as the CUDA kernels do (and float64 as
    float32): each is queued under its own dtype's key.  The copy to the card
    is stubbed out here, so the requests stay queued on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    to = torch.Tensor.to

    def stay_on_host(self, *args, **kwargs):
        if args and isinstance(args[0], torch.device) and args[0].type == "cuda":
            return self
        return to(self, *args, **kwargs)

    monkeypatch.setattr(torch.Tensor, "to", stay_on_host)
    eng = ServeEngine(device="cuda", log_interval=None)
    A = _matrices()["reg1"]
    eng.add_matrix("a", A)
    eng.submit("a", torch.ones(A.n, dtype=torch.bfloat16))
    eng.submit("a", torch.ones((A.n, 2), dtype=torch.float64))
    assert eng.queue_depth == 2 and eng.stats.requests_submitted == 2
    assert {key[1] for key in eng.scheduler._queues} == {"torch.bfloat16", "torch.float32"}
