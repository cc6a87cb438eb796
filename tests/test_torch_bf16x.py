"""bf16 x through the port's routes against the reference, on the CPU.

The reference's Pallas kernels read x in its own dtype, sum in f32 and store
y in x's dtype; the port's CUDA kernels do the same, and on the CPU its
plain versions multiply and sum in bf16.  So a bf16 x gives a bf16 y in both
packages, and rows are compared under

    |y_port − y_ref| ≤ (k_i + 2) · 2⁻⁷ · (|A|·|x|)_i

with k_i the row's stored entries, 2⁻⁷ bf16's machine epsilon and |A| the
dequantised values the operator holds.  x is made from a seed with numpy and
rounded to bf16; both packages get the same bf16 values.  Run with ``-s`` to
print each case's worst ratio |Δ| / (2⁻⁷ · (|A|·|x|)_i).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  one torch thread per test process

import repro.sparse as js
from repro.configs import spmv_suite as j_suite
from repro.core.spmv import prepare as j_prepare
from repro.kernels import ops as j_ops
from repro.serve import ServeEngine as JServeEngine

import repro_torch.sparse as ts
from repro_torch.configs import spmv_suite as t_suite
from repro_torch.core import distributed as t_dist
from repro_torch.core.spmv import prepare as t_prepare
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as t_ref
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.serve import ServeEngine

EPS_BF16 = 2.0 ** -7
EPS32 = float(np.finfo(np.float32).eps)

#: route -> the matrix of both packages it is held on
MATRICES = {
    "csrk": lambda s: s.load_suite(scale=64, ids=[8])["ecology1"],
    "sellcs": lambda s: s.load_suite(scale=64, ids=[16])["bmwcra_1"],
    "segsum": lambda s: s.powerlaw_zipf(2048),
    "diahybrid": lambda s: s.stencil_fringe(64),
}
CASES = [(route, dt) for route in MATRICES for dt in ("f32", "bf16", "int8")
         if not (route == "diahybrid" and dt == "int8")]

_OPS = {}


def _ops(route, value_dtype):
    """(port operator, reference operator, port CSR) of one route, cached."""
    key = (route, value_dtype)
    if key not in _OPS:
        A, Aj = MATRICES[route](t_suite), MATRICES[route](j_suite)
        op = t_prepare(A, "ampere", device="cpu", value_dtype=value_dtype)
        opj = j_prepare(Aj, device="ampere", value_dtype=value_dtype)
        assert op.backend == opj.backend == route
        _OPS[key] = (op, opj, A)
    return _OPS[key]


def abs_operator(op):
    """The same operator over |values| (int8: |codes|, scales kept): its
    products with a float64 |x| are (|A|·|x|) of the dequantised values,
    summed in float64 by the plain versions."""
    if op.backend == "csrk":
        tb = op.tile_buckets
        return dataclasses.replace(op, tile_buckets=dataclasses.replace(
            tb, buckets=tuple(dataclasses.replace(b, vals=b.vals.abs()) for b in tb.buckets),
            rem_val=tb.rem_val.abs()))
    if op.backend == "sellcs":
        st = op.sell_tiles
        return dataclasses.replace(op, sell_tiles=dataclasses.replace(st, vals=st.vals.abs()))
    if op.backend == "segsum":
        return dataclasses.replace(op, segsum=dataclasses.replace(
            op.segsum, vals=op.segsum.vals.abs()))
    d = op.dia
    return dataclasses.replace(op, dia=dataclasses.replace(
        d, diag_vals=d.diag_vals.abs(),
        remainder=dataclasses.replace(d.remainder, vals=d.remainder.vals.abs())))


def bf16_x(n, B, seed):
    """x made with numpy, rounded to bf16: (port tensor, reference array, float64)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n,) if B == 1 else (n, B)).astype(np.float32)
    x16 = torch.from_numpy(x).to(torch.bfloat16)
    xj = jnp.asarray(x16.float().numpy()).astype(jnp.bfloat16)
    return x16, xj, x16.double()


def worst_ratio(y, y_ref, abs_prod, row_nnz, what):
    """Hold y to y_ref within (k_i + 2)·2⁻⁷·(|A|·|x|)_i; returns the worst
    |Δ| / (2⁻⁷ (|A|·|x|)_i) over the rows where (|A|·|x|)_i > 0."""
    y = np.asarray(y, np.float64)
    y_ref = np.asarray(y_ref, np.float64)
    prod = np.asarray(abs_prod, np.float64)
    k = np.asarray(row_nnz, np.float64)
    if prod.ndim == 2:
        k = k[:, None]
    err = np.abs(y - y_ref)
    assert y.shape == y_ref.shape and np.isfinite(y).all()
    assert (err <= (k + 2) * EPS_BF16 * prod).all(), (what, float(err.max()))
    live = prod > 0
    ratio = float((err[live] / (EPS_BF16 * prod[live])).max()) if live.any() else 0.0
    print(f"{what}: worst ratio {ratio:.3f}")
    return ratio


@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("route,value_dtype", CASES)
def test_apply_original_bf16_x_matches_reference(route, value_dtype, B):
    op, opj, A = _ops(route, value_dtype)
    x16, xj, x64 = bf16_x(A.n, B, seed=27)
    y = op.apply_original(x16)
    yj = opj.apply_original(xj)
    assert y.dtype == torch.bfloat16 and yj.dtype == jnp.bfloat16
    prod = abs_operator(op).apply_original(x64.abs())
    assert prod.dtype == torch.float64
    worst_ratio(y.double().numpy(), np.asarray(yj.astype(jnp.float32)), prod.numpy(),
                A.row_lengths().numpy(), f"{route} {value_dtype} B={B}")


@pytest.mark.parametrize("value_dtype", ["f32", "bf16"])
def test_ell_bf16_x_matches_reference(value_dtype):
    """ELL (vector x only) on bmwcra_1/64 at f32 and bf16 values."""
    A, Aj = (MATRICES["sellcs"](s) for s in (t_suite, j_suite))
    if value_dtype == "bf16":
        A = ts.CSRMatrix(A.row_ptr, A.col_idx, A.vals.to(torch.bfloat16), A.shape)
        Aj = js.CSRMatrix(Aj.row_ptr, Aj.col_idx, Aj.vals.astype(jnp.bfloat16), Aj.shape)
    e, ej = ts.ell_from_csr(A), js.ell_from_csr(Aj)
    assert e.vals.dtype == (torch.bfloat16 if value_dtype == "bf16" else torch.float32)
    x16, xj, x64 = bf16_x(A.n, 1, seed=28)
    y = t_ops.spmv_ell(e, x16)
    yj = j_ops.spmv_ell(ej, xj, interpret=True)
    assert y.dtype == torch.bfloat16 and yj.dtype == jnp.bfloat16
    prod = t_ref.ell_rows(e.col_idx, e.vals.abs(), x64.abs())
    worst_ratio(y.double().numpy(), np.asarray(yj.astype(jnp.float32)), prod.numpy(),
                (e.vals != 0).sum(dim=1).numpy(), f"ell {value_dtype} B=1")


@pytest.mark.parametrize("strategy", ["auto", "replicated", "allgather", "halo"])
@pytest.mark.parametrize("route", ["csrk", "sellcs"])
def test_sharded_bf16_x_bit_equal_to_single_device(route, strategy):
    """D = 2 shards on the CPU: a bf16 y with the single-device operator's bits."""
    _, _, A = _ops(route, "f32")
    base = t_prepare(A, "ampere", device="cpu", format=route, tile_layout="monolithic")
    src = base.csrk.csr if route == "csrk" else A
    sharded = t_dist.shard_prepared(base, make_host_mesh(2, device="cpu"), x_strategy=strategy,
                                    A=src)
    for B in (1, 4):
        x16, _, _ = bf16_x(A.n, B, seed=29)
        y = sharded(x16)
        assert y.dtype == torch.bfloat16
        assert torch.equal(y, base(x16))
        assert torch.equal(sharded.apply_original(x16), base.apply_original(x16))


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_mixed_dtype_stream_matches_reference_engine():
    """One seeded stream, a fifth of it bf16 x (the reference's share), through
    the reference's engine (Pallas in interpret mode) and the port's CPU
    engine: each result in its x's dtype, f32 rows within (2 k_i + 2)·eps32,
    bf16 rows within (k_i + 2)·2⁻⁷ of (|A|·|x|)_i."""
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
    rng = np.random.default_rng(27)
    sent = []
    for _ in range(30):
        mid = ("grid", "fem")[int(rng.integers(2))]
        width = int(rng.integers(1, 4))
        x = rng.standard_normal((fleet[mid][0].n,) if width == 1 else
                                (fleet[mid][0].n, width)).astype(np.float32)
        if rng.random() < 0.2:
            xt = torch.from_numpy(x).to(torch.bfloat16)
            xj = jnp.asarray(xt.float().numpy()).astype(jnp.bfloat16)
            x = xt.double().numpy()
        else:
            xt, xj = torch.from_numpy(x), jnp.asarray(x)
        sent.append((mid, x, xt.dtype, t_eng.submit(mid, xt), j_eng.submit(mid, xj)))
        clock.t += float(rng.exponential(0.3))
        if rng.random() < 0.5:
            assert t_eng.step() == j_eng.step()
    assert t_eng.drain() == j_eng.drain()
    assert t_eng.stats.snapshot() == j_eng.stats.snapshot()
    assert 0 < sum(dt == torch.bfloat16 for _, _, dt, _, _ in sent) < len(sent)
    for mid, x, dtype, t_fut, j_fut in sent:
        op, _ = t_eng.cache.get_or_prepare(fleet[mid][0])
        # CSR-k results live in the Band-k order, the same in both packages
        mat = op.csr if op.backend == "csrk" else fleet[mid][0]
        dense = mat.todense().double().numpy()
        prod = np.abs(dense) @ np.abs(x.astype(np.float64))
        k = (dense != 0).sum(axis=1).astype(np.float64)
        if prod.ndim == 2:
            k = k[:, None]
        y_t, y_j = t_fut.result(), j_fut.result()
        assert y_t.dtype == dtype and str(y_j.dtype) == str(dtype).split(".")[-1]
        err = np.abs(y_t.double().numpy() - np.asarray(y_j.astype(jnp.float32), np.float64))
        tol = (k + 2) * EPS_BF16 if dtype == torch.bfloat16 else (2 * k + 2) * EPS32
        assert np.all(err <= tol * prod), (mid, dtype, float(err.max()))
