"""The port's SELL-C-σ route against the reference.

Host-built containers (``SELLCSMatrix``, ``SELLCSTiles``) must equal the
reference's arrays bit for bit, for f32, bf16 and int8 values.  SpMVs are
compared under the per-row rounding bound

    |y_port − y_ref| ≤ (2·k_i + 2) · eps_f32 · (|A|·|x|)_i

with k_i the row's stored entries: the two packages sum in different orders.
The same matrices, made from a seed with numpy, go through both packages;
reference containers reach the port through ``repro_torch.sparse.convert``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  one torch thread per test process

import repro.sparse as js
from repro.configs.spmv_suite import load_suite as j_load_suite
from repro.core import solvers as j_solvers
from repro.core.spmv import prepare as j_prepare
from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref

import repro_torch.sparse as ts
from repro_torch.configs.spmv_suite import load_suite as t_load_suite
from repro_torch.configs.spmv_suite import pareto_rows
from repro_torch.core import solvers as t_solvers
from repro_torch.core.spmv import prepare as t_prepare
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as t_ref
from repro_torch.kernels.spmv_sellcs import spmv_sellcs_chunks
from repro_torch.sparse.convert import (
    sell_tiles_from_numpy,
    sellcs_from_numpy,
    to_numpy,
)

EPS32 = float(np.finfo(np.float32).eps)
DTYPES = ("f32", "bf16", "int8")


def both(A):
    """(port CSR, reference CSR, dense) of one port-built matrix."""
    rp, ci, vl = (a.numpy() for a in (A.row_ptr, A.col_idx, A.vals))
    Aj = js.CSRMatrix(jnp.asarray(rp), jnp.asarray(ci), jnp.asarray(vl), A.shape)
    return A, Aj, A.todense().numpy()


@pytest.fixture(scope="module")
def bmw():
    """bmwcra_1 at 1/64 (2,304 rows): the suite matrix that routes to SELL-C-σ."""
    A, Aj = t_load_suite(64, ids=[16])["bmwcra_1"], j_load_suite(64, ids=[16])["bmwcra_1"]
    return A, Aj, np.asarray(Aj.todense())


@pytest.fixture(scope="module")
def pareto():
    """Pareto row lengths with empty rows, m = 203 (not a multiple of C)."""
    return both(pareto_rows(203, seed=5))


@pytest.fixture(scope="module")
def ops_pair(bmw):
    A, Aj, dense = bmw
    return t_prepare(A, "ampere", device="cpu"), j_prepare(Aj, device="ampere"), dense


def assert_within_bound(y, y_ref, dense, x):
    y, y_ref = np.asarray(y, np.float64), np.asarray(y_ref, np.float64)
    assert y.shape == y_ref.shape
    prod = np.abs(dense.astype(np.float64)) @ np.abs(np.asarray(x, np.float64))
    k = (dense != 0).sum(axis=1).astype(np.float64)
    bound = (2 * (k[:, None] if prod.ndim == 2 else k) + 2) * EPS32 * prod
    assert np.all(np.abs(y - y_ref) <= bound), np.abs(y - y_ref).max()


def assert_same(port, ref_arr):
    got = to_numpy(port)
    want = np.asarray(ref_arr)
    if want.dtype.name == "bfloat16":
        want = want.view(np.uint16)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def port_sell(sj):
    return sellcs_from_numpy(
        np.asarray(sj.vals), np.asarray(sj.col_idx), np.asarray(sj.slot_row),
        np.asarray(sj.chunk_ptr), np.asarray(sj.row_perm), shape=sj.shape, C=sj.C,
        sigma=sj.sigma, nnz_real=sj.nnz_real)


def port_sell_tiles(tj, sj):
    return sell_tiles_from_numpy(
        np.asarray(tj.vals), np.asarray(tj.col_idx), np.asarray(tj.row_perm),
        sj.chunk_widths(), shape=tj.shape, C=tj.C,
        val_scale=None if tj.val_scale is None else np.asarray(tj.val_scale),
        value_dtype=tj.value_dtype)


def dq_dense(tj, m, n):
    """|A| as the tile view stores it (dequantized), for the bound."""
    T, C, W = tj.vals.shape
    v = np.abs(np.asarray(j_ref._tile_vals_f32(tj.vals, tj.val_scale))).reshape(T * C, W)
    rows = np.repeat(np.asarray(tj.row_perm), W)
    keep = rows < m
    out = np.zeros((m, n))
    np.add.at(out, (rows[keep], np.asarray(tj.col_idx).reshape(-1)[keep]),
              v.reshape(-1)[keep])
    return out


# --- containers --------------------------------------------------------------


def _containers_identical(A, Aj, C, sigma):
    s, sj = ts.sellcs_from_csr(A, C=C, sigma=sigma), js.sellcs_from_csr(Aj, C=C, sigma=sigma)
    for f in ("vals", "col_idx", "slot_row", "chunk_ptr", "row_perm"):
        assert_same(getattr(s, f), getattr(sj, f))
    assert (s.shape, s.C, s.sigma, s.nnz, s.m_pad, s.num_chunks, s.slots) == \
        (sj.shape, sj.C, sj.sigma, sj.nnz, sj.m_pad, sj.num_chunks, sj.slots)
    np.testing.assert_array_equal(s.chunk_widths(), sj.chunk_widths())
    assert s.padding_overhead() == sj.padding_overhead()
    assert s.overhead_bytes() == sj.overhead_bytes()
    np.testing.assert_array_equal(s.todense().numpy(), np.asarray(sj.todense()))
    for dt in DTYPES:
        t, tj = ts.tiles_from_sellcs(s, value_dtype=dt), js.tiles_from_sellcs(sj, value_dtype=dt)
        for f in ("vals", "col_idx", "row_perm"):
            assert_same(getattr(t, f), getattr(tj, f))
        assert (t.val_scale is None) == (tj.val_scale is None)
        if t.val_scale is not None:
            assert_same(t.val_scale, tj.val_scale)
        np.testing.assert_array_equal(to_numpy(t.chunk_width), sj.chunk_widths())
        assert t.chunk_width.dtype == torch.int32
        assert (t.num_chunks, t.width, t.C, t.value_dtype) == \
            (tj.num_chunks, tj.width, tj.C, tj.value_dtype)
        assert t.padding_overhead() == tj.padding_overhead()
        assert t.modeled_bytes() == tj.modeled_bytes()
        for got, want in zip(t.col_reach(), tj.col_reach()):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("C,sigma", [(8, None), (4, 1), (16, 128)])
def test_containers_identical_on_bmwcra(bmw, C, sigma):
    A, Aj, _ = bmw
    _containers_identical(A, Aj, C, sigma)


@pytest.mark.parametrize("C,sigma", [(8, None), (8, 32), (4, 1), (16, 128)])
def test_containers_identical_on_pareto(pareto, C, sigma):
    A, Aj, _ = pareto
    assert A.m % C and int((A.row_lengths() == 0).sum()) > 0
    _containers_identical(A, Aj, C, sigma)


def test_containers_identical_on_empty_rows_and_ragged_m():
    dense = np.zeros((13, 13), np.float32)      # 13 % C != 0, 11 empty rows
    dense[3, [0, 5, 12]] = 1.0
    dense[11, 2] = -2.0
    A, Aj, _ = both(ts.CSRMatrix.fromdense(dense))
    _containers_identical(A, Aj, 8, 4)
    np.testing.assert_array_equal(ts.sellcs_from_csr(A, C=8, sigma=4).todense().numpy(), dense)


def test_bmwcra_chunk_widths_need_no_padding(bmw):
    """σ-sorting packs bmwcra_1's 48/64/80-long rows: canonical slots == nnz,
    while the [T, C, W] view stores every chunk at W = 128."""
    A, _, _ = bmw
    s = ts.sellcs_from_csr(A)
    t = ts.tiles_from_sellcs(s)
    assert s.slots == A.nnz and s.padding_overhead() == 0.0
    assert set(np.unique(s.chunk_widths())) == {48, 64, 80} and t.width == 128
    assert int((t.chunk_width.long() * t.C).sum()) == A.nnz


# --- plain versions and the wrapper -------------------------------------------


@pytest.mark.parametrize("B", [None, 3])
def test_canonical_oracle_matches(rng, pareto, B):
    A, Aj, dense = pareto
    sj = js.sellcs_from_csr(Aj, C=8, sigma=32)
    x = rng.standard_normal((A.n,) if B is None else (A.n, B)).astype(np.float32)
    y = t_ref.spmv_sellcs(port_sell(sj), torch.from_numpy(x)).numpy()
    assert_within_bound(y, np.asarray(j_ref.spmv_sellcs(sj, jnp.asarray(x))), dense, x)
    assert_within_bound(y, dense @ x, dense, x)


@pytest.mark.parametrize("value_dtype", DTYPES)
@pytest.mark.parametrize("B", [None, 4])
def test_tile_oracle_and_cpu_wrapper_match(rng, bmw, value_dtype, B):
    A, Aj, _ = bmw
    sj = js.sellcs_from_csr(Aj)
    tj = js.tiles_from_sellcs(sj, value_dtype=value_dtype)
    t = port_sell_tiles(tj, sj)
    x = rng.standard_normal((A.n,) if B is None else (A.n, B)).astype(np.float32)
    absA = dq_dense(tj, A.m, A.n)
    want = np.asarray(j_ref.spmv_sellcs_tiles(tj, jnp.asarray(x)))
    plain = t_ref.spmv_sellcs_tiles(t, torch.from_numpy(x))
    assert_within_bound(plain.numpy(), want, absA, x)
    before = spmv_sellcs_chunks.launches
    got = t_ops.spmv_sellcs(t, torch.from_numpy(x))
    assert spmv_sellcs_chunks.launches == before        # CPU: the plain version
    assert torch.equal(got, plain)


@pytest.mark.parametrize("value_dtype", DTYPES)
def test_cpu_wrapper_matches_interpret_mode_kernel(rng, pareto, value_dtype):
    """ops.spmv_sellcs on the CPU against the reference's Pallas kernel,
    run in interpret mode as the reference's own tests run it."""
    A, Aj, _ = pareto
    sj = js.sellcs_from_csr(Aj, C=8, sigma=16)
    tj = js.tiles_from_sellcs(sj, value_dtype=value_dtype)
    x = rng.standard_normal((A.n, 2)).astype(np.float32)
    absA = dq_dense(tj, A.m, A.n)
    for xb in (x, x[:, 0].copy()):
        want = np.asarray(j_ops.spmv_sellcs(tj, jnp.asarray(xb), interpret=True))
        got = t_ops.spmv_sellcs(port_sell_tiles(tj, sj), torch.from_numpy(xb)).numpy()
        assert_within_bound(got, want, absA, xb)


# --- prepare ------------------------------------------------------------------


@pytest.mark.parametrize("value_dtype", ["f32", "bf16", "int8", "auto"])
def test_prepare_routes_and_decides_as_the_reference(bmw, value_dtype):
    A, Aj, _ = bmw
    op = t_prepare(A, "ampere", device="cpu", value_dtype=value_dtype)
    opj = j_prepare(Aj, device="ampere", value_dtype=value_dtype)
    assert op.backend == opj.backend == "sellcs"
    assert op.value_dtype == opj.value_dtype
    assert dataclasses.asdict(op.params) == dataclasses.asdict(opj.params)
    np.testing.assert_array_equal(op.perm, np.arange(A.m))
    assert op.stats.as_dict() == opj.stats.as_dict()
    assert op.fingerprint == opj.fingerprint
    assert op.modeled_bytes() == opj.modeled_bytes()
    assert op.padding_overhead() == opj.padding_overhead()
    assert op.overhead_fraction() == opj.overhead_fraction()
    # the port adds chunk_width ([T] int32) and keeps its perm arrays in int64
    extra = 4 * op.sell_tiles.num_chunks + 2 * 4 * A.m
    assert op.resident_bytes() == opj.resident_bytes() + extra
    np.testing.assert_array_equal(to_numpy(op.sell_tiles.chunk_width),
                                  opj.sell.chunk_widths())
    with pytest.raises(AttributeError):
        op.csr


def test_prepare_knobs_reach_the_container(bmw):
    A, Aj, _ = bmw
    op = t_prepare(A, "ampere", device="cpu", format="sellcs", sell_c=4, sell_sigma=1)
    opj = j_prepare(Aj, device="ampere", format="sellcs", sell_c=4, sell_sigma=1)
    assert (op.sell.C, op.sell.sigma, op.params.srs) == (4, 1, 4)
    assert op.modeled_bytes() == opj.modeled_bytes()
    assert_same(op.sell.row_perm, opj.sell.row_perm)


@pytest.mark.parametrize("B", [None, 4])
def test_call_apply_original_and_matmat(rng, ops_pair, B):
    op, opj, dense = ops_pair
    x = rng.standard_normal((dense.shape[1],) if B is None else (dense.shape[1], B))
    x = x.astype(np.float32)
    y = op(torch.from_numpy(x)).numpy()
    assert_within_bound(y, np.asarray(opj(jnp.asarray(x))), dense, x)
    assert_within_bound(op.apply_original(torch.from_numpy(x)).numpy(),
                        np.asarray(opj.apply_original(jnp.asarray(x))), dense, x)
    assert_within_bound(y, dense @ x, dense, x)
    if B is not None:
        assert torch.equal(op.matmat(torch.from_numpy(x)), op(torch.from_numpy(x)))


def test_spmm_width_keeps_columns_independent(rng, bmw):
    A, Aj, dense = bmw
    op = t_prepare(A, "ampere", device="cpu", spmm_width=4)
    opj = j_prepare(Aj, device="ampere", spmm_width=4)
    assert op.backend == "sellcs"
    X = rng.standard_normal((A.n, 6)).astype(np.float32)
    Y = op(torch.from_numpy(X))
    assert Y.shape == (A.m, 6)
    assert_within_bound(Y.numpy(), np.asarray(opj(jnp.asarray(X))), dense, X)
    for j in range(6):
        assert torch.equal(Y[:, j], op(torch.from_numpy(X[:, j].copy())))
        assert torch.equal(Y[:, j], op(torch.from_numpy(X[:, [j, 0]].copy()))[:, 0])


def test_jacobi_and_power_iteration_match(rng, ops_pair):
    op, opj, dense = ops_pair
    n = dense.shape[0]
    diag = np.diag(dense).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    # the reference side runs its SELL-C-σ oracle (interpret-mode Pallas per
    # sweep would take most of this file's time)
    j_mv = lambda v: j_ref.spmv_sellcs(opj.sell, v)  # noqa: E731
    got = t_solvers.jacobi_smoother(op, torch.from_numpy(diag), torch.from_numpy(b), iters=40)
    want = j_solvers.jacobi_smoother(j_mv, jnp.asarray(diag), jnp.asarray(b), iters=40)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    res = np.linalg.norm(b - dense.astype(np.float64) @ got.numpy()) / np.linalg.norm(b)
    assert res <= 1e-5
    # the same start vector for both: the two packages draw different random bits
    v0 = np.array(jax.random.normal(jax.random.PRNGKey(0), (n,)))
    lam = t_solvers.power_iteration(op, n, iters=30, v0=torch.from_numpy(v0), device="cpu")
    lam_j = j_solvers.power_iteration(j_mv, n, iters=30, seed=0)
    assert float(lam) == pytest.approx(float(lam_j), rel=1e-4)
