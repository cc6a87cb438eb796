"""The port's baseline formats, their oracles and the one-shot entry points
against the reference.

Host-built containers (``ELLMatrix``, ``BCSRMatrix``, ``CSR5LikeMatrix``)
must equal the reference's arrays bit for bit, with the reference's quirks
(rows cut at an explicit ``kmax``, explicit zeros counted as padding, blocks
that sum to zero dropped, a one-entry ``nonempty_rows`` for an empty
matrix).  The port builds the ELL slab and the BCSR blocks vectorised, the
reference with a row loop and a dense copy, so these tests are what holds
the two builds equal.

Products are compared under the per-row rounding bound

    |y_port − y_ref| ≤ (2·k_i + 2) · eps_f32 · (|A|·|x|)_i

with k_i the row's stored entries: the two packages sum in different
orders.  The same matrices, made from a seed with numpy, go through both
packages; reference containers reach the port through
``repro_torch.sparse.convert``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  one torch thread per test process

import repro.sparse as js
from repro.configs.spmv_suite import load_suite as j_load_suite
from repro.core import solvers as j_solvers
from repro.core.spmv import prepare as j_prepare
from repro.core.spmv import spmm as j_spmm
from repro.core.spmv import spmv as j_spmv
from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref

import repro_torch.sparse as ts
from repro_torch.configs.spmv_suite import ell_width_matrix, pareto_rows, stencil_fringe
from repro_torch.configs.spmv_suite import load_suite as t_load_suite
from repro_torch.core import solvers as t_solvers
from repro_torch.core import spmm as t_spmm
from repro_torch.core import spmv as t_spmv
from repro_torch.core.spmv import prepare as t_prepare
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as t_ref
from repro_torch.kernels.spmv_ell import spmv_ell_rows
from repro_torch.sparse._tree import tensor_leaves
from repro_torch.sparse.convert import (
    bcsr_from_numpy,
    csr5_from_numpy,
    csr_from_numpy,
    ell_from_numpy,
    to_numpy,
)

EPS32 = float(np.finfo(np.float32).eps)


def pair(rp, ci, vl, shape):
    """(port CSR, reference CSR) of the same raw arrays (duplicates and
    explicit zeros kept as given)."""
    rp, ci = np.asarray(rp, np.int32), np.asarray(ci, np.int32)
    vl = np.asarray(vl, np.float32)
    return (csr_from_numpy(rp, ci, vl, shape),
            js.CSRMatrix(jnp.asarray(rp), jnp.asarray(ci), jnp.asarray(vl), shape))


def both(A):
    """(port CSR, reference CSR) of one port-built matrix."""
    return pair(A.row_ptr.numpy(), A.col_idx.numpy(), A.vals.numpy(), A.shape)


def random_dense(m, n, density, seed):
    rng = np.random.default_rng(seed)
    return ((rng.random((m, n)) < density) * rng.standard_normal((m, n))).astype(np.float32)


def raw_case():
    """31×23 with empty rows, explicit zeros and duplicate columns in a row
    (sorted columns drawn with replacement), as raw CSR arrays."""
    rng = np.random.default_rng(11)
    m, n = 31, 23
    lengths = rng.integers(0, 9, size=m)
    lengths[[0, 7, 30]] = 0
    rp = np.concatenate([[0], np.cumsum(lengths)])
    ci = np.concatenate([np.sort(rng.integers(0, n, size=L)) for L in lengths])
    vl = rng.standard_normal(ci.shape[0]).astype(np.float32)
    vl[rng.random(ci.shape[0]) < 0.2] = 0.0
    return pair(rp, ci, vl, (m, n))


def cancelling_case():
    """10×10: real entries in block (0, 0), an explicit zero at (0, 9) and a
    pair 1.5, −1.5 at (9, 9) that sums to zero: with 8×8 blocks both right
    hand blocks hold only zeros and are dropped."""
    rp = [0, 3, 4, 4, 5, 5, 5, 5, 6, 6, 8]
    ci = [0, 3, 9, 1, 7, 2, 9, 9]
    vl = [1.0, 2.0, 0.0, -3.0, 4.0, 5.0, 1.5, -1.5]
    return pair(rp, ci, vl, (10, 10))


def empty_case():
    """9×7 with no entries."""
    return pair(np.zeros(10), [], [], (9, 7))


CASES = {
    "random 37x29": lambda: both(ts.CSRMatrix.fromdense(random_dense(37, 29, 0.2, 1))),
    "raw (zeros, duplicates, empty rows)": raw_case,
    "cancelling": cancelling_case,
    "all empty": empty_case,
    "pareto(203)": lambda: both(pareto_rows(203, seed=5)),
    "stencil_fringe(64)": lambda: both(stencil_fringe(64)),
    "ell_width(103x90, kmax 33)": lambda: both(ell_width_matrix(103, 90, 33, seed=4)),
}


@pytest.fixture(scope="module")
def bmw():
    """bmwcra_1 at 1/64 (2,304 rows, rows of 48/64/80): the suite matrix the
    SELL-C-σ route takes, and the ELL path's cell cut to test size."""
    A, Aj = t_load_suite(64, ids=[16])["bmwcra_1"], j_load_suite(64, ids=[16])["bmwcra_1"]
    return A, Aj, np.asarray(Aj.todense())


def assert_same(port, ref_arr):
    got = to_numpy(port)
    want = np.asarray(ref_arr)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def assert_within_bound(y, y_ref, dense, x):
    y, y_ref = np.asarray(y, np.float64), np.asarray(y_ref, np.float64)
    assert y.shape == y_ref.shape
    prod = np.abs(dense.astype(np.float64)) @ np.abs(np.asarray(x, np.float64))
    k = (dense != 0).sum(axis=1).astype(np.float64)
    bound = (2 * (k[:, None] if prod.ndim == 2 else k) + 2) * EPS32 * prod
    assert np.all(np.abs(y - y_ref) <= bound), np.abs(y - y_ref).max()


def assert_within_csr_bound(y, y_ref, A, x):
    """The per-row bound over a CSR's stored entries (duplicates and explicit
    zeros each count as an entry)."""
    y, y_ref = np.asarray(y, np.float64), np.asarray(y_ref, np.float64)
    absA = ts.CSRMatrix(A.row_ptr, A.col_idx, A.vals.double().abs(), A.shape)
    xa = torch.from_numpy(np.abs(np.asarray(x, np.float64)))
    prod = (t_ref.spmm_csr(absA, xa) if xa.ndim == 2 else t_ref.spmv_csr(absA, xa)).numpy()
    k = A.row_lengths().numpy().astype(np.float64)
    bound = (2 * (k[:, None] if prod.ndim == 2 else k) + 2) * EPS32 * prod
    assert y.shape == y_ref.shape == prod.shape
    assert np.all(np.abs(y - y_ref) <= bound), np.abs(y - y_ref).max()


def assert_within_slab_bound(y, y_ref, ell, x):
    """The per-row bound over the slab's own slots (a cut slab, padding)."""
    y, y_ref = np.asarray(y, np.float64), np.asarray(y_ref, np.float64)
    vals = np.abs(ell.vals.numpy().astype(np.float64))
    prod = (vals * np.abs(np.asarray(x, np.float64))[ell.col_idx.numpy()]).sum(axis=1)
    k = (vals != 0).sum(axis=1)
    assert y.shape == y_ref.shape == prod.shape
    assert np.all(np.abs(y - y_ref) <= (2 * k + 2) * EPS32 * prod), np.abs(y - y_ref).max()


# --- containers ----------------------------------------------------------------


def _ell_identical(A, Aj, kmax):
    e, ej = ts.ell_from_csr(A, kmax), js.ell_from_csr(Aj, kmax)
    assert_same(e.col_idx, ej.col_idx)
    assert_same(e.vals, ej.vals)
    assert e.shape == ej.shape and e.kmax == ej.kmax
    assert e.padding_overhead() == ej.padding_overhead()
    np.testing.assert_array_equal(e.todense().numpy(), np.asarray(ej.todense()))
    p = ell_from_numpy(np.asarray(ej.col_idx), np.asarray(ej.vals), shape=ej.shape)
    assert torch.equal(p.col_idx, e.col_idx) and torch.equal(p.vals, e.vals)
    return e, ej


@pytest.mark.parametrize("kmax", [None, 0, 3, 1, 200])
@pytest.mark.parametrize("case", sorted(CASES))
def test_ell_containers_identical(case, kmax):
    """The vectorised slab equals the reference's row loop, a cut included."""
    A, Aj = CASES[case]()
    e, _ = _ell_identical(A, Aj, kmax)
    longest = int(A.row_lengths().max()) if A.m and A.nnz else 0
    assert e.kmax == (kmax or max(longest, 1))
    assert e.col_idx.dtype == torch.int32 and e.vals.dtype == torch.float32
    if case == "all empty":
        assert e.kmax == (kmax or 1) and not bool(e.vals.any()) and e.padding_overhead() == 9 * e.kmax


def test_ell_on_bmwcra_and_the_explicit_zero_quirk(bmw):
    A, Aj, _ = bmw
    e, _ = _ell_identical(A, Aj, None)
    assert e.kmax == 80 and e.vals.shape == (A.m, 80)
    # explicit zeros count as padding (``count_nonzero``), in both packages
    Az, Azj = raw_case()
    ez = ts.ell_from_csr(Az)
    real = int(torch.count_nonzero(Az.vals))
    assert real < Az.nnz
    assert ez.padding_overhead() == (ez.vals.numel() - real) / real
    assert ez.padding_overhead() == js.ell_from_csr(Azj).padding_overhead()


@pytest.mark.parametrize("block", [(8, 8), (4, 2)])
@pytest.mark.parametrize("case", sorted(CASES))
def test_bcsr_containers_identical(case, block):
    A, Aj = CASES[case]()
    b, bj = ts.bcsr_from_csr(A, *block), js.bcsr_from_csr(Aj, *block)
    for f in ("block_row_ptr", "block_col_idx", "blocks"):
        assert_same(getattr(b, f), getattr(bj, f))
    assert b.shape == bj.shape and b.block_shape == bj.block_shape == block
    assert b.shape == (-(-A.m // block[0]) * block[0], -(-A.n // block[1]) * block[1])
    np.testing.assert_array_equal(b.todense().numpy(), np.asarray(bj.todense()))
    p = bcsr_from_numpy(np.asarray(bj.block_row_ptr), np.asarray(bj.block_col_idx),
                        np.asarray(bj.blocks), shape=bj.shape)
    for f in ("block_row_ptr", "block_col_idx", "blocks"):
        assert torch.equal(getattr(p, f), getattr(b, f))
    if case == "cancelling" and block == (8, 8):
        # the explicit zero's block and the cancelled pair's block are dropped
        assert b.block_col_idx.tolist() == [0] and b.block_row_ptr.tolist() == [0, 1, 1]


@pytest.mark.parametrize("tile", [(16, 4), (2, 3)])
@pytest.mark.parametrize("case", sorted(CASES))
def test_csr5_containers_identical(case, tile):
    A, Aj = CASES[case]()
    c, cj = ts.csr5_from_csr(A, *tile), js.csr5_from_csr(Aj, *tile)
    for f in ("vals", "col_idx", "row_flag", "tile_ptr", "nonempty_rows"):
        assert_same(getattr(c, f), getattr(cj, f))
    assert (c.shape, c.sigma, c.omega, c.nnz_real, c.tile_size) == (
        cj.shape, cj.sigma, cj.omega, cj.nnz_real, cj.tile_size)
    assert c.overhead_bytes() == cj.overhead_bytes()
    assert c.overhead_fraction() == cj.overhead_fraction()
    p = csr5_from_numpy(*(np.asarray(getattr(cj, f)) for f in (
        "vals", "col_idx", "row_flag", "tile_ptr", "nonempty_rows")),
        shape=cj.shape, sigma=cj.sigma, omega=cj.omega, nnz_real=cj.nnz_real)
    for f in ("vals", "col_idx", "row_flag", "tile_ptr", "nonempty_rows"):
        assert torch.equal(getattr(p, f), getattr(c, f))
    if case == "all empty":
        assert c.nonempty_rows.tolist() == [0] and c.vals.shape == (tile[0] * tile[1],)


def test_containers_move_between_devices():
    A, _ = raw_case()
    for c in (ts.ell_from_csr(A), ts.bcsr_from_csr(A), ts.csr5_from_csr(A)):
        moved = c.to("cpu")
        assert type(moved) is type(c)
        leaves = list(tensor_leaves(c))
        assert len(leaves) >= 2
        assert all(torch.equal(a, b) for a, b in zip(tensor_leaves(moved), leaves))


# --- the ELL kernel's wrapper and plain version --------------------------------


@pytest.mark.parametrize("kmax", [None, 2])
@pytest.mark.parametrize("case", ["random 37x29", "pareto(203)", "stencil_fringe(64)"])
def test_cpu_spmv_ell_matches_interpret_mode_kernel(rng, case, kmax):
    """ops.spmv_ell on the CPU against the reference's Pallas kernel, run in
    interpret mode as the reference's own tests run it, at row_tile 16 and
    at its default; the cut slab (kmax 2) is compared as it stands."""
    A, Aj = CASES[case]()
    ej = js.ell_from_csr(Aj, kmax)
    e = ell_from_numpy(np.asarray(ej.col_idx), np.asarray(ej.vals), shape=ej.shape)
    x = rng.standard_normal(A.n).astype(np.float32)
    before = spmv_ell_rows.launches
    got = t_ops.spmv_ell(e, torch.from_numpy(x))
    assert spmv_ell_rows.launches == before          # CPU: the plain version
    assert got.shape == (A.m,) and got.dtype == torch.float32
    for tile in ({"row_tile": 16}, {}):
        want = np.asarray(j_ops.spmv_ell(ej, jnp.asarray(x), interpret=True, **tile))
        assert_within_slab_bound(got.numpy(), want, e, x)
    assert torch.equal(got, t_ref.ell_rows(e.col_idx, e.vals, torch.from_numpy(x)))


@pytest.mark.parametrize("bad", [np.inf, -np.inf, np.nan])
def test_non_finite_x_reaches_the_rows_it_reaches_in_the_reference(bad):
    """Padding slots are multiplied by x[0] as in the reference's kernel, so
    inf or NaN at x[0] reaches every row that holds padding."""
    A, Aj = CASES["pareto(203)"]()
    ej = js.ell_from_csr(Aj)
    e = ts.ell_from_csr(A)
    x = np.ones(A.n, np.float32)
    x[0] = bad
    x[57] = -bad if not np.isnan(bad) else 1.0
    want = np.asarray(j_ops.spmv_ell(ej, jnp.asarray(x), row_tile=16, interpret=True))
    got = t_ops.spmv_ell(e, torch.from_numpy(x)).numpy()
    for test in (np.isnan, np.isposinf, np.isneginf):
        np.testing.assert_array_equal(test(got), test(want))
    assert np.isnan(want).sum() > (A.row_lengths() > 0).sum().item() // 2
    np.testing.assert_array_equal(np.isnan(got),
                                  np.isnan(np.asarray(j_ref.spmv_ell(ej, jnp.asarray(x)))))


def test_wrapper_takes_vectors_only_and_fills_out():
    A, _ = raw_case()
    e = ts.ell_from_csr(A)
    x = torch.arange(A.n, dtype=torch.float32) / 5
    with pytest.raises(ValueError):
        t_ops.spmv_ell(e, torch.ones((A.n, 2)))        # no batched ELL body
    with pytest.raises(ValueError):
        t_ops.spmv_ell(e, torch.ones(A.n + 1))
    out = torch.full((A.m,), float("nan"))
    y = spmv_ell_rows(e.col_idx, e.vals, x, m=A.m, n=A.n, out=out)
    assert y is out and torch.equal(y, t_ops.spmv_ell(e, x))
    dense = A.todense().numpy()
    assert_within_bound(y.numpy(), dense @ x.numpy(), dense, x.numpy())
    empty = ts.ell_from_csr(ts.CSRMatrix.fromdense(np.zeros((0, 4), np.float32)))
    assert t_ops.spmv_ell(empty, torch.ones(4)).shape == (0,)


# --- oracles -------------------------------------------------------------------


@pytest.mark.parametrize("case", ["random 37x29", "pareto(203)", "cancelling", "all empty"])
def test_baseline_oracles_match(rng, case):
    A, Aj = CASES[case]()
    dense = np.array(Aj.todense())
    x = rng.standard_normal(A.n).astype(np.float32)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    e, ej = ts.ell_from_csr(A), js.ell_from_csr(Aj)
    assert_within_bound(t_ref.spmv_ell(e, xt).numpy(), np.asarray(j_ref.spmv_ell(ej, xj)),
                        dense, x)
    assert_within_bound(t_ref.ell_rows(e.col_idx, e.vals, xt).numpy(), dense @ x, dense, x)
    for block in ((8, 8), (4, 2)):
        b, bj = ts.bcsr_from_csr(A, *block), js.bcsr_from_csr(Aj, *block)
        xp = np.zeros(b.shape[1], np.float32)
        xp[: A.n] = x
        want = np.asarray(j_ref.spmv_bcsr(bj, jnp.asarray(xp)))
        got = t_ref.spmv_bcsr(b, torch.from_numpy(xp)).numpy()
        assert got.shape == want.shape == (b.shape[0],)
        dp = np.zeros(b.shape, np.float32)
        dp[: A.m, : A.n] = dense
        assert_within_bound(got, want, dp, xp)
    c, cj = ts.csr5_from_csr(A), js.csr5_from_csr(Aj)
    assert_within_bound(t_ref.spmv_csr5_like(c, xt).numpy(),
                        np.asarray(j_ref.spmv_csr5_like(cj, xj)), dense, x)
    assert_within_bound(t_ref.spmv_coo(A.tocoo(), xt).numpy(),
                        np.asarray(j_ref.spmv_coo(Aj.tocoo(), xj)), dense, x)
    assert_within_bound(t_ref.spmv_dense(torch.from_numpy(dense), xt).numpy(),
                        np.asarray(j_ref.spmv_dense(jnp.asarray(dense), xj)), dense, x)


@pytest.mark.parametrize("srs,ssrs", [(4, 2), (3, 5), (1, 1)])
def test_listing1_loop_oracle_matches(rng, srs, ssrs):
    """The paper's Listing 1 loop nest over the port's CSR-k hierarchy."""
    dense = random_dense(40, 40, 0.2, 3)
    A, Aj = both(ts.CSRMatrix.fromdense(dense))
    x = rng.standard_normal(40).astype(np.float32)
    k3 = ts.build_csrk(A, srs=srs, ssrs=ssrs, k=3)
    want = np.asarray(j_ref.spmv_csrk_loops(js.build_csrk(Aj, srs=srs, ssrs=ssrs, k=3),
                                            jnp.asarray(x)))
    got = t_ref.spmv_csrk_loops(k3, torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (40,)
    assert_within_bound(got.numpy(), want, dense, x)
    assert_within_bound(got.numpy(), dense @ x, dense, x)


def test_oracle_reexports():
    assert t_ops.spmv_ell_ref is t_ref.spmv_ell
    assert t_ops.spmv_csrk_ref is t_ref.spmv_csrk_tiles
    assert t_ops.spmv_sellcs_ref is t_ref.spmv_sellcs
    assert t_ops.spmv_segsum_ref is t_ref.spmv_segsum
    assert t_ops.spmv_diahybrid_ref is t_ref.spmv_diahybrid
    assert t_ops.spmm_csr_ref is t_ref.spmm_csr


# --- one-shot entry points and the registry -------------------------------------


@pytest.mark.parametrize("case", ["random 37x29", "raw (zeros, duplicates, empty rows)"])
def test_one_shot_spmv_and_spmm_match(rng, case):
    A, Aj = CASES[case]()
    x = rng.standard_normal(A.n).astype(np.float32)
    X = rng.standard_normal((A.n, 3)).astype(np.float32)
    y = t_spmv(A, torch.from_numpy(x))
    assert y.shape == (A.m,)
    assert_within_csr_bound(y, np.asarray(j_spmv(Aj, jnp.asarray(x))), A, x)
    Y = t_spmm(A, torch.from_numpy(X))
    assert Y.shape == (A.m, 3)
    assert_within_csr_bound(Y, np.asarray(j_spmm(Aj, jnp.asarray(X))), A, X)
    with pytest.raises(ValueError):
        t_spmm(A, torch.from_numpy(x))
    with pytest.raises(ValueError):
        j_spmm(Aj, jnp.asarray(x))


@pytest.mark.parametrize("name", ["ell", "bcsr", "csr5"])
def test_baselines_are_named_but_never_prepared(bmw, name):
    A, Aj, _ = bmw
    spec = ts.get_format(name)
    assert not spec.selectable and spec.priority == js.get_format(name).priority == -10
    assert ts.available_formats() == js.available_formats()
    with pytest.raises(ValueError):
        t_prepare(A, "ampere", device="cpu", format=name)
    with pytest.raises(ValueError):
        j_prepare(Aj, device="ampere", format=name)


# --- the slice: Jacobi through the ELL operator -------------------------------


def test_jacobi_through_ell_matches_sellcs_and_the_reference(rng, bmw):
    """40 Jacobi sweeps on bmwcra_1 at 1/64 through the ELL operator, through
    ``prepare``'s SELL-C-σ route and through the reference's ELL oracle give
    the same iterates (rtol 1e-5, atol 1e-6: three summation orders over 40
    sweeps of a contraction) and a true relative residual ≤ 1e-5."""
    A, Aj, dense = bmw
    ell = ts.ell_from_csr(A)
    op = t_prepare(A, "ampere", device="cpu")
    assert op.backend == "sellcs"
    diag = np.diag(dense).astype(np.float32)
    b = rng.standard_normal(A.n).astype(np.float32)
    d, bt = torch.from_numpy(diag), torch.from_numpy(b)
    got = t_solvers.jacobi_smoother(lambda v: t_ops.spmv_ell(ell, v), d, bt, iters=40)
    sell = t_solvers.jacobi_smoother(op, d, bt, iters=40)
    ej = js.ell_from_csr(Aj)
    want = j_solvers.jacobi_smoother(lambda v: j_ref.spmv_ell(ej, v), jnp.asarray(diag),
                                     jnp.asarray(b), iters=40)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), sell.numpy(), rtol=1e-5, atol=1e-6)
    res = np.linalg.norm(b - dense.astype(np.float64) @ got.numpy()) / np.linalg.norm(b)
    assert res <= 1e-5
    x = rng.standard_normal(A.n).astype(np.float32)
    assert_within_bound(t_ops.spmv_ell(ell, torch.from_numpy(x)).numpy(),
                        op(torch.from_numpy(x)).numpy(), dense, x)
