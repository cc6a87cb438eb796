"""The port's DIA/CSR-hybrid route against the reference.

The host-built container (``DIAHybridMatrix``) must equal the reference's
arrays bit for bit, for f32 and bf16 plane values.  SpMVs are compared under
the per-row rounding bound

    |y_port − y_ref| ≤ (2·k_i + 2) · eps_f32 · (|A|·|x|)_i

with k_i the row's stored entries: the two packages may sum in different
orders.  Integer-valued cases must come out exactly.  The same matrices,
made from a seed with numpy, go through both packages; reference containers
reach the port through ``repro_torch.sparse.convert``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  one torch thread per test process

import repro.sparse as js
from repro.configs.spmv_suite import grid_laplacian_2d as j_grid
from repro.configs.spmv_suite import load_adversarial as j_load_adversarial
from repro.configs.spmv_suite import stencil_fringe as j_stencil_fringe
from repro.core import solvers as j_solvers
from repro.core.spmv import prepare as j_prepare
from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro.sparse.diahybrid import dense_diagonals as j_dense_diagonals
from repro.sparse.diahybrid import diahybrid_from_csr as j_diahybrid_from_csr

import repro_torch.sparse as ts
from repro_torch.configs.spmv_suite import (
    dia_fringe_matrix,
    dia_hand_matrix,
    dia_rectangular_matrix,
    no_dense_diagonal_matrix,
)
from repro_torch.configs.spmv_suite import grid_laplacian_2d as t_grid
from repro_torch.configs.spmv_suite import load_adversarial as t_load_adversarial
from repro_torch.configs.spmv_suite import stencil_fringe as t_stencil_fringe
from repro_torch.core import solvers as t_solvers
from repro_torch.core.spmv import prepare as t_prepare
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as t_ref
from repro_torch.kernels.spmv_diahybrid import fringe_lanes, spmv_diahybrid_rows
from repro_torch.sparse.convert import diahybrid_from_numpy, to_numpy

EPS32 = float(np.finfo(np.float32).eps)
DTYPES = ("f32", "bf16")


def both(A):
    """(port CSR, reference CSR, dense) of one port-built matrix."""
    rp, ci, vl = (a.numpy() for a in (A.row_ptr, A.col_idx, A.vals))
    Aj = js.CSRMatrix(jnp.asarray(rp), jnp.asarray(ci), jnp.asarray(vl), A.shape)
    return A, Aj, A.todense().numpy()


def from_dense(dense):
    return both(ts.CSRMatrix.fromdense(np.asarray(dense, np.float32)))


def hand_case():
    """The 8×8 integer hand case (``dia_hand_matrix``)."""
    return both(dia_hand_matrix())


def rectangular():
    """130×200, diagonals 0 and +40, two remainder entries in row 5."""
    return both(dia_rectangular_matrix())


def pure_plane():
    """A 24×24 9-point grid: every entry on a dense diagonal (the ±25 corner
    diagonals fill 23²/24² ≥ 0.9 of their rows), empty remainder."""
    return both(t_grid(24, 24, stencil=9))


def pure_remainder():
    """No dense diagonal: every entry rides the remainder."""
    return both(no_dense_diagonal_matrix())


MASK_EDGE_LENGTHS = {0: 1, 31: 2, 32: 31, 33: 32, 63: 33, 64: 64, 1001: 129}


CASES = {
    "stencil_fringe(48)": lambda: both(t_stencil_fringe(48)),
    "rectangular": rectangular,
    "pure_plane": pure_plane,
    "pure_remainder": pure_remainder,
    # remainder rows of 1..129 entries at mask-word edges and the last row;
    # m = 1002 is not a multiple of 4 or 32
    "mask_edges": lambda: both(dia_fringe_matrix(1002, MASK_EDGE_LENGTHS)),
    # every row listed (R = m), with and without a plane
    "every_row": lambda: both(dia_fringe_matrix(70, every_row=3)),
    "every_row_no_plane": lambda: both(dia_fringe_matrix(70, every_row=3, band=None)),
}


@pytest.fixture(scope="module")
def fringe():
    """stencil_fringe(64) from both packages (4096 rows, 41 fringe rows)."""
    A, Aj = t_stencil_fringe(64), j_stencil_fringe(64)
    return A, Aj, np.asarray(Aj.todense())


@pytest.fixture(scope="module")
def ops_pair(fringe):
    A, Aj, dense = fringe
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


def port_dia(dj):
    r = dj.remainder
    return diahybrid_from_numpy(
        np.asarray(dj.diag_vals), dj.offsets, np.asarray(r.row_ptr), np.asarray(r.col_idx),
        np.asarray(r.vals), shape=dj.shape, diag_nnz=dj.diag_nnz, value_dtype=dj.value_dtype)


def stored_dense(dj):
    """A as the container stores it (bf16 plane values upcast), f64."""
    return np.asarray(dj.todense(), np.float64)


# --- generators and containers -----------------------------------------------


def test_stencil_fringe_generator_matches_the_reference():
    for A, Aj in ((t_stencil_fringe(48), j_stencil_fringe(48)),
                  (t_stencil_fringe(64), j_stencil_fringe(64)),
                  (t_load_adversarial(128, names=["stencil_fringe"])["stencil_fringe"],
                   j_load_adversarial(128, names=["stencil_fringe"])["stencil_fringe"])):
        assert A.shape == Aj.shape
        for f in ("row_ptr", "col_idx", "vals"):
            assert_same(getattr(A, f), getattr(Aj, f))
        assert A.fingerprint() == Aj.fingerprint()


def _containers_identical(A, Aj, value_dtype, occupancy=ts.DIAG_OCCUPANCY):
    d = ts.diahybrid_from_csr(A, occupancy=occupancy, value_dtype=value_dtype)
    dj = j_diahybrid_from_csr(Aj, occupancy=occupancy, value_dtype=value_dtype)
    np.testing.assert_array_equal(ts.dense_diagonals(A, occupancy),
                                  j_dense_diagonals(Aj, occupancy))
    assert_same(d.diag_vals, dj.diag_vals)
    assert d.offsets == dj.offsets and all(type(o) is int for o in d.offsets)
    np.testing.assert_array_equal(to_numpy(d.offset_vec), np.asarray(dj.offsets, np.int32))
    assert d.offset_vec.dtype == torch.int32
    for f in ("row_ptr", "col_idx", "vals"):
        assert_same(getattr(d.remainder, f), getattr(dj.remainder, f))
    assert (d.shape, d.diag_nnz, d.value_dtype, d.m, d.n, d.n_diag, d.nnz) == (
        dj.shape, dj.diag_nnz, dj.value_dtype, dj.m, dj.n, dj.n_diag, dj.nnz)
    assert d.padding_overhead() == dj.padding_overhead()
    assert d.overhead_bytes() == dj.overhead_bytes()
    assert d.modeled_bytes() == dj.modeled_bytes()
    np.testing.assert_array_equal(d.todense().numpy(), np.asarray(dj.todense()))
    # the converter carries the reference's container across unchanged
    p = port_dia(dj)
    assert_same(p.diag_vals, dj.diag_vals)
    assert p.offsets == d.offsets and torch.equal(p.offset_vec, d.offset_vec)
    for f in ("row_ptr", "col_idx", "vals"):
        assert torch.equal(getattr(p.remainder, f), getattr(d.remainder, f))
    # both builders derive the port's row list from the remainder's row pointer
    for c in (d, p):
        assert_row_list(c, np.asarray(dj.remainder.row_ptr))
    return d, dj


def assert_row_list(d, row_ptr):
    """``rem_rows``/``rem_start``/``rem_mask`` are what ``row_ptr`` implies,
    worked out here row by row."""
    m = d.m
    rows = [i for i in range(m) if row_ptr[i + 1] > row_ptr[i]]
    start = [int(row_ptr[i]) for i in rows] + [int(row_ptr[m])]
    mask = np.zeros(-(-m // 32), np.uint32)
    for i in rows:
        mask[i // 32] |= np.uint32(1 << (i % 32))
    for t in (d.rem_rows, d.rem_start, d.rem_mask):
        assert t.dtype == torch.int32 and t.ndim == 1
    assert d.rem_rows.tolist() == rows
    assert d.rem_start.tolist() == start
    np.testing.assert_array_equal(d.rem_mask.numpy().view(np.uint32), mask)


@pytest.mark.parametrize("value_dtype", DTYPES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_containers_identical(case, value_dtype):
    A, Aj, dense = CASES[case]()
    d, _ = _containers_identical(A, Aj, value_dtype)
    if case == "stencil_fringe(48)":
        assert len(d.offsets) == 9 and d.remainder.nnz > 0
    elif case == "rectangular":
        assert d.offsets == (0, 40) and d.remainder.nnz == 2
    elif case == "pure_plane":
        assert d.n_diag == 9 and d.remainder.nnz == 0 and d.rem_rows.numel() == 0
    elif case == "mask_edges":
        assert d.offsets == (-1, 0, 1)
        assert d.rem_rows.tolist() == sorted(MASK_EDGE_LENGTHS)
        assert d.remainder.row_lengths()[d.rem_rows.long()].tolist() == [
            MASK_EDGE_LENGTHS[i] for i in sorted(MASK_EDGE_LENGTHS)]
    elif case == "every_row":
        assert d.offsets == (-1, 0, 1) and d.rem_rows.numel() == A.m
    else:
        assert d.n_diag == 0 and d.diag_vals.shape == (0, A.m) and d.remainder.nnz == A.nnz
        if case == "every_row_no_plane":
            assert d.rem_rows.numel() == A.m
    if value_dtype == "f32":
        np.testing.assert_array_equal(d.todense().numpy(), dense)


@pytest.mark.parametrize("value_dtype", DTYPES)
def test_hand_case_container_and_product_are_exact(value_dtype):
    A, Aj, dense = hand_case()
    d, dj = _containers_identical(A, Aj, value_dtype, occupancy=0.7)
    assert d.offsets == (-2, 0, 2)
    assert d.remainder.nnz == 1 and d.diag_nnz == A.nnz - 1
    np.testing.assert_array_equal(d.todense().numpy(), dense)     # small ints: exact in bf16
    x = np.arange(1.0, 9.0, dtype=np.float32)
    X = np.stack([x, -2 * x, x[::-1]], axis=1)
    for xb in (x, X):
        want = dense @ xb
        xt = torch.from_numpy(np.ascontiguousarray(xb))
        np.testing.assert_array_equal(t_ops.spmv_diahybrid(d, xt).numpy(), want)
        np.testing.assert_array_equal(t_ref.spmv_diahybrid(d, xt).numpy(), want)
        np.testing.assert_array_equal(np.asarray(j_ref.spmv_diahybrid(dj, jnp.asarray(xb))),
                                      want)


def test_dense_diagonals_extraction_policy():
    """Occupancy counts against the m plane slots a diagonal costs, so a full
    short corner diagonal never qualifies (``test_irregular_formats.py:103``)."""
    n = 32
    dense = np.zeros((n, n), np.float32)
    np.fill_diagonal(dense, 2.0)
    dense[np.arange(n - 3), np.arange(3, n)] = 1.0     # +3: 29/32
    dense[np.arange(5, n), np.arange(n - 5)] = 1.0     # -5: 27/32
    dense[0, n - 1] = 9.0                              # +31: 1/32
    A, Aj, _ = from_dense(dense)
    for occ, want in ((ts.DIAG_OCCUPANCY, [0, 3]), (0.8, [-5, 0, 3]), (1.1, [])):
        assert list(ts.dense_diagonals(A, occ)) == want
        assert list(j_dense_diagonals(Aj, occ)) == want


def test_int8_is_rejected_by_both_packages():
    A, Aj, _ = from_dense(np.eye(8, dtype=np.float32))
    with pytest.raises(ValueError):
        ts.diahybrid_from_csr(A, value_dtype="int8")
    with pytest.raises(ValueError):
        j_diahybrid_from_csr(Aj, value_dtype="int8")
    with pytest.raises(ValueError):
        t_prepare(A, "ampere", device="cpu", format="diahybrid", value_dtype="int8")
    with pytest.raises(ValueError):
        j_prepare(Aj, format="diahybrid", value_dtype="int8")


# --- plain versions and the wrapper -------------------------------------------


@pytest.mark.parametrize("value_dtype", DTYPES)
@pytest.mark.parametrize("B", [None, 3])
@pytest.mark.parametrize("case", sorted(CASES))
def test_oracle_and_cpu_wrapper_match(rng, case, B, value_dtype):
    A, Aj, _ = CASES[case]()
    dj = j_diahybrid_from_csr(Aj, value_dtype=value_dtype)
    d = port_dia(dj)
    x = rng.standard_normal((A.n,) if B is None else (A.n, B)).astype(np.float32)
    absA = stored_dense(dj)
    want = np.asarray(j_ref.spmv_diahybrid(dj, jnp.asarray(x)))
    oracle = t_ref.spmv_diahybrid(d, torch.from_numpy(x))
    assert_within_bound(oracle.numpy(), want, absA, x)
    plane = t_ref._dia_plane(d, torch.from_numpy(x)).numpy()
    assert_within_bound(plane, np.asarray(j_ref._dia_plane(dj, jnp.asarray(x))), absA, x)
    assert_within_bound(oracle.numpy(), absA @ x, absA, x)
    # the plain version over the row list, as the card reads it
    listed = list_rows(d, torch.from_numpy(x))
    assert_within_bound(listed.numpy(), oracle.numpy(), absA, x)
    assert_within_bound(listed.numpy(), want, absA, x)
    before = spmv_diahybrid_rows.launches
    got = t_ops.spmv_diahybrid(d, torch.from_numpy(x))
    assert spmv_diahybrid_rows.launches == before        # CPU: the plain version
    assert torch.equal(got, listed)
    assert got.shape == (A.m,) + x.shape[1:] and got.dtype == torch.float32


def list_rows(d, x):
    r = d.remainder
    return t_ref.diahybrid_list_rows(d.diag_vals, d.offset_vec, d.rem_rows, d.rem_start,
                                     d.rem_mask, r.col_idx, r.vals, x, m=d.m, n=d.n)


@pytest.mark.parametrize("B", [None, 2])
def test_list_version_leaves_an_unlisted_masked_row_nan(rng, B):
    """A row whose mask bit is set but which is not listed is a row the
    kernel would skip: the plain version shows it as NaN, and every other
    row as before."""
    A, _, dense = CASES["mask_edges"]()
    d = ts.diahybrid_from_csr(A)
    x = torch.from_numpy(rng.standard_normal((A.n,) if B is None else (A.n, B))
                         .astype(np.float32))
    good = list_rows(d, x)
    assert bool(torch.isfinite(good).all())
    mask = d.rem_mask.clone()
    mask[100 // 32] |= 1 << (100 % 32)                   # row 100 holds no remainder
    bad = list_rows(dataclasses.replace(d, rem_mask=mask), x)
    assert bool(torch.isnan(bad[100]).all())
    keep = torch.arange(A.m) != 100
    assert torch.equal(bad[keep], good[keep])


def test_fringe_lanes():
    """G: the largest power of two, 1 to 32, not above a quarter of the mean
    entries per listed row, rounded; 16 on stencil_fringe (64.0 a row)."""
    assert fringe_lanes(2_684_327, 41_943) == 16
    for (nnz, R), G in {(0, 0): 1, (2, 1): 1, (9, 2): 1, (7 * 8, 7): 2, (292, 7): 8,
                        (4 * 31 * 3, 3): 16, (4 * 32 * 5, 5): 32, (4 * 1000, 1): 32}.items():
        assert fringe_lanes(nnz, R) == G


@pytest.mark.parametrize("value_dtype", DTYPES)
@pytest.mark.parametrize("case", ["stencil_fringe(48)", "rectangular"])
def test_cpu_wrapper_matches_interpret_mode_kernel(rng, case, value_dtype):
    """ops.spmv_diahybrid on the CPU against the reference's Pallas kernel,
    run in interpret mode as the reference's own tests run it."""
    A, Aj, _ = CASES[case]()
    dj = j_diahybrid_from_csr(Aj, value_dtype=value_dtype)
    x = rng.standard_normal((A.n, 3)).astype(np.float32)
    absA = stored_dense(dj)
    for xb in (x, x[:, 0].copy()):
        want = np.asarray(j_ops.spmv_diahybrid(dj, jnp.asarray(xb), row_tile=64,
                                               interpret=True))
        got = t_ops.spmv_diahybrid(port_dia(dj), torch.from_numpy(xb)).numpy()
        assert_within_bound(got, want, absA, xb)


def test_non_finite_x_reaches_the_rows_it_reaches_in_the_reference(fringe):
    """Every in-range plane slot is multiplied, a 0 value included: an inf in
    x gives NaN and inf in the same rows as the reference's oracle."""
    A, Aj, _ = fringe
    dj = j_diahybrid_from_csr(Aj)
    d = port_dia(dj)
    x = np.ones(A.n, np.float32)
    x[[0, 100, A.n - 1]] = [np.inf, -np.inf, np.inf]
    want = np.asarray(j_ref.spmv_diahybrid(dj, jnp.asarray(x)))
    got = t_ops.spmv_diahybrid(d, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isposinf(got), np.isposinf(want))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    assert np.isnan(want).any() and np.isinf(want).any()


def test_wrapper_out_and_empty_shapes():
    A, Aj, dense = rectangular()
    d = ts.diahybrid_from_csr(A)
    x = np.arange(200, dtype=np.float32) / 7
    r = d.remainder
    out = torch.full((130,), float("nan"))
    y = spmv_diahybrid_rows(d.diag_vals, d.offset_vec, d.rem_rows, d.rem_start, d.rem_mask,
                            r.col_idx, r.vals, torch.from_numpy(x), m=130, n=200, out=out)
    assert y is out
    assert_within_bound(y.numpy(), dense @ x, dense, x)
    empty = ts.diahybrid_from_csr(ts.CSRMatrix.fromdense(np.zeros((5, 3), np.float32)))
    assert empty.n_diag == 0 and empty.remainder.nnz == 0
    np.testing.assert_array_equal(t_ops.spmv_diahybrid(empty, torch.ones(3)).numpy(),
                                  np.zeros(5))
    np.testing.assert_array_equal(t_ops.spmv_diahybrid(empty, torch.ones(3, 2)).numpy(),
                                  np.zeros((5, 2)))


# --- prepare ------------------------------------------------------------------


@pytest.mark.parametrize("value_dtype", ["f32", "bf16", "auto"])
def test_prepare_routes_and_decides_as_the_reference(fringe, value_dtype):
    A, Aj, _ = fringe
    op = t_prepare(A, "ampere", device="cpu", value_dtype=value_dtype)
    opj = j_prepare(Aj, device="ampere", value_dtype=value_dtype)
    assert op.backend == opj.backend == "diahybrid"
    assert op.value_dtype == opj.value_dtype == op.dia.value_dtype
    assert dataclasses.asdict(op.params) == dataclasses.asdict(opj.params)
    np.testing.assert_array_equal(op.perm, np.arange(A.m))
    assert op.stats.as_dict() == opj.stats.as_dict()
    assert op.fingerprint == opj.fingerprint
    assert op.modeled_bytes() == opj.modeled_bytes()
    assert op.padding_overhead() == opj.padding_overhead()
    assert op.overhead_fraction() == opj.overhead_fraction()
    # the port keeps its perm arrays in int64 (the reference: int32), the
    # offsets as an [n_diag] int32 tensor (the reference: static metadata)
    # and the remainder's row list: rem_rows [R], rem_start [R + 1] and
    # rem_mask [ceil(m / 32)], int32
    R = int((op.dia.remainder.row_lengths() > 0).sum())
    extra = 2 * 4 * A.m + 4 * op.dia.n_diag + 4 * (2 * R + 1) + 4 * (-(-A.m // 32))
    assert op.resident_bytes() == opj.resident_bytes() + extra
    assert_same(op.dia.diag_vals, opj.dia.diag_vals)
    assert op.dia.offsets == opj.dia.offsets
    assert op.segsum is None and op.sell is None
    with pytest.raises(AttributeError):
        op.csr


def test_diag_occupancy_reaches_the_container(fringe):
    A, Aj, _ = fringe
    for occ in (0.5, 0.999):
        op = t_prepare(A, "ampere", device="cpu", format="diahybrid", diag_occupancy=occ)
        opj = j_prepare(Aj, device="ampere", format="diahybrid", diag_occupancy=occ)
        assert op.dia.offsets == opj.dia.offsets
        assert op.dia.remainder.nnz == opj.dia.remainder.nnz
        assert op.modeled_bytes() == opj.modeled_bytes()
    assert len(op.dia.offsets) < 9            # at 0.999 the ±side diagonals drop out


@pytest.mark.parametrize("case", ["grid_12x12", "pure_remainder"])
def test_forced_diahybrid_on_a_matrix_that_does_not_route_there(rng, case):
    if case == "grid_12x12":
        A, Aj = t_grid(12, 12), j_grid(12, 12)
        dense = np.asarray(Aj.todense())
    else:
        A, Aj, dense = pure_remainder()
    op = t_prepare(A, "ampere", device="cpu", format="diahybrid")
    opj = j_prepare(Aj, device="ampere", format="diahybrid")
    assert op.backend == opj.backend == "diahybrid"
    assert op.dia.offsets == opj.dia.offsets
    assert op.modeled_bytes() == opj.modeled_bytes()
    for shape in ((A.n,), (A.n, 3)):
        x = rng.standard_normal(shape).astype(np.float32)
        y = op(torch.from_numpy(x)).numpy()
        assert_within_bound(y, dense @ x, dense, x)
        assert_within_bound(y, np.asarray(j_ref.spmv_diahybrid(opj.dia, jnp.asarray(x))),
                            dense, x)


@pytest.mark.parametrize("B", [None, 4])
def test_call_apply_original_and_matmat(rng, ops_pair, B):
    op, opj, dense = ops_pair
    x = rng.standard_normal((dense.shape[1],) if B is None else (dense.shape[1], B))
    x = x.astype(np.float32)
    absA = stored_dense(opj.dia)
    y = op(torch.from_numpy(x)).numpy()
    want = np.asarray(j_ref.spmv_diahybrid(opj.dia, jnp.asarray(x)))
    assert_within_bound(y, want, absA, x)
    assert_within_bound(op.apply_original(torch.from_numpy(x)).numpy(), want, absA, x)
    assert_within_bound(y, np.asarray(opj.apply_original(jnp.asarray(x))), absA, x)
    if op.value_dtype == "f32":
        assert_within_bound(y, dense @ x, dense, x)
    if B is not None:
        assert torch.equal(op.matmat(torch.from_numpy(x)), op(torch.from_numpy(x)))


def test_spmm_width_keeps_columns_independent(rng, fringe):
    A, Aj, _ = fringe
    op = t_prepare(A, "ampere", device="cpu", spmm_width=4)
    assert op.backend == "diahybrid"
    X = rng.standard_normal((A.n, 6)).astype(np.float32)
    Y = op(torch.from_numpy(X))
    assert Y.shape == (A.m, 6)
    opj = j_prepare(Aj, device="ampere", spmm_width=4)
    assert_within_bound(Y.numpy(), np.asarray(j_ref.spmv_diahybrid(opj.dia, jnp.asarray(X))),
                        stored_dense(opj.dia), X)
    for j in range(6):
        assert torch.equal(Y[:, j], op(torch.from_numpy(X[:, j].copy())))
        assert torch.equal(Y[:, j], op(torch.from_numpy(X[:, [j, 0]].copy()))[:, 0])


def test_power_iteration_matches(ops_pair):
    op, opj, dense = ops_pair
    n = dense.shape[0]
    # the reference side runs its oracle (interpret-mode Pallas per
    # iteration would take most of this file's time)
    j_mv = lambda v: j_ref.spmv_diahybrid(opj.dia, v)  # noqa: E731
    # the same start vector for both: the two packages draw different random bits
    v0 = np.array(jax.random.normal(jax.random.PRNGKey(0), (n,)))
    lam = t_solvers.power_iteration(op, n, iters=30, v0=torch.from_numpy(v0), device="cpu")
    lam_j = j_solvers.power_iteration(j_mv, n, iters=30, seed=0)
    assert np.isfinite(float(lam))
    assert float(lam) == pytest.approx(float(lam_j), rel=1e-4)
    V0 = np.array(jax.random.normal(jax.random.PRNGKey(0), (n, 4)))
    got = t_solvers.block_power_iteration(op, n, 4, iters=30, V0=torch.from_numpy(V0),
                                          device="cpu")
    want = np.asarray(j_solvers.block_power_iteration(j_mv, n, 4, iters=30, seed=0))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3)
