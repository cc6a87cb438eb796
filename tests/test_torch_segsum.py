"""The port's segmented-sum route against the reference.

The host-built container (``SegSumCSR``) must equal the reference's arrays
bit for bit, for f32, bf16 and int8 values.  SpMVs are compared under the
per-row rounding bound

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
from repro.configs.spmv_suite import grid_laplacian_2d as j_grid
from repro.configs.spmv_suite import load_adversarial as j_load_adversarial
from repro.configs.spmv_suite import powerlaw_zipf as j_powerlaw_zipf
from repro.core import solvers as j_solvers
from repro.core.spmv import prepare as j_prepare
from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref

import repro_torch.sparse as ts
from repro_torch.configs.spmv_suite import grid_laplacian_2d as t_grid
from repro_torch.configs.spmv_suite import load_adversarial as t_load_adversarial
from repro_torch.configs.spmv_suite import empty_margin_rows, long_row_matrix, three_chunk_matrix
from repro_torch.configs.spmv_suite import powerlaw_zipf as t_powerlaw_zipf
from repro_torch.core import solvers as t_solvers
from repro_torch.core.spmv import prepare as t_prepare
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as t_ref
from repro_torch.kernels.spmv_segsum import spmv_segsum_chunks
from repro_torch.sparse.convert import segsum_from_numpy, to_numpy

EPS32 = float(np.finfo(np.float32).eps)
DTYPES = ("f32", "bf16", "int8")


def both(A):
    """(port CSR, reference CSR, dense) of one port-built matrix."""
    rp, ci, vl = (a.numpy() for a in (A.row_ptr, A.col_idx, A.vals))
    Aj = js.CSRMatrix(jnp.asarray(rp), jnp.asarray(ci), jnp.asarray(vl), A.shape)
    return A, Aj, A.todense().numpy()


def ragged():
    """13×17 with 11 empty rows (``tests/test_irregular_formats.py:89``)."""
    dense = np.zeros((13, 17), np.float32)
    dense[3, [0, 5, 12]] = [1.0, -2.0, 4.0]
    dense[11, 2] = -2.0
    return both(ts.CSRMatrix.fromdense(dense))


def three_chunk():
    """Row 0 spans three 128-slot chunks (``tests/test_irregular_formats.py:63``)."""
    return both(three_chunk_matrix())


@pytest.fixture(scope="module")
def plaw():
    """powerlaw_zipf(2048) from both packages: hub row, ~10% empty rows."""
    A, Aj = t_powerlaw_zipf(2048), j_powerlaw_zipf(2048)
    return A, Aj, np.asarray(Aj.todense())


@pytest.fixture(scope="module")
def ops_pair(plaw):
    A, Aj, dense = plaw
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


def port_seg(sj):
    return segsum_from_numpy(
        np.asarray(sj.vals), np.asarray(sj.col_idx), np.asarray(sj.local_seg),
        np.asarray(sj.seg_row), shape=sj.shape, nnz_real=sj.nnz_real,
        val_scale=None if sj.val_scale is None else np.asarray(sj.val_scale),
        value_dtype=sj.value_dtype)


def dq_dense(sj):
    """|A| as the container stores it (dequantized), for the bound."""
    m, n = sj.shape
    return np.abs(np.asarray(sj.todense(), np.float64)).reshape(m, n)


def assert_carry_is_the_spanning_rows(s, A):
    """carry lists every nonempty row whose slots fall in more than one chunk,
    with its first and last chunk, from the row pointers."""
    rp = to_numpy(A.row_ptr).astype(np.int64)
    S = s.chunk_slots
    c0, c1 = rp[:-1] // S, (rp[1:] - 1) // S
    rows = np.flatnonzero((rp[1:] > rp[:-1]) & (c0 != c1))
    carry = to_numpy(s.carry)
    assert carry.dtype == np.int32 and carry.shape == (rows.size, 3)
    np.testing.assert_array_equal(carry[:, 0], rows)
    np.testing.assert_array_equal(carry[:, 1] // 2, c0[rows])
    np.testing.assert_array_equal(carry[:, 2], c1[rows])
    # side 1 (the chunk's last segment) exactly when earlier rows' slots
    # precede the row in its first chunk
    np.testing.assert_array_equal(carry[:, 1] % 2, rp[rows] % S != 0)


# --- containers --------------------------------------------------------------


def _containers_identical(A, Aj, chunk_slots, value_dtype):
    s = ts.segsum_from_csr(A, chunk_slots=chunk_slots, value_dtype=value_dtype)
    sj = js.segsum_from_csr(Aj, chunk_slots=chunk_slots, value_dtype=value_dtype)
    for f in ("vals", "col_idx", "local_seg", "seg_row"):
        assert_same(getattr(s, f), getattr(sj, f))
    assert (s.val_scale is None) == (sj.val_scale is None)
    if s.val_scale is not None:
        assert_same(s.val_scale, sj.val_scale)
    assert (s.shape, s.nnz, s.num_chunks, s.chunk_slots, s.segs_per_chunk, s.slots,
            s.value_dtype) == (sj.shape, sj.nnz, sj.num_chunks, sj.chunk_slots,
                               sj.segs_per_chunk, sj.slots, sj.value_dtype)
    assert s.padding_overhead() == sj.padding_overhead()
    assert s.overhead_bytes() == sj.overhead_bytes()
    assert s.modeled_bytes() == sj.modeled_bytes()
    for got, want in zip(s.col_reach(), sj.col_reach()):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(s.todense().numpy(), np.asarray(sj.todense()))
    np.testing.assert_array_equal(s.real_segments(),
                                  (np.asarray(sj.seg_row) < A.m).sum(axis=1))
    assert_carry_is_the_spanning_rows(s, A)
    assert torch.equal(port_seg(sj).carry, s.carry)
    assert torch.equal(port_seg(sj).seg_start, s.seg_start)


@pytest.mark.parametrize("value_dtype", DTYPES)
@pytest.mark.parametrize("chunk_slots", [128, 512])
def test_containers_identical_on_powerlaw(plaw, chunk_slots, value_dtype):
    A, Aj, _ = plaw
    _containers_identical(A, Aj, chunk_slots, value_dtype)


@pytest.mark.parametrize("value_dtype", DTYPES)
@pytest.mark.parametrize("chunk_slots", [128, 512])
def test_containers_identical_on_ragged_empty_rows(chunk_slots, value_dtype):
    A, Aj, dense = ragged()
    _containers_identical(A, Aj, chunk_slots, value_dtype)
    if value_dtype == "f32":
        np.testing.assert_array_equal(
            ts.segsum_from_csr(A, chunk_slots=chunk_slots).todense().numpy(), dense)


def _matrix(name):
    """(port CSR, reference CSR) of one of the segment-table test matrices."""
    if name == "powerlaw":
        return t_powerlaw_zipf(2048), j_powerlaw_zipf(2048)
    A = {"ragged": lambda: ragged()[0], "empty margins": lambda: empty_margin_rows(300, seed=3),
         "three chunks": three_chunk_matrix, "long row": long_row_matrix}[name]()
    return both(A)[:2]


def starts_by_walking(local_seg, nnz):
    """Each chunk's segment starts, slot by slot."""
    T, S = local_seg.shape
    out = []
    for t in range(T):
        n_t = min(S, max(nnz - t * S, 0))
        out.append([s for s in range(n_t)
                    if s == 0 or local_seg[t, s] != local_seg[t, s - 1]])
    return out


MATRICES = ("powerlaw", "ragged", "empty margins", "three chunks", "long row")


@pytest.mark.parametrize("value_dtype", DTYPES)
@pytest.mark.parametrize("chunk_slots", [128, 512])
@pytest.mark.parametrize("name", MATRICES)
def test_segment_start_table_is_the_local_seg_boundaries(name, chunk_slots, value_dtype):
    """seg_start comes from the reference's arrays alone (segsum_from_numpy
    and segsum_from_csr agree) and lists each chunk's segment starts, at
    offsets held in its first T + 1 entries."""
    A, Aj = _matrix(name)
    sj = js.segsum_from_csr(Aj, chunk_slots=chunk_slots, value_dtype=value_dtype)
    s = ts.segsum_from_csr(A, chunk_slots=chunk_slots, value_dtype=value_dtype)
    table = to_numpy(s.seg_start)
    assert table.dtype == np.int32 and table.ndim == 1
    np.testing.assert_array_equal(to_numpy(port_seg(sj).seg_start), table)
    T = s.num_chunks
    ptr = table[: T + 1]
    assert ptr[0] == T + 1 and ptr[-1] == table.size
    lseg = np.asarray(sj.local_seg)
    walked = starts_by_walking(lseg, sj.nnz_real)
    for t in range(T):
        assert table[ptr[t]:ptr[t + 1]].tolist() == walked[t]
    # L_t entries a chunk: the real segments, as seg_row counts them
    np.testing.assert_array_equal(np.diff(ptr), s.real_segments())
    assert table.size == T + 1 + int(s.real_segments().sum())


@pytest.mark.parametrize("B", [None, 3])
@pytest.mark.parametrize("value_dtype", DTYPES)
@pytest.mark.parametrize("name", MATRICES)
def test_table_plain_version_matches_chunk_rows_and_oracle(rng, name, value_dtype, B):
    """ref.segsum_table_rows, the plain version the card kernel is held to
    (segments from seg_start, real slots only), against
    ref.segsum_chunk_rows (segments from local_seg) and the reference's
    oracle, at 128-slot chunks."""
    A, Aj = _matrix(name)
    sj = js.segsum_from_csr(Aj, chunk_slots=128, value_dtype=value_dtype)
    s = port_seg(sj)
    x = rng.standard_normal((A.n,) if B is None else (A.n, B)).astype(np.float32)
    xt = torch.from_numpy(x)
    got = t_ref.segsum_table_rows(s.vals, s.col_idx, s.seg_row, s.seg_start, xt, s.val_scale,
                                  m=s.m, nnz=s.nnz)
    assert got.shape == (A.m,) + x.shape[1:]
    absA = dq_dense(sj)
    assert_within_bound(got.numpy(), t_ref.segsum_chunk_rows(
        s.vals, s.col_idx, s.local_seg, s.seg_row, xt, s.val_scale, m=s.m).numpy(), absA, x)
    assert_within_bound(got.numpy(), np.asarray(j_ref.spmv_segsum(sj, jnp.asarray(x))), absA, x)
    # empty rows and padding come out 0; unit values give the row lengths
    lengths = to_numpy(A.row_lengths())
    assert np.all(got.numpy()[lengths == 0] == 0)
    ones = t_ref.segsum_table_rows(torch.ones_like(s.vals), s.col_idx, s.seg_row, s.seg_start,
                                   torch.ones(A.n), None, m=s.m, nnz=s.nnz)
    np.testing.assert_array_equal(ones.numpy(), lengths.astype(np.float32))


def test_powerlaw_generator_matches_the_reference():
    for A, Aj in ((t_powerlaw_zipf(2048), j_powerlaw_zipf(2048)),
                  (t_load_adversarial(128, names=["powerlaw_zipf"])["powerlaw_zipf"],
                   j_load_adversarial(128, names=["powerlaw_zipf"])["powerlaw_zipf"])):
        assert A.shape == Aj.shape
        for f in ("row_ptr", "col_idx", "vals"):
            assert_same(getattr(A, f), getattr(Aj, f))
        assert A.fingerprint() == Aj.fingerprint()


def test_geometry_of_the_chunks(plaw):
    """Equal-nnz chunks: all but the last full; R covers the worst chunk."""
    A, _, _ = plaw
    s = ts.segsum_from_csr(A, chunk_slots=300)            # rounded up to 384
    assert s.chunk_slots == 384 and s.num_chunks == -(-A.nnz // 384)
    assert s.segs_per_chunk % 8 == 0
    assert int(s.real_segments().max()) <= s.segs_per_chunk
    assert 0 <= s.padding_overhead() < 384 / A.nnz


# --- plain versions and the wrapper -------------------------------------------


@pytest.mark.parametrize("value_dtype", DTYPES)
@pytest.mark.parametrize("B", [None, 8])
def test_oracle_and_cpu_wrapper_match(rng, plaw, value_dtype, B):
    A, Aj, _ = plaw
    sj = js.segsum_from_csr(Aj, chunk_slots=256, value_dtype=value_dtype)
    s = port_seg(sj)
    x = rng.standard_normal((A.n,) if B is None else (A.n, B)).astype(np.float32)
    absA = dq_dense(sj)
    want = np.asarray(j_ref.spmv_segsum(sj, jnp.asarray(x)))
    oracle = t_ref.spmv_segsum(s, torch.from_numpy(x))
    assert_within_bound(oracle.numpy(), want, absA, x)
    before = spmv_segsum_chunks.launches
    got = t_ops.spmv_segsum(s, torch.from_numpy(x))
    assert spmv_segsum_chunks.launches == before        # CPU: the plain version
    assert torch.equal(got, oracle)
    assert got.shape == (A.m,) + x.shape[1:]


@pytest.mark.parametrize("value_dtype", DTYPES)
def test_cpu_wrapper_matches_interpret_mode_kernel(rng, plaw, value_dtype):
    """ops.spmv_segsum on the CPU against the reference's Pallas kernel,
    run in interpret mode as the reference's own tests run it."""
    A, Aj, _ = plaw
    sj = js.segsum_from_csr(Aj, chunk_slots=512, value_dtype=value_dtype)
    x = rng.standard_normal((A.n, 8)).astype(np.float32)
    absA = dq_dense(sj)
    for xb in (x, x[:, 0].copy()):
        want = np.asarray(j_ops.spmv_segsum(sj, jnp.asarray(xb), interpret=True))
        got = t_ops.spmv_segsum(port_seg(sj), torch.from_numpy(xb)).numpy()
        assert_within_bound(got, want, absA, xb)


def test_three_chunk_carry_is_exact():
    A, Aj, _ = three_chunk()
    s = ts.segsum_from_csr(A, chunk_slots=128)
    assert s.num_chunks == 3
    np.testing.assert_array_equal(to_numpy(s.seg_row)[:, 0], [0, 0, 0])
    x = (np.arange(512) % 7 + 1).astype(np.float32)
    want = np.array([1197.0, 0.0, 14.0, 17.0], np.float32)
    np.testing.assert_array_equal(t_ops.spmv_segsum(s, torch.from_numpy(x)).numpy(), want)
    np.testing.assert_array_equal(t_ref.spmv_segsum(s, torch.from_numpy(x)).numpy(), want)
    X = np.stack([x, 2 * x], axis=1)
    np.testing.assert_array_equal(t_ops.spmv_segsum(s, torch.from_numpy(X)).numpy(),
                                  np.stack([want, 2 * want], axis=1))


@pytest.mark.parametrize("value_dtype", DTYPES)
def test_row_over_more_chunks_than_lanes_is_exact(value_dtype):
    """Row 1 spans 40 chunks of 128 slots, more fragments than a warp's 32
    lanes.  Unit values (exact in every value dtype) and small integer x
    make every sum exact, so a dropped or doubled fragment shows."""
    A, Aj, dense = both(long_row_matrix())
    s = ts.segsum_from_csr(A, chunk_slots=128, value_dtype=value_dtype)
    carry = to_numpy(s.carry)
    assert (carry[:, 2] - carry[:, 1] // 2 + 1).max() > 32
    X = ((np.arange(A.n) % 5 + 1)[:, None] * np.arange(1, 9)).astype(np.float32)
    want = (dense.astype(np.int64) @ X.astype(np.int64)).astype(np.float32)
    for xb, wb in ((X[:, 0], want[:, 0]), (X, want)):
        xt = torch.from_numpy(np.ascontiguousarray(xb))
        np.testing.assert_array_equal(t_ops.spmv_segsum(s, xt).numpy(), wb)
        np.testing.assert_array_equal(t_ref.spmv_segsum(s, xt).numpy(), wb)
    sj = js.segsum_from_csr(Aj, chunk_slots=128, value_dtype=value_dtype)
    np.testing.assert_array_equal(np.asarray(j_ref.spmv_segsum(sj, jnp.asarray(X))), want)


def test_empty_rows_and_padding_come_out_exact():
    A, Aj, dense = ragged()
    s = ts.segsum_from_csr(A)
    x = np.arange(17, dtype=np.float32)
    out = torch.full((A.m,), float("nan"))
    y = spmv_segsum_chunks(s.vals, s.col_idx, s.seg_row, s.seg_start, s.carry,
                           torch.from_numpy(x), m=A.m, nnz=s.nnz, out=out)
    assert y is out
    np.testing.assert_array_equal(y.numpy(), dense @ x)
    empty = ts.CSRMatrix.fromdense(np.zeros((5, 3), np.float32))
    s0 = ts.segsum_from_csr(empty)
    assert s0.nnz == 0 and s0.num_chunks == 1
    np.testing.assert_array_equal(t_ops.spmv_segsum(s0, torch.ones(3)).numpy(), np.zeros(5))


# --- prepare ------------------------------------------------------------------


@pytest.mark.parametrize("value_dtype", ["f32", "bf16", "int8", "auto"])
def test_prepare_routes_and_decides_as_the_reference(plaw, value_dtype):
    A, Aj, _ = plaw
    op = t_prepare(A, "ampere", device="cpu", value_dtype=value_dtype)
    opj = j_prepare(Aj, device="ampere", value_dtype=value_dtype)
    assert op.backend == opj.backend == "segsum"
    assert op.value_dtype == opj.value_dtype
    assert dataclasses.asdict(op.params) == dataclasses.asdict(opj.params)
    np.testing.assert_array_equal(op.perm, np.arange(A.m))
    assert op.stats.as_dict() == opj.stats.as_dict()
    assert op.fingerprint == opj.fingerprint
    assert op.modeled_bytes() == opj.modeled_bytes()
    assert op.padding_overhead() == opj.padding_overhead()
    assert op.overhead_fraction() == opj.overhead_fraction()
    # the port adds the segment-start table and the carry list (int32); its
    # perm arrays are int64
    extra = (op.segsum.seg_start.numel() + op.segsum.carry.numel()) * 4 + 2 * 4 * A.m
    assert op.resident_bytes() == opj.resident_bytes() + extra
    for f in ("vals", "col_idx", "local_seg", "seg_row"):
        assert_same(getattr(op.segsum, f), getattr(opj.segsum, f))
    with pytest.raises(AttributeError):
        op.csr


def test_prepare_segsum_chunk_reaches_the_container(plaw):
    A, Aj, _ = plaw
    op = t_prepare(A, "ampere", device="cpu", format="segsum", segsum_chunk=128)
    opj = j_prepare(Aj, device="ampere", format="segsum", segsum_chunk=128)
    assert op.segsum.chunk_slots == opj.segsum.chunk_slots == 128
    assert op.modeled_bytes() == opj.modeled_bytes()
    assert_same(op.segsum.seg_row, opj.segsum.seg_row)


def test_forced_segsum_on_a_tame_matrix(rng):
    A, Aj = t_grid(12, 12), j_grid(12, 12)
    dense = np.asarray(Aj.todense())
    op = t_prepare(A, "ampere", device="cpu", format="segsum")
    opj = j_prepare(Aj, device="ampere", format="segsum")
    assert op.backend == opj.backend == "segsum"
    assert op.modeled_bytes() == opj.modeled_bytes()
    for shape in ((A.n,), (A.n, 3)):
        x = rng.standard_normal(shape).astype(np.float32)
        y = op(torch.from_numpy(x)).numpy()
        assert_within_bound(y, dense @ x, dense, x)
        assert_within_bound(y, np.asarray(j_ref.spmv_segsum(opj.segsum, jnp.asarray(x))),
                            dense, x)
    with pytest.raises(AttributeError):
        op.csr


@pytest.mark.parametrize("B", [None, 4])
def test_call_apply_original_and_matmat(rng, ops_pair, B):
    op, opj, dense = ops_pair
    x = rng.standard_normal((dense.shape[1],) if B is None else (dense.shape[1], B))
    x = x.astype(np.float32)
    y = op(torch.from_numpy(x)).numpy()
    want = np.asarray(j_ref.spmv_segsum(opj.segsum, jnp.asarray(x)))
    assert_within_bound(y, want, dense, x)
    assert_within_bound(op.apply_original(torch.from_numpy(x)).numpy(), want, dense, x)
    assert_within_bound(y, dense @ x, dense, x)
    if B is not None:
        assert torch.equal(op.matmat(torch.from_numpy(x)), op(torch.from_numpy(x)))


def test_spmm_width_keeps_columns_independent(rng, plaw):
    A, Aj, dense = plaw
    op = t_prepare(A, "ampere", device="cpu", spmm_width=4)
    assert op.backend == "segsum"
    X = rng.standard_normal((A.n, 6)).astype(np.float32)
    Y = op(torch.from_numpy(X))
    assert Y.shape == (A.m, 6)
    opj = j_prepare(Aj, device="ampere", spmm_width=4)
    assert_within_bound(Y.numpy(), np.asarray(j_ref.spmv_segsum(opj.segsum, jnp.asarray(X))),
                        dense, X)
    for j in range(6):
        assert torch.equal(Y[:, j], op(torch.from_numpy(X[:, j].copy())))
        assert torch.equal(Y[:, j], op(torch.from_numpy(X[:, [j, 0]].copy()))[:, 0])


def test_power_iteration_matches(ops_pair):
    op, opj, dense = ops_pair
    n = dense.shape[0]
    # the reference side runs its oracle (interpret-mode Pallas per
    # iteration would take most of this file's time)
    j_mv = lambda v: j_ref.spmv_segsum(opj.segsum, v)  # noqa: E731
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
