"""Tests of the port's CUDA kernels that need a card (marker ``cuda``).

Each test takes the ``cuda`` fixture, which skips where no CUDA device is
present.  On a machine with a card and ``nvcc`` run them with

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest`` because ``tests/conftest.py`` imports jax, which a GPU
machine running only the port need not have; this file imports no jax.)
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.spmv_suite import (
    dia_fringe_matrix,
    dia_hand_matrix,
    dia_rectangular_matrix,
    ell_width_matrix,
    empty_margin_rows,
    grid_laplacian_2d,
    load_suite,
    long_row_matrix,
    no_dense_diagonal_matrix,
    pareto_rows,
    powerlaw_zipf,
    stencil_fringe,
    three_chunk_matrix,
)
from repro_torch.core import cg, jacobi_smoother, power_iteration, prepare
from repro_torch.kernels import ops, ref
from repro_torch.kernels.spmv_csrk import spmv_csrk_tiles
from repro_torch.kernels.spmv_diahybrid import fringe_lanes, spmv_diahybrid_rows
from repro_torch.kernels.spmv_ell import spmv_ell_rows
from repro_torch.kernels.spmv_segsum import spmv_segsum_chunks
from repro_torch.kernels.spmv_sellcs import spmv_sellcs_chunks
from repro_torch.sparse import (
    CSRMatrix,
    bucket_tiles,
    diahybrid_from_csr,
    ell_from_csr,
    segsum_from_csr,
    sellcs_from_csr,
    tiles_from_csrk,
    tiles_from_sellcs,
)

pytestmark = pytest.mark.cuda

EPS32 = float(np.finfo(np.float32).eps)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def ecology():
    return load_suite(scale=256, ids=[8])["ecology1"]


def _bound(view, x, row_nnz):
    if hasattr(view, "buckets"):
        absv = dataclasses.replace(view, buckets=tuple(
            dataclasses.replace(b, vals=b.vals.abs()) for b in view.buckets))
        prod = ref.spmv_csrk_buckets(absv, x.abs())
    else:
        prod = ref.spmv_csrk_tiles(dataclasses.replace(view, vals=view.vals.abs()), x.abs())
    k = row_nnz.to(prod.dtype)
    return (2 * (k[:, None] if prod.ndim == 2 else k) + 2) * EPS32 * prod


@pytest.mark.parametrize("value_dtype", ["f32", "bf16", "int8"])
def test_kernel_matches_plain_and_is_bit_stable(cuda, ecology, value_dtype):
    op = prepare(ecology, device=cuda)
    tiles = tiles_from_csrk(op.csrk, value_dtype=value_dtype)
    views = {ops.spmv_csrk: tiles.to(cuda), ops.spmv_csrk_bucketed: bucket_tiles(tiles).to(cuda)}
    plains = {ops.spmv_csrk: ref.spmv_csrk_tiles, ops.spmv_csrk_bucketed: ref.spmv_csrk_buckets}
    X = torch.randn((ecology.n, 8), generator=torch.Generator(cuda).manual_seed(0), device=cuda)
    row_nnz = op.csrk.csr.row_lengths()
    outs = []
    for run, view in views.items():
        Y = run(view, X)
        err = (Y - plains[run](view, X)).abs()
        assert bool((err <= _bound(view, X, row_nnz)).all())
        assert torch.equal(Y, run(view, X))
        for j in range(8):
            assert torch.equal(Y[:, j], run(view, X[:, j].contiguous()))
        outs.append(Y)
    assert torch.equal(outs[0], outs[1])


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda, ecology):
    op = prepare(ecology, device=cuda, tile_layout="monolithic")
    t = op.tiles
    x = torch.randn(ecology.n, device=cuda)
    call = lambda **kw: spmv_csrk_tiles(  # noqa: E731
        kw.get("vals", t.vals), kw.get("lc", t.local_col), t.local_row, t.win_block,
        kw.get("x", x), kw.get("scale"), rows_per_tile=t.rows_per_tile, window=t.window,
        tile_ids=None if kw.get("out") is None else torch.arange(
            t.num_tiles, dtype=torch.int32, device=cuda), out=kw.get("out"))
    with pytest.raises(TypeError):
        call(x=x.double())
    with pytest.raises(TypeError):
        call(x=x.half())
    with pytest.raises(TypeError):
        call(x=x.to(torch.bfloat16), out=torch.empty(t.num_tiles * t.rows_per_tile,
                                                      device=cuda))   # out not in x's dtype
    assert call(x=x.to(torch.bfloat16)).dtype == torch.bfloat16
    with pytest.raises(TypeError):
        call(lc=t.local_col.long())
    with pytest.raises(ValueError):
        call(x=torch.randn((ecology.n, 4), device=cuda)[:, ::2])
    with pytest.raises(ValueError):
        call(vals=t.vals.to(torch.int8))                      # int8 needs val_scale
    with pytest.raises(ValueError):
        call(scale=torch.ones((t.num_tiles, t.slots // 128), device=cuda))
    with pytest.raises(ValueError):
        call(vals=t.vals.cpu())
    before = spmv_csrk_tiles.launches
    call()
    assert spmv_csrk_tiles.launches == before + 1


def test_launch_count_is_one_per_bucket(cuda, ecology):
    op = prepare(ecology, device=cuda)
    before = spmv_csrk_tiles.launches
    op(torch.randn(ecology.n, device=cuda))
    assert spmv_csrk_tiles.launches - before == op.tile_buckets.num_buckets


def test_remainder_fold_is_deterministic(cuda):
    dense = np.zeros((64, 1024), np.float32)
    for i in range(64):
        dense[i, i] = 2.0
        dense[i, 600 + (i * 37) % 400] = 1.0
        dense[i, 1000 - i] = 0.25
    A = CSRMatrix.fromdense(dense)
    op = prepare(A, device=cuda, format="csrk", reorder="natural", tile_layout="monolithic")
    op = dataclasses.replace(op, tiles=tiles_from_csrk(op.csrk.to("cpu"), window=128).to(cuda))
    assert op.tiles.remainder_nnz == 128
    x = torch.randn(1024, generator=torch.Generator(cuda).manual_seed(1), device=cuda)
    y = ops.spmv_csrk(op.tiles, x)
    assert torch.equal(y, ops.spmv_csrk(op.tiles, x))
    want = torch.from_numpy(dense.astype(np.float64) @ x.double().cpu().numpy())
    assert torch.allclose(y.double().cpu(), want, rtol=1e-5, atol=1e-5)


def test_cg_on_card_matches_cpu(cuda, ecology):
    op_gpu = prepare(ecology, device=cuda)
    op_cpu = prepare(ecology, device="cpu")
    b = torch.from_numpy(np.random.default_rng(0).standard_normal(ecology.n).astype(np.float32))
    res_gpu = cg(op_gpu, b.to(cuda), tol=1e-6, maxiter=2000)
    res_cpu = cg(op_cpu, b, tol=1e-6, maxiter=2000)
    assert res_gpu.iters < 2000 and abs(res_gpu.iters - res_cpu.iters) <= 2
    rel = torch.linalg.norm(res_gpu.x.cpu() - res_cpu.x) / torch.linalg.norm(res_cpu.x)
    assert float(rel) <= 1e-4


# --- SELL-C-σ route ---------------------------------------------------------


@pytest.fixture(scope="module")
def irregular():
    """bmwcra_1 at 1/64 (routes to SELL-C-σ) and a Pareto matrix with empty
    rows and m not a multiple of C."""
    return {"bmwcra_1": load_suite(scale=64, ids=[16])["bmwcra_1"],
            "pareto": pareto_rows(1003, seed=3)}


def _sell_bound(tiles, x, row_nnz):
    absv = dataclasses.replace(tiles, vals=tiles.vals.abs())
    prod = ref.spmv_sellcs_tiles(absv, x.abs())
    k = row_nnz.to(prod.dtype)
    return (2 * (k[:, None] if prod.ndim == 2 else k) + 2) * EPS32 * prod


@pytest.mark.parametrize("value_dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("name", ["bmwcra_1", "pareto"])
def test_sellcs_kernel_matches_plain_and_is_bit_stable(cuda, irregular, name, value_dtype):
    A = irregular[name]
    tiles = tiles_from_sellcs(sellcs_from_csr(A), value_dtype=value_dtype).to(cuda)
    X = torch.randn((A.n, 8), generator=torch.Generator(cuda).manual_seed(0), device=cuda)
    row_nnz = A.row_lengths().to(cuda)
    for xb in (X, X[:, 0].contiguous(), X[:, :3].contiguous()):
        Y = ops.spmv_sellcs(tiles, xb)
        err = (Y - ref.spmv_sellcs_tiles(tiles, xb)).abs()
        assert bool((err <= _sell_bound(tiles, xb, row_nnz)).all())
        assert torch.equal(Y, ops.spmv_sellcs(tiles, xb))
    Y = ops.spmv_sellcs(tiles, X)
    for j in range(8):
        assert torch.equal(Y[:, j], ops.spmv_sellcs(tiles, X[:, j].contiguous()))


def test_sellcs_wrapper_rejects_what_the_kernel_does_not_take(cuda, irregular):
    A = irregular["bmwcra_1"]
    t = tiles_from_sellcs(sellcs_from_csr(A)).to(cuda)
    x = torch.randn(A.n, device=cuda)
    call = lambda **kw: spmv_sellcs_chunks(  # noqa: E731
        kw.get("vals", t.vals), kw.get("cols", t.col_idx), t.row_perm,
        kw.get("width", t.chunk_width), kw.get("x", x), kw.get("scale"), m=A.m)
    with pytest.raises(TypeError):
        call(x=x.double())
    with pytest.raises(TypeError):
        call(x=x.half())
    assert call(x=x.to(torch.bfloat16)).dtype == torch.bfloat16
    with pytest.raises(TypeError):
        spmv_sellcs_chunks(t.vals, t.col_idx, t.row_perm, t.chunk_width, x.to(torch.bfloat16),
                           m=A.m, out=torch.empty(A.m, device=cuda))   # out not in x's dtype
    with pytest.raises(ValueError):
        call(x=torch.randn((A.n, 4), device=cuda)[:, ::2])      # not contiguous
    with pytest.raises(ValueError):
        call(cols=t.col_idx.transpose(1, 2))                     # not contiguous
    with pytest.raises(ValueError):
        call(vals=t.vals.cpu())                                  # CPU mixed with CUDA
    with pytest.raises(ValueError):
        call(width=t.chunk_width.cpu())
    with pytest.raises(TypeError):
        call(cols=t.col_idx.long())
    with pytest.raises(ValueError):
        call(vals=t.vals.to(torch.int8))                         # int8 needs val_scale
    before = spmv_sellcs_chunks.launches
    call()
    assert spmv_sellcs_chunks.launches == before + 1


def test_sellcs_route_launches_once_per_spmv(cuda, irregular):
    op = prepare(irregular["bmwcra_1"], device=cuda)
    assert op.backend == "sellcs"
    before = spmv_sellcs_chunks.launches
    op(torch.randn(op.sell.n, device=cuda))
    op(torch.randn((op.sell.n, 8), device=cuda))
    assert spmv_sellcs_chunks.launches - before == 2


def test_jacobi_on_card_matches_cpu(cuda, irregular):
    A = irregular["bmwcra_1"]
    op_gpu = prepare(A, device=cuda)
    op_cpu = prepare(A, device="cpu")
    diag = A.todense().diagonal().contiguous()
    b = torch.from_numpy(np.random.default_rng(0).standard_normal(A.n).astype(np.float32))
    x_gpu = jacobi_smoother(op_gpu, diag.to(cuda), b.to(cuda), iters=40)
    x_cpu = jacobi_smoother(op_cpu, diag, b, iters=40)
    rel = torch.linalg.norm(x_gpu.cpu() - x_cpu) / torch.linalg.norm(x_cpu)
    assert float(rel) <= 1e-5


# --- segmented-sum route ----------------------------------------------------


@pytest.fixture(scope="module")
def powerlaw():
    """powerlaw_zipf(2048) (routes to segsum) and a matrix whose first and
    last rows are empty, with rows that span several 128-slot chunks."""
    return {"powerlaw": powerlaw_zipf(2048), "margins": empty_margin_rows(300, seed=3)}


def _seg_bound(seg, x, row_nnz):
    prod = ref.spmv_segsum(dataclasses.replace(seg, vals=seg.vals.abs()), x.abs())
    k = row_nnz.to(prod.dtype)
    return (2 * (k[:, None] if prod.ndim == 2 else k) + 2) * EPS32 * prod


@pytest.mark.parametrize("chunk_slots", [128, 512])
@pytest.mark.parametrize("value_dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("name", ["powerlaw", "margins"])
def test_segsum_kernel_matches_plain_and_is_bit_stable(cuda, powerlaw, name, value_dtype,
                                                       chunk_slots):
    A = powerlaw[name]
    seg = segsum_from_csr(A, chunk_slots=chunk_slots, value_dtype=value_dtype).to(cuda)
    X = torch.randn((A.n, 16), generator=torch.Generator(cuda).manual_seed(0), device=cuda)
    row_nnz = A.row_lengths().to(cuda)
    for xb in (X, X[:, :8].contiguous(), X[:, 0].contiguous(), X[:, :3].contiguous()):
        Y = ops.spmv_segsum(seg, xb)
        err = (Y - ref.spmv_segsum(seg, xb)).abs()
        assert bool((err <= _seg_bound(seg, xb, row_nnz)).all())
        assert torch.equal(Y, ops.spmv_segsum(seg, xb))
    Y = ops.spmv_segsum(seg, X)
    for j in range(16):
        assert torch.equal(Y[:, j], ops.spmv_segsum(seg, X[:, j].contiguous()))


def test_segsum_three_chunk_carry_is_exact(cuda):
    seg = segsum_from_csr(three_chunk_matrix(), chunk_slots=128).to(cuda)
    x = torch.from_numpy((np.arange(512) % 7 + 1).astype(np.float32)).to(cuda)
    want = torch.tensor([1197.0, 0.0, 14.0, 17.0], device=cuda)
    assert torch.equal(ops.spmv_segsum(seg, x), want)
    assert torch.equal(ops.spmv_segsum(seg, torch.stack([x, 2 * x], 1)),
                       torch.stack([want, 2 * want], 1))


@pytest.mark.parametrize("value_dtype", ["f32", "bf16", "int8"])
def test_segsum_row_over_more_chunks_than_lanes_is_exact(cuda, value_dtype):
    """Row 1 spans 40 chunks of 128 slots: the carry warp's lanes take more
    than one fragment each.  Unit values and small integer x make every sum
    exact, so a dropped or doubled fragment shows."""
    A = long_row_matrix()
    seg = segsum_from_csr(A, chunk_slots=128, value_dtype=value_dtype).to(cuda)
    assert int((seg.carry[:, 2] - seg.carry[:, 1] // 2 + 1).max()) > 32
    X = ((torch.arange(A.n) % 5 + 1)[:, None] * torch.arange(1, 9)).float()
    want = (A.todense().double() @ X.double()).float().to(cuda)
    X = X.to(cuda)
    assert torch.equal(ops.spmv_segsum(seg, X), want)
    for j in range(8):
        assert torch.equal(ops.spmv_segsum(seg, X[:, j].contiguous()), want[:, j])


@pytest.mark.parametrize("B", [1, 8])
def test_segsum_empty_rows_are_zero_in_dirty_memory(cuda, powerlaw, B):
    A = powerlaw["margins"]
    seg = segsum_from_csr(A, chunk_slots=128).to(cuda)
    empty = A.row_lengths().to(cuda) == 0
    assert bool(empty[0]) and bool(empty[-1])
    x = torch.randn((A.n, B), device=cuda)
    x = x[:, 0].contiguous() if B == 1 else x
    out = torch.full((A.m,) + tuple(x.shape[1:]), float("nan"), device=cuda)
    y = spmv_segsum_chunks(seg.vals, seg.col_idx, seg.seg_row, seg.seg_start, seg.carry, x,
                           m=A.m, nnz=seg.nnz, out=out)
    assert y is out and bool(torch.isfinite(y).all())
    assert bool((y[empty] == 0).all())
    assert torch.equal(y, ops.spmv_segsum(seg, x))
    nothing = segsum_from_csr(CSRMatrix.fromdense(np.zeros((5, 3), np.float32))).to(cuda)
    out = torch.full((5,), float("nan"), device=cuda)
    spmv_segsum_chunks(nothing.vals, nothing.col_idx, nothing.seg_row, nothing.seg_start,
                       nothing.carry, torch.ones(3, device=cuda), m=5, nnz=0, out=out)
    assert torch.equal(out, torch.zeros(5, device=cuda))


def test_segsum_wrapper_rejects_what_the_kernel_does_not_take(cuda, powerlaw):
    A = powerlaw["powerlaw"]
    s = segsum_from_csr(A).to(cuda)
    x = torch.randn(A.n, device=cuda)
    call = lambda **kw: spmv_segsum_chunks(  # noqa: E731
        kw.get("vals", s.vals), kw.get("cols", s.col_idx), kw.get("seg_row", s.seg_row),
        kw.get("table", s.seg_start), kw.get("carry", s.carry), kw.get("x", x),
        kw.get("scale"), m=A.m,
        nnz=kw.get("nnz", s.nnz))
    with pytest.raises(TypeError):
        call(x=x.double())
    with pytest.raises(TypeError):
        call(x=x.half())
    x16 = x.to(torch.bfloat16)
    y16 = call(x=x16)
    assert y16.dtype == torch.bfloat16
    assert bool((((y16.double() - ref.spmv_segsum(s, x16.double())).abs()) <= (
        2.0 ** -8 + (2 * A.row_lengths().to(cuda) + 2) * EPS32)
        * ref.spmv_segsum(dataclasses.replace(s, vals=s.vals.abs()), x16.double().abs())).all())
    with pytest.raises(TypeError):
        spmv_segsum_chunks(s.vals, s.col_idx, s.seg_row, s.seg_start, s.carry, x16, m=A.m,
                           nnz=s.nnz, out=torch.empty(A.m, device=cuda))   # not x's dtype
    with pytest.raises(ValueError):
        call(x=torch.randn((A.n, 4), device=cuda)[:, ::2])      # not contiguous
    with pytest.raises(ValueError):
        call(seg_row=s.seg_row[:, :1])                           # wrong shape
    with pytest.raises(ValueError):
        call(seg_row=s.seg_row.cpu())                            # CPU mixed with CUDA
    with pytest.raises(TypeError):
        call(cols=s.col_idx.long())
    with pytest.raises(ValueError):
        call(vals=s.vals.to(torch.int8))                         # int8 needs val_scale
    with pytest.raises(ValueError):
        call(scale=torch.ones((s.num_chunks, 4), device=cuda))   # only with int8
    with pytest.raises(ValueError):
        call(nnz=s.slots + 1)
    with pytest.raises(ValueError):
        call(table=None)                                         # no segment-start table
    with pytest.raises(TypeError):
        call(table=s.seg_start.long())
    with pytest.raises(ValueError):
        call(table=s.seg_start[: 2 * s.num_chunks])              # too short for T chunks
    with pytest.raises(ValueError):
        call(table=s.seg_start[None])                            # not 1-D
    with pytest.raises(ValueError):
        call(table=s.seg_start.cpu())
    before = spmv_segsum_chunks.launches
    call()
    assert spmv_segsum_chunks.launches == before + 1


def _rows_of(lengths, n, seed):
    """CSR with the given row lengths, distinct random columns, normal values."""
    rng = np.random.default_rng(seed)
    dense = np.zeros((len(lengths), n), np.float32)
    for i, k in enumerate(lengths):
        dense[i, rng.choice(n, size=k, replace=False)] = rng.standard_normal(k)
    return CSRMatrix.fromdense(dense)


@pytest.mark.parametrize("value_dtype", ["f32", "int8"])
@pytest.mark.parametrize("name", ["near R", "one segment per chunk"])
def test_segsum_segment_count_extremes(cuda, name, value_dtype):
    """Chunks of 128 slots that hold up to 128 segments (rows of one or two
    entries, and an empty row or two between), and chunks that hold one
    segment of a row spanning all of them, at B = 1 and 8."""
    rng = np.random.default_rng(5)
    if name == "near R":
        lengths = rng.choice([0, 1, 1, 1, 2], size=700)
        lengths[:200] = 1                                      # two chunks of 128 rows
    else:
        lengths = np.array([0, 1500, 0])
    A = _rows_of(lengths, 1600, seed=6)
    seg = segsum_from_csr(A, chunk_slots=128, value_dtype=value_dtype).to(cuda)
    real = seg.real_segments()
    assert (real.max() == 128) if name == "near R" else (real[1:-1] == 1).all()
    row_nnz = A.row_lengths().to(cuda)
    X = torch.randn((A.n, 8), generator=torch.Generator(cuda).manual_seed(2), device=cuda)
    for xb in (X[:, 0].contiguous(), X):
        out = torch.full((A.m,) + tuple(xb.shape[1:]), float("nan"), device=cuda)
        Y = spmv_segsum_chunks(seg.vals, seg.col_idx, seg.seg_row, seg.seg_start, seg.carry,
                               xb, seg.val_scale, m=A.m, nnz=seg.nnz, out=out)
        err = (Y - ref.spmv_segsum(seg, xb)).abs()
        assert bool((err <= _seg_bound(seg, xb, row_nnz)).all())
        assert bool((Y[row_nnz == 0] == 0).all())
        assert torch.equal(Y, ops.spmv_segsum(seg, xb))
    for j in range(8):
        assert torch.equal(Y[:, j], ops.spmv_segsum(seg, X[:, j].contiguous()))


def test_segsum_route_launches_once_per_spmv(cuda, powerlaw):
    op = prepare(powerlaw["powerlaw"], device=cuda)
    assert op.backend == "segsum"
    before = spmv_segsum_chunks.launches
    op(torch.randn(op.segsum.n, device=cuda))
    op(torch.randn((op.segsum.n, 8), device=cuda))
    assert spmv_segsum_chunks.launches - before == 2


def test_power_iteration_on_card_matches_cpu(cuda, powerlaw):
    A = powerlaw["powerlaw"]
    op_gpu = prepare(A, device=cuda)
    op_cpu = prepare(A, device="cpu")
    v0 = torch.from_numpy(np.random.default_rng(0).standard_normal(A.n).astype(np.float32))
    lam_gpu = power_iteration(op_gpu, A.n, iters=30, v0=v0.to(cuda), device=cuda)
    lam_cpu = power_iteration(op_cpu, A.n, iters=30, v0=v0, device="cpu")
    assert float(lam_gpu) == pytest.approx(float(lam_cpu), rel=1e-4)


@pytest.fixture(scope="module")
def diagonal():
    return {"fringe": stencil_fringe(64), "rectangular": dia_rectangular_matrix(),
            "plane": grid_laplacian_2d(24, 24, stencil=9), "remainder": no_dense_diagonal_matrix()}


def _abs_dia(d):
    return dataclasses.replace(d, diag_vals=d.diag_vals.abs(), remainder=dataclasses.replace(
        d.remainder, vals=d.remainder.vals.abs()))


@pytest.mark.parametrize("value_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", ["fringe", "rectangular", "plane", "remainder"])
def test_dia_kernel_matches_plain_and_is_bit_stable(cuda, diagonal, name, value_dtype):
    A = diagonal[name]
    d = diahybrid_from_csr(A, value_dtype=value_dtype).to(cuda)
    assert (d.n_diag == 0) == (name == "remainder") and (d.remainder.nnz == 0) == (name == "plane")
    X = torch.randn((A.n, 8), generator=torch.Generator(cuda).manual_seed(6), device=cuda)
    k = A.row_lengths().to(cuda).float()
    for xb in (X[:, 0].contiguous(), X):
        y = ops.spmv_diahybrid(d, xb)
        prod = ref.spmv_diahybrid(_abs_dia(d), xb.abs())
        bound = (2 * (k[:, None] if xb.ndim == 2 else k) + 2) * EPS32 * prod
        assert bool(((y - ref.spmv_diahybrid(d, xb)).abs() <= bound).all())
        assert torch.equal(y, ops.spmv_diahybrid(d, xb))
    Y = ops.spmv_diahybrid(d, X)
    for j in range(8):
        assert torch.equal(Y[:, j], ops.spmv_diahybrid(d, X[:, j].contiguous()))


@pytest.mark.parametrize("value_dtype", ["f32", "bf16"])
def test_dia_hand_case_is_exact(cuda, value_dtype):
    A = dia_hand_matrix()
    d = diahybrid_from_csr(A, occupancy=0.7, value_dtype=value_dtype).to(cuda)
    assert d.offsets == (-2, 0, 2) and d.remainder.nnz == 1
    X = (torch.arange(1, 9, dtype=torch.float32)[:, None] * torch.tensor([1.0, -2.0, 3.0]))
    want = (A.todense().double() @ X.double()).float().to(cuda)
    X = X.to(cuda)
    assert torch.equal(ops.spmv_diahybrid(d, X), want)
    assert torch.equal(ops.spmv_diahybrid(d, X[:, 0].contiguous()), want[:, 0])


@pytest.mark.parametrize("B", [1, 8])
def test_dia_non_finite_x_reaches_the_plain_versions_rows(cuda, diagonal, B):
    A = diagonal["fringe"]
    d = diahybrid_from_csr(A).to(cuda)
    x = torch.randn((A.n, B), device=cuda)
    bad = torch.tensor([float("inf"), float("-inf"), float("nan")], device=cuda)
    x[[0, 100, A.n - 1]] = bad[:, None]
    x = x[:, 0].contiguous() if B == 1 else x
    y, want = ops.spmv_diahybrid(d, x), ref.spmv_diahybrid(d, x)
    assert torch.equal(torch.isnan(y), torch.isnan(want))
    assert torch.equal(torch.isposinf(y), torch.isposinf(want))
    assert torch.equal(torch.isneginf(y), torch.isneginf(want))
    assert bool(torch.isnan(y).any()) and bool(torch.isinf(y).any())


DIA_LENGTHS = (1, 2, 31, 32, 33, 64, 129)


def _dia_lengths(m):
    """Remainder rows of 1..129 entries at mask-word edges and the last row."""
    return dict(zip((0, 31, 32, 33, 63, 64, m - 1), DIA_LENGTHS))


@pytest.fixture(scope="module")
def dia_lists():
    cases = {f"lengths m={m}": dia_fringe_matrix(m, _dia_lengths(m)) for m in range(1000, 1004)}
    cases["long rows"] = dia_fringe_matrix(1003, {0: 129, 31: 160, 1002: 200}, seed=1)
    cases["every row"] = dia_fringe_matrix(1001, every_row=12, seed=2)
    cases["every row, no plane"] = dia_fringe_matrix(333, every_row=3, band=None, seed=3)
    cases["stencil_fringe(47)"] = stencil_fringe(47)
    cases["71 diagonals"] = dia_fringe_matrix(1001, {7: 2}, band=35, seed=4)
    return cases


@pytest.mark.parametrize("value_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", ["lengths m=1000", "lengths m=1001", "lengths m=1002",
                                  "lengths m=1003", "long rows", "every row",
                                  "every row, no plane", "stencil_fringe(47)", "71 diagonals"])
def test_dia_row_list_cases(cuda, dia_lists, name, value_dtype):
    """Rows listed at mask-word edges, every row listed, G from 1 to 32, m
    % 4 in {0, 1, 2, 3} (f32 and bf16 plane rows off 16-byte boundaries), 71
    diagonals: within the bound of both plain versions, into an
    output filled with NaN, bit-stable, B=8 columns equal to B=1."""
    A = dia_lists[name]
    d = diahybrid_from_csr(A, value_dtype=value_dtype).to(cuda)
    if name.startswith("lengths"):
        rem_len = d.remainder.row_lengths().cpu()[d.rem_rows.cpu().long()]
        assert d.offsets == (-1, 0, 1) and rem_len.tolist() == list(DIA_LENGTHS)
        assert fringe_lanes(d.remainder.nnz, d.rem_rows.numel()) == 8
    elif name == "long rows":
        assert fringe_lanes(d.remainder.nnz, d.rem_rows.numel()) == 32
    elif name.startswith("every row"):
        assert d.rem_rows.numel() == A.m and (d.n_diag == 0) == name.endswith("no plane")
    elif name == "71 diagonals":
        assert d.n_diag == 71 and d.remainder.nnz == 2
    r = d.remainder
    X = torch.randn((A.n, 8), generator=torch.Generator(cuda).manual_seed(5), device=cuda)
    k = A.row_lengths().to(cuda).float()
    for xb in (X[:, 0].contiguous(), X):
        out = torch.full((A.m,) + tuple(xb.shape[1:]), float("nan"), device=cuda)
        y = spmv_diahybrid_rows(d.diag_vals, d.offset_vec, d.rem_rows, d.rem_start, d.rem_mask,
                                r.col_idx, r.vals, xb, m=A.m, n=A.n, out=out)
        prod = ref.spmv_diahybrid(_abs_dia(d), xb.abs())
        bound = (2 * (k[:, None] if xb.ndim == 2 else k) + 2) * EPS32 * prod
        listed = ref.diahybrid_list_rows(d.diag_vals, d.offset_vec, d.rem_rows, d.rem_start,
                                         d.rem_mask, r.col_idx, r.vals, xb, m=A.m, n=A.n)
        for want in (ref.spmv_diahybrid(d, xb), listed):
            assert bool(((y - want).abs() <= bound).all())
        assert torch.equal(y, ops.spmv_diahybrid(d, xb))
    Y = ops.spmv_diahybrid(d, X)
    for j in range(8):
        assert torch.equal(Y[:, j], ops.spmv_diahybrid(d, X[:, j].contiguous()))


def test_dia_wrapper_rejects_what_the_kernel_does_not_take(cuda, diagonal):
    A = diagonal["fringe"]
    d = diahybrid_from_csr(A).to(cuda)
    r = d.remainder
    x = torch.randn(A.n, device=cuda)
    call = lambda **kw: spmv_diahybrid_rows(  # noqa: E731
        kw.get("vals", d.diag_vals), kw.get("offsets", d.offset_vec), kw.get("rows", d.rem_rows), kw.get("start", d.rem_start), kw.get("mask", d.rem_mask),
        kw.get("cols", r.col_idx), kw.get("rv", r.vals), kw.get("x", x), m=A.m,
        n=kw.get("n", A.n), out=kw.get("out"))
    with pytest.raises(TypeError):
        call(x=x.double())
    with pytest.raises(TypeError):
        call(x=x.half())
    x16 = x.to(torch.bfloat16)
    y16 = call(x=x16)
    assert y16.dtype == torch.bfloat16
    assert bool((((y16.double() - ref.spmv_diahybrid(d, x16.double())).abs()) <= (
        2.0 ** -8 + (2 * A.row_lengths().to(cuda) + 2) * EPS32)
        * ref.spmv_diahybrid(_abs_dia(d), x16.double().abs())).all())
    with pytest.raises(TypeError):
        call(x=x16, out=torch.empty(A.m, device=cuda))           # out not in x's dtype
    with pytest.raises(ValueError):
        call(x=torch.randn((A.n, 4), device=cuda)[:, ::2])       # not contiguous
    with pytest.raises(ValueError):
        call(x=x[:-1])                                            # wrong row count
    with pytest.raises(ValueError):
        call(n=A.n + 1)
    with pytest.raises(TypeError):
        call(vals=d.diag_vals.half())
    with pytest.raises(ValueError):
        call(vals=d.diag_vals[:, :-1])                            # wrong shape
    with pytest.raises(ValueError):
        call(offsets=d.offset_vec.cpu())                          # offsets on the host
    with pytest.raises(TypeError):
        call(offsets=d.offset_vec.long())
    with pytest.raises(ValueError):
        call(offsets=d.offset_vec[:-1])                           # an offset short
    with pytest.raises(ValueError):
        call(rows=d.rem_rows.cpu())                               # row list on the host
    with pytest.raises(TypeError):
        call(rows=d.rem_rows.long())
    with pytest.raises(ValueError):
        call(start=d.rem_start[:-1])
    with pytest.raises(TypeError):
        call(start=d.rem_start.long())
    with pytest.raises(ValueError):
        call(mask=d.rem_mask[:-1])
    with pytest.raises(TypeError):
        call(mask=d.rem_mask.to(torch.uint8))
    with pytest.raises(TypeError):
        call(cols=r.col_idx.long())
    with pytest.raises(ValueError):
        call(cols=r.col_idx[:-1])
    with pytest.raises(TypeError):
        call(rv=r.vals.double())
    with pytest.raises(ValueError):
        call(out=torch.empty(A.m - 1, device=cuda))
    before = spmv_diahybrid_rows.launches
    out = torch.full((A.m,), float("nan"), device=cuda)
    assert call(out=out) is out and bool(torch.isfinite(out).all())
    assert spmv_diahybrid_rows.launches == before + 1


def test_dia_route_launches_once_per_spmv(cuda, diagonal):
    op = prepare(diagonal["fringe"], device=cuda)
    assert op.backend == "diahybrid"
    assert op.dia.offset_vec.device.type == "cuda"
    before = spmv_diahybrid_rows.launches
    op(torch.randn(op.dia.n, device=cuda))
    op(torch.randn((op.dia.n, 8), device=cuda))
    op.apply_original(torch.randn(op.dia.n, device=cuda))
    assert spmv_diahybrid_rows.launches - before == 3


def test_dia_power_iteration_on_card_matches_cpu(cuda, diagonal):
    A = diagonal["fringe"]
    op_gpu = prepare(A, device=cuda)
    op_cpu = prepare(A, device="cpu")
    v0 = torch.from_numpy(np.random.default_rng(0).standard_normal(A.n).astype(np.float32))
    lam_gpu = power_iteration(op_gpu, A.n, iters=30, v0=v0.to(cuda), device=cuda)
    lam_cpu = power_iteration(op_cpu, A.n, iters=30, v0=v0, device="cpu")
    assert float(lam_gpu) == pytest.approx(float(lam_cpu), rel=1e-4)


# --- ELL baseline -------------------------------------------------------------


@pytest.fixture(scope="module")
def ell_cases():
    """Slab widths on both sides of a warp with m = 1003 (no multiple of any
    block size), bmwcra_1 at 1/64 (kmax 80) and an all-empty matrix."""
    cases = {f"kmax {k}": ell_width_matrix(1003, 700, k, seed=k)
             for k in (1, 3, 5, 7, 33, 73, 80, 129)}
    cases["bmwcra_1"] = load_suite(scale=64, ids=[16])["bmwcra_1"]
    cases["empty"] = CSRMatrix.fromdense(np.zeros((37, 20), np.float32))
    return cases


def _ell_bound(e, x):
    k = (e.vals != 0).sum(dim=1).to(torch.float32)
    return (2 * k + 2) * EPS32 * ref.ell_rows(e.col_idx, e.vals.abs(), x.abs())


@pytest.mark.parametrize("cut", [None, 3])
@pytest.mark.parametrize("name", ["kmax 1", "kmax 3", "kmax 5", "kmax 7", "kmax 33", "kmax 73",
                                  "kmax 80", "kmax 129", "bmwcra_1", "empty"])
def test_ell_kernel_matches_plain_and_is_bit_stable(cuda, ell_cases, name, cut):
    A = ell_cases[name]
    e = ell_from_csr(A, cut).to(cuda)
    x = torch.randn(A.n, generator=torch.Generator(cuda).manual_seed(9), device=cuda)
    y = ops.spmv_ell(e, x)
    assert bool(((y - ref.ell_rows(e.col_idx, e.vals, x)).abs() <= _ell_bound(e, x)).all())
    assert torch.equal(y, ops.spmv_ell(e, x))
    out = torch.full((A.m,), float("nan"), device=cuda)
    assert spmv_ell_rows(e.col_idx, e.vals, x, m=A.m, n=A.n, out=out) is out
    assert torch.equal(out, y)


def _shifted(t, by):
    """The same values in a view whose base lies ``by`` elements past a fresh
    allocation's (so not 16-byte aligned for by % 4 != 0)."""
    buf = torch.empty(t.numel() + by, dtype=t.dtype, device=t.device)
    view = buf[by:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("name", ["kmax 5", "kmax 73", "kmax 80", "bmwcra_1"])
@pytest.mark.parametrize("shift", [(0, 0), (1, 1)])
def test_ell_non_finite_x_reaches_the_plain_versions_rows(cuda, ell_cases, name, shift):
    """Padding slots are multiplied by x[0], as in the reference; on slabs
    whose rows are not 16-byte aligned too (kmax 5 and 73, shifted views)."""
    A = ell_cases[name]
    e = ell_from_csr(A).to(cuda)
    e = dataclasses.replace(e, col_idx=_shifted(e.col_idx, shift[0]),
                            vals=_shifted(e.vals, shift[1]))
    x = torch.randn(A.n, device=cuda)
    x[[0, 100, A.n - 1]] = torch.tensor([float("inf"), float("-inf"), float("nan")],
                                        device=cuda)
    y, want = ops.spmv_ell(e, x), ref.ell_rows(e.col_idx, e.vals, x)
    assert torch.equal(torch.isnan(y), torch.isnan(want))
    assert torch.equal(torch.isposinf(y), torch.isposinf(want))
    assert torch.equal(torch.isneginf(y), torch.isneginf(want))
    assert bool(torch.isnan(y).any())


@pytest.mark.parametrize("shift", [(1, 1), (2, 2), (3, 3), (1, 2), (0, 3)])
@pytest.mark.parametrize("name", ["kmax 7", "kmax 73", "bmwcra_1"])
def test_ell_kernel_on_views_off_16_byte_boundaries(cuda, ell_cases, name, shift):
    """Column and value arrays whose base pointers are not 16-byte aligned,
    at the same phase (vectors) and at different phases (slot by slot)."""
    A = ell_cases[name]
    e = ell_from_csr(A).to(cuda)
    x = torch.randn(A.n, generator=torch.Generator(cuda).manual_seed(4), device=cuda)
    col, vals = _shifted(e.col_idx, shift[0]), _shifted(e.vals, shift[1])
    assert vals.data_ptr() % 16 or col.data_ptr() % 16
    y = spmv_ell_rows(col, vals, x, m=A.m, n=A.n)
    assert bool(((y - ref.ell_rows(e.col_idx, e.vals, x)).abs() <= _ell_bound(e, x)).all())
    assert torch.equal(y, spmv_ell_rows(col, vals, x, m=A.m, n=A.n))


def test_ell_wrapper_rejects_what_the_kernel_does_not_take(cuda, ell_cases):
    A = ell_cases["kmax 33"]
    e = ell_from_csr(A).to(cuda)
    x = torch.randn(A.n, device=cuda)
    call = lambda **kw: spmv_ell_rows(  # noqa: E731
        kw.get("cols", e.col_idx), kw.get("vals", e.vals), kw.get("x", x), m=A.m,
        n=kw.get("n", A.n), out=kw.get("out"))
    with pytest.raises(TypeError):
        call(x=x.half())
    with pytest.raises(TypeError):
        call(x=x.double())
    x16 = x.to(torch.bfloat16)
    for vals in (e.vals, e.vals.to(torch.bfloat16)):
        y16 = call(x=x16, vals=vals)
        assert y16.dtype == torch.bfloat16
        assert bool(((y16.double() - ref.ell_rows(e.col_idx, vals, x16.double())).abs() <= (
            2.0 ** -8 + (2 * A.row_lengths().to(cuda) + 2) * EPS32)
            * ref.ell_rows(e.col_idx, vals.abs(), x16.double().abs())).all())
    with pytest.raises(TypeError):
        call(x=x16, out=torch.empty(A.m, device=cuda))           # out not in x's dtype
    with pytest.raises(ValueError):
        call(x=torch.randn((A.n, 2), device=cuda))                # no batched body
    with pytest.raises(ValueError):
        call(x=x[:-1])
    with pytest.raises(ValueError):
        call(n=A.n + 1)
    with pytest.raises(TypeError):
        call(vals=e.vals.half())
    with pytest.raises(ValueError):
        call(vals=e.vals.cpu())                                   # CPU mixed with CUDA
    with pytest.raises(ValueError):
        call(cols=e.col_idx.cpu())
    with pytest.raises(TypeError):
        call(cols=e.col_idx.long())
    with pytest.raises(ValueError):
        call(cols=e.col_idx[:, :-1])
    with pytest.raises(ValueError):
        call(vals=e.vals.t().contiguous().t())                    # not contiguous
    with pytest.raises(ValueError):
        call(out=torch.empty(A.m - 1, device=cuda))
    before = spmv_ell_rows.launches
    call()
    assert spmv_ell_rows.launches == before + 1


def test_ell_jacobi_on_card_matches_cpu(cuda, ell_cases):
    A = ell_cases["bmwcra_1"]
    e_cpu = ell_from_csr(A)
    e_gpu = e_cpu.to(cuda)
    diag = A.todense().diagonal().contiguous()
    b = torch.from_numpy(np.random.default_rng(0).standard_normal(A.n).astype(np.float32))
    before = spmv_ell_rows.launches
    x_gpu = jacobi_smoother(lambda v: ops.spmv_ell(e_gpu, v), diag.to(cuda), b.to(cuda),
                            iters=40)
    assert spmv_ell_rows.launches - before == 40
    x_cpu = jacobi_smoother(lambda v: ops.spmv_ell(e_cpu, v), diag, b, iters=40)
    rel = torch.linalg.norm(x_gpu.cpu() - x_cpu) / torch.linalg.norm(x_cpu)
    assert float(rel) <= 1e-5


# --- the CSR-k kernel's row-sorted and general paths --------------------------


def _in_order(view, x):
    """``ref.csrk_tile_rows_in_order`` over a monolithic or bucketed view, rows
    placed as the kernel places them."""
    kw = dict(rows_per_tile=view.rows_per_tile, window=view.window)
    if not hasattr(view, "buckets"):
        return ref.csrk_tile_rows_in_order(view.vals, view.local_col, view.local_row,
                                           view.win_block, x, view.val_scale,
                                           tile_nnz=view.tile_nnz, **kw)
    R = view.rows_per_tile
    out = torch.zeros((view.num_tiles, R) + tuple(x.shape[1:]), device=x.device)
    for b, ids in zip(view.buckets, view.tile_ids):
        y = ref.csrk_tile_rows_in_order(b.vals, b.local_col, b.local_row, b.win_block, x,
                                        b.val_scale, tile_nnz=b.tile_nnz, **kw)
        out[ids.long()] = y.reshape((b.num_tiles, R) + tuple(x.shape[1:]))
    return out.reshape((view.num_tiles * R,) + tuple(x.shape[1:]))


@pytest.mark.parametrize("value_dtype", ["f32", "bf16", "int8"])
def test_csrk_kernel_equals_in_order_plain_version(cuda, ecology, value_dtype):
    """Row-sorted tiles: each row is its products added from +0 in slot order."""
    op = prepare(ecology, device=cuda)
    tiles = tiles_from_csrk(op.csrk, value_dtype=value_dtype)
    X = torch.randn((ecology.n, 8), generator=torch.Generator(cuda).manual_seed(4), device=cuda)
    for view in (tiles.to(cuda), bucket_tiles(tiles).to(cuda)):
        R = view.rows_per_tile
        for xb in (X[:, 0].contiguous(), X):
            if hasattr(view, "buckets"):
                y = torch.full((view.num_tiles * R,) + tuple(xb.shape[1:]), float("nan"),
                               device=cuda)
                for b, ids in zip(view.buckets, view.tile_ids):
                    spmv_csrk_tiles(b.vals, b.local_col, b.local_row, b.win_block, xb,
                                    b.val_scale, rows_per_tile=R, window=view.window,
                                    tile_nnz=b.tile_nnz, tile_ids=ids, out=y)
            else:
                y = spmv_csrk_tiles(view.vals, view.local_col, view.local_row, view.win_block,
                                    xb, view.val_scale, rows_per_tile=R, window=view.window,
                                    tile_nnz=view.tile_nnz)
            assert torch.equal(y, _in_order(view, xb))


def _shuffled(tiles, seed):
    """The same tiles with each tile's real slots in a random order."""
    vals, lc, lr = tiles.vals.clone(), tiles.local_col.clone(), tiles.local_row.clone()
    rng = np.random.default_rng(seed)
    for t in range(tiles.num_tiles):
        k = int(tiles.tile_nnz[t])
        p = torch.from_numpy(rng.permutation(k))
        vals[t, :k], lc[t, :k], lr[t, :k] = vals[t, :k][p], lc[t, :k][p], lr[t, :k][p]
    return dataclasses.replace(tiles, vals=vals, local_col=lc, local_row=lr)


def _check_csrk_call(call, view, X, row_nnz, tile_nnz):
    """Within the plain version's bound and equal to the in-order version, at
    B = 1, 3 and 8; repeat launches and B = 8 columns bit-equal."""
    kw = dict(rows_per_tile=view.rows_per_tile, window=view.window)
    args = (view.vals, view.local_col, view.local_row, view.win_block)
    absv = (view.vals.abs(),) + args[1:]
    for xb in (X[:, 0].contiguous(), X[:, :3].contiguous(), X):
        y = call(xb)
        want = ref.csrk_tile_rows(*args, xb, view.val_scale, **kw)
        prod = ref.csrk_tile_rows(*absv, xb.abs(), view.val_scale, **kw)
        k = row_nnz.to(prod.dtype)
        bound = (2 * (k[:, None] if prod.ndim == 2 else k) + 2) * EPS32 * prod
        assert bool(((y - want).abs() <= bound).all())
        assert torch.equal(y, ref.csrk_tile_rows_in_order(*args, xb, view.val_scale,
                                                          tile_nnz=tile_nnz, **kw))
        assert torch.equal(y, call(xb))
    Y = call(X)
    for j in range(8):
        assert torch.equal(Y[:, j], call(X[:, j].contiguous()))


@pytest.mark.parametrize("value_dtype", ["f32", "int8"])
def test_csrk_unsorted_tiles_take_the_general_path(cuda, ecology, value_dtype):
    op = prepare(ecology, device=cuda)
    t = _shuffled(tiles_from_csrk(op.csrk, value_dtype=value_dtype), seed=5).to(cuda)
    row_nnz = torch.bincount(
        (t.local_row.long() + torch.arange(t.num_tiles, device=cuda)[:, None]
         * t.rows_per_tile)[torch.arange(t.slots, device=cuda)[None, :] < t.tile_nnz[:, None]],
        minlength=t.num_tiles * t.rows_per_tile)
    call = lambda xb: spmv_csrk_tiles(  # noqa: E731
        t.vals, t.local_col, t.local_row, t.win_block, xb, t.val_scale,
        rows_per_tile=t.rows_per_tile, window=t.window, tile_nnz=t.tile_nnz)
    X = torch.randn((ecology.n, 8), generator=torch.Generator(cuda).manual_seed(6), device=cuda)
    _check_csrk_call(call, t, X, row_nnz, t.tile_nnz)


def test_csrk_monolithic_view_without_tile_nnz(cuda, ecology):
    """All S slots: each tile's padding (value 0, row 0) follows its sorted
    real slots, so the kernel's general path sums them into row 0."""
    op = prepare(ecology, device=cuda, tile_layout="monolithic")
    t = op.tiles
    row_nnz = torch.bincount(
        (t.local_row.long() + torch.arange(t.num_tiles, device=cuda)[:, None]
         * t.rows_per_tile).reshape(-1), minlength=t.num_tiles * t.rows_per_tile)
    call = lambda xb: spmv_csrk_tiles(  # noqa: E731
        t.vals, t.local_col, t.local_row, t.win_block, xb, t.val_scale,
        rows_per_tile=t.rows_per_tile, window=t.window)
    X = torch.randn((ecology.n, 8), generator=torch.Generator(cuda).manual_seed(7), device=cuda)
    _check_csrk_call(call, t, X, row_nnz, None)
    y = call(X[:, 0].contiguous())
    assert torch.equal(y[: ecology.m], ops.spmv_csrk(t, X[:, 0].contiguous()))


# --- SELL-C-σ views of other widths and chunk heights -------------------------


@pytest.fixture(scope="module")
def sell_shapes():
    """Views whose widest chunk holds 1, 3, 5 or 127 lanes (W = 128), one
    whose rows reach 200 lanes (W = 256: two int8 scale groups), and C = 32."""
    cases = {f"width {k}": (ell_width_matrix(203, 300, k, seed=k), 8) for k in (1, 3, 5, 127)}
    cases["W 256"] = (ell_width_matrix(150, 400, 200, seed=7), 8)
    cases["C 32"] = (pareto_rows(1003, seed=5), 32)
    return cases


@pytest.mark.parametrize("value_dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("name", ["width 1", "width 3", "width 5", "width 127", "W 256",
                                  "C 32"])
def test_sellcs_kernel_on_other_widths_and_heights(cuda, sell_shapes, name, value_dtype):
    A, C = sell_shapes[name]
    s = sellcs_from_csr(A, C=C)
    tiles = tiles_from_sellcs(s, value_dtype=value_dtype).to(cuda)
    widths = s.chunk_widths()
    if name.startswith("width"):
        assert int(widths.max()) == int(name.split()[1]) and tiles.width == 128
    elif name == "W 256":
        assert tiles.width == 256 and int(widths.max()) > 128
        if value_dtype == "int8":
            assert tiles.val_scale.shape[-1] == 2
    else:
        assert tiles.C == 32
    row_nnz = A.row_lengths().to(cuda)
    X = torch.randn((A.n, 8), generator=torch.Generator(cuda).manual_seed(8), device=cuda)
    for xb in (X[:, 0].contiguous(), X[:, :3].contiguous(), X):
        Y = ops.spmv_sellcs(tiles, xb)
        err = (Y - ref.spmv_sellcs_tiles(tiles, xb)).abs()
        assert bool((err <= _sell_bound(tiles, xb, row_nnz)).all())
        assert torch.equal(Y, ops.spmv_sellcs(tiles, xb))
    Y = ops.spmv_sellcs(tiles, X)
    for j in range(8):
        assert torch.equal(Y[:, j], ops.spmv_sellcs(tiles, X[:, j].contiguous()))


def _misaligned(t):
    """A contiguous copy of ``t`` that starts one element past an aligned address."""
    out = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:].view(t.shape)
    return out.copy_(t)


@pytest.mark.parametrize("value_dtype", ["f32", "bf16", "int8"])
def test_sellcs_misaligned_view_gives_the_same_bits(cuda, irregular, value_dtype):
    """Values and columns that 16-byte loads cannot read are read slot by slot,
    in the same order."""
    A = irregular["bmwcra_1"]
    tiles = tiles_from_sellcs(sellcs_from_csr(A), value_dtype=value_dtype).to(cuda)
    odd = dataclasses.replace(tiles, vals=_misaligned(tiles.vals),
                              col_idx=_misaligned(tiles.col_idx))
    assert odd.col_idx.data_ptr() % 16 != 0
    X = torch.randn((A.n, 8), generator=torch.Generator(cuda).manual_seed(9), device=cuda)
    for xb in (X[:, 0].contiguous(), X):
        assert torch.equal(ops.spmv_sellcs(odd, xb), ops.spmv_sellcs(tiles, xb))


@pytest.mark.parametrize("per_group", [32, 1])
def test_sellcs_int8_scale_groups_smaller_than_a_batch(cuda, irregular, per_group):
    """int8 scales for every 32 lanes or every lane (the wrapper takes any
    group that divides W; containers use 128) take the one-scale-per-slot path."""
    A = irregular["bmwcra_1"]
    t = tiles_from_sellcs(sellcs_from_csr(A), value_dtype="int8")
    rep = 128 // per_group
    scale = t.val_scale.repeat_interleave(rep, dim=-1)
    scale = scale * (1 + 0.01 * torch.arange(scale.shape[-1], dtype=torch.float32))
    tiles = dataclasses.replace(t, val_scale=scale.contiguous()).to(cuda)
    row_nnz = A.row_lengths().to(cuda)
    X = torch.randn((A.n, 8), generator=torch.Generator(cuda).manual_seed(10), device=cuda)
    for xb in (X[:, 0].contiguous(), X):
        Y = ops.spmv_sellcs(tiles, xb)
        err = (Y - ref.spmv_sellcs_tiles(tiles, xb)).abs()
        assert bool((err <= _sell_bound(tiles, xb, row_nnz)).all())
        assert torch.equal(Y, ops.spmv_sellcs(tiles, xb))
    Y = ops.spmv_sellcs(tiles, X)
    for j in range(8):
        assert torch.equal(Y[:, j], ops.spmv_sellcs(tiles, X[:, j].contiguous()))


ENGINE_ROUTES = {
    "csrk": (lambda: grid_laplacian_2d(32, 32), spmv_csrk_tiles),
    "sellcs": (lambda: load_suite(scale=64, ids=[16])["bmwcra_1"], spmv_sellcs_chunks),
    "segsum": (lambda: powerlaw_zipf(2048), spmv_segsum_chunks),
    "diahybrid": (lambda: stencil_fringe(48), spmv_diahybrid_rows),
}


@pytest.mark.parametrize("route", list(ENGINE_ROUTES))
def test_serve_engine_burst_and_interleave_bit_equal_to_direct_calls(cuda, route):
    """The serving engine on the card: a burst of 12 ``[n]`` requests and an
    interleaved stream of widths 1-3 on one matrix of the route; every
    result bit-equal to a direct call of the cached operator and of a freshly
    prepared one, the route's kernel launched; a bf16 x served in bf16 with
    the bits of a direct call, a float16 x refused unqueued."""
    from repro_torch.serve import ServeEngine

    make, kernel = ENGINE_ROUTES[route]
    A = make()
    eng = ServeEngine(max_batch=8, format="auto")
    assert eng.device.type == "cuda"
    eng.add_matrix("A", A)
    gen = torch.Generator(cuda).manual_seed(5)
    rng = np.random.default_rng(5)
    sent = []
    kernel.launches = 0
    for _ in range(12):
        x = torch.randn(A.n, generator=gen, device=cuda)
        sent.append((x, eng.submit("A", x)))
    eng.drain()
    for _ in range(16):
        w = int(rng.integers(1, 4))
        x = torch.randn((A.n,) if w == 1 else (A.n, w), generator=gen, device=cuda)
        sent.append((x, eng.submit("A", x.cpu() if rng.random() < 0.3 else x)))
        if rng.random() < 0.5:
            eng.step()
    eng.drain()
    assert kernel.launches > 0
    assert eng.stats.requests_completed == len(sent) and eng.stats.batches_dispatched < len(sent)
    op, hit = eng.cache.get_or_prepare(A)
    fresh = prepare(A, format="auto", spmm_width=8)
    assert hit and op.backend == route == fresh.backend
    for x, fut in sent:
        y = fut.result()
        assert y.device.type == "cuda"
        assert torch.equal(y, op(x)) and torch.equal(y, fresh(x))
    # a coalesced [n] result is a strided view of its block: fed back, it
    # is served as its contiguous copy is
    y = sent[1][1].result()
    assert not y.is_contiguous() and A.m == A.n
    again = eng.submit("A", y)
    eng.drain()
    assert torch.equal(again.result(), op(y.contiguous())) and torch.equal(op(y), again.result())
    x16 = torch.randn((A.n, 2), generator=gen, device=cuda).to(torch.bfloat16)
    futs = [eng.submit("A", x16), eng.submit("A", x16[:, 0].contiguous()),
            eng.submit("A", x16.float())]
    eng.drain()
    assert [f.result().dtype for f in futs] == [torch.bfloat16] * 2 + [torch.float32]
    assert torch.equal(futs[0].result(), op(x16)) and torch.equal(futs[0].result(), fresh(x16))
    assert torch.equal(futs[1].result(), op(x16[:, 0].contiguous()))
    with pytest.raises(TypeError, match="float32"):
        eng.submit("A", torch.ones(A.n, dtype=torch.float16, device=cuda))
    assert eng.queue_depth == 0


# --- bf16 x on the card: each route's kernel (chip_smoke.py phase (a)) -------

BF16_CASES = [(route, dt) for route in ("csrk", "csrk remainder", "sellcs", "segsum")
              for dt in ("f32", "bf16", "int8")]
BF16_CASES += [(route, dt) for route in ("diahybrid", "ell") for dt in ("f32", "bf16")]


@pytest.mark.parametrize("route,value_dtype", BF16_CASES)
def test_bf16_x_kernel_matches_float64_and_plain(cuda, route, value_dtype):
    """bf16 x at B = 1 and 8 (ELL: 1): y bf16, each row within (r 2^-8 +
    (2k+2) eps32)(|A||x|)_i of a float64 product and (k+2) 2^-7 (|A||x|)_i
    of the plain version, repeat launches and B=8 columns bit-equal; CSR-k's
    tile rows bit-equal to ``ref.csrk_tile_rows_in_order``'s bf16 form."""
    cs = _chip_smoke()
    if route.startswith("csrk"):
        kw = {}
        if route == "csrk":
            csrk = prepare(load_suite(scale=256, ids=[8])["ecology1"], device=cuda).csrk
        else:
            csrk, kw = cs.far_entries_csrk(), {"window": 128}
        tiles = tiles_from_csrk(csrk, value_dtype=value_dtype, **kw)
        assert route == "csrk" or tiles.remainder_nnz == 64
        folded = torch.zeros(csrk.csr.shape[0], dtype=torch.bool, device=cuda)
        folded[tiles.rem_row.long().to(cuda)] = True
        row_nnz = csrk.csr.row_lengths().to(cuda)
        for run, plain, view in ((ops.spmv_csrk, ref.spmv_csrk_tiles, tiles.to(cuda)),
                                 (ops.spmv_csrk_bucketed, ref.spmv_csrk_buckets,
                                  bucket_tiles(tiles).to(cuda))):
            abs_view = cs.abs_tiles(view)
            cs.bf16x_checks(route, lambda x: run(view, x), lambda x: plain(view, x),
                            lambda x: plain(abs_view, x), csrk.csr.shape[1], row_nnz, 3,
                            folded=folded, in_order=lambda x: cs.csrk_in_order(view, x))
        return
    A = {"sellcs": lambda: load_suite(scale=64, ids=[16])["bmwcra_1"],
         "segsum": lambda: powerlaw_zipf(2048), "diahybrid": lambda: stencil_fringe(64),
         "ell": lambda: load_suite(scale=64, ids=[16])["bmwcra_1"]}[route]()
    row_nnz = A.row_lengths().to(cuda)
    if route == "ell":
        e = ell_from_csr(A).to(cuda)
        vals = e.vals.to(torch.bfloat16) if value_dtype == "bf16" else e.vals
        cs.ell_bf16x(dataclasses.replace(e, vals=vals), A.n, f"ell {value_dtype}")
        return
    if route == "sellcs":
        c = tiles_from_sellcs(sellcs_from_csr(A), value_dtype=value_dtype).to(cuda)
        abs_c = dataclasses.replace(c, vals=c.vals.abs())
        run, plain, abs_plain = (lambda x: ops.spmv_sellcs(c, x),
                                 lambda x: ref.spmv_sellcs_tiles(c, x),
                                 lambda x: ref.spmv_sellcs_tiles(abs_c, x))
    elif route == "segsum":
        c = segsum_from_csr(A, value_dtype=value_dtype).to(cuda)
        abs_c = dataclasses.replace(c, vals=c.vals.abs())
        run, plain, abs_plain = (lambda x: cs.segsum_into_nan(c, x),
                                 lambda x: ref.spmv_segsum(c, x),
                                 lambda x: ref.spmv_segsum(abs_c, x))
    else:
        c = diahybrid_from_csr(A, value_dtype=value_dtype).to(cuda)
        abs_c = _abs_dia(c)
        run, plain, abs_plain = (lambda x: cs.dia_into_nan(c, x),
                                 lambda x: ref.spmv_diahybrid(c, x),
                                 lambda x: ref.spmv_diahybrid(abs_c, x))
    cs.bf16x_checks(f"{route} {value_dtype}", run, plain, abs_plain, A.n, row_nnz, 3)


@pytest.mark.parametrize("route", ["csrk", "sellcs", "segsum", "diahybrid"])
def test_prepared_bf16_x_padding_gives_lone_launch_bits(cuda, route):
    """``spmm_width=8``: a bf16 [n] x and each column of a zero-padded bf16
    block give the bits of their lone launch, through ``__call__`` and
    ``apply_original``."""
    make, _ = ENGINE_ROUTES[route]
    A = make()
    padded = prepare(A, device=cuda, format="auto", spmm_width=8)
    lone = prepare(A, device=cuda, format="auto")
    assert padded.backend == lone.backend == route
    X = torch.randn((A.n, 3), generator=torch.Generator(cuda).manual_seed(6),
                    device=cuda).to(torch.bfloat16)
    for call in ("__call__", "apply_original"):
        Y = getattr(padded, call)(X)
        assert Y.dtype == torch.bfloat16
        for j in range(3):
            xj = X[:, j].contiguous()
            want = getattr(lone, call)(xj)
            assert torch.equal(Y[:, j], want) and torch.equal(getattr(padded, call)(xj), want)


# --- the distributed layer: D row-block shards on the card ------------------


def _sharded_cases(cuda, route):
    """(single-device operator, source matrix) of a route, on the card."""
    if route == "csrk":
        A = load_suite(scale=256, ids=[8])["ecology1"]
        op = prepare(A, device=cuda, format="csrk", tile_layout="monolithic")
        return op, op.csrk.csr
    A = load_suite(scale=64, ids=[16])["bmwcra_1"]
    return prepare(A, device=cuda, format="sellcs"), A


@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("route", ["csrk", "sellcs"])
def test_sharded_bit_equal_to_single_device_on_card(cuda, route, D):
    """Every strategy, overlap on and off, B ∈ {1, 8}: the sharded operator's
    launches give the single-device operator's bits."""
    from repro_torch.core.distributed import shard_prepared
    from repro_torch.launch.mesh import make_host_mesh

    base, src = _sharded_cases(cuda, route)
    kernel = spmv_csrk_tiles if route == "csrk" else spmv_sellcs_chunks
    X = torch.randn((src.n, 8), generator=torch.Generator(cuda).manual_seed(11), device=cuda)
    xs = (X[:, 0].contiguous(), X)
    want = [base(x) for x in xs]
    mesh = make_host_mesh(D)
    assert mesh.devices == (torch.device("cuda", 0),) * D or torch.cuda.device_count() > 1
    seen = set()
    for strategy in ("auto", "replicated", "allgather", "halo"):
        for overlap in (None, True, False):
            op = shard_prepared(base, mesh, x_strategy=strategy, A=src, halo_overlap=overlap)
            for x, y in zip(xs, want):
                kernel.launches = 0
                assert torch.equal(op(x), y), (strategy, overlap, x.shape)
                assert kernel.launches >= 1
            seen.add((op.x_strategy, op.overlap))
    assert ("halo", True) in seen and ("halo", False) in seen


@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("route", ["csrk", "sellcs"])
def test_sharded_bf16_x_bit_equal_to_single_device_on_card(cuda, route, D):
    """bf16 x through every strategy, overlap on and off, B in {1, 8}: a bf16
    y with the single-device operator's bits; a float16 x refused."""
    from repro_torch.core.distributed import shard_prepared
    from repro_torch.launch.mesh import make_host_mesh

    base, src = _sharded_cases(cuda, route)
    X = torch.randn((src.n, 8), generator=torch.Generator(cuda).manual_seed(12),
                    device=cuda).to(torch.bfloat16)
    xs = (X[:, 0].contiguous(), X)
    want = [base(x) for x in xs]
    for strategy in ("auto", "replicated", "allgather", "halo"):
        for overlap in (None, True, False):
            op = shard_prepared(base, make_host_mesh(D), x_strategy=strategy, A=src,
                                halo_overlap=overlap)
            for x, y in zip(xs, want):
                got = op(x)
                assert got.dtype == torch.bfloat16 and torch.equal(got, y), (strategy, overlap)
            with pytest.raises(TypeError):
                op(X.half())


def test_sellcs_out_with_a_chunk_subset_on_card(cuda, irregular):
    """The SELL-C-σ kernel with ``out=`` over a chunk subset writes exactly
    those chunks' rows, bit-equal to the full launch, and no other row."""
    A = irregular["pareto"]
    tiles = tiles_from_sellcs(sellcs_from_csr(A), value_dtype="f32").to(cuda)
    T, C = tiles.num_chunks, tiles.C
    X = torch.randn((A.n, 8), generator=torch.Generator(cuda).manual_seed(12), device=cuda)
    sel = torch.arange(0, T, 3, device=cuda)
    rows = tiles.row_perm.view(T, C)[sel].reshape(-1)
    real = rows[rows < A.m].long()
    for x in (X[:, 0].contiguous(), X):
        full = ops.spmv_sellcs(tiles, x)
        out = torch.full_like(full, float("nan"))
        got = spmv_sellcs_chunks(tiles.vals[sel], tiles.col_idx[sel], rows.contiguous(),
                                 tiles.chunk_width[sel], x, m=A.m, out=out)
        assert got is out and torch.equal(out[real], full[real])
        mask = torch.ones(A.m, dtype=torch.bool, device=cuda)
        mask[real] = False
        assert bool(torch.isnan(out[mask]).all())


@pytest.mark.parametrize("route", ["csrk", "sellcs"])
def test_sharded_call_replays_in_a_cuda_graph(cuda, route):
    """A sharded call (overlap plan, D = 4) captured in a CUDA graph replays
    to the eager call's bits: nothing in it waits on the host."""
    from repro_torch.core.distributed import shard_prepared
    from repro_torch.launch.mesh import make_host_mesh

    base, src = _sharded_cases(cuda, route)
    op = shard_prepared(base, make_host_mesh(4), x_strategy="halo", A=src, halo_overlap=True)
    assert op.overlap
    x = torch.randn(src.n, generator=torch.Generator(cuda).manual_seed(13), device=cuda)
    want = op(x)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        op(x)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = op(x)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(y, want) and torch.equal(want, base(x))


# --- the LM tree's serving path (chip_smoke.py phase 21) -----------------------


def _chip_smoke():
    """chip_smoke.py as a module: phase 21's helpers are shared with it."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch", [
    "rwkv6-3b", "qwen1.5-32b", "qwen2-7b", "deepseek-7b", "granite-3-2b", "kimi-k2-1t-a32b",
    "llama4-scout-17b-a16e", "jamba-v0.1-52b", "internvl2-76b", "seamless-m4t-medium"])
def test_lm_smoke_config_on_card_matches_cpu(cuda, arch):
    """f32 with full-precision matmuls: the forward logits and 8 cached
    decode steps, card and CPU within 1e-4 + 1e-4 |cpu|."""
    from repro_torch.configs.registry import get_smoke_config

    assert torch.get_float32_matmul_precision() == "highest"
    assert not torch.backends.cuda.matmul.allow_tf32
    cs = _chip_smoke()
    cfg = get_smoke_config(arch)
    with torch.inference_mode():
        cpu = cs.lm_smoke_pair(cfg, torch.device("cpu"), 0)
        card = cs.lm_smoke_pair(cfg, cuda, 0)
    for a, b in zip(cpu, card):
        assert a.shape == b.shape and bool(torch.isfinite(b).all())
        torch.testing.assert_close(b, a, atol=1e-4, rtol=1e-4)


def test_lm_granite_full_width_decode_matches_forward(cuda):
    """granite-3-2b at full width and depth, a prompt past the 1,024-row kv
    chunk into the cache, then greedy steps.  At f32 (TF32 off) every step's
    logits lie within 2e-3 + 2e-3 |logit| of one full forward's over prompt
    + generated tokens, whose argmax is the generated token wherever its
    top-2 margin exceeds twice that, at one position at least
    (``chip_smoke.lm_check_f32``, which raises otherwise); two bf16 runs
    from one seed give the same tokens, none a padded vocabulary row."""
    from repro_torch.configs.registry import get_config

    assert not torch.backends.cuda.matmul.allow_tf32
    cs = _chip_smoke()
    cfg = get_config("granite-3-2b")
    B, P, G = 2, 1056, 8

    def bf16_tokens():
        with torch.inference_mode():
            params, prompts = cs.lm_seeded(cfg, 0, B, P, cuda)
            return cs.lm_generate(cfg, params, prompts, G)[1]

    toks = bf16_tokens()
    assert int(toks.max()) < cfg.vocab
    torch.cuda.empty_cache()
    assert torch.equal(toks, bf16_tokens())
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params, prompts = cs.lm_seeded(cfg32, 0, B, P, cuda)
    out = cs.lm_check_f32(cfg32, params, prompts, G, "[granite-3-2b]")
    assert out["drops"] == 0 and 0 < out["checked"] == out["agree"]


# --- the LM tree's training path (chip_smoke.py phase 22) ----------------------


@pytest.mark.parametrize("arch", ["granite-3-2b", "kimi-k2-1t-a32b", "rwkv6-3b"])
def test_train_smoke_config_on_card_matches_cpu(cuda, arch):
    """f32 with full-precision matmuls: loss, aux, grad_norm and every
    gradient leaf card against CPU within 1e-4 max|cpu| + 1e-6, a
    microbatches=2 step, and compress_grads (bit-equal) and adamw.apply
    (4 ulps) fed the same gradients (``chip_smoke.train_parity``, which
    raises otherwise)."""
    assert not torch.backends.cuda.matmul.allow_tf32
    out = _chip_smoke().train_parity(arch)
    assert out["worst_rel"] <= 1e-4 and out["leaves"] > 0


def test_train_restart_on_card(cuda):
    """The reference's restart test shape on the card: 10 + restart + 10
    steps within rtol 1e-4 of 20 straight, a failure_at run restarted by
    the supervisor, bf16 leaves through a checkpoint bit for bit
    (``chip_smoke.train_restart_check``)."""
    out = _chip_smoke().train_restart_check("cuda")
    assert abs(out["straight"] - out["resumed"]) <= 1e-4 * abs(out["resumed"])


# --- the sharded LM path (chip_smoke.py phase 23) ------------------------------


@pytest.mark.parametrize("arch,layers", [("qwen2-7b", 2), ("jamba-v0.1-52b", None),
                                         ("rwkv6-3b", None)])
def test_sharded_step_on_card_shards_matches_cpu_shards(cuda, arch, layers):
    """f32 with full-precision matmuls: one 2 x 4 sharded train step (jamba's
    MoE layers expert-parallel, its mamba mixers and rwkv6's channel mix
    tensor-parallel) on card shards and on CPU shards from the
    same weights: loss, grad_norm, every averaged gradient leaf within 1e-4
    of its max + 1e-6, every updated leaf within 1e-4 of its max where the
    gradient is determined (``chip_smoke.updated_within``)."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.util.sharded import Sharded
    from repro_torch.util.tree import leaves

    assert not torch.backends.cuda.matmul.allow_tf32
    cs = _chip_smoke()
    cfg = get_smoke_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, layers=layers)
    cpu = cs.sharded_smoke_step(cfg, "cpu", 0)
    card = cs.sharded_smoke_step(cfg, "cuda", 0)
    for k in ("loss", "grad_norm", "lr", "moe_aux"):
        torch.testing.assert_close(card["metrics"][k], cpu["metrics"][k], rtol=1e-4, atol=1e-6)
    for a, b in zip(leaves(card["grads"]), leaves(cpu["grads"])):
        assert not isinstance(a, Sharded) and a.device.type == "cpu"
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max()) + 1e-6
    cs.updated_within(arch, card["params"], cpu["params"], cpu["grads"], cpu["lr"])


def test_moe_apply_ep_on_card_shards_matches_cpu_shards(cuda):
    """Expert parallelism alone, 8 experts over model 4, tokens over data 2,
    the expert pieces on card shards: within 1e-4 of the CPU shards'."""
    from repro_torch.models import moe as MOE

    params = MOE.moe_init(torch.Generator().manual_seed(0), 64, 128, 8)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((4, 16, 64)).astype(np.float32))
    cs = _chip_smoke()
    out = {}
    for dev in ("cpu", "cuda"):
        mesh = cs.sharded_mesh(dev)
        pieces = {k: v.to(mesh.devices[0]) if k == "router" else
                  tuple(p.to(mesh.device_at(data=0, model=m))
                        for m, p in enumerate(torch.chunk(v, 4)))
                  for k, v in params.items()}
        y, aux = MOE.moe_apply_ep(pieces, x.to(mesh.devices[0]), num_experts=8, top_k=2,
                                  mesh=mesh)
        out[dev] = (y.cpu(), aux.cpu())
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(out["cuda"][1], out["cpu"][1], rtol=1e-4, atol=1e-6)


def test_sharded_restart_on_card(cuda):
    """8 data shards on the card, a failure, a rebuild to 6 and a resume from
    the checkpoint: the resumed losses equal an uninterrupted 6-shard run
    from that checkpoint (``chip_smoke.sharded_restart_check``)."""
    out = _chip_smoke().sharded_restart_check("cuda")
    assert max(out["gaps"]) <= 1e-4


@pytest.mark.parametrize("B", [4, 3])
def test_sharded_serve_on_card_shards_matches_cpu_shards(cuda, B):
    """granite smoke at f32 (TF32 off), params, cache and token rows in
    pieces on 2 x 4 card shards and on CPU shards from the same weights: the
    prefill step, a prefill into the cache and 8 teacher-forced decode
    steps (``chip_smoke.sharded_forced``), and every cache piece, within
    1e-4 + 1e-4 |cpu| (the card-vs-CPU bar of
    ``test_lm_smoke_config_on_card_matches_cpu``).  B = 4 runs one unit a data shard
    with the cache split along S (2 kv heads over model 4), B = 3 one unit
    with the whole batch on the first shard."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.launch import sharded as SHD
    from repro_torch.launch import steps as STEPS
    from repro_torch.models import transformer as TF
    from repro_torch.util.tree import leaves

    assert not torch.backends.cuda.matmul.allow_tf32
    cs = _chip_smoke()
    cfg = get_smoke_config("granite-3-2b")
    tokens = torch.from_numpy(np.random.default_rng(B).integers(0, cfg.vocab, (B, 40))
                              .astype(np.int32))
    out = {}
    for dev in ("cpu", "cuda"):
        mesh = cs.sharded_mesh(dev)
        sp = SHD.shard_tree_(TF.init_params(torch.Generator().manual_seed(0), cfg), mesh)
        t = tokens.to(mesh.devices[0])
        with torch.inference_mode():
            pre = STEPS.make_prefill_step(cfg, mesh)(sp, SHD.batch_rows(t[:, :32], mesh))
            steps, cache, _ = cs.sharded_forced(cfg, sp, t[:, :32], t, mesh)
        out[dev] = [pre.cpu(), steps.cpu()] + [p.cpu() for s in leaves(cache) for p in s.pieces]
    assert len(out["cuda"]) == len(out["cpu"]) > 2
    for a, b in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def test_examples_on_card(cuda, capsys):
    """The three examples at small sizes on the card: quickstart's CSR-k
    product within 1e-4 of plain CSR through the CUDA kernel."""
    from repro_torch.launch import quickstart, serve_lm, train_lm

    launches = spmv_csrk_tiles.launches
    assert quickstart.main(["--grid", "32"]) == 0
    out = capsys.readouterr().out
    assert float(out.split("max |CSR-k − CSR| = ")[1].split()[0]) < 1e-4 and "on cuda" in out
    assert spmv_csrk_tiles.launches > launches
    assert serve_lm.main(["--batch", "2", "--prompt-len", "16", "--gen", "4"]) == 0
    assert train_lm.main(["--steps", "3", "--layers", "2", "--d-model", "96", "--vocab", "512",
                          "--batch", "4", "--seq", "32"]) == 0
    out = capsys.readouterr().out
    assert out.count("on cuda") == 2


def test_dry_run_leaves_card_memory_alone(cuda):
    """A fake run of a smoke train step on a 2 × 4 ``meta`` mesh allocates
    nothing on the card."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch.mesh import make_meta_mesh
    from repro_torch.models.config import ShapeConfig

    before = torch.cuda.memory_allocated()
    r = DR.dryrun_config(get_smoke_config("jamba-v0.1-52b"), ShapeConfig("t", 32, 4, "train"),
                         make_meta_mesh((2, 4), ("data", "model")))
    assert r["collective_bytes"]["all-gather"] > 0
    assert torch.cuda.memory_allocated() == before
