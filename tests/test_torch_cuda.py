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
from repro_torch.kernels.spmv_diahybrid import spmv_diahybrid_rows
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
        kw.get("x", x), kw.get("scale"), rows_per_tile=t.rows_per_tile, window=t.window)
    with pytest.raises(TypeError):
        call(x=x.double())
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
    y = spmv_segsum_chunks(seg.vals, seg.col_idx, seg.local_seg, seg.seg_row, seg.carry, x,
                           m=A.m, nnz=seg.nnz, out=out)
    assert y is out and bool(torch.isfinite(y).all())
    assert bool((y[empty] == 0).all())
    assert torch.equal(y, ops.spmv_segsum(seg, x))
    nothing = segsum_from_csr(CSRMatrix.fromdense(np.zeros((5, 3), np.float32))).to(cuda)
    out = torch.full((5,), float("nan"), device=cuda)
    spmv_segsum_chunks(nothing.vals, nothing.col_idx, nothing.local_seg, nothing.seg_row,
                       nothing.carry, torch.ones(3, device=cuda), m=5, nnz=0, out=out)
    assert torch.equal(out, torch.zeros(5, device=cuda))


def test_segsum_wrapper_rejects_what_the_kernel_does_not_take(cuda, powerlaw):
    A = powerlaw["powerlaw"]
    s = segsum_from_csr(A).to(cuda)
    x = torch.randn(A.n, device=cuda)
    call = lambda **kw: spmv_segsum_chunks(  # noqa: E731
        kw.get("vals", s.vals), kw.get("cols", s.col_idx), kw.get("lseg", s.local_seg),
        kw.get("seg_row", s.seg_row), kw.get("carry", s.carry), kw.get("x", x),
        kw.get("scale"), m=A.m,
        nnz=kw.get("nnz", s.nnz))
    with pytest.raises(TypeError):
        call(x=x.double())
    with pytest.raises(TypeError):
        call(x=x.to(torch.bfloat16))
    with pytest.raises(ValueError):
        call(x=torch.randn((A.n, 4), device=cuda)[:, ::2])      # not contiguous
    with pytest.raises(ValueError):
        call(lseg=s.local_seg[:, :128])                          # wrong shape
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
    before = spmv_segsum_chunks.launches
    call()
    assert spmv_segsum_chunks.launches == before + 1


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


def test_dia_wrapper_rejects_what_the_kernel_does_not_take(cuda, diagonal):
    A = diagonal["fringe"]
    d = diahybrid_from_csr(A).to(cuda)
    r = d.remainder
    x = torch.randn(A.n, device=cuda)
    call = lambda **kw: spmv_diahybrid_rows(  # noqa: E731
        kw.get("vals", d.diag_vals), kw.get("offsets", d.offset_vec), kw.get("rp", r.row_ptr),
        kw.get("cols", r.col_idx), kw.get("rv", r.vals), kw.get("x", x), m=A.m,
        n=kw.get("n", A.n), out=kw.get("out"))
    with pytest.raises(TypeError):
        call(x=x.double())
    with pytest.raises(TypeError):
        call(x=x.to(torch.bfloat16))
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
        call(offsets=d.offset_vec[:-1])
    with pytest.raises(ValueError):
        call(rp=r.row_ptr[:-1])
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
    cases = {f"kmax {k}": ell_width_matrix(1003, 700, k, seed=k) for k in (1, 5, 33, 80, 129)}
    cases["bmwcra_1"] = load_suite(scale=64, ids=[16])["bmwcra_1"]
    cases["empty"] = CSRMatrix.fromdense(np.zeros((37, 20), np.float32))
    return cases


def _ell_bound(e, x):
    k = (e.vals != 0).sum(dim=1).to(torch.float32)
    return (2 * k + 2) * EPS32 * ref.ell_rows(e.col_idx, e.vals.abs(), x.abs())


@pytest.mark.parametrize("cut", [None, 3])
@pytest.mark.parametrize("name", ["kmax 1", "kmax 5", "kmax 33", "kmax 80", "kmax 129",
                                  "bmwcra_1", "empty"])
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


@pytest.mark.parametrize("name", ["kmax 5", "kmax 80", "bmwcra_1"])
def test_ell_non_finite_x_reaches_the_plain_versions_rows(cuda, ell_cases, name):
    """Padding slots are multiplied by x[0], as in the reference."""
    A = ell_cases[name]
    e = ell_from_csr(A).to(cuda)
    x = torch.randn(A.n, device=cuda)
    x[[0, 100, A.n - 1]] = torch.tensor([float("inf"), float("-inf"), float("nan")],
                                        device=cuda)
    y, want = ops.spmv_ell(e, x), ref.ell_rows(e.col_idx, e.vals, x)
    assert torch.equal(torch.isnan(y), torch.isnan(want))
    assert torch.equal(torch.isposinf(y), torch.isposinf(want))
    assert torch.equal(torch.isneginf(y), torch.isneginf(want))
    assert bool(torch.isnan(y).any())


def test_ell_wrapper_rejects_what_the_kernel_does_not_take(cuda, ell_cases):
    A = ell_cases["kmax 33"]
    e = ell_from_csr(A).to(cuda)
    x = torch.randn(A.n, device=cuda)
    call = lambda **kw: spmv_ell_rows(  # noqa: E731
        kw.get("cols", e.col_idx), kw.get("vals", e.vals), kw.get("x", x), m=A.m,
        n=kw.get("n", A.n), out=kw.get("out"))
    with pytest.raises(TypeError):
        call(x=x.to(torch.bfloat16))
    with pytest.raises(TypeError):
        call(x=x.double())
    with pytest.raises(ValueError):
        call(x=torch.randn((A.n, 2), device=cuda))                # no batched body
    with pytest.raises(ValueError):
        call(x=x[:-1])
    with pytest.raises(ValueError):
        call(n=A.n + 1)
    with pytest.raises(TypeError):
        call(vals=e.vals.to(torch.bfloat16))
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
