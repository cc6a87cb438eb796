"""Tests of the port's CUDA kernel that need a card (marker ``cuda``).

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

from repro_torch.configs.spmv_suite import load_suite
from repro_torch.core import cg, prepare
from repro_torch.kernels import ops, ref
from repro_torch.kernels.spmv_csrk import spmv_csrk_tiles
from repro_torch.sparse import CSRMatrix, bucket_tiles, tiles_from_csrk

pytestmark = pytest.mark.cuda

EPS32 = float(np.finfo(np.float32).eps)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
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
