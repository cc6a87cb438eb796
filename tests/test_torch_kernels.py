"""The port's plain kernel versions against the reference's oracles and its
Pallas kernel (run in interpret mode, as tests/test_kernels.py runs it).

The same tiles (built by the reference, carried over with
``repro_torch.sparse.convert``) go through both packages.  The two sum in
different orders, so rows are compared under the per-row rounding bound

    |y_port − y_ref| ≤ (2·k_i + 2) · eps_f32 · (|A|·|x|)_i

with k_i the row's stored entries; bits are never compared across packages.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

import repro.sparse as js
from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref

from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as t_ref
from repro_torch.kernels.spmv_csrk import spmv_csrk_tiles
from repro_torch.sparse.convert import (
    buckets_from_numpy,
    csr_from_numpy,
    tiles_from_numpy,
    to_numpy,
)

EPS32 = float(np.finfo(np.float32).eps)


def _tiles_kwargs(t):
    return dict(
        vals=np.asarray(t.vals), local_col=np.asarray(t.local_col),
        local_row=np.asarray(t.local_row), win_block=np.asarray(t.win_block),
        rem_row=np.asarray(t.rem_row), rem_col=np.asarray(t.rem_col),
        rem_val=np.asarray(t.rem_val), shape=tuple(t.shape),
        rows_per_tile=t.rows_per_tile, window=t.window,
        val_scale=None if t.val_scale is None else np.asarray(t.val_scale),
        tile_nnz=None if t.tile_nnz is None else np.asarray(t.tile_nnz),
        value_dtype=t.value_dtype,
    )


def port_tiles(t):
    return tiles_from_numpy(**_tiles_kwargs(t))


def port_buckets(b):
    return buckets_from_numpy(
        [_tiles_kwargs(x) for x in b.buckets], [np.asarray(i) for i in b.tile_ids],
        np.asarray(b.rem_row), np.asarray(b.rem_col), np.asarray(b.rem_val),
        shape=tuple(b.shape), rows_per_tile=b.rows_per_tile, window=b.window,
        num_tiles=b.num_tiles, value_dtype=b.value_dtype,
    )


def abs_dense(tiles_j, m, n):
    """|A| as the tile view stores it (dequantized), plus the remainder."""
    v = np.asarray(j_ref._tile_vals_f32(tiles_j.vals, tiles_j.val_scale))
    cols = np.asarray(tiles_j.win_block)[:, None] * tiles_j.window + np.asarray(tiles_j.local_col)
    rows = np.asarray(tiles_j.local_row) + np.arange(v.shape[0])[:, None] * tiles_j.rows_per_tile
    out = np.zeros((v.shape[0] * tiles_j.rows_per_tile, max(n, int(cols.max()) + 1)))
    np.add.at(out, (rows.ravel(), cols.ravel()), np.abs(v).ravel())
    out = out[:m, :n]
    np.add.at(out, (np.asarray(tiles_j.rem_row), np.asarray(tiles_j.rem_col)),
              np.abs(np.asarray(tiles_j.rem_val)))
    return out


def assert_within_bound(y, y_ref, absA, x, row_nnz):
    y = np.asarray(y, np.float64)
    y_ref = np.asarray(y_ref, np.float64)
    assert y.shape == y_ref.shape
    prod = absA @ np.abs(np.asarray(x, np.float64))
    k = np.asarray(row_nnz, np.float64)
    if prod.ndim == 2:
        k = k[:, None]
    bound = (2 * k + 2) * EPS32 * prod
    bad = np.abs(y - y_ref) > bound
    assert not bad.any(), f"{bad.sum()} rows outside the bound; max err {np.abs(y - y_ref).max()}"


def _case(rng, m, n, density):
    dense = ((rng.random((m, n)) < density) * rng.standard_normal((m, n))).astype(np.float32)
    return dense


def _build(dense, srs, ssrs, value_dtype, window=None):
    kj = js.build_csrk(js.CSRMatrix.fromdense(dense), srs=srs, ssrs=ssrs, k=3)
    tj = js.tiles_from_csrk(kj, window=window, value_dtype=value_dtype)
    return tj, js.bucket_tiles(tj)


CASES = {
    "64x64": (64, 64, 0.1, 4, 2),
    "256x256": (256, 256, 0.05, 8, 4),   # several slot buckets
}


@pytest.mark.parametrize("B", [None, 3])
@pytest.mark.parametrize("value_dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("case", list(CASES))
def test_tile_paths_match_reference(rng, case, value_dtype, B):
    m, n, density, srs, ssrs = CASES[case]
    dense = _case(rng, m, n, density)
    tj, bj = _build(dense, srs, ssrs, value_dtype)
    x = rng.standard_normal((n,) if B is None else (n, B)).astype(np.float32)
    xt = torch.from_numpy(x)
    absA = abs_dense(tj, m, n)
    row_nnz = (dense != 0).sum(axis=1)

    y_oracle = np.asarray(j_ref.spmv_csrk_tiles(tj, jnp.asarray(x)))
    y_pallas = np.asarray(j_ops.spmv_csrk(tj, jnp.asarray(x), interpret=True))
    y_pallas_b = np.asarray(j_ops.spmv_csrk_bucketed(bj, jnp.asarray(x), interpret=True))
    tt, bt = port_tiles(tj), port_buckets(bj)
    outs = {
        "ops.spmv_csrk": t_ops.spmv_csrk(tt, xt),
        "ops.spmv_csrk_bucketed": t_ops.spmv_csrk_bucketed(bt, xt),
        "ref.spmv_csrk_tiles": t_ref.spmv_csrk_tiles(tt, xt),
        "ref.spmv_csrk_buckets": t_ref.spmv_csrk_buckets(bt, xt),
    }
    for y in outs.values():
        for want in (y_oracle, y_pallas, y_pallas_b):
            assert_within_bound(y.numpy(), want, absA, x, row_nnz)
    # monolithic and bucketed read the same slots in the same order
    assert torch.equal(outs["ops.spmv_csrk"], outs["ops.spmv_csrk_bucketed"])


def far_entries_matrix():
    """64×1024 with a near diagonal and one far entry per row: with a 128-column
    window every tile's far entries fall outside its 2-block window."""
    dense = np.zeros((64, 1024), np.float32)
    for i in range(64):
        dense[i, i] = 2.0
        dense[i, 600 + (i * 37) % 400] = 1.0
    return dense


@pytest.mark.parametrize("B", [None, 2])
@pytest.mark.parametrize("value_dtype", ["f32", "int8"])
def test_out_of_window_remainder(rng, value_dtype, B):
    """Out-of-window entries ride the COO remainder; the port folds them."""
    dense = far_entries_matrix()
    tj, bj = _build(dense, 4, 2, value_dtype, window=128)
    assert tj.remainder_nnz == 64
    x = rng.standard_normal((1024,) if B is None else (1024, B)).astype(np.float32)
    absA = abs_dense(tj, 64, 1024)
    row_nnz = (dense != 0).sum(axis=1)
    wants = (np.asarray(j_ref.spmv_csrk_tiles(tj, jnp.asarray(x))),
             np.asarray(j_ops.spmv_csrk(tj, jnp.asarray(x), interpret=True)))
    tt, bt = port_tiles(tj), port_buckets(bj)
    for y in (t_ops.spmv_csrk(tt, torch.from_numpy(x)),
              t_ops.spmv_csrk_bucketed(bt, torch.from_numpy(x)),
              t_ref.spmv_csrk_buckets(bt, torch.from_numpy(x))):
        for want in wants:
            assert_within_bound(y.numpy(), want, absA, x, row_nnz)


def test_fold_remainder_duplicate_rows_in_entry_order():
    y = torch.zeros(4)
    rem_row = torch.tensor([2, 0, 2, 2], dtype=torch.int32)
    rem_col = torch.tensor([0, 1, 2, 3], dtype=torch.int32)
    rem_val = torch.tensor([1.0, 2.0, 3.0, 4.0])
    x = torch.tensor([1.0, 10.0, 100.0, 1000.0])
    out = t_ops._fold_remainder(y, rem_row, rem_col, rem_val, x)
    np.testing.assert_array_equal(out.numpy(), [20.0, 0.0, 4301.0, 0.0])


@pytest.mark.parametrize("B", [None, 4])
def test_csr_oracles_match(rng, B):
    dense = _case(rng, 70, 50, 0.2)
    Aj = js.CSRMatrix.fromdense(dense)
    At = csr_from_numpy(np.asarray(Aj.row_ptr), np.asarray(Aj.col_idx),
                        np.asarray(Aj.vals), Aj.shape)
    x = rng.standard_normal((50,) if B is None else (50, B)).astype(np.float32)
    if B is None:
        y, want = t_ref.spmv_csr(At, torch.from_numpy(x)), j_ref.spmv_csr(Aj, jnp.asarray(x))
    else:
        y, want = t_ref.spmm_csr(At, torch.from_numpy(x)), j_ref.spmm_csr(Aj, jnp.asarray(x))
    assert_within_bound(y.numpy(), np.asarray(want), np.abs(dense), x, (dense != 0).sum(1))


@pytest.mark.parametrize("value_dtype", ["f32", "bf16", "int8"])
def test_tile_value_dequant_is_exact(rng, value_dtype):
    tj, _ = _build(_case(rng, 64, 64, 0.2), 4, 2, value_dtype)
    got = t_ref._tile_vals_f32(port_tiles(tj).vals, port_tiles(tj).val_scale)
    want = np.asarray(j_ref._tile_vals_f32(tj.vals, tj.val_scale))
    np.testing.assert_array_equal(got.numpy(), want)


def test_pad_and_combine_match_reference(rng):
    x = rng.standard_normal((300, 2)).astype(np.float32)
    np.testing.assert_array_equal(
        t_ops._pad_x_to_blocks(torch.from_numpy(x), 128).numpy(),
        np.asarray(j_ops._pad_x_to_blocks(jnp.asarray(x), 128)))
    parts = [rng.standard_normal((6, 2)).astype(np.float32),
             rng.standard_normal((4, 2)).astype(np.float32)]
    ids = [np.array([2, 0, 5], np.int32), np.array([1, 4], np.int32)]   # 5 = dump slot
    got = t_ops.combine_tile_rows([torch.from_numpy(p) for p in parts],
                                  [torch.from_numpy(i) for i in ids], 5, 2)
    want = j_ops.combine_tile_rows([jnp.asarray(p) for p in parts],
                                   [jnp.asarray(i) for i in ids], 5, 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_wrapper_takes_plain_version_on_cpu(rng):
    """CPU tensors run the plain version and leave the launch count alone."""
    tj, bj = _build(_case(rng, 64, 64, 0.1), 4, 2, "int8")
    tt = port_tiles(tj)
    x = torch.from_numpy(rng.standard_normal(64).astype(np.float32))
    before = spmv_csrk_tiles.launches
    y = spmv_csrk_tiles(tt.vals, tt.local_col, tt.local_row, tt.win_block, x,
                        tt.val_scale, rows_per_tile=tt.rows_per_tile, window=tt.window,
                        tile_nnz=tt.tile_nnz)
    want = t_ref.csrk_tile_rows(tt.vals, tt.local_col, tt.local_row, tt.win_block, x,
                                tt.val_scale, rows_per_tile=tt.rows_per_tile,
                                window=tt.window)
    assert torch.equal(y, want)
    bt = port_buckets(bj)
    out = torch.full((bt.num_tiles * bt.rows_per_tile,), float("nan"))
    for b, ids in zip(bt.buckets, bt.tile_ids):
        spmv_csrk_tiles(b.vals, b.local_col, b.local_row, b.win_block, x, b.val_scale,
                        rows_per_tile=bt.rows_per_tile, window=bt.window,
                        tile_ids=ids, out=out)
    assert torch.equal(out, want)
    assert spmv_csrk_tiles.launches == before
    with pytest.raises(ValueError):
        spmv_csrk_tiles(tt.vals, tt.local_col, tt.local_row, tt.win_block, x,
                        rows_per_tile=tt.rows_per_tile, window=tt.window, out=out)


def test_convert_round_trips_bf16_bits(rng):
    tj, _ = _build(_case(rng, 32, 32, 0.3), 4, 2, "bf16")
    tt = port_tiles(tj)
    assert tt.vals.dtype == torch.bfloat16
    np.testing.assert_array_equal(to_numpy(tt.vals), np.asarray(tj.vals).view(np.uint16))
