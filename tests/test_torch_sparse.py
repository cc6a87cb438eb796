"""The port's host-side build is bit-identical to the reference's.

Every ``load_suite(scale=512)`` matrix is built by both packages; the CSR
arrays, fingerprints, Band-k and RCM permutations, statistics, format
selection, tuner outputs and the CSR-k tile views (f32, bf16, int8;
monolithic and bucketed) must be equal bit for bit, because they all come
from deterministic numpy.
"""
import dataclasses

import numpy as np
import pytest

import repro.core.ordering as j_ord
import repro.core.tuner as j_tuner
import repro.sparse as js
from repro.configs.spmv_suite import SUITE as J_SUITE
from repro.configs.spmv_suite import load_suite as j_load_suite

import repro_torch.core.ordering as t_ord
import repro_torch.core.tuner as t_tuner
import repro_torch.sparse as ts
from repro_torch.configs.spmv_suite import SUITE as T_SUITE
from repro_torch.configs.spmv_suite import load_suite as t_load_suite
from repro_torch.sparse.convert import to_numpy

SCALE = 512
NAMES = [e.name for e in J_SUITE]
DEVICES = ("ampere", "volta", "tpu_v5e", "cpu")


@pytest.fixture(scope="module")
def suite():
    """name → (port CSR, reference CSR)."""
    t, j = t_load_suite(SCALE), j_load_suite(SCALE)
    return {name: (t[name], j[name]) for name in NAMES}


@pytest.fixture(scope="module")
def banded(suite):
    """name → (perm, port P A Pᵀ, reference P A Pᵀ), built on first use."""
    cache = {}

    def get(name):
        if name not in cache:
            A, B = suite[name]
            perm = t_ord.bandk(A, k=3)
            cache[name] = (perm, A.symmetric_permute(perm), B.symmetric_permute(perm))
        return cache[name]

    return get


def _same_csr(A, B):
    assert A.shape == tuple(B.shape)
    np.testing.assert_array_equal(to_numpy(A.row_ptr), np.asarray(B.row_ptr))
    np.testing.assert_array_equal(to_numpy(A.col_idx), np.asarray(B.col_idx))
    np.testing.assert_array_equal(to_numpy(A.vals), np.asarray(B.vals))
    assert to_numpy(A.vals).dtype == np.asarray(B.vals).dtype


def _bits(a):
    """Array bits for comparison (bf16 as its uint16 pattern)."""
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _same_tiles(t, j):
    for f in ("vals", "local_col", "local_row", "win_block", "rem_row", "rem_col",
              "rem_val", "val_scale", "tile_nnz"):
        a, b = getattr(t, f), getattr(j, f)
        assert (a is None) == (b is None), f
        if a is not None:
            ref = _bits(b)
            got = to_numpy(a)
            assert got.dtype.itemsize == ref.dtype.itemsize, f
            np.testing.assert_array_equal(got, ref, err_msg=f)
    assert (t.shape, t.rows_per_tile, t.window, t.value_dtype) == (
        tuple(j.shape), j.rows_per_tile, j.window, j.value_dtype)


def test_suite_catalogue_matches():
    assert [(e.id, e.name, e.paper_n, e.paper_nnz, e.family) for e in T_SUITE] == [
        (e.id, e.name, e.paper_n, e.paper_nnz, e.family) for e in J_SUITE]


@pytest.mark.parametrize("name", NAMES)
def test_csr_and_fingerprint_identical(suite, name):
    A, B = suite[name]
    _same_csr(A, B)
    assert A.fingerprint() == B.fingerprint()
    np.testing.assert_array_equal(to_numpy(A.row_lengths()), np.asarray(B.row_lengths()))


def test_fingerprint_hashes_numpy_dtype_names():
    dense = np.array([[1.0, 0.0], [2.0, 3.0]], np.float32)
    A, B = ts.CSRMatrix.fromdense(dense), js.CSRMatrix.fromdense(dense)
    assert A.fingerprint() == B.fingerprint()
    A2 = ts.CSRMatrix.fromdense(dense * 2)
    assert A2.fingerprint() != A.fingerprint()


@pytest.mark.parametrize("name", NAMES)
def test_orderings_identical(suite, banded, name):
    A, B = suite[name]
    perm, Ar, Br = banded(name)
    np.testing.assert_array_equal(perm, j_ord.bandk(B, k=3))
    np.testing.assert_array_equal(t_ord.rcm(A), j_ord.rcm(B))
    _same_csr(Ar, Br)
    assert t_ord.bandwidth(Ar) == j_ord.bandwidth(Br)


@pytest.mark.parametrize("name", NAMES)
def test_stats_and_selection_identical(suite, banded, name):
    A, B = suite[name]
    _, Ar, Br = banded(name)
    for X, Y in ((A, B), (Ar, Br)):
        st, sj = ts.compute_stats(X), js.compute_stats(Y)
        assert st.as_dict() == sj.as_dict()
        for dev in DEVICES:
            assert ts.select_format(st, dev) == js.select_format(sj, dev)


@pytest.mark.parametrize("device", DEVICES)
def test_tune_identical(suite, device):
    for name in NAMES:
        A, _ = suite[name]
        got = t_tuner.tune(A.rdensity, device=device, m=A.m)
        want = j_tuner.tune(A.rdensity, device=device, m=A.m)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), name


def test_tune_unknown_device_falls_through_to_tpu():
    assert t_tuner.tune(5.0, device="h100", m=4096) == t_tuner.tune_tpu(5.0, m=4096)
    assert dataclasses.asdict(t_tuner.tune(5.0, device="h100", m=4096)) == \
        dataclasses.asdict(j_tuner.tune(5.0, device="h100", m=4096))


@pytest.mark.parametrize("value_dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("name", NAMES)
def test_tiles_and_buckets_identical(banded, name, value_dtype):
    _, Ar, Br = banded(name)
    p = t_tuner.tune(Ar.rdensity, device="ampere", m=Ar.m)
    kt = ts.build_csrk(Ar, srs=p.srs, ssrs=p.ssrs, k=3)
    kj = js.build_csrk(Br, srs=p.srs, ssrs=p.ssrs, k=3)
    np.testing.assert_array_equal(to_numpy(kt.sr_ptr), np.asarray(kj.sr_ptr))
    np.testing.assert_array_equal(to_numpy(kt.ssr_ptr), np.asarray(kj.ssr_ptr))
    tt = ts.tiles_from_csrk(kt, value_dtype=value_dtype)
    tj = js.tiles_from_csrk(kj, value_dtype=value_dtype)
    _same_tiles(tt, tj)
    assert tt.modeled_bytes() == tj.modeled_bytes()
    assert tt.padding_overhead() == pytest.approx(tj.padding_overhead(), rel=1e-12)
    bt, bj = ts.bucket_tiles(tt), js.bucket_tiles(tj)
    assert bt.bucket_slots() == bj.bucket_slots()
    assert bt.num_tiles == bj.num_tiles
    for a, b, ia, ib in zip(bt.buckets, bj.buckets, bt.tile_ids, bj.tile_ids):
        _same_tiles(a, b)
        np.testing.assert_array_equal(to_numpy(ia), np.asarray(ib))
    assert bt.modeled_bytes() == bj.modeled_bytes()


def test_csrk_overhead_matches():
    A = t_load_suite(SCALE, ids=[8])["ecology1"]
    B = j_load_suite(SCALE, ids=[8])["ecology1"]
    for k in (2, 3):
        kt = ts.build_csrk(A, srs=15, ssrs=7, k=k)
        kj = js.build_csrk(B, srs=15, ssrs=7, k=k)
        assert kt.overhead_bytes() == kj.overhead_bytes()
        assert kt.overhead_fraction() == kj.overhead_fraction()


def test_out_of_window_tiles_identical():
    """A narrow window sends far entries to the COO remainder in both."""
    dense = np.zeros((64, 1024), np.float32)
    for i in range(64):
        dense[i, i] = 2.0
        dense[i, 600 + (i * 37) % 400] = 1.0
    kt = ts.build_csrk(ts.CSRMatrix.fromdense(dense), srs=4, ssrs=2, k=3)
    kj = js.build_csrk(js.CSRMatrix.fromdense(dense), srs=4, ssrs=2, k=3)
    for dt in ("f32", "bf16", "int8"):
        tt = ts.tiles_from_csrk(kt, window=128, value_dtype=dt)
        tj = js.tiles_from_csrk(kj, window=128, value_dtype=dt)
        assert tt.remainder_nnz == 64
        _same_tiles(tt, tj)


def test_int8_quantizer_identical(rng):
    from repro.optim.compress import quantize_int8_grouped as jq
    from repro_torch.optim.compress import dequantize_int8_grouped, quantize_int8_grouped

    v = rng.standard_normal((3, 256)).astype(np.float32)
    v[1, :128] = 0.0
    q, s = quantize_int8_grouped(v)
    qj, sj = jq(v)
    np.testing.assert_array_equal(q, qj)
    np.testing.assert_array_equal(s, sj)
    assert s[1, 0] == 1.0
    np.testing.assert_allclose(dequantize_int8_grouped(q, s), v, atol=float(s.max()))
