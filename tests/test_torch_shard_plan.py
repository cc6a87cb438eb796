"""The port's distributed host plan against the reference's.

``repro_torch.core.distributed`` keeps the reference's host-side logic: the
per-tile column reach, ``classify_tile_reach``, the halo edges and byte
model, the strategy choice, ``shard_csr`` and the per-shard statistics.  The
mesh-free cases of ``tests/test_shard_plan.py`` and
``tests/test_sharded_prepare.py::test_compute_shard_stats_partitions`` are
ported here; then, for CSR-k, SELL-C-σ (halo kept and demoted) and CSR-2
operators at D ∈ {2, 4}, every ``x_strategy`` and ``halo_overlap`` setting,
the port's ``ShardPlan``, ``shard_stats``, ``shard_backends``, ``shard_csr``
arrays and per-shard kernel arrays must equal the reference's exactly.

The reference's ``shard_prepared`` reads only ``int(mesh.shape[axis])`` from
its mesh until it is called, so its plan is built here with a stand-in mesh
and never called: no fake JAX devices are needed.
"""
import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  one torch thread per test process

from repro.configs.spmv_suite import grid_laplacian_2d as j_grid
from repro.core import distributed as j_dist
from repro.core.spmv import prepare as j_prepare
from repro.kernels.ops import combine_tile_rows as j_combine
from repro.sparse import classify_tile_reach as j_classify
from repro.sparse import compute_shard_stats as j_shard_stats
from repro.sparse import csr_from_coo as j_csr_from_coo
from repro.sparse.coo import COOMatrix as JCOO
from repro.sparse.csr import CSRMatrix as JCSR

from repro_torch.configs.spmv_suite import grid_laplacian_2d
from repro_torch.core import distributed as t_dist
from repro_torch.core.spmv import prepare as t_prepare
from repro_torch.kernels.ops import combine_tile_rows
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.sparse import CSRMatrix, classify_tile_reach, compute_shard_stats
from repro_torch.sparse import csr_from_coo
from repro_torch.sparse.coo import COOMatrix
from repro_torch.sparse.stats import MatrixStats, compute_stats


def _coo_pair(n, rows, cols, vals):
    r, c = np.asarray(rows, np.int32), np.asarray(cols, np.int32)
    v = np.asarray(vals, np.float32)
    t = csr_from_coo(COOMatrix(torch.from_numpy(r), torch.from_numpy(c),
                               torch.from_numpy(v), (n, n)))
    j = j_csr_from_coo(JCOO(jnp.asarray(r), jnp.asarray(c), jnp.asarray(v), (n, n)))
    return t, j


def banded_irregular(n, band=48, seed=7):
    """Row variance ≫ 10 (routes to SELL-C-σ) but banded: halo is kept."""
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for i in range(n):
        deg = int(rng.integers(1, 24))
        lo, hi = max(0, i - band), min(n, i + band)
        cs = rng.choice(np.arange(lo, hi), size=min(deg, hi - lo), replace=False)
        rows += [i] * len(cs)
        cols += list(cs)
    return _coo_pair(n, rows, cols, rng.standard_normal(len(rows)))


def scattered_irregular(n, seed=3):
    """Irregular and unbanded: a halo request demotes to allgather."""
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for i in range(n):
        deg = int(rng.integers(1, 24))
        cs = rng.choice(n, size=deg, replace=False)
        rows += [i] * deg
        cols += list(cs)
    return _coo_pair(n, rows, cols, rng.standard_normal(len(rows)))


# ---------------------------------------------------------------------------
# host-side: classification, reach, edges, byte model (no mesh)
# ---------------------------------------------------------------------------


def test_classify_tile_reach_hand_pinned():
    """2 shards × 3 tiles, rows_per_shard=300 (the reference's hand case)."""
    lo = np.array([0, 80, 190, 290, 350, 2**31 - 1])
    hi = np.array([90, 250, 310, 420, 560, -1])
    interior, boundary, frac = classify_tile_reach(
        lo, hi, tiles_per_shard=3, rows_per_shard=300, num_shards=2
    )
    assert [list(i) for i in interior] == [[0, 1], [1, 2]]
    assert [list(b) for b in boundary] == [[2], [0]]
    assert frac == 3 / 5
    ji, jb, jf = j_classify(lo, hi, tiles_per_shard=3, rows_per_shard=300, num_shards=2)
    assert all(np.array_equal(a, b) and a.dtype == b.dtype for a, b in zip(interior, ji))
    assert all(np.array_equal(a, b) for a, b in zip(boundary, jb)) and frac == jf

    _, _, f1 = classify_tile_reach(
        np.array([0, 310]), np.array([100, 640]),
        tiles_per_shard=1, rows_per_shard=300, num_shards=2)
    assert f1 == 0.5
    _, _, f_empty = classify_tile_reach(
        np.array([2**31 - 1]), np.array([-1]),
        tiles_per_shard=1, rows_per_shard=300, num_shards=1)
    assert f_empty == 1.0


@pytest.mark.parametrize("value_dtype", ["f32", "bf16", "int8"])
def test_col_reach_csrk_and_sellcs(value_dtype):
    """col_reach reports real (val != 0) column extents per tile, as the
    reference's does on the same operator."""
    A, Aj = grid_laplacian_2d(24, 24), j_grid(24, 24)
    op = t_prepare(A, "ampere", device="cpu", format="csrk", tile_layout="monolithic",
                   value_dtype=value_dtype)
    opj = j_prepare(Aj, "ampere", format="csrk", tile_layout="monolithic",
                    value_dtype=value_dtype)
    lo, hi = op.tiles.col_reach()
    jlo, jhi = opj.tiles.col_reach()
    np.testing.assert_array_equal(lo, jlo)
    np.testing.assert_array_equal(hi, jhi)
    assert lo.shape == (op.tiles.num_tiles,)
    R = op.tiles.rows_per_tile
    rp = op.csrk.csr.row_ptr.numpy()
    ci = op.csrk.csr.col_idx.numpy()
    m = op.csrk.shape[0]
    if value_dtype == "f32":
        for t in range(op.tiles.num_tiles):
            r0, r1 = t * R, min((t + 1) * R, m)
            cols = ci[rp[r0]:rp[r1]]
            if len(cols):
                assert lo[t] == cols.min() and hi[t] == cols.max(), t
            else:
                assert hi[t] < lo[t], t
    bw = compute_stats(op.csrk.csr).bandwidth
    t_rows = np.arange(op.tiles.num_tiles) * R
    real = hi >= lo
    assert (lo[real] >= np.maximum(t_rows[real] - bw, 0)).all()

    op2 = t_prepare(A, "ampere", device="cpu", format="sellcs", value_dtype=value_dtype)
    op2j = j_prepare(Aj, "ampere", format="sellcs", value_dtype=value_dtype)
    lo2, hi2 = op2.sell_tiles.col_reach()
    jlo2, jhi2 = op2j.sell_tiles.col_reach()
    np.testing.assert_array_equal(lo2, jlo2)
    np.testing.assert_array_equal(hi2, jhi2)


def test_halo_edges_and_byte_model():
    """Need-based schedule: only sides with reach get an edge; bytes follow."""
    ShardPlan = t_dist.ShardPlan
    reach = [(0, 299), (300, 599), (600, 899)]
    assert t_dist._halo_edges(reach, 300, 3) == ((), ())
    assert t_dist._required_halo(reach, 300, 3) == 0
    assert ShardPlan("halo", 3, 300, halo=128).collective_bytes() == 0

    reach = [(0, 310), (290, 610), (590, 899)]
    left, right = t_dist._halo_edges(reach, 300, 3)
    assert left == ((0, 1), (1, 2)) and right == ((1, 0), (2, 1))
    assert (left, right) == j_dist._halo_edges(reach, 300, 3)
    assert t_dist._required_halo(reach, 300, 3) == 11 == j_dist._required_halo(reach, 300, 3)
    plan = ShardPlan("halo", 3, 300, halo=128, left_edges=left, right_edges=right)
    assert plan.collective_bytes() == 128 * 4 * 4
    assert plan.collective_bytes(B=8) == 8 * plan.collective_bytes()
    assert not plan.is_degenerate

    left, right = t_dist._halo_edges([None, (250, 640), None], 300, 3)
    assert left == ((0, 1),) and right == ((2, 1),)
    ag = ShardPlan("allgather", 4, 256)
    assert ag.is_degenerate
    assert ag.collective_bytes() == 3 * 256 * 4 * 4
    assert ShardPlan("replicated", 4, 256).collective_bytes() == 0
    assert t_dist._ring_edges(4) == j_dist._ring_edges(4)


def test_estimate_interior_fraction_and_strategy_selector():
    st = MatrixStats(m=4096, n=4096, nnz=20000, rdensity=5.0, row_var=0.1,
                     row_max=5, bandwidth=65)
    assert t_dist.estimate_interior_fraction(st, 1, 4096) == 1.0
    assert abs(t_dist.estimate_interior_fraction(st, 4, 1024) - 0.75) < 1e-9
    wide = dataclasses.replace(st, bandwidth=4000)
    assert t_dist.estimate_interior_fraction(wide, 4, 1024) == 0.0
    for s in (st, wide, dataclasses.replace(st, n=t_dist.REPLICATE_N_MAX + 1, bandwidth=4000)):
        for D, Rs in ((1, 4096), (4, 1024), (4, 64)):
            assert t_dist.select_x_strategy(s, D, Rs) == j_dist.select_x_strategy(s, D, Rs)
            assert (t_dist.estimate_interior_fraction(s, D, Rs)
                    == j_dist.estimate_interior_fraction(s, D, Rs))
    assert (t_dist.X_STRATEGIES, t_dist.REPLICATE_N_MAX, t_dist.OVERLAP_MIN_INTERIOR) == (
        j_dist.X_STRATEGIES, j_dist.REPLICATE_N_MAX, j_dist.OVERLAP_MIN_INTERIOR)


def test_combine_tile_rows_scatter():
    """Subset outputs land at home rows; dump-slot ids are dropped."""
    R, T = 4, 5
    y_a = torch.arange(2 * R, dtype=torch.float32) + 100      # tiles 3, 0
    y_b = torch.arange(2 * R, dtype=torch.float32) + 200      # tile 2, pad->dump
    ids = [torch.tensor([3, 0], dtype=torch.int32), torch.tensor([2, T], dtype=torch.int32)]
    out = combine_tile_rows([y_a, y_b], ids, T, R)
    assert out.shape == (T * R,)
    j_out = j_combine([jnp.asarray(y_a.numpy()), jnp.asarray(y_b.numpy())],
                      [jnp.asarray(i.numpy()) for i in ids], T, R)
    np.testing.assert_array_equal(out.numpy(), np.asarray(j_out))
    out2 = combine_tile_rows([torch.ones((R, 3))], [torch.tensor([1], dtype=torch.int32)], 3, R)
    assert out2.shape == (3 * R, 3) and float(out2[R:2 * R].sum()) == R * 3


def test_compute_shard_stats_partitions():
    """Trailing shards past m get empty stats; an explicit rows_per_shard
    drives the partition; every shard's stats equal the reference's."""
    A = CSRMatrix(torch.arange(10, dtype=torch.int32), torch.arange(9, dtype=torch.int32),
                  torch.ones(9), (9, 9))
    Aj = JCSR(jnp.arange(10, dtype=jnp.int32), jnp.arange(9, dtype=jnp.int32),
              jnp.ones(9, jnp.float32), (9, 9))
    stats = compute_shard_stats(A, 8)
    assert len(stats) == 8 and sum(s.nnz for s in stats) == 9
    assert stats[-1].m == 0 and stats[-1].nnz == 0
    assert [s.as_dict() for s in stats] == [s.as_dict() for s in j_shard_stats(Aj, 8)]

    B, Bj = grid_laplacian_2d(16, 16), j_grid(16, 16)
    st = compute_shard_stats(B, 2, rows_per_shard=200)
    assert st[0].m == 200 and st[1].m == 56 and sum(s.nnz for s in st) == B.nnz
    assert ([s.as_dict() for s in st]
            == [s.as_dict() for s in j_shard_stats(Bj, 2, rows_per_shard=200)])
    sl = B.row_slice(100, 140)
    assert sl.shape == (40, B.n) and sl.nnz == int(B.row_ptr[140] - B.row_ptr[100])


@pytest.mark.parametrize("D", [2, 3, 4, 8])
@pytest.mark.parametrize("name", ["grid", "banded"])
def test_shard_csr_matches_reference(name, D):
    if name == "grid":
        A, Aj = grid_laplacian_2d(20, 20), j_grid(20, 20)
    else:
        A, Aj = banded_irregular(300)
    S, Sj = t_dist.shard_csr(A, D), j_dist.shard_csr(Aj, D)
    for f in ("row_ptr", "col_idx", "vals"):
        np.testing.assert_array_equal(getattr(S, f).numpy(), np.asarray(getattr(Sj, f)))
        assert getattr(S, f).numpy().dtype == np.asarray(getattr(Sj, f)).dtype
    assert (S.shape, S.rows_per_shard, S.halo) == (tuple(Sj.shape), Sj.rows_per_shard, Sj.halo)


# ---------------------------------------------------------------------------
# the whole plan of a prepared operator, against the reference's
# ---------------------------------------------------------------------------

_MATRICES = {
    "grid": lambda: (grid_laplacian_2d(48, 48), j_grid(48, 48)),
    "banded": lambda: banded_irregular(1024),
    "scattered": lambda: scattered_irregular(1024),
}
_BASES = {}


def _bases(name, value_dtype):
    """(port base, reference base, port A, reference A), built once each."""
    key = (name, value_dtype)
    if key not in _BASES:
        if name == "csr2":
            A, Aj = _MATRICES["grid"]()
            model = "cpu"
        else:
            A, Aj = _MATRICES[name]()
            model = "ampere"
        fmt = "csrk" if name in ("grid", "csr2") else "sellcs"
        op = t_prepare(A, model, device="cpu", format=fmt, tile_layout="monolithic",
                       value_dtype=value_dtype)
        opj = j_prepare(Aj, model, format=fmt, tile_layout="monolithic",
                        value_dtype=value_dtype)
        _BASES[key] = (op, opj, A, Aj)
    return _BASES[key]


def _host(a):
    a = np.asarray(a.float() if isinstance(a, torch.Tensor) and a.dtype == torch.bfloat16
                   else a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


_PORT_KEYS = {"csrk": ("vals", "lcol", "lrow", "win", "scale"),
              "sellcs": ("vals", "cols", "scale")}

_CASES = ([(n, "f32", D, s, ov) for n in ("grid", "banded", "scattered", "csr2")
           for D in (2, 4) for s in ("auto",) + t_dist.X_STRATEGIES
           for ov in (None, True, False)]
          + [(n, vd, D, s, None) for n in ("grid", "banded") for vd in ("bf16", "int8")
             for D in (2, 4) for s in ("auto",) + t_dist.X_STRATEGIES])


@pytest.mark.parametrize("name,value_dtype,D,strategy,overlap", _CASES)
def test_plan_matches_reference(name, value_dtype, D, strategy, overlap):
    op, opj, A, Aj = _bases(name, value_dtype)
    src = op.csrk.csr if op.backend == "csrk" else A
    srcj = opj.csrk.csr if opj.backend == "csrk" else Aj
    sh = t_dist.shard_prepared(op, make_host_mesh(D, device="cpu"), x_strategy=strategy,
                               A=src, halo_overlap=overlap)
    shj = j_dist.shard_prepared(opj, types.SimpleNamespace(shape={"data": D}),
                                x_strategy=strategy, A=srcj, halo_overlap=overlap)
    p, pj = sh.plan, shj.plan
    for f in dataclasses.fields(pj):
        a, b = getattr(p, f.name), getattr(pj, f.name)
        if f.name in ("interior_ids", "boundary_ids"):
            assert len(a) == len(b)
            assert all(np.array_equal(u, v) and u.dtype == v.dtype for u, v in zip(a, b))
        else:
            assert a == b, f.name
    assert p.collective_bytes() == pj.collective_bytes()
    assert sh.collective_bytes_per_call(B=8) == shj.collective_bytes_per_call(B=8)
    assert sh.x_strategy_requested == shj.x_strategy_requested
    assert sh.shard_backends == shj.shard_backends
    assert [s.as_dict() for s in sh.shard_stats] == [s.as_dict() for s in shj.shard_stats]
    assert (sh.backend, sh.num_shards, sh.x_strategy, sh.rows_per_shard, sh.halo,
            sh.overlap, sh.interior_fraction) == (
        shj.backend, shj.num_shards, shj.x_strategy, shj.rows_per_shard, shj.halo,
        shj.overlap, shj.interior_fraction)
    np.testing.assert_array_equal(sh.perm, shj.perm)

    if shj.c_csr is not None:
        assert sh.c_csr is not None and sh.shard_arrays == ()
        for f in ("row_ptr", "col_idx", "vals"):
            np.testing.assert_array_equal(getattr(sh.c_csr, f).numpy(),
                                          np.asarray(getattr(shj.c_csr, f)))
        return
    # the real (non-padding) part of every reference stack
    Tp, T = p.tiles_per_shard, (op.tiles.num_tiles if op.backend == "csrk"
                                else op.sell_tiles.num_chunks)
    subsets = ("i_", "b_") if p.overlap else ("",)
    for d in range(D):
        port = sh.shard_arrays[d]
        for s in subsets:
            k = (len(p.interior_ids[d]) if s == "i_" else len(p.boundary_ids[d])) if s \
                else min((d + 1) * Tp, T) - min(d * Tp, T)
            for key in _PORT_KEYS[op.backend]:
                if s + key not in shj.shard_arrays:
                    assert s + key not in port
                    continue
                ref_real = _host(shj.shard_arrays[s + key])[d, :k]
                np.testing.assert_array_equal(_host(port[s + key]), ref_real)
            if s:
                np.testing.assert_array_equal(port[s + "ids"].numpy(),
                                              np.asarray(shj.shard_arrays[s + "ids"])[d, :k])
    assert set(port) >= {s + "ids" for s in subsets}
