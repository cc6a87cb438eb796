"""The port's sharded operators: ``prepare(A, mesh=...)`` / ``shard_prepared``
and the legacy ``dist_spmv_*`` entry points, on the CPU.

* Port against port: at D ∈ {2, 4}, every ``x_strategy``, overlap on and
  off, ``[n]`` and ``[n, B]``, f32/bf16/int8 values, the sharded operator is
  bit-equal to the port's single-device operator (monolithic tiles for
  CSR-k, as the reference's test compares), also when every shard sits on
  another device than y (the copy-back path).
* Port against reference: the sharded port lies within
  ``(2·k_i + 2)·eps32·(|A|·|x|)_i`` per row of the reference's single-device
  operator (which the reference pins bit-equal to its own sharded form).
* The legacy entry points against the dense product, CG through them, the
  solvers through ``apply_original``, the declining backends (segsum, DIA),
  the telemetry names, the guards, the SELL-C-σ wrapper's ``out=`` and the
  ``repro_torch.launch.cg_solver`` CLI.

All of it runs in process: the port's mesh is a list of devices.
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
from repro.core import solvers as j_solvers
from repro.core.ordering import bandk as j_bandk
from repro.core.spmv import prepare as j_prepare
from repro.kernels import ref as j_ref
from repro.obs import MetricsRegistry as JRegistry
from repro.obs import using_registry as j_using_registry

from repro_torch.configs.spmv_suite import grid_laplacian_2d, powerlaw_zipf, stencil_fringe
from repro_torch.core import block_cg, block_power_iteration, cg
from repro_torch.core import distributed as t_dist
from repro_torch.core.ordering import bandk
from repro_torch.core.spmv import prepare as t_prepare
from repro_torch.kernels import ref
from repro_torch.kernels.spmv_sellcs import spmv_sellcs_chunks
from repro_torch.launch import cg_solver
from repro_torch.launch.mesh import ShardMesh, make_host_mesh
from repro_torch.obs import MetricsRegistry, using_registry
from repro_torch.sparse import CSRMatrix

from test_torch_shard_plan import banded_irregular, scattered_irregular

EPS32 = float(np.finfo(np.float32).eps)
STRATEGIES = ("auto",) + t_dist.X_STRATEGIES

_MATS = {}


def _mat(name):
    """(port A, reference A) for a test matrix, built once."""
    if name not in _MATS:
        if name == "grid":
            _MATS[name] = (grid_laplacian_2d(48, 48), j_grid(48, 48))
        elif name == "banded":
            _MATS[name] = banded_irregular(1024)
        else:
            _MATS[name] = scattered_irregular(1024)
    return _MATS[name]


_SINGLE = {}


def _single(name, value_dtype):
    """The port's single-device operator (monolithic tiles for CSR-k)."""
    key = (name, value_dtype)
    if key not in _SINGLE:
        A, _ = _mat(name)
        fmt = "csrk" if name == "grid" else "sellcs"
        _SINGLE[key] = t_prepare(A, "ampere", device="cpu", format=fmt,
                                 tile_layout="monolithic", value_dtype=value_dtype)
    return _SINGLE[key]


def _inputs(n, seed=0, B=5):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal(n).astype(np.float32)),
            torch.from_numpy(rng.standard_normal((n, B)).astype(np.float32)))


@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("value_dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("name", ["grid", "banded", "scattered"])
def test_sharded_bit_equal_to_single_device(name, value_dtype, D):
    base = _single(name, value_dtype)
    A, _ = _mat(name)
    src = base.csrk.csr if base.backend == "csrk" else A
    x, X = _inputs(A.n)
    y, Y = base(x), base(X)
    mesh = make_host_mesh(D, device="cpu")
    seen = set()
    for strategy in STRATEGIES:
        for overlap in (None, True, False):
            op = t_dist.shard_prepared(base, mesh, x_strategy=strategy, A=src,
                                       halo_overlap=overlap)
            assert op.num_shards == D and op.backend == base.backend
            assert torch.equal(op(x), y), (strategy, overlap, "vector")
            assert torch.equal(op(X), Y), (strategy, overlap, "block")
            assert torch.equal(op.matmat(X), Y)
            seen.add((op.x_strategy, op.overlap))
    if name == "scattered" and D == 4:           # halo demotes: degenerate plans only
        assert seen == {("replicated", False), ("allgather", False)}
    elif name != "scattered":
        assert {("halo", True), ("halo", False)} <= seen


@pytest.mark.parametrize("name", ["grid", "banded"])
def test_shards_on_other_devices_than_y_copy_back_the_same_bits(name):
    """Every shard on ``cpu:0`` while y lives on ``cpu``: each launch writes a
    buffer of its own and its rows are copied into y, as for shards on
    another card."""
    base = _single(name, "f32")
    A, _ = _mat(name)
    src = base.csrk.csr if base.backend == "csrk" else A
    x, X = _inputs(A.n, seed=1, B=3)
    mesh = ShardMesh((torch.device("cpu", 0),) * 4)
    for strategy, overlap in (("halo", True), ("halo", False), ("allgather", None),
                              ("replicated", None)):
        op = t_dist.shard_prepared(base, mesh, x_strategy=strategy, A=src,
                                   halo_overlap=overlap)
        assert torch.equal(op(x), base(x)) and torch.equal(op(X), base(X)), strategy
    same = t_dist.shard_prepared(base, make_host_mesh(4, "cpu"), x_strategy="replicated", A=src)
    assert same.x_copy_bytes_per_call() == 0 < op.x_copy_bytes_per_call()


def _abs_prod(op, x):
    """|A|·|x| for the values as stored (dequantized), in op's index space."""
    if op.backend == "csrk":
        t = op.tiles
        return ref.spmv_csrk_tiles(dataclasses.replace(t, vals=t.vals.abs()), x.abs())
    t = op.sell_tiles
    return ref.spmv_sellcs_tiles(dataclasses.replace(t, vals=t.vals.abs()), x.abs())


@pytest.mark.parametrize("value_dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("name", ["grid", "banded"])
def test_sharded_within_bound_of_reference(name, value_dtype):
    A, Aj = _mat(name)
    fmt = "csrk" if name == "grid" else "sellcs"
    opj = j_prepare(Aj, "ampere", format=fmt, tile_layout="monolithic", value_dtype=value_dtype)
    base = _single(name, value_dtype)
    row_nnz = (base.csrk.csr if fmt == "csrk" else A).row_lengths().double()
    x, X = _inputs(A.n, seed=2, B=3)
    for D, strategy, overlap in ((4, "auto", None), (2, "halo", False), (4, "allgather", None)):
        op = t_prepare(A, "ampere", device="cpu", format=fmt, value_dtype=value_dtype,
                       mesh=make_host_mesh(D, "cpu"), x_strategy=strategy,
                       halo_overlap=overlap)
        for v in (x, X):
            want = torch.from_numpy(np.array(opj(jnp.asarray(v.numpy())))).double()
            k = row_nnz[:, None] if v.ndim == 2 else row_nnz
            bound = (2 * k + 2) * EPS32 * _abs_prod(base, v).double()
            err = (op(v).double() - want).abs()
            assert bool((err <= bound).all()), (D, strategy, float(err.max()))


def test_legacy_dist_spmv_against_dense():
    """``dist_spmv_allgather`` / ``dist_spmv_halo`` over 8 shards against the
    dense product ([n] and [n, B]); a band too wide for one neighbour falls
    back to the all-gather."""
    A = grid_laplacian_2d(32, 32)
    A = A.symmetric_permute(bandk(A))
    mesh = make_host_mesh(8, device="cpu")
    S = t_dist.shard_csr(A, mesh.shape["data"])
    dense = A.todense().double()
    x, X = _inputs(A.m, seed=3, B=4)
    for v in (x, X):
        want = dense @ v.double()
        for f in (t_dist.dist_spmv_allgather, t_dist.dist_spmv_halo):
            y = f(S, v, mesh)
            assert y.shape == want.shape and float((y.double() - want).abs().max()) < 1e-3
    assert S.halo <= S.rows_per_shard

    W, _ = scattered_irregular(512)
    SW = t_dist.shard_csr(W, 8)
    assert SW.halo > SW.rows_per_shard
    xw, _ = _inputs(W.n, seed=4)
    assert torch.equal(t_dist.dist_spmv_halo(SW, xw, mesh), t_dist.dist_spmv_allgather(SW, xw, mesh))
    assert float((t_dist.dist_spmv_halo(SW, xw, mesh).double()
                  - W.todense().double() @ xw.double()).abs().max()) < 1e-3


def test_dist_cg_on_halo_matches_reference_iterations():
    A, Aj = grid_laplacian_2d(24, 24), j_grid(24, 24)
    perm = bandk(A)
    np.testing.assert_array_equal(perm, j_bandk(Aj))
    A, Aj = A.symmetric_permute(perm), Aj.symmetric_permute(perm)
    mesh = make_host_mesh(8, device="cpu")
    S = t_dist.shard_csr(A, 8)
    rng = np.random.default_rng(0)
    x_true = rng.standard_normal(A.m).astype(np.float32)
    b = (A.todense().numpy() @ x_true).astype(np.float32)
    res = cg(lambda v: t_dist.dist_spmv_halo(S, v, mesh), torch.from_numpy(b), maxiter=2000)
    assert float((res.x - torch.from_numpy(x_true)).abs().max()) < 5e-2
    resj = j_solvers.cg(lambda v: j_ref.spmv_csr(Aj, v), jnp.asarray(b), maxiter=2000)
    assert abs(res.iters - int(resj.iters)) <= 2


def test_solvers_and_csr2_path():
    """CG, block CG and block power iteration run unchanged on
    ``op.apply_original``; the CSR-2 (CPU device model) path equals its
    single-device operator bit for bit."""
    A = grid_laplacian_2d(32, 32)
    rng = np.random.default_rng(0)
    base = t_prepare(A, "cpu", device="cpu")
    assert base.tiles is None
    x, X = _inputs(A.n, seed=5, B=3)
    for strategy in t_dist.X_STRATEGIES:
        o = t_prepare(A, "cpu", device="cpu", mesh=make_host_mesh(4, "cpu"), x_strategy=strategy)
        assert o.c_csr is not None and o.x_strategy == strategy
        assert torch.equal(o(x), base(x)) and torch.equal(o(X), base(X)), strategy

    op = t_prepare(A, device="cpu", mesh=make_host_mesh(4, "cpu"))
    dense = A.todense().numpy()
    Xt = rng.standard_normal((A.m, 4)).astype(np.float32)
    Bmat = torch.from_numpy(dense @ Xt)
    res = block_cg(op.apply_original, Bmat, maxiter=2000)
    assert float((res.X - torch.from_numpy(Xt)).abs().max()) < 5e-2
    r = cg(op.apply_original, Bmat[:, 0].contiguous(), maxiter=2000)
    assert float((r.x - torch.from_numpy(Xt[:, 0])).abs().max()) < 5e-2
    lams = block_power_iteration(op.apply_original, A.n, 2, iters=60, device="cpu")
    w = np.sort(np.linalg.eigvalsh(dense))[::-1][:2]
    assert abs(float(lams[0]) - w[0]) < 0.2, (lams, w)


@pytest.mark.parametrize("route", ["diahybrid", "segsum"])
def test_declining_backends_take_the_csr_path(route):
    """Routes without a row-shardable tile view fire ``tile_decline`` and
    run :func:`_local_spmv` per shard: within the row bound of the
    single-device operator, with the reference's plan."""
    A = stencil_fringe(48) if route == "diahybrid" else powerlaw_zipf(2048)
    reg = MetricsRegistry()
    with using_registry(reg):
        base = t_prepare(A, device="cpu")
        op = t_prepare(A, device="cpu", mesh=make_host_mesh(4, "cpu"))
    assert base.backend == op.backend == route
    assert reg.get("distributed", f"tile_decline.{route}") == 1
    assert op.c_csr is not None and op.shard_arrays == ()
    row_nnz = A.row_lengths().double()
    absA = CSRMatrix(A.row_ptr, A.col_idx, A.vals.abs(), A.shape)
    for v in _inputs(A.n, seed=6, B=3):
        prod = (ref.spmm_csr(absA, v.abs()) if v.ndim == 2 else ref.spmv_csr(absA, v.abs()))
        k = row_nnz[:, None] if v.ndim == 2 else row_nnz
        err = (op(v).double() - base(v).double()).abs()
        assert bool((err <= (2 * k + 2) * EPS32 * prod.double()).all())


@pytest.mark.parametrize("name,strategy", [("grid", "auto"), ("grid", "halo"),
                                           ("scattered", "halo"), ("banded", "allgather")])
def test_telemetry_matches_reference(name, strategy):
    """``shard_prepared`` records the reference's ``distributed`` gauges and
    counters, under the same names, with the same values."""
    A, Aj = _mat(name)
    fmt = "csrk" if name == "grid" else "sellcs"
    base = _single(name, "f32")
    opj = j_prepare(Aj, "ampere", format=fmt, tile_layout="monolithic")
    src = base.csrk.csr if fmt == "csrk" else A
    srcj = opj.csrk.csr if fmt == "csrk" else Aj
    reg, regj = MetricsRegistry(), JRegistry()
    with using_registry(reg):
        t_dist.shard_prepared(base, make_host_mesh(4, "cpu"), x_strategy=strategy, A=src)
    with j_using_registry(regj):
        j_dist.shard_prepared(opj, types.SimpleNamespace(shape={"data": 4}),
                              x_strategy=strategy, A=srcj)

    def dist(records):
        return sorted((r["name"], r["value"], r["unit"]) for r in records
                      if r["section"] == "distributed")
    assert dist(reg.records()) == dist(regj.records()) != []


def test_surface_and_guards():
    A, _ = _mat("grid")
    base = t_prepare(A, device="cpu")
    op = t_prepare(A, device="cpu", mesh=make_host_mesh(4, "cpu"))
    assert isinstance(op, t_dist.ShardedPreparedSpMV)
    assert op.backend == "csrk" and op.stats == base.stats and op.params == base.params
    np.testing.assert_array_equal(op.perm, base.perm)
    assert op.x_strategy_requested == "auto" and op.x_strategy == "halo" and op.overlap
    assert 0.0 < op.interior_fraction < 1.0 and op.halo == 128
    assert op.rows_per_shard == op.plan.rows_per_shard and len(op.shard_backends) == 4
    x, X = _inputs(A.n, seed=7, B=3)
    mono = t_prepare(A, device="cpu", tile_layout="monolithic")
    assert torch.equal(op.apply_original(x), mono.apply_original(x))
    assert torch.equal(op.apply_original(X), mono.apply_original(X))
    with pytest.raises(ValueError):
        op.matmat(x)
    with pytest.raises(ValueError):
        op(X[:, :, None])
    with pytest.raises(ValueError):
        t_dist.shard_prepared(mono, make_host_mesh(2, "cpu"), x_strategy="ring")
    with pytest.raises(ValueError):
        t_dist.shard_prepared(mono, ShardMesh((torch.device("cuda", 0),) * 2))
    with pytest.raises(ValueError):
        make_host_mesh(0, device="cpu")
    mesh = make_host_mesh(3, device="cpu")
    assert mesh.shape == {"data": 3} and mesh.devices == (torch.device("cpu"),) * 3
    assert len(make_host_mesh(device="cpu").devices) == 1


def test_cuda_mesh_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks a machine without CUDA")
    with pytest.raises(RuntimeError):
        make_host_mesh(2)
    with pytest.raises(RuntimeError):
        make_host_mesh(device="cuda:0")


@pytest.mark.parametrize("B", [None, 3])
def test_sellcs_wrapper_out_takes_chunk_subsets(B):
    """Launches over disjoint chunk subsets with ``out=`` fill one y that is
    bit-equal to the full launch; rows of chunks not launched keep their
    value."""
    A, _ = _mat("banded")
    st = _single("banded", "int8").sell_tiles
    T, C = st.num_chunks, st.C
    x, X = _inputs(A.n, seed=8, B=3)
    v = x if B is None else X
    full = spmv_sellcs_chunks(st.vals, st.col_idx, st.row_perm, st.chunk_width, v,
                              st.val_scale, m=A.m)
    ids = torch.randperm(T, generator=torch.Generator().manual_seed(0))
    parts = (ids[: T // 3], ids[T // 3:])
    out = torch.full_like(full, float("nan"))

    def launch(sel):
        return spmv_sellcs_chunks(st.vals[sel], st.col_idx[sel],
                                  st.row_perm.view(T, C)[sel].reshape(-1),
                                  st.chunk_width[sel], v, st.val_scale[sel], m=A.m, out=out)
    assert launch(parts[0]) is out
    first = st.row_perm.view(T, C)[parts[0]].reshape(-1)
    first = first[first < A.m].long()
    assert torch.equal(out[first], full[first])
    assert int(torch.isnan(out).reshape(A.m, -1).any(dim=1).sum()) == A.m - first.numel()
    launch(parts[1])
    assert torch.equal(out, full)


def test_cg_solver_cli_on_cpu(capsys):
    assert cg_solver.main(["--device", "cpu", "--shards", "4", "--nrhs", "3"]) == 0
    out = capsys.readouterr().out
    assert "shards=4" in out and "halo-exchange CG: iters=" in out
    assert "all-gather CG:" in out and "block CG (3 RHS)" in out
