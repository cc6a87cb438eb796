"""The port's ``prepare`` / ``PreparedSpMV`` / solvers against the reference.

``prepare(A, "ampere", device="cpu")`` in the port and ``prepare(A,
device="ampere")`` in the reference must take the same decisions (backend,
tuning, permutation, value dtype, modeled bytes), and their SpMVs must agree
within the per-row rounding bound ``(2·k_i + 2)·eps_f32·(|A|·|x|)_i``.
Solvers are compared by iteration counts and solutions, eigen-solvers by
their eigenvalues from the same start block.
"""
import ast
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  one torch thread per test process

from repro.configs.spmv_suite import load_suite as j_load_suite
from repro.core import solvers as j_solvers
from repro.core.spmv import prepare as j_prepare
from repro.kernels import ref as j_ref

from repro_torch.configs.spmv_suite import load_suite as t_load_suite
from repro_torch.core import solvers as t_solvers
from repro_torch.core.spmv import prepare as t_prepare
from repro_torch.obs import MetricsRegistry, annotate, using_registry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPS32 = float(np.finfo(np.float32).eps)
SCALE = 512


@pytest.fixture(scope="module")
def mats():
    """A few regular suite matrices: name → (port CSR, reference CSR, dense)."""
    ids = [8, 9, 12]   # ecology1 (2-D 5-point), cont-300, brack2 (3-D 7-point)
    t, j = t_load_suite(SCALE, ids=ids), j_load_suite(SCALE, ids=ids)
    return {k: (t[k], j[k], np.asarray(j[k].todense())) for k in t}


@pytest.fixture(scope="module")
def ops_pair(mats):
    """ecology1 prepared by both packages (auto format, auto value dtype)."""
    A, Aj, dense = mats["ecology1"]
    return (t_prepare(A, "ampere", device="cpu"), j_prepare(Aj, device="ampere"), dense)


def assert_within_bound(y, y_ref, dense, x):
    y, y_ref = np.asarray(y, np.float64), np.asarray(y_ref, np.float64)
    assert y.shape == y_ref.shape
    prod = np.abs(dense.astype(np.float64)) @ np.abs(np.asarray(x, np.float64))
    k = (dense != 0).sum(axis=1).astype(np.float64)
    bound = (2 * (k[:, None] if prod.ndim == 2 else k) + 2) * EPS32 * prod
    assert np.all(np.abs(y - y_ref) <= bound), np.abs(y - y_ref).max()


def _permuted_dense(dense, perm):
    return dense[np.ix_(perm, perm)]


@pytest.mark.parametrize("name", ["ecology1", "cont-300", "brack2"])
@pytest.mark.parametrize("value_dtype", ["f32", "auto"])
def test_prepare_decisions_match(mats, name, value_dtype):
    A, Aj, _ = mats[name]
    op = t_prepare(A, "ampere", device="cpu", value_dtype=value_dtype)
    opj = j_prepare(Aj, device="ampere", value_dtype=value_dtype)
    assert op.backend == opj.backend == "csrk"
    assert dataclasses.asdict(op.params) == dataclasses.asdict(opj.params)
    np.testing.assert_array_equal(op.perm, opj.perm)
    assert op.value_dtype == opj.value_dtype
    assert op.modeled_bytes() == opj.modeled_bytes()
    assert op.fingerprint == opj.fingerprint
    assert op.stats.as_dict() == opj.stats.as_dict()
    assert op.overhead_fraction() == opj.overhead_fraction()
    assert op.padding_overhead() == pytest.approx(opj.padding_overhead(), rel=1e-12)
    assert op.tile_buckets.bucket_slots() == opj.tile_buckets.bucket_slots()
    assert op.resident_bytes() > 0


@pytest.mark.parametrize("B", [None, 4])
def test_call_and_apply_original_match(rng, ops_pair, B):
    op, opj, dense = ops_pair
    n = dense.shape[1]
    x = rng.standard_normal((n,) if B is None else (n, B)).astype(np.float32)
    dp = _permuted_dense(dense, op.perm)
    assert_within_bound(op(torch.from_numpy(x)).numpy(), np.asarray(opj(jnp.asarray(x))), dp, x)
    assert_within_bound(op.apply_original(torch.from_numpy(x)).numpy(),
                        np.asarray(opj.apply_original(jnp.asarray(x))), dense, x)
    assert_within_bound(op.apply_original(torch.from_numpy(x)).numpy(), dense @ x, dense, x)
    if B is not None:
        assert torch.equal(op.matmat(torch.from_numpy(x)), op(torch.from_numpy(x)))
        with pytest.raises(ValueError):
            op.matmat(torch.from_numpy(x[:, 0]))


@pytest.mark.parametrize("value_dtype", ["bf16", "int8"])
def test_compressed_values_match(rng, mats, value_dtype):
    A, Aj, _ = mats["ecology1"]
    for layout in ("bucketed", "monolithic"):
        op = t_prepare(A, "ampere", device="cpu", value_dtype=value_dtype, tile_layout=layout)
        opj = j_prepare(Aj, device="ampere", value_dtype=value_dtype, tile_layout=layout)
        x = rng.standard_normal((A.n, 2)).astype(np.float32)
        dq = np.abs(np.asarray(j_ref._tile_vals_f32(opj.tiles.vals, opj.tiles.val_scale)))
        # |A| as stored (dequantized) bounds the rounding of both packages
        absA = np.zeros((A.m, A.n))
        t = opj.tiles
        rows = np.asarray(t.local_row) + np.arange(t.num_tiles)[:, None] * t.rows_per_tile
        cols = np.asarray(t.win_block)[:, None] * t.window + np.asarray(t.local_col)
        keep = rows < A.m
        np.add.at(absA, (rows[keep], np.minimum(cols[keep], A.n - 1)), dq[keep])
        y = op(torch.from_numpy(x)).numpy()
        want = np.asarray(opj(jnp.asarray(x)))
        k = (absA != 0).sum(axis=1)[:, None]
        bound = (2 * k + 2) * EPS32 * (absA @ np.abs(x))
        assert np.all(np.abs(y - want) <= bound)


def test_spmm_width_pads_and_keeps_columns_independent(rng, mats):
    A, Aj, dense = mats["ecology1"]
    op = t_prepare(A, "ampere", device="cpu", spmm_width=4)
    opj = j_prepare(Aj, device="ampere", spmm_width=4)
    X = rng.standard_normal((A.n, 6)).astype(np.float32)
    Y = op(torch.from_numpy(X))
    assert Y.shape == (A.m, 6)
    dp = _permuted_dense(dense, op.perm)
    assert_within_bound(Y.numpy(), np.asarray(opj(jnp.asarray(X))), dp, X)
    for j in range(6):
        assert torch.equal(Y[:, j], op(torch.from_numpy(X[:, j].copy())))
        assert torch.equal(Y[:, j], op(torch.from_numpy(X[:, [j, 0]].copy()))[:, 0])
    with pytest.raises(ValueError):
        t_prepare(A, "ampere", device="cpu", spmm_width=0)


@pytest.mark.parametrize("device_model", ["cpu", "rome"])
def test_csr2_route_matches(rng, mats, device_model):
    A, Aj, dense = mats["cont-300"]
    op = t_prepare(A, device_model, device="cpu")
    opj = j_prepare(Aj, device=device_model)
    assert op.tiles is None and op.tile_buckets is None and op.value_dtype == "f32"
    assert dataclasses.asdict(op.params) == dataclasses.asdict(opj.params)
    assert op.params.k == 2
    assert op.csrk.num_sr == opj.csrk.num_sr
    assert op.modeled_bytes() == opj.modeled_bytes()
    for shape in ((A.n,), (A.n, 3)):
        x = rng.standard_normal(shape).astype(np.float32)
        assert_within_bound(op.apply_original(torch.from_numpy(x)).numpy(),
                            np.asarray(opj.apply_original(jnp.asarray(x))), dense, x)


def test_prepare_rejects_and_routes(rng):
    A = t_load_suite(SCALE, ids=[15])["Emilia_923"]          # row_var > 10 → sellcs
    op = t_prepare(A, "ampere", device="cpu")
    assert op.backend == "sellcs"
    x = rng.standard_normal(A.n).astype(np.float32)
    dense = A.todense().numpy()
    assert_within_bound(op(torch.from_numpy(x)).numpy(), dense @ x, dense, x)
    op = t_prepare(A, "ampere", device="cpu", format="csrk", reorder="natural")
    assert op.backend == "csrk"
    op = t_prepare(A, "ampere", device="cpu", format="segsum")
    assert op.backend == "segsum"
    assert_within_bound(op(torch.from_numpy(x)).numpy(), dense @ x, dense, x)
    op = t_prepare(A, "ampere", device="cpu", format="diahybrid")
    assert op.backend == "diahybrid"
    assert_within_bound(op(torch.from_numpy(x)).numpy(), dense @ x, dense, x)
    with pytest.raises(ValueError):
        t_prepare(A, "ampere", device="cpu", format="nope")
    with pytest.raises(ValueError):
        t_prepare(A, "ampere", device="cpu", tile_layout="nope")


def test_prepare_defaults_to_cuda():
    """Entry points run on CUDA unless asked for the CPU; never silently."""
    A = t_load_suite(SCALE, ids=[9])["cont-300"]
    if torch.cuda.is_available():
        assert t_prepare(A, reorder="natural").device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            t_prepare(A)


def test_cg_and_block_cg_match(rng, mats):
    A, Aj, dense = mats["ecology1"]
    op = t_prepare(A, "ampere", device="cpu")
    perm = op.perm
    Ajr = Aj.symmetric_permute(perm)
    x_true = rng.standard_normal((A.n, 3)).astype(np.float32)
    Bm = (dense @ x_true).astype(np.float32)[perm]
    j_mv = lambda v: j_ref.spmm_csr(Ajr, v) if v.ndim == 2 else j_ref.spmv_csr(Ajr, v)  # noqa: E731

    res = t_solvers.cg(op, torch.from_numpy(Bm[:, 0].copy()), tol=1e-6, maxiter=500)
    resj = j_solvers.cg(j_mv, jnp.asarray(Bm[:, 0]), tol=1e-6, maxiter=500)
    assert abs(res.iters - int(resj.iters)) <= 2 and res.iters < 500
    xj = np.asarray(resj.x)
    assert np.linalg.norm(res.x.numpy() - xj) <= 1e-4 * np.linalg.norm(xj)

    bres = t_solvers.block_cg(op, torch.from_numpy(Bm), tol=1e-6, maxiter=500)
    bresj = j_solvers.block_cg(j_mv, jnp.asarray(Bm), tol=1e-6, maxiter=500)
    assert abs(bres.iters - int(bresj.iters)) <= 2 and bres.iters < 500
    Xj = np.asarray(bresj.X)
    assert np.linalg.norm(bres.X.numpy() - Xj) <= 1e-4 * np.linalg.norm(Xj)
    assert bres.residual.shape == (3,)
    with pytest.raises(ValueError):
        t_solvers.block_cg(op, torch.from_numpy(Bm[:, 0].copy()))


def test_eigen_solvers_match(mats):
    A, Aj, dense = mats["brack2"]
    op = t_prepare(A, "ampere", device="cpu")
    Ajr = Aj.symmetric_permute(op.perm)
    j_mv = lambda v: j_ref.spmm_csr(Ajr, v) if v.ndim == 2 else j_ref.spmv_csr(Ajr, v)  # noqa: E731
    # the same start block for both: the two packages draw different random bits
    V0 = np.array(jax.random.normal(jax.random.PRNGKey(0), (A.n, 4)))
    got = t_solvers.block_power_iteration(op, A.n, 4, iters=60, V0=torch.from_numpy(V0),
                                          device="cpu")
    want = np.asarray(j_solvers.block_power_iteration(j_mv, A.n, 4, iters=60, seed=0))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3)
    assert np.all(np.diff(got.numpy()) <= 0)
    v0 = np.array(jax.random.normal(jax.random.PRNGKey(0), (A.n,)))
    lam = t_solvers.power_iteration(op, A.n, iters=60, v0=torch.from_numpy(v0), device="cpu")
    lam_j = j_solvers.power_iteration(j_mv, A.n, iters=60, seed=0)
    assert float(lam) == pytest.approx(float(lam_j), rel=1e-3)
    # seeded start vectors are reproducible on their own
    a = t_solvers.block_power_iteration(op, A.n, 2, iters=5, seed=3, device="cpu")
    b = t_solvers.block_power_iteration(op, A.n, 2, iters=5, seed=3, device="cpu")
    assert torch.equal(a, b)


def test_jacobi_smoother_matches(rng, mats):
    A, Aj, dense = mats["cont-300"]
    op = t_prepare(A, "ampere", device="cpu", reorder="natural")
    b = rng.standard_normal(A.n).astype(np.float32)
    diag = np.diag(dense).astype(np.float32)
    got = t_solvers.jacobi_smoother(op, torch.from_numpy(diag), torch.from_numpy(b), iters=10)
    want = j_solvers.jacobi_smoother(lambda v: j_ref.spmv_csr(Aj, v), jnp.asarray(diag),
                                     jnp.asarray(b), iters=10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_telemetry_observes_without_changing_results(rng, mats):
    A, _, _ = mats["cont-300"]
    x = torch.from_numpy(rng.standard_normal(A.n).astype(np.float32))
    on = MetricsRegistry(enabled=True)
    with using_registry(on):
        op = t_prepare(A, "ampere", device="cpu")
        y_on = op(x)
        res_on = t_solvers.cg(op, x, maxiter=20)
    with using_registry(MetricsRegistry(enabled=False)) as off:
        y_off = t_prepare(A, "ampere", device="cpu")(x)
        res_off = t_solvers.cg(op, x, maxiter=20)
        assert annotate("anything") is annotate("else")       # one shared null context
    assert torch.equal(y_on, y_off) and torch.equal(res_on.x, res_off.x)
    names = {r["name"] for r in on.records()}
    assert {"phase.reorder_ms", "phase.tile_build_ms", "backend.csrk"} <= names
    assert on.get("kernels", "repro_torch.spmv_csrk_bucketed.calls") >= 1
    assert len(on.get_series("solvers", "cg.residual")) == res_on.iters
    assert off.records() == []


def test_port_imports_neither_jax_nor_reference():
    """Every module of repro_torch imports in a process that never loads jax."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "             or k == 'repro' or k.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print(len([k for k in sys.modules if k.startswith('repro_torch')]))\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15


def _imported_modules(path):
    tree = ast.parse(open(path).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return names


def test_chip_smoke_and_port_sources_import_neither():
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "src", "repro_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    for path in paths:
        for name in _imported_modules(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, name)
