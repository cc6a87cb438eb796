"""The port's optimizer and gradient compression against the reference's.

``repro_torch.optim.adamw`` and the top-k half of ``repro_torch.optim.compress``
on the CPU, fed the same numpy-seeded inputs as ``repro.optim``.  The
schedule is held to two float32 ulps (XLA's cosine and PyTorch's differ by
one at some arguments); the global norm and every AdamW output to a
few float32 ulps (``ULPS`` × eps × |value|: the reductions sum in another
order, and XLA may fuse a multiply-add), a bf16 parameter to one bf16 ulp.
The top-k selection, its row pointer and the decompression are exact, on
bf16-tied input too, where ``torch.topk`` may pick another set.  The
reference's own cases (``tests/test_substrate.py``) run here on the port.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  one torch thread per test process

from repro.optim import adamw as RADAM
from repro.optim import compress as RCOMP

from repro_torch.models.convert import to_tensor
from repro_torch.optim import adamw
from repro_torch.optim import compress

EPS32 = float(np.finfo(np.float32).eps)
ULPS = 4


def _t(tree):
    return {k: to_tensor(np.asarray(v)) for k, v in tree.items()}


def _close32(port, ref, ulps=ULPS):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(port.numpy(), ref, rtol=ulps * EPS32, atol=ulps * EPS32 * np.abs(ref).max())


# --- schedule, norm, clipping ----------------------------------------------------------


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
@pytest.mark.parametrize("warmup,total", [(0, 40), (7, 50), (100, 10000)])
def test_lr_at_equals_reference(schedule, warmup, total):
    rcfg = RADAM.AdamWConfig(lr=3e-4, warmup_steps=warmup, total_steps=total, schedule=schedule)
    cfg = adamw.AdamWConfig(**dataclasses.asdict(rcfg))
    steps = list(range(0, 60)) + [total - 1, total, total + 5]
    ref = np.array([np.asarray(RADAM.lr_at(rcfg, jnp.asarray(s))) for s in steps])
    ours = np.array([adamw.lr_at(cfg, torch.tensor(s, dtype=torch.int32)).numpy() for s in steps])
    assert ours.dtype == np.float32
    np.testing.assert_allclose(ours, ref, rtol=2 * EPS32, atol=0)


def test_lr_schedule_shape():
    cfg = adamw.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    lrs = [float(adamw.lr_at(cfg, torch.tensor(s))) for s in [0, 5, 10, 55, 100]]
    assert lrs[0] == 0.0
    assert abs(lrs[1] - 0.5) < 1e-6
    assert abs(lrs[2] - 1.0) < 1e-6
    assert lrs[3] < lrs[2]
    assert abs(lrs[4] - 0.1) < 1e-3


def _tree(rng, dtype):
    shapes = {"a": (64, 33), "b": (5,), "c": (8, 8, 4)}
    return {k: jnp.asarray(rng.standard_normal(s) * 3, jnp.float32).astype(dtype)
            for k, s in shapes.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_global_norm_and_clip_match_reference_in_f32(rng, dtype):
    grads = _tree(rng, dtype)
    _close32(adamw.global_norm(_t(grads)), RADAM.global_norm(grads))
    ref, rnorm = RADAM.clip_by_global_norm(grads, 1.0)
    ours, norm = adamw.clip_by_global_norm(_t(grads), 1.0)
    _close32(norm, rnorm)
    for k in grads:
        assert ours[k].dtype == torch.float32 == getattr(torch, str(ref[k].dtype))
        _close32(ours[k], ref[k])


def test_grad_clip():
    clipped, norm = adamw.clip_by_global_norm({"a": torch.tensor([3.0, 4.0])}, 1.0)
    assert abs(float(norm) - 5.0) < 1e-6
    assert abs(float(torch.linalg.norm(clipped["a"])) - 1.0) < 1e-6


# --- the AdamW step --------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grad_clip", [1.0, 0.0])
def test_apply_matches_reference_on_identical_inputs(rng, dtype, grad_clip):
    """One step from step 6 with nonzero moments, clipping and weight decay:
    float32 params and moments within ``ULPS`` ulps, bf16 params within one
    bf16 ulp, and the same step, lr and grad_norm."""
    params, grads = _tree(rng, dtype), _tree(rng, dtype)
    mu = {k: jnp.asarray(rng.standard_normal(v.shape) * 0.1, jnp.float32) for k, v in params.items()}
    nu = {k: jnp.asarray(rng.random(v.shape) * 0.1, jnp.float32) for k, v in params.items()}
    rcfg = RADAM.AdamWConfig(lr=1e-2, warmup_steps=3, total_steps=20, grad_clip=grad_clip)
    rstate = RADAM.AdamWState(jnp.asarray(6, jnp.int32), mu, nu)
    rp, rs, rm = RADAM.apply(rcfg, params, grads, rstate)
    cfg = adamw.AdamWConfig(**dataclasses.asdict(rcfg))
    state = adamw.AdamWState(torch.tensor(6, dtype=torch.int32), _t(mu), _t(nu))
    p, s, m = adamw.apply(cfg, _t(params), _t(grads), state)
    assert s.step.dtype == torch.int32 and int(s.step) == int(rs.step) == 7
    assert float(m["lr"]) == float(rm["lr"])
    _close32(m["grad_norm"], rm["grad_norm"])
    for k in params:
        _close32(s.mu[k], rs.mu[k])
        _close32(s.nu[k], rs.nu[k])
        assert p[k].dtype == getattr(torch, dtype)
        if dtype == "float32":
            _close32(p[k], rp[k])
        else:
            ref = np.asarray(rp[k].astype(jnp.float32))
            ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
            assert np.all(np.abs(p[k].float().numpy() - ref) <= ulp)


def test_apply_updates_in_place_and_keeps_step_on_the_device():
    params = {"w": torch.ones(3)}
    state = adamw.init(params)
    assert state.step.shape == () and state.step.dtype == torch.int32
    new, state2, _ = adamw.apply(adamw.AdamWConfig(warmup_steps=0), params, {"w": torch.ones(3)},
                                 state)
    assert new["w"] is params["w"] and state2.mu["w"] is state.mu["w"]
    assert float(new["w"][0]) < 1.0 and int(state2.step) == 1


def test_adamw_matches_reference_math(rng):
    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=0, weight_decay=0.0, grad_clip=0.0,
                            schedule="constant")
    p0 = rng.standard_normal(5).astype(np.float32)
    g = rng.standard_normal(5).astype(np.float32)
    params = {"w": torch.from_numpy(p0.copy())}
    params, _, _ = adamw.apply(cfg, params, {"w": torch.from_numpy(g)}, adamw.init(params))
    # step 1: mhat = g, vhat = g², delta = g/(|g|+eps)
    np.testing.assert_allclose(params["w"].numpy(), p0 - 1e-2 * (g / (np.abs(g) + cfg.eps)),
                               rtol=1e-5)


def test_adamw_minimizes_quadratic():
    cfg = adamw.AdamWConfig(lr=0.1, warmup_steps=0, weight_decay=0.0,
                            schedule="constant", total_steps=200)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = adamw.init(params)
    for _ in range(200):
        params, state, _ = adamw.apply(cfg, params, {"w": 2 * params["w"]}, state)
    assert float(params["w"].abs().max()) < 1e-2


# --- top-k compression -----------------------------------------------------------------


@pytest.mark.parametrize("n,k", [(300_000, 3_000), (4096, 40), (10, 10)])
def test_topk_csr_gives_the_reference_indices_on_bf16_ties(rng, n, k):
    """bf16-rounded normals (as at a first step, where ``acc`` is a bf16
    gradient cast to f32) have many equal magnitudes: the stable sort keeps
    ``jax.lax.top_k``'s set and order exactly."""
    x = np.array(jnp.asarray(rng.standard_normal(n), jnp.bfloat16).astype(jnp.float32))
    rv, ri = RCOMP.topk_csr(jnp.asarray(x), k)
    v, i = compress.topk_csr(torch.from_numpy(x), k)
    assert i.dtype == torch.int32
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(v.numpy(), np.asarray(rv))


def test_topk_csr_and_rowptr():
    g = torch.tensor([[0.0, 5.0, 0.1], [2.0, 0.0, -3.0]])
    vals, idx = compress.topk_csr(g, 3)
    assert set(idx.tolist()) == {1, 3, 5}
    assert compress.row_ptr_from_indices(idx, n_cols=3, n_rows=2).tolist() == [0, 1, 3]
    dec = compress.decompress(vals, idx, (6,)).reshape(2, 3)
    assert float(dec[0, 1]) == 5.0 and float(dec[1, 2]) == -3.0


def test_row_ptr_and_decompress_equal_reference(rng):
    m, n, k = 37, 53, 300
    g = rng.standard_normal((m, n)).astype(np.float32)
    rv, ri = RCOMP.topk_csr(jnp.asarray(g), k)
    v, i = compress.topk_csr(torch.from_numpy(g), k)
    rp = compress.row_ptr_from_indices(i, n_cols=n, n_rows=m)
    assert rp.dtype == torch.int32
    np.testing.assert_array_equal(rp.numpy(), np.asarray(RCOMP.row_ptr_from_indices(ri, n, m)))
    np.testing.assert_array_equal(compress.decompress(v, i, (m, n)).numpy(),
                                  np.asarray(RCOMP.decompress(rv, ri, (m * n,)).reshape(m, n)))


def test_compress_grads_equals_reference_over_steps(rng):
    """Three error-feedback steps on a tree with a dense (small) leaf and two
    compressed ones (one bf16 with ties): the same sparse gradients, the same
    residual and ratio, bit for bit."""
    cfg = RCOMP.CompressionConfig(density=0.05, min_size=64)
    pcfg = compress.CompressionConfig(**dataclasses.asdict(cfg))
    shapes = {"w": (32, 24), "b": (7,), "e": (50, 16)}
    rstate = RCOMP.init({k: jnp.zeros(s) for k, s in shapes.items()})
    state = compress.init({k: torch.zeros(s) for k, s in shapes.items()})
    for _ in range(3):
        grads = {"w": jnp.asarray(rng.standard_normal(shapes["w"]), jnp.float32),
                 "b": jnp.asarray(rng.standard_normal(shapes["b"]), jnp.float32),
                 "e": jnp.asarray(rng.standard_normal(shapes["e"]), jnp.bfloat16)}
        rg, rstate, rm = RCOMP.compress_grads(cfg, grads, rstate)
        g, state, m = compress.compress_grads(pcfg, _t(grads), state)
        assert m["compress_ratio"] == rm["compress_ratio"]
        for k in shapes:
            assert g[k].dtype == getattr(torch, str(rg[k].dtype))
            np.testing.assert_array_equal(g[k].float().numpy(), np.asarray(rg[k], np.float32))
            np.testing.assert_array_equal(state.residual[k].numpy(), np.asarray(rstate.residual[k]))


def test_error_feedback_recovers_full_gradient_over_time(rng):
    """Sum of compressed grads → sum of true grads (EF guarantee)."""
    cfg = compress.CompressionConfig(density=0.25, min_size=1)
    g_true = torch.from_numpy(rng.standard_normal((64,)).astype(np.float32))
    state = compress.init({"w": g_true})
    total = torch.zeros_like(g_true)
    for _ in range(16):
        out, state, _ = compress.compress_grads(cfg, {"w": g_true}, state)
        total = total + out["w"]
    np.testing.assert_allclose((total / 16).numpy(), g_true.numpy(), atol=0.3)


def test_compression_ratio_reported(rng):
    cfg = compress.CompressionConfig(density=0.01, min_size=1)
    g = {"w": torch.from_numpy(rng.standard_normal((128, 128)).astype(np.float32))}
    _, _, m = compress.compress_grads(cfg, g, compress.init(g))
    assert m["compress_ratio"] < 0.05
    assert m["compress_ratio"] == 163 * 8 / (128 * 128 * 4)


def test_compress_grads_refuses_an_axis_name():
    """No longer refused: with ``axis_name`` it takes one gradient tree and
    one state per shard and gives each shard the mean of the shards' sparse
    gradients (the reference's psum / psum(1)), a small leaf its own dense
    gradient, and its own residual; one shard equals the local form."""
    rng = np.random.default_rng(7)
    cfg = compress.CompressionConfig(density=0.05, min_size=64)
    mk = lambda: {"w": torch.from_numpy(rng.standard_normal((16, 32)).astype(np.float32)),
                  "b": torch.from_numpy(rng.standard_normal(8).astype(np.float32))}
    grads = [mk() for _ in range(3)]
    states = [compress.init(g) for g in grads]
    out, states, m = compress.compress_grads(cfg, grads, states, axis_name="data")
    local = []
    for g in grads:
        sparse, st, m1 = compress.compress_grads(cfg, g, compress.init(g))
        local.append((sparse, st))
    assert m == m1
    mean = (local[0][0]["w"] + local[1][0]["w"] + local[2][0]["w"]) / torch.tensor(3.0)
    for d in range(3):
        assert torch.equal(out[d]["w"], mean)
        assert torch.equal(out[d]["b"], grads[d]["b"])
        assert torch.equal(states[d].residual["w"], local[d][1].residual["w"])
    one, _, _ = compress.compress_grads(cfg, [grads[0]], [compress.init(grads[0])],
                                        axis_name="data")
    assert torch.equal(one[0]["w"], local[0][0]["w"])
