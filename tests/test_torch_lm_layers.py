"""The port's LM layers against the reference's, on the CPU.

Each case feeds the same numpy-seeded inputs (and, for blocks, the
reference's own ``*_init`` weights, carried as numpy) through
``repro.models`` and ``repro_torch.models``.  Both sides compute in float32
with the same formulas, so the tolerance is float32 rounding: ``ATOL`` /
``RTOL`` below unless a case states its own.  Layers covered: the norms,
RoPE, the MLPs, flash attention over the (Tq, Tk, chunk, causal) grid of
``tests/test_linear_attention.py``, ``kv_valid_len``, the decode fast path,
the cache write and its clamp, the chunked linear-attention engine (chunked,
initial-state continuation, decode chain), the mamba and RWKV-6 blocks
(apply and decode), and the MoE dispatch (``csr_dispatch_plan`` bit for bit,
top-k ties, capacity drops, both ``slot_loop`` paths).  At bfloat16 the
blocks are held to two bf16 ulps of their largest output: XLA keeps fused
elementwise chains in float32 where eager PyTorch rounds each op to bf16, so
the two differ by an ulp here and there, never by more.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  one torch thread per test process

from repro.models import layers as RL
from repro.models import linear_attention as RLA
from repro.models import mamba as RM
from repro.models import moe as RMOE
from repro.models import rwkv6 as RR

from repro_torch.models import layers as L
from repro_torch.models import linear_attention as LA
from repro_torch.models import mamba as M
from repro_torch.models import moe as MOE
from repro_torch.models import rwkv6 as R
from repro_torch.models.convert import to_tensor

ATOL = 2e-5
RTOL = 2e-5


def _np(x):
    return np.asarray(x, np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _tree_t(tree):
    if isinstance(tree, dict):
        return {k: _tree_t(v) for k, v in tree.items()}
    return to_tensor(np.asarray(tree))


def _close(port, ref, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(port.detach().float().numpy(), _np(ref), atol=atol, rtol=rtol)


def _randn(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# --- norms, rope, mlp ---------------------------------------------------------


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_norms_match_reference(norm):
    rng = np.random.default_rng(1)
    x = _randn(rng, 2, 5, 48, scale=3.0)
    scale = _randn(rng, 48)
    p_ref = {"scale": jnp.asarray(scale)}
    p = {"scale": _t(scale)}
    if norm == "layernorm":
        bias = _randn(rng, 48)
        p_ref["bias"], p["bias"] = jnp.asarray(bias), _t(bias)
    ref = getattr(RL, norm)(p_ref, jnp.asarray(x))
    _close(getattr(L, norm)(p, _t(x)), ref, atol=1e-5, rtol=1e-5)


def test_rmsnorm_bf16_casts_before_scaling():
    """Normalised in f32, cast to bf16, then scaled: the other order changes
    bf16 bits, and the port agrees with the reference to one bf16 ulp."""
    rng = np.random.default_rng(2)
    x = _t(_randn(rng, 64, 96, scale=2.0)).bfloat16()
    scale = _t(_randn(rng, 96)).bfloat16()
    y = L.rmsnorm({"scale": scale}, x)
    x32 = x.float()
    norm = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + 1e-6)
    assert y.dtype == torch.bfloat16
    assert torch.equal(y, norm.bfloat16() * scale)
    assert not torch.equal(y, (norm * scale.float()).bfloat16())
    ref = RL.rmsnorm({"scale": jnp.asarray(scale.float().numpy(), jnp.bfloat16)},
                     jnp.asarray(x.float().numpy(), jnp.bfloat16))
    np.testing.assert_allclose(y.float().numpy(), _np(ref.astype(jnp.float32)),
                               rtol=2 ** -7, atol=0)


@pytest.mark.parametrize("theta", [10000.0, 1e6])
def test_rope_matches_reference(theta):
    rng = np.random.default_rng(3)
    x = _randn(rng, 2, 7, 3, 16)
    pos = (np.arange(7) + 1029).astype(np.int32)[None].repeat(2, 0)
    ref = RL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    _close(L.apply_rope(_t(x), _t(pos), theta), ref, atol=1e-4, rtol=1e-5)
    # half-split, not interleaved: position 0 is the identity
    assert torch.equal(L.apply_rope(_t(x), torch.zeros(2, 7, dtype=torch.int32), theta), _t(x))


@pytest.mark.parametrize("gated", [True, False])
def test_mlp_matches_reference(gated):
    p_ref = RL.mlp_init(jax.random.PRNGKey(4), 32, 64, gated=gated)
    x = _randn(np.random.default_rng(4), 3, 5, 32)
    ref = RL.mlp_apply(p_ref, jnp.asarray(x))
    _close(L.mlp_apply(_tree_t(p_ref), _t(x)), ref)


# --- attention ------------------------------------------------------------------


@pytest.mark.parametrize("Tq,Tk,chunk", [(16, 16, 4), (8, 32, 8), (32, 32, 32), (5, 13, 4)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_reference(Tq, Tk, chunk, causal):
    rng = np.random.default_rng(5)
    B, H, Dh = 2, 3, 8
    q, k, v = _randn(rng, B, Tq, H, Dh), _randn(rng, B, Tk, H, Dh), _randn(rng, B, Tk, H, Dh)
    off = Tk - Tq if causal else 0
    ref = RL.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=causal, q_offset=off, kv_chunk=chunk)
    out = L.flash_attention(_t(q), _t(k), _t(v), causal=causal, q_offset=off, kv_chunk=chunk)
    _close(out, ref)


@pytest.mark.parametrize("valid", [1, 4, 7])
def test_flash_kv_valid_len_masks_cache_rows(valid):
    rng = np.random.default_rng(6)
    B, T, H, Dh = 1, 9, 2, 8
    q = _randn(rng, B, 2, H, Dh)
    k, v = _randn(rng, B, T, H, Dh), _randn(rng, B, T, H, Dh)
    k[:, valid:] = 100.0
    v[:, valid:] = 100.0
    ref = RL.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                             q_offset=valid - 2, kv_chunk=4, kv_valid_len=jnp.asarray(valid))
    out = L.flash_attention(_t(q), _t(k), _t(v), causal=True, q_offset=valid - 2,
                            kv_chunk=4, kv_valid_len=valid)
    _close(out, ref)
    clean = L.flash_attention(_t(q), _t(k[:, :valid]), _t(v[:, :valid]), causal=True,
                              q_offset=valid - 2, kv_chunk=4)
    torch.testing.assert_close(out, clean, atol=1e-5, rtol=1e-5)


def test_decode_attention_matches_reference():
    rng = np.random.default_rng(7)
    B, S, Hkv, G, Dh = 2, 11, 2, 3, 8
    q, k, v = _randn(rng, B, 1, Hkv * G, Dh), _randn(rng, B, S, Hkv, Dh), _randn(rng, B, S, Hkv, Dh)
    ref = RL._decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), G, jnp.asarray(6))
    _close(L._decode_attention(_t(q), _t(k), _t(v), G, 6), ref)


def _attn_ref_and_port(rng, qkv_bias=False):
    p_ref = RL.attention_init(jax.random.PRNGKey(8), 32, 4, 2, 8, qkv_bias=qkv_bias)
    if qkv_bias:
        p_ref = {k: (v + 0.1 if k.startswith("b") else v) for k, v in p_ref.items()}
    return p_ref, _tree_t(p_ref)


@pytest.mark.parametrize("fastpath", [True, False])
@pytest.mark.parametrize("qkv_bias", [False, True])
def test_attention_apply_prefill_then_decode_matches_reference(fastpath, qkv_bias):
    """A prefill past the kv chunk into a cache, then single-token steps, on
    the fast path and on the chunked path it replaces."""
    rng = np.random.default_rng(9)
    p_ref, p = _attn_ref_and_port(rng, qkv_bias)
    B, P, S = 2, 11, 16
    kw = dict(num_heads=4, kv_heads=2, head_dim=8, kv_chunk=4, decode_fastpath=fastpath)
    rc = {"k": jnp.zeros((B, S, 2, 8)), "v": jnp.zeros((B, S, 2, 8))}
    pc = {"k": torch.zeros(B, S, 2, 8), "v": torch.zeros(B, S, 2, 8)}
    x = _randn(rng, B, P, 32)
    pos = np.arange(P)
    ro, rc = RL.attention_apply(p_ref, jnp.asarray(x), positions=jnp.asarray(pos), cache=rc,
                                cache_index=jnp.asarray(0, jnp.int32), **kw)
    po, pc = L.attention_apply(p, _t(x), positions=_t(pos), cache=pc, cache_index=0, **kw)
    _close(po, ro)
    for t in range(P, S):
        x1 = _randn(rng, B, 1, 32)
        ro, rc = RL.attention_apply(p_ref, jnp.asarray(x1), positions=jnp.asarray([t]),
                                    cache=rc, cache_index=jnp.asarray(t, jnp.int32), **kw)
        po, pc = L.attention_apply(p, _t(x1), positions=torch.tensor([t]), cache=pc,
                                   cache_index=t, **kw)
        _close(po, ro)
    _close(pc["k"], rc["k"])
    _close(pc["v"], rc["v"])


@pytest.mark.parametrize("index,T", [(14, 4), (15, 1), (40, 3), (0, 16)])
def test_cache_write_clamps_like_dynamic_update_slice(index, T):
    """A write that would run past ``max_len`` lands at ``max_len - T`` (the
    clamp of ``dynamic_update_slice``), while the mask and positions keep the
    unclamped index — as in the reference."""
    rng = np.random.default_rng(10)
    p_ref, p = _attn_ref_and_port(rng)
    B, S = 1, 16
    k0 = _randn(rng, B, S, 2, 8)
    v0 = _randn(rng, B, S, 2, 8)
    x = _randn(rng, B, T, 32)
    pos = np.arange(index, index + T)
    kw = dict(num_heads=4, kv_heads=2, head_dim=8, kv_chunk=8)
    ro, rc = RL.attention_apply(p_ref, jnp.asarray(x), positions=jnp.asarray(pos),
                                cache={"k": jnp.asarray(k0), "v": jnp.asarray(v0)},
                                cache_index=jnp.asarray(index, jnp.int32), **kw)
    po, pc = L.attention_apply(p, _t(x), positions=_t(pos),
                               cache={"k": _t(k0.copy()), "v": _t(v0.copy())},
                               cache_index=index, **kw)
    start = L.cache_write_start(index, T, S)
    assert start == min(index, S - T)
    assert torch.equal(pc["k"][:, :start], _t(k0[:, :start]))
    _close(pc["k"], rc["k"])
    _close(pc["v"], rc["v"])
    _close(po, ro)


# --- linear attention -------------------------------------------------------------


def _la_inputs(rng, B, H, T, K, V, with_u):
    r, k, v = _randn(rng, B, H, T, K), _randn(rng, B, H, T, K, scale=0.3), _randn(rng, B, H, T, V)
    lw = np.clip(-rng.random((B, H, T, K)).astype(np.float32) * 3, RLA.LOG_W_MIN, -1e-4)
    u = _randn(rng, H, K, scale=0.2) if with_u else None
    return r, k, v, lw.astype(np.float32), u


@pytest.mark.parametrize("chunk", [8, 16, 32])
@pytest.mark.parametrize("with_u", [True, False])
def test_chunked_linear_attention_matches_reference(chunk, with_u):
    r, k, v, lw, u = _la_inputs(np.random.default_rng(11), 2, 2, 64, 8, 6, with_u)
    ro, rS = RLA.chunked_linear_attention(*map(jnp.asarray, (r, k, v, lw)),
                                          u=None if u is None else jnp.asarray(u), chunk=chunk)
    po, pS = LA.chunked_linear_attention(*map(_t, (r, k, v, lw)),
                                         u=None if u is None else _t(u), chunk=chunk)
    _close(po, ro, atol=1e-4, rtol=1e-4)
    _close(pS, rS, atol=1e-4, rtol=1e-4)


def test_chunked_initial_state_continuation_matches_reference():
    r, k, v, lw, _ = _la_inputs(np.random.default_rng(12), 1, 2, 32, 4, 4, False)
    h = 16
    half = lambda a, s: a[:, :, s]
    _, rS1 = RLA.chunked_linear_attention(*(jnp.asarray(half(a, slice(0, h))) for a in (r, k, v, lw)), chunk=8)
    ro2, rS2 = RLA.chunked_linear_attention(*(jnp.asarray(half(a, slice(h, None))) for a in (r, k, v, lw)),
                                            chunk=8, initial_state=rS1)
    _, pS1 = LA.chunked_linear_attention(*(_t(half(a, slice(0, h))) for a in (r, k, v, lw)), chunk=8)
    po2, pS2 = LA.chunked_linear_attention(*(_t(half(a, slice(h, None))) for a in (r, k, v, lw)),
                                           chunk=8, initial_state=pS1)
    _close(po2, ro2, atol=1e-4, rtol=1e-4)
    _close(pS2, rS2, atol=1e-4, rtol=1e-4)
    po, pS = LA.chunked_linear_attention(*map(_t, (r, k, v, lw)), chunk=8)
    torch.testing.assert_close(po2, po[:, :, h:], atol=1e-5, rtol=1e-3)
    torch.testing.assert_close(pS2, pS, atol=1e-5, rtol=1e-3)


def test_decode_chain_matches_reference_and_chunked():
    r, k, v, lw, u = _la_inputs(np.random.default_rng(13), 1, 1, 16, 4, 4, True)
    rS = jnp.zeros((1, 1, 4, 4))
    pS = torch.zeros(1, 1, 4, 4)
    outs = []
    for t in range(16):
        ro, rS = RLA.linear_attention_decode(*(jnp.asarray(a[:, :, t]) for a in (r, k, v, lw)),
                                             rS, u=jnp.asarray(u))
        po, pS = LA.linear_attention_decode(*(_t(a[:, :, t]) for a in (r, k, v, lw)),
                                            pS, u=_t(u))
        _close(po, ro)
        outs.append(po)
    _close(pS, rS)
    chunked, S = LA.chunked_linear_attention(*map(_t, (r, k, v, lw)), u=_t(u), chunk=8)
    torch.testing.assert_close(torch.stack(outs, dim=2), chunked, atol=1e-5, rtol=1e-3)
    torch.testing.assert_close(pS, S, atol=1e-5, rtol=1e-3)


def test_chunked_rejects_ragged_length():
    r, k, v, lw, _ = _la_inputs(np.random.default_rng(14), 1, 1, 40, 4, 4, False)
    with pytest.raises(ValueError):
        LA.chunked_linear_attention(*map(_t, (r, k, v, lw)), chunk=32)


# --- mamba and rwkv6 blocks ----------------------------------------------------------


def test_mamba_block_apply_and_decode_match_reference():
    D, H, N = 64, 2, 16
    p_ref = RM.mamba_block_init(jax.random.PRNGKey(15), D, d_state=N)
    p = _tree_t(p_ref)
    rng = np.random.default_rng(15)
    x = _randn(rng, 2, 16, D)
    rs = {"S": jnp.zeros((2, H, N, 64))}
    ps = {"S": torch.zeros(2, H, N, 64)}
    ry, rs = RM.mamba_block_apply(p_ref, jnp.asarray(x), num_heads=H, d_state=N, chunk=8, state=rs)
    py, ps = M.mamba_block_apply(p, _t(x), num_heads=H, d_state=N, chunk=8, state=ps)
    _close(py, ry, atol=1e-4, rtol=1e-4)
    _close(ps["S"], rs["S"], atol=1e-4, rtol=1e-4)
    for _ in range(4):
        x1 = _randn(rng, 2, 1, D)
        ry, rs = RM.mamba_block_decode(p_ref, jnp.asarray(x1), rs, num_heads=H, d_state=N)
        py, ps = M.mamba_block_decode(p, _t(x1), ps, num_heads=H, d_state=N)
        _close(py, ry, atol=1e-4, rtol=1e-4)
    _close(ps["S"], rs["S"], atol=1e-4, rtol=1e-4)
    assert M.mamba_init_state(2, D, d_state=N)["S"].shape == RM.mamba_init_state(2, D, d_state=N)["S"].shape


def test_rwkv6_block_apply_and_decode_match_reference():
    """Prefill with state, then decode steps: the token shift carries
    ``x_prev_*`` across steps."""
    D, H = 64, 2
    p_ref = RR.rwkv6_block_init(jax.random.PRNGKey(16), D, H, 128)
    p_ref["w_lora_b"] = p_ref["w_lora_b"] + 0.05       # data-dependent decay in play
    p = _tree_t(p_ref)
    rng = np.random.default_rng(16)
    rs = RR.rwkv6_init_state(2, D, H)
    ps = R.rwkv6_init_state(2, D, H)
    x = _randn(rng, 2, 16, D)
    ry, rs = RR.rwkv6_block_apply(p_ref, jnp.asarray(x), num_heads=H, chunk=8, state=rs)
    py, ps = R.rwkv6_block_apply(p, _t(x), num_heads=H, chunk=8, state=ps)
    _close(py, ry, atol=1e-4, rtol=1e-4)
    for _ in range(4):
        x1 = _randn(rng, 2, 1, D)
        ry, rs = RR.rwkv6_block_decode(p_ref, jnp.asarray(x1), rs, num_heads=H)
        py, ps = R.rwkv6_block_decode(p, _t(x1), ps, num_heads=H)
        _close(py, ry, atol=1e-4, rtol=1e-4)
    for key in ("S", "x_prev_att", "x_prev_ffn"):
        _close(ps[key], rs[key], atol=1e-4, rtol=1e-4)
    # a second prefill continues from the carried state
    x2 = _randn(rng, 2, 8, D)
    ry, rs = RR.rwkv6_block_apply(p_ref, jnp.asarray(x2), num_heads=H, chunk=8, state=rs)
    py, ps = R.rwkv6_block_apply(p, _t(x2), num_heads=H, chunk=8, state=ps)
    _close(py, ry, atol=1e-4, rtol=1e-4)


# --- MoE dispatch ---------------------------------------------------------------------


def _plan_cases():
    rng = np.random.default_rng(17)
    return {
        "random": (rng.integers(0, 8, size=(32, 2)), 8, 100),
        "ties": (np.zeros((20, 2), np.int64) + np.array([3, 3]), 8, 16),
        "capacity_drop": (rng.integers(0, 2, size=(64, 1)), 2, 16),
        "one_expert_small_capacity": (np.full((9, 3), 5), 6, 4),
    }


@pytest.mark.parametrize("case", list(_plan_cases()))
def test_csr_dispatch_plan_equals_reference_exactly(case):
    idx, E, cap = _plan_cases()[case]
    rd, rk, rp = RMOE.csr_dispatch_plan(jnp.asarray(idx, jnp.int32), E, cap)
    pd, pk, pp = MOE.csr_dispatch_plan(torch.from_numpy(idx.astype(np.int32)), E, cap)
    assert pd.dtype == torch.int32 and pp.dtype == torch.int32 and pk.dtype == torch.bool
    np.testing.assert_array_equal(pd.numpy(), np.asarray(rd))
    np.testing.assert_array_equal(pk.numpy(), np.asarray(rk))
    np.testing.assert_array_equal(pp.numpy(), np.asarray(rp))


def test_router_top_k_orders_ties_like_lax_top_k():
    logits = np.array([[1.0, 3.0, 3.0, 2.0, 3.0, 0.5],
                       [0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
                       [2.0, 1.0, 2.0, 1.0, 2.0, 2.0]], np.float32)
    for k in (1, 2, 3, 5):
        rv, ri = jax.lax.top_k(jnp.asarray(logits), k)
        pv, pi = MOE.router_top_k(_t(logits), k)
        np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
        np.testing.assert_array_equal(pv.numpy(), np.asarray(rv))


@pytest.mark.parametrize("slot_loop", [True, False])
@pytest.mark.parametrize("after", [True, False])
def test_moe_apply_matches_reference(slot_loop, after):
    E, K, D, F = 4, 2, 16, 32
    p_ref = RMOE.moe_init(jax.random.PRNGKey(18), D, F, E)
    x = _randn(np.random.default_rng(18), 2, 6, D)
    ry, ra = RMOE.moe_apply(p_ref, jnp.asarray(x), num_experts=E, top_k=K, slot_loop=slot_loop,
                            router_softmax_after_topk=after)
    py, pa = MOE.moe_apply(_tree_t(p_ref), _t(x), num_experts=E, top_k=K, slot_loop=slot_loop,
                           router_softmax_after_topk=after)
    _close(py, ry)
    _close(pa, ra)


@pytest.mark.parametrize("slot_loop", [True, False])
def test_moe_capacity_drops_match_reference(slot_loop):
    E, K, D, F = 2, 1, 4, 8
    p_ref = RMOE.moe_init(jax.random.PRNGKey(0), D, F, E)
    p_ref["router"] = p_ref["router"].at[:, 0].set(100.0)
    x = (np.abs(_randn(np.random.default_rng(19), 1, 64, D)) + 0.1).astype(np.float32)
    ry, ra = RMOE.moe_apply(p_ref, jnp.asarray(x), num_experts=E, top_k=K,
                            capacity_factor=0.5, slot_loop=slot_loop)
    py, pa = MOE.moe_apply(_tree_t(p_ref), _t(x), num_experts=E, top_k=K,
                           capacity_factor=0.5, slot_loop=slot_loop)
    _close(py, ry)
    _close(pa, ra)
    zero_rows = int((py.reshape(-1, D).abs().amax(dim=1) < 1e-9).sum())
    assert zero_rows == 48          # capacity max(⌊64·1/2·0.5⌋, 16) = 16 kept


# --- the blocks at bfloat16 -------------------------------------------------------------


def _bf16_block(kind, rng):
    """(reference output, port output) of one block on the same bf16 weights
    (the MoE router stays float32, as ``moe_init`` makes it at bf16) and
    bf16 input [2, 16, 64]."""
    D, H = 64, 2
    bf = lambda tree: jax.tree.map(lambda a: a.astype(jnp.bfloat16), tree)
    x = _randn(rng, 2, 16, D)
    xr, xp = jnp.asarray(x, jnp.bfloat16), _t(x).bfloat16()
    if kind == "mlp":
        p_ref = bf(RL.mlp_init(jax.random.PRNGKey(20), D, 128, gated=True))
        return RL.mlp_apply(p_ref, xr), L.mlp_apply(_tree_t(p_ref), xp)
    if kind == "attention":
        p_ref = bf(RL.attention_init(jax.random.PRNGKey(21), D, 4, 2, 16))
        kw = dict(num_heads=4, kv_heads=2, head_dim=16, kv_chunk=8)
        pos = np.arange(16)
        return (RL.attention_apply(p_ref, xr, positions=jnp.asarray(pos), **kw)[0],
                L.attention_apply(_tree_t(p_ref), xp, positions=_t(pos), **kw)[0])
    if kind == "mamba":
        p_ref = bf(RM.mamba_block_init(jax.random.PRNGKey(22), D, d_state=16))
        kw = dict(num_heads=H, d_state=16, chunk=8)
        return (RM.mamba_block_apply(p_ref, xr, **kw)[0],
                M.mamba_block_apply(_tree_t(p_ref), xp, **kw)[0])
    if kind == "rwkv6":
        p_ref = bf(RR.rwkv6_block_init(jax.random.PRNGKey(23), D, H, 128))
        return (RR.rwkv6_block_apply(p_ref, xr, num_heads=H, chunk=8)[0],
                R.rwkv6_block_apply(_tree_t(p_ref), xp, num_heads=H, chunk=8)[0])
    p_ref = RMOE.moe_init(jax.random.PRNGKey(24), D, 128, 4)
    p_ref = {k: v if k == "router" else v.astype(jnp.bfloat16) for k, v in p_ref.items()}
    kw = dict(num_experts=4, top_k=2)
    return RMOE.moe_apply(p_ref, xr, **kw)[0], MOE.moe_apply(_tree_t(p_ref), xp, **kw)[0]


@pytest.mark.parametrize("kind", ["mlp", "attention", "mamba", "rwkv6", "moe"])
def test_blocks_bf16_match_reference_within_two_ulps(kind):
    ref, out = _bf16_block(kind, np.random.default_rng(20))
    assert out.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    ref = _np(ref)
    _close(out, ref, atol=2.0 ** -6 * float(np.abs(ref).max()), rtol=0)
