"""The recurrent mixers tensor-parallel: ``mamba_block_*_tp`` and
``rwkv6_block_*_tp`` on model "shards" of the CPU, against the one-device
blocks (which ``tests/test_torch_lm_layers.py`` holds against the
reference's; the whole sharded path is held against the reference in
``tests/test_torch_sharded_*.py``).

Each case feeds numpy-seeded inputs and the reference's own ``*_init``
weights (carried as numpy) through the port's one-device block and, with
each projection cut into M column or row blocks as
``launch/sharding.py::tp_dim`` cuts it, through its ``_tp`` block: a
prefill into a state, then decode steps from it, and the backward of a
prefill.  Held: at f32 the outputs and states within 1e-5·max + 1e-6 of
the one-device block's (the row blocks' partial sums add in another order;
the per-head work is the same), and the gradients of the input and of
every weight within 1e-5 of their largest entry.  At bf16 a tensor-parallel block rounds where one device's rounds
(the partials summed unrounded in f32 and cast once, each column weight's
input gradient likewise): the two round f32 values that differ only by the
order of some additions, so they land at most a bf16 ulp apart: outputs and
gradients within 2^-7 of the largest entry of the one-device block's (one
ulp there), where a partial rounded before the sum would add a rounding per
shard.
"""
import jax
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  one torch thread per test process

from repro.models import mamba as RM
from repro.models import rwkv6 as RR

from repro_torch.models import mamba as M
from repro_torch.models import rwkv6 as R
from repro_torch.models.convert import to_tensor

D, N, F, B, T, CHUNK = 128, 16, 256, 2, 16, 8
#: (column leaves, row leaves) of each block's tensor-parallel groups
GROUPS = {"mamba": (("w_in", "w_gate", "w_B", "w_C"), ("w_out",)),
          "rwkv6": (("wr", "wk", "wv", "wg", "ck", "cr"), ("wo", "cv")),
          "rwkv6-channel": (("ck", "cr"), ("cv",))}
#: (block, heads, model shards): the mamba mixer's heads are d_inner/64 = 4;
#: rwkv6 with 4 heads splits both halves, with 2 heads over 4 shards only
#: its channel mix (d_ff 256 and d_model 128 divide), the time mix whole
CASES = [("mamba", 4, 2), ("mamba", 4, 4), ("rwkv6", 4, 2), ("rwkv6", 4, 4),
         ("rwkv6-channel", 2, 4)]
IDS = [f"{k}-{m}" for k, _, m in CASES]


def _t(a):
    if isinstance(a, dict):
        return {k: _t(v) for k, v in a.items()}
    return to_tensor(np.asarray(a))


def _cast(p, dtype):
    return {k: _cast(v, dtype) if isinstance(v, dict) else v.to(dtype) for k, v in p.items()}


def _ref_params(kind, H):
    if kind == "mamba":
        return RM.mamba_block_init(jax.random.PRNGKey(30), D, d_state=N)
    p = RR.rwkv6_block_init(jax.random.PRNGKey(31), D, H, F)
    p["w_lora_b"] = p["w_lora_b"] + 0.05            # data-dependent decay in play
    return p


def _blocks(p, kind, M_):
    """``p`` with each tensor-parallel leaf cut into its M blocks (views of
    the whole leaf, so that gradients reach it)."""
    cols, rows = GROUPS[kind]
    return {k: (tuple(torch.chunk(v, M_, dim=1)) if k in cols
                else tuple(torch.chunk(v, M_, dim=0)) if k in rows else v)
            for k, v in p.items()}


def _fns(kind, H):
    if kind == "mamba":
        kw = dict(num_heads=H, d_state=N)
        return ((lambda p, x, s: M.mamba_block_apply(p, x, chunk=CHUNK, state=s, **kw)),
                (lambda p, x, s: M.mamba_block_decode(p, x, s, **kw)),
                (lambda p, x, s: M.mamba_block_apply_tp(p, x, chunk=CHUNK, state=s, **kw)),
                (lambda p, x, s: M.mamba_block_decode_tp(p, x, s, **kw)),
                lambda: M.mamba_init_state(B, D, d_state=N))
    return ((lambda p, x, s: R.rwkv6_block_apply(p, x, num_heads=H, chunk=CHUNK, state=s)),
            (lambda p, x, s: R.rwkv6_block_decode(p, x, s, num_heads=H)),
            (lambda p, x, s: R.rwkv6_block_apply_tp(p, x, num_heads=H, chunk=CHUNK, state=s)),
            (lambda p, x, s: R.rwkv6_block_decode_tp(p, x, s, num_heads=H)),
            lambda: R.rwkv6_init_state(B, D, H))


def _run(apply, decode, p, xs, state):
    y, state = apply(p, xs[0], state)
    ys = [y]
    for x in xs[1:]:
        y, state = decode(p, x, state)
        ys.append(y)
    return ys, state


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, T, D)).astype(np.float32)] + [
        rng.standard_normal((B, 1, D)).astype(np.float32) for _ in range(3)]


def _near(got, want, rtol, atol, what):
    err = float((got.double() - want.double()).abs().max())
    bar = rtol * float(want.double().abs().max()) + atol
    assert got.shape == want.shape and err <= bar, (what, err, bar)


@pytest.mark.parametrize("kind,H,M_", CASES, ids=IDS)
def test_tp_prefill_and_decode_match_one_device(kind, H, M_):
    """f32: a prefill of 16 tokens into a state (two chunks) and three
    decode steps from it, on M blocks, against the one-device block; the
    new state comes back whole, of the one-device state's shape."""
    p = _t(_ref_params(kind, H))
    xs = [_t(x) for x in _inputs(32)]
    apply, decode, apply_tp, decode_tp, init = _fns(kind, H)
    with torch.no_grad():
        one, s_one = _run(apply, decode, p, xs, init())
        tp, s_tp = _run(apply_tp, decode_tp, _blocks(p, kind, M_), xs, init())
    for i, (a, b) in enumerate(zip(tp, one)):
        _near(a, b, 1e-5, 1e-6, f"output {i} against one device")
    assert set(s_tp) == set(s_one)
    for k in s_tp:
        assert s_tp[k].shape == s_one[k].shape and s_tp[k].dtype == s_one[k].dtype, k
        _near(s_tp[k], s_one[k], 1e-5, 1e-6, f"state {k} against one device")


def _grads(fn, p, x, w):
    """Gradients of sum(fn(p, x) · w) with respect to x and every weight of
    p (the leaves whole, blocks or not; the norms' scales held fixed)."""
    leaves = {k: v if isinstance(v, dict) else v.detach().clone().requires_grad_()
              for k, v in p.items()}
    xg = x.detach().clone().requires_grad_()
    y, _ = fn(leaves, xg)
    wrt = {k: v for k, v in leaves.items() if not isinstance(v, dict)}
    g = torch.autograd.grad((y.float() * w).sum(), [xg] + list(wrt.values()))
    return y.detach(), dict(zip(["x"] + list(wrt), g))


def _grad_pair(kind, H, M_, dtype):
    p_ref = _ref_params(kind, H)
    p = _cast(_t(p_ref), dtype)
    rng = np.random.default_rng(33)
    x = _t(rng.standard_normal((B, T, D)).astype(np.float32)).to(dtype)
    w = _t(rng.standard_normal((B, T, D)).astype(np.float32))
    apply, _, apply_tp, _, _ = _fns(kind, H)
    one = _grads(lambda q, x: apply(q, x, None), p, x, w)
    tp = _grads(lambda q, x: apply_tp(_blocks(q, kind, M_), x, None), p, x, w)
    return one, tp


@pytest.mark.parametrize("kind,H,M_", CASES, ids=IDS)
def test_tp_backward_matches_one_device(kind, H, M_):
    """f32: the gradients of a prefill's output (no state, as the train step
    runs it) with respect to the input and to every weight, each block's
    gradient landing in its slice of the whole leaf."""
    (y1, g1), (y, g) = _grad_pair(kind, H, M_, torch.float32)
    _near(y, y1, 1e-5, 1e-6, "output")
    for k in g1:
        assert g[k].dtype == g1[k].dtype == torch.float32, k
        _near(g[k], g1[k], 1e-5, 1e-7, f"gradient of {k}")


@pytest.mark.parametrize("kind,H,M_", CASES, ids=IDS)
def test_tp_bf16_rounds_as_one_device(kind, H, M_):
    """bf16 weights and input: the output of a prefill and of a decode step
    from its state, and the prefill's gradients, within one bf16 ulp (2^-7)
    of the largest entry of the one-device block's; the partial sums are
    not rounded before they meet, so no gap of several roundings builds
    up."""
    (y1, g1), (y, g) = _grad_pair(kind, H, M_, torch.bfloat16)
    assert y.dtype == y1.dtype == torch.bfloat16
    _near(y.float(), y1.float(), 2 ** -7, 0, "output")
    for k in g1:
        assert g[k].dtype == g1[k].dtype == torch.bfloat16, k
        _near(g[k].float(), g1[k].float(), 2 ** -7, 0, f"gradient of {k}")
    p = _cast(_t(_ref_params(kind, H)), torch.bfloat16)
    xs = [_t(x).bfloat16() for x in _inputs(34)[:2]]
    apply, decode, apply_tp, decode_tp, init = _fns(kind, H)
    with torch.no_grad():
        one, _ = _run(apply, decode, p, xs, init())
        tp, _ = _run(apply_tp, decode_tp, _blocks(p, kind, M_), xs, init())
    for i, (a, b) in enumerate(zip(tp, one)):
        assert a.dtype == torch.bfloat16
        _near(a.float(), b.float(), 2 ** -7, 0, f"output {i}")
