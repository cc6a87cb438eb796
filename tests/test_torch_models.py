"""The port's LM tree against the reference's, on the CPU at smoke size.

The reference's weights come from its own ``init_params(PRNGKey(0), cfg)``
and are carried into the port's per-layer layout by
``repro_torch.models.convert``; token and embedding inputs are numpy-seeded.
Both sides run float32 (every ``SMOKE_CONFIG`` is float32), so logits agree
to float32 rounding: ``ATOL`` / ``RTOL``.  The decode-versus-full-forward
identity is held to the reference's own tolerance (2e-3, as
``tests/test_models.py``).  At bfloat16 (the full configs' dtype) the port
and the reference round differently op by op (see
``tests/test_torch_lm_layers.py``), and over the layers that spreads the
logits as far as bf16 itself moves them from f32, so there the port's
distance from the f32 logits is held to twice the reference's own.  Also here: the ten configs and the registry field
by field, the port's own ``init_params`` building the reference's tree, the
``scan_layers=False`` path, the refused mesh, the padded vocabulary, the
serve steps and the ``--arch`` CLI.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  one torch thread per test process

from repro.configs import registry as RREG
from repro.launch import steps as RSTEPS
from repro.models import config as RCFG
from repro.models import encdec as RED
from repro.models import frontends as RFE
from repro.models import transformer as RTF

from repro_torch.configs import registry as REG
from repro_torch.launch import serve as SERVE
from repro_torch.launch import steps as STEPS
from repro_torch.models import config as CFG
from repro_torch.models import encdec as ED
from repro_torch.models import frontends as FE
from repro_torch.models import transformer as TF
from repro_torch.models.convert import cache_from_reference, params_from_reference

ATOL = 1e-4
RTOL = 1e-4
KEY = jax.random.PRNGKey(0)
ARCHS = RREG.all_archs()
DECODE_ARCHS = ["granite-3-2b", "qwen2-7b", "rwkv6-3b", "jamba-v0.1-52b", "kimi-k2-1t-a32b"]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(arch, **overrides):
    """(reference cfg, port cfg, reference params, port params)."""
    rcfg = dataclasses.replace(RREG.get_smoke_config(arch), **overrides)
    pcfg = dataclasses.replace(REG.get_smoke_config(arch), **overrides)
    rparams = (RED if rcfg.is_encdec else RTF).init_params(KEY, rcfg)
    return rcfg, pcfg, rparams, params_from_reference(pcfg, _np_tree(rparams))


def _close(port, ref, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref, np.float32), atol=atol, rtol=rtol)


def _inputs(cfg, B, T, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
    extra = None
    if cfg.is_encdec or cfg.frontend == "vit":
        extra = rng.standard_normal((B, cfg.frontend_seq, cfg.d_model)).astype(np.float32)
    return tokens, extra


# --- configs --------------------------------------------------------------------------


def test_registry_and_shapes_equal_reference():
    assert REG.all_archs() == RREG.all_archs()
    assert REG.ARCH_IDS == RREG.ARCH_IDS
    assert {k: dataclasses.asdict(v) for k, v in CFG.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in RCFG.SHAPES.items()}
    assert [f.name for f in dataclasses.fields(CFG.ModelConfig)] == \
        [f.name for f in dataclasses.fields(RCFG.ModelConfig)]


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_reference_field_by_field(arch):
    for getter in ("get_config", "get_smoke_config"):
        ours, ref = getattr(REG, getter)(arch), getattr(RREG, getter)(arch)
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
        assert ours.padded_vocab == ref.padded_vocab
        assert ours.resolved_head_dim == ref.resolved_head_dim
        assert ours.param_count() == ref.param_count()
        assert ours.active_param_count() == ref.active_param_count()
        assert REG.supported_shapes(ours) == RREG.supported_shapes(ref)
        assert [ours.layer_kind(i) for i in range(ours.layers)] == \
            [ref.layer_kind(i) for i in range(ref.layers)]
        assert [ours.layer_is_moe(i) for i in range(ours.layers)] == \
            [ref.layer_is_moe(i) for i in range(ref.layers)]


@pytest.mark.parametrize("arch", ARCHS)
def test_port_init_builds_the_carried_reference_tree(arch):
    """The port's own seeded init has the carried reference's keys, shapes
    and dtypes, and two draws from one seed are equal."""
    rcfg, pcfg, _, carried = _pair(arch)
    init = (ED if pcfg.is_encdec else TF).init_params
    ours = init(torch.Generator().manual_seed(3), pcfg)
    spec = lambda tree: jax.tree.map(lambda t: (tuple(t.shape), t.dtype), tree)
    assert spec(ours) == spec(carried)
    again = init(torch.Generator().manual_seed(3), pcfg)
    assert all(torch.equal(a, b) for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(again)))


# --- forward ----------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_forward_matches_reference(arch):
    rcfg, pcfg, rparams, params = _pair(arch)
    B, T = 2, 16
    tokens, extra = _inputs(rcfg, B, T)
    ref = RSTEPS.make_prefill_step(rcfg)(rparams, jnp.asarray(tokens),
                                         None if extra is None else jnp.asarray(extra))
    out = STEPS.make_prefill_step(pcfg)(params, torch.from_numpy(tokens),
                                        None if extra is None else torch.from_numpy(extra))
    T_out = T + (pcfg.frontend_seq if pcfg.frontend == "vit" else 0)
    assert out.shape == (B, T_out, pcfg.vocab)
    assert bool(torch.isfinite(out).all())
    _close(out, ref)


def test_encode_and_vlm_prepend_match_reference():
    rcfg, pcfg, rparams, params = _pair("seamless-m4t-medium")
    _, extra = _inputs(rcfg, 2, 4)
    _close(ED.encode(params, torch.from_numpy(extra), pcfg),
           RED.encode(rparams, jnp.asarray(extra), rcfg))
    rcfg, pcfg, rparams, params = _pair("internvl2-76b")
    tokens, extra = _inputs(rcfg, 2, 4)
    _close(FE.vlm_prepend(params, torch.from_numpy(extra), torch.from_numpy(tokens), pcfg),
           RFE.vlm_prepend(rparams, jnp.asarray(extra), jnp.asarray(tokens), rcfg))
    for arch in ARCHS:
        ref = RFE.frontend_spec(RREG.get_config(arch), 3)
        ours = FE.frontend_spec(REG.get_config(arch), 3)
        if ref is None:
            assert ours is None
        else:
            assert ours.device.type == "meta" and tuple(ours.shape) == ref.shape
            assert str(ours.dtype).split(".")[-1] == str(ref.dtype)


BF16_ARCHS = ["granite-3-2b", "rwkv6-3b", "jamba-v0.1-52b"]


def _logits(ref, cfg, params, tokens, steps):
    """Forward logits over ``tokens[:, :-steps]`` and cached decode logits
    over all of ``tokens``, as float32 numpy, from the reference (``ref``)
    or the port."""
    B, T = tokens.shape
    pkg, tf = (RSTEPS, RTF) if ref else (STEPS, TF)
    arr = jnp.asarray if ref else torch.from_numpy
    at = (lambda t: jnp.asarray(t, jnp.int32)) if ref else (lambda t: t)
    f32 = lambda a: np.asarray(a, np.float32) if ref else a.float().numpy()
    fwd = pkg.make_prefill_step(cfg)(params, arr(tokens[:, :-steps]), None)
    step, cache, dec = pkg.make_decode_step(cfg), tf.init_cache(cfg, B, T), []
    for t in range(T):
        logits, cache = step(params, cache, arr(tokens[:, t:t + 1]), at(t))
        dec.append(f32(logits[:, 0]))
    assert fwd.dtype == logits.dtype and str(fwd.dtype).endswith(cfg.dtype)
    return f32(fwd), np.stack(dec, 1)


@pytest.mark.parametrize("arch", BF16_ARCHS)
def test_smoke_bf16_no_farther_from_f32_than_reference(arch):
    """The three full-width archs at bfloat16 through both packages: the
    forward logits over 16 tokens and 24 cached decode steps.  The port's
    max distance from the float32 logits is at most twice the reference's
    own bf16 distance from them, forward and decode each.  The float32
    logits are the port's on the carried float32 weights, which
    ``test_smoke_forward_matches_reference`` and
    ``test_decode_matches_full_forward_and_reference`` hold to the
    reference's float32 logits within ``ATOL``."""
    rcfg, pcfg, rparams, params = _pair(arch, dtype="bfloat16")
    _, p32cfg, _, params32 = _pair(arch)
    tokens, _ = _inputs(rcfg, 2, 24, seed=3)
    ours = _logits(False, pcfg, params, tokens, 8)
    ref = _logits(True, rcfg, rparams, tokens, 8)
    f32 = _logits(False, p32cfg, params32, tokens, 8)
    for what, a, r, r32 in zip(("forward", "decode"), ours, ref, f32):
        assert a.shape == r.shape and np.isfinite(a).all()
        ref_drift = float(np.abs(r - r32).max())
        assert 0 < ref_drift < np.abs(r32).max(), what
        assert float(np.abs(a - r32).max()) <= 2 * ref_drift, what


# --- cached decode ------------------------------------------------------------------------


def _decode_both(rcfg, pcfg, rparams, params, tokens, enc=None):
    """Step-by-step cached decode on both sides; each step's logits compared."""
    B, T = tokens.shape
    rstep, pstep = RSTEPS.make_decode_step(rcfg), STEPS.make_decode_step(pcfg)
    rcache = (RED if rcfg.is_encdec else RTF).init_cache(rcfg, B, T)
    pcache = (ED if pcfg.is_encdec else TF).init_cache(pcfg, B, T)
    renc, penc = (None, None) if enc is None else enc
    for t in range(T):
        rl, rcache = rstep(rparams, rcache, jnp.asarray(tokens[:, t:t + 1]),
                           jnp.asarray(t, jnp.int32), renc)
        pl, pcache = pstep(params, pcache, torch.from_numpy(tokens[:, t:t + 1]), t, penc)
        _close(pl, rl)
    return pl, pcache, rcache


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_decode_matches_full_forward_and_reference(arch):
    """Cached decode reproduces the port's full forward (the reference's own
    identity and tolerance) and each step's logits equal the reference's; the
    final cache equals the reference's, carried layout by layout."""
    rcfg, pcfg, rparams, params = _pair(arch)
    tokens, _ = _inputs(rcfg, 2, 8, seed=1)
    full, _, _ = TF.forward(params, torch.from_numpy(tokens), pcfg)
    last, pcache, rcache = _decode_both(rcfg, pcfg, rparams, params, tokens)
    np.testing.assert_allclose(last[:, 0].numpy(), full[:, -1].numpy(), rtol=2e-3, atol=2e-3)
    carried = cache_from_reference(pcfg, _np_tree(rcache))
    assert len(carried) == len(pcache) == TF.num_layers(pcfg)
    for ours, ref in zip(pcache, carried):
        assert ours.keys() == ref.keys()
        for k in ours:
            _close(ours[k].float(), ref[k].float().numpy())


def test_seamless_decode_matches_full_forward_and_reference():
    rcfg, pcfg, rparams, params = _pair("seamless-m4t-medium")
    tokens, extra = _inputs(rcfg, 2, 6, seed=2)
    renc = RED.encode(rparams, jnp.asarray(extra), rcfg)
    penc = ED.encode(params, torch.from_numpy(extra), pcfg)
    full, _ = ED.decode(params, torch.from_numpy(tokens), penc, pcfg)
    last, pcache, rcache = _decode_both(rcfg, pcfg, rparams, params, tokens, (renc, penc))
    np.testing.assert_allclose(last[:, 0].numpy(), full[:, -1].numpy(), rtol=2e-3, atol=2e-3)
    for ours, ref in zip(pcache, cache_from_reference(pcfg, _np_tree(rcache))):
        _close(ours["k"], ref["k"].numpy())
        _close(ours["v"], ref["v"].numpy())


def test_prefill_into_cache_then_decode_matches_reference():
    """The serve path of ``run_lm_smoke``: a prompt written into a longer
    cache in one call (the kv chunk cut at 4 so the prompt spans chunks and
    the last one is partly padding), then greedy decode steps."""
    rcfg, pcfg, rparams, params = _pair("jamba-v0.1-52b", attention_chunk=4)
    tokens, _ = _inputs(rcfg, 2, 8, seed=3)
    rcache, pcache = RTF.init_cache(rcfg, 2, 12), TF.init_cache(pcfg, 2, 12)
    rl, rcache, _ = RTF.forward(rparams, jnp.asarray(tokens), rcfg, cache=rcache,
                                cache_index=jnp.zeros((), jnp.int32))
    pl, pcache, _ = TF.forward(params, torch.from_numpy(tokens), pcfg, cache=pcache, cache_index=0)
    _close(pl, rl)
    tok = pl[:, -1:].argmax(-1)
    step = STEPS.make_decode_step(pcfg)
    rstep = jax.jit(RSTEPS.make_decode_step(rcfg))
    for i in range(4):
        assert torch.equal(tok, torch.from_numpy(np.array(jnp.argmax(rl[:, -1:], -1))))
        rl, rcache = rstep(rparams, rcache, jnp.asarray(tok.numpy(), jnp.int32),
                           jnp.asarray(8 + i, jnp.int32))
        pl, pcache = step(params, pcache, tok, 8 + i)
        _close(pl, rl)
        tok = pl[:, -1:].argmax(-1)


# --- layouts, options and guards -----------------------------------------------------------


@pytest.mark.parametrize("arch,overrides", [
    ("granite-3-2b", {}),
    ("jamba-v0.1-52b", {}),
    # interleaved dense/MoE without a hybrid period: the reference's
    # ``layers_dense``/``layers_moe`` stacks and per-layer cache list
    ("granite-3-2b", dict(layers=4, num_experts=4, top_k=2, moe_d_ff=64, moe_every=2)),
])
def test_unscanned_layers_and_interleaved_stacks_match_reference(arch, overrides):
    rcfg, pcfg, rparams, params = _pair(arch, **overrides)
    tokens, _ = _inputs(rcfg, 2, 8, seed=4)
    ref_scan, _, _ = RTF.forward(rparams, jnp.asarray(tokens), rcfg)
    ref_loop, _, _ = RTF.forward(rparams, jnp.asarray(tokens),
                                 dataclasses.replace(rcfg, scan_layers=False))
    ours, _, _ = TF.forward(params, torch.from_numpy(tokens), pcfg)
    ours_loop, _, _ = TF.forward(params, torch.from_numpy(tokens),
                                 dataclasses.replace(pcfg, scan_layers=False))
    assert torch.equal(ours, ours_loop)
    _close(ours, ref_scan)
    _close(ours, ref_loop)
    if overrides:
        last, pcache, rcache = _decode_both(rcfg, pcfg, rparams, params, tokens)
        for ours_c, ref_c in zip(pcache, cache_from_reference(pcfg, _np_tree(rcache))):
            _close(ours_c["k"], ref_c["k"].numpy())


def test_mesh_is_refused():
    """Only by the encoder-decoder now (the reference's encode and decode take
    no mesh).  The decoder's forward and the serve steps take a mesh: a
    dense model runs as without one, and a MoE model (kimi, 2 × 4 shards,
    8 experts) runs its MoE layers expert-parallel."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe as MOE

    mesh = make_host_mesh(8, "cpu", model=4)
    cfg = REG.get_smoke_config("granite-3-2b")
    params = TF.init_params(torch.Generator().manual_seed(0), cfg)
    tokens = torch.zeros(2, 4, dtype=torch.int32)
    with torch.inference_mode():
        plain = TF.forward(params, tokens, cfg)[0]
        assert torch.equal(TF.forward(params, tokens, cfg, mesh=mesh)[0], plain)
        assert torch.equal(STEPS.make_prefill_step(cfg, mesh)(params, tokens), plain)
        cache = TF.init_cache(cfg, 2, 5)
        TF.forward(params, tokens, cfg, cache=cache, cache_index=0)
        step, _ = STEPS.make_decode_step(cfg, mesh)(params, cache, tokens[:, :1], 4)
        assert step.shape == (2, 1, cfg.padded_vocab)

        moe_cfg = REG.get_smoke_config("kimi-k2-1t-a32b")
        assert moe_cfg.num_experts % 4 == 0
        moe_params = TF.init_params(torch.Generator().manual_seed(0), moe_cfg)
        calls = []
        real = MOE.moe_apply_ep
        MOE.moe_apply_ep = lambda *a, **k: calls.append(k["mesh"]) or real(*a, **k)
        try:
            ep, _, _ = TF.forward(moe_params, tokens, moe_cfg, mesh=mesh)
        finally:
            MOE.moe_apply_ep = real
        assert calls and all(m is mesh for m in calls)
        assert bool(torch.isfinite(ep).all())

    ecfg = REG.get_smoke_config("seamless-m4t-medium")
    eparams = ED.init_params(torch.Generator().manual_seed(0), ecfg)
    embeds = torch.zeros(1, ecfg.frontend_seq, ecfg.d_model)
    with pytest.raises(NotImplementedError, match="encoder-decoder"):
        ED.encode(eparams, embeds, ecfg, mesh=mesh)
    with pytest.raises(NotImplementedError, match="encoder-decoder"):
        ED.decode(eparams, tokens, embeds, ecfg, mesh=mesh)


def test_padded_vocab_rows_are_masked_and_never_picked():
    """granite's 49,155-row vocabulary pads to 49,280: pad logits are −1e30
    in the logits' dtype (bf16 too), as the reference's."""
    rcfg, pcfg, rparams, params = _pair("granite-3-2b", vocab=500)
    assert pcfg.padded_vocab == 512 and REG.get_config("granite-3-2b").padded_vocab == 49280
    # make the pad rows the best match for every hidden state
    rparams = dict(rparams, embedding=rparams["embedding"].at[500:].set(5.0))
    params = params_from_reference(pcfg, _np_tree(rparams))
    tokens, _ = _inputs(rcfg, 2, 8, seed=5)
    ref, _, _ = RTF.forward(rparams, jnp.asarray(tokens), rcfg)
    out, _, _ = TF.forward(params, torch.from_numpy(tokens), pcfg)
    assert bool((out[..., 500:] == -1e30).all())
    _close(out[..., :500], np.asarray(ref)[..., :500])
    assert int(out.argmax(-1).max()) < 500
    logits16 = TF.mask_pad_vocab(torch.zeros(1, 512, dtype=torch.bfloat16), pcfg)
    assert logits16.dtype == torch.bfloat16
    assert float(logits16[0, -1]) == float(torch.tensor(-1e30, dtype=torch.bfloat16))


# --- the --arch CLI ----------------------------------------------------------------------


def test_run_lm_smoke_on_cpu(capsys):
    from repro_torch.obs import get_registry
    get_registry().clear()
    SERVE.main(["--arch", "granite-3-2b", "--smoke", "--device", "cpu",
                "--batch", "2", "--prompt-len", "16", "--gen", "4"])
    out = capsys.readouterr().out
    assert "prefill 2x16:" in out and "on cpu" in out
    assert "decode 3 steps:" in out
    assert "sample tokens:" in out
    names = {r["name"] for r in get_registry().records() if r["section"] == "serve"}
    assert {"prefill_ms", "tokens_per_s"} <= names
    assert any(n.startswith("decode_step_ms") for n in names)


def test_run_lm_smoke_refuses_frontend_archs_and_missing_card():
    with pytest.raises(SystemExit):
        SERVE.main(["--arch", "seamless-m4t-medium", "--smoke", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            SERVE.main(["--arch", "granite-3-2b", "--smoke"])
