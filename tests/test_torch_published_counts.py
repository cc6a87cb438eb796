"""The MoE, vision-language and encoder–decoder families at their published
counts, narrow width, against the reference on the CPU.

The smoke configs cut every count the full configs publish: 8 or 4 experts,
8 patches, 16 frames.  Here each keeps the smoke config's width and depth
and takes back its published count: kimi-k2's 384 experts at top-8 (shared
expert as configured), llama4-scout's 16 experts at top-1, internvl2's 256
patches prepended and seamless's 1,024 encoder frames.  The reference's
weights come from its own ``init_params(PRNGKey(0), cfg)``, carried by
``repro_torch.models.convert``; inputs are numpy-seeded; both sides run
float32.  Held: the prefill logits, a prefill into the cache and 4 cached
decode steps at ``ATOL`` / ``RTOL`` (each step also against the port's own
full forward at the reference's 2e-3 identity bar), and one
``make_grad_fn``'s loss, aux and every gradient leaf against the
reference's ``jax.value_and_grad`` of its train step's loss, a leaf within
``GRAD_RTOL`` × max |leaf| + ``GRAD_ATOL``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  one torch thread per test process

from repro.configs import registry as RREG
from repro.launch import steps as RSTEPS
from repro.models import encdec as RED
from repro.models import transformer as RTF
from repro.models.frontends import vlm_prepend as ref_vlm_prepend

from repro_torch.configs import registry as REG
from repro_torch.launch import steps as STEPS
from repro_torch.models import encdec as ED
from repro_torch.models import transformer as TF
from repro_torch.models.convert import params_from_reference
from repro_torch.models.frontends import vlm_prepend
from repro_torch.util.tree import leaf_paths, leaves

ATOL = RTOL = 1e-4
DECODE_TOL = 2e-3
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
KEY = jax.random.PRNGKey(0)
B, T, G = 2, 16, 4

#: the published counts each smoke config takes back
PUBLISHED = {
    "kimi-k2-1t-a32b": dict(num_experts=384, top_k=8),
    "llama4-scout-17b-a16e": dict(num_experts=16, top_k=1),
    "internvl2-76b": dict(frontend_seq=256),
    "seamless-m4t-medium": dict(frontend_seq=1024),
}
ARCHS = list(PUBLISHED)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _close(port, ref, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref, np.float32),
                               atol=atol, rtol=rtol)


@functools.lru_cache(maxsize=None)
def _pair(arch):
    """(reference cfg, port cfg, reference params, port params) at smoke
    width and depth with the published counts (built once a module; no test
    writes into them)."""
    rcfg = dataclasses.replace(RREG.get_smoke_config(arch), **PUBLISHED[arch])
    pcfg = dataclasses.replace(REG.get_smoke_config(arch), **PUBLISHED[arch])
    rparams = (RED if rcfg.is_encdec else RTF).init_params(KEY, rcfg)
    return rcfg, pcfg, rparams, params_from_reference(pcfg, _np_tree(rparams))


def _inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (B, T + G)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
    extra = None
    if cfg.is_encdec or cfg.frontend == "vit":
        extra = rng.standard_normal((B, cfg.frontend_seq, cfg.d_model)).astype(np.float32)
    return tokens, labels, extra


@pytest.mark.parametrize("arch", ARCHS)
def test_counts_are_the_published_ones(arch):
    """Each override is the full config's own value, and one at least is not
    the smoke config's: the tests below run a count the smoke tests never
    build."""
    full, smoke = REG.get_config(arch), REG.get_smoke_config(arch)
    assert all(getattr(full, f) == v for f, v in PUBLISHED[arch].items())
    assert any(getattr(smoke, f) != v for f, v in PUBLISHED[arch].items())
    assert full.shared_expert == smoke.shared_expert


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_cached_decode_match_reference(arch):
    """The prefill logits; then the prompt (after the patch prefix, or
    against the encoder's output) written into a cache in one call and 4
    greedy-fed decode steps, the cache indices counting the prefix rows.
    Each step against the reference's, and the last against the port's own
    full forward over every token."""
    rcfg, pcfg, rparams, params = _pair(arch)
    tokens, _, extra = _inputs(rcfg)
    prompt = tokens[:, :T]
    rx = None if extra is None else jnp.asarray(extra)
    px = None if extra is None else torch.from_numpy(extra)
    ref = RSTEPS.make_prefill_step(rcfg)(rparams, jnp.asarray(prompt), rx)
    out = STEPS.make_prefill_step(pcfg)(params, torch.from_numpy(prompt), px)
    assert out.shape == (B, T + (pcfg.frontend_seq if pcfg.frontend == "vit" else 0), pcfg.vocab)
    _close(out, ref)

    rstep, pstep = jax.jit(RSTEPS.make_decode_step(rcfg)), STEPS.make_decode_step(pcfg)
    if pcfg.is_encdec:
        renc, penc = RED.encode(rparams, rx, rcfg), ED.encode(params, px, pcfg)
        _close(penc, renc)
        T0 = T
        rcache, pcache = RED.init_cache(rcfg, B, T0 + G), ED.init_cache(pcfg, B, T0 + G)
        rl, rcache = RED.decode(rparams, jnp.asarray(prompt), renc, rcfg, cache=rcache,
                                cache_index=jnp.zeros((), jnp.int32))
        pl, pcache = ED.decode(params, torch.from_numpy(prompt), penc, pcfg, cache=pcache,
                               cache_index=0)
    else:
        renc = penc = None
        rinp, pinp = jnp.asarray(prompt), torch.from_numpy(prompt)
        if pcfg.frontend == "vit":
            rinp = ref_vlm_prepend(rparams, rx, rinp, rcfg)
            pinp = vlm_prepend(params, px, pinp, pcfg)
        T0 = pinp.shape[1]
        rcache, pcache = RTF.init_cache(rcfg, B, T0 + G), TF.init_cache(pcfg, B, T0 + G)
        rl, rcache, _ = RTF.forward(rparams, rinp, rcfg, cache=rcache,
                                    cache_index=jnp.zeros((), jnp.int32))
        pl, pcache, _ = TF.forward(params, pinp, pcfg, cache=pcache, cache_index=0)
    _close(pl, rl)
    for i in range(G):
        tok = tokens[:, T + i:T + i + 1]
        rl, rcache = rstep(rparams, rcache, jnp.asarray(tok), jnp.asarray(T0 + i, jnp.int32),
                           renc)
        pl, pcache = pstep(params, pcache, torch.from_numpy(tok), T0 + i, penc)
        _close(pl, rl)

    # the identity: the last step's logits are the full forward's last
    # position over the prefix, the prompt and the fed tokens
    full = STEPS.make_prefill_step(pcfg)(params, torch.from_numpy(tokens), px)
    np.testing.assert_allclose(pl[:, 0].numpy(), full[:, -1].numpy(),
                               rtol=DECODE_TOL, atol=DECODE_TOL)


def _ref_loss(cfg, aux_weight=0.01):
    """The reference train step's ``loss_fn``
    (``repro.launch.steps.make_train_step``)."""

    def loss_fn(params, tokens, labels, extra=None):
        if cfg.is_encdec:
            enc_out = RED.encode(params, extra, cfg)
            logits, _ = RED.decode(params, tokens, enc_out, cfg)
            aux = jnp.zeros((), jnp.float32)
        else:
            inp = tokens
            if cfg.frontend == "vit" and extra is not None:
                inp = ref_vlm_prepend(params, extra, tokens, cfg)
                labels = jnp.pad(labels, ((0, 0), (extra.shape[1], 0)), constant_values=0)
            logits, _, aux = RTF.forward(params, inp, cfg)
        loss = RSTEPS.cross_entropy(logits, labels)
        return loss + aux_weight * aux, (loss, aux)

    return loss_fn


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_reference(arch):
    rcfg, pcfg, rparams, params = _pair(arch)
    tokens, labels, extra = _inputs(rcfg, seed=1)
    tokens = tokens[:, :T]
    (_, (rloss, raux)), rgrads = jax.jit(jax.value_and_grad(_ref_loss(rcfg), has_aux=True))(
        rparams, tokens, labels, extra)
    loss, aux, grads = STEPS.make_grad_fn(pcfg)(
        params, *[None if a is None else torch.from_numpy(a) for a in (tokens, labels, extra)])
    assert abs(float(loss) - float(rloss)) <= LOSS_RTOL * abs(float(rloss))
    assert abs(float(aux) - float(raux)) <= LOSS_RTOL * abs(float(raux)) + 1e-7
    carried = params_from_reference(pcfg, _np_tree(rgrads))
    ours, want = leaves(grads), leaves(carried)
    assert len(ours) == len(want) == len(leaves(params))
    for path, g, r in zip(leaf_paths(grads), ours, want):
        assert g.shape == r.shape, path
        tol = GRAD_RTOL * float(r.abs().max()) + GRAD_ATOL
        err = float((g - r).abs().max())
        assert err <= tol, (path, err, tol)
