"""The reference's shape cells (``models/config.py::SHAPES``) at their
lengths, on the CPU at smoke width: the port against the reference.

``decode_32k`` and ``long_500k`` are decode steps against a cache of 32,768
and 524,288 rows.  Here the cache is drawn with numpy from a seed in the
reference's ``init_cache`` layout (``chip_smoke.cell_ref_cache``, which
phase 25(a) draws on the card machine too), handed to the reference as is
and to the port through ``convert.cache_from_reference``; the steps sit at
the cell's last indices, so the last one writes the cache's last row.  The
reference's decode step runs under ``jax.jit``, as it is served.

One difference is kept (ROADMAP, F3): under ``jax.jit`` XLA folds the
reference's rotary frequencies ``1 / theta ** (i / Dh)`` to the correctly
rounded float32 value, where the port, like the reference run eagerly,
rounds twice and lands one ulp off at some i.  An angle is position x
frequency, so at 524,287 a written key turns by up to 4e-3 rad against the
jitted reference's (1e-5 at 2,047).  The decode cells therefore run the
jitted reference with the port's frequencies (``rope_freqs`` patched to
the port's values, the package unchanged), and the frequencies are pinned
on their own.  A 32,768-token prefill over 32 kv chunks of 1,024 is too
slow here; the same 32-chunk span is a granite prefill with
``attention_chunk=64`` over 2,040 tokens into 2,048 rows, against the
reference as it is.  Logits and caches are held at ``test_torch_models``'
float32 bars, the decode-versus-forward identity at the reference's own
2e-3.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as RREG
from repro.launch import steps as RSTEPS
from repro.models import layers as RL
from repro.models import transformer as RTF

from repro_torch.configs import registry as REG
from repro_torch.launch import steps as STEPS
from repro_torch.models import layers as L
from repro_torch.models import transformer as TF
from repro_torch.models.config import SHAPES
from repro_torch.models.convert import cache_from_reference

from test_torch_models import ATOL, RTOL, _close, _np_tree, _pair


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()


def test_shape_cells_and_their_archs_equal_reference():
    """The four cells and which of them each arch runs (``long_500k`` only
    the rwkv and hybrid archs)."""
    from repro.models.config import SHAPES as RSHAPES

    assert {k: vars(v) for k, v in SHAPES.items()} == {k: vars(v) for k, v in RSHAPES.items()}
    for arch in REG.all_archs():
        assert REG.supported_shapes(REG.get_config(arch)) == RREG.supported_shapes(
            RREG.get_config(arch))
    assert [a for a in REG.all_archs() if "long_500k" in REG.supported_shapes(
        REG.get_config(a))] == ["rwkv6-3b", "jamba-v0.1-52b"]


def _rope_pairs():
    return sorted({(get(a).resolved_head_dim, get(a).rope_theta)
                   for a in REG.all_archs() for get in (REG.get_config, REG.get_smoke_config)})


def test_rope_freqs_lie_one_ulp_from_the_reference():
    """Every config's head_dim and rope_theta: the port's frequencies lie
    within one float32 ulp of the reference's, run eagerly and folded by
    ``jax.jit`` (F3, kept); the folded ones differ at some entries."""
    differ = 0
    for dh, theta in _rope_pairs():
        ours = L.rope_freqs(dh, theta).numpy()
        folded = np.asarray(jax.jit(lambda: RL.rope_freqs(dh, theta))())
        for ref in (np.asarray(RL.rope_freqs(dh, theta)), folded):
            assert np.all(np.abs(ours - ref) <= np.spacing(ours)), (dh, theta)
        differ += int((ours != folded).sum())
    assert differ > 0


@pytest.fixture
def port_rope(monkeypatch):
    """The reference's ``rope_freqs`` returning the port's values, so that a
    jitted reference step rotates by the port's frequencies (F3)."""
    ours = {(dh, theta): L.rope_freqs(dh, theta).numpy() for dh, theta in _rope_pairs()}
    monkeypatch.setattr(RL, "rope_freqs", lambda dh, theta=10000.0: jnp.asarray(ours[dh, theta]))


@pytest.mark.parametrize("arch,cell,B", [
    ("granite-3-2b", "decode_32k", 2),
    ("jamba-v0.1-52b", "long_500k", 1),
    ("rwkv6-3b", "long_500k", 1),
])
def test_decode_at_the_cell_length_matches_reference(arch, cell, B, port_rope):
    """Steps at indices S - 2 and S - 1 against a seeded S-row cache: each
    step's logits within ATOL / RTOL of the reference's, and the caches after
    the last-row write equal to the reference's, carried layer by layer."""
    S = SHAPES[cell].seq_len
    rcfg, pcfg, rparams, params = _pair(arch)
    ref = CS.cell_ref_cache(pcfg, B, S, 0)
    want = jax.eval_shape(lambda: RTF.init_cache(rcfg, B, S))
    assert jax.tree.structure(ref) == jax.tree.structure(want)
    assert jax.tree.leaves(jax.tree.map(lambda a: (a.shape, a.dtype), ref)) == \
        jax.tree.leaves(jax.tree.map(lambda a: (a.shape, a.dtype), want))
    pcache = cache_from_reference(pcfg, ref)
    rcache = jax.tree.map(jnp.asarray, ref)
    del ref
    seeded_last = {i: e["k"][:, S - 1].clone() for i, e in enumerate(pcache) if "k" in e}
    assert len(seeded_last) == sum(TF.layer_spec(pcfg, i)[0] == "attn"
                                   for i in range(TF.num_layers(pcfg)))
    rstep, pstep = jax.jit(RSTEPS.make_decode_step(rcfg)), STEPS.make_decode_step(pcfg)
    tokens = np.random.default_rng(1).integers(0, pcfg.vocab, (B, 2)).astype(np.int32)
    for i, idx in enumerate((S - 2, S - 1)):
        rl, rcache = rstep(rparams, rcache, jnp.asarray(tokens[:, i:i + 1]),
                           jnp.asarray(idx, jnp.int32))
        pl, pcache = pstep(params, pcache, torch.from_numpy(tokens[:, i:i + 1]), idx)
        _close(pl, rl, ATOL, RTOL)
    for n, (ours, theirs) in enumerate(zip(pcache, cache_from_reference(pcfg, _np_tree(rcache)))):
        assert ours.keys() == theirs.keys()
        for k in ours:
            if n in seeded_last:
                # the rows below S - 2 are the seeded ones on both sides
                assert torch.equal(ours[k][:, :S - 2], theirs[k][:, :S - 2])
                _close(ours[k][:, S - 2:], theirs[k][:, S - 2:].numpy())
            else:
                _close(ours[k], theirs[k].numpy())
        if n in seeded_last:
            assert not torch.equal(ours["k"][:, S - 1], seeded_last[n])


def test_cached_prefill_over_32_kv_chunks_then_decode_to_the_last_row():
    """granite with ``attention_chunk=64``: a cached prefill of 2,040 tokens
    into 2,048 rows (32 kv chunks, the last partly padding), then 8 greedy
    steps to row 2,047, each against the reference, and against the port's
    own uncached forward over the same 2,048 tokens within 2e-3 + 2e-3
    |logit|."""
    S, P, B = 2048, 2040, 1
    rcfg, pcfg, rparams, params = _pair("granite-3-2b", attention_chunk=64)
    assert S // pcfg.attention_chunk == SHAPES["prefill_32k"].seq_len // 1024 == 32
    prompt = np.random.default_rng(5).integers(0, pcfg.vocab, (B, P)).astype(np.int32)
    rl, rcache, _ = jax.jit(lambda p, t, c: RTF.forward(p, t, rcfg, cache=c,
                                                        cache_index=jnp.zeros((), jnp.int32)))(
        rparams, jnp.asarray(prompt), RTF.init_cache(rcfg, B, S))
    pl, pcache, _ = TF.forward(params, torch.from_numpy(prompt), pcfg,
                               cache=TF.init_cache(pcfg, B, S), cache_index=0)
    _close(pl, rl)
    steps, fed = [pl[:, -1]], []
    tok = pl[:, -1:].argmax(-1)
    rstep, pstep = jax.jit(RSTEPS.make_decode_step(rcfg)), STEPS.make_decode_step(pcfg)
    rl = rl[:, -1:]
    for idx in range(P, S):
        assert torch.equal(tok, torch.from_numpy(np.array(jnp.argmax(rl, -1))))
        fed.append(tok)
        rl, rcache = rstep(rparams, rcache, jnp.asarray(tok.numpy(), jnp.int32),
                           jnp.asarray(idx, jnp.int32))
        pl, pcache = pstep(params, pcache, tok, idx)
        _close(pl, rl)
        steps.append(pl[:, 0])
        tok = pl[:, -1:].argmax(-1)
    for ours, theirs in zip(pcache, cache_from_reference(pcfg, _np_tree(rcache))):
        _close(ours["k"], theirs["k"].numpy())
        _close(ours["v"], theirs["v"].numpy())
    full, _, _ = TF.forward(params, torch.cat([torch.from_numpy(prompt)] + fed, 1).long(), pcfg)
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(), full[:, P - 1:].numpy(),
                               rtol=2e-3, atol=2e-3)
