"""The reference's shape cells (``models/config.py::SHAPES``) at their
lengths, on the CPU at smoke width: the port against the reference.

``decode_32k`` and ``long_500k`` are decode steps against a cache of 32,768
and 524,288 rows.  Here the cache is drawn with numpy from a seed in the
reference's ``init_cache`` layout (``chip_smoke.cell_ref_cache``, which
phase 25(a) draws on the card machine too), handed to the reference as is
and to the port through ``convert.cache_from_reference``; the steps sit at
the cell's last indices, so the last one writes the cache's last row.  The
reference's decode step runs under ``jax.jit``, as it is served.

Under ``jax.jit`` XLA folds the reference's rotary frequencies
``1 / theta ** (i / Dh)`` to one float32 rounding of the exact value; the
port computes the same constant (the power in float64, rounded once), and
the decode cells run against the jitted reference as it is.  An angle is
position x frequency, so one ulp of a frequency would turn a key written
at 524,287 by up to 4e-3 rad.  ``decode_32k`` runs for every family:
internvl2's case first prefills its patches and a few tokens into the
drawn cache, seamless's decoder attends to its encoder's output over the
frames.  A 32,768-token prefill over 32 kv chunks of 1,024 is too
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
import torch_threads  # noqa: F401  one torch thread per test process

from repro.configs import registry as RREG
from repro.launch import steps as RSTEPS
from repro.models import encdec as RED
from repro.models import frontends as RFE
from repro.models import layers as RL
from repro.models import transformer as RTF

from repro_torch.configs import registry as REG
from repro_torch.launch import steps as STEPS
from repro_torch.models import encdec as ED
from repro_torch.models import layers as L
from repro_torch.models import transformer as TF
from repro_torch.models.config import SHAPES
from repro_torch.models.convert import cache_from_reference

from test_torch_models import ATOL, RTOL, _close, _inputs, _np_tree, _pair


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


def test_rope_freqs_equal_the_jitted_reference():
    """Every config's head_dim and rope_theta: the port's frequencies equal
    bit for bit the reference's as ``jax.jit`` folds them, which differ from
    the reference's run eagerly at some entries."""
    differ = 0
    for dh, theta in _rope_pairs():
        ours = L.rope_freqs(dh, theta).numpy()
        folded = np.asarray(jax.jit(lambda: RL.rope_freqs(dh, theta))())
        assert ours.dtype == folded.dtype == np.float32
        assert np.array_equal(ours, folded), (dh, theta)
        differ += int((ours != np.asarray(RL.rope_freqs(dh, theta))).sum())
    assert differ > 0


PREFIX_TOKENS = 4


@pytest.mark.parametrize("arch,cell,B", [
    ("granite-3-2b", "decode_32k", 2),
    ("jamba-v0.1-52b", "long_500k", 1),
    ("rwkv6-3b", "long_500k", 1),
    ("qwen1.5-32b", "decode_32k", 1),
    ("qwen2-7b", "decode_32k", 2),
    ("deepseek-7b", "decode_32k", 1),
    ("kimi-k2-1t-a32b", "decode_32k", 1),
    ("llama4-scout-17b-a16e", "decode_32k", 1),
    ("internvl2-76b", "decode_32k", 2),
    ("seamless-m4t-medium", "decode_32k", 1),
    ("jamba-v0.1-52b", "decode_32k", 1),
    ("rwkv6-3b", "decode_32k", 1),
])
def test_decode_at_the_cell_length_matches_reference(arch, cell, B):
    """Steps at indices S - 2 and S - 1 against a seeded S-row cache: each
    step's logits within ATOL / RTOL of the jitted reference's, and the
    caches after the last-row write equal to the reference's, carried layer
    by layer.  A ``vit`` model first prefills its patches and
    ``PREFIX_TOKENS`` tokens into the cache from row 0; the encoder–decoder's
    steps attend to its encoder's output over the frames."""
    S = SHAPES[cell].seq_len
    rcfg, pcfg, rparams, params = _pair(arch)
    ref = CS.cell_ref_cache(pcfg, B, S, 0)
    want = jax.eval_shape(lambda: (RED if rcfg.is_encdec else RTF).init_cache(rcfg, B, S))
    assert jax.tree.structure(ref) == jax.tree.structure(want)
    assert jax.tree.leaves(jax.tree.map(lambda a: (a.shape, a.dtype), ref)) == \
        jax.tree.leaves(jax.tree.map(lambda a: (a.shape, a.dtype), want))
    pcache = cache_from_reference(pcfg, ref)
    rcache = jax.tree.map(jnp.asarray, ref)
    del ref
    seeded_last = {i: e["k"][:, S - 1].clone() for i, e in enumerate(pcache) if "k" in e}
    if not pcfg.is_encdec:
        assert len(seeded_last) == sum(TF.layer_spec(pcfg, i)[0] == "attn"
                                       for i in range(TF.num_layers(pcfg)))
    tokens, extra = _inputs(pcfg, B, 2 + PREFIX_TOKENS, seed=1)
    rextra = pextra = None
    written = 0
    if pcfg.is_encdec:
        rextra = jax.jit(lambda p, e: RED.encode(p, e, rcfg))(rparams, jnp.asarray(extra))
        pextra = ED.encode(params, torch.from_numpy(extra), pcfg)
        _close(pextra, rextra)
    elif pcfg.frontend == "vit":
        pre = tokens[:, 2:]
        rl, rcache, _ = jax.jit(lambda p, e, t, c: RTF.forward(
            p, RFE.vlm_prepend(p, e, t, rcfg), rcfg, cache=c, cache_index=0))(
            rparams, jnp.asarray(extra), jnp.asarray(pre), rcache)
        pl, pcache, _ = STEPS._decoder_forward(pcfg)(
            params, torch.from_numpy(pre), torch.from_numpy(extra), cache=pcache, cache_index=0)
        _close(pl, rl)
        written = pcfg.frontend_seq + PREFIX_TOKENS
    rstep, pstep = jax.jit(RSTEPS.make_decode_step(rcfg)), STEPS.make_decode_step(pcfg)
    for i, idx in enumerate((S - 2, S - 1)):
        rl, rcache = rstep(rparams, rcache, jnp.asarray(tokens[:, i:i + 1]),
                           jnp.asarray(idx, jnp.int32), rextra)
        pl, pcache = pstep(params, pcache, torch.from_numpy(tokens[:, i:i + 1]), idx, pextra)
        _close(pl, rl, ATOL, RTOL)
    for n, (ours, theirs) in enumerate(zip(pcache, cache_from_reference(pcfg, _np_tree(rcache)))):
        assert ours.keys() == theirs.keys()
        for k in ours:
            if n in seeded_last:
                # the rows between the prefill's and S - 2 are the seeded ones
                _close(ours[k][:, :written], theirs[k][:, :written].numpy())
                assert torch.equal(ours[k][:, written:S - 2], theirs[k][:, written:S - 2])
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
