"""The port's serve steps on state in pieces, on a data 2 × model 4 mesh of
CPU shards, held against the reference's on an 8-device host mesh.

The reference needs 8 devices, which the test process must not see, so it
runs once for the module in a subprocess (its jobs compiled side by side in
threads, XLA's backend optimisation off) and pickles its outputs: for
granite-3-2b, rwkv6-3b and jamba-v0.1-52b at smoke size, under the mesh
(its MoE layers expert-parallel where the batch divides, as
``test_torch_sharded_lm.py`` runs it), the prefill step's logits, a
prefill of the prompt into the cache and one cached decode step.  The port runs the same weights (``models.convert``)
cut by ``sharded.shard_tree``, the cache cut by ``sharding.cache_pspecs``
and the batch as ``Sharded`` rows (``sharded.batch_rows``), through
``make_prefill_step`` and ``make_decode_step`` on
``make_host_mesh(8, "cpu", model=4)``.

Cases: B = 4 (one unit per data shard, two rows each) and B = 3 (no split:
one unit, the whole batch on the first shard, as the reference does not
split it), with a prompt of T = 32, and jamba at B = 4 with a prompt of
T = 16; a cache of 40 positions, so that where the kv heads (2) do not
divide the model axis (4) the cache is split along S, over model at B = 4
and over every axis at B = 3.

Held: the logits and every cache piece after the steps equal, bit for
bit at f32, to those of the same steps on whole tensors on one device
(with the mesh for expert parallelism only, as in the reference; the cache
cut by ``cache_spec``), so the pieces add no rounding of their own; the
logits on the first shard's device and within 1e-5 + 1e-5·max|ref| of the
reference's (the bar of
``test_torch_sharded_lm.py::test_forward_on_a_mesh_serves_as_the_reference``).
jamba with a prompt of 32 is held within 1e-4 + 1e-4·max|ref|, the bar of
``tests/test_torch_models.py``.  Its gap to the reference there comes from
the mamba layers' chunked scan, which both packages compute in the
factored form exp(W_t)·exp(−W_s) at f32 over one chunk of the whole
prompt: over 32 tokens the log decay spans 67-73 nats, and each package's
scan output is then 0.6e-4-1.9e-4 from the exact (float64) recurrence and
0.9e-4-2.6e-4 from the other's, at max |output| 39-65
(``test_jamba_gap_over_32_tokens_is_the_scans_f32_rounding``); over 16
tokens the span halves and jamba's logits are held at the 1e-5 bar.
The reference's own mesh run
equals its one-device run bit for bit.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_smoke_config
from repro_torch.launch import sharded as SHD
from repro_torch.launch import sharding as SH
from repro_torch.launch import steps as STEPS
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import transformer as TF
from repro_torch.models.convert import params_from_reference, to_tensor
from repro_torch.util.sharded import Sharded
from repro_torch.util.tree import leaf_paths, leaves

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("granite-3-2b", "rwkv6-3b", "jamba-v0.1-52b")
BATCHES = (4, 3)
T, S = 32, 40
#: (arch, B, prompt length) of each reference job
JOBS = [(a, b, T) for a in ARCHS for b in BATCHES] + [("jamba-v0.1-52b", 4, 16)]
#: (rtol of max|ref|, atol) against the reference
BAR = (1e-5, 1e-5)
#: jamba's over a prompt of 32, its model's own bar (see the module docstring)
JAMBA_32_BAR = (1e-4, 1e-4)

REFERENCE = r'''
import os, pickle, sys
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                           "--xla_backend_optimization_level=0 "
                           "--xla_llvm_disable_expensive_passes=true")
from concurrent.futures import ThreadPoolExecutor
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs.registry import get_smoke_config
from repro.launch import steps as STEPS
from repro.models import transformer as TF

JOBS, S = {jobs!r}, {S}
np_tree = lambda t: jax.tree.map(np.asarray, t)
mesh = Mesh(np.asarray(jax.devices()).reshape(2, 4), ("data", "model"))

def run(arch, B, T):
    cfg = get_smoke_config(arch)
    params = TF.init_params(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(B)
    tokens = jnp.asarray(rng.integers(0, cfg.vocab, (B, T + 1)).astype(np.int32))
    with mesh:
        p = params
        cache = TF.init_cache(cfg, B, S)
        prefill = jax.jit(STEPS.make_prefill_step(cfg, mesh))(p, tokens[:, :T])
        into, cache, _ = jax.jit(lambda p, t, c: TF.forward(
            p, t, cfg, cache=c, cache_index=0, mesh=mesh))(p, tokens[:, :T], cache)
        step, _ = jax.jit(STEPS.make_decode_step(cfg, mesh))(
            p, cache, tokens[:, T:], jnp.asarray(T, jnp.int32))
    return (arch, B, T), {{"params": np_tree(params), "tokens": np.asarray(tokens),
                       "prefill": np.asarray(prefill), "into": np.asarray(into),
                       "decode": np.asarray(step)}}

# XLA compiles with the GIL released: the jobs run side by side, jamba's first
jobs = sorted(JOBS, key=lambda j: not j[0].startswith("jamba"))
with ThreadPoolExecutor(6) as ex:
    out = dict(f.result() for f in [ex.submit(run, *j) for j in jobs])
with open(sys.argv[1], "wb") as fh:
    pickle.dump(out, fh)
'''


@pytest.fixture(scope="module")
def ref():
    script = REFERENCE.format(jobs=JOBS, S=S)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "ref.pkl")
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
        run = subprocess.run([sys.executable, "-c", script, path], capture_output=True,
                             text=True, timeout=600, env=env)
        assert run.returncode == 0, run.stderr[-4000:]
        with open(path, "rb") as fh:
            return pickle.load(fh)


def mesh24():
    return make_host_mesh(8, "cpu", model=4)


def _close(ours, want, bar, what):
    want = torch.as_tensor(np.asarray(want))
    assert ours.shape == want.shape, what
    err = float((ours - want).abs().max())
    assert err <= bar[0] * float(want.abs().max()) + bar[1], (what, err)


def _sharded_cache(cfg, B, mesh):
    cache = TF.init_cache(cfg, B, S)
    return SHD.shard_tree(cache, mesh, SH.cache_pspecs(cache, mesh, B))


def _serve_on_pieces(r, arch, B, T, bar):
    cfg = get_smoke_config(arch)
    mesh = mesh24()
    params = params_from_reference(cfg, r["params"])
    tokens = to_tensor(r["tokens"])
    sp = SHD.shard_tree(params, mesh)
    cache = _sharded_cache(cfg, B, mesh)
    if arch != "rwkv6-3b":
        kv = {tuple(s.spec) for p, s in zip(leaf_paths(cache), leaves(cache)) if p[-1] == "k"}
        want = ("data", "model", None, None) if B == 4 else (None, ("data", "model"), None, None)
        assert kv == {want}          # kv heads 2 do not divide model 4: S is split
    step = STEPS.make_decode_step(cfg, mesh)
    with torch.inference_mode():
        prefill = STEPS.make_prefill_step(cfg, mesh)(sp, SHD.batch_rows(tokens[:, :T], mesh))
        into, cache2 = step(sp, cache, SHD.batch_rows(tokens[:, :T], mesh), 0)
        logits, cache3 = step(sp, cache, SHD.batch_rows(tokens[:, T:], mesh), T)
    assert cache2 is cache and cache3 is cache           # updated in place
    assert prefill.device == mesh.devices[0] == logits.device
    _close(prefill, r["prefill"], bar, "prefill")
    _close(into, r["into"], bar, "prefill into the cache")
    _close(logits, r["decode"], bar, "decode")

    # the same steps on whole tensors on one device, the mesh for EP only
    whole = TF.init_cache(cfg, B, S)
    with torch.inference_mode():
        one_prefill = STEPS.make_prefill_step(cfg, mesh)(params, tokens[:, :T])
        one_into, whole, _ = TF.forward(params, tokens[:, :T], cfg, cache=whole, cache_index=0,
                                        mesh=mesh)
        one, whole = STEPS.make_decode_step(cfg, mesh)(params, whole, tokens[:, T:], T)
    assert torch.equal(one_prefill, prefill) and torch.equal(one_into, into)
    assert torch.equal(one, logits)
    specs = SH.cache_pspecs(whole, mesh, B)
    for path, s, w, spec in zip(leaf_paths(cache), leaves(cache), leaves(whole), leaves(specs)):
        assert s.spec == spec and s.shape == w.shape, path
        for got, want in zip(s.pieces, Sharded.from_full(w, mesh, spec).pieces):
            assert got.dtype == want.dtype == torch.float32
            assert torch.equal(got, want), path


@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_steps_on_pieces_match_the_reference(ref, arch, B):
    bar = JAMBA_32_BAR if arch == "jamba-v0.1-52b" else BAR
    _serve_on_pieces(ref[(arch, B, T)], arch, B, T, bar)


def test_jamba_on_pieces_matches_the_reference_over_a_short_prompt(ref):
    """jamba, B = 4, a prompt of 16: within the 1e-5 bar, where the mamba
    scan's log decay spans half of what it does over 32 tokens."""
    _serve_on_pieces(ref[("jamba-v0.1-52b", 4, 16)], "jamba-v0.1-52b", 4, 16, BAR)


def _exact_scan(r, k, v, log_w):
    """The recurrence the chunked scan computes, step by step in float64:
    o_t = r_t · S_{t-1}, S_t = diag(w_t) S_{t-1} + k_t v_tᵀ, from S = 0."""
    r, k, v, log_w = (a.double() for a in (r, k, v, log_w))
    S = torch.zeros(*r.shape[:2], r.shape[-1], v.shape[-1], dtype=torch.float64)
    out = []
    for t in range(r.shape[2]):
        out.append(torch.einsum("bhk,bhkv->bhv", r[:, :, t], S))
        S = S * log_w[:, :, t].exp()[..., None] + k[:, :, t, :, None] * v[:, :, t, None, :]
    return torch.stack(out, 2)


def test_jamba_gap_over_32_tokens_is_the_scans_f32_rounding(ref, monkeypatch):
    """What puts jamba's logits past the 1e-5 bar over a prompt of 32: each
    mamba layer's chunked scan, port and reference alike, on the inputs the
    port's forward gives it.  Each package's f32 output is within
    4e-6·max|exact| of the float64 recurrence, and the port's is no more
    than 2x as far from it as the reference's: the two differ by their own
    rounding of the factored form, not by a fault of either (``-s`` prints
    the readings)."""
    import jax.numpy as jnp
    from repro.models import linear_attention as RLA
    from repro_torch.models import mamba as PM

    r = ref[("jamba-v0.1-52b", 4, T)]
    cfg = get_smoke_config("jamba-v0.1-52b")
    calls, scan = [], PM.chunked_linear_attention
    monkeypatch.setattr(PM, "chunked_linear_attention",
                        lambda *a, **k: calls.append((a, k)) or scan(*a, **k))
    with torch.inference_mode():
        TF.forward(params_from_reference(cfg, r["params"]), to_tensor(r["tokens"])[:, :T], cfg)
    assert len(calls) == sum(cfg.layer_kind(i) == "mamba" for i in range(cfg.layers)) > 0
    for (rr, k, v, log_w), kw in calls:
        exact = _exact_scan(rr, k, v, log_w)
        port = scan(rr, k, v, log_w, **kw)[0].double()
        theirs = torch.tensor(np.asarray(RLA.chunked_linear_attention(
            *(jnp.asarray(a.numpy()) for a in (rr, k, v, log_w)), chunk=kw["chunk"])[0]),
            dtype=torch.float64)
        scale = float(exact.abs().max())
        e_port, e_ref = float((port - exact).abs().max()), float((theirs - exact).abs().max())
        span = -float(torch.cumsum(log_w, 2).min())
        print(f"span {span:.1f} nats, max|exact| {scale:.3f}: |port - exact| {e_port:.3e}, "
              f"|reference - exact| {e_ref:.3e}, |port - reference| "
              f"{float((port - theirs).abs().max()):.3e}")
        assert max(e_port, e_ref) <= 4e-6 * scale and e_port <= 2 * e_ref


def test_decode_writes_back_only_the_positions_it_wrote():
    """granite, B = 4, S split over model: a decode step at position 33
    changes only that position of the pieces (here in the fourth S block,
    owned by the last model shard of each data row)."""
    cfg = get_smoke_config("granite-3-2b")
    mesh = mesh24()
    params = TF.init_params(torch.Generator().manual_seed(0), cfg)
    sp = SHD.shard_tree(params, mesh)
    cache = _sharded_cache(cfg, 4, mesh)
    for s in leaves(cache):
        for p in s.pieces:
            p.fill_(7.0)
    tokens = torch.zeros(4, 1, dtype=torch.int32)
    with torch.inference_mode():
        STEPS.make_decode_step(cfg, mesh)(sp, cache, SHD.batch_rows(tokens, mesh), 33)
    for s in leaves(cache):
        full = s.full()
        changed = (full != 7.0).any(dim=(0, 2, 3)).nonzero().flatten().tolist()
        assert changed == [33]
        assert [b for b, p in zip(s.blocks(), s.pieces) if bool((p != 7.0).any())] == \
            [(0, 3, 0, 0), (1, 3, 0, 0)]


def test_serve_steps_refuse_state_they_cannot_run():
    """Nothing falls back onto the first shard: mixed state, pieces without
    a mesh of several shards, a cache cut for another batch and the
    encoder–decoder's state in pieces raise."""
    cfg = dataclasses.replace(get_smoke_config("granite-3-2b"), layers=1)
    mesh = mesh24()
    params = TF.init_params(torch.Generator().manual_seed(0), cfg)
    sp = SHD.shard_tree(params, mesh)
    tokens = torch.zeros(4, 1, dtype=torch.int32)
    whole = TF.init_cache(cfg, 4, S)
    with torch.inference_mode():
        with pytest.raises(ValueError, match="not mixed"):
            STEPS.make_decode_step(cfg, mesh)(sp, whole, tokens, 3)
        with pytest.raises(ValueError, match="several shards"):
            STEPS.make_prefill_step(cfg)(sp, tokens)
        other = _sharded_cache(cfg, 3, mesh)            # cut for B = 3: one unit
        with pytest.raises(ValueError, match="not cut for a batch of 4"):
            STEPS.make_decode_step(cfg, mesh)(sp, other, tokens, 3)
        ecfg = get_smoke_config("seamless-m4t-medium")
        from repro_torch.models import encdec as ED
        ep = SHD.shard_tree(ED.init_params(torch.Generator().manual_seed(0), ecfg), mesh)
        with pytest.raises(ValueError, match="encoder-decoder"):
            STEPS.make_prefill_step(ecfg, mesh)(ep, tokens, torch.zeros(4, 4, ecfg.d_model))


def test_expert_leaves_stay_in_their_model_pieces():
    """jamba, B = 4: each unit takes the expert leaves as their model
    pieces (gathered over data onto the model shards only), never whole."""
    cfg = get_smoke_config("jamba-v0.1-52b")
    mesh = mesh24()
    sp = SHD.shard_tree(TF.init_params(torch.Generator().manual_seed(0), cfg), mesh)
    whole, pieces = [], []
    real_full, real_mp = Sharded.full, Sharded.model_pieces
    try:
        Sharded.full = lambda s, *a, **k: whole.append(s.shape) or real_full(s, *a, **k)
        Sharded.model_pieces = lambda s, *a, **k: pieces.append(s.shape) or real_mp(s, *a, **k)
        with torch.inference_mode():
            STEPS.make_prefill_step(cfg, mesh)(sp, torch.zeros(4, 8, dtype=torch.int32))
    finally:
        Sharded.full, Sharded.model_pieces = real_full, real_mp
    n_moe = sum(TF.layer_spec(cfg, i)[1] for i in range(TF.num_layers(cfg)))
    E = cfg.num_experts
    assert len(pieces) == 2 * 3 * n_moe and all(s[0] == E for s in pieces)
    assert not any(len(s) == 3 and s[0] == E for s in whole)
