"""The port's serve steps on state in pieces, on data 2 × model 4 and
data 2 × model 2 meshes of CPU shards, held against the reference's on
host meshes of the same shapes.

The reference needs 8 devices, which the test process must not see, so it
runs once for the module in a subprocess (started with the module's first
test, its jobs compiled side by side in threads, XLA's backend
optimisation off) and pickles its outputs: for
granite-3-2b, rwkv6-3b and jamba-v0.1-52b at smoke size, under the mesh
(its MoE layers expert-parallel where the batch divides, as
``test_torch_sharded_lm.py`` runs it), the prefill step's logits, a
prefill of the prompt into the cache and one cached decode step.  The port runs the same weights (``models.convert``)
cut by ``sharded.shard_tree``, the cache cut by ``sharding.cache_pspecs``
and the batch as ``Sharded`` rows (``sharded.batch_rows``), through
``make_prefill_step`` and ``make_decode_step`` on
``make_host_mesh(8, "cpu", model=4)``; granite (B = 4 and 3, against the
reference on a 2 × 2 host mesh), rwkv6 (B = 4 and 3) and jamba (B = 4,
a prompt of 16, and B = 3), against the reference's runs on 2 × 4, also
on ``make_host_mesh(4, "cpu", model=2)``.
On 2 × 4 the MLPs, the vocabulary, jamba's mamba mixers (4 heads) and
rwkv6's channel mix run tensor-parallel and attention (2 kv heads over
model 4) and rwkv6's time mix (2 heads) are gathered whole; on 2 × 2, where
the smoke configs' 4 heads and 2 kv heads and rwkv6's 2 heads divide,
attention and the time mix too, each model shard reading and writing its
own piece of the K/V cache.  A recurrent state keeps ``cache_spec``'s cut
(batch over data, whole over model): the unit gathers it whole and each
model shard scans its heads' slice.

Cases: B = 4 (one unit per data shard, two rows each) and B = 3 (no split:
one unit, the whole batch on the first shard, as the reference does not
split it), with a prompt of T = 32, and jamba at B = 4 with a prompt of
T = 16; a cache of 40 positions, so that where the kv heads (2) do not
divide the model axis (4) the cache is split along S, over model at B = 4
and over every axis at B = 3.

Held: the logits and every cache piece after the steps against those of
the same steps on whole tensors on one device (with the mesh for expert
parallelism only, as in the reference; the cache cut by ``cache_spec``):
within 1e-5 + 1e-5·max|one device|, since every model here has
tensor-parallel layers on these meshes, whose partial sums change the
order of additions (rwkv6 on 2 × 4 was held bit for bit while only its
embeddings split; its channel mix, d_ff 256 over 4, now runs
tensor-parallel there); the
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
import torch_threads  # noqa: F401  one torch thread per test process

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
#: the data x model meshes: on 2 x 2 the smoke configs' 4 heads and 2 kv
#: heads divide over model, on 2 x 4 they do not
MESHES = {"2x4": (2, 4), "2x2": (2, 2)}
#: (arch, B, prompt length, mesh) of each reference job
JOBS = ([(a, b, T, "2x4") for a in ARCHS for b in BATCHES] + [("jamba-v0.1-52b", 4, 16, "2x4")]
        + [("granite-3-2b", b, T, "2x2") for b in BATCHES])
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

JOBS, S, MESHES = {jobs!r}, {S}, {meshes!r}
np_tree = lambda t: jax.tree.map(np.asarray, t)
devs = np.asarray(jax.devices())
meshes = {{k: Mesh(devs[:d * m].reshape(d, m), ("data", "model")) for k, (d, m) in MESHES.items()}}

def run(arch, B, T, name):
    mesh = meshes[name]
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
    return (arch, B, T, name), {{"params": np_tree(params), "tokens": np.asarray(tokens),
                       "prefill": np.asarray(prefill), "into": np.asarray(into),
                       "decode": np.asarray(step)}}

# XLA compiles with the GIL released: the jobs run side by side, jamba's first
jobs = sorted(JOBS, key=lambda j: not j[0].startswith("jamba"))
with ThreadPoolExecutor(6) as ex:
    out = dict(f.result() for f in [ex.submit(run, *j) for j in jobs])
with open(sys.argv[1], "wb") as fh:
    pickle.dump(out, fh)
'''


@pytest.fixture(scope="module", autouse=True)
def _reference_run():
    """Start the reference's subprocess with the module's first test; :func:`ref`
    waits for it, and the tests that do not need it run meanwhile."""
    d = tempfile.TemporaryDirectory()
    path = os.path.join(d.name, "ref.pkl")
    script = REFERENCE.format(jobs=JOBS, S=S, meshes=MESHES)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    with open(path + ".err", "w") as err:      # a file, not a pipe that could fill
        proc = subprocess.Popen([sys.executable, "-c", script, path], stdout=subprocess.DEVNULL,
                                stderr=err, env=env)
    state = {"proc": proc, "path": path, "out": None}
    yield state
    if proc.poll() is None:
        proc.kill()
    proc.wait()
    d.cleanup()


@pytest.fixture(scope="module")
def ref(_reference_run):
    st = _reference_run
    if st["out"] is None:
        rc = st["proc"].wait(timeout=600)
        with open(st["path"] + ".err") as fh:
            assert rc == 0, fh.read()[-4000:]
        with open(st["path"], "rb") as fh:
            st["out"] = pickle.load(fh)
    return st["out"]


def mesh_of(name):
    data, model = MESHES[name]
    return make_host_mesh(data * model, "cpu", model=model)


def mesh24():
    return mesh_of("2x4")


def _close(ours, want, bar, what):
    want = torch.as_tensor(np.asarray(want))
    assert ours.shape == want.shape, what
    err = float((ours - want).abs().max())
    assert err <= bar[0] * float(want.abs().max()) + bar[1], (what, err)


def _sharded_cache(cfg, B, mesh):
    cache = TF.init_cache(cfg, B, S)
    return SHD.shard_tree(cache, mesh, SH.cache_pspecs(cache, mesh, B))


def _serve_on_pieces(r, arch, B, T, bar, mesh_name="2x4"):
    cfg = get_smoke_config(arch)
    mesh = mesh_of(mesh_name)
    params = params_from_reference(cfg, r["params"])
    tokens = to_tensor(r["tokens"])
    sp = SHD.shard_tree(params, mesh)
    cache = _sharded_cache(cfg, B, mesh)
    if arch != "rwkv6-3b":
        kv = {tuple(s.spec) for p, s in zip(leaf_paths(cache), leaves(cache)) if p[-1] == "k"}
        if B % 2:            # one unit: S over every axis
            want = (None, ("data", "model"), None, None)
        elif cfg.kv_heads % mesh.shape["model"]:
            want = ("data", "model", None, None)     # kv heads 2 do not divide model 4: S
        else:
            want = ("data", None, "model", None)     # they divide model 2: tensor-parallel
        assert kv == {want}
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

    # the same steps on whole tensors on one device, the mesh for EP only:
    # within the f32 bar, since the partial sums of the tensor-parallel
    # layers (every model has some on these meshes) change the order of
    # additions
    assert any(SH.tp_dim(cfg, p[2:], s.spec, mesh) is not None
               for p, s in zip(leaf_paths(sp), leaves(sp)) if p[0] == "layers")
    held = lambda ours, want, what: _close(ours, want, BAR, what)    # noqa: E731

    whole = TF.init_cache(cfg, B, S)
    with torch.inference_mode():
        one_prefill = STEPS.make_prefill_step(cfg, mesh)(params, tokens[:, :T])
        one_into, whole, _ = TF.forward(params, tokens[:, :T], cfg, cache=whole, cache_index=0,
                                        mesh=mesh)
        one, whole = STEPS.make_decode_step(cfg, mesh)(params, whole, tokens[:, T:], T)
    held(prefill, one_prefill, "prefill against one device")
    held(into, one_into, "prefill into the cache against one device")
    held(logits, one, "decode against one device")
    specs = SH.cache_pspecs(whole, mesh, B)
    for path, s, w, spec in zip(leaf_paths(cache), leaves(cache), leaves(whole), leaves(specs)):
        assert s.spec == spec and s.shape == w.shape, path
        for got, want in zip(s.pieces, Sharded.from_full(w, mesh, spec).pieces):
            assert got.dtype == want.dtype == torch.float32
            held(got, want, path)


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


def test_tensor_parallel_decode_writes_each_cache_piece_in_place():
    """granite, B = 4, on data 2 x model 2 (kv heads split over model): a
    decode step at position 33 writes position 33 of every K/V piece, each
    the same tensor as before the step (model shard m's own piece, written
    in place by its attention), and nothing else."""
    cfg = get_smoke_config("granite-3-2b")
    mesh = mesh_of("2x2")
    sp = SHD.shard_tree(TF.init_params(torch.Generator().manual_seed(0), cfg), mesh)
    cache = _sharded_cache(cfg, 4, mesh)
    for s in leaves(cache):
        assert tuple(s.spec) == ("data", None, "model", None)
        for p in s.pieces:
            p.fill_(7.0)
    before = [p for s in leaves(cache) for p in s.pieces]
    tokens = torch.zeros(4, 1, dtype=torch.int32)
    with torch.inference_mode():
        STEPS.make_decode_step(cfg, mesh)(sp, cache, SHD.batch_rows(tokens, mesh), 33)
    after = [p for s in leaves(cache) for p in s.pieces]
    assert len(after) == len(before) == 4 * 2 * cfg.layers
    assert all(a is b for a, b in zip(after, before))
    for p in after:
        assert (p != 7.0).any(dim=(0, 2, 3)).nonzero().flatten().tolist() == [33]


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
    pieces (gathered over data onto the model shards only), never whole;
    so too the tensor-parallel leaves (on 2 x 4 the dense MLPs, the mamba
    mixers' projections, one head a shard, and the two embeddings, by their
    column, row or vocabulary blocks), while attention (2 kv heads over
    model 4) and the mixers' norms, step projections and per-head vectors come
    whole."""
    cfg = get_smoke_config("jamba-v0.1-52b")
    mesh = mesh24()
    sp = SHD.shard_tree(TF.init_params(torch.Generator().manual_seed(0), cfg), mesh)
    paths = {id(s): p for p, s in zip(leaf_paths(sp), leaves(sp))}
    whole, pieces = [], []
    real_full, real_mp = Sharded.full, Sharded.model_pieces
    try:
        Sharded.full = lambda s, *a, **k: whole.append(paths.get(id(s))) or real_full(s, *a, **k)
        Sharded.model_pieces = lambda s, *a, **k: (pieces.append(paths[id(s)])
                                                   or real_mp(s, *a, **k))
        with torch.inference_mode():
            STEPS.make_prefill_step(cfg, mesh)(sp, torch.zeros(4, 8, dtype=torch.int32))
    finally:
        Sharded.full, Sharded.model_pieces = real_full, real_mp
    n_moe = sum(TF.layer_spec(cfg, i)[1] for i in range(TF.num_layers(cfg)))
    experts = [p for p in pieces if "moe" in p]
    assert len(experts) == 2 * 3 * n_moe and all(p[-1] in SHD._EXPERT_LEAVES for p in experts)
    n_mlp = sum("mlp" in lp for lp in sp["layers"])
    projections = ("w_in", "w_gate", "w_B", "w_C", "w_out")
    tp = [p for p in leaf_paths(sp) if "mlp" in p or ("mixer" in p and p[-1] in projections)
          or p in (("embedding",), ("unembedding",))]
    assert sorted(p for p in pieces if "moe" not in p) == sorted(tp * 2)
    assert n_mlp > 0 and not any(p is not None and (p in tp or p in experts) for p in whole)
    assert {p[-1] for p in whole if p is not None and "attn" in p} == {"wq", "wk", "wv", "wo"}
    assert {p[-1] for p in whole if p is not None and "mixer" in p} == {
        "scale", "w_dt", "dt_bias", "A_log", "D_skip"}


# --- against the reference's outputs: these run last, so that the reference's
# subprocess, started with the module's first test, runs beside the tests above ---------


@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_steps_on_pieces_match_the_reference(ref, arch, B):
    """On data 2 x model 4: the MLP and the vocabulary run tensor-parallel,
    attention (2 kv heads over model 4) is gathered whole."""
    bar = JAMBA_32_BAR if arch == "jamba-v0.1-52b" else BAR
    _serve_on_pieces(ref[(arch, B, T, "2x4")], arch, B, T, bar)


@pytest.mark.parametrize("B", BATCHES)
def test_tensor_parallel_serve_steps_match_the_reference(ref, B):
    """granite on data 2 x model 2, where its 4 heads and 2 kv heads divide:
    attention, MLP and vocabulary run tensor-parallel, and at B = 4 each
    model shard reads and writes its own piece of the K/V cache; at B = 3
    (one unit, the cache cut along S) the decode steps gather attention
    whole."""
    _serve_on_pieces(ref[("granite-3-2b", B, T, "2x2")], "granite-3-2b", B, T, BAR, "2x2")


@pytest.mark.parametrize("arch,B", [("rwkv6-3b", 4), ("rwkv6-3b", 3), ("jamba-v0.1-52b", 3)])
def test_recurrent_tensor_parallel_serve_steps_match_the_reference(ref, arch, B):
    """rwkv6 and jamba on data 2 x model 2, against the reference's steps on
    2 x 4 (its mesh runs equal its one-device run bit for bit): rwkv6's time
    mix (one head a shard) and channel mix, jamba's mamba mixers (two heads
    a shard) tensor-parallel, every recurrent state gathered whole onto its
    unit's device and scanned by heads on the model shards.  At B = 3 one
    unit runs the whole batch, its state whole on the first shard: the
    recurrent layers need no counterpart of attention's fallback for a
    cache cut along S (jamba's attention falls back; over 32 tokens at its
    model's bar).  jamba at B = 4 is
    ``test_jamba_tensor_parallel_and_expert_parallel_match_the_reference``."""
    bar = JAMBA_32_BAR if arch == "jamba-v0.1-52b" else BAR
    _serve_on_pieces(ref[(arch, B, T, "2x4")], arch, B, T, bar, "2x2")


def test_jamba_on_pieces_matches_the_reference_over_a_short_prompt(ref):
    """jamba, B = 4, a prompt of 16: within the 1e-5 bar, where the mamba
    scan's log decay spans half of what it does over 32 tokens."""
    _serve_on_pieces(ref[("jamba-v0.1-52b", 4, 16, "2x4")], "jamba-v0.1-52b", 4, 16, BAR)


def test_jamba_tensor_parallel_and_expert_parallel_match_the_reference(ref):
    """jamba, B = 4, a prompt of 16, on data 2 x model 2: its attention, MLP
    and vocabulary tensor-parallel and its experts expert-parallel over the
    same model shards, within the 1e-5 bar of the reference's steps on
    2 x 4 (the reference's mesh runs equal its one-device run, and each data
    shard's expert capacity comes from its own rows on either mesh)."""
    _serve_on_pieces(ref[("jamba-v0.1-52b", 4, 16, "2x4")], "jamba-v0.1-52b", 4, 16, BAR, "2x2")


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

    r = ref[("jamba-v0.1-52b", 4, T, "2x4")]
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
