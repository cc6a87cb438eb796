"""The port's sharded LM path on a mesh of CPU shards, held against the
reference's on an 8-device host mesh.

The reference needs 8 devices (``--xla_force_host_platform_device_count``),
which the test process must not see, so it runs once for the module in a
subprocess (as ``tests/test_distributed.py`` runs it; its jobs compile side
by side in threads) and pickles its outputs: ``moe_apply_ep`` and
``moe_apply``, the 2 × 4 sharded prefill and a decode step of jamba, the
sharded train step's loss, gradients and updated parameters for qwen2-7b
(2 layers), jamba and rwkv6 at smoke size, ``compress_grads`` under a data
axis of 8, and ``rebuild_mesh_after_failure``.
The port runs the same inputs, with the reference's weights carried by
``models.convert``, on ``make_host_mesh(8, "cpu", model=4)``, where the
MLPs, the vocabulary, jamba's mamba mixers and rwkv6's channel mix run
tensor-parallel; the train steps also on ``make_host_mesh(4, "cpu",
model=2)`` against the reference on a 2 × 2 host mesh, where attention and
rwkv6's time mix do too.
The subprocess starts with the module's first test, and the tests that
hold the port against it come last.

Held: MoE and logits within 1e-5 of the reference at f32 (``moe_apply``
within 2e-3, the reference's own bar for EP against one device); loss to
1e-5 relative; every gradient leaf within 1e-4 of its largest entry +
1e-6 (the bar of ``tests/test_torch_train.py``); every updated parameter
within 1e-4 of its leaf's largest entry, except where the gradient itself
is within that gradient bar of 0: there Adam's first step moves by about
lr·sign(g), a sign the two packages' rounding does not fix, so the two
updates may differ by up to 2·lr.
"""
import dataclasses
import functools
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

from repro_torch.checkpoint import ckpt as CKPT
from repro_torch.configs.registry import get_smoke_config
from repro_torch.data.pipeline import DataConfig, global_batch_array
from repro_torch.launch import sharded as SHD
from repro_torch.launch import sharding as SH
from repro_torch.launch import steps as STEPS
from repro_torch.launch import train as TRAIN_CLI
from repro_torch.launch.mesh import ShardMesh, make_host_mesh, rebuild_mesh_after_failure
from repro_torch.models import moe as MOE
from repro_torch.models import transformer as TF
from repro_torch.models.convert import params_from_reference, to_tensor
from repro_torch.optim import adamw
from repro_torch.optim import compress as COMP
from repro_torch.train import trainer as TR
from repro_torch.util.sharded import Sharded, full_tree
from repro_torch.util.tree import leaf_paths, leaves, tree_map

ROOT = Path(__file__).resolve().parents[1]
TRAIN_ARCHS = {"qwen2-7b": {"layers": 2}, "jamba-v0.1-52b": {}, "rwkv6-3b": {}}
#: (arch, mesh) of each train-step case: on data 2 x model 4 the MLP, the
#: vocabulary, jamba's mamba mixers (4 heads) and rwkv6's channel mix run
#: tensor-parallel (the smoke configs' 2 kv heads and rwkv6's 2 heads do not
#: divide model 4); on 2 x 2 attention (qwen2, with its qkv biases; jamba)
#: and rwkv6's time mix too
TRAIN_CASES = [("qwen2-7b", "2x4"), ("jamba-v0.1-52b", "2x4"), ("rwkv6-3b", "2x4"),
               ("qwen2-7b", "2x2"), ("jamba-v0.1-52b", "2x2"), ("rwkv6-3b", "2x2")]
MESHES = {"2x4": (2, 4), "2x2": (2, 2)}
B, T = 4, 32
LR = 3e-4
LOSS_RTOL, GRAD_RTOL, GRAD_ATOL, PARAM_RTOL = 1e-5, 1e-4, 1e-6, 1e-4

REFERENCE = r'''
import os, pickle, sys, dataclasses
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                           "--xla_backend_optimization_level=0 "
                           "--xla_llvm_disable_expensive_passes=true")
from concurrent.futures import ThreadPoolExecutor
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax.experimental.shard_map import shard_map
from repro.configs.registry import get_smoke_config
from repro.launch import sharding as SH, steps as STEPS
from repro.launch.mesh import rebuild_mesh_after_failure
from repro.models import transformer as TF
from repro.models.moe import moe_init, moe_apply, moe_apply_ep
from repro.optim import adamw, compress as COMP

ARCHS, CASES, MESHES, B, T, LR = {archs!r}, {cases!r}, {meshes!r}, {B}, {T}, {LR}
np_tree = lambda t: jax.tree.map(np.asarray, t)
devs = np.asarray(jax.devices())
meshes = {{k: Mesh(devs[:d * m].reshape(d, m), ("data", "model")) for k, (d, m) in MESHES.items()}}
mesh = meshes["2x4"]
out = {{}}

# moe_apply_ep against moe_apply
E, K, D, F = 8, 2, 16, 32
mp = moe_init(jax.random.PRNGKey(0), D, F, E)
x = jnp.asarray(np.random.default_rng(0).standard_normal((4, 8, D)).astype(np.float32))
out["moe_params"], out["moe_x"] = np_tree(mp), np.asarray(x)

def run_moe(cf, slot):
    f = jax.jit(lambda p, x: moe_apply_ep(p, x, num_experts=E, top_k=K, mesh=mesh,
                                          capacity_factor=cf, slot_loop=slot))
    return {{("moe_ep", cf, slot): np_tree(f(mp, x)),
            ("moe", cf, slot): np_tree(moe_apply(mp, x, num_experts=E, top_k=K,
                                                 capacity_factor=cf, slot_loop=slot))}}

def loss_fn(cfg, mesh, aux_weight=0.01):
    def f(params, tokens, labels):
        logits, _, aux = TF.forward(params, tokens, cfg, mesh=mesh)
        loss = STEPS.cross_entropy(logits, labels)
        return loss + aux_weight * aux, (loss, aux)
    return f

def setup(arch):
    cfg = dataclasses.replace(get_smoke_config(arch), **ARCHS[arch])
    params = TF.init_params(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(1)
    tokens = jnp.asarray(rng.integers(0, cfg.vocab, (B, T)).astype(np.int32))
    labels = jnp.asarray(rng.integers(0, cfg.vocab, (B, T)).astype(np.int32))
    return cfg, params, tokens, labels

def run_step(arch, name):
    mesh = meshes[name]
    cfg, params, tokens, labels = setup(arch)
    opt_cfg = adamw.AdamWConfig(lr=LR, total_steps=5, warmup_steps=1)
    with mesh:
        params_s = jax.device_put(params, SH.params_shardings(params, mesh))
        opt_s = jax.device_put(adamw.init(params), adamw.AdamWState(
            NamedSharding(mesh, P()), SH.params_shardings(params, mesh),
            SH.params_shardings(params, mesh)))
        new_params, _, m = jax.jit(STEPS.make_train_step(cfg, opt_cfg, mesh))(
            params_s, opt_s, tokens, labels)
        return (arch, name), {{"params": np_tree(params), "tokens": np.asarray(tokens),
                      "labels": np.asarray(labels), "new_params": np_tree(new_params),
                      "step_loss": float(m["loss"]), "moe_aux": float(m["moe_aux"]),
                      "grad_norm": float(m["grad_norm"]), "lr": float(m["lr"])}}

def run_grads(arch, name):
    mesh = meshes[name]
    cfg, params, tokens, labels = setup(arch)
    with mesh:
        params_s = jax.device_put(params, SH.params_shardings(params, mesh))
        (_, (loss, aux)), grads = jax.jit(jax.value_and_grad(loss_fn(cfg, mesh), has_aux=True))(
            params_s, tokens, labels)
        return (arch, name), {{"loss": float(loss), "aux": float(aux), "grads": np_tree(grads)}}

def run_serve(arch):
    # the prefill into a cache and one decode step on the mesh
    cfg, params, tokens, labels = setup(arch)
    with mesh:
        cache = TF.init_cache(cfg, B, T + 1)
        prefill, cache, _ = jax.jit(lambda p, t, c: TF.forward(
            p, t, cfg, cache=c, cache_index=0, mesh=mesh))(params, tokens, cache)
        logits, _ = jax.jit(STEPS.make_decode_step(cfg, mesh))(
            params, cache, labels[:, -1:], jnp.asarray(T, jnp.int32))
        return (arch, "2x4"), {{"prefill": np.asarray(prefill), "decode": np.asarray(logits)}}

def run_compress():
    # compress_grads under a data axis of 8
    mesh8 = Mesh(np.asarray(jax.devices()), ("data",))
    rng = np.random.default_rng(2)
    g = {{"w": rng.standard_normal((8, 64, 128)).astype(np.float32),
          "b": rng.standard_normal((8, 16)).astype(np.float32)}}
    r = {{k: (0.1 * rng.standard_normal(v.shape)).astype(np.float32) for k, v in g.items()}}
    ccfg = COMP.CompressionConfig(density=0.05, min_size=1024)
    def body(g, r):
        new, st, _ = COMP.compress_grads(ccfg, jax.tree.map(lambda a: a[0], g),
                                         COMP.CompressionState(jax.tree.map(lambda a: a[0], r)),
                                         axis_name="data")
        return jax.tree.map(lambda a: a[None], new), jax.tree.map(lambda a: a[None], st.residual)
    cg, cr = jax.jit(shard_map(body, mesh=mesh8, in_specs=(P("data"), P("data")),
                               out_specs=(P("data"), P("data")), check_rep=False))(g, r)
    return {{"compress": {{"g": g, "r": r, "new_g": np_tree(cg), "new_r": np_tree(cr),
                          "density": ccfg.density, "min_size": ccfg.min_size}}}}

# XLA compiles with the GIL released: the jobs run side by side, the
# slowest (jamba's) first
jobs = sorted(CASES, key=lambda c: not c[0].startswith("jamba"))
with ThreadPoolExecutor(8) as ex:
    futures = [ex.submit(run_step, *c) for c in jobs]
    futures += [ex.submit(run_grads, *c) for c in jobs]
    futures += [ex.submit(run_serve, a) for a in ARCHS if get_smoke_config(a).is_moe]
    moe = [ex.submit(run_moe, cf, slot) for cf in (8.0, 1.25) for slot in (True, False)]
    comp = ex.submit(run_compress)
    for f in futures:
        arch, res = f.result()
        out.setdefault(arch, {{}}).update(res)
    for f in moe + [comp]:
        out.update(f.result())
out["rebuild_data"] = rebuild_mesh_after_failure(failed_fraction=0.25).shape["data"]

with open(sys.argv[1], "wb") as fh:
    pickle.dump(out, fh)
'''


@pytest.fixture(scope="module", autouse=True)
def _reference_run():
    """Start the reference's subprocess with the module's first test; :func:`ref`
    waits for it, and the tests that do not need it run meanwhile."""
    d = tempfile.TemporaryDirectory()
    path = os.path.join(d.name, "ref.pkl")
    script = REFERENCE.format(archs=TRAIN_ARCHS, cases=TRAIN_CASES, meshes=MESHES, B=B, T=T,
                              LR=LR)
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


def _t(a):
    return to_tensor(np.asarray(a))


def _close(ours, want, rtol, atol=0.0, what=""):
    want = torch.as_tensor(want)
    err = float((ours - want).abs().max())
    tol = rtol * float(want.abs().max()) + atol
    assert err <= tol, (what, err, tol)


# --- expert parallelism ----------------------------------------------------------------


def test_moe_apply_ep_refuses_what_the_mesh_cannot_run():
    params = MOE.moe_init(torch.Generator().manual_seed(0), 16, 32, 6)
    with pytest.raises(ValueError, match="must divide model axis"):
        MOE.moe_apply_ep(params, torch.zeros(4, 2, 16), num_experts=6, top_k=2, mesh=mesh24())
    params = MOE.moe_init(torch.Generator().manual_seed(0), 16, 32, 8)
    with pytest.raises(ValueError, match="batch 3"):
        MOE.moe_apply_ep(params, torch.zeros(3, 2, 16), num_experts=8, top_k=2, mesh=mesh24())


# --- the sharded train step ------------------------------------------------------------


def _port_state(arch, r):
    cfg = dataclasses.replace(get_smoke_config(arch), **TRAIN_ARCHS[arch])
    params = params_from_reference(cfg, r["params"])
    return cfg, params


def _train_step_against_reference(r, arch, mesh_name):
    cfg, params = _port_state(arch, r)
    mesh = mesh_of(mesh_name)
    sp = SHD.shard_tree(params, mesh)
    tokens, labels = _t(r["tokens"]), _t(r["labels"])
    for path, s in zip(leaf_paths(sp), leaves(sp)):
        assert s.spec == SH.param_spec(path, s, mesh)
        assert len(s.pieces) == SH.spec_split(s.spec, mesh)
        assert sum(p.numel() for p in s.pieces) == s.numel()

    loss, aux, grads = STEPS.make_grad_fn(cfg, mesh=mesh)(sp, tokens, labels)
    assert abs(float(loss) - r["step_loss"]) <= LOSS_RTOL * r["step_loss"]
    assert abs(float(aux) - r["moe_aux"]) <= LOSS_RTOL * abs(r["moe_aux"]) + 1e-7
    grads = full_tree(grads, "cpu")
    assert abs(float(loss) - r["loss"]) <= LOSS_RTOL * r["loss"]
    ref_grads = params_from_reference(cfg, r["grads"])
    for path, g, rg in zip(leaf_paths(grads), leaves(grads), leaves(ref_grads)):
        assert g.dtype == rg.dtype
        _close(g, rg, GRAD_RTOL, GRAD_ATOL, path)

    opt_cfg = adamw.AdamWConfig(lr=LR, total_steps=5, warmup_steps=1)
    sp, opt, m = STEPS.make_train_step(cfg, opt_cfg, mesh)(sp, adamw.init(sp), tokens, labels)
    assert isinstance(leaves(opt.mu)[0], Sharded) and int(opt.step) == 1
    assert abs(float(m["loss"]) - r["step_loss"]) <= LOSS_RTOL * r["step_loss"]
    assert abs(float(m["grad_norm"]) - r["grad_norm"]) <= LOSS_RTOL * r["grad_norm"]
    assert float(m["lr"]) == pytest.approx(r["lr"], rel=1e-6)
    want = params_from_reference(cfg, r["new_params"])
    for path, p, w, rg in zip(leaf_paths(sp), leaves(sp), leaves(want), leaves(ref_grads)):
        got = p.full()
        bar = PARAM_RTOL * float(w.abs().max())
        fixed = rg.abs() > GRAD_RTOL * float(rg.abs().max()) + GRAD_ATOL
        gap = (got - w).abs()
        assert float(torch.where(fixed, gap, 0).max()) <= bar, (path, bar)
        assert float(gap.max()) <= bar + 2 * LR, path
    return cfg, mesh, sp


def test_sharded_step_equals_one_device_step_on_a_dense_model():
    """granite (2 layers) at f32: the 2 × 4 step, microbatches 2, and a
    batch that does not divide over the data shards (run whole, as the
    reference does) against the one-device step from the same weights."""
    cfg = dataclasses.replace(get_smoke_config("granite-3-2b"), layers=2)
    opt_cfg = adamw.AdamWConfig(lr=LR, total_steps=5, warmup_steps=1)
    rng = np.random.default_rng(3)
    for batch, micro in ((4, 1), (4, 2), (3, 1)):
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (batch, 16)).astype(np.int32))
        labels = torch.from_numpy(rng.integers(0, cfg.vocab, (batch, 16)).astype(np.int32))
        params = TF.init_params(torch.Generator().manual_seed(0), cfg)
        one = tree_map(torch.clone, params)
        gl, _, g1 = STEPS.make_grad_fn(cfg)(one, tokens, labels)
        one, _, m1 = STEPS.make_train_step(cfg, opt_cfg, microbatches=micro)(
            one, adamw.init(one), tokens, labels)
        sp = SHD.shard_tree(params, mesh24())
        sp, _, m = STEPS.make_train_step(cfg, opt_cfg, mesh24(), microbatches=micro)(
            sp, adamw.init(sp), tokens, labels)
        assert abs(float(m["loss"]) - float(m1["loss"])) <= LOSS_RTOL * float(m1["loss"])
        assert abs(float(m["grad_norm"]) - float(m1["grad_norm"])) <= \
            LOSS_RTOL * float(m1["grad_norm"])
        for path, p, w, g in zip(leaf_paths(sp), leaves(sp), leaves(one), leaves(g1)):
            gap = (p.full() - w).abs()
            fixed = g.abs() > GRAD_RTOL * float(g.abs().max()) + GRAD_ATOL
            assert float(torch.where(fixed, gap, 0).max()) <= PARAM_RTOL * float(w.abs().max()), path
            assert float(gap.max()) <= PARAM_RTOL * float(w.abs().max()) + 2 * LR, path


def _track_gathers(monkeypatch):
    """Wrap ``Sharded.full`` and ``Sharded.model_pieces`` so that each tensor
    they make (a piece handed back as it is is not one) adds its bytes to
    the bytes alive, until ``weakref.finalize`` takes them off; returns the
    record ``{"alive", "peak"}``."""
    import weakref

    rec = {"alive": 0, "peak": 0}

    def add(s, t):
        if any(t is p for p in s.pieces):
            return t
        n = t.numel() * t.element_size()
        rec["alive"] += n
        rec["peak"] = max(rec["peak"], rec["alive"])
        weakref.finalize(t, lambda: rec.__setitem__("alive", rec["alive"] - n))
        return t

    real_full, real_mp = Sharded.full, Sharded.model_pieces
    monkeypatch.setattr(Sharded, "full", lambda s, *a, **k: add(s, real_full(s, *a, **k)))
    monkeypatch.setattr(Sharded, "model_pieces",
                        lambda s, *a, **k: tuple(add(s, t) for t in real_mp(s, *a, **k)))
    return rec


def test_sharded_remat_step_holds_one_group_whole_at_a_time(monkeypatch):
    """granite smoke, 4 layers, remat on, on 2 × 4: the step gathers the
    layers inside their checkpointed groups (again in the backward's
    recompute), so the gathered bytes alive at once stay within the largest
    group's plus the (tied) embedding's, strictly below the whole tree's;
    without remat autograd keeps every layer's gathered weights for the
    backward.  Loss and gradients equal the one-device step's within the
    gradient bar."""
    cfg = dataclasses.replace(get_smoke_config("granite-3-2b"), layers=4, remat=True)
    assert cfg.tie_embeddings and cfg.scan_layers
    mesh = mesh24()
    rng = np.random.default_rng(6)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 16)).astype(np.int32))
    labels = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 16)).astype(np.int32))
    params = TF.init_params(torch.Generator().manual_seed(0), cfg)
    nbytes = lambda tree: sum(t.numel() * t.element_size() for t in leaves(tree))
    group = max(nbytes(lp) for lp in params["layers"])
    bound = group + nbytes(params["embedding"])
    loss1, _, g1 = STEPS.make_grad_fn(cfg)(tree_map(torch.clone, params), tokens, labels)

    peaks = {}
    for remat in (True, False):
        c = dataclasses.replace(cfg, remat=remat)
        sp = SHD.shard_tree(params, mesh)
        with monkeypatch.context() as mp:
            rec = _track_gathers(mp)
            loss, _, grads = STEPS.make_grad_fn(c, mesh=mesh)(sp, tokens, labels)
        peaks[remat] = rec["peak"]
        assert abs(float(loss) - float(loss1)) <= LOSS_RTOL * float(loss1)
        for path, g, w in zip(leaf_paths(g1), leaves(full_tree(grads, "cpu")), leaves(g1)):
            _close(g, w, GRAD_RTOL, GRAD_ATOL, path)
    assert 0 < peaks[True] <= bound < nbytes(params)
    assert peaks[False] >= nbytes(params["layers"]) > bound


def test_gather_from_other_devices_equals_the_concatenation():
    """Pieces on another device than the unit's are copied into their slices
    of the box (``util.costs.gather_into``), where pieces on the unit's own
    device are concatenated: on a mesh whose shards alternate between the
    ``cpu:0`` and ``cpu`` devices (unequal as devices, one memory; each
    data row's first shard, a unit's device, is ``cpu:0``, and its pieces
    report ``cpu``), the remat train step's loss and gradients and the
    serve steps' logits and cache equal those on an all-``cpu`` mesh bit
    for bit."""
    cfg = dataclasses.replace(get_smoke_config("granite-3-2b"), layers=2, remat=True)
    devs = tuple(torch.device("cpu") if i % 2 else torch.device("cpu", 0) for i in range(8))
    meshes = {"one": mesh24(), "two": ShardMesh(devs, ("data", "model"), (2, 4))}
    params = TF.init_params(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(7)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 16)).astype(np.int32))
    labels = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 16)).astype(np.int32))
    out = {}
    for name, mesh in meshes.items():
        sp = SHD.shard_tree(params, mesh)
        loss, _, grads = STEPS.make_grad_fn(cfg, mesh=mesh)(sp, tokens, labels)
        cache = TF.init_cache(cfg, 4, 20)
        cache = SHD.shard_tree(cache, mesh, SH.cache_pspecs(cache, mesh, 4))
        with torch.inference_mode():
            _, cache = STEPS.make_decode_step(cfg, mesh)(sp, cache, tokens, 0)
            logits, cache = STEPS.make_decode_step(cfg, mesh)(sp, cache, labels[:, :1], 16)
        out[name] = [loss, logits] + [p for s in leaves(grads) + leaves(cache) for p in s.pieces]
    assert len(out["one"]) == len(out["two"])
    for a, b in zip(out["one"], out["two"]):
        assert torch.equal(a, b)


def test_sharded_bf16_microbatched_step_hands_adamw_f32_gradients(monkeypatch):
    """granite (2 layers) in bf16, microbatches 2: as in the reference
    (``launch/steps.py``: bf16 gradients of each microbatch summed into an
    f32 accumulator), the sharded step hands AdamW the f32 mean over the
    microbatches, as the one-device step does.  Each microbatch's gradient
    is rounded to bf16 once on each side, after another split of the rows,
    so the two agree to a few bf16 roundings (2^-8 each): within 2^-6 of
    each leaf's largest entry, and loss and grad_norm within 2^-8."""
    cfg = dataclasses.replace(get_smoke_config("granite-3-2b"), layers=2, dtype="bfloat16")
    opt_cfg = adamw.AdamWConfig(lr=LR, total_steps=5, warmup_steps=1)
    rng = np.random.default_rng(5)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (8, 16)).astype(np.int32))
    labels = torch.from_numpy(rng.integers(0, cfg.vocab, (8, 16)).astype(np.int32))
    params = TF.init_params(torch.Generator().manual_seed(0), cfg)
    handed = []
    real = adamw.apply
    monkeypatch.setattr(adamw, "apply", lambda c, p, g, s: handed.append(full_tree(g, "cpu"))
                        or real(c, p, g, s))
    one = tree_map(torch.clone, params)
    _, _, m1 = STEPS.make_train_step(cfg, opt_cfg, microbatches=2)(
        one, adamw.init(one), tokens, labels)
    sp = SHD.shard_tree(params, mesh24())
    _, _, m = STEPS.make_train_step(cfg, opt_cfg, mesh24(), microbatches=2)(
        sp, adamw.init(sp), tokens, labels)
    assert leaves(sp)[0].dtype == torch.bfloat16
    for k in ("loss", "grad_norm"):
        assert abs(float(m[k]) - float(m1[k])) <= 2 ** -8 * float(m1[k]), k
    ours, want = handed[1], handed[0]
    for path, g, w in zip(leaf_paths(ours), leaves(ours), leaves(want)):
        assert g.dtype == w.dtype == torch.float32, path
        _close(g, w, 2 ** -6, 0, path)


_BF16_RUNS = {}


def _bf16_case_grads(arch, cfg, params, tokens, labels, model, dtype):
    """(loss, gradients whole on the CPU) of ``cfg``'s step on data 2 ×
    ``model`` CPU shards, its weights at ``dtype``; kept for the module, so
    that the cases share the data 2 × model 1 runs."""
    key = (arch, model, dtype)
    if key not in _BF16_RUNS:
        c = dataclasses.replace(cfg, dtype="float32") if dtype == torch.float32 else cfg
        p = params if dtype == torch.bfloat16 else tree_map(lambda t: t.float(), params)
        mesh = make_host_mesh(2 * model, "cpu", model=model)
        loss, _, g = STEPS.make_grad_fn(c, mesh=mesh)(SHD.shard_tree(p, mesh), tokens, labels)
        _BF16_RUNS[key] = (float(loss), full_tree(g, "cpu"))
    return _BF16_RUNS[key]


@pytest.mark.parametrize("arch,mesh_name", [
    *(pytest.param("granite-3-2b", m, id=m) for m in MESHES),
    pytest.param("jamba-v0.1-52b", "2x2", id="jamba-2x2")])
def test_tensor_parallel_bf16_gradients_round_as_one_device(arch, mesh_name):
    """granite (2 layers) in bf16 on data 2 × model 4 (MLP and vocabulary
    tensor-parallel) and 2 × 2 (attention too): the row blocks' partial
    outputs are summed unrounded and cast once, and each column weight's
    input gradient likewise, so a tensor-parallel layer rounds where one
    device's layer rounds.  The gradients then agree with the one-device
    bf16 step's to a few bf16 roundings of the data split (2^-8 each):
    within 2^-6 of each leaf's largest entry, and the loss within 2^-8.

    jamba (8 layers: seven mamba mixers, one attention, four MoE layers) on
    2 × 2, its mamba mixers (two heads a shard) and attention
    tensor-parallel.  Its bf16 gradients lie far from its f32 ones in
    every placement (up to ~25 · 2^-6 of a leaf's largest entry for the
    mixers' per-head vectors, whose gradients sum many cancelling terms),
    so a reordered f32 addition anywhere moves them by more than 2^-6; and
    its MoE layers route each data shard by its own rows, as one device
    does not.  So it is held against the same step with no model split
    (data 2 × model 1: the same rows per unit, the same routing, every
    layer whole): leaf by leaf, the tensor-parallel step's bf16 gradients
    are no farther from its own f32 gradients than twice that step's are
    from its own (a layer that rounded more, each partial rounded before
    the sum, would stand out), and the loss within 2^-8."""
    rng = np.random.default_rng(5)
    if arch == "granite-3-2b":
        cfg = dataclasses.replace(get_smoke_config(arch), layers=2, dtype="bfloat16")
    else:
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="bfloat16")
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 16)).astype(np.int32))
    labels = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 16)).astype(np.int32))
    params = TF.init_params(torch.Generator().manual_seed(0), cfg)
    mesh = mesh_of(mesh_name)

    def grads(model, dtype=torch.bfloat16):
        return _bf16_case_grads(arch, cfg, params, tokens, labels, model, dtype)

    assert any(SH.tp_dim(cfg, p[2:], s, mesh) is not None
               for p, s in zip(leaf_paths(params), leaves(SH.params_pspecs(params, mesh)))
               if p[0] == "layers")
    if arch == "granite-3-2b":
        l1, _, g1 = STEPS.make_grad_fn(cfg)(tree_map(torch.clone, params), tokens, labels)
        loss, g = grads(MESHES[mesh_name][1])
        assert abs(loss - float(l1)) <= 2 ** -8 * float(l1)
        for path, got, w in zip(leaf_paths(g1), leaves(g), leaves(g1)):
            assert got.dtype == w.dtype == torch.bfloat16, path
            _close(got.float(), w.float(), 2 ** -6, 0, path)
        return
    assert {p[3] for p, s in zip(leaf_paths(params), leaves(SH.params_pspecs(params, mesh)))
            if p[0] == "layers" and SH.tp_dim(cfg, p[2:], s, mesh) is not None
            and p[2] == "mixer"} == {"w_in", "w_gate", "w_B", "w_C", "w_out"}
    (loss, g), (_, g32) = grads(MESHES[mesh_name][1]), grads(MESHES[mesh_name][1], torch.float32)
    (l1, g1), (_, g1_32) = grads(1), grads(1, torch.float32)
    assert abs(loss - l1) <= 2 ** -8 * l1
    for path, a, a32, b, b32 in zip(leaf_paths(params), leaves(g), leaves(g32), leaves(g1),
                                    leaves(g1_32)):
        assert a.dtype == b.dtype, path
        drift = float((a.float() - a32).abs().max())
        assert drift <= 2 * float((b.float() - b32).abs().max()), (path, drift)


def test_sharded_compressed_step_takes_top_k_over_the_reference_stacks():
    """The compressed step on a mesh: top-k over each stack of the averaged
    gradients, the residual cut back into its pieces; fed the same
    gradients, the one-device compression gives the same sparse gradients
    and residuals."""
    cfg = dataclasses.replace(get_smoke_config("granite-3-2b"), layers=2)
    comp = COMP.CompressionConfig(density=0.05)
    opt_cfg = adamw.AdamWConfig(lr=LR, total_steps=5, warmup_steps=1)
    rng = np.random.default_rng(4)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 16)).astype(np.int32))
    labels = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 16)).astype(np.int32))
    params = TF.init_params(torch.Generator().manual_seed(0), cfg)
    mesh = mesh24()
    sp = SHD.shard_tree(params, mesh)
    _, _, grads = STEPS.make_grad_fn(cfg, mesh=mesh)(sp, tokens, labels)
    full_g = full_tree(grads, "cpu")
    state = COMP.init(sp)
    assert isinstance(leaves(state.residual)[0], Sharded)
    step = STEPS.make_train_step(cfg, opt_cfg, mesh, compression=comp)
    sp, _, state, m = step(sp, adamw.init(sp), state, tokens, labels)
    one_state = COMP.init(params)
    sparse, one_state, m1 = COMP.compress_grads(
        comp, full_g, one_state, groups=STEPS.stacked_leaf_groups(cfg, params))
    assert m["compress_ratio"] == m1["compress_ratio"]
    for r, r1 in zip(leaves(state.residual), leaves(one_state.residual)):
        assert torch.equal(r.full(), r1)


# --- data, checkpoints, trainer ----------------------------------------------------------


def test_global_batch_array_gives_each_data_shard_its_rows():
    cfg = DataConfig(vocab=512, seq_len=16, global_batch=8, seed=3)
    tokens, labels = global_batch_array(cfg, 2, make_host_mesh(8, "cpu", model=2))
    full = torch.from_numpy(__import__("repro_torch.data.pipeline", fromlist=["x"])
                            .synthesize_batch(cfg, 2))
    assert isinstance(tokens, Sharded) and len(tokens.pieces) == 4
    for d, (t, l) in enumerate(zip(tokens.pieces, labels.pieces)):
        assert torch.equal(t, full[2 * d:2 * d + 2, :-1]) and torch.equal(l, full[2 * d:2 * d + 2, 1:])
    with pytest.raises(ValueError, match="does not divide"):
        global_batch_array(dataclasses.replace(cfg, global_batch=6), 0, make_host_mesh(8, "cpu", model=2))


def test_checkpoint_of_a_mesh_restores_onto_another_mesh_bit_for_bit(tmp_path):
    """A 2 × 4 state is saved whole (the same files as one device writes)
    and restores onto a 6 × 1 mesh, by its target's cut or by ``shardings``,
    and onto one device, every leaf bit for bit (bf16 included)."""
    cfg = dataclasses.replace(get_smoke_config("granite-3-2b"), layers=2, dtype="bfloat16")
    state = TR.init_state(cfg, mesh24(), seed=5)
    tree = {"params": state.params, "opt": state.opt_state}
    CKPT.save(str(tmp_path / "a"), 3, tree)
    whole = {"params": full_tree(state.params, "cpu"),
             "opt": adamw.AdamWState(state.opt_state.step, full_tree(state.opt_state.mu, "cpu"),
                                     full_tree(state.opt_state.nu, "cpu"))}
    CKPT.save(str(tmp_path / "b"), 3, whole)
    for name in ("arrays.npz", "manifest.json"):
        a = (tmp_path / "a" / "step_00000003" / name).read_bytes()
        assert a == (tmp_path / "b" / "step_00000003" / name).read_bytes(), name
    mesh6 = rebuild_mesh_after_failure(0.25, 8, "cpu")
    other = TR.init_state(cfg, mesh6, seed=0)
    target = {"params": other.params, "opt": other.opt_state}
    back, step = CKPT.restore(str(tmp_path / "a"), target)
    back2, _ = CKPT.restore(str(tmp_path / "a"), whole,
                            shardings={"params": SH.params_shardings(whole["params"], mesh6),
                                       "opt": adamw.AdamWState(
                                           SH.NamedSharding(mesh6, SH.P()),
                                           SH.params_shardings(whole["params"], mesh6),
                                           SH.params_shardings(whole["params"], mesh6))})
    one, _ = CKPT.restore(str(tmp_path / "a"), whole)
    assert step == 3
    for b, b2, o, w, t in zip(leaves(back), leaves(back2), leaves(one), leaves(whole),
                              leaves(target)):
        if isinstance(t, Sharded):
            assert isinstance(b, Sharded) and b.mesh is mesh6 and b.spec == t.spec
            b = b.full()
        b2 = b2.full()
        for x in (b, b2, o):
            assert x.dtype == w.dtype and torch.equal(x.reshape(-1).view(torch.uint8), w.reshape(-1).view(torch.uint8))


def _trainer_setup(steps, **kw):
    cfg = dataclasses.replace(get_smoke_config("granite-3-2b"), layers=2)
    opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    data = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=24, seed=1)
    tcfg = TR.TrainerConfig(steps=steps, ckpt_every=2, log_every=100, **kw)
    return cfg, opt, data, tcfg


def test_trainer_state_is_sharded_and_starts_from_the_one_device_weights():
    cfg, opt, data, tcfg = _trainer_setup(2)
    state = TR.init_state(cfg, mesh24(), seed=3)
    one = TR.init_state(cfg, make_host_mesh(1, "cpu"), seed=3)
    for s, o, mu in zip(leaves(state.params), leaves(one.params), leaves(state.opt_state.mu)):
        assert isinstance(s, Sharded) and torch.equal(s.full(), o)
        assert isinstance(mu, Sharded) and mu.spec == s.spec and mu.dtype == torch.float32
    metrics = []
    TR.train(cfg, opt, data, tcfg, mesh24(), metrics_out=metrics)
    ref = []
    TR.train(cfg, opt, data, tcfg, make_host_mesh(1, "cpu"), metrics_out=ref)
    assert [m["step"] for m in metrics] == [1, 2]
    for m, r in zip(metrics, ref):
        assert abs(m["loss"] - r["loss"]) <= 1e-5 * r["loss"]


def test_elastic_restart_reshards_onto_the_smaller_mesh(tmp_path):
    """8 data shards to a checkpoint at step 4; then a failure after step 5;
    the supervisor rebuilds the mesh at failed_fraction 0.25 (6 shards) and
    resumes from the step-4 checkpoint.  The resumed losses equal an uninterrupted 6-shard run from
    a copy of that checkpoint within rtol 1e-4."""
    import shutil

    cfg, opt, data, tcfg = _trainer_setup(7, ckpt_dir=str(tmp_path / "run"), failure_at=5)
    meshes = []

    def factory():
        mesh = (make_host_mesh(8, "cpu", model=1) if not meshes
                else rebuild_mesh_after_failure(0.25, 8, "cpu"))
        meshes.append(mesh)
        return mesh

    first = []
    TR.train(cfg, opt, data, dataclasses.replace(tcfg, steps=4, failure_at=None),
             factory(), metrics_out=first)
    shutil.copytree(tmp_path / "run", tmp_path / "copy")
    meshes.clear()
    metrics = []
    TR.train_with_restart(cfg, opt, data, tcfg, factory, metrics_out=metrics)
    assert [m.shape for m in meshes] == [{"data": 8, "model": 1}, {"data": 6, "model": 1}]
    straight = []
    TR.train(cfg, opt, data, dataclasses.replace(tcfg, ckpt_dir=str(tmp_path / "copy"),
                                                 failure_at=None),
             rebuild_mesh_after_failure(0.25, 8, "cpu"), metrics_out=straight)
    # the first attempt resumes at 4 on 8 shards, runs step 5 and fails
    assert [m["step"] for m in metrics] == [5, 5, 6, 7]
    resumed = metrics[1:]
    assert [m["step"] for m in straight] == [5, 6, 7]
    for a, b in zip(resumed, straight):
        assert abs(a["loss"] - b["loss"]) <= 1e-4 * abs(b["loss"])


def test_launch_train_on_a_mesh_of_cpu_shards(capsys):
    """The training CLI's ``main`` in this process (a subprocess starts a
    torch of its own beside the test workers and the reference's run)."""
    TRAIN_CLI.main(["--arch", "jamba-v0.1-52b", "--smoke", "--device", "cpu", "--steps", "2",
                    "--batch", "4", "--seq", "32", "--shards", "8", "--model-axis", "4"])
    out = capsys.readouterr().out
    assert "[trainer] step 2 loss" in out and "over 2 steps" in out


def test_cuda_shards_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_host_mesh(8, "cuda", model=4)
    mesh = ShardMesh((torch.device("cuda", 0),) * 8, ("data", "model"), (2, 4))
    params = TF.init_params(torch.Generator().manual_seed(0),
                            dataclasses.replace(get_smoke_config("granite-3-2b"), layers=1))
    with pytest.raises((RuntimeError, AssertionError)):
        SHD.shard_tree(params, mesh)


# --- against the reference's outputs: these run last, so that the reference's
# subprocess, started with the module's first test, runs beside the tests above ---------


@pytest.mark.parametrize("slot", [True, False], ids=["slot_loop", "replica"])
@pytest.mark.parametrize("cf", [8.0, 1.25])
def test_moe_apply_ep_matches_reference(ref, cf, slot):
    """Capacity 8 drops nothing; 1.25 drops, each data shard by its own
    tokens' capacity, and exercises the dummy bin."""
    params = tree_map(_t, ref["moe_params"])
    x = _t(ref["moe_x"])
    kw = dict(num_experts=8, top_k=2, capacity_factor=cf, slot_loop=slot)
    y, aux = MOE.moe_apply_ep(params, x, mesh=mesh24(), **kw)
    ry, raux = ref[("moe_ep", cf, slot)]
    _close(y, ry, 1e-5, 1e-6, "y")
    assert abs(float(aux) - float(raux)) <= 1e-5 * abs(float(raux))
    if cf == 8.0:
        y1, _ = MOE.moe_apply(params, x, **kw)
        _close(y, y1, 0, 2e-3, "moe_apply")
        _close(y1, ref[("moe", cf, slot)][0], 1e-5, 1e-6, "moe_apply vs reference")
    # the experts as pieces (one per model shard) give the same bits
    pieces = {k: (v if k == "router" else tuple(torch.chunk(v, 4))) for k, v in params.items()}
    y2, aux2 = MOE.moe_apply_ep(pieces, x, mesh=mesh24(), **kw)
    assert torch.equal(y, y2) and torch.equal(aux, aux2)


def test_forward_on_a_mesh_serves_as_the_reference(ref):
    """jamba's prefill and a cached decode step with ``mesh``: its MoE layers
    run expert-parallel, each data shard with its own capacity."""
    r = ref[("jamba-v0.1-52b", "2x4")]
    cfg = get_smoke_config("jamba-v0.1-52b")
    params = params_from_reference(cfg, r["params"])
    tokens, labels = _t(r["tokens"]), _t(r["labels"])
    mesh = mesh24()
    calls = []
    real = MOE.moe_apply_ep
    with torch.inference_mode():
        MOE.moe_apply_ep = lambda *a, **k: calls.append(1) or real(*a, **k)
        try:
            logits = STEPS.make_prefill_step(cfg, mesh)(params, tokens)
            cache = TF.init_cache(cfg, B, T + 1)
            _, cache, _ = TF.forward(params, tokens, cfg, cache=cache, cache_index=0, mesh=mesh)
            step, _ = STEPS.make_decode_step(cfg, mesh)(params, cache, labels[:, -1:], T)
        finally:
            MOE.moe_apply_ep = real
    assert len(calls) == 3 * sum(TF.layer_spec(cfg, i)[1] for i in range(cfg.layers))
    _close(logits, r["prefill"], 1e-5, 1e-5, "prefill")
    _close(step, r["decode"], 1e-5, 1e-5, "decode")


@pytest.mark.parametrize("arch", [a for a, m in TRAIN_CASES if m == "2x4"])
def test_sharded_train_step_matches_reference(ref, arch):
    """The 2 × 4 step with the reference's weights: pieces on their shards,
    the loss, every gradient leaf, grad_norm, lr and every updated
    parameter; the MLP, the vocabulary, jamba's mamba mixers (one head a
    shard) and rwkv6's channel mix run tensor-parallel, attention and
    rwkv6's time mix (2 heads over 4) gathered whole."""
    _train_step_against_reference(ref[(arch, "2x4")], arch, "2x4")


@pytest.mark.parametrize("arch", [a for a, m in TRAIN_CASES if m == "2x2"])
def test_tensor_parallel_train_step_matches_reference(ref, arch):
    """The data 2 × model 2 step, where the smoke configs' 4 heads and 2 kv
    heads, jamba's 4 mamba heads and rwkv6's 2 heads divide: attention,
    MLP, the mamba mixer, both halves of rwkv6 and the vocabulary all
    tensor-parallel (every projection of a layer split over model, handed
    to the layer as its model blocks), held to the same bars as on 2 × 4
    against the reference on the same mesh shape."""
    cfg, mesh, sp = _train_step_against_reference(ref[(arch, "2x2")], arch, "2x2")
    tp = [p for p, s in zip(leaf_paths(sp), leaves(sp))
          if SH.tp_dim(cfg, p[2:] if p[0] == "layers" else p, s.spec, mesh) is not None]
    mixers = {"attn": 7 if cfg.qkv_bias else 4, "mamba": 5, "rwkv": 8}
    per_layer = [mixers[TF.layer_spec(cfg, i)[0]] + 3 * ("mlp" in lp)
                 for i, lp in enumerate(sp["layers"])]
    assert len(tp) == sum(per_layer) + len([k for k in sp if k.endswith("embedding")])
    assert {p[2] if isinstance(p[2], str) and len(p) > 3 else "rwkv"
            for p in tp if p[0] == "layers"} == {
        "qwen2-7b": {"attn", "mlp"}, "jamba-v0.1-52b": {"attn", "mixer", "mlp"},
        "rwkv6-3b": {"rwkv"}}[arch]
    # and the gather hands them so: one block per model shard
    gather = SHD.unit_gather(cfg, mesh.select(data=0), mesh.devices[0], SHD._ep(cfg, mesh, B))
    for i, lp in enumerate(sp["layers"]):
        got = gather(lp)
        for path in leaf_paths(lp):
            if "moe" in path:             # the experts come as their EP pieces
                continue
            leaf = functools.reduce(lambda n, k: n[k], path, got)
            assert isinstance(leaf, tuple) == (("layers", i) + path in tp), path
            assert not isinstance(leaf, tuple) or len(leaf) == mesh.shape["model"]


def test_compress_grads_over_a_data_axis_matches_reference(ref):
    """Each shard gets the mean of the shards' sparse gradients (a small
    leaf its own dense one) and keeps its own residual, as the reference's
    shard_map body gives it."""
    c = ref["compress"]
    cfg = COMP.CompressionConfig(density=c["density"], min_size=c["min_size"])
    grads = [{k: _t(v[d]) for k, v in c["g"].items()} for d in range(8)]
    states = [COMP.CompressionState({k: _t(v[d]) for k, v in c["r"].items()})
              for d in range(8)]
    out, states, m = COMP.compress_grads(cfg, grads, states, axis_name="data")
    assert len(out) == len(states) == 8
    assert m["compress_ratio"] == (int(64 * 128 * c["density"]) * 8 + 16 * 4) / ((64 * 128 + 16) * 4)
    for d in range(8):
        _close(out[d]["w"], c["new_g"]["w"][d], 1e-6, 0, "w")
        assert torch.equal(out[d]["b"], grads[d]["b"])
        np.testing.assert_array_equal(out[d]["b"].numpy(), c["new_g"]["b"][d])
        np.testing.assert_array_equal(states[d].residual["w"].numpy(), c["new_r"]["w"][d])
        np.testing.assert_array_equal(states[d].residual["b"].numpy(), c["new_r"]["b"][d])
    assert torch.equal(out[0]["w"], out[7]["w"])


def test_rebuild_mesh_after_failure_matches_reference(ref):
    assert rebuild_mesh_after_failure(0.25, 8, "cpu").shape["data"] == ref["rebuild_data"] == 6
