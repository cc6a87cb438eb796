"""The port's sharding rules (``repro_torch.launch.sharding``) against the
reference's (``repro.launch.sharding``), and the port's mesh.

The rules read only ``mesh.shape`` and ``mesh.axis_names``, so they run in
process against a stand-in mesh.  The reference's parameters and caches are
``jax.eval_shape`` trees of its stacked layers; the port's are leaves of the
same shapes on the ``meta`` device, laid out per layer (its own
``init_params``/``init_cache`` with the random draws sent to ``meta``).  A
per-layer leaf's spec must equal the reference's spec of its stacked leaf
with the stack dimension dropped, and that dimension must be unsplit.
"""
import dataclasses
import functools
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as RP

from repro.configs import registry as RREG
from repro.launch import mesh as RMESH
from repro.launch import sharding as RSH
from repro.models import encdec as RED
from repro.models import transformer as RTF

from repro_torch.configs import registry as REG
from repro_torch.launch import mesh as MESH
from repro_torch.launch import sharding as SH
from repro_torch.models import encdec as ED
from repro_torch.models import transformer as TF
from repro_torch.util.tree import leaf_paths, leaves

ARCHS = RREG.all_archs()
MESHES = {"2x4": ((2, 4), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _stub(name):
    shape, axes = MESHES[name]
    return types.SimpleNamespace(shape=dict(zip(axes, shape)), axis_names=axes)


def _configs(arch, smoke):
    if smoke:
        return RREG.get_smoke_config(arch), REG.get_smoke_config(arch)
    return RREG.get_config(arch), REG.get_config(arch)


def _meta(fn, *args, **kwargs):
    """``fn`` with every random draw sent to the ``meta`` device (shapes and
    dtypes only; nothing is allocated)."""
    randn, rand = torch.randn, torch.rand
    torch.randn = lambda *a, generator=None, device=None, **k: randn(*a, device="meta", **k)
    torch.rand = lambda *a, generator=None, device=None, **k: rand(*a, device="meta", **k)
    try:
        return fn(*args, **kwargs)
    finally:
        torch.randn, torch.rand = randn, rand


@functools.lru_cache(maxsize=None)
def _trees(arch, smoke):
    """(reference abstract params, port meta params) of one config."""
    rcfg, cfg = _configs(arch, smoke)
    rinit = RED.init_params if rcfg.is_encdec else RTF.init_params
    ref = jax.eval_shape(functools.partial(rinit, cfg=rcfg), jax.random.PRNGKey(0))
    gen = types.SimpleNamespace(device=torch.device("meta"))
    ours = _meta(ED.init_params if cfg.is_encdec else TF.init_params, gen, cfg)
    return ref, ours


def _ref_leaf(cfg, ref_tree, path):
    """(the reference's leaf for the port's leaf at ``path``, stacked?)."""
    if path[0] == "layers":
        key, _ = TF.layer_stack(cfg, path[1])
        key, stacked = key + tuple(path[2:]), True
    elif path[0] in ("enc_layers", "dec_layers"):
        key, stacked = (path[0],) + tuple(path[2:]), True
    else:
        key, stacked = tuple(path), False
    node = ref_tree
    for k in key:
        node = node[k]
    return node, stacked


def _check_specs(cfg, ours_tree, ours_specs, ref_tree, ref_specs):
    n = 0
    for path, leaf, spec in zip(leaf_paths(ours_tree), leaves(ours_tree), leaves(ours_specs)):
        ref_leaf, stacked = _ref_leaf(cfg, ref_tree, path)
        ref_spec, _ = _ref_leaf(cfg, ref_specs, path)
        assert isinstance(spec, SH.PartitionSpec)
        want = tuple(ref_spec)
        if stacked:
            assert tuple(ref_leaf.shape[1:]) == tuple(leaf.shape), path
            if want:
                assert want[0] is None, (path, want)
                want = want[1:]
        else:
            assert tuple(ref_leaf.shape) == tuple(leaf.shape), path
        assert tuple(spec) == want, (path, tuple(spec), want)
        n += 1
    return n


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch, smoke, mesh):
    ref, ours = _trees(arch, smoke)
    cfg = _configs(arch, smoke)[1]
    stub = _stub(mesh)
    n = _check_specs(cfg, ours, SH.params_pspecs(ours, stub), ref, RSH.params_pspecs(ref, stub))
    assert n == len(leaves(ours))
    if "pod" in stub.axis_names:
        _check_specs(cfg, ours, SH.params_pspecs(ours, stub, fsdp_over_pod=True),
                     ref, RSH.params_pspecs(ref, stub, fsdp_over_pod=True))
    # state bytes per device under those specs, params + moments
    ref_sh = jax.tree_util.tree_map(lambda s: types.SimpleNamespace(spec=s),
                                    RSH.params_pspecs(ref, stub),
                                    is_leaf=lambda x: isinstance(x, RP))
    assert SH.state_bytes_per_device(ours, SH.params_shardings(ours, stub), stub) == \
        RSH.state_bytes_per_device(ref, ref_sh, stub)


def _ref_cache_leaf(cfg, ref_cache, path):
    """(the reference's cache leaf for the port's per-layer leaf, stacked?)."""
    i, rest = path[0], tuple(path[1:])
    if cfg.is_encdec:
        node, stacked = ref_cache, True
    elif cfg.attn_period > 0:
        node, stacked = ref_cache[i % cfg.attn_period], True
    elif cfg.is_moe and cfg.moe_every > 1:
        node, stacked = ref_cache[i], False
    else:
        node, stacked = ref_cache, True
    for k in rest:
        node = node[k]
    return node, stacked


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_reference(arch, mesh):
    """Decode caches at full width (4,096 positions): a batch over the DP
    axes and a batch of one (sequence sharding)."""
    rcfg, cfg = _configs(arch, False)
    stub = _stub(mesh)
    dp = stub.shape["data"] * stub.shape.get("pod", 1)
    for batch in (dp, 1):
        rinit = RED.init_cache if rcfg.is_encdec else RTF.init_cache
        ref = jax.eval_shape(functools.partial(rinit, rcfg, batch, 4096))
        ours = (ED if cfg.is_encdec else TF).init_cache(cfg, batch, 4096, device="meta")
        for path, leaf in zip(leaf_paths(ours), leaves(ours)):
            ref_leaf, stacked = _ref_cache_leaf(cfg, ref, path)
            ref_path = [jax.tree_util.DictKey(k) for k in path[1:]]
            want = tuple(RSH.cache_spec(ref_path, ref_leaf, stub, batch))
            if stacked:
                assert tuple(ref_leaf.shape[1:]) == tuple(leaf.shape)
                assert want[0] is None
                want = want[1:]
            assert tuple(SH.cache_spec(path, leaf, stub, batch)) == want, (path, batch)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_sanitize_and_batch_sharding(mesh):
    stub = _stub(mesh)
    for shape, spec in (((49155, 2048), ("model", "data")), ((48, 64), (("pod", "data"), None)),
                        ((7,), ("data",)), ((32, 32), (None, ("data", "model"))),
                        ((8,), ("absent",))):
        assert tuple(SH.sanitize_spec(shape, spec, stub)) == \
            tuple(RSH.sanitize_spec(shape, spec, stub))
    # the reference's batch_sharding: P(("pod", "data")) or P("data")
    ours = SH.batch_sharding(stub)
    assert isinstance(ours, SH.NamedSharding) and ours.mesh is stub
    dp = ("pod", "data") if "pod" in stub.axis_names else ("data",)
    assert tuple(ours.spec) == tuple(RP(dp if len(dp) > 1 else dp[0]))


#: the leaves tensor parallelism splits, by parent: the one dimension the
#: reference's rule puts ``model`` on is the output features of a column
#: leaf (the last) and the input features of a row leaf (the first)
TP_COLUMNS = {"attn": {"wq", "wk", "wv", "bq", "bk", "bv"}, "mlp": {"w_in", "w_gate"}}
TP_ROWS = {"attn": {"wo"}, "mlp": {"w_out"}}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_tp_dim_reads_the_reference_spec_of_each_leaf(arch, mesh):
    """At full size: a leaf runs tensor-parallel exactly where it is one of
    attention's projections (whose heads and kv heads both divide over
    ``model``), the MLP's (a MoE layer's shared expert included) or an
    embedding, and the reference's spec of it puts ``model`` on the
    dimension that holds the heads, the ffn or the vocabulary; along that
    dimension.  No leaf of the encoder–decoder, and none of a mamba or
    rwkv mixer, a norm, the router or an expert tensor, runs so."""
    ref, ours = _trees(arch, False)
    cfg = _configs(arch, False)[1]
    stub = _stub(mesh)
    M = stub.shape["model"]
    heads_divide = cfg.num_heads % M == 0 and cfg.kv_heads % M == 0
    ref_specs = RSH.params_pspecs(ref, stub)
    seen = set()
    specs = leaves(SH.params_pspecs(ours, stub))
    for path, leaf, spec in zip(leaf_paths(ours), leaves(ours), specs):
        ref_spec, stacked = _ref_leaf(cfg, ref_specs, path)
        ref_spec = tuple(ref_spec)[1:] if stacked and tuple(ref_spec) else tuple(ref_spec)
        name, parent = path[-1], (path[-2] if len(path) > 1 else None)
        if name in ("embedding", "unembedding") and parent is None:
            dim = 0
        elif parent in TP_COLUMNS and name in TP_COLUMNS[parent]:
            dim = leaf.dim() - 1
        elif parent in TP_ROWS and name in TP_ROWS[parent]:
            dim = 0
        else:
            dim = None
        if dim is not None and (cfg.is_encdec or not ref_spec or ref_spec[dim] != "model"
                                or (parent == "attn" and not heads_divide)):
            dim = None
        got = SH.tp_dim(cfg, path, spec, stub)
        assert got == dim, (path, got, dim, ref_spec)
        if got is not None:
            seen.add(parent or "vocab")
    if cfg.is_encdec:
        assert not seen
    elif arch == "granite-3-2b":
        # 32 heads and 8 kv heads divide over model 4, not over 16
        assert seen == ({"attn", "mlp", "vocab"} if M == 4 else {"mlp", "vocab"})


def test_tp_dim_on_the_smoke_meshes():
    """The smoke configs' 4 heads and 2 kv heads divide over model 2, not 4:
    granite on data 2 x model 2 runs attention, MLP and vocabulary
    tensor-parallel, on 2 x 4 the MLP and vocabulary only; a mesh without
    a model split (the restart's model 1) runs nothing so; rwkv6's only
    such leaves are its two embeddings."""
    def groups(arch, mesh):
        cfg = REG.get_smoke_config(arch)
        ours = _meta(TF.init_params, types.SimpleNamespace(device=torch.device("meta")), cfg)
        specs = SH.params_pspecs(ours, mesh)
        return {(p[-2] if len(p) > 1 else p[-1]): SH.tp_dim(cfg, p, s, mesh)
                for p, s in zip(leaf_paths(ours), leaves(specs))
                if SH.tp_dim(cfg, p, s, mesh) is not None}
    assert set(groups("granite-3-2b", MESH.make_host_mesh(4, "cpu", model=2))) == \
        {"attn", "mlp", "embedding"}
    assert set(groups("granite-3-2b", MESH.make_host_mesh(8, "cpu", model=4))) == \
        {"mlp", "embedding"}
    assert groups("granite-3-2b", MESH.make_host_mesh(8, "cpu", model=1)) == {}
    assert groups("rwkv6-3b", MESH.make_host_mesh(8, "cpu", model=4)) == \
        {"embedding": 0, "unembedding": 0}


def _dropped(cfg, mesh):
    """(leaves with a rule, leaves whose spec lost an axis of its rule to
    ``sanitize_spec``) of ``cfg``'s parameters on ``mesh``."""
    ours = _meta(TF.init_params, types.SimpleNamespace(device=torch.device("meta")), cfg)
    ruled = dropped = 0
    for path, leaf in zip(leaf_paths(ours), leaves(ours)):
        rule = (SH._MOE_RULES.get(path[-1]) if "moe" in path else None) or \
            SH._NAME_RULES.get(path[-1])
        if rule is None:
            continue
        axes = [a for e in tuple(rule)[-leaf.dim():] for a in SH._entry_axes(e)
                if a in mesh.axis_names]
        ruled += 1
        dropped += SH.spec_split(SH.param_spec(path, leaf, mesh), mesh) < \
            int(np.prod([mesh.shape[a] for a in axes]))
    return ruled, dropped


def test_granite_specs_on_the_card_meshes():
    """granite's vocabulary, 49,155, does not divide by 4, but its padded
    vocabulary (49,280) does: at data 2 x model 4 the embedding splits 8
    ways and ``sanitize_spec`` drops no axis of the 362 ruled leaves; on
    the 6-shard restart mesh at smoke width (d_model 128 and d_ff 256 do not
    divide by 6) it drops the data axis from 15 of 20."""
    cfg = REG.get_config("granite-3-2b")
    mesh = MESH.make_host_mesh(8, "cpu", model=4)
    assert cfg.vocab % 4 and cfg.padded_vocab % 4 == 0
    emb = torch.empty(cfg.padded_vocab, cfg.d_model, device="meta")
    assert tuple(SH.param_spec(("embedding",), emb, mesh)) == ("model", "data")
    raw = torch.empty(cfg.vocab, cfg.d_model, device="meta")
    assert tuple(SH.param_spec(("embedding",), raw, mesh)) == (None, "data")
    assert _dropped(cfg, mesh) == (362, 0)
    smoke = dataclasses.replace(REG.get_smoke_config("granite-3-2b"), layers=2)
    assert _dropped(smoke, MESH.rebuild_mesh_after_failure(0.25, 8, "cpu")) == (20, 15)


# --- the mesh --------------------------------------------------------------------------


def test_shard_mesh_is_n_dimensional():
    cpu = torch.device("cpu")
    mesh = MESH.make_host_mesh(8, "cpu", model=4)
    assert mesh.shape == {"data": 2, "model": 4} and mesh.axis_names == ("data", "model")
    assert mesh.size == 8 and mesh.devices == (cpu,) * 8
    assert mesh.coords(6) == {"data": 1, "model": 2}
    sub = mesh.select(data=1)
    assert sub.shape == {"data": 1, "model": 4} and sub.size == 4
    # the SpMV layer's one-axis mesh is unchanged
    assert MESH.make_host_mesh(3, "cpu").shape == {"data": 3}
    # model is clamped, as in the reference, and leftover shards are dropped
    assert MESH.make_host_mesh(2, "cpu", model=4).shape == {"data": 1, "model": 2}
    assert MESH.make_host_mesh(7, "cpu", model=2).shape == {"data": 3, "model": 2}
    pod = MESH.ShardMesh((cpu,) * 8, ("pod", "data", "model"), (2, 2, 2))
    assert MESH.batch_axes(pod) == ("pod", "data") and MESH.dp_size(pod) == 4
    assert MESH.batch_axes(mesh) == ("data",) == tuple(
        RMESH.batch_axes(types.SimpleNamespace(axis_names=("data", "model"))))
    with pytest.raises(ValueError):
        MESH.ShardMesh((cpu,) * 3, ("data", "model"), (2, 2))


@pytest.mark.parametrize("n,f,data", [(8, 0.25, 6), (8, 0.0, 8), (8, 0.5, 4),
                                      (4, 0.9, 1), (16, 0.25, 12)])
def test_rebuild_mesh_after_failure(n, f, data):
    """The reference's rule: model 1, data int(n (1 - f)), at least 1 (8
    devices at 0.25 leave 6)."""
    mesh = MESH.rebuild_mesh_after_failure(f, n, "cpu")
    assert mesh.shape == {"data": data, "model": 1}
    assert mesh.size == data and data == max(int(n * (1 - f)), 1)
