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
import torch_threads  # noqa: F401  one torch thread per test process
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


#: the leaves tensor parallelism splits, by group: the one dimension the
#: reference's rule puts ``model`` on is the output features of a column
#: leaf (the first set, its last dimension) and the input features of a row
#: leaf (the second set, its first).  A group is named by the leaves' parent,
#: but for rwkv6's two, whose leaves sit directly under the layer.
TP_GROUPS = {"attn": ({"wq", "wk", "wv", "bq", "bk", "bv"}, {"wo"}),
             "mlp": ({"w_in", "w_gate"}, {"w_out"}),
             "mixer": ({"w_in", "w_gate", "w_B", "w_C"}, {"w_out"}),
             "time_mix": ({"wr", "wk", "wv", "wg"}, {"wo"}),
             "channel_mix": ({"ck", "cr"}, {"cv"})}


def _group_of(cfg, name, parent):
    if cfg.rwkv and not isinstance(parent, str):
        return next((g for g in ("time_mix", "channel_mix") if name in set.union(*TP_GROUPS[g])),
                    None)
    return parent if parent in TP_GROUPS and name in set.union(*TP_GROUPS[parent]) else None


def _whole_units(cfg, group, M):
    """Whether ``group``'s blocks cut whole units over model M: attention's
    heads and kv heads, the mamba mixer's heads (one per 64 of its
    ``mamba_expand·d_model`` channels), rwkv6's heads, and for rwkv6's
    channel mix both d_ff and d_model."""
    return {"attn": cfg.num_heads % M == 0 and cfg.kv_heads % M == 0,
            "mixer": (cfg.mamba_expand * cfg.d_model // 64) % M == 0,
            "time_mix": cfg.num_heads % M == 0,
            "channel_mix": cfg.d_ff % M == 0 and cfg.d_model % M == 0}.get(group, True)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_tp_dim_reads_the_reference_spec_of_each_leaf(arch, mesh):
    """At full size: a leaf runs tensor-parallel exactly where it is one of
    attention's projections (whose heads and kv heads both divide over
    ``model``), the MLP's (a MoE layer's shared expert included), the mamba
    mixer's (whose heads divide), rwkv6's time mix's (whose heads divide)
    or channel mix's (whose d_ff and d_model divide), or an embedding, and
    the reference's spec of it puts ``model`` on the dimension that holds
    the heads, the ffn or the vocabulary; along that dimension.  No leaf of
    the encoder–decoder, and no norm, router, expert tensor, decay LoRA or
    per-head vector, runs so."""
    ref, ours = _trees(arch, False)
    cfg = _configs(arch, False)[1]
    stub = _stub(mesh)
    M = stub.shape["model"]
    ref_specs = RSH.params_pspecs(ref, stub)
    seen = set()
    specs = leaves(SH.params_pspecs(ours, stub))
    for path, leaf, spec in zip(leaf_paths(ours), leaves(ours), specs):
        ref_spec, stacked = _ref_leaf(cfg, ref_specs, path)
        ref_spec = tuple(ref_spec)[1:] if stacked and tuple(ref_spec) else tuple(ref_spec)
        name, parent = path[-1], (path[-2] if len(path) > 1 else None)
        group = _group_of(cfg, name, parent)
        if name in ("embedding", "unembedding") and parent is None:
            dim = 0
        elif group is not None:
            dim = leaf.dim() - 1 if name in TP_GROUPS[group][0] else 0
        else:
            dim = None
        if dim is not None and (cfg.is_encdec or not ref_spec or ref_spec[dim] != "model"
                                or not _whole_units(cfg, group, M)):
            dim = None
        got = SH.tp_dim(cfg, path, spec, stub)
        assert got == dim, (path, got, dim, ref_spec)
        if got is not None:
            seen.add(group or "vocab")
    if cfg.is_encdec:
        assert not seen
    elif arch == "granite-3-2b":
        # 32 heads and 8 kv heads divide over model 4, not over 16
        assert seen == ({"attn", "mlp", "vocab"} if M == 4 else {"mlp", "vocab"})
    elif arch == "rwkv6-3b":
        # 40 heads divide over model 4, not over 16; d_ff 8960 and d_model
        # 2560 over both
        assert seen == ({"time_mix", "channel_mix", "vocab"} if M == 4
                        else {"channel_mix", "vocab"})
    elif arch == "jamba-v0.1-52b":
        # 128 mamba heads divide over 4 and 16, 8 kv heads only over 4
        assert seen == ({"attn", "mixer", "mlp", "vocab"} if M == 4
                        else {"mixer", "mlp", "vocab"})


def _smoke_groups(arch, mesh, smoke=True):
    """{path within the layer (or the top-level leaf's): tp_dim} of the leaves
    of ``arch``'s layers and embeddings that run tensor-parallel on ``mesh``
    (the same in every layer of a kind)."""
    cfg = REG.get_smoke_config(arch) if smoke else REG.get_config(arch)
    ours = _meta(TF.init_params, types.SimpleNamespace(device=torch.device("meta")), cfg)
    specs = SH.params_pspecs(ours, mesh)
    out = {}
    for p, s in zip(leaf_paths(ours), leaves(specs)):
        inner = p[2:] if p[0] == "layers" else p
        dim = SH.tp_dim(cfg, p, s, mesh)
        assert dim == SH.tp_dim(cfg, inner, s, mesh), p
        if p[0] == "layers":                # a layer's leaf under its index in a group
            assert dim == SH.tp_dim(cfg, (0,) + inner, s, mesh), p
        if dim is not None:
            assert out.setdefault(inner, dim) == dim, p
    return out


def test_tp_dim_on_the_smoke_meshes():
    """The smoke configs' 4 heads and 2 kv heads divide over model 2, not 4:
    granite on data 2 x model 2 runs attention, MLP and vocabulary
    tensor-parallel, on 2 x 4 the MLP and vocabulary only; a mesh without
    a model split (the restart's model 1) runs nothing so."""
    groups = lambda arch, mesh: {p[-2] if len(p) > 1 else p[-1] for p in _smoke_groups(arch, mesh)}
    assert groups("granite-3-2b", MESH.make_host_mesh(4, "cpu", model=2)) == \
        {"attn", "mlp", "embedding"}
    assert groups("granite-3-2b", MESH.make_host_mesh(8, "cpu", model=4)) == \
        {"mlp", "embedding"}
    assert _smoke_groups("granite-3-2b", MESH.make_host_mesh(8, "cpu", model=1)) == {}


_TIME_MIX = {("wr",): 1, ("wk",): 1, ("wv",): 1, ("wg",): 1, ("wo",): 0}
_CHANNEL_MIX = {("ck",): 1, ("cr",): 1, ("cv",): 0}
_MIXER = {("mixer", n): 1 for n in ("w_in", "w_gate", "w_B", "w_C")} | {
    ("mixer", "w_out"): 0}
_ATTN = {("attn", "wq"): 1, ("attn", "wk"): 1, ("attn", "wv"): 1, ("attn", "wo"): 0}
_MLP = {("mlp", "w_in"): 1, ("mlp", "w_gate"): 1, ("mlp", "w_out"): 0}
_VOCAB = {("embedding",): 0, ("unembedding",): 0}


@pytest.mark.parametrize("arch,mesh,smoke,want", [
    # smoke rwkv6: 2 heads of 64, d_ff 256; smoke jamba: 4 mamba heads, 4
    # heads and 2 kv heads
    ("rwkv6-3b", "2x2", True, _TIME_MIX | _CHANNEL_MIX | _VOCAB),
    ("rwkv6-3b", "2x4", True, _CHANNEL_MIX | _VOCAB),
    ("jamba-v0.1-52b", "2x2", True, _ATTN | _MIXER | _MLP | _VOCAB),
    ("jamba-v0.1-52b", "2x4", True, _MIXER | _MLP | _VOCAB),
    # full width: rwkv6-3b's 40 heads do not divide over 16, its d_ff 8960
    # and d_model 2560 do; jamba's 128 mamba heads do, its 8 kv heads not
    ("rwkv6-3b", "16x16", False, _CHANNEL_MIX | _VOCAB),
    ("jamba-v0.1-52b", "16x16", False, _MIXER | _MLP | _VOCAB),
])
def test_tp_dim_table_of_the_recurrent_mixers(arch, mesh, smoke, want):
    """Which rwkv6 and jamba leaves run tensor-parallel, and along which
    dimension, on data 2 x model 2, 2 x 4 and 16 x 16 (the same in every
    layer of a kind, keyed by the path within the layer, by a layer's index
    or by nothing).  Everything else stays whole: the decay LoRA, the mix
    vectors, the per-head vectors and the norms."""
    data, model = (int(n) for n in mesh.split("x"))
    stub = types.SimpleNamespace(shape={"data": data, "model": model},
                                 axis_names=("data", "model"))
    assert _smoke_groups(arch, stub, smoke) == want


def test_tp_dim_never_confuses_attention_with_rwkv6():
    """``wk``, ``wv`` and ``wo`` name leaves of attention (under ``attn``)
    and of rwkv6's time mix (directly under the layer): each keeps its own
    group's rule and condition.  Under jamba a leaf of those names outside
    ``attn`` is no group's; under rwkv6 one inside ``attn`` is attention's
    (whose 2 kv heads divide over model 2, not 4), never the time mix's."""
    rwkv, jamba = REG.get_smoke_config("rwkv6-3b"), REG.get_smoke_config("jamba-v0.1-52b")
    m2, m4 = _stub_of(2, 2), _stub_of(2, 4)
    col, row = SH.P("data", "model"), SH.P("model", "data")
    for name, spec, dim in (("wk", col, 1), ("wv", col, 1), ("wo", row, 0)):
        assert SH.tp_dim(jamba, ("attn", name), spec, m2) == dim
        assert SH.tp_dim(jamba, ("attn", name), spec, m4) is None        # kv heads 2 over 4
        assert SH.tp_dim(jamba, (name,), spec, m2) is None
        assert SH.tp_dim(jamba, ("layers", 4, name), spec, m2) is None
        assert SH.tp_dim(rwkv, (name,), spec, m2) == dim                  # 2 heads over 2
        assert SH.tp_dim(rwkv, ("layers", 1, name), spec, m4) is None     # 2 heads over 4
        assert SH.tp_dim(rwkv, ("attn", name), spec, m2) == dim
        assert SH.tp_dim(rwkv, ("mixer", name), spec, m2) is None
    # the channel mix runs on its own condition (d_ff 256 and d_model 128
    # over 4), the time mix's names never take it
    assert SH.tp_dim(rwkv, ("ck",), col, m4) == 1 and SH.tp_dim(rwkv, ("cv",), row, m4) == 0
    assert SH.tp_dim(rwkv, ("mlp", "w_in"), col, m4) == 1
    assert SH.tp_dim(rwkv, ("w_in",), col, m4) is None


def _stub_of(data, model):
    return types.SimpleNamespace(shape={"data": data, "model": model},
                                 axis_names=("data", "model"))


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
