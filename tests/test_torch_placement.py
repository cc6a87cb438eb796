"""The port's placement on distinct devices: the sharded LM steps fake-run on
data 2 × model 4 and data 2 × model 2 meshes of ``meta:i`` devices.

On one card every shard's device is that card and ``.to(device)`` is a
no-op, so the card cannot show a missing move.  Fake tensors on distinct
indexed ``meta`` devices can: an op whose tensors lie on two devices raises
``FakeTensorDeviceMismatchError``.  The steps run at smoke size through
``launch.dryrun``'s fake run (``steps.input_specs`` places the arguments as
the steps take them), and the bytes each one moves between devices are held
by collective kind (``util.costs``), each derived here from the placement:

  * the sharded train step: each data shard gathers every leaf it uses
    whole onto its device and each tensor-parallel leaf's block m onto its
    model shard m, over ``data`` only, one layer at a time (all-gather:
    every piece the receiving shard does not hold; under EP the expert
    leaves onto the model shards' devices); the gradients go back to the
    pieces (reduce-scatter, the same bytes); EP moves the rows and the
    router to the model shards (all-to-all); tensor parallelism sends each
    split sublayer's input out to the model shards and brings their partial
    outputs back (all-reduce, as do EP's partial outputs), sends the token
    rows and positions out and gathers the vocabulary blocks' logits
    (all-gather); under remat the backward's recompute gathers each
    layer's leaves once more and redoes the layers' forward moves; the rest
    are 0-d float32 scalars (loss means, the divisor, gradient norm
    partials, AdamW's step values);
  * a jamba EP decode step on state in pieces: each data shard's unit
    gathers each layer's whole leaves onto its device and its rows of the
    attention cache, writes the position it wrote back to that position's
    owner (collective-permute), sends the rows and the router to the other
    model shards (all-to-all; no expert byte moves), sums the partial
    outputs (all-reduce) and returns its logits to the first shard
    (all-gather);
  * a granite decode step on data 2 × model 2, where attention is
    tensor-parallel too: no K/V byte moves, and every device computes
    exactly its share of the step;
  * the rwkv6 train step on data 2 × model 2, where its heads divide:
    every projection of its time mix and channel mix in blocks.

The recurrent layers' tensor parallelism moves besides each shard's heads'
slices of the per-head vectors, of rwkv6's decay and (decode) of the state,
which come whole to the unit (all-gather; their gradients back as a
reduce-scatter), the state back, and rwkv6's receptance blocks
(``tp_moves``).
"""
import dataclasses
import math

import pytest
import torch
import torch_threads  # noqa: F401  one torch thread per test process
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.registry import get_smoke_config
from repro_torch.launch import dryrun as DR
from repro_torch.launch import sharded as SHD
from repro_torch.launch import sharding as SH
from repro_torch.launch import steps as STEPS
from repro_torch.launch.mesh import make_meta_mesh
from repro_torch.models import transformer as TF
from repro_torch.models.config import ShapeConfig
from repro_torch.util.sharded import bytes_per_shard, spec_axes
from repro_torch.util.tree import leaf_paths, leaves

TRAIN = ShapeConfig("smoke_train", 32, 4, "train")
DECODE = ShapeConfig("smoke_decode", 32, 4, "decode")


def mesh24():
    return make_meta_mesh((2, 4), ("data", "model"))


def mesh22():
    return make_meta_mesh((2, 2), ("data", "model"))


def _nbytes(t):
    return t.numel() * t.element_size()


def test_meta_devices_are_distinct_under_fake_mode():
    mesh = mesh24()
    assert len(set(mesh.devices)) == 8
    with FakeTensorMode():
        a = torch.zeros(2, device=mesh.devices[1])
        b = torch.zeros(2, device=mesh.devices[2])
        with pytest.raises(RuntimeError, match="device"):
            a + b


def tp_of(cfg, path, s, attn_tp=True):
    """The dimension along which the params leaf at ``path`` runs
    tensor-parallel (``sharding.tp_dim`` on its path within its layer);
    attention's only where ``attn_tp``."""
    inner = path[2:] if path[0] == "layers" else path
    dim = SH.tp_dim(cfg, inner, s.spec, s.mesh)
    return None if dim is None or (not attn_tp and "attn" in inner) else dim


def param_gathers(cfg, mesh, params, B, attn_tp=True):
    """(layer leaves, other leaves): the bytes of the pieces each unit of a
    batch of B receives to gather the params once.  A tensor-parallel leaf's
    block m and an expert leaf's pieces m go to the unit's model shard m,
    each piece from the shard of its own model coordinate at another data
    coordinate (asserted: over ``data`` only); every other leaf goes whole
    to the unit's device."""
    gather = [0, 0]
    for rows, sub, dev in SHD._units(mesh, B):
        model_devs = [sub.device_at(model=m) for m in range(sub.shape["model"])]
        for path, s in zip(leaf_paths(params), leaves(params)):
            expert = (cfg.is_moe and path[-1] in SHD._EXPERT_LEAVES and "moe" in path
                      and "model" in spec_axes(s.spec[0]))
            dim = 0 if expert else tp_of(cfg, path, s, attn_tp)
            for b, p in zip(s.blocks(), s.pieces):
                to = model_devs[b[dim]] if dim is not None else dev
                if s.owner(b) == to:
                    continue
                if dim is not None:
                    got, want = (mesh.coords(mesh.devices.index(d)) for d in (s.owner(b), to))
                    assert got["model"] == want["model"] and got != want, path
                gather[path[0] != "layers"] += _nbytes(p)
    return gather


def tp_moves(cfg, mesh, params, shape, attn_tp=True):
    """The bytes a step's tensor parallelism moves, forward only, by kind
    and by where (``layers``: inside the layers, ``outer``: the embeddings),
    over the units of ``shape``'s batch, and (``layers``, ``back``) those of
    the layers' backward.  Per unit of Bl rows on M model shards, an
    activation [Bl, T, d_model] crossing to or from the M − 1 shards other
    than the unit's own is A = (M − 1)·Bl·T·d_model·4 bytes, and one of its
    column blocks (d_model/M wide) A/M:

      * all-reduce: each tensor-parallel attention, MLP and mamba mixer sends
        its input out and its partial outputs back (2·A each), rwkv6's time
        mix its four lerps out and its partial outputs back (5·A), its
        channel mix two lerps out and its partial outputs back (3·A); the
        embedding lookup sends its partials back (A) and the unembedding
        takes its input out (A).  In the backward, each such layer sends
        the gradient of its partial outputs out (A) and brings back one
        input gradient per column weight of a shard (A each: ``wq``,
        ``wk``, ``wv``; ``w_in`` and ``w_gate``; the mixer's four; rwkv6's
        four and two), each summed over the shards on its own;
      * all-gather: the token rows to the other shards ((M − 1)·Bl·T·4),
        the positions to each tensor-parallel attention ((M − 1)·T·8), each
        vocabulary block's logits to the unit ((M − 1)·Bl·T·(V/M)·4); each
        shard's heads' slices of the per-head vectors that come whole (the
        mixer's ``dt_bias``, ``A_log``, ``D_skip``, H/M each; rwkv6's ``u``
        and ``gn_scale``, d_model/M each), of the mixer's step projection
        ((M − 1)·Bl·T·(H/M)·4), of rwkv6's decay (A/M) and, in a
        decode step, of the recurrent state out and back (2 of
        (M − 1)·Bl·(H/M)·K·V·4), and rwkv6's receptance blocks to the unit
        (A/M); their gradients go back as a reduce-scatter (``back``)."""
    out = {where: {"all-reduce": 0, "all-gather": 0} for where in ("layers", "outer")}
    out["back"] = {"all-reduce": 0, "reduce-scatter": 0}
    specs = dict(zip(leaf_paths(params), leaves(params)))
    tp = lambda path: path in specs and tp_of(cfg, path, specs[path], attn_tp) is not None  # noqa
    mamba_H = cfg.mamba_expand * cfg.d_model // 64
    for rows, sub, dev in SHD._units(mesh, shape.global_batch):
        M, Bl = sub.shape["model"], rows.stop - rows.start
        T = 1 if shape.is_decode else shape.seq_len
        A = (M - 1) * Bl * T * cfg.d_model * 4
        for i in range(TF.num_layers(cfg)):
            attn, mlp = tp(("layers", i, "attn", "wq")), tp(("layers", i, "mlp", "w_in"))
            mixer = tp(("layers", i, "mixer", "w_in"))
            time_mix, channel_mix = tp(("layers", i, "wr")), tp(("layers", i, "ck"))
            gated = ("layers", i, "mlp", "w_gate") in specs
            out["layers"]["all-reduce"] += (2 * A * (attn + mlp + mixer) + 5 * A * time_mix
                                            + 3 * A * channel_mix)
            out["back"]["all-reduce"] += A * (attn * (1 + 3) + mlp * (1 + 1 + gated)
                                              + mixer * (1 + 4) + time_mix * (1 + 4)
                                              + channel_mix * (1 + 2))
            out["layers"]["all-gather"] += (M - 1) * T * 8 * attn
            H = mamba_H if mixer else cfg.num_heads
            K, V = (cfg.mamba_d_state, cfg.mamba_expand * cfg.d_model // H) if mixer else (cfg.d_model // H,) * 2
            sliced = ((M - 1) * (H // M) * (3 + Bl * T) * 4 * mixer
                      + (M - 1) * (cfg.d_model // M) * 2 * 4 * time_mix
                      + A // M * time_mix + A // M * channel_mix)
            out["layers"]["all-gather"] += sliced
            out["back"]["reduce-scatter"] += sliced if not shape.is_decode else 0
            if shape.is_decode and (mixer or time_mix):
                out["layers"]["all-gather"] += 2 * (M - 1) * Bl * (H // M) * K * V * 4
        emb = tp(("embedding",))
        unemb = tp(("unembedding",) if "unembedding" in params else ("embedding",))
        out["outer"]["all-reduce"] += A * (emb + unemb)
        out["outer"]["all-gather"] += ((M - 1) * Bl * T * 4 * emb
                                       + (M - 1) * Bl * T * (cfg.padded_vocab // M) * 4 * unemb)
    return out


def logits_blocks(cfg, mesh, params, shape):
    """The bytes of the vocabulary blocks' logits that cross to the units
    (their gradients' way back is a reduce-scatter of as many)."""
    specs = dict(zip(leaf_paths(params), leaves(params)))
    key = ("unembedding",) if "unembedding" in params else ("embedding",)
    if tp_of(cfg, key, specs[key]) is None:
        return 0
    return sum((sub.shape["model"] - 1) * (rows.stop - rows.start) * shape.seq_len
               * (cfg.padded_vocab // sub.shape["model"]) * 4
               for rows, sub, _ in SHD._units(mesh, shape.global_batch))


def expected_train_moves(cfg, mesh, params):
    """The bytes of one sharded train step by kind.  Forward: each unit
    receives the pieces it does not hold, the layers' twice under remat
    (the recompute gathers them again), EP copies the rows and the router
    to each model shard (all-to-all) and sums the partial outputs
    (all-reduce), and tensor parallelism moves what :func:`tp_moves` counts,
    the layers' again under remat (but for each group's tail,
    :func:`recompute_tail`).  Backward: each gathered piece's gradient
    goes back (reduce-scatter), as do the logits blocks'; every all-reduce
    and all-to-all move of a tensor that takes a gradient moves it back
    once (the token rows and positions take none), but a tensor-parallel
    layer's input, whose gradient comes back once per column weight
    (:func:`tp_moves`' ``back``)."""
    ep, layer_runs = cfg.is_moe, 2 if cfg.remat else 1
    layers, rest = param_gathers(cfg, mesh, params, TRAIN.global_batch)
    tp = tp_moves(cfg, mesh, params, TRAIN)
    a2a = ep_reduce = 0
    for rows, sub, dev in SHD._units(mesh, TRAIN.global_batch):
        model_devs = [sub.device_at(model=m) for m in range(sub.shape["model"])]
        if ep:
            n_moe = sum(TF.layer_spec(cfg, i)[1] for i in range(TF.num_layers(cfg)))
            Bl, T, D = rows.stop - rows.start, TRAIN.seq_len, cfg.d_model
            # the expert pieces sit on their model shards already: the
            # router and the rows go there, the partial outputs come back
            a2a += n_moe * sum(D * cfg.num_experts * 4 + Bl * T * D * 4
                               for d in model_devs if d != dev)
            ep_reduce += n_moe * sum(Bl * T * D * 4 for d in model_devs if d != dev)
    logits = logits_blocks(cfg, mesh, params, TRAIN)
    return {
        "all-gather": layer_runs * (layers + tp["layers"]["all-gather"]) + rest
        + tp["outer"]["all-gather"],
        "reduce-scatter": layers + rest + logits + tp["back"]["reduce-scatter"],
        "all-to-all": (layer_runs + 1) * a2a,
        "all-reduce": layer_runs * tp["layers"]["all-reduce"] + tp["back"]["all-reduce"]
        + (layer_runs + 1) * ep_reduce + 2 * tp["outer"]["all-reduce"]
        - (recompute_tail(cfg, mesh, params) if cfg.remat else 0),
    }


def recompute_tail(cfg, mesh, params):
    """The bytes of the moves that end each checkpointed group (a layer, or a
    hybrid's period) after its last op that saves a tensor for the
    backward: the recompute of a non-reentrant checkpoint stops at that op,
    so they are not made again.  A group that ends in a tensor-parallel MLP
    returns its M − 1 remote partial outputs there ((M − 1)·Bl·T·D·4); one
    that ends in an expert-parallel MoE layer the last model shard's
    output (Bl·T·D·4)."""
    specs = dict(zip(leaf_paths(params), leaves(params)))
    group = cfg.attn_period if cfg.attn_period > 0 else 1
    out = 0
    for rows, sub, dev in SHD._units(mesh, TRAIN.global_batch):
        M, act = sub.shape["model"], (rows.stop - rows.start) * TRAIN.seq_len * cfg.d_model * 4
        for last in range(group - 1, TF.num_layers(cfg), group):
            mlp = ("layers", last, "mlp", "w_in")
            if TF.layer_spec(cfg, last)[1]:
                out += act if sub.device_at(model=M - 1) != dev else 0
            elif mlp in specs and tp_of(cfg, mlp, specs[mlp]) is not None:
                out += (M - 1) * act
    return out


def _train_moves_hold(cfg, mesh):
    run = DR._fake_run(cfg, TRAIN, mesh)          # raises on a device mismatch
    got = run["counter"].collective_bytes()
    with FakeTensorMode():
        args, _ = STEPS.input_specs(cfg, TRAIN, mesh)
        want = expected_train_moves(cfg, mesh, args["params"])
        pieces = sum(len(s.pieces) for s in leaves(args["params"]))
    for kind, n in want.items():
        assert got[kind] == n, (kind, got[kind], n)
    assert got["all-gather"] > 0 and got["reduce-scatter"] > 0
    # 0-d scalars only, two a piece: the divisor (float32) and a norm
    # partial (float64, summed once in float64 by ``adamw.global_norm``); a
    # few float32 a device (AdamW's step values), the units' loss and aux
    assert 0 < got["collective-permute"] <= 4 * (pieces + 8 * mesh.size + 2 * 2) + 8 * pieces
    assert got["collective-permute"] % 4 == 0
    return run, got


@pytest.mark.parametrize("arch", ["granite-3-2b", "jamba-v0.1-52b", "rwkv6-3b"])
def test_sharded_train_step_on_eight_devices(arch):
    """On data 2 × model 4 the smoke configs' MLPs and vocabularies run
    tensor-parallel (their 2 kv heads do not divide model 4): every shard
    computes, each data shard's rows on its own model shards."""
    cfg, mesh = get_smoke_config(arch), mesh24()
    run, got = _train_moves_hold(cfg, mesh)
    assert got["all-reduce"] > 0
    assert all(run["counter"].flops.get(d, 0) > 0 for d in mesh.devices)


@pytest.mark.parametrize("arch", ["granite-3-2b", "jamba-v0.1-52b", "rwkv6-3b"])
def test_remat_train_step_gathers_each_layer_again_in_the_backward(arch):
    """Remat on: each checkpointed group gathers its layers inside the
    group, so the backward's recompute gathers them once more (and redoes
    EP's and tensor parallelism's forward moves); the gradients go back
    once."""
    cfg, mesh = dataclasses.replace(get_smoke_config(arch), remat=True), mesh24()
    _, got = _train_moves_hold(cfg, mesh)
    with FakeTensorMode():
        args, _ = STEPS.input_specs(cfg, TRAIN, mesh)
        layers, rest = param_gathers(cfg, mesh, args["params"], TRAIN.global_batch)
        sliced = tp_moves(cfg, mesh, args["params"], TRAIN)["back"]["reduce-scatter"]
    assert got["reduce-scatter"] - logits_blocks(cfg, mesh, args["params"], TRAIN) - sliced \
        == layers + rest > 0


def test_jamba_ep_decode_step_on_eight_devices():
    cfg, mesh = get_smoke_config("jamba-v0.1-52b"), mesh24()
    run = DR._fake_run(cfg, DECODE, mesh)
    got = run["counter"].collective_bytes()
    with FakeTensorMode():
        args, _ = STEPS.input_specs(cfg, DECODE, mesh)
        layers, rest = param_gathers(cfg, mesh, args["params"], DECODE.global_batch)
        tp = tp_moves(cfg, mesh, args["params"], DECODE)
        held = [sum(v) for v in zip(*(bytes_per_shard(args[k], mesh)
                                      for k in ("params", "cache", "tokens")))]
    n_moe = sum(TF.layer_spec(cfg, i)[1] for i in range(TF.num_layers(cfg)))
    n_attn = sum(TF.layer_spec(cfg, i)[0] == "attn" for i in range(TF.num_layers(cfg)))
    E, D, V = cfg.num_experts, cfg.d_model, cfg.padded_vocab
    hd, kv, S = cfg.resolved_head_dim, cfg.kv_heads, DECODE.seq_len
    units, Bl = 2, DECODE.global_batch // 2
    # K/V [B, S, kv, hd] cut (data, model) along B and S (2 kv heads do not
    # divide model 4): a unit receives the 3 of its row's 4 S blocks it does
    # not hold, and writes position S - 1 back into the last one's owner
    kv_block = Bl * (S // 4) * kv * hd * 4
    kv_gather = units * n_attn * 2 * 3 * kv_block
    kv_write = units * n_attn * 2 * Bl * 1 * kv * hd * 4
    logits = Bl * V * 4                              # data shard 1's, to the first
    # the router and the rows to the 3 other model shards of each data row;
    # the expert pieces are there already: no expert byte
    a2a = units * n_moe * 3 * (D * E * 4 + Bl * D * 4)
    assert got["all-to-all"] == a2a
    # the dense MLPs and the mamba mixers (4 heads over model 4): the heads'
    # slices of the per-head vectors, of the step projection and of the
    # state out, the state back
    S_slice = Bl * 1 * cfg.mamba_d_state * (cfg.mamba_expand * D // 4) * 4
    n_mamba = sum(TF.layer_spec(cfg, i)[0] == "mamba" for i in range(TF.num_layers(cfg)))
    assert tp["layers"]["all-gather"] == units * n_mamba * 3 * ((3 + Bl) * 4 + 2 * S_slice)
    assert tp["layers"]["all-reduce"] > 0
    assert got["all-gather"] == (layers + rest + kv_gather + logits + tp["layers"]["all-gather"]
                                 + tp["outer"]["all-gather"])
    assert got["collective-permute"] == kv_write
    # EP's partial outputs, and tensor parallelism's partial sums
    assert got["all-reduce"] == (units * n_moe * 3 * Bl * D * 4 + tp["layers"]["all-reduce"]
                                 + tp["outer"]["all-reduce"])
    assert got["reduce-scatter"] == 0
    # each data row's attention and mamba layers on its first shard, the
    # experts, the MLPs' and the vocabulary's blocks on all eight
    assert all(run["counter"].flops.get(d, 0) > 0 for d in mesh.devices)
    assert math.isclose(run["counter"].flops[mesh.devices[0]],
                        max(run["counter"].flops.values()))
    # state in pieces: each shard holds its blocks; the first one the most
    held[0] += 4                                     # cache_index
    assert run["state"] == held and max(held) == held[0] and min(held) > 0


def decode_flops_per_shard(cfg, mesh, shape):
    """FLOPs of one tensor-parallel decode step on each device of ``mesh``,
    every leaf split over model M: per layer, the projections of the
    shard's H/M heads and kv/M kv heads (2·Bl·D·hd·(2H/M + 2kv/M)), its
    attention over S cached positions (4·Bl·(H/M)·S·hd), its slice of
    the MLP (6·Bl·D·F/M); and its block of the logits (2·Bl·D·V/M)."""
    M, Bl = mesh.shape["model"], shape.global_batch // mesh.shape["data"]
    D, F, V, hd = cfg.d_model, cfg.d_ff, cfg.padded_vocab, cfg.resolved_head_dim
    H, kv, S = cfg.num_heads // M, cfg.kv_heads // M, shape.seq_len
    layer = 2 * Bl * D * hd * (2 * H + 2 * kv) + 4 * Bl * H * S * hd + 6 * Bl * D * F // M
    return cfg.layers * layer + 2 * Bl * D * V // M


def test_tensor_parallel_decode_moves_no_kv_byte():
    """granite decode on data 2 × model 2, where its heads divide: each model
    shard multiplies its own blocks on its own device (every device does
    exactly its share of the step's FLOPs), the blocks arrive over data
    only, and no K/V byte moves (each shard reads and writes its own piece
    of the cache: no gather, no write-back)."""
    cfg, mesh = get_smoke_config("granite-3-2b"), mesh22()
    run = DR._fake_run(cfg, DECODE, mesh)
    got = run["counter"].collective_bytes()
    with FakeTensorMode():
        args, _ = STEPS.input_specs(cfg, DECODE, mesh)
        layers, rest = param_gathers(cfg, mesh, args["params"], DECODE.global_batch)
        tp = tp_moves(cfg, mesh, args["params"], DECODE)
        kv = [s for p, s in zip(leaf_paths(args["cache"]), leaves(args["cache"]))]
    assert kv and all(tuple(s.spec) == ("data", None, "model", None) for s in kv)
    logits = (DECODE.global_batch // 2) * cfg.padded_vocab * 4     # data shard 1's, to the first
    assert got["all-gather"] == (layers + rest + logits + tp["layers"]["all-gather"]
                                 + tp["outer"]["all-gather"])
    assert got["all-reduce"] == tp["layers"]["all-reduce"] + tp["outer"]["all-reduce"] > 0
    assert got["collective-permute"] == got["reduce-scatter"] == got["all-to-all"] == 0
    want = decode_flops_per_shard(cfg, mesh, DECODE)
    assert {d: run["counter"].flops.get(d, 0) for d in mesh.devices} == \
        dict.fromkeys(mesh.devices, want)


def test_tensor_parallel_train_step_on_four_devices():
    """granite's train step on data 2 × model 2: attention, MLP and
    vocabulary all tensor-parallel; the bytes by kind as derived, and each
    device does the same share of the FLOPs (its blocks' forward and
    backward), within the elementwise-free count of a smoke step."""
    cfg, mesh = get_smoke_config("granite-3-2b"), mesh22()
    run, got = _train_moves_hold(cfg, mesh)
    flops = [run["counter"].flops.get(d, 0) for d in mesh.devices]
    assert min(flops) > 0 and len(set(flops)) == 1


def test_rwkv6_runs_tensor_parallel_on_four_devices():
    """rwkv6's train step on data 2 × model 2, where the smoke config's 2
    heads divide (on 2 × 4 only its channel mix splits): the time mix and
    the channel mix in blocks on their model shards, the bytes by kind as
    derived (the per-head slices and the decay's columns out, the
    receptance blocks back), and every device computes.  The norms, the
    decay and the token shifts run on the unit's device, so the shares are
    not equal, as granite's are."""
    cfg, mesh = get_smoke_config("rwkv6-3b"), mesh22()
    run, got = _train_moves_hold(cfg, mesh)
    flops = [run["counter"].flops.get(d, 0) for d in mesh.devices]
    assert min(flops) > 0 and got["all-reduce"] > 0


def test_counter_puts_a_loose_constant_on_the_ops_device():
    """Some versions of fake mode put ``torch.tensor(v, device="meta:i")`` on
    the index-less ``meta`` device; the counter retries the op with that
    0-d constant on the op's device, and counts no move for it."""
    from repro_torch.util.costs import CostCounter

    with FakeTensorMode():
        x = torch.zeros(3, device="meta:2")
        c = torch.zeros((), device="meta")
        with CostCounter() as k:
            y = torch.where(x > 0, c, x)
        with pytest.raises(RuntimeError):
            torch.where(x > 0, c, torch.zeros(3, device="meta:1"))
    assert y.device == torch.device("meta", 2)
    assert k.collective_bytes()["total"] == 0 and set(k.bytes) == {torch.device("meta", 2)}
