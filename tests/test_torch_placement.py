"""The port's placement on distinct devices: the sharded LM steps fake-run on
a data 2 × model 4 mesh of eight ``meta:i`` devices.

On one card every shard's device is that card and ``.to(device)`` is a
no-op, so the card cannot show a missing move.  Fake tensors on eight
distinct indexed ``meta`` devices can: an op whose tensors lie on two
devices raises ``FakeTensorDeviceMismatchError``.  The steps run at smoke
size through ``launch.dryrun``'s fake run (``steps.input_specs`` places the
arguments as the steps take them), and the bytes each one moves between
devices are held by collective kind (``util.costs``):

  * the sharded train step: each data shard gathers every leaf onto its
    device, one layer at a time (all-gather: every piece it does not hold;
    under EP the expert leaves onto the model shards' devices), the
    gradients go back to the pieces (reduce-scatter, the same bytes), EP
    moves the rows and the router to the model shards (all-to-all) and sums
    the partial outputs (all-reduce); under remat the backward's recompute
    gathers each layer's leaves once more (all-gather only), and redoes
    EP's forward moves;
    the rest are 0-d float32 scalars (loss means, the divisor, gradient
    norm partials, AdamW's step values);
  * a jamba EP decode step on state in pieces: each data shard's unit
    gathers each layer onto its device (the expert leaves only over data,
    onto its model shards) and its rows of the attention cache, writes the
    position it wrote back to that position's owner (collective-permute),
    sends the rows and the router to the other model shards (all-to-all; no
    expert byte moves), sums the partial outputs (all-reduce) and returns
    its logits to the first shard (all-gather).
"""
import dataclasses
import math

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.registry import get_smoke_config
from repro_torch.launch import dryrun as DR
from repro_torch.launch import sharded as SHD
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


def param_gathers(cfg, mesh, params, B):
    """(layer leaves, other leaves): the bytes of the pieces each unit of a
    batch of B receives to make the params whole on its device, once (under
    EP the expert leaves' pieces go to the model shards' devices)."""
    gather = [0, 0]
    for rows, sub, dev in SHD._units(mesh, B):
        model_devs = [sub.device_at(model=m) for m in range(sub.shape["model"])]
        for path, s in zip(leaf_paths(params), leaves(params)):
            expert = (cfg.is_moe and path[-1] in SHD._EXPERT_LEAVES and "moe" in path
                      and "model" in spec_axes(s.spec[0]))
            for b, p in zip(s.blocks(), s.pieces):
                to = model_devs[b[0]] if expert else dev
                gather[path[0] != "layers"] += _nbytes(p) if s.owner(b) != to else 0
    return gather


def expected_train_moves(cfg, mesh, params):
    """(all-gather, all-to-all) bytes of one sharded train step: each unit
    receives the pieces it does not hold, the layers' twice under remat
    (the recompute gathers them again), and EP copies the rows and the
    router to each model shard."""
    ep = cfg.is_moe
    layers, rest = param_gathers(cfg, mesh, params, TRAIN.global_batch)
    gather = (2 if cfg.remat else 1) * layers + rest
    a2a = 0
    for rows, sub, dev in SHD._units(mesh, TRAIN.global_batch):
        model_devs = [sub.device_at(model=m) for m in range(sub.shape["model"])]
        if ep:
            n_moe = sum(TF.layer_spec(cfg, i)[1] for i in range(TF.num_layers(cfg)))
            Bl, T, D = rows.stop - rows.start, TRAIN.seq_len, cfg.d_model
            # the expert pieces sit on their model shards already: the
            # router and the rows go there
            a2a += n_moe * sum(D * cfg.num_experts * 4 + Bl * T * D * 4
                               for d in model_devs if d != dev)
    return gather, a2a


@pytest.mark.parametrize("arch", ["granite-3-2b", "jamba-v0.1-52b", "rwkv6-3b"])
def test_sharded_train_step_on_eight_devices(arch):
    cfg, mesh = get_smoke_config(arch), mesh24()
    run = DR._fake_run(cfg, TRAIN, mesh)          # raises on a device mismatch
    got = run["counter"].collective_bytes()
    with FakeTensorMode():
        args, _ = STEPS.input_specs(cfg, TRAIN, mesh)
        gather, a2a = expected_train_moves(cfg, mesh, args["params"])
        pieces = sum(len(s.pieces) for s in leaves(args["params"]))
    assert got["all-gather"] == gather > 0
    assert got["reduce-scatter"] == gather
    # the forward's moves and their gradients' way back
    assert got["all-to-all"] == 2 * a2a
    assert (got["all-reduce"] > 0) == cfg.is_moe
    # 0-d float32 scalars only: two a piece (the divisor, a norm partial),
    # a few a device (AdamW's step values), the units' loss and aux
    assert 0 < got["collective-permute"] <= 4 * (2 * pieces + 8 * mesh.size + 2 * 2)
    assert got["collective-permute"] % 4 == 0
    # every shard computes: each data shard's rows on its own device
    busy = [d for d in mesh.devices if run["counter"].flops.get(d, 0) > 0]
    assert len(busy) == (8 if cfg.is_moe else 2)


@pytest.mark.parametrize("arch", ["granite-3-2b", "jamba-v0.1-52b", "rwkv6-3b"])
def test_remat_train_step_gathers_each_layer_again_in_the_backward(arch):
    """Remat on: each checkpointed group gathers its layers inside the
    group, so the backward's recompute gathers them once more; the
    gradients go back once."""
    cfg, mesh = dataclasses.replace(get_smoke_config(arch), remat=True), mesh24()
    run = DR._fake_run(cfg, TRAIN, mesh)
    got = run["counter"].collective_bytes()
    with FakeTensorMode():
        args, _ = STEPS.input_specs(cfg, TRAIN, mesh)
        gather, a2a = expected_train_moves(cfg, mesh, args["params"])
        layers, rest = param_gathers(cfg, mesh, args["params"], TRAIN.global_batch)
    assert got["all-gather"] == gather == 2 * layers + rest
    assert got["reduce-scatter"] == layers + rest > 0
    # EP's forward moves twice (forward, recompute) and their way back once
    assert got["all-to-all"] == 3 * a2a
    assert (got["all-reduce"] > 0) == cfg.is_moe


def test_jamba_ep_decode_step_on_eight_devices():
    cfg, mesh = get_smoke_config("jamba-v0.1-52b"), mesh24()
    run = DR._fake_run(cfg, DECODE, mesh)
    got = run["counter"].collective_bytes()
    with FakeTensorMode():
        args, _ = STEPS.input_specs(cfg, DECODE, mesh)
        layers, rest = param_gathers(cfg, mesh, args["params"], DECODE.global_batch)
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
    assert got["all-gather"] == layers + rest + kv_gather + logits
    assert got["collective-permute"] == kv_write
    assert got["all-reduce"] == units * n_moe * 3 * Bl * D * 4      # partial outputs
    assert got["reduce-scatter"] == 0
    # each data row's dense layers on its first shard, the experts on all eight
    assert all(run["counter"].flops.get(d, 0) > 0 for d in mesh.devices)
    assert math.isclose(run["counter"].flops[mesh.devices[0]],
                        max(run["counter"].flops.values()))
    # state in pieces: each shard holds its blocks; the first one the most
    held[0] += 4                                     # cache_index
    assert run["state"] == held and max(held) == held[0] and min(held) > 0


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
