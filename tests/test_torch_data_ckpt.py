"""The port's data pipeline and checkpoints.

``repro_torch.data.pipeline`` gives the reference's tokens bit for bit (its
numpy is copied, not imported), and ``global_batch_array`` the reference's
(tokens, labels) on the mesh's device.  ``repro_torch.checkpoint.ckpt`` keeps
the reference's layout and contract: atomic ``.tmp`` staging and ``LATEST``,
keep-k pruning after the commit, a stale ``LATEST`` falling back to the
newest complete step, shapes checked on restore, bf16 leaves (stored as
their uint16 bits) restored bit for bit, an ``AdamWState`` walked in order.
"""
import json
import os

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  one torch thread per test process

from repro.data import pipeline as RDATA
from repro.launch.mesh import make_host_mesh as ref_host_mesh

from repro_torch.checkpoint import ckpt as CKPT
from repro_torch.data import pipeline as DATA
from repro_torch.launch.mesh import ShardMesh, make_host_mesh
from repro_torch.optim import adamw

CPU_MESH = make_host_mesh(device="cpu")


# --- data pipeline ---------------------------------------------------------------------


@pytest.mark.parametrize("vocab,seq,batch,seed", [
    (1000, 32, 4, 7), (512, 64, 4, 1), (49155, 257, 3, 0), (65536, 16, 2, 5)])
def test_synthesize_batch_equals_reference_bit_for_bit(vocab, seq, batch, seed):
    cfg = DATA.DataConfig(vocab=vocab, seq_len=seq, global_batch=batch, seed=seed)
    rcfg = RDATA.DataConfig(vocab=vocab, seq_len=seq, global_batch=batch, seed=seed)
    for step in (0, 3, 11):
        ours = DATA.synthesize_batch(cfg, step)
        assert ours.dtype == np.int32 and ours.shape == (batch, seq + 1)
        np.testing.assert_array_equal(ours, RDATA.synthesize_batch(rcfg, step))
    np.testing.assert_array_equal(DATA.synthesize_batch(cfg, 2, rows=slice(1, 2)),
                                  RDATA.synthesize_batch(rcfg, 2, rows=slice(1, 2)))


def test_data_deterministic_and_restart_safe():
    cfg = DATA.DataConfig(vocab=1000, seq_len=32, global_batch=4, seed=7)
    a = DATA.synthesize_batch(cfg, step=3)
    np.testing.assert_array_equal(a, DATA.synthesize_batch(cfg, step=3))
    assert not np.array_equal(a, DATA.synthesize_batch(cfg, step=4))
    assert a.dtype == np.int32 and a.min() >= 0 and a.max() < 1000


def test_data_has_learnable_structure():
    batch = DATA.synthesize_batch(DATA.DataConfig(vocab=1000, seq_len=256, global_batch=2), 0)
    assert len(set(batch.reshape(-1).tolist())) < 900


def test_global_batch_array_equals_reference():
    cfg = DATA.DataConfig(vocab=512, seq_len=64, global_batch=4, seed=1)
    rcfg = RDATA.DataConfig(vocab=512, seq_len=64, global_batch=4, seed=1)
    rmesh = ref_host_mesh()
    for step in (0, 5):
        tokens, labels = DATA.global_batch_array(cfg, step, CPU_MESH)
        rt, rl = RDATA.global_batch_array(rcfg, step, rmesh)
        assert tokens.dtype == labels.dtype == torch.int32
        assert tokens.device == labels.device == torch.device("cpu")
        np.testing.assert_array_equal(tokens.numpy(), np.asarray(rt))
        np.testing.assert_array_equal(labels.numpy(), np.asarray(rl))
    # restart-safe: a fresh stream from step 5 gives step 5's batch
    tokens, _ = next(DATA.batches(cfg, CPU_MESH, start_step=5))
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(rt))


def test_global_batch_array_refuses_a_two_shard_mesh():
    """No longer refused: on two data shards each gets its half of the rows
    on its device (``Sharded`` over ``data``), the reference's rows; a batch
    that does not divide over the shards is refused, as the reference's
    sharding refuses it."""
    from repro_torch.util.sharded import Sharded

    cfg = DATA.DataConfig(vocab=512, seq_len=32, global_batch=2)
    tokens, labels = DATA.global_batch_array(cfg, 0, make_host_mesh(2, device="cpu"))
    whole, whole_l = DATA.global_batch_array(cfg, 0, CPU_MESH)
    assert isinstance(tokens, Sharded) and tuple(tokens.spec) == ("data", None)
    assert [tuple(p.shape) for p in tokens.pieces] == [(1, 32), (1, 32)]
    assert torch.equal(tokens.full(), whole) and torch.equal(labels.full(), whole_l)
    with pytest.raises(ValueError, match="does not divide"):
        DATA.global_batch_array(cfg, 0, make_host_mesh(4, device="cpu"))


# --- checkpoints -----------------------------------------------------------------------


def _state_tree(rng):
    params = {"w": torch.from_numpy(rng.standard_normal((4, 4)).astype(np.float32)),
              "layers": [{"a": torch.from_numpy(rng.standard_normal(6).astype(np.float32))
                          .to(torch.bfloat16)} for _ in range(2)]}
    opt = adamw.init(params)
    opt = adamw.AdamWState(opt.step + 3, opt.mu, opt.nu)
    return {"params": params, "opt": opt}


def test_checkpoint_roundtrip_bf16_bits_and_adamw_state(tmp_path, rng):
    tree = _state_tree(rng)
    # bf16 values whose bits a float round trip would change: NaN payloads,
    # subnormals, -0.0
    special = torch.tensor([0x7FC1, 0x0001, 0x8000, 0x7F80, 0xFF81, 0x3F80],
                           dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    tree["params"]["layers"][1]["a"] = special
    d = str(tmp_path / "ck")
    path = CKPT.save(d, 10, tree)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    assert [l["dtype"] for l in manifest["leaves"]].count("bfloat16") == 2
    assert manifest["step"] == 10 and "AdamWState" in manifest["treedef"]
    target = {"params": {"w": torch.zeros(4, 4),
                         "layers": [{"a": torch.zeros(6, dtype=torch.bfloat16)} for _ in range(2)]},
              "opt": adamw.init({"w": torch.zeros(4, 4), "layers": [{"a": torch.zeros(6)}] * 2})}
    restored, step = CKPT.restore(d, target)
    assert step == 10 and isinstance(restored["opt"], adamw.AdamWState)
    assert restored["opt"].step.dtype == torch.int32 and int(restored["opt"].step) == 3
    assert torch.equal(restored["params"]["w"], tree["params"]["w"])
    for got, want in zip(restored["params"]["layers"], tree["params"]["layers"]):
        assert got["a"].dtype == torch.bfloat16
        assert torch.equal(got["a"].view(torch.int16), want["a"].view(torch.int16))


def test_checkpoint_roundtrip_and_atomicity(tmp_path, rng):
    tree = {"params": {"w": torch.from_numpy(rng.standard_normal((4, 4)).astype(np.float32))},
            "step_count": torch.tensor(5)}
    d = str(tmp_path / "ck")
    CKPT.save(d, 10, tree)
    CKPT.save(d, 20, {"params": {"w": tree["params"]["w"] + 1}, "step_count": torch.tensor(6)})
    assert CKPT.latest_step(d) == 20
    restored, step = CKPT.restore(d, tree)
    assert step == 20 and int(restored["step_count"]) == 6
    np.testing.assert_allclose(restored["params"]["w"].numpy(), tree["params"]["w"].numpy() + 1)
    # stale .tmp dirs are ignored, and a leftover one is replaced on save
    os.makedirs(os.path.join(d, "step_00000099.tmp"), exist_ok=True)
    os.makedirs(os.path.join(d, "step_00000030.tmp"), exist_ok=True)
    assert CKPT.latest_step(d) == 20
    CKPT.save(d, 30, tree)
    assert CKPT.all_steps(d) == [10, 20, 30] and not os.path.exists(os.path.join(d, "step_00000030.tmp"))
    assert CKPT.restore(d, tree, step=10)[1] == 10


def test_checkpoint_keep_k(tmp_path):
    d = str(tmp_path / "ck")
    for s in [1, 2, 3, 4, 5]:
        CKPT.save(d, s, {"w": torch.zeros(3)}, keep=2)
    assert CKPT.all_steps(d) == [4, 5]


def test_stale_latest_falls_back_to_newest_complete_step(tmp_path):
    d = str(tmp_path / "ck")
    for s in (1, 2):
        CKPT.save(d, s, {"w": torch.full((3,), float(s))})
    with open(os.path.join(d, "LATEST"), "w") as f:
        f.write("7")                       # names a step that never committed
    assert CKPT.latest_step(d) == 2
    with open(os.path.join(d, "LATEST"), "w") as f:
        f.write("garbage")
    assert CKPT.latest_step(d) == 2
    restored, step = CKPT.restore(d, {"w": torch.zeros(3)})
    assert step == 2 and float(restored["w"][0]) == 2.0
    assert CKPT.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        CKPT.restore(str(tmp_path / "none"), {"w": torch.zeros(3)})


def test_restore_refuses_a_shape_mismatch(tmp_path):
    d = str(tmp_path / "ck")
    CKPT.save(d, 1, {"w": torch.zeros(3, 4)})
    with pytest.raises(ValueError, match="shape"):
        CKPT.restore(d, {"w": torch.zeros(4, 3)})
    with pytest.raises(ValueError, match="leaves"):
        CKPT.restore(d, {"w": torch.zeros(3, 4), "b": torch.zeros(1)})


def test_restore_casts_to_the_target_dtype_and_device(tmp_path):
    d = str(tmp_path / "ck")
    CKPT.save(d, 1, {"w": torch.tensor([1.5, -2.25])})
    target = {"w": torch.zeros(2, dtype=torch.bfloat16, device=torch.device("cpu", 0))}
    restored, _ = CKPT.restore(d, target)
    assert restored["w"].dtype == torch.bfloat16
    assert restored["w"].device == target["w"].device
    assert restored["w"].tolist() == [1.5, -2.25]
    assert isinstance(CPU_MESH, ShardMesh)
