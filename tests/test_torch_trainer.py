"""The port's trainer and training CLI, on the CPU at smoke size.

The reference's trainer cases (``tests/test_trainer.py``: loss decreases,
exact resume from a checkpoint, failure injection with the supervisor's
restart, the straggler flag, compressed training that still learns) run on
the port with the same shapes.  A cross-package run starts both trainers
from the reference's ``init_state`` weights (carried into the port's
``TrainState``) on the same data, and every step's loss, lr and grad_norm
agree to ``LOSS_RTOL`` (1e-5; 8e-8 seen).  That is a statement about this
small case only: at step 1 Adam moves every parameter by about lr × sign(g),
so a gradient of ~1e-8 that rounds differently in the two packages moves its
parameter ±lr, and on other weights the losses may drift further apart.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  one torch thread per test process

from repro.configs.registry import get_smoke_config as ref_smoke_config
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.launch.mesh import make_host_mesh as ref_host_mesh
from repro.optim.adamw import AdamWConfig as RefAdamWConfig
from repro.train import trainer as RTR

from repro_torch.configs.registry import get_smoke_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch import train as LAUNCH
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.convert import params_from_reference
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train import trainer as TR

LOSS_RTOL = 1e-5


def cpu_mesh():
    return make_host_mesh(device="cpu")


def _setup(steps, ckpt_dir=None, failure_at=None, schedule_steps=None):
    cfg = dataclasses.replace(get_smoke_config("granite-3-2b"), layers=2)
    # schedule length is independent of how many steps THIS invocation runs,
    # so partial runs + resumes see identical LR trajectories
    opt = AdamWConfig(lr=1e-3, warmup_steps=2,
                      total_steps=schedule_steps or steps, grad_clip=1.0)
    data = DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=4, seed=1)
    tcfg = TR.TrainerConfig(
        steps=steps, ckpt_dir=ckpt_dir, ckpt_every=5, log_every=100,
        failure_at=failure_at,
    )
    return cfg, opt, data, tcfg


def test_loss_decreases():
    cfg, opt, data, tcfg = _setup(steps=30)
    metrics = []
    TR.train(cfg, opt, data, tcfg, cpu_mesh(), metrics_out=metrics)
    first = np.mean([m["loss"] for m in metrics[:5]])
    last = np.mean([m["loss"] for m in metrics[-5:]])
    assert last < first - 0.2, (first, last)
    assert set(metrics[0]) == {"step", "loss", "lr", "grad_norm", "time_s", "straggler"}


def test_checkpoint_restart_exact_resume(tmp_path):
    """Train 20 straight vs 10 + restart + 10 → identical final loss."""
    cfg, opt, data, tcfg = _setup(steps=20)
    m_straight = []
    TR.train(cfg, opt, data, tcfg, cpu_mesh(), metrics_out=m_straight)

    d = str(tmp_path / "ck")
    cfg, opt, data, tcfg = _setup(steps=10, ckpt_dir=d, schedule_steps=20)
    TR.train(cfg, opt, data, tcfg, cpu_mesh())
    cfg, opt, data, tcfg = _setup(steps=20, ckpt_dir=d)
    m_resumed = []
    TR.train(cfg, opt, data, tcfg, cpu_mesh(), metrics_out=m_resumed)
    assert m_resumed[0]["step"] == 11  # resumed from step-10 checkpoint
    np.testing.assert_allclose(m_straight[-1]["loss"], m_resumed[-1]["loss"], rtol=1e-4)


def test_failure_injection_and_supervisor_restart(tmp_path, capsys):
    d = str(tmp_path / "ck")
    cfg, opt, data, tcfg = _setup(steps=15, ckpt_dir=d, failure_at=12)
    metrics = []
    state = TR.train_with_restart(cfg, opt, data, tcfg, cpu_mesh, metrics_out=metrics)
    assert state.step == 15
    # restart resumed from the step-10 checkpoint: steps 11,12 appear twice
    steps = [m["step"] for m in metrics]
    assert steps.count(11) == 2 and steps.count(12) == 1 + 1
    out = capsys.readouterr().out
    assert "injected failure at step 12; restart 1/3" in out
    assert "[trainer] resumed from step 10" in out


def test_straggler_flag_present():
    cfg, opt, data, tcfg = _setup(steps=3)
    metrics = []
    TR.train(cfg, opt, data, tcfg, cpu_mesh(), metrics_out=metrics)
    assert all("straggler" in m for m in metrics)


def test_compressed_training_still_learns():
    """CSR top-k gradient compression (density 5%) with error feedback:
    the loss still decreases."""
    cfg, opt, data, tcfg = _setup(steps=30)
    tcfg = dataclasses.replace(tcfg, compress_density=0.05)
    metrics = []
    TR.train(cfg, opt, data, tcfg, cpu_mesh(), metrics_out=metrics)
    first = np.mean([m["loss"] for m in metrics[:5]])
    last = np.mean([m["loss"] for m in metrics[-5:]])
    assert last < first - 0.1, (first, last)


def test_trainer_refuses_a_two_shard_mesh():
    """No longer refused: on two data shards the state is cut into pieces and
    the losses are the one-device run's."""
    from repro_torch.util.sharded import Sharded

    cfg, opt, data, tcfg = _setup(steps=3)
    state = TR.init_state(cfg, make_host_mesh(2, device="cpu"))
    assert all(isinstance(p, Sharded) for p in jax.tree.leaves(
        state.params, is_leaf=lambda x: isinstance(x, Sharded)))
    sharded, one = [], []
    TR.train(cfg, opt, data, tcfg, make_host_mesh(2, device="cpu"), metrics_out=sharded)
    TR.train(cfg, opt, data, tcfg, cpu_mesh(), metrics_out=one)
    for a, b in zip(sharded, one):
        assert abs(a["loss"] - b["loss"]) <= LOSS_RTOL * b["loss"]


def test_state_lives_on_the_mesh_device_and_init_is_seeded():
    cfg = dataclasses.replace(get_smoke_config("granite-3-2b"), layers=2)
    mesh = make_host_mesh(device=torch.device("cpu", 0))
    a, b = TR.init_state(cfg, mesh, seed=3), TR.init_state(cfg, mesh, seed=3)
    assert a.opt_state.step.device.type == "cpu" and a.step == 0
    assert all(torch.equal(x, y) for x, y in zip(jax.tree.leaves(a.params),
                                                 jax.tree.leaves(b.params)))


def test_cross_package_run_from_reference_weights():
    """Five steps of both trainers from the reference's initial state."""
    steps = 5
    rcfg = dataclasses.replace(ref_smoke_config("granite-3-2b"), layers=2)
    ropt = RefAdamWConfig(lr=1e-3, warmup_steps=2, total_steps=steps)
    rdata = RefDataConfig(vocab=rcfg.vocab, seq_len=64, global_batch=4, seed=1)
    mesh = ref_host_mesh()
    rstate = RTR.init_state(rcfg, mesh, seed=0)
    cfg, opt, data, tcfg = _setup(steps=steps)
    params = params_from_reference(cfg, jax.tree.map(np.asarray, rstate.params))
    ref_metrics = []
    RTR.train(rcfg, ropt, rdata, RTR.TrainerConfig(steps=steps, log_every=100), mesh,
              state=rstate, metrics_out=ref_metrics)

    metrics = []
    TR.train(cfg, opt, data, tcfg, cpu_mesh(),
             state=TR.TrainState(params, adamw.init(params), 0), metrics_out=metrics)
    assert [m["step"] for m in metrics] == [m["step"] for m in ref_metrics] == [1, 2, 3, 4, 5]
    for m, r in zip(metrics, ref_metrics):
        assert m["lr"] == pytest.approx(r["lr"], rel=LOSS_RTOL)
        assert m["grad_norm"] == pytest.approx(r["grad_norm"], rel=LOSS_RTOL)
        assert abs(m["loss"] - r["loss"]) <= LOSS_RTOL * r["loss"], (m, r)


def test_launch_train_cli_on_cpu(capsys):
    """The training CLI's ``main`` in this process, as a user's command line
    would call it."""
    LAUNCH.main(["--arch", "granite-3-2b", "--smoke", "--device", "cpu", "--steps", "3",
                    "--batch", "2", "--seq", "32"])
    out = capsys.readouterr().out
    assert "[trainer] step 3 loss" in out and "over 3 steps" in out


def test_launch_train_asks_for_one_shard_on_a_host_of_several_cards(monkeypatch):
    """``--device cuda`` on a host with four visible cards trains on one:
    the mesh the launcher builds has one shard, on card 0."""
    made = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(LAUNCH, "train_with_restart",
                        lambda cfg, opt, data, tcfg, mesh_fn, **kw: made.append(mesh_fn()))
    LAUNCH.main(["--arch", "granite-3-2b", "--smoke", "--steps", "1"])
    assert len(made) == 1 and made[0].devices == (torch.device("cuda", 0),)
    assert TR.mesh_device(made[0]) == torch.device("cuda", 0)


def test_launch_train_refuses_what_the_port_does_not_run():
    """Frontend archs and a missing card; ``--model-axis`` with ``--shards``
    now trains on a data × model mesh of CPU shards."""
    with pytest.raises(SystemExit, match="frontend inputs"):
        LAUNCH.main(["--arch", "seamless-m4t-medium", "--smoke", "--device", "cpu"])
    LAUNCH.main(["--arch", "granite-3-2b", "--smoke", "--device", "cpu", "--model-axis", "2",
                 "--shards", "4", "--steps", "1", "--batch", "2", "--seq", "16"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            LAUNCH.main(["--arch", "granite-3-2b", "--smoke", "--steps", "1"])
