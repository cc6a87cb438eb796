"""Fault-tolerant training loop.

Port of ``repro.train.trainer``:
  * checkpoint/restart — atomic checkpoints every ``ckpt_every`` steps;
    restart resumes (params, opt state, data stream position) exactly;
  * failure injection — ``failure_at`` raises mid-run in tests, the restart
    path is exercised end-to-end;
  * straggler watchdog — per-step wall times feed an EWMA; steps slower than
    ``straggler_factor`` × EWMA are flagged with the step index;
  * elastic rebuild — on restart the mesh is re-formed (the caller's
    factory, e.g. ``launch.mesh.rebuild_mesh_after_failure``) and the
    checkpoint is resharded onto it;
  * optional CSR top-k gradient compression (optim/compress.py).

On a one-shard mesh (``launch.mesh.make_host_mesh``) the state is tensors on
its device; on a mesh of several shards it is cut by
``launch.sharding.params_pspecs`` into ``util.sharded.Sharded`` pieces on
the shards' devices (ZeRO: the moments take the params' cut), and each
step runs the sharded train step.  Weights are drawn from a seeded
``torch.Generator`` on the mesh's first device, so every mesh starts from
the same weights.  A step ends in ``torch.cuda.synchronize()`` of each card
the mesh uses, where the reference blocks on the loss.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.checkpoint import ckpt as CKPT
from repro_torch.data.pipeline import DataConfig, global_batch_array
from repro_torch.launch import sharded as SHD
from repro_torch.launch import steps as STEPS
from repro_torch.launch.mesh import ShardMesh, mesh_device
from repro_torch.models import encdec as ED
from repro_torch.models import transformer as TF
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    keep_ckpts: int = 3
    log_every: int = 10
    straggler_factor: float = 3.0
    failure_at: Optional[int] = None      # test hook: raise at this step
    seed: int = 0
    microbatches: int = 1
    compress_density: Optional[float] = None   # CSR top-k grad compression


class SimulatedFailure(RuntimeError):
    pass


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: adamw.AdamWState
    step: int


def init_state(cfg: ModelConfig, mesh: ShardMesh, seed: int = 0) -> TrainState:
    """Seeded weights and zero moments: tensors on a one-shard mesh's device,
    else pieces cut by ``params_pspecs`` on the mesh."""
    init = ED.init_params if cfg.is_encdec else TF.init_params
    gen = torch.Generator(device=mesh_device(mesh)).manual_seed(seed)
    params = init(gen, cfg)
    if mesh.size > 1:
        params = SHD.shard_tree(params, mesh)
    return TrainState(params=params, opt_state=adamw.init(params), step=0)


def train(
    cfg: ModelConfig,
    opt_cfg: adamw.AdamWConfig,
    data_cfg: DataConfig,
    tcfg: TrainerConfig,
    mesh: ShardMesh,
    *,
    state: Optional[TrainState] = None,
    metrics_out: Optional[List[Dict]] = None,
) -> TrainState:
    """Run (or resume) training. Returns the final state."""
    if state is None:
        state = init_state(cfg, mesh, tcfg.seed)
        if tcfg.ckpt_dir and CKPT.latest_step(tcfg.ckpt_dir) is not None:
            tree = {"params": state.params, "opt": state.opt_state}
            tree, step = CKPT.restore(tcfg.ckpt_dir, tree)
            state = TrainState(tree["params"], tree["opt"], step)
            print(f"[trainer] resumed from step {step}")

    compression = None
    comp_state = None
    if tcfg.compress_density is not None:
        from repro_torch.optim import compress as COMP
        compression = COMP.CompressionConfig(density=tcfg.compress_density)
        comp_state = COMP.init(state.params)
    step_fn = STEPS.make_train_step(
        cfg, opt_cfg, mesh, microbatches=tcfg.microbatches,
        compression=compression,
    )
    cards = sorted({d for d in mesh.devices if d.type == "cuda"}, key=str)

    def sync():
        for d in cards:
            torch.cuda.synchronize(d)

    ewma = None
    while state.step < tcfg.steps:
        tokens, labels = global_batch_array(data_cfg, state.step, mesh)
        t0 = time.time()
        if tcfg.failure_at is not None and state.step == tcfg.failure_at:
            raise SimulatedFailure(f"injected failure at step {state.step}")
        if compression is not None:
            params, opt_state, comp_state, metrics = step_fn(
                state.params, state.opt_state, comp_state, tokens, labels
            )
        else:
            params, opt_state, metrics = step_fn(
                state.params, state.opt_state, tokens, labels
            )
        sync()
        dt = time.time() - t0
        ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
        straggler = dt > tcfg.straggler_factor * ewma
        state = TrainState(params, opt_state, state.step + 1)
        if metrics_out is not None:
            metrics_out.append(
                {
                    "step": state.step,
                    "loss": float(metrics["loss"]),
                    "lr": float(metrics["lr"]),
                    "grad_norm": float(metrics["grad_norm"]),
                    "time_s": dt,
                    "straggler": straggler,
                }
            )
        if state.step % tcfg.log_every == 0 or state.step == tcfg.steps:
            print(
                f"[trainer] step {state.step} loss {float(metrics['loss']):.4f} "
                f"lr {float(metrics['lr']):.2e} {dt*1e3:.0f}ms"
                + (" STRAGGLER" if straggler else "")
            )
        if tcfg.ckpt_dir and state.step % tcfg.ckpt_every == 0:
            CKPT.save(
                tcfg.ckpt_dir, state.step,
                {"params": state.params, "opt": state.opt_state},
                keep=tcfg.keep_ckpts,
            )
    return state


def train_with_restart(
    cfg: ModelConfig,
    opt_cfg: adamw.AdamWConfig,
    data_cfg: DataConfig,
    tcfg: TrainerConfig,
    mesh_factory: Callable[[], ShardMesh],
    *,
    max_restarts: int = 3,
    metrics_out: Optional[List[Dict]] = None,
) -> TrainState:
    """Supervisor loop: on failure, rebuild the mesh and resume from the last
    checkpoint — the cluster-level restart contract, runnable in-process."""
    attempts = 0
    while True:
        mesh = mesh_factory()
        try:
            return train(
                cfg, opt_cfg, data_cfg, tcfg, mesh, metrics_out=metrics_out
            )
        except SimulatedFailure as e:
            attempts += 1
            print(f"[trainer] {e}; restart {attempts}/{max_restarts}")
            if attempts > max_restarts:
                raise
            tcfg = dataclasses.replace(tcfg, failure_at=None)
