"""AdamW optimizer + LR schedules + gradient clipping.

Port of ``repro.optim.adamw``.  The state is plain tensors in the params'
layout (``mu`` and ``nu`` float32, ``step`` a 0-d int32 tensor on the
params' device, so a step reads nothing back to the host).  The arithmetic
follows jnp's promotions: the schedule, the bias corrections ``b ** step``
and the clip scale are float32 tensors, and a bf16 gradient times the f32
clip scale is float32.

``apply`` updates the params and the moments in place, one leaf at a time
(the reference's trainer donates both to its step), so at full width the
float32 temporaries are one leaf's, never the tree's; it returns the params
as the reference does.  On a mesh the leaves are ``util.sharded.Sharded``
and ``init``, ``global_norm`` and ``apply`` walk their pieces
(``pieces_of``), each updated on its own shard's device: the ZeRO layout.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.util.sharded import pieces_of, zeros_f32
from repro_torch.util.tree import leaves, tree_map

Params = Any


class AdamWState(NamedTuple):
    step: torch.Tensor
    mu: Params
    nu: Params


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1
    schedule: str = "cosine"        # cosine | linear | constant


def lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor), as a float32 tensor."""
    step = torch.as_tensor(step).to(torch.float32)
    # divisors as tensors: CUDA multiplies by the reciprocal of a host scalar
    div = lambda n: torch.tensor(float(n), dtype=torch.float32, device=step.device)
    warm = torch.clamp(step / div(max(cfg.warmup_steps, 1)), max=1.0)
    if cfg.schedule == "constant":
        decay = 1.0
    else:
        frac = torch.clamp(
            (step - cfg.warmup_steps) / div(max(cfg.total_steps - cfg.warmup_steps, 1)),
            0.0, 1.0,
        )
        if cfg.schedule == "cosine":
            decay = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
                1 + torch.cos(math.pi * frac)
            )
        else:
            decay = 1.0 - (1.0 - cfg.min_lr_frac) * frac
    return cfg.lr * warm * decay


def init(params: Params) -> AdamWState:
    """Zero moments in the params' layout (pieces where the params are
    ``Sharded``); the step counter on the first leaf's device."""
    dev = leaves(params)[0].device
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        mu=tree_map(zeros_f32, params),
        nu=tree_map(zeros_f32, params),
    )


def global_norm(tree: Params) -> torch.Tensor:
    """The 2-norm of every leaf (every piece of a ``Sharded`` leaf) together,
    on the first leaf's device, float32: the float32 squares summed in
    float64 and the norm rounded once, so that the card and the CPU, whose
    float32 sums add in different orders, give one norm."""
    sq = [torch.sum(torch.square(x.to(torch.float32)), dtype=torch.float64)
          for x in pieces_of(tree)]
    return torch.sqrt(torch.sum(torch.stack([v.to(sq[0].device) for v in sq]))).float()


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    # a tensor numerator: ``float / tensor`` multiplies by the reciprocal
    num = torch.tensor(max_norm, dtype=torch.float32, device=norm.device)
    return torch.clamp(num / torch.clamp(norm, min=1e-12), max=1.0)


def clip_by_global_norm(grads: Params, max_norm: float) -> Tuple[Params, torch.Tensor]:
    """(grads × min(1, max_norm/‖grads‖), ‖grads‖); the clipped grads are
    float32 whatever their dtype, as jnp promotes bf16 × f32."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: g.to(torch.float32) * scale, grads), norm


@torch.no_grad()
def apply(
    cfg: AdamWConfig,
    params: Params,
    grads: Params,
    state: AdamWState,
) -> Tuple[Params, AdamWState, dict]:
    """One AdamW step; params keep their dtype, moments are f32 (mixed prec).

    ``params``, ``state.mu`` and ``state.nu`` are updated in place and
    returned; the clip scale is applied leaf by leaf as each gradient is read
    (the same product the reference forms over the whole tree first)."""
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.grad_clip) if cfg.grad_clip > 0 else None
    step = state.step + 1
    lr = lr_at(cfg, step)
    stepf = step.to(torch.float32)
    b1c = 1 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32, device=stepf.device), stepf)
    b2c = 1 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32, device=stepf.device), stepf)

    here = {stepf.device: (scale, lr, b1c, b2c)}
    for p, g, m, v in zip(pieces_of(params), pieces_of(grads), pieces_of(state.mu),
                          pieces_of(state.nu)):
        if p.device not in here:   # a piece on another device than the step counter
            here[p.device] = tuple(None if t is None else t.to(p.device)
                                   for t in here[stepf.device])
        scale, lr, b1c, b2c = here[p.device]
        g32 = g.to(torch.float32)
        if scale is not None:
            g32 = g32 * scale
        m.mul_(cfg.b1).add_(g32 * (1 - cfg.b1))
        v.mul_(cfg.b2).add_(torch.square(g32) * (1 - cfg.b2))
        del g32
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        p32 = p.to(torch.float32)
        delta.add_(cfg.weight_decay * p32)
        p.copy_(p32 - lr * delta)
        del delta, p32
    metrics = {"lr": here[stepf.device][1], "grad_norm": gnorm}
    return params, AdamWState(step, state.mu, state.nu), metrics
