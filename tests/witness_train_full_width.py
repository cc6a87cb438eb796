"""Full-width training through both packages, on the CPU, at two layers.

Phase 22(b) and (c) of ``chip_smoke.py`` train granite-3-2b and rwkv6-3b at
full width and depth on the card, where the reference (JAX) does not run.
This script is their witness at the widths the card runs (d_model, heads,
d_ff and vocabulary of the published configs) but two layers, in two parts:

* *Trajectories*: the reference's trainer from its own ``init_state``
  weights, then the port's trainer from the same weights carried by
  ``params_from_reference``, on the same synthetic batches and at the card
  run's optimizer settings (granite: 8 steps, lr 3e-4, warmup 2; rwkv6: 3
  steps, lr 3e-4, warmup 1).  Every loss is finite, and each step's loss
  and grad_norm agree within ``LOSS_RTOL`` and ``NORM_RTOL``.  granite runs
  in bf16, as on the card; rwkv6 in f32 (see below).
* *bf16 drift*: the first step's gradients of each arch in bf16 from both
  packages, each measured by its distance from the reference's f32
  gradients of the same weights, |g_bf16 - g_f32| / |g_f32| over every
  leaf.  The port's distance is at most ``DRIFT_FACTOR`` times the
  reference's.  rwkv6's bf16 gradients lie far from its f32 ones in the
  reference itself (the per-head group norm of the chunked recurrence's
  output magnifies bf16 rounding), so two packages that round differently
  differ by that much too, and its trajectory is compared in f32.

Not collected by pytest (it takes ~15 minutes and ~12 GB of memory): run it by hand,

  PYTHONPATH=src JAX_PLATFORMS=cpu python tests/witness_train_full_width.py \
      [--arch granite-3-2b] [--layers 2] [--batch 4] [--seq 256] [--json out.json]

At step 1 Adam moves each weight by about lr x sign(g), so a gradient entry
near zero that the packages round differently moves either way; the
trajectory tolerances bound how far that carries in eight steps.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import registry as RREG
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import synthesize_batch
from repro.launch import steps as RSTEPS
from repro.launch.mesh import make_host_mesh as ref_host_mesh
from repro.optim.adamw import AdamWConfig as RefAdamWConfig
from repro.models import transformer as RTF
from repro.train import trainer as RTR

from repro_torch.configs import registry as REG
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch import steps as STEPS
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.convert import params_from_reference
from repro_torch.optim import adamw
from repro_torch.train import trainer as TR
from repro_torch.util.tree import leaves

# arch: steps, warmup (phase 22's settings: b, train_with_restart; c, rwkv),
# and the dtype of the trajectory run
RUNS = {"granite-3-2b": (8, 2, "bfloat16"), "rwkv6-3b": (3, 1, "float32")}
LR = 3e-4
LOSS_RTOL = 2e-2     # update rounding carried over 8 steps
NORM_RTOL = 1e-1
DRIFT_FACTOR = 2.0


def _configs(arch: str, layers: int, dtype: str):
    return (dataclasses.replace(RREG.get_config(arch), layers=layers, dtype=dtype),
            dataclasses.replace(REG.get_config(arch), layers=layers, dtype=dtype))


def trajectories(arch: str, layers: int, batch: int, seq: int) -> dict:
    steps, warmup, dtype = RUNS[arch]
    rcfg, pcfg = _configs(arch, layers, dtype)
    tcfg = dict(steps=steps, log_every=steps)

    mesh = ref_host_mesh()
    rstate = RTR.init_state(rcfg, mesh, seed=0)
    start = jax.tree.map(np.asarray, rstate.params)
    ref = []
    RTR.train(rcfg, RefAdamWConfig(lr=LR, warmup_steps=warmup, total_steps=steps),
              RefDataConfig(vocab=rcfg.vocab, seq_len=seq, global_batch=batch),
              RTR.TrainerConfig(**tcfg), mesh, state=rstate, metrics_out=ref)
    del rstate
    gc.collect()

    params = params_from_reference(pcfg, start)
    del start
    port = []
    TR.train(pcfg, adamw.AdamWConfig(lr=LR, warmup_steps=warmup, total_steps=steps),
             DataConfig(vocab=pcfg.vocab, seq_len=seq, global_batch=batch),
             TR.TrainerConfig(**tcfg), make_host_mesh(1, device="cpu"),
             state=TR.TrainState(params, adamw.init(params), 0), metrics_out=port)
    del params
    gc.collect()
    return {"arch": arch, "dtype": dtype, "layers": layers, "batch": batch, "seq": seq,
            "steps": steps, "warmup": warmup, "lr": LR,
            "ref_loss": [m["loss"] for m in ref], "port_loss": [m["loss"] for m in port],
            "ref_grad_norm": [m["grad_norm"] for m in ref],
            "port_grad_norm": [m["grad_norm"] for m in port]}


def bf16_drift(arch: str, layers: int, batch: int, seq: int) -> dict:
    """Each package's bf16 gradients of the first batch, and the port's f32
    ones, against the reference's f32 gradients of the same
    (bf16-representable) weights."""
    truth, norm, out = None, None, {}
    base = None
    for dtype in ("float32", "bfloat16"):
        rcfg, pcfg = _configs(arch, layers, dtype)
        if base is None:
            base = RTF.init_params(jax.random.PRNGKey(0), rcfg)
            base = jax.tree.map(lambda a: a.astype(jnp.bfloat16).astype(jnp.float32), base)
        params = jax.tree.map(lambda a: a.astype(rcfg.dtype), base)
        full = synthesize_batch(RefDataConfig(vocab=rcfg.vocab, seq_len=seq,
                                              global_batch=batch), 0)
        tokens, labels = full[:, :-1].astype(np.int32), full[:, 1:].astype(np.int32)

        def loss_fn(p):
            logits, _, aux = RTF.forward(p, tokens, rcfg)
            return RSTEPS.cross_entropy(logits, labels) + 0.01 * aux

        rg = leaves(params_from_reference(pcfg, jax.tree.map(
            np.asarray, jax.jit(jax.grad(loss_fn))(params))))
        tparams = params_from_reference(pcfg, jax.tree.map(np.asarray, params))
        del params
        gc.collect()
        if truth is None:
            truth = [t.float() for t in rg]
            norm = math.sqrt(sum(float((t.double() ** 2).sum()) for t in truth))
        else:
            out["ref_" + dtype] = _dist(rg, truth, norm)
        del rg
        _, _, g = STEPS.make_grad_fn(pcfg)(tparams, torch.from_numpy(tokens),
                                           torch.from_numpy(labels))
        out["port_" + dtype] = _dist(leaves(g), truth, norm)
        del g, tparams
        gc.collect()
    return {"arch": arch, "layers": layers, "batch": batch, "seq": seq,
            "port_f32": out["port_float32"], "ref_bf16": out["ref_bfloat16"],
            "port_bf16": out["port_bfloat16"]}


def _dist(gs, truth, norm: float) -> float:
    """|gs - truth| / |truth| over every leaf, summed in f64."""
    return math.sqrt(sum(float(((a.double() - b.double()) ** 2).sum())
                         for a, b in zip(gs, truth))) / norm


def check(r: dict) -> list:
    faults = []
    for s, (a, b, ga, gb) in enumerate(zip(r["ref_loss"], r["port_loss"], r["ref_grad_norm"],
                                           r["port_grad_norm"]), 1):
        if not (math.isfinite(a) and math.isfinite(b)):
            faults.append(f"step {s}: a loss is not finite ({a}, {b})")
        elif abs(a - b) > LOSS_RTOL * abs(a):
            faults.append(f"step {s}: loss {b} against the reference's {a}")
        if not abs(ga - gb) <= NORM_RTOL * abs(ga):
            faults.append(f"step {s}: grad_norm {gb} against the reference's {ga}")
    return faults


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(RUNS), action="append")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--json", default=None, help="write the numbers here")
    args = ap.parse_args(argv)
    results, faults = [], []
    for arch in args.arch or sorted(RUNS):
        r = trajectories(arch, args.layers, args.batch, args.seq)
        results.append(r)
        print(f"[witness] {arch}, {args.layers} layers at full width, {r['dtype']}, "
              f"B={args.batch} S={args.seq}, lr {LR}, warmup {r['warmup']}:")
        for s in range(r["steps"]):
            print(f"[witness]   step {s + 1}: loss reference {r['ref_loss'][s]:.4f} port "
                  f"{r['port_loss'][s]:.4f}; grad_norm reference {r['ref_grad_norm'][s]:.3f} "
                  f"port {r['port_grad_norm'][s]:.3f}")
        drop = [r["ref_loss"][0] - r["ref_loss"][-1], r["port_loss"][0] - r["port_loss"][-1]]
        print(f"[witness]   first minus last loss: reference {drop[0]:+.4f}, port {drop[1]:+.4f}; "
              f"highest loss: reference {max(r['ref_loss']):.4f} (step "
              f"{int(np.argmax(r['ref_loss'])) + 1}), port {max(r['port_loss']):.4f} (step "
              f"{int(np.argmax(r['port_loss'])) + 1})")
        faults += [f"{arch} {f}" for f in check(r)]

        d = bf16_drift(arch, args.layers, args.batch, args.seq)
        results.append(d)
        print(f"[witness] {arch} first-step gradients, distance from the reference's f32 "
              f"gradients: port f32 {d['port_f32']:.3e}; bf16 reference {d['ref_bf16']:.4f}, "
              f"port {d['port_bf16']:.4f} (at most {DRIFT_FACTOR} x the reference's)")
        if not d["port_bf16"] <= DRIFT_FACTOR * d["ref_bf16"]:
            faults.append(f"{arch} bf16 drift {d['port_bf16']} over {DRIFT_FACTOR} x "
                          f"{d['ref_bf16']}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
    for f in faults:
        print(f"[witness] FAIL {f}")
    return 1 if faults else 0


if __name__ == "__main__":
    sys.exit(main())
