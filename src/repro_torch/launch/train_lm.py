"""End-to-end driver: train a ~100M-param granite-family LM for a few hundred
steps on the synthetic pipeline, with checkpointing.

    PYTHONPATH=src python -m repro_torch.launch.train_lm [--steps 200] [--device cuda|cpu]
        [--layers 12 --d-model 768 --vocab 32768]

Port of ``examples/train_lm.py``: granite-3-2b's smoke config scaled to
12 layers × 768 (f32, no remat), AdamW with 20 warmup steps, the trainer's
checkpoints every 100 steps (into ``--ckpt-dir``, default a temporary
directory removed at the end).  ``--layers``, ``--d-model`` and ``--vocab``
shrink the model (the CPU tests use them); the defaults are the reference's
sizes.  It runs on the card unless ``--device cpu`` is given, and raises
where CUDA is asked for and absent.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import tempfile

import numpy as np

from repro_torch.configs.registry import get_smoke_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.trainer import TrainerConfig, train


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--d-model", type=int, default=768)
    ap.add_argument("--vocab", type=int, default=32768)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a temporary one)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    # ~100M params: granite family scaled to 12L × 768
    cfg = dataclasses.replace(
        get_smoke_config("granite-3-2b"),
        layers=args.layers, d_model=args.d_model, num_heads=12, kv_heads=4,
        d_ff=args.d_model * 8 // 3, vocab=args.vocab, dtype="float32", remat=False,
    )
    print(f"model: {cfg.layers}L d={cfg.d_model} → {cfg.param_count() / 1e6:.0f}M params")

    mesh = make_host_mesh(device=args.device, model=1)
    opt = AdamWConfig(lr=3e-4, warmup_steps=20, total_steps=args.steps)
    data = DataConfig(vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch)
    metrics = []
    with tempfile.TemporaryDirectory(prefix="train_lm_") as tmp:
        tcfg = TrainerConfig(steps=args.steps, ckpt_dir=args.ckpt_dir or tmp, ckpt_every=100,
                             log_every=20)
        train(cfg, opt, data, tcfg, mesh, metrics_out=metrics)
    first = np.mean([m["loss"] for m in metrics[:10]])
    last = np.mean([m["loss"] for m in metrics[-10:]])
    print(f"loss: {first:.3f} → {last:.3f} on {mesh.devices[0]} "
          f"({'LEARNING' if last < first - 0.3 else 'check hyperparameters'})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
