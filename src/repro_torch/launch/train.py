"""Training launcher.

Port of ``repro.launch.train``.  Weights come from a seeded generator on the
device and data from the seeded synthetic pipeline; nothing is downloaded.

On a CUDA card (the default):
  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \
      --steps 3 --batch 2 --seq 512
On the CPU, at the smoke config:
  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b --smoke \
      --steps 50 --batch 8 --seq 256 --ckpt-dir /tmp/ckpt --device cpu

``--shards N`` stands for the reference's forced device count: the trainer
runs on a ``data × model`` mesh of N shards laid over the visible devices of
``--device`` (``launch.mesh.make_host_mesh``; on a one-card machine every
shard sits on the card), ``model = --model-axis`` (clamped to N) and
``data = N // model``, as the reference's ``make_host_mesh(model=...)``
splits its devices:
  PYTHONPATH=src python -m repro_torch.launch.train --arch jamba-v0.1-52b --smoke \
      --steps 3 --batch 4 --seq 32 --shards 8 --model-axis 4 --device cpu
"""
from __future__ import annotations

import argparse

from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.trainer import TrainerConfig, train_with_restart


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--shards", type=int, default=1,
                    help="shards of the data x model mesh (the reference's device count)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises where there is no card), 'cuda:i' or 'cpu'")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.is_encdec or cfg.frontend is not None:
        raise SystemExit(
            f"{args.arch} needs frontend inputs; use examples/train_lm.py for "
            "decoder-only training or the dry-run for this arch"
        )
    opt_cfg = AdamWConfig(lr=args.lr, total_steps=args.steps, warmup_steps=max(args.steps // 20, 1))
    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch)
    tcfg = TrainerConfig(
        steps=args.steps, ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        microbatches=args.microbatches,
    )
    metrics = []
    train_with_restart(
        cfg, opt_cfg, data_cfg, tcfg,
        lambda: make_host_mesh(args.shards, device=args.device, model=args.model_axis),
        metrics_out=metrics,
    )
    if metrics:
        first, last = metrics[0]["loss"], metrics[-1]["loss"]
        print(f"loss {first:.4f} → {last:.4f} over {len(metrics)} steps")


if __name__ == "__main__":
    main()
