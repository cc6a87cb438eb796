"""Serving CLI: drive the :mod:`repro_torch.serve` SpMV engine (or the LM smoke).

Port of ``repro.launch.serve``.  The default mode registers a small
matrix fleet (two regular grid Laplacians and a power-law matrix), replays a
seeded random request stream through the engine's continuous batching +
operator cache, drains, verifies a sample bit for bit against freshly
prepared direct operators, and prints the engine's stats snapshot plus every
``serve.*`` registry record.

On a CUDA card (the default):
  PYTHONPATH=src python -m repro_torch.launch.serve --requests 32 --max-batch 8
On the CPU, through the kernels' plain PyTorch versions:
  PYTHONPATH=src python -m repro_torch.launch.serve --requests 32 --device cpu \
      --device-model tpu_v5e

The single-shot LM generation smoke (one prefill + greedy decode steps
through the KV-cache path, timed through the registry) is behind ``--arch``;
weights and prompts are random, drawn from a seeded generator on the device:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b --smoke \
      --batch 4 --prompt-len 64 --gen 32 --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.obs import get_registry


def _powerlaw(m: int, scale: float = 6.0, seed: int = 3):
    """Power-law nnz/row CSR matrix — the canonical irregular workload
    (the reference CLI's construction, the same numpy draws)."""
    from repro_torch.sparse import COOMatrix, csr_from_coo

    rng = np.random.default_rng(seed)
    lengths = np.minimum((rng.pareto(1.0, m) * scale + 1).astype(int), m)
    rows = np.repeat(np.arange(m), lengths)
    cols = np.concatenate([rng.choice(m, size=L, replace=False) for L in lengths])
    vals = rng.standard_normal(len(rows)).astype(np.float32)
    return csr_from_coo(COOMatrix(
        torch.from_numpy(rows.astype(np.int32)), torch.from_numpy(cols.astype(np.int32)),
        torch.from_numpy(vals), (m, m),
    ))


def run_spmv_serve(args) -> None:
    """Replay a seeded request stream through the serving engine."""
    from repro_torch.configs.spmv_suite import grid_laplacian_2d
    from repro_torch.core.spmv import prepare
    from repro_torch.serve import ServeEngine

    side = max(int(args.scale ** 0.5), 8)
    matrices = {
        "grid_a": grid_laplacian_2d(side, side),
        "grid_b": grid_laplacian_2d(side + 2, side + 2),
        "powerlaw": _powerlaw(max(args.scale, 256)),
    }
    eng = ServeEngine(
        max_batch=args.max_batch,
        max_wait=args.max_wait_ms / 1e3,
        cache_bytes=int(args.cache_mb * (1 << 20)) if args.cache_mb else None,
        device=args.device,
        device_model=args.device_model,
        format="auto",
    )
    for mid, A in matrices.items():
        fp = eng.add_matrix(mid, A)
        print(f"registered {mid}: {A.shape[0]}x{A.shape[1]} "
              f"nnz={A.nnz} fingerprint={fp[:12]}…")

    rng = np.random.default_rng(args.seed)
    mids = list(matrices)
    futs = []
    t0 = time.perf_counter()
    for i in range(args.requests):
        mid = mids[rng.integers(len(mids))]
        n = matrices[mid].n
        width = int(rng.integers(1, 4))
        shape = (n,) if width == 1 else (n, width)
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(eng.device)
        futs.append((mid, x, eng.submit(mid, x)))
        if rng.random() < 0.5:
            eng.step()
    eng.drain()
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    wall = time.perf_counter() - t0

    # spot-check the bit-for-bit contract against direct prepares (same
    # fixed launch width as the engine's operators)
    for mid, x, fut in futs[:: max(len(futs) // 4, 1)]:
        direct = prepare(matrices[mid], args.device_model, device=eng.device,
                         format="auto", spmm_width=args.max_batch)
        assert torch.equal(fut.result(), direct(x)), mid
    print(f"\nserved {len(futs)} requests in {wall:.2f}s "
          f"({len(futs) / max(wall, 1e-9):.1f} req/s) on {eng.device}, "
          f"sample verified bit-identical to direct prepare(A)(x)")
    for k, v in sorted(eng.stats.snapshot().items()):
        print(f"  {k} = {v:.3f}")
    print(f"  cache: hits={eng.cache.hits} misses={eng.cache.misses} "
          f"prepares={eng.cache.prepares} evictions={eng.cache.evictions} "
          f"bytes={eng.cache.bytes_in_use}")
    for r in get_registry().records():
        if r["section"] == "serve" and not r["name"].startswith(
            ("queue_depth.", "latency_ms.", "batch_cols.")
        ):
            print(f"# obs {r['section']}.{r['name']} = "
                  f"{r['value']:.3f} {r['unit']}")


def run_lm_smoke(args) -> None:
    """Single-shot generation smoke: one prefill + greedy decode steps."""
    from repro_torch.configs.registry import get_config, get_smoke_config
    from repro_torch.launch import steps as STEPS
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as TF

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.is_encdec or cfg.frontend is not None:
        raise SystemExit(f"{args.arch}: use examples for frontend archs")
    mesh = make_host_mesh(device=args.device, model=1)
    device = mesh.devices[0]
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    gen = torch.Generator(device=device).manual_seed(0)
    B, P, G = args.batch, args.prompt_len, args.gen
    max_len = P + G

    with torch.inference_mode():
        params = TF.init_params(gen, cfg)
        prompts = torch.randint(0, cfg.vocab, (B, P), generator=gen, device=device)
        cache = TF.init_cache(cfg, B, max_len, device=device)
        decode_step = STEPS.make_decode_step(cfg, mesh)

        reg = get_registry()
        # prefill through the cache path (writes K/V for the prompt)
        sync()
        t0 = time.time()
        with reg.timer("serve", "prefill"):
            logits, cache, _ = TF.forward(params, prompts, cfg, cache=cache, cache_index=0)
            tok = torch.argmax(logits[:, -1:], dim=-1)
            sync()
        t_prefill = time.time() - t0

        out = [tok]
        t0 = time.time()
        for i in range(G - 1):
            t_step = time.perf_counter()
            logits, cache = decode_step(params, cache, tok, P + i)
            tok = torch.argmax(logits[:, -1:], dim=-1)
            if reg.enabled:
                # per-step timing needs a sync point; only pay it when
                # telemetry is on (disabled runs keep async dispatch)
                sync()
                reg.observe("serve", "decode_step_ms",
                            (time.perf_counter() - t_step) * 1e3, unit="ms")
            out.append(tok)
        sync()
        t_decode = time.time() - t0
        reg.gauge("serve", "tokens_per_s",
                  (G - 1) * B / max(t_decode, 1e-9), unit="scalar")

    gen_tokens = torch.cat(out, dim=1)
    print(f"prefill {B}x{P}: {t_prefill*1e3:.1f} ms on {device}")
    print(f"decode {G-1} steps: {t_decode*1e3:.1f} ms "
          f"({(G-1)*B/max(t_decode,1e-9):.1f} tok/s)")
    print("sample tokens:", gen_tokens[0, :16].tolist())
    for r in get_registry().records():
        if r["section"] == "serve":
            print(f"# obs {r['section']}.{r['name']} = {r['value']:.3f} {r['unit']}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="SpMV serving engine CLI (default) or LM generation "
                    "smoke (--arch) of the PyTorch port.",
    )
    ap.add_argument("--requests", type=int, default=32,
                    help="number of requests to replay through the engine")
    ap.add_argument("--scale", type=int, default=576,
                    help="approximate matrix rows (sizes the fleet)")
    ap.add_argument("--max-batch", type=int, default=8,
                    help="column budget per coalesced dispatch")
    ap.add_argument("--max-wait-ms", type=float, default=0.0,
                    help="partial-batch wait before dispatching anyway")
    ap.add_argument("--cache-mb", type=float, default=0.0,
                    help="operator-cache byte budget in MiB (0 = unbounded)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device-model", default="h100",
                    help="the tuner's device model (prepare's device_model)")
    ap.add_argument("--device", default="cuda",
                    help='where it runs: "cuda" (default) or "cpu"')
    # LM smoke mode
    ap.add_argument("--arch", default=None,
                    help="run the single-shot LM generation smoke instead")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    args = ap.parse_args(argv)

    if args.arch is not None:
        run_lm_smoke(args)
    else:
        run_spmv_serve(args)


if __name__ == "__main__":
    main()
