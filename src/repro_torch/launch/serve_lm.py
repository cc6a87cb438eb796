"""Serve a small model with batched requests: prefill + cached decode.

    PYTHONPATH=src python -m repro_torch.launch.serve_lm [--batch 8 --prompt-len 64
        --gen 48] [--device cuda|cpu]

Port of ``examples/serve_lm.py``: qwen2-7b's smoke config widened to 4
layers × 256, random weights from a seeded generator on the device, one
prefill through the cache path, then greedy decode steps, each writing its
K/V into the cache in place.  It runs on the card unless ``--device cpu``
is given, and raises where CUDA is asked for and absent.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import torch

from repro_torch.configs.registry import get_smoke_config
from repro_torch.launch import steps as STEPS
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import transformer as TF


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8, help="batched requests")
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=48, help="tokens generated a request")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = dataclasses.replace(
        get_smoke_config("qwen2-7b"), layers=4, d_model=256, num_heads=8,
        kv_heads=4, d_ff=512, vocab=4096,
    )
    device = make_host_mesh(device=args.device, model=1).devices[0]
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    gen = torch.Generator(device=device).manual_seed(0)
    B, P, G = args.batch, args.prompt_len, args.gen
    max_len = P + G

    with torch.inference_mode():
        params = TF.init_params(gen, cfg)
        prompts = torch.randint(0, cfg.vocab, (B, P), generator=gen, device=device)
        cache = TF.init_cache(cfg, B, max_len, device=device)
        decode = STEPS.make_decode_step(cfg)

        sync()
        t0 = time.perf_counter()
        logits, cache, _ = TF.forward(params, prompts, cfg, cache=cache, cache_index=0)
        tok = torch.argmax(logits[:, -1:], dim=-1)
        sync()
        print(f"prefill {B}×{P}: {(time.perf_counter() - t0) * 1e3:.0f} ms on {device}")

        t0 = time.perf_counter()
        toks = [tok]
        for i in range(G - 1):
            logits, cache = decode(params, cache, tok, P + i)
            tok = torch.argmax(logits[:, -1:], dim=-1)
            toks.append(tok)
        sync()
        dt = time.perf_counter() - t0
    print(f"decode {G - 1} steps: {dt * 1e3:.0f} ms → {(G - 1) * B / dt:.0f} tok/s")
    print("first request's continuation:", torch.cat(toks, 1)[0, :12].tolist())
    return 0


if __name__ == "__main__":
    sys.exit(main())
