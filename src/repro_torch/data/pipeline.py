"""Deterministic synthetic data pipeline.

Port of ``repro.data.pipeline``.  A seeded, reproducible token stream
(Zipfian unigram draws with repeated n-gram motifs, so the LM loss actually
decreases), chunked into packed [batch, seq] examples.  ``DataConfig`` and
``synthesize_batch`` are the reference's numpy, copied: the same (seed, step)
gives the same tokens bit for bit.  ``global_batch_array`` gives each data
shard of the mesh its rows on its device (the reference's
``make_array_from_callback`` over a batch-sharded spec).

Restart safety: the stream is indexed by (seed, step), so resuming from a
checkpoint at step k regenerates exactly the batches k, k+1, … with no
stored iterator state.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np
import torch

from repro_torch.launch.mesh import ShardMesh, batch_axes, dp_size
from repro_torch.util.sharded import PartitionSpec, Sharded


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    motif_len: int = 16
    motif_prob: float = 0.5


def _batch_rng(cfg: DataConfig, step: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([cfg.seed, step]))


def synthesize_batch(cfg: DataConfig, step: int, rows: slice | None = None) -> np.ndarray:
    """Tokens [rows, seq_len+1]; deterministic in (seed, step)."""
    rng = _batch_rng(cfg, step)
    b = cfg.global_batch
    T = cfg.seq_len + 1
    # Zipf over a capped vocab for sane tails
    zipf_cap = min(cfg.vocab, 50_000)
    toks = rng.zipf(cfg.zipf_a, size=(b, T))
    toks = np.minimum(toks, zipf_cap) - 1
    # inject repeated motifs → learnable structure
    n_motifs = max(int(T // cfg.motif_len * cfg.motif_prob), 1)
    motif = rng.integers(0, zipf_cap, size=(8, cfg.motif_len))
    for i in range(b):
        starts = rng.integers(0, T - cfg.motif_len, size=n_motifs)
        which = rng.integers(0, 8, size=n_motifs)
        for s, w in zip(starts, which):
            toks[i, s : s + cfg.motif_len] = motif[w]
    toks = toks.astype(np.int32)
    if rows is not None:
        toks = toks[rows]
    return toks


def global_batch_array(
    cfg: DataConfig,
    step: int,
    mesh: ShardMesh,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(tokens, labels) [global_batch, seq_len] int32: the batch's rows
    without their last token, and shifted by one.  On a mesh of one data
    shard they are tensors on the mesh's first device; on more, ``Sharded``
    over the batch axes, data shard d holding rows d·B/D … (d+1)·B/D on its
    device (B must divide by D, as the reference's sharding requires)."""
    full = torch.from_numpy(synthesize_batch(cfg, step))
    tokens, labels = full[:, :-1].contiguous(), full[:, 1:].contiguous()
    D = dp_size(mesh)
    if D == 1:
        return tokens.to(mesh.devices[0]), labels.to(mesh.devices[0])
    if cfg.global_batch % D:
        raise ValueError(f"global batch {cfg.global_batch} does not divide over {D} data shards")
    axes = tuple(a for a in batch_axes(mesh) if a in mesh.axis_names)
    spec = PartitionSpec(axes if len(axes) > 1 else axes[0], None)
    return Sharded.from_full(tokens, mesh, spec), Sharded.from_full(labels, mesh, spec)


def batches(cfg: DataConfig, mesh: ShardMesh, start_step: int = 0) -> Iterator:
    step = start_step
    while True:
        yield global_batch_array(cfg, step, mesh)
        step += 1
