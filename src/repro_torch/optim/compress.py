"""Grouped-scale int8 quantization and top-k gradient compression.

Port of ``repro.optim.compress``.  Its numpy half (``INT8_GROUP``,
``quantize_int8_grouped``, ``dequantize_int8_grouped``) is copied so that the
port never imports the reference.  Values are split into fixed-size groups
along the streaming axis; each group stores one f32 scale = max|v|/127 and
int8 codes q = round(v/scale).  The CSR-k tile view quantizes its value
stream with these helpers so the kernel moves 1 byte per nonzero value
instead of 4; accumulation stays f32 (dequantize-then-multiply in-kernel).
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from repro_torch.util.sharded import Sharded, assign_, whole, zeros_f32
from repro_torch.util.tree import leaves, tree_map

Params = Any

INT8_GROUP = 128   # one scale per 128 slots (tile slot counts are 128 multiples)


def quantize_int8_grouped(vals, group: int = INT8_GROUP):
    """Symmetric per-group int8 quantization along the last axis (host-side).

    Args:
      vals: numpy array whose last-axis length is a multiple of ``group``.
      group: values per scale group.

    Returns:
      ``(q, scales)`` — ``q`` int8 with ``vals.shape``; ``scales`` float32
      with the last axis reduced by ``group``.  All-zero groups get scale 1.0
      so dequantization stays exact for padding slots.
    """
    v = np.asarray(vals, np.float32)
    if v.shape[-1] % group:
        raise ValueError(f"last axis {v.shape[-1]} not a multiple of group {group}")
    g = v.reshape(v.shape[:-1] + (v.shape[-1] // group, group))
    amax = np.abs(g).max(axis=-1)
    scales = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    q = np.rint(g / scales[..., None]).clip(-127, 127).astype(np.int8)
    return q.reshape(v.shape), scales


def dequantize_int8_grouped(q, scales, group: int = INT8_GROUP):
    """Inverse of :func:`quantize_int8_grouped` (host-side numpy)."""
    q = np.asarray(q, np.float32)
    s = np.repeat(np.asarray(scales, np.float32), group, axis=-1)
    return q * s


# ---------------------------------------------------------------------------
# top-k gradient compression in CSR format with error feedback
# ---------------------------------------------------------------------------
#
# Port of the rest of ``repro.optim.compress``.  The sparsified gradient of a
# 2-D parameter is a sparse matrix carried in CSR: values + flat indices and a
# row_ptr built by a cumulative count per row, the paper's pointer-array
# construction.  Error feedback keeps the residual locally so the compression
# is unbiased over time.


class CompressionState(NamedTuple):
    residual: Params     # error-feedback memory, same tree as params


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    density: float = 0.01         # fraction of entries kept
    min_size: int = 4096          # tensors smaller than this stay dense


def init(params: Params) -> CompressionState:
    """Zero residuals in the params' layout (pieces where they are
    ``Sharded``)."""
    return CompressionState(residual=tree_map(zeros_f32, params))


def topk_csr(g: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat top-|k| sparsification → (values, int32 flat indices), in
    ``jax.lax.top_k``'s order: largest |g| first, equal magnitudes in
    ascending index order.  ``torch.topk`` fixes no order among ties and may
    pick another set at the k boundary, so it gives only the k-th magnitude
    t: every entry above t is taken, and the lowest-indexed entries equal to
    t fill the rest; a stable descending sort of those k orders them.  No
    sort runs over the whole of ``g``."""
    flat = g.reshape(-1)
    mag = flat.abs()
    t = torch.topk(mag, k, sorted=False).values.min()
    above = torch.nonzero(mag > t).view(-1)
    tied = torch.nonzero(mag == t).view(-1)[: k - above.numel()]
    idx = torch.sort(torch.cat([above, tied])).values
    idx = idx[torch.sort(mag[idx], descending=True, stable=True).indices]
    return flat[idx], idx.to(torch.int32)


def row_ptr_from_indices(idx: torch.Tensor, n_cols: int, n_rows: int) -> torch.Tensor:
    """Rebuild the CSR row_ptr from flat indices (cumsum of per-row counts)."""
    rows = idx.long() // n_cols
    counts = torch.zeros((n_rows,), dtype=torch.int32, device=idx.device)
    counts.index_add_(0, rows, torch.ones_like(rows, dtype=torch.int32))
    return torch.cat([torch.zeros((1,), dtype=torch.int32, device=idx.device),
                      torch.cumsum(counts, 0).to(torch.int32)])


def decompress(vals: torch.Tensor, idx: torch.Tensor, shape) -> torch.Tensor:
    total = int(np.prod(shape))
    out = torch.zeros((total,), dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, idx.long(), vals).reshape(shape)


@torch.no_grad()
def compress_grads(
    cfg: CompressionConfig,
    grads: Params,
    state: CompressionState,
    *,
    axis_name: str | None = None,
    groups: Sequence[Sequence[int]] | None = None,
) -> Tuple[Params, CompressionState, dict]:
    """Error-feedback top-k: returns (grads, new state, metrics).

    ``groups`` lists the leaves (by walk position) that are compressed as
    one tensor, concatenated flat in the order given: the port keeps one
    tensor per layer where the reference stacks all layers into one leaf,
    so a group is the layers of one reference stack in stack order
    (``launch.steps.stacked_leaf_groups``), and ``min_size``, k and the
    bytes counted are the stack's.  None compresses each leaf alone.

    The residual is updated in place (at full width the f32 residual is as
    large as the f32 moments), and returned.  A ``util.sharded.Sharded``
    leaf (the sharded train step's averaged gradients and residual) is
    gathered whole for its group's top-k, and the sparse gradient and the
    residual are cut back into its pieces.

    With ``axis_name`` (a data-parallel axis) ``grads`` and ``state`` are
    sequences, one per shard along that axis in shard order, and so are
    the grads and states returned: each shard gets what the reference's
    ``shard_map`` body gives it, the mean over the shards (summed in shard
    order, in float32) of their sparse gradients, and its own residual; a
    group under ``min_size`` stays the shard's own dense gradient, as in the
    reference.  The metrics are shard 0's (every shard's are equal)."""
    if axis_name is not None:
        return _compress_over_shards(cfg, grads, state, groups)
    sparse, metrics = _compress_local(cfg, grads, state, groups)
    new_grads = list(leaves(grads))
    for i, t in sparse.items():
        g = new_grads[i]
        new_grads[i] = g.assign_(t) if isinstance(g, Sharded) else t.to(g.dtype)
    it = iter(new_grads)
    return tree_map(lambda _: next(it), grads), state, metrics


def _compress_local(cfg, grads, state, groups):
    """One shard's top-k with error feedback: ({leaf: its float32 sparse
    gradient} for the compressed groups, metrics); the residual is updated
    in place."""
    flat_g, flat_r = leaves(grads), leaves(state.residual)
    if groups is None:
        groups = [[i] for i in range(len(flat_g))]
    sent_bytes = 0
    dense_bytes = 0
    sparse_out = {}
    for group in groups:
        gs, rs = [whole(flat_g[i]) for i in group], [whole(flat_r[i]) for i in group]
        size = sum(g.numel() for g in gs)
        dense_bytes += size * 4
        if size < cfg.min_size:
            sent_bytes += size * 4
            continue
        acc = torch.cat([(r + g.to(torch.float32)).reshape(-1) for g, r in zip(gs, rs)])
        k = max(int(size * cfg.density), 1)
        vals, idx = topk_csr(acc, k)
        sparse = decompress(vals, idx, (size,))
        acc.index_add_(0, idx.long(), -vals)             # acc − sparse, nonzero only at idx
        start = 0
        for i, g in zip(group, gs):
            n = g.numel()
            sparse_out[i] = sparse[start:start + n].view(g.shape)
            assign_(flat_r[i], acc[start:start + n].view(g.shape))
            start += n
        sent_bytes += k * 8   # 4B value + 4B index
    return sparse_out, {"compress_ratio": sent_bytes / max(dense_bytes, 1)}


def _compress_over_shards(cfg, grads_by_shard, states, groups):
    """The ``axis_name`` form of :func:`compress_grads`: the reference's
    ``psum(sparse) / psum(1)`` as a sum over the shards in shard order."""
    local = [_compress_local(cfg, g, s, groups) for g, s in zip(grads_by_shard, states)]
    n = len(local)
    out = []
    for d, grads in enumerate(grads_by_shard):
        flat = list(leaves(grads))
        for i in local[0][0]:
            dev = flat[i].device
            total = local[0][0][i].to(dev)
            for sp, _ in local[1:]:
                total = total + sp[i].to(dev)
            flat[i] = (total / torch.tensor(float(n), device=dev)).to(flat[i].dtype)
        it = iter(flat)
        out.append(tree_map(lambda _: next(it), grads))
    return out, list(states), local[0][1]
