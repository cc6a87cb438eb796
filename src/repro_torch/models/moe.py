"""Mixture-of-Experts with CSR-format dispatch.

Port of ``repro.models.moe`` (single-device path).  The token→expert
assignment is a sparse matrix: N rows (tokens), E columns (experts), top-k
nonzeros per row.  Its CSC-by-expert form is built the way the paper builds
``row_ptr``: per-expert counts → exclusive cumsum → pointer array; a token's
slot inside its expert's capacity buffer is its rank within the expert's run.
All of it is plain PyTorch on the device, with no host synchronisation.

``moe_apply_ep`` (expert parallelism over a ``model`` mesh axis) is not
ported here; it comes with the port of ``launch/sharding.py``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, normal

Params = Dict[str, Any]


def moe_init(
    gen,
    d_model: int,
    d_ff: int,
    num_experts: int,
    dtype=torch.float32,
) -> Params:
    scale_in = 1.0 / math.sqrt(d_model)
    scale_out = 1.0 / math.sqrt(d_ff)
    return {
        "router": dense_init(gen, d_model, num_experts, torch.float32),
        "w_in": normal(gen, (num_experts, d_model, d_ff), scale_in, dtype),
        "w_gate": normal(gen, (num_experts, d_model, d_ff), scale_in, dtype),
        "w_out": normal(gen, (num_experts, d_ff, d_model), scale_out, dtype),
    }


def router_top_k(logits: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` on the last axis: the k largest, equal values in
    ascending index order (a stable descending sort), on any device."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def csr_dispatch_plan(
    expert_idx: torch.Tensor,  # [N, K] integer
    num_experts: int,
    capacity: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Build the CSR-style dispatch plan.

    Returns (dest, keep, row_ptr), int32/bool as in the reference:
      dest    [N*K]  flat slot = e * capacity + rank-within-expert
      keep    [N*K]  bool, False for tokens over capacity
      row_ptr [E+1]  the paper's pointer array over the expert dimension
    """
    e = expert_idx.reshape(-1).long()                              # [NK]
    NK = e.shape[0]
    dev = e.device
    counts = torch.zeros((num_experts,), dtype=torch.int32, device=dev)
    counts.index_add_(0, e, torch.ones((NK,), dtype=torch.int32, device=dev))
    row_ptr = torch.cat([torch.zeros((1,), dtype=torch.int32, device=dev),
                         torch.cumsum(counts, 0).to(torch.int32)])
    # rank within expert: stable sort by expert id, position − run start
    order = torch.argsort(e, stable=True)
    sorted_e = e[order]
    rank_sorted = torch.arange(NK, dtype=torch.int32, device=dev) - row_ptr[sorted_e]
    rank = torch.zeros((NK,), dtype=torch.int32, device=dev).scatter_(0, order, rank_sorted)
    keep = rank < capacity
    dest = (e * capacity + torch.clamp(rank, max=capacity - 1)).to(torch.int32)
    return dest, keep, row_ptr


def _expert_ffn(w_in, w_gate, w_out, xs):
    """xs: [E, C, D] → [E, C, D] (batched expert MLP)."""
    h = torch.bmm(xs, w_in)
    g = F.silu(torch.bmm(xs, w_gate))
    return torch.bmm(h * g, w_out)


def moe_apply(
    params: Params,
    x: torch.Tensor,               # [B, T, D]
    *,
    num_experts: int,
    top_k: int,
    capacity_factor: float = 1.25,
    router_softmax_after_topk: bool = True,
    slot_loop: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-device MoE. Returns (output, aux_loss)."""
    B, T, D = x.shape
    N = B * T
    xf = x.reshape(N, D)
    logits = xf.float() @ params["router"]                        # [N, E]
    topv, topi = router_top_k(logits, top_k)                     # [N, K]
    if router_softmax_after_topk:
        weights = torch.softmax(topv, dim=-1)
    else:
        weights = torch.gather(torch.softmax(logits, dim=-1), -1, topi)

    # floor for tiny N (decode steps): avoid dropping tokens that a larger
    # batch would keep — keeps decode consistent with the full forward
    capacity = max(int(N * top_k / num_experts * capacity_factor), min(N * top_k, 16))
    dest, keep, _ = csr_dispatch_plan(topi, num_experts, capacity)
    dest = dest.long()

    # scatter/gather per routing slot k: no [N·K, D] token-replica tensor
    buf = torch.zeros((num_experts * capacity, D), dtype=x.dtype, device=x.device)
    if slot_loop:
        dest_nk = dest.reshape(N, top_k)
        keep_nk = keep.reshape(N, top_k)
        for kk in range(top_k):
            buf.index_add_(0, dest_nk[:, kk], torch.where(keep_nk[:, kk, None], xf, 0.0))
    else:  # baseline: materialise the [N·K, D] token-replica tensor
        xr = torch.repeat_interleave(xf, top_k, dim=0)
        buf.index_add_(0, dest, torch.where(keep[:, None], xr, 0.0))
    out_buf = _expert_ffn(
        params["w_in"], params["w_gate"], params["w_out"],
        buf.reshape(num_experts, capacity, D),
    ).reshape(num_experts * capacity, D)

    if slot_loop:
        y = torch.zeros((N, D), dtype=x.dtype, device=x.device)
        for kk in range(top_k):
            w_k = (weights[:, kk, None] * keep_nk[:, kk, None]).to(x.dtype)
            y = y + out_buf[dest_nk[:, kk]] * w_k
        y = y.reshape(B, T, D)
    else:
        gathered = out_buf[dest] * (weights.reshape(-1, 1) * keep[:, None]).to(x.dtype)
        y = gathered.reshape(N, top_k, D).sum(dim=1).reshape(B, T, D)

    # load-balance aux loss (Switch-style)
    probs = torch.softmax(logits, dim=-1)
    frac_tokens = torch.zeros((num_experts,), device=x.device).index_add_(
        0, topi[:, 0], torch.ones((N,), device=x.device)) / N
    frac_probs = probs.mean(dim=0)
    aux = num_experts * torch.sum(frac_tokens * frac_probs)
    return y, aux

