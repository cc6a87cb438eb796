"""Mixture-of-Experts with CSR-format dispatch.

Port of ``repro.models.moe``.  The token→expert
assignment is a sparse matrix: N rows (tokens), E columns (experts), top-k
nonzeros per row.  Its CSC-by-expert form is built the way the paper builds
``row_ptr``: per-expert counts → exclusive cumsum → pointer array; a token's
slot inside its expert's capacity buffer is its rank within the expert's run.
All of it is plain PyTorch on the device, with no host synchronisation.

Two execution paths:
  * ``moe_apply``    — single device;
  * ``moe_apply_ep`` — expert parallelism over a ``model`` mesh axis
                       (``shard_map`` in the reference): each model shard
                       routes its data shard's tokens to its slice of the
                       experts on its own device, and the partial outputs
                       are summed over the model shards in shard order (the
                       reference's psum).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, normal
from repro_torch.util.costs import move

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



def _ep_body(router, w_in, w_gate, w_out, xs, *, E, E_loc, e_start, top_k,
             capacity_factor, slot_loop):
    """One model shard's share of one data shard's tokens ``xs`` [N, D]:
    the reference's ``shard_map`` body up to its psum, on the experts
    ``e_start … e_start + E_loc − 1`` (``w_*`` on the shard's device)."""
    N, D = xs.shape
    logits = xs.float() @ router                              # [N, E] router replicated
    topv, topi = router_top_k(logits, top_k)
    weights = torch.softmax(topv, dim=-1)

    capacity = max(int(N * top_k / E * capacity_factor), min(N * top_k, 16))
    # local plan over my experts + one dummy bin (expert id E_loc) that
    # absorbs other shards' tokens without polluting real capacities
    local_e = topi - e_start
    mine = (local_e >= 0) & (local_e < E_loc)
    dest, keep, _ = csr_dispatch_plan(
        torch.where(mine, torch.clamp(local_e, 0, E_loc - 1), E_loc), E_loc + 1, capacity)
    keep = keep & mine.reshape(-1)
    dest = dest.long()

    buf = torch.zeros(((E_loc + 1) * capacity, D), dtype=xs.dtype, device=xs.device)
    if slot_loop:
        dest_nk = dest.reshape(N, top_k)
        keep_nk = keep.reshape(N, top_k)
        for kk in range(top_k):
            buf.index_add_(0, dest_nk[:, kk], torch.where(keep_nk[:, kk, None], xs, 0.0))
    else:  # baseline replica path
        xr = torch.repeat_interleave(xs, top_k, dim=0)
        buf.index_add_(0, dest, torch.where(keep[:, None], xr, 0.0))
    out_buf = _expert_ffn(
        w_in, w_gate, w_out, buf[: E_loc * capacity].reshape(E_loc, capacity, D)
    ).reshape(E_loc * capacity, D)
    out_buf = torch.cat([out_buf, torch.zeros((capacity, D), dtype=out_buf.dtype,
                                              device=out_buf.device)])
    if slot_loop:
        y = torch.zeros((N, D), dtype=xs.dtype, device=xs.device)
        for kk in range(top_k):
            w_k = (weights[:, kk, None] * keep_nk[:, kk, None]).to(xs.dtype)
            y = y + out_buf[dest_nk[:, kk]] * w_k
    else:
        gathered = out_buf[dest] * (weights.reshape(-1, 1) * keep[:, None]).to(xs.dtype)
        y = gathered.reshape(N, top_k, D).sum(dim=1)
    probs = torch.softmax(logits, dim=-1)
    frac_tokens = torch.zeros((E,), device=xs.device).index_add_(
        0, topi[:, 0], torch.ones((N,), device=xs.device)) / N
    aux = E * torch.sum(frac_tokens * probs.mean(dim=0))
    return y, aux


def _expert_pieces(w, ep: int) -> Sequence[torch.Tensor]:
    """A full [E, …] expert tensor split by views into ``ep`` slices along E
    (``shard_map``'s ``in_specs``), or the ``ep`` pieces given as they are."""
    if isinstance(w, (list, tuple)):
        if len(w) != ep:
            raise ValueError(f"{len(w)} expert pieces for a model axis of {ep}")
        return w
    return torch.chunk(w, ep, dim=0)


def moe_apply_ep(
    params: Params,
    x: torch.Tensor,
    *,
    num_experts: int,
    top_k: int,
    mesh,
    model_axis: str = "model",
    data_axes: Tuple[str, ...] = ("data",),
    capacity_factor: float = 1.25,
    slot_loop: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE: experts sharded over ``model_axis``.

    ``x`` [B, T, D] is split by rows over ``data_axes`` (B must divide by
    their size); the experts ``params["w_in"|"w_gate"|"w_out"]`` over
    ``model_axis``: a full [E, …] tensor is split by views, and a sequence
    of one [E/ep, …] piece per model shard is used as given, each on the
    device it sits on.  Data shard d's rows run on the device of shard
    (d, m) against piece m, with the capacity from the data shard's own
    tokens; the partial outputs are summed over m in shard order (the
    reference's psum) on ``x``'s device, and the per-shard aux is averaged
    over the data shards (its pmean).  A cost counter files the moves of
    the rows, the router and the pieces under all-to-all and those of the
    partial outputs under all-reduce (``util.costs.move``).  Returns
    (output, aux)."""
    E = num_experts
    ep = mesh.shape[model_axis]
    if E % ep != 0:
        raise ValueError(f"experts {E} must divide model axis {ep}")
    E_loc = E // ep
    shards = mesh.coords_over(data_axes)
    dp = len(shards)
    B, T, D = x.shape
    if B % dp != 0:
        raise ValueError(f"batch {B} must divide by the data axes {data_axes} of {dp} shards")
    Bl = B // dp
    pieces = {k: _expert_pieces(params[k], ep) for k in ("w_in", "w_gate", "w_out")}
    ys, auxes = [], []
    for d, coords in enumerate(shards):
        xf = x[d * Bl:(d + 1) * Bl].reshape(Bl * T, D)
        y_d = aux_d = None
        for m in range(ep):
            dev = mesh.device_at(**coords, **{model_axis: m})
            a2a = lambda t: move(t, dev, "all-to-all")
            y, aux = _ep_body(
                a2a(params["router"]), a2a(pieces["w_in"][m]), a2a(pieces["w_gate"][m]),
                a2a(pieces["w_out"][m]), a2a(xf),
                E=E, E_loc=E_loc, e_start=m * E_loc, top_k=top_k,
                capacity_factor=capacity_factor, slot_loop=slot_loop)
            y = move(y, x.device, "all-reduce")
            y_d = y if y_d is None else y_d + y              # psum over model, in order
            if aux_d is None:                                 # equal on every model shard
                aux_d = move(aux, x.device, "all-reduce")
        ys.append(y_d.reshape(Bl, T, D))
        auxes.append(aux_d)
    aux = auxes[0]
    for a in auxes[1:]:
        aux = aux + a
    return (torch.cat(ys, dim=0) if dp > 1 else ys[0]), aux / dp
