"""Selective SSM block for Jamba's Mamba half.

Port of ``repro.models.mamba``: the SSD (Mamba-2-style) formulation — a
scalar decay per head per step, run on the shared chunked engine
(``linear_attention.py``) — with the reference's parameterisation.

Port-only: :func:`mamba_block_apply_tp` and :func:`mamba_block_decode_tp`
run the mixer tensor-parallel over model shards, each shard its own whole
heads, where the reference leaves the split to XLA's partitioner
(``launch/sharded.py``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (
    dense_init,
    gather_heads,
    head_slice,
    rmsnorm,
    rmsnorm_init,
    row_partial,
    tp_columns,
    tp_reduce,
)
from repro_torch.models.linear_attention import (
    LOG_W_MIN,
    chunked_linear_attention,
    linear_attention_decode,
)

Params = Dict[str, Any]


def mamba_block_init(
    gen,
    d_model: int,
    *,
    expand: int = 2,
    d_state: int = 16,
    num_heads: Optional[int] = None,
    dtype=torch.float32,
) -> Params:
    d_inner = expand * d_model
    num_heads = num_heads or mamba_num_heads(d_model, expand)
    dev = gen.device
    return {
        "ln": rmsnorm_init(d_model, dtype, dev),
        "w_in": dense_init(gen, d_model, d_inner, dtype),     # x branch
        "w_gate": dense_init(gen, d_model, d_inner, dtype),   # z gate branch
        "w_B": dense_init(gen, d_model, num_heads * d_state, dtype),
        "w_C": dense_init(gen, d_model, num_heads * d_state, dtype),
        "w_dt": dense_init(gen, d_model, num_heads, dtype),
        "dt_bias": torch.zeros((num_heads,), dtype=dtype, device=dev),
        "A_log": torch.log(torch.arange(1, num_heads + 1, dtype=torch.float32,
                                        device=dev)).to(dtype),
        "D_skip": torch.ones((num_heads,), dtype=dtype, device=dev),
        "w_out": dense_init(gen, d_inner, d_model, dtype),
    }


def mamba_num_heads(d_model: int, expand: int = 2) -> int:
    """The mixer's heads, as ``mamba_block_init`` and the LM lay them out:
    one per 64 inner channels."""
    return max(expand * d_model // 64, 1)


def _ssd(xproj, gate, dt_in, Bproj, Cproj, dt_bias, A_log, num_heads: int, d_state: int):
    """(r=C, k=B·Δ, v=x, log_w=−Δ·A) head tensors and the z gate from the
    input projections of ``num_heads`` heads (their ``x``, gate, step, B and
    C columns) and those heads' ``dt_bias`` and ``A_log``."""
    B_, T, d_inner = xproj.shape
    P = d_inner // num_heads                                   # head value dim
    z = F.silu(gate)
    dt = F.softplus((dt_in + dt_bias).float())                 # [B,T,H]
    A = torch.exp(A_log.float())                               # [H] > 0
    log_w = -dt * A[None, None, :]                             # [B,T,H] ≤ 0
    log_w = torch.clamp(log_w, LOG_W_MIN, -1e-6)
    Bp = Bproj.reshape(B_, T, num_heads, d_state)
    Cp = Cproj.reshape(B_, T, num_heads, d_state)
    v = xproj.reshape(B_, T, num_heads, P)
    # fold Δ into B (Euler discretisation): k = Δ_t · B_t (promotes to f32)
    k = Bp * dt[..., None]
    heads = lambda a: a.permute(0, 2, 1, 3)
    return heads(Cp), heads(k), heads(v), log_w.permute(0, 2, 1), z


def _ssd_tensors(p: Params, xn: torch.Tensor, num_heads: int, d_state: int):
    """Project to (r=C, k=B·Δ, v=x, log_w=−Δ·A) head tensors."""
    xproj = xn @ p["w_in"]                                     # [B,T,d_inner]
    C, k, v, log_w, z = _ssd(xproj, xn @ p["w_gate"], xn @ p["w_dt"], xn @ p["w_B"],
                             xn @ p["w_C"], p["dt_bias"], p["A_log"], num_heads, d_state)
    return C, k, v, log_w, z, xproj


def _gated(C, k, v, log_w, z, xproj, D_skip, S0, chunk: Optional[int]):
    """The scan of the heads of C, k, v, log_w from the state ``S0``, its D
    skip and the z gate: (o·z [B, T, heads·P], final state).  ``chunk``
    None: one token, by the decode recurrence."""
    B_, H, T, P = v.shape
    # expand scalar-per-head decay to the key dim expected by the engine
    log_w_vec = log_w[..., None].expand(k.shape)
    if chunk is None:
        sq = lambda a: a[:, :, 0]
        o, S = linear_attention_decode(sq(C), sq(k), sq(v), sq(log_w_vec), S0, u=None)
        o = o.reshape(B_, 1, H * P)
    else:
        o, S = chunked_linear_attention(C, k, v, log_w_vec, u=None, chunk=chunk,
                                        initial_state=S0)
        o = o.permute(0, 2, 1, 3).reshape(B_, T, H * P)
    o = o + xproj * torch.repeat_interleave(D_skip, P)[None, None, :]  # D skip
    return o * z, S


def _mixer(p: Params, xn, num_heads: int, d_state: int, chunk, S0):
    C, k, v, log_w, z, xproj = _ssd_tensors(p, xn, num_heads, d_state)
    oz, S = _gated(C, k, v, log_w, z, xproj, p["D_skip"], S0, chunk)
    return oz @ p["w_out"], S


def _mixer_tp(p: Params, xn, num_heads: int, d_state: int, chunk, S0):
    """:func:`_mixer` with ``w_in``, ``w_gate``, ``w_B``, ``w_C`` as column
    blocks and ``w_out`` as row blocks, one per model shard, each shard's
    whole heads on its device: ``xn`` goes to each shard once
    (``layers.tp_columns``); the step projection ``xn @ w_dt`` ([.., H], a
    few columns) is computed once on ``xn``'s device, as one device computes
    it; each shard takes its heads' columns of it and its heads' slices of
    ``dt_bias``, ``A_log``, ``D_skip`` and of the state ``S0`` (whole on
    ``xn``'s device), scans its heads, and the row blocks' partial outputs
    are summed on ``xn``'s device (``layers.tp_reduce``).  The new state
    comes back there whole (an all-gather of the shards' heads)."""
    M = len(p["w_in"])
    H = num_heads // M
    dt_all = xn @ p["w_dt"]
    cols = tp_columns(xn, list(zip(p["w_in"], p["w_gate"], p["w_B"], p["w_C"])))
    parts, states = [], []
    for m, (xproj, gate, Bproj, Cproj) in enumerate(cols):
        dev = xproj.device
        own = lambda t, dim=0: head_slice(t, m, H, dev, dim)     # noqa: E731
        C, k, v, log_w, z = _ssd(xproj, gate, own(dt_all, -1), Bproj, Cproj, own(p["dt_bias"]),
                                 own(p["A_log"]), H, d_state)
        oz, S = _gated(C, k, v, log_w, z, xproj, own(p["D_skip"]),
                       None if S0 is None else own(S0, 1), chunk)
        parts.append(row_partial(oz, p["w_out"][m]))
        states.append(S)
    S = None if S0 is None else gather_heads(states, xn.device)
    return tp_reduce(parts, xn.device, xn.dtype), S


def _block(mixer, p: Params, x, num_heads: int, d_state: int, chunk, state):
    xn = rmsnorm(p["ln"], x)
    y, S = mixer(p, xn, num_heads, d_state, chunk, None if state is None else state["S"])
    return x + y, (None if state is None else {"S": S})


def mamba_block_apply(
    p: Params,
    x: torch.Tensor,
    *,
    num_heads: int,
    d_state: int = 16,
    chunk: int = 128,
    state: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    return _block(_mixer, p, x, num_heads, d_state, chunk, state)


def mamba_block_decode(
    p: Params,
    x: torch.Tensor,                  # [B, 1, D]
    state: Dict[str, torch.Tensor],
    *,
    num_heads: int,
    d_state: int = 16,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    return _block(_mixer, p, x, num_heads, d_state, None, state)


def mamba_block_apply_tp(p: Params, x: torch.Tensor, *, num_heads: int, d_state: int = 16,
                         chunk: int = 128, state=None):
    """:func:`mamba_block_apply` with the projections as one block per model
    shard (``launch/sharding.py::tp_dim``): the norm and the residual add on
    ``x``'s device, the heads' work on their shards (:func:`_mixer_tp`)."""
    return _block(_mixer_tp, p, x, num_heads, d_state, chunk, state)


def mamba_block_decode_tp(p: Params, x: torch.Tensor, state, *, num_heads: int,
                          d_state: int = 16):
    """:func:`mamba_block_decode` on model blocks, as :func:`mamba_block_apply_tp`."""
    return _block(_mixer_tp, p, x, num_heads, d_state, None, state)


def mamba_init_state(
    batch: int, d_model: int, *, expand: int = 2, d_state: int = 16,
    num_heads: Optional[int] = None, device=None,
):
    d_inner = expand * d_model
    num_heads = num_heads or mamba_num_heads(d_model, expand)
    P = d_inner // num_heads
    return {"S": torch.zeros((batch, num_heads, d_state, P), dtype=torch.float32,
                             device=device)}
