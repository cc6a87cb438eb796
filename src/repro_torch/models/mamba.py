"""Selective SSM block for Jamba's Mamba half.

Port of ``repro.models.mamba``: the SSD (Mamba-2-style) formulation — a
scalar decay per head per step, run on the shared chunked engine
(``linear_attention.py``) — with the reference's parameterisation.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, rmsnorm, rmsnorm_init
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
    num_heads = num_heads or max(d_inner // 64, 1)
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


def _ssd_tensors(p: Params, xn: torch.Tensor, num_heads: int, d_state: int):
    """Project to (r=C, k=B·Δ, v=x, log_w=−Δ·A) head tensors."""
    B_, T, D = xn.shape
    d_inner = p["w_in"].shape[1]
    P = d_inner // num_heads                                   # head value dim
    xproj = xn @ p["w_in"]                                     # [B,T,d_inner]
    z = F.silu(xn @ p["w_gate"])
    dt = F.softplus((xn @ p["w_dt"] + p["dt_bias"]).float())  # [B,T,H]
    A = torch.exp(p["A_log"].float())                          # [H] > 0
    log_w = -dt * A[None, None, :]                             # [B,T,H] ≤ 0
    log_w = torch.clamp(log_w, LOG_W_MIN, -1e-6)
    Bp = (xn @ p["w_B"]).reshape(B_, T, num_heads, d_state)
    Cp = (xn @ p["w_C"]).reshape(B_, T, num_heads, d_state)
    v = xproj.reshape(B_, T, num_heads, P)
    # fold Δ into B (Euler discretisation): k = Δ_t · B_t (promotes to f32)
    k = Bp * dt[..., None]
    heads = lambda a: a.permute(0, 2, 1, 3)
    return heads(Cp), heads(k), heads(v), log_w.permute(0, 2, 1), z, xproj


def mamba_block_apply(
    p: Params,
    x: torch.Tensor,
    *,
    num_heads: int,
    d_state: int = 16,
    chunk: int = 128,
    state: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    B_, T, D = x.shape
    xn = rmsnorm(p["ln"], x)
    C, k, v, log_w, z, xproj = _ssd_tensors(p, xn, num_heads, d_state)
    # expand scalar-per-head decay to the key dim expected by the engine
    log_w_vec = log_w[..., None].expand(k.shape)
    S0 = state["S"] if state is not None else None
    o, S = chunked_linear_attention(
        C, k, v, log_w_vec, u=None, chunk=chunk, initial_state=S0
    )
    P = v.shape[-1]
    o = o.permute(0, 2, 1, 3).reshape(B_, T, num_heads * P)
    o = o + xproj * torch.repeat_interleave(p["D_skip"], P)[None, None, :]  # D skip
    y = (o * z) @ p["w_out"]
    new_state = {"S": S} if state is not None else None
    return x + y, new_state


def mamba_block_decode(
    p: Params,
    x: torch.Tensor,                  # [B, 1, D]
    state: Dict[str, torch.Tensor],
    *,
    num_heads: int,
    d_state: int = 16,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    B_, _, D = x.shape
    xn = rmsnorm(p["ln"], x)
    C, k, v, log_w, z, xproj = _ssd_tensors(p, xn, num_heads, d_state)
    sq = lambda a: a[:, :, 0]
    log_w_vec = log_w[..., None].expand(k.shape)
    o, S = linear_attention_decode(
        sq(C), sq(k), sq(v), sq(log_w_vec), state["S"], u=None
    )
    P = v.shape[-1]
    o = o.reshape(B_, 1, num_heads * P)
    o = o + xproj * torch.repeat_interleave(p["D_skip"], P)[None, None, :]
    y = (o * z) @ p["w_out"]
    return x + y, {"S": S}


def mamba_init_state(
    batch: int, d_model: int, *, expand: int = 2, d_state: int = 16,
    num_heads: Optional[int] = None, device=None,
):
    d_inner = expand * d_model
    num_heads = num_heads or max(d_inner // 64, 1)
    P = d_inner // num_heads
    return {"S": torch.zeros((batch, num_heads, d_state, P), dtype=torch.float32,
                             device=device)}
