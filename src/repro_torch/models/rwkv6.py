"""RWKV-6 "Finch" block: data-dependent decay linear attention (time
mixing) + squared-ReLU channel mixing, with token shift.

Port of ``repro.models.rwkv6``: token-shift interpolation with learned mix
vectors, LoRA-style data-dependent decay ``w = exp(−exp(w0 + lora(x)))``,
per-head bonus ``u``, GroupNorm on the attention output.  The recurrence runs
on the shared chunked engine (``linear_attention.py``); decode carries the
O(1) [B, H, K, V] state and the two token-shift rows ``x_prev_*``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, normal, rmsnorm, rmsnorm_init, uniform
from repro_torch.models.linear_attention import (
    LOG_W_MIN,
    chunked_linear_attention,
    linear_attention_decode,
)

Params = Dict[str, Any]


def rwkv6_block_init(
    gen, d_model: int, num_heads: int, d_ff: int, lora_rank: int = 64, dtype=torch.float32
) -> Params:
    head_dim = d_model // num_heads
    dev = gen.device
    return {
        "ln1": rmsnorm_init(d_model, dtype, dev),
        "ln2": rmsnorm_init(d_model, dtype, dev),
        # token-shift mix coefficients (r, k, v, w, g)
        "mix": (uniform(gen, (5, d_model)) * 0.5 + 0.25).to(dtype),
        "wr": dense_init(gen, d_model, d_model, dtype),
        "wk": dense_init(gen, d_model, d_model, dtype),
        "wv": dense_init(gen, d_model, d_model, dtype),
        "wg": dense_init(gen, d_model, d_model, dtype),
        "wo": dense_init(gen, d_model, d_model, dtype),
        # data-dependent decay: w = exp(-exp(w0 + B(A x)))
        "w0": torch.full((d_model,), -0.6, device=dev).to(dtype),
        "w_lora_a": dense_init(gen, d_model, lora_rank, dtype),
        "w_lora_b": torch.zeros((lora_rank, d_model), dtype=dtype, device=dev),
        "u": normal(gen, (num_heads, head_dim), 0.3, dtype),
        "gn_scale": torch.ones((d_model,), dtype=dtype, device=dev),
        # channel mixing
        "ck": dense_init(gen, d_model, d_ff, dtype),
        "cv": dense_init(gen, d_ff, d_model, dtype),
        "cr": dense_init(gen, d_model, d_model, dtype),
        "cmix": (uniform(gen, (2, d_model)) * 0.5 + 0.25).to(dtype),
    }


def _token_shift(x: torch.Tensor, prev: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x_{t-1} (zero/``prev`` at t=0)."""
    shifted = F.pad(x, (0, 0, 1, 0))[:, :-1]
    if prev is not None:
        shifted = torch.cat([prev[:, None].to(x.dtype), shifted[:, 1:]], dim=1)
    return shifted


def _time_mix_inputs(p: Params, xn: torch.Tensor, shifted: torch.Tensor):
    mix = p["mix"]
    lerp = lambda i: xn + (shifted - xn) * mix[i]
    xr, xk, xv, xw, xg = (lerp(i) for i in range(5))
    r = xr @ p["wr"]
    k = xk @ p["wk"]
    v = xv @ p["wv"]
    g = F.silu(xg @ p["wg"])
    log_w = -torch.exp((p["w0"] + (xw @ p["w_lora_a"]) @ p["w_lora_b"]).float())
    # keep decay sane
    log_w = torch.clamp(log_w, LOG_W_MIN, -1e-4)
    return r, k, v, g, log_w


def _heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    B, T, D = x.shape
    return x.reshape(B, T, num_heads, D // num_heads).permute(0, 2, 1, 3)


def _unheads(x: torch.Tensor) -> torch.Tensor:
    B, H, T, Dh = x.shape
    return x.permute(0, 2, 1, 3).reshape(B, T, H * Dh)


def _group_norm(x: torch.Tensor, scale: torch.Tensor, num_heads: int, eps=1e-5):
    B, T, D = x.shape
    xh = x.reshape(B, T, num_heads, D // num_heads).float()
    mu = xh.mean(dim=-1, keepdim=True)
    var = xh.var(dim=-1, keepdim=True, correction=0)
    return (((xh - mu) * torch.rsqrt(var + eps)).reshape(B, T, D) * scale).to(x.dtype)


def rwkv6_block_apply(
    p: Params,
    x: torch.Tensor,                 # [B, T, D]
    *,
    num_heads: int,
    chunk: int = 128,
    state: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Full-sequence (training/prefill) pass. ``state`` carries (S, x_prev)."""
    xn = rmsnorm(p["ln1"], x)
    prev_x = state["x_prev_att"] if state is not None else None
    shifted = _token_shift(xn, prev_x)
    r, k, v, g, log_w = _time_mix_inputs(p, xn, shifted)
    S0 = state["S"] if state is not None else None
    o, S = chunked_linear_attention(
        _heads(r, num_heads), _heads(k, num_heads), _heads(v, num_heads),
        _heads(log_w, num_heads), u=p["u"], chunk=chunk, initial_state=S0,
    )
    o = _group_norm(_unheads(o), p["gn_scale"], num_heads) * g
    x = x + o @ p["wo"]

    # channel mixing
    xn2 = rmsnorm(p["ln2"], x)
    prev_x2 = state["x_prev_ffn"] if state is not None else None
    shifted2 = _token_shift(xn2, prev_x2)
    xk = xn2 + (shifted2 - xn2) * p["cmix"][0]
    xr = xn2 + (shifted2 - xn2) * p["cmix"][1]
    kk = torch.square(F.relu(xk @ p["ck"]))
    x = x + torch.sigmoid(xr @ p["cr"]) * (kk @ p["cv"])

    new_state = None
    if state is not None:
        new_state = {"S": S, "x_prev_att": xn[:, -1], "x_prev_ffn": xn2[:, -1]}
    return x, new_state


def rwkv6_block_decode(
    p: Params,
    x: torch.Tensor,                 # [B, 1, D]
    state: Dict[str, torch.Tensor],
    *,
    num_heads: int,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode with O(1) state."""
    B, _, D = x.shape
    H = num_heads
    Dh = D // H
    xn = rmsnorm(p["ln1"], x)[:, 0]                            # [B, D]
    shifted = state["x_prev_att"]
    r, k, v, g, log_w = _time_mix_inputs(p, xn[:, None, :], shifted[:, None, :])
    hb = lambda a: a[:, 0].reshape(B, H, Dh)
    o, S = linear_attention_decode(hb(r), hb(k), hb(v), hb(log_w), state["S"], u=p["u"])
    o = o.reshape(B, 1, D)
    o = _group_norm(o, p["gn_scale"], H) * g
    x = x + o @ p["wo"]

    xn2 = rmsnorm(p["ln2"], x)[:, 0]
    shifted2 = state["x_prev_ffn"]
    xk = xn2 + (shifted2 - xn2) * p["cmix"][0]
    xr = xn2 + (shifted2 - xn2) * p["cmix"][1]
    kk = torch.square(F.relu(xk @ p["ck"]))
    x = x + (torch.sigmoid(xr @ p["cr"]) * (kk @ p["cv"]))[:, None, :]

    return x, {"S": S, "x_prev_att": xn, "x_prev_ffn": xn2}


def rwkv6_init_state(batch: int, d_model: int, num_heads: int, dtype=torch.float32,
                     device=None):
    head_dim = d_model // num_heads
    return {
        "S": torch.zeros((batch, num_heads, head_dim, head_dim), dtype=torch.float32,
                         device=device),
        "x_prev_att": torch.zeros((batch, d_model), dtype=dtype, device=device),
        "x_prev_ffn": torch.zeros((batch, d_model), dtype=dtype, device=device),
    }
