"""RWKV-6 "Finch" block: data-dependent decay linear attention (time
mixing) + squared-ReLU channel mixing, with token shift.

Port of ``repro.models.rwkv6``: token-shift interpolation with learned mix
vectors, LoRA-style data-dependent decay ``w = exp(−exp(w0 + lora(x)))``,
per-head bonus ``u``, GroupNorm on the attention output.  The recurrence runs
on the shared chunked engine (``linear_attention.py``); decode carries the
O(1) [B, H, K, V] state and the two token-shift rows ``x_prev_*``.

Port-only: :func:`rwkv6_block_apply_tp` and :func:`rwkv6_block_decode_tp`
run the time mix over model shards, each its own whole heads, and the
channel mix over each shard's slice of the ffn, where the reference leaves
the split to XLA's partitioner (``launch/sharded.py``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (
    dense_init,
    gather_heads,
    head_slice,
    is_tp,
    normal,
    rmsnorm,
    rmsnorm_init,
    row_partial,
    tp_columns,
    tp_reduce,
    uniform,
)
from repro_torch.models.linear_attention import (
    LOG_W_MIN,
    chunked_linear_attention,
    linear_attention_decode,
)
from repro_torch.util.costs import move

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


def _decay(p: Params, xw: torch.Tensor) -> torch.Tensor:
    """The data-dependent log decay, float32, from all of d_model."""
    log_w = -torch.exp((p["w0"] + (xw @ p["w_lora_a"]) @ p["w_lora_b"]).float())
    # keep decay sane
    return torch.clamp(log_w, LOG_W_MIN, -1e-4)


def _lerps(mix: torch.Tensor, xn: torch.Tensor, shifted: torch.Tensor):
    """The token-shift interpolations of ``xn`` towards ``shifted``, one per
    row of ``mix``."""
    return [xn + (shifted - xn) * mix[i] for i in range(mix.shape[0])]


def _time_mix_inputs(p: Params, xn: torch.Tensor, shifted: torch.Tensor):
    xr, xk, xv, xw, xg = _lerps(p["mix"], xn, shifted)
    r = xr @ p["wr"]
    k = xk @ p["wk"]
    v = xv @ p["wv"]
    g = F.silu(xg @ p["wg"])
    return r, k, v, g, _decay(p, xw)


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


def _attend(r, k, v, log_w, g, u, gn_scale, S0, num_heads: int, chunk):
    """The recurrence of ``num_heads`` heads of r, k, v, log_w ([B, T, heads
    × head_dim] each) with bonus ``u`` from the state ``S0``, group-normed
    and gated by ``g``: (output [B, T, heads × head_dim], final state).
    ``chunk`` None: one token, by the decode recurrence."""
    B, T, D = r.shape
    if chunk is None:
        hb = lambda a: a[:, 0].reshape(B, num_heads, D // num_heads)
        o, S = linear_attention_decode(hb(r), hb(k), hb(v), hb(log_w), S0, u=u)
        o = o.reshape(B, 1, D)
    else:
        o, S = chunked_linear_attention(
            _heads(r, num_heads), _heads(k, num_heads), _heads(v, num_heads),
            _heads(log_w, num_heads), u=u, chunk=chunk, initial_state=S0,
        )
        o = _unheads(o)
    return _group_norm(o, gn_scale, num_heads) * g, S


def _time_mix(p: Params, xn, shifted, num_heads: int, chunk, S0):
    r, k, v, g, log_w = _time_mix_inputs(p, xn, shifted)
    o, S = _attend(r, k, v, log_w, g, p["u"], p["gn_scale"], S0, num_heads, chunk)
    return o @ p["wo"], S


def _time_mix_tp(p: Params, xn, shifted, num_heads: int, chunk, S0):
    """:func:`_time_mix` with ``wr``, ``wk``, ``wv``, ``wg`` as column blocks
    and ``wo`` as row blocks, one per model shard, each shard's whole heads
    on its device.  The token-shift lerps and the decay ``log_w`` are
    computed once on ``xn``'s device; each lerp goes to each shard once
    (``layers.tp_columns``), and each shard takes its heads' columns of
    ``log_w`` and its heads' slices of ``u``, ``gn_scale`` and the state
    ``S0``, runs the recurrence and the group norm over its heads, and
    multiplies its row block; the partial outputs are summed on ``xn``'s
    device (``layers.tp_reduce``), where the new state comes back whole."""
    xr, xk, xv, xw, xg = _lerps(p["mix"], xn, shifted)
    log_w = _decay(p, xw)
    M = len(p["wr"])
    H, D = num_heads // M, xn.shape[-1] // M
    r, k, v, g = ([c for (c,) in tp_columns(a, [(w,) for w in p[n]])]
                  for a, n in ((xr, "wr"), (xk, "wk"), (xv, "wv"), (xg, "wg")))
    parts, states = [], []
    for m in range(M):
        dev = r[m].device
        o, S = _attend(r[m], k[m], v[m], head_slice(log_w, m, D, dev, -1), F.silu(g[m]),
                       head_slice(p["u"], m, H, dev), head_slice(p["gn_scale"], m, D, dev),
                       None if S0 is None else head_slice(S0, m, H, dev, 1), H, chunk)
        parts.append(row_partial(o, p["wo"][m]))
        states.append(S)
    S = None if S0 is None else gather_heads(states, xn.device)
    return tp_reduce(parts, xn.device, xn.dtype), S


def _channel_mix(p: Params, xn2, shifted2):
    xk, xr = _lerps(p["cmix"], xn2, shifted2)
    kk = torch.square(F.relu(xk @ p["ck"]))
    return torch.sigmoid(xr @ p["cr"]) * (kk @ p["cv"])


def _channel_mix_tp(p: Params, xn2, shifted2):
    """:func:`_channel_mix` with ``ck`` and ``cr`` as column blocks and
    ``cv`` as row blocks, one per model shard: ``kk @ cv``'s partial sums
    and the receptance ``sigmoid(xr @ cr)`` of each shard's columns
    (concatenated, an all-gather) meet on ``xn2``'s device, where their
    product is taken."""
    xk, xr = _lerps(p["cmix"], xn2, shifted2)
    kk = tp_columns(xk, [(w,) for w in p["ck"]])
    parts = [row_partial(torch.square(F.relu(h)), w) for (h,), w in zip(kk, p["cv"])]
    rec = [move(torch.sigmoid(h), xn2.device, "all-gather", "reduce-scatter")
           for (h,) in tp_columns(xr, [(w,) for w in p["cr"]])]
    return torch.cat(rec, dim=-1) * tp_reduce(parts, xn2.device, xn2.dtype)


def _block(p: Params, x, num_heads: int, chunk, state, tp: bool):
    """The block over x [B, T, D] (``chunk`` None: one token, ``state``
    given); with ``tp`` each half runs tensor-parallel where its leaves come
    as model blocks."""
    time_mix = _time_mix_tp if tp and is_tp(p["wr"]) else _time_mix
    channel_mix = _channel_mix_tp if tp and is_tp(p["ck"]) else _channel_mix
    xn = rmsnorm(p["ln1"], x)
    if chunk is None:
        shifted = state["x_prev_att"][:, None, :]
    else:
        shifted = _token_shift(xn, state["x_prev_att"] if state is not None else None)
    y, S = time_mix(p, xn, shifted, num_heads, chunk, None if state is None else state["S"])
    x = x + y

    # channel mixing (of the token alone in a decode step, as [B, D])
    xn2 = rmsnorm(p["ln2"], x)
    if chunk is None:
        xn2 = xn2[:, 0]
        x = x + channel_mix(p, xn2, state["x_prev_ffn"])[:, None, :]
    else:
        shifted2 = _token_shift(xn2, state["x_prev_ffn"] if state is not None else None)
        x = x + channel_mix(p, xn2, shifted2)
        xn2 = xn2[:, -1]
    if state is None:
        return x, None
    return x, {"S": S, "x_prev_att": xn[:, -1], "x_prev_ffn": xn2}


def rwkv6_block_apply(
    p: Params,
    x: torch.Tensor,                 # [B, T, D]
    *,
    num_heads: int,
    chunk: int = 128,
    state: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Full-sequence (training/prefill) pass. ``state`` carries (S, x_prev)."""
    return _block(p, x, num_heads, chunk, state, tp=False)


def rwkv6_block_decode(
    p: Params,
    x: torch.Tensor,                 # [B, 1, D]
    state: Dict[str, torch.Tensor],
    *,
    num_heads: int,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode with O(1) state."""
    return _block(p, x, num_heads, None, state, tp=False)


def rwkv6_block_apply_tp(p: Params, x: torch.Tensor, *, num_heads: int, chunk: int = 128,
                         state=None):
    """:func:`rwkv6_block_apply` with the time mix's and the channel mix's
    projections as one block per model shard where ``launch/sharding.py::
    tp_dim`` splits them (each half on its own condition: a half whose
    leaves come whole runs whole on ``x``'s device); the norms, token
    shifts and residual adds on ``x``'s device."""
    return _block(p, x, num_heads, chunk, state, tp=True)


def rwkv6_block_decode_tp(p: Params, x: torch.Tensor, state, *, num_heads: int):
    """:func:`rwkv6_block_decode` on model blocks, as :func:`rwkv6_block_apply_tp`."""
    return _block(p, x, num_heads, None, state, tp=True)


def rwkv6_init_state(batch: int, d_model: int, num_heads: int, dtype=torch.float32,
                     device=None):
    head_dim = d_model // num_heads
    return {
        "S": torch.zeros((batch, num_heads, head_dim, head_dim), dtype=torch.float32,
                         device=device),
        "x_prev_att": torch.zeros((batch, d_model), dtype=dtype, device=device),
        "x_prev_ffn": torch.zeros((batch, d_model), dtype=dtype, device=device),
    }
