"""Shared neural layers: norms, RoPE, GQA attention (flash-style), MLPs.

Port of ``repro.models.layers``.  Functional style as in the reference: every
layer is ``*_init(gen, ...) -> params`` (a seeded ``torch.Generator`` takes
the place of the PRNG key; the tensors land on the generator's device) plus a
plain ``apply`` function over a dict of tensors.

Attention is the reference's chunked online-softmax ("flash") loop over KV
blocks in plain PyTorch ops, with the running max and denominator in float32
— no [T, T] score tensor and no library attention, so the port keeps the
reference's numerics.  The decode fast path is a separate masked softmax over
the whole cache (``_decode_attention``), as in the reference.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, Any]

DEFAULT_KV_CHUNK = 1024


def param_dtype(name: str) -> torch.dtype:
    """``ModelConfig.dtype`` ("bfloat16", "float32") as a torch dtype."""
    return getattr(torch, name)


# ---------------------------------------------------------------------------
# initialisers
# ---------------------------------------------------------------------------


def normal(gen: torch.Generator, shape, scale: float = 1.0, dtype=torch.float32) -> torch.Tensor:
    """Standard normal draws from ``gen`` (float32), scaled, then cast."""
    out = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return out.mul_(scale).to(dtype)


def uniform(gen: torch.Generator, shape, dtype=torch.float32) -> torch.Tensor:
    """Uniform [0, 1) draws from ``gen`` (float32), then cast."""
    return torch.rand(shape, generator=gen, device=gen.device, dtype=torch.float32).to(dtype)


def dense_init(gen, in_dim: int, out_dim: int, dtype=torch.float32) -> torch.Tensor:
    return normal(gen, (in_dim, out_dim), 1.0 / math.sqrt(in_dim), dtype)


def embed_init(gen, vocab: int, dim: int, dtype=torch.float32) -> torch.Tensor:
    return normal(gen, (vocab, dim), 0.02, dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rmsnorm_init(dim: int, dtype=torch.float32, device=None) -> Params:
    return {"scale": torch.ones((dim,), dtype=dtype, device=device)}


def rmsnorm(params: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    # normalised in f32, cast back to x's dtype, and only then scaled
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * params["scale"]


def layernorm_init(dim: int, dtype=torch.float32, device=None) -> Params:
    return {"scale": torch.ones((dim,), dtype=dtype, device=device),
            "bias": torch.zeros((dim,), dtype=dtype, device=device)}


def layernorm(params: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * params["scale"] + params["bias"]


# ---------------------------------------------------------------------------
# rotary position embedding
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """x: [..., T, H, Dh]; positions: [..., T].  Half-split halves, f32 angles."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, device=x.device)                      # [Dh/2]
    angles = positions[..., :, None, None].float() * freqs               # [..., T, 1, Dh/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------


def attention_init(
    gen,
    d_model: int,
    num_heads: int,
    kv_heads: int,
    head_dim: int,
    qkv_bias: bool = False,
    dtype=torch.float32,
) -> Params:
    p: Params = {
        "wq": dense_init(gen, d_model, num_heads * head_dim, dtype),
        "wk": dense_init(gen, d_model, kv_heads * head_dim, dtype),
        "wv": dense_init(gen, d_model, kv_heads * head_dim, dtype),
        "wo": dense_init(gen, num_heads * head_dim, d_model, dtype),
    }
    if qkv_bias:
        dev = gen.device
        p["bq"] = torch.zeros((num_heads * head_dim,), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((kv_heads * head_dim,), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((kv_heads * head_dim,), dtype=dtype, device=dev)
    return p


def _repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    """[B, T, Hkv, Dh] → [B, T, Hkv*groups, Dh] (GQA broadcast)."""
    if groups == 1:
        return k
    b, t, h, d = k.shape
    return k[:, :, :, None, :].expand(b, t, h, groups, d).reshape(b, t, h * groups, d)


def flash_attention(
    q: torch.Tensor,            # [B, Tq, H, Dh]
    k: torch.Tensor,            # [B, Tk, H, Dh]
    v: torch.Tensor,            # [B, Tk, H, Dh]
    *,
    causal: bool = True,
    q_offset=0,
    kv_chunk: int = DEFAULT_KV_CHUNK,
    kv_valid_len=None,
) -> torch.Tensor:
    """Chunked online-softmax attention (no [Tq, Tk] materialisation).

    ``q_offset`` is the absolute position of q[0] (for causal masking of
    decode steps). ``kv_valid_len`` masks cache padding during decode.
    """
    B, Tq, H, Dh = q.shape
    Tk = k.shape[1]
    dev = q.device
    scale = 1.0 / math.sqrt(Dh)
    q32 = q.float() * scale
    kv_chunk = min(kv_chunk, Tk)
    num_chunks = -(-Tk // kv_chunk)
    Tk_pad = num_chunks * kv_chunk
    if Tk_pad != Tk:
        k = F.pad(k, (0, 0, 0, 0, 0, Tk_pad - Tk))
        v = F.pad(v, (0, 0, 0, 0, 0, Tk_pad - Tk))

    q_pos = q_offset + torch.arange(Tq, device=dev)
    valid_len = Tk if kv_valid_len is None else kv_valid_len
    m = torch.full((B, H, Tq), -math.inf, device=dev)
    l = torch.zeros((B, H, Tq), device=dev)
    acc = torch.zeros((B, H, Tq, Dh), device=dev)
    for c in range(num_chunks):
        kb = k[:, c * kv_chunk:(c + 1) * kv_chunk].float()
        vb = v[:, c * kv_chunk:(c + 1) * kv_chunk].float()
        kv_pos = c * kv_chunk + torch.arange(kv_chunk, device=dev)
        s = torch.einsum("bqhd,bkhd->bhqk", q32, kb)              # [B, H, Tq, C]
        mask = kv_pos[None, :] < valid_len
        if causal:
            mask = mask & (kv_pos[None, :] <= q_pos[:, None])
        s = torch.where(mask, s, -math.inf)
        m_new = torch.maximum(m, s.amax(dim=-1))
        # guard fully-masked blocks
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(s - m_safe[..., None])
        p = torch.where(mask, p, 0.0)
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vb)
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.transpose(1, 2).to(q.dtype)                          # [B, Tq, H, Dh]


def _decode_attention(
    q: torch.Tensor,          # [B, 1, H, Dh]
    k: torch.Tensor,          # [B, S, Hkv, Dh]
    v: torch.Tensor,          # [B, S, Hkv, Dh]
    groups: int,
    valid_len,
) -> torch.Tensor:
    """Single-token attention over the full cache (no chunk loop)."""
    B, S, Hkv, Dh = k.shape
    scale = 1.0 / math.sqrt(Dh)
    qg = q.reshape(B, Hkv, groups, Dh).float() * scale
    s = torch.einsum("bhgd,bshd->bhgs", qg, k.float())
    mask = torch.arange(S, device=q.device) < valid_len
    s = torch.where(mask, s, -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p, v.float())
    return out.reshape(B, 1, Hkv * groups, Dh).to(q.dtype)


def cache_write_start(cache_index: int, T: int, max_len: int) -> int:
    """Start row of a T-row cache write at ``cache_index``, clamped into
    [0, max_len - T] as ``jax.lax.dynamic_update_slice`` clamps it."""
    return min(max(cache_index, 0), max_len - T)


def attention_apply(
    params: Params,
    x: torch.Tensor,                    # [B, T, D]
    *,
    num_heads: int,
    kv_heads: int,
    head_dim: int,
    positions: torch.Tensor,
    rope_theta: float = 10000.0,
    causal: bool = True,
    cache: Optional[Dict[str, torch.Tensor]] = None,
    cache_index: Optional[int] = None,
    kv_chunk: int = DEFAULT_KV_CHUNK,
    decode_fastpath: bool = True,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """GQA attention. With ``cache`` given, runs a decode/prefill cache update.

    The new K/V rows are written into ``cache``'s tensors in place (the
    reference donates the cache to its decode step) and the same tensors are
    returned.  ``cache_index`` is a Python int; a tensor is read to the host.
    """
    B, T, D = x.shape
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if "bq" in params:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    q = q.reshape(B, T, num_heads, head_dim)
    k = k.reshape(B, T, kv_heads, head_dim)
    v = v.reshape(B, T, kv_heads, head_dim)
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)

    groups = num_heads // kv_heads
    new_cache = None
    if cache is not None:
        # write new kv at cache_index, attend over the whole (masked) cache
        idx = int(cache_index) if cache_index is not None else 0
        ck, cv = cache["k"], cache["v"]
        start = cache_write_start(idx, T, ck.shape[1])
        ck[:, start:start + T] = k.to(ck.dtype)
        cv[:, start:start + T] = v.to(cv.dtype)
        new_cache = {"k": ck, "v": cv}
        valid = idx + T
        if T == 1 and decode_fastpath:
            out = _decode_attention(q, ck, cv, groups, valid)
        else:
            out = flash_attention(
                q, _repeat_kv(ck, groups), _repeat_kv(cv, groups),
                causal=causal, q_offset=idx, kv_chunk=kv_chunk, kv_valid_len=valid,
            )
    else:
        out = flash_attention(
            q, _repeat_kv(k, groups), _repeat_kv(v, groups),
            causal=causal, kv_chunk=kv_chunk,
        )
    out = out.reshape(B, T, num_heads * head_dim) @ params["wo"]
    return out, new_cache


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def mlp_init(gen, d_model: int, d_ff: int, gated: bool = True, dtype=torch.float32) -> Params:
    w_in = dense_init(gen, d_model, d_ff, dtype)
    w_gate = dense_init(gen, d_model, d_ff, dtype) if gated else None
    p = {"w_in": w_in, "w_out": dense_init(gen, d_ff, d_model, dtype)}
    if gated:
        p["w_gate"] = w_gate
    return p


def mlp_apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    h = x @ params["w_in"]
    if "w_gate" in params:
        h = F.silu(x @ params["w_gate"]) * h
    else:
        h = F.gelu(h, approximate="tanh")      # jax.nn.gelu's default form
    return h @ params["w_out"]


# ---------------------------------------------------------------------------
# embedding / unembedding
# ---------------------------------------------------------------------------


def unembed(x: torch.Tensor, embedding: torch.Tensor) -> torch.Tensor:
    """Tied unembedding: [B, T, D] × [V, D]^T → logits."""
    return x @ embedding.T
