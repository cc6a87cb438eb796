"""Encoder–decoder backbone (Seamless-M4T medium: 12L enc + 12L dec).

Port of ``repro.models.encdec``.  The audio frontend is a stub: precomputed
frame embeddings feed the encoder.  The decoder adds cross-attention over the
encoder output; decoding runs the decoder with a KV cache while the encoder
output is computed once.  Layers are lists of per-layer dicts
(``enc_layers``, ``dec_layers``) in place of the reference's scanned stacks.
With ``cfg.remat`` each layer runs under ``torch.utils.checkpoint`` while
autograd records and no cache is given (the reference's ``jax.checkpoint``
of its layer bodies); serving under ``torch.inference_mode()`` is unchanged.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import mask_pad_vocab

Params = Dict[str, Any]


def refuse_mesh(mesh) -> None:
    """Raise for a mesh: the reference's ``encode`` and ``decode`` take
    none, so the encoder–decoder has no sharded path to port."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh: the encoder-decoder runs on one device; the reference's "
            "encode and decode take no mesh"
        )


def _enc_layer_init(gen, cfg: ModelConfig, dtype) -> Params:
    dev = gen.device
    return {
        "ln1": L.rmsnorm_init(cfg.d_model, dtype, dev),
        "attn": L.attention_init(
            gen, cfg.d_model, cfg.num_heads, cfg.kv_heads, cfg.resolved_head_dim,
            qkv_bias=cfg.qkv_bias, dtype=dtype,
        ),
        "ln2": L.rmsnorm_init(cfg.d_model, dtype, dev),
        "mlp": L.mlp_init(gen, cfg.d_model, cfg.d_ff, gated=False, dtype=dtype),
    }


def _dec_layer_init(gen, cfg: ModelConfig, dtype) -> Params:
    dev = gen.device
    return {
        "ln1": L.rmsnorm_init(cfg.d_model, dtype, dev),
        "attn": L.attention_init(
            gen, cfg.d_model, cfg.num_heads, cfg.kv_heads, cfg.resolved_head_dim,
            qkv_bias=cfg.qkv_bias, dtype=dtype,
        ),
        "ln_x": L.rmsnorm_init(cfg.d_model, dtype, dev),
        "xattn": L.attention_init(
            gen, cfg.d_model, cfg.num_heads, cfg.kv_heads, cfg.resolved_head_dim,
            qkv_bias=cfg.qkv_bias, dtype=dtype,
        ),
        "ln2": L.rmsnorm_init(cfg.d_model, dtype, dev),
        "mlp": L.mlp_init(gen, cfg.d_model, cfg.d_ff, gated=False, dtype=dtype),
    }


def init_params(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Random weights drawn from ``gen`` on its device, in ``cfg.dtype``."""
    dtype = L.param_dtype(cfg.dtype)
    return {
        "embedding": L.embed_init(gen, cfg.padded_vocab, cfg.d_model, dtype),
        "enc_layers": [_enc_layer_init(gen, cfg, dtype) for _ in range(cfg.encoder_layers)],
        "dec_layers": [_dec_layer_init(gen, cfg, dtype) for _ in range(cfg.layers)],
        "enc_norm": L.rmsnorm_init(cfg.d_model, dtype, gen.device),
        "final_norm": L.rmsnorm_init(cfg.d_model, dtype, gen.device),
    }


def _cross_attention(p: Params, x: torch.Tensor, enc_kv, cfg: ModelConfig):
    """Cross-attention with precomputed encoder K/V."""
    B, T, D = x.shape
    hd = cfg.resolved_head_dim
    q = (x @ p["wq"]).reshape(B, T, cfg.num_heads, hd)
    if "bq" in p:
        q = q + p["bq"].reshape(1, 1, cfg.num_heads, hd)
    groups = cfg.num_heads // cfg.kv_heads
    out = L.flash_attention(
        q, L._repeat_kv(enc_kv["k"], groups), L._repeat_kv(enc_kv["v"], groups),
        causal=False, kv_chunk=cfg.attention_chunk,
    )
    return out.reshape(B, T, cfg.num_heads * hd) @ p["wo"]


def encode(params: Params, embeds: torch.Tensor, cfg: ModelConfig, *, mesh=None) -> torch.Tensor:
    """Encoder over precomputed frame embeddings [B, S_enc, D]."""
    refuse_mesh(mesh)
    x = embeds.to(L.param_dtype(cfg.dtype))
    positions = torch.arange(x.shape[1], device=x.device)

    def layer(lp, x):
        h = L.rmsnorm(lp["ln1"], x)
        a, _ = L.attention_apply(
            lp["attn"], h, num_heads=cfg.num_heads, kv_heads=cfg.kv_heads,
            head_dim=cfg.resolved_head_dim, positions=positions,
            rope_theta=cfg.rope_theta, causal=False, kv_chunk=cfg.attention_chunk,
        )
        x = x + a
        return x + L.mlp_apply(lp["mlp"], L.rmsnorm(lp["ln2"], x))

    remat = cfg.remat and torch.is_grad_enabled()
    for lp in params["enc_layers"]:
        x = checkpoint(layer, lp, x, use_reentrant=False) if remat else layer(lp, x)
    return L.rmsnorm(params["enc_norm"], x)


def _enc_kv(lp_x: Params, enc_out: torch.Tensor, cfg: ModelConfig):
    B, S, D = enc_out.shape
    hd = cfg.resolved_head_dim
    k = (enc_out @ lp_x["wk"]).reshape(B, S, cfg.kv_heads, hd)
    v = (enc_out @ lp_x["wv"]).reshape(B, S, cfg.kv_heads, hd)
    if "bk" in lp_x:
        k = k + lp_x["bk"].reshape(1, 1, cfg.kv_heads, hd)
        v = v + lp_x["bv"].reshape(1, 1, cfg.kv_heads, hd)
    return {"k": k, "v": v}


def decode(
    params: Params,
    tokens: torch.Tensor,            # [B, T] target tokens
    enc_out: torch.Tensor,           # [B, S_enc, D]
    cfg: ModelConfig,
    *,
    cache: Optional[List] = None,
    cache_index=None,
    mesh=None,
) -> Tuple[torch.Tensor, Optional[List]]:
    """Decoder logits; with ``cache`` the self-attention K/V rows are written
    into it in place and the list is returned."""
    refuse_mesh(mesh)
    x = params["embedding"][tokens.long()]
    B, T = tokens.shape
    base = int(cache_index) if cache_index is not None else 0
    positions = base + torch.arange(T, device=x.device)

    def layer(lp, x, lc):
        h = L.rmsnorm(lp["ln1"], x)
        a, nc = L.attention_apply(
            lp["attn"], h, num_heads=cfg.num_heads, kv_heads=cfg.kv_heads,
            head_dim=cfg.resolved_head_dim, positions=positions,
            rope_theta=cfg.rope_theta, cache=lc, cache_index=cache_index,
            kv_chunk=cfg.attention_chunk,
        )
        x = x + a
        hx = L.rmsnorm(lp["ln_x"], x)
        kv = _enc_kv(lp["xattn"], enc_out, cfg)
        x = x + _cross_attention(lp["xattn"], hx, kv, cfg)
        return x + L.mlp_apply(lp["mlp"], L.rmsnorm(lp["ln2"], x)), nc

    remat = cfg.remat and cache is None and torch.is_grad_enabled()
    new_cache = [] if cache is not None else None
    for i, lp in enumerate(params["dec_layers"]):
        lc = cache[i] if cache is not None else None
        if remat:
            x, nc = checkpoint(layer, lp, x, lc, use_reentrant=False)
        else:
            x, nc = layer(lp, x, lc)
        if new_cache is not None:
            new_cache.append(nc)
    x = L.rmsnorm(params["final_norm"], x)
    logits = mask_pad_vocab(L.unembed(x, params["embedding"]), cfg)
    return logits, new_cache


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None, device=None) -> List:
    """Self-attention KV cache of the decoder: one {"k", "v"} per layer."""
    dtype = dtype or L.param_dtype(cfg.dtype)
    hd = cfg.resolved_head_dim
    shape = (batch, max_len, cfg.kv_heads, hd)
    return [{"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
            for _ in range(cfg.layers)]
