"""Decoder-only LM covering dense/GQA, MoE, RWKV-6 and hybrid (Jamba) archs.

Port of ``repro.models.transformer``.  The reference stacks uniform layers
and runs them with ``jax.lax.scan`` (hybrids scan over periods; interleaved
dense/MoE keeps two stacks).  PyTorch runs eagerly, so here the parameters
are one list of per-layer dicts in layer order, ``params["layers"][i]``, and
the forward pass is a Python loop over it; ``models/convert.py`` maps the
reference's stacks onto that list.  The decode cache is likewise one list
of per-layer entries (``init_cache``).

``remat`` is honoured while autograd records (``torch.is_grad_enabled()``,
no cache): each layer, or each period of a hybrid, runs under
``torch.utils.checkpoint`` as the reference's scan bodies run under
``jax.checkpoint``, so the backward pass keeps one layer's activations and
recomputes them.  As in the reference, the ``scan_layers=False`` path has no
remat.  Under ``torch.inference_mode()`` (serving) nothing is checkpointed.
``analysis_unroll`` concerns the reference's HLO cost analysis only.

With a ``mesh`` (``launch.mesh.ShardMesh``) a MoE layer runs
``moe.moe_apply_ep`` under the reference's condition (a ``model`` axis that
divides the experts, a batch that divides over the data axes), else
``moe_apply``.  The reference also pins the residual stream and the logits
to batch-sharded layouts (``_constrain_act``, ``_constrain_logits``): those
are layout hints to XLA's partitioner, and eager PyTorch has none; the
sharded executor (``launch/sharded.py``) places each data shard's rows
itself.

With ``gather`` (the sharded executor's, for one data shard) the params are
``util.sharded.Sharded`` leaves, and the forward makes them whole where it
uses them: each layer's subtree (each checkpointed group's, under remat,
inside the group, so the backward's recompute gathers it again) just before
the layer runs, the embedding, final norm and unembedding at their use, so
at most one group's weights (and the embeddings) are whole at once.  Where
the gather hands a leaf as one block per model shard (tensor parallelism,
``launch/sharding.py::tp_dim``), the layer multiplies each block on its
shard: attention over each shard's heads (``layers.attention_apply_tp``),
the MLP over its slice of the ffn (``layers.mlp_apply_tp``), the mamba
mixer and rwkv6's time mix over each shard's whole heads and rwkv6's
channel mix over its slice of the ffn (``mamba.mamba_block_*_tp``,
``rwkv6.rwkv6_block_*_tp``: the recurrent state comes whole to the unit's
device, each shard scans its heads' slice of it, and the new state comes
back whole), the embedding lookup and the logits over its vocabulary block
(``layers.embed``, ``layers.unembed``).  The partial outputs (float32,
unrounded, from the row blocks' matmuls) are summed in float32 in shard
order on the unit's device and cast once, where the residual stream and
the norms stay, and the logits are concatenated there.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import moe as MOE
from repro_torch.models import rwkv6 as R
from repro_torch.models.config import ModelConfig

Params = Dict[str, Any]


def num_layers(cfg: ModelConfig) -> int:
    """Layers the model runs: a hybrid runs whole periods only, as the
    reference's per-period stacks do."""
    if cfg.attn_period > 0:
        return (cfg.layers // cfg.attn_period) * cfg.attn_period
    return cfg.layers


def layer_stack(cfg: ModelConfig, i: int) -> Tuple[Tuple, int]:
    """(stack key, index) of layer i in the reference's stacked parameters:
    ``(("periods", j), period)`` for a hybrid, ``(("layers_moe",), n)`` or
    ``(("layers_dense",), n)`` for interleaved dense/MoE, else
    ``(("layers",), i)``.  ``models/convert.py`` reads the reference's
    weights by it, and the gradient compression takes top-k over each
    stack as the reference does."""
    if cfg.attn_period > 0:
        period, j = divmod(i, cfg.attn_period)
        return ("periods", j), period
    if cfg.is_moe and cfg.moe_every > 1:
        moe_i = cfg.layer_is_moe(i)
        idx = sum(1 for q in range(i) if cfg.layer_is_moe(q) == moe_i)
        return ("layers_moe" if moe_i else "layers_dense",), idx
    return ("layers",), i


def layer_spec(cfg: ModelConfig, i: int) -> Tuple[str, bool]:
    """(mixer kind, is MoE) of layer i.  A hybrid takes both from the layer's
    position in its period, as the reference's period body does."""
    j = i % cfg.attn_period if cfg.attn_period > 0 else i
    return cfg.layer_kind(j), cfg.layer_is_moe(j)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _layer_init(gen, cfg: ModelConfig, kind: str, is_moe: bool) -> Params:
    dtype = L.param_dtype(cfg.dtype)
    dev = gen.device
    p: Params = {}
    if kind == "rwkv":
        return R.rwkv6_block_init(gen, cfg.d_model, cfg.num_heads, cfg.d_ff, dtype=dtype)
    if kind == "mamba":
        p["mixer"] = M.mamba_block_init(
            gen, cfg.d_model, expand=cfg.mamba_expand, d_state=cfg.mamba_d_state, dtype=dtype
        )
    else:
        p["ln1"] = L.rmsnorm_init(cfg.d_model, dtype, dev)
        p["attn"] = L.attention_init(
            gen, cfg.d_model, cfg.num_heads, cfg.kv_heads, cfg.resolved_head_dim,
            qkv_bias=cfg.qkv_bias, dtype=dtype,
        )
    p["ln2"] = L.rmsnorm_init(cfg.d_model, dtype, dev)
    if is_moe:
        p["moe"] = MOE.moe_init(
            gen, cfg.d_model, cfg.moe_d_ff or cfg.d_ff, cfg.num_experts, dtype=dtype
        )
        if cfg.shared_expert:
            p["mlp"] = L.mlp_init(gen, cfg.d_model, cfg.moe_d_ff or cfg.d_ff, dtype=dtype)
    elif kind != "rwkv":
        p["mlp"] = L.mlp_init(gen, cfg.d_model, cfg.d_ff, dtype=dtype)
    return p


def init_params(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Random weights drawn from ``gen`` on its device, in ``cfg.dtype``."""
    dtype = L.param_dtype(cfg.dtype)
    params: Params = {
        "embedding": L.embed_init(gen, cfg.padded_vocab, cfg.d_model, dtype),
        "final_norm": L.rmsnorm_init(cfg.d_model, dtype, gen.device),
    }
    if not cfg.tie_embeddings:
        params["unembedding"] = L.embed_init(gen, cfg.padded_vocab, cfg.d_model, dtype)
    params["layers"] = [_layer_init(gen, cfg, *layer_spec(cfg, i))
                        for i in range(num_layers(cfg))]
    return params


# ---------------------------------------------------------------------------
# layer application
# ---------------------------------------------------------------------------


def _apply_layer(
    p: Params,
    x: torch.Tensor,
    cfg: ModelConfig,
    kind: str,
    is_moe: bool,
    positions: torch.Tensor,
    cache: Optional[Dict] = None,
    cache_index=None,
    mesh=None,
) -> Tuple[torch.Tensor, Optional[Dict], torch.Tensor]:
    """Returns (x, new_cache, moe_aux)."""
    aux = torch.zeros((), device=x.device)
    new_cache = None
    if kind == "rwkv":
        x, new_cache = _recurrent(p, x, cfg, kind, cache)
        return x, new_cache, aux
    if kind == "mamba":
        x, new_cache = _recurrent(p["mixer"], x, cfg, kind, cache)
    else:
        h = L.rmsnorm(p["ln1"], x)
        tp = L.is_tp(p["attn"]["wq"])
        if cache is not None and L.is_tp(cache["k"]) != tp:
            raise ValueError("a tensor-parallel attention layer takes its K/V cache as one piece "
                             "per model shard, and only it does")
        attn_out, new_cache = (L.attention_apply_tp if tp else L.attention_apply)(
            p["attn"], h,
            num_heads=cfg.num_heads, kv_heads=cfg.kv_heads,
            head_dim=cfg.resolved_head_dim, positions=positions,
            rope_theta=cfg.rope_theta, cache=cache, cache_index=cache_index,
            kv_chunk=cfg.attention_chunk, decode_fastpath=cfg.opt_decode_fastpath,
        )
        x = x + attn_out

    h = L.rmsnorm(p["ln2"], x)
    if is_moe:
        dp_axes = tuple(a for a in ("pod", "data") if mesh is not None and a in mesh.axis_names)
        dp_size = math.prod(mesh.shape[a] for a in dp_axes) if mesh is not None else 1
        use_ep = (
            mesh is not None
            and "model" in mesh.axis_names
            and cfg.num_experts % mesh.shape["model"] == 0
            and x.shape[0] % dp_size == 0
        )
        # per-slot dispatch at decode, the replica path otherwise (the
        # reference's shape-adaptive choice)
        slot_loop = cfg.opt_moe_slot_loop and x.shape[1] == 1
        if use_ep:
            y, aux = MOE.moe_apply_ep(
                p["moe"], h, num_experts=cfg.num_experts, top_k=cfg.top_k,
                mesh=mesh, data_axes=dp_axes, slot_loop=slot_loop,
            )
        else:
            y, aux = MOE.moe_apply(
                p["moe"], h, num_experts=cfg.num_experts, top_k=cfg.top_k,
                slot_loop=slot_loop,
            )
        if cfg.shared_expert:
            y = y + _mlp(p["mlp"], h)
        x = x + y
    elif kind != "rwkv" and "mlp" in p:
        x = x + _mlp(p["mlp"], h)
    return x, new_cache, aux


#: kind: ((apply, decode) on one device, (apply, decode) tensor-parallel)
_RECURRENT = {
    "rwkv": ((R.rwkv6_block_apply, R.rwkv6_block_decode),
             (R.rwkv6_block_apply_tp, R.rwkv6_block_decode_tp)),
    "mamba": ((M.mamba_block_apply, M.mamba_block_decode),
              (M.mamba_block_apply_tp, M.mamba_block_decode_tp)),
}


def _recurrent(p: Params, x: torch.Tensor, cfg: ModelConfig, kind: str, cache):
    """A rwkv6 block or a mamba mixer: (x, new state).  Tensor-parallel where
    its projections come as model blocks; its state comes whole either way
    (``cache_spec`` splits it by batch only)."""
    if cache is not None and any(L.is_tp(v) for v in cache.values()):
        raise ValueError("a recurrent layer takes its state whole, on its unit's device; a "
                         "tensor-parallel one hands each model shard its heads' slice")
    if kind == "rwkv":
        tp = L.is_tp(p["wr"]) or L.is_tp(p["ck"])
        kw = {"num_heads": cfg.num_heads}
    else:
        tp = L.is_tp(p["w_in"])
        kw = {"num_heads": M.mamba_num_heads(cfg.d_model, cfg.mamba_expand),
              "d_state": cfg.mamba_d_state}
    apply, decode = _RECURRENT[kind][tp]
    if cache is not None and x.shape[1] == 1:
        return decode(p, x, cache, **kw)
    return apply(p, x, chunk=cfg.la_chunk, state=cache, **kw)


def _mlp(p: Params, h: torch.Tensor) -> torch.Tensor:
    return (L.mlp_apply_tp if L.is_tp(p["w_in"]) else L.mlp_apply)(p, h)


def _apply_group(group: List[Params], x: torch.Tensor, cfg: ModelConfig, start: int,
                 positions: torch.Tensor, mesh=None, gather=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Layers ``start``, ``start + 1``, … (one list entry each) without a
    cache: (x, their MoE aux summed), as the reference's period body sums.
    With ``gather`` the group's weights are gathered here, inside the
    checkpointed function, and freed after it."""
    if gather is not None:
        group = gather(group)
    aux = torch.zeros((), device=x.device)
    for j, lp in enumerate(group):
        x, _, a = _apply_layer(lp, x, cfg, *layer_spec(cfg, start + j), positions, mesh=mesh)
        aux = aux + a
    return x, aux


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def mask_pad_vocab(logits: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Pad-row logits → −1e30 (in the logits' dtype) so padded embeddings are
    inert: greedy argmax never picks them."""
    if cfg.padded_vocab == cfg.vocab:
        return logits
    pad_mask = torch.arange(cfg.padded_vocab, device=logits.device) >= cfg.vocab
    return torch.where(pad_mask, torch.tensor(-1e30, dtype=logits.dtype,
                                              device=logits.device), logits)


def forward(
    params: Params,
    tokens_or_embeds: torch.Tensor,
    cfg: ModelConfig,
    *,
    positions: Optional[torch.Tensor] = None,
    cache: Optional[List] = None,
    cache_index=None,
    mesh=None,
    gather=None,
) -> Tuple[torch.Tensor, Optional[List], torch.Tensor]:
    """Returns (logits, new_cache, moe_aux_sum).

    ``tokens_or_embeds``: int tokens [B, T] or precomputed embeddings
    [B, T, D] (modality-frontend stubs feed embeddings directly).  With
    ``cache`` (from :func:`init_cache`) the attention layers write their K/V
    rows into it in place; the recurrent layers' states are replaced in the
    returned list.  ``mesh`` and ``gather``: see the module docstring; with
    ``gather``, ``cache`` is the executor's view of a sharded cache
    (``cache[i]`` gathers layer i's entry, ``cache[i] = entry`` writes the
    layer's writes back into the pieces), and that view is returned.
    """
    whole = gather if gather is not None else (lambda t: t)

    def take(name):             # a top-level leaf, gathered under its name
        return whole({name: params[name]})[name]

    tied = None
    if tokens_or_embeds.dim() == 2:
        emb = take("embedding")
        x = L.embed(emb, tokens_or_embeds)
        if "unembedding" not in params:
            tied = emb                      # gathered once for both uses
        del emb
    else:
        x = tokens_or_embeds.to(L.param_dtype(cfg.dtype))
    B, T = x.shape[:2]
    if positions is None:
        base = int(cache_index) if cache_index is not None else 0
        positions = base + torch.arange(T, device=x.device)

    aux_total = torch.zeros((), device=x.device)
    new_cache = None if cache is None else ([] if gather is None else cache)
    if cfg.remat and cfg.scan_layers and cache is None and torch.is_grad_enabled():
        # one checkpointed group per layer, or per period of a hybrid
        group = cfg.attn_period if cfg.attn_period > 0 else 1
        for start in range(0, len(params["layers"]), group):
            x, a = checkpoint(_apply_group, params["layers"][start:start + group], x, cfg,
                              start, positions, mesh, gather, use_reentrant=False)
            aux_total = aux_total + a
    else:
        for i, lp in enumerate(params["layers"]):
            kind, is_moe = layer_spec(cfg, i)
            ci = cache[i] if cache is not None else None
            x, nc, a = _apply_layer(whole(lp), x, cfg, kind, is_moe, positions,
                                    cache=ci, cache_index=cache_index, mesh=mesh)
            aux_total = aux_total + a
            if new_cache is not None:
                entry = nc if nc is not None else ci
                if gather is None:
                    new_cache.append(entry)
                else:
                    new_cache[i] = entry        # written back into the pieces

    x = L.rmsnorm(whole(params["final_norm"]), x)
    if "unembedding" in params:
        unemb = take("unembedding")
    else:
        unemb = tied if tied is not None else take("embedding")
    logits = mask_pad_vocab(L.unembed(x, unemb), cfg)
    return logits, new_cache, aux_total


# ---------------------------------------------------------------------------
# cache init
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None, device=None) -> List:
    """Decode cache: one entry per layer — {"k", "v"} [B, max_len, Hkv, Dh]
    for attention, {"S"} for mamba, {"S", "x_prev_att", "x_prev_ffn"} for
    RWKV."""
    dtype = dtype or L.param_dtype(cfg.dtype)
    hd = cfg.resolved_head_dim

    def entry(kind):
        if kind == "attn":
            return {
                "k": torch.zeros((batch, max_len, cfg.kv_heads, hd), dtype=dtype, device=device),
                "v": torch.zeros((batch, max_len, cfg.kv_heads, hd), dtype=dtype, device=device),
            }
        if kind == "mamba":
            return M.mamba_init_state(batch, cfg.d_model, expand=cfg.mamba_expand,
                                      d_state=cfg.mamba_d_state, device=device)
        return R.rwkv6_init_state(batch, cfg.d_model, cfg.num_heads, dtype, device=device)

    return [entry(layer_spec(cfg, i)[0]) for i in range(num_layers(cfg))]
