"""Carry the reference's weights and decode caches into the port's layouts.

Port-only.  The reference (``repro.models``) keeps layers in scanned stacks:
``layers`` [L, ...]; ``layers_dense`` / ``layers_moe`` for interleaved
dense/MoE models; per-period ``periods[j]`` [num_periods, ...] for hybrids;
``enc_layers`` / ``dec_layers`` for the encoder–decoder.  The port keeps one
list of per-layer dicts in layer order (``params["layers"][i]``).

Inputs are the reference's pytrees as numpy arrays
(``jax.tree.map(np.asarray, params)``); bfloat16 arrays (numpy dtype name
``"bfloat16"``) are carried bit for bit.  Nothing here imports JAX.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import num_layers


def to_tensor(a, device=None) -> torch.Tensor:
    """One numpy array as a torch tensor (a copy), bfloat16 bit for bit."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t if device is None else t.to(device)


def tree_map(tree, fn):
    """``fn`` applied to every leaf of a tree of dicts and lists (tuples
    become lists), the tree's layout kept."""
    if isinstance(tree, dict):
        return {k: tree_map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(v, fn) for v in tree]
    return fn(tree)


def _slice(stack, i: int, device):
    """Entry i of a stacked pytree, as tensors."""
    return tree_map(stack, lambda a: to_tensor(np.asarray(a)[i], device))


def _layer_stack(cfg: ModelConfig, ref: Dict[str, Any], i: int):
    """(stacked pytree, index) of layer i in the reference's parameters."""
    if cfg.attn_period > 0:
        period, j = divmod(i, cfg.attn_period)
        return ref["periods"][j], period
    if cfg.is_moe and cfg.moe_every > 1:
        moe_i = cfg.layer_is_moe(i)
        idx = sum(1 for q in range(i) if cfg.layer_is_moe(q) == moe_i)
        return ref["layers_moe" if moe_i else "layers_dense"], idx
    return ref["layers"], i


def params_from_reference(cfg: ModelConfig, ref: Dict[str, Any], device=None) -> Dict[str, Any]:
    """The port's parameters from the reference's ``init_params`` pytree
    (``transformer`` or, for an encoder–decoder config, ``encdec``)."""
    top = lambda k: tree_map(ref[k], lambda a: to_tensor(a, device))
    if cfg.is_encdec:
        return {
            "embedding": top("embedding"),
            "enc_layers": [_slice(ref["enc_layers"], i, device)
                           for i in range(cfg.encoder_layers)],
            "dec_layers": [_slice(ref["dec_layers"], i, device) for i in range(cfg.layers)],
            "enc_norm": top("enc_norm"),
            "final_norm": top("final_norm"),
        }
    out = {"embedding": top("embedding"), "final_norm": top("final_norm")}
    if "unembedding" in ref:
        out["unembedding"] = top("unembedding")
    out["layers"] = [_slice(*_layer_stack(cfg, ref, i), device) for i in range(num_layers(cfg))]
    return out


def cache_from_reference(cfg: ModelConfig, ref_cache, device=None) -> List[Dict[str, torch.Tensor]]:
    """The port's per-layer cache list from the reference's ``init_cache``
    layout (stacked per layer; a list per layer for interleaved MoE; a list
    per period position, stacked over periods, for hybrids)."""
    if cfg.is_encdec:
        return [_slice(ref_cache, i, device) for i in range(cfg.layers)]
    if cfg.attn_period > 0:
        return [_slice(ref_cache[i % cfg.attn_period], i // cfg.attn_period, device)
                for i in range(num_layers(cfg))]
    if cfg.is_moe and cfg.moe_every > 1:
        return [tree_map(c, lambda a: to_tensor(a, device)) for c in ref_cache]
    return [_slice(ref_cache, i, device) for i in range(cfg.layers)]
