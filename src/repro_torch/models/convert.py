"""Carry the reference's weights, decode caches and training state into the
port's layouts.

Port-only.  The reference (``repro.models``) keeps layers in scanned stacks:
``layers`` [L, ...]; ``layers_dense`` / ``layers_moe`` for interleaved
dense/MoE models; per-period ``periods[j]`` [num_periods, ...] for hybrids;
``enc_layers`` / ``dec_layers`` for the encoder–decoder.  The port keeps one
list of per-layer dicts in layer order (``params["layers"][i]``).

Inputs are the reference's pytrees as numpy arrays
(``jax.tree.map(np.asarray, params)``); bfloat16 arrays (numpy dtype name
``"bfloat16"``) are carried bit for bit.  The optimizer's moments and the
compression residual have the params' layout and are carried the same way,
so both packages can start a step from one state.  Nothing here imports JAX.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import layer_stack, num_layers
from repro_torch.optim.adamw import AdamWState
from repro_torch.optim.compress import CompressionState
from repro_torch.util.tree import tree_map


def to_tensor(a, device=None) -> torch.Tensor:
    """One numpy array as a torch tensor (a copy), bfloat16 bit for bit."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t if device is None else t.to(device)


def _slice(stack, i: int, device):
    """Entry i of a stacked pytree, as tensors."""
    return tree_map(lambda a: to_tensor(np.asarray(a)[i], device), stack)


def _layer_stack(cfg: ModelConfig, ref: Dict[str, Any], i: int):
    """(stacked pytree, index) of layer i in the reference's parameters."""
    key, idx = layer_stack(cfg, i)
    stack = ref[key[0]]
    return (stack[key[1]] if len(key) > 1 else stack), idx


def params_from_reference(cfg: ModelConfig, ref: Dict[str, Any], device=None) -> Dict[str, Any]:
    """The port's parameters from the reference's ``init_params`` pytree
    (``transformer`` or, for an encoder–decoder config, ``encdec``)."""
    top = lambda k: tree_map(lambda a: to_tensor(a, device), ref[k])
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
        return [tree_map(lambda a: to_tensor(a, device), c) for c in ref_cache]
    return [_slice(ref_cache, i, device) for i in range(cfg.layers)]


def opt_state_from_reference(cfg: ModelConfig, ref_state, device=None) -> AdamWState:
    """The port's ``AdamWState`` from the reference's (``step``, and ``mu`` and
    ``nu`` in the reference's params layout)."""
    step, mu, nu = ref_state
    return AdamWState(to_tensor(np.asarray(step, np.int32), device),
                      params_from_reference(cfg, mu, device),
                      params_from_reference(cfg, nu, device))


def comp_state_from_reference(cfg: ModelConfig, ref_state, device=None) -> CompressionState:
    """The port's ``CompressionState`` from the reference's (its residual in
    the reference's params layout)."""
    return CompressionState(params_from_reference(cfg, ref_state.residual, device))
