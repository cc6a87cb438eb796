"""Modality frontend stubs: precomputed patch/frame embeddings feed the
transformer backbone, which is the real model.

Port of ``repro.models.frontends``.
``vlm``  (internvl2-76b): patch embeddings [B, n_patches, D] are prepended to
the text embeddings.
``audio`` (seamless-m4t): frame embeddings [B, n_frames, D] feed the encoder.
The embedding may come as vocabulary blocks on the model shards
(``layers.embed``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import embed


def vlm_prepend(params, patch_embeds: torch.Tensor, tokens: torch.Tensor, cfg: ModelConfig):
    """Concatenate projected patch embeddings before token embeddings."""
    text = embed(params["embedding"], tokens)
    patches = patch_embeds.to(text.dtype)
    return torch.cat([patches, text], dim=1)


def frontend_spec(cfg: ModelConfig, batch: int, dtype=torch.bfloat16) -> Optional[torch.Tensor]:
    """Shape and dtype of the stub frontend output, as a tensor on the
    ``meta`` device (no storage; the reference returns a ShapeDtypeStruct)."""
    if cfg.frontend is None:
        return None
    return torch.empty((batch, cfg.frontend_seq, cfg.d_model), dtype=dtype, device="meta")
