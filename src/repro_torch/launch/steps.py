"""Serve step functions of the LM tree.

Port of the serve half of ``repro.launch.steps`` (``make_prefill_step`` and
``make_decode_step``).  The loss, the train step and the abstract input specs
come with the training slice of the port.
"""
from __future__ import annotations

from repro_torch.models import encdec as ED
from repro_torch.models import transformer as TF
from repro_torch.models.config import ModelConfig
from repro_torch.models.frontends import vlm_prepend


def make_prefill_step(cfg: ModelConfig, mesh=None):
    TF.refuse_mesh(mesh)

    def prefill_step(params, tokens, extra=None):
        if cfg.is_encdec:
            enc_out = ED.encode(params, extra, cfg)
            logits, _ = ED.decode(params, tokens, enc_out, cfg)
            return logits
        inp = tokens
        if cfg.frontend == "vit" and extra is not None:
            inp = vlm_prepend(params, extra, tokens, cfg)
        logits, _, _ = TF.forward(params, inp, cfg)
        return logits

    return prefill_step


def make_decode_step(cfg: ModelConfig, mesh=None):
    """One new token against a KV cache / recurrent state of seq_len.

    ``cache_index`` is a Python int (a tensor is read to the host); the
    attention layers write into ``cache`` in place."""
    TF.refuse_mesh(mesh)

    def decode_step(params, cache, tokens, cache_index, extra=None):
        if cfg.is_encdec:
            return ED.decode(params, tokens, extra, cfg, cache=cache, cache_index=cache_index)
        logits, new_cache, _ = TF.forward(params, tokens, cfg, cache=cache,
                                          cache_index=cache_index)
        return logits, new_cache

    return decode_step
