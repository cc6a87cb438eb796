"""Train and serve step functions of the LM tree.

Port of ``repro.launch.steps``: the loss, ``make_train_step`` (gradients
from ``torch.autograd.grad``, optionally accumulated over microbatches or
sent through the CSR top-k compression) and the serve steps
(``make_prefill_step``, ``make_decode_step``).  The steps run eagerly on the
device their inputs live on.  With a mesh of several shards the gradients
are those of ``launch/sharded.py`` (params and moments stored as pieces,
each data shard's rows on its device), and the microbatch loop, the
compression and the update are the same code as on one device; with any
mesh the forward runs expert-parallel MoE where the reference does.  The
abstract input specs of the reference's dry run (``abstract_params``,
``abstract_opt_state``, ``abstract_cache``, ``input_specs``) come with the
port of the dry run.
"""
from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from repro_torch.launch import sharded as SHD
from repro_torch.models import encdec as ED
from repro_torch.models import transformer as TF
from repro_torch.models.config import ModelConfig
from repro_torch.models.frontends import vlm_prepend
from repro_torch.optim import adamw
from repro_torch.util.sharded import Sharded, pieces_of, zeros_f32
from repro_torch.util.tree import leaf_paths, leaves, tree_map


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean of f32 ``logsumexp`` minus the gold logit."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(lse - gold)


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------


def make_loss_fn(cfg: ModelConfig, *, aux_weight: float = 0.01):
    """Returns loss_fn(params, tokens, labels, extra=None, mesh=None) →
    (loss + aux_weight·aux, loss, aux): the reference train step's
    ``loss_fn``, the decoder's forward run with ``mesh`` (the
    encoder–decoder's takes none, as in the reference)."""

    def loss_fn(params, tokens, labels, extra=None, mesh=None):
        if cfg.is_encdec:
            enc_out = ED.encode(params, extra, cfg)
            logits, _ = ED.decode(params, tokens, enc_out, cfg)
            aux = torch.zeros((), device=logits.device)
        else:
            inp = tokens
            if cfg.frontend == "vit" and extra is not None:
                inp = vlm_prepend(params, extra, tokens, cfg)
                labels = F.pad(labels, (extra.shape[1], 0), value=0)
            logits, _, aux = TF.forward(params, inp, cfg, mesh=mesh)
        loss = cross_entropy(logits, labels)
        return loss + aux_weight * aux, loss, aux

    return loss_fn


def make_grad_fn(cfg: ModelConfig, *, aux_weight: float = 0.01, mesh=None):
    """Returns grad_fn(params, tokens, labels, [extra]) → (loss, aux, grads):
    the train step's loss (cross-entropy, its MoE aux) and the gradients of
    loss + aux_weight·aux from ``torch.autograd.grad``, in the params' layout
    and dtypes (zeros for a leaf the loss does not reach), as the
    reference's ``jax.value_and_grad`` of its ``loss_fn`` gives them.  With
    a ``mesh`` of several shards it is ``sharded.make_grad_fn``: params and
    gradients are trees of ``Sharded`` pieces, and the loss, aux and
    gradients the mean over the data shards."""
    loss_fn = make_loss_fn(cfg, aux_weight=aux_weight)
    if mesh is not None and mesh.size > 1:
        return SHD.make_grad_fn(cfg, mesh, loss_fn)

    def grad_fn(params, tokens, labels, extra=None):
        flat = [p.detach().requires_grad_() for p in leaves(params)]
        it = iter(flat)
        live = tree_map(lambda _: next(it), params)
        with torch.enable_grad():
            total, loss, aux = loss_fn(live, tokens, labels, extra, mesh)
            grads = torch.autograd.grad(total, flat, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(flat, grads)]
        it = iter(grads)
        return loss.detach(), aux.detach(), tree_map(lambda _: next(it), params)

    return grad_fn


def stacked_leaf_groups(cfg: ModelConfig, params) -> List[List[int]]:
    """The leaves of ``params`` (by walk position) grouped by the leaf of the
    reference's stacked parameters each one is a slice of: one group per
    stack and per entry of a layer, its layers in stack order
    (``transformer.layer_stack``; ``enc_layers`` and ``dec_layers`` are
    one stack each).  Every other leaf is a group of its own.  The
    compressed train step takes top-k over each group, as the reference
    takes it over each of its leaves."""
    groups: Dict[tuple, List[int]] = {}
    for n, path in enumerate(leaf_paths(params)):
        if path[0] == "layers":
            key = (TF.layer_stack(cfg, path[1])[0], path[2:])
        elif path[0] in ("enc_layers", "dec_layers"):
            key = ((path[0],), path[2:])
        else:
            key = path
        groups.setdefault(key, []).append(n)
    return list(groups.values())


def _batch_rows(t, rows: slice):
    """Rows ``rows`` of a batch (a tensor, a ``Sharded`` batch, or None)."""
    if t is None:
        return None
    return (t.full() if isinstance(t, Sharded) else t)[rows]


def make_train_step(
    cfg: ModelConfig,
    opt_cfg: adamw.AdamWConfig,
    mesh=None,
    *,
    aux_weight: float = 0.01,
    microbatches: int = 1,
    compression=None,
):
    """Returns train_step(params, opt_state, tokens, labels, [extra]) →
    (params, opt_state, metrics). ``microbatches`` > 1 accumulates f32
    gradients sequentially (memory ↓, same math).

    ``compression`` (a CompressionConfig) switches the step to the CSR top-k
    gradient path with error feedback: the signature becomes
    train_step(params, opt_state, comp_state, tokens, labels, [extra]) →
    (params, opt_state, comp_state, metrics).

    With a ``mesh`` of several shards the params and the moments (and the
    residual) are trees of ``util.sharded.Sharded`` (``sharded.shard_tree``,
    ``train.trainer.init_state``) and the gradients are
    ``sharded.make_grad_fn``'s; the microbatches, the compression and the
    update are the one-device code, which walks the pieces.  The params and
    the optimizer state are updated in place (``adamw.apply``) and
    returned; the metrics are 0-d tensors (``compress_ratio`` a float)."""
    grad_fn = make_grad_fn(cfg, aux_weight=aux_weight, mesh=mesh)

    def gradients(params, tokens, labels, extra):
        if microbatches <= 1:
            return grad_fn(params, tokens, labels, extra)
        mb = tokens.shape[0] // microbatches
        g_acc = tree_map(zeros_f32, params)
        l_acc = torch.zeros((), device=tokens.device)
        a_acc = torch.zeros((), device=tokens.device)
        for i in range(microbatches):
            rows = slice(i * mb, (i + 1) * mb)
            l, a, g = grad_fn(params, *(_batch_rows(t, rows) for t in (tokens, labels, extra)))
            for acc, gi in zip(pieces_of(g_acc), pieces_of(g)):
                acc.add_(gi)
            l_acc, a_acc = l_acc + l.to(l_acc.device), a_acc + a.to(a_acc.device)
        # a tensor divisor: CUDA multiplies by the reciprocal of a host scalar
        n = torch.tensor(float(microbatches), device=tokens.device)
        for acc in pieces_of(g_acc):
            acc.div_(n.to(acc.device))
        return l_acc / n, a_acc / n, g_acc

    def train_step(params, opt_state, tokens, labels, extra=None):
        loss, aux, grads = gradients(params, tokens, labels, extra)
        new_params, new_opt, metrics = adamw.apply(opt_cfg, params, grads, opt_state)
        metrics = dict(metrics, loss=loss, moe_aux=aux)
        return new_params, new_opt, metrics

    if compression is None:
        return train_step

    from repro_torch.optim import compress as COMP

    def train_step_compressed(params, opt_state, comp_state, tokens, labels, extra=None):
        loss, aux, grads = grad_fn(params, tokens, labels, extra)
        grads, comp_state, cmetrics = COMP.compress_grads(
            compression, grads, comp_state, groups=stacked_leaf_groups(cfg, params))
        new_params, new_opt, metrics = adamw.apply(opt_cfg, params, grads, opt_state)
        metrics = dict(metrics, loss=loss, moe_aux=aux, **cmetrics)
        return new_params, new_opt, comp_state, metrics

    return train_step_compressed


# ---------------------------------------------------------------------------
# serve steps
# ---------------------------------------------------------------------------


def make_prefill_step(cfg: ModelConfig, mesh=None):
    def prefill_step(params, tokens, extra=None):
        if cfg.is_encdec:
            enc_out = ED.encode(params, extra, cfg)
            logits, _ = ED.decode(params, tokens, enc_out, cfg)
            return logits
        inp = tokens
        if cfg.frontend == "vit" and extra is not None:
            inp = vlm_prepend(params, extra, tokens, cfg)
        logits, _, _ = TF.forward(params, inp, cfg, mesh=mesh)
        return logits

    return prefill_step


def make_decode_step(cfg: ModelConfig, mesh=None):
    """One new token against a KV cache / recurrent state of seq_len.

    ``cache_index`` is a Python int (a tensor is read to the host); the
    attention layers write into ``cache`` in place."""

    def decode_step(params, cache, tokens, cache_index, extra=None):
        if cfg.is_encdec:
            return ED.decode(params, tokens, extra, cfg, cache=cache, cache_index=cache_index)
        logits, new_cache, _ = TF.forward(params, tokens, cfg, cache=cache,
                                          cache_index=cache_index, mesh=mesh)
        return logits, new_cache

    return decode_step
