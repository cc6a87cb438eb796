"""Train and serve step functions of the LM tree.

Port of ``repro.launch.steps``: the loss, ``make_train_step`` (gradients
from ``torch.autograd.grad``, optionally accumulated over microbatches or
sent through the CSR top-k compression) and the serve steps
(``make_prefill_step``, ``make_decode_step``).  The steps run eagerly on the
device their inputs live on.  With a mesh of several shards the gradients
are those of ``launch/sharded.py`` (params and moments stored as pieces,
each data shard's rows on its device, the layers gathered one at a time),
and the microbatch loop, the compression and the update are the same code
as on one device; the serve steps take params, cache and batch in pieces
there too (``sharded.serve``).  With any mesh the forward runs
expert-parallel MoE where the reference does.

The abstract input specs of the dry run (``abstract_params``,
``abstract_opt_state``, ``abstract_cache``, ``input_specs``) are the port's
own initialisers run inside a ``FakeTensorMode`` that the caller enters:
the reference's ``jax.eval_shape`` stand-ins, with no memory behind them.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.launch import sharded as SHD
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import ShardMesh, dp_size
from repro_torch.models import encdec as ED
from repro_torch.models import transformer as TF
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.models.frontends import vlm_prepend
from repro_torch.models.layers import param_dtype
from repro_torch.optim import adamw
from repro_torch.util.sharded import PartitionSpec, Sharded, pieces_of, zeros_f32
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


def _decoder_forward(cfg: ModelConfig):
    """Returns forward(params, tokens, extra=None, **kw) → (logits, cache,
    aux) of a decoder-only model: the patch embeddings ``extra`` prepended
    (``vlm_prepend``) where the model has a ``vit`` frontend, then
    ``transformer.forward(..., **kw)``.  With the sharded executor's
    ``gather`` the embedding is gathered for the prepend."""

    def forward(params, tokens, extra=None, **kw):
        inp = tokens
        if cfg.frontend == "vit" and extra is not None:
            gather = kw.get("gather")
            emb = params if gather is None else gather({"embedding": params["embedding"]})
            inp = vlm_prepend(emb, extra, tokens, cfg)
        return TF.forward(params, inp, cfg, **kw)

    return forward


def make_loss_fn(cfg: ModelConfig, *, aux_weight: float = 0.01):
    """Returns loss_fn(params, tokens, labels, extra=None, mesh=None,
    gather=None) → (loss + aux_weight·aux, loss, aux): the reference train
    step's ``loss_fn``, the decoder's forward run with ``mesh`` (the
    encoder–decoder's takes none, as in the reference).  ``gather`` is the
    sharded executor's (``sharded.unit_gather``): the decoder gathers its
    layers one at a time, the encoder–decoder (one device only) its whole
    tree first."""
    forward = _decoder_forward(cfg)

    def loss_fn(params, tokens, labels, extra=None, mesh=None, gather=None):
        if cfg.is_encdec:
            if gather is not None:
                params = gather(params)
            enc_out = ED.encode(params, extra, cfg)
            logits, _ = ED.decode(params, tokens, enc_out, cfg)
            aux = torch.zeros((), device=logits.device)
        else:
            if cfg.frontend == "vit" and extra is not None:
                labels = F.pad(labels, (extra.shape[1], 0), value=0)
            logits, _, aux = forward(params, tokens, extra, mesh=mesh, gather=gather)
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


def _pieces(cfg: ModelConfig, mesh, *state) -> bool:
    """Whether a serve step runs on state in pieces (``sharded.serve``):
    ``Sharded`` leaves, which need a mesh of several shards and a
    decoder-only model.  Whole tensors run on their device, with ``mesh``
    for expert parallelism only."""
    if not SHD.in_pieces(*state):
        return False
    if cfg.is_encdec:
        raise ValueError("the encoder-decoder runs on one device: its state is not taken in "
                         "pieces")
    if mesh is None or mesh.size == 1:
        raise ValueError("state in Sharded pieces needs the mesh of several shards it is cut on")
    return True


def make_prefill_step(cfg: ModelConfig, mesh=None):
    """Logits of a prompt.  On a mesh of several shards the params are
    ``Sharded`` pieces and the batch tensors or ``Sharded`` rows
    (``steps.input_specs``), and the logits come back whole on the first
    shard's device."""
    forward = _decoder_forward(cfg)

    def prefill_step(params, tokens, extra=None):
        if _pieces(cfg, mesh, params):
            return SHD.serve(cfg, mesh, forward, params, tokens, extra)[0]
        if cfg.is_encdec:
            enc_out = ED.encode(params, extra, cfg)
            logits, _ = ED.decode(params, tokens, enc_out, cfg)
            return logits
        logits, _, _ = forward(params, tokens, extra, mesh=mesh)
        return logits

    return prefill_step


def make_decode_step(cfg: ModelConfig, mesh=None):
    """One new token against a KV cache / recurrent state of seq_len (or T
    tokens: a prefill into the cache).

    ``cache_index`` is a Python int (a tensor is read to the host); the
    attention layers write into ``cache`` in place.  On a mesh of several
    shards params and cache are ``Sharded`` pieces (the cache cut by
    ``sharding.cache_spec``), updated in place and returned; the logits
    come back whole on the first shard's device."""
    forward = _decoder_forward(cfg)

    def decode_step(params, cache, tokens, cache_index, extra=None):
        if _pieces(cfg, mesh, params, cache):
            return SHD.serve(cfg, mesh, forward, params, tokens, cache=cache,
                             cache_index=cache_index)
        if cfg.is_encdec:
            return ED.decode(params, tokens, extra, cfg, cache=cache, cache_index=cache_index)
        logits, new_cache, _ = TF.forward(params, tokens, cfg, cache=cache,
                                          cache_index=cache_index, mesh=mesh)
        return logits, new_cache

    return decode_step


# ---------------------------------------------------------------------------
# abstract input specs (fake tensors; no allocation)
# ---------------------------------------------------------------------------


def _require_fake_mode():
    if torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is None:
        raise RuntimeError("abstract specs are built inside a FakeTensorMode the caller "
                           "enters (torch._subclasses.fake_tensor.FakeTensorMode)")


def abstract_params(cfg: ModelConfig) -> Any:
    """The port's ``init_params`` under the caller's ``FakeTensorMode``: fake
    CPU tensors of the parameters' shapes and dtypes, drawn from a CPU
    generator."""
    _require_fake_mode()
    init = ED.init_params if cfg.is_encdec else TF.init_params
    return init(torch.Generator().manual_seed(0), cfg)


def abstract_opt_state(cfg: ModelConfig) -> adamw.AdamWState:
    """``adamw.init`` of :func:`abstract_params` (fake, as it)."""
    return adamw.init(abstract_params(cfg))


def abstract_cache(cfg: ModelConfig, batch: int, max_len: int, device=None) -> List:
    """The port's ``init_cache`` under the caller's ``FakeTensorMode``, on
    ``device`` (default the CPU)."""
    _require_fake_mode()
    init = ED.init_cache if cfg.is_encdec else TF.init_cache
    return init(cfg, batch, max_len, device=device)


def input_specs(cfg: ModelConfig, shape: ShapeConfig, mesh: ShardMesh, *,
                zero_threshold: Optional[float] = None) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(args, shardings) for the step of this shape cell, built under the
    caller's ``FakeTensorMode`` on ``mesh``'s devices.

    The keys are the reference's: train {params, opt_state, tokens, labels,
    [extra]}, prefill {params, tokens, [extra]}, decode {params, cache,
    tokens, cache_index, [extra]}.  ``shardings`` holds the
    :class:`~repro_torch.launch.sharding.NamedSharding` of each leaf by the
    rules of ``launch/sharding.py``, the batch replicated where B does not
    divide over the data axes.  ``args`` are placed as the port's steps take
    them: on a mesh of several shards, for every kind, params (and moments)
    as ``Sharded`` pieces in those specs, the decode cache as ``Sharded``
    pieces by ``cache_spec``, and the batch as ``Sharded`` rows of its data
    shards where B divides (else whole on the first shard); on one shard,
    and for the encoder–decoder's serve steps (which run on one device),
    every tensor whole on ``mesh.devices[0]``.  ``cache_index`` is a Python
    int (the steps read it on the host).

    In training on a mesh with a ``pod`` axis, where the state per device
    would pass ``zero_threshold`` bytes (default 14/16 of
    ``dryrun.HBM_BYTES``, the reference's 14 GiB share of a 16 GiB chip),
    the FSDP axis grows to pod × data (the reference's auto-ZeRO
    escalation)."""
    B, S = shape.global_batch, shape.seq_len
    dev0 = mesh.devices[0]
    repl = SH.NamedSharding(mesh, PartitionSpec())
    b_ok = B % dp_size(mesh) == 0
    dp = SH.batch_sharding(mesh) if b_ok else repl
    train = shape.kind == "train"

    params = abstract_params(cfg)
    p_shard = SH.params_shardings(params, mesh)
    if train and "pod" in mesh.axis_names:
        if zero_threshold is None:
            from repro_torch.launch.dryrun import HBM_BYTES
            zero_threshold = 14 / 16 * HBM_BYTES
        if SH.state_bytes_per_device(params, p_shard, mesh) > zero_threshold:
            p_shard = SH.params_shardings(params, mesh, fsdp_over_pod=True)

    pieces = mesh.size > 1 and (train or not cfg.is_encdec)
    if pieces:
        params = SHD.shard_tree(params, mesh, tree_map(lambda sh: sh.spec, p_shard))
    else:
        params = tree_map(lambda t: t.to(dev0), params)

    def batch(shp, dtype):
        t = torch.zeros(shp, dtype=dtype)
        return SHD.batch_rows(t, mesh) if pieces and b_ok else t.to(dev0)

    tok = torch.int32
    has_extra = cfg.is_encdec or (cfg.frontend == "vit" and not shape.is_decode)
    if train:
        args = {"params": params, "opt_state": adamw.init(params),
                "tokens": batch((B, S), tok), "labels": batch((B, S), tok)}
        shardings = {"params": p_shard,
                     "opt_state": adamw.AdamWState(step=repl, mu=p_shard, nu=p_shard),
                     "tokens": dp, "labels": dp}
    elif shape.kind == "prefill":
        args = {"params": params, "tokens": batch((B, S), tok)}
        shardings = {"params": p_shard, "tokens": dp}
    else:
        # decode / long_decode: one token per sequence, a cache of length S
        cache = abstract_cache(cfg, B, S)
        c_shard = SH.cache_shardings(cache, mesh, B)
        if pieces:
            cache = SHD.shard_tree(cache, mesh, tree_map(lambda sh: sh.spec, c_shard))
        else:
            cache = tree_map(lambda t: t.to(dev0), cache)
        args = {"params": params, "cache": cache, "tokens": batch((B, 1), tok),
                "cache_index": S - 1}
        shardings = {"params": p_shard, "cache": c_shard, "tokens": dp, "cache_index": repl}
    if has_extra:
        args["extra"] = batch((B, cfg.frontend_seq, cfg.d_model), param_dtype(cfg.dtype))
        shardings["extra"] = dp
    return args, shardings
