"""Executor of the sharded LM path: a batch's rows run per data shard
against state stored as pieces on a ``data × model`` mesh, for the train
step's gradients (:func:`make_grad_fn`) and for the serve steps
(:func:`serve`).

Port-only (the reference leaves all of this to XLA's partitioner, under the
specs of ``launch/sharding.py``).  What GSPMD places for the reference is
placed here explicitly:

  * **Storage.**  A leaf of the parameters, of the AdamW moments, of the
    compression residual and of the decode cache is a
    ``util.sharded.Sharded``: one piece per block its ``param_spec`` (or
    ``cache_spec``) cuts, each on its owner shard's device.
    :func:`shard_tree` cuts a tree of whole tensors so.
  * **Compute.**  Each data shard runs the forward of its own rows with
    the one-data-shard sub-mesh (a unit, :func:`_units`): its residual
    stream, norms and loss on its first model shard's device, the unit's
    device.  ``transformer.forward`` gathers the weights one layer at a
    time (one checkpointed group under remat) through the unit's
    :func:`unit_gather`: a tensor-parallel leaf as its model blocks and a
    MoE expert tensor under expert parallelism as its model pieces, each
    gathered over the data shards only onto its model shard
    (``Sharded.model_pieces``), every other leaf whole on the unit's
    device (``Sharded.full``); all differentiable with respect to the
    pieces.  Where the batch does not divide over the data shards, the
    reference does not split it, and neither does this: one unit runs the
    whole batch on the first shard, its model shards those at data 0.
  * **Gradients.**  Autograd gives each piece the slice of its leaf's
    gradient (the cut back into pieces); the pieces' gradients are summed
    over the data shards in shard order in float32, divided by their
    number, and cast to the piece's dtype (the reference's mean over data,
    in the dtype its ``value_and_grad`` gives).
  * **Serving.**  Params, cache and batch stay in pieces between steps.  For
    each layer a unit gathers its rows of the layer's cache onto its device
    (:class:`_UnitCache`), runs the layer, and writes back into the owner
    pieces only what the step wrote: of attention K/V the positions
    [cache_index, cache_index + T) along S, and the recurrent states (split
    by batch only, so the unit's own block) replaced.  A tensor-parallel
    attention layer's K/V (kv heads split over ``model``) are not moved:
    model shard m reads and writes its own piece in place.  A recurrent
    state keeps its cut (the reference replicates it over ``model``): the
    unit gathers its rows whole, a tensor-parallel mamba or rwkv6 layer
    hands each model shard its heads' slice and gathers the shards' new
    heads back, and the whole is written back as on one device.  It needs
    no counterpart of attention's fallback below: its heads are cut on the
    unit's device, whatever the batch, so a batch that does not divide
    over the data shards (one unit, the state whole on the first shard)
    runs tensor-parallel too.  The logits come back whole on the first
    shard's device.
  * **Tensor parallelism** (the reference's "TP over ``model``": heads,
    ffn, vocabulary; ``sharding.tp_dim`` says which leaves).  Model shard
    m of a unit multiplies its own column and row blocks on its device:
    attention over its whole heads and GQA groups, the MLP (and a MoE
    shared expert) over its slice of the ffn, the mamba mixer and rwkv6's
    time mix over their whole heads (the scan and the group norm of each
    head on its shard, with its slices of the per-head vectors), rwkv6's
    channel mix over its slice of the ffn, the embedding lookup and the
    logits over its vocabulary block.  The row blocks' partial outputs
    leave their matmuls as float32, unrounded, and are summed in float32 in
    shard order on the unit's device and cast once, and the
    next norm's output goes back to the model shards (an all-reduce, in two
    halves); the logits are concatenated on the unit's device (an
    all-gather).  Where the heads do not divide, and in a decode step
    whose cache is cut along S, attention is gathered whole as any other
    leaf.

The microbatch loop, the compression and the AdamW update per piece are
``launch/steps.py``'s, the same as on one device.  On one card every
shard's device is that card, and the gathers and sums are copies and adds
between its buffers.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.launch.mesh import ShardMesh, batch_axes, dp_size
from repro_torch.launch.sharding import batch_sharding, params_pspecs, tp_dim
from repro_torch.models.layers import cache_write_start
from repro_torch.util.costs import move
from repro_torch.util.sharded import Sharded, spec_axes
from repro_torch.util.tree import leaf_paths, leaves, tree_map

_EXPERT_LEAVES = ("w_in", "w_gate", "w_out")


def shard_tree(tree: Any, mesh: ShardMesh, pspecs: Any = None) -> Any:
    """A tree of whole tensors cut into ``Sharded`` leaves by ``pspecs``
    (default ``params_pspecs(tree, mesh)``)."""
    if pspecs is None:
        pspecs = params_pspecs(tree, mesh)
    return tree_map(lambda t, spec: Sharded.from_full(t, mesh, spec), tree, pspecs)


def shard_tree_(tree: Any, mesh: ShardMesh, pspecs: Any = None) -> Any:
    """:func:`shard_tree` in place on a tree of dicts and lists, leaf by
    leaf: each whole leaf is dropped as soon as its pieces are cut, so that
    a model that fits once on the card is not held twice; returns
    ``tree``."""
    if pspecs is None:
        pspecs = params_pspecs(tree, mesh)
    for path, spec in zip(leaf_paths(tree), leaves(pspecs)):
        node = tree
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = Sharded.from_full(node[path[-1]], mesh, spec)
    return tree


def batch_rows(t: torch.Tensor, mesh: ShardMesh):
    """A batch tensor as the steps take it on ``mesh``: ``Sharded`` rows of
    the data shards (``sharding.batch_sharding``) where B divides over
    them, else ``t`` as it is (the reference does not split such a
    batch)."""
    if t.shape[0] % dp_size(mesh):
        return t
    return Sharded.from_full(t, mesh, batch_sharding(mesh).spec)


def in_pieces(*trees) -> bool:
    """Whether the leaves of ``trees`` are ``Sharded`` pieces (True) or
    tensors (False); raises where they mix."""
    kinds = {isinstance(t, Sharded) for tree in trees for t in leaves(tree)}
    if len(kinds) > 1:
        raise ValueError("a step takes its state all in Sharded pieces or all whole, not mixed")
    return kinds == {True}


# ---------------------------------------------------------------------------
# units and the gather of one
# ---------------------------------------------------------------------------


def _units(mesh: ShardMesh, B: int):
    """(row slice, sub-mesh, device) of each compute unit of a batch of B:
    one per data shard, in shard order, where B divides over them; else one
    unit, the whole batch on the first shard with the whole mesh (the
    reference does not split such a batch)."""
    D = dp_size(mesh)
    if B % D:
        return [(slice(0, B), mesh, mesh.devices[0])]
    Bl = B // D
    return [(slice(d * Bl, (d + 1) * Bl), mesh.select(**c), mesh.device_at(**c))
            for d, c in enumerate(mesh.coords_over(batch_axes(mesh)))]


def _rows(t, rows: slice, device):
    """Rows ``rows`` of a batch tensor on ``device``; of a ``Sharded``
    batch, the piece that holds exactly those rows where there is one."""
    if isinstance(t, Sharded):
        n = t.shape[0] // t.grid[0]
        if rows.start % n == 0 and rows.stop - rows.start == n:
            return t.pieces[rows.start // n].to(device)
        t = t.full()
    return None if t is None else t[rows].to(device)


def unit_gather(cfg, sub: ShardMesh, device, ep: bool, attn_tp: bool = True):
    """The ``gather`` that ``transformer.forward`` takes for one unit: a
    subtree of ``Sharded`` leaves → each leaf whole on ``device``, except
    that a tensor-parallel leaf (``sharding.tp_dim``: attention's only where
    ``attn_tp``; the mamba mixers' and rwkv6's projections always) comes as
    its model blocks, and under EP an expert leaf as its model pieces, each
    gathered over the data shards only onto model shard m of ``sub``
    (``Sharded.model_pieces``)."""
    model_devs = ([sub.device_at(model=m) for m in range(sub.shape["model"])]
                  if "model" in sub.axis_names else None)

    def one(path, s):
        if (ep and "moe" in path and path[-1] in _EXPERT_LEAVES
                and "model" in spec_axes(s.spec[0])):
            return s.model_pieces(model_devs)
        dim = tp_dim(cfg, path, s.spec, s.mesh)
        if dim is not None and (attn_tp or "attn" not in path):
            return s.model_pieces(model_devs, dim)
        return s.full(device)

    def gather(tree):
        paths = iter(leaf_paths(tree))
        return tree_map(lambda s: one(next(paths), s), tree)

    return gather


def _ep(cfg, mesh: ShardMesh, B: int) -> bool:
    """Expert parallelism for a batch of B: a MoE model, a ``model`` axis,
    and a batch split over the data shards."""
    return cfg.is_moe and "model" in mesh.axis_names and B % dp_size(mesh) == 0


# ---------------------------------------------------------------------------
# the sharded train step
# ---------------------------------------------------------------------------


def make_grad_fn(cfg, mesh: ShardMesh, loss_fn):
    """Returns grad_fn(params, tokens, labels, [extra]) → (loss, aux, grads)
    over a tree of ``Sharded`` params: the mean over the data shards of
    their losses, aux and gradients, the gradients as ``Sharded`` leaves in
    the params' cut and dtypes.

    ``loss_fn(params, tokens, labels, extra, mesh, gather)`` → (total, loss,
    aux) is the train step's loss (``steps.make_loss_fn``), given the
    ``Sharded`` tree over the live pieces and the unit's
    :func:`unit_gather`; ``tokens`` and ``labels`` are tensors or
    ``Sharded`` batches (``data.pipeline.global_batch_array``)."""
    dev0 = mesh.devices[0]

    def grad_fn(params, tokens, labels, extra=None):
        live = [p.detach().requires_grad_() for s in leaves(params) for p in s.pieces]
        it = iter(live)
        tree = tree_map(lambda s: s.map(lambda _: next(it)), params)    # no copy
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in live]
        units = _units(mesh, tokens.shape[0])
        ep = _ep(cfg, mesh, tokens.shape[0])
        losses, auxes = [], []
        for rows, sub, dev in units:
            tb, lb, eb = (_rows(t, rows, dev) for t in (tokens, labels, extra))
            with torch.enable_grad():
                total, loss, aux = loss_fn(tree, tb, lb, eb, sub, unit_gather(cfg, sub, dev, ep))
                grads = torch.autograd.grad(total, live, allow_unused=True)
            with torch.no_grad():
                for a, g in zip(acc, grads):     # the sum over units, in order
                    if g is not None:
                        a.add_(g)
            del grads
            losses.append(loss.detach().to(dev0))
            auxes.append(aux.detach().to(dev0))
        n = torch.tensor(float(len(units)), device=dev0)
        with torch.no_grad():
            for a in acc:
                a.div_(n.to(a.device))
            it = iter(a.to(p.dtype) for a, p in zip(acc, live))
            grads = tree_map(lambda s: s.map(lambda _: next(it)), params)
        loss, aux = losses[0], auxes[0]
        for l_, a_ in zip(losses[1:], auxes[1:]):
            loss, aux = loss + l_, aux + a_
        return loss / n, aux / n, grads

    return grad_fn


# ---------------------------------------------------------------------------
# the sharded serve steps
# ---------------------------------------------------------------------------


class _UnitCache:
    """One unit's view of a decode cache cut by ``cache_spec``: ``view[i]``
    is layer i's entry for the unit's rows, gathered onto its device;
    ``view[i] = entry`` writes what the layer wrote back into the owner
    pieces: of attention K/V the T positions the step wrote along S (from
    ``cache_index``, clamped as the layer clamps it), of a recurrent state
    the whole block, replaced (a tensor-parallel recurrent layer takes its
    state so too, and cuts it by heads itself).  Attention K/V whose kv
    heads are split over ``model`` (a tensor-parallel layer's) are handed as
    the unit's pieces themselves, one per model shard in shard order, each
    on its owner's device: the layer writes them in place and nothing is
    written back."""

    def __init__(self, cache, unit: int, device, cache_index: int, T: int):
        self.cache, self.unit, self.device = cache, unit, device
        self.index, self.T = cache_index, T

    def _box(self, s: Sharded):
        return {b for b in s.blocks() if b[0] == self.unit}

    @staticmethod
    def _per_shard(k: str, s: Sharded) -> bool:
        return k in ("k", "v") and "model" in spec_axes(s.spec[2])

    def __getitem__(self, i):
        return {k: (tuple(p for b, p in zip(s.blocks(), s.pieces) if b[0] == self.unit)
                    if self._per_shard(k, s) else s.box(self._box(s), self.device))
                for k, s in self.cache[i].items()}

    def __setitem__(self, i, entry):
        for k, s in self.cache[i].items():
            if self._per_shard(k, s):
                continue
            if k in ("k", "v"):
                start = cache_write_start(self.index, self.T, s.shape[1])
                s.write_(entry[k], self._box(s), 1, start, start + self.T)
            else:
                s.write_(entry[k], self._box(s))


def serve(cfg, mesh: ShardMesh, forward_fn, params, tokens, extra=None, cache=None,
          cache_index=None):
    """A serve step on state in pieces: (logits whole on the first shard's
    device, ``cache`` updated in place).

    ``params`` are ``Sharded`` leaves (``shard_tree``), ``cache`` (decode
    only) ``Sharded`` leaves cut by ``sharding.cache_spec`` for this batch,
    ``tokens`` and ``extra`` tensors or ``Sharded`` rows.
    ``forward_fn(params, tokens, extra, cache=, cache_index=, mesh=,
    gather=)`` is the decoder's forward (``steps``); each unit runs it on
    its rows with its sub-mesh and :func:`unit_gather`.  Raises where the
    state is not in pieces on ``mesh`` or the cache is not cut for this
    batch."""
    B, T = tokens.shape[0], tokens.shape[1]
    units = _units(mesh, B)
    state = leaves(params) + leaves(cache)
    if not all(isinstance(s, Sharded) and s.mesh == mesh for s in state):
        raise ValueError("a serve step on a mesh of several shards takes params and cache as "
                         "Sharded pieces on that mesh (sharded.shard_tree)")
    if any(s.grid[0] != len(units) for s in leaves(cache)):
        raise ValueError(f"the cache is not cut for a batch of {B} over {len(units)} units "
                         f"(sharding.cache_spec)")
    ep = _ep(cfg, mesh, B)
    # a cache cut along S (B does not divide over the data shards) keeps
    # attention out of tensor parallelism for the step
    attn_tp = cache is None or B % dp_size(mesh) == 0
    dev0 = mesh.devices[0]
    outs = []
    for u, (rows, sub, dev) in enumerate(units):
        view = None if cache is None else _UnitCache(cache, u, dev, int(cache_index), T)
        logits, _, _ = forward_fn(params, _rows(tokens, rows, dev), _rows(extra, rows, dev),
                                  cache=view, cache_index=cache_index, mesh=sub,
                                  gather=unit_gather(cfg, sub, dev, ep, attn_tp))
        outs.append(move(logits, dev0, "all-gather"))
    return (torch.cat(outs) if len(outs) > 1 else outs[0]), cache
