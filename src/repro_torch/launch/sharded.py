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
  * **Compute.**  Each data shard runs the forward of its own rows on its
    device with the one-data-shard sub-mesh (a unit, :func:`_units`).
    ``transformer.forward`` makes the weights whole one layer at a time
    (one checkpointed group under remat) through the unit's
    :func:`unit_gather`: each leaf whole on the unit's device
    (``Sharded.full``, differentiable with respect to the pieces), except
    the MoE expert tensors under expert parallelism, which stay split over
    ``model`` (``Sharded.model_pieces``) and go through
    ``moe.moe_apply_ep`` as given.  Where the batch does not divide over
    the data shards, the reference does not split it, and neither does
    this: one unit runs the whole batch on the first shard.
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
    by batch only, so the unit's own block) replaced.  The logits come back
    whole on the first shard's device.
  * **Tensor parallelism.**  Dense weights split over ``model`` are gathered
    before use; the math is the reference's, the per-shard TP matmuls are
    not done.

The microbatch loop, the compression and the AdamW update per piece are
``launch/steps.py``'s, the same as on one device.  On one card every
shard's device is that card, and the gathers and sums are copies and adds
between its buffers.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.launch.mesh import ShardMesh, batch_axes, dp_size
from repro_torch.launch.sharding import batch_sharding, params_pspecs
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


def unit_gather(sub: ShardMesh, device, ep: bool):
    """The ``gather`` that ``transformer.forward`` takes for one unit: a
    subtree of ``Sharded`` leaves → each leaf whole on ``device``; under EP
    the expert leaves as their model pieces on the model shards of
    ``sub``."""
    model_devs = [sub.device_at(model=m) for m in range(sub.shape["model"])] if ep else None

    def one(path, s):
        if (ep and "moe" in path and path[-1] in _EXPERT_LEAVES
                and "model" in spec_axes(s.spec[0])):
            return s.model_pieces(model_devs)
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
                total, loss, aux = loss_fn(tree, tb, lb, eb, sub, unit_gather(sub, dev, ep))
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
    the whole block, replaced."""

    def __init__(self, cache, unit: int, device, cache_index: int, T: int):
        self.cache, self.unit, self.device = cache, unit, device
        self.index, self.T = cache_index, T

    def _box(self, s: Sharded):
        return {b for b in s.blocks() if b[0] == self.unit}

    def __getitem__(self, i):
        return {k: s.box(self._box(s), self.device) for k, s in self.cache[i].items()}

    def __setitem__(self, i, entry):
        for k, s in self.cache[i].items():
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
    dev0 = mesh.devices[0]
    outs = []
    for u, (rows, sub, dev) in enumerate(units):
        view = None if cache is None else _UnitCache(cache, u, dev, int(cache_index), T)
        logits, _, _ = forward_fn(params, _rows(tokens, rows, dev), _rows(extra, rows, dev),
                                  cache=view, cache_index=cache_index, mesh=sub,
                                  gather=unit_gather(sub, dev, ep))
        outs.append(move(logits, dev0, "all-gather"))
    return (torch.cat(outs) if len(outs) > 1 else outs[0]), cache
