"""Executor of the sharded LM path's gradients: a batch's rows run per data
shard against the training state stored as pieces on a ``data × model``
mesh.

Port-only (the reference leaves all of this to XLA's partitioner, under the
specs of ``launch/sharding.py``).  What GSPMD places for the reference is
placed here explicitly:

  * **Storage.**  A leaf of the parameters, of the AdamW moments and of the
    compression residual is a ``util.sharded.Sharded``: one piece per block
    its ``param_spec`` cuts, each on its owner shard's device.
    :func:`shard_tree` cuts a tree of whole tensors so.
  * **Compute.**  Each data shard gathers every leaf whole onto its device
    (``Sharded.full``, differentiable with respect to the pieces), except
    the MoE expert tensors under expert parallelism, which stay split over
    ``model`` (``Sharded.model_pieces``) and go through
    ``moe.moe_apply_ep``; it runs the forward and backward of its own rows
    with the one-data-shard sub-mesh.  Where the batch does not divide over
    the data shards, the reference does not split it, and neither does
    this: one unit runs the whole batch on the first shard.
  * **Gradients.**  Autograd gives each piece the slice of its leaf's
    gradient (the cut back into pieces); the pieces' gradients are summed
    over the data shards in shard order in float32, divided by their
    number, and cast to the piece's dtype (the reference's mean over data,
    in the dtype its ``value_and_grad`` gives).
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
from repro_torch.launch.sharding import params_pspecs
from repro_torch.util.sharded import Sharded, spec_axes
from repro_torch.util.tree import leaf_paths, leaves, tree_map

_EXPERT_LEAVES = ("w_in", "w_gate", "w_out")


def shard_tree(tree: Any, mesh: ShardMesh, pspecs: Any = None) -> Any:
    """A tree of whole tensors cut into ``Sharded`` leaves by ``pspecs``
    (default ``params_pspecs(tree, mesh)``)."""
    if pspecs is None:
        pspecs = params_pspecs(tree, mesh)
    return tree_map(lambda t, spec: Sharded.from_full(t, mesh, spec), tree, pspecs)


# ---------------------------------------------------------------------------
# the sharded train step
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


def _gathered(params, live, sub: ShardMesh, device, ep: bool):
    """The params tree for one unit: each leaf whole on ``device``, built from
    the ``live`` pieces; under EP the expert leaves as their model pieces."""
    it = iter(live)
    model_devs = None
    if ep:
        model_devs = [sub.device_at(**{a: 0 for a in sub.axis_names if a != "model"}, model=m)
                      for m in range(sub.shape["model"])]

    def one(path, s):
        t = s.map(lambda _: next(it))
        if (ep and path[-1] in _EXPERT_LEAVES and "moe" in path
                and "model" in spec_axes(t.spec[0])):
            return t.model_pieces(model_devs)
        return t.full(device)

    paths = iter(leaf_paths(params))
    return tree_map(lambda s: one(next(paths), s), params)


def make_grad_fn(cfg, mesh: ShardMesh, loss_fn):
    """Returns grad_fn(params, tokens, labels, [extra]) → (loss, aux, grads)
    over a tree of ``Sharded`` params: the mean over the data shards of
    their losses, aux and gradients, the gradients as ``Sharded`` leaves in
    the params' cut and dtypes.

    ``loss_fn(params, tokens, labels, extra, mesh)`` → (total, loss, aux) is
    the train step's loss (``steps.make_loss_fn``); ``tokens`` and
    ``labels`` are tensors or ``Sharded`` batches
    (``data.pipeline.global_batch_array``)."""
    dev0 = mesh.devices[0]
    ep = cfg.is_moe and "model" in mesh.axis_names

    def grad_fn(params, tokens, labels, extra=None):
        live = [p.detach().requires_grad_() for s in leaves(params) for p in s.pieces]
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in live]
        units = _units(mesh, tokens.shape[0])
        split = tokens.shape[0] % dp_size(mesh) == 0
        losses, auxes = [], []
        for rows, sub, dev in units:
            tb, lb, eb = (_rows(t, rows, dev) for t in (tokens, labels, extra))
            with torch.enable_grad():
                tree = _gathered(params, live, sub, dev, ep and split)
                total, loss, aux = loss_fn(tree, tb, lb, eb, sub)
                grads = torch.autograd.grad(total, live, allow_unused=True)
            del tree
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
