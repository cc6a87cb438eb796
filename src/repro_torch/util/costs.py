"""Per-device cost counts of an eager program run on fake tensors.

The port's counterpart of what the reference's dry run reads from XLA
(``compiled.cost_analysis()`` and the collectives of the compiled HLO).  The
port has no compiler, so :class:`CostCounter` watches the aten ops its eager
program dispatches (run under ``FakeTensorMode`` on indexed ``meta``
devices, nothing is allocated) and records, for each device:

  * **FLOPs**: the formulas of ``torch.utils.flop_counter``'s registry
    (matmuls, convolutions, attention kernels), credited to the device of
    the op's output.  An op that has no formula and has a decomposition is
    decomposed, as ``FlopCounterMode`` does; elementwise ops count none.
  * **Bytes accessed**: the bytes of every tensor an op reads plus those it
    writes, each credited to the device it lies on.  View ops count
    nothing.  This is the eager, unfused counterpart of XLA's ``bytes
    accessed``: every intermediate goes through memory, so it is an upper
    bound for a fused program.
  * **Cross-device bytes**: the source bytes of every ``_to_copy`` or
    ``copy_`` whose source and destination devices differ (a 0-d host
    scalar excepted), credited to the
    destination and filed under one of the reference's collective kinds.
    The call sites that move data between shards name the kind through
    :func:`move` and :func:`gather_into`; any other move is a
    ``collective-permute``.

Usage::

    with FakeTensorMode(), CostCounter() as c:
        step(*args)
    c.flops[device], c.bytes[device], c.collective_bytes(device)
"""
from __future__ import annotations

import contextlib
from collections import defaultdict
from typing import Dict, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode, _get_current_dispatch_mode_stack
from torch.utils._pytree import tree_flatten, tree_leaves, tree_unflatten
from torch.utils.flop_counter import flop_registry

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

aten = torch.ops.aten
_METADATA_OPS = {
    aten.sym_is_contiguous.default, aten.is_contiguous.default,
    aten.is_contiguous.memory_format, aten.is_strides_like_format.default,
    aten.is_non_overlapping_and_dense.default, aten.size.default,
    aten.sym_size.default, aten.stride.default, aten.sym_stride.default,
    aten.storage_offset.default, aten.sym_storage_offset.default,
    aten.numel.default, aten.sym_numel.default, aten.dim.default,
    torch.ops.prim.layout.default, torch.ops.prim.device.default,
}
# views whose schema does not say so (``reshape`` gives ``_unsafe_view``)
_VIEWS = {aten._unsafe_view.default, aten.lift_fresh.default}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


_META = torch.device("meta")


def _constants_to_device(args, kwargs):
    """Some versions of fake mode make ``torch.tensor(v, device="meta:i")``
    a 0-d constant on the index-less ``meta`` device, which the op that
    takes it beside ``meta:i`` tensors then refuses.  Such a constant is put
    on the op's one indexed ``meta`` device (on the card it is made there);
    None where there is no such constant."""
    flat, spec = tree_flatten((args, kwargs))
    loose = [i for i, t in enumerate(flat)
             if isinstance(t, torch.Tensor) and t.device == _META and t.dim() == 0]
    devs = {t.device for t in flat if isinstance(t, torch.Tensor)
            and t.device.type == "meta" and t.device.index is not None}
    if not loose or len(devs) != 1:
        return None
    (dev,) = devs
    for i in loose:
        flat[i] = flat[i].to(dev)
    return tree_unflatten(flat, spec)


class CostCounter(TorchDispatchMode):
    """Counts FLOPs, bytes accessed and cross-device bytes per device.

    Enter it inside ``FakeTensorMode`` (``with FakeTensorMode(),
    CostCounter():``), so that it sees each op before the fake mode runs
    it.  It is also sound on real tensors, where it only adds host time."""

    def __init__(self):
        super().__init__()
        self.flops: Dict[torch.device, int] = defaultdict(int)
        self.bytes: Dict[torch.device, int] = defaultdict(int)
        self.coll: Dict[torch.device, Dict[str, int]] = defaultdict(
            lambda: dict.fromkeys(COLLECTIVES, 0))
        self.kind: Optional[str] = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _METADATA_OPS:
            return func(*args, **kwargs)
        packet = func._overloadpacket
        if packet not in flop_registry:
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        try:
            out = func(*args, **kwargs)
        except RuntimeError:
            fixed = _constants_to_device(args, kwargs)
            if fixed is None:
                raise
            args, kwargs = fixed
            out = func(*args, **kwargs)
        self._record(func, packet, args, kwargs, out)
        return out

    def _record(self, func, packet, args, kwargs, out):
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if packet in flop_registry and outs:
            self.flops[outs[0].device] += int(flop_registry[packet](*args, **kwargs, out_val=out))
        if func.is_view or func in _VIEWS:
            return
        if packet is aten.copy_:
            self.record_copy(args[1], args[0].device, _nbytes(args[0]))
            return
        for t in tree_leaves((args, kwargs)):
            if isinstance(t, torch.Tensor):
                self.bytes[t.device] += _nbytes(t)
        for t in outs:
            self.bytes[t.device] += _nbytes(t)
        if packet is aten._to_copy and outs:
            self._moved(args[0], outs[0].device)

    def record_copy(self, src: torch.Tensor, dst: torch.device, dst_bytes: int) -> None:
        """The counts of a ``copy_`` of ``src`` into ``dst_bytes`` on ``dst``:
        the source read, the destination read and written, and the move."""
        self.bytes[src.device] += _nbytes(src)
        self.bytes[dst] += 2 * dst_bytes
        self._moved(src, dst)

    def _moved(self, src: torch.Tensor, dst: torch.device) -> None:
        # a host scalar that a decomposition moves onto the device is no
        # transfer between shards
        host_scalar = src.device.type == "cpu" and src.dim() == 0
        if src.device != dst and not host_scalar:
            self.coll[dst][self.kind or "collective-permute"] += _nbytes(src)

    def collective_bytes(self, device=None) -> Dict[str, int]:
        """Bytes received by ``device`` (None: by every device) per
        collective kind, and their ``total``: the keys of the reference's
        ``dryrun.collective_bytes``."""
        devs = list(self.coll) if device is None else [device]
        out = {k: sum(self.coll[d][k] for d in devs if d in self.coll) for k in COLLECTIVES}
        out["total"] = sum(out.values())
        return out


def _active_counters():
    return [m for m in _get_current_dispatch_mode_stack() if isinstance(m, CostCounter)]


@contextlib.contextmanager
def _filed_under(kind: str):
    """File the moves made inside under ``kind`` in every active counter
    (without one, as on the card, this does nothing)."""
    counters = _active_counters()
    saved = [c.kind for c in counters]
    for c in counters:
        c.kind = kind
    try:
        yield
    finally:
        for c, k in zip(counters, saved):
            c.kind = k


class _Move(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, device, kind, back_kind):
        ctx.src, ctx.back_kind = t.device, back_kind
        with _filed_under(kind):
            return t.to(device)

    @staticmethod
    def backward(ctx, g):
        with _filed_under(ctx.back_kind):
            return g.to(ctx.src), None, None, None


def move(t: torch.Tensor, device, kind: str, back_kind: Optional[str] = None) -> torch.Tensor:
    """``t.to(device)``, filed under the collective ``kind`` by an active
    :class:`CostCounter`, and its gradient's way back under ``back_kind``
    (default ``kind``): an all-gather's backward is a reduce-scatter."""
    if t.device == torch.device(device):
        return t
    return _Move.apply(t, device, kind, back_kind or kind)


class _GatherInto(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shape, parts, device, kind, back_kind, *pieces):
        ctx.parts, ctx.back_kind = parts, back_kind
        ctx.devices = [p.device for p in pieces]
        out = torch.empty(shape, dtype=pieces[0].dtype, device=device)
        with _filed_under(kind):
            if isinstance(out, FakeTensor):
                # the counters record each copy_ below without an op per
                # piece: a fake op costs a fraction of a millisecond, and a
                # 16 x 16 mesh has 256 pieces a leaf
                for c in _active_counters():
                    for p in pieces:
                        c.record_copy(p, out.device, _nbytes(p))
                return out
            for sl, p in zip(parts, pieces):
                out[sl].copy_(p)
        return out

    @staticmethod
    def backward(ctx, g):
        with _filed_under(ctx.back_kind):
            grads = tuple(g[sl].to(d) for sl, d in zip(ctx.parts, ctx.devices))
        return (None,) * 5 + grads


def gather_into(shape, parts, pieces, device, kind: str, back_kind: Optional[str] = None):
    """A new tensor of ``shape`` on ``device`` whose slice ``parts[i]`` is
    ``pieces[i]`` (the pieces tile it), copied there piece by piece, the
    copies filed under ``kind`` and the gradients' way back (each piece's
    slice of the gradient, moved to its device) under ``back_kind``
    (default ``kind``).  On fake tensors the copies are not run: their
    bytes are filed with the active counters as the counter would record
    them."""
    return _GatherInto.apply(tuple(shape), tuple(parts), device, kind, back_kind or kind,
                             *pieces)
