"""Tensors stored as pieces on a mesh of shards, and the spec that cuts them.

The port's counterpart of what ``jax.sharding`` gives the reference: a
:class:`PartitionSpec` names, per dimension, the mesh axes that split it,
and a :class:`Sharded` leaf holds one piece per block that its spec cuts,
each piece on its owner shard's device (the shard at the block's
coordinates on the axes the spec names, 0 on the others; a block is
stored once, not once per replica).  The rules that choose the specs are
``launch/sharding.py``; the train step that gathers and updates the pieces
is ``launch/sharded.py``.  A mesh here is anything with ``shape``
(``{axis: size}``), ``devices`` (row-major) and ``flat_index(**coords)``,
as ``launch.mesh.ShardMesh`` has.

The optimizer and the checkpoint walk a sharded tree through
:func:`pieces_of` and :func:`whole`, which give a plain tensor back
unchanged, so one code path serves a tree of either kind.
"""
from __future__ import annotations

import itertools
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor

from repro_torch.util.costs import gather_into, move
from repro_torch.util.tree import leaves, tree_map


class PartitionSpec(tuple):
    """Per-dimension mesh axes: ``PartitionSpec("data", None)``.  A tuple
    (so it compares equal to the reference's ``PartitionSpec`` as a tuple),
    and a leaf of ``util.tree``'s walks."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple(self)!r}"


def spec_axes(entry) -> Tuple[str, ...]:
    """The mesh axes one entry of a spec names (None, a name or a tuple)."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


class Sharded:
    """A tensor of ``shape`` stored as pieces on ``mesh``, cut by ``spec``.

    ``pieces`` lists one contiguous tensor per block, row-major over
    ``grid`` (the number of blocks along each dimension); a dimension split
    over several axes is cut major-to-minor in the order the spec names
    them, as ``jax.sharding`` cuts it."""

    def __init__(self, mesh, spec, shape, pieces: Optional[List[torch.Tensor]]):
        self.mesh = mesh
        self.spec = PartitionSpec(*(tuple(spec) + (None,) * (len(shape) - len(spec))))
        self.shape = torch.Size(shape)
        self.grid = tuple(math.prod(mesh.shape[a] for a in spec_axes(e)) for e in self.spec)
        if pieces is not None and len(pieces) != math.prod(self.grid):
            raise ValueError(f"{len(pieces)} pieces for a grid of {self.grid}")
        self.pieces = pieces

    # -- tensor-like attributes (the trees' walks and the optimizer read them)
    @property
    def dtype(self) -> torch.dtype:
        return self.pieces[0].dtype

    @property
    def device(self) -> torch.device:
        return self.pieces[0].device

    def numel(self) -> int:
        return math.prod(self.shape)

    def element_size(self) -> int:
        return self.pieces[0].element_size()

    def __repr__(self):
        return (f"Sharded(shape={tuple(self.shape)}, spec={tuple(self.spec)}, "
                f"{len(self.pieces)} pieces, {self.dtype})")

    # -- blocks
    def blocks(self):
        return list(itertools.product(*(range(n) for n in self.grid)))

    def owner_index(self, block) -> int:
        """The (row-major) index of the shard that stores ``block``."""
        coords = {}
        for b, e in zip(block, self.spec):
            for a in reversed(spec_axes(e)):
                b, coords[a] = divmod(b, self.mesh.shape[a])
        return self.mesh.flat_index(**coords)

    def owner(self, block) -> torch.device:
        """The device of the shard that stores ``block``."""
        return self.mesh.devices[self.owner_index(block)]

    def _slices(self, block):
        return tuple(slice(b * (n // g), (b + 1) * (n // g))
                     for b, n, g in zip(block, self.shape, self.grid))

    @classmethod
    def from_full(cls, t: torch.Tensor, mesh, spec) -> "Sharded":
        """``t`` cut into its blocks, each copied to its owner's device (of a
        fake tensor, which has no values, each allocated there: one fake op
        a piece, not three)."""
        s = cls(mesh, spec, t.shape, None)
        if isinstance(t, FakeTensor):
            shape = [n // g for n, g in zip(s.shape, s.grid)]
            s.pieces = [torch.empty(shape, dtype=t.dtype, device=s.owner(b)) for b in s.blocks()]
            return s
        s.pieces = [t[s._slices(b)].to(s.owner(b), copy=True).contiguous()
                    for b in s.blocks()]
        return s

    def map(self, fn) -> "Sharded":
        """A Sharded of the same cut whose pieces are ``fn(piece)``."""
        return Sharded(self.mesh, self.spec, self.shape, [fn(p) for p in self.pieces])

    def box(self, blocks, device) -> torch.Tensor:
        """The pieces of ``blocks`` (a box of the grid) as one tensor on
        ``device``; a box of one block is its piece, moved.  Pieces that
        all lie on ``device`` (every shard on one card) are concatenated
        there, one dimension at a time from the last; else each piece is
        copied into its slice of the box.  The copies are an all-gather,
        and their gradients' way back a reduce-scatter
        (``util.costs.gather_into``, ``util.costs.move``)."""
        held = [(b, p) for b, p in zip(self.blocks(), self.pieces) if b in blocks]
        if len(held) == 1:
            return move(held[0][1], device, "all-gather", "reduce-scatter")
        device = torch.device(device)
        if all(p.device == device for _, p in held):
            parts = dict(held)
            for dim in reversed(range(len(self.grid))):
                runs: Dict[tuple, list] = {}
                for b in sorted(parts):
                    runs.setdefault(b[:dim] + b[dim + 1:], []).append(parts[b])
                parts = {k[:dim] + (0,) + k[dim:]: torch.cat(v, dim=dim) if len(v) > 1 else v[0]
                         for k, v in runs.items()}
            (out,) = parts.values()
            return out
        origin = tuple(min(b[k] for b, _ in held) for k in range(len(self.grid)))
        rel = [tuple(x - o for x, o in zip(b, origin)) for b, _ in held]
        shape = [(max(r[k] for r in rel) + 1) * (n // g)
                 for k, (n, g) in enumerate(zip(self.shape, self.grid))]
        return gather_into(shape, [self._slices(r) for r in rel], [p for _, p in held], device,
                           "all-gather", "reduce-scatter")

    def full(self, device=None) -> torch.Tensor:
        """The whole tensor on ``device`` (default: the first piece's, the
        mesh's first shard); differentiable with respect to the pieces."""
        return self.box(set(self.blocks()), self.device if device is None else device)

    def model_block(self, m: int, device, dim: int = 0) -> torch.Tensor:
        """Block ``m`` along dimension ``dim`` (the one split over ``model``),
        gathered whole along the others onto ``device``: FSDP's gather of
        model shard m's block, in which the shard at data coordinate d
        receives only the pieces (d′, m) of the other data shards.
        Differentiable with respect to the pieces, as :meth:`full`."""
        return self.box({b for b in self.blocks() if b[dim] == m}, device)

    def model_pieces(self, devices: Sequence[torch.device],
                     dim: int = 0) -> Tuple[torch.Tensor, ...]:
        """:meth:`model_block` m on ``devices[m]`` for each block along
        ``dim``: the experts of each model shard (dimension 0 of an expert
        tensor), or a tensor-parallel leaf's column or row blocks."""
        return tuple(self.model_block(m, devices[m], dim) for m in range(self.grid[dim]))

    @torch.no_grad()
    def write_(self, t: torch.Tensor, blocks, dim: Optional[int] = None, lo: int = 0,
               hi: int = 0) -> "Sharded":
        """Write ``t``, the box of ``blocks`` as :meth:`box` gathers it, back
        into those blocks' pieces.  With ``dim`` None each piece is replaced
        by its part of ``t``; else only the part of ``t`` within [lo, hi)
        of the whole tensor along ``dim`` is copied into the pieces, in
        place.  The moves to the owners are a collective-permute."""
        origin = tuple(min(b[k] for b in blocks) for k in range(len(self.grid)))
        for i, b in enumerate(self.blocks()):
            if b not in blocks:
                continue
            src = list(self._slices(tuple(x - o for x, o in zip(b, origin))))
            dst = [slice(None)] * len(self.grid)
            if dim is not None:
                start = self._slices(b)[dim].start
                a = max(lo - start, 0)
                z = min(hi - start, src[dim].stop - src[dim].start)
                if a >= z:
                    continue
                dst[dim] = slice(a, z)
                src[dim] = slice(src[dim].start + a, src[dim].start + z)
            part = move(t[tuple(src)], self.owner(b), "collective-permute")
            if dim is None:
                self.pieces[i] = part
            else:
                self.pieces[i][tuple(dst)].copy_(part)
        return self

    @torch.no_grad()
    def assign_(self, t: torch.Tensor) -> "Sharded":
        """Cut ``t`` (this tensor's shape) back into the pieces, in place."""
        for b, p in zip(self.blocks(), self.pieces):
            p.copy_(t[self._slices(b)])
        return self


def whole(x):
    """A :class:`Sharded` leaf whole on its first shard; a tensor as it is."""
    return x.full() if isinstance(x, Sharded) else x


def assign_(dst, t: torch.Tensor):
    """Write ``t`` into ``dst`` in place: cut into its pieces where ``dst``
    is :class:`Sharded`."""
    return dst.assign_(t) if isinstance(dst, Sharded) else dst.copy_(t)


def zeros_f32(x):
    """float32 zeros of ``x``'s shape on its device; of a :class:`Sharded`
    leaf, zeros in its cut, piece by piece."""
    if isinstance(x, Sharded):
        return x.map(zeros_f32)
    return torch.zeros(x.shape, dtype=torch.float32, device=x.device)


def full_tree(tree: Any, device) -> Any:
    """Every :class:`Sharded` leaf whole on ``device`` (other leaves moved
    there)."""
    return tree_map(lambda s: s.full(device) if isinstance(s, Sharded) else s.to(device), tree)


def pieces_of(tree: Any) -> List[torch.Tensor]:
    """The stored tensors of ``tree`` in walk order: the pieces of each
    :class:`Sharded` leaf, and every other leaf as it is."""
    return [p for s in leaves(tree) for p in (s.pieces if isinstance(s, Sharded) else (s,))]


def bytes_per_shard(tree: Any, mesh) -> List[int]:
    """Bytes of the pieces each shard of ``mesh`` stores, over the
    :class:`Sharded` leaves of ``tree``."""
    out = [0] * len(mesh.devices)
    for s in leaves(tree):
        for b, p in zip(s.blocks(), s.pieces):
            out[s.owner_index(b)] += p.numel() * p.element_size()
    return out
