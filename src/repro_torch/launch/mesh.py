"""The meshes the distributed SpMV layer and the LM tree shard over.

Port of ``repro.launch.mesh`` (``make_host_mesh``, ``batch_axes``,
``rebuild_mesh_after_failure``).  The reference builds a
``jax.sharding.Mesh`` over the devices JAX sees; here a mesh is a plain
frozen grid of ``torch.device``s, one per shard, row-major over its named
axes.  The SpMV layer shards rows along a one-axis ``("data",)`` mesh; the
LM tree shards over ``("data", "model")`` (``("pod", "data", "model")``
where a pod axis is asked for).  Several shards may share a device: with D
shards on one card, every shard runs there and the reference's collectives
are copies between buffers of that card.  ``make_production_mesh`` gives the
dry run's 256- and 512-device meshes, whose shards are distinct indexed
``meta`` devices: they hold fake tensors only (``launch/dryrun.py``).
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ShardMesh:
    """Shards on ``devices``, row-major over ``axis_names`` of ``axis_sizes``.

    ``axis_sizes`` None is one axis of ``len(devices)`` shards (the SpMV
    layer's row-block mesh).
    """

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = ("data",)
    axis_sizes: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        if self.axis_sizes is None:
            object.__setattr__(self, "axis_sizes", (len(self.devices),))
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"axes {self.axis_names} with sizes {self.axis_sizes}")
        if math.prod(self.axis_sizes) != len(self.devices):
            raise ValueError(f"{len(self.devices)} devices for a mesh of shape "
                             f"{dict(zip(self.axis_names, self.axis_sizes))}")

    @property
    def shape(self) -> dict:
        """``{axis: number of shards}``, so ``int(mesh.shape[axis])`` is its size."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return len(self.devices)

    def coords(self, flat: int) -> dict:
        """``{axis: index}`` of shard ``flat`` (row-major)."""
        out = {}
        for name, n in reversed(tuple(zip(self.axis_names, self.axis_sizes))):
            flat, out[name] = divmod(flat, n)
        return {a: out[a] for a in self.axis_names}

    def coords_over(self, axes) -> list:
        """Every ``{axis: index}`` over ``axes`` (those of the mesh's axes
        named there), row-major: the shards of those axes in shard order."""
        axes = [a for a in self.axis_names if a in axes]
        return [dict(zip(axes, idx)) for idx in
                itertools.product(*(range(self.shape[a]) for a in axes))]

    def flat_index(self, **coords) -> int:
        """The row-major index of the shard at ``coords`` (an axis left out
        is 0)."""
        flat = 0
        for name, n in zip(self.axis_names, self.axis_sizes):
            flat = flat * n + int(coords.get(name, 0))
        return flat

    def device_at(self, **coords) -> torch.device:
        """The device of the shard at ``coords`` (an axis left out is 0)."""
        return self.devices[self.flat_index(**coords)]

    def select(self, **coords) -> "ShardMesh":
        """The sub-mesh at ``coords``: each axis named there cut to the one
        index given (size 1), the others whole, the axis names kept."""
        keep = [d for i, d in enumerate(self.devices)
                if all(self.coords(i)[a] == v for a, v in coords.items())]
        sizes = tuple(1 if a in coords else n for a, n in zip(self.axis_names, self.axis_sizes))
        return ShardMesh(tuple(keep), self.axis_names, sizes)


def _visible(device) -> Tuple[torch.device, ...]:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but CUDA is not available; "
                "pass device='cpu' to shard on the host"
            )
        return ((dev,) if dev.index is not None else
                tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count())))
    return (dev,)


def make_host_mesh(num_shards: int | None = None, device="cuda", *,
                   model: int | None = None) -> ShardMesh:
    """A mesh over the visible devices of ``device``'s type.

    Args:
      num_shards: the number of shards, the port's stand-in for the device
        count the reference's mesh takes.  None gives one shard per visible
        device (on a one-card machine, one).  Shards are laid round-robin
        over the visible devices, so there may be more shards than devices.
      device: ``"cuda"`` (every visible card), ``"cuda:i"`` (that card only)
        or ``"cpu"``.  Raises if CUDA is asked for and absent.
      model: None gives the SpMV layer's one-axis ``("data",)`` mesh of
        ``num_shards``; an int gives the reference's ``data × model`` mesh,
        ``model`` clamped to [1, num_shards] and ``data = num_shards //
        model`` (shards beyond ``data · model`` are left out).

    Returns:
      A :class:`ShardMesh`.
    """
    visible = _visible(device)
    n = len(visible) if num_shards is None else int(num_shards)
    if n < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    if model is None:
        return ShardMesh(tuple(visible[d % len(visible)] for d in range(n)))
    model = max(min(int(model), n), 1)
    data = n // model
    return ShardMesh(tuple(visible[d % len(visible)] for d in range(data * model)),
                     ("data", "model"), (data, model))


def make_meta_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...]) -> ShardMesh:
    """A mesh of ``shape`` over ``axes`` whose shard i is ``torch.device("meta",
    i)``: distinct devices that no tensor memory backs.  Only for use under
    ``FakeTensorMode``, which checks that an op's tensors share a device
    (plain ``meta`` tensors do not)."""
    n = math.prod(shape)
    return ShardMesh(tuple(torch.device("meta", i) for i in range(n)), tuple(axes), tuple(shape))


def make_production_mesh(*, multi_pod: bool = False) -> ShardMesh:
    """16 × 16 single-pod (256 devices, ``("data", "model")``) or 2 × 16 × 16
    multi-pod (512, ``("pod", "data", "model")``), the reference's shapes,
    on :func:`make_meta_mesh`'s devices: only for use under
    ``FakeTensorMode`` (the dry run)."""
    if multi_pod:
        return make_meta_mesh((2, 16, 16), ("pod", "data", "model"))
    return make_meta_mesh((16, 16), ("data", "model"))


def batch_axes(mesh: ShardMesh) -> Tuple[str, ...]:
    """Axes the batch dimension shards over (pod joins DP when present)."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def dp_size(mesh: ShardMesh) -> int:
    """The number of data-parallel shards (the product of ``batch_axes``)."""
    return math.prod(mesh.shape[a] for a in batch_axes(mesh) if a in mesh.shape)


def rebuild_mesh_after_failure(failed_fraction: float = 0.0, num_shards: int | None = None,
                               device="cuda") -> ShardMesh:
    """Elastic rebuild: re-form the largest data × model mesh from the live
    shards, keeping the model axis (of size 1) and shrinking data.

    The reference re-enumerates the devices JAX sees; the port's device set
    is ``num_shards`` shards of ``device`` (as in :func:`make_host_mesh`).
    ``int(num_shards · (1 − failed_fraction))`` of them (at least 1) live
    on, so 8 shards at 0.25 give data = 6.
    """
    visible = _visible(device)
    n = len(visible) if num_shards is None else int(num_shards)
    return make_host_mesh(max(int(n * (1 - failed_fraction)), 1), device, model=1)


def mesh_device(mesh: ShardMesh) -> torch.device:
    """The device of the mesh's first shard: where a one-shard state lives,
    and where a sharded state's step counter and host-facing values sit."""
    return mesh.devices[0]
