"""The mesh the distributed SpMV layer partitions rows over, and the one
device the LM tree's trainer runs on.

Port of the SpMV part of ``repro.launch.mesh`` (``make_host_mesh``).  The
reference builds a ``jax.sharding.Mesh`` over the devices JAX sees; here a
mesh is a plain frozen list of ``torch.device``s, one per row-block shard,
along a single ``"data"`` axis.  Several shards may share a device: with D
shards on one card, the distributed executor (``repro_torch.core.distributed``)
runs every shard there, and its x exchange is copies between buffers of that
card.  The trainer takes a one-shard mesh (``mesh_device``).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ShardMesh:
    """D row-block shards, shard d on ``devices[d]``, along ``axis_names[0]``."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = ("data",)

    @property
    def shape(self) -> dict:
        """``{axis: number of shards}``, so ``int(mesh.shape[axis])`` is D."""
        return {self.axis_names[0]: len(self.devices)}


def make_host_mesh(num_shards: int | None = None, device="cuda") -> ShardMesh:
    """A mesh over the visible devices of ``device``'s type.

    Args:
      num_shards: D, the number of row-block shards.  None gives one shard
        per visible device (on a one-card machine, one).  Shards are laid
        round-robin over the visible devices, so D may exceed their number.
      device: ``"cuda"`` (every visible card), ``"cuda:i"`` (that card only)
        or ``"cpu"``.  Raises if CUDA is asked for and absent.

    Returns:
      A :class:`ShardMesh` of D devices.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but CUDA is not available; "
                "pass device='cpu' to shard on the host"
            )
        visible = ([dev] if dev.index is not None else
                   [torch.device("cuda", i) for i in range(torch.cuda.device_count())])
    else:
        visible = [dev]
    D = len(visible) if num_shards is None else int(num_shards)
    if D < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    return ShardMesh(tuple(visible[d % len(visible)] for d in range(D)))


def mesh_device(mesh: ShardMesh) -> torch.device:
    """The one device of a one-shard mesh, where the LM tree's training state
    lives.  More shards raise: sharding the parameters comes with the port of
    ``launch/sharding.py``."""
    if len(mesh.devices) != 1:
        raise NotImplementedError(
            f"a mesh of {len(mesh.devices)} shards: the port's training path runs on one "
            "device; sharding comes with the port of launch/sharding.py")
    return mesh.devices[0]
