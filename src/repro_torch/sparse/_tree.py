"""Tensor-leaf helpers for the frozen container dataclasses.

JAX containers are pytrees; the port's containers are plain frozen
dataclasses whose fields hold ``torch.Tensor``s (or tuples of them, or
nested containers).  These two helpers are the only tree walking the port
needs: moving a container between devices and summing its resident bytes.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterator

import torch


def map_tensors(obj, fn: Callable[[torch.Tensor], torch.Tensor]):
    """Return ``obj`` with ``fn`` applied to every tensor leaf."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, tuple):
        return tuple(map_tensors(o, fn) for o in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        changes = {
            f.name: map_tensors(getattr(obj, f.name), fn)
            for f in dataclasses.fields(obj)
        }
        return dataclasses.replace(obj, **changes)
    return obj


def tensor_leaves(obj) -> Iterator[torch.Tensor]:
    """Yield every tensor leaf of ``obj`` (containers, tuples, tensors)."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, tuple):
        for o in obj:
            yield from tensor_leaves(o)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from tensor_leaves(getattr(obj, f.name))


def to_device(obj, device):
    """Move every tensor leaf of a container to ``device``."""
    return map_tensors(obj, lambda t: t.to(device))


def host(t: torch.Tensor):
    """A tensor's values as a host numpy array (no copy for CPU tensors)."""
    return t.detach().cpu().numpy()
