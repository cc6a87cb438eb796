"""Atomic keep-last-k checkpoints of trees of tensors.

Port of ``repro.checkpoint.ckpt``, with the same layout:

  <dir>/step_<n>/
    manifest.json        tree structure + shapes + dtypes + step
    arrays.npz           flattened leaves (copied to the host)
  <dir>/step_<n>.tmp/    staging (atomic rename commits)
  <dir>/LATEST           text file with the last committed step

Fault-tolerance contract (train/trainer.py):
  * writes are staged to .tmp and committed by ``os.replace`` — a crash
    mid-write never corrupts the latest checkpoint;
  * ``restore`` reads LATEST, falls back to the newest complete step dir if
    LATEST is stale, and puts each leaf on the device of the target tree's
    leaf, or reshards it onto ``shardings`` or the target's own cut
    (elastic restarts onto a mesh of another shape);
  * keep-k pruning runs after commit, never before.

Leaves are walked in ``repro_torch.util.tree`` order (dicts by sorted key,
lists, tuples and the ``AdamWState`` NamedTuple in order).  numpy has no
bfloat16 without JAX's ``ml_dtypes``, so a bf16 leaf is stored as its uint16
bits with ``"bfloat16"`` in the manifest and restored bit for bit.  A
sharded state (``util.sharded.Sharded`` leaves) is saved leaf by leaf
whole, so a mesh and one device write the same files.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.util.sharded import Sharded
from repro_torch.util.tree import leaves, structure, tree_map

Params = Any


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """(host array, manifest dtype name) of one leaf, whole."""
    t = leaf.full("cpu") if isinstance(leaf, Sharded) else torch.as_tensor(leaf)
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def save(directory: str, step: int, tree: Params, *, keep: int = 3) -> str:
    """Atomically write a checkpoint; returns the committed path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    arrays = {}
    manifest = {"step": step, "leaves": []}
    for i, leaf in enumerate(leaves(tree)):
        arr, dtype_name = _to_numpy(leaf)
        arrays[f"leaf_{i}"] = arr
        manifest["leaves"].append(
            {"index": i, "shape": list(arr.shape), "dtype": dtype_name}
        )
    manifest["treedef"] = structure(tree)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    with open(os.path.join(directory, "LATEST.tmp"), "w") as f:
        f.write(str(step))
    os.replace(
        os.path.join(directory, "LATEST.tmp"), os.path.join(directory, "LATEST")
    )
    _prune(directory, keep)
    return final


def _prune(directory: str, keep: int) -> None:
    steps = sorted(all_steps(directory))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"), ignore_errors=True)


def all_steps(directory: str):
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, name, "manifest.json")):
                out.append(int(name.split("_")[1]))
    return sorted(out)


def latest_step(directory: str) -> Optional[int]:
    latest = os.path.join(directory, "LATEST")
    steps = all_steps(directory)
    if os.path.exists(latest):
        try:
            with open(latest) as f:
                s = int(f.read().strip())
            if s in steps:
                return s
        except ValueError:
            pass
    return max(steps) if steps else None


def restore(
    directory: str,
    target_tree: Params,
    *,
    step: Optional[int] = None,
    shardings: Optional[Params] = None,
) -> Tuple[Params, int]:
    """Load into the structure of ``target_tree``: each leaf's shape is
    checked and it is cast to the target leaf's dtype, then cut onto
    ``shardings`` (a tree of ``launch.sharding.NamedSharding`` with the
    target's structure) where given, else onto the target leaf's own cut
    where it is ``Sharded``, else put on the target leaf's device."""
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        dtypes = [leaf["dtype"] for leaf in json.load(f)["leaves"]]
    if len(dtypes) != len(leaves(target_tree)):
        raise ValueError(f"checkpoint has {len(dtypes)} leaves, the target "
                         f"{len(leaves(target_tree))}")
    counter = iter(range(len(dtypes)))
    cuts = iter(leaves(shardings) if shardings is not None else [None] * len(dtypes))
    with np.load(os.path.join(path, "arrays.npz")) as data:

        def load(leaf):
            i = next(counter)
            cut = next(cuts)
            arr = data[f"leaf_{i}"]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(
                    f"checkpoint leaf {i} shape {arr.shape} != target {tuple(leaf.shape)}"
                )
            t = _from_numpy(arr, dtypes[i]).to(dtype=leaf.dtype)
            if cut is None and isinstance(leaf, Sharded):
                cut = leaf
            if cut is not None:
                return Sharded.from_full(t, cut.mesh, cut.spec)
            return t.to(device=leaf.device)

        return tree_map(load, target_tree), step
