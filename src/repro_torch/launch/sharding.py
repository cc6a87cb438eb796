"""Parameter/activation sharding rules: path-name → PartitionSpec.

Port of ``repro.launch.sharding``, with the same rules and names.  Strategy:
FSDP over ``data`` (params ZeRO-sharded on the d_model axis), TP over
``model`` (heads / ffn / vocab / experts), DP across ``pod`` (params
replicated, gradients all-reduced inter-pod).  Optimizer state inherits the
param spec (ZeRO), so the rules here are the single source of truth for the
whole training state.

``sanitize_spec`` drops any mesh axis that does not divide the dim — e.g.
an embedding of 49,155 rows (granite's vocabulary) would fall back to
replicated-on-model on a model axis of 4; the model's padded vocabulary,
49,280, divides, so granite's embedding splits over model.

A spec is the port's ``util.sharded.PartitionSpec``, a tuple of per-dimension
entries (None, an axis name, or a tuple of axis names); a
:class:`NamedSharding` pairs one with a :class:`ShardMesh` where the
reference returns ``jax.sharding.NamedSharding``.  The rules read only
``mesh.shape`` and ``mesh.axis_names``.  The port's parameters keep one
entry per layer where the reference stacks layers on a leading axis; the
spec of a per-layer leaf is the reference's spec of its stacked leaf with
the stack dimension dropped (the stack dimension is never split), and
:func:`cache_spec` reads per-layer cache leaves the same way.  The tensors
stored as pieces by these specs are ``util/sharded.py``'s, and the train
step that gathers them is ``launch/sharded.py``'s.  :func:`tp_dim` reads a
leaf's spec to say which leaves that executor multiplies block by block on
the model shards (tensor parallelism) rather than gathering them whole.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

from repro_torch.launch.mesh import ShardMesh
from repro_torch.models.mamba import mamba_num_heads
from repro_torch.util.sharded import PartitionSpec
from repro_torch.util.tree import leaf_paths, leaves, tree_map

P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``jax.sharding.NamedSharding``)."""

    mesh: ShardMesh
    spec: PartitionSpec


# rules keyed by parameter leaf name; specs are for the *trailing* dims and
# leading dims (layer stacking, expert dim handled separately) get None.
_COL = ("data", "model")      # [D, out] — FSDP on in, TP on out
_ROW = ("model", "data")      # [in, D] — TP on in, FSDP on out
_NAME_RULES = {
    # embeddings [V, D]: vocab over model (TP logits), d_model over data
    "embedding": ("model", "data"),
    "unembedding": ("model", "data"),
    # attention / generic projections
    "wq": _COL, "wk": _COL, "wv": _COL, "wo": _ROW,
    # rwkv time/channel mixing
    "wr": _COL, "wg": _COL, "ck": _COL, "cr": _COL, "cv": _ROW,
    "w_lora_a": _COL, "w_lora_b": (None, None),
    # mlp / mamba projections
    "w_in": _COL, "w_gate": _COL, "w_out": _ROW,
    "w_B": _COL, "w_C": _COL, "w_dt": _COL,
    # router stays replicated (EP expects it everywhere)
    "router": (None, None),
    # 1-D params
    "bq": ("model",), "bk": ("model",), "bv": ("model",),
    "scale": (None,), "bias": (None,),
    "w0": (None,), "u": (None, None), "gn_scale": (None,),
    "mix": (None, None), "cmix": (None, None),
    "dt_bias": (None,), "A_log": (None,), "D_skip": (None,),
}
# MoE expert tensors are 3-D [E, in, out]: expert dim over model (EP).
_MOE_RULES = {
    "w_in": ("model", "data", None),
    "w_gate": ("model", "data", None),
    "w_out": ("model", None, "data"),
}


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def spec_split(spec, mesh) -> int:
    """The number of blocks ``spec`` cuts a leaf into on ``mesh``."""
    return math.prod(mesh.shape[a] for e in spec for a in _entry_axes(e))


def sanitize_spec(shape: Tuple[int, ...], spec: Tuple, mesh) -> PartitionSpec:
    """Drop axes that don't divide the dim; drop axes absent from the mesh."""
    out = []
    for dim, ax in zip(shape, spec):
        if ax is None:
            out.append(None)
            continue
        axes = tuple(a for a in _entry_axes(ax) if a in mesh.axis_names)
        size = math.prod(mesh.shape[a] for a in axes) if axes else 1
        if size > 1 and dim % size == 0:
            out.append(axes if len(axes) > 1 else axes[0])
        else:
            out.append(None)
    return PartitionSpec(*out)


def param_spec(path: Tuple, leaf: Any, mesh, fsdp_over_pod: bool = False) -> PartitionSpec:
    """The spec of the leaf at ``path`` (dict keys and list positions) of the
    port's parameters; ``leaf`` needs ``shape`` (a tensor on any device,
    ``meta`` included)."""
    names = list(path)
    name = names[-1] if names else ""
    in_moe = "moe" in names
    rule = None
    if in_moe and name in _MOE_RULES:
        rule = _MOE_RULES[name]
    elif name in _NAME_RULES:
        rule = _NAME_RULES[name]
    if rule is None:
        return PartitionSpec()
    if fsdp_over_pod and "pod" in mesh.axis_names:
        # ZeRO escalation: the FSDP axis grows to pod×data (params/optimizer
        # sharded across pods; gradients reduce-scattered the same way).
        rule = tuple(("pod", "data") if ax == "data" else ax for ax in rule)
    shape = tuple(leaf.shape)
    ndim = len(shape)
    pad = ndim - len(rule)
    if pad < 0:
        rule = rule[-ndim:] if ndim > 0 else ()
        pad = 0
    full = (None,) * pad + tuple(rule)
    return sanitize_spec(shape, full, mesh)


#: the leaves that run tensor-parallel over ``model``, by their parent's
#: name: (column blocks, row blocks).  Column blocks cut the output features
#: (whole heads, a slice of the ffn), row blocks the input features of the
#: projection back to d_model.
_TP_GROUPS = {
    "attn": (("wq", "wk", "wv", "bq", "bk", "bv"), ("wo",)),
    "mlp": (("w_in", "w_gate"), ("w_out",)),
    "mixer": (("w_in", "w_gate", "w_B", "w_C"), ("w_out",)),
}
#: rwkv6's leaves sit directly under the layer (their parent is a layer's
#: index, or nothing in one layer's subtree), so its two groups are found by
#: the config's ``rwkv`` flag; their names ``wk``, ``wv`` and ``wo`` are also
#: attention's, under ``attn``.
_RWKV_GROUPS = {
    "time_mix": (("wr", "wk", "wv", "wg"), ("wo",)),
    "channel_mix": (("ck", "cr"), ("cv",)),
}


def _tp_group(cfg, path: Tuple):
    """(group name, column blocks, row blocks) of the group whose leaf is at
    ``path``, or None."""
    name, parent = path[-1], (path[-2] if len(path) > 1 else None)
    if cfg.rwkv and not isinstance(parent, str):
        groups = _RWKV_GROUPS.items()
    else:
        groups = [(parent, _TP_GROUPS[parent])] if parent in _TP_GROUPS else []
    for group, (cols, rows) in groups:
        if name in cols + rows:
            return group, cols, rows
    return None


def _group_divides(cfg, group: str, model: int) -> bool:
    """Whether ``group``'s blocks cut whole heads (attention: whole GQA
    groups too) or, for rwkv6's channel mix, whether both of its widths
    split over ``model``."""
    if group == "attn":
        return cfg.num_heads % model == 0 and cfg.kv_heads % model == 0
    if group == "mixer":
        return mamba_num_heads(cfg.d_model, cfg.mamba_expand) % model == 0
    if group == "time_mix":
        return cfg.num_heads % model == 0
    if group == "channel_mix":
        return cfg.d_ff % model == 0 and cfg.d_model % model == 0
    return True


def tp_dim(cfg, path: Tuple, spec, mesh) -> Optional[int]:
    """The dimension along which the parameter leaf at ``path`` runs
    tensor-parallel over ``model`` (one block per model shard, each
    multiplied on its shard), or None where the leaf is used whole.

    ``path`` is the leaf's key path in the parameters or in one layer's
    subtree (its last two keys name the leaf and its parent); ``spec`` is
    the leaf's own :func:`param_spec`.  These groups run so, as the
    reference's rules lay out (heads / ffn / vocab over ``model``):

      * attention's ``wq``, ``wk``, ``wv`` (and ``bq``, ``bk``, ``bv``) by
        columns and ``wo`` by rows, where ``num_heads`` and ``kv_heads``
        both divide over ``model`` (each shard whole heads and whole GQA
        groups);
      * the MLP's ``w_in`` and ``w_gate`` by columns and ``w_out`` by rows
        (the dense MLP and the MoE ``shared_expert``);
      * the mamba mixer's ``w_in``, ``w_gate``, ``w_B`` and ``w_C`` by
        columns and ``w_out`` by rows, where its heads
        (``mamba_expand·d_model // 64``) divide over ``model``: each shard
        whole heads, their value, gate and state columns;
      * rwkv6's time mix, ``wr``, ``wk``, ``wv`` and ``wg`` by columns and
        ``wo`` by rows, where ``num_heads`` divides over ``model``;
      * rwkv6's channel mix, ``ck`` and ``cr`` by columns and ``cv`` by
        rows, where ``d_ff`` and ``d_model`` both divide (each of the three
        leaves' specs splits then, as the MLP runs where attention's heads
        do not divide);
      * ``embedding`` and ``unembedding`` by vocabulary rows.

    Each only where its spec splits that dimension over ``model``
    (``sanitize_spec`` keeps the split where the dimension divides).  Every
    other leaf is used whole, on the unit's device: the norms, the router,
    the MoE experts (which run expert-parallel), rwkv6's ``mix``, ``cmix``
    and its decay LoRA ``w_lora_a`` and ``w_lora_b`` (the decay is computed
    once, from all of d_model, before each shard takes its heads' columns of
    it; ``w_lora_a``'s split over a rank of 64 would save D·64 weights), the
    mamba mixer's step projection ``w_dt`` (D·H weights, whose product is
    likewise computed once and cut by heads: a block of one or two columns
    a shard goes through another GEMM than the whole product, and the scan
    magnifies a rounding of the step Δ through exp(−Δ·A) over a chunk), and
    the per-head vectors ``w0``, ``u``, ``gn_scale``, ``dt_bias``, ``A_log``
    and ``D_skip``, whose specs replicate them: a tensor-parallel layer
    hands each shard its heads' slice.  So is every leaf of the
    encoder–decoder, which runs on one device.  The answer depends only on
    the config and the mesh's shape."""
    if cfg.is_encdec or not path:
        return None
    name, parent = path[-1], (path[-2] if len(path) > 1 else None)
    group = None
    if name in ("embedding", "unembedding") and parent is None:
        dim = 0
    else:
        found = _tp_group(cfg, path)
        if found is None:
            return None
        group, cols, _ = found
        dim = len(spec) - 1 if name in cols else 0
    if not spec or spec[dim] != "model":
        return None
    if group is not None and not _group_divides(cfg, group, mesh.shape["model"]):
        return None
    return dim


def _map_with_path(fn, tree):
    paths = iter(leaf_paths(tree))
    return tree_map(lambda leaf: fn(next(paths), leaf), tree)


def params_shardings(params: Any, mesh, fsdp_over_pod: bool = False) -> Any:
    return _map_with_path(
        lambda path, leaf: NamedSharding(mesh, param_spec(path, leaf, mesh, fsdp_over_pod)),
        params)


def params_pspecs(params: Any, mesh, fsdp_over_pod: bool = False) -> Any:
    return _map_with_path(lambda path, leaf: param_spec(path, leaf, mesh, fsdp_over_pod),
                          params)


def state_bytes_per_device(params: Any, shardings: Any, mesh,
                           opt_multiplier: float = 5.0) -> int:
    """Persistent training-state bytes/device: params + f32 mu/nu (+grad),
    under the given shardings. ``opt_multiplier``≈(2·4+2)/2 for bf16 params."""
    total = 0
    for leaf, sh in zip(leaves(params), leaves(shardings)):
        n = spec_split(sh.spec, mesh)
        total += math.prod(leaf.shape) * leaf.element_size() // n
    return int(total * opt_multiplier)


# ---------------------------------------------------------------------------
# cache sharding (decode)
# ---------------------------------------------------------------------------


def cache_spec(path: Tuple, leaf: Any, mesh, batch: int) -> PartitionSpec:
    """Decode-cache sharding of one per-layer cache leaf.

    Attention K/V [B, S, kv, hd]: batch over DP axes when divisible;
    the ``model`` axis goes on kv-heads when divisible, else on S (sequence
    parallelism — the long_500k path where B=1 also moves DP onto S).
    Recurrent states (S/x_prev, batch first) shard batch only (they are
    O(1) per seq).
    """
    name = path[-1] if path else ""
    shape = tuple(leaf.shape)
    dp = ("pod", "data") if "pod" in mesh.axis_names else ("data",)
    dp_size = math.prod(mesh.shape[a] for a in dp)
    ndim = len(shape)
    spec = [None] * ndim
    if name in ("k", "v") and ndim >= 4:
        b_dim, s_dim, kv_dim = ndim - 4, ndim - 3, ndim - 2
        if batch % dp_size == 0:
            spec[b_dim] = dp if len(dp) > 1 else dp[0]
            if shape[kv_dim] % mesh.shape["model"] == 0:
                spec[kv_dim] = "model"
            elif shape[s_dim] % mesh.shape["model"] == 0:
                spec[s_dim] = "model"
        else:
            # tiny batch (long_500k): sequence-shard over everything
            all_axes = tuple(mesh.axis_names)
            size = math.prod(mesh.shape[a] for a in all_axes)
            if shape[s_dim] % size == 0:
                spec[s_dim] = all_axes
    elif ndim >= 1 and shape[0] % dp_size == 0 and shape[0] >= dp_size:
        # recurrent state [B, H, K, V] or x_prev [B, D]
        spec[0] = dp if len(dp) > 1 else dp[0]
    return sanitize_spec(shape, tuple(spec), mesh)


def cache_shardings(cache: Any, mesh, batch: int) -> Any:
    """The :class:`NamedSharding` of every leaf of a decode cache
    (``init_cache``'s per-layer entries) by :func:`cache_spec`."""
    return _map_with_path(lambda path, leaf: NamedSharding(mesh, cache_spec(path, leaf, mesh, batch)),
                          cache)


def cache_pspecs(cache: Any, mesh, batch: int) -> Any:
    """The :func:`cache_spec` of every leaf of a decode cache (the cut
    ``sharded.shard_tree`` takes for the serve steps' cache in pieces)."""
    return _map_with_path(lambda path, leaf: cache_spec(path, leaf, mesh, batch), cache)


def batch_sharding(mesh) -> NamedSharding:
    dp = ("pod", "data") if "pod" in mesh.axis_names else ("data",)
    return NamedSharding(mesh, PartitionSpec(dp if len(dp) > 1 else dp[0]))
