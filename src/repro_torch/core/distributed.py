"""Distributed SpMV: a prepared operator's rows partitioned into D shards.

Port of ``repro.core.distributed``.  Two levels live here, as there:

1. The low-level :class:`ShardedCSR` + ``dist_spmv_*`` functions: a plain
   row-partitioned CSR run through the segment-sum product
   :func:`_local_spmv` per shard (the historical entry points).

2. The prepared-operator integration: :func:`shard_prepared` wraps a
   single-device :class:`~repro_torch.core.spmv.PreparedSpMV` into a
   :class:`ShardedPreparedSpMV` that partitions the operator's *kernel tile
   view* into per-shard tile sets and runs the CUDA CSR-k / SELL-C-σ
   kernels on each.  ``prepare(A, mesh=...)`` is the public spelling.

Execution is organised around a :class:`ShardPlan` built once at
``shard_prepared`` time; its host-side logic (strategy choice, halo size,
need-based edges, the interior/boundary tile split, the byte model) is the
reference's, line for line, and gives the reference's plan.

The reference runs the plan on a JAX mesh inside ``shard_map``: one
controller, one program per device, ``ppermute``/``all_gather`` for x.  The
port's mesh (:class:`repro_torch.launch.mesh.ShardMesh`) is a list of
devices, one per shard, which several shards may share, and the executor is
one loop over the shards on the current stream.  Each shard's arrays live
on its device and each shard gets its own x buffer there, laid out per
strategy:

  * **replicated**: x itself;
  * **all-gather**: a copy of all of x (every shard's slice);
  * **halo**: ``[left halo | own slice | right halo]`` at rows
    ``d·Rs − H … (d+1)·Rs + H`` of a zero buffer of x's length, a side only
    where the plan schedules its edge.

The exchange is ``copy_`` of x's rows into that buffer: on one device a
copy within the card.  Zeros outside the window make a wrong halo, or a
wrong interior classification, show up as wrong bits; the CSR-k and
SELL-C-σ kernels read only real slots, so with a right plan those zeros are
never read and the sharded result equals the single-device one bit for bit.
An overlap plan makes two launches per shard (interior tiles against a
buffer that holds only the shard's own slice, boundary tiles against the
halo window); a blocking plan one.  Empty subsets are not launched, and no
zero tiles pad a subset: the kernels take any T.  Every launch writes its
tiles' rows into one shared y in place, so nothing is scattered afterwards.
Nothing in a call waits on the host, so with no COO remainder a call can be
captured in a CUDA graph.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.ops import _fold_remainder, _pad_rows
from repro_torch.kernels.spmv_csrk import X_KIND, spmv_csrk_tiles
from repro_torch.kernels.spmv_sellcs import spmv_sellcs_chunks
from repro_torch.obs import get_registry
from repro_torch.sparse._tree import host
from repro_torch.sparse.csr import CSRMatrix
from repro_torch.sparse.csrk import _round_up
from repro_torch.sparse.stats import (
    MatrixStats,
    classify_tile_reach,
    compute_shard_stats,
    compute_stats,
)

_LANE = 128


@dataclasses.dataclass(frozen=True)
class ShardedCSR:
    """Row-partitioned CSR: per-shard padded arrays stacked on axis 0."""

    row_ptr: torch.Tensor   # [D, rows_per_shard+1] int32
    col_idx: torch.Tensor   # [D, max_nnz] int32
    vals: torch.Tensor      # [D, max_nnz]
    shape: Tuple[int, int]
    rows_per_shard: int
    halo: int               # max distance a column reaches outside the shard's rows


def shard_csr(A: CSRMatrix, num_shards: int) -> ShardedCSR:
    """Partition rows contiguously into ``num_shards`` padded shards.

    Args:
      A: the (already reordered) global CSR matrix.
      num_shards: number of contiguous row blocks.

    Returns:
      A :class:`ShardedCSR` on A's device whose stacked arrays have leading
      dimension ``num_shards``; padding nnz slots carry ``vals == 0`` so they
      are inert.  The arrays equal the reference's.
    """
    m, n = A.shape
    rp = host(A.row_ptr)
    ci = host(A.col_idx)
    vl = host(A.vals)
    rows_per_shard = -(-m // num_shards)
    max_nnz = 0
    for d in range(num_shards):
        r0, r1 = min(d * rows_per_shard, m), min((d + 1) * rows_per_shard, m)
        max_nnz = max(max_nnz, int(rp[r1] - rp[r0]))
    max_nnz = max(_round_up(max_nnz, _LANE), _LANE)

    s_rp = np.zeros((num_shards, rows_per_shard + 1), np.int32)
    s_ci = np.zeros((num_shards, max_nnz), np.int32)
    s_vl = np.zeros((num_shards, max_nnz), vl.dtype)
    halo = 0
    for d in range(num_shards):
        r0, r1 = min(d * rows_per_shard, m), min((d + 1) * rows_per_shard, m)
        base = rp[r0]
        local_rp = rp[r0 : r1 + 1] - base
        s_rp[d, : r1 - r0 + 1] = local_rp
        s_rp[d, r1 - r0 + 1 :] = local_rp[-1]
        k = int(rp[r1] - base)
        s_ci[d, :k] = ci[base : base + k]
        s_vl[d, :k] = vl[base : base + k]
        if k:
            lo, hi = int(s_ci[d, :k].min()), int(s_ci[d, :k].max())
            halo = max(halo, r0 - lo, hi - (r1 - 1))
    dev = A.vals.device
    return ShardedCSR(
        torch.from_numpy(s_rp).to(dev), torch.from_numpy(s_ci).to(dev),
        torch.from_numpy(s_vl).to(dev), (m, n), rows_per_shard, max(halo, 0),
    )


def _local_spmv(row_ptr, col_idx, vals, x_full, col_offset: int = 0):
    """Segmented SpMV on one padded shard; padding rows produce 0.

    ``x_full`` may be a vector ([L]) or a multi-vector block ([L, B]).  Slot
    s belongs to the row whose range holds it, and the padding slots past the
    last row's end to the last row (their vals are 0, so they are inert);
    column indices are clamped into ``[0, L)`` as ``jnp.take(mode="clip")``
    clamps them.  Plain torch, as the reference's plain ``jnp``; on CUDA
    ``index_add_`` adds with float atomics, so the sum order is not fixed.
    """
    Rs = row_ptr.shape[0] - 1
    slot = torch.arange(col_idx.shape[0], dtype=row_ptr.dtype, device=col_idx.device)
    rows = torch.searchsorted(row_ptr[1:], slot, right=True).clamp_(max=Rs - 1)
    idx = (col_idx.long() - col_offset).clamp_(0, x_full.shape[0] - 1)
    gathered = x_full[idx]
    contrib = (vals[:, None] if x_full.ndim == 2 else vals) * gathered
    out = torch.zeros((Rs,) + tuple(x_full.shape[1:]), dtype=contrib.dtype,
                      device=contrib.device)
    return out.index_add_(0, rows, contrib)


# ---------------------------------------------------------------------------
# the staged execution plan
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """Static schedule for one sharded SpMV operator, built at prepare time.

    The resolved x strategy, the tile partition geometry, the
    interior/boundary tile split and the halo edge schedule live here, and
    one executor interprets them.  Replicated and all-gather strategies are
    degenerate plans (no tile split, no edges).

    Attributes:
      strategy: resolved x distribution ("replicated" | "allgather" | "halo").
      num_shards / rows_per_shard: partition geometry (tile-granular rows).
      halo: exchanged rows per neighbour edge (0 unless strategy is "halo").
      tiles_per_shard / rows_per_tile: kernel tile geometry (0 for the CSR
        path, which has no tile view).
      overlap: True runs each shard's interior tiles against its own x slice
        and its boundary tiles against the halo window, as two launches;
        False runs one launch per shard after x is distributed.
      interior_ids / boundary_ids: per-shard int32 arrays of *local* tile ids
        (set whenever the tile reach was classified, independent of
        ``overlap``).
      interior_fraction: fraction of non-empty tiles that are interior.
      left_edges / right_edges: ``(src, dst)`` pairs delivering each
        receiver's left resp. right halo; need-based for tile backends.
    """

    strategy: str
    num_shards: int
    rows_per_shard: int
    halo: int = 0
    tiles_per_shard: int = 0
    rows_per_tile: int = 0
    overlap: bool = False
    interior_fraction: float = 1.0
    interior_ids: Tuple = ()
    boundary_ids: Tuple = ()
    left_edges: Tuple[Tuple[int, int], ...] = ()
    right_edges: Tuple[Tuple[int, int], ...] = ()

    @property
    def is_degenerate(self) -> bool:
        """True when no halo schedule exists (replicated / allgather plans)."""
        return self.strategy != "halo"

    @property
    def num_interior(self) -> int:
        """Max interior tiles on any shard."""
        return max((len(i) for i in self.interior_ids), default=0)

    @property
    def num_boundary(self) -> int:
        """Max boundary tiles on any shard."""
        return max((len(b) for b in self.boundary_ids), default=0)

    def collective_bytes(self, B: int = 1, itemsize: int = 4) -> int:
        """Modeled bytes moved by the x collective per SpMV/SpMM call.

        halo: ``halo`` rows per *scheduled edge*; allgather: every shard
        receives the other D−1 shards' rows; replicated: 0.  The reference's
        model: on one device the executor copies more (see
        :meth:`ShardedPreparedSpMV.x_copy_bytes_per_call`).
        """
        per_row = itemsize * max(B, 1)
        if self.strategy == "halo":
            n_edges = len(self.left_edges) + len(self.right_edges)
            return self.halo * n_edges * per_row
        if self.strategy == "allgather":
            D, R = self.num_shards, self.rows_per_shard
            return (D - 1) * R * D * per_row
        return 0


def _ring_edges(D: int):
    """Full bidirectional ring schedule (legacy ``dist_spmv_halo`` semantics).

    ``left``: every shard sends its tail to the right neighbour (each
    receiver gets its left halo); ``right``: mirrored.  Includes the
    wraparound pair, harmless because wraparound columns are never real.
    """
    left = tuple((i, (i + 1) % D) for i in range(D))
    right = tuple((i, (i - 1) % D) for i in range(D))
    return left, right


def _concrete(dev) -> torch.device:
    """``dev`` with the index a tensor placed there reports ("cuda" → "cuda:0")."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _mesh_devices(mesh, axis: str):
    """The device of each of the mesh's shards along ``axis``."""
    D = int(mesh.shape[axis])
    devices = tuple(_concrete(d) for d in mesh.devices)
    if len(devices) != D:
        raise ValueError(f"mesh has {len(devices)} devices for {D} shards along {axis!r}")
    return devices


def _csr_plan_call(plan: ShardPlan, devices, shards, x: torch.Tensor, m: int):
    """Run a plan over raw CSR shards (the legacy entry points' path and the
    prepared operator's CSR path): ``shards[d]`` is shard d's ``(row_ptr,
    col_idx, vals)`` on ``devices[d]``.  Returns ``[m(, B)]`` on x's device.

    replicated: each shard reads x itself; allgather: the shards' slices of
    x (padded to ``D·Rs`` rows) concatenated; halo: ``[left | own | right]``
    with the reference's clamped column offset ``d·Rs − H``, a side taken
    from the edge's source shard (zeros where no edge delivers it).
    """
    D, Rs, H = plan.num_shards, plan.rows_per_shard, plan.halo
    xin = x if plan.strategy == "replicated" else _pad_rows(x, D * Rs)
    left_src = {dst: src for src, dst in plan.left_edges}
    right_src = {dst: src for src, dst in plan.right_edges}
    tail = tuple(x.shape[1:])
    y = torch.empty((D * Rs,) + tail, dtype=x.dtype, device=x.device)
    for d, dev in enumerate(devices):
        rp, ci, vl = shards[d]
        if plan.strategy == "halo":
            s = left_src.get(d)
            left = (xin[s * Rs + Rs - H : s * Rs + Rs].to(dev) if s is not None
                    else xin.new_zeros((H,) + tail, device=dev))
            s = right_src.get(d)
            right = (xin[s * Rs : s * Rs + H].to(dev) if s is not None
                     else xin.new_zeros((H,) + tail, device=dev))
            x_win = torch.cat([left, xin[d * Rs : (d + 1) * Rs].to(dev), right])
            y_d = _local_spmv(rp, ci, vl, x_win, col_offset=d * Rs - H)
        elif plan.strategy == "allgather":
            x_full = torch.cat([xin[s * Rs : (s + 1) * Rs].to(dev) for s in range(D)])
            y_d = _local_spmv(rp, ci, vl, x_full)
        else:
            y_d = _local_spmv(rp, ci, vl, xin.to(dev))
        y[d * Rs : (d + 1) * Rs].copy_(y_d)
    return y[:m]


def _csr_shards(A: ShardedCSR, devices):
    return [tuple(t[d].to(dev) for t in (A.row_ptr, A.col_idx, A.vals))
            for d, dev in enumerate(devices)]


def dist_spmv_allgather(A: ShardedCSR, x: torch.Tensor, mesh, axis: str = "data"):
    """y = A x with x row-sharded; all-gather x then local SpMV (baseline).

    ``x`` may be [n] or [n, B]; the collective moves the whole padded x
    (O(n·B) bytes) regardless of the band structure.  Thin shim over the
    degenerate all-gather :class:`ShardPlan`.
    """
    devices = _mesh_devices(mesh, axis)
    plan = ShardPlan("allgather", len(devices), A.rows_per_shard)
    return _csr_plan_call(plan, devices, _csr_shards(A, devices), x, A.shape[0])


def dist_spmv_halo(A: ShardedCSR, x: torch.Tensor, mesh, axis: str = "data"):
    """Banded halo exchange: neighbours swap ≤halo columns.

    Valid when ``A.halo <= A.rows_per_shard``; otherwise it falls back to
    :func:`dist_spmv_allgather`.  ``x`` may be [n] or [n, B].  Thin shim over
    a full-ring halo :class:`ShardPlan`, as in the reference.
    """
    devices = _mesh_devices(mesh, axis)
    D, R = len(devices), A.rows_per_shard
    H = _round_up(max(A.halo, 1), _LANE)
    if H > R:
        # band too wide for single-neighbour halo — fall back
        return dist_spmv_allgather(A, x, mesh, axis)
    left, right = _ring_edges(D)
    plan = ShardPlan("halo", D, R, halo=H, left_edges=left, right_edges=right)
    return _csr_plan_call(plan, devices, _csr_shards(A, devices), x, A.shape[0])


# ---------------------------------------------------------------------------
# prepared-operator integration: prepare(A, mesh=...) → ShardedPreparedSpMV
# ---------------------------------------------------------------------------

X_STRATEGIES = ("replicated", "allgather", "halo")

#: Below this n, replicating x everywhere is cheaper than any collective
#: bookkeeping (the iterative-solver regime the paper motivates with).
REPLICATE_N_MAX = 1 << 14

#: Minimum fraction of non-empty tiles that must be interior for the staged
#: overlap schedule to be worth its second kernel launch.
OVERLAP_MIN_INTERIOR = 0.25


def select_x_strategy(
    stats: MatrixStats, num_shards: int, rows_per_shard: int
) -> str:
    """O(1) x-distribution choice from matrix statistics (band width vs n).

    Policy (first match wins):

    * one shard → ``"replicated"``;
    * ``round_up(bandwidth, 128) ≤ rows_per_shard`` → ``"halo"``;
    * ``n ≤ REPLICATE_N_MAX`` → ``"replicated"``;
    * otherwise → ``"allgather"``.
    """
    if num_shards <= 1:
        return "replicated"
    if _round_up(max(int(stats.bandwidth), 1), _LANE) <= rows_per_shard:
        return "halo"
    if stats.n <= REPLICATE_N_MAX:
        return "replicated"
    return "allgather"


def estimate_interior_fraction(
    stats: MatrixStats, num_shards: int, rows_per_shard: int
) -> float:
    """O(1) estimate of the interior tile fraction from the bandwidth alone:
    at most ``2·round_up(bw, 128)`` of each shard's rows are boundary rows."""
    if num_shards <= 1:
        return 1.0
    bw = _round_up(max(int(stats.bandwidth), 1), _LANE)
    return max(0.0, 1.0 - 2.0 * bw / max(rows_per_shard, 1))


def _required_halo(reach, rows_per_shard: int, num_shards: int) -> int:
    """Max column overhang of any shard's *real* (val ≠ 0) entries, in rows.

    ``reach`` is a per-shard list of ``(lo, hi)`` real-column extents (or
    None for empty shards).
    """
    H = 0
    for d, r in enumerate(reach):
        if r is None:
            continue
        lo, hi = r
        r0, r1 = d * rows_per_shard, (d + 1) * rows_per_shard
        H = max(H, r0 - lo, hi + 1 - r1)
    return max(H, 0)


def _halo_edges(reach, rows_per_shard: int, num_shards: int):
    """Need-based halo schedule: one edge per side a shard actually reads.

    Shard d gets a ``(d−1, d)`` left edge only if some real column of its
    tiles lies below ``d·rows_per_shard`` (mirrored on the right).
    """
    left, right = [], []
    for d, r in enumerate(reach):
        if r is None:
            continue
        lo, hi = r
        if lo < d * rows_per_shard and d > 0:
            left.append((d - 1, d))
        if hi >= (d + 1) * rows_per_shard and d + 1 < num_shards:
            right.append((d + 1, d))
    return tuple(left), tuple(right)


def _shard_reach(lo, hi, tiles_per_shard: int, num_shards: int):
    """Per-shard ``(lo, hi)`` real-column extents from per-tile reach."""
    lo = np.asarray(lo)
    hi = np.asarray(hi)
    T = int(lo.shape[0])
    out = []
    for d in range(num_shards):
        t0, t1 = d * tiles_per_shard, min((d + 1) * tiles_per_shard, T)
        sl, sh = lo[t0:t1], hi[t0:t1]
        real = sh >= sl
        if real.any():
            out.append((int(sl[real].min()), int(sh[real].max())))
        else:
            out.append(None)
    return out


def _x_rows(plan: ShardPlan, d: int, subset: str, n: int):
    """The x rows ``[lo, hi)`` shard d's launch of ``subset`` reads, or None
    for x itself (replicated).  ``subset`` is "" (blocking), "i_" (interior:
    the own slice) or "b_" (boundary: the halo window)."""
    Rs, H = plan.rows_per_shard, plan.halo
    if plan.strategy == "replicated":
        return None
    if plan.strategy == "allgather":
        return (0, n)
    if subset == "i_":
        return (min(d * Rs, n), min((d + 1) * Rs, n))
    lo = d * Rs - (H if (d - 1, d) in plan.left_edges else 0)
    hi = (d + 1) * Rs + (H if (d + 1, d) in plan.right_edges else 0)
    return (min(lo, n), min(hi, n))


def _x_buffer(x: torch.Tensor, rows, dev: torch.device) -> torch.Tensor:
    """x's rows ``[lo, hi)`` at their own positions in a zero buffer of x's
    shape on ``dev``: all of x when they are every row, x itself when
    ``rows`` is None."""
    if rows is None:
        return x.to(dev)
    lo, hi = rows
    if (lo, hi) == (0, x.shape[0]):
        return x.to(dev, copy=True)
    buf = x.new_zeros(x.shape, device=dev)
    if hi > lo:
        buf[lo:hi].copy_(x[lo:hi])
    return buf


@dataclasses.dataclass(frozen=True)
class ShardedPreparedSpMV:
    """A prepared SpMV operator partitioned into D row-block shards.

    Built by :func:`shard_prepared` (or ``prepare(A, mesh=...)``).  The
    global operator's kernel tile view is split into per-shard tile sets and
    run with the *same* CUDA kernels, so results are bit-for-bit identical to
    the single-device ``base`` operator on the tile backends.

    Shapes: ``__call__`` accepts ``x`` of shape [n] or [n, B] (reordered index
    space) and returns [m] resp. [m, B]; ``apply_original`` works in the
    matrix's original index space, exactly like :class:`PreparedSpMV`.  On
    CUDA, x is float32 or bfloat16 and y comes out in x's dtype, as for the
    single-device operator.

    Attributes:
      base: the single-device :class:`~repro_torch.core.spmv.PreparedSpMV`.
      mesh / axis: the :class:`~repro_torch.launch.mesh.ShardMesh` and the
        axis name rows are partitioned over.
      x_strategy_requested: what the caller asked for; the *resolved*
        strategy lives on ``plan.strategy``.
      plan: the :class:`ShardPlan`.
      shard_stats / shard_backends: per-shard one-pass statistics and the
        registry's per-shard format decisions (introspection).
      shard_arrays: per shard, a dict of its kernel arrays on its device,
        under the reference's names without the leading shard axis
        (CSR-k blocking ``vals/lcol/lrow/win`` (+ ``scale``); overlap
        ``i_*``/``b_*`` and ``i_ids``/``b_ids``; SELL-C-σ ``vals/cols``
        (+ ``scale``), overlap ``i_*``/``b_*``) plus the port's own:
        ``nnz`` (CSR-k ``tile_nnz``), ``perm``/``width`` (SELL-C-σ
        ``row_perm`` rows and ``chunk_width``) and ``ids`` for blocking.
      c_csr: raw CSR shards for the CSR path (no tile view).
    """

    base: "object"                    # PreparedSpMV (kept untyped: no cycle)
    mesh: "object"                    # ShardMesh
    axis: str
    x_strategy_requested: str
    plan: ShardPlan
    shard_stats: Tuple[Optional[MatrixStats], ...]
    shard_backends: Tuple[str, ...]
    shard_arrays: Tuple[dict, ...] = ()
    c_csr: Optional[ShardedCSR] = None

    def __post_init__(self):
        devices = _mesh_devices(self.mesh, self.axis)
        object.__setattr__(self, "_devices", devices)
        if self.c_csr is not None:
            object.__setattr__(self, "_csr", _csr_shards(self.c_csr, devices))
            return
        # per shard: (device, arrays, ((subset, x rows), ...)) of its launches
        n = self.base.tiles.shape[1] if self.backend == "csrk" else self.base.sell_tiles.shape[1]
        object.__setattr__(self, "_n", n)
        subsets = ("i_", "b_") if self.plan.overlap else ("",)
        launches = []
        for d, (dev, arrs) in enumerate(zip(devices, self.shard_arrays)):
            run = tuple((s, _x_rows(self.plan, d, s, n)) for s in subsets
                        if arrs[s + "ids"].numel())
            launches.append((dev, arrs, run))
        object.__setattr__(self, "_launches", tuple(launches))

    # -- delegated introspection --------------------------------------------
    @property
    def backend(self) -> str:
        """The base operator's backend.  Only ``"csrk"`` and ``"sellcs"``
        carry a shardable tile view; the others run the CSR path."""
        return self.base.backend

    @property
    def stats(self):
        """Global :class:`MatrixStats` (post-reordering) of the base operator."""
        return self.base.stats

    @property
    def perm(self) -> np.ndarray:
        return self.base.perm

    @property
    def params(self):
        return self.base.params

    @property
    def num_shards(self) -> int:
        return self.plan.num_shards

    @property
    def x_strategy(self) -> str:
        """The resolved x distribution ("replicated" | "allgather" | "halo")."""
        return self.plan.strategy

    @property
    def rows_per_shard(self) -> int:
        return self.plan.rows_per_shard

    @property
    def halo(self) -> int:
        return self.plan.halo

    @property
    def overlap(self) -> bool:
        """True when each shard runs interior and boundary tiles apart."""
        return self.plan.overlap

    @property
    def interior_fraction(self) -> float:
        return self.plan.interior_fraction

    def collective_bytes_per_call(self, B: int = 1, itemsize: int = 4) -> int:
        """Modeled bytes moved by the x collective per call
        (:meth:`ShardPlan.collective_bytes`, the reference's model)."""
        return self.plan.collective_bytes(B, itemsize)

    def x_copy_bytes_per_call(self, B: int = 1, itemsize: int = 4) -> int:
        """Bytes of x this executor copies into shard buffers per call (the
        zero fill of halo buffers not counted): replicated x is read in
        place on x's own device."""
        per_row = itemsize * max(B, 1)
        if self.c_csr is not None:
            # x padded to D·Rs rows once, then each shard's window or gather
            D, Rs, H = self.plan.num_shards, self.plan.rows_per_shard, self.plan.halo
            n = self.c_csr.shape[1]
            if self.plan.strategy == "halo":
                return (n + D * (Rs + 2 * H)) * per_row
            return (n + D * D * Rs) * per_row if self.plan.strategy == "allgather" else 0
        rows = 0
        for dev, _, run in self._launches:
            for _, r in run:
                if r is not None:
                    rows += r[1] - r[0]
                elif dev != _concrete(self.base.device):
                    rows += self._n
        return rows * per_row

    # -- execution -----------------------------------------------------------
    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """Sharded SpMV / SpMM in the reordered index space ([n] or [n, B])."""
        if x.device.type != self.base.device.type:
            raise ValueError(f"x is on {x.device}, the operator on {self.base.device}")
        if x.device.type == "cuda" and x.dtype not in X_KIND:
            raise TypeError(f"x must be float32 or bfloat16 on CUDA, got {x.dtype}")
        if x.ndim not in (1, 2):
            raise ValueError(f"x must be [n] or [n, B], got shape {tuple(x.shape)}")
        if self.c_csr is not None:
            return _csr_plan_call(self.plan, self._devices, self._csr, x,
                                  self.c_csr.shape[0])
        x = x.contiguous()
        if self.backend == "csrk":
            return self._call_csrk(x)
        return self._call_sellcs(x)

    def _call_csrk(self, x: torch.Tensor) -> torch.Tensor:
        tiles = self.base.tiles
        T, R = tiles.num_tiles, tiles.rows_per_tile
        Tp = self.plan.tiles_per_shard
        y = torch.empty((T * R,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
        for d, (dev, a, run) in enumerate(self._launches):
            # shard d's tiles write rows [d·Tp·R, …) of y: local ids into that view
            view = y[min(d * Tp, T) * R : min((d + 1) * Tp, T) * R]
            out = view if dev == x.device else torch.empty(view.shape, dtype=x.dtype, device=dev)
            for s, rows in run:
                spmv_csrk_tiles(
                    a[s + "vals"], a[s + "lcol"], a[s + "lrow"], a[s + "win"],
                    _x_buffer(x, rows, dev), a.get(s + "scale"),
                    rows_per_tile=R, window=tiles.window, tile_nnz=a[s + "nnz"],
                    tile_ids=a[s + "ids"], out=out,
                )
            if out is not view:
                view.copy_(out)
        y = y[: tiles.shape[0]]
        return _fold_remainder(y, tiles.rem_row, tiles.rem_col, tiles.rem_val, x)

    def _call_sellcs(self, x: torch.Tensor) -> torch.Tensor:
        m = self.base.sell_tiles.shape[0]
        y = torch.empty((m,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
        for dev, a, run in self._launches:
            out = y if dev == x.device else torch.empty(y.shape, dtype=x.dtype, device=dev)
            for s, rows in run:
                spmv_sellcs_chunks(
                    a[s + "vals"], a[s + "cols"], a[s + "perm"], a[s + "width"],
                    _x_buffer(x, rows, dev), a.get(s + "scale"), m=m, out=out,
                )
                if out is not y:
                    real = a[s + "real"]
                    y.index_copy_(0, real.to(x.device), out.index_select(0, real).to(x.device))
        return y

    def matmat(self, X: torch.Tensor) -> torch.Tensor:
        """Explicit multi-vector alias: Y = A X for X of shape [n, B]."""
        if X.ndim != 2:
            raise ValueError(f"matmat expects a [n, B] block, got shape {tuple(X.shape)}")
        return self(X)

    def apply_original(self, x_old: torch.Tensor) -> torch.Tensor:
        """SpMV / SpMM for vectors indexed in the matrix's original ordering."""
        y_new = self(x_old[self.base._perm_dev])
        return y_new[self.base._inv_perm_dev]


def _shard_tile_arrays(base, plan: ShardPlan, devices, T: int) -> Tuple[dict, ...]:
    """Each shard's kernel arrays on its device, in the layout the plan runs.

    Blocking: the shard's contiguous tile range (views of the base arrays
    where the shard shares the base's device).  Overlap: the interior and
    boundary subsets, gathered.  CSR-k writes tile t of a launch at row
    block ``ids[t]`` of its shard's view of y; SELL-C-σ writes rows through
    its chunks' ``row_perm`` rows, which a shard on another device than y's
    also keeps as ``real`` (the rows it copies back).
    """
    Tp = plan.tiles_per_shard
    home = _concrete(base.device)
    if base.backend == "csrk":
        tl = base.tiles
        arrays = {"vals": tl.vals, "lcol": tl.local_col, "lrow": tl.local_row,
                  "win": tl.win_block, "scale": tl.val_scale, "nnz": tl.tile_nnz}
    else:
        st = base.sell_tiles
        arrays = {"vals": st.vals, "cols": st.col_idx, "scale": st.val_scale,
                  "perm": st.row_perm.view(T, st.C), "width": st.chunk_width}
    out = []
    for d, dev in enumerate(devices):
        t0, t1 = min(d * Tp, T), min((d + 1) * Tp, T)
        if plan.overlap:
            subsets = (("i_", plan.interior_ids[d]), ("b_", plan.boundary_ids[d]))
        else:
            subsets = (("", np.arange(t1 - t0, dtype=np.int32)),)
        a = {}
        for key, loc in subsets:
            loc = torch.from_numpy(np.asarray(loc, np.int32))
            glob = (loc.long() + t0).to(home)
            for name, arr in arrays.items():
                if arr is not None:
                    sub = arr[t0:t1] if key == "" else arr.index_select(0, glob)
                    a[key + name] = sub.to(dev)
            a[key + "ids"] = loc.to(dev)
            if base.backend == "sellcs":
                perm = a[key + "perm"] = a[key + "perm"].reshape(-1)
                if dev != home:
                    a[key + "real"] = perm[perm < st.shape[0]].long()
        out.append(a)
    return tuple(out)


def shard_prepared(
    base,
    mesh,
    *,
    axis: str = "data",
    x_strategy: str = "auto",
    A: CSRMatrix | None = None,
    halo_overlap: bool | None = None,
) -> ShardedPreparedSpMV:
    """Partition a single-device :class:`PreparedSpMV` across ``mesh``.

    The base operator's kernel tile view is split into contiguous per-shard
    tile sets (CSR-k: whole SSR tiles; SELL-C-σ: whole C-row chunks), so
    every shard runs the *same* kernel on the same tiles as the global
    launch (the bit-for-bit property).  Backends without a shardable tile
    view (``segsum``, ``diahybrid``, and CSR-k prepared without tiles, the
    CSR-2 route of CPU device models) *decline* tile partitioning: rows go
    to :func:`shard_csr` and the per-shard :func:`_local_spmv`, and a
    ``distributed/tile_decline.<backend>`` counter fires.

    A :class:`ShardPlan` is built on top: per-tile column reach classifies
    each shard's tiles as interior or boundary, the halo edge schedule keeps
    only the sides boundary tiles read, and with the halo strategy on a tile
    backend and enough interior tiles the plan overlaps.

    Args:
      base: the prepared single-device operator (any backend).
      mesh: a :class:`~repro_torch.launch.mesh.ShardMesh`; rows are
        partitioned over ``axis``.  Its devices must be of the base
        operator's device type.
      axis: mesh axis name (default ``"data"``).
      x_strategy: ``"auto"`` (O(1) :func:`select_x_strategy` from the base
        stats), or one of ``"replicated" | "allgather" | "halo"``.  A halo
        request is demoted to allgather when a shard's real column reach
        exceeds one neighbour's rows.
      A: the source matrix in the *base operator's* index space (reordered
        for CSR-k, original for SELL-C-σ), for the per-shard statistics and
        the CSR path.  Falls back to the operator's own CSR view.
      halo_overlap: None lets the plan decide; True forces overlap whenever
        it is structurally possible; False forces the blocking schedule
        (bit-for-bit identical either way).

    Returns:
      A :class:`ShardedPreparedSpMV`; call it like the base operator.
    """
    if x_strategy not in ("auto",) + X_STRATEGIES:
        raise ValueError(
            f"unknown x_strategy {x_strategy!r} (expected auto|" +
            "|".join(X_STRATEGIES) + ")"
        )
    D = int(mesh.shape[axis])
    devices = _mesh_devices(mesh, axis)
    bad = [d for d in devices if d.type != base.device.type]
    if bad:
        raise ValueError(
            f"mesh devices {bad} are not of the operator's device type {base.device.type!r}"
        )

    # -- partition geometry + per-tile column reach -------------------------
    tile_backend = False
    sh = None
    T = 0
    if base.backend == "csrk" and base.tiles is not None:
        tiles = base.tiles
        T, R = tiles.num_tiles, tiles.rows_per_tile
        Tp = -(-T // D)
        Rs = Tp * R
        lo, hi = tiles.col_reach()
        tile_backend = True
        src = A if A is not None else base.csrk.csr
    elif base.backend == "sellcs":
        st = base.sell_tiles
        T, R = int(st.vals.shape[0]), int(st.vals.shape[1])   # R = chunk C
        Tp = -(-T // D)
        Rs = Tp * R
        lo, hi = st.col_reach()
        tile_backend = True
        src = A
    else:
        # no tile view: raw row partitioning + the segment-sum product.
        # segsum/diahybrid land here (their containers are not row-block
        # shardable), as does CSR-k prepared without tiles (CPU models).
        if A is not None:
            src = A
        elif base.csrk is not None:
            src = base.csrk.csr
        else:
            raise ValueError(
                f"backend {base.backend!r} has no shardable tile view and "
                "no CSR source; pass A= (prepare(A, mesh=...) does this)"
            )
        sh = shard_csr(src.to(base.device), D)
        Tp = R = 0
        Rs = sh.rows_per_shard
    if src is not None:
        src = src.to("cpu")

    # per-shard real-column extents (the only inputs the halo math needs)
    if tile_backend:
        reach = _shard_reach(lo, hi, Tp, D)
    else:
        rp, ci, vl = host(sh.row_ptr), host(sh.col_idx), host(sh.vals)
        reach = []
        for d in range(D):
            k = int(rp[d, -1])
            cols = ci[d, :k][vl[d, :k] != 0] if k else np.empty(0, np.int64)
            reach.append(
                (int(cols.min()), int(cols.max())) if len(cols) else None
            )

    # -- per-shard statistics + registry decisions (introspection) ----------
    # (SELL-C-σ shards own *σ-sorted* row blocks; the original-order block
    # is the reference's host-side approximation, kept as it is.)
    if src is not None:
        from repro_torch.sparse.registry import select_format

        shard_stats = compute_shard_stats(src, D, rows_per_shard=Rs)
        shard_backends = tuple(
            select_format(s, base.device_model) for s in shard_stats
        )
    else:
        shard_stats = (None,) * D
        shard_backends = (base.backend,) * D

    # -- x strategy resolution ----------------------------------------------
    stats = base.stats
    if stats is None and src is not None:
        stats = compute_stats(src)
    requested = x_strategy
    if x_strategy == "auto":
        if stats is not None:
            x_strategy = select_x_strategy(stats, D, Rs)
        else:
            x_strategy = "allgather"
    halo = 0
    demoted = False
    if x_strategy == "halo":
        H_req = _required_halo(reach, Rs, D)
        halo = max(_round_up(max(H_req, 1), _LANE), _LANE)
        if halo > Rs:
            # a shard reaches beyond its neighbours: no single-neighbour halo
            x_strategy, halo = "allgather", 0
            demoted = True

    # -- interior/boundary classification + overlap decision ----------------
    interior_ids: Tuple = ()
    boundary_ids: Tuple = ()
    interior_frac = 1.0
    left_edges: Tuple = ()
    right_edges: Tuple = ()
    overlap = False
    if tile_backend:
        interior_ids, boundary_ids, interior_frac = classify_tile_reach(
            lo, hi, tiles_per_shard=Tp, rows_per_shard=Rs, num_shards=D
        )
    if x_strategy == "halo":
        if tile_backend:
            left_edges, right_edges = _halo_edges(reach, Rs, D)
            # overlap needs at least one real interior tile and one boundary
            can_overlap = 0.0 < interior_frac < 1.0
            if halo_overlap is None:
                overlap = can_overlap and interior_frac >= OVERLAP_MIN_INTERIOR
            else:
                overlap = bool(halo_overlap) and can_overlap
        else:
            # CSR path: the historical full-ring schedule
            left_edges, right_edges = _ring_edges(D)

    plan = ShardPlan(
        strategy=x_strategy,
        num_shards=D,
        rows_per_shard=Rs,
        halo=halo,
        tiles_per_shard=Tp,
        rows_per_tile=R,
        overlap=overlap,
        interior_fraction=interior_frac,
        interior_ids=interior_ids,
        boundary_ids=boundary_ids,
        left_edges=left_edges,
        right_edges=right_edges,
    )
    arrs = _shard_tile_arrays(base, plan, devices, T) if tile_backend else ()

    # -- telemetry: the sharding decisions, as metrics -----------------------
    reg = get_registry()
    if reg.enabled:
        reg.gauge("distributed", "num_shards", D, unit="count")
        reg.gauge("distributed", "rows_per_shard", Rs, unit="count")
        reg.gauge("distributed", "halo_rows", halo, unit="count")
        reg.gauge("distributed", "interior_fraction", interior_frac,
                  unit="fraction")
        reg.gauge("distributed", "collective_bytes",
                  plan.collective_bytes(), unit="bytes")
        reg.counter("distributed", f"x_strategy.{x_strategy}")
        if demoted:
            reg.counter("distributed", "halo_demoted_to_allgather")
        if x_strategy == "halo":
            reg.counter(
                "distributed",
                "halo_overlap.on" if overlap else "halo_overlap.off",
            )
        for b in shard_backends:
            reg.counter("distributed", f"shard_backend.{b}")
        if not tile_backend:
            reg.counter("distributed", f"tile_decline.{base.backend}")

    return ShardedPreparedSpMV(
        base=base,
        mesh=mesh,
        axis=axis,
        x_strategy_requested=requested,
        plan=plan,
        shard_stats=tuple(shard_stats),
        shard_backends=shard_backends,
        shard_arrays=arrs,
        c_csr=sh,
    )
