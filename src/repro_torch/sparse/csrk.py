"""CSR-k containers: the paper's hierarchical format plus its padded tile view.

Port of ``repro.sparse.csrk``.  CSR-k (Lane & Booth 2022) stores a sparse
matrix as plain CSR plus k-1 extra pointer arrays that group contiguous rows
into super-rows (``sr_ptr``) and contiguous super-rows into super-super-rows
(``ssr_ptr``).  ``CSRkMatrix.csr`` is a zero-copy view.

The kernel path additionally materialises a *padded tile view*
(:class:`CSRkTiles`): every super-super-row owns a fixed number of rows and
a fixed number of nnz slots.  The host-side build is the reference's numpy,
line for line, so the arrays are bit-identical to the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.optim.compress import INT8_GROUP
from repro_torch.sparse._tree import host, to_device
from repro_torch.sparse.csr import CSRMatrix

#: Bytes per stored value, by tile-view value dtype (value + 4B col + 4B row
#: indices is the per-slot accounting of ``core.tuner.tile_bytes_model``).
VALUE_BYTES = {"f32": 4, "bf16": 2, "int8": 1}


def _i32(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.int32)))


@dataclasses.dataclass(frozen=True)
class CSRkMatrix:
    """CSR-k: CSR + super-row / super-super-row pointer arrays (paper Fig. 2).

    ``k == 2`` → only ``sr_ptr`` is meaningful (``ssr_ptr`` groups all SRs into
    one trivial SSR); ``k == 3`` → both levels are real (the paper's
    CSR-2-on-CPU / CSR-3-on-GPU split).
    """

    row_ptr: torch.Tensor   # [m+1]   cumulative nnz per row
    col_idx: torch.Tensor   # [nnz]
    vals: torch.Tensor      # [nnz]
    sr_ptr: torch.Tensor    # [num_sr+1]  cumulative rows per super-row
    ssr_ptr: torch.Tensor   # [num_ssr+1] cumulative super-rows per super-super-row
    shape: Tuple[int, int]
    k: int = 3

    @property
    def csr(self) -> CSRMatrix:
        return CSRMatrix(self.row_ptr, self.col_idx, self.vals, self.shape)

    @property
    def nnz(self) -> int:
        return int(self.vals.shape[0])

    @property
    def m(self) -> int:
        return self.shape[0]

    @property
    def n(self) -> int:
        return self.shape[1]

    @property
    def num_sr(self) -> int:
        return int(self.sr_ptr.shape[0]) - 1

    @property
    def num_ssr(self) -> int:
        return int(self.ssr_ptr.shape[0]) - 1

    @property
    def rdensity(self) -> float:
        return self.nnz / max(self.m, 1)

    def to(self, device) -> "CSRkMatrix":
        return to_device(self, device)

    def todense(self) -> torch.Tensor:
        return self.csr.todense()

    def overhead_bytes(self) -> int:
        """Extra bytes over plain CSR (the paper's Fig. 12 quantity)."""
        extra = self.sr_ptr.numel()
        if self.k >= 3:
            extra += self.ssr_ptr.numel()
        return int(extra) * 4

    def overhead_fraction(self) -> float:
        base = (2 * self.nnz + self.m + 1) * 4
        return self.overhead_bytes() / base


def build_csrk(
    csr: CSRMatrix,
    srs: int,
    ssrs: int | None = None,
    k: int = 3,
) -> CSRkMatrix:
    """Group rows into super-rows of ~``srs`` rows and SRs into SSRs of ~``ssrs``
    super-rows.  Sizes follow the tuner; groups are contiguous (paper Fig. 2).
    """
    m = csr.m
    srs = max(int(srs), 1)
    num_sr = (m + srs - 1) // srs
    sr_ptr = np.minimum(np.arange(num_sr + 1, dtype=np.int64) * srs, m).astype(np.int32)
    if k >= 3:
        ssrs = max(int(ssrs or 1), 1)
        num_ssr = (num_sr + ssrs - 1) // ssrs
        ssr_ptr = np.minimum(
            np.arange(num_ssr + 1, dtype=np.int64) * ssrs, num_sr
        ).astype(np.int32)
    else:
        ssr_ptr = np.asarray([0, num_sr], np.int32)
    dev = csr.device
    return CSRkMatrix(
        csr.row_ptr,
        csr.col_idx,
        csr.vals,
        _i32(sr_ptr).to(dev),
        _i32(ssr_ptr).to(dev),
        csr.shape,
        k=k,
    )


# ---------------------------------------------------------------------------
# CSR-k padded tile view for the kernel
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CSRkTiles:
    """Padded per-SSR tile view of a CSR-k matrix.

    Each SSR (one kernel thread block) owns:
      * ``rows_per_tile`` contiguous output rows (uniform; last tile padded),
      * ``slots`` nnz slots (padded to the max SSR nnz, rounded up to 128),
      * a column window of ``2·window`` columns starting at block
        ``win_block`` (element offset ``win_block · window``).

    ``local_col`` indexes within the 2-block window; ``local_row`` within the
    tile's rows.  Real entries are packed at the front of every tile in CSR
    order; padding slots carry ``vals == 0`` (int8 code 0) and index 0 so they
    are numerically inert.  Entries outside the window are diverted to a COO
    remainder (empty after Band-k on all suites).

    ``value_dtype`` selects how ``vals`` is stored: ``"f32"``, ``"bf16"``, or
    ``"int8"`` with per-group symmetric scales in ``val_scale`` (one f32 scale
    per :data:`INT8_GROUP` slots).  ``tile_nnz`` records each tile's real
    (in-window) entry count.
    """

    vals: torch.Tensor        # [T, slots] f32 | bf16 | int8 (see value_dtype)
    local_col: torch.Tensor   # [T, slots] int32, in [0, 2*window)
    local_row: torch.Tensor   # [T, slots] int32, in [0, rows_per_tile)
    win_block: torch.Tensor   # [T] int32, x-window block index (elements = blk*window)
    # COO remainder for out-of-window entries
    rem_row: torch.Tensor     # [R] int32
    rem_col: torch.Tensor     # [R] int32
    rem_val: torch.Tensor     # [R]
    shape: Tuple[int, int]
    rows_per_tile: int
    window: int
    val_scale: Optional[torch.Tensor] = None   # [T, slots/INT8_GROUP] f32, int8 only
    tile_nnz: Optional[torch.Tensor] = None    # [T] int32 real in-window entries
    value_dtype: str = "f32"

    @property
    def num_tiles(self) -> int:
        return int(self.vals.shape[0])

    @property
    def slots(self) -> int:
        return int(self.vals.shape[1])

    @property
    def remainder_nnz(self) -> int:
        return int(self.rem_val.shape[0])

    def to(self, device) -> "CSRkTiles":
        return to_device(self, device)

    def padding_overhead(self) -> float:
        """Padded-slot fraction: the tile view's memory-waste metric."""
        real = float(torch.count_nonzero(self.vals)) + self.remainder_nnz
        return (self.num_tiles * self.slots + self.remainder_nnz - real) / max(real, 1.0)

    def modeled_bytes(self) -> int:
        """Modeled per-SpMV HBM traffic of the TPU design's monolithic launch.

        Same accounting as ``core.tuner.tile_bytes_model``: every tile moves
        ``slots`` value/col/row slots plus the 2-block x-window and its y rows;
        the int8 path adds one f32 scale per :data:`INT8_GROUP` slots.  The
        CUDA kernel reads x through the cache instead of per-tile windows, so
        this over-counts its traffic (PERF.md).
        """
        vb = VALUE_BYTES[self.value_dtype]
        per_tile = self.slots * (vb + 8) + 2 * self.window * 4 + self.rows_per_tile * 4
        if self.val_scale is not None:
            per_tile += (self.slots // INT8_GROUP) * 4
        return self.num_tiles * per_tile + self.remainder_nnz * 12

    def col_reach(self):
        """Per-tile real column reach ``(lo, hi)`` (host-side, numpy).

        Only slots with ``vals != 0`` constrain the reach (compared in f32,
        so an int8 slot counts where its code is nonzero): padding slots
        multiply by zero and are inert.  Empty tiles report ``lo > hi``
        (``lo = INT32_MAX``, ``hi = -1``).

        Returns:
          ``(lo, hi)``: two ``[num_tiles]`` int64 arrays of absolute column
          indices, for :func:`repro_torch.sparse.stats.classify_tile_reach`.
        """
        v = host(self.vals.to(torch.float32))
        lc = host(self.local_col).astype(np.int64)
        wb = host(self.win_block).astype(np.int64)
        cols = wb[:, None] * self.window + lc              # [T, S] absolute
        mask = v != 0
        lo = np.where(mask, cols, np.iinfo(np.int32).max).min(
            axis=1, initial=np.iinfo(np.int32).max
        )
        hi = np.where(mask, cols, -1).max(axis=1, initial=-1)
        return lo, hi


def _round_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


def _pack_values(tvals: np.ndarray, value_dtype: str):
    """Convert the freshly built f32 tile values to ``value_dtype``.

    Returns ``(vals, val_scale_or_None)`` as CPU tensors.  bf16 is a
    round-to-nearest-even cast (as in JAX); int8 uses the grouped-scale
    quantizer (one f32 scale per :data:`INT8_GROUP` slots along the slot axis).
    """
    if value_dtype == "f32":
        return torch.from_numpy(tvals), None
    if value_dtype == "bf16":
        return torch.from_numpy(tvals).to(torch.bfloat16), None
    if value_dtype == "int8":
        from repro_torch.optim.compress import quantize_int8_grouped

        q, scales = quantize_int8_grouped(tvals, group=INT8_GROUP)
        return torch.from_numpy(q), torch.from_numpy(scales)
    raise ValueError(
        f"unknown value_dtype {value_dtype!r} (expected f32|bf16|int8)"
    )


def tiles_from_csrk(
    mat: CSRkMatrix, window: int | None = None, value_dtype: str = "f32"
) -> CSRkTiles:
    """Materialise the padded per-SSR tile view (host-side setup, numpy).

    ``window`` is the x-window *block* width in columns (rounded up to 128).
    If None it is chosen as the max SSR column span rounded up — Band-k
    decides it.  ``value_dtype`` ∈ {"f32", "bf16", "int8"} compresses the
    value stream; indices and the COO remainder stay as-is.  The result lives
    on the CPU; move it with ``.to(device)``.
    """
    rp = host(mat.row_ptr)
    ci = host(mat.col_idx)
    vl = host(mat.vals)
    sr = host(mat.sr_ptr)
    ssr = host(mat.ssr_ptr)
    m, n = mat.shape

    # rows covered by each SSR: the kernel needs a uniform row stride per tile
    ssr_row_start = sr[ssr[:-1]]
    ssr_row_end = sr[ssr[1:]]
    T = len(ssr_row_start)
    rows_per_tile = int((ssr_row_end - ssr_row_start).max(initial=1))
    if not np.all(ssr_row_start == np.arange(T) * rows_per_tile):
        raise ValueError(
            "tiles_from_csrk requires uniform SSR row counts "
            "(use build_csrk / regularised hierarchy for the kernel path)"
        )

    # column span per SSR → window block size (Band-k bounds this)
    spans = []
    for t in range(T):
        s, e = rp[ssr_row_start[t]], rp[ssr_row_end[t]]
        if e > s:
            spans.append(int(ci[s:e].max()) - int(ci[s:e].min()) + 1)
        else:
            spans.append(1)
    if window is None:
        window = _round_up(max(spans), 128)
    else:
        window = _round_up(int(window), 128)

    max_nnz = 0
    for t in range(T):
        max_nnz = max(max_nnz, int(rp[ssr_row_end[t]] - rp[ssr_row_start[t]]))
    slots = _round_up(max(max_nnz, 1), 128)

    tvals = np.zeros((T, slots), vl.dtype)
    tlc = np.zeros((T, slots), np.int32)
    tlr = np.zeros((T, slots), np.int32)
    twin = np.zeros((T,), np.int32)
    tnnz = np.zeros((T,), np.int32)
    rem_r, rem_c, rem_v = [], [], []

    for t in range(T):
        r0, r1 = int(ssr_row_start[t]), int(ssr_row_end[t])
        s, e = int(rp[r0]), int(rp[r1])
        if e == s:
            continue
        cols = ci[s:e]
        vals = vl[s:e]
        rows = np.repeat(np.arange(r0, r1), rp[r0 + 1 : r1 + 1] - rp[r0:r1])
        blk = int(cols.min()) // window
        twin[t] = blk
        start = blk * window
        inw = (cols >= start) & (cols < start + 2 * window)
        k = int(inw.sum())
        tvals[t, :k] = vals[inw]
        tlc[t, :k] = cols[inw] - start
        tlr[t, :k] = rows[inw] - r0
        tnnz[t] = k
        if k < len(cols):
            out = ~inw
            rem_r.append(rows[out])
            rem_c.append(cols[out])
            rem_v.append(vals[out])

    if rem_r:
        rem_r = np.concatenate(rem_r)
        rem_c = np.concatenate(rem_c)
        rem_v = np.concatenate(rem_v)
    else:
        rem_r = np.zeros((0,), np.int32)
        rem_c = np.zeros((0,), np.int32)
        rem_v = np.zeros((0,), vl.dtype)

    dvals, dscale = _pack_values(tvals, value_dtype)
    return CSRkTiles(
        dvals,
        _i32(tlc),
        _i32(tlr),
        _i32(twin),
        _i32(rem_r),
        _i32(rem_c),
        torch.from_numpy(np.ascontiguousarray(rem_v)),
        (m, n),
        rows_per_tile,
        window,
        val_scale=dscale,
        tile_nnz=_i32(tnnz),
        value_dtype=value_dtype,
    )


# ---------------------------------------------------------------------------
# slot-bucketed tile view (SELL-C-σ-style per-bucket compaction for CSR-k)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CSRkTileBuckets:
    """Slot-compacted CSR-k tile view: tiles grouped by rounded-up nnz count.

    The monolithic :class:`CSRkTiles` pads every tile to the single worst
    tile's slot count; bucketing (the SELL-C-σ trick, Kreutzer et al.,
    arXiv:1307.6209, at tile granularity) groups tiles whose nnz rounds up to
    the same 128-multiple into one bucket, stored as its own ``[T_b, S_b]``
    array set and launched as its own kernel grid.

    Each bucket is a self-consistent :class:`CSRkTiles` over its *own
    compacted row space*; ``tile_ids[b][i]`` maps bucket tile ``i`` back to
    its global tile, whose rows start at ``tile_ids[b][i] · R``.  Compaction
    only drops trailing all-padding slots, so every real slot keeps its
    position.  The COO remainder is held once, here.
    """

    buckets: Tuple[CSRkTiles, ...]
    tile_ids: Tuple[torch.Tensor, ...]   # per bucket: [T_b] int32 global tile ids
    rem_row: torch.Tensor                # [R] int32
    rem_col: torch.Tensor                # [R] int32
    rem_val: torch.Tensor                # [R]
    shape: Tuple[int, int]
    rows_per_tile: int
    window: int
    num_tiles: int
    value_dtype: str = "f32"

    @property
    def num_buckets(self) -> int:
        return len(self.buckets)

    @property
    def remainder_nnz(self) -> int:
        return int(self.rem_val.shape[0])

    def to(self, device) -> "CSRkTileBuckets":
        return to_device(self, device)

    def bucket_slots(self) -> Tuple[int, ...]:
        return tuple(b.slots for b in self.buckets)

    def padding_overhead(self) -> float:
        """Padded-slot fraction across all buckets (cf. CSRkTiles)."""
        real = self.remainder_nnz
        total = self.remainder_nnz
        for b in self.buckets:
            real += int(torch.count_nonzero(b.vals))
            total += b.num_tiles * b.slots
        return (total - real) / max(float(real), 1.0)

    def modeled_bytes(self) -> int:
        """Modeled per-SpMV HBM traffic, summed over the per-bucket launches.

        ``Σ_b T_b · (S_b·(value+8) + 2·window·4 + rows·4)`` — same per-tile
        accounting as :meth:`CSRkTiles.modeled_bytes`.
        """
        return sum(b.modeled_bytes() for b in self.buckets) + self.remainder_nnz * 12


def bucket_tiles(tiles: CSRkTiles) -> CSRkTileBuckets:
    """Regroup a monolithic tile view into slot buckets (host-side, numpy).

    Tiles are keyed by ``round_up(max(tile_nnz, 1), 128)`` and each bucket's
    arrays are the original rows sliced to the bucket's slot count — real
    entries are packed at the front of every tile, so slicing drops only
    trailing padding.  The result lives on ``tiles``' device.
    """
    dev = tiles.vals.device
    v = tiles.vals.cpu()
    lc = host(tiles.local_col)
    lr = host(tiles.local_row)
    wb = host(tiles.win_block)
    sc = None if tiles.val_scale is None else host(tiles.val_scale)
    if tiles.tile_nnz is not None:
        nnz_t = host(tiles.tile_nnz)
    else:  # hand-built views: padding is 0-valued, real zeros are not packed
        nnz_t = (v != 0).sum(dim=1).numpy()
    slots_t = np.minimum(((np.maximum(nnz_t, 1) + 127) // 128) * 128, tiles.slots)

    buckets, ids = [], []
    for S_b in sorted(set(int(s) for s in slots_t)):
        sel = np.flatnonzero(slots_t == S_b)
        sel_t = torch.from_numpy(sel)
        scale_b = None
        if sc is not None:
            scale_b = torch.from_numpy(np.ascontiguousarray(sc[sel, : S_b // INT8_GROUP]))
        buckets.append(CSRkTiles(
            v[sel_t, :S_b].contiguous(),
            _i32(lc[sel, :S_b]),
            _i32(lr[sel, :S_b]),
            _i32(wb[sel]),
            torch.zeros((0,), dtype=torch.int32),
            torch.zeros((0,), dtype=torch.int32),
            torch.zeros((0,), dtype=tiles.rem_val.dtype),
            (len(sel) * tiles.rows_per_tile, tiles.shape[1]),
            tiles.rows_per_tile,
            tiles.window,
            val_scale=scale_b,
            tile_nnz=_i32(nnz_t[sel]),
            value_dtype=tiles.value_dtype,
        ).to(dev))
        ids.append(_i32(sel).to(dev))
    return CSRkTileBuckets(
        tuple(buckets),
        tuple(ids),
        tiles.rem_row,
        tiles.rem_col,
        tiles.rem_val,
        tiles.shape,
        tiles.rows_per_tile,
        tiles.window,
        tiles.num_tiles,
        value_dtype=tiles.value_dtype,
    )
