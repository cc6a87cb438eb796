"""Speculative segmented-sum CSR: the power-law / empty-row path.

Port of ``repro.sparse.segsum``.  Liu & Vinter (CSR5, arXiv:1504.06474)
make the case that ultra-irregular matrices want an nnz-space partition:
split the nnz stream into equal-size chunks **independent of row
boundaries**, compute per-chunk partial sums speculatively (each chunk
reduces its slots by the row segments it happens to contain), and patch rows
that span chunks with a cheap carry pass that adds the partial head/tail
sums together.  Storage and work are both O(nnz): no per-row padding, so
empty rows are free and a single million-nnz row costs exactly its nnz.

:class:`SegSumCSR` is both the canonical container and the kernel's view:

* ``vals`` / ``col_idx`` — the CSR nnz streams, reshaped to ``[T, S]`` equal
  chunks of ``S`` slots (the tail chunk zero-padded; padding slots carry
  ``val == 0``, so they are numerically inert),
* ``local_seg`` — each slot's *local segment id* inside its chunk (segments
  are the distinct rows intersecting the chunk, in row order),
* ``seg_row`` — ``[T, R]`` global row of each local segment (unused segments
  and the tail chunk's padding segment point at the dump row ``m``).

Its arrays are the reference's bit for bit.  The port adds two arrays,
derived from ``local_seg``, ``seg_row`` and ``nnz`` alone:

* ``seg_start`` — each chunk's real segment starts, which the
  CUDA kernel's chunk pass reads in place of ``local_seg`` (a few MB where
  ``local_seg`` is 4 bytes a slot; :func:`segment_starts`),
* ``carry`` — the rows that span chunks (row, first fragment, last chunk),
  which its carry pass reads instead of walking chunk boundaries
  (:func:`carry_spans`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.optim.compress import INT8_GROUP
from repro_torch.sparse._tree import host, to_device
from repro_torch.sparse.csr import CSRMatrix
from repro_torch.sparse.csrk import VALUE_BYTES, _i32, _pack_values, _round_up


@dataclasses.dataclass(frozen=True)
class SegSumCSR:
    """Equal-nnz-chunk CSR with per-chunk speculative segment structure.

    ``local_seg[t, s]`` ∈ [0, R) names the segment (distinct row) slot ``s``
    contributes to inside chunk ``t``; ``seg_row[t, k]`` is that segment's
    global row (``m`` = dump for unused segments and for the tail chunk's
    padding slots, which form their own inert trailing segment).
    ``carry[i] = (row, 2·c0 + side, c1)`` for each row spanning chunks c0..c1:
    its first fragment is segment 0 (side 0) or the last real segment
    (side 1) of chunk c0, the rest are segment 0 of chunks c0+1..c1.
    ``seg_start[:T + 1]`` point into ``seg_start`` itself: chunk t's list
    ``seg_start[seg_start[t]:seg_start[t + 1]]`` holds the first slot of
    each of its ``L_t`` real segments.
    """

    vals: torch.Tensor       # [T, S] f32 | bf16 | int8 — equal-size nnz chunks
    col_idx: torch.Tensor    # [T, S] int32 (padding → 0)
    local_seg: torch.Tensor  # [T, S] int32 in [0, R)
    seg_row: torch.Tensor    # [T, R] int32 global row per segment (unused → m)
    seg_start: torch.Tensor  # [T + 1 + Σ_t L_t] int32 segment starts (port-only)
    carry: torch.Tensor      # [P, 3] int32 rows spanning chunks (port-only)
    shape: Tuple[int, int]
    nnz_real: int = 0
    val_scale: Optional[torch.Tensor] = None   # [T, S/INT8_GROUP] f32, int8 only
    value_dtype: str = "f32"

    @property
    def m(self) -> int:
        return self.shape[0]

    @property
    def n(self) -> int:
        return self.shape[1]

    @property
    def num_chunks(self) -> int:
        return int(self.vals.shape[0])

    @property
    def chunk_slots(self) -> int:
        return int(self.vals.shape[1])

    @property
    def segs_per_chunk(self) -> int:
        return int(self.seg_row.shape[1])

    @property
    def slots(self) -> int:
        return self.num_chunks * self.chunk_slots

    @property
    def nnz(self) -> int:
        return self.nnz_real

    def to(self, device) -> "SegSumCSR":
        return to_device(self, device)

    def padding_overhead(self) -> float:
        """Padded-slot fraction: only the tail chunk pads, so this is < S/nnz
        — the O(nnz) storage claim, independent of the row-length spread."""
        real = float(max(self.nnz_real, 1))
        return (self.slots - self.nnz_real) / real

    def overhead_bytes(self) -> int:
        """Metadata bytes beyond the slot arrays: local_seg + seg_row."""
        return (self.slots + self.num_chunks * self.segs_per_chunk) * 4

    def real_segments(self) -> np.ndarray:
        """``[T]`` count of each chunk's segments that are rows (host-side)."""
        return (host(self.seg_row) < self.m).sum(axis=1).astype(np.int64)

    def col_reach(self):
        """Per-chunk real column reach ``(lo, hi)`` (host-side, numpy)."""
        v = host(self.vals.to(torch.float32)).reshape(self.num_chunks, -1)
        c = host(self.col_idx).astype(np.int64)
        mask = v != 0
        lo = np.where(mask, c, np.iinfo(np.int32).max).min(
            axis=1, initial=np.iinfo(np.int32).max
        )
        hi = np.where(mask, c, -1).max(axis=1, initial=-1)
        return lo, hi

    def modeled_bytes(self) -> int:
        """Modeled per-SpMV HBM traffic of the reference's Pallas launch.

        Each chunk streams ``S`` value + col slots + local segment ids, reads
        ``S`` gathered x elements, and writes ``R`` speculative partials that
        the carry pass re-reads (+ the seg_row ids); int8 adds the per-group
        scales.  The CUDA kernel writes no dump partials (PERF.md gives the
        bound it is held to).
        """
        vb = VALUE_BYTES[self.value_dtype]
        per_chunk = self.chunk_slots * (vb + 12) + self.segs_per_chunk * 12
        if self.val_scale is not None:
            per_chunk += (self.chunk_slots // INT8_GROUP) * 4
        return self.num_chunks * per_chunk + self.m * 4

    def todense(self) -> torch.Tensor:
        """Dense reconstruction via the slot arrays (round-trip tests)."""
        from repro_torch.kernels.ref import _tile_vals_f32

        m, n = self.shape
        vals = _tile_vals_f32(self.vals, self.val_scale)
        rows = torch.gather(self.seg_row.long(), 1, self.local_seg.long())
        out = torch.zeros((m + 1, n), dtype=torch.float32, device=vals.device)
        out.index_put_((rows.reshape(-1), self.col_idx.long().reshape(-1)),
                       vals.reshape(-1), accumulate=True)
        return out[:m]


def segment_starts(local_seg: np.ndarray, nnz: int) -> np.ndarray:
    """``[T + 1 + Σ_t L_t]`` int32 segment-start table (host-side numpy),
    from the reference's ``local_seg`` and ``nnz`` alone.

    Chunk t's real slots are its first ``n_t = min(S, nnz − t·S)``; a real
    slot starts a segment where it is the chunk's first or its local segment
    id differs from the slot before.  The first ``T + 1`` entries are
    offsets into the table itself: chunk t's list ``[ptr[t], ptr[t + 1])``
    holds its ``L_t`` starts in increasing order.
    """
    T, S = local_seg.shape
    n_t = np.clip(int(nnz) - np.arange(T, dtype=np.int64) * S, 0, S)
    new = np.arange(S)[None, :] < n_t[:, None]
    new[:, 1:] &= local_seg[:, 1:] != local_seg[:, :-1]
    t_idx, s_idx = np.nonzero(new)                 # row-major: by chunk, then slot
    ptr = T + 1 + np.concatenate([[0], np.cumsum(np.bincount(t_idx, minlength=T))])
    return np.concatenate([ptr, s_idx]).astype(np.int32)


def carry_spans(local_seg: np.ndarray, seg_row: np.ndarray, nnz: int) -> np.ndarray:
    """``[P, 3]`` int32 ``(row, 2·c0 + side, c1)`` of every row that spans
    chunks c0..c1 (host-side numpy), from the reference's arrays alone.

    Chunk t's real slots are its first ``min(S, nnz − t·S)``; its last real
    segment continues into chunk t+1 when that chunk's segment 0 is the same
    row.  A row's first fragment is the last real segment of c0 (side 1), or
    its only segment (side 0); it goes on through every following chunk that
    holds one segment and continues.
    """
    T, S = local_seg.shape
    t = np.arange(T)
    n_t = np.clip(int(nnz) - t * S, 0, S)
    L = np.where(n_t > 0, local_seg[t, np.maximum(n_t - 1, 0)] + 1, 0)
    last = seg_row[t, np.maximum(L - 1, 0)]
    cont = np.zeros(T, bool)
    cont[:-1] = (seg_row[1:, 0] == last[:-1]) & (L[:-1] > 0)
    from_prev = np.concatenate([[False], cont[:-1]])
    c0 = np.flatnonzero(cont & ~((L == 1) & from_prev))
    # the row goes on through chunk c while c holds one segment and continues
    through = (L == 1) & cont
    stop = np.minimum.accumulate(np.where(through, T, t)[::-1])[::-1]
    out = np.stack([last[c0], 2 * c0 + (L[c0] > 1), stop[c0 + 1]], axis=1)
    return np.ascontiguousarray(out.astype(np.int32).reshape(-1, 3))


def segsum_from_csr(
    csr: CSRMatrix, chunk_slots: int = 512, value_dtype: str = "f32"
) -> SegSumCSR:
    """Build the segmented-sum view from CSR (host-side numpy: setup phase).

    The nnz stream is cut into ``ceil(nnz / chunk_slots)`` equal chunks with
    no regard for row boundaries; each chunk's slots are labelled with a
    local segment id (distinct rows in the chunk, in order), and ``seg_row``
    records which global row every segment belongs to.  ``R`` (segments per
    chunk) is the maximum over chunks, rounded up to 8 — the only padding in
    the format, bounded by ``chunk_slots``.  The result lives on the CPU.

    Args:
      csr: the source matrix.
      chunk_slots: nnz slots per chunk; rounded up to a 128 multiple.
      value_dtype: "f32" | "bf16" | "int8" slot-value compression (the same
        grouped-scale idiom as :func:`repro_torch.sparse.csrk.tiles_from_csrk`).
    """
    m, n = csr.shape
    S = _round_up(max(int(chunk_slots), 128), 128)
    rp = host(csr.row_ptr)
    ci = host(csr.col_idx)
    vl = host(csr.vals).astype(np.float32)
    nnz = int(rp[-1])
    lengths = (rp[1:] - rp[:-1]).astype(np.int64)
    T = max(-(-nnz // S), 1)
    pad = T * S - nnz

    rows = np.repeat(np.arange(m, dtype=np.int64), lengths)
    rows = np.concatenate([rows, np.full(pad, m, np.int64)]).reshape(T, S)
    cols = np.concatenate([ci.astype(np.int32), np.zeros(pad, np.int32)])
    vals = np.concatenate([vl, np.zeros(pad, np.float32)])

    # local segment ids: a new segment wherever the row changes inside a chunk
    newseg = np.ones((T, S), bool)
    newseg[:, 1:] = rows[:, 1:] != rows[:, :-1]
    local_seg = (np.cumsum(newseg, axis=1) - 1).astype(np.int32)
    R = _round_up(max(int(local_seg[:, -1].max()) + 1, 1), 8)
    seg_row = np.full((T, R), m, np.int32)
    t_idx = np.broadcast_to(np.arange(T)[:, None], (T, S))
    seg_row[t_idx, local_seg] = rows

    dvals, dscale = _pack_values(vals.reshape(T, S), value_dtype)
    return SegSumCSR(
        dvals,
        _i32(cols.reshape(T, S)),
        _i32(local_seg),
        _i32(seg_row),
        _i32(segment_starts(local_seg, nnz)),
        _i32(carry_spans(local_seg, seg_row, nnz)),
        (m, n),
        nnz_real=nnz,
        val_scale=dscale,
        value_dtype=value_dtype,
    )
