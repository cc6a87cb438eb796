"""SELL-C-σ: the SIMD-friendly format for *irregular* matrices.

Port of ``repro.sparse.sellcs``.  Kreutzer et al. (arXiv:1307.6209): rows
are sorted by descending length inside windows of σ rows, then grouped into
chunks of C consecutive rows; each chunk is padded only to *its own* longest
row.  Padding cost scales with the per-chunk spread instead of the global
max row length.

Two containers live here:

* :class:`SELLCSMatrix` — the canonical format: flat ``vals``/``col_idx``
  slot arrays with per-chunk widths (``chunk_ptr``), the σ-window row
  permutation, and a per-slot sorted-row id.
* :class:`SELLCSTiles` — the uniform-width view the reference's Pallas
  kernel takes: every chunk padded to the max chunk width rounded up to 128
  lanes.  Its arrays are the reference's bit for bit.  The port adds
  ``chunk_width`` (each chunk's own width, from ``chunk_ptr``), so the CUDA
  kernel reads only a chunk's real lanes and never the global padding.

The host-side build is numpy and produces the reference's arrays exactly
(vectorised where the reference loops; the tests pin bit identity).
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
class SELLCSMatrix:
    """Canonical SELL-C-σ container (flat slots, per-chunk widths).

    Slot layout inside chunk ``t`` (width ``w_t``) is column-major:
    slot ``chunk_ptr[t] + j·C + r`` holds column ``j`` of the chunk's
    ``r``-th row (rows in σ-sorted order).  Padding slots carry ``vals == 0``
    and ``col_idx == 0`` so they are numerically inert.

    ``row_perm[i]`` is the *original* row id stored at sorted position ``i``;
    positions past ``m`` (C-alignment padding) point at the dump row ``m``.
    """

    vals: torch.Tensor       # [slots] float — flat per-chunk column-major slots
    col_idx: torch.Tensor    # [slots] int32
    slot_row: torch.Tensor   # [slots] int32 — sorted-space row id of each slot
    chunk_ptr: torch.Tensor  # [T+1] int32 — slot offset of each chunk
    row_perm: torch.Tensor   # [m_pad] int32 — sorted position → original row (pad → m)
    shape: Tuple[int, int]
    C: int
    sigma: int
    nnz_real: int = 0        # source-CSR nnz (explicit zeros included, padding not)

    @property
    def m(self) -> int:
        return self.shape[0]

    @property
    def n(self) -> int:
        return self.shape[1]

    @property
    def m_pad(self) -> int:
        return int(self.row_perm.shape[0])

    @property
    def num_chunks(self) -> int:
        return int(self.chunk_ptr.shape[0]) - 1

    @property
    def slots(self) -> int:
        return int(self.vals.shape[0])

    @property
    def dtype(self):
        return self.vals.dtype

    def to(self, device) -> "SELLCSMatrix":
        return to_device(self, device)

    def chunk_widths(self) -> np.ndarray:
        return (np.diff(host(self.chunk_ptr)) // self.C).astype(np.int64)

    @property
    def nnz(self) -> int:
        """Source-CSR nnz — counts explicitly stored zeros."""
        return self.nnz_real

    def padding_overhead(self) -> float:
        """Padded-slot fraction — SELL-C-σ's defining metric (vs. ELL's)."""
        real = float(self.nnz)
        return (self.slots - real) / max(real, 1.0)

    def overhead_bytes(self) -> int:
        """Metadata bytes beyond the slot arrays: chunk_ptr + row_perm."""
        return (int(self.chunk_ptr.numel()) + int(self.row_perm.numel())) * 4

    def todense(self) -> torch.Tensor:
        """Dense reconstruction via the slot arrays (round-trip tests)."""
        m, n = self.shape
        rows = torch.cat([self.row_perm.long(),
                          torch.tensor([m], device=self.row_perm.device)])
        orig_row = rows[self.slot_row.long()]
        out = torch.zeros((m + 1, n), dtype=self.vals.dtype, device=self.vals.device)
        out.index_put_((orig_row, self.col_idx.long()), self.vals, accumulate=True)
        return out[:m]


@dataclasses.dataclass(frozen=True)
class SELLCSTiles:
    """Uniform-width view of a SELL-C-σ matrix: ``[T, C, W]`` chunk arrays.

    Chunks are padded from their own width ``w_t`` to the global max width
    rounded up to 128 lanes (the reference's static ``BlockSpec``).
    ``chunk_width[t]`` is ``w_t``: lanes ``[w_t, W)`` of chunk t are padding.
    """

    vals: torch.Tensor         # [T, C, W] f32 | bf16 | int8 (see value_dtype)
    col_idx: torch.Tensor      # [T, C, W] int32 (padding → 0)
    row_perm: torch.Tensor     # [m_pad] int32 — sorted position → original row (pad → m)
    chunk_width: torch.Tensor  # [T] int32 — real lanes of each chunk
    shape: Tuple[int, int]
    C: int
    val_scale: Optional[torch.Tensor] = None   # [T, C, W/group] f32, int8 only
    value_dtype: str = "f32"

    @property
    def num_chunks(self) -> int:
        return int(self.vals.shape[0])

    @property
    def width(self) -> int:
        return int(self.vals.shape[2])

    def to(self, device) -> "SELLCSTiles":
        return to_device(self, device)

    def padding_overhead(self) -> float:
        real = float(torch.count_nonzero(self.vals))
        return (self.vals.numel() - real) / max(real, 1.0)

    def col_reach(self):
        """Per-chunk real column reach ``(lo, hi)`` (host-side, numpy).

        Only ``vals != 0`` slots constrain the reach; empty chunks report
        ``lo > hi``.
        """
        v = host(self.vals.to(torch.float32)).reshape(self.num_chunks, -1)
        c = host(self.col_idx).astype(np.int64).reshape(self.num_chunks, -1)
        mask = v != 0
        lo = np.where(mask, c, np.iinfo(np.int32).max).min(
            axis=1, initial=np.iinfo(np.int32).max
        )
        hi = np.where(mask, c, -1).max(axis=1, initial=-1)
        return lo, hi

    def modeled_bytes(self) -> int:
        """Modeled per-SpMV HBM traffic of the reference's Pallas launch.

        Each chunk moves ``C·W`` value + col slots, ``C·W`` gathered x
        elements and ``C`` y rows; int8 adds the per-group scales.  It prices
        all W lanes; the CUDA kernel reads only ``chunk_width`` of them
        (PERF.md gives the bound it is held to).
        """
        vb = VALUE_BYTES[self.value_dtype]
        per_chunk = self.C * self.width * (vb + 8) + self.C * 4
        if self.val_scale is not None:
            per_chunk += self.C * (self.width // INT8_GROUP) * 4
        return self.num_chunks * per_chunk


def sellcs_from_csr(
    csr: CSRMatrix, C: int = 8, sigma: int | None = None
) -> SELLCSMatrix:
    """Build SELL-C-σ from CSR (host-side numpy: setup phase).

    ``C`` defaults to 8; ``sigma`` defaults to ``16·C``.  ``sigma = m`` gives
    the full global sort, ``sigma = 1`` plain SELL-C with no sorting.  The
    result lives on the CPU.
    """
    m, n = csr.shape
    C = max(int(C), 1)
    if sigma is None:
        sigma = 16 * C
    sigma = max(int(sigma), 1)

    rp = host(csr.row_ptr)
    ci = host(csr.col_idx)
    vl = host(csr.vals)
    lengths = (rp[1:] - rp[:-1]).astype(np.int64)

    m_pad = _round_up(max(m, 1), C)
    lengths_pad = np.zeros(m_pad, np.int64)
    lengths_pad[:m] = lengths

    # σ-window sort: descending row length inside each window of σ rows
    order = np.arange(m_pad)
    for w0 in range(0, m_pad, sigma):
        w1 = min(w0 + sigma, m_pad)
        sub = np.argsort(-lengths_pad[w0:w1], kind="stable")
        order[w0:w1] = w0 + sub
    # row_perm: sorted position → original row; C-alignment pad rows → dump m
    row_perm = np.where(order < m, order, m).astype(np.int32)
    sorted_lengths = lengths_pad[order]

    T = m_pad // C
    widths = sorted_lengths.reshape(T, C).max(axis=1)
    chunk_ptr = np.zeros(T + 1, np.int64)
    np.cumsum(widths * C, out=chunk_ptr[1:])
    slots = int(chunk_ptr[-1])

    # every slot of chunk t records its sorted-space row id t·C + (s mod C)
    chunk_of_slot = np.repeat(np.arange(T, dtype=np.int64), widths * C)
    within = np.arange(slots, dtype=np.int64) - chunk_ptr[:-1][chunk_of_slot]
    srows = (chunk_of_slot * C + within % C).astype(np.int32)

    # column-major within a chunk: row r's j-th nnz at chunk_ptr[t] + j·C + r
    svals = np.zeros(slots, vl.dtype)
    scols = np.zeros(slots, np.int32)
    real = order < m
    pos = np.arange(m_pad, dtype=np.int64)[real]            # sorted positions
    orig = order[real]
    L = lengths[orig]
    entry_row = np.repeat(np.arange(pos.shape[0]), L)
    j = np.arange(int(L.sum()), dtype=np.int64) - np.repeat(np.cumsum(L) - L, L)
    p = pos[entry_row]
    dest = chunk_ptr[p // C] + j * C + p % C
    src = np.repeat(rp[orig].astype(np.int64), L) + j
    svals[dest] = vl[src]
    scols[dest] = ci[src]

    return SELLCSMatrix(
        torch.from_numpy(svals),
        _i32(scols),
        _i32(srows),
        _i32(chunk_ptr),
        _i32(row_perm),
        (m, n),
        C=C,
        sigma=sigma,
        nnz_real=csr.nnz,
    )


def tiles_from_sellcs(
    mat: SELLCSMatrix, lane: int = 128, value_dtype: str = "f32"
) -> SELLCSTiles:
    """Materialise the uniform-width ``[T, C, W]`` view (host-side, numpy).

    ``value_dtype`` ∈ {"f32", "bf16", "int8"} compresses the value stream as
    :func:`repro_torch.sparse.csrk.tiles_from_csrk` does — int8 groups run
    along the lane (W) axis, one f32 scale per ``INT8_GROUP`` lanes.
    """
    T, C = mat.num_chunks, mat.C
    widths = mat.chunk_widths()
    W = _round_up(int(widths.max(initial=1)), lane)
    cp = host(mat.chunk_ptr).astype(np.int64)
    fv = host(mat.vals)
    fc = host(mat.col_idx)
    pvals = np.zeros((T, C, W), fv.dtype)
    pcols = np.zeros((T, C, W), np.int32)
    # flat slot s of chunk t is (lane j, row r) = divmod(s - chunk_ptr[t], C)
    t_of_slot = np.repeat(np.arange(T, dtype=np.int64), widths * C)
    j, r = np.divmod(np.arange(cp[-1], dtype=np.int64) - cp[:-1][t_of_slot], C)
    pvals[t_of_slot, r, j] = fv
    pcols[t_of_slot, r, j] = fc

    dvals, dscale = _pack_values(pvals, value_dtype)
    return SELLCSTiles(
        dvals,
        torch.from_numpy(pcols),
        mat.row_perm,
        _i32(widths),
        mat.shape,
        C=C,
        val_scale=dscale,
        value_dtype=value_dtype,
    )
