"""Baseline / competitor formats: ELL, BCSR and the CSR5-like stand-in.

Port of ``repro.sparse.baselines``.  These are the formats the paper
benchmarks CSR-k against (Secs. 2.1, 2.3, 2.4).  The registry lists them so
a caller can name them, but the auto-selector never picks them and
``prepare`` takes none of them: they exist to be compared against.

The host builds give arrays equal to the reference's bit for bit, with its
quirks: ``ell_from_csr`` cuts rows longer than an explicit ``kmax`` without
a word and pads with column 0, value 0; ``bcsr_from_csr`` pads the shape to
whole blocks and drops blocks whose values are all zero; ``csr5_from_csr``
keeps a one-entry ``nonempty_rows`` when every row is empty.  Two builds
differ from the reference's code but not from its output:

* ``ell_from_csr`` fills the slab with one masked copy in place of a Python
  loop over rows (seconds at millions of rows);
* ``bcsr_from_csr`` sums each nonzero into its block straight from the CSR
  arrays, in CSR order, in place of densifying the whole matrix (the
  reference's ``todense`` would take 87 GB at bmwcra_1's full size).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.sparse._tree import host, to_device
from repro_torch.sparse.csr import CSRMatrix


# ---------------------------------------------------------------------------
# ELL (GPU-heritage baseline, paper Sec. 2.3)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ELLMatrix:
    """ELLPACK: two m×k dense matrices, rows padded to the densest row."""

    col_idx: torch.Tensor  # [m, kmax] int32, padded with 0
    vals: torch.Tensor     # [m, kmax], padded with 0.0
    shape: Tuple[int, int]

    @property
    def kmax(self) -> int:
        return int(self.vals.shape[1])

    def to(self, device) -> "ELLMatrix":
        return to_device(self, device)

    def padding_overhead(self) -> float:
        """Padding slots per stored nonzero; explicit zeros count as padding,
        as in the reference (``count_nonzero``)."""
        nnz = float(torch.count_nonzero(self.vals))
        slots = float(self.vals.numel())
        return (slots - nnz) / max(nnz, 1.0)

    def todense(self) -> torch.Tensor:
        m, n = self.shape
        flat = torch.arange(m, device=self.vals.device)[:, None] * n + self.col_idx.long()
        out = torch.zeros(m * n, dtype=self.vals.dtype, device=self.vals.device)
        return out.index_add_(0, flat.reshape(-1), self.vals.reshape(-1)).view(m, n)


def ell_from_csr(csr: CSRMatrix, kmax: int | None = None) -> ELLMatrix:
    """The ELL slab of ``csr``; rows longer than ``kmax`` are cut.

    ``kmax`` defaults (also when 0) to the longest row, at least 1.
    """
    rp = host(csr.row_ptr).astype(np.int64)
    lengths = rp[1:] - rp[:-1]
    kmax = int(kmax or lengths.max(initial=1))
    m = csr.m
    take = np.minimum(lengths, kmax)
    # slot k of row i is filled iff k < take[i]; a boolean-mask copy fills
    # the slab in row-major order, which is the CSR order of the kept entries
    fill = torch.from_numpy(np.arange(kmax)[None, :] < take[:, None])
    ci, vl = csr.col_idx.cpu(), csr.vals.cpu()
    if int(take.sum()) < int(rp[-1]):
        pos = np.arange(rp[-1]) - np.repeat(rp[:-1], lengths)
        keep = torch.from_numpy(pos < kmax)
        ci, vl = ci[keep], vl[keep]
    out_ci = torch.zeros((m, kmax), dtype=torch.int32)
    out_vl = torch.zeros((m, kmax), dtype=vl.dtype)
    out_ci[fill] = ci.to(torch.int32)
    out_vl[fill] = vl
    return ELLMatrix(out_ci, out_vl, csr.shape)


# ---------------------------------------------------------------------------
# BCSR (blocked baseline, paper Sec. 2.1)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BCSRMatrix:
    """Block CSR with bR×bC dense blocks; ``shape`` is padded to whole blocks."""

    block_row_ptr: torch.Tensor  # [mb+1] int32
    block_col_idx: torch.Tensor  # [nblocks] int32
    blocks: torch.Tensor         # [nblocks, bR, bC]
    shape: Tuple[int, int]

    @property
    def block_shape(self) -> Tuple[int, int]:
        return (int(self.blocks.shape[1]), int(self.blocks.shape[2]))

    def to(self, device) -> "BCSRMatrix":
        return to_device(self, device)

    def todense(self) -> torch.Tensor:
        bR, bC = self.block_shape
        mb = int(self.block_row_ptr.shape[0]) - 1
        nb = self.shape[1] // bC
        lengths = (self.block_row_ptr[1:] - self.block_row_ptr[:-1]).long()
        brow = torch.repeat_interleave(
            torch.arange(mb, device=self.blocks.device), lengths,
            output_size=int(self.blocks.shape[0]),
        )
        dense = torch.zeros((mb * nb, bR, bC), dtype=self.blocks.dtype, device=self.blocks.device)
        dense.index_add_(0, brow * nb + self.block_col_idx.long(), self.blocks)
        return dense.view(mb, nb, bR, bC).permute(0, 2, 1, 3).reshape(self.shape)


def bcsr_from_csr(csr: CSRMatrix, br: int = 8, bc: int = 8) -> BCSRMatrix:
    """BCSR of ``csr`` with ``br``×``bc`` blocks, built from the CSR arrays.

    Duplicate entries are summed in CSR order, as the reference's densify
    does, and a block whose values are all zero is dropped, whether its
    entries were explicit zeros or summed to zero.
    """
    m, n = csr.shape
    mp, np_ = -(-m // br) * br, -(-n // bc) * bc
    mb, nb = mp // br, np_ // bc
    rp = host(csr.row_ptr).astype(np.int64)
    rows = np.repeat(np.arange(m, dtype=np.int64), rp[1:] - rp[:-1])
    cols = host(csr.col_idx).astype(np.int64)[: rows.shape[0]]
    key = (rows // br) * nb + cols // bc
    uniq, which = np.unique(key, return_inverse=True)
    vals = csr.vals.cpu()[: rows.shape[0]]
    slot = which.reshape(-1) * (br * bc) + (rows % br) * bc + cols % bc
    # on the CPU index_add_ adds duplicates one after another, in CSR order
    blocks = torch.zeros(uniq.shape[0] * br * bc, dtype=vals.dtype)
    blocks = blocks.index_add_(0, torch.from_numpy(slot), vals).view(-1, br * bc)
    keep = blocks.ne(0).any(dim=1)
    kept = uniq[keep.numpy()]
    block_row_ptr = np.zeros(mb + 1, np.int32)
    np.add.at(block_row_ptr, kept // nb + 1, 1)
    np.cumsum(block_row_ptr, out=block_row_ptr)
    return BCSRMatrix(
        torch.from_numpy(block_row_ptr),
        torch.from_numpy((kept % nb).astype(np.int32)),
        blocks[keep].reshape(-1, br, bc),
        (mp, np_),
    )


# ---------------------------------------------------------------------------
# CSR5-like sigma-tile format (the paper's main competitor, Sec. 2.4)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CSR5LikeMatrix:
    """Simplified CSR5 (Liu & Vinter 2015): nonzeros regrouped into σ×ω tiles
    with a tile pointer and a per-nnz row-start bit flag.

    The in-repo stand-in for the paper's CSR5 comparison: it carries the same
    kind of metadata CSR5 needs (tile_ptr + tile descriptor bit flags), so
    the storage-overhead comparison with CSR-k (paper Sec. 8) is measurable,
    and its SpMV runs (a segmented sum with rows rebuilt from the flags).
    """

    vals: torch.Tensor           # [nnz_padded]
    col_idx: torch.Tensor        # [nnz_padded] int32
    row_flag: torch.Tensor       # [nnz_padded] bool — True at each row's first nnz
    tile_ptr: torch.Tensor       # [T+1] int32 — first row index of each tile
    nonempty_rows: torch.Tensor  # [R] int32 — compacted→actual row ids (empty-row
                                 # support; real CSR5 derives this from tile
                                 # descriptors, so it is left out of the
                                 # overhead accounting below)
    shape: Tuple[int, int]
    sigma: int
    omega: int
    nnz_real: int

    @property
    def tile_size(self) -> int:
        return self.sigma * self.omega

    def to(self, device) -> "CSR5LikeMatrix":
        return to_device(self, device)

    def overhead_bytes(self) -> int:
        """Extra bytes over plain CSR: tile_ptr + packed bit flags (the
        paper's Sec. 8 accounting: the base arrays still serve CSR users)."""
        return int(self.tile_ptr.numel()) * 4 + (int(self.row_flag.numel()) + 7) // 8

    def overhead_fraction(self) -> float:
        base = (2 * self.nnz_real + self.shape[0] + 1) * 4
        return self.overhead_bytes() / base


def csr5_from_csr(csr: CSRMatrix, sigma: int = 16, omega: int = 4) -> CSR5LikeMatrix:
    rp = host(csr.row_ptr)
    nnz = csr.nnz
    tile = sigma * omega
    nnz_pad = -(-max(nnz, 1) // tile) * tile
    vals = torch.zeros(nnz_pad, dtype=csr.vals.dtype)
    cols = torch.zeros(nnz_pad, dtype=torch.int32)
    vals[:nnz] = csr.vals.cpu()
    cols[:nnz] = csr.col_idx.cpu()
    flag = np.zeros(nnz_pad, bool)
    flag[rp[:-1][np.diff(rp) > 0]] = True          # first nnz of each non-empty row
    # first row of each tile = row containing the tile's first nnz
    rows_of_nnz = np.searchsorted(rp, np.arange(0, nnz_pad, tile), side="right") - 1
    tile_ptr = np.concatenate([rows_of_nnz, [csr.m]]).astype(np.int32)
    nonempty = np.nonzero(np.diff(rp) > 0)[0].astype(np.int32)
    if len(nonempty) == 0:
        nonempty = np.zeros(1, np.int32)
    return CSR5LikeMatrix(
        vals, cols, torch.from_numpy(flag), torch.from_numpy(tile_ptr),
        torch.from_numpy(nonempty), csr.shape, sigma, omega, nnz,
    )
