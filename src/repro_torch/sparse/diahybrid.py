"""Partially-diagonal hybrid: dense diagonals as DIA + a CSR remainder.

Port of ``repro.sparse.diahybrid``.  Fukaya et al. (arXiv:2105.04937)
observe that finite-difference and finite-element matrices concentrate
nearly all nnz on a handful of *dense* diagonals; storing those as a DIA
plane turns most of the SpMV into unit-stride value and x reads with no
column indices, while the leftover nnz (boundary fringes, irregular
couplings) stay in a small CSR remainder.

:class:`DIAHybridMatrix` keeps the plane as ``diag_vals[n_diag, m]`` with
``diag_vals[k, i] = A[i, i + offsets[k]]`` (row-major per diagonal).
:func:`dense_diagonals` is the extraction policy: a diagonal qualifies when
it fills at least an ``occupancy`` fraction of the ``m`` plane slots its row
would cost, the same census behind ``MatrixStats.diag_fraction``.  The host
build is the reference's numpy, so every array equals the reference's bit
for bit.  The port adds fields the reference does not have, all built
from the reference's arrays alone and moving with the container:

* ``offset_vec`` — the offsets as an int32 tensor, which the CUDA kernel
  reads on the device (without an upload per call);
* ``rem_rows``, ``rem_start``, ``rem_mask`` — the remainder's row list
  (:func:`remainder_rows`): the rows that hold remainder entries, each one's
  first entry, and one bit per row.  The kernel finds the remainder through
  them and never reads ``remainder.row_ptr``, which costs 4 bytes a row of
  the matrix; at ``stencil_fringe(2048)`` the list takes 0.86 MB against
  the row pointer's 16.8 MB.

``modeled_bytes``, ``overhead_bytes`` and ``padding_overhead`` stay the
reference's figures.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.sparse._tree import host, to_device
from repro_torch.sparse.csr import CSRMatrix
from repro_torch.sparse.csrk import VALUE_BYTES, _i32
from repro_torch.sparse.stats import DIAG_OCCUPANCY


@dataclasses.dataclass(frozen=True)
class DIAHybridMatrix:
    """Dense-diagonal DIA plane + CSR remainder (arXiv:2105.04937 style).

    ``diag_vals[k, i]`` holds ``A[i, i + offsets[k]]`` (0 where the diagonal
    runs off the matrix or the entry is absent); ``remainder`` carries every
    nnz not on a dense diagonal and always stays f32.
    """

    diag_vals: torch.Tensor     # [n_diag, m] f32 | bf16
    offsets: Tuple[int, ...]    # ascending; diagonal k is col = row + offsets[k]
    remainder: CSRMatrix        # off-diagonal nnz, f32
    shape: Tuple[int, int]
    offset_vec: torch.Tensor    # [n_diag] int32, ``offsets`` on the container's device
    rem_rows: torch.Tensor      # [R] int32 rows holding remainder entries, ascending (port-only)
    rem_start: torch.Tensor     # [R + 1] int32 each listed row's first entry, then rem nnz
    rem_mask: torch.Tensor      # [ceil(m / 32)] int32, bit i % 32 of word i // 32: row i listed
    diag_nnz: int = 0           # real nnz captured by the plane
    value_dtype: str = "f32"    # dtype of diag_vals ("f32" | "bf16")

    @property
    def m(self) -> int:
        return self.shape[0]

    @property
    def n(self) -> int:
        return self.shape[1]

    @property
    def n_diag(self) -> int:
        return int(self.diag_vals.shape[0])

    @property
    def nnz(self) -> int:
        return self.diag_nnz + self.remainder.nnz

    def to(self, device) -> "DIAHybridMatrix":
        return to_device(self, device)

    def padding_overhead(self) -> float:
        """Stored-but-absent slot fraction of the DIA plane: bounded by
        ``n_diag · m / diag_nnz − 1 ≤ 1/occupancy − 1`` by construction."""
        real = float(max(self.nnz, 1))
        return (self.n_diag * self.m + self.remainder.nnz - self.nnz) / real

    def overhead_bytes(self) -> int:
        """Index metadata bytes: the remainder's CSR streams (the plane needs
        no per-entry indices)."""
        return self.remainder.nnz * 4 + (self.m + 1) * 4

    def modeled_bytes(self) -> int:
        """Modeled per-SpMV HBM traffic of the reference's Pallas design.

        The plane streams ``n_diag · m`` values plus one shifted x read per
        diagonal slot and one y write per row; the remainder pays the CSR toll
        (value + column + x gather per nnz, row_ptr stream).  The CUDA kernel
        reads x far less often (PERF.md gives the bound it is held to).
        """
        vb = VALUE_BYTES[self.value_dtype]
        plane = self.n_diag * self.m * (vb + 4) + self.m * 4
        rem = self.remainder.nnz * 12 + (self.m + 1) * 4
        return plane + rem

    def todense(self) -> torch.Tensor:
        m, n = self.shape
        out = self.remainder.todense().to(torch.float32)
        rows = torch.arange(m, device=out.device)
        vals = self.diag_vals.to(torch.float32)
        for k, off in enumerate(self.offsets):
            keep = (rows + off >= 0) & (rows + off < n)
            out[rows[keep], rows[keep] + off] += vals[k][keep]
        return out


def remainder_rows(rem_row_ptr) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The remainder's row list from its CSR row pointer ``[m + 1]``:
    ``(rows, start, mask)`` as int32 numpy arrays.

    ``rows`` are the rows with at least one entry, ascending; ``start[j]``
    is row ``rows[j]``'s first entry and ``start[R]`` the entry count, so
    row ``rows[j]`` holds entries ``[start[j], start[j + 1])``; ``mask`` has
    bit ``i % 32`` of word ``i // 32`` set for every listed row ``i``.
    """
    rp = np.asarray(rem_row_ptr, np.int64)
    m = rp.shape[0] - 1
    rows = np.flatnonzero(rp[1:] > rp[:-1])
    start = np.append(rp[rows], rp[-1])
    mask = np.zeros(-(-m // 32), np.uint32)
    np.add.at(mask, rows >> 5, np.left_shift(1, rows & 31).astype(np.uint32))
    return rows.astype(np.int32), start.astype(np.int32), mask.view(np.int32)


def dense_diagonals(csr: CSRMatrix, occupancy: float = DIAG_OCCUPANCY) -> np.ndarray:
    """Offsets (ascending int64) of the diagonals dense enough to earn a DIA
    plane row: nnz on the diagonal ≥ ``occupancy · m``.  Host-side, O(nnz+m+n).
    """
    m, n = csr.shape
    rp = host(csr.row_ptr)
    ci = host(csr.col_idx).astype(np.int64)
    lengths = (rp[1:] - rp[:-1]).astype(np.int64)
    if not int(rp[-1]):
        return np.zeros((0,), np.int64)
    offs = ci - np.repeat(np.arange(m, dtype=np.int64), lengths)
    counts = np.bincount(offs + (m - 1), minlength=m + n - 1)
    off_vals = np.arange(-(m - 1), n, dtype=np.int64)
    dense = (counts > 0) & (counts >= occupancy * max(m, 1))
    return off_vals[dense]


def diahybrid_from_csr(
    csr: CSRMatrix,
    occupancy: float = DIAG_OCCUPANCY,
    value_dtype: str = "f32",
) -> DIAHybridMatrix:
    """Split CSR into a dense-diagonal DIA plane + CSR remainder (host-side
    numpy: setup phase).  The result lives on the CPU.

    Args:
      csr: the source matrix.
      occupancy: extraction threshold for :func:`dense_diagonals`.
      value_dtype: "f32" | "bf16" storage for the plane.  int8 is rejected:
        the plane has no slot grouping to hang grouped scales on.
    """
    if value_dtype not in ("f32", "bf16"):
        raise ValueError(f"diahybrid supports value_dtype f32|bf16, got {value_dtype!r}")
    m, n = csr.shape
    rp = host(csr.row_ptr)
    ci = host(csr.col_idx).astype(np.int64)
    vl = host(csr.vals).astype(np.float32)
    lengths = (rp[1:] - rp[:-1]).astype(np.int64)
    rows = np.repeat(np.arange(m, dtype=np.int64), lengths)
    offs = ci - rows

    offsets = dense_diagonals(csr, occupancy)
    diag_id = np.full(m + n - 1, -1, np.int64)
    diag_id[offsets + (m - 1)] = np.arange(offsets.size)
    k_of = diag_id[offs + (m - 1)]
    on_diag = k_of >= 0

    diag_vals = np.zeros((offsets.size, m), np.float32)
    diag_vals[k_of[on_diag], rows[on_diag]] = vl[on_diag]

    rem_rp = np.zeros(m + 1, np.int32)
    np.add.at(rem_rp, rows[~on_diag] + 1, 1)
    np.cumsum(rem_rp, out=rem_rp)
    remainder = CSRMatrix(
        torch.from_numpy(rem_rp),
        _i32(ci[~on_diag]),
        torch.from_numpy(np.ascontiguousarray(vl[~on_diag])),
        (m, n),
    )
    plane = torch.from_numpy(diag_vals)
    if value_dtype == "bf16":
        plane = plane.to(torch.bfloat16)   # round to nearest even, as in JAX
    return DIAHybridMatrix(
        plane,
        tuple(int(o) for o in offsets),
        remainder,
        (m, n),
        _i32(offsets),
        *(torch.from_numpy(a) for a in remainder_rows(rem_rp)),
        diag_nnz=int(on_diag.sum()),
        value_dtype=value_dtype,
    )
