"""Compressed sparse row (CSR) container — the interchange format every other
format converts from (the paper's heterogeneity pivot).

Port of ``repro.sparse.csr``.  The host-side reorderings are vectorised
numpy; they produce the same arrays as the reference's per-row loops.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Tuple

import numpy as np
import torch

from repro_torch.sparse._tree import host, to_device
from repro_torch.sparse.coo import COOMatrix

#: numpy's names for the value dtypes, which the reference hashes.
_NP_DTYPE_NAME = {
    torch.float32: "float32",
    torch.float64: "float64",
    torch.float16: "float16",
    torch.bfloat16: "bfloat16",
    torch.int8: "int8",
    torch.int32: "int32",
}


def _raw_bytes(t: torch.Tensor) -> bytes:
    return t.detach().cpu().contiguous().view(torch.uint8).numpy().tobytes()


@dataclasses.dataclass(frozen=True)
class CSRMatrix:
    """Compressed sparse row matrix (paper Sec. 2.1, Fig. 2 black arrays)."""

    row_ptr: torch.Tensor  # [m+1] int32, cumulative nnz
    col_idx: torch.Tensor  # [nnz] int32
    vals: torch.Tensor     # [nnz] float
    shape: Tuple[int, int]

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
    def dtype(self):
        return self.vals.dtype

    @property
    def device(self) -> torch.device:
        return self.vals.device

    @property
    def rdensity(self) -> float:
        """Mean row density NNZ/N — the tuning model's sole input (paper Sec. 4)."""
        return self.nnz / max(self.m, 1)

    def to(self, device) -> "CSRMatrix":
        return to_device(self, device)

    def row_lengths(self) -> torch.Tensor:
        return self.row_ptr[1:] - self.row_ptr[:-1]

    def fingerprint(self) -> str:
        """Content hash of the matrix: shape + dtype + the three CSR streams.

        Equal to ``repro.sparse.CSRMatrix.fingerprint`` on equal content: the
        dtype is hashed under numpy's name (``"float32"``, not
        ``"torch.float32"``) and every stream as its raw bytes.
        """
        h = hashlib.blake2b(digest_size=16)
        h.update(np.asarray([self.shape[0], self.shape[1]], np.int64).tobytes())
        h.update(_NP_DTYPE_NAME[self.vals.dtype].encode())
        h.update(_raw_bytes(self.row_ptr))
        h.update(_raw_bytes(self.col_idx))
        h.update(_raw_bytes(self.vals))
        return h.hexdigest()

    def _rows(self) -> torch.Tensor:
        return torch.repeat_interleave(
            torch.arange(self.m, device=self.device), self.row_lengths().long(),
            output_size=self.nnz,
        )

    def todense(self) -> torch.Tensor:
        return self.tocoo().todense()

    def tocoo(self) -> COOMatrix:
        return COOMatrix(self._rows().int(), self.col_idx, self.vals, self.shape)

    @classmethod
    def fromdense(cls, dense) -> "CSRMatrix":
        return COOMatrix.fromdense(dense).tocsr()

    def row_slice(self, r0: int, r1: int) -> "CSRMatrix":
        """Return the contiguous row block ``A[r0:r1, :]`` as a CSR matrix.

        The nnz arrays are views; column indices stay global (shape is
        [r1−r0, n]).  Used by the distributed layer's per-shard statistics.
        """
        rp = host(self.row_ptr)
        s, e = int(rp[r0]), int(rp[r1])
        new_rp = (rp[r0 : r1 + 1] - rp[r0]).astype(np.int32)
        return CSRMatrix(
            torch.from_numpy(new_rp).to(self.row_ptr.device),
            self.col_idx[s:e],
            self.vals[s:e],
            (r1 - r0, self.shape[1]),
        )

    def permute_rows(self, perm: np.ndarray) -> "CSRMatrix":
        """Return PA for a row permutation ``perm`` (new row i = old row perm[i])."""
        perm = np.asarray(perm)
        rp = host(self.row_ptr).astype(np.int64)
        lengths = (rp[1:] - rp[:-1])[perm]
        new_rp = np.zeros(self.m + 1, np.int32)
        np.cumsum(lengths, out=new_rp[1:])
        # source position of every output slot: row perm[i]'s run, in order
        src = np.repeat(rp[perm] - new_rp[:-1], lengths) + np.arange(int(new_rp[-1]))
        idx = torch.from_numpy(src)
        return CSRMatrix(
            torch.from_numpy(new_rp),
            self.col_idx.cpu()[idx],
            self.vals.cpu()[idx],
            self.shape,
        )

    def permute_cols(self, perm: np.ndarray) -> "CSRMatrix":
        """Return A P^T: new column j corresponds to old column perm[j]."""
        perm = np.asarray(perm)
        inv = np.empty_like(perm)
        inv[perm] = np.arange(perm.size)
        new_ci = inv[host(self.col_idx)]
        # keep rows sorted by column for band-window friendliness; lexsort is
        # stable, so this equals a stable per-row argsort
        rp = host(self.row_ptr).astype(np.int64)
        rows = np.repeat(np.arange(self.m), rp[1:] - rp[:-1])
        order = np.lexsort((new_ci, rows))
        return CSRMatrix(
            self.row_ptr,
            torch.from_numpy(new_ci[order].astype(np.int32)),
            self.vals.cpu()[torch.from_numpy(order)],
            self.shape,
        )

    def symmetric_permute(self, perm: np.ndarray) -> "CSRMatrix":
        """P A P^T — what a reordering like RCM/Band-k applies."""
        return self.permute_rows(perm).permute_cols(perm)


def csr_from_coo(coo: COOMatrix) -> CSRMatrix:
    """Sort-based COO→CSR conversion (host-side numpy: setup phase)."""
    m, n = coo.shape
    r = host(coo.row_idx)
    c = host(coo.col_idx)
    order = np.lexsort((c, r))
    r, c = r[order], c[order]
    row_ptr = np.zeros(m + 1, np.int32)
    np.add.at(row_ptr, r + 1, 1)
    np.cumsum(row_ptr, out=row_ptr)
    return CSRMatrix(
        torch.from_numpy(row_ptr),
        torch.from_numpy(c.astype(np.int32)),
        coo.vals.cpu()[torch.from_numpy(order)],
        (m, n),
    )
