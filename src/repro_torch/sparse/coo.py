"""Coordinate-list (COO) sparse container (paper Sec. 2.1).

Port of ``repro.sparse.coo``: the same fields, held as torch tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.sparse._tree import to_device


@dataclasses.dataclass(frozen=True)
class COOMatrix:
    """Coordinate-list matrix (paper Sec. 2.1)."""

    row_idx: torch.Tensor  # [nnz] int32
    col_idx: torch.Tensor  # [nnz] int32
    vals: torch.Tensor     # [nnz] float
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return int(self.vals.shape[0])

    @property
    def dtype(self):
        return self.vals.dtype

    def to(self, device) -> "COOMatrix":
        return to_device(self, device)

    def todense(self) -> torch.Tensor:
        out = torch.zeros(self.shape, dtype=self.vals.dtype, device=self.vals.device)
        flat = self.row_idx.long() * self.shape[1] + self.col_idx.long()
        return out.view(-1).index_add_(0, flat, self.vals).view(self.shape)

    def tocsr(self):
        from repro_torch.sparse.csr import csr_from_coo

        return csr_from_coo(self)

    @classmethod
    def fromdense(cls, dense) -> "COOMatrix":
        """Nonzeros of a dense numpy array or tensor, in row-major order.

        float64 input is stored as float32, as the reference's arrays are
        under JAX's default (64-bit mode off).
        """
        if isinstance(dense, torch.Tensor):
            dense = dense.detach().cpu().numpy()
        dense = np.asarray(dense)
        if dense.dtype == np.float64:
            dense = dense.astype(np.float32)
        r, c = np.nonzero(dense)
        return cls(
            torch.from_numpy(r.astype(np.int32)),
            torch.from_numpy(c.astype(np.int32)),
            torch.from_numpy(np.ascontiguousarray(dense[r, c])),
            tuple(dense.shape),
        )
