"""DIA/CSR-hybrid SpMV: the CUDA kernel's wrapper and its plain version.

Replaces ``repro.kernels.spmv_diahybrid.spmv_dia_pallas`` together with the
CSR remainder that ``repro.kernels.ops.spmv_diahybrid`` adds after it.  On
CUDA tensors :func:`spmv_diahybrid_rows` launches the hand-written Hopper
kernel in ``csrc/spmv_diahybrid.cu`` (design notes there: one launch, the
plane rows streamed 16 bytes a thread, the remainder rows found through the
port's row list and each summed by a group of lanes); on CPU tensors it runs
the plain PyTorch version :func:`repro_torch.kernels.ref.diahybrid_list_rows`
over the same arrays.  There is no fallback from one to the other: a CUDA
input the kernel does not take raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.spmv_csrk import X_KIND, check_operand

_VALUE_KIND = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built kernel library, with its C signature declared (once)."""
    lib = build.load("spmv_diahybrid")
    lib.repro_spmv_diahybrid.argtypes = [
        _I, _I, _P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _P, _I, _P, _I, _I, _P]
    lib.repro_spmv_diahybrid.restype = _I
    lib.repro_diahybrid_error_string.argtypes = [_I]
    lib.repro_diahybrid_error_string.restype = ctypes.c_char_p
    return lib


def fringe_lanes(rem_nnz: int, R: int) -> int:
    """G, the lanes that sum one listed row's remainder: the largest power of
    two, 1 to 32, not above a quarter of the mean entries per listed row
    (rounded to the nearest integer), so a lane sums about four entries.

    It comes from the shapes alone (no device read) and never from B, so a
    row's summation order is the same at every width.
    """
    quarter = (rem_nnz + 2 * R) // (4 * R) if R else 0
    return min(32, 1 << (max(quarter, 1).bit_length() - 1))


def spmv_diahybrid_rows(
    diag_vals: torch.Tensor,        # [n_diag, m] f32 | bf16
    offsets: torch.Tensor,          # [n_diag] int32, on x's device
    rem_rows: torch.Tensor,         # [R] int32
    rem_start: torch.Tensor,        # [R + 1] int32
    rem_mask: torch.Tensor,         # [ceil(m / 32)] int32
    rem_col_idx: torch.Tensor,      # [rem_nnz] int32
    rem_vals: torch.Tensor,         # [rem_nnz] f32
    x: torch.Tensor,                # [n] or [n, B] f32 | bf16
    *,
    m: int,
    n: int,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """y = plane·x + remainder·x in row order: ``[m]`` (``[m, B]``).

    The remainder is given by the port's row list
    (``DIAHybridMatrix.rem_rows``/``rem_start``/``rem_mask``), not by its row
    pointer.  ``offsets`` must already lie on x's device
    (``DIAHybridMatrix.offset_vec`` is built once with the container): the
    wrapper uploads nothing, so a call can be captured in a CUDA graph.  The
    kernel writes every row of y, so ``out`` (if given, ``[m]``/``[m, B]``
    in x's dtype on x's device) need not be cleared.  On CUDA ``x`` is
    float32 or bfloat16 and y comes out in x's dtype: a row's plane part and
    remainder are added in f32 and rounded once.  CUDA calls add one to
    ``spmv_diahybrid_rows.launches``; each is one CUDA launch.
    """
    if x.device.type == "cpu":
        y = ref.diahybrid_list_rows(diag_vals, offsets, rem_rows, rem_start, rem_mask,
                                    rem_col_idx, rem_vals, x, m=m, n=n)
        return y if out is None else out.copy_(y)

    dev = x.device
    if diag_vals.ndim != 2 or diag_vals.shape[1] != m:
        raise ValueError(f"diag_vals must be [n_diag, {m}], got shape {tuple(diag_vals.shape)}")
    n_diag = int(diag_vals.shape[0])
    if x.ndim not in (1, 2) or x.shape[0] != n:
        raise ValueError(f"x must be [{n}] or [{n}, B], got shape {tuple(x.shape)}")
    B = 1 if x.ndim == 1 else int(x.shape[1])
    check_operand("x", x, dev, tuple(X_KIND))
    check_operand("diag_vals", diag_vals, dev, tuple(_VALUE_KIND))
    check_operand("offsets", offsets, dev, (torch.int32,), (n_diag,))
    if max(m, n) >= 2**31:
        raise ValueError(f"m and n must be below 2^31, got {m} and {n}")
    if rem_rows.ndim != 1 or rem_vals.ndim != 1:
        raise ValueError(f"rem_rows and rem_vals must be 1-d, got shapes "
                         f"{tuple(rem_rows.shape)} and {tuple(rem_vals.shape)}")
    R, rem_nnz = int(rem_rows.shape[0]), int(rem_vals.shape[0])
    if R > m:
        raise ValueError(f"{R} listed rows for {m} rows")
    check_operand("rem_rows", rem_rows, dev, (torch.int32,))
    check_operand("rem_start", rem_start, dev, (torch.int32,), (R + 1,))
    check_operand("rem_mask", rem_mask, dev, (torch.int32,), (-(-m // 32),))
    check_operand("rem_vals", rem_vals, dev, (torch.float32,))
    check_operand("rem_col_idx", rem_col_idx, dev, (torch.int32,), (rem_nnz,))
    if out is None:
        out = torch.empty((m,) + tuple(x.shape[1:]), dtype=x.dtype, device=dev)
    else:
        check_operand("out", out, dev, (x.dtype,), (m,) + tuple(x.shape[1:]))
    if out.numel() == 0:
        return out

    lib = _library()
    err = lib.repro_spmv_diahybrid(
        _VALUE_KIND[diag_vals.dtype], X_KIND[x.dtype], diag_vals.data_ptr(), offsets.data_ptr(),
        n_diag,
        rem_rows.data_ptr(), rem_start.data_ptr(), rem_mask.data_ptr(), rem_col_idx.data_ptr(),
        rem_vals.data_ptr(), R, fringe_lanes(rem_nnz, R).bit_length() - 1, x.data_ptr(), B,
        out.data_ptr(), m, n, torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            f"spmv_diahybrid kernel launch failed: "
            f"{lib.repro_diahybrid_error_string(err).decode()}"
        )
    spmv_diahybrid_rows.launches += 1
    return out


spmv_diahybrid_rows.launches = 0
