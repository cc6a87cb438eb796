"""ELL SpMV: the CUDA kernel's wrapper and its plain version.

Replaces ``repro.kernels.spmv_ell.spmv_ell_pallas``.  On CUDA tensors
:func:`spmv_ell_rows` launches the hand-written Hopper kernel in
``csrc/spmv_ell.cu`` (design notes there: 8 threads per row of the
row-major slab, each summing fixed strands of 16-byte vectors around a head
and tail taken slot by slot, then a fixed shuffle fold); on CPU tensors it
runs the plain PyTorch version :func:`repro_torch.kernels.ref.ell_rows`.
There is no fallback from one to the other: a CUDA input the kernel does not
take raises.  Like the reference's kernel and oracle, it takes a vector x only.
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
    lib = build.load("spmv_ell")
    lib.repro_spmv_ell.argtypes = [_I, _I, _P, _P, _P, _P, _I, _I, _I, _P]
    lib.repro_spmv_ell.restype = _I
    lib.repro_ell_error_string.argtypes = [_I]
    lib.repro_ell_error_string.restype = ctypes.c_char_p
    return lib


def spmv_ell_rows(
    col_idx: torch.Tensor,   # [m, kmax] int32
    vals: torch.Tensor,      # [m, kmax] f32 | bf16
    x: torch.Tensor,         # [n] f32 | bf16
    *,
    m: int,
    n: int,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """y = slab · x, ``[m]``: every slot multiplied, padding included.

    ``x`` must be a vector: the reference has no batched ELL body, so an
    ``[n, B]`` x raises on every device.  The kernel writes every row of y,
    so ``out`` (if given, ``[m]`` in x's dtype on x's device) need not be
    cleared.  On CUDA ``x`` is float32 or bfloat16 and y comes out in x's
    dtype, summed in f32 and rounded once.
    CUDA calls add one to ``spmv_ell_rows.launches``; each is one CUDA
    launch.
    """
    if x.ndim != 1 or x.shape[0] != n:
        raise ValueError(f"x must be [{n}] (ELL has no batched form), got shape "
                         f"{tuple(x.shape)}")
    if x.device.type == "cpu":
        y = ref.ell_rows(col_idx, vals, x)
        return y if out is None else out.copy_(y)

    dev = x.device
    if vals.ndim != 2 or vals.shape[0] != m:
        raise ValueError(f"vals must be [{m}, kmax], got shape {tuple(vals.shape)}")
    kmax = int(vals.shape[1])
    # slot offsets are 64-bit in the kernel; m, n and kmax travel as C ints
    if max(m, n, kmax) >= 2**31:
        raise ValueError(f"m, n and kmax must be below 2^31, got {m}, {n} and {kmax}")
    check_operand("x", x, dev, tuple(X_KIND))
    check_operand("vals", vals, dev, tuple(_VALUE_KIND))
    check_operand("col_idx", col_idx, dev, (torch.int32,), (m, kmax))
    if out is None:
        out = torch.empty(m, dtype=x.dtype, device=dev)
    else:
        check_operand("out", out, dev, (x.dtype,), (m,))
    if m == 0:
        return out

    lib = _library()
    err = lib.repro_spmv_ell(
        _VALUE_KIND[vals.dtype], X_KIND[x.dtype], col_idx.data_ptr(), vals.data_ptr(),
        x.data_ptr(), out.data_ptr(), m, n, kmax,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            f"spmv_ell kernel launch failed: {lib.repro_ell_error_string(err).decode()}"
        )
    spmv_ell_rows.launches += 1
    return out


spmv_ell_rows.launches = 0
