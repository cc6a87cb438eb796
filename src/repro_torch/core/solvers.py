"""Iterative solvers on top of SpMV — the paper's motivating workload (CG).

Port of ``repro.core.solvers``.  The solvers take an abstract ``matvec`` so
they run identically over the plain CSR oracle or the prepared CSR-k
operator.  Block variants (``block_cg``, ``block_power_iteration``) issue one
*batched* matvec per iteration, riding the [n, B] SpMM path.

The JAX ``while_loop`` becomes a Python loop that reads the convergence test
on the host once per iteration (one device sync per iteration).  Every solver
keeps a per-iteration residual-norm history on the device (always, so
enabling telemetry never changes a solution bit) and records it into the
:mod:`repro_torch.obs` registry as a ``solvers.<name>.residual`` series.

Random starting vectors come from an explicit ``torch.Generator`` seeded by
``seed`` (or from a ``v0``/``V0`` argument); they differ from JAX's random
bits, so results agree with the reference in eigenvalues, not in vectors.
"""
from __future__ import annotations

import time
from typing import Callable, NamedTuple

import torch

from repro_torch.obs import get_registry

MatVec = Callable[[torch.Tensor], torch.Tensor]


def _record_solve(name: str, iters: int, residuals: torch.Tensor, seconds: float) -> None:
    """Record one finished solve (no-op when telemetry is disabled)."""
    reg = get_registry()
    if not reg.enabled:
        return
    reg.counter("solvers", f"{name}.solves")
    reg.observe("solvers", f"{name}.iters", iters, unit="count")
    reg.observe("solvers", f"{name}.time_s", seconds, unit="s")
    reg.series("solvers", f"{name}.residual", residuals[:iters].cpu().tolist())


class CGResult(NamedTuple):
    x: torch.Tensor
    iters: int
    residual: torch.Tensor


def cg(
    matvec: MatVec,
    b: torch.Tensor,
    x0: torch.Tensor | None = None,
    *,
    tol: float = 1e-6,
    maxiter: int = 500,
) -> CGResult:
    """Conjugate gradients for SPD A (paper Sec. 1: the SpMV consumer).

    Args:
      matvec: y = A x for x of shape [n].
      b: right-hand side, shape [n].
      x0: optional initial guess, shape [n] (defaults to zeros).
      tol: relative residual tolerance (on ‖r‖ / ‖b‖).
      maxiter: iteration cap.

    Returns:
      :class:`CGResult` with the solution ``x`` [n], iteration count and the
      final (recurrence) residual norm.
    """
    t_start = time.perf_counter()
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - matvec(x)
    p = r
    rs = torch.dot(r, r)
    tol2 = torch.tensor(tol, dtype=b.dtype, device=b.device) ** 2 * torch.clamp_min(
        torch.dot(b, b), 1e-30
    )
    hist = torch.zeros(maxiter, dtype=torch.float32, device=b.device)
    k = 0
    while k < maxiter and bool(rs > tol2):
        Ap = matvec(p)
        alpha = rs / torch.clamp_min(torch.dot(p, Ap), 1e-30)
        x = x + alpha * p
        r = r - alpha * Ap
        rs_new = torch.dot(r, r)
        p = r + (rs_new / torch.clamp_min(rs, 1e-30)) * p
        hist[k] = torch.sqrt(rs_new)
        rs = rs_new
        k += 1
    _record_solve("cg", k, hist, time.perf_counter() - t_start)
    return CGResult(x=x, iters=k, residual=torch.sqrt(rs))


class BlockCGResult(NamedTuple):
    X: torch.Tensor         # [n, B] solution block
    iters: int              # iterations until every column converged
    residual: torch.Tensor  # [B] per-column residual norms


def block_cg(
    matvec: MatVec,
    B: torch.Tensor,
    X0: torch.Tensor | None = None,
    *,
    tol: float = 1e-6,
    maxiter: int = 500,
) -> BlockCGResult:
    """Conjugate gradients for SPD A with multiple right-hand sides.

    Each column runs its own CG recurrence (per-column α/β; converged columns
    freeze), but all columns share one SpMM A·P per step.

    Args:
      matvec: Y = A X for X of shape [n, nrhs].
      B: right-hand-side block, shape [n, nrhs] (raises otherwise).
      X0: optional initial guess, shape [n, nrhs] (defaults to zeros).
      tol: per-column relative residual tolerance.
      maxiter: iteration cap (counts until *every* column converged).
    """
    if B.ndim != 2:
        raise ValueError(f"block_cg expects B of shape [n, nrhs], got {tuple(B.shape)}")
    t_start = time.perf_counter()
    X = torch.zeros_like(B) if X0 is None else X0
    R = B - matvec(X)
    P = R
    rs = torch.sum(R * R, dim=0)                                 # [nrhs]
    tol2 = torch.tensor(tol, dtype=B.dtype, device=B.device) ** 2 * torch.clamp_min(
        torch.sum(B * B, dim=0), 1e-30
    )
    hist = torch.zeros(maxiter, dtype=torch.float32, device=B.device)  # worst column
    k = 0
    while k < maxiter and bool(torch.any(rs > tol2)):
        AP = matvec(P)                                           # one SpMM
        active = (rs > tol2).to(B.dtype)                         # freeze done cols
        alpha = active * rs / torch.clamp_min(torch.sum(P * AP, dim=0), 1e-30)
        X = X + alpha[None, :] * P
        R = R - alpha[None, :] * AP
        rs_new = torch.sum(R * R, dim=0)
        beta = rs_new / torch.clamp_min(rs, 1e-30)
        P = torch.where(active[None, :] > 0, R + beta[None, :] * P, P)
        rs = torch.where(active > 0, rs_new, rs)
        hist[k] = torch.sqrt(torch.max(rs))
        k += 1
    _record_solve("block_cg", k, hist, time.perf_counter() - t_start)
    return BlockCGResult(X=X, iters=k, residual=torch.sqrt(rs))


def _start(shape, seed: int, v0, device) -> torch.Tensor:
    if v0 is not None:
        return v0
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=gen, dtype=torch.float32).to(device)


def power_iteration(
    matvec: MatVec, n: int, *, iters: int = 50, seed: int = 0,
    v0: torch.Tensor | None = None, device="cuda",
) -> torch.Tensor:
    """Dominant eigenvalue estimate — a second SpMV-bound consumer.

    The start vector is ``v0`` or, if None, normal draws from a
    ``torch.Generator`` seeded with ``seed``, placed on ``device``.
    """
    v = _start((n,), seed, v0, device)
    v = v / torch.linalg.norm(v)
    for _ in range(iters):
        w = matvec(v)
        v = w / torch.clamp_min(torch.linalg.norm(w), 1e-30)
    return torch.dot(v, matvec(v))


def block_power_iteration(
    matvec: MatVec, n: int, k: int, *, iters: int = 50, seed: int = 0,
    V0: torch.Tensor | None = None, device="cuda",
) -> torch.Tensor:
    """Top-k eigenvalue estimates via subspace (orthogonal) iteration.

    One batched matvec (SpMM over a [n, k] block) per sweep followed by a QR
    re-orthonormalisation.  The start block is ``V0`` or normal draws from a
    ``torch.Generator`` seeded with ``seed``, placed on ``device``.

    Returns:
      [k] Rayleigh-quotient eigenvalue estimates, descending.
    """
    t_start = time.perf_counter()
    V, _ = torch.linalg.qr(_start((n, k), seed, V0, device))
    for _ in range(iters):
        V, _ = torch.linalg.qr(matvec(V))                        # one SpMM
    H = V.T @ matvec(V)                                          # [k, k] Rayleigh
    evals = torch.flip(torch.linalg.eigvalsh((H + H.T) / 2), dims=(0,))
    reg = get_registry()
    if reg.enabled:
        reg.counter("solvers", "block_power_iteration.solves")
        reg.observe("solvers", "block_power_iteration.iters", iters, unit="count")
        reg.observe("solvers", "block_power_iteration.time_s",
                    time.perf_counter() - t_start, unit="s")
    return evals


def jacobi_smoother(
    matvec: MatVec, diag: torch.Tensor, b: torch.Tensor, *, iters: int = 10,
    omega: float = 0.67,
) -> torch.Tensor:
    """Weighted-Jacobi relaxation (SpMV per sweep) — multigrid building block."""
    x = torch.zeros_like(b)
    for _ in range(iters):
        x = x + omega * (b - matvec(x)) / diag
    return x
