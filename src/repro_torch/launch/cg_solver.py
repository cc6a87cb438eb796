"""Distributed conjugate-gradient solve — the paper's target workload.

    PYTHONPATH=src python -m repro_torch.launch.cg_solver [--shards 8] [--nrhs 4]
        [--device cuda|cpu]

Port of ``examples/cg_solver.py``.  Solves A x = b for a banded PDE matrix
with the row-partitioned SpMV (halo-exchange, then all-gather) over
``--shards`` row-block shards, then checks the solution.  The reference fakes
an N-device host mesh (``--devices N``); here the shards are laid
round-robin over the visible devices of ``--device`` (on a one-card machine,
all on the card).  It runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from repro_torch.configs.spmv_suite import grid_laplacian_2d
from repro_torch.core.distributed import dist_spmv_allgather, dist_spmv_halo, shard_csr
from repro_torch.core.ordering import bandk
from repro_torch.core.solvers import block_cg, cg
from repro_torch.core.spmv import prepare
from repro_torch.launch.mesh import make_host_mesh


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shards", type=int, default=8, help="row-block shards D")
    ap.add_argument("--nrhs", type=int, default=1,
                    help="right-hand sides; >1 adds a block-CG solve (one SpMM "
                         "per iteration for all columns)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    mesh = make_host_mesh(args.shards, device=args.device)
    dev = mesh.devices[0]
    A = grid_laplacian_2d(48, 48)
    A = A.symmetric_permute(bandk(A))          # Band-k keeps shard halos narrow
    S = shard_csr(A.to(dev), mesh.shape["data"])
    print(f"A: {A.shape}, nnz={A.nnz} | shards={mesh.shape['data']} on "
          f"{sorted({str(d) for d in mesh.devices})} | rows/shard={S.rows_per_shard} "
          f"halo={S.halo}")

    rng = np.random.default_rng(0)
    dense = A.todense().numpy()
    x_true = rng.standard_normal(A.m).astype(np.float32)
    b = torch.from_numpy(dense @ x_true).to(dev)

    res = cg(lambda v: dist_spmv_halo(S, v, mesh), b, tol=1e-6, maxiter=4000)
    err = float((res.x.cpu() - torch.from_numpy(x_true)).abs().max())
    print(f"halo-exchange CG: iters={int(res.iters)} residual={float(res.residual):.2e} "
          f"max err={err:.2e}")
    if not err < 5e-2:
        print("halo-exchange CG did not converge", file=sys.stderr)
        return 1

    res2 = cg(lambda v: dist_spmv_allgather(S, v, mesh), b, tol=1e-6, maxiter=4000)
    print(f"all-gather CG:    iters={int(res2.iters)} residual={float(res2.residual):.2e}")
    print(f"halo traffic per SpMV: 2×{S.halo}×4B/shard vs all-gather {A.m * 4}B — "
          f"{A.m / max(2 * S.halo, 1):.0f}× less")

    if args.nrhs > 1:
        # Multi-RHS solve via the prepared single-device operator: block CG
        # runs one batched SpMM per iteration for all --nrhs columns.
        op = prepare(A, "cpu", device=dev, reorder="natural")
        X_true = rng.standard_normal((A.m, args.nrhs)).astype(np.float32)
        Bmat = torch.from_numpy(dense @ X_true).to(dev)
        bres = block_cg(op, Bmat, tol=1e-6, maxiter=4000)
        berr = float((bres.X.cpu() - torch.from_numpy(X_true)).abs().max())
        print(f"block CG ({args.nrhs} RHS): iters={int(bres.iters)} "
              f"max residual={float(bres.residual.max()):.2e} max err={berr:.2e}")
        if not berr < 5e-2:
            print("block CG did not converge", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
