"""Quickstart: the paper's pipeline in one call and one check.

    PYTHONPATH=src python -m repro_torch.launch.quickstart [--grid 64] [--device cuda|cpu]

Port of ``examples/quickstart.py``.  Build a sparse matrix → Band-k
reorder → constant-time tune → CSR-k build → SpMV through the CSR-k CUDA
kernel (on the CPU, through its plain PyTorch version) → check against
plain CSR, and show the format's storage overhead (paper Fig. 12).  It runs
on the card unless ``--device cpu`` is given, and raises where CUDA is
asked for and absent.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from repro_torch.configs.spmv_suite import grid_laplacian_2d
from repro_torch.core.ordering import bandwidth
from repro_torch.core.spmv import prepare, spmv


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--grid", type=int, default=64, help="side of the 2D grid Laplacian")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    # a 2D PDE matrix (the "ecology1" family from the paper's Table 2)
    A = grid_laplacian_2d(args.grid, args.grid)
    print(f"A: {A.shape}, nnz={A.nnz}, rdensity={A.rdensity:.2f}, "
          f"bandwidth={bandwidth(A)}")

    # one call runs the paper's full setup: Band-k → tune(rdensity) → CSR-k,
    # tuned with the port's GPU model
    op = prepare(A, "ampere", device=args.device, format="csrk", reorder="bandk")
    print(f"tuned: SSRS={op.params.ssrs} SRS={op.params.srs} "
          f"(constant-time, from rdensity alone)")
    print(f"pointer-array overhead: {100 * op.overhead_fraction():.3f}% "
          f"(paper bound: <2.5%)")
    print(f"tile view: {op.tiles.num_tiles} tiles × {op.tiles.slots} nnz slots, "
          f"x-window {op.tiles.window} cols, padding {100 * op.padding_overhead():.1f}%")

    dev = op.device
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(A.m).astype(np.float32)).to(dev)
    y_csrk = op.apply_original(x)        # the CSR-k kernel (its plain version on the CPU)
    y_csr = spmv(A.to(dev), x)           # plain-CSR baseline
    err = float((y_csrk - y_csr).abs().max())
    print(f"max |CSR-k − CSR| = {err:.2e} on {dev}")
    if not err < 1e-4:
        print("CSR-k and CSR disagree", file=sys.stderr)
        return 1
    print("OK — same arrays serve both the CSR baseline and the tuned kernel.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
