"""Roofline sweep: the extrapolated three-term analysis of every runnable
cell, in the baseline variant (the optimization flags off) and the
optimized one (on).

Port of ``repro.launch.roofline_sweep``, over ``dryrun.roofline_cell``'s
fake runs on the 16 × 16 production mesh of ``meta`` devices:

  python -m repro_torch.launch.roofline_sweep --out roofline.json [--variant both]
      [--cells granite-3-2b:decode_32k,...]

``opt_act_sharding`` changes nothing in the port: the reference's flag
pins activation layouts for XLA's partitioner, and eager PyTorch has no such
constraint, so both variants run the same program there.  The other flags
(the decode fast path, the MoE slot loop, the padded vocabulary) change the
port's program as the reference's.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import traceback

from repro_torch.configs.registry import all_archs, get_config, supported_shapes
from repro_torch.launch.dryrun import roofline_cell
from repro_torch.launch.mesh import make_production_mesh

BASELINE_FLAGS = dict(
    opt_act_sharding=False,
    opt_decode_fastpath=False,
    opt_moe_slot_loop=False,
    vocab_pad_multiple=1,
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="roofline.json")
    ap.add_argument("--variant", default="both", choices=["baseline", "optimized", "both"])
    ap.add_argument("--cells", default=None, help="arch:shape,arch:shape,...")
    args = ap.parse_args(argv)

    mesh = make_production_mesh()
    if args.cells:
        cells = [tuple(c.split(":")) for c in args.cells.split(",")]
    else:
        cells = [(arch, shape) for arch in all_archs()
                 for shape in supported_shapes(get_config(arch))]
    variants = ["baseline", "optimized"] if args.variant == "both" else [args.variant]
    results = []
    failures = 0
    for variant in variants:
        for arch, shape in cells:
            cfg = get_config(arch)
            if variant == "baseline":
                cfg = dataclasses.replace(cfg, **BASELINE_FLAGS)
            try:
                r = roofline_cell(arch, shape, mesh=mesh, cfg_override=cfg)
                r["variant"] = variant
                results.append(r)
                t = r["terms"]
                print(
                    f"[{variant:9s}] {arch} × {shape}: "
                    f"comp {t['compute_s']:.4f}s mem {t['memory_s']:.4f}s "
                    f"coll {t['collective_s']:.4f}s dom={r['dominant']} "
                    f"rf={r['roofline_fraction']:.4f} useful={r['useful_flops_ratio']:.2f}"
                )
            except Exception as e:      # a failed cell is reported, the sweep goes on
                failures += 1
                print(f"[{variant:9s}] {arch} × {shape}: FAIL {type(e).__name__}: {e}")
                traceback.print_exc()
            sys.stdout.flush()
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
