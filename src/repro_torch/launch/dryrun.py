"""Dry run: every (architecture × shape × mesh) cell run on fake tensors.

Port of ``repro.launch.dryrun``.  The reference forces 512 host devices,
lowers and compiles each cell's step with XLA and reads the compiled
program's memory and cost analyses and the collectives of its HLO.  The
port has no compiler: its steps run eagerly.  So for each cell this:

  1. builds the production mesh (16 × 16 single-pod / 2 × 16 × 16
     multi-pod), whose shards are distinct indexed ``meta`` devices
     (``launch.mesh.make_production_mesh``),
  2. builds the inputs with ``steps.input_specs`` inside a
     ``FakeTensorMode``: fake tensors placed as the port's steps take them,
     with no memory behind them,
  3. runs the step once, eagerly, on those fake tensors, under
     ``util.costs.CostCounter``, which counts per device the FLOPs, the
     bytes accessed (unfused: every op's inputs and outputs) and the bytes
     moved between devices, by collective kind.

Nothing is allocated on the card or on the CPU.  ``lower_s`` is the time to
build the fake inputs and ``compile_s`` the time of the fake run.  A
per-device number is the largest over the mesh's devices.  The roofline
constants are the H100 SXM5's, from NVIDIA's data sheet.

Usage:
  python -m repro_torch.launch.dryrun --arch granite-3-2b --shape decode_32k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--json out.json]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time
import traceback
from typing import Any, Dict, List, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.registry import all_archs, get_config, supported_shapes
from repro_torch.launch import steps as STEPS
from repro_torch.launch.mesh import ShardMesh, make_production_mesh
from repro_torch.models.config import SHAPES, ModelConfig, ShapeConfig
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.util.costs import CostCounter
from repro_torch.util.sharded import Sharded
from repro_torch.util.tree import leaves

# H100 SXM5 (NVIDIA data sheet); chip_smoke.py's PEAKS["H100"]
PEAK_FLOPS = 989e12        # dense bf16 FLOP/s per GPU
HBM_BW = 3.35e12           # bytes/s per GPU
LINK_BW = 450e9            # NVLink 4, bytes/s per GPU per direction
HBM_BYTES = 80e9           # HBM3 per GPU


def collective_bytes(counter: CostCounter, device=None) -> Dict[str, int]:
    """Bytes moved between devices by kind, and their ``total``, as the
    reference's ``collective_bytes`` reads them from the HLO: here from the
    counter of a fake run, received by ``device`` (None: by every device)."""
    return counter.collective_bytes(device)


def _step(cfg: ModelConfig, shape: ShapeConfig, mesh: ShardMesh, args: Dict[str, Any]):
    """(step function, its argument order) of the cell, as the reference's."""
    if shape.kind == "train":
        step_fn = STEPS.make_train_step(cfg, AdamWConfig(), mesh)
        ordered = ["params", "opt_state", "tokens", "labels"]
    elif shape.kind == "prefill":
        step_fn = STEPS.make_prefill_step(cfg, mesh)
        ordered = ["params", "tokens"]
    else:
        step_fn = STEPS.make_decode_step(cfg, mesh)
        ordered = ["params", "cache", "tokens", "cache_index"]
    if "extra" in args:
        ordered.append("extra")
    return step_fn, ordered


def state_bytes_per_device(args: Dict[str, Any], kind: str, mesh: ShardMesh) -> List[int]:
    """The bytes each shard of ``mesh`` holds between steps: the arguments
    where ``input_specs`` placed them (a ``Sharded`` leaf's pieces on their
    owner shards, the params, moments, decode cache and batch rows of a
    mesh of several shards; a whole tensor on the first shard on its
    device), plus, in training, twice the parameter bytes of that shard
    (the transient f32 gradient tree, the reference's rule).
    ``cache_index``, a Python int that the step reads on the host, counts
    as the reference's int32 scalar on the first shard.  On distinct
    devices (the dry run's ``meta:i``) a shard is a device; on one card
    the count is by shard all the same."""
    first = {}
    for i, d in enumerate(mesh.devices):
        first.setdefault(d, i)
    state = [0] * mesh.size
    params = [0] * mesh.size
    for key, tree in args.items():
        for leaf in leaves(tree):
            if isinstance(leaf, int):
                state[0] += 4
                continue
            if isinstance(leaf, Sharded):
                held = [(leaf.owner_index(b), p) for b, p in zip(leaf.blocks(), leaf.pieces)]
            else:
                held = [(first[leaf.device], leaf)]
            for i, p in held:
                n = p.numel() * p.element_size()
                state[i] += n
                if key == "params":
                    params[i] += n
    if kind == "train":
        state = [s + 2 * p for s, p in zip(state, params)]
    return state


def _fake_run(cfg: ModelConfig, shape: ShapeConfig, mesh: ShardMesh) -> Dict[str, Any]:
    """Build the cell's fake inputs and run its step once under a counter."""
    with FakeTensorMode():
        t0 = time.perf_counter()
        args, _ = STEPS.input_specs(cfg, shape, mesh)
        state = state_bytes_per_device(args, shape.kind, mesh)
        t_lower = time.perf_counter() - t0
        step_fn, ordered = _step(cfg, shape, mesh, args)
        serve = torch.inference_mode() if shape.kind != "train" else contextlib.nullcontext()
        t0 = time.perf_counter()
        with serve, CostCounter() as counter:
            step_fn(*(args[k] for k in ordered))
        t_run = time.perf_counter() - t0
    return {"counter": counter, "state": state, "lower_s": t_lower, "compile_s": t_run}


def _two_point(a, b, units: int):
    """A count of the full depth from its counts at one and two repeat units:
    c(L) = c(1) + (units − 1)·(c(2) − c(1)), the per-unit delta clamped at 0
    as the reference's.  Exact on a stack uniform by repeat unit."""
    return a + (units - 1) * max(b - a, 0)


def _run(cfg: ModelConfig, shape: ShapeConfig, mesh: ShardMesh) -> Dict[str, Any]:
    """:func:`_fake_run` of the full depth.  Where the stack is uniform by
    repeat unit (:func:`_depth_cut`) and deeper than two units, from fake
    runs at one and two units instead, each device's counts extrapolated
    (:func:`_two_point`; an encoder's depth is its own, so not there); the
    state bytes are then the full model's (its inputs built, no step run)."""
    cfg1, units = _depth_cut(cfg, 1)
    if units <= 2 or cfg.is_encdec or cfg1.layers * units != cfg.layers:
        return _fake_run(cfg, shape, mesh)
    r1, r2 = _fake_run(cfg1, shape, mesh), _fake_run(_depth_cut(cfg, 2)[0], shape, mesh)
    c1, c2 = r1["counter"], r2["counter"]
    counter = CostCounter()
    for d in set(c1.flops) | set(c2.flops):
        counter.flops[d] = _two_point(c1.flops.get(d, 0), c2.flops.get(d, 0), units)
    for d in set(c1.bytes) | set(c2.bytes):
        counter.bytes[d] = _two_point(c1.bytes.get(d, 0), c2.bytes.get(d, 0), units)
    for d in set(c1.coll) | set(c2.coll):
        a, b = c1.collective_bytes(d), c2.collective_bytes(d)
        for k in counter.coll[d]:
            counter.coll[d][k] = _two_point(a[k], b[k], units)
    t0 = time.perf_counter()
    with FakeTensorMode():
        state = state_bytes_per_device(STEPS.input_specs(cfg, shape, mesh)[0], shape.kind, mesh)
    return {"counter": counter, "state": state,
            "lower_s": r1["lower_s"] + r2["lower_s"] + time.perf_counter() - t0,
            "compile_s": r1["compile_s"] + r2["compile_s"]}


def _per_device(counter: CostCounter, mesh: ShardMesh) -> Dict[str, Any]:
    """The largest FLOPs, bytes and collective bytes over the mesh's devices
    (the collectives of the device that receives the most)."""
    coll = max((counter.collective_bytes(d) for d in mesh.devices), key=lambda c: c["total"])
    return {"flops": float(max(counter.flops.get(d, 0) for d in mesh.devices)),
            "bytes": float(max(counter.bytes.get(d, 0) for d in mesh.devices)),
            "coll": coll}


def _terms(flops: float, nbytes: float, coll: float) -> Dict[str, float]:
    return {"compute_s": flops / PEAK_FLOPS, "memory_s": nbytes / HBM_BW,
            "collective_s": coll / LINK_BW}


def _mesh_name(mesh: ShardMesh) -> str:
    return "x".join(str(v) for v in mesh.shape.values())


def dryrun_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
                mesh: Optional[ShardMesh] = None) -> Dict[str, Any]:
    """One cell's placement, fit and roofline terms, with the reference's
    keys (:func:`dryrun_config` of the registry's config and shape)."""
    mesh = mesh if mesh is not None else make_production_mesh(multi_pod=multi_pod)
    return dict(dryrun_config(get_config(arch), SHAPES[shape_name], mesh),
                arch=arch, shape=shape_name)


def dryrun_config(cfg: ModelConfig, shape: ShapeConfig, mesh: ShardMesh) -> Dict[str, Any]:
    """:func:`dryrun_cell` of any config and shape on ``mesh``, its counts
    from :func:`_run` (on a uniform stack, fake runs at one and two repeat
    units of depth).  ``peak_hbm_per_device`` is the largest of
    :func:`state_bytes_per_device` (the reference's rule on the port's
    placement); ``fits_hbm`` compares it with ``HBM_BYTES``."""
    run = _run(cfg, shape, mesh)
    dev = _per_device(run["counter"], mesh)
    peak = max(run["state"])
    terms = _terms(dev["flops"], dev["bytes"], dev["coll"]["total"])
    model_flops = 6 * cfg.active_param_count() * shape.global_batch * (
        shape.seq_len if shape.kind in ("train", "prefill") else 1)
    if shape.kind != "train":
        model_flops //= 3          # forward only: 2·N·D
    return {
        "arch": cfg.name,
        "shape": shape.name,
        "mesh": _mesh_name(mesh),
        "devices": mesh.size,
        "lower_s": round(run["lower_s"], 1),
        "compile_s": round(run["compile_s"], 1),
        "flops_per_device": dev["flops"],
        "hbm_bytes_per_device": dev["bytes"],
        "collective_bytes": dev["coll"],
        "peak_hbm_per_device": int(peak),
        "fits_hbm": bool(peak <= HBM_BYTES),
        "terms": terms,
        "dominant": max(terms, key=terms.get),
        "model_flops_global": float(model_flops),
        "useful_flops_ratio": float(model_flops / max(dev["flops"] * mesh.size, 1.0)),
    }


def _depth_cut(cfg: ModelConfig, units: int):
    """``cfg`` at a depth of ``units`` repeat-units (hybrid period / dense-MoE
    pair / single layer): (config, units of the full depth)."""
    unit = cfg.attn_period if cfg.attn_period > 0 else (
        cfg.moe_every if (cfg.is_moe and cfg.moe_every > 1) else 1)
    kw = dict(layers=unit * units)
    if cfg.encoder_layers:
        kw["encoder_layers"] = units
    return dataclasses.replace(cfg, **kw), cfg.layers // unit


def _analysis_cfg(cfg: ModelConfig, units: int, shape: ShapeConfig):
    """Analysis variant at a depth of ``units`` repeat-units (:func:`_depth_cut`),
    with the reference's unrolled layers and its moderate attention and
    linear-attention chunks: (config, units of the full depth)."""
    cut, full = _depth_cut(cfg, units)
    return dataclasses.replace(cut, scan_layers=False, analysis_unroll=True,
                               attention_chunk=4096, la_chunk=128), full


def _cell_costs(cfg: ModelConfig, shape: ShapeConfig, mesh: ShardMesh) -> Dict[str, float]:
    """(flops, hbm bytes, collective bytes) per device of one fake run.
    ``whiles`` is 0: the port has no compiled loops, and every layer and
    chunk runs as a Python loop that the counter sees in full."""
    dev = _per_device(_fake_run(cfg, shape, mesh)["counter"], mesh)
    return {"flops": dev["flops"], "bytes": dev["bytes"],
            "coll": float(dev["coll"]["total"]), "whiles": 0}


def roofline_cell(arch: str, shape_name: str, mesh: Optional[ShardMesh] = None, *,
                  cfg_override: Optional[ModelConfig] = None) -> Dict[str, Any]:
    """Roofline terms by two-point depth extrapolation (exact for uniform
    stacks): total(L) = c(1·unit) + (units−1) · [c(2·unit) − c(1·unit)].
    One and two units are cheaper to fake-run than L layers.
    ``residual_whiles`` is 0 (see :func:`_cell_costs`)."""
    cfg = cfg_override if cfg_override is not None else get_config(arch)
    shape = SHAPES[shape_name]
    mesh = mesh if mesh is not None else make_production_mesh()
    cfg1, units = _analysis_cfg(cfg, 1, shape)
    cfg2, _ = _analysis_cfg(cfg, 2, shape)
    c1 = _cell_costs(cfg1, shape, mesh)
    c2 = _cell_costs(cfg2, shape, mesh)
    total = {k: _two_point(c1[k], c2[k], units) for k in ("flops", "bytes", "coll")}
    terms = _terms(total["flops"], total["bytes"], total["coll"])
    tokens = shape.global_batch * (shape.seq_len if shape.kind in ("train", "prefill") else 1)
    mult = 6 if shape.kind == "train" else 2
    model_flops = mult * cfg.active_param_count() * tokens
    # attention quadratic term (causal ≈ ½ of S²), decode: S per new token
    n_attn = sum(1 for i in range(cfg.layers) if cfg.layer_kind(i) == "attn")
    hd, H = cfg.resolved_head_dim, cfg.num_heads
    if shape.kind in ("train", "prefill"):
        attn = 2 * shape.global_batch * shape.seq_len ** 2 * H * hd * n_attn
    else:
        attn = 4 * shape.global_batch * shape.seq_len * H * hd * n_attn
    model_flops += (mult // 2) * attn
    peak = max(terms.values())
    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": _mesh_name(mesh),
        "units": units,
        "terms": terms,
        "dominant": max(terms, key=terms.get),
        "flops_per_device": total["flops"],
        "hbm_bytes_per_device": total["bytes"],
        "collective_bytes_per_device": total["coll"],
        "model_flops_global": float(model_flops),
        "useful_flops_ratio": float(model_flops / max(total["flops"] * mesh.size, 1.0)),
        "roofline_fraction": terms["compute_s"] / peak if peak else 0.0,
        "residual_whiles": max(c1["whiles"], c2["whiles"]),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)

    if args.all:
        cells = [(arch, shape) for arch in all_archs()
                 for shape in supported_shapes(get_config(arch))]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("--arch and --shape, or --all")
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    results = []
    failures = 0
    for multi_pod in meshes:
        mesh = make_production_mesh(multi_pod=multi_pod)
        for arch, shape in cells:
            tag = f"{arch} × {shape} × {'2x16x16' if multi_pod else '16x16'}"
            try:
                r = dryrun_cell(arch, shape, multi_pod=multi_pod, mesh=mesh)
                results.append(r)
                print(
                    f"[OK] {tag}: compile {r['compile_s']}s, "
                    f"{r['flops_per_device']:.3e} FLOP/dev, "
                    f"{r['hbm_bytes_per_device']:.3e} B/dev, "
                    f"coll {r['collective_bytes']['total']:.3e} B, "
                    f"peak HBM {r['peak_hbm_per_device'] / 2**30:.1f} GiB "
                    f"({'fits' if r['fits_hbm'] else 'OVER'}), "
                    f"dominant={r['dominant']}"
                )
            except Exception as e:      # a failed cell is reported, the sweep goes on
                failures += 1
                print(f"[FAIL] {tag}: {type(e).__name__}: {e}")
                traceback.print_exc()
            sys.stdout.flush()

    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
    print(f"\n{len(results)} cells compiled, {failures} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
