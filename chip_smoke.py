#!/usr/bin/env python3
"""Drive the PyTorch port's CSR-k main path on one NVIDIA GPU and check it.

Run from the repository root on a machine with a CUDA card and ``nvcc``:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. build the CUDA kernel from ``src/repro_torch/csrc`` (nvcc, sm_90a);
2. print the card's name and power limit (``nvidia-smi``);
3. hold the kernel against its plain PyTorch version on a small suite matrix:
   f32/bf16/int8 x B in {1, 8} x monolithic/bucketed layouts, within the
   per-row bound |y - y_plain| <= (2 k_i + 2) eps32 (|A| |x|)_i, with repeat
   launches bit-equal and column j of a B=8 launch bit-equal to a B=1 launch;
4. run the main path at the paper's size of ecology1 (1M rows, 5M nnz):
   ``prepare(format="auto")`` -> ``apply_original`` against a plain CSR
   product -> CG and 8-column block CG to a true relative residual <= 1e-4,
   counting kernel launches;
5. time the kernel, its plain version and ``torch.sparse`` CSR (cuSPARSE,
   the yardstick; the port never calls it) at the ecology1 shapes, as device
   time from CUDA-graph replays between CUDA events, beside the memory-bound
   least time; the eager per-call time (host overhead included) is logged;
6. print one JSON line describing the kernel; then the card line and, last,
   ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
EPS32 = float(np.finfo(np.float32).eps)

#: Memory rate (bytes/s) and float32 rate (flop/s, outside the tensor
#: cores) of the card, from NVIDIA's data sheets, keyed by a substring of
#: its name; the SXM part's figures are the default.
PEAKS = {"H100 PCIe": (2.0e12, 51e12), "H100 NVL": (3.9e12, 60e12),
         "H100": (3.35e12, 67e12)}
VALUE_BYTES = {"f32": 4, "bf16": 2, "int8": 1}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def peaks(name: str):
    for key, val in PEAKS.items():
        if key in name:
            return val
    return PEAKS["H100"]


def time_ms(fn, reps: int = 20, iters: int = 10) -> float:
    """Device milliseconds of one ``fn()``, without the host's per-call cost.

    ``reps`` calls of ``fn`` are captured in one CUDA graph, which is replayed
    ``iters`` times between two CUDA events.
    """
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * iters)


def eager_ms(fn, iters: int = 100) -> float:
    """Host-clock milliseconds of one eager ``fn()`` call, synchronised."""
    import torch

    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def row_bound(abs_prod, row_nnz):
    """Per-row tolerance (2 k_i + 2) eps32 (|A| |x|)_i, with a trailing batch axis."""
    k = row_nnz.to(abs_prod.dtype)
    if abs_prod.ndim == 2:
        k = k[:, None]
    return (2 * k + 2) * EPS32 * abs_prod


def check_close(y, y_ref, bound, what: str) -> float:
    import torch

    if y.shape != y_ref.shape or not bool(torch.isfinite(y).all()):
        raise AssertionError(f"{what}: shape {tuple(y.shape)} or non-finite output")
    err = (y.double() - y_ref.double()).abs()
    bad = int((err > bound.double()).sum())
    if bad:
        raise AssertionError(f"{what}: {bad} rows outside the rounding bound")
    return float(err.max())


def abs_tiles(view):
    """The same tile view with |values| (for the |A| |x| bound)."""
    import dataclasses

    from repro_torch.sparse import CSRkTileBuckets

    if isinstance(view, CSRkTileBuckets):
        return dataclasses.replace(
            view, buckets=tuple(abs_tiles(b) for b in view.buckets),
            rem_val=view.rem_val.abs())
    return dataclasses.replace(view, vals=view.vals.abs(), rem_val=view.rem_val.abs())


def kernel_vs_plain(views, row_nnz, n, seed: int, what: str):
    """Phase-3 checks for one matrix; returns {(dtype, layout, B): max_abs_err}."""
    import torch

    from repro_torch.kernels import ops, ref

    run = {"monolithic": ops.spmv_csrk, "bucketed": ops.spmv_csrk_bucketed}
    plain = {"monolithic": ref.spmv_csrk_tiles, "bucketed": ref.spmv_csrk_buckets}
    gen = torch.Generator(device="cuda").manual_seed(seed)
    errs = {}
    for dtype, layouts in views.items():
        X = torch.randn((n, 8), generator=gen, device="cuda")
        Y8 = {}
        for layout, view in layouts.items():
            Y8[layout] = run[layout](view, X)
            for B, xb in ((1, X[:, 0].contiguous()), (8, X)):
                yb = run[layout](view, xb)
                bound = row_bound(plain[layout](abs_tiles(view), xb.abs()), row_nnz)
                errs[(dtype, layout, B)] = check_close(
                    yb, plain[layout](view, xb), bound, f"{what} {dtype} {layout} B={B}")
                if not torch.equal(yb, run[layout](view, xb)):
                    raise AssertionError(f"{what} {dtype} {layout} B={B}: repeat launch differs")
            for j in range(8):
                if not torch.equal(Y8[layout][:, j], run[layout](view, X[:, j].contiguous())):
                    raise AssertionError(f"{what} {dtype} {layout}: column {j} of B=8 != B=1")
        if len(Y8) == 2 and not torch.equal(Y8["monolithic"], Y8["bucketed"]):
            raise AssertionError(f"{what} {dtype}: bucketed != monolithic bits")
    return errs


def views_for(csrk, dtypes, layouts=("monolithic", "bucketed")):
    from repro_torch.sparse import bucket_tiles, tiles_from_csrk

    out = {}
    for dt in dtypes:
        tiles = tiles_from_csrk(csrk, value_dtype=dt)
        v = {}
        if "monolithic" in layouts:
            v["monolithic"] = tiles.to("cuda")
        if "bucketed" in layouts:
            v["bucketed"] = bucket_tiles(tiles).to("cuda")
        out[dt] = v
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.spmv_suite import load_suite
    from repro_torch.core import block_cg, cg, prepare
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels.spmv_csrk import spmv_csrk_tiles
    from repro_torch.obs import get_registry
    from repro_torch.sparse import CSRMatrix

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_all = time.perf_counter()

    # 1. build
    t0 = time.perf_counter()
    lib = build.build("spmv_csrk")
    log(f"[build] spmv_csrk.cu -> {lib.name} in {time.perf_counter() - t0:.2f} s")
    report = Path(str(lib) + ".log")
    if report.exists():
        for line in report.read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {line.strip()}")

    # 2. card
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    mem_rate, f32_rate = peaks(kind)
    log(f"[card] {card}")
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda}; peaks used: "
        f"{mem_rate / 1e12:.2f} TB/s, {f32_rate / 1e12:.0f} TFLOP/s f32")

    # 3. kernel vs plain on a small suite matrix
    t0 = time.perf_counter()
    A_small = load_suite(scale=64, ids=[8])["ecology1"]
    op_small = prepare(A_small, device="cuda", format="auto")
    errs = kernel_vs_plain(views_for(op_small.csrk, ("f32", "bf16", "int8")),
                           op_small.csrk.csr.row_lengths(), A_small.n, 0,
                           f"ecology1/64 ({A_small.m} rows)")
    torch.cuda.synchronize()
    log(f"[kernel] {len(errs)} cases within bound, repeat launches and B=8 columns "
        f"bit-equal; max |err| {max(errs.values()):.3e} ({time.perf_counter() - t0:.1f} s)")

    # 4. main path at the paper's ecology1 size
    t0 = time.perf_counter()
    A = load_suite(scale=1, ids=[8])["ecology1"]
    log(f"[main] ecology1: {A.m} rows, {A.nnz} nnz (built in {time.perf_counter() - t0:.1f} s)")
    t_main = time.perf_counter()
    reg = get_registry()
    reg.clear()
    spmv_csrk_tiles.launches = 0
    t0 = time.perf_counter()
    op = prepare(A, device="cuda", format="auto")
    t_prep = time.perf_counter() - t0
    if op.backend != "csrk":
        raise AssertionError(f"ecology1 routed to {op.backend}, expected csrk")
    phases = {r["name"]: r["value"] for r in reg.records() if r["section"] == "prepare"}
    log(f"[main] prepare {t_prep:.1f} s: " + ", ".join(
        f"{k[6:-3]} {v / 1e3:.1f} s" for k, v in sorted(phases.items())
        if k.startswith("phase.") and k.endswith("_ms")))
    T = op.tiles.num_tiles
    log(f"[main] params {op.params}; tiles {T} x {op.tiles.rows_per_tile} rows, "
        f"window {op.tiles.window}, buckets {op.tile_buckets.bucket_slots()}, "
        f"remainder {op.tiles.remainder_nnz}; modeled_bytes() {op.modeled_bytes()} "
        f"(prices a 2*window x slice per tile)")
    A_dev = A.to("cuda")
    A64 = CSRMatrix(A_dev.row_ptr, A_dev.col_idx, A_dev.vals.double(), A_dev.shape)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(A.n).astype(np.float32)).cuda()
    y = op.apply_original(x)
    y_plain = ref.spmv_csr(A_dev, x)
    A_abs = CSRMatrix(A_dev.row_ptr, A_dev.col_idx, A_dev.vals.abs(), A_dev.shape)
    bound = row_bound(ref.spmv_csr(A_abs, x.abs()), A_dev.row_lengths())
    err = check_close(y, y_plain, bound, "apply_original vs plain CSR")
    log(f"[main] apply_original vs plain CSR product: max |err| {err:.3e}")

    perm, inv = op._perm_dev, op._inv_perm_dev
    x_true = torch.from_numpy(rng.standard_normal(A.n).astype(np.float32)).cuda()
    b = ref.spmv_csr(A_dev, x_true)
    t0 = time.perf_counter()
    res = cg(op, b[perm], tol=1e-5, maxiter=5000)
    torch.cuda.synchronize()
    t_cg = time.perf_counter() - t0
    xs = res.x[inv]
    true_res = float(torch.linalg.norm(b.double() - ref.spmv_csr(A64, xs.double()))
                     / torch.linalg.norm(b.double()))
    log(f"[main] cg: {res.iters} iterations, recurrence residual "
        f"{float(res.residual) / float(torch.linalg.norm(b)):.3e}, true relative residual "
        f"{true_res:.3e}, {t_cg:.2f} s ({t_cg / max(res.iters, 1) * 1e3:.3f} ms/iter)")
    if res.iters >= 5000 or not true_res <= 1e-4:
        raise AssertionError("cg did not converge on ecology1")

    X_true = torch.from_numpy(rng.standard_normal((A.n, 8)).astype(np.float32)).cuda()
    Bm = ref.spmm_csr(A_dev, X_true)
    t0 = time.perf_counter()
    bres = block_cg(op, Bm[perm], tol=1e-5, maxiter=5000)
    torch.cuda.synchronize()
    t_bcg = time.perf_counter() - t0
    Xs = bres.X[inv]
    true_b = (torch.linalg.norm(Bm.double() - ref.spmm_csr(A64, Xs.double()), dim=0)
              / torch.linalg.norm(Bm.double(), dim=0))
    log(f"[main] block_cg (8 rhs): {bres.iters} iterations, worst true relative residual "
        f"{float(true_b.max()):.3e}, {t_bcg:.2f} s ({t_bcg / max(bres.iters, 1) * 1e3:.3f} "
        f"ms/iter)")
    if bres.iters >= 5000 or not float(true_b.max()) <= 1e-4:
        raise AssertionError("block_cg did not converge on ecology1")
    launches = spmv_csrk_tiles.launches
    log(f"[main] phase done in {time.perf_counter() - t_main:.1f} s")
    spmvs = 1 + (1 + res.iters) + (1 + bres.iters)   # apply_original, then each solve
    log(f"[main] spmv_csrk_tiles launches on the main path: {launches} "
        f"({launches / spmvs:.2f} per SpMV over {spmvs} SpMVs)")
    if launches == 0:
        raise AssertionError("the main path never launched the CUDA kernel")

    # 5. timing at the ecology1 shapes
    t0 = time.perf_counter()
    m, n, nnz = A.m, A.n, A.nnz
    csr = op.csrk.csr
    warnings.filterwarnings("ignore", message=".*[Ss]parse CSR tensor support is in beta.*")
    sp = torch.sparse_csr_tensor(csr.row_ptr.long(), csr.col_idx.long(), csr.vals,
                                 size=csr.shape, check_invariants=True)
    views = views_for(op.csrk, ("bf16", "int8"), layouts=("bucketed",))
    views["f32"] = {"bucketed": op.tile_buckets}
    gen = torch.Generator(device="cuda").manual_seed(1)
    variants = []
    for dt in ("f32", "bf16", "int8"):
        view = views[dt]["bucketed"]
        scale_bytes = sum(4 * b.val_scale.numel() for b in view.buckets
                          if b.val_scale is not None)
        abs_view = abs_tiles(view)
        for B in (1, 8):
            xb = torch.randn((n, B), generator=gen, device="cuda")
            xb = xb[:, 0].contiguous() if B == 1 else xb
            yk = ops.spmv_csrk_bucketed(view, xb)
            yp = ref.spmv_csrk_buckets(view, xb)
            bound = row_bound(ref.spmv_csrk_buckets(abs_view, xb.abs()), csr.row_lengths())
            err = check_close(yk, yp, bound, f"ecology1 {dt} B={B}")
            ms = time_ms(lambda: ops.spmv_csrk_bucketed(view, xb))
            call_ms = eager_ms(lambda: ops.spmv_csrk_bucketed(view, xb))
            plain_ms = time_ms(lambda: ref.spmv_csrk_buckets(view, xb), reps=5)
            lib_ms = time_ms(lambda: sp @ xb) if dt == "f32" else None
            nbytes = nnz * (VALUE_BYTES[dt] + 8) + scale_bytes + n * 4 * B + m * 4 * B
            t_bytes = nbytes / mem_rate * 1e3
            t_ops = 2 * nnz * B / f32_rate * 1e3
            variants.append({
                "value_dtype": dt, "B": B, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "library_ms": lib_ms, "eager_call_ms": call_ms,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bytes": nbytes,
            })
            lib_txt = "n/a" if lib_ms is None else f"{lib_ms:.4f}"
            log(f"[time] {dt:4s} B={B}: kernel {ms:.4f} ms (eager call {call_ms:.4f} ms), "
                f"plain {plain_ms:.4f} ms, cuSPARSE {lib_txt} ms, bound "
                f"{max(t_bytes, t_ops):.4f} ms ({nbytes / 1e6:.1f} MB; "
                f"{nbytes / ms / 1e6:.0f} GB/s achieved), max |err| {err:.3e}")
    log(f"[time] done in {time.perf_counter() - t0:.1f} s")

    # 6. result lines
    head = variants[0]
    kernels = {"kernels": [{
        "name": "spmv_csrk_tiles",
        "route": "cuda",
        "source": "src/repro_torch/csrc/spmv_csrk.cu",
        "replaces": "src/repro/kernels/spmv_csrk.py:131",
        "launches": launches,
        "max_abs_err": max(v["max_abs_err"] for v in variants),
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "shape": {"matrix": "ecology1", "m": m, "n": n, "nnz": nnz,
                  "value_dtype": "f32", "B": 1},
        "variants": variants,
    }]}
    print(json.dumps(kernels), flush=True)
    log(f"[card] {card}")
    log(f"[done] {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
