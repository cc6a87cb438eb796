#!/usr/bin/env python3
"""Drive the PyTorch port's CSR-k, SELL-C-σ, segmented-sum and DIA/CSR-hybrid paths
and the ELL baseline path on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card and ``nvcc``:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. build the CUDA kernels from ``src/repro_torch/csrc`` (one nvcc per
   source, all started together; sm_90a);
2. print the card's name and power limit (``nvidia-smi``);
3. hold the kernel against its plain PyTorch version on a small suite matrix:
   f32/bf16/int8 x B in {1, 8} x monolithic/bucketed layouts, within the
   per-row bound |y - y_plain| <= (2 k_i + 2) eps32 (|A| |x|)_i, with repeat
   launches bit-equal and column j of a B=8 launch bit-equal to a B=1 launch;
4. run the main path at the paper's size of ecology1 (1M rows, 5M nnz):
   ``prepare(format="auto")`` -> ``apply_original`` against a plain CSR
   product -> CG and 8-column block CG to a true relative residual <= 1e-4,
   counting kernel launches;
5. time the kernel, its plain version and ``torch.sparse`` CSR (cuSPARSE
   with int32 indices, the yardstick; the port never calls it) at the
   ecology1 shapes, as device time from CUDA-graph replays between CUDA
   events, beside the memory-bound least time; the eager per-call time
   (host overhead included) is logged;
6. SELL-C-σ kernel against its plain version on bmwcra_1 at 1/64 and on a
   Pareto matrix with empty rows and m not a multiple of C: f32/bf16/int8 x
   B in {1, 8}, within the same per-row bound, repeat launches and B=8
   columns bit-equal;
7. the SELL-C-σ path at the paper's size of bmwcra_1 (147,456 rows, 11.7M
   nnz): ``prepare(format="auto")`` must route to "sellcs";
   ``apply_original`` against a plain CSR product; 40 Jacobi sweeps for 1
   and for 8 right-hand sides to a true relative residual <= 1e-5
   (bmwcra_1's values are not symmetric, but it is strictly diagonally
   dominant), counting kernel launches;
8. time the SELL-C-σ kernel, its plain version and cuSPARSE at the bmwcra_1
   shapes, as in phase 5;
9. segmented-sum kernel against its plain version on powerlaw_zipf(2048)
   at 128- and 512-slot chunks, on a matrix whose first and last rows are
   empty, on a row that spans three chunks (which must come out exactly)
   and on a row that spans 40: f32/bf16/int8 x B in {1, 8}, within the
   same per-row bound, repeat launches and B=8 columns bit-equal, empty
   rows 0 in an output filled with NaN before the call, and with unit
   values the row lengths exactly;
10. the segmented-sum path at powerlaw_zipf's full size (262,144 rows,
    32.6M nnz): ``prepare(format="auto")`` must route to "segsum";
    ``apply_original`` against a plain CSR product at B=1 and B=8; 50 sweeps
    of power iteration and of 8-column block power iteration, whose last
    products through the operator must agree with a float64 CSR product
    within the bound (their values have random signs, so the iterations
    need not converge), counting kernel launches;
11. at the powerlaw_zipf shapes, check that unit values give the row
    lengths exactly, then time the segmented-sum kernel, its plain version
    and cuSPARSE as in phase 5;
12. DIA/CSR-hybrid kernel against its plain version on stencil_fringe(48)
    and (64), a 130x200 matrix with offsets {0, 40} and remainder entries at
    columns 0 and 199, a pure plane (a 9-point grid) and a pure remainder (no
    dense diagonal): f32/bf16 x B in {1, 8}, within the same per-row bound,
    repeat launches and B=8 columns bit-equal, every row written into an
    output filled with NaN; the 8x8 integer hand case exactly; and with an
    inf, a -inf and a NaN in x, NaN and inf in the same places as the plain
    version;
13. the DIA/CSR-hybrid path at stencil_fringe(side=2048) (4,194,304 rows,
    40.4M nnz): ``prepare(format="auto")`` must route to "diahybrid";
    ``apply_original`` against a plain CSR product at B=1 and B=8; 50 sweeps
    of power iteration and of 8-column block power iteration, whose last
    products through the operator must agree with a float64 CSR product
    within the bound (the matrix is neither symmetric nor diagonally
    dominant, so the iterations need not converge); exactly one CUDA launch
    per SpMV;
14. time the DIA/CSR-hybrid kernel, its plain version and cuSPARSE at the
    stencil_fringe shapes, as in phase 5;
15. ELL kernel against its plain version on bmwcra_1 at 1/64 and on slabs of
    kmax 1, 5, 33, 80 and 129 with m = 1003 (no multiple of any block size),
    two slabs cut at an explicit kmax and an all-empty matrix: within the
    per-row bound, a repeat launch bit-equal, every row written into an
    output filled with NaN; with an inf (at x[0], which every padding slot
    reads), a -inf and a NaN in x, NaN and inf in the same rows as the plain
    version;
16. the ELL path at bmwcra_1's full size, on the matrix phase 7 built:
    ``ell_from_csr`` -> ``to`` -> ``ops.spmv_ell`` against a plain CSR
    product and against the SELL-C-σ route's output within the bound; 40
    Jacobi sweeps through ``ops.spmv_ell`` with phase 7's diagonal and
    right-hand side to a true relative residual <= 1e-5 and within 1e-5 of
    the SELL-C-σ route's iterate; exactly one CUDA launch per SpMV;
17. time the ELL kernel, its plain version and cuSPARSE on bmwcra_1 and on
    phase 13's stencil_fringe(2048) (kmax 73: 7.6x its nnz in slots), as in
    phase 5, beside the SELL-C-σ and DIA kernels' times;
18. print one JSON line describing the five kernels; then the card line
    and, last, ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
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


def time_variant(tag, dt, B, err, run, plain, library, nbytes, nnz, rates,
                 read_bytes=None) -> dict:
    """Time one (value dtype, B) case: kernel, eager call, plain version and,
    where there is one, the library call; log it and return its record.

    ``nbytes`` is the least the function must move, which sets the bound;
    ``read_bytes``, where given, is what the kernel moves, if more."""
    mem_rate, f32_rate = rates
    ms = time_ms(run)
    call_ms = eager_ms(run)
    plain_ms = time_ms(plain, reps=5)
    lib_ms = None if library is None else time_ms(library)
    t_bytes = nbytes / mem_rate * 1e3
    t_ops = 2 * nnz * B / f32_rate * 1e3
    lib_txt = "n/a" if lib_ms is None else f"{lib_ms:.4f}"
    read_txt = "" if read_bytes is None else (
        f"; the kernel reads {read_bytes / 1e6:.1f} MB, "
        f"{read_bytes / ms / 1e6:.0f} GB/s, {read_bytes / mem_rate * 1e3:.4f} ms at the rate")
    log(f"[{tag}] {dt:4s} B={B}: kernel {ms:.4f} ms (eager call {call_ms:.4f} ms), "
        f"plain {plain_ms:.4f} ms, cuSPARSE {lib_txt} ms, bound "
        f"{max(t_bytes, t_ops):.4f} ms ({nbytes / 1e6:.1f} MB; "
        f"{nbytes / ms / 1e6:.0f} GB/s achieved{read_txt}), max |err| {err:.3e}")
    rec = {
        "value_dtype": dt, "B": B, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "library_ms": lib_ms, "eager_call_ms": call_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": nbytes,
    }
    if read_bytes is not None:
        rec["bytes_read"] = read_bytes
    return rec


def kernel_entry(name, source, replaces, launches, variants, shape,
                 cuda_launches_per_call: int = 1) -> dict:
    """One kernel's record of the ``kernels`` line; the headline numbers are
    its first variant's (f32, B=1).  ``launches`` counts wrapper calls, each
    ``cuda_launches_per_call`` CUDA launches."""
    head = variants[0]
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "cuda_launches_per_call": cuda_launches_per_call,
        "max_abs_err": max(v["max_abs_err"] for v in variants),
        **{k: head[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "shape": shape,
        "variants": variants,
    }


def library_csr(csr):
    """``torch.sparse`` CSR of ``csr`` (cuSPARSE), with int32 indices as the
    kernels read them; the yardstick only, never called by the port."""
    import torch

    warnings.filterwarnings("ignore", message=".*[Ss]parse CSR tensor support is in beta.*")
    return torch.sparse_csr_tensor(csr.row_ptr.int(), csr.col_idx.int(), csr.vals,
                                   size=csr.shape, check_invariants=True)


def build_all(names):
    """Build every kernel source at once (one nvcc each) and log the reports."""
    from repro_torch.kernels import build

    def timed(name):
        t0 = time.perf_counter()
        lib = build.build(name)
        return lib, time.perf_counter() - t0

    with ThreadPoolExecutor(len(names)) as pool:
        built = dict(zip(names, pool.map(timed, names)))
    for name, (lib, secs) in built.items():
        log(f"[build] {name}.cu -> {lib.name} in {secs:.2f} s")
        report = Path(str(lib) + ".log")
        if report.exists():
            for line in report.read_text().splitlines():
                if "entry function" in line or "registers" in line or "spill" in line:
                    log(f"[build] {name}: {line.strip()}")


def sell_kernel_vs_plain(views, row_nnz, n, seed: int, what: str):
    """Phase-6 checks for one matrix; returns {(dtype, B): max_abs_err}."""
    import torch

    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device="cuda").manual_seed(seed)
    errs = {}
    for dtype, tiles in views.items():
        X = torch.randn((n, 8), generator=gen, device="cuda")
        abs_view = dataclasses.replace(tiles, vals=tiles.vals.abs())
        for B, xb in ((1, X[:, 0].contiguous()), (8, X)):
            yb = ops.spmv_sellcs(tiles, xb)
            bound = row_bound(ref.spmv_sellcs_tiles(abs_view, xb.abs()), row_nnz)
            errs[(dtype, B)] = check_close(
                yb, ref.spmv_sellcs_tiles(tiles, xb), bound, f"{what} {dtype} B={B}")
            if not torch.equal(yb, ops.spmv_sellcs(tiles, xb)):
                raise AssertionError(f"{what} {dtype} B={B}: repeat launch differs")
        Y8 = ops.spmv_sellcs(tiles, X)
        for j in range(8):
            if not torch.equal(Y8[:, j], ops.spmv_sellcs(tiles, X[:, j].contiguous())):
                raise AssertionError(f"{what} {dtype}: column {j} of B=8 != B=1")
    return errs


def sell_views(sell, dtypes):
    from repro_torch.sparse import tiles_from_sellcs

    return {dt: tiles_from_sellcs(sell, value_dtype=dt).to("cuda") for dt in dtypes}


def csr_diagonal(A):
    """The diagonal of a square CSR matrix, on its device."""
    import torch

    rows = torch.repeat_interleave(
        torch.arange(A.m, device=A.vals.device), A.row_lengths().long())
    on = rows == A.col_idx.long()
    diag = torch.zeros(A.m, dtype=A.vals.dtype, device=A.vals.device)
    diag[rows[on]] = A.vals[on]
    return diag


def sellcs_phases(mem_rate: float, f32_rate: float):
    """Phases 6-8: the SELL-C-σ kernel, its path at bmwcra_1's size, timing.

    Returns the kernel's entry of the ``kernels`` line, and bmwcra_1 with its
    operator, diagonal and one-column right-hand side for the ELL phases.
    """
    import torch

    from repro_torch.configs.spmv_suite import load_suite, pareto_rows
    from repro_torch.core import jacobi_smoother, prepare
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.spmv_csrk import spmv_csrk_tiles
    from repro_torch.kernels.spmv_sellcs import spmv_sellcs_chunks
    from repro_torch.obs import get_registry
    from repro_torch.sparse import CSRMatrix, sellcs_from_csr

    # 6. kernel vs plain on small matrices
    t0 = time.perf_counter()
    errs = {}
    for name, A_s in (("bmwcra_1/64", load_suite(scale=64, ids=[16])["bmwcra_1"]),
                      ("pareto", pareto_rows(1003, seed=3))):
        sell_s = sellcs_from_csr(A_s)
        views = sell_views(sell_s, ("f32", "bf16", "int8"))
        what = (f"{name} ({A_s.m} rows, widths {int(sell_s.chunk_widths().min())}.."
                f"{int(sell_s.chunk_widths().max())}, W {views['f32'].width})")
        errs.update({(name,) + k: v for k, v in sell_kernel_vs_plain(
            views, A_s.row_lengths().cuda(), A_s.n, 2, what).items()})
    torch.cuda.synchronize()
    log(f"[sellcs/kernel] {len(errs)} cases within bound, repeat launches and B=8 columns "
        f"bit-equal; max |err| {max(errs.values()):.3e} ({time.perf_counter() - t0:.1f} s)")

    # 7. the SELL-C-σ path at the paper's bmwcra_1 size
    t0 = time.perf_counter()
    A = load_suite(scale=1, ids=[16])["bmwcra_1"]
    log(f"[sellcs/main] bmwcra_1: {A.m} rows, {A.nnz} nnz "
        f"(built in {time.perf_counter() - t0:.1f} s)")
    t_main = time.perf_counter()
    reg = get_registry()
    reg.clear()
    spmv_csrk_tiles.launches = 0
    spmv_sellcs_chunks.launches = 0
    t0 = time.perf_counter()
    op = prepare(A, device="cuda", format="auto")
    t_prep = time.perf_counter() - t0
    if op.backend != "sellcs":
        raise AssertionError(f"bmwcra_1 routed to {op.backend}, expected sellcs")
    if not np.array_equal(op.perm, np.arange(A.m)):
        raise AssertionError("the SELL-C-σ route must not reorder")
    phases = {r["name"]: r["value"] for r in reg.records() if r["section"] == "prepare"}
    log(f"[sellcs/main] prepare {t_prep:.1f} s: " + ", ".join(
        f"{k[6:-3]} {v / 1e3:.2f} s" for k, v in sorted(phases.items())
        if k.startswith("phase.") and k.endswith("_ms")))
    widths, counts = np.unique(op.sell.chunk_widths(), return_counts=True)
    tiles = op.sell_tiles
    log(f"[sellcs/main] stats row_var {op.stats.row_var:.2f}, row_skew "
        f"{op.stats.row_skew:.2f}; C {tiles.C}, sigma {op.sell.sigma}, {tiles.num_chunks} "
        f"chunks, widths " + ", ".join(f"{w} x{c}" for w, c in zip(widths, counts))
        + f"; canonical slots {op.sell.slots}, [T, C, W] view {tiles.vals.numel()} slots "
        f"(W {tiles.width}); modeled_bytes() {op.modeled_bytes()} (prices all W lanes)")
    A_dev = A.to("cuda")
    A64 = CSRMatrix(A_dev.row_ptr, A_dev.col_idx, A_dev.vals.double(), A_dev.shape)
    A_abs = CSRMatrix(A_dev.row_ptr, A_dev.col_idx, A_dev.vals.abs(), A_dev.shape)
    row_nnz = A_dev.row_lengths()
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal(A.n).astype(np.float32)).cuda()
    err = check_close(op.apply_original(x), ref.spmv_csr(A_dev, x),
                      row_bound(ref.spmv_csr(A_abs, x.abs()), row_nnz),
                      "apply_original vs plain CSR")
    log(f"[sellcs/main] apply_original vs plain CSR product: max |err| {err:.3e}")

    # perm is the identity, so op works in the original index space
    diag = csr_diagonal(A_dev)
    sweeps = 40
    X_true = torch.from_numpy(rng.standard_normal((A.n, 8)).astype(np.float32)).cuda()
    b1 = ref.spmv_csr(A_dev, X_true[:, 0].contiguous())
    for label, xt in (("1 rhs", X_true[:, 0].contiguous()), ("8 rhs", X_true)):
        b = ref.spmm_csr(A_dev, xt) if xt.ndim == 2 else b1
        d = diag[:, None] if xt.ndim == 2 else diag
        t0 = time.perf_counter()
        xs = jacobi_smoother(op, d, b, iters=sweeps)
        torch.cuda.synchronize()
        t_j = time.perf_counter() - t0
        r = (b.double() - (ref.spmm_csr(A64, xs.double()) if xt.ndim == 2
                           else ref.spmv_csr(A64, xs.double())))
        true_res = float((torch.linalg.norm(r, dim=0) / torch.linalg.norm(b.double(), dim=0))
                         .max())
        log(f"[sellcs/main] jacobi ({label}): {sweeps} sweeps, worst true relative residual "
            f"{true_res:.3e}, {t_j:.3f} s ({t_j / sweeps * 1e3:.3f} ms/sweep)")
        if not true_res <= 1e-5:
            raise AssertionError(f"jacobi ({label}) did not reach 1e-5 on bmwcra_1")
    launches = spmv_sellcs_chunks.launches
    spmvs = 1 + 2 * sweeps
    log(f"[sellcs/main] phase done in {time.perf_counter() - t_main:.1f} s")
    log(f"[sellcs/main] spmv_sellcs launches on the path: {launches} "
        f"({launches / spmvs:.2f} per SpMV over {spmvs} SpMVs); spmv_csrk_tiles "
        f"launches {spmv_csrk_tiles.launches}")
    if launches == 0:
        raise AssertionError("the SELL-C-σ path never launched its CUDA kernel")

    # 8. timing at the bmwcra_1 shapes
    t0 = time.perf_counter()
    m, n, nnz = A.m, A.n, A.nnz
    T, m_pad = tiles.num_chunks, op.sell.m_pad
    sp = library_csr(A_dev)
    views = sell_views(op.sell, ("bf16", "int8"))
    views["f32"] = tiles
    # int8 scales the kernel reads: one per 128 real lanes of every real row
    real_rows = (op.sell.row_perm < m).view(T, -1).sum(dim=1).cpu().numpy()
    w_t = op.sell.chunk_widths()
    scale_reads = int((real_rows * -(-w_t // 128)).sum())
    gen = torch.Generator(device="cuda").manual_seed(3)
    variants = []
    for dt in ("f32", "bf16", "int8"):
        view = views[dt]
        abs_view = dataclasses.replace(view, vals=view.vals.abs())
        for B in (1, 8):
            xb = torch.randn((n, B), generator=gen, device="cuda")
            xb = xb[:, 0].contiguous() if B == 1 else xb
            err = check_close(ops.spmv_sellcs(view, xb), ref.spmv_sellcs_tiles(view, xb),
                              row_bound(ref.spmv_sellcs_tiles(abs_view, xb.abs()), row_nnz),
                              f"bmwcra_1 {dt} B={B}")
            # real slots only: values, columns, int8 scales; row_perm and
            # chunk_width once; x and y once per column
            nbytes = (nnz * (VALUE_BYTES[dt] + 4) + (4 * scale_reads if dt == "int8" else 0)
                      + 4 * m_pad + 4 * T + 4 * n * B + 4 * m * B)
            variants.append(time_variant(
                "sellcs/time", dt, B, err, lambda: ops.spmv_sellcs(view, xb),
                lambda: ref.spmv_sellcs_tiles(view, xb),
                (lambda: sp @ xb) if dt == "f32" else None, nbytes, nnz, (mem_rate, f32_rate)))
    log(f"[sellcs/time] done in {time.perf_counter() - t0:.1f} s")
    entry = kernel_entry(
        "spmv_sellcs", "src/repro_torch/csrc/spmv_sellcs.cu",
        "src/repro/kernels/spmv_sellcs.py:103", launches, variants,
        {"matrix": "bmwcra_1", "m": m, "n": n, "nnz": nnz, "C": tiles.C, "chunks": T,
         "W": tiles.width, "value_dtype": "f32", "B": 1})
    return entry, {"A": A, "A_dev": A_dev, "op": op, "diag": diag, "b": b1}


def segsum_kernel_vs_plain(seg, row_nnz, n, seed: int, what: str):
    """Phase-9 checks for one container; returns {B: max_abs_err}."""
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.spmv_segsum import spmv_segsum_chunks

    gen = torch.Generator(device="cuda").manual_seed(seed)
    X = torch.randn((n, 8), generator=gen, device="cuda")
    abs_seg = dataclasses.replace(seg, vals=seg.vals.abs())
    empty = row_nnz == 0
    errs = {}
    for B, xb in ((1, X[:, 0].contiguous()), (8, X)):
        out = torch.full((seg.m,) + tuple(xb.shape[1:]), float("nan"), device="cuda")
        yb = spmv_segsum_chunks(seg.vals, seg.col_idx, seg.local_seg, seg.seg_row, seg.carry,
                                xb, seg.val_scale, m=seg.m, nnz=seg.nnz, out=out)
        if not bool((yb[empty] == 0).all()):
            raise AssertionError(f"{what} B={B}: an empty row is not 0")
        bound = row_bound(ref.spmv_segsum(abs_seg, xb.abs()), row_nnz)
        errs[B] = check_close(yb, ref.spmv_segsum(seg, xb), bound, f"{what} B={B}")
        if not torch.equal(yb, ops.spmv_segsum(seg, xb)):
            raise AssertionError(f"{what} B={B}: repeat launch differs")
    Y8 = ops.spmv_segsum(seg, X)
    for j in range(8):
        if not torch.equal(Y8[:, j], ops.spmv_segsum(seg, X[:, j].contiguous())):
            raise AssertionError(f"{what}: column {j} of B=8 != B=1")
    return errs


def segsum_pattern_exact(seg, row_nnz, what: str) -> None:
    """Unit values (scale 1 for int8) and ``x[:, j] = j + 1``: y[i, j] must be
    ``(j + 1)·k_i`` bit for bit, at B = 1 and 8.  Every partial sum is an
    integer below 2^24, so a fragment dropped or added twice shows whatever
    the row's tolerance."""
    import torch

    from repro_torch.kernels import ops

    ones = dataclasses.replace(
        seg, vals=torch.ones_like(seg.vals),
        val_scale=None if seg.val_scale is None else torch.ones_like(seg.val_scale))
    X = torch.arange(1, 9, dtype=torch.float32, device="cuda").expand(seg.shape[1], 8)
    X = X.contiguous()
    want = row_nnz.float()[:, None] * X[0]
    for B, xb, wb in ((1, X[:, 0].contiguous(), want[:, 0]), (8, X, want)):
        if not torch.equal(ops.spmv_segsum(ones, xb), wb):
            raise AssertionError(f"{what} B={B}: unit-value product != row lengths")


def csr_product(mat, v):
    """Plain CSR product of ``mat`` with [n] or [n, B] ``v``."""
    from repro_torch.kernels import ref

    return ref.spmm_csr(mat, v) if v.ndim == 2 else ref.spmv_csr(mat, v)


class Recorder:
    """A matvec that passes through to ``op`` and keeps its last input and output."""

    def __init__(self, op):
        self.op = op
        self.last = None

    def __call__(self, v):
        w = self.op(v)
        self.last = (v, w)
        return w


def check_route_products(tag, op, A_dev, seed: int, iters: int = 50) -> int:
    """``apply_original`` at B=1 and B=8 against a plain CSR product, then
    ``iters`` sweeps of power and of 8-column block power iteration whose
    last products through ``op`` must agree with a float64 CSR product
    within the bound (the iterations need not converge).  Returns the
    number of SpMVs made through ``op``."""
    import torch

    from repro_torch.core import block_power_iteration, power_iteration
    from repro_torch.sparse import CSRMatrix

    A64 = CSRMatrix(A_dev.row_ptr, A_dev.col_idx, A_dev.vals.double(), A_dev.shape)
    A_abs = CSRMatrix(A_dev.row_ptr, A_dev.col_idx, A_dev.vals.abs(), A_dev.shape)
    row_nnz = A_dev.row_lengths()
    n = A_dev.shape[1]
    rng = np.random.default_rng(seed)
    X = torch.from_numpy(rng.standard_normal((n, 8)).astype(np.float32)).cuda()
    for B, xb in ((1, X[:, 0].contiguous()), (8, X)):
        err = check_close(op.apply_original(xb), csr_product(A_dev, xb),
                          row_bound(csr_product(A_abs, xb.abs()), row_nnz),
                          f"apply_original B={B} vs plain CSR")
        log(f"[{tag}] apply_original (B={B}) vs plain CSR product: max |err| {err:.3e}")

    for label, run in (
            ("power_iteration",
             lambda mv: power_iteration(mv, n, iters=iters, device="cuda")),
            ("block_power_iteration (8)",
             lambda mv: block_power_iteration(mv, n, 8, iters=iters, device="cuda"))):
        rec = Recorder(op)
        t0 = time.perf_counter()
        est = run(rec)
        torch.cuda.synchronize()
        t_it = time.perf_counter() - t0
        v, w = rec.last
        err = check_close(w, csr_product(A64, v.double()),
                          row_bound(csr_product(A_abs, v.abs()), row_nnz),
                          f"{label}: last product vs float64 CSR")
        est = est.reshape(-1).double().cpu()
        if not bool(torch.isfinite(est).all()):
            raise AssertionError(f"{label}: non-finite estimate {est.tolist()}")
        log(f"[{tag}] {label}: {iters} sweeps in {t_it:.3f} s "
            f"({t_it / iters * 1e3:.3f} ms/sweep), estimates "
            + ", ".join(f"{e:.6g}" for e in est.tolist())
            + f"; last product vs float64 CSR within bound, max |err| {err:.3e}")
    return 2 + 2 * (iters + 1)


def segsum_phases(mem_rate: float, f32_rate: float) -> dict:
    """Phases 9-11: the segmented-sum kernel, its path at powerlaw_zipf's
    full size, timing.  Returns the kernel's entry of the ``kernels`` line."""
    import torch

    from repro_torch.configs.spmv_suite import (
        empty_margin_rows, load_adversarial, long_row_matrix, powerlaw_zipf,
        three_chunk_matrix)
    from repro_torch.core import prepare
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.spmv_csrk import spmv_csrk_tiles
    from repro_torch.kernels.spmv_segsum import spmv_segsum_chunks
    from repro_torch.kernels.spmv_sellcs import spmv_sellcs_chunks
    from repro_torch.obs import get_registry
    from repro_torch.sparse import segsum_from_csr

    # 9. kernel vs plain on small matrices
    t0 = time.perf_counter()
    errs = {}
    cases = (("powerlaw_zipf(2048)", powerlaw_zipf(2048), (128, 512)),
             ("empty margins", empty_margin_rows(300, seed=3), (128, 512)),
             ("three chunks", three_chunk_matrix(), (128,)),
             ("long row", long_row_matrix(), (128,)))
    for name, A_s, chunks in cases:
        row_nnz = A_s.row_lengths().cuda()
        for S in chunks:
            for dt in ("f32", "bf16", "int8"):
                seg = segsum_from_csr(A_s, chunk_slots=S, value_dtype=dt).to("cuda")
                what = (f"{name} ({A_s.m} rows, {int((row_nnz == 0).sum())} empty) "
                        f"S={S} T={seg.num_chunks} R={seg.segs_per_chunk} {dt}")
                errs.update({(name, S, dt, B): e for B, e in segsum_kernel_vs_plain(
                    seg, row_nnz, A_s.n, 4, what).items()})
                segsum_pattern_exact(seg, row_nnz, what)
    seg = segsum_from_csr(three_chunk_matrix(), chunk_slots=128).to("cuda")
    x = torch.from_numpy((np.arange(512) % 7 + 1).astype(np.float32)).cuda()
    y = ops.spmv_segsum(seg, x).cpu().numpy()
    if seg.num_chunks != 3 or not np.array_equal(y, [1197.0, 0.0, 14.0, 17.0]):
        raise AssertionError(f"three-chunk carry gave {y.tolist()}, expected [1197, 0, 14, 17]")
    torch.cuda.synchronize()
    log(f"[segsum/kernel] {len(errs)} cases within bound, repeat launches and B=8 columns "
        f"bit-equal, empty rows 0 in NaN-filled output, unit-value products exactly the "
        f"row lengths (a row over 40 chunks among them); three-chunk carry exactly "
        f"{y.tolist()}; max |err| {max(errs.values()):.3e} ({time.perf_counter() - t0:.1f} s)")

    # 10. the segmented-sum path at powerlaw_zipf's full size
    t0 = time.perf_counter()
    A = load_adversarial(scale=1, names=["powerlaw_zipf"])["powerlaw_zipf"]
    lengths = A.row_lengths()
    log(f"[segsum/main] powerlaw_zipf: {A.m} rows, {A.nnz} nnz, {int((lengths == 0).sum())} "
        f"empty rows, longest row {int(lengths.max())} (built in "
        f"{time.perf_counter() - t0:.1f} s)")
    t_main = time.perf_counter()
    reg = get_registry()
    reg.clear()
    spmv_csrk_tiles.launches = 0
    spmv_sellcs_chunks.launches = 0
    spmv_segsum_chunks.launches = 0
    t0 = time.perf_counter()
    op = prepare(A, device="cuda", format="auto")
    t_prep = time.perf_counter() - t0
    if op.backend != "segsum":
        raise AssertionError(f"powerlaw_zipf routed to {op.backend}, expected segsum")
    if not np.array_equal(op.perm, np.arange(A.m)):
        raise AssertionError("the segmented-sum route must not reorder")
    phases = {r["name"]: r["value"] for r in reg.records() if r["section"] == "prepare"}
    log(f"[segsum/main] prepare {t_prep:.1f} s: " + ", ".join(
        f"{k[6:-3]} {v / 1e3:.2f} s" for k, v in sorted(phases.items())
        if k.startswith("phase.") and k.endswith("_ms")))
    seg = op.segsum
    T, S, R = seg.num_chunks, seg.chunk_slots, seg.segs_per_chunk
    real = seg.real_segments()
    sr = seg.seg_row
    last_row = sr.gather(1, torch.from_numpy(real - 1).cuda()[:, None])[:, 0]
    cuts = int((sr[1:, 0] == last_row[:-1]).sum())
    log(f"[segsum/main] stats row_var {op.stats.row_var:.4g}, row_skew "
        f"{op.stats.row_skew:.4g}; T {T} chunks of S {S} slots, R {R} segments per chunk, "
        f"{real.mean():.2f} real on average (max {int(real.max())}); {cuts} of {T - 1} chunk "
        f"boundaries cut a row; modeled_bytes() {op.modeled_bytes()} (prices all T*R "
        f"partials)")
    A_dev = A.to("cuda")
    row_nnz = A_dev.row_lengths()
    spmvs = check_route_products("segsum/main", op, A_dev, seed=2)
    launches = spmv_segsum_chunks.launches
    log(f"[segsum/main] phase done in {time.perf_counter() - t_main:.1f} s")
    log(f"[segsum/main] spmv_segsum launches on the path: {launches} ({launches / spmvs:.2f} "
        f"wrapper calls per SpMV over {spmvs} SpMVs; each call is two CUDA launches, a chunk "
        f"pass and a carry pass); "
        f"spmv_csrk_tiles {spmv_csrk_tiles.launches}, spmv_sellcs {spmv_sellcs_chunks.launches}")
    if launches == 0:
        raise AssertionError("the segmented-sum path never launched its CUDA kernel")

    # 11. timing at the powerlaw_zipf shapes
    t0 = time.perf_counter()
    m, n, nnz = A.m, A.n, A.nnz
    sp = library_csr(A_dev)
    views = {dt: segsum_from_csr(A, value_dtype=dt).to("cuda") for dt in ("bf16", "int8")}
    views["f32"] = seg
    gen = torch.Generator(device="cuda").manual_seed(5)
    n_real = int(real.sum())
    variants = []
    for dt in ("f32", "bf16", "int8"):
        view = views[dt]
        segsum_pattern_exact(view, row_nnz, f"powerlaw_zipf {dt}")
        abs_view = dataclasses.replace(view, vals=view.vals.abs())
        for B in (1, 8):
            xb = torch.randn((n, B), generator=gen, device="cuda")
            xb = xb[:, 0].contiguous() if B == 1 else xb
            err = check_close(ops.spmv_segsum(view, xb), ref.spmv_segsum(view, xb),
                              row_bound(ref.spmv_segsum(abs_view, xb.abs()), row_nnz),
                              f"powerlaw_zipf {dt} B={B}")
            # least bytes, real slots only: values and columns, one int8
            # scale per 128 of them; each chunk's L_t + 1 segment offsets and
            # L_t seg_row entries; x and y once per column
            nbytes = (nnz * (VALUE_BYTES[dt] + 4) + (4 * -(-nnz // 128) if dt == "int8" else 0)
                      + 4 * (2 * n_real + T) + 4 * n * B + 4 * m * B)
            # the kernel finds the offsets from local_seg, 4 bytes a slot
            read_bytes = nbytes + 4 * nnz - 4 * (n_real + T)
            variants.append(time_variant(
                "segsum/time", dt, B, err, lambda: ops.spmv_segsum(view, xb),
                lambda: ref.spmv_segsum(view, xb),
                (lambda: sp @ xb) if dt == "f32" else None, nbytes, nnz, (mem_rate, f32_rate),
                read_bytes=read_bytes))
    log(f"[segsum/time] unit-value products exactly the row lengths at full size "
        f"(f32/bf16/int8, B=1 and 8); done in {time.perf_counter() - t0:.1f} s")
    return kernel_entry(
        "spmv_segsum", "src/repro_torch/csrc/spmv_segsum.cu",
        "src/repro/kernels/spmv_segsum.py:101", launches, variants,
        {"matrix": "powerlaw_zipf", "m": m, "n": n, "nnz": nnz, "chunks": T, "S": S, "R": R,
         "value_dtype": "f32", "B": 1},
        cuda_launches_per_call=2 if seg.carry.shape[0] else 1)


def abs_dia(d):
    """The same DIA-hybrid container with |values| (for the |A| |x| bound)."""
    return dataclasses.replace(d, diag_vals=d.diag_vals.abs(), remainder=dataclasses.replace(
        d.remainder, vals=d.remainder.vals.abs()))


def dia_kernel_vs_plain(d, row_nnz, seed: int, what: str):
    """Phase-12 checks for one container; returns {B: max_abs_err}."""
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.spmv_diahybrid import spmv_diahybrid_rows

    gen = torch.Generator(device="cuda").manual_seed(seed)
    X = torch.randn((d.n, 8), generator=gen, device="cuda")
    r = d.remainder
    errs = {}
    for B, xb in ((1, X[:, 0].contiguous()), (8, X)):
        out = torch.full((d.m,) + tuple(xb.shape[1:]), float("nan"), device="cuda")
        yb = spmv_diahybrid_rows(d.diag_vals, d.offset_vec, r.row_ptr, r.col_idx, r.vals, xb,
                                 m=d.m, n=d.n, out=out)
        bound = row_bound(ref.spmv_diahybrid(abs_dia(d), xb.abs()), row_nnz)
        errs[B] = check_close(yb, ref.spmv_diahybrid(d, xb), bound, f"{what} B={B}")
        if not torch.equal(yb, ops.spmv_diahybrid(d, xb)):
            raise AssertionError(f"{what} B={B}: repeat launch differs")
    Y8 = ops.spmv_diahybrid(d, X)
    for j in range(8):
        if not torch.equal(Y8[:, j], ops.spmv_diahybrid(d, X[:, j].contiguous())):
            raise AssertionError(f"{what}: column {j} of B=8 != B=1")
    return errs


def dia_phases(mem_rate: float, f32_rate: float):
    """Phases 12-14: the DIA/CSR-hybrid kernel, its path at
    stencil_fringe(side=2048), timing.  Returns the kernel's entry of the
    ``kernels`` line and the matrix (on the host), which the ELL timing
    reuses."""
    import torch

    from repro_torch.configs.spmv_suite import (
        dia_hand_matrix, dia_rectangular_matrix, grid_laplacian_2d, no_dense_diagonal_matrix,
        stencil_fringe)
    from repro_torch.core import prepare
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.spmv_csrk import spmv_csrk_tiles
    from repro_torch.kernels.spmv_diahybrid import spmv_diahybrid_rows
    from repro_torch.kernels.spmv_segsum import spmv_segsum_chunks
    from repro_torch.kernels.spmv_sellcs import spmv_sellcs_chunks
    from repro_torch.obs import get_registry
    from repro_torch.sparse import diahybrid_from_csr

    # 12. kernel vs plain on small matrices
    t0 = time.perf_counter()
    errs = {}
    cases = (("stencil_fringe(48)", stencil_fringe(48)),
             ("stencil_fringe(64)", stencil_fringe(64)),
             ("rectangular 130x200", dia_rectangular_matrix()),
             ("pure plane (9-point grid 24x24)", grid_laplacian_2d(24, 24, stencil=9)),
             ("pure remainder", no_dense_diagonal_matrix()))
    for name, A_s in cases:
        row_nnz = A_s.row_lengths().cuda()
        for dt in ("f32", "bf16"):
            d = diahybrid_from_csr(A_s, value_dtype=dt).to("cuda")
            what = (f"{name} ({A_s.m}x{A_s.n}, offsets {list(d.offsets)}, remainder "
                    f"{d.remainder.nnz}) {dt}")
            errs.update({(name, dt, B): e for B, e in dia_kernel_vs_plain(
                d, row_nnz, 7, what).items()})
    A_h = dia_hand_matrix()
    X = torch.arange(1, 9, dtype=torch.float32)[:, None] * torch.tensor([1.0, -2.0, 3.0])
    want = (A_h.todense().double() @ X.double()).float().cuda()
    X = X.cuda()
    for dt in ("f32", "bf16"):
        d = diahybrid_from_csr(A_h, occupancy=0.7, value_dtype=dt).to("cuda")
        if d.offsets != (-2, 0, 2) or d.remainder.nnz != 1:
            raise AssertionError(f"hand case split as {d.offsets}, {d.remainder.nnz} remainder")
        if not (torch.equal(ops.spmv_diahybrid(d, X), want)
                and torch.equal(ops.spmv_diahybrid(d, X[:, 0].contiguous()), want[:, 0])):
            raise AssertionError(f"hand case {dt}: not exactly the integer product")
    A_f = stencil_fringe(64)
    d = diahybrid_from_csr(A_f).to("cuda")
    bad = torch.tensor([float("inf"), float("-inf"), float("nan")], device="cuda")
    n_bad = {}
    for B in (1, 8):
        xb = torch.randn((A_f.n, B), device="cuda")
        xb[[0, 100, A_f.n - 1]] = bad[:, None]
        xb = xb[:, 0].contiguous() if B == 1 else xb
        y, yp = ops.spmv_diahybrid(d, xb), ref.spmv_diahybrid(d, xb)
        for test in (torch.isnan, torch.isposinf, torch.isneginf):
            if not torch.equal(test(y), test(yp)):
                raise AssertionError(f"non-finite x, B={B}: {test.__name__} differs from plain")
        n_bad[B] = (int(torch.isnan(y).sum()), int(torch.isinf(y).sum()))
    torch.cuda.synchronize()
    log(f"[dia/kernel] {len(errs)} cases within bound, repeat launches and B=8 columns "
        f"bit-equal, every row written into NaN-filled output; hand case exact "
        f"(f32/bf16, B=1 and 3); inf/-inf/NaN in x: NaN and inf rows equal the plain "
        f"version's (NaN, inf rows at B=1 {n_bad[1]}, B=8 {n_bad[8]}); max |err| "
        f"{max(errs.values()):.3e} ({time.perf_counter() - t0:.1f} s)")

    # 13. the DIA/CSR-hybrid path at stencil_fringe(side=2048)
    t0 = time.perf_counter()
    A = stencil_fringe(side=2048)
    lengths = A.row_lengths()
    log(f"[dia/main] stencil_fringe(side=2048): {A.m} rows, {A.nnz} nnz, longest row "
        f"{int(lengths.max())} (built in {time.perf_counter() - t0:.1f} s)")
    t_main = time.perf_counter()
    reg = get_registry()
    reg.clear()
    spmv_csrk_tiles.launches = 0
    spmv_sellcs_chunks.launches = 0
    spmv_segsum_chunks.launches = 0
    spmv_diahybrid_rows.launches = 0
    t0 = time.perf_counter()
    op = prepare(A, device="cuda", format="auto")
    t_prep = time.perf_counter() - t0
    if op.backend != "diahybrid":
        raise AssertionError(f"stencil_fringe routed to {op.backend}, expected diahybrid")
    if not np.array_equal(op.perm, np.arange(A.m)):
        raise AssertionError("the DIA/CSR-hybrid route must not reorder")
    phases = {r["name"]: r["value"] for r in reg.records() if r["section"] == "prepare"}
    log(f"[dia/main] prepare {t_prep:.1f} s: " + ", ".join(
        f"{k[6:-3]} {v / 1e3:.2f} s" for k, v in sorted(phases.items())
        if k.startswith("phase.") and k.endswith("_ms")))
    dia = op.dia
    rem_len = dia.remainder.row_lengths()
    log(f"[dia/main] stats row_var {op.stats.row_var:.4g}, diag_fraction "
        f"{op.stats.diag_fraction:.4f}, row_skew {op.stats.row_skew:.4g}; offsets "
        f"{list(dia.offsets)}; diag_nnz {dia.diag_nnz}, remainder nnz {dia.remainder.nnz} "
        f"in {int((rem_len > 0).sum())} rows (longest {int(rem_len.max())}); value_dtype "
        f"{op.value_dtype}; padding_overhead {op.padding_overhead():.4f}; modeled_bytes() "
        f"{op.modeled_bytes()} (prices one x read per plane slot)")
    A_dev = A.to("cuda")
    row_nnz = A_dev.row_lengths()
    spmvs = check_route_products("dia/main", op, A_dev, seed=3)
    launches = spmv_diahybrid_rows.launches
    log(f"[dia/main] phase done in {time.perf_counter() - t_main:.1f} s")
    log(f"[dia/main] spmv_diahybrid launches on the path: {launches} over {spmvs} SpMVs "
        f"(one CUDA launch each); spmv_csrk_tiles {spmv_csrk_tiles.launches}, spmv_sellcs "
        f"{spmv_sellcs_chunks.launches}, spmv_segsum {spmv_segsum_chunks.launches}")
    if launches != spmvs:
        raise AssertionError(f"the DIA/CSR-hybrid path made {launches} kernel launches for "
                             f"{spmvs} SpMVs, expected one each")

    # 14. timing at the stencil_fringe(2048) shapes
    t0 = time.perf_counter()
    m, n, nnz = A.m, A.n, A.nnz
    sp = library_csr(A_dev)
    views = {"f32": dia, "bf16": diahybrid_from_csr(A, value_dtype="bf16").to("cuda")}
    gen = torch.Generator(device="cuda").manual_seed(8)
    rem_nnz = dia.remainder.nnz
    variants = []
    for dt in ("f32", "bf16"):
        view = views[dt]
        abs_view = abs_dia(view)
        for B in (1, 8):
            xb = torch.randn((n, B), generator=gen, device="cuda")
            xb = xb[:, 0].contiguous() if B == 1 else xb
            err = check_close(ops.spmv_diahybrid(view, xb), ref.spmv_diahybrid(view, xb),
                              row_bound(ref.spmv_diahybrid(abs_view, xb.abs()), row_nnz),
                              f"stencil_fringe(2048) {dt} B={B}")
            # least bytes: the plane once, remainder values and columns, its
            # row pointers, x and y once per column
            nbytes = (view.n_diag * m * VALUE_BYTES[dt] + 8 * rem_nnz + 4 * (m + 1)
                      + 4 * n * B + 4 * m * B)
            variants.append(time_variant(
                "dia/time", dt, B, err, lambda: ops.spmv_diahybrid(view, xb),
                lambda: ref.spmv_diahybrid(view, xb),
                (lambda: sp @ xb) if dt == "f32" else None, nbytes, nnz, (mem_rate, f32_rate)))
    log(f"[dia/time] done in {time.perf_counter() - t0:.1f} s")
    entry = kernel_entry(
        "spmv_diahybrid", "src/repro_torch/csrc/spmv_diahybrid.cu",
        "src/repro/kernels/spmv_diahybrid.py:84", launches, variants,
        {"matrix": "stencil_fringe(side=2048)", "m": m, "n": n, "nnz": nnz,
         "n_diag": dia.n_diag, "diag_nnz": dia.diag_nnz, "remainder_nnz": rem_nnz,
         "value_dtype": "f32", "B": 1})
    return entry, A


def ell_bound(e, x):
    """Per-row bound over the slab's own slots: (2 k_i + 2) eps32 (|vals| |x[col]|)_i,
    k_i the row's nonzero slots."""
    from repro_torch.kernels import ref

    return row_bound(ref.ell_rows(e.col_idx, e.vals.abs(), x.abs()), (e.vals != 0).sum(dim=1))


def ell_kernel_vs_plain(e, n, seed: int, what: str) -> float:
    """Phase-15 checks for one slab: within the bound of the plain version,
    every row written into NaN-filled output, a repeat launch bit-equal."""
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.spmv_ell import spmv_ell_rows

    m = e.shape[0]
    x = torch.randn(n, generator=torch.Generator(device="cuda").manual_seed(seed), device="cuda")
    out = torch.full((m,), float("nan"), device="cuda")
    y = spmv_ell_rows(e.col_idx, e.vals, x, m=m, n=n, out=out)
    err = check_close(y, ref.ell_rows(e.col_idx, e.vals, x), ell_bound(e, x), what)
    if not torch.equal(y, ops.spmv_ell(e, x)):
        raise AssertionError(f"{what}: repeat launch differs")
    return err


def ell_phases(mem_rate: float, f32_rate: float, bmw: dict, fringe, others: dict) -> dict:
    """Phases 15-17: the ELL kernel, the ELL path at bmwcra_1's full size,
    timing on bmwcra_1 and stencil_fringe(2048).  ``bmw`` is what the
    SELL-C-σ phase built, ``fringe`` the DIA phase's matrix (host) and
    ``others`` the other kernels' entries.  Returns the kernel's entry of the
    ``kernels`` line."""
    import torch

    from repro_torch.configs.spmv_suite import ell_width_matrix, load_suite
    from repro_torch.core import jacobi_smoother
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.spmv_csrk import spmv_csrk_tiles
    from repro_torch.kernels.spmv_diahybrid import spmv_diahybrid_rows
    from repro_torch.kernels.spmv_ell import spmv_ell_rows
    from repro_torch.kernels.spmv_segsum import spmv_segsum_chunks
    from repro_torch.kernels.spmv_sellcs import spmv_sellcs_chunks
    from repro_torch.obs import get_registry
    from repro_torch.sparse import CSRMatrix, ell_from_csr

    # 15. kernel vs plain on small slabs
    t0 = time.perf_counter()
    bmw64 = load_suite(scale=64, ids=[16])["bmwcra_1"]
    widths = {k: ell_width_matrix(1003, 700, k, seed=k) for k in (1, 5, 33, 80, 129)}
    cases = [("bmwcra_1/64", bmw64, None), ("bmwcra_1/64 cut at 50", bmw64, 50)]
    cases += [(f"m 1003, kmax {k}", A_s, None) for k, A_s in widths.items()]
    cases += [("m 1003, kmax 129 cut at 40", widths[129], 40),
              ("all empty 37x20", CSRMatrix.fromdense(np.zeros((37, 20), np.float32)), None)]
    errs = {}
    for name, A_s, cut in cases:
        e = ell_from_csr(A_s, cut).to("cuda")
        errs[name] = ell_kernel_vs_plain(e, A_s.n, 10, f"{name} (kmax {e.kmax})")
    bad = torch.tensor([float("inf"), float("-inf"), float("nan")], device="cuda")
    n_bad = {}
    for name, A_s in (("bmwcra_1/64", bmw64), ("kmax 80", widths[80])):
        e = ell_from_csr(A_s).to("cuda")
        x = torch.randn(A_s.n, device="cuda")
        x[[0, 100, A_s.n - 1]] = bad
        y, yp = ops.spmv_ell(e, x), ref.ell_rows(e.col_idx, e.vals, x)
        for test in (torch.isnan, torch.isposinf, torch.isneginf):
            if not torch.equal(test(y), test(yp)):
                raise AssertionError(f"{name}, non-finite x: {test.__name__} differs from plain")
        n_bad[name] = (int(torch.isnan(y).sum()), int(torch.isinf(y).sum()))
    torch.cuda.synchronize()
    log(f"[ell/kernel] {len(errs)} slabs (kmax 1..129, two cut, one all padding) within "
        f"bound, repeat launches bit-equal, every row written into NaN-filled output; "
        f"inf/-inf/NaN in x (inf at x[0]): NaN and inf rows equal the plain version's "
        f"(NaN, inf rows {n_bad}); max |err| {max(errs.values()):.3e} "
        f"({time.perf_counter() - t0:.1f} s)")

    # 16. the ELL path at bmwcra_1's full size
    A, A_dev, op, diag, b = (bmw[k] for k in ("A", "A_dev", "op", "diag", "b"))
    t0 = time.perf_counter()
    ell_host = ell_from_csr(A)
    t_build = time.perf_counter() - t0
    ell = ell_host.to("cuda")
    slots = ell.vals.numel()
    log(f"[ell/main] bmwcra_1: {A.m} rows, {A.nnz} nnz; ell_from_csr {t_build:.2f} s: kmax "
        f"{ell.kmax}, {slots} slots, padding_overhead {ell_host.padding_overhead():.4f}")
    sweeps = 40
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal(A.n).astype(np.float32)).cuda()
    y_sell = op.apply_original(x)
    x_sell = jacobi_smoother(op, diag, b, iters=sweeps)
    A_abs = CSRMatrix(A_dev.row_ptr, A_dev.col_idx, A_dev.vals.abs(), A_dev.shape)
    A64 = CSRMatrix(A_dev.row_ptr, A_dev.col_idx, A_dev.vals.double(), A_dev.shape)
    bound = row_bound(ref.spmv_csr(A_abs, x.abs()), A_dev.row_lengths())
    t_main = time.perf_counter()
    reg = get_registry()
    reg.clear()
    for counted in (spmv_csrk_tiles, spmv_sellcs_chunks, spmv_segsum_chunks,
                    spmv_diahybrid_rows, spmv_ell_rows):
        counted.launches = 0
    y = ops.spmv_ell(ell, x)
    err_csr = check_close(y, ref.spmv_csr(A_dev, x), bound, "ELL vs plain CSR")
    err_sell = check_close(y, y_sell, bound, "ELL vs the SELL-C-σ route")
    t0 = time.perf_counter()
    xs = jacobi_smoother(lambda v: ops.spmv_ell(ell, v), diag, b, iters=sweeps)
    torch.cuda.synchronize()
    t_j = time.perf_counter() - t0
    launches = spmv_ell_rows.launches
    other = {f.__name__: f.launches for f in (spmv_csrk_tiles, spmv_sellcs_chunks,
                                              spmv_segsum_chunks, spmv_diahybrid_rows)}
    true_res = float(torch.linalg.norm(b.double() - ref.spmv_csr(A64, xs.double()))
                     / torch.linalg.norm(b.double()))
    vs_sell = float(torch.linalg.norm(xs - x_sell) / torch.linalg.norm(x_sell))
    spmvs = 1 + sweeps
    log(f"[ell/main] spmv_ell vs plain CSR product: max |err| {err_csr:.3e}; vs the SELL-C-σ "
        f"route: max |diff| {err_sell:.3e}")
    log(f"[ell/main] jacobi through ops.spmv_ell: {sweeps} sweeps, true relative residual "
        f"{true_res:.3e}, relative difference from the SELL-C-σ route's iterate "
        f"{vs_sell:.3e}, {t_j:.3f} s ({t_j / sweeps * 1e3:.3f} ms/sweep)")
    log(f"[ell/main] phase done in {time.perf_counter() - t_main:.1f} s; spmv_ell launches on "
        f"the path: {launches} over {spmvs} SpMVs (one CUDA launch each); others {other}")
    if not true_res <= 1e-5 or not vs_sell <= 1e-5:
        raise AssertionError("jacobi through ELL did not match the SELL-C-σ route to 1e-5")
    if launches != spmvs or any(other.values()):
        raise AssertionError(f"the ELL path made {launches} ELL launches for {spmvs} SpMVs "
                             f"and {other} others, expected one ELL launch each")

    # 17. timing on bmwcra_1 and stencil_fringe(2048)
    def time_ell(label, A_t, A_t_dev, ell_t):
        xt = torch.randn(A_t.n, generator=torch.Generator(device="cuda").manual_seed(11),
                         device="cuda")
        A_abs_t = CSRMatrix(A_t_dev.row_ptr, A_t_dev.col_idx, A_t_dev.vals.abs(), A_t_dev.shape)
        err = check_close(ops.spmv_ell(ell_t, xt), ref.spmv_csr(A_t_dev, xt),
                          row_bound(ref.spmv_csr(A_abs_t, xt.abs()), A_t_dev.row_lengths()),
                          f"{label} ELL vs plain CSR")
        err = max(err, check_close(ops.spmv_ell(ell_t, xt), ref.ell_rows(
            ell_t.col_idx, ell_t.vals, xt), ell_bound(ell_t, xt), f"{label} ELL vs plain"))
        sp = library_csr(A_t_dev)
        # least bytes: the slab (value and column of every slot, padding
        # included: it is the function's input), x and y once
        slots_t = ell_t.vals.numel()
        nbytes = 8 * slots_t + 4 * A_t.n + 4 * A_t.m
        rec = time_variant(
            "ell/time", "f32", 1, err, lambda: ops.spmv_ell(ell_t, xt),
            lambda: ref.ell_rows(ell_t.col_idx, ell_t.vals, xt), lambda: sp @ xt, nbytes,
            slots_t, (mem_rate, f32_rate))
        rec["matrix"] = label
        beside = others["spmv_sellcs" if label == "bmwcra_1" else "spmv_diahybrid"]
        log(f"[ell/time] {label}: ELL {rec['ms']:.4f} ms beside {beside['name']} "
            f"{beside['ms']:.4f} ms and cuSPARSE {rec['library_ms']:.4f} ms (this run)")
        return rec

    t0 = time.perf_counter()
    variants = [time_ell("bmwcra_1", A, A_dev, ell)]
    t1 = time.perf_counter()
    ell_f = ell_from_csr(fringe)
    t_build = time.perf_counter() - t1
    log(f"[ell/time] stencil_fringe(2048): {fringe.m} rows, {fringe.nnz} nnz; ell_from_csr "
        f"{t_build:.2f} s: kmax {ell_f.kmax}, {ell_f.vals.numel()} slots "
        f"({ell_f.vals.numel() / fringe.nnz:.2f} x nnz), padding_overhead "
        f"{ell_f.padding_overhead():.4f}, slab {8 * ell_f.vals.numel() / 1e9:.2f} GB")
    # the 2.45 GB slab lives on the card only inside this call
    variants.append(time_ell("stencil_fringe(2048)", fringe, fringe.to("cuda"),
                             ell_f.to("cuda")))
    del ell_f
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"[ell/time] done in {time.perf_counter() - t0:.1f} s")
    return kernel_entry(
        "spmv_ell", "src/repro_torch/csrc/spmv_ell.cu", "src/repro/kernels/spmv_ell.py:29",
        launches, variants,
        {"matrix": "bmwcra_1", "m": A.m, "n": A.n, "nnz": A.nnz, "kmax": ell.kmax,
         "slots": slots, "value_dtype": "f32", "B": 1})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.spmv_suite import load_suite
    from repro_torch.core import block_cg, cg, prepare
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.spmv_csrk import spmv_csrk_tiles
    from repro_torch.obs import get_registry
    from repro_torch.sparse import CSRMatrix

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_all = time.perf_counter()

    # 1. build
    build_all(("spmv_csrk", "spmv_sellcs", "spmv_segsum", "spmv_diahybrid", "spmv_ell"))

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
    sp = library_csr(csr)
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
            nbytes = nnz * (VALUE_BYTES[dt] + 8) + scale_bytes + n * 4 * B + m * 4 * B
            variants.append(time_variant(
                "time", dt, B, err, lambda: ops.spmv_csrk_bucketed(view, xb),
                lambda: ref.spmv_csrk_buckets(view, xb),
                (lambda: sp @ xb) if dt == "f32" else None, nbytes, nnz, (mem_rate, f32_rate)))
    log(f"[time] done in {time.perf_counter() - t0:.1f} s")

    # 6.-8. the SELL-C-σ kernel and its path
    sell_entry, bmw = sellcs_phases(mem_rate, f32_rate)

    # 9.-11. the segmented-sum kernel and its path
    segsum_entry = segsum_phases(mem_rate, f32_rate)

    # 12.-14. the DIA/CSR-hybrid kernel and its path
    dia_entry, fringe = dia_phases(mem_rate, f32_rate)

    # 15.-17. the ELL kernel and its path
    ell_entry = ell_phases(mem_rate, f32_rate, bmw, fringe,
                           {e["name"]: e for e in (sell_entry, dia_entry)})

    # 18. result lines
    kernels = {"kernels": [kernel_entry(
        "spmv_csrk_tiles", "src/repro_torch/csrc/spmv_csrk.cu",
        "src/repro/kernels/spmv_csrk.py:131", launches, variants,
        {"matrix": "ecology1", "m": m, "n": n, "nnz": nnz, "value_dtype": "f32", "B": 1},
    ), sell_entry, segsum_entry, dia_entry, ell_entry]}
    print(json.dumps(kernels), flush=True)
    log(f"[card] {card}")
    log(f"[done] {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
