"""Fit the constant-time tuner's device model on the card (paper Sec. 4).

    PYTHONPATH=src python -m repro_torch.launch.fit_device_model [--quick]
        [--scale N] [--scale-for ID:N,...] [--ids 1,8,9] [--jobs J]
        [--out device_model.json] [--name h100] [--device cuda|cpu]

Port of the reference's ``benchmarks/fit_device_model.py``: the paper's
calibration protocol, run with the hand-written CSR-k kernel.

1. For each Table-2 suite matrix (``configs/spmv_suite.py``), build it at
   its paper N / ``scale`` rows (``--scale-for`` sets one id's scale), Band-k
   it once, and time every (SSRS, SRS) in ``tuner.GPU_SWEEP``² with
   SSRS·SRS ≤ max(m // 4, 8), the reference's skip rule.  Each candidate is
   built as ``prepare`` builds it (``build_csrk`` → ``tiles_from_csrk`` →
   ``bucket_tiles``) and timed through ``ops.spmv_csrk_bucketed`` at f32,
   B=1: device time from CUDA-graph replay between CUDA events.  Its y must
   lie within (2·k_i+2)·eps32·(|A|·|x|)_i of the plain CSR product.  The
   optimum and every pair within 2% of it are kept.
2. Fit ``size = a − b·ln(rdensity)`` for SSRS and SRS with
   ``tuner.fit_log_model`` over every matrix's optimum, as the reference
   fits.  The kernel's time follows the tile's rows, SSRS·SRS, and hardly
   how they split ((a, b) and (b, a) time alike), so a flat optimum is
   represented by its most nearly square pair within 2%, the fastest of
   those: SSRS and SRS then move together from matrix to matrix instead of
   jumping between (4, 24) and (24, 4).
3. Per matrix, time the fitted model's pick (``tuner.tune_h100``), above
   rdensity 8 the pick of the paper's Ampere case table applied to the
   fitted base (``tuner.ampere_cases``), the A100 model's pick and
   ``torch.sparse`` CSR (cuSPARSE on the card, int32 indices), and print
   the table.
4. Write ``{name: {"ssrs": [a, b], "srs": [a, b], "gather_chunk": g}}``,
   the shape ``tuner.load_fitted_device_model`` reads, with ``g`` the
   hand-set width (the kernel has no one-hot gather to tune).

Install the result with ``REPRO_DEVICE_MODEL=device_model.json`` or
``tuner.use_device_model(tuner.load_fitted_device_model(path, "h100"))``.

``--jobs J`` builds and Band-k's the matrices in J worker processes; only
one process uses the device at a time.  ``--device cpu`` (tests) times the
plain PyTorch version on the host instead, and names it so.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

from repro_torch.configs.spmv_suite import SUITE
from repro_torch.core import tuner
from repro_torch.core.ordering import bandk
from repro_torch.core.spmv import _resolve_device
from repro_torch.kernels import ops, ref
from repro_torch.sparse import CSRMatrix, bucket_tiles, build_csrk, tiles_from_csrk
from repro_torch.sparse._tree import host

QUICK_IDS = (1, 9, 12, 16)      # spans rdensity ≈ 4 … 75, as the reference's
NEAR = 0.02                     # pairs within 2% of the optimum are kept
EPS32 = float(np.finfo(np.float32).eps)

#: Set in each worker process by ``_init_worker``: the lock that keeps the
#: device to one process at a time.
_DEVICE_LOCK = None


def candidates(m: int) -> list:
    """The (SSRS, SRS) pairs the reference's sweep times for ``m`` rows."""
    most = max(m // 4, 8)
    return [(a, b) for a in tuner.GPU_SWEEP for b in tuner.GPU_SWEEP if a * b <= most]


def time_ms(fn, device: torch.device, reps: int = 20, iters: int = 10) -> float:
    """Milliseconds of one ``fn()``.

    On the card: device time, ``reps`` calls captured in one CUDA graph and
    replayed ``iters`` times between two CUDA events (as ``chip_smoke.py``
    times).  On the CPU: host time of ``reps`` calls of the plain version.
    """
    if device.type == "cpu":
        fn()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / (reps * iters)


def _device_turn():
    return _DEVICE_LOCK if _DEVICE_LOCK is not None else contextlib.nullcontext()


class _Timer:
    """Times CSR-k candidates of one Band-k'd matrix on ``device``, each held
    within the per-row bound of the plain CSR product."""

    def __init__(self, Ar: CSRMatrix, device: torch.device, name: str):
        self.Ar, self.device, self.name = Ar, device, name
        self._dev = None

    def _on_device(self):
        """The matrix, x, the plain product and the row bound on the device,
        made at the first turn and kept."""
        if self._dev is None:
            A = self.Ar.to(self.device)
            x = np.random.default_rng(0).standard_normal(A.n).astype(np.float32)
            x = torch.from_numpy(x).to(self.device)
            A_abs = CSRMatrix(A.row_ptr, A.col_idx, A.vals.abs(), A.shape)
            bound = ((2 * A.row_lengths().to(torch.float32) + 2) * EPS32
                     * ref.spmv_csr(A_abs, x.abs()))
            self._dev = A, x, ref.spmv_csr(A, x), bound
        return self._dev

    def pairs(self, pairs) -> dict:
        """{(ssrs, srs): ms} for each pair, built on the host one at a time."""
        out = {}
        for ssrs, srs in pairs:
            view = bucket_tiles(tiles_from_csrk(build_csrk(self.Ar, srs=srs, ssrs=ssrs, k=3)))
            with _device_turn():
                _, x, y_plain, bound = self._on_device()
                v = view.to(self.device)
                bad = int(((ops.spmv_csrk_bucketed(v, x) - y_plain).abs() > bound).sum())
                if bad:
                    raise AssertionError(
                        f"{self.name} ({ssrs}, {srs}): {bad} rows outside the bound "
                        "of the plain CSR product")
                out[(ssrs, srs)] = time_ms(lambda: ops.spmv_csrk_bucketed(v, x), self.device)
        return out

    def library_ms(self) -> float:
        """``torch.sparse`` CSR (cuSPARSE on the card), int32 indices."""
        warnings.filterwarnings("ignore", message=".*[Ss]parse CSR tensor support is in beta.*")
        with _device_turn():
            A, x, _, _ = self._on_device()
            sp = torch.sparse_csr_tensor(A.row_ptr.int(), A.col_idx.int(), A.vals,
                                         size=A.shape, check_invariants=True)
            return time_ms(lambda: sp @ x, self.device)


def _csr_arrays(A: CSRMatrix) -> tuple:
    return host(A.row_ptr), host(A.col_idx), host(A.vals), tuple(A.shape)


def _csr(arrays: tuple) -> CSRMatrix:
    rp, ci, vl, shape = arrays
    return CSRMatrix(torch.from_numpy(rp), torch.from_numpy(ci), torch.from_numpy(vl), shape)


def sweep_matrix(entry_id: int, scale: int, device: str) -> dict:
    """Round 1 for one suite matrix: build, Band-k, time every candidate, the
    A100 model's pick and the library call.  Returns its row, with the
    Band-k'd matrix's arrays under ``"csr"`` for round 2."""
    entry = next(e for e in SUITE if e.id == entry_id)
    dev = torch.device(device)
    t0 = time.perf_counter()
    A = entry.build(scale)
    Ar = A.symmetric_permute(bandk(A, k=3))
    host_s = time.perf_counter() - t0
    timer = _Timer(Ar, dev, entry.name)
    rd = Ar.rdensity
    amp = tuner.tune_ampere(rd)
    amp_pair = (amp.ssrs, amp.srs)
    cands = candidates(Ar.m)
    times = timer.pairs(cands + ([amp_pair] if amp_pair not in cands else []))
    grid = {p: times[p] for p in cands}
    best = min(grid, key=grid.get)
    return {
        "id": entry.id, "name": entry.name, "scale": scale, "m": Ar.m, "nnz": Ar.nnz,
        "rdensity": rd, "times": times, "candidates": cands,
        "opt": best, "opt_ms": grid[best],
        "near": sorted(p for p, t in grid.items() if t <= grid[best] * (1 + NEAR)),
        "ampere": amp_pair, "library_ms": timer.library_ms(),
        "host_s": host_s, "csr": _csr_arrays(Ar),
    }


def time_pairs(name: str, arrays: tuple, pairs, device: str) -> dict:
    """Round 2: ``{pair: ms}`` for pairs of an already Band-k'd matrix."""
    return _Timer(_csr(arrays), torch.device(device), name).pairs(pairs)


def _init_worker(lock) -> None:
    global _DEVICE_LOCK
    _DEVICE_LOCK = lock
    torch.set_num_threads(1)


def representative(row: dict) -> tuple:
    """The pair that stands for a row's optimum in the fit: of the pairs
    within ``NEAR`` of it, the most nearly square, then the fastest."""
    return min(row["near"], key=lambda p: (abs(np.log(p[0] / p[1])), row["times"][p]))


def fit(rows: list, name: str = "h100") -> tuner.DeviceModel:
    """The model fitted over every row's representative optimum."""
    if len({round(r["rdensity"], 9) for r in rows}) < 2:
        raise ValueError("the fit needs matrices of at least two rdensities")
    rds = np.asarray([r["rdensity"] for r in rows])
    reps = np.asarray([representative(r) for r in rows])
    a1, b1 = tuner.fit_log_model(rds, reps[:, 0])
    a2, b2 = tuner.fit_log_model(rds, reps[:, 1])
    return tuner.DeviceModel(name, a1, b1, a2, b2, gather_chunk=tuner.H100.gather_chunk)


def picks(row: dict, model: tuner.DeviceModel) -> dict:
    """The pairs round 2 reports for a row: the fitted model's, and above
    rdensity 8 the Ampere case table's on the fitted base."""
    p = tuner.tune_h100(row["rdensity"], model=model)
    out = {"fitted": (p.ssrs, p.srs)}
    if row["rdensity"] > 8:
        out["table"] = tuner.ampere_cases(row["rdensity"], *model.base(row["rdensity"]))
    return out


def _map(jobs: int, fn, argss):
    """``[fn(*args) for args in argss]``, in ``jobs`` spawned processes when
    ``jobs > 1`` (one of them on the device at a time)."""
    if jobs <= 1:
        return [fn(*args) for args in argss]
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    ctx = mp.get_context("spawn")
    with ProcessPoolExecutor(jobs, mp_context=ctx, initializer=_init_worker,
                             initargs=(ctx.Lock(),)) as pool:
        futures = [pool.submit(fn, *args) for args in argss]
        return [f.result() for f in futures]


def card_line(device: torch.device) -> str:
    if device.type != "cuda":
        return f"{device} (plain PyTorch version, host time)"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def run(scale: int = 1024, quick: bool = False, out: str = "device_model.json",
        name: str = "h100", ids=None, device: str = "cuda", scale_for=None,
        jobs: int = 1) -> dict:
    """The protocol above; returns ``{"model": {...}, "rows": [...]}`` and
    writes the model to ``out``."""
    dev = _resolve_device(device)
    if dev.type == "cuda":
        from repro_torch.kernels.spmv_csrk import _library

        _library()   # build once, before any worker loads it
    if ids is None:
        ids = QUICK_IDS if quick else tuple(e.id for e in SUITE)
    scale_for = dict(scale_for or {})
    scales = {i: scale_for.get(i, scale) for i in ids}
    size = {e.id: e.paper_n / scales[e.id] for e in SUITE if e.id in scales}
    order = sorted(scales, key=lambda i: -size[i])     # largest first
    t0 = time.perf_counter()
    rows = _map(jobs, sweep_matrix, [(i, scales[i], str(dev)) for i in order])
    sweep_s = time.perf_counter() - t0
    model = fit(rows, name)
    todo = []
    for r in rows:
        r.update({k + "_pick": v for k, v in picks(r, model).items()})
        todo.append(sorted({r[k] for k in ("fitted_pick", "table_pick") if k in r}
                           - set(r["times"])))
    timed = _map(jobs, time_pairs, [(r["name"], r["csr"], p, str(dev))
                                    for r, p in zip(rows, todo) if p])
    timed = iter(timed)
    for r, p in zip(rows, todo):
        if p:
            r["times"].update(next(timed))
        del r["csr"]
    rows.sort(key=lambda r: r["id"])
    fitted = {name: {"ssrs": [model.ssrs_a, model.ssrs_b], "srs": [model.srs_a, model.srs_b],
                     "gather_chunk": model.gather_chunk}}
    with open(out, "w") as fh:
        json.dump(fitted, fh, indent=2)
    return {"model": fitted, "rows": rows, "card": card_line(dev),
            "sweep_s": sweep_s, "total_s": time.perf_counter() - t0}


def _pair(p) -> str:
    return f"({p[0]}, {p[1]})"


def report(result: dict, out: str) -> str:
    """The per-matrix table (markdown) and the fitted constants."""
    rows = result["rows"]
    lines = [
        f"# card: {result['card']}",
        "| id | matrix | scale | rows | nnz | rdensity | optimum | ms | within 2% | "
        "fit from | fitted pick | ms | table on it (> 8) | ms | A100 pick | ms | library ms |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        t = r["times"]
        table = r.get("table_pick")
        lines.append(
            f"| {r['id']} | {r['name']} | {r['scale']} | {r['m']} | {r['nnz']} | "
            f"{r['rdensity']:.3f} | {_pair(r['opt'])} | {r['opt_ms']:.4f} | "
            f"{' '.join(_pair(p) for p in r['near'])} | {_pair(representative(r))} | "
            f"{_pair(r['fitted_pick'])} | {t[r['fitted_pick']]:.4f} | "
            f"{'' if table is None else _pair(table)} | "
            f"{'' if table is None else f'{t[table]:.4f}'} | {_pair(r['ampere'])} | "
            f"{t[r['ampere']]:.4f} | {r['library_ms']:.4f} |")
    for r in rows:
        grid = " ".join(f"{a}x{b}:{r['times'][(a, b)]:.4f}" for a, b in r["candidates"])
        lines.append(f"# grid {r['name']} (band-k and build {r['host_s']:.1f} s): {grid}")
    (name, m), = result["model"].items()
    lines += [
        f"SSRS = round({m['ssrs'][0]:.3f} - {m['ssrs'][1]:.3f} * ln(rdensity))",
        f"SRS  = round({m['srs'][0]:.3f} - {m['srs'][1]:.3f} * ln(rdensity))",
        f"# {name}: fitted over every matrix's optimum; sweep {result['sweep_s']:.1f} s, "
        f"all {result['total_s']:.1f} s",
        f"# wrote {out}; activate with REPRO_DEVICE_MODEL={out}",
    ]
    return "\n".join(lines)


def _scale_for(text: str) -> dict:
    out = {}
    for item in filter(None, text.split(",")):
        i, s = item.split(":")
        out[int(i)] = int(s)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help=f"the {len(QUICK_IDS)}-matrix subset {QUICK_IDS}")
    ap.add_argument("--scale", type=int, default=1024,
                    help="suite down-scale divisor (paper N / scale)")
    ap.add_argument("--scale-for", type=_scale_for, default={},
                    help="per-id scales overriding --scale, e.g. 4:4,3:2")
    ap.add_argument("--ids", type=lambda s: tuple(int(v) for v in s.split(",")), default=None,
                    help="suite ids to sweep (default: all, or the --quick subset)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="worker processes for the host side (build, Band-k)")
    ap.add_argument("--out", default="device_model.json")
    ap.add_argument("--name", default="h100",
                    help="device entry name in the JSON / DEVICES table")
    ap.add_argument("--device", default="cuda", help='"cuda" (default) or "cpu"')
    args = ap.parse_args(argv)
    result = run(scale=args.scale, quick=args.quick, out=args.out, name=args.name,
                 ids=args.ids, device=args.device, scale_for=args.scale_for, jobs=args.jobs)
    print(report(result, args.out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
