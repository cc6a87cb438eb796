"""Constant-time tuning model for CSR-k (paper Sec. 4).

A verbatim copy of ``repro.core.tuner`` (pure numpy), so tuner outputs
compare field by field with the reference's — including the fall-through of
unknown device names to :func:`tune_tpu` in :func:`tune`.

The paper's method: calibrate once per device by sweeping
``(SSRS, SRS) ∈ (∪_{i=2..5} {2^i, 1.5·2^i})²`` over a representative matrix
suite, then fit a logarithmic regression ``size = ⌊a − b·ln(rdensity)⌉`` so
any future matrix is tuned in O(1) from its mean row density alone.  Density
"cases" then apply fixed correction factors (the paper lists Volta and Ampere
case tables).

We keep the paper's Volta/Ampere formulas verbatim (they are checked against
the paper in tests) and add a TPU-v5e device model whose cases are keyed on
the same rdensity thresholds but express 8×128 tile alignment instead of
warp-of-32 block shapes.  The TPU (a, b) constants are produced by
``benchmarks/tuning_model.py`` (sweep + log fit, same protocol).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import numpy as np


def round_half_up(x: float) -> int:
    """⌊x⌉ — round to nearest, half towards +inf (paper's ⌊·⌉)."""
    return int(math.floor(x + 0.5))


# sweep sets from the paper -------------------------------------------------

GPU_SWEEP = sorted({int(2**i) for i in range(2, 6)} | {int(1.5 * 2**i) for i in range(2, 6)})
# = {4, 6, 8, 12, 16, 24, 32, 48}
CPU_SRS_SWEEP = sorted({int(2**i) for i in range(3, 12)} | {int(1.5 * 2**i) for i in range(3, 12)})
# = {8, 12, ..., 2048, 3072}

CPU_FIXED_SRS = 96  # geometric-mean constant-time choice (paper Sec. 7, Fig. 11)


@dataclasses.dataclass(frozen=True)
class TuningParams:
    ssrs: int          # super-rows per super-super-row
    srs: int           # rows per super-row
    k: int             # hierarchy depth
    use_inner_parallel: bool  # GPUSpMV-3 vs -3.5 analogue (lane-dim reduction)
    gather_chunk: int = 512   # one-hot gather chunk width (128 multiple)

    @property
    def rows_per_ssr(self) -> int:
        return self.ssrs * self.srs


@dataclasses.dataclass(frozen=True)
class DeviceModel:
    """Fitted ⌊a − b·ln(rdensity)⌉ model plus density-case corrections.

    ``gather_chunk`` is the device's preferred one-hot gather chunk width —
    hand-set for the builtin models, measured by
    ``benchmarks/fit_device_model.py`` for fitted ones.
    """

    name: str
    ssrs_a: float
    ssrs_b: float
    srs_a: float
    srs_b: float
    gather_chunk: int = 512

    def base(self, rdensity: float) -> Tuple[int, int]:
        rd = max(rdensity, 1.0)
        ssrs = round_half_up(self.ssrs_a - self.ssrs_b * math.log(rd))
        srs = round_half_up(self.srs_a - self.srs_b * math.log(rd))
        return max(ssrs, 1), max(srs, 1)


VOLTA = DeviceModel("volta", ssrs_a=8.900, ssrs_b=1.25, srs_a=10.146, srs_b=1.50)
AMPERE = DeviceModel("ampere", ssrs_a=9.175, ssrs_b=1.32, srs_a=20.500, srs_b=3.50)
# TPU-v5e constants fitted by benchmarks/tuning_model.py (see EXPERIMENTS.md):
# the sweep optimises padded-tile efficiency (useful-slot fraction × occupancy)
# over the synthetic Table-2 suite.
TPU_V5E = DeviceModel("tpu_v5e", ssrs_a=9.0, ssrs_b=1.10, srs_a=12.0, srs_b=1.60)

DEVICES: Dict[str, DeviceModel] = {d.name: d for d in (VOLTA, AMPERE, TPU_V5E)}


# ---------------------------------------------------------------------------
# measured-model loading (the calibration loop closed: see
# benchmarks/fit_device_model.py and docs/tuning.md)
# ---------------------------------------------------------------------------

#: Installed fitted model for the TPU path; None → resolve from the
#: ``REPRO_DEVICE_MODEL`` env var once, falling back to hand-set TPU_V5E.
_ACTIVE_TPU_MODEL: DeviceModel | None = None
_ENV_RESOLVED = False


def load_fitted_device_model(
    path: str, name: str = "tpu_v5e"
) -> DeviceModel:
    """Load fitted ``(a, b)`` constants written by benchmarks/fit_device_model.py.

    The file maps device name → ``{"ssrs": [a, b], "srs": [a, b],
    "gather_chunk": g}``.  A missing/unreadable file or absent device entry
    falls back to the hand-set model in :data:`DEVICES` — the measured model
    is an accelerant, never a requirement (paper Sec. 4's portability).
    """
    import json
    import os

    fallback = DEVICES.get(name, TPU_V5E)
    if not path or not os.path.exists(path):
        return fallback
    try:
        with open(path) as fh:
            entry = json.load(fh).get(name)
        if entry is None:
            return fallback
        return DeviceModel(
            name=name,
            ssrs_a=float(entry["ssrs"][0]),
            ssrs_b=float(entry["ssrs"][1]),
            srs_a=float(entry["srs"][0]),
            srs_b=float(entry["srs"][1]),
            gather_chunk=int(entry.get("gather_chunk", fallback.gather_chunk)),
        )
    except (OSError, ValueError, KeyError, TypeError):
        return fallback


def use_device_model(model: DeviceModel | None) -> None:
    """Install a (fitted) model for :func:`tune_tpu`; None resets to the
    env-var / hand-set resolution."""
    global _ACTIVE_TPU_MODEL, _ENV_RESOLVED
    _ACTIVE_TPU_MODEL = model
    _ENV_RESOLVED = model is not None


def active_tpu_model() -> DeviceModel:
    """The model :func:`tune_tpu` currently runs on.

    Resolution order: :func:`use_device_model` install → the
    ``REPRO_DEVICE_MODEL`` env var (a fit_device_model.py JSON, read once)
    → the hand-set :data:`TPU_V5E`.
    """
    global _ACTIVE_TPU_MODEL, _ENV_RESOLVED
    if not _ENV_RESOLVED:
        import os

        env = os.environ.get("REPRO_DEVICE_MODEL", "")
        _ACTIVE_TPU_MODEL = load_fitted_device_model(env) if env else TPU_V5E
        _ENV_RESOLVED = True
    return _ACTIVE_TPU_MODEL or TPU_V5E


def tune_volta(rdensity: float) -> TuningParams:
    """Paper Sec. 4.1, Volta case table — verbatim."""
    ssrs, srs = VOLTA.base(rdensity)
    if rdensity <= 8:
        pass
    elif rdensity <= 16:
        ssrs = round_half_up(ssrs * 1.5)
        srs = srs * 2
    elif rdensity <= 32:
        ssrs = ssrs * 4
        srs = ssrs // 2
    else:
        ssrs = ssrs * 5
        srs = ssrs // 2
    return TuningParams(max(ssrs, 1), max(srs, 1), k=3, use_inner_parallel=rdensity >= 8)


def tune_ampere(rdensity: float) -> TuningParams:
    """Paper Sec. 4.1, Ampere case table — verbatim."""
    ssrs, srs = AMPERE.base(rdensity)
    if rdensity <= 8:
        pass
    elif rdensity <= 16:
        srs = srs * 4
    elif rdensity <= 32:
        ssrs = round_half_up(ssrs * 2.5)
        srs = ssrs * 3
    elif rdensity <= 64:
        ssrs = ssrs * 2
        srs = ssrs * 2
    else:
        ssrs = round_half_up(ssrs * 2.7)
        srs = round_half_up(ssrs / 4)
    return TuningParams(max(ssrs, 1), max(srs, 1), k=3, use_inner_parallel=rdensity >= 8)


def tune_cpu(
    rdensity: float,
    constant_time: bool = True,
    row_ptr: np.ndarray | None = None,
) -> TuningParams:
    """CPU uses CSR-2 (paper Sec. 4.2); constant-time choice is SRS=96.

    With ``constant_time=False`` the paper's per-matrix SRS sweep runs
    instead: each candidate in :data:`CPU_SRS_SWEEP` is scored by its total
    padded super-row slots (``num_SRs × max SR nnz`` — the load-imbalance
    proxy a work-stealing CPU schedule pays for) and the smallest-bytes
    candidate wins, ties going to the larger SRS (fewer, fatter tasks).
    This requires ``row_ptr``; omitting it raises, because silently falling
    back to the fixed constant would reintroduce the dead branch this
    signature replaces.
    """
    del rdensity
    if constant_time:
        return TuningParams(ssrs=1, srs=CPU_FIXED_SRS, k=2, use_inner_parallel=False)
    if row_ptr is None:
        raise ValueError("tune_cpu(constant_time=False) needs row_ptr for the SRS sweep")
    rp = np.asarray(row_ptr, np.int64)
    m = len(rp) - 1
    best_srs, best_cost = CPU_FIXED_SRS, None
    for srs in CPU_SRS_SWEEP:
        starts = np.arange(0, m, srs)
        ends = np.minimum(starts + srs, m)
        sr_nnz = rp[ends] - rp[starts]
        cost = int(len(starts) * sr_nnz.max(initial=1))
        if best_cost is None or cost < best_cost or (cost == best_cost and srs > best_srs):
            best_srs, best_cost = srs, cost
    return TuningParams(ssrs=1, srs=best_srs, k=2, use_inner_parallel=False)


def tune_tpu(rdensity: float, m: int | None = None) -> TuningParams:
    """TPU-v5e tuning (this work, DESIGN §2).

    Same functional form as the paper; cases express tile alignment:
      * rows_per_ssr (= SSRS·SRS, the Pallas tile height) must be a multiple
        of 8 (sublane count) — the analogue of warp-multiples-of-32;
      * intra-row lane parallelism (GPUSpMV-3.5 analogue) turns on at the
        paper's experimentally-determined rdensity ≥ 8 threshold;
      * denser matrices → shorter tiles (fewer rows) but the tile's nnz slot
        count stays near a multiple of 128 (lane count).

    Runs on :func:`active_tpu_model` — the hand-set :data:`TPU_V5E` constants
    unless a fitted model (benchmarks/fit_device_model.py) was installed via
    :func:`use_device_model` or the ``REPRO_DEVICE_MODEL`` env var.
    """
    model = active_tpu_model()
    ssrs, srs = model.base(rdensity)
    if rdensity <= 8:
        pass
    elif rdensity <= 16:
        srs = srs * 2
    elif rdensity <= 32:
        ssrs = round_half_up(ssrs * 1.5)
    elif rdensity <= 64:
        ssrs = max(ssrs // 2, 1)
        srs = srs * 2
    else:
        ssrs = max(ssrs // 2, 1)
        srs = max(srs // 2, 1)
    ssrs, srs = max(ssrs, 1), max(srs, 1)
    # alignment case: grow SRS to the smallest multiple making 8 | SSRS·SRS
    # (sublane alignment — the warp-multiple-of-32 analogue)
    g = math.gcd(ssrs, 8)
    step = 8 // g
    srs = -(-srs // step) * step
    # cap tile height for tiny matrices so the grid keeps >= 8 steps
    if m is not None and m > 0:
        max_rows = max(8, (m // 8) // 8 * 8) if m >= 64 else max(m, 1)
        while ssrs * srs > max_rows and ssrs > 1:
            ssrs -= 1
        if ssrs * srs > max_rows:
            srs = max(max_rows, 1)
    return TuningParams(ssrs, srs, k=3, use_inner_parallel=rdensity >= 8,
                        gather_chunk=model.gather_chunk)


def tune(rdensity: float, device: str = "tpu_v5e", m: int | None = None) -> TuningParams:
    if device == "volta":
        return tune_volta(rdensity)
    if device == "ampere":
        return tune_ampere(rdensity)
    if device in ("cpu", "rome", "icelake"):
        return tune_cpu(rdensity)
    return tune_tpu(rdensity, m=m)


# ---------------------------------------------------------------------------
# beyond-paper: variance-aware tuning (EXPERIMENTS §Perf, paper-core cell)
# ---------------------------------------------------------------------------


def tile_bytes_model(
    row_ptr: np.ndarray,
    col_min: np.ndarray,
    col_max: np.ndarray,
    rows_per_tile: int,
) -> Tuple[int, float]:
    """Model the CSR-k kernel's HBM traffic for a given tile height.

    Per tile the kernel moves: ``slots`` nnz slots × (4B vals + 4B col + 4B
    row) + the 2-block x-window (2·W × 4B) + the y rows (4B each), where
    ``slots`` and ``W`` are the *max* tile nnz / column span rounded up to 128
    (static BlockSpecs pad every tile to the worst one).  Returns
    (modeled_bytes, efficiency = useful nnz bytes / modeled bytes).

    O(num_tiles) given per-row column extents — cheap enough to run inside
    the constant-time tuner without violating its spirit (one pass over
    ``row_ptr``, no SpMV executions).
    """
    m = len(row_ptr) - 1
    rows_per_tile = max(int(rows_per_tile), 1)
    starts = np.arange(0, m, rows_per_tile)
    ends = np.minimum(starts + rows_per_tile, m)
    nnz_t = row_ptr[ends] - row_ptr[starts]
    span_t = np.asarray([
        (col_max[s:e].max() - col_min[s:e].min() + 1) if e > s else 1
        for s, e in zip(starts, ends)
    ])
    rnd = lambda v: -(-int(v) // 128) * 128
    slots = rnd(nnz_t.max(initial=1))
    W = rnd(span_t.max(initial=1))
    T = len(starts)
    total = T * (slots * 12 + 2 * W * 4 + rows_per_tile * 4)
    useful = int(row_ptr[-1]) * 12
    return total, useful / max(total, 1)


def row_col_extents(
    row_ptr: np.ndarray, col_idx: np.ndarray, m: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-row min/max column, vectorized (one ``reduceat`` pass, no Python
    loop over rows).  Empty rows get extent 0/0, matching the historical
    per-row loop this replaces (pinned in tests/test_ordering_tuner.py).

    ``reduceat`` over the *non-empty* row starts is correct because between
    two consecutive non-empty starts there are only that row's elements —
    empty rows contribute no slice boundaries.
    """
    rp = np.asarray(row_ptr, np.int64)
    ci = np.asarray(col_idx, np.int64)
    col_min = np.zeros(m, np.int64)
    col_max = np.zeros(m, np.int64)
    lengths = rp[1:] - rp[:-1]
    ne = np.flatnonzero(lengths[:m] > 0)
    if len(ne):
        starts = rp[:-1][ne]
        col_min[ne] = np.minimum.reduceat(ci, starts)
        col_max[ne] = np.maximum.reduceat(ci, starts)
    return col_min, col_max


def tune_tpu_adaptive(
    row_ptr: np.ndarray,
    col_idx: np.ndarray,
    rdensity: float,
    m: int,
) -> TuningParams:
    """Variance-aware TPU tuning: seed with the paper's O(1) formula, then
    pick the (SSRS, SRS) from the paper's candidate sweep minimising the
    modeled kernel bytes.  One cheap pass per candidate (16 candidates of
    distinct tile heights) — still effectively constant-time for large m.
    """
    # per-row column extents (one vectorized pass, shared by all candidates)
    col_min, col_max = row_col_extents(row_ptr, col_idx, m)

    seed = tune_tpu(rdensity, m=m)
    best = (seed, tile_bytes_model(row_ptr, col_min, col_max, seed.rows_per_ssr)[0])
    heights = sorted({
        -(-(s1 * s2) // 8) * 8
        for s1 in GPU_SWEEP for s2 in GPU_SWEEP
        if s1 * s2 <= max(m // 8, 8)
    })
    for h in heights:
        total, _ = tile_bytes_model(row_ptr, col_min, col_max, h)
        if total < best[1]:
            ssrs = max(min(8, h // 8), 1)
            best = (
                TuningParams(ssrs, -(-h // ssrs), k=3,
                             use_inner_parallel=rdensity >= 8,
                             gather_chunk=seed.gather_chunk),
                total,
            )
    return best[0]


# ---------------------------------------------------------------------------
# model fitting (the calibration half of Sec. 4)
# ---------------------------------------------------------------------------


def fit_log_model(rdensities: np.ndarray, optimal_sizes: np.ndarray) -> Tuple[float, float]:
    """Least-squares fit of ``size ≈ a − b·ln(rdensity)`` (paper Sec. 4.1).

    Returns ``(a, b)``. The paper then lowers ``b`` by hand so the formula does
    not collapse for large rdensity; callers may clamp similarly.
    """
    x = np.log(np.maximum(np.asarray(rdensities, float), 1.0))
    y = np.asarray(optimal_sizes, float)
    A = np.stack([np.ones_like(x), -x], axis=1)
    coef, *_ = np.linalg.lstsq(A, y, rcond=None)
    return float(coef[0]), float(coef[1])
