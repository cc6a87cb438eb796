"""Synthetic analogue of the paper's Table 2 SuiteSparse test suite.

Port of ``repro.configs.spmv_suite``: the same numpy-seeded generators, so
every matrix is identical to the reference's, held in the port's CSR.

Each Table 2 matrix is replaced by a synthetic generator matched on problem *family*, N, NNZ and rdensity (DESIGN
§7.4).  Sizes are scaled down by ``scale`` (default 1/64 of the paper's N) so
the full suite runs in CI; the generators are size-parametric so the paper's
exact N can be requested.

Families:
  * road / DIMACS graph  → random near-planar low-degree graphs
  * 2D/3D PDE            → 5-point / 7-point grid Laplacians
  * circuit              → grid Laplacian + random long-range couplings
  * thermal/optimization → 9-point Laplacian variants
  * structural FEM       → block-dense Laplacians (bmwcra-style dense rows)

On top of the Table 2 analogue, :data:`ADVERSARIAL` holds two stress
families that deliberately defeat the row-balanced formats (power-law hub
rows with empty rows; a mostly-diagonal stencil with a low-occupancy
fringe).  They are intentionally *not* part of :data:`SUITE` — the suite's
routing decisions are pinned by tests — and load via
:func:`load_adversarial`.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List

import numpy as np
import torch

from repro_torch.sparse.coo import COOMatrix
from repro_torch.sparse.csr import CSRMatrix, csr_from_coo


def _coo(r, c, v, shape) -> COOMatrix:
    """COO with int32 indices and float32 values, as the reference builds."""
    return COOMatrix(
        torch.from_numpy(np.asarray(r, np.int32)),
        torch.from_numpy(np.asarray(c, np.int32)),
        torch.from_numpy(np.asarray(v, np.float32)),
        tuple(shape),
    )


def _sym_coo(n: int, r: np.ndarray, c: np.ndarray, v: np.ndarray) -> CSRMatrix:
    """Symmetrise, dedupe, add unit diagonal, return CSR."""
    r2 = np.concatenate([r, c, np.arange(n)])
    c2 = np.concatenate([c, r, np.arange(n)])
    v2 = np.concatenate([v, v, np.full(n, 4.0)])
    key = r2.astype(np.int64) * n + c2
    _, idx = np.unique(key, return_index=True)
    return csr_from_coo(
        _coo(r2[idx], c2[idx], v2[idx], (n, n))
    )


def grid_laplacian_2d(nx: int, ny: int, stencil: int = 5) -> CSRMatrix:
    """5- or 9-point 2D grid Laplacian (ecology/thermal/optimization family)."""
    n = nx * ny
    idx = np.arange(n).reshape(nx, ny)
    rows, cols = [], []

    def link(a, b):
        rows.append(a.reshape(-1))
        cols.append(b.reshape(-1))

    link(idx[:-1, :], idx[1:, :])
    link(idx[:, :-1], idx[:, 1:])
    if stencil == 9:
        link(idx[:-1, :-1], idx[1:, 1:])
        link(idx[:-1, 1:], idx[1:, :-1])
    r = np.concatenate(rows)
    c = np.concatenate(cols)
    return _sym_coo(n, r, c, -np.ones(len(r)))


def grid_laplacian_3d(nx: int, ny: int, nz: int) -> CSRMatrix:
    """7-point 3D Laplacian (2D/3D problem family: brack2/wave)."""
    n = nx * ny * nz
    idx = np.arange(n).reshape(nx, ny, nz)
    rows, cols = [], []
    rows.append(idx[:-1].reshape(-1)); cols.append(idx[1:].reshape(-1))
    rows.append(idx[:, :-1].reshape(-1)); cols.append(idx[:, 1:].reshape(-1))
    rows.append(idx[:, :, :-1].reshape(-1)); cols.append(idx[:, :, 1:].reshape(-1))
    r = np.concatenate(rows)
    c = np.concatenate(cols)
    return _sym_coo(n, r, c, -np.ones(len(r)))


def road_graph(n: int, seed: int = 0) -> CSRMatrix:
    """Low-degree near-planar graph (roadNet/hugetrace/DIMACS family).

    Nodes on a random 2D point cloud, each linked to ~3 nearest neighbours by
    grid bucketing — degree ≈ 2.7–3, like the paper's road networks.
    """
    rng = np.random.default_rng(seed)
    side = int(np.sqrt(n))
    pts = rng.random((n, 2))
    cell = np.minimum((pts * side).astype(np.int64), side - 1)
    order = np.lexsort((cell[:, 1], cell[:, 0]))
    rows, cols = [], []
    # link consecutive nodes in the space-filling order + a few skips
    rows.append(order[:-1]); cols.append(order[1:])
    skip = rng.permutation(n)
    rows.append(skip[: n // 2 - 1]); cols.append(skip[1 : n // 2])
    r = np.concatenate(rows)
    c = np.concatenate(cols)
    mask = r != c
    return _sym_coo(n, r[mask], c[mask], -np.ones(mask.sum()))


def circuit_graph(n: int, seed: int = 1) -> CSRMatrix:
    """Grid + sparse random long-range couplings (G3_circuit family)."""
    side = int(np.sqrt(n))
    base = grid_laplacian_2d(side, side)
    rng = np.random.default_rng(seed)
    extra = side * side // 10
    r = rng.integers(0, side * side, extra)
    c = rng.integers(0, side * side, extra)
    rp = base.row_ptr.numpy()
    ci = base.col_idx.numpy()
    vl = base.vals.numpy()
    rows0 = np.repeat(np.arange(base.m), rp[1:] - rp[:-1])
    mask = r != c
    r2 = np.concatenate([rows0, r[mask], c[mask]])
    c2 = np.concatenate([ci, c[mask], r[mask]])
    v2 = np.concatenate([vl, -np.ones(mask.sum()), -np.ones(mask.sum())])
    key = r2.astype(np.int64) * base.m + c2
    _, idx = np.unique(key, return_index=True)
    return csr_from_coo(
        _coo(r2[idx], c2[idx], v2[idx], base.shape)
    )


def fem_block(n_nodes: int, block: int = 12, seed: int = 2) -> CSRMatrix:
    """Structural-FEM-like matrix with dense node blocks (Emilia/bmwcra family).

    ``block`` coupled DOFs per node → dense block rows, high rdensity.
    """
    rng = np.random.default_rng(seed)
    mesh = grid_laplacian_2d(int(np.sqrt(n_nodes)), int(np.sqrt(n_nodes)))
    rp = mesh.row_ptr.numpy()
    ci = mesh.col_idx.numpy()
    nn = mesh.m
    rows0 = np.repeat(np.arange(nn), rp[1:] - rp[:-1])
    # expand each node-edge into a block×block dense coupling
    bi = np.arange(block)
    br = rows0[:, None, None] * block + bi[None, :, None]   # [nnz, block, 1]
    bc = ci[:, None, None] * block + bi[None, None, :]      # [nnz, 1, block]
    br, bc = np.broadcast_arrays(br, bc)
    br, bc = br.reshape(-1), bc.reshape(-1)
    bv = rng.standard_normal(len(br)) * 0.01
    n = nn * block
    key = br.astype(np.int64) * n + bc
    _, idx = np.unique(key, return_index=True)
    diag_boost = np.zeros(0)
    return csr_from_coo(
        _coo(br[idx], bc[idx],
             np.where(br[idx] == bc[idx], 8.0 + np.abs(bv[idx]), bv[idx]), (n, n))
    )


@dataclasses.dataclass(frozen=True)
class SuiteEntry:
    id: int
    name: str
    paper_n: int
    paper_nnz: int
    paper_rdensity: float
    family: str
    build: Callable[[int], CSRMatrix]


def _scaled(n_paper: int, scale: int) -> int:
    return max(n_paper // scale, 1024)


SUITE: List[SuiteEntry] = [
    SuiteEntry(1, "roadNet-TX", 1_393_383, 3_843_320, 2.76, "graph",
               lambda s: road_graph(_scaled(1_393_383, s), seed=1)),
    SuiteEntry(2, "hugetrace-00000", 4_588_484, 13_758_266, 2.99, "graph",
               lambda s: road_graph(_scaled(4_588_484, s), seed=2)),
    SuiteEntry(3, "hugetric-00000", 5_824_554, 17_467_046, 2.99, "graph",
               lambda s: road_graph(_scaled(5_824_554, s), seed=3)),
    SuiteEntry(4, "hugebubbles-00000", 18_318_143, 54_940_162, 2.99, "graph",
               lambda s: road_graph(_scaled(18_318_143, s), seed=4)),
    SuiteEntry(5, "wi2010", 253_096, 1_209_404, 4.77, "graph",
               lambda s: circuit_graph(_scaled(253_096, s), seed=5)),
    SuiteEntry(6, "G3_circuit", 1_585_478, 7_660_826, 4.83, "circuit",
               lambda s: circuit_graph(_scaled(1_585_478, s), seed=6)),
    SuiteEntry(7, "fl2010", 484_481, 2_346_294, 4.84, "graph",
               lambda s: circuit_graph(_scaled(484_481, s), seed=7)),
    SuiteEntry(8, "ecology1", 1_000_000, 4_996_000, 4.99, "2d_pde",
               lambda s: grid_laplacian_2d(*(2 * [int(np.sqrt(_scaled(1_000_000, s)))]))),
    SuiteEntry(9, "cont-300", 180_895, 988_195, 5.46, "optimization",
               lambda s: grid_laplacian_2d(*(2 * [int(np.sqrt(_scaled(180_895, s)))]))),
    SuiteEntry(10, "delaunay_n20", 1_048_576, 6_291_372, 6.00, "graph",
               lambda s: grid_laplacian_2d(
                   int(np.sqrt(_scaled(1_048_576, s))), int(np.sqrt(_scaled(1_048_576, s))), stencil=9)),
    SuiteEntry(11, "thermal2", 1_228_045, 8_580_313, 6.98, "thermal",
               lambda s: grid_laplacian_2d(
                   int(np.sqrt(_scaled(1_228_045, s))), int(np.sqrt(_scaled(1_228_045, s))), stencil=9)),
    SuiteEntry(12, "brack2", 62_631, 733_118, 11.71, "3d_pde",
               lambda s: grid_laplacian_3d(*(3 * [max(int(round(_scaled(62_631, s) ** (1 / 3))), 8)]))),
    SuiteEntry(13, "wave", 156_317, 2_118_662, 13.55, "3d_pde",
               lambda s: grid_laplacian_3d(*(3 * [max(int(round(_scaled(156_317, s) ** (1 / 3))), 8)]))),
    SuiteEntry(14, "packing-500x100x100", 2_145_852, 34_976_486, 16.30, "3d_pde",
               lambda s: fem_block(_scaled(2_145_852, s) // 4, block=4, seed=14)),
    SuiteEntry(15, "Emilia_923", 923_136, 40_373_538, 43.74, "structural",
               lambda s: fem_block(_scaled(923_136, s) // 9, block=9, seed=15)),
    SuiteEntry(16, "bmwcra_1", 148_770, 10_641_602, 71.53, "structural",
               lambda s: fem_block(_scaled(148_770, s) // 16, block=16, seed=16)),
]


def load_suite(scale: int = 64, ids: List[int] | None = None) -> Dict[str, CSRMatrix]:
    out = {}
    for e in SUITE:
        if ids is not None and e.id not in ids:
            continue
        out[e.name] = e.build(scale)
    return out


# ---------------------------------------------------------------------------
# Adversarial stress families (NOT part of SUITE — see module docstring)
# ---------------------------------------------------------------------------

def powerlaw_zipf(
    n: int,
    seed: int = 17,
    alpha: float = 1.6,
    empty_fraction: float = 0.1,
) -> CSRMatrix:
    """Power-law (Zipf) row lengths with empty rows (web/social-graph family).

    The adversary for row-balanced formats: a few hub rows hold most of the
    nnz (``row_skew`` far above ``SEGSUM_ROW_SKEW_MIN``) while ~10% of rows
    are empty, so any per-row padding scheme (ELL / SELL-C-σ) burns slots on
    the hubs.  Routes to the segmented-sum backend, which partitions *nnz*
    instead of rows.
    """
    rng = np.random.default_rng(seed)
    lengths = np.minimum(rng.zipf(alpha, n), n // 4).astype(np.int64)
    lengths[rng.random(n) < empty_fraction] = 0
    # guarantee one hub row, so the skew is structural rather than sampled
    lengths[rng.integers(0, n)] = n // 4
    rows = np.repeat(np.arange(n), lengths)
    cols = rng.integers(0, n, rows.shape[0])
    key = rows.astype(np.int64) * n + cols
    _, idx = np.unique(key, return_index=True)
    return csr_from_coo(
        _coo(rows[idx], cols[idx],
             rng.standard_normal(len(idx)).astype(np.float32), (n, n))
    )


def pareto_rows(m: int, seed: int = 0) -> CSRMatrix:
    """Square matrix with Pareto row lengths and some empty rows.

    The irregular case the SELL-C-σ tests of the reference draw
    (``tests/test_sparse_registry.py::powerlaw_csr``): row i holds
    ``min(⌊4·pareto(1) + 1⌋, m)`` distinct random columns with normal
    values; on top of that about 10% of the rows are empty.
    Port-only: the kernel checks of ``chip_smoke.py`` use it with an m that
    is not a multiple of the chunk height.
    """
    rng = np.random.default_rng(seed)
    lengths = np.minimum((rng.pareto(1.0, m) * 4 + 1).astype(int), m)
    lengths[rng.random(m) < 0.1] = 0
    rows = np.repeat(np.arange(m), lengths)
    cols = np.concatenate(
        [rng.choice(m, size=L, replace=False) for L in lengths] + [np.zeros(0, int)]
    )
    vals = rng.standard_normal(rows.shape[0]).astype(np.float32)
    return csr_from_coo(_coo(rows, cols, vals, (m, m)))


def empty_margin_rows(m: int, seed: int = 0) -> CSRMatrix:
    """Square matrix whose first and last ``m // 16`` rows are empty.

    The rows between draw their lengths from ``{0, 1, 3, m // 2, m − 8}``
    (distinct random columns, normal values), so with 128-slot chunks some
    rows span several chunks and some chunks hold many short rows.
    Port-only: the segmented-sum kernel checks of ``chip_smoke.py`` and
    ``tests/test_torch_cuda.py`` use it for the rows no chunk covers.
    """
    rng = np.random.default_rng(seed)
    lengths = rng.choice(np.array([0, 1, 3, m // 2, m - 8]), size=m)
    lengths[: m // 16] = 0
    lengths[m - m // 16:] = 0
    rows = np.repeat(np.arange(m), lengths)
    cols = np.concatenate(
        [rng.choice(m, size=L, replace=False) for L in lengths] + [np.zeros(0, int)]
    )
    vals = rng.standard_normal(rows.shape[0]).astype(np.float32)
    return csr_from_coo(_coo(rows, cols, vals, (m, m)))


def three_chunk_matrix() -> CSRMatrix:
    """4×512: row 0 holds 300 ones and spans three 128-slot chunks, row 1 is
    empty, rows 2 and 3 are short.  With ``x = arange(512) % 7 + 1`` the
    product is exactly ``[1197, 0, 14, 17]`` (the reference's hand-computed
    carry case, ``tests/test_irregular_formats.py:63``)."""
    dense = np.zeros((4, 512), np.float32)
    dense[0, :300] = 1.0
    dense[2, 10], dense[2, 400] = 2.0, 3.0
    dense[3, [0, 100, 200, 300, 511]] = 1.0
    return CSRMatrix.fromdense(dense)


def long_row_matrix(length: int = 5000) -> CSRMatrix:
    """8×(length + 64) of ones: row 1 holds ``length`` entries, so with
    128-slot chunks it spans more than 32 chunks (more fragments than a warp
    has lanes); rows 2 and 7 are empty, the others short.  Every product
    with small integer x is exact in float32, so a kernel must match it bit
    for bit.  Port-only, like :func:`empty_margin_rows`."""
    lengths = np.array([20, length, 0, 3, 300, 1, 64, 0])
    n = length + 64
    rows = np.repeat(np.arange(8), lengths)
    cols = np.concatenate([np.arange(L) * 7 % n for L in lengths])
    return csr_from_coo(_coo(rows, cols, np.ones(rows.shape[0], np.float32), (8, n)))


def dia_hand_matrix() -> CSRMatrix:
    """8×8 with integer values: diagonals −2 (ones), 0 (twos) and +2 (threes),
    which fill 6/8, 8/8 and 6/8 of their rows, and one entry 5 at (0, 7).
    At occupancy 0.7 the three diagonals form the DIA plane and (0, 7) is
    the remainder; every product with small integer x is exact in float32
    (the reference's hand case, ``tests/test_irregular_formats.py:119``)."""
    m = 8
    dense = np.zeros((m, m), np.float32)
    np.fill_diagonal(dense, 2.0)
    dense[np.arange(2, m), np.arange(m - 2)] = 1.0
    dense[np.arange(m - 2), np.arange(2, m)] = 3.0
    dense[0, 7] = 5.0
    return CSRMatrix.fromdense(dense)


def dia_rectangular_matrix(seed: int = 7) -> CSRMatrix:
    """130×200: seeded normal values on diagonals 0 and +40, and ones at
    columns 0 and 199 of row 5, which stay in the DIA remainder (the shape of
    the reference's ``tests/test_irregular_formats.py:217``)."""
    rng = np.random.default_rng(seed)
    dense = np.zeros((130, 200), np.float32)
    dense[np.arange(130), np.arange(130)] = rng.standard_normal(130)
    dense[np.arange(130), np.arange(130) + 40] = rng.standard_normal(130)
    dense[5, [0, 199]] = 1.0
    return CSRMatrix.fromdense(dense)


def no_dense_diagonal_matrix() -> CSRMatrix:
    """16×16 with nine entries and no dense diagonal: the whole matrix is a
    DIA remainder.  Port-only, like :func:`long_row_matrix`."""
    dense = np.zeros((16, 16), np.float32)
    dense[0, :7] = 1.0
    dense[9, [3, 15]] = [-2.0, 4.0]
    return CSRMatrix.fromdense(dense)


def dia_fringe_matrix(
    m: int,
    lengths: Dict[int, int] | None = None,
    every_row: int = 0,
    band: int | None = 1,
    seed: int = 0,
) -> CSRMatrix:
    """m×m with seeded normal values: a dense band of diagonals −``band`` to
    +``band`` (none for ``band=None``), and remainder rows.

    Row i of ``lengths`` holds ``lengths[i]`` entries at distinct random
    columns off the band; with ``every_row`` > 0 every other row holds 1 to
    ``every_row`` of them.  Port-only: the DIA kernel's row-list checks of
    ``tests/test_torch_*.py`` and ``chip_smoke.py`` use it for remainder rows
    of chosen lengths, rows at mask-word edges, every row listed, m not a
    multiple of 4, and many diagonals.  With ``band`` ≤ 0.05·m every band
    diagonal is dense (≥ 90% full).
    """
    rng = np.random.default_rng(seed)
    lengths = dict(lengths or {})
    if every_row:
        drawn = rng.integers(1, every_row + 1, size=m)
        lengths = {i: lengths.get(i, int(drawn[i])) for i in range(m)}
    dense = np.zeros((m, m), np.float32)
    half = -1 if band is None else band
    for off in range(-half, half + 1):
        rows = np.arange(max(0, -off), min(m, m - off))
        dense[rows, rows + off] = rng.standard_normal(rows.size)
    for i, k in sorted(lengths.items()):
        free = np.setdiff1d(np.arange(m), np.arange(i - max(half, 1), i + max(half, 1) + 1))
        dense[i, rng.choice(free, k, replace=False)] = rng.standard_normal(k)
    return CSRMatrix.fromdense(dense)


def ell_width_matrix(m: int, n: int, kmax: int, seed: int = 0) -> CSRMatrix:
    """m×n with rows of 0..``kmax`` distinct random columns and normal values.

    Row 0 holds exactly ``kmax`` entries (so the ELL slab is ``kmax`` wide),
    about 10% of the rows are empty, the rest draw their lengths uniformly.
    Port-only: the ELL kernel checks of ``chip_smoke.py`` and
    ``tests/test_torch_cuda.py`` use it with slab widths on both sides of a
    warp and an m that is not a multiple of any block size.
    """
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, kmax + 1, size=m)
    lengths[rng.random(m) < 0.1] = 0
    lengths[0] = kmax
    rows = np.repeat(np.arange(m), lengths)
    cols = np.concatenate(
        [np.sort(rng.choice(n, size=L, replace=False)) for L in lengths] + [np.zeros(0, int)]
    )
    vals = rng.standard_normal(rows.shape[0]).astype(np.float32)
    return csr_from_coo(_coo(rows, cols, vals, (m, n)))


def stencil_fringe(
    side: int = 64,
    seed: int = 18,
    fringe_fraction: float = 0.01,
    fringe_deg: int = 64,
) -> CSRMatrix:
    """9-point stencil plus a low-occupancy fringe (AMR/contact family).

    Almost all nnz sit on dense diagonals (``diag_fraction`` above
    ``DIA_FRACTION_MIN``), but ~1% of rows carry ``fringe_deg`` random
    long-range couplings — enough to push ``row_var`` past the regular
    ceiling, far too few to justify abandoning the diagonal structure.
    Routes to the DIA+CSR hybrid: diagonals stream through the DIA plane,
    the fringe rides the CSR remainder.
    """
    base = grid_laplacian_2d(side, side, stencil=9)
    n = base.m
    rng = np.random.default_rng(seed)
    rp = base.row_ptr.numpy()
    rows0 = np.repeat(np.arange(n), rp[1:] - rp[:-1])
    n_fringe = max(1, int(n * fringe_fraction))
    fr = np.repeat(rng.choice(n, n_fringe, replace=False), fringe_deg)
    fc = rng.integers(0, n, fr.shape[0])
    r2 = np.concatenate([rows0, fr])
    c2 = np.concatenate([base.col_idx.numpy(), fc])
    v2 = np.concatenate(
        [base.vals.numpy(), np.full(fr.shape[0], 0.01, np.float32)]
    )
    key = r2.astype(np.int64) * n + c2
    _, idx = np.unique(key, return_index=True)   # base values win over fringe
    return csr_from_coo(
        _coo(r2[idx], c2[idx], v2[idx], (n, n))
    )


ADVERSARIAL: Dict[str, Callable[[int], CSRMatrix]] = {
    "powerlaw_zipf": lambda s: powerlaw_zipf(max(262_144 // s, 2048)),
    "stencil_fringe": lambda s: stencil_fringe(
        max(int(np.sqrt(262_144 // s)), 64)
    ),
}


def load_adversarial(
    scale: int = 64, names: List[str] | None = None
) -> Dict[str, CSRMatrix]:
    """Build the adversarial families at ``scale`` (same knob as the suite)."""
    return {
        name: build(scale)
        for name, build in ADVERSARIAL.items()
        if names is None or name in names
    }
