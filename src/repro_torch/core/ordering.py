"""Band-k ordering (paper Listing 2) and the RCM baseline.

A verbatim copy of ``repro.core.ordering`` (pure numpy), so the port's
permutation is identical to the reference's; only the CSR import differs.

The paper's Band-k: convert the matrix to a graph, coarsen it k-1 times
(heavy-edge matching), reorder every level with a *weighted* bandwidth-limiting
ordering (a Cuthill–McKee variant that accounts for node weights), then expand
back down, reordering each coarse node's children locally.  The resulting
permutation is band-limiting like RCM but aligned with the SR/SSR hierarchy.

This is a setup-phase, host-side computation in the paper (and in every CSR-k
implementation), so it is plain numpy here; the output permutation is applied
once and the reordered matrix flows to the kernel execution path.

The banding bounds each SSR's column span, which sizes the tile view's
x-window and keeps the COO remainder empty.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from repro_torch.sparse.csr import CSRMatrix


# ---------------------------------------------------------------------------
# graph utilities
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Graph:
    """Symmetric adjacency in CSR form with node/edge weights."""

    adj_ptr: np.ndarray   # [n+1]
    adj_idx: np.ndarray   # [m]
    edge_w: np.ndarray    # [m]
    node_w: np.ndarray    # [n]

    @property
    def n(self) -> int:
        return len(self.node_w)

    def degree(self, v: int) -> int:
        return int(self.adj_ptr[v + 1] - self.adj_ptr[v])

    def neighbors(self, v: int) -> np.ndarray:
        return self.adj_idx[self.adj_ptr[v] : self.adj_ptr[v + 1]]


def graph_from_csr(csr: CSRMatrix) -> Graph:
    """Symmetrised pattern graph of A (diagonal dropped)."""
    m, n = csr.shape
    size = max(m, n)
    rp = np.asarray(csr.row_ptr)
    ci = np.asarray(csr.col_idx)
    rows = np.repeat(np.arange(m), rp[1:] - rp[:-1])
    mask = rows != ci
    r = np.concatenate([rows[mask], ci[mask]])
    c = np.concatenate([ci[mask], rows[mask]])
    # dedupe
    key = r.astype(np.int64) * size + c
    key, uniq = np.unique(key, return_index=True)
    r, c = r[uniq], c[uniq]
    order = np.lexsort((c, r))
    r, c = r[order], c[order]
    adj_ptr = np.zeros(size + 1, np.int64)
    np.add.at(adj_ptr, r + 1, 1)
    np.cumsum(adj_ptr, out=adj_ptr)
    return Graph(adj_ptr, c.astype(np.int64), np.ones(len(c)), np.ones(size))


# ---------------------------------------------------------------------------
# weighted Cuthill–McKee
# ---------------------------------------------------------------------------


def _pseudo_peripheral(g: Graph, component: np.ndarray) -> int:
    """George–Liu pseudo-peripheral node finder restricted to a component."""
    v = int(component[np.argmin([g.degree(u) for u in component])])
    last_ecc = -1
    for _ in range(8):
        levels = _bfs_levels(g, v)
        ecc = int(levels[component].max())
        if ecc <= last_ecc:
            break
        last_ecc = ecc
        far = component[levels[component] == ecc]
        v = int(far[np.argmin([g.degree(u) for u in far])])
    return v


def _bfs_levels(g: Graph, start: int) -> np.ndarray:
    levels = np.full(g.n, -1, np.int64)
    levels[start] = 0
    frontier = [start]
    d = 0
    while frontier:
        d += 1
        nxt = []
        for u in frontier:
            for w in g.neighbors(u):
                if levels[w] < 0:
                    levels[w] = d
                    nxt.append(int(w))
        frontier = nxt
    return levels


def weighted_cm(g: Graph, reverse: bool = True) -> np.ndarray:
    """(Reverse) Cuthill–McKee with node-weight-aware tie-breaking.

    Neighbour visit order is by (weighted degree, node weight): heavier coarse
    nodes are placed later so their expansions stay contiguous — the
    "weighted bandwidth limiting ordering" of Listing 2.
    """
    n = g.n
    visited = np.zeros(n, bool)
    order: List[int] = []
    # weighted degree = sum of incident edge weights
    wdeg = np.zeros(n)
    for v in range(n):
        s, e = g.adj_ptr[v], g.adj_ptr[v + 1]
        wdeg[v] = g.edge_w[s:e].sum()
    for comp_start in range(n):
        if visited[comp_start]:
            continue
        component = _component_of(g, comp_start, visited)
        start = _pseudo_peripheral(g, component)
        visited[start] = True
        queue = [start]
        qi = 0
        while qi < len(queue):
            u = queue[qi]
            qi += 1
            order.append(u)
            nbrs = [int(w) for w in g.neighbors(u) if not visited[w]]
            nbrs.sort(key=lambda w: (wdeg[w], g.node_w[w]))
            for w in nbrs:
                visited[w] = True
                queue.append(w)
    perm = np.asarray(order, np.int64)
    if reverse:
        perm = perm[::-1].copy()
    return perm


def _component_of(g: Graph, start: int, visited: np.ndarray) -> np.ndarray:
    seen = {start}
    frontier = [start]
    while frontier:
        nxt = []
        for u in frontier:
            for w in g.neighbors(u):
                w = int(w)
                if w not in seen and not visited[w]:
                    seen.add(w)
                    nxt.append(w)
        frontier = nxt
    return np.asarray(sorted(seen), np.int64)


def rcm(csr: CSRMatrix) -> np.ndarray:
    """Plain RCM (the baseline ordering fed to competitors in the paper)."""
    return weighted_cm(graph_from_csr(csr), reverse=True)


# ---------------------------------------------------------------------------
# coarsening (heavy-edge matching)
# ---------------------------------------------------------------------------


def coarsen(g: Graph) -> Tuple[Graph, np.ndarray]:
    """One level of heavy-edge-matching coarsening.

    Returns the coarse graph and ``fine2coarse`` mapping.
    """
    n = g.n
    match = np.full(n, -1, np.int64)
    # visit nodes in increasing degree: small-degree nodes match first
    for v in np.argsort([g.degree(u) for u in range(n)]):
        v = int(v)
        if match[v] >= 0:
            continue
        best, best_w = -1, -1.0
        s, e = g.adj_ptr[v], g.adj_ptr[v + 1]
        for w, ew in zip(g.adj_idx[s:e], g.edge_w[s:e]):
            w = int(w)
            if match[w] < 0 and w != v and ew > best_w:
                best, best_w = w, float(ew)
        if best >= 0:
            match[v] = best
            match[best] = v
        else:
            match[v] = v
    fine2coarse = np.full(n, -1, np.int64)
    nc = 0
    for v in range(n):
        if fine2coarse[v] >= 0:
            continue
        fine2coarse[v] = nc
        if match[v] != v:
            fine2coarse[match[v]] = nc
        nc += 1
    # build coarse graph
    edges = {}
    node_w = np.zeros(nc)
    for v in range(n):
        node_w[fine2coarse[v]] += g.node_w[v]
        s, e = g.adj_ptr[v], g.adj_ptr[v + 1]
        for w, ew in zip(g.adj_idx[s:e], g.edge_w[s:e]):
            cu, cv = int(fine2coarse[v]), int(fine2coarse[w])
            if cu == cv:
                continue
            edges[(cu, cv)] = edges.get((cu, cv), 0.0) + float(ew)
    if edges:
        keys = np.asarray(sorted(edges.keys()), np.int64)
        vals = np.asarray([edges[tuple(k)] for k in keys])
        adj_ptr = np.zeros(nc + 1, np.int64)
        np.add.at(adj_ptr, keys[:, 0] + 1, 1)
        np.cumsum(adj_ptr, out=adj_ptr)
        adj_idx = keys[:, 1]
    else:
        adj_ptr = np.zeros(nc + 1, np.int64)
        adj_idx = np.zeros(0, np.int64)
        vals = np.zeros(0)
    return Graph(adj_ptr, adj_idx, vals, node_w), fine2coarse


# ---------------------------------------------------------------------------
# Band-k (paper Listing 2)
# ---------------------------------------------------------------------------


def bandk(csr: CSRMatrix, k: int = 3, max_coarse_ratio: float = 0.05) -> np.ndarray:
    """Band-k permutation for a CSR matrix.

    ``k-1`` coarsening levels; each level ordered with weighted CM; expansion
    orders each coarse node's children by their fine-level CM rank.  Returns
    the permutation ``perm`` such that ``A[perm][:, perm]`` is banded.
    """
    g0 = graph_from_csr(csr)
    graphs = [g0]
    maps: List[np.ndarray] = []
    for _ in range(max(k - 1, 0)):
        g, f2c = coarsen(graphs[-1])
        if g.n >= graphs[-1].n or g.n <= max(2, int(g0.n * max_coarse_ratio)):
            graphs.append(g)
            maps.append(f2c)
            break
        graphs.append(g)
        maps.append(f2c)

    # order the coarsest level
    rank = np.empty(graphs[-1].n, np.int64)
    rank[weighted_cm(graphs[-1])] = np.arange(graphs[-1].n)

    # expand: children sorted by (coarse rank, fine CM rank within the level)
    for level in range(len(maps) - 1, -1, -1):
        g_fine = graphs[level]
        f2c = maps[level]
        fine_rank = np.empty(g_fine.n, np.int64)
        fine_rank[weighted_cm(g_fine)] = np.arange(g_fine.n)
        order = np.lexsort((fine_rank, rank[f2c]))
        rank = np.empty(g_fine.n, np.int64)
        rank[order] = np.arange(g_fine.n)

    perm = np.argsort(rank[: csr.m], kind="stable")
    return perm


# ---------------------------------------------------------------------------
# band metrics
# ---------------------------------------------------------------------------


def bandwidth(csr: CSRMatrix) -> int:
    """Max |i - j| over nonzeros — the quantity band orderings minimise."""
    rp = np.asarray(csr.row_ptr)
    ci = np.asarray(csr.col_idx)
    rows = np.repeat(np.arange(csr.m), rp[1:] - rp[:-1])
    if len(rows) == 0:
        return 0
    return int(np.abs(rows - ci).max())


def ssr_span_stats(csr: CSRMatrix, rows_per_tile: int) -> Tuple[int, float]:
    """(max, mean) column span over row tiles — what sizes the tile x-window."""
    rp = np.asarray(csr.row_ptr)
    ci = np.asarray(csr.col_idx)
    spans = []
    for r0 in range(0, csr.m, rows_per_tile):
        r1 = min(r0 + rows_per_tile, csr.m)
        s, e = rp[r0], rp[r1]
        spans.append(int(ci[s:e].max()) - int(ci[s:e].min()) + 1 if e > s else 1)
    return int(np.max(spans)), float(np.mean(spans))
