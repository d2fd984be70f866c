"""Reverse Cuthill-McKee node ordering — bandwidth reduction on the host.

Counterpart of ``flow_updating_tpu/plan/rcm.py`` (pure numpy, carried over
unchanged so both packages order a graph identically).

The banded executor (:mod:`flow_updating_tpu_torch.plan.banded`) pays one
masked roll per occupied diagonal, so its cost is the number of distinct
``dst - src`` offsets the adjacency occupies.  RCM is the classic
bandwidth-reducing permutation: breadth-first layers from a
pseudo-peripheral vertex, neighbors visited in ascending-degree order,
the whole order reversed (George & Liu).  On lattices, paths, community
graphs and anything with spatial structure it concentrates the adjacency
into a few near-full diagonals; on expanders (ER, BA cores) no ordering
can — the band statistics it produces are exactly what the planner's
remainder-fraction heuristics consume.

Pure numpy, level-vectorized (no per-node Python loop inside a level).
"""

from __future__ import annotations

import numpy as np


def _level_neighbors(topo, frontier: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """All neighbors of ``frontier`` (with repeats), plus the frontier
    position each came from — vectorized ragged CSR slice extraction."""
    lo = topo.row_start[frontier]
    counts = topo.row_start[frontier + 1] - lo
    total = int(counts.sum())
    if not total:
        e = np.empty(0, np.int64)
        return e, e
    seg = np.repeat(np.arange(frontier.size, dtype=np.int64), counts)
    within = np.arange(total, dtype=np.int64) - np.repeat(
        np.cumsum(counts) - counts, counts
    )
    return topo.dst[lo[seg] + within].astype(np.int64), seg


def _cm_component(topo, start: int, visited: np.ndarray) -> np.ndarray:
    """Cuthill-McKee order of ``start``'s component: BFS where each
    level's nodes are taken parent-by-parent (in the parent's level
    order), each parent's unvisited neighbors in ascending degree."""
    deg = topo.out_deg
    visited[start] = True
    out = [np.array([start], np.int64)]
    frontier = out[0]
    while True:
        nbrs, seg = _level_neighbors(topo, frontier)
        if not nbrs.size:
            break
        # textbook CM ordering key: (parent position, degree, node id)
        order = np.lexsort((nbrs, deg[nbrs], seg))
        nbrs = nbrs[order]
        # dedup keeping the FIRST occurrence (earliest parent wins)
        _, first = np.unique(nbrs, return_index=True)
        nbrs = nbrs[np.sort(first)]
        nbrs = nbrs[~visited[nbrs]]
        if not nbrs.size:
            break
        visited[nbrs] = True
        out.append(nbrs)
        frontier = nbrs
    return np.concatenate(out)


def _pseudo_peripheral(topo, start: int) -> int:
    """George-Liu pseudo-peripheral vertex: walk to the farthest BFS
    level's minimum-degree node until the eccentricity stops growing."""
    deg = topo.out_deg
    ecc = -1
    for _ in range(8):  # converges in 2-3 hops in practice
        visited = np.zeros(topo.num_nodes, bool)
        visited[start] = True
        frontier = np.array([start], np.int64)
        last = frontier
        depth = 0
        while True:
            nbrs, _ = _level_neighbors(topo, frontier)
            nbrs = np.unique(nbrs)
            nbrs = nbrs[~visited[nbrs]]
            if not nbrs.size:
                break
            visited[nbrs] = True
            last = nbrs
            frontier = nbrs
            depth += 1
        if depth <= ecc:
            return start
        ecc = depth
        start = int(last[np.argmin(deg[last])])
    return start


def rcm_order(topo) -> np.ndarray:
    """Reverse Cuthill-McKee permutation: ``order[new_id] = old_id``.

    Covers every connected component (each started at a
    pseudo-peripheral vertex of minimum degree); isolated nodes land at
    the front of the reversed order, harmlessly.  A graph with no edges
    returns the identity."""
    N = topo.num_nodes
    if topo.num_edges == 0:
        return np.arange(N, dtype=np.int64)
    visited = np.zeros(N, bool)
    parts = []
    # scan components cheapest-first: the unvisited node of least degree
    deg_key = topo.out_deg.astype(np.int64) * N + np.arange(N)
    by_deg = np.argsort(deg_key, kind="stable")
    cursor = 0
    while True:
        while cursor < N and visited[by_deg[cursor]]:
            cursor += 1
        if cursor >= N:
            break
        seed = int(by_deg[cursor])
        if topo.out_deg[seed] > 0:
            seed = _pseudo_peripheral(topo, seed)
        parts.append(_cm_component(topo, seed, visited))
    order = np.concatenate(parts)
    return order[::-1].copy()


def adjacency_bandwidth(topo, order: np.ndarray | None = None) -> int:
    """Max |new(dst) - new(src)| over the edges — the half-bandwidth of
    the permuted adjacency (0 for an edgeless graph)."""
    if topo.num_edges == 0:
        return 0
    if order is None:
        return int(np.max(np.abs(topo.dst.astype(np.int64)
                                 - topo.src.astype(np.int64))))
    inv = np.empty(topo.num_nodes, np.int64)
    inv[np.asarray(order, np.int64)] = np.arange(topo.num_nodes,
                                                 dtype=np.int64)
    return int(np.max(np.abs(inv[topo.dst] - inv[topo.src])))


def offset_profile(topo, order: np.ndarray | None = None,
                   top: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Distinct signed diagonals ``new(dst) - new(src)`` and their edge
    counts, most-occupied first (``top`` > 0 truncates) — the raw band
    statistics the planner and ``plan --explain`` report."""
    if topo.num_edges == 0:
        e = np.empty(0, np.int64)
        return e, e
    if order is None:
        d = topo.dst.astype(np.int64) - topo.src.astype(np.int64)
    else:
        inv = np.empty(topo.num_nodes, np.int64)
        inv[np.asarray(order, np.int64)] = np.arange(topo.num_nodes,
                                                     dtype=np.int64)
        d = inv[topo.dst] - inv[topo.src]
    offs, counts = np.unique(d, return_counts=True)
    rank = np.argsort(-counts, kind="stable")
    offs, counts = offs[rank], counts[rank]
    if top:
        offs, counts = offs[:top], counts[:top]
    return offs, counts
