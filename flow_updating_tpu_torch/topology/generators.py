"""Synthetic topology generators (numpy).

Counterpart of ``flow_updating_tpu/topology/generators.py``.  Each generator
emits undirected edges once and lets :func:`build_topology` symmetrize
them.  Differences from the JAX package, both deliberate for now:

* every generator takes its numpy path at every size (the JAX package
  hands Erdős–Rényi above 100k nodes and Barabási–Albert above 10k nodes
  to its C++ runtime, whose random draws differ — graphs above those sizes
  are therefore different graphs here);
* no closed-form ``structure`` descriptor is attached (it feeds only
  ``spmv='structured'``, a later port item), and ``fat_tree`` always
  materializes its edges.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from flow_updating_tpu_torch.topology.graph import Topology, build_topology


def _finish(n, pairs, seed, values) -> Topology:
    if values is None:
        values = np.random.default_rng(seed + 1).uniform(0.0, 1.0, n)
    # generators emit undirected edges as single-direction pairs by design;
    # symmetrization is intended, not a declaration repair
    return build_topology(n, pairs, values=values, seed=seed,
                          warn_asymmetric=False)


def ring(n: int, k: int = 1, seed: int = 0, values=None) -> Topology:
    """Ring lattice: node i connected to i+1..i+k (mod n)."""
    i = np.arange(n, dtype=np.int64)
    pairs = np.concatenate(
        [np.stack([i, (i + d) % n], axis=1) for d in range(1, k + 1)], axis=0
    )
    return _finish(n, pairs, seed, values)


def grid2d(h: int, w: int, seed: int = 0, values=None) -> Topology:
    """2-D grid (4-neighborhood)."""
    idx = np.arange(h * w, dtype=np.int64).reshape(h, w)
    right = np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], axis=1)
    down = np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()], axis=1)
    return _finish(h * w, np.concatenate([right, down]), seed, values)


def torus2d(h: int, w: int, seed: int = 0, values=None) -> Topology:
    """2-D torus (periodic 4-neighborhood)."""
    idx = np.arange(h * w, dtype=np.int64).reshape(h, w)
    right = np.stack([idx.ravel(), np.roll(idx, -1, axis=1).ravel()], axis=1)
    down = np.stack([idx.ravel(), np.roll(idx, -1, axis=0).ravel()], axis=1)
    return _finish(h * w, np.concatenate([right, down]), seed, values)


def hypercube(d: int, seed: int = 0, values=None) -> Topology:
    """d-dimensional hypercube: 2^d nodes, node i ~ i^(1<<b)."""
    if d < 1:
        raise ValueError("hypercube dimension d must be >= 1")
    i = np.arange(1 << d, dtype=np.int64)
    pairs = np.concatenate(
        [np.stack([lo, lo ^ (1 << b)], axis=1)
         for b in range(d)
         for lo in (i[(i >> b) & 1 == 0],)], axis=0
    )
    return _finish(1 << d, pairs, seed, values)


def complete(n: int, seed: int = 0, values=None) -> Topology:
    i, j = np.triu_indices(n, k=1)
    return _finish(n, np.stack([i, j], axis=1), seed, values)


def erdos_renyi(n: int, avg_degree: float = 8.0, seed: int = 0,
                values=None) -> Topology:
    """G(n, m) with m = n * avg_degree / 2 undirected edges, plus a random
    Hamiltonian-cycle backbone so the graph is connected."""
    m = int(n * avg_degree / 2)
    rng = np.random.default_rng(seed)
    u = rng.integers(0, n, size=m, dtype=np.int64)
    v = rng.integers(0, n, size=m, dtype=np.int64)
    perm = rng.permutation(n).astype(np.int64)
    backbone = np.stack([perm, np.roll(perm, -1)], axis=1)
    pairs = np.concatenate([np.stack([u, v], axis=1), backbone], axis=0)
    return _finish(n, pairs, seed, values)


def barabasi_albert(n: int, m: int = 4, seed: int = 0,
                    values=None) -> Topology:
    """Preferential attachment (degree-skewed), repeated-endpoints sampling
    vectorized in chunks: a whole chunk of new nodes draws its targets from
    the endpoint multiset built so far."""
    rng = np.random.default_rng(seed)
    if n <= m + 1:
        return complete(n, seed=seed, values=values)
    i, j = np.triu_indices(m + 1, k=1)
    endpoints = [np.concatenate([i, j]).astype(np.int64)]
    pairs = [np.stack([i, j], axis=1).astype(np.int64)]
    next_node = m + 1
    chunk = max(256, n // 64)
    while next_node < n:
        cnt = min(chunk, n - next_node)
        pool = np.concatenate(endpoints)
        new = np.arange(next_node, next_node + cnt, dtype=np.int64)
        tgt = pool[rng.integers(0, len(pool), size=(cnt, m))]
        srcs = np.repeat(new, m)
        dsts = tgt.ravel()
        pairs.append(np.stack([srcs, dsts], axis=1))
        endpoints.append(np.concatenate([srcs, dsts]))
        next_node += cnt
    return _finish(n, np.concatenate(pairs), seed, values)


def community(n: int, c: int = 8, k_in: float = 8.0, k_out: float = 0.5,
              seed: int = 0, values=None) -> Topology:
    """Planted-partition graph: ``c`` dense communities bridged sparsely
    (an Erdős–Rényi layer plus a Hamiltonian backbone inside each
    contiguous block, ``n * k_out / 2`` random bridges and one guaranteed
    bridge per consecutive block pair)."""
    if c < 1:
        raise ValueError("community count c must be >= 1")
    c = int(min(c, n)) or 1
    rng = np.random.default_rng(seed)
    bounds = np.linspace(0, n, c + 1).astype(np.int64)
    pairs = []
    for b in range(c):
        lo, hi = int(bounds[b]), int(bounds[b + 1])
        size = hi - lo
        if size < 2:
            continue
        m = int(size * k_in / 2)
        u = rng.integers(lo, hi, size=m, dtype=np.int64)
        v = rng.integers(lo, hi, size=m, dtype=np.int64)
        perm = lo + rng.permutation(size).astype(np.int64)
        backbone = np.stack([perm, np.roll(perm, -1)], axis=1)
        pairs.append(np.stack([u, v], axis=1))
        pairs.append(backbone)
    m_x = int(n * k_out / 2)
    if c > 1 and m_x:
        u = rng.integers(0, n, size=m_x, dtype=np.int64)
        # a bridge leaves its community: v = (hi + off) mod n sweeps
        # exactly the complement of u's block
        block = np.searchsorted(bounds, u, side="right") - 1
        lo, hi = bounds[block], bounds[block + 1]
        off = rng.integers(0, np.maximum(n - (hi - lo), 1), dtype=np.int64)
        v = (hi + off) % n
        pairs.append(np.stack([u, v], axis=1))
    if c > 1:
        chain_u = bounds[1:-1] - 1
        chain_v = bounds[1:-1]
        pairs.append(np.stack([chain_u, chain_v], axis=1))
    all_pairs = (np.concatenate(pairs) if pairs
                 else np.empty((0, 2), np.int64))
    topo = _finish(n, all_pairs, seed, values)
    membership = (np.searchsorted(bounds, np.arange(n), side="right") - 1
                  ).astype(np.int32)
    bridge = np.flatnonzero(
        membership[topo.src] != membership[topo.dst]).astype(np.int64)
    return dataclasses.replace(topo, membership=membership,
                               bridge_edges=bridge)


def fat_tree(k: int, seed: int = 0, values=None,
             hosts_only_values: bool = True,
             materialize_edges: bool = True) -> Topology:
    """Al-Fares k-ary fat-tree; all hosts *and* switches are vertices.

    Layout: hosts [0, k^3/4), edge switches, aggregation switches, core
    switches.  Vertex count k^3/4 + 5k^2/4, undirected edges 3k^3/4;
    k=160 gives 1,056,000 vertices.  Switches carry value 0 when
    ``hosts_only_values``."""
    if k % 2:
        raise ValueError("fat-tree arity k must be even")
    if not materialize_edges:
        raise NotImplementedError(
            "fat_tree(materialize_edges=False) builds a virtual topology "
            "that only spmv='structured' can run; that path is the "
            "ROADMAP item 'structured stencil (A4)', not ported yet")
    half = k // 2
    n_host = half * half * k
    n_edge_sw = half * k
    n_agg_sw = half * k
    n_core = half * half
    edge0 = n_host
    agg0 = edge0 + n_edge_sw
    core0 = agg0 + n_agg_sw
    n = core0 + n_core

    pod = np.arange(k, dtype=np.int64)
    e_in_pod = np.arange(half, dtype=np.int64)

    P, E_, H = np.meshgrid(pod, e_in_pod, e_in_pod, indexing="ij")
    hosts = (P * half + E_) * half + H
    edges_sw = edge0 + P * half + E_
    he = np.stack([hosts.ravel(), edges_sw.ravel()], axis=1)

    P, E_, A = np.meshgrid(pod, e_in_pod, e_in_pod, indexing="ij")
    ea = np.stack(
        [(edge0 + P * half + E_).ravel(), (agg0 + P * half + A).ravel()],
        axis=1)

    P, A, C = np.meshgrid(pod, e_in_pod, np.arange(half, dtype=np.int64),
                          indexing="ij")
    ac = np.stack(
        [(agg0 + P * half + A).ravel(), (core0 + A * half + C).ravel()],
        axis=1)

    pairs = np.concatenate([he, ea, ac], axis=0)
    if values is None:
        rng = np.random.default_rng(seed + 1)
        values = rng.uniform(0.0, 1.0, n)
        if hosts_only_values:
            values[n_host:] = 0.0
    return build_topology(n, pairs, values=values, seed=seed,
                          warn_asymmetric=False)


def topology_from_spec(spec: str, seed: int = 0) -> Topology:
    """Build a topology from the CLI's ``name:params`` grammar
    (``'barabasi_albert:100000:4'``, ``'ring:64:2'``).  Integer-looking
    params parse as int, the rest as float."""
    parts = spec.split(":")
    name = parts[0]
    if name not in GENERATORS:
        raise ValueError(
            f"unknown generator {name!r}; have {sorted(GENERATORS)}")
    try:
        params = [int(p) if p.lstrip("-").isdigit() else float(p)
                  for p in parts[1:]]
    except ValueError:
        raise ValueError(f"bad generator parameters in {spec!r}") from None
    return GENERATORS[name](*params, seed=seed)


GENERATORS = {
    "ring": ring,
    "grid2d": grid2d,
    "torus2d": torus2d,
    "hypercube": hypercube,
    "complete": complete,
    "erdos_renyi": erdos_renyi,
    "barabasi_albert": barabasi_albert,
    "community": community,
    "fat_tree": fat_tree,
}
