"""``compile_topology``: one pass from an arbitrary graph to a plan.

Counterpart of ``flow_updating_tpu/plan/compile.py``.

The :class:`ExecutionPlan` binds together

* the RCM node order (``order[new] = old``) and its inverse,
* the reordered :class:`~flow_updating_tpu_torch.topology.graph.Topology` —
  rebuilt with the *stable* edge relabeling
  (:func:`reorder_topology_stable`), which preserves every node's
  within-row edge order and records the edge permutation, so the edge
  kernel run on the plan's topology evolves **bit-for-bit** like the
  original-order run (per-node segment sums add the same floats in the
  same order; the ``drop_perm`` lane keeps fault-injection PRNG draws
  aligned with original edge ids),
* the banded spmv plan + its leaves for the node kernel
  (``spmv='banded'``/``'banded_fused'``), and
* the statistics auto-selection and ``plan --explain`` consume
  (bandwidth before/after, lane count, band coverage, remainder
  fraction and route).

Plans are cached per (topology content, build knobs) in a small
in-process cache: the Engine, the bench and the CLI all compile the same
graph.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from flow_updating_tpu_torch.plan.banded import (
    BandedLeaves,
    BandedSpmvPlan,
    build_banded,
)
from flow_updating_tpu_torch.plan.rcm import adjacency_bandwidth, rcm_order
from flow_updating_tpu_torch.topology.graph import Topology


def reorder_topology_stable(topo: Topology, order: np.ndarray,
                            ) -> tuple[Topology, np.ndarray]:
    """Renumber nodes by ``order`` keeping each row's ORIGINAL edge
    order.

    Edges are grouped by new source but kept in their original relative
    order within each row.  Per-node
    reductions over out-edges therefore add the exact same floats in the
    exact same order as the un-reordered kernel — the property that
    makes a planned edge-kernel run bit-identical to the original after
    unpermutation (tests/test_plan.py).  Returns ``(topology,
    edge_order)`` with ``edge_order[new_e] = old_e``.
    """
    N, E = topo.num_nodes, topo.num_edges
    order = np.asarray(order, np.int64)
    inv = np.empty(N, np.int64)
    inv[order] = np.arange(N, dtype=np.int64)
    new_src = inv[topo.src]
    new_dst = inv[topo.dst]
    # stable: ties (same new source row) keep original edge order
    e_order = np.argsort(new_src, kind="stable")
    e_pos = np.empty(E, np.int64)
    e_pos[e_order] = np.arange(E, dtype=np.int64)
    src = new_src[e_order].astype(np.int32)
    dst = new_dst[e_order].astype(np.int32)
    rev = e_pos[topo.rev[e_order]].astype(np.int32)
    out_deg = topo.out_deg[order]
    row_start = np.zeros(N + 1, np.int64)
    np.cumsum(out_deg, out=row_start[1:])
    edge_rank = (np.arange(E, dtype=np.int64)
                 - row_start[src]).astype(np.int32)
    pick_e = lambda a: None if a is None else a[e_order]
    out = dataclasses.replace(
        topo,
        src=src,
        dst=dst,
        rev=rev,
        out_deg=out_deg,
        row_start=row_start,
        edge_rank=edge_rank,
        delay=topo.delay[e_order],
        values=topo.values[order],
        names=(tuple(topo.names[i] for i in order)
               if topo.names is not None else None),
        speeds=None if topo.speeds is None else topo.speeds[order],
        bandwidth=pick_e(topo.bandwidth),
        latency_s=pick_e(topo.latency_s),
        adopted=None,
        edge_links=pick_e(topo.edge_links),
        lat_rounds=pick_e(topo.lat_rounds),
        # fault-injection PRNG draws stay keyed by ORIGINAL edge id, so
        # a drop>0 planned run replays the exact original loss pattern
        drop_perm=e_order.astype(np.int32),
        structure=None,
    )
    return out, e_order


@dataclasses.dataclass(frozen=True, eq=False)
class ExecutionPlan:
    """One compiled topology: reorder + bands + remainder + stats.

    Identity-hashed (``eq=False``); the tensors live in ``leaves``
    (:class:`~flow_updating_tpu_torch.plan.banded.BandedLeaves`, on the
    CPU — the node kernel moves them to its device).
    """

    order: np.ndarray          # (N,) new -> old node id
    inv_order: np.ndarray      # (N,) old -> new node id
    topo: Topology             # RCM-reordered, stable edge order
    edge_order: np.ndarray     # (E,) new -> old edge id
    spmv: BandedSpmvPlan
    leaves: BandedLeaves
    stats: dict
    source_key: tuple = ()     # _topo_key of the SOURCE topology — the
    #                            consumers' cheap guard against running a
    #                            plan on a different graph that merely
    #                            shares the node count (silently wrong
    #                            banded masks otherwise)

    @property
    def num_nodes(self) -> int:
        return self.topo.num_nodes

    def unpermute_nodes(self, arr: np.ndarray, axis: int = 0) -> np.ndarray:
        """Plan-order per-node array -> original node order."""
        arr = np.asarray(arr)
        out = np.empty_like(arr)
        idx = [slice(None)] * arr.ndim
        idx[axis] = self.order
        out[tuple(idx)] = arr
        return out

    def unpermute_edges(self, arr: np.ndarray, axis: int = 0) -> np.ndarray:
        """Plan-order per-edge array -> original edge order."""
        arr = np.asarray(arr)
        out = np.empty_like(arr)
        idx = [slice(None)] * arr.ndim
        idx[axis] = self.edge_order
        out[tuple(idx)] = arr
        return out

    def original_node_ids(self, new_ids: np.ndarray) -> np.ndarray:
        """Map plan-space node ids to original ids (negatives pass
        through — the padding convention of topk_idx)."""
        new_ids = np.asarray(new_ids, np.int64)
        safe = np.clip(new_ids, 0, self.num_nodes - 1)
        return np.where(new_ids >= 0, self.order[safe], new_ids)

    def describe(self) -> dict:
        """JSON-ready summary (plan manifests, ``plan`` CLI)."""
        s = self.spmv
        return {
            "nodes": int(self.topo.num_nodes),
            "directed_edges": int(self.topo.num_edges),
            "band_lanes": len(s.offsets),
            "band_offsets": list(s.offsets[:64]),
            "in_band_edges": int(s.in_band_edges),
            "remainder_edges": int(s.remainder_edges),
            "band_coverage": round(s.coverage, 6),
            "remainder_fraction": round(1.0 - s.coverage, 6),
            "remainder_impl": s.rem_mode,
            **{k: v for k, v in self.stats.items()},
        }


_plan_cache: dict = {}

#: the RCM order and the reordered topology by topology content: they do
#: not depend on the knobs, so the plans of one graph at several fills
#: (the autotuner's grid) order it once
_order_cache: dict = {}


def _topo_key(topo: Topology) -> tuple:
    import hashlib

    h = hashlib.sha1()
    h.update(np.ascontiguousarray(topo.src))
    h.update(np.ascontiguousarray(topo.dst))
    return (topo.num_nodes, topo.num_edges, h.hexdigest())


def _ordered(topo: Topology, topo_key: tuple) -> tuple:
    """``(order, bandwidth before, bandwidth after, reordered topology,
    edge order)`` of ``topo``, cached by content (as many graphs as the
    plan cache keeps, whose plans share the reordered topologies)."""
    hit = _order_cache.get(topo_key)
    if hit is not None:
        return hit
    order = rcm_order(topo)
    bw_before = adjacency_bandwidth(topo)
    bw_after = adjacency_bandwidth(topo, order)
    if bw_after > bw_before:
        # RCM never *has* to win; on a pre-banded input keep the
        # original order (identity) rather than degrade it
        order = np.arange(topo.num_nodes, dtype=np.int64)
        bw_after = bw_before
    hit = (order, bw_before, bw_after,
           *reorder_topology_stable(topo, order))
    _order_cache[topo_key] = hit
    while len(_order_cache) > 4:   # a reordered topology is O(E) arrays
        _order_cache.pop(next(iter(_order_cache)))
    return hit


def compile_topology(topo: Topology, *, max_lanes: int = 96,
                     min_fill: float = 0.05, remainder: str = "auto",
                     features: int = 0) -> ExecutionPlan:
    """Compile ``topo`` into an :class:`ExecutionPlan`.

    Knobs: ``max_lanes`` bounds the dense roll lanes (each costs one
    streamed pass per neighbor sum); ``min_fill`` is the occupancy floor
    below which a diagonal goes to the remainder; ``remainder`` routes
    the out-of-band edges ('auto' | 'gather' | 'benes' | 'none');
    ``features`` > 0 declares a vector payload (rolls broadcast over it,
    the remainder then gathers).  Plans are cached on (topology content,
    knobs), the RCM ordering on the content alone."""
    topo._require_edges("compile_topology (the banded planner)")
    # 'auto' builds exactly the 'gather' plan here (plan/banded.py), so
    # both share one cache entry: the sharded round asks for 'gather'
    key = (_topo_key(topo), max_lanes, float(min_fill),
           "gather" if remainder == "auto" else remainder, bool(features))
    cached = _plan_cache.get(key)
    if cached is not None:
        return cached
    t0 = time.perf_counter()
    order, bw_before, bw_after, reordered, e_order = _ordered(topo, key[0])
    spmv, leaves = build_banded(
        reordered.num_nodes, reordered.src, reordered.dst,
        max_lanes=max_lanes, min_fill=min_fill, remainder=remainder,
        features=features,
    )
    inv = np.empty(topo.num_nodes, np.int64)
    inv[order] = np.arange(topo.num_nodes, dtype=np.int64)
    plan = ExecutionPlan(
        order=order, inv_order=inv, topo=reordered, edge_order=e_order,
        spmv=spmv, leaves=leaves, source_key=key[0],
        stats={
            "bandwidth_before": bw_before,
            "bandwidth_after": bw_after,
            "build_s": round(time.perf_counter() - t0, 6),
            "max_lanes": max_lanes,
            "min_fill": min_fill,
        },
    )
    _plan_cache[key] = plan
    while len(_plan_cache) > 4:   # plans hold O(N) host arrays
        _plan_cache.pop(next(iter(_plan_cache)))
    return plan
