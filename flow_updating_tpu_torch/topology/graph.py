"""Dense edge-index topology: the symmetrized directed edge list.

Counterpart of ``flow_updating_tpu/topology/graph.py``.  The representation
is the same flat, static, symmetrized edge list:

* ``src/dst (E,) int32`` — directed edges sorted by ``(src, dst)``, so every
  node's out-edges are contiguous (CSR rows);
* ``rev (E,) int32`` — index of the opposite direction;
* ``delay (E,) int32`` — per-edge delivery latency in whole rounds.

Symmetrization absorbs the reference's runtime neighbor-adoption repair:
missing reverse edges are added at load time and reported through
:func:`build_topology`'s ``adopted`` output.

Everything here is host-side numpy; the node kernel (``models/sync.py``)
moves what it needs onto its device.  Graphs are always built on the numpy
path (the JAX package switches to a C++ builder above two million pairs;
the port has no native runtime yet).
"""

from __future__ import annotations

import dataclasses
import logging
from collections.abc import Mapping, Sequence

import numpy as np

logger = logging.getLogger("flow_updating_tpu_torch")


@dataclasses.dataclass(frozen=True)
class Topology:
    """Static graph for one run (host-side numpy arrays)."""

    num_nodes: int
    src: np.ndarray        # (E,) int32, sorted
    dst: np.ndarray        # (E,) int32
    rev: np.ndarray        # (E,) int32, rev[rev[e]] == e
    out_deg: np.ndarray    # (N,) int32 (== in_deg after symmetrization)
    row_start: np.ndarray  # (N+1,) int64 CSR offsets into src/dst
    edge_rank: np.ndarray  # (E,) int32 position of edge within its src row
    delay: np.ndarray      # (E,) int32 delivery delay in rounds, >= 1
    values: np.ndarray     # (N,) float64 initial node values
    names: tuple | None = None          # (N,) host names, optional
    speeds: np.ndarray | None = None    # (N,) float64 host flop-rates
    bandwidth: np.ndarray | None = None  # (E,) float64 route bandwidth
    latency_s: np.ndarray | None = None  # (E,) float64 route latency (s)
    adopted: np.ndarray | None = None   # (A,2) int64 directed edges adopted
    #                                     at load to symmetrize a declared-
    #                                     asymmetric graph
    # link-level contention model (platform-loaded topologies only; the
    # edge kernel that consumes it is a later port item)
    edge_links: np.ndarray | None = None     # (E, K) int32 link ids, pad L
    link_ser_rounds: np.ndarray | None = None  # (L,) f64 one-message cost
    link_shared: np.ndarray | None = None    # (L,) bool — False = FATPIPE
    lat_rounds: np.ndarray | None = None     # (E,) f64 route latency, rounds
    drop_perm: np.ndarray | None = None      # (E,) int32 new-edge ->
    #                                          ORIGINAL edge id, set by the
    #                                          topology compiler's stable
    #                                          reorder (plan/compile.py)
    membership: np.ndarray | None = None     # (N,) int32 planted-partition
    #                                          block id (community generator)
    bridge_edges: np.ndarray | None = None   # (B,) int64 directed edge ids
    #                                          crossing community blocks

    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])

    @property
    def max_delay(self) -> int:
        return int(self.delay.max()) if self.num_edges else 1

    @property
    def true_mean(self) -> float:
        return float(self.values.mean())

    def ell_buckets(self) -> EllBuckets:
        """Degree-bucketed ELL adjacency for scatter-free neighbor sums.

        Nodes are permuted into ascending-degree order and grouped into
        buckets keyed by the next power of two of their degree; each
        bucket stores a dense ``(rows, width)`` neighbor-index matrix whose
        width is the bucket's true max degree (indices in *permuted* node
        space, padded with N -> a zero slot).  Cached after first use."""
        cached = getattr(self, "_ell_buckets", None)
        if cached is not None:
            return cached
        N = self.num_nodes
        deg = self.out_deg.astype(np.int64)
        width = np.zeros(N, np.int64)
        nz = deg > 0
        width[nz] = 1 << np.ceil(np.log2(deg[nz])).astype(np.int64)
        order = np.argsort(width, kind="stable").astype(np.int32)
        inv = np.empty(N, np.int32)
        inv[order] = np.arange(N, dtype=np.int32)

        mats = []
        edge_mats = []
        row_counts = []
        widths = []
        start = 0
        sorted_w = width[order]
        while start < N:
            wkey = sorted_w[start]
            end = int(np.searchsorted(sorted_w, wkey, side="right"))
            rows = order[start:end]
            # the power of two is only the GROUPING key; the stored width
            # is the bucket's true max degree (fat-tree switches: 160, not
            # 256)
            w = int(deg[rows].max()) if wkey else 0
            if w == 0:
                mat = np.empty((len(rows), 0), np.int32)
                emat = np.empty((len(rows), 0), np.int32)
            else:
                lo = self.row_start[rows]
                d = deg[rows]
                ar = np.arange(int(w), dtype=np.int64)
                valid = ar[None, :] < d[:, None]
                col = np.where(valid, lo[:, None] + ar[None, :], 0)
                mat = np.where(valid, inv[self.dst[col]], N).astype(np.int32)
                emat = np.where(valid, col, self.num_edges).astype(np.int32)
            mats.append(mat)
            edge_mats.append(emat)
            row_counts.append(len(rows))
            widths.append(int(w))
            start = end
        out = EllBuckets(
            perm=order, inv_perm=inv, widths=tuple(widths),
            row_counts=tuple(row_counts), mats=tuple(mats),
            edge_mats=tuple(edge_mats),
        )
        object.__setattr__(self, "_ell_buckets", out)
        return out

    def neighbors(self, node: int) -> np.ndarray:
        lo, hi = self.row_start[node], self.row_start[node + 1]
        return self.dst[lo:hi]


@dataclasses.dataclass(frozen=True)
class EllBuckets:
    """Degree-bucketed ELL adjacency (see :meth:`Topology.ell_buckets`).

    ``perm`` maps permuted position -> original node id; bucket ``b`` covers
    permuted rows ``[sum(row_counts[:b]), sum(row_counts[:b+1]))`` with a
    dense ``(row_counts[b], widths[b])`` neighbor matrix in permuted space,
    padded with N."""

    perm: np.ndarray        # (N,) int32
    inv_perm: np.ndarray    # (N,) int32
    widths: tuple           # per-bucket padded width
    row_counts: tuple       # per-bucket row count
    mats: tuple             # per-bucket (rows, width) int32 NEIGHBOR indices
    edge_mats: tuple        # per-bucket (rows, width) int32 OUT-EDGE indices


def _symmetrize(pairs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Both directions of every declared edge, deduped, self-loops dropped.

    Returns (directed_edges sorted by (src, dst), adopted) where ``adopted``
    lists directed edges that were only present via symmetrization."""
    pairs = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
    keep = pairs[:, 0] != pairs[:, 1]
    pairs = pairs[keep]
    fwd = pairs
    bwd = pairs[:, ::-1]
    both = np.concatenate([fwd, bwd], axis=0)
    both = np.unique(both, axis=0)  # sorted lexicographically by (src, dst)
    declared = np.unique(fwd, axis=0)
    base = both.max() + 1 if both.size else 1
    both_keys = both[:, 0] * base + both[:, 1]
    decl_keys = declared[:, 0] * base + declared[:, 1]
    adopted = both[~np.isin(both_keys, decl_keys)]
    return both, adopted


def build_topology(
    num_nodes: int,
    pairs: np.ndarray | Sequence,
    values: np.ndarray | None = None,
    names: Sequence[str] | None = None,
    latency_s: Mapping[tuple, float] | None = None,
    bandwidth: Mapping[tuple, float] | None = None,
    speeds: np.ndarray | None = None,
    tick_interval: float = 1.0,
    latency_scale: float = 0.0,
    msg_bytes: float = 104.0,
    seed: int = 0,
    warn_asymmetric: bool = True,
    route_links: Mapping[tuple, tuple] | None = None,
    link_caps: np.ndarray | None = None,
    link_shared: np.ndarray | None = None,
) -> Topology:
    """Build a :class:`Topology` from (possibly asymmetric) directed pairs.

    Same arguments and semantics as the JAX package's ``build_topology``:
    ``values`` defaults to uniform [0, 1) from ``seed``; ``latency_scale``
    0.0 gives unit delays, > 0 latency-warped delays
    ``max(1, round((latency + msg_bytes/bandwidth) * latency_scale /
    tick_interval))``; ``route_links``/``link_caps``/``link_shared``
    attach the link-level contention model."""
    pairs_arr = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
    edges, adopted = _symmetrize(pairs_arr)
    if len(adopted) and warn_asymmetric:
        shown = ", ".join(f"{int(a)}->{int(b)}" for a, b in adopted[:8])
        logger.warning(
            "topology: %d directed edge(s) had no declared reverse; "
            "adopted at load time (%s%s)",
            len(adopted), shown, "..." if len(adopted) > 8 else "",
        )
    if edges.size and (edges.max() >= num_nodes or edges.min() < 0):
        raise ValueError("edge endpoint out of range")

    E = edges.shape[0]
    src = edges[:, 0].astype(np.int32)
    dst = edges[:, 1].astype(np.int32)

    # reverse-edge permutation: position of (dst, src) in the sorted list
    order_keys = src.astype(np.int64) * num_nodes + dst.astype(np.int64)
    rev_keys = dst.astype(np.int64) * num_nodes + src.astype(np.int64)
    rev = np.searchsorted(order_keys, rev_keys).astype(np.int32)
    if not np.array_equal(order_keys[rev], rev_keys):
        raise ValueError("symmetrized graph has an edge without reverse")

    out_deg = np.bincount(src, minlength=num_nodes).astype(np.int32)
    row_start = np.zeros(num_nodes + 1, dtype=np.int64)
    np.cumsum(out_deg, out=row_start[1:])
    edge_rank = (np.arange(E, dtype=np.int64) - row_start[src]).astype(np.int32)

    if values is None:
        rng = np.random.default_rng(seed)
        values = rng.uniform(0.0, 1.0, size=num_nodes)
    values = np.asarray(values, dtype=np.float64)
    if values.shape != (num_nodes,):
        raise ValueError(f"values must have shape ({num_nodes},)")

    lat = None
    bw = None
    if latency_s is not None:
        lat = np.zeros(E, dtype=np.float64)
        for i in range(E):
            key = (int(src[i]), int(dst[i]))
            lat[i] = latency_s.get(key, latency_s.get((key[1], key[0]), 0.0))
    if bandwidth is not None:
        bw = np.zeros(E, dtype=np.float64)
        for i in range(E):
            key = (int(src[i]), int(dst[i]))
            bw[i] = bandwidth.get(key, bandwidth.get((key[1], key[0]), 0.0))

    if latency_scale > 0.0 and lat is not None:
        transfer_s = lat.copy()
        if bw is not None:
            pos = bw > 0
            transfer_s[pos] += msg_bytes / bw[pos]
        delay = np.maximum(
            1, np.rint(transfer_s * latency_scale / tick_interval)
        ).astype(np.int32)
    else:
        delay = np.ones(E, dtype=np.int32)

    edge_links_arr = None
    link_ser = None
    link_shared_arr = None
    lat_rounds = None
    if route_links is not None and latency_scale > 0.0:
        if link_caps is None or lat is None:
            raise ValueError(
                "route_links needs link_caps and latency_s for the "
                "contention model"
            )
        L = len(link_caps)
        K = max((len(v) for v in route_links.values()), default=1) or 1
        edge_links_arr = np.full((E, K), L, np.int32)
        for i in range(E):
            key = (int(src[i]), int(dst[i]))
            lks = route_links.get(key, route_links.get((key[1], key[0]), ()))
            edge_links_arr[i, : len(lks)] = lks
        link_ser = (msg_bytes * latency_scale
                    / (tick_interval * np.asarray(link_caps, np.float64)))
        link_shared_arr = (np.ones(L, bool) if link_shared is None
                           else np.asarray(link_shared, bool))
        lat_rounds = lat * latency_scale / tick_interval

    return Topology(
        num_nodes=num_nodes,
        src=src,
        dst=dst,
        rev=rev,
        out_deg=out_deg,
        row_start=row_start,
        edge_rank=edge_rank,
        delay=delay,
        values=values,
        names=tuple(names) if names is not None else None,
        speeds=np.asarray(speeds, dtype=np.float64) if speeds is not None else None,
        bandwidth=bw,
        latency_s=lat,
        adopted=adopted,
        edge_links=edge_links_arr,
        link_ser_rounds=link_ser,
        link_shared=link_shared_arr,
        lat_rounds=lat_rounds,
    )


def topology_from_arrays(num_nodes: int, src, dst, rev, out_deg, row_start,
                         edge_rank, delay, values, **optional) -> Topology:
    """A :class:`Topology` from ready edge arrays — the JAX package's
    ``Topology`` leaves handed over as numpy arrays, so a run started
    there can continue here on the identical graph.  ``optional`` takes
    the remaining dataclass fields (``names``, ``speeds``, ...).  The
    arrays are checked for the invariants every consumer relies on."""
    topo = Topology(
        num_nodes=int(num_nodes),
        src=np.asarray(src, np.int32), dst=np.asarray(dst, np.int32),
        rev=np.asarray(rev, np.int32), out_deg=np.asarray(out_deg, np.int32),
        row_start=np.asarray(row_start, np.int64),
        edge_rank=np.asarray(edge_rank, np.int32),
        delay=np.asarray(delay, np.int32),
        values=np.asarray(values, np.float64),
        **optional,
    )
    E, N = topo.num_edges, topo.num_nodes
    shapes_ok = (topo.dst.shape == (E,) and topo.rev.shape == (E,)
                 and topo.edge_rank.shape == (E,) and topo.delay.shape == (E,)
                 and topo.out_deg.shape == (N,)
                 and topo.row_start.shape == (N + 1,)
                 and topo.values.shape[:1] == (N,))
    if not shapes_ok:
        raise ValueError("topology arrays disagree on node/edge counts")
    if E and (topo.src.min() < 0 or topo.src.max() >= N
              or topo.dst.min() < 0 or topo.dst.max() >= N):
        raise ValueError("edge endpoint out of range")
    if E and not (np.all(topo.rev[topo.rev] == np.arange(E))
                  and np.array_equal(topo.src[topo.rev], topo.dst)):
        raise ValueError("rev is not the reverse-edge involution")
    if not np.array_equal(np.diff(topo.row_start), topo.out_deg) \
            or not np.array_equal(
                np.bincount(topo.src, minlength=N), topo.out_deg):
        raise ValueError("row_start/out_deg do not describe the CSR rows "
                         "of src")
    return topo
