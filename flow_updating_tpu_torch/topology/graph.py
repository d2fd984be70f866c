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
moves what it needs onto its device, and :meth:`Topology.device_arrays`
gives the edge kernel (``models/rounds.py``) its :class:`EdgeArrays`.
As in the JAX package, a generator's graph of two million declared pairs
or more is symmetrized, sorted and paired with its reverse edges by the
C++ builder
(:mod:`flow_updating_tpu_torch.native`), which gives the same arrays.
"""

from __future__ import annotations

import dataclasses
import logging
from collections.abc import Mapping, Sequence

import numpy as np
import torch

from flow_updating_tpu_torch import native

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
    # link-level contention model (platform-loaded topologies, or
    # build_topology's route_links; the edge kernel's edge_delays)
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
    structure: object | None = None          # closed-form adjacency
    #                                          descriptor (ops/structured.py)
    #                                          attached by a regular graph's
    #                                          generator: spmv='structured'
    virtual: bool = False                    # True = the edge arrays are
    #                                          deliberately empty (a fat tree
    #                                          built materialize_edges=False);
    #                                          only spmv='structured' runs it

    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])

    @property
    def max_delay(self) -> int:
        return int(self.delay.max()) if self.num_edges else 1

    @property
    def has_link_model(self) -> bool:
        return self.edge_links is not None

    def contended_max_delay(self, max_flows: int | None = None,
                            inflight_per_edge: int = 0) -> int:
        """Upper bound on the delay under contention: every edge's latency
        plus its worst link serialization when every edge whose route
        crosses that link sends at once (``max_flows`` caps the per-link
        count) — the safe ``delay_depth`` of a ``cfg.contention`` run.
        ``inflight_per_edge`` > 0 also counts that many standing in-flight
        messages per crossing edge (``cfg.contention_backlog`` sizing)."""
        if not self.has_link_model:
            return self.max_delay
        L = self.link_ser_rounds.shape[0]
        cross = np.bincount(self.edge_links.reshape(-1),
                            minlength=L + 1)[:L]
        cross = cross * (1 + max(int(inflight_per_edge), 0))
        if max_flows is not None:
            cross = np.minimum(cross, max_flows)
        ser = np.where(self.link_shared,
                       self.link_ser_rounds * np.maximum(cross, 1),
                       self.link_ser_rounds)
        serp = np.concatenate([ser, [0.0]])
        worst = serp[self.edge_links].max(axis=1)
        return max(1, int(np.ceil((self.lat_rounds + worst).max())))

    def link_csr(self) -> tuple[np.ndarray, np.ndarray]:
        """The link-major order of the ``(E*K,)`` flattened route slots
        (the pad link ``L`` included), for per-link float sums in a fixed
        order: ``(gather, lengths)``, where link ``l``'s segment is a head
        slot (index ``l`` into a ``(L + 1,)`` per-link array) followed by
        the flat positions that cross it in increasing order (index
        ``L + 1 + position`` into the per-slot updates).  Cached."""
        self._require_edges("link_csr (the link model)")
        cached = getattr(self, "_link_csr", None)
        if cached is not None:
            return cached
        Lp = self.link_ser_rounds.shape[0] + 1
        flat = self.edge_links.reshape(-1).astype(np.int64)
        order = np.argsort(flat, kind="stable")
        cnt = np.bincount(flat, minlength=Lp)
        heads = np.concatenate([[0], np.cumsum(cnt)[:-1]]) + np.arange(Lp)
        gather = np.empty(flat.size + Lp, np.int64)
        body = np.ones(gather.size, bool)
        body[heads] = False
        gather[heads] = np.arange(Lp)
        gather[body] = Lp + order
        out = (gather, cnt + 1)
        object.__setattr__(self, "_link_csr", out)
        return out

    @property
    def true_mean(self) -> float:
        return float(self.values.mean())

    def _require_edges(self, what: str) -> None:
        """Refuse an edge consumer on a virtual topology (the JAX
        package's message), or on one whose arrays are missing."""
        if self.virtual:
            raise ValueError(
                f"{what} needs materialized edge arrays, but this topology "
                "is virtual (generator called with materialize_edges=False "
                "for mega-scale runs); only the node kernel with "
                "spmv='structured' can execute it — rebuild with "
                "materialize_edges=True for any other path"
            )
        if self.src is None or self.dst is None:
            raise ValueError(f"{what} needs materialized edge arrays, but "
                             "this topology has none")

    def with_values(self, values: np.ndarray) -> Topology:
        """The same graph with other initial values (``(N,)`` or ``(N,
        D)``); the structure descriptor stays."""
        values = np.asarray(values, dtype=np.float64)
        if values.ndim not in (1, 2) or values.shape[0] != self.num_nodes:
            raise ValueError(
                f"values must have shape ({self.num_nodes},) or "
                f"({self.num_nodes}, D) — got {values.shape}")
        return dataclasses.replace(self, values=values)

    def name_to_id(self) -> dict:
        if self.names is None:
            raise ValueError("topology has no node names")
        return {n: i for i, n in enumerate(self.names)}

    def ell_buckets(self) -> EllBuckets:
        """Degree-bucketed ELL adjacency for scatter-free neighbor sums.

        Nodes are permuted into ascending-degree order and grouped into
        buckets keyed by the next power of two of their degree; each
        bucket stores a dense ``(rows, width)`` neighbor-index matrix whose
        width is the bucket's true max degree (indices in *permuted* node
        space, padded with N -> a zero slot).  Cached after first use."""
        self._require_edges("ell_buckets")
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
        self._require_edges("neighbors")
        lo, hi = self.row_start[node], self.row_start[node + 1]
        return self.dst[lo:hi]

    def edge_coloring(self) -> tuple[np.ndarray, int]:
        """Proper edge coloring (undirected: both directions share a
        color), ``(color (E,) int32, number of colors)``, cached on the
        object.  The fast synchronous pairwise mode fires one color class
        per round, so concurrent 2-party averages are disjoint.

        From 50,000 directed edges the C++ greedy coloring (hubs first,
        the smallest color free at both endpoints); below that repeated
        maximal-matching extraction (each pass gives the next color to
        every edge that is the lowest-indexed uncolored edge at both of
        its endpoints, until no such edge is left) — the JAX package's two
        routes at its threshold, so both give the same colors."""
        self._require_edges("edge_coloring")
        cached = getattr(self, "_edge_coloring", None)
        if cached is not None:
            return cached
        E = self.num_edges
        if E >= 50_000:
            out = native.edge_coloring(self)
            object.__setattr__(self, "_edge_coloring", out)
            return out
        und = np.where(self.src < self.dst)[0]
        u = self.src[und].astype(np.int64)
        v = self.dst[und].astype(np.int64)
        M = len(und)
        color = np.full(M, -1, np.int32)
        uncolored = np.ones(M, bool)
        idx = np.arange(M, dtype=np.int64)
        c = 0
        while uncolored.any():
            # grow one maximal matching: repeat the picks until no
            # uncolored edge has both endpoints free
            free = np.ones(self.num_nodes, bool)
            this = np.zeros(M, bool)
            avail = uncolored.copy()
            while True:
                eid = np.where(avail, idx, M)
                first = np.full(self.num_nodes, M, dtype=np.int64)
                np.minimum.at(first, u, eid)
                np.minimum.at(first, v, eid)
                pick = avail & (first[u] == idx) & (first[v] == idx)
                if not pick.any():
                    break
                this |= pick
                free[u[pick]] = False
                free[v[pick]] = False
                avail &= ~pick & free[u] & free[v]
            color[this] = c
            uncolored &= ~this
            c += 1
        full = np.full(E, -1, np.int32)
        full[und] = color
        full[self.rev[und]] = color
        object.__setattr__(self, "_edge_coloring", (full, c))
        return full, c

    def _network(self, which: str, fused: bool):
        """The edge kernel's planned networks — ``'segments'`` (the
        segment plan and its dist plane) or ``'rev'`` (the reverse-edge
        permutation) — for the per-stage or the fused executor.  The
        Beneš routing is the costly part (seconds at 2^23 elements), so
        the routed stages are cached on the object and both executors
        share them."""
        self._require_edges(f"the {which} network")
        from flow_updating_tpu_torch.ops import permute, seg_benes

        cache = getattr(self, "_networks", None)
        if cache is None:
            cache = {}
            object.__setattr__(self, "_networks", cache)
        if which not in cache:
            if which == "segments":
                cache[which] = seg_benes.plan_segments(
                    self.row_start, self.out_deg, self.edge_rank)
            else:
                cache[which] = permute.padded_perm_plan(self.rev)
        base = cache[which]
        if not fused:
            return base
        if which == "segments":
            plan, dist = base
            return seg_benes.SegmentedPlan.from_plan(plan, fused=True), dist
        return permute.FusedPaddedPermPlan.from_plan(base)

    def device_arrays(self, coloring: bool = False,
                      segment_ell: bool = False, delivery_benes=False,
                      segment_benes=False, device=None) -> EdgeArrays:
        """The arrays the edge kernel consumes, on ``device`` (the card
        unless ``'cpu'`` is given).

        ``coloring`` adds the edge coloring (fast synchronous pairwise);
        ``segment_ell`` the degree-bucketed out-edge ELL matrices
        (``segment_impl='ell'``).  ``segment_benes`` and ``delivery_benes``
        are tri-state, as in the JAX package: ``True`` plans the segment
        networks (``segment_impl='benes'``) or the reverse-edge
        permutation (``delivery='benes'``) for the per-stage executor,
        ``"fused"`` for the fused passes (kernels B3 and B4), ``False``
        neither.  A topology with a link model also carries it, for
        ``cfg.contention``: ``link_ser_rounds`` and ``lat_rounds`` as
        float32 (so every ``rint`` decides as the JAX package's does),
        the pad link ``L`` at serialization 0 and not shared, and the
        link-major order of :meth:`Topology.link_csr`."""
        from flow_updating_tpu_torch.utils.device import resolve_device

        self._require_edges("device_arrays")
        dev = resolve_device(device)

        def t(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

        edge_color, num_colors = None, 0
        if coloring:
            col, num_colors = self.edge_coloring()
            edge_color = t(col, torch.int32)
        ell_edge_mats = ell_inv_perm = None
        if segment_ell:
            ell = self.ell_buckets()
            ell_edge_mats = tuple(t(m, torch.int64) for m in ell.edge_mats)
            ell_inv_perm = t(ell.inv_perm, torch.int64)
        seg_plan = seg_dist = None
        seg_extract_masks = seg_place_masks = ()
        if segment_benes:
            seg_plan, dist = self._network("segments",
                                           segment_benes == "fused")
            seg_dist = t(dist, torch.int32)
            seg_extract_masks, seg_place_masks = seg_plan.to(dev)
        rev_plan = delay_rev = None
        rev_masks = ()
        if delivery_benes:
            rev_plan = self._network("rev", delivery_benes == "fused")
            rev_masks = rev_plan.to(dev)
            delay_rev = t(self.delay[self.rev], torch.int32)
        link = {}
        if self.has_link_model:
            gather, lengths = self.link_csr()
            link = dict(
                edge_links=t(self.edge_links, torch.int64),
                link_ser_rounds=t(np.concatenate([self.link_ser_rounds,
                                                  [0.0]]), torch.float32),
                link_shared=t(np.concatenate([self.link_shared, [False]]),
                              torch.bool),
                lat_rounds=t(self.lat_rounds, torch.float32),
                link_gather=t(gather, torch.int64),
                link_lengths=t(lengths, torch.int64))
        return EdgeArrays(
            src=t(self.src, torch.int64), dst=t(self.dst, torch.int64),
            rev=t(self.rev, torch.int64),
            out_deg=t(self.out_deg, torch.int32),
            row_start=t(self.row_start, torch.int64),
            edge_rank=t(self.edge_rank, torch.int32),
            delay=t(self.delay, torch.int32),
            deg_e=t(self.out_deg[self.src], torch.int32),
            drop_perm=(None if self.drop_perm is None
                       else t(self.drop_perm, torch.int64)),
            edge_color=edge_color, num_colors=num_colors,
            ell_edge_mats=ell_edge_mats, ell_inv_perm=ell_inv_perm,
            rev_plan=rev_plan, rev_masks=rev_masks, delay_rev=delay_rev,
            seg_plan=seg_plan, seg_dist=seg_dist,
            seg_extract_masks=seg_extract_masks,
            seg_place_masks=seg_place_masks, **link)


@dataclasses.dataclass(frozen=True)
class EdgeArrays:
    """The edge kernel's per-topology tensors on one device (JAX
    ``TopoArrays``).  Index arrays are int64, the rest int32."""

    src: torch.Tensor
    dst: torch.Tensor
    rev: torch.Tensor
    out_deg: torch.Tensor
    row_start: torch.Tensor
    edge_rank: torch.Tensor
    delay: torch.Tensor
    deg_e: torch.Tensor              # (E,) out_deg[src]: the drain's
    #                                  priority modulus, a topology constant
    drop_perm: torch.Tensor | None = None   # plan edge -> original edge
    edge_color: torch.Tensor | None = None  # fast pairwise coloring
    num_colors: int = 0
    ell_edge_mats: tuple | None = None  # segment_impl='ell'
    ell_inv_perm: torch.Tensor | None = None
    # gather-free delivery (delivery='benes'|'benes_fused')
    rev_plan: object = None          # PaddedPermPlan / FusedPaddedPermPlan
    rev_masks: tuple = ()
    delay_rev: torch.Tensor | None = None   # delay[rev] (static)
    # gather/scatter-free segment ops (segment_impl='benes'|'benes_fused')
    seg_plan: object = None          # ops/seg_benes.SegmentedPlan
    seg_dist: torch.Tensor | None = None    # (P,) int32 edge_rank padded
    seg_extract_masks: tuple = ()
    seg_place_masks: tuple = ()
    # a shard's local view (parallel/sharded.py): the CSR rows cover the
    # first seg_len slots; the rest is padding owned by the dead dummy row
    seg_len: int | None = None
    # link-level contention model (cfg.contention); pad link = L
    edge_links: torch.Tensor | None = None       # (E, K) link ids
    link_ser_rounds: torch.Tensor | None = None  # (L+1,) float32
    link_shared: torch.Tensor | None = None      # (L+1,) bool
    lat_rounds: torch.Tensor | None = None       # (E,) float32
    link_gather: torch.Tensor | None = None      # Topology.link_csr()
    link_lengths: torch.Tensor | None = None
    # a sweep bucket (sweep/pack.py): B padded instances end to end, lane
    # b's nodes and edges at [b*N_pad, (b+1)*N_pad) and [b*E_pad, ...)
    lanes: int = 1
    sweep_edge_rows: torch.Tensor | None = None  # (N, W) out-edge ids in
    #                                  edge order, pad slot = E: every
    #                                  per-node reduction folds its W
    #                                  columns (ops/segment.rows_segment_*)
    num_colors_arr: torch.Tensor | None = None   # the color count as a
    #                                  tensor (0-d, or one per edge in a
    #                                  bucket of lanes with other counts)
    # the adversary's faults on the wire (scenarios/adversary.py); None =
    # the family is absent and the round runs none of its operations.
    # The values are 0-d, or one per node (lie) or edge (gain, window) in
    # a bucket
    adv_lie_mask: torch.Tensor | None = None     # (N,) bool: lying nodes
    adv_lie_value: torch.Tensor | None = None    # the estimate they report
    adv_corrupt_mask: torch.Tensor | None = None  # (E,) bool
    adv_corrupt_gain: torch.Tensor | None = None  # wire-flow multiplier
    adv_silent_mask: torch.Tensor | None = None  # (N,) bool: sends lost
    adv_down_mask: torch.Tensor | None = None    # (E,) bool: sends lost
    adv_down_from: torch.Tensor | None = None    # int32: first dead round
    adv_down_until: torch.Tensor | None = None   # int32: first healed one
    # per-lane reduction modes of the aggregate fabric (aggregates/): a
    # (D,) int32 over the payload lane axis — 0 the additive mean ledger
    # (the plain protocol), 1 max consensus, 2 min consensus.  None = no
    # mode selection and no operation of it in the round; once installed
    # every mode change is a write into the same tensor
    lane_modes: torch.Tensor | None = None

    def replace(self, **kw) -> EdgeArrays:
        return dataclasses.replace(self, **kw)

    @property
    def num_nodes(self) -> int:
        return int(self.out_deg.shape[0])

    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])


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
    adopted = None
    if len(pairs_arr) >= 2_000_000 and not warn_asymmetric:
        # big generator graphs: the C++ builder (the adopted-edge report
        # needs the numpy path).  It skips bad endpoints instead of
        # raising, so the range check comes first.
        if pairs_arr.min() < 0 or pairs_arr.max() >= num_nodes:
            raise ValueError("edge endpoint out of range")
        src, dst, rev, out_deg = native.build_graph_arrays(num_nodes,
                                                           pairs_arr)
        E = len(src)
    else:
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

        # reverse-edge permutation: position of (dst, src) in the sorted
        # list
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
        lat = _edge_values(latency_s, src, dst, num_nodes)
    if bandwidth is not None:
        bw = _edge_values(bandwidth, src, dst, num_nodes)

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
        routes = list(route_links.values())
        K = max((len(v) for v in routes), default=1) or 1
        table = np.full((len(routes) + 1, K), L, np.int32)   # last: none
        for j, lks in enumerate(routes):
            table[j, : len(lks)] = lks
        edge_links_arr = table[_edge_lookup(route_links, src, dst,
                                            num_nodes)]
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


def _edge_lookup(mapping: Mapping, src, dst, num_nodes: int) -> np.ndarray:
    """For each directed edge ``(src[i], dst[i])``, the position among
    ``mapping``'s items of that key, else of ``(dst[i], src[i])``, else
    ``len(mapping)`` — the loop ``mapping.get(key, mapping.get(reversed,
    default))`` over every edge, as sorted-code searches."""
    n = len(mapping)
    keys = np.array(list(mapping.keys()), dtype=np.int64).reshape(-1, 2)
    pos = np.arange(n)
    ok = ((keys >= 0) & (keys < num_nodes)).all(1)   # others match no edge
    codes = keys[ok, 0] * num_nodes + keys[ok, 1]
    order = np.argsort(codes, kind="stable")
    codes, pos = codes[order], pos[ok][order]

    def find(a, b):
        want = a.astype(np.int64) * num_nodes + b.astype(np.int64)
        if not len(codes):
            return np.full(len(want), n)
        at = np.minimum(np.searchsorted(codes, want), len(codes) - 1)
        return np.where(codes[at] == want, pos[at], n)

    fwd = find(src, dst)
    return np.where(fwd < n, fwd, find(dst, src))


def _edge_values(mapping: Mapping, src, dst, num_nodes: int) -> np.ndarray:
    """Per-edge float64 value of a ``{(u, v): value}`` mapping (either
    direction; 0.0 where neither is given)."""
    vals = np.append(np.asarray(list(mapping.values()), np.float64), 0.0)
    return vals[_edge_lookup(mapping, src, dst, num_nodes)]


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


def locality_order(topo: Topology, start: int = 0) -> np.ndarray:
    """BFS node ordering for locality-aware partitioning (JAX
    ``topology/graph.py::locality_order``).

    Contiguous-block sharding (``parallel.sharded.plan_sharding``) cuts
    every edge whose endpoints land in different blocks; renumbering nodes
    by BFS layers first keeps neighborhoods together.  Returns ``order``
    with ``order[new_id] = old_id``, covering all components (a new BFS
    starts at the lowest unvisited node)."""
    N = topo.num_nodes
    visited = np.zeros(N, bool)
    order = np.empty(N, np.int64)
    pos = 0
    frontier = np.array([start], np.int64) if N else np.empty(0, np.int64)
    visited[frontier] = True
    while pos < N:
        if frontier.size == 0:
            nxt = int(np.argmax(~visited))  # lowest unvisited node
            frontier = np.array([nxt], np.int64)
            visited[nxt] = True
        order[pos: pos + frontier.size] = frontier
        pos += frontier.size
        # all neighbors of the frontier, deduped, unvisited only
        lo = topo.row_start[frontier]
        counts = topo.row_start[frontier + 1] - lo
        total = int(counts.sum())
        if total:
            seg = np.repeat(np.arange(frontier.size), counts)
            within = np.arange(total) - np.repeat(
                np.cumsum(counts) - counts, counts)
            idx = topo.dst[lo[seg] + within].astype(np.int64)
        else:
            idx = np.empty(0, np.int64)
        idx = np.unique(idx)
        idx = idx[~visited[idx]]
        visited[idx] = True
        frontier = idx.astype(np.int64)
    return order


def reorder_topology(topo: Topology, order: np.ndarray) -> Topology:
    """Renumber nodes by ``order`` (``order[new_id] = old_id``), rebuilding
    the ``(src, dst)``-sorted edge list, the reverse permutation and the
    CSR rows (JAX ``topology/graph.py::reorder_topology``).  Per-edge
    attributes follow their edges, per-node ones their nodes; ``adopted``
    is dropped.  A cached edge coloring is carried through, so a
    reordered partition fires the same matching sequence as the original
    topology.  The structure descriptor is dropped: it indexes the
    generator's node layout, and would give wrong stencil sums after a
    renumbering."""
    topo._require_edges("reorder_topology")
    N, E = topo.num_nodes, topo.num_edges
    order = np.asarray(order, np.int64)
    inv = np.empty(N, np.int64)
    inv[order] = np.arange(N, dtype=np.int64)
    new_src = inv[topo.src]
    new_dst = inv[topo.dst]
    e_order = np.lexsort((new_dst, new_src))
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
    pick_e = lambda a: None if a is None else a[e_order]  # noqa: E731
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
        membership=(None if topo.membership is None
                    else topo.membership[order].astype(np.int32)),
        bridge_edges=(None if topo.bridge_edges is None
                      else np.sort(e_pos[topo.bridge_edges])),
        structure=None,
    )
    cached = getattr(topo, "_edge_coloring", None)
    if cached is not None:
        col, c = cached
        object.__setattr__(out, "_edge_coloring", (col[e_order], c))
    return out
