"""Explicitly scheduled multi-device edge round: the halo kernel.

Counterpart of ``flow_updating_tpu/parallel/sharded.py``
(``Engine(mesh=, multichip='halo')``).  Nodes are partitioned into
contiguous blocks, one per shard; every directed edge lives with its
*source* node's shard, so the segment reductions and the firing decisions
are local.  The only traffic between shards is message delivery on *cut*
edges (edges whose reverse lives on another shard), compiled at plan time
into fixed per-shard send lists and receiver tables; intra-shard edges
deliver with a local scatter, as on one device.

The JAX package runs one round body per shard under ``shard_map``.  Here a
:class:`~flow_updating_tpu_torch.parallel.mesh.Mesh` holds the shards in
one process, each with its own tensors and CUDA stream, and a round is a
Python loop over the shards in two phases — a receiver can only wait on
an event that every sender has already recorded:

1. **every shard**: deliver, fire, the intra-shard scatter, the payload
   blocks of its cut edges; then it records its ``ready`` event;
2. **every shard**: its stream waits on its senders' ``ready`` events,
   brings in their blocks — ``'ppermute'``: one ``(2*nf+1, Hd)`` block
   per plan offset ``d`` from shard ``(s - d) % S``; ``'allgather'``:
   every shard's ``(H,)`` halo block — and scatters them into its ring
   buffers.

Targets are unique (a slot has one sender, its reverse edge), so every
write is pure replacement and the order of the scatters does not matter;
padding rows carry the ``Eb`` sentinel and are dropped.  A block made on
one stream and read on another has that stream recorded on it
(``record_stream``), so the caching allocator does not hand its memory to
a new tensor before the reader has run.  The overlap schedules
(``halo='overlap'|'overlap_pallas'``) are :mod:`.overlap`.

The fast synchronous pairwise mode has its own round
(:func:`_local_round_fastpair`): the cut edges carry the remote
endpoint's current estimate and validity instead of a message; build the
plan with ``plan_sharding(..., coloring=True)``.

:func:`gather_full_state` and :func:`scatter_full_state` move a halo
state to the canonical single-device layout and back (checkpoints), and
the telemetry and field runners (:func:`run_rounds_sharded_telemetry`,
:func:`run_rounds_sharded_fields`, whose per-shard rows
:func:`gather_node_field_series` and :func:`gather_edge_field_series`
bring back to the original node and edge order).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import numpy as np
import torch

from flow_updating_tpu_torch.models.config import RoundConfig
from flow_updating_tpu_torch.models.rounds import (
    _rows,
    deliver_phase,
    fire_core,
)
from flow_updating_tpu_torch.models.state import (
    FlowUpdatingState,
    _ex,
    _feat,
    check_payload_values,
    state_from_numpy as _state_from_numpy,
)
from flow_updating_tpu_torch.ops.segment import segment_max, segment_sum
from flow_updating_tpu_torch.parallel.mesh import Mesh
from flow_updating_tpu_torch.topology.graph import EdgeArrays, Topology
from flow_updating_tpu_torch.utils import prng

#: public cut-edge exchange modes.  'ppermute' and 'allgather' are the
#: serialized oracles; 'overlap' is the interior/frontier-split schedule
#: (parallel/overlap.py) and 'overlap_pallas' the same schedule with
#: kernel B6 pulling the blocks and merging (ops/halo_exchange.py).
HALO_MODES = ("ppermute", "allgather", "overlap", "overlap_pallas")

#: plus the profiling-only interior probe (the overlap schedule with the
#: exchange left out) and the fat-frontier resolution of 'overlap'
#: (overlap.resolve_mode)
_HALO_MODES_INTERNAL = HALO_MODES + ("interior", "overlap_full")


def _check_halo(halo: str, *, _internal: bool = False) -> None:
    if halo in (_HALO_MODES_INTERNAL if _internal else HALO_MODES):
        return
    if halo in _HALO_MODES_INTERNAL:
        raise ValueError(
            f"halo={halo!r} is internal-only (the profiling probe / a "
            f"plan-time schedule resolution), not a correct protocol "
            f"mode: use one of {HALO_MODES}")
    raise ValueError(
        f"unknown halo mode {halo!r}: use one of {HALO_MODES}")


# ---- the plan (host-side numpy tables, equal to the JAX package's) -------

@dataclasses.dataclass(frozen=True)
class PlanArrays:
    """Per-shard tables, stacked on a leading shard axis ``(S, ...)``."""

    src_local: np.ndarray    # (S, Eb) i32 — local source node of each slot
    out_deg: np.ndarray      # (S, Nb) i32 — real out-degree per local node
    row_start: np.ndarray    # (S, Nb+1) i32 — local CSR offsets
    edge_rank: np.ndarray    # (S, Eb) i32 — rank within local src row
    delay: np.ndarray        # (S, Eb) i32 — delivery delay in rounds
    tshard: np.ndarray       # (S, Eb) i32 — shard owning rev(edge)
    tlocal: np.ndarray       # (S, Eb) i32 — rev(edge)'s slot there (Eb = none)
    halo_idx: np.ndarray     # (S, H) i32 — slots of cut edges (Eb = padding)
    edge_color: np.ndarray | None = None  # (S, Eb) i32, -1 on padding
    #                          (iff the plan was built with coloring=True)


@dataclasses.dataclass(frozen=True)
class HaloTables:
    """Routing of the halo entries in all-gather (shard-major) order,
    the same on every shard."""

    tshard: np.ndarray  # (S*H,) i32 — receiving shard (-1 = padding)
    tlocal: np.ndarray  # (S*H,) i32 — slot there (Eb = padding)
    delay: np.ndarray   # (S*H,) i32 — sending edge's delivery delay


@dataclasses.dataclass(frozen=True)
class PermTables:
    """Per-offset point-to-point routing (``halo='ppermute'``): for each
    nonzero shard offset ``d`` that carries a cut edge, shard ``s`` sends
    its cut edges towards shard ``(s+d) % S`` as one dense block."""

    send_idx: tuple      # per offset: (S, Hd) i32 local slots to send (Eb pad)
    recv_tlocal: tuple   # per offset: (S, Hd) i32 receiver slot (Eb pad)
    recv_delay: tuple    # per offset: (S, Hd) i32 sending edge's delay


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """Host-side sharding plan for one topology on S shards."""

    topo: Topology
    num_shards: int
    cap: int            # real nodes per shard (the last may be short)
    Nb: int             # local node count incl. the per-shard dummy (cap + 1)
    Eb: int             # padded edge slots per shard
    H: int              # padded halo (cut-edge) slots per shard
    arrays: PlanArrays
    halo: HaloTables
    values: np.ndarray  # (S, Nb) initial node values (0 on padding)
    alive0: np.ndarray  # (S, Nb) bool initial liveness (False on padding)
    perm_offsets: tuple = ()         # nonzero shard offsets with cut edges
    perm_tables: PermTables | None = None
    num_colors: int = 0              # >0 iff built with coloring=True
    order: np.ndarray | None = None  # partition node order (new -> original
    #                                  id); None = identity
    edge_shard: np.ndarray | None = None  # (E,) owner shard per edge of the
    edge_slot: np.ndarray | None = None   # (reordered) topology, and slot

    @property
    def cut_fraction(self) -> float:
        """Fraction of directed edges whose delivery crosses shards."""
        return float((self.arrays.halo_idx < self.Eb).sum()) / max(
            self.topo.num_edges, 1)

    def collective_bytes_per_round(self, dtype_bytes: int = 4) -> dict:
        """Per-round halo traffic of each wire, in its own format:
        ``allgather`` broadcasts every shard's padded ``(H,)`` block (flow
        and estimate of the ledger dtype plus a 1-byte valid flag) to all
        S shards; ``ppermute`` sends each per-offset block to one peer, 3
        ledger-dtype lanes per entry; the overlap modes move the ppermute
        blocks."""
        S, H = self.num_shards, self.H
        ag_entry = 2 * dtype_bytes + 1
        pp_entry = 3 * dtype_bytes
        sum_hd = sum(int(t.shape[1]) for t in (
            self.perm_tables.send_idx if self.perm_tables else ()))
        pp = S * sum_hd * pp_entry
        return {
            "allgather_bytes": S * S * H * ag_entry,
            "ppermute_bytes": pp,
            "overlap_bytes": pp,
            "cut_edges": int((self.arrays.halo_idx < self.Eb).sum()),
            "cut_fraction": round(self.cut_fraction, 4),
            "num_offsets": len(self.perm_offsets),
        }


def plan_sharding(topo: Topology, num_shards: int,
                  partition: str = "contiguous",
                  coloring: bool = False) -> ShardPlan:
    """Partition nodes into contiguous blocks and edges with their source.

    ``partition='bfs'`` renumbers nodes by BFS order first
    (:func:`~flow_updating_tpu_torch.topology.graph.locality_order`);
    estimates read back through :func:`gather_estimates` are always in the
    caller's original node order.  Local node ``Nb-1`` of every shard is a
    dead dummy that owns the padded edge slots, so padding never fires or
    sends.  ``coloring=True`` colors the ORIGINAL topology before any
    reorder (the reorder carries the coloring through), so fast pairwise
    fires the single-device round's matching sequence."""
    topo._require_edges("plan_sharding (the halo planner)")
    if coloring:
        topo.edge_coloring()
    order = None
    if partition == "bfs":
        from flow_updating_tpu_torch.topology.graph import (
            locality_order,
            reorder_topology,
        )

        order = locality_order(topo)
        topo = reorder_topology(topo, order)
    elif partition != "contiguous":
        raise ValueError(f"unknown partition {partition!r}")
    N, E, S = topo.num_nodes, topo.num_edges, num_shards
    cap = max(1, math.ceil(N / S))
    Nb = cap + 1
    shard_of = topo.src.astype(np.int64) // cap
    local_of = topo.src.astype(np.int64) % cap

    counts = np.bincount(shard_of, minlength=S)
    Eb = max(int(counts.max()) if E else 0, 1)
    starts = np.zeros(S + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    pos = np.arange(E, dtype=np.int64) - starts[shard_of]

    owner_shard = shard_of
    owner_pos = pos
    rev_shard = owner_shard[topo.rev]
    rev_pos = owner_pos[topo.rev]

    src_local = np.full((S, Eb), Nb - 1, np.int32)
    delay = np.ones((S, Eb), np.int32)
    tshard = np.tile(np.arange(S, dtype=np.int32).reshape(S, 1), (1, Eb))
    tlocal = np.full((S, Eb), Eb, np.int32)
    src_local[owner_shard, owner_pos] = local_of
    delay[owner_shard, owner_pos] = topo.delay
    tshard[owner_shard, owner_pos] = rev_shard
    tlocal[owner_shard, owner_pos] = rev_pos

    edge_color = None
    num_colors = 0
    if coloring:
        col, num_colors = topo.edge_coloring()
        edge_color = np.full((S, Eb), -1, np.int32)
        edge_color[owner_shard, owner_pos] = col

    # local CSR (the padded slots all belong to the dummy row at the end)
    out_deg = np.zeros((S, Nb), np.int32)
    np.add.at(out_deg, (owner_shard, local_of), 1)
    row_start = np.zeros((S, Nb + 1), np.int32)
    full_deg = out_deg.copy()
    full_deg[:, Nb - 1] += Eb - counts.astype(np.int32)
    np.cumsum(full_deg, axis=1, out=row_start[:, 1:])
    slot_idx = np.tile(np.arange(Eb, dtype=np.int64), (S, 1))
    edge_rank = (slot_idx - row_start[np.arange(S)[:, None],
                                      src_local]).astype(np.int32)

    # halo send lists: cut-edge slots, padded with the Eb sentinel
    is_cut = (tshard != np.arange(S, dtype=np.int32).reshape(S, 1)) & (
        tlocal < Eb)
    H = max(int(is_cut.sum(axis=1).max()), 1)
    halo_idx = np.full((S, H), Eb, np.int32)
    for s in range(S):
        slots = np.where(is_cut[s])[0]
        halo_idx[s, : len(slots)] = slots

    vals_flat = np.zeros(S * cap, np.float64)
    vals_flat[:N] = topo.values
    alive_flat = np.zeros(S * cap, bool)
    alive_flat[:N] = True
    values = np.zeros((S, Nb), np.float64)
    values[:, :cap] = vals_flat.reshape(S, cap)
    alive0 = np.zeros((S, Nb), bool)
    alive0[:, :cap] = alive_flat.reshape(S, cap)

    hi = np.minimum(halo_idx, Eb - 1)
    h_ok = halo_idx < Eb
    sidx = np.arange(S)[:, None]
    halo = HaloTables(
        tshard=np.where(h_ok, tshard[sidx, hi], -1).astype(np.int32).ravel(),
        tlocal=np.where(h_ok, tlocal[sidx, hi], Eb).astype(np.int32).ravel(),
        delay=np.where(h_ok, delay[sidx, hi], 1).astype(np.int32).ravel(),
    )

    # point-to-point routing: each shard's cut edges grouped by the
    # target-shard OFFSET d = (target - source) mod S
    off_of_cut = np.where(
        is_cut, (tshard - np.arange(S, dtype=np.int32)[:, None]) % S, -1)
    offsets = sorted(int(d) for d in np.unique(off_of_cut) if d > 0)
    send_idx_t, recv_tlocal_t, recv_delay_t = [], [], []
    for d in offsets:
        per_shard = [np.where(off_of_cut[s] == d)[0] for s in range(S)]
        Hd = max(max((len(p) for p in per_shard), default=0), 1)
        sidx_d = np.full((S, Hd), Eb, np.int32)
        for s in range(S):
            sidx_d[s, : len(per_shard[s])] = per_shard[s]
        # receiver-side tables: shard r's row describes what arrives from
        # shard (r - d) % S, in that sender's send order
        rt = np.full((S, Hd), Eb, np.int32)
        rd = np.ones((S, Hd), np.int32)
        for r in range(S):
            s = (r - d) % S
            slots = per_shard[s]
            rt[r, : len(slots)] = tlocal[s, slots]
            rd[r, : len(slots)] = delay[s, slots]
        send_idx_t.append(sidx_d)
        recv_tlocal_t.append(rt)
        recv_delay_t.append(rd)
    perm_tables = PermTables(send_idx=tuple(send_idx_t),
                             recv_tlocal=tuple(recv_tlocal_t),
                             recv_delay=tuple(recv_delay_t))

    arrays = PlanArrays(
        src_local=src_local, out_deg=out_deg, row_start=row_start,
        edge_rank=edge_rank, delay=delay, tshard=tshard, tlocal=tlocal,
        halo_idx=halo_idx, edge_color=edge_color)
    return ShardPlan(
        topo=topo, num_shards=S, cap=cap, Nb=Nb, Eb=Eb, H=H, arrays=arrays,
        halo=halo, values=values, alive0=alive0,
        perm_offsets=tuple(offsets), perm_tables=perm_tables, order=order,
        num_colors=num_colors,
        edge_shard=owner_shard.astype(np.int32),
        edge_slot=owner_pos.astype(np.int32))


# ---- state ----------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardedState:
    """The halo kernel's state: one :class:`FlowUpdatingState` per shard,
    on that shard's device, in the shard's local layout (``(Nb,)`` nodes,
    ``(Eb,)`` edge slots) — the JAX package's ``(S, ...)`` leaves split
    along the shard axis."""

    shards: tuple

    @property
    def t(self) -> int:
        """The round counter (the shards run in lockstep)."""
        return int(self.shards[0].t)

    def numpy(self) -> dict:
        """The JAX ``FlowUpdatingState`` leaves: every field stacked to
        ``(S, ...)``, the key as uint32 words."""
        per = [s.numpy() for s in self.shards]
        return {name: np.stack([p[name] for p in per]) for name in per[0]}


def _check_mesh(plan: ShardPlan, mesh: Mesh) -> None:
    if not isinstance(mesh, Mesh):
        raise TypeError("mesh= takes a flow_updating_tpu_torch.parallel."
                        f"mesh.Mesh (make_mesh), got {type(mesh).__name__}")
    if mesh.size != plan.num_shards:
        raise ValueError(f"the plan has {plan.num_shards} shards but the "
                         f"mesh {mesh.size}")


def _check_round_cfg(plan: ShardPlan, cfg: RoundConfig) -> None:
    if cfg.needs_coloring and plan.num_colors == 0:
        raise ValueError(
            "fast synchronous pairwise needs the edge coloring in the "
            "plan: build it with plan_sharding(..., coloring=True)")
    if cfg.needs_coloring and cfg.robust != "off":
        # the message modes run fire_core (robust included) on each
        # shard's rows; the direct exchange of fast pairwise has its own
        # fire, which the JAX package's halo round also runs without the
        # robust mark — refuse rather than quietly drop it
        raise ValueError(
            f"robust={cfg.robust!r} on the halo round runs in the message "
            "modes (collect-all, faithful pairwise); fast synchronous "
            "pairwise exchanges directly and has no robust form there — "
            "run it single-device")


def init_plan_state(plan: ShardPlan, cfg: RoundConfig, mesh: Mesh,
                    seed: int = 0, values=None) -> ShardedState:
    """Fresh sharded state, each shard's part on its device.  ``values``
    overrides the plan's node values and may be ``(N, D)`` in the
    caller's ORIGINAL node order (vector payloads: the payload leaves
    carry the trailing feature axis).  Shard ``s`` draws its message-loss
    bits from ``fold_in(PRNGKey(seed), s)``, as in JAX."""
    _check_round_cfg(plan, cfg)
    _check_mesh(plan, mesh)
    S, Nb, Eb, D = plan.num_shards, plan.Nb, plan.Eb, cfg.delay_depth
    Q = cfg.pending_depth
    dt = cfg.torch_dtype
    if values is None:
        vals = plan.values
        F = ()
    else:
        values = np.asarray(values, np.float64)
        N = plan.topo.num_nodes
        check_payload_values(values, N)
        F = tuple(values.shape[1:])
        ordered = values[plan.order] if plan.order is not None else values
        flat = np.zeros((S * plan.cap,) + F, np.float64)
        flat[:N] = ordered
        vals = np.zeros((S, Nb) + F, np.float64)
        vals[:, : plan.cap] = flat.reshape((S, plan.cap) + F)
    base = prng.prng_key(seed, device="cpu")
    shards = []
    for s, dev in enumerate(mesh.devices):
        def z(shape, dtype, dev=dev):
            return torch.zeros(shape, dtype=dtype, device=dev)

        shards.append(FlowUpdatingState(
            t=z((), torch.int32),
            value=torch.as_tensor(vals[s], dtype=dt).to(dev),
            flow=z((Eb,) + F, dt), est=z((Eb,) + F, dt),
            recv=z((Eb,), torch.bool), ticks=z((Nb,), torch.int32),
            stamp=z((Eb,), torch.int32), last_avg=z((Nb,) + F, dt),
            fired=z((Nb,), torch.int32),
            alive=torch.as_tensor(plan.alive0[s]).to(dev),
            edge_ok=torch.ones((Eb,), dtype=torch.bool, device=dev),
            pending_flow=z((Q, Eb) + F, dt), pending_est=z((Q, Eb) + F, dt),
            pending_valid=z((Q, Eb), torch.bool),
            pending_stamp=z((Q, Eb), torch.int32),
            buf_flow=z((D, Eb) + F, dt), buf_est=z((D, Eb) + F, dt),
            buf_valid=z((D, Eb), torch.bool),
            key=prng.fold_in(base, s).to(dev)))
    return ShardedState(tuple(shards))


def state_from_numpy(plan: ShardPlan, leaves, mesh: Mesh) -> ShardedState:
    """A sharded state from the JAX halo kernel's ``(S, ...)``
    ``FlowUpdatingState`` leaves as numpy arrays (a mapping or an object
    with those attributes) — a JAX sharded run continues here.  Payloads
    keep their dtype."""
    _check_mesh(plan, mesh)
    get = (leaves.__getitem__ if isinstance(leaves, dict)
           else lambda n: getattr(leaves, n))
    names = [f.name for f in dataclasses.fields(FlowUpdatingState)]
    arrs = {n: np.asarray(get(n)) for n in names}
    S = plan.num_shards
    if (arrs["value"].shape[:2] != (S, plan.Nb)
            or arrs["flow"].shape[:2] != (S, plan.Eb)):
        raise ValueError(
            f"state leaves have value {arrs['value'].shape} and flow "
            f"{arrs['flow'].shape}; this plan's layout is ({S}, "
            f"{plan.Nb}) nodes and ({S}, {plan.Eb}) edge slots — build "
            "both from the same topology, shard count and partition")
    return ShardedState(tuple(
        _state_from_numpy({n: a[s] for n, a in arrs.items()}, device=dev)
        for s, dev in enumerate(mesh.devices)))


# ---- per-shard device tables ------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class ShardArrays:
    """One shard's plan tables on its device, with its streams and events
    (``None`` for a shard on the host)."""

    index: int
    device: torch.device
    stream: object              # torch.cuda.Stream | None
    copy_stream: object         # the 'overlap' wire's copies
    ready: object               # torch.cuda.Event: payload blocks made
    copied: object              # torch.cuda.Event: incoming blocks copied
    local: EdgeArrays           # the shard's local topology view
    tshard: torch.Tensor        # (Eb,) int64
    tlocal: torch.Tensor        # (Eb,) int64
    delay: torch.Tensor         # (Eb,) int32
    halo_idx: torch.Tensor      # (H,) int64
    edge_color: torch.Tensor | None
    num_colors: int
    send_idx: tuple             # per offset (Hd,) int64
    recv_tlocal: tuple          # per offset (Hd,) int64
    recv_delay: tuple           # per offset (Hd,) int32
    halo_tshard: torch.Tensor   # (S*H,) int64, the same on every shard
    halo_tlocal: torch.Tensor
    halo_delay: torch.Tensor    # (S*H,) int32
    ov: object = None           # overlap.OverlapShard | None


def local_view(src, out_deg, row_start, edge_rank, delay, rev,
               device) -> EdgeArrays:
    """A shard's (or a compact frontier's) rows as the
    :class:`EdgeArrays` the round consumes: no ELL or network fields, so
    the reductions run ``torch.segment_reduce`` over the CSR rows.  The
    padded slots are a suffix owned by the dead dummy row, whose real
    out-degree is 0: the reductions cover the real prefix (``seg_len``)
    only, and the padding's reduction is the identity, as its values are
    in the JAX package.  ``dst`` is a placeholder: no local path reads
    it."""
    def t(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device, dtype)

    src = np.asarray(src, np.int64)
    out_deg = np.asarray(out_deg)
    return EdgeArrays(
        src=t(src, torch.int64), dst=t(src, torch.int64),
        rev=t(rev, torch.int64), out_deg=t(out_deg, torch.int32),
        row_start=t(row_start, torch.int64),
        edge_rank=t(edge_rank, torch.int32), delay=t(delay, torch.int32),
        deg_e=t(out_deg[src], torch.int32), seg_len=int(out_deg.sum()))


def _row_sum(x, view: EdgeArrays):
    """Per-row sum of an edge array over ``view``'s real slots."""
    return segment_sum(_rows(x, view), view.out_deg)


def plan_device_arrays(plan: ShardPlan, mesh: Mesh,
                       halo: str | None = None) -> tuple:
    """Each shard's tables on its device (:class:`ShardArrays`, one per
    shard), with one stream, copy stream and pair of events per shard on
    the card.  The overlap split tables are built only when ``halo`` is an
    overlap mode (or None = mode unknown)."""
    from flow_updating_tpu_torch.parallel import overlap as _ovl

    _check_mesh(plan, mesh)
    a, h, pm = plan.arrays, plan.halo, plan.perm_tables
    ov = (_ovl.build_overlap(plan)
          if halo is None or halo in _ovl.OVERLAP_MODES else None)
    out = []
    for s, (dev, stream) in enumerate(zip(mesh.devices, mesh.streams)):
        def t(x, dtype, dev=dev):
            return torch.from_numpy(np.ascontiguousarray(x)).to(dev, dtype)

        card = dev.type == "cuda"
        out.append(ShardArrays(
            index=s, device=dev, stream=stream,
            copy_stream=torch.cuda.Stream(device=dev) if card else None,
            ready=torch.cuda.Event() if card else None,
            copied=torch.cuda.Event() if card else None,
            local=local_view(a.src_local[s], a.out_deg[s], a.row_start[s],
                             a.edge_rank[s], a.delay[s], a.tlocal[s], dev),
            tshard=t(a.tshard[s], torch.int64),
            tlocal=t(a.tlocal[s], torch.int64),
            delay=t(a.delay[s], torch.int32),
            halo_idx=t(a.halo_idx[s], torch.int64),
            edge_color=(None if a.edge_color is None
                        else t(a.edge_color[s], torch.int32)),
            num_colors=plan.num_colors,
            send_idx=tuple(t(x[s], torch.int64) for x in pm.send_idx),
            recv_tlocal=tuple(t(x[s], torch.int64) for x in pm.recv_tlocal),
            recv_delay=tuple(t(x[s], torch.int32) for x in pm.recv_delay),
            halo_tshard=t(h.tshard, torch.int64),
            halo_tlocal=t(h.tlocal, torch.int64),
            halo_delay=t(h.delay, torch.int32),
            ov=None if ov is None else _ovl.overlap_shard(ov, s, dev)))
    return tuple(out)


# ---- helpers shared with the overlap schedule ---------------------------

def _on(stream):
    return (contextlib.nullcontext() if stream is None
            else torch.cuda.stream(stream))


def _lanes(x: torch.Tensor) -> torch.Tensor:
    """Payload -> wire lanes: ``(H,)`` -> ``(1, H)``; a vector payload's
    ``(H, F)`` -> ``(F, H)``, so features ride the same block."""
    return x.T if x.dim() > 1 else x[None]


def _unlanes(m: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_lanes`, shaped like payload ``ref``."""
    return m.T if ref.dim() > 1 else m[0]


def _scatter(buf: torch.Tensor, slot: torch.Tensor, tgt: torch.Tensor,
             val) -> torch.Tensor:
    """``buf.at[slot, tgt].set(val, mode='drop')``: targets equal to the
    slot count ``Eb`` are dropped (they land in a pad column)."""
    pad = torch.cat([buf, buf[:, :1]], 1)
    pad[slot.long(), tgt] = val
    return pad[:, : buf.shape[1]]


def _bring(block: torch.Tensor, sender: ShardArrays,
           receiver: ShardArrays, stream=None) -> torch.Tensor:
    """A sender's block made usable on the receiver's ``stream`` (its
    main stream by default): the stream waits on the sender's ``ready``
    event; a block on another card is copied over on that stream."""
    stream = receiver.stream if stream is None else stream
    if stream is None:
        return block
    stream.wait_event(sender.ready)
    block.record_stream(stream)
    if block.device != receiver.device:
        with torch.cuda.stream(stream):
            return block.to(receiver.device, non_blocking=True)
    return block


def _record(a: ShardArrays) -> None:
    if a.ready is not None:
        a.ready.record(a.stream)


def _msg_blocks(flow, msg_est, send_mask, send_idx, Eb: int) -> list:
    """The wire blocks of the message modes: per offset ``[flow lanes;
    estimate lanes; valid]``, ``(2*nf+1, Hd)``, gathered at ``send_idx``
    (a slot of the ``Eb`` given, ``Eb`` = padding)."""
    dt = flow.dtype
    out = []
    for sidx in send_idx:
        in_r = sidx < Eb
        slc = torch.clamp(sidx, max=Eb - 1)
        v = (send_mask[slc] & in_r).to(dt)
        out.append(torch.cat([_lanes(flow[slc]), _lanes(msg_est[slc]),
                              v[None]]))
    return out


def _finish_blocks(got, a: ShardArrays, t, D: int, Eb: int, ref,
                   buf_flow, buf_est, buf_valid):
    """Scatter the received message blocks into the cut edges' ring
    buffer slots (``recv_tlocal`` at ``(t + delay) % D``)."""
    nf = _feat(ref)
    for di, g in enumerate(got):
        rv = g[2 * nf] > 0.5
        rt = a.recv_tlocal[di]
        slot_r = (t + a.recv_delay[di]) % D
        tgt2 = torch.where(rv & (rt < Eb), rt, Eb)
        buf_flow = _scatter(buf_flow, slot_r, tgt2, _unlanes(g[:nf], ref))
        buf_est = _scatter(buf_est, slot_r, tgt2,
                           _unlanes(g[nf:2 * nf], ref))
        buf_valid = _scatter(buf_valid, slot_r, tgt2, True)
    return buf_flow, buf_est, buf_valid


def _local_deliver(st: FlowUpdatingState, a: ShardArrays, msg_est,
                   send_mask, D: int, Eb: int):
    """Intra-shard delivery: the plain local scatter of the one-device
    kernel, into the receiver slot ``tlocal`` at ``(t + delay) % D``."""
    slot = (st.t + a.delay) % D
    local_ok = send_mask & (a.tshard == a.index)
    tgt = torch.where(local_ok, a.tlocal, Eb)
    return (_scatter(st.buf_flow, slot, tgt, st.flow),
            _scatter(st.buf_est, slot, tgt, msg_est),
            _scatter(st.buf_valid, slot, tgt, True))


def _fastpair_blocks(x_u, valid_u, send_idx, Eb: int) -> list:
    """The fast-pairwise wire blocks: per offset ``[x_u lanes; valid]``,
    ``(nf+1, Hd)``, gathered at ``send_idx`` (``Eb`` = padding)."""
    dt = x_u.dtype
    out = []
    for sidx in send_idx:
        in_r = sidx < Eb
        slc = torch.clamp(sidx, max=Eb - 1)
        out.append(torch.cat([_lanes(x_u[slc]),
                              (valid_u[slc] & in_r).to(dt)[None]]))
    return out


def _arrive(tgt, vals, x_v, valid_v, Eb: int):
    """Merge partner values arriving at slots ``tgt`` (``Eb`` = none)."""
    F = x_v.shape[1:]
    arrived = _scatter(torch.zeros((1, Eb), dtype=torch.bool,
                                   device=x_v.device),
                       torch.zeros_like(tgt), tgt, True)[0]
    xin = _scatter(torch.zeros((1, Eb) + F, dtype=x_v.dtype,
                               device=x_v.device),
                   torch.zeros_like(tgt), tgt, vals)[0]
    return (torch.where(_ex(arrived, x_v), xin, x_v),
            valid_v | arrived)


def _fastpair_partner(st: FlowUpdatingState, a: ShardArrays, x_u, valid_u,
                      Eb: int):
    """Partner state through the local reverse slot (cut slots are
    filled from the wire afterwards)."""
    is_local = (a.tshard == a.index) & (a.tlocal < Eb)
    lr = torch.clamp(a.tlocal, max=Eb - 1)
    x_v = torch.where(_ex(is_local, x_u), x_u[lr], 0.0)
    valid_v = is_local & valid_u[lr]
    return x_v, valid_v


def _fastpair_fire(st: FlowUpdatingState, a: ShardArrays, x_u, x_v,
                   valid_u, valid_v) -> FlowUpdatingState:
    """The matched 2-party averages of one fast-pairwise round (the
    single-device branch of ``fire_core`` on the shard's slots)."""
    t = st.t
    view = a.local
    matched = ((a.edge_color == t % a.num_colors) & valid_u & valid_v)
    m_ex = _ex(matched, x_u)
    avg_e = (x_u + x_v) * 0.5
    flow = torch.where(m_ex, st.flow + (x_u - x_v) * 0.5, st.flow)
    est_e = torch.where(m_ex, avg_e, st.est)
    stamp = torch.where(matched, t, st.stamp)
    fire_any = segment_max(_rows(matched.to(torch.int32), view),
                           view.out_deg) > 0
    node_avg = _row_sum(torch.where(m_ex, avg_e, 0.0), view)
    last_avg = torch.where(_ex(fire_any, node_avg), node_avg, st.last_avg)
    return st.replace(t=t + 1, flow=flow, est=est_e, stamp=stamp,
                      last_avg=last_avg,
                      fired=st.fired + fire_any.to(torch.int32))


def _fastpair_own(st: FlowUpdatingState, a: ShardArrays):
    """Each slot's own endpoint: current estimate and sender-side
    validity."""
    src = a.local.src
    est_n = st.value - _row_sum(st.flow, a.local)
    return est_n[src], st.alive[src] & st.edge_ok


# ---- the serialized round bodies ----------------------------------------

def _local_round(states, arrs, cfg: RoundConfig, Eb: int, offsets: tuple,
                 halo_mode: str, masks: list | None = None) -> tuple:
    """One message-mode round of every shard with a serialized wire
    (``'ppermute'`` or ``'allgather'``).  ``masks`` (a list) receives each
    shard's ``(processed, send_mask)``, the telemetry counters."""
    S, D = len(states), cfg.delay_depth
    made = []
    for st, a in zip(states, arrs):
        with _on(a.stream):
            st, processed = deliver_phase(st, a.local, cfg)
            st, msg_est, send_mask = fire_core(st, a.local, cfg, processed)
            if masks is not None:
                masks.append((processed, send_mask))
            bufs = _local_deliver(st, a, msg_est, send_mask, D, Eb)
            if halo_mode == "ppermute":
                blocks = _msg_blocks(st.flow, msg_est, send_mask,
                                     a.send_idx, Eb)
            else:
                hidx = torch.clamp(a.halo_idx, max=Eb - 1)
                blocks = (send_mask[hidx] & (a.halo_idx < Eb),
                          st.flow[hidx], msg_est[hidx])
            _record(a)
        made.append((st, bufs, blocks))
    out = []
    for r, a in enumerate(arrs):
        st, (bf, be, bv), _ = made[r]
        t = st.t
        with _on(a.stream):
            if halo_mode == "ppermute":
                got = [_bring(made[(r - d) % S][2][di], arrs[(r - d) % S], a)
                       for di, d in enumerate(offsets)]
                bf, be, bv = _finish_blocks(got, a, t, D, Eb, st.flow,
                                            bf, be, bv)
            else:
                a_valid, a_flow, a_est = (torch.cat([
                    _bring(made[s][2][i], arrs[s], a) for s in range(S)])
                    for i in range(3))
                a_slot = (t + a.halo_delay) % D
                mine = a_valid & (a.halo_tshard == r)
                tgt2 = torch.where(mine, a.halo_tlocal, Eb)
                bf = _scatter(bf, a_slot, tgt2, a_flow)
                be = _scatter(be, a_slot, tgt2, a_est)
                bv = _scatter(bv, a_slot, tgt2, True)
            out.append(st.replace(t=t + 1, buf_flow=bf, buf_est=be,
                                  buf_valid=bv))
    return tuple(out)


def _local_round_fastpair(states, arrs, cfg: RoundConfig, Eb: int,
                          offsets: tuple, halo_mode: str,
                          masks: list | None = None) -> tuple:
    """One fast-synchronous-pairwise round of every shard, serialized
    wire.  Round ``t`` fires color class ``t % C``; matched endpoints
    average directly.  The cut edges carry ``x_u`` and the sender-side
    validity, so each edge sees its remote endpoint's current estimate;
    both shards of a cut pair compute the same average from the same
    ``(x_u, x_v)``, so the flow deltas are exactly antisymmetric.  The
    direct exchange drains and sends no messages: ``masks`` receives
    ``(None, None)`` per shard (zero counters, as in the single-device
    fast pairwise round)."""
    S = len(states)
    if masks is not None:
        masks.extend([(None, None)] * S)
    made = []
    for st, a in zip(states, arrs):
        with _on(a.stream):
            x_u, valid_u = _fastpair_own(st, a)
            if halo_mode == "ppermute":
                blocks = _fastpair_blocks(x_u, valid_u, a.send_idx, Eb)
            else:
                hidx = torch.clamp(a.halo_idx, max=Eb - 1)
                blocks = (x_u[hidx], valid_u[hidx] & (a.halo_idx < Eb))
            _record(a)
        made.append((x_u, valid_u, blocks))
    out = []
    for r, (st, a) in enumerate(zip(states, arrs)):
        x_u, valid_u, _ = made[r]
        nf = _feat(x_u)
        with _on(a.stream):
            x_v, valid_v = _fastpair_partner(st, a, x_u, valid_u, Eb)
            if halo_mode == "ppermute":
                for di, d in enumerate(offsets):
                    s = (r - d) % S
                    g = _bring(made[s][2][di], arrs[s], a)
                    rt = a.recv_tlocal[di]
                    tgt = torch.where(g[nf] > 0.5, torch.clamp(rt, max=Eb),
                                      Eb)
                    x_v, valid_v = _arrive(tgt, _unlanes(g[:nf], x_u), x_v,
                                           valid_v, Eb)
            else:
                a_x, a_ok = (torch.cat([_bring(made[s][2][i], arrs[s], a)
                                        for s in range(S)])
                             for i in range(2))
                mine = a_ok & (a.halo_tshard == r)
                tgt = torch.where(mine, a.halo_tlocal, Eb)
                x_v, valid_v = _arrive(tgt, a_x, x_v, valid_v, Eb)
            out.append(_fastpair_fire(st, a, x_u, x_v, valid_u, valid_v))
    return tuple(out)


def _round_dispatch(states, arrs, cfg: RoundConfig, Eb: int, offsets: tuple,
                    halo_mode: str, masks: list | None = None) -> tuple:
    """One round of every shard for any halo mode: the serialized oracles
    run the bodies above, the overlap modes the interior/frontier-split
    schedule (:mod:`.overlap`)."""
    from flow_updating_tpu_torch.parallel import overlap as _ovl

    if halo_mode in _ovl.OVERLAP_MODES:
        body = (_ovl.local_round_overlap_fastpair if cfg.needs_coloring
                else _ovl.local_round_overlap)
    else:
        body = (_local_round_fastpair if cfg.needs_coloring
                else _local_round)
    return body(states, arrs, cfg, Eb, offsets, halo_mode, masks)


def run_rounds_sharded(state: ShardedState, plan: ShardPlan,
                       cfg: RoundConfig, mesh: Mesh, num_rounds: int,
                       arrays: tuple | None = None,
                       halo: str = "ppermute", *,
                       _internal: bool = False) -> ShardedState:
    """Run ``num_rounds`` sharded rounds.

    ``halo`` selects the cut-edge exchange: ``'ppermute'`` (point to
    point, O(cut) traffic), ``'allgather'`` (broadcast), ``'overlap'``
    (the interior/frontier-split schedule, the blocks copied on each
    shard's copy stream while the interior runs) or ``'overlap_pallas'``
    (the same schedule, kernel B6 pulling the blocks and merging the
    intra-shard deliveries in one launch).  All four give the same state
    bit for bit.  ``_internal=True`` admits the profiling probe
    ``'interior'`` and the plan-time ``'overlap_full'``.

    On the card each shard's stream first waits for the caller's stream,
    and at the end the caller's stream waits for every shard's, so what
    the caller reads next is final."""
    return _run_sharded(state, plan, cfg, mesh, num_rounds, arrays, halo,
                        _internal)


def _run_sharded(state: ShardedState, plan: ShardPlan, cfg: RoundConfig,
                 mesh: Mesh, num_rounds: int, arrays, halo: str,
                 _internal: bool = False, sample=None) -> ShardedState:
    """The sharded round loop; ``sample(i, states, masks, arrays)`` runs
    after round ``i`` with each shard's ``(processed, send_mask)``."""
    from flow_updating_tpu_torch.parallel import overlap as _ovl

    _check_round_cfg(plan, cfg)
    _check_halo(halo, _internal=_internal)
    if cfg.contention:
        raise NotImplementedError(
            "contention is single-device (per-round link flow counts are "
            "a global reduction; fidelity runs are platform-scale)")
    _check_mesh(plan, mesh)
    halo = _ovl.resolve_mode(plan, halo)
    if arrays is None or (halo in _ovl.OVERLAP_MODES
                          and arrays[0].ov is None):
        arrays = plan_device_arrays(plan, mesh, halo=halo)
    cards = [a for a in arrays if a.stream is not None]
    for a in cards:
        a.stream.wait_stream(torch.cuda.current_stream(a.device))
    states = state.shards
    for i in range(int(num_rounds)):
        masks = [] if sample is not None else None
        states = _round_dispatch(states, arrays, cfg, plan.Eb,
                                 plan.perm_offsets, halo, masks)
        if sample is not None:
            sample(i, states, masks, arrays)
    for a in cards:
        caller = torch.cuda.current_stream(a.device)
        caller.wait_stream(a.stream)
        for f in dataclasses.fields(FlowUpdatingState):
            getattr(states[a.index], f.name).record_stream(caller)
    return ShardedState(tuple(states))


def _halo_partials(st: FlowUpdatingState, a, spec, mean, processed,
                   send_mask) -> dict:
    """One shard's partial sums for one round's metric row, on its device
    (no host read).  Padding rows are dead dummies (alive=False, value
    0), so the alive mask leaves them out."""
    out = {"t": st.t}
    alive = st.alive
    if any(spec.has(m) for m in ("rmse", "max_abs_err", "mass",
                                 "mass_residual")):
        est = st.value - _row_sum(st.flow, a.local)
        a_ex = _ex(alive, est)
        if spec.has("rmse") or spec.has("max_abs_err"):
            err = torch.where(a_ex, est - mean, 0.0)
            if spec.has("rmse"):
                out["sq"] = (err * err).sum()
            if spec.has("max_abs_err"):
                out["mx"] = err.abs().max()
        if spec.has("mass") or spec.has("mass_residual"):
            out["mass"] = torch.where(a_ex, est, 0.0).sum(0)
            if spec.has("mass_residual"):
                out["vsum"] = torch.where(_ex(alive, st.value), st.value,
                                          0.0).sum(0)
    if spec.has("rmse") or spec.has("active"):
        out["alive"] = alive.sum(dtype=torch.int32)
    for name, m in (("sent", send_mask), ("delivered", processed)):
        if spec.has(name):
            out[name] = (m.sum(dtype=torch.int32) if m is not None else
                         torch.zeros((), dtype=torch.int32, device=a.device))
    if spec.has("fired_total"):
        out["fired_total"] = st.fired.sum(dtype=torch.int64)
    return out


def run_rounds_sharded_telemetry(state: ShardedState, plan: ShardPlan,
                                 cfg: RoundConfig, mesh: Mesh,
                                 num_rounds: int, spec, true_mean,
                                 arrays: tuple | None = None,
                                 halo: str = "ppermute"):
    """Telemetry twin of :func:`run_rounds_sharded`: the same rounds, each
    followed by every shard's partial sums written into preallocated rows
    on its device; after the loop the partials are added in shard order
    (on the first shard's device), so the series does not depend on
    stream timing.  Every metric but ``antisymmetry`` (a shard's reverse
    edges live on other shards).  Returns ``(state, {metric: (R, ...)
    tensor})``."""
    from flow_updating_tpu_torch.obs.telemetry import SeriesRecorder

    if not spec.enabled:
        raise ValueError(
            "telemetry spec is disabled; run run_rounds_sharded() instead")
    if spec.has("antisymmetry"):
        raise ValueError(
            "antisymmetry is not measurable on the halo kernel (a "
            "shard's reverse edges live on other shards)")
    recs = [SeriesRecorder(num_rounds) for _ in mesh.devices]
    means = [torch.tensor(true_mean, dtype=st.value.dtype, device=st.value
                          .device) for st in state.shards]

    def sample(i, states, masks, arrs):
        for s, (st, a, (pr, sm)) in enumerate(zip(states, arrs, masks)):
            with _on(a.stream):
                recs[s].put(i, _halo_partials(st, a, spec, means[s], pr,
                                              sm))

    state = _run_sharded(state, plan, cfg, mesh, num_rounds, arrays, halo,
                         sample=sample)
    for rec, dev in zip(recs, mesh.devices):
        if dev.type == "cuda":
            caller = torch.cuda.current_stream(dev)
            for t in rec.tensors():
                t.record_stream(caller)
    dev0 = mesh.devices[0]
    parts = [{k: v.to(dev0) for k, v in rec.series().items()}
             for rec in recs]

    def total(key):
        acc = parts[0][key]
        for p in parts[1:]:
            acc = acc + p[key]
        return acc

    first = state.shards[0].value
    out = {"t": parts[0]["t"]}
    if spec.has("rmse"):
        cnt = (torch.clamp(total("alive"), min=1)
               * _feat(first)).to(first.dtype)
        out["rmse"] = torch.sqrt(total("sq") / cnt)
    if spec.has("max_abs_err"):
        mx = parts[0]["mx"]
        for p in parts[1:]:
            mx = torch.maximum(mx, p["mx"])
        out["max_abs_err"] = mx
    if spec.has("mass") or spec.has("mass_residual"):
        mass = total("mass")
        if spec.has("mass"):
            out["mass"] = mass
        if spec.has("mass_residual"):
            out["mass_residual"] = mass - total("vsum")
    for name in ("sent", "delivered", "fired_total"):
        if spec.has(name):
            out[name] = total(name)
    if spec.has("active"):
        out["active"] = total("alive")
    return state, out


def _halo_field_sample(st: FlowUpdatingState, a, spec, mean) -> tuple:
    """One recorded per-node/per-edge field row on one shard, in its
    local block layout, on its device (no host read).  The node estimate
    is ``value - segment_sum(flow)`` over the shard's CSR rows, the
    reduction the halo telemetry uses; padding rows are dead dummies, so
    the alive mask leaves them out.  Returns ``(row, err)``; ``active``
    is the shard's count, added over shards after the loop."""
    from flow_updating_tpu_torch.models.rounds import _pool_sum

    row = {"t": st.t, "active": st.alive.sum(dtype=torch.int32)}
    err = None
    if any(spec.has(f) for f in ("node_err", "node_mass",
                                 "node_mass_residual", "node_conv_round")):
        est = st.value - _row_sum(st.flow, a.local)
        a_ex = _ex(st.alive, est)
        err = torch.where(a_ex, est - mean, 0.0)
        if spec.has("node_err"):
            row["node_err"] = err
        if spec.has("node_mass"):
            row["node_mass"] = torch.where(a_ex, est, 0.0)
        if spec.has("node_mass_residual"):
            row["node_mass_residual"] = torch.where(a_ex, est - st.value,
                                                    0.0)
    if spec.has("node_fired"):
        row["node_fired"] = st.fired.to(torch.int32)
    if spec.has("edge_flow"):
        row["edge_flow"] = _pool_sum(st.flow)
    if spec.has("edge_est"):
        row["edge_est"] = _pool_sum(st.est)
    if spec.has("edge_stale"):
        row["edge_stale"] = (st.t - st.stamp).to(torch.int32)
    return row, err


def run_rounds_sharded_fields(state: ShardedState, plan: ShardPlan,
                              cfg: RoundConfig, mesh: Mesh,
                              num_rounds: int, spec, true_mean,
                              arrays: tuple | None = None,
                              halo: str = "ppermute"):
    """Fields twin of :func:`run_rounds_sharded_telemetry`: the same
    rounds, and after every ``spec.stride``-th each shard writes its
    local field row into preallocated tensors on its device, on its own
    stream.  Returns ``(state, conv_round, series)``: ``conv_round`` is
    one ``(Nb,)`` int32 frontier per shard; ``series`` holds ``t`` (shard
    0's), ``active`` (the shards' counts added in shard order after the
    loop) and, per field, one ``(R/stride, Nb|Eb, ...)`` tensor per shard
    — still blocked: :func:`gather_node_field_series` and
    :func:`gather_edge_field_series` reassemble them."""
    from flow_updating_tpu_torch.models.rounds import frontier_update
    from flow_updating_tpu_torch.obs.telemetry import SeriesRecorder

    if not spec.enabled:
        raise ValueError(
            "field spec is disabled; run run_rounds_sharded() instead")
    stride = spec.stride
    if num_rounds % stride:
        raise ValueError(
            f"num_rounds={num_rounds} must be a multiple of the field "
            f"stride {stride}")
    recs = [SeriesRecorder(num_rounds // stride) for _ in mesh.devices]
    means = [torch.tensor(true_mean, dtype=st.value.dtype,
                          device=st.value.device) for st in state.shards]
    conv = [None] * len(recs)

    def sample(i, states, masks, arrs):
        if (i + 1) % stride:
            return
        for s, (st, a) in enumerate(zip(states, arrs)):
            with _on(a.stream):
                row, err = _halo_field_sample(st, a, spec, means[s])
                if spec.has("node_conv_round"):
                    if conv[s] is None:
                        conv[s] = torch.full(st.alive.shape, -1,
                                             dtype=torch.int32,
                                             device=a.device)
                    conv[s] = frontier_update(conv[s], err, st.alive, st.t,
                                              spec.tol)
                recs[s].put((i + 1) // stride - 1, row)

    state = _run_sharded(state, plan, cfg, mesh, num_rounds, arrays, halo,
                         sample=sample)
    for s, (rec, dev) in enumerate(zip(recs, mesh.devices)):
        if dev.type == "cuda":
            caller = torch.cuda.current_stream(dev)
            for t in rec.tensors() + ([conv[s]] if conv[s] is not None
                                      else []):
                t.record_stream(caller)
    parts = [rec.series() for rec in recs]
    dev0 = mesh.devices[0]
    active = parts[0]["active"]
    for p in parts[1:]:
        active = active + p["active"].to(dev0)
    out = {"t": parts[0]["t"], "active": active}
    for name in parts[0]:
        if name not in ("t", "active"):
            out[name] = [p[name] for p in parts]
    return state, (conv if spec.has("node_conv_round") else None), out


def _stacked(x) -> np.ndarray:
    """Per-shard blocks (a sequence of tensors or arrays) or one stacked
    array -> one ``(S, ...)`` numpy array."""
    if isinstance(x, (tuple, list)):
        return np.stack([v.cpu().numpy() if isinstance(v, torch.Tensor)
                         else np.asarray(v) for v in x])
    return np.asarray(x)


def gather_node_field_series(x, plan: ShardPlan) -> np.ndarray:
    """A per-node field series, one ``(R, Nb, ...)`` block per shard (or
    their ``(S, R, Nb, ...)`` stack) -> ``(R, N, ...)`` in the caller's
    original node order (drops the dummy row and the tail padding, undoes
    any partition reorder)."""
    x = _stacked(x)
    R, rest = x.shape[1], x.shape[3:]
    x = np.moveaxis(x[:, :, : plan.cap], 0, 1).reshape(
        (R, plan.num_shards * plan.cap) + rest)[:, : plan.topo.num_nodes]
    if plan.order is None:
        return x.copy()
    out = np.empty_like(x)
    out[:, plan.order] = x
    return out


def gather_edge_field_series(x, plan: ShardPlan, orig_topo) -> np.ndarray:
    """A per-edge field series, one ``(R, Eb)`` block per shard (or their
    ``(S, R, Eb)`` stack) -> ``(R, E)`` in ``orig_topo``'s edge order
    (through the plan's edge ownership map)."""
    es, ep = _edge_slots(plan, orig_topo)
    return _stacked(x)[es, :, ep].T


# ---- read-back ----------------------------------------------------------

def gather_estimates(state: ShardedState, plan: ShardPlan) -> np.ndarray:
    """Per-node estimates in the caller's ORIGINAL node order: each
    shard's ``value - segment_sum(flow)`` over its local CSR rows, then
    the block layout and any partition reorder undone on the host."""
    N = plan.topo.num_nodes
    est = []
    for s, st in enumerate(state.shards):
        deg = torch.from_numpy(plan.arrays.out_deg[s]).to(st.flow.device)
        flow = st.flow[: int(plan.arrays.out_deg[s].sum())]
        est.append((st.value - segment_sum(flow, deg)).cpu().numpy())
    est = np.stack(est)
    F = est.shape[2:]
    return _unpermute(est[:, : plan.cap].reshape((-1,) + F)[:N], plan)


def gather_node_array(x, plan: ShardPlan) -> np.ndarray:
    """Unpad a per-shard node array — a sequence of ``(Nb, ...)`` tensors
    or arrays, or one ``(S, Nb, ...)`` array — back to the original
    global node order (trailing feature axes pass through)."""
    if isinstance(x, (tuple, list)):
        x = np.stack([v.cpu().numpy() if isinstance(v, torch.Tensor)
                      else np.asarray(v) for v in x])
    x = np.asarray(x)
    N = plan.topo.num_nodes
    return _unpermute(x[:, : plan.cap].reshape((-1,) + x.shape[2:])[:N],
                      plan)


def _unpermute(x: np.ndarray, plan: ShardPlan) -> np.ndarray:
    if plan.order is None:
        return x.copy()
    out = np.empty_like(x)
    out[plan.order] = x
    return out


# ---- the canonical single-device layout (checkpoints) ---------------------

_NODE_LEAVES = ("value", "ticks", "last_avg", "fired", "alive")
_EDGE_LEAVES = ("flow", "est", "recv", "stamp", "edge_ok")
_PLANE_LEAVES = ("pending_flow", "pending_est", "pending_valid",
                 "pending_stamp", "buf_flow", "buf_est", "buf_valid")


def _edge_map_to_original(plan: ShardPlan, orig_topo) -> np.ndarray:
    """(E,) map: ORIGINAL edge index -> index into the plan's (possibly
    BFS-reordered) global edge order.  Identity when no reorder."""
    if plan.order is None:
        return np.arange(plan.topo.num_edges, dtype=np.int64)
    # reordered edge r = (src', dst') is the original pair
    # (order[src'], order[dst']); locate it in the original sorted list
    rt, ot = plan.topo, orig_topo
    o_src = plan.order[rt.src.astype(np.int64)]
    o_dst = plan.order[rt.dst.astype(np.int64)]
    keys = ot.src.astype(np.int64) * ot.num_nodes + ot.dst
    want = o_src * ot.num_nodes + o_dst
    pos = np.searchsorted(keys, want)
    # clip before the equality probe: an out-of-range key must surface as
    # the diagnostic below, not an IndexError
    probe = np.minimum(pos, len(keys) - 1)
    if not np.array_equal(keys[probe], want):
        raise ValueError("plan topology is not a renumbering of the "
                         "original (edge sets differ)")
    # pos[r] = original index of reordered edge r; invert
    inv = np.empty_like(pos)
    inv[pos] = np.arange(len(pos), dtype=np.int64)
    return inv


def _edge_slots(plan: ShardPlan, orig_topo) -> tuple:
    """(shard, slot) of every edge of ``orig_topo``, in its order."""
    if plan.edge_shard is None:
        raise ValueError("plan lacks the edge ownership map")
    e_of_orig = _edge_map_to_original(plan, orig_topo)
    return plan.edge_shard[e_of_orig], plan.edge_slot[e_of_orig]


def gather_full_state(state: ShardedState, plan: ShardPlan,
                      orig_topo: Topology) -> FlowUpdatingState:
    """The halo state as a CANONICAL single-device
    :class:`FlowUpdatingState` on the host, in ``orig_topo``'s node and
    edge order — the layout ``init_state`` produces, so it checkpoints and
    restores through the standard path and resumes on any execution mode.
    The PRNG key collapses to shard 0's, as in the JAX package: a run with
    message loss does not continue its loss draws bit for bit across
    layouts (:func:`scatter_full_state` folds each shard's key from it)."""
    es, ep = _edge_slots(plan, orig_topo)
    host = state.numpy()                       # (S, ...) leaves
    out = {n: gather_node_array(host[n], plan) for n in _NODE_LEAVES}
    out.update({n: host[n][es, ep] for n in _EDGE_LEAVES})
    # (S, K, Eb, F...)[es, :, ep] is (E, K, F...): planes are (K, E, F...)
    out.update({n: np.moveaxis(host[n][es, :, ep], 0, 1)
                for n in _PLANE_LEAVES})
    out["t"] = host["t"].ravel()[0]
    out["key"] = host["key"][0]
    return _state_from_numpy(out, device="cpu")


def scatter_full_state(state, plan: ShardPlan, orig_topo: Topology,
                       cfg: RoundConfig, mesh: Mesh) -> ShardedState:
    """Inverse of :func:`gather_full_state`: distribute a canonical
    single-device state (a :class:`FlowUpdatingState` on any device, or
    its numpy leaves by name with the key as uint32 words) into the
    plan's per-shard layout, each shard on its device.  Padding slots take
    :func:`init_plan_state`'s values (dead dummies, zero ledgers, links
    up); shard ``i``'s key is ``fold_in(key, i)``.  No fresh state is
    made first: the shards are assembled on the host and copied once."""
    _check_round_cfg(plan, cfg)
    _check_mesh(plan, mesh)
    canon = (state.numpy() if isinstance(state, FlowUpdatingState)
             else {n: np.asarray(a) for n, a in state.items()})
    es, ep = _edge_slots(plan, orig_topo)
    S, cap, Nb, Eb = plan.num_shards, plan.cap, plan.Nb, plan.Eb
    N = orig_topo.num_nodes
    # node arrays: original order -> partition order -> (S, cap) blocks
    norder = (plan.order if plan.order is not None
              else np.arange(N, dtype=np.int64))

    def node(x):
        F = x.shape[1:]
        flat = np.zeros((S * cap,) + F, x.dtype)
        flat[:N] = x[norder]
        out = np.zeros((S, Nb) + F, x.dtype)
        out[:, :cap] = flat.reshape((S, cap) + F)
        return out

    def edge(x, fill=0):
        out = np.full((S, Eb) + x.shape[1:], fill, x.dtype)
        out[es, ep] = x
        return out

    def planes(x):
        out = np.zeros((S, x.shape[0], Eb) + x.shape[2:], x.dtype)
        out[es, :, ep] = np.moveaxis(x, 0, 1)
        return out

    blocks = {n: node(canon[n]) for n in _NODE_LEAVES}
    blocks.update({n: edge(canon[n], fill=n == "edge_ok")
                   for n in _EDGE_LEAVES})
    blocks.update({n: planes(canon[n]) for n in _PLANE_LEAVES})
    blocks["t"] = np.full((S,), int(np.asarray(canon["t"]).ravel()[0]),
                          np.int32)
    key = torch.from_numpy(
        np.asarray(canon["key"]).astype(np.uint32).astype(np.int64))
    # per-shard independent streams, like init_plan_state
    blocks["key"] = np.stack([prng.fold_in(key, s).numpy()
                              for s in range(S)]).astype(np.uint32)
    return ShardedState(tuple(
        _state_from_numpy({n: a[s] for n, a in blocks.items()}, device=dev)
        for s, dev in enumerate(mesh.devices)))
