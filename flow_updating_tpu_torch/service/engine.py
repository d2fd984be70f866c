"""The streaming service engine: live aggregation with dynamic membership.

Counterpart of ``flow_updating_tpu/service/engine.py``.  Every other mode
runs a fixed-N batch job; the service keeps the estimate live while
members join, leave and update their values.  It holds one set of
tensors at a fixed capacity ``(n_cap, e_cap)`` on its device and runs
indefinitely in segments of ``segment_rounds`` rounds
(``models/rounds.run_rounds(params=)``), with every membership event an
O(event-size) indexed write into those same tensors between segments:
no leaf ever changes shape, dtype or device.

Layout
------
* **node slots**: ``capacity`` usable slots plus one permanently-dead
  *parking* slot (the last id).  Free slots are mass-neutral ghosts
  (value 0, born dead) handed out lowest id first from a heap.
* **edge slots**: a fixed budget of ``edge_capacity`` directed slots.  A
  free slot is a self-loop on the parking slot (``src == dst == park``,
  ``rev`` itself, ``edge_ok=False``): the park never fires, so a free
  slot's ledger stays exactly zero.
* **reductions** run over the ``(n_cap, W)`` out-edge row matrix
  (``EdgeArrays.sweep_edge_rows``, ``W = degree_budget``, stored column
  major as the sweep packer stores it): each per-node sum folds exactly
  the edge slots a row lists, in column order, so edge membership is data.

Mass accounting across events (the JAX package's contract): ``join`` and
``update`` leave the live residual ``-sum(flow[e] for live src[e])``
unchanged bit for bit; ``leave`` and ``remove_edges`` detach ledger pairs,
moving it by the pairs' antisymmetry deficit, and the protocol heals it.

The engine keeps numpy mirrors of the dynamic topology (``_src``,
``_deg``, ``_rows``, ...) for its host bookkeeping and edits them in
place.  Every device leaf is built from a mirror with a copy: on the CPU a
zero-copy tensor would share the mirror's buffer and apply each event
twice (:mod:`.aliasing` probes this).

``compile_count`` keeps the meaning ``doctor``'s ``service_compile`` rule
judges (at most 1): the port compiles nothing, so it counts the distinct
dispatch signatures — each state, arrays and params leaf's shape, dtype
and device, or ``None``, and the runner — with which :meth:`run` has
dispatched a segment since the engine was built.  It is 1 after the
first segment and stays 1 across any number of events.
"""

from __future__ import annotations

import dataclasses
import hashlib
import heapq

import numpy as np
import torch

from flow_updating_tpu_torch.models.config import (
    COLLECTALL,
    RoundConfig,
    RoundParams,
)
from flow_updating_tpu_torch.obs.metrics import MetricsRegistry
from flow_updating_tpu_torch.obs.spans import SpanRecorder
from flow_updating_tpu_torch.service import membership
from flow_updating_tpu_torch.topology.graph import EdgeArrays
from flow_updating_tpu_torch.topology.padding import (
    bucket_ceil,
    edge_rows,
    mask_ghost_state,
    masked_values,
    pad_topology_to,
)
from flow_updating_tpu_torch.utils.device import resolve_device
from flow_updating_tpu_torch.utils.trace import annotate

SERVICE_EVENTS = ("join", "leave", "update", "add_edge", "remove_edge",
                  "suspend", "resume")


def validate_service_config(cfg: RoundConfig) -> None:
    """The service's config domain: the round programs whose topology
    consumption is fully dynamic (edge membership as data).

    Pairwise modes are rejected — fast pairwise fires a static edge
    coloring and faithful pairwise orders its within-tick scan by the
    static CSR layout, both of which an edge edit would invalidate.
    ``drain > 0`` is rejected for the same reason (the round-robin drain
    priority bakes static per-edge ranks)."""
    if cfg.kernel != "edge":
        raise ValueError(
            "the service engine drives the edge kernel (per-edge state "
            "carries the membership masks); use kernel='edge'")
    if cfg.variant != COLLECTALL:
        raise ValueError(
            "the service engine runs variant='collectall': pairwise "
            "modes bake static per-edge structure (edge coloring / CSR "
            "scan order) that dynamic edge membership would invalidate")
    if cfg.drain != 0:
        raise ValueError(
            "the service engine needs drain=0 (unbounded): the bounded "
            "drain's round-robin priority bakes static per-edge ranks")
    if cfg.delivery not in ("gather", "scatter"):
        raise ValueError(
            f"the service engine runs delivery='gather'|'scatter'; "
            f"{cfg.delivery!r} plans a static permutation network")
    if cfg.segment_impl not in ("auto", "segment"):
        raise ValueError(
            f"the service engine runs segment_impl='auto'|'segment' "
            f"(reductions go through the dynamic row matrix); "
            f"{cfg.segment_impl!r} builds static layouts")
    if cfg.contention:
        raise ValueError(
            "contention needs a static link model; the service's "
            "dynamic edge set has none")


def _leaf_signature(v):
    if isinstance(v, torch.Tensor):
        return (tuple(v.shape), str(v.dtype), str(v.device))
    if isinstance(v, tuple):
        return tuple(_leaf_signature(x) for x in v)
    return v if v is None or isinstance(v, (bool, int, float, str)) \
        else type(v).__name__


def _signature(*trees) -> tuple:
    return tuple(tuple((f.name, _leaf_signature(getattr(t, f.name)))
                       for f in dataclasses.fields(t)) for t in trees)


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy of a tensor (never a view of a CPU tensor's buffer)."""
    a = t.detach().cpu().numpy()
    return a.copy() if t.device.type == "cpu" else a


class ServiceEngine:
    """A live, capacity-padded Flow-Updating engine (module docstring).

    Parameters
    ----------
    topo:
        The initial membership graph (its nodes are members 0..N-1).
    capacity:
        Maximum concurrent members.  One extra hidden slot (the parking
        ghost) is appended, so the padded node axis is ``capacity + 1``.
    degree_budget:
        Per-member out-degree budget W (the row-matrix width).  Defaults
        to the initial max degree; ``add_edges`` beyond a row's budget
        raises.
    edge_capacity:
        Total directed edge slots.  Defaults to an eighth-pow2 rounding
        of the initial edge count plus headroom for the spare node slots.
    config:
        A :class:`RoundConfig` in the service domain
        (:func:`validate_service_config`); default
        ``RoundConfig.fast(variant='collectall')``.
    segment_rounds:
        The segment length; ``run`` advances in whole segments.
    values:
        Optional ``(N,)`` / ``(N, D)`` initial payloads overriding the
        topology's values (vector payloads make every mass quantity
        per-feature).
    device:
        Where the tensors live: the card unless ``'cpu'`` is given.
    """

    def __init__(self, topo, capacity: int, *, degree_budget: int | None
                 = None, edge_capacity: int | None = None,
                 config: RoundConfig | None = None,
                 segment_rounds: int = 32, seed: int = 0, values=None,
                 boundary_samples: bool = True, observe: bool = True,
                 device=None):
        from flow_updating_tpu_torch.models.state import (
            check_payload_values,
            init_state,
        )

        cfg = config or RoundConfig.fast(variant=COLLECTALL)
        validate_service_config(cfg)
        dev = resolve_device(device)
        N, E = topo.num_nodes, topo.num_edges
        if capacity < N:
            raise ValueError(
                f"capacity={capacity} < initial member count {N}")
        if segment_rounds < 1:
            raise ValueError("segment_rounds must be >= 1")
        max_deg = int(topo.out_deg.max()) if N else 0
        W = max(max_deg, 1) if degree_budget is None else int(degree_budget)
        if W < max_deg:
            raise ValueError(
                f"degree_budget={W} < initial max degree {max_deg}")
        n_cap = int(capacity) + 1          # + the parking ghost
        if edge_capacity is None:
            e_cap = bucket_ceil(E + 4 * (capacity - N) + 2)
        else:
            e_cap = int(edge_capacity)
            if e_cap < E:
                raise ValueError(
                    f"edge_capacity={e_cap} < initial edge count {E}")

        padded = pad_topology_to(topo, n_cap, e_cap, spread="last")
        rows = edge_rows(padded, W, e_cap)
        rows[N:] = e_cap        # ghosts + park list nothing: free slots
        #                         never enter any row's reduction
        deg = np.concatenate(
            [topo.out_deg.astype(np.int32),
             np.zeros(n_cap - N, np.int32)])   # live degrees only
        pv = None
        if values is not None:
            vals = np.asarray(values, np.float64)
            check_payload_values(vals, N)
            pv = masked_values(vals, n_cap)
        state = init_state(padded, cfg, seed=seed, values=pv, device=dev)
        state = mask_ghost_state(state, N, E)
        # init_state may wrap the value array without a copy on the host
        state = state.replace(value=state.value.clone())

        self.config = cfg
        self.device = dev
        self.capacity = int(capacity)
        self.degree_budget = W
        self.edge_capacity = e_cap
        self.segment_rounds = int(segment_rounds)
        self.state = state
        self.params = _params(cfg, dev)
        self._n_cap = n_cap
        self._park = n_cap - 1
        # host mirrors of the dynamic topology leaves (the free-list /
        # row-occupancy bookkeeping reads these; device edits mirror them)
        self._src = np.asarray(padded.src, np.int32).copy()
        self._dst = np.asarray(padded.dst, np.int32).copy()
        self._rev = np.asarray(padded.rev, np.int32).copy()
        self._src[E:] = self._park
        self._dst[E:] = self._park
        self._delay = np.asarray(padded.delay, np.int32).copy()
        self._deg = deg.copy()
        self._rows = rows.copy()
        self._member = np.zeros(n_cap, bool)
        self._member[:N] = True
        self.arrays = _service_topo_arrays(
            self._src, self._dst, self._rev, self._deg, self._rows,
            self._delay, dev)
        self._free_nodes = list(range(N, self._park))
        heapq.heapify(self._free_nodes)
        self._free_edges = list(range(E, e_cap))
        heapq.heapify(self._free_edges)
        self._init_bookkeeping(observe)
        if boundary_samples:
            self._sample("init")

    def _init_bookkeeping(self, observe: bool) -> None:
        self._epoch = 0
        self._event_counts = {k: 0 for k in SERVICE_EVENTS}
        self._pending_events = []       # since the last run()
        self.history: list = []         # one record per epoch (run call)
        self._samples: list = []        # boundary telemetry rows
        self._est_cache = None          # (t, est (n_cap,)+F, alive)
        self._signatures: set = set()   # compile_count's witness
        # the flight recorder (obs/metrics.py, obs/spans.py): host-side
        # event/latency accounting plus engine-level spans (recovery)
        self.metrics = MetricsRegistry() if observe else None
        self.spans = SpanRecorder() if observe else None
        self._init_resilience()

    # ---- resilience (flow_updating_tpu_torch.resilience) -----------------
    def _init_resilience(self) -> None:
        self._wal = None            # WriteAheadLog when durability is on
        self._ring = None           # CheckpointRing when durability is on
        self._resil_dir = None
        self._replaying = False     # recovery replay: never re-journal
        self._wal_applied_seq = 0   # last journaled seq reflected in state
        self._recovery = None       # recover()'s evidence block

    def _journal(self, kind: str, args: dict) -> None:
        """Write-ahead: journal the validated event (fsync'd) BEFORE it
        is applied; recovery re-applies journaled-but-unapplied events."""
        if self._wal is not None and not self._replaying:
            self._wal_applied_seq = self._wal.append(kind, args,
                                                     self.clock)
            if self.metrics is not None:
                self.metrics.observe("wal_fsync_seconds",
                                     self._wal.last_fsync_s)

    def enable_durability(self, directory: str, *,
                          checkpoint_every: int = 8, retain: int = 3,
                          fsync: bool = True) -> ServiceEngine:
        """Arm the event WAL + checkpoint ring in ``directory``: every
        subsequent event/run is journaled before it is applied, and a
        ring archive is written every ``checkpoint_every`` segments
        (``retain`` kept).  Recover after a crash with :meth:`recover`."""
        from flow_updating_tpu_torch.resilience.recover import (
            arm_durability,
        )

        arm_durability(self, directory, kind="service",
                       checkpoint_every=checkpoint_every,
                       retain=retain, fsync=fsync)
        return self

    @classmethod
    def recover(cls, directory: str, device=None) -> ServiceEngine:
        """Rebuild the service journaled in ``directory`` on ``device``:
        the newest valid ring checkpoint (a corrupt newest falls back) and
        a WAL replay of every event since — bit for bit the uninterrupted
        run at any kill point, with the evidence in
        :meth:`resilience_block`."""
        from flow_updating_tpu_torch.resilience.recover import recover

        return recover(directory, kind="service", device=device)

    def state_digest(self) -> str:
        """sha256 over every state leaf (in the JAX package's leaf form),
        the dynamic topology mirrors and the free lists: bit-exactness
        in one comparable string."""
        h = hashlib.sha256()
        leaves = self.state.numpy()
        for name in sorted(leaves):
            h.update(name.encode())
            h.update(np.ascontiguousarray(leaves[name]).tobytes())
        for name, arr in (("src", self._src), ("dst", self._dst),
                          ("rev", self._rev), ("deg", self._deg),
                          ("rows", self._rows), ("delay", self._delay),
                          ("member", self._member)):
            h.update(name.encode())
            h.update(np.ascontiguousarray(arr).tobytes())
        h.update(repr(sorted(self._free_nodes)).encode())
        h.update(repr(sorted(self._free_edges)).encode())
        return h.hexdigest()

    def resilience_block(self) -> dict | None:
        """The manifest's ``recovery`` block: live WAL/ring accounting
        plus — after :meth:`recover` — the scan/replay evidence
        (``obs.health.check_recovery`` judges it).  None when
        durability is off."""
        if self._wal is None and self._recovery is None:
            return None
        out = {"dir": self._resil_dir, "kind": "service"}
        if self._recovery is not None:
            out.update(self._recovery)
        if self._wal is not None:
            # live accounting wins over the recovery-time scan (its extra
            # evidence keys survive): doctor's metrics_consistency
            # compares the gauge against same-moment figures
            wal = dict(out.get("wal") or {})
            wal.update(self._wal.block())
            out["wal"] = wal
        if self._ring is not None:
            ring = dict(out.get("ring") or {})
            ring.update(self._ring.block())
            out["ring"] = ring
        return out

    # ---- dispatch accounting ---------------------------------------------
    @property
    def compile_count(self) -> int:
        """Distinct dispatch signatures of :meth:`run`'s segments since
        this engine was built (module docstring): the zero-recompile SLO
        reads 1 after the first segment, whatever the events."""
        return len(self._signatures)

    # ---- views -----------------------------------------------------------
    @property
    def clock(self) -> int:
        """Completed rounds (the state's round counter)."""
        return int(self.state.t)

    @property
    def live_count(self) -> int:
        return int(self.state.alive.sum())

    @property
    def member_count(self) -> int:
        return int(self._member.sum())

    @property
    def feature_shape(self) -> tuple:
        return tuple(self.state.value.shape[1:])

    def live_ids(self) -> np.ndarray:
        return np.where(_host(self.state.alive))[0].astype(np.int32)

    def member_edges(self) -> list:
        """Current undirected member edges as (u, v) pairs, u < v."""
        live = self._src != self._park
        u, v = self._src[live], self._dst[live]
        keep = u < v
        return list(zip(u[keep].tolist(), v[keep].tolist()))

    # ---- event plumbing --------------------------------------------------
    def _log(self, kind: str, **detail) -> None:
        self._event_counts[kind] += 1
        detail["kind"] = kind
        self._pending_events.append(detail)
        self._est_cache = None   # membership changed: staleness resets
        if self.metrics is not None:
            self.metrics.inc("events_total")
            self.metrics.inc(f"events_{kind}_total")

    def _check_member(self, ids, verb: str) -> np.ndarray:
        ids = membership.as_id_array(ids)
        for i in ids:
            i = int(i)
            if i < 0 or i >= self._park or not self._member[i]:
                raise ValueError(
                    f"{verb}: node {i} is not a member "
                    f"(members occupy slots 0..{self._park - 1})")
        return ids

    def _edge_slot_of(self, u: int, v: int) -> int | None:
        """Directed slot u->v, via u's row (O(degree_budget) scan)."""
        for e in self._rows[u]:
            if e != self.edge_capacity and self._dst[e] == v:
                return int(e)
        return None

    def _idx(self, ids):
        """Index lists to int64 tensors on the device in one copy: a flat
        list gives one tensor, a list of equal-length lists their rows."""
        a = torch.tensor(np.asarray(ids, np.int64), dtype=torch.int64,
                         device=self.device)
        return a if a.dim() < 2 else a.unbind(0)

    # ---- membership events ----------------------------------------------
    def join(self, value) -> int:
        """Admit one member with payload ``value`` (scalar, or a
        ``(D,)`` vector matching the service's feature shape).  Returns
        the assigned slot id.  The fresh member has zero flows, so its
        estimate equals its value and the live mass residual is
        unchanged bit for bit.  It starts edgeless — wire it in with
        :meth:`add_edges`."""
        if not self._free_nodes:
            raise RuntimeError(
                f"service at capacity: {self.capacity} node slots, "
                f"{self.member_count} members and no free slot — raise "
                "capacity= at construction")
        v = np.asarray(value, np.float64)
        if v.shape != self.feature_shape:
            raise ValueError(
                f"join value shape {v.shape} != service feature shape "
                f"{self.feature_shape}")
        self._journal("join", {"value": v.tolist()})
        slot = heapq.heappop(self._free_nodes)
        st = self.state
        st.value[slot] = (float(v) if v.ndim == 0 else torch.tensor(
            v, dtype=st.value.dtype, device=self.device))
        st.alive[slot] = True
        st.ticks[slot] = 0
        st.fired[slot] = 0
        st.last_avg[slot] = 0
        self._member[slot] = True
        self._log("join", node=int(slot))
        return int(slot)

    def leave(self, ids) -> ServiceEngine:
        """Graceful departure: detach every incident edge pair (both
        ledger directions zeroed, in-flight on those slots invalidated),
        then free the slot (dead, value 0).  The survivors' mass residual
        changes only by the detached pairs' antisymmetry deficit, and the
        protocol re-converges (the paper's self-healing)."""
        ids = self._check_member(ids, "leave")
        self._journal("leave", {"ids": [int(i) for i in ids]})
        pairs = set()
        for u in ids:
            for e in self._rows[int(u)]:
                if e != self.edge_capacity:
                    pairs.add((min(int(e), int(self._rev[e])),
                               max(int(e), int(self._rev[e]))))
        if pairs:
            self._detach_pairs(sorted(pairs))
        st = self.state
        idx = self._idx(ids)
        st.value[idx] = 0
        st.alive[idx] = False
        st.ticks[idx] = 0
        st.fired[idx] = 0
        st.last_avg[idx] = 0
        for i in ids:
            self._member[int(i)] = False
            heapq.heappush(self._free_nodes, int(i))
            self._log("leave", node=int(i))
        return self

    def update(self, ids, values) -> ServiceEngine:
        """Overwrite members' input values (estimates shift by the same
        delta as values, so the mass residual is unchanged bit for
        bit)."""
        ids = self._check_member(ids, "update")
        vals = np.asarray(values, np.float64)
        want = ids.shape + self.feature_shape
        if vals.shape != want:
            raise ValueError(
                f"update values shape {vals.shape} != {want} "
                f"(one row per id, feature shape {self.feature_shape})")
        self._journal("update", {"ids": [int(i) for i in ids],
                                 "values": vals.tolist()})
        self.state.value[self._idx(ids)] = torch.tensor(
            vals, dtype=self.state.value.dtype, device=self.device)
        for i in ids:
            self._log("update", node=int(i))
        return self

    def suspend(self, ids) -> ServiceEngine:
        """Temporary failure (the paper's crash churn): alive mask off,
        ledgers intact — :func:`membership.set_alive`.  A suspended node
        keeps its slot; :meth:`resume` revives it in place."""
        ids = self._check_member(ids, "suspend")
        self._journal("suspend", {"ids": [int(i) for i in ids]})
        self.state = membership.set_alive(self.state, ids, False)
        for i in ids:
            self._log("suspend", node=int(i))
        return self

    def resume(self, ids) -> ServiceEngine:
        ids = self._check_member(ids, "resume")
        self._journal("resume", {"ids": [int(i) for i in ids]})
        self.state = membership.set_alive(self.state, ids, True)
        for i in ids:
            self._log("resume", node=int(i))
        return self

    # ---- edge events -----------------------------------------------------
    def add_edges(self, pairs) -> ServiceEngine:
        """Add undirected member edges: each (u, v) claims the two lowest
        free edge slots and one free row-matrix column at each endpoint.
        The whole batch is validated first, then applied as one device
        edit — an invalid pair leaves the service untouched.  Added edges
        deliver with unit delay (freed slots are reset to delay 1 at
        detach)."""
        e_sent = self.edge_capacity
        eidx, srcs, dsts, revs = [], [], [], []
        rows_r, rows_c, rows_v = [], [], []
        done = []
        # validate + stage: the touched rows as copies, the slots popped
        # from the free heap (lowest first, as sorting the free list would
        # give them) and pushed back if anything in the batch fails
        staged = {}
        try:
            for u, v in pairs:
                u, v = int(u), int(v)
                if u == v:
                    raise ValueError(f"add_edges: self-loop ({u}, {u})")
                self._check_member([u, v], "add_edges")
                if self._edge_slot_of(u, v) is not None or (u, v) in done \
                        or (v, u) in done:
                    raise ValueError(f"add_edges: edge ({u}, {v}) already "
                                     "present")
                cols = []
                for n in (u, v):
                    row = staged.get(n)
                    if row is None:
                        row = staged[n] = self._rows[n].copy()
                    c = int(np.argmax(row == e_sent))
                    if row[c] != e_sent:
                        raise RuntimeError(
                            f"add_edges: node {n} is at its degree budget "
                            f"({self.degree_budget}) — raise "
                            "degree_budget= at construction")
                    cols.append(c)
                if len(self._free_edges) < 2:
                    raise RuntimeError(
                        f"add_edges: edge capacity {self.edge_capacity} "
                        "exhausted — raise edge_capacity= at construction")
                e1 = heapq.heappop(self._free_edges)
                e2 = heapq.heappop(self._free_edges)
                eidx += [e1, e2]
                staged[u][cols[0]] = e1
                staged[v][cols[1]] = e2
                srcs += [u, v]
                dsts += [v, u]
                revs += [e2, e1]
                rows_r += [u, v]
                rows_c += cols
                rows_v += [e1, e2]
                done.append((u, v))
            if not eidx:
                return self
            self._journal("add_edges", {"pairs": [[u, v] for u, v in done]})
        except BaseException:
            for e in eidx:
                heapq.heappush(self._free_edges, e)
            raise
        # commit: host mirrors ...
        for n, row in staged.items():
            self._rows[n] = row
        for e, s, d, r in zip(eidx, srcs, dsts, revs):
            self._src[e], self._dst[e], self._rev[e] = s, d, r
        for n in srcs:
            self._deg[n] += 1
        for u, v in done:
            self._log("add_edge", u=u, v=v)
        # ... then one batched device edit (one host-to-device copy), into
        # the tensors the round reads (the row matrix through its
        # column-major view)
        ei, src, dst, rev, rr, rc, rv = self._idx(
            [eidx, srcs, dsts, revs, rows_r, rows_c, rows_v])
        ar = self.arrays
        ar.src[ei] = src
        ar.dst[ei] = dst
        ar.rev[ei] = rev
        ar.out_deg.index_add_(0, src, torch.ones(
            len(srcs), dtype=ar.out_deg.dtype, device=self.device))
        ar.sweep_edge_rows.index_put_((rr, rc), rv)
        # freed slots are scrubbed at detach time, so the new edges start
        # with exactly zero ledgers; only the link mask needs flipping
        self.state.edge_ok[ei] = True
        return self

    def remove_edges(self, pairs) -> ServiceEngine:
        """Remove undirected member edges (ledger pair zeroed — mass-
        neutral up to the pair's antisymmetry deficit, see :meth:`leave`).
        Validated as a batch before anything is applied."""
        todo, logs = [], []
        for u, v in pairs:
            u, v = int(u), int(v)
            self._check_member([u, v], "remove_edges")
            e1 = self._edge_slot_of(u, v)
            if e1 is None:
                raise ValueError(f"remove_edges: no edge ({u}, {v})")
            e2 = int(self._rev[e1])
            todo.append((min(e1, e2), max(e1, e2)))
            logs.append((u, v))
        if todo:
            self._journal("remove_edges",
                          {"pairs": [[u, v] for u, v in logs]})
            self._detach_pairs(sorted(set(todo)))
            for u, v in logs:
                self._log("remove_edge", u=u, v=v)
        return self

    def _detach_pairs(self, pairs) -> None:
        """Scrub + park a set of (e, rev e) slot pairs: ledgers, mailbox
        and ring-buffer lanes zeroed (in-flight on a detached edge is
        dropped), row-matrix columns cleared, slots onto the free list,
        delays back to the pad convention (unit: a reused slot never
        inherits an old latency-derived delay)."""
        e_sent = self.edge_capacity
        eidx, rows_r, rows_c = [], [], []
        for e1, e2 in pairs:
            for e in (e1, e2):
                u = int(self._src[e])
                col = int(np.argmax(self._rows[u] == e))
                assert self._rows[u, col] == e, "row matrix out of sync"
                self._rows[u, col] = e_sent
                rows_r.append(u)
                rows_c.append(col)
                self._deg[u] -= 1
                self._src[e] = self._dst[e] = self._park
                self._rev[e] = e
                self._delay[e] = 1
                eidx.append(e)
                heapq.heappush(self._free_edges, e)
        ei, rr, rc = self._idx([eidx, rows_r, rows_c])
        ar = self.arrays
        ar.src[ei] = self._park
        ar.dst[ei] = self._park
        ar.rev[ei] = ei
        ar.delay[ei] = 1
        # a node may lose several edges in one batch: the decrements add
        ar.out_deg.index_add_(0, rr, torch.full(
            (len(rows_r),), -1, dtype=ar.out_deg.dtype, device=self.device))
        ar.sweep_edge_rows[rr, rc] = e_sent
        st = self.state
        for name in ("flow", "est", "recv", "stamp", "edge_ok"):
            getattr(st, name)[ei] = 0
        for name in ("pending_valid", "pending_stamp", "pending_flow",
                     "pending_est", "buf_valid", "buf_flow", "buf_est"):
            getattr(st, name)[:, ei] = 0

    # ---- execution -------------------------------------------------------
    def _estimates_device(self) -> np.ndarray:
        """(n_cap,)+F current estimates on the host (``node_estimates``
        over the row matrix, then one copy)."""
        from flow_updating_tpu_torch.models.rounds import node_estimates

        return _host(node_estimates(self.state, self.arrays))

    def _live_mean(self) -> np.ndarray:
        alive = _host(self.state.alive)
        vals = _host(self.state.value)
        cnt = max(int(alive.sum()), 1)
        return vals[alive].sum(axis=0) / cnt

    def _sample(self, label: str) -> dict:
        """One boundary telemetry row (host side, between segments)."""
        est = self._estimates_device()
        alive = _host(self.state.alive)
        vals = _host(self.state.value)
        live = int(alive.sum())
        a_ex = alive.reshape(alive.shape + (1,) * (est.ndim - 1))
        mass = np.where(a_ex, est, 0).sum(axis=0)
        residual = self._ledger_residual(alive)
        cnt = max(live, 1)
        mean = vals[alive].sum(axis=0) / cnt
        err = est[alive] - mean
        t = self.clock
        row = {
            "label": label,
            "t": t,
            "active": live,
            "rmse": float(np.sqrt(np.mean(err * err))) if live else 0.0,
            "max_abs_err": float(np.max(np.abs(err))) if live else 0.0,
            "mass": np.atleast_1d(mass).tolist(),
            "mass_residual": np.atleast_1d(residual).tolist(),
        }
        self._samples.append(row)
        self._est_cache = (t, est, alive)
        if self.metrics is not None:
            self.metrics.inc("boundary_samples_total")
            gauges = {"live_members": live,
                      "rmse": row["rmse"],
                      "max_abs_err": row["max_abs_err"]}
            if self._wal is not None:
                gauges["wal_last_seq"] = self._wal.last_seq
                gauges["wal_fsync_seconds_total"] = \
                    self._wal.fsync_seconds_total
            if self._ring is not None:
                gauges["checkpoint_writes"] = self._ring.written_total
                gauges["checkpoint_write_seconds_total"] = \
                    self._ring.write_seconds_total
            self.metrics.sample_row(t, **gauges)
        return row

    def run(self, rounds: int, telemetry=None):
        """Advance ``rounds`` (a whole number of segments) as one
        membership epoch.  Events queued since the previous ``run`` are
        bound to this epoch's record, and boundary samples (mass /
        residual / rmse over live members) are taken after the events and
        after the rounds — the doctor's SLO inputs.  No host read happens
        inside a segment.

        ``telemetry``: an optional
        :class:`~flow_updating_tpu_torch.obs.telemetry.TelemetrySpec` —
        each segment then runs the telemetry runner and the per-round
        series is returned; otherwise returns ``self``."""
        from flow_updating_tpu_torch.models.rounds import (
            run_rounds,
            run_rounds_telemetry,
        )

        if rounds < 0:
            raise ValueError("rounds must be >= 0")
        if rounds % self.segment_rounds:
            raise ValueError(
                f"rounds={rounds} must be a whole number of compiled "
                f"segments (segment_rounds={self.segment_rounds}) — the "
                "zero-recompile contract fixes the segment length")
        self._journal("run", {"rounds": int(rounds)})
        events = self._pending_events
        self._pending_events = []
        if events or not self._samples \
                or self._samples[-1]["t"] != self.clock:
            before = self._sample("epoch_start")
        else:
            # no events since the last boundary: the state is the one
            # the previous sample measured
            before = dict(self._samples[-1])
        series_rows = None
        if telemetry is not None and not telemetry.enabled:
            telemetry = None
        for _ in range(rounds // self.segment_rounds):
            if telemetry is None:
                self._signatures.add(("run_rounds",) + _signature(
                    self.state, self.arrays, self.params))
                with annotate("fu.segment"):
                    self.state = run_rounds(
                        self.state, self.arrays, self.config,
                        self.segment_rounds, params=self.params)
            else:
                self._signatures.add(
                    ("run_rounds_telemetry", telemetry.metrics)
                    + _signature(self.state, self.arrays, self.params))
                mean = self._live_mean()
                with annotate("fu.segment"):
                    self.state, seg = run_rounds_telemetry(
                        self.state, self.arrays, self.config,
                        self.segment_rounds, telemetry, mean,
                        params=self.params)
                seg = {k: _host(v) for k, v in seg.items()}
                if series_rows is None:
                    series_rows = {k: [v] for k, v in seg.items()}
                else:
                    for k, v in seg.items():
                        series_rows[k].append(v)
        after = self._sample("epoch_end")
        self.history.append({
            "epoch": self._epoch,
            "rounds": int(rounds),
            "t0": before["t"],
            "t1": after["t"],
            "events": [dict(e) for e in events],
            "live": after["active"],
            "before": {k: before[k] for k in
                       ("rmse", "max_abs_err", "mass", "mass_residual",
                        "active")},
            "after": {k: after[k] for k in
                      ("rmse", "max_abs_err", "mass", "mass_residual",
                       "active")},
        })
        self._epoch += 1
        if self.metrics is not None and rounds:
            self.metrics.inc("runs_total")
            self.metrics.inc("segments_total",
                             rounds // self.segment_rounds)
        if self._ring is not None and rounds:
            # the archive reflects every journaled record up to
            # _wal_applied_seq (this run's record included) — recovery
            # replays only what came after
            wrote = self._ring.tick(self, self._wal_applied_seq,
                                    segments=rounds // self.segment_rounds)
            if wrote and self.metrics is not None:
                self.metrics.inc("checkpoints_written_total")
                self.metrics.observe("checkpoint_write_seconds",
                                     self._ring.last_write_s)
        if series_rows is not None:
            from flow_updating_tpu_torch.obs.telemetry import (
                TelemetrySeries,
            )

            return TelemetrySeries({
                k: np.concatenate(v) for k, v in series_rows.items()})
        return self

    # ---- reads -----------------------------------------------------------
    def estimates(self, max_staleness: int | None = None):
        """Live members' current estimates: ``(ids, values)`` numpy
        arrays.  ``max_staleness=k`` accepts the boundary sample if it is
        at most ``k`` rounds old — a bounded-staleness read that costs no
        device work; ``None`` forces a fresh computation.  Membership
        events always invalidate the sample."""
        cache = self._est_cache
        if (max_staleness is not None and cache is not None
                and self.clock - cache[0] <= max_staleness):
            t, est, alive = cache
        else:
            est = self._estimates_device()
            alive = _host(self.state.alive)
            self._est_cache = (self.clock, est, alive)
        ids = np.where(alive)[0].astype(np.int32)
        return ids, est[alive]

    def _ledger_residual(self, alive: np.ndarray) -> np.ndarray:
        """Per-feature live-mass residual ``sum_alive(est) -
        sum_alive(value)`` in its ledger form ``-sum(flow[e] for live
        src[e])``, a fixed-edge-order masked sum on the host: a ``join``
        adds no edge term and an ``update`` touches no flow, so neither
        moves the residual by a ulp."""
        flow = _host(self.state.flow)
        live_e = alive[self._src]
        mask = live_e.reshape(live_e.shape + (1,) * (flow.ndim - 1))
        return -np.where(mask, flow, 0).sum(axis=0)

    def mass_residual(self) -> np.ndarray:
        """(D,) (or scalar as (1,)) per-feature live-mass residual now
        (the ledger form — see :meth:`_ledger_residual`)."""
        return np.atleast_1d(self._ledger_residual(_host(self.state.alive)))

    def convergence_report(self) -> dict:
        s = self._sample("report")
        flow = _host(self.state.flow)
        anti = flow + flow[self._rev]
        mean = self._live_mean()
        return {
            "t": self.clock,
            "rmse": s["rmse"],
            "max_abs_err": s["max_abs_err"],
            "mass_residual": s["mass_residual"],
            "antisymmetry_residual": float(np.max(np.abs(anti))),
            "live": self.live_count,
            # scalar scale for check_report's tolerance; the per-feature
            # vector rides alongside
            "true_mean": float(np.max(np.abs(mean))),
            "true_mean_per_feature": np.atleast_1d(mean).tolist(),
            "nodes": self.live_count,
        }

    def service_block(self) -> dict:
        """The manifest's ``service`` block: capacity accounting, epoch
        history, dispatch-signature count — the inputs of ``doctor``'s
        service SLO checks (obs/health.check_service)."""
        from flow_updating_tpu_torch.service.aliasing import (
            shared_mirror_report,
        )

        return {
            "capacity": {
                "nodes": self.capacity,
                "edges": self.edge_capacity,
                "degree_budget": self.degree_budget,
                "live": self.live_count,
                "members": self.member_count,
                "free_node_slots": len(self._free_nodes),
                "free_edge_slots": len(self._free_edges),
            },
            "segment_rounds": self.segment_rounds,
            "compile_count": self.compile_count,
            "epochs": [dict(h) for h in self.history],
            "events_total": int(sum(self._event_counts.values())),
            "event_counts": {k: v for k, v in self._event_counts.items()
                             if v},
            "dtype": self.config.dtype,
            "mirror_probe": shared_mirror_report(self),
        }

    def _refresh_obs_gauges(self) -> None:
        """Point-in-time gauges ahead of an export/embed (the sampled
        rows carry the history; these carry *now*)."""
        if self.metrics is None:
            return
        m = self.metrics
        m.set_gauge("live_members", self.live_count)
        m.set_gauge("member_count", self.member_count)
        m.set_gauge("free_node_slots", len(self._free_nodes))
        m.set_gauge("free_edge_slots", len(self._free_edges))
        m.set_gauge("compile_count", self.compile_count)
        if self._wal is not None:
            m.set_gauge("wal_last_seq", self._wal.last_seq)
            m.set_gauge("wal_fsync_seconds_total",
                        self._wal.fsync_seconds_total)
        if self._ring is not None:
            m.set_gauge("checkpoint_writes", self._ring.written_total)
            m.set_gauge("checkpoint_write_seconds_total",
                        self._ring.write_seconds_total)

    def serving_trace_block(self) -> dict | None:
        """The manifest's ``serving_trace`` block
        (``flow-updating-serving-trace/v1``): the flight recorder's
        metrics plane + engine-level spans.  None when observation is
        off."""
        if self.metrics is None:
            return None
        from flow_updating_tpu_torch.obs.report import SERVING_TRACE_SCHEMA

        self._refresh_obs_gauges()
        return {
            "schema": SERVING_TRACE_SCHEMA,
            "slo": {},
            "metrics": self.metrics.block(),
            "spans": (self.spans.block()
                      if self.spans is not None else None),
        }

    def boundary_series(self) -> dict:
        """The boundary samples as a telemetry-shaped series dict (one
        row per segment boundary) — doctor's standard series checks run
        on it unchanged."""
        if not self._samples:
            return {}
        keys = ("t", "rmse", "max_abs_err", "mass", "mass_residual",
                "active")
        return {k: [s[k] for s in self._samples] for k in keys}

    # ---- durability ------------------------------------------------------
    def save_checkpoint(self, path: str,
                        extra_meta: dict | None = None) -> ServiceEngine:
        """Write the full service state — protocol state, dynamic
        topology mirrors, free lists, epoch counters, the flight
        recorder — as one versioned archive (``utils/checkpoint.py``, the
        JAX package's ``service-checkpoint`` layout).  ``extra_meta``
        merges extra JSON blocks into the service meta."""
        from flow_updating_tpu_torch.utils.checkpoint import (
            save_service_checkpoint,
        )

        topo_arrays = {
            "src": self._src, "dst": self._dst, "rev": self._rev,
            "out_deg": self._deg, "rows": self._rows,
            "delay": self._delay,
            "free_nodes": np.asarray(sorted(self._free_nodes), np.int32),
            "free_edges": np.asarray(sorted(self._free_edges), np.int32),
            "member": self._member,
        }
        meta = {
            "capacity": self.capacity,
            "edge_capacity": self.edge_capacity,
            "degree_budget": self.degree_budget,
            "segment_rounds": self.segment_rounds,
            "epoch": self._epoch,
            "event_counts": dict(self._event_counts),
            "observe": self.metrics is not None,
        }
        if self.metrics is not None:
            # the black box rides the archive: a recovered engine's
            # metrics/span planes are continuous with the pre-crash ones
            meta["obs"] = {
                "metrics": self.metrics.state_dict(),
                "spans": (self.spans.state_dict()
                          if self.spans is not None else None),
            }
        if extra_meta:
            meta.update(extra_meta)
        save_service_checkpoint(path, self.state, self.config,
                                topo_arrays, meta)
        return self

    @classmethod
    def restore_checkpoint(cls, path: str, device=None) -> ServiceEngine:
        """Rebuild a service from :meth:`save_checkpoint`'s archive (or
        the JAX package's) on ``device`` — same capacity, same
        membership, bit-exact state."""
        from flow_updating_tpu_torch.service.aliasing import (
            assert_no_shared_mirrors,
        )
        from flow_updating_tpu_torch.utils.checkpoint import (
            load_service_checkpoint,
        )

        dev = resolve_device(device)
        state, cfg, topo_arrays, meta = load_service_checkpoint(
            path, device=dev)
        self = object.__new__(cls)
        self.config = cfg
        self.device = dev
        self.capacity = int(meta["capacity"])
        self.edge_capacity = int(meta["edge_capacity"])
        self.degree_budget = int(meta["degree_budget"])
        self.segment_rounds = int(meta["segment_rounds"])
        self._n_cap = self.capacity + 1
        self._park = self.capacity
        self.state = state
        self._src = topo_arrays["src"].astype(np.int32)
        self._dst = topo_arrays["dst"].astype(np.int32)
        self._rev = topo_arrays["rev"].astype(np.int32)
        self._deg = topo_arrays["out_deg"].astype(np.int32)
        self._rows = topo_arrays["rows"].astype(np.int32)
        self._delay = topo_arrays["delay"].astype(np.int32)
        self._member = topo_arrays["member"].astype(bool)
        self._free_nodes = topo_arrays["free_nodes"].astype(int).tolist()
        heapq.heapify(self._free_nodes)
        self._free_edges = topo_arrays["free_edges"].astype(int).tolist()
        heapq.heapify(self._free_edges)
        self.arrays = _service_topo_arrays(
            self._src, self._dst, self._rev, self._deg, self._rows,
            self._delay, dev)
        self.params = _params(cfg, dev)
        self._init_bookkeeping(bool(meta.get("observe", False)))
        self._epoch = int(meta.get("epoch", 0))
        self._event_counts.update(meta.get("event_counts", {}))
        if self.metrics is not None:
            obs = meta.get("obs") or {}
            self.metrics = MetricsRegistry.load_state(
                obs.get("metrics") or {})
            sp = obs.get("spans")
            self.spans = (SpanRecorder.load_state(sp)
                          if sp is not None else SpanRecorder())
        # a restored engine must never hold device leaves aliasing its
        # host mirrors: fail here, not rounds later as a double-applied
        # event
        assert_no_shared_mirrors(self)
        self._sample("restore")
        return self


def _params(cfg: RoundConfig, device) -> RoundParams:
    params = RoundParams.from_config(cfg, device=device)
    return params.without_drop() if cfg.drop_rate == 0.0 else params


def _service_topo_arrays(src, dst, rev, deg, rows, delay,
                         device) -> EdgeArrays:
    """The service's :class:`EdgeArrays` from its host mirrors, every
    leaf a copy (``torch.tensor`` copies; ``from_numpy`` would alias the
    mirrors on the CPU).

    ``row_start``, ``edge_rank`` and ``deg_e`` are dead under the service
    config domain (their consumers, the bounded drain and the faithful
    pairwise scan, are refused by :func:`validate_service_config`); they
    are rebuilt here so the leaf set is the edge kernel's.  The row
    matrix is stored column major, as the sweep packer stores it, and
    held as its ``(n_cap, W)`` transposed view: an event writes through
    the view into the tensor the row fold gathers from."""
    n_cap = deg.shape[0]
    row_start = np.zeros(n_cap + 1, np.int64)
    np.cumsum(np.bincount(src, minlength=n_cap), out=row_start[1:])
    edge_rank = np.arange(src.shape[0], dtype=np.int64) - row_start[src]

    def t(a, dtype):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    return EdgeArrays(
        src=t(src, torch.int64),
        dst=t(dst, torch.int64),
        rev=t(rev, torch.int64),
        out_deg=t(deg, torch.int32),
        row_start=t(row_start, torch.int64),
        edge_rank=t(edge_rank, torch.int32),
        delay=t(delay, torch.int32),
        deg_e=t(deg[src], torch.int32),
        sweep_edge_rows=t(np.ascontiguousarray(rows.T), torch.int64).t(),
    )
