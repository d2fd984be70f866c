"""Pod-sharded fat-tree stencil: the structured round over a mesh, with
O(k) traffic.

Counterpart of ``flow_updating_tpu/parallel/structured_sharded.py``
(``Engine(mesh=..., multichip='pod')``).  In a fat tree the hosts, edge
switches and aggregation switches of pod ``p`` touch only each other; the
one term of the round that crosses pods is the core switches' neighbor
sum

    A_core[a, c] = sum_p x_agg[p, a]

(:class:`~flow_updating_tpu_torch.ops.structured.FatTreeStruct`), a sum
over pods of a ``(k/2,)`` partial.  Shard ``s`` of an ``S``-shard mesh
(``S`` divides ``k``) holds pods ``[s k/S, (s+1) k/S)``: their host, edge
and aggregation sections, and its own copy of the (k/2)^2 core section.
A round:

1. each shard, on its own stream: the fire ``avg``, the pod-local stencil
   terms and its ``(k/2,)`` partial (``FatTreeStruct.pod_local_sums``),
   then an event;
2. each shard waits for every shard's event and sums the ``S`` partials
   in shard order, ``((p_0 + p_1) + p_2) + ...``: every shard adds the
   same core term, so the replicated core sections advance bit for bit
   alike (the JAX package's ``psum``, whose order is its own);
3. each shard merges ``S``, ``G`` and ``A``.

``overlap=True`` is the JAX package's overlap schedule: the partial first,
then the pod-local sections' merge and the whole ``G`` merge before the
wait, the core section's merge after it.  Same operations on the same
values, so it equals ``overlap=False`` bit for bit.

A shard's state is one flat tensor per field, its sections in the order
host, edge, agg, core.  The canonical layout is the structured
:class:`~flow_updating_tpu_torch.models.sync.NodeKernel`'s ``(N,)``
vector in the generator's order: :meth:`PodShardedFatTreeKernel.
to_canonical` and :meth:`~PodShardedFatTreeKernel.from_canonical` move
between the two, so a pod archive restores on one device, on another pod
mesh and in the JAX package.  On the host the shards run one after the
other with the same operations.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from flow_updating_tpu_torch.models.config import RoundConfig
from flow_updating_tpu_torch.ops.structured import FatTreeStruct
from flow_updating_tpu_torch.parallel.mesh import Mesh, check_mesh, on_stream
from flow_updating_tpu_torch.topology.graph import Topology
from flow_updating_tpu_torch.utils.metrics import observer_sample

_FIELDS = ("S", "G", "avg_prev", "A_prev")


@dataclasses.dataclass(frozen=True)
class PodState:
    """Per-shard node state: each field holds one flat tensor per shard,
    on that shard's device (sections host, edge, agg, core)."""

    t: int
    S: tuple
    G: tuple
    avg_prev: tuple
    A_prev: tuple


@dataclasses.dataclass(frozen=True, eq=False)
class _Shard:
    device: torch.device
    stream: object           # torch.cuda.Stream | None (host)
    value: torch.Tensor      # (L,) flat sections
    inv_depp1: torch.Tensor
    deg: torch.Tensor
    ready: object            # torch.cuda.Event | None


class PodShardedFatTreeKernel:
    """Fast synchronous collect-all on a fat tree (virtual or
    materialized), sharded by pod over ``mesh``; the mesh's shard count
    must divide ``k``.  ``device`` must agree with the mesh (default: the
    mesh's)."""

    def __init__(self, topo: Topology, cfg: RoundConfig, mesh: Mesh,
                 overlap: bool = False, device=None):
        if not cfg.is_fast_sync_collectall:
            raise ValueError(
                "the pod-sharded stencil covers exactly the fast "
                "synchronous collect-all mode (like kernel='node')")
        if not isinstance(topo.structure, FatTreeStruct):
            raise ValueError(
                "PodShardedFatTreeKernel needs a fat-tree structure "
                "descriptor (topology.structure); got "
                f"{type(topo.structure).__name__}")
        check_mesh(mesh, device)
        self.k = k = topo.structure.k
        self.num_shards = S = mesh.size
        if k % S:
            raise ValueError(
                f"mesh size {S} must divide the fat-tree arity k={k} "
                "(pods shard evenly; pad k or change the mesh)")
        self.topo = topo
        self.cfg = cfg
        self.mesh = mesh
        self.overlap = bool(overlap)
        self.dtype = cfg.torch_dtype
        self.struct = topo.structure
        h = self.struct.half
        self._kb = kb = k // S
        #: local slots: the pod-local sections, then the core section
        self._n_local = kb * h * h + 2 * kb * h
        self.local = self._n_local + h * h

        deg = np.asarray(topo.out_deg, np.float64)
        vals = np.asarray(topo.values, np.float64)
        value = self._scatter(vals)
        inv = self._scatter(1.0 / (deg + 1.0))
        degs = self._scatter(deg)
        shards = []
        for s, (dev, stream) in enumerate(zip(mesh.devices, mesh.streams)):
            put = lambda a, dev=dev: torch.from_numpy(a).to(  # noqa: E731
                dev, self.dtype)
            shards.append(_Shard(
                device=dev, stream=stream, value=put(value[s]),
                inv_depp1=put(inv[s]), deg=put(degs[s]),
                ready=torch.cuda.Event() if dev.type == "cuda" else None))
        self._shards = tuple(shards)

    @property
    def padded_size(self) -> int:
        """Node slots of the canonical layout: no padding."""
        return self.topo.num_nodes

    @property
    def state_shape(self) -> tuple:
        """The shape of an archived state's vectors (canonical)."""
        return (self.topo.num_nodes,)

    # ---- layouts -----------------------------------------------------------
    def _scatter(self, flat) -> list:
        """A canonical ``(N,)`` vector (numpy or tensor) -> each shard's
        flat sections, in the same array library."""
        xh, xe, xa, xc = self.struct.sections(flat)
        cat = np.concatenate if isinstance(flat, np.ndarray) else torch.cat
        kb = self._kb
        return [cat([xh[s * kb:(s + 1) * kb].reshape(-1),
                     xe[s * kb:(s + 1) * kb].reshape(-1),
                     xa[s * kb:(s + 1) * kb].reshape(-1), xc.reshape(-1)])
                for s in range(self.num_shards)]

    def _sections(self, x: torch.Tensor):
        """One shard's flat vector as its four section views."""
        kb, h = self._kb, self.struct.half
        nh = kb * h * h
        return (x[:nh].view(kb, h, h), x[nh:nh + kb * h].view(kb, h),
                x[nh + kb * h:self._n_local].view(kb, h),
                x[self._n_local:].view(h, h))

    def _gather(self, parts) -> torch.Tensor:
        """Each shard's flat vector -> the canonical ``(N,)`` tensor, on the
        first shard's device (the core section from shard 0)."""
        dev = self._shards[0].device
        secs = [self._sections(p.to(dev)) for p in parts]
        return torch.cat(
            [torch.cat([sec[i].reshape(-1) for sec in secs])
             for i in range(3)] + [secs[0][3].reshape(-1)])

    def to_canonical(self, state: PodState):
        """The structured ``NodeKernel``'s state of the same round."""
        from flow_updating_tpu_torch.models.sync import NodeSyncState

        return NodeSyncState(t=state.t, **{
            f: self._gather(getattr(state, f)) for f in _FIELDS})

    def from_canonical(self, ns) -> PodState:
        """A pod state from a structured ``NodeKernel`` state (tensors on
        any device)."""
        return PodState(t=int(ns.t), **{
            f: tuple(p.to(sh.device, self.dtype) for p, sh in zip(
                self._scatter(getattr(ns, f)), self._shards))
            for f in _FIELDS})

    def state_from_numpy(self, leaves: dict) -> PodState:
        """A pod state from canonical ``NodeSyncState`` leaves (``(N,)``
        numpy arrays, as an archive or the JAX package holds them)."""
        from flow_updating_tpu_torch.models.sync import NodeSyncState

        n = self.topo.num_nodes
        vecs = {}
        for f in _FIELDS:
            arr = np.asarray(leaves[f])
            if arr.shape != (n,):
                raise ValueError(
                    f"state leaf {f} has shape {arr.shape}; the pod kernel "
                    f"restores the canonical ({n},) layout")
            vecs[f] = torch.from_numpy(arr)
        return self.from_canonical(NodeSyncState(
            t=int(np.asarray(leaves["t"]).ravel()[0]), **vecs))

    # ---- rounds ------------------------------------------------------------
    def init_state(self) -> PodState:
        z = tuple(torch.zeros_like(sh.value) for sh in self._shards)
        return PodState(t=0, S=z, G=z, avg_prev=z, A_prev=z)

    def _core_column(self, s: int, parts: list) -> torch.Tensor:
        """Shard ``s``'s sum of every shard's partial, in shard order,
        after waiting for them (each partial is kept from reuse until
        this shard's stream has read it)."""
        sh = self._shards[s]
        col = None
        for j, (other, p) in enumerate(zip(self._shards, parts)):
            if j != s and sh.stream is not None:
                sh.stream.wait_event(other.ready)
                p.record_stream(sh.stream)
            p = p.to(sh.device, non_blocking=True)
            col = p if col is None else col + p
        return col

    def _round(self, st: PodState) -> PodState:
        n_loc, h = self._n_local, self.struct.half
        fire = []
        for s, sh in enumerate(self._shards):
            with on_stream(sh.stream):
                avg = (sh.value - st.S[s] + st.A_prev[s]) * sh.inv_depp1
                *local, part = FatTreeStruct.pod_local_sums(
                    *self._sections(avg))
                a_loc = torch.cat([a.reshape(-1) for a in local])
                if sh.ready is not None:
                    sh.ready.record(sh.stream)
                S_loc = G_next = None
                if self.overlap:
                    # the pod-local sections and the whole G merge need
                    # no core term: they go before the wait
                    S_loc = (-st.G[s][:n_loc] - a_loc
                             + sh.deg[:n_loc] * st.avg_prev[s][:n_loc])
                    G_next = -st.S[s] - sh.deg * avg + st.A_prev[s]
                fire.append((avg, a_loc, part, S_loc, G_next))
        parts = [f[2] for f in fire]
        out = {f: [] for f in _FIELDS}
        for s, sh in enumerate(self._shards):
            avg, a_loc, _, S_loc, G_next = fire[s]
            with on_stream(sh.stream):
                a_core = self._core_column(s, parts)[:, None].expand(h, h)
                A = torch.cat([a_loc, a_core.reshape(-1)])
                if self.overlap:
                    S_core = (-st.G[s][n_loc:] - a_core.reshape(-1)
                              + sh.deg[n_loc:] * st.avg_prev[s][n_loc:])
                    S_next = torch.cat([S_loc, S_core])
                else:
                    S_next = -st.G[s] - A + sh.deg * st.avg_prev[s]
                    G_next = -st.S[s] - sh.deg * avg + st.A_prev[s]
            for f, v in zip(_FIELDS, (S_next, G_next, avg, A)):
                out[f].append(v)
        return PodState(t=st.t + 1, **{f: tuple(v) for f, v in out.items()})

    def round_program(self, state, num_rounds: int):
        """``(fn, full_args, n_dynamic)`` for the rounds :meth:`run`
        runs — the cost-attribution hook (:mod:`~flow_updating_tpu_torch.
        obs.profile` runs ``fn`` from a copy of the state), so the profiled
        program IS the plain one."""
        return (self.run, (state, int(num_rounds)), 1)

    def run(self, state: PodState, num_rounds: int) -> PodState:
        """``num_rounds`` rounds from ``state``, which stays as it was.  On
        the card each shard's stream first waits for the caller's stream,
        and at the end the caller's stream waits for every shard's."""
        return self._loop(state, num_rounds)

    def _loop(self, state: PodState, num_rounds: int,
              sample=None) -> PodState:
        """The round loop; ``sample(i, state)`` runs after round ``i``."""
        if num_rounds <= 0:
            return state
        cards = [sh for sh in self._shards if sh.stream is not None]
        for sh in cards:
            sh.stream.wait_stream(torch.cuda.current_stream(sh.device))
        for i in range(num_rounds):
            state = self._round(state)
            if sample is not None:
                sample(i, state)
        for s, sh in enumerate(self._shards):
            if sh.stream is None:
                continue
            caller = torch.cuda.current_stream(sh.device)
            caller.wait_stream(sh.stream)
            for f in _FIELDS:
                getattr(state, f)[s].record_stream(caller)
        return state

    def _partials(self, s: int, state: PodState, spec, mean) -> dict:
        """Shard ``s``'s partial sums of one round's metric row (the
        replicated core section counted on shard 0 only), on its device."""
        sh = self._shards[s]
        est, value = sh.value + state.G[s], sh.value
        if s:
            est, value = est[:self._n_local], value[:self._n_local]
        err = est - mean
        out = {}
        if spec.has("rmse"):
            out["sq"] = (err * err).sum()
        if spec.has("max_abs_err"):
            out["mx"] = err.abs().max()
        if spec.has("mass") or spec.has("mass_residual"):
            out["mass"] = est.sum()
            if spec.has("mass_residual"):
                out["vsum"] = value.sum()
        return out

    def run_telemetry(self, state: PodState, num_rounds: int, spec):
        """Device-resident per-round series with the node kernel's field
        contract: each round every shard writes its partial sums into
        preallocated rows on its device; after the loop they are added in
        shard order on the first shard's device.  Every node fires every
        round (``fired_total = t * n``).  Returns ``(state, series)``."""
        from flow_updating_tpu_torch.obs.telemetry import SeriesRecorder

        if not spec.enabled:
            raise ValueError(
                "telemetry spec is disabled; run run() instead")
        n = self.topo.num_nodes
        recs = [SeriesRecorder(num_rounds) for _ in self._shards]
        means = [torch.tensor(self.topo.true_mean, dtype=self.dtype,
                              device=sh.device) for sh in self._shards]
        t0 = state.t
        wanted = any(spec.has(m) for m in ("rmse", "max_abs_err", "mass",
                                           "mass_residual"))

        def sample(i, st):
            if not wanted:
                return
            for s, sh in enumerate(self._shards):
                with on_stream(sh.stream):
                    recs[s].put(i, self._partials(s, st, spec, means[s]))

        state = self._loop(state, num_rounds, sample)
        for rec, sh in zip(recs, self._shards):
            if sh.stream is not None:   # made on the shard's stream
                for x in rec.tensors():
                    x.record_stream(torch.cuda.current_stream(sh.device))
        dev0 = self._shards[0].device
        parts = [{k: v.to(dev0) for k, v in rec.series().items()}
                 for rec in recs]

        def total(key):
            acc = parts[0][key]
            for p in parts[1:]:
                acc = acc + p[key]
            return acc

        t = torch.arange(t0 + 1, t0 + num_rounds + 1, dtype=torch.int64)
        out = {"t": t}
        if spec.has("rmse"):
            out["rmse"] = torch.sqrt(
                total("sq") / torch.tensor(n, dtype=self.dtype,
                                           device=dev0))
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
        if spec.has("fired_total"):
            out["fired_total"] = t * n
        if spec.has("active"):
            out["active"] = torch.full((num_rounds,), n, dtype=torch.int32)
        return state, out

    # ---- read-back ---------------------------------------------------------
    def estimates(self, state: PodState) -> np.ndarray:
        """``value + G`` per node, in the generator's node order."""
        return self._gather([sh.value + g for sh, g in
                             zip(self._shards, state.G)]).cpu().numpy()

    def last_avg(self, state: PodState) -> np.ndarray:
        return self._gather(state.avg_prev).cpu().numpy()

    def _sample(self, state: PodState, mean: float) -> tuple:
        """(squared error sum, max abs error, mass) over every node, each
        shard reduced on its device (the replicated core section counted
        on shard 0 only): three host numbers a shard."""
        sq = mx = mass = 0.0
        for s, (sh, g) in enumerate(zip(self._shards, state.G)):
            est = sh.value + g
            if s:
                est = est[:self._n_local]
            err = est - mean
            sq += float((err * err).sum())
            mx = max(mx, float(err.abs().max()))
            mass += float(est.sum())
        return sq, mx, mass

    def run_streamed(self, state: PodState, num_rounds: int,
                     observe_every: int, emit) -> PodState:
        """Host-chunked observer with the node kernel's emit record; the
        metrics reduce on the card, so a sample moves three numbers per
        shard, never the ``(N,)`` estimates."""
        if num_rounds % observe_every:
            raise ValueError(
                "num_rounds must be a multiple of observe_every")
        n = self.topo.num_nodes
        mean = self.topo.true_mean
        for _ in range(num_rounds // observe_every):
            state = self.run(state, observe_every)
            if emit is not None:
                sq, mx, mass = self._sample(state, mean)
                emit(observer_sample(state.t, np.sqrt(sq / n), mx, mass,
                                     state.t * n))
        return state

    def _field_row(self, s: int, state: PodState, spec, mean) -> tuple:
        """Shard ``s``'s per-node field row in its flat section layout, on
        its device (the host flattens with :meth:`flatten_field_series`).
        The fat tree tiles exactly (no padding, no churn on this kernel),
        so nothing is masked; every node fires every round."""
        sh = self._shards[s]
        row, err = {}, None
        if any(spec.has(f) for f in ("node_err", "node_mass",
                                     "node_mass_residual",
                                     "node_conv_round")):
            est = sh.value + state.G[s]
            err = est - mean
            if spec.has("node_err"):
                row["node_err"] = err
            if spec.has("node_mass"):
                row["node_mass"] = est
            if spec.has("node_mass_residual"):
                row["node_mass_residual"] = est - sh.value
        if spec.has("node_fired"):
            row["node_fired"] = torch.full(sh.value.shape, state.t,
                                           dtype=torch.int32,
                                           device=sh.device)
        return row, err

    def run_fields(self, state: PodState, num_rounds: int, spec):
        """Per-node field rows every ``spec.stride`` rounds, each shard's
        written into preallocated tensors on its device on its own
        stream.  Returns ``(state, conv, series)``: ``conv`` is one flat
        int32 frontier per shard (``abs(err) <= tol`` per section, as in
        the JAX package), ``series`` holds ``t`` and ``active`` (host
        numbers: the round counter and ``n``) and, per field, one ``(R,
        L)`` tensor per shard (:meth:`flatten_field_series`)."""
        from flow_updating_tpu_torch.models.rounds import frontier_update
        from flow_updating_tpu_torch.obs.telemetry import SeriesRecorder

        if not spec.enabled:
            raise ValueError("field spec is disabled; run run() instead")
        stride = spec.stride
        if num_rounds % stride:
            raise ValueError(
                f"num_rounds={num_rounds} must be a multiple of the "
                f"field stride {stride}")
        n = self.topo.num_nodes
        rows = num_rounds // stride
        recs = [SeriesRecorder(rows) for _ in self._shards]
        means = [torch.tensor(self.topo.true_mean, dtype=self.dtype,
                              device=sh.device) for sh in self._shards]
        conv = [None] * len(self._shards)
        t0 = state.t

        def sample(i, st):
            if (i + 1) % stride:
                return
            for s, sh in enumerate(self._shards):
                with on_stream(sh.stream):
                    row, err = self._field_row(s, st, spec, means[s])
                    if spec.has("node_conv_round"):
                        if conv[s] is None:
                            conv[s] = torch.full(sh.value.shape, -1,
                                                 dtype=torch.int32,
                                                 device=sh.device)
                        conv[s] = frontier_update(conv[s], err, None, st.t,
                                                  spec.tol)
                    if row:
                        recs[s].put((i + 1) // stride - 1, row)

        state = self._loop(state, num_rounds, sample)
        for s, (rec, sh) in enumerate(zip(recs, self._shards)):
            if sh.stream is not None:   # made on the shard's stream
                for x in rec.tensors() + ([conv[s]] if conv[s] is not None
                                          else []):
                    x.record_stream(torch.cuda.current_stream(sh.device))
        parts = [rec.series() for rec in recs]
        out = {"t": torch.arange(t0 + stride, t0 + num_rounds + 1, stride,
                                 dtype=torch.int64),
               "active": torch.full((rows,), n, dtype=torch.int32)}
        for name in parts[0]:
            out[name] = [p[name] for p in parts]
        return state, (conv if spec.has("node_conv_round") else None), out

    def flatten_field_series(self, per_shard) -> np.ndarray:
        """One ``(R, L)`` per-shard series (tensors or arrays) -> ``(R,
        N)`` in the generator's node order: the host, edge and agg
        sections of every shard in pod order, then the replicated core
        section from shard 0."""
        xs = [x.cpu().numpy() if isinstance(x, torch.Tensor)
              else np.asarray(x) for x in per_shard]
        kb, h = self._kb, self.struct.half
        cuts = np.cumsum([kb * h * h, kb * h, kb * h])
        secs = [np.split(x, cuts, axis=1) for x in xs]
        return np.concatenate(
            [sec[i] for i in range(3) for sec in secs] + [secs[0][3]],
            axis=1)

    def flatten_field_final(self, per_shard) -> np.ndarray:
        """One ``(L,)`` per-shard vector (the convergence frontier) ->
        ``(N,)`` in the generator's node order."""
        return self.flatten_field_series(
            [(x.cpu().numpy() if isinstance(x, torch.Tensor)
              else np.asarray(x))[None] for x in per_shard])[0]
