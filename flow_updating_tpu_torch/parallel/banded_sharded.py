"""Sharded one-kernel banded round: kernel B5 per shard and a ring-halo
exchange.

Counterpart of ``flow_updating_tpu/parallel/banded_sharded.py``.  After
RCM reordering the plan's bandwidth ``H`` bounds every edge's
``|dst - src|``, so a contiguous block partition of the node axis needs
only ``H`` elements of ``avg`` from each ring neighbor per round.  Each
shard keeps its constants and state on its own device (a
:class:`~flow_updating_tpu_torch.parallel.mesh.Mesh`) and runs one round
as B5 launches on its own stream (``ops/sharded_round.py``).  A state
carries the ``avg`` its round reads (:class:`ShardedNodeState`): the
merges of each round fire the next one, and a fire-only launch runs where
a state is made (:meth:`ShardedBandedKernel.init_state`,
:meth:`~ShardedBandedKernel.state_from_numpy`).  A round:

1. **ready** — an event on the shard's stream, after the launches that
   wrote this round's ``avg``;
2. **exchange** — on the shard's copy stream, after that event: its first
   ``H`` elements of ``avg`` go to the left neighbor's ``recv_hi``, its
   last ``H`` to the right neighbor's ``recv_lo`` (a ring; the wrapped
   blocks are never selected by a mask, but are copied so the window
   holds what the oracle's window holds);
3. **interior** (``exchange='pallas'``) — the merge of tile-rows
   ``[Hr, R - Hr)``, whose reads stay on the shard, while the copies run;
4. **boundary** — after waiting on the two incoming copies, one launch
   over the remaining rows, both ends of the shard (``exchange=
   'ppermute'``: all rows, the serialized schedule).

Each merge writes ``S'``, ``G'``, ``A`` and the next round's ``avg`` for
its rows.  The shard's two ``avg`` buffers alternate by round parity:
round ``r`` writes buffer ``(r + 1) % 2``, which holds round ``r - 1``'s
``avg`` — this round's ``avg_prev``, read by the same thread at the same
rows before it is overwritten — and the next round reads it.  States are
values, as in the JAX package: :meth:`ShardedBandedKernel.run` reads the
state's own ``avg`` and ``avg_prev`` in its first round (its merges write
only the other buffer), and the state it returns owns clones of the last
round's two buffers.  That is two ``L``-sized copies a shard per ``run``
call and none per round, so a retained state runs again, reads back its
own round and is never changed by a later run.

The stream order, which no flag checks:

* *Receive blocks*, double-buffered by round parity.  Round ``r+2``'s
  copy into a block can only start after the sender's round ``r+2``
  ready event, which on the sender's stream follows its round ``r+1``
  boundary merge, which waited on the receiver's round ``r+1`` copy,
  which followed the receiver's round ``r+1`` ready event and so its
  round ``r`` boundary merge — the last reader of that block.
* *The avg buffers* (write after read across streams).  Round ``r``'s
  copies read the head and tail of buffer ``r % 2`` on the copy stream;
  round ``r+1``'s merges write that buffer on the shard's stream.  The
  interior merge writes neither the head nor the tail (its rows start and
  end ``H`` from the shard's ends).  The boundary merge of round ``r+1``
  waits on the neighbors' round ``r+1`` copies, which follow the
  neighbors' round ``r+1`` ready events, which follow the neighbors'
  round ``r`` boundary merges, which waited on this shard's round ``r``
  copies.  So every write of the head and tail follows the copies that
  read them, whatever the shard count (with two shards the left and the
  right neighbor are one shard).
* *Around a run.*  Every shard's stream first waits for the caller's
  stream; at the end the caller's stream waits for every shard's stream,
  whose boundary merges followed every copy, and clones the last round's
  ``avg`` buffers there.  So the first round of a run, which reads the
  state's own tensors and writes buffer ``(t + 1) % 2``, follows every
  read of an earlier run, and the fire of a new state (on the caller's
  stream, into a tensor of its own) follows the last run's copies too.

On the CPU both exchanges run the same schedule with the plain versions
and ``copy_`` between host tensors.

Scope, as in the JAX package: the fast synchronous collect-all mode,
scalar payloads, plans whose remainder is 'gather' (inlined per shard) or
'none'.  Wire bytes: ``2 * H * dtype_bytes`` per shard per round.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from flow_updating_tpu_torch.models.config import RoundConfig
from flow_updating_tpu_torch.ops.fused_round import (
    FusedRoundSpec,
    _rem_window_index,
    pack_band_planes,
)
from flow_updating_tpu_torch.ops.sharded_round import (
    LANE,
    ShardedRoundLeaves,
    ShardedRoundSpec,
    plan_sharded_round,
    row_ranges,
    sharded_fire,
    sharded_round,
)
from flow_updating_tpu_torch.parallel.mesh import Mesh, check_mesh, on_stream
from flow_updating_tpu_torch.topology.graph import Topology

EXCHANGES = ("pallas", "ppermute")


@dataclasses.dataclass(frozen=True)
class ShardedNodeState:
    """Per-shard node state: each field holds one ``(local,)`` tensor per
    shard, on that shard's device — the JAX kernel's ``(S, L)`` leaves, and
    ``avg``, the fire of ``S`` and ``A_prev`` that the next round reads.
    The state owns every tensor: no later round writes them."""

    t: int
    S: tuple
    G: tuple
    avg_prev: tuple
    A_prev: tuple
    avg: tuple

    def to_numpy(self) -> dict:
        """The JAX ``NodeSyncState`` leaves: ``t`` and ``(S, L)`` arrays."""
        out = {"t": self.t}
        for name in ("S", "G", "avg_prev", "A_prev"):
            out[name] = np.stack([v.cpu().numpy()
                                  for v in getattr(self, name)])
        return out


@dataclasses.dataclass(frozen=True, eq=False)
class _Shard:
    """One shard's constants, receive blocks, copy stream and events."""

    device: torch.device
    stream: object              # torch.cuda.Stream | None (host)
    copy_stream: object
    value: torch.Tensor         # (L,)
    inv_depp1: torch.Tensor
    deg: torch.Tensor
    leaves: ShardedRoundLeaves
    recv: tuple                 # per round parity: (recv_lo, recv_hi)
    avg: tuple                  # per round parity: the avg that round reads
                                # (after a run's first round)
    ready: object               # torch.cuda.Event | None
    copied: object


class ShardedBandedKernel:
    """Node-collapsed fast collect-all over a mesh, the banded plan run as
    kernel B5 per shard.  Mirrors :class:`~flow_updating_tpu_torch.models.
    sync.NodeKernel`'s recurrence: equal to the single-device banded
    executor on plans whose remainder rows hold one edge, and to the JAX
    package's ``ppermute`` oracle.

    ``exchange='pallas'`` overlaps the halo copies with the interior
    merge; ``'ppermute'`` copies, waits and merges every row (the JAX
    package's names).  ``device`` must agree with the mesh (default: the
    mesh's)."""

    def __init__(self, topo: Topology, cfg: RoundConfig, mesh: Mesh,
                 plan=None, exchange: str = "pallas", device=None):
        from flow_updating_tpu_torch.models import sync
        from flow_updating_tpu_torch.plan.compile import (
            _topo_key,
            compile_topology,
        )

        sync._check_cfg(cfg)
        if cfg.spmv != "banded_fused":
            raise ValueError(
                "ShardedBandedKernel is the spmv='banded_fused' mesh path")
        if exchange not in EXCHANGES:
            raise ValueError(
                f"unknown exchange {exchange!r}: 'pallas' (halo copies "
                "overlapped with the interior merge) or 'ppermute' (the "
                "serialized schedule)")
        vals = topo.values
        if vals is not None and getattr(vals, "ndim", 1) > 1:
            raise ValueError(
                "the sharded fused round is scalar-payload (vector "
                "payloads run the single-device banded kernels)")
        check_mesh(mesh, device)
        S = mesh.size
        if S < 2:
            raise ValueError("the sharded fused round needs >= 2 shards")
        self.topo = topo
        self.cfg = cfg
        self.mesh = mesh
        self.exchange = exchange
        self.dtype = cfg.torch_dtype

        if plan is None:
            # the per-shard remainder is an in-kernel gather; a
            # self-compiled plan must not route it through Beneš lanes
            plan = compile_topology(topo, remainder="gather")
        if plan.source_key and plan.source_key != _topo_key(topo):
            raise ValueError(
                "execution plan was compiled from a different topology "
                "(edge-content fingerprint mismatch) — recompile with "
                "plan.compile_topology(topo)")
        if plan.spmv.rem_mode == "benes":
            raise ValueError(
                "the sharded fused round inlines a gather remainder per "
                "shard; this plan routes its remainder through global "
                "Beneš lanes — recompile with compile_topology(topo, "
                "remainder='gather')")
        self.plan = plan
        self.spec = spec = plan_sharded_round(
            plan.spmv, int(plan.stats.get("bandwidth_after", 0)), S)
        self.padded_size = M = spec.P
        n = topo.num_nodes
        self._perm = np.asarray(plan.order, np.int64)

        value = np.zeros(M, np.float64)
        deg = np.zeros(M, np.float64)
        value[:n] = np.asarray(topo.values, np.float64)[self._perm]
        deg[:n] = topo.out_deg[self._perm]
        L = spec.local
        planes = self._band_planes(spec)
        stacked = (np.stack(planes) if planes
                   else np.zeros((0, M), np.uint32)).view(np.int32)
        rem = (self._rem_window_index(spec)
               if spec.rem_route == "inline" else None)
        offsets = torch.tensor(spec.offsets, dtype=torch.int32)
        shards = []
        for s, (dev, stream) in enumerate(zip(mesh.devices, mesh.streams)):
            sl = slice(s * L, (s + 1) * L)
            put = lambda a, dt=self.dtype, dev=dev: torch.tensor(  # noqa: E731
                np.ascontiguousarray(a), dtype=dt, device=dev)
            card = dev.type == "cuda"
            shards.append(_Shard(
                device=dev, stream=stream,
                copy_stream=torch.cuda.Stream(device=dev) if card else None,
                value=put(value[sl]), inv_depp1=put(1.0 / (deg[sl] + 1.0)),
                deg=put(deg[sl]),
                leaves=ShardedRoundLeaves(
                    planes=put(stacked[:, sl], torch.int32),
                    offsets=offsets.to(dev),
                    rem_idx=None if rem is None else put(rem[sl],
                                                         torch.int32)),
                recv=tuple(tuple(torch.zeros(spec.halo, dtype=self.dtype,
                                             device=dev) for _ in range(2))
                           for _ in range(2)),
                avg=tuple(torch.zeros(L, dtype=self.dtype, device=dev)
                          for _ in range(2)),
                ready=torch.cuda.Event() if card else None,
                copied=torch.cuda.Event() if card else None))
        self._shards = tuple(shards)

    def _band_planes(self, spec: ShardedRoundSpec) -> list:
        """Global bitpacked band-mask planes, ``(P,)`` uint32 per group
        (the single-device packer, shared)."""
        return pack_band_planes(self.plan.leaves.band_masks, spec.P,
                                spec.n_planes)

    def _rem_window_index(self, spec: ShardedRoundSpec) -> np.ndarray:
        """Remainder ELL in per-shard WINDOW coordinates, ``(P, W)``:
        global neighbor g of a row owned by shard s sits at
        ``g - (s*L - H)`` inside that shard's [recv_lo; own; recv_hi]
        window — the single-device window index (tile = one shard,
        origin ``(s-1)*L``) shifted by ``L - H``."""
        one = FusedRoundSpec(
            n=spec.n, P=spec.P, rows=spec.P // LANE,
            block_rows=spec.local // LANE, grid=spec.num_shards,
            offsets=spec.offsets, rem_route="inline",
            rem_width=spec.rem_width, n_planes=spec.n_planes)
        idx = _rem_window_index(self.plan.spmv, self.plan.leaves, one)
        idx = idx.reshape(spec.P, -1).astype(np.int64)
        idx = np.where(idx >= 0, idx - (spec.local - spec.halo), -1)
        if not ((idx < 0) | (idx < spec.local + 2 * spec.halo)).all():
            raise ValueError(
                "remainder reach exceeds the halo window — the plan's "
                "bandwidth accounting is inconsistent (recompile the plan)")
        return idx.astype(np.int32)

    # ---- state -------------------------------------------------------------
    @property
    def state_shape(self) -> tuple:
        """The shape of an archived state's vectors."""
        return (self.spec.num_shards, self.spec.local)

    def init_state(self) -> ShardedNodeState:
        z = tuple(torch.zeros(self.spec.local, dtype=self.dtype,
                              device=sh.device) for sh in self._shards)
        return self._fired(0, dict(S=z, G=z, avg_prev=z, A_prev=z))

    def state_from_numpy(self, leaves: dict) -> ShardedNodeState:
        """A state from the JAX sharded kernel's ``NodeSyncState`` leaves
        as numpy arrays (``t``; ``S``, ``G``, ``avg_prev``, ``A_prev`` of
        shape ``(S, L)``) — a JAX sharded run continues here."""
        shape = (self.spec.num_shards, self.spec.local)
        vecs = {}
        for name in ("S", "G", "avg_prev", "A_prev"):
            arr = np.asarray(leaves[name])
            if arr.shape != shape:
                raise ValueError(
                    f"state leaf {name} has shape {arr.shape}, this "
                    f"kernel's layout is {shape} — build both kernels from "
                    "the same topology, config, plan and shard count")
            vecs[name] = tuple(
                torch.tensor(arr[s], dtype=self.dtype, device=sh.device)
                for s, sh in enumerate(self._shards))
        return self._fired(int(np.asarray(leaves["t"]).ravel()[0]), vecs)

    def _fired(self, t: int, vecs: dict) -> ShardedNodeState:
        """The state at round ``t`` with its ``avg``: one fire-only launch
        per shard, on the caller's stream, into a tensor of the state's."""
        avg = tuple(
            sharded_fire(sh.value, S, A_prev, sh.inv_depp1, sh.leaves,
                         self.spec, out=torch.empty_like(S))
            for sh, S, A_prev in zip(self._shards, vecs["S"],
                                     vecs["A_prev"]))
        return ShardedNodeState(t=t, avg=avg, **vecs)

    # ---- rounds ------------------------------------------------------------
    def _round(self, st: ShardedNodeState, parity: int) -> ShardedNodeState:
        spec, shards = self.spec, self._shards
        nsh, L, H = spec.num_shards, spec.local, spec.halo
        before, after = row_ranges(spec, self.exchange)
        # 1. ready: this round's avg was written on the shard's stream
        for sh in shards:
            if sh.ready is not None:
                sh.ready.record(sh.stream)
        # 2. exchange: my head -> left's recv_hi, my tail -> right's recv_lo
        for s, sh in enumerate(shards):
            left = shards[(s - 1) % nsh].recv[parity]
            right = shards[(s + 1) % nsh].recv[parity]
            with on_stream(sh.copy_stream):
                if sh.ready is not None:
                    sh.copy_stream.wait_event(sh.ready)
                left[1].copy_(st.avg[s][:H], non_blocking=True)
                right[0].copy_(st.avg[s][L - H:], non_blocking=True)
                if sh.copied is not None:
                    sh.copied.record()
        # 3. the rows whose reads stay on the shard, while the copies run
        outs = []
        for s, sh in enumerate(shards):
            with on_stream(sh.stream):
                out = tuple(torch.empty_like(st.S[s]) for _ in range(3)) \
                    + (sh.avg[1 - parity],)
                for rb, re in before:
                    self._merge(st, s, parity, (rb, re), out=out)
                outs.append(out)
        # 4. wait for both incoming halos, then the remaining rows in one
        #    launch
        for s, sh in enumerate(shards):
            with on_stream(sh.stream):
                if sh.stream is not None:
                    sh.stream.wait_event(shards[(s - 1) % nsh].copied)
                    sh.stream.wait_event(shards[(s + 1) % nsh].copied)
                if after:
                    self._merge(st, s, parity, *after, out=outs[s])
        return ShardedNodeState(
            t=st.t + 1, S=tuple(o[0] for o in outs),
            G=tuple(o[1] for o in outs), avg_prev=st.avg,
            A_prev=tuple(o[2] for o in outs), avg=tuple(o[3] for o in outs))

    def _merge(self, st, s, parity, rows, rows2=None, *, out) -> None:
        sh = self._shards[s]
        lo, hi = sh.recv[parity]
        sharded_round(st.S[s], st.G[s], st.avg_prev[s], st.A_prev[s],
                      sh.deg, st.avg[s], lo, hi, sh.leaves, self.spec,
                      *rows, out, rows2=rows2,
                      fire=(sh.value, sh.inv_depp1))

    def round_program(self, state, num_rounds: int):
        """``(fn, full_args, n_dynamic)`` for the rounds :meth:`run`
        runs — the cost-attribution hook (:mod:`~flow_updating_tpu_torch.
        obs.profile` runs ``fn`` from a copy of the state), so the profiled
        program IS the plain one."""
        return (self.run, (state, int(num_rounds)), 1)

    def run(self, state: ShardedNodeState, num_rounds: int
            ) -> ShardedNodeState:
        """``num_rounds`` rounds from ``state``, which stays as it was.  On
        the card each shard's stream first waits for the caller's stream,
        and at the end the caller's stream waits for every shard's and
        clones the last round's ``avg`` buffers into the returned state,
        so what the caller reads next is final and its own."""
        if num_rounds <= 0:
            return state
        cards = [(s, sh) for s, sh in enumerate(self._shards)
                 if sh.stream is not None]
        for _, sh in cards:
            sh.stream.wait_stream(torch.cuda.current_stream(sh.device))
        for _ in range(num_rounds):
            state = self._round(state, state.t % 2)
        for s, sh in cards:
            caller = torch.cuda.current_stream(sh.device)
            caller.wait_stream(sh.stream)
            for name in ("S", "G", "A_prev"):
                getattr(state, name)[s].record_stream(caller)
        return dataclasses.replace(
            state, avg=tuple(a.clone() for a in state.avg),
            avg_prev=tuple(a.clone() for a in state.avg_prev))

    # ---- read-back ---------------------------------------------------------
    def _flat(self, parts) -> np.ndarray:
        return np.concatenate([p.cpu().numpy() for p in parts])

    def _unpermute(self, padded: np.ndarray) -> np.ndarray:
        out = np.empty(self.topo.num_nodes, padded.dtype)
        out[self._perm] = padded[:self.topo.num_nodes]
        return out

    def estimates(self, state: ShardedNodeState) -> np.ndarray:
        """Per-node estimates in original node order (``value + G``)."""
        return self._unpermute(self._flat(
            sh.value + g for sh, g in zip(self._shards, state.G)))

    def last_avg(self, state: ShardedNodeState) -> np.ndarray:
        return self._unpermute(self._flat(state.avg_prev))

    def run_streamed(self, state: ShardedNodeState, num_rounds: int,
                     observe_every: int, emit) -> ShardedNodeState:
        """Chunked host-side observer — the JAX kernel's emit payload
        (metrics over the communicating nodes)."""
        if num_rounds % observe_every:
            raise ValueError("num_rounds must be a multiple of "
                             "observe_every")
        mean = float(self.topo.true_mean)
        real = self._flat(sh.deg for sh in self._shards) > 0
        cnt = max(int(real.sum()), 1)
        for _ in range(num_rounds // observe_every):
            state = self.run(state, observe_every)
            if emit is not None:
                est = self._flat(sh.value + g
                                 for sh, g in zip(self._shards, state.G))
                err = np.where(real, est - mean, 0.0)
                emit({
                    "t": int(state.t),
                    "rmse": float(np.sqrt((err * err).sum() / cnt)),
                    "max_abs_err": float(np.abs(err).max()),
                    "mass": float(np.where(real, est, 0.0).sum()),
                    "fired_total": int(state.t) * cnt,
                })
        return state
