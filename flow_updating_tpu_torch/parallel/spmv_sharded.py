"""The node round over a mesh with the Beneš neighbor sum per shard:
kernel B3 on every shard.

Counterpart of ``flow_updating_tpu/parallel/spmv_sharded.py``
(``Engine(mesh=..., spmv='benes_fused')``).  The node round's one graph
operation, the neighbor sum, runs as the gather-free permutation network
of ``ops/spmv_benes.py``, one network a shard:

* **Round-robin, degree-interleaved nodes.**  The base layout is the
  single-device kernel's ELL degree order with every bucket's row count
  padded to a multiple of ``S`` (``NodeKernel(row_multiple=S)``, built on
  the host); shard ``s`` owns padded rows ``s::S`` of every bucket.  So
  every shard holds the same per-bucket row counts and widths, and its
  network the same width ``P``.
* **One pass skeleton.**  Each shard routes its own network (its rows
  against the whole node vector), and its spread and fill sections are
  padded with no-op stages to the full dist lists
  (``spmv_benes.pad_roll_section``), so every shard runs the same passes
  with its own mask planes.
* **A round**, each shard on its own stream: the fire of its rows, an
  event; then, after every shard's event, the global ``avg`` gathered
  into the network's input (the shards concatenated in order and
  re-interleaved, written straight into strided slices), the fused passes
  (B3 on the card, one launch a pass), the row sums of its buckets, and
  its merge.  On the host the shards run one after the other with the
  plain versions.

The state's vectors are ``(S, M/S)``: one ``(M/S,)`` tensor a shard, the
JAX package's leaves, which a checkpoint stores as they are.  That layout
is not interchangeable with the single-device ``(M,)`` one (a restore
without the mesh raises).
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import os

import numpy as np
import torch

from flow_updating_tpu_torch.models.config import RoundConfig
from flow_updating_tpu_torch.ops.fused_passes import (
    apply_fused,
    pack_masks,
    plan_fused,
)
from flow_updating_tpu_torch.ops.permute import concat_plans
from flow_updating_tpu_torch.ops.spmv_benes import (
    _mats_key,
    pad_roll_section,
    plan_sections,
)
from flow_updating_tpu_torch.parallel.mesh import Mesh, check_mesh, on_stream
from flow_updating_tpu_torch.topology.graph import Topology

_FIELDS = ("S", "G", "avg_prev", "A_prev")

_sharded_plan_cache: dict = {}


def plan_sharded_spmv(mats: tuple, m1: int, num_shards: int):
    """Per-shard networks with one pass skeleton: ``(fused, planes,
    local_shapes)``.

    ``mats`` are the GLOBAL padded ELL matrices (every row count a
    multiple of ``num_shards``); shard ``s`` owns rows ``s::num_shards``.
    ``fused`` is the common :class:`~flow_updating_tpu_torch.ops.
    fused_passes.FusedPlan`; ``planes[p]`` stacks pass ``p``'s host mask
    plane of every shard, ``(S, P)``; ``local_shapes`` are a shard's
    ``(rows/S, width)`` per bucket.  The shards route in parallel threads
    (the native router releases the GIL)."""
    S = num_shards
    key = (_mats_key(mats, m1), S)
    cached = _sharded_plan_cache.get(key)
    if cached is not None:
        return cached
    with concurrent.futures.ThreadPoolExecutor(
            max_workers=max(1, min(S, os.cpu_count() or 1))) as pool:
        sections = list(pool.map(
            lambda s: plan_sections(
                tuple(np.ascontiguousarray(m[s::S]) for m in mats), m1),
            range(S)))
    widths = {sec[3] for sec in sections}
    if len(widths) != 1:
        raise ValueError(f"shards disagree on network width: {widths}")
    P = widths.pop()
    # full dist lists (descending for the spread, ascending for the
    # fill): each shard's stages are a subsequence of them
    kmax = P.bit_length() - 1
    spread_dists = tuple(1 << k for k in range(kmax - 1, -1, -1))
    fill_dists = tuple(1 << k for k in range(kmax))
    stage_plans = [concat_plans(pad_roll_section(spread, spread_dists),
                                pad_roll_section(fill, fill_dists), benes)
                   for spread, fill, benes, _ in sections]
    del sections
    skeleton = (stage_plans[0].dists, stage_plans[0].kinds)
    if any((sp.dists, sp.kinds) != skeleton for sp in stage_plans[1:]):
        raise ValueError("shard stage skeletons diverged; per-shard "
                         "routing would be silently wrong")
    fused = plan_fused(stage_plans[0])
    per_shard = [pack_masks(sp, fused) for sp in stage_plans]
    planes = tuple(np.stack([per_shard[s][p] for s in range(S)])
                   for p in range(len(fused.passes)))
    local_shapes = tuple((m.shape[0] // S, m.shape[1]) for m in mats)
    out = (fused, planes, local_shapes)
    _sharded_plan_cache[key] = out
    while len(_sharded_plan_cache) > 2:   # stacked planes are big
        _sharded_plan_cache.pop(next(iter(_sharded_plan_cache)))
    return out


@dataclasses.dataclass(frozen=True)
class ShardedSpmvState:
    """Per-shard node state: each field holds one ``(M/S,)`` tensor per
    shard, on that shard's device."""

    t: int
    S: tuple
    G: tuple
    avg_prev: tuple
    A_prev: tuple

    def to_numpy(self) -> dict:
        """The JAX ``NodeSyncState`` leaves: ``t`` and ``(S, M/S)``
        arrays."""
        out = {"t": self.t}
        for f in _FIELDS:
            out[f] = np.stack([v.cpu().numpy() for v in getattr(self, f)])
        return out


@dataclasses.dataclass(frozen=True, eq=False)
class _Shard:
    device: torch.device
    stream: object           # torch.cuda.Stream | None (host)
    value: torch.Tensor      # (M/S,)
    inv_depp1: torch.Tensor
    deg: torch.Tensor
    planes: tuple            # per pass: its (P,) mask plane
    ready: object            # torch.cuda.Event | None


class ShardedNodeKernel:
    """Node-collapsed fast collect-all over a mesh, the neighbor sum as a
    Beneš network per shard (``spmv='benes_fused'``).  Mirrors
    :class:`~flow_updating_tpu_torch.models.sync.NodeKernel`'s recurrence
    and equals its ``benes_fused`` round bit for bit: the network only
    moves data, and each row sums the same values in the same order.
    ``device`` must agree with the mesh (default: the mesh's)."""

    def __init__(self, topo: Topology, cfg: RoundConfig, mesh: Mesh,
                 device=None):
        from flow_updating_tpu_torch.models import sync

        sync._check_cfg(cfg)
        if cfg.spmv != "benes_fused":
            raise ValueError("ShardedNodeKernel is the spmv='benes_fused' "
                             "mesh path")
        check_mesh(mesh, device)
        self.topo = topo
        self.cfg = cfg
        self.mesh = mesh
        self.dtype = cfg.torch_dtype
        self.num_shards = S = mesh.size
        # the single-device layout with every bucket padded to a multiple
        # of S, on the host: its constants are cast to the config's dtype
        # exactly as the single-device kernel's
        base = sync.NodeKernel(topo, dataclasses.replace(cfg, spmv="xla"),
                               row_multiple=S, device="cpu")
        self.padded_size = M = base.padded_size
        self.local = M // S
        self._pos_of_real = base._pos_of_real
        self._perm = base._perm
        mats = tuple(m.numpy() for m in base.arrays.mats)
        self.fused, planes, self.local_shapes = plan_sharded_spmv(
            mats, M + 1, S)
        self.bucket_offs = tuple(int(o) for o in np.concatenate(
            [[0], np.cumsum([m.shape[0] for m in mats])]))
        #: each bucket's rows without the shard padding
        self.bucket_rows = tuple(topo.ell_buckets().row_counts)
        value, inv, deg = (self._interleave(a.numpy()) for a in (
            base.arrays.value, base.arrays.inv_depp1, base.arrays.deg))
        del base
        shards = []
        for s, (dev, stream) in enumerate(zip(mesh.devices, mesh.streams)):
            shards.append(_Shard(
                device=dev, stream=stream,
                value=torch.from_numpy(value[s]).to(dev),
                inv_depp1=torch.from_numpy(inv[s]).to(dev),
                deg=torch.from_numpy(deg[s]).to(dev),
                planes=tuple(
                    torch.from_numpy(p[s].view(np.int32)
                                     if p.dtype == np.uint32
                                     else p[s]).to(dev)
                    for p in planes),
                ready=torch.cuda.Event() if dev.type == "cuda" else None))
        self._shards = tuple(shards)

    @property
    def state_shape(self) -> tuple:
        """The shape of an archived state's vectors."""
        return (self.num_shards, self.local)

    # ---- layouts -----------------------------------------------------------
    def _interleave(self, x: np.ndarray) -> np.ndarray:
        """Global padded ``(M,)`` -> ``(S, M/S)``: shard ``s`` takes rows
        ``s::S`` of each bucket, the buckets concatenated."""
        S, offs = self.num_shards, self.bucket_offs
        return np.ascontiguousarray(np.concatenate(
            [x[offs[b]:offs[b + 1]].reshape(-1, S).T
             for b in range(len(offs) - 1)], axis=1))

    def _uninterleave(self, x_l: np.ndarray) -> np.ndarray:
        """``(S, M/S)`` -> global padded ``(M,)``."""
        out = np.zeros(self.padded_size, x_l.dtype)
        col = 0
        for b, (rows, _) in enumerate(self.local_shapes):
            lo = self.bucket_offs[b]
            out[lo:lo + rows * self.num_shards] = \
                x_l[:, col:col + rows].T.reshape(-1)
            col += rows
        return out

    def _unpermute(self, padded: np.ndarray) -> np.ndarray:
        out = np.empty(self.topo.num_nodes, padded.dtype)
        out[self._perm] = padded[self._pos_of_real]
        return out

    def _host(self, parts) -> np.ndarray:
        return self._unpermute(self._uninterleave(
            np.stack([p.cpu().numpy() for p in parts])))

    # ---- state -------------------------------------------------------------
    def init_state(self) -> ShardedSpmvState:
        z = tuple(torch.zeros_like(sh.value) for sh in self._shards)
        return ShardedSpmvState(t=0, S=z, G=z, avg_prev=z, A_prev=z)

    def state_from_numpy(self, leaves: dict) -> ShardedSpmvState:
        """A state from the JAX sharded kernel's ``NodeSyncState`` leaves
        as numpy arrays (``t``; the vectors ``(S, M/S)``)."""
        vecs = {}
        for f in _FIELDS:
            arr = np.asarray(leaves[f])
            if arr.shape != self.state_shape:
                raise ValueError(
                    f"state leaf {f} has shape {arr.shape}, this kernel's "
                    f"layout is {self.state_shape} — build both kernels "
                    "from the same topology, config and shard count")
            vecs[f] = tuple(torch.tensor(arr[s], dtype=self.dtype,
                                         device=sh.device)
                            for s, sh in enumerate(self._shards))
        return ShardedSpmvState(t=int(np.asarray(leaves["t"]).ravel()[0]),
                                **vecs)

    # ---- rounds ------------------------------------------------------------
    def _network_input(self, s: int, avg: list) -> torch.Tensor:
        """Shard ``s``'s ``(P,)`` network input: the global padded ``avg``
        (every shard's rows written into their interleaved slots, after
        waiting for them; each kept from reuse until this shard's stream
        has read it), then zeros — the zero slot and the padding."""
        sh = self._shards[s]
        S = self.num_shards
        z = torch.zeros(self.fused.P, dtype=self.dtype, device=sh.device)
        for j, (other, a) in enumerate(zip(self._shards, avg)):
            if j != s and sh.stream is not None:
                sh.stream.wait_event(other.ready)
                a.record_stream(sh.stream)
            col = 0
            for b, (rows, _) in enumerate(self.local_shapes):
                lo, hi = self.bucket_offs[b], self.bucket_offs[b + 1]
                if rows:
                    z[lo + j:hi:S].copy_(a[col:col + rows],
                                         non_blocking=True)
                col += rows
        return z

    def _neighbor_sum(self, s: int, avg: list) -> torch.Tensor:
        """Shard ``s``'s rows of ``A(avg)``: the network, then the row sums
        of its buckets.

        On the card, torch's row sum picks its block shape from the number
        of rows (below 16 rows, and for rows of 8,192 values or more) and
        its vector loads from each row's alignment, so a row summed among
        another count of rows, or at another offset, can add in another
        order.  Each real row is therefore summed inside a fresh buffer
        of its bucket's single-device shape ``(rows, width)`` (the true
        row count, without the shard padding), at its single-device row:
        every row adds in the single-device route's order (the buffer's
        other rows are not read back).  The shard's padding rows sum to 0,
        as there."""
        sh = self._shards[s]
        S = self.num_shards
        z = apply_fused(self._network_input(s, avg), self.fused, sh.planes)
        parts = []
        off = self.padded_size + 1
        for (rows, w), real in zip(self.local_shapes, self.bucket_rows):
            mine = len(range(s, real, S))
            if w == 0 or mine == 0:
                parts.append(z.new_zeros(rows))
            else:
                buf = z.new_empty(real, w)
                buf[s::S] = z[off:off + mine * w].view(mine, w)
                parts.append(buf.sum(dim=1)[s::S])
                if rows > mine:
                    parts.append(z.new_zeros(rows - mine))
            off += rows * w
        return torch.cat(parts) if len(parts) > 1 else parts[0]

    def _round(self, st: ShardedSpmvState) -> ShardedSpmvState:
        avg = []
        for s, sh in enumerate(self._shards):
            with on_stream(sh.stream):
                avg.append((sh.value - st.S[s] + st.A_prev[s])
                           * sh.inv_depp1)
                if sh.ready is not None:
                    sh.ready.record(sh.stream)
        out = {f: [] for f in _FIELDS}
        for s, sh in enumerate(self._shards):
            with on_stream(sh.stream):
                A = self._neighbor_sum(s, avg)
                S_next = -st.G[s] - A + sh.deg * st.avg_prev[s]
                G_next = -st.S[s] - sh.deg * avg[s] + st.A_prev[s]
            for f, v in zip(_FIELDS, (S_next, G_next, avg[s], A)):
                out[f].append(v)
        return ShardedSpmvState(t=st.t + 1,
                                **{f: tuple(v) for f, v in out.items()})

    def run(self, state: ShardedSpmvState, num_rounds: int
            ) -> ShardedSpmvState:
        """``num_rounds`` rounds from ``state``, which stays as it was.  On
        the card each shard's stream first waits for the caller's stream,
        and at the end the caller's stream waits for every shard's."""
        if num_rounds <= 0:
            return state
        cards = [sh for sh in self._shards if sh.stream is not None]
        for sh in cards:
            sh.stream.wait_stream(torch.cuda.current_stream(sh.device))
        for _ in range(num_rounds):
            state = self._round(state)
        for s, sh in enumerate(self._shards):
            if sh.stream is None:
                continue
            caller = torch.cuda.current_stream(sh.device)
            caller.wait_stream(sh.stream)
            for f in _FIELDS:
                getattr(state, f)[s].record_stream(caller)
        return state

    # ---- read-back ---------------------------------------------------------
    def estimates(self, state: ShardedSpmvState) -> np.ndarray:
        """Per-node estimates in original node order (``value + G``)."""
        return self._host(sh.value + g
                          for sh, g in zip(self._shards, state.G))

    def last_avg(self, state: ShardedSpmvState) -> np.ndarray:
        return self._host(state.avg_prev)

    def run_streamed(self, state: ShardedSpmvState, num_rounds: int,
                     observe_every: int, emit) -> ShardedSpmvState:
        """Chunked host-side observer — the JAX kernel's emit payload
        (metrics over the communicating nodes)."""
        if num_rounds % observe_every:
            raise ValueError("num_rounds must be a multiple of "
                             "observe_every")
        mean = float(self.topo.true_mean)
        real = np.stack([sh.deg.cpu().numpy() for sh in self._shards]) > 0
        cnt = max(int(real.sum()), 1)
        for _ in range(num_rounds // observe_every):
            state = self.run(state, observe_every)
            if emit is not None:
                est = np.stack([(sh.value + g).cpu().numpy()
                                for sh, g in zip(self._shards, state.G)])
                err = np.where(real, est - mean, 0.0)
                emit({
                    "t": int(state.t),
                    "rmse": float(np.sqrt((err * err).sum() / cnt)),
                    "max_abs_err": float(np.abs(err).max()),
                    "mass": float(np.where(real, est, 0.0).sum()),
                    "fired_total": int(state.t) * cnt,
                })
        return state
