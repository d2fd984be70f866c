"""Node-collapsed kernel for the fast synchronous collect-all mode.

Counterpart of ``flow_updating_tpu/models/sync.py``.  In the fast mode
(``fire_policy='every_round'``, unit delay, unbounded drain, no faults)
the per-edge ledgers are determined by the node history, and summing over
each node's out-edges collapses the edge state into four per-node vectors
— S (sum of own out-flows), G (sum of flows the neighbors hold toward the
node), avg and its neighbor sum A(avg) — with the recurrence

    avg_r   = (value - S_r + A(avg_{r-1})) / (deg + 1)
    S_{r+1} = -G_r - A(avg_r) + deg * avg_{r-1}
    G_{r+1} = -S_r - deg * avg_r + A(avg_{r-1})

(initial conditions S_0 = G_0 = 0, avg_{-1} = 0).  The only graph
operation is the neighbor sum A, selected by ``RoundConfig.spmv``:

* ``'xla'``          — plain gather + row sum (``ops/spmv.neighbor_sum``);
* ``'pallas'``       — kernel K1, the CUDA ELL neighbor sum
                       (``ops/spmv.neighbor_sum_ell``);
* ``'banded'``       — the topology compiler's masked-roll bands + gather
                       remainder as plain tensor ops (``plan/banded.py``);
* ``'banded_fused'`` — kernel K2, the whole round in one CUDA launch
                       (``ops/fused_round.fused_banded_round``);
* ``'benes'``        — the gather-free permutation network, one set of
                       torch ops per stage (``ops/spmv_benes.py``);
* ``'benes_fused'``  — the same network as fused passes, kernel B3
                       (``ops/fused_passes.py``);
* ``'structured'``   — the closed-form stencil of a regular generator's
                       graph (``ops/structured.py``), plain tensor ops as
                       in the JAX package; it runs virtual fat trees.

Node vectors live in the layout of the chosen path (ELL degree order, which
the Beneš paths share with 'xla', the plan's RCM order padded to the tile
grid, or the generator's own order for 'structured'), exactly as in the
JAX package, so a state can be carried
across between the two packages
(:meth:`NodeKernel.state_from_numpy`).  Rounds run as a Python loop over
tensor ops on the kernel's device.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from flow_updating_tpu_torch.models.config import RoundConfig
from flow_updating_tpu_torch.models.state import _ex, check_payload_values
from flow_updating_tpu_torch.ops.fused_round import (
    FusedRoundLeaves,
    FusedRoundSpec,
    build_fused_leaves,
    fused_banded_round,
    plan_fused_round,
)
from flow_updating_tpu_torch.ops.spmv import (
    BLOCK_ROWS,
    neighbor_sum,
    neighbor_sum_ell,
)
from flow_updating_tpu_torch.ops.spmv_benes import (
    neighbor_sum_benes,
    plan_neighbor_sum,
)
from flow_updating_tpu_torch.ops.structured import structured_neighbor_sum
from flow_updating_tpu_torch.plan.banded import (
    BandedLeaves,
    BandedSpmvPlan,
    banded_neighbor_sum,
    banded_remainder_sum,
)
from flow_updating_tpu_torch.topology.graph import Topology
from flow_updating_tpu_torch.utils.device import resolve_device

@dataclasses.dataclass(frozen=True)
class NodeSyncState:
    """Per-node state, in the kernel's node layout."""

    t: int                  # rounds run
    S: torch.Tensor         # (M,) or (M, D) sum of own out-edge flows
    G: torch.Tensor         # sum of neighbors' flows toward the node
    avg_prev: torch.Tensor  # avg_{r-1}
    A_prev: torch.Tensor    # neighbor sum of avg_{r-1}


@dataclasses.dataclass(frozen=True)
class NodeSyncArrays:
    """Per-topology constants of the node-collapsed round."""

    value: torch.Tensor      # (M,) or (M, D) initial values, kernel layout
    inv_depp1: torch.Tensor  # (M,) 1 / (deg + 1)
    deg: torch.Tensor        # (M,) float degree
    mats: tuple = ()         # 'xla'/'pallas'/'benes*': per-bucket (rows,
    #                          width) int32
    ns_plan: object = None   # 'benes*': NeighborSumPlan / FusedNeighborSumPlan
    ns_masks: tuple = ()     # 'benes*': its stage masks / pass planes
    band: BandedSpmvPlan | None = None    # 'banded*': static plan
    band_leaves: BandedLeaves | None = None
    fused: FusedRoundSpec | None = None   # 'banded_fused': tile geometry
    fused_leaves: FusedRoundLeaves | None = None
    struct: object = None    # 'structured': the topology's descriptor


def _check_cfg(cfg: RoundConfig) -> None:
    if not cfg.is_fast_sync_collectall:
        raise ValueError(
            "the node-collapsed kernel covers exactly the fast synchronous "
            "collect-all mode (every_round, drain=0, delay_depth=1, no "
            "message drop); use the edge kernel otherwise"
        )


def _ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _refuse_mesh(cfg: RoundConfig) -> None:
    """``NodeKernel`` runs on one device.  As in the JAX package, the
    kernel-backed neighbor sums name their mesh path; 'xla' and
    'structured', which JAX partitions with GSPMD, have no torch
    counterpart yet."""
    if cfg.spmv == "xla":
        raise NotImplementedError(
            "spmv='xla' over a mesh is GSPMD's node path in the JAX "
            "package, the ROADMAP item 'multi-device execution (A12 part "
            "4)', not ported yet; spmv='banded_fused' and 'benes_fused' "
            "run over a mesh through parallel.banded_sharded."
            "ShardedBandedKernel and parallel.spmv_sharded."
            "ShardedNodeKernel")
    if cfg.spmv == "structured":
        raise NotImplementedError(
            "spmv='structured' over a mesh is GSPMD's stencil in the JAX "
            "package, the ROADMAP item 'multi-device execution (A12 part "
            "4)', not ported yet; a fat tree runs over a mesh by pod: "
            "Engine(mesh=..., multichip='pod') or parallel."
            "structured_sharded.PodShardedFatTreeKernel")
    if cfg.spmv == "banded_fused":
        hint = ("use parallel.banded_sharded.ShardedBandedKernel (the "
                "kernel-per-shard halo path)")
    elif cfg.spmv == "benes_fused":
        hint = ("use parallel.spmv_sharded.ShardedNodeKernel (the sharded "
                "fused-circuit path)")
    else:
        hint = ("use spmv='xla' with a mesh (GSPMD handles the collective; "
                "ROADMAP A12, not ported yet)")
    raise ValueError(f"spmv={cfg.spmv!r} has no GSPMD partitioning path; "
                     + hint)


class NodeKernel:
    """The node-collapsed fast kernel for one topology, on one device.

    ``device`` defaults to the CUDA card (raising if there is none); pass
    ``device='cpu'`` to run the plain tensor versions on the host.
    ``values`` overrides ``topo.values`` and may be ``(N, D)`` (paths
    'xla', 'banded' and 'banded_fused'; 'pallas', 'benes' and
    'benes_fused' are scalar, as in the JAX package).  ``plan`` (banded
    paths) supplies a compiled
    :class:`~flow_updating_tpu_torch.plan.compile.ExecutionPlan`;
    ``fused_tile`` pins the one-kernel round's tile height and
    ``fused_remainder`` its remainder route: ``'auto'`` (the default) and
    ``'lanes'`` add the remainder computed outside the kernel, bit-exact
    against 'banded'; ``'inline'`` gathers it inside the kernel (gather
    remainders only) — the autotuner races the two.
    ``row_multiple`` pads every degree bucket's row count ('xla',
    'pallas', 'benes*') or the node vector ('structured') to a multiple
    of it, as in the JAX package (the sharded Beneš round builds its base
    layout with the shard count).  A ``mesh`` raises, as in the JAX
    package: the mesh path of 'banded_fused' is
    :class:`~flow_updating_tpu_torch.parallel.banded_sharded.
    ShardedBandedKernel`, that of 'benes_fused'
    :class:`~flow_updating_tpu_torch.parallel.spmv_sharded.
    ShardedNodeKernel`, and a fat tree's stencil runs by pod
    (:class:`~flow_updating_tpu_torch.parallel.structured_sharded.
    PodShardedFatTreeKernel`)."""

    def __init__(self, topo: Topology, cfg: RoundConfig, values=None,
                 plan=None, fused_tile=None, device=None, mesh=None,
                 row_multiple: int = 1, fused_remainder: str = "auto"):
        _check_cfg(cfg)
        self.device = resolve_device(device)
        self.topo = topo
        self.cfg = cfg
        self.dtype = cfg.torch_dtype
        self._values = np.asarray(
            topo.values if values is None else values, np.float64)
        check_payload_values(self._values, topo.num_nodes)
        self.feature_shape = tuple(self._values.shape[1:])
        if self.feature_shape and cfg.spmv not in ("xla", "banded",
                                                   "banded_fused"):
            raise ValueError(
                f"vector payloads run the node kernel with spmv='xla', "
                f"'banded' or 'banded_fused' (spmv={cfg.spmv!r} is "
                "scalar)")
        if mesh is not None:
            _refuse_mesh(cfg)
        if cfg.spmv in ("banded", "banded_fused"):
            self._init_banded(topo, plan, fused_tile, fused_remainder)
            return
        if cfg.spmv == "structured":
            self._init_structured(topo, row_multiple)
            return
        # 'pallas' pads each bucket to the JAX kernel's 256-row blocks, so
        # the state layout matches the JAX package's
        if cfg.spmv == "pallas":
            row_multiple = math.lcm(row_multiple, BLOCK_ROWS)
        ell = topo.ell_buckets()
        counts = [_ceil_to(c, row_multiple) for c in ell.row_counts]
        offs = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        self.padded_size = M = int(offs[-1])
        pos = np.concatenate([
            offs[b] + np.arange(c, dtype=np.int64)
            for b, c in enumerate(ell.row_counts)
        ]) if ell.row_counts else np.zeros((0,), np.int64)
        self._pos_of_real = pos          # (N,) permuted-real -> padded slot
        self._perm = ell.perm            # (N,) permuted-real -> original id

        value = np.zeros((M,) + self.feature_shape, np.float64)
        deg = np.zeros(M, np.float64)
        value[pos] = self._values[ell.perm]
        deg[pos] = topo.out_deg[ell.perm]

        mats = []
        for b, m in enumerate(ell.mats):
            mat = np.full((counts[b], m.shape[1]), M, np.int32)  # M -> zero
            if m.size:
                # remap neighbor indices from permuted-real to padded slots
                mat[: m.shape[0]] = np.where(
                    m < topo.num_nodes,
                    pos[np.minimum(m, topo.num_nodes - 1)], M,
                ).astype(np.int32)
            mats.append(mat)
        ns_plan, ns_masks = None, ()
        if cfg.spmv in ("benes", "benes_fused"):
            ns_plan = plan_neighbor_sum(tuple(mats), M + 1,
                                        fused=cfg.spmv == "benes_fused")
            ns_masks = ns_plan.to(self.device)
        self.arrays = self._constants(value, deg, mats=tuple(
            torch.from_numpy(m).to(self.device) for m in mats),
            ns_plan=ns_plan, ns_masks=ns_masks)

    def _constants(self, value, deg, **kw) -> NodeSyncArrays:
        dev, dt = self.device, self.dtype
        return NodeSyncArrays(
            value=torch.from_numpy(value).to(dev, dt),
            inv_depp1=torch.from_numpy(1.0 / (deg + 1.0)).to(dev, dt),
            deg=torch.from_numpy(deg).to(dev, dt), **kw)

    def _init_structured(self, topo: Topology, row_multiple: int) -> None:
        """spmv='structured': the generator's node order (there is no
        gather to bucket), padding at the tail up to ``row_multiple``."""
        struct = topo.structure
        if struct is None:
            raise ValueError(
                "spmv='structured' is the closed-form stencil for "
                "topologies whose GENERATOR proves their regularity "
                "(ring, grid2d, torus2d, hypercube, complete, fat_tree) "
                "— this topology carries no structure descriptor.  For "
                "arbitrary graphs use the topology compiler instead: "
                "Engine(plan='auto') / --plan auto picks the fastest "
                "correct path automatically, spmv='banded' forces the "
                "compiled RCM-band plan, and "
                "spmv='xla'|'benes'|'benes_fused' are the generic "
                "neighbor-sum layouts"
            )
        if struct.n != topo.num_nodes:
            raise ValueError(
                f"structure descriptor covers {struct.n} nodes but the "
                f"topology has {topo.num_nodes}"
            )
        n = topo.num_nodes
        self.padded_size = M = _ceil_to(n, row_multiple)
        self._pos_of_real = np.arange(n, dtype=np.int64)
        self._perm = np.arange(n, dtype=np.int64)
        value = np.zeros(M, np.float64)
        deg = np.zeros(M, np.float64)
        value[:n] = self._values
        deg[:n] = topo.out_deg
        self.arrays = self._constants(value, deg, struct=struct)

    def _init_banded(self, topo: Topology, plan, fused_tile,
                     fused_remainder: str = "auto") -> None:
        """spmv='banded'/'banded_fused': node vectors live in the
        topology compiler's RCM order (``plan.order[new] = old``), padding
        at the tail — for 'banded_fused' up to the tile grid."""
        from flow_updating_tpu_torch.plan.compile import (
            _topo_key,
            compile_topology,
        )

        features = int(np.prod(self.feature_shape)) \
            if self.feature_shape else 0
        if plan is None:
            plan = compile_topology(topo, features=features)
        if plan.num_nodes != topo.num_nodes:
            raise ValueError(
                f"execution plan covers {plan.num_nodes} nodes but the "
                f"topology has {topo.num_nodes} — compile the plan from "
                "this topology (plan.compile_topology)")
        if plan.source_key and plan.source_key != _topo_key(topo):
            raise ValueError(
                "execution plan was compiled from a different topology "
                "(edge-content fingerprint mismatch) — recompile with "
                "plan.compile_topology(topo)")
        self.plan = plan
        n = topo.num_nodes
        spec = fleaves = None
        self.padded_size = M = n
        if self.cfg.spmv == "banded_fused":
            spec = plan_fused_round(plan.spmv, block_rows=fused_tile,
                                    rem_route=fused_remainder)
            fleaves = build_fused_leaves(plan.spmv, plan.leaves,
                                         spec).to(self.device)
            self.padded_size = M = spec.P
        self._pos_of_real = np.arange(n, dtype=np.int64)
        self._perm = np.asarray(plan.order, np.int64)
        value = np.zeros((M,) + self.feature_shape, np.float64)
        deg = np.zeros(M, np.float64)
        value[:n] = self._values[self._perm]
        deg[:n] = topo.out_deg[self._perm]
        self.arrays = self._constants(
            value, deg, band=plan.spmv,
            band_leaves=plan.leaves.to(self.device),
            fused=spec, fused_leaves=fleaves)

    @property
    def state_shape(self) -> tuple:
        """The shape of an archived state's vectors."""
        return (self.padded_size,) + self.feature_shape

    def init_state(self) -> NodeSyncState:
        z = torch.zeros((self.padded_size,) + self.feature_shape,
                        dtype=self.dtype, device=self.device)
        return NodeSyncState(t=0, S=z, G=z, avg_prev=z, A_prev=z)

    def state_from_numpy(self, leaves: dict) -> NodeSyncState:
        """A state from the JAX package's ``NodeSyncState`` leaves as numpy
        arrays (``t``, ``S``, ``G``, ``avg_prev``, ``A_prev``), in the same
        padded node layout — a run started there continues here."""
        shape = (self.padded_size,) + self.feature_shape
        vecs = {}
        for name in ("S", "G", "avg_prev", "A_prev"):
            arr = np.asarray(leaves[name])
            if arr.shape != shape:
                raise ValueError(
                    f"state leaf {name} has shape {arr.shape}, this kernel's "
                    f"layout is {shape} — build both kernels from the same "
                    "topology, config and plan")
            vecs[name] = torch.tensor(arr, dtype=self.dtype,
                                      device=self.device)
        return NodeSyncState(t=int(np.asarray(leaves["t"])), **vecs)

    def run(self, state: NodeSyncState, num_rounds: int) -> NodeSyncState:
        return run_rounds_node(state, self.arrays, self.cfg, num_rounds)

    def run_telemetry(self, state: NodeSyncState, num_rounds: int, spec):
        """Device-resident per-round series (see
        :func:`run_rounds_node_telemetry`); returns ``(state, series)``.
        Layouts whose real nodes are a prefix (the plan's RCM order, the
        generator's order) reduce over that prefix only, so a
        tile-padded 'banded_fused' series equals its unpadded twin's."""
        n = self.topo.num_nodes
        prefix = self.cfg.spmv in ("banded", "banded_fused", "structured")
        return run_rounds_node_telemetry(
            state, self.arrays, self.cfg, num_rounds, spec,
            self.topo.true_mean,
            n_live=n if prefix and self.padded_size != n else None)

    def run_fields(self, state: NodeSyncState, num_rounds: int, spec):
        """Device-resident per-node field rows (see
        :func:`run_rounds_node_fields`); returns ``(state, conv_round,
        series)``, every node axis still in the kernel's padded layout
        (``Engine.run_fields`` unpermutes with :meth:`unpermute_series`,
        :meth:`_unpermute` and :meth:`original_node_ids`)."""
        return run_rounds_node_fields(state, self.arrays, self.cfg,
                                      num_rounds, spec, self.topo.true_mean)

    def unpermute_series(self, padded: np.ndarray) -> np.ndarray:
        """A stacked ``(R, M, ...)`` per-node field series in the kernel's
        layout -> ``(R, N, ...)`` in original node order."""
        out = np.empty((padded.shape[0], self.topo.num_nodes)
                       + padded.shape[2:], padded.dtype)
        out[:, self._perm] = padded[:, self._pos_of_real]
        return out

    def original_node_ids(self, padded_idx: np.ndarray) -> np.ndarray:
        """Padded-slot indices (a recorded ``topk_idx`` row) -> original
        node ids; padding slots map to -1."""
        inv = np.full(self.padded_size, -1, np.int64)
        inv[self._pos_of_real] = self._perm
        return inv[np.asarray(padded_idx)]

    def _unpermute(self, padded: np.ndarray) -> np.ndarray:
        n = self.topo.num_nodes
        if self.cfg.spmv == "structured":   # the generator's own order
            return padded[:n].copy()
        out = np.empty((n,) + padded.shape[1:], padded.dtype)
        out[self._perm] = padded[self._pos_of_real]
        return out

    def estimates(self, state: NodeSyncState) -> np.ndarray:
        """Per-node estimates in original node order
        (``value + G``; see the module doc)."""
        est = self.arrays.value + state.G
        return self._unpermute(est.cpu().numpy())

    def last_avg(self, state: NodeSyncState) -> np.ndarray:
        return self._unpermute(state.avg_prev.cpu().numpy())


def _fused_round_step(state: NodeSyncState,
                      arrs: NodeSyncArrays) -> NodeSyncState:
    """spmv='banded_fused': the whole round through kernel K2.  On the
    'lanes' route the remainder addend is computed first, from the same
    elementwise ``avg`` the kernel computes, by the banded executor's own
    remainder function."""
    spec = arrs.fused
    a_rem = None
    if spec.rem_route == "lanes":
        avg = (arrs.value - state.S + state.A_prev) \
            * _ex(arrs.inv_depp1, arrs.value)
        a_rem = banded_remainder_sum(avg, arrs.band, arrs.band_leaves)
    S_next, G_next, avg_o, A_cur = fused_banded_round(
        state.S, state.G, state.avg_prev, state.A_prev,
        arrs.value, arrs.inv_depp1, arrs.deg,
        arrs.fused_leaves, spec, a_rem=a_rem)
    return NodeSyncState(t=state.t + 1, S=S_next, G=G_next,
                         avg_prev=avg_o, A_prev=A_cur)


def node_round_step(state: NodeSyncState, arrs: NodeSyncArrays,
                    cfg: RoundConfig) -> NodeSyncState:
    if cfg.spmv == "banded_fused":
        return _fused_round_step(state, arrs)
    avg = (arrs.value - state.S + state.A_prev) \
        * _ex(arrs.inv_depp1, arrs.value)
    if cfg.spmv == "pallas":
        A_cur = neighbor_sum_ell(avg, arrs.mats)
    elif cfg.spmv == "banded":
        A_cur = banded_neighbor_sum(avg, arrs.band, arrs.band_leaves)
    elif cfg.spmv in ("benes", "benes_fused"):
        A_cur = neighbor_sum_benes(avg, arrs.ns_plan, arrs.ns_masks)
    elif cfg.spmv == "structured":
        A_cur = structured_neighbor_sum(avg, arrs.struct)
    else:
        A_cur = neighbor_sum(avg, arrs.mats)
    deg = _ex(arrs.deg, arrs.value)
    S_next = -state.G - A_cur + deg * state.avg_prev
    G_next = -state.S - deg * avg + state.A_prev
    return NodeSyncState(t=state.t + 1, S=S_next, G=G_next, avg_prev=avg,
                         A_prev=A_cur)


def run_rounds_node(state: NodeSyncState, arrs: NodeSyncArrays,
                    cfg: RoundConfig, num_rounds: int) -> NodeSyncState:
    for _ in range(num_rounds):
        state = node_round_step(state, arrs, cfg)
    return state


def node_telemetry_sample(s: NodeSyncState, arrs: NodeSyncArrays, spec,
                          mean, n_live: int | None = None) -> dict:
    """One round's metric row for the node-collapsed kernel, as device
    tensors (no host read).  Communicating rows only (deg > 0 — padding
    has degree 0).  In fast sync mode every communicating node fires
    every round, so ``fired_total = t * active``.  ``n_live`` slices the
    reductions to the real-node prefix, so a tile-padded layout sums the
    same terms as the unpadded kernel."""
    value, G = arrs.value, s.G
    real = arrs.inv_depp1 < 1.0
    if n_live is not None:
        value, G, real = value[:n_live], G[:n_live], real[:n_live]
    out = {"t": s.t}
    need_est = any(spec.has(m) for m in
                   ("rmse", "max_abs_err", "mass", "mass_residual"))
    if need_est:
        est = value + G
        r_ex = _ex(real, est)
        if spec.has("rmse") or spec.has("max_abs_err"):
            err = torch.where(r_ex, est - mean, 0.0)
            if spec.has("rmse"):
                feat = int(est[0].numel()) if est.dim() > 1 else 1
                cnt = (torch.clamp(real.sum(), min=1) * feat).to(est.dtype)
                out["rmse"] = torch.sqrt((err * err).sum() / cnt)
            if spec.has("max_abs_err"):
                out["max_abs_err"] = err.abs().max()
        if spec.has("mass") or spec.has("mass_residual"):
            mass = torch.where(r_ex, est, 0.0).sum(0)
            if spec.has("mass"):
                out["mass"] = mass
            if spec.has("mass_residual"):
                out["mass_residual"] = mass - torch.where(
                    _ex(real, value), value, 0.0).sum(0)
    active = real.sum(dtype=torch.int32)
    if spec.has("fired_total"):
        out["fired_total"] = active.to(torch.int64) * s.t
    if spec.has("active"):
        out["active"] = active
    return out


def run_rounds_node_telemetry(state: NodeSyncState, arrs: NodeSyncArrays,
                              cfg: RoundConfig, num_rounds: int, spec,
                              true_mean, n_live: int | None = None):
    """Node-kernel twin of :func:`flow_updating_tpu_torch.models.rounds.
    run_rounds_telemetry`: the plain rounds, each followed by one sample
    written into preallocated device rows.  Returns ``(state, series)``.
    ``n_live`` is the real-node prefix of tile-padded layouts (see
    :func:`node_telemetry_sample`)."""
    from flow_updating_tpu_torch.obs.telemetry import SeriesRecorder

    if not spec.enabled:
        raise ValueError(
            "telemetry spec is disabled; run run_rounds_node() instead")
    mean = torch.tensor(true_mean, dtype=state.S.dtype,
                        device=state.S.device)
    rec = SeriesRecorder(num_rounds)
    for i in range(int(num_rounds)):
        state = node_round_step(state, arrs, cfg)
        rec.put(i, node_telemetry_sample(state, arrs, spec, mean, n_live))
    return state, rec.series()


def node_field_sample(s: NodeSyncState, arrs: NodeSyncArrays, spec,
                      mean):
    """One recorded row of per-node fields for the node-collapsed kernel,
    in the kernel's padded layout (the host unpermutes).  Communicating
    rows only (deg > 0), as :func:`node_telemetry_sample` masks; every
    communicating node fires every round in fast sync mode, so
    ``node_fired = t`` on those rows.  Returns ``(row, err, real)``."""
    real = arrs.inv_depp1 < 1.0
    row = {"t": s.t, "active": real.sum(dtype=torch.int32)}
    err = None
    if any(spec.has(f) for f in ("node_err", "node_mass",
                                 "node_mass_residual", "node_conv_round")):
        est = arrs.value + s.G
        r_ex = _ex(real, est)
        err = torch.where(r_ex, est - mean, 0.0)
        if spec.has("node_err"):
            row["node_err"] = err
        if spec.has("node_mass"):
            row["node_mass"] = torch.where(r_ex, est, 0.0)
        if spec.has("node_mass_residual"):
            row["node_mass_residual"] = torch.where(r_ex, est - arrs.value,
                                                    0.0)
    if spec.has("node_fired"):
        row["node_fired"] = real.to(torch.int32) * s.t
    return row, err, real


def run_rounds_node_fields(state: NodeSyncState, arrs: NodeSyncArrays,
                           cfg: RoundConfig, num_rounds: int, spec,
                           true_mean):
    """Node-kernel twin of :func:`flow_updating_tpu_torch.models.rounds.
    run_rounds_fields`: chunks of ``spec.stride`` plain rounds, each
    followed by one field row written into preallocated device tensors,
    the convergence frontier carried on the device.  Returns ``(state,
    conv_round, series)`` in the kernel's padded layout; the round
    counter is a host number, so ``t`` goes into the recorder's host
    rows."""
    from flow_updating_tpu_torch.models.rounds import (
        frontier_update,
        keep_topk,
    )
    from flow_updating_tpu_torch.obs.telemetry import SeriesRecorder

    if not spec.enabled:
        raise ValueError(
            "field spec is disabled; run run_rounds_node() instead")
    stride = spec.stride
    if num_rounds % stride:
        raise ValueError(
            f"num_rounds={num_rounds} must be a multiple of the field "
            f"stride {stride}")
    dev = state.S.device
    mean = torch.tensor(true_mean, dtype=state.S.dtype, device=dev)
    conv = torch.full(state.S.shape[:1], -1, dtype=torch.int32, device=dev)
    rec = SeriesRecorder(num_rounds // stride)
    for i in range(num_rounds // stride):
        for _ in range(stride):
            state = node_round_step(state, arrs, cfg)
        row, err, real = node_field_sample(state, arrs, spec, mean)
        if spec.has("node_conv_round"):
            conv = frontier_update(conv, err, real, state.t, spec.tol)
        if spec.topk:
            row = keep_topk(row, err, spec)
        rec.put(i, row)
    return state, conv, rec.series()


def _node_sample(s: NodeSyncState, arrs: NodeSyncArrays, mean: float):
    """One watcher sample ``(t, rmse, max_abs_err, mass, active)`` as host
    numbers.  Padded rows (degree 0) are masked out, as are isolated real
    nodes, which never communicate."""
    real = arrs.inv_depp1 < 1.0  # deg > 0 <=> 1/(deg+1) < 1
    est = arrs.value + s.G
    feat = int(est[0].numel()) if est.dim() > 1 else 1
    cnt = max(int(real.sum()), 1) * feat
    mask = _ex(real, est)
    err = torch.where(mask, est - mean, 0)
    return (
        s.t,
        float(torch.sqrt((err * err).sum() / cnt)),
        float(err.abs().max()) if err.numel() else 0.0,
        float(torch.where(mask, est, 0).sum()),
        int(real.sum()),
    )
