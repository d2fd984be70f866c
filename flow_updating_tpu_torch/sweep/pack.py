"""Packing: shape-bucketed padding of sweep instances into one bucket.

Counterpart of ``flow_updating_tpu/sweep/pack.py``.  Instances whose
topologies differ in N and E are padded to a shared bucket shape
``(N_pad, E_pad)`` — each axis rounded up to an eighth of a power of two
(:func:`bucket_shape`), so topologies of similar size share a bucket and
very different sizes never do — with the mass-neutral ghost nodes and
failed self-loop pad edges of :mod:`flow_updating_tpu_torch.topology.
padding` (ghosts spread evenly, which caps the uniform row width W of the
bucket's reduction layout).  The real edge arrays stay a bit-identical
prefix of the padded ones, and every per-node reduction folds a lane's
out-edge row in edge order (``sweep_edge_rows``), so each lane computes
exactly its unpadded instance's values on its real slots.

Where the JAX package stacks the lanes on a leading axis for ``jax.vmap``,
a bucket here lays its B lanes end to end as one disjoint graph of
``B * N_pad`` nodes and ``B * E_pad`` edges (:func:`stack_arrays`): lane
b's ``src``/``dst`` are offset by ``b * N_pad`` and its ``rev`` and rows
by ``b * E_pad``, so the round runs unchanged and issues the same
launches whatever B is.  Each lane's traced :class:`RoundParams` is a
``(B,)`` leaf the round spreads over the lane's nodes or edges, the lanes'
keys a ``(B, 2)`` tensor (each lane draws its ``E_pad`` loss words under
its own key), and the adversary's per-lane values are expanded per node
or per edge here.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from flow_updating_tpu_torch.models.config import RoundConfig, RoundParams
from flow_updating_tpu_torch.models.state import (
    check_payload_values,
    init_state,
    stack_lanes,
)
from flow_updating_tpu_torch.topology.graph import EdgeArrays, Topology
from flow_updating_tpu_torch.topology.padding import (
    bucket_ceil as _bucket_ceil,
    edge_rows,
    mask_ghost_state,
    masked_values,
    pad_topology_to as _shared_pad_topology_to,
    row_width,
)
from flow_updating_tpu_torch.utils.device import resolve_device

__all__ = [
    "SweepBucket", "SweepInstance", "bucket_shape", "pack_instance",
    "pack_instances", "pad_topology_to", "row_width", "stack_arrays",
]


def pad_topology_to(topo: Topology, n_pad: int, e_pad: int) -> Topology:
    """Sweep-layout padding: the shared ghost/pad construction with even
    ghost spreading (see topology/padding.py)."""
    return _shared_pad_topology_to(topo, n_pad, e_pad, spread="even")


def bucket_shape(topo: Topology, n_min: int = 8,
                 e_min: int = 16) -> tuple[int, int]:
    """The padded ``(N_pad, E_pad)`` bucket an instance lands in:
    eighth-pow2 rounding of ``N + 1`` / ``E + 1`` (always at least one
    ghost node and one pad edge), floored so tiny instances coalesce."""
    n_pad = max(_bucket_ceil(topo.num_nodes + 1), n_min)
    e_pad = max(_bucket_ceil(topo.num_edges + 1), e_min)
    return n_pad, e_pad


@dataclasses.dataclass(frozen=True)
class SweepInstance:
    """One (topology, seed, params) point of a sweep grid.

    ``drop_rate`` / ``timeout`` / ``latency_scale`` / ``contention_scale``
    override the shared :class:`RoundConfig`'s knobs for this instance only
    (its lane's :class:`RoundParams`); ``None`` inherits the config's.
    ``values`` optionally replaces the topology's node values (``(N,)`` or
    ``(N, D)``); ``tag`` is free-form grid metadata echoed into the sweep
    manifest.  ``adversary`` (an :class:`~flow_updating_tpu_torch.
    scenarios.adversary.Adversary`) plants its faults in this lane only;
    lanes share a bucket only when their adversaries' structure keys
    agree."""

    topo: Topology
    seed: int = 0
    drop_rate: float | None = None
    timeout: int | None = None
    latency_scale: float | None = None
    contention_scale: float | None = None
    values: object | None = None
    adversary: object | None = None
    tag: dict = dataclasses.field(default_factory=dict)

    def params(self, cfg: RoundConfig, device=None) -> RoundParams:
        return RoundParams.from_config(
            cfg, drop_rate=self.drop_rate, timeout=self.timeout,
            latency_scale=self.latency_scale,
            contention_scale=self.contention_scale, device=device)

    def true_mean(self):
        """The lane's convergence target: the mean over its real nodes of
        the values it aggregates (scalar, or ``(D,)``)."""
        if self.values is None:
            return self.topo.true_mean
        return np.asarray(self.values).mean(axis=0)


@dataclasses.dataclass
class SweepBucket:
    """One packed bucket: its lanes' state, arrays and params laid end to
    end (see the module docstring), plus the per-instance bookkeeping."""

    shape: tuple          # (N_pad, E_pad) + feature shape
    states: object        # FlowUpdatingState over B * N_pad nodes
    arrays: EdgeArrays    # lanes = B
    params: RoundParams   # every leaf (B,)
    means: torch.Tensor   # (B,) or (B, D) convergence targets
    n_real: np.ndarray    # (B,) real node counts
    e_real: np.ndarray    # (B,) real directed-edge counts
    meta: list            # per-instance manifest records (dicts)

    @property
    def size(self) -> int:
        return len(self.meta)


def _validate_cfg(cfg: RoundConfig) -> None:
    if cfg.kernel != "edge":
        raise ValueError(
            "the sweep engine batches the edge kernel (per-edge state "
            "vmaps over lanes); kernel='node' collapses state per "
            "topology structure — use kernel='edge'")
    if cfg.delivery not in ("gather", "scatter"):
        raise ValueError(
            f"sweep buckets run delivery='gather'|'scatter'; "
            f"{cfg.delivery!r} plans a per-topology permutation network "
            "(static masks cannot batch across instances)")
    if cfg.segment_impl not in ("auto", "segment"):
        raise ValueError(
            f"sweep buckets run segment_impl='auto'|'segment'; "
            f"{cfg.segment_impl!r} builds per-topology layouts that do "
            "not batch")
    if cfg.contention:
        raise ValueError(
            "contention needs per-topology link route tables, which do "
            "not batch; sweep latency effects go through "
            "RoundParams.latency_scale instead")


def pack_instance(inst: SweepInstance, cfg: RoundConfig,
                  n_pad: int, e_pad: int, width: int | None = None,
                  static_no_drop: bool = False, device=None):
    """Pad and build one lane: ``(state, arrays, params)`` for the given
    bucket shape, on ``device`` (the card unless ``'cpu'`` is given); the
    three run as a bucket of one lane through ``run_rounds(params=)``.
    ``width`` is the bucket's row width (default: this instance's own);
    ``static_no_drop`` leaves the loss draw out (set when no lane of the
    bucket drops messages)."""
    dev = resolve_device(device)
    if cfg.needs_coloring:
        # color the real graph first: the padded copy extends it with -1
        # on its self-loops, so the lane fires the unpadded matchings
        inst.topo.edge_coloring()
    padded = pad_topology_to(inst.topo, n_pad, e_pad)
    arrays = padded.device_arrays(coloring=cfg.needs_coloring, device=dev)
    width = row_width(inst.topo, n_pad, e_pad) if width is None else width
    # column-major: each of the W columns the row fold gathers is one
    # contiguous run of indices
    rows = torch.from_numpy(np.ascontiguousarray(
        edge_rows(padded, width, e_pad).T))
    arrays = arrays.replace(sweep_edge_rows=rows.to(dev, torch.int64).t())
    if cfg.needs_coloring:
        arrays = arrays.replace(
            num_colors=0,
            num_colors_arr=torch.tensor(arrays.num_colors,
                                        dtype=torch.int32, device=dev))
    if inst.adversary is not None:
        # ghost slots never lie, corrupt or drop (they are dead and their
        # links failed anyway)
        arrays = arrays.replace(**inst.adversary.device_leaves(
            n_pad, e_pad, cfg.torch_dtype, device=dev))
    values = None
    if inst.values is not None:
        vals = np.asarray(inst.values, np.float64)
        check_payload_values(vals, inst.topo.num_nodes)
        values = masked_values(vals, n_pad)
    state = init_state(padded, cfg, seed=inst.seed, values=values,
                       device=dev)
    state = mask_ghost_state(state, inst.topo.num_nodes,
                             inst.topo.num_edges)
    params = inst.params(cfg, device=dev)
    if static_no_drop:
        params = params.without_drop()
    return state, arrays, params


def _per_lane(lanes, name: str, n: int):
    """The lanes' 0-d ``name`` values expanded over ``n`` slots each."""
    return torch.cat([getattr(a, name).expand(n) for a in lanes])


def stack_arrays(lanes, n_pad: int, e_pad: int) -> EdgeArrays:
    """B lanes' arrays (from :func:`pack_instance`, one bucket shape) laid
    end to end: one disjoint graph of ``B * n_pad`` nodes and ``B * e_pad``
    edges with ``lanes = B``."""
    lanes = list(lanes)
    B = len(lanes)
    if any(a.drop_perm is not None for a in lanes):
        raise ValueError(
            "a reordered topology's loss alignment (drop_perm) does not "
            "pad; sweep the topology in its original order")

    def cat(name, offset=0):
        return torch.cat([getattr(a, name) + b * offset if offset
                          else getattr(a, name)
                          for b, a in enumerate(lanes)])

    first = lanes[0]
    end = first.row_start.new_full((1,), B * e_pad)
    cols = [a.sweep_edge_rows.t() for a in lanes]     # (W, n_pad) each
    rows = torch.cat([torch.where(c < e_pad, c + b * e_pad, B * e_pad)
                      for b, c in enumerate(cols)], dim=1).t()
    kw = dict(
        src=cat("src", n_pad), dst=cat("dst", n_pad), rev=cat("rev", e_pad),
        out_deg=cat("out_deg"),
        row_start=torch.cat([a.row_start[:-1] + b * e_pad
                             for b, a in enumerate(lanes)] + [end]),
        edge_rank=cat("edge_rank"), delay=cat("delay"), deg_e=cat("deg_e"),
        lanes=B, sweep_edge_rows=rows)
    if first.edge_color is not None:
        kw.update(edge_color=cat("edge_color"),
                  num_colors_arr=_per_lane(lanes, "num_colors_arr", e_pad))
    if first.adv_lie_mask is not None:
        kw.update(adv_lie_mask=cat("adv_lie_mask"),
                  adv_lie_value=_per_lane(lanes, "adv_lie_value", n_pad))
    if first.adv_corrupt_mask is not None:
        kw.update(adv_corrupt_mask=cat("adv_corrupt_mask"),
                  adv_corrupt_gain=_per_lane(lanes, "adv_corrupt_gain",
                                             e_pad))
    if first.adv_silent_mask is not None:
        kw.update(adv_silent_mask=cat("adv_silent_mask"))
    if first.adv_down_mask is not None:
        kw.update(adv_down_mask=cat("adv_down_mask"),
                  adv_down_from=_per_lane(lanes, "adv_down_from", e_pad),
                  adv_down_until=_per_lane(lanes, "adv_down_until", e_pad))
    return EdgeArrays(**kw)


def pack_instances(instances, cfg: RoundConfig,
                   max_batch: int | None = None,
                   n_min: int = 8, e_min: int = 16,
                   device=None) -> list[SweepBucket]:
    """Bucket, pad and lay out ``instances`` as :class:`SweepBucket`\\ s on
    ``device`` (the card unless ``'cpu'`` is given).

    Instances group by ``(bucket_shape, feature_shape)`` and adversary
    structure; each group splits into chunks of at most ``max_batch``
    lanes.  Bucket order and lane order follow the input order, so the
    manifest's instance records stay aligned with the grid fan-out."""
    from flow_updating_tpu_torch.utils.checkpoint import topology_fingerprint

    if max_batch is not None and max_batch < 1:
        raise ValueError(f"max_batch must be >= 1 (got {max_batch}); "
                         "pass None for unbounded buckets")
    _validate_cfg(cfg)
    dev = resolve_device(device)
    groups: dict = {}
    order: list = []
    for idx, inst in enumerate(instances):
        feat = (() if inst.values is None
                else np.asarray(inst.values).shape[1:])
        # the families an adversary plants are part of the bucket's
        # identity (its round runs their operations for every lane); an
        # empty adversary plants none and joins the honest lanes
        adv = (inst.adversary.structure_key()
               if inst.adversary else None)
        shape = bucket_shape(inst.topo, n_min=n_min, e_min=e_min) + feat
        key = (shape, adv)
        if key not in groups:
            groups[key] = []
            order.append(key)
        groups[key].append((idx, inst))

    buckets = []
    for key in order:
        members = groups[key]
        shape = key[0]
        n_pad, e_pad = shape[0], shape[1]
        step = max_batch or len(members)
        for lo in range(0, len(members), step):
            chunk = members[lo: lo + step]
            width = max(row_width(inst.topo, n_pad, e_pad)
                        for _, inst in chunk)
            # a bucket where no lane drops messages leaves the loss draw
            # out of its rounds (the whole bucket must agree)
            no_drop = all(
                (inst.drop_rate if inst.drop_rate is not None
                 else cfg.drop_rate) == 0.0 for _, inst in chunk)
            lanes = [pack_instance(inst, cfg, n_pad, e_pad, width=width,
                                   static_no_drop=no_drop, device=dev)
                     for _, inst in chunk]
            means = torch.stack([
                torch.as_tensor(np.asarray(inst.true_mean()),
                                dtype=cfg.torch_dtype)
                for _, inst in chunk]).to(dev)
            meta = []
            for idx, inst in chunk:
                rec = {
                    "instance": idx,
                    "seed": int(inst.seed),
                    "topology": topology_fingerprint(inst.topo),
                    "params": inst.params(cfg, device="cpu").describe(),
                    "padded_shape": [int(n_pad), int(e_pad)],
                }
                if inst.tag:
                    rec["tag"] = dict(inst.tag)
                meta.append(rec)
            buckets.append(SweepBucket(
                shape=shape,
                states=stack_lanes(ln[0] for ln in lanes),
                arrays=stack_arrays([ln[1] for ln in lanes], n_pad, e_pad),
                params=RoundParams.stack(ln[2] for ln in lanes),
                means=means,
                n_real=np.asarray([i.topo.num_nodes for _, i in chunk]),
                e_real=np.asarray([i.topo.num_edges for _, i in chunk]),
                meta=meta,
            ))
    return buckets
