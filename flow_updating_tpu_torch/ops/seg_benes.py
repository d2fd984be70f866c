"""Gather- and scatter-free per-node reductions and broadcasts for the edge
kernel (``segment_impl='benes'|'benes_fused'``).

Counterpart of ``flow_updating_tpu/ops/seg_benes.py``.  The edge kernel's
graph operations are a **segment reduce** (sum/min/max/all over each
node's out-edges) and a **broadcast** (``x[src]``: a node's value to each
of its out-edges).  Both are static graph structure, so both become
switching circuits (:mod:`.permute`):

    reduce(x)    = extract_benes( segmented_scan(x) )[:N]
    broadcast(v) = fill_forward( place_benes(v) )[:E]

The segmented Hillis–Steele scan and the fill-forward need no stored
masks: stage ``d = 2^k`` takes ``x[p - d]`` where ``dist[p] >= d`` (scan)
or where bit ``k`` of ``dist[p]`` is set (fill), ``dist`` being each
edge's rank in its CSR row (0 on the padding).  Only the two Beneš
permutations carry masks, planned once per topology:

* extraction maps each node of degree > 0 to its row end, and each
  isolated node to an identity slot in the padding;
* placement maps node ``v`` to ``row_start[v]``, the head of its run.

``segment_impl='benes'`` runs every stage as plain torch ops (the JAX
package's XLA loop).  ``'benes_fused'`` runs the networks as fused passes
(kernel B3) and the scan and fill as kernel B4
(:func:`~.fused_passes.segscan_pass`, :func:`~.fused_passes.fill_pass`);
on a CUDA tensor both always launch, whatever the width and the degree
(JAX keeps its XLA loop below 1,024 elements and above its halo budget;
the port splits long stage lists over several B4 launches instead).  B3
and B4 move 4- and 8-byte words, so boolean lanes ride as int32 or as the
float lane dtype and are converted back.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from flow_updating_tpu_torch.ops.fused_passes import (
    apply_fused,
    dist_stage,
    fill_pass,
    geometry,
    mask_planes,
    plan_fused,
    scan_identity,
    segscan_pass,
)
from flow_updating_tpu_torch.ops.permute import (
    StagePlan,
    apply_stages,
    benes_plan,
    next_pow2,
)


@dataclasses.dataclass(frozen=True, eq=False)
class SegmentedPlan:
    """Host-side plan of one topology's segment networks."""

    N: int               # node count (reduce output length)
    E: int               # directed edge count (broadcast output length)
    P: int               # power-of-two circuit width >= E + #deg0
    scan_bits: int       # stages in the segmented scan (bit_length(maxdeg-1))
    fill_bits: int       # stages in fill-forward (same bound)
    extract: StagePlan   # row-end -> node id permutation
    place: StagePlan     # node id -> row-head permutation
    extract_fused: object = None   # fused_passes.FusedPlan, or None
    place_fused: object = None     # (segment_impl='benes_fused')
    geom: object = None            # fused_passes.Geometry of B4's passes

    @classmethod
    def from_numpy(cls, N, E, P, scan_bits, fill_bits, extract, place,
                   fused: bool = False,
                   block_rows: int | None = None) -> SegmentedPlan:
        """A plan from another plan's fields, its two networks given as
        objects with ``n``, ``dists``, ``kinds`` and ``masks`` (the JAX
        package's ``StagePlan``); ``fused`` plans the fused passes."""
        ex = StagePlan.from_numpy(extract.n, extract.dists, extract.kinds,
                                  extract.masks)
        pl = StagePlan.from_numpy(place.n, place.dists, place.kinds,
                                  place.masks)
        return _finish(int(N), int(E), int(P), int(scan_bits),
                       int(fill_bits), ex, pl, fused, block_rows)

    @classmethod
    def from_plan(cls, plan: SegmentedPlan, fused: bool,
                  block_rows: int | None = None) -> SegmentedPlan:
        """The same routed networks planned for the fused passes
        (``fused=True``) or the per-stage executor."""
        return _finish(plan.N, plan.E, plan.P, plan.scan_bits,
                       plan.fill_bits, plan.extract, plan.place, fused,
                       block_rows)

    def to(self, device) -> tuple:
        """``(extract_masks, place_masks)`` on ``device``: the fused
        passes' mask planes, or the stage masks."""
        if self.extract_fused is not None:
            return (mask_planes(self.extract, self.extract_fused, device),
                    mask_planes(self.place, self.place_fused, device))
        return self.extract.to(device), self.place.to(device)


def _finish(N, E, P, scan_bits, fill_bits, extract, place, fused,
            block_rows) -> SegmentedPlan:
    extract_fused = place_fused = geom = None
    if fused:
        extract_fused = plan_fused(extract, block_rows)
        place_fused = plan_fused(place, block_rows)
        geom = geometry(P, block_rows)
    return SegmentedPlan(N=N, E=E, P=P, scan_bits=scan_bits,
                         fill_bits=fill_bits, extract=extract, place=place,
                         extract_fused=extract_fused,
                         place_fused=place_fused, geom=geom)


def plan_segments(row_start: np.ndarray, out_deg: np.ndarray,
                  edge_rank: np.ndarray, fused: bool = False,
                  block_rows: int | None = None):
    """Build the plan from the topology's CSR structure.  Returns ``(plan,
    dist)``, ``dist`` the ``(P,)`` int32 plane the scan and fill masks
    derive from (``edge_rank`` padded with 0)."""
    N = len(out_deg)
    E = len(edge_rank)
    deg0 = np.flatnonzero(out_deg == 0)
    P = next_pow2(E + len(deg0))
    maxdeg = int(out_deg.max()) if N else 1
    bits = max(maxdeg - 1, 0).bit_length()

    dist = np.zeros(P, np.int32)
    dist[:E] = edge_rank

    def complete(partial: np.ndarray) -> np.ndarray:
        """Fill the -1 outputs of a partial injective map with the unused
        sources (any order) to make a full permutation."""
        used = np.zeros(len(partial), bool)
        used[partial[partial >= 0]] = True
        out = partial.copy()
        out[out < 0] = np.flatnonzero(~used)
        return out

    # extraction: out[u] = scan[row_end[u]] (deg>0) | identity slot (deg0)
    perm = np.full(P, -1, np.int64)
    pos = np.asarray(out_deg, np.int64) > 0
    perm[np.flatnonzero(pos)] = row_start[1:][pos] - 1
    perm[deg0] = E + np.arange(len(deg0), dtype=np.int64)
    extract = benes_plan(complete(perm))

    # placement: out[row_start[v]] = x[v] for deg>0 v; other outputs take
    # leftover sources (never a run head, never read)
    perm2 = np.full(P, -1, np.int64)
    perm2[row_start[:-1][pos]] = np.flatnonzero(pos)
    place = benes_plan(complete(perm2))
    plan = _finish(N, E, P, bits, bits, extract, place, fused, block_rows)
    return plan, dist


def _apply(z, stages: StagePlan, fused_plan, masks):
    """One permutation application: the fused passes when planned, the
    per-stage executor otherwise."""
    if fused_plan is not None:
        return apply_fused(z, fused_plan, masks)
    return apply_stages(z, stages, masks)


def _to_lanes(x, P: int, fill, L: int):
    """Embed an ``(L,)`` or ``(L, F)`` array into the circuit width as
    ``(P,)`` or ``(F, P)`` lanes.  Returns ``(z, F)``."""
    F = tuple(x.shape[1:])
    if not F:
        z = x.new_full((P,), fill)
        z[:L] = x
        return z, F
    lanes = x.reshape(x.shape[0], -1).T
    z = x.new_full((lanes.shape[0], P), fill)
    z[:, :L] = lanes
    return z, F


def _from_lanes(z, F, out_len: int):
    """Inverse of :func:`_to_lanes`."""
    if not F:
        return z[:out_len]
    return z[:, :out_len].T.reshape((out_len,) + F)


def _dists(bits: int) -> tuple:
    return tuple(1 << k for k in range(bits))


def seg_reduce(x, op: str, plan: SegmentedPlan, dist, extract_masks):
    """Per-node reduction of the ``(E,)`` (or ``(E, F)``) edge array
    ``x`` -> ``(N,)`` (or ``(N, F)``)."""
    ident = scan_identity(op, x.dtype)
    z, F = _to_lanes(x, plan.P, ident, plan.E)
    fused = plan.geom is not None
    if fused:
        if op == "all":
            # booleans scan as int32 min (identity 1) and stay int32
            # through the extraction's word moves
            z = z.to(torch.int32)
        if plan.scan_bits:
            z = segscan_pass(z, dist, _dists(plan.scan_bits),
                             "min" if op == "all" else op, plan.geom)
    else:
        for d in _dists(plan.scan_bits):
            z = dist_stage(z, torch.roll(z, d, -1), dist, d, op)
    out = _from_lanes(_apply(z, plan.extract, plan.extract_fused,
                             extract_masks), F, plan.N)
    return out != 0 if op == "all" and fused else out


def extract_row_ends(x, plan: SegmentedPlan, extract_masks):
    """``(E,)`` (or ``(E, F)``) edge array -> ``(N,)`` (or ``(N, F)``)
    values at each node's LAST out-edge (the ``x[row_start[1:] - 1]``
    gather; isolated nodes read 0)."""
    z, F = _to_lanes(x, plan.P, 0, plan.E)
    return _from_lanes(
        _apply(z, plan.extract, plan.extract_fused, extract_masks),
        F, plan.N)


def _lane_dtype(dtypes) -> torch.dtype:
    dt = torch.float32
    for d in dtypes:
        dt = torch.promote_types(dt, d)
    return dt


def seg_reduce_multi(xs_ops, plan: SegmentedPlan, dist, extract_masks):
    """Several per-node reductions sharing one batched extraction.

    ``xs_ops``: sequence of ``(x (E,), op)``.  The 'sum' lanes already in
    the common float dtype scan as one batch, 'all' lanes as a float min
    over {0, 1}; those lanes then ride ONE batched extraction.  min/max
    lanes (whose values the float lane could round) take the per-call
    :func:`seg_reduce`.  Returns the ``(N,)`` results in input order."""
    if plan.geom is None or not plan.scan_bits:
        return [seg_reduce(x, op, plan, dist, extract_masks)
                for x, op in xs_ops]
    dt = _lane_dtype([x.dtype for x, _ in xs_ops])
    dists = _dists(plan.scan_bits)
    dev = xs_ops[0][0].device
    lanes = [None] * len(xs_ops)
    sums = [(i, x) for i, (x, op) in enumerate(xs_ops)
            if op == "sum" and x.dtype == dt]
    if sums:
        z = torch.zeros((len(sums), plan.P), dtype=dt, device=dev)
        for j, (_, x) in enumerate(sums):
            z[j, : plan.E] = x
        z = segscan_pass(z, dist, dists, "sum", plan.geom)
        for j, (i, _) in enumerate(sums):
            lanes[i] = z[j]
    for i, (x, op) in enumerate(xs_ops):
        if op == "all":
            z = torch.ones((plan.P,), dtype=dt, device=dev)
            z[: plan.E] = x.to(torch.int32).to(dt)
            lanes[i] = segscan_pass(z, dist, dists, "min", plan.geom)
    batched = [ln for ln in lanes if ln is not None]
    if not batched:
        return [seg_reduce(x, op, plan, dist, extract_masks)
                for x, op in xs_ops]
    out = _apply(torch.stack(batched), plan.extract, plan.extract_fused,
                 extract_masks)[:, : plan.N]
    results = []
    j = 0
    for i, (x, op) in enumerate(xs_ops):
        if lanes[i] is None:
            results.append(seg_reduce(x, op, plan, dist, extract_masks))
            continue
        r = out[j]
        j += 1
        results.append(r != 0 if op == "all" else r.to(x.dtype))
    return results


def broadcast_multi(vs, plan: SegmentedPlan, dist, place_masks):
    """Several node->edge broadcasts through one batched placement and
    fill-forward.  ``vs``: sequence of ``(N,)`` arrays (booleans ride the
    float lane dtype); returns the ``(E,)`` results in input order."""
    if plan.geom is None:
        return [broadcast(v, plan, dist, place_masks) for v in vs]
    dt = _lane_dtype([v.dtype for v in vs])
    z = torch.zeros((len(vs), plan.P), dtype=dt, device=vs[0].device)
    for j, v in enumerate(vs):
        z[j, : plan.N] = v
    z = _apply(z, plan.place, plan.place_fused, place_masks)
    if plan.fill_bits:
        z = fill_pass(z, dist, _dists(plan.fill_bits), plan.geom)
    out = z[:, : plan.E]
    return [r > 0.5 if v.dtype == torch.bool else r.to(v.dtype)
            for v, r in zip(vs, out)]


def broadcast(v, plan: SegmentedPlan, dist, place_masks):
    """Node array ``(N,)`` (or ``(N, F)``) -> per-out-edge array ``(E,)``
    (or ``(E, F)``): the ``v[src]`` gather, gather-free."""
    is_bool = v.dtype == torch.bool and plan.geom is not None
    z, F = _to_lanes(v.to(torch.int32) if is_bool else v, plan.P, 0,
                     plan.N)
    z = _apply(z, plan.place, plan.place_fused, place_masks)
    if plan.geom is not None and plan.fill_bits:
        z = fill_pass(z, dist, _dists(plan.fill_bits), plan.geom)
    else:
        for d in _dists(plan.fill_bits):
            z = dist_stage(z, torch.roll(z, d, -1), dist, d, "fill")
    out = _from_lanes(z, F, plan.E)
    return out != 0 if is_bool else out
