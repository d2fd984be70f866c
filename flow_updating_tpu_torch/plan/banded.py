"""Banded neighbor sums: occupied diagonals as dense masked rolls.

Counterpart of ``flow_updating_tpu/plan/banded.py``.  After RCM
reordering, most edges of a structured-ish graph sit on a few near-full
diagonals of the adjacency.  Each kept diagonal ``d`` contributes
``where(mask_d, roll(x, -d), 0)`` to the neighbor sum; edges on
low-occupancy diagonals form the *remainder*, routed through either

* a plain bucketed ELL gather + row sums
  (:func:`flow_updating_tpu_torch.ops.spmv.neighbor_sum`), or
* ``remainder='benes'``: the Beneš permutation network of
  :mod:`flow_updating_tpu_torch.ops.spmv_benes` over the remainder's ELL
  matrices, and a second, padded network that un-permutes the
  bucket-ordered rows back to RCM order — both unfused (per-stage torch
  ops), as in the JAX package.

``remainder='auto'`` resolves to ``'gather'`` here, where the JAX package
picks ``'benes'`` for large remainders when its C++ router is present: on
the card the gather is native, and parity between the packages is on
results, not on planning choices.

The plan (:class:`BandedSpmvPlan`) is static host metadata; the arrays
travel separately as :class:`BandedLeaves` tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from flow_updating_tpu_torch.models.state import _ex
from flow_updating_tpu_torch.ops.permute import (
    apply_padded_perm,
    padded_perm_plan,
)
from flow_updating_tpu_torch.ops.spmv import neighbor_sum
from flow_updating_tpu_torch.ops.spmv_benes import (
    neighbor_sum_benes,
    plan_neighbor_sum,
)


@dataclasses.dataclass(frozen=True)
class BandedLeaves:
    """Tensors of one banded plan."""

    band_masks: tuple      # per kept offset: (n,) bool — row u has edge u->u+d
    rem_mats: tuple = ()   # 'gather': bucketed (rows, w) int32 neighbor mats
    #                        in RCM node space (pad index n -> zero slot)
    rem_pos: torch.Tensor | None = None  # 'gather': (n,) int64 — RCM row ->
    #                                      bucket position
    rem_ns_masks: tuple = ()      # 'benes': remainder network stage masks
    rem_unperm_masks: tuple = ()  # 'benes': bucket-order -> RCM-order masks

    def to(self, device) -> BandedLeaves:
        return BandedLeaves(
            band_masks=tuple(m.to(device) for m in self.band_masks),
            rem_mats=tuple(m.to(device) for m in self.rem_mats),
            rem_pos=None if self.rem_pos is None else self.rem_pos.to(device),
            rem_ns_masks=tuple(m.to(device) for m in self.rem_ns_masks),
            rem_unperm_masks=tuple(m.to(device)
                                   for m in self.rem_unperm_masks),
        )


@dataclasses.dataclass(frozen=True, eq=False)
class BandedSpmvPlan:
    """Static banded-spmv descriptor.

    ``offsets`` are the kept signed diagonals in ascending order;
    ``rem_mode`` is 'none' | 'gather' | 'benes'."""

    n: int                     # real node count (RCM space)
    offsets: tuple             # kept signed diagonals, ascending
    in_band_edges: int
    remainder_edges: int
    rem_mode: str
    rem_bucket_shapes: tuple = ()
    rem_ns_plan: object = None       # 'benes': spmv_benes.NeighborSumPlan
    rem_unperm_plan: object = None   # 'benes': permute.PaddedPermPlan

    @property
    def coverage(self) -> float:
        """In-band fraction of the directed edges."""
        total = self.in_band_edges + self.remainder_edges
        return self.in_band_edges / total if total else 1.0


def _remainder_ell(n: int, src: np.ndarray, dst: np.ndarray):
    """Degree-bucketed ELL matrices for the remainder adjacency, rows
    grouped by next-pow2 remainder degree (stored width = the bucket's
    true max degree).  Returns ``(mats, pos)`` with ``pos[row] =
    position of RCM row`` in the concatenated bucket output."""
    deg = np.bincount(src, minlength=n).astype(np.int64)
    row_start = np.zeros(n + 1, np.int64)
    np.cumsum(deg, out=row_start[1:])
    wkey = np.zeros(n, np.int64)
    nz = deg > 0
    wkey[nz] = 1 << np.ceil(np.log2(deg[nz])).astype(np.int64)
    order = np.argsort(wkey, kind="stable").astype(np.int64)
    pos = np.empty(n, np.int64)
    pos[order] = np.arange(n, dtype=np.int64)
    mats = []
    sorted_w = wkey[order]
    start = 0
    while start < n:
        key = sorted_w[start]
        end = int(np.searchsorted(sorted_w, key, side="right"))
        rows = order[start:end]
        w = int(deg[rows].max()) if key else 0
        if w == 0:
            mats.append(np.empty((len(rows), 0), np.int32))
        else:
            lo = row_start[rows]
            d = deg[rows]
            ar = np.arange(w, dtype=np.int64)
            valid = ar[None, :] < d[:, None]
            col = np.where(valid, lo[:, None] + ar[None, :], 0)
            mats.append(np.where(valid, dst[col], n).astype(np.int32))
        start = end
    return tuple(mats), pos.astype(np.int32)


def build_banded(n: int, src: np.ndarray, dst: np.ndarray, *,
                 max_lanes: int = 96, min_fill: float = 0.05,
                 remainder: str = "auto", features: int = 0,
                 ) -> tuple[BandedSpmvPlan, BandedLeaves]:
    """Build the banded plan for an adjacency already in RCM node order.

    A diagonal is kept as a band lane while it holds at least
    ``min_fill * n`` edges, up to ``max_lanes`` lanes (most-occupied
    first).  ``remainder`` is 'auto' | 'gather' | 'benes' | 'none'
    ('none' raises if any edge is left over, 'auto' = 'gather').
    ``features`` declares a vector payload, which the rolls and the
    gather remainder broadcast over ('benes' packs scalar lanes and
    refuses it).  Leaves are CPU tensors."""
    if remainder not in ("auto", "gather", "benes", "none"):
        raise ValueError(f"unknown remainder route {remainder!r}")
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    E = len(src)
    offs = dst - src
    uq, counts = (np.unique(offs, return_counts=True) if E
                  else (np.empty(0, np.int64), np.empty(0, np.int64)))
    rank = np.argsort(-counts, kind="stable")
    uq, counts = uq[rank], counts[rank]
    keep_mask = counts >= max(min_fill * n, 1.0)
    kept = uq[keep_mask][:max_lanes]
    kept = np.sort(kept)

    band_masks = []
    in_band = np.zeros(E, bool)
    for d in kept:
        sel = offs == d
        m = np.zeros(n, bool)
        m[src[sel]] = True
        band_masks.append(m)
        in_band |= sel
    n_in = int(in_band.sum())
    rem_src, rem_dst = src[~in_band], dst[~in_band]
    n_rem = E - n_in

    mode = remainder
    if mode == "none" and n_rem:
        raise ValueError(
            f"remainder='none' but {n_rem} edge(s) fall outside the "
            f"{len(kept)} kept band(s) — allow a remainder path "
            "('gather'/'benes'/'auto') or widen min_fill/max_lanes")
    if n_rem == 0:
        mode = "none"
    elif mode == "auto":
        mode = "gather"
    if features and mode == "benes":
        raise ValueError(
            "remainder='benes' packs scalar lanes; vector payloads "
            "route the remainder through 'gather'")

    rem_mats: tuple = ()
    rem_pos = None
    shapes: tuple = ()
    ns_plan = unperm_plan = None
    ns_masks: tuple = ()
    unperm_masks: tuple = ()
    if mode in ("gather", "benes"):
        rem_mats, rem_pos = _remainder_ell(n, rem_src, rem_dst)
        shapes = tuple(m.shape for m in rem_mats)
        if mode == "benes":
            # m1 = n + 1: the zero slot follows the generic convention
            ns_plan = plan_neighbor_sum(rem_mats, n + 1)
            ns_masks = ns_plan.to("cpu")
            unperm_plan = padded_perm_plan(rem_pos.astype(np.int64))
            unperm_masks = unperm_plan.to("cpu")
            rem_mats, rem_pos = (), None  # the network replaces the gather

    leaves = BandedLeaves(
        band_masks=tuple(torch.from_numpy(m) for m in band_masks),
        rem_mats=tuple(torch.from_numpy(m) for m in rem_mats),
        rem_pos=(None if rem_pos is None
                 else torch.from_numpy(rem_pos.astype(np.int64))),
        rem_ns_masks=ns_masks, rem_unperm_masks=unperm_masks,
    )
    plan = BandedSpmvPlan(
        n=n, offsets=tuple(int(d) for d in kept), in_band_edges=n_in,
        remainder_edges=n_rem, rem_mode=mode, rem_bucket_shapes=shapes,
        rem_ns_plan=ns_plan, rem_unperm_plan=unperm_plan,
    )
    return plan, leaves


def _pad_to(acc: torch.Tensor, rows: int) -> torch.Tensor:
    if acc.shape[0] == rows:
        return acc
    pad = acc.new_zeros((rows - acc.shape[0],) + acc.shape[1:])
    return torch.cat([acc, pad])


def banded_neighbor_sum(x: torch.Tensor, plan: BandedSpmvPlan,
                        leaves: BandedLeaves) -> torch.Tensor:
    """A(x) over the first ``plan.n`` entries of a (possibly padded)
    RCM-ordered vector; padding slots get 0.  ``x`` may carry a trailing
    feature axis."""
    n = plan.n
    xv = x[:n]
    acc = torch.zeros_like(xv)
    for d, mask in zip(plan.offsets, leaves.band_masks):
        contrib = torch.roll(xv, -d, 0)
        acc = acc + torch.where(_ex(mask, xv), contrib, 0)
    if plan.rem_mode in ("gather", "benes"):
        acc = acc + _remainder_term(xv, plan, leaves)
    return _pad_to(acc, x.shape[0])


def _remainder_term(xv: torch.Tensor, plan: BandedSpmvPlan,
                    leaves: BandedLeaves) -> torch.Tensor:
    """The remainder addend for an ``(n, ...)`` plan-order vector — THE
    one implementation both :func:`banded_neighbor_sum` and
    :func:`banded_remainder_sum` add, so the fused round's
    ``rem_route='lanes'`` bit-parity contract cannot drift."""
    if plan.rem_mode == "gather":
        return neighbor_sum(xv, leaves.rem_mats)[leaves.rem_pos]
    a = neighbor_sum_benes(xv, plan.rem_ns_plan, leaves.rem_ns_masks)
    return apply_padded_perm(a, plan.rem_unperm_plan,
                             leaves.rem_unperm_masks)


def banded_remainder_sum(x: torch.Tensor, plan: BandedSpmvPlan,
                         leaves: BandedLeaves) -> torch.Tensor:
    """The remainder-only addend of :func:`banded_neighbor_sum` (zeros
    when the plan has no remainder), padded like ``x`` — the
    ``rem_route='lanes'`` input of the one-kernel fused round."""
    n = plan.n
    xv = x[:n]
    if plan.rem_mode in ("gather", "benes"):
        acc = _remainder_term(xv, plan, leaves)
    else:
        acc = torch.zeros_like(xv)
    return _pad_to(acc, x.shape[0])
