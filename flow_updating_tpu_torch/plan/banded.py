"""Banded neighbor sums: occupied diagonals as dense masked rolls.

Counterpart of ``flow_updating_tpu/plan/banded.py``.  After RCM
reordering, most edges of a structured-ish graph sit on a few near-full
diagonals of the adjacency.  Each kept diagonal ``d`` contributes
``where(mask_d, roll(x, -d), 0)`` to the neighbor sum; edges on
low-occupancy diagonals form the *remainder*, summed by a plain bucketed
ELL gather (:func:`flow_updating_tpu_torch.ops.spmv.neighbor_sum`).

The JAX package can also route the remainder through a Beneš
permutation network (``remainder='benes'``); that route is the ROADMAP
item "Beneš circuits and their kernels (A6, B3/B4)" and raises here.
``remainder='auto'`` resolves to ``'gather'``.

The plan (:class:`BandedSpmvPlan`) is static host metadata; the arrays
travel separately as :class:`BandedLeaves` tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from flow_updating_tpu_torch.models.state import _ex
from flow_updating_tpu_torch.ops.spmv import neighbor_sum


@dataclasses.dataclass(frozen=True)
class BandedLeaves:
    """Tensors of one banded plan."""

    band_masks: tuple      # per kept offset: (n,) bool — row u has edge u->u+d
    rem_mats: tuple = ()   # 'gather': bucketed (rows, w) int32 neighbor mats
    #                        in RCM node space (pad index n -> zero slot)
    rem_pos: torch.Tensor | None = None  # 'gather': (n,) int64 — RCM row ->
    #                                      bucket position

    def to(self, device) -> BandedLeaves:
        return BandedLeaves(
            band_masks=tuple(m.to(device) for m in self.band_masks),
            rem_mats=tuple(m.to(device) for m in self.rem_mats),
            rem_pos=None if self.rem_pos is None else self.rem_pos.to(device),
        )


@dataclasses.dataclass(frozen=True, eq=False)
class BandedSpmvPlan:
    """Static banded-spmv descriptor.

    ``offsets`` are the kept signed diagonals in ascending order;
    ``rem_mode`` is 'none' | 'gather'."""

    n: int                     # real node count (RCM space)
    offsets: tuple             # kept signed diagonals, ascending
    in_band_edges: int
    remainder_edges: int
    rem_mode: str
    rem_bucket_shapes: tuple = ()

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
    first).  ``remainder`` is 'auto' | 'gather' | 'none' ('none' raises
    if any edge is left over, 'auto' = 'gather'; 'benes' raises).
    ``features`` declares a vector payload, which the rolls and the
    gather remainder both broadcast over.  Leaves are CPU tensors."""
    if remainder == "benes":
        raise NotImplementedError(
            "remainder='benes' routes the remainder through a Beneš "
            "permutation network — the ROADMAP item 'Beneš circuits and "
            "their kernels (A6, B3/B4)', not ported yet; use 'gather'")
    if remainder not in ("auto", "gather", "none"):
        raise ValueError(f"unknown remainder route {remainder!r}")
    del features  # both remainder routes of the port broadcast over D
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
            "('gather'/'auto') or widen min_fill/max_lanes")
    if n_rem == 0:
        mode = "none"
    elif mode == "auto":
        mode = "gather"

    rem_mats: tuple = ()
    rem_pos = None
    shapes: tuple = ()
    if mode == "gather":
        rem_mats, rem_pos = _remainder_ell(n, rem_src, rem_dst)
        shapes = tuple(m.shape for m in rem_mats)

    leaves = BandedLeaves(
        band_masks=tuple(torch.from_numpy(m) for m in band_masks),
        rem_mats=tuple(torch.from_numpy(m) for m in rem_mats),
        rem_pos=(None if rem_pos is None
                 else torch.from_numpy(rem_pos.astype(np.int64))),
    )
    plan = BandedSpmvPlan(
        n=n, offsets=tuple(int(d) for d in kept), in_band_edges=n_in,
        remainder_edges=n_rem, rem_mode=mode, rem_bucket_shapes=shapes,
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
    if plan.rem_mode == "gather":
        acc = acc + _remainder_term(xv, plan, leaves)
    return _pad_to(acc, x.shape[0])


def _remainder_term(xv: torch.Tensor, plan: BandedSpmvPlan,
                    leaves: BandedLeaves) -> torch.Tensor:
    """The remainder addend for an ``(n, ...)`` plan-order vector — THE
    one implementation both :func:`banded_neighbor_sum` and
    :func:`banded_remainder_sum` add, so the fused round's
    ``rem_route='lanes'`` bit-parity contract cannot drift."""
    del plan  # one remainder route ('gather') in this package
    return neighbor_sum(xv, leaves.rem_mats)[leaves.rem_pos]


def banded_remainder_sum(x: torch.Tensor, plan: BandedSpmvPlan,
                         leaves: BandedLeaves) -> torch.Tensor:
    """The remainder-only addend of :func:`banded_neighbor_sum` (zeros
    when the plan has no remainder), padded like ``x`` — the
    ``rem_route='lanes'`` input of the one-kernel fused round."""
    n = plan.n
    xv = x[:n]
    if plan.rem_mode == "gather":
        acc = _remainder_term(xv, plan, leaves)
    else:
        acc = torch.zeros_like(xv)
    return _pad_to(acc, x.shape[0])
