"""Fixed permutations as Beneš switching networks.

Counterpart of ``flow_updating_tpu/ops/permute.py``.  A static permutation
``y = x[perm]`` is routed on the host through a Beneš network — ``2 log2
n - 1`` columns of 2x2 switches — and applied as a sequence of masked
stages, each ``where(mask, partner(x), x)``:

* :func:`benes_plan` — route an arbitrary permutation (recursive cycle
  2-coloring; the C++ router of :mod:`flow_updating_tpu_torch.native`
  from 2^14 elements, the numpy recursion below, the same masks);
* :func:`spread_plan` — a monotone injective placement as a barrel
  shifter (log2 n masked rolls);
* :func:`fill_forward_stages` — copy each run's head over its run;
* :func:`apply_stages` — the plain per-stage executor over the last axis
  (torch rolls and selects, as the JAX form), the ``spmv='benes'`` route
  on every device.

The fused executor that applies many stages per memory pass — kernel B3
on the card — is :mod:`flow_updating_tpu_torch.ops.fused_passes`.  Plans
are host numpy; :meth:`StagePlan.to` moves the masks to a device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from flow_updating_tpu_torch import native


@dataclasses.dataclass(frozen=True, eq=False)
class StagePlan:
    """Stage sequence of one network.

    ``kind`` per stage: 'swap' (Beneš column: exchange within pairs at
    ``dist``, ``x[p] <- x[p ^ dist]`` where the mask is set) or 'roll'
    (barrel-shifter stage: take the value ``dist`` positions to the
    left).  ``masks`` are ``(n,)`` bool numpy arrays."""

    n: int
    dists: tuple
    kinds: tuple          # 'swap' | 'roll'
    masks: tuple          # (n,) bool per stage

    @classmethod
    def from_numpy(cls, n, dists, kinds, masks) -> StagePlan:
        """A plan from another plan's fields as numpy arrays (the JAX
        package's ``StagePlan`` carries the same four)."""
        return cls(n=int(n), dists=tuple(int(d) for d in dists),
                   kinds=tuple(str(k) for k in kinds),
                   masks=tuple(np.asarray(m, bool) for m in masks))

    def to(self, device) -> tuple:
        """The stage masks as bool tensors on ``device``."""
        return tuple(torch.from_numpy(np.ascontiguousarray(m)).to(device)
                     for m in self.masks)


def _route_block(p: np.ndarray) -> np.ndarray:
    """2-color the inputs of one Beneš recursion block.

    ``p`` is the block-local permutation (output o takes input ``p[o]``).
    Constraints: input pair (i, i^h) differ; sources of output pair
    (o, o^h) differ.  The constraint graph is a disjoint union of even
    cycles — walk each, alternating colors."""
    m = len(p)
    h = m // 2
    pinv = np.empty(m, np.int64)
    pinv[p] = np.arange(m, dtype=np.int64)
    color = np.full(m, -1, np.int8)
    for s in range(m):
        if color[s] != -1:
            continue
        i, c = s, 0
        while color[i] == -1:
            color[i] = c
            partner = i ^ h
            color[partner] = 1 - c
            i = int(p[pinv[partner] ^ h])
    return color


#: from this network width on, :func:`benes_plan` routes in C++
NATIVE_MIN_N = 1 << 14


def benes_route_numpy(perm: np.ndarray) -> list:
    """The Beneš swap masks of ``y = x[perm]`` by the numpy recursion
    (the same masks as the C++ router, hours slower at 2^23)."""
    n = len(perm)
    k = n.bit_length() - 1
    masks = [np.zeros(n, bool) for _ in range(2 * k - 1)]
    perms = {0: np.asarray(perm, np.int64)}
    for level in range(k - 1):
        m = n >> level
        h = m >> 1
        nxt = {}
        for start, p in perms.items():
            color = _route_block(p)
            swap_in = color[:h] == 1
            masks[level][start: start + h] = swap_in
            masks[level][start + h: start + m] = swap_in
            pcol = color[p]
            swap_out = pcol[:h] == 1
            out_s = 2 * k - 2 - level
            masks[out_s][start: start + h] = swap_out
            masks[out_s][start + h: start + m] = swap_out
            up = np.where(pcol[:h] == 0, p[:h], p[h:m])
            lo = np.where(pcol[:h] == 0, p[h:m], p[:h])
            nxt[start] = up % h
            nxt[start + h] = lo % h
        perms = nxt
    for start, p in perms.items():   # middle column, size-2 blocks
        sw = p[0] == 1
        masks[k - 1][start] = sw
        masks[k - 1][start + 1] = sw
    return masks


def benes_plan(perm: np.ndarray) -> StagePlan:
    """Swap-stage plan computing ``y = x[perm]`` for a power-of-two n."""
    perm = np.asarray(perm, np.int64)
    n = len(perm)
    if n & (n - 1) or n < 2:
        raise ValueError("benes_plan needs power-of-two length >= 2")
    if np.any(np.sort(perm) != np.arange(n)):
        raise ValueError("not a permutation")
    k = n.bit_length() - 1
    masks = (native.benes_route(perm) if n >= NATIVE_MIN_N
             else benes_route_numpy(perm))
    dists = [n >> (level + 1) for level in range(k)]
    dists = dists + dists[-2::-1]
    return StagePlan(n=n, dists=tuple(dists), kinds=("swap",) * (2 * k - 1),
                     masks=tuple(masks))


def spread_plan(targets: np.ndarray, n: int) -> StagePlan:
    """Roll-stage plan placing ``x[i]`` at ``targets[i]`` (strictly
    increasing, ``targets[i] >= i``); other positions end up with
    unspecified junk.  Monotone non-crossing moves are realized bit by
    bit (largest shift first); the host simulation tracks the exact
    occupancy, so reads never hit a vacated slot."""
    targets = np.asarray(targets, np.int64)
    if len(targets) and (np.any(np.diff(targets) <= 0)
                        or targets[-1] >= n
                        or np.any(targets < np.arange(len(targets)))):
        raise ValueError("targets must be strictly increasing, >= index, < n")
    offset = targets - np.arange(len(targets), dtype=np.int64)
    maxbit = int(offset.max()).bit_length() if len(targets) else 0
    pos = np.arange(len(targets), dtype=np.int64)
    dists, kinds, masks = [], [], []
    for k in range(maxbit - 1, -1, -1):
        d = 1 << k
        move = (offset & d) != 0
        mask = np.zeros(n, bool)
        mask[pos[move] + d] = True
        pos = pos + np.where(move, d, 0)
        dists.append(d)
        kinds.append("roll")
        masks.append(mask)
    return StagePlan(n=n, dists=tuple(dists), kinds=tuple(kinds),
                     masks=tuple(masks))


def fill_forward_stages(run_id: np.ndarray) -> StagePlan:
    """Roll-stage plan copying each run's head value over the whole run.

    ``run_id`` (n,) is a non-decreasing array of run labels; stage k
    copies from ``2^k`` to the left exactly where bit k of the position's
    distance to its run head is set (ascending bit order composes within
    a run)."""
    run_id = np.asarray(run_id)
    n = len(run_id)
    heads = np.zeros(n, bool)
    heads[0] = True
    heads[1:] = run_id[1:] != run_id[:-1]
    head_pos = np.maximum.accumulate(
        np.where(heads, np.arange(n, dtype=np.int64), -1))
    dist = np.arange(n, dtype=np.int64) - head_pos
    maxbit = int(dist.max()).bit_length() if n else 0
    dists, kinds, masks = [], [], []
    for k in range(maxbit):
        dists.append(1 << k)
        kinds.append("roll")
        masks.append(((dist >> k) & 1).astype(bool))
    return StagePlan(n=n, dists=tuple(dists), kinds=tuple(kinds),
                     masks=tuple(masks))


def next_pow2(x: int) -> int:
    """Smallest power of two >= x, floored at 2 (network minimum)."""
    return 1 << max(x - 1, 1).bit_length()


def concat_plans(*plans: StagePlan) -> StagePlan:
    n = plans[0].n
    if any(p.n != n for p in plans):
        raise ValueError("concatenated plans must share their width")
    return StagePlan(
        n=n,
        dists=sum((p.dists for p in plans), ()),
        kinds=sum((p.kinds for p in plans), ()),
        masks=sum((p.masks for p in plans), ()),
    )


@dataclasses.dataclass(frozen=True, eq=False)
class PaddedPermPlan:
    """A permutation on [0, n) routed through a power-of-two Beneš network
    (identity on the padding)."""

    n: int
    stages: StagePlan

    def to(self, device) -> tuple:
        """The stage masks :func:`apply_padded_perm` takes, on ``device``."""
        return self.stages.to(device)


@dataclasses.dataclass(frozen=True, eq=False)
class FusedPaddedPermPlan:
    """:class:`PaddedPermPlan` whose stages run as fused passes
    (``delivery='benes_fused'``; kernel B3 on the card)."""

    n: int
    stages: StagePlan
    fused: object        # fused_passes.FusedPlan

    @classmethod
    def from_plan(cls, base: PaddedPermPlan) -> FusedPaddedPermPlan:
        """Plan ``base``'s routed stages for the fused executor (at every
        width: the card's tile shrinks to the network)."""
        from flow_updating_tpu_torch.ops.fused_passes import plan_fused

        return cls(n=base.n, stages=base.stages,
                   fused=plan_fused(base.stages))

    def to(self, device) -> tuple:
        """The fused passes' mask planes, on ``device``."""
        from flow_updating_tpu_torch.ops.fused_passes import mask_planes

        return mask_planes(self.stages, self.fused, device)


def padded_perm_plan(perm: np.ndarray) -> PaddedPermPlan:
    """Beneš plan for ``y = x[perm]`` with arbitrary (non-power-of-two)
    length; the network is padded to the next power of two."""
    perm = np.asarray(perm, np.int64)
    n = len(perm)
    P = next_pow2(n)
    full = np.concatenate([perm, np.arange(n, P, dtype=np.int64)])
    return PaddedPermPlan(n=n, stages=benes_plan(full))


def apply_padded_perm(x: torch.Tensor, plan, masks) -> torch.Tensor:
    """Apply over the last axis (``masks`` from the plan's ``to``); pads to
    the network width and slices back.  A :class:`FusedPaddedPermPlan`
    runs the fused passes, a :class:`PaddedPermPlan` the per-stage
    executor."""
    pad = plan.stages.n - plan.n
    if pad:
        x = torch.cat([x, x.new_zeros(x.shape[:-1] + (pad,))], dim=-1)
    if isinstance(plan, FusedPaddedPermPlan):
        from flow_updating_tpu_torch.ops.fused_passes import apply_fused

        y = apply_fused(x, plan.fused, masks)
    else:
        y = apply_stages(x, plan.stages, masks)
    return y[..., : plan.n]


def apply_stages(x: torch.Tensor, plan: StagePlan, masks) -> torch.Tensor:
    """Run the plan's stages over the LAST axis of ``x`` (leading batch
    dims share the masks).  ``masks`` are the stage masks as bool tensors
    on ``x``'s device (:meth:`StagePlan.to`).  A swap at power-of-two
    ``dist`` is the butterfly ``x[p] <- x[p ^ dist]``, written as two
    rolls and two selects exactly as the JAX form; a roll takes the value
    ``dist`` to the left (circularly)."""
    n = plan.n
    if x.shape[-1] != n:
        raise ValueError(f"apply_stages: last axis {x.shape[-1]}, plan "
                         f"width {n}")
    iota = None
    for dist, kind, mask in zip(plan.dists, plan.kinds, masks):
        if kind == "swap":
            if dist & (dist - 1):
                raise ValueError(
                    f"swap distance {dist} is not a power of two")
            if iota is None:
                iota = torch.arange(n, dtype=torch.int64, device=x.device)
            hi = (iota & dist) != 0
            x = torch.where(
                mask & hi, torch.roll(x, dist, -1),
                torch.where(mask & ~hi, torch.roll(x, -dist, -1), x))
        else:
            x = torch.where(mask, torch.roll(x, dist, -1), x)
    return x
