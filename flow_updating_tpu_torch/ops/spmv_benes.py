"""Gather-free neighbor sum: the adjacency SpMV as a permutation network.

Counterpart of ``flow_updating_tpu/ops/spmv_benes.py``, the node kernel's
``spmv='benes'`` (per-stage torch ops) and ``spmv='benes_fused'`` (fused
passes, kernel B3 on the card).  All maps are topology constants planned
on the host once:

    x[idx_flat]  =  permute_benes( fill_forward( spread(x) ) )

* ``spread``: place ``x[v]`` at the first slot of value v's run in the
  sorted index list (monotone injective: a conflict-free barrel shifter).
  A synthetic leading block ``[0, m1)`` in the index list makes every
  value occur, so the sorted runs cover all of x;
* ``fill_forward``: copy each run head over its run;
* ``permute_benes``: route sorted positions back to ELL slots (the
  inverse argsort, an arbitrary permutation, routed by the C++ router at
  scale).

The ELL row sums that follow are plain reductions.  On the H100 the gather
these stages replace is native (``spmv='xla'``/``'pallas'``); the network
is ported for parity with the JAX package and for the delivery and
segment paths that reuse it.

Routed plans are cached in-process and on disk (``FU_PLAN_CACHE``, see
:func:`plan_neighbor_sum`), so a second process on the same topology
loads the routing instead of routing again.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os

import numpy as np
import torch

from flow_updating_tpu_torch.ops.fused_passes import (
    FusedPlan,
    apply_fused,
    mask_planes,
    plan_fused,
)
from flow_updating_tpu_torch.ops.permute import (
    StagePlan,
    apply_stages,
    benes_plan,
    concat_plans,
    fill_forward_stages,
    next_pow2,
    spread_plan,
)


@dataclasses.dataclass(frozen=True, eq=False)
class NeighborSumPlan:
    """Host plan of the network (masks are numpy; :meth:`to` moves them)."""

    m1: int              # padded node-vector length incl. the zero slot
    P: int               # power-of-two network width
    flat_begin: int      # ELL payload offset inside the network domain
    bucket_shapes: tuple  # (rows, width) per ELL bucket
    stages: StagePlan

    def to(self, device) -> tuple:
        """The stage masks :func:`neighbor_sum_benes` takes, on
        ``device``."""
        return self.stages.to(device)


@dataclasses.dataclass(frozen=True, eq=False)
class FusedNeighborSumPlan:
    """:class:`NeighborSumPlan` whose stages run as fused passes
    (``spmv='benes_fused'``) — at every network width."""

    base: NeighborSumPlan
    fused: FusedPlan

    @property
    def m1(self):
        return self.base.m1

    @property
    def P(self):
        return self.base.P

    @property
    def flat_begin(self):
        return self.base.flat_begin

    @property
    def bucket_shapes(self):
        return self.base.bucket_shapes

    def to(self, device) -> tuple:
        """The pass mask planes, on ``device``."""
        return mask_planes(self.base.stages, self.fused, device)


_plan_cache: dict = {}

# The on-disk cache of routed base plans (the JAX package's layout): the
# stage masks bit-packed (8x) and zlib'd in an npz keyed by the content
# hash of the ELL matrices.  FU_PLAN_CACHE=0 turns it off; a path moves
# it; the default is the user's cache directory, never the source tree.
# A failure only warns and replans: the cache never breaks planning.
_logger = logging.getLogger("flow_updating_tpu_torch.spmv_benes")

# Bump when plan_sections / spread_plan / fill_forward_stages /
# benes_plan routing changes: the digest covers only the INPUT mats, so
# without this a stale file would replay a plan from before a fix.
_PLANNER_VERSION = 1
_DISK_FORMAT = 1


def _disk_cache_dir():
    env = os.environ.get("FU_PLAN_CACHE", "")
    if env == "0":
        return None
    if env:
        return env
    # the port's own directory: its routing is its own (the native
    # router of this package), so neither package reads the other's
    # files unasked
    xdg = os.environ.get("XDG_CACHE_HOME", os.path.expanduser("~/.cache"))
    return os.path.join(xdg, "flow_updating_tpu_torch", "plans")


def _disk_path(key0):
    d = _disk_cache_dir()
    if d is None:
        return None
    m1, _shapes, digest = key0
    return os.path.join(d, f"ns_v{_PLANNER_VERSION}_{digest[:20]}_m{m1}.npz")


def _disk_save(key0, plan: NeighborSumPlan) -> None:
    path = _disk_path(key0)
    if path is None:
        return
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        st = plan.stages
        arrays = {f"mask{i}": np.packbits(m) for i, m in enumerate(st.masks)}
        meta = dict(
            format=_DISK_FORMAT, m1=plan.m1, P=plan.P,
            flat_begin=plan.flat_begin,
            bucket_shapes=list(map(list, plan.bucket_shapes)),
            n=st.n, dists=list(st.dists), kinds=list(st.kinds))
        # the trailing .npz makes savez write exactly this path; unlink on
        # failure so aborted writes cannot pile up
        tmp = path + f".{os.getpid()}.tmp.npz"
        try:
            np.savez_compressed(tmp, meta=json.dumps(meta), **arrays)
            os.replace(tmp, path)
        except Exception:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
    except Exception as exc:  # the cache write is best-effort
        _logger.warning("plan disk-cache write failed (%s)", exc)


def _disk_load(key0):
    path = _disk_path(key0)
    if path is None or not os.path.exists(path):
        return None
    try:
        with np.load(path) as z:
            meta = json.loads(str(z["meta"]))
            if meta.get("format") != _DISK_FORMAT:
                return None
            if tuple(tuple(s) for s in meta["bucket_shapes"]) != key0[1]:
                # the digest hashes raw bytes without per-matrix
                # delimiters: never trust a shape-mismatched hit
                return None
            masks = tuple(
                np.unpackbits(z[f"mask{i}"])[: meta["n"]].astype(bool)
                for i in range(len(meta["dists"])))
        stages = StagePlan(n=meta["n"], dists=tuple(meta["dists"]),
                           kinds=tuple(meta["kinds"]), masks=masks)
        return NeighborSumPlan(
            m1=meta["m1"], P=meta["P"], flat_begin=meta["flat_begin"],
            bucket_shapes=tuple(tuple(s) for s in meta["bucket_shapes"]),
            stages=stages)
    except Exception as exc:
        _logger.warning("plan disk-cache read failed (%s); replanning", exc)
        return None


def _mats_key(mats: tuple, m1: int):
    h = hashlib.sha1()
    for m in mats:
        h.update(m.dtype.str.encode())
        h.update(np.ascontiguousarray(m))
    return (m1, tuple(m.shape for m in mats), h.hexdigest())


def plan_neighbor_sum(mats: tuple, m1: int, fused: bool = False):
    """Plan the network for ELL matrices ``mats`` (per-bucket ``(rows,
    width)`` int32 numpy neighbor slots in padded node space, pad value
    ``m1 - 1``, the zero slot; ``m1`` = padded vector length + 1).
    ``fused=True`` also plans the fused passes, at the card's tile.

    Plans are cached on the content of ``mats``: routing the network at
    a million nodes costs seconds to minutes, and the ``'benes'`` twin and
    ``'benes_fused'`` share one routing.  In-process, the last 8 plans;
    on disk, every routed base plan, in ``FU_PLAN_CACHE`` (a directory;
    ``0`` turns the disk cache off; default
    ``$XDG_CACHE_HOME/flow_updating_tpu_torch/plans``).  Only the base
    routing is stored: the fused passes are planned from it at the
    card's tile each time."""
    key0 = _mats_key(mats, m1)
    key = (key0, fused)
    cached = _plan_cache.get(key)
    if cached is not None:
        return cached
    plan = _plan_cache.get((key0, False))
    if plan is None:
        plan = _disk_load(key0)
    if plan is None:
        spread, fill, benes, P = plan_sections(mats, m1)
        plan = NeighborSumPlan(
            m1=m1, P=P, flat_begin=m1,
            bucket_shapes=tuple(m.shape for m in mats),
            stages=concat_plans(spread, fill, benes))
        _disk_save(key0, plan)
    _plan_cache[(key0, False)] = plan
    out = plan
    if fused:
        out = FusedNeighborSumPlan(base=plan, fused=plan_fused(plan.stages))
        _plan_cache[key] = out
    while len(_plan_cache) > 8:   # bound held host memory (masks are big)
        _plan_cache.pop(next(iter(_plan_cache)))
    return out


def plan_sections(mats: tuple, m1: int, min_width: int = 0):
    """The three network sections (spread, fill, benes StagePlans) plus
    the common width ``P`` for one set of ELL matrices.  Exposed apart so
    that the sharded planner (``parallel/spmv_sharded.py``) can pad each
    shard's sections to a common stage skeleton before it concatenates
    them; ``min_width`` floors ``P``."""
    flats = [np.asarray(m, np.int64).ravel() for m in mats]
    idx_flat = np.concatenate(flats) if flats else np.zeros(0, np.int64)
    # synthetic block: every value present at least once
    aug = np.concatenate([np.arange(m1, dtype=np.int64), idx_flat])
    Ea = len(aug)
    P = next_pow2(max(Ea, m1, min_width))

    order = np.argsort(aug, kind="stable")
    g = aug[order]
    heads = np.zeros(Ea, bool)
    heads[0] = True
    heads[1:] = g[1:] != g[:-1]
    head_pos = np.flatnonzero(heads)
    if len(head_pos) != m1:
        raise ValueError("ELL matrices index outside [0, m1)")

    spread = spread_plan(head_pos, P)
    run_id = np.concatenate([g, np.full(P - Ea, g[-1] if Ea else 0)])
    fill = fill_forward_stages(run_id)
    # sorted position r holds x[g[r]]; ELL slot s needs x[aug[s]] = the
    # value at sorted position inv_order[s]
    inv_order = np.empty(Ea, np.int64)
    inv_order[order] = np.arange(Ea, dtype=np.int64)
    perm2 = np.concatenate([inv_order, np.arange(Ea, P, dtype=np.int64)])
    benes = benes_plan(perm2)
    return spread, fill, benes, P


def pad_roll_section(plan: StagePlan, target_dists: tuple) -> StagePlan:
    """Extend a roll-stage section to the dist list ``target_dists`` by
    inserting stages whose mask is all false (no-ops); the section's own
    stages must appear in ``target_dists`` in order."""
    it = iter(zip(plan.dists, plan.masks))
    nxt = next(it, None)
    masks = []
    for d in target_dists:
        if nxt is not None and nxt[0] == d:
            masks.append(nxt[1])
            nxt = next(it, None)
        else:
            masks.append(np.zeros(plan.n, bool))
    if nxt is not None:
        raise ValueError("section dists not a subsequence of target")
    return StagePlan(n=plan.n, dists=tuple(target_dists),
                     kinds=("roll",) * len(target_dists),
                     masks=tuple(masks))


def neighbor_sum_benes(x: torch.Tensor, plan, masks) -> torch.Tensor:
    """A(x) for the node kernel: ``x`` is the padded ``(m1 - 1,)`` vector;
    the zero slot and the network padding are appended here as one block
    of zeros.  ``masks`` come from ``plan.to(device)``.  A
    :class:`FusedNeighborSumPlan` runs :func:`apply_fused` (kernel B3 on a
    CUDA tensor), a :class:`NeighborSumPlan` the per-stage executor."""
    if x.dim() != 1:
        raise ValueError("the Beneš neighbor sum takes a scalar (M,) "
                         f"payload, got shape {tuple(x.shape)}")
    z = torch.cat([x, x.new_zeros(plan.P - plan.m1 + 1)])
    if isinstance(plan, FusedNeighborSumPlan):
        z = apply_fused(z, plan.fused, masks)
    else:
        z = apply_stages(z, plan.stages, masks)
    parts = []
    off = plan.flat_begin
    for rows, w in plan.bucket_shapes:
        if w == 0:
            parts.append(x.new_zeros(rows))
        else:
            # sum a fresh (rows, w) tensor, as the gather route sums its
            # freshly gathered bucket: the card's reduction picks its
            # vector width from the data pointer's alignment, so the sum
            # of a view into the network's output can add in another
            # order (.contiguous() would return the view unchanged)
            parts.append(
                z[off: off + rows * w].reshape(rows, w).clone().sum(dim=1))
            off += rows * w
    return torch.cat(parts) if len(parts) > 1 else parts[0]
