"""Per-shard banded round: band and remainder delivery and merge through a
ring-halo window, with the next round's fire folded in.

Counterpart of ``flow_updating_tpu/ops/pallas_round.py:490-667``
(``ShardedRoundSpec``, ``_sharded_round_kernel``, ``fused_sharded_round``).
After RCM reordering the plan's bandwidth ``H`` bounds every edge's
``|dst - src|``, so a contiguous block partition of the node axis needs
only the last ``H`` elements of ``avg`` of the left neighbor shard and the
first ``H`` of the right one each round.  A shard of ``L`` elements reads
``avg`` through the window ``[recv_lo; avg; recv_hi]`` of ``L + 2H``
elements, whose origin is global element ``s*L - H``.

Kernel **B5** (``csrc/sharded_round.cu``) has two modes, over ranges of one
shard's tile-rows (128 elements each):

* **fire** — ``avg = (value - S + A_prev) * inv``, over a whole shard;
  it runs only where a state is made (``parallel/banded_sharded.py``);
* **merge** — ``acc = acc + (bit_d ? window[H + p + d] : 0)`` for every
  kept diagonal in plan order (the bit planes pack 32 diagonals per
  ``uint32``), then the 'inline' remainder ``rs = rs + window[idx[p, j]]``
  over its W columns in index order (-1 = empty), ``acc = acc + rs``, and
  the ledger merge ``S' = -G - acc + deg*avg_prev``,
  ``G' = -S - deg*avg + A_prev``, ``A = acc`` — and, folded in, the next
  round's fire on what it just wrote, ``avg_next = (value - S' + A) *
  inv``, the same operations in the same order as :func:`sharded_fire_plain`
  on the stored ``S'`` and ``A``.  One launch takes one range of rows or
  two (the boundary rows at both ends of the shard).

A row whose reads all stay on the shard (tile-rows ``[Hr, R - Hr)``, since
every offset and remainder reach is at most the bandwidth, at most ``H``)
never touches the receive blocks, so the caller can merge those rows while
the halos are still on the way (``parallel/banded_sharded.py``).  Each row
is computed once; the TPU kernel accumulated every row before and after
its wait and kept the boundary rows of the second pass.

The two plain versions, :func:`sharded_fire_plain` and
:func:`sharded_round_plain`, run the same arithmetic in the same order as
the oracle of the JAX package (``banded_sharded._oracle_step``); the CPU
tests use them, and ``chip_smoke.py`` holds the kernel against them.  The
wrappers :func:`sharded_fire` and :func:`sharded_round` take the plain
versions for CPU tensors and launch B5 for CUDA tensors (counted in their
``launches``), raising on anything the kernel does not take.
"""

from __future__ import annotations

import dataclasses

import torch

from flow_updating_tpu_torch import kernels

LANE = 128
#: per-shard length multiple (8 tile-rows of 128, the JAX package's tile)
TILE = 8 * LANE

_ROUTES = {"none": 0, "inline": 2}
_FIRE, _MERGE = 0, 1


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedRoundSpec:
    """Static descriptor of the per-shard banded round.  Each shard owns
    ``local`` contiguous plan-order elements; ``halo_rows`` tile-rows of
    ``avg`` cross to each ring neighbor per round."""

    n: int               # real node count (RCM space)
    P: int               # padded global length (num_shards * local)
    local: int           # per-shard element count (multiple of TILE)
    halo_rows: int       # exchanged tile-rows per direction
    num_shards: int
    offsets: tuple       # kept signed diagonals, plan order
    rem_route: str       # 'none' | 'inline'
    rem_width: int       # 'inline': padded per-row remainder degree
    n_planes: int        # bitpacked band-mask planes (32 offsets each)

    @property
    def local_rows(self) -> int:
        return self.local // LANE

    @property
    def halo(self) -> int:
        """Exchanged elements per direction."""
        return self.halo_rows * LANE


@dataclasses.dataclass(frozen=True)
class ShardedRoundLeaves:
    """One shard's band and remainder tables."""

    planes: torch.Tensor          # (n_planes, local) int32 — uint32 bits
    offsets: torch.Tensor         # (len(spec.offsets),) int32
    rem_idx: torch.Tensor | None  # 'inline': (local, W) int32 window
    #                               coordinates, -1 = empty slot


def _ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def plan_sharded_round(spmv, bandwidth: int, num_shards: int
                       ) -> ShardedRoundSpec:
    """The spec for a banded plan over ``num_shards`` shards — the JAX
    package's padding rule (``banded_sharded.py:156-163``): halo rows
    cover the bandwidth (at least 8, a multiple of 8), the padded length
    is a multiple of ``num_shards * TILE``, grown until one shard holds
    a whole halo."""
    S = int(num_shards)
    n = spmv.n
    H = int(bandwidth) or 1
    Hr = _ceil_to(max(-(-H // LANE), 8), 8)
    M = _ceil_to(n, S * TILE)
    L = M // S
    while Hr * LANE > L:
        M += S * TILE
        L = M // S
    rem_route = "none" if spmv.rem_mode == "none" else "inline"
    offs = tuple(int(d) for d in spmv.offsets)
    W = (max((s[1] for s in spmv.rem_bucket_shapes), default=0)
         if rem_route == "inline" else 0)
    return ShardedRoundSpec(
        n=n, P=M, local=L, halo_rows=Hr, num_shards=S, offsets=offs,
        rem_route=rem_route, rem_width=W, n_planes=-(-len(offs) // 32))


def row_ranges(spec: ShardedRoundSpec, exchange: str) -> tuple:
    """The merge launches of one shard-round as ``(before, after)`` lists
    of tile-row ranges: ``before`` runs before the halos are waited for,
    ``after`` once they have landed.  'ppermute' merges all rows after the
    wait; 'pallas' merges the interior rows ``[Hr, R - Hr)`` first and the
    boundary rows after (when ``R < 2*Hr`` there is no interior)."""
    R, Hr = spec.local_rows, spec.halo_rows
    if exchange == "ppermute":
        return (), ((0, R),)
    lo_end = min(Hr, R)
    hi_begin = max(R - Hr, lo_end)
    before = ((lo_end, hi_begin),) if hi_begin > lo_end else ()
    after = ((0, lo_end),) + (((hi_begin, R),) if R > hi_begin else ())
    return before, after


def launches_per_shard_round(spec: ShardedRoundSpec, exchange: str) -> int:
    """B5 launches one shard makes per round: the merge of the rows before
    the wait, if any, and one launch for the rows after it (both boundary
    ranges).  The fire is folded into the previous round's merges."""
    before, after = row_ranges(spec, exchange)
    return len(before) + (1 if after else 0)


def sharded_fire_plain(value, S, A_prev, inv_depp1):
    """Plain version of B5's fire: ``avg = (value - S + A_prev) * inv``."""
    return (value - S + A_prev) * inv_depp1


def sharded_round_plain(S, G, avg_prev, A_prev, deg, avg, recv_lo, recv_hi,
                        leaves: ShardedRoundLeaves, spec: ShardedRoundSpec,
                        row_begin: int, row_end: int):
    """Plain version of B5's merge for tile-rows ``[row_begin, row_end)``
    of one shard: the same reads through the window, the same additions in
    the same order.  All shard arrays are ``(local,)``; the receive blocks
    ``(halo,)``.  Returns ``(S_next, G_next, A_cur)`` for those rows."""
    H = spec.halo
    b, e = row_begin * LANE, row_end * LANE
    window = torch.cat([recv_lo, avg, recv_hi])
    acc = torch.zeros(e - b, dtype=avg.dtype, device=avg.device)
    for gi, d in enumerate(spec.offsets):
        bit = ((leaves.planes[gi // 32, b:e] >> (gi % 32)) & 1) != 0
        acc = acc + torch.where(bit, window[H + b + d:H + e + d], 0)
    if spec.rem_route == "inline":
        idx = leaves.rem_idx[b:e]
        valid = idx >= 0
        gathered = window[torch.where(valid, idx, 0).long()]
        rs = torch.zeros_like(acc)
        for j in range(idx.shape[1]):
            rs = rs + torch.where(valid[:, j], gathered[:, j], 0)
        acc = acc + rs
    dg = deg[b:e]
    S_next = -G[b:e] - acc + dg * avg_prev[b:e]
    G_next = -S[b:e] - dg * avg[b:e] + A_prev[b:e]
    return S_next, G_next, acc


def _check(tensors, like, shape, what):
    for t in tensors:
        if (t.shape != shape or t.dtype != like.dtype
                or t.device != like.device or not t.is_contiguous()):
            raise ValueError(
                f"{what}: expected contiguous {tuple(shape)} {like.dtype} "
                f"tensors on {like.device}, got {tuple(t.shape)} {t.dtype} "
                f"on {t.device}")


def _launch(mode, spec, ranges, leaves, ins, avg, recv_lo, recv_hi, outs,
            like):
    code = kernels.dtype_code(like)
    rem = leaves.rem_idx if spec.rem_route == "inline" else None
    fn = kernels.library("sharded_round").sharded_round
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    (rb, re), (rb2, re2) = (tuple(ranges) + ((0, 0),))[:2]
    with torch.cuda.device(like.device):
        kernels.check(fn(
            code, _ROUTES[spec.rem_route], rb, re, rb2, re2, mode,
            spec.local, spec.halo, len(spec.offsets),
            leaves.offsets.data_ptr(), leaves.planes.data_ptr(),
            *(ptr(t) for t in ins), avg.data_ptr(), ptr(recv_lo),
            ptr(recv_hi), ptr(rem), max(spec.rem_width, 1) if rem is not None
            else 0, *(ptr(t) for t in outs), kernels.stream_ptr(like)),
            "sharded_round")


def _check_leaves(leaves, spec, like, what):
    ok = (leaves.planes.shape == (spec.n_planes, spec.local)
          and leaves.offsets.shape == (len(spec.offsets),))
    tabs = [leaves.planes, leaves.offsets]
    if spec.rem_route == "inline":
        ok = ok and leaves.rem_idx is not None and leaves.rem_idx.shape == (
            spec.local, max(spec.rem_width, 1))
        tabs.append(leaves.rem_idx)
    for t in tabs:
        ok = ok and (t is not None and t.dtype == torch.int32
                     and t.device == like.device and t.is_contiguous())
    if not ok:
        raise ValueError(f"{what}: leaves do not match the spec (int32, "
                         "contiguous, on the shard's device)")


def sharded_fire(value, S, A_prev, inv_depp1, leaves: ShardedRoundLeaves,
                 spec: ShardedRoundSpec, out=None):
    """B5's fire over one whole shard; returns the new ``avg``, written
    into ``out`` when given.  CPU tensors take :func:`sharded_fire_plain`;
    CUDA tensors launch the kernel once (``sharded_fire.launches``)."""
    if S.device.type == "cpu":
        avg = sharded_fire_plain(value, S, A_prev, inv_depp1)
        return avg if out is None else out.copy_(avg)
    if S.device.type != "cuda":
        raise ValueError(f"sharded_fire: unsupported device {S.device}")
    avg = torch.empty_like(S) if out is None else out
    _check((value, S, A_prev, inv_depp1, avg), S, (spec.local,),
           "sharded_fire")
    _check_leaves(leaves, spec, S, "sharded_fire")
    _launch(_FIRE, spec, ((0, spec.local_rows),), leaves,
            (value, S, None, None, A_prev, inv_depp1, None), avg, None, None,
            (None, None, None, None), S)
    sharded_fire.launches += 1
    return avg


sharded_fire.launches = 0


def sharded_round(S, G, avg_prev, A_prev, deg, avg, recv_lo, recv_hi,
                  leaves: ShardedRoundLeaves, spec: ShardedRoundSpec,
                  row_begin: int, row_end: int, out, *, fire,
                  rows2=None) -> None:
    """B5's merge over tile-rows ``[row_begin, row_end)`` of one shard, and
    over ``rows2 = (begin, end)`` too when given (one launch), written into
    those rows of ``out = (S_next, G_next, A_cur, avg_next)``, where
    ``avg_next`` receives the next round's fire from ``fire = (value,
    inv_depp1)``, ``(value - S_next + A_cur) * inv``.  ``avg_next`` may be
    ``avg_prev`` itself (each row reads its ``avg_prev`` before it writes
    there).  CPU tensors take :func:`sharded_round_plain` and
    :func:`sharded_fire_plain`; CUDA tensors launch the kernel once
    (``sharded_round.launches``)."""
    ranges = ((row_begin, row_end),) + ((tuple(rows2),) if rows2 else ())
    for rb, re in ranges:
        if not 0 <= rb <= re <= spec.local_rows:
            raise ValueError(f"sharded_round: rows [{rb}, {re}) outside "
                             f"[0, {spec.local_rows})")
    if len(out) != 4:
        raise ValueError("sharded_round: out is (S_next, G_next, A_cur, "
                         "avg_next)")
    value, inv = fire
    if S.device.type == "cpu":
        for rb, re in ranges:
            b, e = rb * LANE, re * LANE
            S_next, G_next, acc = sharded_round_plain(
                S, G, avg_prev, A_prev, deg, avg, recv_lo, recv_hi, leaves,
                spec, rb, re)
            out[3][b:e] = sharded_fire_plain(value[b:e], S_next, acc,
                                             inv[b:e])
            for o, r in zip(out, (S_next, G_next, acc)):
                o[b:e] = r
        return
    if S.device.type != "cuda":
        raise ValueError(f"sharded_round: unsupported device {S.device}")
    _check((S, G, avg_prev, A_prev, deg, avg, value, inv, *out), S,
           (spec.local,), "sharded_round")
    _check((recv_lo, recv_hi), S, (spec.halo,), "sharded_round")
    _check_leaves(leaves, spec, S, "sharded_round")
    _launch(_MERGE, spec, ranges, leaves,
            (value, S, G, avg_prev, A_prev, inv, deg), avg, recv_lo,
            recv_hi, out, S)
    sharded_round.launches += 1


sharded_round.launches = 0


def sharded_round_min_bytes(spec: ShardedRoundSpec, *,
                            dtype_bytes: int = 4) -> int:
    """The least bytes one shard's round must move — the numerator of
    B5's bound on the card: every input read once (value, S, G,
    avg_prev, A_prev, inv, deg, the bit planes, the offsets, the
    remainder table and the two received halos) and the four outputs
    (S', G', avg, A) written once."""
    L = spec.local
    vec = L * dtype_bytes
    reads = 7 * vec + spec.n_planes * L * 4 + len(spec.offsets) * 4 \
        + 2 * spec.halo * dtype_bytes
    if spec.rem_route == "inline":
        reads += L * max(spec.rem_width, 1) * 4
    return int(reads + 4 * vec)
