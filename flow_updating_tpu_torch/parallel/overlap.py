"""Interior/frontier-split round schedule: the halo wire started early.

Counterpart of ``flow_updating_tpu/parallel/overlap.py``.  The plain
halo round (:mod:`.sharded`) is a straight line — deliver, fire, local
scatter, exchange, receive scatter.  This schedule reorders it:

1. **frontier pass** (every shard) — the cut-edge payloads are computed
   first, on a compacted sub-problem holding exactly the frontier rows
   (nodes owning a cut edge) with their whole out-edge rows, so each
   per-row reduction sees the same operands in the same order as the
   full pass and the payloads are bit-identical to the unsplit round's;
   the shard then records its ``ready`` event;
2. **start the exchange** — ``halo='overlap'``: the receiver's copy
   stream waits on each sender's ``ready`` event and copies the sender's
   block into a receive block, then records ``copied``;
3. **interior pass** — the full deliver and fire on the shard's stream
   (the state of record; it covers the frontier rows again);
4. **intra-shard merge** — ``'overlap'``: the local scatter, then the
   stream waits on ``copied``; ``'overlap_pallas'``: the stream waits on
   each sender's ``ready`` event and kernel **B6**
   (:func:`~flow_updating_tpu_torch.ops.halo_exchange.fused_exchange_merge`)
   pulls the blocks and does the receiver-pull merge ``buf[d, e] =
   hit[d, e] ? payload[e] : buf[d, e]`` in one launch;
5. **finish the frontier** — the received blocks are scattered into the
   cut edges' ring-buffer slots.

Why the order is safe: a receiver's wait is issued after every sender
recorded its ``ready`` event in the same round (phase 1 runs for all
shards first); payload blocks are fresh tensors each round, never written
after they are made, and each has its reader's stream recorded on it
(``record_stream``), so the caching allocator does not reuse their memory
before the reader's copy or B6 launch has run.  B6 takes no flag and does
no inter-block waiting: stream order alone orders it after the senders.

The frontier is thin on locality partitions; when more than
:data:`COMPACT_FRONTIER_MAX_FRACTION` of the real edges lie in frontier
rows, ``'overlap'`` resolves to ``'overlap_full'``, which replays the
frontier at full width — and, as XLA's CSE does in the JAX package, that
one full pass is also the interior pass.  Message-based pairwise always
takes the full-width replay.  ``halo='interior'`` is the schedule with the
exchange left out, a timing probe only (nothing arrives); the Engine
refuses it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from flow_updating_tpu_torch.models.config import COLLECTALL
from flow_updating_tpu_torch.models.rounds import (
    _draw_dtype,
    deliver_phase,
    fire_core,
)
from flow_updating_tpu_torch.models.state import FlowUpdatingState, _feat
from flow_updating_tpu_torch.parallel.sharded import (
    _arrive,
    _bring,
    _fastpair_blocks,
    _fastpair_fire,
    _fastpair_own,
    _fastpair_partner,
    _finish_blocks,
    _local_deliver,
    _msg_blocks,
    _on,
    _record,
    _row_sum,
    _unlanes,
    local_view,
)
from flow_updating_tpu_torch.utils import prng

#: halo modes of this module ('interior' is the timing probe;
#: 'overlap_full' the plan-time fat-frontier resolution of 'overlap')
OVERLAP_MODES = ("overlap", "overlap_full", "overlap_pallas", "interior")

#: halo mode -> the wire of the exchange step
_WIRE = {"overlap": "ppermute", "overlap_full": "ppermute",
         "overlap_pallas": "pallas", "interior": "none"}

#: above this fraction of real edges in the frontier, the compact pass
#: repeats more deliver/fire work than the early wire start can hide, and
#: 'overlap' resolves to 'overlap_full'
COMPACT_FRONTIER_MAX_FRACTION = 0.5


def resolve_mode(plan, halo: str) -> str:
    """Plan-time resolution of ``halo='overlap'``: the compact frontier
    pass when the frontier is thin, the full-width replay when it is fat
    (both bit-identical to ppermute).  Other modes pass through.  The
    count is cached on the plan."""
    if halo != "overlap":
        return halo
    cached = getattr(plan, "_overlap_schedule", None)
    if cached is not None:
        return cached
    a = plan.arrays
    real = a.tlocal < plan.Eb
    own = np.arange(plan.num_shards, dtype=a.tshard.dtype).reshape(-1, 1)
    is_cut = (a.tshard != own) & real
    frontier_edges = 0
    for s in range(plan.num_shards):
        rows = np.zeros(plan.Nb, bool)
        rows[a.src_local[s, is_cut[s]]] = True
        frontier_edges += int(rows[a.src_local[s]][real[s]].sum())
    total = max(int(real.sum()), 1)
    resolved = ("overlap" if frontier_edges <= COMPACT_FRONTIER_MAX_FRACTION
                * total else "overlap_full")
    object.__setattr__(plan, "_overlap_schedule", resolved)
    return resolved


@dataclasses.dataclass(frozen=True)
class OverlapTables:
    """Plan-time frontier/interior split, stacked ``(S, ...)`` numpy
    arrays equal to the JAX package's.  The compact frontier holds every
    frontier row's whole out-edge row in the shard's slot order; compact
    row ``Fn`` is the dead dummy that owns the padded entries."""

    f_nodes: np.ndarray      # (S, Fn+1) local node id per compact row
    f_edges: np.ndarray      # (S, Fe) edge slot per compact slot (pad Eb)
    f_src: np.ndarray        # (S, Fe) compact row of each slot (pad Fn)
    f_out_deg: np.ndarray    # (S, Fn+1) real out-degree per compact row
    f_row_start: np.ndarray  # (S, Fn+2) compact CSR offsets
    f_edge_rank: np.ndarray  # (S, Fe) original within-row rank
    f_delay: np.ndarray      # (S, Fe)
    send_pos: tuple          # per offset (S, Hd): position of each send
    #                          slot within f_edges (pad Fe)
    lrev: np.ndarray         # (S, Eb) intra-shard sender slot whose message
    #                          lands in slot r (none: Eb) — the receiver-
    #                          pull form of the local delivery (B6's merge)


def build_overlap(plan) -> OverlapTables:
    """The split tables, from the partition's own tables (host side)."""
    a = plan.arrays
    S, Eb, Nb = plan.num_shards, plan.Eb, plan.Nb
    src, ts, tl = a.src_local, a.tshard, a.tlocal
    own = np.arange(S, dtype=ts.dtype).reshape(S, 1)
    real = tl < Eb
    is_cut = (ts != own) & real

    fn_mask = np.zeros((S, Nb), bool)
    for s in range(S):
        fn_mask[s, src[s, is_cut[s]]] = True
    fn_mask[:, Nb - 1] = False          # the dummy row is never frontier
    fe_mask = fn_mask[np.arange(S)[:, None], src] & real
    Fn = max(int(fn_mask.sum(1).max()), 1)
    Fe = max(int(fe_mask.sum(1).max()), 1)

    f_nodes = np.full((S, Fn + 1), Nb - 1, np.int32)
    f_edges = np.full((S, Fe), Eb, np.int32)
    f_src = np.full((S, Fe), Fn, np.int32)
    f_out_deg = np.zeros((S, Fn + 1), np.int32)
    f_row_start = np.zeros((S, Fn + 2), np.int32)
    f_edge_rank = np.zeros((S, Fe), np.int32)
    f_delay = np.ones((S, Fe), np.int32)
    pos_of_slot = np.full((S, Eb + 1), Fe, np.int64)
    lrev = np.full((S, Eb), Eb, np.int32)
    for s in range(S):
        rows = np.where(fn_mask[s])[0]
        slots = np.where(fe_mask[s])[0]           # ascending = row-major
        f_nodes[s, : len(rows)] = rows
        f_edges[s, : len(slots)] = slots
        pos_of_slot[s, slots] = np.arange(len(slots))
        rank_of = np.full(Nb, Fn, np.int64)
        rank_of[rows] = np.arange(len(rows))
        f_src[s, : len(slots)] = rank_of[src[s, slots]]
        f_out_deg[s, : len(rows)] = a.out_deg[s, rows]
        counts = np.bincount(f_src[s, : len(slots)], minlength=Fn + 1)
        counts[Fn] += Fe - len(slots)             # pads: the dummy row
        np.cumsum(counts, out=f_row_start[s, 1:])
        f_edge_rank[s, : len(slots)] = a.edge_rank[s, slots]
        f_edge_rank[s, len(slots):] = np.arange(Fe - len(slots))
        f_delay[s, : len(slots)] = a.delay[s, slots]
        # receiver-pull map of the intra-shard delivery: slot r's local
        # sender is the edge e with tshard[e] == s and tlocal[e] == r
        loc = np.where((ts[s] == s) & real[s])[0]
        lrev[s, tl[s, loc]] = loc

    send_pos = tuple(
        pos_of_slot[np.arange(S)[:, None],
                    np.minimum(sidx, Eb)].astype(np.int32)
        for sidx in (plan.perm_tables.send_idx if plan.perm_tables else ()))
    return OverlapTables(
        f_nodes=f_nodes, f_edges=f_edges, f_src=f_src, f_out_deg=f_out_deg,
        f_row_start=f_row_start, f_edge_rank=f_edge_rank, f_delay=f_delay,
        send_pos=send_pos, lrev=lrev)


def frontier_interior_rows(plan) -> tuple[np.ndarray, np.ndarray]:
    """Per-shard boolean masks ``(frontier, interior)`` over the real
    local rows — disjoint, and together every row that owns an edge."""
    a = plan.arrays
    S, Eb, Nb = plan.num_shards, plan.Eb, plan.Nb
    real = a.tlocal < Eb
    is_cut = (a.tshard != np.arange(S, dtype=a.tshard.dtype).reshape(S, 1)
              ) & real
    frontier = np.zeros((S, Nb), bool)
    alive_rows = np.zeros((S, Nb), bool)
    for s in range(S):
        frontier[s, a.src_local[s, is_cut[s]]] = True
        alive_rows[s, a.src_local[s, real[s]]] = True
    frontier[:, Nb - 1] = False
    alive_rows[:, Nb - 1] = False
    return frontier, alive_rows & ~frontier


@dataclasses.dataclass(frozen=True, eq=False)
class OverlapShard:
    """One shard's split tables on its device."""

    ftopo: object            # EdgeArrays of the compact frontier rows
    f_nodes: torch.Tensor    # (Fn+1,) int64
    f_edges: torch.Tensor    # (Fe,) int64, pad = Eb
    send_pos: tuple          # per offset (Hd,) int64, pad = Fe
    lrev: torch.Tensor       # (Eb,) int64, none = Eb


def overlap_shard(ov: OverlapTables, s: int, device) -> OverlapShard:
    """Shard ``s``'s split tables on ``device``."""
    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device,
                                                            torch.int64)

    # rev is a placeholder: the frontier pass never delivers
    return OverlapShard(
        ftopo=local_view(ov.f_src[s], ov.f_out_deg[s], ov.f_row_start[s],
                         ov.f_edge_rank[s], ov.f_delay[s], ov.f_src[s],
                         device),
        f_nodes=t(ov.f_nodes[s]), f_edges=t(ov.f_edges[s]),
        send_pos=tuple(t(p[s]) for p in ov.send_pos), lrev=t(ov.lrev[s]))


# ---- the compact frontier pass ------------------------------------------

def _frontier_state(st: FlowUpdatingState, ov: OverlapShard,
                    Eb: int) -> FlowUpdatingState:
    """The frontier rows' state in the compact layout.  Pad slots are
    clamped gathers owned by the dead dummy row: they never receive, fire
    or send."""
    ge = torch.clamp(ov.f_edges, max=Eb - 1)
    e_ok = ov.f_edges < Eb
    gn = ov.f_nodes
    return FlowUpdatingState(
        t=st.t, value=st.value[gn], flow=st.flow[ge], est=st.est[ge],
        recv=st.recv[ge], ticks=st.ticks[gn], stamp=st.stamp[ge],
        last_avg=st.last_avg[gn], fired=st.fired[gn], alive=st.alive[gn],
        edge_ok=st.edge_ok[ge] & e_ok,
        pending_flow=st.pending_flow[:, ge], pending_est=st.pending_est[:, ge],
        pending_valid=st.pending_valid[:, ge] & e_ok[None],
        pending_stamp=st.pending_stamp[:, ge],
        buf_flow=st.buf_flow[:, ge], buf_est=st.buf_est[:, ge],
        buf_valid=st.buf_valid[:, ge] & e_ok[None], key=st.key)


def frontier_core(st: FlowUpdatingState, ov: OverlapShard, cfg, Eb: int):
    """The compact frontier pass of the message modes: deliver and fire
    on exactly the frontier rows.  Returns ``(flow, msg_est, send_mask)``
    in the compact layout, bit-identical to the full pass at the same
    slots (the loss draw is taken full-width from the same key split and
    gathered, so the realizations agree position by position)."""
    cst = _frontier_state(st, ov, Eb)
    cfg0 = (dataclasses.replace(cfg, drop_rate=0.0) if cfg.drop_rate > 0.0
            else cfg)
    cst, processed = deliver_phase(cst, ov.ftopo, cfg0)
    cst, msg_est, send_mask = fire_core(cst, ov.ftopo, cfg0, processed)
    if cfg.drop_rate > 0.0:
        sub = prng.split(st.key)[1]
        keep = prng.bernoulli(sub, 1.0 - cfg.drop_rate, Eb,
                              _draw_dtype(st.flow.dtype))
        send_mask = send_mask & keep[torch.clamp(ov.f_edges, max=Eb - 1)]
    return cst.flow, msg_est, send_mask


def _msg_payloads(st, a, cfg, Eb: int, compact: bool):
    """Per-offset wire blocks of the message modes (bit-equal to the
    serialized round's).  ``compact=True`` (collect-all only) runs the
    compact frontier pass and returns ``(blocks, None)``; otherwise the
    full pass runs here and is returned too — ``(blocks, (state,
    processed, msg_est, send_mask))`` — so it serves as the interior pass
    (message-based pairwise always replays at full width: its segmented
    affine scan is not cut to rows)."""
    if cfg.variant == COLLECTALL and compact:
        flow_f, est_f, send_f = frontier_core(st, a.ov, cfg, Eb)
        return _msg_blocks(flow_f, est_f, send_f, a.ov.send_pos,
                           a.ov.f_edges.shape[0]), None
    st2, processed = deliver_phase(st, a.local, cfg)
    st2, msg_est, send_mask = fire_core(st2, a.local, cfg, processed)
    return (_msg_blocks(st2.flow, msg_est, send_mask, a.send_idx, Eb),
            (st2, processed, msg_est, send_mask))


def _fastpair_payloads(st, a, Eb: int) -> list:
    """Per-offset wire blocks of fast synchronous pairwise: the frontier
    rows' current estimates and sender-side validity."""
    ov = a.ov
    ge = torch.clamp(ov.f_edges, max=Eb - 1)
    e_ok = ov.f_edges < Eb
    flow_f = st.flow[ge]
    f_src = ov.ftopo.src
    est_f = st.value[ov.f_nodes] - _row_sum(flow_f, ov.ftopo)
    x_u = est_f[f_src]
    valid_u = st.alive[ov.f_nodes][f_src] & st.edge_ok[ge] & e_ok
    return _fastpair_blocks(x_u, valid_u, ov.send_pos, ov.f_edges.shape[0])


def _start_copies(blocks_by_shard, arrs, r: int, offsets: tuple) -> list:
    """``'overlap'``'s wire: on shard ``r``'s copy stream, after each
    sender's ``ready`` event, a copy of every incoming block; then the
    ``copied`` event.  On the host the copies run in line."""
    a = arrs[r]
    S = len(arrs)
    got = []
    with _on(a.copy_stream):
        for di, d in enumerate(offsets):
            s = (r - d) % S
            blk = _bring(blocks_by_shard[s][di], arrs[s], a,
                         stream=a.copy_stream)
            out = blk.clone() if blk.device == a.device else blk
            if a.copy_stream is not None:
                out.record_stream(a.stream)
            got.append(out)
        if a.copied is not None:
            a.copied.record(a.copy_stream)
    return got


def _wait_senders(blocks_by_shard, arrs, r: int, offsets: tuple) -> None:
    """Order shard ``r``'s stream after every sender of its blocks, and
    record that stream on the blocks: B6 reads them by pointer, on this
    card or a peer's, and nothing is copied here."""
    a = arrs[r]
    if a.stream is None:
        return
    S = len(arrs)
    for di, d in enumerate(offsets):
        s = (r - d) % S
        a.stream.wait_event(arrs[s].ready)
        blocks_by_shard[s][di].record_stream(a.stream)


# ---- the overlap round bodies -------------------------------------------

def local_round_overlap(states, arrs, cfg, Eb: int, offsets: tuple,
                        halo_mode: str) -> tuple:
    """One split-schedule round of every shard (message modes): the
    serialized round's state, bit for bit, for every mode but the
    'interior' probe."""
    from flow_updating_tpu_torch.ops import halo_exchange

    wire = _WIRE[halo_mode]
    D = cfg.delay_depth
    exchange = wire != "none" and bool(offsets)
    # 1) the frontier pass: payload blocks, then 'ready'
    blocks, full = [], []
    for st, a in zip(states, arrs):
        b, f = [], None
        if exchange:
            with _on(a.stream):
                b, f = _msg_payloads(st, a, cfg, Eb,
                                     compact=halo_mode != "overlap_full")
                _record(a)
        blocks.append(b)
        full.append(f)
    out = []
    for r, (st, a) in enumerate(zip(states, arrs)):
        # 2) 'overlap': the copies start on the copy stream
        got = (_start_copies(blocks, arrs, r, offsets)
               if exchange and wire == "ppermute" else [])
        with _on(a.stream):
            # 3) the interior pass (the full pass, once)
            if full[r] is None:
                st, processed = deliver_phase(st, a.local, cfg)
                st, msg_est, send_mask = fire_core(st, a.local, cfg,
                                                   processed)
            else:
                st, _, msg_est, send_mask = full[r]
            t = st.t
            # 4) the intra-shard merge
            if exchange and wire == "pallas":
                lr = torch.clamp(a.ov.lrev, max=Eb - 1)
                sending_r = send_mask[lr] & (a.ov.lrev < Eb)
                slot_r = (t + a.delay[lr]) % D
                hit = sending_r[None, :] & (
                    slot_r[None, :] == torch.arange(
                        D, dtype=slot_r.dtype, device=a.device)[:, None])
                _wait_senders(blocks, arrs, r, offsets)
                got, bf, be, bv = halo_exchange.fused_exchange_merge(
                    blocks, offsets, r, hit, st.flow[lr], msg_est[lr],
                    st.buf_flow.contiguous(), st.buf_est.contiguous(),
                    st.buf_valid.contiguous())
            else:
                bf, be, bv = _local_deliver(st, a, msg_est, send_mask, D,
                                            Eb)
                if got and a.copied is not None:
                    a.stream.wait_event(a.copied)
            # 5) finish the frontier: the received blocks
            bf, be, bv = _finish_blocks(got, a, t, D, Eb, st.flow, bf, be,
                                        bv)
            out.append(st.replace(t=t + 1, buf_flow=bf, buf_est=be,
                                  buf_valid=bv))
    return tuple(out)


def local_round_overlap_fastpair(states, arrs, cfg, Eb: int,  # noqa: ARG001
                                 offsets: tuple, halo_mode: str) -> tuple:
    """Split-schedule round of fast synchronous pairwise: the cut
    endpoints' estimates go on the wire first, the bulk estimate and
    partner compute runs behind them, and the received blocks finish the
    frontier's ``x_v``.  ``'overlap_pallas'`` pulls the blocks with B6
    (no merge: this mode has no ring buffer)."""
    from flow_updating_tpu_torch.ops import halo_exchange

    wire = _WIRE[halo_mode]
    exchange = wire != "none" and bool(offsets)
    blocks = []
    for st, a in zip(states, arrs):
        b = []
        if exchange:
            with _on(a.stream):
                b = _fastpair_payloads(st, a, Eb)
                _record(a)
        blocks.append(b)
    out = []
    for r, (st, a) in enumerate(zip(states, arrs)):
        got = (_start_copies(blocks, arrs, r, offsets)
               if exchange and wire == "ppermute" else [])
        with _on(a.stream):
            if exchange and wire == "pallas":
                _wait_senders(blocks, arrs, r, offsets)
                got = halo_exchange.remote_block_exchange(blocks, offsets, r)
            x_u, valid_u = _fastpair_own(st, a)
            x_v, valid_v = _fastpair_partner(st, a, x_u, valid_u, Eb)
            if got and wire == "ppermute" and a.copied is not None:
                a.stream.wait_event(a.copied)
            nf = _feat(x_u)
            for di, g in enumerate(got):
                rt = a.recv_tlocal[di]
                tgt = torch.where(g[nf] > 0.5, torch.clamp(rt, max=Eb), Eb)
                x_v, valid_v = _arrive(tgt, _unlanes(g[:nf], x_u), x_v,
                                       valid_v, Eb)
            out.append(_fastpair_fire(st, a, x_u, x_v, valid_u, valid_v))
    return tuple(out)
