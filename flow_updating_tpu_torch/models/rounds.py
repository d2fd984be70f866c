"""The general per-edge Flow-Updating round — the edge kernel.

Counterpart of ``flow_updating_tpu/models/rounds.py``.  All N peers
advance one tick as one bulk-synchronous step of dense edge-array
operations; a round has the reference loop's two phases:

``deliver_phase``
    Pop this round's slot of the in-flight ring buffer into each edge's
    depth-``Q`` pending FIFO, then drain: everything (fast mode) or a
    per-node pick of ``cfg.drain`` messages, oldest arrival first with a
    round-robin tie-break.  A processed message applies the antisymmetry
    write ``flow[e] = -msg.flow``, ``est[e] = msg.estimate``.

``fire_phase``
    Decide who averages (all-neighbors-heard or timeout for collect-all,
    receive trigger or staleness for pairwise; everyone, or one edge-color
    class, in fast mode), compute the averages with per-node reductions,
    update the ledgers, and put the outgoing messages into the receivers'
    ring-buffer slots at ``(t + delay) % D``.  Message loss masks the
    delivery only; the sender's ledger moves regardless.

Rounds run as a Python loop over tensor operations on the state's
device.  The per-node reductions and broadcasts dispatch on the
:class:`~flow_updating_tpu_torch.topology.graph.EdgeArrays`:

* ``segment_impl='benes'|'benes_fused'`` — the permutation-network
  segmented scans and broadcasts (``ops/seg_benes.py``; kernels B3 and B4
  for ``'benes_fused'`` on the card);
* ``'ell'`` — the degree-bucketed out-edge ELL gather and row reduction;
* otherwise ``torch.segment_reduce`` over the CSR rows (``ops/segment.py``;
  row-ordered, so the card adds in the same order on every run).

Delivery (``cfg.delivery``): ``'gather'`` (the receiver pulls through
``rev``), ``'scatter'`` (the sender pushes), ``'benes'``/``'benes_fused'``
(the ``rev`` pull through the planned network, all payload lanes in one
batched application).

Robust aggregation (``cfg.robust``): ``'clip'`` clamps every flow-ledger
write to ``+-robust_clip`` (fire and receive side), ``'trim'`` makes an
armed node (degree >= 3, neighbor-estimate spread above ``robust_tol``)
stand down along its single highest and single lowest neighbor-estimate
edge.  Contention (``cfg.contention``): :func:`edge_delays` prices this
round's sends on the topology's shared links, quasi-static or by the
progressive-filling water-fill, with in-flight messages as standing load
under ``contention_backlog``; its float sums run in a fixed per-link
order (the link-major CSR of ``Topology.link_csr``), so two runs on the
card give the same delays.

Telemetry (:func:`run_rounds_telemetry`) and the per-node and per-edge
fields (:func:`run_rounds_fields`, every ``stride`` rounds) write their
rows into preallocated device tensors and read nothing back inside the
loop; :func:`run_rounds_streamed` reads one watcher sample between
chunks.

Not ported yet, and refused with ``NotImplementedError`` naming the
ROADMAP item: the adversary masks, per-lane reduction modes and traced
``RoundParams`` (A10) and the chunked runners (A13).
"""

from __future__ import annotations

import torch

from flow_updating_tpu_torch.models.config import COLLECTALL, RoundConfig
from flow_updating_tpu_torch.models.state import FlowUpdatingState, _ex, _feat
from flow_updating_tpu_torch.ops.permute import apply_padded_perm
from flow_updating_tpu_torch.ops.seg_benes import (
    broadcast,
    broadcast_multi,
    extract_row_ends,
    seg_reduce,
    seg_reduce_multi,
)
from flow_updating_tpu_torch.ops.segment import (
    ell_segment_all,
    ell_segment_max,
    ell_segment_min,
    ell_segment_sum,
    segment_all,
    segment_max,
    segment_min,
    segment_sum,
)
from flow_updating_tpu_torch.ops.segscan import segmented_affine_scan
from flow_updating_tpu_torch.utils import prng

_I32_MAX = torch.iinfo(torch.int32).max


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is the ROADMAP item '{item}', not ported yet")


def check_ported(cfg: RoundConfig, params=None) -> None:
    """Refuse what the edge kernel does not run yet, naming its item:
    traced ``RoundParams``."""
    if params is not None:
        raise _not_ported("traced RoundParams", "sweep and scenarios (A10)")


# ---- per-node reductions and node->edge broadcasts --------------------------

def _rows(x, topo):
    """The slots the CSR rows cover: all of them, or the real prefix of a
    shard's padded slots (``topo.seg_len``; the padding belongs to an
    empty dead row, so its reduction is the identity)."""
    return x if topo.seg_len is None else x[: topo.seg_len]


def _seg_sum(x, topo):
    if topo.seg_plan is not None:
        return seg_reduce(x, "sum", topo.seg_plan, topo.seg_dist,
                          topo.seg_extract_masks)
    if topo.ell_edge_mats is not None:
        return ell_segment_sum(x, topo.ell_edge_mats, topo.ell_inv_perm)
    return segment_sum(_rows(x, topo), topo.out_deg)


def _seg_min(x, topo, identity):
    if topo.seg_plan is not None:
        return seg_reduce(x, "min", topo.seg_plan, topo.seg_dist,
                          topo.seg_extract_masks)
    if topo.ell_edge_mats is not None:
        return ell_segment_min(x, topo.ell_edge_mats, topo.ell_inv_perm,
                               identity)
    return segment_min(_rows(x, topo), topo.out_deg)


def _seg_max(x, topo, identity):
    if topo.seg_plan is not None:
        return seg_reduce(x, "max", topo.seg_plan, topo.seg_dist,
                          topo.seg_extract_masks)
    if topo.ell_edge_mats is not None:
        return ell_segment_max(x, topo.ell_edge_mats, topo.ell_inv_perm,
                               identity)
    return segment_max(_rows(x, topo), topo.out_deg)


def _seg_all(pred, topo):
    if topo.seg_plan is not None:
        return seg_reduce(pred, "all", topo.seg_plan, topo.seg_dist,
                          topo.seg_extract_masks)
    if topo.ell_edge_mats is not None:
        return ell_segment_all(pred, topo.ell_edge_mats, topo.ell_inv_perm,
                               topo.out_deg)
    return segment_all(_rows(pred, topo), topo.out_deg)


def _bcast(x, topo):
    """Node array -> per-out-edge array (the ``x[src]`` gather; the planned
    network under segment_impl='benes*')."""
    if topo.seg_plan is not None:
        return broadcast(x, topo.seg_plan, topo.seg_dist,
                         topo.seg_place_masks)
    return x[topo.src]


def _row(a: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``a[i]`` for a 0-d index tensor, without a device-to-host read."""
    return a.index_select(0, i.reshape(1).long())[0]


def node_estimates(state: FlowUpdatingState, topo) -> torch.Tensor:
    """Per-node estimate ``value - sum(out flows)`` (reference
    ``flowupdating-collectall.py:106-107``)."""
    return state.value - _seg_sum(state.flow, topo)


# ---- the two phases ------------------------------------------------------

def deliver_phase(state: FlowUpdatingState, topo, cfg: RoundConfig):
    """Arrivals + drain + receive.  Returns ``(state, processed_mask)``.

    Arrivals append at each edge's first free FIFO slot (the newest slot
    is overwritten when the queue is full); draining pops the head."""
    D = cfg.delay_depth
    Q = cfg.pending_depth
    dev = state.flow.device
    t = state.t
    slot = t % D

    arr_valid = _row(state.buf_valid, slot)                   # (E,)
    depth = state.pending_valid.sum(0)                        # (E,)
    put = torch.clamp(depth, max=Q - 1)
    hit = arr_valid[None, :] & (
        torch.arange(Q, device=dev)[:, None] == put[None, :])
    pending_flow = torch.where(_ex(hit, state.pending_flow),
                               _row(state.buf_flow, slot)[None],
                               state.pending_flow)
    pending_est = torch.where(_ex(hit, state.pending_est),
                              _row(state.buf_est, slot)[None],
                              state.pending_est)
    pending_stamp = torch.where(hit, t, state.pending_stamp)
    pending_valid = state.pending_valid | hit
    buf_valid = state.buf_valid & ~(
        torch.arange(D, device=dev) == slot)[:, None]

    receiver_alive = _bcast(state.alive, topo)
    candidates = pending_valid[0] & receiver_alive          # head ready

    if cfg.drain == 0:
        process = candidates
    else:
        # FIFO pick of `drain` pending in-edges per node: the head
        # message's arrival round first (SimGrid pops the oldest message
        # of the node's mailbox), then the edge rank rotated by the round
        # counter, so same-round arrivals are serviced round-robin
        process = torch.zeros_like(candidates)
        remaining = candidates
        prio = torch.remainder(topo.edge_rank - t,
                               torch.clamp(topo.deg_e, min=1))
        for _ in range(cfg.drain):
            skey = torch.where(remaining, pending_stamp[0], _I32_MAX)
            oldest = _seg_min(skey, topo, _I32_MAX)
            tie = (remaining & (skey == _bcast(oldest, topo))
                   & (skey < _I32_MAX))
            key = torch.where(tie, prio, _I32_MAX)
            best = _seg_min(key, topo, _I32_MAX)
            pick = tie & (key == _bcast(best, topo)) & (key < _I32_MAX)
            process = process | pick
            remaining = remaining & ~pick

    recv_flow = pending_flow[0]
    if cfg.robust == "clip":
        # the receive-side half of the ledger clamp (see fire_core): the
        # antisymmetry write honors the same +-robust_clip bound
        recv_flow = torch.clamp(recv_flow, -cfg.robust_clip, cfg.robust_clip)
    flow = torch.where(_ex(process, state.flow), -recv_flow, state.flow)
    est = torch.where(_ex(process, state.est), pending_est[0], state.est)
    recv = state.recv | process

    if Q > 1:
        # pop the head of each processed queue: shift slots down by one
        def shift(a, fill):
            return torch.cat([a[1:], fill], 0)

        pending_flow = torch.where(_ex(process[None], pending_flow),
                                   shift(pending_flow, pending_flow[-1:]),
                                   pending_flow)
        pending_est = torch.where(_ex(process[None], pending_est),
                                  shift(pending_est, pending_est[-1:]),
                                  pending_est)
        pending_stamp = torch.where(process[None, :],
                                    shift(pending_stamp, pending_stamp[-1:]),
                                    pending_stamp)
        pending_valid = torch.where(
            process[None, :],
            shift(pending_valid, torch.zeros_like(pending_valid[:1])),
            pending_valid)
    else:
        pending_valid = pending_valid & ~process[None, :]

    state = state.replace(
        flow=flow, est=est, recv=recv, pending_flow=pending_flow,
        pending_est=pending_est, pending_valid=pending_valid,
        pending_stamp=pending_stamp, buf_valid=buf_valid)
    return state, process


def _align_drop(keep, topo):
    """Loss draws are keyed by ORIGINAL edge id: on a reordered topology
    (``drop_perm``) plan edge e takes its original edge's draw."""
    if topo.drop_perm is None:
        return keep
    return keep[topo.drop_perm]


def _draw_dtype(dt: torch.dtype) -> torch.dtype:
    """The loss draw's float type: float64 for a float64 ledger (the JAX
    package under ``jax_enable_x64``), float32 otherwise (without it)."""
    return torch.float64 if dt == torch.float64 else torch.float32


def _trim_extreme_edges(state: FlowUpdatingState, topo, cfg: RoundConfig,
                        dt) -> torch.Tensor:
    """The trimmed-mean mark (``robust='trim'``): a node of degree >= 3
    whose neighbor-estimate spread exceeds ``cfg.robust_tol`` marks its
    single highest and single lowest neighbor-estimate edge (ties broken
    by the lowest edge rank).  Returns the ``(E,)`` marked-edge mask."""
    fi = torch.finfo(dt)
    est_hi = _seg_max(state.est, topo, fi.min)
    est_lo = _seg_min(state.est, topo, fi.max)
    tol = torch.tensor(cfg.robust_tol, dtype=dt, device=state.est.device)
    can = (topo.out_deg >= 3) & (est_hi - est_lo > tol)
    can_e = _bcast(can, topo)
    at_hi = can_e & (state.est >= _bcast(est_hi, topo))
    at_lo = can_e & (state.est <= _bcast(est_lo, topo))

    def pick(at):
        first = _seg_min(torch.where(at, topo.edge_rank, _I32_MAX), topo,
                         _I32_MAX)
        return at & (topo.edge_rank == _bcast(first, topo))

    return pick(at_hi) | pick(at_lo)


def _reject_vec_trim(vec: bool) -> None:
    if vec:
        raise ValueError(
            "robust='trim' marks per-edge extreme ESTIMATES, a "
            "control-plane (feature-free) decision; vector "
            "payloads would need per-feature firing — use "
            "robust='clip' for (N, D) payloads")


def _clip_delta(flow, target, clip):
    """The ledger move the ``+-clip`` clamp admits toward ``target``."""
    return torch.clamp(flow + target, -clip, clip) - flow


def fire_core(state: FlowUpdatingState, topo, cfg: RoundConfig, trigger):
    """Tick + averaging + ledger update; the outgoing messages are computed
    but not delivered.  Returns ``(state, msg_est, send_mask)``: edge e's
    message is ``(state.flow[e], msg_est[e])``, the sender's ledger after
    the update (``flowupdating-collectall.py:116-125``)."""
    E = topo.num_edges
    dt = state.flow.dtype
    t = state.t
    src = topo.src
    ticks, stamp, recv = state.ticks, state.stamp, state.recv
    last_avg, fired_ctr = state.last_avg, state.fired

    # collect-all reduces the flow sum, the est sum and all-heard; on the
    # planned segment networks they share one batched extraction.  Vector
    # payloads take the per-op path.
    vec = state.flow.dim() > 1
    all_heard = None
    if topo.seg_plan is not None and cfg.variant == COLLECTALL and not vec:
        xs = [(state.flow, "sum"), (state.est, "sum")]
        if cfg.fire_policy != "every_round":
            xs.append((recv, "all"))
        red = seg_reduce_multi(xs, topo.seg_plan, topo.seg_dist,
                               topo.seg_extract_masks)
        flows_sum, est_sum = red[0], red[1]
        if cfg.fire_policy != "every_round":
            all_heard = red[2]
    else:
        flows_sum = _seg_sum(state.flow, topo)
        est_sum = (_seg_sum(state.est, topo)
                   if cfg.variant == COLLECTALL else None)
    estimate = state.value - flows_sum

    if cfg.variant == COLLECTALL:
        ticks = ticks + 1
        if cfg.fire_policy == "every_round":
            fire_n = state.alive
        else:
            if all_heard is None:
                all_heard = _seg_all(recv, topo)
            fire_n = (all_heard | (ticks >= cfg.timeout)) & state.alive
        # the average over self and ALL neighbors' last-known estimates
        # (unheard neighbors count as the reference's defaultdict 0.0);
        # under trim, without the marked edges, which also move no flow
        trim_edge = None
        if cfg.robust == "trim":
            _reject_vec_trim(vec)
            trim_edge = _trim_extreme_edges(state, topo, cfg, dt)
            t_sum = _seg_sum(torch.where(trim_edge, 0.0, state.est), topo)
            t_cnt = topo.out_deg - _seg_sum(trim_edge.to(torch.int32),
                                            topo)
            avg = (estimate + t_sum) / _ex((t_cnt + 1).to(dt), estimate)
        else:
            avg = (estimate + est_sum) / _ex((topo.out_deg + 1).to(dt),
                                             estimate)
        if topo.seg_plan is not None and not vec:
            fire_e, avg_e = broadcast_multi(
                [fire_n, avg], topo.seg_plan, topo.seg_dist,
                topo.seg_place_masks)
        else:
            fire_e = _bcast(fire_n, topo)
            avg_e = _bcast(avg, topo)
        # marked edges still send the unchanged ledger and the fresh
        # average (silencing them deadlocks honest pairs)
        act_e = fire_e if trim_edge is None else fire_e & ~trim_edge
        fire_ex = _ex(act_e, state.flow)
        if cfg.robust == "clip":
            delta = _clip_delta(state.flow, avg_e - state.est,
                                cfg.robust_clip)
            clipped = state.est + delta
            new_flow = torch.where(fire_ex, state.flow + delta, state.flow)
            new_est = torch.where(fire_ex, clipped, state.est)
            msg_est = clipped
        else:
            new_flow = torch.where(fire_ex, state.flow + avg_e - state.est,
                                   state.flow)
            new_est = torch.where(fire_ex, avg_e, state.est)
            msg_est = avg_e
        send_mask = fire_e
        ticks = torch.where(fire_n, 0, ticks)
        recv = recv & ~fire_e
        last_avg = torch.where(_ex(fire_n, avg), avg, last_avg)
        fired_ctr = fired_ctr + fire_n.to(torch.int32)
    elif cfg.fire_policy == "every_round":
        # fast synchronous pairwise: one proper edge-color class fires per
        # round and matched endpoints exchange directly (both current
        # estimates, exactly antisymmetric flow deltas)
        if topo.edge_color is None:
            raise ValueError(
                "fast pairwise mode needs the edge coloring: build the "
                "topology arrays with device_arrays(coloring=True)")
        matched = ((topo.edge_color == t % topo.num_colors)
                   & state.alive[src] & state.alive[topo.dst]
                   & state.edge_ok & state.edge_ok[topo.rev])
        if cfg.robust == "trim":
            # an armed node refuses to match along its extreme edges (both
            # ends stand down, so antisymmetry and mass are untouched)
            _reject_vec_trim(vec)
            trim_edge = _trim_extreme_edges(state, topo, cfg, dt)
            matched = matched & ~trim_edge & ~trim_edge[topo.rev]
        x_u = estimate[src]
        x_v = estimate[topo.dst]
        m_ex = _ex(matched, state.flow)
        if cfg.robust == "clip":
            # clip is odd and the flow antisymmetric, so delta[rev] ==
            # -delta: mass is conserved exactly
            delta = _clip_delta(state.flow, (x_u - x_v) * 0.5,
                                cfg.robust_clip)
            avg_e = x_u - delta
            new_flow = torch.where(m_ex, state.flow + delta, state.flow)
        else:
            avg_e = (x_u + x_v) * 0.5
            new_flow = torch.where(m_ex, state.flow + (x_u - x_v) * 0.5,
                                   state.flow)
        new_est = torch.where(m_ex, avg_e, state.est)
        msg_est = avg_e
        send_mask = torch.zeros_like(matched)  # direct exchange, no messages
        stamp = torch.where(matched, t, stamp)
        fire_any = _seg_max(matched.to(torch.int32), topo, 0) > 0
        node_avg = _seg_sum(torch.where(m_ex, avg_e, 0.0), topo)
        last_avg = torch.where(_ex(fire_any, node_avg), node_avg, last_avg)
        fired_ctr = fired_ctr + fire_any.to(torch.int32)
    else:
        # faithful pairwise: each firing out-edge applies x -> (x + est)/2
        # to the node's running estimate in edge order (the reference's
        # loop over stale neighbors, pairwise.py:86-91,102-109) — one
        # segmented affine scan
        stale = stamp < (t - cfg.timeout)
        fire_e = (trigger | stale) & _bcast(state.alive, topo)
        if cfg.robust == "trim":
            # an armed node's extreme edges do not fire: no flow delta,
            # no message
            _reject_vec_trim(vec)
            fire_e = fire_e & ~_trim_extreme_edges(state, topo, cfg, dt)
        fire_f = fire_e.to(dt)
        a = 1.0 - 0.5 * fire_f                       # 0.5 firing, 1 not
        b = torch.where(_ex(fire_e, state.est), state.est * 0.5, 0.0)
        A, B = segmented_affine_scan(a, b, topo.edge_rank == 0)
        run_est = _ex(A, B) * _bcast(estimate, topo) + B
        avg_e = run_est                 # the 2-party average at firing e
        f_ex = _ex(fire_e, state.flow)
        if cfg.robust == "clip":
            # the scan keeps the unclipped 2-party targets (the clamp is
            # not affine); the write admits only the clamped delta
            delta = _clip_delta(state.flow, avg_e - state.est,
                                cfg.robust_clip)
            clipped = state.est + delta
            new_flow = torch.where(f_ex, state.flow + delta, state.flow)
            new_est = torch.where(f_ex, clipped, state.est)
            msg_est = clipped
        else:
            new_flow = torch.where(f_ex, state.flow + avg_e - state.est,
                                   state.flow)
            new_est = torch.where(f_ex, avg_e, state.est)
            msg_est = avg_e
        send_mask = fire_e
        stamp = torch.where(fire_e, t, stamp)
        # last_avg = the running estimate at the row end (identity maps
        # pass it through)
        fire_any = _seg_max(fire_e.to(torch.int32), topo, 0) > 0
        if topo.seg_plan is not None:
            final_est = extract_row_ends(run_est, topo.seg_plan,
                                         topo.seg_extract_masks)
        else:
            seg_end = torch.clamp(topo.row_start[1:] - 1, min=0)
            final_est = run_est[seg_end]
        last_avg = torch.where(_ex(fire_any, final_est), final_est,
                               last_avg)
        fired_ctr = fired_ctr + fire_any.to(torch.int32)

    # a dead link loses every message put on it; the sender's ledger is
    # still updated, exactly like per-message loss
    send_mask = send_mask & state.edge_ok
    key = state.key
    if cfg.drop_rate > 0.0:
        key, sub = prng.split(key)
        keep = prng.bernoulli(sub, 1.0 - cfg.drop_rate, E, _draw_dtype(dt))
        send_mask = send_mask & _align_drop(keep, topo)

    state = state.replace(flow=new_flow, est=new_est, recv=recv,
                          ticks=ticks, stamp=stamp, last_avg=last_avg,
                          fired=fired_ctr, key=key)
    return state, msg_est, send_mask


def _link_sum(per_link, per_slot, topo):
    """``per_link + sum of per_slot over each link's route slots``, the
    slots added one after another in flat ``(e, k)`` order (JAX's
    ``.at[edge_links].add`` on its CPU) — a gather into the link-major
    CSR and one segment sum, the same order on every run of the card."""
    data = torch.cat([per_link, per_slot])[topo.link_gather]
    return torch.segment_reduce(data, "sum", lengths=topo.link_lengths)


def _link_count(counts, topo, base=None):
    """Per-link integer count of the ``(E,)`` ``counts`` over the route
    slots (exact in any order); ``base`` adds a standing count."""
    Lp = topo.link_ser_rounds.shape[0]
    K = topo.edge_links.shape[1]
    out = (torch.zeros(Lp, dtype=torch.int32, device=counts.device)
           if base is None else base.clone())
    return out.index_add_(0, topo.edge_links.reshape(-1),
                          counts.to(torch.int32).repeat_interleave(K))


def edge_delays(topo, cfg: RoundConfig, send_mask,
                inflight=None) -> torch.Tensor:
    """Per-edge delivery delay of this round's sends.

    Static (``topo.delay``) unless ``cfg.contention``: then each SHARED
    link's capacity is split across this round's concurrent sends
    (bottleneck fair share, the quasi-static approximation of a max-min
    network; FATPIPE links never share), and::

        delay[e] = clamp(rint(lat_rounds[e] +
                              max_{l in route(e)} load[l] * ser[l]),
                         1, delay_depth)

    with ``load[l]`` the number of concurrent sends crossing a shared
    link (at least 1), 1 on FATPIPE.  ``cfg.contention_iters > 0``
    replaces the local fair share by that many rounds of progressive
    filling (fix the flows at the most contended link at their share,
    release what they leave on their other links, repeat; leftovers take
    their local share).  ``inflight`` ((E,) — messages still in the ring
    buffer) counts as standing load under ``cfg.contention_backlog``.
    All in float32 as in the JAX package; the float per-link sums run in
    the fixed order of :func:`_link_sum`."""
    if not cfg.contention:
        return topo.delay
    if topo.edge_links is None:
        raise ValueError(
            "cfg.contention needs a topology with a link model (platform-"
            "loaded with latency_scale > 0; generators have no links)")
    el = topo.edge_links
    K = el.shape[1]
    standing = None
    if cfg.contention_backlog and inflight is not None:
        standing = _link_count(inflight, topo)
    flows = _link_count(send_mask, topo, standing)
    lat_rounds = topo.lat_rounds
    link_ser = topo.link_ser_rounds
    D = cfg.delay_depth
    if cfg.contention_iters == 0:
        load = torch.where(topo.link_shared, torch.clamp(flows, min=1), 1)
        ser = load.to(link_ser.dtype) * link_ser
        worst = ser[el].amax(1)                    # the pad slot adds 0
        dyn = torch.round(lat_rounds + worst).to(torch.int32)
        return torch.clamp(dyn, 1, D)

    f32 = torch.float32
    inf = torch.tensor(float("inf"), dtype=f32, device=el.device)
    ser0 = link_ser.to(f32)
    constraining = topo.link_shared & (ser0 > 0)
    cap_rem = torch.where(constraining,
                          1.0 / torch.clamp(ser0, min=1e-30), inf)
    nflow = flows.to(f32)
    # per-flow full-rate bound from NON-shared ser > 0 links
    own = torch.where(~topo.link_shared & (ser0 > 0),
                      1.0 / torch.clamp(ser0, min=1e-30), inf)
    own_cap = own[el].amin(1)
    rate = torch.zeros(el.shape[0], dtype=f32, device=el.device)
    fixed = ~send_mask

    def shares():
        fair = torch.where((nflow > 0.5) & constraining,
                           cap_rem / torch.clamp(nflow, min=1.0), inf)
        return torch.minimum(fair[el].amin(1), own_cap)

    for _ in range(cfg.contention_iters):
        share = shares()
        m = torch.where(fixed, inf, share).amin()
        newly = (~fixed) & torch.isfinite(share) & (share <= m * 1.000001)
        rate = torch.where(newly, share, rate)
        taken = torch.where(newly, share, 0.0).repeat_interleave(K)
        cap_rem = torch.clamp(_link_sum(cap_rem, -taken, topo), min=0.0)
        nflow = torch.clamp(
            nflow - _link_count(newly, topo).to(f32), min=0.0)
        fixed = fixed | newly
    rate = torch.where(fixed, rate, shares())
    transfer = torch.where(torch.isfinite(rate) & (rate > 0),
                           1.0 / torch.clamp(rate, min=1e-30), 0.0)
    dyn = torch.round(lat_rounds + transfer).to(torch.int32)
    return torch.clamp(dyn, 1, D)


def send_messages(state: FlowUpdatingState, topo, cfg: RoundConfig,
                  msg_est, send_mask) -> FlowUpdatingState:
    """Delivery into the receiver edge's ring-buffer slot at ``(t + delay)
    % D``.  'gather': receiving edge r pulls from ``rev[r]`` (``rev`` is an
    involution, so this is the sender's push); 'benes*': the same pull
    through the planned network, flow, estimate and send mask as one
    batch of lanes; 'scatter': the literal push (targets are distinct, a
    non-sender writes a discarded pad column)."""
    E = topo.num_edges
    t = state.t
    D = cfg.delay_depth
    dev = state.flow.device
    # deliver_phase cleared this round's arrival slots, so the ring's
    # valid slots are the messages still in flight; column r holds those
    # sent along rev[r], whose route is rev[r]'s: gather through rev
    inflight = (state.buf_valid.sum(0, dtype=torch.int32)[topo.rev]
                if cfg.contention_backlog else None)
    delay = edge_delays(topo, cfg, send_mask, inflight=inflight)
    wire_flow = state.flow
    if cfg.delivery in ("gather", "benes", "benes_fused"):
        if cfg.delivery != "gather":
            if topo.rev_plan is None:
                raise ValueError("delivery='benes' needs device_arrays("
                                 "delivery_benes=True)")
            dt = state.flow.dtype
            # the delay lane carries whole rounds: at least float32
            lane_dt = (torch.promote_types(dt, torch.float32)
                       if cfg.contention else dt)
            nf = _feat(state.flow)
            vec = state.flow.dim() > 1

            def as_lanes(x):
                return (x.T.to(lane_dt) if x.dim() > 1
                        else x.to(lane_dt)[None])

            lanes = [as_lanes(wire_flow), as_lanes(msg_est),
                     send_mask.to(lane_dt)[None]]
            if cfg.contention:
                lanes.append(delay.to(lane_dt)[None])
            moved = apply_padded_perm(torch.cat(lanes), topo.rev_plan,
                                      topo.rev_masks)

            def un_lanes(m):
                return (m.T if vec else m[0]).to(dt)

            pay_flow = un_lanes(moved[:nf])
            pay_est = un_lanes(moved[nf:2 * nf])
            sending = moved[2 * nf] > 0.5
            delay_r = (moved[2 * nf + 1].to(torch.int32) if cfg.contention
                       else topo.delay_rev)
            slot_r = (t + delay_r) % D
        else:
            rf = topo.rev
            sending = send_mask[rf]
            pay_flow = wire_flow[rf]
            pay_est = msg_est[rf]
            slot_r = (t + delay[rf]) % D
        hit = sending[None, :] & (
            slot_r[None, :] == torch.arange(D, device=dev)[:, None])
        hit_p = _ex(hit, state.buf_flow)
        buf_flow = torch.where(hit_p, pay_flow[None], state.buf_flow)
        buf_est = torch.where(hit_p, pay_est[None], state.buf_est)
        buf_valid = state.buf_valid | hit
    else:
        slot_idx = ((t + delay) % D).long()
        tgt = torch.where(send_mask, topo.rev, E)

        def push(buf, val):
            pad = torch.cat([buf, buf[:, :1]], 1)
            pad[slot_idx, tgt] = val
            return pad[:, :E]

        buf_flow = push(state.buf_flow, wire_flow)
        buf_est = push(state.buf_est, msg_est)
        buf_valid = push(state.buf_valid,
                         torch.ones_like(send_mask))
    return state.replace(t=t + 1, buf_flow=buf_flow, buf_est=buf_est,
                         buf_valid=buf_valid)


def fire_phase(state: FlowUpdatingState, topo, cfg: RoundConfig,
               trigger) -> FlowUpdatingState:
    """Tick, averaging, ledger update and message send."""
    state, msg_est, send_mask = fire_core(state, topo, cfg, trigger)
    return send_messages(state, topo, cfg, msg_est, send_mask)


def round_step_aux(state: FlowUpdatingState, topo, cfg: RoundConfig,
                   params=None):
    """One full round, also returning the per-edge ``processed`` (drained
    this round) and ``send_mask`` (fired) masks."""
    check_ported(cfg, params)
    state, processed = deliver_phase(state, topo, cfg)
    state, msg_est, send_mask = fire_core(state, topo, cfg, processed)
    state = send_messages(state, topo, cfg, msg_est, send_mask)
    return state, processed, send_mask


def round_step(state: FlowUpdatingState, topo, cfg: RoundConfig,
               params=None) -> FlowUpdatingState:
    """One full gossip round (one simulated second of the reference)."""
    return round_step_aux(state, topo, cfg, params)[0]


def run_rounds(state: FlowUpdatingState, topo, cfg: RoundConfig,
               num_rounds: int, params=None) -> FlowUpdatingState:
    """Run ``num_rounds`` rounds as a Python loop on the state's device."""
    check_ported(cfg, params)
    for _ in range(int(num_rounds)):
        state = round_step(state, topo, cfg)
    return state


def _observe_chunk(state: FlowUpdatingState, topo, cfg: RoundConfig,
                   observe_every: int, mean: torch.Tensor):
    """``observe_every`` rounds and one watcher sample over the alive
    nodes: ``(t, rmse, max_abs_err, mass, fired_total)`` as 0-d tensors
    on the state's device (no host read)."""
    for _ in range(observe_every):
        state = round_step(state, topo, cfg)
    est = node_estimates(state, topo)
    alive = _ex(state.alive, est)
    cnt = (torch.clamp(state.alive.sum(), min=1) * _feat(est)).to(est.dtype)
    err = torch.where(alive, est - mean, 0.0)
    return state, (state.t, torch.sqrt((err * err).sum() / cnt),
                   err.abs().max(), torch.where(alive, est, 0.0).sum(),
                   state.fired.sum(dtype=torch.int64))


def run_rounds_observed(state: FlowUpdatingState, topo, cfg: RoundConfig,
                        num_rounds: int, observe_every: int, true_mean):
    """Run rounds in chunks of ``observe_every``, one watcher sample per
    chunk (reference ``flowupdating-collectall.py:139-142``).  Returns
    ``(state, metrics)``: ``metrics`` maps ``t``, ``rmse``,
    ``max_abs_err``, ``mass`` and ``fired_total`` to ``(chunks,)``
    tensors on the state's device."""
    if num_rounds % observe_every:
        raise ValueError("num_rounds must be a multiple of observe_every")
    mean = torch.tensor(true_mean, dtype=state.value.dtype,
                        device=state.value.device)
    rows = []
    for _ in range(num_rounds // observe_every):
        state, sample = _observe_chunk(state, topo, cfg, observe_every, mean)
        rows.append(sample)
    names = ("t", "rmse", "max_abs_err", "mass", "fired_total")
    dtypes = (torch.int32, mean.dtype, mean.dtype, mean.dtype, torch.int64)
    return state, {
        name: (torch.stack([r[i] for r in rows]) if rows else
               torch.zeros(0, dtype=dt, device=mean.device))
        for i, (name, dt) in enumerate(zip(names, dtypes))}


def telemetry_sample(state, topo, spec, mean, processed,
                     send_mask) -> dict:
    """One round's metric row for the edge kernel, as device tensors (no
    host read).  ``spec`` is a :class:`~flow_updating_tpu_torch.obs.
    telemetry.TelemetrySpec`; only the selected metrics are computed.
    Metrics mask to alive nodes (padding dummies and crash-stopped
    nodes excluded)."""
    out = {"t": state.t}
    alive = state.alive
    need_est = any(spec.has(m) for m in
                   ("rmse", "max_abs_err", "mass", "mass_residual"))
    if need_est:
        est = node_estimates(state, topo)
        a_ex = _ex(alive, est)
        if spec.has("rmse") or spec.has("max_abs_err"):
            err = torch.where(a_ex, est - mean, 0.0)
            if spec.has("rmse"):
                cnt = (torch.clamp(alive.sum(), min=1)
                       * _feat(est)).to(est.dtype)
                out["rmse"] = torch.sqrt((err * err).sum() / cnt)
            if spec.has("max_abs_err"):
                out["max_abs_err"] = err.abs().max()
        if spec.has("mass") or spec.has("mass_residual"):
            mass = torch.where(a_ex, est, 0.0).sum(0)   # per feature
            if spec.has("mass"):
                out["mass"] = mass
            if spec.has("mass_residual"):
                out["mass_residual"] = mass - torch.where(
                    _ex(alive, state.value), state.value, 0.0).sum(0)
    if spec.has("antisymmetry"):
        out["antisymmetry"] = (state.flow + state.flow[topo.rev]).abs() \
            .max()
    if spec.has("sent"):
        out["sent"] = send_mask.sum(dtype=torch.int32)
    if spec.has("delivered"):
        out["delivered"] = processed.sum(dtype=torch.int32)
    if spec.has("fired_total"):
        out["fired_total"] = state.fired.sum(dtype=torch.int64)
    if spec.has("active"):
        out["active"] = alive.sum(dtype=torch.int32)
    return out


def run_rounds_telemetry(state: FlowUpdatingState, topo, cfg: RoundConfig,
                         num_rounds: int, spec, true_mean, params=None):
    """Run ``num_rounds`` rounds, accumulating the ``spec``-selected
    per-round metric series on the device (preallocated rows, no host
    read in the loop).  Returns ``(state, {metric: (R,) or (R, D)
    tensor})``.  The state evolves exactly as under :func:`run_rounds`.
    A disabled spec is rejected: callers run :func:`run_rounds` instead
    (``Engine.run_telemetry`` does)."""
    from flow_updating_tpu_torch.obs.telemetry import SeriesRecorder

    if not spec.enabled:
        raise ValueError(
            "telemetry spec is disabled; run run_rounds() instead (the "
            "Engine.run_telemetry dispatcher handles this)")
    check_ported(cfg, params)
    mean = torch.tensor(true_mean, dtype=state.value.dtype,
                        device=state.value.device)
    rec = SeriesRecorder(num_rounds)
    for i in range(int(num_rounds)):
        state, processed, send_mask = round_step_aux(state, topo, cfg)
        rec.put(i, telemetry_sample(state, topo, spec, mean, processed,
                                    send_mask))
    return state, rec.series()


def run_rounds_streamed(state: FlowUpdatingState, topo, cfg: RoundConfig,
                        num_rounds: int, observe_every: int, true_mean,
                        emit) -> FlowUpdatingState:
    """Like :func:`run_rounds_observed`, but each chunk's watcher sample
    goes to ``emit(metrics_dict)`` (host numbers) as soon as the chunk
    ends — the one host read per ``observe_every`` rounds."""
    from flow_updating_tpu_torch.utils.metrics import observer_sample

    if num_rounds % observe_every:
        raise ValueError("num_rounds must be a multiple of observe_every")
    mean = torch.tensor(true_mean, dtype=state.value.dtype,
                        device=state.value.device)
    for _ in range(num_rounds // observe_every):
        state, sample = _observe_chunk(state, topo, cfg, observe_every,
                                       mean)
        emit(observer_sample(*(x.item() for x in sample)))
    return state


def _pool_abs(x: torch.Tensor) -> torch.Tensor:
    """Per-entity magnitude with trailing feature axes pooled (max |.|)."""
    if x.dim() > 1:
        return x.abs().amax(dim=tuple(range(1, x.dim())))
    return x.abs()


def _pool_sum(x: torch.Tensor) -> torch.Tensor:
    """Signed feature pooling (sum) — keeps flow antisymmetry."""
    if x.dim() > 1:
        return x.sum(dim=tuple(range(1, x.dim())))
    return x


def topk_rows(mag: torch.Tensor, m: int) -> torch.Tensor:
    """Indices of the ``m`` largest entries of ``mag``, the lower index
    first among equal values (``jax.lax.top_k``'s order; ``torch.topk``
    promises none, and ties are common: dead and padded nodes sit at 0)."""
    return torch.sort(mag, descending=True, stable=True)[1][:m]


def field_sample(state: FlowUpdatingState, topo, spec, mean):
    """One recorded row of per-node/per-edge fields for the edge kernel,
    as device tensors (no host read).  ``spec`` is a :class:`~flow_updating_
    tpu_torch.obs.fields.FieldSpec`.  Returns ``(row, err)``, ``err``
    being the alive-masked signed estimate error (None when no selected
    field needs it), which the convergence frontier and the topk ranking
    reuse.  The masking is :func:`telemetry_sample`'s, so each field
    reduces to the global series."""
    row = {"t": state.t, "active": state.alive.sum(dtype=torch.int32)}
    err = None
    if any(spec.has(f) for f in ("node_err", "node_mass",
                                 "node_mass_residual", "node_conv_round")):
        est = node_estimates(state, topo)
        a_ex = _ex(state.alive, est)
        err = torch.where(a_ex, est - mean, 0.0)
        if spec.has("node_err"):
            row["node_err"] = err
        if spec.has("node_mass"):
            row["node_mass"] = torch.where(a_ex, est, 0.0)
        if spec.has("node_mass_residual"):
            row["node_mass_residual"] = torch.where(a_ex, est - state.value,
                                                    0.0)
    if spec.has("node_fired"):
        row["node_fired"] = state.fired.to(torch.int32)
    if spec.has("edge_flow"):
        row["edge_flow"] = _pool_sum(state.flow)
    if spec.has("edge_est"):
        row["edge_est"] = _pool_sum(state.est)
    if spec.has("edge_stale"):
        row["edge_stale"] = (state.t - state.stamp).to(torch.int32)
    return row, err


def frontier_update(conv: torch.Tensor, err: torch.Tensor, live, t,
                    tol: float) -> torch.Tensor:
    """The convergence frontier after one recorded row: each entry still
    at -1 whose pooled ``|err|`` is within ``tol`` takes the round ``t``
    (a 0-d tensor or a Python int), int32 throughout; ``live`` (a mask, or
    None on kernels with no dead or padded entries) limits it."""
    within = _pool_abs(err) <= tol
    if live is not None:
        within = within & live
    return torch.where((conv < 0) & within, t, conv)


def keep_topk(row: dict, err: torch.Tensor, spec) -> dict:
    """Narrow the per-node series fields of ``row`` to the ``spec.topk``
    worst nodes by pooled ``|err|``, and record their ids as
    ``topk_idx`` (int32)."""
    idx = topk_rows(_pool_abs(err), spec.topk)
    for name in spec.node_series_fields:
        row[name] = row[name][idx]
    row["topk_idx"] = idx.to(torch.int32)
    return row


def run_rounds_fields(state: FlowUpdatingState, topo, cfg: RoundConfig,
                      num_rounds: int, spec, true_mean, params=None):
    """Run ``num_rounds`` rounds, recording the ``spec``-selected field
    rows every ``spec.stride`` rounds into preallocated ``(R/stride,
    ...)`` tensors on the device (no host read in the loop).  Returns
    ``(state, conv_round, series)``: ``conv_round`` is the ``(N,)`` int32
    convergence frontier (-1 = never within ``spec.tol``).

    Recording is a pure observer: each chunk runs exactly ``stride``
    :func:`round_step` calls and then reads the state, so the state
    equals :func:`run_rounds`' bit for bit at any stride.  A disabled
    spec is rejected: callers run :func:`run_rounds` instead
    (``Engine.run_fields`` does)."""
    from flow_updating_tpu_torch.obs.telemetry import SeriesRecorder

    if not spec.enabled:
        raise ValueError(
            "field spec is disabled; run run_rounds() instead (the "
            "Engine.run_fields dispatcher handles this)")
    stride = spec.stride
    if num_rounds % stride:
        raise ValueError(
            f"num_rounds={num_rounds} must be a multiple of the field "
            f"stride {stride}")
    check_ported(cfg, params)
    dev = state.value.device
    mean = torch.tensor(true_mean, dtype=state.value.dtype, device=dev)
    conv = torch.full(state.alive.shape, -1, dtype=torch.int32, device=dev)
    rec = SeriesRecorder(num_rounds // stride)
    for i in range(num_rounds // stride):
        for _ in range(stride):
            state = round_step(state, topo, cfg)
        row, err = field_sample(state, topo, spec, mean)
        if spec.has("node_conv_round"):
            conv = frontier_update(conv, err, state.alive, state.t,
                                   spec.tol)
        if spec.topk:
            row = keep_topk(row, err, spec)
        rec.put(i, row)
    return state, conv, rec.series()


# ---- runners of later port items -------------------------------------------

def _later_runner(name: str, item: str):
    def runner(*args, **kwargs):
        raise _not_ported(f"{name}()", item)

    runner.__name__ = runner.__qualname__ = name
    runner.__doc__ = f"The JAX package's ``{name}``: ROADMAP item {item}."
    return runner


init_chunked_state = _later_runner("init_chunked_state", "workloads (A13)")
run_rounds_chunked = _later_runner("run_rounds_chunked", "workloads (A13)")
run_rounds_chunked_telemetry = _later_runner(
    "run_rounds_chunked_telemetry", "workloads (A13)")
