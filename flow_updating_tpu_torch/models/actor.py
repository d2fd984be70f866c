"""Custom actors as whole-population tensor programs.

Counterpart of ``flow_updating_tpu/models/actor.py``.  The reference runs
one Python object per host inside SimGrid's actor scheduler
(``Engine.register_actor("peer", Peer)``, ``flowupdating-collectall.py:156``);
per-actor bytecode cannot run on the card.  The vetted extension point is
a :class:`VectorActor`: the user writes the *same protocol logic* as three
functions over the entire node/edge population (torch ops on ``(N,)`` /
``(E,)`` tensors), and :class:`ActorKernel` runs them round after round on
the engine's device, like the built-in kernels.  One actor "class" = one
program; N actors = the tensor axis.

Message model (the built-in fast path's): directed edge ``e`` carries
``src[e] -> dst[e]``; whatever ``round`` places in ``outbox[e]`` is
delivered to ``dst[e]``'s inbox at the START of the next round (unit
delay).  ``view.recv(inbox_leaf)`` re-keys an inbox so that slot ``e``
holds the message that arrived *along the reverse edge* — what ``src[e]``
last told ``dst[e]``.

Reductions over a node's in-edges use ``view.sum_to_dst`` /
``view.max_to_dst``.  The sum is a dst-segmented sum in a fixed order: an
ELL of each node's in-edge ids (padded with the sentinel ``E``), grouped
by in-degree like ``Topology.ell_buckets``, summed row by row and written
back to node order.  For an ``(E,)`` float leaf on the card that row sum
is kernel **K1** (``ops/spmv.neighbor_sum_ell``, ``csrc/spmv_ell.cu``,
whose indices may range over any ``[0, M]``); on the CPU it is K1's plain
version (``ops/spmv.neighbor_sum``), and other shapes take the plain
version on either device.  No atomic ``index_add_``: a resumed run must
repeat the uninterrupted one bit for bit.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable
from typing import Any

import numpy as np
import torch

from flow_updating_tpu_torch.ops.spmv import neighbor_sum, neighbor_sum_ell
from flow_updating_tpu_torch.utils.device import resolve_device


def in_edge_ell(dst: np.ndarray, num_nodes: int) -> dict:
    """Degree-bucketed ELL of each node's in-edge ids (host arrays).

    Nodes are ordered by the next power of two of their in-degree (stable,
    as ``Topology.ell_buckets`` orders by out-degree); each bucket is a
    ``(rows, width)`` int32 matrix of edge ids in ascending order, padded
    with ``E`` (the zero slot of the row sum).  ``inv[v]`` is node ``v``'s
    row in the concatenated bucket order."""
    dst = np.asarray(dst, np.int64)
    E, N = int(dst.shape[0]), int(num_nodes)
    deg = np.bincount(dst, minlength=N).astype(np.int64)
    eorder = np.argsort(dst, kind="stable")
    start = np.zeros(N + 1, np.int64)
    np.cumsum(deg, out=start[1:])
    width = np.zeros(N, np.int64)
    nz = deg > 0
    width[nz] = 1 << np.ceil(np.log2(deg[nz])).astype(np.int64)
    order = np.argsort(width, kind="stable")
    inv = np.empty(N, np.int64)
    inv[order] = np.arange(N, dtype=np.int64)
    sorted_w = width[order]
    mats, lo = [], 0
    while lo < N:
        hi = int(np.searchsorted(sorted_w, sorted_w[lo], side="right"))
        rows = order[lo:hi]
        w = int(deg[rows].max()) if sorted_w[lo] else 0
        ar = np.arange(w, dtype=np.int64)
        valid = ar[None, :] < deg[rows][:, None]
        col = np.where(valid, start[rows][:, None] + ar[None, :], 0)
        mats.append(np.where(valid, eorder[col], E).astype(np.int32)
                    .reshape(len(rows), w))
        lo = hi
    return {"mats": mats, "inv": inv, "degree": deg}


@dataclasses.dataclass(frozen=True, eq=False)
class TopoView:
    """The topology handed to actor functions, as tensors on the engine's
    device (``src``, ``dst``, ``rev`` int64 edge indices, ``degree`` the
    int32 in-degree) plus the in-edge ELL that :meth:`sum_to_dst` and
    :meth:`max_to_dst` reduce over.  ``eq=False``: identity-hashed."""

    num_nodes: int
    num_edges: int
    src: Any          # (E,) int64
    dst: Any          # (E,) int64
    rev: Any          # (E,) int64: index of the reverse directed edge
    degree: Any       # (N,) int32 in-degree
    ell: tuple = ()   # (rows_b, width_b) int32 in-edge ids, sentinel E
    ell_inv: Any = None   # (N,) int64: node -> row of the bucket order

    @classmethod
    def from_topology(cls, topology, device) -> TopoView:
        dev = resolve_device(device)
        ell = in_edge_ell(topology.dst, topology.num_nodes)
        t = lambda a, dt: torch.as_tensor(np.asarray(a), dtype=dt).to(dev)
        return cls(
            num_nodes=int(topology.num_nodes),
            num_edges=int(topology.num_edges),
            src=t(topology.src, torch.int64),
            dst=t(topology.dst, torch.int64),
            rev=t(topology.rev, torch.int64),
            degree=t(ell["degree"], torch.int32),
            ell=tuple(t(m, torch.int32).contiguous() for m in ell["mats"]),
            ell_inv=t(ell["inv"], torch.int64),
        )

    def send(self, node_vals):
        """(N,) per-node value -> (E,) outbox, one copy per out-edge."""
        return node_vals[self.src]

    def recv(self, inbox_leaf):
        """Re-key an (E,) inbox leaf so slot e = message on rev[e]
        (what src[e] sent to dst[e] — neighbor-pair addressing)."""
        return inbox_leaf[self.rev]

    def sum_to_dst(self, edge_vals):
        """(E,) -> (N,): sum of each node's incoming edge values, in the
        in-edge ELL's fixed order (module docstring).  An ``(E,)`` float
        leaf goes through kernel K1's wrapper (the kernel on the card,
        its plain version on the CPU, so a cost count reads the same on
        both); anything else through the plain version."""
        x = edge_vals
        if x.dim() == 1 and x.dtype in (torch.float32, torch.float64):
            rows = neighbor_sum_ell(x.contiguous(), self.ell)
        else:
            rows = neighbor_sum(x, self.ell)
        return rows[self.ell_inv]

    def max_to_dst(self, edge_vals):
        """(E,) -> (N,): max of each node's incoming edge values; a node
        with no in-edge reads ``-inf`` (the integer minimum for integer
        leaves), as ``jax.ops.segment_max`` fills empty segments."""
        x = edge_vals
        feat = x.shape[1:]
        low = (-torch.inf if x.dtype.is_floating_point
               else torch.iinfo(x.dtype).min)
        xp = torch.cat([x, x.new_full((1,) + feat, low)])
        parts = [xp[m].amax(dim=1) if m.shape[1] else
                 x.new_full((m.shape[0],) + feat, low) for m in self.ell]
        rows = torch.cat(parts) if len(parts) > 1 else parts[0]
        return rows[self.ell_inv]


@dataclasses.dataclass(frozen=True, eq=False)
class VectorActor:
    """A user protocol as population-wide tensor functions.

    init(values, view) -> (state, outbox)
        ``values``: (N,) float32 initial per-node inputs on the engine's
        device.  Returns the state (a dict, tuple or list of tensors whose
        leaves lead with N or E) and the first round's outbox of (E,)
        leaves (may be zeros).
    round(state, inbox, view) -> (state, outbox)
        One synchronous round.  ``inbox`` is last round's outbox,
        delivered (slot e = message IN FLIGHT on edge e; use
        ``view.recv`` for neighbor-pair addressing).  It must not write
        into its inputs: a round returns new tensors.
    estimate(state, view) -> (N,)
        Current per-node estimate, for watchers/metrics/convergence.
    """

    init: Callable
    round: Callable
    estimate: Callable
    name: str = "custom"


class ActorKernel:
    """Drives a :class:`VectorActor` with the NodeKernel interface the
    Engine dispatches on (``init_state`` / ``run`` / ``estimates`` /
    ``last_avg``), on ``device`` (the card unless ``'cpu'`` is given).

    ``mesh`` is JAX's GSPMD placement of the actor's leaves over a device
    mesh; the port has no GSPMD path (ROADMAP A12 part 4), so it raises."""

    def __init__(self, topology, actor: VectorActor, mesh=None,
                 device=None):
        if mesh is not None:
            raise NotImplementedError(
                "ActorKernel(mesh=) places a VectorActor's leaves over a "
                "device mesh through GSPMD: the ROADMAP item "
                "'multi-device execution: GSPMD (A12 part 4)', not ported "
                "yet — run the actor on one device")
        self.topology = topology
        self.actor = actor
        self.mesh = None
        self.device = resolve_device(device)
        self.padded_size = topology.num_nodes
        self.view = TopoView.from_topology(topology, self.device)

    def init_state(self):
        values = torch.as_tensor(np.asarray(self.topology.values),
                                 dtype=torch.float32).to(self.device)
        carry = self.actor.init(values, self.view)
        if not (isinstance(carry, tuple) and len(carry) == 2):
            raise TypeError(
                f"VectorActor {self.actor.name!r}: init must return "
                "(state, outbox)")
        return carry

    def _step(self, carry):
        state, outbox = carry
        out = self.actor.round(state, outbox, self.view)
        return out if isinstance(out, tuple) else tuple(out)

    def run(self, carry, n: int):
        for _ in range(int(n)):
            carry = self._step(carry)
        return carry

    def round_program(self, carry, num_rounds: int):
        """``(fn, full_args, n_dynamic)`` for the actor's rounds — the
        same callable :meth:`run` is, so a profiler of the program
        measures the plain run."""
        return (self.run, (carry, int(num_rounds)), 1)

    def _estimate(self, carry):
        return self.actor.estimate(carry[0], self.view)

    def run_streamed(self, carry, n: int, observe_every: int, emit):
        """Chunks of ``observe_every`` rounds between samples; each sample
        carries the keys the built-in kernels stream (``fired_total`` is
        not defined for a custom protocol: 0)."""
        mean = float(np.mean(self.topology.values))
        done = 0
        while done < n:
            take = min(int(observe_every), n - done)
            carry = self.run(carry, take)
            done += take
            est = self._estimate(carry)
            err = est - mean
            stats = torch.stack([
                torch.sqrt(torch.mean(err * err)),
                torch.max(torch.abs(err)), torch.sum(est)]).cpu().numpy()
            emit({
                "t": done,
                "rmse": float(stats[0]),
                "max_abs_err": float(stats[1]),
                "mass": float(stats[2]),
                "fired_total": 0,
            })
        return carry

    def estimates(self, carry):
        return self._estimate(carry).cpu().numpy()

    def last_avg(self, carry):
        return self.estimates(carry)


def push_sum_actor() -> VectorActor:
    """Deterministic Push-Sum (Kempe et al. 2003) as the canonical
    :class:`VectorActor`.  Each node keeps ``(s, w)``; every round it
    splits both equally over ``{self} ∪ out-neighbors``; ``s / w``
    converges to the mean.  Mass-conserving, so it exercises
    outbox->inbox delivery and the dst-segmented sum end to end."""

    def init(values, view: TopoView):
        z = torch.zeros((view.num_edges,), dtype=values.dtype,
                        device=values.device)
        return ({"s": values, "w": torch.ones_like(values)},
                {"s": z, "w": z})

    def round_(state, inbox, view: TopoView):
        # this round's totals: retained share + everything heard
        s = state["s"] + view.sum_to_dst(inbox["s"])
        w = state["w"] + view.sum_to_dst(inbox["w"])
        # split over {self} ∪ out-neighbors: keep one share, send one per
        # out-edge (the retained share is next round's state)
        share = 1.0 / (view.degree.to(torch.float32) + 1.0)
        return ({"s": s * share, "w": w * share},
                {"s": view.send(s * share), "w": view.send(w * share)})

    def estimate(state, view: TopoView):  # noqa: ARG001  # VectorActor protocol signature
        return state["s"] / state["w"]

    return VectorActor(init=init, round=round_, estimate=estimate,
                       name="push-sum")
