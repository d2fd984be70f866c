"""Device-side fault and adversary specs for the scenario registry.

Counterpart of ``flow_updating_tpu/scenarios/adversary.py``.  An
:class:`Adversary` is a host-side plan of which nodes lie, which edges
corrupt their wire flow, which senders drop silently and which link set
suffers a scheduled correlated failure.  It lowers to the ``adv_*``
tensors of :class:`~flow_updating_tpu_torch.topology.graph.EdgeArrays`
(:meth:`Adversary.device_leaves`), where the edge round injects the faults
on the wire (``models/rounds.py``: ``fire_core``, ``send_messages``); the
honest per-edge ledgers are never touched.

Absence is the default: every family is ``None`` until planted, and the
round runs none of an absent family's operations, so an adversary-free
run is today's run.  A sweep bucket holds only lanes whose
:meth:`Adversary.structure_key` agree (the families present), since the
bucket's round runs one set of operations for all its lanes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["Adversary"]


def _ids(x) -> tuple:
    return tuple(int(i) for i in np.atleast_1d(np.asarray(x, np.int64)))


@dataclasses.dataclass(frozen=True)
class Adversary:
    """One scenario's planted faults, by original node/edge id.

    * ``lie_nodes`` / ``lie_value`` — every message a lying node sends
      reports ``lie_value`` as its estimate.
    * ``corrupt_edges`` / ``corrupt_gain`` — the wire copy of the flow
      ledger is scaled by ``corrupt_gain`` on these directed edges.
    * ``silent_nodes`` — every send from these nodes is lost on the wire
      while the sender's ledger updates regardless.
    * ``down_edges`` / ``down_from`` / ``down_until`` — the edges lose every
      send during rounds ``[down_from, down_until)``.
    """

    lie_nodes: tuple = ()
    lie_value: float = 0.0
    corrupt_edges: tuple = ()
    corrupt_gain: float = 1.0
    silent_nodes: tuple = ()
    down_edges: tuple = ()
    down_from: int = 0
    down_until: int = 0

    def __post_init__(self):
        object.__setattr__(self, "lie_nodes", _ids(self.lie_nodes))
        object.__setattr__(self, "corrupt_edges", _ids(self.corrupt_edges))
        object.__setattr__(self, "silent_nodes", _ids(self.silent_nodes))
        object.__setattr__(self, "down_edges", _ids(self.down_edges))
        if self.down_edges and not self.down_until > self.down_from >= 0:
            raise ValueError(
                f"down window [{self.down_from}, {self.down_until}) is "
                "empty; schedule at least one dead round (or drop the "
                "down_edges)")

    def __bool__(self) -> bool:
        return bool(self.lie_nodes or self.corrupt_edges
                    or self.silent_nodes or self.down_edges)

    def structure_key(self) -> tuple:
        """Which families are present: lanes may share a sweep bucket iff
        their keys agree."""
        return (bool(self.lie_nodes), bool(self.corrupt_edges),
                bool(self.silent_nodes), bool(self.down_edges))

    def device_leaves(self, n_pad: int, e_pad: int, dtype,
                      device=None) -> dict:
        """The ``EdgeArrays.replace`` keywords: masks over ``n_pad`` nodes
        and ``e_pad`` edges (ghost slots never lie, corrupt or drop), values
        as 0-d tensors (the lie and the gain of ``dtype``, the window
        int32), on ``device`` (the card unless ``'cpu'`` is given).  Only
        present families emit leaves."""
        from flow_updating_tpu_torch.utils.device import resolve_device

        dev = resolve_device(device)

        def mask(ids, size):
            m = np.zeros(size, bool)
            ids = np.asarray(ids, np.int64)
            if ids.size and (ids.min() < 0 or ids.max() >= size):
                raise ValueError(
                    f"adversary id(s) {ids[(ids < 0) | (ids >= size)]} "
                    f"outside [0, {size})")
            m[ids] = True
            return torch.from_numpy(m).to(dev)

        def scalar(v, dt):
            return torch.tensor(v, dtype=dt, device=dev)

        out: dict = {}
        if self.lie_nodes:
            out["adv_lie_mask"] = mask(self.lie_nodes, n_pad)
            out["adv_lie_value"] = scalar(self.lie_value, dtype)
        if self.corrupt_edges:
            out["adv_corrupt_mask"] = mask(self.corrupt_edges, e_pad)
            out["adv_corrupt_gain"] = scalar(self.corrupt_gain, dtype)
        if self.silent_nodes:
            out["adv_silent_mask"] = mask(self.silent_nodes, n_pad)
        if self.down_edges:
            out["adv_down_mask"] = mask(self.down_edges, e_pad)
            out["adv_down_from"] = scalar(self.down_from, torch.int32)
            out["adv_down_until"] = scalar(self.down_until, torch.int32)
        return out

    def describe(self) -> dict:
        """Manifest-grade ground truth: the planted culprits a conformance
        check verifies blame against."""
        out: dict = {}
        if self.lie_nodes:
            out["lie"] = {"nodes": list(self.lie_nodes),
                          "value": float(self.lie_value)}
        if self.corrupt_edges:
            out["corrupt"] = {"edges": list(self.corrupt_edges),
                              "gain": float(self.corrupt_gain)}
        if self.silent_nodes:
            out["silent"] = {"nodes": list(self.silent_nodes)}
        if self.down_edges:
            out["down"] = {"edges": list(self.down_edges),
                           "from": int(self.down_from),
                           "until": int(self.down_until)}
        return out
