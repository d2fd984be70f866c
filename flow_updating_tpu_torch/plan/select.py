"""Execution-mode selection: the halo kernel's exchange (``halo='auto'``).

Counterpart of ``select_halo_mode`` in ``flow_updating_tpu/plan/select.py``
(with its constants ``HALO_LATENCY_BYTES`` and ``OVERLAP_HIDE_RATIO``).  A
byte ranking over the plan's own cut-edge counts
(``ShardPlan.collective_bytes_per_round``); nothing in it was timed on
any device.  A cost model measured on the H100 belongs to ``plan='auto'``
(ROADMAP A5).
"""

from __future__ import annotations

#: per-collective launch overhead charged in wire-byte equivalents when
#: ranking the exchange modes — what keeps the one-collective allgather
#: competitive when the cut is tiny but the offsets are many
HALO_LATENCY_BYTES = 8192.0

#: interior-to-cut work ratio at which the overlap schedule fully hides
#: the wire (intra / cut >= the ratio: the exchange ends inside the
#: interior pass)
OVERLAP_HIDE_RATIO = 4.0


def _backend_name(backend: str | None) -> str:
    if backend:
        return backend
    import torch

    return "cuda" if torch.cuda.is_available() else "cpu"


def select_halo_mode(plan, *, backend: str | None = None,
                     dtype_bytes: int = 4) -> dict:
    """Rank the halo kernel's exchange modes for a built
    :class:`~flow_updating_tpu_torch.parallel.sharded.ShardPlan`: each
    mode pays its wire bytes plus a per-collective overhead, and the
    overlap schedule is credited with the share of the wire the interior
    can hide (saturating once the intra-shard edges exceed
    :data:`OVERLAP_HIDE_RATIO` times the cut).  Ties go to the simpler
    serialized mode.  Returns the chosen ``halo`` with its evidence;
    ``backend`` (default: ``cuda`` when a card is visible, else ``cpu``)
    is recorded, not used — ``Engine(halo='auto')`` passes its device."""
    backend = _backend_name(backend)
    rep = plan.collective_bytes_per_round(dtype_bytes)
    cut = rep["cut_edges"]
    intra = plan.topo.num_edges - cut
    n_off = max(rep["num_offsets"], 1)
    if cut == 0:
        return {"halo": "ppermute", "backend": backend,
                "cut_edges": 0, "intra_edges": intra,
                "predicted_effective_bytes": {},
                "reason": "no cut edges: nothing on the wire, the "
                          "point-to-point path compiles to no collective"}
    hide = float(min(1.0, intra / (cut * OVERLAP_HIDE_RATIO)))
    predicted = {
        "allgather": rep["allgather_bytes"] + 3 * HALO_LATENCY_BYTES,
        "ppermute": rep["ppermute_bytes"] + n_off * HALO_LATENCY_BYTES,
        "overlap": (rep["ppermute_bytes"] * (1.0 - hide)
                    + n_off * HALO_LATENCY_BYTES),
    }
    order = ("allgather", "ppermute", "overlap")
    best = min(order, key=lambda k: predicted[k])
    return {
        "halo": best,
        "backend": backend,
        "cut_edges": cut,
        "intra_edges": intra,
        "hide_fraction": round(hide, 3),
        "predicted_effective_bytes": {k: round(v, 1)
                                      for k, v in predicted.items()},
        "reason": (f"{best} cheapest: cut={cut} edge payloads "
                   f"({rep['ppermute_bytes']} B point-to-point, "
                   f"{rep['allgather_bytes']} B broadcast) over "
                   f"{n_off} offset(s); interior {intra} edges hides "
                   f"{100 * hide:.0f}% of the wire under overlap"),
    }
