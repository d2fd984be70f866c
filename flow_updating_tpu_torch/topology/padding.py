"""Capacity padding: ghost nodes, self-loop pad edges, row layouts.

Counterpart of ``flow_updating_tpu/topology/padding.py`` (host numpy, the
same arrays).  A topology fills a fixed ``(n_pad, e_pad)`` capacity
without perturbing the protocol:

* **ghost nodes** are appended after the real nodes with value 0 and are
  born dead (``alive=False`` in the packed state, :func:`mask_ghost_state`):
  they never fire, never drain, and every alive-masked metric excludes
  them, so the instance's mean and mass are untouched;
* **pad edges** are self-loops on ghost nodes with ``edge_ok=False`` and
  ``rev`` mapped to themselves, appended after the real edges.  Edges
  sort by ``(src, dst)`` and every ghost id exceeds every real id, so the
  real edge arrays stay a bit-identical prefix of the padded arrays;
* a computed **edge coloring** is extended with color ``-1`` on the pad
  self-loops, which no round fires.

Two ghost placements serve two consumers: ``spread='even'`` (the sweep
engine's) spreads the pad self-loops evenly over all ghosts, capping every
row's degree and so the uniform row width W of the bucket's reduction
layout (:func:`edge_rows`); ``spread='last'`` (the streaming service's)
parks every pad self-loop on the last ghost, leaving the other ghosts as
clean zero-degree slots a ``join`` can claim.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from flow_updating_tpu_torch.topology.graph import Topology


def pow2_ceil(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length() if x > 1 else 1


def mask_ghost_state(state, n_real: int, e_real: int):
    """The packed state's ghost mask: nodes past ``n_real`` are born dead
    and edges past ``e_real`` are failed links, so the real prefix evolves
    exactly as the unpadded run."""
    alive = state.alive.clone()
    alive[n_real:] = False
    edge_ok = state.edge_ok.clone()
    edge_ok[e_real:] = False
    return state.replace(alive=alive, edge_ok=edge_ok)


def masked_values(values, n_rows: int, cohort=None) -> np.ndarray:
    """A ``(n_rows,) + F`` float64 array with ``values`` on ``cohort``'s
    slots and exactly ``0.0`` everywhere else (a slot outside the cohort
    contributes nothing to the aggregate, yet still relays).  ``cohort=None``
    writes ``values`` as the leading prefix (capacity padding)."""
    vals = np.asarray(values, np.float64)
    if cohort is None:
        if vals.shape[0] > n_rows:
            raise ValueError(
                f"masked_values: {vals.shape[0]} value rows exceed "
                f"{n_rows} slots")
        pad = np.zeros((n_rows - vals.shape[0],) + vals.shape[1:])
        return np.concatenate([vals, pad], axis=0)
    cohort = np.asarray(cohort, np.int64)
    if cohort.ndim != 1:
        raise ValueError(
            f"masked_values: cohort must be a 1-D id array "
            f"(got shape {cohort.shape})")
    if vals.shape[0] != cohort.shape[0]:
        raise ValueError(
            f"masked_values: {vals.shape[0]} value rows for "
            f"{cohort.shape[0]} cohort ids (need one row per id)")
    if cohort.size and (cohort.min() < 0 or cohort.max() >= n_rows):
        raise ValueError(
            f"masked_values: cohort ids must lie in [0, {n_rows}) "
            f"(got [{cohort.min()}, {cohort.max()}])")
    if np.unique(cohort).size != cohort.size:
        raise ValueError("masked_values: duplicate cohort ids")
    out = np.zeros((n_rows,) + vals.shape[1:])
    out[cohort] = vals
    return out


def bucket_ceil(x: int) -> int:
    """Round up to an eighth-power-of-two boundary: at most 12.5% pad
    waste per axis, at most 8 bucket sizes per octave."""
    g = max(pow2_ceil(x) // 8, 1)
    return ((int(x) + g - 1) // g) * g


def pad_topology_to(topo: Topology, n_pad: int, e_pad: int,
                    spread: str = "even") -> Topology:
    """Pad ``topo`` to exactly ``(n_pad, e_pad)`` with ghost nodes and
    self-loop pad edges placed per ``spread``.  The real arrays remain a
    prefix; ghost values are 0."""
    topo._require_edges("pad_topology_to (capacity packing)")
    if spread not in ("even", "last"):
        raise ValueError(f"unknown ghost-placement policy {spread!r} "
                         "(use 'even' or 'last')")
    N, E = topo.num_nodes, topo.num_edges
    if n_pad <= N:
        raise ValueError(
            f"n_pad={n_pad} must exceed the real node count {N} (at "
            "least one ghost node carries the pad edges)")
    if e_pad < E:
        raise ValueError(f"e_pad={e_pad} < real edge count {E}")
    pad_n = n_pad - N
    pad_e = e_pad - E
    if spread == "even":
        # ghost i in [N, n_pad) takes an even contiguous share of the pad
        # self-loops; (g, g) pairs sort by g, so the edge list stays
        # (src, dst)-sorted with the real edges as a prefix
        ghost_of = (N + (np.arange(pad_e, dtype=np.int64) * pad_n)
                    // max(pad_e, 1) % pad_n) if pad_e else \
            np.empty(0, np.int64)
        ghost_of = np.sort(ghost_of).astype(np.int32)
    else:
        ghost_of = np.full(pad_e, n_pad - 1, np.int32)

    src = np.concatenate([topo.src, ghost_of])
    dst = np.concatenate([topo.dst, ghost_of])
    # self-loops reverse to themselves: rev stays an involution
    rev = np.concatenate([topo.rev, np.arange(E, e_pad, dtype=np.int32)])
    ghost_deg = np.bincount(ghost_of - N, minlength=pad_n) \
        if pad_e else np.zeros(pad_n, np.int64)
    pad_rank = (np.arange(pad_e, dtype=np.int64)
                - np.concatenate([[0], np.cumsum(ghost_deg)])[
                    ghost_of - N]) if pad_e else np.empty(0, np.int64)
    edge_rank = np.concatenate(
        [topo.edge_rank, pad_rank.astype(np.int32)])
    delay = np.concatenate([topo.delay, np.ones(pad_e, np.int32)])
    out_deg = np.concatenate(
        [topo.out_deg, ghost_deg.astype(np.int32)])
    values = np.concatenate([topo.values, np.zeros(pad_n)])
    counts = np.bincount(src, minlength=n_pad)
    row_start = np.zeros(n_pad + 1, np.int64)
    np.cumsum(counts, out=row_start[1:])

    padded = dataclasses.replace(
        topo,
        num_nodes=n_pad,
        src=src,
        dst=dst,
        rev=rev,
        out_deg=out_deg,
        row_start=row_start,
        edge_rank=edge_rank,
        delay=delay,
        values=values,
        names=None,
        speeds=None,
        bandwidth=None,
        latency_s=None,
        adopted=None,
        # the link model does not batch (the packers refuse contention)
        edge_links=None,
        link_ser_rounds=None,
        link_shared=None,
        lat_rounds=None,
        # a structure descriptor indexes the unpadded node layout
        structure=None,
        # the planted-partition ground truth is sized to the unpadded
        # arrays; scenario and blame consumers read the original topology
        membership=None,
        bridge_edges=None,
    )
    cached = getattr(topo, "_edge_coloring", None)
    if cached is not None:
        col, c = cached
        col = np.concatenate([col, np.full(pad_e, -1, np.int32)])
        object.__setattr__(padded, "_edge_coloring", (col, c))
    return padded


def edge_rows(padded: Topology, width: int, e_pad: int) -> np.ndarray:
    """The ``(N_pad, W)`` out-edge index matrix of the row reduction layout
    (pad slot = ``e_pad``; see ``ops/segment.rows_segment_*``)."""
    lo = padded.row_start[:-1]
    deg = padded.out_deg.astype(np.int64)
    ar = np.arange(width, dtype=np.int64)
    valid = ar[None, :] < deg[:, None]
    return np.where(valid, lo[:, None] + ar[None, :], e_pad).astype(
        np.int32)


def row_width(topo: Topology, n_pad: int, e_pad: int) -> int:
    """The uniform row width this instance needs in an ``(n_pad, e_pad)``
    bucket under even ghost spreading: its real max degree, or the evenly
    spread ghost degree if that is larger."""
    pad_n = n_pad - topo.num_nodes
    pad_e = e_pad - topo.num_edges
    ghost_deg = -(-pad_e // pad_n) if pad_n and pad_e else 0
    real = int(topo.out_deg.max()) if topo.num_nodes else 0
    return max(real, ghost_deg, 1)

