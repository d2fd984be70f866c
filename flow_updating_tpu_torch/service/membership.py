"""Membership primitives shared by every churn surface.

Counterpart of ``flow_updating_tpu/service/membership.py``.  "Node churn"
means one thing: flipping the alive mask of a
:class:`~flow_updating_tpu_torch.models.state.FlowUpdatingState` — dead
nodes stop firing, sending and draining; their ledgers stay intact, so a
revived node re-joins with its flow state and the protocol self-heals
(the Flow-Updating paper's fault model).  The engine's
``kill_nodes``/``revive_nodes`` are this bare mask flip.
"""

from __future__ import annotations

import numpy as np
import torch


def as_id_array(ids) -> np.ndarray:
    """Normalize a node-id collection to a (k,) int32 numpy array."""
    arr = np.atleast_1d(np.asarray(ids, np.int32))
    if arr.ndim != 1:
        raise ValueError(f"node ids must be a flat sequence, got shape "
                         f"{arr.shape}")
    return arr


def set_alive(state, ids, alive: bool):
    """Flip the liveness mask of ``ids`` (ledgers untouched — the
    temporary-failure churn of the paper; see module docstring).  The
    new mask is a new tensor on the state's device; the state passed in
    is left as it was.  Ids are checked on the host (negative ids count
    from the end, as in numpy): an id outside the node range raises
    instead of reaching the card."""
    idx = as_id_array(ids).astype(np.int64)
    n = int(state.alive.shape[0])
    bad = (idx < -n) | (idx >= n)
    if bad.any():
        raise ValueError(f"node ids {idx[bad].tolist()} are outside "
                         f"[0, {n})")
    dev = state.alive.device
    mask = state.alive.index_put(
        (torch.from_numpy(idx % n).to(dev),),
        torch.tensor(bool(alive), device=dev))
    return state.replace(alive=mask)
