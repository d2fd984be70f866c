"""Derived aggregates on the mean kernel: COUNT, SUM, MIN, MAX, weighted mean.

Counterpart of ``flow_updating_tpu/models/aggregates.py``.  The reference
estimates only the average; the Flow-Updating literature
(Jesus/Baquero/Almeida) derives the other classical gossip aggregates
from it, and they fall out of the kernels for free because those take
arbitrary per-node inputs:

* **count** (network size): one designated root contributes 1, everyone
  else 0; the converged mean is ``1/N``, so ``N = 1/mean``;
* **sum**: ``sum = mean * N`` — one value run and one indicator run;
* **min / max**: extrema propagation — each round every node keeps the
  extremum of itself and its neighbors.  Exact after (eccentricity)
  rounds, not an estimate; the loop stops at the first round that
  changes nothing (one host read of a flag a round), bounded by N rounds;
* **weighted mean**: Σ(w·x)/Σw as the ratio of two mean runs (over w·x
  and over w).

The mean runs dispatch as the Engine does (``cfg.kernel``: the node
round, whose ``spmv='pallas'`` is kernel K1 on the card, or the edge
round with every layout its config opts into), on ``device`` (the card
unless ``'cpu'`` is given).  Run enough rounds for the topology's mixing
time.
"""

from __future__ import annotations

import numpy as np
import torch

from flow_updating_tpu_torch.models.config import RoundConfig
from flow_updating_tpu_torch.utils.device import resolve_device


def _mean_estimates(topo, cfg: RoundConfig, rounds: int,
                    device=None) -> np.ndarray:
    # dispatch and array-building mirror the Engine's (_prepare_arrays):
    # kernel selection is cfg.kernel, and the edge kernel's arrays carry
    # every layout the config opted into
    device = resolve_device(device)
    if cfg.kernel == "node":
        from flow_updating_tpu_torch.models.sync import NodeKernel

        k = NodeKernel(topo, cfg, device=device)
        return k.estimates(k.run(k.init_state(), rounds))
    from flow_updating_tpu_torch.models.rounds import (
        node_estimates,
        run_rounds,
    )
    from flow_updating_tpu_torch.models.state import init_state

    arrays = topo.device_arrays(
        coloring=cfg.needs_coloring,
        segment_ell=cfg.use_segment_ell,
        segment_benes=cfg.segment_benes_mode,
        delivery_benes=cfg.delivery_benes_mode,
        device=device,
    )
    out = run_rounds(init_state(topo, cfg, device=device), arrays, cfg,
                     rounds)
    return node_estimates(out, arrays).cpu().numpy()


def estimate_count(topo, cfg: RoundConfig | None = None,
                   rounds: int = 1000, root: int = 0,
                   device=None) -> np.ndarray:
    """Per-node estimates of the network size N (root-indicator mean)."""
    cfg = cfg or RoundConfig.fast(variant="collectall", kernel="node")
    ind = np.zeros(topo.num_nodes)
    ind[int(root)] = 1.0
    mean = _mean_estimates(topo.with_values(ind), cfg, rounds, device)
    # mean -> 1/N; guard the not-yet-mixed zeros far from the root
    return np.where(mean > 0, 1.0 / np.maximum(mean, 1e-30), np.inf)


def estimate_sum(topo, cfg: RoundConfig | None = None,
                 rounds: int = 1000, root: int = 0,
                 device=None) -> np.ndarray:
    """Per-node estimates of the global sum (mean x estimated N)."""
    cfg = cfg or RoundConfig.fast(variant="collectall", kernel="node")
    mean = _mean_estimates(topo, cfg, rounds, device)
    return mean * estimate_count(topo, cfg, rounds, root, device)


def estimate_weighted_mean(topo, weights, cfg: RoundConfig | None = None,
                           rounds: int = 1000, device=None) -> np.ndarray:
    """Per-node estimates of Σ(w·x)/Σw — one mean run over w·x and one
    over w.  Weights must be non-negative with a positive sum."""
    cfg = cfg or RoundConfig.fast(variant="collectall", kernel="node")
    w = np.asarray(weights, np.float64)
    if w.shape != (topo.num_nodes,):
        raise ValueError(
            f"weights must have shape ({topo.num_nodes},), got {w.shape}")
    # (w >= 0).all() form: NaN fails the comparison, so non-finite
    # weights raise instead of silently producing an all-NaN result
    if not (w >= 0).all() or not np.isfinite(w).all() or not w.sum() > 0:
        raise ValueError("weights must be non-negative, finite, and have "
                         "a positive sum")
    num = _mean_estimates(topo.with_values(topo.values * w), cfg, rounds,
                          device)
    den = _mean_estimates(topo.with_values(w), cfg, rounds, device)
    # both denominators converge to mean(w) > 0; guard the not-yet-mixed
    # zeros far from heavy nodes the same way estimate_count does
    return np.where(den > 0, num / np.maximum(den, 1e-30), np.nan)


def _propagate_extremum(topo, mode: str, device=None) -> np.ndarray:
    """Exact extrema propagation to the fixed point (<= N rounds; stops at
    the first unchanged round, i.e. after eccentricity + 1 rounds).

    One round gathers each edge's value at its dst endpoint and reduces
    over the sorted src axis (CSR rows, ``torch.segment_reduce``; a min or
    max is exact in any order), so each node meets its neighbors' values;
    an isolated node's empty row reads the reduction's identity (+/-inf),
    which the combine ignores."""
    topo._require_edges(f"estimate_{mode} (extrema propagation)")
    device = resolve_device(device)
    x = torch.as_tensor(np.asarray(topo.values)).to(device)
    dst = torch.as_tensor(np.asarray(topo.dst, np.int64)).to(device)
    lengths = torch.as_tensor(np.asarray(topo.out_deg, np.int64)).to(device)
    comb = torch.minimum if mode == "min" else torch.maximum
    ident = torch.inf if mode == "min" else -torch.inf
    for _ in range(int(topo.num_nodes)):
        nb = torch.segment_reduce(x[dst], mode, lengths=lengths,
                                  unsafe=True, initial=ident)
        xn = comb(x, nb)
        changed = bool((xn != x).any())
        x = xn
        if not changed:
            break
    return x.cpu().numpy()


def estimate_min(topo, device=None) -> np.ndarray:
    """Per-node global minimum — exact once propagation reaches the fixed
    point (per connected component)."""
    return _propagate_extremum(topo, "min", device)


def estimate_max(topo, device=None) -> np.ndarray:
    """Per-node global maximum — exact once propagation reaches the fixed
    point (per connected component)."""
    return _propagate_extremum(topo, "max", device)
