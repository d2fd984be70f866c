"""Convergence and invariant metrics (node-kernel parts).

Counterpart of ``flow_updating_tpu/utils/metrics.py``.  With antisymmetric
flows the global sum of node estimates equals the sum of inputs (mass
conservation); in the fast synchronous mode every round ends with all
messages delivered, so the residual is exact up to rounding.
"""

from __future__ import annotations

import numpy as np


def rmse(estimates: np.ndarray, true_mean: float) -> float:
    """Root-mean-square error of the estimates against the true mean."""
    err = estimates - true_mean
    return float(np.sqrt(np.mean(err * err)))


def mass_residual(estimates: np.ndarray, values: np.ndarray) -> float:
    """sum(estimates) - sum(values): ~0 once every message of the round
    has been delivered, transiently nonzero otherwise."""
    return float(estimates.sum() - values.sum())


def observer_sample(t, rmse_v, max_abs_err, mass, fired_total) -> dict:
    """The streamed-observer emit record (all inputs host scalars)."""
    return {
        "t": int(t),
        "rmse": float(rmse_v),
        "max_abs_err": float(max_abs_err),
        "mass": float(mass),
        "fired_total": int(fired_total),
    }
