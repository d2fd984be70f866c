"""Bucket execution: B instances per round, one set of launches.

Counterpart of ``flow_updating_tpu/sweep/batch.py``.  A bucket's lanes lie
end to end as one disjoint graph (``sweep/pack.py``), so the edge round
(:func:`~flow_updating_tpu_torch.models.rounds.round_step_aux`) advances
every lane with the launches of one round, whatever B is, with each
lane's traced :class:`~flow_updating_tpu_torch.models.config.RoundParams`
read per node or per edge.  Per-lane telemetry reduces ``(B, N_pad)`` and
``(B, E_pad)`` views of the round's tensors.

Convergence is tracked per lane on the device: a lane whose alive-masked
RMSE first reaches ``rmse_threshold`` records that round in a ``(B,)``
int32 tensor (``torch.where``, no host read) and keeps running with the
others; the ``(R, B)`` series and the rounds go to the host once, at the
end.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from flow_updating_tpu_torch.models.rounds import (
    node_estimates,
    round_step,
    round_step_aux,
)
from flow_updating_tpu_torch.models.state import _ex


def run_bucket(bucket, cfg, num_rounds: int):
    """Advance every lane of ``bucket`` by ``num_rounds`` rounds; returns
    the bucket's final state (lane by lane: ``models.state.lane_state``)."""
    states = bucket.states
    for _ in range(int(num_rounds)):
        states = round_step(states, bucket.arrays, cfg, bucket.params)
    return states


def _lanes(x: torch.Tensor, B: int) -> torch.Tensor:
    """``(B * n, ...)`` -> ``(B, n, ...)``."""
    return x.reshape((B, -1) + tuple(x.shape[1:]))


def _over_lane(x: torch.Tensor, op) -> torch.Tensor:
    """Reduce every axis of a ``(B, ...)`` tensor but the lane axis."""
    return op(x, dim=tuple(range(1, x.dim())))


def lane_sample(state, arrays, spec, means, processed, send_mask) -> dict:
    """One round's per-lane metric row: each metric of
    ``models.rounds.telemetry_sample`` as a ``(B,)`` (or ``(B, D)``) tensor,
    alive-masked per lane, on the device (no host read)."""
    B = arrays.lanes
    out = {"t": state.t.expand(B)}
    alive = _lanes(state.alive, B)
    need_est = any(spec.has(m) for m in
                   ("rmse", "max_abs_err", "mass", "mass_residual"))
    if need_est:
        est = _lanes(node_estimates(state, arrays), B)
        a_ex = _ex(alive, est)
        if spec.has("rmse") or spec.has("max_abs_err"):
            mean = means.reshape((B, 1) + tuple(est.shape[2:]))
            err = torch.where(a_ex, est - mean, 0.0)
            if spec.has("rmse"):
                feats = int(np.prod(est.shape[2:], dtype=np.int64))
                cnt = (torch.clamp(alive.sum(1), min=1) * feats).to(
                    est.dtype)
                out["rmse"] = torch.sqrt(_over_lane(err * err, torch.sum)
                                         / cnt)
            if spec.has("max_abs_err"):
                out["max_abs_err"] = _over_lane(err.abs(), torch.amax)
        if spec.has("mass") or spec.has("mass_residual"):
            mass = torch.where(a_ex, est, 0.0).sum(1)      # per feature
            if spec.has("mass"):
                out["mass"] = mass
            if spec.has("mass_residual"):
                value = _lanes(state.value, B)
                out["mass_residual"] = mass - torch.where(
                    _ex(alive, value), value, 0.0).sum(1)
    if spec.has("antisymmetry"):
        out["antisymmetry"] = _over_lane(
            _lanes((state.flow + state.flow[arrays.rev]).abs(), B),
            torch.amax)
    if spec.has("sent"):
        out["sent"] = _lanes(send_mask, B).sum(1, dtype=torch.int32)
    if spec.has("delivered"):
        out["delivered"] = _lanes(processed, B).sum(1, dtype=torch.int32)
    if spec.has("fired_total"):
        out["fired_total"] = _lanes(state.fired, B).sum(1,
                                                        dtype=torch.int64)
    if spec.has("active"):
        out["active"] = alive.sum(1, dtype=torch.int32)
    return out


def _run_bucket_states(states, bucket, cfg, num_rounds: int, spec,
                       rmse_threshold: float):
    return run_bucket_telemetry(dataclasses.replace(bucket, states=states),
                                cfg, num_rounds, spec, rmse_threshold)


def bucket_program(bucket, cfg, num_rounds: int, spec,
                   rmse_threshold: float = 0.0):
    """``(fn, full_args, n_dynamic)`` for the bucket's telemetry rounds —
    the cost-attribution hook (``sweep --profile`` attaches one record per
    bucket to the sweep manifest).  ``fn`` is :func:`run_bucket_telemetry`
    on the bucket with the given states, which the profiler copies."""
    return (_run_bucket_states,
            (bucket.states, bucket, cfg, int(num_rounds), spec,
             rmse_threshold), 1)


def run_bucket_telemetry(bucket, cfg, num_rounds: int, spec,
                         rmse_threshold: float = 0.0):
    """Run ``num_rounds`` rounds with per-round, per-lane telemetry.

    Returns ``(states, converged_round, series)``:

    * ``states`` — the bucket's final state (every lane ran the full
      ``num_rounds``; converged lanes keep running);
    * ``converged_round`` — ``(B,)`` int32 numpy, the round at which each
      lane's alive-masked RMSE first reached ``rmse_threshold``, or -1;
    * ``series`` — ``{metric: (B, R, ...) numpy}``, lane-major.

    ``spec`` must include ``rmse`` (convergence tracking reads it)."""
    from flow_updating_tpu_torch.obs.telemetry import SeriesRecorder

    if not spec.enabled or not spec.has("rmse"):
        raise ValueError(
            "run_bucket_telemetry needs a TelemetrySpec that includes "
            "'rmse' (convergence tracking reads the sampled rmse row)")
    states, arrays, params = bucket.states, bucket.arrays, bucket.params
    means = bucket.means
    thr = torch.tensor(rmse_threshold, dtype=means.dtype,
                       device=means.device)
    conv = torch.full((arrays.lanes,), -1, dtype=torch.int32,
                      device=means.device)
    rec = SeriesRecorder(num_rounds)
    for i in range(int(num_rounds)):
        states, processed, send_mask = round_step_aux(states, arrays, cfg,
                                                      params)
        row = lane_sample(states, arrays, spec, means, processed,
                          send_mask)
        conv = torch.where((conv < 0) & (row["rmse"] <= thr), states.t,
                           conv)
        rec.put(i, row)
    host = {k: np.swapaxes(v.cpu().numpy(), 0, 1)
            for k, v in rec.series().items()}
    return states, conv.cpu().numpy(), host
