"""Sweep driving: grid fan-out, bucket orchestration, manifest records.

Counterpart of ``flow_updating_tpu/sweep/runner.py``.  A sweep is a cross
product — topologies x seeds x parameter values — packed into buckets
(:mod:`~flow_updating_tpu_torch.sweep.pack`), run bucket by bucket
(:mod:`~flow_updating_tpu_torch.sweep.batch`) and reduced to one record
per instance, in the JAX package's keys, for the
``flow-updating-sweep-report/v1`` manifest.
"""

from __future__ import annotations

import time

import numpy as np

from flow_updating_tpu_torch.models.config import RoundConfig
from flow_updating_tpu_torch.sweep.batch import run_bucket_telemetry
from flow_updating_tpu_torch.sweep.pack import SweepInstance, pack_instances

#: the adversary families, in the order the compile key lists them
_ADV_LEAVES = ("adv_lie_mask", "adv_corrupt_mask", "adv_silent_mask",
               "adv_down_mask")


def grid_instances(topos, seeds=(0,), drop_rates=(None,),
                   timeouts=(None,), latency_scales=(None,)) -> list:
    """Fan a parameter grid out to :class:`SweepInstance`\\ s.  ``topos`` is
    a list of ``(name, Topology)`` pairs (the name lands in each instance's
    tag); the other axes cross-multiply, ``None`` inheriting the config's
    knob."""
    instances = []
    for name, topo in topos:
        for seed in seeds:
            for dr in drop_rates:
                for to in timeouts:
                    for ls in latency_scales:
                        tag = {"topology": str(name), "seed": int(seed)}
                        if dr is not None:
                            tag["drop_rate"] = float(dr)
                        if to is not None:
                            tag["timeout"] = int(to)
                        if ls is not None:
                            tag["latency_scale"] = float(ls)
                        instances.append(SweepInstance(
                            topo=topo, seed=int(seed), drop_rate=dr,
                            timeout=to, latency_scale=ls, tag=tag))
    return instances


def _worst_offenders(states, bucket, top: int = 3) -> list:
    """Per lane, the ``top`` largest final per-node absolute errors,
    alive-masked (dead ghosts never rank)."""
    from flow_updating_tpu_torch.models.rounds import node_estimates

    B = bucket.size
    est = node_estimates(states, bucket.arrays).cpu().numpy()
    est = est.reshape((B, -1) + est.shape[1:])
    means = bucket.means.cpu().numpy()
    m = (means.reshape((-1,) + (1,) * (est.ndim - 1))
         if means.ndim == 1 else means[:, None])   # (B, 1[, D])
    err = np.abs(est - m)
    if err.ndim > 2:
        err = err.max(axis=tuple(range(2, err.ndim)))
    alive = states.alive.cpu().numpy().reshape(B, -1)
    err = np.where(alive, err, -np.inf)
    out = []
    for lane in range(B):
        order = np.argsort(-err[lane])[:top]
        out.append([
            {"node": int(i), "abs_err": float(err[lane, i])}
            for i in order if np.isfinite(err[lane, i])
        ])
    return out


def _structure_key(bucket) -> tuple:
    """What sets a bucket's round apart from another's: its lanes, node
    slots and row width, the payload shape, whether the loss draw runs,
    and the adversary families present (JAX's compile key)."""
    rows = bucket.arrays.sweep_edge_rows
    return ((bucket.size, bucket.shape[0], int(rows.shape[1])),
            tuple(bucket.means.shape),
            bucket.params.drop_rate is None,
            tuple(getattr(bucket.arrays, leaf) is not None
                  for leaf in _ADV_LEAVES))


def run_sweep(instances, cfg: RoundConfig, rounds: int, spec=None,
              rmse_threshold: float = 1e-6, max_batch: int | None = None,
              include_series: bool = False, profile: bool = False,
              device=None):
    """Pack ``instances``, run every bucket on ``device`` (the card unless
    ``'cpu'`` is given), reduce to per-instance records.

    Returns ``(records, summary)``: ``records`` is one dict per instance
    (input order) — topology fingerprint, seed, params, convergence (the
    early-exit round, final and least rmse), the worst nodes and, when
    ``include_series``, the per-round series; ``summary`` the sweep-level
    aggregates.  ``summary['compiled_programs']`` counts the distinct
    bucket structures by the JAX package's compile key (JAX compiles one
    program per structure; nothing is compiled here).

    ``profile=True`` counts each bucket's rounds once more through the
    cost attribution (:mod:`~flow_updating_tpu_torch.obs.profile`, from a
    copy of the bucket's states, no timed run) and attaches flops, bytes,
    the kernels' declared work and memory per bucket to
    ``summary['buckets']``; the execution time comes from the real run
    (``run_s`` per bucket)."""
    from flow_updating_tpu_torch.obs.telemetry import TelemetrySpec

    instances = list(instances)
    spec = TelemetrySpec.default() if spec is None else spec
    spec = spec.for_kernel("edge")
    if not spec.has("rmse"):
        raise ValueError(
            "sweep telemetry needs 'rmse' for convergence tracking "
            "(the 'default' spec includes it)")
    t0 = time.perf_counter()
    buckets = pack_instances(instances, cfg, max_batch=max_batch,
                             device=device)
    pack_s = time.perf_counter() - t0

    bucket_profiles: list = []
    if profile:
        from flow_updating_tpu_torch.obs.profile import (
            per_round,
            profile_program,
        )
        from flow_updating_tpu_torch.sweep.batch import bucket_program

        for bucket in buckets:
            fn, args, nd = bucket_program(bucket, cfg, rounds, spec,
                                          rmse_threshold=rmse_threshold)
            rec = profile_program(fn, args, n_dynamic=nd, execute=False,
                                  label=f"bucket{tuple(bucket.shape)}",
                                  rounds=rounds)
            rec["per_round"] = per_round(rec, rounds)
            bucket_profiles.append(rec)

    records: list = [None] * len(instances)
    converged = 0
    bucket_run_s: list = []
    t0 = time.perf_counter()
    for bucket in buckets:
        tb0 = time.perf_counter()
        states, conv, series = run_bucket_telemetry(
            bucket, cfg, rounds, spec, rmse_threshold=rmse_threshold)
        bucket_run_s.append(round(time.perf_counter() - tb0, 6))
        worst = _worst_offenders(states, bucket)
        for lane, meta in enumerate(bucket.meta):
            rmse_series = series["rmse"][lane]
            rec = dict(meta)
            rec["convergence"] = {
                "rounds": int(rounds),
                "converged_round": int(conv[lane]),
                "converged": bool(conv[lane] >= 0),
                "rmse_threshold": float(rmse_threshold),
                "final_rmse": float(rmse_series[-1]) if rounds else None,
                "min_rmse": float(rmse_series.min()) if rounds else None,
            }
            rec["worst_nodes"] = worst[lane]
            if conv[lane] >= 0:
                converged += 1
            if include_series:
                rec["series"] = {k: np.asarray(v[lane]).tolist()
                                 for k, v in series.items()}
            records[meta["instance"]] = rec
    run_s = time.perf_counter() - t0

    summary = {
        "instances": len(records),
        "buckets": [{"shape": list(map(int, b.shape)), "size": b.size,
                     "run_s": bucket_run_s[i],
                     **({"profile": bucket_profiles[i]}
                        if bucket_profiles else {})}
                    for i, b in enumerate(buckets)],
        "compiled_programs": len({_structure_key(b) for b in buckets}),
        "rounds": int(rounds),
        "converged": converged,
        "timings": {"pack_s": round(pack_s, 6), "run_s": round(run_s, 6)},
    }
    return records, summary
