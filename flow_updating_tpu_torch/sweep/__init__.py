"""Sweep engine: many (topology, seed, params) instances per bucket.

Counterpart of ``flow_updating_tpu/sweep``.  The reference paper's
evaluation is a grid — topologies x loss rates x timeouts — and one small
instance at a time leaves the card idle.  This package packs B instances
into one bucket and advances them together:

* :mod:`~flow_updating_tpu_torch.sweep.pack` — shape-bucketed padding
  (mass-neutral ghost nodes, failed self-loop pad edges) and the bucket
  layout: the lanes end to end as one disjoint graph, traced
  :class:`~flow_updating_tpu_torch.models.config.RoundParams` per lane;
* :mod:`~flow_updating_tpu_torch.sweep.batch` — the bucket's rounds, per-lane
  telemetry and convergence on the device;
* :mod:`~flow_updating_tpu_torch.sweep.runner` — grid fan-out, buckets and
  one record per instance for the ``flow-updating-sweep-report/v1``
  manifest (``sweep`` subcommand).
"""

from flow_updating_tpu_torch.sweep.batch import (
    run_bucket,
    run_bucket_telemetry,
)
from flow_updating_tpu_torch.sweep.pack import (
    SweepBucket,
    SweepInstance,
    bucket_shape,
    pack_instances,
    pad_topology_to,
)
from flow_updating_tpu_torch.sweep.runner import grid_instances, run_sweep

__all__ = [
    "SweepBucket",
    "SweepInstance",
    "bucket_shape",
    "pack_instances",
    "pad_topology_to",
    "run_bucket",
    "run_bucket_telemetry",
    "grid_instances",
    "run_sweep",
]
