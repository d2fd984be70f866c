"""Aggregate algebra over the query fabric (counterpart of
``flow_updating_tpu/aggregates``): sum/count, min/max consensus,
ε-quantiles and windowed means on one set of service tensors."""

from flow_updating_tpu_torch.aggregates.fabric import AggregateFabric
from flow_updating_tpu_torch.aggregates.registry import (
    KINDS,
    MODE_MAX,
    MODE_MEAN,
    MODE_MIN,
    AggregatePlan,
    AggregateSpec,
    get_kind,
    register,
)
from flow_updating_tpu_torch.aggregates.scenarios import (
    AGG_SCENARIOS,
    AggScenario,
    aggregate_scenario_manifest,
    run_aggregate_scenario,
    run_aggregate_scenarios,
)

__all__ = [
    "AGG_SCENARIOS", "AggScenario", "AggregateFabric", "AggregatePlan",
    "AggregateSpec", "KINDS", "MODE_MAX", "MODE_MEAN", "MODE_MIN",
    "aggregate_scenario_manifest", "get_kind", "register",
    "run_aggregate_scenario", "run_aggregate_scenarios",
]
