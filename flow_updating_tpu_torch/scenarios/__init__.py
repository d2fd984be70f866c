"""Scenario conformance suite: adversarial and poorly-connected cases.

Counterpart of ``flow_updating_tpu/scenarios``.  A
:class:`~flow_updating_tpu_torch.scenarios.registry.Scenario` bundles a
deterministic hostile construction (conductance-bottleneck bridges,
Byzantine nodes injected on the message wire, correlated link failure),
a config (with the robust-aggregation fire modes) and a declared
signature that ``doctor`` asserts against the scenario's manifest, with
``inspect``'s blame required to name the planted adversary at rank 1.

Entry points: the ``scenarios`` subcommand and
:func:`~flow_updating_tpu_torch.scenarios.run.run_scenarios`.
"""

from flow_updating_tpu_torch.scenarios.adversary import Adversary
from flow_updating_tpu_torch.scenarios.registry import (
    REGISTRY,
    Scenario,
    ScenarioCase,
    get_scenario,
    scenario_names,
)
from flow_updating_tpu_torch.scenarios.run import (
    run_scenario,
    run_scenarios,
    scenario_manifest,
)

__all__ = [
    "Adversary", "REGISTRY", "Scenario", "ScenarioCase", "get_scenario",
    "run_scenario", "run_scenarios", "scenario_manifest",
    "scenario_names",
]
