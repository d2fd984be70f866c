"""Scenario execution: sweep-engine grids plus representative blame runs.

Counterpart of ``flow_updating_tpu/scenarios/run.py``.  One scenario runs
as two artifacts, both bound into its manifest record:

* a **seed grid under the sweep engine** — every seed a
  :class:`~flow_updating_tpu_torch.sweep.pack.SweepInstance` carrying the
  scenario's adversary (its masks laid out per lane), with per-lane
  telemetry series kept for the signature's series clauses;
* a **representative field run** (the first seed) through
  ``Engine(adversary=...)``: per-node and per-edge field rows reduced to
  the ``inspect`` blame bundle the signature's blame clauses judge
  (planted culprit at rank 1).

``perturb`` re-runs a scenario with its fault withdrawn
(``'remove_adversary'``) or its healing disabled (``'no_heal'``): the
negative control, under which every registered signature must fail.
"""

from __future__ import annotations

import dataclasses
import time

from flow_updating_tpu_torch.scenarios.registry import (
    REGISTRY,
    Scenario,
    get_scenario,
)

__all__ = ["perturbed_adversary", "run_scenario", "run_scenarios",
           "scenario_manifest"]

#: Field selection of the representative blame run: everything the blame
#: symptoms consume (stall and liar read node rows; leak, cut and pinned
#: the edge ledgers).
BLAME_FIELDS = "node_err,node_mass,edge_flow,edge_est"


def perturbed_adversary(scn: Scenario, adversary, perturb: str | None):
    """The adversary actually planted for this run: ``None`` keeps the
    registered fault, ``'remove_adversary'`` withdraws it, ``'no_heal'``
    pushes the down window past the end of the run."""
    if perturb is None:
        return adversary
    if perturb == "remove_adversary":
        return None
    if perturb == "no_heal":
        if adversary is None or not adversary.down_edges:
            raise ValueError(
                f"scenario {scn.name!r} schedules no link-down window; "
                "'no_heal' only perturbs partition scenarios")
        return dataclasses.replace(adversary,
                                   down_until=int(scn.rounds) + 1)
    raise ValueError(
        f"unknown perturbation {perturb!r} (use 'remove_adversary' or "
        "'no_heal')")


def run_scenario(scn: Scenario, seeds=(0, 1), *, perturb: str | None = None,
                 max_batch: int | None = None, device=None) -> dict:
    """Execute one scenario on ``device`` (the card unless ``'cpu'`` is
    given); returns its manifest record: the registered declaration, the
    planted ground truth, one sweep instance record per seed (with its
    ``rmse``/``mass_residual`` series), the sweep summary and the
    representative run's field block and blame bundle."""
    from flow_updating_tpu_torch.obs.report import topology_summary
    from flow_updating_tpu_torch.sweep import run_sweep
    from flow_updating_tpu_torch.sweep.pack import SweepInstance

    seeds = [int(s) for s in seeds]
    if not seeds:
        raise ValueError("run_scenario needs at least one seed")
    cfg = scn.round_config()
    cases = {s: scn.build(s) for s in seeds}
    instances = []
    for s in seeds:
        adv = perturbed_adversary(scn, cases[s].adversary, perturb)
        instances.append(SweepInstance(
            topo=cases[s].topo, seed=s, adversary=adv if adv else None,
            tag={"scenario": scn.name, "seed": s}))
    records, summary = run_sweep(
        instances, cfg, scn.rounds, rmse_threshold=scn.rmse_threshold,
        include_series=True, max_batch=max_batch, device=device)

    rep = cases[seeds[0]]
    rep_adv = perturbed_adversary(scn, rep.adversary, perturb)
    fields, blame = _representative_blame(scn, rep, rep_adv, cfg,
                                          seed=seeds[0], device=device)
    record = scn.describe()
    record.update({
        "ground_truth": dict(rep.ground_truth),
        "perturb": perturb,
        "topology": topology_summary(rep.topo),
        "representative_seed": seeds[0],
        "instances": records,
        "sweep_summary": summary,
        "blame": blame,
    })
    if fields is not None:
        record["fields"] = fields.to_jsonable()
    return record


def _representative_blame(scn: Scenario, case, adversary, cfg, *,
                          seed: int, device=None):
    """Field-record the first seed through the engine and reduce it to the
    blame bundle (the planted partition handed through, so partition
    blame never re-derives the blocks)."""
    from flow_updating_tpu_torch.engine import Engine
    from flow_updating_tpu_torch.obs import inspect as _inspect
    from flow_updating_tpu_torch.obs.fields import FieldSpec

    engine = Engine(config=cfg, adversary=adversary, device=device)
    engine.set_topology(case.topo)
    engine.build(seed=seed)
    series = engine.run_fields(scn.rounds, FieldSpec.parse(BLAME_FIELDS))
    gt = case.ground_truth
    bundle = _inspect.blame(
        series, threshold=scn.rmse_threshold,
        membership=gt.get("membership"),
        bridge_edges=gt.get("bridge_edges"))
    return series, bundle


def run_scenarios(names=None, seeds=(0, 1), *,
                  perturb: str | None = None,
                  max_batch: int | None = None, device=None):
    """Run a set of registered scenarios (default: all, in registration
    order) on ``device``.  Returns ``(records, summary)`` for
    :func:`scenario_manifest`; ``summary['sweep_compiles']`` sums the
    scenarios' distinct bucket structures (JAX's compile count)."""
    names = list(names) if names else list(REGISTRY)
    scns = [get_scenario(n) for n in names]
    t0 = time.perf_counter()
    records = []
    compiled = 0
    for scn in scns:
        rec = run_scenario(scn, seeds, perturb=perturb,
                           max_batch=max_batch, device=device)
        compiled += int(rec["sweep_summary"]["compiled_programs"])
        records.append(rec)
    summary = {
        "scenarios": names,
        "seeds": [int(s) for s in seeds],
        "perturb": perturb,
        "sweep_compiles": compiled,
        "wall_s": round(time.perf_counter() - t0, 6),
    }
    return records, summary


def scenario_manifest(records, summary, *, argv=None, device=None) -> dict:
    """The ``flow-updating-scenario-report/v1`` manifest of a
    :func:`run_scenarios` result."""
    from flow_updating_tpu_torch.obs.report import build_scenario_manifest

    return build_scenario_manifest(argv=argv, scenarios=records,
                                   summary=summary, device=device)
