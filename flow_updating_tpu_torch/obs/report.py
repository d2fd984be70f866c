"""Run and plan manifests: one self-describing JSON artifact per run.

Counterpart of a subset of ``flow_updating_tpu/obs/report.py``: the
schema names, :func:`build_manifest` (``run --report``,
``flow-updating-run-report/v1``), :func:`build_plan_manifest` (``plan
--report``, ``flow-updating-plan-report/v1``), :func:`build_field_manifest`
(``inspect --report``, ``flow-updating-field-report/v1``),
:func:`build_sweep_manifest` (``sweep --report``,
``flow-updating-sweep-report/v1``), :func:`build_scenario_manifest`
(``scenarios --report``, ``flow-updating-scenario-report/v1``),
:func:`build_service_manifest` (``serve --report``,
``flow-updating-service-report/v1``), :func:`build_query_manifest`
(``query --report``, ``flow-updating-query-report/v1``),
:func:`build_recovery_manifest` (``flow-updating-recovery-report/v1``),
:func:`build_profile_manifest` (``profile --report``,
``flow-updating-profile-report/v1``) and :func:`write_report`.
A manifest binds the invocation (argv and the resolved config), the
topology (size and the checkpoint-grade content fingerprint), the
execution substrate (torch, CUDA, the device), the timings, the final
report and — when telemetry ran — the full per-round series (or, in a
field manifest, the per-node and per-edge fields and the global series
reduced from them), in the JAX package's keys, so its ``doctor`` and
``inspect`` judge the port's manifests.  The audit and budget builders
move with their ROADMAP item.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time

SCHEMA = "flow-updating-run-report/v1"
SWEEP_SCHEMA = "flow-updating-sweep-report/v1"
PROFILE_SCHEMA = "flow-updating-profile-report/v1"
FIELD_SCHEMA = "flow-updating-field-report/v1"
PLAN_SCHEMA = "flow-updating-plan-report/v1"
SERVICE_SCHEMA = "flow-updating-service-report/v1"
SCENARIO_SCHEMA = "flow-updating-scenario-report/v1"
AUDIT_SCHEMA = "flow-updating-audit-report/v1"
QUERY_SCHEMA = "flow-updating-query-report/v1"
RECOVERY_SCHEMA = "flow-updating-recovery-report/v1"
BUDGET_SCHEMA = "flow-updating-budget-report/v1"
#: embedded blocks (not top-level schemas), named as in the JAX package
SERVING_TRACE_SCHEMA = "flow-updating-serving-trace/v1"
PERF_LENS_SCHEMA = "flow-updating-perf-lens/v1"


def environment_info(device=None) -> dict:
    """Backend, device and version facts in the keys the JAX package's
    ``doctor`` reads (``backend``, ``device_kind``, ``device_count``,
    ``x64``).  ``device`` is the run's device (default: the card when one
    is visible, else the CPU); torch runs float64 natively, so ``x64``
    is always true."""
    info: dict = {"python": sys.version.split()[0]}
    try:
        import torch

        dev = torch.device(device if device is not None else
                           ("cuda" if torch.cuda.is_available() else "cpu"))
        info.update({
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "backend": dev.type,
            "device_kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
            "device_count": (torch.cuda.device_count()
                             if dev.type == "cuda" else 1),
            "process_count": 1,
            "x64": True,
        })
    except Exception as exc:  # the manifest must not fail on a probe
        info["backend_error"] = f"{type(exc).__name__}: {exc}"
    try:
        import numpy as np

        info["numpy"] = np.__version__
    except Exception:
        pass
    return info


def topology_summary(topo) -> dict:
    """Size + degree stats + the checkpoint-grade content fingerprint."""
    import numpy as np

    from flow_updating_tpu_torch.utils.checkpoint import topology_fingerprint

    deg = np.asarray(topo.out_deg)
    out = topology_fingerprint(topo)
    out.update({
        "degree_min": int(deg.min()) if deg.size else 0,
        "degree_mean": round(float(deg.mean()), 3) if deg.size else 0.0,
        "degree_max": int(deg.max()) if deg.size else 0,
        "true_mean": float(topo.true_mean),
    })
    return out


def _config_dict(config) -> dict:
    if config is None:
        return {}
    if dataclasses.is_dataclass(config) and not isinstance(config, type):
        return dataclasses.asdict(config)
    if isinstance(config, dict):
        return dict(config)
    return {"repr": repr(config)}


def _configs(config) -> dict:
    return ({k: _config_dict(v) for k, v in config.items()}
            if isinstance(config, dict) else _config_dict(config))


def build_manifest(*, argv=None, config=None, topo=None, report=None,
                   timings=None, telemetry=None, extra=None,
                   device=None) -> dict:
    """Assemble the run manifest.  ``telemetry`` is a
    :class:`~flow_updating_tpu_torch.obs.telemetry.TelemetrySeries` (or
    None); ``config`` may be a dataclass, a dict, or a dict of
    dataclasses."""
    manifest = {
        "schema": SCHEMA,
        "created_unix": round(time.time(), 3),
        "argv": list(argv) if argv is not None else None,
        "config": _configs(config),
        "topology": topology_summary(topo) if topo is not None else None,
        "environment": environment_info(device),
        "timings": dict(timings) if timings else None,
        "report": report,
    }
    if telemetry is not None and len(telemetry):
        manifest["telemetry"] = {
            "metrics": list(telemetry.metrics),
            "rounds": len(telemetry),
            "series": telemetry.to_jsonable(),
        }
    if extra:
        manifest.update(extra)
    return manifest


def build_profile_manifest(*, argv=None, config=None, topo=None,
                           profile=None, extra=None, device=None) -> dict:
    """Assemble the profile manifest: the run manifest's argv, config,
    topology and environment binding around one cost record
    (:meth:`Engine.profile <flow_updating_tpu_torch.engine.Engine.
    profile>`)."""
    manifest = {
        "schema": PROFILE_SCHEMA,
        "created_unix": round(time.time(), 3),
        "argv": list(argv) if argv is not None else None,
        "config": _configs(config),
        "topology": topology_summary(topo) if topo is not None else None,
        "environment": environment_info(device),
        "profile": profile,
    }
    if extra:
        manifest.update(extra)
    return manifest


def build_plan_manifest(*, argv=None, config=None, topo=None,
                        plan=None, measured=None, extra=None,
                        device=None) -> dict:
    """Assemble the plan manifest around one topology-compiler decision
    (``PlanDecision.describe()``).  ``measured`` optionally records
    per-candidate measured rates (``{candidate: rounds_per_sec}``) so
    ``doctor``'s ``plan_selection`` audits the choice."""
    manifest = {
        "schema": PLAN_SCHEMA,
        "created_unix": round(time.time(), 3),
        "argv": list(argv) if argv is not None else None,
        "config": _configs(config),
        "topology": topology_summary(topo) if topo is not None else None,
        "environment": environment_info(device),
        "plan": dict(plan) if plan else None,
    }
    if measured:
        manifest["measured"] = dict(measured)
    if extra:
        manifest.update(extra)
    return manifest


def build_field_manifest(*, argv=None, config=None, topo=None,
                         fields=None, report=None, timings=None,
                         extra=None, device=None) -> dict:
    """Assemble the field manifest: the run manifest's binding around one
    :class:`~flow_updating_tpu_torch.obs.fields.FieldSeries` — its
    per-node/per-edge block and, when the run recorded full rows, the
    global series reduced from the fields under the ``telemetry`` key, so
    ``doctor``'s series checks run on field manifests unchanged (and can
    cite culprit ids from the fields)."""
    manifest = {
        "schema": FIELD_SCHEMA,
        "created_unix": round(time.time(), 3),
        "argv": list(argv) if argv is not None else None,
        "config": _configs(config),
        "topology": topology_summary(topo) if topo is not None else None,
        "environment": environment_info(device),
        "timings": dict(timings) if timings else None,
        "report": report,
    }
    if fields is not None and fields:
        manifest["fields"] = fields.to_jsonable()
        reduced = fields.reduced_series()
        if reduced:
            manifest["telemetry"] = {
                "metrics": [k for k in reduced if k != "t"],
                "rounds": len(fields),
                "derived_from": "fields",
                "series": reduced,
            }
    if extra:
        manifest.update(extra)
    return manifest


def build_sweep_manifest(*, argv=None, config=None, instances=None,
                         summary=None, timings=None, extra=None,
                         device=None) -> dict:
    """Assemble the sweep manifest: the run manifest's argv/config/
    environment binding around one record per packed instance (each with
    its topology fingerprint, params and convergence) and the sweep-level
    ``summary`` (buckets, structures, timings)."""
    manifest = {
        "schema": SWEEP_SCHEMA,
        "created_unix": round(time.time(), 3),
        "argv": list(argv) if argv is not None else None,
        "config": _configs(config),
        "environment": environment_info(device),
        "summary": dict(summary) if summary else None,
        "timings": dict(timings) if timings else None,
        "instances": list(instances) if instances is not None else [],
    }
    if extra:
        manifest.update(extra)
    return manifest


def build_scenario_manifest(*, argv=None, scenarios=None, summary=None,
                            timings=None, extra=None, device=None) -> dict:
    """Assemble the scenario-conformance manifest: the argv/environment
    binding around one record per executed scenario (its declaration, the
    planted ground truth, per-seed sweep records with series, the
    representative run's fields and blame — ``scenarios.run_scenarios``'
    output).  The doctor judges each record against its declared
    signature; the series live inside the records, so the healthy-run
    series rules never judge a planted fault."""
    manifest = {
        "schema": SCENARIO_SCHEMA,
        "created_unix": round(time.time(), 3),
        "argv": list(argv) if argv is not None else None,
        "environment": environment_info(device),
        "summary": dict(summary) if summary else None,
        "timings": dict(timings) if timings else None,
        "scenarios": list(scenarios) if scenarios is not None else [],
    }
    if extra:
        manifest.update(extra)
    return manifest


def build_service_manifest(*, argv=None, config=None, topo=None,
                           service=None, series=None, report=None,
                           timings=None, extra=None, device=None) -> dict:
    """Assemble the service manifest: the run manifest's argv/config/
    environment binding around a live engine's ``service`` block
    (``ServiceEngine.service_block()``).  ``series`` is the boundary-sample
    series (one row per segment boundary), embedded under the standard
    ``telemetry`` key so the doctor's series checks run unchanged;
    ``topo`` is the initial topology (the graph is mutable state
    afterwards — the epochs record how it evolved)."""
    manifest = {
        "schema": SERVICE_SCHEMA,
        "created_unix": round(time.time(), 3),
        "argv": list(argv) if argv is not None else None,
        "config": _configs(config),
        "topology": topology_summary(topo) if topo is not None else None,
        "environment": environment_info(device),
        "timings": dict(timings) if timings else None,
        "report": report,
        "service": dict(service) if service else None,
    }
    if series:
        manifest["telemetry"] = {
            "metrics": [k for k in series if k != "t"],
            "rounds": len(series.get("t", ())),
            "derived_from": "segment_boundaries",
            "series": {k: list(v) for k, v in series.items()},
        }
    if extra:
        manifest.update(extra)
    return manifest


def build_query_manifest(*, argv=None, config=None, topo=None,
                         query=None, timings=None, extra=None,
                         device=None) -> dict:
    """Assemble the query-fabric manifest: the run manifest's argv/config/
    environment binding around a ``query`` block
    (``QueryFabric.query_block()`` — lane and dispatch accounting, the
    admission-latency distribution against its SLO, per-boundary
    lane-mass rows, per-query lifecycle records with results).  The
    doctor judges it with ``check_query``; ``topo`` is the initial
    topology (membership is mutable state afterwards)."""
    manifest = {
        "schema": QUERY_SCHEMA,
        "created_unix": round(time.time(), 3),
        "argv": list(argv) if argv is not None else None,
        "config": _configs(config),
        "topology": topology_summary(topo) if topo is not None else None,
        "environment": environment_info(device),
        "timings": dict(timings) if timings else None,
        "query": dict(query) if query else None,
    }
    if extra:
        manifest.update(extra)
    return manifest


def build_recovery_manifest(*, argv=None, config=None, recovery=None,
                            service=None, query=None, timings=None,
                            extra=None, device=None) -> dict:
    """Assemble the crash-recovery manifest: the argv/config/environment
    binding around one ``recovery`` block
    (``ServiceEngine.resilience_block()``: WAL accounting with torn-tail
    truncation, the ring scan with per-archive integrity verdicts and the
    fallback chain, the replay record, and — when a harness planted a
    fault — its ``ground_truth`` and ``verify`` blocks).  The doctor judges
    it with ``check_recovery``; ``inspect --blame`` ranks the faults that
    explain it.  The post-recovery ``service`` block rides along so the
    service SLO checks run on the recovered engine too."""
    manifest = {
        "schema": RECOVERY_SCHEMA,
        "created_unix": round(time.time(), 3),
        "argv": list(argv) if argv is not None else None,
        "config": _configs(config),
        "environment": environment_info(device),
        "timings": dict(timings) if timings else None,
        "recovery": dict(recovery) if recovery else None,
    }
    if service:
        manifest["service"] = dict(service)
    if query:
        manifest["query"] = dict(query)
    if extra:
        manifest.update(extra)
    return manifest


def write_report(path: str, manifest: dict) -> None:
    with open(path, "w") as f:
        json.dump(manifest, f, indent=1, default=str)
        f.write("\n")
