"""Command-line driver: the ``run``, ``oracle``, ``plan``, ``inspect`` and
``obs`` subcommands.

Counterpart of ``flow_updating_tpu/cli.py``'s ``run``, ``oracle``,
``plan``, ``inspect`` and ``obs export-trace``.
They take the same flags, so a JAX command line carries over, plus
``--device`` (``cuda``, the default, or ``cpu``) for ``run``.  Topology
from ``--platform``/``--deployment`` XML or a synthetic ``--generator``;
watcher sampling every ``--observe-every`` simulated seconds until
``--until``, or exactly ``--rounds``, or ``--until-rmse``.  Prints one
JSON convergence report.

``--shards N`` runs the node kernel's ``banded_fused`` round over an
N-shard mesh (``--halo`` picks the exchange, as in the JAX CLI), or its
``benes_fused`` round with a Beneš network per shard; ``--shards N
--multichip pod --spmv structured`` a fat tree's stencil sharded by pod
(N dividing k; ``--halo overlap`` the overlap schedule);
``--shards N --multichip halo`` the edge kernel's halo round
(``--halo ppermute|allgather|overlap|overlap_pallas|auto``,
``--partition bfs|contiguous``), whose exchange decision the report
carries under ``halo``.  ``--contention`` (``--contention-iters``,
``--contention-backlog``) and ``--fidelity`` price shared links on a
``--platform`` topology.  ``--save-checkpoint PATH`` writes the run's
state at its end (the JAX package's archive, which either package
resumes); ``--resume PATH`` continues from one instead of building a
fresh state, under the archive's config (``--rounds`` counts from the
restored round, ``--until`` is absolute simulated time).  ``--plan auto``
lets the topology compiler pick the kernel/spmv (its decision goes into
the report as ``plan``).  ``--telemetry [METRICS]`` records the
per-round series on the device (summary on stdout, the full series in
the ``--report`` manifest, ``flow-updating-run-report/v1``);
``--event-log PATH`` writes JSONL ``run_start``, ``advance``, ``watch``
and ``run_end`` records.  Flags whose machinery is not ported yet exit
with a message naming the ROADMAP item.  ``--backend`` selects the JAX backend in the JAX package; it is
accepted here for command-line compatibility and has no effect.

``oracle`` runs the native discrete-event simulator on the host (the
reference-style baseline; ``--lmm`` for the dynamic max-min network) and
prints the JAX CLI's JSON keys.

``plan`` runs the topology compiler alone: the auto-selection decision
with band occupancy and predicted costs as JSON (``--explain`` adds the
table on stderr, ``--mixing`` the spectral-gap block, ``--autotune`` the
measured probes on ``--device``, ``--report PATH`` a
``flow-updating-plan-report/v1`` manifest).

``inspect`` records per-node and per-edge fields on a live run on
``--device`` (``--fields``, ``--field-stride``, ``--field-topk``,
``--conv-tol``; ``--report PATH`` writes a
``flow-updating-field-report/v1`` manifest) or reads saved field, sweep
and recovery manifests — either package's — and prints their summary,
``--blame`` (ranked culprits per symptom), ``--diff A B`` (per-field
deltas on the common round grid) or ``--heatmap FIELD`` (ASCII, over
the generator's coordinates).  ``obs export-trace`` converts an
``--event-log`` JSONL file (or a serving manifest) into a Chrome
trace-event document.
"""

from __future__ import annotations

import argparse
import json
import logging
import math
import sys
import time

#: run flags of the JAX CLI that this package does not run yet -> item
_LATER_FLAGS = {
    "profile": "profiling and analysis (A14)",
    "trace_dir": "profiling and analysis (A14)",
}


def _build_topology(args):
    from flow_updating_tpu_torch.engine import TICK_INTERVAL
    from flow_updating_tpu_torch.topology.deployment import load_deployment
    from flow_updating_tpu_torch.topology.generators import (
        topology_from_spec,
    )
    from flow_updating_tpu_torch.topology.platform import load_platform

    if args.generator:
        try:
            return topology_from_spec(args.generator, seed=args.seed)
        except (ValueError, NotImplementedError) as err:
            raise SystemExit(str(err)) from err
    if args.deployment:
        platform = load_platform(args.platform) if args.platform else None
        return load_deployment(args.deployment).to_topology(
            platform=platform, tick_interval=TICK_INTERVAL,
            latency_scale=args.latency_scale, msg_bytes=args.msg_bytes,
        )
    raise SystemExit("need --deployment (with optional --platform) "
                     "or --generator")


def _make_config(args):
    from flow_updating_tpu_torch.models.config import RoundConfig

    kw = dict(variant=args.variant, drop_rate=args.drop_rate,
              kernel=args.kernel, delivery=args.delivery, spmv=args.spmv,
              segment_impl=args.segment)
    if args.fidelity:
        if args.fire_policy not in (None, "reference"):
            raise SystemExit(
                "--fidelity runs the faithful dynamics; it cannot "
                "combine with --fire-policy every_round")
        maker = RoundConfig.fidelity
        if args.contention_iters is not None:
            kw["contention_iters"] = args.contention_iters
        if args.contention_backlog:
            kw["contention_backlog"] = True
    else:
        maker = (RoundConfig.reference
                 if (args.fire_policy or "reference") == "reference"
                 else RoundConfig.fast)
        kw["contention"] = args.contention
        kw["contention_iters"] = (args.contention_iters
                                  if args.contention_iters is not None
                                  else 0)
        kw["contention_backlog"] = args.contention_backlog
    for name in ("drain", "timeout", "delay_depth", "pending_depth"):
        if getattr(args, name) is not None:
            kw[name] = getattr(args, name)
    try:
        return maker(**kw)
    except ValueError as err:
        raise SystemExit(f"invalid flag combination: {err}") from err


def cmd_run(args) -> int:
    for flag, item in _LATER_FLAGS.items():
        if getattr(args, flag) not in (None, False):
            raise SystemExit(f"--{flag.replace('_', '-')} is the ROADMAP "
                             f"item '{item}', not ported yet")
    if args.multichip in ("halo", "pod") and not args.shards:
        raise SystemExit(
            f"--multichip {args.multichip} needs --shards N (it is a "
            "multi-chip distribution strategy)")
    if args.latency_scale is None:
        args.latency_scale = 1.0 if args.fidelity and args.platform else 0.0

    cfg = _make_config(args)
    telemetry_spec = _telemetry_spec(args)
    event_log = None
    if args.event_log:
        from flow_updating_tpu_torch.utils.eventlog import EventLog

        event_log = EventLog(args.event_log)
    engine = _new_engine(args, cfg, event_log)
    t_build0 = time.perf_counter()
    if args.resume:
        # restore makes no fresh state; the checkpoint's config governs
        # the run (it is part of the run's identity — e.g. delay_depth
        # shapes the ring buffer)
        try:
            engine.restore_checkpoint(args.resume)
        except (ValueError, NotImplementedError) as err:
            # bad checkpoints (format, fingerprint, dtype) and config
            # errors raised while preparing the kernel
            raise SystemExit(
                f"cannot resume from {args.resume}: {err}") from err
        if engine.config != cfg:
            logging.getLogger("flow_updating_tpu_torch.cli").warning(
                "--resume: checkpoint config %s overrides CLI flags %s",
                engine.config, cfg)
    else:
        try:
            engine.build(latency_scale=args.latency_scale, seed=args.seed)
        except (ValueError, NotImplementedError) as err:
            raise SystemExit(f"invalid flag combination: {err}") from err

    build_s = time.perf_counter() - t_build0
    if event_log:
        event_log.emit(
            "run_start", nodes=engine.topology.num_nodes,
            edges=engine.topology.num_edges, variant=engine.config.variant,
            fire_policy=engine.config.fire_policy)

    until_rmse_result = None
    telemetry_series = None
    t_run0 = time.perf_counter()
    if telemetry_spec is not None:
        # the series stays on the device; one bulk copy at the end
        every = max(1, int(args.observe_every))
        n = (args.rounds if args.rounds is not None
             else max(0, int(round(args.until - engine.clock))))
        try:
            telemetry_series = engine.run_telemetry(n, telemetry_spec)
        except (ValueError, NotImplementedError) as err:
            raise SystemExit(f"--telemetry: {err}") from err
        if event_log and telemetry_series:
            for rec in telemetry_series.watch_records(every):
                event_log.emit("watch", **rec)
    elif args.until_rmse is not None:
        until_rmse_result = engine.run_until_rmse(
            args.until_rmse, max_rounds=args.max_rounds)
        if event_log:
            event_log.emit("until_rmse", **until_rmse_result)
    elif args.stream:
        emit = None
        if event_log:
            def emit(m):
                event_log.emit("watch", **m)
        # --until is absolute simulated time (as run_until, after
        # --resume too); --rounds is a relative count
        n = (args.rounds if args.rounds is not None
             else max(0, int(round(args.until - engine.clock))))
        every = max(1, int(args.observe_every))
        full = n - n % every
        if full:
            engine.run_streamed(full, observe_every=every, emit=emit)
        if n - full:
            engine.run_rounds(n - full)
    elif args.rounds is not None:
        engine.run_rounds(args.rounds)
    else:
        cb = None
        if event_log:
            def cb(e):
                event_log.emit("watch", t=int(e.state.t),
                               **e.global_values())
        engine.add_watcher(run_until=args.until,
                           time_interval=args.observe_every, callback=cb)
        engine.run_until(args.until)
    report = engine.convergence_report()   # reads back: the run has ended
    run_s = time.perf_counter() - t_run0
    if until_rmse_result is not None:
        report["until_rmse"] = until_rmse_result
    report["true_mean"] = engine.topology.true_mean
    report["nodes"] = engine.topology.num_nodes
    report["edges"] = engine.topology.num_edges
    report["variant"] = engine.config.variant
    report["fire_policy"] = engine.config.fire_policy
    report["spmv"] = engine.config.spmv
    report["device"] = str(engine.device)
    report["run_s"] = run_s
    if engine.halo_report() is not None:
        report["halo"] = engine.halo_report()
    if engine.plan_report() is not None:
        report["plan"] = engine.plan_report()
    if telemetry_series is not None:
        # summary on stdout; the full series belongs in --report
        report["telemetry"] = telemetry_series.summary()
    if args.save_checkpoint:
        engine.save_checkpoint(args.save_checkpoint)
        report["checkpoint"] = args.save_checkpoint
    if args.report:
        from flow_updating_tpu_torch.obs.report import (
            build_manifest,
            write_report,
        )

        timings = {"build_s": round(build_s, 6), "run_s": round(run_s, 6)}
        timings.update(engine.telemetry_timings or {})
        write_report(args.report, build_manifest(
            argv=getattr(args, "_argv", None), config=engine.config,
            topo=engine.topology, report=report, timings=timings,
            telemetry=telemetry_series, device=engine.device))
        report["report_path"] = args.report
    if event_log:
        event_log.emit("run_end", **report)
        event_log.close()
    print(json.dumps(report))
    return 0


def _new_engine(args, cfg, event_log=None):
    """The Engine the shared run flags describe, its topology set (``run``
    and ``inspect``'s live run build the same engine on ``--device``)."""
    from flow_updating_tpu_torch.engine import Engine

    try:
        mesh = None
        if args.shards:
            from flow_updating_tpu_torch.parallel.mesh import make_mesh

            mesh = make_mesh(args.shards, device=args.device)
        engine = Engine(config=cfg, mesh=mesh, multichip=args.multichip,
                        halo=args.halo, partition=args.partition,
                        plan=args.plan, event_log=event_log,
                        device=args.device)
    except (NotImplementedError, RuntimeError, ValueError) as err:
        raise SystemExit(str(err)) from err
    return engine.set_topology(_build_topology(args))


def _telemetry_spec(args):
    """``--telemetry`` as a spec (None when off), checked against the
    run flags before anything runs."""
    if args.telemetry is None:
        return None
    from flow_updating_tpu_torch.obs.telemetry import TelemetrySpec

    try:
        spec = TelemetrySpec.parse(args.telemetry)
    except ValueError as err:
        raise SystemExit(f"--telemetry: {err}") from err
    if not spec.enabled:
        # '--telemetry off' means exactly that: the plain run paths
        return None
    if args.stream or args.until_rmse is not None:
        raise SystemExit(
            "--telemetry accumulates the series over one fixed-length "
            "run; it cannot combine with --stream or --until-rmse")
    if args.event_log:
        need = [m for m in ("rmse", "max_abs_err", "mass", "fired_total")
                if not spec.has(m)]
        if need:
            raise SystemExit(
                f"--telemetry with --event-log needs metric(s) "
                f"{','.join(need)} for the watch records — add them to "
                "the list or use '--telemetry default'")
    return spec


def cmd_obs_export_trace(args) -> int:
    """``obs export-trace``: an event-log JSONL file -> a Chrome
    trace-event / Perfetto document (chrome://tracing, ui.perfetto.dev).
    A serving manifest (a ``serving_trace`` block) renders as lane
    tracks with query spans and metric counter tracks instead."""
    import os

    from flow_updating_tpu_torch.obs.trace import (
        eventlog_to_chrome_trace,
        read_eventlog,
        serving_manifest_to_chrome_trace,
    )

    if not os.path.exists(args.eventlog):
        raise SystemExit(f"no such event log: {args.eventlog}")
    # a manifest is one JSON document, not a JSONL event log — the most
    # common mix-up: name the fix instead of tracing a half-parsed file
    try:
        with open(args.eventlog) as f:
            doc = json.load(f)
    except (ValueError, OSError):
        doc = None
    if isinstance(doc, dict) and "schema" in doc:
        # a one-record event log also parses as one JSON object; only the
        # schema key marks a manifest
        if isinstance(doc.get("serving_trace"), dict) \
                or isinstance(doc.get("query"), dict):
            trace_doc = serving_manifest_to_chrome_trace(doc)
            _write_trace(trace_doc, args, {"source": doc["schema"]})
            return 0
        raise SystemExit(
            f"{args.eventlog}: this is a {doc['schema']} manifest, not "
            "an event log — export-trace consumes the JSONL file "
            "written by `run --event-log PATH` (manifests are judged "
            "by `doctor`, field manifests by `inspect`; serve/query "
            "manifests with a serving_trace block DO render here)")
    records = read_eventlog(args.eventlog)
    if not records:
        raise SystemExit(
            f"{args.eventlog}: no parseable JSONL records (is this an "
            "event log written with --event-log?)")
    _write_trace(eventlog_to_chrome_trace(records), args,
                 {"records": len(records)})
    return 0


def _write_trace(doc: dict, args, info: dict) -> None:
    out = args.output or (args.eventlog + ".trace.json")
    if out == "-":
        json.dump(doc, sys.stdout)
        sys.stdout.write("\n")
        return
    with open(out, "w") as f:
        json.dump(doc, f)
    print(json.dumps({"trace": out, **info,
                      "trace_events": len(doc["traceEvents"])}))


def _load_inspect_manifest(path: str) -> dict:
    try:
        with open(path) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as err:
        raise SystemExit(f"inspect: cannot read {path}: {err}") from err
    if not isinstance(manifest, dict):
        raise SystemExit(
            f"inspect: {path} is not a manifest (expected a JSON object "
            "with a 'fields' block — write one with `inspect --report` "
            "or `run`'s field flags)")
    return manifest


def _field_series_from(manifest: dict, path: str):
    """A manifest's fields block as a FieldSeries, with mix-ups named."""
    from flow_updating_tpu_torch.obs.fields import FieldSeries

    block = manifest.get("fields")
    if not isinstance(block, dict):
        schema = manifest.get("schema", "unknown schema")
        raise SystemExit(
            f"inspect: {path} ({schema}) has no per-node/per-edge "
            "fields block — record one with `inspect --generator ... "
            "--fields ... --report PATH` (global-telemetry manifests "
            "are judged by `doctor`)")
    return FieldSeries.from_jsonable(block)


def _emit_json(doc: dict, output: str | None) -> None:
    if output and output != "-":
        with open(output, "w") as f:
            json.dump(doc, f, indent=1, default=str)
            f.write("\n")
        print(json.dumps({"output": output}))
    else:
        print(json.dumps(doc, default=str))


def cmd_inspect(args) -> int:
    """``inspect``: record per-node/per-edge fields on a live run
    (``--fields``, bounded by ``--field-stride``/``--field-topk``),
    localize faults (``--blame``), diff two runs (``--diff A B``) and
    render ASCII heatmaps (``--heatmap FIELD``); field manifests use the
    ``flow-updating-field-report/v1`` schema."""
    from flow_updating_tpu_torch.obs import inspect as _inspect

    if args.diff:
        a_path, b_path = args.diff
        sa = _field_series_from(_load_inspect_manifest(a_path), a_path)
        sb = _field_series_from(_load_inspect_manifest(b_path), b_path)
        try:
            out = _inspect.diff_fields(sa, sb, atol=args.diff_atol)
        except ValueError as err:
            raise SystemExit(f"inspect --diff: {err}") from err
        _emit_json({"a": a_path, "b": b_path, **out}, args.output)
        return 0

    targets = []
    if args.generator or args.deployment:
        from flow_updating_tpu_torch.obs.fields import FieldSpec

        try:
            spec = FieldSpec.parse(
                args.fields if args.fields is not None else "default",
                stride=args.field_stride, topk=args.field_topk,
                tol=args.conv_tol)
        except ValueError as err:
            raise SystemExit(f"--fields: {err}") from err
        if not spec.enabled:
            raise SystemExit(
                "--fields off records nothing to inspect; pick a field "
                "list (or 'default'/'full')")
        if args.multichip in ("halo", "pod") and not args.shards:
            raise SystemExit(
                f"--multichip {args.multichip} needs --shards N (it is a "
                "multi-chip distribution strategy)")
        engine = _new_engine(args, _make_config(args))
        try:
            engine.build(latency_scale=args.latency_scale, seed=args.seed)
        except (ValueError, NotImplementedError) as err:
            raise SystemExit(f"invalid flag combination: {err}") from err
        t0 = time.perf_counter()
        try:
            series = engine.run_fields(args.rounds, spec)
        except (ValueError, NotImplementedError) as err:
            raise SystemExit(f"inspect: {err}") from err
        run_s = time.perf_counter() - t0
        if args.report:
            from flow_updating_tpu_torch.obs.report import (
                build_field_manifest,
                write_report,
            )

            report = engine.convergence_report()
            report["true_mean"] = engine.topology.true_mean
            report["nodes"] = engine.topology.num_nodes
            write_report(args.report, build_field_manifest(
                argv=getattr(args, "_argv", None), config=engine.config,
                topo=engine.topology, fields=series, report=report,
                timings={"run_s": round(run_s, 6),
                         **engine.field_timings},
                device=engine.device))
        targets.append((args.report or "<live>", series))
    sweep_targets = []
    recovery_targets = []
    for path in args.reports:
        doc = _load_inspect_manifest(path)
        if isinstance(doc.get("recovery"), dict):
            if not args.blame:
                raise SystemExit(
                    f"inspect: {path} is a recovery manifest — pass "
                    "--blame to rank the infra faults that explain it")
            recovery_targets.append((path, doc))
        elif (isinstance(doc.get("instances"), list)
                and not isinstance(doc.get("fields"), dict)):
            if not args.blame:
                raise SystemExit(
                    f"inspect: {path} is a sweep manifest — pass "
                    "--blame to rank its worst instances (field-level "
                    "views need a field manifest)")
            sweep_targets.append((path, doc))
        else:
            targets.append((path, _field_series_from(doc, path)))
    if not targets and not sweep_targets and not recovery_targets:
        raise SystemExit(
            "inspect: nothing to inspect — pass saved field-manifest "
            "paths, --diff A B, or a topology (--generator/"
            "--deployment) for a live field recording")

    if args.heatmap:
        if sweep_targets:
            raise SystemExit(
                "inspect: --heatmap renders per-node fields; sweep "
                "manifests carry per-instance records only (use "
                "--blame)")
        for path, series in targets:
            if args.heatmap not in series:
                raise SystemExit(
                    f"inspect: field {args.heatmap!r} was not recorded "
                    f"in {path} (have: {', '.join(series.fields)})")
            vals = series[args.heatmap]
            if args.heatmap != "node_conv_round":
                try:
                    vals = vals[args.heatmap_round]
                except IndexError:
                    raise SystemExit(
                        f"inspect: --heatmap-round {args.heatmap_round} "
                        f"outside the {len(series)} recorded rows") from None
            if series.topk_idx is not None:
                raise SystemExit(
                    "inspect: heatmaps need full field rows; this run "
                    "recorded only the topk worst nodes")
            # coordinates are per node; edge fields wrap in edge-id order
            coords = (series.coords if args.heatmap not in series.edge
                      else None)
            print(f"# {path}: {args.heatmap}"
                  + ("" if args.heatmap == "node_conv_round" else
                     f" @ t={int(series.t[args.heatmap_round])}"))
            print(_inspect.ascii_heatmap(vals, coords,
                                         width=args.heatmap_width))
        return 0

    out = []
    for path, series in targets:
        entry = {"source": path, "fields": series.summary()}
        if args.blame:
            entry["blame"] = _inspect.blame(
                series, threshold=args.rmse_threshold)
        out.append(entry)
    for path, doc in sweep_targets:
        try:
            verdict = _inspect.blame_sweep(doc)
        except ValueError as err:
            raise SystemExit(f"inspect: {path}: {err}") from err
        out.append({"source": path, "sweep_blame": verdict})
    for path, doc in recovery_targets:
        try:
            verdict = _inspect.blame_recovery(doc)
        except ValueError as err:
            raise SystemExit(f"inspect: {path}: {err}") from err
        out.append({"source": path, "recovery_blame": verdict})
    _emit_json(out[0] if len(out) == 1 else {"inspected": out},
               args.output)
    return 0


def cmd_plan(args) -> int:
    """``plan``: the topology compiler alone — compile the graph, print
    the auto-selection decision with band occupancy and predicted
    per-candidate cost (``--explain`` for the table on stderr), and
    optionally a ``flow-updating-plan-report/v1`` manifest."""
    from flow_updating_tpu_torch.plan import select_plan

    if args.probe:
        raise SystemExit(
            "plan --probe ranks candidates by the compiler's cost analysis "
            "of the lowered programs — the ROADMAP item 'profiling and "
            "analysis (A14)', not ported yet; use --autotune for measured "
            "rates")
    if args.latency_scale is None:
        args.latency_scale = 0.0
    cfg = _make_config(args)
    topo = _build_topology(args)
    try:
        decision = select_plan(
            topo, cfg, backend=args.plan_backend or args.device,
            max_lanes=args.max_lanes, min_fill=args.min_fill,
            remainder=args.remainder,
            autotune=True if args.autotune else False,
            device=args.device)
    except (ValueError, NotImplementedError, RuntimeError) as err:
        raise SystemExit(f"plan: {err}") from err
    doc = decision.describe()
    doc["nodes"] = topo.num_nodes
    doc["directed_edges"] = topo.num_edges
    if args.autotune:
        # this invocation's cache traffic: a hit means zero probes ran
        from flow_updating_tpu_torch.plan.select import AUTOTUNE_CACHE_STATS

        doc["autotune_cache"] = dict(AUTOTUNE_CACHE_STATS)
    if args.mixing:
        from flow_updating_tpu_torch.obs.spectral import mixing_report

        doc["mixing"] = mixing_report(
            topo, plan=decision.plan
            if decision.spmv in ("banded", "banded_fused") else None,
            device=args.device)
    if args.explain:
        print("\n".join(_explain_lines(doc, decision, topo)),
              file=sys.stderr)
    if args.report:
        from flow_updating_tpu_torch.obs.report import (
            build_plan_manifest,
            write_report,
        )

        write_report(args.report, build_plan_manifest(
            argv=getattr(args, "_argv", None), config=cfg, topo=topo,
            plan=doc, device=args.device))
        doc["report_path"] = args.report
    print(json.dumps(doc))
    return 0


def _explain_lines(doc: dict, decision, topo) -> list:
    """The human-readable decision: predicted costs, the band occupancy
    after RCM (kept lanes marked), the mixing estimate."""
    from flow_updating_tpu_torch.plan.rcm import offset_profile

    lines = [f"# decision: {doc['kernel']}"
             + (f"/{doc['spmv']}" if doc.get("spmv") else "")
             + f" on {doc['backend']}",
             f"# {decision.reason}"]
    numeric = {c: v for c, v in doc.get("predicted_cost", {}).items()
               if isinstance(v, (int, float))}
    for cand, cost in sorted(numeric.items(), key=lambda kv: kv[1]):
        lines.append(f"#   {cand:<16} predicted {cost:,.0f}")
    plan = decision.plan
    if plan is not None:
        offs, counts = offset_profile(topo, plan.order, top=16)
        lines.append(
            f"# band occupancy after RCM (top diagonals of "
            f"{topo.num_nodes} rows; kept lanes marked *):")
        kept = set(plan.spmv.offsets)
        for d, c in zip(offs, counts):
            mark = "*" if int(d) in kept else " "
            lines.append(
                f"# {mark} offset {int(d):+6d}: {int(c):8d} edges "
                f"({100.0 * c / max(topo.num_nodes, 1):5.1f}% fill)")
    mix = doc.get("mixing")
    if isinstance(mix, dict):
        pr = mix.get("predicted_rounds")
        lines.append(
            f"# mixing: gap {mix['gap']:.4g} ({mix['provenance']}) "
            f"-> ~{pr:,.0f} rounds to eps={mix['eps']:g}"
            if pr is not None and math.isfinite(pr)
            else f"# mixing: gap {mix.get('gap')!r} "
                 f"({mix.get('provenance')})")
        st, me = mix.get("structural") or {}, mix.get("measured") or {}
        if st.get("gap") is not None and me.get("gap") is not None:
            lines.append(
                f"#   structural {st['gap']:.4g} "
                f"(|lambda2| {st.get('lambda2', 0):.4g}, "
                f"{st.get('iters', '?')} iters) vs measured "
                f"{me['gap']:.4g} ({me.get('rounds', '?')} probe rounds)")
        cache = mix.get("cache") or {}
        lines.append(
            f"#   cache {'hit' if cache.get('hit') else 'miss'}"
            f" ({cache.get('path')})")
    return lines


def cmd_oracle(args) -> int:
    import numpy as np

    from flow_updating_tpu_torch import native

    topo = _build_topology(args)
    timeout = args.timeout if args.timeout is not None else 50
    network = "unit-delay"
    try:
        if args.lmm:
            if not topo.has_link_model:
                raise SystemExit("--lmm needs a platform topology with a "
                                 "link model (--platform + --latency-scale "
                                 "> 0)")
            _rmse, est, last_avg, events = native.des_run_contend(
                topo, variant=args.variant, timeout=timeout,
                ticks=args.ticks, clamp_d=0, lmm=True)
            network = "dynamic max-min LMM"
        else:
            est, last_avg, events = native.des_run(
                topo, variant=args.variant, timeout=timeout,
                ticks=args.ticks)
    except native.NativeError as err:
        raise SystemExit(f"native runtime unavailable: {err}") from err
    err = est - topo.true_mean
    print(json.dumps({
        "ticks": args.ticks,
        "events": events,
        "network": network,
        "rmse": float(np.sqrt(np.mean(err * err))),
        "max_abs_err": float(np.max(np.abs(err))),
        "mass_residual": float(est.sum() - topo.values.sum()),
        "true_mean": topo.true_mean,
    }))
    return 0


def _add_topology_flags(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--platform", help="SimGrid-style platform XML")
    ap.add_argument("--deployment", help="SimGrid-style deployment XML")
    ap.add_argument("--generator", help="synthetic topology, e.g. "
                    "'erdos_renyi:10000', 'fat_tree:160', 'ring:100:2'")
    ap.add_argument("--seed", type=int, default=0)


def _add_config_flags(ap: argparse.ArgumentParser) -> None:
    """The round-config flags ``run`` and ``plan`` share."""
    ap.add_argument("--variant", default="collectall",
                    choices=("collectall", "pairwise"))
    ap.add_argument("--fire-policy", default=None,
                    choices=("reference", "every_round"),
                    help="'reference' = faithful async dynamics; "
                         "'every_round' = fast synchronous mode")
    ap.add_argument("--delivery", default="gather",
                    choices=("gather", "scatter", "benes", "benes_fused"),
                    help="edge-kernel message delivery: gather (pull "
                         "through rev), scatter (push), benes / "
                         "benes_fused (the rev pull through a permutation "
                         "network; benes_fused through CUDA kernel B3)")
    ap.add_argument("--spmv", default="xla",
                    choices=("xla", "pallas", "benes", "benes_fused",
                             "structured", "banded", "banded_fused"),
                    help="node-kernel neighbor sum: xla (plain gather), "
                         "pallas (CUDA ELL kernel), banded (RCM bands + "
                         "gather remainder), banded_fused (the whole "
                         "round as one CUDA kernel), benes / benes_fused "
                         "(a permutation network; benes_fused through "
                         "CUDA kernel B3), structured (a regular "
                         "generator's closed-form stencil)")
    ap.add_argument("--segment", default="auto",
                    choices=("auto", "segment", "ell", "benes",
                             "benes_fused"),
                    help="edge-kernel per-node reductions: segment/auto "
                         "(CSR segment_reduce), ell (bucketed gather), "
                         "benes (permutation networks), benes_fused (the "
                         "same through CUDA kernels B3 and B4)")
    ap.add_argument("--kernel", default="edge", choices=("edge", "node"),
                    help="'edge' = the general per-edge round (every "
                         "dynamics; --segment and --delivery pick its "
                         "layouts); 'node' = the collapsed SpMV recurrence "
                         "(fast synchronous collect-all only; --spmv)")
    ap.add_argument("--drain", type=int, default=None)
    ap.add_argument("--timeout", type=int, default=None)
    ap.add_argument("--delay-depth", type=int, default=None)
    ap.add_argument("--pending-depth", type=int, default=None)
    ap.add_argument("--drop-rate", type=float, default=0.0)
    ap.add_argument("--fidelity", action="store_true")
    ap.add_argument("--contention", action="store_true")
    ap.add_argument("--contention-iters", type=int, default=None)
    ap.add_argument("--contention-backlog", action="store_true")


def _add_mesh_flags(ap: argparse.ArgumentParser) -> None:
    """The multi-shard flags ``run`` and ``inspect`` share."""
    ap.add_argument("--multichip", default="auto",
                    choices=("auto", "halo", "pod"),
                    help="under --shards: 'auto' = the node kernel's "
                         "sharded banded or Beneš round; 'halo' = the "
                         "edge kernel's halo round (cut-edge exchange, "
                         "--halo, --partition); 'pod' = a fat tree's "
                         "stencil sharded by pod (--spmv structured, "
                         "shards dividing k)")
    ap.add_argument("--halo", default="ppermute",
                    choices=("ppermute", "allgather", "overlap",
                             "overlap_pallas", "auto"),
                    help="exchange under --shards: 'ppermute' = the "
                         "serialized schedule; the banded round overlaps "
                         "its copies for any other value; the halo round "
                         "takes each mode as named ('overlap_pallas' = "
                         "CUDA kernel B6, 'auto' = ranked by wire bytes)")
    ap.add_argument("--partition", default="bfs",
                    choices=("bfs", "contiguous"))
    ap.add_argument("--shards", type=int, default=0,
                    help="run over an N-shard mesh (--kernel node --spmv "
                         "banded_fused or benes_fused, --multichip pod, "
                         "or --multichip halo): shards go "
                         "round-robin over the visible cards, or all on "
                         "the host with --device cpu")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="flow_updating_tpu_torch",
        description="Flow-Updating distributed aggregation on PyTorch/CUDA",
    )
    ap.add_argument("-v", "--verbose", action="store_true")
    sub = ap.add_subparsers(dest="cmd", required=True)

    run = sub.add_parser("run", help="one aggregation run")
    run.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                     help="where the rounds run: the CUDA card (default) or "
                          "the host CPU with the plain tensor versions")
    run.add_argument("--backend", default="auto",
                     choices=("auto", "cpu", "jax_tpu"),
                     help="JAX backend of the JAX package; accepted for "
                          "command-line compatibility, no effect here "
                          "(see --device)")
    _add_topology_flags(run)
    _add_mesh_flags(run)
    _add_config_flags(run)
    run.add_argument("--plan", default="off", choices=("off", "auto"),
                     help="'auto' = the topology compiler picks the "
                          "kernel/spmv for the graph on --device")
    run.add_argument("--latency-scale", type=float, default=None)
    run.add_argument("--msg-bytes", type=float, default=104.0)
    run.add_argument("--rounds", type=int, default=None,
                     help="run exactly N rounds (no watcher)")
    run.add_argument("--until-rmse", type=float, default=None,
                     metavar="THRESH",
                     help="run until estimate RMSE <= THRESH")
    run.add_argument("--max-rounds", type=int, default=100_000,
                     help="round budget for --until-rmse")
    run.add_argument("--until", type=float, default=1000.0,
                     help="watcher horizon in simulated seconds")
    run.add_argument("--observe-every", type=float, default=10.0,
                     help="watcher sampling interval")
    run.add_argument("--stream", action="store_true",
                     help="log a metrics sample every --observe-every "
                          "rounds")
    run.add_argument("--telemetry", nargs="?", const="default",
                     metavar="METRICS",
                     help="record per-round metric series on the device "
                          "(default / full / off / m1,m2,...); summary "
                          "in the report, full series in --report")
    run.add_argument("--report", metavar="PATH",
                     help="write the flow-updating-run-report/v1 "
                          "manifest to PATH")
    run.add_argument("--event-log", metavar="PATH",
                     help="append JSONL run_start / advance / watch / "
                          "run_end records to PATH")
    run.add_argument("--profile", metavar="DIR")
    run.add_argument("--trace-dir", metavar="DIR")
    run.add_argument("--save-checkpoint", metavar="PATH",
                     help="write the final state to PATH (.npz)")
    run.add_argument("--resume", metavar="PATH",
                     help="continue from a checkpoint (its config wins)")
    run.set_defaults(fn=cmd_run)

    orc = sub.add_parser("oracle", help="native DES reference-style run "
                         "(on the host)")
    orc.add_argument("--backend", default="auto",
                     choices=("auto", "cpu", "jax_tpu"),
                     help="accepted for command-line compatibility with "
                          "the JAX CLI; no effect")
    _add_topology_flags(orc)
    orc.add_argument("--variant", default="collectall",
                     choices=("collectall", "pairwise"))
    orc.add_argument("--timeout", type=int, default=None)
    orc.add_argument("--ticks", type=int, default=1000)
    orc.add_argument("--latency-scale", type=float, default=0.0)
    orc.add_argument("--msg-bytes", type=float, default=104.0)
    orc.add_argument("--lmm", action="store_true",
                     help="dynamic max-min LMM network (SimGrid flow-"
                          "model fidelity; needs --platform and "
                          "--latency-scale > 0)")
    orc.set_defaults(fn=cmd_oracle)

    pl = sub.add_parser(
        "plan", help="topology compiler alone: the kernel/spmv decision "
        "with band occupancy and predicted costs, optionally measured "
        "probes, the mixing estimate and a plan manifest")
    pl.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where --autotune and --mixing probe: the CUDA "
                         "card (default) or the host CPU")
    pl.add_argument("--backend", default="auto",
                    choices=("auto", "cpu", "jax_tpu"),
                    help="accepted for command-line compatibility with "
                         "the JAX CLI; no effect (see --device)")
    _add_topology_flags(pl)
    _add_config_flags(pl)
    pl.add_argument("--latency-scale", type=float, default=None)
    pl.add_argument("--msg-bytes", type=float, default=104.0)
    pl.add_argument("--plan-backend", default=None,
                    choices=("cuda", "cpu"),
                    help="rank candidates with this backend's cost model "
                         "instead of --device's")
    pl.add_argument("--probe", action="store_true",
                    help="rank by the compiler's cost analysis (ROADMAP "
                         "A14; exits naming it)")
    pl.add_argument("--autotune", action="store_true",
                    help="time the banded-family candidates (band width "
                         "x fused-round tile x remainder route) on "
                         "--device and rank from the measured rates; "
                         "records persist in the autotune cache "
                         "(FLOW_UPDATING_AUTOTUNE_CACHE)")
    pl.add_argument("--max-lanes", type=int, default=96,
                    help="dense roll-lane budget")
    pl.add_argument("--min-fill", type=float, default=None,
                    help="occupancy floor for keeping a diagonal as a "
                         "band lane, as a fraction of N (default: the "
                         "backend's break-even 3/gather_cost)")
    pl.add_argument("--remainder", default="auto",
                    choices=("auto", "gather", "benes", "none"),
                    help="route for out-of-band edges ('auto' = gather)")
    pl.add_argument("--explain", action="store_true",
                    help="print the decision breakdown (predicted costs, "
                         "band occupancy) to stderr")
    pl.add_argument("--mixing", action="store_true",
                    help="estimate the diffusion operator's spectral gap "
                         "on --device and embed the mixing block")
    pl.add_argument("--report", metavar="PATH",
                    help="write the flow-updating-plan-report/v1 "
                         "manifest to PATH")
    pl.set_defaults(fn=cmd_plan)

    ins = sub.add_parser(
        "inspect",
        help="topology-resolved observability: record per-node/per-edge "
             "metric fields on a live run (on the device, stride/topk "
             "memory bounding), localize faults with --blame, diff two "
             "runs (--diff A B), render ASCII heatmaps (--heatmap "
             "FIELD) — flow-updating-field-report/v1 manifests")
    ins.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                     help="where a live run's rounds run: the CUDA card "
                          "(default) or the host CPU")
    ins.add_argument("--backend", default="auto",
                     choices=("auto", "cpu", "jax_tpu"),
                     help="accepted for command-line compatibility with "
                          "the JAX CLI; no effect (see --device)")
    _add_topology_flags(ins)
    _add_mesh_flags(ins)
    _add_config_flags(ins)
    ins.add_argument("--plan", default="off", choices=("off", "auto"),
                     help="'auto' = the topology compiler picks the "
                          "kernel/spmv for the graph on --device")
    ins.add_argument("reports", nargs="*", metavar="FIELDS.json",
                     help="saved field manifests to inspect")
    ins.add_argument("--latency-scale", type=float, default=0.0)
    ins.add_argument("--msg-bytes", type=float, default=104.0)
    ins.add_argument("--rounds", type=int, default=200,
                     help="live-run length (with --generator/"
                          "--deployment); must be a multiple of "
                          "--field-stride")
    ins.add_argument("--fields", nargs="?", const="default",
                     metavar="FIELDS",
                     help="field selection for the live run: 'default', "
                          "'full', or a comma list from: node_err, "
                          "node_mass, node_mass_residual, node_fired, "
                          "node_conv_round, edge_flow, edge_est, "
                          "edge_stale")
    ins.add_argument("--field-stride", type=int, default=1, metavar="K",
                     help="record every K-th round only (memory bound; "
                          "state evolution is unchanged)")
    ins.add_argument("--field-topk", type=int, default=0, metavar="M",
                     help="record only the M worst nodes per round "
                          "(ranked by |node_err|; single-device kernels)")
    ins.add_argument("--conv-tol", type=float, default=1e-6,
                     help="per-node convergence-frontier tolerance for "
                          "node_conv_round")
    ins.add_argument("--rmse-threshold", type=float, default=1e-6,
                     help="stall-blame threshold: nodes above it with a "
                          "flat error trend rank as stragglers")
    ins.add_argument("--blame", action="store_true",
                     help="rank culprit node/edge ids per failing "
                          "symptom (stall stragglers, leaking edge "
                          "pairs, divergence origin)")
    ins.add_argument("--diff", nargs=2, metavar=("A.json", "B.json"),
                     help="align two field manifests on their common "
                          "round grid and report per-node/per-metric "
                          "deltas (identical-seed runs diff to zero)")
    ins.add_argument("--diff-atol", type=float, default=0.0,
                     help="absolute tolerance under which --diff "
                          "deltas count as identical")
    ins.add_argument("--heatmap", metavar="FIELD",
                     help="render FIELD as an ASCII heatmap over the "
                          "generator's coordinates (plain text output)")
    ins.add_argument("--heatmap-round", type=int, default=-1,
                     help="recorded row to render (default: last)")
    ins.add_argument("--heatmap-width", type=int, default=64,
                     help="wrap width when the topology has no "
                          "coordinates")
    ins.add_argument("--report", metavar="PATH",
                     help="write the live run's "
                          "flow-updating-field-report/v1 manifest to "
                          "PATH")
    ins.add_argument("-o", "--output", default=None, metavar="PATH",
                     help="write the JSON result (summary/blame/diff) "
                          "to PATH instead of stdout")
    ins.set_defaults(fn=cmd_inspect)

    obs = sub.add_parser(
        "obs", help="observability tools (event-log trace export)")
    obs_sub = obs.add_subparsers(dest="obs_cmd", required=True)
    exp = obs_sub.add_parser(
        "export-trace",
        help="convert an --event-log JSONL into Chrome trace-event / "
             "Perfetto JSON: engine lanes and watcher metrics as counter "
             "tracks (serving manifests: lane tracks)")
    exp.add_argument("eventlog", help="JSONL event log path")
    exp.add_argument("-o", "--output", default=None,
                     help="output path (default: <eventlog>.trace.json; "
                          "'-' = stdout)")
    exp.set_defaults(fn=cmd_obs_export_trace)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    args._argv = list(sys.argv[1:] if argv is None else argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(levelname)s %(name)s: %(message)s",
    )
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
