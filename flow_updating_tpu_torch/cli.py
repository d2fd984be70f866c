"""Command-line entry point: the ``run``, ``oracle``, ``plan``, ``inspect``,
``obs``, ``sweep``, ``scenarios``, ``serve``, ``query``, ``chaos``,
``doctor``, ``profile`` and ``regress`` subcommands.

Counterpart of ``flow_updating_tpu/cli.py``'s ``run``, ``oracle``,
``plan``, ``inspect``, ``obs export-trace``, ``sweep``, ``scenarios``,
``serve``, ``query``, ``chaos``, ``doctor``, ``profile`` and ``regress``.
They take the same flags, so a JAX command line carries over, plus
``--device`` (``cuda``, the default, or ``cpu``).  Topology
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
and ``run_end`` records; ``--trace-dir DIR`` (or ``--profile DIR``)
captures the rounds as one ``torch.profiler`` trace.  Flags whose
machinery is not ported yet exit with a message naming the ROADMAP
item.  ``--backend`` selects the JAX backend in the JAX package; it is
accepted here for command-line compatibility and has no effect.

``oracle`` runs the native discrete-event simulator on the host (the
reference-style baseline; ``--lmm`` for the dynamic max-min network) and
prints the JAX CLI's JSON keys.

``plan`` runs the topology compiler alone: the auto-selection decision
with band occupancy and predicted costs as JSON (``--explain`` adds the
table on stderr, ``--mixing`` the spectral-gap block, ``--autotune`` the
measured probes on ``--device``, ``--probe`` the ranking by each
candidate's counted bytes a round, ``--report PATH`` a
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

``sweep`` packs a grid (``--generator`` repeated, ``--seeds``,
``--drop-rates``, ``--timeouts``, ``--latency-scales``) into shape
buckets and advances each bucket's lanes together on ``--device``;
``--report`` writes a ``flow-updating-sweep-report/v1`` manifest.
``scenarios`` runs the conformance registry (``--list``, names,
``--seeds``, ``--perturb``) and exits 1 when a declared signature
fails; the ``agg_*`` names run the aggregate-kind fault cases, one
mixed-kind ``AggregateFabric`` each; ``sweep --profile`` attaches one
cost record per bucket.

``serve`` runs the streaming service (``flow_updating_tpu_torch.service``)
on ``--device``: an event script (``--events FILE`` or ``-``) of ``run``,
``join``, ``leave``, ``update``, ``add-edge``, ``remove-edge``,
``suspend``, ``resume``, ``estimates`` and ``checkpoint`` lines, then
``--rounds``; one JSON summary (``compile_count`` counts dispatch
signatures: 1), ``--report`` (``flow-updating-service-report/v1``),
``--metrics`` (Prometheus text), ``--checkpoint`` / ``--resume`` (service
archives of either package), ``--wal DIR`` (journal + checkpoint ring)
and ``--wal DIR --recover``; ``--trace-dir DIR`` captures the serving
body as one ``torch.profiler`` trace.

``query`` runs the multi-tenant query fabric
(``flow_updating_tpu_torch.query``) on ``--device``: Poisson arrivals
(``--arrival-rate`` a round, ``--queries`` in all) of random-cohort
(``--cohort-frac``) mean queries admit into free lanes of ``--lanes``;
converged lanes retire and recycle between segments.  One JSON summary
in the JAX CLI's keys; ``--report`` (``flow-updating-query-report/v1``),
``--metrics``, ``--checkpoint`` / ``--resume``, ``--wal DIR``
(``--recover``), ``--watchdog``, ``--mixing``, ``--admit-policy``.

``doctor`` judges saved manifests (run, plan, field and every other
``flow-updating-*-report/v1`` kind, either package's), ``--baselines``
and/or a live telemetry run on ``--device`` (``--generator`` or
``--deployment`` with ``run``'s flags, ``--rounds``) with the rules of
``obs/health.py``, prints ``{"overall", "checks"}`` and exits 1 on a
``fail`` (on a ``warn`` too under ``--strict``).

``profile`` counts and times the configured kernel's ``--rounds`` on
``--device`` (:meth:`Engine.profile`; ``--roofline``, ``--trace-dir``,
``--no-execute``, ``--report`` a ``flow-updating-profile-report/v1``
manifest).  ``regress --fresh F [--against R]`` gates a fresh profile
manifest or bench line against a reference or the ``BENCH_*`` history
(``obs/regress.py``) and exits 1 on a regression.
"""

from __future__ import annotations

import argparse
import json
import logging
import math
import sys
import time

#: run and doctor flags of the JAX CLI that this package does not run
#: yet -> item
_LATER_FLAGS = {
    "golden": "profiling and analysis (A14 part 2)",
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


def _refuse_later_flags(args) -> None:
    for flag, item in _LATER_FLAGS.items():
        if getattr(args, flag, None) not in (None, False):
            raise SystemExit(f"--{flag.replace('_', '-')} is the ROADMAP "
                             f"item '{item}', not ported yet")


def _check_run_flags(args) -> None:
    """The checks a live run (``run``, ``inspect``, ``doctor``) makes
    before building: later items' flags, ``--multichip`` without
    ``--shards``, and the default latency scale (1.0 for ``--fidelity``
    on a platform)."""
    _refuse_later_flags(args)
    if args.multichip in ("halo", "pod") and not args.shards:
        raise SystemExit(
            f"--multichip {args.multichip} needs --shards N (it is a "
            "multi-chip distribution strategy)")
    if args.latency_scale is None:
        args.latency_scale = 1.0 if args.fidelity and args.platform else 0.0


def cmd_run(args) -> int:
    _check_run_flags(args)
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

    # --trace-dir and --profile are the same torch.profiler capture
    # (utils/trace.py) of the run's rounds; --trace-dir wins when both are
    # given
    import contextlib

    from flow_updating_tpu_torch.utils.trace import trace

    capture = contextlib.ExitStack()
    capture.enter_context(trace(args.trace_dir or args.profile))
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
    capture.close()
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


def _live_engine(args):
    """The built engine of a live ``inspect`` or ``doctor`` run."""
    _check_run_flags(args)
    engine = _new_engine(args, _make_config(args))
    try:
        engine.build(latency_scale=args.latency_scale, seed=args.seed)
    except (ValueError, NotImplementedError) as err:
        raise SystemExit(f"invalid flag combination: {err}") from err
    return engine


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
        engine = _live_engine(args)
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

    if args.latency_scale is None:
        args.latency_scale = 0.0
    cfg = _make_config(args)
    topo = _build_topology(args)
    try:
        decision = select_plan(
            topo, cfg, backend=args.plan_backend or args.device,
            max_lanes=args.max_lanes, min_fill=args.min_fill,
            remainder=args.remainder,
            probe="aot" if args.probe else "analytic",
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


def cmd_doctor(args) -> int:
    """``doctor``: rule-based health verdicts (``obs/health.py``) over
    saved manifests (either package's), the recorded baselines, and/or a
    live telemetry run on ``--device``.  Exit code 1 on any failing check
    (warnings too under ``--strict``) — the CI contract."""
    from flow_updating_tpu_torch.obs import health

    _refuse_later_flags(args)
    checks = []
    for path in args.reports:
        try:
            with open(path) as f:
                manifest = json.load(f)
        except (OSError, ValueError) as err:
            raise SystemExit(f"doctor: cannot read {path}: {err}") from err
        for c in health.diagnose_manifest(manifest):
            c.evidence.setdefault("source", path)
            checks.append(c)
    if args.baselines is not None:
        try:
            with open(args.baselines) as f:
                data = json.load(f)
        except (OSError, ValueError) as err:
            raise SystemExit(
                f"doctor: cannot read baselines {args.baselines}: {err}"
            ) from err
        c = health.check_baselines(data)
        c.evidence.setdefault("source", args.baselines)
        checks.append(c)
    if args.generator or args.deployment:
        from flow_updating_tpu_torch.obs.report import environment_info
        from flow_updating_tpu_torch.obs.telemetry import TelemetrySpec

        engine = _live_engine(args)
        try:
            series = engine.run_telemetry(args.rounds,
                                          TelemetrySpec.full())
        except (ValueError, NotImplementedError) as err:
            raise SystemExit(f"doctor: {err}") from err
        dtype = engine.config.dtype
        checks.extend(health.diagnose_series(
            series, threshold=args.rmse_threshold, dtype=dtype))
        checks.append(health.check_environment(
            environment_info(engine.device), config={"dtype": dtype}))
        # as run's printed report: check_report scales its mass tolerance
        # by true_mean x nodes, and a bare report would be judged at
        # scale 1.0
        report = engine.convergence_report()
        report["true_mean"] = engine.topology.true_mean
        report["nodes"] = engine.topology.num_nodes
        checks.append(health.check_report(report, dtype=dtype))
    if not checks:
        raise SystemExit(
            "doctor: nothing to judge — pass saved report paths, "
            "--baselines, --golden, or a topology (--generator/"
            "--deployment) for a live run")
    print(json.dumps({"overall": health.overall(checks),
                      "checks": [c.to_jsonable() for c in checks]}))
    return health.exit_code(checks, strict=args.strict)


def _csv_list(text, cast, flag: str):
    if text is None:
        return (None,)
    try:
        vals = tuple(cast(v) for v in text.split(",") if v.strip())
    except ValueError:
        raise SystemExit(f"{flag} {text!r}: expected a comma list of "
                         f"{cast.__name__} values") from None
    if not vals:
        raise SystemExit(f"{flag} {text!r}: no values")
    return vals


def cmd_profile(args) -> int:
    """``profile``: cost attribution of the configured kernel's rounds
    on ``--device`` (:meth:`Engine.profile`), printed as JSON and, with
    ``--report``, written as a ``flow-updating-profile-report/v1``
    manifest (with ``--roofline``, its ``perf_lens`` block)."""
    _check_run_flags(args)
    engine = _new_engine(args, _make_config(args))
    try:
        engine.build(latency_scale=args.latency_scale, seed=args.seed)
        prof = engine.profile(args.rounds, execute=not args.no_execute,
                              trace_dir=args.trace_dir,
                              roofline=args.roofline)
    except (ValueError, NotImplementedError) as err:
        raise SystemExit(f"profile: {err}") from err
    if args.report:
        from flow_updating_tpu_torch.obs.report import (
            build_profile_manifest,
            write_report,
        )

        extra = None
        rl = prof.get("roofline")
        if isinstance(rl, dict):
            # the reconciled record as the manifest's perf-lens block, so
            # `doctor` judges roofline_sane / roofline_floor
            from flow_updating_tpu_torch.obs import roofline as _roof

            extra = {"perf_lens": _roof.perf_lens_block(
                [rl], _roof.resolve_model(engine.device))}
        write_report(args.report, build_profile_manifest(
            argv=getattr(args, "_argv", None), config=engine.config,
            topo=engine.topology, profile=prof, extra=extra,
            device=engine.device))
        prof["report_path"] = args.report
    print(json.dumps(prof))
    return 0


def cmd_regress(args) -> int:
    """``regress``: gate a fresh bench result / profile manifest against
    the artifact history (obs/regress.py); exit 1 beyond the recorded
    spread."""
    from flow_updating_tpu_torch.obs import health, regress

    def _load(path):
        try:
            with open(path) as f:
                return json.load(f)
        except (OSError, ValueError) as err:
            raise SystemExit(f"regress: cannot read {path}: {err}") from err

    fresh = _load(args.fresh)
    against = _load(args.against) if args.against else None
    checks = regress.gate(fresh, history_pattern=args.history,
                          against=against, margin_pct=args.margin)
    print(json.dumps({"overall": health.overall(checks),
                      "checks": [c.to_jsonable() for c in checks]}))
    return health.exit_code(checks)


def cmd_sweep(args) -> int:
    """``sweep``: a grid of (topology, seed, params) instances packed into
    shape buckets, each bucket's lanes advanced together on ``--device``
    (``flow_updating_tpu_torch.sweep``).  Prints the summary as JSON;
    ``--report`` writes the ``flow-updating-sweep-report/v1`` manifest."""
    import dataclasses

    import numpy as np

    from flow_updating_tpu_torch.models.config import RoundConfig
    from flow_updating_tpu_torch.obs.telemetry import TelemetrySpec
    from flow_updating_tpu_torch.sweep import grid_instances, run_sweep
    from flow_updating_tpu_torch.topology.generators import (
        topology_from_spec,
    )

    _refuse_later_flags(args)
    topos = []
    for spec in args.generator:
        try:
            topos.append((spec, topology_from_spec(spec, seed=args.seed)))
        except (ValueError, NotImplementedError) as err:
            raise SystemExit(str(err)) from err
    drop_rates = _csv_list(args.drop_rates, float, "--drop-rates")
    timeouts = _csv_list(args.timeouts, int, "--timeouts")
    latency_scales = _csv_list(args.latency_scales, float,
                               "--latency-scales")
    maker = (RoundConfig.reference if args.fire_policy == "reference"
             else RoundConfig.fast)
    try:
        cfg = maker(variant=args.variant, dtype=args.dtype)
        ls_max = max((ls for ls in latency_scales if ls is not None),
                     default=0.0)
        if ls_max > 0:
            # the ring buffer must cover the worst scaled delay, or the
            # clamp flattens the latency sweep
            need = int(np.ceil(max(t.max_delay for _, t in topos) * ls_max))
            cfg = dataclasses.replace(
                cfg, delay_depth=max(cfg.delay_depth, need))
    except ValueError as err:
        raise SystemExit(f"invalid flag combination: {err}") from err

    seeds = [args.seed + i for i in range(max(1, args.seeds))]
    instances = grid_instances(topos, seeds=seeds, drop_rates=drop_rates,
                               timeouts=timeouts,
                               latency_scales=latency_scales)
    spec = TelemetrySpec.default()
    if args.telemetry is not None:
        try:
            spec = TelemetrySpec.parse(args.telemetry)
        except ValueError as err:
            raise SystemExit(f"--telemetry: {err}") from err
    t0 = time.perf_counter()
    try:
        records, summary = run_sweep(
            instances, cfg, args.rounds, spec=spec,
            rmse_threshold=args.rmse_threshold,
            max_batch=args.max_batch or None,
            include_series=args.include_series, profile=args.profile,
            device=args.device)
    except ValueError as err:
        raise SystemExit(f"invalid sweep configuration: {err}") from err
    wall_s = time.perf_counter() - t0

    out = dict(summary)
    out["wall_s"] = round(wall_s, 6)
    exits = [r["convergence"]["converged_round"] for r in records
             if r["convergence"]["converged"]]
    out["median_exit_round"] = int(np.median(exits)) if exits else None
    if args.report:
        from flow_updating_tpu_torch.obs.report import (
            build_sweep_manifest,
            write_report,
        )

        write_report(args.report, build_sweep_manifest(
            argv=getattr(args, "_argv", None), config=cfg,
            instances=records, summary=summary,
            timings={"wall_s": round(wall_s, 6)}, device=args.device))
        out["report_path"] = args.report
    print(json.dumps(out))
    return 0


def cmd_scenarios(args) -> int:
    """``scenarios``: the adversarial conformance suite
    (``flow_updating_tpu_torch.scenarios``) — run registered scenarios on
    ``--device`` (each a seed grid under the sweep engine plus one
    field-recorded blame run), write the
    ``flow-updating-scenario-report/v1`` manifest, and judge every
    scenario's declared signature.  Exit 1 on any failing clause (on a
    warning too under ``--strict``)."""
    from flow_updating_tpu_torch.aggregates import AGG_SCENARIOS
    from flow_updating_tpu_torch.scenarios.registry import (
        REGISTRY,
        get_scenario,
    )

    if args.list:
        listing = {
            name: {
                "summary": scn.summary,
                "rounds": scn.rounds,
                "rmse_threshold": scn.rmse_threshold,
                "config": dict(scn.config),
                "signature": [dict(c) for c in scn.signature],
            } for name, scn in REGISTRY.items()}
        for name, scn in AGG_SCENARIOS.items():
            rec = scn.describe()
            rec.pop("name", None)
            listing[name] = rec
        print(json.dumps(listing))
        return 0
    names = list(args.names) or None
    agg_names = [n for n in (names or []) if n in AGG_SCENARIOS]
    if agg_names:
        # the per-kind aggregate fault cases run one mixed-kind fabric
        # each, not a seed grid: the whole invocation goes to that runner
        if len(agg_names) != len(names):
            raise SystemExit(
                "scenarios: aggregate scenarios "
                f"({', '.join(agg_names)}) cannot mix with sweep-grid "
                "scenarios in one invocation")
        return _run_aggregate_scenarios_cli(args, names)
    for n in names or ():
        try:
            get_scenario(n)
        except ValueError as err:
            raise SystemExit(f"scenarios: {err}") from err
    from flow_updating_tpu_torch.obs import health
    from flow_updating_tpu_torch.scenarios.run import (
        run_scenarios,
        scenario_manifest,
    )

    seeds = [args.seed + i for i in range(max(1, args.seeds))]
    try:
        records, summary = run_scenarios(
            names, seeds=seeds, perturb=args.perturb,
            max_batch=args.max_batch or None, device=args.device)
    except ValueError as err:
        raise SystemExit(f"scenarios: {err}") from err
    manifest = scenario_manifest(records, summary,
                                 argv=getattr(args, "_argv", None),
                                 device=args.device)
    if args.report:
        from flow_updating_tpu_torch.obs.report import write_report

        write_report(args.report, manifest)
    checks = health.check_scenario_conformance(manifest)
    out = {
        "overall": health.overall(checks),
        "scenarios": summary["scenarios"],
        "seeds": summary["seeds"],
        "sweep_compiles": summary["sweep_compiles"],
        "wall_s": summary["wall_s"],
        "checks": [c.to_jsonable() for c in checks],
    }
    if args.perturb:
        out["perturb"] = args.perturb
    if args.report:
        out["report_path"] = args.report
    print(json.dumps(out))
    return health.exit_code(checks, strict=args.strict)


def _run_aggregate_scenarios_cli(args, names) -> int:
    """The ``scenarios`` body for the aggregate-kind fault cases: each
    named case's mixed-kind fabric under its planted adversary on
    ``--device``, the per-kind ``agg_*`` clauses judged, exit 1 on any
    failing clause (``--perturb remove_adversary`` is the negative
    control and fails by design)."""
    if args.perturb and args.perturb != "remove_adversary":
        raise SystemExit(
            f"scenarios: aggregate scenarios support --perturb "
            f"remove_adversary only (got {args.perturb!r})")
    from flow_updating_tpu_torch.aggregates import (
        aggregate_scenario_manifest,
        run_aggregate_scenarios,
    )
    from flow_updating_tpu_torch.obs import health
    from flow_updating_tpu_torch.utils.device import resolve_device

    try:
        resolve_device(args.device)
    except RuntimeError as err:
        raise SystemExit(str(err)) from err
    t0 = time.perf_counter()
    records, summary = run_aggregate_scenarios(
        names, perturb=args.perturb or None, device=args.device)
    manifest = aggregate_scenario_manifest(
        records, summary, argv=getattr(args, "_argv", None),
        device=args.device)
    if args.report:
        from flow_updating_tpu_torch.obs.report import write_report

        write_report(args.report, manifest)
    checks = health.check_scenario_conformance(manifest)
    out = {
        "overall": health.overall(checks),
        "scenarios": summary["scenarios"],
        "kinds": summary["kinds"],
        "wall_s": round(time.perf_counter() - t0, 3),
        "checks": [c.to_jsonable() for c in checks],
    }
    if args.perturb:
        out["perturb"] = args.perturb
    if args.report:
        out["report_path"] = args.report
    print(json.dumps(out))
    return health.exit_code(checks, strict=args.strict)


def _parse_service_events(lines):
    """Parse a ``serve`` event script into (lineno, verb, args) tuples.

    Grammar (one event per line, ``#`` comments):

    ``run K`` | ``join V[,V...]`` | ``leave IDS`` | ``update ID V[,V...]``
    | ``add-edge U V`` | ``remove-edge U V`` | ``suspend IDS`` |
    ``resume IDS`` | ``estimates [MAX_STALENESS]`` | ``checkpoint PATH``
    """
    def _ids(tok):
        return [int(x) for x in tok.split(",")]

    def _vals(tok):
        v = [float(x) for x in tok.split(",")]
        return v[0] if len(v) == 1 else v

    out = []
    for lineno, raw in enumerate(lines, start=1):
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        toks = line.split()
        verb, rest = toks[0], toks[1:]
        try:
            if verb == "run":
                out.append((lineno, "run", (int(rest[0]),)))
            elif verb == "join":
                out.append((lineno, "join", (_vals(rest[0]),)))
            elif verb in ("leave", "suspend", "resume"):
                out.append((lineno, verb, (_ids(rest[0]),)))
            elif verb == "update":
                out.append((lineno, "update", (_ids(rest[0]),
                                               _vals(rest[1]))))
            elif verb in ("add-edge", "remove-edge"):
                out.append((lineno, verb, (int(rest[0]), int(rest[1]))))
            elif verb == "estimates":
                k = int(rest[0]) if rest else None
                out.append((lineno, "estimates", (k,)))
            elif verb == "checkpoint":
                out.append((lineno, "checkpoint", (rest[0],)))
            else:
                raise SystemExit(
                    f"events line {lineno}: unknown verb {verb!r} "
                    "(valid: run, join, leave, update, add-edge, "
                    "remove-edge, suspend, resume, estimates, "
                    "checkpoint)")
        except (IndexError, ValueError) as err:
            raise SystemExit(
                f"events line {lineno}: cannot parse {line!r} ({err})"
            ) from err
    return out


def _apply_service_event(svc, verb: str, a, joined: list) -> None:
    """Apply one parsed event-script line to ``svc`` (a join's slot is
    appended to ``joined``; an ``estimates`` read prints one JSON line)."""
    import numpy as np

    if verb == "run":
        svc.run(a[0])
    elif verb == "join":
        joined.append(svc.join(np.asarray(a[0])))
    elif verb == "leave":
        svc.leave(a[0])
    elif verb == "suspend":
        svc.suspend(a[0])
    elif verb == "resume":
        svc.resume(a[0])
    elif verb == "update":
        ids = a[0]
        vals = np.asarray([a[1]] * len(ids))
        if svc.feature_shape and np.ndim(a[1]) == 0:
            raise ValueError(f"scalar update value for feature shape "
                             f"{svc.feature_shape}")
        svc.update(ids, vals)
    elif verb == "add-edge":
        svc.add_edges([a])
    elif verb == "remove-edge":
        svc.remove_edges([a])
    elif verb == "estimates":
        ids, est = svc.estimates(max_staleness=a[0])
        print(json.dumps({"t": svc.clock, "live": len(ids),
                          "mean_estimate": float(np.mean(est)),
                          "max_staleness": a[0]}))
    elif verb == "checkpoint":
        svc.save_checkpoint(a[0])


def cmd_serve(args) -> int:
    """``serve``: the streaming service — one set of tensors at a fixed
    capacity on ``--device``, scripted (or stdin) membership events
    applied as indexed writes between segments, one dispatch signature
    throughout (``flow_updating_tpu_torch.service``).  Prints one JSON
    summary; ``--report`` writes a ``flow-updating-service-report/v1``
    manifest, ``--metrics`` the Prometheus text, ``--wal`` journals and
    rings, ``--recover`` rebuilds from a journal."""
    from flow_updating_tpu_torch.models.config import RoundConfig
    from flow_updating_tpu_torch.service import ServiceEngine
    from flow_updating_tpu_torch.utils.device import resolve_device

    _refuse_later_flags(args)
    try:
        resolve_device(args.device)
    except RuntimeError as err:
        raise SystemExit(str(err)) from err
    t_start = time.perf_counter()
    if args.recover:
        if not args.wal:
            raise SystemExit(
                "serve: --recover needs --wal DIR (the durability "
                "directory the crashed service was journaling into)")
        try:
            svc = ServiceEngine.recover(args.wal, device=args.device)
        except ValueError as err:
            raise SystemExit(f"serve: {err}") from err
        topo = None
    elif args.resume:
        try:
            svc = ServiceEngine.restore_checkpoint(args.resume,
                                                   device=args.device)
        except ValueError as err:
            raise SystemExit(f"serve: {err}") from err
        topo = None
    else:
        topo = _build_topology(args)
        maker = (RoundConfig.reference
                 if args.fire_policy == "reference" else RoundConfig.fast)
        kw = dict(variant="collectall", dtype=args.dtype,
                  drop_rate=args.drop_rate, drain=0)
        if args.timeout is not None:
            kw["timeout"] = args.timeout
        if args.fire_policy == "reference":
            kw["pending_depth"] = 1
        try:
            cfg = maker(**kw)
            svc = ServiceEngine(
                topo, args.capacity or topo.num_nodes,
                degree_budget=args.degree_budget or None,
                edge_capacity=args.edge_capacity or None,
                config=cfg, segment_rounds=args.segment_rounds,
                seed=args.seed, device=args.device)
        except ValueError as err:
            raise SystemExit(
                f"invalid service configuration: {err}") from err
    setup_s = time.perf_counter() - t_start
    if args.wal and not args.recover:
        try:
            svc.enable_durability(args.wal,
                                  checkpoint_every=args.checkpoint_every,
                                  retain=args.retain)
        except (ValueError, OSError) as err:
            raise SystemExit(
                f"serve: cannot arm durability: {err}") from err

    if args.events == "-":
        events = _parse_service_events(sys.stdin.readlines())
    elif args.events:
        try:
            with open(args.events) as f:
                events = _parse_service_events(f.readlines())
        except OSError as err:
            raise SystemExit(f"serve: cannot read events: {err}") from err
    else:
        events = []

    # --trace-dir captures the whole serving body (event script +
    # trailing rounds) as one torch.profiler trace; the fu.segment spans
    # (service/engine.py) land inside it
    from flow_updating_tpu_torch.utils.trace import trace

    joined = []
    with trace(args.trace_dir):
        for lineno, verb, a in events:
            try:
                _apply_service_event(svc, verb, a, joined)
            except (ValueError, RuntimeError) as err:
                raise SystemExit(
                    f"serve: events line {lineno}: {err}") from err
        if args.rounds:
            try:
                svc.run(args.rounds)
            except ValueError as err:
                raise SystemExit(f"serve: {err}") from err

    report = svc.convergence_report()
    timings = {"setup_s": setup_s}
    if args.checkpoint:
        t0 = time.perf_counter()
        svc.save_checkpoint(args.checkpoint)
        timings["checkpoint_s"] = time.perf_counter() - t0
    block = svc.service_block()
    out = {
        "t": svc.clock,
        "live": svc.live_count,
        "members": svc.member_count,
        "epochs": len(svc.history),
        "events": block["events_total"],
        "compile_count": block["compile_count"],
        "rmse": report["rmse"],
        "mass_residual": report["mass_residual"],
    }
    if joined:
        out["joined"] = joined
    resil = svc.resilience_block()
    if resil is not None:
        out["durability"] = {
            "dir": resil.get("dir"),
            "wal_seq": (resil.get("wal") or {}).get("last_seq"),
            "recovered": svc._recovery is not None,
        }
    # the flight recorder: built after the resilience block so doctor's
    # metrics_consistency compares same-moment facts
    trace = svc.serving_trace_block()
    if args.metrics:
        if svc.metrics is None:
            raise SystemExit(
                "serve: --metrics needs the flight recorder (it is on "
                "by default; this engine was restored from an archive "
                "written without it)")
        with open(args.metrics, "w") as f:
            f.write(svc.metrics.to_prometheus())
        out["metrics_path"] = args.metrics
    if args.report:
        from flow_updating_tpu_torch.obs.report import (
            build_service_manifest,
            write_report,
        )

        extra = {}
        if resil is not None:
            extra["recovery"] = resil
        if trace is not None:
            extra["serving_trace"] = trace
        write_report(args.report, build_service_manifest(
            argv=getattr(args, "_argv", None), config=svc.config,
            topo=topo, service=block, series=svc.boundary_series(),
            report=report, extra=extra or None, device=svc.device,
            timings={**timings, "wall_s": time.perf_counter() - t_start}))
        out["report_path"] = args.report
    print(json.dumps(out))
    return 0


def cmd_query(args) -> int:
    """``query``: the multi-tenant query fabric — one set of
    ``(capacity, lanes)`` service tensors on ``--device`` serving a
    stream of cohort aggregates: Poisson arrivals admit into free lanes
    (one dispatch signature), per-lane convergence retires and recycles
    lanes between segments (``flow_updating_tpu_torch.query``)."""
    import numpy as np

    from flow_updating_tpu_torch.models.config import RoundConfig
    from flow_updating_tpu_torch.query import QueryFabric
    from flow_updating_tpu_torch.utils.device import resolve_device

    try:
        resolve_device(args.device)
    except RuntimeError as err:
        raise SystemExit(str(err)) from err
    t_start = time.perf_counter()
    if args.recover:
        if not args.wal:
            raise SystemExit(
                "query: --recover needs --wal DIR (the durability "
                "directory the crashed fabric was journaling into)")
        try:
            fab = QueryFabric.recover(args.wal, device=args.device)
        except ValueError as err:
            raise SystemExit(f"query: {err}") from err
        topo = None
    elif args.resume:
        try:
            fab = QueryFabric.restore_checkpoint(args.resume,
                                                 device=args.device)
        except ValueError as err:
            raise SystemExit(f"query: {err}") from err
        topo = None
    else:
        topo = _build_topology(args)
        maker = (RoundConfig.reference
                 if args.fire_policy == "reference" else RoundConfig.fast)
        kw = dict(variant="collectall", dtype=args.dtype,
                  drop_rate=args.drop_rate, drain=0)
        if args.timeout is not None:
            kw["timeout"] = args.timeout
        if args.fire_policy == "reference":
            kw["pending_depth"] = 1
        mix = None
        if args.mixing:
            # the a-priori spectral gap prices admissions (and fills the
            # manifest's mixing block)
            from flow_updating_tpu_torch.obs.spectral import mixing_report

            mix = mixing_report(topo, eps=args.eps, device=args.device)
        try:
            cfg = maker(**kw)
            fab = QueryFabric(
                topo, lanes=args.lanes,
                capacity=args.capacity or None,
                degree_budget=args.degree_budget or None,
                edge_capacity=args.edge_capacity or None,
                config=cfg, segment_rounds=args.segment_rounds,
                seed=args.seed, conv_eps=args.eps,
                admission_slo_rounds=args.admission_slo or None,
                convergence_slo_rounds=args.convergence_slo or None,
                forecast=False if args.no_forecast else None,
                admit_policy=args.admit_policy, mixing=mix,
                device=args.device)
        except ValueError as err:
            raise SystemExit(f"invalid query configuration: {err}") from err
    setup_s = time.perf_counter() - t_start
    if args.watchdog and fab._watchdog is None:
        fab.attach_watchdog()
    if args.wal and not args.recover:
        try:
            fab.enable_durability(args.wal,
                                  checkpoint_every=args.checkpoint_every,
                                  retain=args.retain)
        except (ValueError, OSError) as err:
            raise SystemExit(f"query: cannot arm durability: {err}") from err

    # Poisson arrivals: random-cohort mean queries submitted at
    # --arrival-rate a round until --queries have been offered, then
    # drain (stop early once every query retires)
    rng = np.random.default_rng(args.seed + 1)
    seg = fab.svc.segment_rounds
    t0 = time.perf_counter()
    submitted = rounds_run = 0
    while rounds_run < args.rounds:
        arrivals = min(int(rng.poisson(args.arrival_rate * seg)),
                       args.queries - submitted)
        if arrivals:
            members = fab.svc.live_ids()
            m = max(1, int(round(len(members) * args.cohort_frac)))
        for _ in range(arrivals):
            cohort = rng.choice(members, size=m, replace=False)
            fab.submit(rng.random(m), cohort=np.sort(cohort))
            submitted += 1
        try:
            fab.run(seg)
        except ValueError as err:
            raise SystemExit(f"query: {err}") from err
        rounds_run += seg
        if args.queries and submitted >= args.queries \
                and not fab.active_lanes and not fab.queued:
            break
    wall_s = time.perf_counter() - t0

    block = fab.query_block()
    out = {
        "t": fab.clock,
        "lanes": fab.lanes,
        "submitted": submitted,
        "completed": block["retired_total"],
        "active": block["lanes"]["active"],
        "queued": block["lanes"]["queued"],
        "compile_count": block["compile_count"],
        "admission_p95": block["admission_latency"].get("p95"),
        "wall_s": round(wall_s, 3),
    }
    fb = block.get("forecast")
    if isinstance(fb, dict) and fb.get("enabled"):
        out["at_risk"] = fb["at_risk_total"]
        out["deferred"] = fb["deferred_total"]
        if fb.get("p90_abs_log_ratio") is not None:
            out["forecast_p90_abs_log_ratio"] = fb["p90_abs_log_ratio"]
    timings = {"setup_s": setup_s, "wall_s": wall_s}
    if args.checkpoint:
        t1 = time.perf_counter()
        fab.save_checkpoint(args.checkpoint)
        timings["checkpoint_s"] = time.perf_counter() - t1
    resil = fab.resilience_block()
    if resil is not None:
        out["durability"] = {
            "dir": resil.get("dir"),
            "wal_seq": (resil.get("wal") or {}).get("last_seq"),
            "recovered": fab._recovery is not None,
            "quarantined": fab.quarantined_total,
        }
    # the flight recorder: built after the resilience block so doctor's
    # metrics_consistency compares same-moment facts
    trace = fab.serving_trace_block()
    if args.metrics:
        if fab.metrics is None:
            raise SystemExit(
                "query: --metrics needs the flight recorder (it is on "
                "by default; this fabric was restored from an archive "
                "written without it)")
        with open(args.metrics, "w") as f:
            f.write(fab.metrics.to_prometheus())
        out["metrics_path"] = args.metrics
    if args.report:
        from flow_updating_tpu_torch.obs.report import (
            build_query_manifest,
            write_report,
        )

        extra = {}
        if resil is not None:
            extra["recovery"] = resil
        if trace is not None:
            extra["serving_trace"] = trace
        write_report(args.report, build_query_manifest(
            argv=getattr(args, "_argv", None), config=fab.svc.config,
            topo=topo, query=block, timings=timings,
            extra=extra or None, device=fab.device))
        out["report_path"] = args.report
    print(json.dumps(out))
    return 0


def cmd_chaos(args) -> int:
    """``chaos``: the infrastructure-fault conformance suite
    (:mod:`flow_updating_tpu_torch.resilience.chaos`) — inject each
    registered fault into a real subprocess run on ``--device``, exercise
    the declared recovery machinery, doctor-assert the recovery signature
    and require ``inspect --blame`` to name the planted fault at rank 1.
    With ``--perturb`` the recovery is disabled and the signature is
    EXPECTED to fail (the negative control).  Exit 1 on any violated
    contract."""
    from flow_updating_tpu_torch.resilience.chaos import (
        CHAOS_REGISTRY,
        get_fault,
        run_chaos,
    )
    from flow_updating_tpu_torch.utils.device import resolve_device

    if args.list:
        print(json.dumps({
            name: {"summary": f.summary, "kind": f.kind,
                   "kill": f.kill, "tamper": f.tamper,
                   "inject": f.inject, "watchdog": f.watchdog}
            for name, f in CHAOS_REGISTRY.items()}))
        return 0
    names = list(args.names) or sorted(CHAOS_REGISTRY)
    for n in names:
        try:
            get_fault(n)
        except ValueError as err:
            raise SystemExit(f"chaos: {err}") from err
    try:
        device = resolve_device(args.device)
    except RuntimeError as err:
        raise SystemExit(str(err)) from err
    results, bad = [], []
    for n in names:
        try:
            out = run_chaos(
                n, nodes=args.nodes, lanes=args.lanes,
                segment_rounds=args.segment_rounds, n_ops=args.ops,
                seed=args.seed, outdir=args.outdir,
                perturb=args.perturb, device=device)
        except (ValueError, RuntimeError) as err:
            raise SystemExit(f"chaos: {n}: {err}") from err
        if args.perturb:
            # the recovery-disabled control MUST fail its signature
            ok = out["exit_code"] != 0
        else:
            ok = out["exit_code"] == 0 and out["blame_top"] == n
        if not ok:
            bad.append(n)
        results.append({k: out[k] for k in
                        ("fault", "perturb", "overall", "blame_top",
                         "manifest_path")})
    print(json.dumps({
        "faults": names,
        "perturb": bool(args.perturb),
        "violations": bad,
        "results": results,
    }))
    return 1 if bad else 0


def _add_durability_flags(p, prog: str) -> None:
    """The crash-safety flag set ``serve`` and ``query`` share."""
    p.add_argument("--wal", metavar="DIR",
                   help="durability directory: journal every event in "
                        "an fsync'd CRC-framed WAL and write automatic "
                        "ring checkpoints — a SIGKILL at any point "
                        f"recovers bit-exactly via `{prog} --wal DIR "
                        "--recover`")
    p.add_argument("--checkpoint-every", type=int, default=8,
                   metavar="K",
                   help="ring cadence: one checkpoint every K segments "
                        "(with --wal)")
    p.add_argument("--retain", type=int, default=3, metavar="N",
                   help="ring retention: keep the newest N checkpoints "
                        "(corrupt newest falls back to next)")
    p.add_argument("--recover", action="store_true",
                   help="rebuild the engine from --wal DIR (newest "
                        "valid ring checkpoint + WAL replay) instead "
                        "of building fresh")


def _add_topology_flags(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--platform", help="SimGrid-style platform XML")
    ap.add_argument("--deployment", help="SimGrid-style deployment XML")
    ap.add_argument("--generator", help="synthetic topology, e.g. "
                    "'erdos_renyi:10000', 'fat_tree:160', 'ring:100:2'")
    ap.add_argument("--seed", type=int, default=0)


def _add_config_flags(ap: argparse.ArgumentParser) -> None:
    """The round-config flags ``run``, ``plan``, ``inspect`` and
    ``doctor`` share."""
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
    """The multi-shard flags ``run``, ``inspect`` and ``doctor`` share."""
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
    run.add_argument("--profile", metavar="DIR",
                     help="capture the run's rounds as a torch.profiler "
                          "trace into DIR (the same capture as "
                          "--trace-dir, which wins when both are given)")
    run.add_argument("--trace-dir", metavar="DIR",
                     help="capture the run's rounds as one gzipped Chrome "
                          "trace (torch.profiler: host ops and the card's "
                          "kernels and copies) into DIR")
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
                    help="rank candidates by the bytes a round of each "
                         "one's program moves, counted on --device "
                         "(obs/profile.py) instead of the analytic model")
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

    sw = sub.add_parser(
        "sweep",
        help="batched multi-instance parameter sweep: pack a grid of "
             "(topology, seed, params) instances into shape buckets and "
             "advance each bucket's lanes together on --device")
    sw.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the buckets run: the CUDA card (default) "
                         "or the host CPU")
    sw.add_argument("--backend", default="auto",
                    choices=("auto", "cpu", "jax_tpu"),
                    help="accepted for command-line compatibility with "
                         "the JAX CLI; no effect (see --device)")
    sw.add_argument("--generator", action="append", required=True,
                    metavar="SPEC",
                    help="synthetic topology, e.g. 'ring:64:2' or "
                         "'fat_tree:32' — repeat the flag to sweep "
                         "several topologies")
    sw.add_argument("--seed", type=int, default=0,
                    help="base seed (topology values + first instance "
                         "seed)")
    sw.add_argument("--seeds", type=int, default=1,
                    help="instance seeds per grid point: seed, seed+1, "
                         "... (independent message-loss realizations)")
    sw.add_argument("--drop-rates", metavar="CSV",
                    help="comma list of per-message loss probabilities "
                         "(one lane parameter each)")
    sw.add_argument("--timeouts", metavar="CSV",
                    help="comma list of timeout values (one lane "
                         "parameter each)")
    sw.add_argument("--latency-scales", metavar="CSV",
                    help="comma list of delay multipliers (scales each "
                         "topology's static per-edge delays; delay_depth "
                         "is sized to cover the largest)")
    sw.add_argument("--variant", default="collectall",
                    choices=("collectall", "pairwise"))
    sw.add_argument("--fire-policy", default="reference",
                    choices=("reference", "every_round"))
    sw.add_argument("--dtype", default="float32",
                    choices=("float32", "float64"))
    sw.add_argument("--rounds", type=int, default=200,
                    help="rounds per instance (every lane runs the full "
                         "count; converged lanes record their effective "
                         "early-exit round)")
    sw.add_argument("--rmse-threshold", type=float, default=1e-6,
                    help="per-instance convergence threshold for the "
                         "early-exit round")
    sw.add_argument("--max-batch", type=int, default=0,
                    help="cap lanes per bucket (0 = unbounded)")
    sw.add_argument("--telemetry", nargs="?", const="default",
                    metavar="METRICS",
                    help="per-instance metric selection (as in `run`; "
                         "must include rmse)")
    sw.add_argument("--include-series", action="store_true",
                    help="embed each instance's full per-round series "
                         "in the manifest records (large)")
    sw.add_argument("--profile", action="store_true",
                    help="per-bucket cost attribution: each bucket's "
                         "rounds counted once more (bytes, flops, "
                         "kernels' declared work) into the summary's "
                         "buckets (obs/profile.py)")
    sw.add_argument("--report", metavar="PATH",
                    help="write the flow-updating-sweep-report/v1 "
                         "manifest (one record per instance) to PATH")
    sw.set_defaults(fn=cmd_sweep)

    sc = sub.add_parser(
        "scenarios",
        help="adversarial conformance suite: run registered scenarios "
             "(conductance-bottleneck bridges, Byzantine nodes, "
             "correlated failures) under the sweep engine on --device, "
             "blame the planted adversary, and assert each declared "
             "signature — flow-updating-scenario-report/v1 manifests")
    sc.add_argument("names", nargs="*", metavar="SCENARIO",
                    help="registered scenario names (default: the whole "
                         "registry; see --list)")
    sc.add_argument("--list", action="store_true",
                    help="print the registry (name, summary, config, "
                         "declared signature) and exit")
    sc.add_argument("--seeds", type=int, default=2, metavar="K",
                    help="seeds per scenario (the sweep grid width)")
    sc.add_argument("--seed", type=int, default=0,
                    help="base seed (seeds are seed..seed+K-1)")
    sc.add_argument("--perturb",
                    choices=("remove_adversary", "no_heal"),
                    help="negative control: withdraw the planted fault "
                         "(or never heal the partition) — signatures "
                         "are EXPECTED to fail")
    sc.add_argument("--max-batch", type=int, default=0, metavar="B",
                    help="cap sweep lanes per bucket (0 = unbounded)")
    sc.add_argument("--report", metavar="PATH",
                    help="write the flow-updating-scenario-report/v1 "
                         "manifest to PATH")
    sc.add_argument("--strict", action="store_true",
                    help="exit 1 on warnings too")
    sc.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the scenarios run: the CUDA card "
                         "(default) or the host CPU")
    sc.add_argument("--backend", default="auto",
                    choices=("auto", "cpu", "jax_tpu"),
                    help="accepted for command-line compatibility with "
                         "the JAX CLI; no effect (see --device)")
    sc.set_defaults(fn=cmd_scenarios)

    sv = sub.add_parser(
        "serve",
        help="streaming service: one set of tensors at a fixed capacity "
             "runs in segments on --device while members join, leave, "
             "update values and rewire edges between segments — one "
             "dispatch signature, per-feature mass conserved, "
             "doctor-checkable flow-updating-service-report/v1 manifests")
    sv.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the service runs: the CUDA card (default) "
                         "or the host CPU")
    sv.add_argument("--backend", default="auto",
                    choices=("auto", "cpu", "jax_tpu"),
                    help="accepted for command-line compatibility with "
                         "the JAX CLI; no effect (see --device)")
    _add_topology_flags(sv)
    sv.add_argument("--capacity", type=int, default=0,
                    help="maximum concurrent members (node slots; "
                         "default: the initial topology's node count — "
                         "no join headroom)")
    sv.add_argument("--edge-capacity", type=int, default=0,
                    help="total directed edge slots (default: initial "
                         "edges + headroom for the spare node slots)")
    sv.add_argument("--degree-budget", type=int, default=0,
                    help="per-member degree budget W (row-matrix width; "
                         "default: the initial max degree — no add-edge "
                         "headroom beyond freed slots)")
    sv.add_argument("--segment-rounds", type=int, default=32,
                    help="segment length; events apply between segments "
                         "and `run` counts must be multiples")
    sv.add_argument("--rounds", type=int, default=0,
                    help="extra rounds after the event script (a whole "
                         "number of segments)")
    sv.add_argument("--events", metavar="FILE",
                    help="event script ('-' = stdin): run K / join V / "
                         "leave IDS / update IDS V / add-edge U V / "
                         "remove-edge U V / suspend IDS / resume IDS / "
                         "estimates [K] / checkpoint PATH")
    sv.add_argument("--fire-policy", default="every_round",
                    choices=("every_round", "reference"),
                    help="collect-all firing rule (the service runs "
                         "variant=collectall with unbounded drain)")
    sv.add_argument("--timeout", type=int, default=None,
                    help="collect-all tick timeout (reference firing)")
    sv.add_argument("--drop-rate", type=float, default=0.0,
                    help="per-message loss probability")
    sv.add_argument("--dtype", default="float32",
                    choices=("float32", "float64"))
    _add_durability_flags(sv, "serve")
    sv.add_argument("--resume", metavar="CKPT",
                    help="restore a service checkpoint (either package's) "
                         "instead of building from a topology (bit-exact "
                         "resume)")
    sv.add_argument("--checkpoint", metavar="PATH",
                    help="save a service checkpoint at exit")
    sv.add_argument("--report", metavar="PATH",
                    help="write the flow-updating-service-report/v1 "
                         "manifest (capacity accounting, per-epoch mass "
                         "history, dispatch-signature count) to PATH")
    sv.add_argument("--metrics", metavar="PATH",
                    help="write the flight recorder's streaming metrics "
                         "as Prometheus text exposition to PATH at exit")
    sv.add_argument("--trace-dir", metavar="DIR",
                    help="capture the serving body (events and rounds) as "
                         "one torch.profiler trace into DIR; the fu.segment "
                         "spans mark each segment")
    sv.set_defaults(fn=cmd_serve, latency_scale=0.0, msg_bytes=104.0)

    qr = sub.add_parser(
        "query",
        help="multi-tenant query fabric: concurrent cohort aggregates on "
             "one set of service tensors on --device — Poisson arrivals "
             "admit into free payload lanes (one dispatch signature), "
             "per-lane convergence retires and recycles lanes between "
             "segments, doctor-checkable flow-updating-query-report/v1 "
             "manifests")
    qr.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the fabric runs: the CUDA card (default) "
                         "or the host CPU")
    qr.add_argument("--backend", default="auto",
                    choices=("auto", "cpu", "jax_tpu"),
                    help="accepted for command-line compatibility with "
                         "the JAX CLI; no effect (see --device)")
    _add_topology_flags(qr)
    qr.add_argument("--lanes", type=int, default=64,
                    help="concurrent-query capacity (the payload width "
                         "D; admission beyond it queues)")
    qr.add_argument("--capacity", type=int, default=0,
                    help="maximum concurrent members (node slots; "
                         "default: the initial topology's node count)")
    qr.add_argument("--edge-capacity", type=int, default=0,
                    help="total directed edge slots (default: initial "
                         "edges + headroom)")
    qr.add_argument("--degree-budget", type=int, default=0,
                    help="per-member degree budget W (default: the "
                         "initial max degree)")
    qr.add_argument("--segment-rounds", type=int, default=32,
                    help="segment length; lanes admit and retire at "
                         "segment boundaries")
    qr.add_argument("--queries", type=int, default=16,
                    help="total queries to offer (0 = just run "
                         "--rounds)")
    qr.add_argument("--arrival-rate", type=float, default=0.25,
                    help="Poisson arrival rate (queries per round)")
    qr.add_argument("--cohort-frac", type=float, default=0.25,
                    help="cohort size as a fraction of live members "
                         "(random member subsets)")
    qr.add_argument("--rounds", type=int, default=4096,
                    help="round budget (the stream stops early once "
                         "every offered query retires)")
    qr.add_argument("--eps", type=float, default=1e-6,
                    help="default per-query convergence tolerance "
                         "(relative estimate spread for retirement)")
    qr.add_argument("--admission-slo", type=int, default=0,
                    help="admission-latency SLO in rounds (doctor's "
                         "query_admission budget; default: 2 segments)")
    qr.add_argument("--convergence-slo", type=int, default=0,
                    help="convergence-latency SLO in rounds (doctor's "
                         "slo_latency p95 target; default: undeclared)")
    qr.add_argument("--no-forecast", action="store_true",
                    help="disable the per-lane convergence forecaster "
                         "(on by default with the flight recorder)")
    qr.add_argument("--admit-policy", default="observe",
                    choices=("observe", "strict"),
                    help="forecast-aware admission: 'observe' flags "
                         "provably-over-SLO queries at_risk but admits "
                         "them; 'strict' defers them at the door "
                         "(needs --mixing and --convergence-slo)")
    qr.add_argument("--mixing", action="store_true",
                    help="estimate the topology's spectral gap up front "
                         "(obs/spectral.py, cached) and price admissions "
                         "against it; the manifest gains a mixing block")
    qr.add_argument("--fire-policy", default="every_round",
                    choices=("every_round", "reference"),
                    help="collect-all firing rule")
    qr.add_argument("--timeout", type=int, default=None,
                    help="collect-all tick timeout (reference firing)")
    qr.add_argument("--drop-rate", type=float, default=0.0,
                    help="per-message loss probability")
    qr.add_argument("--dtype", default="float32",
                    choices=("float32", "float64"))
    _add_durability_flags(qr, "query")
    qr.add_argument("--watchdog", action="store_true",
                    help="arm the inline lane watchdog: NaN/divergence "
                         "lanes are quarantined mass-neutrally between "
                         "segments, admissions back off when lanes are "
                         "exhausted")
    qr.add_argument("--resume", metavar="CKPT",
                    help="restore a query-fabric checkpoint (either "
                         "package's, lane tables included) instead of "
                         "building fresh")
    qr.add_argument("--checkpoint", metavar="PATH",
                    help="save a query-fabric checkpoint at exit")
    qr.add_argument("--report", metavar="PATH",
                    help="write the flow-updating-query-report/v1 "
                         "manifest (lane and dispatch accounting, "
                         "admission latency vs SLO, per-boundary "
                         "lane-mass rows) to PATH")
    qr.add_argument("--metrics", metavar="PATH",
                    help="write the flight recorder's streaming metrics "
                         "as Prometheus text exposition to PATH at exit")
    qr.set_defaults(fn=cmd_query, latency_scale=0.0, msg_bytes=104.0)

    ch = sub.add_parser(
        "chaos",
        help="infrastructure-fault conformance: inject each registered "
             "infra fault (SIGKILL, torn WAL, corrupt/bitflipped "
             "checkpoint, NaN-poisoned lane, admission storm) into a "
             "real subprocess run on --device, doctor-assert the "
             "declared recovery signature, and require blame to name "
             "the planted fault at rank 1 "
             "(flow_updating_tpu_torch.resilience.chaos)")
    ch.add_argument("names", nargs="*", metavar="FAULT",
                    help="registered fault names (default: the whole "
                         "registry; see --list)")
    ch.add_argument("--list", action="store_true",
                    help="print the fault registry and exit")
    ch.add_argument("--nodes", type=int, default=128,
                    help="scripted-run member count")
    ch.add_argument("--lanes", type=int, default=8,
                    help="query-lane capacity for fabric faults")
    ch.add_argument("--segment-rounds", type=int, default=8)
    ch.add_argument("--ops", type=int, default=28,
                    help="scripted event-stream length (one WAL record "
                         "per op)")
    ch.add_argument("--seed", type=int, default=0)
    ch.add_argument("--outdir", default="obs-artifacts",
                    help="where the flow-updating-recovery-report/v1 "
                         "manifests land")
    ch.add_argument("--perturb", action="store_true",
                    help="negative control: disable the recovery "
                         "machinery — every signature is EXPECTED to "
                         "fail")
    ch.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the children, the recoveries and the "
                         "controls run: the CUDA card (default) or the "
                         "host CPU")
    ch.set_defaults(fn=cmd_chaos)

    dr = sub.add_parser(
        "doctor",
        help="rule-based health verdicts with evidence: NaN/divergence "
             "watchdog, RMSE-stall detection, mass-conservation and "
             "antisymmetry drift, environment sanity, recorded-baseline "
             "validity — on saved manifests (either package's) and/or a "
             "live telemetry run on --device; exit 1 on any fail "
             "(obs/health.py)")
    dr.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where a live run's rounds run: the CUDA card "
                         "(default) or the host CPU")
    dr.add_argument("--backend", default="auto",
                    choices=("auto", "cpu", "jax_tpu"),
                    help="accepted for command-line compatibility with "
                         "the JAX CLI; no effect (see --device)")
    _add_topology_flags(dr)
    _add_mesh_flags(dr)
    _add_config_flags(dr)
    dr.add_argument("--plan", default="off", choices=("off", "auto"),
                    help="'auto' = the topology compiler picks the "
                         "kernel/spmv for the graph on --device")
    dr.add_argument("reports", nargs="*", metavar="REPORT.json",
                    help="saved flow-updating-*-report/v1 manifests to "
                         "judge")
    dr.add_argument("--latency-scale", type=float, default=None)
    dr.add_argument("--msg-bytes", type=float, default=104.0)
    dr.add_argument("--rounds", type=int, default=200,
                    help="live-run length (with --generator/"
                         "--deployment)")
    dr.add_argument("--rmse-threshold", type=float, default=1e-6,
                    help="convergence threshold for the stall check")
    dr.add_argument("--baselines", nargs="?",
                    const="BASELINE_MEASURED.json", metavar="PATH",
                    help="audit recorded DES baselines against the "
                         "spread validity gate (default file: "
                         "BASELINE_MEASURED.json)")
    dr.add_argument("--golden", nargs="?", const="GOLDEN_PROGRAMS.json",
                    metavar="PATH",
                    help="program_conformance: audit the golden-program "
                         "ledger (ROADMAP A14 part 2; exits naming it)")
    dr.add_argument("--strict", action="store_true",
                    help="warnings also exit 1")
    dr.set_defaults(fn=cmd_doctor)

    pr = sub.add_parser(
        "profile",
        help="cost attribution of the configured kernel's rounds: bytes "
             "and flops counted over the rounds (the kernels' declared "
             "work included), peak memory on the card, the timed run, "
             "the kernels' launches — a pure observer, the engine's state "
             "is untouched (obs/profile.py)")
    pr.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the rounds run: the CUDA card (default) "
                         "or the host CPU with the plain tensor versions")
    _add_topology_flags(pr)
    _add_mesh_flags(pr)
    _add_config_flags(pr)
    pr.add_argument("--plan", default="off", choices=("off", "auto"))
    pr.add_argument("--latency-scale", type=float, default=0.0,
                    help=">0: latency-warped delays from platform "
                         "latencies (as in `run`)")
    pr.add_argument("--msg-bytes", type=float, default=104.0)
    pr.add_argument("--rounds", type=int, default=64,
                    help="rounds to attribute (the per_round block "
                         "amortizes)")
    pr.add_argument("--no-execute", action="store_true",
                    help="skip the timed run (the counted run still runs "
                         "the rounds)")
    pr.add_argument("--report", metavar="PATH",
                    help="write the flow-updating-profile-report/v1 "
                         "manifest (argv, config, topology fingerprint, "
                         "environment, attribution) to PATH")
    pr.add_argument("--roofline", action="store_true",
                    help="compose the cost record with the device's "
                         "hardware model (obs/roofline.py): arithmetic "
                         "intensity, binding resource, predicted ceiling "
                         "and the measured-vs-ceiling roofline_frac ride "
                         "the record (and the manifest's "
                         "flow-updating-perf-lens/v1 block with --report)")
    pr.add_argument("--trace-dir", metavar="DIR",
                    help="also capture one run as a torch.profiler trace "
                         "into DIR: the device events it kept against the "
                         "kernels' launches (trace_complete), and on the "
                         "halo round's overlap schedules the overlap "
                         "ratio measured from the slices (obs/timeline.py)")
    pr.set_defaults(fn=cmd_profile)

    rg = sub.add_parser(
        "regress",
        help="perf regression gate: compare a fresh bench result line "
             "or profile manifest against the BENCH_* artifact history "
             "/ a reference manifest, flagging drops beyond the "
             "recorded spread; exit 1 on regression (obs/regress.py)")
    rg.add_argument("--fresh", required=True, metavar="PATH",
                    help="fresh bench JSON line or profile manifest")
    rg.add_argument("--against", metavar="PATH",
                    help="reference profile manifest to compare against")
    rg.add_argument("--history", default="BENCH_*.json", metavar="GLOB",
                    help="bench artifact history (default: BENCH_*.json "
                         "in the working directory)")
    rg.add_argument("--margin", type=float, default=None, metavar="PCT",
                    help="override the allowed drop/growth percentage")
    rg.set_defaults(fn=cmd_regress)
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
