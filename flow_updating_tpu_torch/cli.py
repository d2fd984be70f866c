"""Command-line driver: the ``run``, ``oracle`` and ``plan`` subcommands.

Counterpart of ``flow_updating_tpu/cli.py``'s ``run``, ``oracle`` and
``plan``.
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

    from flow_updating_tpu_torch.engine import Engine

    cfg = _make_config(args)
    telemetry_spec = _telemetry_spec(args)
    event_log = None
    if args.event_log:
        from flow_updating_tpu_torch.utils.eventlog import EventLog

        event_log = EventLog(args.event_log)
    try:
        mesh = None
        if args.shards:
            from flow_updating_tpu_torch.parallel.mesh import make_mesh

            mesh = make_mesh(args.shards, device=args.device)
        engine = Engine(config=cfg, mesh=mesh, multichip=args.multichip,
                        halo=args.halo,
                        partition=args.partition, plan=args.plan,
                        event_log=event_log, device=args.device)
    except (NotImplementedError, RuntimeError, ValueError) as err:
        raise SystemExit(str(err)) from err
    engine.set_topology(_build_topology(args))
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
    run.add_argument("--multichip", default="auto",
                     choices=("auto", "halo", "pod"),
                     help="under --shards: 'auto' = the node kernel's "
                          "sharded banded or Beneš round; 'halo' = the "
                          "edge kernel's halo round (cut-edge exchange, "
                          "--halo, --partition); 'pod' = a fat tree's "
                          "stencil sharded by pod (--spmv structured, "
                          "shards dividing k)")
    run.add_argument("--halo", default="ppermute",
                     choices=("ppermute", "allgather", "overlap",
                              "overlap_pallas", "auto"),
                     help="exchange under --shards: 'ppermute' = the "
                          "serialized schedule; the banded round overlaps "
                          "its copies for any other value; the halo round "
                          "takes each mode as named ('overlap_pallas' = "
                          "CUDA kernel B6, 'auto' = ranked by wire bytes)")
    run.add_argument("--partition", default="bfs",
                     choices=("bfs", "contiguous"))
    run.add_argument("--shards", type=int, default=0,
                     help="run over an N-shard mesh (--kernel node --spmv "
                          "banded_fused or benes_fused, --multichip pod, "
                          "or --multichip halo): shards go "
                          "round-robin over the visible cards, or all on "
                          "the host with --device cpu")
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
