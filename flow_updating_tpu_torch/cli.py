"""Command-line driver: the ``run`` subcommand.

Counterpart of ``flow_updating_tpu/cli.py``'s ``run``.  It takes the same
flags, so a JAX command line carries over, plus ``--device`` (``cuda``,
the default, or ``cpu``).  Topology from ``--platform``/``--deployment``
XML or a synthetic ``--generator``; watcher sampling every
``--observe-every`` simulated seconds until ``--until``, or exactly
``--rounds``, or ``--until-rmse``.  Prints one JSON convergence report.

Flags whose machinery is not ported yet exit with a message naming the
ROADMAP item.  ``--backend`` selects the JAX backend in the JAX package;
it is accepted here for command-line compatibility and has no effect.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import time

#: run flags of the JAX CLI that this package does not run yet -> item
_LATER_FLAGS = {
    "telemetry": "observability twins and manifests (A9)",
    "report": "observability twins and manifests (A9)",
    "event_log": "observability twins and manifests (A9)",
    "profile": "profiling and analysis (A14)",
    "trace_dir": "profiling and analysis (A14)",
    "save_checkpoint": "engine checkpoints (A7)",
    "resume": "engine checkpoints (A7)",
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
    if args.shards or args.multichip != "auto":
        raise SystemExit("--shards/--multichip is the ROADMAP item "
                         "'multi-device execution (A12, B5, B6)', not "
                         "ported yet")
    if args.latency_scale is None:
        args.latency_scale = 1.0 if args.fidelity and args.platform else 0.0

    from flow_updating_tpu_torch.engine import Engine

    cfg = _make_config(args)
    try:
        engine = Engine(config=cfg, plan=args.plan, device=args.device)
    except (NotImplementedError, RuntimeError) as err:
        raise SystemExit(str(err)) from err
    engine.set_topology(_build_topology(args))
    try:
        engine.build(latency_scale=args.latency_scale, seed=args.seed)
    except (ValueError, NotImplementedError) as err:
        raise SystemExit(f"invalid flag combination: {err}") from err

    until_rmse_result = None
    t_run0 = time.perf_counter()
    if args.until_rmse is not None:
        until_rmse_result = engine.run_until_rmse(
            args.until_rmse, max_rounds=args.max_rounds)
    elif args.stream:
        n = (args.rounds if args.rounds is not None
             else max(0, int(round(args.until - engine.clock))))
        every = max(1, int(args.observe_every))
        full = n - n % every
        if full:
            engine.run_streamed(full, observe_every=every)
        if n - full:
            engine.run_rounds(n - full)
    elif args.rounds is not None:
        engine.run_rounds(args.rounds)
    else:
        engine.add_watcher(run_until=args.until,
                           time_interval=args.observe_every)
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
    print(json.dumps(report))
    return 0


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
    run.add_argument("--platform", help="SimGrid-style platform XML")
    run.add_argument("--deployment", help="SimGrid-style deployment XML")
    run.add_argument("--generator", help="synthetic topology, e.g. "
                     "'erdos_renyi:10000', 'fat_tree:160', 'ring:100:2'")
    run.add_argument("--seed", type=int, default=0)
    run.add_argument("--variant", default="collectall",
                     choices=("collectall", "pairwise"))
    run.add_argument("--fire-policy", default=None,
                     choices=("reference", "every_round"),
                     help="'reference' = faithful async dynamics; "
                          "'every_round' = fast synchronous mode")
    run.add_argument("--delivery", default="gather",
                     choices=("gather", "scatter", "benes", "benes_fused"),
                     help="edge-kernel message delivery")
    run.add_argument("--spmv", default="xla",
                     choices=("xla", "pallas", "benes", "benes_fused",
                              "structured", "banded", "banded_fused"),
                     help="node-kernel neighbor sum: xla (plain gather), "
                          "pallas (CUDA ELL kernel), banded (RCM bands + "
                          "gather remainder), banded_fused (the whole "
                          "round as one CUDA kernel)")
    run.add_argument("--segment", default="auto",
                     choices=("auto", "segment", "ell", "benes",
                              "benes_fused"),
                     help="edge-kernel per-node reduction layout")
    run.add_argument("--multichip", default="auto",
                     choices=("auto", "halo", "pod"))
    run.add_argument("--halo", default="ppermute",
                     choices=("ppermute", "allgather", "overlap",
                              "overlap_pallas", "auto"))
    run.add_argument("--partition", default="bfs",
                     choices=("bfs", "contiguous"))
    run.add_argument("--shards", type=int, default=0)
    run.add_argument("--kernel", default="edge", choices=("edge", "node"),
                     help="'node' = collapsed SpMV recurrence (fast "
                          "synchronous collect-all; the ported path); "
                          "'edge' = general per-edge kernel (not ported)")
    run.add_argument("--plan", default="off", choices=("off", "auto"))
    run.add_argument("--drain", type=int, default=None)
    run.add_argument("--timeout", type=int, default=None)
    run.add_argument("--delay-depth", type=int, default=None)
    run.add_argument("--pending-depth", type=int, default=None)
    run.add_argument("--drop-rate", type=float, default=0.0)
    run.add_argument("--fidelity", action="store_true")
    run.add_argument("--contention", action="store_true")
    run.add_argument("--contention-iters", type=int, default=None)
    run.add_argument("--contention-backlog", action="store_true")
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
                     metavar="METRICS")
    run.add_argument("--report", metavar="PATH")
    run.add_argument("--event-log", metavar="PATH")
    run.add_argument("--profile", metavar="DIR")
    run.add_argument("--trace-dir", metavar="DIR")
    run.add_argument("--save-checkpoint", metavar="PATH")
    run.add_argument("--resume", metavar="PATH")
    run.set_defaults(fn=cmd_run)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(levelname)s %(name)s: %(message)s",
    )
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
