"""Command-line driver: the ``run`` and ``oracle`` subcommands.

Counterpart of ``flow_updating_tpu/cli.py``'s ``run`` and ``oracle``.
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
restored round, ``--until`` is absolute simulated time).  Flags whose
machinery is not ported yet exit with a message naming the ROADMAP
item.  ``--backend`` selects the JAX backend in the JAX package; it is
accepted here for command-line compatibility and has no effect.

``oracle`` runs the native discrete-event simulator on the host (the
reference-style baseline; ``--lmm`` for the dynamic max-min network) and
prints the JAX CLI's JSON keys.
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
    try:
        mesh = None
        if args.shards:
            from flow_updating_tpu_torch.parallel.mesh import make_mesh

            mesh = make_mesh(args.shards, device=args.device)
        engine = Engine(config=cfg, mesh=mesh, multichip=args.multichip,
                        halo=args.halo,
                        partition=args.partition, plan=args.plan,
                        device=args.device)
    except (NotImplementedError, RuntimeError, ValueError) as err:
        raise SystemExit(str(err)) from err
    engine.set_topology(_build_topology(args))
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

    until_rmse_result = None
    t_run0 = time.perf_counter()
    if args.until_rmse is not None:
        until_rmse_result = engine.run_until_rmse(
            args.until_rmse, max_rounds=args.max_rounds)
    elif args.stream:
        # --until is absolute simulated time (as run_until, after
        # --resume too); --rounds is a relative count
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
    if engine.halo_report() is not None:
        report["halo"] = engine.halo_report()
    if args.save_checkpoint:
        engine.save_checkpoint(args.save_checkpoint)
        report["checkpoint"] = args.save_checkpoint
    print(json.dumps(report))
    return 0


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
    run.add_argument("--variant", default="collectall",
                     choices=("collectall", "pairwise"))
    run.add_argument("--fire-policy", default=None,
                     choices=("reference", "every_round"),
                     help="'reference' = faithful async dynamics; "
                          "'every_round' = fast synchronous mode")
    run.add_argument("--delivery", default="gather",
                     choices=("gather", "scatter", "benes", "benes_fused"),
                     help="edge-kernel message delivery: gather (pull "
                          "through rev), scatter (push), benes / "
                          "benes_fused (the rev pull through a permutation "
                          "network; benes_fused through CUDA kernel B3)")
    run.add_argument("--spmv", default="xla",
                     choices=("xla", "pallas", "benes", "benes_fused",
                              "structured", "banded", "banded_fused"),
                     help="node-kernel neighbor sum: xla (plain gather), "
                          "pallas (CUDA ELL kernel), banded (RCM bands + "
                          "gather remainder), banded_fused (the whole "
                          "round as one CUDA kernel), benes / benes_fused "
                          "(a permutation network; benes_fused through "
                          "CUDA kernel B3), structured (a regular "
                          "generator's closed-form stencil)")
    run.add_argument("--segment", default="auto",
                     choices=("auto", "segment", "ell", "benes",
                              "benes_fused"),
                     help="edge-kernel per-node reductions: segment/auto "
                          "(CSR segment_reduce), ell (bucketed gather), "
                          "benes (permutation networks), benes_fused (the "
                          "same through CUDA kernels B3 and B4)")
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
    run.add_argument("--kernel", default="edge", choices=("edge", "node"),
                     help="'edge' = the general per-edge round (every "
                          "dynamics; --segment and --delivery pick its "
                          "layouts); 'node' = the collapsed SpMV recurrence "
                          "(fast synchronous collect-all only; --spmv)")
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
