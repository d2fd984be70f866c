"""Chaos harness: infrastructure faults as data, recovery proven per
fault.

Counterpart of ``flow_updating_tpu/resilience/chaos.py``, on the port's
``ServiceEngine``, ``QueryFabric``, WAL, checkpoint ring, ``recover``,
watchdog and flight recorder.  The scenario registry closed the
conformance loop over *protocol* adversaries; this module closes it over
the *infrastructure* layer.  Each registered fault is injected into a
real run **in a subprocess** (SIGKILL is a real SIGKILL — no atexit, no
flush), the declared recovery machinery is exercised, and the result is
a ``flow-updating-recovery-report/v1`` manifest that must pass
``doctor --strict`` — while the same fault with recovery *disabled*
(``perturb=True``) must FAIL it, and ``inspect --blame`` must name the
planted fault at rank 1 from the recovery evidence alone.

Two differences from the JAX harness, on purpose: the child runs on the
parent's device (``run_chaos(device=)``, the card unless ``'cpu'`` is
given; the JAX harness pins its children to the CPU), so the child, the
recovered engine and the control all run there and their digests are
compared there; and every child runs under a time limit
(``child_timeout``, :data:`CHILD_TIMEOUT_S` seconds by default), so a
hung child fails its fault instead of holding its caller.  Children are
started with ``subprocess`` (an exec, never a fork of a process that
holds a CUDA context).

Registry (:data:`CHAOS_REGISTRY`):

========================  ==============================================
fault                     what is planted / what must hold
========================  ==============================================
``kill_at_segment``       SIGKILL between two scripted ops; recover()
                          replays the WAL — state digest bit-exact vs
                          the uninterrupted control
``kill_mid_checkpoint``   SIGKILL between a ring archive's temp write
                          and its atomic rename; the stale temp is
                          swept, the previous archive recovers, digest
                          bit-exact
``truncate_wal_tail``     the journal's last frame torn after the
                          kill; the tail truncates cleanly and the
                          resumed script re-applies the lost op —
                          digest bit-exact
``corrupt_newest_ckpt``   the newest ring archive torn (size shrinks);
                          recovery falls back to the next, replays a
                          longer WAL suffix — digest bit-exact
``bitflip_archive``       one byte flipped in the newest archive (size
                          intact); the integrity sidecar classifies it,
                          recovery falls back — digest bit-exact
``nan_poison_lane``       one active query lane's ledgers poisoned with
                          NaN; the watchdog quarantines it
                          mass-neutrally — every OTHER lane bit-exact
                          vs an unpoisoned control, free-lane residual
                          exactly 0.0
``admission_storm``       3x lane capacity submitted in one burst; the
                          admission backoff bounds degraded mode and
                          the queue drains
========================  ==============================================

The scripted run is deterministic from ``(kind, seed, sizes)`` alone
and journals exactly one WAL record per op, so a recovered engine
resumes the script at ``ops[wal.last_seq:]`` — how the harness (and any
real driver) continues where the dead process stopped.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import subprocess
import sys

import numpy as np

#: Seconds a chaos child may run before it is killed and its fault fails
#: (the default of ``run_chaos(child_timeout=)``).
CHILD_TIMEOUT_S = 300.0

#: The directory that holds the package, put on the child's PYTHONPATH so
#: ``python -m flow_updating_tpu_torch.resilience.chaos`` imports this
#: checkout from any working directory.
_PKG_PARENT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: State leaves carrying a trailing query-lane axis (the per-lane
#: bit-exactness comparison slices these around the poisoned lane).
_LANE_LEAVES = ("value", "flow", "est", "last_avg", "pending_flow",
                "pending_est", "buf_flow", "buf_est")


@dataclasses.dataclass(frozen=True)
class ChaosFault:
    """One registered infra fault (module docstring)."""

    name: str
    summary: str
    kind: str                  # "service" | "query"
    kill: str | None = None    # "op" | "mid_checkpoint"
    tamper: str | None = None  # "truncate_wal"|"truncate_ckpt"|"bitflip"
    inject: str | None = None  # "nan_lane" | "storm"
    watchdog: bool = False
    drain_tail: int = 0        # extra run ops appended to the script


CHAOS_REGISTRY = {f.name: f for f in (
    ChaosFault(
        "kill_at_segment",
        "SIGKILL at a scripted op boundary; WAL replay restores the "
        "exact timeline",
        kind="query", kill="op"),
    ChaosFault(
        "kill_mid_checkpoint",
        "SIGKILL between a ring archive's temp write and its rename; "
        "the stale temp is swept and the previous archive recovers",
        kind="service", kill="mid_checkpoint"),
    ChaosFault(
        "truncate_wal_tail",
        "journal torn mid-frame after the kill; the tail truncates "
        "cleanly and the lost op is re-applied by the resumed script",
        kind="service", kill="op", tamper="truncate_wal"),
    ChaosFault(
        "corrupt_newest_ckpt",
        "newest ring archive torn (size shrinks); recovery falls back "
        "to the next archive",
        kind="query", kill="op", tamper="truncate_ckpt"),
    ChaosFault(
        "bitflip_archive",
        "one byte flipped inside the newest archive (size intact); "
        "the integrity sidecar classifies it and recovery falls back",
        kind="service", kill="op", tamper="bitflip"),
    ChaosFault(
        "nan_poison_lane",
        "one active lane's edge ledgers poisoned with NaN; the "
        "watchdog quarantines it mass-neutrally",
        kind="query", inject="nan_lane", watchdog=True, drain_tail=6),
    ChaosFault(
        "admission_storm",
        "3x lane capacity submitted in one burst; admission backoff "
        "bounds degraded mode until the queue drains",
        kind="query", inject="storm", watchdog=True, drain_tail=24),
)}


def get_fault(name: str) -> ChaosFault:
    try:
        return CHAOS_REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown chaos fault {name!r}; registered: "
            f"{', '.join(sorted(CHAOS_REGISTRY))}") from None


# ---- the deterministic scripted run --------------------------------------

def service_capacity(nodes: int) -> int:
    """Spare node slots the scripted service run budgets for joins —
    shared by the engine constructor and the script's free-list mirror
    (they must agree for journaled joins to replay into the same
    slots)."""
    return nodes + max(4, nodes // 8)


def scripted_ops(kind: str, n_ops: int, seed: int, nodes: int,
                 lanes: int, drain_tail: int = 0) -> list:
    """The scripted event stream, computed from the arguments alone
    (no engine state) so the child, the recovering parent and the
    control all agree: one journaled WAL record per op."""
    rng = np.random.default_rng(seed)
    ops: list = []
    if kind == "service":
        free = list(range(nodes, service_capacity(nodes)))
        held: list = []
        while len(ops) < n_ops:
            r = rng.random()
            if r < 0.2 and held:
                slot = held.pop(0)
                free.append(slot)
                free.sort()
                ops.append({"op": "leave", "ids": [slot]})
            elif r < 0.45 and free:
                slot = free.pop(0)
                anchor = int(rng.integers(0, nodes))
                held.append(slot)
                ops.append({"op": "join", "value": float(rng.random())})
                ops.append({"op": "add_edges",
                            "pairs": [[slot, anchor]]})
            elif r < 0.6:
                i = int(rng.integers(0, nodes))
                ops.append({"op": "update", "ids": [i],
                            "values": [float(rng.random())]})
            else:
                ops.append({"op": "run",
                            "segments": int(rng.integers(1, 4))})
    else:
        while len(ops) < n_ops:
            r = rng.random()
            if r < 0.4:
                m = int(rng.integers(1, max(2, min(lanes, nodes // 4))))
                cohort = np.sort(rng.choice(
                    nodes, size=m, replace=False)).tolist()
                ops.append({"op": "submit",
                            "values": rng.random(m).tolist(),
                            "cohort": [int(i) for i in cohort]})
            elif r < 0.5:
                i = int(rng.integers(0, nodes))
                ops.append({"op": "suspend", "ids": [i]})
                ops.append({"op": "resume", "ids": [i]})
            else:
                ops.append({"op": "run",
                            "segments": int(rng.integers(1, 4))})
    ops = ops[:n_ops]
    ops.extend({"op": "run", "segments": 4} for _ in range(drain_tail))
    return ops


def build_engine(kind: str, nodes: int, lanes: int,
                 segment_rounds: int, seed: int, drop_rate: float,
                 eps: float = 1e-3, device=None):
    """The scripted run's engine on ``device`` (the card unless ``'cpu'``
    is given) — an ER topology (fast mixing keeps the scripts short),
    drop>0 by default (the acceptance criteria include loss + churn +
    active lanes)."""
    from flow_updating_tpu_torch.models.config import RoundConfig
    from flow_updating_tpu_torch.topology.generators import erdos_renyi

    topo = erdos_renyi(nodes, avg_degree=8.0, seed=seed)
    cfg = RoundConfig.fast(variant="collectall", drop_rate=drop_rate)
    if kind == "service":
        from flow_updating_tpu_torch.service import ServiceEngine

        return ServiceEngine(
            topo, service_capacity(nodes),
            degree_budget=int(topo.out_deg.max()) + 8,
            config=cfg, segment_rounds=segment_rounds, seed=seed,
            device=device)
    from flow_updating_tpu_torch.query import QueryFabric

    return QueryFabric(
        topo, lanes=lanes, capacity=nodes, config=cfg,
        segment_rounds=segment_rounds, seed=seed, conv_eps=eps,
        # storms intentionally overflow the queue: the admission SLO
        # under test is the backoff bound, not the latency budget
        admission_slo_rounds=10_000 * segment_rounds, device=device)


def apply_op(engine, kind: str, op: dict,
             segment_rounds: int) -> None:
    o = op["op"]
    if o == "run":
        engine.run(op["segments"] * segment_rounds)
    elif o == "join":
        if kind == "service":
            engine.join(op["value"])
        else:
            engine.join()
    elif o == "leave":
        engine.leave(op["ids"])
    elif o == "update":
        engine.update(op["ids"], np.asarray(op["values"]))
    elif o == "add_edges":
        engine.add_edges([tuple(p) for p in op["pairs"]])
    elif o == "suspend":
        engine.suspend(op["ids"])
    elif o == "resume":
        engine.resume(op["ids"])
    elif o == "submit":
        engine.submit(np.asarray(op["values"]), cohort=op["cohort"])
    else:
        raise ValueError(f"unknown scripted op {o!r}")


def pick_kill_op(ops: list, seed: int) -> int:
    """A seeded kill point in the middle half of the script, placed
    right after a state-CHANGING event op — so at least one journaled
    record is guaranteed to sit between the last possible ring
    checkpoint (checkpoints only happen inside run ops) and the kill,
    which is exactly what the recovery-disabled control must lose."""
    rng = np.random.default_rng(seed + 7)
    lo, hi = len(ops) // 4, 3 * len(ops) // 4
    candidates = [i for i in range(lo, hi)
                  if ops[i - 1]["op"] in ("update", "submit", "join",
                                          "add_edges", "leave")]
    if not candidates:
        candidates = [max(lo, 1)]
    return int(candidates[int(rng.integers(0, len(candidates)))])


def pick_poison_op(ops: list) -> int:
    """The first run op after a submit — an active lane is guaranteed
    at the next boundary."""
    seen_submit = False
    for i, op in enumerate(ops):
        if op["op"] == "submit":
            seen_submit = True
        elif seen_submit and op["op"] == "run":
            return i
    raise ValueError("script has no submit-then-run prefix to poison")


# ---- the child (the real run a fault is injected into) -------------------

def _child_main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="chaos-child")
    ap.add_argument("--kind", required=True,
                    choices=("service", "query"))
    ap.add_argument("--dir", required=True)
    ap.add_argument("--result", required=True,
                    help="where the surviving child writes its blocks")
    ap.add_argument("--final", default=None,
                    help="final checkpoint path (surviving children)")
    ap.add_argument("--nodes", type=int, required=True)
    ap.add_argument("--lanes", type=int, default=8)
    ap.add_argument("--segment-rounds", type=int, default=8)
    ap.add_argument("--ops", type=int, required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--drop-rate", type=float, default=0.05)
    ap.add_argument("--checkpoint-every", type=int, default=2)
    ap.add_argument("--retain", type=int, default=3)
    ap.add_argument("--drain-tail", type=int, default=0)
    ap.add_argument("--kill-op", type=int, default=-1)
    ap.add_argument("--kill-mid-ckpt", type=int, default=-1,
                    help="SIGKILL during the Nth ring archive write")
    ap.add_argument("--poison-op", type=int, default=-1)
    ap.add_argument("--storm-op", type=int, default=-1)
    ap.add_argument("--watchdog", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the child's engine runs: the CUDA card "
                         "(default) or the host CPU")
    args = ap.parse_args(argv)

    engine = build_engine(args.kind, args.nodes, args.lanes,
                          args.segment_rounds, args.seed,
                          args.drop_rate, device=args.device)
    if args.watchdog:
        engine.attach_watchdog()
    if args.kill_mid_ckpt >= 0:
        from flow_updating_tpu_torch.utils import checkpoint as ck

        writes = {"n": 0}

        def _crash(path: str) -> None:
            if os.path.basename(path).startswith("ckpt-"):
                writes["n"] += 1
                if writes["n"] == args.kill_mid_ckpt:
                    os.kill(os.getpid(), signal.SIGKILL)

        ck._CRASH_BEFORE_REPLACE = _crash
    engine.enable_durability(args.dir,
                             checkpoint_every=args.checkpoint_every,
                             retain=args.retain)
    ops = scripted_ops(args.kind, args.ops, args.seed, args.nodes,
                       args.lanes, drain_tail=args.drain_tail)
    planted = {}
    for i, op in enumerate(ops):
        if i == args.kill_op:
            os.kill(os.getpid(), signal.SIGKILL)
        if i == args.poison_op:
            lane = next(ln for ln, q in enumerate(engine._lane_q)
                        if q is not None)
            # in place, into the tensors the next segment's rounds read
            # (svc.state's own planes; no host mirror aliases them)
            st = engine.svc.state
            st.est[:, lane] = float("nan")
            st.flow[:, lane] = float("nan")
            planted["poisoned_lane"] = int(lane)
            planted["poison_op"] = i
        if i == args.storm_op:
            rng = np.random.default_rng(args.seed + 13)
            for _ in range(3 * args.lanes):
                member = int(rng.integers(0, args.nodes))
                engine.submit([float(rng.random())], cohort=[member])
            planted["storm_op"] = i
            planted["storm_queries"] = 3 * args.lanes
        apply_op(engine, args.kind, op, args.segment_rounds)
    if args.final:
        engine.save_checkpoint(args.final)
    result = {
        "planted": planted,
        "digest": engine.state_digest(),
        "clock": int(engine.clock),
        "recovery": engine.resilience_block(),
        "serving_trace": engine.serving_trace_block(),
    }
    if args.kind == "query":
        result["query"] = engine.query_block()
    else:
        result["service"] = engine.service_block()
    with open(args.result, "w") as f:
        json.dump(result, f, indent=1, default=str)
    return 0


# ---- tamper (what the fault does to the dead process's directory) --------

def _newest_ckpt(directory: str) -> str:
    from flow_updating_tpu_torch.resilience.ring import CheckpointRing

    cands = CheckpointRing(directory).candidates()
    if not cands:
        raise ValueError(f"{directory}: ring is empty, nothing to "
                         "tamper with")
    return cands[0]["path"]


def apply_tamper(directory: str, tamper: str) -> dict:
    """Damage the durability directory the way the fault declares.
    Returns the ground-truth detail block."""
    from flow_updating_tpu_torch.resilience.recover import WAL_NAME

    if tamper == "truncate_wal":
        path = os.path.join(directory, WAL_NAME)
        size = os.path.getsize(path)
        cut = min(7, size - 9)           # tear the last frame mid-way
        with open(path, "r+b") as f:
            f.truncate(size - cut)
        return {"tampered": os.path.basename(path),
                "bytes_cut": int(cut)}
    if tamper == "truncate_ckpt":
        path = _newest_ckpt(directory)
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            f.truncate(max(size * 3 // 5, 1))
        return {"tampered": os.path.basename(path),
                "bytes_cut": int(size - size * 3 // 5)}
    if tamper == "bitflip":
        path = _newest_ckpt(directory)
        size = os.path.getsize(path)
        off = size // 2
        with open(path, "r+b") as f:
            f.seek(off)
            b = f.read(1)
            f.seek(off)
            f.write(bytes([b[0] ^ 0xFF]))
        return {"tampered": os.path.basename(path),
                "bitflip_offset": int(off)}
    raise ValueError(f"unknown tamper {tamper!r}")


# ---- the parent-side runner ---------------------------------------------

def _spawn_child(fault: ChaosFault, *, directory: str, result: str,
                 final: str | None, nodes: int, lanes: int,
                 segment_rounds: int, n_ops: int, seed: int,
                 drop_rate: float, checkpoint_every: int, retain: int,
                 kill_op: int, poison_op: int, storm_op: int,
                 watchdog: bool, device: str = "cuda",
                 timeout: float = CHILD_TIMEOUT_S
                 ) -> subprocess.CompletedProcess:
    """Run one chaos child (``python -m flow_updating_tpu_torch.
    resilience.chaos``) to its end, on ``device``.  A child still running
    after ``timeout`` seconds (:data:`CHILD_TIMEOUT_S` by default) is
    killed and its fault fails with a RuntimeError."""
    cmd = [sys.executable, "-m",
           "flow_updating_tpu_torch.resilience.chaos",
           "--kind", fault.kind, "--dir", directory,
           "--result", result,
           "--nodes", str(nodes), "--lanes", str(lanes),
           "--segment-rounds", str(segment_rounds),
           "--ops", str(n_ops), "--seed", str(seed),
           "--drop-rate", str(drop_rate),
           "--checkpoint-every", str(checkpoint_every),
           "--retain", str(retain),
           "--drain-tail", str(fault.drain_tail),
           "--device", device]
    if final:
        cmd += ["--final", final]
    if kill_op >= 0:
        cmd += ["--kill-op", str(kill_op)]
    if fault.kill == "mid_checkpoint":
        cmd += ["--kill-mid-ckpt", "3"]
    if poison_op >= 0:
        cmd += ["--poison-op", str(poison_op)]
    if storm_op >= 0:
        cmd += ["--storm-op", str(storm_op)]
    if watchdog:
        cmd += ["--watchdog"]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_PKG_PARENT, env.get("PYTHONPATH")) if p)
    try:
        return subprocess.run(cmd, env=env, capture_output=True,
                              text=True, timeout=timeout)
    except subprocess.TimeoutExpired as exc:
        tail = exc.stderr or ""
        if isinstance(tail, bytes):
            tail = tail.decode(errors="replace")
        raise RuntimeError(
            f"chaos child ({fault.name}) still running after {timeout} s "
            f"— killed\n{tail[-2000:]}") from None


def _run_control(fault: ChaosFault, ops: list, *, nodes: int,
                 lanes: int, segment_rounds: int, seed: int,
                 drop_rate: float, device=None):
    """The uninterrupted in-process control run (no durability; same
    watchdog arming so the boundary schedule matches)."""
    engine = build_engine(fault.kind, nodes, lanes, segment_rounds,
                          seed, drop_rate, device=device)
    if fault.watchdog:
        engine.attach_watchdog()
    for op in ops:
        apply_op(engine, fault.kind, op, segment_rounds)
    return engine


def _compare_lanes(recovered_svc_state, control_svc_state,
                   poisoned: int) -> dict:
    """Bit-exactness of every lane EXCEPT the poisoned one, plus the
    whole payload-independent control plane."""
    bad = []
    for name in recovered_svc_state.__dataclass_fields__:
        a = getattr(recovered_svc_state, name).cpu().numpy()
        b = getattr(control_svc_state, name).cpu().numpy()
        if name in _LANE_LEAVES:
            keep = [ln for ln in range(a.shape[-1]) if ln != poisoned]
            a, b = a[..., keep], b[..., keep]
        if not np.array_equal(a, b):
            bad.append(name)
    return {"exact": not bad, "kind": "lanes_except_poisoned",
            "poisoned_lane": int(poisoned), "diverged_leaves": bad}


def run_chaos(name: str, *, nodes: int = 128, lanes: int = 8,
              segment_rounds: int = 8, n_ops: int = 28, seed: int = 0,
              drop_rate: float = 0.05, checkpoint_every: int = 2,
              retain: int = 3, outdir: str = "obs-artifacts",
              perturb: bool = False, device=None,
              child_timeout: float = CHILD_TIMEOUT_S) -> dict:
    """Run one registered fault end to end (module docstring) on
    ``device`` (the card unless ``'cpu'`` is given): the child, the
    recovery and the control all run there.

    Returns ``{"fault", "manifest_path", "checks", "overall",
    "blame_top", ...}``; the manifest passes ``doctor --strict`` for a
    healthy recovery and FAILS under ``perturb=True`` (recovery
    disabled) — both directions are the chaos conformance contract.  A
    child that outlives ``child_timeout`` seconds is killed and raises
    RuntimeError."""
    import tempfile

    from flow_updating_tpu_torch.obs import health
    from flow_updating_tpu_torch.obs.inspect import blame_recovery
    from flow_updating_tpu_torch.obs.report import (
        build_recovery_manifest,
        write_report,
    )
    from flow_updating_tpu_torch.resilience.recover import recover
    from flow_updating_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    fault = get_fault(name)
    os.makedirs(outdir, exist_ok=True)
    scratch = tempfile.mkdtemp(prefix=f"chaos-{name}-")
    directory = os.path.join(scratch, "durability")
    result_path = os.path.join(scratch, "child_result.json")
    final_path = os.path.join(scratch, "final.npz")

    ops = scripted_ops(fault.kind, n_ops, seed, nodes, lanes,
                       drain_tail=fault.drain_tail)
    kill_op = pick_kill_op(ops, seed) if fault.kill == "op" else -1
    poison_op = pick_poison_op(ops) if fault.inject == "nan_lane" \
        else -1
    storm_op = pick_poison_op(ops) if fault.inject == "storm" else -1
    use_watchdog = fault.watchdog and not perturb

    proc = _spawn_child(
        fault, directory=directory, result=result_path,
        final=final_path if fault.inject else None,
        nodes=nodes, lanes=lanes, segment_rounds=segment_rounds,
        n_ops=n_ops, seed=seed, drop_rate=drop_rate,
        checkpoint_every=checkpoint_every, retain=retain,
        kill_op=kill_op, poison_op=poison_op, storm_op=storm_op,
        watchdog=use_watchdog, device=dev.type, timeout=child_timeout)
    killed = proc.returncode == -signal.SIGKILL
    if fault.kill and not killed:
        raise RuntimeError(
            f"chaos {name}: child was supposed to die by SIGKILL, got "
            f"rc={proc.returncode}\n{proc.stderr[-2000:]}")
    if not fault.kill and proc.returncode != 0:
        raise RuntimeError(
            f"chaos {name}: child failed rc={proc.returncode}\n"
            f"{proc.stderr[-2000:]}")

    ground_truth = {"fault": name, "summary": fault.summary,
                    "kind": fault.kind, "perturb": bool(perturb),
                    "seed": seed, "ops": len(ops)}
    if kill_op >= 0:
        ground_truth["kill_op"] = kill_op
    if fault.tamper:
        ground_truth.update(apply_tamper(directory, fault.tamper))

    recovery_block: dict
    service_block = query_block = None
    serving_trace = None
    verify = None
    timings: dict = {}

    if fault.kill:
        if perturb and fault.tamper in ("truncate_ckpt", "bitflip"):
            # recovery-disabled control: no ring fallback — try ONLY
            # the newest archive and report the dead end
            from flow_updating_tpu_torch.resilience.ring import (
                CheckpointRing,
            )

            ringo = CheckpointRing(directory, every=checkpoint_every,
                                   retain=retain)
            cand = ringo.candidates()[0]
            try:
                build_cls = None
                if fault.kind == "query":
                    from flow_updating_tpu_torch.query import (
                        QueryFabric as build_cls,
                    )
                else:
                    from flow_updating_tpu_torch.service import (
                        ServiceEngine as build_cls,
                    )
                build_cls.restore_checkpoint(cand["path"], device=dev)
                status = "used"
            except ValueError as exc:
                status = "restore-failed"
                cand = {**cand, "error": str(exc)}
            recovery_block = {
                "dir": directory, "kind": fault.kind,
                "ring": {**ringo.block(),
                         "scanned": [{**cand, "status": status}],
                         "used": None, "fallbacks": 1},
                "ground_truth": ground_truth,
            }
        else:
            import time as _time

            t0 = _time.perf_counter()
            engine = recover(directory, kind=fault.kind,
                             replay=not perturb, device=dev)
            timings["recover_s"] = round(_time.perf_counter() - t0, 4)
            resume_from = engine._wal.last_seq
            resume_error = None
            for op in ops[resume_from:]:
                try:
                    apply_op(engine, fault.kind, op, segment_rounds)
                except (ValueError, RuntimeError) as exc:
                    if not perturb:
                        raise
                    # the recovery-disabled control is ALLOWED to break
                    # — a lost join makes later ops reference a
                    # non-member; the manifest records the wreckage
                    resume_error = f"{type(exc).__name__}: {exc}"
                    break
            control = _run_control(
                fault, ops, nodes=nodes, lanes=lanes,
                segment_rounds=segment_rounds, seed=seed,
                drop_rate=drop_rate, device=dev)
            verify = {
                "exact": resume_error is None
                and engine.state_digest() == control.state_digest(),
                "kind": "state_digest",
                "recovered_digest": engine.state_digest(),
                "control_digest": control.state_digest(),
                "resumed_ops": len(ops) - resume_from,
            }
            if resume_error is not None:
                verify["resume_error"] = resume_error
            recovery_block = engine.resilience_block() or {}
            recovery_block["verify"] = verify
            recovery_block["ground_truth"] = ground_truth
            if fault.kind == "query":
                query_block = engine.query_block()
            else:
                service_block = engine.service_block()
            # the flight recorder survived the SIGKILL with the engine:
            # its spans/metrics rode the ring checkpoint and the replay
            # re-fired the rest — doctor's span_complete judges the
            # continuity (and FAILS the replay-disabled perturbation)
            serving_trace = engine.serving_trace_block()
    else:
        # inject faults: the child survived and wrote its own blocks
        with open(result_path) as f:
            child = json.load(f)
        ground_truth.update(child.get("planted") or {})
        recovery_block = child.get("recovery") or {
            "dir": directory, "kind": fault.kind}
        recovery_block["ground_truth"] = ground_truth
        query_block = child.get("query")
        service_block = child.get("service")
        serving_trace = child.get("serving_trace")
        if fault.inject == "nan_lane" and not perturb:
            from flow_updating_tpu_torch.query import QueryFabric

            recovered = QueryFabric.restore_checkpoint(final_path,
                                                       device=dev)
            control = _run_control(
                fault, ops, nodes=nodes, lanes=lanes,
                segment_rounds=segment_rounds, seed=seed,
                drop_rate=drop_rate, device=dev)
            verify = _compare_lanes(
                recovered.svc.state, control.svc.state,
                ground_truth["poisoned_lane"])
            recovery_block["verify"] = verify

    suffix = "_perturbed" if perturb else ""
    manifest_path = os.path.join(outdir, f"chaos_{name}{suffix}.json")
    manifest = build_recovery_manifest(
        argv=["chaos", name] + (["--perturb"] if perturb else []),
        recovery=recovery_block, service=service_block,
        query=query_block, timings=timings or None,
        extra=({"serving_trace": serving_trace}
               if serving_trace else None), device=dev)
    write_report(manifest_path, manifest)

    checks = health.check_recovery(recovery_block)
    if serving_trace:
        # the flight recorder rides the same gate: a recovery whose
        # span chains have gaps (or whose counters disagree with the
        # census) fails the conformance loop, not just the doctor CLI
        checks = checks + health.check_serving_trace(
            serving_trace, query=query_block, recovery=recovery_block)
    blame = blame_recovery(manifest)
    return {
        "fault": name,
        "perturb": bool(perturb),
        "manifest_path": manifest_path,
        "overall": health.overall(checks),
        "exit_code": health.exit_code(checks, strict=True),
        "checks": [c.to_jsonable() for c in checks],
        "blame_top": blame["top"],
        "blame": blame["ranked"][:3],
        "verify": verify,
        "timings": timings,
    }


if __name__ == "__main__":
    sys.exit(_child_main())
