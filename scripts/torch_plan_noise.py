#!/usr/bin/env python3
"""How steady are the node routes' wall times on ``barabasi_albert(1e6, 4)``
on one NVIDIA GPU (the PyTorch/CUDA port, ``flow_updating_tpu_torch``)?

Run from the repository root on a machine with one card:

    python3 scripts/torch_plan_noise.py

It builds the graph ``chip_smoke.py``'s path L2 plans, runs
``Engine(plan='auto')`` cold twice (the autotuner's grid rates, its
head-to-head race and its choice), then builds five node engines
(``spmv='xla'``, ``'banded'`` on the decision's plan, ``'banded_fused'``
at the default knobs and at tile 64 and 256 with the 'lanes' remainder).
For each it prints the kernel launches and the device time a round from
one ``torch.profiler`` trace of 20 rounds, the host's dispatch time of 20
rounds and the wall time of 200.  Then it runs L2's gate protocol
(interleaved repeats of 20 rounds in a rotating order, CUDA events, each
engine's median) six times with 5 repeats, with the garbage collector on,
off and frozen, and four times with ``chip_smoke.L_REPS`` repeats, and
prints each trial's medians and every repeat's spread; then three races
of ``plan/select.py``'s ``_head_to_head`` (``H2H_PASSES`` passes) over
the xla, banded and tile-64 fused engines.  One JSON object a line, then
the ``nvidia-smi --query-gpu=name,power.limit`` line; nothing is checked.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

BA_N, BA_M, SEED = 1_000_000, 4, 0   # chip_smoke.py's path L2 graph
ROUNDS = 20                           # rounds per timed repeat
GATE_REPS = 30                        # chip_smoke.L_REPS
T0 = time.perf_counter()


def log(**kw) -> None:
    kw["t"] = round(time.perf_counter() - T0, 2)
    print(json.dumps(kw), flush=True)


def timed(engine, rounds: int = ROUNDS) -> float:
    """Milliseconds a round over ``rounds`` rounds, by CUDA events."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    engine.run_rounds(rounds)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / rounds


def gate(engines: dict, reps: int) -> dict:
    """L2's protocol: ``reps`` passes, each engine once a pass, the order
    rotating by one each pass."""
    order = list(engines.items())
    out = {name: [] for name in engines}
    for i in range(reps):
        k = i % len(order)
        for name, engine in order[k:] + order[:k]:
            out[name].append(timed(engine))
    return out


def profile_round(engine) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        engine.run_rounds(ROUNDS)
        torch.cuda.synchronize()
    launches, dev_us = 0, 0.0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            launches += 1
            dev_us += ev.device_time_total
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.run_rounds(ROUNDS)
    dispatch = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.run_rounds(200)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {"launches_per_round": launches / ROUNDS,
            "device_ms_per_round": dev_us / ROUNDS / 1e3,
            "dispatch_ms_per_round": dispatch / ROUNDS * 1e3,
            "wall_ms_per_round_200": wall / 200 * 1e3}


def main() -> int:
    import torch

    from flow_updating_tpu_torch import Engine, RoundConfig
    from flow_updating_tpu_torch.plan import select
    from flow_updating_tpu_torch.plan.select import PlanDecision
    from flow_updating_tpu_torch.topology.generators import barabasi_albert

    if not torch.cuda.is_available():
        print("torch_plan_noise: no CUDA device", file=sys.stderr)
        return 1
    log(cpus=os.cpu_count(), affinity=len(os.sched_getaffinity(0)),
        load=open("/proc/loadavg").read().strip(),
        threads=torch.get_num_threads())
    tmp = tempfile.mkdtemp()
    os.environ["FU_PLAN_CACHE"] = "0"
    ba = barabasi_albert(BA_N, BA_M, seed=SEED)
    decision = None
    for i in range(2):
        os.environ["FLOW_UPDATING_AUTOTUNE_CACHE"] = os.path.join(
            tmp, f"c{i}.json")
        t0 = time.perf_counter()
        eng = Engine(config=RoundConfig.fast(), plan="auto")
        eng.set_topology(ba).build()
        torch.cuda.synchronize()
        d = eng.plan_decision
        log(phase="auto", i=i, s=time.perf_counter() - t0,
            chosen=f"{d.kernel}/{d.spmv}", grid=d.fused.get("candidates"),
            raced=d.fused.get("measured_rounds_per_sec"),
            best=d.fused.get("best"), chosen_knobs=d.fused.get("chosen"))
        decision = decision or d
        del eng
    cfg = RoundConfig.fast()

    def fixed(spmv, knobs=None):
        return Engine(config=cfg, plan=PlanDecision(
            kernel="node", spmv=spmv, plan=decision.plan, backend="cuda",
            predicted={}, reason="noise",
            fused=None if knobs is None else {"chosen": knobs}))

    makers = {
        "xla": lambda: Engine(config=dataclasses.replace(
            cfg, kernel="node", spmv="xla")),
        "banded": lambda: fixed("banded"),
        "fused_default": lambda: fixed(
            "banded_fused", {"fused_tile": None, "fused_remainder": "auto"}),
        "fused_t64_lanes": lambda: fixed(
            "banded_fused", {"fused_tile": 64, "fused_remainder": "lanes"}),
        "fused_t256_lanes": lambda: fixed(
            "banded_fused", {"fused_tile": 256, "fused_remainder": "lanes"}),
    }
    engines = {}
    for name, make in makers.items():
        engines[name] = make().set_topology(ba).build()
        engines[name].run_rounds(5)
    torch.cuda.synchronize()
    log(phase="built", mem_gb=torch.cuda.memory_allocated() / 1e9)
    for name, engine in engines.items():
        log(phase="profile", cand=name, **profile_round(engine))

    collections = []
    gc.callbacks.append(lambda phase, info: collections.append(phase))
    for mode, trials, reps in (("gc_on", 6, 5), ("gc_off", 6, 5),
                               ("gc_frozen", 6, 5),
                               ("l_reps", 4, GATE_REPS)):
        if mode == "gc_off":
            gc.disable()
        if mode == "gc_frozen":
            gc.freeze()
        collections.clear()
        medians = {name: [] for name in engines}
        every = {name: [] for name in engines}
        for _ in range(trials):
            for name, v in gate(engines, reps).items():
                medians[name].append(round(statistics.median(v), 4))
                every[name] += v
        gc.enable()
        log(phase="gate", mode=mode, reps=reps, medians=medians,
            spread={name: [round(min(v), 4), round(statistics.median(v), 4),
                           round(max(v), 4)] for name, v in every.items()},
            gc_collections=collections.count("start"))
    for i in range(3):
        raced = select._head_to_head(
            {name: (lambda e=engines[name]: e._node_kernel)
             for name in ("xla", "banded", "fused_t64_lanes")},
            select.PROBE_ROUNDS)
        log(phase="race", i=i, passes=select.H2H_PASSES,
            rounds_per_s={k: round(v, 1) for k, v in raced.items()})
    log(phase="done", load=open("/proc/loadavg").read().strip())
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
