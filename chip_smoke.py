#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``flow_updating_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``flow_updating_tpu_torch/csrc``,
holds each kernel against its plain PyTorch version at the shapes of the
main path, drives the two main paths through the public entry points, and
prints one JSON line per phase:

1. ``device``  — the card (``torch.cuda.get_device_name``) and the
   ``nvidia-smi --query-gpu=name,power.limit`` line;
2. ``build``   — nvcc time per kernel source (compiled in parallel);
3. ``k1``      — kernel K1 (ELL neighbor sum) vs its plain version on the
   degree buckets of the fat tree k=160 (1,056,000 nodes), float32 within
   rtol=atol=1e-6, float64 within 1e-12, and exactly on a dyadic payload
   (whose sums are exact in any order);
4. ``k2``      — kernel K2 (one-kernel banded round) vs its plain version
   on ``ring(1_000_000, 2)``: route 'lanes' bit-exact on random floats
   (float32 and float64), route 'inline' exact on integer payloads;
5. ``path_a``  — ``Engine`` with ``RoundConfig.fast(kernel='node',
   spmv='pallas')`` on the fat tree: ms/round and rounds/s from CUDA events,
   rmse and mass residual, K1 launches == rounds x non-empty buckets, and
   the same engine on a small fat tree agreeing with its CPU run;
6. ``path_b``  — the same with ``spmv='banded_fused'`` on the ring: K2
   launched once per round, estimates ``torch.equal`` to an
   ``spmv='banded'`` run of the same rounds on the card;
7. ``profile`` — ``torch.profiler`` over a few more rounds of each path:
   device time per round, the device's busy share of the wall time and
   the kernels that take it;
8. the ``{"kernels": [...]}`` line (launches from the main paths; times,
   errors and bounds measured in this run), then the nvidia-smi line, then
   ``{"ok": true, "device": {...}}`` as the last line.

A kernel's ``ms``, ``plain_ms`` and ``library_ms`` are device time per
call: the profiler's sum over the call's CUDA kernels, averaged over
``REPS`` calls.  ``call_ms`` is the wrapper's time per call from CUDA
events around ``REPS`` back-to-back calls, host launch gaps included.

Any failure raises and exits non-zero.  Without a CUDA device it exits
with code 2 and prints no result.  It takes no options: the sizes below
are the headline configurations, at full width.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

FAT_TREE_K = 160        # fat_tree(160): 1,056,000 nodes (path A, K1)
RING_N = 1_000_000      # ring(1_000_000, 2) (path B, K2)
ROUNDS = 50             # timed rounds per main path
WARMUP = 5              # rounds before the timed ones
REPS = 20               # calls per kernel timing
PROFILE_ROUNDS = 20     # rounds per path under the profiler
SEED = 0

#: NVIDIA H100 SXM data sheet: peak HBM rate (bytes/s) and float32 rate
#: outside the tensor cores (FLOP/s)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn) -> float:
    """Mean milliseconds per call of ``fn`` from CUDA events around
    ``REPS`` back-to-back calls (host launch gaps included)."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def device_ms(fn, only: str | None = None) -> float:
    """Mean device milliseconds per call of ``fn``: ``torch.profiler``'s
    self device time summed over the CUDA events of ``REPS`` calls (only
    those whose name contains ``only``, when given).  Raises when the trace
    holds none."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    us = sum(ev.self_device_time_total for ev in prof.key_averages()
             if ev.device_type == DeviceType.CUDA
             and (only is None or only in ev.key))
    if not us > 0:
        raise AssertionError(f"the profiler saw no device time for "
                             f"{only or 'the call'}")
    return us / REPS / 1e3


def bound(nbytes: int, ops: int) -> dict:
    """The least time the card could take: the larger of the bytes over
    the HBM rate and the operations over the float32 rate."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / FP32_FLOP_PER_S * 1e3
    return {"bytes": nbytes, "ops": ops,
            "bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def reset_counts() -> None:
    from flow_updating_tpu_torch.ops.fused_round import fused_banded_round
    from flow_updating_tpu_torch.ops.spmv import neighbor_sum_ell

    neighbor_sum_ell.launches = 0
    fused_banded_round.launches = 0


def phase_k1(topo, dev):
    """K1 vs plain on the main path's bucket matrices (path A layout)."""
    import numpy as np
    import torch

    from flow_updating_tpu_torch.models.config import RoundConfig
    from flow_updating_tpu_torch.models.sync import NodeKernel
    from flow_updating_tpu_torch.ops.spmv import (
        neighbor_sum,
        neighbor_sum_ell,
        neighbor_sum_min_bytes,
    )

    k = NodeKernel(topo, RoundConfig.fast(kernel="node", spmv="pallas"),
                   device=dev)
    mats, M = k.arrays.mats, k.padded_size
    rng = np.random.default_rng(SEED)
    u = rng.uniform(0.0, 1.0, M)
    out = {"nodes": topo.num_nodes, "padded": M,
           "buckets": [list(m.shape) for m in mats]}
    for name, dt, tol in (("float32", torch.float32, 1e-6),
                          ("float64", torch.float64, 1e-12)):
        x = torch.from_numpy(u).to(dev, dt)
        got, ref = neighbor_sum_ell(x, mats), neighbor_sum(x, mats)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        if not torch.allclose(got, ref, rtol=tol, atol=tol):
            raise AssertionError(f"K1 {name} disagrees with its plain "
                                 f"version: max abs err {err}")
        out[f"max_abs_err_{name}"] = err
    dyadic = torch.from_numpy(rng.integers(0, 1024, M) / 1024.0).to(
        dev, torch.float32)
    if not torch.equal(neighbor_sum_ell(dyadic, mats),
                       neighbor_sum(dyadic, mats)):
        raise AssertionError("K1 differs from its plain version on a "
                             "dyadic payload (sums exact in any order)")
    x = torch.from_numpy(u).to(dev, torch.float32)
    out["ms"] = device_ms(lambda: neighbor_sum_ell(x, mats), "spmv_ell_")
    out["call_ms"] = cuda_ms(lambda: neighbor_sum_ell(x, mats))
    out["plain_ms"] = device_ms(lambda: neighbor_sum(x, mats))
    # the one-call library yardstick: the same adjacency as a CSR matrix
    crow, col = [np.zeros(1, np.int64)], []
    for m in mats:
        mh = m.cpu().numpy()
        valid = mh < M
        col.append(mh[valid])
        crow.append(crow[-1][-1] + np.cumsum(valid.sum(axis=1)))
    crow = np.concatenate(crow)
    adj = torch.sparse_csr_tensor(
        torch.from_numpy(crow).to(dev),
        torch.from_numpy(np.concatenate(col).astype(np.int64)).to(dev),
        torch.ones(int(crow[-1]), dtype=torch.float32, device=dev),
        size=(M, M))
    lib = adj @ x.unsqueeze(1)
    if not torch.allclose(lib.squeeze(1), neighbor_sum(x, mats), rtol=1e-5,
                          atol=1e-5):
        raise AssertionError("CSR yardstick does not compute A(x)")
    out["library_ms"] = device_ms(lambda: adj @ x.unsqueeze(1))
    # one add per stored neighbor index
    out.update(bound(neighbor_sum_min_bytes(mats, M, 4), int(crow[-1])))
    return out


def _state(rng, P, dev, dt, integer=False):
    import torch

    draw = ((lambda: rng.integers(-8, 9, P).astype(float)) if integer
            else (lambda: rng.uniform(-1.0, 1.0, P)))
    return [torch.from_numpy(draw()).to(dev, dt) for _ in range(5)]


def phase_k2(ring_topo, dev):
    """K2 vs plain on the ring's banded plan, both remainder routes."""
    import numpy as np
    import torch

    from flow_updating_tpu_torch.ops.fused_round import (
        build_fused_leaves,
        fused_banded_round,
        fused_round_min_bytes,
        fused_round_plain,
        plan_fused_round,
    )
    from flow_updating_tpu_torch.plan import (
        banded_neighbor_sum,
        banded_remainder_sum,
        compile_topology,
    )

    t0 = time.perf_counter()
    plan = compile_topology(ring_topo)
    plan_s = time.perf_counter() - t0
    leaves = plan.leaves.to(dev)
    n = ring_topo.num_nodes
    rng = np.random.default_rng(SEED + 1)
    out = {"nodes": n, "plan_s": plan_s, "lanes": len(plan.spmv.offsets),
           "remainder_edges": plan.spmv.remainder_edges,
           "max_abs_err": 0.0}
    for route in ("lanes", "inline"):
        spec = plan_fused_round(plan.spmv, rem_route=route)
        fl = build_fused_leaves(plan.spmv, plan.leaves, spec).to(dev)
        deg = np.zeros(spec.P)
        deg[:n] = ring_topo.out_deg[plan.order]
        for name, dt in (("float32", torch.float32),
                         ("float64", torch.float64)):
            S, G, avp, ap, val = _state(rng, spec.P, dev, dt,
                                        integer=route == "inline")
            dg = torch.from_numpy(deg).to(dev, dt)
            inv = (torch.ones_like(dg) if route == "inline"
                   else 1.0 / (dg + 1.0))
            a_rem = None
            if route == "lanes":
                a_rem = banded_remainder_sum((val - S + ap) * inv,
                                             plan.spmv, leaves)
            args_k = (S, G, avp, ap, val, inv, dg, fl, spec)
            got = fused_banded_round(*args_k, a_rem=a_rem)
            ref = fused_round_plain(*args_k, a_rem=a_rem)
            torch.cuda.synchronize()
            for g, r, what in zip(got, ref, ("S'", "G'", "avg", "A")):
                err = float((g - r).abs().max())
                out["max_abs_err"] = max(out["max_abs_err"], err)
                if not torch.equal(g, r):
                    raise AssertionError(
                        f"K2 {route}/{name}: {what} differs from the plain "
                        f"version (max {err})")
            if route == "inline":
                # with S = A_prev = 0 and inv = 1 the A output IS the
                # neighbor sum of the value plane
                z = torch.zeros_like(val)
                A = fused_banded_round(z, z, z, z, val, inv, dg, fl,
                                       spec)[3][:n]
                ref_A = banded_neighbor_sum(val, plan.spmv, leaves)[:n]
                out["max_abs_err"] = max(out["max_abs_err"],
                                         float((A - ref_A).abs().max()))
                if not torch.equal(A, ref_A):
                    raise AssertionError("K2 inline neighbor sum differs "
                                         "from the banded executor")
        out[f"{route}_exact"] = True
        if route == "lanes":
            S, G, avp, ap, val = _state(rng, spec.P, dev, torch.float32)
            dg = torch.from_numpy(deg).to(dev, torch.float32)
            inv = 1.0 / (dg + 1.0)
            a_rem = banded_remainder_sum((val - S + ap) * inv, plan.spmv,
                                         leaves)
            call = (S, G, avp, ap, val, inv, dg, fl, spec)
            out["P"] = spec.P
            out["ms"] = device_ms(
                lambda: fused_banded_round(*call, a_rem=a_rem),
                "fused_round_kernel")
            out["call_ms"] = cuda_ms(
                lambda: fused_banded_round(*call, a_rem=a_rem))
            out["plain_ms"] = device_ms(
                lambda: fused_round_plain(*call, a_rem=a_rem))
            # per node: fire 3, one add per kept diagonal, the remainder
            # add, merge 8
            ops = spec.P * (12 + len(spec.offsets))
            out.update(bound(fused_round_min_bytes(spec, dtype_bytes=4),
                             ops))
    return out


def _timed_rounds(engine, rounds: int) -> float:
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    engine.run_rounds(rounds)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def phase_path_a(topo):
    import numpy as np

    from flow_updating_tpu_torch import Engine, RoundConfig
    from flow_updating_tpu_torch.ops.spmv import neighbor_sum_ell
    from flow_updating_tpu_torch.topology.generators import fat_tree

    cfg = RoundConfig.fast(kernel="node", spmv="pallas")
    eng = Engine(config=cfg).set_topology(topo).build()
    rmse0 = eng.convergence_report()["rmse"]
    eng.run_rounds(WARMUP)
    buckets = sum(1 for m in eng._node_kernel.arrays.mats
                  if m.shape[0] and m.shape[1])
    reset_counts()
    ms = _timed_rounds(eng, ROUNDS)
    launches = neighbor_sum_ell.launches
    if launches != ROUNDS * buckets:
        raise AssertionError(f"K1 launched {launches} times in {ROUNDS} "
                             f"rounds, expected {ROUNDS * buckets}")
    rep = eng.convergence_report()
    est = eng.estimates()
    if est.shape != (topo.num_nodes,) or not np.isfinite(est).all():
        raise AssertionError("path A estimates are not finite (N,) values")
    if not rep["rmse"] < rmse0:
        raise AssertionError("path A did not reduce the rmse")
    # reference on a small input: the same entry point on the host
    small = fat_tree(8)
    card = Engine(config=cfg).set_topology(small).build().run_rounds(40)
    host = Engine(config=cfg, device="cpu").set_topology(small).build()
    host.run_rounds(40)
    if not np.allclose(card.estimates(), host.estimates(), rtol=1e-6,
                       atol=1e-6):
        raise AssertionError("path A on the card disagrees with the host "
                             "run on fat_tree(8)")
    return {"rounds": ROUNDS, "ms_per_round": ms / ROUNDS,
            "rounds_per_s": ROUNDS / (ms / 1e3),
            "k1_launches": launches, "nonempty_buckets": buckets,
            "rmse_initial": rmse0, **rep}, eng


def phase_path_b(ring_topo):
    import numpy as np
    import torch

    from flow_updating_tpu_torch import Engine, RoundConfig
    from flow_updating_tpu_torch.ops.fused_round import (
        fused_banded_round,
        fused_round_bytes,
    )

    cfg = RoundConfig.fast(kernel="node", spmv="banded_fused")
    eng = Engine(config=cfg).set_topology(ring_topo).build()
    rmse0 = eng.convergence_report()["rmse"]
    eng.run_rounds(WARMUP)
    reset_counts()
    ms = _timed_rounds(eng, ROUNDS)
    launches = fused_banded_round.launches
    if launches != ROUNDS:
        raise AssertionError(f"K2 launched {launches} times in {ROUNDS} "
                             "rounds")
    rep = eng.convergence_report()
    twin = Engine(config=RoundConfig.fast(kernel="node", spmv="banded"))
    twin.set_topology(ring_topo).build().run_rounds(WARMUP + ROUNDS)
    n = ring_topo.num_nodes
    fused_est = (eng._node_kernel.arrays.value + eng.state.G)[:n]
    banded_est = (twin._node_kernel.arrays.value + twin.state.G)[:n]
    if not torch.equal(fused_est, banded_est):
        raise AssertionError(
            "banded_fused estimates differ from spmv='banded' "
            f"(max {float((fused_est - banded_est).abs().max())})")
    est = eng.estimates()
    if est.shape != (n,) or not np.isfinite(est).all():
        raise AssertionError("path B estimates are not finite (N,) values")
    if not rep["rmse"] < rmse0:
        raise AssertionError("path B did not reduce the rmse")
    spec = eng._node_kernel.arrays.fused
    return {"rounds": ROUNDS, "ms_per_round": ms / ROUNDS,
            "rounds_per_s": ROUNDS / (ms / 1e3),
            "k2_launches": launches, "equal_to_banded": True,
            "tpu_kernel_bytes_per_round": fused_round_bytes(spec)[
                "bytes_per_round"],
            "rmse_initial": rmse0, **rep}, eng


def profile_rounds(engine, rounds: int) -> dict:
    """Where a round's time goes on the card: ``torch.profiler`` over
    ``rounds`` rounds, the device time of every CUDA-side event (kernels,
    memsets, copies) summed and set against the wall time of the same
    rounds (which the profiler itself lengthens).  ``busy_share`` is None
    when the trace holds no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.run_rounds(rounds)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    device = [(ev.key, ev.self_device_time_total, ev.count)
              for ev in prof.key_averages()
              if ev.device_type == DeviceType.CUDA
              and ev.self_device_time_total > 0]
    busy_us = sum(t for _, t, _ in device)
    device.sort(key=lambda row: -row[1])
    return {"rounds": rounds, "wall_ms_per_round": wall_us / rounds / 1e3,
            "device_ms_per_round": busy_us / rounds / 1e3,
            "busy_share": busy_us / wall_us if busy_us else None,
            "device_launches_per_round": sum(c for _, _, c in device)
            / rounds,
            "top": [{"kernel": k[:90], "ms_per_round": t / rounds / 1e3,
                     "calls_per_round": c / rounds}
                    for k, t, c in device[:6]]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from flow_updating_tpu_torch import kernels
    from flow_updating_tpu_torch.topology.generators import fat_tree, ring

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    emit({"phase": "device", "kind": name,
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    build = kernels.load_all()
    emit({"phase": "build", "nvcc_s": build,
          "wall_s": time.perf_counter() - t0})

    t0 = time.perf_counter()
    tree = fat_tree(FAT_TREE_K)
    tree_s = time.perf_counter() - t0
    k1 = phase_k1(tree, dev)
    torch.cuda.synchronize()
    emit({"phase": "k1", "topology_s": tree_s, **k1})

    t0 = time.perf_counter()
    ring_topo = ring(RING_N, 2)
    ring_s = time.perf_counter() - t0
    k2 = phase_k2(ring_topo, dev)
    torch.cuda.synchronize()
    emit({"phase": "k2", "topology_s": ring_s, **k2})

    path_a, engine_a = phase_path_a(tree)
    torch.cuda.synchronize()
    emit({"phase": "path_a", "topology": f"fat_tree:{FAT_TREE_K}", **path_a})

    path_b, engine_b = phase_path_b(ring_topo)
    torch.cuda.synchronize()
    emit({"phase": "path_b", "topology": f"ring:{RING_N}:2", **path_b})

    emit({"phase": "profile",
          "path_a": profile_rounds(engine_a, PROFILE_ROUNDS),
          "path_b": profile_rounds(engine_b, PROFILE_ROUNDS)})
    torch.cuda.synchronize()

    emit({"kernels": [
        {"name": "spmv_ell", "route": "cuda",
         "source": "flow_updating_tpu_torch/csrc/spmv_ell.cu",
         "replaces": "flow_updating_tpu/ops/pallas_spmv.py:35",
         "launches": path_a["k1_launches"],
         "parity": "float32 rtol=atol=1e-6, float64 1e-12, dyadic exact",
         "max_abs_err": k1["max_abs_err_float32"],
         "ms": k1["ms"], "call_ms": k1["call_ms"],
         "plain_ms": k1["plain_ms"],
         "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
         "library_ms": k1["library_ms"]},
        {"name": "fused_round", "route": "cuda",
         "source": "flow_updating_tpu_torch/csrc/fused_round.cu",
         "replaces": "flow_updating_tpu/ops/pallas_round.py:331",
         "launches": path_b["k2_launches"],
         "parity": "lanes bit-exact, inline exact on integers",
         "max_abs_err": k2["max_abs_err"],
         "ms": k2["ms"], "call_ms": k2["call_ms"],
         "plain_ms": k2["plain_ms"],
         "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
         "library_ms": None},
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
