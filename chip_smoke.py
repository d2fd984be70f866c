#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``flow_updating_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``flow_updating_tpu_torch/csrc``,
holds each kernel against its plain PyTorch version at the shapes of the
main paths, drives the main paths through the public entry points,
and prints one JSON line per phase:

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
7. ``k3``      — kernel B3 (the fused passes of the Beneš neighbor-sum
   network) on the fat tree's network (P = 2^23): the routing time, the
   passes per flavour, each flavour on a real pass of the plan
   ``torch.equal`` to its plain version in float32 and float64 (and with a
   batch of 3), the local, window, wide and wide2 flavours also at every
   tile (2 to 4,096; the wide kernels from 1) on random stage lists and
   planes, the whole plan ``torch.equal`` to the per-stage executor, and
   the device time of every window pass of the plan, of its first wide2
   passes (roll and swap) at a batch of 3, and of every wide pass of the
   plan (batch 1) and of path D's three networks (extract at batch 3,
   place at 2, rev at 3: the widest call of each in a round);
8. ``path_c``  — ``Engine`` with ``spmv='benes_fused'`` on the fat tree:
   ms/round, B3 launches == rounds x passes (per flavour too), rmse,
   estimates ``torch.equal`` to ``spmv='benes'`` and ``spmv='xla'`` runs
   on the card;
   ``a6``     — the on-disk plan cache on path C's network: with
   ``FU_PLAN_CACHE`` at a new temporary directory (everywhere else the
   script sets it to ``0``, so no earlier run's file warms a phase), a
   cold build routes and saves, a second build after the in-process cache
   is cleared loads from disk; build seconds of both, the file's bytes,
   the stages equal, 20 rounds of each ``torch.equal``;
9. ``k4``      — kernel B4 (the segmented scan and fill-forward of the edge
   kernel's segment networks) on the fat tree's segment plan (P = 2^23):
   scan sum (float32, float64), min and max (float32), min (int32) and fill
   (float32, int32) at batch 1 and 3, each ``torch.equal`` to its plain
   version, the fill also on a random (non-rank) dist plane; a star with
   a hub of degree 5,000 (the split into several launches) too; the
   device time of each scan op at path D's batches (1 and 2, float32) and
   at float64 beside its bound; the whole ``seg_reduce`` and
   ``broadcast`` against ``torch.segment_reduce`` and ``index_select``;
10. ``path_d`` — the general edge round: ``Engine`` with
   ``RoundConfig.reference('collectall', segment_impl='benes_fused',
   delivery='benes_fused')`` on the fat tree: routing time, the timeout
   bootstrap (no node fires in 49 rounds, every node in the 50th), ms/round
   over 150 rounds after the first 50, B3 and B4 launches equal to the
   count the plans and the round's calls give, a falling rmse, estimates
   after 60 rounds ``torch.equal`` to a ``'benes'`` twin and close to a
   ``'segment'``/``'gather'`` twin; then fast pairwise with
   ``segment_impl='benes_fused'`` (the native edge coloring) for 50 rounds,
   ``torch.equal`` to its ``'benes'`` twin;
11. ``path_g`` — the robust edge round on the fat tree, path D's config:
   G1 faithful collect-all with ``robust='trim'`` (its extreme marks take
   a float max and min and two int32 minima through B4's scans, and five
   more broadcasts through B3), G2 fast pairwise with ``robust='clip'``;
   the trim's armed nodes and the clip's edges at the clamp, ms/round, B3
   and B4 launches against the plans, each ``torch.equal`` to its
   ``'segment'``/``'gather'`` twin (estimates and flows);
   ``path_h`` — contention: H1 the same-model contract on the repo's
   small6 platform at two message sizes (rounds to rmse 1e-2 and 1e-3 of
   the kernel with ``contention_backlog``, float64, on the card and on
   the host, against the DES's backlog twin; collect-all equal to the
   DES at 1e6 bytes, pairwise within 50 rounds at 1e5), H2
   ``RoundConfig.fidelity`` against the dynamic max-min oracle, H3
   ``edge_delays`` alone on the fat tree with a link model (a shared
   host link per node, K = 2): device ms per call at ``contention_iters``
   0 and 4 and with backlog, two runs ``torch.equal``;
   ``des`` — the host DES on the fat tree (ticks per second at timeout
   1 and 50, three repeats, the host CPU named), and the faithful edge
   round on the card reaching the DES fixed point on ``ring(24, 2)``;
12. ``k5``    — kernel B5 (the per-shard banded round, the next round's
   fire folded into its merges) vs its plain version at 4 shards on
   ``ring(1_000_000, 2)`` (path B's plan: 8 band lanes, W = 1) and on
   ``grid2d(1000, 1000)`` (a remainder-heavy plan), float32 and float64:
   the fire-only launch, and the folded merges (``S'``, ``G'``, ``A`` and
   the next ``avg``) ``torch.equal`` over whole shards and over the split
   schedule (the interior launch, then one launch over both boundary
   ranges); device ms of a shard-round (interior plus boundary launch),
   of each launch, and of the fire-only launch apart, on the ring; then a
   stress run, ``ring(20000, 2)`` over 4 shards for 500 rounds, whose
   ``'pallas'`` and ``'ppermute'`` exchanges equal each other and the
   single-device ``banded_fused`` round bit for bit;
13. ``path_e`` — the sharded round: ``Engine`` with ``spmv='banded_fused'``
   over ``make_mesh(4)`` (all four shards on the one card) and
   ``halo='overlap'`` on the ring: ms/round, B5 launches == rounds x shards
   x launches per shard-round (2) with no fire in the timed rounds, halo
   bytes per round, estimates ``torch.equal`` to a ``halo='ppermute'``
   twin and to path B's single-device run of the same rounds, a falling
   rmse;
14. ``k6``    — kernel B6 (the halo block pull and its fused ring-buffer
   merge) vs its plain version at path F's shard shapes (its ``Eb``, ``D``
   and offset blocks): float32 and float64, scalar and 3 feature lanes,
   both entries, every receiving shard, ``torch.equal``; and on odd
   shapes (an ``Eb`` that is no multiple of the pack, three rows, blocks
   of odd length, sources off the 16-byte grid); device ms of one
   fused call, of the pull alone (on the same blocks, turning over four
   sets so its reads come from HBM, beside its byte bound), of the plain
   version and of the composition it replaces (three ``torch.where`` and the blocks'
   ``copy_``), and the call's bytes counted in 32-byte sectors (a floor
   below which no loads of whole sectors go; the bound stays the byte
   count); then a stress run of four shards on the card
   (``erdos_renyi(4000, 6)``, faithful collect-all with message loss, 200
   rounds) whose ``'overlap_pallas'`` state equals ``'ppermute'``'s;
15. ``path_f`` — the halo edge round: ``Engine(config=RoundConfig.
   reference('collectall'), mesh=make_mesh(4), multichip='halo',
   halo='overlap_pallas')`` on the fat tree (``partition='bfs'``, all four
   shards on the card): the plan (cut fraction, ``H``, offsets, wire
   bytes, the schedule ``'overlap'`` resolves to), ms/round after the
   timeout bootstrap, B6 launches == rounds x shards, every state leaf
   after 60 rounds ``torch.equal`` to its ``'ppermute'``, ``'allgather'``
   and ``'overlap'`` twins, its estimates equal to the single-device
   ``segment``/``gather`` round on the plan's BFS-renumbered topology,
   their distance from path D's twin on the original numbering (the
   renumbering reorders each row, and so the faithful drain's pick:
   reported, not bounded), the contiguous partition against path D's
   twin (recorded); then fast pairwise (``halo='overlap_pallas'``, B6's
   pull alone) for 50 rounds, equal to its ``'ppermute'`` twin, with a
   falling rmse (the faithful round's rmse swings for its first few
   hundred rounds in either numbering, so F1 reports its rmse);
16. ``c1``    — path E's sharded states are values: a ``run(st, 1)``
   loop against ``run(st, R)`` (device ms per round, the clones a
   ``run`` call costs), both equal, and a retained state run twice;
   ``path_i`` — checkpoints and faults at full size: I1 path D's engine
   saved (bytes, seconds), restored into a new engine on a new fat tree
   object (restore seconds split into the archive's load and
   ``_prepare_arrays``, which routes the networks again) and run 20
   rounds, every leaf ``torch.equal`` to the uninterrupted engine; I2 1%
   of the hosts killed (by name and by id) and 1,000 links failed after
   60 rounds, 30 rounds, revived and repaired, 60 rounds: dead nodes do
   not fire, nothing crosses a failed link, every revived node fires
   again (the rmse at the fault and at the end is reported: the faithful
   round's rmse swings for hundreds of rounds on a fat tree), every leaf
   equal to a ``'benes'`` twin and the estimates
   within ``EDGE_TWIN_ATOL`` of a ``'segment'``/``'gather'`` twin through
   the same sequence; fast pairwise never matches a failed link; I3 path
   F's halo state through ``gather_full_state`` -> ``scatter_full_state``
   (every leaf on the real slots), saved, resumed in a new halo engine
   (equal in the canonical layout, keys aside) and in a single-device
   engine (estimates at the restore within ``EDGE_TWIN_ATOL``); I4 path
   E's sharded state resumed on the mesh (B5 launches counted, every leaf
   equal), refused by the single-device kernel; I1 also times its first
   round apart and profiles the device time of I1 and D side by side;
   ``path_j`` — the structured stencil and the new mesh routes: J1
   ``spmv='structured'`` on the fat tree (ms/round, device time; 40
   float64 rounds within 1e-12 of ``spmv='xla'``; the virtual k=160 tree
   ``torch.equal`` to the materialized one); J2 the virtual fat tree
   k=640 (66,048,000 nodes, no edge arrays) on one card: build seconds,
   ms/round, device memory, a falling rmse, the estimates' mean at the
   true mean within ``DRIFT_ULPS`` ulps a round; J3 its pod kernel over
   ``make_mesh(4)``, plain and overlapped, equal to each other bit for
   bit and within ``POD_ULPS`` ulps of the largest neighbor sum of J2,
   at float64 on the virtual k=160 tree within 1e-12 of one device, and
   a pod archive resumed on one device within the float32 tolerance; J4
   ``Engine(mesh=make_mesh(4), spmv='benes_fused')`` on the fat tree:
   plan seconds, ms/round, B3 launches (shards x passes a round), the
   estimates equal to path C's bit for bit;
17. ``profile`` — ``torch.profiler`` over a few more rounds of each path:
   device time per round, the device's busy share of the wall time, the
   time of each hand-written kernel and of each flavour of B3 and B4, and
   the kernels that take the most;
   for paths E and F also the union of the busy intervals of their
   streams and the share of the copies' time that another stream's
   kernel overlaps (path F: its ``'overlap'`` twin, whose wire is copies);
18. the ``{"kernels": [...]}`` line (launches from the main paths; times,
    errors and bounds measured in this run), then the nvidia-smi line,
    then ``{"ok": true, "device": {...}}`` as the last line.

A kernel's ``ms``, ``plain_ms`` and ``library_ms`` are device time per
call: the profiler's sum over the call's CUDA kernels, averaged over
``REPS`` calls — each kernel's mean duration times its launches per call,
since a trace drops some of its device events — the largest of
``TRACES`` traces; a measurement whose traces all came back empty is
timed with CUDA events instead and named in the ``timing`` line before
the kernels line.  ``call_ms`` is the wrapper's time per call from CUDA
events around ``REPS`` back-to-back calls, host launch gaps included.
B3's yardstick is ``torch.index_select`` with the pass's own source index
(the pass applied to ``arange(P)``); the fill's is ``index_select`` with
each position's run head; no single library call computes a segmented
scan.  A B5 call is one shard's round (the interior merge and the
boundary merge, each firing the next round); a B6 call one shard's fused
pull and merge, whose
yardstick (``composition_ms``) is the tensor ops it replaces, since no
one PyTorch call does both.

Any failure raises and exits non-zero.  Without a CUDA device it exits
with code 2 and prints no result.  It takes no options: the sizes below
are the headline configurations, at full width.
"""

from __future__ import annotations

import itertools
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

FAT_TREE_K = 160        # fat_tree(160): 1,056,000 nodes (paths A, C; K1, B3)
RING_N = 1_000_000      # ring(1_000_000, 2) (path B, K2)
ROUNDS = 50             # timed rounds per main path
WARMUP = 5              # rounds before the timed ones
REPS = 20               # calls per kernel timing
TRACES = 3              # profiler traces per device-time measurement
PROFILE_ROUNDS = 20     # rounds per path under the profiler
EDGE_BOOT = 50          # path D: the faithful timeout (no fire before it)
EDGE_ROUNDS = 150       # path D: timed rounds after the bootstrap
TWIN_ROUNDS = 60        # path D: rounds before the twin comparisons
PAIRWISE_ROUNDS = 50    # path D: fast pairwise rounds
STAR_HUB = 5000         # k4: the hub degree that splits B4's passes
SHARDS = 4              # k5, path E: shards of the mesh (all on one card)
GRID_SIDE = 1000        # k5: grid2d(1000, 1000), the remainder-heavy plan
HALO_ROUNDS = 100       # path F: timed rounds after the twin comparison
STRESS_NODES = 4000     # k6: the stress run's erdos_renyi(4000, 6)
STRESS_ROUNDS = 200     # k6: the stress run's rounds
RING_STRESS_N = 20000   # k5: the stress run's ring(20000, 2)
RING_STRESS_ROUNDS = 500  # k5: the stress run's rounds
PULL_SETS = 4           # k6: block sets the pull's timing turns over
ROBUST_TOL = 0.05       # path G1: the trim's arming spread
ROBUST_CLIP = 0.01      # path G2: the ledger clamp
ROBUST_ROUNDS = 40      # path G: timed rounds
SMALL6_PLATFORM = "examples/platforms/small6.xml"
SMALL6_ACTORS = "examples/deployments/small6_actors.xml"
SMALL6_SCALE = 100.0    # path H1/H2: latency scale of small6
#: path H1/H2 message sizes: at 1e5 bytes every delay rounds to 1 round,
#: at 1e6 the delays reach 5 rounds and the contention binds
SMALL6_MSG_BYTES = (1e5, 1e6)
DES_TICKS = 1200        # path H1/H2: rounds (ticks) of each curve
OBS = 10                # path H1/H2: the curves' sampling interval
LINK_SER_ROUNDS = 0.01  # path H3: a message's serialization, in rounds
DES_BASE_TICKS = 10     # des: ticks of each timed DES run (k=160)
DES_REPEATS = 3         # des: timed runs per timeout
DES_FIXED_TICKS = 2000  # des: ring(24, 2) rounds to the fixed point
C1_ROUNDS = 20          # c1: rounds of path E per measurement
RESUME_ROUNDS = 20      # path I: rounds after each restore
FAULT_BOOT = 60         # I2: rounds before the faults (past the timeout)
FAULT_ROUNDS = 30       # I2: rounds with the faults in place
HEAL_ROUNDS = 60        # I2: rounds after the revival and the repair
KILL_SHARE = 0.01       # I2: share of the fat tree's hosts killed
FAILED_LINKS = 1000     # I2: undirected links failed
A6_ROUNDS = 20          # a6: rounds of each engine
#: path D's float32 estimates against the 'segment'/'gather' twin, whose
#: per-node sums add in another order (sequential rows vs the scan tree)
VIRTUAL_K = 640         # path J2/J3: fat_tree(640, materialize_edges=False),
#                         66,048,000 nodes and no edge arrays
J_CHECK_ROUNDS = 40     # J1, J3: float64 rounds held to a twin within 1e-12
STRUCT_TOL = 1e-12      # J1, J3: JAX's tolerance (tests/test_structured.py)
POD_ULPS = 8            # J3: float32 pod vs one device within this many
#                         ulps of the largest neighbor sum (k x max value):
#                         the core column is summed in another order
DRIFT_ULPS = 4          # J2: the estimates' mean within this many ulps of
#                         the largest value per round of the true mean
EDGE_TWIN_ATOL = 1e-4
SEED = 0

#: NVIDIA H100 SXM data sheet: peak HBM rate (bytes/s) and float32 rate
#: outside the tensor cores (FLOP/s)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12


T_START = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line also carries the seconds since the
    script started (``elapsed_s``)."""
    if "phase" in obj:
        obj = {**obj, "elapsed_s": time.perf_counter() - T_START}
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


def _device_rows(prof, n: int, only: str | None = None) -> list:
    """``(name, device us per unit, launches per unit)`` of every CUDA
    kernel, copy or memset of ``prof``, over ``n`` identical units (calls
    or rounds).  The trace drops some of its device events, more of them
    the longer the process has run (on the H100 machine: up to 16 of 20
    launches of one kernel), so a kernel's time is its mean duration over
    the events kept times its launches per unit, the kept count over ``n``
    rounded up."""
    from torch.autograd import DeviceType

    rows = []
    for ev in prof.key_averages():
        if (ev.device_type != DeviceType.CUDA or ev.count == 0
                or (only is not None and only not in ev.key)):
            continue
        per = -(-ev.count // n)
        rows.append((ev.key, ev.self_device_time_total / ev.count * per,
                     per))
    return rows


#: measurements whose every profiler trace held no device time, so that
#: :func:`device_ms` timed them with CUDA events (``phase`` and kernel)
EVENT_TIMED = []


def device_ms(fn, only: str | None = None) -> float:
    """Mean device milliseconds per call of ``fn`` from ``torch.profiler``
    over ``REPS`` calls (the kernels whose name contains ``only``, when
    given; :func:`_device_rows` makes up for dropped events): the largest
    of ``TRACES`` traces.  When every trace holds none (the profiler can
    drop all of a short kernel's events on the H100 machine), the call is
    timed with CUDA events instead (:func:`cuda_ms`, host launch gaps
    included) and listed in :data:`EVENT_TIMED`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    best = 0.0
    for _ in range(TRACES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                fn()
            torch.cuda.synchronize()
        best = max(best, sum(us for _, us, _ in _device_rows(prof, REPS,
                                                              only)))
    if best <= 0:
        label = f"{sys._getframe(1).f_code.co_name}: {only or 'call'}"
        print(f"chip_smoke: the profiler saw no device time in {TRACES} "
              f"traces ({label}); timed with CUDA events", file=sys.stderr)
        EVENT_TIMED.append(label)
        return cuda_ms(fn)
    return best / 1e3


def device_top(fn, n: int = 6) -> list:
    """The ``n`` CUDA kernels (or copies) that take the most device time
    in a call of ``fn``: ``torch.profiler`` over ``REPS`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    rows = sorted(_device_rows(prof, REPS), key=lambda r: -r[1])
    return [{"kernel": k[:90], "ms_per_call": us / 1e3,
             "launches_per_call": c} for k, us, c in rows[:n]]


def bound(nbytes: int, ops: int) -> dict:
    """The least time the card could take: the larger of the bytes over
    the HBM rate and the operations over the float32 rate."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / FP32_FLOP_PER_S * 1e3
    return {"bytes": nbytes, "ops": ops,
            "bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


#: B3's flavours: (row name, wrapper in ops/fused_passes.py, what the
#: names of its CUDA kernels hold, line of the TPU kernel in
#: flow_updating_tpu/ops/pallas_fused.py)
B3_FLAVOURS = (("local", "local_pass", "butterfly_pass", 292),
               ("window", "window_pass", "window_walk_pass", 323),
               ("wide", "wide_pass", "::wide_pass_", 356),
               ("wide2", "wide2_pass", "wide2_", 387))


#: B4's flavours: (row name, wrapper in ops/fused_passes.py, line of the
#: TPU kernel in flow_updating_tpu/ops/pallas_fused.py)
B4_FLAVOURS = (("scan", "segscan_pass", 475), ("fill", "fill_pass", 513))


#: the CUDA function names of B3's and B4's flavours (profile)
FLAVOUR_KERNELS = {"B3 local": ("::butterfly_pass<",),
                   "B3 window": ("::window_walk_pass<",),
                   "B3 wide": ("::wide_pass_swap<", "::wide_pass_roll<"),
                   "B3 wide2": ("::wide2_swap_group<", "::wide2_roll_chain<",
                                "::wide2_roll_gather<"),
                   "B4 scan": ("::scan_chunk_pass<",),
                   "B4 fill": ("::fill_walk_pass<",),
                   "B4 wide": ("::seg_wide_pass<",)}


def _family(prefix: str) -> tuple:
    return tuple(m for name, marks in FLAVOUR_KERNELS.items()
                 if name.startswith(prefix) for m in marks)


#: the hand-written kernels' CUDA function names, by kernel (profile)
KERNEL_FAMILIES = {"K1": ("spmv_ell_",), "K2": ("fused_round_kernel",),
                   "B3": _family("B3"), "B4": _family("B4"),
                   "B5": ("::sharded_fire_kernel<",
                          "::sharded_merge_kernel<"),
                   "B6": ("::exchange_kernel<",)}


def b3_family(kind: str) -> str:
    """The B3 flavour that runs a pass of ``kind``."""
    return kind.replace("_swap", "").replace("_roll", "")


def reset_counts() -> None:
    from flow_updating_tpu_torch.ops import (
        fused_passes,
        halo_exchange,
        sharded_round,
    )
    from flow_updating_tpu_torch.ops.fused_round import fused_banded_round
    from flow_updating_tpu_torch.ops.spmv import neighbor_sum_ell

    neighbor_sum_ell.launches = 0
    fused_banded_round.launches = 0
    sharded_round.sharded_fire.launches = 0
    sharded_round.sharded_round.launches = 0
    halo_exchange.fused_exchange_merge.launches = 0
    halo_exchange.remote_block_exchange.launches = 0
    for _, wrapper, _, _ in B3_FLAVOURS:
        getattr(fused_passes, wrapper).launches = 0
    for _, wrapper, _ in B4_FLAVOURS:
        getattr(fused_passes, wrapper).launches = 0


def b3_launches() -> dict:
    from flow_updating_tpu_torch.ops import fused_passes

    return {name: getattr(fused_passes, wrapper).launches
            for name, wrapper, _, _ in B3_FLAVOURS}


def b4_launches() -> dict:
    from flow_updating_tpu_torch.ops import fused_passes

    return {name: getattr(fused_passes, wrapper).launches
            for name, wrapper, _ in B4_FLAVOURS}


def b5_launches() -> dict:
    from flow_updating_tpu_torch.ops import sharded_round

    return {"fire": sharded_round.sharded_fire.launches,
            "merge": sharded_round.sharded_round.launches}


def b6_launches() -> dict:
    from flow_updating_tpu_torch.ops import halo_exchange

    return {"fused": halo_exchange.fused_exchange_merge.launches,
            "pull": halo_exchange.remote_block_exchange.launches}


def round_network_calls(cfg) -> dict:
    """Network applications and B4 calls of one edge round on the planned
    segment networks, by the round's code (models/rounds.py): deliver
    broadcasts ``alive`` and, per drain step, takes two segment minima and
    broadcasts each; collect-all fire reduces (flow, est) as one batched
    sum scan plus, in the faithful mode, the all-heard scan, through ONE
    extraction, and broadcasts (fire, avg) as one batch; fast pairwise
    fire reduces the flow sum, the matched max and the average sum one by
    one; delivery='benes_fused' moves the lanes through the rev network
    once."""
    faithful = cfg.fire_policy != "every_round"
    if cfg.variant == "collectall":
        scans = 2 * cfg.drain + 1 + int(faithful)
        extracts = 2 * cfg.drain + 1
        places = 1 + 2 * cfg.drain + 1
    elif not faithful:
        scans = extracts = 3
        places = 1
    else:
        raise ValueError("faithful pairwise is not a chip-smoke path")
    if cfg.robust == "trim":
        # the mark: est max and min, two int32 rank minima, and under
        # collect-all the trimmed sum and count (one scan and one
        # extraction each); broadcasts of the armed mask, the two
        # extremes and the two picked ranks
        extra = 6 if cfg.variant == "collectall" else 4
        scans += extra
        extracts += extra
        places += 5
    return {"scan": scans, "fill": places, "extract": extracts,
            "place": places, "rev": int(cfg.delivery == "benes_fused")}


def planned_launches(arrays, cfg) -> dict:
    """B3 launches per flavour and B4 launches per flavour of one edge
    round, from the plans (passes per network, B4 passes per stage list)
    and :func:`round_network_calls`."""
    from flow_updating_tpu_torch.ops.fused_passes import plan_dist_passes

    calls = round_network_calls(cfg)
    plan = arrays.seg_plan
    nets = [(calls["extract"], plan.extract_fused),
            (calls["place"], plan.place_fused)]
    if calls["rev"]:
        nets.append((calls["rev"], arrays.rev_plan.fused))
    out = {name: 0 for name, _, _, _ in B3_FLAVOURS}
    for times, fused in nets:
        for ps in fused.passes:
            out[b3_family(ps.kind)] += times
    n_b4 = len(plan_dist_passes(tuple(1 << k for k in range(plan.scan_bits)),
                                plan.geom))
    out["scan"] = calls["scan"] * n_b4
    out["fill"] = calls["fill"] * n_b4
    return out


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


def phase_k3(topo, dev, d_arrays):
    """B3 vs plain on the fat tree's network, as path C plans it; the
    wide passes also on path D's networks (``d_arrays``)."""
    import numpy as np
    import torch

    from flow_updating_tpu_torch.models.config import RoundConfig
    from flow_updating_tpu_torch.models.sync import NodeKernel
    from flow_updating_tpu_torch.ops import fused_passes as fp
    from flow_updating_tpu_torch.ops.permute import apply_stages
    from flow_updating_tpu_torch.ops.spmv_benes import plan_neighbor_sum

    xla = NodeKernel(topo, RoundConfig.fast(kernel="node", spmv="xla"),
                     device=dev)
    mats = tuple(m.cpu().numpy() for m in xla.arrays.mats)
    M = xla.padded_size
    del xla
    t0 = time.perf_counter()
    plan = plan_neighbor_sum(mats, M + 1, fused=True)
    plan_s = time.perf_counter() - t0
    stages, fused = plan.base.stages, plan.fused
    geom = fused.geom
    t0 = time.perf_counter()
    planes = plan.to(dev)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    by_flavour = {name: 0 for name, _, _, _ in B3_FLAVOURS}
    for ps in fused.passes:
        by_flavour[b3_family(ps.kind)] += 1
    out = {"P": geom.P, "tile": geom.tile, "grid": geom.grid,
           "plan_s": plan_s, "planes_upload_s": upload_s,
           "stages": len(stages.dists),
           "stages_by_kind": {k: stages.kinds.count(k)
                              for k in ("roll", "swap")},
           "passes": len(fused.passes), "passes_by_flavour": by_flavour,
           "pass_kinds": [ps.kind for ps in fused.passes],
           "stages_per_pass": [len(ps.dists) for ps in fused.passes],
           "flavours": {}}
    rng = np.random.default_rng(SEED + 2)
    P = geom.P
    shape = (1, geom.grid, geom.tile)
    idx = torch.arange(P, device=dev).reshape(shape)
    for name, wrapper_name, kernel, _ in B3_FLAVOURS:
        i = next((i for i, ps in enumerate(fused.passes)
                  if b3_family(ps.kind) == name), None)
        if i is None:
            raise AssertionError(f"the k={FAT_TREE_K} plan holds no "
                                 f"{name} pass")
        ps, plane = fused.passes[i], planes[i]
        wrapper = getattr(fp, wrapper_name)
        plain = fp.PLAIN_FNS[ps.kind]
        row = {"pass": i, "kind": ps.kind, "dists": list(ps.dists),
               "max_abs_err": 0.0}
        for dt, batch in ((torch.float32, 1), (torch.float64, 1),
                          (torch.float32, 3)):
            x = torch.from_numpy(rng.uniform(-1.0, 1.0, (batch,) + shape[1:])
                                 ).to(dev, dt)
            got, ref = wrapper(x, plane, ps, geom), plain(x, plane, ps, geom)
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            row["max_abs_err"] = max(row["max_abs_err"], err)
            if not torch.equal(got, ref):
                raise AssertionError(f"B3 {name} ({dt}, batch {batch}) "
                                     f"differs from its plain version "
                                     f"(max {err})")
        x = torch.from_numpy(rng.uniform(-1.0, 1.0, shape)).to(
            dev, torch.float32)
        src = wrapper(idx, plane, ps, geom).reshape(P)
        xf = x.reshape(P)
        if not torch.equal(torch.index_select(xf, 0, src),
                           wrapper(x, plane, ps, geom).reshape(P)):
            raise AssertionError(f"index_select yardstick does not compute "
                                 f"the {name} pass")
        row["ms"] = device_ms(lambda: wrapper(x, plane, ps, geom), kernel)
        row["call_ms"] = cuda_ms(lambda: wrapper(x, plane, ps, geom))
        row["plain_ms"] = device_ms(lambda: plain(x, plane, ps, geom))
        row["library_ms"] = device_ms(lambda: torch.index_select(xf, 0, src))
        # pure data movement: no arithmetic to bound by
        row.update(bound(fp.pass_min_bytes(ps, geom, 1, 4), 0))
        out["flavours"][name] = row
    local = fused.passes[out["flavours"]["local"]["pass"]]
    sched = fp.plan_local_schedule(local.dists, geom.tile)
    out["flavours"]["local"]["schedule"] = {
        "segment_ends": list(sched.seg_end), "exchanges": sched.exchanges}
    out["window_passes"] = [
        pass_timing(fused.passes[i], planes[i], i, geom, 1, rng, dev)
        for i, ps in enumerate(fused.passes) if ps.kind == "window"]
    out["wide2_batch3"] = [
        pass_timing(fused.passes[i], planes[i], i, geom, 3, rng, dev)
        for i in (next(i for i, ps in enumerate(fused.passes)
                       if ps.kind == kind)
                  for kind in ("wide_roll2", "wide_swap2"))]
    out["wide_passes"] = [
        {"network": "path_c", **pass_timing(ps, planes[i], i, geom, 1, rng,
                                            dev)}
        for i, ps in enumerate(fused.passes) if b3_family(ps.kind) == "wide"]
    for net, d_fused, d_planes, batch in path_d_networks(d_arrays):
        out["wide_passes"] += [
            {"network": net, **pass_timing(ps, d_planes[i], i, d_fused.geom,
                                           batch, rng, dev)}
            for i, ps in enumerate(d_fused.passes)
            if b3_family(ps.kind) == "wide"]
    out["local_tiles"] = local_tile_sweep(rng, dev)
    out["window_tiles"] = window_tile_sweep(rng, dev)
    out["wide_tiles"] = wide_tile_sweep(rng, dev)
    out["wide2_tiles"] = wide2_tile_sweep(rng, dev)
    # the whole network: every pass against the per-stage executor
    masks = stages.to(dev)
    for dt in (torch.float32, torch.float64):
        z = torch.from_numpy(rng.uniform(-1.0, 1.0, P)).to(dev, dt)
        got = fp.apply_fused(z, fused, planes)
        ref = apply_stages(z, stages, masks)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            raise AssertionError(f"apply_fused ({dt}) differs from "
                                 "apply_stages over the whole network")
    z = torch.from_numpy(rng.uniform(-1.0, 1.0, P)).to(dev, torch.float32)
    src = fp.apply_fused(torch.arange(P, device=dev), fused, planes)
    if not torch.equal(torch.index_select(z, 0, src),
                       fp.apply_fused(z, fused, planes)):
        raise AssertionError("index_select yardstick does not compute the "
                             "network")
    out["network"] = {
        "ms": device_ms(lambda: fp.apply_fused(z, fused, planes)),
        "call_ms": cuda_ms(lambda: fp.apply_fused(z, fused, planes)),
        "plain_ms": device_ms(lambda: apply_stages(z, stages, masks)),
        "library_ms": device_ms(lambda: torch.index_select(z, 0, src)),
        "bound_ms": sum(bound(fp.pass_min_bytes(ps, geom, 1, 4), 0)[
            "bound_ms"] for ps in fused.passes),
        "bound_by": "bytes"}
    del masks
    torch.cuda.empty_cache()
    return out


def path_d_networks(arrays) -> list:
    """Path D's three networks: ``(name, fused plan, mask planes, batch)``,
    the batch of each network's widest call in a round (the collect-all
    extraction of the flow sum, the est sum and all-heard; the placement
    of fire and avg; the delivery's flow, est and send lanes)."""
    plan = arrays.seg_plan
    return [("extract", plan.extract_fused, arrays.seg_extract_masks, 3),
            ("place", plan.place_fused, arrays.seg_place_masks, 2),
            ("rev", arrays.rev_plan.fused, arrays.rev_masks, 3)]


def pass_timing(ps, plane, i, geom, batch, rng, dev) -> dict:
    """One B3 pass of the k=160 plan at ``batch`` float32 rows: ``ms``
    (profiler device time of its kernel), ``call_ms``, ``library_ms``
    (``index_select`` of every row with the pass's source index) and
    ``bound_ms``, after ``torch.equal`` to its plain version."""
    import torch

    from flow_updating_tpu_torch.ops import fused_passes as fp

    name = b3_family(ps.kind)
    wrapper = fp.PASS_FNS[ps.kind]
    kernel = next(k for n, _, k, _ in B3_FLAVOURS if n == name)
    shape = (batch, geom.grid, geom.tile)
    x = torch.from_numpy(rng.uniform(-1.0, 1.0, shape)).to(dev,
                                                           torch.float32)
    if not torch.equal(wrapper(x, plane, ps, geom),
                       fp.PLAIN_FNS[ps.kind](x, plane, ps, geom)):
        raise AssertionError(f"B3 {name} pass {i} (batch {batch}) differs "
                             "from its plain version")
    idx = torch.arange(geom.P, device=dev).reshape(1, *shape[1:])
    src = wrapper(idx, plane, ps, geom).reshape(geom.P)
    xf = x.reshape(batch, geom.P)
    return {"pass": i, "kind": ps.kind, "stages": len(ps.dists),
            "dists": list(ps.dists), "batch": batch,
            "ms": device_ms(lambda: wrapper(x, plane, ps, geom), kernel),
            "call_ms": cuda_ms(lambda: wrapper(x, plane, ps, geom)),
            "library_ms": device_ms(
                lambda: torch.index_select(xf, 1, src)),
            **bound(fp.pass_min_bytes(ps, geom, batch, 4), 0)}


def _tiles_geometry(tile: int, grid: int):
    """``grid`` tiles of ``tile`` elements (below a row of 128 too: the
    kernels take any power-of-two tile)."""
    from flow_updating_tpu_torch.ops import fused_passes as fp

    return fp.Geometry(P=grid * tile, rows=max(grid * tile // 128, 1),
                       block_rows=max(tile // 128, 1), grid=grid)


def window_tile_sweep(rng, dev) -> list:
    """B3's window kernel at every tile from 2 to 4,096 elements (four
    tiles) on random lists of 1 and 32 roll distances below the window,
    random mask words, float32 and float64 at batch 1 and 3, each
    ``torch.equal`` to its plain version; returns the tiles."""
    import numpy as np
    import torch

    from flow_updating_tpu_torch.ops import fused_passes as fp

    tiles = []
    for n in range(1, 13):
        tile = 1 << n
        geom = _tiles_geometry(tile, 4)
        for k in (1, fp.MAX_STAGES_PER_PASS):
            dists = tuple(int(d) for d in rng.integers(1, 2 * tile, size=k))
            ps = fp.PassSpec(kind="window", dists=dists, block_dist=0)
            plane = torch.from_numpy(rng.integers(
                -2**31, 2**31, geom.P, dtype=np.int64).astype(np.int32)
            ).to(dev)
            for dt in (torch.float32, torch.float64):
                for batch in (1, 3):
                    x = torch.from_numpy(rng.uniform(
                        -1.0, 1.0, (batch, geom.grid, tile))).to(dev, dt)
                    if not torch.equal(
                            fp.window_pass(x, plane, ps, geom),
                            fp.window_pass_plain(x, plane, ps, geom)):
                        raise AssertionError(
                            f"B3 window ({dt}, batch {batch}) differs from "
                            f"its plain version at tile {tile}, stages "
                            f"{dists}")
        tiles.append(tile)
    return tiles


#: wide2 sweep cases (kind, D1, D2, tiles): roll chains, the general
#: roll form, swap groups of four and of two tiles
WIDE2_SWEEP = (("wide_roll2", 2, 1, 20), ("wide_roll2", 1, 2, 20),
               ("wide_roll2", 3, 3, 20), ("wide_roll2", 7, 3, 20),
               ("wide_swap2", 4, 1, 16), ("wide_swap2", 2, 2, 8))


#: wide sweep cases (kind, D, tiles): swap pairs, roll chains of one
#: tile, of unequal length (20 tiles mod 3) and past the tile count
WIDE_SWEEP = (("wide_swap", 1, 8), ("wide_swap", 4, 16), ("wide_roll", 1, 20),
              ("wide_roll", 3, 20), ("wide_roll", 25, 20))


def wide_tile_sweep(rng, dev) -> list:
    """B3's wide kernels at every tile from 1 to 4,096 elements over
    :data:`WIDE_SWEEP`, random int8 mask planes with zeros and non-zero
    bytes whose bit 0 is clear, float32 and float64 at batch 1 and 3,
    each ``torch.equal`` to its plain version; returns the tiles."""
    import numpy as np
    import torch

    from flow_updating_tpu_torch.ops import fused_passes as fp

    tiles = []
    for n in range(13):
        tile = 1 << n
        for kind, d, grid in WIDE_SWEEP:
            geom = _tiles_geometry(tile, grid)
            ps = fp.PassSpec(kind=kind, dists=(d * tile,), block_dist=d)
            bits = rng.integers(-128, 128, geom.P).astype(np.int8)
            bits[::3] = 0
            bits[1::5] = 2
            plane = torch.from_numpy(bits).to(dev)
            for dt in (torch.float32, torch.float64):
                for batch in (1, 3):
                    x = torch.from_numpy(rng.uniform(
                        -1.0, 1.0, (batch, grid, tile))).to(dev, dt)
                    if not torch.equal(fp.wide_pass(x, plane, ps, geom),
                                       fp.wide_pass_plain(x, plane, ps,
                                                          geom)):
                        raise AssertionError(
                            f"B3 {kind} ({dt}, batch {batch}) differs from "
                            f"its plain version at tile {tile}, D {d}")
        tiles.append(tile)
    return tiles


def wide2_tile_sweep(rng, dev) -> list:
    """B3's wide2 kernels at every tile from 2 to 4,096 elements over
    :data:`WIDE2_SWEEP`, random int8 mask planes, float32 and float64 at
    batch 1 and 3, each ``torch.equal`` to its plain version; returns
    the tiles."""
    import numpy as np
    import torch

    from flow_updating_tpu_torch.ops import fused_passes as fp

    tiles = []
    for n in range(1, 13):
        tile = 1 << n
        for kind, d1, d2, grid in WIDE2_SWEEP:
            geom = _tiles_geometry(tile, grid)
            ps = fp.PassSpec(kind=kind, dists=(d1 * tile, d2 * tile),
                             block_dist=d1, block_dist2=d2)
            plane = torch.from_numpy(rng.integers(
                -128, 128, geom.P).astype(np.int8)).to(dev)
            for dt in (torch.float32, torch.float64):
                for batch in (1, 3):
                    x = torch.from_numpy(rng.uniform(
                        -1.0, 1.0, (batch, grid, tile))).to(dev, dt)
                    if not torch.equal(
                            fp.wide2_pass(x, plane, ps, geom),
                            fp.wide2_pass_plain(x, plane, ps, geom)):
                        raise AssertionError(
                            f"B3 {kind} ({dt}, batch {batch}) differs from "
                            f"its plain version at tile {tile}, D1 {d1}, "
                            f"D2 {d2}")
        tiles.append(tile)
    return tiles


def local_tile_sweep(rng, dev) -> list:
    """B3's local kernel at every tile from 2 to 4,096 elements (four
    tiles, one below a row of 128) on a random list of 32 stages and on a
    one-stage list, random mask words, float32 and float64 at batch 3,
    each ``torch.equal`` to its plain version; returns the tiles."""
    import numpy as np
    import torch

    from flow_updating_tpu_torch.ops import fused_passes as fp

    tiles = []
    for n in range(1, 13):
        tile = 1 << n
        geom = (fp.geometry(tile) if tile < 128
                else fp.geometry(4 * tile, block_rows=tile // 128))
        for k in (1, fp.MAX_STAGES_PER_PASS):
            dists = tuple(1 << int(b) for b in rng.integers(0, n, size=k))
            ps = fp.PassSpec(kind="local", dists=dists, block_dist=0)
            plane = torch.from_numpy(rng.integers(
                -2**31, 2**31, geom.P, dtype=np.int64).astype(np.int32)
            ).to(dev)
            for dt in (torch.float32, torch.float64):
                x = torch.from_numpy(rng.uniform(
                    -1.0, 1.0, (3, geom.grid, tile))).to(dev, dt)
                if not torch.equal(fp.local_pass(x, plane, ps, geom),
                                   fp.local_pass_plain(x, plane, ps, geom)):
                    raise AssertionError(f"B3 local ({dt}) differs from its "
                                         f"plain version at tile {tile}, "
                                         f"stages {dists}")
        tiles.append(tile)
    return tiles


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


def _estimate_tensor(engine):
    arrs = engine._node_kernel.arrays
    return arrs.value + engine.state.G


def phase_path_c(topo):
    import numpy as np
    import torch

    from flow_updating_tpu_torch import Engine, RoundConfig

    cfg = RoundConfig.fast(kernel="node", spmv="benes_fused")
    t0 = time.perf_counter()
    eng = Engine(config=cfg).set_topology(topo).build()
    build_s = time.perf_counter() - t0
    rmse0 = eng.convergence_report()["rmse"]
    eng.run_rounds(WARMUP)
    passes = eng._node_kernel.arrays.ns_plan.fused.passes
    per_round = {name: 0 for name, _, _, _ in B3_FLAVOURS}
    for ps in passes:
        per_round[b3_family(ps.kind)] += 1
    reset_counts()
    ms = _timed_rounds(eng, ROUNDS)
    launches = b3_launches()
    if sum(launches.values()) != ROUNDS * len(passes):
        raise AssertionError(f"B3 launched {sum(launches.values())} times "
                             f"in {ROUNDS} rounds, expected "
                             f"{ROUNDS * len(passes)}")
    for name, count in per_round.items():
        if launches[name] != ROUNDS * count:
            raise AssertionError(f"B3 {name}: {launches[name]} launches, "
                                 f"expected {ROUNDS * count}")
    rep = eng.convergence_report()
    est = eng.estimates()
    if est.shape != (topo.num_nodes,) or not np.isfinite(est).all():
        raise AssertionError("path C estimates are not finite (N,) values")
    if not rep["rmse"] < rmse0:
        raise AssertionError("path C did not reduce the rmse")
    mine = _estimate_tensor(eng)
    twins = {}
    for spmv in ("benes", "xla"):
        twin = Engine(config=RoundConfig.fast(kernel="node", spmv=spmv))
        twin.set_topology(topo).build().run_rounds(WARMUP)
        twin_ms = _timed_rounds(twin, ROUNDS)
        other = _estimate_tensor(twin)
        twins[spmv] = {"equal": bool(torch.equal(mine, other)),
                       "max_abs_diff": float((mine - other).abs().max()),
                       "ms_per_round": twin_ms / ROUNDS}
        del twin
    for spmv, twin in twins.items():
        if not twin["equal"]:
            raise AssertionError(f"benes_fused estimates differ from "
                                 f"spmv={spmv!r} (max {twin['max_abs_diff']})")
    return {"rounds": ROUNDS, "ms_per_round": ms / ROUNDS,
            "rounds_per_s": ROUNDS / (ms / 1e3), "build_s": build_s,
            "passes_per_round": len(passes),
            "passes_per_round_by_flavour": per_round,
            "b3_launches": launches,
            "b3_launches_total": sum(launches.values()),
            "equal_to_benes": twins["benes"]["equal"],
            "benes_ms_per_round": twins["benes"]["ms_per_round"],
            "equal_to_xla": twins["xla"]["equal"],
            "max_abs_diff_to_xla": twins["xla"]["max_abs_diff"],
            "xla_ms_per_round": twins["xla"]["ms_per_round"],
            "rmse_initial": rmse0, **rep}, eng


def _b4_payload(rng, shape, dt, dev):
    import torch

    if dt == torch.int32:
        return torch.from_numpy(rng.integers(-10**6, 10**6, shape,
                                             dtype="int32")).to(dev)
    return torch.from_numpy(rng.uniform(-1.0, 1.0, shape)).to(dev, dt)


def _b4_cases(plan, dist, dev, rng, cases, batches=(1, 3)):
    """Each (op, dtype) case at each batch through B4 and its plain
    version; returns the largest error and raises unless torch.equal."""
    import torch

    from flow_updating_tpu_torch.ops import fused_passes as fp

    geom = plan.geom
    dists = tuple(1 << k for k in range(plan.scan_bits))
    err = 0.0
    for op, dt in cases:
        for batch in batches:
            x = _b4_payload(rng, (batch, geom.P), dt, dev)
            if op == "fill":
                got = fp.fill_pass(x, dist, dists, geom)
                ref = fp.fill_pass_plain(x, dist, dists, geom)
            else:
                got = fp.segscan_pass(x, dist, dists, op, geom)
                ref = fp.segscan_pass_plain(x, dist, dists, op, geom)
            e = float((got.double() - ref.double()).abs().max())
            err = max(err, e)
            if not torch.equal(got, ref):
                raise AssertionError(f"B4 {op} ({dt}, batch {batch}) "
                                     f"differs from its plain version "
                                     f"(max {e})")
    return err


def phase_k4(topo, arrays, dev):
    """B4 vs plain on path D's segment plan, plus the split path on a
    star and the whole reduce/broadcast against one library call."""
    import numpy as np
    import torch

    from flow_updating_tpu_torch.ops import fused_passes as fp
    from flow_updating_tpu_torch.ops.seg_benes import (
        broadcast,
        plan_segments,
        seg_reduce,
    )
    from flow_updating_tpu_torch.topology.graph import build_topology

    plan, dist = arrays.seg_plan, arrays.seg_dist
    geom = plan.geom
    P = geom.P
    dists = tuple(1 << k for k in range(plan.scan_bits))
    passes = fp.plan_dist_passes(dists, geom)
    rng = np.random.default_rng(SEED + 4)
    f32, f64, i32 = torch.float32, torch.float64, torch.int32
    cases = {"scan": (("sum", f32), ("sum", f64), ("min", f32),
                      ("max", f32), ("min", i32)),
             "fill": (("fill", f32), ("fill", i32))}
    out = {"P": P, "tile": geom.tile, "stages": list(dists),
           "passes": [[dp.kind, list(dp.dists)] for dp in passes],
           "flavours": {}}
    for name, _, _ in B4_FLAVOURS:
        row = {"cases": [[op, str(dt).replace("torch.", "")]
                         for op, dt in cases[name]], "batches": [1, 3],
               "max_abs_err": _b4_cases(plan, dist, dev, rng, cases[name])}
        x = _b4_payload(rng, (1, P), f32, dev)
        if name == "scan":
            run = lambda: fp.segscan_pass(x, dist, dists, "sum", geom)
            plain = lambda: fp.segscan_pass_plain(x, dist, dists, "sum", geom)
            ops = P * len(dists)
            row["library_ms"] = None
        else:
            run = lambda: fp.fill_pass(x, dist, dists, geom)
            plain = lambda: fp.fill_pass_plain(x, dist, dists, geom)
            ops = 0
            head = torch.arange(P, device=dev) - dist.long()
            if not torch.equal(torch.index_select(x[0], 0, head), run()[0]):
                raise AssertionError("index_select with the run heads does "
                                     "not compute the fill")
            row["library_ms"] = device_ms(
                lambda: torch.index_select(x[0], 0, head))
        row["ms"] = device_ms(run)
        row["call_ms"] = cuda_ms(run)
        row["plain_ms"] = device_ms(plain)
        row.update(bound(len(passes) * fp.dist_pass_min_bytes(geom, 1, 4),
                         ops))
        out["flavours"][name] = row
    # each scan op at path D's batches (the batched sum of flow and est;
    # the all-heard min and the drain's minima one plane each) and at
    # float64
    out["scan_timing"] = []
    for op in fp.SCAN_OPS:
        for dt, batch in ((f32, 1), (f32, 2), (f64, 1)):
            x = _b4_payload(rng, (batch, P), dt, dev)
            if not torch.equal(fp.segscan_pass(x, dist, dists, op, geom),
                               fp.segscan_pass_plain(x, dist, dists, op,
                                                     geom)):
                raise AssertionError(f"B4 {op} ({dt}, batch {batch}) "
                                     "differs from its plain version")
            run = lambda: fp.segscan_pass(x, dist, dists, op, geom)
            out["scan_timing"].append({
                "op": op, "dtype": str(dt).replace("torch.", ""),
                "batch": batch, "ms": device_ms(run), "call_ms": cuda_ms(run),
                **bound(len(passes) * fp.dist_pass_min_bytes(
                    geom, batch, x.element_size()),
                    P * len(dists) * batch)})
    # the fill on a dist plane that is no rank plane (random words)
    noise = torch.from_numpy(rng.integers(-2**31, 2**31, P, dtype=np.int64)
                             .astype(np.int32)).to(dev)
    out["fill_random_plane"] = {"max_abs_err": _b4_cases(
        plan, noise, dev, rng, (("fill", f32), ("fill", i32)))}
    # the split path: a star whose hub has STAR_HUB out-edges
    star = build_topology(STAR_HUB + 1,
                          [(0, i) for i in range(1, STAR_HUB + 1)],
                          warn_asymmetric=False)
    splan, sdist = plan_segments(star.row_start, star.out_deg,
                                 star.edge_rank, fused=True)
    sdist = torch.from_numpy(sdist).to(dev)
    sdists = tuple(1 << k for k in range(splan.scan_bits))
    skinds = [dp.kind for dp in fp.plan_dist_passes(sdists, splan.geom)]
    if "wide" not in skinds or skinds.count("window") < 2:
        raise AssertionError(f"the star's stages did not split: {skinds}")
    star_err = _b4_cases(splan, sdist, dev, rng,
                         (("sum", f32), ("min", i32), ("max", f64),
                          ("fill", f32)))
    for op in ("sum", "min", "fill"):
        x = _b4_payload(rng, (2, splan.P), f64, dev)
        loop = x.clone()
        for d in sdists:
            loop = fp.dist_stage(loop, torch.roll(loop, d, -1), sdist, d,
                                 op)
        got = (fp.fill_pass(x, sdist, sdists, splan.geom) if op == "fill"
               else fp.segscan_pass(x, sdist, sdists, op, splan.geom))
        if not torch.equal(got, loop):
            raise AssertionError(f"B4 {op} on the star differs from the "
                                 "unsplit stage loop")
    out["star"] = {"hub_degree": STAR_HUB, "P": splan.P,
                   "passes": skinds, "max_abs_err": star_err,
                   "equal_to_stage_loop": True}
    # the whole reduce (scan + extraction) and the whole broadcast
    # (placement + fill) against one library call each
    E, N = topo.num_edges, topo.num_nodes
    xe = torch.from_numpy(rng.uniform(-1.0, 1.0, E)).to(dev, f32)
    deg = arrays.out_deg
    red = lambda: seg_reduce(xe, "sum", plan, dist, arrays.seg_extract_masks)
    lib = lambda: torch.segment_reduce(xe, "sum", lengths=deg)
    red_err = float((red() - lib()).abs().max())
    if not red_err <= 1e-4:
        raise AssertionError(f"seg_reduce disagrees with segment_reduce "
                             f"(max {red_err})")
    vn = torch.from_numpy(rng.uniform(-1.0, 1.0, N)).to(dev, f32)
    bc = lambda: broadcast(vn, plan, dist, arrays.seg_place_masks)
    bc_lib = lambda: torch.index_select(vn, 0, arrays.src)
    if not torch.equal(bc(), bc_lib()):
        raise AssertionError("broadcast differs from index_select(v, src)")
    out["seg_reduce"] = {"ms": device_ms(red), "call_ms": cuda_ms(red),
                         "library_ms": device_ms(lib),
                         "max_abs_err_to_library": red_err}
    out["broadcast"] = {"ms": device_ms(bc), "call_ms": cuda_ms(bc),
                        "library_ms": device_ms(bc_lib),
                        "equal_to_library": True}
    out["max_abs_err"] = max(row["max_abs_err"]
                             for row in out["flavours"].values())
    return out


def _edge_estimates(engine):
    from flow_updating_tpu_torch.models.rounds import node_estimates

    return node_estimates(engine.state, engine._topo_arrays)


def build_path_d(topo):
    """Path D's engine: its build routes the extract, place and rev
    networks (cached on the topology for the twins)."""
    import torch

    from flow_updating_tpu_torch import Engine, RoundConfig

    cfg = RoundConfig.reference("collectall", segment_impl="benes_fused",
                                delivery="benes_fused")
    t0 = time.perf_counter()
    eng = Engine(config=cfg).set_topology(topo).build(seed=SEED)
    torch.cuda.synchronize()
    return eng, time.perf_counter() - t0


def phase_path_d(topo, eng, plan_s):
    import numpy as np
    import torch

    from flow_updating_tpu_torch import Engine, RoundConfig

    n = topo.num_nodes
    cfg = eng.config
    arrays = eng._topo_arrays
    eng.run_rounds(EDGE_BOOT - 1)
    fired49 = int(eng.state.fired.sum())
    rmse49 = eng.convergence_report()["rmse"]
    eng.run_rounds(1)
    fired50 = int(eng.state.fired.sum())
    if fired49 != 0 or fired50 != n:
        raise AssertionError(f"timeout bootstrap: {fired49} fired after "
                             f"{EDGE_BOOT - 1} rounds, {fired50} after "
                             f"{EDGE_BOOT} (expected 0 and {n})")
    expected = {k: v * EDGE_ROUNDS
                for k, v in planned_launches(arrays, cfg).items()}
    # 150 timed rounds in two stretches: the state after round 60 is kept
    # for the twin comparisons
    reset_counts()
    ms = _timed_rounds(eng, TWIN_ROUNDS - EDGE_BOOT)
    state60 = eng.state
    ms += _timed_rounds(eng, EDGE_ROUNDS - (TWIN_ROUNDS - EDGE_BOOT))
    got = {**b3_launches(), **b4_launches()}
    if got != expected:
        raise AssertionError(f"path D launches {got}, planned {expected}")
    rep = eng.convergence_report()
    est = eng.estimates()
    if est.shape != (n,) or not np.isfinite(est).all():
        raise AssertionError("path D estimates are not finite (N,) values")
    if not rep["rmse"] < rmse49:
        raise AssertionError(f"path D rmse {rep['rmse']} after "
                             f"{EDGE_BOOT + EDGE_ROUNDS} rounds is not below "
                             f"{rmse49} at round {EDGE_BOOT - 1}")
    from flow_updating_tpu_torch.models.rounds import node_estimates

    mine = node_estimates(state60, arrays)
    del state60
    twins = {}
    for seg, dlv in (("benes", "benes"), ("segment", "gather")):
        tcfg = RoundConfig.reference("collectall", segment_impl=seg,
                                     delivery=dlv)
        twin = Engine(config=tcfg).set_topology(topo).build(seed=SEED)
        twin_ms = _timed_rounds(twin, TWIN_ROUNDS)
        other = _edge_estimates(twin)
        twins[seg] = {"equal": bool(torch.equal(mine, other)),
                      "max_abs_diff": float((mine - other).abs().max()),
                      "ms_per_round": twin_ms / TWIN_ROUNDS}
        if seg == "segment":
            segment_est = other.cpu().numpy()
        del twin, other
        torch.cuda.empty_cache()
    if not twins["benes"]["equal"]:
        raise AssertionError("path D estimates differ from the 'benes' twin "
                             f"(max {twins['benes']['max_abs_diff']})")
    if not twins["segment"]["max_abs_diff"] <= EDGE_TWIN_ATOL:
        raise AssertionError("path D estimates are not within "
                             f"{EDGE_TWIN_ATOL} of the 'segment' twin "
                             f"(max {twins['segment']['max_abs_diff']})")
    # fast pairwise on the same segment networks, colored natively
    pcfg = RoundConfig.fast("pairwise", segment_impl="benes_fused")
    t0 = time.perf_counter()
    pw = Engine(config=pcfg).set_topology(topo).build(seed=SEED)
    pw_build_s = time.perf_counter() - t0
    pw_expected = planned_launches(pw._topo_arrays, pcfg)
    reset_counts()
    pw_ms = _timed_rounds(pw, PAIRWISE_ROUNDS)
    pw_got = {**b3_launches(), **b4_launches()}
    if pw_got != {k: v * PAIRWISE_ROUNDS for k, v in pw_expected.items()}:
        raise AssertionError(f"fast pairwise launches {pw_got}, planned "
                             f"{pw_expected} per round")
    pw_rep = pw.convergence_report()
    ptwin = Engine(config=RoundConfig.fast("pairwise", segment_impl="benes"))
    ptwin.set_topology(topo).build(seed=SEED).run_rounds(PAIRWISE_ROUNDS)
    if not torch.equal(_edge_estimates(pw), _edge_estimates(ptwin)):
        raise AssertionError("fast pairwise benes_fused differs from its "
                             "'benes' twin")
    pairwise = {"rounds": PAIRWISE_ROUNDS, "build_s": pw_build_s,
                "colors": pw._topo_arrays.num_colors,
                "ms_per_round": pw_ms / PAIRWISE_ROUNDS,
                "rounds_per_s": PAIRWISE_ROUNDS / (pw_ms / 1e3),
                "launches_per_round": pw_expected,
                "equal_to_benes": True, "rmse": pw_rep["rmse"],
                "mass_residual": pw_rep["mass_residual"]}
    del pw, ptwin
    torch.cuda.empty_cache()
    per_round = planned_launches(arrays, cfg)
    return {"plan_s": plan_s, "P": arrays.seg_plan.P,
            "rev_P": arrays.rev_plan.stages.n,
            "rounds_timed": EDGE_ROUNDS, "after_round": EDGE_BOOT,
            "ms_per_round": ms / EDGE_ROUNDS,
            "rounds_per_s": EDGE_ROUNDS / (ms / 1e3),
            "fired_after_49": fired49, "fired_after_50": fired50,
            "rmse_round_49": rmse49,
            "network_calls_per_round": round_network_calls(cfg),
            "launches_per_round": per_round,
            "b3_launches": {k: got[k] for k, _, _, _ in B3_FLAVOURS},
            "b4_launches": {k: got[k] for k, _, _ in B4_FLAVOURS},
            "twins_at_round": TWIN_ROUNDS,
            "equal_to_benes": True,
            "benes_ms_per_round": twins["benes"]["ms_per_round"],
            "max_abs_diff_to_segment": twins["segment"]["max_abs_diff"],
            "segment_atol": EDGE_TWIN_ATOL,
            "segment_ms_per_round": twins["segment"]["ms_per_round"],
            "pairwise_fast": pairwise, **rep}, segment_est


def _b5_inputs(kernel, rng, dt, dev):
    """Random round inputs of every shard of ``kernel`` on the card."""
    import torch

    spec = kernel.spec
    draw = lambda n: torch.from_numpy(  # noqa: E731
        rng.uniform(-1.0, 1.0, n)).to(dev, dt)
    return [{"S": draw(spec.local), "G": draw(spec.local),
             "avg_prev": draw(spec.local), "A_prev": draw(spec.local),
             "lo": draw(spec.halo), "hi": draw(spec.halo),
             "value": sh.value.to(dt), "inv": sh.inv_depp1.to(dt),
             "deg": sh.deg.to(dt)} for sh in kernel._shards]


def _b5_fire(sh, x, spec):
    """B5's fire-only launch: the ``avg`` a new state carries."""
    from flow_updating_tpu_torch.ops.sharded_round import sharded_fire

    return sharded_fire(x["value"], x["S"], x["A_prev"], x["inv"],
                        sh.leaves, spec)


def _b5_shard_round(sh, x, avg, spec, launches, out):
    """One shard-round of B5: one folded merge launch per entry of
    ``launches`` (one or two row ranges each), into ``out = (S', G', A,
    next avg)``."""
    from flow_updating_tpu_torch.ops.sharded_round import sharded_round

    for ranges in launches:
        sharded_round(x["S"], x["G"], x["avg_prev"], x["A_prev"], x["deg"],
                      avg, x["lo"], x["hi"], sh.leaves, spec, *ranges[0],
                      out, rows2=ranges[1] if len(ranges) > 1 else None,
                      fire=(x["value"], x["inv"]))
    return out


def _b5_plain(x, avg, sh, spec):
    """The plain composition a folded shard-round replaces: the merge of
    every row, then the next round's fire on what it wrote."""
    from flow_updating_tpu_torch.ops.sharded_round import (
        sharded_fire_plain,
        sharded_round_plain,
    )

    S_next, G_next, acc = sharded_round_plain(
        x["S"], x["G"], x["avg_prev"], x["A_prev"], x["deg"], avg, x["lo"],
        x["hi"], sh.leaves, spec, 0, spec.local_rows)
    return S_next, G_next, acc, sharded_fire_plain(x["value"], S_next, acc,
                                                   x["inv"])


def _b5_check(kernel, rng, dev, out):
    """B5 vs plain on every shard, float32 and float64: the fire-only
    launch, and the folded merges over a whole shard and over the
    overlapped schedule (interior, then both boundary ranges in one
    launch); ``torch.equal`` or raise."""
    import torch

    from flow_updating_tpu_torch.ops.sharded_round import (
        row_ranges,
        sharded_fire_plain,
    )

    spec = kernel.spec
    before, after = row_ranges(spec, "pallas")
    schedules = {"whole": [((0, spec.local_rows),)],
                 "overlapped": ([before] if before else []) + [after]}
    for name, dt in (("float32", torch.float32), ("float64", torch.float64)):
        for sh, x in zip(kernel._shards, _b5_inputs(kernel, rng, dt, dev)):
            avg = _b5_fire(sh, x, spec)
            want_avg = sharded_fire_plain(x["value"], x["S"], x["A_prev"],
                                          x["inv"])
            want = _b5_plain(x, want_avg, sh, spec)
            torch.cuda.synchronize()
            pairs = [((avg,), (want_avg,), ("avg",), "fire")]
            for sched, launches in schedules.items():
                got = [torch.full_like(avg, float("nan")) for _ in range(4)]
                _b5_shard_round(sh, x, avg, spec, launches, got)
                torch.cuda.synchronize()
                pairs.append((got, want, ("S'", "G'", "A", "next avg"),
                              sched))
            for gots, wants, whats, sched in pairs:
                for g, w, what in zip(gots, wants, whats):
                    err = float((g - w).abs().max())
                    out["max_abs_err"] = max(out["max_abs_err"], err)
                    if not torch.equal(g, w):
                        raise AssertionError(
                            f"B5 {name}/{sched}: {what} differs from the "
                            f"plain version (max {err})")


def _b5_stress(dev) -> dict:
    """RING_STRESS_ROUNDS rounds of ring(RING_STRESS_N, 2) over SHARDS
    shards: 'pallas' == 'ppermute' == the single-device banded_fused
    round, every state leaf bit for bit."""
    import numpy as np
    import torch

    from flow_updating_tpu_torch import NodeKernel, RoundConfig
    from flow_updating_tpu_torch.parallel.banded_sharded import (
        ShardedBandedKernel,
    )
    from flow_updating_tpu_torch.parallel.mesh import make_mesh
    from flow_updating_tpu_torch.plan import compile_topology
    from flow_updating_tpu_torch.topology.generators import ring

    cfg = RoundConfig.fast(kernel="node", spmv="banded_fused")
    topo = ring(RING_STRESS_N, 2)
    plan = compile_topology(topo, remainder="gather")
    single = NodeKernel(topo, cfg, plan=plan, device=dev)
    want = single.estimates(single.run(single.init_state(),
                                       RING_STRESS_ROUNDS))
    states = {}
    for exchange in ("pallas", "ppermute"):
        k = ShardedBandedKernel(topo, cfg, make_mesh(SHARDS), plan=plan,
                                exchange=exchange)
        st = k.run(k.init_state(), RING_STRESS_ROUNDS)
        torch.cuda.synchronize()
        if not np.array_equal(k.estimates(st), want):
            raise AssertionError(
                f"k5 stress: '{exchange}' differs from the single-device "
                f"banded_fused round after {RING_STRESS_ROUNDS} rounds")
        states[exchange] = [torch.cat([t.cpu() for t in getattr(st, f)])
                            for f in ("S", "G", "avg_prev", "A_prev",
                                      "avg")]
    if not all(torch.equal(a, b) for a, b in zip(states["pallas"],
                                                  states["ppermute"])):
        raise AssertionError("k5 stress: 'pallas' state differs from "
                             f"'ppermute' after {RING_STRESS_ROUNDS} rounds")
    return {"nodes": RING_STRESS_N, "shards": SHARDS,
            "rounds": RING_STRESS_ROUNDS, "equal_to_ppermute": True,
            "equal_to_single_device": True}


def phase_k5(ring_topo, dev):
    """B5 vs plain at SHARDS shards on the ring and on the grid; times on
    the ring (one shard's round, float32); the ring stress run."""
    import numpy as np
    import torch

    from flow_updating_tpu_torch import RoundConfig
    from flow_updating_tpu_torch.ops.sharded_round import (
        row_ranges,
        sharded_round_min_bytes,
    )
    from flow_updating_tpu_torch.parallel.banded_sharded import (
        ShardedBandedKernel,
    )
    from flow_updating_tpu_torch.parallel.mesh import make_mesh
    from flow_updating_tpu_torch.plan import compile_topology
    from flow_updating_tpu_torch.topology.generators import grid2d

    cfg = RoundConfig.fast(kernel="node", spmv="banded_fused")
    rng = np.random.default_rng(SEED + 5)
    out = {"shards": SHARDS, "max_abs_err": 0.0}
    t0 = time.perf_counter()
    grid = grid2d(GRID_SIDE, GRID_SIDE)
    out["grid_topology_s"] = time.perf_counter() - t0
    for label, topo in (("ring", ring_topo), ("grid", grid)):
        t0 = time.perf_counter()
        plan = compile_topology(topo, remainder="gather")
        plan_s = time.perf_counter() - t0
        k = ShardedBandedKernel(topo, cfg, make_mesh(SHARDS), plan=plan)
        spec = k.spec
        out[label] = {"nodes": topo.num_nodes, "plan_s": plan_s,
                      "bandwidth": plan.stats["bandwidth_after"],
                      "lanes": len(spec.offsets),
                      "remainder_edges": plan.spmv.remainder_edges,
                      "rem_route": spec.rem_route,
                      "rem_width": spec.rem_width, "P": spec.P,
                      "local": spec.local, "halo": spec.halo,
                      "row_ranges": row_ranges(spec, "pallas")}
        _b5_check(k, rng, dev, out)
        out[label]["exact"] = True
        if label != "ring":
            del k
            continue
        sh, x = k._shards[0], _b5_inputs(k, rng, torch.float32, dev)[0]
        before, after = row_ranges(spec, "pallas")
        avg = _b5_fire(sh, x, spec)
        res = [torch.empty_like(avg) for _ in range(4)]
        out["fire_ms"] = device_ms(lambda: _b5_fire(sh, x, spec))
        out["interior_ms"] = device_ms(lambda: _b5_shard_round(
            sh, x, avg, spec, [before], res))
        out["boundary_ms_per_launch"] = device_ms(lambda: _b5_shard_round(
            sh, x, avg, spec, [after], res))
        call = lambda: _b5_shard_round(  # noqa: E731
            sh, x, avg, spec, [before, after], res)
        out["launches_per_call"] = 2
        out["ms"] = device_ms(call)
        out["call_ms"] = cuda_ms(call)
        out["plain_ms"] = device_ms(lambda: _b5_plain(x, avg, sh, spec))
        out["library_ms"] = None   # no single PyTorch call computes it
        # per node: the fold's fire 3, one add per kept diagonal and
        # remainder slot, the remainder add, merge 8
        ops = spec.local * (12 + len(spec.offsets) + spec.rem_width)
        out.update(bound(sharded_round_min_bytes(spec, dtype_bytes=4), ops))
        del k
    del grid
    torch.cuda.empty_cache()
    out["stress"] = _b5_stress(dev)
    return out


def phase_path_e(ring_topo, engine_b):
    """The sharded round on SHARDS shards of the one card, overlapped
    exchange, against its serialized twin and path B."""
    import numpy as np
    import torch

    from flow_updating_tpu_torch import Engine, RoundConfig
    from flow_updating_tpu_torch.ops.sharded_round import (
        launches_per_shard_round,
    )
    from flow_updating_tpu_torch.parallel.mesh import make_mesh

    cfg = RoundConfig.fast(kernel="node", spmv="banded_fused")
    t0 = time.perf_counter()
    eng = Engine(config=cfg, mesh=make_mesh(SHARDS), halo="overlap")
    eng.set_topology(ring_topo).build()
    build_s = time.perf_counter() - t0
    kern = eng._node_kernel
    if kern.exchange != "pallas":
        raise AssertionError("halo='overlap' did not pick the overlapped "
                             "exchange")
    rmse0 = eng.convergence_report()["rmse"]
    eng.run_rounds(WARMUP)
    per_shard = launches_per_shard_round(kern.spec, "pallas")
    reset_counts()
    ms = _timed_rounds(eng, ROUNDS)
    got = b5_launches()
    if per_shard != 2 or got != {"fire": 0,
                                 "merge": ROUNDS * SHARDS * per_shard}:
        raise AssertionError(f"B5 launched {got} in {ROUNDS} rounds of "
                             f"{SHARDS} shards, expected 2 merges per "
                             "shard-round and no fire")
    rep = eng.convergence_report()
    est = eng.estimates()
    n = ring_topo.num_nodes
    if est.shape != (n,) or not np.isfinite(est).all():
        raise AssertionError("path E estimates are not finite (N,) values")
    if not rep["rmse"] < rmse0:
        raise AssertionError("path E did not reduce the rmse")
    twin = Engine(config=cfg, mesh=make_mesh(SHARDS), halo="ppermute")
    twin.set_topology(ring_topo).build()
    twin.run_rounds(WARMUP)
    twin_ms = _timed_rounds(twin, ROUNDS)
    if twin._node_kernel.exchange != "ppermute":
        raise AssertionError("halo='ppermute' did not pick the serialized "
                             "exchange")
    mine = torch.cat([v.cpu() for v in eng.state.G])
    other = torch.cat([v.cpu() for v in twin.state.G])
    if not torch.equal(mine, other):
        raise AssertionError("path E's overlapped exchange differs from its "
                             "serialized twin")
    if engine_b.state.t != eng.state.t:
        raise AssertionError("path B's engine is not at path E's round")
    single = engine_b.estimates()
    if not np.array_equal(est, single):
        raise AssertionError(
            "path E differs from path B's single-device banded_fused run "
            f"(max {float(np.abs(est - single).max())})")
    spec = kern.spec
    dtype_bytes = torch.finfo(cfg.torch_dtype).bits // 8
    del twin
    return {"rounds": ROUNDS, "shards": SHARDS,
            "devices": [str(d) for d in kern.mesh.devices],
            "build_s": build_s,
            "plan_reused_from_path_b": kern.plan is
            engine_b._node_kernel.plan,
            "ms_per_round": ms / ROUNDS, "rounds_per_s": ROUNDS / (ms / 1e3),
            "ppermute_ms_per_round": twin_ms / ROUNDS,
            "b5_launches": got, "launches_per_shard_round": per_shard,
            "halo_elements": spec.halo,
            "halo_bytes_per_round": 2 * spec.halo * SHARDS * dtype_bytes,
            "equal_to_ppermute": True, "equal_to_path_b": True,
            "rmse_initial": rmse0, **rep}, eng


class _HaloRun:
    """A halo-kernel twin run through the library (``parallel.sharded``)
    on a given plan: ``run_rounds(n)`` advances it, as an engine's does."""

    def __init__(self, plan, cfg, mesh, halo):
        from flow_updating_tpu_torch.parallel import sharded

        self.plan, self.cfg, self.mesh, self.halo = plan, cfg, mesh, halo
        self.arrays = sharded.plan_device_arrays(plan, mesh, halo=halo)
        self.state = sharded.init_plan_state(plan, cfg, mesh, seed=SEED)

    def run_rounds(self, n: int):
        from flow_updating_tpu_torch.parallel import sharded

        self.state = sharded.run_rounds_sharded(
            self.state, self.plan, self.cfg, self.mesh, n,
            arrays=self.arrays, halo=self.halo)
        return self

    def estimates(self):
        from flow_updating_tpu_torch.parallel import sharded

        return sharded.gather_estimates(self.state, self.plan)


def _states_equal(a, b) -> bool:
    """Every leaf of every shard of two halo states, ``torch.equal``."""
    import dataclasses

    import torch

    return all(torch.equal(getattr(x, f.name), getattr(y, f.name))
               for x, y in zip(a.shards, b.shards)
               for f in dataclasses.fields(x))


def build_path_f(topo):
    """Path F's engine: the faithful halo round over four shards of the
    card with B6's fused merge (its build plans the BFS partition)."""
    import torch

    from flow_updating_tpu_torch import Engine, RoundConfig
    from flow_updating_tpu_torch.parallel.mesh import make_mesh

    t0 = time.perf_counter()
    eng = Engine(config=RoundConfig.reference("collectall"),
                 mesh=make_mesh(SHARDS), multichip="halo",
                 halo="overlap_pallas", partition="bfs")
    eng.set_topology(topo).build(seed=SEED)
    torch.cuda.synchronize()
    return eng, time.perf_counter() - t0


def _b6_inputs(rng, plan, rows, dt, nf, dev, D=1):
    """Random B6 inputs at ``plan``'s shard shapes: every shard's block per
    offset, ``(rows, Hd)``, and the merge operands of one shard."""
    import torch

    hds = [int(t.shape[1]) for t in plan.perm_tables.send_idx]
    feat = (nf,) if nf > 1 else ()
    draw = lambda shape: torch.from_numpy(  # noqa: E731
        rng.uniform(-1.0, 1.0, shape)).to(dev, dt)
    blocks = [[draw((rows, hd)) for hd in hds]
              for _ in range(plan.num_shards)]
    Eb = plan.Eb
    merge = (torch.from_numpy(rng.random((D, Eb)) < 0.3).to(dev),
             draw((Eb,) + feat), draw((Eb,) + feat), draw((D, Eb) + feat),
             draw((D, Eb) + feat),
             torch.from_numpy(rng.random((D, Eb)) < 0.5).to(dev))
    return blocks, merge


def _b6_odd_inputs(rng, shards, n_off, dt, nf, dev, D=3, Eb=100_003):
    """B6 inputs at odd shapes: an Eb off every pack, D rows, blocks of
    odd length whose sources start 1 element off the 16-byte grid."""
    import torch

    feat = (nf,) if nf > 1 else ()
    draw = lambda shape: torch.from_numpy(  # noqa: E731
        rng.uniform(-1.0, 1.0, shape)).to(dev, dt)

    def block(rows, hd):
        buf = draw(rows * hd + 1)
        return buf[1:].view(rows, hd)

    rows = 2 * nf + 1
    blocks = [[block(rows, 4099 + 2 * i) for i in range(n_off)]
              for _ in range(shards)]
    merge = (torch.from_numpy(rng.random((D, Eb)) < 0.3).to(dev),
             draw((Eb,) + feat), draw((Eb,) + feat), draw((D, Eb) + feat),
             draw((D, Eb) + feat),
             torch.from_numpy(rng.random((D, Eb)) < 0.5).to(dev))
    return blocks, merge


def _sector_bytes(hit, itemsize: int, block_bytes) -> int:
    """The bytes a fused B6 call with scalar lanes moves when counted in
    whole 32-byte sectors: each block read and written; ``hit``, the
    valid flags read where a sector holds a miss, ``out_valid`` written;
    the payload planes read where a sector holds a hit column, the ring
    buffers where it holds a miss, the outputs written."""
    import torch

    def sectors(mask, per):
        flat = mask.reshape(-1)
        pad = (-flat.numel()) % per
        flat = torch.cat([flat, flat.new_zeros(pad)])
        return int(flat.view(-1, per).any(1).sum())

    every = torch.ones_like(hit)
    miss = ~hit
    per = 32 // itemsize
    pull = sum(2 * 32 * -(-b // 32) for b in block_bytes)
    flags = sectors(every, 32) + sectors(miss, 32) + sectors(every, 32)
    vals = sectors(hit.any(0), per) * hit.shape[0] + sectors(miss, per) \
        + sectors(every, per)
    return pull + 32 * flags + 2 * 32 * vals


def phase_k6(plan, cfg, dev):
    """B6 vs plain at path F's shard shapes; times of one fused call;
    the four-shard stress run."""
    import dataclasses

    import numpy as np
    import torch

    from flow_updating_tpu_torch import RoundConfig
    from flow_updating_tpu_torch.ops import halo_exchange as hx
    from flow_updating_tpu_torch.parallel import sharded
    from flow_updating_tpu_torch.parallel.mesh import make_mesh
    from flow_updating_tpu_torch.topology.generators import erdos_renyi

    rng = np.random.default_rng(SEED + 6)
    offsets, D = plan.perm_offsets, cfg.delay_depth
    if not offsets:
        raise AssertionError("path F's plan has no cut edge to exchange")
    out = {"shards": plan.num_shards, "Eb": plan.Eb, "D": D,
           "offsets": list(offsets),
           "Hd": [int(t.shape[1]) for t in plan.perm_tables.send_idx],
           "max_abs_err": 0.0, "cases": []}
    for dt in (torch.float32, torch.float64):
        for nf in (1, 3):
            for mode in ("fused", "pull"):
                rows = 2 * nf + 1 if mode == "fused" else nf + 1
                blocks, merge = _b6_inputs(rng, plan, rows, dt, nf, dev, D)
                for me in range(plan.num_shards):
                    if mode == "fused":
                        got = hx.fused_exchange_merge(blocks, offsets, me,
                                                      *merge)
                        want = hx.fused_exchange_merge_plain(
                            blocks, offsets, me, *merge)
                        pairs = list(zip(got[0], want[0])) + list(
                            zip(got[1:], want[1:]))
                    else:
                        pairs = list(zip(
                            hx.remote_block_exchange(blocks, offsets, me),
                            hx.remote_block_exchange_plain(blocks, offsets,
                                                           me)))
                    torch.cuda.synchronize()
                    for g, w in pairs:
                        err = float((g.double() - w.double()).abs().max())
                        out["max_abs_err"] = max(out["max_abs_err"], err)
                        if not torch.equal(g, w):
                            raise AssertionError(
                                f"B6 {mode} ({dt}, nf={nf}, shard {me}) "
                                f"differs from its plain version (max {err})")
                out["cases"].append([mode, str(dt).replace("torch.", ""),
                                     nf])
    # odd shapes: the pack's row tails, unaligned rows and sources
    for dt in (torch.float32, torch.float64):
        for nf in (1, 3):
            blocks, merge = _b6_odd_inputs(rng, plan.num_shards,
                                           len(offsets), dt, nf, dev)
            for me in range(plan.num_shards):
                got = hx.fused_exchange_merge(blocks, offsets, me, *merge)
                pull = hx.remote_block_exchange(blocks, offsets, me)
                want = hx.fused_exchange_merge_plain(blocks, offsets, me,
                                                     *merge)
                torch.cuda.synchronize()
                pairs = (list(zip(got[0], want[0])) + list(zip(pull,
                                                               want[0]))
                         + list(zip(got[1:], want[1:])))
                if not all(torch.equal(g, w) for g, w in pairs):
                    raise AssertionError(
                        f"B6 at odd shapes ({dt}, nf={nf}, shard {me}) "
                        "differs from its plain version")
            out["cases"].append(["odd", str(dt).replace("torch.", ""), nf])
    # one shard's fused call at the path's shapes, float32, scalar lanes
    blocks, merge = _b6_inputs(rng, plan, 3, torch.float32, 1, dev, D)
    call = lambda: hx.fused_exchange_merge(  # noqa: E731
        blocks, offsets, 0, *merge)
    senders = [blocks[(0 - d) % plan.num_shards][i]
               for i, d in enumerate(offsets)]
    recv = [torch.empty_like(b) for b in senders]
    hit, pf, pe, bf, be, bv = merge

    def composition():
        for r, b in zip(recv, senders):
            r.copy_(b)
        return (torch.where(hit, pf[None], bf), torch.where(hit, pe[None], be),
                torch.where(hit, True, bv))

    out["ms"] = device_ms(call, "exchange_kernel")
    out["call_ms"] = cuda_ms(call)
    out["plain_ms"] = device_ms(lambda: hx.fused_exchange_merge_plain(
        blocks, offsets, 0, *merge))
    out["composition_ms"] = device_ms(composition)
    out["library_ms"] = None   # no one PyTorch call does pull and merge
    # the pull alone on the fused call's 3-row blocks, turning over sets
    # that together outgrow the 50 MB L2, so its reads come from HBM as
    # its byte bound counts them
    pull_sets = [blocks] + [
        _b6_inputs(rng, plan, 3, torch.float32, 1, dev, D)[0]
        for _ in range(PULL_SETS - 1)]
    turn = itertools.count()
    out["pull_ms"] = device_ms(lambda: hx.remote_block_exchange(
        pull_sets[next(turn) % PULL_SETS], offsets, 0), "exchange_kernel")
    out["pull_bound_ms"] = hx.halo_exchange_min_bytes(
        [b.numel() for b in senders], 4) / HBM_BYTES_PER_S * 1e3
    del pull_sets
    # pure data movement: no arithmetic to bound by
    out.update(bound(hx.halo_exchange_min_bytes(
        [b.numel() for b in senders], 4, D, plan.Eb, 1,
        hit_cells=int(hit.sum()), hit_columns=int(hit.any(0).sum())), 0))
    out["hit_share"] = float(hit.float().mean())
    out["sector_bytes"] = _sector_bytes(hit, 4, [b.numel() * 4
                                                 for b in senders])
    out["sector_floor_ms"] = out["sector_bytes"] / HBM_BYTES_PER_S * 1e3
    # the stream order under load: four shards, small Eb, many rounds
    topo = erdos_renyi(STRESS_NODES, 6.0, seed=SEED + 6)
    scfg = dataclasses.replace(RoundConfig.reference("collectall",
                                                     delay_depth=2),
                               drop_rate=0.2)
    splan = sharded.plan_sharding(topo, SHARDS, partition="bfs")
    mesh = make_mesh(SHARDS)
    runs = {halo: _HaloRun(splan, scfg, mesh, halo).run_rounds(STRESS_ROUNDS)
            for halo in ("ppermute", "overlap_pallas")}
    if not _states_equal(runs["ppermute"].state,
                         runs["overlap_pallas"].state):
        raise AssertionError("stress: 'overlap_pallas' state differs from "
                             "'ppermute' after "
                             f"{STRESS_ROUNDS} rounds")
    out["stress"] = {"nodes": STRESS_NODES, "shards": SHARDS,
                     "Eb": splan.Eb, "offsets": len(splan.perm_offsets),
                     "rounds": STRESS_ROUNDS, "equal_to_ppermute": True}
    del runs
    return out


def phase_path_f(topo, eng, build_s, segment_est):
    """The halo edge round on four shards of the card: F1 (faithful
    collect-all, B6 fused) against its twins, then F2 (fast pairwise, B6's
    pull)."""
    import numpy as np
    import torch

    from flow_updating_tpu_torch import Engine, RoundConfig
    from flow_updating_tpu_torch.parallel import overlap, sharded
    from flow_updating_tpu_torch.parallel.mesh import make_mesh

    n = topo.num_nodes
    plan, cfg, mesh = eng._halo_plan, eng.config, eng.mesh
    wire = plan.collective_bytes_per_round(4)
    out = {"shards": SHARDS, "devices": [str(d) for d in mesh.devices],
           "build_s": build_s, "partition": "bfs",
           "cut_fraction": plan.cut_fraction, "Eb": plan.Eb, "H": plan.H,
           "num_offsets": len(plan.perm_offsets),
           "offsets": list(plan.perm_offsets),
           "ppermute_bytes": wire["ppermute_bytes"],
           "allgather_bytes": wire["allgather_bytes"],
           "cut_edges": wire["cut_edges"],
           "schedule_of_overlap": overlap.resolve_mode(plan, "overlap"),
           "halo_report": eng.halo_report()}
    reset_counts()
    boot_ms = _timed_rounds(eng, EDGE_BOOT - 1)
    rmse49 = eng.convergence_report()["rmse"]
    ms = _timed_rounds(eng, TWIN_ROUNDS - EDGE_BOOT + 1)
    # the twins on the same plan, from the same seed, after the same rounds
    est60 = eng.estimates()
    twins = {}
    for halo in ("ppermute", "allgather", "overlap"):
        twin = _HaloRun(plan, cfg, mesh, halo)
        twin_ms = _timed_rounds(twin, TWIN_ROUNDS)
        twins[halo] = {"equal": _states_equal(eng.state, twin.state),
                       "ms_per_round": twin_ms / TWIN_ROUNDS}
        if halo == "overlap":
            profile_twin = twin
        del twin
    for halo, twin in twins.items():
        if not twin["equal"]:
            raise AssertionError(f"path F's state differs from its "
                                 f"'{halo}' twin after {TWIN_ROUNDS} rounds")
    # the single-device round on the plan's BFS-renumbered topology: the
    # renumbering changes each row's edge order, hence the faithful
    # drain's round-robin pick, so this, not path D's run on the original
    # numbering, is the round the halo kernel must equal
    single = Engine(config=cfg).set_topology(plan.topo).build(seed=SEED)
    single.run_rounds(TWIN_ROUNDS)
    reordered_est = single.estimates()
    del single
    if not np.array_equal(est60[plan.order], reordered_est):
        raise AssertionError(
            "path F differs from the single-device round on its renumbered "
            "topology (max "
            f"{float(np.abs(est60[plan.order] - reordered_est).max())})")
    seg_diff = float(np.abs(est60 - segment_est).max())
    ms += _timed_rounds(eng, HALO_ROUNDS)
    got = b6_launches()
    rounds_run = EDGE_BOOT - 1 + TWIN_ROUNDS - EDGE_BOOT + 1 + HALO_ROUNDS
    if got != {"fused": rounds_run * SHARDS, "pull": 0}:
        raise AssertionError(f"B6 launched {got} in {rounds_run} rounds of "
                             f"{SHARDS} shards, expected one fused launch "
                             "per shard-round")
    # the faithful fat-tree round swings for its first few hundred rounds
    # (drain 1 at degree-160 switches) in either numbering, so the falling
    # rmse is checked on F2; F1's correctness is its equalities above
    rep = eng.convergence_report()
    est = eng.estimates()
    if est.shape != (n,) or not np.isfinite(est).all():
        raise AssertionError("path F estimates are not finite (N,) values")
    t0 = time.perf_counter()
    sharded.plan_sharding(topo, SHARDS, partition="bfs")
    out["plan_s"] = time.perf_counter() - t0
    # the contiguous partition against the single-device round: recorded
    t0 = time.perf_counter()
    cplan = sharded.plan_sharding(topo, SHARDS, partition="contiguous")
    contiguous = _HaloRun(cplan, cfg, mesh, "overlap_pallas")
    c_build_s = time.perf_counter() - t0
    contiguous.run_rounds(TWIN_ROUNDS)
    c_est = contiguous.estimates()
    del contiguous
    out.update({
        "rounds_boot": EDGE_BOOT - 1, "boot_ms_per_round":
        boot_ms / (EDGE_BOOT - 1),
        "rounds_timed": TWIN_ROUNDS - EDGE_BOOT + 1 + HALO_ROUNDS,
        "after_round": EDGE_BOOT - 1,
        "ms_per_round": ms / (TWIN_ROUNDS - EDGE_BOOT + 1 + HALO_ROUNDS),
        "rounds_per_s": (TWIN_ROUNDS - EDGE_BOOT + 1 + HALO_ROUNDS)
        / (ms / 1e3),
        "b6_launches": got, "b6_launches_per_round": got["fused"]
        / rounds_run,
        "twins_at_round": TWIN_ROUNDS,
        "equal_to": {h: t["equal"] for h, t in twins.items()},
        "twin_ms_per_round": {h: t["ms_per_round"]
                              for h, t in twins.items()},
        "equal_to_single_device_renumbered": True,
        "max_abs_diff_to_path_d_segment": seg_diff,
        "contiguous": {
            "build_s": c_build_s, "cut_fraction": cplan.cut_fraction,
            "num_offsets": len(cplan.perm_offsets),
            "equal_to_single_device": bool(np.array_equal(c_est,
                                                          segment_est)),
            "max_abs_diff_to_single_device": float(
                np.abs(c_est - segment_est).max())},
        "rmse_round_49": rmse49, **rep})
    # F2: fast pairwise, B6's block pull alone
    pcfg = RoundConfig.fast("pairwise")
    t0 = time.perf_counter()
    f2 = Engine(config=pcfg, mesh=make_mesh(SHARDS), multichip="halo",
                halo="overlap_pallas").set_topology(topo).build(seed=SEED)
    torch.cuda.synchronize()
    f2_build_s = time.perf_counter() - t0
    f2_rmse0 = f2.convergence_report()["rmse"]
    reset_counts()
    f2_ms = _timed_rounds(f2, PAIRWISE_ROUNDS)
    f2_got = b6_launches()
    if f2_got != {"fused": 0, "pull": PAIRWISE_ROUNDS * SHARDS}:
        raise AssertionError(f"fast pairwise launched B6 {f2_got} in "
                             f"{PAIRWISE_ROUNDS} rounds, expected one pull "
                             "per shard-round")
    f2_twin = _HaloRun(f2._halo_plan, pcfg, f2.mesh, "ppermute")
    f2_twin_ms = _timed_rounds(f2_twin, PAIRWISE_ROUNDS)
    if not (_states_equal(f2.state, f2_twin.state)
            and np.array_equal(f2.estimates(), f2_twin.estimates())):
        raise AssertionError("fast pairwise 'overlap_pallas' differs from "
                             "its 'ppermute' twin")
    f2_rep = f2.convergence_report()
    if not f2_rep["rmse"] < f2_rmse0:
        raise AssertionError(f"path F2 rmse {f2_rep['rmse']} after "
                             f"{PAIRWISE_ROUNDS} rounds is not below the "
                             f"initial {f2_rmse0}")
    out["pairwise_fast"] = {
        "rounds": PAIRWISE_ROUNDS, "build_s": f2_build_s,
        "colors": f2._halo_plan.num_colors,
        "ms_per_round": f2_ms / PAIRWISE_ROUNDS,
        "rounds_per_s": PAIRWISE_ROUNDS / (f2_ms / 1e3),
        "ppermute_ms_per_round": f2_twin_ms / PAIRWISE_ROUNDS,
        "b6_launches": f2_got, "equal_to_ppermute": True,
        "rmse_initial": f2_rmse0, "rmse": f2_rep["rmse"],
        "mass_residual": f2_rep["mass_residual"]}
    del f2, f2_twin
    torch.cuda.empty_cache()
    return out, profile_twin


# ---- slice 11: robust modes, contention, the DES and value states --------

def _armed(eng) -> dict:
    """Trim's marks in an edge engine's current state: marked edges and
    the nodes that mark them (armed nodes)."""
    import torch

    from flow_updating_tpu_torch.models.rounds import _trim_extreme_edges

    a = eng._topo_arrays
    mark = _trim_extreme_edges(eng.state, a, eng.config,
                               eng.config.torch_dtype)
    return {"marked_edges": int(mark.sum()),
            "armed_nodes": int(torch.unique(a.src[mark]).numel())}


def _robust_run(topo, cfg, boot: int, rounds: int, twin_rounds: int,
                what: str) -> tuple:
    """One robust edge engine on the fat tree: ``boot`` rounds, ``rounds``
    timed rounds with the B3/B4 counts set to 0 just before them (checked
    against the plans), then its ``segment``/``gather`` twin at round
    ``twin_rounds``, held bit for bit.  Returns ``(report, engine)``."""
    import dataclasses

    import numpy as np
    import torch

    from flow_updating_tpu_torch import Engine
    from flow_updating_tpu_torch.models.rounds import node_estimates

    t0 = time.perf_counter()
    eng = Engine(config=cfg).set_topology(topo).build(seed=SEED)
    build_s = time.perf_counter() - t0
    rmse0 = eng.convergence_report()["rmse"]
    eng.run_rounds(boot)
    armed_first = _armed(eng) if cfg.robust == "trim" else None
    per_round = planned_launches(eng._topo_arrays, cfg)
    reset_counts()
    ms = _timed_rounds(eng, twin_rounds - boot)
    first = {**b3_launches(), **b4_launches()}
    mine = node_estimates(eng.state, eng._topo_arrays)   # not counted
    flow_at_twin = eng.state.flow.clone()
    reset_counts()
    ms += _timed_rounds(eng, rounds - (twin_rounds - boot))
    got = {k: v + first[k] for k, v in {**b3_launches(),
                                        **b4_launches()}.items()}
    if got != {k: v * rounds for k, v in per_round.items()}:
        raise AssertionError(f"{what} launches {got}, planned {per_round} "
                             f"per round x {rounds}")
    rep = eng.convergence_report()
    est = eng.estimates()
    if est.shape != (topo.num_nodes,) or not np.isfinite(est).all():
        raise AssertionError(f"{what} estimates are not finite (N,) values")
    twin_cfg = dataclasses.replace(cfg, segment_impl="segment",
                                   delivery="gather")
    twin = Engine(config=twin_cfg).set_topology(topo).build(seed=SEED)
    twin_ms = _timed_rounds(twin, twin_rounds)
    other = node_estimates(twin.state, twin._topo_arrays)
    diff = float((mine - other).abs().max())
    flow_equal = bool(torch.equal(flow_at_twin, twin.state.flow))
    if diff != 0.0 or not flow_equal:
        raise AssertionError(f"{what} differs from its segment/gather twin "
                             f"at round {twin_rounds} (estimates max "
                             f"{diff}, flows equal: {flow_equal})")
    out = {"config": {k: getattr(cfg, k) for k in (
               "variant", "fire_policy", "robust", "robust_tol",
               "robust_clip", "segment_impl", "delivery", "dtype")},
           "build_s": build_s, "rounds_timed": rounds, "after_round": boot,
           "ms_per_round": ms / rounds, "rounds_per_s": rounds / (ms / 1e3),
           "launches_per_round": per_round,
           "b3_launches": {k: got[k] for k, _, _, _ in B3_FLAVOURS},
           "b4_launches": {k: got[k] for k, _, _ in B4_FLAVOURS},
           "twin_at_round": twin_rounds, "max_abs_diff_to_segment": diff,
           "flow_equal_to_segment": flow_equal,
           "segment_ms_per_round": twin_ms / twin_rounds,
           "rmse_initial": rmse0, **rep}
    if armed_first is not None:
        out["armed_at_round"] = {str(boot): armed_first,
                                 str(boot + rounds): _armed(eng)}
    del twin, other
    torch.cuda.empty_cache()
    return out, eng


def phase_path_g(topo) -> tuple:
    """The robust faithful edge round at full width: G1, collect-all with
    ``robust='trim'`` on path D's config (the trim's float max and min and
    int32 min scans through B4, its broadcasts through B3); G2, fast
    pairwise with ``robust='clip'`` on path D's pairwise config."""
    from flow_updating_tpu_torch import RoundConfig

    g1_cfg = RoundConfig.reference(
        "collectall", segment_impl="benes_fused", delivery="benes_fused",
        robust="trim", robust_tol=ROBUST_TOL)
    g1, eng1 = _robust_run(topo, g1_cfg, EDGE_BOOT + 1, ROBUST_ROUNDS,
                           EDGE_BOOT + 10, "path G1")
    if not g1["armed_at_round"][str(EDGE_BOOT + 1)]["armed_nodes"]:
        raise AssertionError("path G1: robust_tol armed no node")
    g2_cfg = RoundConfig.fast("pairwise", segment_impl="benes_fused",
                              robust="clip", robust_clip=ROBUST_CLIP)
    g2, eng2 = _robust_run(topo, g2_cfg, 0, ROBUST_ROUNDS, 10, "path G2")
    flow = eng2.state.flow.abs()
    if float(flow.max()) > ROBUST_CLIP:
        raise AssertionError("path G2: a ledger entry exceeds robust_clip")
    g2["edges_at_clamp"] = int((flow == ROBUST_CLIP).sum())
    if not g2["edges_at_clamp"]:
        raise AssertionError("path G2: robust_clip bound no write")
    g2["mass_residual_bound"] = "float32 noise (the clip is odd)"
    return {"g1": g1, "g2": g2}, eng1, eng2


def _rounds_to(curve, th, obs) -> int | None:
    import numpy as np

    below = np.asarray(curve) < th
    return int((np.argmax(below) + 1) * obs) if below.any() else None


def _small6(msg_bytes: float):
    from flow_updating_tpu_torch.engine import TICK_INTERVAL
    from flow_updating_tpu_torch.topology.deployment import load_deployment
    from flow_updating_tpu_torch.topology.platform import load_platform

    return load_deployment(os.path.join(ROOT, SMALL6_ACTORS)).to_topology(
        platform=load_platform(os.path.join(ROOT, SMALL6_PLATFORM)),
        tick_interval=TICK_INTERVAL, latency_scale=SMALL6_SCALE,
        msg_bytes=msg_bytes)


def _observed(topo, cfg, device) -> list:
    """The rmse curve of ``DES_TICKS`` rounds, sampled every ``OBS``."""
    from flow_updating_tpu_torch.models import rounds
    from flow_updating_tpu_torch.models.state import init_state

    _, m = rounds.run_rounds_observed(
        init_state(topo, cfg, device=device),
        topo.device_arrays(device=device), cfg, DES_TICKS, OBS,
        topo.true_mean)
    return m["rmse"].cpu().tolist()


def _linked_fat_tree(topo):
    """``topo`` with a link model through the public ``build_topology``:
    one SHARED host link per node, each directed edge routed over its
    source's and its destination's (K = 2, L = N), one round of latency
    and ``LINK_SER_ROUNDS`` of serialization a message."""
    import numpy as np

    from flow_updating_tpu_torch.topology.graph import build_topology

    pairs = np.stack([topo.src, topo.dst], 1)[topo.src < topo.dst]
    keys = list(zip(pairs[:, 0].tolist(), pairs[:, 1].tolist()))
    return build_topology(
        topo.num_nodes, pairs, values=topo.values,
        latency_s=dict.fromkeys(keys, 1.0), latency_scale=1.0,
        msg_bytes=104.0, route_links={k: k for k in keys},
        link_caps=np.full(topo.num_nodes, 104.0 / LINK_SER_ROUNDS),
        link_shared=np.ones(topo.num_nodes, bool), warn_asymmetric=False)


def phase_path_h(tree) -> dict:
    """Contention where it exists.  H1: the same-model contract (the
    kernel with ``contention_backlog`` against the DES's backlog twin) on
    small6 at two message sizes, the card's float64 run equal to the
    host's; H2: ``RoundConfig.fidelity`` against the dynamic max-min
    oracle; H3: ``edge_delays`` alone on the k=160 fat tree with a link
    model, device ms a call, two runs ``torch.equal``."""
    import dataclasses

    import numpy as np
    import torch

    from flow_updating_tpu_torch import Engine, RoundConfig, native
    from flow_updating_tpu_torch.models import rounds

    h1, h2 = {}, {}
    for mb in SMALL6_MSG_BYTES:
        topo = _small6(mb)
        D = topo.contended_max_delay()
        h1[f"{mb:g}"] = cells = {"delay_depth": D,
                                 "max_static_delay": topo.max_delay}
        for variant in ("collectall", "pairwise"):
            cfg = RoundConfig.reference(variant, delay_depth=D,
                                        contention=True,
                                        contention_backlog=True,
                                        dtype="float64")
            card = _observed(topo, cfg, "cuda")
            host = _observed(topo, cfg, "cpu")
            des = native.des_run_contend(
                topo, variant, timeout=50, ticks=DES_TICKS, obs_every=OBS,
                clamp_d=D, backlog=True)[0]
            got = {f"{th:g}": {"kernel": _rounds_to(card, th, OBS),
                               "host": _rounds_to(host, th, OBS),
                               "des": _rounds_to(des, th, OBS)}
                   for th in (1e-2, 1e-3)}
            for th, r in got.items():
                if r["kernel"] is None or r["kernel"] != r["host"]:
                    raise AssertionError(
                        f"path H1 {variant} msg_bytes={mb:g} th={th}: the "
                        f"card's rounds {r['kernel']} != the host's "
                        f"{r['host']}")
            cells[variant] = got
        fid = {}
        for variant in ("collectall", "pairwise"):
            eng = Engine(config=RoundConfig.fidelity(variant,
                                                     dtype="float64"))
            eng.set_topology(topo).build(latency_scale=SMALL6_SCALE)
            card = _observed(topo, eng.config, "cuda")
            lmm = native.des_run_contend(
                topo, variant, timeout=50, ticks=DES_TICKS, obs_every=OBS,
                clamp_d=eng.config.delay_depth, lmm=True)[0]
            fid[variant] = {
                "delay_depth": eng.config.delay_depth,
                "contention_iters": eng.config.contention_iters,
                "contention_backlog": eng.config.contention_backlog,
                **{f"{th:g}": {"kernel": _rounds_to(card, th, OBS),
                               "lmm": _rounds_to(lmm, th, OBS)}
                   for th in (1e-2, 1e-3)}}
        h2[f"{mb:g}"] = fid
    # the contract's gates, each where it holds (PERF.md: not general)
    exact = h1[f"{SMALL6_MSG_BYTES[1]:g}"]["collectall"]
    if any(r["kernel"] != r["des"] for r in exact.values()):
        raise AssertionError(f"path H1: collect-all rounds {exact} differ "
                             "from the DES's")
    band = h1[f"{SMALL6_MSG_BYTES[0]:g}"]["pairwise"]
    if any(abs(r["kernel"] - r["des"]) > 50 for r in band.values()):
        raise AssertionError(f"path H1: pairwise rounds {band} are not "
                             "within 50 of the DES's")

    t0 = time.perf_counter()
    linked = _linked_fat_tree(tree)
    link_s = time.perf_counter() - t0
    if not np.array_equal(linked.src, tree.src):
        raise AssertionError("path H3: the linked fat tree's edges differ")
    t0 = time.perf_counter()
    arrays = linked.device_arrays()
    torch.cuda.synchronize()
    arrays_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED)
    E = linked.num_edges
    send = torch.from_numpy(rng.random(E) < 0.5).cuda()
    inflight = torch.from_numpy(rng.integers(0, 3, E).astype(np.int32)).cuda()
    base = RoundConfig.reference(contention=True,
                                 delay_depth=linked.contended_max_delay())
    h3 = {"links": int(linked.link_ser_rounds.shape[0]),
          "route_slots": int(linked.edge_links.shape[1]),
          "build_s": link_s, "device_arrays_s": arrays_s,
          "delay_depth": base.delay_depth, "calls": {}}
    for name, kw in (("iters0", {}), ("iters4", {"contention_iters": 4}),
                     ("iters4_backlog", {"contention_iters": 4,
                                         "contention_backlog": True})):
        cfg = dataclasses.replace(base, **kw)

        def call(cfg=cfg):
            return rounds.edge_delays(arrays, cfg, send, inflight=inflight)

        runs = [call(), call()]
        torch.cuda.synchronize()
        if not torch.equal(runs[0], runs[1]):
            raise AssertionError(f"path H3 {name}: two runs of edge_delays "
                                 "differ")
        d = runs[0]
        h3["calls"][name] = {
            "device_ms": device_ms(call), "ms": cuda_ms(call),
            "top": device_top(call), "equal_twice": True,
            "delay_histogram": torch.bincount(d).cpu().tolist(),
            "max_delay": int(d.max())}
    del arrays, send, inflight
    torch.cuda.empty_cache()
    return {"h1": h1, "h2": h2, "h3": h3,
            "small6": {"latency_scale": SMALL6_SCALE,
                       "msg_bytes": list(SMALL6_MSG_BYTES),
                       "ticks": DES_TICKS, "obs_every": OBS}}


def host_cpu() -> dict:
    """What the host says of its CPU: ``/proc/cpuinfo``'s first
    ``model name``, vendor, family, model and MHz fields, and the cores
    this process may use."""
    fields = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                key = key.strip().lower()
                if key in ("model name", "vendor_id", "cpu family", "model",
                           "cpu mhz") and key not in fields:
                    fields[key] = value.strip()
    except OSError:
        pass
    return {"model_name": fields.pop("model name", "unknown"), **fields,
            "cores": len(os.sched_getaffinity(0))}


def phase_des(tree) -> dict:
    """The host baseline a round rate will be divided by: ``des_run`` on
    the k=160 fat tree at ``timeout=1`` (every node fires every tick, the
    fast round's work) and ``timeout=50`` (the faithful round's), ticks
    per second over ``DES_REPEATS`` repeats; then the faithful edge round
    on the card held to the DES fixed point on ``ring(24, 2)``."""
    import numpy as np

    from flow_updating_tpu_torch import Engine, RoundConfig, native
    from flow_updating_tpu_torch.topology.generators import ring

    rates = {}
    for timeout in (1, 50):
        samples, events = [], 0
        for _ in range(DES_REPEATS):
            t0 = time.perf_counter()
            _, _, events = native.des_run(tree, "collectall",
                                          timeout=timeout,
                                          ticks=DES_BASE_TICKS)
            samples.append(DES_BASE_TICKS / (time.perf_counter() - t0))
        mean = sum(samples) / len(samples)
        rates[f"timeout{timeout}"] = {
            "rounds_per_s": mean, "rounds_per_s_min": min(samples),
            "rounds_per_s_max": max(samples),
            "spread_pct": 100 * (max(samples) - min(samples)) / mean,
            "ticks": DES_BASE_TICKS, "repeats": DES_REPEATS,
            "events": events}
    small = ring(24, 2, seed=9)
    fixed = {}
    for variant in ("collectall", "pairwise"):
        est, _, _ = native.des_run(small, variant, timeout=50,
                                   ticks=DES_FIXED_TICKS)
        eng = Engine(config=RoundConfig.reference(variant))
        eng.set_topology(small).build().run_rounds(DES_FIXED_TICKS)
        des_rmse = float(np.sqrt(np.mean((est - small.true_mean) ** 2)))
        rmse = eng.convergence_report()["rmse"]
        if not (des_rmse < 1e-3 and rmse < 1e-3):
            raise AssertionError(f"des: {variant} on ring(24, 2) did not "
                                 f"reach the fixed point (DES {des_rmse}, "
                                 f"card {rmse})")
        fixed[variant] = {"des_rmse": des_rmse, "card_rmse": rmse}
    return {"host_cpu": host_cpu(), "topology": f"fat_tree:{FAT_TREE_K}",
            "variant": "collectall", **rates,
            "ring24_fixed_point": {"ticks": DES_FIXED_TICKS, **fixed}}


def phase_c1(engine_e) -> dict:
    """Value semantics of sharded node states on the card: path E's
    kernel by ``run(st, 1)`` loops against ``run(st, R)`` (device ms a
    round: the two clones a ``run`` call costs), and running twice from a
    retained state."""
    import torch

    kern = engine_e._node_kernel
    st0 = engine_e.state

    def leaves(st):
        return [torch.cat([t.cpu() for t in getattr(st, f)])
                for f in ("S", "G", "avg_prev", "A_prev", "avg")]

    a = kern.run(st0, C1_ROUNDS)
    want = leaves(a)
    kern.run(a, 3)
    b = st0
    for _ in range(C1_ROUNDS):
        b = kern.run(b, 1)
    if not all(torch.equal(x, y) for x, y in zip(leaves(b), want)):
        raise AssertionError("c1: run(st, 1) x R differs from run(st, R)")
    if not all(torch.equal(x, y) for x, y in zip(
            leaves(kern.run(st0, C1_ROUNDS)), want)):
        raise AssertionError("c1: a second run from the retained state "
                             "differs")

    def loop():
        s = st0
        for _ in range(C1_ROUNDS):
            s = kern.run(s, 1)

    def whole():
        kern.run(st0, C1_ROUNDS)

    one = device_ms(loop) / C1_ROUNDS
    many = device_ms(whole) / C1_ROUNDS
    return {"rounds": C1_ROUNDS, "shards": SHARDS,
            "device_ms_per_round_run1_loop": one,
            "device_ms_per_round_runR": many,
            "copy_device_ms_per_run_call": (one - many) * C1_ROUNDS
            / (C1_ROUNDS - 1),
            "ms_per_round_run1_loop": cuda_ms(loop) / C1_ROUNDS,
            "ms_per_round_runR": cuda_ms(whole) / C1_ROUNDS,
            "retained_state_runs_equal": True}


def _restore_timed(engine, path) -> dict:
    """``engine.restore_checkpoint(path)``, its seconds split into the
    kernel's preparation (``_prepare_arrays``: networks, plans, tables)
    and the rest (the archive's read and checks, the copy to the card)."""
    import torch

    spans = {}
    prepare = engine._prepare_arrays

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        prepare(*args, **kwargs)
        torch.cuda.synchronize()
        spans["prepare_s"] = time.perf_counter() - t0

    engine._prepare_arrays = timed
    t0 = time.perf_counter()
    try:
        engine.restore_checkpoint(path)
        torch.cuda.synchronize()
    finally:
        del engine._prepare_arrays
    total = time.perf_counter() - t0
    return {"restore_s": total, "prepare_s": spans["prepare_s"],
            "load_s": total - spans["prepare_s"]}


def _save_timed(engine, path) -> dict:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.save_checkpoint(path)
    return {"save_s": time.perf_counter() - t0,
            "archive_bytes": os.path.getsize(path)}


def _edge_leaves_equal(a, b) -> list:
    """The names of the leaves where two edge states differ."""
    import dataclasses

    import torch

    return [f.name for f in dataclasses.fields(a)
            if not torch.equal(getattr(a, f.name), getattr(b, f.name))]


def _named_fat_tree():
    """A new fat tree k=160 with a name per vertex (``v<id>``): a second
    process's topology (nothing routed on it yet), whose nodes can be
    killed by name.  Names are not part of the fingerprint."""
    import dataclasses

    from flow_updating_tpu_torch.topology.generators import fat_tree

    topo = fat_tree(FAT_TREE_K)
    return dataclasses.replace(
        topo, names=tuple(f"v{i}" for i in range(topo.num_nodes)))


def phase_path_i1(engine_d, topo, tmp) -> dict:
    """I1: path D's engine saved, restored into a new engine on a new
    topology object (the networks routed again, as in a second process)
    and run on; every leaf equal to the uninterrupted engine's."""
    from flow_updating_tpu_torch import Engine

    path = os.path.join(tmp, "path_d.npz")
    at = engine_d.state.t
    out = {"saved_at_round": int(at), **_save_timed(engine_d, path)}
    state_bytes = sum(v.nbytes for v in engine_d.state.numpy().values())
    fresh = Engine().set_topology(topo)
    if fresh.state is not None:
        raise AssertionError("a fresh engine holds a state")
    out.update(_restore_timed(fresh, path))
    if fresh.clock != engine_d.clock or fresh.config != engine_d.config:
        raise AssertionError("I1: the restore lost the clock or config")
    if any(getattr(fresh.state, f).device != engine_d.state.flow.device
           for f in ("flow", "pending_flow", "key")):
        raise AssertionError("I1: the restored state is not on the card")
    expected = {k: v * RESUME_ROUNDS for k, v in
                planned_launches(fresh._topo_arrays, fresh.config).items()}
    reset_counts()
    first = _timed_rounds(fresh, 1)
    ms = first + _timed_rounds(fresh, RESUME_ROUNDS - 1)
    got = {**b3_launches(), **b4_launches()}
    if got != expected:
        raise AssertionError(f"I1 launches {got}, planned {expected}")
    d_first = _timed_rounds(engine_d, 1)
    d_ms = d_first + _timed_rounds(engine_d, RESUME_ROUNDS - 1)
    diff = _edge_leaves_equal(engine_d.state, fresh.state)
    if diff:
        raise AssertionError(f"I1: the resumed run differs in {diff}")
    # the gap between I1 and D: the first round apart, and the device
    # time of both side by side
    gap = {"first_round_ms": first, "d_ms_per_round": d_ms / RESUME_ROUNDS,
           "d_first_round_ms": d_first,
           "profile_i1": profile_rounds(fresh, PROFILE_ROUNDS),
           "profile_d": profile_rounds(engine_d, PROFILE_ROUNDS)}
    del fresh
    return {**out, "state_bytes": state_bytes,
            "compression": out["archive_bytes"] / state_bytes,
            "rounds_after_restore": RESUME_ROUNDS,
            "ms_per_round": ms / RESUME_ROUNDS, "launches": got,
            "every_leaf_equal": True, **gap}


def phase_path_i2(topo) -> dict:
    """I2: faults on path D's configuration — 1% of the hosts killed (by
    name and by id) and 1,000 links failed after the timeout bootstrap,
    then revived and repaired — against 'benes' and 'segment'/'gather'
    twins run through the same sequence; then fast pairwise with failed
    links.  The faithful round's rmse swings for hundreds of rounds on a
    fat tree, faults or none, so it is reported; the healing gate is
    that every revived node fires again within the timeout."""
    import numpy as np
    import torch

    from flow_updating_tpu_torch import Engine, RoundConfig

    rng = np.random.default_rng(SEED)
    n_host = FAT_TREE_K ** 3 // 4
    killed = np.sort(rng.choice(n_host, int(KILL_SHARE * n_host),
                                replace=False))
    nodes = ([topo.names[i] for i in killed[::2]]
             + [int(i) for i in killed[1::2]])
    und = np.flatnonzero(topo.src < topo.dst)
    links = [(int(topo.src[e]), int(topo.dst[e]))
             for e in rng.choice(und, FAILED_LINKS, replace=False)]
    kill_t = torch.from_numpy(killed).cuda()

    def drive(eng, observe):
        obs = {}
        eng.run_rounds(FAULT_BOOT)
        t0 = time.perf_counter()
        eng.kill_nodes(nodes).fail_links(links)
        torch.cuda.synchronize()
        obs["fault_s"] = time.perf_counter() - t0
        failed = torch.from_numpy(eng._edge_ids(links)).cuda()
        if observe:
            fired = eng.state.fired[kill_t].clone()
            queued = int(eng.state.pending_valid[:, failed].sum())
            reset_counts()
        eng.run_rounds(FAULT_ROUNDS)
        if observe:
            # the counts before any read-back (estimates run the networks)
            obs["launches"] = {**b3_launches(), **b4_launches()}
            st = eng.state
            if not torch.equal(st.fired[kill_t], fired):
                raise AssertionError("I2: a dead node fired")
            if bool(st.alive[kill_t].any()) or \
                    int(st.alive.sum()) != topo.num_nodes - len(killed):
                raise AssertionError("I2: the alive mask is not the kill")
            if bool(st.buf_valid[:, failed].any()) or \
                    int(st.pending_valid[:, failed].sum()) > queued:
                raise AssertionError("I2: a message crossed a failed link")
            obs["rmse_dead"] = eng.convergence_report()["rmse"]
            obs["pending_on_failed_at_fault"] = queued
        eng.revive_nodes(nodes).restore_links(links)
        if observe:
            reset_counts()
        eng.run_rounds(HEAL_ROUNDS)
        if observe:
            heal = {**b3_launches(), **b4_launches()}
            obs["launches"] = {k: v + heal[k]
                               for k, v in obs["launches"].items()}
            obs["rmse_healed"] = eng.convergence_report()["rmse"]
            # HEAL_ROUNDS passes the timeout: every revived node fires
            if not bool((eng.state.fired[kill_t] > fired).all()):
                raise AssertionError("I2: a revived node did not fire")
        return obs

    cfg = RoundConfig.reference("collectall", segment_impl="benes_fused",
                                delivery="benes_fused")
    eng = Engine(config=cfg).set_topology(topo).build(seed=SEED)
    obs = drive(eng, True)
    per_round = planned_launches(eng._topo_arrays, cfg)
    want = {k: v * (FAULT_ROUNDS + HEAL_ROUNDS) for k, v in
            per_round.items()}
    if obs["launches"] != want:
        raise AssertionError(f"I2 launches {obs['launches']}, planned "
                             f"{want}")
    twins = {}
    for seg, dlv in (("benes", "benes"), ("segment", "gather")):
        twin = Engine(config=RoundConfig.reference(
            "collectall", segment_impl=seg, delivery=dlv))
        twin.set_topology(topo).build(seed=SEED)
        drive(twin, False)
        mine, other = _edge_estimates(eng), _edge_estimates(twin)
        twins[seg] = {"leaves_differing": _edge_leaves_equal(eng.state,
                                                             twin.state),
                      "max_abs_diff": float((mine - other).abs().max())}
        del twin, other
        torch.cuda.empty_cache()
    if twins["benes"]["leaves_differing"]:
        raise AssertionError("I2: benes_fused differs from its 'benes' twin "
                             f"in {twins['benes']['leaves_differing']}")
    if not twins["segment"]["max_abs_diff"] <= EDGE_TWIN_ATOL:
        raise AssertionError("I2: not within the 'segment' twin's "
                             f"tolerance ({twins['segment']})")
    del eng
    torch.cuda.empty_cache()
    # fast pairwise: a failed link is never matched, so its flow stays 0
    pcfg = RoundConfig.fast("pairwise", segment_impl="benes_fused")
    pw = Engine(config=pcfg).set_topology(topo).build(seed=SEED)
    pw.fail_links(links)
    failed = torch.from_numpy(pw._edge_ids(links)).cuda()
    rmse0 = pw.convergence_report()["rmse"]
    reset_counts()
    pw.run_rounds(PAIRWISE_ROUNDS)
    pw_launches = {**b3_launches(), **b4_launches()}
    want = {k: v * PAIRWISE_ROUNDS for k, v in
            planned_launches(pw._topo_arrays, pcfg).items()}
    if pw_launches != want:
        raise AssertionError(f"I2 pairwise launches {pw_launches}, planned "
                             f"{want}")
    if bool(pw.state.flow[failed].any()):
        raise AssertionError("I2: fast pairwise matched a failed link")
    rep = pw.convergence_report()
    if not rep["rmse"] < rmse0:
        raise AssertionError("I2: fast pairwise with failed links did not "
                             "reduce the rmse")
    del pw
    torch.cuda.empty_cache()
    return {"killed": len(killed), "killed_by_name": len(killed[::2]),
            "failed_links": FAILED_LINKS,
            "rounds": [FAULT_BOOT, FAULT_ROUNDS, HEAL_ROUNDS],
            **obs, "equal_to_benes": True,
            "max_abs_diff_to_segment": twins["segment"]["max_abs_diff"],
            "segment_atol": EDGE_TWIN_ATOL,
            "pairwise": {"rounds": PAIRWISE_ROUNDS, "launches": pw_launches,
                         "failed_flows_zero": True, "rmse_initial": rmse0,
                         "rmse": rep["rmse"],
                         "mass_residual": rep["mass_residual"]}}


def phase_path_i3(engine_f, topo, tmp) -> dict:
    """I3: path F's halo engine — gather -> scatter returns its state on
    the real slots (keys aside), and its archive resumes in a new halo
    engine (equal to the uninterrupted run in the canonical layout, keys
    aside) and in a single-device engine (estimates equal at the restore
    up to the summation order; its next rounds reported)."""
    import numpy as np
    import torch

    from flow_updating_tpu_torch import Engine
    from flow_updating_tpu_torch.parallel import sharded
    from flow_updating_tpu_torch.parallel.mesh import make_mesh

    plan, cfg, mesh = engine_f._halo_plan, engine_f.config, engine_f.mesh
    t0 = time.perf_counter()
    canon = sharded.gather_full_state(engine_f.state, plan, topo)
    gather_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = sharded.scatter_full_state(canon, plan, topo, cfg, mesh)
    torch.cuda.synchronize()
    scatter_s = time.perf_counter() - t0
    real = torch.from_numpy(plan.alive0)
    for s, (x, y) in enumerate(zip(engine_f.state.shards, back.shards)):
        for name, a in vars(x).items():
            b = getattr(y, name)
            if name == "key":
                continue
            if name in ("value", "ticks", "last_avg", "fired", "alive"):
                a, b = a[real[s].cuda()], b[real[s].cuda()]
            if not torch.equal(a, b):
                raise AssertionError(f"I3: gather -> scatter changed {name} "
                                     f"on shard {s}")
    del back
    path = os.path.join(tmp, "path_f.npz")
    out = {"saved_at_round": engine_f.state.t, "gather_s": gather_s,
           "scatter_s": scatter_s, **_save_timed(engine_f, path)}
    halo_est = engine_f.estimates()
    fresh = Engine(mesh=make_mesh(SHARDS), multichip="halo",
                   halo="overlap_pallas", partition="bfs")
    fresh.set_topology(topo)
    out.update(_restore_timed(fresh, path))
    reset_counts()
    ms = _timed_rounds(fresh, RESUME_ROUNDS)
    launches = b6_launches()
    if launches != {"fused": RESUME_ROUNDS * SHARDS, "pull": 0}:
        raise AssertionError(f"I3: B6 launched {launches} in "
                             f"{RESUME_ROUNDS} rounds")
    engine_f.run_rounds(RESUME_ROUNDS)
    a = sharded.gather_full_state(engine_f.state, plan, topo).numpy()
    b = sharded.gather_full_state(fresh.state, fresh._halo_plan,
                                  topo).numpy()
    diff = [k for k in a if k != "key" and not np.array_equal(a[k], b[k])]
    if diff:
        raise AssertionError(f"I3: the resumed halo run differs in {diff}")
    del fresh, a, b
    single = Engine().set_topology(topo)
    out["single_device"] = _restore_timed(single, path)
    single_est = single.estimates()
    gap = float(np.abs(single_est - halo_est).max())
    if not gap <= EDGE_TWIN_ATOL:
        raise AssertionError(f"I3: the single-device restore's estimates "
                             f"are {gap} from the halo's")
    single.run_rounds(RESUME_ROUNDS)
    out["single_device"].update({
        "max_abs_diff_at_restore": gap,
        "rmse_after_rounds": single.convergence_report()["rmse"],
        "rounds": RESUME_ROUNDS})
    del single, canon
    torch.cuda.empty_cache()
    return {**out, "rounds_after_restore": RESUME_ROUNDS,
            "ms_per_round": ms / RESUME_ROUNDS, "b6_launches": launches,
            "gather_scatter_returns_state": True,
            "equal_to_uninterrupted": True}


def phase_path_i4(engine_e, ring_topo, tmp) -> dict:
    """I4: path E's sharded banded state saved and restored on the mesh
    (B5 launches of the resumed rounds counted, every leaf equal to the
    uninterrupted engine's); the single-device banded_fused engine
    refuses the layout."""
    import torch

    from flow_updating_tpu_torch import Engine
    from flow_updating_tpu_torch.parallel.mesh import make_mesh

    path = os.path.join(tmp, "path_e.npz")
    out = {"saved_at_round": engine_e.state.t,
           **_save_timed(engine_e, path)}
    fresh = Engine(mesh=make_mesh(SHARDS), halo="overlap")
    fresh.set_topology(ring_topo)
    out.update(_restore_timed(fresh, path))
    reset_counts()
    ms = _timed_rounds(fresh, RESUME_ROUNDS)
    launches = b5_launches()
    if launches != {"fire": 0, "merge": RESUME_ROUNDS * SHARDS * 2}:
        raise AssertionError(f"I4: B5 launched {launches} in "
                             f"{RESUME_ROUNDS} rounds of {SHARDS} shards")
    engine_e.run_rounds(RESUME_ROUNDS)
    for name in ("S", "G", "avg_prev", "A_prev", "avg"):
        for x, y in zip(getattr(engine_e.state, name),
                        getattr(fresh.state, name)):
            if not torch.equal(x, y):
                raise AssertionError(f"I4: the resumed mesh run differs in "
                                     f"{name}")
    del fresh
    try:
        Engine().set_topology(ring_topo).restore_checkpoint(path)
    except ValueError as err:
        if "interchangeable" not in str(err) and "node axis" not in str(err):
            raise
        refusal = str(err)
    else:
        raise AssertionError("I4: a single-device engine restored the "
                             "sharded layout")
    torch.cuda.empty_cache()
    return {**out, "rounds_after_restore": RESUME_ROUNDS,
            "ms_per_round": ms / RESUME_ROUNDS, "b5_launches": launches,
            "equal_to_uninterrupted": True, "single_device_refusal": refusal}


def phase_a6(topo) -> dict:
    """A6: path C's network through the disk plan cache, pointed at a new
    temporary directory: a cold build routes and saves, then, the
    in-process cache cleared, a second build loads the routing from disk;
    the two plans' stages equal and their runs ``torch.equal``."""
    import dataclasses
    import shutil
    import tempfile

    import numpy as np
    import torch

    from flow_updating_tpu_torch import Engine, RoundConfig
    from flow_updating_tpu_torch.ops import spmv_benes

    cfg = RoundConfig.fast(kernel="node", spmv="benes_fused")
    cache = tempfile.mkdtemp(prefix="fu_plan_cache_")
    before = os.environ.get("FU_PLAN_CACHE")
    os.environ["FU_PLAN_CACHE"] = cache
    try:
        engines, build_s = [], []
        for _ in range(2):
            spmv_benes._plan_cache.clear()
            t0 = time.perf_counter()
            engines.append(Engine(config=cfg).set_topology(topo).build())
            torch.cuda.synchronize()
            build_s.append(time.perf_counter() - t0)
            if len(engines) == 1:
                files = os.listdir(cache)
        cold, warm = (e._node_kernel.arrays.ns_plan for e in engines)
        if len(files) != 1 or cold is warm:
            raise AssertionError(f"a6: cache files {files}; the second "
                                 "plan was not loaded afresh")
        a, b = cold.base.stages, warm.base.stages
        if (a.n, a.dists, a.kinds) != (b.n, b.dists, b.kinds) or not all(
                np.array_equal(x, y) for x, y in zip(a.masks, b.masks)):
            raise AssertionError("a6: the loaded stages differ")
        if [dataclasses.astuple(p) for p in cold.fused.passes] != \
                [dataclasses.astuple(p) for p in warm.fused.passes]:
            raise AssertionError("a6: the fused passes differ")
        file_bytes = os.path.getsize(os.path.join(cache, files[0]))
        t0 = time.perf_counter()
        key0 = spmv_benes._mats_key(
            tuple(m.cpu().numpy() for m in engines[0]._node_kernel.arrays
                  .mats), cold.m1)
        spmv_benes._disk_save(key0, cold.base)
        save_s = time.perf_counter() - t0
        reset_counts()
        for e in engines:
            e.run_rounds(A6_ROUNDS)
        launches = b3_launches()
        per_round = len(cold.fused.passes)
        if sum(launches.values()) != 2 * A6_ROUNDS * per_round:
            raise AssertionError(f"a6: B3 launched {launches}")
        if not torch.equal(_estimate_tensor(engines[0]),
                           _estimate_tensor(engines[1])):
            raise AssertionError("a6: the loaded plan's run differs")
    finally:
        spmv_benes._plan_cache.clear()
        if before is None:
            os.environ.pop("FU_PLAN_CACHE", None)
        else:
            os.environ["FU_PLAN_CACHE"] = before
        shutil.rmtree(cache, ignore_errors=True)
    del engines
    torch.cuda.empty_cache()
    return {"cold_build_s": build_s[0], "warm_build_s": build_s[1],
            "warm_over_cold": build_s[1] / build_s[0],
            "disk_save_s": save_s, "file_bytes": file_bytes,
            "P": cold.P, "stages": len(a.dists), "rounds": A6_ROUNDS,
            "b3_launches": launches, "stages_equal": True,
            "equal_runs": True}


def _structured_cfg(dtype="float32"):
    from flow_updating_tpu_torch import RoundConfig

    return RoundConfig.fast(kernel="node", spmv="structured", dtype=dtype)


def _timed_path(engine, rounds: int = ROUNDS) -> dict:
    """Warm-up, then ``rounds`` rounds timed by CUDA events."""
    engine.run_rounds(WARMUP)
    ms = _timed_rounds(engine, rounds)
    return {"rounds": rounds, "ms_per_round": ms / rounds,
            "rounds_per_s": rounds / (ms / 1e3)}


def _device_summary(engine) -> dict:
    """Device ms, busy share and launches per round of ``engine``'s next
    rounds (:func:`profile_rounds`), without the per-kernel tables."""
    prof = profile_rounds(engine, PROFILE_ROUNDS)
    return {k: prof[k] for k in ("device_ms_per_round", "wall_ms_per_round",
                                 "busy_share", "device_launches_per_round")}


def phase_path_j1(tree) -> dict:
    """J1: the structured stencil on the materialized fat tree k=160:
    float32 timing; 40 float64 rounds within 1e-12 of spmv='xla'; the
    virtual tree's estimates ``torch.equal`` to the materialized one's."""
    import numpy as np
    import torch

    from flow_updating_tpu_torch import Engine, RoundConfig
    from flow_updating_tpu_torch.topology.generators import fat_tree

    cfg = _structured_cfg()
    t0 = time.perf_counter()
    eng = Engine(config=cfg).set_topology(tree).build()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    rmse0 = eng.convergence_report()["rmse"]
    out = {"build_s": build_s, "rmse_initial": rmse0, **_timed_path(eng)}
    rep = eng.convergence_report()
    est = eng.estimates()
    if est.shape != (tree.num_nodes,) or not np.isfinite(est).all():
        raise AssertionError("J1 estimates are not finite (N,) values")
    if not rep["rmse"] < rmse0:
        raise AssertionError("J1 did not reduce the rmse")
    virtual = Engine(config=cfg).set_topology(
        fat_tree(FAT_TREE_K, materialize_edges=False)).build()
    virtual.run_rounds(eng.state.t)
    if not torch.equal(_estimate_tensor(virtual), _estimate_tensor(eng)):
        raise AssertionError("J1: the virtual tree's estimates differ from "
                             "the materialized tree's")
    del virtual
    runs = {}
    for spmv in ("structured", "xla"):
        twin = Engine(config=RoundConfig.fast(kernel="node", spmv=spmv,
                                              dtype="float64"))
        runs[spmv] = twin.set_topology(tree).build().run_rounds(
            J_CHECK_ROUNDS).estimates()
        del twin
    diff = float(np.abs(runs["structured"] - runs["xla"]).max())
    if not np.allclose(runs["structured"], runs["xla"], rtol=STRUCT_TOL,
                       atol=STRUCT_TOL):
        raise AssertionError(f"J1: float64 structured differs from xla by "
                             f"{diff}")
    out.update(rep)
    out.update({"virtual_equal": True,
                "float64_max_abs_diff_to_xla": diff,
                "device": _device_summary(eng)})
    return out


def phase_path_j2() -> tuple:
    """J2: the virtual fat tree k=640 (66,048,000 nodes, no edges) on one
    card: build seconds, ms/round, device memory; the rmse falls and the
    estimates' mean stays at the true mean within float32 rounding."""
    import numpy as np
    import torch

    from flow_updating_tpu_torch import Engine
    from flow_updating_tpu_torch.topology.generators import fat_tree

    t0 = time.perf_counter()
    topo = fat_tree(VIRTUAL_K, materialize_edges=False)
    topo_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = Engine(config=_structured_cfg()).set_topology(topo).build()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    held = torch.cuda.memory_allocated() - base
    rmse0 = eng.convergence_report()["rmse"]
    out = {"nodes": topo.num_nodes, "edges": topo.num_edges,
           "topology_s": topo_s, "build_s": build_s,
           "rmse_initial": rmse0, **_timed_path(eng)}
    est = eng.estimates()
    rounds = int(eng.state.t)
    rep = eng.convergence_report()
    if est.shape != (topo.num_nodes,) or not np.isfinite(est).all():
        raise AssertionError("J2 estimates are not finite (N,) values")
    if not rep["rmse"] < rmse0:
        raise AssertionError("J2 did not reduce the rmse")
    drift = float(est.astype(np.float64).mean() - topo.true_mean)
    drift_bound = (rounds * DRIFT_ULPS * float(np.finfo(np.float32).eps)
                   * float(np.abs(topo.values).max()))
    if not abs(drift) <= drift_bound:
        raise AssertionError(f"J2: the estimates' mean is {drift} off the "
                             f"true mean (bound {drift_bound})")
    device = _device_summary(eng)
    torch.cuda.synchronize()
    out.update(rep)
    out.update({"mean_drift": drift, "mean_drift_bound": drift_bound,
                "held_bytes": held,
                "max_memory_allocated": torch.cuda.max_memory_allocated()
                - base, "device": device})
    del eng
    return out, topo, est, rounds


def _pod_engine(topo, overlap: bool, dtype="float32"):
    from flow_updating_tpu_torch import Engine
    from flow_updating_tpu_torch.parallel.mesh import make_mesh

    return Engine(config=_structured_cfg(dtype), mesh=make_mesh(SHARDS),
                  multichip="pod",
                  halo="overlap" if overlap else "ppermute").set_topology(topo)


def phase_path_j3(topo, est_j2, rounds: int, tmp) -> dict:
    """J3: the pod kernel over make_mesh(4) on J2's tree, plain and
    overlapped: equal bit for bit, within ``POD_ULPS`` ulps of the largest
    neighbor sum of J2; at float64 on the virtual k=160 tree within 1e-12
    of one device; a pod archive resumed on one device within the float32
    tolerance."""
    import numpy as np
    import torch

    from flow_updating_tpu_torch import Engine
    from flow_updating_tpu_torch.topology.generators import fat_tree

    eps = float(np.finfo(np.float32).eps)
    tol = POD_ULPS * eps * VIRTUAL_K * float(np.abs(topo.values).max())
    out = {"tolerance": tol}
    ests = {}
    for overlap in (False, True):
        t0 = time.perf_counter()
        eng = _pod_engine(topo, overlap).build()
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        timed = _timed_path(eng, rounds - WARMUP)
        ests[overlap] = eng.estimates()
        out["overlap" if overlap else "plain"] = {
            "build_s": build_s, **timed, **eng.convergence_report(),
            "device": _device_summary(eng)}
        del eng
    if not np.array_equal(ests[True], ests[False]):
        raise AssertionError("J3: the overlap schedule differs from the "
                             "plain one")
    diff = float(np.abs(ests[True].astype(np.float64) - est_j2).max())
    if not diff <= tol:
        raise AssertionError(f"J3: the pod run is {diff} off J2 (bound "
                             f"{tol})")
    del ests
    small = fat_tree(FAT_TREE_K, materialize_edges=False)
    pod64 = _pod_engine(small, True, "float64").build().run_rounds(
        J_CHECK_ROUNDS)
    one64 = Engine(config=_structured_cfg("float64")).set_topology(small)
    one64.build().run_rounds(J_CHECK_ROUNDS)
    diff64 = float(np.abs(pod64.estimates() - one64.estimates()).max())
    if not diff64 <= STRUCT_TOL:
        raise AssertionError(f"J3: float64 pod differs from one device by "
                             f"{diff64}")
    del pod64, one64
    small_tol = POD_ULPS * eps * FAT_TREE_K * float(
        np.abs(small.values).max())
    pod = _pod_engine(small, True).build().run_rounds(RESUME_ROUNDS)
    path = os.path.join(tmp, "pod.npz")
    saved = _save_timed(pod, path)
    one = Engine().set_topology(small)
    restore = _restore_timed(one, path)
    if one.state.S.device.type != "cuda" or one.config.spmv != "structured":
        raise AssertionError("J3: the pod archive did not restore a "
                             "structured state on the card")
    pod.run_rounds(RESUME_ROUNDS)
    one.run_rounds(RESUME_ROUNDS)
    resumed = float(np.abs(pod.estimates().astype(np.float64)
                           - one.estimates()).max())
    if not resumed <= small_tol:
        raise AssertionError(f"J3: the resumed single-device run is "
                             f"{resumed} off the pod run (bound "
                             f"{small_tol})")
    out.update({"equal_overlap_plain": True, "max_abs_diff_to_j2": diff,
                "float64_k160_max_abs_diff": diff64,
                "resume": {**saved, **restore, "max_abs_diff": resumed,
                           "tolerance": small_tol}})
    return out


def phase_path_j4(tree, engine_c) -> tuple:
    """J4: Engine(mesh=make_mesh(4), spmv='benes_fused') on the fat tree
    k=160: plan seconds, ms/round, B3 launches per round (S x passes), and
    the estimates equal to path C's single-device run bit for bit."""
    import numpy as np
    import torch

    from flow_updating_tpu_torch import Engine, RoundConfig
    from flow_updating_tpu_torch.parallel.mesh import make_mesh

    cfg = RoundConfig.fast(kernel="node", spmv="benes_fused")
    t0 = time.perf_counter()
    eng = Engine(config=cfg, mesh=make_mesh(SHARDS)).set_topology(tree)
    eng.build()
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    kern = eng._node_kernel
    passes = kern.fused.passes
    per_round = {name: 0 for name, _, _, _ in B3_FLAVOURS}
    for ps in passes:
        per_round[b3_family(ps.kind)] += SHARDS
    target = int(engine_c.state.t)
    eng.run_rounds(WARMUP)
    reset_counts()
    ms = _timed_rounds(eng, target - WARMUP)
    launches = b3_launches()
    for name, count in per_round.items():
        if launches[name] != (target - WARMUP) * count:
            raise AssertionError(f"J4 B3 {name}: {launches[name]} launches "
                                 f"in {target - WARMUP} rounds, expected "
                                 f"{(target - WARMUP) * count}")
    mine, theirs = eng.estimates(), engine_c.estimates()
    diff = float(np.abs(mine - theirs).max())
    if not np.array_equal(mine, theirs):
        raise AssertionError(f"J4 differs from path C by {diff}")
    out = {"rounds": target - WARMUP,
           "ms_per_round": ms / (target - WARMUP),
           "plan_s": plan_s, "network_width": kern.fused.P,
           "passes_per_shard": len(passes),
           "b3_launches_per_round": per_round, "b3_launches": launches,
           "equal_to_path_c": True, **eng.convergence_report()}
    return out, eng


def _intervals_union(spans) -> float:
    total, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def profile_overlap(engine, rounds: int) -> dict:
    """Path E's streams from a ``torch.profiler`` trace (its Chrome
    export): the union of the device's busy intervals over the wall time,
    and how much of the halo copies' time another stream's kernel
    overlaps."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.run_rounds(rounds)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in dev]
    kernels = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                e.get("args", {}).get("stream")) for e in dev
               if e["cat"] == "kernel"]
    copies = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]),
               e.get("args", {}).get("stream")) for e in dev
              if e["cat"] == "gpu_memcpy"]
    copy_us = sum(b - a for a, b, _ in copies)
    hidden = 0.0
    for a, b, stream in copies:
        over = [(max(a, ka), min(b, kb)) for ka, kb, ks in kernels
                if ks != stream and ka < b and kb > a]
        hidden += _intervals_union(over)
    union = _intervals_union(spans)
    return {"rounds": rounds, "wall_ms_per_round": wall_us / rounds / 1e3,
            "busy_union_ms_per_round": union / rounds / 1e3,
            "busy_share": union / wall_us if union else None,
            "streams": len({s for _, _, s in kernels}),
            "copies_per_round": len(copies) / rounds,
            "copy_ms_per_round": copy_us / rounds / 1e3,
            "copy_overlapped_share": hidden / copy_us if copy_us else None}


def profile_rounds(engine, rounds: int) -> dict:
    """Where a round's time goes on the card: ``torch.profiler`` over
    ``rounds`` rounds, the device time of every CUDA-side event (kernels,
    memsets, copies) summed and set against the wall time of the same
    rounds (which the profiler itself lengthens), with dropped events made
    up for (:func:`_device_rows`); of ``TRACES`` traces the one with the
    most device time counts.  ``busy_share`` is None when the trace holds
    no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    best = None
    for _ in range(TRACES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            engine.run_rounds(rounds)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        device = _device_rows(prof, rounds)
        busy_us = sum(us for _, us, _ in device)
        if best is None or busy_us > best[0]:
            best = (busy_us, wall_us, device)
    busy_us, wall_us, device = best
    device.sort(key=lambda row: -row[1])
    def ms(groups):
        return {name: sum(us for k, us, _ in device
                          if any(m in k for m in marks)) / 1e3
                for name, marks in groups.items()}

    return {"rounds": rounds, "wall_ms_per_round": wall_us / rounds / 1e3,
            "device_ms_per_round": busy_us / 1e3,
            "busy_share": busy_us * rounds / wall_us if busy_us else None,
            "device_launches_per_round": sum(c for _, _, c in device),
            "kernel_ms_per_round": ms(KERNEL_FAMILIES),
            "flavour_ms_per_round": ms(FLAVOUR_KERNELS),
            "top": [{"kernel": k[:90], "ms_per_round": us / 1e3,
                     "calls_per_round": c}
                    for k, us, c in device[:10]]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from flow_updating_tpu_torch import kernels
    from flow_updating_tpu_torch.topology.generators import fat_tree, ring

    # no phase reads or writes a plan cache file but a6, which points the
    # cache at a directory of its own
    os.environ["FU_PLAN_CACHE"] = "0"
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

    k5 = phase_k5(ring_topo, dev)
    torch.cuda.synchronize()
    emit({"phase": "k5", **k5})

    path_e, engine_e = phase_path_e(ring_topo, engine_b)
    torch.cuda.synchronize()
    emit({"phase": "path_e", "topology": f"ring:{RING_N}:2", **path_e})

    engine_d, plan_s = build_path_d(tree)
    k3 = phase_k3(tree, dev, engine_d._topo_arrays)
    torch.cuda.synchronize()
    emit({"phase": "k3", **k3})

    path_c, engine_c = phase_path_c(tree)
    torch.cuda.synchronize()
    emit({"phase": "path_c", "topology": f"fat_tree:{FAT_TREE_K}", **path_c})

    a6 = phase_a6(tree)
    emit({"phase": "a6", "topology": f"fat_tree:{FAT_TREE_K}", **a6})

    k4 = phase_k4(tree, engine_d._topo_arrays, dev)
    torch.cuda.synchronize()
    emit({"phase": "k4", **k4})

    path_d, segment_est = phase_path_d(tree, engine_d, plan_s)
    torch.cuda.synchronize()
    emit({"phase": "path_d", "topology": f"fat_tree:{FAT_TREE_K}", **path_d})

    path_g, engine_g1, engine_g2 = phase_path_g(tree)
    torch.cuda.synchronize()
    emit({"phase": "path_g", "topology": f"fat_tree:{FAT_TREE_K}", **path_g})

    t0 = time.perf_counter()
    path_h = phase_path_h(tree)
    torch.cuda.synchronize()
    emit({"phase": "path_h", "wall_s": time.perf_counter() - t0, **path_h})

    t0 = time.perf_counter()
    des = phase_des(tree)
    emit({"phase": "des", "wall_s": time.perf_counter() - t0, **des})

    engine_f, f_build_s = build_path_f(tree)
    k6 = phase_k6(engine_f._halo_plan, engine_f.config, dev)
    torch.cuda.synchronize()
    emit({"phase": "k6", **k6})

    path_f, twin_f = phase_path_f(tree, engine_f, f_build_s, segment_est)
    torch.cuda.synchronize()
    emit({"phase": "path_f", "topology": f"fat_tree:{FAT_TREE_K}", **path_f})

    c1 = phase_c1(engine_e)
    torch.cuda.synchronize()
    emit({"phase": "c1", **c1})

    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
        t0 = time.perf_counter()
        named = _named_fat_tree()
        named_s = time.perf_counter() - t0
        path_i = {"topology_s": named_s,
                  "i1": phase_path_i1(engine_d, named, tmp)}
        emit({"phase": "path_i", "part": "i1", **path_i["i1"]})
        path_i["i2"] = phase_path_i2(named)
        emit({"phase": "path_i", "part": "i2", **path_i["i2"]})
        del named
        path_i["i3"] = phase_path_i3(engine_f, tree, tmp)
        emit({"phase": "path_i", "part": "i3", **path_i["i3"]})
        path_i["i4"] = phase_path_i4(engine_e, ring_topo, tmp)
        emit({"phase": "path_i", "part": "i4", **path_i["i4"]})
    torch.cuda.synchronize()
    emit({"phase": "path_i", "topology_s": named_s,
          "wall_s": time.perf_counter() - t0})
    i_b3 = {k: path_i["i1"]["launches"][k] + path_i["i2"]["launches"][k]
            + path_i["i2"]["pairwise"]["launches"][k]
            for k, _, _, _ in B3_FLAVOURS}
    i_b4 = {k: path_i["i1"]["launches"][k] + path_i["i2"]["launches"][k]
            + path_i["i2"]["pairwise"]["launches"][k]
            for k, _, _ in B4_FLAVOURS}

    t0 = time.perf_counter()
    path_j = {"j1": phase_path_j1(tree)}
    emit({"phase": "path_j", "part": "j1",
          "topology": f"fat_tree:{FAT_TREE_K}", **path_j["j1"]})
    path_j["j2"], virtual, est_j2, j2_rounds = phase_path_j2()
    emit({"phase": "path_j", "part": "j2",
          "topology": f"fat_tree:{VIRTUAL_K}:virtual", **path_j["j2"]})
    with tempfile.TemporaryDirectory(prefix="chip_smoke_pod_") as tmp:
        path_j["j3"] = phase_path_j3(virtual, est_j2, j2_rounds, tmp)
    del virtual, est_j2
    emit({"phase": "path_j", "part": "j3",
          "topology": f"fat_tree:{VIRTUAL_K}:virtual", **path_j["j3"]})
    path_j["j4"], engine_j4 = phase_path_j4(tree, engine_c)
    emit({"phase": "path_j", "part": "j4",
          "topology": f"fat_tree:{FAT_TREE_K}", **path_j["j4"]})
    torch.cuda.synchronize()
    emit({"phase": "path_j", "wall_s": time.perf_counter() - t0})

    emit({"phase": "profile",
          "path_a": profile_rounds(engine_a, PROFILE_ROUNDS),
          "path_b": profile_rounds(engine_b, PROFILE_ROUNDS),
          "path_c": profile_rounds(engine_c, PROFILE_ROUNDS),
          "path_j4": profile_rounds(engine_j4, PROFILE_ROUNDS),
          "path_d": profile_rounds(engine_d, PROFILE_ROUNDS),
          "path_g1": profile_rounds(engine_g1, PROFILE_ROUNDS),
          "path_g2": profile_rounds(engine_g2, PROFILE_ROUNDS),
          "path_e": {**profile_rounds(engine_e, PROFILE_ROUNDS),
                     "overlap": profile_overlap(engine_e, PROFILE_ROUNDS)},
          "path_f": {**profile_rounds(engine_f, PROFILE_ROUNDS),
                     "overlap": profile_overlap(engine_f, PROFILE_ROUNDS),
                     "overlap_twin": profile_overlap(twin_f,
                                                     PROFILE_ROUNDS)}})
    torch.cuda.synchronize()

    emit({"phase": "timing", "timed_by_cuda_events": EVENT_TIMED})
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
        *({"name": f"benes_pass.{name}", "route": "cuda",
           "source": "flow_updating_tpu_torch/csrc/benes_pass.cu",
           "replaces": f"flow_updating_tpu/ops/pallas_fused.py:{line}",
           "launches": (path_c["b3_launches"][name]
                        + path_d["b3_launches"][name]
                        + path_g["g1"]["b3_launches"][name]
                        + path_g["g2"]["b3_launches"][name]
                        + a6["b3_launches"][name] + i_b3[name]
                        + path_j["j4"]["b3_launches"][name]),
           "parity": "bit-exact (torch.equal), float32 and float64",
           "max_abs_err": k3["flavours"][name]["max_abs_err"],
           "ms": k3["flavours"][name]["ms"],
           "call_ms": k3["flavours"][name]["call_ms"],
           "plain_ms": k3["flavours"][name]["plain_ms"],
           "bound_ms": k3["flavours"][name]["bound_ms"],
           "bound_by": k3["flavours"][name]["bound_by"],
           "library_ms": k3["flavours"][name]["library_ms"]}
          for name, _, _, line in B3_FLAVOURS),
        *({"name": f"seg_scan.{name}", "route": "cuda",
           "source": "flow_updating_tpu_torch/csrc/seg_scan.cu",
           "replaces": f"flow_updating_tpu/ops/pallas_fused.py:{line}",
           "launches": (path_d["b4_launches"][name]
                        + path_g["g1"]["b4_launches"][name]
                        + path_g["g2"]["b4_launches"][name]
                        + i_b4[name]),
           "parity": "bit-exact (torch.equal): float32, float64, int32, "
                     "batch 1 and 3, the split passes",
           "max_abs_err": k4["flavours"][name]["max_abs_err"],
           "ms": k4["flavours"][name]["ms"],
           "call_ms": k4["flavours"][name]["call_ms"],
           "plain_ms": k4["flavours"][name]["plain_ms"],
           "bound_ms": k4["flavours"][name]["bound_ms"],
           "bound_by": k4["flavours"][name]["bound_by"],
           "library_ms": k4["flavours"][name]["library_ms"]}
          for name, _, line in B4_FLAVOURS),
        {"name": "sharded_round", "route": "cuda",
         "source": "flow_updating_tpu_torch/csrc/sharded_round.cu",
         "replaces": "flow_updating_tpu/ops/pallas_round.py:520",
         # shard-rounds, the unit of ms (each: launches_per_shard_round
         # merge launches)
         "launches": (path_e["b5_launches"]["merge"]
                      + path_i["i4"]["b5_launches"]["merge"])
                     // path_e["launches_per_shard_round"],
         "kernel_launches": (sum(path_e["b5_launches"].values())
                             + sum(path_i["i4"]["b5_launches"].values())),
         "parity": "bit-exact (torch.equal), float32 and float64, the "
                   "fire-only launch and the folded merges over whole "
                   "shards and split rows; sharded ring == single device "
                   "(500-round stress)",
         "max_abs_err": k5["max_abs_err"],
         "ms": k5["ms"], "call_ms": k5["call_ms"],
         "plain_ms": k5["plain_ms"],
         "bound_ms": k5["bound_ms"], "bound_by": k5["bound_by"],
         "library_ms": k5["library_ms"]},
        {"name": "halo_exchange", "route": "cuda",
         "source": "flow_updating_tpu_torch/csrc/halo_exchange.cu",
         "replaces": "flow_updating_tpu/ops/pallas_halo.py:99",
         "launches": (path_f["b6_launches"]["fused"]
                      + path_f["pairwise_fast"]["b6_launches"]["pull"]
                      + path_i["i3"]["b6_launches"]["fused"]),
         "parity": "bit-exact (torch.equal): float32 and float64, scalar "
                   "and 3 lanes, pull and fused, every shard, odd shapes; "
                   "path F 'overlap_pallas' == 'ppermute', 'allgather', "
                   "'overlap'",
         "max_abs_err": k6["max_abs_err"],
         "ms": k6["ms"], "call_ms": k6["call_ms"],
         "plain_ms": k6["plain_ms"],
         "composition_ms": k6["composition_ms"],
         "pull_ms": k6["pull_ms"], "pull_bound_ms": k6["pull_bound_ms"],
         "sector_floor_ms": k6["sector_floor_ms"],
         "bound_ms": k6["bound_ms"], "bound_by": k6["bound_by"],
         "library_ms": k6["library_ms"]},
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
