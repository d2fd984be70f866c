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
   1 and 50, two repeats, the host CPU named), and the faithful edge
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
   stress run, ``ring(20000, 2)`` over 4 shards for 250 rounds, whose
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
   (``erdos_renyi(4000, 6)``, faithful collect-all with message loss, 50
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
   ``path_t`` — ``Engine.profile(roofline=True)`` on every kernel kind at
   full width: T1 path A (K1), T2 path B (K2), T3 path D (B3, B4), T4
   path E (B5), T5 path F (B6, with a ``torch.profiler`` trace: the
   overlap measured from it and ``trace_complete``); each gated on the
   engine's state equal before and after, a run after the profile equal
   to one before it, ``roofline_frac`` in (0, 1], the launches a round
   equal to the plans' counts, and a small twin (``fat_tree(8)``,
   ``ring(4096, 2)``, four shards for T4 and T5) counting the same bytes
   and flops on the card as on the CPU; T5 also runs the ``profile``
   subcommand as a process on ``fat_tree:32`` over four shards, ``doctor``
   on its manifest through the CLI and in memory (equal verdicts) and
   ``regress`` of the manifest against itself (exit 0);
   ``path_l`` — ``plan='auto'`` and telemetry: L0 the gather ratio (the
   node/xla gather of the neighbor slots against a streamed copy of as
   many float32 elements, device time) on the fat tree and
   ``barabasi_albert(1_000_000, 4)``, beside ``GATHER_COST['cuda']``,
   which must lie between the two or within 25% of the nearer; L1
   ``Engine(plan='auto')`` on the fat tree takes the stencil with no
   probe, ``torch.equal`` to J1's route; L2 ``Engine(plan='auto')`` on
   path B's ring (its descriptor dropped) and on the BA graph: the
   decision, predicted costs, probes and probed rates (kernel K2 at each
   tile and remainder route), cold and cached build seconds (the second
   build hits the autotune cache with no probe), the chosen route's
   ms/round, the four candidates' ms/round (the median of ``L_REPS``
   interleaved repeats in a rotating order; the choice within ``PLAN_MARGIN`` of the fastest
   rate), 40 float64 rounds within 1e-9
   of ``spmv='xla'``; L3 ``mixing_report`` on the fat tree (edge rows)
   and on the ring's banded plan: both provenances, gaps in (0, 1], a
   cache hit recomputing nothing, two cold calls equal bit for bit; L4
   ``select_halo_mode`` on path F's plan over one card: 'ppermute', with
   the byte ranking's choice beside it; L5 ``run_telemetry`` with every
   metric on paths D, A, F and J3 (J3's inside path J): the state
   ``torch.equal`` to ``run_rounds``', the last rmse and mass residual
   against the host's, host reads inside the loop, the overhead; path
   F's series against the single-device series on its renumbered
   topology; ``run_streamed`` on path D, 10 samples;
   ``path_m`` — per-node and per-edge fields at full width on paths A
   (K1), B (K2), C (B3), D (B3, B4) and F (B6), and on J3 (inside path
   J): the default fields at stride 1 and 10 (J3: 10) and, on D and F,
   ``FieldSpec.full()``, each run's state ``torch.equal`` to
   ``run_rounds``', no host read inside the loop, ms a round by CUDA
   events and device ms a round by the profiler beside the plain round's,
   the recorded bytes and the bulk copy's time, ``Engine.run_fields``
   reduced against ``run_telemetry`` from the same state; F's fields
   against the single-device round's on its renumbered topology, A's
   ``topk_idx`` against a stable host ranking of the full rows, and
   ``blame`` naming a flow planted on one edge of D's tree under fast
   pairwise on D's segment networks;
   ``path_n`` — ``doctor`` on the card: N1 the live run through
   ``cli.main(["doctor", ...])`` on the fat tree k=160 for 200 rounds,
   on the node kernel through K1 (K1 launched at least once a round) and
   on the edge kernel's plain round (the antisymmetry series): exit code
   0, no ``fail``, the environment (naming the cuda backend), the final
   report and every series check whose metric the kernel records judged;
   N2 the manifests paths L and M built at full width — the run
   manifests of L5's series on A, D, F and J3, the plan manifests of L1
   and L2, the field manifests of A and of the planted leak — judged by
   ``health.diagnose_manifest`` and, the run and plan manifests written
   to a temporary directory, by one ``doctor`` call through the CLI
   with the same verdicts; the run manifests' series checks judged; D's
   manifest with its last ten rmse rows set to NaN exits 1 with
   ``nan_divergence`` at ``fail``; every verdict recorded;
   ``path_o`` — the sweep engine and the scenarios: O1
   ``cli.main(["sweep", ...])`` on the card over ``fat_tree:32`` x 8 seeds
   x 4 drop rates x 4 timeouts (128 lanes in one bucket of 1,310,720 node
   and 7,340,032 edge slots, 100 faithful rounds with per-lane
   telemetry), its manifest judged by ``doctor`` (no ``fail``), then the
   same bucket timed (ms a bucket round by CUDA events; device ms, busy
   share and launches a round by the profiler; peak memory; lane-rounds a
   second) beside one lane's instance alone through ``Engine``; O2 lanes
   0, 63 and 127 (and 0, 15, 31 of a 32-lane faithful pairwise grid)
   after 40 rounds ``torch.equal`` on every leaf to the same instance
   packed alone, and their distance from the unpadded ``run_rounds(
   params=)`` run recorded (the card's CSR row sums add in another order
   than the row fold; within ``EDGE_TWIN_ATOL``); O3 ``cli.main([
   "scenarios", ...])`` over the whole registry (rc 0, ``pass``, one
   bucket structure a scenario, seconds by scenario) and the two negative
   controls (rc 1, ``fail``); O4 ``Engine(adversary=)`` on path D's
   networks (lying and silent switches, scaled wires): B3 and B4
   launches against the plans over 20 rounds after the bootstrap,
   ``torch.equal`` to its ``segment``/``gather`` twin, away from the
   honest round;
   ``path_p`` — the streaming service: P1 ``cli.main(["serve", ...])`` on
   ``ring(1_000_000, 2)`` at capacity 1,048,576 (degree budget 6,
   segments of 32 rounds, float32 fast collect-all) through 16 epochs of
   a seeded churn script (64 joins wired by two edges each, 64 updates,
   64 leaves, 8 suspends resumed at the next boundary and 8 edge removals
   a boundary, an ``estimates 16`` read an epoch, a checkpoint after
   epoch 8), ``compile_count`` 1 and ``doctor``'s verdict on its manifest
   (the four service checks ``pass``); P2 a service with no events, 64
   rounds ``torch.equal`` on every leaf to ``run_rounds(params=)`` on the
   same arrays and within ``EDGE_TWIN_ATOL`` of the padded arrays without
   rows (the card's CSR ``segment_reduce``), then ms a segment by CUDA
   events under churn against the same arrays with no events, device ms,
   busy share and launches a round, one boundary sample's ms, events a
   second on the host and a checkpoint's save and restore; P3 P1's
   epoch-8 archive restored and the script's last 8 epochs applied:
   ``state_digest`` equal to P1's end; P4 a child ``serve --wal`` on
   ``ring(100_000, 2)`` with churn and 1% loss killed with SIGKILL after
   20 journal records, ``serve --wal --recover`` finishing the script:
   the digest equal to an uninterrupted control's, ``doctor``'s
   ``check_recovery`` ``pass`` and ``blame_recovery`` naming the kill;
   ``path_q`` — the query and aggregate fabric: Q1 ``cli.main(["query",
   ...])`` at the acceptance size (``erdos_renyi(99_000, 6)``, capacity
   100,000, degree budget 24, 1,024 lanes, segments of 8 rounds, eps
   1e-2, 1,536 queries of 35 members arriving Poisson(512) a boundary,
   float32) with ``--report`` and ``--metrics``: ``compile_count`` 1, a
   recycled lane, every query retired, ``doctor``'s four query checks
   ``pass``, queries retired a second and peak memory; Q2 a fabric of
   that size with 1% loss and join/add-edge/leave churn: one lane
   ``torch.equal`` to an isolated one-query fabric on every lane plane,
   free lanes at exactly 0.0 residual at every boundary, and ms a
   segment, the lane probe's ms, device ms and launches a round; Q3 an
   ``AggregateFabric`` at ``aggregate_smoke.py``'s size (10,000
   members, 32 lanes): all five kinds, a second wave into retired lanes,
   ``compile_count`` exactly 2, every read against its numpy oracle,
   ``doctor``'s aggregate checks ``pass``; Q4 a child ``query --wal``
   killed with SIGKILL at a seeded segment, ``query --wal --recover``:
   the digest equal to an uninterrupted control's, then a NaN-poisoned
   lane under the watchdog quarantined with every other lane
   ``torch.equal`` to an unpoisoned control.  Path Q launches no kernel
   of the port (the fabric runs the plain row fold);
   ``path_s`` — actors: S1 ``push_sum_actor()`` through
   ``Engine.register_actor`` on the k=160 fat tree for 200 rounds (the
   totals of ``s`` and ``w`` within 1e-5 at every sample, the rmse
   falling, K1 launched twice a round per non-empty in-edge bucket, a
   second run and a resume from the round-100 actor archive
   ``torch.equal``, ``sum_to_dst`` against its plain version; ms, device
   ms and launches a round); S2 the collect-all ``Peer`` of
   ``examples/torch_host_actors.py`` on small6 through
   ``Engine(host_actors=True)``: converged, stopped by ``kill_all``,
   replayed exactly; S3 ``estimate_count``/``sum`` (float64, node round
   through K1) and ``estimate_min``/``max`` on the k=160 fat tree: within
   1e-3, exact;
   ``path_r`` — the chaos registry: ten ``chaos`` CLI processes started
   at once, each with its child on the card: R1 all seven faults at
   ``erdos_renyi(10_000, 8)`` x 32 lanes, 28 ops (every process exit 0,
   ``doctor --strict`` on each manifest but the storm's
   ``forecast_calibrated``, which the JAX package's own manifest fails
   too, ``blame_top`` the fault, the five kill and tamper recoveries'
   digests equal to their controls, the NaN lane's others equal and free
   lanes at 0.0, the storm drained); R2 ``--perturb`` for
   ``kill_at_segment``, ``bitflip_archive`` and ``nan_poison_lane`` at
   625 members: each signature and ``doctor --strict`` fail;
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

Every phase line carries ``elapsed_s`` (seconds since the start) and
``wall_s`` (seconds since the previous phase line, or the whole phase on
the line that closes a phase of several parts).

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
REPS = 10               # calls per kernel timing (the profiler spends
#                         ~50-70 host us an event turning a trace into
#                         rows: traces are most of the script's time)
TRACES = 1              # profiler traces per device-time measurement
PROFILE_ROUNDS = 5      # rounds per path under the profiler
PROFILE_TRACES = 1      # profile: traces per path (the most device time
#                         counts)
EDGE_BOOT = 50          # path D: the faithful timeout (no fire before it)
EDGE_ROUNDS = 150       # path D: timed rounds after the bootstrap
TWIN_ROUNDS = 60        # path D: rounds before the twin comparisons
PAIRWISE_ROUNDS = 50    # path D: fast pairwise rounds
STAR_HUB = 5000         # k4: the hub degree that splits B4's passes
SHARDS = 4              # k5, path E: shards of the mesh (all on one card)
GRID_SIDE = 1000        # k5: grid2d(1000, 1000), the remainder-heavy plan
HALO_ROUNDS = 100       # path F: timed rounds after the twin comparison
STRESS_NODES = 4000     # k6: the stress run's erdos_renyi(4000, 6)
STRESS_ROUNDS = 50      # k6: the stress run's rounds
RING_STRESS_N = 20000   # k5: the stress run's ring(20000, 2)
RING_STRESS_ROUNDS = 250  # k5: the stress run's rounds
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
DES_TICKS = 1120        # path H1/H2: rounds (ticks) of each 1e6 curve
DES_TICKS_1E5 = 400     # path H1/H2: ... of each 1e5 curve (their latest
#                         crossing is round 210)
OBS = 10                # path H1/H2: the curves' sampling interval
LINK_SER_ROUNDS = 0.01  # path H3: a message's serialization, in rounds
DES_BASE_TICKS = 3      # des: ticks of each timed DES run (k=160)
DES_REPEATS = 1         # des: timed runs per timeout
DES_FIXED_TICKS = 1000  # des: ring(24, 2) rounds to the fixed point
C1_ROUNDS = 10          # c1: rounds of path E per measurement
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
BA_N, BA_M = 1_000_000, 4   # path L: barabasi_albert(1_000_000, 4)
L_ROUNDS = 20           # L2: timed rounds of the chosen route and of each
#                         of the four candidates, per repeat
L_REPS = 40             # L2: interleaved repeats of each candidate's timing
#                         (the host's pace swings +-20% on host-bound
#                         rounds: medians of 5 read routes 10% apart in
#                         either order)
PLAN_MARGIN = 0.10      # L2: the choice within this share of the fastest
#                         candidate's rate (doctor's plan_selection margin)
L_F64_ROUNDS = 40       # L2: float64 rounds held to spmv='xla'
L_F64_TOL = 1e-9        # L2: ... within this
TELEMETRY_ROUNDS = 10   # L5: rounds of paths F and J3 under telemetry
L_SERIES_RTOL = 1e-5    # L5: halo vs single-device float32 series, as a
#                         share of each series' largest value (the
#                         shards' partial sums add in another order)
M_ROUNDS = 20           # path M: rounds of each fields run on A, B, C
M_EDGE_ROUNDS = 10      # path M: ... on D
M_HALO_ROUNDS = 10      # path M: ... on F (FieldSpec.full() there is
#                         ~260 MB a row: four shards of Eb edge slots)
M_STRIDE = 10           # path M: the sparse stride (the dense one is 1)
M_TOPK = 16             # path M: A's ranked nodes a row
M_LEAK = 100.0          # path M: the flow planted on one edge of D's tree
M_LEAK_WARMUP = 50      # path M: fast pairwise rounds before the plant
M_LEAK_SETTLE = 60      # path M: plain rounds after the plant, while the
#                         planted deficit mixes away from its ends
M_LEAK_ROUNDS = 40      # path M: rounds then recorded (stride 10)
M_J3_ROUNDS = 20        # path M: J3's fields rounds (stride 10 only: a
#                         row of the default fields is ~0.8 GB there)
N_ROUNDS = 200          # path N: rounds of each live doctor run
O_GENERATOR = "fat_tree:32"   # path O: each lane's topology (9,472 nodes,
#                               49,152 edges; bucket (10240, 57344))
O_SEEDS = 8             # O1: seeds of the grid (x 4 drops x 4 timeouts
#                         = 128 lanes in one bucket)
O_DROPS = "0,0.01,0.05,0.1"
O_TIMEOUTS = "2,4,8,16"
O_ROUNDS = 100          # O1: the sweep's rounds (with per-lane telemetry)
O_TIMED_ROUNDS = 20     # O1: bucket rounds timed by CUDA events
O_CHECK_ROUNDS = 40     # O2: rounds before the lanes are compared
O_LANES = (0, 63, 127)  # O2: the lanes held to B = 1 and to one instance
O_PAIRWISE_SEEDS = 2    # O2: the pairwise grid (32 lanes)
O_PAIRWISE_LANES = (0, 15, 31)
O_SCENARIO_SEEDS = 1    # O3: seeds of each scenario's grid
O4_ROUNDS = 20          # O4: rounds after the timeout bootstrap
P_CAPACITY = 1_048_576  # path P: the service's node slots (RING_N members)
P_BUDGET = 6            # P: the degree budget (a ring node has 4)
P_SEGMENT = 32          # P: rounds a segment
P_EPOCHS = 16           # P1: epochs of the churn script (one run each)
P_CKPT_EPOCH = 8        # P1: the checkpoint P3 restores, after this epoch
P_JOINS = 64            # P1: joins a boundary (two add-edges each)
P_UPDATES = 64          # P1: updates a boundary
P_LEAVES = 64           # P1: leaves of earlier joiners a boundary
P_SUSPENDS = 8          # P1: suspends a boundary (resumed at the next)
P_REMOVES = 8           # P1: remove-edges a boundary
P2_ROUNDS = 64          # P2: rounds of the no-event twin
P_TIMED_SEGMENTS = 8    # P2: segments timed with and without churn
P4_N = 100_000          # P4: the killed child's ring:P4_N:2
P4_CAPACITY = 131_072   # P4: its node slots
P4_SEGMENT = 16         # P4: rounds a segment (a run is two)
P4_EPOCHS = 3           # P4: epochs of its script
P4_DROP = 0.01          # P4: message loss
P4_KILL_RECORDS = 20    # P4: WAL records before the SIGKILL
Q_NODES = 99_000        # path Q: erdos_renyi(99_000, avg_degree=6) members
Q_CAPACITY = 100_000    # Q: node slots
Q_BUDGET = 24           # Q: the degree budget
Q_LANES = 1024          # Q: query lanes
Q_SEGMENT = 8           # Q: rounds a segment
Q_EPS = 1e-2            # Q: the retirement tolerance
Q_QUERIES = 1536        # Q1: queries offered (1.5 x lanes)
Q_COHORT = 35           # Q1: cohort members (the mean of 8-63)
Q_ROUNDS = 4096         # Q1: the round budget (it stops once all retire)
Q2_SEGMENTS = 4         # Q2: segments after the target's admission
Q2_DROP = 0.01          # Q2: message loss
Q2_TIMED_SEGMENTS = 2   # Q2: segments timed by CUDA events
Q3_NODES = 10_000       # Q3: erdos_renyi(10_000, 6), aggregate_smoke's
Q3_LANES = 32           # Q3: lanes shared by every kind
Q3_EVENTS = 16          # Q3: churn events between segments
Q3_QEPS = 0.34          # Q3: the quantile's rank tolerance (3 brackets)
Q4_NODES = 10_000       # Q4: the killed child's erdos_renyi:Q4_NODES:6
Q4_LANES = 32           # Q4: its lanes
Q4_KILL_SEGMENT = 5     # Q4: the child is killed once this segment's run
#                         record is journaled
R_NODES = 10_000        # R1: chaos --nodes (JAX's scripts/chaos_smoke.py
#                         floor of 10,000 members)
R_LANES = 32            # R1, R2: chaos --lanes (path Q4's)
R_OPS = 28              # R1, R2: chaos --ops (the scripted events)
R2_NODES = R_NODES // 16    # R2: the perturbed runs' members (JAX's
#                             nodes // 16)
R2_FAULTS = ("kill_at_segment", "bitflip_archive", "nan_poison_lane")
R_TIMEOUT_S = 420       # R: each chaos process's limit
R_BACKEND = "cuda"      # R: where every recovery and control must run
#: R1: doctor --strict checks that the JAX package's own manifest of the
#: same fault fails at these sizes (ROADMAP C12: at 10,000 x 32 the
#: storm banks one forecast ratio of 17.4 against a band of 2, in both
#: packages alike); any other failing check fails path R
R_REFERENCE_FAILS = {"admission_storm": {"forecast_calibrated"}}
S_ROUNDS = 200          # S1: push-sum rounds on the fat tree
S_CKPT_ROUND = 100      # S1: the actor checkpoint's round
S_SAMPLE = 20           # S1: rounds between conservation samples
S_MASS_RTOL = 1e-5      # S1: JAX's tolerance (tests/test_actor.py:56)
S_TIMED_ROUNDS = 20     # S1: rounds timed by CUDA events after the run
S2_DEADLINE = 400.0     # S2: the watcher's kill_all (simulated s)
S2_UNTIL = 500.0        # S2: the run's horizon (simulated s)
S3_ROUNDS = 200         # S3: rounds of each mean run (count and sum)
T_ROUNDS = 4            # T: rounds of each Engine.profile (counted, timed)
T5_ROUNDS = 2           # T5: path F's rounds (its round is ~40 ms)
T_RING_N = 4096         # T2, T4: the ring twin, ring(4096, 2)
T5_CLI_GENERATOR = "fat_tree:32"    # T5: the profile CLI process's graph
T5_CLI_TIMEOUT_S = 300  # T5: its time limit
T_TWIN_DEVICES = ("cuda", "cpu")    # T: where each twin counts



def h100():
    """The card's rates: the package's declared H100 model
    (``obs/roofline.py``: HBM 3.35 TB/s, float32 67 TFLOP/s outside the
    tensor cores), which the perf lens reads too."""
    from flow_updating_tpu_torch.obs.roofline import H100

    return H100


T_START = time.perf_counter()
#: when the last phase line was printed (``emit`` keeps it)
_LAST_PHASE = [T_START]


def emit(obj) -> None:
    """One JSON line; a phase's line also carries the seconds since the
    script started (``elapsed_s``) and, unless it states its own, the
    seconds since the previous phase line (``wall_s``)."""
    if "phase" in obj:
        now = time.perf_counter()
        obj = {"wall_s": now - _LAST_PHASE[0], **obj,
               "elapsed_s": now - T_START}
        _LAST_PHASE[0] = now
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
    the HBM rate and the operations over the float32 rate (:func:`h100`)."""
    by_bytes = nbytes / h100().hbm_bytes_per_s * 1e3
    by_ops = ops / h100().vpu_flop_per_s * 1e3
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
    from flow_updating_tpu_torch.obs.profile import launch_counters

    for wrapper in launch_counters().values():
        wrapper.launches = 0


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


def round_network_calls(cfg, adversary=None) -> dict:
    """Network applications and B4 calls of one edge round on the planned
    segment networks, by the round's code (models/rounds.py): deliver
    broadcasts ``alive`` and, per drain step, takes two segment minima and
    broadcasts each; collect-all fire reduces (flow, est) as one batched
    sum scan plus, in the faithful mode, the all-heard scan, through ONE
    extraction, and broadcasts (fire, avg) as one batch; fast pairwise
    fire reduces the flow sum, the matched max and the average sum one by
    one; delivery='benes_fused' moves the lanes through the rev network
    once; an adversary's lie and silent masks are one broadcast each."""
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
    if adversary is not None:
        places += bool(adversary.lie_nodes) + bool(adversary.silent_nodes)
    return {"scan": scans, "fill": places, "extract": extracts,
            "place": places, "rev": int(cfg.delivery == "benes_fused")}


def planned_launches(arrays, cfg, adversary=None) -> dict:
    """B3 launches per flavour and B4 launches per flavour of one edge
    round, from the plans (passes per network, B4 passes per stage list)
    and :func:`round_network_calls`."""
    from flow_updating_tpu_torch.ops.fused_passes import plan_dist_passes

    calls = round_network_calls(cfg, adversary)
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
        [b.numel() for b in senders], 4) / h100().hbm_bytes_per_s * 1e3
    del pull_sets
    # pure data movement: no arithmetic to bound by
    out.update(bound(hx.halo_exchange_min_bytes(
        [b.numel() for b in senders], 4, D, plan.Eb, 1,
        hit_cells=int(hit.sum()), hit_columns=int(hit.any(0).sum())), 0))
    out["hit_share"] = float(hit.float().mean())
    out["sector_bytes"] = _sector_bytes(hit, 4, [b.numel() * 4
                                                 for b in senders])
    out["sector_floor_ms"] = (out["sector_bytes"]
                              / h100().hbm_bytes_per_s * 1e3)
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


def _observed(topo, cfg, device, ticks: int) -> list:
    """The rmse curve of ``ticks`` rounds, sampled every ``OBS``."""
    from flow_updating_tpu_torch.models import rounds
    from flow_updating_tpu_torch.models.state import init_state

    _, m = rounds.run_rounds_observed(
        init_state(topo, cfg, device=device),
        topo.device_arrays(device=device), cfg, ticks, OBS,
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
        ticks = DES_TICKS if mb == SMALL6_MSG_BYTES[1] else DES_TICKS_1E5
        D = topo.contended_max_delay()
        h1[f"{mb:g}"] = cells = {"delay_depth": D,
                                 "max_static_delay": topo.max_delay}
        for variant in ("collectall", "pairwise"):
            cfg = RoundConfig.reference(variant, delay_depth=D,
                                        contention=True,
                                        contention_backlog=True,
                                        dtype="float64")
            card = _observed(topo, cfg, "cuda", ticks)
            host = _observed(topo, cfg, "cpu", ticks)
            des = native.des_run_contend(
                topo, variant, timeout=50, ticks=ticks, obs_every=OBS,
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
            card = _observed(topo, eng.config, "cuda", ticks)
            lmm = native.des_run_contend(
                topo, variant, timeout=50, ticks=ticks, obs_every=OBS,
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
                       "ticks": [DES_TICKS_1E5, DES_TICKS],
                       "obs_every": OBS}}


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


def _edge_leaves_equal(a, b, N=None, E=None) -> list:
    """The names of the leaves where two edge states differ; with ``N``
    and ``E``, on the first N nodes and E edges only (a padded sweep
    lane's real slots; the FIFO and ring fields on their edge axis)."""
    import dataclasses

    import torch

    def part(name, x):
        if N is None or name in ("t", "key"):
            return x
        if name in ("value", "ticks", "last_avg", "fired", "alive"):
            return x[:N]
        if name in ("flow", "est", "recv", "stamp", "edge_ok"):
            return x[:E]
        return x[:, :E]

    return [f.name for f in dataclasses.fields(a)
            if not torch.equal(part(f.name, getattr(a, f.name)),
                               part(f.name, getattr(b, f.name)))]


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
        if overlap:     # paths L5 and M on the pod kernel, at full width
            out["telemetry"] = telemetry_check(eng, TELEMETRY_ROUNDS)
            out["fields"] = fields_check(eng, M_J3_ROUNDS,
                                         strides=(M_STRIDE,))
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
    up for (:func:`_device_rows`); of ``PROFILE_TRACES`` traces the one
    with the most device time counts.  ``busy_share`` is None when the trace holds
    no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    best = None
    for _ in range(PROFILE_TRACES):
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


# ---- path T: Engine.profile on every kernel kind at full width -----------

def _t_equal(a, b) -> bool:
    """Two states (or any trees of tensors) equal bit for bit, their round
    counters too."""
    import torch

    from flow_updating_tpu_torch.obs.profile import _tensors

    ta, tb = _tensors(a), _tensors(b)
    return (getattr(a, "t", None) == getattr(b, "t", None)
            and len(ta) == len(tb)
            and all(x.shape == y.shape and x.dtype == y.dtype
                    and torch.equal(x, y) for x, y in zip(ta, tb)))


def _t_run(engine, rounds: int):
    """``rounds`` rounds of ``engine``'s program from a copy of its state
    (the engine's own state stays as it is)."""
    import torch

    from flow_updating_tpu_torch.obs.profile import _clone

    fn, args, nd = engine.round_program(rounds)
    out = fn(*_clone(tuple(args[:nd])), *args[nd:])
    torch.cuda.synchronize()
    return out


def t_profile(engine, expect: dict, rounds: int = None, **kw) -> dict:
    """Gates 1, 2, 4 and 5 of a phase of path T on a full-width engine:
    its state equal before and after ``Engine.profile(rounds,
    roofline=True)``, a run after the profile equal to one before it,
    ``roofline_frac`` in (0, 1], and the launches a round equal to
    ``expect`` (the plans' own counts)."""
    import torch

    from flow_updating_tpu_torch.obs.profile import _clone

    rounds = T_ROUNDS if rounds is None else rounds
    before = _clone(engine.state)
    ref = _t_run(engine, rounds)
    t0 = time.perf_counter()
    rec = engine.profile(rounds, roofline=True, **kw)
    torch.cuda.synchronize()
    profile_s = time.perf_counter() - t0
    if not _t_equal(engine.state, before):
        raise AssertionError(f"path T: {rec['mode']}'s state changed "
                             "under Engine.profile")
    if not _t_equal(_t_run(engine, rounds), ref):
        raise AssertionError(f"path T: a run of {rec['mode']} after the "
                             "profile differs from one before it")
    del before, ref
    rl = rec["roofline"]
    frac = rl["roofline_frac"]
    if not (isinstance(frac, float) and 0.0 < frac <= 1.0):
        raise AssertionError(f"path T: {rl['mode']} roofline_frac {frac} "
                             "outside (0, 1]")
    got = rec["launches_per_round"]
    want = {k: float(v) for k, v in expect.items() if v}
    if got != want:
        raise AssertionError(f"path T: {rl['mode']} launched {got} a "
                             f"round, the plans give {want}")
    return {"mode": rl["mode"], "rounds": rounds, "profile_s": profile_s,
            "cost": {k: rec["cost"][k] for k in
                     ("bytes_accessed", "flops", "kernels", "raw")},
            "per_round": rec["per_round"], "memory": rec["memory"],
            "timings": rec["timings"], "launches_per_round": got,
            "launches_match_plans": True, "state_untouched": True,
            "rerun_equal": True,
            "roofline": {k: rl.get(k) for k in
                         ("model", "binding", "bytes_per_round",
                          "flops_per_round", "floor_s_per_round",
                          "ceiling_rounds_per_sec",
                          "measured_rounds_per_sec", "roofline_frac",
                          "floor_frac", "known_discrepancy")},
            "ms_per_round": 1e3 / rl["measured_rounds_per_sec"],
            "nvidia_smi": nvidia_smi_line()}, rec


def t_twin(make) -> dict:
    """Gate 3: a small twin of the phase's kind counts the same bytes on
    the card as on the CPU (``make(device)`` builds it).  On a mismatch
    the per-op tallies name what differs."""
    from flow_updating_tpu_torch.obs.profile import _clone
    from flow_updating_tpu_torch.utils import cost

    out, by_op = {}, {}
    for side, dev in zip(("card", "cpu"), T_TWIN_DEVICES):
        engine = make(dev)
        rec = engine.profile(T_ROUNDS, execute=False)
        out[side] = {"bytes_accessed": rec["cost"]["bytes_accessed"],
                     "flops": rec["cost"]["flops"],
                     "kernels": rec["cost"]["kernels"]}
        if side == "card":
            out["launches_per_round"] = rec["launches_per_round"]
        fn, args, nd = engine.round_program(T_ROUNDS)
        with cost.count() as c:
            fn(*_clone(tuple(args[:nd])), *args[nd:])
        by_op[side] = c.by_op
        del engine
    card, cpu = out["card"], out["cpu"]
    if (card["bytes_accessed"], card["flops"]) \
            != (cpu["bytes_accessed"], cpu["flops"]):
        diff = {op: (by_op["card"].get(op), by_op["cpu"].get(op))
                for op in set(by_op["card"]) | set(by_op["cpu"])
                if by_op["card"].get(op) != by_op["cpu"].get(op)}
        raise AssertionError(
            f"path T: the twin counts {card} on the card and {cpu} on the "
            f"CPU; per op (card, cpu): {diff}")
    out["equal"] = True
    return out


def phase_path_t1(engine_a) -> dict:
    """T1: kernel K1 (path A's engine, fat tree k=160, 'pallas')."""
    from flow_updating_tpu_torch import Engine, RoundConfig
    from flow_updating_tpu_torch.topology.generators import fat_tree

    buckets = sum(1 for m in engine_a._node_kernel.arrays.mats
                  if m.shape[0] and m.shape[1])
    out, _ = t_profile(engine_a, {"K1": buckets})
    cfg = RoundConfig.fast(kernel="node", spmv="pallas")
    small = fat_tree(8)
    out["twin"] = t_twin(lambda dev: Engine(config=cfg, device=dev)
                         .set_topology(small).build())
    return out


def phase_path_t2(engine_b) -> dict:
    """T2: kernel K2 (path B's engine, ring 1M, 'banded_fused')."""
    from flow_updating_tpu_torch import Engine, RoundConfig
    from flow_updating_tpu_torch.topology.generators import ring

    out, _ = t_profile(engine_b, {"K2": 1})
    cfg = RoundConfig.fast(kernel="node", spmv="banded_fused")
    small = ring(T_RING_N, 2)
    out["twin"] = t_twin(lambda dev: Engine(config=cfg, device=dev)
                         .set_topology(small).build())
    return out


def phase_path_t3(engine_d) -> dict:
    """T3: kernels B3 and B4 (path D's engine, the faithful edge round on
    'benes_fused' networks)."""
    from flow_updating_tpu_torch import Engine
    from flow_updating_tpu_torch.topology.generators import fat_tree

    plan = planned_launches(engine_d._topo_arrays, engine_d.config)
    expect = {f"B3.{k}": plan[k] for k, _, _, _ in B3_FLAVOURS}
    expect.update({f"B4.{k}": plan[k] for k, _, _ in B4_FLAVOURS})
    out, _ = t_profile(engine_d, expect)
    cfg = engine_d.config
    small = fat_tree(8)
    out["twin"] = t_twin(lambda dev: Engine(config=cfg, device=dev)
                         .set_topology(small).build(seed=SEED))
    return out


def phase_path_t4(engine_e) -> dict:
    """T4: kernel B5 (path E's engine, ring 1M over four shards,
    overlapped)."""
    from flow_updating_tpu_torch import Engine
    from flow_updating_tpu_torch.ops.sharded_round import (
        launches_per_shard_round,
    )
    from flow_updating_tpu_torch.parallel.mesh import make_mesh
    from flow_updating_tpu_torch.topology.generators import ring

    kern = engine_e._node_kernel
    per_shard = launches_per_shard_round(kern.spec, kern.exchange)
    out, _ = t_profile(engine_e, {"B5.merge": SHARDS * per_shard})
    cfg = engine_e.config
    small = ring(T_RING_N, 2)
    out["twin"] = t_twin(lambda dev: Engine(
        config=cfg, mesh=make_mesh(SHARDS, device=dev), halo="overlap",
        device=dev).set_topology(small).build())
    return out


def phase_path_t5(engine_f, tmp) -> dict:
    """T5: kernel B6 (path F's engine, the faithful halo round over four
    shards, 'overlap_pallas') with a trace; then the ``profile`` CLI as a
    process, ``doctor`` on its manifest (the CLI and in memory) and
    ``regress`` of the manifest against itself."""
    import contextlib
    import io

    from flow_updating_tpu_torch import Engine
    from flow_updating_tpu_torch.cli import main as cli_main
    from flow_updating_tpu_torch.obs import health
    from flow_updating_tpu_torch.parallel.mesh import make_mesh
    from flow_updating_tpu_torch.topology.generators import fat_tree

    trace_dir = os.path.join(tmp, "t5_trace")
    out, rec = t_profile(engine_f, {"B6.fused": SHARDS},
                         rounds=T5_ROUNDS, trace_dir=trace_dir)
    ov = rec["overlap"]
    measured = ov.get("measured") or {}
    out["trace"] = {k: v for k, v in rec["trace"].items()
                    if k != "trace_file"}
    out["overlap"] = {
        "overlap_ratio": ov["overlap_ratio"],
        "execute_s": ov["execute_s"],
        "measured_overlap": measured.get("overlap_ratio_measured"),
        "measured_trace_complete": measured.get("trace_complete"),
        "measured_kernels": measured.get("kernels"),
        "wire_ops": measured.get("wire_ops"),
        "error": measured.get("error")}
    print(f"chip_smoke: T5 measured_overlap="
          f"{out['overlap']['measured_overlap']} trace_complete="
          f"{out['trace']['trace_complete']} (overlap capture: "
          f"{out['overlap']['measured_trace_complete']})", flush=True)
    cfg = engine_f.config
    small = fat_tree(8)
    out["twin"] = t_twin(lambda dev: Engine(
        config=cfg, mesh=make_mesh(SHARDS, device=dev), multichip="halo",
        halo="overlap_pallas", partition="bfs", device=dev)
        .set_topology(small).build(seed=SEED))
    # the profile subcommand as a user runs it, in a process of its own
    manifest = os.path.join(tmp, "t5_profile.json")
    argv = [sys.executable, "-m", "flow_updating_tpu_torch", "profile",
            "--generator", T5_CLI_GENERATOR, "--shards", str(SHARDS),
            "--multichip", "halo", "--halo", "overlap_pallas",
            "--rounds", str(T_ROUNDS), "--roofline",
            "--trace-dir", os.path.join(tmp, "t5_cli_trace"),
            "--report", manifest]
    t0 = time.perf_counter()
    proc = subprocess.run(argv, cwd=ROOT, capture_output=True, text=True,
                          timeout=T5_CLI_TIMEOUT_S)
    cli_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"path T: the profile CLI exited "
                             f"{proc.returncode}: {proc.stderr[-2000:]}")
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    with open(manifest) as f:
        doc = json.load(f)
    if doc["schema"] != "flow-updating-profile-report/v1" \
            or doc["profile"]["cost"]["bytes_accessed"] <= 0:
        raise AssertionError("path T: the profile manifest is malformed")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        doctor_rc = cli_main(["doctor", manifest])
    doctor_cli = json.loads(buf.getvalue().strip().splitlines()[-1])
    in_memory = health.diagnose_manifest(doc)
    cli_verdicts = [(c["name"], c["status"]) for c in doctor_cli["checks"]]
    mem_verdicts = [(c.name, c.status) for c in in_memory]
    if cli_verdicts != mem_verdicts:
        raise AssertionError(f"path T: the doctor CLI gives {cli_verdicts}, "
                             f"diagnose_manifest {mem_verdicts}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        regress_rc = cli_main(["regress", "--fresh", manifest, "--against",
                               manifest])
    if regress_rc != 0:
        raise AssertionError(f"path T: regress of the manifest against "
                             f"itself exited {regress_rc}: "
                             f"{buf.getvalue()[-1000:]}")
    cli_trace = line.get("trace") or {}
    out["cli"] = {
        "generator": T5_CLI_GENERATOR, "process_s": cli_s,
        "mode": line["roofline"]["mode"],
        "roofline_frac": line["roofline"]["roofline_frac"],
        "bytes_per_round": line["per_round"]["bytes_accessed"],
        "launches_per_round": line["launches_per_round"],
        "trace_complete": cli_trace.get("trace_complete"),
        "measured_overlap": (line.get("overlap") or {}).get(
            "overlap_ratio_measured"),
        "doctor_rc": doctor_rc, "doctor_overall": doctor_cli["overall"],
        "doctor_verdicts_equal": True, "verdicts": cli_verdicts,
        "regress_rc": regress_rc}
    return out


# ---- path L: plan='auto' on the card and telemetry at full width ---------

def _host_reads_mode():
    """A dispatch mode counting host reads: scalar reads
    (``aten._local_scalar_dense``) and copies from the card to the host."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class Reads(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.scalars = 0
            self.copies = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if func is torch.ops.aten._local_scalar_dense.default:
                self.scalars += 1
            elif (func is torch.ops.aten._to_copy.default
                  and args[0].is_cuda
                  and torch.device(kwargs.get("device") or "cuda").type
                  == "cpu"):
                self.copies += 1
            elif (func is torch.ops.aten.copy_.default
                  and not args[0].is_cuda and args[1].is_cuda):
                self.copies += 1
            return func(*args, **kwargs)

    return Reads()


def _same_state(a, b) -> bool:
    """Every tensor of two states of any kernel, ``torch.equal``."""
    import dataclasses

    import torch

    if hasattr(a, "shards"):
        return _states_equal(a, b)
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        pairs = zip(x, y) if isinstance(x, tuple) else ((x, y),)
        for p, q in pairs:
            if isinstance(p, torch.Tensor):
                if not torch.equal(p, q):
                    return False
            elif p != q:
                return False
    return True


def _run_manifest(engine, series) -> dict:
    """The manifest ``run --telemetry full --report`` writes for
    ``series`` (path N judges it): the engine's convergence report with
    the true mean and the node count, as ``run`` adds them."""
    from flow_updating_tpu_torch.obs.report import build_manifest

    report = engine.convergence_report()
    report["true_mean"] = engine.topology.true_mean
    report["nodes"] = engine.topology.num_nodes
    return build_manifest(config=engine.config, topo=engine.topology,
                          report=report, telemetry=series,
                          device=engine.device)


def telemetry_check(engine, rounds: int) -> dict:
    """L5 on one engine: ``rounds`` plain rounds timed, then the same
    rounds from the same state under ``TelemetrySpec.full()``: the states
    ``torch.equal``, the last rmse row against the rmse of
    ``estimates()``, the last ``mass_residual`` against the host's sum,
    the host reads inside the loop (expected 0) and the overhead.  The
    record's ``manifest`` (the run manifest of the series, for path N) is
    popped before it is printed."""
    import numpy as np
    import torch

    from flow_updating_tpu_torch.obs.telemetry import TelemetrySpec

    s0, clock0 = engine.state, engine.clock
    with _host_reads_mode() as plain_reads:
        plain_ms = _timed_rounds(engine, rounds)
    plain = engine.state
    engine.state, engine._clock = s0, clock0
    torch.cuda.synchronize()
    with _host_reads_mode() as reads:
        t0 = time.perf_counter()
        series = engine.run_telemetry(rounds, TelemetrySpec.full())
        tele_ms = (time.perf_counter() - t0) * 1e3
    kind = engine._kernel_kind
    # the bulk copies at the end: one per series tensor on the card (the
    # node and pod kernels count rounds on the host, the pod kernel its
    # fired and active counts too)
    host_made = ("fired_total", "active") if kind == "pod" else ()
    bulk = sum(1 for m in series.metrics if m not in host_made) \
        + (1 if kind in ("edge", "halo") else 0)
    if not _same_state(engine.state, plain):
        raise AssertionError(f"L5 {kind}: the state after run_telemetry "
                             "differs from the state after run_rounds")
    est = engine.estimates().astype(np.float64)
    topo = engine.topology
    # the series measures against the true mean in the run's dtype
    mean = float(np.asarray(topo.true_mean, engine.estimates().dtype))
    host_rmse = float(np.sqrt(np.mean((est - mean) ** 2)))
    rel = abs(float(series["rmse"][-1]) - host_rmse) / host_rmse
    eps = float(np.finfo(np.float32).eps)
    if not rel <= 1e-4:
        raise AssertionError(f"L5 {kind}: the last rmse row is {rel} off "
                             "the rmse of estimates()")
    host_res = float(est.sum() - np.asarray(topo.values, np.float64).sum())
    res_tol = eps * topo.num_nodes * float(np.abs(est).max())
    res_diff = abs(float(np.sum(series["mass_residual"][-1])) - host_res)
    if not res_diff <= res_tol:
        raise AssertionError(f"L5 {kind}: mass_residual is {res_diff} off "
                             f"the host's (bound {res_tol})")
    return {"kernel": kind, "rounds": rounds, "metrics": list(series.metrics),
            "plain_ms_per_round": plain_ms / rounds,
            "telemetry_ms_per_round": tele_ms / rounds,
            "overhead": tele_ms / plain_ms - 1.0,
            "state_equal": True, "rmse_rel_diff": rel,
            "mass_residual_diff": res_diff, "mass_residual_bound": res_tol,
            "host_reads_plain_run": plain_reads.scalars + plain_reads.copies,
            "host_reads_in_loop": reads.scalars + reads.copies - bulk,
            "bulk_copies": bulk, "final": series.row(len(series) - 1),
            "manifest": _run_manifest(engine, series)}


def _gather_ratio(topo, dev) -> dict:
    """L0 on one graph: the node/xla gather of the graph's neighbor slots
    (its degree buckets, one ``xp[m]`` per bucket, each timed apart)
    against one streamed pass (a copy) over as many float32 elements,
    both by device time."""
    import numpy as np
    import torch

    ell = topo.ell_buckets()
    mats = [torch.from_numpy(np.ascontiguousarray(m)).to(dev)
            for m in ell.mats if m.size]
    slots = int(sum(m.numel() for m in mats))
    rng = np.random.default_rng(SEED)
    xp = torch.from_numpy(rng.random(topo.num_nodes + 1)).to(
        dev, torch.float32)
    src = torch.from_numpy(rng.random(slots)).to(dev, torch.float32)
    dst = torch.empty_like(src)
    # one bucket a measurement: the buckets' gathers share a kernel name,
    # and device_ms makes up for dropped profiler events per name, which
    # needs the launches of a name to be alike
    gather_ms = sum(device_ms(lambda m=m: xp[m]) for m in mats)
    stream_ms = device_ms(lambda: dst.copy_(src))
    return {"nodes": topo.num_nodes, "edges": topo.num_edges,
            "gathered_slots": slots, "buckets": len(mats),
            "gather_ms": gather_ms, "stream_ms": stream_ms,
            "gather_ps_per_slot": gather_ms * 1e9 / slots,
            "stream_ps_per_element": stream_ms * 1e9 / slots,
            "ratio": gather_ms / stream_ms}


def phase_path_l0(tree, ba) -> dict:
    import torch

    from flow_updating_tpu_torch.plan.select import GATHER_COST

    dev = torch.device("cuda")
    out = {"fat_tree": _gather_ratio(tree, dev),
           "barabasi_albert": _gather_ratio(ba, dev)}
    lo, hi = sorted((out["fat_tree"]["ratio"],
                     out["barabasi_albert"]["ratio"]))
    cg = GATHER_COST["cuda"]
    near = lo if abs(cg - lo) <= abs(cg - hi) else hi
    ok = lo <= cg <= hi or abs(cg - near) <= 0.25 * near
    out.update({"gather_cost_cuda": cg, "ratio_range": [lo, hi],
                "within_gate": ok})
    if not ok:
        raise AssertionError(f"L0: GATHER_COST['cuda'] = {cg} is not "
                             f"within [{lo}, {hi}] or 25% of {near}")
    return out


def _plan_manifest(engine) -> dict:
    """The manifest ``plan --report`` writes for the engine's
    ``plan='auto'`` decision (path N judges it)."""
    from flow_updating_tpu_torch.obs.report import build_plan_manifest

    doc = engine.plan_decision.describe()
    doc["nodes"] = engine.topology.num_nodes
    doc["directed_edges"] = engine.topology.num_edges
    return build_plan_manifest(config=engine.config, topo=engine.topology,
                               plan=doc, device=engine.device)


def phase_path_l1(tree) -> dict:
    """L1: Engine(plan='auto') on the fat tree k=160 takes the structured
    stencil with no probe, and its estimates equal J1's route's after the
    same rounds.  The record's ``manifest`` (the decision's plan manifest,
    for path N) is popped before it is printed."""
    import torch

    from flow_updating_tpu_torch import Engine, RoundConfig
    from flow_updating_tpu_torch.plan import select

    probes = select.PROBE_COUNT
    t0 = time.perf_counter()
    auto = Engine(config=RoundConfig.fast(), plan="auto").set_topology(tree)
    auto.build()
    build_s = time.perf_counter() - t0
    rep = auto.plan_report()
    if (rep["kernel"], rep["spmv"]) != ("node", "structured") \
            or select.PROBE_COUNT != probes or "autotune" in rep:
        raise AssertionError(f"L1: plan='auto' chose {rep['kernel']}/"
                             f"{rep['spmv']} with probes on the fat tree")
    j1 = Engine(config=_structured_cfg()).set_topology(tree).build()
    auto.run_rounds(ROUNDS)
    j1.run_rounds(ROUNDS)
    if not torch.equal(_estimate_tensor(auto), _estimate_tensor(j1)):
        raise AssertionError("L1: plan='auto' estimates differ from J1's")
    return {"decision": f"{rep['kernel']}/{rep['spmv']}", "probes_run": 0,
            "build_s": build_s, "reason": rep["reason"],
            "equal_to_j1": True, "rounds": ROUNDS,
            "manifest": _plan_manifest(auto)}


def _candidate_engines(topo, decision) -> dict:
    """L2's four candidates on ``topo``: node/xla, the decision's plan as
    node/banded and as node/banded_fused (at the autotuner's best fused
    knobs when it probed them), and the edge kernel's gather round."""
    import dataclasses

    from flow_updating_tpu_torch import Engine, RoundConfig
    from flow_updating_tpu_torch.plan.select import PlanDecision

    tune = decision.fused or {}
    best = tune.get("best") or {}
    knobs = {"fused_tile": None, "fused_remainder": "auto"}
    if best.get("spmv") == "banded_fused":
        knobs = {"fused_tile": best.get("fused_tile"),
                 "fused_remainder": best.get("fused_remainder") or "auto"}
    knobs = tune.get("chosen") or knobs

    def fixed(spmv, fused=None):
        return PlanDecision(kernel="node", spmv=spmv, plan=decision.plan,
                            backend="cuda", predicted={}, reason="L2",
                            fused=fused)

    cfg = RoundConfig.fast()
    return {
        "node/xla": lambda: Engine(config=dataclasses.replace(
            cfg, kernel="node", spmv="xla")),
        "node/banded": lambda: Engine(config=cfg, plan=fixed("banded")),
        "node/banded_fused": lambda: Engine(
            config=cfg, plan=fixed("banded_fused", {"chosen": knobs})),
        "edge/gather": lambda: Engine(config=cfg),
    }


def _plan_graph(name, topo, tmp) -> dict:
    """L2 on one graph: the cold decision with its probes, the cached
    second build, the chosen route's time, the four candidates' times,
    and the float64 agreement with spmv='xla'."""
    import numpy as np
    import torch

    from flow_updating_tpu_torch import Engine, RoundConfig
    from flow_updating_tpu_torch.plan import compile_topology, select
    from flow_updating_tpu_torch.plan.select import PlanDecision

    os.environ["FLOW_UPDATING_AUTOTUNE_CACHE"] = os.path.join(
        tmp, f"{name}.json")
    t0 = time.perf_counter()
    plan_only = compile_topology(topo, min_fill=float(np.clip(
        3.0 / select.GATHER_COST["cuda"], 1.0 / 64.0, 0.75)))
    plan_s = time.perf_counter() - t0
    probes0 = select.PROBE_COUNT
    t0 = time.perf_counter()
    eng = Engine(config=RoundConfig.fast(), plan="auto").set_topology(topo)
    eng.build()
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    decision = eng.plan_decision
    rep = eng.plan_report()
    tune = rep.get("autotune") or {}
    if tune.get("cache") != "miss" or not tune.get("probes_run"):
        raise AssertionError(f"L2 {name}: the cold build ran no probes "
                             f"({tune})")
    probes_run = select.PROBE_COUNT - probes0
    t0 = time.perf_counter()
    again = Engine(config=RoundConfig.fast(), plan="auto").set_topology(topo)
    again.build()
    warm_s = time.perf_counter() - t0
    tune2 = again.plan_report().get("autotune") or {}
    if tune2.get("probes_run") != 0 or tune2.get("cache") != "hit" \
            or select.PROBE_COUNT != probes0 + probes_run:
        raise AssertionError(f"L2 {name}: the second build missed the "
                             f"cache ({tune2})")
    del again
    chosen = f"{decision.kernel}/{decision.spmv or 'gather'}"
    eng.run_rounds(WARMUP)
    ms = _timed_rounds(eng, L_ROUNDS)
    dev_ms = device_ms(lambda: eng.run_rounds(1))
    # the candidates' rounds are host-bound at 1 M nodes, so each is
    # timed L_REPS times, interleaved with the others in a rotating
    # order, and its median counts (a slow stretch of the host hits every
    # candidate alike)
    engines = {}
    for cand, make in _candidate_engines(topo, decision).items():
        engines[cand] = make().set_topology(topo).build()
        engines[cand].run_rounds(WARMUP)
    reps = {cand: [] for cand in engines}
    order = list(engines.items())
    for i in range(L_REPS):
        k = i % len(order)
        for cand, e in order[k:] + order[:k]:
            reps[cand].append(_timed_rounds(e, L_ROUNDS) / L_ROUNDS)
    measured = {cand: {"ms_per_round": float(np.median(v)),
                       "ms_per_round_reps": v,
                       "spmv": engines[cand].config.spmv}
                for cand, v in reps.items()}
    del engines
    rates = {c: 1e3 / v["ms_per_round"] for c, v in measured.items()}
    fastest = max(rates, key=rates.get)
    chosen_rate = rates[chosen]
    margin = 1.0 - chosen_rate / rates[fastest]
    if chosen_rate < rates[fastest] * (1.0 - PLAN_MARGIN):
        raise AssertionError(
            f"L2 {name}: plan='auto' chose {chosen} at {chosen_rate:.4g} "
            f"r/s, {100 * margin:.1f}% slower than {fastest} at "
            f"{rates[fastest]:.4g} r/s")
    # float64: the chosen route against spmv='xla' after 40 rounds
    f64 = RoundConfig.fast(dtype="float64")
    mine = Engine(config=f64, plan=PlanDecision(
        kernel=decision.kernel, spmv=decision.spmv, plan=decision.plan,
        backend="cuda", predicted={}, reason="L2 float64",
        fused=decision.fused)).set_topology(topo).build()
    ref = Engine(config=RoundConfig.fast(kernel="node", spmv="xla",
                                         dtype="float64"))
    ref.set_topology(topo).build()
    mine.run_rounds(L_F64_ROUNDS)
    ref.run_rounds(L_F64_ROUNDS)
    diff = float(np.abs(mine.estimates() - ref.estimates()).max())
    if not diff <= L_F64_TOL:
        raise AssertionError(f"L2 {name}: float64 {chosen} is {diff} off "
                             "spmv='xla'")
    del mine, ref
    out = {"nodes": topo.num_nodes, "edges": topo.num_edges,
           "plan_s": plan_s, "band_lanes": len(plan_only.spmv.offsets),
           "remainder_edges": int(plan_only.spmv.remainder_edges),
           "decision": chosen, "reason": rep["reason"],
           "predicted_cost": rep["predicted_cost"],
           "probes_run": probes_run,
           "probed_rounds_per_s": tune.get("candidates"),
           "autotune_best": tune.get("best"),
           "cold_build_s": cold_s, "cached_build_s": warm_s,
           "cached_probes_run": 0,
           "chosen_ms_per_round": ms / L_ROUNDS,
           "chosen_device_ms_per_round": dev_ms,
           "candidates_ms_per_round": measured,
           "fastest": fastest, "chosen_margin": margin,
           "float64_max_abs_diff_to_xla": diff,
           "plan": decision.plan if decision.plan is not None else None,
           "manifest": _plan_manifest(eng)}
    del eng
    return out


def phase_path_l2(ring_topo, ba, tmp) -> dict:
    import dataclasses

    # path B's ring as an arbitrary graph: with its generator's descriptor
    # plan='auto' takes the stencil and never races the banded family
    plain_ring = dataclasses.replace(ring_topo, structure=None)
    return {"ring": _plan_graph("ring", plain_ring, tmp),
            "barabasi_albert": _plan_graph("ba", ba, tmp)}


def _mixing_pair(topo, plan, tmp, name) -> dict:
    from flow_updating_tpu_torch.obs.spectral import mixing_report

    path = os.path.join(tmp, f"mix_{name}.json")
    t0 = time.perf_counter()
    cold = mixing_report(topo, plan=plan, cache_path=path)
    cold_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    hit = mixing_report(topo, plan=plan, cache_path=path)
    hit_s = time.perf_counter() - t0
    again = mixing_report(topo, plan=plan,
                          cache_path=os.path.join(tmp, f"mix2_{name}.json"))
    if cold["cache"]["hit"] or not hit["cache"]["hit"] \
            or hit["structural"] != cold["structural"] \
            or hit["measured"] != cold["measured"]:
        raise AssertionError(f"L3 {name}: the second call was no cache hit")
    if again["structural"] != cold["structural"] \
            or again["measured"] != cold["measured"]:
        raise AssertionError(f"L3 {name}: two cold calls differ")
    gaps = [cold["gap"], cold["structural"]["gap"], cold["measured"]["gap"]]
    if not all(0.0 < g <= 1.0 for g in gaps):
        raise AssertionError(f"L3 {name}: a gap outside (0, 1]: {gaps}")
    return {"family": cold["family"], "gap": cold["gap"],
            "provenance": cold["provenance"],
            "structural": cold["structural"], "measured": cold["measured"],
            "predicted_rounds_to_1e-6": cold["predicted_rounds"],
            "cold_s": cold_s, "cached_s": hit_s, "cold_calls_equal": True}


def phase_path_l3(tree, ring_plan, plain_ring, tmp) -> dict:
    return {"fat_tree": _mixing_pair(tree, None, tmp, "tree"),
            "ring_banded": _mixing_pair(plain_ring, ring_plan, tmp, "ring")}


def phase_path_l4(engine_f) -> dict:
    from flow_updating_tpu_torch.plan.select import select_halo_mode

    plan = engine_f._halo_plan
    got = select_halo_mode(plan, mesh=engine_f.mesh, dtype_bytes=4)
    bytes_only = select_halo_mode(plan, backend="cuda", dtype_bytes=4)
    if got["halo"] != "ppermute" or not got.get("one_device"):
        raise AssertionError(f"L4: halo='auto' on one card chose "
                             f"{got['halo']}")
    return {"chosen": got["halo"], "reason": got["reason"],
            "wire_hide_fraction": got["wire_hide_fraction"],
            "byte_ranking_choice": bytes_only["halo"],
            "byte_ranking_hide_fraction": bytes_only["hide_fraction"],
            "predicted_effective_bytes": got["predicted_effective_bytes"]}


def phase_path_l5(engine_d, engine_a, engine_f, j3_telemetry) -> tuple:
    """L5: telemetry at full width on paths D, A and F (J3's ran inside
    path J, where its engine lives), the halo series against the
    single-device series on the renumbered topology, and run_streamed on
    path D.  Returns the record, that single-device engine, in step with
    path F (path M compares their fields), and the four series' run
    manifests (path N judges them)."""
    import numpy as np

    from flow_updating_tpu_torch import Engine
    from flow_updating_tpu_torch.obs.telemetry import TelemetrySpec

    out = {"path_d": telemetry_check(engine_d, EDGE_ROUNDS),
           "path_a": telemetry_check(engine_a, ROUNDS),
           "path_f": telemetry_check(engine_f, TELEMETRY_ROUNDS),
           "path_j3": j3_telemetry}
    manifests = {name: rec.pop("manifest") for name, rec in out.items()}
    # the halo series against the single-device round on the plan's
    # renumbered topology, from path F's state (reached again from SEED)
    plan, t_f = engine_f._halo_plan, int(engine_f.state.t)
    single = Engine(config=engine_f.config).set_topology(plan.topo)
    single.build(seed=SEED).run_rounds(t_f)
    if not np.array_equal(engine_f.estimates()[plan.order],
                          single.estimates()):
        raise AssertionError("L5: path F's state is not the renumbered "
                             "single-device run's")
    spec = TelemetrySpec.full().for_kernel("halo")
    halo = engine_f.run_telemetry(TELEMETRY_ROUNDS, spec)
    one = single.run_telemetry(TELEMETRY_ROUNDS, spec)
    worst = 0.0
    for m in halo.metrics:
        a, b = np.asarray(halo[m], np.float64), np.asarray(one[m],
                                                           np.float64)
        if np.issubdtype(np.asarray(halo[m]).dtype, np.integer):
            if not np.array_equal(a, b):
                raise AssertionError(f"L5: halo series {m} differs from "
                                     "the single device's")
            continue
        # the residual is a difference of masses: it is held on the
        # masses' scale, every other series on its own
        scale = float(np.max(np.abs(np.asarray(
            one["mass"] if m == "mass_residual" else one[m], np.float64))))
        rel = float(np.max(np.abs(a - b))) / max(scale, 1e-30)
        worst = max(worst, rel)
        if not rel <= L_SERIES_RTOL:
            raise AssertionError(f"L5: halo series {m} is {rel} (of its "
                                 "scale) off the single device's")
    out["halo_vs_single_device"] = {"rounds": TELEMETRY_ROUNDS,
                                    "max_rel_diff": worst,
                                    "rtol": L_SERIES_RTOL,
                                    "counters_equal": True}
    seen = []
    engine_d.run_streamed(10 * OBS, observe_every=OBS, emit=seen.append)
    if len(seen) != 10:
        raise AssertionError(f"L5: run_streamed emitted {len(seen)} "
                             "samples, expected 10")
    out["path_d_streamed"] = {"samples": len(seen), "last": seen[-1]}
    return out, single, manifests


def phase_path_l(tree, ring_topo, engine_a, engine_d, engine_f,
                 j3_telemetry) -> tuple:
    """Path L: L0 the gather ratio, L1 plan='auto' on the fat tree, L2
    plan='auto' with probes on the ring and the BA graph, L3 the mixing
    probe, L4 select_halo_mode on path F's plan, L5 telemetry.  Returns
    the record, L5's single-device twin of path F, and the plan manifests
    of L1 and L2 and the run manifests of L5 by name (path N judges
    them)."""
    import tempfile

    import torch

    from flow_updating_tpu_torch.topology.generators import barabasi_albert

    t0 = time.perf_counter()
    ba = barabasi_albert(BA_N, BA_M, seed=SEED)
    ba_s = time.perf_counter() - t0
    out = {"ba_topology_s": ba_s}
    saved = os.environ.get("FLOW_UPDATING_AUTOTUNE_CACHE")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_plan_") as tmp:
        try:
            out["l0"] = phase_path_l0(tree, ba)
            emit({"phase": "path_l", "part": "l0", **out["l0"]})
            out["l1"] = phase_path_l1(tree)
            manifests = {"plan_l1_fat_tree": out["l1"].pop("manifest")}
            emit({"phase": "path_l", "part": "l1", **out["l1"]})
            out["l2"] = phase_path_l2(ring_topo, ba, tmp)
            ring_plan = out["l2"]["ring"].pop("plan")
            out["l2"]["barabasi_albert"].pop("plan")
            for graph in ("ring", "barabasi_albert"):
                manifests[f"plan_l2_{graph}"] = out["l2"][graph].pop(
                    "manifest")
            emit({"phase": "path_l", "part": "l2", **out["l2"]})
            import dataclasses

            out["l3"] = phase_path_l3(
                tree, ring_plan, dataclasses.replace(ring_topo,
                                                     structure=None), tmp)
            emit({"phase": "path_l", "part": "l3", **out["l3"]})
        finally:
            if saved is None:
                os.environ.pop("FLOW_UPDATING_AUTOTUNE_CACHE", None)
            else:
                os.environ["FLOW_UPDATING_AUTOTUNE_CACHE"] = saved
    del ba
    out["l4"] = phase_path_l4(engine_f)
    emit({"phase": "path_l", "part": "l4", **out["l4"]})
    out["l5"], f_single, runs = phase_path_l5(engine_d, engine_a, engine_f,
                                              j3_telemetry)
    manifests.update({f"run_{name}": man for name, man in runs.items()})
    emit({"phase": "path_l", "part": "l5", **out["l5"]})
    torch.cuda.synchronize()
    return out, f_single, manifests


# ---- path M: per-node and per-edge fields at full width -------------------

def _raw_fields(engine, rounds: int, spec):
    """The engine's field runner as ``Engine.run_fields`` dispatches it,
    its rows left on the card: ``(state, conv, series)``."""
    from flow_updating_tpu_torch.models import rounds as edge_rounds
    from flow_updating_tpu_torch.parallel import sharded

    kind = engine._kernel_kind
    spec = spec.for_kernel(kind)
    if kind == "halo":
        return sharded.run_rounds_sharded_fields(
            engine.state, engine._halo_plan, engine.config, engine.mesh,
            rounds, spec, engine.topology.true_mean,
            arrays=engine._halo_arrays, halo=engine._halo_wire)
    if kind == "edge":
        return edge_rounds.run_rounds_fields(
            engine.state, engine._topo_arrays, engine.config, rounds, spec,
            engine.topology.true_mean)
    return engine._node_kernel.run_fields(engine.state, rounds, spec)


def _card_tensors(x) -> list:
    """Every CUDA tensor in a nest of dicts, lists and tuples."""
    import torch

    if isinstance(x, torch.Tensor):
        return [x] if x.is_cuda else []
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _card_tensors(v)]
    return []


def _device_ms_per_round(fn, rounds: int, stride: int = 1) -> float:
    """Device ms a round of ``fn`` (``rounds`` rounds) from one
    ``torch.profiler`` trace of the CUDA activity alone (a trace of the
    host's ops too costs seconds to reduce on a launch-heavy path), every
    CUDA-side event summed; dropped events are made up for per chunk of
    ``stride`` rounds (:func:`_device_rows`: a field runner samples once a
    chunk).  A trace with no device time is taken again with the host's
    activity on."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    units = rounds // stride
    for acts in ([ProfilerActivity.CUDA],
                 [ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        us = sum(us for _, us, _ in _device_rows(prof, units))
        if us > 0:
            return us / 1e3 / stride
    raise AssertionError("M: the profiler saw no device time")


def _fields_run(engine, rounds: int, spec) -> tuple:
    """One run of the field runner from the engine's state, timed by CUDA
    events, then the bulk copy of its rows timed apart."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    state, conv, series = _raw_fields(engine, rounds, spec)
    end.record()
    torch.cuda.synchronize()
    rows = _card_tensors((conv, series))
    t0 = time.perf_counter()
    for t in rows:
        t.cpu()
    copy_s = time.perf_counter() - t0
    return {"rows": rounds // spec.stride,
            "ms_per_round": start.elapsed_time(end) / rounds,
            "recorded_bytes": sum(t.numel() * t.element_size()
                                  for t in rows),
            "copy_ms": copy_s * 1e3}, state


def _against_telemetry(series, tel) -> dict:
    """A field series' reductions (``FieldSeries.reduced_series``, on the
    host in float64) against the telemetry series of the same rounds from
    the same state, at the recorded rounds: t and active exactly, the
    float series within ``L_SERIES_RTOL`` of each one's largest value
    (the residual on the masses' scale)."""
    import numpy as np

    red = series.reduced_series()
    at = [int(np.flatnonzero(tel.t == t)[0]) for t in series.t]
    if not np.array_equal(np.asarray(red["active"]),
                          tel["active"][at]):
        raise AssertionError("M: the fields' active counts differ from "
                             "the telemetry's")
    worst = {}
    for m in ("rmse", "max_abs_err", "mass", "mass_residual"):
        got = np.asarray(red[m], np.float64)
        want = np.asarray(tel[m], np.float64)[at]
        if got.ndim < want.ndim:
            want = want.sum(axis=tuple(range(1, want.ndim)))
        scale = float(np.max(np.abs(np.asarray(
            tel["mass" if m == "mass_residual" else m], np.float64))))
        worst[m] = float(np.max(np.abs(got - want))) / max(scale, 1e-30)
        if not worst[m] <= L_SERIES_RTOL:
            raise AssertionError(f"M: the fields' {m} is {worst[m]} (of its "
                                 "scale) off the telemetry series")
    return {"rows": len(series), "max_rel_diff": worst,
            "rtol": L_SERIES_RTOL, "active_equal": True}


def _field_manifest(engine, series) -> dict:
    """The manifest ``inspect --report`` writes for ``series`` (path N
    judges it)."""
    from flow_updating_tpu_torch.obs.report import build_field_manifest

    report = engine.convergence_report()
    report["true_mean"] = engine.topology.true_mean
    report["nodes"] = engine.topology.num_nodes
    return build_field_manifest(config=engine.config, topo=engine.topology,
                                fields=series, report=report,
                                device=engine.device)


def fields_check(engine, rounds: int, strides=(1, M_STRIDE),
                 full: bool = False, manifest: bool = False) -> dict:
    """M on one engine: ``rounds`` plain rounds timed, then from the same
    state the field runner with the default fields at each stride (and
    ``FieldSpec.full()`` at stride 1 when ``full``): its state
    ``torch.equal`` to the plain run's, the recorded bytes, the bulk
    copy's time, ms a round by CUDA events, and for the default fields no
    host read in the loop and device ms a round by the profiler beside the
    plain round's; then
    ``Engine.run_fields`` with the default fields reduced against
    ``run_telemetry`` from the same state; with ``manifest``, the field
    manifest of the default fields in eight rows (under the record's
    ``manifest``, popped before it is printed).  The engine ends where it
    began."""
    from flow_updating_tpu_torch.obs.fields import FieldSpec
    from flow_updating_tpu_torch.obs.telemetry import TelemetrySpec

    s0, clock0 = engine.state, engine.clock

    def reset():
        engine.state, engine._clock = s0, clock0

    plain_ms = _timed_rounds(engine, rounds) / rounds
    plain = engine.state
    reset()
    out = {"kernel": engine._kernel_kind, "rounds": rounds,
           "plain_ms_per_round": plain_ms,
           "plain_device_ms_per_round": _device_ms_per_round(
               lambda: engine.run_rounds(rounds), rounds)}
    reset()
    runs = [(f"default_stride{s}", FieldSpec.default(stride=s), s)
            for s in strides]
    if full:
        runs.append(("full_stride1", FieldSpec.full(), 1))
    for name, spec, stride in runs:
        rec, state = _fields_run(engine, rounds, spec)
        if not _same_state(state, plain):
            raise AssertionError(f"M {out['kernel']} {name}: the state "
                                 "after the field runner differs from the "
                                 "state after run_rounds")
        del state
        rec["overhead"] = rec["ms_per_round"] / plain_ms - 1.0
        rec["state_equal"] = True
        out[name] = rec
        if name.startswith("full"):
            continue
        # the profiled run also counts the host reads: the counting mode
        # adds Python to every op, so it stays out of the timed run
        with _host_reads_mode() as reads:
            rec["device_ms_per_round"] = _device_ms_per_round(
                lambda spec=spec: _raw_fields(engine, rounds, spec),
                rounds, stride)
        rec["host_reads_in_loop"] = reads.scalars + reads.copies
        if rec["host_reads_in_loop"]:
            raise AssertionError(f"M {out['kernel']} {name}: "
                                 f"{rec['host_reads_in_loop']} host reads "
                                 "inside the loop")
        rec["device_overhead"] = (rec["device_ms_per_round"]
                                  / out["plain_device_ms_per_round"] - 1.0)
    series = engine.run_fields(rounds, FieldSpec.default(stride=strides[0]))
    out["engine_field_timings"] = dict(engine.field_timings)
    if not _same_state(engine.state, plain):
        raise AssertionError(f"M {out['kernel']}: the state after "
                             "Engine.run_fields differs from run_rounds'")
    reset()
    tel = engine.run_telemetry(rounds, TelemetrySpec.default())
    reset()
    out["vs_telemetry"] = _against_telemetry(series, tel)
    if manifest:
        # eight rows: doctor's stall check judges no shorter series
        kept = engine.run_fields(rounds, FieldSpec.default(
            stride=max(1, rounds // 8)))
        out["manifest"] = _field_manifest(engine, kept)
        reset()
    return out


def _frontier_mismatch(conv, ref, tol, slack) -> int:
    """Entries of the frontier ``conv`` that differ from the series
    ``ref``'s at nodes whose pooled error in ``ref`` never came within
    ``slack`` of ``tol`` (a float32 rounding may put a node on either side
    there)."""
    import numpy as np

    near = np.any(np.abs(ref.pooled("node_err") - tol) <= slack, axis=0)
    return int(np.sum((conv != ref.conv_round) & ~near))


def _f_vs_single(engine_f, single) -> dict:
    """F's fields against those of ``single``, the single-device edge
    round on the plan's renumbered topology in step with F (L5's twin):
    ``FieldSpec.full()`` at stride 2; t, active, node_fired and
    edge_stale exactly, the float fields within ``L_SERIES_RTOL`` of each
    one's largest value, the frontier equal away from the tolerance."""
    import numpy as np

    from flow_updating_tpu_torch.obs.fields import FieldSpec
    from flow_updating_tpu_torch.parallel import sharded

    s0, clock0 = engine_f.state, engine_f.clock
    plan = engine_f._halo_plan
    if not np.array_equal(engine_f.estimates()[plan.order],
                          single.estimates()):
        raise AssertionError("M: path F's state is not the renumbered "
                             "single-device run's")
    spec = FieldSpec.full(stride=2)
    a = engine_f.run_fields(M_HALO_ROUNDS, spec)
    b = single.run_fields(M_HALO_ROUNDS, spec)
    engine_f.state, engine_f._clock = s0, clock0
    e_map = sharded._edge_map_to_original(plan, engine_f.topology)
    if not (np.array_equal(a.t, b.t) and np.array_equal(a.active,
                                                        b.active)):
        raise AssertionError("M: F's t or active differ from the single "
                             "device's")
    worst = {}
    pairs = [(n, a.node[n][:, plan.order], b.node[n]) for n in b.node]
    pairs += [(n, a.edge[n], b.edge[n][:, e_map]) for n in b.edge]
    for name, x, y in pairs:
        if np.issubdtype(y.dtype, np.integer):
            if not np.array_equal(x, y):
                raise AssertionError(f"M: F's {name} differs from the "
                                     "single device's")
            continue
        scale = float(np.max(np.abs(y))) if y.size else 0.0
        worst[name] = float(np.max(np.abs(x.astype(np.float64) - y)))
        worst[name] /= max(scale, 1e-30)
        if not worst[name] <= L_SERIES_RTOL:
            raise AssertionError(f"M: F's {name} is {worst[name]} (of its "
                                 "scale) off the single device's")
    slack = 8 * float(np.finfo(np.float32).eps) * float(
        np.abs(plan.topo.values).max())
    bad = _frontier_mismatch(a.conv_round[plan.order], b, spec.tol, slack)
    if bad:
        raise AssertionError(f"M: {bad} frontier entries of F differ from "
                             "the single device's away from the tolerance")
    return {"rounds": M_HALO_ROUNDS, "stride": 2,
            "fields": list(a.fields), "max_rel_diff": worst,
            "rtol": L_SERIES_RTOL, "integers_equal": True,
            "frontier_mismatches_away_from_tol": 0}


def _a_topk(engine_a) -> dict:
    """A's ``topk_idx`` (kernel layout, straight from the runner) against
    a stable ranking, on the host, of the full ``node_err`` row the same
    runner records from the same state."""
    import numpy as np

    from flow_updating_tpu_torch.obs.fields import FieldSpec

    k, s0 = engine_a._node_kernel, engine_a.state
    _, _, top = k.run_fields(s0, M_ROUNDS, FieldSpec.parse(
        "node_err", stride=M_STRIDE, topk=M_TOPK))
    _, _, rows = k.run_fields(s0, M_ROUNDS, FieldSpec.parse(
        "node_err", stride=M_STRIDE))
    idx = top["topk_idx"].cpu().numpy()
    mag = rows["node_err"].abs().cpu().numpy()
    for i in range(mag.shape[0]):
        want = np.argsort(-mag[i], kind="stable")[:M_TOPK]
        if not np.array_equal(idx[i], want):
            raise AssertionError(f"M: A's topk_idx row {i} is {idx[i]}, the "
                                 f"host's stable ranking {want}")
    if not np.array_equal(top["node_err"].cpu().numpy(),
                          np.take_along_axis(rows["node_err"].cpu().numpy(),
                                             idx.astype(np.int64), 1)):
        raise AssertionError("M: A's ranked node_err rows are not the full "
                             "rows' entries")
    return {"rows": int(idx.shape[0]), "topk": M_TOPK,
            "equal_to_stable_host_ranking": True,
            "original_ids_last_row": k.original_node_ids(idx[-1]).tolist()}


def _d_leak(engine_d) -> dict:
    """``blame`` on a flow of ``M_LEAK`` planted on one switch-to-switch
    edge of path D's fat tree, run in fast pairwise mode on D's segment
    networks (B3, B4), as the JAX package's own leak test plants it: the
    direct exchange adds exactly antisymmetric increments, so the pair's
    residual stays the plant while the plant's deficit mixes away, and
    the pair ranks first in the leak blame.  (Under D's faithful round a
    plant heals once the next message crosses; failing the link keeps it,
    but then the planted end averages only at its timeout, and between
    its firings its error climbs back to 5-90% of the plant, so blame's
    in-flight allowance of twice the largest error covers the pair in
    part of every timeout cycle.)  The record's ``manifest`` (the run's
    field manifest, its masses recorded too, for path N) is popped before
    it is printed."""
    import numpy as np

    from flow_updating_tpu_torch import Engine, RoundConfig
    from flow_updating_tpu_torch.obs.fields import FieldSpec
    from flow_updating_tpu_torch.obs.inspect import blame

    topo = engine_d.topology
    pw = Engine(config=RoundConfig.fast(
        "pairwise", segment_impl=engine_d.config.segment_impl))
    pw.set_topology(topo).build(seed=SEED)
    pw.run_rounds(M_LEAK_WARMUP)
    deg = np.asarray(topo.out_deg)
    inner = np.flatnonzero((deg[topo.src] > 1) & (deg[topo.dst] > 1))
    leak = int(inner[len(inner) // 3])
    u, v = int(topo.src[leak]), int(topo.dst[leak])
    flow = pw.state.flow.clone()
    flow[leak] += M_LEAK
    pw.state = pw.state.replace(flow=flow)
    t0 = time.perf_counter()
    pw.run_rounds(M_LEAK_SETTLE)
    series = pw.run_fields(M_LEAK_ROUNDS, FieldSpec.parse(
        "node_err,node_mass,node_mass_residual,edge_flow", stride=M_STRIDE))
    run_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    verdict = blame(series)
    blame_s = time.perf_counter() - t0
    manifest = _field_manifest(pw, series)
    del pw
    top = (verdict["leak"] or [None])[0]
    if top is None or {top["edge"], top["rev"]} != {leak,
                                                    int(topo.rev[leak])}:
        raise AssertionError(f"M: blame did not rank the planted leak edge "
                             f"{leak} first: {verdict['leak']}")
    return {"edge": leak, "rev": int(topo.rev[leak]), "link": [u, v],
            "mode": "fast pairwise", "planted": M_LEAK,
            "warmup_rounds": M_LEAK_WARMUP, "settle_rounds": M_LEAK_SETTLE,
            "rounds": M_LEAK_ROUNDS,
            "stride": M_STRIDE, "top": top,
            "culprits": len(verdict["leak"]),
            "max_final_err": float(np.max(series.pooled("node_err")[-1])),
            "run_s": run_s, "blame_s": blame_s, "manifest": manifest}


def phase_path_m(engine_a, engine_b, engine_c, engine_d, engine_f,
                 f_single) -> dict:
    """Path M: the field runners on paths A (K1), B (K2), C (B3), D (B3,
    B4) and F (B6) at full width (J3's ran inside path J): the state equal
    to ``run_rounds``', no host read in the loop, ms a round against the
    plain round, the recorded bytes and the copy, the reductions against
    telemetry; F against the single-device round on its renumbered
    topology, A's ranking against the host's, a leak planted on D's tree
    (fast pairwise, D's networks) named by ``blame``.  Returns the record
    and the field manifests of A and of the leak by name (path N judges
    them)."""
    out, manifests = {}, {}
    for name, eng, rounds, full in (("path_a", engine_a, M_ROUNDS, False),
                                    ("path_b", engine_b, M_ROUNDS, False),
                                    ("path_c", engine_c, M_ROUNDS, False),
                                    ("path_d", engine_d, M_EDGE_ROUNDS,
                                     True),
                                    ("path_f", engine_f, M_HALO_ROUNDS,
                                     True)):
        out[name] = fields_check(eng, rounds, full=full,
                                 manifest=name == "path_a")
        if name == "path_a":
            manifests["fields_path_a"] = out[name].pop("manifest")
        emit({"phase": "path_m", "part": name, **out[name]})
    out["f_vs_single_device"] = _f_vs_single(engine_f, f_single)
    out["a_topk"] = _a_topk(engine_a)
    out["d_leak"] = _d_leak(engine_d)
    manifests["fields_d_leak"] = out["d_leak"].pop("manifest")
    return out, manifests


# ---- path N: doctor, live through the entry point and on saved manifests ---

#: the doctor's four series checks; antisymmetry is judged only where the
#: series records it (the edge-ledger kernels: JAX's rule)
SERIES_CHECKS = ("nan_divergence", "rmse_stall", "mass_conservation",
                 "antisymmetry")


def _doctor_cli(argv) -> tuple:
    """``flow_updating_tpu_torch.cli.main(["doctor", *argv])`` in this
    process: its exit code and the verdict JSON it prints."""
    return _cli_json(["doctor", *argv])


def _statuses(checks) -> dict:
    return {c["name"]: c["status"] for c in checks}


def _live_doctor(argv, kernel: str) -> dict:
    """One live ``doctor`` run on the card through the CLI: exit code 0,
    no ``fail``, environment and final report judged, the series checks
    judged wherever the series records their metric, the environment
    naming the card."""
    t0 = time.perf_counter()
    rc, doc = _doctor_cli(argv)
    wall = time.perf_counter() - t0
    st = _statuses(doc["checks"])
    if rc != 0 or "fail" in st.values():
        raise AssertionError(f"N1 {kernel}: doctor exited {rc}: {doc}")
    judged = [*SERIES_CHECKS[:3], "environment", "final_report"]
    if kernel == "edge":
        judged.append("antisymmetry")
    elif st.get("antisymmetry") != "skip":
        raise AssertionError(f"N1 {kernel}: antisymmetry judged on a kernel "
                             "that records no antisymmetry series")
    skipped = [name for name in judged if st.get(name, "skip") == "skip"]
    if skipped:
        raise AssertionError(f"N1 {kernel}: {skipped} skipped: {doc}")
    env = {c["name"]: c for c in doc["checks"]}["environment"]["evidence"]
    if env.get("backend") != "cuda":
        raise AssertionError(f"N1 {kernel}: the environment is {env}")
    final = {c["name"]: c for c in doc["checks"]}["rmse_stall"]["evidence"]
    return {"argv": argv, "rc": rc, "overall": doc["overall"],
            "statuses": st, "final_rmse": final.get("final_rmse"),
            "environment": env, "wall_s": wall}


def phase_path_n1() -> dict:
    """N1: the live ``doctor`` through ``cli.main`` on the full fat tree
    k=160: the node kernel through K1 (K1 launched at least once a round)
    and the edge kernel's plain round (whose flows make the antisymmetry
    series)."""
    from flow_updating_tpu_torch.ops.spmv import neighbor_sum_ell

    tree = ["--generator", f"fat_tree:{FAT_TREE_K}", "--fire-policy",
            "every_round", "--rounds", str(N_ROUNDS)]
    k1 = neighbor_sum_ell.launches
    node = _live_doctor([*tree, "--kernel", "node", "--spmv", "pallas"],
                        "node")
    node["k1_launches"] = neighbor_sum_ell.launches - k1
    if node["k1_launches"] < N_ROUNDS:
        raise AssertionError(f"N1: K1 launched {node['k1_launches']} times "
                             f"in {N_ROUNDS} rounds")
    return {"node": node, "edge": _live_doctor(tree, "edge")}


def _judge(name, manifest) -> list:
    """``health.diagnose_manifest`` on one manifest; a check that raises
    fails the phase."""
    from flow_updating_tpu_torch.obs import health

    try:
        return health.diagnose_manifest(manifest)
    except Exception as err:
        raise AssertionError(f"N2: doctor raised on {name}: "
                             f"{type(err).__name__}: {err}") from err


def phase_path_n2(manifests: dict, tmp) -> dict:
    """N2: the manifests paths L and M built at full width — the run
    manifests of L5's telemetry on A, D, F and J3, the plan manifests of
    L1 and L2, the field manifests of A and of the planted leak — judged
    by ``health.diagnose_manifest`` and, the run and plan manifests
    written to ``tmp``, by one ``doctor`` call through the CLI (the field
    manifests hold tens of millions of values: they are judged in
    memory).  The series checks of every run manifest are judged (the
    antisymmetry wherever its series is recorded); D's manifest with its
    last ten rmse rows set to NaN exits 1 with ``nan_divergence`` at
    ``fail``.  Every verdict is recorded, a ``fail`` included."""
    import copy

    from flow_updating_tpu_torch.obs import health
    from flow_updating_tpu_torch.obs.report import write_report

    out, paths = {}, {}
    for name, man in manifests.items():
        if name.startswith("fields_"):
            checks = _judge(name, man)
        else:
            paths[name] = os.path.join(tmp, f"{name}.json")
            write_report(paths[name], man)
            with open(paths[name]) as f:
                checks = _judge(name, json.load(f))
        st = {c.name: c.status for c in checks}
        if name.startswith("run_"):
            metrics = man["telemetry"]["metrics"]
            skipped = [c for c in SERIES_CHECKS if st.get(c) == "skip"
                       and (c != "antisymmetry" or c in metrics)]
            if skipped:
                raise AssertionError(f"N2 {name}: {skipped} skipped")
        out[name] = {"overall": health.overall(checks), "statuses": st}
        if name == "fields_d_leak":
            out[name]["mass_conservation"] = next(
                c.to_jsonable() for c in checks
                if c.name == "mass_conservation")
    rc, doc = _doctor_cli(list(paths.values()))
    by_source = {}
    for c in doc["checks"]:
        by_source.setdefault(c["evidence"]["source"], {})[c["name"]] = \
            c["status"]
    for name, path in paths.items():
        if by_source.get(path) != out[name]["statuses"]:
            raise AssertionError(f"N2 {name}: the CLI's verdicts "
                                 f"{by_source.get(path)} differ from "
                                 f"diagnose_manifest's")
    poisoned = copy.deepcopy(manifests["run_path_d"])
    rows = poisoned["telemetry"]["series"]["rmse"]
    rows[-10:] = [float("nan")] * 10
    bad = os.path.join(tmp, "run_path_d_poisoned.json")
    write_report(bad, poisoned)
    prc, pdoc = _doctor_cli([bad])
    nan = _statuses(pdoc["checks"]).get("nan_divergence")
    if prc != 1 or nan != "fail":
        raise AssertionError(f"N2: the poisoned D manifest exited {prc} "
                             f"with nan_divergence {nan}")
    return {"manifests": out, "cli_rc": rc, "cli_overall": doc["overall"],
            "cli_checks": len(doc["checks"]),
            "poisoned_d": {"rc": prc, "nan_divergence": nan,
                           "evidence": {c["name"]: c for c in
                                        pdoc["checks"]}[
                                            "nan_divergence"]["evidence"]}}


# ---- path O: the sweep engine and the scenarios on the card -------------

class _BucketRounds:
    """A sweep bucket behind ``run_rounds(n)``, so the engine timers and
    :func:`profile_rounds` drive its rounds."""

    def __init__(self, bucket, cfg):
        self.bucket, self.cfg, self.state = bucket, cfg, bucket.states

    def run_rounds(self, n: int):
        from flow_updating_tpu_torch.models.rounds import round_step

        for _ in range(n):
            self.state = round_step(self.state, self.bucket.arrays,
                                    self.cfg, self.bucket.params)
        return self


def _cli_json(argv) -> tuple:
    """``flow_updating_tpu_torch.cli.main(argv)`` in this process: its exit
    code and the JSON it prints last."""
    import contextlib
    import io

    from flow_updating_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(list(argv))
    return rc, json.loads(buf.getvalue().strip().splitlines()[-1])


def _o_grid(variant: str, seeds: int) -> tuple:
    """Path O's grid (``O_GENERATOR`` x seeds x ``O_DROPS`` x
    ``O_TIMEOUTS``), as the ``sweep`` subcommand builds it: ``(cfg,
    topology, instances)``."""
    from flow_updating_tpu_torch import RoundConfig
    from flow_updating_tpu_torch.sweep import grid_instances
    from flow_updating_tpu_torch.topology.generators import (
        topology_from_spec,
    )

    topo = topology_from_spec(O_GENERATOR, seed=SEED)
    cfg = RoundConfig.reference(variant, dtype="float32")
    insts = grid_instances(
        [(O_GENERATOR, topo)], seeds=[SEED + i for i in range(seeds)],
        drop_rates=[float(d) for d in O_DROPS.split(",")],
        timeouts=[int(t) for t in O_TIMEOUTS.split(",")])
    return cfg, topo, insts


def phase_path_o1(tmp) -> tuple:
    """O1: ``cli.main(["sweep", ...])`` on the card over the 128-lane grid
    (one bucket of 1.31 M node and 7.34 M edge slots), its manifest
    judged by ``doctor`` (no ``fail``) and its peak memory above what the
    earlier paths hold; then the same bucket packed again and timed: ms a
    bucket round by CUDA events, device ms, busy share and launches a
    round by the profiler, lane-rounds a second, and one lane's instance
    alone through ``Engine`` beside it."""
    import torch

    from flow_updating_tpu_torch import Engine
    from flow_updating_tpu_torch.obs import health
    from flow_updating_tpu_torch.sweep import pack_instances

    path = os.path.join(tmp, "sweep.json")
    argv = ["sweep", "--generator", O_GENERATOR, "--seeds", str(O_SEEDS),
            "--drop-rates", O_DROPS, "--timeouts", O_TIMEOUTS, "--rounds",
            str(O_ROUNDS), "--fire-policy", "reference", "--report", path]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()      # the earlier paths' tensors
    t0 = time.perf_counter()
    rc, out = _cli_json(argv)
    cli_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - held
    lanes = O_SEEDS * 16
    if rc != 0 or out["instances"] != lanes or len(out["buckets"]) != 1 \
            or out["buckets"][0]["size"] != lanes:
        raise AssertionError(f"O1: sweep exited {rc}: {out}")
    with open(path) as f:
        man = json.load(f)
    checks = health.diagnose_manifest(man)
    st = {c.name: c.status for c in checks}
    if "fail" in st.values() or man["environment"]["backend"] != "cuda":
        raise AssertionError(f"O1: doctor on the sweep manifest: {st}")
    converged = out["converged"]

    cfg, topo, insts = _o_grid("collectall", O_SEEDS)
    t0 = time.perf_counter()
    bucket = pack_instances(insts, cfg)[0]
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    runner = _BucketRounds(bucket, cfg)
    timed = _timed_path(runner, O_TIMED_ROUNDS)
    prof = _device_summary(runner)
    alone = Engine(config=cfg).set_topology(topo).build(seed=SEED)
    one = _timed_path(alone, O_TIMED_ROUNDS)
    del runner, alone
    report = {
        "argv": argv, "rc": rc, "cli_s": cli_s,
        "lanes": lanes, "bucket_shape": out["buckets"][0]["shape"],
        "node_slots": lanes * bucket.shape[0],
        "edge_slots": lanes * bucket.shape[1],
        "row_width": int(bucket.arrays.sweep_edge_rows.shape[1]),
        "compiled_programs": out["compiled_programs"],
        "converged": converged, "median_exit_round":
            out["median_exit_round"],
        "sweep_pack_s": out["timings"]["pack_s"],
        "sweep_run_s": out["timings"]["run_s"],
        "sweep_ms_per_round_with_telemetry":
            out["timings"]["run_s"] * 1e3 / O_ROUNDS,
        "peak_memory_bytes": peak, "memory_held_before_bytes": held,
        "doctor": {"overall": health.overall(checks), "statuses": st},
        "pack_s": pack_s,
        "ms_per_bucket_round": timed["ms_per_round"],
        "lane_rounds_per_s": lanes * timed["rounds_per_s"],
        **{f"bucket_{k}": v for k, v in prof.items()},
        "one_lane_alone": {"ms_per_round": one["ms_per_round"],
                           "rounds_per_s": one["rounds_per_s"]},
        "batching_speedup": lanes * one["ms_per_round"]
        / timed["ms_per_round"]}
    return report, bucket, (cfg, topo, insts)


def _lane_checks(bucket, cfg, topo, insts, lanes) -> dict:
    """Lanes of ``bucket`` after ``O_CHECK_ROUNDS`` rounds against the same
    instance packed alone (every leaf bit for bit; the key too where the
    lane draws its losses alone as well) and against the unpadded
    instance through ``run_rounds(params=)`` (recorded: bit for bit where
    the card's CSR row sums add as the row fold does)."""
    import torch

    from flow_updating_tpu_torch.models.rounds import run_rounds
    from flow_updating_tpu_torch.models.state import init_state, lane_state
    from flow_updating_tpu_torch.sweep import pack_instances, run_bucket

    N, E = topo.num_nodes, topo.num_edges
    out = run_bucket(bucket, cfg, O_CHECK_ROUNDS)
    arrays = topo.device_arrays(coloring=cfg.needs_coloring,
                                device="cuda")
    rows = {}
    for lane in lanes:
        inst = insts[lane]
        got = lane_state(out, lane, bucket.size)
        alone = lane_state(run_bucket(pack_instances([inst], cfg)[0], cfg,
                                      O_CHECK_ROUNDS), 0, 1)
        bad = _edge_leaves_equal(got, alone, N, E)
        draws_alone = bool(inst.drop_rate)
        if not draws_alone:
            # a bucket of one loss-free lane leaves the draw out, so its
            # key stays where the 128-lane bucket's advanced
            bad = [f for f in bad if f != "key"]
        if bad:
            raise AssertionError(f"O2: lane {lane} differs from its B = 1 "
                                 f"packing in {bad}")
        single = run_rounds(init_state(topo, cfg, seed=inst.seed),
                            arrays, cfg, O_CHECK_ROUNDS,
                            params=inst.params(cfg))
        diff = _edge_leaves_equal(got, single, N, E)
        gap = max((float((getattr(got, f)[:E] - getattr(single, f)[:E])
                         .abs().max()) for f in ("flow", "est")),
                  default=0.0)
        if not (gap <= EDGE_TWIN_ATOL):
            raise AssertionError(f"O2: lane {lane} is {gap} from its "
                                 "unpadded run")
        rows[str(lane)] = {"tag": inst.tag, "equal_to_alone": True,
                           "key_compared": draws_alone,
                           "unpadded_leaves_differing": diff,
                           "unpadded_max_abs_diff": gap}
    del out
    torch.cuda.empty_cache()
    return rows


def phase_path_o2(bucket, grid) -> dict:
    """O2: lanes of O1's bucket and of a 32-lane faithful pairwise grid
    (its affine scans run lane by lane) after ``O_CHECK_ROUNDS`` rounds,
    each against B = 1 and the unpadded run."""
    from flow_updating_tpu_torch.sweep import pack_instances

    cfg, topo, insts = grid
    out = {"rounds": O_CHECK_ROUNDS,
           "collectall": _lane_checks(bucket, cfg, topo, insts, O_LANES)}
    pcfg, ptopo, pinsts = _o_grid("pairwise", O_PAIRWISE_SEEDS)
    pbucket = pack_instances(pinsts, pcfg)[0]
    if pbucket.size != 32:
        raise AssertionError(f"O2: the pairwise grid packed "
                             f"{pbucket.size} lanes")
    out["pairwise"] = _lane_checks(pbucket, pcfg, ptopo, pinsts,
                                   O_PAIRWISE_LANES)
    return out


def phase_path_o3(tmp) -> dict:
    """O3: ``cli.main(["scenarios", ...])`` on the card over the whole
    sweep-grid registry (rc 0, ``pass``, one bucket structure a
    scenario), the wall seconds of each scenario, and the two negative
    controls (rc 1, ``fail``)."""
    from flow_updating_tpu_torch.scenarios import registry
    from flow_updating_tpu_torch.scenarios import run as scn_run

    walls = {}
    plain = scn_run.run_scenario

    def timed(scn, *args, **kw):
        t0 = time.perf_counter()
        rec = plain(scn, *args, **kw)
        walls[scn.name] = time.perf_counter() - t0
        return rec

    scn_run.run_scenario = timed
    try:
        rc, doc = _cli_json(["scenarios", "--seeds", str(O_SCENARIO_SEEDS),
                             "--report", os.path.join(tmp, "scn.json")])
    finally:
        scn_run.run_scenario = plain
    n = len(registry.REGISTRY)
    if rc != 0 or doc["overall"] != "pass" or doc["sweep_compiles"] != n:
        raise AssertionError(f"O3: scenarios exited {rc}: overall "
                             f"{doc['overall']}, {doc['sweep_compiles']} "
                             f"structures for {n} scenarios")
    out = {"rc": rc, "overall": doc["overall"], "scenarios": n,
           "checks": len(doc["checks"]),
           "sweep_compiles": doc["sweep_compiles"],
           "wall_s": doc["wall_s"], "wall_s_by_scenario": walls,
           "perturbed": {}}
    for name, perturb in (("byzantine_lie", "remove_adversary"),
                          ("partition_heal", "no_heal")):
        t0 = time.perf_counter()
        prc, pdoc = _cli_json(["scenarios", name, "--seeds",
                               str(O_SCENARIO_SEEDS), "--perturb", perturb])
        if prc != 1 or pdoc["overall"] != "fail":
            raise AssertionError(f"O3: {name} --perturb {perturb} exited "
                                 f"{prc} with {pdoc['overall']}")
        out["perturbed"][name] = {
            "perturb": perturb, "rc": prc, "overall": pdoc["overall"],
            "failing": sorted(c["name"] for c in pdoc["checks"]
                              if c["status"] == "fail"),
            "wall_s": time.perf_counter() - t0}
    return out


def _o4_adversary(tree):
    """Faults whose first effects show right after the timeout bootstrap:
    two edge switches lie and one is silent (their hosts, of degree 1,
    fire as soon as they hear their one neighbor, or never before the
    next timeout), and two switch-to-host edges carry a scaled wire flow."""
    import numpy as np

    from flow_updating_tpu_torch.scenarios import Adversary

    hosts = np.flatnonzero(tree.out_deg == 1)
    switch = tree.dst[tree.row_start[hosts]]        # each host's switch
    picks = [int(h) for h in hosts[np.linspace(0, len(hosts) - 1, 5)
                                   .astype(int)]]
    wires = tree.rev[tree.row_start[picks[3:]]]      # switch -> host edges
    return Adversary(
        lie_nodes=tuple(int(switch[np.searchsorted(hosts, h)])
                        for h in picks[:2]), lie_value=5.0,
        silent_nodes=(int(switch[np.searchsorted(hosts, picks[2])]),),
        corrupt_edges=tuple(int(e) for e in wires), corrupt_gain=1.5)


def phase_path_o4(tree) -> dict:
    """O4: ``Engine(adversary=)`` on path D's configuration (the k=160 fat
    tree, faithful collect-all, ``benes_fused`` segments and delivery:
    kernels B3 and B4 broadcast the lie and silent masks): after the
    timeout bootstrap, ``O4_ROUNDS`` rounds with the B3/B4 counts from 0,
    held bit for bit to its ``segment``/``gather`` twin, and away from the
    honest round."""
    import dataclasses

    import torch

    from flow_updating_tpu_torch import Engine, RoundConfig

    adv = _o4_adversary(tree)
    cfg = RoundConfig.reference("collectall", segment_impl="benes_fused",
                                delivery="benes_fused")
    t0 = time.perf_counter()
    eng = Engine(config=cfg, adversary=adv).set_topology(tree).build(
        seed=SEED)
    build_s = time.perf_counter() - t0
    eng.run_rounds(EDGE_BOOT)
    per_round = planned_launches(eng._topo_arrays, cfg, adversary=adv)
    reset_counts()
    ms = _timed_rounds(eng, O4_ROUNDS)
    got = {**b3_launches(), **b4_launches()}
    if got != {k: v * O4_ROUNDS for k, v in per_round.items()}:
        raise AssertionError(f"O4 launches {got}, planned {per_round} per "
                             f"round x {O4_ROUNDS}")
    mine = _edge_estimates(eng)
    flow = eng.state.flow
    rounds_ = EDGE_BOOT + O4_ROUNDS
    tcfg = dataclasses.replace(cfg, segment_impl="segment",
                               delivery="gather")
    twin = Engine(config=tcfg, adversary=adv).set_topology(tree).build(
        seed=SEED)
    twin.run_rounds(rounds_)
    diff = float((mine - _edge_estimates(twin)).abs().max())
    if diff != 0.0 or not torch.equal(flow, twin.state.flow):
        raise AssertionError(f"O4 differs from its segment/gather twin at "
                             f"round {rounds_} (estimates max {diff})")
    del twin
    honest = Engine(config=tcfg).set_topology(tree).build(seed=SEED)
    honest.run_rounds(rounds_)
    away = float((mine - _edge_estimates(honest)).abs().max())
    if not away > 0.0:
        raise AssertionError("O4 equals the honest round")
    del honest, eng
    torch.cuda.empty_cache()
    return {"config": {k: getattr(cfg, k) for k in (
                "variant", "fire_policy", "segment_impl", "delivery",
                "dtype")},
            "adversary": adv.describe(), "build_s": build_s,
            "after_round": EDGE_BOOT, "rounds_timed": O4_ROUNDS,
            "ms_per_round": ms / O4_ROUNDS,
            "launches_per_round": per_round,
            "b3_launches": {k: got[k] for k, _, _, _ in B3_FLAVOURS},
            "b4_launches": {k: got[k] for k, _, _ in B4_FLAVOURS},
            "max_abs_diff_to_segment": diff, "flow_equal_to_segment": True,
            "max_abs_diff_to_honest": away}


# ---- path P: the streaming service on the card -------------------------

def _p_script(n: int, epochs: int, rounds: int, seed: int, *, joins: int,
              updates: int, leaves: int, suspends: int, removes: int,
              reads: bool = True) -> list:
    """A seeded ``serve`` event script, one list of lines an epoch: at
    each boundary the previous epoch's suspended members resume,
    ``leaves`` of the oldest joiners leave (from the second epoch),
    ``joins`` members join, each wired by two ``add-edge``s to initial
    members never picked before, ``updates`` initial members take new
    values, ``suspends`` initial members are suspended and ``removes`` of
    this epoch's joiners drop their first edge; then ``run`` and (with
    ``reads``) an ``estimates 16`` read.  The slots a join takes are the
    service's (lowest free id first), simulated here."""
    import heapq

    import numpy as np

    rng = np.random.default_rng(seed)
    ends = iter(rng.permutation(n)[: epochs * joins * 2].tolist())
    free = list(range(n, n + epochs * joins))
    joiners, suspended, out = [], [], []
    for epoch in range(epochs):
        lines = [f"resume {i}" for i in suspended]
        if epoch:
            for j in joiners[:leaves]:
                lines.append(f"leave {j}")
                heapq.heappush(free, j)
            joiners = joiners[leaves:]
        fresh = []
        for _ in range(joins):
            j = heapq.heappop(free)
            a, b = next(ends), next(ends)
            lines += [f"join {rng.uniform(-1, 1)!r}", f"add-edge {j} {a}",
                      f"add-edge {j} {b}"]
            fresh.append((j, a))
        joiners += [j for j, _ in fresh]
        for i in rng.choice(n, updates, replace=False).tolist():
            lines.append(f"update {i} {rng.uniform(-1, 1)!r}")
        suspended = rng.choice(n, suspends, replace=False).tolist()
        lines += [f"suspend {i}" for i in suspended]
        lines += [f"remove-edge {j} {a}" for j, a in fresh[:removes]]
        lines.append(f"run {rounds}")
        if reads:
            lines.append("estimates 16")
        out.append(lines)
    return out


def _p_events(script) -> int:
    """Membership and edge events in a list of script lines."""
    return sum(1 for line in script
               if line.split()[0] not in ("run", "estimates", "checkpoint"))


def _p_verdict(report: str) -> dict:
    """``doctor`` through the CLI on a saved manifest: exit code and every
    check's status."""
    rc, out = _cli_json(["doctor", report])
    return {"rc": rc, "overall": out["overall"],
            "checks": {c["name"]: c["status"] for c in out["checks"]}}


def phase_path_p1(tmp) -> tuple:
    """P1: ``cli.main(["serve", ...])`` on the card over ``ring:RING_N:2``
    at capacity ``P_CAPACITY``, degree budget 6, segments of 32 rounds,
    float32 fast collect-all, through ``P_EPOCHS`` epochs of the seeded
    churn script (a checkpoint after epoch ``P_CKPT_EPOCH``), with
    ``--report``, ``--metrics`` and a checkpoint at exit; the summary's
    ``compile_count`` 1 and ``doctor``'s whole verdict on the manifest
    (its four service checks ``pass``)."""
    import contextlib
    import io

    from flow_updating_tpu_torch import cli

    epochs = _p_script(RING_N, P_EPOCHS, P_SEGMENT, SEED, joins=P_JOINS,
                       updates=P_UPDATES, leaves=P_LEAVES,
                       suspends=P_SUSPENDS, removes=P_REMOVES)
    mid = os.path.join(tmp, "p1_mid.npz")
    end = os.path.join(tmp, "p1_end.npz")
    epochs[P_CKPT_EPOCH - 1].append(f"checkpoint {mid}")
    events = os.path.join(tmp, "p1_events.txt")
    with open(events, "w") as f:
        f.write("\n".join(line for ep in epochs for line in ep) + "\n")
    report = os.path.join(tmp, "p1.json")
    metrics = os.path.join(tmp, "p1.prom")
    argv = ["serve", "--generator", f"ring:{RING_N}:2",
            "--capacity", str(P_CAPACITY), "--degree-budget",
            str(P_BUDGET), "--segment-rounds", str(P_SEGMENT),
            "--dtype", "float32", "--events", events, "--report", report,
            "--metrics", metrics, "--checkpoint", end]
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    serve_s = time.perf_counter() - t0
    lines = [json.loads(x) for x in buf.getvalue().strip().splitlines()]
    summary, reads = lines[-1], lines[:-1]
    if rc != 0 or summary["compile_count"] != 1:
        raise AssertionError(f"P1: serve exited {rc}: {summary}")
    if len(reads) != P_EPOCHS:
        raise AssertionError(f"P1: {len(reads)} estimates reads")
    t0 = time.perf_counter()
    verdict = _p_verdict(report)
    doctor_s = time.perf_counter() - t0
    for name in ("service_compile", "service_capacity", "service_mass",
                 "service_churn_recovery"):
        if verdict["checks"].get(name) != "pass":
            raise AssertionError(f"P1: doctor {name}: {verdict}")
    with open(report) as f:
        manifest = json.load(f)
    block = manifest["service"]
    with open(metrics) as f:
        prom = f.read()
    out = {"topology": f"ring:{RING_N}:2", "capacity": P_CAPACITY,
           "edge_capacity": block["capacity"]["edges"],
           "epochs": P_EPOCHS, "rounds": summary["t"],
           "events": summary["events"], "event_counts": block[
               "event_counts"], "compile_count": summary["compile_count"],
           "live": summary["live"], "members": summary["members"],
           "rmse": summary["rmse"],
           "mass_residual": summary["mass_residual"],
           "reads": len(reads), "serve_s": serve_s,
           "setup_s": manifest["timings"]["setup_s"],
           "checkpoint_save_s": manifest["timings"]["checkpoint_s"],
           "doctor": verdict, "doctor_s": doctor_s,
           "mirror_probe": block["mirror_probe"],
           "metrics_lines": len(prom.splitlines()),
           "archive_bytes": {"mid": os.path.getsize(mid),
                             "end": os.path.getsize(end)}}
    return out, (epochs, mid, end)


def phase_path_p2(ring_topo) -> dict:
    """P2: a service at P1's size with no events, 64 rounds, every leaf
    ``torch.equal`` to ``run_rounds(params=)`` from the same state on the
    same arrays (the same row matrix), and within ``EDGE_TWIN_ATOL`` of
    the padded arrays without rows (the card's CSR ``segment_reduce``;
    integer and bool leaves equal).  Then the measurements: ms a segment
    by CUDA events under churn (one epoch of P1's script a segment,
    boundary samples included) against the same arrays with no events
    (``churn_overhead_pct``), device ms a round, busy share and launches
    a round by the profiler, one boundary sample's ms (and of the copy of
    ``flow`` to the host it holds) and events a second on the host."""
    import dataclasses
    import statistics

    import torch

    from flow_updating_tpu_torch import cli
    from flow_updating_tpu_torch.models.rounds import run_rounds
    from flow_updating_tpu_torch.models.state import FlowUpdatingState
    from flow_updating_tpu_torch.service import ServiceEngine
    from flow_updating_tpu_torch.topology.padding import pad_topology_to
    from torch.profiler import ProfilerActivity, profile

    def clone(st):
        return FlowUpdatingState(**{f.name: getattr(st, f.name).clone()
                                    for f in dataclasses.fields(st)})

    t0 = time.perf_counter()
    svc = ServiceEngine(ring_topo, P_CAPACITY, degree_budget=P_BUDGET,
                        segment_rounds=P_SEGMENT, seed=SEED)
    build_s = time.perf_counter() - t0
    cfg, params = svc.config, svc.params
    start = clone(svc.state)
    ref = run_rounds(clone(start), svc.arrays, cfg, P2_ROUNDS,
                     params=params)
    svc.run(P2_ROUNDS)
    unequal = [f.name for f in dataclasses.fields(ref)
               if not torch.equal(getattr(ref, f.name),
                                  getattr(svc.state, f.name))]
    if unequal or svc.compile_count != 1:
        raise AssertionError(f"P2: leaves {unequal} differ from the plain "
                             f"rounds ({svc.compile_count} signatures)")
    padded = pad_topology_to(ring_topo, P_CAPACITY + 1, svc.edge_capacity,
                             spread="last")
    csr = run_rounds(clone(start), padded.device_arrays(), cfg, P2_ROUNDS,
                     params=params)
    del padded
    diff, int_equal = 0.0, True
    for f in dataclasses.fields(csr):
        a, b = getattr(csr, f.name), getattr(svc.state, f.name)
        if a.is_floating_point():
            diff = max(diff, float((a - b).abs().max()))
        else:
            int_equal &= bool(torch.equal(a, b))
    if diff > EDGE_TWIN_ATOL or not int_equal:
        raise AssertionError(f"P2: the CSR twin is {diff} away "
                             f"(integer leaves equal: {int_equal})")
    del csr, ref

    # ms a segment: the same arrays with no events, then under churn
    epochs = _p_script(RING_N, P_TIMED_SEGMENTS + 1, P_SEGMENT, SEED + 1,
                       joins=P_JOINS, updates=P_UPDATES, leaves=P_LEAVES,
                       suspends=P_SUSPENDS, removes=P_REMOVES,
                       reads=False)
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    st = clone(svc.state)
    st = run_rounds(st, svc.arrays, cfg, P_SEGMENT, params=params)
    torch.cuda.synchronize()
    ev0.record()
    for _ in range(P_TIMED_SEGMENTS):
        st = run_rounds(st, svc.arrays, cfg, P_SEGMENT, params=params)
    ev1.record()
    torch.cuda.synchronize()
    static_ms = ev0.elapsed_time(ev1) / P_TIMED_SEGMENTS
    del st
    joined = []

    def apply(lines):
        for line in lines:
            for _, verb, a in cli._parse_service_events([line]):
                cli._apply_service_event(svc, verb, a, joined)

    apply(epochs[0])                              # warm the event path
    torch.cuda.synchronize()
    host_s, n_events = [], 0
    ev0.record()
    for lines in epochs[1:]:
        t1 = time.perf_counter()
        apply(lines[:-1])
        torch.cuda.synchronize()
        host_s.append(time.perf_counter() - t1)
        n_events += _p_events(lines)
        apply(lines[-1:])
    ev1.record()
    torch.cuda.synchronize()
    churn_ms = ev0.elapsed_time(ev1) / P_TIMED_SEGMENTS
    if svc.compile_count != 1:
        raise AssertionError(f"P2: {svc.compile_count} signatures")

    # device time of a segment under the profiler
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        svc.state = run_rounds(svc.state, svc.arrays, cfg, P_SEGMENT,
                               params=params)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t1) * 1e6
    device = _device_rows(prof, P_SEGMENT)
    busy_us = sum(us for _, us, _ in device)

    sample_ms, flow_ms = [], []
    for _ in range(5):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        svc._sample("probe")
        sample_ms.append((time.perf_counter() - t1) * 1e3)
        t1 = time.perf_counter()
        svc.state.flow.cpu()          # the one copy a sample's residual reads
        flow_ms.append((time.perf_counter() - t1) * 1e3)
    return {"rounds": P2_ROUNDS, "build_s": build_s,
            "equal_to_plain_rows": True,
            "csr_twin_max_abs_diff": diff, "csr_twin_int_equal": int_equal,
            "segment_rounds": P_SEGMENT,
            "timed_segments": P_TIMED_SEGMENTS,
            "static_ms_per_segment": static_ms,
            "churn_ms_per_segment": churn_ms,
            "churn_overhead_pct": 100.0 * (churn_ms / static_ms - 1.0),
            "events_per_segment": n_events / P_TIMED_SEGMENTS,
            "host_events_per_s": n_events / sum(host_s),
            "device_ms_per_round": busy_us / 1e3,
            "wall_ms_per_round": wall_us / P_SEGMENT / 1e3,
            "busy_share": busy_us * P_SEGMENT / wall_us,
            "launches_per_round": sum(c for _, _, c in device),
            "top": [{"kernel": k[:80], "ms_per_round": us / 1e3,
                     "calls_per_round": c}
                    for k, us, c in sorted(device, key=lambda r: -r[1])[:5]],
            "boundary_sample_ms": statistics.median(sample_ms),
            "flow_copy_ms": statistics.median(flow_ms),
            "flow_bytes": svc.state.flow.numel()
            * svc.state.flow.element_size(),
            "compile_count": svc.compile_count}


def phase_path_p3(p1_files) -> dict:
    """P3: P1's epoch-``P_CKPT_EPOCH`` archive restored on a new engine,
    the script's later epochs applied to it: its ``state_digest`` equals
    P1's end state (the archive P1 wrote at exit)."""
    import torch

    from flow_updating_tpu_torch import cli
    from flow_updating_tpu_torch.service import ServiceEngine

    epochs, mid, end = p1_files
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    svc = ServiceEngine.restore_checkpoint(mid)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    joined = []
    t0 = time.perf_counter()
    lines = [ln for ep in epochs[P_CKPT_EPOCH:] for ln in ep
             if not ln.startswith("estimates")]
    for _, verb, a in cli._parse_service_events(lines):
        cli._apply_service_event(svc, verb, a, joined)
    torch.cuda.synchronize()
    replay_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    end_svc = ServiceEngine.restore_checkpoint(end)
    torch.cuda.synchronize()
    end_restore_s = time.perf_counter() - t0
    want, got = end_svc.state_digest(), svc.state_digest()
    if got != want or svc.compile_count != 1:
        raise AssertionError(f"P3: digest {got} != {want} "
                             f"({svc.compile_count} signatures)")
    return {"restored_epoch": P_CKPT_EPOCH, "restore_s": restore_s,
            "end_restore_s": end_restore_s,
            "archive_bytes": os.path.getsize(mid),
            "epochs_applied": P_EPOCHS - P_CKPT_EPOCH,
            "apply_s": replay_s, "digest_equal": True, "digest": got,
            "compile_count": svc.compile_count}


def phase_path_p4(tmp) -> dict:
    """P4: a child process runs ``serve --wal DIR --checkpoint-every 2`` on
    ``ring:P4_N:2`` with churn and message loss and is killed with SIGKILL
    once ``scan_wal`` reads ``P4_KILL_RECORDS`` records; ``serve --wal DIR
    --recover`` finishes the script from the record after the journal's
    last.  Its end state's digest equals an uninterrupted control's,
    ``doctor`` gives ``check_recovery`` ``pass`` on the recovery manifest
    (control digests as its ``verify`` block) and ``blame_recovery``
    names the kill."""
    import signal
    import subprocess

    from flow_updating_tpu_torch.obs.inspect import blame_recovery
    from flow_updating_tpu_torch.obs.report import (
        build_recovery_manifest,
        write_report,
    )
    from flow_updating_tpu_torch.resilience.wal import scan_wal
    from flow_updating_tpu_torch.service import ServiceEngine

    script = [ln for ep in _p_script(
        P4_N, P4_EPOCHS, 2 * P4_SEGMENT, SEED + 2, joins=8, updates=8,
        leaves=4, suspends=2, removes=2, reads=False) for ln in ep]
    full = os.path.join(tmp, "p4_events.txt")
    with open(full, "w") as f:
        f.write("\n".join(script) + "\n")
    base = ["serve", "--generator", f"ring:{P4_N}:2", "--capacity",
            str(P4_CAPACITY), "--degree-budget", "6", "--segment-rounds",
            str(P4_SEGMENT), "--drop-rate", str(P4_DROP), "--dtype",
            "float32"]
    wal_dir = os.path.join(tmp, "p4_wal")
    wal_log = os.path.join(wal_dir, "wal.log")
    env = {**os.environ, "PYTHONPATH": ROOT}
    t0 = time.perf_counter()
    child = subprocess.Popen(
        [sys.executable, "-m", "flow_updating_tpu_torch", *base,
         "--events", full, "--wal", wal_dir, "--checkpoint-every", "2"],
        cwd=ROOT, env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE)
    seen = 0
    try:
        while child.poll() is None and time.perf_counter() - t0 < 120:
            if os.path.exists(wal_log):
                try:
                    seen = len(scan_wal(wal_log)[0])
                except ValueError:
                    seen = 0
                if seen >= P4_KILL_RECORDS:
                    child.send_signal(signal.SIGKILL)
                    break
            time.sleep(0.01)
    finally:
        if child.poll() is None and seen < P4_KILL_RECORDS:
            child.kill()
        rc = child.wait()
        err = child.stderr.read().decode(errors="replace")
        child.stderr.close()
    child_s = time.perf_counter() - t0
    if rc != -signal.SIGKILL or seen < P4_KILL_RECORDS:
        raise AssertionError(f"P4: the child exited {rc} before the kill "
                             f"({seen} records): {err[-2000:]}")
    records, torn = scan_wal(wal_log)
    last = int(records[-1]["seq"]) if records else 0
    rest = os.path.join(tmp, "p4_rest.txt")
    with open(rest, "w") as f:
        f.write("\n".join(script[last:]) + "\n")

    ctrl_end = os.path.join(tmp, "p4_ctrl.npz")
    t0 = time.perf_counter()
    rc, _ = _cli_json(base + ["--events", full, "--checkpoint", ctrl_end])
    ctrl_s = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"P4: the control exited {rc}")
    rec_end = os.path.join(tmp, "p4_rec.npz")
    report = os.path.join(tmp, "p4.json")
    t0 = time.perf_counter()
    rc, out = _cli_json(["serve", "--wal", wal_dir, "--recover",
                         "--events", rest, "--report", report,
                         "--checkpoint", rec_end])
    recover_call_s = time.perf_counter() - t0
    if rc != 0 or not out["durability"]["recovered"]:
        raise AssertionError(f"P4: the recovery exited {rc}: {out}")
    with open(report) as f:
        manifest = json.load(f)
    recovery = manifest["recovery"]
    want = ServiceEngine.restore_checkpoint(ctrl_end).state_digest()
    got = ServiceEngine.restore_checkpoint(rec_end).state_digest()
    recovery["verify"] = {"exact": got == want, "recovered_digest": got,
                          "control_digest": want}
    path = os.path.join(tmp, "p4_recovery.json")
    write_report(path, build_recovery_manifest(
        recovery=recovery, service=manifest["service"],
        extra={"config": manifest["config"],
               "serving_trace": manifest.get("serving_trace")}))
    verdict = _p_verdict(path)
    blame = blame_recovery({"recovery": recovery})
    if got != want:
        raise AssertionError(f"P4: recovered digest {got} != control "
                             f"{want}")
    for name in ("wal_replay_exact", "ring_integrity"):
        if verdict["checks"].get(name) != "pass":
            raise AssertionError(f"P4: doctor {name}: {verdict}")
    if blame["top"] not in ("kill_at_segment", "kill_mid_checkpoint",
                            "truncate_wal_tail"):
        raise AssertionError(f"P4: blame names {blame}")
    fsync = (manifest.get("serving_trace") or {}).get("metrics", {}) \
        .get("histograms", {}).get("wal_fsync_seconds") or {}
    return {"topology": f"ring:{P4_N}:2", "capacity": P4_CAPACITY,
            "drop_rate": P4_DROP, "script_records": len(script),
            "killed_at_records": seen, "wal_records": len(records),
            "torn_bytes": torn, "child_s": child_s,
            "replay": recovery["replay"],
            "ring_used": recovery["ring"]["used"],
            "recover_s": manifest["timings"]["setup_s"],
            "recover_call_s": recover_call_s, "control_s": ctrl_s,
            "digest_equal": True, "doctor": verdict,
            "blame_top": blame["top"],
            "wal_fsync_s_per_record": (fsync["sum"] / fsync["count"]
                                       if fsync.get("count") else None),
            "wal_fsync_records": fsync.get("count")}


# ---- path Q: the query and aggregate fabric on the card ------------------

def _q_cohort_queries(rng, members, n: int) -> list:
    """``n`` random-cohort mean queries of 8-63 members (the acceptance
    script's draw): ``(values, sorted cohort)`` pairs."""
    import numpy as np

    out = []
    for _ in range(n):
        m = int(rng.integers(8, 64))
        cohort = rng.choice(members, size=m, replace=False)
        out.append((rng.random(m), np.sort(cohort)))
    return out


def phase_path_q1(tmp) -> dict:
    """Q1: ``cli.main(["query", ...])`` on the card at the acceptance size
    (``erdos_renyi:Q_NODES:6``, capacity ``Q_CAPACITY``, degree budget
    ``Q_BUDGET``, ``Q_LANES`` lanes, segments of ``Q_SEGMENT`` rounds,
    eps ``Q_EPS``, ``Q_QUERIES`` queries of ``Q_COHORT`` members arriving
    Poisson(``Q_LANES / 2``) a boundary, float32) with ``--report`` and
    ``--metrics``: ``compile_count`` 1, at least one lane recycled, every
    offered query retired, ``doctor``'s four query checks ``pass``."""
    import torch

    report = os.path.join(tmp, "q1.json")
    metrics = os.path.join(tmp, "q1.prom")
    argv = ["query", "--generator", f"erdos_renyi:{Q_NODES}:6",
            "--seed", str(SEED), "--capacity", str(Q_CAPACITY),
            "--degree-budget", str(Q_BUDGET), "--lanes", str(Q_LANES),
            "--segment-rounds", str(Q_SEGMENT),
            "--queries", str(Q_QUERIES),
            "--arrival-rate", str(Q_LANES / 2 / Q_SEGMENT),
            "--cohort-frac", repr(Q_COHORT / Q_NODES),
            "--eps", repr(Q_EPS), "--rounds", str(Q_ROUNDS),
            "--dtype", "float32", "--report", report, "--metrics", metrics]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rc, summary = _cli_json(argv)
    query_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    if rc != 0 or summary["compile_count"] != 1:
        raise AssertionError(f"Q1: query exited {rc}: {summary}")
    if summary["completed"] != Q_QUERIES or summary["submitted"] \
            != Q_QUERIES or summary["active"] or summary["queued"]:
        raise AssertionError(f"Q1: not every query retired: {summary}")
    with open(report) as f:
        manifest = json.load(f)
    block = manifest["query"]
    lanes_used = {q["lane"] for q in block["queries"]}
    recycled = Q_QUERIES - len(lanes_used)
    if recycled < 1:
        raise AssertionError("Q1: no lane was recycled")
    free_resid = max(b["max_resid_free"] for b in block["boundaries"])
    t0 = time.perf_counter()
    verdict = _p_verdict(report)
    doctor_s = time.perf_counter() - t0
    for name in ("query_compile", "query_lanes", "query_lane_mass",
                 "query_admission"):
        if verdict["checks"].get(name) != "pass":
            raise AssertionError(f"Q1: doctor {name}: {verdict}")
    with open(metrics) as f:
        prom = f.read()
    wall_s = manifest["timings"]["wall_s"]
    segments = summary["t"] // Q_SEGMENT
    return {"topology": f"erdos_renyi:{Q_NODES}:6",
            "capacity": Q_CAPACITY, "lanes": Q_LANES,
            "edge_capacity": block["service"]["capacity"]["edges"],
            "degree_budget": Q_BUDGET, "segment_rounds": Q_SEGMENT,
            "eps": Q_EPS, "queries": Q_QUERIES, "cohort": Q_COHORT,
            "rounds": summary["t"], "segments": segments,
            "completed": summary["completed"],
            "compile_count": summary["compile_count"],
            "lanes_used": len(lanes_used), "recycled_admissions": recycled,
            "peak_active": block["lanes"]["peak_active"],
            "admission_latency": block["admission_latency"],
            "convergence_latency": block["convergence_latency"],
            "max_resid_free": free_resid,
            "query_s": query_s, "setup_s": manifest["timings"]["setup_s"],
            "stream_wall_s": wall_s,
            "ms_per_segment": 1e3 * wall_s / segments,
            "queries_retired_per_s": summary["completed"] / wall_s,
            "peak_memory_bytes": peak,
            "doctor": verdict, "doctor_s": doctor_s,
            "metrics_lines": len(prom.splitlines())}


def phase_path_q2() -> dict:
    """Q2: a fabric at Q1's size with ``Q2_DROP`` loss: busy lanes admitted,
    then a target query (never retiring) into lane L and into a one-query
    fabric of the same capacity and seed, both driven through the same
    join/add-edge/leave churn; after ``Q2_SEGMENTS`` segments lane L of
    every lane plane is ``torch.equal`` to the isolated lane, the shared
    control planes are equal, and every boundary's free lanes carry a
    residual of exactly 0.0.  Then the measurements: ms a segment (CUDA
    events, the boundary included), the lane probe's ms, and device ms,
    busy share and launches a round by the profiler."""
    import statistics

    import numpy as np
    import torch

    from flow_updating_tpu_torch.models.config import RoundConfig
    from flow_updating_tpu_torch.models.rounds import run_rounds
    from flow_updating_tpu_torch.query import QueryFabric
    from flow_updating_tpu_torch.query.fabric import LANE_PLANES
    from flow_updating_tpu_torch.topology.generators import erdos_renyi
    from torch.profiler import ProfilerActivity, profile

    topo = erdos_renyi(Q_NODES, avg_degree=6, seed=SEED)
    cfg = RoundConfig.fast(variant="collectall", drop_rate=Q2_DROP)
    kw = dict(capacity=Q_CAPACITY, degree_budget=Q_BUDGET, config=cfg,
              segment_rounds=Q_SEGMENT, seed=SEED, conv_eps=Q_EPS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    busy = QueryFabric(topo, lanes=Q_LANES, **kw)
    build_s = time.perf_counter() - t0
    iso = QueryFabric(topo, lanes=1, **kw)
    rng = np.random.default_rng(SEED + 3)
    members = np.arange(Q_NODES)
    for vals, cohort in _q_cohort_queries(rng, members, Q_LANES // 2):
        busy.submit(vals, cohort=cohort)
    for f in (busy, iso):
        f.run(Q_SEGMENT)
    t_vals, t_cohort = _q_cohort_queries(rng, members, 1)[0]
    lane = busy._queries[busy.submit(t_vals, cohort=t_cohort,
                                     eps=1e-30)]["lane"]
    iso.submit(t_vals, cohort=t_cohort, eps=1e-30)
    held = []
    for seg in range(Q2_SEGMENTS):
        for vals, cohort in _q_cohort_queries(rng, members,
                                              Q_LANES // 4):
            busy.submit(vals, cohort=cohort)
        ends = rng.choice(members, size=2, replace=False).tolist()
        for f in (busy, iso):
            j = f.join()
            f.add_edges([(j, ends[0]), (j, ends[1])])
        held.append(j)
        if seg % 2:
            for f in (busy, iso):
                f.leave([held[0]])
            held.pop(0)
        for f in (busy, iso):
            f.run(Q_SEGMENT)
    unequal = [n for n in LANE_PLANES
               if not torch.equal(getattr(busy.svc.state, n)[..., lane],
                                  getattr(iso.svc.state, n)[..., 0])]
    unequal += [n for n in ("t", "key", "alive", "edge_ok", "ticks",
                            "fired", "recv", "stamp", "pending_valid",
                            "buf_valid")
                if not torch.equal(getattr(busy.svc.state, n),
                                   getattr(iso.svc.state, n))]
    if unequal:
        raise AssertionError(f"Q2: lane {lane} differs from the isolated "
                             f"fabric in {unequal}")
    free_resid = [b["max_resid_free"] for b in busy._boundaries]
    if any(r != 0.0 for r in free_resid):
        raise AssertionError(f"Q2: free-lane residuals {free_resid}")
    if busy.retired_total < 1 or busy.compile_count != 1:
        raise AssertionError(f"Q2: {busy.retired_total} retired, "
                             f"{busy.compile_count} signatures")
    retired = busy.retired_total
    del iso

    # the measurements, on the busy fabric
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    ev0.record()
    for _ in range(Q2_TIMED_SEGMENTS):
        busy.run(Q_SEGMENT)
    ev1.record()
    torch.cuda.synchronize()
    seg_ms = ev0.elapsed_time(ev1) / Q2_TIMED_SEGMENTS
    probe_ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        busy._probe_fresh()
        probe_ms.append((time.perf_counter() - t1) * 1e3)
    svc = busy.svc
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for _ in range(Q_SEGMENT):      # a round at a time, as run() does
            svc.state = run_rounds(svc.state, svc.arrays, svc.config, 1,
                                   params=svc.params)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t1) * 1e6
    device = _device_rows(prof, Q_SEGMENT)
    busy_us = sum(us for _, us, _ in device)
    plane = svc.state.flow
    return {"topology": f"erdos_renyi:{Q_NODES}:6", "lanes": Q_LANES,
            "drop_rate": Q2_DROP, "build_s": build_s, "lane": lane,
            "segments": Q2_SEGMENTS + 1, "lane_equal_to_isolated": True,
            "boundaries": len(free_resid), "free_resid_max": 0.0,
            "retired": retired, "compile_count": busy.compile_count,
            "timed_segments": Q2_TIMED_SEGMENTS,
            "ms_per_segment": seg_ms,
            "lane_probe_ms": statistics.median(probe_ms),
            "device_ms_per_round": busy_us / 1e3,
            "wall_ms_per_round": wall_us / Q_SEGMENT / 1e3,
            "busy_share": busy_us * Q_SEGMENT / wall_us,
            "launches_per_round": sum(c for _, _, c in device),
            "top": [{"kernel": k[:80], "ms_per_round": us / 1e3,
                     "calls_per_round": c}
                    for k, us, c in sorted(device, key=lambda r: -r[1])[:5]],
            "edge_plane_bytes": plane.numel() * plane.element_size(),
            "peak_memory_bytes": torch.cuda.max_memory_allocated()}


def phase_path_q3(tmp) -> dict:
    """Q3: an ``AggregateFabric`` at ``scripts/aggregate_smoke.py``'s size
    (``erdos_renyi:Q3_NODES:6``, capacity + 64, ``Q3_LANES`` lanes, degree
    budget 24, segments of 8, eps 1e-3) under join/add-edge/leave churn:
    the sum/count lanes and a standing window (restreamed three times)
    first, one segment on the plain round, then max, min and quantile
    (``lane_modes`` installed); a second wave of the four value kinds
    into the retired lanes.  ``compile_count`` exactly 2, every read
    against its numpy oracle, ``doctor``'s aggregate checks ``pass``."""
    import numpy as np

    from flow_updating_tpu_torch.aggregates import AggregateFabric
    from flow_updating_tpu_torch.obs.report import (
        build_query_manifest,
        write_report,
    )
    from flow_updating_tpu_torch.topology.generators import erdos_renyi

    t0 = time.perf_counter()
    topo = erdos_renyi(Q3_NODES, avg_degree=6, seed=SEED)
    fab = AggregateFabric(topo, lanes=Q3_LANES, capacity=Q3_NODES + 64,
                          degree_budget=24, segment_rounds=8, seed=SEED,
                          conv_eps=1e-3, probe_manifest=True)
    rng = np.random.default_rng(SEED)
    members = fab.svc.live_ids()

    def cohort(m):
        return np.sort(rng.choice(members, size=m, replace=False))

    def submit(wave, kinds):
        for label, kind, params in kinds:
            c = cohort(int(rng.integers(64, 256)))
            vals = rng.random(c.size)
            wave[label] = (fab.submit_aggregate(kind, vals, c, **params),
                           vals)

    wave1, wave2 = {}, {}
    submit(wave1, [("sum_count", "sum_count", {})])
    win_cohort = cohort(128)
    win_vals = [rng.random(128)]
    win_aid = fab.submit_aggregate("windowed_mean", win_vals[0],
                                   win_cohort, window=4)
    fab.run(8)                           # the plain round: signature 1
    if fab.compile_count != 1 or fab.extrema_installed:
        raise AssertionError(f"Q3: {fab.compile_count} signatures before "
                             "the first extrema admission")
    extrema = [("max", "max", {}), ("min", "min", {}),
               ("quantile", "quantile", {"q": 0.5, "qeps": Q3_QEPS})]
    submit(wave1, extrema)
    held, state = [], {"events": 0, "pushes": 0, "rounds": 8}

    def churn(budget):
        while state["events"] < Q3_EVENTS and budget > 0:
            if held and rng.random() < 0.4:
                fab.leave([held.pop()])
                state["events"] += 1
                budget -= 1
            else:
                slot = fab.join()
                fab.add_edges([(slot, int(rng.integers(0, Q3_NODES)))])
                held.append(slot)
                state["events"] += 2
                budget -= 2

    def done(wave):
        return all(fab.read_aggregate(a)["status"] == "done"
                   for a, _ in wave.values())

    while not done(wave1) and state["rounds"] < 4096:
        churn(6)
        if state["pushes"] < 3 and state["rounds"] % 32 == 0:
            batch = rng.random(128)
            win_vals.append(batch)
            if not fab.push(win_aid, batch)["neutral"]:
                raise AssertionError("Q3: a restream moved the residual")
            state["pushes"] += 1
        fab.run(8)
        state["rounds"] += 8
    submit(wave2, [("sum_count", "sum_count", {})] + extrema)
    while not done(wave2) and state["rounds"] < 8192:
        churn(6)
        fab.run(8)
        state["rounds"] += 8
    if fab.compile_count != 2:
        raise AssertionError(f"Q3: {fab.compile_count} signatures "
                             "(budget: the plain round + lane_modes = 2)")
    errors = {}
    for name, wave in (("wave1", wave1), ("wave2", wave2)):
        if not done(wave):
            raise AssertionError(f"Q3: {name} not done")
        for label, (aid, vals) in wave.items():
            res = fab.read_aggregate(aid, max_staleness=None)["result"]
            got = float(res["mean"] if label == "sum_count"
                        else res["value"])
            truth = {"sum_count": float(np.mean(vals)),
                     "max": float(np.max(vals)),
                     "min": float(np.min(vals)),
                     "quantile": float(np.sort(vals)[
                         int(np.ceil(0.5 * vals.size)) - 1])}[label]
            if label == "sum_count":
                bound = float(res["mean_error_bound"]) + 1e-9
            elif label == "quantile":
                bound = Q3_QEPS * (float(res["hi"]) - float(res["lo"])) \
                    + 1e-9
            else:
                bound = 1e-6
            errors[f"{name}.{label}"] = [abs(got - truth), bound]
            if abs(got - truth) > bound:
                raise AssertionError(f"Q3: {name}/{label} read {got!r} vs "
                                     f"{truth!r} (bound {bound:.3g})")
    win = fab.read_aggregate(win_aid, max_staleness=None)["result"]
    win_truth = float(np.mean(np.concatenate(win_vals[-4:])))
    report = os.path.join(tmp, "q3.json")
    write_report(report, build_query_manifest(
        argv=["path_q3"], config=fab.svc.config, topo=topo,
        query=fab.query_block(),
        extra={"aggregates": fab.aggregate_block()}))
    verdict = _p_verdict(report)
    for name in ("aggregate_read", "aggregate_extrema_monotone",
                 "aggregate_kind_census", "query_compile",
                 "query_lane_mass"):
        if verdict["checks"].get(name) != "pass":
            raise AssertionError(f"Q3: doctor {name}: {verdict}")
    return {"topology": f"erdos_renyi:{Q3_NODES}:6", "lanes": Q3_LANES,
            "kinds": fab.aggregate_block()["kinds"],
            "compile_count": fab.compile_count,
            "events": state["events"], "pushes": state["pushes"],
            "rounds": state["rounds"], "read_errors": errors,
            "window_mean": win["mean"], "window_host_mean": win_truth,
            "doctor": verdict, "q3_s": time.perf_counter() - t0}


def _q4_ops(n: int, lanes: int, queries: int, rate: float,
            cohort_frac: float, seed: int, segments: int) -> list:
    """The journal records ``query`` writes for its Poisson arrivals (one
    ``submit`` a query, one ``run`` a segment), drawn as the subcommand
    draws them: ``("submit", values, cohort)`` and ``("run", rounds)``."""
    import numpy as np

    rng = np.random.default_rng(seed + 1)
    members = np.arange(n, dtype=np.int32)
    m = max(1, int(round(n * cohort_frac)))
    ops, submitted = [], 0
    for _ in range(segments):
        arrivals = min(int(rng.poisson(rate * Q_SEGMENT)),
                       queries - submitted)
        for _ in range(arrivals):
            cohort = rng.choice(members, size=m, replace=False)
            ops.append(("submit", rng.random(m), np.sort(cohort)))
            submitted += 1
        ops.append(("run", Q_SEGMENT))
    return ops


def phase_path_q4(tmp) -> dict:
    """Q4: a child process runs ``query --wal DIR --checkpoint-every 4
    --watchdog`` on ``erdos_renyi:Q4_NODES:6`` (``Q4_LANES`` lanes, 1%
    loss) and is killed with SIGKILL once the run record of segment
    ``Q4_KILL_SEGMENT`` is journaled; ``query --wal DIR --recover`` (in
    this process) rebuilds it, and its ``state_digest`` equals a fabric
    driven through the same journal records without a crash; ``doctor``
    gives ``wal_replay_exact`` ``pass``.  Then a NaN-poisoned lane under
    the watchdog: quarantined (reason ``nan``, residual after the scrub
    exactly 0.0), every other lane plane ``torch.equal`` to an
    unpoisoned control."""
    import signal
    import subprocess

    import numpy as np
    import torch

    from flow_updating_tpu_torch.models.config import RoundConfig
    from flow_updating_tpu_torch.query import QueryFabric
    from flow_updating_tpu_torch.query.fabric import LANE_PLANES
    from flow_updating_tpu_torch.resilience.wal import scan_wal
    from flow_updating_tpu_torch.topology.generators import erdos_renyi

    queries, rate, frac = 4 * Q4_LANES, 2.0, 40 / Q4_NODES
    base = ["--generator", f"erdos_renyi:{Q4_NODES}:6", "--seed",
            str(SEED), "--capacity", str(Q4_NODES + 64),
            "--degree-budget", "24", "--lanes", str(Q4_LANES),
            "--segment-rounds", str(Q_SEGMENT), "--queries", str(queries),
            "--arrival-rate", repr(rate), "--cohort-frac", repr(frac),
            "--eps", "1e-3", "--drop-rate", "0.01", "--dtype", "float32"]
    wal_dir = os.path.join(tmp, "q4_wal")
    wal_log = os.path.join(wal_dir, "wal.log")
    env = {**os.environ, "PYTHONPATH": ROOT}
    t0 = time.perf_counter()
    child = subprocess.Popen(
        [sys.executable, "-m", "flow_updating_tpu_torch", "query", *base,
         "--rounds", str(Q_ROUNDS), "--wal", wal_dir,
         "--checkpoint-every", "4", "--watchdog"],
        cwd=ROOT, env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE)
    runs = 0
    try:
        while child.poll() is None and time.perf_counter() - t0 < 180:
            if os.path.exists(wal_log):
                try:
                    runs = sum(1 for r in scan_wal(wal_log)[0]
                               if r["kind"] == "run")
                except ValueError:
                    runs = 0
                if runs >= Q4_KILL_SEGMENT:
                    child.send_signal(signal.SIGKILL)
                    break
            time.sleep(0.005)
    finally:
        if child.poll() is None and runs < Q4_KILL_SEGMENT:
            child.kill()
        rc = child.wait()
        err = child.stderr.read().decode(errors="replace")
        child.stderr.close()
    child_s = time.perf_counter() - t0
    if rc != -signal.SIGKILL or runs < Q4_KILL_SEGMENT:
        raise AssertionError(f"Q4: the child exited {rc} before the kill "
                             f"({runs} runs): {err[-2000:]}")
    records, torn = scan_wal(wal_log)
    last = int(records[-1]["seq"]) if records else 0
    report = os.path.join(tmp, "q4.json")
    rec_end = os.path.join(tmp, "q4_rec.npz")
    t0 = time.perf_counter()
    rc, out = _cli_json(["query", "--wal", wal_dir, "--recover",
                         "--queries", "0", "--rounds", "0", "--report",
                         report, "--checkpoint", rec_end])
    recover_call_s = time.perf_counter() - t0
    if rc != 0 or not out["durability"]["recovered"]:
        raise AssertionError(f"Q4: the recovery exited {rc}: {out}")
    got = QueryFabric.restore_checkpoint(rec_end).state_digest()
    # the control: the same fabric driven through the journal's records
    # (the subcommand's own draws) with no crash
    topo = erdos_renyi(Q4_NODES, avg_degree=6, seed=SEED)
    cfg = RoundConfig.fast(variant="collectall", drop_rate=0.01)
    ctrl = QueryFabric(topo, lanes=Q4_LANES, capacity=Q4_NODES + 64,
                       degree_budget=24, config=cfg,
                       segment_rounds=Q_SEGMENT, seed=SEED,
                       conv_eps=1e-3).attach_watchdog()
    ops = _q4_ops(Q4_NODES, Q4_LANES, queries, rate, frac, SEED,
                  Q4_KILL_SEGMENT + 2)[:last]
    for op in ops:
        if op[0] == "submit":
            ctrl.submit(op[1], cohort=op[2])
        else:
            ctrl.run(op[1])
    want = ctrl.state_digest()
    with open(report) as f:
        manifest = json.load(f)
    recovery = manifest["recovery"]
    verdict = _p_verdict(report)
    if got != want:
        raise AssertionError(f"Q4: recovered digest {got} != control "
                             f"{want} ({last} records)")
    if verdict["checks"].get("wal_replay_exact") != "pass":
        raise AssertionError(f"Q4: doctor wal_replay_exact: {verdict}")

    # a NaN-poisoned lane under the watchdog, against a clean twin
    def build():
        f = QueryFabric(topo, lanes=Q4_LANES, capacity=Q4_NODES + 64,
                        degree_budget=24, config=cfg,
                        segment_rounds=Q_SEGMENT, seed=SEED,
                        conv_eps=1e-30).attach_watchdog()
        rng = np.random.default_rng(SEED + 5)
        for vals, cohort in _q_cohort_queries(rng, np.arange(Q4_NODES),
                                              Q4_LANES // 2):
            f.submit(vals, cohort=cohort)
        f.run(2 * Q_SEGMENT)
        return f

    sick, clean = build(), build()
    lane = Q4_LANES // 4
    sick.svc.state.est[:, lane] = float("nan")
    sick.svc.state.flow[:, lane] = float("nan")
    for f in (sick, clean):
        f.run(2 * Q_SEGMENT)
    acts = sick._watchdog.block()["actions"]
    if [(a["lane"], a["reason"], a["post_scrub_residual"])
            for a in acts] != [(lane, "nan", 0.0)]:
        raise AssertionError(f"Q4: watchdog actions {acts}")
    keep = torch.tensor([ln for ln in range(Q4_LANES) if ln != lane],
                        device=sick.device)
    unequal = [n for n in LANE_PLANES if not torch.equal(
        getattr(sick.svc.state, n).index_select(-1, keep),
        getattr(clean.svc.state, n).index_select(-1, keep))]
    if unequal or sick.mass_residual()[lane] != 0.0:
        raise AssertionError(f"Q4: the quarantine touched {unequal}")
    fsync = (manifest.get("serving_trace") or {}).get("metrics", {}) \
        .get("histograms", {}).get("wal_fsync_seconds") or {}
    return {"topology": f"erdos_renyi:{Q4_NODES}:6", "lanes": Q4_LANES,
            "drop_rate": 0.01, "killed_after_runs": runs,
            "wal_records": len(records), "torn_bytes": torn,
            "child_s": child_s, "replay": recovery["replay"],
            "ring_used": recovery["ring"]["used"],
            "recover_s": manifest["timings"]["setup_s"],
            "recover_call_s": recover_call_s, "digest_equal": True,
            "doctor": verdict, "quarantine": acts[0],
            "other_lanes_equal": True,
            "wal_fsync_s_per_record": (fsync["sum"] / fsync["count"]
                                       if fsync.get("count") else None)}


# ---- path R: the chaos registry on the card -------------------------------

def _chaos_argv(name: str, nodes: int, outdir: str, perturb: bool) -> list:
    return [sys.executable, "-m", "flow_updating_tpu_torch", "chaos", name,
            "--nodes", str(nodes), "--lanes", str(R_LANES), "--ops",
            str(R_OPS), "--outdir", outdir,
            *(["--perturb"] if perturb else [])]


def _run_chaos_processes(jobs, tmp) -> dict:
    """Start one ``chaos`` CLI process per ``(key, argv)`` job at once (each
    starts its own child on the card), wait for all under ``R_TIMEOUT_S``
    each, and return ``{key: (rc, wall_s, last JSON line, stderr tail)}``.
    A process still running at its limit is killed, as are all others
    once one fails to start."""
    # two host threads a process: ten processes share the host's cores
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "2"}
    procs, ended = {}, {}
    try:
        for key, argv in jobs:
            out = open(os.path.join(tmp, f"{key}.out"), "w+")
            err = open(os.path.join(tmp, f"{key}.err"), "w+")
            procs[key] = (subprocess.Popen(argv, cwd=ROOT, env=env,
                                           stdout=out, stderr=err),
                          out, err, time.perf_counter())
        while len(ended) < len(procs):
            for key, (proc, _, _, t0) in procs.items():
                if key not in ended and proc.poll() is not None:
                    ended[key] = time.perf_counter() - t0
                elif key not in ended and \
                        time.perf_counter() - t0 > R_TIMEOUT_S:
                    raise AssertionError(f"R {key}: still running after "
                                         f"{R_TIMEOUT_S} s")
            time.sleep(0.2)
        done = {}
        for key, (proc, out, err, _) in procs.items():
            out.seek(0)
            err.seek(0)
            lines = out.read().strip().splitlines()
            done[key] = (proc.returncode, ended[key],
                         json.loads(lines[-1]) if lines else None,
                         err.read()[-3000:])
        return done
    finally:
        for proc, out, err, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            out.close()
            err.close()


def phase_path_r(tmp) -> dict:
    """R: the whole chaos registry through ``chaos`` on the card (R1, at
    ``R_NODES`` members and ``R_LANES`` lanes), and ``--perturb`` for one
    fault per recovery mechanism (R2: the WAL, the ring's fallback, the
    watchdog, at ``R2_NODES``), all ten CLI processes started at once.
    Gates: every process exits 0 (no violated contract); each R1 manifest
    passes ``doctor --strict`` but for the checks of
    ``R_REFERENCE_FAILS``, and ``blame_top`` is its fault; the five
    kill and tamper faults recover to the control's digest; the NaN lane
    leaves every other lane equal to its control (``verify.exact``) with
    the free-lane residual exactly 0.0 at every boundary; the storm's
    queue drains; each R2 manifest fails its signature and ``doctor
    --strict``."""
    import torch

    from flow_updating_tpu_torch.resilience.chaos import CHAOS_REGISTRY

    torch.cuda.empty_cache()
    r1_dir = os.path.join(tmp, "r1")
    r2_dir = os.path.join(tmp, "r2")
    names = sorted(CHAOS_REGISTRY)
    jobs = [(f"r1_{n}", _chaos_argv(n, R_NODES, r1_dir, False))
            for n in names]
    jobs += [(f"r2_{n}", _chaos_argv(n, R2_NODES, r2_dir, True))
             for n in R2_FAULTS]
    t0 = time.perf_counter()
    done = _run_chaos_processes(jobs, tmp)
    procs_s = time.perf_counter() - t0
    r1, r2, bad = {}, {}, []
    for key, (rc, wall, out, err) in done.items():
        if rc != 0 or out is None or out["violations"]:
            bad.append(f"R {key}: chaos exited {rc}: {out}\n{err}")
            continue
        res = out["results"][0]
        with open(res["manifest_path"]) as f:
            man = json.load(f)
        drc, doc = _doctor_cli(["--strict", res["manifest_path"]])
        st = _statuses(doc["checks"])
        name = res["fault"]
        env = man["environment"]
        row = {"wall_s": wall, "overall": res["overall"],
               "blame_top": res["blame_top"], "doctor_rc": drc,
               "statuses": st, "timings": man.get("timings")}
        if env.get("backend") != R_BACKEND:
            bad.append(f"R {key}: the recovery ran on {env}")
        if key.startswith("r2_"):
            if res["overall"] != "fail" or drc != 1:
                bad.append(f"R2 {name}: the perturbed run passed its "
                           f"signature: {res}, doctor {drc}")
            r2[name] = row
            continue
        r1[name] = row
        failing = {c for c, v in st.items() if v == "fail"}
        row["reference_fails"] = sorted(failing)
        if not failing <= R_REFERENCE_FAILS.get(name, set()) \
                or drc != (1 if failing else 0) \
                or res["blame_top"] != name:
            fails = [c for c in doc["checks"] if c["status"] == "fail"]
            bad.append(f"R1 {name}: doctor {drc}, blame "
                       f"{res['blame_top']}: {fails}")
        fault = CHAOS_REGISTRY[name]
        rec = man["recovery"]
        if fault.kill:
            v = rec["verify"]
            if not (v["exact"] and v["recovered_digest"]
                    == v["control_digest"]):
                bad.append(f"R1 {name}: recovery not exact: {v}")
            row["records_replayed"] = rec["replay"]["records_replayed"]
            row["fallbacks"] = rec["ring"]["fallbacks"]
        if fault.inject == "nan_lane":
            v = rec["verify"]
            free = [b["max_resid_free"] for b in man["query"]["boundaries"]]
            if not v["exact"] or any(x != 0.0 for x in free) \
                    or st.get("quarantine_mass") != "pass":
                bad.append(f"R1 {name}: lanes {v}, free-lane residuals "
                           f"{free}, {st}")
            row["poisoned_lane"] = v["poisoned_lane"]
            row["boundaries"] = len(free)
        if fault.inject == "storm":
            last = man["query"]["boundaries"][-1]
            if last["queued"] != 0 \
                    or st.get("degraded_mode_bounded") != "pass":
                bad.append(f"R1 {name}: the storm did not drain: {last}, "
                           f"{st}")
            row["admitted_total"] = man["query"]["admitted_total"]
    if bad:
        raise AssertionError("path R:\n" + "\n".join(bad))
    return {"r1": r1, "r2": r2, "processes": len(jobs),
            "processes_wall_s": procs_s,
            "r1_args": {"nodes": R_NODES, "lanes": R_LANES, "ops": R_OPS},
            "r2_args": {"nodes": R2_NODES, "lanes": R_LANES, "ops": R_OPS}}


# ---- path S: actors on the card ---------------------------------------------

def _same_carry(a, b) -> bool:
    import torch

    from flow_updating_tpu_torch.utils.checkpoint import tree_leaves_with_path

    la, lb = tree_leaves_with_path(a), tree_leaves_with_path(b)
    return len(la) == len(lb) and all(
        ka == kb and torch.equal(va, vb) for (ka, va), (kb, vb)
        in zip(la, lb))


def _push_sum_engine(tree):
    from flow_updating_tpu_torch import Engine, push_sum_actor

    eng = Engine().set_topology(tree)
    return eng.register_actor("pushsum", push_sum_actor())


def phase_path_s1(tree, tmp) -> dict:
    """S1: ``push_sum_actor()`` through ``Engine.register_actor`` on the
    full fat tree, ``S_ROUNDS`` rounds.  Gates: the total of ``s`` and of
    ``w`` (state plus outbox, summed in float64) within ``S_MASS_RTOL`` of
    the start at every sample, the rmse falling, K1 launched twice a round
    per non-empty in-edge bucket; a second run ``torch.equal``; the
    archive of round ``S_CKPT_ROUND`` restored into a fresh engine and
    resumed ``torch.equal`` to the uninterrupted run; ``sum_to_dst`` on the
    card within K1's float32 tolerance (rtol = atol = 1e-6) of its plain
    version.  Then ms a round by CUDA events and the profiler's device ms
    and launches a round."""
    import numpy as np
    import torch

    from flow_updating_tpu_torch.ops.spmv import neighbor_sum, neighbor_sum_ell

    t0 = time.perf_counter()
    eng = _push_sum_engine(tree).build()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    view = eng._node_kernel.view
    buckets = sum(1 for m in view.ell if m.shape[0] and m.shape[1])
    mean = tree.true_mean
    mass0 = (float(np.sum(tree.values.astype(np.float32),
                          dtype=np.float64)), float(tree.num_nodes))

    def masses():
        st, out = eng.state
        return [float(st[k].double().sum() + out[k].double().sum())
                for k in ("s", "w")]

    def rmse():
        est = eng._node_kernel._estimate(eng.state).double()
        return float(torch.sqrt(torch.mean((est - mean) ** 2)))

    path = os.path.join(tmp, "push_sum.npz")
    samples = [{"t": 0, "rmse": rmse(), "mass_rel_err": [0.0, 0.0]}]
    reset_counts()
    t1 = time.perf_counter()
    for t in range(S_SAMPLE, S_ROUNDS + 1, S_SAMPLE):
        eng.run_rounds(S_SAMPLE)
        m = masses()
        samples.append({"t": t, "rmse": rmse(),
                        "mass_rel_err": [abs(m[i] - mass0[i]) / mass0[i]
                                         for i in range(2)]})
        if t == S_CKPT_ROUND:
            eng.save_checkpoint(path)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t1
    launches = neighbor_sum_ell.launches
    if launches != 2 * S_ROUNDS * buckets:
        raise AssertionError(f"S1: K1 launched {launches} times in "
                             f"{S_ROUNDS} rounds, expected "
                             f"{2 * S_ROUNDS * buckets}")
    worst = max(max(x["mass_rel_err"]) for x in samples)
    if worst > S_MASS_RTOL:
        raise AssertionError(f"S1: mass drifted {worst} (> {S_MASS_RTOL})")
    if not samples[-1]["rmse"] < samples[0]["rmse"] / 10:
        raise AssertionError(f"S1: the rmse did not fall: {samples}")
    twin = _push_sum_engine(tree).build()
    twin.run_rounds(S_ROUNDS)
    rerun_equal = _same_carry(eng.state, twin.state)
    del twin
    t2 = time.perf_counter()
    resumed = _push_sum_engine(tree)
    resumed.restore_checkpoint(path)
    restore_s = time.perf_counter() - t2
    if resumed.clock != float(S_CKPT_ROUND):
        raise AssertionError(f"S1: restored clock {resumed.clock}")
    resumed.run_rounds(S_ROUNDS - S_CKPT_ROUND)
    resume_equal = _same_carry(eng.state, resumed.state)
    del resumed
    if not (rerun_equal and resume_equal):
        raise AssertionError(f"S1: second run equal {rerun_equal}, resumed "
                             f"run equal {resume_equal}")
    x = eng.state[1]["s"].contiguous()
    got = view.sum_to_dst(x)
    plain = neighbor_sum(x, view.ell)[view.ell_inv]
    err = float((got - plain).abs().max())
    if not torch.allclose(got, plain, rtol=1e-6, atol=1e-6):
        raise AssertionError(f"S1: sum_to_dst off its plain version by {err}")
    ms = _timed_rounds(eng, S_TIMED_ROUNDS) / S_TIMED_ROUNDS
    prof = profile_rounds(eng, PROFILE_ROUNDS)
    return {"topology": f"fat_tree:{FAT_TREE_K}", "nodes": tree.num_nodes,
            "directed_edges": tree.num_edges, "rounds": S_ROUNDS,
            "build_s": build_s, "run_s": run_s, "restore_s": restore_s,
            "archive_bytes": os.path.getsize(path),
            "k1_launches": launches, "nonempty_in_edge_buckets": buckets,
            "samples": samples, "mass_rel_err_max": worst,
            "rerun_equal": rerun_equal, "resume_equal": resume_equal,
            "sum_to_dst_max_abs_err": err, "ms_per_round": ms,
            "profile": prof}


def _s2_run(example) -> dict:
    from flow_updating_tpu_torch import s4u
    from flow_updating_tpu_torch.engine import Engine

    example.global_values.clear()
    eng = Engine(host_actors=True)
    eng.load_platform(os.path.join(ROOT, "examples/platforms/small6.xml"))
    eng.register_actor("peer", example.Peer)
    eng.load_deployment(os.path.join(
        ROOT, "examples/deployments/small6_actors.xml"))
    s4u.Actor.create("watcher", s4u.Host.by_name("Lisboa"),
                     example.watcher, S2_DEADLINE, 10.0)
    eng.run_until(S2_UNTIL)
    des = eng._hostdes
    alive = [c.name for c in des.actors if not c.done]
    des.shutdown()
    return {"clock": eng.clock, "alive_after_kill_all": alive,
            "mirrors": {k: dict(v)
                        for k, v in example.global_values.items()}}


def phase_path_s2() -> dict:
    """S2: the reference-style collect-all ``Peer`` of
    ``examples/torch_host_actors.py`` (written against the port's ``s4u``)
    on ``small6`` through ``Engine(host_actors=True)``.  Gates: every
    peer's last average within 0.05 of the true mean, every actor stopped
    by the watcher's ``kill_all``, and a second run replaying the same
    mirrors exactly."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_host_actors", os.path.join(ROOT,
                                          "examples/torch_host_actors.py"))
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    t0 = time.perf_counter()
    a = _s2_run(example)
    run_s = time.perf_counter() - t0
    b = _s2_run(example)
    values = a["mirrors"]["value"]
    mean = sum(values.values()) / len(values)
    err = max(abs(v - mean) for v in a["mirrors"]["last_avg"].values())
    if len(a["mirrors"]["last_avg"]) != 6 or err > 0.05:
        raise AssertionError(f"S2: the peers did not converge: {a}")
    if a["alive_after_kill_all"] or a["clock"] != S2_UNTIL:
        raise AssertionError(f"S2: actors left running: {a}")
    if a["mirrors"] != b["mirrors"]:
        raise AssertionError("S2: the second run replayed another "
                             "trajectory")
    return {"peers": len(values), "true_mean": mean,
            "max_abs_err": err, "replay_equal": True, "run_s": run_s,
            "last_avg": a["mirrors"]["last_avg"]}


def phase_path_s3(tree) -> dict:
    """S3: ``estimate_count``, ``estimate_sum``, ``estimate_min`` and
    ``estimate_max`` on the full fat tree, the mean runs on the node round
    through K1 (``spmv='pallas'``, float64).  Gates: count and sum within
    rel 1e-3 of the truth (``tests/test_robustness.py``'s bounds), min and
    max exact at every node."""
    import numpy as np

    from flow_updating_tpu_torch import (
        RoundConfig,
        estimate_count,
        estimate_max,
        estimate_min,
        estimate_sum,
    )
    from flow_updating_tpu_torch.ops.spmv import neighbor_sum_ell

    cfg = RoundConfig.fast(variant="collectall", kernel="node",
                           spmv="pallas", dtype="float64")
    out, times = {}, {}
    reset_counts()
    for name, fn in (("count", lambda: estimate_count(tree, cfg,
                                                      S3_ROUNDS)),
                     ("sum", lambda: estimate_sum(tree, cfg, S3_ROUNDS)),
                     ("min", lambda: estimate_min(tree)),
                     ("max", lambda: estimate_max(tree))):
        t0 = time.perf_counter()
        out[name] = fn()
        times[name] = time.perf_counter() - t0
    launches = neighbor_sum_ell.launches
    n, total = tree.num_nodes, float(tree.values.sum())
    errs = {"count": float(np.max(np.abs(out["count"] / n - 1))),
            "sum": float(np.max(np.abs(out["sum"] / total - 1)))}
    if max(errs.values()) > 1e-3:
        raise AssertionError(f"S3: count/sum off the truth: {errs}")
    if not ((out["min"] == tree.values.min()).all()
            and (out["max"] == tree.values.max()).all()):
        raise AssertionError("S3: min/max are not exact")
    if not launches:
        raise AssertionError("S3: the mean runs launched no K1")
    return {"rounds": S3_ROUNDS, "dtype": "float64",
            "count_rel_err": errs["count"], "sum_rel_err": errs["sum"],
            "min_exact": True, "max_exact": True, "k1_launches": launches,
            "seconds": times}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from flow_updating_tpu_torch import kernels
    from flow_updating_tpu_torch.ops.fused_round import fused_banded_round
    from flow_updating_tpu_torch.ops.spmv import neighbor_sum_ell
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

    t0 = time.perf_counter()
    path_t = {"t1": phase_path_t1(engine_a)}
    emit({"phase": "path_t", "part": "t1",
          "topology": f"fat_tree:{FAT_TREE_K}", **path_t["t1"]})
    path_t["t2"] = phase_path_t2(engine_b)
    emit({"phase": "path_t", "part": "t2", "topology": f"ring:{RING_N}:2",
          **path_t["t2"]})
    path_t["t3"] = phase_path_t3(engine_d)
    emit({"phase": "path_t", "part": "t3",
          "topology": f"fat_tree:{FAT_TREE_K}", **path_t["t3"]})
    path_t["t4"] = phase_path_t4(engine_e)
    emit({"phase": "path_t", "part": "t4", "topology": f"ring:{RING_N}:2",
          **path_t["t4"]})
    with tempfile.TemporaryDirectory(prefix="chip_smoke_profile_") as tmp:
        path_t["t5"] = phase_path_t5(engine_f, tmp)
    emit({"phase": "path_t", "part": "t5",
          "topology": f"fat_tree:{FAT_TREE_K}", **path_t["t5"]})
    torch.cuda.synchronize()
    emit({"phase": "path_t", "wall_s": time.perf_counter() - t0,
          "nvidia_smi": smi,
          "roofline_frac": {k: v["roofline"]["roofline_frac"]
                            for k, v in path_t.items()},
          "twins_equal": {k: v["twin"]["equal"]
                          for k, v in path_t.items()}})

    t0 = time.perf_counter()
    reset_counts()
    path_l, f_single, manifests = phase_path_l(
        tree, ring_topo, engine_a, engine_d, engine_f,
        path_j["j3"].pop("telemetry"))
    l_launches = {"k1": neighbor_sum_ell.launches,
                  "k2": fused_banded_round.launches, "b3": b3_launches(),
                  "b4": b4_launches(), "b6": b6_launches()}
    emit({"phase": "path_l", "wall_s": time.perf_counter() - t0,
          "launches": l_launches,
          "k2_probe_and_route_launches": l_launches["k2"]})

    t0 = time.perf_counter()
    reset_counts()
    path_m, m_manifests = phase_path_m(engine_a, engine_b, engine_c,
                                       engine_d, engine_f, f_single)
    manifests.update(m_manifests)
    del f_single, m_manifests
    m_launches = {"k1": neighbor_sum_ell.launches,
                  "k2": fused_banded_round.launches, "b3": b3_launches(),
                  "b4": b4_launches(), "b6": b6_launches()}
    emit({"phase": "path_m", "wall_s": time.perf_counter() - t0,
          "launches": m_launches, "path_j3": path_j["j3"].pop("fields"),
          **{k: v for k, v in path_m.items() if not k.startswith("path_")}})
    for family, count in (("K1", m_launches["k1"]),
                          ("K2", m_launches["k2"]),
                          ("B3", sum(m_launches["b3"].values())),
                          ("B4", sum(m_launches["b4"].values())),
                          ("B6", m_launches["b6"]["fused"])):
        if not count:
            raise AssertionError(f"path M launched no {family}")

    t0 = time.perf_counter()
    reset_counts()
    path_n = {"n1": phase_path_n1()}
    n_launches = {"k1": neighbor_sum_ell.launches}
    emit({"phase": "path_n", "part": "n1", "launches": n_launches,
          **path_n["n1"]})
    with tempfile.TemporaryDirectory(prefix="chip_smoke_doctor_") as tmp:
        path_n["n2"] = phase_path_n2(manifests, tmp)
    del manifests
    emit({"phase": "path_n", "part": "n2", **path_n["n2"]})
    emit({"phase": "path_n", "wall_s": time.perf_counter() - t0,
          "launches": n_launches})

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sweep_") as tmp:
        path_o = {}
        path_o["o1"], o_bucket, o_grid = phase_path_o1(tmp)
        emit({"phase": "path_o", "part": "o1", **path_o["o1"]})
        path_o["o2"] = phase_path_o2(o_bucket, o_grid)
        del o_bucket, o_grid
        emit({"phase": "path_o", "part": "o2", **path_o["o2"]})
        path_o["o3"] = phase_path_o3(tmp)
        emit({"phase": "path_o", "part": "o3", **path_o["o3"]})
    path_o["o4"] = phase_path_o4(tree)
    emit({"phase": "path_o", "part": "o4",
          "topology": f"fat_tree:{FAT_TREE_K}", **path_o["o4"]})
    o4 = path_o["o4"]
    emit({"phase": "path_o", "wall_s": time.perf_counter() - t0,
          "launches": {"b3": o4["b3_launches"], "b4": o4["b4_launches"]}})

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_") as tmp:
        path_p = {}
        path_p["p1"], p1_files = phase_path_p1(tmp)
        emit({"phase": "path_p", "part": "p1", **path_p["p1"]})
        path_p["p2"] = phase_path_p2(ring_topo)
        emit({"phase": "path_p", "part": "p2",
              "topology": f"ring:{RING_N}:2", **path_p["p2"]})
        path_p["p3"] = phase_path_p3(p1_files)
        del p1_files
        emit({"phase": "path_p", "part": "p3", **path_p["p3"]})
        path_p["p4"] = phase_path_p4(tmp)
        emit({"phase": "path_p", "part": "p4", **path_p["p4"]})
    emit({"phase": "path_p", "wall_s": time.perf_counter() - t0})

    t0 = time.perf_counter()
    reset_counts()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_query_") as tmp:
        path_q = {"q1": phase_path_q1(tmp)}
        emit({"phase": "path_q", "part": "q1", **path_q["q1"]})
        torch.cuda.empty_cache()
        path_q["q2"] = phase_path_q2()
        emit({"phase": "path_q", "part": "q2", **path_q["q2"]})
        torch.cuda.empty_cache()
        path_q["q3"] = phase_path_q3(tmp)
        emit({"phase": "path_q", "part": "q3", **path_q["q3"]})
        path_q["q4"] = phase_path_q4(tmp)
        emit({"phase": "path_q", "part": "q4", **path_q["q4"]})
    # the fabric runs the plain row fold: no kernel of the port launches
    q_launches = {"k1": neighbor_sum_ell.launches,
                  "k2": fused_banded_round.launches, "b3": b3_launches(),
                  "b4": b4_launches(), "b5": b5_launches(),
                  "b6": b6_launches()}
    emit({"phase": "path_q", "wall_s": time.perf_counter() - t0,
          "launches": q_launches})

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_actor_") as tmp:
        path_s = {"s1": phase_path_s1(tree, tmp)}
    emit({"phase": "path_s", "part": "s1", **path_s["s1"]})
    path_s["s2"] = phase_path_s2()
    emit({"phase": "path_s", "part": "s2", **path_s["s2"]})
    path_s["s3"] = phase_path_s3(tree)
    emit({"phase": "path_s", "part": "s3", **path_s["s3"]})
    s_launches = {"k1": path_s["s1"]["k1_launches"]
                  + path_s["s3"]["k1_launches"]}
    emit({"phase": "path_s", "wall_s": time.perf_counter() - t0,
          "launches": s_launches})

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_chaos_") as tmp:
        path_r = phase_path_r(tmp)
    emit({"phase": "path_r", "wall_s": time.perf_counter() - t0, **path_r})

    emit({"phase": "timing", "timed_by_cuda_events": EVENT_TIMED})
    emit({"kernels": [
        {"name": "spmv_ell", "route": "cuda",
         "source": "flow_updating_tpu_torch/csrc/spmv_ell.cu",
         "replaces": "flow_updating_tpu/ops/pallas_spmv.py:35",
         "launches": (path_a["k1_launches"] + l_launches["k1"]
                      + m_launches["k1"] + n_launches["k1"]
                      + s_launches["k1"]),
         "parity": "float32 rtol=atol=1e-6, float64 1e-12, dyadic exact",
         "max_abs_err": k1["max_abs_err_float32"],
         "ms": k1["ms"], "call_ms": k1["call_ms"],
         "plain_ms": k1["plain_ms"],
         "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
         "library_ms": k1["library_ms"]},
        {"name": "fused_round", "route": "cuda",
         "source": "flow_updating_tpu_torch/csrc/fused_round.cu",
         "replaces": "flow_updating_tpu/ops/pallas_round.py:331",
         "launches": (path_b["k2_launches"] + l_launches["k2"]
                      + m_launches["k2"]),
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
                        + path_j["j4"]["b3_launches"][name]
                        + l_launches["b3"][name] + m_launches["b3"][name]
                        + o4["b3_launches"][name]),
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
                        + i_b4[name] + l_launches["b4"][name]
                        + m_launches["b4"][name]
                        + o4["b4_launches"][name]),
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
                      + path_i["i3"]["b6_launches"]["fused"]
                      + l_launches["b6"]["fused"]
                      + m_launches["b6"]["fused"]),
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
