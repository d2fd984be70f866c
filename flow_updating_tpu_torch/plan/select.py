"""Auto-mode plan selection: pick the fastest correct execution per
(topology, backend).

Counterpart of ``flow_updating_tpu/plan/select.py``.  ``Engine(plan=
'auto')`` calls :func:`select_plan` after resolving the topology:
candidates are enumerated from what the config permits (the
node-collapsed kernel covers exactly the fast synchronous collect-all
mode; everything else runs the edge kernel), each gets a predicted
per-round cost from an analytic memory-traffic model (streamed
element-passes, with the backend's dynamic-gather penalty
:data:`GATHER_COST`), and the cheapest wins.  Above
:data:`AUTOTUNE_MIN_NODES` nodes the banded family is raced on the
engine's device (:func:`autotune_fused`: band width x tile x remainder
route of kernel K2) and the measured rates replace its prediction; the
records persist in a JSON cache keyed by plan content, device, torch and
CUDA versions and dtype.  A topology carrying a generator's structure
descriptor always selects the structured stencil.  The best banded and
the best fused configuration of the grid are then raced head to head
with ``node/xla`` (:func:`_head_to_head`), and those three measured
rates rank the node candidates: on the card the rounds are host-bound,
and the best of many noisy probes of one family would otherwise beat
the analytic estimate of another.

:func:`select_halo_mode` ranks the halo kernel's exchanges (``halo=
'auto'``) from the plan's wire bytes; on a mesh whose shards all sit on
one device it credits the overlap schedule with no hiding — there is no
wire to hide.

``probe='aot'`` replaces the analytic numbers with the bytes a round of
each candidate's program moves, counted on the device
(:func:`_aot_costs`, :mod:`~flow_updating_tpu_torch.obs.profile`: the
plain ops' bytes and the kernels' declared work).  The JAX package ranks
by XLA's cost analysis of the lowered programs instead, so on some graph
the two packages' picks may differ.  ``FLOW_UPDATING_ROOFLINE`` annotates
a fresh probe record with each raced family's roofline fraction
(:func:`_annotate_roofline`).  :func:`autotune_metrics` is the cache's Prometheus face: its counters
(and a record's measured rates) into a ``MetricsRegistry``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np

from flow_updating_tpu_torch.kernels import KernelError
from flow_updating_tpu_torch.plan.compile import ExecutionPlan, compile_topology

#: relative cost of one dynamically gathered element vs one streamed
#: element, per backend.  'cuda': measured on an NVIDIA H100 80GB HBM3
#: (power limit 700 W) by chip_smoke.py's phase L0 — the node/xla gather
#: of a graph's neighbor slots (one ``x[bucket]`` per degree bucket)
#: against a streamed copy of as many float32 elements, by device time:
#: 4.45 on the k=160 fat tree (11.7 ps a slot against 2.6), 5.30 and
#: 5.70 in two runs on barabasi_albert(1e6, 4) (16–18 ps against 3.1);
#: the constant is the geometric mean of the first run's two ratios
#: (PERF.md, path L).  'cpu': the JAX package's vectorized-but-cache-
#: hostile host figure.
GATHER_COST = {"cuda": 5.04, "cpu": 8.0}
DEFAULT_GATHER_COST = 8.0

#: per-collective launch overhead charged in wire-byte equivalents when
#: ranking the halo exchange modes — what keeps the one-collective
#: allgather competitive when the cut is tiny but the offsets are many
HALO_LATENCY_BYTES = 8192.0

#: interior-to-cut work ratio at which the overlap schedule fully hides
#: the wire (intra / cut >= the ratio: the exchange ends inside the
#: interior pass)
OVERLAP_HIDE_RATIO = 4.0


@dataclasses.dataclass(frozen=True)
class PlanDecision:
    """What auto mode chose, and why (manifest-ready)."""

    kernel: str                 # 'edge' | 'node'
    spmv: str | None            # node kernel only
    plan: ExecutionPlan | None  # banded plans carry the compiled plan
    backend: str
    predicted: dict             # candidate -> predicted per-round cost
    reason: str
    fused: dict | None = None   # measured-probe autotune record (tile /
    #                             remainder route / per-candidate rates)

    def describe(self) -> dict:
        out = {
            "kernel": self.kernel,
            "spmv": self.spmv,
            "backend": self.backend,
            "predicted_cost": {k: (round(float(v), 1)
                                   if isinstance(v, (int, float)) else v)
                               for k, v in self.predicted.items()},
            "reason": self.reason,
        }
        if self.fused is not None:
            out["autotune"] = self.fused
        if self.plan is not None:
            out["plan"] = self.plan.describe()
        return out


def _backend_name(backend: str | None, device=None) -> str:
    """The cost model's backend: as given, else the device's type, else
    ``cuda`` when a card is visible and ``cpu`` otherwise."""
    import torch

    if backend:
        return backend
    if device is not None:
        return torch.device(device).type
    return "cuda" if torch.cuda.is_available() else "cpu"


def _remainder_cost(s, cg: float, N: float) -> float:
    """Streamed-pass cost of a plan's out-of-band remainder — shared by
    the banded and banded_fused candidates (both ride the same lanes)."""
    if s.rem_mode == "gather":
        return cg * (s.remainder_edges + N)  # + unpermute gather
    if s.rem_mode == "benes":
        P = float(s.rem_ns_plan.P)
        cost = len(s.rem_ns_plan.stages.dists) * P
        return cost + len(s.rem_unperm_plan.stages.dists) \
            * float(s.rem_unperm_plan.stages.n)
    return 0.0


def _aot_costs(topo, cfg, plan, candidates, device) -> dict:
    """Replace analytic predictions with the bytes a round of each
    candidate's program moves, counted on ``device`` (one round from a
    fresh state; :func:`~flow_updating_tpu_torch.obs.profile.
    profile_program` without the timed run).  A candidate that refuses
    the graph (the ``ValueError`` a program raises for a shape it does not
    take) ranks last, its error recorded; a kernel that fails to build,
    load or launch raises, as it does everywhere else."""
    from flow_updating_tpu_torch.obs.profile import profile_program

    out = {}
    for cand in candidates:
        kernel, _, impl = cand.partition("/")
        try:
            if kernel == "node":
                from flow_updating_tpu_torch.models import sync

                c = dataclasses.replace(cfg, kernel="node", spmv=impl)
                k = sync.NodeKernel(topo, c, plan=plan, device=device)
                fn, args, nd = k.round_program(k.init_state(), 1)
            else:
                from flow_updating_tpu_torch.models.rounds import run_rounds
                from flow_updating_tpu_torch.models.state import init_state

                c = dataclasses.replace(cfg, kernel="edge")
                arrays = topo.device_arrays(coloring=c.needs_coloring,
                                            device=device)
                fn, args, nd = (run_rounds,
                                (init_state(topo, c, device=device),
                                 arrays, c, 1), 1)
            rec = profile_program(fn, args, n_dynamic=nd, execute=False,
                                  label=f"plan:{cand}", device=device,
                                  rounds=1)
            bytes_ = rec["cost"].get("bytes_accessed")
            out[cand] = float(bytes_) if bytes_ else float("inf")
        except ValueError as exc:  # a candidate that refuses the graph
            out[cand] = float("inf")
            out[f"{cand}#error"] = f"{type(exc).__name__}: {exc}"[:200]
    return out


def _analytic_costs(topo, plan: ExecutionPlan | None, backend: str,
                    candidates) -> dict:
    """Predicted per-round cost in streamed-element-pass units."""
    N = float(topo.num_nodes)
    E = float(topo.num_edges)
    cg = GATHER_COST.get(backend, DEFAULT_GATHER_COST)
    out = {}
    for cand in candidates:
        if cand == "node/structured":
            out[cand] = 4.0 * N
        elif cand == "node/xla":
            # bucketed gather of E neighbor slots + elementwise recurrence
            out[cand] = cg * E + 6.0 * N
        elif cand == "node/banded":
            s = plan.spmv
            out[cand] = (3.0 * len(s.offsets) * N + 6.0 * N
                         + _remainder_cost(s, cg, N))
        elif cand == "node/banded_fused":
            # the one-kernel round: band lanes read their operands from
            # the tile window, so memory traffic collapses to ~one read
            # and write of the state planes plus the bitpacked masks; the
            # remainder rides the same lanes as node/banded
            s = plan.spmv
            out[cand] = ((12.0 + len(s.offsets) / 8.0) * N
                         + _remainder_cost(s, cg, N))
        elif cand == "node/benes":
            from flow_updating_tpu_torch.ops.permute import next_pow2

            P = float(next_pow2(int(E + N + 1)))
            out[cand] = (3 * np.log2(max(P, 2)) + 2) * P + 6.0 * N
        elif cand == "edge/gather":
            # ~a dozen streamed passes over (E,) state + 3 edge gathers
            out[cand] = 12.0 * E + 3.0 * cg * E
        else:
            raise ValueError(f"unknown candidate {cand!r}")
    return out


def select_halo_mode(plan, *, backend: str | None = None,
                     dtype_bytes: int = 4, mesh=None) -> dict:
    """Rank the halo kernel's cut-edge exchange modes for a built
    :class:`~flow_updating_tpu_torch.parallel.sharded.ShardPlan`: each
    mode pays its wire bytes plus a per-collective overhead, and the
    overlap schedule is credited with the share of the wire the interior
    can hide (saturating once the intra-shard edges exceed
    :data:`OVERLAP_HIDE_RATIO` times the cut).  Ties go to the simpler
    serialized mode.

    ``mesh`` (a :class:`~flow_updating_tpu_torch.parallel.mesh.Mesh` or
    its device list): when every shard sits on one device there is no
    wire to hide, so the overlap schedule is credited with no hiding and
    the tie goes to the serialized mode; a mesh over more than one device
    (or none given) keeps the byte ranking unchanged.  Returns the chosen
    ``halo`` with its evidence; ``backend`` (default: the mesh's device
    type, else ``cuda`` when a card is visible) is recorded."""
    devices = None
    if mesh is not None:
        devices = tuple(getattr(mesh, "devices", mesh))
    backend = _backend_name(backend, devices[0] if devices else None)
    rep = plan.collective_bytes_per_round(dtype_bytes)
    cut = rep["cut_edges"]
    intra = plan.topo.num_edges - cut
    n_off = max(rep["num_offsets"], 1)
    if cut == 0:
        return {"halo": "ppermute", "backend": backend,
                "cut_edges": 0, "intra_edges": intra,
                "predicted_effective_bytes": {},
                "reason": "no cut edges: nothing on the wire, the "
                          "point-to-point path compiles to no collective"}
    hide = float(min(1.0, intra / (cut * OVERLAP_HIDE_RATIO)))
    one_device = devices is not None and len(set(devices)) == 1
    ranked_hide = 0.0 if one_device else hide
    predicted = {
        "allgather": rep["allgather_bytes"] + 3 * HALO_LATENCY_BYTES,
        "ppermute": rep["ppermute_bytes"] + n_off * HALO_LATENCY_BYTES,
        "overlap": (rep["ppermute_bytes"] * (1.0 - ranked_hide)
                    + n_off * HALO_LATENCY_BYTES),
    }
    order = ("allgather", "ppermute", "overlap")  # ties -> simpler mode
    best = min(order, key=lambda k: predicted[k])
    reason = (f"{best} cheapest: cut={cut} edge payloads "
              f"({rep['ppermute_bytes']} B point-to-point, "
              f"{rep['allgather_bytes']} B broadcast) over "
              f"{n_off} offset(s); ")
    if one_device:
        reason += (f"every shard sits on {devices[0]}: the blocks never "
                   "cross a wire, so overlap hides nothing (the byte "
                   f"ranking alone would credit it {100 * hide:.0f}%) and "
                   "the tie goes to the serialized mode")
    else:
        reason += (f"interior {intra} edges hides {100 * hide:.0f}% of "
                   "the wire under overlap")
    out = {
        "halo": best,
        "backend": backend,
        "cut_edges": cut,
        "intra_edges": intra,
        "hide_fraction": round(ranked_hide, 3),
        "predicted_effective_bytes": {k: round(v, 1)
                                      for k, v in predicted.items()},
        "reason": reason,
    }
    if one_device:
        out["one_device"] = True
        out["wire_hide_fraction"] = round(hide, 3)
    return out


#: per-round control-plane cost of one edge-kernel round, in streamed
#: edge-element-pass units — the payload-independent work (firing masks,
#: delivery selects, segment folds on the scalar control arrays) that
#: every underlying round pays whatever its payload width
CONTROL_LANES_EQUIV = 64.0

#: per-visit overhead of the chunked schedule's machinery, in
#: payload-lane-pass units per visit — amortized by rounds_per_visit
CHUNK_VISIT_LANES_EQUIV = 192.0


def select_payload_schedule(topo, *, features: int,
                            backend: str | None = None,
                            dtype_bytes: int = 4,
                            chunk: int | None = None,
                            rounds_per_visit: int | None = None,
                            anchor_features: int = 64,
                            max_round_bytes: float | None = None) -> dict:
    """The payload-bytes term of plan='auto' for deep-payload runs: rank
    the chunked pipelined schedule against the monolithic one from the
    edge count and payload bytes
    (:func:`~flow_updating_tpu_torch.obs.profile.payload_bytes_per_round`)
    and pick the chunk width / visit length that maximizes predicted
    per-lane throughput relative to the anchor width (the JAX package's
    model: one round of width ``w`` costs ``E * (w +
    CONTROL_LANES_EQUIV)`` lane-passes plus the chunked schedule's
    per-visit overhead amortized over ``rounds_per_visit``).
    ``max_round_bytes`` excludes schedules whose per-round wire window
    exceeds it; explicit ``chunk`` / ``rounds_per_visit`` pin those
    knobs.  The chunked schedule itself runs on the edge kernel, ROADMAP
    A13; this ranking only records how it would rank."""
    backend = _backend_name(backend)
    from flow_updating_tpu_torch.obs.profile import payload_bytes_per_round

    E = float(topo.num_edges)
    a = float(anchor_features)

    def visit_cost(w, rpv):
        return E * (w + CONTROL_LANES_EQUIV
                    + CHUNK_VISIT_LANES_EQUIV / max(rpv, 1))

    anchor_cost = E * (a + CONTROL_LANES_EQUIV)

    def lane_throughput(w, rpv, chunked):
        cost = visit_cost(w, rpv) if chunked else E * (w
                                                       + CONTROL_LANES_EQUIV)
        return (anchor_cost / a) / (cost / w)

    if features <= anchor_features:
        return {
            "schedule": "monolithic", "chunk": None,
            "rounds_per_visit": None, "backend": backend,
            "predicted_lane_throughput": {"monolithic": round(
                lane_throughput(features, 1, False), 3)},
            "bytes": payload_bytes_per_round(
                topo.num_edges, features, dtype_bytes=dtype_bytes),
            "reason": (f"D={features} <= anchor {anchor_features}: "
                       "nothing to pipeline"),
        }
    rpv_grid = ([int(rounds_per_visit)] if rounds_per_visit
                else [1, 4, 8, 16])
    if chunk:
        c_grid = [int(chunk)]
    else:
        c_grid = [c for c in (64, 128, 256, 512)
                  if c < features and features % c == 0]

    def fits(w):
        return max_round_bytes is None or E * w * dtype_bytes \
            <= max_round_bytes

    predicted = {"monolithic": lane_throughput(features, 1, False)}
    if chunk:
        best_key, best_eff, best = None, -1.0, None
    elif fits(features):
        best_key, best_eff, best = ("monolithic",
                                    predicted["monolithic"], None)
    else:
        predicted["monolithic#excluded"] = (
            f"{int(E * features * dtype_bytes)} B/round exceeds the "
            f"{int(max_round_bytes)} B wire window")
        best_key, best_eff, best = None, -1.0, None
    for c in c_grid:
        if not fits(c):
            predicted[f"chunked_c{c}#excluded"] = "over wire window"
            continue
        for rpv in rpv_grid:
            eff = lane_throughput(c, rpv, True)
            key = f"chunked_c{c}_rpv{rpv}"
            predicted[key] = eff
            if eff > best_eff:
                best_key, best_eff, best = key, eff, (c, rpv)
    if best_key is None:
        raise ValueError(
            f"no payload schedule fits max_round_bytes="
            f"{max_round_bytes} (smallest candidate chunk moves "
            f"{int(E * min(c_grid or [features]) * dtype_bytes)} B)")
    chosen_chunk, chosen_rpv = best if best else (None, None)
    bytes_rep = payload_bytes_per_round(
        topo.num_edges, features, chunk=chosen_chunk,
        dtype_bytes=dtype_bytes)
    return {
        "schedule": "chunked" if best else "monolithic",
        "chunk": chosen_chunk,
        "rounds_per_visit": chosen_rpv,
        "backend": backend,
        "predicted_lane_throughput": {k: (round(v, 3)
                                          if isinstance(v, float) else v)
                                      for k, v in predicted.items()},
        "bytes": bytes_rep,
        "reason": (
            f"{best_key} maximizes predicted per-lane throughput "
            f"({best_eff:.2f}x the D={anchor_features} anchor): each "
            f"underlying round moves {bytes_rep['bytes_per_round']} B "
            f"over {topo.num_edges} directed edges instead of "
            f"{topo.num_edges * features * dtype_bytes} B monolithic; "
            f"control plane ~{CONTROL_LANES_EQUIV:.0f} lane-equivalents "
            "amortized per visit"),
    }


# ---------------------------------------------------------------------
# measured-probe autotune cache: band width x tile x remainder route,
# timed on the engine's device, persisted keyed by (plan hash, device,
# torch and CUDA versions, dtype)
# ---------------------------------------------------------------------

#: cache file override (tests point it at a temporary directory)
AUTOTUNE_CACHE_ENV = "FLOW_UPDATING_AUTOTUNE_CACHE"
#: '0' disables measured probing entirely (analytic ranking only)
AUTOTUNE_ENV = "FLOW_UPDATING_AUTOTUNE"
#: plan='auto' probes only above this node count: probing costs a few
#: candidate builds, worth paying exactly when the round is expensive
AUTOTUNE_MIN_NODES = 4096

#: timing probes run since import — the cache-hit contract ("a second
#: select_plan call runs ZERO probes") is pinned on it
PROBE_COUNT = 0

#: persisted-cache traffic since import, the observable twin of the
#: probe-count contract: a hit shows here AND as ``probes_run == 0``
AUTOTUNE_CACHE_STATS = {"hits": 0, "misses": 0}

#: rounds per timing probe (one warm run + this many timed rounds)
PROBE_ROUNDS = 16

#: once a candidate's warm run alone exceeds this, its rate is taken
#: from that run instead of a second timed pass
PROBE_BUDGET_S = 20.0

#: timed passes per probe, the median rate counts: at a million nodes a
#: round takes well under a millisecond of host launches on the card,
#: and one 16-round pass swung by 25% between two candidates that time
#: alike (barabasi_albert(1e6, 4), chip_smoke.py L2)
PROBE_REPEATS = 3

#: each probe keeps running warm passes for at least this long before it
#: times: the first probe after the plan's host build otherwise meets an
#: idle card and a cold host, and reads slow against the ones after it
PROBE_WARM_S = 0.25

#: passes of the head-to-head race that ranks the node candidates after
#: the probe grid: the best banded and the best fused configuration and
#: node/xla, built and warmed together, then timed in turn in every pass
#: (each pass starting one candidate further on).  On the H100 these
#: rounds are host-bound (46-53 launches, 0.33 device ms, 0.5-1.2 wall ms
#: at 1 M nodes) and the host's pace swings by +-20% from one timing to
#: the next: five passes let two routes 10% apart read in either order
H2H_PASSES = 60

#: largest (padded rows x widest remainder row) index table the 'inline'
#: remainder route is probed with: it pads every row to the widest
#: remainder row, so a hub-heavy graph (barabasi_albert at 1e6 nodes: rows
#: of thousands of neighbors) would need gigabytes of indices — the probe
#: records the route as skipped instead
INLINE_MAX_SLOTS = 1 << 25

#: the opt-in roofline annotation of a fresh probe record
#: (obs/roofline.py)
ROOFLINE_ENV = "FLOW_UPDATING_ROOFLINE"


def autotune_cache_path() -> str:
    env = os.environ.get(AUTOTUNE_CACHE_ENV)
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache",
                        "flow_updating_tpu_torch", "autotune.json")


def _device_tag(device) -> str:
    """``type|device name|torch<ver>|cuda<ver>``: a record measured on one
    card, driver stack or host never steers another."""
    import torch

    dev = torch.device(device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    return (f"{dev.type}|{name}|torch{torch.__version__}|"
            f"cuda{torch.version.cuda}")


def _autotune_key(topo, device, features: int, *, max_lanes: int,
                  min_fill, remainder: str, dtype: str) -> str:
    """Cache key: the probed device (type, name, torch and CUDA versions)
    x plan content hash x the probe configuration (payload dtype and the
    plan-shaping knobs).  Any mismatch is a stale entry that re-probes."""
    from flow_updating_tpu_torch.plan.compile import _topo_key

    tk = _topo_key(topo)
    mf = "auto" if min_fill is None else f"{float(min_fill):g}"
    return (f"v1|{_device_tag(device)}|"
            f"n{tk[0]}e{tk[1]}|{tk[2][:16]}|f{int(features)}|"
            f"ml{int(max_lanes)}|mf{mf}|rem{remainder}|dt{dtype}")


def _load_autotune_cache(path: str) -> dict:
    try:
        with open(path) as fh:
            doc = json.load(fh)
        return doc if isinstance(doc, dict) else {}
    except (OSError, ValueError):
        return {}


def _store_autotune_entry(path: str, key: str, entry: dict) -> None:
    """Read-modify-write of the cache file through a temp file and
    ``os.replace`` (a reader never sees a half-written file)."""
    cache = _load_autotune_cache(path)
    cache[key] = entry
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as fh:
        json.dump(cache, fh, indent=1, sort_keys=True)
    os.replace(tmp, path)


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _probe_rate(kernel_factory, rounds: int) -> float:
    """Build and warm one candidate (for at least :data:`PROBE_WARM_S`),
    then time ``rounds`` rounds :data:`PROBE_REPEATS` times — the median
    rounds/s on the kernel's device (the card synchronized around each
    run).  Every call counts one probe."""
    global PROBE_COUNT

    PROBE_COUNT += 1
    kern = kernel_factory()
    state = kern.init_state()
    t0 = time.perf_counter()
    kern.run(state, rounds)          # first launches build the kernels
    _sync(kern.device)
    warm_s = time.perf_counter() - t0
    if warm_s > PROBE_BUDGET_S:
        return rounds / warm_s
    while time.perf_counter() - t0 < PROBE_WARM_S:
        kern.run(state, rounds)
        _sync(kern.device)
    rates = []
    for _ in range(PROBE_REPEATS):
        t0 = time.perf_counter()
        kern.run(state, rounds)
        _sync(kern.device)
        rates.append(rounds / max(time.perf_counter() - t0, 1e-9))
    return float(np.median(rates))


def _head_to_head(factories: dict, rounds: int) -> dict:
    """Rounds/s of each candidate (``{label: kernel factory}``) timed
    against the others: all built and warmed (each for at least
    :data:`PROBE_WARM_S`), then :data:`H2H_PASSES` passes of ``rounds``
    rounds in which every candidate runs once, in turn (a rotating
    order, so no candidate always follows the same one).  A candidate's
    rate is the median pass's: the median of its times over their pass's
    geometric mean, times the median pass's mean.  The grid's
    rates are each the best of several probes taken at different times,
    and on a host-bound round the best of many noisy readings of one
    family beats the best of few of another (the fused family has the
    most configurations); these rates are taken alike, together.  Every
    candidate counts one probe."""
    global PROBE_COUNT

    kerns = {}
    for label, make in factories.items():
        PROBE_COUNT += 1
        kern = make()
        state = kern.init_state()
        t0 = time.perf_counter()
        while True:
            kern.run(state, rounds)
            _sync(kern.device)
            if time.perf_counter() - t0 >= PROBE_WARM_S:
                break
        kerns[label] = (kern, state)
    secs = {label: [] for label in kerns}
    order = list(kerns.items())
    for i in range(H2H_PASSES):
        k = i % len(order)
        for label, (kern, state) in order[k:] + order[:k]:
            t0 = time.perf_counter()
            kern.run(state, rounds)
            _sync(kern.device)
            secs[label].append(max(time.perf_counter() - t0, 1e-9))
    # each time against its pass's geometric mean, so a slow stretch of
    # the host that spans a pass cancels out of the ranking
    table = np.array(list(secs.values()))
    scale = np.exp(np.log(table).mean(axis=0))
    typical = float(np.median(scale))
    return {label: rounds / (float(np.median(row / scale)) * typical)
            for label, row in zip(secs, table)}


def _fused_tile_candidates(plan) -> list:
    """Tile heights worth probing for one plan: the heuristic default
    and a 4x coarser tile when it is still under half the array."""
    from flow_updating_tpu_torch.ops.fused_round import choose_block_rows

    H = max((abs(d) for d in plan.spmv.offsets), default=0)
    base = choose_block_rows(plan.spmv.n, H)
    cands = [base]
    if base * 4 * 128 < plan.spmv.n * 2:
        cands.append(base * 4)
    return sorted(set(cands))


def autotune_fused(topo, cfg, *, backend: str | None = None,
                   features: int = 0, max_lanes: int = 96,
                   min_fill: float | None = None,
                   remainder: str = "auto",
                   cache_path: str | None = None,
                   force: bool = False, device=None) -> dict:
    """Measured-probe autotune for the banded family: time the unfused
    banded executor and the one-kernel fused round (kernel K2) over the
    band-width (``min_fill``) x tile x remainder-route grid on
    ``device`` (default: the card), and persist the record.  A cache hit
    returns the stored record with ``probes_run == 0``.  A candidate
    that fails to build or launch is recorded under its label's
    ``#error`` key, never timed on another device.

    The grid's best configuration of each family is then raced head to
    head with ``node/xla`` (:func:`_head_to_head`): the record's
    ``measured_rounds_per_sec`` block holds those rates under
    :func:`select_plan`'s candidate labels (``node/banded``,
    ``node/banded_fused``, ``node/xla``), so ``doctor``'s
    ``plan_selection`` check can judge the decision offline, and
    ``best`` is the faster of the two raced configurations."""
    from flow_updating_tpu_torch.models import sync
    from flow_updating_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    backend = _backend_name(backend, dev)
    path = cache_path or autotune_cache_path()
    cg = GATHER_COST.get(backend, DEFAULT_GATHER_COST)
    if remainder == "auto":
        # the port's 'auto' plans the gather remainder (plan/banded.py)
        remainder = "gather"
    # keyed on the device the probes time, whatever cost model asked
    key = _autotune_key(topo, dev, features, max_lanes=max_lanes,
                        min_fill=min_fill, remainder=remainder,
                        dtype=str(cfg.dtype))
    if not force:
        hit = _load_autotune_cache(path).get(key)
        if isinstance(hit, dict) and "measured_rounds_per_sec" in hit:
            AUTOTUNE_CACHE_STATS["hits"] += 1
            return {**hit, "probes_run": 0, "cache": "hit"}
    AUTOTUNE_CACHE_STATS["misses"] += 1
    base_fill = min_fill if min_fill is not None \
        else float(np.clip(3.0 / cg, 1.0 / 64.0, 0.75))
    # band-width axis: the selector's fill plus one coarser band set
    # (fewer lanes, fatter remainder) when it changes the plan
    fills = sorted({round(float(base_fill), 6),
                    round(float(min(0.75, base_fill * 8)), 6)})
    probes = 0
    candidates: dict = {}
    best = None
    cfg_b = dataclasses.replace(cfg, kernel="node", spmv="banded")
    cfg_f = dataclasses.replace(cfg, kernel="node", spmv="banded_fused")
    plans = {}
    for mf in fills:
        plan = compile_topology(topo, max_lanes=max_lanes, min_fill=mf,
                                remainder=remainder, features=features)
        sig = (len(plan.spmv.offsets), plan.spmv.rem_mode)
        if sig in plans:
            continue        # a coarser fill that changed nothing
        plans[sig] = (mf, plan)
    for mf, plan in plans.values():
        label_b = f"node/banded[min_fill={mf}]"
        rate = _probe_rate(
            lambda plan=plan: sync.NodeKernel(topo, cfg_b, plan=plan,
                                              device=dev),
            PROBE_ROUNDS)
        probes += 1
        candidates[label_b] = rate
        if best is None or rate > best[0]:
            best = (rate, "banded", mf, None, None)
        routes = ["lanes"]
        if plan.spmv.rem_mode == "gather":
            routes.append("inline")
            width = max((w for _, w in plan.spmv.rem_bucket_shapes),
                        default=0)
            if plan.spmv.n * width > INLINE_MAX_SLOTS:
                routes.remove("inline")
                candidates[f"node/banded_fused[min_fill={mf},rem=inline]"
                           "#skipped"] = (
                    f"{plan.spmv.n} rows x {width} slots of in-kernel "
                    f"gather indices exceed INLINE_MAX_SLOTS "
                    f"({INLINE_MAX_SLOTS})")
        if plan.spmv.rem_mode == "none":
            routes = ["auto"]
        for tile in _fused_tile_candidates(plan):
            for route in routes:
                label = (f"node/banded_fused[min_fill={mf},tile={tile},"
                         f"rem={route}]")
                try:
                    rate = _probe_rate(
                        lambda plan=plan, tile=tile, route=route:
                        sync.NodeKernel(topo, cfg_f, plan=plan,
                                        fused_tile=tile,
                                        fused_remainder=route, device=dev),
                        PROBE_ROUNDS)
                except (ValueError, RuntimeError) as exc:
                    candidates[f"{label}#error"] = \
                        f"{type(exc).__name__}: {exc}"[:160]
                    continue
                probes += 1
                candidates[label] = rate
                if rate > best[0]:
                    best = (rate, "banded_fused", mf, tile, route)
    # the best configuration of each family by the grid, raced again
    # head to head with node/xla: these rates rank the node candidates
    best_b = max(((v, k) for k, v in candidates.items()
                  if isinstance(v, (int, float))
                  and k.startswith("node/banded[")), default=None)
    best_f = max(((v, k) for k, v in candidates.items()
                  if isinstance(v, (int, float))
                  and k.startswith("node/banded_fused[")), default=None)
    by_fill = {mf: plan for mf, plan in plans.values()}

    def _knobs(label):
        kv = dict(part.split("=") for part in
                  label[label.index("[") + 1:-1].split(","))
        return (float(kv["min_fill"]),
                int(kv["tile"]) if "tile" in kv else None, kv.get("rem"))

    factories = {}
    if best_b is not None:
        mf_b = _knobs(best_b[1])[0]
        factories["node/banded"] = lambda: sync.NodeKernel(
            topo, cfg_b, plan=by_fill[mf_b], device=dev)
    if best_f is not None:
        mf_f, tile_f, rem_f = _knobs(best_f[1])
        factories["node/banded_fused"] = lambda: sync.NodeKernel(
            topo, cfg_f, plan=by_fill[mf_f], fused_tile=tile_f,
            fused_remainder=rem_f, device=dev)
    factories["node/xla"] = lambda: sync.NodeKernel(
        topo, dataclasses.replace(cfg, kernel="node", spmv="xla"),
        device=dev)
    raced = _head_to_head(factories, PROBE_ROUNDS)
    probes += len(factories)
    if best_f is not None and best_b is not None:
        winner = best_f if raced["node/banded_fused"] \
            > raced["node/banded"] else best_b
        mf, tile, rem = _knobs(winner[1])
        best = ((raced["node/banded_fused"], "banded_fused", mf, tile, rem)
                if winner is best_f else
                (raced["node/banded"], "banded", mf, None, None))
    entry = {
        "key": key,
        "backend": backend,
        # the remainder route the probe plans were compiled with — the
        # consumer ships a plan of the same family
        "remainder": remainder,
        "probe_rounds": PROBE_ROUNDS,
        "candidates": {k: (round(v, 3) if isinstance(v, float) else v)
                       for k, v in candidates.items()},
        "measured_rounds_per_sec": {
            k: round(v, 3) for k, v in raced.items() if v > 0},
        "best": {
            "spmv": "banded_fused" if best[1] == "banded_fused"
            else "banded",
            "min_fill": best[2],
            "fused_tile": best[3],
            "fused_remainder": best[4],
            "rounds_per_sec": round(best[0], 3),
        },
        "probes_run": probes,
    }
    _annotate_roofline(entry, raced, factories, dev)
    _store_autotune_entry(path, key, entry)
    return {**entry, "cache": "miss"}


def _annotate_roofline(entry: dict, raced: dict, factories: dict,
                       device) -> None:
    """Attach a perf-lens block to a fresh autotune record: each raced
    banded family's candidate is counted once more over
    :data:`PROBE_ROUNDS` rounds (no extra timed run) and its raced rate
    reconciled against the device's roofline ceiling.  Opt-in via
    ``FLOW_UPDATING_ROOFLINE`` and contained — a lens failure never loses
    the probe record."""
    from flow_updating_tpu_torch.obs import roofline as _roof

    fams = [f for f in ("node/banded", "node/banded_fused")
            if f in factories and raced.get(f)]
    if not _roof.enabled() or not fams:
        return
    try:
        from flow_updating_tpu_torch.obs.profile import profile_program

        model = _roof.resolve_model(device)
        programs = []
        fracs = {}
        for fam in fams:
            kern = factories[fam]()
            fn, fargs, nd = kern.round_program(kern.init_state(),
                                               PROBE_ROUNDS)
            rec = profile_program(fn, fargs, n_dynamic=nd, execute=False,
                                  label=f"autotune/{fam}", device=device,
                                  rounds=PROBE_ROUNDS)
            rl = _roof.reconcile(
                _roof.analyze(rec, model, rounds=PROBE_ROUNDS,
                              mode=f"autotune/{fam}"),
                raced[fam])
            programs.append(rl)
            if rl.get("roofline_frac") is not None:
                fracs[fam] = rl["roofline_frac"]
        entry["roofline"] = _roof.perf_lens_block(programs, model)
        if fracs:
            entry["roofline_frac"] = fracs
    except KernelError:           # a kernel fault is no lens error
        raise
    except Exception as exc:      # noqa: BLE001 — lens must not break probes
        entry["roofline_error"] = f"{type(exc).__name__}: {exc}"[:160]


def autotune_metrics(registry, record: dict | None = None) -> None:
    """Export the autotune cache counters (and, when a record is given,
    its per-family measured rates and roofline fracs) into a
    :class:`~flow_updating_tpu_torch.obs.metrics.MetricsRegistry` — the
    Prometheus face of the measured-probe cache."""
    registry.set_counter("autotune_cache_hits_total",
                         AUTOTUNE_CACHE_STATS["hits"])
    registry.set_counter("autotune_cache_misses_total",
                         AUTOTUNE_CACHE_STATS["misses"])
    registry.set_counter("autotune_probes_total", PROBE_COUNT)
    if not isinstance(record, dict):
        return

    def _slug(s: str) -> str:
        return "".join(c if c.isalnum() else "_" for c in s).strip("_")

    for label, rate in (record.get("measured_rounds_per_sec")
                        or {}).items():
        if isinstance(rate, (int, float)):
            registry.set_gauge(f"autotune_rate_{_slug(label)}",
                               float(rate))
    for label, frac in (record.get("roofline_frac") or {}).items():
        if isinstance(frac, (int, float)):
            registry.set_gauge(f"autotune_roofline_frac_{_slug(label)}",
                               float(frac))


def select_plan(topo, cfg, *, backend: str | None = None,
                features: int = 0, probe: str = "analytic",
                max_lanes: int = 96, min_fill: float | None = None,
                remainder: str = "auto",
                autotune: bool | None = None,
                device=None) -> PlanDecision:
    """Choose kernel/spmv for ``(topo, cfg, backend)``.

    Returns a :class:`PlanDecision`; ``decision.plan`` is the compiled
    :class:`ExecutionPlan` when the banded path won (or was a candidate),
    else None.  ``backend`` picks the cost model (default: ``device``'s
    type).  ``autotune=None`` probes the banded family on ``device`` when
    it is given, the graph has at least :data:`AUTOTUNE_MIN_NODES` nodes,
    ``FLOW_UPDATING_AUTOTUNE`` is not '0' and the backend is the device's
    own; ``autotune=True`` probes on ``device`` (default: the card).
    ``probe='aot'`` ranks the candidates by the bytes a round of each
    one's program moves, counted on ``device`` (default: the card;
    :func:`_aot_costs`)."""
    if probe not in ("analytic", "aot"):
        raise ValueError(f"unknown probe {probe!r}: use 'analytic' or "
                         "'aot'")
    backend = _backend_name(backend, device)
    if not cfg.is_fast_sync_collectall:
        # only the edge kernel implements these dynamics; there is one
        # correct program, nothing to rank
        return PlanDecision(
            kernel="edge", spmv=None, plan=None, backend=backend,
            predicted={}, reason=(
                "config requires the general edge kernel "
                f"(variant={cfg.variant!r}, fire_policy="
                f"{cfg.fire_policy!r}, drop_rate={cfg.drop_rate}); "
                "plan reordering stays available via "
                "plan.compile_topology for locality studies"))
    if topo.structure is not None and not features:
        return PlanDecision(
            kernel="node", spmv="structured", plan=None, backend=backend,
            predicted={}, reason=(
                "generator attached a closed-form structure descriptor "
                f"({type(topo.structure).__name__}): the exact stencil "
                "beats any banded emulation of itself"))
    if topo.virtual:
        raise ValueError(
            "cannot plan a virtual topology (no edge arrays); it only "
            "runs the structured stencil")
    cg = GATHER_COST.get(backend, DEFAULT_GATHER_COST)
    if min_fill is None:
        # lane economics: one roll lane costs ~3 streamed passes over the
        # n-vector and absorbs count_d edges of per-edge gather cost — the
        # break-even diagonal fill is 3/cg (clamped to sane bounds)
        min_fill = float(np.clip(3.0 / cg, 1.0 / 64.0, 0.75))
    # no backend of this package is gather-hostile (GATHER_COST < 100
    # throughout), so the JAX package's upgrade of the remainder to Beneš
    # lanes never applies: the remainder stays as asked ('auto' = gather)
    plan = compile_topology(topo, max_lanes=max_lanes, min_fill=min_fill,
                            remainder=remainder, features=features)
    candidates = ["node/banded", "node/banded_fused", "node/xla",
                  "edge/gather"]
    if probe == "aot":
        from flow_updating_tpu_torch.utils.device import resolve_device

        predicted = _aot_costs(topo, cfg, plan, candidates,
                               resolve_device(device))
    else:
        predicted = _analytic_costs(topo, plan, backend, candidates)

    # measured probes (cached): band width x tile x remainder route timed
    # on the engine's device — real rates replace the modeled
    # banded-family ranking when available
    if autotune is None:
        import torch

        autotune = (device is not None
                    and os.environ.get(AUTOTUNE_ENV, "1") != "0"
                    and topo.num_nodes >= AUTOTUNE_MIN_NODES
                    and backend == torch.device(device).type)
    tune = None
    if autotune:
        tune = autotune_fused(topo, cfg, backend=backend,
                              features=features, max_lanes=max_lanes,
                              min_fill=min_fill, remainder=remainder,
                              device=device)
        rates = tune.get("measured_rounds_per_sec", {})
        rb = rates.get("node/banded")
        for cand in ("node/banded_fused", "node/xla"):
            rc = rates.get(cand)
            if rb and rc and "node/banded" in predicted \
                    and cand in predicted:
                # re-anchor each raced candidate on its measured ratio to
                # banded, so the node family ranks as measured and stays
                # comparable with the analytic edge entry
                predicted[cand] = predicted["node/banded"] * rb / rc
                predicted[f"{cand}#measured"] = \
                    f"{rc:.4g} r/s vs banded {rb:.4g} r/s (raced)"
    numeric = [c for c in candidates
               if isinstance(predicted.get(c), (int, float))]
    best = min(numeric, key=lambda c: predicted[c])
    kernel, _, impl = best.partition("/")
    s = plan.spmv
    fused_kw = None
    if impl == "banded_fused":
        fused_kw = {"fused_tile": None, "fused_remainder": "auto"}
        if tune is not None and \
                tune.get("best", {}).get("spmv") == "banded_fused":
            fused_kw = {"fused_tile": tune["best"].get("fused_tile"),
                        "fused_remainder":
                        tune["best"].get("fused_remainder") or "auto"}
            mf = tune["best"].get("min_fill")
            # ship the plan the probes actually ran: the autotuner may
            # have probed another remainder family or band width than the
            # ranking plan
            probed_rem = tune.get("remainder", remainder)
            if (mf is not None and float(mf) != float(min_fill)) \
                    or probed_rem != remainder:
                plan = compile_topology(
                    topo, max_lanes=max_lanes,
                    min_fill=float(mf) if mf is not None else min_fill,
                    remainder=probed_rem, features=features)
                s = plan.spmv
    fused_doc = None
    if tune is not None:
        fused_doc = {k: tune[k] for k in
                     ("backend", "remainder", "candidates",
                      "measured_rounds_per_sec", "best", "probes_run",
                      "probe_rounds", "roofline", "roofline_frac",
                      "roofline_error")
                     if k in tune}
        fused_doc["cache"] = tune.get("cache")
    if fused_kw is not None:
        fused_doc = dict(fused_doc or {})
        fused_doc["chosen"] = fused_kw
    return PlanDecision(
        kernel=kernel, spmv=impl if kernel == "node" else None,
        plan=plan,  # losers keep the plan attached: stats feed manifests
        backend=backend, predicted=predicted,
        fused=fused_doc,
        reason=(f"{best} "
                + ("measured fastest" if tune is not None
                   and best in ("node/banded", "node/banded_fused",
                                "node/xla")
                   else "predicted cheapest")
                + f" on {backend} "
                f"(bands cover {100 * s.coverage:.1f}% of edges in "
                f"{len(s.offsets)} lane(s), remainder via "
                f"{s.rem_mode}; bandwidth "
                f"{plan.stats['bandwidth_before']} -> "
                f"{plan.stats['bandwidth_after']} after RCM)"),
    )
