"""The curated scenario registry: adversarial and poorly-connected cases.

Counterpart of ``flow_updating_tpu/scenarios/registry.py``: the same
names, configs, signatures and constructions, on the port's generators.

Every benchmark graph elsewhere in the repo is well-connected and every
node honest; this registry holds the HARD cases the roadmap names — the
conductance-bottleneck bridge whose spreading time is governed by the
cut, not the node count (arXiv:1104.2944), Byzantine nodes lying on the
wire, corrupted flow ledgers, silent droppers, and correlated link
failure (partition a community, then heal).  Each :class:`Scenario`
bundles three things:

* a deterministic **construction** — topology (with planted-partition
  ground truth riding the metadata), per-seed node values (block-offset
  draws keep the bridge load-bearing: with i.i.d. values the blocks are
  pre-balanced and the cut is invisible), and an
  :class:`~flow_updating_tpu_torch.scenarios.adversary.Adversary` plan;
* a **config** — including the robust-aggregation modes
  (``RoundConfig.robust``: trimmed-mean / clipped-flow variants of the
  collect-all fire step; statically off they leave the round program
  bit-identical);
* a declared **expected observable signature** — conformance clauses
  (:data:`Scenario.signature`) the doctor judges a scenario manifest
  against (obs/health.check_scenario_conformance): convergence bounds,
  bias/mass bounds under attack, heal deadlines, cross-scenario
  convergence factors, and blame clauses asserting the planted
  adversary is localized at rank 1 (obs/inspect.blame_adversary).

Thresholds are calibrated against measured behavior of the reference
construction (documented per scenario); the conformance tests pin both
directions — each signature passes on its own run and FAILS on a
perturbed run (adversary removed, healing disabled).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from flow_updating_tpu_torch.scenarios.adversary import Adversary

#: Structural constants of the registry's community graph: 3 contiguous
#: 32-node blocks, dense inside (k_in = 8), connected ONLY by the two
#: guaranteed chain bridges (k_out = 0) — the conductance bottleneck.
COMMUNITY_N = 96
COMMUNITY_C = 3
_COMMUNITY_KW = dict(c=COMMUNITY_C, k_in=8.0, k_out=0.0, seed=0)


def block_values(membership: np.ndarray, seed: int) -> np.ndarray:
    """Per-seed node inputs with a +1.0 offset per community block.

    I.i.d. values leave every block's mean near the global mean, so
    nothing needs to cross the bridges and the bottleneck is invisible;
    the block offset plants ~``N/c`` units of mass imbalance per block,
    making the cut load-bearing (the registry's whole point) while the
    within-block draw still varies per seed."""
    rng = np.random.default_rng(seed)
    return (np.asarray(membership, np.float64)
            + rng.uniform(0.0, 1.0, membership.shape[0]))


def _community(seed: int):
    from flow_updating_tpu_torch.topology.generators import community

    topo = community(COMMUNITY_N, **_COMMUNITY_KW)
    return topo.with_values(block_values(topo.membership, seed))


def _community_uniform(seed: int):
    """The same community graph with i.i.d. uniform per-seed values —
    the Byzantine scenarios' base: honest equilibrium flow ledgers stay
    small (no planted bulk transfer), so clipped/trimmed robustness
    thresholds sit cleanly between honest dynamics and the attack."""
    from flow_updating_tpu_torch.topology.generators import community

    topo = community(COMMUNITY_N, **_COMMUNITY_KW)
    rng = np.random.default_rng(1000 + seed)
    return topo.with_values(rng.uniform(0.0, 1.0, COMMUNITY_N))


def _community_meta(topo) -> dict:
    return {
        "membership": [int(b) for b in topo.membership],
        "bridge_edges": [int(e) for e in topo.bridge_edges],
    }


def _expander(seed: int):
    """The same community graph augmented with two random perfect
    matchings over all nodes — the expander-augmented control: identical
    blocks and values, but the cut is no longer a bottleneck."""
    import dataclasses as _dc

    from flow_updating_tpu_torch.topology.graph import build_topology

    base = _community(seed)
    pairs = np.stack([base.src, base.dst], axis=1)
    pairs = pairs[pairs[:, 0] < pairs[:, 1]]
    rng = np.random.default_rng(7)           # structural, not per-seed
    extra = [rng.permutation(COMMUNITY_N).reshape(-1, 2) for _ in range(2)]
    topo = build_topology(COMMUNITY_N, np.concatenate([pairs] + extra),
                          values=base.values, seed=0,
                          warn_asymmetric=False)
    # membership still holds (augmentation adds edges, renames nothing)
    memb = base.membership
    bridge = np.flatnonzero(
        memb[topo.src] != memb[topo.dst]).astype(np.int64)
    return _dc.replace(topo, membership=memb, bridge_edges=bridge)


#: The planted Byzantine node / silent node of the registry's community
#: graph (block 0 interior) and the reported lie.
LIE_NODE = 5
SILENT_NODE = 7
LIE_VALUE = 100.0


def _corrupt_edge(topo) -> int:
    """First out-edge of node 3 — the planted wire-corruption site."""
    return int(np.flatnonzero(np.asarray(topo.src) == 3)[0])


def _block_bridges(topo, block: int) -> tuple:
    """All directed bridge edges touching ``block`` — cutting them
    isolates the block (k_out = 0 leaves no other path)."""
    memb = topo.membership
    src = np.asarray(topo.src)
    dst = np.asarray(topo.dst)
    return tuple(int(e) for e in topo.bridge_edges
                 if memb[src[e]] == block or memb[dst[e]] == block)


@dataclasses.dataclass(frozen=True)
class ScenarioCase:
    """One built instance of a scenario: the deterministic topology (node
    values already seeded in), the adversary plan, and the ground truth a
    conformance check verifies blame against."""

    topo: object
    adversary: Adversary | None
    ground_truth: dict


@dataclasses.dataclass(frozen=True)
class Scenario:
    """A registered scenario: construction + config + expected signature.

    ``config`` holds :class:`~flow_updating_tpu_torch.models.config.RoundConfig`
    keyword overrides applied on top of ``RoundConfig.fast()`` (the
    robust-aggregation modes live here); ``signature`` is the tuple of
    declarative conformance clauses (see
    :func:`flow_updating_tpu_torch.obs.health.check_scenario_conformance` for
    the vocabulary).  ``builder(seed)`` must be deterministic in
    ``seed``."""

    name: str
    summary: str
    builder: object
    signature: tuple
    rounds: int
    rmse_threshold: float = 1e-3
    config: dict = dataclasses.field(default_factory=dict)

    def build(self, seed: int = 0) -> ScenarioCase:
        case = self.builder(seed)
        if not isinstance(case, ScenarioCase):
            raise TypeError(
                f"scenario {self.name!r}: builder returned "
                f"{type(case).__name__}, expected ScenarioCase")
        return case

    def round_config(self):
        from flow_updating_tpu_torch.models.config import RoundConfig

        return RoundConfig.fast(**self.config)

    def describe(self) -> dict:
        """Manifest-grade record (everything but the built arrays)."""
        return {
            "name": self.name,
            "summary": self.summary,
            "rounds": int(self.rounds),
            "rmse_threshold": float(self.rmse_threshold),
            "config": dict(self.config),
            "signature": [dict(c) for c in self.signature],
        }


REGISTRY: dict = {}


def register(scn: Scenario) -> Scenario:
    if scn.name in REGISTRY:
        raise ValueError(f"scenario {scn.name!r} already registered")
    REGISTRY[scn.name] = scn
    return scn


def get_scenario(name: str) -> Scenario:
    if name not in REGISTRY:
        import difflib

        near = difflib.get_close_matches(name, REGISTRY, n=1)
        hint = f" (did you mean {near[0]!r}?)" if near else ""
        raise ValueError(
            f"unknown scenario {name!r}{hint}; registered: "
            f"{', '.join(sorted(REGISTRY))}")
    return REGISTRY[name]


def scenario_names() -> tuple:
    return tuple(REGISTRY)


# --------------------------------------------------------------------------
# the registry
# --------------------------------------------------------------------------

def _honest(seed):
    topo = _community(seed)
    return ScenarioCase(topo, None, _community_meta(topo))


def _honest_expander(seed):
    topo = _expander(seed)
    return ScenarioCase(topo, None, _community_meta(topo))


register(Scenario(
    name="bridge_bottleneck",
    summary="conductance-bottleneck community graph: 3 blocks joined "
            "only by 2 bridge edges; block-offset values force ~32 mass "
            "units across each cut",
    builder=_honest,
    rounds=800,
    # measured: converges at round ~252 at 1e-3 (seeds 0-2), vs ~48 for
    # the expander-augmented control — the cut, not N, sets the time
    signature=(
        {"check": "converges", "within": 500},
        {"check": "relative_rounds", "of": "expander_relief",
         "min_factor": 2.0, "max_factor": 10.0},
    ),
))

register(Scenario(
    name="expander_relief",
    summary="the same blocks + values with 2 random matchings added: "
            "the expander-augmented control the bridge case is judged "
            "against",
    builder=_honest_expander,
    rounds=200,
    signature=(
        {"check": "converges", "within": 100},   # measured: ~48
    ),
))


def _lie(seed):
    topo = _community_uniform(seed)
    adv = Adversary(lie_nodes=(LIE_NODE,), lie_value=LIE_VALUE)
    gt = {**_community_meta(topo), **adv.describe()}
    return ScenarioCase(topo, adv, gt)


register(Scenario(
    name="byzantine_lie",
    summary=f"node {LIE_NODE} reports {LIE_VALUE:g} in every message "
            "(state stays honest); no protection — the attack must "
            "visibly poison the average",
    builder=_lie,
    rounds=300,
    signature=(
        # measured: the poisoned consensus sits ~10 rmse off the mean
        {"check": "final_rmse_above", "value": 1.0},
        {"check": "blame", "symptom": "liar", "nodes": [LIE_NODE]},
    ),
))

register(Scenario(
    name="byzantine_lie_clip",
    summary="the same liar under robust='clip' (flow ledgers clamped to "
            "±0.5): displacement through any edge is bounded, so the "
            "bias is bounded by the clamp × degree, not the lie",
    builder=_lie,
    rounds=300,
    config={"robust": "clip", "robust_clip": 0.5},
    signature=(
        # measured: rmse ~0.9, |mass residual| ~= 2 x deg(liar) x clip
        # (deg 5 -> ~5.0); the unprotected run sits at rmse ~10 / 467
        {"check": "final_rmse_below", "value": 2.0},
        {"check": "mass_bounded", "value": 7.5},
        # the clamp bounds the poison but the anomaly still concentrates
        # on the liar's neighborhood — rank 1 through the clip, and an
        # adversary-free clipped run ranks someone else (negative
        # control discrimination)
        {"check": "blame", "symptom": "liar", "nodes": [LIE_NODE]},
    ),
))

register(Scenario(
    name="byzantine_lie_trim",
    summary="the same liar under robust='trim' (each armed node freezes "
            "its single highest/lowest neighbor out of the exchange): "
            "one extreme liar per neighborhood is excluded outright and "
            "the honest fixed point survives",
    builder=_lie,
    rounds=500,
    # robust_tol sits ABOVE the honest dynamic range (values in [0, 1],
    # lie at 100): honest neighborhoods never arm, the liar's always do
    config={"robust": "trim", "robust_tol": 2.0},
    signature=(
        {"check": "converges", "within": 450},   # measured: 109-168
        {"check": "mass_bounded", "value": 0.5},
        # the frozen-out lie stays pinned in the liar's in-view entries
        # while consensus tightens — the rank-1 tell
        {"check": "blame", "symptom": "pinned", "nodes": [LIE_NODE]},
    ),
))


def _corrupt(seed):
    topo = _community_uniform(seed)
    e = _corrupt_edge(topo)
    adv = Adversary(corrupt_edges=(e,), corrupt_gain=1.5)
    gt = {**_community_meta(topo), **adv.describe()}
    return ScenarioCase(topo, adv, gt)


register(Scenario(
    name="flow_corruption",
    summary="one edge's wire flow is scaled ×1.5 (the receiver's "
            "antisymmetry write no longer cancels the sender): an "
            "unprotected pair is a runaway amplifier",
    builder=_corrupt,
    rounds=120,    # gain^t grows without bound; 120 rounds stays finite
    signature=(
        {"check": "final_rmse_above", "value": 10.0},
        {"check": "blame", "symptom": "leak", "edge_of": "corrupt"},
    ),
))

register(Scenario(
    name="flow_corruption_clip",
    summary="the same corrupted wire under robust='clip': both ledger "
            "writes honor the clamp, the amplifier is cut and the run "
            "converges as if honest",
    builder=_corrupt,
    rounds=300,
    # robust_clip sits ABOVE the honest equilibrium |flow| (measured
    # <= 3.8 across seeds): honest convergence is never clipped, while
    # the x1.5 amplifier (unbounded growth) is cut at the clamp
    config={"robust": "clip", "robust_clip": 8.0},
    signature=(
        {"check": "converges", "within": 280},   # measured: 70-171
        {"check": "mass_bounded", "value": 0.5},
        # mid-run the wire gain mis-writes the receiver ledger by
        # 0.5 x f: the pair residual (2.5, vs 0.36 for the runner-up)
        # names the corrupted pair even though the clamp saves the run
        {"check": "blame", "symptom": "cut", "edge_of": "corrupt"},
    ),
))


def _silent(seed):
    topo = _community_uniform(seed)
    adv = Adversary(silent_nodes=(SILENT_NODE,))
    gt = {**_community_meta(topo), **adv.describe()}
    return ScenarioCase(topo, adv, gt)


register(Scenario(
    name="silent_node",
    summary=f"node {SILENT_NODE}'s sends vanish on the wire (its ledger "
            "updates regardless — a lost put): a liveness fault with "
            "bounded damage, localized as the worst straggler",
    builder=_silent,
    rounds=300,
    signature=(
        {"check": "final_rmse_above", "value": 0.005},
        {"check": "final_rmse_below", "value": 1.0},
        {"check": "blame", "symptom": "straggler",
         "nodes": [SILENT_NODE]},
    ),
))

#: Partition window of the ``partition_heal`` scenario (rounds).
PARTITION_FROM = 100
PARTITION_UNTIL = 200
PARTITION_BLOCK = 0


def _partition(seed):
    topo = _community(seed)
    cut = _block_bridges(topo, PARTITION_BLOCK)
    adv = Adversary(down_edges=cut, down_from=PARTITION_FROM,
                    down_until=PARTITION_UNTIL)
    gt = {**_community_meta(topo), **adv.describe(),
          "partition_block": PARTITION_BLOCK}
    return ScenarioCase(topo, adv, gt)


register(Scenario(
    name="partition_heal",
    summary=f"every bridge of block {PARTITION_BLOCK} goes down for "
            f"rounds [{PARTITION_FROM}, {PARTITION_UNTIL}): the block "
            "is fully partitioned, then the links heal — "
            "self-healing must restore conservation and convergence",
    builder=_partition,
    rounds=800,
    signature=(
        # measured: rmse plateaus ~0.05 during the cut, the first
        # post-heal exchanges restore the pair ledgers (residual 2.4e-3
        # within 50 rounds, 3e-5 by the end), convergence resumes
        {"check": "rmse_at_least", "round": PARTITION_UNTIL - 1,
         "value": 0.01},
        {"check": "mass_bounded", "value": 5e-3,
         "from_round": PARTITION_UNTIL + 150},
        {"check": "converges", "within": 600},
        {"check": "blame", "symptom": "cut", "edge_of": "down",
         "block": PARTITION_BLOCK},
    ),
))


def _asym(seed):
    import dataclasses as _dc

    topo = _community(seed)
    delay = np.asarray(topo.delay).copy()
    src, dst = np.asarray(topo.src), np.asarray(topo.dst)
    for e in topo.bridge_edges:
        if src[e] < dst[e]:
            delay[e] = 4               # forward slow, reverse fast
    t = _dc.replace(topo, delay=delay)
    gt = {**_community_meta(topo),
          "asym_edges": [int(e) for e in topo.bridge_edges
                         if src[e] < dst[e]]}
    return ScenarioCase(t, None, gt)


register(Scenario(
    name="asym_latency",
    summary="weighted/asymmetric links: each bridge takes 4 rounds one "
            "way, 1 the other — Flow-Updating must stay mass-conserving "
            "and converge through asymmetric delivery",
    builder=_asym,
    rounds=800,
    config={"delay_depth": 4},
    signature=(
        {"check": "converges", "within": 780},
        {"check": "mass_bounded", "value": 0.05},
    ),
))
