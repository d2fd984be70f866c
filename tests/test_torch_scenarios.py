"""The scenario conformance suite (``flow_updating_tpu_torch.scenarios``)
and ``Engine(adversary=)`` against the JAX package's.

Counterparts of ``tests/test_scenarios.py`` (the robust-mode tests there
belong to A3 and live in ``test_torch_robust.py``):

* the :class:`Adversary` spec (absence, refusals, structure keys, the
  device leaves equal to JAX's);
* each adversary family's trajectory against JAX's round at 1e-9 (float64,
  every wire family alone and together, collect-all fast and faithful,
  faithful pairwise), and the same adversary on the ``benes_fused``
  networks equal to ``benes`` bit for bit and to the ``segment``/``gather``
  trajectory; an absent or empty adversary runs exactly today's
  operations;
* ``Engine(adversary=)`` (bit-exact when empty, refused on the node
  kernel, fast pairwise and a mesh, with JAX's messages);
* the registry equal to JAX's: names, configs, signatures, and each case's
  topology arrays, values, adversary and ground truth for seeds 0 and 1;
* sweep buckets split by adversary structure, an adversarial lane equal to
  the single-device run;
* the conformance loop: every registered signature passes on its own run
  and fails under its perturbation (the whole registry, seeds 0 and 1),
  and both packages' ``doctor`` give equal verdicts on the port's
  manifests; blame names the silent node at rank 1; the ``scenarios``
  subcommand's exit codes.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax.numpy as jnp

from flow_updating_tpu.models.config import RoundConfig as JaxConfig
from flow_updating_tpu.models.rounds import run_rounds as jax_run
from flow_updating_tpu.models.state import init_state as jax_init
from flow_updating_tpu.obs import health as jhealth
from flow_updating_tpu.scenarios import Adversary as JaxAdversary
from flow_updating_tpu.scenarios import registry as jregistry
from flow_updating_tpu.scenarios import run_scenario as jax_run_scenario
from flow_updating_tpu.topology import generators as jgen
from flow_updating_tpu_torch import Engine, RoundConfig
from flow_updating_tpu_torch.cli import main as port_main
from flow_updating_tpu_torch.models import rounds
from flow_updating_tpu_torch.models.state import init_state, lane_state
from flow_updating_tpu_torch.obs import health
from flow_updating_tpu_torch.obs import inspect as obs_inspect
from flow_updating_tpu_torch.parallel.mesh import make_mesh
from flow_updating_tpu_torch.scenarios import (
    REGISTRY,
    Adversary,
    get_scenario,
    run_scenario,
    run_scenarios,
    scenario_manifest,
    scenario_names,
)
from flow_updating_tpu_torch.sweep import (
    SweepInstance,
    pack_instances,
    run_bucket,
)
from flow_updating_tpu_torch.topology import generators as pgen

TOL = dict(rtol=1e-9, atol=1e-9)
ADV_KW = {
    "lie": dict(lie_nodes=(1, 9), lie_value=7.5),
    "corrupt": dict(corrupt_edges=(0, 11), corrupt_gain=1.5),
    "silent": dict(silent_nodes=(3,)),
    "down": dict(down_edges=(2, 5, 30), down_from=30, down_until=56),
}
ADV_KW["all"] = {k: v for kw in ADV_KW.values() for k, v in kw.items()}
MODES = [("collectall", "every_round"), ("collectall", "reference"),
         ("pairwise", "reference")]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def graphs():
    return (jgen.community(32, c=2, k_in=6.0, k_out=0.0, seed=0),
            pgen.community(32, c=2, k_in=6.0, k_out=0.0, seed=0))


@pytest.fixture(scope="module")
def registry_run():
    """The whole registry, seeds 0 and 1, on the CPU (~15 s)."""
    return run_scenarios(seeds=(0, 1), device="cpu")


def _cfgs(variant, policy, **kw):
    make = "reference" if policy == "reference" else "fast"
    return (getattr(JaxConfig, make)(variant, dtype="float64", **kw),
            getattr(RoundConfig, make)(variant, dtype="float64", **kw))


def _port_arrays(topo, cfg, adv, **kw):
    arrays = topo.device_arrays(coloring=cfg.needs_coloring, device="cpu",
                                **kw)
    if adv is not None:
        arrays = arrays.replace(**adv.device_leaves(
            topo.num_nodes, topo.num_edges, cfg.torch_dtype, device="cpu"))
    return arrays


class _Ops(TorchDispatchMode):
    """Records the aten operations a call dispatches."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


# ---- the adversary spec ------------------------------------------------------

def test_adversary_defaults_are_absent():
    adv = Adversary()
    assert not adv
    assert adv.device_leaves(8, 16, torch.float32, device="cpu") == {}
    assert adv.structure_key() == (False, False, False, False)


def test_adversary_empty_down_window_rejected():
    with pytest.raises(ValueError, match="down window"):
        Adversary(down_edges=(1,), down_from=5, down_until=5)


def test_adversary_out_of_range_ids_rejected():
    adv = Adversary(lie_nodes=(9,), lie_value=1.0)
    with pytest.raises(ValueError, match="outside"):
        adv.device_leaves(8, 16, torch.float32, device="cpu")


@pytest.mark.parametrize("family", sorted(ADV_KW))
def test_adversary_leaves_equal_jax(family):
    adv, jadv = Adversary(**ADV_KW[family]), JaxAdversary(**ADV_KW[family])
    assert adv.structure_key() == jadv.structure_key()
    assert adv.describe() == jadv.describe()
    got = adv.device_leaves(40, 64, torch.float64, device="cpu")
    want = jadv.device_leaves(40, 64, jnp.float64)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v),
                                      err_msg=k)


def test_adversary_structure_key_families():
    adv = Adversary(lie_nodes=(1,), lie_value=2.0, silent_nodes=(3,))
    assert adv.structure_key() == (True, False, True, False)
    leaves = adv.device_leaves(8, 16, torch.float32, device="cpu")
    assert set(leaves) == {"adv_lie_mask", "adv_lie_value",
                           "adv_silent_mask"}
    assert bool(leaves["adv_lie_mask"][1])
    assert adv.describe() == {"lie": {"nodes": [1], "value": 2.0},
                              "silent": {"nodes": [3]}}


# ---- the adversary on the wire, against JAX ------------------------------------

@pytest.mark.parametrize("family", sorted(ADV_KW))
@pytest.mark.parametrize("variant,policy", MODES)
def test_adversary_trajectory_matches_jax(graphs, family, variant, policy):
    jt, pt = graphs
    jcfg, cfg = _cfgs(variant, policy, drop_rate=0.1)
    adv, jadv = Adversary(**ADV_KW[family]), JaxAdversary(**ADV_KW[family])
    R = 60
    got = rounds.run_rounds(init_state(pt, cfg, seed=3, device="cpu"),
                            _port_arrays(pt, cfg, adv), cfg, R)
    jarrays = jt.device_arrays().replace(**jadv.device_leaves(
        jt.num_nodes, jt.num_edges, jcfg.jnp_dtype))
    want = jax_run(jax_init(jt, jcfg, seed=3), jarrays, jcfg, R)
    for f in ("flow", "est", "last_avg", "buf_flow", "buf_est"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), err_msg=f,
                                   **TOL)
    for f in ("ticks", "fired", "stamp", "recv", "buf_valid",
              "pending_valid"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    honest = rounds.run_rounds(init_state(pt, cfg, seed=3, device="cpu"),
                               _port_arrays(pt, cfg, None), cfg, R)
    assert not torch.equal(got.flow, honest.flow)


@pytest.mark.parametrize("variant,policy", MODES)
def test_adversary_on_the_networks(graphs, variant, policy):
    """The masks ride the planned networks like every other broadcast
    (kernels B3 and B4 on the card): ``benes_fused`` equals ``benes`` bit
    for bit, and both give the ``segment``/``gather`` trajectory (the
    network sums add in another order)."""
    _, pt = graphs
    _, cfg = _cfgs(variant, policy)
    adv = Adversary(**ADV_KW["all"])
    plain = rounds.run_rounds(init_state(pt, cfg, seed=1, device="cpu"),
                              _port_arrays(pt, cfg, adv), cfg, 60)
    runs = {}
    for net, mode in (("benes", True), ("benes_fused", "fused")):
        ncfg = dataclasses.replace(cfg, segment_impl=net, delivery=net)
        arrays = _port_arrays(pt, ncfg, adv, segment_benes=mode,
                              delivery_benes=mode)
        runs[net] = rounds.run_rounds(
            init_state(pt, ncfg, seed=1, device="cpu"), arrays, ncfg, 60)
    for f in ("flow", "est", "ticks", "fired", "buf_flow", "last_avg"):
        assert torch.equal(getattr(runs["benes"], f),
                           getattr(runs["benes_fused"], f)), f
        torch.testing.assert_close(getattr(runs["benes"], f),
                                   getattr(plain, f), **TOL)


def test_absent_and_empty_adversary_run_the_plain_operations(graphs):
    """No adversary and an empty one dispatch the very same operations as
    the plain round; each planted family adds its own."""
    _, pt = graphs
    cfg = RoundConfig.fast()
    state = init_state(pt, cfg, device="cpu")

    def ops(adv):
        with _Ops() as rec:
            out = rounds.round_step(state, _port_arrays(pt, cfg, adv), cfg)
        return rec.ops, out

    plain, ref = ops(None)
    empty, got = ops(Adversary())
    assert empty == plain and torch.equal(got.flow, ref.flow)
    for family in ("lie", "corrupt", "silent", "down"):
        assert len(ops(Adversary(**ADV_KW[family]))[0]) > len(plain)


def test_engine_adversary_none_is_bit_exact(graphs):
    """Engine(adversary=None) and an empty adversary equal the plain
    engine bit for bit; a planted liar changes the estimates as JAX's
    engine does."""
    from flow_updating_tpu.engine import Engine as JaxEngine

    jt, pt = graphs

    def run(adv):
        eng = Engine(config=RoundConfig.fast(dtype="float64"),
                     adversary=adv, device="cpu")
        eng.set_topology(pt).build(seed=0).run_rounds(32)
        return eng.estimates()

    honest = run(None)
    assert np.array_equal(run(Adversary()), honest)
    lied = run(Adversary(lie_nodes=(1,), lie_value=50.0))
    assert not np.array_equal(lied, honest)
    jeng = JaxEngine(config=JaxConfig.fast(dtype="float64"),
                     adversary=JaxAdversary(lie_nodes=(1,), lie_value=50.0))
    jeng.set_topology(jt)
    jeng.build(seed=0)
    jeng.run_rounds(32)
    np.testing.assert_allclose(lied, np.asarray(jeng.estimates()), **TOL)


def test_engine_adversary_validation():
    topo = pgen.community(16, c=2, k_in=4.0, k_out=0.0, seed=0)
    adv = Adversary(lie_nodes=(1,), lie_value=9.0)
    eng = Engine(config=RoundConfig.fast(kernel="node"), adversary=adv,
                 device="cpu").set_topology(topo)
    with pytest.raises(ValueError, match="kernel='edge'"):
        eng.build()
    eng = Engine(config=RoundConfig.fast(variant="pairwise"),
                 adversary=adv, device="cpu").set_topology(topo)
    with pytest.raises(ValueError, match="no wire to attack"):
        eng.build()
    eng = Engine(mesh=make_mesh(2, device="cpu"), multichip="halo",
                 adversary=adv, device="cpu").set_topology(topo)
    with pytest.raises(ValueError, match="single-device"):
        eng.build()
    # the round refuses wire faults under fast pairwise too
    cfg = RoundConfig.fast(variant="pairwise")
    arrays = _port_arrays(topo, cfg, Adversary(corrupt_edges=(0,),
                                               corrupt_gain=2.0))
    with pytest.raises(ValueError, match="no wire"):
        rounds.run_rounds(init_state(topo, cfg, device="cpu"), arrays, cfg,
                          1)


# ---- the community graph and the registry -------------------------------------

def test_community_metadata_membership_and_bridges():
    topo = pgen.community(96, c=3, k_in=8.0, k_out=0.5, seed=1)
    jtopo = jgen.community(96, c=3, k_in=8.0, k_out=0.5, seed=1)
    np.testing.assert_array_equal(topo.membership, jtopo.membership)
    np.testing.assert_array_equal(topo.bridge_edges, jtopo.bridge_edges)
    crossing = np.flatnonzero(topo.membership[topo.src]
                              != topo.membership[topo.dst])
    assert np.array_equal(np.sort(topo.bridge_edges), crossing)


def test_registry_declarations_equal_jax():
    assert scenario_names() == jregistry.scenario_names()
    for name in scenario_names():
        assert get_scenario(name).describe() == \
            jregistry.get_scenario(name).describe()
    for const in ("COMMUNITY_N", "COMMUNITY_C", "LIE_NODE", "SILENT_NODE",
                  "LIE_VALUE", "PARTITION_FROM", "PARTITION_UNTIL",
                  "PARTITION_BLOCK"):
        from flow_updating_tpu_torch.scenarios import registry

        assert getattr(registry, const) == getattr(jregistry, const), const


@pytest.mark.parametrize("name", list(jregistry.REGISTRY))
@pytest.mark.parametrize("seed", [0, 1])
def test_registry_cases_equal_jax(name, seed):
    case = get_scenario(name).build(seed)
    jcase = jregistry.get_scenario(name).build(seed)
    for f in ("src", "dst", "rev", "delay", "values", "out_deg"):
        np.testing.assert_array_equal(getattr(case.topo, f),
                                      getattr(jcase.topo, f), err_msg=f)
    assert case.ground_truth == jcase.ground_truth
    assert (case.adversary is None) == (jcase.adversary is None)
    if case.adversary is not None:
        assert case.adversary.describe() == jcase.adversary.describe()
    assert dataclasses.asdict(get_scenario(name).round_config()) == \
        dataclasses.asdict(jregistry.get_scenario(name).round_config())


def test_unknown_scenario_names_registry():
    with pytest.raises(ValueError, match="registered:"):
        get_scenario("no_such_scenario")
    with pytest.raises(ValueError, match="did you mean"):
        get_scenario("byzantine_lei")


def test_perturb_no_heal_requires_down_window():
    with pytest.raises(ValueError, match="no link-down window"):
        run_scenario(get_scenario("byzantine_lie"), seeds=(0,),
                     perturb="no_heal", device="cpu")


# ---- sweep packing with adversaries -----------------------------------------

def test_sweep_buckets_split_by_adversary_structure(graphs):
    _, topo = graphs
    cfg = RoundConfig.fast()
    lie = Adversary(lie_nodes=(1,), lie_value=9.0)
    lie2 = Adversary(lie_nodes=(2,), lie_value=5.0)
    silent = Adversary(silent_nodes=(3,))
    insts = [
        SweepInstance(topo=topo, seed=0),
        SweepInstance(topo=topo, seed=1, adversary=lie),
        SweepInstance(topo=topo, seed=2, adversary=lie2),
        SweepInstance(topo=topo, seed=3, adversary=silent),
        SweepInstance(topo=topo, seed=4, adversary=Adversary()),
    ]
    buckets = pack_instances(insts, cfg, device="cpu")
    assert len(buckets) == 3
    assert sorted(b.size for b in buckets) == [1, 2, 2]
    got = sorted(m["instance"] for b in buckets for m in b.meta)
    assert got == [0, 1, 2, 3, 4]


@pytest.mark.parametrize("family", sorted(ADV_KW))
def test_sweep_adversarial_lane_matches_single_device(graphs, family):
    """Adversarial lanes (their own planted ids and values, one bucket)
    equal the single-device adversarial runs bit for bit; the JAX
    reference's own lane misses its single run by a rounding, the port's
    does not."""
    jt, pt = graphs
    cfg = RoundConfig.reference("collectall", dtype="float64",
                                drop_rate=0.1)
    kw = ADV_KW[family]
    advs = [Adversary(**kw),
            dataclasses.replace(Adversary(**kw),
                                lie_value=kw.get("lie_value", 0.0) + 3.0,
                                corrupt_gain=kw.get("corrupt_gain", 1.0)
                                + 0.25)]
    insts = [SweepInstance(topo=pt, seed=s, adversary=a)
             for s, a in enumerate(advs)]
    bucket = pack_instances(insts, cfg, device="cpu")[0]
    out = run_bucket(bucket, cfg, 40)
    N, E = pt.num_nodes, pt.num_edges
    for lane, inst in enumerate(insts):
        ref = rounds.run_rounds(
            init_state(pt, cfg, seed=inst.seed, device="cpu"),
            _port_arrays(pt, cfg, inst.adversary), cfg, 40,
            params=inst.params(cfg, device="cpu"))
        got = lane_state(out, lane, 2)
        for f in ("flow", "est", "ticks", "fired", "stamp", "last_avg"):
            a, b = getattr(got, f), getattr(ref, f)
            n = N if f in ("ticks", "fired", "last_avg") else E
            assert torch.equal(a[:n], b), f
        est = rounds.node_estimates(out, bucket.arrays).reshape(2, -1)
        assert torch.equal(est[lane, :N], rounds.node_estimates(
            ref, _port_arrays(pt, cfg, None)))


# ---- the conformance loop ----------------------------------------------------

def _conformance(records, summary):
    man = scenario_manifest(records, summary)
    return man, health.check_scenario_conformance(man)


def test_full_registry_conformance_and_perturbations(registry_run):
    """Every registered signature passes ``doctor --strict`` on its own
    run (one bucket structure a scenario, as JAX's compile count)."""
    records, summary = registry_run
    man = scenario_manifest(records, summary)
    checks = health.diagnose_manifest(man)
    assert health.exit_code(checks, strict=True) == 0, \
        [c.summary for c in checks if c.status not in ("pass", "skip")]
    assert summary["sweep_compiles"] == len(records) == len(REGISTRY)


def test_both_doctors_agree_on_scenario_manifest(registry_run):
    records, summary = registry_run
    man = json.loads(json.dumps(scenario_manifest(records, summary),
                                default=str))
    assert [c.to_jsonable() for c in health.diagnose_manifest(man)] == \
        [c.to_jsonable() for c in jhealth.diagnose_manifest(man)]
    assert [c.to_jsonable() for c in
            health.check_scenario_conformance(man)] == \
        [c.to_jsonable() for c in jhealth.check_scenario_conformance(man)]


PERTURBED = [(n, "no_heal" if n == "partition_heal" else "remove_adversary")
             for n in ("byzantine_lie", "byzantine_lie_clip",
                       "byzantine_lie_trim", "flow_corruption",
                       "flow_corruption_clip", "silent_node",
                       "partition_heal")]


@pytest.mark.parametrize("name,perturb", PERTURBED)
def test_perturbed_signature_fails(name, perturb):
    """The negative control: with its fault withdrawn (or its partition
    never healed) every adversarial signature fails, under both
    packages' checkers."""
    rec = run_scenario(get_scenario(name), seeds=(0,), perturb=perturb,
                       device="cpu")
    man, checks = _conformance([rec], {})
    assert health.overall(checks) == "fail"
    assert health.exit_code(checks) == 1
    man = json.loads(json.dumps(man, default=str))
    assert [c.to_jsonable() for c in checks] == \
        [c.to_jsonable() for c in jhealth.check_scenario_conformance(man)]


def test_byzantine_lie_signature_and_record_match_jax():
    scn = get_scenario("byzantine_lie")
    rec = run_scenario(scn, seeds=(0,), device="cpu")
    _, checks = _conformance([rec], {})
    assert health.overall(checks) == "pass"
    failing = {c.name.split(":")[2].split("#")[0] for c in _conformance(
        [run_scenario(scn, seeds=(0,), perturb="remove_adversary",
                      device="cpu")], {})[1] if c.status == "fail"}
    assert {"final_rmse_above", "blame"} <= failing
    jrec = jax_run_scenario(jregistry.get_scenario("byzantine_lie"),
                            seeds=(0,))
    gi, ji = rec["instances"][0], jrec["instances"][0]
    assert gi["params"] == ji["params"] and gi["topology"] == ji["topology"]
    assert gi["convergence"]["converged_round"] == \
        ji["convergence"]["converged_round"]
    np.testing.assert_allclose(gi["series"]["rmse"], ji["series"]["rmse"],
                               rtol=1e-6)
    assert [e["node"] for e in rec["blame"]["liar"]] == \
        [e["node"] for e in jrec["blame"]["liar"]]


def test_silent_node_blame_rank1_deterministic(registry_run):
    records, _ = registry_run
    rec = next(r for r in records if r["name"] == "silent_node")
    ranked = rec["blame"]["stall"]
    assert ranked and ranked[0]["node"] == 7
    rec2 = run_scenario(get_scenario("silent_node"), seeds=(0,),
                        device="cpu")
    assert [e["node"] for e in rec2["blame"]["stall"]] == \
        [e["node"] for e in ranked]


def test_conformance_checker_rejects_tampered_blame(registry_run):
    records, _ = registry_run
    rec = next(r for r in records if r["name"] == "byzantine_lie")
    tampered = json.loads(json.dumps(rec, default=str))
    tampered["blame"]["liar"] = [{"node": 9, "score": 1e6, "mass": 0.0}]
    _, checks_t = _conformance([tampered], {})
    bad = [c for c in checks_t if c.status == "fail"]
    assert len(bad) == 1 and "blame" in bad[0].name


def test_scenario_manifest_schema_and_doctor_dispatch(registry_run):
    records, _ = registry_run
    rec = next(r for r in records if r["name"] == "expander_relief")
    man = scenario_manifest([rec], {"scenarios": ["expander_relief"]},
                            device="cpu")
    assert man["schema"] == "flow-updating-scenario-report/v1"
    assert man["environment"]["backend"] == "cpu"
    names = {c.name for c in health.diagnose_manifest(man)}
    assert any(n.startswith("scn:") for n in names)
    assert not any(n in ("rmse_stall", "mass_conservation")
                   for n in names)
    inst = rec["instances"][0]
    assert "rmse" in inst["series"] and "mass_residual" in inst["series"]


def test_blame_sweep_ranks_worst_instance(registry_run):
    """``inspect``'s sweep blame over the records the port's sweep wrote:
    the unprotected liar's lane ranks worst."""
    records, _ = registry_run
    insts = [dict(i, instance=k) for k, i in enumerate(
        i for r in records for i in r["instances"])]
    out = obs_inspect.blame_sweep({"instances": insts})
    worst = out["worst_instance"]
    assert worst["tag"]["scenario"] == "flow_corruption"
    assert out["ranked_of"] == len(insts)


# ---- the scenarios subcommand -------------------------------------------------

def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_scenarios_cli(tmp_path, capsys):
    assert port_main(["scenarios", "--list"]) == 0
    listing = _last_json(capsys)
    from flow_updating_tpu.aggregates import AGG_SCENARIOS as JAX_AGG

    assert list(listing) == list(jregistry.REGISTRY) + list(JAX_AGG)
    path = tmp_path / "scn.json"
    rc = port_main(["scenarios", "--device", "cpu", "--seeds", "1",
                    "byzantine_lie", "silent_node", "--report", str(path)])
    out = _last_json(capsys)
    assert rc == 0 and out["overall"] == "pass"
    assert out["sweep_compiles"] == 2
    man = json.loads(path.read_text())
    assert [c["name"] for c in out["checks"]] == \
        [c.name for c in jhealth.check_scenario_conformance(man)]
    rc = port_main(["scenarios", "--device", "cpu", "--seeds", "1",
                    "byzantine_lie", "--perturb", "remove_adversary"])
    assert rc == 1 and _last_json(capsys)["overall"] == "fail"
    # the aggregate cases run their own fabric: they cannot share an
    # invocation with the sweep grid (tests/test_torch_aggregates.py
    # runs them)
    with pytest.raises(SystemExit, match="cannot mix"):
        port_main(["scenarios", "agg_byzantine_lie", "byzantine_lie"])
    with pytest.raises(SystemExit, match="did you mean"):
        port_main(["scenarios", "byzantine_lei"])
