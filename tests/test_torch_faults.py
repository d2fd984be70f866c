"""Fault injection of the port's ``Engine`` against the JAX package's.

``kill_nodes``/``revive_nodes`` (crash-stop churn through the alive mask)
and ``fail_links``/``restore_links`` (per-edge loss masks) on the
single-device edge round: the same fault sequence on the same topology
gives JAX's trajectory at float64 to 1e-9 (every state leaf; the integer
and boolean leaves exactly), and the paper's headline property holds —
after the faults clear the protocol reconverges to the true mean with no
state reset (JAX ``tests/test_faults.py``).  Links are named by node ids
or host names; an unknown link, the node kernel and the halo round are
refused as in JAX.
"""

import os

import numpy as np
import pytest
import torch

from flow_updating_tpu.engine import Engine as JaxEngine
from flow_updating_tpu.models.config import RoundConfig as JaxConfig
from flow_updating_tpu.topology import generators as jgen
from flow_updating_tpu_torch import Engine, RoundConfig
from flow_updating_tpu_torch.models.rounds import node_estimates
from flow_updating_tpu_torch.parallel.mesh import make_mesh
from flow_updating_tpu_torch.service import membership
from flow_updating_tpu_torch.topology import generators as pgen

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL6 = (os.path.join(ROOT, "examples/platforms/small6.xml"),
          os.path.join(ROOT, "examples/deployments/small6_actors.xml"))
TOL = dict(rtol=1e-9, atol=1e-9)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def _cfgs(maker, variant, **kw):
    return (getattr(JaxConfig, maker)(variant, dtype="float64", **kw),
            getattr(RoundConfig, maker)(variant, dtype="float64", **kw))


def _engines(spec, maker, variant, seed=0, **kw):
    jc, pc = _cfgs(maker, variant, **kw)
    je = JaxEngine(config=jc).set_topology(
        jgen.topology_from_spec(spec, seed=seed)).build()
    pe = Engine(config=pc, device="cpu").set_topology(
        pgen.topology_from_spec(spec, seed=seed)).build()
    return je, pe


def _both(engines, call, *args):
    for e in engines:
        getattr(e, call)(*args)


def _assert_same_state(je, pe):
    port = pe.state.numpy()
    for name, leaf in port.items():
        ref = np.asarray(getattr(je.state, name))
        if leaf.dtype.kind == "f":
            np.testing.assert_allclose(leaf, ref, err_msg=name, **TOL)
        else:
            np.testing.assert_array_equal(leaf, ref, err_msg=name)


def _max_err(engine):
    return float(np.max(np.abs(engine.estimates()
                               - engine.topology.true_mean)))


@pytest.mark.parametrize("spec,variant,killed", [
    ("erdos_renyi:48:5", "collectall", [0, 1, 2]),
    ("ring:24:2", "pairwise", [5, 6]),
])
def test_kill_revive_matches_jax(spec, variant, killed):
    engines = _engines(spec, "reference", variant, seed=2, delay_depth=2)
    je, pe = engines
    _both(engines, "run_rounds", 100)
    _both(engines, "kill_nodes", killed)
    fired = pe.state.fired.numpy()[killed].copy()
    _both(engines, "run_rounds", 150)
    # the dead neither fire nor lose their ledgers; survivors keep running
    np.testing.assert_array_equal(pe.state.fired.numpy()[killed], fired)
    assert not pe.state.alive.numpy()[killed].any()
    assert np.all(np.isfinite(pe.estimates()))
    _assert_same_state(je, pe)
    _both(engines, "revive_nodes", killed)
    _both(engines, "run_rounds", 250)
    assert (pe.state.fired.numpy()[killed] > fired).all()
    _assert_same_state(je, pe)
    np.testing.assert_allclose(pe.estimates(), je.estimates(), **TOL)


def test_kill_revive_reconverges_collectall():
    """JAX's contract: after the revival the error falls a hundredfold
    below its pre-fault value (or under 1e-3)."""
    topo = pgen.erdos_renyi(48, avg_degree=5.0, seed=2)
    cfg = RoundConfig.reference(variant="collectall", delay_depth=2)
    e = Engine(config=cfg, device="cpu").set_topology(topo).build()
    e.run_rounds(150)
    err_before = _max_err(e)
    e.kill_nodes([0, 1, 2])
    e.run_rounds(300)
    assert np.all(np.isfinite(e.estimates()))
    e.revive_nodes([0, 1, 2])
    e.run_rounds(1500)
    assert _max_err(e) < max(1e-3, err_before * 1e-2)


def test_link_failure_then_restore_matches_jax():
    engines = _engines("ring:16:2", "reference", "collectall",
                       delay_depth=2)
    je, pe = engines
    bad = [(0, 1), (4, 5), (8, 9)]
    _both(engines, "fail_links", bad)
    failed = pe._edge_ids(bad)
    assert not pe.state.edge_ok.numpy()[failed].any()
    assert pe.state.edge_ok.numpy().sum() == pe.topology.num_edges - 6
    _both(engines, "run_rounds", 300)
    # nothing is in flight on a failed link, nor ever drained from it
    assert not pe.state.buf_valid.numpy()[:, failed].any()
    assert not pe.state.pending_valid.numpy()[:, failed].any()
    _assert_same_state(je, pe)
    _both(engines, "restore_links", bad)
    assert pe.state.edge_ok.numpy().all()
    _both(engines, "run_rounds", 1200)
    _assert_same_state(je, pe)
    assert _max_err(pe) < 1e-3
    # quiescent and healed: antisymmetry restored on the once-failed links
    assert pe.convergence_report()["antisymmetry_residual"] < 1e-3


@pytest.mark.parametrize("maker,variant", [("fast", "pairwise"),
                                           ("fast", "collectall")])
def test_failed_link_in_fast_modes_matches_jax(maker, variant):
    """Fast pairwise never matches a failed link (its flow stays 0); the
    still-connected rest converges with the mass conserved every round
    (JAX ``test_failed_link_excluded_from_fast_pairwise_matching``).
    Fast collect-all loses every message put on the link, so its mass
    moves while the link is down: JAX's trajectory is the contract."""
    engines = _engines("ring:12:2", maker, variant, seed=3)
    je, pe = engines
    _both(engines, "fail_links", [(0, 1)])
    failed = pe._edge_ids([(0, 1)])
    total = float(np.sum(pe.topology.values))
    for _ in range(8):
        _both(engines, "run_rounds", 25)
        est = pe.estimates()
        if variant == "pairwise":
            np.testing.assert_allclose(est.sum(), total, rtol=1e-9)
    _assert_same_state(je, pe)
    if variant == "pairwise":
        assert not pe.state.flow.numpy()[failed].any()
        assert np.max(np.abs(est - pe.topology.true_mean)) < 1e-4


def test_fail_links_and_kill_by_name_small6():
    """Links and nodes named by host names, as in JAX's
    ``test_fail_links_by_name``, against JAX's engine."""
    jc, pc = _cfgs("reference", "collectall", delay_depth=2)
    je = JaxEngine(config=jc).load_platform(SMALL6[0])
    je.register_actor("peer").load_deployment(SMALL6[1])
    pe = Engine(config=pc, device="cpu").load_platform(SMALL6[0])
    pe.register_actor("peer").load_deployment(SMALL6[1])
    engines = (je.build(), pe.build())
    names = pe.topology.names
    _both(engines, "fail_links", [("Lisboa", "Porto")])
    by_id = pe._edge_ids([(names.index("Lisboa"), names.index("Porto"))])
    np.testing.assert_array_equal(pe._edge_ids([("Lisboa", "Porto")]),
                                  by_id)
    _both(engines, "run_rounds", 300)
    _both(engines, "kill_nodes", [names[2], 4])
    assert not pe.state.alive.numpy()[[2, 4]].any()
    _both(engines, "run_rounds", 300)
    _both(engines, "revive_nodes", [4, names[2]])
    _both(engines, "restore_links", [("Lisboa", "Porto")])
    _both(engines, "run_rounds", 600)
    _assert_same_state(je, pe)
    assert _max_err(pe) < 1e-3


def test_unknown_link_and_bad_ids_rejected():
    e = Engine(config=RoundConfig.fast(), device="cpu")
    e.set_topology(pgen.ring(8, seed=0)).build()
    with pytest.raises(ValueError, match="no edge 0->4"):
        e.fail_links([(0, 4)])  # not an edge in ring(k=1)
    with pytest.raises(ValueError, match="no node names"):
        e.kill_nodes(["Lisboa"])
    # ids are checked on the host: none reaches a device index
    with pytest.raises(ValueError, match="outside"):
        e.kill_nodes([8])
    e.kill_nodes([-1])                  # numpy's negative ids
    assert e.state.alive.numpy().tolist() == [True] * 7 + [False]
    fresh = Engine(config=RoundConfig.fast(), device="cpu")
    fresh.set_topology(pgen.ring(8, seed=0))
    with pytest.raises(RuntimeError, match="not built"):
        fresh.kill_nodes([0])


def test_node_kernel_and_halo_round_refuse_faults():
    pt = pgen.ring(64, 2)
    node = Engine(config=RoundConfig.fast(kernel="node"), device="cpu")
    node.set_topology(pt).build()
    for call in (lambda: node.kill_nodes([0]),
                 lambda: node.revive_nodes([0]),
                 lambda: node.fail_links([(0, 1)]),
                 lambda: node.restore_links([(0, 1)])):
        with pytest.raises(ValueError, match="kernel='edge'"):
            call()
    halo = Engine(mesh=make_mesh(4, device="cpu"), multichip="halo",
                  device="cpu").set_topology(pt).build()
    for call in (lambda: halo.kill_nodes([0]),
                 lambda: halo.fail_links([(0, 1)])):
        with pytest.raises(NotImplementedError, match="halo kernel"):
            call()


def test_set_alive_is_a_value_edit():
    """``membership.set_alive`` returns a new state with a new mask on the
    state's device and leaves the state it was given as it was."""
    topo = pgen.ring(10, 2)
    e = Engine(config=RoundConfig.reference("collectall"), device="cpu")
    state = e.set_topology(topo).build().state
    dead = membership.set_alive(state, [1, 3, 3], False)
    assert state.alive.all()
    assert dead.alive.numpy().tolist() == [
        i not in (1, 3) for i in range(10)]
    assert membership.set_alive(dead, np.int32(3), True).alive[3]
    assert dead.flow is state.flow
    with pytest.raises(ValueError, match="flat sequence"):
        membership.as_id_array([[0, 1]])
    est = node_estimates(dead, e._topo_arrays)
    torch.testing.assert_close(est, node_estimates(state, e._topo_arrays))
