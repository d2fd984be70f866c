"""Custom actors in the port (``flow_updating_tpu_torch.models.actor``, the
``Engine`` dispatch and the actor checkpoint flavour) against the JAX
package's.

Counterparts of ``tests/test_actor.py`` (its GSPMD cases become the
refusal naming A12 part 4), plus:

* push-sum's estimates through ``ActorKernel`` equal to JAX's
  ``ActorKernel`` to rel 1e-5 (JAX's actor path is float32 only; its own
  tolerance, ``tests/test_actor.py:56``);
* ``TopoView.sum_to_dst`` / ``max_to_dst`` against ``jax.ops.segment_sum``
  / ``segment_max`` (empty segments read ``-inf``), and the in-edge ELL
  they reduce over;
* actor archives both ways: the port restores JAX's, JAX restores the
  port's, each resumed run within rel 1e-5 of the other package's, and
  the leaf keys spelled as ``jax.tree_util.keystr`` spells them;
* the Engine's refusals: halo/pod with an actor, latency-warped delivery,
  telemetry and fields, an adversary, a callable without
  ``host_actors=True``.
"""

import collections

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
import torch

from flow_updating_tpu.engine import Engine as JaxEngine
from flow_updating_tpu.models.actor import ActorKernel as JaxActorKernel
from flow_updating_tpu.models.actor import TopoView as JaxTopoView
from flow_updating_tpu.models.actor import push_sum_actor as jax_push_sum
from flow_updating_tpu.topology.graph import build_topology as jax_build
from flow_updating_tpu_torch import Engine, RoundConfig
from flow_updating_tpu_torch.models.actor import (
    ActorKernel,
    TopoView,
    VectorActor,
    in_edge_ell,
    push_sum_actor,
)
from flow_updating_tpu_torch.topology.generators import erdos_renyi
from flow_updating_tpu_torch.topology.graph import build_topology
from flow_updating_tpu_torch.utils import checkpoint as ck

REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def _pairs(n):
    # ring + length-5 chords: expander-ish, so push-sum mixes in O(100)
    # rounds
    return ([(i, (i + 1) % n) for i in range(n)]
            + [(i, (i + 5) % n) for i in range(n)])


def _topos(n=32, seed=3):
    vals = np.random.default_rng(seed).uniform(0, 60, n)
    return (build_topology(n, _pairs(n), values=vals, warn_asymmetric=False),
            jax_build(n, _pairs(n), values=vals, warn_asymmetric=False))


def _ring_engine(n=32, seed=3):
    topo, _ = _topos(n, seed)
    return Engine(device="cpu").set_topology(topo), topo


def _jax_engine(jtopo):
    e = JaxEngine()
    e.set_topology(jtopo)
    e.register_actor("pushsum", jax_push_sum())
    return e


def test_push_sum_converges_to_mean():
    e, topo = _ring_engine()
    e.register_actor("pushsum", push_sum_actor())
    e.build()
    e.run_rounds(600)
    est = e.estimates()
    assert est.dtype == np.float32
    assert np.abs(est - topo.true_mean).max() < 1e-3
    gv = e.global_values()
    assert len(gv["last_avg"]) == topo.num_nodes


@pytest.mark.parametrize("rounds", [1, 7, 37, 200])
def test_push_sum_matches_jax_actor_kernel(rounds):
    topo, jtopo = _topos()
    port = ActorKernel(topo, push_sum_actor(), device="cpu")
    ref = JaxActorKernel(jtopo, jax_push_sum())
    got = port.estimates(port.run(port.init_state(), rounds))
    want = ref.estimates(ref.run(ref.init_state(), rounds))
    np.testing.assert_allclose(got, want, rtol=REL, atol=0)
    state, outbox = port.run(port.init_state(), rounds)
    jstate, joutbox = ref.run(ref.init_state(), rounds)
    for k in ("s", "w"):
        np.testing.assert_allclose(state[k].numpy(), np.asarray(jstate[k]),
                                   rtol=REL, atol=1e-6)
        np.testing.assert_allclose(outbox[k].numpy(),
                                   np.asarray(joutbox[k]), rtol=REL,
                                   atol=1e-6)


def test_push_sum_matches_jax_on_a_random_graph():
    topo = erdos_renyi(300, avg_degree=6.0, seed=2)
    from flow_updating_tpu.topology.generators import erdos_renyi as jer

    jtopo = jer(300, avg_degree=6.0, seed=2)
    port = ActorKernel(topo, push_sum_actor(), device="cpu")
    ref = JaxActorKernel(jtopo, jax_push_sum())
    np.testing.assert_allclose(
        port.estimates(port.run(port.init_state(), 120)),
        ref.estimates(ref.run(ref.init_state(), 120)), rtol=REL)


def test_push_sum_conserves_mass_each_round():
    e, topo = _ring_engine()
    e.register_actor("pushsum", push_sum_actor())
    e.build()
    total = topo.values.sum()
    for _ in range(5):
        e.run_rounds(1)
        state, outbox = e.state
        mass = float(state["s"].double().sum() + outbox["s"].double().sum())
        assert mass == pytest.approx(total, rel=REL)
        assert float(state["w"].double().sum() + outbox["w"].double().sum()
                     ) == pytest.approx(topo.num_nodes, rel=REL)


def test_run_until_with_watcher_in_actor_mode():
    e, _ = _ring_engine()
    e.register_actor("pushsum", push_sum_actor())
    samples = []
    e.add_watcher(run_until=50.0, time_interval=10.0,
                  callback=lambda eng: samples.append(eng.clock))
    e.run_until(60.0)
    assert samples == [10.0, 20.0, 30.0, 40.0, 50.0]
    assert e.clock == 60.0


def test_arbitrary_callable_is_rejected():
    e = Engine(device="cpu")
    with pytest.raises(TypeError, match="VectorActor"):
        e.register_actor("peer", lambda: None)

    class Peer:  # the reference's per-actor class shape
        pass

    with pytest.raises(TypeError, match="cannot execute on the card"):
        e.register_actor("peer", Peer)
    with pytest.raises(TypeError, match="host_actors=True"):
        e.register_actor("peer", print)


def test_builtin_none_registration_still_works():
    e, topo = _ring_engine()
    e.register_actor("peer")
    e.build()
    e.run_rounds(100)
    assert np.abs(e.estimates() - topo.true_mean).max() < 1e-3


def test_actor_checkpoint_roundtrip(tmp_path):
    path = str(tmp_path / "actor.npz")
    e, topo = _ring_engine()
    e.register_actor("pushsum", push_sum_actor())
    e.build()
    e.run_rounds(37)
    e.save_checkpoint(path)
    ref = e.estimates()
    clock = e.clock
    e.run_rounds(100)
    after = e.state

    e2 = Engine(device="cpu").set_topology(topo)
    e2.register_actor("pushsum", push_sum_actor())
    e2.restore_checkpoint(path)
    assert e2.clock == clock
    np.testing.assert_array_equal(e2.estimates(), ref)
    e2.run_rounds(100)   # the resumed run repeats the uninterrupted one
    for a, b in zip(ck.tree_leaves_with_path(e2.state),
                    ck.tree_leaves_with_path(after)):
        assert a[0] == b[0] and torch.equal(a[1], b[1]), a[0]

    e3, _ = _ring_engine(n=16)
    e3.register_actor("pushsum", push_sum_actor())
    with pytest.raises(ValueError, match="different topology"):
        e3.restore_checkpoint(path)

    base = push_sum_actor()
    other = VectorActor(init=base.init, round=base.round,
                        estimate=base.estimate, name="other-protocol")
    e4 = Engine(device="cpu").set_topology(topo)
    e4.register_actor("other", other)
    with pytest.raises(ValueError, match="saved by actor"):
        e4.restore_checkpoint(path)

    def init2(values, view):
        st, out = base.init(values, view)
        st["extra_field"] = torch.zeros_like(values)
        return st, out

    changed = VectorActor(init=init2, round=base.round,
                          estimate=base.estimate, name="push-sum")
    e5 = Engine(device="cpu").set_topology(topo)
    e5.register_actor("pushsum", changed)
    with pytest.raises(ValueError, match="structure does not match"):
        e5.restore_checkpoint(path)

    def init64(values, view):
        st, out = base.init(values, view)
        return {k: v.double() for k, v in st.items()}, out

    wider = VectorActor(init=init64, round=base.round,
                        estimate=base.estimate, name="push-sum")
    e6 = Engine(device="cpu").set_topology(topo)
    e6.register_actor("pushsum", wider)
    with pytest.raises(ValueError, match="precision changed"):
        e6.restore_checkpoint(path)
    with pytest.raises(ValueError, match="not a VectorActor checkpoint"):
        cfg = RoundConfig.fast()
        from flow_updating_tpu_torch.models.state import init_state

        plain = str(tmp_path / "plain.npz")
        ck.save_checkpoint(plain, init_state(topo, cfg, device="cpu"), cfg)
        ck.load_actor_checkpoint(plain, e.state, "push-sum")


def test_actor_archive_port_to_jax(tmp_path):
    path = str(tmp_path / "port.npz")
    topo, jtopo = _topos()
    e = Engine(device="cpu").set_topology(topo)
    e.register_actor("pushsum", push_sum_actor())
    e.build()
    e.run_rounds(41)
    e.save_checkpoint(path)
    j = _jax_engine(jtopo)
    j.restore_checkpoint(path)
    assert j.clock == e.clock
    np.testing.assert_array_equal(j.estimates(), e.estimates())
    j.run_rounds(60)
    e.run_rounds(60)
    np.testing.assert_allclose(e.estimates(), j.estimates(), rtol=REL)


def test_actor_archive_jax_to_port(tmp_path):
    path = str(tmp_path / "jax.npz")
    topo, jtopo = _topos()
    j = _jax_engine(jtopo)
    j.build()
    j.run_rounds(41)
    j.save_checkpoint(path)
    e = Engine(device="cpu").set_topology(topo)
    e.register_actor("pushsum", push_sum_actor())
    e.restore_checkpoint(path)
    assert e.clock == j.clock
    np.testing.assert_array_equal(e.estimates(), j.estimates())
    j.run_rounds(60)
    e.run_rounds(60)
    np.testing.assert_allclose(e.estimates(), j.estimates(), rtol=REL)


def test_leaf_keys_spelled_as_jax_keystr():
    NT = collections.namedtuple("NT", "a b")
    tree = ({"w": 1.0, "s": [2.0, NT(3.0, {"z": 4.0, "a": {7: 5.0}})]}, None,
            (6.0,))
    port = [(k, v) for k, v in ck.tree_leaves_with_path(tree)]
    ref = [(jtu.keystr(k), v) for k, v in jtu.tree_leaves_with_path(tree)]
    assert port == ref
    swapped = ck._tree_replace(tree, {k: -v for k, v in port})
    assert [v for _, v in ck.tree_leaves_with_path(swapped)] == \
        [-v for _, v in port]
    assert isinstance(swapped[0]["s"][1], NT)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sum_and_max_to_dst_match_jax_segment_ops(dtype):
    # an isolated node (7) has no in-edge: its sum is 0 and its max -inf
    pairs = [(0, 1), (1, 2), (2, 0), (3, 4), (4, 5), (5, 6), (0, 5),
             (2, 4), (1, 3)]
    topo = build_topology(8, pairs, values=np.arange(8.0),
                          warn_asymmetric=False)
    view = TopoView.from_topology(topo, "cpu")
    jview = JaxTopoView(
        num_nodes=8, num_edges=int(topo.num_edges),
        src=jnp.asarray(topo.src, jnp.int32),
        dst=jnp.asarray(topo.dst, jnp.int32),
        rev=jnp.asarray(topo.rev, jnp.int32),
        degree=jnp.asarray(np.bincount(topo.dst, minlength=8), jnp.int32))
    x = np.random.default_rng(1).standard_normal(topo.num_edges)
    xt = torch.as_tensor(x, dtype=dtype)
    jx = jnp.asarray(x, jnp.float32 if dtype == torch.float32
                     else jnp.float64)
    tol = 1e-6 if dtype == torch.float32 else 1e-12
    np.testing.assert_allclose(view.sum_to_dst(xt).numpy(),
                               np.asarray(jview.sum_to_dst(jx)),
                               rtol=tol, atol=tol)
    got = view.max_to_dst(xt).numpy()
    np.testing.assert_array_equal(got, np.asarray(jview.max_to_dst(jx)))
    assert got[7] == -np.inf
    assert torch.equal(view.degree,
                       torch.as_tensor(np.bincount(topo.dst, minlength=8),
                                       dtype=torch.int32))
    # (E, D) leaves take the plain row sum on any device
    x2 = torch.as_tensor(np.stack([x, 2 * x], 1), dtype=dtype)
    np.testing.assert_allclose(view.sum_to_dst(x2).numpy(),
                               np.asarray(jax.ops.segment_sum(
                                   jnp.asarray(x2.numpy()), jview.dst,
                                   num_segments=8)), rtol=tol, atol=tol)
    assert torch.equal(view.send(torch.arange(8.0)),
                       torch.arange(8.0)[torch.as_tensor(topo.src)])
    assert torch.equal(view.recv(xt), xt[torch.as_tensor(topo.rev)])


def test_in_edge_ell_lists_every_in_edge_once():
    topo = erdos_renyi(200, avg_degree=5.0, seed=7)
    ell = in_edge_ell(topo.dst, topo.num_nodes)
    E = topo.num_edges
    seen = np.zeros(E, np.int64)
    row0 = 0
    for m in ell["mats"]:
        for r in range(m.shape[0]):
            v = int(np.nonzero(ell["inv"] == row0 + r)[0][0])
            ids = m[r][m[r] < E]
            assert (topo.dst[ids] == v).all()
            assert (np.diff(ids) > 0).all()
            seen[ids] += 1
        row0 += m.shape[0]
    assert (seen == 1).all()
    assert sorted(ell["inv"]) == list(range(topo.num_nodes))


def test_run_streamed_in_actor_mode_default_emit():
    e, topo = _ring_engine()
    e.register_actor("pushsum", push_sum_actor())
    e.build()
    e.run_streamed(50, observe_every=10)
    samples = []
    e.run_streamed(30, observe_every=10, emit=samples.append)
    assert [s["t"] for s in samples] == [10, 20, 30]
    assert all({"rmse", "max_abs_err", "mass", "fired_total"} <= set(s)
               for s in samples)
    assert samples[-1]["mass"] == pytest.approx(topo.values.sum(), rel=1e-3)
    assert e.clock == 80.0


def test_actor_engine_refusals():
    from flow_updating_tpu_torch.parallel.mesh import make_mesh
    from flow_updating_tpu_torch.scenarios.adversary import Adversary

    topo, _ = _topos()
    mesh = make_mesh(2, device="cpu")
    for mode in ("halo", "pod"):
        e = Engine(mesh=mesh, multichip=mode, device="cpu")
        e.set_topology(topo).register_actor("p", push_sum_actor())
        with pytest.raises(ValueError, match="custom VectorActors"):
            e.build()
    e = Engine(mesh=mesh, device="cpu").set_topology(topo)
    e.register_actor("p", push_sum_actor())
    with pytest.raises(NotImplementedError, match="A12 part 4"):
        e.build()
    with pytest.raises(NotImplementedError, match="A12 part 4"):
        ActorKernel(topo, push_sum_actor(), mesh=mesh, device="cpu")
    e = Engine(device="cpu").set_topology(topo)
    e.register_actor("p", push_sum_actor())
    with pytest.raises(ValueError, match="unit-delay synchronous"):
        e.build(latency_scale=1.0)
    e = Engine(device="cpu").set_topology(topo)
    e.register_actor("p", push_sum_actor())
    e.build()
    with pytest.raises(NotImplementedError, match="telemetry series"):
        e.run_telemetry(10)
    with pytest.raises(NotImplementedError, match="field series"):
        e.run_fields(10)
    assert e._kernel_kind == "node" and e._node_like
    adv = Adversary(lie_nodes=(1,), lie_value=5.0)
    e = Engine(adversary=adv, device="cpu").set_topology(topo)
    e.register_actor("p", push_sum_actor())
    with pytest.raises(ValueError, match="custom-actor dispatch"):
        e.build()
    with pytest.raises(TypeError, match="init must return"):
        ActorKernel(topo, VectorActor(init=lambda v, view: v,
                                      round=None, estimate=None),
                    device="cpu").init_state()
