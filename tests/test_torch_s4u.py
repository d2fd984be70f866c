"""The port's host actor runtime (``flow_updating_tpu_torch.s4u`` and
``Engine(host_actors=True)``) against the JAX package's.

Counterparts of ``tests/test_s4u.py``, run on the port with the actors
of ``examples/torch_host_actors.py`` (``examples/host_actors.py`` with
its import swapped):

* the collect-all and pairwise peers converge; ``kill_all`` stops every
  actor; a crashing actor dies alone;
* platform-route delays, the cancel semantics (a cancelled pending put is
  never delivered, a cancel wakes a waiter with ``CancelException``, a
  cancel of a completed comm is a no-op);
* deterministic replay — and the port's run equal, mirror for mirror, to
  the JAX package's run of its own example;
* the s4u runtime and the port's C++ DES converge in the same class;
* the refusals of the mode and the teardown that joins every thread.
"""

import importlib.util
import logging
import os
import threading

import pytest
import torch

from flow_updating_tpu import s4u as jax_s4u
from flow_updating_tpu.engine import Engine as JaxEngine
from flow_updating_tpu_torch import s4u
from flow_updating_tpu_torch.engine import Engine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PLATFORM = os.path.join(ROOT, "examples/platforms/small6.xml")
ACTORS = os.path.join(ROOT, "examples/deployments/small6_actors.xml")


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


example = _load("torch_host_actors_example",
                os.path.join(ROOT, "examples/torch_host_actors.py"))
jax_example = _load("host_actors_example",
                    os.path.join(ROOT, "examples/host_actors.py"))
Peer = example.Peer
watcher = example.watcher
RESULTS = example.global_values


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def _engine(peer=None):
    RESULTS.clear()
    eng = Engine(host_actors=True, device="cpu")
    eng.load_platform(PLATFORM)
    eng.register_actor("peer", peer or Peer)
    eng.load_deployment(ACTORS)
    return eng


@pytest.fixture()
def host_engine():
    eng = _engine()
    yield eng
    eng._hostdes.shutdown()


def test_reference_style_peer_converges(host_engine):
    eng = host_engine
    s4u.Actor.create("watcher", s4u.Host.by_name("Lisboa"),
                     watcher, 400.0, 10.0)
    eng.run_until(500.0)
    assert eng.clock == 500.0
    last = RESULTS["last_avg"]
    assert set(last) == {"Lisboa", "Porto", "Braga", "Coimbra", "Faro",
                         "Aveiro"}
    for name, avg in last.items():
        assert avg == pytest.approx(30.0, abs=0.05), (name, avg)
    assert sum(RESULTS["value"].values()) / 6 == pytest.approx(30.0)


def test_kill_all_stops_actors(host_engine):
    eng = host_engine
    s4u.Actor.create("watcher", s4u.Host.by_name("Lisboa"),
                     watcher, 50.0, 10.0)
    eng.run_until(200.0)
    assert eng.clock == 200.0
    alive = [c for c in eng._hostdes.actors if not c.done]
    assert not alive, [c.name for c in alive]


def test_register_arbitrary_callable_requires_opt_in():
    eng = Engine(device="cpu")
    with pytest.raises(TypeError, match="host_actors=True"):
        eng.register_actor("peer", Peer)
    with pytest.raises(TypeError, match="not callable"):
        Engine(host_actors=True, device="cpu").register_actor("peer", 3)


def test_mesh_and_host_actors_are_exclusive():
    with pytest.raises(ValueError, match="host_actors"):
        Engine(host_actors=True, mesh=object(), device="cpu")


def test_host_mode_refuses_the_kernel_verbs(host_engine):
    for verb in (lambda: host_engine.add_watcher(100.0),
                 host_engine.global_values, host_engine.estimates):
        with pytest.raises(NotImplementedError, match="s4u|Python actors"):
            verb()


def test_unregistered_deployment_function_raises():
    eng = Engine(host_actors=True, device="cpu")
    eng.register_actor("other", Peer)
    with pytest.raises(RuntimeError, match="no callable was registered"):
        eng.load_deployment(ACTORS, function="peer")


def test_net_delay_uses_platform_routes(host_engine):
    eng = host_engine
    des = eng._hostdes
    lat = eng.platform.route_latency("Lisboa", "Porto", default=0.0)
    bw = eng.platform.route_bandwidth("Lisboa", "Porto")
    src = next(c for c in des.actors if c.name == "Lisboa")
    delay = des._net_delay(src, des.mailbox("Porto"), 1000.0)
    expected = lat + (1000.0 / bw if bw != float("inf") else 0.0)
    assert delay == pytest.approx(expected)
    assert delay > 0.0
    # the JAX runtime prices the same put the same
    jeng = JaxEngine(host_actors=True)
    jeng.load_platform(PLATFORM)
    jeng.register_actor("peer", jax_example.Peer)
    jeng.load_deployment(ACTORS)
    jdes = jeng._hostdes
    jsrc = next(c for c in jdes.actors if c.name == "Lisboa")
    assert jdes._net_delay(jsrc, jdes.mailbox("Porto"), 1000.0) == delay
    jdes.kill_all()
    jdes.run_until(1.0)


def test_cancelled_pending_put_is_never_delivered(host_engine):
    got = {}

    def sender():
        mbox = s4u.Mailbox.by_name("drop-here")
        comm = mbox.put_async("lost", 10)
        comm.cancel()
        mbox.put_async("kept", 10)
        s4u.this_actor.sleep_for(5.0)

    def receiver():
        s4u.this_actor.sleep_for(1.0)
        got["payload"] = s4u.Mailbox.by_name("drop-here") \
            .get_async().wait().get_payload()

    s4u.Actor.create("canceller", s4u.Host.by_name("Lisboa"), sender)
    s4u.Actor.create("drop-here", s4u.Host.by_name("Porto"), receiver)
    host_engine.run_until(30.0)
    assert got["payload"] == "kept"


def test_pairwise_peer_converges():
    eng = _engine(example.PairwisePeer)
    s4u.Actor.create("watcher", s4u.Host.by_name("Lisboa"),
                     watcher, 400.0, 10.0)
    eng.run_until(450.0)
    last = RESULTS["last_avg"]
    assert len(last) == 6
    for name, avg in last.items():
        assert avg == pytest.approx(30.0, abs=0.1), (name, avg)


def _port_run(until: float, deadline: float) -> dict:
    eng = _engine()
    s4u.Actor.create("watcher", s4u.Host.by_name("Lisboa"),
                     watcher, deadline, 10.0)
    eng.run_until(until)
    eng._hostdes.shutdown()
    return {k: dict(v) for k, v in RESULTS.items()}


def test_deterministic_replay_and_equal_to_jax():
    a = _port_run(200.0, 150.0)
    assert a == _port_run(200.0, 150.0)
    jax_example.global_values.clear()
    jeng = JaxEngine(host_actors=True)
    jeng.load_platform(PLATFORM)
    jeng.register_actor("peer", jax_example.Peer)
    jeng.load_deployment(ACTORS)
    jax_s4u.Actor.create("watcher", jax_s4u.Host.by_name("Lisboa"),
                         jax_example.watcher, 150.0, 10.0)
    jeng.run_until(200.0)
    assert a == {k: dict(v) for k, v in jax_example.global_values.items()}


def test_s4u_and_cpp_des_converge_in_the_same_class():
    import numpy as np

    from flow_updating_tpu_torch import native
    from flow_updating_tpu_torch.topology.deployment import load_deployment
    from flow_updating_tpu_torch.topology.platform import load_platform

    tol = 1e-4
    eng = _engine()
    s4u_rounds = None
    t = 0
    while t < 1000:
        eng.run_until(t + 10)
        t += 10
        la = RESULTS.get("last_avg", {})
        if len(la) == 6 and all(abs(v - 30.0) < tol for v in la.values()):
            s4u_rounds = t
            break
    eng._hostdes.shutdown()
    assert s4u_rounds is not None
    topo = load_deployment(ACTORS).to_topology(load_platform(PLATFORM))
    rmse, _est, _la, _ev = native.des_run_traj(
        topo, "collectall", timeout=Peer.TICK_TIMEOUT, ticks=1000,
        obs_every=10)
    below = np.asarray(rmse) < tol
    assert below.any()
    des_rounds = int((np.argmax(below) + 1) * 10)
    ratio = s4u_rounds / des_rounds
    assert 0.4 <= ratio <= 2.5, (s4u_rounds, des_rounds, ratio)


def test_actor_exception_does_not_kill_the_simulation(host_engine, caplog):
    def crasher():
        s4u.this_actor.sleep_for(5.0)
        raise RuntimeError("boom")

    s4u.Actor.create("crasher", s4u.Host.by_name("Lisboa"), crasher)
    s4u.Actor.create("watcher", s4u.Host.by_name("Lisboa"),
                     watcher, 150.0, 10.0)
    with caplog.at_level(logging.ERROR, logger="flow_updating_tpu_torch"):
        host_engine.run_until(200.0)
    assert any("crasher" in r.message for r in caplog.records)
    last = RESULTS["last_avg"]
    assert len(last) == 6
    for avg in last.values():
        assert avg == pytest.approx(30.0, abs=0.5)


def test_cancel_wakes_cross_actor_waiter(host_engine):
    seen = {}

    def receiver():
        comm = s4u.Mailbox.by_name("never-served").get_async()
        seen["comm"] = comm
        try:
            comm.wait()
            seen["outcome"] = "returned"
        except s4u.CancelException:
            seen["outcome"] = "cancelled"
        seen["clock"] = s4u.Engine.clock

    def canceller():
        s4u.this_actor.sleep_for(3.0)
        seen["comm"].cancel()

    s4u.Actor.create("waiter", s4u.Host.by_name("Lisboa"), receiver)
    s4u.Actor.create("canceller", s4u.Host.by_name("Porto"), canceller)
    host_engine.run_until(30.0)
    assert seen["outcome"] == "cancelled"
    assert seen["clock"] == pytest.approx(3.0)


def test_wait_after_cancel_of_completed_comm_returns(host_engine):
    got = {}

    def sender():
        s4u.Mailbox.by_name("done-box").put_async("payload", 1)

    def receiver():
        s4u.this_actor.sleep_for(1.0)
        comm = s4u.Mailbox.by_name("done-box").get_async()
        comm.wait()
        comm.cancel()
        got["payload"] = comm.wait().get_payload()

    s4u.Actor.create("done-sender", s4u.Host.by_name("Lisboa"), sender)
    s4u.Actor.create("done-box", s4u.Host.by_name("Porto"), receiver)
    host_engine.run_until(30.0)
    assert got["payload"] == "payload"


def test_verbs_outside_the_runtime_raise():
    with pytest.raises(RuntimeError, match="inside a running actor"):
        s4u.this_actor.get_host()
    prev = s4u._CURRENT_DES
    s4u._CURRENT_DES = None
    try:
        with pytest.raises(RuntimeError, match="host_actors=True"):
            s4u.Mailbox.by_name("x")
    finally:
        s4u._CURRENT_DES = prev


def test_shutdown_joins_every_thread_and_logs_events():
    import io
    import json

    from flow_updating_tpu_torch.utils.eventlog import EventLog

    RESULTS.clear()
    buf = io.StringIO()
    log = EventLog(buf)
    eng = Engine(host_actors=True, event_log=log, device="cpu")
    eng.load_platform(PLATFORM)
    eng.register_actor("peer", Peer)
    eng.load_deployment(ACTORS)
    eng.run_until(40.0)
    des = eng._hostdes
    threads = [c.thread for c in des.actors]
    assert all(t.is_alive() for t in threads)
    des.shutdown()
    assert not any(t.is_alive() for t in threads)
    assert all(c.done for c in des.actors)
    des.shutdown()       # twice is harmless
    kinds = {json.loads(line)["kind"]
             for line in buf.getvalue().splitlines()}
    assert {"actor_spawn", "comm_put", "comm_deliver",
            "actor_exit"} <= kinds
    # a dropped engine's finalizer does the same
    eng2 = _engine()
    eng2.run_until(5.0)
    names = {c.thread.name for c in eng2._hostdes.actors}
    del eng2
    import gc

    gc.collect()
    assert not [t for t in threading.enumerate() if t.name in names]
