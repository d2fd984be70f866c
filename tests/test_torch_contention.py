"""Shared-link contention in the port's edge round against the JAX
package's.

``edge_delays`` — quasi-static (``contention_iters=0``), the
progressive-filling water-fill (``contention_iters > 0``) and the backlog
of in-flight messages — gives the JAX package's ``int32`` delays bit for
bit on a hand-built star, on the two-level and FATPIPE systems of the JAX
suite and on the repo's ``small6`` platform; its float32 per-link sums run
in a fixed order (``Topology.link_csr``), which on the CPU is JAX's order.
Also: ``contended_max_delay`` and the Engine's ``delay_depth`` sizing,
``send_messages`` charging the transmitting edge's route, whole runs
(``RoundConfig.fidelity`` included) and their ``run_rounds_observed``
curves against JAX at float64, the kernel against the port's same-model
DES oracle, the water-fill against an exact max-min solve (hypothesis),
the CLI flags, and a mesh refusing contention as JAX's engine does.
"""

import dataclasses
import json
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from hypothesis import assume, given, settings
from hypothesis import strategies as st

from flow_updating_tpu.cli import main as jax_main
from flow_updating_tpu.engine import Engine as JaxEngine
from flow_updating_tpu.models import rounds as jrounds
from flow_updating_tpu.models.config import RoundConfig as JaxConfig
from flow_updating_tpu.models.state import init_state as jax_init
from flow_updating_tpu.topology.deployment import load_deployment as jdep
from flow_updating_tpu.topology.graph import build_topology as jbuild
from flow_updating_tpu.topology.platform import load_platform as jplat
from flow_updating_tpu_torch import Engine, RoundConfig, native
from flow_updating_tpu_torch.cli import main as port_main
from flow_updating_tpu_torch.models import rounds
from flow_updating_tpu_torch.models.state import init_state
from flow_updating_tpu_torch.parallel.mesh import make_mesh
from flow_updating_tpu_torch.plan.compile import reorder_topology_stable
from flow_updating_tpu_torch.topology.deployment import load_deployment
from flow_updating_tpu_torch.topology.generators import ring
from flow_updating_tpu_torch.topology.graph import build_topology
from flow_updating_tpu_torch.topology.platform import load_platform

PLATFORM = "examples/platforms/small6.xml"
ACTORS = "examples/deployments/small6_actors.xml"
TOL = dict(rtol=1e-9, atol=1e-9)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def _small6(latency_scale=100.0, msg_bytes=1e5):
    kw = dict(tick_interval=1.0, latency_scale=latency_scale,
              msg_bytes=msg_bytes)
    return (jdep(ACTORS).to_topology(platform=jplat(PLATFORM), **kw),
            load_deployment(ACTORS).to_topology(
                platform=load_platform(PLATFORM), **kw))


def _both(*args, **kw):
    return jbuild(*args, **kw), build_topology(*args, **kw)


def _star(leaves=7):
    """A hub and ``leaves`` spokes; a spoke's route is its own link and
    the hub's uplink (both shared), the last spoke rides a FATPIPE."""
    pairs = [(0, i) for i in range(1, leaves + 1)]
    caps = 104.0 / np.array([3.0, 0.7, 1.5, 2.0, 0.4, 1.1, 2.5, 0.9])
    route = {(0, i): (i, 0) for i in range(1, leaves + 1)}
    shared = np.ones(leaves + 1, bool)
    shared[leaves] = False
    return _both(leaves + 1, np.array(pairs),
                 values=np.arange(leaves + 1, dtype=np.float64),
                 latency_s={p: 0.5 + 0.3 * i for i, p in enumerate(pairs)},
                 latency_scale=1.0, msg_bytes=104.0, route_links=route,
                 link_caps=caps[: leaves + 1], link_shared=shared)


def _two_level():
    """The JAX suite's two bottleneck levels (``test_lmm.py``)."""
    pairs = [(0, 1), (2, 3), (4, 5), (6, 7)]
    caps = np.array([104.0 / 4.0, 104.0 / (4.0 / 3.0)])
    route = {(0, 1): (0,), (2, 3): (0, 1), (4, 5): (1,), (6, 7): (1,)}
    return _both(8, np.array(pairs),
                 values=np.arange(8, dtype=np.float64),
                 latency_s={p: 1.0 for p in pairs},
                 bandwidth={p: float(caps[min(route[p])]) for p in pairs},
                 latency_scale=1.0, msg_bytes=104.0, route_links=route,
                 link_caps=caps, link_shared=np.array([True, True]))


def _fatpipe(ser_rounds=4.0):
    caps = np.array([104.0 / ser_rounds])
    return _both(2, np.array([(0, 1)]),
                 values=np.array([1.0, 5.0]), latency_s={(0, 1): 1.0},
                 bandwidth={(0, 1): float(caps[0])}, latency_scale=1.0,
                 msg_bytes=104.0, route_links={(0, 1): (0,)},
                 link_caps=caps, link_shared=np.array([False]))


TOPOS = {"star": _star, "two_level": _two_level, "fatpipe": _fatpipe,
         "small6": lambda: _small6(), "small6_1e6": lambda: _small6(
             msg_bytes=1e6)}


@pytest.mark.parametrize("name", list(TOPOS))
@pytest.mark.parametrize("iters", [0, 4])
def test_edge_delays_equal_jax(name, iters):
    jt, pt = TOPOS[name]()
    ja, pa = jt.device_arrays(), pt.device_arrays(device="cpu")
    rng = np.random.default_rng(11)
    for backlog in (False, True):
        kw = dict(delay_depth=64, contention=True, contention_iters=iters,
                  contention_backlog=backlog)
        jc, pc = JaxConfig.reference(**kw), RoundConfig.reference(**kw)
        for p in (0.3, 0.7, 1.0):
            send = rng.random(pt.num_edges) < p
            inflight = rng.integers(0, 4, pt.num_edges).astype(np.int32)
            want = np.asarray(jrounds.edge_delays(
                ja, jc, jnp.asarray(send), inflight=jnp.asarray(inflight)))
            got = rounds.edge_delays(pa, pc, torch.from_numpy(send),
                                     inflight=torch.from_numpy(inflight))
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want)


def test_device_link_arrays_are_jax_s():
    jt, pt = _small6()
    ja, pa = jt.device_arrays(), pt.device_arrays(device="cpu")
    assert pa.link_ser_rounds.dtype == pa.lat_rounds.dtype == torch.float32
    for name in ("edge_links", "link_ser_rounds", "link_shared",
                 "lat_rounds"):
        np.testing.assert_array_equal(getattr(pa, name).numpy(),
                                      np.asarray(getattr(ja, name)), name)
    gather, lengths = pt.link_csr()
    assert lengths.sum() == gather.size == pt.edge_links.size + len(lengths)
    # a compiler reorder carries the four link fields with its edges
    order = np.arange(pt.num_nodes)[::-1].copy()
    moved, e_order = reorder_topology_stable(pt, order)
    np.testing.assert_array_equal(moved.edge_links, pt.edge_links[e_order])
    np.testing.assert_array_equal(moved.lat_rounds, pt.lat_rounds[e_order])
    assert moved.link_ser_rounds is pt.link_ser_rounds
    assert moved.link_shared is pt.link_shared
    np.testing.assert_array_equal(
        rounds.edge_delays(moved.device_arrays(device="cpu"),
                           RoundConfig.reference(delay_depth=64,
                                                 contention=True),
                           torch.ones(pt.num_edges, dtype=torch.bool)),
        rounds.edge_delays(pa, RoundConfig.reference(delay_depth=64,
                                                     contention=True),
                           torch.ones(pt.num_edges,
                                      dtype=torch.bool))[e_order])
    assert pt.has_link_model and not load_deployment(ACTORS).to_topology(
        platform=load_platform(PLATFORM)).has_link_model


def test_waterfill_and_fatpipe_cases_of_the_jax_suite():
    _, pt = _two_level()
    pa = pt.device_arrays(device="cpu")
    mask = torch.zeros(pt.num_edges, dtype=torch.bool)
    mask[[0, 2, 4, 6]] = True
    local = RoundConfig.reference(delay_depth=16, contention=True)
    fill = dataclasses.replace(local, contention_iters=2)
    d0 = rounds.edge_delays(pa, local, mask).numpy()
    d2 = rounds.edge_delays(pa, fill, mask).numpy()
    assert d0[0] == d0[2] == d2[0] == d2[2] == 9
    assert d0[4] == d0[6] == 5 and d2[4] == d2[6] == 4
    assert np.all(d2 <= d0)
    _, pt = _fatpipe()
    pa = pt.device_arrays(device="cpu")
    ones = torch.ones(pt.num_edges, dtype=torch.bool)
    assert (rounds.edge_delays(pa, local, ones) == 5).all()
    assert (rounds.edge_delays(pa, fill, ones) == 5).all()


@pytest.mark.parametrize("name", ["star", "small6", "small6_1e6"])
def test_contended_max_delay_and_engine_depth_equal_jax(name):
    jt, pt = TOPOS[name]()
    for kw in ({}, {"max_flows": 2}, {"inflight_per_edge": 3}):
        assert pt.contended_max_delay(**kw) == jt.contended_max_delay(**kw)
    for backlog in (False, True):
        cfg = dict(contention=True, contention_backlog=backlog)
        je = JaxEngine(config=JaxConfig.reference(**cfg)).set_topology(jt)
        pe = Engine(config=RoundConfig.reference(**cfg),
                    device="cpu").set_topology(pt)
        je.build()
        pe.build()
        assert pe.config.delay_depth == je.config.delay_depth
        base = pt.contended_max_delay()
        assert base <= pe.config.delay_depth <= 4 * max(base, 4)


def test_backlog_charges_the_transmitting_edges_route():
    caps = np.array([104.0 / 4.0, 104.0 / 4.0])
    topo = build_topology(
        2, np.array([(0, 1)]), values=np.array([1.0, 5.0]),
        latency_s={(0, 1): 1.0}, bandwidth={(0, 1): float(caps[0])},
        latency_scale=1.0, msg_bytes=104.0,
        route_links={(0, 1): (0,), (1, 0): (1,)}, link_caps=caps,
        link_shared=np.array([True, True]))
    arrays = topo.device_arrays(device="cpu")
    e01 = int(np.flatnonzero((topo.src == 0) & (topo.dst == 1))[0])
    e10 = int(topo.rev[e01])
    D = 16
    cfg = RoundConfig.reference(delay_depth=D, contention=True,
                                contention_backlog=True)
    state = init_state(topo, cfg, device="cpu")
    buf_valid = state.buf_valid.clone()
    buf_valid[D - 1, e10] = True            # one message in flight on e01
    state = state.replace(buf_valid=buf_valid)

    def sent_delay(edge):
        mask = torch.zeros(topo.num_edges, dtype=torch.bool)
        mask[edge] = True
        out = rounds.send_messages(state, arrays, cfg, state.est, mask)
        new = out.buf_valid & ~state.buf_valid
        slots = torch.nonzero(new[:, int(topo.rev[edge])]).flatten()
        assert len(slots) == 1
        return int(slots[0])

    assert sent_delay(e01) == 9
    assert sent_delay(e10) == 5


CONFIGS = {
    "quasi_static": dict(contention=True),
    "waterfill": dict(contention=True, contention_iters=4),
    "backlog": dict(contention=True, contention_backlog=True),
    "both": dict(contention=True, contention_iters=3,
                 contention_backlog=True),
}


@pytest.mark.parametrize("variant", ["collectall", "pairwise"])
@pytest.mark.parametrize("name", list(CONFIGS) + ["fidelity"])
def test_contended_run_matches_jax(variant, name):
    jt, pt = _small6(msg_bytes=1e6)
    if name == "fidelity":
        jc = JaxConfig.fidelity(variant, dtype="float64")
        pc = RoundConfig.fidelity(variant, dtype="float64")
    else:
        jc = JaxConfig.reference(variant, dtype="float64", **CONFIGS[name])
        pc = RoundConfig.reference(variant, dtype="float64", **CONFIGS[name])
    je = JaxEngine(config=jc).set_topology(jt)
    pe = Engine(config=pc, device="cpu").set_topology(pt)
    je.build(latency_scale=100.0)
    pe.build(latency_scale=100.0)
    assert pe.config == dataclasses.replace(pc, delay_depth=je.config.
                                            delay_depth)
    _, jm = jrounds.run_rounds_observed(
        jax_init(jt, je.config), jt.device_arrays(), je.config, 400, 10,
        jt.true_mean)
    ps, pm = rounds.run_rounds_observed(
        init_state(pt, pe.config, device="cpu"),
        pt.device_arrays(device="cpu"), pe.config, 400, 10, pt.true_mean)
    for key in ("rmse", "max_abs_err", "mass"):
        np.testing.assert_allclose(pm[key].numpy(), np.asarray(jm[key]),
                                   **TOL, err_msg=key)
    for key in ("t", "fired_total"):
        np.testing.assert_array_equal(pm[key].numpy(), np.asarray(jm[key]))


def _rounds_to(curve, th, obs=10):
    below = np.asarray(curve) < th
    return int((np.argmax(below) + 1) * obs) if below.any() else None


def test_kernel_against_the_same_model_des_oracle():
    """``contention_backlog`` has a same-model twin in the DES
    (``des_run_contend(backlog=True)``).  On small6 at latency scale 100
    and 1e6-byte messages (delays up to 5 rounds) collect-all reaches
    1e-2 and 1e-3 in exactly the DES's rounds (810 and 1090).  The
    contract is not general: at 1e5-byte messages, where every delay
    rounds to 1, the kernel takes 150 and 180 rounds against the DES's 180
    and 210 — as the JAX package's kernel does, which the port's equals
    (``test_contended_run_matches_jax``).  Pairwise is reported, not
    bounded: 430 and 610 rounds against the DES's 660 and 860."""
    _, topo = _small6(msg_bytes=1e6)
    D = topo.contended_max_delay()
    arrays = topo.device_arrays(device="cpu")
    got = {}
    for variant in ("collectall", "pairwise"):
        orc = native.des_run_contend(topo, variant, timeout=50, ticks=1200,
                                     obs_every=10, clamp_d=D,
                                     backlog=True)[0]
        cfg = RoundConfig.reference(variant, delay_depth=D, contention=True,
                                    contention_backlog=True,
                                    dtype="float64")
        _, m = rounds.run_rounds_observed(init_state(topo, cfg,
                                                     device="cpu"),
                                          arrays, cfg, 1200, 10,
                                          topo.true_mean)
        got[variant] = [(_rounds_to(m["rmse"].numpy(), th),
                         _rounds_to(orc, th)) for th in (1e-2, 1e-3)]
    assert got["collectall"] == [(810, 810), (1090, 1090)]
    assert got["pairwise"] == [(430, 660), (610, 860)]


# ---- the water-fill against an exact max-min solve ------------------------

def _ref_maxmin(routes, caps, shared):
    """Exact progressive-filling max-min in float64 (the JAX suite's)."""
    F, L = len(routes), len(caps)
    cap_rem = [caps[l] if shared[l] else math.inf for l in range(L)]
    nflow = [0] * L
    for r in routes:
        for l in r:
            nflow[l] += 1
    own = [min((caps[l] for l in r if not shared[l]), default=math.inf)
           for r in routes]
    rate = [None] * F
    while any(v is None for v in rate):
        def fair(i):
            f = own[i]
            for l in routes[i]:
                if shared[l] and nflow[l] > 0:
                    f = min(f, cap_rem[l] / nflow[l])
            return f
        pend = [i for i in range(F) if rate[i] is None]
        best = min(fair(i) for i in pend)
        if best == math.inf:
            for i in pend:
                rate[i] = math.inf
            break
        for i in pend:
            if fair(i) <= best * (1 + 1e-12):
                rate[i] = fair(i)
                for l in routes[i]:
                    if shared[l]:
                        cap_rem[l] = max(cap_rem[l] - rate[i], 0.0)
                    nflow[l] -= 1
    return rate


@settings(max_examples=40, deadline=None)
@given(st.data())
def test_waterfill_property_matches_exact_maxmin(data):
    n_pairs = data.draw(st.integers(1, 5), label="pairs")
    L = data.draw(st.integers(1, 3), label="links")
    caps = [data.draw(st.sampled_from([0.2, 0.3, 0.8, 1.7, 4.0]),
                      label=f"cap{l}") for l in range(L)]
    shared = [data.draw(st.booleans(), label=f"sh{l}") for l in range(L)]
    routes = [tuple(sorted(data.draw(
        st.sets(st.integers(0, L - 1), min_size=1, max_size=L),
        label=f"route{i}"))) for i in range(n_pairs)]
    pairs = [(2 * i, 2 * i + 1) for i in range(n_pairs)]
    topo = build_topology(
        2 * n_pairs, np.array(pairs),
        values=np.arange(2 * n_pairs, dtype=np.float64),
        latency_s={p: 1.0 for p in pairs},
        bandwidth={p: 104.0 * min(caps[l] for l in routes[i])
                   for i, p in enumerate(pairs)},
        latency_scale=1.0, msg_bytes=104.0,
        route_links={p: routes[i] for i, p in enumerate(pairs)},
        link_caps=np.array([104.0 * c for c in caps]),
        link_shared=np.array(shared))
    send = [int(np.flatnonzero((topo.src == a) & (topo.dst == b))[0])
            for a, b in pairs]
    mask = torch.zeros(topo.num_edges, dtype=torch.bool)
    mask[send] = True
    expected = []
    for rate in _ref_maxmin(routes, caps, shared):
        tr = 0.0 if rate == math.inf else 1.0 / rate
        assume(abs((1.0 + tr) % 1.0 - 0.5) > 0.05)
        expected.append(int(np.rint(1.0 + tr).clip(1, 64)))
    cfg = RoundConfig.reference(delay_depth=64, contention=True,
                                contention_iters=8)
    got = rounds.edge_delays(topo.device_arrays(device="cpu"), cfg, mask)
    assert got[send].tolist() == expected


# ---- the CLI and the engine's refusals ------------------------------------

@pytest.mark.parametrize("flags", [
    ["--contention"], ["--contention", "--contention-iters", "4"],
    ["--contention", "--contention-backlog"], ["--fidelity"],
    ["--fidelity", "--variant", "pairwise"],
    ["--fidelity", "--contention-iters", "2", "--contention-backlog"]])
def test_cli_contention_flags_match_jax(capsys, flags):
    argv = ["--platform", PLATFORM, "--deployment", ACTORS, "--msg-bytes",
            "1e6", "--rounds", "300", *flags]
    if "--fidelity" not in flags:
        argv += ["--latency-scale", "100"]
    with jax.enable_x64(False):
        assert jax_main(["run", "--backend", "cpu", *argv]) == 0
    jrep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert port_main(["run", "--device", "cpu", *argv]) == 0
    prep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for key in ("t", "nodes", "edges", "variant", "fire_policy"):
        assert prep[key] == jrep[key], key
    for key in ("rmse", "max_abs_err", "mass_residual"):
        assert abs(prep[key] - jrep[key]) <= 1e-3 * abs(jrep[key]) + 3e-5, \
            (key, prep[key], jrep[key])


def test_contention_needs_links_and_one_device():
    with pytest.raises(ValueError, match="link model"):
        Engine(config=RoundConfig.reference(contention=True),
               device="cpu").set_topology(_small6(latency_scale=0.0)[1]) \
            .build()
    _, topo = _small6()
    for kw in ({}, {"multichip": "halo"}):
        with pytest.raises(NotImplementedError, match="single-device"):
            Engine(config=RoundConfig.reference(contention=True),
                   mesh=make_mesh(2, device="cpu"), device="cpu", **kw) \
                .set_topology(topo).build()
    with pytest.raises(ValueError, match="link model"):
        rounds.edge_delays(ring(8, 1).device_arrays(device="cpu"),
                           RoundConfig.reference(contention=True),
                           torch.ones(16, dtype=torch.bool))
