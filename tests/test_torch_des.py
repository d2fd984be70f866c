"""The port's discrete-event simulator (``native.des_run*``) and its
``oracle`` subcommand against the JAX package's.

Both packages build the same C++ (``native/src/funative.cpp``, the
simulator copied byte for byte) with ``g++``, so on the same topology
every entry point gives bit-identical estimates, last averages, event
counts and rmse trajectories: ``des_run`` and ``des_run_traj`` on
Erdős–Rényi 100 and ``ring(24, 2)``, the three contention entries on the
repo's ``small6`` platform with its link model (a ring-buffer clamp, a
reshuffled visit order, the dynamic max-min model, backlog).  Also the
JAX package's DES cases run on the port: the oracle converges and
conserves mass, the port's faithful edge round reaches the DES fixed
point, the faithful trajectory stays in the calibrated band of the DES
(``test_dynamics_parity``), and the LMM oracle converges at a stable load
(``test_lmm``).
"""

import json

import numpy as np
import pytest
import torch

import jax_native  # noqa: F401  (JAX's native library, whole)

from flow_updating_tpu import cli as jax_cli
from flow_updating_tpu import native as jnative
from flow_updating_tpu.topology import generators as jgen
from flow_updating_tpu.topology.deployment import load_deployment as jdep
from flow_updating_tpu.topology.platform import load_platform as jplat
from flow_updating_tpu_torch import RoundConfig
from flow_updating_tpu_torch import cli as port_cli
from flow_updating_tpu_torch import native
from flow_updating_tpu_torch.models import rounds
from flow_updating_tpu_torch.models.state import init_state
from flow_updating_tpu_torch.topology import generators as pgen
from flow_updating_tpu_torch.topology.deployment import load_deployment
from flow_updating_tpu_torch.topology.platform import load_platform
from flow_updating_tpu_torch.utils.metrics import rmse

PLATFORM = "examples/platforms/small6.xml"
ACTORS = "examples/deployments/small6_actors.xml"
VARIANTS = ("collectall", "pairwise")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


GRAPHS = {
    "er100": (lambda: jgen.erdos_renyi(100, avg_degree=6.0, seed=5),
              lambda: pgen.erdos_renyi(100, avg_degree=6.0, seed=5)),
    "ring24": (lambda: jgen.ring(24, k=2, seed=9),
               lambda: pgen.ring(24, k=2, seed=9)),
}


def _small6(latency_scale=100.0, msg_bytes=1e5):
    kw = dict(tick_interval=1.0, latency_scale=latency_scale,
              msg_bytes=msg_bytes)
    return (jdep(ACTORS).to_topology(platform=jplat(PLATFORM), **kw),
            load_deployment(ACTORS).to_topology(
                platform=load_platform(PLATFORM), **kw))


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y)
        else:
            assert x == y


@pytest.mark.parametrize("graph", list(GRAPHS))
@pytest.mark.parametrize("variant", VARIANTS)
def test_des_run_and_traj_equal_jax(graph, variant):
    jt, pt = (make() for make in GRAPHS[graph])
    _same(native.des_run(pt, variant, timeout=20, ticks=400),
          jnative.des_run(jt, variant, timeout=20, ticks=400))
    _same(native.des_run_traj(pt, variant, timeout=20, ticks=400,
                              obs_every=7),
          jnative.des_run_traj(jt, variant, timeout=20, ticks=400,
                               obs_every=7))


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("kw", [
    dict(clamp_d=0), dict(clamp_d=6), dict(clamp_d=6, visit_seed=3),
    dict(clamp_d=0, lmm=True), dict(clamp_d=6, lmm=True, visit_seed=1),
    dict(clamp_d=6, backlog=True), dict(clamp_d=6, backlog=True,
                                        visit_seed=2)])
def test_des_contend_entries_equal_jax(variant, kw):
    jt, pt = _small6(msg_bytes=1e6)
    _same(native.des_run_contend(pt, variant, timeout=30, ticks=600,
                                 obs_every=10, **kw),
          jnative.des_run_contend(jt, variant, timeout=30, ticks=600,
                                  obs_every=10, **kw))


def test_des_guards():
    with pytest.raises(ValueError, match="backlog"):
        native.des_run_contend(object(), lmm=True, backlog=True)
    with pytest.raises(ValueError, match="link model"):
        native.des_run_contend(pgen.ring(8, 2))
    with pytest.raises(ValueError, match="variant"):
        native.des_run(pgen.ring(8, 2), "gossip")


def test_traj_does_not_perturb_the_run():
    topo = pgen.erdos_renyi(64, avg_degree=5.0, seed=2)
    a = native.des_run(topo, "pairwise", timeout=50, ticks=500)
    b = native.des_run_traj(topo, "pairwise", timeout=50, ticks=500,
                            obs_every=25)[1:]
    _same(a, b)


@pytest.mark.parametrize("variant", VARIANTS)
def test_des_oracle_converges_and_conserves_mass(variant):
    topo = pgen.erdos_renyi(100, avg_degree=6.0, seed=5)
    est, _, events = native.des_run(topo, variant, timeout=50, ticks=3000)
    assert events > 0
    assert np.sqrt(np.mean((est - topo.true_mean) ** 2)) < 1e-3
    assert est.sum() == pytest.approx(topo.values.sum(), rel=1e-6)


def _rounds_to(curve, obs, th):
    below = np.asarray(curve) < th
    return int((np.argmax(below) + 1) * obs) if below.any() else None


@pytest.mark.parametrize("variant", VARIANTS)
def test_faithful_edge_round_reaches_the_des_fixed_point(variant):
    topo = pgen.ring(24, k=2, seed=9)
    est, _, _ = native.des_run(topo, variant, timeout=50, ticks=4000)
    assert np.sqrt(np.mean((est - topo.true_mean) ** 2)) < 1e-3
    cfg = RoundConfig.reference(variant, dtype="float64")
    arrays = topo.device_arrays(device="cpu")
    st = rounds.run_rounds(init_state(topo, cfg, device="cpu"), arrays,
                           cfg, 4000)
    assert rmse(rounds.node_estimates(st, arrays).numpy(),
                topo.true_mean) < 1e-3


@pytest.mark.parametrize("variant", VARIANTS)
def test_faithful_trajectory_in_the_des_band(variant):
    """``test_dynamics_parity``'s band on the ring, where the JAX package
    measured the two sample-exact: rounds to 1e-3 and 1e-4 within
    [0.75, 1.2] of the DES, through ``run_rounds_observed``."""
    topo = pgen.ring(24, k=2, seed=9)
    des = native.des_run_traj(topo, variant, timeout=50, ticks=1200,
                              obs_every=10)[0]
    cfg = RoundConfig.reference(variant, delay_depth=topo.max_delay,
                                dtype="float64")
    _, m = rounds.run_rounds_observed(
        init_state(topo, cfg, device="cpu"), topo.device_arrays(device="cpu"),
        cfg, 1200, 10, topo.true_mean)
    assert m["rmse"].shape == (120,)
    assert torch.equal(m["t"], torch.arange(10, 1201, 10, dtype=torch.int32))
    for th in (1e-3, 1e-4):
        r_des, r_vec = (_rounds_to(des, 10, th),
                        _rounds_to(m["rmse"].numpy(), 10, th))
        assert r_des is not None and r_vec is not None
        assert 0.75 <= r_vec / r_des <= 1.2, (th, r_vec, r_des)


@pytest.mark.parametrize("variant", VARIANTS)
def test_lmm_oracle_converges_at_stable_load(variant):
    _, topo = _small6()
    curve, est, _, events = native.des_run_contend(
        topo, variant, timeout=50, ticks=3000, obs_every=10,
        clamp_d=topo.contended_max_delay(), lmm=True)
    assert events > 0
    assert _rounds_to(curve, 10, 1e-3) is not None
    assert np.mean(est) == pytest.approx(topo.true_mean, abs=1e-5)


@pytest.mark.parametrize("argv", [
    ["--generator", "erdos_renyi:100", "--ticks", "300"],
    ["--generator", "ring:24:2", "--variant", "pairwise", "--timeout",
     "10", "--ticks", "200"],
    ["--platform", PLATFORM, "--deployment", ACTORS, "--latency-scale",
     "100", "--msg-bytes", "1e5", "--lmm", "--ticks", "300"],
    ["--platform", PLATFORM, "--deployment", ACTORS, "--variant",
     "pairwise", "--ticks", "300"]])
def test_oracle_subcommand_prints_jax_json(argv, capsys):
    assert port_cli.main(["oracle", *argv]) == 0
    port = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert jax_cli.main(["oracle", "--backend", "cpu", *argv]) == 0
    jax = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert port == jax


def test_oracle_subcommand_refuses_lmm_without_links():
    with pytest.raises(SystemExit, match="link model"):
        port_cli.main(["oracle", "--generator", "ring:16:2", "--lmm"])


def test_help_lists_both_subcommands(capsys):
    with pytest.raises(SystemExit):
        port_cli.main(["--help"])
    # the plan subcommand joined run and oracle in A5, inspect and obs in
    # A9 part 2, doctor in A9 part 3, sweep and scenarios in A10, serve in
    # A11 part 1, query (and chaos, which names A11 part 3) in A11 part 2,
    # profile and regress in A14 part 1
    assert ("{run,oracle,plan,inspect,obs,sweep,scenarios,serve,query,"
            "chaos,doctor,profile,regress}") in capsys.readouterr().out
