"""Robust aggregation (``robust='clip'|'trim'``) in the port's edge round
against the JAX package's.

The same numpy-seeded topology and values go through JAX ``run_rounds``
and the port's at float64.  One JAX run per (robust mode, variant, fire
policy) is the oracle for the port under every ``segment_impl`` (on the
CPU the networks run their plain versions): estimates, ledgers and
``last_avg`` agree to 1e-9, and the integer and boolean fields (fire
counters, stamps, receive marks) exactly; the fused networks equal the
per-stage ones bit for bit.  Also: ``(N, D)``
clip, trim refusing vector payloads, the halo round with robust modes
held to the single-device round on the renumbered topology, and the JAX
package's robust scenario cases without adversaries (clip conserves mass,
trim contains a value outlier, disarmed trim equals off bit for bit).
"""

import dataclasses

import numpy as np
import pytest
import torch

from flow_updating_tpu.models.config import RoundConfig as JaxConfig
from flow_updating_tpu.models.rounds import node_estimates as jax_estimates
from flow_updating_tpu.models.rounds import run_rounds as jax_run
from flow_updating_tpu.models.state import init_state as jax_init
from flow_updating_tpu.topology import generators as jgen
from flow_updating_tpu_torch import Engine, RoundConfig
from flow_updating_tpu_torch.models import rounds
from flow_updating_tpu_torch.models.state import init_state
from flow_updating_tpu_torch.parallel import sharded
from flow_updating_tpu_torch.parallel.mesh import make_mesh
from flow_updating_tpu_torch.topology import generators as pgen

TOL = dict(rtol=1e-9, atol=1e-9)
ROUNDS = 60
SEGMENTS = ("segment", "ell", "benes", "benes_fused")
# the arming knobs: a tolerance below the early neighborhood spreads of
# uniform [0, 1) values, a clamp below the early flows
KNOBS = {"clip": dict(robust_clip=0.05), "trim": dict(robust_tol=0.05)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def graphs():
    return (jgen.barabasi_albert(48, m=3, seed=4),
            pgen.barabasi_albert(48, m=3, seed=4))


def _make(cls, variant, mode, robust, **kw):
    make = cls.reference if mode == "reference" else cls.fast
    return make(variant, dtype="float64", robust=robust,
                **KNOBS.get(robust, {}), **kw)


def _arrays(topo, cfg, **dev):
    return topo.device_arrays(
        coloring=cfg.needs_coloring, segment_ell=cfg.use_segment_ell,
        segment_benes=cfg.segment_benes_mode,
        delivery_benes=cfg.delivery_benes_mode, **dev)


def _port_run(topo, cfg, n=ROUNDS, values=None):
    arrays = _arrays(topo, cfg, device="cpu")
    st = init_state(topo, cfg, seed=3, values=values, device="cpu")
    return rounds.run_rounds(st, arrays, cfg, n), arrays


def _jax_run(topo, cfg, n=ROUNDS, values=None):
    arrays = _arrays(topo, cfg)
    return jax_run(jax_init(topo, cfg, seed=3, values=values), arrays, cfg,
                   n), arrays


INT_FIELDS = ("t", "fired", "ticks", "stamp", "recv", "pending_valid",
              "buf_valid")
FLOAT_FIELDS = ("flow", "est", "last_avg", "buf_flow", "buf_est")


@pytest.mark.parametrize("robust", ["clip", "trim"])
@pytest.mark.parametrize("variant,mode", [
    ("collectall", "reference"), ("collectall", "every_round"),
    ("pairwise", "reference"), ("pairwise", "every_round")])
def test_robust_round_matches_jax_under_every_segment_impl(
        graphs, robust, variant, mode):
    jt, pt = graphs
    jc = _make(JaxConfig, variant, mode, robust, drop_rate=0.1)
    js, ja = _jax_run(jt, jc)
    want = np.asarray(jax_estimates(js, ja))
    runs = {}
    for seg, dlv in zip(SEGMENTS, ("gather", "scatter", "benes",
                                   "benes_fused")):
        pc = _make(RoundConfig, variant, mode, robust, drop_rate=0.1,
                   segment_impl=seg, delivery=dlv)
        ps, pa = _port_run(pt, pc)
        np.testing.assert_allclose(rounds.node_estimates(ps, pa).numpy(),
                                   want, **TOL, err_msg=seg)
        for name in FLOAT_FIELDS:
            np.testing.assert_allclose(getattr(ps, name).numpy(),
                                       np.asarray(getattr(js, name)),
                                       **TOL, err_msg=f"{seg} {name}")
        for name in INT_FIELDS:
            np.testing.assert_array_equal(getattr(ps, name).numpy(),
                                          np.asarray(getattr(js, name)),
                                          err_msg=f"{seg} {name}")
        runs[seg] = ps
    # the fused networks (kernels B3 and B4 on the card) equal the
    # per-stage ones bit for bit
    for name in FLOAT_FIELDS + INT_FIELDS:
        assert torch.equal(getattr(runs["benes"], name),
                           getattr(runs["benes_fused"], name)), name
    if robust == "clip":   # the clamp bound, and it binds
        flow = runs["segment"].flow.abs()
        assert flow.max() <= KNOBS["clip"]["robust_clip"] + 1e-15
        assert (flow == KNOBS["clip"]["robust_clip"]).any()


def test_trim_arms_and_changes_the_trajectory(graphs):
    _, pt = graphs
    off = RoundConfig.fast("collectall", dtype="float64")
    trim = _make(RoundConfig, "collectall", "every_round", "trim")
    a, arr = _port_run(pt, off, 5)
    b, _ = _port_run(pt, trim, 5)
    assert not torch.equal(a.flow, b.flow)
    mark = rounds._trim_extreme_edges(b, arr, trim, torch.float64)
    assert 0 < int(mark.sum()) <= 2 * pt.num_nodes


def test_vector_clip_matches_jax_and_trim_refuses_vectors(graphs):
    jt, pt = graphs
    values = np.random.default_rng(6).normal(size=(pt.num_nodes, 3))
    jc = _make(JaxConfig, "collectall", "reference", "clip")
    pc = _make(RoundConfig, "collectall", "reference", "clip",
               segment_impl="benes_fused", delivery="benes_fused")
    js, ja = _jax_run(jt, jc, values=values)
    ps, pa = _port_run(pt, pc, values=values)
    np.testing.assert_allclose(rounds.node_estimates(ps, pa).numpy(),
                               np.asarray(jax_estimates(js, ja)), **TOL)
    np.testing.assert_allclose(ps.flow.numpy(), np.asarray(js.flow), **TOL)
    for mode in ("reference", "every_round"):
        for variant in ("collectall", "pairwise"):
            cfg = _make(RoundConfig, variant, mode, "trim")
            with pytest.raises(ValueError, match="robust='clip' for"):
                _port_run(pt, cfg, 1, values=values)


# ---- the halo round ------------------------------------------------------

@pytest.mark.parametrize("halo", ["ppermute", "overlap", "overlap_pallas"])
@pytest.mark.parametrize("robust,variant", [
    ("clip", "collectall"), ("trim", "collectall"), ("clip", "pairwise"),
    ("trim", "pairwise")])
def test_halo_round_with_robust_equals_single_device(halo, robust, variant):
    """BFS renumbers the rows, so the faithful halo round equals the
    single-device round on the plan's (renumbered) topology."""
    topo = pgen.erdos_renyi(120, seed=2)
    cfg = _make(RoundConfig, variant, "reference", robust)
    mesh = make_mesh(4, device="cpu")
    plan = sharded.plan_sharding(topo, 4, partition="bfs")
    st = sharded.init_plan_state(plan, cfg, mesh, seed=1)
    st = sharded.run_rounds_sharded(st, plan, cfg, mesh, 70, halo=halo)
    got = sharded.gather_estimates(st, plan)

    single, arrays = None, _arrays(plan.topo, cfg, device="cpu")
    single = rounds.run_rounds(init_state(plan.topo, cfg, seed=1,
                                          device="cpu"), arrays, cfg, 70)
    want = rounds.node_estimates(single, arrays).numpy()
    # plan.topo is in the partition's order; gather_estimates undoes it
    out = np.empty_like(want)
    out[plan.order] = want
    np.testing.assert_allclose(got, out, rtol=0, atol=1e-12)
    if robust == "clip":
        for s in st.shards:
            assert s.flow.abs().max() <= KNOBS["clip"]["robust_clip"] + 1e-15


def test_halo_engine_runs_robust_and_refuses_it_on_fast_pairwise():
    topo = pgen.erdos_renyi(80, seed=5)
    cfg = _make(RoundConfig, "collectall", "reference", "trim")
    eng = Engine(config=cfg, mesh=make_mesh(2, device="cpu"),
                 multichip="halo", halo="overlap_pallas", device="cpu")
    eng.set_topology(topo).build()
    eng.run_rounds(40)
    assert np.isfinite(eng.estimates()).all()
    fast = _make(RoundConfig, "pairwise", "every_round", "clip")
    with pytest.raises(ValueError, match="fast synchronous pairwise"):
        Engine(config=fast, mesh=make_mesh(2, device="cpu"),
               multichip="halo", device="cpu").set_topology(topo).build()


# ---- the JAX package's robust scenario cases, without adversaries ---------

def _community(n, seed, values):
    topo = pgen.community(n, c=2, k_in=6.0, k_out=0.0, seed=seed)
    return dataclasses.replace(topo, values=np.asarray(values, np.float64))


def _run(topo, cfg, n):
    arrays = _arrays(topo, cfg, device="cpu")
    st = rounds.run_rounds(init_state(topo, cfg, seed=0, device="cpu"),
                           arrays, cfg, n)
    return st, arrays


def test_pairwise_clip_conserves_mass_and_converges_honest():
    vals = np.random.default_rng(5).uniform(0.0, 1.0, 48)
    topo = _community(48, 0, vals)
    for make in (RoundConfig.fast, RoundConfig.reference):
        cfg = make("pairwise", robust="clip", robust_clip=8.0,
                   dtype="float64")
        st, arrays = _run(topo, cfg, 600)
        flow = st.flow.numpy()
        assert np.abs(flow).max() <= 8.0 + 1e-12
        if cfg.fire_policy != "reference":
            np.testing.assert_allclose(flow, -flow[topo.rev], atol=1e-12)
        est = rounds.node_estimates(st, arrays).numpy()
        assert np.max(np.abs(est - topo.true_mean)) < 1e-2


def test_pairwise_clip_tight_clamp_still_conserves():
    vals = np.zeros(32)
    vals[0] = 32.0
    topo = _community(32, 0, vals)
    cfg = RoundConfig.fast("pairwise", robust="clip", robust_clip=0.05,
                           dtype="float64")
    st, arrays = _run(topo, cfg, 64)
    est = rounds.node_estimates(st, arrays).numpy()
    assert abs(est.sum() - vals.sum()) < 1e-9
    assert st.flow.abs().max() <= 0.05 + 1e-12


def test_pairwise_trim_contains_value_outlier():
    vals = np.random.default_rng(7).uniform(0.0, 1.0, 48)
    vals[0] = 500.0
    topo = dataclasses.replace(
        pgen.community(48, c=2, k_in=8.0, k_out=0.0, seed=3), values=vals)

    def run(robust, **kw):
        cfg = RoundConfig.fast("pairwise", robust=robust, dtype="float64",
                               **kw)
        st, arrays = _run(topo, cfg, 300)
        est = rounds.node_estimates(st, arrays).numpy()
        assert abs(est.sum() - vals.sum()) < 1e-6, robust
        return est

    gmean = vals.mean()
    assert abs(run("off")[0] - gmean) < 0.5 * gmean
    assert run("trim", robust_tol=2.0)[0] > 2.5 * gmean


@pytest.mark.parametrize("variant", ["collectall", "pairwise"])
def test_trim_disarmed_matches_off_bit_for_bit(variant):
    topo = _community(32, 0, np.random.default_rng(5).uniform(0, 1, 32))
    for make in (RoundConfig.fast, RoundConfig.reference):
        off = make(variant, dtype="float64")
        trim = make(variant, robust="trim", robust_tol=1e6, dtype="float64")
        a, _ = _run(topo, off, 50)
        b, _ = _run(topo, trim, 50)
        assert torch.equal(a.flow, b.flow)
        assert torch.equal(a.est, b.est)


def test_trim_and_clip_keep_honest_convergence():
    topo = _community(48, 0, np.random.default_rng(5).uniform(0, 1, 48))
    for cfg in (RoundConfig.fast(robust="clip", robust_clip=8.0),
                RoundConfig.fast(robust="trim", robust_tol=2.0)):
        st, arrays = _run(topo, cfg, 200)
        est = rounds.node_estimates(st, arrays).numpy()
        assert np.max(np.abs(est - topo.true_mean)) < 1e-3, cfg.robust
