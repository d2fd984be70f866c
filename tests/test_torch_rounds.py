"""The port's general per-edge round (``models/rounds.py``) against the JAX
package's.

The same numpy-seeded topology and payloads go through JAX ``run_rounds``
and the port's at float64; trajectories agree to 1e-9 (the contract) — in
practice to a few ulps.  The JAX runs cover every mode (collect-all and
pairwise, fast and faithful) with each ``segment_impl`` and ``delivery``
value, message loss on and off (the port's threefry replays JAX's draws)
and scalar and ``(N, D)`` payloads; the cross product of layouts, which
must not change a trajectory, is held port against port.  Also: the
faithful timeout bootstrap, carrying a JAX state across, the node kernel
against the edge kernel, vector columns against scalar runs, the items
that still raise, and the launch count ``chip_smoke.py`` derives for the
card.
"""

import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flow_updating_tpu.models.config import RoundConfig as JaxConfig
from flow_updating_tpu.models.rounds import node_estimates as jax_estimates
from flow_updating_tpu.models.rounds import run_rounds as jax_run
from flow_updating_tpu.models.state import init_state as jax_init
from flow_updating_tpu.topology import generators as jgen
from flow_updating_tpu_torch import Engine, NodeKernel, RoundConfig
from flow_updating_tpu_torch.models import rounds
from flow_updating_tpu_torch.models.state import (
    FlowUpdatingState,
    init_state,
    state_from_numpy,
)
from flow_updating_tpu_torch.topology import generators as pgen

TOL = dict(rtol=1e-9, atol=1e-9)
ROUNDS = 80           # past the faithful timeout bootstrap at round 50
SEGMENTS = ("segment", "ell", "benes", "benes_fused")
DELIVERIES = ("gather", "scatter", "benes", "benes_fused")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def graphs():
    return (jgen.barabasi_albert(60, m=3, seed=2),
            pgen.barabasi_albert(60, m=3, seed=2))


def _cfgs(variant, mode, **kw):
    make = "reference" if mode == "reference" else "fast"
    return (getattr(JaxConfig, make)(variant, dtype="float64", **kw),
            getattr(RoundConfig, make)(variant, dtype="float64", **kw))


def _port_run(topo, cfg, rounds_, values=None, seed=5):
    arrays = topo.device_arrays(
        coloring=cfg.needs_coloring, segment_ell=cfg.use_segment_ell,
        segment_benes=cfg.segment_benes_mode,
        delivery_benes=cfg.delivery_benes_mode, device="cpu")
    state = rounds.run_rounds(init_state(topo, cfg, seed=seed,
                                         values=values, device="cpu"),
                              arrays, cfg, rounds_)
    return state, arrays


def _jax_run(topo, cfg, rounds_, values=None, seed=5):
    arrays = topo.device_arrays(
        coloring=cfg.needs_coloring, segment_ell=cfg.use_segment_ell,
        segment_benes=cfg.segment_benes_mode,
        delivery_benes=cfg.delivery_benes_mode)
    state = jax_run(jax_init(topo, cfg, seed=seed, values=values), arrays,
                    cfg, rounds_)
    return state, arrays


# (variant, mode, segment_impl, delivery, drop_rate, vector payload)
JAX_CASES = [
    ("collectall", "reference", "segment", "gather", 0.0, False),
    ("collectall", "reference", "ell", "scatter", 0.1, False),
    ("collectall", "reference", "benes", "benes", 0.1, False),
    ("collectall", "reference", "benes_fused", "benes_fused", 0.1, False),
    ("collectall", "reference", "segment", "benes_fused", 0.0, True),
    ("collectall", "reference", "benes_fused", "gather", 0.1, True),
    ("collectall", "every_round", "segment", "gather", 0.1, False),
    ("collectall", "every_round", "ell", "benes", 0.0, True),
    ("collectall", "every_round", "benes_fused", "scatter", 0.0, False),
    ("pairwise", "reference", "segment", "gather", 0.1, False),
    ("pairwise", "reference", "ell", "benes_fused", 0.0, False),
    ("pairwise", "reference", "benes", "scatter", 0.1, True),
    ("pairwise", "reference", "benes_fused", "benes", 0.0, False),
    ("pairwise", "every_round", "segment", "gather", 0.0, False),
    ("pairwise", "every_round", "ell", "gather", 0.0, True),
    ("pairwise", "every_round", "benes", "gather", 0.0, False),
    ("pairwise", "every_round", "benes_fused", "gather", 0.0, False),
]


@pytest.mark.parametrize("variant,mode,seg,dlv,drop,vec", JAX_CASES)
def test_trajectory_matches_jax(graphs, variant, mode, seg, dlv, drop, vec):
    jt, pt = graphs
    jc, pc = _cfgs(variant, mode, segment_impl=seg, delivery=dlv,
                   drop_rate=drop)
    values = (np.random.default_rng(3).normal(size=(pt.num_nodes, 3))
              if vec else None)
    js, ja = _jax_run(jt, jc, ROUNDS, values)
    ps, pa = _port_run(pt, pc, ROUNDS, values)
    np.testing.assert_allclose(rounds.node_estimates(ps, pa).numpy(),
                               np.asarray(jax_estimates(js, ja)), **TOL)
    for name in ("flow", "est", "last_avg", "buf_flow", "pending_est"):
        np.testing.assert_allclose(getattr(ps, name).numpy(),
                                   np.asarray(getattr(js, name)), **TOL,
                                   err_msg=name)
    for name in ("t", "fired", "ticks", "stamp", "recv", "pending_valid",
                 "buf_valid", "pending_stamp"):
        np.testing.assert_array_equal(getattr(ps, name).numpy(),
                                      np.asarray(getattr(js, name)),
                                      err_msg=name)
    assert np.array_equal(ps.key.numpy(), np.asarray(js.key))
    if drop == 0.0 and mode == "reference":
        assert int(ps.fired.sum()) > 0


@pytest.mark.parametrize("variant,mode", [
    ("collectall", "reference"), ("collectall", "every_round"),
    ("pairwise", "reference"), ("pairwise", "every_round")])
@pytest.mark.parametrize("drop", [0.0, 0.1])
def test_every_layout_gives_one_trajectory(graphs, variant, mode, drop):
    """All segment_impl x delivery values give the trajectory of the
    'segment'/'gather' run (JAX-checked above): the Beneš layouts move
    data (bit-exact), the sums differ in order only."""
    _, pt = graphs
    base, _ = _port_run(pt, _cfgs(variant, mode, drop_rate=drop)[1], 60)
    delivs = DELIVERIES if not (variant == "pairwise"
                                and mode == "every_round") else ("gather",)
    for seg, dlv in itertools.product(SEGMENTS, delivs):
        pc = _cfgs(variant, mode, segment_impl=seg, delivery=dlv,
                   drop_rate=drop)[1]
        ps, _ = _port_run(pt, pc, 60)
        for name in ("flow", "est", "last_avg"):
            torch.testing.assert_close(getattr(ps, name),
                                       getattr(base, name), **TOL)
        assert torch.equal(ps.fired, base.fired), (seg, dlv)
        assert torch.equal(ps.buf_valid, base.buf_valid), (seg, dlv)


@pytest.mark.parametrize("seg,dlv", [("segment", "gather"),
                                     ("benes_fused", "benes_fused")])
def test_faithful_bootstrap_via_timeout(seg, dlv):
    """Nothing is heard before anyone sends: the first averages come from
    the 50-tick timeout, every node at round 50 (tests/test_collectall.py
    ::test_faithful_bootstrap_via_timeout)."""
    topo = pgen.ring(8, k=1)
    cfg = RoundConfig.reference("collectall", timeout=50, segment_impl=seg,
                                delivery=dlv)
    eng = Engine(config=cfg, device="cpu").set_topology(topo).build()
    eng.run_rounds(49)
    assert int(eng.state.fired.sum()) == 0
    eng.run_rounds(1)
    assert int(eng.state.fired.sum()) == topo.num_nodes


def test_state_carries_across_from_jax(graphs):
    """A JAX state read field by field continues here: same trajectory,
    same loss draws (the key's words cross too)."""
    jt, pt = graphs
    jc, pc = _cfgs("collectall", "reference", drop_rate=0.2)
    js, ja = _jax_run(jt, jc, 30)
    fields = {f: np.asarray(getattr(js, f))
              for f in FlowUpdatingState.__dataclass_fields__}
    ps = state_from_numpy(fields, device="cpu")
    assert ps.key.dtype == torch.int64 and ps.t.dtype == torch.int32
    pa = pt.device_arrays(device="cpu")
    ps = rounds.run_rounds(ps, pa, pc, 40)
    js = jax_run(js, ja, jc, 40)
    np.testing.assert_allclose(rounds.node_estimates(ps, pa).numpy(),
                               np.asarray(jax_estimates(js, ja)), **TOL)
    assert np.array_equal(ps.key.numpy(), np.asarray(js.key))
    back = ps.numpy()
    assert back["key"].dtype == np.uint32 and back["flow"].shape == (
        pt.num_edges,)


def test_state_defaults_to_the_card(graphs):
    """``init_state``, ``state_from_numpy`` and the PRNG key build on the
    card unless the CPU is asked for: without one they raise."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    from flow_updating_tpu_torch.utils import prng

    _, pt = graphs
    cfg = RoundConfig.reference("collectall")
    fields = init_state(pt, cfg, device="cpu").numpy()
    for build in (lambda: init_state(pt, cfg),
                  lambda: state_from_numpy(fields),
                  lambda: prng.prng_key(0)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
    assert state_from_numpy(fields, device="cpu").key.device.type == "cpu"


@pytest.mark.parametrize("rounds_", [1, 7, 60])
def test_node_kernel_matches_edge_kernel(rounds_):
    """tests/test_sync.py::test_matches_edge_kernel, inside the port."""
    topo = pgen.erdos_renyi(200, avg_degree=6.0, seed=1)
    cfg = RoundConfig.fast(variant="collectall", dtype="float64")
    es, ea = _port_run(topo, cfg, rounds_)
    k = NodeKernel(topo, RoundConfig.fast(kernel="node", dtype="float64"),
                   device="cpu")
    ns = k.run(k.init_state(), rounds_)
    np.testing.assert_allclose(k.estimates(ns),
                               rounds.node_estimates(es, ea).numpy(), **TOL)
    np.testing.assert_allclose(k.last_avg(ns), es.last_avg.numpy(), **TOL)


@pytest.mark.parametrize("variant,mode", [("collectall", "reference"),
                                          ("pairwise", "every_round")])
def test_vector_columns_match_scalar_runs(graphs, variant, mode):
    """A (N, D) run is D scalar runs sharing one set of messages; the
    columns are held to tolerance (the JAX package's own bit-exact form
    of this check does not hold under its current XLA:CPU)."""
    _, pt = graphs
    cfg = _cfgs(variant, mode, drop_rate=0.1)[1]
    values = np.random.default_rng(4).normal(size=(pt.num_nodes, 3))
    vs, va = _port_run(pt, cfg, 70, values)
    vest = rounds.node_estimates(vs, va).numpy()
    for d in range(3):
        ss, sa = _port_run(pt, cfg, 70, values[:, d])
        np.testing.assert_allclose(vest[:, d],
                                   rounds.node_estimates(ss, sa).numpy(),
                                   rtol=1e-12, atol=1e-12)
        assert torch.equal(vs.fired, ss.fired)


def test_unported_items_raise_naming_them(graphs):
    """What the edge kernel does not run yet raises naming its item.  The
    A3 configs that used to raise here now run: robust clip and trim
    match JAX's round at 1e-9, and contention on a generator graph (no
    link model) raises JAX's ValueError; ``run_rounds_observed`` (ported)
    samples the loop's own states."""
    jt, pt = graphs
    arrays = pt.device_arrays(device="cpu")
    cfg = RoundConfig.reference("collectall")
    state = init_state(pt, cfg, device="cpu")
    for variant, knob in (("collectall", dict(robust="clip",
                                              robust_clip=0.05)),
                          ("pairwise", dict(robust="trim",
                                            robust_tol=0.05))):
        jc, pc = _cfgs(variant, "reference", **knob)
        js, ja = _jax_run(jt, jc, ROUNDS)
        ps, pa = _port_run(pt, pc, ROUNDS)
        np.testing.assert_allclose(rounds.node_estimates(ps, pa).numpy(),
                                   np.asarray(jax_estimates(js, ja)), **TOL)
        eng = Engine(config=pc, device="cpu").set_topology(pt).build()
        eng.run_rounds(ROUNDS)
        np.testing.assert_allclose(eng.estimates(),
                                   np.asarray(jax_estimates(js, ja)), **TOL)
    bad = RoundConfig.reference("collectall", contention=True)
    with pytest.raises(ValueError, match="link model"):
        rounds.run_rounds(init_state(pt, bad, device="cpu"), arrays, bad, 1)
    with pytest.raises(ValueError, match="link model"):
        Engine(config=bad, device="cpu").set_topology(pt).build()
    looped = rounds.run_rounds(state, arrays, cfg, 20)
    observed, m = rounds.run_rounds_observed(state, arrays, cfg, 20, 10,
                                             pt.true_mean)
    assert torch.equal(observed.flow, looped.flow)
    assert m["t"].tolist() == [10, 20]
    assert m["fired_total"][-1] == looped.fired.sum()
    with pytest.raises(NotImplementedError, match="A10"):
        rounds.run_rounds(state, arrays, cfg, 1, params=object())
    with pytest.raises(NotImplementedError, match="A10"):
        Engine(config=cfg, adversary=object(), device="cpu")
    for runner, item in ((rounds.run_rounds_chunked, "A13"),
                         (rounds.init_chunked_state, "A13")):
        with pytest.raises(NotImplementedError, match=item):
            runner(state, arrays, cfg, 1)
    # the field runner is ported (A9 part 2): a disabled spec or a round
    # count off the stride is refused, as in the JAX package
    from flow_updating_tpu_torch.obs.fields import FieldSpec

    with pytest.raises(ValueError, match="field spec is disabled"):
        rounds.run_rounds_fields(state, arrays, cfg, 1, FieldSpec.off(),
                                 pt.true_mean)
    with pytest.raises(ValueError, match="multiple of the field stride"):
        rounds.run_rounds_fields(state, arrays, cfg, 5,
                                 FieldSpec.default(stride=2), pt.true_mean)
    # the streamed observer runs on the edge kernel (A9 part 1)
    eng = Engine(config=cfg, device="cpu").set_topology(pt).build()
    seen = []
    eng.run_streamed(10, observe_every=10, emit=seen.append)
    assert [m["t"] for m in seen] == [10]


def test_engine_edge_kernel_surface(graphs):
    """Engine() defaults to the edge kernel: report keys, global values,
    the latency-warped delay depth and the until-rmse runner."""
    _, pt = graphs
    eng = Engine(device="cpu").set_topology(pt).build()
    assert eng.config.kernel == "edge"
    out = eng.run_until_rmse(1e-6, chunk=32)
    assert out["converged"]
    rep = eng.convergence_report()
    assert rep.keys() == {"t", "rmse", "max_abs_err", "mass_residual",
                          "antisymmetry_residual"}
    assert rep["antisymmetry_residual"] < 1e-6
    gv = eng.global_values()
    assert len(gv["value"]) == pt.num_nodes
    delayed = pgen.ring(12, 1, seed=0)
    import dataclasses

    delayed = dataclasses.replace(delayed, delay=np.full(24, 3, np.int32))
    eng = Engine(config=RoundConfig.reference("collectall"), device="cpu")
    eng.set_topology(delayed).build(latency_scale=1.0)
    assert eng.config.delay_depth == 3
    eng.run_rounds(120)
    assert eng.convergence_report()["rmse"] < delayed.values.std()


def _count_launches(monkeypatch, topo, cfg, n_rounds):
    """Count B3 passes and B4 passes of ``n_rounds`` rounds on the CPU, by
    wrapping the fused executors the round looks up at call time."""
    from flow_updating_tpu_torch.ops import fused_passes as fp
    from flow_updating_tpu_torch.ops import seg_benes

    counts = {"local": 0, "window": 0, "wide": 0, "wide2": 0, "scan": 0,
              "fill": 0}
    for kind, fn in list(fp.PASS_FNS.items()):
        fam = kind.replace("_swap", "").replace("_roll", "")

        def counted(*a, _fn=fn, _fam=fam):
            counts[_fam] += 1
            return _fn(*a)

        monkeypatch.setitem(fp.PASS_FNS, kind, counted)
    for name, fam in (("segscan_pass", "scan"), ("fill_pass", "fill")):
        orig = getattr(seg_benes, name)

        def counted(x, dist, dists, *rest, _orig=orig, _fam=fam):
            counts[_fam] += len(fp.plan_dist_passes(dists, rest[-1]))
            return _orig(x, dist, dists, *rest)

        monkeypatch.setattr(seg_benes, name, counted)
    eng = Engine(config=cfg, device="cpu").set_topology(topo).build()
    eng.run_rounds(n_rounds)
    return counts, eng


@pytest.mark.parametrize("variant,maker,robust", [
    ("collectall", "reference", {}), ("pairwise", "fast", {}),
    ("collectall", "reference", dict(robust="trim", robust_tol=0.05)),
    ("pairwise", "fast", dict(robust="trim", robust_tol=0.05)),
    ("pairwise", "fast", dict(robust="clip", robust_clip=0.01))])
def test_chip_smoke_launch_derivation(monkeypatch, variant, maker, robust):
    """chip_smoke.py holds path D's and path G's B3/B4 launches to a count
    derived from the plans and the round's calls; the derivation must
    match what a round actually calls."""
    import chip_smoke

    topo = pgen.barabasi_albert(300, m=3, seed=2)
    cfg = getattr(RoundConfig, maker)(variant, segment_impl="benes_fused",
                                      delivery=("benes_fused"
                                                if maker == "reference"
                                                else "gather"), **robust)
    counts, eng = _count_launches(monkeypatch, topo, cfg, 3)
    planned = chip_smoke.planned_launches(eng._topo_arrays, cfg)
    assert counts == {k: 3 * v for k, v in planned.items()}
    assert counts["scan"] > 0 and counts["fill"] > 0
