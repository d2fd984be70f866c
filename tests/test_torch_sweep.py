"""The sweep engine (``flow_updating_tpu_torch.sweep``) and the traced
``RoundParams`` against the JAX package's, and its lanes against
themselves.

Counterparts of ``tests/test_sweep.py`` at small sizes, the same inputs
from numpy seeds through both packages (float64, the conftest turns x64
on):

* **lanes bit for bit** — every lane of a port bucket equals the same
  instance packed alone (B = 1) and the unpadded instance run through
  ``run_rounds(params=)``, ``torch.equal`` on every leaf (real prefix), in
  all four variant and fire-policy cases, ``collectall-every_round``
  included (where JAX's own vmapped lanes miss its single run by a
  rounding); the port matches JAX's single run to 1e-9 with integer and
  bool leaves and the key equal;
* **traced params against JAX** — ``run_rounds(params=)`` over a drop x
  timeout grid with drop > 0 (the float32 loss words whatever the ledger
  dtype), ``latency_scale`` and ``contention_scale`` on small6 with a link
  model;
* **buckets against JAX** — a JAX bucket's stacked state continued in the
  port (``bucket_from_numpy``), ``run_bucket_telemetry``'s per-lane
  ``converged_round`` equal to JAX's, ``run_sweep``'s records and
  ``compiled_programs`` equal, the batched threefry equal to ``jax.vmap``'s;
* **padding** — ghosts stay dead and valueless through churn and loss;
  a bucket round issues the same operations whatever B is;
* the ``sweep`` subcommand's manifest under both packages' ``doctor``.

``test_sweep.py``'s bench-baseline test has no counterpart: the port has
no benchmark yet (ROADMAP A16).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from flow_updating_tpu import sweep as jsweep
from flow_updating_tpu.models.config import RoundConfig as JaxConfig
from flow_updating_tpu.models.config import RoundParams as JaxParams
from flow_updating_tpu.models.rounds import run_rounds as jax_run
from flow_updating_tpu.models.state import init_state as jax_init
from flow_updating_tpu.obs import health as jhealth
from flow_updating_tpu.obs.telemetry import TelemetrySpec as JaxSpec
from flow_updating_tpu.sweep.batch import _run_bucket as jax_run_bucket
from flow_updating_tpu.topology import generators as jgen
from flow_updating_tpu.topology.deployment import load_deployment as jdep
from flow_updating_tpu.topology.platform import load_platform as jplat
from flow_updating_tpu_torch import RoundConfig
from flow_updating_tpu_torch.cli import main as port_main
from flow_updating_tpu_torch.models import rounds
from flow_updating_tpu_torch.models.config import RoundParams
from flow_updating_tpu_torch.models.state import (
    FlowUpdatingState,
    bucket_from_numpy,
    init_state,
    lane_state,
    stack_lanes,
)
from flow_updating_tpu_torch.obs import health
from flow_updating_tpu_torch.obs.telemetry import TelemetrySpec
from flow_updating_tpu_torch.ops import segment as pseg
from flow_updating_tpu_torch.sweep import (
    SweepInstance,
    grid_instances,
    pack_instances,
    pad_topology_to,
    run_bucket,
    run_bucket_telemetry,
    run_sweep,
)
from flow_updating_tpu_torch.sweep.pack import row_width
from flow_updating_tpu_torch.sweep.runner import _structure_key
from flow_updating_tpu_torch.topology import generators as pgen
from flow_updating_tpu_torch.topology.deployment import load_deployment
from flow_updating_tpu_torch.topology.padding import edge_rows
from flow_updating_tpu_torch.topology.platform import load_platform
from flow_updating_tpu_torch.utils import prng

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PLATFORM = os.path.join(ROOT, "examples/platforms/small6.xml")
ACTORS = os.path.join(ROOT, "examples/deployments/small6_actors.xml")
TOL = dict(rtol=1e-9, atol=1e-9)
NODE = ("value", "ticks", "last_avg", "fired", "alive")
EDGE = ("flow", "est", "recv", "stamp", "edge_ok")
QUEUE = ("pending_flow", "pending_est", "pending_valid", "pending_stamp",
         "buf_flow", "buf_est", "buf_valid")
MODES = [("collectall", "reference"), ("collectall", "every_round"),
         ("pairwise", "reference"), ("pairwise", "every_round")]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def _small6(**kw):
    kw = dict(tick_interval=1.0, **kw)
    return (jdep(ACTORS).to_topology(platform=jplat(PLATFORM), **kw),
            load_deployment(ACTORS).to_topology(
                platform=load_platform(PLATFORM), **kw))


def _cfgs(variant, policy, **kw):
    make = "reference" if policy == "reference" else "fast"
    return (getattr(JaxConfig, make)(variant, dtype="float64", **kw),
            getattr(RoundConfig, make)(variant, dtype="float64", **kw))


def _prefix(state, N, E) -> dict:
    """Every leaf of a state on its first N nodes and E edges, as numpy
    (the key as its uint32 words)."""
    get = ((lambda f: np.asarray(getattr(state, f)))
           if not isinstance(state, FlowUpdatingState)
           else (lambda f: getattr(state, f).numpy()))
    out = {f: get(f)[:N] for f in NODE}
    out.update({f: get(f)[:E] for f in EDGE})
    out.update({f: get(f)[:, :E] for f in QUEUE})
    out["t"] = get("t")
    out["key"] = get("key").astype(np.uint32)
    return out


def _assert_close(got: dict, want: dict):
    """Float leaves to 1e-9, integer, bool and key leaves equal."""
    for f, w in want.items():
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(got[f], w, err_msg=f, **TOL)
        else:
            np.testing.assert_array_equal(got[f], w, err_msg=f)


def _assert_equal_states(a: FlowUpdatingState, b: FlowUpdatingState, N, E):
    """``torch.equal`` on every leaf's real prefix."""
    pa, pb = _prefix(a, N, E), _prefix(b, N, E)
    for f in pa:
        assert torch.equal(torch.from_numpy(np.ascontiguousarray(pa[f])),
                           torch.from_numpy(np.ascontiguousarray(pb[f]))), f


def _jax_params(inst, jcfg):
    return JaxParams.from_config(
        jcfg, drop_rate=inst.drop_rate, timeout=inst.timeout,
        latency_scale=inst.latency_scale,
        contention_scale=inst.contention_scale)


def _jax_single(jtopo, jcfg, inst, rounds_):
    arrays = jtopo.device_arrays(coloring=jcfg.needs_coloring)
    return jax_run(jax_init(jtopo, jcfg, seed=inst.seed), arrays, jcfg,
                   rounds_, params=_jax_params(inst, jcfg))


def _port_single(topo, cfg, inst, rounds_):
    arrays = topo.device_arrays(coloring=cfg.needs_coloring, device="cpu")
    return rounds.run_rounds(
        init_state(topo, cfg, seed=inst.seed, values=inst.values,
                   device="cpu"),
        arrays, cfg, rounds_, params=inst.params(cfg, device="cpu"))


def _alone(inst, cfg, rounds_):
    bucket = pack_instances([inst], cfg, device="cpu")[0]
    return lane_state(run_bucket(bucket, cfg, rounds_), 0, 1)


def _check_lanes(bucket, states, insts, cfg, rounds_, jpairs=None,
                 jcfg=None):
    """Each lane against its B = 1 packing and its unpadded run (bit for
    bit) and, with ``jpairs``, the JAX single run (1e-9)."""
    for lane, inst in enumerate(insts):
        got = lane_state(states, lane, bucket.size)
        N, E = inst.topo.num_nodes, inst.topo.num_edges
        _assert_equal_states(got, _alone(inst, cfg, rounds_), N, E)
        _assert_equal_states(got, _port_single(inst.topo, cfg, inst,
                                               rounds_), N, E)
        if jpairs is not None:
            js = _jax_single(jpairs[lane], jcfg, inst, rounds_)
            _assert_close(_prefix(got, N, E), _prefix(js, N, E))


# ---- lanes bit for bit, and against JAX (every mode) ----------------------

@pytest.mark.parametrize("variant,policy", MODES)
def test_batch_of_small6_matches_single_instance(variant, policy):
    jt, pt = _small6()
    jcfg, cfg = _cfgs(variant, policy)
    R = 40
    insts = [SweepInstance(topo=pt, seed=s, drop_rate=0.1 + 0.1 * s,
                           timeout=12 + 4 * s, tag={"lane": s})
             for s in range(3)]
    buckets = pack_instances(insts, cfg, device="cpu")
    assert len(buckets) == 1 and buckets[0].size == 3
    states = run_bucket(buckets[0], cfg, R)
    _check_lanes(buckets[0], states, insts, cfg, R, [jt] * 3, jcfg)


def test_mixed_topologies_share_bucket_and_stay_exact():
    """Different graphs (and color counts) in one bucket: each lane equals
    its unpadded run bit for bit and JAX's to 1e-9."""
    jcfg, cfg = _cfgs("pairwise", "every_round")
    pairs = [(jgen.ring(12, k=2, seed=0), pgen.ring(12, k=2, seed=0)),
             (jgen.grid2d(4, 4, seed=1), pgen.grid2d(4, 4, seed=1))]
    insts = [SweepInstance(topo=p, seed=i, drop_rate=0.1)
             for i, (_, p) in enumerate(pairs)]
    buckets = pack_instances(insts, cfg, n_min=32, e_min=64, device="cpu")
    assert len(buckets) == 1, "instances under the floors must coalesce"
    assert pairs[0][1].edge_coloring()[1] != pairs[1][1].edge_coloring()[1]
    states = run_bucket(buckets[0], cfg, 30)
    for lane, inst in enumerate(insts):
        got = lane_state(states, lane, 2)
        N, E = inst.topo.num_nodes, inst.topo.num_edges
        _assert_equal_states(got, _port_single(inst.topo, cfg, inst, 30),
                             N, E)
        js = _jax_single(pairs[lane][0], jcfg, inst, 30)
        _assert_close(_prefix(got, N, E), _prefix(js, N, E))


def test_vector_payload_lanes_match_jax():
    """(N, D) payloads ride the lanes: each equals its unpadded run and
    JAX's."""
    jt, pt = jgen.ring(16, k=2, seed=3), pgen.ring(16, k=2, seed=3)
    jcfg, cfg = _cfgs("collectall", "reference")
    rng = np.random.default_rng(0)
    vals = [rng.normal(size=(16, 2)) for _ in range(2)]
    insts = [SweepInstance(topo=pt, seed=5 + i, drop_rate=0.3, values=v)
             for i, v in enumerate(vals)]
    bucket = pack_instances(insts, cfg, device="cpu")[0]
    assert bucket.shape[2:] == (2,)
    states = run_bucket(bucket, cfg, 30)
    for lane, inst in enumerate(insts):
        got = lane_state(states, lane, 2)
        _assert_equal_states(got, _port_single(pt, cfg, inst, 30), 16,
                             pt.num_edges)
        arrays = jt.device_arrays()
        js = jax_run(jax_init(jt, jcfg, seed=inst.seed, values=vals[lane]),
                     arrays, jcfg, 30, params=_jax_params(inst, jcfg))
        _assert_close(_prefix(got, 16, pt.num_edges),
                      _prefix(js, 16, pt.num_edges))


# ---- padding invariants under churn + drop --------------------------------

def test_padding_neutral_under_churn_and_drop():
    """Ghosts and pad self-loops carry exactly zero state through a
    churned, lossy run; the lane equals the unpadded run bit for bit (the
    counter-based draw keeps a prefix-stable keep mask) and JAX's to
    1e-9, so the true mean and per-feature mass are untouched."""
    jt, pt = jgen.ring(16, k=2, seed=3), pgen.ring(16, k=2, seed=3)
    jcfg, cfg = _cfgs("collectall", "reference")
    values = np.random.default_rng(0).normal(size=(16, 2))
    inst = SweepInstance(topo=pt, seed=5, drop_rate=0.3, values=values)
    bucket = pack_instances([inst], cfg, device="cpu")[0]
    N, E = pt.num_nodes, pt.num_edges
    arrays = pt.device_arrays(device="cpu")
    single = init_state(pt, cfg, seed=5, values=values, device="cpu")
    params = inst.params(cfg, device="cpu")
    jarrays = jt.device_arrays()
    jsingle = jax_init(jt, jcfg, seed=5, values=values)
    jparams = _jax_params(inst, jcfg)
    batched = bucket.states
    kill = 3
    for phase in ("pre", "killed", "revived"):
        if phase != "pre":
            up = phase == "revived"
            alive = single.alive.clone()
            alive[kill] = up
            single = single.replace(alive=alive)
            balive = batched.alive.clone()
            balive[kill] = up
            batched = batched.replace(alive=balive)
            jsingle = jsingle.replace(alive=jsingle.alive.at[kill].set(up))
        single = rounds.run_rounds(single, arrays, cfg, 12, params=params)
        jsingle = jax_run(jsingle, jarrays, jcfg, 12, params=jparams)
        for _ in range(12):
            batched = rounds.round_step(batched, bucket.arrays, cfg,
                                        bucket.params)
        got = lane_state(batched, 0, 1)
        _assert_equal_states(got, single, N, E)
        _assert_close(_prefix(got, N, E), _prefix(jsingle, N, E))
        assert not got.alive[N:].any()
        assert not got.flow[E:].any() and not got.est[E:].any()
        assert not got.value[N:].any()
        assert not got.buf_valid[:, E:].any()
        lane_est = rounds.node_estimates(got, bucket.arrays)[:N]
        ref_est = rounds.node_estimates(single, arrays)
        assert torch.equal(lane_est[single.alive].sum(0),
                           ref_est[single.alive].sum(0))


# ---- traced RoundParams against JAX ----------------------------------------

@pytest.mark.parametrize("variant,policy", MODES)
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_traced_params_match_jax(variant, policy, dtype):
    """``run_rounds(params=)`` with drop > 0 draws JAX's float32 words
    (whatever the ledger dtype) and reads the traced timeout."""
    jt = jgen.barabasi_albert(40, m=3, seed=2)
    pt = pgen.barabasi_albert(40, m=3, seed=2)
    make = "reference" if policy == "reference" else "fast"
    jcfg = getattr(JaxConfig, make)(variant, dtype=dtype)
    cfg = getattr(RoundConfig, make)(variant, dtype=dtype)
    inst = SweepInstance(topo=pt, seed=7, drop_rate=0.25, timeout=9)
    got = _port_single(pt, cfg, inst, 60)
    js = _jax_single(jt, jcfg, inst, 60)
    want = _prefix(js, pt.num_nodes, pt.num_edges)
    have = _prefix(got, pt.num_nodes, pt.num_edges)
    if dtype == "float64":
        _assert_close(have, want)
    else:
        for f in ("key", "ticks", "fired", "stamp", "recv", "t"):
            np.testing.assert_array_equal(have[f], want[f], err_msg=f)
        np.testing.assert_allclose(have["flow"], want["flow"], rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("drop", [0.0, 0.1, 0.25])
@pytest.mark.parametrize("timeout", [10, 30])
def test_params_grid_matches_jax(drop, timeout):
    """One params path serves a drop x timeout grid (JAX: one compile)."""
    jt, pt = jgen.ring(10, k=2, seed=0), pgen.ring(10, k=2, seed=0)
    jcfg, cfg = _cfgs("collectall", "reference")
    inst = SweepInstance(topo=pt, seed=0, drop_rate=drop, timeout=timeout)
    got = _port_single(pt, cfg, inst, 70)
    js = _jax_single(jt, jcfg, inst, 70)
    _assert_close(_prefix(got, 10, pt.num_edges),
                  _prefix(js, 10, pt.num_edges))


def test_traced_drop_zero_draws_but_keeps_the_ledgers():
    """At drop 0 the traced path still advances the key (it always draws)
    while the static path draws nothing; the ledgers are equal."""
    pt = pgen.ring(10, k=2, seed=0)
    cfg = RoundConfig.reference("collectall", dtype="float64")
    arrays = pt.device_arrays(device="cpu")
    state = init_state(pt, cfg, seed=0, device="cpu")
    static = rounds.run_rounds(state, arrays, cfg, 20)
    traced = rounds.run_rounds(state, arrays, cfg, 20,
                               params=RoundParams.from_config(
                                   cfg, device="cpu"))
    nodraw = rounds.run_rounds(
        state, arrays, cfg, 20,
        params=RoundParams.from_config(cfg, device="cpu").without_drop())
    assert torch.equal(static.key, state.key)
    assert not torch.equal(traced.key, state.key)
    assert torch.equal(nodraw.key, state.key)
    for f in ("flow", "est", "ticks", "fired", "buf_flow"):
        assert torch.equal(getattr(static, f), getattr(traced, f)), f
        assert torch.equal(getattr(static, f), getattr(nodraw, f)), f
    # the traced delivery is refused where the network bakes static delays
    bad = dataclasses.replace(cfg, delivery="benes")
    with pytest.raises(ValueError, match="bakes static delays"):
        rounds.run_rounds(state, pt.device_arrays(delivery_benes=True,
                                                  device="cpu"),
                          bad, 1, params=RoundParams.from_config(
                              cfg, device="cpu"))


@pytest.mark.parametrize("contention", [False, True])
@pytest.mark.parametrize("scales", [(1.0, 1.0), (2.0, 1.0), (0.5, 3.0)])
def test_latency_and_contention_scale_match_jax(contention, scales):
    """``latency_scale`` stretches small6's latency-warped delays (and,
    under contention, its route latencies; ``contention_scale`` the
    links' serialization) exactly as JAX's."""
    jt, pt = _small6(latency_scale=100.0, msg_bytes=1e6)
    assert pt.has_link_model and pt.max_delay > 1
    kw = dict(delay_depth=64, contention=contention)
    jcfg, cfg = _cfgs("collectall", "reference", **kw)
    ls, cs = scales
    inst = SweepInstance(topo=pt, seed=1, latency_scale=ls,
                         contention_scale=cs)
    got = _port_single(pt, cfg, inst, 80)
    js = _jax_single(jt, jcfg, inst, 80)
    _assert_close(_prefix(got, pt.num_nodes, pt.num_edges),
                  _prefix(js, pt.num_nodes, pt.num_edges))
    send = torch.ones(pt.num_edges, dtype=torch.bool)
    arrays = pt.device_arrays(device="cpu")
    d = rounds.edge_delays(arrays, cfg, send, params=inst.params(
        cfg, device="cpu"))
    from flow_updating_tpu.models import rounds as jrounds

    jd = jrounds.edge_delays(jt.device_arrays(), jcfg,
                             jnp.ones(pt.num_edges, bool),
                             params=_jax_params(inst, jcfg))
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))


def test_latency_scale_lanes_match_single_runs():
    """Lanes with different latency scales in one bucket (no contention:
    a sweep refuses it) equal their unpadded runs and JAX's."""
    jt, pt = _small6(latency_scale=100.0, msg_bytes=1e6)
    jcfg, cfg = _cfgs("pairwise", "reference", delay_depth=24)
    insts = [SweepInstance(topo=pt, seed=s, latency_scale=ls, drop_rate=0.1)
             for s, ls in enumerate((0.5, 1.0, 2.0))]
    bucket = pack_instances(insts, cfg, device="cpu")[0]
    states = run_bucket(bucket, cfg, 60)
    _check_lanes(bucket, states, insts, cfg, 60, [jt] * 3, jcfg)


# ---- buckets against JAX ---------------------------------------------------

def test_jax_bucket_continues_in_the_port():
    """A JAX bucket's stacked state, carried across lane by lane
    (``bucket_from_numpy``), runs on in the port as JAX's does."""
    jcfg, cfg = _cfgs("collectall", "reference")
    jt, pt = jgen.ring(24, k=2, seed=1), pgen.ring(24, k=2, seed=1)
    jinsts = [jsweep.SweepInstance(topo=jt, seed=s, drop_rate=0.2,
                                   timeout=8 + s) for s in range(3)]
    pinsts = [SweepInstance(topo=pt, seed=s, drop_rate=0.2, timeout=8 + s)
              for s in range(3)]
    jb = jsweep.pack_instances(jinsts, jcfg)[0]
    pb = pack_instances(pinsts, cfg, device="cpu")[0]
    assert jb.shape == pb.shape
    mid = jax_run_bucket(jb.states, jb.arrays, jb.params, jcfg, 25)
    end = jax_run_bucket(mid, jb.arrays, jb.params, jcfg, 25)
    carried = bucket_from_numpy({f.name: np.asarray(getattr(mid, f.name))
                                 for f in dataclasses.fields(
                                     FlowUpdatingState)}, device="cpu")
    for _ in range(25):
        carried = rounds.round_step(carried, pb.arrays, cfg, pb.params)
    n_pad, e_pad = pb.shape[:2]
    for lane in range(3):
        jl = jax.tree.map(lambda x: np.asarray(x)[lane], end)
        _assert_close(_prefix(lane_state(carried, lane, 3), n_pad, e_pad),
                      _prefix(jl, n_pad, e_pad))
    # the port's own bucket from the start reaches the same state
    own = run_bucket(pb, cfg, 50)
    for lane in range(3):
        _assert_equal_states(lane_state(own, lane, 3),
                             lane_state(carried, lane, 3), n_pad, e_pad)


def test_effective_early_exit_round():
    """Converged lanes keep running but record the round their RMSE first
    reached the threshold: per lane, equal to JAX's."""
    jcfg, cfg = _cfgs("collectall", "every_round")
    jpairs = [(jgen.ring(8, k=2, seed=0), pgen.ring(8, k=2, seed=0)),
              (jgen.ring(8, k=1, seed=1), pgen.ring(8, k=1, seed=1))]
    insts = [SweepInstance(topo=p, seed=i) for i, (_, p) in
             enumerate(jpairs)]
    bucket = pack_instances(insts, cfg, n_min=16, e_min=64, device="cpu")[0]
    assert bucket.size == 2
    R = 300
    states, conv, series = run_bucket_telemetry(
        bucket, cfg, R, TelemetrySpec.default(), rmse_threshold=1e-9)
    assert (conv >= 0).all(), "fast sync collect-all converges well"
    assert conv[0] != conv[1]
    for lane in range(2):
        t = series["t"][lane]
        i = int(np.searchsorted(t, conv[lane]))
        assert series["rmse"][lane][i] <= 1e-9
        if i:
            assert series["rmse"][lane][i - 1] > 1e-9
    assert int(states.t) == R
    jinsts = [jsweep.SweepInstance(topo=j, seed=i) for i, (j, _) in
              enumerate(jpairs)]
    jb = jsweep.pack_instances(jinsts, jcfg, n_min=16, e_min=64)[0]
    _, jconv, jseries = jsweep.run_bucket_telemetry(
        jb, jcfg, R, JaxSpec.default(), rmse_threshold=1e-9)
    np.testing.assert_array_equal(conv, jconv)
    assert set(series) == set(jseries)
    for k, v in jseries.items():
        if np.issubdtype(v.dtype, np.floating):
            np.testing.assert_allclose(series[k], v, err_msg=k, **TOL)
        else:
            np.testing.assert_array_equal(series[k], v, err_msg=k)


def test_run_sweep_records_match_jax():
    """``run_sweep``'s records (params as the round reads them,
    convergence, worst nodes) and summary counts equal JAX's."""
    jcfg, cfg = _cfgs("collectall", "reference")
    topos = [("ring:12:2", jgen.ring(12, k=2, seed=0),
              pgen.ring(12, k=2, seed=0)),
             ("grid2d:4:4", jgen.grid2d(4, 4, seed=0),
              pgen.grid2d(4, 4, seed=0))]
    kw = dict(seeds=(0, 1), drop_rates=(0.0, 0.1), timeouts=(6,))
    pin = grid_instances([(n, p) for n, _, p in topos], **kw)
    jin = jsweep.grid_instances([(n, j) for n, j, _ in topos], **kw)
    got, gsum = run_sweep(pin, cfg, 120, rmse_threshold=1e-3,
                          include_series=True, device="cpu")
    want, wsum = jsweep.run_sweep(jin, jcfg, 120, rmse_threshold=1e-3,
                                  include_series=True)
    assert gsum["compiled_programs"] == wsum["compiled_programs"]
    assert [b["shape"] for b in gsum["buckets"]] == \
        [b["shape"] for b in wsum["buckets"]]
    assert gsum["converged"] == wsum["converged"]
    for g, w in zip(got, want):
        for k in ("instance", "seed", "topology", "params", "padded_shape",
                  "tag"):
            assert g[k] == w[k], k
        gc, wc = g["convergence"], w["convergence"]
        assert gc["converged_round"] == wc["converged_round"]
        np.testing.assert_allclose(gc["final_rmse"], wc["final_rmse"],
                                   **TOL)
        assert [n["node"] for n in g["worst_nodes"]] == \
            [n["node"] for n in w["worst_nodes"]]
        np.testing.assert_allclose(g["series"]["rmse"],
                                   w["series"]["rmse"], **TOL)


def test_batched_draw_equals_jax_vmap():
    """A ``(B, 2)`` stack of keys splits and draws lane by lane as
    ``jax.vmap`` does: the bucket's loss words are the lanes' own."""
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(5))
    jsplit = jax.vmap(jax.random.split)(keys)
    p = jnp.asarray([0.0, 0.1, 0.5, 0.9, 1.0], jnp.float32)
    jkeep = jax.vmap(lambda k, q: jax.random.bernoulli(k, 1.0 - q, (37,)))(
        jsplit[:, 1], p)
    pkeys = torch.from_numpy(np.asarray(keys).astype(np.int64))
    psplit = prng.split(pkeys)
    np.testing.assert_array_equal(psplit.numpy().astype(np.uint32),
                                  np.asarray(jsplit))
    keep = prng.bernoulli(psplit[:, 1], 1.0 - torch.from_numpy(
        np.array(p)), 37, torch.float32)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    # one lane alone draws the same words
    one = prng.bernoulli(psplit[2, 1], 1.0 - torch.tensor(0.5), 37)
    assert torch.equal(one, keep[2])


# ---- structure and launches -------------------------------------------------

class _Ops(TorchDispatchMode):
    """Counts the aten operations a call dispatches."""

    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.count += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("variant,policy", MODES)
def test_bucket_round_issues_the_same_ops_whatever_b(variant, policy):
    """A bucket round's operations do not grow with its lanes (no Python
    loop over lanes inside a round)."""
    _, cfg = _cfgs(variant, policy)
    topo = pgen.ring(12, k=2, seed=0)
    counts = []
    for B in (1, 2, 5):
        insts = [SweepInstance(topo=topo, seed=s, drop_rate=0.1)
                 for s in range(B)]
        b = pack_instances(insts, cfg, device="cpu")[0]
        state = rounds.round_step(b.states, b.arrays, cfg, b.params)
        with _Ops() as ops:
            rounds.round_step(state, b.arrays, cfg, b.params)
        counts.append(ops.count)
    assert counts[0] == counts[1] == counts[2], counts


def test_same_shape_buckets_share_one_structure():
    cfg = RoundConfig.fast(variant="collectall")
    b1 = pack_instances(
        [SweepInstance(topo=pgen.ring(12, k=2, seed=0), seed=0),
         SweepInstance(topo=pgen.ring(12, k=2, seed=0), seed=1)], cfg,
        device="cpu")[0]
    b2 = pack_instances(
        [SweepInstance(topo=pgen.ring(13, k=2, seed=4), seed=2,
                       timeout=10),
         SweepInstance(topo=pgen.ring(12, k=2, seed=7), seed=3,
                       latency_scale=1.0)], cfg, device="cpu")[0]
    assert b1.shape == b2.shape
    assert _structure_key(b1) == _structure_key(b2)
    b3 = pack_instances(
        [SweepInstance(topo=pgen.ring(12, k=2, seed=0), seed=0,
                       drop_rate=0.1)], cfg, device="cpu")[0]
    assert _structure_key(b3) != _structure_key(b1)


def test_stack_and_lane_state_round_trip():
    cfg = RoundConfig.reference("pairwise")
    topo = pgen.ring(8, k=1, seed=0)
    states = [init_state(topo, cfg, seed=s, device="cpu") for s in range(3)]
    b = stack_lanes(states)
    assert b.key.shape == (3, 2) and b.flow.shape == (3 * topo.num_edges,)
    assert b.pending_flow.shape == (cfg.pending_depth, 3 * topo.num_edges)
    for i, s in enumerate(states):
        _assert_equal_states(lane_state(b, i, 3), s, topo.num_nodes,
                             topo.num_edges)
    with pytest.raises(ValueError, match="round counter"):
        stack_lanes([states[0], states[1].replace(t=states[1].t + 1)])


def test_round_params_describe_and_stack():
    jcfg, cfg = _cfgs("collectall", "reference")
    p = RoundParams.from_config(cfg, drop_rate=0.1, timeout=20,
                                latency_scale=1.5, device="cpu")
    jp = JaxParams.from_config(jcfg, drop_rate=0.1, timeout=20,
                               latency_scale=1.5)
    assert p.describe() == jp.describe()
    assert p.without_drop().describe()["drop_rate"] == 0.0
    s = RoundParams.stack([p, p.replace(timeout=p.timeout + 1)])
    assert s.timeout.tolist() == [20, 21] and s.drop_rate.shape == (2,)
    with pytest.raises(ValueError, match="all draw"):
        RoundParams.stack([p, p.without_drop()])


# ---- validation ---------------------------------------------------------------

def test_pack_rejects_unbatchable_configs():
    insts = [SweepInstance(topo=pgen.ring(8, k=2, seed=0))]
    with pytest.raises(ValueError, match="kernel='edge'"):
        pack_instances(insts, RoundConfig.fast(
            variant="collectall", kernel="node"), device="cpu")
    with pytest.raises(ValueError, match="delivery"):
        pack_instances(insts, RoundConfig.fast(
            variant="collectall", delivery="benes"), device="cpu")
    with pytest.raises(ValueError, match="segment_impl"):
        pack_instances(insts, RoundConfig.fast(
            variant="collectall", segment_impl="ell"), device="cpu")
    with pytest.raises(ValueError, match="contention"):
        pack_instances(insts, RoundConfig.reference(contention=True),
                       device="cpu")
    with pytest.raises(ValueError, match="n_pad"):
        pad_topology_to(pgen.ring(8, k=2, seed=0), 8, 40)
    with pytest.raises(ValueError, match="max_batch"):
        pack_instances(insts, RoundConfig.fast(variant="collectall"),
                       max_batch=-1, device="cpu")
    # per-bucket cost attribution (ported in A14 part 1): counted, never
    # re-run for time
    _, summary = run_sweep(insts, RoundConfig.fast(), 5, profile=True,
                           device="cpu")
    prof = summary["buckets"][0]["profile"]
    assert prof["cost"]["bytes_accessed"] > 0 and prof["cost"]["flops"] > 0
    assert prof["cost"]["method"] == "counted"
    assert prof["timings"]["execute_s"] is None


def test_max_batch_splits_buckets_in_input_order():
    cfg = RoundConfig.fast()
    insts = [SweepInstance(topo=pgen.ring(12, k=2, seed=0), seed=s)
             for s in range(5)]
    buckets = pack_instances(insts, cfg, max_batch=2, device="cpu")
    assert [b.size for b in buckets] == [2, 2, 1]
    assert [m["instance"] for b in buckets for m in b.meta] == list(range(5))


def test_rows_reductions_match_segment_ops():
    """The row-fold reductions equal the CSR segment reductions (scalar
    and vector payloads) and JAX's row folds."""
    from flow_updating_tpu.ops import segment as jseg
    from flow_updating_tpu.sweep.pack import _edge_rows as jrows
    from flow_updating_tpu.sweep.pack import pad_topology_to as jpad

    topo = pgen.grid2d(5, 5, seed=0)
    padded = pad_topology_to(topo, 28, 112)
    rows = torch.from_numpy(edge_rows(padded, row_width(topo, 28, 112),
                                      112)).long()
    jpadded = jpad(jgen.grid2d(5, 5, seed=0), 28, 112)
    np.testing.assert_array_equal(rows.numpy(), jrows(
        jpadded, row_width(topo, 28, 112), 112))
    E = padded.num_edges
    deg = torch.from_numpy(padded.out_deg).int()
    rng = np.random.default_rng(1)
    for shape in ((E,), (E, 3)):
        x = rng.normal(size=shape)
        got = pseg.rows_segment_sum(torch.from_numpy(x), rows)
        assert torch.equal(got, pseg.segment_sum(torch.from_numpy(x), deg))
        np.testing.assert_array_equal(got.numpy(), np.asarray(
            jseg.rows_segment_sum(jnp.asarray(x), jnp.asarray(rows.numpy()))))
    xi = torch.from_numpy(rng.integers(-9, 9, E).astype(np.int32))
    imax = torch.iinfo(torch.int32).max
    has = deg > 0
    assert torch.equal(pseg.rows_segment_min(xi, rows, imax)[has],
                       pseg.segment_min(xi, deg)[has])
    assert torch.equal(pseg.rows_segment_max(xi, rows, -imax - 1)[has],
                       pseg.segment_max(xi, deg)[has])
    pred = torch.from_numpy(rng.integers(0, 2, E).astype(bool))
    assert torch.equal(pseg.rows_segment_all(pred, rows, deg),
                       pseg.segment_all(pred, deg))


# ---- the sweep subcommand ---------------------------------------------------

def _run_cli(capsys, argv):
    rc = port_main(argv)
    out = capsys.readouterr().out.strip().splitlines()[-1]
    return rc, json.loads(out)


def test_sweep_manifest_contract(tmp_path, capsys):
    rep_path = str(tmp_path / "sweep.json")
    rc, out = _run_cli(capsys, [
        "sweep", "--device", "cpu", "--generator", "ring:12:2",
        "--generator", "grid2d:4:4", "--seeds", "2", "--drop-rates",
        "0,0.1", "--timeouts", "20", "--rounds", "30", "--rmse-threshold",
        "1e-3", "--report", rep_path])
    assert rc == 0
    assert out["instances"] == 8
    shapes = {tuple(b["shape"]) for b in out["buckets"]}
    assert out["compiled_programs"] == len(shapes)
    assert out["report_path"] == rep_path
    m = json.load(open(rep_path))
    assert m["schema"] == "flow-updating-sweep-report/v1"
    assert "--drop-rates" in m["argv"]
    assert m["config"]["variant"] == "collectall"
    assert m["environment"]["backend"] == "cpu"
    assert len(m["instances"]) == 8
    drops = set()
    for i, rec in enumerate(m["instances"]):
        assert rec["instance"] == i
        assert len(rec["topology"]["digest"]) == 64
        assert set(rec["params"]) == {"drop_rate", "timeout",
                                      "latency_scale", "contention_scale"}
        assert rec["params"]["timeout"] == 20
        conv = rec["convergence"]
        assert conv["rounds"] == 30
        assert isinstance(conv["converged"], bool)
        assert conv["final_rmse"] >= 0.0
        assert rec["tag"]["topology"] in ("ring:12:2", "grid2d:4:4")
        drops.add(rec["params"]["drop_rate"])
    assert sorted(drops) == pytest.approx([0.0, 0.1])
    # both packages' doctors give the same verdicts on the port manifest
    got = [c.to_jsonable() for c in health.diagnose_manifest(m)]
    want = [c.to_jsonable() for c in jhealth.diagnose_manifest(m)]
    assert got == want
    assert health.overall(health.diagnose_manifest(m)) != "fail"


def test_sweep_cli_validation(capsys):
    with pytest.raises(SystemExit, match="unknown generator"):
        port_main(["sweep", "--generator", "nope:4"])
    with pytest.raises(SystemExit, match="comma list"):
        port_main(["sweep", "--generator", "ring:8:2",
                   "--drop-rates", "a,b"])
    with pytest.raises(SystemExit, match="rmse"):
        port_main(["sweep", "--device", "cpu", "--generator", "ring:8:2",
                   "--rounds", "5", "--telemetry", "mass,fired_total"])
    # --profile attaches one cost record per bucket (A14 part 1)
    assert port_main(["sweep", "--device", "cpu", "--generator", "ring:8:2",
                      "--rounds", "5", "--profile"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["buckets"][0]["profile"]["cost"]["flops"] > 0


def test_sweep_cli_latency_scales_size_the_ring(tmp_path, capsys):
    rc, out = _run_cli(capsys, [
        "sweep", "--device", "cpu", "--generator", "ring:12:2",
        "--latency-scales", "1,3", "--rounds", "20", "--report",
        str(tmp_path / "s.json")])
    assert rc == 0 and out["instances"] == 2
    m = json.load(open(tmp_path / "s.json"))
    assert m["config"]["delay_depth"] == 3
    assert [r["params"]["latency_scale"] for r in m["instances"]] == \
        [1.0, 3.0]
