"""The streaming service (``flow_updating_tpu_torch.service``) against the
JAX package's, and against its own plain rounds.

Counterparts of ``tests/test_service.py`` at its sizes, the same inputs
from numpy seeds through both packages (float64, the conftest turns x64
on):

* **no-op parity** — a service run with zero events equals the port's
  plain ``run_rounds`` on the same padded arrays bit for bit, with the
  same row matrix and without rows (the CSR ``segment_reduce``), at both
  collect-all fire policies (JAX's own test misses this at
  ``every_round`` by a rounding);
* **event conservation, self-healing, scrubbing, unit delays, budget
  errors, staleness, the membership primitive** — as the JAX suite;
* **one dispatch signature** — ``compile_count`` is 1 across 100+
  events (the port counts dispatch signatures; it compiles nothing);
* **checkpoints** — bit-exact round trips, named errors, and archives
  that cross to JAX and back;
* **against JAX** — one seeded event script, scalar and ``(N, 3)``
  payloads, through both engines: after every epoch the slots ``join``
  returns, the free lists, the host mirrors and the integer and bool
  leaves are equal and the float leaves within 1e-9; the service block
  and history equal apart from ``compile_count`` and ``mirror_probe``;
  both doctors give the same verdicts on the port's manifests;
* the ``serve`` subcommand on ``--device cpu``: summary keys equal to
  JAX's, a doctor-clean ``--report``, ``--resume``, named script errors,
  ``--trace-dir`` naming A14.

``test_service.py``'s bench-baseline test has no counterpart: the port
has no benchmark yet (ROADMAP A16).
"""

import json

import numpy as np
import pytest
import torch

from flow_updating_tpu.cli import main as jax_main
from flow_updating_tpu.models.config import RoundConfig as JaxConfig
from flow_updating_tpu.obs import health as jhealth
from flow_updating_tpu.service import ServiceEngine as JaxService
from flow_updating_tpu.topology import generators as jgen
from flow_updating_tpu_torch.cli import main as port_main
from flow_updating_tpu_torch.models.config import RoundConfig
from flow_updating_tpu_torch.models.rounds import node_estimates, run_rounds
from flow_updating_tpu_torch.models.state import init_state
from flow_updating_tpu_torch.obs import health
from flow_updating_tpu_torch.ops.segment import segment_sum
from flow_updating_tpu_torch.service import ServiceEngine, membership
from flow_updating_tpu_torch.service.engine import _service_topo_arrays
from flow_updating_tpu_torch.topology import generators as pgen
from flow_updating_tpu_torch.topology.padding import pad_topology_to
from flow_updating_tpu_torch.utils import checkpoint as ck


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def _cfg(fire_policy="every_round", **kw):
    return RoundConfig(variant="collectall", fire_policy=fire_policy,
                       dtype="float64", **kw)


def _jcfg(fire_policy="every_round", **kw):
    return JaxConfig(variant="collectall", fire_policy=fire_policy,
                     dtype="float64", **kw)


def _svc(topo, capacity, **kw):
    kw.setdefault("config", _cfg())
    return ServiceEngine(topo, capacity, device="cpu", **kw)


def _plain_comparator(topo, svc, cfg, seed, rows: bool):
    """The port's plain round at the service's capacity: the same padded
    layout, masks and seed, with the service's row matrix or without rows
    (the CSR ``segment_reduce``)."""
    padded = pad_topology_to(topo, svc.capacity + 1, svc.edge_capacity,
                             spread="last")
    arrays = padded.device_arrays(device="cpu")
    if rows:
        arrays = arrays.replace(
            sweep_edge_rows=svc.arrays.sweep_edge_rows.clone(),
            out_deg=svc.arrays.out_deg.clone())
    st = init_state(padded, cfg, seed=seed, device="cpu")
    alive = st.alive.clone()
    alive[topo.num_nodes:] = False
    edge_ok = st.edge_ok.clone()
    edge_ok[topo.num_edges:] = False
    return st.replace(alive=alive, edge_ok=edge_ok), arrays


def _assert_engines_match(j, p, atol=1e-9):
    """JAX's and the port's service: mirrors, free lists, integer and bool
    leaves equal; float leaves within ``atol``."""
    pl = p.state.numpy()
    for name in sorted(pl):
        ref = np.asarray(getattr(j.state, name))
        got = pl[name]
        assert ref.shape == got.shape, name
        if ref.dtype.kind == "f":
            np.testing.assert_allclose(got, ref, rtol=0, atol=atol,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(got, ref, err_msg=name)
    for m in ("_src", "_dst", "_rev", "_deg", "_rows", "_delay",
              "_member"):
        np.testing.assert_array_equal(getattr(p, m), getattr(j, m),
                                      err_msg=m)
    assert sorted(p._free_nodes) == sorted(j._free_nodes)
    assert sorted(p._free_edges) == sorted(j._free_edges)


def _assert_close_tree(got, want, path="", atol=1e-9):
    """Equal JSON-like trees, floats within ``atol``."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _assert_close_tree(got[k], want[k], f"{path}.{k}", atol)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_close_tree(g, w, f"{path}[{i}]", atol)
    elif isinstance(want, float):
        assert abs(float(got) - want) <= atol, (path, got, want)
    else:
        assert got == want, (path, got, want)


# ---- no-op parity --------------------------------------------------------

@pytest.mark.parametrize("rows", [True, False], ids=["rows", "csr"])
@pytest.mark.parametrize("fire_policy", ["every_round", "reference"])
def test_noop_service_bitexact_vs_plain_engine(fire_policy, rows):
    topo = pgen.ring(12, k=2, seed=3)
    cfg = _cfg(fire_policy)
    svc = _svc(topo, 20, config=cfg, segment_rounds=8, seed=1,
               degree_budget=6)
    st, arrays = _plain_comparator(topo, svc, cfg, seed=1, rows=rows)
    ref = run_rounds(st, arrays, cfg, 24)
    svc.run(24)
    for name, want in ref.numpy().items():
        np.testing.assert_array_equal(
            svc.state.numpy()[name], want,
            err_msg=f"leaf {name} diverged from the plain round")


@pytest.mark.parametrize("fire_policy", ["every_round", "reference"])
def test_noop_service_matches_jax(fire_policy):
    jt, pt = jgen.ring(12, k=2, seed=3), pgen.ring(12, k=2, seed=3)
    j = JaxService(jt, capacity=20, config=_jcfg(fire_policy),
                   segment_rounds=8, seed=1, degree_budget=6)
    p = _svc(pt, 20, config=_cfg(fire_policy), segment_rounds=8, seed=1,
             degree_budget=6)
    j.run(24)
    p.run(24)
    _assert_engines_match(j, p)


# ---- event mass conservation ---------------------------------------------

def test_join_and_update_are_mass_neutral_bitexact():
    svc = _svc(pgen.grid2d(4, 4, seed=0), 24, segment_rounds=8,
               degree_budget=6)
    svc.run(16)   # mid-flight state: residual is NOT zero here
    r0 = svc.mass_residual().copy()
    assert np.any(r0 != 0.0)
    nid = svc.join(0.77)
    np.testing.assert_array_equal(svc.mass_residual(), r0)
    svc.update([3, 5], [2.5, -1.25])
    np.testing.assert_array_equal(svc.mass_residual(), r0)
    svc.add_edges([(nid, 0), (nid, 3)])
    np.testing.assert_array_equal(svc.mass_residual(), r0)


def test_churn_sequence_conserves_mass_and_recovers():
    rng = np.random.default_rng(7)
    vals = rng.normal(size=(16, 2))
    svc = _svc(pgen.grid2d(4, 4, seed=1), 24, segment_rounds=16,
               degree_budget=8, values=vals)
    expected = vals.sum(axis=0)
    svc.run(32)
    j1 = svc.join(np.array([0.5, -0.5]))
    svc.add_edges([(j1, 0), (j1, 5)])
    expected = expected + np.array([0.5, -0.5])
    svc.run(32)
    svc.update([2], [[1.0, 1.0]])
    expected = expected - vals[2] + np.array([1.0, 1.0])
    svc.leave([3])
    expected = expected - vals[3]
    svc.remove_edges([(0, 1)])
    svc.run(32)
    svc.run(64)

    alive = svc.state.alive.numpy()
    value_mass = svc.state.value.numpy()[alive].sum(axis=0)
    np.testing.assert_allclose(value_mass, expected, rtol=0, atol=1e-12)
    by_name = {c.name: c for c in
               health.check_service(svc.service_block(), dtype="float64")}
    for name in ("service_mass", "service_churn_recovery",
                 "service_capacity", "service_mirror_aliasing"):
        assert by_name[name].status == health.PASS, by_name[name].summary
    assert np.max(np.abs(svc.mass_residual())) < 1e-9


def test_leave_detaches_ledgers_and_inflight():
    svc = _svc(pgen.ring(10, k=2, seed=0), 16, segment_rounds=4,
               degree_budget=6)
    svc.run(12)
    svc.leave([4])
    free = np.asarray(sorted(svc._free_edges))
    park = svc._park
    assert (svc._src[free] == park).all()
    assert (svc._dst[free] == park).all()
    assert (svc._rev[free] == free).all()
    st = svc.state.numpy()
    assert not st["flow"][free].any()
    assert not st["est"][free].any()
    assert not st["buf_valid"][:, free].any()
    assert not st["pending_valid"][:, free].any()
    assert not st["edge_ok"][free].any()
    # the device leaves were edited in place and agree with the mirrors
    for dev, host in (("src", "_src"), ("dst", "_dst"), ("rev", "_rev"),
                      ("out_deg", "_deg"), ("delay", "_delay"),
                      ("sweep_edge_rows", "_rows")):
        np.testing.assert_array_equal(
            getattr(svc.arrays, dev).numpy(), getattr(svc, host),
            err_msg=dev)
    svc.run(64)
    ids, est = svc.estimates()
    assert 4 not in ids
    mean = svc.state.value.numpy()[svc.state.alive.numpy()].mean()
    assert np.max(np.abs(est - mean)) < 1e-9


def test_freed_edge_slots_reset_to_unit_delay():
    import dataclasses

    base = pgen.ring(8, k=1, seed=0)
    topo = dataclasses.replace(
        base, delay=np.full(base.num_edges, 3, np.int32))
    cfg = _cfg(delay_depth=4)
    svc = _svc(topo, 10, config=cfg, segment_rounds=4, degree_budget=4)
    e_uv = svc._edge_slot_of(0, 1)
    assert int(svc._delay[e_uv]) == 3
    svc.run(4)
    svc.remove_edges([(0, 1)])
    freed = {e_uv, int(svc._rev[e_uv])}
    svc.add_edges([(0, 2)])
    e_new = svc._edge_slot_of(0, 2)
    assert e_new in freed or int(svc._rev[e_new]) in freed
    assert int(svc._delay[e_new]) == 1
    assert int(svc.arrays.delay[e_new]) == 1
    svc.run(8)
    assert svc.compile_count == 1


def test_row_edits_land_in_the_matrix_the_round_reads():
    """The row matrix is a column-major tensor held as its transposed
    view: an event's write must reach the storage the row fold gathers
    from, and the round's per-node sums must follow the new edge set."""
    svc = _svc(pgen.ring(10, k=1, seed=0), 14, segment_rounds=4,
               degree_budget=4)
    rows = svc.arrays.sweep_edge_rows
    base = rows.t()
    assert base.is_contiguous() and base.data_ptr() == rows.data_ptr()
    svc.run(8)
    j = svc.join(0.25)
    svc.add_edges([(j, 0), (j, 5)])
    svc.remove_edges([(1, 2)])
    svc.leave([7])
    assert svc.arrays.sweep_edge_rows.data_ptr() == base.data_ptr()
    np.testing.assert_array_equal(base.t().numpy(), svc._rows)
    svc.run(8)
    # the row fold over the edited matrix equals the CSR segment sum over
    # the live edges re-sorted by source
    order = np.argsort(svc._src, kind="stable")
    flow = svc.state.flow[torch.from_numpy(order)]
    deg = np.bincount(svc._src, minlength=svc._n_cap).astype(np.int32)
    csr = svc.state.value - segment_sum(flow, torch.from_numpy(deg))
    live = svc.state.alive
    np.testing.assert_allclose(
        node_estimates(svc.state, svc.arrays)[live].numpy(),
        csr[live].numpy(), rtol=0, atol=1e-12)


# ---- one dispatch signature ----------------------------------------------

def test_compile_count_one_across_100_events():
    svc = _svc(pgen.ring(24, k=2, seed=2), 40, segment_rounds=4,
               degree_budget=6, edge_capacity=160)
    assert svc.compile_count == 0
    svc.run(4)
    assert svc.compile_count == 1
    rng = np.random.default_rng(0)
    held, events = [], 0
    while events < 110:
        if held and (len(held) >= 12 or rng.random() < 0.4):
            svc.leave([held.pop()])
            events += 1
        else:
            slot = svc.join(float(rng.random()))
            a = int(rng.choice(24))
            svc.add_edges([(slot, a)])
            svc.update([a], [float(rng.random())])
            held.append(slot)
            events += 3
        svc.run(4)
    assert svc.compile_count == 1
    by_name = {c.name: c for c in
               health.check_service(svc.service_block(), dtype="float64")}
    assert by_name["service_compile"].status == health.PASS
    assert by_name["service_mass"].status == health.PASS


def test_compile_count_counts_new_signatures():
    """A changed leaf (here the loss draw switched on) is a new dispatch
    signature, and the telemetry runner is a signature of its own: the
    count never hides a change of what the segment dispatches."""
    from flow_updating_tpu_torch.obs.telemetry import TelemetrySpec

    svc = _svc(pgen.ring(12, k=2, seed=0), 16, segment_rounds=4)
    svc.run(8)
    assert svc.compile_count == 1
    series = svc.run(4, telemetry=TelemetrySpec.default())
    assert len(series) == 4
    assert svc.compile_count == 2
    svc.params = svc.params.replace(
        drop_rate=torch.tensor(0.0, dtype=torch.float32))
    svc.run(4)
    assert svc.compile_count == 3


# ---- durability ----------------------------------------------------------

def test_service_checkpoint_roundtrip_bitexact(tmp_path):
    svc = _svc(pgen.grid2d(4, 4, seed=3), 24, segment_rounds=8,
               degree_budget=8)
    svc.run(16)
    j = svc.join(0.9)
    svc.add_edges([(j, 0)])
    svc.leave([7])
    svc.run(16)
    path = str(tmp_path / "svc.npz")
    svc.save_checkpoint(path)
    twin = ServiceEngine.restore_checkpoint(path, device="cpu")
    assert twin.capacity == svc.capacity
    assert twin.member_count == svc.member_count
    assert twin.compile_count == 0
    for s in (svc, twin):
        s.run(16)
        slot = s.join(-0.25)
        assert slot == 7, "free-list restore must reuse the same slot"
        s.add_edges([(slot, 1)])
        s.run(16)
    for name, want in svc.state.numpy().items():
        np.testing.assert_array_equal(twin.state.numpy()[name], want,
                                      err_msg=f"leaf {name} after restore")
    np.testing.assert_array_equal(svc._rows, twin._rows)
    np.testing.assert_array_equal(svc._src, twin._src)
    assert twin.compile_count == 1
    assert svc.state_digest() == twin.state_digest()


def test_service_checkpoint_errors(tmp_path):
    topo = pgen.ring(8, k=1, seed=0)
    svc = _svc(topo, 10, segment_rounds=4)
    path = str(tmp_path / "svc.npz")
    svc.save_checkpoint(path)

    clipped = str(tmp_path / "clipped.npz")
    with open(path, "rb") as f:
        blob = f.read()
    with open(clipped, "wb") as f:
        f.write(blob[: len(blob) // 3])
    with pytest.raises(ValueError, match="clipped.npz.*truncated"):
        ServiceEngine.restore_checkpoint(clipped, device="cpu")

    plain = str(tmp_path / "plain.npz")
    cfg = _cfg()
    ck.save_checkpoint(plain, init_state(topo, cfg, device="cpu"), cfg,
                       topo=topo)
    with pytest.raises(ValueError, match="not a service checkpoint"):
        ServiceEngine.restore_checkpoint(plain, device="cpu")

    with np.load(path) as z:
        manifest = json.loads(bytes(z["__manifest__"]).decode())
        arrays = {k: z[k] for k in z.files if k != "__manifest__"}
    manifest["service_version"] = 99
    old = str(tmp_path / "old.npz")
    ck._write_archive(old, manifest, arrays)
    with pytest.raises(ValueError,
                       match="old.npz.*service schema version 99"):
        ServiceEngine.restore_checkpoint(old, device="cpu")
    # a version-1 archive (no lane tables) still restores
    manifest["service_version"] = 1
    v1 = str(tmp_path / "v1.npz")
    ck._write_archive(v1, manifest, arrays)
    assert ServiceEngine.restore_checkpoint(v1, device="cpu") \
        .state_digest() == svc.state_digest()
    with pytest.raises(ValueError, match="topology mirrors"):
        ck.save_service_checkpoint(path, svc.state, cfg, {}, {})


def _churned_pair(values=None):
    """The same churned service in both packages (float64, with drop)."""
    jt = jgen.erdos_renyi(40, avg_degree=6.0, seed=4)
    pt = pgen.erdos_renyi(40, avg_degree=6.0, seed=4)
    w = int(pt.out_deg.max()) + 4
    j = JaxService(jt, 48, degree_budget=w, segment_rounds=8, seed=2,
                   config=JaxConfig.fast(variant="collectall",
                                         drop_rate=0.05, dtype="float64"),
                   values=values)
    p = ServiceEngine(pt, 48, degree_budget=w, segment_rounds=8, seed=2,
                      config=RoundConfig.fast(variant="collectall",
                                              drop_rate=0.05,
                                              dtype="float64"),
                      values=values, device="cpu")
    for s in (j, p):
        s.run(16)
        slot = s.join(np.full(s.feature_shape, 0.5))
        s.add_edges([(slot, 2), (slot, 9)])
        s.leave([5])
        s.run(16)
    return j, p


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_service_archives_cross_both_ways(tmp_path, direction):
    j, p = _churned_pair()
    path = str(tmp_path / "svc.npz")
    if direction == "jax_to_port":
        j.save_checkpoint(path)
        a = ServiceEngine.restore_checkpoint(path, device="cpu")
        b = JaxService.restore_checkpoint(path)
    else:
        p.save_checkpoint(path)
        a = ServiceEngine.restore_checkpoint(path, device="cpu")
        b = JaxService.restore_checkpoint(path)
    _assert_engines_match(b, a, atol=0.0)
    assert a.metrics.block() == b.metrics.block()
    assert a._epoch == b._epoch and a._event_counts == b._event_counts
    for s in (a, b):
        s.run(16)
        slot = s.join(0.125)
        assert slot == 5
        s.add_edges([(slot, 3)])
        s.run(16)
    _assert_engines_match(b, a)


# ---- bounded-staleness reads ---------------------------------------------

def test_estimates_bounded_staleness():
    svc = _svc(pgen.ring(12, k=2, seed=1), 16, segment_rounds=8)
    svc.run(8)
    value = svc.state.value.clone()
    value[0] += 1.0
    svc.state = svc.state.replace(value=value)
    ids_stale, est_stale = svc.estimates(max_staleness=100)
    ids_fresh, est_fresh = svc.estimates()
    assert abs((est_fresh[0] - est_stale[0]) - 1.0) < 1e-9
    svc.join(0.3)
    ids3, _ = svc.estimates(max_staleness=10**9)
    assert len(ids3) == len(ids_fresh) + 1


# ---- validation ----------------------------------------------------------

def test_capacity_and_validation_errors():
    topo = pgen.ring(6, k=1, seed=0)
    svc = _svc(topo, 7, segment_rounds=4, degree_budget=2,
               edge_capacity=16)
    j = svc.join(1.0)
    with pytest.raises(RuntimeError, match="at capacity"):
        svc.join(2.0)
    with pytest.raises(ValueError, match="not a member"):
        svc.leave([svc.capacity + 5])
    with pytest.raises(ValueError, match="already present"):
        svc.add_edges([(0, 1)])
    with pytest.raises(ValueError, match="self-loop"):
        svc.add_edges([(0, 0)])
    with pytest.raises(RuntimeError, match="degree budget"):
        svc.add_edges([(0, 3)])
    with pytest.raises(ValueError, match="no edge"):
        svc.remove_edges([(0, 3)])
    with pytest.raises(ValueError, match="rounds=6"):
        svc.run(6)
    with pytest.raises(ValueError, match="shape"):
        svc.update([j], [[1.0, 2.0]])
    with pytest.raises(ValueError, match="collectall"):
        ServiceEngine(topo, 8, config=RoundConfig.fast(variant="pairwise"),
                      device="cpu")
    with pytest.raises(ValueError, match="drain"):
        ServiceEngine(topo, 8, config=RoundConfig.reference(),
                      device="cpu")
    with pytest.raises(ValueError, match="capacity"):
        ServiceEngine(topo, 4, device="cpu")
    with pytest.raises(ValueError, match="benes"):
        ServiceEngine(topo, 8, device="cpu", config=RoundConfig.fast(
            variant="collectall", segment_impl="benes"))


def test_edge_capacity_exhaustion_is_named():
    svc = _svc(pgen.ring(6, k=1, seed=0), 8, segment_rounds=4,
               degree_budget=4, edge_capacity=14)
    free = sorted(svc._free_edges)
    assert len(free) == 2
    with pytest.raises(RuntimeError, match="edge capacity 14 exhausted"):
        svc.add_edges([(0, 2), (1, 3)])
    # the batch was validated first: nothing of it was applied, and the
    # slots it had claimed are free again
    assert svc.member_edges() == [(0, 1), (0, 5), (1, 2), (2, 3), (3, 4),
                                  (4, 5)]
    assert sorted(svc._free_edges) == free
    svc.add_edges([(0, 3)])
    assert svc._edge_slot_of(0, 3) == free[0]


def test_card_is_the_default_device():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServiceEngine(pgen.ring(6, k=1, seed=0), 8)
    with pytest.raises(SystemExit, match="--device cpu"):
        port_main(["serve", "--generator", "ring:8:1", "--rounds", "32"])


def test_membership_is_the_shared_churn_primitive():
    topo = pgen.ring(8, k=1, seed=0)
    cfg = _cfg()
    st = init_state(topo, cfg, device="cpu")
    st2 = membership.set_alive(st, [2, 5], False)
    assert not st2.alive.numpy()[[2, 5]].any()
    assert torch.equal(st2.flow, st.flow)
    svc = _svc(topo, 10, config=cfg, segment_rounds=4)
    svc.suspend([2])
    assert svc.live_count == 7 and svc.member_count == 8
    svc.resume([2])
    assert svc.live_count == 8


# ---- against JAX: one event script, epoch by epoch -----------------------

def _script(rng, features):
    """A seeded churn script of (verb, args) steps, ``run`` closing each
    epoch; join and update values are scalars or ``features``-wide."""
    def v():
        return (float(rng.normal()) if features is None
                else rng.normal(size=features))

    return [
        ("join", v()), ("add", 0), ("update", (3, v())), ("run", 16),
        ("join", v()), ("add", 4), ("suspend", 6), ("add", 8),
        ("remove", 4),
        ("run", 16),
        ("resume", 6), ("leave", 0), ("join", v()), ("add", 7),
        ("update", (9, v())), ("run", 32),
        ("leave", 1), ("join", v()), ("add", 11), ("run", 16),
    ]


def _apply(svc, step, joined):
    verb, a = step
    if verb == "join":
        joined.append(svc.join(a))
    elif verb == "add":
        svc.add_edges([(joined[-1], a)])
    elif verb == "update":
        svc.update([a[0]], [a[1]])
    elif verb == "suspend":
        svc.suspend([a])
    elif verb == "resume":
        svc.resume([a])
    elif verb == "remove":
        svc.remove_edges([(joined[-1], a)])
    elif verb == "leave":
        svc.leave([joined[a]])
    elif verb == "run":
        svc.run(a)


@pytest.mark.parametrize("features", [None, 3], ids=["scalar", "vector"])
def test_event_script_matches_jax_epoch_by_epoch(features):
    rng = np.random.default_rng(11)
    n = 30
    values = (None if features is None
              else rng.normal(size=(n, features)))
    jt = jgen.erdos_renyi(n, avg_degree=4.0, seed=5)
    pt = pgen.erdos_renyi(n, avg_degree=4.0, seed=5)
    w = int(pt.out_deg.max()) + 3
    kw = dict(drain=0, pending_depth=1, timeout=3)
    j = JaxService(jt, 36, degree_budget=w, segment_rounds=8, seed=3,
                   config=_jcfg("reference", **kw), values=values)
    p = ServiceEngine(pt, 36, degree_budget=w, segment_rounds=8, seed=3,
                      config=_cfg("reference", **kw), values=values,
                      device="cpu")
    jj, pj = [], []
    for step in _script(rng, features):
        _apply(j, step, jj)
        _apply(p, step, pj)
        assert pj == jj
        if step[0] == "run":
            _assert_engines_match(j, p)
    jb, pb = j.service_block(), p.service_block()
    for blk in (jb, pb):
        del blk["compile_count"], blk["mirror_probe"]
    _assert_close_tree(pb, jb)
    _assert_close_tree(p.history, j.history)
    _assert_close_tree(p.boundary_series(), j.boundary_series())
    assert p.metrics.to_prometheus() == j.metrics.to_prometheus()


def test_both_doctors_agree_on_the_port_service_manifest(tmp_path):
    from flow_updating_tpu_torch.obs.report import build_service_manifest

    _, p = _churned_pair(values=np.random.default_rng(1).normal(
        size=(40, 2)))
    p.run(64)
    manifest = build_service_manifest(
        config=p.config, service=p.service_block(),
        series=p.boundary_series(), report=p.convergence_report(),
        extra={"serving_trace": p.serving_trace_block()}, device="cpu")
    manifest = json.loads(json.dumps(manifest))
    mine = [c.to_jsonable() for c in health.diagnose_manifest(manifest)]
    theirs = [c.to_jsonable() for c in jhealth.diagnose_manifest(manifest)]
    assert [(c["name"], c["status"]) for c in mine] == \
        [(c["name"], c["status"]) for c in theirs]
    by_name = {c["name"]: c["status"] for c in mine}
    for name in ("service_compile", "service_capacity", "service_mass",
                 "service_churn_recovery", "service_mirror_aliasing"):
        assert by_name[name] == "pass", name


# ---- serve CLI + manifest + doctor ---------------------------------------

_EVENTS = ("run 32\n"
           "join 0.5\n"
           "add-edge 16 0   # wire the new member in\n"
           "run 32\n"
           "leave 3\n"
           "update 7 1.25\n"
           "estimates 4\n"
           "run 192\n")


def test_serve_cli_manifest_and_doctor(tmp_path, capsys):
    ev = tmp_path / "events.txt"
    ev.write_text(_EVENTS)
    rep = str(tmp_path / "svc.json")
    ckpt = str(tmp_path / "svc.npz")
    prom = str(tmp_path / "svc.prom")
    rc = port_main(["serve", "--device", "cpu",
                    "--generator", "ring:16:2", "--capacity", "20",
                    "--degree-budget", "6", "--segment-rounds", "32",
                    "--dtype", "float64", "--events", str(ev),
                    "--report", rep, "--checkpoint", ckpt,
                    "--metrics", prom])
    lines = capsys.readouterr().out.strip().splitlines()
    read = json.loads(lines[0])
    summary = json.loads(lines[-1])
    assert rc == 0
    assert read["live"] == 16 and read["max_staleness"] == 4
    assert summary["compile_count"] == 1
    assert summary["live"] == 16
    assert summary["joined"] == [16]
    assert summary["report_path"] == rep
    assert "fu_events_join_total 1" in open(prom).read()

    m = json.load(open(rep))
    assert m["schema"] == "flow-updating-service-report/v1"
    assert m["environment"]["backend"] == "cpu"
    assert m["service"]["capacity"]["nodes"] == 20
    assert m["service"]["event_counts"]["join"] == 1
    assert len(m["service"]["epochs"]) == 3
    assert m["telemetry"]["series"]["mass_residual"]
    assert m["timings"]["checkpoint_s"] > 0 and m["timings"]["setup_s"] > 0
    rc = port_main(["doctor", rep])
    verdict = json.loads(capsys.readouterr().out)
    assert rc == 0 and verdict["overall"] == "pass"
    assert jax_main(["doctor", rep]) == 0
    capsys.readouterr()

    rc = port_main(["serve", "--device", "cpu", "--resume", ckpt,
                    "--rounds", "32"])
    resumed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0
    assert resumed["t"] == summary["t"] + 32
    assert resumed["compile_count"] == 1

    bad = tmp_path / "bad.txt"
    bad.write_text("run 32\nfrobnicate 3\n")
    with pytest.raises(SystemExit, match="line 2.*frobnicate"):
        port_main(["serve", "--device", "cpu", "--generator", "ring:8:1",
                   "--events", str(bad)])
    # --trace-dir captures the serving body, its fu.segment spans inside
    # (ported in A14 part 1)
    from flow_updating_tpu_torch.obs import timeline

    assert port_main(["serve", "--device", "cpu", "--generator", "ring:8:1",
                      "--segment-rounds", "4", "--rounds", "8",
                      "--trace-dir", str(tmp_path / "trace")]) == 0
    capsys.readouterr()
    events, _ = timeline.load_trace_events(
        timeline.latest_trace_file(str(tmp_path / "trace")))
    assert len(timeline.annotation_spans(events, "fu.segment")) == 2


def test_serve_cli_summary_matches_jax(tmp_path, capsys):
    ev = tmp_path / "events.txt"
    ev.write_text(_EVENTS)
    argv = ["serve", "--generator", "ring:16:2", "--capacity", "20",
            "--degree-budget", "6", "--segment-rounds", "32",
            "--dtype", "float64", "--events", str(ev)]
    assert jax_main(argv + ["--backend", "cpu"]) == 0
    jout = capsys.readouterr().out.strip().splitlines()
    assert port_main(argv + ["--device", "cpu"]) == 0
    pout = capsys.readouterr().out.strip().splitlines()
    j, p = json.loads(jout[-1]), json.loads(pout[-1])
    assert set(p) == set(j)
    for k in ("t", "live", "members", "epochs", "events", "joined"):
        assert p[k] == j[k], k
    assert j["compile_count"] <= 1 and p["compile_count"] == 1
    np.testing.assert_allclose(p["mass_residual"], j["mass_residual"],
                               rtol=0, atol=1e-12)
    assert abs(p["rmse"] - j["rmse"]) <= 1e-12
    _assert_close_tree(json.loads(pout[0]), json.loads(jout[0]))


def test_restore_topo_arrays_copy_the_mirrors():
    rows = np.arange(12, dtype=np.int32).reshape(4, 3)
    deg = np.full(4, 3, np.int32)
    src = np.repeat(np.arange(4, dtype=np.int32), 3)
    ar = _service_topo_arrays(src, src.copy(), src.copy(), deg, rows,
                              np.ones(12, np.int32), "cpu")
    deg[0] -= 1
    rows[0, 0] = 99
    assert int(ar.out_deg[0]) == 3 and int(ar.sweep_edge_rows[0, 0]) == 0
    assert ar.sweep_edge_rows.dtype == torch.int64
