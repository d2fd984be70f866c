"""Checkpoint / resume of the port against the JAX package's.

The archive layout is the JAX package's (``utils/checkpoint.py``), so
archives cross in both directions:

* **JAX -> port.**  A JAX ``save_checkpoint`` of a JAX run, restored by
  the port and run R more rounds, equals JAX's own restore and R rounds —
  every state leaf at float64 to 1e-9, the integer and boolean leaves and
  the PRNG key exactly — for both families, fast and faithful,
  ``delay_depth`` 2 and message loss 0.1.
* **Port -> JAX.**  The port's archive is read by JAX's unchanged
  ``load_checkpoint`` and the two runs go on equal.
* **The port's own round trip** is bit-exact (JAX
  ``test_roundtrip_bitexact``'s configurations), through ``Engine`` too,
  on the node round (every ``spmv`` route, both directions with JAX), the
  sharded banded round (and its layout error) and the halo round (whose
  canonical gather equals JAX's on the same plan, and whose scatter gives
  JAX's per-shard keys under message loss).
* **The error contracts** of JAX ``test_checkpoint.py``: a truncated,
  torn, bit-flipped, empty or temp file, a format version, a topology
  mismatch, the config override, a resume past a watcher's kill and a
  revival in one session.
* **The CLI**: ``run --save-checkpoint`` then ``run --resume`` equals one
  straight run, and a JAX-CLI archive resumes in the port's CLI.
"""

import json
import os
import zipfile

import jax
import numpy as np
import pytest
import torch

from flow_updating_tpu.cli import main as jax_main
from flow_updating_tpu.engine import Engine as JaxEngine
from flow_updating_tpu.models.config import RoundConfig as JaxConfig
from flow_updating_tpu.models.rounds import run_rounds as jax_run
from flow_updating_tpu.models.state import init_state as jax_init
from flow_updating_tpu.parallel import sharded as jsh
from flow_updating_tpu.parallel.mesh import make_mesh as jax_make_mesh
from flow_updating_tpu.topology import generators as jgen
from flow_updating_tpu.topology.deployment import (
    load_deployment as jax_load_deployment,
)
from flow_updating_tpu.topology.platform import (
    load_platform as jax_load_platform,
)
from flow_updating_tpu.utils import checkpoint as jck
from flow_updating_tpu_torch import Engine, RoundConfig
from flow_updating_tpu_torch.cli import main as port_main
from flow_updating_tpu_torch.models.rounds import run_rounds
from flow_updating_tpu_torch.models.state import init_state
from flow_updating_tpu_torch.parallel import sharded
from flow_updating_tpu_torch.parallel.mesh import make_mesh
from flow_updating_tpu_torch.topology import generators as pgen
from flow_updating_tpu_torch.topology.deployment import load_deployment
from flow_updating_tpu_torch.topology.platform import load_platform
from flow_updating_tpu_torch.utils import checkpoint as ck

# Start JAX's CPU backend now, while pytest collects (every worker imports
# every test module first), with the suite's 8 virtual devices: a JAX CLI
# call with ``--backend cpu --shards N`` that happened to start the
# backend in a fresh worker would pin N devices for the rest of the
# worker's tests (ROADMAP C4).
jax.devices()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL6 = (os.path.join(ROOT, "examples/platforms/small6.xml"),
          os.path.join(ROOT, "examples/deployments/small6_actors.xml"))
TOL = dict(rtol=1e-9, atol=1e-9)
R1, R2 = 40, 30          # saved after R1 rounds (faithful: before the
#                          timeout bootstrap at 50), resumed for R2
#: (maker, variant, extra): both families, fast and faithful,
#: delay_depth 2, message loss 0.1
CASES = [
    ("fast", "collectall", {}),
    ("fast", "pairwise", {}),
    ("reference", "collectall", dict(delay_depth=2)),
    ("reference", "pairwise", dict(delay_depth=2, drop_rate=0.1)),
]
IDS = [f"{m}-{v}{'-' + '-'.join(map(str, kw.values())) if kw else ''}"
       for m, v, kw in CASES]
SPMV = ("xla", "pallas", "banded", "banded_fused", "benes", "benes_fused")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def graphs():
    return (jgen.erdos_renyi(64, avg_degree=4.0, seed=3),
            pgen.erdos_renyi(64, avg_degree=4.0, seed=3))


def _cfgs(maker, variant, **kw):
    return (getattr(JaxConfig, maker)(variant, dtype="float64", **kw),
            getattr(RoundConfig, maker)(variant, dtype="float64", **kw))


def _port_arrays(topo, cfg):
    return topo.device_arrays(coloring=cfg.needs_coloring, device="cpu")


def _assert_leaves_close(port: dict, ref, exact_floats=False):
    """Every leaf of a port state (``.numpy()`` form) against a JAX
    state or a leaf mapping: floats to 1e-9 (or exactly), the rest
    exactly."""
    get = ref.__getitem__ if isinstance(ref, dict) else (
        lambda n: getattr(ref, n))
    for name, leaf in port.items():
        want = np.asarray(get(name))
        assert leaf.shape == want.shape, name
        if leaf.dtype.kind == "f" and not exact_floats:
            np.testing.assert_allclose(leaf, want, err_msg=name, **TOL)
        else:
            np.testing.assert_array_equal(leaf, want, err_msg=name)


def _save_jax_run(tmp_path, jt, jc, rounds_=R1, seed=7):
    jarr = jt.device_arrays(coloring=jc.needs_coloring)
    js = jax_run(jax_init(jt, jc, seed=seed), jarr, jc, rounds_)
    path = str(tmp_path / "jax.npz")
    jck.save_checkpoint(path, js, jc, topo=jt, extra={"note": "t40"})
    return path, jarr


# ---- the fingerprint and the layout --------------------------------------

@pytest.mark.parametrize("spec", ["ring:64:2", "erdos_renyi:80:5",
                                  "barabasi_albert:60:3", "fat_tree:4",
                                  "grid2d:6:7"])
def test_fingerprint_agrees_with_jax(spec):
    """The digest hashes the topology's arrays as stored, so the port's
    must have JAX's dtypes, or every JAX archive is 'a different
    topology'."""
    jt = jgen.topology_from_spec(spec, seed=3)
    pt = pgen.topology_from_spec(spec, seed=3)
    for name in ("src", "dst", "delay", "values"):
        assert getattr(pt, name).dtype == np.asarray(getattr(jt, name)).dtype
    assert ck.topology_fingerprint(pt) == jck.topology_fingerprint(jt)


def test_fingerprint_agrees_with_jax_on_a_platform():
    for scale in (0.0, 100.0):
        jt = jax_load_deployment(SMALL6[1]).to_topology(
            platform=jax_load_platform(SMALL6[0]), latency_scale=scale)
        pt = load_deployment(SMALL6[1]).to_topology(
            platform=load_platform(SMALL6[0]), latency_scale=scale)
        assert ck.topology_fingerprint(pt) == jck.topology_fingerprint(jt)


def test_archive_layout_is_jax_s(tmp_path, graphs):
    """Keys, manifest and leaf dtypes: the key as uint32 words, ``t`` an
    int32 scalar, the node state's class name JAX's."""
    _, pt = graphs
    cfg = RoundConfig.reference("pairwise", delay_depth=2, drop_rate=0.1,
                                dtype="float64")
    st = run_rounds(init_state(pt, cfg, seed=7, device="cpu"),
                    _port_arrays(pt, cfg), cfg, 3)
    path = str(tmp_path / "p.npz")
    ck.save_checkpoint(path, st, cfg, topo=pt, extra={"clock": 3.0})
    with np.load(path) as z:
        manifest = json.loads(bytes(z["__manifest__"]).decode())
        assert z["state.key"].dtype == np.uint32
        assert z["state.t"].dtype == np.int32 and z["state.t"].shape == ()
        assert sorted(z.files) == sorted(
            ["__manifest__"] + [f"state.{n}" for n in st.numpy()])
    assert manifest["format_version"] == jck.FORMAT_VERSION == 2
    assert manifest["state_class"] == "FlowUpdatingState"
    assert manifest["topology"] == ck.topology_fingerprint(pt)
    assert manifest["extra"] == {"clock": 3.0}
    node = Engine(config=RoundConfig.fast(kernel="node"), device="cpu")
    node.set_topology(pgen.ring(16, 2)).build().run_rounds(2)
    node.save_checkpoint(path)
    with np.load(path) as z:
        manifest = json.loads(bytes(z["__manifest__"]).decode())
        assert z["state.t"].dtype == np.int32 and int(z["state.t"]) == 2
    assert manifest["state_class"] == "NodeSyncState"


# ---- across the frameworks -------------------------------------------------

@pytest.mark.parametrize("maker,variant,kw", CASES, ids=IDS)
def test_jax_archive_resumes_in_port(tmp_path, graphs, maker, variant, kw):
    jt, pt = graphs
    jc, pc = _cfgs(maker, variant, **kw)
    path, jarr = _save_jax_run(tmp_path, jt, jc)
    js, jc2, jextra = jck.load_checkpoint(path, topo=jt)
    want = jax_run(js, jarr, jc2, R2)
    ps, pc2, pextra = ck.load_checkpoint(path, topo=pt, device="cpu")
    assert pc2 == pc and pextra == jextra == {"note": "t40"}
    assert ps.key.dtype == torch.int64
    if pc.needs_coloring:
        # the archive's coloring re-seeded the port's topology
        np.testing.assert_array_equal(pt._edge_coloring[0],
                                      jt.edge_coloring()[0])
    got = run_rounds(ps, _port_arrays(pt, pc2), pc2, R2)
    _assert_leaves_close(got.numpy(), want)


@pytest.mark.parametrize("maker,variant,kw", CASES, ids=IDS)
def test_port_archive_resumes_in_jax(tmp_path, graphs, maker, variant, kw):
    jt, pt = graphs
    jc, pc = _cfgs(maker, variant, **kw)
    parr = _port_arrays(pt, pc)
    ps = run_rounds(init_state(pt, pc, seed=7, device="cpu"), parr, pc, R1)
    path = str(tmp_path / "port.npz")
    ck.save_checkpoint(path, ps, pc, topo=pt, extra={"note": "t40"})
    js, jc2, jextra = jck.load_checkpoint(path, topo=jt)   # JAX, unchanged
    assert jc2 == jc and jextra == {"note": "t40"}
    _assert_leaves_close(ps.numpy(), js, exact_floats=True)
    want = jax_run(js, jt.device_arrays(coloring=jc.needs_coloring), jc2, R2)
    got = run_rounds(ps, parr, pc, R2)
    _assert_leaves_close(got.numpy(), want)


@pytest.mark.parametrize("spmv", SPMV)
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_node_round_archives_cross(tmp_path, spmv, direction):
    """The node round's archive in each route's padded layout (the ELL
    degree order, the 'pallas' 256-row buckets, the RCM order, the tile
    grid): the port's layouts are JAX's, so both directions restore."""
    jt, pt = jgen.ring(80, 2, seed=1), pgen.ring(80, 2, seed=1)
    kw = dict(kernel="node", spmv=spmv, dtype="float64")
    jc, pc = JaxConfig.fast(**kw), RoundConfig.fast(**kw)
    path = str(tmp_path / "node.npz")
    if direction == "jax_to_port":
        JaxEngine(config=jc).set_topology(jt).build().run_rounds(
            7).save_checkpoint(path)
    else:
        Engine(config=pc, device="cpu").set_topology(pt).build().run_rounds(
            7).save_checkpoint(path)
    je = JaxEngine().set_topology(jt).restore_checkpoint(path)
    pe = Engine(device="cpu").set_topology(pt).restore_checkpoint(path)
    assert pe.config == pc and pe.clock == je.clock == 7.0
    je.run_rounds(6)
    pe.run_rounds(6)
    assert pe.convergence_report()["t"] == 13
    np.testing.assert_allclose(pe.estimates(), je.estimates(), **TOL)


# ---- the port's own round trip and the engine ------------------------------

@pytest.mark.parametrize("cfg", [
    RoundConfig.fast(variant="collectall"),
    RoundConfig.reference(variant="collectall", delay_depth=2),
    RoundConfig.reference(variant="pairwise", delay_depth=2, drop_rate=0.1),
])
def test_roundtrip_bitexact(tmp_path, cfg):
    topo = pgen.erdos_renyi(64, avg_degree=4.0, seed=3)
    arrays = _port_arrays(topo, cfg)
    state = init_state(topo, cfg, seed=7, device="cpu")
    straight = run_rounds(state, arrays, cfg, 20)
    half = run_rounds(state, arrays, cfg, 10)
    path = str(tmp_path / "ckpt.npz")
    ck.save_checkpoint(path, half, cfg, topo=topo, extra={"note": "t10"})
    restored, cfg2, extra = ck.load_checkpoint(path, topo=topo,
                                               device="cpu")
    assert cfg2 == cfg and extra == {"note": "t10"}
    resumed = run_rounds(restored, arrays, cfg, 10)
    _assert_leaves_close(resumed.numpy(), straight.numpy(),
                         exact_floats=True)


def test_edge_coloring_cached_through_checkpoint(tmp_path):
    """A computed coloring rides the checkpoint and re-seeds a fresh
    Topology at restore — a resumed fast-pairwise run never recolors."""
    cfg = RoundConfig.fast(variant="pairwise")
    topo = pgen.ring(32, k=2, seed=1)
    topo.device_arrays(coloring=True, device="cpu")   # computes + caches
    color, c = topo.edge_coloring()
    path = str(tmp_path / "ckpt.npz")
    ck.save_checkpoint(path, init_state(topo, cfg, device="cpu"), cfg,
                       topo=topo)
    fresh = pgen.ring(32, k=2, seed=1)
    assert getattr(fresh, "_edge_coloring", None) is None
    ck.load_checkpoint(path, topo=fresh, device="cpu")
    np.testing.assert_array_equal(fresh._edge_coloring[0], color)
    assert fresh._edge_coloring[1] == c


def test_engine_checkpoint_resume_small6(tmp_path):
    """JAX ``test_engine_checkpoint_resume`` through the port, and the
    port's archive resumed by JAX's engine to the same estimates."""
    cfg = RoundConfig.reference(variant="collectall", delay_depth=2,
                                dtype="float64")

    def fresh(make=Engine, config=cfg, **kw):
        e = make(config=config, **kw).load_platform(SMALL6[0])
        return e.register_actor("peer").load_deployment(SMALL6[1])

    path = str(tmp_path / "engine.npz")
    a = fresh(device="cpu").build().run_rounds(100)
    a.save_checkpoint(path)
    b = fresh(device="cpu").restore_checkpoint(path)
    j = fresh(JaxEngine, JaxConfig.reference(variant="collectall",
                                             delay_depth=2, dtype="float64"))
    j.restore_checkpoint(path)
    assert b.clock == a.clock == j.clock == 100.0
    for e in (a, b, j):
        e.run_rounds(300)
    np.testing.assert_array_equal(a.estimates(), b.estimates())
    np.testing.assert_allclose(b.estimates(), j.estimates(), **TOL)
    assert np.max(np.abs(a.estimates() - a.topology.true_mean)) < 1e-3


def test_config_restored_overrides(tmp_path):
    """restore_checkpoint adopts the checkpoint's config (delay_depth
    shapes the ring buffer)."""
    topo = pgen.ring(8, seed=0)
    saved_cfg = RoundConfig.reference(variant="pairwise", delay_depth=3)
    path = str(tmp_path / "c.npz")
    ck.save_checkpoint(path, init_state(topo, saved_cfg, device="cpu"),
                       saved_cfg, topo=topo)
    e = Engine(config=RoundConfig.fast(), device="cpu").set_topology(topo)
    e.build().restore_checkpoint(path)
    assert e.config == saved_cfg
    assert e.state.buf_flow.shape[0] == 3


def test_resume_past_watcher_kill(tmp_path):
    """A checkpoint taken after a watcher's stop restores killed=True,
    and a new watcher with a later deadline revives the peers."""
    cfg = RoundConfig.reference(variant="collectall", delay_depth=2)

    def fresh():
        e = Engine(config=cfg, device="cpu").load_platform(SMALL6[0])
        return e.register_actor("peer").load_deployment(SMALL6[1])

    path = str(tmp_path / "killed.npz")
    a = fresh().build()
    a.add_watcher(run_until=50.0, time_interval=25.0)
    a.run_until(50.0)
    a.save_checkpoint(path)
    rmse_at_kill = a.convergence_report()["rmse"]
    b = fresh().restore_checkpoint(path)
    assert b._killed and b.clock == 50.0
    b.add_watcher(run_until=400.0, time_interval=100.0)
    b.run_until(400.0)
    assert int(b.state.t) == 400
    assert b.convergence_report()["rmse"] < rmse_at_kill / 10


def test_revive_in_session():
    """Reviving works on one live engine: the expired watcher does not
    stop the peers again at its old deadline."""
    e = Engine(config=RoundConfig.reference(variant="collectall",
                                            delay_depth=2), device="cpu")
    e.load_platform(SMALL6[0]).register_actor("peer")
    e.load_deployment(SMALL6[1]).build()
    e.add_watcher(run_until=50.0, time_interval=25.0)
    e.run_until(50.0)
    assert int(e.state.t) == 50
    e.add_watcher(run_until=400.0, time_interval=100.0)
    e.run_until(400.0)
    assert int(e.state.t) == 400


# ---- error contracts -------------------------------------------------------

def _small_archive(tmp_path, name="full.npz"):
    cfg = RoundConfig.fast()
    topo = pgen.ring(8, k=1, seed=0)
    path = str(tmp_path / name)
    ck.save_checkpoint(path, init_state(topo, cfg, device="cpu"), cfg,
                       topo=topo)
    return path, topo


def test_truncated_checkpoint_names_file_and_fix(tmp_path):
    path, _ = _small_archive(tmp_path)
    clipped = str(tmp_path / "clipped.npz")
    blob = open(path, "rb").read()
    open(clipped, "wb").write(blob[: len(blob) // 4])
    with pytest.raises(ValueError, match="clipped.npz.*truncated"):
        ck.load_checkpoint(clipped, device="cpu")
    with pytest.raises(ValueError, match="no such file"):
        ck.load_checkpoint(str(tmp_path / "never-written.npz"),
                           device="cpu")
    junk = str(tmp_path / "junk.npz")
    open(junk, "w").write("this is not a checkpoint")
    with pytest.raises(ValueError, match="junk.npz"):
        ck.load_checkpoint(junk, device="cpu")


@pytest.mark.parametrize("damage", ["torn", "flip", "empty", "temp"])
def test_corruption_matrix_names_file(tmp_path, damage):
    """Torn tail, a flipped byte (surfacing at the lazy member read), a
    zero-length file and a partially-written temp: each is a ValueError
    naming the FILE, never a raw zipfile/zlib traceback."""
    path, topo = _small_archive(tmp_path)
    blob = open(path, "rb").read()
    if damage == "torn":
        bad, data, match = "torn.npz", blob[: len(blob) * 3 // 5], "torn"
    elif damage == "flip":
        # one byte flipped inside a member's compressed data: size and
        # headers intact, caught by the member's CRC at the read
        with zipfile.ZipFile(path) as zf:
            info = zf.getinfo("state.flow.npy")
        head = info.header_offset
        extra = int.from_bytes(blob[head + 28: head + 30], "little")
        at = head + 30 + len(info.filename) + extra + info.compress_size // 2
        flipped = bytearray(blob)
        flipped[at] ^= 0xFF
        bad, data, match = "flip.npz", bytes(flipped), "flip.npz"
    elif damage == "empty":
        bad, data, match = "empty.npz", b"", "empty.npz"
    else:
        bad, data = "full.npz.tmp.4242", blob[: len(blob) // 3]
        match = r"tmp\.4242.*partially-written temp"
    target = str(tmp_path / bad)
    open(target, "wb").write(data)
    with pytest.raises(ValueError, match=match):
        ck.load_checkpoint(target, topo=topo, device="cpu")
    with pytest.raises(ValueError, match=match):
        Engine(device="cpu").set_topology(topo).restore_checkpoint(target)


def test_interrupted_save_leaves_no_final_file(tmp_path, monkeypatch):
    path, topo = _small_archive(tmp_path)
    target = str(tmp_path / "crash.npz")

    def crash(final):
        raise KeyboardInterrupt(final)

    monkeypatch.setattr(ck, "_CRASH_BEFORE_REPLACE", crash)
    with pytest.raises(KeyboardInterrupt):
        e = Engine(config=RoundConfig.fast(), device="cpu")
        e.set_topology(topo).build().save_checkpoint(target)
    assert sorted(os.listdir(tmp_path)) == ["full.npz"]


def test_format_version_mismatch_names_file_and_versions(tmp_path):
    path, _ = _small_archive(tmp_path)
    with np.load(path) as z:
        manifest = json.loads(bytes(z["__manifest__"]).decode())
        arrays = {k: z[k] for k in z.files if k != "__manifest__"}
    manifest["format_version"] = 1
    old = str(tmp_path / "old-format.npz")
    ck._write_archive(old, manifest, arrays)
    with pytest.raises(ValueError,
                       match=r"old-format.npz.*version 1.*reads version 2"):
        ck.load_checkpoint(old, device="cpu")
    # a leaf whose dtype disagrees with its manifest entry
    manifest["format_version"] = 2
    manifest["dtypes"]["flow"] = "float64"
    lied = str(tmp_path / "lied.npz")
    ck._write_archive(lied, manifest, arrays)
    with pytest.raises(ValueError, match="manifest entry"):
        ck.load_checkpoint(lied, device="cpu")


def test_topology_mismatch_rejected(tmp_path):
    cfg = RoundConfig.fast()
    topo = pgen.ring(16, k=2, seed=0)
    path = str(tmp_path / "ckpt.npz")
    ck.save_checkpoint(path, init_state(topo, cfg, device="cpu"), cfg,
                       topo=topo)
    other = pgen.ring(16, k=2, seed=1)  # same shape, different values
    with pytest.raises(ValueError, match="different topology"):
        ck.load_checkpoint(path, topo=other, device="cpu")
    with pytest.raises(ValueError, match="different topology"):
        Engine(device="cpu").set_topology(other).restore_checkpoint(path)


def test_unported_flavours_raise_naming_items():
    for fn, item in ((ck.save_actor_checkpoint, "A8"),
                     (ck.load_actor_checkpoint, "A8"),
                     (ck.save_service_checkpoint, "A11"),
                     (ck.load_service_checkpoint, "A11")):
        with pytest.raises(NotImplementedError, match=item):
            fn("x.npz")


def test_restore_needs_no_build_and_lands_on_the_engine_device(tmp_path):
    """No fresh state first, and no card: a CPU engine restores on the
    host; the default (card) restore raises without one."""
    path, topo = _small_archive(tmp_path)
    e = Engine(device="cpu").set_topology(topo)
    assert e.state is None
    e.restore_checkpoint(path)
    assert e.state.flow.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ck.load_checkpoint(path)


# ---- the sharded banded round ---------------------------------------------

@pytest.mark.parametrize("direction", ["port", "jax_to_port",
                                       "port_to_jax"])
def test_sharded_banded_restore(tmp_path, direction):
    """A sharded node state saves as JAX's ``NodeSyncState`` with ``(S,
    M/S)`` leaves and restores on a mesh (JAX's ``'ppermute'`` exchange
    is the oracle); the single-device kernel refuses the layout."""
    kw = dict(kernel="node", spmv="banded_fused", dtype="float64")
    jt, pt = jgen.ring(2000, 2), pgen.ring(2000, 2)
    path = str(tmp_path / "mesh.npz")

    def port_engine():
        return Engine(config=RoundConfig.fast(**kw),
                      mesh=make_mesh(4, device="cpu"), halo="overlap",
                      device="cpu").set_topology(pt)

    def jax_engine():
        return JaxEngine(config=JaxConfig.fast(**kw),
                         mesh=jax_make_mesh(4)).set_topology(jt)

    src = jax_engine() if direction == "jax_to_port" else port_engine()
    src.build().run_rounds(9)
    src.save_checkpoint(path)
    with np.load(path) as z:
        assert z["state.S"].shape[0] == 4
    dst = (jax_engine() if direction == "port_to_jax"
           else port_engine()).restore_checkpoint(path)
    assert dst.clock == 9.0
    src.run_rounds(5)
    dst.run_rounds(5)
    if direction == "port":
        np.testing.assert_array_equal(dst.estimates(), src.estimates())
        for name in ("S", "G", "avg_prev", "A_prev", "avg"):
            for a, b in zip(getattr(src.state, name),
                            getattr(dst.state, name)):
                assert torch.equal(a, b), name
    else:
        np.testing.assert_allclose(dst.estimates(), src.estimates(), **TOL)
    single = Engine(device="cpu").set_topology(pt)
    with pytest.raises(ValueError, match="interchangeable|node axis"):
        single.restore_checkpoint(path)


def test_sharded_layout_with_the_same_slot_count_is_refused(tmp_path):
    """JAX's second check: the slot count can match while the layout
    does not — the ``(S, M/S)`` state never restores as ``(M,)``."""
    pt = pgen.ring(2000, 2)
    e = Engine(config=RoundConfig.fast(kernel="node", spmv="banded_fused"),
               mesh=make_mesh(4, device="cpu"), device="cpu")
    e.set_topology(pt).build().run_rounds(3)
    path = str(tmp_path / "mesh.npz")
    e.save_checkpoint(path)
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files if k != "__manifest__"}
        manifest = json.loads(bytes(z["__manifest__"]).decode())
    flat = str(tmp_path / "flat.npz")
    ck._write_archive(flat, manifest, {
        k: (v.reshape(2, -1) if v.ndim == 2 else v)
        for k, v in arrays.items()})
    with pytest.raises(ValueError, match="interchangeable"):
        Engine(mesh=make_mesh(4, device="cpu"),
               device="cpu").set_topology(pt).restore_checkpoint(flat)


# ---- the halo round ---------------------------------------------------------

def _halo_pair(cfg_kw, partition="bfs", seed=5, rounds_=23):
    """The same halo run on both sides: JAX's 'ppermute' on its 4-device
    CPU mesh, the port's 'overlap_pallas' on a 4-shard host mesh."""
    jc, pc = _cfgs("reference", "collectall", **cfg_kw)
    jt = jgen.erdos_renyi(257, avg_degree=6.0, seed=7)
    pt = pgen.erdos_renyi(257, avg_degree=6.0, seed=7)
    je = JaxEngine(config=jc, mesh=jax_make_mesh(4), multichip="halo",
                   partition=partition).set_topology(jt).build(seed=seed)
    pe = Engine(config=pc, mesh=make_mesh(4, device="cpu"),
                multichip="halo", halo="overlap_pallas", partition=partition,
                device="cpu").set_topology(pt).build(seed=seed)
    je.run_rounds(rounds_)
    pe.run_rounds(rounds_)
    return je, pe


@pytest.mark.parametrize("partition", ["bfs", "contiguous"])
def test_halo_gather_and_scatter_match_jax(partition):
    """On the same plan and run (message loss 0.1): the canonical gather
    equals JAX's (key exactly: shard 0's), and scattering it back gives
    JAX's blocked state bit for bit, per-shard ``fold_in`` keys and
    padding included."""
    je, pe = _halo_pair(dict(delay_depth=2, drop_rate=0.1),
                        partition=partition, rounds_=60)
    jcanon = jsh.gather_full_state(je.state, je._halo_plan, je.topology)
    pcanon = sharded.gather_full_state(pe.state, pe._halo_plan, pe.topology)
    assert pcanon.flow.device.type == "cpu"
    _assert_leaves_close(pcanon.numpy(), jcanon)
    jback = jsh.scatter_full_state(jcanon, je._halo_plan, je.topology,
                                   je.config, je.mesh)
    pback = sharded.scatter_full_state(
        {n: np.asarray(getattr(jcanon, n)) for n in pcanon.numpy()},
        pe._halo_plan, pe.topology, pe.config, pe.mesh)
    _assert_leaves_close(pback.numpy(), jback, exact_floats=True)
    assert len({tuple(s.key.tolist()) for s in pback.shards}) == 4


def test_halo_scatter_inverts_gather_on_real_slots():
    """gather -> scatter returns every leaf of the halo state (keys aside)
    on the real node and edge slots; the dead padding slots take the
    fresh state's values."""
    _, pe = _halo_pair(dict(delay_depth=2), rounds_=70)
    plan = pe._halo_plan
    canon = sharded.gather_full_state(pe.state, plan, pe.topology)
    back = sharded.scatter_full_state(canon, plan, pe.topology, pe.config,
                                      pe.mesh)
    a, b = pe.state.numpy(), back.numpy()
    real = plan.alive0
    for name in a:
        if name == "key":
            continue
        if a[name].shape[:2] == real.shape:
            np.testing.assert_array_equal(a[name][real], b[name][real],
                                          err_msg=name)
        else:
            np.testing.assert_array_equal(a[name], b[name], err_msg=name)
    assert (b["ticks"][~real] == 0).all()


def test_halo_checkpoint_is_canonical_and_cross_restorable(tmp_path):
    """JAX ``test_halo_mode_checkpoint_is_canonical_and_cross_
    restorable`` on the port's 4-shard host mesh: restore into a fresh
    halo engine (another partition) and into a single-device engine —
    estimates equal up to the summation order — and both continuations
    agree; a fresh halo engine on the same plan continues bit for bit;
    JAX's halo engine restores the port's archive."""
    je, pe = _halo_pair({}, rounds_=23)
    ref = pe.estimates()
    path = str(tmp_path / "halo.npz")
    pe.save_checkpoint(path)
    with np.load(path) as z:
        assert z["state.flow"].shape == (pe.topology.num_edges,)
    pc = pe.config
    e2 = Engine(config=pc, mesh=make_mesh(4, device="cpu"),
                multichip="halo", partition="contiguous", device="cpu")
    e2.set_topology(pe.topology).restore_checkpoint(path)
    np.testing.assert_allclose(e2.estimates(), ref, atol=1e-12)
    e3 = Engine(config=pc, device="cpu").set_topology(pe.topology)
    e3.restore_checkpoint(path)
    np.testing.assert_allclose(e3.estimates(), ref, atol=1e-12)
    e4 = Engine(mesh=make_mesh(4, device="cpu"), multichip="halo",
                halo="overlap_pallas", device="cpu")
    e4.set_topology(pe.topology).restore_checkpoint(path)
    jr = JaxEngine(mesh=jax_make_mesh(4), multichip="halo")
    jr.set_topology(je.topology).restore_checkpoint(path)
    for e in (e2, e3, e4, pe, jr):
        e.run_rounds(40)
    np.testing.assert_allclose(e2.estimates(), e3.estimates(), atol=1e-9)
    np.testing.assert_allclose(jr.estimates(), e4.estimates(), **TOL)
    a = sharded.gather_full_state(pe.state, pe._halo_plan, pe.topology)
    b = sharded.gather_full_state(e4.state, e4._halo_plan, e4.topology)
    for name, leaf in a.numpy().items():
        if name != "key":
            np.testing.assert_array_equal(leaf, b.numpy()[name], name)


# ---- the CLI ---------------------------------------------------------------

def _report(capsys, main, argv):
    assert main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_save_then_resume_equals_one_run(tmp_path, capsys):
    path = str(tmp_path / "cli.npz")
    flags = ["--device", "cpu", "--generator", "erdos_renyi:120:5",
             "--drop-rate", "0.1", "--delay-depth", "2"]
    straight = _report(capsys, port_main, ["run", *flags, "--rounds", "90"])
    first = _report(capsys, port_main, ["run", *flags, "--rounds", "50",
                                        "--save-checkpoint", path])
    assert first["checkpoint"] == path and first["t"] == 50
    # --rounds counts from the restored round; the archive's config wins
    # over the (different) flags, with a warning
    resumed = _report(capsys, port_main, [
        "run", "--device", "cpu", "--generator", "erdos_renyi:120:5",
        "--resume", path, "--rounds", "40"])
    assert resumed["t"] == 90
    for key in ("rmse", "max_abs_err", "mass_residual",
                "antisymmetry_residual"):
        assert resumed[key] == straight[key], key
    with pytest.raises(SystemExit, match="cannot resume from .*different "
                                         "topology"):
        port_main(["run", "--device", "cpu", "--generator",
                   "erdos_renyi:121:5", "--resume", path, "--rounds", "1"])
    with pytest.raises(SystemExit, match="cannot resume from .*no such"):
        port_main(["run", "--device", "cpu", "--generator",
                   "erdos_renyi:120:5", "--resume", str(tmp_path / "nope"),
                   "--rounds", "1"])


def test_cli_resumes_a_jax_cli_archive(tmp_path, capsys):
    """JAX's ``run --save-checkpoint`` (float32, no x64, as its CLI runs)
    resumed by the port's ``run --resume`` and by JAX's own: the reports
    agree at the CLI tests' relative 1e-3 above 1e-7."""
    path = str(tmp_path / "jax-cli.npz")
    flags = ["--generator", "ring:64:2", "--variant", "pairwise",
             "--delay-depth", "2"]
    with jax.enable_x64(False):
        _report(capsys, jax_main, ["run", "--backend", "cpu", *flags,
                                   "--rounds", "60",
                                   "--save-checkpoint", path])
        jrep = _report(capsys, jax_main, ["run", "--backend", "cpu",
                                          *flags, "--resume", path,
                                          "--rounds", "60"])
    prep = _report(capsys, port_main, ["run", "--device", "cpu", *flags,
                                       "--resume", path, "--rounds", "60"])
    assert prep["t"] == jrep["t"] == 120
    for key in ("rmse", "max_abs_err", "mass_residual",
                "antisymmetry_residual"):
        assert abs(prep[key] - jrep[key]) <= 1e-3 * abs(jrep[key]) + 1e-7, \
            key
