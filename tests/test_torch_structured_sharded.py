"""The pod-sharded fat-tree stencil (``parallel/structured_sharded.py``,
``Engine(mesh=..., multichip='pod')``) against the JAX package's.

The cases are JAX ``tests/test_structured_sharded.py``'s, on the port's
host mesh (``make_mesh(n, device='cpu')``): the pod kernel against JAX's
single-device structured kernel and JAX's pod kernel at float64 within
1e-12 (the pod sum reassociates the core column's sum, as JAX's ``psum``
does), its overlap schedule equal to the plain one bit for bit, virtual
trees, the rejections, ``Engine`` with its streamed observer and
``run_until_rmse``, archives that cross between pod meshes, one device
and JAX, and the CLI's pod report against JAX's library run (not JAX's
``run --shards`` CLI, which can pin a worker's JAX device count, ROADMAP
C4).
"""

import json

import jax
import numpy as np
import pytest
import torch

from flow_updating_tpu.engine import Engine as JaxEngine
from flow_updating_tpu.models import sync as jsync
from flow_updating_tpu.models.config import RoundConfig as JaxConfig
from flow_updating_tpu.parallel.mesh import make_mesh as jax_make_mesh
from flow_updating_tpu.parallel.structured_sharded import (
    PodShardedFatTreeKernel as JaxPodKernel,
)
from flow_updating_tpu.topology import generators as jgen
from flow_updating_tpu.utils import checkpoint as jck
from flow_updating_tpu_torch import Engine, NodeKernel, RoundConfig
from flow_updating_tpu_torch.cli import main as port_main
from flow_updating_tpu_torch.obs.telemetry import TelemetrySpec
from flow_updating_tpu_torch.parallel.mesh import make_mesh
from flow_updating_tpu_torch.parallel.structured_sharded import (
    PodShardedFatTreeKernel,
)
from flow_updating_tpu_torch.topology import generators as pgen

# the suite's 8 virtual JAX devices, started while pytest collects
jax.devices()

TOL = dict(rtol=1e-12, atol=1e-12)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def _cfgs(**kw):
    kw = dict(kernel="node", spmv="structured", dtype="float64", **kw)
    return JaxConfig.fast(**kw), RoundConfig.fast(**kw)


def _mesh(n):
    return make_mesh(n, device="cpu")


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_matches_single_device(shards):
    """50 rounds: JAX's single-device stencil and JAX's pod kernel, within
    1e-12; converged; overlap equal to the plain schedule bit for bit."""
    jt, pt = jgen.fat_tree(8, seed=2), pgen.fat_tree(8, seed=2)
    jcfg, pcfg = _cfgs()
    ref = jsync.NodeKernel(jt, jcfg)
    e_ref = ref.estimates(ref.run(ref.init_state(), 50))
    jpod = JaxPodKernel(jt, jcfg, jax_make_mesh(shards))
    e_jpod = jpod.estimates(jpod.run(jpod.init_state(), 50))
    out = {}
    for overlap in (False, True):
        kern = PodShardedFatTreeKernel(pt, pcfg, _mesh(shards),
                                       overlap=overlap)
        st = kern.run(kern.init_state(), 50)
        assert st.t == 50
        out[overlap] = kern.estimates(st)
    np.testing.assert_array_equal(out[True], out[False])
    np.testing.assert_allclose(out[False], e_ref, **TOL)
    np.testing.assert_allclose(out[False], e_jpod, **TOL)
    assert np.abs(out[False] - pt.true_mean).max() < 1e-6


def test_overlap_states_equal_bit_for_bit():
    """Every field of every shard, overlap against plain, at float32."""
    pt = pgen.fat_tree(12, seed=8)
    cfg = RoundConfig.fast(kernel="node", spmv="structured")
    a = PodShardedFatTreeKernel(pt, cfg, _mesh(3))
    b = PodShardedFatTreeKernel(pt, cfg, _mesh(3), overlap=True)
    sa = a.run(a.init_state(), 33)
    sb = b.run(b.init_state(), 33)
    for f in ("S", "G", "avg_prev", "A_prev"):
        for x, y in zip(getattr(sa, f), getattr(sb, f)):
            assert torch.equal(x, y), f
    # the replicated core sections advance alike on every shard
    cores = [a._sections(g)[3] for g in sa.G]
    assert all(torch.equal(c, cores[0]) for c in cores)


def test_virtual_topology_runs_sharded():
    """The mega-scale configuration: a virtual fat tree by pod, equal to
    the materialized tree's pod run and to JAX's virtual pod run."""
    jv = jgen.fat_tree(8, seed=2, materialize_edges=False)
    tv = pgen.fat_tree(8, seed=2, materialize_edges=False)
    tm = pgen.fat_tree(8, seed=2)
    jcfg, pcfg = _cfgs()
    kv = PodShardedFatTreeKernel(tv, pcfg, _mesh(4))
    km = PodShardedFatTreeKernel(tm, pcfg, _mesh(4))
    ev = kv.estimates(kv.run(kv.init_state(), 30))
    np.testing.assert_array_equal(ev, km.estimates(km.run(km.init_state(),
                                                          30)))
    jk = JaxPodKernel(jv, jcfg, jax_make_mesh(4))
    np.testing.assert_allclose(ev, jk.estimates(jk.run(jk.init_state(), 30)),
                               **TOL)


def test_rejects_bad_inputs():
    pcfg = _cfgs()[1]
    with pytest.raises(ValueError, match="divide"):
        PodShardedFatTreeKernel(pgen.fat_tree(6, seed=0), pcfg, _mesh(4))
    with pytest.raises(ValueError, match="fat-tree structure"):
        PodShardedFatTreeKernel(pgen.ring(64, 2, seed=0), pcfg, _mesh(4))
    with pytest.raises(ValueError, match="collect-all"):
        PodShardedFatTreeKernel(
            pgen.fat_tree(8, seed=0),
            RoundConfig.reference(variant="collectall", delay_depth=2),
            _mesh(4))
    with pytest.raises(TypeError, match="make_mesh"):
        PodShardedFatTreeKernel(pgen.fat_tree(8, seed=0), pcfg, object())
    with pytest.raises(ValueError, match="disagrees"):
        PodShardedFatTreeKernel(pgen.fat_tree(8, seed=0), pcfg, _mesh(2),
                                device="cuda")
    k = PodShardedFatTreeKernel(pgen.fat_tree(8, seed=0), pcfg, _mesh(2))
    from flow_updating_tpu_torch.obs.fields import FieldSpec

    with pytest.raises(ValueError, match="field spec is disabled"):
        k.run_fields(k.init_state(), 4, FieldSpec.off())
    with pytest.raises(ValueError, match="multiple of the field stride"):
        k.run_fields(k.init_state(), 5, FieldSpec.default(stride=2))
    with pytest.raises(ValueError, match="disabled"):
        k.run_telemetry(k.init_state(), 4, TelemetrySpec.off())


def test_last_avg_matches_single_device():
    jt, pt = jgen.fat_tree(8, seed=5), pgen.fat_tree(8, seed=5)
    jcfg, pcfg = _cfgs()
    ref = jsync.NodeKernel(jt, jcfg)
    kern = PodShardedFatTreeKernel(pt, pcfg, _mesh(2))
    a_ref = ref.last_avg(ref.run(ref.init_state(), 20))
    a_sh = kern.last_avg(kern.run(kern.init_state(), 20))
    np.testing.assert_allclose(a_sh, a_ref, **TOL)


def test_canonical_layout_round_trip():
    """to_canonical equals the single-device structured state of the same
    round; from_canonical scatters it back to every shard, exactly."""
    pt = pgen.fat_tree(8, seed=1)
    pcfg = _cfgs()[1]
    kern = PodShardedFatTreeKernel(pt, pcfg, _mesh(4))
    st = kern.run(kern.init_state(), 12)
    flat = kern.to_canonical(st)
    one = NodeKernel(pt, pcfg, device="cpu")
    ref = one.run(one.init_state(), 12)
    for f in ("S", "G", "avg_prev", "A_prev"):
        np.testing.assert_allclose(getattr(flat, f).numpy(),
                                   getattr(ref, f).numpy(), **TOL)
    back = kern.from_canonical(flat)
    for f in ("S", "G", "avg_prev", "A_prev"):
        for x, y in zip(getattr(back, f), getattr(st, f)):
            assert torch.equal(x, y), f
    with pytest.raises(ValueError, match="canonical"):
        kern.state_from_numpy({"t": 0, **{f: np.zeros((4, 5)) for f in
                                          ("S", "G", "avg_prev",
                                           "A_prev")}})


def test_engine_pod_mode_matches_single_device():
    """multichip='pod' through the Engine: the single-device structured
    engine's estimates, and the streamed observer's samples against JAX's
    pod kernel's."""
    jt, pt = jgen.fat_tree(8, seed=4), pgen.fat_tree(8, seed=4)
    jcfg, pcfg = _cfgs()
    e1 = Engine(config=pcfg, device="cpu").set_topology(pt).build()
    e1.run_rounds(40)
    ep = Engine(config=pcfg, mesh=_mesh(4), multichip="pod", device="cpu")
    ep.set_topology(pt).build().run_rounds(40)
    assert isinstance(ep._node_kernel, PodShardedFatTreeKernel)
    np.testing.assert_allclose(ep.estimates(), e1.estimates(), **TOL)
    assert len(ep.global_values()["last_avg"]) == pt.num_nodes
    want = []
    jk = JaxPodKernel(jt, jcfg, jax_make_mesh(4))
    jk.run_streamed(jk.init_state(), 40, 10, want.append)
    got = []
    es = Engine(config=pcfg, mesh=_mesh(4), multichip="pod", device="cpu")
    es.set_topology(pt).run_streamed(40, observe_every=10, emit=got.append)
    assert [m["t"] for m in got] == [m["t"] for m in want] == [10, 20, 30,
                                                                40]
    for g, w in zip(got, want):
        assert g["fired_total"] == w["fired_total"]
        for key in ("rmse", "max_abs_err", "mass"):
            assert abs(g[key] - w[key]) <= 1e-12 * max(1.0, abs(w[key]))


@pytest.mark.parametrize("halo,overlap", [("ppermute", False),
                                          ("allgather", False),
                                          ("overlap", True),
                                          ("overlap_pallas", True),
                                          ("auto", True)])
def test_engine_pod_halo_selects_the_overlap_schedule(halo, overlap):
    """halo in ('overlap', 'overlap_pallas', 'auto') takes the overlap
    schedule (JAX engine.py), with the same result."""
    pt = pgen.fat_tree(8, seed=3)
    ep = Engine(config=_cfgs()[1], mesh=_mesh(2), multichip="pod",
                halo=halo, device="cpu").set_topology(pt).build()
    assert ep._node_kernel.overlap is overlap
    ref = Engine(config=_cfgs()[1], mesh=_mesh(2), multichip="pod",
                 device="cpu").set_topology(pt).build()
    np.testing.assert_array_equal(ep.run_rounds(15).estimates(),
                                  ref.run_rounds(15).estimates())


def test_engine_pod_checkpoint_cross_mode(tmp_path):
    """pod save -> single-device restore, and the reverse: the archive is
    canonical (the flat structured layout)."""
    pt = pgen.fat_tree(8, seed=9)
    pcfg = _cfgs()[1]
    path = str(tmp_path / "pod.npz")
    ep = Engine(config=pcfg, mesh=_mesh(2), multichip="pod", device="cpu")
    ep.set_topology(pt).build().run_rounds(25)
    ep.save_checkpoint(path)
    e1 = Engine(config=pcfg, device="cpu").set_topology(pt)
    e1.restore_checkpoint(path)
    ref = Engine(config=pcfg, device="cpu").set_topology(pt).build()
    ref.run_rounds(25)
    np.testing.assert_allclose(e1.estimates(), ref.estimates(), **TOL)
    e1.run_rounds(25)
    ref.run_rounds(25)
    np.testing.assert_allclose(e1.estimates(), ref.estimates(), **TOL)
    path2 = str(tmp_path / "single.npz")
    ref.save_checkpoint(path2)
    ep2 = Engine(config=pcfg, mesh=_mesh(4), multichip="pod", device="cpu")
    ep2.set_topology(pt).restore_checkpoint(path2)
    np.testing.assert_allclose(ep2.estimates(), ref.estimates(), **TOL)
    assert ep2.clock == 50.0


def test_pod_archives_cross_to_jax_and_back(tmp_path):
    """The port's pod archive is read by JAX's unchanged load_checkpoint
    and JAX's pod engine continues it; JAX's pod archive resumes on the
    port's pod mesh (virtual tree, 4 shards)."""
    kw = dict(seed=6, materialize_edges=False)
    jt, pt = jgen.fat_tree(8, **kw), pgen.fat_tree(8, **kw)
    jcfg, pcfg = _cfgs()
    path = str(tmp_path / "port_pod.npz")
    ep = Engine(config=pcfg, mesh=_mesh(4), multichip="pod", device="cpu")
    ep.set_topology(pt).build().run_rounds(20).save_checkpoint(path)
    state, cfg, extra = jck.load_checkpoint(path, topo=jt)
    assert cfg.spmv == "structured" and extra["clock"] == 20.0
    je = JaxEngine(config=jcfg, mesh=jax_make_mesh(4), multichip="pod")
    je.set_topology(jt).restore_checkpoint(path)
    je.run_rounds(20)
    ep.run_rounds(20)
    np.testing.assert_allclose(ep.estimates(), je.estimates(), **TOL)
    jpath = str(tmp_path / "jax_pod.npz")
    je.save_checkpoint(jpath)
    back = Engine(config=pcfg, mesh=_mesh(2), multichip="pod",
                  device="cpu").set_topology(pt).restore_checkpoint(jpath)
    back.run_rounds(10)
    je.run_rounds(10)
    np.testing.assert_allclose(back.estimates(), je.estimates(), **TOL)


def test_engine_pod_mode_rejections():
    pt = pgen.fat_tree(8, seed=0)
    bad = RoundConfig.fast(variant="collectall", kernel="node", spmv="xla")
    with pytest.raises(ValueError, match="structured"):
        Engine(config=bad, mesh=_mesh(2), multichip="pod",
               device="cpu").set_topology(pt).build()
    with pytest.raises(ValueError, match="pod"):
        Engine(config=RoundConfig.fast(variant="collectall"), mesh=_mesh(2),
               multichip="pod", device="cpu").set_topology(pt).build()
    with pytest.raises(ValueError, match="divide"):
        Engine(config=_cfgs()[1], mesh=_mesh(3), multichip="pod",
               device="cpu").set_topology(pt).build()


def test_engine_pod_run_until_rmse():
    """run_until_rmse through the pod mode (host-chunked loop over
    kernel.run and estimates)."""
    pt = pgen.fat_tree(8, seed=7)
    ep = Engine(config=_cfgs()[1], mesh=_mesh(2), multichip="pod",
                device="cpu").set_topology(pt).build()
    report = ep.run_until_rmse(1e-6, chunk=32, max_rounds=2048)
    assert report["converged"] and report["rmse"] <= 1e-6


def test_cli_pod_matches_jax_library(capsys):
    """``run --multichip pod --shards 4 --spmv structured`` prints JAX's
    numbers for the same run of JAX's library pod engine (float32, as
    JAX's CLI runs)."""
    flags = ["--generator", "fat_tree:8", "--rounds", "60", "--kernel",
             "node", "--fire-policy", "every_round", "--spmv",
             "structured", "--shards", "4", "--multichip", "pod", "--halo",
             "overlap"]
    assert port_main(["run", "--device", "cpu", *flags]) == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    with jax.enable_x64(False):
        je = JaxEngine(config=JaxConfig.fast(kernel="node",
                                             spmv="structured"),
                       mesh=jax_make_mesh(4), multichip="pod",
                       halo="overlap")
        je.set_topology(jgen.fat_tree(8)).build().run_rounds(60)
        jr = je.convergence_report()
    assert rep["spmv"] == "structured" and rep["t"] == 60
    assert rep["nodes"] == 208 and rep["edges"] == 768
    for key in ("rmse", "max_abs_err", "mass_residual"):
        assert abs(rep[key] - jr[key]) <= 1e-6, key
    with pytest.raises(SystemExit, match="divide"):
        port_main(["run", "--device", "cpu", *flags[:-6], "--shards", "3",
                   "--multichip", "pod"])
