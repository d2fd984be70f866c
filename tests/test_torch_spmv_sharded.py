"""The node round with a Beneš network per shard
(``parallel/spmv_sharded.py``, ``Engine(mesh=..., spmv='benes_fused')``)
against the JAX package's.

The cases are JAX ``tests/test_spmv_sharded.py``'s at 3 and 4 shards on
the port's host mesh: the sharded round against JAX's single-device
gather round at float64 within 1e-12 (JAX holds its own to 1e-9) and
against the port's single-device ``benes_fused`` round bit for bit (the
network only moves data, and each row sums the same values over the same
width).  The planner's sections equal JAX's stage for stage; the layout,
the checkpoint round trip (crossing to JAX's sharded kernel and back) and
the refusal to restore without the mesh are JAX's; the CLI's report is
held to JAX's library run.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from flow_updating_tpu.engine import Engine as JaxEngine
from flow_updating_tpu.models import sync as jsync
from flow_updating_tpu.models.config import RoundConfig as JaxConfig
from flow_updating_tpu.ops import spmv_benes as jsb
from flow_updating_tpu.parallel.mesh import make_mesh as jax_make_mesh
from flow_updating_tpu.parallel.spmv_sharded import (
    ShardedNodeKernel as JaxShardedNodeKernel,
)
from flow_updating_tpu.topology import generators as jgen
from flow_updating_tpu_torch import Engine, NodeKernel, RoundConfig
from flow_updating_tpu_torch.cli import main as port_main
from flow_updating_tpu_torch.ops import spmv_benes as psb
from flow_updating_tpu_torch.parallel.mesh import make_mesh
from flow_updating_tpu_torch.parallel.spmv_sharded import (
    ShardedNodeKernel,
    plan_sharded_spmv,
)
from flow_updating_tpu_torch.topology import generators as pgen

# the suite's 8 virtual JAX devices, started while pytest collects
jax.devices()

TOL = dict(rtol=1e-12, atol=1e-12)
GRAPHS = {
    "er": lambda g: g.erdos_renyi(600, avg_degree=6.0, seed=5),
    "ba": lambda g: g.barabasi_albert(500, m=3, seed=6),
    "fat_tree": lambda g: g.fat_tree(8, seed=0),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def _cfgs(dtype="float64", **kw):
    kw = dict(kernel="node", spmv="benes_fused", dtype=dtype, **kw)
    return JaxConfig.fast(**kw), RoundConfig.fast(**kw)


def _mesh(n):
    return make_mesh(n, device="cpu")


@pytest.mark.parametrize("shards", [3, 4])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_sharded_matches_single_device(name, shards):
    jt, pt = GRAPHS[name](jgen), GRAPHS[name](pgen)
    jcfg, pcfg = _cfgs()
    ks = ShardedNodeKernel(pt, pcfg, _mesh(shards))
    out_s = ks.run(ks.init_state(), 20)
    assert out_s.t == 20
    jx = jsync.NodeKernel(jt, dataclasses.replace(jcfg, spmv="xla"))
    out_x = jx.run(jx.init_state(), 20)
    np.testing.assert_allclose(ks.estimates(out_s), jx.estimates(out_x),
                               **TOL)
    np.testing.assert_allclose(ks.last_avg(out_s), jx.last_avg(out_x), **TOL)
    k1 = NodeKernel(pt, pcfg, device="cpu")
    out_1 = k1.run(k1.init_state(), 20)
    np.testing.assert_array_equal(ks.estimates(out_s), k1.estimates(out_1))
    np.testing.assert_array_equal(ks.last_avg(out_s), k1.last_avg(out_1))


def test_odd_shard_count():
    """3 shards: row counts pad to multiples of 3, the skeletons still
    align; the layout is JAX's (padded size, local rows)."""
    jt = jgen.erdos_renyi(300, avg_degree=5.0, seed=12)
    pt = pgen.erdos_renyi(300, avg_degree=5.0, seed=12)
    jcfg, pcfg = _cfgs()
    ks = ShardedNodeKernel(pt, pcfg, _mesh(3))
    jk = JaxShardedNodeKernel(jt, jcfg, jax_make_mesh(3))
    assert ks.padded_size == jk.padded_size
    assert ks.state_shape == tuple(jk.init_state().S.shape)
    assert ks.local_shapes == tuple(jk._plan.bucket_shapes)
    out_s = ks.run(ks.init_state(), 15)
    np.testing.assert_allclose(ks.estimates(out_s),
                               jk.estimates(jk.run(jk.init_state(), 15)),
                               **TOL)


def test_planner_sections_equal_jax():
    """plan_sections (with min_width) and pad_roll_section give JAX's
    stages, stage for stage; every shard of the sharded plan shares one
    pass skeleton."""
    pt = pgen.erdos_renyi(200, avg_degree=4.0, seed=3)
    jt = jgen.erdos_renyi(200, avg_degree=4.0, seed=3)
    base_p = NodeKernel(pt, RoundConfig.fast(kernel="node"), row_multiple=4,
                        device="cpu")
    base_j = jsync.NodeKernel(jt, JaxConfig.fast(kernel="node"),
                              row_multiple=4)
    mats = tuple(m.numpy() for m in base_p.arrays.mats)
    for mp, mj in zip(mats, base_j.arrays.mats):
        np.testing.assert_array_equal(mp, np.asarray(mj))
    m1 = base_p.padded_size + 1
    for s in range(4):
        mine = tuple(np.ascontiguousarray(m[s::4]) for m in mats)
        got = psb.plan_sections(mine, m1, min_width=1 << 12)
        want = jsb.plan_sections(mine, m1, min_width=1 << 12)
        assert got[3] == want[3] == 1 << 12
        kmax = got[3].bit_length() - 1
        for i, dists in ((0, tuple(1 << k for k in range(kmax - 1, -1, -1))),
                         (1, tuple(1 << k for k in range(kmax)))):
            a = psb.pad_roll_section(got[i], dists)
            b = jsb.pad_roll_section(want[i], dists)
            assert a.dists == b.dists == dists
            for x, y in zip(a.masks, b.masks):
                np.testing.assert_array_equal(x, y)
        for x, y in zip(got[2].masks, want[2].masks):
            np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError, match="subsequence"):
        psb.pad_roll_section(got[0], (1,))
    fused, planes, local = plan_sharded_spmv(mats, m1, 4)
    assert all(p.shape == (4, fused.P) for p in planes)
    assert local == tuple((m.shape[0] // 4, m.shape[1]) for m in mats)


def test_sharded_converges_to_mean():
    pt = pgen.erdos_renyi(400, avg_degree=8.0, seed=9)
    k = ShardedNodeKernel(pt, _cfgs("float32")[1], _mesh(4))
    est = k.estimates(k.run(k.init_state(), 200))
    np.testing.assert_allclose(est, pt.true_mean, atol=1e-3)


def test_node_kernel_mesh_guard_points_here():
    topo = pgen.ring(64, k=2, seed=0)
    with pytest.raises(ValueError, match="ShardedNodeKernel"):
        NodeKernel(topo, _cfgs("float32")[1], mesh=_mesh(2), device="cpu")
    with pytest.raises(ValueError, match="benes_fused"):
        ShardedNodeKernel(topo, RoundConfig.fast(kernel="node"), _mesh(2))
    with pytest.raises(TypeError, match="make_mesh"):
        ShardedNodeKernel(topo, _cfgs()[1], object())


def test_engine_dispatch_and_streamed_payload():
    """Engine(mesh=, spmv='benes_fused') builds the sharded kernel; its
    streamed samples are JAX's sharded kernel's."""
    jt, pt = GRAPHS["ba"](jgen), GRAPHS["ba"](pgen)
    jcfg, pcfg = _cfgs()
    want = []
    jk = JaxShardedNodeKernel(jt, jcfg, jax_make_mesh(4))
    jk.run_streamed(jk.init_state(), 20, 10, want.append)
    e = Engine(config=pcfg, mesh=_mesh(4), device="cpu").set_topology(pt)
    got = []
    e.run_streamed(20, observe_every=10, emit=got.append)
    assert isinstance(e._node_kernel, ShardedNodeKernel)
    assert [m["t"] for m in got] == [m["t"] for m in want] == [10, 20]
    for g, w in zip(got, want):
        assert g["fired_total"] == w["fired_total"]
        for key in ("rmse", "max_abs_err", "mass"):
            assert abs(g[key] - w[key]) <= 1e-12 * max(1.0, abs(w[key]))
    rep = e.convergence_report()
    assert rep["t"] == 20 and np.isfinite(rep["rmse"])
    assert len(e.global_values()["last_avg"]) == pt.num_nodes


def test_sharded_checkpoint_roundtrip(tmp_path):
    """Engine save/restore through the sharded kernel: the (S, M/S)
    interleaved state round-trips and resumes identically."""
    pt = pgen.erdos_renyi(300, avg_degree=5.0, seed=21)
    pcfg = _cfgs()[1]
    e1 = Engine(config=pcfg, mesh=_mesh(4), device="cpu").set_topology(pt)
    e1.build().run_rounds(30)
    ck = str(tmp_path / "sharded.npz")
    e1.save_checkpoint(ck)
    e1.run_rounds(20)
    e2 = Engine(config=pcfg, mesh=_mesh(4), device="cpu").set_topology(pt)
    e2.restore_checkpoint(ck)
    e2.run_rounds(20)
    np.testing.assert_array_equal(e2.estimates(), e1.estimates())


def test_sharded_archives_cross_to_jax_and_back(tmp_path):
    """The port's (S, M/S) archive resumes in JAX's sharded engine, and
    JAX's in the port's: the layouts are one."""
    jt = jgen.erdos_renyi(300, avg_degree=5.0, seed=21)
    pt = pgen.erdos_renyi(300, avg_degree=5.0, seed=21)
    jcfg, pcfg = _cfgs()
    path = str(tmp_path / "port.npz")
    pe = Engine(config=pcfg, mesh=_mesh(4), device="cpu").set_topology(pt)
    pe.build().run_rounds(12).save_checkpoint(path)
    je = JaxEngine(config=jcfg, mesh=jax_make_mesh(4)).set_topology(jt)
    je.restore_checkpoint(path)
    je.run_rounds(8)
    pe.run_rounds(8)
    np.testing.assert_allclose(pe.estimates(), je.estimates(), **TOL)
    jpath = str(tmp_path / "jax.npz")
    je.save_checkpoint(jpath)
    back = Engine(config=pcfg, mesh=_mesh(4), device="cpu").set_topology(pt)
    back.restore_checkpoint(jpath)
    back.run_rounds(6)
    je.run_rounds(6)
    np.testing.assert_allclose(back.estimates(), je.estimates(), **TOL)


def test_sharded_checkpoint_rejected_without_mesh(tmp_path):
    """A mesh-less engine refuses the sharded archive (the interleaved
    layout is not interchangeable)."""
    pt = pgen.erdos_renyi(300, avg_degree=5.0, seed=21)
    pcfg = _cfgs()[1]
    e1 = Engine(config=pcfg, mesh=_mesh(4), device="cpu").set_topology(pt)
    e1.build().run_rounds(5)
    ck = str(tmp_path / "sharded.npz")
    e1.save_checkpoint(ck)
    e2 = Engine(config=pcfg, device="cpu").set_topology(pt)
    with pytest.raises(ValueError, match="interchangeable|node axis"):
        e2.restore_checkpoint(ck)


def test_cli_sharded_benes_matches_jax_library(capsys):
    """``run --shards 4 --spmv benes_fused`` prints the port's library
    numbers exactly and JAX's library numbers for the same run (float32,
    as JAX's CLI runs): rmse and max_abs_err within 1e-6; the mass
    residual, a difference of two float32 sums of 400 values, within 64
    float32 ulps of the mass (JAX's doctor's bound)."""
    flags = ["--generator", "erdos_renyi:400", "--rounds", "80", "--kernel",
             "node", "--fire-policy", "every_round", "--spmv", "benes_fused",
             "--shards", "4"]
    assert port_main(["run", "--device", "cpu", *flags]) == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    topo = pgen.erdos_renyi(400)
    lib = Engine(config=_cfgs("float32")[1], mesh=_mesh(4), device="cpu")
    lib.set_topology(topo).build().run_rounds(80)
    assert lib.convergence_report() == {k: rep[k] for k in (
        "t", "rmse", "max_abs_err", "mass_residual")}
    with jax.enable_x64(False):
        je = JaxEngine(config=JaxConfig.fast(kernel="node", spmv="xla"))
        je.set_topology(jgen.erdos_renyi(400)).build().run_rounds(80)
        jr = je.convergence_report()
    assert rep["spmv"] == "benes_fused" and rep["t"] == 80
    for key in ("rmse", "max_abs_err"):
        assert abs(rep[key] - jr[key]) <= 1e-6, key
    mass_ulps = 64 * np.finfo(np.float32).eps * np.abs(topo.values).sum()
    assert abs(rep["mass_residual"] - jr["mass_residual"]) <= mass_ulps
