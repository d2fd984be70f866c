"""``Engine(mesh=, multichip='halo')`` and ``run --multichip halo`` of the
port vs the JAX package's.

The port's engine runs on a host mesh (``make_mesh(4, device='cpu')``),
JAX's on ``make_mesh(4)`` of the suite's virtual CPU devices.  JAX's
``'ppermute'`` engine is the oracle for every port mode (its
``'overlap_pallas'`` stops at ``pltpu.TPUMemorySpace`` under the installed
jax, ROADMAP C): estimates within 1e-9 at float64, the tolerance of
``tests/test_parallel.py``, for both partitions.  ``halo='auto'`` records
JAX's decision (all but the backend name), the refusals are JAX's, and the
CLI report carries JAX's keys, held at the relative 1e-3 above 1e-7 of the
other CLI tests (float32).
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from flow_updating_tpu.cli import main as jax_main
from flow_updating_tpu.engine import Engine as JaxEngine
from flow_updating_tpu.models.config import RoundConfig as JaxConfig
from flow_updating_tpu.parallel.mesh import make_mesh as jax_make_mesh
from flow_updating_tpu.topology import generators as jgen
from flow_updating_tpu_torch import Engine, RoundConfig
from flow_updating_tpu_torch.cli import main as port_main
from flow_updating_tpu_torch.parallel.mesh import make_mesh
from flow_updating_tpu_torch.topology import generators as pgen

ROUNDS = 20
MODES = ("ppermute", "allgather", "overlap", "overlap_pallas", "auto")
CLI_RTOL, CLI_ATOL = 1e-3, 1e-7


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def graphs():
    return (jgen.erdos_renyi(96, avg_degree=5.0, seed=3),
            pgen.erdos_renyi(96, avg_degree=5.0, seed=3))


def _port_engine(topo, cfg, halo, partition="bfs", seed=0):
    e = Engine(config=cfg, mesh=make_mesh(4, device="cpu"),
               multichip="halo", halo=halo, partition=partition,
               device="cpu")
    return e.set_topology(topo).build(seed=seed)


@pytest.mark.parametrize("partition", ["bfs", "contiguous"])
@pytest.mark.parametrize("maker", ["fast", "reference"])
def test_engine_halo_matches_jax_engine(graphs, partition, maker):
    jt, pt = graphs
    extra = dict(delay_depth=2) if maker == "reference" else {}
    jcfg = getattr(JaxConfig, maker)(dtype="float64", **extra)
    cfg = getattr(RoundConfig, maker)(dtype="float64", **extra)
    je = JaxEngine(config=jcfg, mesh=jax_make_mesh(4), multichip="halo",
                   halo="ppermute", partition=partition)
    je.set_topology(jt).build().run_rounds(ROUNDS)
    want = je.estimates()
    jrep = je.convergence_report()
    ests = {}
    for halo in MODES:
        e = _port_engine(pt, cfg, halo, partition).run_rounds(ROUNDS)
        ests[halo] = e.estimates()
        np.testing.assert_allclose(ests[halo], want, rtol=0, atol=1e-9)
        rep = e.convergence_report()
        assert rep["t"] == jrep["t"] == ROUNDS
        for key in ("rmse", "max_abs_err", "mass_residual",
                    "antisymmetry_residual"):
            assert abs(rep[key] - jrep[key]) <= 1e-9, key
        assert e.halo_report()["partition"] == partition
    for halo in MODES[1:]:
        np.testing.assert_array_equal(ests[halo], ests["ppermute"])


def test_engine_halo_fast_pairwise_and_global_values(graphs):
    jt, pt = graphs
    jcfg = JaxConfig.fast("pairwise", dtype="float64")
    cfg = RoundConfig.fast("pairwise", dtype="float64")
    je = JaxEngine(config=jcfg, mesh=jax_make_mesh(4), multichip="halo")
    je.set_topology(jt).build().run_rounds(ROUNDS)
    for halo in ("ppermute", "overlap_pallas"):
        e = _port_engine(pt, cfg, halo).run_rounds(ROUNDS)
        np.testing.assert_allclose(e.estimates(), je.estimates(), rtol=0,
                                   atol=1e-9)
        pv, jv = e.global_values(), je.global_values()
        assert pv["value"] == jv["value"]
        np.testing.assert_allclose(list(pv["last_avg"].values()),
                                   list(jv["last_avg"].values()), rtol=0,
                                   atol=1e-9)
    run = e.run_until_rmse(1e-6, max_rounds=3000, chunk=100)
    assert run["converged"] and run["t"] == ROUNDS + run["rounds"]


def test_halo_auto_records_jax_decision(graphs):
    jt, pt = graphs
    for dtype, size in (("float32", 4), ("float64", 8)):
        for partition in ("bfs", "contiguous"):
            je = JaxEngine(config=JaxConfig.fast(dtype=dtype),
                           mesh=jax_make_mesh(4), multichip="halo",
                           halo="auto", partition=partition)
            je.set_topology(jt).build()
            e = _port_engine(pt, RoundConfig.fast(dtype=dtype), "auto",
                             partition)
            jrep, rep = je.halo_report(), e.halo_report()
            assert rep["decision"].pop("backend") == "cpu"
            jrep["decision"].pop("backend")
            assert rep == jrep
            assert rep["resolved"] == rep["decision"]["halo"]
            assert e._ledger_dtype_bytes == size


def test_engine_halo_refusals(graphs, tmp_path):
    _, pt = graphs
    mesh = make_mesh(4, device="cpu")
    node = RoundConfig.fast(kernel="node", spmv="banded_fused")
    with pytest.raises(ValueError, match="drives the edge kernel"):
        Engine(config=node, mesh=mesh, multichip="halo",
               device="cpu").set_topology(pt).build()
    e = Engine(mesh=mesh, multichip="halo", device="cpu").set_topology(pt)
    with pytest.raises(NotImplementedError, match="latency-warped"):
        e.build(latency_scale=1.0)
    with pytest.raises(ValueError, match="unknown halo"):
        Engine(multichip="halo", halo="interior", device="cpu")
    with pytest.raises(ValueError, match="unknown partition"):
        Engine(mesh=mesh, multichip="halo", partition="metis",
               device="cpu").set_topology(pt).build()
    with pytest.raises(ValueError, match="pod.*drives the node kernel"):
        Engine(mesh=mesh, multichip="pod",
               device="cpu").set_topology(pt).build()
    with pytest.raises(NotImplementedError, match="A12"):
        Engine(config=RoundConfig.fast(kernel="node"), mesh=mesh,
               device="cpu").set_topology(pt).build()
    built = _port_engine(pt, RoundConfig.fast(), "overlap")
    # faults stay refused on the blocked layout, as in JAX; checkpoints
    # gather to the canonical layout and restore
    for call in (lambda: built.kill_nodes([0]),
                 lambda: built.fail_links([(0, 1)])):
        with pytest.raises(NotImplementedError, match="halo kernel"):
            call()
    path = str(tmp_path / "halo.npz")
    built.run_rounds(3).save_checkpoint(path)
    again = Engine(mesh=mesh, multichip="halo", device="cpu")
    assert again.set_topology(pt).restore_checkpoint(path).clock == 3.0
    with pytest.raises(NotImplementedError, match="A9"):
        built.run_streamed(10, observe_every=5)
    # a halo engine without a mesh is the single-device edge kernel, as
    # in JAX; the node kernel's mesh path ignores the partition
    assert Engine(multichip="halo", device="cpu").set_topology(
        pt).build().halo_report() is None
    k = Engine(config=RoundConfig.fast(kernel="node", spmv="banded_fused"),
               mesh=mesh, partition="contiguous", device="cpu")
    k.set_topology(pgen.ring(64, 2)).build().run_rounds(5)
    assert k.convergence_report()["t"] == 5


def _cli_report(capsys, main, argv):
    assert main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("halo,partition", [("ppermute", "bfs"),
                                            ("overlap_pallas", "contiguous")])
def test_cli_halo_matches_jax(capsys, halo, partition):
    flags = ["--generator", "erdos_renyi:200", "--rounds", "60",
             "--shards", "4", "--multichip", "halo", "--halo", halo,
             "--partition", partition, "--drop-rate", "0.1"]
    with jax.enable_x64(False):
        jrep = _cli_report(capsys, jax_main, [
            "run", "--backend", "cpu", *[f if f != "overlap_pallas"
                                         else "overlap" for f in flags]])
    prep = _cli_report(capsys, port_main, ["run", "--device", "cpu",
                                           *flags])
    assert set(jrep) <= set(prep)
    for key in ("t", "nodes", "edges", "variant", "fire_policy",
                "true_mean"):
        assert prep[key] == jrep[key], key
    for key in ("rmse", "max_abs_err", "mass_residual",
                "antisymmetry_residual"):
        assert abs(prep[key] - jrep[key]) <= CLI_ATOL + CLI_RTOL * abs(
            jrep[key]), key
    assert prep["halo"]["requested"] == halo
    assert prep["halo"]["partition"] == partition
    with pytest.raises(SystemExit, match="needs --shards"):
        port_main(["run", "--device", "cpu", "--generator", "ring:16",
                   "--multichip", "halo"])
    with pytest.raises(SystemExit, match="pod.*drives the node kernel"):
        port_main(["run", "--device", "cpu", "--generator", "ring:16",
                   "--shards", "2", "--multichip", "pod"])


def test_halo_state_is_per_shard_on_the_mesh(graphs):
    _, pt = graphs
    cfg = dataclasses.replace(RoundConfig.reference(dtype="float64"),
                              drop_rate=0.1)
    e = _port_engine(pt, cfg, "overlap", seed=5).run_rounds(7)
    assert len(e.state.shards) == 4
    assert all(s.flow.device.type == "cpu" for s in e.state.shards)
    assert e.state.t == 7
    leaves = e.state.numpy()
    assert leaves["flow"].shape == (4, e._halo_plan.Eb)
    assert leaves["key"].dtype == np.uint32
