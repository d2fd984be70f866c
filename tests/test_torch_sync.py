"""Port node-collapsed kernel, Engine and CLI vs the JAX package's.

The same topology and initial values go through the JAX ``NodeKernel``
and the port's ``NodeKernel(device='cpu')`` for each of the four neighbor
sums.  The tolerance is the JAX suite's node-kernel contract, 1e-9 at
float64 (``tests/test_sync.py::test_matches_edge_kernel``): the port adds
row sums in torch's order and rounds the ledger merge's products before
adding (XLA:CPU fuses them into multiply-adds), so the trajectories agree
to rounding, not bit for bit, on graphs with non-power-of-two degrees.
Within the port, 'banded_fused' equals 'banded' bit for bit
(``test_torch_fused_round.py``), and the Beneš routes equal the gather
(``test_torch_spmv_benes.py``).
"""

import json
import os

import numpy as np
import pytest
import torch

import jax_native  # noqa: F401  (JAX's native library, whole)

from flow_updating_tpu.engine import Engine as JaxEngine
from flow_updating_tpu.models import sync as jsync
from flow_updating_tpu.models.config import RoundConfig as JaxConfig
from flow_updating_tpu.topology import generators as jgen
from flow_updating_tpu_torch import Engine, NodeKernel, RoundConfig
from flow_updating_tpu_torch.cli import main as port_main
from flow_updating_tpu_torch.parallel.mesh import make_mesh
from flow_updating_tpu_torch.topology import generators as pgen
from flow_updating_tpu_torch.topology.graph import topology_from_arrays

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL6 = (os.path.join(ROOT, "examples/platforms/small6.xml"),
          os.path.join(ROOT, "examples/deployments/small6_actors.xml"))
SPMVS = ("xla", "pallas", "banded", "banded_fused", "benes", "benes_fused")
GRAPHS = {
    "ring": lambda g: g.ring(33, 2, seed=0),
    "er": lambda g: g.erdos_renyi(200, 6.0, seed=1),
    "ba": lambda g: g.barabasi_albert(300, 3, seed=2),
    "fat_tree": lambda g: g.fat_tree(4, seed=0),
}
TOL = dict(rtol=1e-9, atol=1e-9)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def _kernels(name, spmv, dtype="float64", values=None):
    jk = jsync.NodeKernel(GRAPHS[name](jgen),
                          JaxConfig.fast(kernel="node", spmv=spmv,
                                         dtype=dtype), values=values)
    pk = NodeKernel(GRAPHS[name](pgen),
                    RoundConfig.fast(kernel="node", spmv=spmv, dtype=dtype),
                    values=values, device="cpu")
    return jk, pk


@pytest.mark.parametrize("spmv", SPMVS)
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_node_kernel_matches_jax(name, spmv):
    jk, pk = _kernels(name, spmv)
    assert pk.padded_size == jk.padded_size
    js = jk.run(jk.init_state(), 40)
    ps = pk.run(pk.init_state(), 40)
    assert ps.t == int(js.t) == 40
    np.testing.assert_allclose(pk.estimates(ps), jk.estimates(js), **TOL)
    np.testing.assert_allclose(pk.last_avg(ps), jk.last_avg(js), **TOL)


@pytest.mark.parametrize("spmv", ["xla", "pallas"])
def test_float32_run_matches_jax(spmv):
    """The setting of the JAX float32 check ``test_pallas_spmv_matches_xla``
    (BA(400, 3), 30 rounds).  Across the two frameworks the row sums add
    in another order and the merge rounds its products: on the hubs
    (degree ~60, neighbor sums ~30) that is a few float32 ulps of the sum,
    so the bound is rtol=atol=3e-5 rather than the 1e-6 JAX holds two of
    its own lowerings to."""
    cfg = dict(kernel="node", spmv=spmv, dtype="float32")
    jk = jsync.NodeKernel(jgen.barabasi_albert(400, m=3, seed=8),
                          JaxConfig.fast(**cfg))
    pk = NodeKernel(pgen.barabasi_albert(400, m=3, seed=8),
                    RoundConfig.fast(**cfg), device="cpu")
    est = pk.estimates(pk.run(pk.init_state(), 30))
    assert est.dtype == np.float32
    np.testing.assert_allclose(est, jk.estimates(jk.run(jk.init_state(), 30)),
                               rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize("spmv", ["xla", "banded", "banded_fused"])
def test_vector_payload_matches_jax(spmv):
    vals = np.random.default_rng(3).uniform(0, 1, (200, 3))
    jk, pk = _kernels("er", spmv, values=vals)
    js = jk.run(jk.init_state(), 30)
    ps = pk.run(pk.init_state(), 30)
    got = pk.estimates(ps)
    assert got.shape == (200, 3)
    np.testing.assert_allclose(got, jk.estimates(js), **TOL)
    # each column tracks its own scalar run
    for d in range(3):
        _, pd = _kernels("er", spmv, values=vals[:, d].copy())
        col = pd.estimates(pd.run(pd.init_state(), 30))
        np.testing.assert_allclose(got[:, d], col, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("spmv", ["benes", "benes_fused"])
def test_vector_payload_refused_by_the_benes_routes(spmv):
    """The network packs scalar lanes; both packages refuse (N, D)."""
    vals = np.ones((200, 2))
    topo = GRAPHS["er"]
    with pytest.raises(ValueError, match="vector payloads"):
        NodeKernel(topo(pgen), RoundConfig.fast(kernel="node", spmv=spmv),
                   values=vals, device="cpu")
    with pytest.raises(ValueError, match="vector payloads"):
        jsync.NodeKernel(topo(jgen), JaxConfig.fast(kernel="node",
                                                    spmv=spmv), values=vals)


@pytest.mark.parametrize("spmv", SPMVS)
def test_state_carries_across_from_jax(spmv):
    """JAX runs r rounds, the port takes its state and topology leaves as
    numpy and runs r more; the result matches JAX run for 2r rounds."""
    jtopo = jgen.community(160, 4, seed=5)
    cfg = dict(kernel="node", spmv=spmv, dtype="float64")
    jk = jsync.NodeKernel(jtopo, JaxConfig.fast(**cfg))
    js = jk.run(jk.init_state(), 12)
    ptopo = topology_from_arrays(
        jtopo.num_nodes, jtopo.src, jtopo.dst, jtopo.rev, jtopo.out_deg,
        jtopo.row_start, jtopo.edge_rank, jtopo.delay, jtopo.values)
    pk = NodeKernel(ptopo, RoundConfig.fast(**cfg), device="cpu")
    leaves = {f: np.asarray(getattr(js, f))
              for f in ("t", "S", "G", "avg_prev", "A_prev")}
    ps = pk.run(pk.state_from_numpy(leaves), 12)
    js2 = jk.run(js, 12)
    assert ps.t == int(js2.t) == 24
    np.testing.assert_allclose(pk.estimates(ps), jk.estimates(js2), **TOL)
    with pytest.raises(ValueError, match="layout"):
        pk.state_from_numpy({**leaves, "S": leaves["S"][:-1]})


def test_engine_small6_matches_jax_convergence_report():
    def drive(make, **kw):
        seen = []
        e = make(config=kw.pop("cfg"), **kw)
        e.load_platform(SMALL6[0]).register_actor("peer")
        e.load_deployment(SMALL6[1])
        e.add_watcher(run_until=300, time_interval=10,
                      callback=lambda eng: seen.append(eng.clock))
        e.run_until(500)
        return e, seen

    jeng, jseen = drive(JaxEngine, cfg=JaxConfig.fast(kernel="node",
                                                      dtype="float64"))
    peng, pseen = drive(Engine, cfg=RoundConfig.fast(kernel="node",
                                                     dtype="float64"),
                        device="cpu")
    assert pseen == jseen and len(pseen) == 30
    assert peng.clock == jeng.clock == 500.0
    jrep, prep = jeng.convergence_report(), peng.convergence_report()
    assert prep.keys() == {"t", "rmse", "max_abs_err", "mass_residual"}
    assert prep["t"] == jrep["t"] == 300        # stopped at the deadline
    for key in ("rmse", "max_abs_err", "mass_residual"):
        assert abs(prep[key] - jrep[key]) <= 1e-9, key
    assert prep["rmse"] < 1e-6
    pg, jg = peng.global_values(), jeng.global_values()
    assert pg["value"] == jg["value"]
    assert pg["last_avg"].keys() == jg["last_avg"].keys()
    np.testing.assert_allclose(list(pg["last_avg"].values()),
                               list(jg["last_avg"].values()), **TOL)


def test_engine_until_rmse_and_stream():
    topo = pgen.erdos_renyi(128, 6.0, seed=7)
    e = Engine(config=RoundConfig.fast(kernel="node", spmv="banded"),
               device="cpu").set_topology(topo).build()
    out = e.run_until_rmse(1e-4, chunk=16)
    assert out["converged"] and out["rounds"] % 16 == 0
    samples = []
    e.run_streamed(20, observe_every=10, emit=samples.append)
    assert [s["t"] for s in samples] == [out["t"] + 10, out["t"] + 20]
    assert samples[-1]["fired_total"] == samples[-1]["t"] * 128


@pytest.mark.parametrize("spmv", SPMVS)
def test_cli_run_json_matches_jax(capsys, spmv):
    """The CLI runs float32.  For the Beneš routes the JAX report to hold
    the port to is its gather run: the network is pure data movement (the
    port's Beneš run equals its gather run bit for bit), while JAX's jitted
    float32 recurrence fuses the elementwise ops around the network
    differently from those around a gather and moves the statistics at the
    float32 noise floor (tests/test_pallas_fused.py::
    test_neighbor_sum_fused_matches_gather allows rtol=3e-5 for it)."""
    from flow_updating_tpu.cli import main as jax_main

    flags = ["--generator", "ring:64:2", "--rounds", "200", "--kernel",
             "node", "--fire-policy", "every_round", "--spmv", spmv]
    jax_spmv = "xla" if spmv.startswith("benes") else spmv
    assert jax_main(["run", "--backend", "cpu", *flags[:-1], jax_spmv]) == 0
    jrep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert port_main(["run", "--device", "cpu", *flags]) == 0
    prep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert prep["device"] == "cpu" and prep["spmv"] == spmv
    for key in ("t", "nodes", "edges", "variant", "fire_policy",
                "true_mean"):
        assert prep[key] == jrep[key], key
    for key in ("rmse", "max_abs_err", "mass_residual"):
        assert abs(prep[key] - jrep[key]) <= 1e-6, key


def test_cli_refuses_unported_flags(tmp_path, capsys):
    base = ["run", "--device", "cpu", "--generator", "ring:16",
            "--kernel", "node", "--fire-policy", "every_round"]
    # --profile DIR captures the run as a torch.profiler trace (ported in
    # A14 part 1)
    assert port_main([*base, "--rounds", "5", "--profile",
                      str(tmp_path / "prof")]) == 0
    capsys.readouterr()
    assert list((tmp_path / "prof").glob("*.pt.trace.json.gz"))
    # --shards runs the sharded banded and Beneš rounds (with --multichip
    # halo the edge kernel's halo round, with --multichip pod the pod
    # stencil, spmv='structured' only); GSPMD's 'xla' path exits
    with pytest.raises(SystemExit, match="requires spmv='structured'"):
        port_main([*base, "--shards", "2", "--multichip", "pod"])
    with pytest.raises(SystemExit, match="drives the edge kernel"):
        port_main([*base, "--shards", "2", "--multichip", "halo"])
    with pytest.raises(SystemExit, match="A12"):
        port_main([*base, "--shards", "2", "--spmv", "xla", "--rounds", "3"])
    # the edge kernel runs --contention (A3); a generator graph has no
    # link model, so it exits naming that, as the JAX CLI does
    with pytest.raises(SystemExit, match="link model"):
        port_main(["run", "--device", "cpu", "--generator", "ring:16",
                   "--contention"])
    with pytest.raises(SystemExit, match="invalid flag combination"):
        port_main([*base, "--drop-rate", "0.1"])


def test_unported_configs_raise_naming_their_item():
    topo = pgen.ring(16, seed=0)
    with pytest.raises(ValueError, match="structured"):   # no descriptor
        NodeKernel(pgen.erdos_renyi(16, 4.0, seed=0),
                   RoundConfig.fast(kernel="node", spmv="structured"),
                   device="cpu")
    for spmv in ("benes", "benes_fused", "structured"):   # ported
        k = NodeKernel(topo, RoundConfig.fast(kernel="node", spmv=spmv),
                       device="cpu")
        assert k.run(k.init_state(), 2).t == 2
    with pytest.raises(ValueError, match="node-collapsed|kernel"):
        NodeKernel(topo, RoundConfig.fast(drop_rate=0.1), device="cpu")
    with pytest.raises(ValueError, match="vector payloads"):
        NodeKernel(topo, RoundConfig.fast(kernel="node", spmv="pallas"),
                   values=np.ones((16, 2)), device="cpu")
    # Engine() builds the edge kernel, robust modes included (A3)
    assert Engine(device="cpu").config.kernel == "edge"
    clip = Engine(config=RoundConfig.fast(robust="clip", robust_clip=1.0),
                  device="cpu").set_topology(topo).build()
    clip.run_rounds(5)
    assert clip.state.flow.abs().max() <= 1.0
    node = RoundConfig.fast(kernel="node")
    # plan='auto' runs (A5); unknown plan modes are refused
    assert Engine(config=node, plan="auto", device="cpu").set_topology(
        topo).build().plan_decision.spmv == "structured"
    with pytest.raises(ValueError, match="plan mode"):
        Engine(config=node, plan="fastest", device="cpu")
    # a mesh runs spmv='banded_fused' and 'benes_fused', and the pod
    # stencil spmv='structured'; GSPMD's 'xla' path still raises, naming
    # multi-device execution; the halo round refuses the node kernel, as
    # in JAX
    mesh = make_mesh(2, device="cpu")
    with pytest.raises(NotImplementedError, match="multi-device.*A12"):
        Engine(config=node, mesh=mesh, device="cpu").set_topology(
            topo).build()
    with pytest.raises(ValueError, match="requires spmv='structured'"):
        Engine(config=node, mesh=mesh, multichip="pod",
               device="cpu").set_topology(topo).build()
    with pytest.raises(ValueError, match="drives the edge kernel"):
        Engine(config=node, mesh=mesh, multichip="halo",
               device="cpu").set_topology(topo).build()
    # host actors run (A8): the mode takes any callable, refuses a mesh
    assert Engine(config=node, host_actors=True,
                  device="cpu").register_actor("peer", fn=print).host_actors
    with pytest.raises(ValueError, match="host_actors"):
        Engine(config=node, host_actors=True, mesh=mesh, device="cpu")
    e = Engine(argv=["--cfg=spmv:banded"], config=node, device="cpu")
    assert e.config.spmv == "banded"
    # outside it a custom actor must be a VectorActor (A8)
    with pytest.raises(TypeError, match="VectorActor"):
        e.register_actor("peer", fn=print)
