"""Cost attribution (``obs/profile.py``, ``utils/cost.py``,
``Engine.profile``) against the JAX package's ``tests/test_profile.py``.

The contract under test:

* every kernel the port dispatches — edge, node (every ``spmv``), halo
  (every exchange), pod, the sharded banded and Beneš rounds — gives a
  record with the JAX package's keys (``cost``, ``memory``, ``timings``,
  ``compile_cache``, ``mode``, ``rounds``, ``per_round``, ``topology``,
  ``config``, ``halo``, ``overlap``), the same ``mode``, ``topology`` and
  ``config`` values as JAX's on the same engine, positive counted bytes
  and flops (``cost.method == 'counted'``);
* profiling is a pure observer: the state is ``torch.equal`` before and
  after, and the next run equals an unprofiled one;
* repeated profiles of one program hit the count cache; ``n <= 0`` and a
  custom actor are refused as in JAX;
* the ``profile`` CLI writes JAX's manifest shape, both doctors give one
  verdict on it, ``regress`` of it against itself exits 0, and without
  ``--device cpu`` on a host without a card it refuses to run;
* the sweep's per-bucket records carry JAX's keys;
* the count: a K1 round on a ring worked out by hand; every hand kernel's
  wrapper declares its work, and on the CPU each wrapper call (its plain
  version) counts exactly its declaration — nothing of its body;
* ``probe='aot'`` ranks by the counted bytes; where its pick differs
  from JAX's (XLA's cost analysis of fused programs) the case is named.
"""

import json

import pytest
import torch

import jax_native  # noqa: F401  (JAX's native library, whole)

from flow_updating_tpu.cli import main as jax_main
from flow_updating_tpu.engine import Engine as JaxEngine
from flow_updating_tpu.models.config import RoundConfig as JaxConfig
from flow_updating_tpu.parallel.mesh import make_mesh as jax_mesh
from flow_updating_tpu.plan import select as jselect
from flow_updating_tpu.topology import generators as jgen
from flow_updating_tpu_torch import Engine, RoundConfig
from flow_updating_tpu_torch.cli import main as port_main
from flow_updating_tpu_torch.models.actor import push_sum_actor
from flow_updating_tpu_torch.obs import profile as pprof
from flow_updating_tpu_torch.obs.report import PROFILE_SCHEMA
from flow_updating_tpu_torch.parallel.mesh import make_mesh
from flow_updating_tpu_torch.plan import select
from flow_updating_tpu_torch.topology import generators as pgen
from flow_updating_tpu_torch.utils import cost

from test_torch_plan_select import IRREGULAR, _bridge, _cfgs


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _own_caches(tmp_path, monkeypatch):
    monkeypatch.setenv("FLOW_UPDATING_AUTOTUNE_CACHE",
                       str(tmp_path / "autotune.json"))
    monkeypatch.setenv("FLOW_UPDATING_ROOFLINE_CACHE",
                       str(tmp_path / "roofline_cpu.json"))
    pprof.reset_cache()


def _last_json(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


# ---- the engines: the JAX suite's four modes, and every route of the port --

def _jax_engine(mode: str):
    if mode == "edge":
        return JaxEngine(config=JaxConfig.reference(dtype="float64")) \
            .set_topology(jgen.ring(32, k=2, seed=0))
    if mode == "node":
        return JaxEngine(config=JaxConfig.fast(kernel="node",
                                               dtype="float64")) \
            .set_topology(jgen.ring(32, k=2, seed=0))
    mesh = jax_mesh(2)
    if mode == "halo":
        return JaxEngine(config=JaxConfig.fast(dtype="float64"), mesh=mesh,
                         multichip="halo") \
            .set_topology(jgen.erdos_renyi(48, avg_degree=4.0, seed=3))
    return JaxEngine(config=JaxConfig.fast(kernel="node", spmv="structured",
                                           dtype="float64"),
                     mesh=mesh, multichip="pod") \
        .set_topology(jgen.fat_tree(4, seed=0))


def _port_engine(mode: str):
    """A CPU engine of ``mode``: JAX's four (``edge``, ``node``, ``halo``,
    ``pod``) and every other route the port dispatches."""
    ring32 = pgen.ring(32, k=2, seed=0)
    er48 = pgen.erdos_renyi(48, avg_degree=4.0, seed=3)
    if mode == "edge":
        return Engine(config=RoundConfig.reference(dtype="float64"),
                      device="cpu").set_topology(ring32)
    if mode == "edge/benes_fused":
        return Engine(config=RoundConfig.reference(
            "collectall", segment_impl="benes_fused",
            delivery="benes_fused"), device="cpu") \
            .set_topology(pgen.fat_tree(4, seed=0))
    if mode == "node":
        return Engine(config=RoundConfig.fast(kernel="node",
                                              dtype="float64"),
                      device="cpu").set_topology(ring32)
    if mode.startswith("node/"):
        spmv = mode.split("/")[1]
        topo = pgen.fat_tree(4, seed=0) if spmv == "structured" \
            else pgen.ring(600, k=2, seed=0)
        return Engine(config=RoundConfig.fast(kernel="node", spmv=spmv,
                                              dtype="float64"),
                      device="cpu").set_topology(topo)
    if mode.startswith("sharded/"):
        spmv = mode.split("/")[1]
        return Engine(config=RoundConfig.fast(kernel="node", spmv=spmv,
                                              dtype="float64"),
                      mesh=make_mesh(4, device="cpu"), halo="overlap",
                      device="cpu").set_topology(pgen.ring(4096, k=2,
                                                           seed=0))
    if mode == "pod":
        return Engine(config=RoundConfig.fast(kernel="node",
                                              spmv="structured",
                                              dtype="float64"),
                      mesh=make_mesh(2, device="cpu"), multichip="pod",
                      device="cpu").set_topology(pgen.fat_tree(4, seed=0))
    halo = "ppermute" if mode == "halo" else mode.split("/")[1]
    return Engine(config=RoundConfig.fast(dtype="float64"),
                  mesh=make_mesh(2, device="cpu"), multichip="halo",
                  halo=halo, device="cpu").set_topology(er48)


PORT_MODES = ["edge", "edge/benes_fused", "node", "node/pallas",
              "node/banded", "node/banded_fused", "node/benes",
              "node/benes_fused", "node/structured", "sharded/banded_fused",
              "sharded/benes_fused", "pod", "halo", "halo/allgather",
              "halo/overlap", "halo/overlap_pallas"]


def _states_equal(a, b) -> bool:
    ta, tb = pprof._tensors(a), pprof._tensors(b)
    return (getattr(a, "t", None) == getattr(b, "t", None)
            and len(ta) == len(tb)
            and all(torch.equal(x, y) for x, y in zip(ta, tb)))


@pytest.mark.parametrize("mode", ["edge", "node", "halo", "pod"])
def test_profile_attribution_all_modes(mode):
    """JAX's keys and values on the same engine: every key of JAX's
    record (and of its cost, timings and compile-cache blocks) is there,
    ``mode``, ``rounds``, ``topology`` and ``config`` equal; counted bytes
    and flops positive; a pure observer."""
    jrec = _jax_engine(mode).build().profile(6)
    e = _port_engine(mode).build()
    before = pprof._clone(e.state)
    rec = e.profile(6)
    assert set(jrec) <= set(rec)
    for block in ("cost", "timings", "compile_cache"):
        assert set(jrec[block]) <= set(rec[block]), block
    for key in ("mode", "rounds", "topology", "config"):
        assert rec[key] == jrec[key], key
    assert rec["cost"]["method"] == "counted"
    assert rec["cost"]["counted_rounds"] == 6
    assert rec["cost"]["flops"] > 0 and rec["cost"]["bytes_accessed"] > 0
    assert rec["memory"] == {"available": False,
                             "note": rec["memory"]["note"]}
    assert rec["device_memory_stats"] is None
    assert rec["timings"]["execute_s"] > 0
    assert rec["per_round"]["flops"] == pytest.approx(
        rec["cost"]["flops"] / 6)
    assert _states_equal(e.state, before)
    assert e.clock == 0.0
    json.dumps(rec)


@pytest.mark.parametrize("mode", PORT_MODES)
def test_profile_is_a_pure_observer_on_every_route(mode):
    """Every route: the state ``torch.equal`` before and after, the next
    run equal to an unprofiled engine's, the kernels' declared work in
    the record, and the halo round's overlap block on overlap modes."""
    e1 = _port_engine(mode).build()
    before = pprof._clone(e1.state)
    rec = e1.profile(3, roofline=True)
    assert _states_equal(e1.state, before)
    assert rec["cost"]["bytes_accessed"] > 0
    assert rec["roofline"]["mode"].split("@")[0].split("/")[0] \
        == rec["mode"]
    if mode.startswith("halo/overlap"):
        ov = rec["overlap"]
        assert ov["mode"] == mode.split("/")[1]
        assert set(ov["execute_s"]) == {"ppermute", ov["mode"], "interior"}
    e1.run_rounds(20)
    e2 = _port_engine(mode).build()
    e2.run_rounds(20)
    assert _states_equal(e1.state, e2.state)
    declared = {"node/pallas": {"K1"}, "node/banded_fused": {"K2"},
                "node/benes_fused": {"B3.local"},
                "sharded/banded_fused": {"B5.merge"},
                "sharded/benes_fused": {"B3.local"},
                "halo/overlap_pallas": {"B6.fused"},
                "edge/benes_fused": {"B3.local", "B4.scan", "B4.fill"}}
    assert set(rec["cost"]["kernels"]) >= declared.get(mode, set())
    json.dumps(rec)


def test_profile_count_cache_hits():
    e = _port_engine("node").build()
    first = e.profile(5)
    again = e.profile(5)
    assert not first["compile_cache"]["cache_hit"]
    assert again["compile_cache"]["cache_hit"]
    assert again["compile_cache"]["hits"] >= 1
    # the count is reused, the execution re-timed
    assert again["cost"] == first["cost"]
    assert again["timings"]["compile_s"] == first["timings"]["compile_s"]
    other = e.profile(7)  # a different round count = another program
    assert not other["compile_cache"]["cache_hit"]


def test_profile_count_cache_misses_a_freed_graphs_twin():
    """Two graphs of one shape (32 nodes, 128 directed edges) whose K1
    work differs, profiled one after the other with the first engine
    freed: the second is counted anew (a freed table's reused id finds
    no entry) and its declared K1 work is its own."""
    import gc

    import numpy as np

    from flow_updating_tpu_torch.topology.graph import build_topology

    i = np.arange(32, dtype=np.int64)
    ring1 = np.stack([i, (i + 1) % 32], axis=1)
    hub = np.array([(0, j) for j in range(2, 31)]
                   + [(1, 3), (1, 4), (1, 5)], dtype=np.int64)
    values = np.random.default_rng(1).uniform(0.0, 1.0, 32)
    cfg = RoundConfig.fast(kernel="node", spmv="pallas", dtype="float64")

    def profile_of(topo):
        e = Engine(config=cfg, device="cpu").set_topology(topo).build()
        return e.profile(3, execute=False)

    first = profile_of(pgen.ring(32, k=2, seed=0))
    gc.collect()
    skewed = build_topology(32, np.concatenate([ring1, hub]), values=values,
                            seed=0, warn_asymmetric=False)
    assert skewed.num_edges == 128
    second = profile_of(skewed)
    assert not second["compile_cache"]["cache_hit"]
    assert second["cost"]["kernels"]["K1"] != first["cost"]["kernels"]["K1"]
    assert second["cost"]["bytes_accessed"] != first["cost"][
        "bytes_accessed"]


def test_profile_count_cache_keeps_no_kernel_alive():
    """A sharded kernel's round program is its bound ``run``: the cache
    entry refers to the kernel weakly, so a freed engine's kernel and
    tables are freed, and its entry is dropped at the next profile."""
    import gc
    import weakref

    e = _port_engine("pod").build()
    fn, _, _ = e._node_kernel.round_program(e.state, 3)
    assert fn.__self__ is e._node_kernel
    e.profile(3, execute=False)
    assert len(pprof._COUNTED) == 1
    kernel = weakref.ref(e._node_kernel)
    del e, fn
    gc.collect()
    assert kernel() is None
    _port_engine("node").build().profile(3, execute=False)
    assert len(pprof._COUNTED) == 1


def test_profile_rejects_nonpositive_rounds_and_custom_actors():
    e = _port_engine("edge")
    with pytest.raises(ValueError, match="positive"):
        e.profile(0)
    actor = Engine(device="cpu").set_topology(pgen.ring(16, k=2, seed=0))
    actor.register_actor("p", push_sum_actor()).build()
    with pytest.raises(NotImplementedError, match="VectorActor"):
        actor.profile(4)


# ---- the CLI -----------------------------------------------------------------

def test_profile_cli_writes_jax_manifest(tmp_path, capsys):
    out, jout = tmp_path / "prof.json", tmp_path / "jprof.json"
    argv = ["profile", "--generator", "ring:24:2", "--rounds", "8"]
    assert jax_main([*argv, "--backend", "cpu", "--report", str(jout)]) == 0
    jline = _last_json(capsys)
    assert port_main([*argv, "--device", "cpu", "--report", str(out)]) == 0
    line = _last_json(capsys)
    doc, jdoc = json.loads(out.read_text()), json.loads(jout.read_text())
    assert doc["schema"] == jdoc["schema"] == PROFILE_SCHEMA
    assert set(doc) == set(jdoc)
    assert set(jdoc["profile"]) <= set(doc["profile"])
    assert doc["profile"]["cost"]["flops"] > 0
    assert doc["topology"]["num_nodes"] == 24
    assert doc["topology"] == jdoc["topology"]
    assert doc["environment"]["python"]
    assert line["report_path"] == str(out)
    assert line["mode"] == jline["mode"] == "edge"


def test_profile_cli_no_execute(capsys):
    rc = port_main(["profile", "--device", "cpu", "--generator",
                    "ring:16:2", "--rounds", "4", "--kernel", "node",
                    "--fire-policy", "every_round", "--no-execute"])
    assert rc == 0
    line = _last_json(capsys)
    assert line["timings"]["execute_s"] is None
    assert line["cost"]["flops"] > 0


def test_profile_cli_acceptance_doctors_and_regress(tmp_path, capsys):
    """The acceptance commands: ``profile --generator fat_tree:8 --rounds
    16 --roofline --report P --device cpu`` exits 0 with JAX's schema,
    both doctors give the same verdict on P, ``regress --fresh P
    --against P`` exits 0; without ``--device cpu`` (no card here) it
    refuses to run."""
    import jax

    p = tmp_path / "p.json"
    assert port_main(["profile", "--generator", "fat_tree:8", "--rounds",
                      "16", "--roofline", "--report", str(p), "--device",
                      "cpu"]) == 0
    capsys.readouterr()
    doc = json.loads(p.read_text())
    assert doc["schema"] == PROFILE_SCHEMA
    assert doc["perf_lens"]["schema"] == "flow-updating-perf-lens/v1"
    rc_p = port_main(["doctor", str(p)])
    port_verdict = _last_json(capsys)
    with jax.enable_x64(False):
        rc_j = jax_main(["doctor", str(p)])
    jax_verdict = _last_json(capsys)
    assert (rc_p, port_verdict) == (rc_j, jax_verdict)
    names = {c["name"] for c in port_verdict["checks"]}
    assert {"roofline_sane", "roofline_floor"} <= names
    assert port_main(["regress", "--fresh", str(p), "--against",
                      str(p)]) == 0
    assert _last_json(capsys)["overall"] == "pass"
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="--device cpu"):
            port_main(["profile", "--generator", "fat_tree:8", "--rounds",
                       "16", "--roofline", "--report", str(p)])


# ---- the sweep ---------------------------------------------------------------

def test_sweep_attaches_per_bucket_attribution():
    from flow_updating_tpu.sweep import grid_instances as jgrid
    from flow_updating_tpu.sweep import run_sweep as jrun
    from flow_updating_tpu_torch.sweep import grid_instances, run_sweep

    _, jsum = jrun(jgrid([("ring:16:2", jgen.ring(16, k=2, seed=0))],
                         seeds=[0, 1]),
                   JaxConfig.reference(dtype="float64"), 20, profile=True)
    insts = grid_instances([("ring:16:2", pgen.ring(16, k=2, seed=0))],
                           seeds=[0, 1])
    _, summary = run_sweep(insts, RoundConfig.reference(dtype="float64"),
                           20, profile=True, device="cpu")
    assert len(summary["buckets"]) == len(jsum["buckets"]) == 1
    b, jb = summary["buckets"][0], jsum["buckets"][0]
    assert set(jb) <= set(b) and set(jb["profile"]) <= set(b["profile"])
    prof = b["profile"]
    assert prof["cost"]["flops"] > 0 and prof["cost"]["counted_rounds"] == 20
    # attribution counts, never re-runs the sweep for time
    assert prof["timings"]["execute_s"] is None
    json.dumps(summary)


# ---- the count -----------------------------------------------------------------

def test_k1_round_counted_by_hand():
    """One node round through K1 on ``ring(8, 1)`` in float64: every node
    has degree 2, one ELL bucket of width 2 whose rows pad to 256
    (``BLOCK_ROWS``), so M = 256 slots, 16 real neighbor indices.

    K1 declares x read once (256 x 8 B), the index matrix once (512 x
    4 B), every row written once (256 x 8 B): 6,144 bytes; one add per
    real index: 16 flops.  Around it, 11 elementwise ops on (256,)
    float64 vectors (2,048 B each): avg = (value - S + A_prev) * inv —
    sub, add, mul; S' = -G - A + deg * avg_prev — neg, sub, mul, add;
    G' = -S - deg * avg + A_prev — neg, mul, sub, add.  The nine binary
    ops move 3 vectors each, the two negations 2: 9 x 3 + 2 x 2 = 31
    vectors = 63,488 bytes, and 11 x 256 = 2,816 flops."""
    from flow_updating_tpu_torch.models.sync import NodeKernel

    k = NodeKernel(pgen.ring(8, k=1, seed=0),
                   RoundConfig.fast(kernel="node", spmv="pallas",
                                    dtype="float64"), device="cpu")
    (m,) = k.arrays.mats
    assert tuple(m.shape) == (256, 2) and k.padded_size == 256
    assert int((m < 256).sum()) == 16
    st = k.init_state()
    with cost.count() as c:
        k.run(st, 1)
    assert c.kernels == {"K1": {"calls": 1, "bytes": 6144, "flops": 16}}
    assert (c.ops, c.bytes, c.flops) == (11, 31 * 2048, 11 * 256)
    assert c.total_bytes == 6144 + 63488


def test_every_kernel_wrapper_declares_its_work():
    counters = pprof.launch_counters()
    assert set(counters) == {"K1", "K2", "B3.local", "B3.window",
                             "B3.wide", "B3.wide2", "B4.scan", "B4.fill",
                             "B5.fire", "B5.merge", "B6.pull", "B6.fused"}
    for name, wrapper in counters.items():
        assert wrapper.declared_cost == name
        assert callable(wrapper.cost) and hasattr(wrapper, "launches")


#: engines whose rounds reach every declaring wrapper between them
_KERNEL_ENGINES = {
    "K1": lambda: _port_engine("node/pallas"),
    "K2": lambda: _port_engine("node/banded_fused"),
    "B3": lambda: _port_engine("node/benes_fused"),
    "B3+B4": lambda: _port_engine("edge/benes_fused"),
    "B5": lambda: _port_engine("sharded/banded_fused"),
    "B6.fused": lambda: Engine(
        config=RoundConfig.reference("collectall"),
        mesh=make_mesh(4, device="cpu"), multichip="halo",
        halo="overlap_pallas", device="cpu")
    .set_topology(pgen.fat_tree(4, seed=0)),
    "B6.pull": lambda: Engine(
        config=RoundConfig.fast("pairwise"), mesh=make_mesh(4, device="cpu"),
        multichip="halo", halo="overlap_pallas", device="cpu")
    .set_topology(pgen.fat_tree(4, seed=0)),
}


@pytest.mark.parametrize("which", sorted(_KERNEL_ENGINES))
def test_plain_versions_count_their_declaration(which, monkeypatch):
    """On the CPU a wrapper runs its kernel's plain version; under a count
    it adds exactly its declared bytes and flops and tallies none of the
    plain version's ops (no double counting).  The calls are the ones a
    real round makes, caught at the wrappers."""
    calls = []
    for name, wrapper in pprof.launch_counters().items():
        def spy(*args, _w=wrapper, _f=wrapper.cost, **kwargs):
            got = _f(*args, **kwargs)
            calls.append((_w, args, kwargs, got))
            return got
        monkeypatch.setattr(wrapper, "cost", spy)
    e = _KERNEL_ENGINES[which]().build()
    fn, args, nd = e.round_program(2)
    with cost.count():
        fn(*pprof._clone(tuple(args[:nd])), *args[nd:])
    assert calls
    seen = set()
    for wrapper, args, kwargs, (nbytes, flops) in calls[:40]:
        with cost.count() as c:
            wrapper(*args, **kwargs)
        assert c.ops == 0 and c.by_op == {}
        assert c.kernels == {wrapper.declared_cost: {
            "calls": 1, "bytes": nbytes, "flops": flops}}
        assert nbytes > 0
        seen.add(wrapper.declared_cost)
    want = {"K1": {"K1"}, "K2": {"K2"}, "B3": {"B3.local"},
            "B3+B4": {"B3.local", "B4.scan", "B4.fill"},
            "B5": {"B5.merge"}, "B6.fused": {"B6.fused"},
            "B6.pull": {"B6.pull"}}[which]
    assert want <= {w.declared_cost for w, *_ in calls}
    assert seen


@pytest.mark.parametrize("exchange", ["ppermute", "pallas"])
def test_b5_merge_declarations_sum_to_the_kernel_tables_bound(exchange):
    """B5's merge launches of one shard-round declare, between them,
    exactly :func:`sharded_round_min_bytes` — the kernel table's bound —
    however the rows are split: the offsets and the halos once."""
    from flow_updating_tpu_torch.ops import sharded_round as sr

    e = _port_engine("sharded/banded_fused").build()
    spec = e._node_kernel.spec
    S = torch.zeros(spec.local, dtype=torch.float64)
    before, after = sr.row_ranges(spec, exchange)
    launches = [(r, None) for r in before]
    launches.append((after[0], after[1] if len(after) > 1 else None))
    assert len(launches) == sr.launches_per_shard_round(spec, exchange)
    total = sum(sr.sharded_round.cost(S, *[None] * 8, spec, *rows, None,
                                      fire=None, rows2=rows2)[0]
                for rows, rows2 in launches)
    assert total == sr.sharded_round_min_bytes(spec, dtype_bytes=8)
    rec = e.profile(3, execute=False)
    assert rec["cost"]["kernels"]["B5.merge"]["bytes"] == \
        3 * spec.num_shards * sr.sharded_round_min_bytes(spec, dtype_bytes=8)


# ---- probe='aot' -----------------------------------------------------------------

#: graphs on which the port's probe='aot' pick differs from JAX's, and why:
#: on a path the band lanes are XLA-fused into one loop in JAX (its banded
#: program counts 17,572 bytes against the gather's 19,268), while the
#: port's banded executor runs each lane as its own torch ops, each read
#: and written (45,392 counted bytes against the gather's 42,208)
AOT_PICKS_DIFFER = {"path": (("node", "banded"), ("node", "xla"))}


@pytest.mark.parametrize("name", sorted(IRREGULAR))
def test_aot_probe_against_jax(name):
    jcfg, pcfg = _cfgs()
    jt = IRREGULAR[name]()
    jd = jselect.select_plan(jt, jcfg, backend="cpu", probe="aot",
                             autotune=False)
    pd = select.select_plan(_bridge(jt), pcfg, backend="cpu", probe="aot",
                            autotune=False, device="cpu")
    assert set(pd.predicted) == set(jd.predicted)
    cands = ("node/banded", "node/banded_fused", "node/xla", "edge/gather")
    assert all(0 < pd.predicted[c] < float("inf") for c in cands)
    picks = ((jd.kernel, jd.spmv), (pd.kernel, pd.spmv))
    if name in AOT_PICKS_DIFFER:
        assert picks == AOT_PICKS_DIFFER[name]
    else:
        assert picks[0] == picks[1]


def test_aot_probe_raises_when_a_kernel_fails(monkeypatch):
    """A kernel that fails to build, load or launch inside a candidate's
    program raises out of ``probe='aot'``: node/banded_fused does not lose
    quietly to a plain candidate.  Only a candidate's ``ValueError`` (a
    graph it does not take) ranks it last."""
    from flow_updating_tpu_torch.kernels import KernelError
    from flow_updating_tpu_torch.models import sync

    def broken(*args, **kwargs):
        raise KernelError("fused_round: CUDA launch failed with "
                          "cudaError_t 1")

    monkeypatch.setattr(sync, "fused_banded_round", broken)
    _, pcfg = _cfgs()
    with pytest.raises(KernelError, match="fused_round"):
        select.select_plan(_bridge(IRREGULAR["er"]()), pcfg, backend="cpu",
                           probe="aot", autotune=False, device="cpu")


@pytest.mark.parametrize("fault", ["kernel", "lens"])
def test_autotune_lens_passes_kernel_faults_on(monkeypatch, fault):
    """The autotune record's roofline annotation contains a failure of
    its own (``roofline_error``, the probe record kept), but a kernel
    that fails to launch in the counted rounds raises."""
    from flow_updating_tpu_torch.kernels import KernelError

    class Kernel:
        def init_state(self):
            return torch.zeros(4, dtype=torch.float32)

        def round_program(self, state, n):
            return (self.run, (state, n), 1)

        def run(self, state, n):
            if fault == "kernel":
                raise KernelError("fused_round: CUDA launch failed")
            return state + 1

    monkeypatch.setenv("FLOW_UPDATING_ROOFLINE", "1")
    if fault == "lens":
        def no_model(device):
            raise RuntimeError("no calibration")
        monkeypatch.setattr("flow_updating_tpu_torch.obs.roofline."
                            "resolve_model", no_model)
    entry = {}
    args = (entry, {"node/banded_fused": 1e3},
            {"node/banded_fused": Kernel}, "cpu")
    if fault == "kernel":
        with pytest.raises(KernelError, match="fused_round"):
            select._annotate_roofline(*args)
    else:
        select._annotate_roofline(*args)
        assert entry["roofline_error"] == "RuntimeError: no calibration"


def test_aot_probe_ranks_a_refusing_candidate_last(monkeypatch):
    """A candidate whose program refuses the graph with ``ValueError``
    ranks last with its error recorded, and the probe picks another."""
    from flow_updating_tpu_torch.models import sync

    def refuses(*args, **kwargs):
        raise ValueError("fused round: band too wide for one tile")

    monkeypatch.setattr(sync, "fused_banded_round", refuses)
    _, pcfg = _cfgs()
    d = select.select_plan(_bridge(IRREGULAR["er"]()), pcfg, backend="cpu",
                           probe="aot", autotune=False, device="cpu")
    assert d.predicted["node/banded_fused"] == float("inf")
    assert d.predicted["node/banded_fused#error"].startswith("ValueError")
    assert (d.kernel, d.spmv) != ("node", "banded_fused")


def test_actor_sum_to_dst_goes_through_k1_on_every_device():
    """Repair: ``TopoView.sum_to_dst`` took K1's wrapper only on the card
    and called the plain neighbor sum directly on the CPU, so a cost count
    of a custom actor's round read differently by device.  An ``(E,)``
    float leaf now goes through the wrapper everywhere (its plain version
    on the CPU): the count declares K1 and the sum is unchanged."""
    from flow_updating_tpu_torch.ops.spmv import neighbor_sum

    e = Engine(device="cpu").set_topology(pgen.ring(16, k=2, seed=0))
    e.register_actor("p", push_sum_actor()).build()
    view = e._node_kernel.view
    x = torch.arange(e.topology.num_edges, dtype=torch.float64)
    with cost.count() as c:
        got = view.sum_to_dst(x)
    assert c.kernels["K1"]["calls"] == 1 and c.ops > 0
    want = neighbor_sum(x, view.ell)[view.ell_inv]
    assert torch.equal(got, want)
