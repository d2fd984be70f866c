"""Port ``obs/spectral.py`` and ``obs/forecast.fit_log_decay`` vs the JAX
package's.

Closed forms (cycle ``C_n``: ``lambda2 = (1 + 2 cos(2 pi / n)) / 3``;
``K_n``: 0) and the JAX suite's fit and cache contracts
(``tests/test_forecast.py``), then both provenances against JAX's
``mixing_report`` on the same graphs at float64 within 1e-9.  The power
iteration stops where two successive estimates differ by less than
1e-9, so a port run may take one step more or less than JAX's where
that test sits at its threshold: the iteration counts may differ by
one, the gaps still agree within 1e-9.  One exception: on the banded
family the measured gap agrees within 1e-7.  The banded lanes and the
gather remainder add in torch's order where XLA adds in its own (the
node kernels' 1e-9 contract, ``tests/test_torch_sync.py``), so the
vectors differ by an ulp from the first step; the decay fit runs down to
spreads of 100 ulps, where that ulp is a 1% error, and the fitted slope
moves by 1e-8 (1.65e-8 on the ER graph, 4.9e-9 on the BA graph); the
edge family adds in JAX's order and agrees within 1e-9.
"""

import json
import math

import numpy as np
import pytest
import torch

import jax_native  # noqa: F401  (JAX's native library, whole)

from flow_updating_tpu.obs import health
from flow_updating_tpu.obs import spectral as jspectral
from flow_updating_tpu.plan import compile_topology as jax_compile
from flow_updating_tpu.topology import generators as jgen
from flow_updating_tpu_torch.obs.forecast import fit_log_decay
from flow_updating_tpu_torch.obs.spectral import (
    MIXING_CACHE_STATS,
    MIXING_VERSION,
    estimate_gap_measured,
    estimate_gap_structural,
    mixing_report,
    predicted_rounds_to_eps,
)
from flow_updating_tpu_torch.plan import compile_topology
from flow_updating_tpu_torch.topology import generators as pgen
from flow_updating_tpu_torch.topology.graph import topology_from_arrays

CPU = dict(device="cpu")


@pytest.fixture(autouse=True)
def _own_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("FLOW_UPDATING_AUTOTUNE_CACHE",
                       str(tmp_path / "autotune.json"))


def _bridge(j):
    return topology_from_arrays(j.num_nodes, j.src, j.dst, j.rev, j.out_deg,
                                j.row_start, j.edge_rank, j.delay, j.values)


# ---- closed forms (JAX tests/test_forecast.py) ----------------------------

def test_structural_gap_matches_cycle_closed_form():
    n = 24
    rec = estimate_gap_structural(pgen.ring(n, k=1), **CPU)
    lam_exact = (1.0 + 2.0 * math.cos(2.0 * math.pi / n)) / 3.0
    assert rec["provenance"] == "structural" and rec["family"] == "edge"
    assert abs(rec["lambda2"] - lam_exact) < 1e-5
    assert abs(rec["gap"] - (1.0 - lam_exact)) < 1e-5


def test_structural_gap_complete_graph_is_one():
    rec = estimate_gap_structural(pgen.complete(16), **CPU)
    assert rec["lambda2"] < 1e-6
    assert abs(rec["gap"] - 1.0) < 1e-6


def test_measured_gap_agrees_with_structural_on_cycle():
    topo = pgen.ring(24, k=1)
    st = estimate_gap_structural(topo, **CPU)
    me = estimate_gap_measured(topo, rounds=96, **CPU)
    assert me["provenance"] == "measured" and me["fit"] is not None
    ratio = max(st["gap"] / me["gap"], me["gap"] / st["gap"])
    assert ratio < health.MIXING_AGREE_FACTOR


def test_measured_gap_complete_graph_degenerates_to_open_gap():
    rec = estimate_gap_measured(pgen.complete(16), **CPU)
    assert rec["fit"] is None and rec["gap"] == 1.0


def test_predicted_rounds_closed_form():
    assert predicted_rounds_to_eps(0.5, 1e-6) == pytest.approx(
        math.log(1e6) / 0.5)
    assert predicted_rounds_to_eps(0.0, 1e-6) == float("inf")
    assert predicted_rounds_to_eps(0.5, 2.0) == 0.0


def test_fit_log_decay_recovers_exact_geometric_decay():
    rate = 0.8
    ts = list(range(1, 11))
    ys = [5.0 * rate ** t for t in ts]
    fit = fit_log_decay(ts, ys)
    assert fit["slope"] == pytest.approx(math.log(rate), abs=1e-12)
    assert fit["intercept"] == pytest.approx(math.log(5.0), abs=1e-9)
    assert fit["stderr"] == pytest.approx(0.0, abs=1e-9)
    assert fit["points"] == 10


def test_fit_log_decay_refuses_degenerate_inputs():
    assert fit_log_decay([1], [0.5]) is None            # one point
    assert fit_log_decay([1, 2], [0.0, -1.0]) is None   # no positive ys


def test_mixing_cache_round_trip_and_stale_reprobe(tmp_path):
    cache = tmp_path / "autotune.json"
    topo = pgen.ring(24, k=1)
    before = dict(MIXING_CACHE_STATS)
    rep = mixing_report(topo, eps=1e-6, **CPU)      # env-routed path
    assert rep["cache"]["path"] == str(cache)
    assert rep["cache"]["hit"] is False
    assert rep["cache"]["key"].startswith(
        f"{MIXING_VERSION}|cpu|cpu|torch{torch.__version__}|")
    again = mixing_report(topo, eps=1e-6, **CPU)
    assert again["cache"]["hit"] is True
    assert again["gap"] == rep["gap"]               # recompute nothing
    assert MIXING_CACHE_STATS["hits"] == before["hits"] + 1
    assert MIXING_CACHE_STATS["misses"] == before["misses"] + 1
    # a stale version never steers: the entry re-probes
    blob = json.loads(cache.read_text())
    key = rep["cache"]["key"]
    assert blob[key]["version"] == MIXING_VERSION
    blob[key]["version"] = "mixing-v0"
    blob[key]["structural"]["gap"] = 0.999          # poison: must not leak
    cache.write_text(json.dumps(blob))
    fresh = mixing_report(topo, eps=1e-6, **CPU)
    assert fresh["cache"]["hit"] is False
    assert fresh["gap"] == rep["gap"]
    assert mixing_report(topo, eps=1e-6, refresh=True,
                         **CPU)["cache"]["hit"] is False
    # another dtype is another record
    assert mixing_report(topo, eps=1e-6, dtype="float32",
                         **CPU)["cache"]["hit"] is False


# ---- both provenances against JAX -----------------------------------------

GRAPHS = {
    "ring": lambda g: g.ring(64, 2, seed=0),
    "er": lambda g: g.erdos_renyi(300, 6.0, seed=1),
    "ba": lambda g: g.barabasi_albert(300, 3, seed=2),
    "community": lambda g: g.community(320, c=4, k_in=8.0, k_out=0.4,
                                       seed=3),
    "fat_tree": lambda g: g.fat_tree(4, seed=0),
}


def _agree(got, want, measured_tol=1e-9):
    for prov, tol in (("structural", 1e-9), ("measured", measured_tol)):
        g, w = got[prov], want[prov]
        assert g["family"] == w["family"]
        assert abs(g["gap"] - w["gap"]) <= tol, prov
    assert abs(got["structural"]["iters"]
               - want["structural"]["iters"]) <= 1
    assert got["measured"]["rounds"] == want["measured"]["rounds"]
    assert got["provenance"] == want["provenance"]
    assert abs(got["gap"] - want["gap"]) <= measured_tol
    assert got["predicted_rounds"] == pytest.approx(
        want["predicted_rounds"], rel=1e-7)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_edge_family_matches_jax(name, tmp_path):
    jt = GRAPHS[name](jgen)
    want = jspectral.mixing_report(jt, cache_path=str(tmp_path / "j.json"))
    got = mixing_report(_bridge(jt), **CPU)
    _agree(got, want)


@pytest.mark.parametrize("name", ["ring", "er", "ba", "community"])
def test_banded_family_matches_jax(name, tmp_path):
    jt = GRAPHS[name](jgen)
    pt = _bridge(jt)
    want = jspectral.mixing_report(jt, plan=jax_compile(jt),
                                   cache_path=str(tmp_path / "j.json"))
    got = mixing_report(pt, plan=compile_topology(pt), **CPU)
    assert got["family"] == "banded"
    _agree(got, want, measured_tol=1e-7)


def test_cold_calls_are_bit_reproducible(tmp_path):
    """Two cold probes give the same gap bit for bit: the edge rows sum
    in a fixed order (no atomics)."""
    topo = pgen.barabasi_albert(400, 3, seed=5)
    a = mixing_report(topo, cache_path=str(tmp_path / "a.json"), **CPU)
    b = mixing_report(topo, cache_path=str(tmp_path / "b.json"), **CPU)
    assert not a["cache"]["hit"] and not b["cache"]["hit"]
    for prov in ("structural", "measured"):
        assert a[prov] == b[prov]


def test_foreign_plan_refused():
    plan = compile_topology(pgen.erdos_renyi(100, 5.0, seed=1))
    with pytest.raises(ValueError, match="different topology"):
        estimate_gap_structural(pgen.barabasi_albert(100, 3, seed=2),
                                plan=plan, **CPU)
    with pytest.raises(ValueError, match="materialize_edges"):
        estimate_gap_structural(pgen.fat_tree(8, materialize_edges=False),
                                **CPU)


def test_mixing_block_passes_jax_doctor():
    rep = mixing_report(pgen.community(200, c=4, k_in=6.0, k_out=0.5,
                                       seed=0), **CPU)
    (check,) = health.check_mixing(rep)
    assert check.status == health.PASS, check.summary
    assert 0.0 < rep["gap"] <= 1.0
    assert np.isfinite(rep["predicted_rounds"])
