"""The derived aggregates of the port (``flow_updating_tpu_torch.models.
aggregates``) against the JAX package's ``models/aggregates.py``.

Counterparts of ``tests/test_robustness.py``'s aggregate cases, with the
same bounds, plus the JAX package's own results on the same seeded
graphs: COUNT and SUM within rel 1e-4 of JAX's float32 node round (two
float32 runs whose sums add in other orders; rel 1e-9 at float64), MIN
and MAX bit for bit (propagation copies values), the weighted mean, the
faithful edge round's count, the disconnected graph, and the refusals.
"""

import numpy as np
import pytest
import torch

from flow_updating_tpu.models import aggregates as jagg
from flow_updating_tpu.models.config import RoundConfig as JaxConfig
from flow_updating_tpu.topology import generators as jgen
from flow_updating_tpu.topology.graph import build_topology as jax_build
from flow_updating_tpu_torch import (
    RoundConfig,
    build_topology,
    estimate_count,
    estimate_max,
    estimate_min,
    estimate_sum,
    estimate_weighted_mean,
)
from flow_updating_tpu_torch.topology import generators as pgen


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def _er():
    return (pgen.erdos_renyi(256, avg_degree=8.0, seed=4),
            jgen.erdos_renyi(256, avg_degree=8.0, seed=4))


def _disconnected(build):
    pairs = [(0, 1), (1, 2), (2, 0), (3, 4), (4, 5), (5, 3)]
    vals = np.array([3.0, 6.0, 9.0, 10.0, 20.0, 30.0, 99.0])
    return build(7, pairs, values=vals, warn_asymmetric=False)


def test_count_and_sum_aggregates():
    topo, jtopo = _er()
    n_est = estimate_count(topo, rounds=400, device="cpu")
    np.testing.assert_allclose(n_est, 256.0, rtol=1e-3)
    np.testing.assert_allclose(n_est, jagg.estimate_count(jtopo, rounds=400),
                               rtol=1e-4)
    s_est = estimate_sum(topo, rounds=400, device="cpu")
    np.testing.assert_allclose(s_est, topo.values.sum(), rtol=1e-3)
    np.testing.assert_allclose(s_est, jagg.estimate_sum(jtopo, rounds=400),
                               rtol=1e-4)


@pytest.mark.parametrize("spmv", ["xla", "pallas", "banded"])
def test_count_and_sum_float64_equal_jax(spmv):
    topo, jtopo = _er()
    kw = dict(variant="collectall", kernel="node", dtype="float64")
    cfg = RoundConfig.fast(spmv=spmv, **kw)
    jcfg = JaxConfig.fast(spmv="xla", **kw)
    np.testing.assert_allclose(
        estimate_count(topo, cfg, rounds=300, root=5, device="cpu"),
        jagg.estimate_count(jtopo, jcfg, rounds=300, root=5), rtol=1e-9)
    np.testing.assert_allclose(
        estimate_sum(topo, cfg, rounds=300, device="cpu"),
        jagg.estimate_sum(jtopo, jcfg, rounds=300), rtol=1e-9)


def test_min_max_aggregates():
    topo, jtopo = _er()
    lo = estimate_min(topo, device="cpu")
    hi = estimate_max(topo, device="cpu")
    np.testing.assert_array_equal(
        lo, np.full(256, topo.values.astype(lo.dtype).min()))
    np.testing.assert_array_equal(
        hi, np.full(256, topo.values.astype(hi.dtype).max()))
    np.testing.assert_array_equal(lo, jagg.estimate_min(jtopo))
    np.testing.assert_array_equal(hi, jagg.estimate_max(jtopo))


def test_min_max_disconnected_components():
    topo = _disconnected(build_topology)
    jtopo = _disconnected(jax_build)
    lo, hi = estimate_min(topo, device="cpu"), estimate_max(topo,
                                                            device="cpu")
    np.testing.assert_array_equal(
        lo, np.float32([3.0, 3.0, 3.0, 10.0, 10.0, 10.0, 99.0]))
    np.testing.assert_array_equal(
        hi, np.float32([9.0, 9.0, 9.0, 30.0, 30.0, 30.0, 99.0]))
    np.testing.assert_array_equal(lo, jagg.estimate_min(jtopo))
    np.testing.assert_array_equal(hi, jagg.estimate_max(jtopo))


def test_extrema_stop_at_the_fixed_point(monkeypatch):
    """The loop ends at the first round that changes nothing: on a ring
    of 64 the farthest node is 32 hops away, so 33 rounds reduce."""
    calls = []
    real = torch.segment_reduce

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(torch, "segment_reduce", counting)
    topo = pgen.ring(64, 1, seed=2)
    hi = estimate_max(topo, device="cpu")
    assert (hi == topo.values.max()).all()
    assert len(calls) == 33


def test_count_aggregate_on_faithful_kernel():
    topo = pgen.erdos_renyi(64, avg_degree=6.0, seed=1)
    jtopo = jgen.erdos_renyi(64, avg_degree=6.0, seed=1)
    kw = dict(variant="collectall", delay_depth=2, dtype="float64")
    n_est = estimate_count(topo, cfg=RoundConfig.reference(**kw),
                           rounds=1500, device="cpu")
    np.testing.assert_allclose(n_est, 64.0, rtol=1e-4)
    np.testing.assert_allclose(
        n_est, jagg.estimate_count(jtopo, cfg=JaxConfig.reference(**kw),
                                   rounds=1500), rtol=1e-9)


def test_weighted_mean_aggregate():
    rng = np.random.default_rng(3)
    topo, jtopo = pgen.ring(48, 2, seed=3), jgen.ring(48, 2, seed=3)
    w = rng.uniform(0.0, 2.0, 48)
    w[:5] = 0.0
    got = estimate_weighted_mean(topo, w, rounds=500, device="cpu")
    expect = float((topo.values * w).sum() / w.sum())
    np.testing.assert_allclose(got, expect, rtol=1e-4)
    np.testing.assert_allclose(
        got, jagg.estimate_weighted_mean(jtopo, w, rounds=500), rtol=1e-5)
    with pytest.raises(ValueError, match="non-negative"):
        estimate_weighted_mean(topo, -w, device="cpu")
    with pytest.raises(ValueError, match="non-negative"):
        estimate_weighted_mean(topo, np.where(w == 0, np.nan, w),
                               device="cpu")
    with pytest.raises(ValueError, match="shape"):
        estimate_weighted_mean(topo, w[:10], device="cpu")


def test_extrema_refuse_a_virtual_topology():
    with pytest.raises(ValueError, match="materialize_edges"):
        estimate_min(pgen.fat_tree(4, materialize_edges=False),
                     device="cpu")


def test_aggregates_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    topo, _ = _er()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        estimate_min(topo)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        estimate_count(topo, rounds=10)
