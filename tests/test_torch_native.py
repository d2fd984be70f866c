"""The port's native host runtime against the JAX package's.

Both packages compile their own copy of the C++ runtime; from the same
inputs they must route the same Beneš masks and build the same graphs,
bit for bit.  The generator cases sit just above the JAX package's native
thresholds (Barabási–Albert above 10,000 nodes, Erdős–Rényi from 100,000,
the builder from two million declared pairs), where the port used to take
its numpy paths and build different graphs.
"""

import numpy as np
import pytest
import torch

from flow_updating_tpu import native as jnative
from flow_updating_tpu.ops import permute as jpermute
from flow_updating_tpu.topology import generators as jgen
from flow_updating_tpu.topology.graph import build_topology as jbuild
from flow_updating_tpu_torch import native
from flow_updating_tpu_torch.ops import permute as ppermute
from flow_updating_tpu_torch.topology import generators as pgen
from flow_updating_tpu_torch.topology.graph import build_topology

FIELDS = ("src", "dst", "rev", "out_deg", "row_start", "edge_rank", "values")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def _assert_same_graph(p, j):
    assert p.num_nodes == j.num_nodes and p.num_edges == j.num_edges
    for field in FIELDS:
        np.testing.assert_array_equal(getattr(p, field), getattr(j, field),
                                      err_msg=field)


@pytest.mark.parametrize("log2n", [14, 15, 16])
def test_router_matches_jax_native_and_numpy_recursion(log2n):
    perm = np.random.default_rng(log2n).permutation(1 << log2n)
    got = native.benes_route(perm)
    want = jnative.benes_route(perm)
    assert len(got) == len(want) == 2 * log2n - 1
    rec = ppermute.benes_route_numpy(perm)
    for a, b, c in zip(got, want, rec):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_benes_plan_native_route_equals_jax_plan():
    perm = np.random.default_rng(7).permutation(1 << 14)
    p, j = ppermute.benes_plan(perm), jpermute.benes_plan(perm)
    assert p.dists == j.dists and p.kinds == j.kinds
    for a, b in zip(p.masks, j.masks):
        np.testing.assert_array_equal(a, b)


def test_router_rejects_bad_input():
    with pytest.raises(ValueError, match="power-of-two"):
        native.benes_route(np.arange(6))
    with pytest.raises(ValueError, match="not a permutation"):
        native.benes_route(np.zeros(8, np.int64))


def test_barabasi_albert_above_threshold_equals_jax():
    _assert_same_graph(pgen.barabasi_albert(20_000, 4, seed=3),
                       jgen.barabasi_albert(20_000, 4, seed=3))


def test_erdos_renyi_at_threshold_equals_jax():
    _assert_same_graph(pgen.erdos_renyi(100_000, 8, seed=1),
                       jgen.erdos_renyi(100_000, 8, seed=1))


def test_native_generator_pairs_equal_jax():
    np.testing.assert_array_equal(
        native.gen_barabasi_albert_pairs(500, 3, seed=7),
        jnative.gen_barabasi_albert_pairs(500, 3, seed=7))
    np.testing.assert_array_equal(
        native.gen_erdos_renyi_pairs(300, 900, seed=2),
        jnative.gen_erdos_renyi_pairs(300, 900, seed=2))


def test_big_builder_equals_jax():
    """Two million declared pairs take the C++ builder in both packages;
    it agrees with the numpy path on the same pairs too."""
    rng = np.random.default_rng(5)
    n = 300_000
    pairs = rng.integers(0, n, size=(2_000_000, 2), dtype=np.int64)
    p = build_topology(n, pairs, seed=4, warn_asymmetric=False)
    j = jbuild(n, pairs, seed=4, warn_asymmetric=False)
    _assert_same_graph(p, j)
    assert p.adopted is None        # the native path reports no adoptions
    numpy_path = build_topology(n, pairs, seed=4, warn_asymmetric=True)
    for field in FIELDS:
        np.testing.assert_array_equal(getattr(p, field),
                                      getattr(numpy_path, field))


def test_big_builder_range_checks_before_the_call():
    pairs = np.zeros((2_000_000, 2), np.int64)
    pairs[-1] = (0, 10)
    with pytest.raises(ValueError, match="out of range"):
        build_topology(10, pairs, warn_asymmetric=False)


def test_failed_build_raises(monkeypatch, tmp_path):
    """No compiler means no native runtime, loudly: the numpy paths would
    build a different graph."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native.shutil, "which", lambda _name: None)
    with pytest.raises(native.NativeError, match="g\\+\\+ not found"):
        native.get_lib()
    with pytest.raises(native.NativeError):
        pgen.barabasi_albert(10_001, 2, seed=0)
