"""Port topology layer vs the JAX package's: exactly equal arrays.

The generators, the symmetrizing builder, the degree-bucketed ELL layout
and the XML loaders of ``flow_updating_tpu_torch.topology`` are numpy
copies of the JAX package's; on the same inputs every array must be
identical (the JAX package's native C++ paths only take over above 10k
nodes for Barabási–Albert, 100k for Erdős–Rényi and two million pairs,
all outside these sizes).
"""

import os

import numpy as np
import pytest
import torch

from flow_updating_tpu.topology import generators as jgen
from flow_updating_tpu.topology.deployment import (
    load_deployment as jload_deployment,
)
from flow_updating_tpu.topology.graph import build_topology as jbuild
from flow_updating_tpu.topology.platform import (
    load_platform as jload_platform,
    parse_value as jparse_value,
)
from flow_updating_tpu_torch.topology import generators as pgen
from flow_updating_tpu_torch.topology.deployment import load_deployment
from flow_updating_tpu_torch.topology.graph import (
    _symmetrize,
    build_topology,
    topology_from_arrays,
)
from flow_updating_tpu_torch.topology.platform import (
    load_platform,
    parse_value,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL6 = (os.path.join(ROOT, "examples/platforms/small6.xml"),
          os.path.join(ROOT, "examples/deployments/small6_actors.xml"))

GENERATORS = {
    "ring": ("ring", (33, 2)),
    "ring_k1": ("ring", (40,)),
    "grid2d": ("grid2d", (5, 7)),
    "torus2d": ("torus2d", (4, 6)),
    "hypercube": ("hypercube", (5,)),
    "complete": ("complete", (9,)),
    "fat_tree": ("fat_tree", (8,)),
    "community": ("community", (200, 4)),
    "barabasi_albert": ("barabasi_albert", (300, 3)),
    "erdos_renyi": ("erdos_renyi", (500,)),
}

EDGE_FIELDS = ("src", "dst", "rev", "out_deg", "row_start", "edge_rank",
               "delay", "values", "adopted")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def _assert_same_topology(p, j):
    assert p.num_nodes == j.num_nodes
    for name in EDGE_FIELDS:
        a, b = getattr(p, name), getattr(j, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
    assert p.true_mean == j.true_mean
    assert p.names == j.names


@pytest.mark.parametrize("key", sorted(GENERATORS))
def test_generator_arrays_equal(key):
    name, params = GENERATORS[key]
    p = getattr(pgen, name)(*params, seed=3)
    j = getattr(jgen, name)(*params, seed=3)
    _assert_same_topology(p, j)
    for field in ("membership", "bridge_edges"):
        a, b = getattr(p, field), getattr(j, field)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("key", ["ring", "fat_tree", "community",
                                 "barabasi_albert", "erdos_renyi"])
def test_ell_buckets_equal(key):
    name, params = GENERATORS[key]
    pe = getattr(pgen, name)(*params, seed=1).ell_buckets()
    je = getattr(jgen, name)(*params, seed=1).ell_buckets()
    np.testing.assert_array_equal(pe.perm, je.perm)
    np.testing.assert_array_equal(pe.inv_perm, je.inv_perm)
    assert pe.widths == je.widths
    assert pe.row_counts == je.row_counts
    for a, b in zip(pe.mats + pe.edge_mats, je.mats + je.edge_mats):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_small6_xml_pair_equal(small6):
    jplat, jdep = small6
    plat = load_platform(SMALL6[0])
    dep = load_deployment(SMALL6[1])
    assert dep.host_names == jdep.host_names
    assert plat.hosts == jplat.hosts
    for latency_scale in (0.0, 1.0):
        p = dep.to_topology(platform=plat, latency_scale=latency_scale)
        j = jdep.to_topology(platform=jplat, latency_scale=latency_scale)
        _assert_same_topology(p, j)
        for field in ("speeds", "bandwidth", "latency_s", "edge_links",
                      "link_ser_rounds", "link_shared", "lat_rounds"):
            a, b = getattr(p, field), getattr(j, field)
            assert (a is None) == (b is None), field
            if a is not None:
                np.testing.assert_array_equal(a, b, err_msg=field)
    topo = dep.to_topology()
    assert topo.true_mean == 30.0
    assert len(topo.adopted) > 0          # the file is deliberately asymmetric
    assert list(topo.neighbors(0)) == list(
        jdep.to_topology().neighbors(0))


@pytest.mark.parametrize("text,kind", [("98.095Mf", "speed"),
                                       ("41.279125MBps", "bandwidth"),
                                       ("100Mbps", "bandwidth"),
                                       ("59.904us", "time"),
                                       ("1.4ms", "time"), ("15", "time")])
def test_parse_value_equal(text, kind):
    assert parse_value(text, kind) == jparse_value(text, kind)


def test_symmetrize_and_builder_match_on_asymmetric_pairs():
    rng = np.random.default_rng(5)
    pairs = rng.integers(0, 40, size=(120, 2))
    both, adopted = _symmetrize(pairs)
    from flow_updating_tpu.topology.graph import _symmetrize as jsym

    jboth, jadopted = jsym(pairs)
    np.testing.assert_array_equal(both, jboth)
    np.testing.assert_array_equal(adopted, jadopted)
    lat = {(int(u), int(v)): 0.001 * (u + v) for u, v in pairs}
    p = build_topology(40, pairs, seed=7, latency_s=lat, latency_scale=900.0,
                       warn_asymmetric=False)
    j = jbuild(40, pairs, seed=7, latency_s=lat, latency_scale=900.0,
               warn_asymmetric=False)
    _assert_same_topology(p, j)
    assert p.max_delay == j.max_delay > 1
    with pytest.raises(ValueError, match="out of range"):
        build_topology(3, [(0, 5)])


def test_topology_from_arrays_takes_jax_leaves():
    j = jgen.community(120, 3, seed=2)
    p = topology_from_arrays(
        j.num_nodes, j.src, j.dst, j.rev, j.out_deg, j.row_start,
        j.edge_rank, j.delay, j.values)
    for name in EDGE_FIELDS:
        if name != "adopted":   # a load-time report, not a graph array
            np.testing.assert_array_equal(getattr(p, name), getattr(j, name))
    np.testing.assert_array_equal(p.ell_buckets().mats[-1],
                                  j.ell_buckets().mats[-1])
    bad_rev = j.rev.copy()
    bad_rev[[0, 1]] = bad_rev[[1, 0]]
    with pytest.raises(ValueError, match="rev"):
        topology_from_arrays(j.num_nodes, j.src, j.dst, bad_rev, j.out_deg,
                             j.row_start, j.edge_rank, j.delay, j.values)


def test_spec_parser_and_unported_virtual_fat_tree():
    p = pgen.topology_from_spec("ring:64:2", seed=4)
    _assert_same_topology(p, jgen.topology_from_spec("ring:64:2", seed=4))
    with pytest.raises(ValueError, match="unknown generator"):
        pgen.topology_from_spec("moebius:4")
    with pytest.raises(NotImplementedError, match="structured"):
        pgen.fat_tree(4, materialize_edges=False)
