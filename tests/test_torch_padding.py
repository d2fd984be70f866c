"""Capacity padding (``topology/padding.py``) against the JAX package's.

The same topologies (small6, ``ring:64:2``, the registry's 96-node
community graph, ``fat_tree:4``, a 5 x 5 grid) are padded by both
packages: every array of ``pad_topology_to`` under both ghost spreads,
the ``edge_rows`` matrix, ``row_width``, ``bucket_ceil``/``pow2_ceil``,
``masked_values`` and the ghost masks of a packed state are equal element
for element; the real arrays stay a prefix; padding clears the community
metadata and extends a computed coloring with -1.
"""

import os

import numpy as np
import pytest
import torch

from flow_updating_tpu.models.config import RoundConfig as JaxConfig
from flow_updating_tpu.models.state import init_state as jax_init
from flow_updating_tpu.topology import generators as jgen
from flow_updating_tpu.topology import padding as jpad
from flow_updating_tpu.topology.deployment import (
    load_deployment as jax_deployment,
)
from flow_updating_tpu.topology.platform import load_platform as jax_platform
from flow_updating_tpu_torch import RoundConfig
from flow_updating_tpu_torch.models.state import init_state
from flow_updating_tpu_torch.topology import generators as pgen
from flow_updating_tpu_torch.topology import padding as ppad
from flow_updating_tpu_torch.topology.deployment import load_deployment
from flow_updating_tpu_torch.topology.platform import load_platform

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("src", "dst", "rev", "out_deg", "row_start", "edge_rank",
          "delay", "values")


def _small6(platform_loader, deployment_loader):
    pl = platform_loader(os.path.join(ROOT, "examples/platforms/small6.xml"))
    dp = deployment_loader(
        os.path.join(ROOT, "examples/deployments/small6_actors.xml"))
    return dp.to_topology(platform=pl, tick_interval=1.0)


GRAPHS = {
    "small6": (lambda: _small6(jax_platform, jax_deployment),
               lambda: _small6(load_platform, load_deployment)),
    "ring": (lambda: jgen.ring(64, k=2, seed=0),
             lambda: pgen.ring(64, k=2, seed=0)),
    "community": (lambda: jgen.community(96, c=3, k_in=8.0, k_out=0.0,
                                         seed=0),
                  lambda: pgen.community(96, c=3, k_in=8.0, k_out=0.0,
                                         seed=0)),
    "fat_tree": (lambda: jgen.fat_tree(4), lambda: pgen.fat_tree(4)),
    "grid": (lambda: jgen.grid2d(5, 5, seed=0),
             lambda: pgen.grid2d(5, 5, seed=0)),
}


@pytest.fixture(scope="module", params=sorted(GRAPHS))
def pair(request):
    jmake, pmake = GRAPHS[request.param]
    return jmake(), pmake()


def _shapes(topo):
    """The sweep's bucket shape, a wider one and a much wider one."""
    n = jpad.bucket_ceil(topo.num_nodes + 1)
    e = jpad.bucket_ceil(topo.num_edges + 1)
    return ((max(n, 8), max(e, 16)), (n + 5, e + 37), (2 * n, 4 * e + 3))


@pytest.mark.parametrize("spread", ["even", "last"])
def test_pad_topology_to_equals_jax(pair, spread):
    jt, pt = pair
    for n_pad, e_pad in _shapes(jt):
        jp = jpad.pad_topology_to(jt, n_pad, e_pad, spread=spread)
        pp = ppad.pad_topology_to(pt, n_pad, e_pad, spread=spread)
        assert pp.num_nodes == jp.num_nodes == n_pad
        assert pp.num_edges == jp.num_edges == e_pad
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(pp, f), getattr(jp, f),
                                          err_msg=f)
            assert getattr(pp, f).dtype == getattr(jp, f).dtype, f
        # the real arrays are a prefix, the ghosts valueless
        E, N = pt.num_edges, pt.num_nodes
        for f in ("src", "dst", "rev", "edge_rank", "delay"):
            np.testing.assert_array_equal(getattr(pp, f)[:E],
                                          getattr(pt, f))
        assert not pp.values[N:].any()
        np.testing.assert_array_equal(pp.rev[pp.rev], np.arange(e_pad))


def test_edge_rows_and_row_width_equal_jax(pair):
    jt, pt = pair
    for n_pad, e_pad in _shapes(jt):
        w = jpad.row_width(jt, n_pad, e_pad)
        assert ppad.row_width(pt, n_pad, e_pad) == w
        jp = jpad.pad_topology_to(jt, n_pad, e_pad)
        pp = ppad.pad_topology_to(pt, n_pad, e_pad)
        for width in (w, w + 3):
            got = ppad.edge_rows(pp, width, e_pad)
            np.testing.assert_array_equal(got,
                                          jpad.edge_rows(jp, width, e_pad))
            assert got.dtype == np.int32


@pytest.mark.parametrize("x", [0, 1, 2, 3, 7, 8, 9, 17, 63, 64, 65, 1000,
                               9473, 49153, 1 << 20])
def test_bucket_ceil_and_pow2_ceil(x):
    assert ppad.bucket_ceil(x) == jpad.bucket_ceil(x)
    assert ppad.pow2_ceil(x) == jpad.pow2_ceil(x)
    # at most an eighth of the power of two above x is padding
    assert 0 <= ppad.bucket_ceil(x) - x < max(ppad.pow2_ceil(x) // 8, 1)


def test_ghost_masks_equal_jax(pair):
    jt, pt = pair
    (n_pad, e_pad), _, _ = _shapes(jt)
    jp = jpad.pad_topology_to(jt, n_pad, e_pad)
    pp = ppad.pad_topology_to(pt, n_pad, e_pad)
    jcfg = JaxConfig.reference("collectall")
    cfg = RoundConfig.reference("collectall")
    js = jpad.mask_ghost_state(jax_init(jp, jcfg, seed=3),
                               jt.num_nodes, jt.num_edges)
    ps = ppad.mask_ghost_state(init_state(pp, cfg, seed=3, device="cpu"),
                               pt.num_nodes, pt.num_edges)
    np.testing.assert_array_equal(ps.alive.numpy(), np.asarray(js.alive))
    np.testing.assert_array_equal(ps.edge_ok.numpy(),
                                  np.asarray(js.edge_ok))
    np.testing.assert_array_equal(ps.value.numpy(), np.asarray(js.value))


@pytest.mark.parametrize("cohort", [None, [5, 0, 3]])
def test_masked_values_equal_jax(cohort):
    vals = np.random.default_rng(0).normal(size=(3, 2))
    np.testing.assert_array_equal(ppad.masked_values(vals, 8, cohort),
                                  jpad.masked_values(vals, 8, cohort))


def test_masked_values_and_padding_refusals():
    t = pgen.ring(8, k=2, seed=0)
    with pytest.raises(ValueError, match="n_pad"):
        ppad.pad_topology_to(t, 8, 40)
    with pytest.raises(ValueError, match="e_pad"):
        ppad.pad_topology_to(t, 16, 4)
    with pytest.raises(ValueError, match="ghost-placement"):
        ppad.pad_topology_to(t, 16, 40, spread="middle")
    with pytest.raises(ValueError, match="exceed"):
        ppad.masked_values(np.ones(9), 8)
    with pytest.raises(ValueError, match="duplicate"):
        ppad.masked_values(np.ones(2), 8, cohort=[1, 1])
    with pytest.raises(ValueError, match="lie in"):
        ppad.masked_values(np.ones(1), 8, cohort=[8])


def test_community_metadata_cleared_by_padding():
    topo = pgen.community(48, c=2, k_in=6.0, k_out=0.5, seed=3)
    assert topo.membership is not None and topo.bridge_edges is not None
    padded = ppad.pad_topology_to(topo, 64, 1024, spread="even")
    assert padded.membership is None and padded.bridge_edges is None


def test_padded_coloring_extends_with_minus_one():
    jt = jgen.grid2d(4, 4, seed=1)
    pt = pgen.grid2d(4, 4, seed=1)
    col, c = pt.edge_coloring()
    jcol, jc = jt.edge_coloring()
    pp = ppad.pad_topology_to(pt, 32, 64)
    jp = jpad.pad_topology_to(jt, 32, 64)
    got, gc = pp.edge_coloring()
    want, wc = jp.edge_coloring()
    assert gc == wc == c == jc
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:pt.num_edges], col)
    assert (got[pt.num_edges:] == -1).all()
    # a padded graph with no cached coloring colors the same way (its
    # self-loops never enter a matching)
    fresh = ppad.pad_topology_to(pgen.grid2d(4, 4, seed=1), 32, 64)
    np.testing.assert_array_equal(fresh.edge_coloring()[0], got)
    assert torch.equal(torch.from_numpy(got), torch.from_numpy(want))
