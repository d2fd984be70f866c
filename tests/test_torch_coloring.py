"""``Topology.edge_coloring`` of the port against the JAX package's.

Both packages color with the numpy matching extractor below 50,000
directed edges and with the C++ greedy coloring from there (each package
builds its own copy of the native runtime); the colorings must be equal,
proper (no two edges at a node share a color), symmetric across the two
directions of an edge, and cached.
"""

import numpy as np
import pytest
import torch

from flow_updating_tpu.topology import generators as jgen
from flow_updating_tpu_torch.topology import generators as pgen


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def _assert_proper(topo, color, c):
    assert color.dtype == np.int32 and color.shape == (topo.num_edges,)
    assert color.min() == 0 and color.max() == c - 1
    assert np.array_equal(color, color[topo.rev])
    # at every node, its out-edges carry distinct colors
    key = topo.src.astype(np.int64) * c + color
    assert len(np.unique(key)) == topo.num_edges
    assert c >= int(topo.out_deg.max())


@pytest.mark.parametrize("name,args", [
    ("ring", (33, 2)), ("barabasi_albert", (300, 3)),
    ("erdos_renyi", (200, 6.0)), ("fat_tree", (4,)),
    ("barabasi_albert", (7000, 4)),       # 55,980 edges: the native route
])
def test_coloring_equals_jax_and_is_proper(name, args):
    jt = getattr(jgen, name)(*args, seed=1)
    pt = getattr(pgen, name)(*args, seed=1)
    assert np.array_equal(jt.src, pt.src) and np.array_equal(jt.dst, pt.dst)
    jc, jn = jt.edge_coloring()
    pc, pn = pt.edge_coloring()
    assert (pt.num_edges >= 50_000) == (name == "barabasi_albert"
                                        and args[0] == 7000)
    assert pn == jn
    assert np.array_equal(pc, jc)
    _assert_proper(pt, pc, pn)
    assert pt.edge_coloring()[0] is pc          # cached on the object


def test_coloring_rides_device_arrays():
    topo = pgen.ring(10, 1, seed=0)
    arrays = topo.device_arrays(coloring=True, device="cpu")
    col, c = topo.edge_coloring()
    assert arrays.num_colors == c
    assert torch.equal(arrays.edge_color, torch.from_numpy(col))
    assert topo.device_arrays(device="cpu").edge_color is None
