"""The port's Beneš neighbor sum vs the JAX package's and the port's gather.

The node kernel's ELL matrices plan the same network in both packages
(masks equal bit for bit, the same fused passes at the same tile), and the
network is pure data movement, so ``neighbor_sum_benes`` equals the port's
own gather ``neighbor_sum`` exactly — the JAX suite's
``test_neighbor_sum_fused_matches_gather`` setting, ER(600, 6).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flow_updating_tpu.models import sync as jsync
from flow_updating_tpu.models.config import RoundConfig as JaxConfig
from flow_updating_tpu.ops import pallas_fused as jfused
from flow_updating_tpu.ops import spmv_benes as jbenes
from flow_updating_tpu.topology import generators as jgen
from flow_updating_tpu_torch import NodeKernel, RoundConfig
from flow_updating_tpu_torch.ops import fused_passes as pfused
from flow_updating_tpu_torch.ops.spmv import neighbor_sum
from flow_updating_tpu_torch.ops.spmv_benes import (
    FusedNeighborSumPlan,
    NeighborSumPlan,
    neighbor_sum_benes,
    plan_neighbor_sum,
)
from flow_updating_tpu_torch.topology import generators as pgen

GRAPHS = {
    "er": lambda g: g.erdos_renyi(600, 6.0, seed=3),
    "ba": lambda g: g.barabasi_albert(300, 3, seed=1),
    "fat_tree": lambda g: g.fat_tree(8, seed=0),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def _node_mats(name, spmv="xla"):
    k = NodeKernel(GRAPHS[name](pgen),
                   RoundConfig.fast(kernel="node", spmv=spmv), device="cpu")
    return k, tuple(m.numpy() for m in k.arrays.mats)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_network_masks_equal_jax(name):
    jk = jsync.NodeKernel(GRAPHS[name](jgen),
                          JaxConfig.fast(kernel="node", spmv="benes"))
    pk, _ = _node_mats(name, "benes")
    jp, pp = jk.arrays.ns_plan, pk.arrays.ns_plan
    assert isinstance(pp, NeighborSumPlan)
    assert (pp.m1, pp.P, pp.flat_begin, pp.bucket_shapes) == \
        (jp.m1, jp.P, jp.flat_begin, jp.bucket_shapes)
    assert pp.stages.dists == jp.stages.dists
    assert pp.stages.kinds == jp.stages.kinds
    for a, b in zip(pp.stages.masks, jp.stages.masks):
        np.testing.assert_array_equal(a, b)
    # the fused plan at one tile height: the same passes and planes
    R = 8
    pf = pfused.plan_fused(pp.stages, block_rows=R)
    jf = jfused.plan_fused(jp.stages, block_rows=R)
    assert [(p.kind, p.dists, p.block_dist, p.block_dist2)
            for p in pf.passes] == \
        [(p.kind, p.dists, p.block_dist, p.block_dist2) for p in jf.passes]
    for a, b in zip(pfused.pack_masks(pp.stages, pf),
                    jfused.pack_masks(jp.stages, jf)):
        np.testing.assert_array_equal(a, b.reshape(-1))


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_neighbor_sum_benes_equals_gather_exactly(fused, dtype):
    k, mats = _node_mats("er")
    plan = plan_neighbor_sum(mats, k.padded_size + 1)
    if fused:   # tiles of 4 rows: a grid of 16 over this 8,192-wide network
        plan = FusedNeighborSumPlan(
            base=plan, fused=pfused.plan_fused(plan.stages, block_rows=4))
        assert plan.fused.geom.grid == 16
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 1, k.padded_size)).to(dtype)
    got = neighbor_sum_benes(x, plan, plan.to("cpu"))
    assert torch.equal(got, neighbor_sum(x, k.arrays.mats))


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_neighbor_sum_benes_equals_jax_on_exact_payloads(name):
    """Integer-valued payloads sum exactly in any order, so the port's
    network + row sums equal the JAX package's bit for bit."""
    jk = jsync.NodeKernel(GRAPHS[name](jgen),
                          JaxConfig.fast(kernel="node", spmv="benes"))
    pk, mats = _node_mats(name, "benes")
    x = np.random.default_rng(2).integers(-50, 50, pk.padded_size)
    x = x.astype(np.float64)
    want = jbenes.neighbor_sum_benes(jnp.asarray(x), jk.arrays.ns_plan,
                                     jk.arrays.ns_masks)
    got = neighbor_sum_benes(torch.from_numpy(x), pk.arrays.ns_plan,
                             pk.arrays.ns_masks)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_plans_are_cached_and_share_one_routing():
    k, mats = _node_mats("ba")
    m1 = k.padded_size + 1
    base = plan_neighbor_sum(mats, m1)
    assert plan_neighbor_sum(mats, m1) is base
    fused = plan_neighbor_sum(mats, m1, fused=True)
    assert isinstance(fused, FusedNeighborSumPlan) and fused.base is base
    assert plan_neighbor_sum(mats, m1, fused=True) is fused


def test_small_graph_plans_fused_passes_without_cutoff():
    """The JAX package falls back to the unfused plan below 1,024
    elements; the port plans one tile, so the card always runs B3."""
    k = NodeKernel(pgen.ring(16, 2, seed=0),
                   RoundConfig.fast(kernel="node", spmv="benes_fused"),
                   device="cpu")
    plan = k.arrays.ns_plan
    assert isinstance(plan, FusedNeighborSumPlan) and plan.P < 1024
    assert plan.fused.geom.grid == 1
    x = torch.from_numpy(np.random.default_rng(1).uniform(0, 1,
                                                          k.padded_size))
    assert torch.equal(neighbor_sum_benes(x, plan, k.arrays.ns_masks),
                       neighbor_sum(x, k.arrays.mats))


def test_vector_payload_is_refused():
    k, _ = _node_mats("er", "benes")
    with pytest.raises(ValueError, match="scalar"):
        neighbor_sum_benes(torch.zeros(k.padded_size, 2), k.arrays.ns_plan,
                           k.arrays.ns_masks)
