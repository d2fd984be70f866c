"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU with ``nvcc`` and skips without one.
This file imports no JAX, so it also runs where JAX is absent, without the
suite's JAX-pinning conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from flow_updating_tpu_torch import Engine, NodeKernel, RoundConfig
from flow_updating_tpu_torch.ops.fused_round import (
    build_fused_leaves,
    fused_banded_round,
    fused_round_plain,
    plan_fused_round,
)
from flow_updating_tpu_torch.ops.spmv import neighbor_sum, neighbor_sum_ell
from flow_updating_tpu_torch.plan import banded_remainder_sum, compile_topology
from flow_updating_tpu_torch.topology.generators import (
    barabasi_albert,
    community,
    fat_tree,
    ring,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels are built with nvcc and "
                    "run only on the card)")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6),
                                       (torch.float64, 1e-12)])
def test_spmv_ell_kernel_matches_plain(card, dtype, tol):
    topo = barabasi_albert(3000, 4, seed=3)
    k = NodeKernel(topo, RoundConfig.fast(kernel="node", spmv="pallas"),
                   device=card)
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 1, k.padded_size)).to(card, dtype)
    before = neighbor_sum_ell.launches
    got = neighbor_sum_ell(x, k.arrays.mats)
    assert neighbor_sum_ell.launches - before == sum(
        1 for m in k.arrays.mats if m.shape[0] and m.shape[1])
    torch.testing.assert_close(got, neighbor_sum(x, k.arrays.mats),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("route", ["lanes", "inline"])
@pytest.mark.parametrize("features", [0, 3])
def test_fused_round_kernel_matches_plain(card, route, features):
    topo = community(600, 4, seed=0)
    plan = compile_topology(topo, remainder="gather")
    spec = plan_fused_round(plan.spmv, rem_route=route)
    leaves = build_fused_leaves(plan.spmv, plan.leaves, spec).to(card)
    rng = np.random.default_rng(1)
    shape = (spec.P,) + ((features,) if features else ())
    draw = ((lambda: rng.integers(-9, 10, shape).astype(float))
            if route == "inline" else (lambda: rng.uniform(-1, 1, shape)))
    S, G, avp, ap, val = (torch.from_numpy(draw()).to(card)
                          for _ in range(5))
    deg = np.zeros(spec.P)
    deg[:topo.num_nodes] = topo.out_deg[plan.order]
    dg = torch.from_numpy(deg).to(card)
    inv = torch.ones_like(dg) if route == "inline" else 1.0 / (dg + 1.0)
    a_rem = None
    if route == "lanes":
        invx = inv[:, None] if features else inv
        a_rem = banded_remainder_sum((val - S + ap) * invx, plan.spmv,
                                     plan.leaves.to(card))
    call = (S, G, avp, ap, val, inv, dg, leaves, spec)
    got = fused_banded_round(*call, a_rem=a_rem)
    ref = fused_round_plain(*call, a_rem=a_rem)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def test_banded_fused_bit_exact_vs_banded_on_card(card):
    topo = ring(6000, 2, seed=0)
    plan = compile_topology(topo)
    est = {}
    for spmv in ("banded", "banded_fused"):
        k = NodeKernel(topo, RoundConfig.fast(kernel="node", spmv=spmv),
                       plan=plan, device=card, fused_tile=8)
        est[spmv] = k.estimates(k.run(k.init_state(), 37))
    assert np.array_equal(est["banded"], est["banded_fused"])


def test_engine_pallas_on_card_matches_host(card):
    cfg = RoundConfig.fast(kernel="node", spmv="pallas", dtype="float64")
    on_card = Engine(config=cfg).set_topology(fat_tree(8)).build()
    host = Engine(config=cfg, device="cpu").set_topology(fat_tree(8)).build()
    on_card.run_rounds(60)
    host.run_rounds(60)
    np.testing.assert_allclose(on_card.estimates(), host.estimates(),
                               rtol=1e-12, atol=1e-12)
    assert on_card.device.type == "cuda"
