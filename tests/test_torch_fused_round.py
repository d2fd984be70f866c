"""Kernel K2's plain version vs the JAX one-kernel round.

``fused_banded_round`` on CPU tensors runs ``fused_round_plain``; it is held
against the JAX ``fused_banded_round`` in Pallas interpret mode on the same
inputs (the remainder addend of the 'lanes' route enters as an input; both
sides get the same one here).  The fire (``avg``) and the delivery
(``A``) are bit-exact.  The ledger merge ``S' = -G - A + deg*avg_prev``,
``G' = -S - deg*avg + A_prev`` is exact up to one rounding: XLA:CPU
contracts ``deg*avg_prev`` (and ``deg*avg``) into a fused multiply-add,
while the port rounds the product as its unfused banded executor does (the
CUDA kernel is built with ``-fmad=false`` for that reason) — so where the
degree is a power of two (exact products) the merge is bit-exact too, and
everywhere it is within the one-FMA bound checked below.  The 'inline'
route on integer payloads is exact everywhere.  Within the port, whole
runs of ``spmv='banded_fused'`` equal ``spmv='banded'`` bit for bit — the
contract of ``tests/test_pallas_round.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flow_updating_tpu.ops import pallas_round as jround
from flow_updating_tpu.plan import compile_topology as jcompile
from flow_updating_tpu.plan.banded import (
    banded_remainder_sum as jbanded_remainder_sum,
)
from flow_updating_tpu.topology import generators as jgen
from flow_updating_tpu_torch import NodeKernel, RoundConfig
from flow_updating_tpu_torch.ops import fused_round as pround
from flow_updating_tpu_torch.plan import compile_topology
from flow_updating_tpu_torch.topology import generators as pgen


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def _inputs(make, route="auto", tile=None, features=0, dtype="float64",
            integer=False, seed=0):
    """The same random round inputs for both packages."""
    pplan = compile_topology(make(pgen), remainder="gather")
    jplan = jcompile(make(jgen), remainder="gather")
    pspec = pround.plan_fused_round(pplan.spmv, block_rows=tile,
                                    rem_route=route)
    jspec = jround.plan_fused_round(jplan.spmv, block_rows=tile,
                                    rem_route=route)
    rng = np.random.default_rng(seed)
    shape = (pspec.P,) + ((features,) if features else ())
    vecs = [(rng.integers(-9, 10, shape).astype(dtype) if integer
             else rng.uniform(-1, 1, shape).astype(dtype))
            for _ in range(5)]
    deg = np.zeros(pspec.P, dtype)
    deg[:pplan.num_nodes] = pplan.topo.out_deg
    inv = (np.ones(pspec.P, dtype) if integer
           else (1.0 / (deg + 1.0)).astype(dtype))
    return pplan, jplan, pspec, jspec, vecs, inv, deg


def _run_both(make, **kw):
    pplan, jplan, pspec, jspec, vecs, inv, deg = _inputs(make, **kw)
    S, G, avp, ap, val = vecs
    a_rem = None
    if jspec.rem_route == "lanes":
        invx = inv.reshape((-1,) + (1,) * (S.ndim - 1))
        a_rem = np.asarray(jbanded_remainder_sum(
            jnp.asarray((val - S + ap) * invx), jplan.spmv, jplan.leaves))
    jout = jround.fused_banded_round(
        *(jnp.asarray(a) for a in (S, G, avp, ap, val, inv, deg)),
        jround.build_fused_leaves(jplan.spmv, jplan.leaves, jspec), jspec,
        a_rem=None if a_rem is None else jnp.asarray(a_rem), interpret=True)
    pout = pround.fused_banded_round(
        *(torch.from_numpy(a) for a in (S, G, avp, ap, val, inv, deg)),
        pround.build_fused_leaves(pplan.spmv, pplan.leaves, pspec), pspec,
        a_rem=None if a_rem is None else torch.from_numpy(a_rem.copy()))
    return [o.numpy() for o in pout], [np.asarray(o) for o in jout], pspec


def _assert_round_equal(got, want, dtype, merge_exact=False):
    """avg and A bit-exact; S' and G' equal up to the difference between
    rounding ``deg*x`` before the sum and one fused multiply-add, which
    is at most one rounding of each of the two additions' operands."""
    S_g, G_g, avg_g, A_g = got
    S_w, G_w, avg_w, A_w = want
    np.testing.assert_array_equal(avg_g, avg_w)
    np.testing.assert_array_equal(A_g, A_w)
    for g, w in ((S_g, S_w), (G_g, G_w)):
        assert g.dtype == w.dtype == np.dtype(dtype)
        if merge_exact:
            np.testing.assert_array_equal(g, w)
        else:
            eps = np.finfo(dtype).eps
            bound = 4 * eps * (np.abs(w) + np.abs(g) + 64.0)
            assert np.all(np.abs(g - w) <= bound)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_plain_k2_matches_jax_gather_remainder(dtype):
    got, want, spec = _run_both(lambda g: g.community(200, 4, seed=0),
                                dtype=dtype)
    assert spec.rem_route == "lanes"
    _assert_round_equal(got, want, dtype)


def test_plain_k2_bit_exact_vs_jax_multi_tile_pow2_degree():
    got, want, spec = _run_both(lambda g: g.ring(6000, 1, seed=0), tile=8)
    assert spec.grid > 1
    # every ring degree is 2: exact products, so the merge is exact too
    _assert_round_equal(got, want, "float64", merge_exact=True)


def test_plain_k2_matches_jax_vector_payload():
    got, want, _ = _run_both(lambda g: g.community(200, 4, seed=0),
                             features=3, seed=1)
    assert got[0].shape[1] == 3
    _assert_round_equal(got, want, "float64")


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_plain_k2_inline_exact_on_integers(dtype):
    got, want, spec = _run_both(lambda g: g.barabasi_albert(300, 3, seed=1),
                                route="inline", dtype=dtype, integer=True)
    assert spec.rem_route == "inline" and spec.rem_width > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _estimates(topo, spmv, rounds, dtype="float64", **kw):
    plan = compile_topology(topo, remainder="gather",
                            features=kw.pop("features", 0))
    k = NodeKernel(topo, RoundConfig.fast(kernel="node", spmv=spmv,
                                          dtype=dtype),
                   plan=plan, device="cpu", **kw)
    return k.estimates(k.run(k.init_state(), rounds)), k


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_fused_bit_exact_vs_port_banded(dtype):
    topo = pgen.community(200, 4, seed=0)
    eb, _ = _estimates(topo, "banded", 21, dtype)
    ef, kf = _estimates(topo, "banded_fused", 21, dtype)
    assert kf.arrays.fused.rem_route == "lanes"
    assert np.array_equal(eb, ef)


def test_fused_bit_exact_vs_port_banded_multi_tile():
    topo = pgen.ring(6000, 1, seed=0)
    eb, _ = _estimates(topo, "banded", 37)
    ef, kf = _estimates(topo, "banded_fused", 37, fused_tile=8)
    assert kf.arrays.fused.grid > 1
    assert np.array_equal(eb, ef)


def test_fused_bit_exact_vs_port_banded_vector_payload():
    topo = pgen.community(200, 4, seed=0)
    vals = np.linspace(0.0, 3.0, topo.num_nodes * 3).reshape(-1, 3)
    eb, _ = _estimates(topo, "banded", 21, values=vals, features=3)
    ef, _ = _estimates(topo, "banded_fused", 21, values=vals, features=3)
    assert eb.shape == (topo.num_nodes, 3)
    assert np.array_equal(eb, ef)


def test_inline_route_neighbor_sum_exact_on_integers():
    """With S = A_prev = 0 and inv = 1 the A output is the neighbor sum of
    the value plane: equal to the banded executor's on integers."""
    from flow_updating_tpu_torch.plan import banded_neighbor_sum

    plan = compile_topology(pgen.barabasi_albert(300, 3, seed=1),
                            remainder="gather")
    spec = pround.plan_fused_round(plan.spmv, rem_route="inline")
    leaves = pround.build_fused_leaves(plan.spmv, plan.leaves, spec)
    x = torch.zeros(spec.P, dtype=torch.float64)
    x[:plan.num_nodes] = torch.arange(1, plan.num_nodes + 1)
    z, ones = torch.zeros_like(x), torch.ones_like(x)
    A = pround.fused_banded_round(z, z, z, z, x, ones, z, leaves, spec)[3]
    ref = banded_neighbor_sum(x, plan.spmv, plan.leaves)
    assert torch.equal(A[:plan.num_nodes], ref[:plan.num_nodes])


def test_wrapper_contract_on_cpu():
    plan = compile_topology(pgen.community(200, 4, seed=0))
    spec = pround.plan_fused_round(plan.spmv)
    leaves = pround.build_fused_leaves(plan.spmv, plan.leaves, spec)
    z = torch.zeros(spec.P, dtype=torch.float64)
    with pytest.raises(ValueError, match="a_rem"):
        pround.fused_banded_round(z, z, z, z, z, z, z, leaves, spec)
    before = pround.fused_banded_round.launches
    pround.fused_banded_round(z, z, z, z, z, z, z, leaves, spec, a_rem=z)
    assert pround.fused_banded_round.launches == before  # the plain version
    # least bytes: 5 payload + inv + deg + a_rem reads, 4 writes, the
    # bit planes and the offsets
    assert pround.fused_round_min_bytes(spec, dtype_bytes=8) == \
        12 * spec.P * 8 + spec.n_planes * spec.P * 4 + 4 * len(spec.offsets)
