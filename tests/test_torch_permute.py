"""The port's permutation-network planners and executor vs the JAX package's.

Beneš, spread and fill-forward plans are host numpy in both packages and
must be equal mask for mask; the per-stage executor ``apply_stages`` is
pure data movement and must be bit-exact to the JAX form on any payload.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flow_updating_tpu.ops import permute as jpermute
from flow_updating_tpu_torch.ops import permute as ppermute
from flow_updating_tpu_torch.ops.permute import StagePlan


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def _assert_plans_equal(p, j):
    assert p.n == j.n and p.dists == j.dists and p.kinds == j.kinds
    assert len(p.masks) == len(j.masks)
    for a, b in zip(p.masks, j.masks):
        assert a.dtype == np.bool_
        np.testing.assert_array_equal(a, np.asarray(b))


def _plans(rng, n):
    """One plan of each planner at width n (a power of two)."""
    runs = np.sort(rng.integers(0, n // 5 + 1, size=n))
    heads = np.flatnonzero(np.r_[True, runs[1:] != runs[:-1]])
    perm = rng.permutation(n)
    return {"benes": lambda m: m.benes_plan(perm),
            "spread": lambda m: m.spread_plan(heads, n),
            "fill": lambda m: m.fill_forward_stages(runs)}


@pytest.mark.parametrize("n", [2, 4, 64, 1024])
@pytest.mark.parametrize("kind", ["benes", "spread", "fill"])
def test_plans_equal_jax(kind, n):
    build = _plans(np.random.default_rng(n), n)[kind]
    _assert_plans_equal(build(ppermute), build(jpermute))


def test_spread_plan_equal_jax_on_real_heads():
    rng = np.random.default_rng(3)
    heads = np.flatnonzero(np.r_[True, np.diff(np.sort(
        rng.integers(0, 700, 3000))) != 0])
    _assert_plans_equal(ppermute.spread_plan(heads, 4096),
                        jpermute.spread_plan(heads, 4096))


def test_padded_perm_plan_equal_jax_and_roundtrip():
    rng = np.random.default_rng(1)
    perm = rng.permutation(1500)
    p = ppermute.padded_perm_plan(perm)
    j = jpermute.padded_perm_plan(perm)
    assert p.n == j.n == 1500
    _assert_plans_equal(p.stages, j.stages)
    x = torch.from_numpy(rng.normal(size=(2, 1500)))
    got = ppermute.apply_padded_perm(x, p, p.to("cpu"))
    assert torch.equal(got, x[:, perm])


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32])
@pytest.mark.parametrize("batch", [(), (3,)])
def test_apply_stages_bit_exact_vs_jax(dtype, batch):
    rng = np.random.default_rng(7)
    n = 512
    runs = np.sort(rng.integers(0, 60, size=n))
    heads = np.flatnonzero(np.r_[True, runs[1:] != runs[:-1]])
    plan = ppermute.concat_plans(
        ppermute.spread_plan(heads, n),
        ppermute.fill_forward_stages(runs),
        ppermute.benes_plan(rng.permutation(n)))
    jplan = jpermute.StagePlan(n=plan.n, dists=plan.dists, kinds=plan.kinds,
                               masks=plan.masks)
    x = (rng.normal(size=batch + (n,)) * 100).astype(dtype)
    got = ppermute.apply_stages(torch.from_numpy(x), plan, plan.to("cpu"))
    want = np.asarray(jpermute.apply_stages(jnp.asarray(x), jplan))
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)


def test_benes_plan_applies_the_permutation():
    rng = np.random.default_rng(2)
    perm = rng.permutation(256)
    plan = ppermute.benes_plan(perm)
    x = torch.arange(256, dtype=torch.int64)
    assert torch.equal(ppermute.apply_stages(x, plan, plan.to("cpu")),
                       x[perm])


def test_stage_plan_from_jax_fields_routes_the_same_masks():
    """A JAX plan's numpy fields build the port's plan, which applies the
    identical network."""
    rng = np.random.default_rng(4)
    j = jpermute.benes_plan(rng.permutation(128))
    p = StagePlan.from_numpy(j.n, j.dists, j.kinds, j.masks)
    _assert_plans_equal(p, j)
    x = rng.normal(size=128)
    np.testing.assert_array_equal(
        ppermute.apply_stages(torch.from_numpy(x), p, p.to("cpu")).numpy(),
        np.asarray(jpermute.apply_stages(jnp.asarray(x), j)))


def test_bad_inputs_raise_as_in_jax():
    with pytest.raises(ValueError, match="power-of-two"):
        ppermute.benes_plan(np.arange(6))
    with pytest.raises(ValueError, match="not a permutation"):
        ppermute.benes_plan(np.zeros(8, np.int64))
    with pytest.raises(ValueError, match="strictly increasing"):
        ppermute.spread_plan(np.array([3, 2]), 8)
    bad = StagePlan(n=8, dists=(3,), kinds=("swap",),
                    masks=(np.ones(8, bool),))
    with pytest.raises(ValueError, match="power of two"):
        ppermute.apply_stages(torch.zeros(8), bad, bad.to("cpu"))
    assert ppermute.next_pow2(1) == 2 == jpermute.next_pow2(1)
    assert ppermute.next_pow2(1025) == 2048 == jpermute.next_pow2(1025)
