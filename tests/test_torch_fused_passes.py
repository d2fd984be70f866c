"""The port's fused-pass planner and plain passes vs the JAX package's.

Mirrors ``tests/test_pallas_fused.py`` at its geometry (64 rows of 128
elements in tiles of 16 rows, a grid of 4): for the same stage plan both
packages must segment the same passes and pack the same bit planes, and
each plain pass flavour must be bit-exact to the JAX Pallas pass run in
interpret mode — single and batched — and the whole plan bit-exact to
``apply_stages``.  Kernel B3 itself runs only on the card
(``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flow_updating_tpu.ops import pallas_fused as jfused
from flow_updating_tpu.ops import permute as jpermute
from flow_updating_tpu_torch.ops import fused_passes as pfused
from flow_updating_tpu_torch.ops import permute as ppermute
from flow_updating_tpu_torch.ops.permute import StagePlan

LANE = 128
P = 64 * LANE
BLOCK_ROWS = 16
T = LANE * BLOCK_ROWS


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def random_stage_plan(seed, kinds_dists, n=P):
    rng = np.random.default_rng(seed)
    masks = []
    for kind, d in kinds_dists:
        m = rng.integers(0, 2, size=n).astype(bool)
        if kind == "swap":
            m = m | m[np.arange(n) ^ d]     # pair-symmetric, as Beneš masks
        else:
            m[:d] = False                   # no wrapped-around source
        masks.append(m)
    return StagePlan(n=n, dists=tuple(d for _, d in kinds_dists),
                     kinds=tuple(k for k, _ in kinds_dists),
                     masks=tuple(masks))


def _jax_plan(plan):
    return jpermute.StagePlan(n=plan.n, dists=plan.dists, kinds=plan.kinds,
                              masks=plan.masks)


CASES = {
    "local_all_dists": [("swap", d) for d in (1, 2, 8, 64, 128, 256, T // 2)],
    "wide_swaps": [("swap", T), ("swap", 2 * T)],
    "wide_swaps_odd": [("swap", T), ("swap", 2 * T), ("swap", T)],
    "windowed_rolls": [("roll", d) for d in (1, 64, 128, 256, 512)],
    "window_halo_split": [("roll", T // 2)] * 3,
    "wide_rolls": [("roll", T), ("roll", 2 * T)],
    "wide_roll2_then_narrow": [("roll", 2 * T), ("roll", T), ("roll", 128)],
    "mixed": ([("roll", d) for d in (128, 256)]
              + [("swap", d) for d in (1, 64, 256)]
              + [("swap", 2 * T), ("roll", 128)]),
    "stage_cap": [("swap", 128)] * (pfused.MAX_STAGES_PER_PASS + 3),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plan_and_planes_equal_jax(name):
    plan = random_stage_plan(len(name), CASES[name])
    pf = pfused.plan_fused(plan, block_rows=BLOCK_ROWS)
    jf = jfused.plan_fused(_jax_plan(plan), block_rows=BLOCK_ROWS)
    assert (pf.geom.P, pf.geom.rows, pf.geom.block_rows, pf.geom.grid) == \
        (jf.P, jf.rows, jf.block_rows, jf.grid)
    assert [(p.kind, p.dists, p.block_dist, p.block_dist2)
            for p in pf.passes] == \
        [(p.kind, p.dists, p.block_dist, p.block_dist2) for p in jf.passes]
    pplanes = pfused.pack_masks(plan, pf)
    jplanes = jfused.pack_masks(_jax_plan(plan), jf)
    assert len(pplanes) == len(jplanes)
    for a, b in zip(pplanes, jplanes):
        assert a.dtype == b.dtype and a.shape == (P,)
        np.testing.assert_array_equal(a, b.reshape(-1))
    # the device form: the same bits, uint32 stored as int32
    for a, t in zip(pplanes, pfused.mask_planes(plan, pf, "cpu")):
        assert t.dtype == (torch.int32 if a.dtype == np.uint32
                           else torch.int8)
        np.testing.assert_array_equal(t.numpy().view(a.dtype), a)


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_apply_fused_bit_exact(name, dtype):
    """The whole plan through the plain passes equals the port's and the
    JAX package's ``apply_stages`` bit for bit."""
    plan = random_stage_plan(len(name), CASES[name])
    pf = pfused.plan_fused(plan, block_rows=BLOCK_ROWS)
    x = np.random.default_rng(1).normal(size=P).astype(dtype)
    got = pfused.apply_fused(torch.from_numpy(x), pf,
                             pfused.mask_planes(plan, pf, "cpu"))
    ref = ppermute.apply_stages(torch.from_numpy(x), plan, plan.to("cpu"))
    assert torch.equal(got, ref)
    np.testing.assert_array_equal(
        got.numpy(),
        np.asarray(jpermute.apply_stages(jnp.asarray(x), _jax_plan(plan))))


FLAVOURS = {
    "local": [("swap", d) for d in (1, 8, 64, 128, 512, T // 2)],
    "window": [("roll", d) for d in (1, 3, 64, 128, 256, 512)],
    "wide_swap": [("swap", 2 * T)],
    "wide_roll": [("roll", T)],
    "wide_swap2": [("swap", T), ("swap", 2 * T)],
    "wide_roll2": [("roll", 2 * T), ("roll", T)],
}


@pytest.mark.parametrize("flavour", sorted(FLAVOURS))
@pytest.mark.parametrize("batch", [1, 3])
def test_plain_pass_bit_exact_vs_jax_interpret(flavour, batch):
    """One pass of each flavour, the plain torch body against the JAX
    Pallas pass in interpret mode on the same random words."""
    dists = FLAVOURS[flavour]
    plan = random_stage_plan(7, dists)
    pf = pfused.plan_fused(plan, block_rows=BLOCK_ROWS)
    jf = jfused.plan_fused(_jax_plan(plan), block_rows=BLOCK_ROWS)
    assert [p.kind for p in pf.passes] == [flavour]
    x = np.random.default_rng(batch).normal(size=(batch, P))
    (plane,) = pfused.mask_planes(plan, pf, "cpu")
    (jplane,) = jfused.device_mask_planes(_jax_plan(plan), jf)
    geom = pf.geom
    got = pfused.PLAIN_FNS[flavour](
        torch.from_numpy(x).reshape(batch, geom.grid, geom.tile), plane,
        pf.passes[0], geom)
    want = jfused._PASS_FNS[flavour](
        jnp.asarray(x).reshape(batch, jf.rows, LANE), jplane,
        jf.passes[0], jf, True)
    np.testing.assert_array_equal(got.reshape(batch, P).numpy(),
                                  np.asarray(want).reshape(batch, P))
    # the CPU wrapper is the plain version and counts no launch
    wrapper = pfused.PASS_FNS[flavour]
    before = wrapper.launches
    again = wrapper(torch.from_numpy(x).reshape(batch, geom.grid,
                                                geom.tile),
                    plane, pf.passes[0], geom)
    assert torch.equal(again, got) and wrapper.launches == before


def test_batched_apply_fused_on_a_routed_network():
    perm = np.random.default_rng(5).permutation(P)
    plan = ppermute.benes_plan(perm)
    pf = pfused.plan_fused(plan, block_rows=BLOCK_ROWS)
    assert any(p.kind == "local" for p in pf.passes)
    assert any(p.kind.startswith("wide_swap") for p in pf.passes)
    x = torch.from_numpy(np.random.default_rng(6).normal(size=(3, P)))
    got = pfused.apply_fused(x, pf, pfused.mask_planes(plan, pf, "cpu"))
    assert torch.equal(got, x[:, perm])


def test_no_wrap_check_raises_as_in_jax():
    plan = random_stage_plan(3, [("roll", 256)])
    masks = (plan.masks[0].copy(),)
    masks[0][5] = True                    # selects a wrapped source
    bad = StagePlan(n=P, dists=plan.dists, kinds=plan.kinds, masks=masks)
    pf = pfused.plan_fused(bad, block_rows=BLOCK_ROWS)
    jf = jfused.plan_fused(_jax_plan(bad), block_rows=BLOCK_ROWS)
    with pytest.raises(ValueError) as perr:
        pfused.pack_masks(bad, pf)
    with pytest.raises(ValueError) as jerr:
        jfused.pack_masks(_jax_plan(bad), jf)
    assert str(perr.value).split(";")[0] == str(jerr.value).split(";")[0]
    assert "wrapped-around" in str(perr.value)


def test_planner_errors_match_jax():
    for seq in ([("swap", 3)], [("roll", 200)]):
        plan = StagePlan(n=P, dists=tuple(d for _, d in seq),
                         kinds=tuple(k for k, _ in seq),
                         masks=(np.zeros(P, bool),))
        with pytest.raises(ValueError) as perr:
            pfused.plan_fused(plan, block_rows=BLOCK_ROWS)
        with pytest.raises(ValueError) as jerr:
            jfused.plan_fused(_jax_plan(plan), block_rows=BLOCK_ROWS)
        assert str(perr.value) == str(jerr.value)
    assert pfused.halo_rows((1, 64, 128, 512)) == \
        jfused.halo_rows((1, 64, 128, 512)) == 7


@pytest.mark.parametrize("n", [2, 16, 64, 256, 512])
def test_small_networks_are_one_tile_without_cutoff(n):
    """Below the JAX package's 1,024-element minimum the port still plans
    fused passes (one tile), and they equal ``apply_stages``."""
    rng = np.random.default_rng(n)
    runs = np.sort(rng.integers(0, n // 3 + 1, size=n))
    heads = np.flatnonzero(np.r_[True, runs[1:] != runs[:-1]])
    plan = ppermute.concat_plans(ppermute.spread_plan(heads, n),
                                 ppermute.fill_forward_stages(runs),
                                 ppermute.benes_plan(rng.permutation(n)))
    pf = pfused.plan_fused(plan)
    assert pf.geom.grid == 1 and pf.geom.tile == n
    x = torch.from_numpy(rng.normal(size=(2, n)))
    assert torch.equal(
        pfused.apply_fused(x, pf, pfused.mask_planes(plan, pf, "cpu")),
        ppermute.apply_stages(x, plan, plan.to("cpu")))


def test_card_default_tile_fits_the_kernel():
    geom = pfused.geometry(1 << 23)
    assert geom.tile == pfused.DEFAULT_BLOCK_ROWS * LANE <= pfused.MAX_TILE
    assert geom.grid == (1 << 23) // geom.tile
    with pytest.raises(ValueError, match="power-of-two width"):
        pfused.geometry(96)
    with pytest.raises(ValueError, match="block_rows"):
        pfused.geometry(P, block_rows=24)
