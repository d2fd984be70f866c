"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU with ``nvcc`` and skips without one
(kernels K1, K2, the four flavours of B3 — local, window, wide and wide2
at every tile —, B4's scan (every tile too) and fill, B5 and B6;
the edge kernel's Beneš routes, the sharded banded round and the halo
edge round on the card; checkpoints restored onto the card and faults
that keep the state there).
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


def _random_plan(seed, kinds_dists, n):
    from flow_updating_tpu_torch.ops.permute import StagePlan

    rng = np.random.default_rng(seed)
    masks = []
    for kind, d in kinds_dists:
        m = rng.integers(0, 2, size=n).astype(bool)
        if kind == "swap":
            m = m | m[np.arange(n) ^ d]
        else:
            m[:d] = False
        masks.append(m)
    return StagePlan(n=n, dists=tuple(d for _, d in kinds_dists),
                     kinds=tuple(k for k, _ in kinds_dists),
                     masks=tuple(masks))


_T = 16 * 128
_FLAVOURS = {
    "local": [("swap", d) for d in (1, 8, 64, 128, 512, _T // 2)],
    "window": [("roll", d) for d in (1, 3, 64, 128, 256, 512)],
    "wide_swap": [("swap", 2 * _T)],
    "wide_roll": [("roll", _T)],
    "wide_swap2": [("swap", _T), ("swap", 2 * _T)],
    "wide_roll2": [("roll", 2 * _T), ("roll", _T)],
}


@pytest.mark.parametrize("flavour", sorted(_FLAVOURS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.int32])
@pytest.mark.parametrize("batch", [1, 3])
def test_benes_pass_kernel_matches_plain(card, flavour, dtype, batch):
    """Kernel B3, each flavour, against its plain version: bit-exact, at
    the JAX test geometry (64 rows of 128 in tiles of 16 rows)."""
    from flow_updating_tpu_torch.ops import fused_passes as fp

    plan = _random_plan(3, _FLAVOURS[flavour], 64 * 128)
    fused = fp.plan_fused(plan, block_rows=16)
    (ps,) = fused.passes
    assert ps.kind == flavour
    (plane,) = fp.mask_planes(plan, fused, card)
    geom = fused.geom
    x = torch.from_numpy(np.random.default_rng(batch).normal(
        size=(batch, geom.grid, geom.tile)) * 1000).to(card, dtype)
    wrapper = fp.PASS_FNS[flavour]
    before = wrapper.launches
    got = wrapper(x, plane, ps, geom)
    assert wrapper.launches == before + 1
    assert torch.equal(got, fp.PLAIN_FNS[flavour](x, plane, ps, geom))


_K160_LOCAL = tuple(1 << b for b in [*range(11, -1, -1), *range(1, 12)])


@pytest.mark.parametrize("log2_tile", range(1, 13))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.int32])
@pytest.mark.parametrize("batch", [1, 3])
def test_local_pass_kernel_every_tile(card, log2_tile, dtype, batch):
    """B3's local kernel against local_pass_plain at every tile from 2 to
    4,096 elements: random lists of 1 to 32 stages with repeats, random
    mask words (any bit), and at 4,096 the k=160 list of 23 stages; one
    launch per pass."""
    from flow_updating_tpu_torch.ops import fused_passes as fp

    tile = 1 << log2_tile
    geom = (fp.geometry(tile) if tile < 128
            else fp.geometry(4 * tile, block_rows=tile // 128))
    rng = np.random.default_rng(log2_tile)
    lists = [tuple(1 << int(b) for b in rng.integers(0, log2_tile, size=k))
             for k in (1, 5, 17, 32)]
    if tile == 4096:
        lists.append(_K160_LOCAL)
    for dists in lists:
        ps = fp.PassSpec(kind="local", dists=dists, block_dist=0)
        plane = torch.from_numpy(rng.integers(
            -2**31, 2**31, geom.P, dtype=np.int64).astype(np.int32)).to(card)
        x = torch.from_numpy(rng.normal(size=(batch, geom.grid, tile))
                             * 1000).to(card, dtype)
        before = fp.local_pass.launches
        got = fp.local_pass(x, plane, ps, geom)
        assert fp.local_pass.launches == before + 1
        assert torch.equal(got, fp.local_pass_plain(x, plane, ps, geom))


def _tiles_geometry(tile, grid):
    """``grid`` tiles of ``tile`` elements (below a row of 128 too)."""
    from flow_updating_tpu_torch.ops import fused_passes as fp

    return fp.Geometry(P=grid * tile, rows=max(grid * tile // 128, 1),
                       block_rows=max(tile // 128, 1), grid=grid)


@pytest.mark.parametrize("log2_tile", range(1, 13))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.int32])
@pytest.mark.parametrize("batch", [1, 3])
def test_window_pass_kernel_every_tile(card, log2_tile, dtype, batch):
    """B3's window kernel against window_pass_plain at every tile from 2
    to 4,096 elements (four tiles): random lists of 1 to 32 roll
    distances below the window, repeats allowed, a list whose sum stays
    below the tile, random mask words (any bit); one launch per pass."""
    from flow_updating_tpu_torch.ops import fused_passes as fp

    tile = 1 << log2_tile
    geom = _tiles_geometry(tile, 4)
    rng = np.random.default_rng(40 + log2_tile)
    lists = [tuple(int(d) for d in rng.integers(1, 2 * tile, size=k))
             for k in (1, 6, 17, 32)]
    lists.append(tuple(max(tile // 64, 1) for _ in range(min(tile // 2, 6))))
    for dists in lists:
        ps = fp.PassSpec(kind="window", dists=dists, block_dist=0)
        plane = torch.from_numpy(rng.integers(
            -2**31, 2**31, geom.P, dtype=np.int64).astype(np.int32)).to(card)
        x = torch.from_numpy(rng.normal(size=(batch, geom.grid, tile))
                             * 1000).to(card, dtype)
        before = fp.window_pass.launches
        got = fp.window_pass(x, plane, ps, geom)
        assert fp.window_pass.launches == before + 1
        assert torch.equal(got, fp.window_pass_plain(x, plane, ps, geom))


#: (kind, D1, D2, tiles): roll chains (D1 = 2 D2, D2 = 2 D1, D1 = D2,
#: several segments), the general roll form (past the register budget,
#: distances past the grid), swap groups of four and two
_WIDE2 = [("wide_roll2", 2, 1, 20), ("wide_roll2", 1, 2, 20),
          ("wide_roll2", 3, 3, 20), ("wide_roll2", 8, 4, 16),
          ("wide_roll2", 4, 2, 23), ("wide_roll2", 3, 2, 23),
          ("wide_roll2", 1, 4, 20), ("wide_roll2", 5, 4, 20),
          ("wide_roll2", 7, 3, 20), ("wide_roll2", 20, 40, 20),
          ("wide_swap2", 1, 2, 8),
          ("wide_swap2", 4, 1, 16), ("wide_swap2", 2, 2, 8)]


@pytest.mark.parametrize("log2_tile", range(1, 13))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.int32])
@pytest.mark.parametrize("batch", [1, 3])
def test_wide2_pass_kernel_every_tile(card, log2_tile, dtype, batch):
    """B3's wide2 kernels against wide2_pass_plain at every tile from 2
    to 4,096 elements: swap groups, roll chains and the general roll
    form, random int8 mask planes (any bit), and an unaligned payload
    (the one-word form); one launch per pass."""
    from flow_updating_tpu_torch.ops import fused_passes as fp

    tile = 1 << log2_tile
    rng = np.random.default_rng(60 + log2_tile)
    for kind, d1, d2, grid in _WIDE2:
        geom = _tiles_geometry(tile, grid)
        ps = fp.PassSpec(kind=kind, dists=(d1 * tile, d2 * tile),
                         block_dist=d1, block_dist2=d2)
        plane = torch.from_numpy(rng.integers(
            -128, 128, geom.P).astype(np.int8)).to(card)
        x = torch.from_numpy(rng.normal(size=(batch, grid, tile))
                             * 1000).to(card, dtype)
        # the same words one element into a larger buffer: not 16-byte
        # aligned
        shifted = torch.empty(batch * geom.P + 1, dtype=dtype, device=card)
        shifted[1:] = x.reshape(-1)
        x_off = shifted[1:].view(batch, grid, tile)
        want = fp.wide2_pass_plain(x, plane, ps, geom)
        for payload in (x, x_off):
            before = fp.wide2_pass.launches
            got = fp.wide2_pass(payload, plane, ps, geom)
            assert fp.wide2_pass.launches == before + 1
            assert torch.equal(got, want)


#: (kind, D, tiles): swap pairs; roll chains of one tile and of several,
#: of unequal length (20 mod 3, 23 mod 5), up to and past the tile count
_WIDE = [("wide_swap", 1, 8), ("wide_swap", 2, 8), ("wide_swap", 4, 16),
         ("wide_swap", 8, 16), ("wide_roll", 1, 20), ("wide_roll", 3, 20),
         ("wide_roll", 5, 23), ("wide_roll", 4, 16), ("wide_roll", 19, 20),
         ("wide_roll", 25, 20)]


@pytest.mark.parametrize("log2_tile", range(13))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.int32])
@pytest.mark.parametrize("batch", [1, 3])
def test_wide_pass_kernel_every_tile(card, log2_tile, dtype, batch):
    """B3's wide kernels (wide2's one-stage instances) against
    wide_pass_plain at every tile from 1 to 4,096 elements: swap pairs
    and roll chains, random int8 mask planes with zeros and non-zero
    bytes whose bit 0 is clear (any non-zero byte selects), and an
    unaligned payload (the one-word form); one launch per pass."""
    from flow_updating_tpu_torch.ops import fused_passes as fp

    tile = 1 << log2_tile
    rng = np.random.default_rng(80 + log2_tile)
    for kind, d, grid in _WIDE:
        geom = _tiles_geometry(tile, grid)
        ps = fp.PassSpec(kind=kind, dists=(d * tile,), block_dist=d)
        bits = rng.integers(-128, 128, geom.P).astype(np.int8)
        bits[::3] = 0
        bits[1::5] = 2
        plane = torch.from_numpy(bits).to(card)
        x = torch.from_numpy(rng.normal(size=(batch, grid, tile))
                             * 1000).to(card, dtype)
        shifted = torch.empty(batch * geom.P + 1, dtype=dtype, device=card)
        shifted[1:] = x.reshape(-1)
        x_off = shifted[1:].view(batch, grid, tile)
        want = fp.wide_pass_plain(x, plane, ps, geom)
        for payload in (x, x_off):
            before = fp.wide_pass.launches
            got = fp.wide_pass(payload, plane, ps, geom)
            assert fp.wide_pass.launches == before + 1
            assert torch.equal(got, want)


@pytest.mark.parametrize("log2n,block_rows", [(16, None), (13, 16),
                                              (6, None), (9, None)])
def test_apply_fused_on_card_equals_apply_stages(card, log2n, block_rows):
    """A routed network through B3 at the card's tile (and below one
    tile, where the JAX package would not fuse) equals the per-stage
    executor and the permutation itself."""
    from flow_updating_tpu_torch.ops import fused_passes as fp
    from flow_updating_tpu_torch.ops import permute as pm

    n = 1 << log2n
    rng = np.random.default_rng(log2n)
    runs = np.sort(rng.integers(0, n // 4 + 1, size=n))
    heads = np.flatnonzero(np.r_[True, runs[1:] != runs[:-1]])
    plan = pm.concat_plans(pm.spread_plan(heads, n),
                           pm.fill_forward_stages(runs))
    perm = rng.permutation(n)
    for stages in (plan, pm.benes_plan(perm)):
        fused = fp.plan_fused(stages, block_rows=block_rows)
        x = torch.from_numpy(rng.normal(size=(2, n))).to(card)
        got = fp.apply_fused(x, fused, fp.mask_planes(stages, fused, card))
        assert torch.equal(got, pm.apply_stages(x, stages,
                                                stages.to(card)))
    idx = torch.arange(n, device=card)
    fused = fp.plan_fused(pm.benes_plan(perm), block_rows=block_rows)
    routed = fp.apply_fused(idx, fused, fp.mask_planes(
        pm.benes_plan(perm), fused, card))
    assert torch.equal(routed.cpu(), torch.from_numpy(perm))


def test_benes_routes_on_card_equal_gather(card):
    topo = barabasi_albert(3000, 4, seed=3)
    est = {}
    for spmv in ("xla", "benes", "benes_fused"):
        k = NodeKernel(topo, RoundConfig.fast(kernel="node", spmv=spmv,
                                              dtype="float64"), device=card)
        est[spmv] = k.estimates(k.run(k.init_state(), 25))
    assert np.array_equal(est["benes"], est["benes_fused"])
    # every route sums the same values in a fresh (rows, width) tensor
    # (the Beneš route clones its section), so the card adds them in one
    # order
    assert np.array_equal(est["benes"], est["xla"])


def test_benes_fused_launches_b3_on_a_tiny_graph(card):
    from flow_updating_tpu_torch.ops import fused_passes as fp

    cfg = RoundConfig.fast(kernel="node", spmv="benes_fused")
    k = NodeKernel(ring(16, 2, seed=0), cfg, device=card)
    passes = len(k.arrays.ns_plan.fused.passes)
    before = sum(f.launches for f in (fp.local_pass, fp.window_pass,
                                      fp.wide_pass, fp.wide2_pass))
    s = k.run(k.init_state(), 5)
    after = sum(f.launches for f in (fp.local_pass, fp.window_pass,
                                     fp.wide_pass, fp.wide2_pass))
    assert after - before == 5 * passes
    host = NodeKernel(ring(16, 2, seed=0), cfg, device="cpu")
    # float32 row sums of four neighbors, added in the card's order
    np.testing.assert_allclose(k.estimates(s),
                               host.estimates(host.run(host.init_state(), 5)),
                               rtol=1e-6, atol=1e-6)


# ---- kernel B4 (csrc/seg_scan.cu) and the edge kernel's Beneš routes ------

def _dist_plane(rng, P, max_deg):
    """edge_rank of random CSR rows of degree 1..max_deg, padded with 0."""
    ranks, n = [], 0
    while n < P:
        d = int(rng.integers(1, max_deg + 1))
        ranks.append(np.arange(d))
        n += d
    dist = np.concatenate(ranks)[:P].astype(np.int32)
    dist[-(P // 16):] = 0
    return dist


def _payload(rng, shape, dtype, special=False):
    """Random values; ``special``: floats also -0.0 and NaN at a few
    positions."""
    if dtype == torch.int32:
        return torch.from_numpy(rng.integers(-10**6, 10**6, shape,
                                             dtype=np.int32))
    x = torch.from_numpy(rng.uniform(-1, 1, shape)).to(dtype)
    if special:
        flat = x.view(-1)
        at = torch.from_numpy(rng.integers(0, flat.numel(),
                                           2 * (flat.numel() // 64 + 1)))
        flat[at[::2]] = -0.0
        flat[at[1::2]] = float("nan")
    return x


def _same_values(a, b) -> bool:
    """NaN at the same positions and every other word bit for bit (the
    sign of zero included); a NaN's payload is not compared."""
    if not a.dtype.is_floating_point:
        return torch.equal(a, b)
    nan = a.isnan()
    word = torch.int32 if a.element_size() == 4 else torch.int64
    return (torch.equal(nan, b.isnan())
            and torch.equal(a[~nan].view(word), b[~nan].view(word)))


@pytest.mark.parametrize("op,dtype", [
    ("sum", torch.float32), ("sum", torch.float64), ("sum", torch.int32),
    ("min", torch.float32), ("min", torch.int32), ("max", torch.float32),
    ("max", torch.float64), ("fill", torch.float32), ("fill", torch.int32),
    ("fill", torch.float64)])
@pytest.mark.parametrize("batch", [1, 3])
def test_seg_scan_kernel_matches_plain(card, op, dtype, batch):
    """Path D's 8 stages at the card's tile on a rank plane, with -0.0
    and NaN in the float payloads (a stage adds 0 where its mask is off,
    so -0.0 turns +0.0; a NaN operand wins min and max)."""
    from flow_updating_tpu_torch.ops import fused_passes as fp

    rng = np.random.default_rng(5)
    P = 1 << 16
    geom = fp.geometry(P)
    dist = torch.from_numpy(_dist_plane(rng, P, 200)).to(card)
    dists = tuple(1 << k for k in range(8))
    x = _payload(rng, (batch, P), dtype, special=True).to(card)
    if op == "fill":
        before = fp.fill_pass.launches
        got = fp.fill_pass(x, dist, dists, geom)
        ref = fp.fill_pass_plain(x, dist, dists, geom)
        assert fp.fill_pass.launches - before == 1
    else:
        before = fp.segscan_pass.launches
        got = fp.segscan_pass(x, dist, dists, op, geom)
        ref = fp.segscan_pass_plain(x, dist, dists, op, geom)
        assert fp.segscan_pass.launches - before == 1
    assert _same_values(got, ref)


@pytest.mark.parametrize("log2_tile", range(13))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.int32])
@pytest.mark.parametrize("batch", [1, 3])
def test_seg_scan_window_kernel_every_tile(card, log2_tile, dtype, batch):
    """B4's scan window kernel against dist_pass_plain at every tile from
    1 to 4,096 elements (four tiles, tile 0 included), every op, random
    dist planes, -0.0 and NaN in the float payloads, aligned (packs of 16
    bytes) and unaligned (one value a pack): ascending powers of two
    below the tile (a chunk and its halo) and random lists of 1, 8 and 32
    distances below 2 tile (halos up to the whole window, which the C
    entry takes though no plan makes them)."""
    from flow_updating_tpu_torch.ops import fused_passes as fp

    tile = 1 << log2_tile
    geom = _tiles_geometry(tile, 4)
    rng = np.random.default_rng(90 + log2_tile)
    lists = [tuple(int(d) for d in rng.integers(1, 2 * tile, size=k))
             for k in (1, 8, 32)]
    if tile > 1:
        lists.append(tuple(1 << k for k in range(log2_tile)))
    for dists in lists:
        dist = torch.from_numpy(rng.integers(-2**31, 2**31, geom.P,
                                             dtype=np.int64)
                                .astype(np.int32)).to(card)
        dp = fp.DistPass("window", dists)
        for op in fp.SCAN_OPS:
            x = _payload(rng, (batch, geom.P), dtype, special=True).to(card)
            want = fp.dist_pass_plain(x, dist, dp, op, geom)
            shifted = torch.empty(batch * geom.P + 1, dtype=dtype,
                                  device=card)
            shifted[1:] = x.reshape(-1)
            for payload in (x, shifted[1:].view(batch, geom.P)):
                got = fp._launch_dist(payload, dist, dp, op, geom,
                                      "segscan_pass")
                assert _same_values(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.int32])
@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("n_stages", [8, 13])
def test_fill_kernel_on_a_random_plane(card, dtype, batch, n_stages):
    """B4's fill on a dist plane that is no rank plane (random words, any
    bit): equal to fill_pass_plain, one launch per pass (13 stages: two
    window passes and a wide one)."""
    from flow_updating_tpu_torch.ops import fused_passes as fp

    rng = np.random.default_rng(7)
    P = 1 << 16
    geom = fp.geometry(P)
    dist = torch.from_numpy(rng.integers(-2**31, 2**31, P, dtype=np.int64)
                            .astype(np.int32)).to(card)
    dists = tuple(1 << k for k in range(n_stages))
    x = _payload(rng, (batch, P), dtype).to(card)
    before = fp.fill_pass.launches
    got = fp.fill_pass(x, dist, dists, geom)
    assert (fp.fill_pass.launches - before
            == len(fp.plan_dist_passes(dists, geom)))
    assert torch.equal(got, fp.fill_pass_plain(x, dist, dists, geom))


@pytest.mark.parametrize("op", ["sum", "min", "fill"])
def test_seg_scan_split_passes_equal_stage_loop(card, op):
    """A hub of degree 5,000 needs 13 stages: two window passes and one
    wide launch on the card, equal to the plain passes and to the
    unsplit stage loop over the whole row."""
    from flow_updating_tpu_torch.ops import fused_passes as fp

    rng = np.random.default_rng(6)
    P = 1 << 15
    dist_np = np.zeros(P, np.int32)
    dist_np[100:5100] = np.arange(5000)
    dist = torch.from_numpy(dist_np).to(card)
    geom = fp.geometry(P)
    dists = tuple(1 << k for k in range(13))
    kinds = [dp.kind for dp in fp.plan_dist_passes(dists, geom)]
    assert kinds == ["window", "window", "wide"]
    x = _payload(rng, (2, P), torch.float64).to(card)
    loop = x.clone()
    for d in dists:
        loop = fp.dist_stage(loop, torch.roll(loop, d, -1), dist, d, op)
    if op == "fill":
        got = fp.fill_pass(x, dist, dists, geom)
        ref = fp.fill_pass_plain(x, dist, dists, geom)
    else:
        got = fp.segscan_pass(x, dist, dists, op, geom)
        ref = fp.segscan_pass_plain(x, dist, dists, op, geom)
    assert torch.equal(got, ref)
    assert torch.equal(got, loop)


def test_segment_reduce_is_deterministic_on_card(card):
    from flow_updating_tpu_torch.ops.segment import segment_sum

    topo = barabasi_albert(20000, 6, seed=2)
    deg = torch.from_numpy(topo.out_deg).to(card)
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        -1, 1, topo.num_edges)).to(card, torch.float32)
    runs = [segment_sum(x, deg) for _ in range(3)]
    assert all(torch.equal(runs[0], r) for r in runs[1:])


@pytest.mark.parametrize("variant,maker", [("collectall", "reference"),
                                           ("pairwise", "reference"),
                                           ("pairwise", "fast")])
def test_edge_round_benes_fused_on_card_equals_benes(card, variant, maker):
    from flow_updating_tpu_torch.ops import fused_passes as fp

    topo = barabasi_albert(3000, 4, seed=3)
    est = {}
    for seg, dlv in (("benes_fused", "benes_fused"), ("benes", "benes"),
                     ("segment", "gather")):
        if maker == "fast":
            dlv = "gather"
        cfg = getattr(RoundConfig, maker)(variant, segment_impl=seg,
                                          delivery=dlv, dtype="float64",
                                          drop_rate=0.1)
        before = fp.segscan_pass.launches + fp.fill_pass.launches
        eng = Engine(config=cfg).set_topology(topo).build(seed=3)
        eng.run_rounds(60)
        est[seg] = eng.estimates()
        launched = fp.segscan_pass.launches + fp.fill_pass.launches - before
        assert (launched > 0) == (seg == "benes_fused")
    assert np.array_equal(est["benes_fused"], est["benes"])
    np.testing.assert_allclose(est["benes"], est["segment"], rtol=1e-9,
                               atol=1e-9)


# ---- kernel B5: the sharded banded round ---------------------------------

def _sharded_kernel(topo, shards, device, exchange="pallas", dtype="float64"):
    from flow_updating_tpu_torch.parallel.banded_sharded import (
        ShardedBandedKernel,
    )
    from flow_updating_tpu_torch.parallel.mesh import make_mesh

    cfg = RoundConfig.fast(kernel="node", spmv="banded_fused", dtype=dtype)
    return ShardedBandedKernel(topo, cfg, make_mesh(shards, device=device),
                               exchange=exchange)


def test_mesh_places_shards_round_robin_with_own_streams(card):
    from flow_updating_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(3)
    count = torch.cuda.device_count()
    assert mesh.devices == tuple(torch.device("cuda", s % count)
                                 for s in range(3))
    assert len({s.cuda_stream for s in mesh.streams}) == 3
    assert all(s.device == d for s, d in zip(mesh.streams, mesh.devices))
    assert make_mesh(2, device="cuda:0").devices == (torch.device(
        "cuda", 0),) * 2


@pytest.mark.parametrize("graph", ["ring", "grid"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_sharded_round_kernel_matches_plain(card, graph, dtype):
    from flow_updating_tpu_torch.ops import sharded_round as sr
    from flow_updating_tpu_torch.topology.generators import grid2d

    topo = ring(20000, 2) if graph == "ring" else grid2d(64, 64)
    k = _sharded_kernel(topo, 2, card, dtype=dtype)
    spec, sh = k.spec, k._shards[1]
    L, H, R = spec.local, spec.halo, spec.local_rows
    rng = np.random.default_rng(5)
    dt = getattr(torch, dtype)
    vec = lambda n=L: torch.from_numpy(  # noqa: E731
        rng.uniform(-1, 1, n)).to(card, dt)
    S, G, avp, ap = (vec() for _ in range(4))
    lo, hi = vec(H), vec(H)
    before = sr.sharded_fire.launches
    avg = sr.sharded_fire(sh.value, S, ap, sh.inv_depp1, sh.leaves, spec)
    assert sr.sharded_fire.launches == before + 1
    assert torch.equal(avg, sr.sharded_fire_plain(sh.value, S, ap,
                                                  sh.inv_depp1))
    want = sr.sharded_round_plain(S, G, avp, ap, sh.deg, avg, lo, hi,
                                  sh.leaves, spec, 0, R)
    # the folded fire: the next round's avg from the S' and A just written
    want_next = sr.sharded_fire_plain(sh.value, want[0], want[2],
                                      sh.inv_depp1)
    inner, outer = sr.row_ranges(spec, "pallas")
    # each schedule is a list of launches, each launch one or two ranges
    for launches in ([((0, R),)], [((0, 1),), ((1, R - 5),), ((R - 5, R),)],
                     [((0, 1), (1, R - 5)), ((R - 5, R),)],
                     ([inner] if inner else []) + [outer]):
        for alias in (False, True):
            out = [torch.full((L,), float("nan"), dtype=dt, device=card)
                   for _ in range(3)]
            # avg_next in a buffer of its own, or written over avg_prev
            nxt = avp.clone() if alias else torch.full_like(avp,
                                                            float("nan"))
            prev = nxt if alias else avp
            before = sr.sharded_round.launches
            for ranges in launches:
                sr.sharded_round(S, G, prev, ap, sh.deg, avg, lo, hi,
                                 sh.leaves, spec, *ranges[0], out + [nxt],
                                 rows2=ranges[1] if len(ranges) > 1
                                 else None, fire=(sh.value, sh.inv_depp1))
            torch.cuda.synchronize()
            assert sr.sharded_round.launches == before + len(launches)
            for g, w in zip(out, want):
                assert torch.equal(g, w)
            assert torch.equal(nxt, want_next)
    out = out + [nxt]
    with pytest.raises(ValueError, match="contiguous"):
        sr.sharded_round(S, G.cpu(), avp, ap, sh.deg, avg, lo, hi,
                         sh.leaves, spec, 0, R, out,
                         fire=(sh.value, sh.inv_depp1))
    with pytest.raises(ValueError, match="contiguous"):
        sr.sharded_round(S, G, avp, ap, sh.deg, avg, lo[:-1], hi,
                         sh.leaves, spec, 0, R, out,
                         fire=(sh.value, sh.inv_depp1))
    with pytest.raises(ValueError, match="contiguous"):
        sr.sharded_round(S, G, avp, ap, sh.deg, avg, lo, hi, sh.leaves,
                         spec, 0, R, out, fire=(sh.value.cpu(),
                                                sh.inv_depp1))


@pytest.mark.parametrize("shards", [2, 3, 4])
def test_sharded_exchanges_equal_on_one_card(card, shards):
    from flow_updating_tpu_torch.ops import sharded_round as sr
    from flow_updating_tpu_torch.topology.generators import grid2d

    for topo in (ring(20000, 2), grid2d(64, 64), community(4000, 8, seed=0)):
        est = {}
        for exchange in ("ppermute", "pallas"):
            k = _sharded_kernel(topo, shards, None, exchange)
            before = sr.sharded_fire.launches + sr.sharded_round.launches
            st = k.run(k.init_state(), 30)
            launched = (sr.sharded_fire.launches + sr.sharded_round.launches
                        - before)
            # the merges of every round, and one fire per shard where the
            # state was made
            assert launched == 30 * shards * sr.launches_per_shard_round(
                k.spec, exchange) + shards
            est[exchange] = [torch.cat([t.cpu() for t in getattr(st, f)])
                             for f in ("S", "G", "avg_prev", "A_prev")]
        for a, b in zip(est["ppermute"], est["pallas"]):
            assert torch.equal(a, b)


def test_sharded_ring_equals_single_device_banded_fused_on_card(card):
    topo = ring(20000, 2)
    cfg = RoundConfig.fast(kernel="node", spmv="banded_fused")
    single = NodeKernel(topo, cfg, device=card)
    es = single.estimates(single.run(single.init_state(), 40))
    for shards in (2, 4):
        k = _sharded_kernel(topo, shards, None, "pallas", dtype="float32")
        host = _sharded_kernel(topo, shards, "cpu", "pallas", "float32")
        got = k.estimates(k.run(k.init_state(), 40))
        assert np.array_equal(got, es)
        assert np.array_equal(got, host.estimates(host.run(
            host.init_state(), 40)))


# ---- kernel B6: the halo block pull and its fused merge -------------------

def _halo_blocks(rng, S, offsets, rows, dt, device, hd=(7, 300, 5)):
    """Random per-shard payload blocks: shard s, offset i -> (rows, Hd_i)."""
    return [[torch.from_numpy(rng.uniform(-1, 1, (rows, hd[i % len(hd)])))
             .to(device, dt) for i in range(len(offsets))]
            for _ in range(S)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nf", [1, 3])
@pytest.mark.parametrize("D", [1, 3])
def test_halo_exchange_kernel_matches_plain(card, dtype, nf, D):
    from flow_updating_tpu_torch.ops import halo_exchange as hx

    rng = np.random.default_rng(11)
    S, offsets, Eb = 4, (1, 2, 3), 5000
    feat = (nf,) if nf > 1 else ()
    blocks = _halo_blocks(rng, S, offsets, 2 * nf + 1, dtype, card)
    draw = lambda shape: torch.from_numpy(  # noqa: E731
        rng.uniform(-1, 1, shape)).to(card, dtype)
    hit = torch.from_numpy(rng.random((D, Eb)) < 0.3).to(card)
    valid = torch.from_numpy(rng.random((D, Eb)) < 0.5).to(card)
    merge = (hit, draw((Eb,) + feat), draw((Eb,) + feat),
             draw((D, Eb) + feat), draw((D, Eb) + feat), valid)
    for me in range(S):
        before = (hx.fused_exchange_merge.launches,
                  hx.remote_block_exchange.launches)
        got = hx.fused_exchange_merge(blocks, offsets, me, *merge)
        pull = hx.remote_block_exchange(blocks, offsets, me)
        torch.cuda.synchronize()
        assert (hx.fused_exchange_merge.launches,
                hx.remote_block_exchange.launches) == (before[0] + 1,
                                                       before[1] + 1)
        want = hx.fused_exchange_merge_plain(blocks, offsets, me, *merge)
        for g, p, w in zip(got[0], pull, want[0]):
            assert torch.equal(g, w) and torch.equal(p, w)
        for g, w in zip(got[1:], want[1:]):
            assert torch.equal(g, w)
    with pytest.raises(ValueError, match="mix of devices"):
        hx.fused_exchange_merge(blocks, offsets, 0, hit.cpu(), *merge[1:])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nf", [1, 3])
def test_halo_exchange_kernel_odd_shapes(card, dtype, nf):
    """Row tails (Eb off every pack), rows off the 16-byte grid, one-cell
    rows, blocks of odd length and of none, sources off the 16-byte grid
    (a scalar head) and sources and destinations that disagree mod 16
    (copied by element), 32 offsets in one launch."""
    from flow_updating_tpu_torch.ops import halo_exchange as hx

    rng = np.random.default_rng(13)
    feat = (nf,) if nf > 1 else ()
    draw = lambda shape: torch.from_numpy(  # noqa: E731
        rng.uniform(-1, 1, shape)).to(card, dtype)

    def block(rows, hd, skew):
        buf = draw(rows * hd + skew)
        return buf[skew:].view(rows, hd)

    for D, Eb in ((1, 1), (2, 17), (3, 4099), (1, 100_003)):
        offsets = tuple(range(1, 33)) if Eb == 17 else (1, 2, 3)
        S = 33 if Eb == 17 else 4
        rows = 2 * nf + 1
        blocks = [[block(rows, (2 * i + 1) * (s % 3), (s + i) % 3)
                   for i in range(len(offsets))] for s in range(S)]
        merge = (torch.from_numpy(rng.random((D, Eb)) < 0.3).to(card),
                 draw((Eb,) + feat), draw((Eb,) + feat),
                 draw((D, Eb) + feat), draw((D, Eb) + feat),
                 torch.from_numpy(rng.random((D, Eb)) < 0.5).to(card))
        for me in (0, S - 1):
            got = hx.fused_exchange_merge(blocks, offsets, me, *merge)
            pull = hx.remote_block_exchange(blocks, offsets, me)
            torch.cuda.synchronize()
            want = hx.fused_exchange_merge_plain(blocks, offsets, me, *merge)
            for g, p, w in zip(got[0], pull, want[0]):
                assert torch.equal(g, w) and torch.equal(p, w)
            for g, w in zip(got[1:], want[1:]):
                assert torch.equal(g, w)


def test_halo_overlap_pallas_equals_ppermute_on_card(card):
    import dataclasses

    from flow_updating_tpu_torch.ops import halo_exchange as hx
    from flow_updating_tpu_torch.parallel import sharded
    from flow_updating_tpu_torch.parallel.mesh import make_mesh
    from flow_updating_tpu_torch.topology.generators import erdos_renyi

    topo = erdos_renyi(3000, 6.0, seed=2)
    mesh = make_mesh(4)
    for cfg in (dataclasses.replace(RoundConfig.reference(delay_depth=2),
                                    drop_rate=0.2),
                RoundConfig.fast("pairwise", dtype="float64")):
        plan = sharded.plan_sharding(topo, 4, partition="bfs",
                                     coloring=cfg.needs_coloring)
        out = {}
        for halo in ("ppermute", "allgather", "overlap", "overlap_pallas"):
            before = (hx.fused_exchange_merge.launches
                      + hx.remote_block_exchange.launches)
            st = sharded.init_plan_state(plan, cfg, mesh, seed=1)
            out[halo] = sharded.run_rounds_sharded(st, plan, cfg, mesh, 120,
                                                   halo=halo).numpy()
            launched = (hx.fused_exchange_merge.launches
                        + hx.remote_block_exchange.launches - before)
            assert launched == (120 * 4 if halo == "overlap_pallas" else 0)
        for halo in ("allgather", "overlap", "overlap_pallas"):
            for name, leaf in out["ppermute"].items():
                assert np.array_equal(leaf, out[halo][name]), (halo, name)
        host = sharded.init_plan_state(plan, cfg, make_mesh(4, device="cpu"),
                                       seed=1)
        host = sharded.run_rounds_sharded(host, plan, cfg,
                                          make_mesh(4, device="cpu"), 120,
                                          halo="overlap_pallas").numpy()
        np.testing.assert_allclose(host["flow"], out["ppermute"]["flow"],
                                   rtol=1e-6, atol=1e-6)


def test_engine_halo_every_mode_on_card(card):
    from flow_updating_tpu_torch.parallel.mesh import make_mesh
    from flow_updating_tpu_torch.topology.generators import erdos_renyi

    topo = erdos_renyi(2000, 6.0, seed=5)
    for cfg in (RoundConfig.reference(dtype="float64"),
                RoundConfig.fast("pairwise", dtype="float64")):
        for partition in ("bfs", "contiguous"):
            est = {}
            for halo in ("ppermute", "allgather", "overlap",
                         "overlap_pallas", "auto"):
                e = Engine(config=cfg, mesh=make_mesh(4), multichip="halo",
                           halo=halo, partition=partition)
                e.set_topology(topo).build().run_rounds(60)
                assert e.state.shards[0].flow.device.type == "cuda"
                est[halo] = e.estimates()
                assert e.halo_report()["resolved"] != "auto"
            for halo, got in est.items():
                assert np.array_equal(got, est["ppermute"]), halo


# ---- robust modes, contention and value states (slice 11) ----------------

@pytest.mark.parametrize("variant,maker,knob", [
    ("collectall", "reference", dict(robust="trim", robust_tol=0.05)),
    ("collectall", "fast", dict(robust="clip", robust_clip=0.02)),
    ("pairwise", "fast", dict(robust="clip", robust_clip=0.02)),
    ("pairwise", "fast", dict(robust="trim", robust_tol=0.05))])
def test_robust_edge_round_benes_fused_equals_its_twins_on_card(
        card, variant, maker, knob):
    """Path G at a small size: the robust round through B3 and B4 (the
    trim's float max and min and int32 min scans) equals the per-stage
    networks bit for bit and the segment/gather round to 1e-9."""
    from flow_updating_tpu_torch.ops import fused_passes as fp

    topo = barabasi_albert(3000, 4, seed=3)
    est = {}
    for seg, dlv in (("benes_fused", "benes_fused"), ("benes", "benes"),
                     ("segment", "gather")):
        cfg = getattr(RoundConfig, maker)(variant, segment_impl=seg,
                                          delivery=dlv, dtype="float64",
                                          timeout=10, **knob)
        before = fp.segscan_pass.launches
        eng = Engine(config=cfg).set_topology(topo).build(seed=3)
        eng.run_rounds(40)
        est[seg] = eng.estimates()
        assert (fp.segscan_pass.launches > before) == (seg == "benes_fused")
    assert np.array_equal(est["benes_fused"], est["benes"])
    np.testing.assert_allclose(est["benes"], est["segment"], rtol=1e-9,
                               atol=1e-9)


def test_edge_delays_twice_equal_on_card(card):
    """The water-fill's float sums run in the link-major CSR's order: two
    runs give the same delays, and the card's equal the host's."""
    from flow_updating_tpu_torch.models import rounds
    from flow_updating_tpu_torch.topology.graph import build_topology

    topo = fat_tree(8)
    pairs = np.stack([topo.src, topo.dst], 1)[topo.src < topo.dst]
    route = {(int(u), int(v)): (int(u), int(v)) for u, v in pairs}
    linked = build_topology(
        topo.num_nodes, pairs, values=topo.values,
        latency_s={k: 1.0 for k in route}, latency_scale=1.0,
        msg_bytes=104.0, route_links=route,
        link_caps=np.full(topo.num_nodes, 104.0 / 0.05),
        link_shared=np.ones(topo.num_nodes, bool))
    rng = np.random.default_rng(0)
    send = torch.from_numpy(rng.random(linked.num_edges) < 0.6)
    inflight = torch.from_numpy(rng.integers(0, 3, linked.num_edges)
                                .astype(np.int32))
    arrays = {d: linked.device_arrays(device=d) for d in ("cpu", card)}
    for iters in (0, 4):
        cfg = RoundConfig.reference(delay_depth=64, contention=True,
                                    contention_iters=iters,
                                    contention_backlog=True)
        runs = [rounds.edge_delays(arrays[card], cfg, send.to(card),
                                   inflight=inflight.to(card))
                for _ in range(2)]
        assert torch.equal(runs[0], runs[1])
        host = rounds.edge_delays(arrays["cpu"], cfg, send,
                                  inflight=inflight)
        assert torch.equal(runs[0].cpu(), host)


def test_sharded_state_is_a_value_on_card(card):
    """C1 on the card: running twice from a retained state gives equal
    leaves, and an old state still reads back its own round."""
    k = _sharded_kernel(ring(20000, 2), 4, None, "pallas", "float32")

    def leaves(st):
        return [torch.cat([t.cpu() for t in getattr(st, f)])
                for f in ("S", "G", "avg_prev", "A_prev", "avg")]

    st0 = k.init_state()
    st5 = k.run(st0, 5)
    want0, want5 = leaves(st0), leaves(st5)
    k.run(st5, 7)
    again = k.run(st0, 5)
    for a, b in zip(leaves(again), want5):
        assert torch.equal(a, b)
    for a, b in zip(leaves(st0), want0):
        assert torch.equal(a, b)
    for a, b in zip(leaves(k.run(st5, 3)), leaves(k.run(st0, 8))):
        assert torch.equal(a, b)


def _states_equal(a, b) -> bool:
    na, nb = a.numpy(), b.numpy()
    return na.keys() == nb.keys() and all(
        np.array_equal(na[k], nb[k]) for k in na)


@pytest.mark.parametrize("cfg", [
    RoundConfig.reference("collectall", delay_depth=2, drop_rate=0.1,
                          segment_impl="benes_fused",
                          delivery="benes_fused"),
    RoundConfig.fast("pairwise", segment_impl="benes_fused"),
])
def test_edge_checkpoint_restores_on_card_bit_for_bit(card, tmp_path, cfg):
    """A card-resident edge state saves, restores onto the card (no host
    fallback) and continues bit for bit."""
    topo = barabasi_albert(600, 3, seed=4)
    a = Engine(config=cfg).set_topology(topo).build(seed=3).run_rounds(60)
    path = str(tmp_path / "edge.npz")
    a.save_checkpoint(path)
    b = Engine().set_topology(topo).restore_checkpoint(path)
    assert b.config == cfg
    assert all(t.device.type == "cuda" for t in vars(b.state).values())
    a.run_rounds(25)
    b.run_rounds(25)
    assert _states_equal(a.state, b.state)


@pytest.mark.parametrize("spmv", ["pallas", "banded_fused", "benes_fused"])
def test_node_checkpoint_restores_on_card_bit_for_bit(card, tmp_path, spmv):
    cfg = RoundConfig.fast(kernel="node", spmv=spmv)
    topo = fat_tree(8) if spmv != "banded_fused" else ring(5000, 2)
    a = Engine(config=cfg).set_topology(topo).build().run_rounds(9)
    path = str(tmp_path / "node.npz")
    a.save_checkpoint(path)
    b = Engine().set_topology(topo).restore_checkpoint(path)
    assert b.state.S.device.type == "cuda"
    a.run_rounds(11)
    b.run_rounds(11)
    for f in ("S", "G", "avg_prev", "A_prev"):
        assert torch.equal(getattr(a.state, f), getattr(b.state, f)), f


def test_mesh_checkpoints_restore_on_card(card, tmp_path):
    """The sharded banded round and the halo round restore onto their
    card meshes and continue bit for bit (the halo state compared in the
    canonical layout, keys aside: the gather keeps shard 0's)."""
    from flow_updating_tpu_torch.parallel import sharded
    from flow_updating_tpu_torch.parallel.mesh import make_mesh

    path = str(tmp_path / "mesh.npz")
    cfg = RoundConfig.fast(kernel="node", spmv="banded_fused")
    topo = ring(20000, 2)
    a = Engine(config=cfg, mesh=make_mesh(4), halo="overlap")
    a.set_topology(topo).build().run_rounds(12).save_checkpoint(path)
    b = Engine(mesh=make_mesh(4), halo="overlap").set_topology(topo)
    b.restore_checkpoint(path)
    a.run_rounds(8)
    b.run_rounds(8)
    for f in ("S", "G", "avg_prev", "A_prev", "avg"):
        for x, y in zip(getattr(a.state, f), getattr(b.state, f)):
            assert x.device.type == "cuda" and torch.equal(x, y), f
    hcfg = RoundConfig.reference("collectall")
    htopo = barabasi_albert(800, 3, seed=2)
    h = Engine(config=hcfg, mesh=make_mesh(4), multichip="halo",
               halo="overlap_pallas").set_topology(htopo).build()
    h.run_rounds(60).save_checkpoint(path)
    g = Engine(mesh=make_mesh(4), multichip="halo", halo="overlap_pallas")
    g.set_topology(htopo).restore_checkpoint(path)
    h.run_rounds(20)
    g.run_rounds(20)
    ca = sharded.gather_full_state(h.state, h._halo_plan, htopo).numpy()
    cb = sharded.gather_full_state(g.state, g._halo_plan, htopo).numpy()
    for k in ca:
        if k != "key":
            assert np.array_equal(ca[k], cb[k]), k


def test_faults_keep_the_state_on_card(card):
    topo = ring(64, 2)
    e = Engine(config=RoundConfig.reference("collectall", delay_depth=2))
    e.set_topology(topo).build().run_rounds(55)
    e.kill_nodes([3, 7]).fail_links([(0, 1)])
    assert e.state.alive.device.type == "cuda"
    assert e.state.edge_ok.device.type == "cuda"
    assert int(e.state.alive.sum()) == 62
    assert int(e.state.edge_ok.sum()) == topo.num_edges - 2
    host = Engine(config=e.config, device="cpu").set_topology(topo).build()
    host.run_rounds(55).kill_nodes([3, 7]).fail_links([(0, 1)])
    e.run_rounds(40).revive_nodes([3, 7]).restore_links([(0, 1)])
    host.run_rounds(40).revive_nodes([3, 7]).restore_links([(0, 1)])
    e.run_rounds(40)
    host.run_rounds(40)
    np.testing.assert_allclose(e.estimates(), host.estimates(), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("gen,args", [("ring", (1000, 2)),
                                      ("grid2d", (40, 30)),
                                      ("torus2d", (30, 40)),
                                      ("hypercube", (12,)),
                                      ("complete", (300,)),
                                      ("fat_tree", (16,))])
def test_structured_on_card_every_generator(card, gen, args):
    """spmv='structured' runs on the card on every structured generator:
    float64 within 1e-12 of the host run and of the card's gather route."""
    from flow_updating_tpu_torch.topology import generators

    topo = getattr(generators, gen)(*args, seed=2)
    cfg = RoundConfig.fast(kernel="node", spmv="structured", dtype="float64")
    on_card = Engine(config=cfg).set_topology(topo).build().run_rounds(40)
    assert on_card.state.S.device.type == "cuda"
    host = Engine(config=cfg, device="cpu").set_topology(topo).build()
    gather = Engine(config=RoundConfig.fast(kernel="node", spmv="xla",
                                            dtype="float64"))
    gather.set_topology(topo).build().run_rounds(40)
    np.testing.assert_allclose(on_card.estimates(),
                               host.run_rounds(40).estimates(),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(on_card.estimates(), gather.estimates(),
                               rtol=1e-12, atol=1e-12)


def test_virtual_fat_tree_on_card_equals_materialized(card):
    from flow_updating_tpu_torch.topology.generators import fat_tree as ft

    cfg = RoundConfig.fast(kernel="node", spmv="structured")
    runs = [Engine(config=cfg).set_topology(ft(32, materialize_edges=m))
            .build().run_rounds(30) for m in (True, False)]
    a, b = (e._node_kernel.arrays.value + e.state.G for e in runs)
    assert torch.equal(a, b)


def test_pod_kernel_on_card(card, tmp_path):
    """The pod stencil over make_mesh(4) on the card: overlap equals the
    plain schedule bit for bit, float64 within 1e-12 of one device, and
    its archive resumes on one device within 1e-12."""
    from flow_updating_tpu_torch.parallel.mesh import make_mesh
    from flow_updating_tpu_torch.topology.generators import fat_tree as ft

    topo = ft(16, materialize_edges=False)
    cfg = RoundConfig.fast(kernel="node", spmv="structured", dtype="float64")
    runs = {}
    for halo in ("ppermute", "overlap"):
        e = Engine(config=cfg, mesh=make_mesh(4), multichip="pod",
                   halo=halo).set_topology(topo).build().run_rounds(40)
        assert all(g.device.type == "cuda" for g in e.state.G)
        runs[halo] = e
    assert np.array_equal(runs["ppermute"].estimates(),
                          runs["overlap"].estimates())
    one = Engine(config=cfg).set_topology(topo).build().run_rounds(40)
    np.testing.assert_allclose(runs["overlap"].estimates(), one.estimates(),
                               rtol=1e-12, atol=1e-12)
    path = str(tmp_path / "pod.npz")
    runs["overlap"].save_checkpoint(path)
    back = Engine().set_topology(topo).restore_checkpoint(path)
    assert back.state.S.device.type == "cuda"
    runs["overlap"].run_rounds(20)
    back.run_rounds(20)
    np.testing.assert_allclose(back.estimates(),
                               runs["overlap"].estimates(),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_sharded_benes_launches_b3_per_shard_on_card(card, dtype):
    """Engine(mesh=make_mesh(4), spmv='benes_fused') launches B3 once per
    pass on each shard, and equals the single-device benes_fused round on
    the card bit for bit."""
    from flow_updating_tpu_torch.ops import fused_passes as fp
    from flow_updating_tpu_torch.parallel.mesh import make_mesh

    topo = barabasi_albert(3000, 4, seed=5)
    cfg = RoundConfig.fast(kernel="node", spmv="benes_fused", dtype=dtype)
    e = Engine(config=cfg, mesh=make_mesh(4)).set_topology(topo).build()
    wrappers = (fp.local_pass, fp.window_pass, fp.wide_pass, fp.wide2_pass)
    before = sum(w.launches for w in wrappers)
    e.run_rounds(12)
    passes = len(e._node_kernel.fused.passes)
    assert sum(w.launches for w in wrappers) - before == 12 * 4 * passes
    assert all(s.device.type == "cuda" for s in e.state.S)
    one = Engine(config=cfg).set_topology(topo).build().run_rounds(12)
    assert np.array_equal(e.estimates(), one.estimates())
