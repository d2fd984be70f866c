"""How kernel B3's local pass and kernel B4's fill run on the card, on the
CPU: each kernel's algorithm transcribed into torch and held bit for bit
against the plain version it must equal.

* The local kernel (``csrc/benes_pass.cu``, ``butterfly_pass``) runs the
  schedule of :func:`plan_local_schedule`: words in register, lane and
  warp slots, a register stage as a select between a thread's words, a
  lane stage as a shuffle, a re-layout through shared memory between
  segments.  The emulation below runs exactly those steps, at every tile
  from 2 to 4,096, on the k=160 neighbor-sum list and on random lists.
  The shared-memory swizzle is transcribed too, to check that every
  layout the planner makes is free of bank conflicts.
* The fill (``csrc/seg_scan.cu``, ``fill_walk_pass``) finds each output's
  source by walking the stages backwards; the transcription is held
  against ``fill_pass_plain`` on rank planes and on random planes, and
  against the JAX package's ``fill_pass`` in interpret mode.

The kernels themselves run only on the card (``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flow_updating_tpu.ops import pallas_fused as jfused
from flow_updating_tpu_torch.ops import fused_passes as fp

LANE = 128
#: the k=160 neighbor-sum plan's local pass (pass 20 of 27)
K160_LOCAL = tuple(1 << b for b in list(range(11, -1, -1)) + list(range(1, 12)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def _geometry(tile: int) -> fp.Geometry:
    """Four tiles of ``tile`` elements (one below a row of 128)."""
    if tile < LANE:
        return fp.geometry(tile)
    return fp.geometry(4 * tile, block_rows=tile // LANE)


def _stage_lists(tile: int, seed: int) -> list:
    """Random local stage lists of 1 to 32 stages (repeats allowed), the
    longest list, and the k=160 list where the tile takes it."""
    n = tile.bit_length() - 1
    rng = np.random.default_rng(seed)
    lists = [tuple(1 << int(b) for b in rng.integers(0, n, size=int(k)))
             for k in rng.integers(1, fp.MAX_STAGES_PER_PASS + 1, size=4)]
    lists.append(tuple(1 << int(b) for b in rng.integers(
        0, n, size=fp.MAX_STAGES_PER_PASS)))
    lists.append((1,))
    if tile == 4096:
        lists.append(K160_LOCAL)
    return lists


def _random_words(rng, shape, dtype):
    if dtype == torch.int32:
        return torch.from_numpy(rng.integers(-2**31, 2**31, shape,
                                             dtype=np.int64).astype(np.int32))
    return torch.from_numpy(rng.normal(size=shape)).to(dtype)


def _positions(layout, tile: int) -> torch.Tensor:
    """The tile position each slot holds under ``layout``."""
    slot = torch.arange(tile, dtype=torch.int64)
    pos = torch.zeros(tile, dtype=torch.int64)
    for i, b in enumerate(layout):
        pos |= ((slot >> i) & 1) << b
    return pos


def emulate_local(x3, plane, ps, geom):
    """B3's local kernel as its schedule runs it: ``v[..., s]`` is the
    word in slot ``s``; a stage on slot bit i takes the word of slot
    ``s ^ 2**i`` (a register for i < r, the lane ``lane ^ 2**(i - r)`` for
    a lane bit) where bit j of the mask word at the slot's position is
    set; a change of layout stores every word at its position and loads
    the new layout's."""
    sched = fp.plan_local_schedule(ps.dists, geom.tile)
    T = geom.tile
    slot = torch.arange(T, dtype=torch.int64)
    masks = plane.reshape(geom.grid, T)
    layout = sched.layouts[0]
    pos = _positions(layout, T)
    v = x3[..., pos]
    bounds = zip(sched.layouts[1:], (0,) + sched.seg_end,
                 sched.seg_end + (len(ps.dists),))
    for nxt, lo, hi in bounds:
        if nxt != layout:
            tile_words = torch.empty_like(v)
            tile_words[..., pos] = v
            layout, pos = nxt, _positions(nxt, T)
            v = tile_words[..., pos]
        m = masks[:, pos]
        for j in range(lo, hi):
            i = sched.slots[j]
            assert i < sched.reg_bits + sched.lane_bits     # never a warp
            assert 1 << layout[i] == ps.dists[j]
            take = ((m >> j) & 1) != 0
            v = torch.where(take, v[..., slot ^ (1 << i)], v)
    out = torch.empty_like(x3)
    out[..., pos] = v
    return out


@pytest.mark.parametrize("log2_tile", range(1, 13))
@pytest.mark.parametrize("batch", [1, 3])
def test_local_schedule_equals_plain(log2_tile, batch):
    tile = 1 << log2_tile
    geom = _geometry(tile)
    rng = np.random.default_rng(100 * log2_tile + batch)
    for dists in _stage_lists(tile, log2_tile):
        ps = fp.PassSpec(kind="local", dists=dists, block_dist=0)
        plane = torch.from_numpy(rng.integers(-2**31, 2**31, geom.P,
                                              dtype=np.int64).astype(np.int32))
        for dtype in (torch.float64, torch.int32):
            x3 = _random_words(rng, (batch, geom.grid, tile), dtype)
            assert torch.equal(emulate_local(x3, plane, ps, geom),
                               fp.local_pass_plain(x3, plane, ps, geom))


def test_local_schedule_of_the_k160_list():
    """bits 11..3 | 2..0..8 | 9..11: two re-layouts; the tile comes in in
    the first segment's layout and leaves in the last one's, which is
    coalesced; the kernel's int array encodes the same schedule."""
    sched = fp.plan_local_schedule(K160_LOCAL, 4096)
    assert sched.seg_end == (9, 20, 23)
    bits = [d.bit_length() - 1 for d in K160_LOCAL]
    segments = [set(bits[lo:hi]) for lo, hi in
                zip((0, 9, 20), sched.seg_end)]
    assert segments == [set(range(3, 12)), set(range(9)), set(range(9, 12))]
    assert sched.exchanges == 2
    assert sched.layouts[0] == sched.layouts[1]
    assert sched.layouts[-1] == sched.layouts[-2]
    assert (sched.reg_bits, sched.lane_bits) == (4, 5)
    a = list(sched.c_ints)
    assert len(a) == fp.SCHED_INTS and a[0] == 3 and a[1:4] == [9, 20, 23]
    assert a[33:56] == list(sched.slots)
    for s, lay in enumerate(sched.layouts):
        assert tuple(a[65 + 12 * s: 77 + 12 * s]) == lay


def test_local_schedule_refuses_what_the_kernel_cannot_run():
    with pytest.raises(ValueError, match="power of two"):
        fp.plan_local_schedule((3,), 64)
    with pytest.raises(ValueError, match="below the tile"):
        fp.plan_local_schedule((64,), 64)
    with pytest.raises(ValueError, match="1 to 32"):
        fp.plan_local_schedule((1,) * 33, 64)
    with pytest.raises(ValueError, match="tile"):
        fp.plan_local_schedule((1,), 8192)


def _swizzle(p: np.ndarray, elem_bytes: int) -> np.ndarray:
    """The kernel's shared-memory address of position p."""
    if elem_bytes == 4:
        return p ^ (((p >> 5) ^ (p >> 10)) & 31)
    return p ^ (((p >> 4) ^ (p >> 8)) & 15)


@pytest.mark.parametrize("log2_tile", range(9, 13))
def test_local_layouts_are_conflict_free_and_coalesced(log2_tile):
    """Every layout the planner makes puts its lanes on 5 consecutive
    position bits: under the swizzle a warp's 32 words (4 bytes) fall in
    32 banks and a half warp's 16 words (8 bytes) in 16 bank pairs; the
    store layout writes 32 consecutive words per warp."""
    tile = 1 << log2_tile
    p = np.arange(tile, dtype=np.int64)
    for eb in (4, 8):
        assert np.array_equal(np.sort(_swizzle(p, eb)), p)
    for dists in _stage_lists(tile, 7 * log2_tile):
        sched = fp.plan_local_schedule(dists, tile)
        r, l = sched.reg_bits, sched.lane_bits
        for k, layout in enumerate(sched.layouts):
            pos = _positions(layout, tile).numpy().reshape(-1, 32, 1 << r)
            lanes = layout[r: r + l]
            assert list(lanes) == list(range(lanes[0], lanes[0] + l))
            banks4 = _swizzle(pos, 4) % 32
            assert all(len(set(banks4[w, :, k2])) == 32
                       for w in range(pos.shape[0]) for k2 in range(1 << r))
            pairs8 = _swizzle(pos, 8) % 16
            assert all(len(set(pairs8[w, h:h + 16, k2])) == 16
                       for w in range(pos.shape[0]) for h in (0, 16)
                       for k2 in range(1 << r))
            if k == len(sched.layouts) - 1:
                assert lanes[0] == 0
                assert np.array_equal(pos[:, :, 0] - pos[:, :1, 0],
                                      np.broadcast_to(np.arange(32),
                                                      pos[:, :, 0].shape))


# ---- the fill: the backward walk --------------------------------------------

def walk_fill(x, dist, dists, geom):
    """B4's fill as the kernels run it: a window pass by the backward walk
    (``fill_walk_pass``, its shared-memory halo from window position
    ``lo`` asserted), a wide pass as ``seg_wide_pass``'s select."""
    P, T = geom.P, geom.tile
    x2 = x.reshape(-1, P)
    p = torch.arange(P, dtype=torch.int64)
    for dp in fp.plan_dist_passes(dists, geom):
        if dp.kind == "wide":
            d = dp.dists[0]
            x2 = torch.where((dist & d) != 0, x2[:, (p - d) % P], x2)
            continue
        lo = max(T - sum(dp.dists), 0)
        blk = torch.arange(geom.grid, dtype=torch.int64)[:, None]
        prev = torch.clamp(blk - 1, min=0)
        w = (T + torch.arange(T, dtype=torch.int64)).expand(geom.grid, T)

        def g(w):
            return torch.where(w < T, prev * T + w, blk * T + (w - T))

        for d in reversed(dp.dists):
            take = (dist[g(w)] & d) != 0
            w = torch.where(take, (w - d) & (2 * T - 1), w)
            assert bool((w >= lo).all())
        x2 = x2[:, g(w).reshape(-1)]
    return x2.reshape(x.shape)


def _rank_plane(rng, P, max_run):
    """Each edge's rank in CSR rows of 1 to max_run - 1 edges, the last
    sixteenth padding (rank 0)."""
    ranks, n = [], 0
    while n < P:
        k = int(rng.integers(1, max_run))
        ranks.append(np.arange(k, dtype=np.int32))
        n += k
    rank = np.concatenate(ranks)[:P]
    rank[-(P // 16):] = 0
    return torch.from_numpy(rank)


def _random_plane(rng, P):
    return torch.from_numpy(rng.integers(-2**31, 2**31, P,
                                         dtype=np.int64).astype(np.int32))


FILL_GEOMETRIES = {
    "one_row": (64, None, 6),            # a network narrower than a row
    "rows_of_128": (1024, 1, 7),         # tile 128, 8 tiles
    "jax_test": (64 * LANE, 16, 6),      # tile 2,048, as the JAX tests
    "card_tile": (1 << 16, None, 8),     # tile 4,096, path D's 8 stages
    "split": (64 * LANE, 16, 13),        # window, window, wide
    "card_split": (1 << 15, None, 13),   # the hub's 13 stages
}


@pytest.mark.parametrize("name", sorted(FILL_GEOMETRIES))
@pytest.mark.parametrize("plane", ["rank", "random"])
@pytest.mark.parametrize("batch", [1, 3])
def test_fill_walk_equals_plain(name, plane, batch):
    P, block_rows, n_stages = FILL_GEOMETRIES[name]
    geom = fp.geometry(P, block_rows)
    dists = tuple(1 << k for k in range(n_stages))
    if name.endswith("split"):
        kinds = [dp.kind for dp in fp.plan_dist_passes(dists, geom)]
        assert kinds[-1] == "wide" and "window" in kinds
    rng = np.random.default_rng(len(name) + batch)
    dist = (_rank_plane(rng, P, 1 << n_stages) if plane == "rank"
            else _random_plane(rng, P))
    for dtype in (torch.float32, torch.int32):
        x = _random_words(rng, (batch, P), dtype)
        want = fp.fill_pass_plain(x, dist, dists, geom)
        assert torch.equal(walk_fill(x, dist, dists, geom), want)
        if plane == "rank":
            head = torch.arange(P, dtype=torch.int64) - dist.long()
            assert torch.equal(want, x[:, head])


@pytest.mark.parametrize("plane", ["rank", "random"])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_fill_walk_equals_jax_interpret(plane, dtype):
    """The walk against the JAX package's fill_pass (one Pallas call, in
    interpret mode) at the JAX test geometry, tile 0 included."""
    P = 64 * LANE
    rng = np.random.default_rng(11)
    dist = (_rank_plane(rng, P, 50) if plane == "rank"
            else _random_plane(rng, P))
    dists = tuple(1 << k for k in range(6))
    x = rng.normal(size=(2, P)).astype(dtype)
    want = np.asarray(jfused.fill_pass(jnp.asarray(x),
                                       jnp.asarray(dist.numpy()), dists,
                                       jfused.geometry(P, block_rows=16)))
    got = walk_fill(torch.from_numpy(x), dist, dists,
                    fp.geometry(P, block_rows=16))
    np.testing.assert_array_equal(got.numpy(), want)
