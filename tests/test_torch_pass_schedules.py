"""How kernel B3's local, window and wide2 passes and kernel B4's fill run
on the card, on the CPU: each kernel's algorithm transcribed into torch
and held bit for bit against the plain version it must equal.

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
* The window kernel (``window_walk_pass``) walks the same way over mask
  bits, on persistent blocks whose mask tiles rotate through a ring in
  shared memory; the transcription (ring included) is held against
  ``window_pass_plain`` at every tile and against the JAX package's
  ``_window_pass`` in interpret mode.
* The wide2 kernels (``wide2_swap_group``, ``wide2_roll_chain``,
  ``wide2_roll_gather``) and the wide kernels, their one-stage instances
  (``wide_pass_swap``, ``wide_pass_roll``), are transcribed thread by
  thread: which vectors each thread owns and loads, and the selects;
  held against ``wide2_pass_plain`` and ``wide_pass_plain``, and the
  wide pass against the JAX package's ``_wide_pass`` in interpret mode.
* The scan (``scan_chunk_pass``) runs the stages over a chunk of outputs
  and the halo below it, each stage over a shrinking range, between two
  shared-memory buffers; the transcription (the launch arithmetic
  included) is held against ``segscan_pass_plain`` and the window pass's
  plain version at every tile, and against the JAX package's
  ``segscan_pass`` in interpret mode.

The kernels themselves run only on the card (``tests/test_torch_cuda.py``).
"""

import math

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


# ---- B3's window pass: the backward walk ------------------------------------

def _many_tiles(tile: int, grid: int) -> fp.Geometry:
    """``grid`` tiles of ``tile`` elements, below a row of 128 too (the
    kernels take any power-of-two tile; the planner makes one tile of a
    network that narrow)."""
    return fp.Geometry(P=grid * tile, rows=max(grid * tile // LANE, 1),
                       block_rows=max(tile // LANE, 1), grid=grid)


#: mask tiles in the window kernel's shared-memory ring (benes_pass.cu,
#: kRing)
RING = 4


def window_ring(tiles: int, blocks: int) -> dict:
    """Where ``window_walk_pass`` finds each tile's window, block by block
    over an even split of the tiles: ``{tile: (k, slots)}``, tile i the
    block's k-th and ``slots`` the tile each ring slot holds while i is
    walked.  Asserts that a copy never overwrites a tile that is still to
    be read."""
    out = {}
    for j in range(blocks):
        t0, t1 = tiles * j // blocks, tiles * (j + 1) // blocks
        ring = [None] * RING
        ring[RING - 1] = max(t0 - 1, 0)
        ring[0] = t0
        if t0 + 1 < t1:
            ring[1] = t0 + 1
        for k, i in enumerate(range(t0, t1)):
            if i + 2 < t1:
                # the slot of the tile before i - 1 (tile 0 standing in
                # for tile -1)
                assert ring[(k + 2) % RING] in (None, max(i - 2, 0))
                ring[(k + 2) % RING] = i + 2
            out[i] = (k, tuple(ring))
    return out


def walk_window(x3, plane, ps, geom, blocks: int):
    """B3's window pass as ``window_walk_pass`` runs it on ``blocks``
    persistent blocks: each output walks the stages backwards, in ring
    positions (window positions mod 2 * tile where sum(d) reaches the
    tile), reading each mask word from the ring slot that holds it, and
    takes x at the window position it ends on."""
    T, grid = geom.tile, geom.grid
    wrap = sum(ps.dists) >= T
    rings = window_ring(grid, blocks)
    m = plane.reshape(grid, T)
    k = torch.tensor([rings[i][0] for i in range(grid)])[:, None]
    slots = torch.tensor([[-1 if t is None else t for t in rings[i][1]]
                          for i in range(grid)])
    base = (k + RING - 1) % RING * T             # ring position of the window
    prev = torch.gather(slots, 1, (k + RING - 1) % RING)
    own = torch.gather(slots, 1, k % RING)
    assert torch.equal(own[:, 0], torch.arange(grid))
    assert torch.equal(prev[:, 0], torch.clamp(torch.arange(grid) - 1, min=0))

    def word(r):
        """The mask word at ring position r: its slot must hold the
        window's tiles."""
        slot = r // T
        tile_at = torch.gather(slots, 1, slot)
        assert bool(((slot == k % RING) | (slot == (k + RING - 1) % RING))
                    .all())
        return m[tile_at, r % T]

    q = T + torch.arange(T).expand(grid, T)
    w = q if wrap else (base + q) % (RING * T)
    for j in reversed(range(len(ps.dists))):
        r = (base + w) % (RING * T) if wrap else w
        take = ((word(r) >> j) & 1) != 0
        w = torch.where(take, w - ps.dists[j], w)
        w = w & (2 * T - 1) if wrap else w % (RING * T)
    if not wrap:
        w = (w - base) % (RING * T)
    blk = torch.arange(grid)[:, None]
    src = torch.where(blk > 0, (blk - 1) * T + w, w & (T - 1))
    return x3.reshape(x3.shape[0], geom.P)[:, src.reshape(-1)].reshape(
        x3.shape)


def _roll_lists(tile: int, rng) -> list:
    """Random roll distances below the window (2 * tile), 1, 6, 17 and 32
    of them, repeats allowed."""
    return [tuple(int(d) for d in rng.integers(1, 2 * tile, size=k))
            for k in (1, 6, 17, 32)]


@pytest.mark.parametrize("log2_tile", range(1, 13))
@pytest.mark.parametrize("batch", [1, 3])
def test_window_walk_equals_plain(log2_tile, batch):
    tile = 1 << log2_tile
    geom = _many_tiles(tile, 8)
    rng = np.random.default_rng(300 + 10 * log2_tile + batch)
    lists = _roll_lists(tile, rng)
    # a sum below the tile: the walk runs in ring positions
    lists.append(tuple(max(tile // 64, 1) for _ in range(min(tile // 2, 6))))
    for blocks, dists in zip((1, 2, 3, 5, 8), lists):
        ps = fp.PassSpec(kind="window", dists=dists, block_dist=0)
        plane = _random_plane(rng, geom.P)
        for dtype in (torch.float32, torch.int32):
            x3 = _random_words(rng, (batch, geom.grid, tile), dtype)
            assert torch.equal(walk_window(x3, plane, ps, geom, blocks),
                               fp.window_pass_plain(x3, plane, ps, geom))


def test_window_ring_holds_each_tile_and_its_predecessor():
    """The mask ring of the persistent window kernel over every split of
    up to 40 tiles and the card's (2,048 tiles on a few hundred blocks):
    while tile i is walked its ring slots k - 1 and k hold tiles i - 1
    (tile 0 for tile 0) and i."""
    for tiles, blocks in [(t, b) for t in range(1, 41)
                          for b in range(1, t + 1)] + [(2048, 396)]:
        for i, (k, ring) in window_ring(tiles, blocks).items():
            assert ring[k % RING] == i
            assert ring[(k + RING - 1) % RING] == max(i - 1, 0)


@pytest.mark.parametrize("n_stages", [1, 6, 17])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_window_walk_equals_jax_interpret(n_stages, dtype):
    """The walk against the JAX package's _window_pass (one Pallas call,
    interpret mode) at the JAX test geometry (64 rows of 128, tiles of
    16 rows), on a random plane: distances below a row, or whole rows
    below the window (the JAX body rolls rows for those)."""
    P, R = 64 * LANE, 16
    T = R * LANE
    rng = np.random.default_rng(20 + n_stages)
    small = rng.integers(1, LANE, size=n_stages)
    rows = LANE * rng.integers(1, 2 * R, size=n_stages)
    dists = tuple(int(d) for d in np.where(rng.integers(0, 2, n_stages),
                                           small, rows))
    plane = _random_plane(rng, P)
    x = rng.normal(size=(3, P)).astype(dtype)
    jps = jfused.PassSpec(kind="window", dists=dists, block_dist=0)
    jplan = jfused.FusedPlan(geom=jfused.geometry(P, block_rows=R),
                             passes=(jps,))
    want = np.asarray(jfused._PASS_FNS["window"](
        jnp.asarray(x).reshape(3, P // LANE, LANE),
        jnp.asarray(plane.numpy().view(np.uint32).reshape(P // LANE, LANE)),
        jps, jplan, True)).reshape(3, P)
    geom = fp.geometry(P, block_rows=R)
    assert geom.tile == T
    ps = fp.PassSpec(kind="window", dists=dists, block_dist=0)
    got = walk_window(torch.from_numpy(x).reshape(3, geom.grid, T), plane,
                      ps, geom, blocks=3)
    np.testing.assert_array_equal(got.reshape(3, P).numpy(), want)


# ---- B3's wide and wide2 passes: vectors, swap groups, roll chains ---------

#: chain steps per thread and the largest (D1 + D2) / gcd of the chain
#: form (benes_pass.cu, kWide2Seg and kChainBudget)
WIDE2_SEG = 4
CHAIN_BUDGET = 3


def _pick(m, m_at2, own, at1, at2, at12):
    """wide2_pick on source positions: the own and the D2 partner's
    stage-1 bits, then the own stage-2 bit."""
    s1_own = np.where(m & 1, at1, own)
    s1_shift = np.where(m_at2 & 1, at12, at2)
    return np.where(m & 2, s1_shift, s1_own)


def _pick1(m, own, at1):
    """A wide pass's select (pick_vec's kOne): any non-zero mask byte
    takes the partner."""
    return np.where(m != 0, at1, own)


def emulate_wide(x3, plane, ps, geom, aligned: bool = True):
    """B3's wide and wide2 kernels as they run, thread by thread (see
    ``csrc/benes_pass.cu``): which vector of which tiles each thread
    owns, the x and mask vectors it loads, the selects.  A wide pass runs
    as the one-stage instance: a swap pair {i, i ^ D}, a roll chain of
    tiles mod D (D clamped to the tile count).  Every output is written
    once, every x vector is loaded once per batch row but for a roll
    chain segment's predecessors, and a roll chain reads tile 0 (where it
    clamps) only where a mask selects it: elsewhere its vectors are
    poison, which no output may take.  Returns ``(out, form, clamped)``,
    ``clamped`` the threads that read tile 0 for a clamped source."""
    T, grid, P = geom.tile, geom.grid, geom.P
    vec = 16 // x3.element_size()
    N = vec if T >= vec and aligned else 1
    vecs = T // N
    one = ps.kind in ("wide_swap", "wide_roll")
    D1 = ps.block_dist
    D2 = D1 if one else ps.block_dist2
    mask = plane.numpy().astype(np.int64)
    src = np.full(P, -1, np.int64)
    loaded = np.zeros(P, np.int64)     # x loads per word, predecessors apart
    clamped = 0

    def words(tile_idx, v):
        """(threads, N) positions of vector v of each tile."""
        return tile_idx[:, None] * T + v[:, None] * N + np.arange(N)

    def write(dst, s):
        assert (src[dst] == -1).all(), "an output written twice"
        src[dst] = s

    if ps.kind in ("wide_swap", "wide_swap2"):
        form = "swap_pair" if one else "swap_group"
        b1, b2 = D1.bit_length() - 1, D2.bit_length() - 1
        pair = D1 == D2
        G, k2 = (2, 1) if pair else (4, 2)
        t = np.arange((grid >> (1 if pair else 2)) * vecs)
        v, i0 = t % vecs, t // vecs
        lo, hi = min(b1, b2), max(b1, b2)
        i0 = ((i0 >> lo) << (lo + 1)) | (i0 & ((1 << lo) - 1))
        if not pair:
            i0 = ((i0 >> hi) << (hi + 1)) | (i0 & ((1 << hi) - 1))
        pos = [words(i0 ^ (D1 if k & 1 else 0) ^ (D2 if k & 2 else 0), v)
               for k in range(G)]
        m = [mask[q] for q in pos]
        for q in pos:
            np.add.at(loaded, q.ravel(), 1)
        for k in range(G):
            write(pos[k], _pick1(m[k], pos[k], pos[k ^ 1]) if one
                  else _pick(m[k], m[k ^ k2], pos[k], pos[k ^ 1],
                             pos[k ^ k2], pos[k ^ 1 ^ k2]))
    else:
        if one:     # B = 0: the single stage, D = g
            g, A, B = min(D1, grid), 1, 0
        else:
            g = math.gcd(D1, D2)
            A, B = D1 // g, D2 // g
        if one or (A + B <= CHAIN_BUDGET and g < grid):
            form = "roll_chain"
            H = A + B
            longest = -(-grid // g)
            seg = min(longest, WIDE2_SEG)
            t = np.arange(-(-longest // seg) * g * vecs)
            v, rest = t % vecs, t // vecs
            r, s0 = rest % g, rest // g * seg
            length = (grid - r + g - 1) // g
            cnt = np.minimum(seg, length - s0)     # <= 0: the thread returns

            def at(s, live):
                """The vector at chain step s where the thread loads it;
                off the grid only where it does not."""
                tiles = r + s * g
                assert (tiles[live & (s >= 0)] < grid).all()
                return words(np.clip(tiles, 0, grid - 1), v)

            zero = words(np.zeros_like(r), v)           # tile 0
            # mask vectors at steps >= 0 (a clamped D2 partner's bit does
            # not matter: both of its sources are tile 0)
            mw = [np.where(((j < B + cnt) & (s0 - B + j >= 0))[:, None],
                           mask[at(s0 - B + j, j < B + cnt)], 0)
                  for j in range(B + WIDE2_SEG)]
            # tile 0's x where a selected source clamps
            need0 = np.zeros(len(t), bool)
            for s in range(WIDE2_SEG):
                live = ((s < cnt) & (s0 + s < H))[:, None]
                m, m2 = mw[B + s], mw[s]
                if one:
                    sel = m != 0
                else:
                    b0, b1, c0 = (m & 1) != 0, (m & 2) != 0, (m2 & 1) != 0
                    sel = (b1 & c0) | (((s0 + s < A)[:, None]) & b0
                                       & ~b1) | (
                        ((s0 + s < B)[:, None]) & b1 & ~c0)
                need0 |= (live & sel).any(axis=1)
            clamped = int(need0.sum())
            poison = -1 - P                       # never a position
            xw = []
            for j in range(H + WIDE2_SEG):
                step = s0 - H + j
                live = j < H + cnt
                pos = at(step, live)
                if j >= H:
                    np.add.at(loaded, pos[live & (step >= 0)].ravel(), 1)
                neg = (step < 0)[:, None]
                xw.append(np.where(neg, np.where(need0[:, None], zero,
                                                 poison), pos))
            for s in range(WIDE2_SEG):
                live = s < cnt
                got = (_pick1(mw[s], xw[H + s], xw[s]) if one
                       else _pick(mw[B + s], mw[s], xw[H + s], xw[B + s],
                                  xw[A + s], xw[s]))
                write(xw[H + s][live], got[live])
        else:
            form = "roll_gather"
            t = np.arange(grid * vecs)
            v, i = t % vecs, t // vecs
            own = words(i, v)
            at1 = words(np.maximum(i - D1, 0), v)
            at2 = words(np.maximum(i - D2, 0), v)
            at12 = words(np.maximum(i - D1 - D2, 0), v)
            got = _pick(mask[own], mask[at2], own, at1, at2, at12)
            np.add.at(loaded, got.ravel(), 1)
            write(own, got)
    assert (src >= 0).all(), "an output never written, or took poison"
    if form != "roll_gather":
        assert (loaded == 1).all(), "an x vector loaded twice"
    xf = x3.reshape(x3.shape[0], P)
    return xf[:, torch.from_numpy(src)].reshape(x3.shape), form, clamped


#: (kind, D1, D2, tiles, form): the chain form (D1 = 2 D2, D2 = 2 D1,
#: D1 = D2, chains of one and of several segments, chains of unequal
#: length), the general form past the budget (every other ratio), swap
#: groups of four and of two tiles
WIDE2_CASES = {
    "roll_2_1": ("wide_roll2", 2, 1, 20, "roll_chain"),
    "roll_1_2": ("wide_roll2", 1, 2, 20, "roll_chain"),
    "roll_eq": ("wide_roll2", 3, 3, 20, "roll_chain"),
    "roll_8_4": ("wide_roll2", 8, 4, 20, "roll_chain"),
    "roll_3_2": ("wide_roll2", 3, 2, 23, "roll_gather"),
    "roll_4_2": ("wide_roll2", 4, 2, 23, "roll_chain"),
    "roll_1_4": ("wide_roll2", 1, 4, 20, "roll_gather"),
    "roll_k160": ("wide_roll2", 8, 4, 16, "roll_chain"),
    "roll_5_4": ("wide_roll2", 5, 4, 20, "roll_gather"),
    "roll_7_3": ("wide_roll2", 7, 3, 20, "roll_gather"),
    "roll_far": ("wide_roll2", 30, 1, 20, "roll_gather"),
    "roll_past_grid": ("wide_roll2", 20, 40, 20, "roll_gather"),
    "swap_1_2": ("wide_swap2", 1, 2, 8, "swap_group"),
    "swap_4_1": ("wide_swap2", 4, 1, 16, "swap_group"),
    "swap_2_8": ("wide_swap2", 2, 8, 16, "swap_group"),
    "swap_eq": ("wide_swap2", 2, 2, 8, "swap_group"),
}


@pytest.mark.parametrize("case", sorted(WIDE2_CASES))
@pytest.mark.parametrize("log2_tile", [1, 2, 3, 5, 6, 7, 9, 12])
def test_wide2_kernels_equal_plain(case, log2_tile):
    """On a random plane (clamped sources selected) and on a planned one
    (:func:`pack_masks` refuses a roll mask that selects a clamped source,
    so no roll chain then reads tile 0 for one)."""
    kind, D1, D2, grid, form = WIDE2_CASES[case]
    tile = 1 << log2_tile
    geom = _many_tiles(tile, grid)
    ps = fp.PassSpec(kind=kind, dists=(D1 * tile, D2 * tile), block_dist=D1,
                     block_dist2=D2)
    rng = np.random.default_rng(100 * sorted(WIDE2_CASES).index(case)
                                + log2_tile)
    bits = rng.integers(-128, 128, geom.P).astype(np.int8)
    planned = bits.copy()
    if kind == "wide_roll2":
        planned[: D1 * tile] &= ~1
        planned[: D2 * tile] &= ~2
    for plane, is_planned in ((bits, False), (planned, True)):
        plane = torch.from_numpy(plane)
        for batch in (1, 3):
            for dtype in (torch.float32, torch.int32, torch.float64):
                x3 = _random_words(rng, (batch, grid, tile), dtype)
                want = fp.wide2_pass_plain(x3, plane, ps, geom)
                for aligned in (True, False):
                    got, used, clamped = emulate_wide(x3, plane, ps, geom,
                                                      aligned)
                    assert used == form
                    assert torch.equal(got, want)
                    if is_planned and form == "roll_chain":
                        assert clamped == 0


#: (kind, D, tiles, form): swap pairs {i, i ^ D}; roll chains of one tile
#: (D = 1 on 20 tiles: five segments), of several, of unequal length (20
#: tiles mod 3, 23 mod 5), the k=160 plan's shape, and distances up to
#: and past the tile count (every source tile 0)
WIDE_CASES = {
    "swap_1": ("wide_swap", 1, 8, "swap_pair"),
    "swap_2": ("wide_swap", 2, 8, "swap_pair"),
    "swap_4": ("wide_swap", 4, 16, "swap_pair"),
    "swap_half": ("wide_swap", 8, 16, "swap_pair"),
    "roll_1": ("wide_roll", 1, 20, "roll_chain"),
    "roll_2": ("wide_roll", 2, 20, "roll_chain"),
    "roll_3": ("wide_roll", 3, 20, "roll_chain"),
    "roll_5": ("wide_roll", 5, 23, "roll_chain"),
    "roll_k160": ("wide_roll", 4, 16, "roll_chain"),
    "roll_last": ("wide_roll", 19, 20, "roll_chain"),
    "roll_past_grid": ("wide_roll", 25, 20, "roll_chain"),
}


@pytest.mark.parametrize("case", sorted(WIDE_CASES))
@pytest.mark.parametrize("log2_tile", range(13))
def test_wide_kernels_equal_plain(case, log2_tile):
    """The wide pass as wide2's one-stage instance, at every tile from 1
    to 4,096, on a plane of random bytes (any non-zero byte selects, not
    bit 0 alone; clamped roll sources selected) and on a planned one
    (no roll then reads tile 0 for a clamped source)."""
    kind, D, grid, form = WIDE_CASES[case]
    tile = 1 << log2_tile
    geom = _many_tiles(tile, grid)
    ps = fp.PassSpec(kind=kind, dists=(D * tile,), block_dist=D)
    rng = np.random.default_rng(1000 + 100 * sorted(WIDE_CASES).index(case)
                                + log2_tile)
    bits = rng.integers(-128, 128, geom.P).astype(np.int8)
    bits[::3] = 0
    bits[1::5] = 2          # non-zero, bit 0 clear: selects
    planned = bits.copy()
    if kind == "wide_roll":
        planned[: D * tile] = 0
    for plane, is_planned in ((bits, False), (planned, True)):
        plane = torch.from_numpy(plane)
        for batch in (1, 3):
            for dtype in (torch.float32, torch.int32, torch.float64):
                x3 = _random_words(rng, (batch, grid, tile), dtype)
                want = fp.wide_pass_plain(x3, plane, ps, geom)
                for aligned in (True, False):
                    got, used, clamped = emulate_wide(x3, plane, ps, geom,
                                                      aligned)
                    assert used == form
                    assert torch.equal(got, want)
                    if is_planned:
                        assert clamped == 0


@pytest.mark.parametrize("kind,D", [("wide_swap", 1), ("wide_swap", 2),
                                    ("wide_roll", 1), ("wide_roll", 3)])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_wide_kernels_equal_jax_interpret(kind, D, dtype):
    """The wide pass's transcription against the JAX package's _wide_pass
    (one Pallas call, interpret mode) at the JAX test geometry (64 rows
    of 128 in tiles of 16 rows), on a plane of random bytes."""
    P, R = 64 * LANE, 16
    rng = np.random.default_rng(40 + D)
    plane = rng.integers(-128, 128, P).astype(np.int8)
    x = rng.normal(size=(3, P)).astype(dtype)
    jps = jfused.PassSpec(kind=kind, dists=(D * R * LANE,), block_dist=D)
    jplan = jfused.FusedPlan(geom=jfused.geometry(P, block_rows=R),
                             passes=(jps,))
    want = np.asarray(jfused._PASS_FNS[kind](
        jnp.asarray(x).reshape(3, P // LANE, LANE),
        jnp.asarray(plane.reshape(P // LANE, LANE)), jps, jplan,
        True)).reshape(3, P)
    geom = fp.geometry(P, block_rows=R)
    ps = fp.PassSpec(kind=kind, dists=(D * geom.tile,), block_dist=D)
    got, _, _ = emulate_wide(torch.from_numpy(x).reshape(3, geom.grid,
                                                         geom.tile),
                             torch.from_numpy(plane), ps, geom)
    np.testing.assert_array_equal(got.reshape(3, P).numpy(), want)


# ---- B4's scan: a chunk and its halo, shrinking stage ranges -----------------

#: B4's scan window kernel (seg_scan.cu: kScanChunk, kScanPer,
#: kScanThreads) and an SM's shared memory for a block
SCAN_CHUNK, SCAN_PER, SCAN_THREADS = 1024, 8, 1024
SMEM_LIMIT = 232448


def scan_launch(dists, tile: int, E: int):
    """``launch_scan``'s arithmetic for a scan window pass in packs of
    ``E`` values: ``(chunk, span, threads, per, starts)``: outputs per
    block, window positions staged, threads, packs per thread, and the
    first pack of each stage."""
    lead = -(-sum(dists) // E) * E
    chunk = min(tile, SCAN_CHUNK)
    span = min(lead + chunk, 2 * tile)
    if span > 2 * SCAN_CHUNK:
        chunk = tile
        span = min(lead + tile, 2 * tile)
    packs = span // E
    threads = min(-(-packs // (SCAN_PER // E) // 32) * 32, SCAN_THREADS)
    starts, later = [0] * len(dists), 0
    for j in reversed(range(len(dists))):
        starts[j] = max(span - chunk - later, 0) // E
        later += dists[j]
    return chunk, span, threads, -(-packs // threads), starts


def chunk_window(x2, dist, dists, op, tile: int, aligned: bool = True):
    """B4's scan window pass as ``scan_chunk_pass`` runs it: block b owns
    outputs [b C, (b + 1) C) and the ``span`` window positions ending at
    them, in packs of E = 16 bytes (one value below a 16-byte tile or on
    unaligned pointers); stage j updates the packs from ``starts[j]`` on,
    each position reading position p - d (mod span, pack by pack) from
    the buffer the stage before wrote, which must hold every source an
    output depends on (asserted; the pack's own values come from
    registers where d < E, so that pack must have been written too); the
    chunk's outputs are the last C positions."""
    B, P = x2.shape
    vec = 16 // x2.element_size()
    E = vec if tile % vec == 0 and aligned else 1
    chunk, span, threads, per, starts = scan_launch(dists, tile, E)
    assert per <= SCAN_PER // E and threads * per * E >= span
    assert threads <= SCAN_THREADS and threads % 32 == 0
    assert 2 * span * x2.element_size() <= SMEM_LIMIT
    assert span % E == 0 and chunk % E == 0 and tile % chunk == 0
    c0 = torch.arange(P // chunk, dtype=torch.int64) * chunk
    blk = c0 // tile
    first = tile + (c0 - blk * tile) + chunk - span
    assert bool((first % E == 0).all())        # packs never straddle
    row0 = torch.where(blk > 0, (blk - 1) * tile, 0)
    wrap0 = torch.where(blk > 0, 2 * tile - 1, tile - 1)
    p = torch.arange(span, dtype=torch.int64)
    g = row0[:, None] + ((first[:, None] + p) & wrap0[:, None])
    dv = dist[g]
    v = x2[:, g]                              # (B, blocks, span)
    bufs = [v.clone(), torch.zeros_like(v)]
    fresh = [torch.ones(span, dtype=torch.bool),
             torch.zeros(span, dtype=torch.bool)]
    later = sum(dists)
    for j, d in enumerate(dists):
        later -= d
        active = p // E >= starts[j]
        # the positions an output depends on, and their sources
        needed = p >= span - chunk - later
        src = (p - d) % span
        assert bool(needed[active].sum() == needed.sum())
        assert span == 2 * tile or bool((p - d >= 0)[needed].all())
        assert bool(fresh[j & 1][src[needed]].all())
        if d < E:
            assert bool(fresh[j & 1][active].all())
        v = torch.where(active, fp.dist_stage(v, bufs[j & 1][..., src], dv,
                                              d, op), v)
        if j + 1 < len(dists):
            k = (j + 1) & 1
            bufs[k] = torch.where(active, v, bufs[k])
            fresh[k] = active
    lead = span - chunk
    out = torch.empty_like(x2)
    out[:, (c0[:, None] + torch.arange(chunk)).reshape(-1)] = \
        v[..., lead:].reshape(B, -1)
    return out


def chunk_scan(x, dist, dists, op, geom):
    """B4's scan as the kernels run it: a window pass as
    :func:`chunk_window`, a wide pass as ``seg_wide_pass``'s select."""
    P = geom.P
    x2 = x.reshape(-1, P)
    p = torch.arange(P, dtype=torch.int64)
    for dp in fp.plan_dist_passes(dists, geom):
        if dp.kind == "wide":
            d = dp.dists[0]
            x2 = fp.dist_stage(x2, x2[:, (p - d) % P], dist, d, op)
        else:
            x2 = chunk_window(x2, dist, dp.dists, op, geom.tile)
    return x2.reshape(x.shape)


def _scan_payload(rng, shape, dtype):
    """Random words; for floats also -0.0 and NaN at a few positions (a
    stage adds 0 where its mask is off, so -0.0 turns +0.0; a NaN operand
    wins min and max)."""
    x = _random_words(rng, shape, dtype)
    if dtype.is_floating_point:
        flat = x.view(-1)
        at = torch.from_numpy(rng.integers(0, flat.numel(), 2 * (flat.numel()
                                                                 // 64 + 1)))
        flat[at[::2]] = -0.0
        flat[at[1::2]] = float("nan")
    return x


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """NaN at the same positions, every other word bit for bit (the sign
    of zero included).  A NaN's payload bits are not compared: torch's
    CPU minimum and maximum give one NaN in their vector loop and another
    in its scalar tail."""
    if not a.dtype.is_floating_point:
        return torch.equal(a, b)
    nan = a.isnan()
    word = torch.int32 if a.element_size() == 4 else torch.int64
    return (torch.equal(nan, b.isnan())
            and torch.equal(a[~nan].view(word), b[~nan].view(word)))


def test_scan_launch_of_path_d_and_the_split_passes():
    """Path D's 8 stages at the card's tile, float32: chunks of 1,024
    outputs with a halo of 255 positions (256: whole packs of 4), stage j
    from the pack of prefix sum j on, 160 threads of two packs each; the
    hub's window passes (sum(d) 2,047 and 2,048) run a whole tile per
    block of 768 threads."""
    dists = tuple(1 << k for k in range(8))
    chunk, span, threads, per, starts = scan_launch(dists, 4096, 4)
    assert (chunk, span, threads, per) == (1024, 1280, 160, 2)
    assert starts == [(256 - 255 + int(c)) // 4 for c in np.cumsum(dists)]
    geom = fp.geometry(1 << 15)
    hub = fp.plan_dist_passes(tuple(1 << k for k in range(13)), geom)
    assert [dp.kind for dp in hub] == ["window", "window", "wide"]
    for dp in hub[:2]:
        assert scan_launch(dp.dists, 4096, 4)[:4] == (4096, 6144, 768, 2)


@pytest.mark.parametrize("name", sorted(FILL_GEOMETRIES))
@pytest.mark.parametrize("plane", ["rank", "random"])
@pytest.mark.parametrize("batch", [1, 3])
def test_scan_chunk_equals_plain(name, plane, batch):
    P, block_rows, n_stages = FILL_GEOMETRIES[name]
    geom = fp.geometry(P, block_rows)
    dists = tuple(1 << k for k in range(n_stages))
    rng = np.random.default_rng(500 + len(name) + batch)
    dist = (_rank_plane(rng, P, 1 << n_stages) if plane == "rank"
            else _random_plane(rng, P))
    for op in fp.SCAN_OPS:
        for dtype in (torch.float32, torch.float64, torch.int32):
            x = _scan_payload(rng, (batch, P), dtype)
            assert _same_bits(chunk_scan(x, dist, dists, op, geom),
                              fp.segscan_pass_plain(x, dist, dists, op,
                                                    geom))


@pytest.mark.parametrize("log2_tile", range(13))
@pytest.mark.parametrize("batch", [1, 3])
def test_scan_chunk_every_tile(log2_tile, batch):
    """The window pass at every tile from 1 to 4,096 (four tiles, tile 0
    included) on random planes, in packs of 16 bytes and of one value:
    ascending powers of two whose sum stays below the tile (the halo
    case), and random lists of 1, 8 and 32 distances below 2 tile whose
    halo reaches round the window."""
    tile = 1 << log2_tile
    geom = _many_tiles(tile, 4)
    rng = np.random.default_rng(700 + 10 * log2_tile + batch)
    lists = [tuple(1 << k for k in range(log2_tile))]
    lists += [tuple(int(d) for d in rng.integers(1, 2 * tile, size=k))
              for k in (1, 8, 32)]
    for dists in lists:
        if not dists:
            continue
        dist = _random_plane(rng, geom.P)
        dp = fp.DistPass("window", dists)
        for op in fp.SCAN_OPS:
            for dtype in (torch.float32, torch.float64, torch.int32):
                x = _scan_payload(rng, (batch, geom.P), dtype)
                want = fp.dist_pass_plain(x, dist, dp, op, geom)
                for aligned in (True, False):
                    assert _same_bits(
                        chunk_window(x, dist, dists, op, tile, aligned),
                        want)


@pytest.mark.parametrize("op", fp.SCAN_OPS)
@pytest.mark.parametrize("plane", ["rank", "random"])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_scan_chunk_equals_jax_interpret(op, plane, dtype):
    """The transcription against the JAX package's segscan_pass (one
    Pallas call, interpret mode) at the JAX test geometry (tile 2,048:
    two chunks a tile), tile 0 included."""
    P = 64 * LANE
    rng = np.random.default_rng(len(op) + len(plane))
    dist = (_rank_plane(rng, P, 50) if plane == "rank"
            else _random_plane(rng, P))
    dists = tuple(1 << k for k in range(6))
    x = (rng.normal(size=(2, P)) * 1000).astype(dtype)
    want = np.asarray(jfused.segscan_pass(jnp.asarray(x),
                                          jnp.asarray(dist.numpy()), dists,
                                          op, jfused.geometry(P,
                                                              block_rows=16)))
    got = chunk_scan(torch.from_numpy(x), dist, dists, op,
                     fp.geometry(P, block_rows=16))
    np.testing.assert_array_equal(got.numpy(), want)
