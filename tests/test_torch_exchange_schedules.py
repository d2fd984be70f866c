"""How kernels B6 (the halo pull and its fused merge) and B5 (the sharded
banded round with the next fire folded in) run on the card, on the CPU:
each launch transcribed thread by thread into numpy/torch and held bit for
bit against the plain version it must equal.

* B6 (``csrc/halo_exchange.cu``): the host's launch arithmetic (each
  block's scalar head, its tiles and their running sum, the grid of the
  card's resident blocks split between pull and merge by bytes and
  trimmed to whole loop trips), the pull's tiles (a binary search of the
  running sum, eight 16-byte copies a thread, scalar heads and tails,
  blocks copied by element where source and destination disagree mod 16)
  and the merge's packs (16 or 8 cells of one row; at scalar lanes a
  warp's 32 packs taken together, a lane's vectors 32 apart; with feature
  lanes a thread's own pack; raw 32-bit words selected by the flag of
  their cell; a scalar path for row tails and unaligned rows).  Memory is
  one byte arena addressed as the card's, so every alignment test sees
  the same addresses the kernel would; each output byte must be written
  exactly once.  Held against
  ``fused_exchange_merge_plain``, ``remote_block_exchange_plain`` and a
  numpy transcription of the JAX kernel body
  (``flow_updating_tpu/ops/pallas_halo.py:120-154``), since JAX's kernel
  stops at ``pltpu.TPUMemorySpace`` under the installed jax.
* B5 (``csrc/sharded_round.cu``): the merge launch over one or two row
  ranges (a block's range by its index), a thread's pack of nodes, the
  bit-plane word loaded once per 32 diagonals, the window of 8 diagonals
  read at once whatever their mask bits (asserted to stay in the window),
  directly in blocks that lie ``H`` from both ends of the shard (asserted
  never to reach the halos) and through the three-way choice elsewhere,
  and the folded fire.  Held against ``sharded_round_plain`` followed by
  ``sharded_fire_plain``.
* The folded schedule itself (``parallel/banded_sharded.py`` on
  ``device='cpu'``), held against the unfused composition round by round
  and against the JAX package's ``ppermute`` oracle over many rounds,
  also continued from a JAX state.

The kernels themselves run only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""

import math

import numpy as np
import pytest
import torch

from flow_updating_tpu.models.config import RoundConfig as JaxConfig
from flow_updating_tpu.parallel.banded_sharded import (
    ShardedBandedKernel as JaxShardedBandedKernel,
)
from flow_updating_tpu.parallel.mesh import make_mesh as jax_make_mesh
from flow_updating_tpu.plan import compile_topology as jcompile
from flow_updating_tpu.topology import generators as jgen
from flow_updating_tpu_torch import RoundConfig
from flow_updating_tpu_torch.ops import halo_exchange as hx
from flow_updating_tpu_torch.ops import sharded_round as psr
from flow_updating_tpu_torch.parallel.banded_sharded import (
    ShardedBandedKernel,
)
from flow_updating_tpu_torch.parallel.mesh import make_mesh
from flow_updating_tpu_torch.plan import compile_topology
from flow_updating_tpu_torch.topology import generators as pgen

THREADS = 256
VEC = 16            # bytes of one vector access
PACK_BYTES = 64     # bytes of a value plane a B6 merge thread moves per pack
PULL_VECS = 8       # 16-byte vectors a B6 pull thread copies a tile
WAVES = 4           # B6's grid: times the blocks the card holds at once
TOL = dict(rtol=1e-12, atol=1e-12)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


# ---- B6: memory -----------------------------------------------------------

class Arena:
    """One byte buffer addressed as the card's memory: ``put`` places an
    array ``off`` bytes past a 256-byte boundary and returns its
    address."""

    def __init__(self):
        self.mem = np.zeros(0, np.uint8)
        self.writes = np.zeros(0, np.int64)

    def put(self, arr: np.ndarray, off: int = 0) -> int:
        start = -(-len(self.mem) // 256) * 256 + 256 + off
        raw = np.ascontiguousarray(arr).view(np.uint8).reshape(-1)
        grown = np.zeros(start + raw.size + 64, np.uint8)
        grown[:len(self.mem)] = self.mem
        grown[start:start + raw.size] = raw
        self.mem = grown
        self.writes = np.zeros(len(grown), np.int64)
        return start

    def get(self, addr: int, like: np.ndarray) -> np.ndarray:
        n = like.nbytes
        return self.mem[addr:addr + n].copy().view(like.dtype).reshape(
            like.shape)

    def read(self, addrs: np.ndarray, nbytes: int) -> np.ndarray:
        """``nbytes`` at each address: ``(len(addrs), nbytes)`` bytes."""
        idx = np.asarray(addrs, np.int64)[:, None] + np.arange(nbytes)
        return self.mem[idx]

    def write(self, addrs: np.ndarray, data: np.ndarray) -> None:
        idx = np.asarray(addrs, np.int64)[:, None] + np.arange(
            data.shape[1])
        self.mem[idx] = data
        np.add.at(self.writes, idx.reshape(-1), 1)


# ---- B6: the host's launch arithmetic -------------------------------------

def trim(units: int, per_block: int, blocks: int) -> int:
    """``trim`` of the .cu: the fewest blocks that take as many loop trips
    as ``blocks`` blocks would."""
    if units <= 0:
        return 0
    blocks = max(blocks, 1)
    trips = -(-units // (blocks * per_block))
    return -(-units // (trips * per_block))


def b6_plan(src, dst, counts, sz, D, Eb, nf, resident):
    """``launch<SZ, NF1>`` of the .cu: the by-value table and the grid
    (``resident``: the blocks the card holds at once)."""
    resident *= WAVES
    E = VEC // sz
    per = THREADS * PULL_VECS
    heads, tile_end, tiles, pull_bytes = [], [], 0, 0
    for s, d, n in zip(src, dst, counts):
        if s % VEC == d % VEC:
            head = min(((VEC - s % VEC) % VEC) // sz, n)
            nv = (n - head) // E
            t = -(-nv // per) if n else 0
            if n and t == 0:
                t = 1
        else:
            head = -1
            t = -(-n // (per * E))
        heads.append(head)
        tiles += t
        tile_end.append(tiles)
        pull_bytes += 2 * n * sz
    pack = PACK_BYTES // sz
    npk = -(-Eb // pack) if D else 0
    merge_bytes = D * Eb * (3 + 6 * nf * sz)
    if npk == 0:
        copy, merge = trim(tiles, 1, resident), 0
    elif tiles == 0:
        copy, merge = 0, trim(npk, THREADS, resident)
    else:
        share = int(resident * pull_bytes / (pull_bytes + merge_bytes)
                    + 0.5)
        share = 1 if share < 1 else (resident - 1 if share > resident - 1
                                     else share)
        copy = trim(tiles, 1, share)
        merge = trim(npk, THREADS, resident - share)
    return {"heads": heads, "tile_end": tile_end, "tiles": tiles,
            "copy_blocks": copy, "merge_blocks": merge, "npk": npk,
            "pack": pack}


# ---- B6: the kernel ---------------------------------------------------------

def b6_pull(ar: Arena, plan, src, dst, counts, sz) -> None:
    """The copy blocks: tile ``t`` of block ``b`` (binary search of the
    running sum), 256 threads a tile, each ``PULL_VECS`` vectors (or as
    many elements times the vector's) at a stride of 256."""
    E = VEC // sz
    U = PULL_VECS
    tid = np.arange(THREADS)
    for blk in range(plan["copy_blocks"]):
        for t in range(blk, plan["tiles"], plan["copy_blocks"]):
            lo, hi = 0, len(counts) - 1
            while lo < hi:
                mid = (lo + hi) >> 1
                if t < plan["tile_end"][mid]:
                    hi = mid
                else:
                    lo = mid + 1
            b = lo
            tb = t - (plan["tile_end"][b - 1] if b else 0)
            n, head = counts[b], plan["heads"][b]
            if head < 0:
                i = (tb * THREADS * U * E + tid)[:, None] \
                    + np.arange(U * E)[None] * THREADS
                i = i[i < n]
                ar.write(dst[b] + i * sz, ar.read(src[b] + i * sz, sz))
                continue
            nv = (n - head) // E
            iv = (tb * THREADS * U + tid)[:, None] \
                + np.arange(U)[None] * THREADS
            iv = iv[iv < nv]
            base = head * sz
            ar.write(dst[b] + base + iv * VEC,
                     ar.read(src[b] + base + iv * VEC, VEC))
            if tb == 0:
                i = tid[tid < head]
                ar.write(dst[b] + i * sz, ar.read(src[b] + i * sz, sz))
                j = head + nv * E + (tid - E)
                j = j[(tid >= E) & (tid < 2 * E) & (j < n)]
                ar.write(dst[b] + j * sz, ar.read(src[b] + j * sz, sz))


def _b6_cell(ar, a, r0, e, nf, sz):
    """``merge_cell``: one cell, element by element."""
    c = r0 + e
    h = ar.read([a["hit"] + c], 1)
    ar.write([a["out_valid"] + c], ar.read([a["buf_valid"] + c], 1) | h)
    for p, b, o in (("pay_flow", "buf_flow", "out_flow"),
                    ("pay_est", "buf_est", "out_est")):
        for f in range(nf):
            src = (a[p] + (e * nf + f) * sz if h[0, 0]
                   else a[b] + (c * nf + f) * sz)
            ar.write([a[o] + (c * nf + f) * sz], ar.read([src], sz))


def _b6_row_aligned(a, r0, nf, sz, pack):
    flags = (a["hit"] + r0) | (a["buf_valid"] + r0) | (a["out_valid"] + r0)
    vo = r0 * nf * sz
    vals = a["pay_flow"] | a["pay_est"] | (a["buf_flow"] + vo) \
        | (a["buf_est"] + vo) | (a["out_flow"] + vo) | (a["out_est"] + vo)
    return not (flags & (pack - 1)) and not (vals & (VEC - 1))


def b6_merge_warps(ar: Arena, plan, a: dict, sz: int, D: int, Eb: int
                   ) -> None:
    """The merge blocks at scalar lanes (``kWarpVectors``): per row and
    trip, each warp's 32 packs; lane ``l`` takes vectors ``l, l + 32, ...``
    of the chunk (the cells of vector ``v`` are ``v*CPV ..``) where their
    pack is whole and the row aligned; the lane's own pack otherwise goes
    cell by cell."""
    pack, npk = plan["pack"], plan["npk"]
    vpc, cpv, wpe = PACK_BYTES // VEC, VEC // sz, sz // 4
    stride = plan["merge_blocks"] * THREADS
    lane = np.arange(32)
    for d in range(D):
        r0 = d * Eb
        whole = Eb // pack if _b6_row_aligned(a, r0, 1, sz, pack) else 0
        for pk0 in range(0, npk, 32):        # every warp chunk of a trip
            if pk0 < whole:
                for j in range(vpc):
                    v = j * 32 + lane
                    v = v[pk0 + v // vpc < whole]
                    c = (r0 + pk0 * pack) + v * cpv
                    col = pk0 * pack + v * cpv
                    fh = ar.read(a["hit"] + c, cpv)
                    fv = ar.read(a["buf_valid"] + c, cpv)
                    ar.write(a["out_valid"] + c, fv | fh)
                    hw = fh[:, np.arange(4) // wpe] != 0
                    for p, b, o in (("pay_flow", "buf_flow", "out_flow"),
                                    ("pay_est", "buf_est", "out_est")):
                        pv = ar.read(a[p] + col * sz, VEC).view(np.uint32)
                        bv = ar.read(a[b] + c * sz, VEC).view(np.uint32)
                        ar.write(a[o] + c * sz,
                                 np.where(hw, pv, bv).view(np.uint8))
            for pk in range(max(pk0, whole), min(pk0 + 32, npk)):
                for e in range(pk * pack, min(pk * pack + pack, Eb)):
                    _b6_cell(ar, a, r0, e, 1, sz)
    assert stride % 32 == 0   # a warp's chunk never straddles two trips


def b6_merge(ar: Arena, plan, a: dict, sz: int, D: int, Eb: int,
             nf: int) -> None:
    """The merge blocks with feature lanes: per row, each thread's packs
    in grid-stride order; a whole aligned pack by words, anything else by
    cell."""
    pack, npk = plan["pack"], plan["npk"]
    wpe = sz // 4
    stride = plan["merge_blocks"] * THREADS
    first = np.arange(stride)
    for d in range(D):
        r0 = d * Eb
        aligned = _b6_row_aligned(a, r0, nf, sz, pack)
        for trip in range(-(-npk // stride)):
            pk = first + trip * stride
            pk = pk[pk < npk]
            e0 = pk * pack
            whole = aligned & (e0 + pack <= Eb)
            if whole.any():
                c0, e = r0 + e0[whole], e0[whole]
                h = ar.read(a["hit"] + c0, pack)
                v = ar.read(a["buf_valid"] + c0, pack)
                ar.write(a["out_valid"] + c0, v | h)
                span = pack * nf * sz            # bytes a plane a pack
                word_elem = np.arange(span // 4) // wpe
                hw = h[:, word_elem // nf] != 0  # each word's cell flag
                for p, b, o in (("pay_flow", "buf_flow", "out_flow"),
                                ("pay_est", "buf_est", "out_est")):
                    pv = ar.read(a[p] + e * nf * sz, span).view(np.uint32)
                    bv = ar.read(a[b] + c0 * nf * sz, span).view(np.uint32)
                    ar.write(a[o] + c0 * nf * sz,
                             np.where(hw, pv, bv).view(np.uint8))
            for e0s in e0[~whole]:
                for e in range(e0s, min(e0s + pack, Eb)):
                    _b6_cell(ar, a, r0, e, nf, sz)


def b6_call(blocks, offsets, me, merge, resident, offs=None, pull_only=False):
    """One B6 launch, transcribed: returns ``(received, outputs)`` and
    checks that every output byte was written once."""
    S = len(blocks)
    senders = [blocks[(me - d) % S][i] for i, d in enumerate(offsets)]
    offs = offs or {}
    ar = Arena()
    sz = senders[0].dtype.itemsize
    src = [ar.put(b, offs.get(("src", i), 0)) for i, b in enumerate(senders)]
    recv = [np.zeros_like(b) for b in senders]
    dst = [ar.put(r, offs.get(("dst", i), 0)) for i, r in enumerate(recv)]
    counts = [b.size for b in senders]
    D = Eb = 0
    nf = 1
    a = {}
    if not pull_only:
        hit, pf, pe, bf, be, bv = merge
        D, Eb = hit.shape
        nf = bf[0, 0].size
        outs = (np.zeros_like(bf), np.zeros_like(be), np.zeros_like(bv))
        for name, arr in zip(("hit", "pay_flow", "pay_est", "buf_flow",
                              "buf_est", "buf_valid", "out_flow", "out_est",
                              "out_valid"),
                             (hit.view(np.uint8), pf, pe, bf, be,
                              bv.view(np.uint8), *outs)):
            a[name] = ar.put(arr, offs.get(name, 0))
    plan = b6_plan(src, dst, counts, sz, D, Eb, nf, resident)
    assert plan["copy_blocks"] + plan["merge_blocks"] <= max(
        resident * WAVES, 2)
    b6_pull(ar, plan, src, dst, counts, sz)
    if not pull_only and nf == 1:
        b6_merge_warps(ar, plan, a, sz, D, Eb)
    elif not pull_only:
        b6_merge(ar, plan, a, sz, D, Eb, nf)
    got = [ar.get(addr, r) for addr, r in zip(dst, recv)]
    written = [ar.writes[addr:addr + r.nbytes] for addr, r in zip(dst, recv)]
    res = None
    if not pull_only:
        res = [ar.get(a[n], o) for n, o in zip(("out_flow", "out_est",
                                                 "out_valid"), outs)]
        res[2] = res[2].view(bool)
        written += [ar.writes[a[n]:a[n] + o.nbytes]
                    for n, o in zip(("out_flow", "out_est", "out_valid"),
                                    outs)]
    for w in written:
        assert (w == 1).all(), "an output byte was written other than once"
    return got, res, plan


def _numpy_exchange(blocks, offsets, me):
    """pallas_halo.py:120-131: one remote copy per offset to (s + d) % S,
    seen from the receiver."""
    return [blocks[(me - d) % len(blocks)][i] for i, d in enumerate(offsets)]


def _numpy_merge(hit, pay_flow, pay_est, buf_flow, buf_est, buf_valid):
    """pallas_halo.py:135-151."""
    h = hit.reshape(hit.shape + (1,) * (buf_flow.ndim - hit.ndim))
    return (np.where(h, pay_flow[None], buf_flow),
            np.where(h, pay_est[None], buf_est), buf_valid | hit)


def _b6_inputs(rng, D, Eb, nf, dtype, lens=((3, 7), (3, 300), (3, 5)),
               S=4):
    feat = (nf,) if nf > 1 else ()
    blocks = [[rng.uniform(-1, 1, shape).astype(dtype) for shape in lens]
              for _ in range(S)]
    merge = (rng.random((D, Eb)) < 0.3,
             rng.uniform(-1, 1, (Eb,) + feat).astype(dtype),
             rng.uniform(-1, 1, (Eb,) + feat).astype(dtype),
             rng.uniform(-1, 1, (D, Eb) + feat).astype(dtype),
             rng.uniform(-1, 1, (D, Eb) + feat).astype(dtype),
             rng.random((D, Eb)) < 0.5)
    return blocks, merge


def _bits(x):
    return np.ascontiguousarray(x).view(np.uint8)


# ---- B6 tests --------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("nf", [1, 3])
@pytest.mark.parametrize("D,Eb", [(1, 1), (1, 16), (1, 1000), (3, 15),
                                  (3, 33), (2, 517)])
@pytest.mark.parametrize("skew", [0, 1])
def test_b6_merge_packs_tails_and_unaligned_rows(dtype, nf, D, Eb, skew):
    """Whole packs, row tails past the last whole pack, rows that start
    off the 16-byte grid (D * Eb * itemsize), and, with ``skew``, flag
    and value planes that start off it (every row then scalar)."""
    rng = np.random.default_rng(D * 1000 + Eb + nf)
    blocks, merge = _b6_inputs(rng, D, Eb, nf, dtype)
    offsets = (1, 2, 3)
    sz = np.dtype(dtype).itemsize
    offs = ({"hit": 3, "buf_valid": 1, "buf_flow": sz, "out_est": sz}
            if skew else {})
    for me in range(4):
        got, res, _ = b6_call(blocks, offsets, me, merge, resident=8,
                              offs=offs)
        tb = [[torch.from_numpy(b) for b in row] for row in blocks]
        tm = [torch.from_numpy(m) for m in merge]
        want_got, *want = hx.fused_exchange_merge_plain(tb, offsets, me,
                                                        *tm)
        jax_want = _numpy_merge(*merge)
        for g, w, j in zip(got, want_got, _numpy_exchange(blocks, offsets,
                                                          me)):
            assert np.array_equal(_bits(g), _bits(w.numpy()))
            assert np.array_equal(_bits(g), _bits(j))
        for g, w, j in zip(res, want, jax_want):
            assert np.array_equal(_bits(g), _bits(w.numpy()))
            assert np.array_equal(_bits(g), _bits(j))


def test_b6_merge_takes_the_scalar_path_only_where_it_must():
    """At float32 a row of Eb = 40 holds two whole packs of 16 and a tail
    of 8; a second row starts 40 bytes in, off the 16-byte grid."""
    assert b6_plan([0], [0], [0], 4, 2, 40, 1, 8)["pack"] == 16
    assert b6_plan([0], [0], [0], 8, 2, 40, 1, 8)["pack"] == 8
    assert (40 * 4) % VEC == 0 and (40 * 1) % 16 != 0  # flags misaligned


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("lens,offs", [
    ([(1, 1), (3, 7), (2, 4099)], {}),
    ([(1, 0), (5, 1001), (1, 3)], {("src", 1): 4, ("dst", 1): 4}),
    ([(3, 333), (2, 2049), (1, 17)], {("src", 0): 8, ("src", 1): 4,
                                      ("dst", 2): 12}),
    ([(1, 65536), (3, 5)], {("src", 0): 4}),
])
@pytest.mark.parametrize("resident", [1, 3, 1056])
def test_b6_pull_tiles_cover_every_element_once(dtype, lens, offs,
                                                resident):
    """Blocks of odd length, of none, with sources and destinations on
    and off the 16-byte grid (same offset: a scalar head; different
    offsets: copied by element), on grids of one block up to a full
    card."""
    rng = np.random.default_rng(len(lens) * 7 + resident)
    sz = np.dtype(dtype).itemsize
    offs = {k: v if v % sz == 0 else 0 for k, v in offs.items()}
    blocks = [[rng.uniform(-1, 1, shape).astype(dtype) for shape in lens]
              for _ in range(3)]
    offsets = tuple(range(1, len(lens) + 1))
    for me in range(3):
        got, _, plan = b6_call(blocks, offsets, me, None, resident,
                               offs=offs, pull_only=True)
        tb = [[torch.from_numpy(b) for b in row] for row in blocks]
        want = hx.remote_block_exchange_plain(tb, offsets, me)
        for g, w in zip(got, want):
            assert np.array_equal(_bits(g), _bits(w.numpy()))
        assert plan["merge_blocks"] == 0
        assert plan["tile_end"][-1] == plan["tiles"]


def test_b6_grid_split_at_the_halo_rounds_shapes():
    """Path F's shard (Eb = 5,352,000, 30% hits, about 19 MB pulled) on a
    card of 132 SMs: both parts within the grid of four waves, each
    trimmed to whole trips, the pull's share near its share of the
    bytes."""
    sz, Eb = 4, 5_352_000
    counts = [1_580_000, 1_590_000, 1_580_000]
    for per_sm in (2, 3, 8):
        resident = 132 * per_sm
        plan = b6_plan([0] * 3, [0] * 3, counts, sz, 1, Eb, 1, resident)
        copy, merge = plan["copy_blocks"], plan["merge_blocks"]
        resident *= WAVES
        assert 1 <= copy and 1 <= merge and copy + merge <= resident
        pull_bytes = 2 * sum(counts) * sz
        share = round(resident * pull_bytes
                      / (pull_bytes + Eb * (3 + 6 * sz)))
        # trimmed to whole trips: as many trips as the byte share's blocks
        # would take, and one block fewer would need another trip
        assert copy <= share and merge <= resident - share
        trips = -(-plan["tiles"] // copy)
        assert trips == -(-plan["tiles"] // share)
        assert copy == 1 or -(-plan["tiles"] // (copy - 1)) > trips
        mtrips = -(-plan["npk"] // (merge * THREADS))
        assert mtrips == -(-plan["npk"] // ((resident - share) * THREADS))
        assert -(-plan["npk"] // ((merge - 1) * THREADS)) > mtrips
    for units, per, blocks in ((1000, 1, 7), (334_500, 256, 800),
                               (1, 256, 50), (0, 1, 3)):
        got = trim(units, per, blocks)
        assert got <= max(blocks, 1)
        if units:
            assert math.ceil(units / (got * per)) == math.ceil(
                units / (blocks * per))


# ---- B5: the merge launch -------------------------------------------------

def b5_merge_launch(spec, leaves, S, G, avg_prev, A_prev, deg, avg, lo, hi,
                    ranges, value, inv, V=4):
    """``sharded_merge_kernel`` thread by thread: ``ranges`` (one or two
    row ranges) as one launch; returns ``{node: (S', G', A, next)}`` for
    the nodes it wrote.  Asserts that blocks on the direct path read only
    their own shard."""
    L, H = spec.local, spec.halo
    per = THREADS * V
    ranges = [(b * 128, e * 128) for b, e in ranges] + [(0, 0)]
    blocks0 = -(-(ranges[0][1] - ranges[0][0]) // per)
    grid = blocks0 + -(-(ranges[1][1] - ranges[1][0]) // per)
    planes = leaves.planes.view(torch.int32).numpy().view(np.uint32)
    offs = list(spec.offsets)
    rem = leaves.rem_idx.numpy() if spec.rem_route == "inline" else None
    out = {}
    for blk in range(grid):
        r = 0 if blk < blocks0 else 1
        b0 = ranges[r][0] + (blk - (blocks0 if r else 0)) * per
        b1 = min(b0 + per, ranges[r][1])
        inside = b0 >= H and b1 + H <= L
        p = np.arange(b0, b1, V)              # each thread's first node
        nodes = (p[:, None] + np.arange(V)[None]).reshape(-1)

        def window(w):
            w = np.asarray(w)
            assert ((w >= 0) & (w < L + 2 * H)).all(), "read off the window"
            if inside:
                assert ((w >= H) & (w < H + L)).all(), "direct path left " \
                    "the shard"
                return avg[torch.from_numpy(w - H)]
            win = torch.cat([lo, avg, hi])
            return win[torch.from_numpy(w)]

        acc = torch.zeros(len(nodes), dtype=avg.dtype)
        word = None
        for g0 in range(0, len(offs), 8):     # kDiags reads at once
            if g0 % 32 == 0:                  # one load per 32 diagonals
                word = planes[g0 >> 5, nodes]
            # read whatever the bit: every kept diagonal stays in the window
            vals = [window(H + nodes + d) for d in offs[g0:g0 + 8]]
            for k, v in enumerate(vals):
                bit = torch.from_numpy(((word >> ((g0 + k) % 32)) & 1) != 0)
                acc = acc + torch.where(bit, v,
                                        torch.zeros((), dtype=avg.dtype))
        if rem is not None:
            rs = torch.zeros_like(acc)
            for c in range(rem.shape[1]):
                w = rem[nodes, c]
                ok = torch.from_numpy(w >= 0)
                v = torch.where(ok, window(np.where(w >= 0, w, H)),
                                torch.zeros((), dtype=avg.dtype))
                rs = rs + v
            acc = acc + rs
        n = torch.from_numpy(nodes)
        dg = deg[n]
        s_out = -G[n] - acc + dg * avg_prev[n]
        g_out = -S[n] - dg * avg[n] + A_prev[n]
        nxt = (value[n] - s_out + acc) * inv[n]
        for j, node in enumerate(nodes.tolist()):
            assert node not in out, "a node written twice"
            out[node] = (s_out[j], g_out[j], acc[j], nxt[j])
    return out


def _b5_kernel(name, shards=2, dtype="float64"):
    topo = {"ring": lambda: pgen.ring(20000, 2),
            "ring20": lambda: pgen.ring(5000, 20),
            "grid": lambda: pgen.grid2d(64, 64),
            "community": lambda: pgen.community(4000, 8, seed=0)}[name]()
    cfg = RoundConfig.fast(kernel="node", spmv="banded_fused", dtype=dtype)
    return ShardedBandedKernel(topo, cfg, make_mesh(shards, device="cpu"))


@pytest.mark.parametrize("name", ["ring", "ring20", "grid", "community"])
@pytest.mark.parametrize("dtype,V", [("float32", 4), ("float32", 1),
                                     ("float64", 2)])
def test_b5_merge_launch_matches_plain_merge_then_fire(name, dtype, V):
    """ring20: 96 kept diagonals (three bit-plane words); community: no
    interior row (L = H), every block on the three-way path."""
    k = _b5_kernel(name, dtype=dtype)
    spec, sh = k.spec, k._shards[1]
    L, H, R = spec.local, spec.halo, spec.local_rows
    rng = np.random.default_rng(3)
    dt = getattr(torch, dtype)
    vec = lambda n=L: torch.from_numpy(  # noqa: E731
        rng.uniform(-1, 1, n)).to(dt)
    S, G, avp, ap = (vec() for _ in range(4))
    lo, hi = vec(H), vec(H)
    avg = psr.sharded_fire_plain(sh.value, S, ap, sh.inv_depp1)
    S_n, G_n, acc = psr.sharded_round_plain(S, G, avp, ap, sh.deg, avg, lo,
                                            hi, sh.leaves, spec, 0, R)
    nxt = psr.sharded_fire_plain(sh.value, S_n, acc, sh.inv_depp1)
    inner, outer = psr.row_ranges(spec, "pallas")
    for launches in ([[(0, R)]], [inner, outer] if inner else [outer],
                     [[(0, 1), (R - 1, R)], [(1, R - 1)]]):
        got = {}
        for ranges in launches:
            got.update(b5_merge_launch(spec, sh.leaves, S, G, avp, ap,
                                       sh.deg, avg, lo, hi, ranges,
                                       sh.value, sh.inv_depp1, V))
        assert sorted(got) == list(range(L))
        for i, want in enumerate((S_n, G_n, acc, nxt)):
            col = torch.stack([got[p][i] for p in range(L)])
            assert torch.equal(col, want), (launches, i)


def b5_width(nodes: int, sms: int, itemsize: int, aligned: bool) -> int:
    """``launch`` of the .cu: 16 bytes of each node plane a thread where
    the pointers are aligned and the launch still gives each SM a block at
    that width, else one node."""
    wide = 16 // itemsize
    return wide if aligned and nodes >= sms * THREADS * wide else 1


def test_b5_interior_launch_never_reads_the_halos():
    """Every block of the interior launch lies H from both ends (the
    direct path), and the boundary launch's two ranges are one grid.  At
    path E's shapes on a card of 132 SMs the interior launch is wide and
    the boundary launch one node a thread."""
    k = _b5_kernel("ring", shards=4, dtype="float32")
    spec = k.spec
    inner, outer = psr.row_ranges(spec, "pallas")
    assert len(inner) == 1 and len(outer) == 2
    L, H, per = spec.local, spec.halo, THREADS * 4
    b, e = inner[0][0] * 128, inner[0][1] * 128
    for b0 in range(b, e, per):
        assert b0 >= H and min(b0 + per, e) + H <= L
    assert b5_width(248_832, 132, 4, True) == 4
    assert b5_width(2_048, 132, 4, True) == 1
    assert b5_width(248_832, 132, 8, True) == 2
    assert b5_width(248_832, 132, 4, False) == 1
    assert psr.launches_per_shard_round(spec, "pallas") == 2
    assert psr.launches_per_shard_round(spec, "ppermute") == 1
    k1 = _b5_kernel("community", shards=4)
    assert psr.row_ranges(k1.spec, "pallas")[0] == ()
    assert psr.launches_per_shard_round(k1.spec, "pallas") == 1


# ---- B5: the folded schedule ----------------------------------------------

def _unfused_rounds(k, S, G, avp, ap, rounds):
    """The schedule before the fold, with the plain versions: each round
    fires every shard, exchanges the halos, merges every row."""
    spec, shards = k.spec, k._shards
    nsh, L, H = spec.num_shards, spec.local, spec.halo
    for _ in range(rounds):
        avgs = [psr.sharded_fire_plain(sh.value, S[s], ap[s], sh.inv_depp1)
                for s, sh in enumerate(shards)]
        new = []
        for s, sh in enumerate(shards):
            lo = avgs[(s - 1) % nsh][L - H:]
            hi = avgs[(s + 1) % nsh][:H]
            new.append(psr.sharded_round_plain(
                S[s], G[s], avp[s], ap[s], sh.deg, avgs[s], lo, hi,
                sh.leaves, spec, 0, spec.local_rows))
        S = [n[0] for n in new]
        G = [n[1] for n in new]
        ap = [n[2] for n in new]
        avp = avgs
    return S, G, avp, ap


@pytest.mark.parametrize("name", ["ring", "grid", "community"])
@pytest.mark.parametrize("exchange", ["pallas", "ppermute"])
def test_folded_schedule_equals_unfused_rounds(name, exchange):
    k = _b5_kernel(name, shards=3, dtype="float32")
    k.exchange = exchange
    st = k.init_state()
    z = [torch.zeros(k.spec.local) for _ in k._shards]
    S, G, avp, ap = z, z, z, z
    for chunk in (1, 6, 33):
        st = k.run(st, chunk)
        S, G, avp, ap = _unfused_rounds(k, S, G, avp, ap, chunk)
        for got, want in ((st.S, S), (st.G, G), (st.avg_prev, avp),
                          (st.A_prev, ap)):
            for g, w in zip(got, want):
                assert torch.equal(g, w)
        for s, sh in enumerate(k._shards):    # the carried next fire
            assert torch.equal(st.avg[s], psr.sharded_fire_plain(
                sh.value, st.S[s], st.A_prev[s], sh.inv_depp1))
            assert st.avg[s] is not sh.avg[st.t % 2]   # the state's own


def _jax_pair(name, shards):
    jt = {"ring": lambda: jgen.ring(20000, 2),
          "grid": lambda: jgen.grid2d(64, 64)}[name]()
    pt = {"ring": lambda: pgen.ring(20000, 2),
          "grid": lambda: pgen.grid2d(64, 64)}[name]()
    jk = JaxShardedBandedKernel(
        jt, JaxConfig.fast(kernel="node", spmv="banded_fused",
                           dtype="float64"),
        jax_make_mesh(shards), plan=jcompile(jt, remainder="gather"),
        exchange="ppermute")
    pk = ShardedBandedKernel(
        pt, RoundConfig.fast(kernel="node", spmv="banded_fused",
                             dtype="float64"),
        make_mesh(shards, device="cpu"),
        plan=compile_topology(pt, remainder="gather"), exchange="pallas")
    return jk, pk


@pytest.mark.parametrize("name,shards", [("ring", 4), ("grid", 2)])
def test_folded_schedule_matches_jax_oracle_over_many_rounds(name, shards):
    jk, pk = _jax_pair(name, shards)
    js, ps = jk.init_state(), pk.init_state()
    for chunk in (40, 80):
        js, ps = jk.run(js, chunk), pk.run(ps, chunk)
        np.testing.assert_allclose(pk.estimates(ps), jk.estimates(js),
                                   **TOL)
        np.testing.assert_allclose(pk.last_avg(ps), jk.last_avg(js), **TOL)
    assert ps.t == 120


def test_state_from_jax_leaves_continues_the_folded_run():
    jk, pk = _jax_pair("ring", 2)
    js = jk.run(jk.init_state(), 7)        # an odd round: buffer 1
    leaves = {k: np.asarray(getattr(js, k))
              for k in ("t", "S", "G", "avg_prev", "A_prev")}
    ps = pk.state_from_numpy(leaves)
    assert ps.t == 7
    for s, sh in enumerate(pk._shards):
        assert ps.avg[s] is not sh.avg[1]         # the state's own
        assert torch.equal(ps.avg[s], psr.sharded_fire_plain(
            sh.value, ps.S[s], ps.A_prev[s], sh.inv_depp1))
    back = ps.to_numpy()
    assert set(back) == set(leaves)
    for name in ("S", "G", "avg_prev", "A_prev"):
        np.testing.assert_array_equal(back[name], leaves[name])
    ps = pk.run(ps, 53)
    js = jk.run(js, 53)
    assert ps.t == int(js.t) == 60
    np.testing.assert_allclose(pk.estimates(ps), jk.estimates(js), **TOL)
    np.testing.assert_allclose(pk.last_avg(ps), jk.last_avg(js), **TOL)


@pytest.mark.parametrize("exchange", ["pallas", "ppermute"])
def test_retained_state_is_a_value(exchange):
    """States are values, as in the JAX package: running twice from a
    retained state gives equal leaves, an old state still reads back its
    own round after later runs, and a state made from leaves is
    independent of the one they came from."""
    k = _b5_kernel("grid", shards=2)
    k.exchange = exchange

    def leaves(st):
        out = st.to_numpy()
        out["avg"] = np.stack([a.numpy() for a in st.avg])
        out["last_avg"] = k.last_avg(st)
        out["est"] = k.estimates(st)
        return out

    def same(a, b):
        assert set(a) == set(b)
        for name in a:
            np.testing.assert_array_equal(a[name], b[name])

    st0 = k.init_state()
    st1 = k.run(st0, 1)
    want0, want1 = leaves(st0), leaves(st1)
    same(leaves(k.run(st0, 1)), want1)    # twice from the same state
    st3 = k.run(st1, 2)
    want3 = leaves(st3)
    k.run(st3, 5)                         # later rounds, both parities
    k.run(st0, 4)
    same(leaves(st0), want0)              # old states read their own round
    same(leaves(st1), want1)
    same(leaves(k.run(st1, 2)), want3)
    # the latest state runs on, equal to one uninterrupted run
    same(leaves(k.run(st3, 3)), leaves(k.run(k.init_state(), 6)))
    # a state made from leaves is its own: running either leaves the other
    made = k.state_from_numpy(st1.to_numpy())
    same(leaves(made), want1)
    same(leaves(k.run(made, 2)), want3)
    k.run(st1, 3)
    same(leaves(made), want1)
    same(leaves(k.run(made, 2)), want3)
