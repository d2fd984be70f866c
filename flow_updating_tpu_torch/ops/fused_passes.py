"""Fused permutation-network passes: many stages per memory round trip.

Counterpart of ``flow_updating_tpu/ops/pallas_fused.py``.  The per-stage
executor (:func:`~flow_updating_tpu_torch.ops.permute.apply_stages`) reads
and writes the whole network array for every stage; here the stages are
segmented into passes that each make one trip:

* **local**: a run of swap stages whose pair blocks fit inside one tile —
  up to 32 butterflies ``x[p] <- x[p ^ d]``;
* **window**: a run of roll stages applied on the window ``[prev; own]``
  of two tiles, valid while the run's halo (:func:`halo_rows`) fits the
  tile (the halo-consumption argument of :func:`plan_fused`);
* **wide**: one stage whose partner lies a whole number of tiles away
  (``i ^ D`` for a swap, ``max(i - D, 0)`` for a roll) — one select;
* **wide2**: two adjacent wide stages of one kind merged into one pass.

The host planner (:func:`plan_fused`, :func:`pack_masks`) is the JAX
package's, unchanged in meaning: for the same ``block_rows`` it gives the
same passes and the same bit planes.  Only the default tile differs — the
TPU's 2,048-row VMEM block becomes :data:`DEFAULT_BLOCK_ROWS` rows of 128
elements, whose float64 window fits an SM's shared memory with room to
spare.  Unlike the JAX package there is no small-network cut-off: a
network narrower than one tile is one tile (``geometry``).

Each flavour has a plain torch version (``local_pass_plain`` ...), written
as the JAX pass bodies on the flat tile view (a tile is ``R`` rows of 128
elements; a row roll inside it is a flat roll), and a wrapper
(``local_pass`` ...) that takes the plain version for a CPU tensor and
launches kernel **B3** (``csrc/benes_pass.cu``) for a CUDA tensor,
counting each launch in its ``launches``.  :func:`apply_fused` runs a
whole plan and is bit-exact to ``apply_stages`` (pure data movement).

The module also holds kernel **B4**'s wrappers (``csrc/seg_scan.cu``),
:func:`segscan_pass` and :func:`fill_pass`: the segmented scan and the
fill-forward of the edge kernel's segment networks, whose stage masks
derive from a dist plane instead of stored bits (see the B4 section).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from flow_updating_tpu_torch import kernels
from flow_updating_tpu_torch.ops.permute import StagePlan

LANE = 128
MAX_STAGES_PER_PASS = 32
#: the card's tile height in rows of 128: 4,096 elements, so a float64
#: window (two tiles) takes 64 KiB of shared memory
DEFAULT_BLOCK_ROWS = 32
#: the kernels' largest tile (the local schedule's 12 position bits; the
#: window kernel's mask words of a whole window fit 32 KiB of shared
#: memory)
MAX_TILE = 4096

_KIND_CODE = {"local": 0, "window": 1, "wide_swap": 2, "wide_roll": 3,
              "wide_swap2": 4, "wide_roll2": 5}


@dataclasses.dataclass(frozen=True, eq=False)
class PassSpec:
    """One memory round trip."""

    kind: str            # 'local' | 'window' | 'wide_swap' | 'wide_roll'
    #                      | 'wide_swap2' | 'wide_roll2' (two merged stages)
    dists: tuple         # element distances, in stage order
    block_dist: int      # wide passes: partner distance in tiles
    block_dist2: int = 0  # wide2 passes: second stage's tile distance


@dataclasses.dataclass(frozen=True, eq=False)
class Geometry:
    """Tile geometry shared by every pass flavour."""

    P: int
    rows: int
    block_rows: int
    grid: int

    @property
    def tile(self) -> int:
        """Elements per tile (``P`` for a network narrower than a row)."""
        return self.P // self.grid


@dataclasses.dataclass(frozen=True, eq=False)
class FusedPlan:
    """Pass sequence for one :class:`StagePlan`."""

    geom: Geometry
    passes: tuple        # of PassSpec

    @property
    def P(self):
        return self.geom.P


def geometry(P: int, block_rows: int | None = None) -> Geometry:
    """Tiles of ``min(block_rows, P / 128)`` rows of 128 elements.  A
    network narrower than 128 elements (a power of two) is one tile of
    one row."""
    block_rows = DEFAULT_BLOCK_ROWS if block_rows is None else block_rows
    if P < LANE:
        if P < 2 or P & (P - 1):
            raise ValueError("a network narrower than 128 elements must "
                             "have a power-of-two width >= 2")
        return Geometry(P=P, rows=1, block_rows=1, grid=1)
    if P % LANE:
        raise ValueError(f"geometry needs P % {LANE} == 0 (or P < {LANE})")
    rows = P // LANE
    R = min(block_rows, rows)
    if R < 1 or R & (R - 1) or rows % R:
        raise ValueError("block_rows must be a power of two dividing rows")
    return Geometry(P=P, rows=rows, block_rows=R, grid=rows // R)


def halo_rows(dists) -> int:
    """Window-halo consumption of a stage run, in rows: a roll at
    distance d reads d/128 rows below, a lane distance costs one row."""
    return sum(max(d // LANE, 1) for d in dists)


def _classify(kind: str, d: int, R: int) -> str:
    """Pass flavour for one stage at a tile height of ``R`` rows."""
    rowd = d // LANE
    if kind == "swap":
        # the pair block of 2*rowd rows must fit in (and align to) R rows
        return "local" if (d < LANE or 2 * rowd <= R) else "wide_swap"
    return "window" if rowd < R else "wide_roll"


def plan_fused(plan: StagePlan, block_rows: int | None = None) -> FusedPlan:
    """Segment ``plan``'s stages into fused passes, preserving order.

    Halo rule for window passes: a roll at row distance dr reads dr rows
    below, so the own half of the ``[prev; own]`` window stays exact while
    the run's :func:`halo_rows` is at most ``R``.  Masked-on reads never
    hit the invalid prefix because the stage masks never select a
    wrapped-around source (checked by :func:`pack_masks`)."""
    geom = geometry(plan.n, block_rows)
    R = geom.block_rows
    passes = []
    cur_kind, cur_dists, cur_halo = None, [], 0

    def flush():
        nonlocal cur_kind, cur_dists, cur_halo
        if cur_dists:
            passes.append(PassSpec(kind=cur_kind, dists=tuple(cur_dists),
                                   block_dist=0))
        cur_kind, cur_dists, cur_halo = None, [], 0

    for d, kind in zip(plan.dists, plan.kinds):
        if kind == "swap" and d & (d - 1):
            raise ValueError(f"swap distance {d} is not a power of two")
        if kind == "roll" and d >= LANE and d % LANE:
            raise ValueError(
                f"roll distance {d} >= {LANE} must be a multiple of {LANE}")
        flavor = _classify(kind, d, R)
        if flavor in ("wide_swap", "wide_roll"):
            if (d // LANE) % R:
                raise ValueError(
                    f"wide stage distance {d} is not a multiple of the "
                    f"block ({R * LANE} elements)")
            flush()
            passes.append(PassSpec(kind=flavor, dists=(d,),
                                   block_dist=(d // LANE) // R))
            continue
        halo = max(d // LANE, 1) if flavor == "window" else 0
        if (cur_kind != flavor
                or len(cur_dists) >= MAX_STAGES_PER_PASS
                or (flavor == "window" and cur_halo + halo > R)):
            flush()
            cur_kind = flavor
        cur_dists.append(d)
        cur_halo += halo
    flush()
    # merge adjacent single-stage wide passes of one kind pairwise: two
    # stages per round trip (source tiles {0, D1, D2, D1+D2})
    merged = []
    for ps in passes:
        prev = merged[-1] if merged else None
        if (prev is not None and prev.kind in ("wide_swap", "wide_roll")
                and ps.kind == prev.kind):
            merged[-1] = PassSpec(kind=prev.kind + "2",
                                  dists=prev.dists + ps.dists,
                                  block_dist=prev.block_dist,
                                  block_dist2=ps.block_dist)
            continue
        merged.append(ps)
    return FusedPlan(geom=geom, passes=tuple(merged))


def pack_masks(plan: StagePlan, fused: FusedPlan) -> tuple:
    """Host mask planes, one flat ``(P,)`` array per pass, in pass order:
    local/window passes ``uint32`` (bit j = stage j of the pass), wide
    passes ``int8`` (wide2: bit 0 = first stage, bit 1 = second)."""
    planes = []
    s = 0
    for ps in fused.passes:
        n_stages = len(ps.dists)
        stage_masks = plan.masks[s: s + n_stages]
        if ps.kind in ("window", "wide_roll", "wide_roll2"):
            # the passes clamp/duplicate tile 0 where apply_stages' roll
            # wraps circularly, so a roll mask selecting a wrapped source
            # (p < d) would silently corrupt data: refuse it here
            for j, (d, m) in enumerate(zip(ps.dists, stage_masks)):
                if m[:d].any():
                    raise ValueError(
                        f"roll stage {s + j} (distance {d}) selects a "
                        f"wrapped-around source: mask is set below index "
                        f"{d}; fused kernels do not implement circular "
                        f"wrap (use the apply_stages path)")
        s += n_stages
        if ps.kind in ("local", "window"):
            plane = np.zeros(fused.P, np.uint32)
            for j, m in enumerate(stage_masks):
                plane |= m.astype(np.uint32) << j
        elif ps.kind in ("wide_swap2", "wide_roll2"):
            plane = (stage_masks[0].astype(np.int8)
                     | (stage_masks[1].astype(np.int8) << 1))
        else:
            plane = stage_masks[0].astype(np.int8)
        planes.append(plane)
    if s != len(plan.masks):
        raise ValueError("pass segmentation lost stages")
    return tuple(planes)


def mask_planes(plan: StagePlan, fused: FusedPlan, device) -> tuple:
    """:func:`pack_masks` as tensors on ``device``: the uint32 planes as
    ``torch.int32`` (the same bits — torch's uint32 lacks shifts and
    ``&``; bit 31 is the sign bit, which ``(m >> j) & 1`` still reads),
    the wide planes as ``torch.int8``."""
    out = []
    for p in pack_masks(plan, fused):
        if p.dtype == np.uint32:
            p = p.view(np.int32)
        out.append(torch.from_numpy(p).to(device))
    return tuple(out)


# ---------------------------------------------------------------------------
# plain versions: x3 is (B, grid, tile), a plane is (P,)
# ---------------------------------------------------------------------------

def _tiles(plane: torch.Tensor, geom: Geometry) -> torch.Tensor:
    return plane.reshape(geom.grid, geom.tile)


def _prev_tiles(t: torch.Tensor, axis: int) -> torch.Tensor:
    """Tile ``max(i - 1, 0)`` at position i along ``axis``."""
    first = t.narrow(axis, 0, 1)
    return torch.cat([first, t.narrow(axis, 0, t.shape[axis] - 1)], axis)


def local_pass_plain(x3: torch.Tensor, plane: torch.Tensor, ps: PassSpec,
                     geom: Geometry) -> torch.Tensor:
    """Butterflies ``x[p] <- x[p ^ d]`` inside each tile, as the JAX body:
    two rolls and two selects per stage."""
    m = _tiles(plane, geom)
    iota = torch.arange(geom.tile, dtype=torch.int64, device=x3.device)
    x = x3
    for j, d in enumerate(ps.dists):
        bit = ((m >> j) & 1) != 0
        hi = (iota & d) != 0
        x = torch.where(bit & hi, torch.roll(x, d, -1),
                        torch.where(bit & ~hi, torch.roll(x, -d, -1), x))
    return x


def window_pass_plain(x3: torch.Tensor, plane: torch.Tensor, ps: PassSpec,
                      geom: Geometry) -> torch.Tensor:
    """Rolls on the ``[prev; own]`` window, circular inside the window,
    keeping the own half (tile 0's window repeats tile 0)."""
    T = geom.tile
    m = _tiles(plane, geom)
    w = torch.cat([_prev_tiles(x3, 1), x3], -1)
    mw = torch.cat([_prev_tiles(m, 0), m], -1)
    for j, d in enumerate(ps.dists):
        bit = ((mw >> j) & 1) != 0
        w = torch.where(bit, torch.roll(w, d, -1), w)
    return w[..., T:]


def _partner_tiles(geom: Geometry, D: int, swap: bool, device):
    i = torch.arange(geom.grid, dtype=torch.int64, device=device)
    return i ^ D if swap else torch.clamp(i - D, min=0)


def wide_pass_plain(x3: torch.Tensor, plane: torch.Tensor, ps: PassSpec,
                    geom: Geometry) -> torch.Tensor:
    """One select against the partner tile."""
    swap = ps.kind == "wide_swap"
    src = _partner_tiles(geom, ps.block_dist, swap, x3.device)
    return torch.where(_tiles(plane, geom) != 0, x3[:, src], x3)


def wide2_pass_plain(x3: torch.Tensor, plane: torch.Tensor, ps: PassSpec,
                     geom: Geometry) -> torch.Tensor:
    """Two merged wide stages: four source tiles, two mask reads."""
    swap = ps.kind == "wide_swap2"
    D1, D2 = ps.block_dist, ps.block_dist2
    dev = x3.device
    at1 = _partner_tiles(geom, D1, swap, dev)
    at2 = _partner_tiles(geom, D2, swap, dev)
    at12 = (at1 ^ D2) if swap else _partner_tiles(geom, D1 + D2, False, dev)
    m = _tiles(plane, geom)
    m1_own = (m & 1) != 0
    m1_shift = (m[at2] & 1) != 0
    m2_own = (m & 2) != 0
    s1_own = torch.where(m1_own, x3[:, at1], x3)
    s1_shift = torch.where(m1_shift, x3[:, at12], x3[:, at2])
    return torch.where(m2_own, s1_shift, s1_own)


# ---------------------------------------------------------------------------
# kernel B3's local schedule: bit roles
# ---------------------------------------------------------------------------
#
# The local kernel holds a tile of 2^n words in registers.  A word's slot
# is ``k | lane << r | warp << (r + l)``: r = 4 register bits (16 words a
# thread), l = 5 lane bits, and the rest warp bits (fewer lanes and no
# warp bits below a 1,024-element tile).  A layout gives each slot bit the
# position bit it holds.  A stage at distance 2^b runs where b is a
# register bit (a select between two registers) or a lane bit (a warp
# shuffle), never a warp bit; between two layouts the words pass once
# through shared memory.  Lane bits are always 5 consecutive position
# bits, which keeps the kernel's swizzled shared-memory accesses free of
# bank conflicts, and a layout whose lanes start at position 0 writes the
# tile to device memory coalesced.

REG_BITS = 4
LANE_BITS = 5
#: ints in the schedule array the kernel reads (benes_pass.cu, kSchedInts)
SCHED_INTS = 1 + 2 * MAX_STAGES_PER_PASS + (MAX_STAGES_PER_PASS + 2) * 12


@dataclasses.dataclass(frozen=True)
class LocalSchedule:
    """How B3's local kernel runs one stage list on a tile of ``2**n``
    words: segments of stages, each run in one layout."""

    n: int
    reg_bits: int        # r: 2**r words per thread
    lane_bits: int       # l: 2**l lanes; the remaining bits are warps
    seg_end: tuple       # the first stage after each segment
    slots: tuple         # per stage, the slot bit it runs on
    layouts: tuple       # load, one per segment, store: for each slot bit
    #                      (registers, lanes, warps) the position bit

    @property
    def exchanges(self) -> int:
        """Passes of each batch row through shared memory."""
        return sum(a != b for a, b in zip(self.layouts, self.layouts[1:]))

    @functools.cached_property
    def c_ints(self):
        """The int array ``benes_pass`` takes for a local pass."""
        a = (ctypes.c_int * SCHED_INTS)()
        a[0] = len(self.seg_end)
        a[1: 1 + len(self.seg_end)] = self.seg_end
        base = 1 + MAX_STAGES_PER_PASS
        a[base: base + len(self.slots)] = self.slots
        for s, lay in enumerate(self.layouts):
            at = 1 + 2 * MAX_STAGES_PER_PASS + 12 * s
            a[at: at + self.n] = lay
        return a


def _fit_layout(bits, n: int, r: int, l: int):
    """A layout in which every bit of ``bits`` is a register or a lane
    bit, its lanes starting as low as they can; None if there is none.
    Spare register bits take the highest free positions."""
    for lo in range(n - l + 1):
        lanes = list(range(lo, lo + l))
        regs = sorted(set(bits).difference(lanes))
        if len(regs) > r:
            continue
        free = [b for b in range(n - 1, -1, -1)
                if b not in regs and not lo <= b < lo + l]
        regs = sorted(regs + free[: r - len(regs)])
        warps = [b for b in range(n) if b not in regs and not lo <= b < lo + l]
        return tuple(regs + lanes + warps)
    return None


@functools.lru_cache(maxsize=256)
def plan_local_schedule(dists: tuple, tile: int) -> LocalSchedule:
    """Cut a local pass's stage list into segments, each as long as its
    distinct bits fit one layout (greedy, so the fewest segments).  The
    tile comes in through shared memory in the first segment's layout and
    goes out to device memory in the last one's when that is coalesced
    (lanes from position 0), else in a coalesced layout of its own."""
    n = tile.bit_length() - 1
    if tile < 2 or tile != 1 << n or tile > MAX_TILE:
        raise ValueError(f"local pass: tile of {tile} elements is not a "
                         f"power of two in [2, {MAX_TILE}]")
    if not 1 <= len(dists) <= MAX_STAGES_PER_PASS:
        raise ValueError(f"local pass: {len(dists)} stages, the kernel "
                         f"takes 1 to {MAX_STAGES_PER_PASS}")
    bits = []
    for d in dists:
        if d <= 0 or d >= tile or d & (d - 1):
            raise ValueError(f"local stage distance {d} is not a power of "
                             f"two below the tile ({tile})")
        bits.append(d.bit_length() - 1)
    r = min(REG_BITS, n)
    l = min(LANE_BITS, n - r)
    seg_end, segs = [], []
    start = 0
    while start < len(bits):
        end = start + 1
        while (end < len(bits)
               and _fit_layout(bits[start: end + 1], n, r, l) is not None):
            end += 1
        seg_end.append(end)
        segs.append(_fit_layout(bits[start:end], n, r, l))
        start = end
    slots = tuple(lay.index(b)
                  for lay, lo, hi in zip(segs, [0] + seg_end, seg_end)
                  for b in bits[lo:hi])
    last = segs[-1]
    if l and last[r] != 0:
        last = _fit_layout((), n, r, l)
    return LocalSchedule(n=n, reg_bits=r, lane_bits=l, seg_end=tuple(seg_end),
                         slots=slots, layouts=(segs[0], *segs, last))


# ---------------------------------------------------------------------------
# kernel B3 wrappers
# ---------------------------------------------------------------------------

def _launch(x3: torch.Tensor, plane: torch.Tensor, ps: PassSpec,
            geom: Geometry, what: str) -> torch.Tensor:
    if x3.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x3.device}")
    if x3.dim() != 3 or x3.shape[1:] != (geom.grid, geom.tile) \
            or not x3.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous (B, {geom.grid}, "
                         f"{geom.tile}) tensor, got {tuple(x3.shape)}")
    if x3.element_size() not in (4, 8):
        raise ValueError(f"{what}: the kernel moves 4- or 8-byte words, "
                         f"got {x3.dtype}")
    stage_bits = ps.kind in ("local", "window")   # an int32 bit per stage
    want = torch.int32 if stage_bits else torch.int8
    if (plane.device != x3.device or plane.dtype != want
            or plane.numel() != geom.P or not plane.is_contiguous()):
        raise ValueError(f"{what}: the mask plane must be a contiguous "
                         f"({geom.P},) {want} tensor on the payload's "
                         "device")
    if geom.tile > MAX_TILE:
        raise ValueError(f"{what}: tile of {geom.tile} elements exceeds the "
                         f"kernel's {MAX_TILE}; plan with block_rows <= "
                         f"{MAX_TILE // LANE}")
    sched = (plan_local_schedule(ps.dists, geom.tile).c_ints
             if ps.kind == "local" else None)
    out = torch.empty_like(x3)
    dists = (ctypes.c_int * max(len(ps.dists), 1))(*ps.dists)
    fn = kernels.library("benes_pass").benes_pass
    kernels.check(fn(_KIND_CODE[ps.kind], x3.element_size(), x3.data_ptr(),
                     out.data_ptr(), plane.data_ptr(), geom.P, x3.shape[0],
                     geom.tile, len(ps.dists) if stage_bits else 0, dists,
                     ps.block_dist, ps.block_dist2, sched,
                     kernels.stream_ptr(x3)),
                  what)
    return out


def _wrapper(name: str, plain):
    def run(x3, plane, ps, geom):
        if x3.device.type == "cpu":
            return plain(x3, plane, ps, geom)
        out = _launch(x3, plane, ps, geom, name)
        run.launches += 1
        return out

    run.__name__ = run.__qualname__ = name
    run.__doc__ = (f"Kernel B3's {name.split('_')[0]} flavour: the plain "
                   f"version on a CPU tensor, the CUDA kernel (counted in "
                   f"``{name}.launches``) on a CUDA tensor.")
    run.launches = 0
    return run


local_pass = _wrapper("local_pass", local_pass_plain)
window_pass = _wrapper("window_pass", window_pass_plain)
wide_pass = _wrapper("wide_pass", wide_pass_plain)
wide2_pass = _wrapper("wide2_pass", wide2_pass_plain)

PASS_FNS = {"local": local_pass, "window": window_pass,
            "wide_swap": wide_pass, "wide_roll": wide_pass,
            "wide_swap2": wide2_pass, "wide_roll2": wide2_pass}
PLAIN_FNS = {"local": local_pass_plain, "window": window_pass_plain,
             "wide_swap": wide_pass_plain, "wide_roll": wide_pass_plain,
             "wide_swap2": wide2_pass_plain, "wide_roll2": wide2_pass_plain}


def apply_fused(x: torch.Tensor, fused: FusedPlan, planes) -> torch.Tensor:
    """Run every pass over the last axis of ``x`` (leading batch dims
    share the planes from :func:`mask_planes`); equal to
    ``apply_stages(x, stage_plan)`` bit for bit."""
    geom = fused.geom
    if x.shape[-1] != geom.P:
        raise ValueError(f"apply_fused: last axis {x.shape[-1]}, network "
                         f"width {geom.P}")
    lead = x.shape[:-1]
    x3 = x.reshape(-1, geom.grid, geom.tile)
    for ps, plane in zip(fused.passes, planes):
        x3 = PASS_FNS[ps.kind](x3, plane, ps, geom)
    return x3.reshape(*lead, geom.P)


def pass_min_bytes(ps: PassSpec, geom: Geometry, batch: int,
                   dtype_bytes: int) -> int:
    """The least bytes one pass must move: x read once, its mask plane
    read once, the output written once."""
    mask_bytes = 4 if ps.kind in ("local", "window") else 1
    return int(geom.P * (2 * batch * dtype_bytes + mask_bytes))


# ---------------------------------------------------------------------------
# kernel B4: the segmented scan and fill-forward passes over a dist plane
# ---------------------------------------------------------------------------
#
# The segment networks of the edge kernel (ops/seg_benes.py) run stages at
# d = 1, 2, 4, ... whose masks derive from one static int32 plane ``dist``
# (each edge's rank in its CSR row): ``dist >= d`` for the scan, bit ``d``
# of ``dist`` for the fill.  JAX runs them as one Pallas call while their
# halo fits its 2,048-row block and as an XLA stage loop otherwise; here
# :func:`plan_dist_passes` splits any stage list into consecutive window
# passes while the halo fits the card's tile, then one elementwise 'wide'
# pass per stage whose distance passes the tile.  The stages and their
# order are the loop's, so the result is the same.

SCAN_OPS = ("sum", "min", "max")
_B4_OP = {"sum": 0, "min": 1, "max": 2, "fill": 3}
#: the scan ops' combine functions (torch.minimum/maximum: a NaN wins)
_COMB = {"sum": torch.add, "min": torch.minimum, "max": torch.maximum,
         "all": torch.logical_and}


@dataclasses.dataclass(frozen=True)
class DistPass:
    """One B4 launch: ``kind`` 'window' (stages on ``[prev; own]``) or
    'wide' (one stage against ``x[p - d]``)."""

    kind: str
    dists: tuple


def plan_dist_passes(dists, geom: Geometry) -> tuple:
    """Split ascending stage distances into B4 passes (see above): a
    window pass holds stages while their :func:`halo_rows` fits the
    tile's ``block_rows`` (and at most 32 of them); a stage that alone
    passes it is a wide pass."""
    R = geom.block_rows
    passes, cur = [], []
    for d in dists:
        if halo_rows((d,)) > R or d >= geom.tile:
            if cur:
                passes.append(DistPass("window", tuple(cur)))
                cur = []
            passes.append(DistPass("wide", (d,)))
            continue
        if cur and (halo_rows(cur + [d]) > R
                    or len(cur) >= MAX_STAGES_PER_PASS):
            passes.append(DistPass("window", tuple(cur)))
            cur = []
        cur.append(d)
    if cur:
        passes.append(DistPass("window", tuple(cur)))
    return tuple(passes)


def scan_identity(op: str, dtype: torch.dtype):
    """0 for sum; the dtype's largest (min) or lowest (max) finite value —
    the JAX kernel's identities; True for the boolean 'all'."""
    if op == "sum":
        return 0
    if op == "all":
        return True
    info = (torch.finfo(dtype) if dtype.is_floating_point
            else torch.iinfo(dtype))
    return info.max if op == "min" else info.min


def dist_stage(w, src, dv, d: int, op: str):
    """One stage of the segmented scan or the fill: ``src`` is ``w`` rolled
    by ``d``; ``op`` is 'sum', 'min', 'max', 'all' or 'fill'.  A scan
    combines the source where ``dv >= d`` (the identity elsewhere); the
    fill takes it where bit ``d`` of ``dv`` is set."""
    if op == "fill":
        return torch.where((dv & d) != 0, src, w)
    ident = torch.tensor(scan_identity(op, w.dtype), dtype=w.dtype,
                         device=w.device)
    return _COMB[op](w, torch.where(dv >= d, src, ident))


def dist_pass_plain(x: torch.Tensor, dist: torch.Tensor, dp: DistPass,
                    op: str, geom: Geometry) -> torch.Tensor:
    """One B4 pass in plain torch; ``x`` is ``(B, P)``, ``dist`` ``(P,)``.
    A window pass rolls circularly inside ``[prev; own]`` (tile 0's window
    repeats tile 0) and keeps the own half, as the JAX kernel; a wide
    pass rolls the whole row."""
    if dp.kind == "wide":
        d = dp.dists[0]
        return dist_stage(x, torch.roll(x, d, -1), dist, d, op)
    T = geom.tile
    x3 = x.reshape(x.shape[0], geom.grid, T)
    dt = _tiles(dist, geom)
    w = torch.cat([_prev_tiles(x3, 1), x3], -1)
    dw = torch.cat([_prev_tiles(dt, 0), dt], -1)
    for d in dp.dists:
        w = dist_stage(w, torch.roll(w, d, -1), dw, d, op)
    return w[..., T:].reshape(x.shape)


def _launch_dist(x: torch.Tensor, dist: torch.Tensor, dp: DistPass,
                 op: str, geom: Geometry, what: str) -> torch.Tensor:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.dim() != 2 or x.shape[1] != geom.P or not x.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous (B, {geom.P}) "
                         f"tensor, got {tuple(x.shape)}")
    if (dist.device != x.device or dist.dtype != torch.int32
            or dist.numel() != geom.P or not dist.is_contiguous()):
        raise ValueError(f"{what}: the dist plane must be a contiguous "
                         f"({geom.P},) int32 tensor on the payload's device")
    if geom.tile > MAX_TILE:
        raise ValueError(f"{what}: tile of {geom.tile} elements exceeds the "
                         f"kernel's {MAX_TILE}")
    code = kernels.dtype_code(x)
    out = torch.empty_like(x)
    dists = (ctypes.c_int * len(dp.dists))(*dp.dists)
    fn = kernels.library("seg_scan").seg_scan
    kernels.check(fn(_B4_OP[op], code, x.data_ptr(), out.data_ptr(),
                     dist.data_ptr(), geom.P, x.shape[0], geom.tile,
                     len(dp.dists), dists, int(dp.kind == "wide"),
                     kernels.stream_ptr(x)), what)
    return out


def _run_dist_passes(x, dist, dists, op, geom, launch, what):
    lead = x.shape[:-1]
    if x.shape[-1] != geom.P:
        raise ValueError(f"{what}: last axis {x.shape[-1]}, network width "
                         f"{geom.P}")
    x2 = x.reshape(-1, geom.P)
    for dp in plan_dist_passes(dists, geom):
        x2 = launch(x2, dist, dp, op, geom)
    return x2.reshape(*lead, geom.P)


def segscan_pass_plain(x, dist, dists: tuple, op: str,
                       geom: Geometry) -> torch.Tensor:
    """The segmented scan of ``x`` (``(..., P)``) over the stages
    ``dists`` in plain torch, pass by pass as B4 runs it."""
    return _run_dist_passes(x, dist, dists, op, geom, dist_pass_plain,
                            "segscan_pass_plain")


def fill_pass_plain(x, dist, dists: tuple, geom: Geometry) -> torch.Tensor:
    """Fill-forward of ``x`` (``(..., P)``) in plain torch, as B4 runs it."""
    return _run_dist_passes(x, dist, dists, "fill", geom, dist_pass_plain,
                            "fill_pass_plain")


def segscan_pass(x, dist, dists: tuple, op: str,
                 geom: Geometry) -> torch.Tensor:
    """Kernel B4's scan: for each ``d`` in ``dists`` (ascending powers of
    two), ``x = comb(x, where(dist >= d, x[p - d], identity))`` over the
    last axis, ``comb`` in {sum, min, max}; leading batch dims share
    ``dist``.  The plain version on a CPU tensor; on a CUDA tensor one
    B4 launch per pass, each counted in ``segscan_pass.launches``."""
    if op not in SCAN_OPS:
        raise ValueError(f"segscan_pass: unknown op {op!r}")
    if x.device.type == "cpu":
        return segscan_pass_plain(x, dist, dists, op, geom)

    def launch(x2, dist, dp, op, geom):
        out = _launch_dist(x2, dist, dp, op, geom, "segscan_pass")
        segscan_pass.launches += 1
        return out

    return _run_dist_passes(x, dist, dists, op, geom, launch,
                            "segscan_pass")


def fill_pass(x, dist, dists: tuple, geom: Geometry) -> torch.Tensor:
    """Kernel B4's fill-forward: for each ``d`` in ``dists``, ``x =
    where(dist & d, x[p - d], x)``.  The plain version on a CPU tensor;
    on a CUDA tensor one B4 launch per pass, counted in
    ``fill_pass.launches``."""
    if x.device.type == "cpu":
        return fill_pass_plain(x, dist, dists, geom)

    def launch(x2, dist, dp, op, geom):
        out = _launch_dist(x2, dist, dp, op, geom, "fill_pass")
        fill_pass.launches += 1
        return out

    return _run_dist_passes(x, dist, dists, "fill", geom, launch,
                            "fill_pass")


segscan_pass.launches = 0
fill_pass.launches = 0


def dist_pass_min_bytes(geom: Geometry, batch: int, dtype_bytes: int) -> int:
    """The least bytes one B4 pass must move: x read once, the dist plane
    read once, the output written once."""
    return int(geom.P * (2 * batch * dtype_bytes + 4))
