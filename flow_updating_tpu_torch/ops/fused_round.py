"""One-kernel banded round: fire, band delivery, remainder and merge.

Counterpart of ``flow_updating_tpu/ops/pallas_round.py`` (single-device
form: ``pallas_round.py:57-484, 670-702``).  The banded executor
(``plan/banded.py`` driven by ``models/sync.py``) runs one round as
separate tensor ops — the fire (an elementwise ``avg`` update), one
masked roll per kept diagonal, the remainder gather and the ledger merge.
Kernel **K2** (``csrc/fused_round.cu``) runs the whole round in one launch:

1. **fire** — ``avg = (value - S + A_prev) * inv``;
2. **deliver** — ``acc = acc + (bit_d ? avg[p + d] : 0)`` for every kept
   diagonal in plan order, the masks bit-packed 32 diagonals per
   ``uint32`` plane;
3. **remainder** — ``rem_route='lanes'``: the plan's gather remainder is
   computed outside the kernel by the same plain function the banded
   executor uses and enters as one input (keeps the fused round
   bit-identical to the unfused one); ``'inline'``: a per-row gather in
   the kernel over the tile window (order-equivalent sums: exact on
   integer payloads only, as in the TPU kernel);
4. **merge** — ``S' = -G - acc + deg*avg_prev``,
   ``G' = -S - deg*avg + A_prev``.

The host planning (:func:`plan_fused_round`, :func:`choose_block_rows`,
:func:`pack_band_planes`, :func:`build_fused_leaves`,
:func:`_rem_window_index`) is the JAX package's, so both packages pad to
the same tile grid and pack identical bit planes; the tile height only
shapes the padding and the 'inline' window coordinates here.

K2 replaces ``_round_kernel`` (``ops/pallas_round.py:331-402``).  On the
H100 it is bound by bytes: one round must read five payload planes, the
two per-node constants, the bit planes and the remainder input and write
four payload planes (:func:`fused_round_min_bytes`;
:func:`fused_round_bytes` is the TPU kernel's count, which re-reads its
window tiles).  The CUDA kernel reads each
neighbor operand only when its bit is set, from cache.

:func:`fused_round_plain` is the plain PyTorch version; the CPU tests run
it and ``chip_smoke.py`` holds the kernel against it on the card.
:func:`fused_banded_round` is the wrapper: the plain version for CPU
tensors, the kernel (one launch, counted in
``fused_banded_round.launches``) for CUDA tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from flow_updating_tpu_torch import kernels
from flow_updating_tpu_torch.models.state import _ex
from flow_updating_tpu_torch.utils.cost import declares

LANE = 128
#: default band-tile height (rows of 128 lanes)
DEFAULT_BLOCK_ROWS = 512
#: smallest tile height
MIN_BLOCK_ROWS = 8

_ROUTES = {"none": 0, "lanes": 1, "inline": 2}


@dataclasses.dataclass(frozen=True, eq=False)
class FusedRoundSpec:
    """Static descriptor of one fused-round program."""

    n: int               # real node count (RCM space)
    P: int               # padded vector length (rows * 128)
    rows: int
    block_rows: int      # tile height R; window is [prev; own; next]
    grid: int            # rows // block_rows
    offsets: tuple       # kept signed diagonals, plan order
    rem_route: str       # 'none' | 'lanes' | 'inline'
    rem_width: int       # 'inline': padded per-row remainder degree
    n_planes: int        # bitpacked band-mask planes (32 offsets each)

    @property
    def needs_window(self) -> bool:
        """Band shifts and inline gathers read beyond the own tile."""
        return bool(self.offsets) or self.rem_route == "inline"


@dataclasses.dataclass(frozen=True)
class FusedRoundLeaves:
    """Tensors of one fused-round program."""

    planes: torch.Tensor          # (n_planes, P) int32 — the uint32 bit
    #                               planes, reinterpreted
    offsets: torch.Tensor         # (len(spec.offsets),) int32
    rem_idx: torch.Tensor | None  # 'inline': (P, W) int32 window coords,
    #                               -1 = empty slot; else None

    def to(self, device) -> FusedRoundLeaves:
        return FusedRoundLeaves(
            planes=self.planes.to(device), offsets=self.offsets.to(device),
            rem_idx=None if self.rem_idx is None else self.rem_idx.to(device))


def _ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def choose_block_rows(n: int, max_abs_offset: int,
                      block_rows: int | None = None) -> int:
    """Tile height for a graph of ``n`` nodes and RCM half-bandwidth
    ``max_abs_offset``: the smallest power of two >= MIN_BLOCK_ROWS that
    covers the bandwidth, capped at the whole (lane-padded) array.  An
    explicit ``block_rows`` is validated and used as-is."""
    rows_all = _ceil_to(max(n, 1), LANE * MIN_BLOCK_ROWS) // LANE
    need = max(MIN_BLOCK_ROWS, -(-max_abs_offset // LANE))
    if block_rows is not None:
        r = int(block_rows)
        if r < MIN_BLOCK_ROWS or r & (r - 1):
            raise ValueError(
                f"block_rows={r} must be a power of two >= "
                f"{MIN_BLOCK_ROWS}")
        if r * LANE < max_abs_offset and r < rows_all:
            raise ValueError(
                f"block_rows={r} tile ({r * LANE} elements) cannot cover "
                f"the plan's bandwidth {max_abs_offset}; the halo window "
                "would read beyond the neighbor tiles")
        return min(r, 1 << (rows_all - 1).bit_length())
    r = MIN_BLOCK_ROWS
    while r < need or r < DEFAULT_BLOCK_ROWS // 8:
        r <<= 1
    r = min(max(r, MIN_BLOCK_ROWS), DEFAULT_BLOCK_ROWS * 8)
    while r * LANE >= max(n, 1) * 2 and r > MIN_BLOCK_ROWS:
        r >>= 1
    if r * LANE < max_abs_offset:
        r = 1 << (rows_all - 1).bit_length()  # whole array, one tile
    return r


def plan_fused_round(spmv, *, block_rows: int | None = None,
                     rem_route: str = "auto") -> FusedRoundSpec:
    """The static spec for a :class:`~flow_updating_tpu_torch.plan.banded.
    BandedSpmvPlan`.  ``rem_route='auto'`` keeps the plan's remainder on
    its outside gather ('lanes', bit-exact); 'inline' gathers it in the
    kernel; 'none' asserts the plan has no remainder."""
    offs = tuple(int(d) for d in spmv.offsets)
    H = max((abs(d) for d in offs), default=0)
    route = rem_route
    if spmv.rem_mode == "none":
        route = "none"
    elif route == "auto":
        route = "lanes"
    if route == "none" and spmv.rem_mode != "none":
        raise ValueError(
            f"rem_route='none' but the plan routes {spmv.remainder_edges} "
            "edge(s) through its remainder — use 'lanes' or 'inline'")
    if route == "inline" and spmv.rem_mode != "gather":
        raise ValueError(
            "rem_route='inline' gathers the plan's bucketed ELL "
            f"remainder in-kernel; this plan's remainder is "
            f"{spmv.rem_mode!r} — recompile with remainder='gather' or "
            "keep rem_route='lanes'")
    if route not in _ROUTES:
        raise ValueError(f"unknown rem_route {rem_route!r}")
    W = 0
    if route == "inline":
        W = max((s[1] for s in spmv.rem_bucket_shapes), default=0)
    R = choose_block_rows(spmv.n, H, block_rows)
    P = _ceil_to(max(spmv.n, 1), R * LANE)
    rows = P // LANE
    return FusedRoundSpec(
        n=spmv.n, P=P, rows=rows, block_rows=R, grid=rows // R,
        offsets=offs, rem_route=route, rem_width=W,
        n_planes=-(-len(offs) // 32),
    )


def pack_band_planes(band_masks, P: int, n_planes: int) -> list:
    """Bitpack per-offset bool band masks into flat ``(P,)`` uint32
    planes, 32 offsets each."""
    planes = []
    for g in range(n_planes):
        plane = np.zeros(P, np.uint32)
        for j, mask in enumerate(band_masks[g * 32:(g + 1) * 32]):
            m = np.asarray(mask)
            plane[:m.shape[0]] |= m.astype(np.uint32) << j
        planes.append(plane)
    return planes


def build_fused_leaves(spmv, leaves, spec: FusedRoundSpec
                       ) -> FusedRoundLeaves:
    """Bitpack the plan's band masks (and, inline route, flatten the
    bucketed remainder ELL to window coordinates) into CPU tensors."""
    planes = pack_band_planes(leaves.band_masks, spec.P, spec.n_planes)
    stacked = (np.stack(planes) if planes
               else np.zeros((0, spec.P), np.uint32))
    rem_idx = None
    if spec.rem_route == "inline":
        rem_idx = torch.from_numpy(_rem_window_index(spmv, leaves, spec))
    return FusedRoundLeaves(
        planes=torch.from_numpy(stacked.view(np.int32)),
        offsets=torch.tensor(spec.offsets, dtype=torch.int32),
        rem_idx=rem_idx)


def _rem_window_index(spmv, leaves, spec: FusedRoundSpec) -> np.ndarray:
    """Per-row remainder neighbor matrix in WINDOW coordinates, ``(P, W)``.

    The bucketed ELL (``rem_mats`` grouped by degree, ``rem_pos`` row ->
    bucket position) is flattened back to row order at the global max
    width; each index then shifts by the owning tile's window origin
    ``(tile - 1) * R * 128``.  Empty slots are -1.  Raises when a
    remainder edge reaches beyond the tile window."""
    n, W = spec.n, max(spec.rem_width, 1)
    R = spec.block_rows
    out = np.full((spec.P, W), -1, np.int64)
    rem_pos = np.asarray(leaves.rem_pos) if leaves.rem_pos is not None \
        else None
    if rem_pos is not None and spmv.remainder_edges:
        flat = np.full((n, W), -1, np.int64)
        row0 = 0
        for m in leaves.rem_mats:
            m = np.asarray(m)
            rows_b, w = m.shape
            if w:
                blk = m.astype(np.int64)
                blk = np.where(blk >= n, -1, blk)  # n = the pad slot
                flat[row0:row0 + rows_b, :w] = blk
            row0 += rows_b
        out[:n] = flat[rem_pos]
        span = np.abs(out[:n] - np.arange(n)[:, None],
                      where=out[:n] >= 0, out=np.zeros_like(out[:n]))
        if span.max(initial=0) > R * LANE:
            raise ValueError(
                f"remainder reach {int(span.max())} exceeds the "
                f"{R * LANE}-element tile window; use rem_route='lanes' "
                "or a larger block_rows")
    tile = np.arange(spec.P, dtype=np.int64) // (R * LANE)
    origin = (tile - 1) * (R * LANE)
    out = np.where(out >= 0, out - origin[:, None], -1)
    return out.astype(np.int32)


def fused_round_plain(S, G, avg_prev, A_prev, value, inv_depp1, deg,
                      leaves: FusedRoundLeaves, spec: FusedRoundSpec,
                      a_rem=None):
    """The plain PyTorch version of K2: the same round, op by op.

    Node arrays are ``(P,)`` or ``(P, D)``; ``inv_depp1``/``deg`` are
    ``(P,)``.  Returns ``(S_next, G_next, avg, A_cur)``."""
    inv = _ex(inv_depp1, value)
    dg = _ex(deg, value)
    avg = (value - S + A_prev) * inv
    acc = torch.zeros_like(avg)
    for gi, d in enumerate(spec.offsets):
        bit = ((leaves.planes[gi // 32] >> (gi % 32)) & 1) != 0
        acc = acc + torch.where(_ex(bit, avg), torch.roll(avg, -d, 0), 0)
    if spec.rem_route == "inline":
        idx = leaves.rem_idx
        tile = spec.block_rows * LANE
        origin = (torch.arange(spec.P, device=idx.device) // tile - 1) * tile
        valid = idx >= 0
        gathered = avg[torch.where(valid, origin[:, None] + idx, 0)]
        acc = acc + torch.where(_ex(valid, gathered), gathered, 0).sum(dim=1)
    elif spec.rem_route == "lanes":
        acc = acc + a_rem
    S_next = -G - acc + dg * avg_prev
    G_next = -S - dg * avg + A_prev
    return S_next, G_next, avg, acc


def _k2_cost(S, G, avg_prev, A_prev, value, inv_depp1, deg, leaves,
             spec, a_rem=None) -> tuple:
    """K2's declared work: :func:`fused_round_min_bytes`; per node and
    lane, fire 3, one add per kept diagonal, the remainder add, merge 8."""
    D = S.numel() // max(spec.P, 1)
    return (fused_round_min_bytes(spec, dtype_bytes=S.element_size(),
                                  features=D),
            spec.P * (12 + len(spec.offsets)) * D)


@declares("K2", _k2_cost)
def fused_banded_round(S, G, avg_prev, A_prev, value, inv_depp1, deg,
                       leaves: FusedRoundLeaves, spec: FusedRoundSpec,
                       a_rem=None):
    """Kernel K2's wrapper: one full Flow-Updating round.

    All node arrays are ``(P,)`` or ``(P, D)`` with ``P = spec.P`` (the
    node kernel pads to the tile grid).  CPU tensors take
    :func:`fused_round_plain`; CUDA tensors launch ``csrc/fused_round.cu``
    once and raise on anything the kernel does not take.  Returns
    ``(S_next, G_next, avg, A_cur)``."""
    if spec.rem_route == "lanes" and a_rem is None:
        raise ValueError("rem_route='lanes' needs the precomputed "
                         "remainder addend (a_rem)")
    if S.device.type == "cpu":
        return fused_round_plain(S, G, avg_prev, A_prev, value, inv_depp1,
                                 deg, leaves, spec, a_rem=a_rem)
    if S.device.type != "cuda":
        raise ValueError(f"fused_banded_round: unsupported device {S.device}")
    code = kernels.dtype_code(S)
    if S.shape[0] != spec.P or S.dim() not in (1, 2):
        raise ValueError(f"fused_banded_round: payload must be ({spec.P},) "
                         f"or ({spec.P}, D), got {tuple(S.shape)}")
    D = S.shape[1] if S.dim() == 2 else 1
    if not 1 <= D <= 65535:
        raise ValueError(f"fused_banded_round: D={D} outside [1, 65535]")
    payload = [S, G, avg_prev, A_prev, value]
    if spec.rem_route == "lanes":
        payload.append(a_rem)
    for t in payload:
        if (t.shape != S.shape or t.dtype != S.dtype or t.device != S.device
                or not t.is_contiguous()):
            raise ValueError("fused_banded_round: payload arrays must share "
                             "shape, dtype and device, and be contiguous")
    for t in (inv_depp1, deg):
        if (t.shape != (spec.P,) or t.dtype != S.dtype
                or t.device != S.device or not t.is_contiguous()):
            raise ValueError("fused_banded_round: inv_depp1/deg must be "
                             f"contiguous ({spec.P},) {S.dtype} tensors on "
                             "the payload's device")
    idx_ok = (leaves.planes.shape == (spec.n_planes, spec.P)
              and leaves.offsets.shape == (len(spec.offsets),))
    for t in (leaves.planes, leaves.offsets):
        idx_ok = idx_ok and (t.dtype == torch.int32 and t.device == S.device
                             and t.is_contiguous())
    rem_w = 0
    if spec.rem_route == "inline":
        t = leaves.rem_idx
        rem_w = max(spec.rem_width, 1)
        idx_ok = idx_ok and (t is not None and t.shape == (spec.P, rem_w)
                             and t.dtype == torch.int32
                             and t.device == S.device and t.is_contiguous())
    if not idx_ok:
        raise ValueError("fused_banded_round: leaves do not match the spec "
                         "(int32, contiguous, on the payload's device)")
    outs = [torch.empty_like(S) for _ in range(4)]
    fn = kernels.library("fused_round").fused_round
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    kernels.check(fn(
        code, _ROUTES[spec.rem_route], spec.P, D, len(spec.offsets),
        leaves.offsets.data_ptr(), leaves.planes.data_ptr(),
        value.data_ptr(), S.data_ptr(), G.data_ptr(), avg_prev.data_ptr(),
        A_prev.data_ptr(), inv_depp1.data_ptr(), deg.data_ptr(),
        ptr(a_rem if spec.rem_route == "lanes" else None),
        ptr(leaves.rem_idx if spec.rem_route == "inline" else None),
        rem_w, spec.block_rows * LANE,
        *(o.data_ptr() for o in outs), kernels.stream_ptr(S)),
        "fused_round")
    fused_banded_round.launches += 1
    return tuple(outs)


fused_banded_round.launches = 0


def fused_round_bytes(spec: FusedRoundSpec, *, dtype_bytes: int = 4,
                      features: int = 1) -> dict:
    """Bytes one fused round moves in the TPU kernel's accounting (its
    window tiles read three times), vs the unfused banded executor —
    carried over from the JAX package for comparison with
    :func:`fused_round_min_bytes`."""
    D = max(features, 1)
    vec = spec.P * dtype_bytes
    window = 3 if spec.needs_window else 1
    reads = ((3 * D + 1) * window + (2 * D + 1)) * vec \
        + spec.n_planes * spec.P * 4
    if spec.rem_route == "inline":
        reads += spec.P * max(spec.rem_width, 1) * 4
    writes = 4 * D * vec
    fused_passes = 1
    if spec.rem_route == "lanes":
        reads += D * vec            # the precomputed remainder addend
        fused_passes += 1           # the outside avg+remainder pass
    lanes = len(spec.offsets)
    unfused = (3 * lanes + 6) * D * vec
    return {
        "bytes_per_round": int(reads + writes),
        "unfused_bytes_per_round": int(unfused),
        "passes_per_round": fused_passes,
        "unfused_passes_per_round": 3 * lanes + 6,
        "band_lanes": lanes,
        "tile_rows": spec.block_rows,
        "grid": spec.grid,
        "rem_route": spec.rem_route,
    }


def fused_round_min_bytes(spec: FusedRoundSpec, *, dtype_bytes: int = 4,
                          features: int = 1) -> int:
    """The least bytes one round must move: every input read once (five
    payload planes, inv and deg, the bit planes and offsets, the
    remainder input) and the four payload outputs written once — the
    numerator of K2's bound on the card."""
    D = max(features, 1)
    vec = spec.P * dtype_bytes
    reads = 5 * D * vec + 2 * vec + spec.n_planes * spec.P * 4 \
        + len(spec.offsets) * 4
    if spec.rem_route == "lanes":
        reads += D * vec
    elif spec.rem_route == "inline":
        reads += spec.P * max(spec.rem_width, 1) * 4
    return int(reads + 4 * D * vec)
