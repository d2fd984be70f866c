"""The halo block pull and its fused ring-buffer merge (kernel B6).

Counterpart of ``flow_updating_tpu/ops/pallas_halo.py``
(``_exchange_kernel``, launched by ``remote_block_exchange`` and
``fused_exchange_merge``).  In the halo kernel's overlap schedule
(``parallel/overlap.py``) shard ``s`` sends one payload block per plan
offset ``d`` to shard ``(s + d) % S``: ``(2*nf+1, Hd)`` for the message
modes (flow lanes, estimate lanes, valid), ``(nf+1, Hd)`` for fast
pairwise (estimate lanes, valid), ``nf`` the number of feature lanes.
The JAX kernel starts one remote DMA per offset, merges the intra-shard
deliveries while they fly, and waits on the DMA semaphores.

Here the shards live in one process (``parallel/mesh.py``), so the
"remote" copy is a read of the sender's buffer — on the same card, or on
a peer card by pointer.  Kernel **B6** (``csrc/halo_exchange.cu``) is one
launch on the receiving shard's stream, in two parts:

* **block pull** — thread blocks copy each offset's incoming block from
  the sender's buffer (a device pointer in a small table passed by value)
  into this shard's receive block;
* **merge** (:func:`fused_exchange_merge` only) — the other thread blocks
  of the same grid do the receiver-pull select over the ``D x Eb`` cells,
  ``buf[d, e] = hit[d, e] ? payload[e] : buf[d, e]`` for the flow and the
  estimate planes (a vector payload's ``nf`` lanes share ``hit``), and
  ``valid |= hit``.  It reads none of the incoming blocks, so the two
  parts are independent inside the launch.

The kernel takes no flag and waits on nothing: the caller orders the
launch after every sender's payload on the receiving stream (an event),
and the payload blocks are never written after they are made.  Booleans
travel as bytes.  A sender on another card needs peer access
(``torch.cuda.can_device_access_peer``); without it the wrapper raises —
it never falls back to ``copy_``.

The plain versions :func:`remote_block_exchange_plain` and
:func:`fused_exchange_merge_plain` compute the same function with tensor
ops; the wrappers take them for CPU tensors only and launch B6 for CUDA
tensors (counted in their ``launches``).  A mix of devices raises.
"""

from __future__ import annotations

import ctypes

import torch

from flow_updating_tpu_torch import kernels

#: most offsets one launch takes (the pointer table is a kernel argument)
MAX_BLOCKS = 32

_peer_enabled: set = set()


def _senders(blocks_by_shard, offsets, me: int) -> list:
    """The block each offset brings to shard ``me``: offset ``d``'s block
    of shard ``(me - d) % S``."""
    S = len(blocks_by_shard)
    return [blocks_by_shard[(me - int(d)) % S][i]
            for i, d in enumerate(offsets)]


def remote_block_exchange_plain(blocks_by_shard, offsets, me: int) -> list:
    """Plain version of B6's block pull: ``blocks_by_shard[s][i]`` is
    shard ``s``'s block for offset ``offsets[i]``; returns, for each
    offset ``d``, a copy of the block of shard ``(me - d) % S`` on shard
    ``me``'s device — ``ppermute`` to ``(s + d) % S`` as seen by ``me``."""
    got = _senders(blocks_by_shard, offsets, me)
    if not got:
        return []
    dev = blocks_by_shard[me][0].device
    return [b.to(dev, copy=True) for b in got]


def fused_exchange_merge_plain(blocks_by_shard, offsets, me: int, hit,
                               pay_flow, pay_est, buf_flow, buf_est,
                               buf_valid):
    """Plain version of B6 with its merge: the block pull plus
    ``buf[d, e] = hit[d, e] ? pay[e] : buf[d, e]`` for the flow and the
    estimate planes (``hit`` broadcast over a vector payload's lanes) and
    ``valid | hit``.  ``hit`` is ``(D, Eb)`` bool, ``pay_*`` ``(Eb[, nf])``,
    ``buf_*`` ``(D, Eb[, nf])``.  Returns ``(received, buf_flow, buf_est,
    buf_valid)``."""
    got = remote_block_exchange_plain(blocks_by_shard, offsets, me)
    hx = hit.reshape(hit.shape + (1,) * (buf_flow.dim() - hit.dim()))
    return (got, torch.where(hx, pay_flow[None], buf_flow),
            torch.where(hx, pay_est[None], buf_est), buf_valid | hit)


def _device_kind(tensors) -> str:
    kinds = {t.device.type for t in tensors}
    if len(kinds) > 1:
        raise ValueError(f"halo exchange: tensors on a mix of devices "
                         f"({sorted(kinds)}); the plain version runs on the "
                         "host only, B6 on the card only")
    kind = kinds.pop()
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"halo exchange: unsupported device {kind}")
    return kind


def _enable_peer(dst: torch.device, src: torch.device) -> None:
    """Let ``dst``'s kernels read ``src``'s memory, or raise."""
    if (dst.index, src.index) in _peer_enabled:
        return
    if not torch.cuda.can_device_access_peer(dst, src):
        raise RuntimeError(
            f"halo exchange: {dst} cannot read {src}'s memory (no peer "
            "access); B6 pulls blocks by pointer and does not fall back "
            "to copy_")
    fn = kernels.library("halo_exchange").halo_enable_peer
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    kernels.check(fn(dst.index, src.index), "halo_enable_peer")
    _peer_enabled.add((dst.index, src.index))


def _check(t, shape, dtype, device, what):
    if (tuple(t.shape) != tuple(shape) or t.dtype != dtype
            or t.device != device or not t.is_contiguous()):
        raise ValueError(
            f"halo exchange: {what} must be a contiguous {tuple(shape)} "
            f"{dtype} tensor on {device}, got {tuple(t.shape)} {t.dtype} on "
            f"{t.device}")


def _launch(senders, dst_dev, merge):
    """One B6 launch on ``dst_dev``'s current stream; returns the receive
    blocks."""
    k = len(senders)
    if k > MAX_BLOCKS:
        raise ValueError(f"halo exchange: {k} offsets, B6 takes at most "
                         f"{MAX_BLOCKS} per launch")
    dtype = senders[0].dtype
    for b in senders:
        if b.dtype != dtype or not b.is_contiguous() or b.device.type \
                != "cuda":
            raise ValueError("halo exchange: blocks must be contiguous CUDA "
                             f"tensors of one dtype, got {b.dtype} on "
                             f"{b.device}")
        if b.device != dst_dev:
            _enable_peer(dst_dev, b.device)
    recv = [torch.empty(b.shape, dtype=dtype, device=dst_dev)
            for b in senders]
    table = ctypes.c_longlong * max(k, 1)
    src_p = table(*(b.data_ptr() for b in senders))
    dst_p = table(*(r.data_ptr() for r in recv))
    cnt = table(*(b.numel() for b in senders))
    cells, Eb, nf = 0, 1, 1
    ptrs = [None] * 9
    if merge is not None:
        hit, pay_flow, pay_est, buf_flow, buf_est, buf_valid = merge
        D, Eb = hit.shape
        nf = buf_flow[0, 0].numel() if buf_flow.numel() else 1
        cells = D * Eb
        out = (torch.empty_like(buf_flow), torch.empty_like(buf_est),
               torch.empty_like(buf_valid))
        ptrs = [t.data_ptr() for t in (hit, pay_flow, pay_est, buf_flow,
                                       buf_est, buf_valid, *out)]
    fn = kernels.library("halo_exchange").halo_exchange
    with torch.cuda.device(dst_dev):
        kernels.check(fn(
            kernels.dtype_code(senders[0]), k, ctypes.addressof(src_p),
            ctypes.addressof(dst_p), ctypes.addressof(cnt), cells, Eb, nf,
            *ptrs, torch.cuda.current_stream(dst_dev).cuda_stream),
            "halo_exchange")
    return recv, (out if merge is not None else None)


def remote_block_exchange(blocks_by_shard, offsets, me: int) -> list:
    """B6's block pull for shard ``me`` (the fast-pairwise exchange of
    ``halo='overlap_pallas'``).  CPU tensors take
    :func:`remote_block_exchange_plain`; CUDA tensors launch B6 once on
    ``me``'s device's current stream (``remote_block_exchange.launches``),
    which the caller has ordered after every sender."""
    senders = _senders(blocks_by_shard, offsets, me)
    if not senders:
        return []      # no cut edges: nothing on the wire, no launch
    mine = list(blocks_by_shard[me])
    if _device_kind(senders + mine) == "cpu":
        return remote_block_exchange_plain(blocks_by_shard, offsets, me)
    recv, _ = _launch(senders, mine[0].device, None)
    remote_block_exchange.launches += 1
    return recv


remote_block_exchange.launches = 0


def fused_exchange_merge(blocks_by_shard, offsets, me: int, hit, pay_flow,
                         pay_est, buf_flow, buf_est, buf_valid):
    """B6 with its merge, for shard ``me`` (the message modes of
    ``halo='overlap_pallas'``): the block pull plus the receiver-pull
    ring-buffer merge, in one launch.  CPU tensors take
    :func:`fused_exchange_merge_plain`; CUDA tensors launch B6 once
    (``fused_exchange_merge.launches``).  Returns ``(received, buf_flow,
    buf_est, buf_valid)``."""
    senders = _senders(blocks_by_shard, offsets, me)
    if not senders:
        raise ValueError("the fused merge needs at least one offset block")
    mine = list(blocks_by_shard[me])
    merge = (hit, pay_flow, pay_est, buf_flow, buf_est, buf_valid)
    if _device_kind(senders + mine + list(merge)) == "cpu":
        return fused_exchange_merge_plain(blocks_by_shard, offsets, me,
                                          *merge)
    dev = hit.device
    D, Eb = hit.shape
    feat = tuple(buf_flow.shape[2:])
    dt = buf_flow.dtype
    _check(hit, (D, Eb), torch.bool, dev, "hit")
    _check(buf_valid, (D, Eb), torch.bool, dev, "buf_valid")
    for t, shape, what in ((pay_flow, (Eb,) + feat, "pay_flow"),
                           (pay_est, (Eb,) + feat, "pay_est"),
                           (buf_flow, (D, Eb) + feat, "buf_flow"),
                           (buf_est, (D, Eb) + feat, "buf_est")):
        _check(t, shape, dt, dev, what)
    if senders[0].dtype != dt:
        raise ValueError("halo exchange: blocks and ring buffers differ in "
                         f"dtype ({senders[0].dtype} vs {dt})")
    recv, out = _launch(senders, dev, merge)
    fused_exchange_merge.launches += 1
    return (recv, *out)


fused_exchange_merge.launches = 0


def halo_exchange_min_bytes(block_numels, itemsize: int, D: int = 0,
                            Eb: int = 0, nf: int = 1, hit_cells: int = 0,
                            hit_columns: int = 0) -> int:
    """The least bytes one B6 launch must move for its inputs — its bound
    on the card: every incoming block read once and written once into its
    receive block; with the merge (``D > 0``), ``hit`` read once (1 byte a
    cell), and where a cell is hit its payload value (once per hit column
    ``e``, for the flow and the estimate plane) but neither its ring-buffer
    values nor its valid flag, where it is not the opposite; the three
    output planes written once.  ``hit_cells`` and ``hit_columns`` count
    the ``True`` cells of ``hit`` and its columns with any."""
    pull = 2 * sum(int(n) for n in block_numels) * itemsize
    if not D:
        return pull
    cells = D * Eb
    missed = cells - hit_cells
    reads = cells + missed + 2 * nf * itemsize * (missed + hit_columns)
    writes = 2 * cells * nf * itemsize + cells
    return pull + reads + writes
