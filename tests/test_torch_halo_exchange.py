"""Kernel B6's plain versions and wrappers, on the host.

``ops/halo_exchange.py`` against a numpy transcription of the JAX kernel
body (``flow_updating_tpu/ops/pallas_halo.py:120-154``): shard ``me``
receives, for each offset ``d``, the block shard ``(me - d) % S`` sent —
``ppermute`` to ``(s + d) % S`` — and, fused, the ring buffers become
``np.where(hit, pay[None], buf)`` (``hit`` broadcast over a vector
payload's lanes) and ``valid | hit``.  JAX's kernel itself stops at
``pltpu.TPUMemorySpace`` under the installed jax (ROADMAP C), so the
transcription is the oracle.  Exact equality throughout: a select and a
copy round nothing.  The CUDA kernel is held against these plain versions
on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase k6).
"""

import numpy as np
import pytest
import torch

from flow_updating_tpu_torch.ops import halo_exchange as hx

S = 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def _numpy_exchange(blocks, offsets, me):
    """pallas_halo.py:120-131: one remote copy per offset to
    (s + d) % S, seen from the receiver."""
    return [blocks[(me - d) % len(blocks)][i] for i, d in enumerate(offsets)]


def _numpy_merge(hit, pay_flow, pay_est, buf_flow, buf_est, buf_valid):
    """pallas_halo.py:135-151."""
    hx_ = hit
    while hx_.ndim < buf_flow.ndim:
        hx_ = hx_[..., None]
    return (np.where(hx_, pay_flow[None], buf_flow),
            np.where(hx_, pay_est[None], buf_est), buf_valid | hit)


def _inputs(rng, D, nf, dtype, Eb=41, offsets=(1, 3)):
    feat = (nf,) if nf > 1 else ()
    blocks = [[rng.uniform(-1, 1, (2 * nf + 1, 3 + 2 * i)).astype(dtype)
               for i in range(len(offsets))] for _ in range(S)]
    merge = (rng.random((D, Eb)) < 0.4,
             rng.uniform(-1, 1, (Eb,) + feat).astype(dtype),
             rng.uniform(-1, 1, (Eb,) + feat).astype(dtype),
             rng.uniform(-1, 1, (D, Eb) + feat).astype(dtype),
             rng.uniform(-1, 1, (D, Eb) + feat).astype(dtype),
             rng.random((D, Eb)) < 0.5)
    return offsets, blocks, merge


def _t(blocks):
    return [[torch.from_numpy(b) for b in row] for row in blocks]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("nf", [1, 3])
@pytest.mark.parametrize("D", [1, 2, 3])
def test_plain_versions_match_numpy_transcription(D, nf, dtype):
    rng = np.random.default_rng(D * 10 + nf)
    offsets, blocks, merge = _inputs(rng, D, nf, dtype)
    tb = _t(blocks)
    tm = [torch.from_numpy(m) for m in merge]
    for me in range(S):
        want_got = _numpy_exchange(blocks, offsets, me)
        want = _numpy_merge(*merge)
        for entry in (hx.remote_block_exchange_plain,
                      hx.remote_block_exchange):
            got = entry(tb, offsets, me)
            assert len(got) == len(offsets)
            for g, w in zip(got, want_got):
                assert g.dtype == torch.from_numpy(w).dtype
                np.testing.assert_array_equal(g.numpy(), w)
        for entry in (hx.fused_exchange_merge_plain, hx.fused_exchange_merge):
            got, *bufs = entry(tb, offsets, me, *tm)
            for g, w in zip(got, want_got):
                np.testing.assert_array_equal(g.numpy(), w)
            for b, w in zip(bufs, want):
                assert b.dtype == torch.from_numpy(w).dtype
                np.testing.assert_array_equal(b.numpy(), w)


def test_plain_exchange_copies_and_counts_no_launch():
    rng = np.random.default_rng(0)
    offsets, blocks, merge = _inputs(rng, 2, 1, np.float64)
    tb = _t(blocks)
    before = (hx.remote_block_exchange.launches,
              hx.fused_exchange_merge.launches)
    got = hx.remote_block_exchange(tb, offsets, 0)
    hx.fused_exchange_merge(tb, offsets, 0,
                            *[torch.from_numpy(m) for m in merge])
    # the host takes the plain versions: no kernel launch is counted
    assert (hx.remote_block_exchange.launches,
            hx.fused_exchange_merge.launches) == before
    # the received block is a copy, not the sender's buffer
    got[0].zero_()
    assert tb[(0 - offsets[0]) % S][0].abs().sum() > 0
    # no offsets: nothing on the wire; the fused form needs one
    assert hx.remote_block_exchange(tb, (), 0) == []
    with pytest.raises(ValueError, match="at least one offset"):
        hx.fused_exchange_merge(tb, (), 0,
                                *[torch.from_numpy(m) for m in merge])


def test_wrappers_refuse_mixed_and_unsupported_devices():
    rng = np.random.default_rng(1)
    offsets, blocks, merge = _inputs(rng, 1, 1, np.float32)
    tb = _t(blocks)
    tm = [torch.from_numpy(m) for m in merge]
    meta = [[torch.empty(b.shape, device="meta") for b in row]
            for row in tb]
    with pytest.raises(ValueError, match="unsupported device"):
        hx.remote_block_exchange(meta, offsets, 0)
    mixed = [row if s else meta[s] for s, row in enumerate(tb)]
    with pytest.raises(ValueError, match="mix of devices"):
        hx.remote_block_exchange(mixed, offsets, 1)
    with pytest.raises(ValueError, match="mix of devices"):
        hx.fused_exchange_merge(tb, offsets, 0, tm[0].to("meta"), *tm[1:])


def test_min_bytes_counts_what_the_inputs_need():
    numels = [3 * 10, 3 * 7]
    # each block element read once and written once into its receive block
    assert hx.halo_exchange_min_bytes(numels, 4) == 2 * (30 + 21) * 4
    # the merge: hit read; a missed cell reads its valid flag and its two
    # ring-buffer values, a hit column its two payload values once; the
    # three output planes are written
    D, Eb, nf, isz = 2, 100, 3, 8
    hit = np.zeros((D, Eb), bool)
    hit[0, :30] = True
    hit[1, 20:40] = True
    cells, hits, cols = D * Eb, int(hit.sum()), int(hit.any(0).sum())
    pull = 2 * sum(numels) * isz
    merge = (cells + (cells - hits) + 2 * nf * isz * (cells - hits)
             + 2 * nf * isz * cols + 2 * cells * nf * isz + cells)
    assert hx.halo_exchange_min_bytes(numels, isz, D, Eb, nf, hits,
                                      cols) == pull + merge
    # with no cell hit, every ring-buffer value and flag is read
    assert hx.halo_exchange_min_bytes([], 4, 1, 10) == (
        10 + 10 + 2 * 4 * 10 + 2 * 10 * 4 + 10)
