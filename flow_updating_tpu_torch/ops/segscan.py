"""Segmented affine scan — the faithful pairwise mode's sequential fire.

Counterpart of ``flow_updating_tpu/ops/segscan.py``.  In the reference's
pairwise variant a node fires its stale neighbors one after another in a
tick (``flowupdating-pairwise.py:86-91``), each call reading the running
estimate the previous call left.  Each out-edge is the affine map ``x ->
a*x + b`` (``(x + est)/2`` when it fires, the identity otherwise), and a
node's out-edges are one contiguous segment of the edge axis, so the
whole tick is one segmented inclusive scan of map compositions.

The scan mirrors ``jax.lax.associative_scan``'s recursion step for step
— pair adjacent elements, scan the pairs, combine the evens, interleave
— so the products and sums happen in the JAX package's order and a
float64 run agrees with it to rounding at most (the contract is 1e-12).
It is plain torch on every device: the JAX package computes it outside
any Pallas kernel.
"""

from __future__ import annotations

import torch


def _combine(left, right, up):
    a1, b1, f1 = left
    a2, b2, f2 = right
    # right-after-left: x -> a2*(a1 x + b1) + b2, unless right starts a
    # new segment, in which case left is discarded
    a_out = torch.where(f2, a2, a2 * a1)
    b_out = torch.where(up(f2), b2, up(a2) * b1 + b2)
    return a_out, b_out, f1 | f2


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """``[e0, o0, e1, o1, ...]`` along axis 0.  JAX interleaves by padding
    both with zeros and adding (OR for booleans), which turns a -0.0 into
    +0.0; the ``+ 0`` repeats that."""
    n = even.shape[0] + odd.shape[0]
    out = even.new_empty((n,) + even.shape[1:])
    out[0::2] = even
    out[1::2] = odd
    return out if out.dtype == torch.bool else out + 0


def _scan(elems, up):
    n = elems[0].shape[0]
    if n < 2:
        return elems
    reduced = _combine([e[0:n - 1:2] for e in elems],
                       [e[1::2] for e in elems], up)
    odd = _scan(reduced, up)
    if n % 2 == 0:
        even = _combine([e[:-1] for e in odd],
                        [e[2::2] for e in elems], up)
    else:
        even = _combine(odd, [e[2::2] for e in elems], up)
    even = [torch.cat([e[:1], r]) for e, r in zip(elems, even)]
    return [_interleave(e, o) for e, o in zip(even, odd)]


def segmented_affine_scan(a: torch.Tensor, b: torch.Tensor,
                          seg_start: torch.Tensor):
    """Inclusive scan of affine-map composition within segments.

    Element i carries ``x -> a[i] * x + b[i]``; ``seg_start[i]`` is True
    where a segment begins.  Returns ``(A, B)``: the composition of maps
    ``seg_first..i`` is ``x -> A[i] * x + B[i]``.  ``b`` may carry a
    trailing feature axis; ``a`` and ``seg_start`` are 1-D."""
    seg_start = seg_start.to(torch.bool)
    ext = b.dim() - a.dim()
    up = ((lambda m: m.reshape(m.shape + (1,) * ext)) if ext
          else (lambda m: m))
    A, B, _ = _scan([a, b, seg_start], up)
    return A, B
