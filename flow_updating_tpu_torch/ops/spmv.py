"""Degree-bucketed ELL neighbor sum ``A(x)[u] = sum_{v in N(u)} x[v]``.

Counterpart of ``flow_updating_tpu/ops/pallas_spmv.py`` and of
``neighbor_sum`` in ``flow_updating_tpu/models/sync.py``.  The node
vector lives in the ELL bucket order (``Topology.ell_buckets``); bucket
``b`` is a dense ``(rows_b, width_b)`` int32 matrix of neighbor slots, the
slot ``M = len(x)`` standing for zero.

* :func:`neighbor_sum` — the plain PyTorch version (gather + row sum),
  ``(M,)`` or ``(M, D)`` payloads.  The node kernel's ``spmv='xla'`` path
  and the banded plan's gather remainder use it on every device.
* :func:`neighbor_sum_ell` — kernel **K1** (``csrc/spmv_ell.cu``), the
  ``spmv='pallas'`` path.  On a CUDA tensor it launches the hand-written
  kernel once per non-empty bucket and counts each launch in
  ``neighbor_sum_ell.launches``; on a CPU tensor it returns the plain
  version.  Nothing falls back from the card to the plain version.

K1 replaces ``_spmv_bucket_kernel`` (``ops/pallas_spmv.py:35-41``).  On the
H100 it is bound by bytes: the index matrices are the bulk of the traffic
(``4 * sum(rows_b * width_b)`` bytes per call, :func:`neighbor_sum_min_bytes`)
while ``x`` stays resident in the 50 MB L2; see the note in the CUDA
source for the thread/warp per-row split.
"""

from __future__ import annotations

import torch

from flow_updating_tpu_torch import kernels

#: bucket row counts are padded to this multiple on the ``spmv='pallas'``
#: path, so the state layout matches the JAX package's (its Pallas grid
#: walks 256-row blocks)
BLOCK_ROWS = 256


def neighbor_sum(x: torch.Tensor, mats) -> torch.Tensor:
    """A(x) by bucketed gather + row sums (the plain version).  ``x`` is
    ``(M,)`` or ``(M, D)``; the gather and row sum broadcast over the
    trailing feature axis."""
    feat = x.shape[1:]
    xp = torch.cat([x, x.new_zeros((1,) + feat)])
    parts = []
    for m in mats:
        if m.shape[1] == 0:
            parts.append(x.new_zeros((m.shape[0],) + feat))
        else:
            parts.append(xp[m].sum(dim=1))
    return torch.cat(parts) if len(parts) > 1 else parts[0]


def neighbor_sum_ell(x: torch.Tensor, mats) -> torch.Tensor:
    """Kernel K1's wrapper: A(x) for a scalar ``(M,)`` payload.

    CPU tensors take :func:`neighbor_sum`.  CUDA tensors launch
    ``csrc/spmv_ell.cu`` once per bucket of nonzero width (buckets of
    width 0 are zero-filled) and raise on anything the kernel does not
    take.  Every index must lie in ``[0, M]``."""
    if x.device.type == "cpu":
        return neighbor_sum(x, mats)
    if x.device.type != "cuda":
        raise ValueError(f"neighbor_sum_ell: unsupported device {x.device}")
    if x.dim() != 1 or not x.is_contiguous():
        raise ValueError("neighbor_sum_ell: the kernel takes a contiguous "
                         f"(M,) payload, got shape {tuple(x.shape)}")
    code = kernels.dtype_code(x)
    M = x.shape[0]
    for m in mats:
        if (m.device != x.device or m.dtype != torch.int32 or m.dim() != 2
                or not m.is_contiguous()):
            raise ValueError("neighbor_sum_ell: bucket matrices must be "
                             "contiguous 2-D int32 tensors on the payload's "
                             "device")
    out = torch.empty(sum(m.shape[0] for m in mats), dtype=x.dtype,
                      device=x.device)
    fn = kernels.library("spmv_ell").spmv_ell
    stream = kernels.stream_ptr(x)
    row0 = 0
    for m in mats:
        rows, width = m.shape
        part = out[row0:row0 + rows]
        if width == 0:
            part.zero_()
        elif rows:
            kernels.check(fn(code, x.data_ptr(), m.data_ptr(),
                             part.data_ptr(), rows, width, M, stream),
                          "spmv_ell")
            neighbor_sum_ell.launches += 1
        row0 += rows
    return out


neighbor_sum_ell.launches = 0


def neighbor_sum_min_bytes(mats, num_slots: int, dtype_bytes: int) -> int:
    """The least bytes one bucketed neighbor sum must move: ``x`` read
    once (``num_slots`` values), every index read once, every row
    written once — the numerator of K1's bound on the card."""
    idx = sum(int(m.shape[0]) * int(m.shape[1]) for m in mats)
    rows = sum(int(m.shape[0]) for m in mats)
    return int(num_slots * dtype_bytes + 4 * idx + rows * dtype_bytes)
