"""Per-node reductions over the edge axis (``segment_impl='segment'|'ell'``).

Counterpart of ``flow_updating_tpu/ops/segment.py``.  Edges are sorted
by ``src``, so a node's out-edges are one contiguous CSR row and every
per-node reduction — the flow ledger sum, the all-neighbors-heard test,
the drain's oldest-message pick — is a reduction over rows.

* ``segment_*`` — ``torch.segment_reduce`` with ``lengths=out_deg``: it
  walks each row in edge order, one thread per row on the card, so the
  additions come in the same order on every run and on every device.
  ``index_add_``/``scatter_reduce`` would add in a nondeterministic order
  on the card (atomics) and are not used.  The reduction starts from the
  identity (``initial``), as the JAX package's scatter into a filled
  array does, so an empty row (an isolated node) reads the identity.
  ``segment_reduce`` takes floating payloads only: integer keys ride it
  as float64, which holds every int32 exactly.
* ``rows_segment_*`` — the sweep engine's uniform-width row layout: the
  ``W`` columns folded in edge order.
* ``ell_segment_*`` — the degree-bucketed out-edge ELL layout: a gather
  per bucket, a row reduction, and one ``(N,)`` unpermute.

Every function takes ``(E,)`` or ``(E, D)`` payloads.
"""

from __future__ import annotations

import torch


def _identity(op: str, dtype: torch.dtype):
    if op == "sum":
        return 0
    if dtype.is_floating_point:
        return float("inf") if op == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if op == "min" else info.min


def _segment(data: torch.Tensor, out_deg: torch.Tensor, op: str):
    ident = _identity(op, data.dtype)
    if data.dtype.is_floating_point:
        return torch.segment_reduce(data, op, lengths=out_deg,
                                    initial=ident)
    out = torch.segment_reduce(data.to(torch.float64), op, lengths=out_deg,
                               initial=float(ident))
    return out.to(data.dtype)


def segment_sum(data: torch.Tensor, out_deg: torch.Tensor) -> torch.Tensor:
    return _segment(data, out_deg, "sum")


def segment_max(data: torch.Tensor, out_deg: torch.Tensor) -> torch.Tensor:
    return _segment(data, out_deg, "max")


def segment_min(data: torch.Tensor, out_deg: torch.Tensor) -> torch.Tensor:
    return _segment(data, out_deg, "min")


def segment_all(pred: torch.Tensor, out_deg: torch.Tensor) -> torch.Tensor:
    """Per-row logical AND of a boolean edge predicate; empty rows
    (isolated nodes) are False."""
    mins = segment_min(pred.to(torch.int32), out_deg)
    return (mins == 1) & (out_deg > 0)


# ---- the sweep engine's uniform-width row layout ---------------------------

def _rows_fold(values, rows, init, combine):
    feat = values.shape[1:]
    xp = torch.cat([values, values.new_full((1,) + feat, init)])
    acc = values.new_full((rows.shape[0],) + feat, init)
    for w in range(rows.shape[1]):
        acc = combine(acc, xp[rows[:, w]])
    return acc


def rows_segment_sum(values, rows):
    return _rows_fold(values, rows, 0, torch.add)


def rows_segment_min(values, rows, identity):
    return _rows_fold(values, rows, identity, torch.minimum)


def rows_segment_max(values, rows, identity):
    return _rows_fold(values, rows, identity, torch.maximum)


def rows_segment_all(pred, rows, out_deg):
    """AND over each row's valid slots; empty rows are False."""
    mins = rows_segment_min(pred.to(torch.int32), rows, 1)
    return (mins == 1) & (out_deg > 0)


# ---- the degree-bucketed out-edge ELL layout -------------------------------

def _ell_reduce(values, pad_value, edge_mats, inv_perm, reducer):
    feat = values.shape[1:]
    xp = torch.cat([values, values.new_full((1,) + feat, pad_value)])
    parts = []
    for m in edge_mats:
        if m.shape[1] == 0:
            parts.append(values.new_full((m.shape[0],) + feat, pad_value))
        else:
            parts.append(reducer(xp[m]))
    cat = torch.cat(parts) if len(parts) > 1 else parts[0]
    return cat[inv_perm]


def ell_segment_sum(values, edge_mats, inv_perm):
    return _ell_reduce(values, 0, edge_mats, inv_perm,
                       lambda v: v.sum(dim=1))


def ell_segment_min(values, edge_mats, inv_perm, identity):
    return _ell_reduce(values, identity, edge_mats, inv_perm,
                       lambda v: v.amin(dim=1))


def ell_segment_max(values, edge_mats, inv_perm, identity):
    return _ell_reduce(values, identity, edge_mats, inv_perm,
                       lambda v: v.amax(dim=1))


def ell_segment_all(pred, edge_mats, inv_perm, out_deg):
    """AND over each node's out-edges; empty rows False."""
    allr = _ell_reduce(pred.to(torch.int32), 1, edge_mats, inv_perm,
                       lambda v: v.amin(dim=1))
    return (allr == 1) & (out_deg > 0)
