"""The counted cost of a stretch of torch work: the port's cost record.

The JAX package reads its cost record off XLA (``cost_analysis()`` of a
lowered program: flops and bytes accessed).  The port has no lowering, so
it counts, with one rule for every device: a :class:`count` block runs its
work under a ``TorchDispatchMode`` that tallies each aten op as it runs,
and each hand kernel's wrapper declares its own work.

* **Plain torch ops.**  An op's bytes are its tensor inputs' bytes plus
  its outputs' bytes (XLA tallies operand plus output bytes).  Views,
  aliases and allocation-only ops (``empty``, ``empty_like``,
  ``record_stream``) count 0 bytes.  An op that overwrites its first
  argument without reading it (``copy_``, ``fill_``, ``zero_``) does not
  count that argument as read; an ``out=`` argument is counted once, as
  an output.  A gather (``index``, ``index_select``, ``gather``,
  ``take``) reads only the elements it picks: its source counts the
  output's bytes.  An in-place scatter (``index_put_``, ``index_add_``,
  ``index_copy_``, ``scatter_*``, ``index_fill_``) touches only the slots
  it writes: its target counts the written bytes once, or twice (read and
  write) where it accumulates.  An op's flops are its arithmetic element
  operations: the largest element count among its tensors (``2mnk`` for a
  matrix product); pure data movement counts 0 flops.
* **Hand kernels.**  The kernels launch through ``ctypes``, which the
  dispatch mode never sees, so each kernel's wrapper is decorated with
  :func:`declares`: inside a count it adds the wrapper's own bytes and
  flops (the same counts ``chip_smoke.py``'s bound takes) and tallies no
  aten op of its body.  A kernel's plain version on the CPU therefore
  counts exactly what its CUDA launch counts on the card.  Outside a
  count the declaration costs one test of a list.

Nothing here changes what runs: a count observes the ops and returns
their outputs unchanged.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

#: the counts in force, innermost last
_STACK: list = []

#: ops that move no data: allocations, stream bookkeeping, aliases
FREE_OPS = frozenset({
    "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "record_stream", "detach", "alias", "lift_fresh",
    "set_", "resize_", "_reshape_alias", "_unsafe_view", "_to_dense_view",
})

#: ops that overwrite their first argument without reading it
WRITE_ONLY_OPS = frozenset({
    "copy_", "fill_", "zero_", "uniform_", "normal_", "random_",
    "bernoulli_", "exponential_", "geometric_", "cauchy_", "log_normal_",
})

#: pure data movement: bytes, no flops
MOVE_OPS = frozenset({
    "copy_", "clone", "_to_copy", "cat", "stack", "index", "index_select",
    "gather", "take", "embedding", "index_put_", "index_put",
    "_index_put_impl_", "index_copy_", "index_copy", "index_fill_",
    "index_fill", "scatter", "scatter_", "roll", "flip", "repeat",
    "fill_", "zero_", "zeros", "ones", "full", "zeros_like", "ones_like",
    "full_like", "new_zeros", "new_ones", "new_full", "arange",
    "masked_select", "nonzero", "where", "constant_pad_nd", "slice_scatter",
    "select_scatter", "narrow_copy", "_local_scalar_dense", "expand_copy",
    "masked_fill", "masked_fill_", "repeat_interleave", "tril", "triu",
})

#: gathers: the source is read only where the output picks it
GATHER_OPS = frozenset({"index", "index_select", "gather", "take",
                        "embedding"})

#: in-place scatters: target bytes touched = the written slots, counted
#: twice (read and write) where the op accumulates
SCATTER_OPS = {"index_put_": False, "_index_put_impl_": False,
               "index_copy_": False, "scatter_": False,
               "index_fill_": False, "index_add_": True,
               "scatter_add_": True, "scatter_reduce_": True,
               "index_reduce_": True}

MATMUL_OPS = frozenset({"mm", "bmm", "matmul", "addmm", "baddbmm", "mv",
                        "addmv", "dot"})


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    leaves, _ = tree_flatten(tree)
    return [x for x in leaves if isinstance(x, torch.Tensor)]


def _matmul_flops(name: str, ins: list, outs: list) -> int:
    if not outs:
        return 0
    out = outs[0]
    a = ins[-2] if name in ("addmm", "baddbmm", "addmv") else ins[0]
    k = a.shape[-1] if a.dim() else 1
    return 2 * out.numel() * k


def op_cost(func, args, kwargs, out) -> tuple:
    """``(bytes, flops)`` of one aten op under this module's rules."""
    name = func.overloadpacket.__name__
    if getattr(func, "is_view", False) or name in FREE_OPS:
        return 0, 0
    kwargs = dict(kwargs or {})
    out_kw = kwargs.pop("out", None)
    outs = _tensors(out)
    if name in SCATTER_OPS and args and isinstance(args[0], torch.Tensor):
        target = args[0]
        rest = _tensors((args[1:], kwargs))
        if name == "index_fill_":
            idx = rest[0] if rest else None
            dim = args[1] if len(args) > 1 and isinstance(args[1], int) \
                else 0
            row = target.numel() // max(target.shape[dim], 1) \
                if target.dim() else 1
            touched = (idx.numel() if idx is not None else 0) * row \
                * target.element_size()
        else:
            src = rest[-1] if rest else None
            touched = (src.numel() * target.element_size()
                       if src is not None else 0)
        acc = SCATTER_OPS[name] or bool(kwargs.get("accumulate")) or (
            name in ("index_put_", "_index_put_impl_") and len(args) > 3
            and bool(args[3]))
        nbytes = sum(_nbytes(t) for t in rest) + touched * (2 if acc else 1)
        flops = (max((t.numel() for t in rest), default=0) if acc else 0)
        return nbytes, flops
    ins = _tensors((args, kwargs))
    if name in WRITE_ONLY_OPS and ins:
        ins = ins[1:]
    if name in GATHER_OPS and ins:
        # the source is read where the output picks it: the output's bytes
        nbytes = sum(_nbytes(t) for t in ins[1:]) \
            + 2 * sum(_nbytes(t) for t in outs)
        return nbytes, 0
    if out_kw is not None:
        skip = {id(t) for t in _tensors(out_kw)}
        ins = [t for t in ins if id(t) not in skip]
    nbytes = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
    if name in MOVE_OPS:
        flops = 0
    elif name in MATMUL_OPS:
        flops = _matmul_flops(name, ins, outs)
    else:
        flops = max((t.numel() for t in ins + outs), default=0)
    return int(nbytes), int(flops)


@dataclasses.dataclass
class CostCount:
    """What one :class:`count` block tallied: bytes and flops of the plain
    ops (``ops`` of them; ``by_op[name] = [calls, bytes, flops]``) and of
    each declaring kernel wrapper (``kernels[name] = {"calls", "bytes",
    "flops"}``)."""

    bytes: int = 0
    flops: int = 0
    ops: int = 0
    kernels: dict = dataclasses.field(default_factory=dict)
    by_op: dict = dataclasses.field(default_factory=dict)
    depth: int = 0

    @property
    def total_bytes(self) -> int:
        return self.bytes + sum(k["bytes"] for k in self.kernels.values())

    @property
    def total_flops(self) -> int:
        return self.flops + sum(k["flops"] for k in self.kernels.values())

    def declare(self, name: str, nbytes: int, flops: int) -> None:
        rec = self.kernels.setdefault(name, {"calls": 0, "bytes": 0,
                                             "flops": 0})
        rec["calls"] += 1
        rec["bytes"] += int(nbytes)
        rec["flops"] += int(flops)

    def to_dict(self) -> dict:
        return {"bytes_accessed": self.total_bytes,
                "flops": self.total_flops,
                "plain_ops": self.ops, "plain_bytes": self.bytes,
                "plain_flops": self.flops,
                "kernels": {k: dict(v) for k, v in
                            sorted(self.kernels.items())}}


class _Tally(TorchDispatchMode):
    def __init__(self, rec: CostCount):
        super().__init__()
        self.rec = rec

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not self.rec.depth:
            nbytes, flops = op_cost(func, args, kwargs, out)
            rec = self.rec
            rec.bytes += nbytes
            rec.flops += flops
            rec.ops += 1
            tally = rec.by_op.setdefault(str(func), [0, 0, 0])
            tally[0] += 1
            tally[1] += nbytes
            tally[2] += flops
        return out


def counting() -> bool:
    """Whether a :class:`count` block is in force."""
    return bool(_STACK)


@contextlib.contextmanager
def count():
    """``with count() as c:`` — tally the enclosed torch work into the
    :class:`CostCount` ``c`` (module docstring)."""
    rec = CostCount()
    _STACK.append(rec)
    try:
        with _Tally(rec):
            yield rec
    finally:
        _STACK.pop()


def declares(name: str, cost):
    """Decorate a hand kernel's wrapper: inside a :class:`count`,
    ``cost(*args, **kwargs) -> (bytes, flops)`` is added under ``name``
    and the wrapper's body (its plain version on the CPU, its launch and
    allocations on the card) tallies nothing.  ``cost`` runs with the
    tally off too, so it may read tensors.  The wrapper carries
    ``declared_cost`` (the name) and ``cost`` (the function, read at each
    call)."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not _STACK or _STACK[-1].depth:
                return fn(*args, **kwargs)
            rec = _STACK[-1]
            rec.depth += 1
            try:
                nbytes, flops = wrapper.cost(*args, **kwargs)
                out = fn(*args, **kwargs)
            finally:
                rec.depth -= 1
            rec.declare(name, nbytes, flops)
            return out

        wrapper.declared_cost = name
        wrapper.cost = cost
        return wrapper
    return deco
