"""Cost attribution: what a round program *costs*, and how long it runs.

Counterpart of ``flow_updating_tpu/obs/profile.py``.  The JAX package
reads its cost record off XLA (``cost_analysis()`` / ``memory_analysis()``
of the lowered program).  The port has no lowering, so it *counts*
(``utils/cost.py``): :func:`profile_program` runs the program once from a
copy of its state under the cost count — every plain aten op's bytes and
flops, every hand kernel's declared work — and, with ``execute``, once
more from a second copy with nothing attached, timed with CUDA events on
the card.  The count describes the work, not its implementation: a
kernel's plain version on the CPU counts what its launch counts on the
card.  Profiling is a pure observer: the program it measures is the one
the plain path calls, from copies, so the caller's state is untouched.

Entry points:

* :func:`profile_program` — count + (optionally) time one round program,
  returning the normalized attribution record in the JAX package's keys
  (``cost``, ``memory``, ``timings``, ``compile_cache``,
  ``device_memory_stats``) plus the wrappers' ``launches`` and, with
  ``trace_dir``, the device events the ``torch.profiler`` trace kept;
* :meth:`Engine.profile <flow_updating_tpu_torch.engine.Engine.profile>`
  — the record for the engine's kernel (edge / node / halo / pod);
* the ``profile`` CLI subcommand — the same record written as a
  ``flow-updating-profile-report/v1`` manifest;
* batched sweeps (``sweep --profile``) attach one record per bucket.

What the timings stand for in the port: ``lower_s`` is the caller's
build of the program's inputs (an engine's plan, tables and networks,
``Engine.build``'s wall time), ``compile_s`` the kernels' build and load
(``nvcc`` and ``ctypes``; 0 on the CPU, which runs the plain versions),
``count_s`` the counted run (slowed by the count's Python per op) and
``execute_s`` the timed run.

Repeated profiles of the same program (same callable, same argument
shapes) are served from an in-process cache of the count: a hit re-times
the execution and reuses the count, as the JAX package reuses a compiled
executable; the hit/miss counters are part of every record.
"""

from __future__ import annotations

import copy
import dataclasses
import enum
import time
import types
import weakref

import numpy as np
import torch

#: process-wide count-cache counters (every record carries a snapshot;
#: reset_cache() zeroes them — test isolation)
CACHE_STATS = {"hits": 0, "misses": 0}

_COUNTED: dict = {}

#: the torch.cuda.memory_stats keys a record keeps, under the TPU
#: runtime's names where it has one
_MEM_STATS = {"allocated_bytes.all.current": "bytes_in_use",
              "allocated_bytes.all.peak": "peak_bytes_in_use",
              "reserved_bytes.all.current": "bytes_reserved",
              "reserved_bytes.all.peak": "peak_bytes_reserved",
              "num_alloc_retries": "num_alloc_retries",
              "num_ooms": "num_ooms"}


def reset_cache() -> None:
    """Drop cached counts and zero the hit/miss counters."""
    _COUNTED.clear()
    CACHE_STATS["hits"] = CACHE_STATS["misses"] = 0


def _num(x):
    if isinstance(x, (np.floating, np.integer)):
        return x.item()
    return x


def normalize_cost_analysis(d: dict, rounds: int | None = None) -> dict:
    """A count (``CostCount.to_dict()``, ``utils/cost.py``) -> ``{flops,
    bytes_accessed, raw, kernels, method, counted_rounds}``; ``raw`` holds
    the plain ops' share."""
    return {
        "flops": d.get("flops"),
        "bytes_accessed": d.get("bytes_accessed"),
        "raw": {k: d[k] for k in ("plain_ops", "plain_bytes", "plain_flops")
                if k in d},
        "kernels": d.get("kernels", {}),
        "method": "counted",
        "counted_rounds": rounds,
    }


def normalize_memory_analysis(mem: dict | None) -> dict:
    """The card's allocator readings around one run -> the JAX package's
    memory keys.  ``mem`` holds ``argument_bytes`` (the program's state
    copy), ``output_bytes``, ``base_bytes`` (allocated before the run)
    and ``peak_allocated`` (``torch.cuda.max_memory_allocated`` after
    ``reset_peak_memory_stats``); ``temp_bytes`` is what the run
    allocated beyond what was resident and ``peak_bytes`` the state copy
    plus it.  None (the CPU keeps no such stats) -> ``available: False``."""
    if mem is None:
        return {"available": False,
                "note": "the CPU allocator keeps no peak statistics"}
    temp = max(int(mem["peak_allocated"]) - int(mem["base_bytes"]), 0)
    return {"available": True,
            "argument_bytes": int(mem["argument_bytes"]),
            "output_bytes": int(mem["output_bytes"]),
            "temp_bytes": temp,
            "alias_bytes": 0,
            "peak_bytes": int(mem["argument_bytes"]) + temp,
            "peak_source": "argument_bytes + max_memory_allocated over "
                           "the resident bytes"}


def device_memory_stats(device=None) -> dict | None:
    """The card allocator's view (``torch.cuda.memory_stats``): live and
    peak bytes in use, reserved bytes, retries; None on the CPU."""
    dev = torch.device(device) if device is not None else None
    if dev is None or dev.type != "cuda":
        return None
    try:
        stats = torch.cuda.memory_stats(dev)
    except Exception:
        return None
    return {key: _num(stats[k]) for k, key in _MEM_STATS.items()
            if k in stats}


def _tensors(x) -> list:
    """Every tensor inside ``x`` (dataclasses, tuples, lists, dicts)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return [t for f in dataclasses.fields(x)
                for t in _tensors(getattr(x, f.name))]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    return []


def _clone(x):
    """A copy of ``x`` whose every tensor is a fresh clone — a round
    program runs from it and leaves the caller's state as it was."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        new = copy.copy(x)
        for f in dataclasses.fields(x):
            object.__setattr__(new, f.name, _clone(getattr(x, f.name)))
        return new
    if isinstance(x, tuple):
        vals = [_clone(v) for v in x]
        return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
    if isinstance(x, list):
        return [_clone(v) for v in x]
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    return x


def _signature(x) -> tuple:
    """Shapes, dtypes and devices of ``x``'s tensors, and its scalars."""
    if isinstance(x, torch.Tensor):
        return ("arr", tuple(x.shape), str(x.dtype), str(x.device))
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,) + tuple(
            _signature(getattr(x, f.name)) for f in dataclasses.fields(x))
    if isinstance(x, (tuple, list)):
        return tuple(_signature(v) for v in x)
    if isinstance(x, dict):
        return tuple((k, _signature(v)) for k, v in sorted(x.items()))
    try:
        return ("st", hash(x))
    except TypeError:
        return ("st", id(x))


_VALUES = (type(None), bool, int, float, complex, str, bytes, enum.Enum,
           np.generic, torch.dtype, torch.device)


def _static_key(x, refs: list):
    """Key of a static argument: plain values by value, containers by
    their items, every other object (tensors, tables, callables) by its
    identity, with a weak reference to it appended to ``refs``."""
    if isinstance(x, _VALUES):
        return ("v", x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,) + tuple(
            _static_key(getattr(x, f.name), refs)
            for f in dataclasses.fields(x))
    if isinstance(x, (tuple, list)):
        return (type(x).__name__,) + tuple(_static_key(v, refs) for v in x)
    if isinstance(x, dict):
        return ("dict",) + tuple((k, _static_key(v, refs))
                                 for k, v in sorted(x.items()))
    if isinstance(x, types.MethodType):
        refs.append(weakref.WeakMethod(x))
        return ("id", id(x.__self__), x.__func__)
    try:
        refs.append(weakref.ref(x))
    except TypeError:  # no weak reference: the entry holds it instead
        refs.append(lambda x=x: x)
    return ("id", id(x))


def _fingerprint(fn, args, n_dynamic: int):
    """``(key, refs)``: the count-cache key — the callable, the dynamic
    arguments' shapes and the static arguments (:func:`_static_key`) —
    and the weak references that keep it honest.  An entry is valid
    while every reference is alive: a live object's id is its own, so
    two calls with the same valid key run the same program on the same
    tables, and a freed table's id reused by another misses."""
    refs: list = []
    key = (_static_key(fn, refs), _signature(tuple(args[:n_dynamic])),
           _static_key(tuple(args[n_dynamic:]), refs))
    return key, refs


def _purge_dead() -> None:
    """Drop the cache entries whose static arguments were freed."""
    for key in [k for k, (refs, _) in _COUNTED.items()
                if any(r() is None for r in refs)]:
        del _COUNTED[key]


def _device_of(args):
    """The device of the arguments' first tensor (the card when there is
    none, as every entry point defaults to it)."""
    from flow_updating_tpu_torch.utils.device import resolve_device

    ts = _tensors(args)
    return ts[0].device if ts else resolve_device(None)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def launch_counters() -> dict:
    """Every hand kernel's wrapper by the name it declares its work under
    (``utils/cost.py``); each counts its launches in ``.launches``."""
    from flow_updating_tpu_torch.ops import fused_passes as fp
    from flow_updating_tpu_torch.ops import halo_exchange as hx
    from flow_updating_tpu_torch.ops import sharded_round as sr
    from flow_updating_tpu_torch.ops.fused_round import fused_banded_round
    from flow_updating_tpu_torch.ops.spmv import neighbor_sum_ell

    return {"K1": neighbor_sum_ell, "K2": fused_banded_round,
            "B3.local": fp.local_pass, "B3.window": fp.window_pass,
            "B3.wide": fp.wide_pass, "B3.wide2": fp.wide2_pass,
            "B4.scan": fp.segscan_pass, "B4.fill": fp.fill_pass,
            "B5.fire": sr.sharded_fire, "B5.merge": sr.sharded_round,
            "B6.pull": hx.remote_block_exchange,
            "B6.fused": hx.fused_exchange_merge}


def launch_counts() -> dict:
    """A snapshot of every wrapper's ``.launches``."""
    return {k: int(f.launches) for k, f in launch_counters().items()}


def _launch_delta(before: dict) -> dict:
    after = launch_counts()
    return {k: after[k] - before.get(k, 0) for k in after
            if after[k] != before.get(k, 0)}


def family(name: str) -> str:
    """``'B3.local'`` -> ``'B3'``: the kernel a wrapper launches."""
    return name.split(".")[0]


def _timed_run(fn, args, nd: int, dev, *, memory: bool = False):
    """One run from a copy of the dynamic arguments: ``(seconds, memory
    readings or None)``; CUDA events on the card."""
    dyn = _clone(tuple(args[:nd]))
    _sync(dev)
    if dev.type != "cuda":
        t0 = time.perf_counter()
        out = fn(*dyn, *args[nd:])
        seconds = time.perf_counter() - t0
        del out
        return seconds, None
    mem = None
    if memory:
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn(*dyn, *args[nd:])
    end.record()
    torch.cuda.synchronize(dev)
    if memory:
        mem = {"argument_bytes": sum(t.numel() * t.element_size()
                                     for t in _tensors(dyn)),
               "output_bytes": sum(t.numel() * t.element_size()
                                   for t in _tensors(out)),
               "base_bytes": base,
               "peak_allocated": torch.cuda.max_memory_allocated(dev)}
    del out
    return start.elapsed_time(end) / 1e3, mem


def trace_record(log_dir: str, launches: dict) -> dict:
    """What a capture under ``log_dir`` kept of one run whose wrappers
    launched ``launches`` (by declared name): per kernel the launches,
    the device events kept and — only when every launch of every kernel
    is there — their device time.  ``trace_complete`` is False when the
    trace dropped an event (its times are then not reported), None when
    nothing was launched (a host run has no kernel to hold it against)."""
    from flow_updating_tpu_torch.obs import timeline

    path = timeline.latest_trace_file(log_dir)
    if path is None:
        return {"trace_file": None, "trace_complete": None,
                "error": f"the profiler wrote no capture under {log_dir}"}
    events, threads = timeline.load_trace_events(path)
    slices = timeline.device_slices(events, threads)
    kept = timeline.kernel_events(slices)
    fams: dict = {}
    for name, n in launches.items():
        fams[family(name)] = fams.get(family(name), 0) + n
    kernels = {}
    complete = True
    for fam, n in sorted(fams.items()):
        got = kept.get(fam, {}).get("events", 0)
        kernels[fam] = {"launches": n, "events": got}
        complete = complete and got == n
    out = {"trace_file": path, "device_slices": len(slices),
           "kernels": kernels,
           "trace_complete": complete if fams else None}
    if not fams:
        out["note"] = ("no hand kernel was launched (a host run): nothing "
                       "to hold the trace against")
    elif complete:
        for fam in kernels:
            kernels[fam]["device_ms"] = kept[fam]["device_us"] / 1e3
        out["device_ms"] = sum(s["dur_us"] for s in slices) / 1e3
    return out


def profile_program(fn, args=(), *, n_dynamic=None, execute=True,
                    label=None, device=None, rounds: int | None = None,
                    lower_s: float | None = None,
                    trace_dir: str | None = None) -> dict:
    """Count and (optionally) time ``fn(*args)``, returning the cost
    attribution record.

    ``args`` is the full argument tuple, ``n_dynamic`` how many leading
    arguments are the state (copied before every run; default: all).
    ``execute=False`` skips the timed run — in the port the counted run
    still runs the program, since counting is how the cost is known.
    ``rounds`` is stored as ``cost.counted_rounds``; ``lower_s`` is the
    caller's build time (module docstring).  ``trace_dir`` captures one
    more run with ``torch.profiler`` there and records what the trace
    kept (:func:`trace_record`)."""
    from flow_updating_tpu_torch.utils import cost

    nd = len(args) if n_dynamic is None else int(n_dynamic)
    dev = torch.device(device) if device is not None \
        else _device_of(args[:nd])
    _purge_dead()
    key, refs = _fingerprint(fn, args, nd)
    hit = key in _COUNTED
    if hit:
        CACHE_STATS["hits"] += 1
        compile_s, count_s, counted, launches, mem = _COUNTED[key][1]
    else:
        CACHE_STATS["misses"] += 1
        t0 = time.perf_counter()
        if dev.type == "cuda":
            from flow_updating_tpu_torch import kernels

            kernels.load_all()
        compile_s = time.perf_counter() - t0
        dyn = _clone(tuple(args[:nd]))
        _sync(dev)
        before = launch_counts()
        t0 = time.perf_counter()
        with cost.count() as c:
            out = fn(*dyn, *args[nd:])
        _sync(dev)
        count_s = time.perf_counter() - t0
        del out, dyn
        launches = _launch_delta(before)
        counted = c.to_dict()
        mem = None
        if dev.type == "cuda" and not execute:
            _, mem = _timed_run(fn, args, nd, dev, memory=True)
        _COUNTED[key] = (refs, (compile_s, count_s, counted, launches,
                                mem))

    execute_s = None
    if execute:
        execute_s, run_mem = _timed_run(fn, args, nd, dev,
                                        memory=dev.type == "cuda")
        if run_mem is not None:
            mem = run_mem

    rec = {
        "label": label,
        "cost": normalize_cost_analysis(counted, rounds),
        "memory": normalize_memory_analysis(mem),
        "timings": {
            "lower_s": (round(lower_s, 6) if lower_s is not None
                        else None),
            "compile_s": round(compile_s, 6),
            "count_s": round(count_s, 6),
            "execute_s": (round(execute_s, 6)
                          if execute_s is not None else None),
        },
        "compile_cache": {
            "cache_hit": hit,
            "hits": CACHE_STATS["hits"],
            "misses": CACHE_STATS["misses"],
            "jit_cache_size": None,
        },
        "device_memory_stats": device_memory_stats(dev),
        "launches": dict(launches),
    }
    if trace_dir:
        from flow_updating_tpu_torch.utils.trace import annotate, trace

        dyn = _clone(tuple(args[:nd]))
        _sync(dev)
        before = launch_counts()
        with trace(trace_dir):
            with annotate("fu.profile_capture"):
                out = fn(*dyn, *args[nd:])
            _sync(dev)
        del out, dyn
        rec["trace"] = trace_record(trace_dir, _launch_delta(before))
    return rec


def _best_time(fn, args, nd: int, dev, repeats: int) -> float:
    """The least of ``repeats`` timed runs after one warm-up run."""
    _timed_run(fn, args, nd, dev)
    return min(_timed_run(fn, args, nd, dev)[0]
               for _ in range(max(int(repeats), 1)))


def overlap_report(state, plan, cfg, mesh, rounds: int, *, arrays=None,
                   repeats: int = 3, execute: bool = True,
                   mode: str = "overlap",
                   trace_dir: str | None = None) -> dict:
    """Overlap ratio of the halo kernel's split schedule: the fraction
    of the cut-edge exchange time hidden behind interior compute.

    Times three schedules of the SAME rounds — ``'ppermute'`` (the
    serialized oracle), ``mode`` (``'overlap'`` or ``'overlap_pallas'``)
    and ``'interior'`` (the schedule with the exchange elided, a
    timing-only probe) — each the best of ``repeats`` runs after a
    warm-up, and reports::

        exchange_s = t_ppermute - t_interior   (the serialized wire)
        hidden_s   = t_ppermute - t_overlap    (what the split saved)
        overlap_ratio = hidden_s / exchange_s  (clamped to [0, 1])

    With ``trace_dir`` the overlap schedule also runs once under
    ``torch.profiler`` and the ratio is measured from the device slices
    (:func:`_measure_overlap_trace`); a trace that dropped events says
    so (``trace_complete``) and its ratio is not taken."""
    from flow_updating_tpu_torch.parallel import overlap as _ovl
    from flow_updating_tpu_torch.parallel import sharded

    if mode not in ("overlap", "overlap_pallas"):
        raise ValueError(f"overlap_report measures an overlap schedule; "
                         f"got mode={mode!r}")
    times: dict = {}
    for m in ("ppermute", mode, "interior"):
        fn, args, nd = sharded.round_program(
            state, plan, cfg, mesh, rounds, arrays=arrays, halo=m,
            _internal=(m == "interior"))
        times[m] = (_best_time(fn, args, nd, _device_of(args[:nd]), repeats)
                    if execute else None)
    out = {"rounds": int(rounds), "mode": mode,
           "schedule": _ovl.resolve_mode(plan, mode),
           "execute_s": {k: (round(v, 6) if v is not None else None)
                         for k, v in times.items()},
           "note": (f"overlap_ratio = (t_ppermute - t_{mode}) / "
                    "(t_ppermute - t_interior); 'interior' is a "
                    "timing-only probe with the exchange elided")}
    if any(v is None for v in times.values()):
        out.update({"exchange_s": None, "hidden_s": None,
                    "overlap_ratio": None})
        return out
    exchange, hidden, ratio = overlap_ratio_from_times(
        times["ppermute"], times[mode], times["interior"])
    out.update({"exchange_s": round(exchange, 6),
                "hidden_s": round(hidden, 6),
                "overlap_ratio": (round(ratio, 3)
                                  if ratio is not None else None)})
    if trace_dir and execute:
        out["measured"] = _measure_overlap_trace(
            state, plan, cfg, mesh, rounds, arrays=arrays, mode=mode,
            trace_dir=trace_dir)
        measured_ratio = (out["measured"] or {}).get(
            "overlap_ratio_measured")
        if measured_ratio is not None:
            # the device timeline carries the measured figure — the
            # three-schedule wall-clock arithmetic above stays as the
            # cross-check
            out["overlap_ratio_measured"] = measured_ratio
            out["overlap_ratio_source"] = "device-trace"
    return out


def _measure_overlap_trace(state, plan, cfg, mesh, rounds: int, *,
                           arrays, mode: str, trace_dir: str) -> dict:
    """Run the overlap schedule once under ``torch.profiler`` (after a
    warm-up) and measure the wire/compute overlap from the captured
    device slices (obs/timeline.py).  The wrappers' launches are held
    against the events the trace kept: a trace that dropped some reports
    ``trace_complete: False`` and no ratio.  Contained: a capture or
    parse failure reports itself in the record, never breaks the
    report; a kernel that fails to build or launch raises."""
    from flow_updating_tpu_torch.kernels import KernelError
    from flow_updating_tpu_torch.obs import timeline as _tl
    from flow_updating_tpu_torch.parallel import sharded
    from flow_updating_tpu_torch.utils.trace import annotate, trace

    try:
        fn, args, nd = sharded.round_program(
            state, plan, cfg, mesh, rounds, arrays=arrays, halo=mode)
        dev = _device_of(args[:nd])
        _timed_run(fn, args, nd, dev)           # warm outside the capture
        dyn = _clone(tuple(args[:nd]))
        _sync(dev)
        before = launch_counts()
        with trace(trace_dir):
            with annotate("fu.overlap_capture"):
                out = fn(*dyn, *args[nd:])
            _sync(dev)
        del out, dyn
        measured = _tl.measured_overlap(trace_dir)
        if measured is None:
            return {"overlap_ratio_measured": None,
                    "error": f"profiler wrote no capture under "
                             f"{trace_dir}"}
        kept = trace_record(trace_dir, _launch_delta(before))
        measured["trace_complete"] = kept["trace_complete"]
        measured["kernels"] = kept.get("kernels", {})
        if kept["trace_complete"] is False:
            measured["overlap_ratio_measured"] = None
            measured["note"] = ("the trace dropped device events of the "
                                "run; its overlap is not reported")
        return measured
    except KernelError:  # a kernel fault is no capture failure
        raise
    except Exception as exc:
        return {"overlap_ratio_measured": None,
                "error": f"{type(exc).__name__}: {exc}"[:300]}


def overlap_ratio_from_times(t_serial: float, t_overlap: float,
                             t_interior: float):
    """``(exchange_s, hidden_s, overlap_ratio)`` from the three schedule
    timings — the definition of the hidden fraction.  ``overlap_ratio``
    is None when the serialized wire cost is inside timing noise."""
    import math

    exchange = max(t_serial - t_interior, 0.0)
    hidden = max(t_serial - t_overlap, 0.0)
    ratio = (max(0.0, min(hidden / exchange, 1.0))
             if exchange > 1e-9 and math.isfinite(exchange) else None)
    return exchange, hidden, ratio


def per_round(record: dict, rounds: int) -> dict:
    """Amortize a whole-run attribution over its round count."""
    r = max(int(rounds), 1)
    cost = record.get("cost", {})
    out = {}
    for key in ("flops", "bytes_accessed"):
        v = cost.get(key)
        out[key] = (v / r) if isinstance(v, (int, float)) else None
    return out


# ---- payload-bytes attribution (DFL model scale, arXiv:2506.10607) ------


def payload_bytes_per_round(num_edges: int, features: int, *,
                            chunk: int | None = None,
                            feature_shards: int = 1,
                            dtype_bytes: int = 4) -> dict:
    """Edge-payload wire bytes of one underlying gossip round: ``E *
    width`` payload words, ``width = D`` monolithic or ``c`` chunked (a
    full model stream then costs ``D/c`` rounds and the same total
    bytes); feature sharding divides the per-device share by ``S_f``."""
    if features <= 0:
        raise ValueError("features must be >= 1 for payload accounting")
    width = int(chunk) if chunk else int(features)
    if chunk and (chunk <= 0 or features % chunk):
        raise ValueError(
            f"chunk={chunk} must be a positive divisor of D={features}")
    if feature_shards < 1:
        raise ValueError("feature_shards must be >= 1")
    per_round = num_edges * width * dtype_bytes
    return {
        "features": int(features),
        "chunk": int(chunk) if chunk else None,
        "width": width,
        "dtype_bytes": int(dtype_bytes),
        "bytes_per_round": per_round,
        "bytes_per_round_per_device": per_round // feature_shards,
        "rounds_per_model_stream": (int(features) // width),
        "bytes_per_model_stream": num_edges * features * dtype_bytes,
    }


def fused_round_report(kernel) -> dict | None:
    """Bytes-per-round attribution of a ``spmv='banded_fused'``
    :class:`~flow_updating_tpu_torch.models.sync.NodeKernel`
    (:func:`~flow_updating_tpu_torch.ops.fused_round.fused_round_bytes`);
    None for kernels without a fused spec."""
    spec = getattr(getattr(kernel, "arrays", None), "fused", None)
    if spec is None:
        return None
    import numpy as np

    from flow_updating_tpu_torch.ops.fused_round import fused_round_bytes

    feats = int(np.prod(kernel.feature_shape)) \
        if getattr(kernel, "feature_shape", ()) else 1
    return fused_round_bytes(spec, dtype_bytes=kernel.dtype.itemsize,
                             features=feats)


def dfl_efficiency(rate: float, bytes_per_round: float,
                   anchor_rate: float, anchor_bytes_per_round: float
                   ) -> float | None:
    """The DFL bytes-efficiency ratio: rounds/s per wire byte, relative
    to an anchor row (the D=64 monolithic record).  1.0 means a round
    that moves the same bytes as the anchor's costs the same wall-clock."""
    if not rate or not anchor_rate or not bytes_per_round \
            or not anchor_bytes_per_round:
        return None
    return (rate / bytes_per_round) / (anchor_rate / anchor_bytes_per_round)
