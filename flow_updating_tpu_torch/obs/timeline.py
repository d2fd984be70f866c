"""Measured device timelines: parse ``torch.profiler`` captures.

Counterpart of ``flow_updating_tpu/obs/timeline.py``.
:func:`~flow_updating_tpu_torch.utils.trace.trace` (the ``--trace-dir``
flag of ``run``, ``serve`` and ``profile``) writes one gzipped Chrome
trace (``*.pt.trace.json.gz``) into a directory; this module reads it.
The card's rows are complete (``'X'``) events of category ``kernel``,
``gpu_memcpy`` or ``gpu_memset``, on lanes ``(device, stream)``; the
host's ``user_annotation`` events are the :func:`~flow_updating_tpu_torch.
utils.trace.annotate` spans.

From those slices the overlap ratio of a sharded schedule is *measured*:
the fraction of the wire's time during which compute runs beside it,
rather than inferred from the three-schedule wall-clock arithmetic of
:func:`~flow_updating_tpu_torch.obs.profile.overlap_report` (which stays
as the cross-check).  The port's shards are streams on one card
(``parallel/mesh.py``): the wire is the copies between them (``'overlap'``
copies each incoming block on the receiver's copy stream) and kernel B6's
pull (``'overlap_pallas'``).  A stream runs its own work in order, so a
shard's wire can only hide behind compute on another stream of the same
card: :func:`measured_overlap` counts the wire time covered by compute on
the wire's device.

The profiler keeps only some of the card's events of a long run (on the
H100 machine: as few as 4 of 20 launches of one kernel late in a
process).  :func:`kernel_events` counts the events kept for each hand
kernel, so a caller can hold them against the wrappers' launch counters
and report a trace as incomplete instead of trusting it.

Everything here is host-side JSON parsing — stdlib only.
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import re

#: the card's event categories in a torch.profiler trace
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

#: device slices that ARE the wire: copies between the shards' streams
#: and kernel B6's pull/merge (the receiver reads the senders' blocks)
WIRE_RE = re.compile(r"Memcpy|memcpy|exchange_kernel", re.IGNORECASE)

#: the CUDA function names of each hand kernel's launches, by kernel (the
#: prefix of the names its wrappers declare their work under,
#: ``utils/cost.py``)
KERNEL_NAMES = {
    "K1": ("spmv_ell_",),
    "K2": ("fused_round_kernel",),
    "B3": ("butterfly_pass<", "window_walk_pass<", "wide_pass_swap<",
           "wide_pass_roll<", "wide2_swap_group<", "wide2_roll_chain<",
           "wide2_roll_gather<"),
    "B4": ("scan_chunk_pass<", "fill_walk_pass<", "seg_wide_pass<"),
    "B5": ("sharded_fire_kernel<", "sharded_merge_kernel<"),
    "B6": ("exchange_kernel<",),
}


def latest_trace_file(log_dir: str) -> str | None:
    """The newest ``*.trace.json.gz`` under ``log_dir``."""
    hits = glob.glob(os.path.join(log_dir, "**", "*.trace.json.gz"),
                     recursive=True)
    if not hits:
        return None
    return max(hits, key=os.path.getmtime)


def load_trace_events(path: str) -> tuple:
    """``(trace events, thread names)`` from one Chrome trace file;
    thread names key on ``(pid, tid)``."""
    with gzip.open(path, "rt") as fh:
        doc = json.load(fh)
    events = doc.get("traceEvents") or []
    threads = {}
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "thread_name":
            threads[(e.get("pid"), e.get("tid"))] = \
                (e.get("args") or {}).get("name", "")
    return events, threads


def device_slices(events: list, threads: dict | None = None, *,
                  module: str | None = None) -> list:
    """The card's slices: complete events of category ``kernel``,
    ``gpu_memcpy`` or ``gpu_memset`` with a positive duration, on lanes
    ``(device, stream)`` (``args.device``/``args.stream``, else the
    event's ``pid``/``tid``).  ``module`` keeps the slices whose name
    contains it (the JAX package's filter is on the HLO module; a torch
    trace has none, so the kernel's name stands in).  ``threads`` is
    accepted for the JAX signature and not needed."""
    out = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        name = str(e.get("name", ""))
        if module is not None and module not in name:
            continue
        dur, ts = e.get("dur"), e.get("ts")
        if not isinstance(dur, (int, float)) \
                or not isinstance(ts, (int, float)) or dur <= 0:
            continue
        args = e.get("args") or {}
        out.append({"name": name, "cat": e.get("cat"),
                    "ts_us": float(ts), "dur_us": float(dur),
                    "lane": (args.get("device", e.get("pid")),
                             args.get("stream", e.get("tid")))})
    return out


def annotation_spans(events: list, name: str) -> list:
    """Spans of one ``utils.trace.annotate`` marker (the host's
    ``user_annotation`` row; its mirror on the card's rows is left out,
    so each span counts once)."""
    return [{"ts_us": float(e["ts"]), "dur_us": float(e["dur"])}
            for e in events
            if e.get("ph") == "X" and e.get("name") == name
            and e.get("cat") != "gpu_user_annotation"
            and isinstance(e.get("ts"), (int, float))
            and isinstance(e.get("dur"), (int, float))]


def _union(intervals: list) -> list:
    """Merged ``(start, end)`` union of possibly-overlapping
    intervals."""
    merged: list = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], end))
        else:
            merged.append((start, end))
    return merged


def _overlap_with(interval: tuple, union: list) -> float:
    """Length of ``interval``'s intersection with a sorted disjoint
    union."""
    start, end = interval
    total = 0.0
    for a, b in union:
        if b <= start:
            continue
        if a >= end:
            break
        total += min(end, b) - max(start, a)
    return total


def kernel_events(slices: list) -> dict:
    """Kept device events of each hand kernel (:data:`KERNEL_NAMES`), and
    their summed device time in microseconds: ``{kernel: {"events",
    "device_us"}}`` for the kernels that have any."""
    out: dict = {}
    for s in slices:
        for kernel, marks in KERNEL_NAMES.items():
            if any(m in s["name"] for m in marks):
                rec = out.setdefault(kernel, {"events": 0, "device_us": 0.0})
                rec["events"] += 1
                rec["device_us"] += s["dur_us"]
                break
    return out


def measured_overlap(log_dir: str, *,
                     module: str | None = None) -> dict | None:
    """Measure the wire/compute overlap ratio from a captured device
    timeline: the fraction of total wire-slice time during which a
    compute slice runs on the same device (module docstring: the port's
    shards are streams of one card).  Returns None when ``log_dir``
    holds no capture; returns a record with
    ``overlap_ratio_measured=None`` when the capture has no wire slices
    (a single-device program, or a host-only capture)."""
    path = latest_trace_file(log_dir)
    if path is None:
        return None
    events, threads = load_trace_events(path)
    slices = device_slices(events, threads, module=module)
    wire = [s for s in slices if WIRE_RE.search(s["name"])]
    compute = [s for s in slices if not WIRE_RE.search(s["name"])]
    out = {
        "trace_file": path,
        "device_slices": len(slices),
        "wire_ops": len(wire),
        "compute_ops": len(compute),
        "lanes": len({s["lane"] for s in slices}),
        "module": module,
    }
    compute_by_dev: dict = {}
    for s in compute:
        compute_by_dev.setdefault(s["lane"][0], []).append(
            (s["ts_us"], s["ts_us"] + s["dur_us"]))
    dev_unions = {d: _union(iv) for d, iv in compute_by_dev.items()}
    compute_busy = sum(b - a for u in dev_unions.values() for a, b in u)
    if not wire:
        out.update({
            "wire_busy_s": 0.0,
            "compute_busy_s": round(compute_busy / 1e6, 6),
            "overlapped_s": 0.0,
            "overlap_ratio_measured": None,
            "note": "capture holds no wire slices (single-device "
                    "program?) — nothing to overlap",
        })
        return out
    wire_busy = sum(s["dur_us"] for s in wire)
    overlapped = sum(
        _overlap_with((s["ts_us"], s["ts_us"] + s["dur_us"]),
                      dev_unions.get(s["lane"][0], []))
        for s in wire)
    out.update({
        "wire_busy_s": round(wire_busy / 1e6, 6),
        "compute_busy_s": round(compute_busy / 1e6, 6),
        "overlapped_s": round(overlapped / 1e6, 6),
        "overlap_ratio_measured": round(
            min(overlapped / wire_busy, 1.0), 4) if wire_busy > 0
        else None,
    })
    return out
