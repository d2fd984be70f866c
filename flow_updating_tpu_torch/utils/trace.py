"""Profiling helpers (counterpart of ``flow_updating_tpu/utils/trace.py``).

:func:`trace` captures the enclosed work with ``torch.profiler`` — host
ops and, on the card, every CUDA kernel, copy and memset — and writes
one gzipped Chrome trace (``*.pt.trace.json.gz``) into a directory,
viewable in Perfetto or ``chrome://tracing`` and read back by
:mod:`~flow_updating_tpu_torch.obs.timeline`.  :func:`annotate` names a
span inside it.
"""

from __future__ import annotations

import contextlib
import os


@contextlib.contextmanager
def trace(log_dir: str | None):
    """``with trace('/tmp/fu-trace'):`` — profile the enclosed work into
    one gzipped Chrome trace under ``log_dir``.

    ``log_dir=None`` is a no-op, so call sites can thread a CLI flag
    through unconditionally.  CUDA activity is captured when the card is
    there (the capture waits for the card before it closes)."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import (
        ProfilerActivity,
        profile,
        tensorboard_trace_handler,
    )

    os.makedirs(log_dir, exist_ok=True)
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(
                     log_dir, worker_name="fu", use_gzip=True)):
        yield
        if cuda:
            torch.cuda.synchronize()


@contextlib.contextmanager
def annotate(name: str):
    """A named span inside a trace: ``torch.profiler.record_function``
    (a ``user_annotation`` event on the host row, mirrored on the card's
    rows), plus an NVTX range on the card.  Span names use dots
    (``fu.segment``), as the JAX package's do."""
    import torch

    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()
