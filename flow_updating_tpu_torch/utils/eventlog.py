"""Structured JSONL event log — the framework's XBT-logging equivalent.

Counterpart of ``flow_updating_tpu/utils/eventlog.py``: one JSON object
per line, each carrying an event ``kind`` and the host's monotonic
``wall_s``, written by the host (watcher samples, engine lifecycle,
``advance`` dispatches).  Tensors are made JSON-able as arrays are: 0-d
and one-element ones collapse to a Python scalar, small ones become
lists, large ones a shape/dtype stub.
"""

from __future__ import annotations

import json
import threading
import time
from typing import IO

#: Arrays up to this many elements are inlined as JSON lists; larger ones
#: are summarized (shape + dtype) — an event line is a log record, not a
#: tensor store.
MAX_INLINE_ARRAY = 64


def _jsonable(v):
    """JSON-safe coercion of one emitted field (numpy arrays and torch
    tensors alike; containers recurse)."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, dict):
        return {k: _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    shape = getattr(v, "shape", None)
    if shape is not None:  # numpy array or torch tensor
        size = 1
        for d in shape:
            size *= int(d)
        if hasattr(v, "detach"):
            v = v.detach().cpu().numpy()
        if size <= 1:
            return v.item() if size == 1 else []
        if size <= MAX_INLINE_ARRAY:
            return _jsonable(v.tolist())
        return {"__array__": True, "shape": [int(d) for d in shape],
                "dtype": str(getattr(v, "dtype", "?"))}
    if hasattr(v, "item"):  # shapeless scalar wrappers
        return v.item()
    return v


class EventLog:
    """Append-only JSONL sink.  Thread-safe."""

    def __init__(self, path_or_file: str | IO):
        if isinstance(path_or_file, str):
            self._fh = open(path_or_file, "a", buffering=1)
            self._owns = True
        else:
            self._fh = path_or_file
            self._owns = False
        self._lock = threading.Lock()
        self._t0 = time.monotonic()

    def emit(self, kind: str, **fields) -> None:
        record = {"kind": kind,
                  "wall_s": round(time.monotonic() - self._t0, 6)}
        for k, v in fields.items():
            record[k] = _jsonable(v)
        with self._lock:
            self._fh.write(json.dumps(record, default=str) + "\n")

    def close(self) -> None:
        if self._owns:
            self._fh.close()

    def __enter__(self) -> EventLog:
        return self

    def __exit__(self, *exc) -> None:
        self.close()
