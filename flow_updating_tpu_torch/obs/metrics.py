"""Streaming serving metrics: bounded counters, gauges and histograms.

Counterpart of ``flow_updating_tpu/obs/metrics.py``, host Python only and
the same output for the same calls (the Prometheus text byte for byte).
The serving stack runs indefinitely, so every structure is O(1) per
observation and bounded in memory: a monotone counter is one float, a
gauge one float, a histogram a fixed-window ring of the most recent
observations (quantiles computed over the window on demand), and the
per-boundary sample rows a bounded deque.  Everything is host-side
Python over values the service's boundary path already computes: no
device work and no new dispatch signature.

The registry is the black-box half of the flight recorder: its state
rides service checkpoints (:meth:`MetricsRegistry.state_dict` under the
archive's ``obs`` meta key) and WAL replay re-fires the increments, so
the counters stay consistent with the manifest after a SIGKILL and
``recover()`` (``doctor``'s ``metrics_consistency`` check).

Export surfaces: :meth:`MetricsRegistry.to_prometheus` (the Prometheus
text exposition; ``serve --metrics PATH``) and :meth:`MetricsRegistry.block`
(the JSON block of the ``flow-updating-serving-trace/v1`` schema that
service manifests embed).
"""

from __future__ import annotations

import math
from collections import deque

#: Ring-buffer window for histogram observations and boundary sample
#: rows: quantiles reflect the most recent ``window`` observations (a
#: streaming service cares about current latency, not the all-time
#: distribution); count/sum/max stay exact monotone accumulators.
DEFAULT_WINDOW = 4096

#: Quantiles exported by summaries — the SLO vocabulary (p95 is the
#: latency target doctor's ``slo_latency`` judges; docs/OBSERVABILITY.md).
QUANTILES = (0.5, 0.95, 0.99)


def _quantile(window, q: float) -> float:
    """Nearest-rank quantile over a histogram's ring-buffer window."""
    vals = sorted(window)
    if not vals:
        return float("nan")
    idx = min(len(vals) - 1, max(0, math.ceil(q * len(vals)) - 1))
    return float(vals[idx])


def _prom_name(name: str) -> str:
    """Prometheus metric-name sanitation ([a-zA-Z_:][a-zA-Z0-9_:]*)."""
    out = "".join(c if c.isalnum() or c in "_:" else "_" for c in name)
    return out if out and not out[0].isdigit() else "_" + out


class MetricsRegistry:
    """Bounded streaming counters, gauges, and windowed histograms.

    One registry per service engine; observations are plain host floats.
    ``state_dict()``/``load_state()`` round-trip the full streaming
    state through checkpoint meta so a recovered engine's metrics plane
    is continuous with the pre-crash one.
    """

    def __init__(self, window: int = DEFAULT_WINDOW):
        self.window = int(window)
        self._counters: dict[str, float] = {}
        self._gauges: dict[str, float] = {}
        # name -> {"count", "sum", "max", "buf": deque(maxlen=window)}
        self._hists: dict[str, dict] = {}
        #: per-boundary gauge snapshots for counter-track rendering
        #: (obs export-trace); bounded like everything else
        self._samples: deque = deque(maxlen=self.window)

    # ---- write path ------------------------------------------------------

    def inc(self, name: str, value: float = 1.0) -> None:
        """Add ``value`` to a monotone counter (created at 0)."""
        self._counters[name] = self._counters.get(name, 0.0) + float(value)

    def set_counter(self, name: str, value: float) -> None:
        """Mirror an externally-accumulated monotone count (never
        lowered — a stale mirror must not rewind the counter)."""
        self._counters[name] = max(self._counters.get(name, 0.0),
                                   float(value))

    def set_gauge(self, name: str, value: float) -> None:
        self._gauges[name] = float(value)

    def observe(self, name: str, value: float) -> None:
        """Record one histogram observation (windowed quantiles)."""
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = {
                "count": 0, "sum": 0.0, "max": float("-inf"),
                "buf": deque(maxlen=self.window),
            }
        v = float(value)
        h["count"] += 1
        h["sum"] += v
        h["max"] = max(h["max"], v)
        h["buf"].append(v)

    def sample_row(self, t, **gauges) -> None:
        """One boundary snapshot: set each gauge and append a row to the
        bounded sample ring (the time axis of the counter tracks)."""
        for name, value in gauges.items():
            self.set_gauge(name, value)
        self._samples.append({"t": t, **{k: float(v)
                                         for k, v in gauges.items()}})

    # ---- read path -------------------------------------------------------

    def counter(self, name: str) -> float:
        return self._counters.get(name, 0.0)

    def gauge(self, name: str) -> float | None:
        return self._gauges.get(name)

    def histogram(self, name: str) -> dict | None:
        """Summary of one histogram: exact count/sum/max + windowed
        quantiles; None when nothing was observed."""
        h = self._hists.get(name)
        if h is None:
            return None
        out = {
            "count": int(h["count"]),
            "sum": float(h["sum"]),
            "max": float(h["max"]),
            "window_n": len(h["buf"]),
        }
        for q in QUANTILES:
            out[f"p{int(q * 100)}"] = _quantile(h["buf"], q)
        return out

    def block(self) -> dict:
        """The manifest-embeddable JSON block (serving-trace schema)."""
        return {
            "window": self.window,
            "counters": {k: self._counters[k]
                         for k in sorted(self._counters)},
            "gauges": {k: self._gauges[k] for k in sorted(self._gauges)},
            "histograms": {k: self.histogram(k)
                           for k in sorted(self._hists)},
            "samples": list(self._samples),
        }

    def to_prometheus(self, prefix: str = "fu") -> str:
        """Prometheus text exposition (v0.0.4): counters and gauges as
        single samples, histograms as summaries with quantile labels."""
        lines = []
        for name in sorted(self._counters):
            m = _prom_name(f"{prefix}_{name}")
            lines += [f"# TYPE {m} counter",
                      f"{m} {self._counters[name]:g}"]
        for name in sorted(self._gauges):
            m = _prom_name(f"{prefix}_{name}")
            lines += [f"# TYPE {m} gauge",
                      f"{m} {self._gauges[name]:g}"]
        for name in sorted(self._hists):
            m = _prom_name(f"{prefix}_{name}")
            h = self.histogram(name)
            lines.append(f"# TYPE {m} summary")
            for q in QUANTILES:
                v = h[f"p{int(q * 100)}"]
                if math.isfinite(v):
                    lines.append(f'{m}{{quantile="{q:g}"}} {v:g}')
            lines += [f"{m}_sum {h['sum']:g}",
                      f"{m}_count {h['count']}"]
        return "\n".join(lines) + ("\n" if lines else "")

    # ---- checkpoint ride -------------------------------------------------

    def state_dict(self) -> dict:
        return {
            "window": self.window,
            "counters": dict(self._counters),
            "gauges": dict(self._gauges),
            "histograms": {k: {"count": h["count"], "sum": h["sum"],
                               "max": h["max"], "buf": list(h["buf"])}
                           for k, h in self._hists.items()},
            "samples": list(self._samples),
        }

    @classmethod
    def load_state(cls, state: dict) -> MetricsRegistry:
        reg = cls(window=int(state.get("window", DEFAULT_WINDOW)))
        reg._counters = {k: float(v)
                         for k, v in (state.get("counters") or {}).items()}
        reg._gauges = {k: float(v)
                       for k, v in (state.get("gauges") or {}).items()}
        for name, h in (state.get("histograms") or {}).items():
            reg._hists[name] = {
                "count": int(h["count"]), "sum": float(h["sum"]),
                "max": float(h["max"]),
                "buf": deque(h.get("buf") or [], maxlen=reg.window),
            }
        reg._samples.extend(state.get("samples") or [])
        return reg
