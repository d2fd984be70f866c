"""Telemetry spec + series: the device-resident metric contract.

Counterpart of ``flow_updating_tpu/obs/telemetry.py``.  Every kernel's
telemetry runner (``models/rounds.py``, ``models/sync.py``,
``parallel/sharded.py``, ``parallel/structured_sharded.py``) keeps one
round's sample on the device, written into preallocated ``(R, ...)``
tensors, and the host sees one bulk copy at the end — no ``.item()``,
``float()`` or ``.cpu()`` inside the round loop.  A disabled spec
(``TelemetrySpec.off()``) runs the plain loop, unchanged.

This module holds :class:`TelemetrySpec`, a static selection of metric
names; :class:`SeriesRecorder`, the preallocated device-side rows the
runners write; and :class:`TelemetrySeries`, the host-side numpy series
with its JSON and watch-record conversions.
"""

from __future__ import annotations

import dataclasses

import numpy as np

#: Every metric the subsystem knows, in canonical emission order.
ALL_METRICS = (
    "rmse",            # alive-masked RMSE vs the true mean (pooled features)
    "max_abs_err",     # alive-masked max |estimate - mean|
    "mass",            # alive-masked sum of estimates, per feature
    "mass_residual",   # mass - alive-masked sum of inputs, per feature
    "antisymmetry",    # max |flow[e] + flow[rev[e]]| (edge ledgers)
    "sent",            # messages fired onto the wire this round
    "delivered",       # messages drained from mailboxes this round
    "fired_total",     # cumulative averaging events across all nodes
    "active",          # alive (communicating) node count
)

#: The subset cheap and meaningful on every kernel.
DEFAULT_METRICS = (
    "rmse", "max_abs_err", "mass", "mass_residual", "fired_total", "active",
)

#: What each execution mode can measure.  The node-collapsed kernels keep
#: no per-edge ledgers (no antisymmetry, no message counts); the halo
#: kernel's reverse edges live on other shards, so the antisymmetry pairing
#: would itself be a collective — it stays a single-device/GSPMD metric.
SUPPORTED_METRICS = {
    "edge": ALL_METRICS,
    "halo": tuple(m for m in ALL_METRICS if m != "antisymmetry"),
    "node": DEFAULT_METRICS,
    "pod": DEFAULT_METRICS,
}


def _suggest(name: str, vocabulary) -> str:
    import difflib

    close = difflib.get_close_matches(name, vocabulary, n=1)
    return f" (did you mean {close[0]!r}?)" if close else ""


@dataclasses.dataclass(frozen=True)
class TelemetrySpec:
    """Static metric selection (hashable).

    ``strict=True`` (an explicit user list) makes :meth:`for_kernel` raise
    on metrics the execution mode cannot measure; the ``full()``/``parse``
    presets are non-strict and silently narrow to what is supported.
    """

    metrics: tuple = ()
    strict: bool = True

    @property
    def enabled(self) -> bool:
        return bool(self.metrics)

    def has(self, name: str) -> bool:
        return name in self.metrics

    @classmethod
    def off(cls) -> TelemetrySpec:
        return cls(metrics=())

    @classmethod
    def default(cls) -> TelemetrySpec:
        return cls(metrics=DEFAULT_METRICS, strict=False)

    @classmethod
    def full(cls) -> TelemetrySpec:
        return cls(metrics=ALL_METRICS, strict=False)

    @classmethod
    def parse(cls, text: str | None) -> TelemetrySpec:
        """CLI surface: ``off`` / ``default`` / ``full`` / ``m1,m2,...``."""
        if text is None or text in ("", "off", "none"):
            return cls.off()
        if text in ("default", "on", "true", "1"):
            return cls.default()
        if text in ("full", "all"):
            return cls.full()
        names = tuple(m.strip() for m in text.split(",") if m.strip())
        unknown = [m for m in names if m not in ALL_METRICS]
        if unknown:
            # a typo must fail loudly with the whole vocabulary (and a
            # closest-match hint) — silently recording nothing is the
            # failure mode this guards against
            raise ValueError(
                f"unknown telemetry metric(s) {unknown}"
                f"{_suggest(unknown[0], ALL_METRICS)}; valid: "
                f"{', '.join(ALL_METRICS)} (or 'default'/'full'/'off')")
        # canonical order regardless of user order
        return cls(metrics=tuple(m for m in ALL_METRICS if m in names))

    def for_kernel(self, kind: str) -> TelemetrySpec:
        """Narrow to the metrics ``kind`` supports (or raise, if strict)."""
        try:
            sup = SUPPORTED_METRICS[kind]
        except KeyError:
            raise ValueError(
                f"unknown kernel kind {kind!r}; have "
                f"{sorted(SUPPORTED_METRICS)}") from None
        missing = [m for m in self.metrics if m not in sup]
        if missing and self.strict:
            raise ValueError(
                f"metric(s) {missing} are not measurable on the {kind!r} "
                f"kernel (supported: {', '.join(sup)})")
        return TelemetrySpec(
            metrics=tuple(m for m in self.metrics if m in sup),
            strict=self.strict)


class SeriesRecorder:
    """The device-resident half of a telemetry run: ``rounds`` rows per
    metric, in tensors allocated on the first sample's device (row ``i``
    written by a device copy, never read back in the loop).  Python
    numbers (a node kernel's round counter) are kept on the host."""

    def __init__(self, rounds: int):
        self.rounds = int(rounds)
        self._dev: dict = {}
        self._host: dict = {}

    def put(self, i: int, row: dict) -> None:
        import torch

        for k, v in row.items():
            if isinstance(v, torch.Tensor):
                buf = self._dev.get(k)
                if buf is None:
                    buf = self._dev[k] = torch.empty(
                        (self.rounds,) + tuple(v.shape), dtype=v.dtype,
                        device=v.device)
                buf[i].copy_(v)
            else:
                self._host.setdefault(k, [None] * self.rounds)[i] = v

    def tensors(self) -> list:
        return list(self._dev.values())

    def series(self) -> dict:
        """``{metric: (R, ...)}``: device tensors, host numbers as int64
        CPU tensors."""
        import torch

        out = {k: torch.tensor(v, dtype=torch.int64)
               for k, v in self._host.items()}
        out.update(self._dev)
        return out


class TelemetrySeries:
    """Host-side per-round metric series: ``{name: (R,) or (R, D) array}``
    plus the absolute round counter ``t``.  One instance per telemetry
    run; empty when telemetry was disabled."""

    def __init__(self, data: dict | None = None):
        self._data = {k: np.asarray(v) for k, v in (data or {}).items()}
        if self._data and "t" not in self._data:
            raise ValueError("telemetry series needs the 't' round axis")

    @classmethod
    def empty(cls) -> TelemetrySeries:
        return cls({})

    def __len__(self) -> int:
        return int(self._data["t"].shape[0]) if self._data else 0

    def __bool__(self) -> bool:
        return len(self) > 0

    @property
    def t(self) -> np.ndarray:
        return self._data.get("t", np.zeros((0,), np.int32))

    @property
    def metrics(self) -> tuple:
        return tuple(k for k in self._data if k != "t")

    def __getitem__(self, name: str) -> np.ndarray:
        return self._data[name]

    def __contains__(self, name: str) -> bool:
        return name in self._data

    def row(self, i: int) -> dict:
        out = {}
        for k, v in self._data.items():
            x = v[i]
            out[k] = x.tolist() if np.ndim(x) else x.item()
        return out

    def to_jsonable(self) -> dict:
        """Full series as JSON-ready lists (the run-manifest payload)."""
        return {k: v.tolist() for k, v in self._data.items()}

    def summary(self) -> dict:
        """Final-row digest for the printed report (full series belongs in
        the manifest, not on stdout)."""
        if not self:
            return {"rounds": 0, "metrics": []}
        out = {"rounds": len(self), "metrics": list(self.metrics),
               "final": self.row(len(self) - 1)}
        if "rmse" in self._data:
            out["min_rmse"] = float(np.min(self._data["rmse"]))
        return out

    def watch_records(self, observe_every: int = 1) -> list:
        """The series re-expressed as ``observer_sample`` watch records at
        the watcher grid (the streamed observers' emit shape)."""
        from flow_updating_tpu_torch.utils.metrics import observer_sample

        need = ("rmse", "max_abs_err", "mass", "fired_total")
        missing = [m for m in need if m not in self._data]
        if missing:
            raise ValueError(
                f"watch records need metric(s) {missing}; enable them in "
                "the TelemetrySpec (the 'default' set has all of them)")
        every = max(int(observe_every), 1)
        recs = []
        t = self._data["t"]
        for i in range(len(self)):
            ti = int(t[i])
            if ti % every:
                continue
            recs.append(observer_sample(
                ti,
                self._data["rmse"][i],
                self._data["max_abs_err"][i],
                # observer mass is the pooled total (the watcher's
                # global_values-sum heritage); per-feature stays in the
                # series itself
                float(np.sum(self._data["mass"][i])),
                self._data["fired_total"][i],
            ))
        return recs
