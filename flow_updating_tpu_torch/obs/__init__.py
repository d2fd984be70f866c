"""Observability (counterpart of ``flow_updating_tpu/obs/``): the run
side and the topology-resolved side.

* :mod:`.telemetry` — :class:`TelemetrySpec` / :class:`TelemetrySeries`,
  the metric contract every kernel's telemetry runner fills;
* :mod:`.fields` — :class:`FieldSpec` / :class:`FieldSeries`, the
  per-node and per-edge fields every kernel's field runner records;
* :mod:`.inspect` — blame (stragglers, leaking edge pairs, liars,
  pinned claims, cut links, divergence origins), run diffs and ASCII
  heatmaps over field series;
* :mod:`.report` — run, plan and field manifests;
* :mod:`.trace` — event logs and serving manifests as Chrome
  trace-event documents;
* :mod:`.spectral` — the diffusion operator's spectral gap
  (``mixing_report``), persisted in the autotune cache;
* :mod:`.forecast` — ``fit_log_decay``, the log-spread fit;
* :mod:`.profile` — the payload-bytes and fused-round attributions.
"""

from flow_updating_tpu_torch.obs.fields import (
    ALL_FIELDS,
    SUPPORTED_FIELDS,
    FieldSeries,
    FieldSpec,
)
from flow_updating_tpu_torch.obs.inspect import (
    ascii_heatmap,
    blame,
    diff_fields,
)
from flow_updating_tpu_torch.obs.report import (
    build_field_manifest,
    build_manifest,
    write_report,
)
from flow_updating_tpu_torch.obs.telemetry import (
    ALL_METRICS,
    DEFAULT_METRICS,
    SUPPORTED_METRICS,
    TelemetrySeries,
    TelemetrySpec,
)
from flow_updating_tpu_torch.obs.trace import (
    eventlog_to_chrome_trace,
    read_eventlog,
)
from flow_updating_tpu_torch.utils.metrics import observer_sample

__all__ = [
    "ALL_FIELDS",
    "ALL_METRICS",
    "DEFAULT_METRICS",
    "SUPPORTED_FIELDS",
    "SUPPORTED_METRICS",
    "FieldSeries",
    "FieldSpec",
    "TelemetrySeries",
    "TelemetrySpec",
    "ascii_heatmap",
    "blame",
    "build_field_manifest",
    "build_manifest",
    "diff_fields",
    "eventlog_to_chrome_trace",
    "observer_sample",
    "read_eventlog",
    "write_report",
]
