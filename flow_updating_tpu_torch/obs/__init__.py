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
* :mod:`.health` — ``doctor``'s rule-based verdicts
  (:class:`CheckResult`, :func:`diagnose_manifest`) on series and on
  every kind of manifest, either package's;
* :mod:`.profile` — cost attribution (:func:`profile_program`: bytes
  and flops counted over a round program, the kernels' declared work,
  the card's memory, the timed run, the launches), the overlap report
  and the payload-bytes and fused-round attributions;
* :mod:`.roofline` + :mod:`.timeline` — the perf lens: the H100 model
  (:data:`~.roofline.H100`) and the measured CPU calibration,
  predicted-vs-measured reconciliation (``roofline_frac``; doctor
  clauses ``roofline_sane`` / ``roofline_floor``), and ``torch.profiler``
  traces parsed into device slices, kept events per kernel and a
  *measured* overlap ratio;
* :mod:`.regress` — fresh bench lines and profile manifests gated against
  the history or a reference (the ``regress`` subcommand);
* :mod:`.trace` — event logs and serving manifests as Chrome
  trace-event documents;
* :mod:`.spectral` — the diffusion operator's spectral gap
  (``mixing_report``), persisted in the autotune cache;
* :mod:`.forecast` — ``fit_log_decay``, the log-spread fit, and
  ``LaneForecaster``, the query fabric's per-lane ETA;
* :mod:`.metrics`, :mod:`.spans` — the serving flight recorder.
"""

from flow_updating_tpu_torch.obs.fields import (
    ALL_FIELDS,
    SUPPORTED_FIELDS,
    FieldSeries,
    FieldSpec,
)
from flow_updating_tpu_torch.obs.health import CheckResult, diagnose_manifest
from flow_updating_tpu_torch.obs.inspect import (
    ascii_heatmap,
    blame,
    diff_fields,
)
from flow_updating_tpu_torch.obs.profile import profile_program
from flow_updating_tpu_torch.obs.report import (
    build_field_manifest,
    build_manifest,
    build_profile_manifest,
    write_report,
)
from flow_updating_tpu_torch.obs.roofline import (
    HardwareModel,
    calibrate_cpu,
    resolve_model,
)
from flow_updating_tpu_torch.obs.telemetry import (
    ALL_METRICS,
    DEFAULT_METRICS,
    SUPPORTED_METRICS,
    TelemetrySeries,
    TelemetrySpec,
)
from flow_updating_tpu_torch.obs.timeline import measured_overlap
from flow_updating_tpu_torch.obs.trace import (
    eventlog_to_chrome_trace,
    read_eventlog,
)
from flow_updating_tpu_torch.utils.metrics import observer_sample

__all__ = [
    "ALL_FIELDS",
    "ALL_METRICS",
    "CheckResult",
    "DEFAULT_METRICS",
    "SUPPORTED_FIELDS",
    "SUPPORTED_METRICS",
    "FieldSeries",
    "FieldSpec",
    "HardwareModel",
    "TelemetrySeries",
    "TelemetrySpec",
    "ascii_heatmap",
    "blame",
    "build_field_manifest",
    "build_manifest",
    "build_profile_manifest",
    "calibrate_cpu",
    "diagnose_manifest",
    "diff_fields",
    "eventlog_to_chrome_trace",
    "measured_overlap",
    "observer_sample",
    "profile_program",
    "read_eventlog",
    "resolve_model",
    "write_report",
]
