"""Observability: telemetry series, run and plan manifests, the mixing
probe (counterpart of ``flow_updating_tpu/obs/``, the run side).

* :mod:`.telemetry` — :class:`TelemetrySpec` / :class:`TelemetrySeries`,
  the metric contract every kernel's telemetry runner fills;
* :mod:`.report` — ``flow-updating-run-report/v1`` and
  ``flow-updating-plan-report/v1`` manifests;
* :mod:`.spectral` — the diffusion operator's spectral gap
  (``mixing_report``), persisted in the autotune cache;
* :mod:`.forecast` — ``fit_log_decay``, the log-spread fit;
* :mod:`.profile` — the payload-bytes and fused-round attributions.
"""
