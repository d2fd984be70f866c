"""Log-spread decay fit (counterpart of a subset of
``flow_updating_tpu/obs/forecast.py``).

:func:`fit_log_decay` is the least-squares line through ``ln(spread)``
that the mixing probe's measured provenance (:mod:`.spectral`) rides.
The online per-lane forecaster (``LaneForecaster``) moves with the query
fabric (ROADMAP A11).
"""

from __future__ import annotations

import math

#: calibration band for ``forecast_ratio``: doctor passes when the p90
#: of ``|log ratio|`` is within ``log(FORECAST_BAND)`` — i.e. 90% of
#: banked ratios land in [1/band, band].  Mirrored into the query
#: manifest's ``forecast`` block so offline doctor judges the band the
#: fabric declared, not whatever the checker's default happens to be.
FORECAST_BAND = 2.0

#: slopes above this are "not decaying" — the fit is judged flat and no
#: ETA is extrapolated (a diverging or stalled lane is the watchdog's
#: jurisdiction, not the forecaster's)
_FLAT_SLOPE = -1e-12


def fit_log_decay(ts, ys) -> dict | None:
    """Least-squares fit of ``ln(y) = intercept + slope * t`` over the
    strictly-positive, finite points of ``(ts, ys)``.

    Returns ``{"slope", "intercept", "stderr", "slope_stderr",
    "points"}`` (stderr = residual standard error of ``ln y``), or
    ``None`` with fewer than two usable points or zero time spread.
    Plain host float math — no array backend, importable anywhere.
    """
    pts = [(float(t), math.log(float(y))) for t, y in zip(ts, ys)
           if float(y) > 0.0 and math.isfinite(float(y))]
    if len(pts) < 2:
        return None
    n = len(pts)
    mt = sum(t for t, _ in pts) / n
    my = sum(y for _, y in pts) / n
    sxx = sum((t - mt) ** 2 for t, _ in pts)
    if sxx <= 0.0:
        return None
    sxy = sum((t - mt) * (y - my) for t, y in pts)
    slope = sxy / sxx
    intercept = my - slope * mt
    rss = sum((y - (intercept + slope * t)) ** 2 for t, y in pts)
    stderr = math.sqrt(rss / (n - 2)) if n > 2 else 0.0
    return {
        "slope": slope,
        "intercept": intercept,
        "stderr": stderr,
        "slope_stderr": stderr / math.sqrt(sxx),
        "points": n,
    }
