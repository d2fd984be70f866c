"""The roofline floor table (counterpart of the floor part of
``flow_updating_tpu/obs/roofline.py``).

``doctor``'s ``roofline_floor`` clause (:func:`.health.check_perf_lens`)
judges a perf-lens block's ``roofline_frac`` per program against a
per-mode floor; a frac below its floor fails unless a pinned known
discrepancy covers the mode.  This module holds only that table:
:data:`FLOOR_FRACS`, :data:`DEFAULT_FLOOR_FRAC`,
:data:`KNOWN_DISCREPANCIES`, :func:`known_discrepancy` and
:func:`floor_frac`, equal to the JAX package's.  The hardware models,
the calibration and the predicted-vs-measured reconciliation come with
profiling and analysis (ROADMAP A14).

The ``banded_sharded_recompute`` record describes the JAX package's
sharded banded kernel, which re-runs the full band pass after its
remote-copy wait.  The port's kernel B5 has no such recompute (each
merge launch covers only its own rows), but the record stays so that
perf-lens blocks written by the JAX package are judged alike by either
doctor.
"""

from __future__ import annotations

import re

#: per-mode roofline_frac floors for the ``roofline_floor`` doctor
#: clause: (mode regex, min frac).  First match wins; modes below their
#: floor FAIL unless a KNOWN_DISCREPANCIES entry pins them.  The floors
#: are deliberately loose — they catch catastrophic lying (a fused
#: kernel silently falling back to a gather path, a model declared 100x
#: wrong), not tuning headroom.
FLOOR_FRACS: tuple = (
    (r"^serve", 5e-4),          # fabric rounds ride host orchestration
    (r"^autotune", 5e-4),       # probe scale is launch-overhead bound
    (r"^halo", 5e-4),           # sharded rounds ride collective
                                # rendezvous the zero-ICI CPU-proxy
                                # wire term cannot floor
    (r"^edge", 1e-3),           # the reference edge kernel is the
                                # faithfulness oracle, not a tuned
                                # kernel: its floor catches collapse,
                                # not its honest distance from the roof
    (r".*", 2e-3),
)

#: the fallback floor when no pattern matches (unreachable with the
#: catch-all above; kept for callers composing their own tables)
DEFAULT_FLOOR_FRAC = 2e-3

#: pinned predicted-vs-measured discrepancies: ``roofline_floor``
#: reports a below-floor frac on a matching mode as KNOWN instead of
#: failing (the JAX package's record, kept for its perf-lens blocks; see
#: the module docstring).
KNOWN_DISCREPANCIES: tuple = (
    {
        "name": "banded_sharded_recompute",
        "mode_re": r"banded_fused.*@s(?:[2-9]|\d{2,})",
        "factor": 2.0,
        "reason": ("sharded fused banded round recomputes the full band "
                   "pass after the remote-DMA wait (~2x VPU work) "
                   "instead of re-accumulating only boundary rows — "
                   "parallel/banded_sharded.py, ROADMAP item 1"),
    },
)


def known_discrepancy(mode: str | None) -> dict | None:
    """The pinned discrepancy record covering ``mode``, or None."""
    if not mode:
        return None
    for rec in KNOWN_DISCREPANCIES:
        if re.search(rec["mode_re"], str(mode)):
            return rec
    return None


def floor_frac(mode: str | None) -> float:
    """The ``roofline_floor`` threshold for ``mode`` (first regex
    match in :data:`FLOOR_FRACS` wins)."""
    for pat, frac in FLOOR_FRACS:
        if re.search(pat, str(mode or "")):
            return frac
    return DEFAULT_FLOOR_FRAC
