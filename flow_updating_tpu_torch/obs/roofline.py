"""Backend roofline models + predicted-vs-measured reconciliation.

Counterpart of ``flow_updating_tpu/obs/roofline.py``.  Every cost the
port counts (``utils/cost.py``: bytes and flops of the plain ops and the
kernels' declared work, in ``Engine.profile``'s ``cost`` block) and every
rate it measures meet here.  A :class:`HardwareModel` declares what the
device can move and compute per second; :func:`analyze` composes it with
a profile record into arithmetic intensity, the binding resource and a
predicted floor time per round; :func:`reconcile` divides a measured rate
by the predicted ceiling into ``roofline_frac``, which must land in
(0, 1]: above 1 the model or the count is lying (doctor clause
``roofline_sane``); below the per-mode floor, without a pinned known
discrepancy, the implementation leaves the card idle (``roofline_floor``).

Model provenance, two kinds:

* **declared** — :data:`H100`, the one card the port runs on, from the
  NVIDIA H100 SXM data sheet: HBM3 at 3.35 TB/s, 67 TFLOP/s of float32
  outside the tensor cores (the resource every kernel of the port
  spends), dense TF32 tensor-core throughput (without sparsity) for the
  matmul roof.  ``ici_gbps`` is 0: the port's shards share one card
  (``parallel/mesh.py``), so their copies are HBM traffic that the byte
  count already holds.  ``chip_smoke.py``'s kernel bounds read the same
  model.  A card of another name gets the H100 model, flagged in
  ``notes``, as the JAX package gives an unlisted TPU its newest model.
* **measured** — the CPU has no published roofline, so it is calibrated
  once per machine with a STREAM-style triad (memory bandwidth) and a
  chained-FMA probe (vector flops), single-thread rates scaled by the
  core count (a ceiling, not an expectation), persisted beside the
  autotune cache (``FLOW_UPDATING_ROOFLINE_CACHE`` overrides the path).

Pure host-side arithmetic: nothing here runs on the card or changes what
a round computes.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import time

#: opt-in switch for the call sites that would otherwise pay an extra
#: count (the autotune probe annotation): off by default, the lens must
#: never slow a plain run
ROOFLINE_ENV = "FLOW_UPDATING_ROOFLINE"

#: calibration-record override (tests point it at a tmpdir); the default
#: lives beside autotune.json — one probe per machine
ROOFLINE_CACHE_ENV = "FLOW_UPDATING_ROOFLINE_CACHE"

#: calibration record version: bump when the probe method changes so a
#: stale persisted record re-probes instead of silently mismatching
_CALIBRATION_VERSION = 1


@dataclasses.dataclass(frozen=True)
class HardwareModel:
    """What one device can move and compute per second.

    ``hbm_gbps`` is main-memory stream bandwidth (GB/s), ``vpu_gflops``
    elementwise vector throughput (GFLOP/s, float32 — the resource the
    fire/merge passes spend), ``mxu_gflops`` dense matmul throughput,
    ``ici_gbps`` interconnect bandwidth (GB/s; 0 = no wire)."""

    name: str
    hbm_gbps: float
    vpu_gflops: float
    mxu_gflops: float
    ici_gbps: float
    source: str = "declared"
    notes: str = ""

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @property
    def hbm_bytes_per_s(self) -> float:
        return self.hbm_gbps * 1e9

    @property
    def vpu_flop_per_s(self) -> float:
        return self.vpu_gflops * 1e9


#: the NVIDIA H100 SXM (data sheet figures; module docstring)
H100 = HardwareModel(
    "nvidia-h100", hbm_gbps=3_350.0, vpu_gflops=67_000.0,
    mxu_gflops=494_700.0, ici_gbps=0.0,
    notes=("NVIDIA H100 SXM data sheet: HBM3 3.35 TB/s, float32 67 "
           "TFLOP/s (CUDA cores), TF32 tensor cores 494.7 TFLOP/s dense; "
           "ici 0: the port's shards are streams of one card, whose "
           "copies are HBM traffic the byte count already holds"))

#: declared models of the cards the port runs on, matched as substrings
#: of ``torch.cuda.get_device_name()`` (lower case)
GPU_MODELS: dict = {"h100": H100}


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
#: failing.  The record describes the JAX package's sharded banded kernel,
#: which re-runs the full band pass after its remote-copy wait; the port's
#: kernel B5 has no such recompute (each merge launch covers only its own
#: rows), but the record stays so that perf-lens blocks written by either
#: package are judged alike by either doctor.
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


# ---- CPU calibration -----------------------------------------------------


def roofline_cache_path() -> str:
    """Where the CPU calibration record persists — beside the autotune
    cache (``plan.select.autotune_cache_path()``'s directory)."""
    env = os.environ.get(ROOFLINE_CACHE_ENV)
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache",
                        "flow_updating_tpu_torch", "roofline_cpu.json")


def _measure_cpu(seconds: float = 0.12) -> dict:
    """STREAM-style single-thread probes: triad bandwidth over arrays
    far beyond LLC, chained FMA flops over an L2-resident array with
    preallocated outputs (the JAX package's probes)."""
    import numpy as np

    n_big = 1 << 22                       # 3 x 16 MiB fp32: past LLC
    rng = np.random.default_rng(0)
    a = np.empty(n_big, np.float32)
    b = rng.random(n_big).astype(np.float32)
    c = rng.random(n_big).astype(np.float32)
    reps, t0 = 0, time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        np.multiply(c, np.float32(1.0001), out=a)
        np.add(a, b, out=a)
        reps += 1
    triad_s = (time.perf_counter() - t0) / max(reps, 1)
    bw = 3 * 4 * n_big / max(triad_s, 1e-9)

    n_small = 1 << 16                     # 256 KiB fp32: cache-resident
    x = rng.random(n_small).astype(np.float32)
    y = rng.random(n_small).astype(np.float32)
    z = rng.random(n_small).astype(np.float32)
    t = np.empty(n_small, np.float32)
    reps, t0 = 0, time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(16):
            np.multiply(x, y, out=t)
            np.add(t, z, out=t)
        reps += 16
    fma_s = (time.perf_counter() - t0) / max(reps, 1)
    fl = 2.0 * n_small / max(fma_s, 1e-9)
    return {"stream_gbps_1t": bw / 1e9, "fma_gflops_1t": fl / 1e9,
            "triad_elems": n_big, "fma_elems": n_small}


def calibrate_cpu(*, force: bool = False, path: str | None = None,
                  threads: int | None = None) -> HardwareModel:
    """The CPU model: the persisted calibration record for this probe
    version if there is one, else the probes, persisted (atomic tmp +
    replace).  Single-thread rates scale by ``threads`` (default: the
    machine's core count), which biases the ceiling high."""
    p = path or roofline_cache_path()
    nthreads = threads if threads is not None else (os.cpu_count() or 1)
    rec = None
    if not force:
        try:
            with open(p) as fh:
                doc = json.load(fh)
            if isinstance(doc, dict) \
                    and doc.get("version") == _CALIBRATION_VERSION:
                rec = doc
        except (OSError, ValueError):
            rec = None
    if rec is None:
        rec = {"version": _CALIBRATION_VERSION, **_measure_cpu()}
        d = os.path.dirname(p)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = f"{p}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as fh:
                json.dump(rec, fh, indent=1, sort_keys=True)
            os.replace(tmp, p)
        except OSError:
            pass                          # read-only FS: calibrate-only
    return HardwareModel(
        name="cpu-proxy",
        hbm_gbps=rec["stream_gbps_1t"] * nthreads,
        vpu_gflops=rec["fma_gflops_1t"] * nthreads,
        mxu_gflops=rec["fma_gflops_1t"] * nthreads,
        ici_gbps=0.0,
        source="measured",
        notes=(f"STREAM triad {rec['stream_gbps_1t']:.2f} GB/s + "
               f"chained FMA {rec['fma_gflops_1t']:.2f} GFLOP/s per "
               f"thread, x{nthreads} threads (ceiling bias)"),
    )


def model_for_device_kind(device_kind: str) -> HardwareModel | None:
    """Match a card's name (``torch.cuda.get_device_name()``) against
    :data:`GPU_MODELS` — the longest key wins."""
    kind = str(device_kind).lower()
    best = None
    for key, model in GPU_MODELS.items():
        if key in kind and (best is None or len(key) > len(best[0])):
            best = (key, model)
    return best[1] if best else None


def resolve_model(device=None) -> HardwareModel:
    """The model of ``device`` (the card unless ``'cpu'`` is given): a
    declared card, or the measured CPU calibration."""
    import torch

    from flow_updating_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        name = torch.cuda.get_device_name(dev)
        model = model_for_device_kind(name)
        if model is not None:
            return model
        return dataclasses.replace(
            H100, name=f"gpu-unknown({name})",
            notes="unlisted card; using the H100 model as the ceiling")
    return calibrate_cpu()


# ---- roofline math ---------------------------------------------------------


def analyze(record: dict, model: HardwareModel, *,
            rounds: int | None = None, wire_bytes_per_round: float = 0.0,
            mode: str | None = None, compute_unit: str = "vpu") -> dict:
    """Compose one profile record with a hardware model: per-round
    arithmetic intensity, per-resource floor times, the binding resource
    and the predicted ceiling rate (the JAX package's arithmetic).
    ``compute_unit``: ``'vpu'`` for the elementwise passes (every kernel
    of the port), ``'mxu'`` for a dense-matmul program."""
    cost = record.get("cost") or {}
    flops, nbytes = cost.get("flops"), cost.get("bytes_accessed")
    r = max(int(rounds if rounds is not None
                else record.get("rounds") or 1), 1)
    out = {
        "mode": mode or record.get("mode") or record.get("label"),
        "model": model.name,
        "model_source": model.source,
        "compute_unit": compute_unit,
        "rounds": r,
    }
    if not isinstance(flops, (int, float)) \
            or not isinstance(nbytes, (int, float)) or nbytes <= 0:
        out.update({"error": "profile record carries no usable "
                    "flops/bytes_accessed cost analysis",
                    "floor_s_per_round": None,
                    "ceiling_rounds_per_sec": None})
        return out
    f_r, b_r = flops / r, nbytes / r
    w_r = max(float(wire_bytes_per_round), 0.0)
    rate_gflops = (model.vpu_gflops if compute_unit == "vpu"
                   else model.mxu_gflops)
    t_hbm = b_r / (model.hbm_gbps * 1e9) if model.hbm_gbps > 0 else 0.0
    t_compute = (f_r / (rate_gflops * 1e9)) if rate_gflops > 0 else 0.0
    t_wire = (w_r / (model.ici_gbps * 1e9)) if model.ici_gbps > 0 \
        and w_r > 0 else 0.0
    floors = {"hbm": t_hbm, "compute": t_compute, "wire": t_wire}
    binding = max(floors, key=lambda k: floors[k])
    floor = floors[binding]
    out.update({
        "flops_per_round": f_r,
        "bytes_per_round": b_r,
        "wire_bytes_per_round": w_r,
        "arithmetic_intensity": f_r / b_r,
        "t_hbm_s": t_hbm,
        "t_compute_s": t_compute,
        "t_wire_s": t_wire,
        "binding": binding,
        "floor_s_per_round": floor,
        "ceiling_rounds_per_sec": (1.0 / floor) if floor > 0 else None,
    })
    return out


def reconcile(roofline_rec: dict, measured_rounds_per_sec) -> dict:
    """Attach the measured rate and its ``roofline_frac`` (measured /
    predicted ceiling) to an :func:`analyze` record."""
    out = dict(roofline_rec)
    ceiling = out.get("ceiling_rounds_per_sec")
    measured = (float(measured_rounds_per_sec)
                if isinstance(measured_rounds_per_sec, (int, float))
                else None)
    out["measured_rounds_per_sec"] = measured
    frac = (measured / ceiling
            if measured is not None and isinstance(ceiling, (int, float))
            and ceiling > 0 else None)
    out["roofline_frac"] = round(frac, 6) if frac is not None else None
    out["floor_frac"] = floor_frac(out.get("mode"))
    kd = known_discrepancy(out.get("mode"))
    out["known_discrepancy"] = kd["name"] if kd else None
    return out


def perf_lens_block(programs: list, model: HardwareModel, *,
                    calibration: dict | None = None,
                    extra: dict | None = None) -> dict:
    """Assemble the ``flow-updating-perf-lens/v1`` manifest block from
    reconciled program records (``doctor`` judges it via
    ``roofline_sane`` / ``roofline_floor``)."""
    from flow_updating_tpu_torch.obs.report import PERF_LENS_SCHEMA

    block = {
        "schema": PERF_LENS_SCHEMA,
        "model": model.to_dict(),
        "programs": [dict(p) for p in programs],
        "known_discrepancies": [dict(d) for d in KNOWN_DISCREPANCIES],
    }
    if calibration is not None:
        block["calibration"] = dict(calibration)
    if extra:
        block.update(extra)
    return block


def _metric_slug(mode) -> str:
    return re.sub(r"[^a-zA-Z0-9]+", "_", str(mode or "unknown")).strip("_")


def export_metrics(registry, block: dict) -> None:
    """Surface a perf-lens block as MetricsRegistry gauges:
    ``roofline_frac_<mode>`` and ``roofline_ceiling_rps_<mode>``."""
    for prog in block.get("programs") or []:
        slug = _metric_slug(prog.get("mode"))
        frac = prog.get("roofline_frac")
        if isinstance(frac, (int, float)):
            registry.set_gauge(f"roofline_frac_{slug}", float(frac))
        ceil = prog.get("ceiling_rounds_per_sec")
        if isinstance(ceil, (int, float)):
            registry.set_gauge(f"roofline_ceiling_rps_{slug}",
                               float(ceil))


def enabled() -> bool:
    """The opt-in env switch for call sites that would otherwise pay an
    extra count (the autotune probe annotation)."""
    return os.environ.get(ROOFLINE_ENV, "0") not in ("", "0")
