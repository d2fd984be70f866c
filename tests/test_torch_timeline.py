"""Measured timelines (``obs/timeline.py``, ``utils/trace.py``) against the
JAX package's ``obs/timeline.py``.

* the interval arithmetic (``_union``, ``_overlap_with``) equals JAX's on
  the same intervals;
* a synthetic ``torch.profiler`` trace: the card's kernel, copy and memset
  slices on lanes ``(device, stream)``, the hand kernels' kept events, the
  overlap of the wire (copies, B6) with compute on the same card, the
  annotation spans (the host's row, not the card's mirror);
* a real CPU capture through ``utils.trace.trace`` and ``annotate``: the
  file is found, its spans read, and with no device slice the overlap
  degrades as JAX's does (a record with ``overlap_ratio_measured`` None
  and a note; no capture at all: None);
* ``trace_record`` holds the kept events against the launches and says
  ``trace_complete`` False where the trace dropped one.
"""

import gzip
import json

import numpy as np
import pytest
import torch

from flow_updating_tpu.obs import timeline as jtl
from flow_updating_tpu_torch.obs import profile as pprof
from flow_updating_tpu_torch.obs import timeline
from flow_updating_tpu_torch.utils.trace import annotate, trace


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("seed", range(6))
def test_interval_arithmetic_equals_jax(seed):
    rng = np.random.default_rng(seed)
    starts = rng.uniform(0, 100, 12)
    iv = [(float(a), float(a + d))
          for a, d in zip(starts, rng.uniform(0, 15, 12))]
    assert timeline._union(iv) == jtl._union(iv)
    u = timeline._union(iv)
    for a, d in zip(rng.uniform(-10, 110, 8), rng.uniform(0, 30, 8)):
        probe = (float(a), float(a + d))
        assert timeline._overlap_with(probe, u) \
            == jtl._overlap_with(probe, u)
    assert timeline._union([(5, 15), (0, 10), (20, 30)]) \
        == [(0, 15), (20, 30)]
    assert timeline._overlap_with((8, 25), [(0, 15), (20, 30)]) == 12.0


def _write(tmp_path, events: list) -> str:
    path = tmp_path / "fu.1.pt.trace.json.gz"
    with gzip.open(path, "wt") as fh:
        json.dump({"traceEvents": events}, fh)
    return str(tmp_path)


def _dev(name, ts, dur, stream, cat="kernel", device=0):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": device, "tid": stream,
            "args": {"device": device, "stream": stream}}


def test_synthetic_torch_trace(tmp_path):
    log_dir = _write(tmp_path, [
        {"ph": "X", "cat": "user_annotation", "name": "fu.segment",
         "ts": 0, "dur": 100, "pid": 9, "tid": 9},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "fu.segment",
         "ts": 1, "dur": 99, "pid": 0, "tid": 7},
        # the wire: a copy on shard 1's copy stream (13) 0..10, half under
        # a kernel on stream 7 of the same card; B6 on stream 9, 40..50,
        # fully under compute on stream 7
        _dev("Memcpy DtoD (Device -> Device)", 0, 10, 13,
             cat="gpu_memcpy"),
        _dev("void fu::exchange_kernel<4, 1>(...)", 40, 10, 9),
        _dev("void fu::butterfly_pass<4, 3>(...)", 5, 10, 7),
        _dev("void at::native::elementwise_kernel<...>", 35, 20, 7),
        _dev("void spmv_ell_warp_rows<float>(...)", 60, 5, 7),
        _dev("void spmv_ell_thread_rows<float>(...)", 66, 4, 7),
        # compute on ANOTHER card covers the copy: not this card's hiding
        _dev("void at::native::vectorized_elementwise_kernel<...>", 0, 10,
             7, device=1),
        _dev("Memset (Device)", 70, 1, 7, cat="gpu_memset"),
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 0,
         "dur": 5, "pid": 9, "tid": 9},
    ])
    events, threads = timeline.load_trace_events(
        timeline.latest_trace_file(log_dir))
    slices = timeline.device_slices(events, threads)
    assert len(slices) == 8
    assert {s["lane"] for s in slices} == {(0, 13), (0, 9), (0, 7), (1, 7)}
    kept = timeline.kernel_events(slices)
    assert kept == {"B6": {"events": 1, "device_us": 10.0},
                    "B3": {"events": 1, "device_us": 10.0},
                    "K1": {"events": 2, "device_us": 9.0}}
    spans = timeline.annotation_spans(events, "fu.segment")
    assert spans == [{"ts_us": 0.0, "dur_us": 100.0}]
    out = timeline.measured_overlap(log_dir)
    assert (out["wire_ops"], out["compute_ops"]) == (2, 6)
    assert out["wire_busy_s"] == pytest.approx(20 / 1e6)
    # 5 of the copy's 10 us and all 10 of B6's under compute on card 0
    assert out["overlap_ratio_measured"] == pytest.approx(0.75)
    only = timeline.measured_overlap(log_dir, module="Memcpy")
    assert only["device_slices"] == 1 and only["compute_ops"] == 0
    assert only["overlap_ratio_measured"] == 0.0


def test_trace_record_holds_events_against_launches(tmp_path):
    log_dir = _write(tmp_path, [
        _dev("void spmv_ell_warp_rows<float>(...)", 0, 5, 7),
        _dev("void spmv_ell_thread_rows<float>(...)", 6, 5, 7),
        _dev("void fused_round_kernel<float, 0>(...)", 20, 5, 7),
    ])
    whole = pprof.trace_record(log_dir, {"K1": 2, "K2": 1})
    assert whole["trace_complete"] is True
    assert whole["kernels"]["K1"] == {"launches": 2, "events": 2,
                                      "device_ms": 0.01}
    assert whole["device_ms"] == pytest.approx(0.015)
    dropped = pprof.trace_record(log_dir, {"K1": 4, "K2": 1})
    assert dropped["trace_complete"] is False
    assert "device_ms" not in dropped
    assert "device_ms" not in dropped["kernels"]["K1"]
    host = pprof.trace_record(log_dir, {})
    assert host["trace_complete"] is None and "note" in host
    empty = tmp_path / "none"
    empty.mkdir()
    assert pprof.trace_record(str(empty), {"K1": 1})["trace_complete"] \
        is None


def test_real_cpu_capture_and_degradation(tmp_path):
    with trace(None):          # a no-op for None
        pass
    assert timeline.measured_overlap(str(tmp_path)) is None
    x = torch.ones(1000, dtype=torch.float32)
    with trace(str(tmp_path / "cap")):
        for _ in range(3):
            with annotate("fu.segment"):
                x = x * 2.0 + 1.0
    path = timeline.latest_trace_file(str(tmp_path / "cap"))
    assert path.endswith(".pt.trace.json.gz")
    events, threads = timeline.load_trace_events(path)
    assert len(timeline.annotation_spans(events, "fu.segment")) == 3
    assert timeline.device_slices(events, threads) == []
    out = timeline.measured_overlap(str(tmp_path / "cap"))
    jout = {"wire_ops": 0, "overlap_ratio_measured": None,
            "wire_busy_s": 0.0, "overlapped_s": 0.0}
    assert {k: out[k] for k in jout} == jout
    assert "no wire slices" in out["note"]
    assert set(out) == {"trace_file", "device_slices", "wire_ops",
                        "compute_ops", "lanes", "module", "wire_busy_s",
                        "compute_busy_s", "overlapped_s",
                        "overlap_ratio_measured", "note"}
