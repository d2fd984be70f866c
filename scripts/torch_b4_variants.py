#!/usr/bin/env python3
"""Design variants of kernel B4's scan window pass, timed on one NVIDIA GPU
(the PyTorch/CUDA port, ``flow_updating_tpu_torch``).

Run from the repository root on a machine with one card:

    python3 scripts/torch_b4_variants.py [--source NAME=PATH ...]

It builds ``flow_updating_tpu_torch/csrc/seg_scan.cu`` as committed and in
variants made by rewriting a few of its lines (chunks of 512 or of
2,048 outputs a block instead of 1,024; one pack of 16 bytes a thread
instead of as many as 8 positions take; 16 positions a thread in blocks
of at most 512), plus any
other ``seg_scan.cu`` given with ``--source`` (an earlier revision, say),
each with nvcc in parallel.  On the k=160 fat tree's segment plan (P =
2^23, path D's 8 scan stages on its rank plane, as ``chip_smoke.py``
plans it) it holds every variant against the plain version
(``torch.equal``) for each scan op (sum, min, max) at float32 batch 1 and
2 and float64 batch 1, and times it with CUDA events over 50
back-to-back calls, beside the pass's byte bound (x read once, the dist
plane read once, the output written once, over 3.35 TB/s).  Prints one
JSON object per op and payload, then the ``nvidia-smi
--query-gpu=name,power.limit`` line.  Exits non-zero without a card or
when a variant differs from the plain version.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HBM_BYTES_PER_S = 3.35e12
REPS = 50

_THREADS = """\
  const int threads = (packs + K - 1) / K < kScanThreads
                          ? ((packs + K - 1) / K + 31) / 32 * 32
                          : kScanThreads;
"""
#: one pack a thread
_ONE_PACK = """\
  const int threads =
      packs < kScanThreads ? (packs + 31) / 32 * 32 : kScanThreads;
"""

#: variant name -> [(committed text, its replacement), ...]
VARIANTS = {
    "chunk_512": [("constexpr int kScanChunk = 1024;",
                   "constexpr int kScanChunk = 512;")],
    "chunk_2048": [("constexpr int kScanChunk = 1024;",
                    "constexpr int kScanChunk = 2048;")],
    "one_pack": [(_THREADS, _ONE_PACK)],
    "per_16": [("constexpr int kScanPer = 8;", "constexpr int kScanPer = 16;"),
               ("constexpr int kScanThreads = 1024;",
                "constexpr int kScanThreads = 512;")],
}


def build(sources: dict, out_dir: str) -> dict:
    """nvcc every source in parallel; ``{name: ctypes function}``."""
    from flow_updating_tpu_torch import kernels

    procs = {}
    for name, text in sources.items():
        path = os.path.join(out_dir, f"seg_scan_{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o",
             os.path.join(out_dir, f"seg_scan_{name}.so"), path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        fn = ctypes.CDLL(os.path.join(out_dir, f"seg_scan_{name}.so")).seg_scan
        fn.argtypes = list(kernels.SIGNATURES["seg_scan"])
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def events_ms(fn) -> float:
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_b4_variants: no CUDA device available", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", action="append", default=[],
                    help="NAME=PATH of another seg_scan.cu to time")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    from flow_updating_tpu_torch import kernels
    from flow_updating_tpu_torch.ops import fused_passes as fp
    from flow_updating_tpu_torch.ops.seg_benes import plan_segments
    from flow_updating_tpu_torch.topology.generators import fat_tree

    with open(os.path.join(kernels.CSRC, "seg_scan.cu")) as f:
        committed = f.read()
    sources = {"committed": committed}
    for name, edits in VARIANTS.items():
        text = committed
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} is not in seg_scan.cu "
                                   "exactly once")
            text = text.replace(old, new)
        sources[name] = text
    for item in args.source:
        name, path = item.split("=", 1)
        with open(path) as f:
            sources[name] = f.read()
    out_dir = os.path.join(kernels.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    fns = build(sources, out_dir)
    print(json.dumps({"built": sorted(fns), "nvcc_s":
                      time.perf_counter() - t0}), flush=True)

    class Lib:  # what kernels.library() returns, for one variant
        def __init__(self, fn):
            self.seg_scan = fn

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    topo = fat_tree(160)
    plan, dist = plan_segments(topo.row_start, topo.out_deg, topo.edge_rank,
                               fused=True)
    dist = torch.from_numpy(dist).to(dev)
    geom = plan.geom
    dists = tuple(1 << k for k in range(plan.scan_bits))
    n_pass = len(fp.plan_dist_passes(dists, geom))
    print(json.dumps({"P": geom.P, "tile": geom.tile, "stages": list(dists),
                      "passes": n_pass,
                      "plan_s": time.perf_counter() - t0}), flush=True)
    rng = np.random.default_rng(0)
    failed = False
    for op in fp.SCAN_OPS:
        for batch, dt in ((1, torch.float32), (2, torch.float32),
                          (1, torch.float64)):
            x = torch.from_numpy(rng.uniform(-1, 1, (batch, geom.P))).to(
                dev, dt)
            want = fp.segscan_pass_plain(x, dist, dists, op, geom)
            row = {"op": op, "batch": batch, "dtype": str(dt).split(".")[1],
                   "bound_ms": n_pass * fp.dist_pass_min_bytes(
                       geom, batch, x.element_size())
                   / HBM_BYTES_PER_S * 1e3}
            for name, fn in fns.items():
                kernels._libs["seg_scan"] = Lib(fn)
                if not torch.equal(fp.segscan_pass(x, dist, dists, op, geom),
                                   want):
                    row[name] = "differs"
                    failed = True
                    continue
                row[name] = events_ms(
                    lambda: fp.segscan_pass(x, dist, dists, op, geom))
            print(json.dumps(row), flush=True)
    kernels._libs.pop("seg_scan", None)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
