#!/usr/bin/env python3
"""Design variants of kernel B3's window, wide and wide2 passes, timed on
one NVIDIA GPU (the PyTorch/CUDA port, ``flow_updating_tpu_torch``).

Run from the repository root on a machine with one card:

    python3 scripts/torch_b3_variants.py [--source NAME=PATH ...]

It builds ``flow_updating_tpu_torch/csrc/benes_pass.cu`` as committed and
in variants made by rewriting a few of its lines (the window kernel with
each batch row's window of x staged in shared memory before the gather,
with every walk in window positions mod 2 * tile, even where no walk can
wrap, and with a cap of 3 resident blocks; the roll chain of wide2 and
of its one-stage instance, the wide pass, with 8 steps per thread, and
with a cap of 2 resident blocks), plus any other
``benes_pass.cu`` given with ``--source`` (an earlier revision, say),
each with nvcc in parallel.  On
the k=160 fat tree's neighbor-sum network (P = 2^23, as ``chip_smoke.py``
plans it) it holds every variant against the plain version
(``torch.equal``) on every window pass, on a roll and a swap wide2 pass
of each distance pair and on a wide pass of each kind and distance, and
times it with CUDA events over 50
back-to-back calls: float32 at batch 1 and 3, float64 at batch 1, beside
``torch.index_select`` with the pass's source index and the pass's byte
bound (x read once, the mask plane read once, the output written once,
over 3.35 TB/s).  Prints one JSON object per pass and payload, then the
``nvidia-smi --query-gpu=name,power.limit`` line.  Exits non-zero without
a card or when a variant differs from the plain version.
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

#: The window kernel's gather with x staged: each batch row's window
#: (2 tiles) copied to shared memory behind the mask ring, then read there.
_GATHER = """\
#pragma unroll
      for (int e = 0; e < kWalkPer; ++e)
        if (e < per) v[e] = xb[row0 + (w[e] & wrap0)];
"""
_STAGED_GATHER = """\
      W* sx = reinterpret_cast<W*>(sm + kRing * tile);
      for (int q = threadIdx.x; q < 2 * tile; q += blockDim.x)
        sx[q] = xb[row0 + (q & wrap0)];
      __syncthreads();
#pragma unroll
      for (int e = 0; e < kWalkPer; ++e)
        if (e < per) v[e] = sx[w[e]];
      __syncthreads();  // the next row overwrites sx
"""

#: variant name -> [(committed text, its replacement), ...]
VARIANTS = {
    "window_stage_x": [
        (_GATHER, _STAGED_GATHER),
        ("const size_t smem = kRing * (size_t)tile * sizeof(unsigned);",
         "const size_t smem = kRing * (size_t)tile * sizeof(unsigned)"
         " + 2 * (size_t)tile * sizeof(W);"),
        ("const size_t max_smem = kRing * (size_t)kMaxTile * "
         "sizeof(unsigned);",
         "const size_t max_smem = kRing * (size_t)kMaxTile * "
         "sizeof(unsigned) + 2 * (size_t)kMaxTile * sizeof(W);")],
    "window_wrap_walk": [("  if (sum >= tile)\n", "  if (true)\n")],
    "window_3_blocks": [("constexpr int kWalkMinBlocks = 2;",
                         "constexpr int kWalkMinBlocks = 3;")],
    "wide2_seg_8": [("constexpr int kWide2Seg = 4;",
                     "constexpr int kWide2Seg = 8;")],
    "wide2_two_blocks": [("constexpr int kChainBlocks = 3;",
                          "constexpr int kChainBlocks = 2;")],
}


def build(sources: dict, out_dir: str) -> dict:
    """nvcc every source in parallel; ``{name: ctypes function}``."""
    from flow_updating_tpu_torch import kernels

    procs = {}
    for name, text in sources.items():
        path = os.path.join(out_dir, f"benes_{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o",
             os.path.join(out_dir, f"benes_{name}.so"), path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        fn = ctypes.CDLL(os.path.join(out_dir, f"benes_{name}.so")).benes_pass
        fn.argtypes = list(kernels.SIGNATURES["benes_pass"])
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


def k160_network(dev):
    """The fat tree k=160 neighbor-sum network, planned as chip_smoke's
    phase k3 does: its fused plan and mask planes on ``dev``."""
    from flow_updating_tpu_torch.models.config import RoundConfig
    from flow_updating_tpu_torch.models.sync import NodeKernel
    from flow_updating_tpu_torch.ops.spmv_benes import plan_neighbor_sum
    from flow_updating_tpu_torch.topology.generators import fat_tree

    xla = NodeKernel(fat_tree(160), RoundConfig.fast(kernel="node",
                                                      spmv="xla"), device=dev)
    mats = tuple(m.cpu().numpy() for m in xla.arrays.mats)
    plan = plan_neighbor_sum(mats, xla.padded_size + 1, fused=True)
    return plan.fused, plan.to(dev)


def chosen_passes(fused) -> list:
    """Every window pass, and the first wide or wide2 pass of each (kind,
    D1, D2)."""
    seen, out = set(), []
    for i, ps in enumerate(fused.passes):
        key = (ps.kind, ps.block_dist, ps.block_dist2)
        if ps.kind == "window" or (ps.kind.startswith("wide")
                                   and key not in seen):
            seen.add(key)
            out.append(i)
    return out


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_b3_variants: no CUDA device available", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", action="append", default=[],
                    help="NAME=PATH of another benes_pass.cu to time")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    from flow_updating_tpu_torch import kernels
    from flow_updating_tpu_torch.ops import fused_passes as fp

    with open(os.path.join(kernels.CSRC, "benes_pass.cu")) as f:
        committed = f.read()
    sources = {"committed": committed}
    for name, edits in VARIANTS.items():
        text = committed
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} is not in "
                                   "benes_pass.cu exactly once")
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
            self.benes_pass = fn

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    fused, planes = k160_network(dev)
    geom = fused.geom
    print(json.dumps({"P": geom.P, "tile": geom.tile, "plan_s":
                      time.perf_counter() - t0}), flush=True)
    rng = np.random.default_rng(0)
    failed = False
    for i in chosen_passes(fused):
        ps, plane = fused.passes[i], planes[i]
        wrapper, plain = fp.PASS_FNS[ps.kind], fp.PLAIN_FNS[ps.kind]
        names = [n for n in fns if not n.startswith(
            "wide2" if ps.kind == "window" else "window")]
        for batch, dt in ((1, torch.float32), (3, torch.float32),
                          (1, torch.float64)):
            shape = (batch, geom.grid, geom.tile)
            x = torch.from_numpy(rng.uniform(-1, 1, shape)).to(dev, dt)
            want = plain(x, plane, ps, geom)
            kernels._libs["benes_pass"] = Lib(fns["committed"])
            src = wrapper(torch.arange(geom.P, device=dev).reshape(
                1, *shape[1:]), plane, ps, geom).reshape(geom.P)
            xf = x.reshape(batch, geom.P)
            row = {"pass": i, "kind": ps.kind, "stages": len(ps.dists),
                   "dists": list(ps.dists) if ps.kind == "window"
                   else [ps.block_dist, ps.block_dist2],
                   "batch": batch, "dtype": str(dt).split(".")[1],
                   "library_ms": events_ms(
                       lambda: torch.index_select(xf, 1, src)),
                   "bound_ms": fp.pass_min_bytes(
                       ps, geom, batch, x.element_size())
                   / HBM_BYTES_PER_S * 1e3}
            for name in names:
                kernels._libs["benes_pass"] = Lib(fns[name])
                if not torch.equal(wrapper(x, plane, ps, geom), want):
                    row[name] = "differs"
                    failed = True
                    continue
                row[name] = events_ms(lambda: wrapper(x, plane, ps, geom))
            print(json.dumps(row), flush=True)
    kernels._libs.pop("benes_pass", None)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
