#!/usr/bin/env python3
"""Design variants of kernels B6 (the halo pull and its fused merge) and B5
(the sharded banded round with the next fire folded in), timed on one
NVIDIA GPU (the PyTorch/CUDA port, ``flow_updating_tpu_torch``).

Run from the repository root on a machine with one card:

    python3 scripts/torch_b5_b6_variants.py [--source NAME=PATH ...]

It builds ``flow_updating_tpu_torch/csrc/halo_exchange.cu`` and
``sharded_round.cu`` as committed and in variants made by rewriting a few
of their lines, plus any other revision of either file given with
``--source`` (``NAME=PATH``; the file's name says which kernel), each with
nvcc in parallel:

* B6: ``conditional`` loads, at scalar lanes, the payload only where a
  cell of the vector is hit and the ring buffer only where one is not
  (the committed kernel loads both); ``pack_per_thread`` gives each thread its own pack's 64
  contiguous bytes at scalar lanes (the committed kernel lets a warp take
  32 packs together, each load 512 contiguous bytes); ``pack_32`` and
  ``pack_128`` move 32 or 128 bytes of a plane a thread per pack instead
  of 64; ``pull_1`` copies one 16-byte vector a pull thread a trip instead
  of 8; ``grid_x1`` launches the blocks the card holds at once (the
  committed kernel four times as many); ``occupancy_3`` caps registers
  so that three blocks fit on an SM.
* B5: ``smem_window`` stages each block's nodes plus H on each side in
  shared memory and reads the window there (the committed kernel reads
  avg directly in blocks H from both ends, through a three-way choice
  elsewhere); ``one_node`` gives each thread one node in every launch,
  ``always_wide`` 16 bytes of each plane in every aligned launch (the
  committed kernel takes 16 bytes where the launch still gives each SM a
  block at that width, else one node), ``wide_8`` 8 bytes instead of 16;
  ``diags_1`` adds each diagonal's read before it issues the next (the
  committed kernel issues 8 at once).

B6 runs at path F's shapes (the k=160 fat tree's BFS plan over 4 shards,
as ``chip_smoke.py`` builds it: Eb = 5,352,000, one row, its three offset
blocks of 3 rows, 30% of the cells hit), float32: one shard's fused call,
its pull alone and its merge alone.  B5 runs one shard's round of path E
(``ring(1_000_000, 2)`` over 4 shards) and of ``grid2d(1000, 1000)``,
float32: the interior launch, the boundary launch and both.  Every variant
is first held against the plain version (``torch.equal``), then timed as
``chip_smoke.py`` times a kernel: the profiler's device time of its CUDA
kernel per call over 20 calls, the largest of three traces (CUDA events
around back-to-back calls would time the host's launches: a B5 launch
takes a few microseconds on the card).  Prints one JSON object per kernel
and shape, then the ``nvidia-smi --query-gpu=name,power.limit`` line.
Exits non-zero without a card or when a variant differs from the plain
version.
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
SEED = 0

_BOTH_LOADS = """\
    xp[j] = *vec_at(a.pay_flow, (col0 + c) * SZ);
    yp[j] = *vec_at(a.pay_est, (col0 + c) * SZ);
    xb[j] = *vec_at(a.buf_flow, (cell0 + c) * SZ);
    yb[j] = *vec_at(a.buf_est, (cell0 + c) * SZ);
"""
_CONDITIONAL_LOADS = """\
    bool all = true;
    for (int k = 0; k < CPV; ++k) all = all && ((fh[j] >> (8 * k)) & 0xffu);
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    xp[j] = fh[j] ? *vec_at(a.pay_flow, (col0 + c) * SZ) : zero;
    yp[j] = fh[j] ? *vec_at(a.pay_est, (col0 + c) * SZ) : zero;
    xb[j] = all ? zero : *vec_at(a.buf_flow, (cell0 + c) * SZ);
    yb[j] = all ? zero : *vec_at(a.buf_est, (cell0 + c) * SZ);
"""

#: B6 variant name -> [(committed text, its replacement), ...]
B6_VARIANTS = {
    "conditional": [(_BOTH_LOADS, _CONDITIONAL_LOADS)],
    "pack_per_thread": [("    if (NF1) {\n      const int lane",
                         "    if (false) {\n      const int lane")],
    "pack_32": [("constexpr int kPackBytes = 64;",
                 "constexpr int kPackBytes = 32;")],
    "pack_128": [("constexpr int kPackBytes = 64;",
                  "constexpr int kPackBytes = 128;")],
    "pull_1": [("constexpr int kPullVecs = 8;",
                "constexpr int kPullVecs = 1;")],
    "grid_x1": [("constexpr int kWaves = 4;", "constexpr int kWaves = 1;")],
    "occupancy_3": [("__global__ void __launch_bounds__(kThreads)\n"
                     "exchange_kernel",
                     "__global__ void __launch_bounds__(kThreads, 3)\n"
                     "exchange_kernel")],
}

_WINDOW = """\
template <typename T, bool INSIDE>
__device__ __forceinline__ T window_at(const MergeArgs<T>& a, long long w) {
  if (INSIDE || (w >= a.H && w < a.H + a.L)) return a.avg[w - a.H];
  if (w < a.H) return a.lo[w];
  return a.hi[w - a.H - a.L];
}
"""
_SMEM_WINDOW = """\
template <typename T>
__device__ __forceinline__ T window_global(const MergeArgs<T>& a,
                                           long long w) {
  if (w >= a.H && w < a.H + a.L) return a.avg[w - a.H];
  if (w < a.H) return a.lo[w];
  return a.hi[w - a.H - a.L];
}

// the block's staged window: its origin, then the elements
template <typename T, bool INSIDE>
__device__ __forceinline__ T window_at(const MergeArgs<T>& a, long long w) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const long long w0 = *reinterpret_cast<const long long*>(smem_raw);
  return reinterpret_cast<const T*>(smem_raw + 16)[w - w0];
}
"""
_KERNEL_BODY = """\
  const long long p = b0 + (long long)threadIdx.x * V;
  if (p >= b1) return;
  if (b0 >= a.H && b1 + a.H <= a.L)
    merge_nodes<T, V, INLINE, true>(a, p);
  else
    merge_nodes<T, V, INLINE, false>(a, p);
"""
_SMEM_BODY = """\
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tile = reinterpret_cast<T*>(smem_raw + 16);
  const long long w1 = b1 + 2 * a.H;   // window coordinates [b0, w1)
  if (threadIdx.x == 0) *reinterpret_cast<long long*>(smem_raw) = b0;
  for (long long w = b0 + threadIdx.x; w < w1; w += kThreads)
    tile[w - b0] = window_global(a, w);
  __syncthreads();
  const long long p = b0 + (long long)threadIdx.x * V;
  if (p >= b1) return;
  merge_nodes<T, V, INLINE, true>(a, p);
"""
_LAUNCH = """\
  if (inl)
    sharded_merge_kernel<T, V, true><<<(unsigned)grid, kThreads, 0, stream>>>(
        rg, a);
  else
    sharded_merge_kernel<T, V, false><<<(unsigned)grid, kThreads, 0,
                                        stream>>>(rg, a);
"""
_SMEM_LAUNCH = """\
  const size_t smem = 16 + (size_t)(per + 2 * a.H) * sizeof(T);
  auto* kernel = inl ? sharded_merge_kernel<T, V, true>
                     : sharded_merge_kernel<T, V, false>;
  cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(kernel),
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)grid, kThreads, smem, stream>>>(rg, a);
"""

#: B5 variant name -> [(committed text, its replacement), ...]
B5_VARIANTS = {
    "smem_window": [(_WINDOW, _SMEM_WINDOW), (_KERNEL_BODY, _SMEM_BODY),
                    (_LAUNCH, _SMEM_LAUNCH)],
    "one_node": [("  constexpr int V = kWideBytes / sizeof(T);\n",
                  "  constexpr int V = 1;\n")],
    "always_wide": [(" &&\n      nodes >= (long long)sms * kThreads * V)",
                     ")")],
    "wide_8": [("constexpr int kWideBytes = 16;",
                "constexpr int kWideBytes = 8;")],
    "diags_1": [("constexpr int kDiags = 8;", "constexpr int kDiags = 1;")],
}


def variants(stem: str, edits: dict) -> dict:
    from flow_updating_tpu_torch import kernels

    with open(os.path.join(kernels.CSRC, stem + ".cu")) as f:
        committed = f.read()
    out = {"committed": committed}
    for name, pairs in edits.items():
        text = committed
        for old, new in pairs:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} is not in {stem}.cu "
                                   "exactly once")
            text = text.replace(old, new)
        out[name] = text
    return out


def build(sources: dict, out_dir: str) -> dict:
    """nvcc every ``(stem, name) -> text`` in parallel; ``{(stem, name):
    ctypes function}``."""
    from flow_updating_tpu_torch import kernels

    procs = {}
    for (stem, name), text in sources.items():
        path = os.path.join(out_dir, f"{stem}_{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        procs[stem, name] = subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o",
             os.path.join(out_dir, f"{stem}_{name}.so"), path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for (stem, name), proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {stem} {name}:\n{log}")
        lib = ctypes.CDLL(os.path.join(out_dir, f"{stem}_{name}.so"))
        fn = getattr(lib, stem)
        fn.argtypes = list(kernels.SIGNATURES[stem])
        fn.restype = ctypes.c_int
        fns[stem, name] = fn
    return fns


def b6_launch(fn, senders, recv, merge, outs):
    """One B6 launch through ``fn`` (the wrapper's call, any build)."""
    import torch

    from flow_updating_tpu_torch import kernels

    k = len(senders)
    table = ctypes.c_longlong * max(k, 1)
    src = table(*(b.data_ptr() for b in senders))
    dst = table(*(r.data_ptr() for r in recv))
    cnt = table(*(b.numel() for b in senders))
    cells, Eb, nf, ptrs = 0, 1, 1, [None] * 9
    if merge is not None:
        D, Eb = merge[0].shape
        cells = D * Eb
        ptrs = [t.data_ptr() for t in (*merge, *outs)]
    kernels.check(fn(0, k, ctypes.addressof(src), ctypes.addressof(dst),
                     ctypes.addressof(cnt), cells, Eb, nf, *ptrs,
                     torch.cuda.current_stream().cuda_stream),
                  "halo_exchange")


def run_b6(fns, dev) -> list:
    import numpy as np
    import torch

    import chip_smoke
    from flow_updating_tpu_torch.ops import halo_exchange as hx
    from flow_updating_tpu_torch.topology.generators import fat_tree

    eng, _ = chip_smoke.build_path_f(fat_tree(chip_smoke.FAT_TREE_K))
    plan = eng._halo_plan
    offsets = plan.perm_offsets
    rng = np.random.default_rng(SEED + 6)
    blocks, merge = chip_smoke._b6_inputs(rng, plan, 3, torch.float32, 1,
                                          dev, eng.config.delay_depth)
    del eng
    senders = [blocks[(0 - d) % plan.num_shards][i]
               for i, d in enumerate(offsets)]
    recv = [torch.empty_like(b) for b in senders]
    outs = [torch.empty_like(merge[3]), torch.empty_like(merge[4]),
            torch.empty_like(merge[5])]
    want = hx.fused_exchange_merge_plain(blocks, offsets, 0, *merge)
    hit = merge[0]
    row = {"kernel": "B6", "Eb": plan.Eb, "D": int(hit.shape[0]),
           "blocks": [list(b.shape) for b in senders],
           "hit_share": float(hit.float().mean()),
           "bound_ms": hx.halo_exchange_min_bytes(
               [b.numel() for b in senders], 4, hit.shape[0], plan.Eb, 1,
               int(hit.sum()), int(hit.any(0).sum())) / 3.35e12 * 1e3,
           "fused_ms": {}, "pull_ms": {}, "merge_ms": {}}
    for (stem, name), fn in fns.items():
        if stem != "halo_exchange":
            continue
        for r in recv:
            r.fill_(float("nan"))
        for o in outs:
            o.zero_()
        b6_launch(fn, senders, recv, merge, outs)
        torch.cuda.synchronize()
        if not (all(torch.equal(g, w) for g, w in zip(recv, want[0]))
                and all(torch.equal(g, w) for g, w in zip(outs, want[1:]))):
            raise AssertionError(f"B6 {name} differs from the plain version")
        ms = chip_smoke.device_ms
        row["fused_ms"][name] = ms(
            lambda: b6_launch(fn, senders, recv, merge, outs),
            "exchange_kernel")
        row["pull_ms"][name] = ms(
            lambda: b6_launch(fn, senders, recv, None, None),
            "exchange_kernel")
        row["merge_ms"][name] = ms(
            lambda: b6_launch(fn, [], [], merge, outs), "exchange_kernel")
    return [row]


def b5_launch(fn, spec, leaves, x, avg, ranges, out):
    """One folded B5 merge launch through ``fn`` over one or two ranges."""
    from flow_updating_tpu_torch import kernels

    (rb, re), (rb2, re2) = (tuple(ranges) + ((0, 0),))[:2]
    rem = leaves.rem_idx if spec.rem_route == "inline" else None
    kernels.check(fn(
        0, 2 if rem is not None else 0, rb, re, rb2, re2, 1, spec.local,
        spec.halo, len(spec.offsets), leaves.offsets.data_ptr(),
        leaves.planes.data_ptr(), x["value"].data_ptr(), x["S"].data_ptr(),
        x["G"].data_ptr(), x["avg_prev"].data_ptr(), x["A_prev"].data_ptr(),
        x["inv"].data_ptr(), x["deg"].data_ptr(), avg.data_ptr(),
        x["lo"].data_ptr(), x["hi"].data_ptr(),
        None if rem is None else rem.data_ptr(),
        max(spec.rem_width, 1) if rem is not None else 0,
        *(o.data_ptr() for o in out), kernels.stream_ptr(avg)),
        "sharded_round")


def run_b5(fns, dev) -> list:
    import numpy as np
    import torch

    import chip_smoke
    from flow_updating_tpu_torch import RoundConfig
    from flow_updating_tpu_torch.ops import sharded_round as sr
    from flow_updating_tpu_torch.parallel.banded_sharded import (
        ShardedBandedKernel,
    )
    from flow_updating_tpu_torch.parallel.mesh import make_mesh
    from flow_updating_tpu_torch.topology.generators import grid2d, ring

    cfg = RoundConfig.fast(kernel="node", spmv="banded_fused")
    rng = np.random.default_rng(SEED + 5)
    rows = []
    for label, topo in (("ring", ring(chip_smoke.RING_N, 2)),
                        ("grid", grid2d(chip_smoke.GRID_SIDE,
                                        chip_smoke.GRID_SIDE))):
        k = ShardedBandedKernel(topo, cfg, make_mesh(chip_smoke.SHARDS))
        spec, sh = k.spec, k._shards[0]
        x = chip_smoke._b5_inputs(k, rng, torch.float32, dev)[0]
        avg = chip_smoke._b5_fire(sh, x, spec)
        want = chip_smoke._b5_plain(x, avg, sh, spec)
        inner, outer = sr.row_ranges(spec, "pallas")
        out = [torch.empty_like(avg) for _ in range(4)]
        row = {"kernel": "B5", "graph": label, "local": spec.local,
               "halo": spec.halo, "lanes": len(spec.offsets),
               "rem_width": spec.rem_width,
               "bound_ms": sr.sharded_round_min_bytes(spec) / 3.35e12 * 1e3,
               "round_ms": {}, "interior_ms": {}, "boundary_ms": {}}
        for (stem, name), fn in fns.items():
            if stem != "sharded_round":
                continue
            for o in out:
                o.fill_(float("nan"))
            for ranges in (inner, outer):
                b5_launch(fn, spec, sh.leaves, x, avg, ranges, out)
            torch.cuda.synchronize()
            if not all(torch.equal(g, w) for g, w in zip(out, want)):
                raise AssertionError(f"B5 {name} ({label}) differs from the "
                                     "plain version")
            ms = chip_smoke.device_ms
            row["round_ms"][name] = ms(lambda: [
                b5_launch(fn, spec, sh.leaves, x, avg, r, out)
                for r in (inner, outer)], "sharded_merge_kernel")
            row["interior_ms"][name] = ms(
                lambda: b5_launch(fn, spec, sh.leaves, x, avg, inner, out),
                "sharded_merge_kernel")
            row["boundary_ms"][name] = ms(
                lambda: b5_launch(fn, spec, sh.leaves, x, avg, outer, out),
                "sharded_merge_kernel")
        rows.append(row)
        del k
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_b5_b6_variants: no CUDA device available",
              file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", action="append", default=[],
                    help="NAME=PATH of another halo_exchange.cu or "
                    "sharded_round.cu to time")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import chip_smoke
    from flow_updating_tpu_torch import kernels

    sources = {}
    for stem, edits in (("halo_exchange", B6_VARIANTS),
                        ("sharded_round", B5_VARIANTS)):
        for name, text in variants(stem, edits).items():
            sources[stem, name] = text
    for item in args.source:
        name, path = item.split("=", 1)
        stem = os.path.basename(path)[:-3]
        if stem not in ("halo_exchange", "sharded_round"):
            raise SystemExit(f"--source {item}: not a B5 or B6 source")
        with open(path) as f:
            sources[stem, name] = f.read()
    out_dir = os.path.join(kernels.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    fns = build(sources, out_dir)
    print(json.dumps({"build_s": time.perf_counter() - t0,
                      "variants": sorted(f"{s}:{n}" for s, n in fns)}),
          flush=True)
    dev = torch.device("cuda")
    for row in run_b5(fns, dev) + run_b6(fns, dev):
        print(json.dumps(row), flush=True)
    print(json.dumps({"timed_by_cuda_events": chip_smoke.EVENT_TIMED}),
          flush=True)
    print(chip_smoke.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
