"""ctypes bindings for the port's C++ host runtime (``src/funative.cpp``).

The library holds the exact Erdős–Rényi and Barabási–Albert generators,
the big-graph builder, the Beneš router, the greedy edge coloring and the
reference-style discrete-event simulator (:func:`des_run`,
:func:`des_run_traj`, :func:`des_run_contend`) — the same algorithms as
the JAX package's native runtime, so both packages build the same graphs,
route the same networks and simulate the same events from the same
inputs.  The simulator runs on the host: it is the baseline a round rate
is divided by and the oracle the edge round's dynamics are held to.  The
library is compiled on first use with ``g++ -O3 -march=native -std=c++17
-fPIC -shared`` (the JAX package's flags) into
``flow_updating_tpu_torch/_build/`` under a name that hashes the source
and the flags (an edited source rebuilds), then loaded with ``ctypes``.

There is no numpy fallback: the generators' numpy paths draw other random
numbers, so a missing compiler or a failed build raises
:class:`NativeError` instead of quietly building a different graph.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_HERE, "src", "funative.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
#: the JAX package's flags: -march=native lets g++ contract the simulator's
#: float sums into FMAs as it does there, so both give the same bits
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-shared")

_lock = threading.Lock()
_lib = None


class NativeError(RuntimeError):
    """The native library failed to build or load."""


def _target() -> str:
    with open(SRC, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"funative-{digest.hexdigest()[:12]}.so")


def _build(target: str) -> None:
    cxx = shutil.which("g++")
    if cxx is None:
        raise NativeError("g++ not found on PATH; the port's native runtime "
                          "(graph generators above the JAX package's native "
                          "thresholds, the big-graph builder, the Beneš "
                          "router) is compiled from source on first use")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{target}.{os.getpid()}.tmp"
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SRC],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise NativeError(f"g++ failed on {SRC}:\n{proc.stderr}")
    os.replace(tmp, target)


def get_lib() -> ctypes.CDLL:
    """The loaded native library, built on first use (raises
    :class:`NativeError` when it cannot be built or loaded)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            target = _target()
            if not os.path.exists(target):
                _build(target)
            try:
                lib = ctypes.CDLL(target)
            except OSError as exc:
                raise NativeError(f"cannot load {target}: {exc}") from exc
            i64, u64 = ctypes.c_int64, ctypes.c_uint64
            i32p = ctypes.POINTER(ctypes.c_int32)
            i64p = ctypes.POINTER(ctypes.c_int64)
            u8p = ctypes.POINTER(ctypes.c_uint8)
            lib.fu_gen_erdos_renyi.restype = i64
            lib.fu_gen_erdos_renyi.argtypes = [i64, i64, u64, i64p]
            lib.fu_gen_barabasi_albert.restype = i64
            lib.fu_gen_barabasi_albert.argtypes = [i64, i64, u64, i64p]
            lib.fu_build_graph_count.restype = i64
            lib.fu_build_graph_count.argtypes = [i64, i64, i64p]
            lib.fu_build_graph.restype = i64
            lib.fu_build_graph.argtypes = [i64, i64, i64p, i32p, i32p, i32p,
                                           i32p]
            lib.fu_benes_route.restype = i64
            lib.fu_benes_route.argtypes = [i64, i64p, u8p]
            lib.fu_edge_coloring.restype = i64
            lib.fu_edge_coloring.argtypes = [i64, i64, i32p, i32p, i32p,
                                             i32p]
            f64p = ctypes.POINTER(ctypes.c_double)
            base = [i64, i64, i32p, i32p, i32p, i32p, i64p, f64p,
                    ctypes.c_int32, i64, i64, f64p, f64p]
            traj = base + [i64, ctypes.c_double, f64p]
            contend = traj + [i64, i32p, i64, f64p, u8p, f64p, i64, i64]
            for name, args in (("fu_des_run", base),
                               ("fu_des_run_traj", traj),
                               ("fu_des_run_contend", contend),
                               ("fu_des_run_contend_backlog", contend),
                               ("fu_des_run_lmm", contend)):
                getattr(lib, name).restype = i64
                getattr(lib, name).argtypes = args
            _lib = lib
    return _lib


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def gen_erdos_renyi_pairs(n: int, m: int, seed: int = 0) -> np.ndarray:
    """G(n, m) pairs plus a Hamiltonian backbone, ``(m + n, 2)`` int64."""
    lib = get_lib()
    out = np.empty(2 * (m + n), dtype=np.int64)
    k = lib.fu_gen_erdos_renyi(n, m, seed, _ptr(out, ctypes.c_int64))
    if k < 0:
        raise ValueError("bad Erdős–Rényi parameters")
    return out[: 2 * k].reshape(-1, 2)


def gen_barabasi_albert_pairs(n: int, m: int, seed: int = 0) -> np.ndarray:
    """The exact sequential Barabási–Albert pair list, int64 ``(K, 2)``."""
    lib = get_lib()
    npairs = m * (m + 1) // 2 + (n - m - 1) * m
    out = np.empty(2 * max(npairs, 0), dtype=np.int64)
    k = lib.fu_gen_barabasi_albert(n, m, seed, _ptr(out, ctypes.c_int64))
    if k < 0:
        raise ValueError("bad Barabási–Albert parameters")
    return out[: 2 * k].reshape(-1, 2)


def build_graph_arrays(num_nodes: int, pairs: np.ndarray):
    """Symmetrize, dedupe, sort and pair the reverse edges of ``pairs``:
    ``(src, dst, rev, out_deg)`` int32 arrays.  Pairs with an endpoint
    outside ``[0, num_nodes)`` are skipped, so range-check first."""
    lib = get_lib()
    flat = np.ascontiguousarray(pairs, dtype=np.int64).reshape(-1)
    npairs = flat.size // 2
    E = lib.fu_build_graph_count(num_nodes, npairs,
                                 _ptr(flat, ctypes.c_int64))
    src = np.empty(E, dtype=np.int32)
    dst = np.empty(E, dtype=np.int32)
    rev = np.empty(E, dtype=np.int32)
    deg = np.empty(num_nodes, dtype=np.int32)
    E2 = lib.fu_build_graph(num_nodes, npairs, _ptr(flat, ctypes.c_int64),
                            _ptr(src, ctypes.c_int32),
                            _ptr(dst, ctypes.c_int32),
                            _ptr(rev, ctypes.c_int32),
                            _ptr(deg, ctypes.c_int32))
    if E2 != E:
        raise NativeError(f"graph builder wrote {E2} edges, counted {E}")
    return src, dst, rev, deg


def benes_route(perm: np.ndarray) -> list:
    """The Beneš swap masks realizing ``y = x[perm]``: ``2 log2(n) - 1``
    bool arrays of length ``n`` (views of one buffer), the same masks as
    the numpy recursion in :func:`flow_updating_tpu_torch.ops.permute.
    benes_plan`."""
    lib = get_lib()
    perm = np.ascontiguousarray(perm, np.int64)
    n = len(perm)
    if n < 2 or n & (n - 1):
        raise ValueError("benes_route needs power-of-two length >= 2")
    stages = 2 * (n.bit_length() - 1) - 1
    # bool and uint8 share their layout: the rows are zero-copy views
    out = np.zeros((stages, n), np.bool_)
    if lib.fu_benes_route(n, _ptr(perm, ctypes.c_int64),
                          _ptr(out, ctypes.c_uint8)) < 0:
        raise ValueError("not a permutation")
    return [out[s] for s in range(stages)]


def edge_coloring(topo) -> tuple[np.ndarray, int]:
    """Greedy proper edge coloring (hubs first, the smallest color free at
    both endpoints; both directions of an edge share it): ``(color (E,)
    int32, number of colors)``."""
    lib = get_lib()
    E = topo.num_edges
    src = np.ascontiguousarray(topo.src, np.int32)
    dst = np.ascontiguousarray(topo.dst, np.int32)
    rev = np.ascontiguousarray(topo.rev, np.int32)
    color = np.full(E, -1, np.int32)
    c = lib.fu_edge_coloring(topo.num_nodes, E, _ptr(src, ctypes.c_int32),
                             _ptr(dst, ctypes.c_int32),
                             _ptr(rev, ctypes.c_int32),
                             _ptr(color, ctypes.c_int32))
    if c < 0:
        raise ValueError("malformed edge list")
    return color, int(c)


# ---- the reference-style discrete-event simulator --------------------------

def _des_args(topo, variant: str, timeout: int, ticks: int):
    """The leading arguments every ``fu_des_run*`` entry takes, and the
    estimate and last-average arrays it fills."""
    if variant not in ("collectall", "pairwise"):
        raise ValueError(f"unknown variant {variant!r}")
    n = topo.num_nodes
    arrays = [np.ascontiguousarray(getattr(topo, name), dt) for name, dt in
              (("src", np.int32), ("dst", np.int32), ("rev", np.int32),
               ("delay", np.int32))]
    row_start = np.ascontiguousarray(topo.row_start, np.int64)
    values = np.ascontiguousarray(topo.values, np.float64)
    if values.ndim != 1:
        raise ValueError("the DES takes scalar node values")
    est = np.empty(n, np.float64)
    last_avg = np.empty(n, np.float64)
    args = [n, topo.num_edges,
            *(_ptr(a, ctypes.c_int32) for a in arrays),
            _ptr(row_start, ctypes.c_int64), _ptr(values, ctypes.c_double),
            0 if variant == "collectall" else 1, timeout, ticks,
            _ptr(est, ctypes.c_double), _ptr(last_avg, ctypes.c_double)]
    # the arrays must outlive the call: keep them beside the pointers
    return args, (arrays, row_start, values), est, last_avg


def des_run(topo, variant: str = "collectall", timeout: int = 50,
            ticks: int = 1000):
    """The reference-style discrete-event simulator on a Topology:
    per-actor FIFO mailbox, one message drained per tick, per-edge latency
    ``topo.delay`` in whole ticks, collect-all or pairwise with its
    timeout.  Returns ``(estimates (N,), last_avg (N,), events)``."""
    args, keep, est, last_avg = _des_args(topo, variant, timeout, ticks)
    events = int(get_lib().fu_des_run(*args))
    del keep
    return est, last_avg, events


def des_run_traj(topo, variant: str = "collectall", timeout: int = 50,
                 ticks: int = 1000, obs_every: int = 10):
    """:func:`des_run` that also samples the RMSE against the true mean
    every ``obs_every`` ticks.  Returns ``(rmse (ticks // obs_every,),
    estimates, last_avg, events)``."""
    args, keep, est, last_avg = _des_args(topo, variant, timeout, ticks)
    rmse = np.empty(ticks // obs_every, np.float64)
    events = int(get_lib().fu_des_run_traj(
        *args, obs_every, float(topo.true_mean),
        _ptr(rmse, ctypes.c_double)))
    del keep
    return rmse, est, last_avg, events


def des_run_contend(topo, variant: str = "collectall", timeout: int = 50,
                    ticks: int = 1000, obs_every: int = 10,
                    clamp_d: int = 0, visit_seed: int = -1,
                    lmm: bool = False, backlog: bool = False):
    """:func:`des_run_traj` over the topology's link model.

    ``lmm=False``: the quasi-static per-tick bottleneck fair share over
    SHARED links (FATPIPE exempt), the model of
    :func:`flow_updating_tpu_torch.models.rounds.edge_delays`.
    ``lmm=True``: the dynamic max-min model — each transfer a continuous
    flow whose rate is re-solved by progressive filling whenever one
    starts or ends (the fidelity oracle).  ``backlog=True``
    (quasi-static only) also counts messages still in flight as standing
    load on their links, the twin of ``RoundConfig.contention_backlog``.
    ``clamp_d`` mirrors the ring-buffer clamp of a ``delay_depth``-bounded
    run (0: none); ``visit_seed >= 0`` reshuffles the within-tick visit
    order every tick (mt19937), ``-1`` keeps the fixed order.  Returns
    ``(rmse, estimates, last_avg, events)``."""
    if lmm and backlog:
        raise ValueError("backlog refines the quasi-static model; the "
                         "dynamic LMM already carries in-flight load")
    if topo.edge_links is None:
        raise ValueError("topology has no link model (see build_topology)")
    lib = get_lib()
    args, keep, est, last_avg = _des_args(topo, variant, timeout, ticks)
    links = np.ascontiguousarray(topo.edge_links, np.int32)
    ser = np.ascontiguousarray(topo.link_ser_rounds, np.float64)
    shared = np.ascontiguousarray(topo.link_shared, np.uint8)
    lat = np.ascontiguousarray(topo.lat_rounds, np.float64)
    rmse = np.empty(max(ticks // obs_every, 1), np.float64)
    name = ("fu_des_run_lmm" if lmm else "fu_des_run_contend_backlog"
            if backlog else "fu_des_run_contend")
    events = int(getattr(lib, name)(
        *args, obs_every, float(topo.true_mean), _ptr(rmse, ctypes.c_double),
        links.shape[1], _ptr(links, ctypes.c_int32), len(ser),
        _ptr(ser, ctypes.c_double), _ptr(shared, ctypes.c_uint8),
        _ptr(lat, ctypes.c_double), clamp_d, int(visit_seed)))
    del keep
    return rmse[: ticks // obs_every], est, last_avg, events
