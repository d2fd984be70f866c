"""Build and load the hand-written CUDA kernels.

Each source in ``flow_updating_tpu_torch/csrc/`` has a plain C interface and
is compiled on first use by ``nvcc`` into its own shared library under
``flow_updating_tpu_torch/_build/`` (named by a hash of the source and the
flags, so an edited source rebuilds), then loaded with ``ctypes``.  All
sources are compiled in parallel, one ``nvcc`` process each.  A build
failure raises; nothing falls back to another implementation.

Pointers and the CUDA stream cross the boundary as ``c_void_p``
(``tensor.data_ptr()``, ``torch.cuda.current_stream().cuda_stream``).
Every C entry point returns the ``cudaGetLastError()`` of its launch;
:func:`check` raises on a non-zero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(_HERE), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int

#: C signature of every kernel entry point: source stem -> argtypes
SIGNATURES = {
    "spmv_ell": (_I, _P, _P, _P, _LL, _I, _LL, _P),
    "fused_round": (_I, _I, _LL, _I, _I, _P, _P,
                    _P, _P, _P, _P, _P, _P, _P,
                    _P, _P, _I, _LL, _P, _P, _P, _P, _P),
    "benes_pass": (_I, _I, _P, _P, _P, _LL, _LL, _LL, _I, _P, _LL, _LL,
                   _P, _P),
    "seg_scan": (_I, _I, _P, _P, _P, _LL, _LL, _LL, _I, _P, _I, _P),
    "sharded_round": (_I, _I, _LL, _LL, _LL, _LL, _I, _LL, _LL, _I, _P,
                      _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                      _P, _I, _P, _P, _P, _P, _P),
    "halo_exchange": (_I, _I, _P, _P, _P, _LL, _LL, _I,
                      _P, _P, _P, _P, _P, _P, _P, _P, _P, _P),
}

_lock = threading.Lock()
_libs: dict = {}


class KernelError(RuntimeError):
    """A kernel failed to build, load or launch."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise KernelError("nvcc not found (PATH, $CUDA_HOME/bin, "
                      "/usr/local/cuda/bin); the CUDA kernels are built "
                      "from source on first use")


def _target(stem: str) -> str:
    with open(os.path.join(CSRC, stem + ".cu"), "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{stem}-{digest.hexdigest()[:12]}.so")


def build(stems=None) -> dict:
    """Compile every listed source (default: all) that is not built yet,
    one ``nvcc`` per source, all started together.  Returns
    ``{stem: seconds}`` (0.0 for a library that was already built)."""
    stems = tuple(SIGNATURES) if stems is None else tuple(stems)
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs = {}
    out = {}
    nvcc = None
    for stem in stems:
        target = _target(stem)
        if os.path.exists(target):
            out[stem] = 0.0
            continue
        nvcc = nvcc or _nvcc()
        tmp = f"{target}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, stem + ".cu")]
        jobs[stem] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT),
                      tmp, target, time.perf_counter())
    failed = []
    for stem, (proc, tmp, target, t0) in jobs.items():
        log, _ = proc.communicate()
        out[stem] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{stem}.cu:\n{log.decode(errors='replace')}")
            continue
        os.replace(tmp, target)
    if failed:
        raise KernelError("nvcc failed:\n" + "\n".join(failed))
    return out


def library(stem: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<stem>.cu``, built on first use."""
    lib = _libs.get(stem)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(stem)
        if lib is None:
            target = _target(stem)
            if not os.path.exists(target):
                build([stem])
            lib = ctypes.CDLL(target)
            fn = getattr(lib, stem)
            fn.argtypes = list(SIGNATURES[stem])
            fn.restype = ctypes.c_int
            _libs[stem] = lib
    return lib


def load_all() -> dict:
    """Build every kernel in parallel and load it; ``{stem: seconds}``."""
    times = build()
    for stem in SIGNATURES:
        library(stem)
    return times


def check(code: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if code != 0:
        raise KernelError(f"{what}: CUDA launch failed with cudaError_t "
                          f"{code}")


def stream_ptr(tensor) -> int:
    """The raw handle of PyTorch's current stream on ``tensor``'s card."""
    import torch

    return torch.cuda.current_stream(tensor.device).cuda_stream


def dtype_code(tensor) -> int:
    """0 float32, 1 float64, 2 int32.  An entry point refuses a code its
    kernel does not take (``cudaErrorInvalidValue``, raised by
    :func:`check`)."""
    import torch

    codes = {torch.float32: 0, torch.float64: 1, torch.int32: 2}
    if tensor.dtype not in codes:
        raise KernelError(f"kernels take float32, float64 or int32, got "
                          f"{tensor.dtype}")
    return codes[tensor.dtype]
