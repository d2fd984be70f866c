"""The JAX package's native library, whole, before a port test compares
against it.

The JAX package builds ``libfunative.so`` on first use by writing ``g++
-o`` straight onto ``flow_updating_tpu/native/_build/libfunative.so``,
with no temporary name and no lock, and treats any ``.so`` newer than the
source as fresh.  A failed load latches its numpy fallbacks for the rest
of the process.  Under ``pytest -n 6`` on a fresh checkout, every worker
reaches that builder while collecting the JAX test modules that call
``native.available()`` at import; a worker that opens the library while
another is still linking it fails with "file too short" and then draws
its graphs from the numpy generators, which draw other random numbers —
so a port test that holds the port's native library against JAX's fails
for that worker alone.

Importing this module (the port's test modules that reach
``flow_updating_tpu.native`` do it at module level, and every worker
imports every test module before it runs any) takes an ``fcntl.flock``
beside JAX's ``_build`` directory, builds the library with JAX's exact
command into a temporary name and ``os.replace``s it when it is missing
or stale (or when this process cannot load it), clears a latched failure
of this process, and fails naming the cause if JAX's ``get_lib()`` still
returns None.  Nothing of the JAX package is edited.
"""

from __future__ import annotations

import fcntl
import os
import subprocess

from flow_updating_tpu import native as jax_native

#: JAX's build command (``flow_updating_tpu/native/__init__.py``), the
#: output name left to the caller
JAX_CXX = ("g++", "-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall",
           "-shared")
LOCK = os.path.join(os.path.dirname(os.path.dirname(jax_native._SO)),
                    "_build.lock")
ATTEMPTS = 3


def _fresh() -> bool:
    so, src = jax_native._SO, jax_native._SRC
    return os.path.exists(so) and \
        os.path.getmtime(so) >= os.path.getmtime(src)


def _build() -> None:
    so = jax_native._SO
    os.makedirs(os.path.dirname(so), exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    try:
        subprocess.run([*JAX_CXX, "-o", tmp, jax_native._SRC], check=True,
                       capture_output=True, timeout=300)
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def jax_native_lib():
    """JAX's loaded native library, built under the lock if needed."""
    with open(LOCK, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            for attempt in range(ATTEMPTS):
                if attempt or not _fresh():
                    _build()
                if jax_native._lib is None:
                    # an earlier failed load in this process latched the
                    # numpy fallbacks; the library is whole now
                    jax_native._tried = False
                lib = jax_native.get_lib()
                if lib is not None:
                    return lib
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return None


LIB = jax_native_lib()
assert LIB is not None, (
    f"the JAX package's native library {jax_native._SO} did not load after "
    f"{ATTEMPTS} builds with {' '.join(JAX_CXX)}; the parity tests would "
    "compare against its numpy generators, which draw other random numbers")
