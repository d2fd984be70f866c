"""The host-mirror aliasing probe of the service engine.

The port's copy of ``shared_mirror_report`` and
``assert_no_shared_mirrors`` (JAX ``flow_updating_tpu/analysis/
aliasing.py``, whose static half belongs to ROADMAP A14).  A
``ServiceEngine`` keeps numpy mirrors of its dynamic topology and edits
them in place (``_detach_pairs`` does ``self._deg[u] -= 1``); on the CPU,
``torch.from_numpy``/``torch.as_tensor`` of a mirror, or ``.to('cpu')`` of
a CPU tensor, would share that buffer, and the host edit would apply the
event to the device leaf a second time.  The engine therefore builds
every device leaf from a mirror with a copy, and this probe proves it:
``np.shares_memory`` over every CPU tensor leaf of ``state`` and
``arrays`` against every numpy mirror.  A query or aggregate fabric is
probed through its ``svc``, against the service's mirrors and the
fabric's own (the aggregate fabric's lane-mode vector).  Tensors on the
card cannot alias host memory, so the probe returns the ``skipped``
record there.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _host_mirrors(obj) -> dict:
    """name -> numpy mirror, over the instance's own attributes."""
    return {name: v for name, v in vars(obj).items()
            if isinstance(v, np.ndarray)}


def _device_leaves(obj):
    """(label, tensor) for every tensor leaf of ``state`` and ``arrays``
    (tuple-valued fields element by element)."""
    for attr in ("state", "arrays"):
        tree = getattr(obj, attr, None)
        if tree is None:
            continue
        for f in dataclasses.fields(tree):
            v = getattr(tree, f.name)
            if isinstance(v, torch.Tensor):
                yield f"{attr}.{f.name}", v
            elif isinstance(v, tuple):
                for i, x in enumerate(v):
                    if isinstance(x, torch.Tensor):
                        yield f"{attr}.{f.name}[{i}]", x


def shared_mirror_report(engine) -> dict:
    """The ``mirror_probe`` record a service manifest embeds:
    ``{"checked": n_pairs, "shared": [{"leaf", "mirror"}, ...]}`` —
    ``shared`` must be empty.  ``engine`` is a ``ServiceEngine`` or a
    fabric (probed through its ``svc``)."""
    target = getattr(engine, "svc", engine)
    leaves = list(_device_leaves(target))
    if any(t.device.type != "cpu" for _, t in leaves):
        return {"checked": 0, "shared": [],
                "skipped": "non-cpu backend (host buffers are copied)"}
    mirrors = _host_mirrors(target)
    if target is not engine:
        mirrors.update({f"fabric.{k}": v
                        for k, v in _host_mirrors(engine).items()})
    shared, checked = [], 0
    for label, leaf in leaves:
        view = leaf.detach().numpy()
        for name, mirror in mirrors.items():
            checked += 1
            if np.shares_memory(view, mirror):
                shared.append({"leaf": label, "mirror": name})
    return {"checked": checked, "shared": shared}


def assert_no_shared_mirrors(engine) -> None:
    """Raise if any device leaf aliases a host mirror (called by the
    restore and recover paths, so a zero-copy build fails when the
    engine is built, not rounds later as a double-applied event)."""
    rep = shared_mirror_report(engine)
    if rep["shared"]:
        pairs = ", ".join(f"{s['leaf']}<->{s['mirror']}"
                          for s in rep["shared"])
        raise AssertionError(
            f"device leaves alias in-place-mutated host mirrors "
            f"({pairs}) — a zero-copy tensor over a live numpy mirror; "
            "build device leaves with torch.tensor (copies)")
