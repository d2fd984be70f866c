"""Checkpoint / resume.

Counterpart of ``flow_updating_tpu/utils/checkpoint.py``, in the JAX
package's on-disk layout, so an archive written by either package
restores in the other:

* every state leaf, copied to the host, stored as ``state.<field>`` in
  one compressed ``.npz``;
* the :class:`RoundConfig` (all static knobs) and a JSON manifest, stored
  as the uint8 record ``__manifest__``;
* a topology fingerprint (node/edge counts + a sha256 of the edge list,
  delays and initial values), checked at restore so that a checkpoint can
  never be resumed against a different graph;
* a computed edge coloring (``aux.edge_color``), which re-seeds
  ``Topology._edge_coloring`` at restore so that a resumed fast-pairwise
  run does not color the graph again.

The leaves are JAX's: a :class:`FlowUpdatingState` writes its PRNG key as
the two uint32 words (the port holds them in int64), a node state
(``state_class`` ``NodeSyncState``) writes ``t`` as an int32 scalar and
its vectors in the kernel's padded node layout — ``(M,)`` for
``NodeKernel``, ``(S, M/S)`` for the sharded banded kernel.  A restore
reads the leaves as stored: the archive's dtype is the dtype.

The service flavour (:func:`save_service_checkpoint`,
:func:`load_service_checkpoint`) archives a ``ServiceEngine``: the state
leaves plus the dynamic topology the membership events produced (the
``svc.*`` host mirrors of :data:`_SERVICE_TOPO_KEYS`) and the capacity,
epoch and flight-recorder meta, versioned apart
(:data:`SERVICE_FORMAT_VERSION`) in the JAX package's layout, so a
service archive of either package restores in the other.  The actor
flavour (``save_actor_checkpoint``, ROADMAP A8) is not ported; it raises
naming its item.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
import zipfile
import zlib

import numpy as np
import torch

from flow_updating_tpu_torch.models.config import RoundConfig
from flow_updating_tpu_torch.models.state import (
    FlowUpdatingState,
    state_from_numpy,
)
from flow_updating_tpu_torch.utils.device import resolve_device

# 2: pending_* mailbox arrays gained a leading depth axis (Q, E) and the
#    pending_stamp field — v1 checkpoints cannot resume.
FORMAT_VERSION = 2

# Service checkpoints version their own schema on top of the archive
# format (the JAX package's numbers): the dynamic-topology mirror set is
# part of the contract.  Version 2 may carry the query fabric's lane
# tables under meta["query"]; version-1 archives carry none and still
# restore (a ServiceEngine restore ignores the block either way).
SERVICE_FORMAT_VERSION = 2
SERVICE_READ_VERSIONS = (1, 2)
_SERVICE_TOPO_KEYS = ("src", "dst", "rev", "out_deg", "rows", "delay",
                      "free_nodes", "free_edges", "member")

_NODE_FIELDS = ("t", "S", "G", "avg_prev", "A_prev")
_STATE_FIELDS = {
    "FlowUpdatingState": tuple(f.name for f in
                               dataclasses.fields(FlowUpdatingState)),
    "NodeSyncState": _NODE_FIELDS,
}


def topology_fingerprint(topo) -> dict:
    """Cheap content digest binding a checkpoint to its graph (the JAX
    package's: the same arrays, in the same dtypes, hash the same)."""
    h = hashlib.sha256()
    for arr in (topo.src, topo.dst, topo.delay, topo.values):
        h.update(np.ascontiguousarray(arr).tobytes())
    return {
        "num_nodes": int(topo.num_nodes),
        "num_edges": int(topo.num_edges),
        "digest": h.hexdigest(),
    }


#: Crash-point hook: called with the final path between the temp write
#: and its atomic rename (a test plants a failure here to prove that an
#: interrupted save leaves no file at the final path).
_CRASH_BEFORE_REPLACE = None

_TMP_RE = re.compile(r"\.tmp\.\d+$")


def _write_archive(path: str, manifest: dict, arrays: dict) -> None:
    """The one write path: a compressed npz with the JSON manifest as a
    uint8 buffer, written to a pid-suffixed temp file, fsynced and
    atomically renamed — a crash mid-write leaves a stale temp and NO
    final file, never a truncated archive at the final path.  A failed
    write removes its temp."""
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            np.savez_compressed(
                f, __manifest__=np.frombuffer(
                    json.dumps(manifest).encode(), dtype=np.uint8),
                **arrays)
            f.flush()
            os.fsync(f.fileno())
        if _CRASH_BEFORE_REPLACE is not None:
            _CRASH_BEFORE_REPLACE(path)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


def _open_archive(path: str):
    """Open a checkpoint archive with failures translated into errors
    that name the FILE and the likely fix — a truncated copy, a partial
    download or a non-checkpoint file never surfaces as a raw
    zipfile/pickle traceback."""
    try:
        return np.load(path)
    except FileNotFoundError:
        raise ValueError(f"checkpoint {path}: no such file") from None
    except (zipfile.BadZipFile, EOFError, OSError, ValueError) as exc:
        if _TMP_RE.search(path):
            raise ValueError(
                f"checkpoint {path}: this is a partially-written temp "
                "file from an interrupted save (checkpoints write to "
                "a .tmp.<pid> then atomically rename) — restore from "
                "the final checkpoint path; the temp is garbage") from exc
        raise ValueError(
            f"checkpoint {path}: not a readable checkpoint archive "
            f"({type(exc).__name__}: {exc}) — the file is truncated, "
            "still being written, or not a checkpoint at all") from exc


def _read_manifest(z, path: str) -> dict:
    if "__manifest__" not in z.files:
        raise ValueError(
            f"checkpoint {path}: no manifest record — the archive is "
            "not a flow_updating_tpu checkpoint (or was truncated "
            "mid-write; checkpoints are written atomically, so re-save)")
    try:
        manifest = json.loads(bytes(z["__manifest__"]).decode())
    except (ValueError, UnicodeDecodeError, zipfile.BadZipFile,
            zlib.error, EOFError, OSError) as exc:
        raise ValueError(
            f"checkpoint {path}: manifest is corrupt "
            f"({type(exc).__name__}: {exc})") from exc
    got = manifest.get("format_version")
    if got != FORMAT_VERSION:
        raise ValueError(
            f"checkpoint {path}: format version {got}, but this runtime "
            f"reads version {FORMAT_VERSION} — re-create the checkpoint "
            "with the current code (format 1 predates the depth-Q "
            "mailbox arrays and cannot be migrated)")
    return manifest


def state_leaves(state) -> tuple[str, dict]:
    """``(state_class, {field: numpy array})`` of a port state in the JAX
    package's leaf form: a :class:`FlowUpdatingState` (key as uint32
    words), a ``NodeSyncState`` or a sharded banded node state (``t`` as
    an int32 scalar; vectors ``(M,)`` or ``(S, M/S)``)."""
    if isinstance(state, FlowUpdatingState):
        return "FlowUpdatingState", state.numpy()
    to_numpy = getattr(state, "to_numpy", None)
    if to_numpy is not None:           # ShardedNodeState
        leaves = dict(to_numpy())
    elif all(hasattr(state, f) for f in _NODE_FIELDS):
        leaves = {f: getattr(state, f).cpu().numpy()
                  for f in _NODE_FIELDS[1:]}
        leaves["t"] = state.t
    else:
        raise TypeError(f"cannot checkpoint a {type(state).__name__}")
    leaves["t"] = np.asarray(int(leaves["t"]), np.int32)
    return "NodeSyncState", {f: leaves[f] for f in _NODE_FIELDS}


def save_checkpoint(path: str, state, cfg: RoundConfig, topo=None,
                    extra: dict | None = None) -> None:
    """Write one atomic checkpoint file (``.npz``) at ``path``.

    If the topology has a computed edge coloring cached (the fast-pairwise
    prerequisite), it rides along and is re-seeded on restore, so a
    resumed run never recolors."""
    cls_name, leaves = state_leaves(state)
    arrays = {f"state.{k}": np.asarray(v) for k, v in leaves.items()}
    coloring = (getattr(topo, "_edge_coloring", None)
                if topo is not None else None)
    if coloring is not None:
        arrays["aux.edge_color"] = np.asarray(coloring[0])
    manifest = {
        "format_version": FORMAT_VERSION,
        "state_class": cls_name,
        "config": dataclasses.asdict(cfg),
        "topology": topology_fingerprint(topo) if topo is not None else None,
        "dtypes": {k[len("state."):]: str(v.dtype)
                   for k, v in arrays.items() if k.startswith("state.")},
        "num_colors": int(coloring[1]) if coloring is not None else None,
        "extra": extra or {},
    }
    _write_archive(path, manifest, arrays)


def read_checkpoint(path: str, topo=None
                    ) -> tuple[str, dict, RoundConfig, dict]:
    """Read and check an archive without building a state:
    ``(state_class, {field: numpy array}, config, extra)``.

    If ``topo`` is given and the checkpoint carries a fingerprint, they
    must match, and a stored edge coloring re-seeds ``topo``'s."""
    with _open_archive(path) as z:
        manifest = _read_manifest(z, path)
        try:
            fields = {k[len("state."):]: z[k] for k in z.files
                      if k.startswith("state.")}
            aux_color = (z["aux.edge_color"]
                         if "aux.edge_color" in z.files else None)
        except (zipfile.BadZipFile, zlib.error, EOFError, OSError,
                ValueError) as exc:
            # member reads are lazy: in-place corruption (a flipped byte,
            # a torn copy) surfaces here, not at open
            raise ValueError(
                f"checkpoint {path}: archive member unreadable "
                f"({type(exc).__name__}: {exc}) — the file is corrupt "
                "(bitflip or torn copy); restore from an older "
                "checkpoint") from exc
    cls_name = manifest.get("state_class", "FlowUpdatingState")
    if cls_name not in _STATE_FIELDS:
        raise ValueError(f"unknown checkpoint state class {cls_name!r}")
    want, have = set(_STATE_FIELDS[cls_name]), set(fields)
    if have != want:
        raise ValueError(
            f"checkpoint fields mismatch: missing {sorted(want - have)}, "
            f"unexpected {sorted(have - want)}")
    if topo is not None and manifest.get("topology"):
        fp = topology_fingerprint(topo)
        saved = manifest["topology"]
        if fp != saved:
            raise ValueError(
                "checkpoint was taken on a different topology "
                f"(saved {saved['num_nodes']} nodes/{saved['num_edges']} "
                f"edges, have {fp['num_nodes']}/{fp['num_edges']}, digests "
                f"{'match' if fp['digest'] == saved['digest'] else 'differ'})")
        # fingerprint-checked, so the coloring describes this edge list
        if aux_color is not None and manifest.get("num_colors") is not None:
            object.__setattr__(topo, "_edge_coloring",
                               (aux_color, int(manifest["num_colors"])))
    cfg = RoundConfig(**manifest["config"])
    saved_dtypes = manifest.get("dtypes", {})
    for name, arr in fields.items():
        saved = saved_dtypes.get(name)
        if saved is not None and str(arr.dtype) != saved:
            raise ValueError(
                f"checkpoint leaf {name!r} dtype {arr.dtype} does not match "
                f"its manifest entry {saved!r} (corrupt archive?)")
    return cls_name, fields, cfg, manifest.get("extra", {})


def load_checkpoint(path: str, topo=None, device=None):
    """Read a checkpoint: ``(state, config, extra)``.  The state is a
    :class:`FlowUpdatingState`, or a ``NodeSyncState`` in the archive's
    node layout, on ``device`` (the card unless ``device='cpu'``)."""
    device = resolve_device(device)
    cls_name, fields, cfg, extra = read_checkpoint(path, topo)
    if cls_name == "FlowUpdatingState":
        return state_from_numpy(fields, device=device), cfg, extra
    from flow_updating_tpu_torch.models.sync import NodeSyncState

    vecs = {f: torch.from_numpy(np.array(fields[f])).to(device)
            for f in _NODE_FIELDS[1:]}
    return (NodeSyncState(t=int(np.asarray(fields["t"]).ravel()[0]),
                          **vecs), cfg, extra)


def _not_ported(name: str, item: str):
    def fn(*args, **kwargs):
        raise NotImplementedError(
            f"{name}() is the ROADMAP item '{item}', not ported yet")

    fn.__name__ = fn.__qualname__ = name
    fn.__doc__ = f"The JAX package's ``{name}``: ROADMAP item {item}."
    return fn


save_actor_checkpoint = _not_ported("save_actor_checkpoint",
                                    "host actors (A8)")
load_actor_checkpoint = _not_ported("load_actor_checkpoint",
                                    "host actors (A8)")

# ---- service checkpoints (ServiceEngine) --------------------------------
#
# A service checkpoint is a run checkpoint plus the dynamic topology the
# membership events have produced: the live src/dst/rev/out_deg/row-
# matrix/delay mirrors, the free-slot lists and the member mask.  There
# is no topology fingerprint: the graph is mutable state, not an input.

def save_service_checkpoint(path: str, state: FlowUpdatingState,
                            cfg: RoundConfig, topo_arrays: dict,
                            meta: dict) -> None:
    """Write one atomic service checkpoint (state + dynamic topology +
    capacity metadata).  ``topo_arrays`` must carry exactly the
    :data:`_SERVICE_TOPO_KEYS` host mirrors; ``meta`` is the JSON
    capacity / epoch block :func:`load_service_checkpoint` returns."""
    missing = set(_SERVICE_TOPO_KEYS) - set(topo_arrays)
    if missing:
        raise ValueError(
            f"service checkpoint needs topology mirrors {sorted(missing)}")
    arrays = {f"state.{k}": np.asarray(v)
              for k, v in state.numpy().items()}
    for key in _SERVICE_TOPO_KEYS:
        arrays[f"svc.{key}"] = np.asarray(topo_arrays[key])
    manifest = {
        "format_version": FORMAT_VERSION,
        "state_class": type(state).__name__,
        "service_version": SERVICE_FORMAT_VERSION,
        "config": dataclasses.asdict(cfg),
        "dtypes": {k: str(v.dtype) for k, v in arrays.items()},
        "service": dict(meta),
        "extra": {},
    }
    _write_archive(path, manifest, arrays)


def load_service_checkpoint(path: str, device=None):
    """Read a service checkpoint: ``(state, config, topo_arrays, meta)``,
    the state on ``device`` (the card unless ``'cpu'`` is given) and the
    mirrors as numpy arrays.  A non-service archive, a schema version
    this runtime does not read, or a truncated or incomplete mirror set
    raises a ValueError naming the file and the fix."""
    device = resolve_device(device)
    with _open_archive(path) as z:
        manifest = _read_manifest(z, path)
        if "service_version" not in manifest:
            raise ValueError(
                f"checkpoint {path}: not a service checkpoint "
                f"(state_class={manifest.get('state_class')!r}, no "
                "service_version) — service archives are written by "
                "ServiceEngine.save_checkpoint; plain run checkpoints "
                "restore via Engine.restore_checkpoint")
        got = manifest["service_version"]
        if got not in SERVICE_READ_VERSIONS:
            readable = "/".join(str(v) for v in SERVICE_READ_VERSIONS)
            raise ValueError(
                f"checkpoint {path}: service schema version {got}, but "
                f"this runtime reads versions {readable} (writes "
                f"{SERVICE_FORMAT_VERSION}) — re-create the checkpoint "
                "with the current code")
        try:
            fields = {k[len("state."):]: z[k] for k in z.files
                      if k.startswith("state.")}
            svc = {k[len("svc."):]: z[k] for k in z.files
                   if k.startswith("svc.")}
        except (zipfile.BadZipFile, zlib.error, EOFError, OSError,
                ValueError) as exc:
            # member reads are lazy: in-place corruption (a flipped byte,
            # a torn copy) surfaces here, not at open
            raise ValueError(
                f"checkpoint {path}: archive member unreadable "
                f"({type(exc).__name__}: {exc}) — the file is corrupt "
                "(bitflip or torn copy); restore from an older "
                "checkpoint") from exc
    want = set(_STATE_FIELDS["FlowUpdatingState"])
    have = set(fields)
    if have != want:
        raise ValueError(
            f"checkpoint {path}: state fields mismatch — missing "
            f"{sorted(want - have)}, unexpected {sorted(have - want)} "
            "(truncated archive, or saved by an incompatible version)")
    missing = set(_SERVICE_TOPO_KEYS) - set(svc)
    if missing:
        raise ValueError(
            f"checkpoint {path}: service topology mirrors missing "
            f"{sorted(missing)} (truncated archive?)")
    saved_dtypes = manifest.get("dtypes", {})
    for name, arr in fields.items():
        saved = saved_dtypes.get(f"state.{name}")
        if saved is not None and str(arr.dtype) != saved:
            raise ValueError(
                f"checkpoint {path}: leaf {name!r} dtype {arr.dtype} "
                f"does not match its manifest entry {saved!r} (corrupt "
                "archive?)")
    cfg = RoundConfig(**manifest["config"])
    state = state_from_numpy(fields, device=device)
    return state, cfg, svc, manifest.get("service", {})
