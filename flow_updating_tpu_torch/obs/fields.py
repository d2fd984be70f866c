"""Topology-resolved observability: per-node and per-edge metric FIELDS.

Counterpart of ``flow_updating_tpu/obs/fields.py``.  Telemetry
(:mod:`flow_updating_tpu_torch.obs.telemetry`) records one global scalar
per metric per round, enough to say THAT a run stalled or leaked, never
WHERE.  Flow-Updating's invariants are local (each node's estimate, each
directed edge's antisymmetric flow), so the field runners keep the same
device-resident design (rows written into preallocated tensors on the
device, no host read inside the round loop, one bulk copy at the end)
down to per-node and per-edge resolution:

* ``node_err``            — alive-masked signed estimate error against
                            the true mean, ``(R, N[, D])``.  Its RMS over
                            nodes and features is the telemetry ``rmse``.
* ``node_mass``           — alive-masked per-node estimate (its sum is the
                            telemetry ``mass``).
* ``node_mass_residual``  — alive-masked ``estimate - input`` per node
                            (its sum is ``mass_residual`` up to summation
                            order).
* ``node_fired``          — cumulative averaging events per node (the
                            straggler counter), int32.
* ``node_conv_round``     — the convergence FRONTIER: the first recorded
                            round each node's pooled ``|err|`` entered
                            ``tol`` (-1 = never), an ``(N,)`` int32 field
                            carried through the loop and emitted once.
* ``edge_flow``           — the signed per-edge flow ledger (features
                            summed), ``(R, E)``.  Pairing it through
                            ``rev`` localizes mass leaks: a healthy pair
                            has ``flow[e] + flow[rev[e]] ~ 0``.
* ``edge_est``            — the per-edge estimate ledger (features
                            summed), ``(R, E)``: what ``src`` last heard
                            ``dst`` claim.
* ``edge_stale``          — rounds since the edge last averaged
                            (``t - stamp``), int32.

Two knobs on the spec bound memory: ``stride`` records every k-th round
only (each chunk runs k plain rounds, so the state evolves exactly as
under ``run_rounds``), and ``topk`` keeps only the ``m`` worst nodes per
row (ranked by pooled ``|node_err|``, ties to the lower index as
``jax.lax.top_k`` breaks them; the recorded ``topk_idx`` row carries
their ids).  ``stride`` works on every kernel; ``topk`` needs a
device-global ranking and is limited to the single-device kernels (edge,
node).

The per-kernel samplers live with their kernels (``models/rounds.py``,
``models/sync.py``, ``parallel/sharded.py``,
``parallel/structured_sharded.py``); ``Engine.run_fields`` dispatches and
re-assembles everything into ORIGINAL node and edge order.  Blame and run
diffing over these fields live in :mod:`flow_updating_tpu_torch.obs.
inspect`.  Pure numpy: the JAX package's manifests and this package's
cross both ways.
"""

from __future__ import annotations

import dataclasses

import numpy as np

#: Per-node fields, in canonical emission order.
NODE_FIELDS = (
    "node_err",            # (R, N[, D]) signed alive-masked est - mean
    "node_mass",           # (R, N[, D]) alive-masked estimate
    "node_mass_residual",  # (R, N[, D]) alive-masked est - input
    "node_fired",          # (R, N) int32 cumulative fires
    "node_conv_round",     # (N,) int32 convergence frontier (-1 = never)
)

#: Per-edge fields (edge-ledger kernels only).
EDGE_FIELDS = (
    "edge_flow",           # (R, E) signed flow ledger (features summed)
    "edge_est",            # (R, E) estimate ledger: src's last-heard
    #                        view of dst (features summed)
    "edge_stale",          # (R, E) int32 rounds since last avg on edge
)

ALL_FIELDS = NODE_FIELDS + EDGE_FIELDS

DEFAULT_FIELDS = (
    "node_err", "node_mass", "node_mass_residual", "node_conv_round",
)

#: What each execution mode can record.  The node-collapsed kernels keep
#: no per-edge ledgers; the halo kernel's per-edge ledgers exist but its
#: reverse edges live on other shards (pairing stays a host-side job on
#: the gathered field).
SUPPORTED_FIELDS = {
    "edge": ALL_FIELDS,
    "halo": ALL_FIELDS,
    "node": NODE_FIELDS,
    "pod": NODE_FIELDS,
}

#: Kernels whose sampler can rank nodes globally on the device.
TOPK_KINDS = ("edge", "node")


def _suggest(name: str, vocabulary) -> str:
    import difflib

    close = difflib.get_close_matches(name, vocabulary, n=1)
    return f" (did you mean {close[0]!r}?)" if close else ""


@dataclasses.dataclass(frozen=True)
class FieldSpec:
    """Static field selection + downsampling knobs (hashable).

    ``stride`` — emit one field row every ``stride`` rounds (the rounds in
    between still run; only recording is skipped).  ``topk`` — keep only
    the ``topk`` worst nodes per row (0 = all; needs ``node_err`` as the
    ranking key).  ``tol`` — the convergence-frontier threshold for
    ``node_conv_round``.  ``strict=True`` (an explicit user list) makes
    :meth:`for_kernel` raise on fields the execution mode cannot record;
    the presets narrow silently, mirroring
    :class:`~flow_updating_tpu_torch.obs.telemetry.TelemetrySpec`."""

    fields: tuple = ()
    stride: int = 1
    topk: int = 0
    tol: float = 1e-6
    strict: bool = True

    def __post_init__(self):
        if self.stride < 1:
            raise ValueError(f"field stride must be >= 1 (got {self.stride})")
        if self.topk < 0:
            raise ValueError(f"field topk must be >= 0 (got {self.topk})")

    @property
    def enabled(self) -> bool:
        return bool(self.fields)

    def has(self, name: str) -> bool:
        return name in self.fields

    @property
    def node_series_fields(self) -> tuple:
        """Selected per-node fields that emit one row per recorded round
        (everything but the one-shot convergence frontier)."""
        return tuple(f for f in self.fields
                     if f in NODE_FIELDS and f != "node_conv_round")

    @property
    def edge_series_fields(self) -> tuple:
        return tuple(f for f in self.fields if f in EDGE_FIELDS)

    @classmethod
    def off(cls) -> FieldSpec:
        return cls(fields=())

    @classmethod
    def default(cls, stride: int = 1, topk: int = 0,
                tol: float = 1e-6) -> FieldSpec:
        return cls(fields=DEFAULT_FIELDS, stride=stride, topk=topk,
                   tol=tol, strict=False)

    @classmethod
    def full(cls, stride: int = 1, topk: int = 0,
             tol: float = 1e-6) -> FieldSpec:
        return cls(fields=ALL_FIELDS, stride=stride, topk=topk, tol=tol,
                   strict=False)

    @classmethod
    def parse(cls, text: str | None, stride: int = 1, topk: int = 0,
              tol: float = 1e-6) -> FieldSpec:
        """CLI surface: ``off`` / ``default`` / ``full`` / ``f1,f2,...``.
        Unknown names fail loudly with the valid vocabulary (and a
        closest-match hint) — a typo must never silently record
        nothing."""
        if text is None or text in ("", "off", "none"):
            return cls.off()
        if text in ("default", "on", "true", "1"):
            return cls.default(stride=stride, topk=topk, tol=tol)
        if text in ("full", "all"):
            return cls.full(stride=stride, topk=topk, tol=tol)
        names = tuple(f.strip() for f in text.split(",") if f.strip())
        unknown = [f for f in names if f not in ALL_FIELDS]
        if unknown:
            raise ValueError(
                f"unknown field(s) {unknown}{_suggest(unknown[0], ALL_FIELDS)}"
                f"; valid: {', '.join(ALL_FIELDS)} "
                "(or 'default'/'full'/'off')")
        return cls(fields=tuple(f for f in ALL_FIELDS if f in names),
                   stride=stride, topk=topk, tol=tol)

    def for_kernel(self, kind: str) -> FieldSpec:
        """Narrow to what ``kind`` can record (or raise, if strict), and
        validate the downsampling knobs against the mode."""
        try:
            sup = SUPPORTED_FIELDS[kind]
        except KeyError:
            raise ValueError(
                f"unknown kernel kind {kind!r}; have "
                f"{sorted(SUPPORTED_FIELDS)}") from None
        missing = [f for f in self.fields if f not in sup]
        if missing and self.strict:
            raise ValueError(
                f"field(s) {missing} are not recordable on the {kind!r} "
                f"kernel (supported: {', '.join(sup)})")
        fields = tuple(f for f in self.fields if f in sup)
        if self.topk:
            if kind not in TOPK_KINDS:
                raise ValueError(
                    f"topk downsampling needs a device-global node ranking "
                    f"and is limited to the {'/'.join(TOPK_KINDS)} kernels; "
                    f"the {kind!r} kernel supports stride downsampling "
                    "only")
            if "node_err" not in fields:
                raise ValueError(
                    "topk ranks nodes by |node_err|; add 'node_err' to "
                    "the field list")
        return dataclasses.replace(self, fields=fields)


class FieldSeries:
    """Host-side field bundle in ORIGINAL node/edge order.

    ``node``: ``{name: (R, N[, D])}`` (or ``(R, m[, D])`` under topk,
    with ``topk_idx`` ``(R, m)`` carrying the original node ids per row);
    ``edge``: ``{name: (R, E)}``; ``t``/``active``: ``(R,)``;
    ``conv_round``: ``(N,)`` or None.  ``edges`` (``{"src", "dst",
    "rev"}``) and ``coords`` (``(N, 2)``) travel along when available so
    offline consumers (blame, heatmaps) need no topology object."""

    def __init__(self, t=None, active=None, node=None, edge=None,
                 conv_round=None, topk_idx=None, spec: FieldSpec | None = None,
                 edges: dict | None = None, coords=None):
        self.t = np.asarray(t if t is not None else np.zeros((0,), np.int32))
        self.active = (np.asarray(active) if active is not None else None)
        self.node = {k: np.asarray(v) for k, v in (node or {}).items()}
        self.edge = {k: np.asarray(v) for k, v in (edge or {}).items()}
        self.conv_round = (np.asarray(conv_round)
                           if conv_round is not None else None)
        self.topk_idx = np.asarray(topk_idx) if topk_idx is not None else None
        self.spec = spec or FieldSpec.off()
        self.edges = ({k: np.asarray(v) for k, v in edges.items()}
                      if edges else None)
        self.coords = np.asarray(coords) if coords is not None else None

    @classmethod
    def empty(cls) -> FieldSeries:
        return cls()

    def __len__(self) -> int:
        return int(self.t.shape[0])

    def __bool__(self) -> bool:
        return len(self) > 0 or self.conv_round is not None

    @property
    def fields(self) -> tuple:
        out = tuple(self.node) + tuple(self.edge)
        if self.conv_round is not None:
            out = out + ("node_conv_round",)
        return out

    def __contains__(self, name: str) -> bool:
        return name in self.fields

    def __getitem__(self, name: str):
        if name == "node_conv_round":
            if self.conv_round is None:
                raise KeyError(name)
            return self.conv_round
        if name in self.node:
            return self.node[name]
        return self.edge[name]

    @property
    def num_nodes(self) -> int | None:
        if self.conv_round is not None:
            return int(self.conv_round.shape[0])
        for v in self.node.values():
            if self.topk_idx is None:
                return int(v.shape[1])
        return None

    def pooled(self, name: str) -> np.ndarray:
        """A field's per-entity magnitude with feature axes pooled
        (max |.|): ``(R, N)`` whatever the payload width."""
        v = np.asarray(self[name], dtype=np.float64)
        if v.ndim > 2:
            return np.max(np.abs(v), axis=tuple(range(2, v.ndim)))
        return np.abs(v)

    def reduced_series(self) -> dict | None:
        """The global telemetry series re-derived by reducing the fields
        (None under topk — partial rows cannot reproduce global sums).
        Keys follow :mod:`~flow_updating_tpu_torch.obs.telemetry` naming so
        the doctor's series checks run unchanged on field manifests."""
        if self.spec.topk or not len(self):
            return None
        out = {"t": self.t.tolist()}
        reduce_axes = lambda v: tuple(range(1, v.ndim))
        if "node_err" in self.node and self.active is not None:
            err = np.asarray(self.node["node_err"], np.float64)
            feat = int(err[0].size // err.shape[1]) if err.ndim > 1 else 1
            cnt = np.maximum(self.active.astype(np.float64), 1.0) * feat
            out["rmse"] = np.sqrt(
                np.sum(err * err, axis=reduce_axes(err)) / cnt).tolist()
            out["max_abs_err"] = np.max(
                np.abs(err), axis=reduce_axes(err)).tolist()
        if "node_mass" in self.node:
            out["mass"] = np.sum(self.node["node_mass"], axis=1).tolist()
        if "node_mass_residual" in self.node:
            out["mass_residual"] = np.sum(
                self.node["node_mass_residual"], axis=1).tolist()
        if self.active is not None:
            out["active"] = self.active.tolist()
        return out

    def summary(self) -> dict:
        """Compact digest for stdout (full fields belong in the
        manifest)."""
        out = {
            "rounds_recorded": len(self),
            "stride": self.spec.stride,
            "topk": self.spec.topk,
            "fields": list(self.fields),
        }
        if len(self) and "node_err" in self.node:
            mag = self.pooled("node_err")[-1]
            worst = int(np.argmax(mag))
            if self.topk_idx is not None:
                worst = int(self.topk_idx[-1][worst])
            out["final_worst_node"] = {
                "node": worst, "abs_err": float(np.max(mag))}
        if self.conv_round is not None:
            conv = self.conv_round
            done = conv[conv >= 0]
            out["convergence_frontier"] = {
                "converged_nodes": int(done.size),
                "nodes": int(conv.size),
                "first_round": int(done.min()) if done.size else None,
                "last_round": int(done.max()) if done.size else None,
            }
        return out

    def to_jsonable(self) -> dict:
        """The manifest ``fields`` block (see obs/report.py
        FIELD_SCHEMA)."""
        block = {
            "spec": {
                "fields": list(self.spec.fields),
                "stride": self.spec.stride,
                "topk": self.spec.topk,
                "tol": self.spec.tol,
            },
            "t": self.t.tolist(),
            "node": {k: v.tolist() for k, v in self.node.items()},
            "edge": {k: v.tolist() for k, v in self.edge.items()},
        }
        if self.active is not None:
            block["active"] = self.active.tolist()
        if self.conv_round is not None:
            block["conv_round"] = self.conv_round.tolist()
        if self.topk_idx is not None:
            block["topk_idx"] = self.topk_idx.tolist()
        if self.edges is not None:
            block["edges"] = {k: v.tolist() for k, v in self.edges.items()}
        if self.coords is not None:
            block["coords"] = self.coords.tolist()
        return block

    @classmethod
    def from_jsonable(cls, block: dict) -> FieldSeries:
        """Rebuild from a manifest ``fields`` block (inspect / doctor
        offline paths)."""
        sp = block.get("spec") or {}
        spec = FieldSpec(fields=tuple(sp.get("fields", ())),
                         stride=int(sp.get("stride", 1)),
                         topk=int(sp.get("topk", 0)),
                         tol=float(sp.get("tol", 1e-6)), strict=False)
        return cls(
            t=np.asarray(block.get("t", []), np.int64),
            active=(np.asarray(block["active"])
                    if block.get("active") is not None else None),
            node=block.get("node") or {},
            edge=block.get("edge") or {},
            conv_round=(np.asarray(block["conv_round"], np.int64)
                        if block.get("conv_round") is not None else None),
            topk_idx=(np.asarray(block["topk_idx"], np.int64)
                      if block.get("topk_idx") is not None else None),
            spec=spec,
            edges=block.get("edges"),
            coords=block.get("coords"),
        )
