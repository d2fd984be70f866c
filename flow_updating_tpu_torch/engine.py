"""Engine façade — the S4U-shaped simulation API over the round kernels.

Counterpart of ``flow_updating_tpu/engine.py``:
``Engine(argv, config)`` -> ``load_platform`` -> ``register_actor`` ->
``load_deployment`` -> ``build`` -> ``run_rounds`` / ``run_until`` (with
the watcher) -> ``estimates`` / ``convergence_report`` / ``global_values``.
The deployment resolves to a :class:`Topology`; ``kernel='edge'`` (the
default, the general per-edge round of ``models/rounds.py``) keeps a
:class:`~flow_updating_tpu_torch.models.state.FlowUpdatingState`,
``kernel='node'`` the node-collapsed
:class:`~flow_updating_tpu_torch.models.sync.NodeSyncState`.  Rounds run
on the engine's device — the CUDA card unless ``device='cpu'`` is given.

``mesh=`` (a :class:`~flow_updating_tpu_torch.parallel.mesh.Mesh`) with
``kernel='node'`` and ``spmv='banded_fused'`` runs the sharded banded round
(:class:`~flow_updating_tpu_torch.parallel.banded_sharded.
ShardedBandedKernel`): ``halo='ppermute'`` (the default) the serialized
exchange, any other ``halo`` the overlapped one, as in the JAX engine.
With ``spmv='benes_fused'`` it runs the node round with a Beneš network
per shard (:class:`~flow_updating_tpu_torch.parallel.spmv_sharded.
ShardedNodeKernel`, kernel B3 on each shard).  ``mesh=`` with
``multichip='pod'`` runs a fat tree's structured stencil sharded by pod
(:class:`~flow_updating_tpu_torch.parallel.structured_sharded.
PodShardedFatTreeKernel`; ``kernel='node'``, ``spmv='structured'``, the
shard count dividing k; ``halo`` 'overlap', 'overlap_pallas' or 'auto'
takes its overlap schedule).  ``mesh=`` with ``multichip='halo'`` runs
the edge kernel's halo round (:mod:`~flow_updating_tpu_torch.parallel.
sharded`): ``halo`` picks the cut-edge exchange ('ppermute', 'allgather',
'overlap', 'overlap_pallas' with kernel B6, or 'auto', ranked by
``plan.select.select_halo_mode`` and recorded in
:meth:`Engine.halo_report`), ``partition`` the node order ('bfs' or
'contiguous').

The edge kernel runs every config of the JAX engine's single-device edge
path, robust clip/trim (on the halo round too) and shared-link contention
(quasi-static, water-fill, backlog, ``RoundConfig.fidelity``) included;
contention sizes ``delay_depth`` by ``Topology.contended_max_delay`` and
is single-device, as in the JAX engine.

Faults and checkpoints (ROADMAP A7): ``kill_nodes``/``revive_nodes`` and
``fail_links``/``restore_links`` edit the single-device edge state's
masks (the node kernel refuses them, the halo round raises, as in the
JAX engine); ``save_checkpoint``/``restore_checkpoint`` write and read
the JAX package's archive (:mod:`~flow_updating_tpu_torch.utils.
checkpoint`) on the edge round, the node round (every ``spmv`` route),
the sharded banded and Beneš rounds and the halo and pod rounds, whose
states are gathered to the canonical single-device layout, so their
archives resume on any mode.  The structured route runs virtual fat trees
(``fat_tree(k, materialize_edges=False)``), which have no edge arrays.

What the JAX engine does beyond that raises ``NotImplementedError``
naming its ROADMAP item: GSPMD's mesh paths, ``plan='auto'``,
``host_actors``, ``adversary``, custom actors, event logs and the edge
kernel's streamed runner.

Simulated-time convention: one round == ``TICK_INTERVAL`` (1.0) simulated
seconds, the reference peers' loop cadence.
"""

from __future__ import annotations

import dataclasses
import logging
import typing
from collections.abc import Callable

import numpy as np
import torch

from flow_updating_tpu_torch.models import rounds
from flow_updating_tpu_torch.models.config import RoundConfig
from flow_updating_tpu_torch.models.state import init_state, state_from_numpy
from flow_updating_tpu_torch.models.sync import NodeKernel, _node_sample
from flow_updating_tpu_torch.parallel.mesh import Mesh
from flow_updating_tpu_torch.topology.deployment import (
    Deployment,
    load_deployment,
)
from flow_updating_tpu_torch.topology.graph import Topology
from flow_updating_tpu_torch.topology.platform import Platform, load_platform
from flow_updating_tpu_torch.utils.device import resolve_device
from flow_updating_tpu_torch.utils.metrics import (
    mass_residual,
    observer_sample,
    rmse,
)

logger = logging.getLogger("flow_updating_tpu_torch.engine")

TICK_INTERVAL = 1.0  # simulated seconds per round
HALO_MODES = ("ppermute", "allgather", "overlap", "overlap_pallas", "auto")


def _log_stream_sample(m: dict) -> None:
    logger.info(
        "[%d] rmse=%.3e max_err=%.3e mass=%.6g fired=%d",
        m["t"], m["rmse"], m["max_abs_err"], m["mass"], m["fired_total"],
    )


class _NetzoneShim:
    """``e.netzone_root.add_host(name, speed)`` (reference
    ``flowupdating-collectall.py:159``).  Hosts added here that never
    receive a peer simply don't join the gossip graph."""

    def __init__(self, engine: Engine):
        self._engine = engine

    def add_host(self, name: str, speed: float):
        if self._engine.platform is None:
            self._engine.platform = Platform(hosts={}, links={}, routes={})
        self._engine.platform = self._engine.platform.add_host(name, speed)
        return name


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is the ROADMAP item '{item}', not ported yet")


class Engine:
    """Driver for one aggregation run on one device or one mesh."""

    def __init__(self, argv=None, config: RoundConfig | None = None,
                 mesh=None, multichip: str = "auto",
                 halo: str = "ppermute", partition: str = "bfs",
                 host_actors: bool = False, event_log=None,
                 plan="off", adversary=None, device=None):
        # the argument list mirrors the JAX Engine so call sites carry
        # over; what this package does not run yet is refused up front
        if multichip not in ("auto", "halo", "pod"):
            raise ValueError(f"unknown multichip mode {multichip!r}")
        if halo not in HALO_MODES:
            raise ValueError(
                f"unknown halo mode {halo!r}: use 'ppermute', "
                "'allgather', 'overlap', 'overlap_pallas', or 'auto'")
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(
                "mesh= takes a flow_updating_tpu_torch.parallel.mesh.Mesh "
                f"(make_mesh), got {type(mesh).__name__}")
        if plan not in ("off", None):
            raise _not_ported(f"plan={plan!r}",
                              "plan='auto' with the H100 cost model (A5)")
        if host_actors:
            raise _not_ported("host_actors=True", "host actors (A8)")
        if adversary is not None:
            raise _not_ported("adversary=", "sweep and scenarios (A10)")
        if event_log is not None:
            raise _not_ported("event_log=",
                              "observability twins and manifests (A9)")
        self.argv = list(argv) if argv else []
        self.config = self._apply_argv_cfg(config or RoundConfig.fast())
        self.device = resolve_device(device)
        if mesh is not None and mesh.device_type != self.device.type:
            raise ValueError(
                f"the mesh's shards are on {mesh.device_type} but the "
                f"engine runs on {self.device}; build the mesh with "
                f"make_mesh(n, device={self.device.type!r})")
        self.mesh = mesh
        self.multichip = multichip
        self.halo = halo
        self.partition = partition
        self._halo_plan = None
        self._halo_arrays = None
        self._halo_resolved = None  # halo='auto' resolution (set at build)
        self.halo_decision = None   # select_halo_mode evidence when 'auto'
        self.platform: Platform | None = None
        self.deployment: Deployment | None = None
        self.topology: Topology | None = None
        self.state = None
        self._node_kernel: NodeKernel | None = None
        self._topo_arrays = None
        self._registered: dict = {}
        self._watchers: list = []
        self._clock = 0.0
        self._killed = False
        self.netzone_root = _NetzoneShim(self)

    def _apply_argv_cfg(self, cfg: RoundConfig) -> RoundConfig:
        """Consume SimGrid-style ``--cfg=key:value`` flags from argv: every
        RoundConfig field is addressable by name (dashes accepted for
        underscores), values parse to the field's type and RoundConfig
        re-validates.  SimGrid's own slash-form keys are logged and
        skipped; a mistyped bare key raises."""
        hints = typing.get_type_hints(RoundConfig)
        overrides = {}
        for arg in self.argv:
            if not (isinstance(arg, str) and arg.startswith("--cfg=")):
                continue
            key, sep, val = arg[len("--cfg="):].partition(":")
            key = key.strip()
            if "/" in key:
                logger.warning(
                    "--cfg=%s: SimGrid engine key has no equivalent on "
                    "this runtime; ignored", key)
                continue
            key = key.replace("-", "_")
            if not sep and key in hints:
                raise ValueError(
                    f"--cfg={key}: missing ':' separator "
                    f"(format --cfg={key}:value)")
            if key not in hints:
                raise ValueError(
                    f"--cfg={key!r}: unknown config key (valid: "
                    f"{', '.join(sorted(hints))}; format "
                    "--cfg=key:value)")
            ftype = hints[key]
            if ftype is bool:
                low = val.strip().lower()
                if low in ("1", "true", "yes", "on"):
                    overrides[key] = True
                elif low in ("0", "false", "no", "off"):
                    overrides[key] = False
                else:
                    raise ValueError(
                        f"--cfg={key}:{val!r}: not a boolean "
                        "(use true/false, yes/no, on/off, 1/0)")
            elif ftype in (int, float):
                try:
                    overrides[key] = ftype(val)
                except ValueError:
                    raise ValueError(
                        f"--cfg={key}:{val}: not a valid "
                        f"{ftype.__name__} value") from None
            else:
                overrides[key] = val.strip()
        return dataclasses.replace(cfg, **overrides) if overrides else cfg

    # ---- the halo kernel ---------------------------------------------------
    @property
    def _halo_mode(self) -> bool:
        return self.mesh is not None and self.multichip == "halo"

    @property
    def _pod_mode(self) -> bool:
        return self.mesh is not None and self.multichip == "pod"

    @property
    def _ledger_dtype_bytes(self) -> int:
        """Bytes per ledger element on the halo wire — shared by the
        halo='auto' ranking and halo_report()'s evidence."""
        return 8 if self.config.dtype == "float64" else 4

    @property
    def _halo_wire(self) -> str:
        """The exchange the halo kernel dispatches with (``halo='auto'``
        resolves at build; before it, the serialized default)."""
        if self._halo_resolved is not None:
            return self._halo_resolved
        return "ppermute" if self.halo == "auto" else self.halo

    def halo_report(self) -> dict | None:
        """The halo exchange decision: requested and resolved modes, the
        schedule the rounds execute (``'overlap'`` may resolve to
        ``'overlap_full'`` on fat frontiers), the plan's wire bytes, and
        ``select_halo_mode``'s evidence when 'auto' chose.  None off the
        halo path."""
        if not self._halo_mode or self._halo_plan is None:
            return None
        from flow_updating_tpu_torch.parallel import overlap

        out = {"requested": self.halo, "resolved": self._halo_wire,
               "schedule": overlap.resolve_mode(self._halo_plan,
                                                self._halo_wire),
               "partition": self.partition,
               **self._halo_plan.collective_bytes_per_round(
                   self._ledger_dtype_bytes)}
        if self.halo_decision is not None:
            out["decision"] = self.halo_decision
        return out

    def _prepare_halo(self, latency_scale: float) -> None:
        """The halo kernel's plan and device tables (no state)."""
        from flow_updating_tpu_torch.parallel import sharded

        if self.config.kernel == "node":
            raise ValueError(
                "multichip='halo' drives the edge kernel (per-edge state "
                "partitioned by source shard); the node kernel "
                "distributes via the sharded banded round — use "
                "multichip='auto'")
        if latency_scale > 0.0 or self.config.contention:
            raise NotImplementedError(
                "the halo kernel runs unit-delay/static-delay rounds; "
                "latency-warped + contention fidelity runs are "
                "single-device (platform-scale)")
        self._halo_plan = sharded.plan_sharding(
            self.topology, self.mesh.size, partition=self.partition,
            coloring=self.config.needs_coloring)
        if self.halo == "auto":
            from flow_updating_tpu_torch.plan.select import select_halo_mode

            self.halo_decision = select_halo_mode(
                self._halo_plan, backend=self.device.type,
                dtype_bytes=self._ledger_dtype_bytes)
            self._halo_resolved = self.halo_decision["halo"]
            logger.info("halo auto: %s", self.halo_decision["reason"])
        else:
            self._halo_resolved = self.halo
        self._halo_arrays = sharded.plan_device_arrays(
            self._halo_plan, self.mesh, halo=self._halo_resolved)

    # ---- setup -----------------------------------------------------------
    @property
    def clock(self) -> float:
        return self._clock

    def load_platform(self, path: str) -> Engine:
        self.platform = load_platform(path)
        return self

    def register_actor(self, name: str, fn=None) -> Engine:
        """Register a deployable actor.  ``fn=None`` selects the built-in
        gossip protocol (the reference's ``register_actor("peer", Peer)``
        maps to this plus config); custom actors are a later item."""
        if fn is not None:
            raise _not_ported(f"register_actor({name!r}, <custom actor>)",
                              "host actors (A8)")
        self._registered[name] = fn
        return self

    def load_deployment(self, path: str,
                        function: str | None = None) -> Engine:
        if function is None and len(self._registered) == 1:
            function = next(iter(self._registered))
        self.deployment = load_deployment(path, function=function)
        return self

    def set_topology(self, topo: Topology) -> Engine:
        self.topology = topo
        return self

    def _resolve_topology(self, latency_scale: float = 0.0) -> None:
        if self.topology is None:
            if self.deployment is None:
                raise RuntimeError("no deployment loaded and no topology set")
            self.topology = self.deployment.to_topology(
                platform=self.platform,
                tick_interval=TICK_INTERVAL,
                latency_scale=latency_scale,
            )

    def _prepare_arrays(self, latency_scale: float = 0.0) -> None:
        """The configured kernel and its device tables, without a state
        (``build`` adds a fresh one, ``restore_checkpoint`` a restored
        one)."""
        if self._halo_mode:
            self._prepare_halo(latency_scale)
            return
        if self.config.kernel == "node":
            if latency_scale > 0.0 or self.topology.max_delay > 1:
                raise ValueError(
                    "latency-warped rounds need per-edge delivery state; "
                    "the node-collapsed kernel is unit-delay only — use "
                    "kernel='edge' with latency_scale")
            if self._pod_mode:
                from flow_updating_tpu_torch.parallel.structured_sharded \
                    import PodShardedFatTreeKernel

                if self.config.spmv != "structured":
                    raise ValueError(
                        "multichip='pod' runs the pod-sharded stencil; it "
                        "requires spmv='structured'")
                # the overlap schedule is the same math reordered: taken
                # whenever overlap is asked for or left to 'auto'
                self._node_kernel = PodShardedFatTreeKernel(
                    self.topology, self.config, self.mesh,
                    overlap=self.halo in ("overlap", "overlap_pallas",
                                          "auto"), device=self.device)
            elif self.mesh is not None and \
                    self.config.spmv == "benes_fused":
                from flow_updating_tpu_torch.parallel.spmv_sharded import (
                    ShardedNodeKernel,
                )

                self._node_kernel = ShardedNodeKernel(
                    self.topology, self.config, self.mesh,
                    device=self.device)
            elif self.mesh is not None and \
                    self.config.spmv == "banded_fused":
                from flow_updating_tpu_torch.parallel.banded_sharded import (
                    ShardedBandedKernel,
                )

                # halo='ppermute' keeps the serialized schedule; every other
                # wire setting overlaps the copies with the interior merge
                self._node_kernel = ShardedBandedKernel(
                    self.topology, self.config, self.mesh,
                    exchange="ppermute" if self.halo == "ppermute"
                    else "pallas", device=self.device)
            else:
                self._node_kernel = NodeKernel(self.topology, self.config,
                                               device=self.device,
                                               mesh=self.mesh)
            return
        if self._pod_mode:
            raise ValueError(
                "multichip='pod' drives the node kernel (kernel='node', "
                "spmv='structured')")
        if latency_scale > 0.0:
            depth = max(self.config.delay_depth, self.topology.max_delay)
            if depth != self.config.delay_depth:
                self.config = dataclasses.replace(self.config,
                                                  delay_depth=depth)
        if self.config.contention:
            self._size_contention()
        if self.mesh is not None:
            raise _not_ported(
                "the edge kernel over a mesh with multichip='auto'",
                "multi-device execution: GSPMD's edge path (A12); "
                "multichip='halo' runs the halo edge kernel")
        cfg = self.config
        self._topo_arrays = self.topology.device_arrays(
            coloring=cfg.needs_coloring,
            segment_ell=cfg.use_segment_ell,
            segment_benes=cfg.segment_benes_mode,
            delivery_benes=cfg.delivery_benes_mode,
            device=self.device)

    def build(self, latency_scale: float = 0.0, seed: int = 0) -> Engine:
        """Resolve deployment(+platform) into topology + kernel + fresh
        state.  ``seed`` keys the edge kernel's message-loss draws."""
        self._resolve_topology(latency_scale)
        self._prepare_arrays(latency_scale)
        if self._halo_mode:
            from flow_updating_tpu_torch.parallel import sharded

            self.state = sharded.init_plan_state(
                self._halo_plan, self.config, self.mesh, seed=seed)
        elif self.config.kernel == "node":
            self.state = self._node_kernel.init_state()
        else:
            self.state = init_state(self.topology, self.config, seed=seed,
                                    device=self.device)
        return self

    def _size_contention(self) -> None:
        """Refuse contention without a link model or on a mesh, and size
        ``delay_depth`` to cover the worst contended delay (else the
        clamp flattens contention back to the static profile)."""
        if not self.topology.has_link_model:
            raise ValueError(
                "contention=True needs a platform-loaded topology with a "
                "link model and a positive latency scale — pass --platform "
                "with --latency-scale > 0 on the CLI (generators have no "
                "links)")
        if self.mesh is not None:
            raise NotImplementedError(
                "contention is single-device (the per-round link flow "
                "count is a global reduction; fidelity runs are "
                "platform-scale)")
        base = self.topology.contended_max_delay()
        depth = max(self.config.delay_depth, base)
        if self.config.contention_backlog:
            # up to D standing messages per edge add load, which grows D:
            # the smallest self-consistent depth, saturated at 4x the
            # senders-only bound (no fixed point under overload; beyond
            # it the clamp is the model's queue-capacity limit)
            cap = max(4 * base, depth)
            for _ in range(16):
                nxt = min(cap, max(depth, self.topology.contended_max_delay(
                    inflight_per_edge=depth)))
                if nxt == depth:
                    break
                depth = nxt
        if depth != self.config.delay_depth:
            self.config = dataclasses.replace(self.config, delay_depth=depth)

    # ---- observability ---------------------------------------------------
    def add_watcher(self, run_until: float = 1000.0,
                    time_interval: float = 10.0,
                    callback: Callable | None = None) -> Engine:
        """The reference's watcher actor (``collectall.py:139-148``):
        sample global state every ``time_interval`` simulated seconds, and
        at ``run_until`` stop all peers.  A watcher whose deadline lies in
        the future revives a previously stopped run."""
        if self._killed and float(run_until) > self._clock:
            logger.info("[%0.1f] watcher: reviving peers (new deadline "
                        "%.1f)", self._clock, float(run_until))
            self._killed = False
            self._watchers = [
                w for w in self._watchers if w["until"] > self._clock
            ]
        self._watchers.append({"until": float(run_until),
                               "every": float(time_interval),
                               "callback": callback})
        return self

    def global_values(self) -> dict:
        """The reference's ``global_values`` mirror: per-host value and
        last_avg keyed by host name (``collectall.py:47-63,131``)."""
        if self.state is None:
            return {}
        names = self.topology.names or tuple(
            str(i) for i in range(self.topology.num_nodes))
        if self._halo_mode:
            from flow_updating_tpu_torch.parallel import sharded

            value = self.topology.values
            last_avg = sharded.gather_node_array(
                [st.last_avg for st in self.state.shards], self._halo_plan)
        elif self.config.kernel == "node":
            value = self.topology.values
            last_avg = self._node_kernel.last_avg(self.state)
        else:
            value = self.state.value.cpu().numpy()
            last_avg = self.state.last_avg.cpu().numpy()
        return {
            "value": dict(zip(names, value.tolist())),
            "last_avg": dict(zip(names, last_avg.tolist())),
        }

    def estimates(self) -> np.ndarray:
        if self.state is None:
            raise RuntimeError("engine not built")
        if self._halo_mode:
            from flow_updating_tpu_torch.parallel import sharded

            return sharded.gather_estimates(self.state, self._halo_plan)
        if self.config.kernel == "node":
            return self._node_kernel.estimates(self.state)
        return rounds.node_estimates(self.state,
                                     self._topo_arrays).cpu().numpy()

    def convergence_report(self) -> dict:
        """Convergence + invariant metrics for the current state (the edge
        kernel adds the flow antisymmetry residual)."""
        est = self.estimates()
        mean = self.topology.true_mean
        report = {
            "t": int(self.state.t),
            "rmse": rmse(est, mean),
            "max_abs_err": float(np.max(np.abs(est - mean))),
            "mass_residual": mass_residual(est, self.topology.values),
        }
        if self._halo_mode:
            # edge flows live in per-shard slots; pair them through the
            # plan's reverse routing (tshard/tlocal), across shards too
            pl = self._halo_plan
            flow = np.stack([st.flow.cpu().numpy()
                             for st in self.state.shards])
            ts, tl = pl.arrays.tshard, pl.arrays.tlocal
            real = tl < pl.Eb
            report["antisymmetry_residual"] = float(
                np.max(np.abs(flow[real] + flow[ts[real], tl[real]])))
        elif self.config.kernel == "edge":
            flow = self.state.flow.cpu().numpy()
            report["antisymmetry_residual"] = float(
                np.max(np.abs(flow + flow[self.topology.rev])))
        return report

    # ---- fault injection -------------------------------------------------
    def _require_edge_kernel(self, what: str) -> None:
        if self.config.kernel != "edge":
            raise ValueError(
                f"{what} needs per-edge state; the node-collapsed kernel is "
                "exactly the fault-free fast path — use kernel='edge'")
        if self._halo_mode:
            # the per-shard layout does not take global node/edge ids
            raise NotImplementedError(
                f"{what} is not supported on the halo kernel's blocked "
                "layout yet — run fault-injection single-device")
        if self.state is None:
            raise RuntimeError("engine not built")

    def _node_ids(self, nodes) -> np.ndarray:
        name_to_id = None
        ids = []
        for n in nodes:
            if isinstance(n, str):
                if name_to_id is None:
                    name_to_id = self.topology.name_to_id()
                ids.append(name_to_id[n])
            else:
                ids.append(int(n))
        return np.asarray(ids, dtype=np.int32)

    def kill_nodes(self, nodes) -> Engine:
        """Crash-stop the given nodes (ids or host names): they stop
        firing, sending and processing.  Delivered-but-undrained messages
        stay queued and are processed on revival — the protocol's
        idempotent state exchange makes the sequence self-healing.  The
        mask edit is the shared churn primitive (service/membership.py)."""
        from flow_updating_tpu_torch.service import membership

        self._require_edge_kernel("kill_nodes")
        self.state = membership.set_alive(
            self.state, self._node_ids(nodes), False)
        return self

    def revive_nodes(self, nodes) -> Engine:
        from flow_updating_tpu_torch.service import membership

        self._require_edge_kernel("revive_nodes")
        self.state = membership.set_alive(
            self.state, self._node_ids(nodes), True)
        return self

    def _edge_ids(self, links) -> np.ndarray:
        """Directed edge indices for (u, v) node pairs, both directions."""
        topo = self.topology
        topo._require_edges("fail_links/heal_links (edge lookup)")
        keys = topo.src.astype(np.int64) * topo.num_nodes + topo.dst
        ids = []
        for u, v in links:
            u, v = (int(x) for x in self._node_ids([u, v]))
            for a, b in ((u, v), (v, u)):
                key = a * topo.num_nodes + b  # Python ints: no int32 wrap
                e = int(np.searchsorted(keys, key))
                if e >= len(keys) or int(keys[e]) != key:
                    raise ValueError(f"no edge {a}->{b} in topology")
                ids.append(e)
        return np.asarray(ids, dtype=np.int64)

    def _set_edge_ok(self, links, ok: bool) -> None:
        ids = self._edge_ids(links)
        mask = self.state.edge_ok
        self.state = self.state.replace(edge_ok=mask.index_put(
            (torch.from_numpy(ids).to(mask.device),),
            torch.tensor(ok, device=mask.device)))

    def fail_links(self, links) -> Engine:
        """Fail the given undirected links (pairs of node ids or names):
        every message put on them is lost, in both directions, until
        :meth:`restore_links`.  Senders' ledgers still update — the exact
        semantics of a lost ``put_async``; fast pairwise never matches
        them."""
        self._require_edge_kernel("fail_links")
        self._set_edge_ok(links, False)
        return self

    def restore_links(self, links) -> Engine:
        self._require_edge_kernel("restore_links")
        self._set_edge_ok(links, True)
        return self

    # ---- checkpoint / resume ---------------------------------------------
    def save_checkpoint(self, path: str) -> Engine:
        """Write the full run state + config + topology fingerprint to
        ``path`` in the JAX package's archive layout, with the simulated
        clock and the watcher's stop (``extra``).  A halo or pod state is
        gathered to the canonical single-device layout first, so its
        archive restores on any execution mode."""
        from flow_updating_tpu_torch.utils.checkpoint import save_checkpoint

        if self.state is None:
            raise RuntimeError("engine not built — nothing to checkpoint")
        state = self.state
        if self._halo_mode:
            from flow_updating_tpu_torch.parallel import sharded

            state = sharded.gather_full_state(state, self._halo_plan,
                                              self.topology)
        elif self._pod_mode:
            state = self._node_kernel.to_canonical(state)
        save_checkpoint(path, state, self.config, topo=self.topology,
                        extra={"clock": self._clock,
                               "killed": self._killed})
        return self

    def restore_checkpoint(self, path: str) -> Engine:
        """Resume from a checkpoint taken on the *same* topology (checked
        by its content fingerprint): state, config and clock.  ``build()``
        is not needed first, and no fresh state is made: the kernel's
        tables are prepared under the archive's config, which governs the
        run, and the archive's leaves go straight to the engine's device
        (a halo or pod engine scatters the canonical state over its
        shards)."""
        from flow_updating_tpu_torch.utils.checkpoint import read_checkpoint

        self._resolve_topology()
        cls_name, fields, cfg, extra = read_checkpoint(path,
                                                       topo=self.topology)
        want = "NodeSyncState" if cfg.kernel == "node" \
            else "FlowUpdatingState"
        if cls_name != want:
            raise ValueError(
                f"checkpoint {path} holds a {cls_name} but its config "
                f"runs kernel={cfg.kernel!r} (corrupt archive?)")
        self.config = cfg
        self._prepare_arrays()
        if self._halo_mode:
            from flow_updating_tpu_torch.parallel import sharded

            state = sharded.scatter_full_state(
                fields, self._halo_plan, self.topology, cfg, self.mesh)
        elif cfg.kernel == "node":
            state = self._restore_node_state(fields)
        else:
            got = fields["value"].shape[0]
            if got != self.topology.num_nodes:
                raise ValueError(
                    f"checkpoint state has node axis {got} but this "
                    "engine's layout expects "
                    f"{self.topology.num_nodes} — restore with the same "
                    "mesh/padding it was saved under")
            state = state_from_numpy(fields, device=self.device)
        self.state = state
        t = int(np.asarray(fields["t"]).ravel()[0])
        self._clock = float(extra.get("clock", float(t)))
        self._killed = bool(extra.get("killed", False))
        return self

    def _restore_node_state(self, fields: dict):
        """A node state from the archive's leaves, after JAX's two checks:
        the node-axis size (padded slots), then the layout — a sharded
        ``(S, M/S)`` state is NOT interchangeable with the single-device
        ``(M,)`` layout even when the slot count matches."""
        kernel = self._node_kernel
        shape = kernel.state_shape
        got = fields["S"].size
        expect = int(np.prod(shape, dtype=np.int64))
        if got != expect:
            raise ValueError(
                f"checkpoint state has node axis {got} but this engine's "
                f"layout expects {expect} — restore with the same "
                "mesh/padding it was saved under")
        if fields["S"].shape != shape:
            raise ValueError(
                f"checkpoint node state has shape {fields['S'].shape} but "
                f"this engine's kernel uses {shape} — the sharded fused "
                "kernel's interleaved layout is not interchangeable with "
                "the single-device layout; restore under the "
                "configuration it was saved with")
        return kernel.state_from_numpy(fields)

    # ---- execution -------------------------------------------------------
    def _advance(self, n: int) -> None:
        if self._halo_mode:
            from flow_updating_tpu_torch.parallel import sharded

            self.state = sharded.run_rounds_sharded(
                self.state, self._halo_plan, self.config, self.mesh, n,
                arrays=self._halo_arrays, halo=self._halo_wire)
        elif self.config.kernel == "node":
            self.state = self._node_kernel.run(self.state, n)
        else:
            self.state = rounds.run_rounds(self.state, self._topo_arrays,
                                           self.config, n)

    def run_rounds(self, n: int) -> Engine:
        if self.state is None:
            self.build()
        if not self._killed and n > 0:
            self._advance(n)
        self._clock += n * TICK_INTERVAL
        return self

    def run_until_rmse(self, threshold: float, max_rounds: int = 100_000,
                       chunk: int = 64) -> dict:
        """Advance in ``chunk``-round steps until the estimate RMSE vs the
        true mean is at or below ``threshold``.  Returns ``{"rounds",
        "t", "rmse", "converged"}`` (``rounds`` executed by this call)."""
        if threshold <= 0:
            raise ValueError("threshold must be positive")
        if chunk <= 0:
            raise ValueError("chunk must be positive")
        if max_rounds < 0:
            raise ValueError("max_rounds must be >= 0")
        if self.state is None:
            self.build()

        mean = self.topology.true_mean
        done = 0
        now = rmse(self.estimates(), mean)
        while now > threshold and done < max_rounds and not self._killed:
            take = min(int(chunk), max_rounds - done)
            self.run_rounds(take)
            done += take
            now = rmse(self.estimates(), mean)
        return {"rounds": done, "t": int(self.state.t), "rmse": now,
                "converged": now <= threshold}

    def run_streamed(self, n: int, observe_every: int = 10,
                     emit=None) -> Engine:
        """Run ``n`` rounds, emitting a watcher sample every
        ``observe_every`` rounds (host-chunked: the samples are read
        between chunks).  ``emit(metrics_dict)`` defaults to an INFO log
        line."""
        if n % observe_every:
            raise ValueError("num_rounds must be a multiple of observe_every")
        if self.config.kernel == "edge":
            raise _not_ported("run_streamed on the edge kernel",
                              "observability twins and manifests (A9)")
        if self.state is None:
            self.build()
        emit = emit or _log_stream_sample
        if self.mesh is not None:
            if not self._killed and n > 0:
                self.state = self._node_kernel.run_streamed(
                    self.state, n, observe_every, emit)
            self._clock += n * TICK_INTERVAL
            return self
        mean = self.topology.true_mean
        for _ in range(n // observe_every if not self._killed else 0):
            self._advance(observe_every)
            t, rmse_v, max_err, mass, cnt = _node_sample(
                self.state, self._node_kernel.arrays, mean)
            # every communicating node fires every round in fast mode
            emit(observer_sample(t, rmse_v, max_err, mass, t * cnt))
        self._clock += n * TICK_INTERVAL
        return self

    def run_until(self, t_end: float) -> Engine:
        """Advance simulated time to ``t_end``, honoring watchers: chunks
        of rounds between sampling points, callbacks at each sample, and a
        hard stop of peer execution at a watcher's ``until`` (after which
        the clock still advances to ``t_end``)."""
        if self.state is None:
            self.build()
        events = sorted(
            {w["until"] for w in self._watchers}
            | {
                t
                for w in self._watchers
                for t in np.arange(self._clock + w["every"],
                                   min(w["until"], t_end) + 1e-9, w["every"])
            }
            | {float(t_end)}
        )
        for t_ev in events:
            if t_ev > t_end:
                break
            n = int(round((t_ev - self._clock) / TICK_INTERVAL))
            if n > 0 and not self._killed:
                self._advance(n)
            self._clock = t_ev
            for w in self._watchers:
                hit_sample = (
                    t_ev <= w["until"]
                    and abs(t_ev - round(t_ev / w["every"]) * w["every"])
                    < 1e-9
                )
                if hit_sample:
                    if w["callback"] is not None:
                        w["callback"](self)
                    else:
                        for key, vals in self.global_values().items():
                            logger.info("[%0.1f] %s%s", self._clock, key,
                                        vals)
                if t_ev >= w["until"] and not self._killed:
                    logger.info("[%0.1f] watcher: stopping every peer.",
                                self._clock)
                    self._killed = True
        self._clock = float(t_end)
        return self
