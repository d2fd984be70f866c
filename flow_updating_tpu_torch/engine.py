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

``plan='auto'`` (ROADMAP A5) picks the fastest correct kernel/spmv for the
resolved topology on the engine's device
(:func:`~flow_updating_tpu_torch.plan.select.select_plan`: the analytic
model with the H100's gather penalty, the banded family raced on the
device above 4,096 nodes through the autotune cache); an
:class:`~flow_updating_tpu_torch.plan.compile.ExecutionPlan` or a
:class:`~flow_updating_tpu_torch.plan.select.PlanDecision` is used as
given.  Only the implementation changes, never the dynamics;
:meth:`Engine.plan_report` records the decision.

Observability (ROADMAP A9 parts 1 and 2): :meth:`run_telemetry` (global
series) and :meth:`run_fields` (per-node and per-edge fields in original
node and edge order) on the edge, node, halo and pod kernels, both
device-resident with one bulk copy at the end; ``event_log=``
(``advance`` and ``kill_all`` records), and :meth:`run_streamed` on every
kernel.

``adversary=`` (a :class:`~flow_updating_tpu_torch.scenarios.adversary.
Adversary`, ROADMAP A10) plants lies, silent senders, a scheduled link cut
or a scaled wire flow on the single-device edge round's messages, with
every ``segment_impl`` and ``delivery`` (the masks ride the planned
networks like every other broadcast); a mesh, the node kernel and fast
pairwise refuse it with the JAX engine's messages.

Custom actors (ROADMAP A8): ``register_actor(name, VectorActor)`` runs
a population-wide tensor protocol through
:class:`~flow_updating_tpu_torch.models.actor.ActorKernel` on the engine's
device (its in-edge sums through kernel K1 on the card), with actor
checkpoints; ``Engine(host_actors=True)`` runs ANY Python callable on the
host DES of :mod:`~flow_updating_tpu_torch.s4u` (reference semantics, host
speed), spawned at ``load_deployment`` and driven by ``run_until``.

What the JAX engine does beyond that raises ``NotImplementedError``
naming its ROADMAP item: GSPMD's mesh paths.

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


def _shutdown_des(des) -> None:
    """Finalizer of a host_actors engine: join its actor threads and
    retire its DES as the active runtime."""
    from flow_updating_tpu_torch import s4u

    des.shutdown()
    if s4u._CURRENT_DES is des:
        s4u._CURRENT_DES = None


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
        if host_actors and mesh is not None:
            raise ValueError(
                "host_actors=True runs Python bytecode on the host; it "
                "cannot shard over a device mesh — drop mesh=, or "
                "express the protocol as a VectorActor")
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
        if isinstance(plan, str):
            if plan not in ("off", "auto"):
                raise ValueError(
                    f"unknown plan mode {plan!r}: use 'off', 'auto', or "
                    "pass a compiled flow_updating_tpu_torch.plan "
                    "ExecutionPlan / PlanDecision")
        elif plan is not None:
            from flow_updating_tpu_torch.plan import ExecutionPlan
            from flow_updating_tpu_torch.plan.select import PlanDecision

            if not isinstance(plan, (ExecutionPlan, PlanDecision)):
                # a dict/describe() output/bool must not silently run
                # auto-selection in place of the caller's intended plan
                raise TypeError(
                    f"plan= takes 'off', 'auto', an ExecutionPlan or a "
                    f"PlanDecision; got {type(plan).__name__}")
        self.argv = list(argv) if argv else []
        self.config = self._apply_argv_cfg(config or RoundConfig.fast())
        self.device = resolve_device(device)
        if mesh is not None and mesh.device_type != self.device.type:
            raise ValueError(
                f"the mesh's shards are on {mesh.device_type} but the "
                f"engine runs on {self.device}; build the mesh with "
                f"make_mesh(n, device={self.device.type!r})")
        self.mesh = mesh
        # a scenarios.Adversary planted on the single-device edge round's
        # wire (an empty one plants nothing)
        self.adversary = adversary or None
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
        self.plan_spec = plan
        self.plan_decision = None   # PlanDecision once build() resolved it
        self._plan = None           # ExecutionPlan handed to the NodeKernel
        self._fused_kw = None       # the fused round's tile / remainder
        #                             route (autotuned or defaults)
        self.netzone_root = _NetzoneShim(self)
        # optional EventLog sink for engine lifecycle records ("advance"
        # dispatches, "kill_all")
        self.event_log = event_log
        # wall-time split of the last run_telemetry call (run manifests
        # record it); compile_s is None: nothing is compiled
        self.telemetry_timings: dict = {}
        # the same for the last run_fields call, with the recorded bytes
        # and the final copy's share
        self.field_timings: dict = {}
        # host-fidelity mode: arbitrary Python actors on the s4u host DES
        # (flow_updating_tpu_torch.s4u) instead of tensor kernels — the
        # explicit opt-in for the reference's register_actor(<any class>)
        self.host_actors = bool(host_actors)
        self._hostdes = None
        # wall time of the last build() (plan, tables, networks, state):
        # a profile record's lower_s
        self._build_s = None

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
        return self.mesh is not None and self.multichip == "halo" \
            and self._custom_actor is None

    @property
    def _pod_mode(self) -> bool:
        return self.mesh is not None and self.multichip == "pod" \
            and self._custom_actor is None

    @property
    def _node_like(self) -> bool:
        """Dispatch through the node-kernel interface (the built-in
        node-collapsed kernel, or an ActorKernel driving a VectorActor)."""
        return self.config.kernel == "node" or self._custom_actor is not None

    @property
    def _kernel_kind(self) -> str:
        """'edge', 'node', 'halo' or 'pod' — the key telemetry support
        dispatches on."""
        return ("halo" if self._halo_mode else
                "pod" if self._pod_mode else
                "node" if self._node_like else "edge")

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
                dtype_bytes=self._ledger_dtype_bytes, mesh=self.mesh)
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
        """Register a deployable actor.

        ``fn=None`` selects the built-in gossip protocols (variant via
        ``RoundConfig.variant``) — the reference's
        ``register_actor("peer", Peer)`` maps to this plus config.

        ``fn`` may also be a :class:`~flow_updating_tpu_torch.models.actor.
        VectorActor`: the vetted extension point for custom protocols,
        written as population-wide tensor functions and run round after
        round on the engine's device like the built-in kernels.

        With ``Engine(host_actors=True)``, ``fn`` may be ANY Python
        callable/class — the reference's ``register_actor("peer", Peer)``
        surface (``flowupdating-collectall.py:156``) — executed on the
        deterministic host DES (:mod:`flow_updating_tpu_torch.s4u`) at
        host speed.  Without that opt-in, anything else raises: per-actor
        Python bytecode cannot run on the card, and silently recording it
        would make users think their callable runs."""
        if self.host_actors:
            if fn is not None and not callable(fn):
                raise TypeError(
                    f"register_actor({name!r}): {type(fn).__name__} is "
                    "not callable")
            self._registered[name] = fn
            return self
        from flow_updating_tpu_torch.models.actor import VectorActor

        if fn is not None and not isinstance(fn, VectorActor):
            raise TypeError(
                f"register_actor({name!r}): got {type(fn).__name__}; "
                "per-actor Python callables cannot execute on the card.  "
                "Pass None to select the built-in protocols "
                "(RoundConfig.variant), express the protocol as a "
                "flow_updating_tpu_torch.models.actor.VectorActor — "
                "population-wide (N,)/(E,) tensor functions run round "
                "after round on the device — or opt into the "
                "host-fidelity runtime with Engine(host_actors=True) to "
                "run arbitrary Python actors on the s4u host DES "
                "(reference semantics, host speed, not the card)")
        self._registered[name] = fn
        return self

    @property
    def _custom_actor(self):
        for fn in self._registered.values():
            if fn is not None:
                return fn
        return None

    def load_deployment(self, path: str,
                        function: str | None = None) -> Engine:
        if function is None and len(self._registered) == 1:
            function = next(iter(self._registered))
        self.deployment = load_deployment(path, function=function)
        if self.host_actors:
            # spawn reference-style now, so a driver-level Actor.create
            # (e.g. the watcher, collectall.py:162) finds a live runtime
            # between load_deployment and run_until
            self._host_spawn_deployment()
        return self

    def _host_des(self):
        """The lazily created s4u host DES (host_actors mode).  It becomes
        the active runtime; when the engine is dropped its actor threads
        are killed and joined (``HostDes.shutdown``)."""
        import weakref

        from flow_updating_tpu_torch import s4u

        if self._hostdes is None:
            self._hostdes = s4u.HostDes(platform=self.platform,
                                        event_log=self.event_log)
            s4u._CURRENT_DES = self._hostdes
            weakref.finalize(self, _shutdown_des, self._hostdes)
        return self._hostdes

    def _host_spawn_deployment(self) -> None:
        """Instantiate each deployment actor SimGrid-style: the registered
        class is constructed with the deployment's string args *inside the
        actor context* and then called (``flowupdating-collectall.py:
        156-157`` + ``actors.xml:4-7``)."""
        des = self._host_des()
        for spec in self.deployment.actors:
            fn = self._registered.get(spec.function)
            if fn is None:
                raise RuntimeError(
                    f"deployment binds function {spec.function!r} but no "
                    "callable was registered for it (host_actors mode "
                    "has no built-in protocol fallback)")
            des.spawn(spec.host, des.host(spec.host),
                      lambda _f=fn, _a=spec.args: _f(*_a)(), ())

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
        if self.adversary is not None:
            self._check_adversary()
        if self._custom_actor is not None:
            from flow_updating_tpu_torch.models.actor import ActorKernel

            if self.mesh is not None and self.multichip in ("halo", "pod"):
                raise ValueError(
                    f"multichip={self.multichip!r} drives a built-in "
                    "kernel; custom VectorActors distribute via GSPMD — "
                    "use multichip='auto'")
            if latency_scale > 0.0 or self.topology.max_delay > 1:
                raise ValueError(
                    "VectorActor rounds are unit-delay synchronous; "
                    "latency-warped delivery applies to the built-in "
                    "edge kernel only")
            self._node_kernel = ActorKernel(self.topology,
                                            self._custom_actor,
                                            mesh=self.mesh,
                                            device=self.device)
            self._topo_arrays = None
            return
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
                self._node_kernel = NodeKernel(
                    self.topology, self.config, device=self.device,
                    mesh=self.mesh, plan=self._plan,
                    **(self._fused_kw or {}))
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
        if self.adversary is not None:
            # the fault masks on the wire; an absent family stays None and
            # the round runs none of its operations
            self._topo_arrays = self._topo_arrays.replace(
                **self.adversary.device_leaves(
                    self.topology.num_nodes, self.topology.num_edges,
                    cfg.torch_dtype, device=self.device))

    def _check_adversary(self) -> None:
        """``adversary=`` runs on the single-device edge round's message
        wire, as in the JAX engine."""
        if (self.mesh is not None or self.host_actors
                or self._custom_actor is not None):
            raise ValueError(
                "adversary= injects faults into the single-device "
                "edge kernel's wire; multi-chip / host-actor / "
                "custom-actor dispatch is not covered — drop mesh=/"
                "host_actors=, or run the scenario under the sweep "
                "engine (SweepInstance.adversary)")
        if self.config.kernel != "edge":
            raise ValueError(
                "adversary= corrupts per-edge wire state; the node-"
                "collapsed kernel has no wire — use kernel='edge'")
        if self.config.needs_coloring:
            raise ValueError(
                "adversary= targets the message-based protocols; the "
                "fast synchronous pairwise mode exchanges estimates "
                "directly on-chip (no wire to attack) — use "
                "variant='collectall' or fire_policy='reference'")

    # ---- the topology compiler's auto mode (A5) -------------------------
    def _apply_plan(self) -> None:
        """Resolve ``plan=`` into a concrete kernel/spmv choice.  Runs
        between topology resolution and array preparation: the decision
        may rewrite ``self.config``'s kernel and spmv fields and nothing
        else — the requested dynamics are inputs to the selection, never
        outputs.  The chosen plan and the fused round's knobs go to the
        NodeKernel, whose permutation keeps every readback and telemetry
        row in original node order."""
        if self.plan_spec in (None, "off"):
            return
        if (self.mesh is not None or self.host_actors
                or self._custom_actor is not None):
            logger.info(
                "plan=%r: multi-chip / custom-actor dispatch is not "
                "planned yet; keeping the configured execution mode",
                self.plan_spec)
            return
        from flow_updating_tpu_torch.plan import ExecutionPlan, select_plan
        from flow_updating_tpu_torch.plan.select import PlanDecision

        feats = 0
        vals = self.topology.values
        if vals is not None and getattr(vals, "ndim", 1) > 1:
            feats = int(vals.size // vals.shape[0])
        spec = self.plan_spec
        if isinstance(spec, ExecutionPlan):
            decision = PlanDecision(
                kernel="node", spmv="banded", plan=spec,
                backend="explicit", predicted={},
                reason="explicit ExecutionPlan passed to Engine(plan=)")
        elif isinstance(spec, PlanDecision):
            decision = spec
        else:  # 'auto'
            decision = select_plan(self.topology, self.config,
                                   features=feats, device=self.device)
        if decision.kernel == "node" and not \
                self.config.is_fast_sync_collectall:
            raise ValueError(
                "the supplied plan selects the node kernel, but this "
                "config runs dynamics only the edge kernel implements "
                f"({self.config.variant!r}/{self.config.fire_policy!r}"
                f"/drop={self.config.drop_rate}) — use plan='auto' to "
                "let selection respect the config")
        if decision.kernel == "node":
            self.config = dataclasses.replace(
                self.config, kernel="node", spmv=decision.spmv)
            self._plan = decision.plan \
                if decision.spmv in ("banded", "banded_fused") else None
            if decision.spmv == "banded_fused":
                # the autotuner's measured tile / remainder route (or the
                # defaults when probing was skipped)
                self._fused_kw = dict(
                    (decision.fused or {}).get("chosen")
                    or {"fused_tile": None, "fused_remainder": "auto"})
        else:
            self.config = dataclasses.replace(self.config, kernel="edge")
            self._plan = None
        self.plan_decision = decision
        logger.info("plan: %s", decision.reason)

    def plan_report(self, mixing: bool = False) -> dict | None:
        """JSON-ready record of the plan decision (None when planning was
        off or fell back) — the ``plan`` block of run and plan manifests.
        Vector-payload engines also carry the payload-schedule ranking
        (``payload_schedule``), a fused-round engine its bytes per round
        (``fused_round``).  ``mixing=True`` adds the topology's spectral
        gap (:func:`~flow_updating_tpu_torch.obs.spectral.mixing_report`,
        probed on the engine's device) as the ``mixing`` block."""
        if self.plan_decision is None:
            return None
        out = self.plan_decision.describe()
        if mixing and self.topology is not None:
            from flow_updating_tpu_torch.obs.spectral import mixing_report

            out["mixing"] = mixing_report(
                self.topology,
                plan=self._plan if self.plan_decision.spmv
                in ("banded", "banded_fused") else None,
                device=self.device)
        vals = self.topology.values if self.topology is not None else None
        if vals is not None and getattr(vals, "ndim", 1) > 1:
            from flow_updating_tpu_torch.plan.select import (
                select_payload_schedule,
            )

            feats = int(vals.size // vals.shape[0])
            try:
                out["payload_schedule"] = select_payload_schedule(
                    self.topology, features=feats,
                    backend=self.device.type,
                    dtype_bytes=self.config.torch_dtype.itemsize)
            except ValueError as exc:
                out["payload_schedule"] = {"error": str(exc)}
        if self._node_kernel is not None:
            from flow_updating_tpu_torch.obs.profile import (
                fused_round_report,
            )

            fused = fused_round_report(self._node_kernel)
            if fused is not None:
                out["fused_round"] = fused
        return out

    def _plan_for_restore(self, cfg: RoundConfig) -> None:
        """A planned engine restores as the banded route does: the
        archive's config governs; the plan decision (made now under that
        config if this engine was never built) hands its plan and fused
        knobs to the kernel only when it picks the archive's route."""
        if self.plan_spec not in (None, "off") and \
                self.plan_decision is None:
            self.config = cfg
            self._apply_plan()
        self.config = cfg
        d = self.plan_decision
        if d is None or (d.kernel, d.spmv if d.kernel == "node" else None) \
                != (cfg.kernel, cfg.spmv if cfg.kernel == "node" else None):
            self._plan = self._fused_kw = None

    def build(self, latency_scale: float = 0.0, seed: int = 0) -> Engine:
        """Resolve deployment(+platform) into topology + kernel + fresh
        state.  ``seed`` keys the edge kernel's message-loss draws."""
        import time

        t0 = time.perf_counter()
        self._resolve_topology(latency_scale)
        self._apply_plan()
        self._prepare_arrays(latency_scale)
        if self._halo_mode:
            from flow_updating_tpu_torch.parallel import sharded

            self.state = sharded.init_plan_state(
                self._halo_plan, self.config, self.mesh, seed=seed)
        elif self._node_like:
            self.state = self._node_kernel.init_state()
        else:
            self.state = init_state(self.topology, self.config, seed=seed,
                                    device=self.device)
        self._build_s = time.perf_counter() - t0
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
        if self.host_actors:
            raise NotImplementedError(
                "host_actors mode runs watchers as ordinary s4u actors, "
                "exactly like the reference: "
                "s4u.Actor.create('watcher', host, fn, deadline, every) "
                "(see examples/torch_host_actors.py::watcher)")
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
        if self.host_actors:
            raise NotImplementedError(
                "host_actors mode: state lives inside the user's Python "
                "actors — keep your own global_values mirror like the "
                "reference does (examples/torch_host_actors.py)")
        if self.state is None:
            return {}
        names = self.topology.names or tuple(
            str(i) for i in range(self.topology.num_nodes))
        if self._halo_mode:
            from flow_updating_tpu_torch.parallel import sharded

            value = self.topology.values
            last_avg = sharded.gather_node_array(
                [st.last_avg for st in self.state.shards], self._halo_plan)
        elif self._node_like:
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
        if self.host_actors:
            raise NotImplementedError(
                "host_actors mode: state lives inside the user's Python "
                "actors (the reference keeps its own global_values mirror, "
                "collectall.py:131) — expose it from the actor, as "
                "examples/torch_host_actors.py does")
        if self.state is None:
            raise RuntimeError("engine not built")
        if self._halo_mode:
            from flow_updating_tpu_torch.parallel import sharded

            return sharded.gather_estimates(self.state, self._halo_plan)
        if self._node_like:
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
        if self._custom_actor is not None:
            from flow_updating_tpu_torch.utils.checkpoint import (
                save_actor_checkpoint,
            )

            save_actor_checkpoint(
                path, self.state, self._custom_actor.name,
                topo=self.topology,
                extra={"clock": self._clock, "killed": self._killed})
            return self
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
        if self._custom_actor is not None:
            # a VectorActor restore runs the actor's init once: the fresh
            # carry is the template the archive is checked against
            from flow_updating_tpu_torch.utils.checkpoint import (
                load_actor_checkpoint,
            )

            self._prepare_arrays()
            template = self._node_kernel.init_state()
            self.state, extra = load_actor_checkpoint(
                path, template, self._custom_actor.name,
                topo=self.topology)
            self._clock = float(extra.get("clock", 0.0))
            self._killed = bool(extra.get("killed", False))
            return self
        cls_name, fields, cfg, extra = read_checkpoint(path,
                                                       topo=self.topology)
        want = "NodeSyncState" if cfg.kernel == "node" \
            else "FlowUpdatingState"
        if cls_name != want:
            raise ValueError(
                f"checkpoint {path} holds a {cls_name} but its config "
                f"runs kernel={cfg.kernel!r} (corrupt archive?)")
        self._plan_for_restore(cfg)
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
        """Run ``n`` rounds of the configured kernel.  With an event log
        attached, each call leaves an ``advance`` record (simulated start
        time, round count, host wall time of the dispatch — the card runs
        asynchronously, so ``wall_s`` measures the launches)."""
        import time

        t0 = time.perf_counter() if self.event_log is not None else 0.0
        self._advance_inner(n)
        if self.event_log is not None:
            self.event_log.emit(
                "advance", t=self._clock, rounds=n,
                wall_s=round(time.perf_counter() - t0, 6))

    def _advance_inner(self, n: int) -> None:
        if self._halo_mode:
            from flow_updating_tpu_torch.parallel import sharded

            self.state = sharded.run_rounds_sharded(
                self.state, self._halo_plan, self.config, self.mesh, n,
                arrays=self._halo_arrays, halo=self._halo_wire)
        elif self._node_like:
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

    def run_telemetry(self, n: int, spec=None):
        """Run ``n`` rounds, accumulating the ``spec``-selected per-round
        metric series on the device (no host read inside the loop; one
        bulk copy at the end).  Returns a :class:`~flow_updating_tpu_torch.
        obs.telemetry.TelemetrySeries`.  Dispatches to the kernel's
        runner (edge, node, halo, pod); a disabled spec runs the plain
        :meth:`run_rounds` and returns an empty series.  The state after
        it equals the state after :meth:`run_rounds` bit for bit.
        ``self.telemetry_timings`` afterwards holds ``compile_s`` (None:
        nothing is compiled) and ``execute_s``."""
        import time

        from flow_updating_tpu_torch.obs.telemetry import (
            TelemetrySeries,
            TelemetrySpec,
        )

        spec = TelemetrySpec.default() if spec is None else spec
        self.telemetry_timings = {}
        if self.state is None:
            self.build()
        if not spec.enabled or self._killed or n <= 0:
            self.run_rounds(n)
            return TelemetrySeries.empty()
        if self._custom_actor is not None:
            raise NotImplementedError(
                "telemetry series cover the built-in kernels; a custom "
                "VectorActor defines its own carry — sample it from the "
                "actor's rounds instead")
        kind = self._kernel_kind
        spec = spec.for_kernel(kind)
        t0 = time.perf_counter()
        if kind == "halo":
            from flow_updating_tpu_torch.parallel import sharded

            state, series = sharded.run_rounds_sharded_telemetry(
                self.state, self._halo_plan, self.config, self.mesh, n,
                spec, self.topology.true_mean, arrays=self._halo_arrays,
                halo=self._halo_wire)
        elif kind == "pod":
            state, series = self._node_kernel.run_telemetry(self.state, n,
                                                            spec)
        elif kind == "node":
            if not isinstance(self._node_kernel, NodeKernel):
                raise NotImplementedError(
                    f"telemetry is not wired into "
                    f"{type(self._node_kernel).__name__} yet — use the "
                    "plain NodeKernel (spmv='xla'|'pallas'|'benes'|"
                    "'structured'), the pod kernel, or the edge kernel")
            state, series = self._node_kernel.run_telemetry(self.state, n,
                                                            spec)
        else:
            state, series = rounds.run_rounds_telemetry(
                self.state, self._topo_arrays, self.config, n, spec,
                self.topology.true_mean)
        host = {k: v.cpu().numpy() for k, v in series.items()}
        self.telemetry_timings = {
            "compile_s": None,
            "execute_s": round(time.perf_counter() - t0, 6),
        }
        self.state = state
        self._clock += n * TICK_INTERVAL
        return TelemetrySeries(host)

    def run_fields(self, n: int, spec=None):
        """Run ``n`` rounds recording the ``spec``-selected per-node and
        per-edge fields (:mod:`~flow_updating_tpu_torch.obs.fields`) on
        the device every ``spec.stride`` rounds: no host read inside the
        loop, one bulk copy at the end.  Returns a :class:`~flow_updating_
        tpu_torch.obs.fields.FieldSeries` in ORIGINAL node and edge order.

        Dispatches to the kernel's fields runner (edge, node, halo, pod);
        the sharded banded and Beneš rounds raise ``NotImplementedError``,
        as in the JAX package.  A disabled spec runs the plain
        :meth:`run_rounds` and returns an empty series; at any stride the
        state afterwards equals :meth:`run_rounds`' bit for bit.
        ``self.field_timings`` afterwards holds ``compile_s`` (None),
        ``execute_s`` (the loop's launches), ``copy_s`` (the wait for the
        device, the bulk copy and the host's reassembly) and
        ``recorded_bytes`` (the rows on the device)."""
        import time

        from flow_updating_tpu_torch.obs.fields import (
            EDGE_FIELDS,
            FieldSeries,
            FieldSpec,
        )
        from flow_updating_tpu_torch.obs.inspect import node_coordinates

        spec = FieldSpec.default() if spec is None else spec
        self.field_timings = {}
        if self.state is None:
            self.build()
        if not spec.enabled or self._killed or n <= 0:
            self.run_rounds(n)
            return FieldSeries.empty()
        if self._custom_actor is not None:
            raise NotImplementedError(
                "field series cover the built-in kernels; a custom "
                "VectorActor defines its own carry — sample it from the "
                "actor's rounds instead")
        kind = self._kernel_kind
        spec = spec.for_kernel(kind)
        if not spec.enabled:
            self.run_rounds(n)
            return FieldSeries.empty()
        if n % spec.stride:
            raise ValueError(
                f"round count {n} must be a multiple of the field "
                f"stride {spec.stride}")
        if kind == "node" and not isinstance(self._node_kernel, NodeKernel):
            raise NotImplementedError(
                f"field recording is not wired into "
                f"{type(self._node_kernel).__name__} yet — use the "
                "plain NodeKernel (spmv='xla'|'pallas'|'benes'|"
                "'structured'), the pod kernel, or the edge kernel")
        t0 = time.perf_counter()
        if kind == "halo":
            from flow_updating_tpu_torch.parallel import sharded

            state, conv_b, series = sharded.run_rounds_sharded_fields(
                self.state, self._halo_plan, self.config, self.mesh, n,
                spec, self.topology.true_mean, arrays=self._halo_arrays,
                halo=self._halo_wire)
        elif kind == "pod":
            state, conv_b, series = self._node_kernel.run_fields(
                self.state, n, spec)
        elif kind == "node":
            state, conv_b, series = self._node_kernel.run_fields(
                self.state, n, spec)
        else:
            state, conv_b, series = rounds.run_rounds_fields(
                self.state, self._topo_arrays, self.config, n, spec,
                self.topology.true_mean)
        t1 = time.perf_counter()
        recorded = sum(x.numel() * x.element_size()
                       for v in series.values()
                       for x in (v if isinstance(v, list) else [v]))
        # key order as the JAX package's (a pytree dict comes back sorted),
        # so summaries and manifests list the fields alike
        host = {k: ([x.cpu().numpy() for x in v] if isinstance(v, list)
                    else v.cpu().numpy()) for k, v in sorted(series.items())}
        if not spec.has("node_conv_round"):
            conv_b = None
        if conv_b is not None:
            conv_b = ([c.cpu().numpy() for c in conv_b]
                      if isinstance(conv_b, list) else conv_b.cpu().numpy())
        t = host.pop("t")
        active = host.pop("active")
        node: dict = {}
        edge: dict = {}
        conv = topk_idx = None
        if kind == "halo":
            for name, v in host.items():
                if name in EDGE_FIELDS:
                    edge[name] = sharded.gather_edge_field_series(
                        v, self._halo_plan, self.topology)
                else:
                    node[name] = sharded.gather_node_field_series(
                        v, self._halo_plan)
            if conv_b is not None:
                conv = sharded.gather_node_array(conv_b, self._halo_plan)
        elif kind == "pod":
            for name, v in host.items():
                node[name] = self._node_kernel.flatten_field_series(v)
            if conv_b is not None:
                conv = self._node_kernel.flatten_field_final(conv_b)
        elif kind == "node":
            kernel = self._node_kernel
            if "topk_idx" in host:
                topk_idx = kernel.original_node_ids(host.pop("topk_idx"))
                node.update(host)
            else:
                node.update({k: kernel.unpermute_series(v)
                             for k, v in host.items()})
            if conv_b is not None:
                conv = kernel._unpermute(conv_b)
        else:
            topk_idx = host.pop("topk_idx", None)
            for name, v in host.items():
                (edge if name in EDGE_FIELDS else node)[name] = v
            conv = conv_b
        self.field_timings = {
            "compile_s": None,
            "execute_s": round(t1 - t0, 6),
            "copy_s": round(time.perf_counter() - t1, 6),
            "recorded_bytes": int(recorded),
        }
        self.state = state
        self._clock += n * TICK_INTERVAL
        edges = None
        if edge:
            topo = self.topology
            edges = {"src": np.asarray(topo.src),
                     "dst": np.asarray(topo.dst),
                     "rev": np.asarray(topo.rev)}
        return FieldSeries(
            t=t, active=active, node=node, edge=edge, conv_round=conv,
            topk_idx=topk_idx, spec=spec, edges=edges,
            coords=node_coordinates(self.topology))

    def round_program(self, n: int):
        """``(fn, full_args, n_dynamic)`` of the configured kernel's ``n``
        rounds from the engine's state — the kernel's own
        ``round_program`` hook, which :meth:`profile` runs from copies of
        the state.  ``fn(*full_args)`` returns the advanced state and
        leaves the engine as it is only when given a copy."""
        if self.state is None:
            self.build()
        kind = self._kernel_kind
        if kind == "halo":
            from flow_updating_tpu_torch.parallel import sharded

            return sharded.round_program(
                self.state, self._halo_plan, self.config, self.mesh, n,
                arrays=self._halo_arrays, halo=self._halo_wire)
        if kind in ("node", "pod"):
            return self._node_kernel.round_program(self.state, n)
        return (rounds.run_rounds,
                (self.state, self._topo_arrays, self.config, n), 1)

    def profile(self, n: int, *, execute: bool = True,
                trace_dir: str | None = None,
                roofline: bool = False) -> dict:
        """Cost attribution of the configured kernel's ``n`` rounds
        (:mod:`~flow_updating_tpu_torch.obs.profile`): the bytes and flops
        counted over the rounds (``cost``, ``method: 'counted'``), the
        card's memory (``memory``; ``available: False`` on the CPU), the
        timings, the wrappers' launches (``launches`` and
        ``launches_per_round``), in the JAX package's keys (``mode``,
        ``rounds``, ``per_round``, ``topology``, ``config``, ``halo``,
        ``overlap``, ``roofline``).

        Profiling is a pure observer: it runs the kernel's own round
        program (each kernel's ``round_program`` hook) from copies of
        the state, and does not advance the engine's state or clock.
        ``execute=False`` skips the timed run; in the port the counted
        run still runs the rounds, since counting is how the cost is
        known.  ``trace_dir`` captures one more run with
        ``torch.profiler`` there and records the device events it kept
        for each kernel (``trace``, with ``trace_complete``), and, on the
        halo kernel's overlap schedules, measures the overlap ratio from
        the trace's slices; ``roofline`` attaches the perf lens'
        predicted-vs-measured record (:mod:`~flow_updating_tpu_torch.obs.
        roofline`)."""
        from flow_updating_tpu_torch.obs import profile as _prof

        if n <= 0:
            raise ValueError("profile needs a positive round count")
        if self.state is None:
            self.build()
        if self._custom_actor is not None:
            raise NotImplementedError(
                "cost attribution covers the built-in kernels; a custom "
                "VectorActor owns its rounds — count them with "
                "obs.profile.profile_program directly")
        kind = self._kernel_kind
        fn, args, nd = self.round_program(n)
        record = _prof.profile_program(
            fn, args, n_dynamic=nd, execute=execute, label=kind,
            device=self.device, rounds=n, lower_s=self._build_s,
            trace_dir=trace_dir)
        shards = self.mesh.size if self.mesh is not None else 0
        record.update({
            "mode": kind,
            "rounds": n,
            "per_round": _prof.per_round(record, n),
            "launches_per_round": {k: v / n for k, v in
                                   record["launches"].items()},
            "topology": {"nodes": self.topology.num_nodes,
                         "edges": self.topology.num_edges},
            "config": {"kernel": self.config.kernel,
                       "variant": self.config.variant,
                       "fire_policy": self.config.fire_policy,
                       "spmv": self.config.spmv,
                       "delivery": self.config.delivery,
                       "dtype": self.config.dtype,
                       "multichip": (self.multichip
                                     if self.mesh is not None else None),
                       "halo": (self._halo_wire if kind == "halo"
                                else None),
                       "shards": shards},
        })
        if kind == "halo":
            record["halo"] = self.halo_report()
            if self._halo_wire in ("overlap", "overlap_pallas"):
                record["overlap"] = _prof.overlap_report(
                    self.state, self._halo_plan, self.config, self.mesh,
                    n, arrays=self._halo_arrays, execute=execute,
                    mode=self._halo_wire, trace_dir=trace_dir)
        if roofline:
            from flow_updating_tpu_torch.obs import roofline as _roof

            mode = kind
            if kind in ("node", "pod") and self.config.spmv:
                mode = f"{kind}/{self.config.spmv}"
            if shards:
                mode += f"@s{shards}"
            model = _roof.resolve_model(self.device)
            exec_s = record["timings"].get("execute_s")
            measured = (n / exec_s if isinstance(exec_s, (int, float))
                        and exec_s > 0 else None)
            record["roofline"] = _roof.reconcile(
                _roof.analyze(record, model, rounds=n, mode=mode),
                measured)
        return record

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
        if self.state is None:
            self.build()
        emit = emit or _log_stream_sample
        if self._halo_mode:
            self._halo_streamed(n, observe_every, emit)
            self._clock += n * TICK_INTERVAL
            return self
        if n % observe_every:
            raise ValueError("num_rounds must be a multiple of observe_every")
        if self._custom_actor is not None:
            if not self._killed and n > 0:
                self.state = self._node_kernel.run_streamed(
                    self.state, n, observe_every, emit)
            self._clock += n * TICK_INTERVAL
            return self
        if self.config.kernel == "edge":
            if not self._killed and n > 0:
                self.state = rounds.run_rounds_streamed(
                    self.state, self._topo_arrays, self.config, n,
                    observe_every, self.topology.true_mean, emit)
            self._clock += n * TICK_INTERVAL
            return self
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

    def _halo_streamed(self, n: int, observe_every: int, emit) -> None:
        """The halo kernel's streamed observer: chunks between samples,
        each sample with the other kernels' contract (the state's round
        counter, alive-masked rmse and mass, real fired counts)."""
        from flow_updating_tpu_torch.parallel import sharded

        done = 0
        while done < n and not self._killed:
            take = min(int(observe_every), n - done)
            self._advance(take)
            done += take
            est = self.estimates()
            alive = sharded.gather_node_array(
                [st.alive for st in self.state.shards],
                self._halo_plan).astype(bool)
            cnt = max(int(alive.sum()), 1)
            err = np.where(alive, est - self.topology.true_mean, 0.0)
            emit(observer_sample(
                self.state.t, np.sqrt(np.sum(err * err) / cnt),
                np.max(np.abs(err)), est[alive].sum(),
                sharded.gather_node_array(
                    [st.fired for st in self.state.shards],
                    self._halo_plan).sum()))

    def _host_run_until(self, t_end: float) -> Engine:
        """host_actors mode: drive the s4u DES (actors were spawned at
        ``load_deployment``; any extras via ``s4u.Actor.create``)."""
        des = self._host_des()
        des.run_until(float(t_end))
        self._clock = des.clock
        return self

    def run_until(self, t_end: float) -> Engine:
        """Advance simulated time to ``t_end``, honoring watchers: chunks
        of rounds between sampling points, callbacks at each sample, and a
        hard stop of peer execution at a watcher's ``until`` (after which
        the clock still advances to ``t_end``).  In host_actors mode the
        s4u DES runs to ``t_end`` instead."""
        if self.host_actors:
            return self._host_run_until(t_end)
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
                    if self.event_log is not None:
                        self.event_log.emit("kill_all", t=self._clock)
        self._clock = float(t_end)
        return self
