"""Engine façade — the S4U-shaped driver API over the node-collapsed kernel.

Counterpart of ``flow_updating_tpu/engine.py`` for the node kernel:
``Engine(argv, config)`` -> ``load_platform`` -> ``register_actor`` ->
``load_deployment`` -> ``build`` -> ``run_rounds`` / ``run_until`` (with
the watcher) -> ``estimates`` / ``convergence_report`` / ``global_values``.
The deployment resolves to a :class:`Topology`, the state is one
:class:`~flow_updating_tpu_torch.models.sync.NodeSyncState`, and rounds run
on the engine's device — the CUDA card unless ``device='cpu'`` is given.

What the JAX engine does beyond the node kernel raises
``NotImplementedError`` naming its ROADMAP item: ``kernel='edge'`` (the JAX
default), ``mesh``/``multichip``, ``plan='auto'``, ``host_actors``,
``adversary``, custom actors and event logs.

Simulated-time convention: one round == ``TICK_INTERVAL`` (1.0) simulated
seconds, the reference peers' loop cadence.
"""

from __future__ import annotations

import dataclasses
import logging
import typing
from collections.abc import Callable

import numpy as np

from flow_updating_tpu_torch.models.config import RoundConfig
from flow_updating_tpu_torch.models.sync import NodeKernel, _node_sample
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
        f"{what} is the ROADMAP item '{item}', not ported yet; this "
        "package's Engine runs the node-collapsed kernel "
        "(RoundConfig.fast(kernel='node'))")


class Engine:
    """Driver for one aggregation run on one device."""

    def __init__(self, argv=None, config: RoundConfig | None = None,
                 mesh=None, multichip: str = "auto",
                 halo: str = "ppermute", partition: str = "bfs",
                 host_actors: bool = False, event_log=None,
                 plan="off", adversary=None, device=None):
        # the argument list mirrors the JAX Engine so call sites carry
        # over; what this package does not run yet is refused up front
        if mesh is not None or multichip != "auto" or halo != "ppermute" \
                or partition != "bfs":
            raise _not_ported("multi-device execution (mesh/multichip/halo)",
                              "multi-device execution (A12, B5, B6)")
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
        if self.config.kernel != "node":
            raise _not_ported(
                f"kernel={self.config.kernel!r} (the general per-edge "
                "round)", "edge kernel (A2/A3)")
        self.device = resolve_device(device)
        self.platform: Platform | None = None
        self.deployment: Deployment | None = None
        self.topology: Topology | None = None
        self.state = None
        self._node_kernel: NodeKernel | None = None
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

    def build(self, latency_scale: float = 0.0, seed: int = 0) -> Engine:
        """Resolve deployment(+platform) into topology + kernel + fresh
        state.  ``seed`` feeds the edge kernel's PRNG in the JAX package;
        the node kernel draws nothing."""
        del seed
        self._resolve_topology(latency_scale)
        if latency_scale > 0.0 or self.topology.max_delay > 1:
            raise ValueError(
                "latency-warped rounds need per-edge delivery state; the "
                "node-collapsed kernel is unit-delay only — use "
                "kernel='edge' with latency_scale")
        self._node_kernel = NodeKernel(self.topology, self.config,
                                       device=self.device)
        self.state = self._node_kernel.init_state()
        return self

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
        value = self.topology.values
        last_avg = self._node_kernel.last_avg(self.state)
        return {
            "value": dict(zip(names, value.tolist())),
            "last_avg": dict(zip(names, last_avg.tolist())),
        }

    def estimates(self) -> np.ndarray:
        if self.state is None:
            raise RuntimeError("engine not built")
        return self._node_kernel.estimates(self.state)

    def convergence_report(self) -> dict:
        """Convergence + invariant metrics for the current state."""
        est = self.estimates()
        mean = self.topology.true_mean
        return {
            "t": int(self.state.t),
            "rmse": rmse(est, mean),
            "max_abs_err": float(np.max(np.abs(est - mean))),
            "mass_residual": mass_residual(est, self.topology.values),
        }

    # ---- execution -------------------------------------------------------
    def _advance(self, n: int) -> None:
        self.state = self._node_kernel.run(self.state, n)

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
        if self.state is None:
            self.build()
        emit = emit or _log_stream_sample
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
