"""SimGrid deployment-XML loader (``actors.xml`` dialect).

Counterpart of ``flow_updating_tpu/topology/deployment.py``.

Replaces SimGrid's deployment parser + actor factory (SURVEY.md N7; the
reference binds its ``peer`` function to hosts at
``flowupdating-collectall.py:156-157`` and receives ``(value,
"n1,n2,...")`` string arguments, ``actors.xml`` format).  Here the
deployment is data, not actor spawning: it resolves to an initial-value
vector plus declared directed neighbor pairs, which :func:`to_topology`
symmetrizes into a :class:`~flow_updating_tpu_torch.topology.graph.Topology`.
"""

from __future__ import annotations

import dataclasses
import xml.etree.ElementTree as ET

import numpy as np

from flow_updating_tpu_torch.topology.graph import Topology, build_topology
from flow_updating_tpu_torch.topology.platform import Platform


@dataclasses.dataclass(frozen=True)
class ActorSpec:
    host: str
    function: str
    args: tuple

    @property
    def value(self) -> float:
        return float(self.args[0]) if self.args else 0.0

    @property
    def neighbors(self) -> tuple:
        if len(self.args) < 2 or not self.args[1]:
            return ()
        return tuple(self.args[1].split(","))


@dataclasses.dataclass(frozen=True)
class Deployment:
    actors: tuple  # of ActorSpec, in file order

    @property
    def host_names(self) -> tuple:
        return tuple(a.host for a in self.actors)

    def to_topology(
        self,
        platform: Platform | None = None,
        tick_interval: float = 1.0,
        latency_scale: float = 0.0,
        msg_bytes: float = 104.0,
    ) -> Topology:
        """Deployment (+ optional platform for latencies/speeds) -> Topology.

        Node ids follow actor declaration order.  Neighbor lists may be
        asymmetric, exactly as the reference's ``actors.xml`` is; the builder
        symmetrizes and logs the adopted reverse edges.
        """
        names = list(self.host_names)
        ids = {n: i for i, n in enumerate(names)}
        values = np.array([a.value for a in self.actors], dtype=np.float64)
        pairs = []
        for a in self.actors:
            for nb in a.neighbors:
                if nb not in ids:
                    raise ValueError(
                        f"actor {a.host!r} declares neighbor {nb!r} which has "
                        "no actor deployed"
                    )
                pairs.append((ids[a.host], ids[nb]))
        latency = None
        bandwidth = None
        speeds = None
        link_caps = None
        link_shared = None
        route_links = None
        if platform is not None:
            latency = platform.latency_table(names)
            bandwidth = platform.bandwidth_table(names)
            speeds = np.array(
                [platform.hosts.get(n, 0.0) for n in names], dtype=np.float64
            )
            if latency_scale > 0.0:
                # the link model only feeds latency-warped / contention
                # runs; build_topology discards it otherwise
                link_caps, link_shared, route_links = \
                    platform.link_table(names)
        return build_topology(
            num_nodes=len(names),
            pairs=np.array(pairs, dtype=np.int64).reshape(-1, 2),
            values=values,
            names=names,
            latency_s=latency,
            bandwidth=bandwidth,
            speeds=speeds,
            tick_interval=tick_interval,
            latency_scale=latency_scale,
            msg_bytes=msg_bytes,
            route_links=route_links,
            link_caps=link_caps,
            link_shared=link_shared,
        )


def load_deployment(path: str, function: str | None = None) -> Deployment:
    """Parse an actors.xml.  If ``function`` is given, keep only actors bound
    to that function name (the analogue of ``register_actor("peer", Peer)``:
    unregistered functions simply have no implementation here)."""
    tree = ET.parse(path)
    root = tree.getroot()
    actors = []
    for child in root:
        if child.tag != "actor":
            continue
        args = tuple(
            a.attrib["value"] for a in child if a.tag == "argument"
        )
        spec = ActorSpec(
            host=child.attrib["host"],
            function=child.attrib["function"],
            args=args,
        )
        if function is None or spec.function == function:
            actors.append(spec)
    if not actors:
        raise ValueError(f"{path}: no matching <actor> entries")
    return Deployment(actors=tuple(actors))
