"""SimGrid platform-XML loader (the dialect of ``simgrid.dtd`` the reference uses).

Counterpart of ``flow_updating_tpu/topology/platform.py`` (stdlib ``xml``
and numpy only, so it is carried over unchanged).

Replaces SimGrid's C++ platform parser + routing tables (SURVEY.md N6; the
reference loads its platform at ``flowupdating-collectall.py:154``).  We parse
the same declarative dialect — ``<host id speed>``, ``<link id bandwidth
latency [sharing_policy]>``, ``<route src dst><link_ctn id/></route>`` inside
``<zone>``/``<AS>`` — but emit plain numpy tables instead of a routing engine:
per-route latency is the sum of link latencies along the declared path and
per-route bandwidth the min over links, which is all the Flow-Updating
workload observes of SimGrid's flow-level model.

Only the subset of the DTD exercised by gossip platforms is supported; rich
features (clusters, caburettor bandwidth profiles, state traces) are out of
scope and rejected loudly rather than silently misparsed.
"""

from __future__ import annotations

import dataclasses
import math
import re
import xml.etree.ElementTree as ET
from collections.abc import Mapping

import numpy as np

# Unit multipliers for SimGrid value strings, e.g. "98.095Mf", "41.2MBps",
# "59.904us", "35.083019ms".
_SI = {
    "": 1.0, "k": 1e3, "K": 1e3, "M": 1e6, "G": 1e9, "T": 1e12,
    "m": 1e-3, "u": 1e-6, "n": 1e-9, "p": 1e-12,
}

_NUM_RE = re.compile(r"^\s*([0-9.eE+-]+)\s*([A-Za-z]*)\s*$")


def _mult(unit: str, text: str, kind: str) -> float:
    if unit not in _SI:
        raise ValueError(f"unknown unit in {kind} value {text!r}")
    return _SI[unit]


def parse_value(text: str, kind: str) -> float:
    """Parse a SimGrid quantity: kind in {'speed', 'bandwidth', 'time'}."""
    m = _NUM_RE.match(text)
    if not m:
        raise ValueError(f"cannot parse {kind} value {text!r}")
    num, unit = float(m.group(1)), m.group(2)
    if kind == "speed":  # '98.095Mf' -> flops
        unit = unit[:-1] if unit.endswith("f") else unit
        return num * _mult(unit, text, kind)
    if kind == "bandwidth":  # '41.27MBps' or 'kBps' or 'Bps' -> bytes/s
        if unit.endswith("Bps"):
            unit = unit[:-3]
        elif unit.endswith("bps"):  # bits per second
            return num * _mult(unit[:-3], text, kind) / 8.0
        return num * _mult(unit, text, kind)
    if kind == "time":  # '59.904us' / '1.4ms' / '15s' / bare seconds
        if unit.endswith("s"):
            unit = unit[:-1]
        return num * _mult(unit, text, kind)
    raise ValueError(f"unknown kind {kind}")


@dataclasses.dataclass(frozen=True)
class Link:
    id: str
    bandwidth: float  # bytes/s
    latency: float    # seconds
    sharing_policy: str = "SHARED"


@dataclasses.dataclass(frozen=True)
class Route:
    src: str
    dst: str
    links: tuple  # link ids in path order

    def latency(self, links: Mapping[str, Link]) -> float:
        return float(sum(links[l].latency for l in self.links))

    def bandwidth(self, links: Mapping[str, Link]) -> float:
        return float(min(links[l].bandwidth for l in self.links))


@dataclasses.dataclass(frozen=True)
class Platform:
    """Parsed platform: host table + link table + explicit routes."""

    hosts: dict       # name -> speed (flops)
    links: dict       # id -> Link
    routes: dict      # (src, dst) -> Route, symmetric lookup via route()

    @property
    def host_names(self) -> tuple:
        return tuple(self.hosts.keys())

    def add_host(self, name: str, speed: float) -> Platform:
        """Programmatic host creation — the analogue of the reference's
        ``e.netzone_root.add_host("observer", 25e6)``
        (``flowupdating-collectall.py:159``)."""
        hosts = dict(self.hosts)
        hosts[name] = float(speed)
        return dataclasses.replace(self, hosts=hosts)

    def route(self, src: str, dst: str) -> Route | None:
        r = self.routes.get((src, dst))
        if r is None:
            r = self.routes.get((dst, src))
        return r

    def route_latency(self, src: str, dst: str, default: float = 0.0) -> float:
        r = self.route(src, dst)
        return r.latency(self.links) if r is not None else default

    def route_bandwidth(self, src: str, dst: str,
                        default: float = math.inf) -> float:
        r = self.route(src, dst)
        return r.bandwidth(self.links) if r is not None else default

    def latency_table(self, names: list) -> dict:
        """{(u_id, v_id): seconds} over the given host-name ordering."""
        out = {}
        for i, a in enumerate(names):
            for j, b in enumerate(names):
                if i == j:
                    continue
                r = self.route(a, b)
                if r is not None:
                    out[(i, j)] = r.latency(self.links)
        return out

    def bandwidth_table(self, names: list) -> dict:
        """{(u_id, v_id): bytes/s} (bottleneck link along the route)."""
        out = {}
        for i, a in enumerate(names):
            for j, b in enumerate(names):
                if i == j:
                    continue
                r = self.route(a, b)
                if r is not None:
                    out[(i, j)] = r.bandwidth(self.links)
        return out

    def link_table(self, names: list):
        """Link-level route membership for the contention model.

        Returns ``(link_caps (L,) f64, link_shared (L,) bool,
        route_links {(u_id, v_id): tuple(link_idx)})`` over a stable
        (declaration-ordered) link indexing.  This is what SimGrid's
        flow-level model contends over: concurrent transfers crossing the
        same SHARED link split its bandwidth; FATPIPE links don't share
        (SURVEY.md N3; reference links at
        ``platforms/small_platform.xml:13-36``).
        """
        link_ids = list(self.links.keys())
        idx = {lid: k for k, lid in enumerate(link_ids)}
        caps = np.array(
            [self.links[l].bandwidth for l in link_ids], dtype=np.float64
        )
        shared = np.array(
            [self.links[l].sharing_policy.upper() != "FATPIPE"
             for l in link_ids], dtype=bool,
        )
        route_links = {}
        for i, a in enumerate(names):
            for j, b in enumerate(names):
                if i == j:
                    continue
                r = self.route(a, b)
                if r is not None:
                    route_links[(i, j)] = tuple(idx[l] for l in r.links)
        return caps, shared, route_links


_UNSUPPORTED = {"cluster", "cabinet", "peer", "trace", "trace_connect", "bypassRoute"}


def load_platform(path: str) -> Platform:
    tree = ET.parse(path)
    root = tree.getroot()
    if root.tag != "platform":
        raise ValueError(f"{path}: root element is <{root.tag}>, expected <platform>")

    hosts: dict = {}
    links: dict = {}
    routes: dict = {}

    def walk(elem):
        for child in elem:
            tag = child.tag
            if tag in ("zone", "AS"):
                walk(child)
            elif tag == "host":
                hosts[child.attrib["id"]] = parse_value(child.attrib["speed"], "speed")
            elif tag == "link":
                links[child.attrib["id"]] = Link(
                    id=child.attrib["id"],
                    bandwidth=parse_value(child.attrib["bandwidth"], "bandwidth"),
                    latency=parse_value(child.attrib.get("latency", "0us"), "time"),
                    sharing_policy=child.attrib.get("sharing_policy", "SHARED"),
                )
            elif tag == "route":
                path_links = tuple(
                    lc.attrib["id"] for lc in child if lc.tag == "link_ctn"
                )
                r = Route(src=child.attrib["src"], dst=child.attrib["dst"], links=path_links)
                routes[(r.src, r.dst)] = r
            elif tag in _UNSUPPORTED:
                raise NotImplementedError(
                    f"{path}: platform element <{tag}> is not supported by the "
                    "gossip topology loader"
                )
            # silently ignore <prop> and comments
    walk(root)

    missing = {
        l for r in routes.values() for l in r.links if l not in links
    }
    if missing:
        raise ValueError(f"{path}: routes reference undeclared links {sorted(missing)}")
    return Platform(hosts=hosts, links=links, routes=routes)
