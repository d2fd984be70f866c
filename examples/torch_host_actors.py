#!/usr/bin/env python
"""Arbitrary Python actors on the PyTorch port's host-fidelity runtime.

``examples/host_actors.py`` with one import swapped: the actors below are
written against :mod:`flow_updating_tpu_torch.s4u`, and the engine is the
port's ``Engine(host_actors=True)``.  The reference registers a plain
Python class as the actor behavior (``flowupdating-collectall.py:156``);
the card cannot run Python bytecode, but the deterministic host DES can,
with the verbs the reference uses (``this_actor``, ``Mailbox``, ``Comm``,
``ActivitySet``, ``Actor``, ``Engine.clock``).  This example runs a
user-written collect-all Flow-Updating ``Peer`` end to end,
reference-workflow style.  Nothing here touches the card.

This is the fidelity/compatibility path, not the performance path: for
speed, use the built-in kernels or a VectorActor (see README).

Run:  python examples/torch_host_actors.py [--until 400]
"""

import argparse
import logging
import os
import sys

try:
    import flow_updating_tpu_torch  # noqa: F401
except ImportError:
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from flow_updating_tpu_torch import s4u
from flow_updating_tpu_torch.engine import Engine

HERE = os.path.dirname(os.path.abspath(__file__))

global_values: dict = {}


class Peer:
    """Collect-all Flow-Updating written against the s4u verbs (the
    protocol per SURVEY.md A4/A6/A7; see tests/test_torch_s4u.py)."""

    TICK_TIMEOUT = 20

    def __init__(self, value, neighbors=""):
        self.value = float(value)
        self.neighbor_names = [n for n in str(neighbors).split(",") if n]

    def __call__(self):
        self.name = s4u.this_actor.get_host().name
        self.mailbox = s4u.Mailbox.by_name(self.name)
        self.peers = {n: s4u.Mailbox.by_name(n) for n in self.neighbor_names}
        self.flows = {n: 0.0 for n in self.neighbor_names}
        self.estimates = {n: 0.0 for n in self.neighbor_names}
        self.heard, self.ticks = set(), 0
        self.pending = s4u.ActivitySet()
        global_values.setdefault("value", {})[self.name] = self.value
        comm = None
        s4u.this_actor.info("peer up")
        while True:
            if comm is None:
                comm = self.mailbox.get_async()
            if comm.test():
                msg = comm.wait().get_payload()
                comm = None
                self.on_receive(*msg)
            self.ticks += 1
            if self.ticks >= self.TICK_TIMEOUT:
                self.avg_and_send()
            s4u.this_actor.sleep_for(1.0)

    def on_receive(self, sender, flow, estimate):
        if sender not in self.peers:
            s4u.this_actor.error(f"adopting unknown neighbor {sender}")
            self.peers[sender] = s4u.Mailbox.by_name(sender)
            self.flows[sender] = self.estimates[sender] = 0.0
        self.estimates[sender] = estimate
        self.flows[sender] = -flow
        self.heard.add(sender)
        if self.heard.issuperset(self.peers):
            self.avg_and_send()

    def avg_and_send(self):
        estimate = self.value - sum(self.flows.values())
        avg = (estimate + sum(self.estimates.values())) \
            / (len(self.peers) + 1)
        global_values.setdefault("last_avg", {})[self.name] = avg
        for n, mbox in self.peers.items():
            self.flows[n] += avg - self.estimates[n]
            self.estimates[n] = avg
            self.pending.push(
                mbox.put_async((self.name, self.flows[n], avg), 104))
        self.heard, self.ticks = set(), 0


class PairwisePeer(Peer):
    """Pairwise Flow-Updating on the same verb surface: every received
    message immediately triggers a 2-party average with that sender
    only, plus per-neighbor staleness re-initiation (SURVEY.md A5)."""

    STALENESS = 20.0

    def __call__(self):
        self.name = s4u.this_actor.get_host().name
        self.mailbox = s4u.Mailbox.by_name(self.name)
        self.peers = {n: s4u.Mailbox.by_name(n) for n in self.neighbor_names}
        self.flows = {n: 0.0 for n in self.neighbor_names}
        self.estimates = {n: 0.0 for n in self.neighbor_names}
        self.last_exchange = {n: 0.0 for n in self.neighbor_names}
        self.pending = s4u.ActivitySet()
        global_values.setdefault("value", {})[self.name] = self.value
        comm = None
        s4u.this_actor.info("pairwise peer up")
        while True:
            if comm is None:
                comm = self.mailbox.get_async()
            if comm.test():
                msg = comm.wait().get_payload()
                comm = None
                self.on_receive(*msg)
            for n in list(self.peers):
                if self.last_exchange[n] < s4u.Engine.clock - self.STALENESS:
                    self.avg_and_send(n)
            s4u.this_actor.sleep_for(1.0)

    def on_receive(self, sender, flow, estimate):
        if sender not in self.peers:
            s4u.this_actor.error(f"adopting unknown neighbor {sender}")
            self.peers[sender] = s4u.Mailbox.by_name(sender)
            self.flows[sender] = self.estimates[sender] = 0.0
            self.last_exchange[sender] = 0.0
        self.estimates[sender] = estimate
        self.flows[sender] = -flow
        self.avg_and_send(sender)

    def avg_and_send(self, neighbor):
        estimate = self.value - sum(self.flows.values())
        avg = (self.estimates[neighbor] + estimate) / 2.0
        global_values.setdefault("last_avg", {})[self.name] = avg
        self.flows[neighbor] += avg - self.estimates[neighbor]
        self.estimates[neighbor] = avg
        self.last_exchange[neighbor] = s4u.Engine.clock
        self.pending.push(self.peers[neighbor].put_async(
            (self.name, self.flows[neighbor], avg), 104))


def watcher(deadline, every):
    while s4u.Engine.clock < deadline:
        s4u.this_actor.sleep_for(min(every, deadline - s4u.Engine.clock))
        for key, vals in sorted(global_values.items()):
            s4u.this_actor.info(f"{key}: " + ", ".join(
                f"{h}={v:.4f}" for h, v in sorted(vals.items())))
    s4u.Actor.kill_all()
    s4u.this_actor.exit()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--until", type=float, default=400.0)
    ap.add_argument("--variant", default="collectall",
                    choices=("collectall", "pairwise"))
    args = ap.parse_args()
    logging.basicConfig(level=logging.INFO, format="%(message)s")

    eng = Engine(host_actors=True, device="cpu")
    eng.load_platform(os.path.join(HERE, "platforms/small6.xml"))
    eng.register_actor(
        "peer", Peer if args.variant == "collectall" else PairwisePeer)
    eng.load_deployment(os.path.join(HERE, "deployments/small6_actors.xml"))
    eng.netzone_root.add_host("observer", 25e6)
    s4u.Actor.create("watcher", s4u.Host.by_name("observer"),
                     watcher, args.until, 10.0)
    eng.run_until(args.until + 100.0)
    mean = sum(global_values["value"].values()) / len(global_values["value"])
    print(f"true mean {mean:.4f}; last_avg: " + ", ".join(
        f"{h}={v:.4f}" for h, v in sorted(global_values["last_avg"].items())))


if __name__ == "__main__":
    main()
