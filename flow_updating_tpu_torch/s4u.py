"""Host-side actor runtime: SimGrid-S4U-style verbs for arbitrary Python actors.

Counterpart of ``flow_updating_tpu/s4u.py``, the port's own copy of the
host DES (pure Python: threads, a heap and a virtual clock; nothing of
torch runs here).  The reference's ``register_actor("peer", Peer)``
accepts ANY Python class (``flowupdating-collectall.py:156``); its actors
talk to the world through the S4U surface — ``this_actor.sleep_for/info/
error/exit``, ``Mailbox.by_name / get_async / put_async``, ``Comm.test/
wait/get_payload/cancel``, ``ActivitySet.push``, ``Actor.create/
kill_all``, ``Engine.clock`` (the full contact list in SURVEY.md §1 L1).
Per-actor Python bytecode cannot run on the card, so the port, like the
JAX package, gives it an explicit host-fidelity mode: a deterministic
discrete-event scheduler (one actor runnable at a time, virtual clock,
heap-ordered events — the sequential-maestro model SimGrid uses, SURVEY.md
N2) driving each actor on its own cooperatively scheduled thread.
``Engine(host_actors=True)`` selects it; the verbs here are
import-compatible with how the reference uses the ``simgrid`` module, so
porting an actor is an import swap:

    from flow_updating_tpu_torch import s4u as simgrid
    # this_actor, Mailbox, Comm, ActivitySet, Actor, Host, Engine.clock

It is a fidelity/compatibility tool, NOT the performance path: Python
actor bytecode runs at host speed.  Express hot protocols as
:class:`~flow_updating_tpu_torch.models.actor.VectorActor` tensor
programs (or use the built-ins) to run on the card.

Determinism comes from the handover, not from thread timing: exactly one
of {maestro, one actor} runs at any moment, and the maestro pops events
in ``(time, sequence)`` order.  Actor threads are daemons; :meth:`HostDes.
kill_all` plus :meth:`HostDes.shutdown` (which the engine calls when it is
dropped) wake and join every one still parked, so no leftover thread
keeps a process alive.

Network timing: a matched send completes ``latency + size/bandwidth``
after the put, using the platform's route between the two actors' hosts
when one exists (SimGrid's flow model, N3, simplified to the bottleneck
link of the static route); without platform data, delivery is immediate
(next scheduling point).
"""

from __future__ import annotations

import heapq
import itertools
import logging
import threading

logger = logging.getLogger("flow_updating_tpu_torch")

_TLS = threading.local()          # _TLS.ctx = running _ActorCtx
_CURRENT_DES: HostDes | None = None


class ActorKilled(BaseException):
    """Raised inside an actor at its next blocking call after kill.

    BaseException so a protocol's ``except Exception`` cannot swallow
    the termination (mirrors SimGrid force-kill semantics)."""


class CancelException(Exception):
    """Raised by ``Comm.wait()`` on a comm that was cancelled while still
    pending (SimGrid's ``CancelException``).  A cancel of an
    already-completed comm stays a no-op and ``wait()`` returns normally
    — the reference's quirk at ``collectall.py:78``."""


def _des() -> HostDes:
    if _CURRENT_DES is None:
        raise RuntimeError(
            "no host actor runtime is active — construct "
            "Engine(host_actors=True) and run inside its simulation")
    return _CURRENT_DES


def _ctx() -> _ActorCtx:
    ctx = getattr(_TLS, "ctx", None)
    if ctx is None:
        raise RuntimeError(
            "this verb must be called from inside a running actor")
    return ctx


class _ActorCtx:
    def __init__(self, des: HostDes, name: str, host: Host, fn, args):
        self.des = des
        self.name = name
        self.host = host
        self.fn = fn
        self.args = args
        self.evt = threading.Event()
        self.done = False
        self.killed = False
        self.thread = threading.Thread(
            target=self._main, name=f"s4u-actor-{name}", daemon=True)

    # -- cooperative handoff (exactly one of {maestro, one actor} runs) --
    def _main(self):
        self.evt.wait()
        self.evt.clear()
        _TLS.ctx = self
        try:
            if self.killed:
                raise ActorKilled()
            self.fn(*self.args)
        except ActorKilled:
            pass
        except Exception:
            logger.exception("actor %r died with an exception", self.name)
        finally:
            self.done = True
            self.des._emit("actor_exit", actor=self.name, killed=self.killed)
            self.des.maestro_evt.set()

    def yield_to_maestro(self):
        """Block this actor; run the maestro; resume when rescheduled."""
        self.des.maestro_evt.set()
        self.evt.wait()
        self.evt.clear()
        if self.killed:
            raise ActorKilled()

    def resume(self):
        """Maestro-side: run the actor until it blocks or finishes."""
        self.evt.set()
        self.des.maestro_evt.wait()
        self.des.maestro_evt.clear()


class Host:
    def __init__(self, name: str, speed: float = 0.0):
        self.name = name
        self.speed = speed

    def __repr__(self):
        return f"Host({self.name!r})"

    @staticmethod
    def by_name(name: str) -> Host:
        return _des().host(name)


class Comm:
    """Future for one asynchronous put/get (reference contact:
    ``collectall.py:74-79,123-125``)."""

    def __init__(self, des: HostDes, kind: str):
        self.des = des
        self.kind = kind              # 'send' | 'recv'
        self.payload = None
        self.finished = False
        self.cancelled = False
        self._waiter: _ActorCtx | None = None

    def test(self) -> bool:
        return self.finished

    def wait(self) -> Comm:
        ctx = _ctx()
        while not self.finished and not self.cancelled:
            self._waiter = ctx
            ctx.yield_to_maestro()
        self._waiter = None
        if self.cancelled and not self.finished:
            # SimGrid raises on waiting a cancelled activity; returning
            # payload None here would read as a successful zero-message
            # (ADVICE r5 #1)
            raise CancelException(
                f"{self.kind} comm was cancelled while pending")
        return self

    def get_payload(self):
        return self.payload

    def cancel(self) -> None:
        """Abort the operation if still pending/in flight.

        The reference cancels comms that already completed (the quirk at
        ``collectall.py:78``) — that stays a no-op.  A genuinely pending
        cancel detaches the comm: queued mailbox entries are skipped at
        match time and an in-flight delivery is dropped (both sides stay
        incomplete; Flow-Updating is loss-tolerant by design, A6).  An
        actor blocked in ``wait()`` on this comm is woken and observes
        :class:`CancelException` — without the wake it would stay parked
        until ``kill_all`` (ADVICE r5 #1)."""
        if not self.finished:
            self.cancelled = True
            if self._waiter is not None:
                self.des.make_ready(self._waiter)

    def _complete(self, payload=None) -> None:
        self.finished = True
        self.payload = payload
        if self._waiter is not None:
            self.des.make_ready(self._waiter)


class Mailbox:
    """Named rendezvous point (SURVEY.md N4)."""

    def __init__(self, des: HostDes, name: str):
        self.des = des
        self.name = name
        self._pending_puts: list = []   # (send_comm, payload, size, src_ctx)
        self._pending_gets: list = []   # recv Comm

    @staticmethod
    def by_name(name: str) -> Mailbox:
        return _des().mailbox(name)

    def _pop_live_get(self) -> Comm | None:
        while self._pending_gets:
            recv = self._pending_gets.pop(0)
            if not recv.cancelled:
                return recv
        return None

    def _pop_live_put(self):
        while self._pending_puts:
            entry = self._pending_puts.pop(0)
            if not entry[0].cancelled:
                return entry
        return None

    def put_async(self, payload, size: float = 0.0) -> Comm:
        des = self.des
        comm = Comm(des, "send")
        src = _ctx()
        recv = self._pop_live_get()
        if recv is not None:
            des.schedule_delivery(self, comm, recv, payload, size, src)
        else:
            self._pending_puts.append((comm, payload, size, src))
        return comm

    def get_async(self) -> Comm:
        des = self.des
        comm = Comm(des, "recv")
        entry = self._pop_live_put()
        if entry is not None:
            send, payload, size, src = entry
            des.schedule_delivery(self, send, comm, payload, size, src)
        else:
            self._pending_gets.append(comm)
        return comm


class ActivitySet:
    """Minimal S4U ActivitySet: tracks pending comms (the reference only
    pushes, ``collectall.py:123``)."""

    def __init__(self):
        self.activities: list = []

    def push(self, comm: Comm) -> None:
        self.activities.append(comm)
        # completed entries are dropped so the set cannot grow without
        # bound (the reference's own FIXME at collectall.py:122)
        self.activities = [c for c in self.activities if not c.finished]


class _ThisActor:
    """Module-level ``this_actor`` veneer (``collectall.py:27,67,85,96,148``)."""

    @staticmethod
    def get_host() -> Host:
        return _ctx().host

    @staticmethod
    def sleep_for(dt: float) -> None:
        ctx = _ctx()
        ctx.des.schedule_wake(ctx, dt)
        ctx.yield_to_maestro()

    @staticmethod
    def info(msg: str) -> None:
        des = _des()
        logger.info("[%s:%s] %s", f"{des.clock:.6f}", _ctx().name, msg)

    @staticmethod
    def error(msg: str) -> None:
        des = _des()
        logger.error("[%s:%s] %s", f"{des.clock:.6f}", _ctx().name, msg)

    @staticmethod
    def exit() -> None:
        raise ActorKilled()


this_actor = _ThisActor()


class Actor:
    """``Actor.create`` / ``Actor.kill_all`` (``collectall.py:162,145``)."""

    @staticmethod
    def create(name: str, host: Host, fn, *args) -> _ActorCtx:
        return _des().spawn(name, host, fn, args)

    @staticmethod
    def kill_all() -> None:
        _des().kill_all(except_ctx=getattr(_TLS, "ctx", None))


class _EngineMeta(type):
    @property
    def clock(cls) -> float:       # mirrors static ``Engine.clock``
        return _des().clock


class Engine(metaclass=_EngineMeta):
    """Static-clock shim so reference-style ``Engine.clock`` reads the
    active runtime's virtual time (``pairwise.py:87,111``)."""


class HostDes:
    """Deterministic sequential-maestro DES over actor threads.

    ``event_log`` (an :class:`~flow_updating_tpu_torch.utils.eventlog.EventLog`)
    turns on actor/comm lifecycle records — ``actor_spawn``/``actor_exit``,
    ``comm_put``/``comm_deliver``/``comm_drop`` — the raw material of the
    Perfetto trace exporter (:mod:`flow_updating_tpu_torch.obs.trace`), the
    runtime's answer to SimGrid's Paje tracing."""

    def __init__(self, platform=None, event_log=None):
        self.clock = 0.0
        self.platform = platform
        self.event_log = event_log
        self.hosts: dict = {}
        self.mailboxes: dict = {}
        self.actors: list = []
        self.heap: list = []           # (time, seq, callback)
        self.seq = itertools.count()
        self.comm_seq = itertools.count()
        self.maestro_evt = threading.Event()
        if platform is not None:
            for name, speed in getattr(platform, "hosts", {}).items():
                self.hosts[name] = Host(name, speed)

    def _emit(self, kind: str, **fields) -> None:
        if self.event_log is not None:
            self.event_log.emit(kind, t=round(self.clock, 9), **fields)

    # -- registry -------------------------------------------------------
    def host(self, name: str) -> Host:
        if name not in self.hosts:
            self.hosts[name] = Host(name)
        return self.hosts[name]

    def mailbox(self, name: str) -> Mailbox:
        if name not in self.mailboxes:
            self.mailboxes[name] = Mailbox(self, name)
        return self.mailboxes[name]

    # -- scheduling -----------------------------------------------------
    def _push(self, dt: float, callback) -> None:
        heapq.heappush(self.heap,
                       (self.clock + max(dt, 0.0), next(self.seq), callback))

    def spawn(self, name: str, host: Host, fn, args) -> _ActorCtx:
        ctx = _ActorCtx(self, name, host, fn, args)
        self.actors.append(ctx)
        self._emit("actor_spawn", actor=name, host=host.name)
        ctx.thread.start()
        self._push(0.0, lambda: self._resume(ctx))
        return ctx

    def schedule_wake(self, ctx: _ActorCtx, dt: float) -> None:
        self._push(dt, lambda: self._resume(ctx))

    def make_ready(self, ctx: _ActorCtx) -> None:
        self._push(0.0, lambda: self._resume(ctx))

    def schedule_delivery(self, mbox: Mailbox, send: Comm, recv: Comm,
                          payload, size: float, src: _ActorCtx) -> None:
        delay = self._net_delay(src, mbox, size)
        cid = next(self.comm_seq)
        self._emit("comm_put", cid=cid, mailbox=mbox.name, src=src.name,
                   size=float(size))

        def deliver():
            if send.cancelled or recv.cancelled:
                self._emit("comm_drop", cid=cid, mailbox=mbox.name)
                return          # detached mid-flight: message dropped
            self._emit("comm_deliver", cid=cid, mailbox=mbox.name,
                       src=src.name)
            send._complete()
            recv._complete(payload)

        self._push(delay, deliver)

    def _net_delay(self, src: _ActorCtx, mbox: Mailbox, size: float) -> float:
        """latency + size/bottleneck-bandwidth over the platform route
        between the sender's host and the receiver mailbox's owner host
        (mailbox names are peer names in the reference's convention);
        0 when the platform doesn't describe the pair."""
        plat = self.platform
        if plat is None:
            return 0.0
        # receiver host: the actor listening under the mailbox's name
        # (the reference's convention — each peer's mailbox is its name)
        dst_host = None
        for ctx in self.actors:
            if ctx.name == mbox.name:
                dst_host = ctx.host.name
                break
        if dst_host is None:
            return 0.0
        lat = plat.route_latency(src.host.name, dst_host, default=0.0)
        bw = plat.route_bandwidth(src.host.name, dst_host)
        return lat + (float(size) / bw if bw and bw != float("inf") else 0.0)

    def _resume(self, ctx: _ActorCtx) -> None:
        if not ctx.done:
            ctx.resume()

    def kill_all(self, except_ctx: _ActorCtx | None = None) -> None:
        for ctx in self.actors:
            if ctx is except_ctx or ctx.done:
                continue
            ctx.killed = True
            # wake it so the pending blocking call raises ActorKilled
            self._push(0.0, lambda c=ctx: self._resume(c))

    def shutdown(self, timeout: float = 5.0) -> None:
        """Tear the runtime down: every actor still parked (or never
        scheduled) is killed and resumed at once, so its pending blocking
        call raises :class:`ActorKilled` and its thread ends; then every
        thread is joined (``timeout`` seconds each).  Called by the
        engine when it is dropped; calling it twice is harmless."""
        for ctx in self.actors:
            if ctx.done:
                continue
            ctx.killed = True
            if ctx.thread.is_alive():
                ctx.resume()
        for ctx in self.actors:
            ctx.thread.join(timeout)
        self.heap.clear()

    # -- main loop ------------------------------------------------------
    def run_until(self, t_end: float) -> None:
        global _CURRENT_DES
        prev = _CURRENT_DES
        _CURRENT_DES = self
        try:
            while self.heap and self.heap[0][0] <= t_end:
                t, _seq, callback = heapq.heappop(self.heap)
                self.clock = t
                callback()
            self.clock = max(self.clock, t_end)
        finally:
            _CURRENT_DES = prev
