"""Discrete-event simulation clock: exactly-reproducible virtual time.

``VirtualClock`` (core/backend.py) credits each ``sleep`` instantly and
approximates the schedule's critical path with per-thread accounting —
fast, but the *interleaving* of real threads still decides who executes
what, so makespans, steal counts and per-worker loads vary run to run,
and CI guards had to pace with scaled real sleeps just to keep the OS
scheduler honest (``PacedVirtualClock``), capping them below
``REPRO_BENCH_SCALE=1.0``.

``SimClock`` replaces the approximation with a cooperative discrete-event
simulation over the *real* engine threads:

* every participating thread (the benchmark driver + the executor's pool
  workers) is an **actor**; exactly one actor runs at a time (the
  "token"), so every lock acquisition, shard pop, steal and fuse decision
  happens in a deterministic order — the whole schedule is a pure
  function of the op stream and the latency model's seed;
* ``sleep(dt)`` parks the calling actor on the event queue with a wake
  deadline ``now + dt`` and hands the token to the next runnable actor;
  virtual time advances **only** when no actor is runnable, jumping to
  the earliest deadline — milliseconds of wall time simulate any modelled
  timescale at any scale;
* blocking points that are *not* modelled time (a worker parking on the
  scheduler's ready condition, the driver waiting on a sync op's
  completion event or the in-flight budget) bracket their real wait with
  ``block_begin()`` / ``block_end()`` so the simulation knows the actor
  is off the timeline and time may advance past it;
* parking/wakeup and steal probes are charged on the virtual timeline
  too (``wake_latency_s``, ``steal_probe_s``) — the dispatch layer's
  bookkeeping costs are modelled, not just the backend roundtrips.

Determinism contract: with the token held by one actor at a time, ties
between runnable actors are broken by (thread name, attach order), and
the latency model's RNG draws happen in token order — two same-seed runs
produce byte-identical schedules, makespans and per-worker loads (the
``dispatch_guard``/``walk_guard`` determinism regression relies on
this).  Callers that must never block another actor in *real* time while
holding the token (the rule that keeps the simulation deadlock-free):
never call ``sleep`` while holding a lock another actor can contend.

Usage::

    clock  = SimClock()
    remote = LatencyBackend(InMemoryBackend(), LatencyModel(...),
                            clock=clock)
    fs     = CannyFS(remote, workers=8)   # auto-discovers the SimClock:
    ...                                   # driver + workers attach
    fs.close()                            # quiesces; workers detach
    clock.makespan()                      # elapsed virtual seconds

The engine attaches the constructing thread and its pool workers
automatically; standalone use (unit tests, hand-rolled harnesses) can
``attach()``/``detach()`` explicitly or rely on ``sleep``'s transient
auto-attach.
"""
from __future__ import annotations

import itertools
import threading
from typing import Optional

from .backend import Clock

# actor states
_RUNNING, _READY, _SLEEPING, _BLOCKED = range(4)


class _Actor:
    __slots__ = ("ident", "name", "order", "state", "deadline", "nest",
                 "channel", "bseq")

    def __init__(self, ident: int, name: str, order: int):
        self.ident = ident
        self.name = name
        self.order = order          # attach order: tie-break after name
        self.state = _READY
        self.deadline = 0.0
        self.nest = 1               # attach() nesting depth
        self.channel = None         # what a _BLOCKED actor waits on
        self.bseq = 0               # FIFO order within the channel


class SimClock(Clock):
    """Deterministic discrete-event clock (see module docstring).

    ``wake_latency_s`` is charged each time a parked worker resumes (the
    modelled cost of the parking-lot handoff); ``steal_probe_s`` each
    time a worker pops from a non-owned shard (the modelled cost of the
    probe walk).  Both default tiny-but-nonzero so the dispatch layer's
    costs exist on the timeline without drowning the backend RTTs."""

    #: marks the clock as discrete-event: LatencyBackend switches its
    #: server-slot semaphore to a virtual-timeline queue model, and the
    #: engine wires park/steal/sync-wait hooks through the scheduler
    discrete_event = True

    def __init__(self, start: float = 0.0, *,
                 wake_latency_s: float = 1e-6,
                 steal_probe_s: float = 1e-7):
        self._cv = threading.Condition()
        self._start = float(start)
        self._now = float(start)
        self.wake_latency_s = float(wake_latency_s)
        self.steal_probe_s = float(steal_probe_s)
        self._actors: dict[int, _Actor] = {}
        self._running: Optional[int] = None   # ident of the token holder
        self._order = itertools.count()
        self._bseq = itertools.count()        # channel-FIFO block stamps
        self._busy: dict[str, float] = {}     # per-actor virtual busy time

    # ------------------------------------------------------------------
    # participation
    # ------------------------------------------------------------------

    def attach(self, name: str | None = None) -> None:
        """Join the simulation: the calling thread becomes an actor and
        blocks until it is granted the run token.  Nested attaches from
        the same thread count and must be matched by detaches."""
        ident = threading.get_ident()
        with self._cv:
            a = self._actors.get(ident)
            if a is not None:
                a.nest += 1
                return
            a = _Actor(ident, name or threading.current_thread().name,
                       next(self._order))
            self._actors[ident] = a
            self._cv.notify_all()       # wait_attached() watchers
            self._schedule_locked()
            while a.state != _RUNNING:
                self._cv.wait()

    def detach(self) -> None:
        """Leave the simulation (releasing the token if held).  No-op for
        threads that never attached; nested attaches unwind first."""
        ident = threading.get_ident()
        with self._cv:
            a = self._actors.get(ident)
            if a is None:
                return
            if a.nest > 1:
                a.nest -= 1
                return
            del self._actors[ident]
            if self._running == ident:
                self._running = None
            self._schedule_locked()
            self._cv.notify_all()

    def attached(self) -> bool:
        with self._cv:
            return threading.get_ident() in self._actors

    def wait_attached(self, n: int) -> None:
        """Block (holding the token) until ``n`` actors are registered —
        the engine calls this after spawning its pool so the actor set is
        identical at every driver yield point, run to run."""
        with self._cv:
            while len(self._actors) < n:
                self._cv.wait()

    # ------------------------------------------------------------------
    # the event queue
    # ------------------------------------------------------------------

    def _schedule_locked(self) -> None:
        """Grant the token to the next runnable actor; if none is runnable
        but some are sleeping, advance virtual time to the earliest wake
        deadline first.  All-blocked (or empty) is not an error: a real
        wakeup (event set, condition notify, a new attach) will
        reschedule."""
        if self._running is not None:
            return
        actors = self._actors.values()
        ready = [a for a in actors if a.state == _READY]
        if not ready:
            sleepers = [a for a in actors if a.state == _SLEEPING]
            if not sleepers:
                return
            self._now = max(self._now, min(a.deadline for a in sleepers))
            for a in sleepers:
                if a.deadline <= self._now:
                    a.state = _READY
            ready = [a for a in actors if a.state == _READY]
        nxt = min(ready, key=lambda a: (a.name, a.order))
        nxt.state = _RUNNING
        self._running = nxt.ident
        self._cv.notify_all()

    def _yield_as(self, a: _Actor, state: int) -> None:
        """Move the calling (token-holding) actor to ``state`` and hand
        the token on.  Caller holds ``_cv``."""
        if self._running == a.ident:
            self._running = None
        a.state = state
        self._schedule_locked()

    def _wait_for_token(self, a: _Actor) -> None:
        while a.state != _RUNNING:
            self._cv.wait()

    # ------------------------------------------------------------------
    # Clock interface
    # ------------------------------------------------------------------

    def now(self) -> float:
        with self._cv:
            return self._now

    def sleep(self, dt: float) -> None:
        """Advance this actor ``dt`` virtual seconds: park on the event
        queue and yield the token; wake when virtual time reaches the
        deadline.  Unattached threads are attached for the duration of
        the call (convenience for standalone use)."""
        if dt <= 0:
            return
        ident = threading.get_ident()
        transient = False
        with self._cv:
            a = self._actors.get(ident)
            if a is None:
                transient = True
                a = _Actor(ident, threading.current_thread().name,
                           next(self._order))
                self._actors[ident] = a
                self._cv.notify_all()
                self._schedule_locked()
                self._wait_for_token(a)
            self._busy[a.name] = self._busy.get(a.name, 0.0) + dt
            a.deadline = self._now + dt
            self._yield_as(a, _SLEEPING)
            self._wait_for_token(a)
            if transient:
                del self._actors[ident]
                if self._running == ident:
                    self._running = None
                self._schedule_locked()
                self._cv.notify_all()

    # ------------------------------------------------------------------
    # external-wait brackets (scheduler / engine hooks)
    # ------------------------------------------------------------------

    def block_begin(self, channel: object = None) -> None:
        """The calling actor is about to block on something *outside* the
        virtual timeline (a condition wait for work, a completion event).
        Yields the token immediately and returns — the caller then enters
        its real wait.  Call while still holding the lock the real wait
        releases, so the token's next holder cannot slip a notify in
        before the wait begins (no lost wakeups).

        ``channel`` identifies *what* is being waited on (the condition
        object, the event); the waking side calls ``wake(channel, n)`` —
        from the token holder, so the READY transition happens in token
        order, not whenever the waiter's real thread gets scheduled.  A
        waiter whose real wait can end without any sim-side waker (e.g. a
        thread join) may pass no channel and relies on ``block_end``'s
        self-wake, which is deterministic only when no runnable actor
        raced it — the engine uses that solely for final teardown."""
        with self._cv:
            a = self._actors.get(threading.get_ident())
            if a is None:
                return
            a.channel = channel
            a.bseq = next(self._bseq)
            self._yield_as(a, _BLOCKED)

    def block_end(self) -> None:
        """The real wait returned: rejoin the runnable set and block until
        the token is granted again.  Call *after* releasing the lock the
        real wait re-acquired (a token-less actor must never hold a lock
        a running actor can contend).  If a ``wake`` already moved this
        actor to READY (or granted it), only the token wait remains."""
        with self._cv:
            a = self._actors.get(threading.get_ident())
            if a is None:
                return
            if a.state == _BLOCKED:
                a.channel = None
                a.state = _READY
                self._schedule_locked()
            self._wait_for_token(a)

    def wake(self, channel: object, n: Optional[int] = None) -> int:
        """Move up to ``n`` actors blocked on ``channel`` (all, when None)
        to READY, oldest block first, and return how many moved.  Called
        by the waking side *together with* its real notify/set, from the
        token holder, so the handoff is part of the deterministic
        schedule: CPython conditions wake waiters FIFO, and blocked-stamp
        order equals real wait-entry order (block_begin happens under the
        condition's own lock), so sim and real pick the same threads."""
        with self._cv:
            blocked = sorted((a for a in self._actors.values()
                              if a.state == _BLOCKED and a.channel is channel),
                             key=lambda a: a.bseq)
            if n is not None:
                blocked = blocked[:n]
            for a in blocked:
                a.channel = None
                a.state = _READY
            if blocked and self._running is None:
                self._schedule_locked()
            return len(blocked)

    def wait_event(self, event: threading.Event) -> None:
        """Hooked ``Event.wait``: yields the token around the real wait so
        virtual time can advance past this actor while it waits for a
        completion set by another actor (who must pair ``event.set()``
        with ``wake(event)``).  Safe for unattached threads (plain
        wait)."""
        if event.is_set():
            return
        with self._cv:
            a = self._actors.get(threading.get_ident())
            if a is None:
                event.wait()
                return
            a.channel = event
            a.bseq = next(self._bseq)
            self._yield_as(a, _BLOCKED)
        event.wait()
        self.block_end()

    # ------------------------------------------------------------------
    # measurement
    # ------------------------------------------------------------------

    def makespan(self) -> float:
        """Elapsed virtual seconds — the simulated schedule's true
        critical path (idle gaps included), not the per-thread
        approximation ``VirtualClock.makespan`` returns."""
        with self._cv:
            return self._now - self._start

    def thread_seconds(self) -> dict[str, float]:
        """Per-actor virtual busy seconds, keyed by *thread name* (stable
        across runs, unlike idents): how evenly the schedule spread its
        modelled service time."""
        with self._cv:
            return dict(self._busy)


__all__ = ["SimClock"]
