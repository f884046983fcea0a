"""Executor layer: worker models that drain the scheduler's ready queue.

Two models, unchanged semantics from the seed engine:

* ``pool``          — N recycled workers (the paper's stated future work);
* ``thread_per_op`` — one fresh thread per ready op (the paper's actual
  implementation: "high number of threads created and scrapped", kept for
  faithful overhead comparisons).

An executor knows nothing about paths, dependencies or fusion: it pulls
ready ops and hands them to the engine's ``run`` callback, which executes
the op and reports completion back to the scheduler.

Discrete-event mode (core/simclock.py): pool workers register with the
simulation for their whole lifetime — ``attach()`` before the first pop,
``detach()`` on the way out — so the event queue always knows exactly
which actors exist and the schedule is a pure function of the op stream.
``thread_per_op`` spawns an unbounded, timing-dependent set of threads
and is rejected under a SimClock (the engine enforces this).
"""
from __future__ import annotations

import threading
from typing import Callable

from .scheduler import OpScheduler, _Op

EXECUTOR_MODES = ("pool", "thread_per_op")


class PoolExecutor:
    """Workers are numbered: worker ``i`` of ``W`` pulls from its owned
    ready-queue shards first and steals from the rest when dry (see the
    scheduler's dispatch architecture)."""

    def __init__(self, sched: OpScheduler, run: Callable[[_Op], None],
                 workers: int = 32, sim=None):
        self._threads = []
        nworkers = max(1, int(workers))
        self.nworkers = nworkers
        for i in range(nworkers):
            t = threading.Thread(target=self._worker_loop,
                                 args=(sched, run, i, nworkers, sim),
                                 name=f"cannyfs-w{i}", daemon=True)
            t.start()
            self._threads.append(t)

    @staticmethod
    def _worker_loop(sched: OpScheduler, run: Callable[[_Op], None],
                     worker: int, workers: int, sim) -> None:
        if sim is not None:
            sim.attach()
        try:
            while True:
                op = sched.next_ready(worker, workers)
                if op is None:
                    return
                run(op)
        finally:
            if sim is not None:
                sim.detach()

    def join(self) -> None:
        for t in self._threads:
            t.join()


class ThreadPerOpExecutor:
    def __init__(self, sched: OpScheduler, run: Callable[[_Op], None],
                 workers: int = 0, sim=None):   # workers ignored
        self.nworkers = 0
        t = threading.Thread(target=self._dispatcher_loop, args=(sched, run),
                             name="cannyfs-dispatch", daemon=True)
        t.start()
        self._threads = [t]

    @staticmethod
    def _dispatcher_loop(sched: OpScheduler, run: Callable[[_Op], None]) -> None:
        while True:
            op = sched.next_ready()
            if op is None:
                return
            threading.Thread(target=run, args=(op,), daemon=True).start()

    def join(self) -> None:
        for t in self._threads:
            t.join()


def make_executor(mode: str, sched: OpScheduler,
                  run: Callable[[_Op], None], workers: int, sim=None):
    if mode == "pool":
        return PoolExecutor(sched, run, workers, sim=sim)
    if mode == "thread_per_op":
        return ThreadPerOpExecutor(sched, run)
    raise ValueError(f"unknown executor: {mode!r}")
