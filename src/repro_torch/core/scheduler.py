"""Scheduler layer: per-path FIFO + cross-path DAG edges, sharded by path.

This is the bottom third of the engine split (scheduler / optimizer /
executor).  It owns *which op may run when* and nothing else:

* per-path FIFO order via a ``last_op`` map (two ops touching the same path
  execute in submission order);
* cross-path edges for the cases per-path order cannot see (create under a
  pending mkdir, readdir racing child creation, rename spanning two paths);
* the in-flight budget (submission blocks at ``max_inflight``), the
  per-shard ready queues the executor drains, and the poison/close
  lifecycle.

Dispatch architecture
---------------------

PR 2 sharded *submission* state; dispatch still funnelled every ready op
through one global deque + condition variable, so at high worker counts
the scheduler itself became the latency the engine claims to hide.  Ready
ops now live in per-shard deques aligned to the path-hash shards:

* a ready op is enqueued on its first path's home shard;
* pool worker ``i`` of ``W`` owns the shards ``s`` with ``s % W == i`` and
  pops from them FIFO (every shard has exactly one owner, so stealing off
  still drains everything);
* a worker whose owned shards are dry *steals* from the tail of a victim
  shard's deque (``stats.steals``); stealing is what keeps uneven per-shard
  load balanced across the pool;
* each shard additionally carries a **low-priority lane** (``rq_lo``) for
  *speculative* ops — the metadata-prefetch pipeline's advisory batch
  reads (``submit_speculative``): budget-counted and drained like any
  other op (poison/close/drain all see them), but taking and granting no
  DAG edges, popped (and stolen) only when every normal lane in reach is
  dry, and never recorded in the ledger — prefetch work fills
  otherwise-idle workers and nothing else;
* only when every shard is empty does a worker fall back to the single
  parking lot — one condition variable on the control lock
  (``stats.parks``).  Producers take the control lock only to wake parked
  workers, so the busy-pool fast path never touches a global lock to pop.

Multi-tenant fair dispatch + admission control (PR 10)
------------------------------------------------------

With tenants registered (``register_tenant``; a zero-tenant engine takes
exactly the legacy paths above, byte-identical schedules included), every
ready-lane pop — owned-shard head and steal tail alike — honours a
**deficit-weighted round-robin credit** per tenant: an op whose tenant
holds ``deficit >= 1`` dispatches and spends one credit
(``TenantStats.credits_spent``); when a lane holds only broke tenants'
ops, every tenant's deficit is replenished in proportion to its weight
(the lowest weight maps to exactly one credit per round; accumulation is
capped at four rounds so an idle tenant cannot bank an unbounded burst)
and the scan re-runs — one replenish always funds a pop.  Untenanted
ops (engine-internal work: spill chunks, prefetch batches) always
dispatch.  A tenant's burst therefore cannot starve a neighbour's
latency: each round interleaves dispatch weight-proportionally however
deep any single backlog runs.  A steal that dispatches a tenant's op
additionally counts ``TenantStats.steals_served`` — the cross-worker
capacity the engine donated to that tenant.

Admission control composes two releases ahead of blocking.  At global
in-flight saturation the submitter first **sheds** the oldest queued
speculative op — the low-priority lanes are advisory by contract
(prefetch/read-ahead/spill chunks re-issue or degrade, never corrupt) —
retiring it cancelled and taking its budget slot
(``stats.admission_sheds``).  Only when nothing is sheddable does the
submitter block, and then **per-tenant backpressure** applies: a tenant
over its weight-share of the budget keeps waiting while an under-share
tenant is parked on the budget too, so one tenant saturating the window
backpressures its own submits, never a neighbour's (completions
broadcast the budget condition in tenant mode so the under-share waiter
always gets its look).

Lock architecture
-----------------

The seed engine serialized *all* submit/complete traffic under one global
lock.  Here submission state is sharded by path hash: each shard's lock
protects only that shard's ``last_op`` and ``pending_children`` maps, so
disjoint-path submissions and completions proceed in parallel.  A small
control lock remains for the in-flight budget, the parking lot and
lifecycle flags; it is held only for counter updates and parking, never
while wiring dependencies.

Lock order (never acquired in reverse): shard locks (ascending index)
-> per-op ``flock`` -> control lock -> per-shard ready-queue ``rlock``
(the deepest leaf: a parked worker rescans the ready deques while holding
the control lock, so an rlock holder must never wait on anything).  Leaf
locks (stat cache, ledger, fusion stats) nest under any of these.

PR 10 additions keep that order: per-tenant DWRR ``deficit`` counters
(and the credit/steal tallies on ``TenantStats``) are mutated only while
holding a ready-queue ``rlock`` — cooperatively serialized in sim mode,
advisory under real threads — and never take another lock; per-tenant
``inflight``/``waiting``/``poisoned`` bookkeeping lives strictly under
the control lock, exactly like the global budget it refines.  The
admission-control shed pops a speculative lane under ctl -> rlock, the
already-legal rescan nesting.

Per-op flags (``claimed``/``sealed``/``elided``/``completed``) live under
the op's own ``flock`` so the optimizer can mutate a pending op's payload
race-free against the executor claiming it:

* ``claimed``  — an executor owns the op; its payload is frozen.
* ``sealed``   — an observation point (read / barrier / any sync op) has
  scheduled a wait on this op; it must execute exactly as submitted.
  Observation classification is per-*answer*, not per-call: a readdir or
  stat satisfied by the namespace overlay (core/namespace.py) never
  reaches the scheduler and seals nothing; only an overlay miss submits
  the sync op that pins its dependencies.
* ``elided``   — the optimizer proved the op's effects are invisible at
  every observation point (e.g. writes to a path unlinked in the same
  window); the executor completes it without touching the backend.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Any, Callable, Optional

from .backend import is_under, norm_path, parent_of
from .errors import EnginePoisonedError

# ops that change the namespace under their parent directory — a readdir /
# rmdir / rename of the parent must wait for *all* of these (siblings do not
# chain with each other, so per-path order alone cannot express this).
STRUCTURAL = {"mkdir", "rmdir", "create", "unlink", "rename", "symlink",
              "link", "remove_tree"}
# ops that must observe a complete namespace under their own path.  A fused
# remove_tree lists every covered entry in its paths, so this edge also
# orders it after any pending straggler beneath the tree.
NEEDS_CHILDREN = {"rmdir", "readdir", "rename", "remove_tree"}

DEFAULT_SHARDS = 16


class _TenantState:
    """Scheduler-side record of one registered tenant: the DWRR credit,
    the per-tenant slice of the in-flight budget, and the tenant-scoped
    poison flag.  ``stats`` is the engine's ``TenantStats`` sub-snapshot
    (a leaf: counters bumped under rlock/ctl, never read under a lock
    the snapshot path takes).  See the module docstring for which lock
    guards which field."""

    __slots__ = ("name", "weight", "stats", "deficit", "inflight",
                 "waiting", "poisoned", "spill")

    def __init__(self, name: str, weight: float, stats):
        self.name = name
        self.weight = max(1e-6, float(weight))
        self.stats = stats
        self.deficit = 1.0      # DWRR credit (rlock; see docstring)
        self.inflight = 0       # admitted, not yet completed (ctl)
        self.waiting = 0        # submitters parked on the budget (ctl)
        self.poisoned = False   # tenant-scoped abort_on_error (ctl)
        self.spill = None       # the tenant's own SpillManager, if armed


class _Op:
    __slots__ = ("seq", "kind", "paths", "fn", "done", "error", "result",
                 "remaining_deps", "dependents", "cancelled", "submitted_at",
                 "started_at", "finished_at", "eager", "region",
                 "flock", "completed", "claimed", "sealed", "elided",
                 "payload", "prev_same_path", "wired", "speculative",
                 "tenant")

    def __init__(self, seq: int, kind: str, paths: tuple[str, ...],
                 fn: Callable[[], Any], eager: bool = True,
                 region: object = None, payload: object = None,
                 tenant: Optional[_TenantState] = None):
        self.seq = seq
        self.kind = kind
        self.paths = paths
        self.fn = fn
        self.eager = eager
        self.region = region  # active Transaction at submission, if any
        self.done = threading.Event()
        self.error: BaseException | None = None
        self.result: Any = None
        self.remaining_deps = 0
        self.dependents: list[_Op] = []
        self.cancelled = False
        self.submitted_at = time.monotonic()
        self.started_at = 0.0
        self.finished_at = 0.0
        # -- optimizer state (guarded by flock) --
        self.flock = threading.Lock()
        self.completed = False        # dependents released; op is history
        self.claimed = False          # an executor owns it; payload frozen
        self.sealed = False           # an observation point pinned it
        self.elided = False           # optimizer removed it from the stream
        self.payload = payload        # fusable payload (fusion.py), or None
        self.prev_same_path: Optional[_Op] = None  # chain link for peepholes
        # wiring stamp: drawn while the op still holds its shard locks at
        # the end of dependency wiring.  Cross-shard edges added *outside*
        # an op's own locked region (the rename chain-tip pass) may only
        # point at ops with a smaller stamp — every edge then strictly
        # decreases the stamp, which keeps the DAG acyclic (0 = unwired).
        self.wired = 0
        # speculative (advisory) op: rides the low-priority ready deques,
        # takes and grants no DAG edges, never lands in the ledger
        self.speculative = False
        # owning tenant's _TenantState (None = engine-internal work):
        # scopes DWRR credit, the budget slice, poison and the ledger tag
        self.tenant = tenant


class _Shard:
    __slots__ = ("lock", "last_op", "pending_children", "rlock", "rq",
                 "rq_lo")

    def __init__(self):
        self.lock = threading.Lock()
        self.last_op: dict[str, _Op] = {}       # last pending op per path
        # every pending structural op, grouped by parent dir (seq -> op)
        self.pending_children: dict[str, dict[int, _Op]] = {}
        # the shard's ready deque: owner pops the head, thieves the tail
        self.rlock = threading.Lock()
        self.rq: deque[_Op] = deque()
        # low-priority lane: speculative (prefetch) ops, drained only when
        # rq is dry — real work always dispatches first
        self.rq_lo: deque[_Op] = deque()


class OpScheduler:
    """Sharded DAG scheduler.  ``stats`` is the engine's EngineStats — the
    scheduler updates submitted/executed/queue-depth counters under its
    control lock so they stay exact under concurrency."""

    def __init__(self, stats, *, max_inflight: int = 300,
                 shards: int = DEFAULT_SHARDS, work_stealing: bool = True,
                 sim=None):
        self.stats = stats
        self.max_inflight = int(max_inflight)
        self.work_stealing = bool(work_stealing)
        # discrete-event mode (core/simclock.py): every real wait in this
        # class is bracketed with sim.block_begin()/block_end() so the
        # simulation can advance virtual time past a blocked worker, and
        # park-wakeup / steal-probe costs are charged on the virtual
        # timeline.  block_begin is always called while still holding the
        # condition's underlying lock (no lost wakeups: the next token
        # holder cannot complete a notify until our wait begins), and
        # block_end only after releasing it (a token-less thread must not
        # hold a lock a running thread can contend).
        self._sim = sim
        self._shards = [_Shard() for _ in range(max(1, int(shards)))]
        self._nshards = len(self._shards)
        self._seq = itertools.count(1)
        self._wire_seq = itertools.count(1)   # wiring stamps (see _Op.wired)
        # control lock: budget + parking lot + lifecycle (held briefly)
        self._ctl = threading.Lock()
        self._ready_cv = threading.Condition(self._ctl)   # the parking lot
        self._idle_cv = threading.Condition(self._ctl)
        self._budget_cv = threading.Condition(self._ctl)
        self._slock = threading.Lock()    # exact steal counter (leaf)
        self._parked = 0                  # workers waiting in the lot
        self._inflight = 0
        self._poisoned = False
        self._closed = False
        # multi-tenant state (empty dict = legacy single-job engine; every
        # tenancy branch below gates on it so zero-tenant schedules stay
        # byte-identical to pre-PR 10)
        self._tenants: dict[str, _TenantState] = {}
        self._total_weight = 0.0
        self._min_weight = 1.0

    # ------------------------------------------------------------------
    # tenancy
    # ------------------------------------------------------------------

    def register_tenant(self, name: str, weight: float,
                        stats) -> _TenantState:
        """Register one tenant and return its scheduler-side state.
        ``stats`` is the engine's ``TenantStats`` for this tenant (the
        scheduler bumps credits_spent / steals_served on it)."""
        with self._ctl:
            if name in self._tenants:
                raise ValueError(f"tenant {name!r} already registered")
            ts = _TenantState(name, weight, stats)
            self._tenants[name] = ts
            self._total_weight = sum(
                t.weight for t in self._tenants.values())
            self._min_weight = min(
                t.weight for t in self._tenants.values())
            return ts

    def _tenant_share(self, ts: _TenantState) -> int:
        """The tenant's weight-proportional slice of the in-flight budget
        (its backpressure threshold — never an absolute cap: an alone
        tenant may use the whole window)."""
        return max(1, int(self.max_inflight * ts.weight
                          / max(self._total_weight, 1e-9)))

    def _must_defer(self, ts: Optional[_TenantState]) -> bool:
        """Caller holds ctl.  True when ``ts`` is over its weight-share of
        the budget while some *under-share* tenant is parked waiting for a
        slot — the over-budget tenant alone backpressures."""
        if ts is None or not self._tenants:
            return False
        if ts.inflight < self._tenant_share(ts):
            return False
        for t in self._tenants.values():
            if (t is not ts and t.waiting > 0
                    and t.inflight < self._tenant_share(t)):
                return True
        return False

    def _replenish_credits(self) -> None:
        """DWRR replenish (caller holds an rlock): every tenant gains
        weight-proportional credit — the lowest weight earns exactly one
        op per round, so one replenish always funds the next pop —
        accumulation capped at four rounds of burst."""
        mw = self._min_weight
        for t in self._tenants.values():
            gain = t.weight / mw
            t.deficit = min(t.deficit + gain, 4.0 * max(1.0, gain))

    def _pop_lane(self, dq: deque, *, tail: bool) -> Optional[_Op]:
        """Pop one op from a ready lane (caller holds its rlock): plain
        FIFO head / steal tail with no tenants registered, else the first
        op — in the same scan direction — whose tenant can afford a DWRR
        credit (untenanted and poisoned-tenant ops always dispatch: the
        former are engine-internal, the latter drain as cancellations and
        must not rot in the lane)."""
        if not dq:
            return None
        if not self._tenants:
            return dq.pop() if tail else dq.popleft()
        for _round in (0, 1):
            order = (range(len(dq) - 1, -1, -1) if tail
                     else range(len(dq)))
            for i in order:
                ts = dq[i].tenant
                if ts is None or ts.poisoned or ts.deficit >= 1.0:
                    op = dq[i]
                    del dq[i]
                    if ts is not None and not ts.poisoned:
                        ts.deficit -= 1.0
                        ts.stats.credits_spent += 1
                    return op
            self._replenish_credits()
        return dq.pop() if tail else dq.popleft()   # unreachable backstop

    # ------------------------------------------------------------------
    # sharding helpers
    # ------------------------------------------------------------------

    def _shard_of(self, path: str) -> _Shard:
        return self._shards[hash(path) % self._nshards]

    def _lock_shards(self, paths) -> list[_Shard]:
        """Acquire the shards covering ``paths`` in ascending index order
        (deadlock-free for multi-path ops like rename)."""
        idx = sorted({hash(p) % self._nshards for p in paths})
        shards = [self._shards[i] for i in idx]
        for s in shards:
            s.lock.acquire()
        return shards

    @staticmethod
    def _unlock_shards(shards) -> None:
        for s in reversed(shards):
            s.lock.release()

    # ------------------------------------------------------------------
    # submission
    # ------------------------------------------------------------------

    def submit(self, kind: str, paths: tuple[str, ...],
               fn: Callable[[], Any], *, eager: bool,
               region: object = None, payload: object = None,
               tenant: Optional[_TenantState] = None,
               on_admit: Callable[[], None] | None = None) -> _Op:
        """Admit one op: budget gate, dependency wiring, ready enqueue.
        Paths must already be normalized.  ``on_admit`` runs after the
        budget admits the op but before it is published to the DAG — i.e.
        strictly before the op can possibly execute (the engine updates
        its write-through stat cache there, so a fast-failing op's
        error-path invalidation, which happens at completion, always wins
        over the ACK-time mocked entry).  ``tenant`` scopes the op to a
        registered tenant: its poison gate, its budget slice, its DWRR
        credit."""
        while True:
            hooked = False
            shed: Optional[_Op] = None
            with self._ctl:
                if self._poisoned or (tenant is not None
                                      and tenant.poisoned):
                    raise EnginePoisonedError(
                        "cannyfs engine poisoned by an earlier deferred error")
                if self._closed:
                    raise RuntimeError("engine is closed")
                # budget: block the *caller* — the paper's in-flight cap.
                # In tenant mode an over-share tenant additionally yields
                # to under-share waiters (per-tenant backpressure).
                if (self._inflight < self.max_inflight
                        and not self._must_defer(tenant)):
                    seq = next(self._seq)
                    self._inflight += 1
                    if tenant is not None:
                        tenant.inflight += 1
                        tenant.stats.ops += 1
                    self.stats.submitted += 1
                    self.stats.op_counts[kind] = \
                        self.stats.op_counts.get(kind, 0) + 1
                    self.stats.max_queue_depth = max(
                        self.stats.max_queue_depth, self._inflight)
                    break
                # saturated: shed the oldest queued speculative op before
                # blocking anyone — advisory lanes degrade, real work
                # proceeds (tenant mode only; legacy engines keep the
                # exact pre-PR 10 blocking behaviour)
                if self._tenants and self._inflight >= self.max_inflight:
                    shed = self._take_sheddable_locked()
                    if shed is not None:
                        self._inflight -= 1
                        if shed.tenant is not None:
                            shed.tenant.inflight -= 1
                        self.stats.admission_sheds += 1
                        self.stats.cancelled += 1
                if shed is None:
                    if tenant is not None:
                        tenant.waiting += 1
                    if self._sim is not None:
                        self._sim.block_begin(self._budget_cv)
                        hooked = True
                    self._budget_cv.wait()
                    if tenant is not None:
                        tenant.waiting -= 1
            if shed is not None:
                self._retire_shed(shed)
                continue
            if hooked:
                self._sim.block_end()
        op = _Op(seq, kind, paths, fn, eager=eager, region=region,
                 payload=payload, tenant=tenant)
        if on_admit is not None:
            on_admit()

        relevant = set(paths)
        for p in paths:
            relevant.add(parent_of(p))
        deps: list[_Op] = []
        seen: set[int] = set()

        def add_dep(d: Optional[_Op]) -> None:
            if d is None or id(d) in seen:
                return
            seen.add(id(d))
            with d.flock:
                if d.completed:
                    return
                d.dependents.append(op)
                # observation point: a sync op waiting on d pins it —
                # the optimizer may no longer rewrite or remove it
                if not eager:
                    d.sealed = True
            deps.append(d)

        shards = self._lock_shards(relevant)
        try:
            for p in paths:
                shard = self._shard_of(p)
                prev = shard.last_op.get(p)
                if prev is not None and len(paths) == 1:
                    op.prev_same_path = prev   # peephole chain link
                add_dep(prev)
                # an op under a directory whose creation/rename is pending
                # must wait for it
                add_dep(self._shard_of(parent_of(p)).last_op.get(parent_of(p)))
            if kind in NEEDS_CHILDREN:
                for p in paths:
                    kids = self._shard_of(p).pending_children.get(p, {})
                    for d in list(kids.values()):
                        add_dep(d)
            for p in paths:
                self._shard_of(p).last_op[p] = op
            if kind in STRUCTURAL:
                for p in paths:
                    par = parent_of(p)
                    self._shard_of(par).pending_children.setdefault(
                        par, {})[op.seq] = op
            op.wired = next(self._wire_seq)   # stamped inside the region
        finally:
            self._unlock_shards(shards)
        # rename subtree-tail pass: a rename moves *content*, so it must
        # run after every pending op anywhere under either endpoint —
        # structural or not.  Discovery is a per-prefix sweep of each
        # shard's last_op map: every pending op, whatever its kind,
        # publishes its chain tip there, so any path under either root is
        # found directly — including a non-structural op on a path whose
        # structural ancestors already drained (e.g. a chmod three levels
        # down whose create left the window; PR 5 closed PR 4's gap here,
        # whose BFS over pending_children could reach paths only through
        # pending *structural* anchors).  Depending on the eligible tip
        # orders after its whole chain transitively.  One shard lock at a
        # time; only ops wired strictly before this one are eligible — a
        # tip wired later may already depend on this op through the
        # parent-directory edge, and the stamp guard is what keeps the
        # DAG acyclic (see _Op.wired).
        if kind == "rename":
            for sh in self._shards:
                with sh.lock:
                    for kp, tip in list(sh.last_op.items()):
                        if kp in relevant:
                            continue
                        if not any(is_under(kp, r) for r in paths):
                            continue
                        cur = tip
                        while cur is not None and not 0 < cur.wired < op.wired:
                            cur = cur.prev_same_path
                        add_dep(cur)
        # publish the dep count last: deps completing mid-wiring have
        # already decremented remaining_deps below zero, so the sum
        # lands on the true outstanding count exactly once
        with op.flock:
            op.remaining_deps += len(deps)
            ready_now = op.remaining_deps == 0
        if ready_now:
            self._push_ready(op)
        return op

    def submit_speculative(self, kind: str, paths: tuple[str, ...],
                           fn: Callable[[], Any],
                           payload: object = None) -> Optional[_Op]:
        """Admit one *advisory* op: budget-counted and drained like any
        other, but it takes no DAG edges, publishes nothing to the
        per-path maps, and rides the low-priority ready lane — real work
        always dispatches first and never waits on it (racing-mutation
        correctness is the overlay's speculation tickets' job, not the
        scheduler's).  Returns None — never blocks, never raises — when
        the engine is poisoned/closed or the in-flight budget is full:
        speculation yields instead of backpressuring the caller."""
        with self._ctl:
            if (self._poisoned or self._closed
                    or self._inflight >= self.max_inflight):
                return None
            seq = next(self._seq)
            self._inflight += 1
            self.stats.submitted += 1
            self.stats.op_counts[kind] = self.stats.op_counts.get(kind, 0) + 1
            self.stats.max_queue_depth = max(self.stats.max_queue_depth,
                                             self._inflight)
        op = _Op(seq, kind, paths, fn, eager=True, payload=payload)
        op.speculative = True
        self._push_ready(op)
        return op

    def _take_sheddable_locked(self) -> Optional[_Op]:
        """Caller holds ctl.  Remove and return the oldest queued
        speculative op across every low-priority lane (ctl -> rlock is
        the legal rescan nesting), or None when the lanes are dry."""
        for sh in self._shards:
            with sh.rlock:
                if sh.rq_lo:
                    return sh.rq_lo.popleft()
        return None

    def _retire_shed(self, op: _Op) -> None:
        """Finish a shed speculative op outside ctl: it left the lane, no
        worker will ever claim it, so the completion bookkeeping the
        executor would have done happens here.  Speculative ops hold no
        DAG edges and publish nothing to the per-path maps, so cancel +
        payload callback + done is the whole protocol."""
        op.cancelled = True
        cb = getattr(op.payload, "on_cancelled", None)
        if cb is not None:
            cb()
        op.done.set()
        if self._sim is not None:
            self._sim.wake(op.done)

    def _home_shard(self, op: _Op) -> _Shard:
        return self._shards[hash(op.paths[0]) % self._nshards]

    def _enqueue_ready(self, op: _Op) -> None:
        """Append to the op's home-shard ready deque (rlock is the deepest
        leaf: never held while taking any other lock).  Speculative ops
        land on the low-priority lane."""
        sh = self._home_shard(op)
        with sh.rlock:
            (sh.rq_lo if op.speculative else sh.rq).append(op)

    def _notify_ready(self, n: int) -> None:
        """Wake parked workers for ``n`` newly enqueued ops.  Caller holds
        the control lock.  With stealing on, any worker can take any op,
        so waking exactly ``n`` avoids a thundering herd; with stealing
        off an arbitrary woken worker may not own the op's shard and
        would re-park, so broadcast."""
        if not self._parked:
            return
        if self.work_stealing:
            if self._sim is not None:
                # sim mode: the parked workers' READY transitions happen
                # HERE, on the notifier's (token-holding) side, via the
                # wake channel — a woken worker mutates no sim state
                # between its real wait returning and its block_end(), so
                # every handoff lands in deterministic token order
                woken = self._sim.wake(self._ready_cv, n)
                self._parked -= woken
                self._ready_cv.notify(woken)
            else:
                self._ready_cv.notify(n)
        else:
            if self._sim is not None:
                self._sim.wake(self._ready_cv)
                self._parked = 0
            self._ready_cv.notify_all()

    def _push_ready(self, op: _Op) -> None:
        self._enqueue_ready(op)
        with self._ctl:
            self._notify_ready(1)

    # ------------------------------------------------------------------
    # optimizer hooks
    # ------------------------------------------------------------------

    def fuse_tip(self, path: str, attempt: Callable[[_Op], bool]) -> bool:
        """Offer the pending tip op on ``path`` to the optimizer.

        ``attempt(op)`` runs under the shard lock *and* the op's flock with
        the op guaranteed unclaimed/unsealed/uncompleted — it may mutate the
        op's payload and must return True iff it absorbed the new work."""
        shard = self._shard_of(path)
        with shard.lock:
            tip = shard.last_op.get(path)
            if tip is None:
                return False
            with tip.flock:
                if (tip.completed or tip.claimed or tip.sealed
                        or tip.cancelled or tip.elided):
                    return False
                return attempt(tip)

    def elide_chain(self, path: str, eligible: Callable[[_Op], bool]) -> list[_Op]:
        """Walk the pending same-path chain backwards from the tip, marking
        every op ``eligible`` accepts as elided (stops at the first claimed,
        sealed, completed, cancelled or rejected op).  Returns the ops
        elided, newest first.  Elided ops still flow through the DAG — the
        executor completes them without running their fn."""
        shard = self._shard_of(path)
        out: list[_Op] = []
        with shard.lock:
            cur = shard.last_op.get(path)
            while cur is not None and cur.paths == (path,):
                with cur.flock:
                    if (cur.completed or cur.claimed or cur.sealed
                            or cur.cancelled or cur.elided):
                        break
                    if not eligible(cur):
                        break
                    cur.elided = True
                    nxt = cur.prev_same_path
                out.append(cur)
                cur = nxt
        return out

    def capture_chain(self, path: str, eligible: Callable[[_Op], bool],
                      anchor_kind: str) -> Optional[list[_Op]]:
        """All-or-nothing elision of the *entire* pending chain on
        ``path``: succeeds only when every pending op is ``eligible`` and
        the oldest one is an ``anchor_kind`` op (the path's whole backend
        lifetime is still pending), in which case all of them are marked
        elided atomically and returned oldest-first; otherwise nothing is
        touched and None is returned.

        Unlike ``elide_chain`` — which may stop partway, safe for unlink
        (dropping a suffix of the chain loses only work that would be
        deleted anyway) — a partial capture would LOSE DATA for the
        rename-retarget rule: the caller replays the captured payloads at
        another path, so it must own the chain completely or not at all.
        The flocks of the whole chain are therefore acquired and *held*
        together (under the shard lock, tip→oldest) before any op is
        marked: a bottom-of-chain op that is ready can be claimed by a
        worker under its flock alone, and a mark-then-rollback scheme
        would race it.  Holding multiple flocks is deadlock-free here:
        every other code path takes at most one flock at a time and
        never acquires a shard lock while holding one."""
        shard = self._shard_of(path)
        chain: list[_Op] = []
        held: list[_Op] = []
        with shard.lock:
            try:
                cur = shard.last_op.get(path)
                while cur is not None:
                    cur.flock.acquire()
                    held.append(cur)
                    if (cur.completed or cur.claimed or cur.sealed
                            or cur.cancelled or cur.elided
                            or cur.paths != (path,) or not eligible(cur)):
                        return None
                    chain.append(cur)
                    cur = cur.prev_same_path
                if not chain or chain[-1].kind != anchor_kind:
                    return None
                for op in chain:
                    op.elided = True
            finally:
                for op in held:
                    op.flock.release()
        chain.reverse()
        return chain

    def pending_structural_children(self, path: str) -> list[_Op]:
        """Snapshot of the pending structural ops directly under ``path``
        (the bulk-remove pass scans these for collapsible removals)."""
        shard = self._shard_of(path)
        with shard.lock:
            return list(shard.pending_children.get(path, {}).values())

    def has_pending_under(self, path: str) -> bool:
        """True when ``path`` has a pending tip or pending structural
        children — i.e. an observation at ``path`` answered by the
        namespace overlay genuinely avoided sealing something."""
        shard = self._shard_of(path)
        with shard.lock:
            if shard.last_op.get(path) is not None:
                return True
            return bool(shard.pending_children.get(path))

    def seal_path(self, path: str) -> Optional[_Op]:
        """Pin the pending tip on ``path`` (an observation point is about
        to wait on it) and return it, or None if the path is quiescent."""
        shard = self._shard_of(path)
        with shard.lock:
            op = shard.last_op.get(path)
            if op is not None:
                with op.flock:
                    op.sealed = True
        return op

    # ------------------------------------------------------------------
    # executor interface
    # ------------------------------------------------------------------

    def _owned_shards(self, worker: int, workers: int) -> range | tuple:
        """Worker ``worker`` of ``workers`` owns the shards congruent to it
        mod the pool size — every shard has exactly one owner while the
        pool is no wider than the shard count."""
        n = self._nshards
        if workers <= 0 or workers > n:
            return (worker % n,)
        return range(worker % workers, n, workers)

    def _pop_ready(self, worker: int,
                   workers: int) -> tuple[Optional[_Op], bool]:
        """Non-blocking pop: owned shards FIFO first (normal lane, then
        the low-priority speculative lane), then (with stealing on) the
        tail of the first non-empty victim shard — again normal lanes
        before any speculative one, so prefetch work only ever fills
        otherwise-idle workers.  Returns ``(op, stolen)`` — the caller
        charges the steal-probe cost to the virtual timeline, never this
        method, because the parked-worker rescan runs under the control
        lock and sleeping there would deadlock the simulation."""
        shards = self._shards
        owned = self._owned_shards(worker, workers)
        for s in owned:
            sh = shards[s]
            with sh.rlock:
                op = self._pop_lane(sh.rq, tail=False)
            if op is not None:
                return op, False
        for s in owned:
            sh = shards[s]
            with sh.rlock:
                op = self._pop_lane(sh.rq_lo, tail=False)
            if op is not None:
                return op, False
        if not self.work_stealing:
            return None, False
        mine = set(owned)
        n = self._nshards
        for k in range(n):
            s = (worker + k) % n
            if s in mine:
                continue
            sh = shards[s]
            with sh.rlock:
                op = self._pop_lane(sh.rq, tail=True)
            if op is not None:
                with self._slock:
                    self.stats.steals += 1
                    if op.tenant is not None:
                        op.tenant.stats.steals_served += 1
                return op, True
        for k in range(n):
            s = (worker + k) % n
            if s in mine:
                continue
            sh = shards[s]
            with sh.rlock:
                op = self._pop_lane(sh.rq_lo, tail=True)
            if op is not None:
                with self._slock:
                    self.stats.steals += 1
                    if op.tenant is not None:
                        op.tenant.stats.steals_served += 1
                return op, True
        return None, False

    def next_ready(self, worker: int = 0, workers: int = 1) -> Optional[_Op]:
        """Blocking pop for pool worker ``worker`` of ``workers``; None once
        the scheduler is closed and every shard is drained.  Parks on the
        control-lock condition only when all shards are dry; the re-scan
        under the control lock closes the race with producers (who take the
        control lock after enqueueing, so either they see us parked or we
        see their op).  In sim mode the park is bracketed for the event
        queue and the wakeup / steal-probe costs are charged to the virtual
        timeline (outside every lock)."""
        sim = self._sim
        while True:
            op, stolen = self._pop_ready(worker, workers)
            if op is None:
                hooked = False
                with self._ctl:
                    # rescan while holding ctl: rlocks nest under the
                    # control lock, so a producer's enqueue either landed
                    # before this scan or its notify comes after our wait
                    # begins
                    op, stolen = self._pop_ready(worker, workers)
                    if op is None:
                        if self._closed:
                            return None
                        self._parked += 1
                        self.stats.parks += 1
                        if sim is not None:
                            sim.block_begin(self._ready_cv)
                            hooked = True
                        self._ready_cv.wait()
                        if sim is None:
                            self._parked -= 1
                        # sim mode: _notify_ready/close already debited
                        # _parked on the notifier's side (see there)
                if hooked:
                    sim.block_end()
                    if sim.wake_latency_s > 0:
                        sim.sleep(sim.wake_latency_s)
                if op is None:
                    continue
            if sim is not None and stolen and sim.steal_probe_s > 0:
                sim.sleep(sim.steal_probe_s)
            return op

    def on_complete(self, op: _Op) -> None:
        """Release dependents, clean the shard maps, retire the budget
        slot.  Called by the engine after the op ran (or was skipped)."""
        with op.flock:
            op.completed = True
            dependents = op.dependents
            op.dependents = []
            op.prev_same_path = None   # don't anchor the whole chain
        newly_ready: list[_Op] = []
        for d in dependents:
            with d.flock:
                d.remaining_deps -= 1
                if d.remaining_deps == 0:
                    newly_ready.append(d)
        shards = self._lock_shards(
            set(op.paths) | {parent_of(p) for p in op.paths})
        try:
            for p in op.paths:
                shard = self._shard_of(p)
                if shard.last_op.get(p) is op:
                    del shard.last_op[p]
            if op.kind in STRUCTURAL:
                for p in op.paths:
                    par = parent_of(p)
                    kids = self._shard_of(par).pending_children.get(par)
                    if kids is not None:
                        kids.pop(op.seq, None)
                        if not kids:
                            del self._shard_of(par).pending_children[par]
        finally:
            self._unlock_shards(shards)
        for d in newly_ready:
            self._enqueue_ready(d)
        with self._ctl:
            if newly_ready:
                self._notify_ready(len(newly_ready))
            self._inflight -= 1
            if op.tenant is not None:
                op.tenant.inflight -= 1
            if self._tenants:
                # broadcast in tenant mode: a single notify could keep
                # waking the over-share tenant's deferred submitter while
                # the under-share waiter it must yield to sleeps on
                if self._sim is not None:
                    self._sim.wake(self._budget_cv)
                self._budget_cv.notify_all()
            else:
                if self._sim is not None:
                    self._sim.wake(self._budget_cv, 1)
                self._budget_cv.notify()
            if self._inflight == 0:
                if self._sim is not None:
                    self._sim.wake(self._idle_cv)
                self._idle_cv.notify_all()
        op.done.set()
        if self._sim is not None:
            self._sim.wake(op.done)

    # ------------------------------------------------------------------
    # barriers / lifecycle
    # ------------------------------------------------------------------

    def pending_tip(self, path: str) -> Optional[_Op]:
        shard = self._shard_of(path)
        with shard.lock:
            return shard.last_op.get(path)

    def drain(self) -> None:
        sim = self._sim
        while True:
            hooked = False
            with self._idle_cv:
                if self._inflight == 0:
                    return
                if sim is not None:
                    sim.block_begin(self._idle_cv)
                    hooked = True
                self._idle_cv.wait()
            if hooked:
                sim.block_end()

    @property
    def poisoned(self) -> bool:
        return self._poisoned

    def poison(self, tenant: Optional[_TenantState] = None) -> None:
        """Poison the engine — or, given a tenant, only that tenant's
        failure domain: its flag trips, its queued ops cancel, and every
        other tenant's window stays open and convergent."""
        with self._ctl:
            if tenant is None:
                self._poisoned = True
            elif not tenant.poisoned:
                tenant.poisoned = True
                tenant.stats.poison_trips += 1
            # cancel everything not yet started; their dependents cascade
            queued: list[_Op] = []
            for sh in self._shards:
                with sh.rlock:
                    for dq in (sh.rq, sh.rq_lo):
                        for op in dq:
                            if tenant is None or op.tenant is tenant:
                                queued.append(op)
        for op in queued:
            op.cancelled = True

    def reset_poison(self, tenant: Optional[_TenantState] = None) -> None:
        with self._ctl:
            if tenant is None:
                self._poisoned = False
            else:
                tenant.poisoned = False

    def close(self) -> None:
        with self._ctl:
            self._closed = True
            if self._sim is not None:
                self._sim.wake(self._ready_cv)
                self._parked = 0   # notifier-side accounting (sim mode)
            self._ready_cv.notify_all()

    @property
    def inflight(self) -> int:
        return self._inflight

    # -- merged debugging/introspection views (tests assert on these) ----

    def merged_last_op(self) -> dict[str, _Op]:
        out: dict[str, _Op] = {}
        for s in self._shards:
            with s.lock:
                out.update(s.last_op)
        return out

    def merged_pending_children(self) -> dict[str, dict[int, _Op]]:
        out: dict[str, dict[int, _Op]] = {}
        for s in self._shards:
            with s.lock:
                out.update(s.pending_children)
        return out
