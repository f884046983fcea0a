"""The CannyFS eager-I/O engine: scheduler / optimizer / namespace
overlay / prefetcher / executor.

Architecture (one op's life, left to right)::

        submit / try_fuse / prepare_unlink / prepare_rmtree
                        |
        +---------------v-----------------------------------------+
        |  OpScheduler (core/scheduler.py)                        |
        |  per-path FIFO + cross-path DAG edges; submission state |
        |  AND ready queues sharded by path hash; in-flight       |
        |  budget; poison/close; per-shard LOW-PRIORITY lane for  |
        |  speculative ops (submit_speculative: no DAG edges,     |
        |  drained only when the normal lanes are dry)            |
        +---------------+-----------------------------------------+
                        | pending tip / chain, under shard+op locks
        +---------------v-----------------------------------------+
        |  Fuser (core/fusion.py)                                 |
        |  peephole pass over the pending stream:                 |
        |    coalesce write_at -> one vectored write_vec          |
        |      (cap ~2x the backend's per-op-class cost_hint BDP  |
        |       when adaptive, else FusionPolicy.max_bytes)       |
        |    fold chmod/utimens/truncate to last-wins             |
        |    elide create+write chains unlinked in-window         |
        |    retarget renames on copy+delete media: a still-      |
        |      pending source chain replays at the destination    |
        |      (cost-gated via cost_hint("rename") vs "create")   |
        |    collapse cross-path unlink/rmdir -> one remove_tree  |
        |      (provisional dirs fuse too: the op re-verifies the |
        |       overlay claim at exec via a RemoveWitness)        |
        +------+--------+-----------------------------------------+
               |        | per-shard ready deques
        +------v------+ |   +-------------------------------------+
        | Namespace   | +--->  PoolExecutor | ThreadPerOp         |
        | Overlay     |     |  (core/executor.py)                 |
        | (namespace  |     |  worker i of W owns shards s with   |
        |  .py)       |     |  s % W == i, steals from the rest   |
        +------^------+     |  when dry, parks when all empty;    |
          mirrors every     |  completion releases dependents     |
          admitted op as a  +-------------------------------------+
          directory-tree delta; readdir/stat/exists/walk answered
          here never seal a chain; cached listings are LRU-bounded
          (OverlayPolicy.max_cached_listings; eviction demotes
          completeness only, never pending membership)
               |
        +------v---------------------------------------------------+
        |  MetadataPrefetcher (core/prefetch.py)                   |
        |  speculative pipeline for COLD trees: a readdir/walk miss|
        |  seeds a bounded BFS frontier; batched readdir_plus_vec  |
        |  reads (ONE roundtrip per batch, width ~2x BDP) install  |
        |  listings into the overlay at LRU-cold recency without   |
        |  sealing; SpeculationTickets cancel on racing mutations; |
        |  consumers latch onto in-flight batches (demand          |
        |  promotion) instead of duplicating the fetch             |
        +------+---------------------------------------------------+
               |
        +------v---------------------------------------------------+
        |  Read-side data plane (core/readahead.py)                |
        |  ReadAheadManager: a sequential pread registers a        |
        |  ticketed per-file page buffer and pipelines speculative |
        |  read_vec windows (~2x BDP) ahead of the consumer —      |
        |  page hits skip the backend, an outrun consumer latches  |
        |  onto the in-flight window, racing admitted mutations    |
        |  cancel the run.  StatVecBatcher: transactional          |
        |  create/write existence probes fuse into ONE speculative |
        |  stat_vec per batch, consumed single-shot at execution   |
        |  time with a sync-stat fallback                          |
        +------+---------------------------------------------------+
               |
        +------v---------------------------------------------------+
        |  Backend zoo + CostModel (core/backend.py,               |
        |  core/objectstore.py, core/remote.py, core/faults.py)    |
        |  the StorageBackend decorator stack bottoms out at a     |
        |  storage class with its own cost structure: Local /      |
        |  InMemory (no cost opinion), LatencyBackend (measured    |
        |  RTT+bandwidth EWMAs, seeded from the model's nominals), |
        |  ObjectStoreBackend (flat keyspace: paginated            |
        |  list_by_prefix, whole-object PUT, rename=copy+delete,   |
        |  per-request billing) and RemoteStreamBackend (high RTT, |
        |  cheap streaming, native rename).  Every backend answers |
        |  cost_hint(op, nbytes) -> CostHint(rtt_s, bytes_per_s,   |
        |  per_request_overhead_s) | None; fault/quota decorators  |
        |  delegate the question inward, so the fuser, prefetcher, |
        |  read-ahead manager and stat batcher size their batches  |
        |  and arm cost-gated rules from the storage actually at   |
        |  the bottom of the stack                                 |
        +------+---------------------------------------------------+
               |
        +------v---------------------------------------------------+
        |  Durability spill (core/durability.py)                   |
        |  SpillManager taps submit (admit records) and _execute   |
        |  (done/fail records, per-segment write checksums) and    |
        |  appends an epoch-stamped, checksummed record log to the |
        |  backend itself; chunks ride the scheduler's LOW-        |
        |  PRIORITY speculative lane (durability never serializes  |
        |  the hot path) and every barrier/drain CUTs: synchronous |
        |  flush of outstanding chunks + COMMIT-style marker       |
        |  stamp.  After a kill, CannyFS.resume(spill_dir) re-     |
        |  proves the optimization window from the log — journal   |
        |  reinstalled, durable ops elided/diverted on re-run,     |
        |  uncertain in-flight ops repaired against the backend —  |
        |  instead of redoing the whole job from scratch           |
        +------+---------------------------------------------------+
               |
        +------v---------------------------------------------------+
        |  Tenancy (core/tenancy.py, PR 10)                        |
        |  CannyFS.tenant(name, prefix, weight, quota) carves N    |
        |  isolated jobs out of ONE engine.  Every tenant op is    |
        |  confined to its root prefix and tagged with a           |
        |  _TenantState that scopes (1) dispatch: a deficit-       |
        |  weighted-round-robin credit on every ready-lane pop     |
        |  (a burst cannot starve a neighbour's latency) plus a    |
        |  weight-share slice of the in-flight budget — at         |
        |  saturation admission control sheds speculative lanes    |
        |  first, then backpressures only the over-share tenant;   |
        |  (2) the failure domain: tenant-tagged ledger entries,   |
        |  tenant-scoped poison/rollback/retry-backoff, and an     |
        |  optional per-tenant spill journal, so one tenant's      |
        |  fault storm or ProcessKilled preemption leaves the      |
        |  neighbours' optimization windows open and convergent;   |
        |  (3) resources: an optional TenantQuota byte+inode       |
        |  budget enforced at submit.  EngineStats.tenants[name]   |
        |  is the per-tenant observability sub-snapshot            |
        +----------------------------------------------------------+

Semantics (paper §2–§3):

* Every operation is routed through per-path FIFO order; ops on disjoint
  paths run concurrently.  *Eager* ops are acknowledged immediately;
  non-eager ops and all data reads block the caller (the read barrier).
* Reads, barriers and transaction commit are the observation points.
  Between them the pending stream is *rewritable*: the optimizer may
  coalesce, fold and delete ops as long as commit-visible state is
  unchanged.  Observation classification is per-*answer*: a namespace
  read (readdir/stat/exists) whose answer is fully determined by the
  transaction's own writes is served by the **namespace overlay**
  (``core/namespace.py``) and seals nothing; only an overlay miss takes
  the sync path, which *seals* the ops it waits on — freezing them
  against further rewriting — so results are exactly what a synchronous
  execution would have produced at every read.  The overlay is populated
  at submission, invalidated per-path when a background op fails,
  cleared by transaction rollback and dropped at commit.
* Fusion is controlled by ``FusionPolicy`` (``fusion=`` argument: a
  policy, True/None for defaults, False to disable); the overlay by
  ``OverlayPolicy`` (``overlay=`` argument, default derived from the
  legacy mock_stat/readdir_prefetch/negative_stat_cache flags).
  ``EngineStats`` reports ``fused_writes`` (writes absorbed into a
  pending vectored op), ``folded_meta`` (last-wins metadata folds),
  ``elided_ops``/``bytes_elided`` (ops/bytes deleted by elision),
  ``renames_retargeted`` (renames rewritten to build-at-destination on
  copy+delete media),
  ``overlay_readdirs``/``overlay_seals_avoided`` (namespace reads that
  never reached the backend / that left pending chains rewritable),
  ``bulk_removes`` (cross-path removal collapses),
  ``bulk_reverify_promoted``/``bulk_reverify_demoted`` (fused removals
  confirmed / fallen back at execution time), ``steals``/``parks``
  (dispatch-layer load balancing), ``adaptive_max_bytes`` (the latest
  BDP-derived coalescing clamp),
  ``prefetch_{issued,batches,hits,wasted,cancelled}`` (the speculative
  metadata-prefetch pipeline's accounting),
  ``readahead_{windows,hits,latched,bytes,wasted,cancelled}`` and
  ``stat_{batches,probes,probe_hits,probe_fallbacks}`` (the vectored
  read-side data plane, ``core/readahead.py``, controlled by
  ``ReadPolicy`` via the ``readahead=`` argument — same
  policy/True/None/False convention), and
  ``spill_{records,flushes,bytes,cuts}`` /
  ``resume{s,_elided_ops,_replayed_ops,_repairs}`` (the durability
  spill and crash-resume path, ``core/durability.py``, engaged by
  ``CannyFS.enable_spill``/``CannyFS.resume``), ``admission_sheds``
  (speculative ops cancelled to admit real work at budget
  saturation) and ``tenants`` (name -> ``TenantStats`` per-tenant
  sub-snapshots: ops/executed/fused/deferred_errors/credits_spent/
  steals_served/retries/rollbacks/resumes/quota headroom).
* Failures of background ops land in the ErrorLedger; optional
  abort_on_error poisons the engine.  ``max_inflight`` bounds queued ops
  (fused absorptions don't consume new slots — coalescing is also
  backpressure relief, bounded by ``FusionPolicy.max_bytes``).
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from .backend import StorageBackend, StatResult, norm_path
from .errors import ErrorLedger, OpCancelledError
from .executor import make_executor
from .flags import EagerFlags
from .fusion import Fuser, FusionPolicy, MetaPayload, WritePayload
from .namespace import NamespaceOverlay, OverlayPolicy
from .prefetch import MetadataPrefetcher, PrefetchPolicy
from .readahead import (INVALIDATING_KINDS, ReadAheadManager, ReadPolicy,
                        StatVecBatcher)
from .scheduler import NEEDS_CHILDREN, STRUCTURAL, OpScheduler, _Op
from .simclock import SimClock


@dataclass
class TenantStats:
    """Per-tenant observability sub-snapshot (``EngineStats.tenants``).

    Counters are bumped under the scheduler locks noted in
    ``core/scheduler.py``'s lock-order docs (credits/steals under a
    ready-queue rlock, the rest under the control lock or the GIL-atomic
    fs layer), so they are exact in sim mode and monotone-approximate
    under real threads — same contract as the global counters."""

    name: str = ""
    weight: float = 1.0
    ops: int = 0                  # ops admitted for this tenant
    executed: int = 0             # ...that completed (incl. cancellations)
    fused: int = 0                # writes/meta absorbed without a new op
    deferred_errors: int = 0      # ledger entries attributed to the tenant
    credits_spent: int = 0        # DWRR dispatch credits consumed
    steals_served: int = 0        # tenant ops dispatched via a work steal
    retries: int = 0              # run_transaction resubmissions (scoped)
    rollbacks: int = 0            # Transaction.rollback() on this tenant
    resumes: int = 0              # CannyFS.resume() on the tenant's spill
    poison_trips: int = 0         # abort_on_error trips scoped to this
    #                               tenant (False->True transitions)
    quota_bytes_used: int = 0     # TenantQuota high-water byte charge
    quota_bytes_budget: int = 0   # 0 = unbudgeted
    quota_inodes_used: int = 0
    last_complete_s: float = 0.0  # sim/monotonic stamp of the latest
    #                               completion — per-tenant makespan probe


@dataclass
class EngineStats:
    submitted: int = 0
    eager_acks: int = 0
    sync_ops: int = 0
    executed: int = 0
    cancelled: int = 0
    mocked_stats: int = 0
    prefetched_stats: int = 0
    barrier_waits: int = 0
    max_queue_depth: int = 0
    ack_latency_s: float = 0.0   # total caller-visible latency of eager ops
    exec_latency_s: float = 0.0  # total background execution time
    # -- fusion / optimizer counters --------------------------------------
    fused_writes: int = 0        # write_at calls absorbed into a pending op
    folded_meta: int = 0         # chmod/utimens/truncate last-wins folds
    elided_ops: int = 0          # pending ops deleted by unlink/bulk elision
    bytes_elided: int = 0        # write payload bytes that never hit storage
    renames_retargeted: int = 0  # renames rewritten to build-at-destination
    #                              (cost-gated: copy+delete media only)
    # -- namespace overlay counters ---------------------------------------
    overlay_readdirs: int = 0    # readdirs answered from the overlay
    overlay_seals_avoided: int = 0  # of those, with pending ops underneath
    bulk_removes: int = 0        # cross-path removals fused to remove_tree
    bulk_reverify_promoted: int = 0  # fused removals whose provisional dirs
    #                                  all proved fresh at execution time
    bulk_reverify_demoted: int = 0   # ...that fell back per-entry instead
    # -- dispatch counters (sharded ready queues + work stealing) ----------
    steals: int = 0              # ops popped from a non-owned shard's deque
    parks: int = 0               # worker waits in the all-shards-empty lot
    # -- speculative metadata prefetch (core/prefetch.py) ------------------
    prefetch_issued: int = 0     # dirs sent in speculative batches
    prefetch_batches: int = 0    # vectored readdir_plus_vec calls submitted
    prefetch_hits: int = 0       # overlay reads served by a speculative
    #                              listing (first consumption per dir)
    prefetch_wasted: int = 0     # fetched but uninstallable (failed batch,
    #                              stale vs a sync miss, evicted at insert)
    prefetch_cancelled: int = 0  # invalidated by racing mutations/teardown
    # -- vectored read-side data plane (core/readahead.py) -----------------
    readahead_windows: int = 0   # speculative read_vec windows submitted
    readahead_hits: int = 0      # preads served from installed pages
    readahead_latched: int = 0   # consumers that waited on an in-flight window
    readahead_bytes: int = 0     # bytes landed into page buffers
    readahead_wasted: int = 0    # windows fetched but uninstallable
    readahead_cancelled: int = 0  # page runs dropped by racing mutations
    stat_batches: int = 0        # speculative stat_vec batches submitted
    stat_probes: int = 0         # write-path existence probes enqueued
    stat_probe_hits: int = 0     # probes consumed with a landed answer
    stat_probe_fallbacks: int = 0  # probes that fell back to a sync stat
    # -- adaptive fusion sizing --------------------------------------------
    adaptive_max_bytes: int = 0  # latest BDP-derived write-coalescing clamp
    # -- durability spill / crash-resume (core/durability.py) -------------
    spill_records: int = 0       # admit/done/fail/journal records appended
    spill_flushes: int = 0       # record chunks landed on the backend
    spill_bytes: int = 0         # journal bytes written
    spill_cuts: int = 0          # barrier/commit cuts that stamped the marker
    resumes: int = 0             # CannyFS.resume() invocations
    resume_elided_ops: int = 0   # re-run ops skipped as provably durable
    resume_replayed_ops: int = 0  # done records replayed into the caches
    resume_repairs: int = 0      # uncertain in-flight ops repaired on resume
    # -- fault / trace counters (chaos + error-path observability) --------
    deferred_errors: int = 0     # background failures recorded in the ledger
    injected_faults: int = 0     # of those, carried an `.injected` tag
    rollbacks: int = 0           # Transaction.rollback() invocations
    rollback_leftovers: int = 0  # paths a verified rollback failed to remove
    retries: int = 0             # run_transaction resubmissions
    # -- multi-tenancy (core/tenancy.py) ----------------------------------
    admission_sheds: int = 0     # speculative ops shed at budget saturation
    tenants: dict = field(default_factory=dict)  # name -> TenantStats
    op_counts: dict = field(default_factory=dict)     # kind -> submitted
    error_counts: dict = field(default_factory=dict)  # kind -> deferred errs


class _StatCache:
    """Write-through metadata cache.

    The paper mocks stat with default values; we can do strictly better
    because the engine *knows* every pending mutation — sizes/mtimes are
    tracked as writes are queued, so an eager-mode ``stat`` is answered
    exactly without flushing."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: dict[str, StatResult] = {}

    def get(self, path: str) -> Optional[StatResult]:
        with self._lock:
            return self._entries.get(path)

    def put(self, path: str, st: StatResult) -> None:
        with self._lock:
            self._entries[path] = st

    def on_op(self, kind: str, paths: tuple[str, ...], **kw) -> None:
        now = time.time()
        with self._lock:
            if kind == "mkdir":
                self._entries[paths[0]] = StatResult(True, is_dir=True,
                                                     mtime=now, mocked=True)
            elif kind == "create":
                self._entries[paths[0]] = StatResult(True, size=0, mtime=now,
                                                     mocked=True)
            elif kind == "symlink":
                self._entries[paths[0]] = StatResult(True, is_symlink=True,
                                                     mtime=now, mocked=True)
            elif kind in ("unlink", "rmdir"):
                self._entries[paths[0]] = StatResult(False, mocked=True)
            elif kind == "rename":
                src, dst = paths
                ent = self._entries.pop(src, None)
                if ent is not None:
                    self._entries[dst] = ent
                self._entries[src] = StatResult(False, mocked=True)
            elif kind == "write":
                prev = self._entries.get(paths[0])
                end = kw.get("offset", 0) + kw.get("nbytes", 0)
                size = max(end, prev.size if prev and prev.exists else 0)
                self._entries[paths[0]] = StatResult(True, size=size,
                                                     mtime=now, mocked=True)
            elif kind in ("truncate", "fallocate"):
                self._entries[paths[0]] = StatResult(True, size=kw.get("size", 0),
                                                     mtime=now, mocked=True)
            elif kind == "chmod":
                prev = self._entries.get(paths[0])
                if prev and prev.exists:
                    self._entries[paths[0]] = StatResult(
                        True, is_dir=prev.is_dir, is_symlink=prev.is_symlink,
                        size=prev.size, mtime=prev.mtime,
                        mode=kw.get("mode", prev.mode), mocked=True)
            elif kind == "remove_tree":
                # one fused removal covers every listed path
                for p in paths:
                    self._entries[p] = StatResult(False, mocked=True)

    def invalidate(self, path: str) -> None:
        with self._lock:
            self._entries.pop(path, None)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()


class EagerIOEngine:
    def __init__(self, backend: StorageBackend, *,
                 flags: EagerFlags | None = None,
                 max_inflight: int = 300,
                 workers: int = 32,
                 executor: str = "pool",          # "pool" | "thread_per_op"
                 abort_on_error: bool = False,
                 ledger: ErrorLedger | None = None,
                 fusion: FusionPolicy | bool | None = None,
                 overlay: OverlayPolicy | bool | None = None,
                 prefetch: PrefetchPolicy | bool | None = None,
                 readahead: "ReadPolicy | bool | None" = None,
                 work_stealing: bool = True,
                 clock=None):
        self.backend = backend
        self.flags = flags or EagerFlags()
        self.max_inflight = int(max_inflight)
        self.abort_on_error = abort_on_error
        # explicit None-check: an empty ErrorLedger is falsy (__len__ == 0),
        # so `ledger or ...` would silently discard a caller-provided ledger
        self.ledger = ledger if ledger is not None else ErrorLedger()
        self.stats = EngineStats()
        self.stat_cache = _StatCache()
        # the durability spill manager (core/durability.py), installed by
        # CannyFS.enable_spill/resume; duck-typed so the engine layer does
        # not import the durability module
        self.spill = None
        # registered tenants (core/tenancy.py): name -> scheduler-side
        # _TenantState.  Empty for single-job engines — every tenancy
        # branch gates on registration so legacy schedules stay identical.
        self._tenant_states: dict = {}
        if fusion is None or fusion is True:
            self.fusion = FusionPolicy()
        elif fusion is False:
            self.fusion = FusionPolicy.off()
        else:
            self.fusion = fusion
        # the write-back namespace overlay; None when disabled (then all
        # namespace reads hit the backend, as before PR 3)
        if overlay is None:
            ov_policy = OverlayPolicy.from_flags(self.flags)
        elif overlay is True:
            ov_policy = OverlayPolicy()
        elif overlay is False:
            ov_policy = OverlayPolicy.off()
        else:
            ov_policy = overlay
        self.overlay: NamespaceOverlay | None = (
            NamespaceOverlay(ov_policy) if ov_policy.enabled else None)
        # discrete-event mode (core/simclock.py): engaged by an explicit
        # ``clock=SimClock(...)`` or by discovering one on the backend's
        # decorator stack (LatencyBackend exposes ``.clock``; the fault /
        # quota decorators delegate unknown attrs inward).  The driver
        # (this constructing thread) and every pool worker become actors
        # of the simulation; all blocking waits below are bracketed so
        # the event queue can advance virtual time past them.
        clk = clock if clock is not None else getattr(backend, "clock", None)
        self.sim: SimClock | None = clk if isinstance(clk, SimClock) else None
        if self.sim is not None and executor != "pool":
            raise ValueError(
                "SimClock requires the pool executor: thread_per_op spawns "
                "an unbounded, timing-dependent thread set the event queue "
                "cannot schedule deterministically")
        self._sched = OpScheduler(self.stats, max_inflight=self.max_inflight,
                                  work_stealing=work_stealing, sim=self.sim)
        # adaptive fusion sizing: the backend's CostModel protocol
        # (``cost_hint`` — per-op-class RTT/bandwidth/overhead, decorators
        # delegate it inward) is the preferred signal; the older scalar
        # ``bdp_bytes`` probe is kept as the fallback for latency-only
        # stacks.  Without either the fixed FusionPolicy bounds stand.
        bdp = getattr(backend, "bdp_bytes", None)
        cost = getattr(backend, "cost_hint", None)
        self._fuser = Fuser(self.fusion, self.stats,
                            bdp_source=bdp if callable(bdp) else None,
                            cost_source=cost if callable(cost) else None)
        # the speculative metadata prefetcher pipelines cold-tree walks
        # through batched readdir_plus_vec reads; it rides the overlay's
        # speculation tickets, so it exists only when the overlay does
        if prefetch is None or prefetch is True:
            pf_policy = PrefetchPolicy()
        elif prefetch is False:
            pf_policy = PrefetchPolicy.off()
        else:
            pf_policy = prefetch
        self.prefetch_policy = pf_policy
        self.prefetcher: MetadataPrefetcher | None = (
            MetadataPrefetcher(self, pf_policy)
            if pf_policy.enabled and self.overlay is not None else None)
        # the vectored read-side data plane (core/readahead.py): BDP-sized
        # speculative read-ahead for sequential consumers plus stat_vec
        # batching for the write path's journaling existence probes
        if readahead is None or readahead is True:
            ra_policy = ReadPolicy()
        elif readahead is False:
            ra_policy = ReadPolicy.off()
        else:
            ra_policy = readahead
        self.read_policy = ra_policy
        # admissions-in-flight guard: on_admit (the cancellation hook) runs
        # BEFORE the scheduler publishes the op to the per-path maps, so a
        # speculation registering in that window would see a quiescent path
        # whose cancellation hook has already fired.  Registration declines
        # while any invalidating admission is mid-flight (see
        # _admitting_invalidators / readahead.py's registration checks).
        self._adm_lock = threading.Lock()
        self._admitting = 0
        self.readahead: ReadAheadManager | None = (
            ReadAheadManager(self, ra_policy) if ra_policy.enabled else None)
        self.stat_batcher: StatVecBatcher | None = (
            StatVecBatcher(self, ra_policy)
            if ra_policy.enabled and ra_policy.stat_batching else None)
        self._closed = False
        self._executor = executor
        self._sim_driver_ident = 0
        if self.sim is not None:
            # the driver attaches FIRST (token holder from the start), then
            # the pool spawns and every worker registers before any op is
            # submitted — the actor set is identical at every driver yield
            # point, run to run, which is what makes the schedule a pure
            # function of the op stream and the latency model's seed
            self.sim.attach()
            self._sim_driver_ident = threading.get_ident()
        self._exec = make_executor(executor, self._sched, self._execute,
                                   workers, sim=self.sim)
        if self.sim is not None:
            self.sim.wait_attached(self._exec.nworkers + 1)

    # ------------------------------------------------------------------
    # tenancy
    # ------------------------------------------------------------------

    def register_tenant(self, name: str, weight: float = 1.0):
        """Register one tenant: creates the ``EngineStats.tenants[name]``
        sub-snapshot and the scheduler-side DWRR/budget/poison state.
        Returns the scheduler state handle — opaque to callers;
        ``CannyFS.tenant`` threads it through every submit."""
        tstats = TenantStats(name=name, weight=float(weight))
        ts = self._sched.register_tenant(name, weight, tstats)
        self.stats.tenants[name] = tstats
        self._tenant_states[name] = ts
        return ts

    def _spill_for(self, tenant):
        """The spill journal an op records to: a tenant's own journal (or
        none — tenants never write into the shared engine journal, that
        would re-entangle the failure domains), else the engine's."""
        if tenant is not None:
            return tenant.spill
        return self.spill

    # ------------------------------------------------------------------
    # submission
    # ------------------------------------------------------------------

    def submit(self, kind: str, paths: tuple[str, ...],
               fn: Callable[[], Any], *, eager: bool,
               cache_kw: dict | None = None,
               region: object = None,
               payload: object = None,
               tenant=None) -> Any:
        """Route one op through the DAG.  Eager → returns None immediately;
        sync → waits and returns the op's result (re-raising its error).
        ``tenant`` (a registered ``_TenantState``) scopes the op's poison
        gate, budget slice, DWRR credit, ledger tag and spill journal."""
        t0 = time.monotonic()
        paths = tuple(norm_path(p) for p in paths)
        sp = self._spill_for(tenant)
        if sp is not None:
            # admit-before-schedule: a kill can now strike with the op
            # recorded but unsettled, which resume treats as uncertain
            # and repairs by probing — never the reverse (landed but
            # unrecorded would be invisible)
            sp.record_admit(kind, paths)
        # write-through cache + namespace-overlay updates ride on_admit —
        # after the budget admits the op but before the DAG publishes it,
        # so a fast-failing op's error-path invalidation (at completion,
        # strictly later) always wins over the ACK-time mocked entry
        ra, sb = self.readahead, self.stat_batcher
        if cache_kw is None and ra is None and sb is None:
            on_admit = None
        else:
            def on_admit():
                if cache_kw is not None:
                    self.stat_cache.on_op(kind, paths, **cache_kw)
                    if self.overlay is not None:
                        self.overlay.on_op(kind, paths, **cache_kw)
                # the data plane's speculation is admission-cancelled too:
                # pages/probes must die before the mutating op can execute
                if ra is not None:
                    ra.on_op(kind, paths)
                if sb is not None:
                    sb.on_op(kind, paths)
        guard = ((ra is not None or sb is not None)
                 and kind in INVALIDATING_KINDS)
        if guard:
            with self._adm_lock:
                self._admitting += 1
        try:
            op = self._sched.submit(kind, paths, fn, eager=eager,
                                    region=region, payload=payload,
                                    tenant=tenant, on_admit=on_admit)
        finally:
            if guard:
                with self._adm_lock:
                    self._admitting -= 1
        if eager:
            self.stats.eager_acks += 1
            self.stats.ack_latency_s += time.monotonic() - t0
            return None
        self.stats.sync_ops += 1
        if self.sim is not None:
            self.sim.wait_event(op.done)
        else:
            op.done.wait()
        self.stats.ack_latency_s += time.monotonic() - t0
        if op.error is not None:
            raise op.error
        return op.result

    # ------------------------------------------------------------------
    # optimizer entry points (called by the fs layer before submitting)
    # ------------------------------------------------------------------

    def try_fuse_write(self, path: str, offset: int, data: bytes, *,
                       region: object = None,
                       cache_kw: dict | None = None) -> bool:
        """Absorb one write into the path's pending vectored write op.
        True → the write is ACKed (no new op); caller must not submit."""
        if self._sched.poisoned:
            return False   # fall through to submit's fail-fast raise
        path = norm_path(path)
        on_absorb = (None if cache_kw is None else
                     lambda: self.stat_cache.on_op("write", (path,),
                                                   **cache_kw))
        return self._fuser.absorb_write(self._sched, path, offset, data,
                                        region, on_absorb)

    def try_fuse_meta(self, kind: str, path: str, args: tuple, *,
                      region: object = None,
                      cache_kw: dict | None = None) -> bool:
        """Fold a chmod/utimens/truncate into the path's pending same-kind
        op (last-wins).  True → folded; caller must not submit."""
        if self._sched.poisoned:
            return False   # fall through to submit's fail-fast raise
        path = norm_path(path)
        on_absorb = (None if cache_kw is None else
                     lambda: self.stat_cache.on_op(kind, (path,),
                                                   **cache_kw))
        return self._fuser.absorb_meta(self._sched, kind, path, args, region,
                                       on_absorb)

    def prepare_unlink(self, path: str, *, region: object = None) -> bool:
        """Elide the path's pending create/write/metadata chain ahead of an
        unlink.  Returns True iff anything was elided — the unlink must
        then tolerate the file's absence (its creating ops are gone)."""
        if self._sched.poisoned:
            return False   # the unlink submit will fail fast instead
        return self._fuser.elide_for_unlink(self._sched, norm_path(path),
                                            region)

    def prepare_rmtree(self, path: str, *, region: object = None):
        """Cross-path bulk-remove peephole: collapse the pending removals
        under ``path`` into one vectored ``remove_tree`` call.  Returns
        the fused op's ``BulkRemovePayload`` (covered co-paths: dependency
        edges and error-invalidation scope; per-entry fallback manifest;
        re-verification witness) when the overlay proves — or, with
        ``FusionPolicy.reverify_provisional``, provisionally claims — the
        subtree, or None when the caller must submit a plain rmdir."""
        if self._sched.poisoned or self.overlay is None:
            return None
        return self._fuser.prepare_bulk_remove(self._sched, self.overlay,
                                               norm_path(path), region)

    def rename_retarget_wanted(self) -> bool:
        """Is the cost-gated rename-retarget rule armed for this backend?
        (``FusionPolicy.retarget_renames``: "auto" consults the cost
        model — fires only on copy+delete media like the object store.)"""
        return (not self._sched.poisoned
                and self._fuser.rename_retarget_wanted())

    def prepare_rename_retarget(self, src: str, *,
                                region: object = None) -> list | None:
        """Capture the source's entire pending chain (all-or-nothing, must
        bottom at its pending ``create``) so the fs layer can replay the
        payloads at the destination instead of paying the backend's
        copy+delete rename.  Returns the captured ops oldest-first (already
        marked elided), or None when the chain is not fully capturable and
        the plain backend rename must run."""
        if self._sched.poisoned:
            return None
        return self._fuser.capture_for_rename(self._sched, norm_path(src),
                                              region)

    def run_bulk_remove(self, payload) -> int:
        """Execute one fused removal (called from the fused op's fn on a
        worker thread).  The op's DAG edges ordered it after every mkdir
        it depends on, so the witness verdict is final here: promoted (or
        no witness — the tree was backend-proven at fuse time) runs the
        single vectored ``remove_tree``; demoted falls back to per-entry
        removals, byte-identical to the unfused execution — children
        before parents, absence-tolerant (elided creates mean an entry may
        never have existed), with the final rmdir of the root left to
        fail ENOTEMPTY exactly as the plain rmdir would have when the
        demoted directory turns out to hold pre-existing entries."""
        ov = self.overlay
        w = payload.witness
        verdict = ("clean" if w is None or ov is None
                   else ov.resolve_witness(w))
        if verdict != "demoted":
            if verdict == "promoted":
                with self._sched._ctl:
                    self.stats.bulk_reverify_promoted += 1
            return self.backend.remove_tree(payload.root)
        with self._sched._ctl:
            self.stats.bulk_reverify_demoted += 1
        b = self.backend
        removed = 0
        for p, is_dir in payload.fallback_order():
            try:
                (b.rmdir if is_dir else b.unlink)(p)
                removed += 1
            except OSError:
                # per-entry failures are independent, as unfused execution's
                # would have been: a surviving entry (ENOTEMPTY on a demoted
                # subdir, EACCES, ...) keeps the root non-empty, so the
                # final rmdir below reports the failure for the whole op —
                # aborting here would strand siblings the unfused rmdirs
                # would still have removed
                pass
        try:
            b.rmdir(payload.root)
            removed += 1
        except FileNotFoundError:
            pass
        return removed

    # ------------------------------------------------------------------
    # barriers
    # ------------------------------------------------------------------

    def barrier(self, path: str, tenant=None) -> None:
        """Wait until every op submitted so far on ``path`` has executed.
        An observation point: the waited-on op is sealed against fusion."""
        op = self._sched.seal_path(norm_path(path))
        if op is not None:
            self.stats.barrier_waits += 1
            if self.sim is not None:
                self.sim.wait_event(op.done)
            else:
                op.done.wait()
        sp = self._spill_for(tenant)
        if sp is not None:
            # observation seal = durability cut: what the caller can now
            # see is also what a resume can now prove
            sp.cut()

    def drain(self) -> None:
        """Global barrier: wait for the whole DAG to execute.  The
        speculative prefetcher is quiesced first (frontier dropped,
        in-flight batches allowed to land) so the barrier doesn't chase a
        self-refilling pipeline, and resumed after."""
        pf = self.prefetcher
        if pf is not None:
            pf.quiesce()
        try:
            self._sched.drain()
        finally:
            if pf is not None:
                pf.resume()
        if self.spill is not None:
            self.spill.cut()
        # a global barrier seals every tenant's observation window too
        for ts in self._tenant_states.values():
            if ts.spill is not None:
                ts.spill.cut()

    # ------------------------------------------------------------------
    # error / lifecycle
    # ------------------------------------------------------------------

    @property
    def poisoned(self) -> bool:
        return self._sched.poisoned

    def reset_poison(self, tenant=None) -> None:
        """Clear the poisoned state after a transaction rollback handled the
        failure (the retry path of run_transaction).  With ``tenant``,
        clears only that tenant's flag — the global flag and every other
        tenant's are untouched."""
        self._sched.reset_poison(tenant)

    def close(self) -> None:
        """Orderly teardown: drain, then report the ledger (paper's global
        destructor double-report)."""
        if self._closed:
            return
        self.drain()
        self._closed = True
        self._sched.close()
        self.ledger.report()
        if self.sim is not None:
            # quiesce the simulation before anyone reads the clock: every
            # worker's exit path (final wakeup charge, detach) lands on the
            # virtual timeline *before* close returns, so makespan reads
            # are stable and run-to-run identical.  Only the attaching
            # driver detaches itself; a close from another thread joins
            # without touching the actor registry.
            if threading.get_ident() == self._sim_driver_ident:
                self.sim.block_begin()
                self._exec.join()
                self.sim.block_end()
                self.sim.detach()
            else:
                self._exec.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- introspection (chaos tests assert the engine ends quiescent) ----

    @property
    def _inflight(self) -> int:
        return self._sched.inflight

    @property
    def _last_op(self) -> dict:
        return self._sched.merged_last_op()

    @property
    def _pending_children(self) -> dict:
        return self._sched.merged_pending_children()

    # ------------------------------------------------------------------
    # execution (called from executor worker threads)
    # ------------------------------------------------------------------

    def _execute(self, op: _Op) -> None:
        op.started_at = time.monotonic()
        with op.flock:
            # claiming freezes the op: the optimizer can no longer absorb
            # new work into its payload or elide it from the stream
            op.claimed = True
            elided = op.elided
        tname = op.tenant.name if op.tenant is not None else None
        if op.cancelled or (self._sched.poisoned and self.abort_on_error) \
                or (op.tenant is not None and op.tenant.poisoned
                    and self.abort_on_error):
            op.error = OpCancelledError(f"{op.kind}{op.paths}")
            op.cancelled = True
            # a cancelled eager op was ACKed but never executed — without a
            # ledger entry a transaction commit (region-tagged) or the
            # checkpoint manager's path scan (untagged) would conclude the
            # I/O landed when it was silently dropped.  Speculative ops
            # were never ACKed to anyone — dropping them is their contract
            if op.eager and not op.speculative:
                self.ledger.record(op.seq, op.kind, op.paths, op.error,
                                   region=op.region, tenant=tname)
        elif elided:
            pass  # proven invisible at every observation point: no backend
        else:
            try:
                op.result = op.fn()
            except BaseException as e:  # noqa: BLE001
                op.error = e
                # the ledger exists for errors the caller never saw (paper:
                # "not properly reported back"); sync ops re-raise directly.
                # Speculative ops are advisory — their faults never reach
                # the ledger and must not poison (a ProcessKilled escaping
                # an advisory batch fn would otherwise nuke every tenant)
                if op.eager and not op.speculative:
                    self.ledger.record(op.seq, op.kind, op.paths, e,
                                       region=op.region, tenant=tname)
                    if self.abort_on_error:
                        # blast radius: a tenant op's failure poisons only
                        # its own tenant — neighbours' windows stay open
                        self._sched.poison(op.tenant)
        op.finished_at = time.monotonic()
        sp = self._spill_for(op.tenant)
        if sp is not None and not op.speculative:
            # outcome settles here, before the error-path invalidation and
            # outside every scheduler lock (recording may chunk-flush via
            # the speculative lane, which takes the scheduler control lock)
            if op.error is None and not op.cancelled:
                sp.record_done(op, elided)
            else:
                sp.record_fail(op)
        if op.error is not None and not op.speculative:
            # the write-through cache and the namespace overlay recorded
            # this op's effect at ACK time; it never materialized (failed
            # or cancelled), so every claim is wrong — drop them and let
            # the backend answer again.  (A speculative op claimed
            # nothing at admission: nothing to invalidate.)  Overlay
            # FIRST: its invalidate cancels speculation tickets under its
            # own lock — where speculative installs also warm the stat
            # cache — so by the time the cache is cleared below, no late
            # warming write can race back in behind the invalidation.
            for p in op.paths:
                if self.overlay is not None:
                    self.overlay.invalidate(p)
                self.stat_cache.invalidate(p)
                if self.readahead is not None:
                    self.readahead.invalidate(p)
                if self.stat_batcher is not None:
                    self.stat_batcher.invalidate(p)
        if self.overlay is not None:
            # a fused removal's re-verification witness is spent once the
            # op is done (ran, fell back, was elided into a parent, failed
            # or was cancelled) — unhook it from the overlay's watchers
            self.overlay.release_witness(getattr(op.payload, "witness",
                                                 None))
        if op.cancelled and op.payload is not None:
            # a speculative batch cancelled before it ran still holds its
            # overlay tickets and an in-flight-window slot — release them
            cb = getattr(op.payload, "on_cancelled", None)
            if cb is not None:
                cb()
        with self._sched._ctl:   # exact counters (see scheduler lock note)
            self.stats.exec_latency_s += op.finished_at - op.started_at
            self.stats.executed += 1
            if op.cancelled:
                self.stats.cancelled += 1
            elif op.error is not None and op.eager:
                self.stats.deferred_errors += 1
                self.stats.error_counts[op.kind] = \
                    self.stats.error_counts.get(op.kind, 0) + 1
                if getattr(op.error, "injected", False):
                    self.stats.injected_faults += 1
            if op.tenant is not None:
                tst = op.tenant.stats
                tst.executed += 1
                # per-tenant makespan probe: last completion on the shared
                # timeline (virtual seconds in sim mode)
                tst.last_complete_s = (self.sim.now()
                                       if self.sim is not None
                                       else time.monotonic())
                if not op.cancelled and op.error is not None and op.eager:
                    tst.deferred_errors += 1
        self._sched.on_complete(op)


__all__ = ["EagerIOEngine", "EngineStats", "TenantStats", "FusionPolicy",
           "MetaPayload", "NamespaceOverlay", "OverlayPolicy", "ReadPolicy",
           "WritePayload", "NEEDS_CHILDREN", "STRUCTURAL"]
