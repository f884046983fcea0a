"""Speculative metadata prefetch pipeline for cold directory trees.

The engine hides *write* latency by deferring and fusing mutations, and
PR 3/4's namespace overlay answers namespace reads from pending state —
but only once a tree is *warm*.  The paper's model tasks (extract a tree
you just scanned, ``rm -rf`` a tree you must first enumerate) open with a
**cold metadata walk** that costed one synchronous ``readdir_plus``
roundtrip per directory, serialized by the walk's own recursion: O(dirs x
RTT), the last unpipelined metadata path in the engine.

This module closes it with a bounded breadth-first prefetch frontier:

* when a cold ``readdir``/``walk`` misses the overlay and its executed
  listing discovers subdirectories, those are enqueued on the frontier;
* the frontier drains in *batched* background reads — ONE vectored
  ``readdir_plus_vec`` backend call per batch (``LatencyBackend`` pays a
  single roundtrip), with the batch width sized from the backend's live
  RTT/bandwidth EWMAs (``bdp_bytes``, PR 4's plumbing) so one batch
  carries ~2x a bandwidth-delay product of dirents;
* results install into the ``NamespaceOverlay`` as cached listings —
  **without sealing and without counting as observations** — at LRU-cold
  recency, so speculation can never evict the hot in-use window;
* each discovered level seeds the next: the fetch pipeline runs ahead of
  the consumer, turning O(depth x RTT + dirs x RTT) cold walks into
  O(depth x RTT + dirs/B x RTT).

The pipeline is strictly **advisory**:

* batches ride the scheduler's *low-priority* ready lanes
  (``OpScheduler.submit_speculative``): they take and grant no DAG edges,
  real ops always dispatch first, and a full in-flight budget makes the
  prefetcher yield instead of blocking anyone;
* every enqueued directory holds a ``SpeculationTicket`` in the overlay;
  any racing admitted mutation that could make the fetched listing stale
  (rmdir/rename/remove_tree under the prefix, a mkdir over it, an op
  failure, rollback) cancels the ticket and the listing is dropped on
  arrival — observed semantics stay byte-identical to the unprefetched
  engine (the prefetch on/off equivalence property suite);
* fetch failures — including injected faults, which fire once per *fused*
  batch — are swallowed: nothing lands in the ledger, no region is
  condemned, the engine is never poisoned, and the consumer simply falls
  back to its per-directory sync path.

``EngineStats`` reports ``prefetch_issued`` (dirs sent in batches),
``prefetch_batches`` (vectored calls), ``prefetch_hits`` (overlay reads
answered from a speculative listing), ``prefetch_wasted`` (fetched but
uninstallable: failed, stale, or evicted at insert) and
``prefetch_cancelled`` (invalidated by racing mutations or teardown).
"""
from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass

from .backend import norm_path


@dataclass(frozen=True)
class PrefetchPolicy:
    """Knobs of the speculative prefetch pipeline (``CannyFS(prefetch=
    PrefetchPolicy(...))``; ``prefetch=False`` disables it, the default
    enables it whenever the namespace overlay is on).

    ``max_batch``/``min_batch`` bound one vectored ``readdir_plus_vec``
    call's width; with ``adaptive_batch`` and a backend that measures its
    bandwidth-delay product (``LatencyBackend.bdp_bytes``), the width is
    ~``bdp_multiplier`` x BDP worth of ``bytes_per_dirent``-sized entries
    within those bounds — the same self-tuning the write coalescer uses.
    ``max_inflight_batches`` clamps the pipeline's in-flight window (≈
    RTT x width of speculation outstanding at once) and
    ``max_outstanding`` bounds the whole frontier, so an adversarially
    wide tree cannot queue unbounded speculation."""

    enabled: bool = True
    max_batch: int = 32
    min_batch: int = 4
    adaptive_batch: bool = True
    bdp_multiplier: float = 2.0
    bytes_per_dirent: int = 256
    max_inflight_batches: int = 2
    max_outstanding: int = 4096
    warm_stat_cache: bool = True   # listings also warm the stat cache

    @classmethod
    def off(cls) -> "PrefetchPolicy":
        return cls(enabled=False)


class _BatchPayload:
    """Payload of one speculative batch op; the engine calls
    ``on_cancelled`` when poison cancels the op before it ran, so the
    tickets are released and the in-flight window reopens."""

    __slots__ = ("batch", "prefetcher")

    def __init__(self, batch, prefetcher):
        self.batch = batch              # [(path, SpeculationTicket)]
        self.prefetcher = prefetcher

    def on_cancelled(self) -> None:
        self.prefetcher._abort_batch(self.batch)


class MetadataPrefetcher:
    """The bounded BFS frontier + batch pump.  One per engine; all entry
    points are thread-safe and non-blocking.  Holds its own lock above
    the overlay's (never the reverse): overlay methods are called only
    outside ``_lock``."""

    def __init__(self, engine, policy: PrefetchPolicy):
        self.engine = engine
        self.policy = policy
        bdp = getattr(engine.backend, "bdp_bytes", None)
        self._bdp = bdp if callable(bdp) else None
        # per-op-class cost hints (CostModel protocol) outrank the scalar
        # probe: listings are sized by the "readdir" class, so a backend
        # with paginated LISTs sizes the pipeline from listing costs, not
        # from data-plane bandwidth
        cost = getattr(engine.backend, "cost_hint", None)
        self._cost = cost if callable(cost) else None
        self._lock = threading.Lock()
        self._slock = threading.Lock()     # exact counters (leaf)
        self._frontier: deque = deque()    # (path, ticket)
        self._inflight_batches = 0
        self._quiesced = 0                 # drain depth (see quiesce())
        # path -> the submitted batch op fetching it (consumer latch)
        self._inflight_paths: dict = {}

    # ------------------------------------------------------------------
    # sizing
    # ------------------------------------------------------------------

    def _bdp_bytes(self):
        """Listing-class BDP: the backend's "readdir" cost hint when it
        has one, else the legacy scalar probe, else None."""
        if self._cost is not None:
            hint = self._cost("readdir", 0)
            if hint is not None:
                return hint.bdp_bytes()
        if self._bdp is not None:
            return self._bdp()
        return None

    def batch_width(self) -> int:
        """Dirs per vectored call: ~2x the measured BDP worth of dirents
        when the backend exposes one, else the policy cap."""
        pol = self.policy
        if not pol.adaptive_batch:
            return pol.max_batch
        bdp = self._bdp_bytes()
        if not bdp:
            return pol.max_batch
        return max(pol.min_batch,
                   min(int(pol.bdp_multiplier * bdp / pol.bytes_per_dirent),
                       pol.max_batch))

    # ------------------------------------------------------------------
    # frontier
    # ------------------------------------------------------------------

    def seed(self, listing) -> None:
        """Enqueue the subdirectories discovered by one executed listing
        ``[(child_path, StatResult|None), ...]`` and pump the pipeline."""
        if self._quiesced:
            return
        ov = self.engine.overlay
        wanted = []
        for child, st in listing:
            if st is None or not st.is_dir or st.is_symlink:
                continue
            t = ov.speculation_wanted(norm_path(child))
            if t is not None:
                wanted.append((t.path, t))
        if not wanted:
            return
        overflow = []
        with self._lock:
            room = self.policy.max_outstanding - len(self._frontier)
            if room < len(wanted):
                overflow = wanted[max(room, 0):]
                wanted = wanted[:max(room, 0)]
            self._frontier.extend(wanted)
        for _, t in overflow:
            ov.end_speculation(t)
        if overflow:
            with self._slock:
                self.engine.stats.prefetch_cancelled += len(overflow)
        self._pump()

    def seed_children(self, path: str, listing) -> None:
        """Convenience: ``seed`` with names resolved against ``path``."""
        path = norm_path(path)
        self.seed([(f"{path}/{name}" if path else name, st)
                   for name, st in listing])

    def _pump(self) -> None:
        """Issue batches while the in-flight window has room.  Never
        blocks: a declined submission (budget full / poisoned / closed)
        drops the batch and releases its tickets.  Batch hygiene: an
        *undersized* frontier is held back while another batch is still
        in flight — its installs are about to seed more of this level,
        and flushing early would fragment the level into sub-width
        roundtrips (a consumer that cannot wait sync-misses exactly as
        it would have anyway)."""
        ov = self.engine.overlay
        while True:
            with self._lock:
                if (self._quiesced or not self._frontier
                        or self._inflight_batches
                        >= self.policy.max_inflight_batches):
                    return
                width = self.batch_width()
                if (len(self._frontier) < width
                        and self._inflight_batches > 0):
                    return
                batch = []
                while self._frontier and len(batch) < width:
                    batch.append(self._frontier.popleft())
                self._inflight_batches += 1
            live = []
            dropped = 0
            for p, t in batch:
                if t.cancelled:
                    ov.end_speculation(t)
                    dropped += 1
                else:
                    live.append((p, t))
            if dropped:
                with self._slock:
                    self.engine.stats.prefetch_cancelled += dropped
            if not live:
                with self._lock:
                    self._inflight_batches -= 1
                continue
            payload = _BatchPayload(live, self)
            op = self.engine._sched.submit_speculative(
                "prefetch", tuple(p for p, _ in live),
                lambda b=live: self._run_batch(b), payload=payload)
            if op is None:      # engine busy/poisoned/closed: yield
                self._abort_batch(live)
                return
            with self._lock:
                for p, _ in live:
                    self._inflight_paths[p] = op
            with self._slock:
                st = self.engine.stats
                st.prefetch_batches += 1
                st.prefetch_issued += len(live)

    def _abort_batch(self, batch) -> None:
        ov = self.engine.overlay
        for _, t in batch:
            ov.end_speculation(t)
        with self._slock:
            self.engine.stats.prefetch_cancelled += len(batch)
        with self._lock:
            self._inflight_batches -= 1
            for p, _ in batch:
                self._inflight_paths.pop(p, None)

    # ------------------------------------------------------------------
    # the batch body (runs on an executor worker, low priority)
    # ------------------------------------------------------------------

    def _run_batch(self, batch) -> None:
        eng = self.engine
        ov = eng.overlay
        stats = eng.stats
        try:
            live = []
            cancelled = 0
            for p, t in batch:
                if t.cancelled:      # racing mutation beat the fetch
                    ov.end_speculation(t)
                    cancelled += 1
                else:
                    live.append((p, t))
            if cancelled:
                with self._slock:
                    stats.prefetch_cancelled += cancelled
            if not live:
                return
            try:
                listings = eng.backend.readdir_plus_vec(
                    [p for p, _ in live])
            except OSError:
                # advisory: an injected (or real) fault on the fused
                # batch drops it whole — no ledger entry, no poison; the
                # consumer falls back to its per-directory sync path
                for _, t in live:
                    ov.end_speculation(t)
                with self._slock:
                    stats.prefetch_wasted += len(live)
                return
            warm = (self.policy.warm_stat_cache
                    and ov.policy.prefetch)
            cache = eng.stat_cache
            for p, t in live:
                listing = listings.get(p)
                if listing is None:   # vanished/denied: per-dir advisory
                    ov.end_speculation(t)
                    with self._slock:
                        stats.prefetch_wasted += 1
                    continue
                def warm_cb(p=p, listing=listing):
                    # runs inside the overlay's install critical section:
                    # warming is atomic with the ticket re-check, so a
                    # racing op failure — which invalidates the overlay
                    # (this lock) *before* the stat cache — always clears
                    # any entry warmed here, and a cancelled batch never
                    # plants stat entries the unprefetched engine could
                    # not have held
                    warmed = 0
                    for name, stt in listing:
                        child = f"{p}/{name}" if p else name
                        if stt is not None and cache.get(child) is None:
                            cache.put(child, stt)
                            warmed += 1
                    if warmed:
                        with self._slock:
                            stats.prefetched_stats += warmed
                verdict = ov.install_speculative(
                    t, listing, warm=warm_cb if warm else None)
                if verdict == "installed":
                    if not self._quiesced:
                        self.seed_children(p, listing)
                elif verdict == "cancelled":
                    with self._slock:
                        stats.prefetch_cancelled += 1
                else:                 # "stale" | "evicted"
                    with self._slock:
                        stats.prefetch_wasted += 1
        finally:
            with self._lock:
                self._inflight_batches -= 1
                for p, _ in batch:
                    self._inflight_paths.pop(p, None)
            self._pump()

    # ------------------------------------------------------------------
    # consumer latch
    # ------------------------------------------------------------------

    def wait_for(self, path: str) -> bool:
        """A consumer missed the overlay on ``path`` while the pipeline
        already covers it: wait for the covering batch to land and
        return True (the caller re-checks the overlay — a hit costs zero
        extra roundtrips instead of a duplicate fetch).

        A path still *queued* on the frontier is **demand-promoted**: its
        entry (plus up to a batch width of queued neighbours — the
        walker's next targets) is force-issued immediately, bypassing
        the in-flight window, and the caller latches onto that batch.
        The consumer's stall then costs the same one RTT its sync miss
        would have, but warms a whole batch aligned with its position —
        this is what keeps the pipeline ahead of a depth-first walker
        on wide levels.

        Returns False when the pipeline has nothing for the path (never
        seeded, ticket cancelled, or submission declined): the caller
        takes its sync path exactly as before.  Deadlock-free: the wait
        happens on the *caller's* thread, never on a pool worker
        (fs.readdir latches before submitting its sync op)."""
        path = norm_path(path)
        batch = None
        with self._lock:
            op = self._inflight_paths.get(path)
            if op is None and not self._quiesced:
                # demand promotion: find the path's frontier entry and
                # lead a batch with it
                for i, (p, _t) in enumerate(self._frontier):
                    if p == path:
                        self._frontier.rotate(-i)
                        width = self.batch_width()
                        batch = []
                        while self._frontier and len(batch) < width:
                            batch.append(self._frontier.popleft())
                        self._inflight_batches += 1
                        break
        if batch is not None:
            live = [(p, t) for p, t in batch if not t.cancelled]
            dead = [(p, t) for p, t in batch if t.cancelled]
            if dead:
                ov = self.engine.overlay
                for _, t in dead:
                    ov.end_speculation(t)
                with self._slock:
                    self.engine.stats.prefetch_cancelled += len(dead)
            if not live:
                with self._lock:
                    self._inflight_batches -= 1
                return False
            payload = _BatchPayload(live, self)
            op = self.engine._sched.submit_speculative(
                "prefetch", tuple(p for p, _ in live),
                lambda b=live: self._run_batch(b), payload=payload)
            if op is None:
                self._abort_batch(live)
                return False
            with self._lock:
                for p, _ in live:
                    self._inflight_paths[p] = op
            with self._slock:
                st = self.engine.stats
                st.prefetch_batches += 1
                st.prefetch_issued += len(live)
        if op is None:
            return False
        sim = self.engine.sim
        if sim is not None:
            # discrete-event mode: the latch is an off-timeline wait (the
            # covering batch's completion is the wake), bracketed so the
            # event queue can advance virtual time past this consumer
            sim.wait_event(op.done)
        else:
            op.done.wait()
        return True

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def quiesce(self) -> None:
        """Stop issuing and drop the frontier (tickets released) — called
        by ``engine.drain()`` so a global barrier doesn't chase a
        self-refilling pipeline; in-flight batches finish and install as
        usual.  Nested drains stack (``resume`` unwinds one level)."""
        with self._lock:
            self._quiesced += 1
            dropped = list(self._frontier)
            self._frontier.clear()
        ov = self.engine.overlay
        for _, t in dropped:
            ov.end_speculation(t)
        if dropped:
            with self._slock:
                self.engine.stats.prefetch_cancelled += len(dropped)

    def resume(self) -> None:
        with self._lock:
            self._quiesced = max(0, self._quiesced - 1)


__all__ = ["MetadataPrefetcher", "PrefetchPolicy"]
