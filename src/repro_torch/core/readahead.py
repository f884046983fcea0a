"""Vectored read-side data plane: BDP-sized read-ahead + stat batching.

The engine hides *write* latency by deferring and fusing mutations, and
the PR 5 prefetcher pipelines cold *metadata* walks — but the cold data
read path still costed one synchronous backend roundtrip per ``read``
and one per journaling existence probe, which is exactly the serialized
pattern that dominates checkpoint restore and data-shard ingestion in
the training loop.  This module closes it with two speculative
consumers of the new vectored backend primitives:

``ReadAheadManager`` — the buffered read-ahead file layer.  A
sequential consumer's first sync read of a known-size file registers a
per-file page buffer guarded by a ``SpeculationTicket`` and issues a
speculative ``read_vec`` *window* sized to ~``bdp_multiplier`` x the
backend's measured bandwidth-delay product (``bdp_bytes`` EWMAs, the
same clamping discipline as ``FusionPolicy.adaptive_max_bytes``).
Subsequent preads are served from the installed pages without a
roundtrip; every page hit extends the frontier by one more window
(clamped to the known file size), so a streaming reader pays
``1 + ceil((size - first_read) / window)`` roundtrips instead of one
per chunk.  A consumer that outruns the pipeline *latches* onto the
in-flight window op (one shared roundtrip) instead of duplicating the
fetch.

``StatVecBatcher`` — existence batching for the write path's
journaling probes.  Inside a transaction, ``create`` and an
implicit-create ``write`` must learn whether their target pre-existed
(journal a create vs. mark pre-existing).  The probes enqueue at
submission, flush as ONE speculative ``stat_vec`` per fused batch, and
the op's fn consumes the landed answer at execution time — falling
back to today's sync ``stat`` whenever the batch lost the race.

Both are strictly **advisory** and byte-identical to the unbuffered
engine, by the same ticket discipline as the metadata prefetcher:

* speculation registers only while the path (and, for read-ahead, its
  ancestors) has no pending ops — earlier-admitted work can never be
  overtaken;
* any racing *admitted* mutation that could change the answer —
  write/truncate/create/unlink on the file, rename/rmdir/remove_tree
  at or above it, an op failure, a transaction rollback — cancels the
  ticket, and installs are refused on arrival;
* probe consumption is single-shot: the first lookup (hit or miss)
  retires the entry and cancels its ticket, so a late install can
  never leak a stale answer into a later transaction;
* fetch failures — including injected faults, which fire once per
  *fused* batch — are swallowed: nothing lands in the ledger, no
  region is condemned, and the consumer falls back to its sync path.

``EngineStats`` reports ``readahead_{windows,hits,latched,bytes,
wasted,cancelled}`` and ``stat_{batches,probes,probe_hits,
probe_fallbacks}``.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass

from .backend import is_under, norm_path, parent_of
from .namespace import SpeculationTicket


@dataclass(frozen=True)
class ReadPolicy:
    """Knobs of the read-side data plane (``CannyFS(readahead=
    ReadPolicy(...))``; ``readahead=False`` disables it, the default
    enables it).

    ``min_bytes``/``max_bytes`` bound one speculative ``read_vec``
    window; with ``adaptive`` and a backend that measures its
    bandwidth-delay product (``LatencyBackend.bdp_bytes``), the window
    is ~``bdp_multiplier`` x BDP within those bounds — the same
    self-tuning the write coalescer and the metadata prefetcher use.
    ``max_files`` LRU-bounds the per-file page buffers so speculation
    can never hold unbounded memory.  ``stat_batching``/``stat_batch``
    gate and size the write-path existence batcher."""

    enabled: bool = True
    min_bytes: int = 64 << 10
    max_bytes: int = 8 << 20
    adaptive: bool = True
    bdp_multiplier: float = 2.0
    max_files: int = 64
    stat_batching: bool = True
    stat_batch: int = 16

    @classmethod
    def off(cls) -> "ReadPolicy":
        return cls(enabled=False)


# op kinds whose admission invalidates speculation exactly on the op's
# paths (content or existence of that file changes when they execute)
_EXACT_KINDS = frozenset({
    "write", "truncate", "fallocate", "create", "unlink", "mkdir",
    "symlink", "link",
})
# op kinds whose admission invalidates every speculation under their
# paths (a subtree moves or vanishes)
_TREE_KINDS = frozenset({"rename", "rmdir", "remove_tree"})
# the engine brackets these kinds' admissions with its in-flight guard:
# their on_admit cancellation hook runs before the scheduler publishes
# the op, so registration must decline while one is mid-admission
INVALIDATING_KINDS = _EXACT_KINDS | _TREE_KINDS
# ancestor tips that cannot change a *file's* existence or bytes: a
# pending mkdir of a parent only brings the directory into being (the
# DAG orders the probed op after it), and pure-metadata tips touch no
# namespace at all.  Anything else pending above the path refuses
# registration — earlier-admitted structural work must win.
_BENIGN_ANCESTOR_KINDS = frozenset({
    "mkdir", "chmod", "chown", "utimens", "setxattr", "removexattr",
    "fsync", "stat", "readdir",
})


class _WindowPayload:
    """Payload of one speculative window fetch; the engine calls
    ``on_cancelled`` when poison/close cancels the op before it ran, so
    the in-flight marker clears and the consumer's latch falls through
    to its sync path."""

    __slots__ = ("manager", "path", "ticket")

    def __init__(self, manager, path, ticket):
        self.manager = manager
        self.path = path
        self.ticket = ticket

    def on_cancelled(self) -> None:
        self.manager._window_aborted(self.path, self.ticket)


class _FileState:
    """One file's read-ahead run: a contiguous page buffer
    ``[start, start + len(buf))`` plus at most one in-flight window."""

    __slots__ = ("path", "ticket", "start", "buf", "expected", "size",
                 "inflight_op", "inflight_start", "inflight_end")

    def __init__(self, path: str, ticket: SpeculationTicket,
                 expected: int, size: int):
        self.path = path
        self.ticket = ticket
        self.start = expected       # buffer origin (empty buf)
        self.buf = b""
        self.expected = expected    # next sequential offset
        self.size = size            # known file size (fetch clamp ONLY)
        self.inflight_op = None
        self.inflight_start = 0
        self.inflight_end = 0


class ReadAheadManager:
    """The per-file page buffers + window pump.  One per engine; all
    entry points are thread-safe.  Holds its own lock (``_slock`` is
    the stats leaf lock, mirroring the prefetcher's discipline); the
    scheduler is only entered for non-blocking calls."""

    def __init__(self, engine, policy: ReadPolicy):
        self.engine = engine
        self.policy = policy
        bdp = getattr(engine.backend, "bdp_bytes", None)
        self._bdp = bdp if callable(bdp) else None
        # CostModel protocol: the "read" class hint outranks the scalar
        # probe, so the window is sized from read-request costs even when
        # the backend's metadata ops are billed differently
        cost = getattr(engine.backend, "cost_hint", None)
        self._cost = cost if callable(cost) else None
        self._lock = threading.Lock()
        self._slock = threading.Lock()
        self._files: OrderedDict[str, _FileState] = OrderedDict()

    # ------------------------------------------------------------------
    # sizing
    # ------------------------------------------------------------------

    def _bdp_bytes(self):
        if self._cost is not None:
            hint = self._cost("read", 0)
            if hint is not None:
                return hint.bdp_bytes()
        if self._bdp is not None:
            return self._bdp()
        return None

    def window(self) -> int:
        """Bytes per speculative fetch: ~2x the measured BDP when the
        backend exposes one, else the policy cap — the same clamp
        discipline as ``FusionPolicy.adaptive_max_bytes``."""
        pol = self.policy
        if not pol.adaptive:
            return pol.max_bytes
        bdp = self._bdp_bytes()
        if not bdp:
            return pol.max_bytes
        return max(pol.min_bytes,
                   min(int(pol.bdp_multiplier * bdp), pol.max_bytes))

    # ------------------------------------------------------------------
    # the read path (called by fs.pread on the consumer's thread)
    # ------------------------------------------------------------------

    def read(self, path: str, offset: int, size: int):
        """Serve ``[offset, offset + size)`` from installed pages, or
        latch onto the in-flight window covering the offset and re-try
        once, or return None — the caller then takes the sync path.  A
        hit is byte-identical to the sync read: pages register only on
        quiescent paths and cancel on any racing admitted mutation, so
        a valid page IS the backend's current content.  Reads are never
        served past the buffered run (EOF knowledge only clamps
        *fetches*, it never answers a consumer)."""
        if size < 0:
            return None
        path = norm_path(path)
        out, op = self._try_serve(path, offset, size)
        if out is not None or op is None:
            return out
        # consumer latch: the covering window is already on the wire —
        # wait for it on the caller's thread (never a pool worker) and
        # re-check, exactly one shared roundtrip instead of a duplicate
        sim = self.engine.sim
        if sim is not None:
            sim.wait_event(op.done)
        else:
            op.done.wait()
        with self._slock:
            self.engine.stats.readahead_latched += 1
        out, _ = self._try_serve(path, offset, size)
        return out

    def _try_serve(self, path: str, offset: int, size: int):
        """-> (bytes | None, latchable in-flight op | None)."""
        issue = None
        with self._lock:
            st = self._files.get(path)
            if st is None:
                return None, None
            if st.ticket.cancelled:
                self._drop_locked(path, st, count=False)
                return None, None
            self._files.move_to_end(path)
            end = offset + size
            buf_end = st.start + len(st.buf)
            if st.start <= offset and end <= buf_end:
                out = st.buf[offset - st.start:end - st.start]
                # trim the consumed prefix: sequential readers never
                # look back, and this bounds the buffer to one window
                st.buf = st.buf[end - st.start:]
                st.start = end
                st.expected = end
                # frontier extension: every hit keeps exactly one
                # window in flight until the known size is covered
                if st.inflight_op is None:
                    issue = self._next_window_locked(st)
            elif (st.inflight_op is not None
                    and st.inflight_start <= offset < st.inflight_end):
                return None, st.inflight_op
            else:
                return None, None
        with self._slock:
            self.engine.stats.readahead_hits += 1
        if issue is not None:
            self._issue(*issue)
        return out, None

    def observe_sync(self, path: str, offset: int, nbytes: int,
                     requested: int) -> None:
        """One sync read executed.  A fresh file read sequentially from
        offset 0 (or a sequential continuation after a cancelled
        window) triggers the first speculative window; a short read
        learned EOF and stops the pipeline; a non-sequential offset
        drops the state (random access)."""
        if requested < 0:
            return
        path = norm_path(path)
        issue = None
        with self._lock:
            st = self._files.get(path)
            if st is not None:
                if st.ticket.cancelled:
                    self._drop_locked(path, st, count=False)
                    st = None
                elif nbytes < requested:
                    # EOF: nothing left to speculate on
                    self._drop_locked(path, st, count=False)
                    return
                elif offset == st.expected:
                    # sequential miss (window cancelled/declined): resync
                    # the buffer origin and restart the pipeline
                    st.expected = offset + nbytes
                    st.start = st.expected
                    st.buf = b""
                    if st.inflight_op is None:
                        issue = self._next_window_locked(st)
                else:
                    self._drop_locked(path, st)
                    st = None
            if st is None and issue is None:
                if offset != 0 or nbytes < requested or nbytes == 0:
                    return
                size = self._known_size(path)
                if size is None or size <= nbytes:
                    return
                if not self._quiescent(path):
                    return
                st = _FileState(path, SpeculationTicket(path),
                                expected=nbytes, size=size)
                self._files[path] = st
                while len(self._files) > self.policy.max_files:
                    old, ost = next(iter(self._files.items()))
                    self._drop_locked(old, ost)
                issue = self._next_window_locked(st)
        if issue is not None:
            self._issue(*issue)

    # ------------------------------------------------------------------
    # window issue / install (the speculative fetch)
    # ------------------------------------------------------------------

    def _known_size(self, path: str):
        """The file's settled size, from the stat cache (registration
        requires a quiescent path, so a cached size is not mid-flight).
        Used ONLY to clamp fetch extents — never to answer a read."""
        st = self.engine.stat_cache.get(path)
        if st is None or not st.exists or st.is_dir or st.is_symlink:
            return None
        return st.size

    def _next_window_locked(self, st: _FileState):
        """Compute the next window for ``st`` (frontier = end of the
        buffered run) or None when the known size is covered.  Caller
        holds ``_lock`` and issues outside stats."""
        frontier = st.start + len(st.buf)
        if frontier >= st.size:
            return None
        length = min(self.window(), st.size - frontier)
        return st, frontier, length

    def _issue(self, st: _FileState, start: int, length: int) -> None:
        path, ticket = st.path, st.ticket
        backend = self.engine.backend

        def fn():
            try:
                data = backend.read_vec(path, [(start, length)])[0]
            except OSError:
                # advisory: an injected (or real) fault on the fused
                # window drops it whole — no ledger entry, no poison;
                # the consumer sync-reads and the pipeline restarts
                data = None
            self._install(path, ticket, start, data)

        op = self.engine._sched.submit_speculative(
            "read_ahead", (path,), fn,
            payload=_WindowPayload(self, path, ticket))
        with self._lock:
            cur = self._files.get(path)
            if cur is st and op is not None:
                st.inflight_op = op
                st.inflight_start = start
                st.inflight_end = start + length
        if op is None:
            return
        with self._slock:
            self.engine.stats.readahead_windows += 1

    def _install(self, path: str, ticket: SpeculationTicket,
                 start: int, data) -> None:
        """Land one fetched window (runs on an executor worker).  The
        ticket re-check happens under the manager lock, so a racing
        admitted mutation's cancellation always wins over the install —
        a cancelled window never plants bytes the unbuffered engine
        could not have read."""
        wasted = False
        with self._lock:
            st = self._files.get(path)
            if st is None or st.ticket is not ticket or ticket.cancelled:
                wasted = True
            else:
                if st.inflight_op is not None:
                    st.inflight_op = None
                if data is None:
                    wasted = True
                elif start == st.start + len(st.buf):
                    st.buf = st.buf + data
                    if len(data) < st.inflight_end - start:
                        # short fetch: the file is smaller than the stat
                        # suggested — learn the EOF and stop speculating
                        st.size = min(st.size, start + len(data))
                else:
                    wasted = True   # stale vs. a consumer resync
        with self._slock:
            stats = self.engine.stats
            if wasted:
                stats.readahead_wasted += 1
            else:
                stats.readahead_bytes += len(data)

    def _window_aborted(self, path: str, ticket: SpeculationTicket) -> None:
        with self._lock:
            st = self._files.get(path)
            if st is not None and st.ticket is ticket:
                st.inflight_op = None
        with self._slock:
            self.engine.stats.readahead_wasted += 1

    # ------------------------------------------------------------------
    # invalidation (racing admitted mutations / failures / rollback)
    # ------------------------------------------------------------------

    def _quiescent(self, path: str) -> bool:
        """True iff nothing already admitted can still change this
        file's bytes: no pending op on the path, no invalidating
        admission mid-flight (its cancellation hook has already fired
        but the op is not yet visible to ``pending_tip``), and no
        pending non-benign op on any ancestor.  Later admissions are
        the ``on_op`` hook's job."""
        eng = self.engine
        with eng._adm_lock:
            if eng._admitting:
                return False
        sched = eng._sched
        if sched.pending_tip(path) is not None:
            return False
        anc = parent_of(path)
        while True:
            tip = sched.pending_tip(anc)
            if tip is not None and tip.kind not in _BENIGN_ANCESTOR_KINDS:
                return False
            if not anc:
                return True
            anc = parent_of(anc)

    def _drop_locked(self, path: str, st: _FileState,
                     count: bool = True) -> None:
        st.ticket.cancelled = True
        self._files.pop(path, None)
        if count:
            with self._slock:
                self.engine.stats.readahead_cancelled += 1

    def on_op(self, kind: str, paths) -> None:
        """Admission hook (engine.submit's on_admit): cancel every
        speculation the op could invalidate once it executes."""
        if kind in _TREE_KINDS:
            with self._lock:
                for p, st in [(p, st) for p, st in self._files.items()
                              if any(is_under(p, q) for q in paths)]:
                    self._drop_locked(p, st)
        elif kind in _EXACT_KINDS:
            with self._lock:
                for q in paths:
                    st = self._files.get(q)
                    if st is not None:
                        self._drop_locked(q, st)

    def invalidate(self, path: str) -> None:
        """A background op on ``path`` failed after claiming its effect
        at ACK time — every speculation there is suspect."""
        with self._lock:
            st = self._files.get(path)
            if st is not None:
                self._drop_locked(path, st)

    def clear(self) -> None:
        """Transaction rollback mutates the backend directly (bypassing
        admission), so every page is suspect — drop them all."""
        with self._lock:
            for p, st in list(self._files.items()):
                self._drop_locked(p, st)


# ---------------------------------------------------------------------------


class _Probe:
    """One enqueued existence probe.  ``exempt_kind`` is the probed op's
    own kind: its (single) admission must not cancel the probe — it IS
    the consumer.  Per-path FIFO then orders every later same-path
    admission after the consumer's execution, so post-exemption
    admissions are harmless; any *other* admission before the exemption
    is consumed cancels (a foreign op slipped between enqueue and the
    consumer's admission)."""

    __slots__ = ("path", "ticket", "exempt_kind", "exempt_used", "value",
                 "flushed")

    def __init__(self, path: str, exempt_kind: str):
        self.path = path
        self.ticket = SpeculationTicket(path)
        self.exempt_kind = exempt_kind
        self.exempt_used = False
        self.value = None           # StatResult once a batch landed
        self.flushed = False        # left the pending buffer as a batch


class _ProbeBatchPayload:
    __slots__ = ("batcher", "batch")

    def __init__(self, batcher, batch):
        self.batcher = batcher
        self.batch = batch

    def on_cancelled(self) -> None:
        self.batcher._batch_aborted(self.batch)


class StatVecBatcher:
    """Fuses the write path's journaling existence probes into
    speculative ``stat_vec`` batches (one advisory rule match per fused
    batch on a fault-injecting stack).  Single-shot consumption keeps
    it exact: ``lookup`` retires the entry and cancels its ticket, so a
    batch that lost the race installs into nothing and the consumer's
    sync fallback is today's behaviour, RTT for RTT."""

    def __init__(self, engine, policy: ReadPolicy):
        self.engine = engine
        self.policy = policy
        # CostModel protocol: the "stat" class hint sizes the probe batch
        # (a high-RTT stat pipeline wants wider fusion); the policy's
        # ``stat_batch`` stays the hard ceiling either way
        cost = getattr(engine.backend, "cost_hint", None)
        self._cost = cost if callable(cost) else None
        self._lock = threading.Lock()
        self._slock = threading.Lock()
        self._entries: dict[str, _Probe] = {}
        self._pending: list[_Probe] = []   # enqueued, not yet flushed

    def effective_batch(self) -> int:
        """Probes per fused ``stat_vec``: ~2x the "stat" class BDP worth
        of ~256-byte attr records, floored at 4 and capped by the policy
        bound (which always wins, so cost-blind stacks are unchanged)."""
        pol = self.policy
        if self._cost is not None:
            hint = self._cost("stat", 0)
            if hint is not None:
                adaptive = max(4, int(2.0 * hint.bdp_bytes() / 256))
                return min(pol.stat_batch, adaptive)
        return pol.stat_batch

    # ------------------------------------------------------------------
    # producer side (fs.create / fs._write_at, at submission time)
    # ------------------------------------------------------------------

    def enqueue(self, path: str, exempt_kind: str) -> None:
        """Register one probe for ``path`` ahead of its op's admission.
        Declined (silently — the consumer just sync-stats) when the
        path or an ancestor has non-benign pending work: the answer
        would depend on ops the speculative lane can overtake."""
        path = norm_path(path)
        eng = self.engine
        with eng._adm_lock:
            if eng._admitting:
                return
        sched = eng._sched
        if sched.pending_tip(path) is not None:
            return
        anc = parent_of(path)
        while True:
            tip = sched.pending_tip(anc)
            if tip is not None and tip.kind not in _BENIGN_ANCESTOR_KINDS:
                return
            if not anc:
                break
            anc = parent_of(anc)
        flush = None
        with self._lock:
            if path in self._entries:
                return
            probe = _Probe(path, exempt_kind)
            self._entries[path] = probe
            self._pending.append(probe)
            if len(self._pending) >= self.effective_batch():
                flush = self._pending
                self._pending = []
        with self._slock:
            self.engine.stats.stat_probes += 1
        if flush is not None:
            self._flush(flush)

    def flush(self) -> None:
        """Flush a partial pending batch (consumers are catching up — the
        window for growing it further has passed)."""
        with self._lock:
            batch, self._pending = self._pending, []
        if batch:
            self._flush(batch)

    def _flush(self, batch) -> None:
        for p in batch:
            p.flushed = True
        live = [p for p in batch if not p.ticket.cancelled]
        if not live:
            return
        backend = self.engine.backend

        def fn(batch=live):
            try:
                res = backend.stat_vec([p.path for p in batch])
            except OSError:
                # advisory: a fault on the fused batch (ONE rule match)
                # drops it whole — consumers fall back per-path
                res = {}
            self._land(batch, res)

        op = self.engine._sched.submit_speculative(
            "stat", tuple(p.path for p in live), fn,
            payload=_ProbeBatchPayload(self, live))
        if op is not None:
            with self._slock:
                self.engine.stats.stat_batches += 1

    def _land(self, batch, res) -> None:
        with self._lock:
            for probe in batch:
                if probe.ticket.cancelled:
                    continue
                if self._entries.get(probe.path) is not probe:
                    continue            # already consumed: refuse
                st = res.get(probe.path)
                if st is not None:
                    probe.value = st

    def _batch_aborted(self, batch) -> None:
        # poison/close cancelled the batch op before it ran: consumers
        # fall back — nothing to release beyond the entries themselves,
        # which lookup() retires
        pass

    # ------------------------------------------------------------------
    # consumer side (the probed op's fn, at execution time)
    # ------------------------------------------------------------------

    def lookup(self, path: str):
        """Single-shot consume: the landed ``StatResult`` or None (sync
        fallback).  Retiring the entry cancels its ticket, so a batch
        still on the wire installs into nothing — a late answer can
        never leak into a later transaction's probe of the same path."""
        path = norm_path(path)
        flush = None
        with self._lock:
            probe = self._entries.pop(path, None)
            if probe is None:
                return None
            val = None if probe.ticket.cancelled else probe.value
            probe.ticket.cancelled = True
            if not probe.flushed and self._pending:
                # the consumer outran the batch window: flush what
                # accumulated so the rest still has a chance to land
                flush, self._pending = self._pending, []
        if flush:
            self._flush(flush)
        with self._slock:
            stats = self.engine.stats
            if val is None:
                stats.stat_probe_fallbacks += 1
            else:
                stats.stat_probe_hits += 1
        return val

    # ------------------------------------------------------------------
    # invalidation
    # ------------------------------------------------------------------

    def on_op(self, kind: str, paths) -> None:
        """Admission hook.  Structural subtree ops cancel everything
        underneath; an exact-path admission either consumes the probe's
        exemption (its own op arriving) or cancels it."""
        if kind in _TREE_KINDS:
            with self._lock:
                for p in [p for p in self._entries
                          if any(is_under(p, q) for q in paths)]:
                    self._entries.pop(p).ticket.cancelled = True
            return
        with self._lock:
            for q in paths:
                probe = self._entries.get(q)
                if probe is None or probe.exempt_used:
                    # post-exemption admissions are FIFO-ordered after
                    # the consumer's execution: harmless
                    continue
                if kind == probe.exempt_kind:
                    probe.exempt_used = True
                else:
                    self._entries.pop(q).ticket.cancelled = True

    def invalidate(self, path: str) -> None:
        with self._lock:
            probe = self._entries.pop(path, None)
            if probe is not None:
                probe.ticket.cancelled = True

    def clear(self) -> None:
        """Probes are transaction-scoped ('did the path exist before
        this region touched it') — commit and rollback both retire
        every outstanding entry."""
        with self._lock:
            for probe in self._entries.values():
                probe.ticket.cancelled = True
            self._entries.clear()
            self._pending = []


__all__ = ["INVALIDATING_KINDS", "ReadAheadManager", "ReadPolicy",
           "StatVecBatcher"]
