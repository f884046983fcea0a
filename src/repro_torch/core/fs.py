"""CannyFS — the POSIX-ish user API over the eager engine.

This is the in-process equivalent of the paper's FUSE mount: a task loops
over `mkdir/open/write/close/...` calls exactly as it would against a kernel
filesystem, and each call is either eagerly ACKed (background execution,
per-path ordering, deferred errors) or executed synchronously, per the
EagerFlags.
"""
from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Iterable, Optional

from .backend import StorageBackend, StatResult, norm_path, parent_of
from .durability import SpillManager, _replay_kw
from .engine import EagerIOEngine
from .errors import ErrorLedger, ShortWriteError
from .flags import EagerFlags
from .fusion import FusionPolicy, MetaPayload, WritePayload
from .namespace import OverlayPolicy
from .prefetch import PrefetchPolicy
from .readahead import ReadPolicy


class CannyFile:
    """Streaming file handle.

    Writes are queued eagerly with a running offset; the buffer is handed to
    the worker without copying (the user-space analogue of the paper's
    splice-based zero-copy path — we transfer ownership of the `bytes`
    object instead of kernel pipe pages).
    """

    def __init__(self, fs: "CannyFS", path: str, mode: str):
        if mode not in ("wb", "rb", "ab"):
            raise ValueError(f"mode {mode!r} not supported")
        self.fs = fs
        self.path = norm_path(path)
        self.mode = mode
        self._offset = 0
        self._closed = False
        if mode == "wb":
            fs.create(self.path)
        elif mode == "ab":
            st = fs.stat(self.path)
            self._offset = st.size if st.exists else 0
            if not st.exists:
                fs.create(self.path)

    # -- write side --
    def write(self, data: bytes) -> int:
        if self.mode == "rb":
            raise IOError("file opened read-only")
        if self._closed:
            raise ValueError("I/O on closed file")
        data = bytes(data)  # freeze caller's view; engine takes ownership
        off = self._offset
        self._offset += len(data)
        self.fs._write_at(self.path, off, data)
        return len(data)

    # -- read side --
    def read(self, size: int = -1) -> bytes:
        if self.mode != "rb":
            raise IOError("file opened write-only")
        out = self.fs.pread(self.path, self._offset, size)
        self._offset += len(out)
        return out

    def seek(self, offset: int) -> None:
        self._offset = int(offset)

    def tell(self) -> int:
        return self._offset

    def flush(self) -> None:
        self.fs.flush(self.path)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self.mode in ("wb", "ab"):
            self.fs._on_close_write(self.path)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class CannyFS:
    """The mount object.  One per 'job'; all methods are thread-safe."""

    def __init__(self, backend: StorageBackend, *,
                 flags: EagerFlags | None = None,
                 max_inflight: int = 300,
                 workers: int = 32,
                 executor: str = "pool",
                 abort_on_error: bool = False,
                 echo_errors: bool = True,
                 fusion: FusionPolicy | bool | None = None,
                 overlay: OverlayPolicy | bool | None = None,
                 prefetch: PrefetchPolicy | bool | None = None,
                 readahead: ReadPolicy | bool | None = None,
                 work_stealing: bool = True,
                 clock=None):
        self.flags = flags or EagerFlags()
        self.engine = EagerIOEngine(
            backend, flags=self.flags, max_inflight=max_inflight,
            workers=workers, executor=executor, abort_on_error=abort_on_error,
            ledger=ErrorLedger(echo=echo_errors), fusion=fusion,
            overlay=overlay, prefetch=prefetch, readahead=readahead,
            work_stealing=work_stealing, clock=clock)
        self.backend = backend
        self._txn_lock = threading.Lock()
        self._txn = None  # active Transaction (set by Transaction.__enter__)
        self._detached = threading.local()  # per-thread txn opt-out

    # ------------------------------------------------------------------
    # plumbing
    # ------------------------------------------------------------------

    _REGION_UNSET = object()

    # tenancy hooks (PR 10): the base mount is the untenanted whole-
    # namespace view, so these default to no-op / engine-global.  The
    # ``Tenant`` handle (core/tenancy.py) shares this engine but overrides
    # the hooks, and every public op below inherits prefix confinement,
    # quota admission, per-tenant spill/poison/retry bookkeeping and
    # prefix-scoped cache clears without further changes here.
    _tenant_state = None  # scheduler-side _TenantState; Tenant sets it

    def tenant(self, name: str, root_prefix: str | None = None,
               weight: float = 1.0, quota=None) -> "CannyFS":
        """Open a tenant handle on this mount's engine: a ``CannyFS``-
        shaped view confined to ``root_prefix`` (default: ``name``) with
        its own failure domain (ledger tag, poison flag, rollback and
        spill scope), a DWRR dispatch weight, and an optional
        ``TenantQuota`` byte/inode budget."""
        from .tenancy import Tenant
        return Tenant(self, name,
                      root_prefix if root_prefix is not None else name,
                      weight=weight, quota=quota)

    def _spill(self):
        """The spill journal this view records to — the tenant's own for
        Tenant handles (never the shared engine journal), else the
        engine's."""
        return self.engine._spill_for(self._tenant_state)

    def _check_paths(self, kind: str, paths) -> None:
        """Namespace confinement hook: Tenant raises PermissionError for
        paths outside its root prefix.  No-op on the base mount."""

    def _quota_admit(self, kind: str, paths, cache_kw=None) -> None:
        """Quota admission hook, charged synchronously at ACK time (the
        caller sees EDQUOT/ENOSPC, not a deferred ledger entry).  Charges
        are high-water per path, so the fused-write fast path and the
        engine submit path may both call this for one op without double
        counting.  No-op on the base mount."""

    def _note_fused(self) -> None:
        """A write/meta op of this view was absorbed by the coalescer."""
        ts = self._tenant_state
        if ts is not None:
            ts.stats.fused += 1

    def _note_retry(self) -> None:
        """run_transaction retry bookkeeping — engine-global counter plus
        the submitting tenant's own, so one tenant's transient-error storm
        is visible (and billable) per tenant."""
        self.engine.stats.retries += 1
        ts = self._tenant_state
        if ts is not None:
            ts.stats.retries += 1

    def _note_rollback(self, n_leftovers: int) -> None:
        self.engine.stats.rollbacks += 1
        self.engine.stats.rollback_leftovers += n_leftovers
        ts = self._tenant_state
        if ts is not None:
            ts.stats.rollbacks += 1

    def _backoff_salt(self) -> str:
        """Extra salt for run_transaction's deterministic backoff RNG:
        the tenant name, so per-tenant retry schedules are independent
        streams (one tenant's attempt count never perturbs a
        neighbour's jitter)."""
        return ""

    def _reset_poison(self) -> None:
        """Scope-aware poison clear: the whole engine for the base mount,
        only this tenant's flag for a Tenant handle."""
        self.engine.reset_poison(self._tenant_state)

    def _clear_window_caches(self, *, rollback: bool) -> None:
        """Drop the optimization-window caches at a commit/rollback
        boundary.  The base mount owns the whole namespace and clears
        wholesale (matching pre-tenancy behaviour exactly); a Tenant
        clears the overlay only under its own prefix so a neighbour's
        open window survives the boundary."""
        eng = self.engine
        ov = eng.overlay
        if ov is not None:
            ov.clear()
        if rollback and eng.readahead is not None:
            eng.readahead.clear()
        sb = eng.stat_batcher
        if sb is not None:
            sb.clear()

    def _submit(self, kind: str, paths: tuple[str, ...], fn, *,
                cache_kw: dict | None = None, region=_REGION_UNSET,
                payload=None):
        paths_n = tuple(norm_path(p) for p in paths)
        self._check_paths(kind, paths_n)
        self._quota_admit(kind, paths_n, cache_kw)
        sp = self._spill()
        if sp is not None:
            # real mutations poison the spill image for their paths (no
            # later elision may trust run-1 state there) and force-settle
            # any diverted stream they touch, keeping FIFO order intact
            sp.note_paths(self, kind, paths_n)
        eager = self.flags.is_eager(kind)
        # tag the op with the active transaction so its deferred error is
        # attributed (and later scope-cleared) exactly, even when another
        # region opens before this one's rollback runs.  Journaling ops
        # pass the txn they captured so tag and journal can never diverge.
        if region is CannyFS._REGION_UNSET:
            region = self._active_txn()
        return self.engine.submit(kind, paths, fn, eager=eager,
                                  cache_kw=cache_kw, region=region,
                                  payload=payload, tenant=self._tenant_state)

    def _active_txn(self):
        """The transaction to journal into, captured at submission time.
        _active flips on only once __enter__ completes — work racing the
        open is pre-region and must not be journaled (a rollback would
        otherwise delete it)."""
        if getattr(self._detached, "on", False):
            return None
        txn = self._txn
        return txn if (txn is not None and txn._active) else None

    @contextmanager
    def detached(self):
        """Run the enclosed I/O outside any active transaction on this
        thread: nothing is journaled and deferred errors stay untagged.
        For subsystems with their own commit protocol (the checkpoint
        manager) whose files must not be rolled back — or whose failures
        blamed on — a user transaction that happens to be open."""
        prev = getattr(self._detached, "on", False)
        self._detached.on = True
        try:
            yield self
        finally:
            self._detached.on = prev

    def _submit_journaled(self, kind: str, paths: tuple[str, ...], call,
                          journal, *, cache_kw: dict | None = None):
        """Delegate, then journal into the region on *success*, from the
        executing worker: a failed (or pre-existing-target) op created
        nothing, so rollback must not remove it.  The txn is captured at
        submission — keeping the ledger region tag and the journal in
        lockstep — and rollback's drain guarantees every journal write
        lands before the journal is read."""
        txn = self._active_txn()

        def fn():
            out = call()
            if txn is not None:
                journal(txn)
            return out

        return self._submit(kind, paths, fn, cache_kw=cache_kw, region=txn)

    # ------------------------------------------------------------------
    # namespace ops
    # ------------------------------------------------------------------

    def mkdir(self, path: str) -> None:
        b, p, txn = self.backend, norm_path(path), self._active_txn()
        sp = self._spill()
        if sp is not None and sp.elide_mkdir(p):
            # provably durable from the interrupted run: refresh the
            # claims (journal membership was seeded at attach) and skip
            # the backend roundtrip
            self._elide_replay("mkdir", (p,), {})
            return

        def fn():
            try:
                b.mkdir(p)
            except FileExistsError:
                if sp is None or not sp.session_tolerant(p):
                    # not a path the spill image vouches for: a fresh run
                    # would surface this EEXIST too — don't mask it
                    raise
                # idempotent re-execution: the interrupted run's mkdir on
                # a vouched path landed but was not provably durable (its
                # record missed the last cut).  The dir exists with
                # unknown contents — keep the membership delta, drop
                # completeness.  NOT journaled: there is no proof the dir
                # was absent before the window (it may pre-date the job),
                # and a pre-existing — possibly empty, hence rmdir-able —
                # directory must never enter rollback scope; if run 1 did
                # create it, the journal seeded at attach already covers
                # it.
                ov2 = self.engine.overlay
                if ov2 is not None:
                    ov2.demote(p)
                return
            # the dir provably came into existence fresh and empty just
            # now: the overlay's provisional admit-time claim is promoted
            # to backend-proven (journal + promote on *success* only — a
            # failed mkdir created nothing and is invalidated instead)
            ov = self.engine.overlay
            if ov is not None:
                ov.promote(p)
            if txn is not None:
                txn._record_create(p, True)

        self._submit("mkdir", (p,), fn, cache_kw={}, region=txn)

    def makedirs(self, path: str, exist_ok: bool = True) -> None:
        parts = norm_path(path).split("/")
        cur = ""
        txn = self._active_txn()
        # vectored parent probe: in sync-mkdir mode every uncached
        # component below pays one backend stat roundtrip (the
        # ``self.exists`` check) — warm the stat cache with ONE
        # ``stat_vec`` over the whole chain instead, so a deep
        # manifest-driven extract probes each parent chain in a single
        # roundtrip.  Advisory: a failed batch falls back per-component.
        if not self.flags.mkdir and self.engine.readahead is not None:
            cache = self.engine.stat_cache
            probe, anc = [], ""
            for part in parts:
                anc = f"{anc}/{part}" if anc else part
                if cache.get(anc) is None:
                    probe.append(anc)
            if len(probe) > 1:
                b = self.backend

                def pfn(probe=tuple(probe)):
                    try:
                        res = b.stat_vec(list(probe))
                    except OSError:
                        return None
                    for q in probe:
                        st = res.get(q)
                        if st is not None and cache.get(q) is None:
                            cache.put(q, st)
                    return None

                self.engine.submit("stat", tuple(probe), pfn, eager=False,
                                   tenant=self._tenant_state)
        for part in parts:
            cur = f"{cur}/{part}" if cur else part
            st = self.engine.stat_cache.get(cur)
            if st is not None and st.exists:
                continue
            if not self.flags.mkdir and self.exists(cur):
                continue
            b, p = self.backend, cur

            def fn(p=p, txn=txn):
                ov = self.engine.overlay
                try:
                    b.mkdir(p)
                except FileExistsError:
                    # the dir pre-existed: the overlay's admit-time claim
                    # of a fresh (complete, empty) directory is wrong —
                    # demote its completeness; the membership deltas
                    # recorded so far remain valid
                    if ov is not None:
                        ov.demote(p)
                    if not exist_ok:
                        raise
                else:  # journal only dirs this region actually created
                    if ov is not None:
                        ov.promote(p)
                    if txn is not None:
                        txn._record_create(p, True)
            self._submit("mkdir", (p,), fn, cache_kw={}, region=txn)

    def rmdir(self, path: str) -> None:
        p, txn = norm_path(path), self._active_txn()
        sp = self._spill()
        if sp is not None and sp.elide_rmdir(p):
            self._elide_replay("rmdir", (p,), {})
            return
        # cross-path bulk-remove peephole: when the overlay proves this
        # directory's subtree is fully known and ends empty after the
        # pending removals, those unlinks/rmdirs are elided and ONE
        # vectored remove_tree backend call covers the whole prefix.
        # Collapses roll up through the rmtree recursion: leaf dirs fuse
        # first, parents then absorb their children's fused removals.
        if self.flags.is_eager("rmdir") and self.flags.is_eager("remove_tree"):
            prep = self.engine.prepare_rmtree(p, region=txn)
            if prep is not None:
                eng = self.engine
                self._submit("remove_tree", (p, *prep.covered),
                             lambda: eng.run_bulk_remove(prep), cache_kw={},
                             region=txn, payload=prep)
                return
        b = self.backend
        tolerant = sp is not None and sp.removal_tolerant(p)

        def fn():
            try:
                b.rmdir(p)
            except FileNotFoundError:
                # the interrupted run's removal was in flight at the kill:
                # the directory may already be durably gone
                if not tolerant:
                    raise

        self._submit("rmdir", (p,), fn, cache_kw={}, region=txn)

    def create(self, path: str) -> None:
        b, p, txn = self.backend, norm_path(path), self._active_txn()
        sp = self._spill()
        if sp is not None and sp.divert_create(p):
            # the interrupted run durably created (and wrote) this file:
            # buffer the re-run's stream instead of re-submitting; close
            # verifies the content against the recorded segment checksums
            # and either elides the whole stream or falls back to a real
            # rewrite (SpillManager.finalize)
            self.engine.stat_cache.on_op("create", (p,))
            ov = self.engine.overlay
            if ov is not None:
                ov.on_op("create", (p,))
            return
        # the journaling existence probe below batches: enqueued before
        # this op's own admission (which consumes the probe's exemption),
        # it fuses with neighbouring probes into ONE speculative stat_vec
        sb = self.engine.stat_batcher
        if txn is not None and sb is not None:
            sb.enqueue(p, "create")

        def fn():
            # create succeeds on an existing file (O_TRUNC) — journal only
            # true creations, or rollback would unlink a pre-transaction
            # file outright.  (Truncated content is not restored: the
            # journal records namespace, not data.)  The extra stat is paid
            # only inside transactions, by the background worker — or not
            # at all when the batched probe landed.
            if txn is not None:
                hit = sb.lookup(p) if sb is not None else None
                existed = hit.exists if hit is not None else b.stat(p).exists
                if sp is not None:
                    # spill the probe result BEFORE the backend call: if a
                    # kill leaves this op uncertain, repair may journal
                    # the landed file only on this surviving absence proof
                    sp.record_preexist(p, existed)
            else:
                existed = False
            b.create(p)
            if txn is not None and not existed:
                txn._record_create(p, False)

        self._submit("create", (p,), fn, cache_kw={}, region=txn)

    def unlink(self, path: str) -> None:
        b, p, txn = self.backend, norm_path(path), self._active_txn()
        sp = self._spill()
        if sp is not None and sp.elide_unlink(p):
            self._elide_replay("unlink", (p,), {})
            return
        # optimizer: a pending create/write chain on this path is invisible
        # at every observation point once the path is unlinked in the same
        # window — elide it.  The unlink must then tolerate absence: the op
        # that would have created the file (create, or an implicit-create
        # write) no longer executes — or the interrupted run's removal was
        # in flight at the kill, so the file may already be gone.
        tolerant = ((self.flags.is_eager("unlink")
                     and self.engine.prepare_unlink(p, region=txn))
                    or (sp is not None and sp.removal_tolerant(p)))

        def fn():
            try:
                b.unlink(p)
            except FileNotFoundError:
                if not tolerant:
                    raise

        self._submit("unlink", (p,), fn, cache_kw={}, region=txn)

    def rename(self, src: str, dst: str) -> None:
        b = self.backend
        s, d = norm_path(src), norm_path(dst)
        # optimizer rule 5 (cost-gated): on media where rename is a
        # server-side copy+delete, a source whose whole backend lifetime
        # is still pending (create+write+metadata, nothing executed) is
        # rebuilt at the destination instead — the copy+delete round-trips
        # never happen.  The capture is all-or-nothing; on any ineligible
        # op the plain backend rename below runs untouched.
        if (s != d and self.flags.is_eager("rename")
                and self.flags.is_eager("create")
                and self.flags.is_eager("write")
                and self.flags.is_eager("unlink")
                and self.engine.rename_retarget_wanted()):
            txn = self._active_txn()
            chain = self.engine.prepare_rename_retarget(s, region=txn)
            if chain is not None:
                self._replay_retargeted(chain, s, d, txn)
                return
        self._submit_journaled("rename", (s, d), lambda: b.rename(s, d),
                               lambda t: t._record_rename(s, d),
                               cache_kw={})

    def _replay_retargeted(self, chain, s: str, d: str, txn) -> None:
        """Re-drive a captured source chain at the destination through the
        public ops (oldest-first: the create lands before its writes), so
        journaling, stat-cache/overlay bookkeeping and destination-side
        fusion all happen exactly as if the caller had built the file at
        the destination in the first place.  The elided source ops never
        journalled (their fns never ran), so nothing double-records."""
        b = self.backend
        for op in chain:
            pl = op.payload
            if op.kind == "create":
                self.create(d)
            elif op.kind == "write":
                for off, data in pl.segments():
                    self._write_at(d, off, data)
            elif op.kind == "chmod":
                self.chmod(d, *pl.args)
            elif op.kind == "utimens":
                self.utimens(d, *pl.args)
            elif op.kind == "truncate":
                self.truncate(d, *pl.args)
        # the source still disappears: a pre-existing file at the source
        # (the elided create would have O_TRUNCed it) must go, and the
        # overlay/stat-cache must see the path removed.  Submitted
        # directly — NOT via self.unlink, whose elision pass would find
        # the already-captured chain gone and leave the op intolerant,
        # pushing a spurious ENOENT into the ledger when the source was
        # never materialized.

        def fn():
            try:
                b.unlink(s)
            except FileNotFoundError:
                pass

        self._submit("unlink", (s,), fn, cache_kw={}, region=txn)

    def symlink(self, target: str, path: str) -> None:
        b, p = self.backend, norm_path(path)
        self._submit_journaled("symlink", (p,), lambda: b.symlink(target, p),
                               lambda t: t._record_create(p, False),
                               cache_kw={})

    def link(self, src: str, dst: str) -> None:
        b = self.backend
        s, d = norm_path(src), norm_path(dst)
        self._submit_journaled("link", (s, d), lambda: b.link(s, d),
                               lambda t: t._record_create(d, False),
                               cache_kw={})

    def readlink(self, path: str) -> str:
        b = self.backend
        p = norm_path(path)
        self._check_paths("readlink", (p,))
        return self.engine.submit("readlink", (p,),
                                  lambda: b.readlink(p), eager=False,
                                  tenant=self._tenant_state)

    # ------------------------------------------------------------------
    # data ops
    # ------------------------------------------------------------------

    def _write_at(self, path: str, offset: int, data: bytes) -> None:
        b, p, txn = self.backend, norm_path(path), self._active_txn()
        cache_kw = {"offset": offset, "nbytes": len(data)}
        # confinement + quota run BEFORE the fusion attempt: a denied path
        # must never be absorbed into a neighbour's pending vector, and a
        # fused write still consumes budget (the high-water charge is
        # idempotent with _submit's)
        self._check_paths("write", (p,))
        self._quota_admit("write", (p,), cache_kw)
        sp = self._spill()
        if sp is not None and sp.divert_write(p, offset, data):
            # resumed diverted stream: buffered for close-time verification
            self.engine.stat_cache.on_op("write", (p,), **cache_kw)
            ov = self.engine.overlay
            if ov is not None:
                ov.on_op("write", (p,), **cache_kw)
            return
        # feed the coalescer: if the path's pending tip is an unclaimed,
        # unsealed write in the same region, this write is absorbed into
        # its vector and ACKed without a new engine op
        if self.flags.is_eager("write") and self.engine.try_fuse_write(
                p, offset, data, region=txn, cache_kw=cache_kw):
            self._note_fused()
            return
        payload = WritePayload(offset, data)
        # batch the journaling probe (same conditions fn re-checks at
        # execution — they cannot flip in between, because enqueue
        # requires a quiescent path and later same-path admissions are
        # FIFO-ordered after this op)
        sb = self.engine.stat_batcher
        if (sb is not None and txn is not None and not txn._has_created(p)
                and not txn._is_preexisting(p)):
            sb.enqueue(p, "write")

        def fn():
            # write_vec creates a missing file implicitly; if its create op
            # faulted earlier, the file would otherwise be an unjournaled
            # orphan that rollback cannot remove.  The existence probe is
            # skipped on the hot paths (path already journaled, or already
            # proven to pre-exist — streamed appends pay one probe total).
            probe = (txn is not None and not txn._has_created(p)
                     and not txn._is_preexisting(p))
            if probe:
                hit = sb.lookup(p) if sb is not None else None
                existed = hit.exists if hit is not None else b.stat(p).exists
                if sp is not None:
                    # spilled pre-backend-call: repair's only licence to
                    # journal this path if the op lands without a record
                    sp.record_preexist(p, existed)
            else:
                existed = True
            expected = payload.nbytes   # frozen once the op is claimed
            out = b.write_vec(p, payload.segments())
            if probe:
                if existed:
                    txn._mark_preexisting(p)
                else:
                    txn._record_create(p, False)
            if out < expected:
                # torn op: journal ran first so rollback removes the torn
                # file; EIO-class error makes run_transaction resubmit
                raise ShortWriteError(p, expected, out)
            return out

        self._submit("write", (p,), fn, cache_kw=cache_kw, region=txn,
                     payload=payload)

    def write_file(self, path: str, data: bytes) -> None:
        """create + write + close — the common whole-file put."""
        with self.open(path, "wb") as f:
            f.write(data)

    def pread(self, path: str, offset: int, size: int) -> bytes:
        """Data reads are never eager (paper §2) — but with the read-ahead
        layer on, a *sequential* reader's bytes are usually already here:
        the first sync read registers a ticketed page buffer and pipelines
        speculative ``read_vec`` windows ahead of the consumer, so later
        preads are served without a backend roundtrip.  A page hit is
        byte-identical to the sync path (pages register only on quiescent
        paths and die on any racing admitted mutation); any miss falls
        through to the sync read below and re-feeds the observer."""
        b = self.backend
        p = norm_path(path)
        self._check_paths("read", (p,))
        ra = self.engine.readahead
        if ra is not None and size >= 0:
            out = ra.read(p, offset, size)
            if out is not None:
                return out
        out = self.engine.submit("read", (p,),
                                 lambda: b.read_at(p, offset, size),
                                 eager=False, tenant=self._tenant_state)
        if ra is not None:
            ra.observe_sync(p, offset, len(out), size)
        return out

    def read_file(self, path: str) -> bytes:
        return self.pread(path, 0, -1)

    def open(self, path: str, mode: str = "rb") -> CannyFile:
        return CannyFile(self, path, mode)

    def _submit_foldable(self, kind: str, path: str, args: tuple, apply_fn,
                         cache_kw: dict | None) -> None:
        """Submit a last-wins metadata op (chmod/utimens/truncate) through
        the optimizer: an adjacent pending same-kind op absorbs the new
        arguments instead of a second backend roundtrip."""
        p, txn = norm_path(path), self._active_txn()
        sp = self._spill()
        if sp is not None and sp.elide_meta(kind, p, args):
            # last-wins metadata durably applied with identical arguments
            # by the interrupted run: skip the roundtrip
            self._elide_replay(kind, (p,), cache_kw or {})
            return
        if self.flags.is_eager(kind) and self.engine.try_fuse_meta(
                kind, p, args, region=txn, cache_kw=cache_kw):
            self._note_fused()
            return
        payload = MetaPayload(args)
        self._submit(kind, (p,), lambda: apply_fn(p, *payload.args),
                     cache_kw=cache_kw, region=txn, payload=payload)

    def truncate(self, path: str, size: int) -> None:
        self._submit_foldable("truncate", path, (size,),
                              self.backend.truncate, {"size": size})

    def fallocate(self, path: str, size: int) -> None:
        b = self.backend
        self._submit("fallocate", (path,), lambda: b.fallocate(path, size),
                     cache_kw={"size": size})

    def flush(self, path: str) -> None:
        sp = self._spill()
        if sp is not None:
            sp.finalize(self, norm_path(path))
        if self.flags.flush:
            return  # eager flush == no-op ACK; data ordering is per-path
        self.engine.barrier(path, tenant=self._tenant_state)

    def fsync(self, path: str) -> None:
        b = self.backend
        self._submit("fsync", (path,), lambda: b.fsync(path))

    def _on_close_write(self, path: str) -> None:
        """close() of a written file: with eager flush this is an immediate
        ACK; otherwise it is a barrier (NFS close-to-open consistency —
         'the closing of files a barrier', paper §5).  A resumed diverted
        stream settles here: the buffered content is verified against the
        recorded durable checksums and elided, or rewritten for real."""
        sp = self._spill()
        if sp is not None:
            sp.finalize(self, norm_path(path))
        if not self.flags.flush:
            self.engine.barrier(path, tenant=self._tenant_state)

    # ------------------------------------------------------------------
    # metadata ops
    # ------------------------------------------------------------------

    def chmod(self, path: str, mode: int) -> None:
        self._submit_foldable("chmod", path, (mode,),
                              self.backend.chmod, {"mode": mode})

    def chown(self, path: str, uid: int, gid: int) -> None:
        b = self.backend
        self._submit("chown", (path,), lambda: b.chown(path, uid, gid))

    def utimens(self, path: str, atime: float, mtime: float) -> None:
        self._submit_foldable("utimens", path, (atime, mtime),
                              self.backend.utimens, None)

    def setxattr(self, path: str, key: str, value: bytes) -> None:
        b = self.backend
        self._submit("setxattr", (path,), lambda: b.setxattr(path, key, value))

    def removexattr(self, path: str, key: str) -> None:
        b = self.backend
        self._submit("removexattr", (path,),
                     lambda: b.removexattr(path, key))

    def stat(self, path: str) -> StatResult:
        """Stat is an *overlay read*: answered from the write-through
        cache (positive and negative hits) or from the overlay's proven
        membership (a complete parent that does not list the name) without
        sealing anything; only a miss takes the sync, sealing path."""
        path = norm_path(path)
        self._check_paths("stat", (path,))
        ov = self.engine.overlay
        mock = ov.policy.mock_stat if ov is not None else self.flags.mock_stat
        negative = (ov.policy.negative_stat if ov is not None
                    else self.flags.negative_stat_cache)
        if mock:
            hit = self.engine.stat_cache.get(path)
            if hit is not None and (hit.exists or negative):
                self.engine.stats.mocked_stats += 1
                return hit
            if hit is None and negative and ov is not None \
                    and ov.lookup(path) is False:
                self.engine.stats.mocked_stats += 1
                return StatResult(False, mocked=True)
        b = self.backend
        cache = self.engine.stat_cache

        def fn():
            hit = cache.get(path)
            if hit is not None:
                return hit
            st = b.stat(path)
            cache.put(path, st)
            return st

        return self.engine.submit("stat", (path,), fn, eager=False,
                                  tenant=self._tenant_state)

    def exists(self, path: str) -> bool:
        return self.stat(path).exists

    def _overlay_readdir_hit(self, ov, path: str) -> list[str] | None:
        """One overlay readdir attempt with its hit accounting, or None
        on a miss (shared by the fast path and the post-latch re-try)."""
        names = ov.readdir(path)
        if names is None:
            return None
        stats = self.engine.stats
        stats.overlay_readdirs += 1
        if self.engine._sched.has_pending_under(path):
            stats.overlay_seals_avoided += 1
        if (self.engine.prefetcher is not None
                and ov.was_speculative(path)):
            stats.prefetch_hits += 1
        return names

    def readdir(self, path: str) -> list[str]:
        """Readdir consults the namespace overlay first: when the
        directory's membership is fully determined by the transaction's
        own writes (created in-window) or a cached backend listing, the
        answer comes from pending state and the chains beneath stay
        rewritable (no seal, no backend roundtrip).  A miss with a
        speculative batch already in flight for the path latches onto
        that batch (``MetadataPrefetcher.wait_for`` — one shared
        roundtrip, demand-promoting a frontier-queued path) and re-tries
        the overlay; only then does it execute ONE vectored
        ``readdir_plus`` call — names plus attributes, the NFS
        READDIRPLUS analogue — installing the listing into the overlay,
        warming the stat cache, seeding the prefetch frontier with the
        discovered subdirectories, and sealing as any sync op does."""
        path = norm_path(path)
        self._check_paths("readdir", (path,))
        ov = self.engine.overlay
        b = self.backend
        if ov is not None:
            if ov.policy.readdir_overlay:
                names = self._overlay_readdir_hit(ov, path)
                if names is not None:
                    return names
                # consumer latch: a speculative batch already carrying
                # this directory is in flight — wait for its install
                # instead of issuing a duplicate roundtrip, then re-try
                # the overlay (a cancelled/failed batch falls through to
                # the sync path exactly as before)
                pf = self.engine.prefetcher
                if pf is not None and pf.wait_for(path):
                    names = self._overlay_readdir_hit(ov, path)
                    if names is not None:
                        return names
            cache = self.engine.stat_cache
            warm = ov.policy.prefetch

            def fn():
                listing = b.readdir_plus(path)
                if warm:
                    for name, st in listing:
                        child = f"{path}/{name}" if path else name
                        if st is not None and cache.get(child) is None:
                            cache.put(child, st)
                            self.engine.stats.prefetched_stats += 1
                ov.install_listing(path, listing)
                # a cold miss is the prefetch pipeline's trigger: the
                # subdirectories this listing discovered are enqueued for
                # batched speculative fetching ahead of the consumer
                pf = self.engine.prefetcher
                if pf is not None:
                    pf.seed_children(path, listing)
                return [name for name, _ in listing]

            return self.engine.submit("readdir", (path,), fn, eager=False,
                                      tenant=self._tenant_state)
        # overlay disabled: the pre-overlay path — plain backend readdir
        # plus the legacy advisory per-entry prefetch stats
        names = self.engine.submit("readdir", (path,),
                                   lambda: b.readdir(path), eager=False,
                                   tenant=self._tenant_state)
        if self.flags.readdir_prefetch:
            cache = self.engine.stat_cache
            for name in names:
                child = f"{path}/{name}" if path else name
                if cache.get(child) is None:
                    def pf(child=child):
                        if cache.get(child) is None:
                            try:
                                cache.put(child, b.stat(child))
                            except OSError:
                                pass  # advisory warm-up only: a failure
                                # must not land in the ledger and condemn
                                # a transaction — consumers stat on demand
                    self.engine.submit("stat", (child,), pf, eager=True,
                                       tenant=self._tenant_state)
                    self.engine.stats.prefetched_stats += 1
        return names

    listdir = readdir

    # ------------------------------------------------------------------
    # composite workloads
    # ------------------------------------------------------------------

    def rmtree(self, path: str) -> None:
        """`rm -rf` — the paper's second benchmark, readdir-driven.

        With the namespace overlay this walk stays inside the unobserved
        window: readdirs of in-window (or once-listed) directories answer
        from pending state without sealing, per-entry stats hit the cache
        warmed by the listing, and each ``rmdir`` tries the bulk-remove
        peephole — collapsing the subtree's pending unlinks/rmdirs into
        one vectored ``remove_tree`` backend call that rolls up the
        recursion to a single fused removal of the whole tree.  With the
        overlay off (or on any miss) this degrades gracefully to the
        per-entry path: eager unlinks/rmdirs ordered by the engine's
        pending-children edges."""
        path = norm_path(path)
        sp = self._spill()
        if sp is not None and sp.elide_remove_root(path):
            # the interrupted run durably removed this whole subtree (and
            # nothing under it was re-created since): skip the recursion
            self._elide_replay("remove_tree", (path,), {})
            return
        for name in self.readdir(path):
            child = f"{path}/{name}" if path else name
            st = self.stat(child)
            if st.is_dir:
                self.rmtree(child)
            else:
                self.unlink(child)
        self.rmdir(path)

    def walk(self, path: str = ""):
        """Generator of (dir, subdirs, files) — `find`/`du`-style traversal.

        Overlay fast path: a directory whose membership *and* child kinds
        are fully determined by pending state or a cached listing yields
        without a single backend roundtrip or seal (counted in
        ``overlay_readdirs``); any other directory falls back to the
        readdir + per-entry stat walk for that directory only — each
        subdirectory re-tries the fast path."""
        path = norm_path(path)
        ov = self.engine.overlay
        if ov is not None and ov.policy.readdir_overlay:
            kinds = ov.listing_kinds(path)
            if kinds is not None:
                dirs, files = kinds
                stats = self.engine.stats
                stats.overlay_readdirs += 1
                if self.engine._sched.has_pending_under(path):
                    stats.overlay_seals_avoided += 1
                if (self.engine.prefetcher is not None
                        and ov.was_speculative(path)):
                    stats.prefetch_hits += 1
                yield path, dirs, files
                for d in dirs:
                    child = f"{path}/{d}" if path else d
                    yield from self.walk(child)
                return
        names = self.readdir(path)
        dirs, files = [], []
        for name in names:
            child = f"{path}/{name}" if path else name
            (dirs if self.stat(child).is_dir else files).append(name)
        yield path, dirs, files
        for d in dirs:
            child = f"{path}/{d}" if path else d
            yield from self.walk(child)

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    @property
    def ledger(self) -> ErrorLedger:
        return self.engine.ledger

    @property
    def stats(self):
        """Engine counters: per-op fault/trace counters (deferred_errors,
        injected_faults, rollbacks, retries) and the optimizer's fusion
        counters (fused_writes, folded_meta, elided_ops, bytes_elided)."""
        return self.engine.stats

    @property
    def poisoned(self) -> bool:
        """True once abort_on_error tripped; new submissions fail fast."""
        return self.engine.poisoned

    def _arm_spill(self, sp: SpillManager) -> None:
        """Install a prepared spill journal where ``_spill()`` finds it:
        engine-global here, the tenant's own slot for Tenant handles."""
        self.engine.spill = sp

    def _quota_release(self, paths) -> None:
        """Rollback removed these paths directly through the backend —
        give the tenant its budget back.  No-op on the base mount."""

    def _elide_replay(self, kind: str, paths: tuple, kw: dict) -> None:
        """Account one re-run op skipped as provably durable, refreshing
        the write-through claims it would have installed at admission."""
        self.engine.stat_cache.on_op(kind, paths, **kw)
        ov = self.engine.overlay
        if ov is not None:
            ov.on_op(kind, paths, **kw)
            if kind == "mkdir":
                ov.promote(paths[0])
        self.engine.stats.resume_elided_ops += 1

    def enable_spill(self, spill_dir: str, *,
                     flush_records: int = 64) -> SpillManager:
        """Arm the durability spill: from here on the active transaction's
        journal and every op outcome persist incrementally to
        ``spill_dir`` on this mount's own backend (see core/durability.py).
        Call before opening the transaction."""
        sp = SpillManager(self.engine, spill_dir,
                          flush_records=flush_records)
        sp.prepare()
        self._arm_spill(sp)
        return sp

    def resume(self, spill_dir: str, *, flush_records: int = 64) -> dict:
        """Re-prove an interrupted optimization window from the spill on a
        FRESH mount: parse the journal, repair the kill's in-flight
        ambiguity against the backend, replay the proven delta into the
        stat cache and namespace overlay (no tree re-walk), and arm the
        spill so the re-executed job body elides/diverts ops that are
        provably durable.  Returns a report dict (records parsed, repairs,
        ops replayed, ...)."""
        sp = SpillManager(self.engine, spill_dir,
                          flush_records=flush_records)
        sp.prepare()
        report = sp.load()
        report.update(sp.repair())
        cache, ov = self.engine.stat_cache, self.engine.overlay
        replayed = 0
        if sp.resuming:
            for kind, paths, rec in sp.image.events:
                kw = _replay_kw(kind, rec)
                cache.on_op(kind, paths, **kw)
                if ov is not None:
                    ov.on_op(kind, paths, **kw)
                    if kind == "mkdir":
                        ov.promote(paths[0])
                replayed += 1
            # failed ops recorded no durable effect — whatever claims the
            # replay stream installed for them must not stand
            for kind, paths in sp.image.fails:
                for p in paths:
                    cache.invalidate(p)
                    if ov is not None:
                        ov.invalidate(p)
            # repair-time removals (re-issued bulk deletes, probed-gone
            # paths) post-date the event stream: apply them last
            for root, gone in sp.removed_roots():
                cache.on_op("remove_tree", tuple(gone))
                if ov is not None:
                    ov.on_op("remove_tree", (root,))
        # preemption skipped the rollback that would have cleared the
        # poison gate; the re-proof IS the recovery — lift it (tenant-
        # scoped on a Tenant view, a no-op on a genuinely fresh mount)
        self._reset_poison()
        self._arm_spill(sp)
        self.engine.stats.resumes += 1
        self.engine.stats.resume_replayed_ops += replayed
        ts = self._tenant_state
        if ts is not None:
            ts.stats.resumes += 1
        report["replayed"] = replayed
        return report

    def drain(self) -> None:
        sp = self._spill()
        if sp is not None:
            sp.finalize_all(self)
        self.engine.drain()

    def close(self) -> None:
        """Unmount: drain all pending I/O and report deferred errors —
        the benchmarked 'fully killing the CannyFS process' step."""
        sp = self._spill()
        if sp is not None:
            sp.finalize_all(self)
        self.engine.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
