"""Job-as-transaction semantics (paper §1, §5).

A Transaction brackets a region of work against a CannyFS mount:

* every path *created* inside the region is journaled;
* ``commit()`` drains the engine and succeeds iff no deferred error was
  recorded during the region — the job's outputs are then durable;
* ``rollback()`` removes everything the region created (files first, then
  directories deepest-first), restoring the pre-transaction namespace;
* ``run_transaction`` is the paper's "roll back and resubmit" loop.

Transactions are also the *optimization-window* boundaries for the
engine's op-fusion pass: between observation points (reads, barriers and
this module's commit/rollback drains) the region's pending op stream may
be coalesced, folded or elided, because only commit-visible state is
promised.  The boundaries compose mechanically: the fusion pass only
rewrites ops in the *same* region (so a fused failure lands in exactly one
region's ledger scope and an elided create skips exactly that region's
journal), every sync op and barrier seals the ops it waits on, and
commit/rollback drain — after which nothing is pending to rewrite.  An op
elided inside a region therefore commits trivially (its effects were
proven invisible) and has nothing to roll back (it journaled nothing and
created nothing).

Torn ops ride the same loop: a fused write that lands short surfaces as a
deferred ``ShortWriteError`` (errno EIO, transient), the torn file *was*
journaled before the tear was detected, so rollback removes it and the
resubmission rewrites it whole.
"""
from __future__ import annotations

import errno as _errno
import random
import threading
import time
import zlib
from typing import Callable, TypeVar

from .backend import is_under
from .errors import (EnginePoisonedError, OpCancelledError, ProcessKilled,
                     RollbackLeakError, TransactionFailedError)
from .fs import CannyFS

T = TypeVar("T")

# OSError errnos worth resubmitting a job over (the paper's transient I/O
# failure classes).  ENOENT/EISDIR/EEXIST-style errors are deterministic
# body bugs: retrying them just replays the same failure.
TRANSIENT_ERRNOS = frozenset({
    _errno.EIO, _errno.ENOSPC, _errno.EDQUOT, _errno.EACCES, _errno.EPERM,
    _errno.ECONNRESET, _errno.ECONNABORTED, _errno.ECONNREFUSED,
    _errno.ETIMEDOUT, _errno.ESTALE, _errno.EAGAIN, _errno.EINTR,
    _errno.ENETDOWN, _errno.ENETUNREACH, _errno.EBUSY,
})


class Transaction:
    def __init__(self, fs: CannyFS, name: str = "txn"):
        self.fs = fs
        self.name = name
        self._lock = threading.Lock()
        self._created: dict[str, bool] = {}   # path -> is_dir
        self._preexisting: set[str] = set()   # probe memo (see _write_at)
        self._active = False
        self.committed = False
        self.rolled_back = False
        # paths rollback could not remove (verified against the backend)
        self.rollback_leftovers: list[str] = []
        # the region's deferred errors as they stood when rollback ran
        # (rollback clears them from the ledger; retry decisions need them)
        self.final_errors: list = []

    # -- journal hooks (called by CannyFS) --
    def _record_create(self, path: str, is_dir: bool) -> None:
        with self._lock:
            known = self._created.get(path)
            self._created[path] = is_dir
        if known is None or known != is_dir:
            # new (or re-kinded) journal entry: persist it so a resumed
            # attempt's rollback scope covers this path too.  Seeded
            # entries (attach_txn) re-record nothing.
            sp = self.fs._spill()
            if sp is not None:
                sp.record_journal(path, is_dir)

    def _has_created(self, path: str) -> bool:
        with self._lock:
            return path in self._created

    # existence-probe memo for _write_at's orphan check: paths proven to
    # pre-exist are never probed again (streamed appends stay one op/chunk)
    def _is_preexisting(self, path: str) -> bool:
        with self._lock:
            return path in self._preexisting

    def _mark_preexisting(self, path: str) -> None:
        with self._lock:
            self._preexisting.add(path)

    def _record_rename(self, src: str, dst: str) -> None:
        with self._lock:
            for p in [p for p in self._created if is_under(p, src)]:
                self._created[dst + p[len(src):]] = self._created.pop(p)
        sp = self.fs._spill()
        if sp is not None:
            sp.record_journal_rename(src, dst)

    # -- lifecycle --
    def __enter__(self) -> "Transaction":
        # no drain barrier here: region tags and the journal both capture
        # the active txn at submission time, so in-flight pre-region ops
        # stay untagged/unjournaled no matter when they finish — and a
        # transaction open must not stall on unrelated background I/O
        with self.fs._txn_lock:
            if self.fs._txn is not None:
                raise RuntimeError("nested transactions are not supported")
            self.fs._txn = self
        self._active = True
        sp = self.fs._spill()
        if sp is not None:
            # open the spill epoch (or, on a resumed mount, seed this
            # region's journal with the interrupted attempt's proven one)
            sp.attach_txn(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.fs._txn = None
        self._active = False
        if exc_type is not None:
            # caller failed mid-transaction → roll back, re-raise.
            # Exception: a ProcessKilled (raised directly, or at the root
            # of this region's deferred errors) means the process is
            # 'gone' — neither roll back nor retry in-process; recovery
            # is a fresh mount's CannyFS.resume() against the spill.
            killed = issubclass(exc_type, ProcessKilled) or any(
                isinstance(en.error, ProcessKilled) for en in self.errors())
            if not killed:
                self.rollback()
            return False
        if not self.committed and not self.rolled_back:
            self.commit()
        return False

    def errors(self):
        return self.fs.ledger.entries_for(self)

    def commit(self) -> None:
        """Drain all deferred I/O; surface any failure as a single
        transaction-level error (this is where the 'canny assumption' is
        finally checked)."""
        self.fs.drain()
        errs = self.errors()
        if errs:
            raise TransactionFailedError(errs)
        sp = self.fs._spill()
        if sp is not None:
            # committed marker + final cut, then the spill log is retired
            sp.on_commit()
        # the optimization window is closed: drop the namespace overlay's
        # delta (its claims are now plain backend truth; the next window
        # rebuilds its own) and retire the window-scoped existence probes.
        # The read-ahead pages stay: commit mutated nothing behind the
        # engine.  Scope-aware: a Tenant clears only under its prefix.
        self.fs._clear_window_caches(rollback=False)
        self.committed = True

    def rollback(self) -> None:
        """Remove every output of the transaction.  Runs synchronously and
        directly against the backend — rollback must not itself be canny.

        Removal is verified against the backend (one retry pass for
        stragglers — e.g. a transient injected fault on the unlink itself);
        anything still present afterwards is reported in
        ``rollback_leftovers`` rather than silently leaked."""
        self.fs.drain()
        self.final_errors = self.errors()
        sp = self.fs._spill()
        if sp is not None:
            # tombstone the epoch BEFORE removing anything: a kill mid-
            # rollback must leave a log that proves "this window is dead",
            # never one whose durable claims point at half-deleted files
            sp.on_rollback()
        with self._lock:
            created = dict(self._created)
            self._created.clear()
        files = sorted((p for p, d in created.items() if not d),
                       key=lambda p: -p.count("/"))
        dirs = sorted((p for p, d in created.items() if d),
                      key=lambda p: -p.count("/"))
        backend = self.fs.backend

        failed: list[str] = []

        def sweep(paths: list[str], remove) -> None:
            for p in paths:
                try:
                    remove(p)
                except OSError:
                    failed.append(p)  # a non-raising remove needs no verify
                self.fs.engine.stat_cache.invalidate(p)

        sweep(files, backend.unlink)
        sweep(dirs, backend.rmdir)
        # verification pass over the failures only: ask the backend what
        # actually survived, retry once, record the rest.  A path that
        # cannot even be stat'ed is *reported*, not assumed gone.
        leftovers: list[str] = []
        for p in sorted(failed, key=lambda q: -q.count("/")):
            try:
                st = backend.stat(p)
            except OSError:
                leftovers.append(p)
                continue
            if not st.exists:
                continue
            try:
                (backend.rmdir if created[p] else backend.unlink)(p)
            except OSError:
                pass
            self.fs.engine.stat_cache.invalidate(p)
            try:
                if backend.stat(p).exists:
                    leftovers.append(p)
            except OSError:
                leftovers.append(p)
        self.rollback_leftovers = leftovers
        # the removed outputs hand their quota charges back to the tenant
        # (no-op on untenanted mounts)
        self.fs._quota_release([p for p in created if p not in leftovers])
        # rollback mutated the backend behind the engine's back (direct
        # unlinks/rmdirs): every overlay claim under this view's scope is
        # now suspect — clear it, and every read-ahead page / batched
        # existence probe with it.  Scope-aware: a Tenant clears the
        # overlay only under its prefix, keeping neighbours' windows open.
        self.fs._clear_window_caches(rollback=True)
        # scoped clear: only this region's errors are handled — entries
        # from earlier work or a concurrently-opened region must survive
        self.fs.ledger.clear_region(self)
        # scope-aware: a Tenant clears only its own poison flag
        self.fs._reset_poison()
        self.fs._note_rollback(len(leftovers))
        self.rolled_back = True


def _entry_signal(err: BaseException) -> bool | None:
    """Transience signal of one ledger entry: None for cancellations (a
    secondary effect of poisoning — says nothing about the root cause)."""
    if isinstance(err, OpCancelledError):
        return None
    if isinstance(err, OSError):
        return err.errno in TRANSIENT_ERRNOS
    return True


def _is_resubmittable(e: BaseException, region_errs=()) -> bool:
    """Would resubmitting the job plausibly clear this failure?

    Decides from root causes: cancelled-op entries are ignored, and a
    poison raised into the body is judged by the region's own recorded
    errors (``region_errs``, snapshotted before rollback cleared them) —
    a deterministic ENOENT that tripped abort_on_error must not buy
    itself a full retry budget via the poison path."""
    if isinstance(e, TransactionFailedError):
        # retry iff any real deferred entry looks transient — deterministic
        # cascades (ENOENT under a faulted mkdir) carry their transient
        # root cause in the same ledger scope
        signals = [s for s in (_entry_signal(en.error) for en in e.entries)
                   if s is not None]
        return any(signals) if signals else True
    if isinstance(e, (EnginePoisonedError, OpCancelledError)):
        signals = [s for s in (_entry_signal(en.error) for en in region_errs)
                   if s is not None]
        return any(signals) if signals else True  # unknown cause: resubmit
    if isinstance(e, OSError):
        return e.errno in TRANSIENT_ERRNOS
    return True  # unknown failure class: keep the paper's resubmit default


def _was_killed(e: BaseException,
                region_errs=()) -> ProcessKilled | None:
    """Did this attempt die of a (simulated) process kill?  Checked before
    rollback: a dead process neither rolls back nor resubmits in-process —
    the failure must propagate so a fresh mount can ``resume()``.  Returns
    the root ``ProcessKilled`` (for uniform re-raising) or ``None``."""
    if isinstance(e, ProcessKilled):
        return e
    entries = (e.entries if isinstance(e, TransactionFailedError)
               else region_errs)
    for en in entries:
        if isinstance(en.error, ProcessKilled):
            return en.error
    return None


def _backoff_sleep(fs: CannyFS, name: str, attempt: int,
                   base_s: float, cap_s: float, seed: int | None) -> None:
    """Seeded full-jitter exponential backoff, charged on the injected
    clock.  The draw is derived per (seed, job-name, attempt) the same way
    ``FaultPlan`` derives its per-match draws — a tuple-of-int hash, stable
    across processes — defaulting to the fault plan's own seed when the
    backend stack carries one, so chaos sweeps and their emitted
    ``BENCH_*.json`` replay byte-identically per seed."""
    if seed is None:
        seed = getattr(getattr(fs.backend, "plan", None), "seed", 0)
    # per-tenant salt (empty on the base mount, so untenanted draws are
    # unchanged): one tenant's attempt count never perturbs a neighbour's
    # jitter stream
    salted = fs._backoff_salt() + name
    rng = random.Random(hash((int(seed), zlib.crc32(salted.encode("utf-8")),
                              attempt)))
    delay = rng.random() * min(cap_s, base_s * (2 ** attempt))
    if delay <= 0:
        return
    clock = fs.engine.sim
    if clock is None:
        clock = getattr(fs.backend, "clock", None)
    if clock is not None and hasattr(clock, "sleep"):
        clock.sleep(delay)
    else:
        time.sleep(delay)


def run_transaction(fs: CannyFS, body: Callable[[CannyFS], T], *,
                    name: str = "job", retries: int = 2,
                    backoff_s: float = 0.0,
                    backoff_cap_s: float = 30.0,
                    backoff_seed: int | None = None,
                    retry_on: tuple[type[BaseException], ...] = (
                        TransactionFailedError, EnginePoisonedError,
                        OpCancelledError, OSError)) -> T:
    """The paper's full model: run body as a transaction; on failure roll
    back (outputs removed) and retry the whole thing.

    ``retry_on`` defaults to every I/O-shaped failure: deferred errors
    surfacing at commit, fail-fast submissions against a poisoned engine,
    and synchronous OSErrors raised straight out of the body (a blocking
    read/readdir that hit an injected or real fault) — but only for
    *transient* errnos (``TRANSIENT_ERRNOS``).  A deterministic body bug —
    FileNotFoundError on a misspelled path, whether raised synchronously or
    deferred into the commit's TransactionFailedError — is rolled back once
    and propagates immediately.  A commit failure is still retried when
    *any* of its entries is transient: cascade errors (ENOENT on ops under
    a faulted mkdir) ride along with their transient root cause.

    ``backoff_s`` arms seeded-jitter exponential backoff between attempts:
    each resubmission sleeps ``U(0, min(backoff_cap_s, backoff_s * 2**k))``
    (full jitter, AWS-style), drawn from a per-(seed, name, attempt) RNG
    — ``backoff_seed``, defaulting to the backend fault plan's seed — and
    charged on the engine's sim clock (or the backend's virtual clock)
    when one is present, so chaos sweeps stay deterministic per seed.

    A ``ProcessKilled`` failure (injected preemption) is exempt from the
    whole loop: no rollback, no resubmission — it propagates so a fresh
    mount can ``CannyFS.resume()`` from the durability spill."""
    last: BaseException | None = None
    leftover_acc: list[str] = []   # verified leakage across all attempts
    for attempt in range(retries + 1):
        txn = Transaction(fs, name=f"{name}#{attempt}")
        try:
            with txn:
                out = body(fs)
            if leftover_acc:
                # an earlier attempt's verified leakage must not vanish
                # behind this attempt's success — route it through the
                # deferred-error channel so teardown reporting surfaces it
                fs.ledger.record(
                    0, "rollback", tuple(leftover_acc),
                    RollbackLeakError(
                        f"{len(leftover_acc)} path(s) survived rollback of "
                        f"failed attempts"))
            return out
        except retry_on as e:
            kill = _was_killed(e, fs.ledger.entries_for(txn))
            if kill is not None:
                # preempted, not failed: resume(), don't resubmit.  Raise
                # the root ProcessKilled so callers see ONE preemption
                # signal whether the kill struck a sync op in the body or
                # surfaced as a deferred entry at commit
                raise kill from e
            if not txn.rolled_back:  # commit failed inside __exit__
                txn.rollback()
            # rollback snapshotted the region's errors before clearing
            # them — the resubmittability decision needs the root causes
            region_errs = txn.final_errors
            for p in txn.rollback_leftovers:
                if p not in leftover_acc:
                    leftover_acc.append(p)
            if leftover_acc:
                # verified on-backend leakage must reach the caller, not
                # die with the per-attempt txn objects (a retry only
                # journals what it created itself, so an earlier attempt's
                # stuck path would otherwise go unreported)
                e.rollback_leftovers = list(leftover_acc)
            if not _is_resubmittable(e, region_errs):
                raise  # deterministic body bug: rolled back, not retried
            last = e
            if attempt < retries:
                fs._note_retry()  # engine-global + per-tenant bookkeeping
                if backoff_s:  # no pointless sleep after the final attempt
                    _backoff_sleep(fs, name, attempt, backoff_s,
                                   backoff_cap_s, backoff_seed)
            continue
    assert last is not None
    raise last
