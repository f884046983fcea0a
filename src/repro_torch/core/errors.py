"""Error model for the transactional eager-I/O engine.

The paper defers error reporting: background failures are recorded in a
ledger, printed twice (at occurrence and at orderly teardown), and surfaced
at the transaction boundary.  An optional abort-on-error mode poisons the
engine so every later access fails fast.
"""
from __future__ import annotations

import sys
import threading
import time
from dataclasses import dataclass, field


class CannyError(Exception):
    """Base class for engine errors."""


class EnginePoisonedError(CannyError):
    """Raised on new submissions after abort_on_error tripped."""


class OpCancelledError(CannyError):
    """A queued op was cancelled (engine poisoned before execution)."""


class RollbackLeakError(CannyError):
    """Rollback verified that some transaction outputs could not be
    removed.  Recorded in the ledger (untagged) when the job ultimately
    succeeds anyway, so teardown reporting still surfaces the leak."""


class ProcessKilled(CannyError):
    """Simulated SIGKILL: the process (and with it the backend connection)
    died mid-job.  Deliberately NOT an OSError — an in-process retry
    cannot clear it (the process is 'gone'), so ``run_transaction`` must
    neither roll back nor resubmit; recovery is a fresh mount's
    ``CannyFS.resume(spill_dir)`` against the durable spill journal
    (``core/durability.py``).  Raised by ``FaultInjectingBackend`` when a
    ``FaultRule(outcome="kill")`` fires, and by every later call against
    the dead backend."""


class ShortWriteError(OSError, CannyError):
    """A (possibly fused/vectored) write landed fewer bytes than submitted
    — a torn op.  Carries errno EIO so the transactional retry loop treats
    it as transient: the torn file is journaled (rollback removes it) and
    the resubmitted job rewrites it whole."""

    def __init__(self, path: str, expected: int, written: int):
        import errno as _errno
        super().__init__(_errno.EIO,
                         f"short write: {written}/{expected} bytes", path)
        self.expected = expected
        self.written = written


class TransactionFailedError(CannyError):
    """Commit found deferred errors in the ledger."""

    def __init__(self, entries: list["LedgerEntry"]):
        self.entries = entries
        lines = "; ".join(str(e) for e in entries[:8])
        more = "" if len(entries) <= 8 else f" (+{len(entries) - 8} more)"
        super().__init__(f"{len(entries)} deferred I/O error(s): {lines}{more}")


@dataclass(frozen=True)
class LedgerEntry:
    """One deferred failure: which op, on what path(s), what went wrong.

    ``region`` identifies the transaction that was active when the op was
    *submitted* (None for non-transactional work).  Record order cannot be
    scoped positionally — op ``seq`` is assigned at submission, ops finish
    out of order, and concurrent regions interleave — so the tag is what
    attributes an entry exactly."""

    seq: int
    kind: str
    paths: tuple[str, ...]
    error: BaseException
    wallclock: float
    region: object = None
    tenant: str | None = None

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return f"op#{self.seq} {self.kind}({', '.join(self.paths)}): {self.error!r}"


class ErrorLedger:
    """Thread-safe record of deferred I/O failures.

    Mirrors the paper's behaviour: every failure is printed to stderr when it
    happens, and the full ledger is printed again at orderly teardown so the
    user is "notified of any I/O errors that were not properly reported back
    to the calling process".
    """

    def __init__(self, *, echo: bool = True):
        self._lock = threading.Lock()
        self._entries: list[LedgerEntry] = []
        self._echo = echo

    def record(self, seq: int, kind: str, paths: tuple[str, ...],
               error: BaseException, region: object = None,
               tenant: str | None = None) -> LedgerEntry:
        with self._lock:
            entry = LedgerEntry(seq=seq, kind=kind, paths=paths, error=error,
                                wallclock=time.time(), region=region,
                                tenant=tenant)
            self._entries.append(entry)
        # cancellations are secondary effects of one poisoning failure —
        # echoing thousands of them per rollback drowns the root cause
        if self._echo and not isinstance(error, OpCancelledError):
            print(f"cannyfs: deferred error: {entry}", file=sys.stderr)
        return entry

    def entries(self) -> list[LedgerEntry]:
        with self._lock:
            return list(self._entries)

    def entries_for(self, region: object) -> list[LedgerEntry]:
        """Entries from ops submitted while ``region`` was the active
        transaction."""
        with self._lock:
            return [e for e in self._entries if e.region is region]

    def clear_where(self, pred) -> list["LedgerEntry"]:
        """Drop (and return) every entry matching ``pred`` — for callers
        that handled a scoped set of failures themselves (the checkpoint
        manager's per-directory commit check)."""
        with self._lock:
            dropped = [e for e in self._entries if pred(e)]
            self._entries = [e for e in self._entries if not pred(e)]
            return dropped

    def clear_region(self, region: object) -> list["LedgerEntry"]:
        """Drop (and return) exactly one region's entries.

        This is the transaction-scoped clear: a rollback must forget the
        failed region's errors without touching entries from earlier work
        (region None) or from another region that opened concurrently —
        serial ranges of interleaved regions overlap, tags don't."""
        return self.clear_where(lambda e: e.region is region)

    def entries_for_tenant(self, tenant: str | None) -> list[LedgerEntry]:
        """Entries attributed to ``tenant`` (the tenant name stamped at
        submission; ``None`` selects untenanted work)."""
        with self._lock:
            return [e for e in self._entries if e.tenant == tenant]

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def report(self) -> None:
        """Teardown-time second report (the paper's global destructor).
        Cancellations are summarized as one count line, not spelled out."""
        entries = self.entries()
        if not entries or not self._echo:
            return
        real = [e for e in entries
                if not isinstance(e.error, OpCancelledError)]
        n_cancelled = len(entries) - len(real)
        print(f"cannyfs: {len(entries)} deferred I/O error(s) at teardown:",
              file=sys.stderr)
        for e in real:
            print(f"cannyfs:   {e}", file=sys.stderr)
        if n_cancelled:
            print(f"cannyfs:   (+{n_cancelled} op(s) cancelled by poisoning)",
                  file=sys.stderr)
