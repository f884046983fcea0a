"""Deterministic fault injection for the storage stack.

The paper's central bet — every I/O can be eagerly ACKed because a failure
"will frequently warrant the resubmission of a full job" — is only testable
if the stack can *produce* failures on demand.  This module provides:

* ``FaultRule``  — one failure clause: match by op kind, path glob, call
  window and/or probability; raise a chosen errno (``EACCES``/``ENOSPC``/
  ``EDQUOT``/``EIO``) or a connection loss.  Besides raising, a rule can
  fire as a *torn op* (``outcome="short"``: ``write_at``/``write_vec``
  return a short byte count instead of raising — the engine surfaces the
  tear as a deferred ``ShortWriteError``) or a *latency spike*
  (``outcome="delay"``: the op sleeps ``delay_s`` on the backend's clock
  and then succeeds — slow ops, not failed ops, for the straggler/
  backpressure path) or as a *process death* (``outcome="kill"``: the op
  raises ``ProcessKilled`` and the backend goes dead — every later call
  fails the same way until ``revive()`` — the deterministic SIGKILL
  simulation behind the preemption/resume harness).
* ``FaultPlan``  — a seeded, thread-safe collection of rules.  The same
  seed always yields the same fault schedule, so ledger contents and
  rollback behaviour replay bit-identically in tests.
* ``FaultInjectingBackend`` — decorator that consults a plan before every
  primitive op.  Composable with the other decorators:

      FaultInjectingBackend(QuotaBackend(LatencyBackend(InMemoryBackend())))

* ``QuotaBackend`` — enforces a byte budget (and, with ``max_inodes``, an
  inode budget) so disk-quota exhaustion (a headline error class in the
  paper) emerges organically mid-write/mid-create instead of being
  scripted; rollback's unlinks/rmdirs — and a fused ``remove_tree`` —
  release the charges, which is exactly why the paper's
  roll-back-and-resubmit loop converges.
"""
from __future__ import annotations

import errno as _errno
import fnmatch
import random
import threading
from dataclasses import dataclass, field

from .backend import Clock, RealClock, StorageBackend, is_under, norm_path
from .errors import ProcessKilled

# errno spellings accepted by FaultRule.error (connection loss raises a
# ConnectionResetError, which the engine defers like any other OSError).
ERRNOS = {
    "EACCES": _errno.EACCES,
    "ENOSPC": _errno.ENOSPC,
    "EDQUOT": _errno.EDQUOT,
    "EIO": _errno.EIO,
    "ECONNRESET": _errno.ECONNRESET,
}


OUTCOMES = ("raise", "short", "delay", "kill")


def make_fault(error: str, path: str, *, outcome: str = "raise",
               short_fraction: float = 0.5, delay_s: float = 0.0) -> OSError:
    """Build the fault token for one injected failure, tagged ``.injected``.

    The token is always an OSError (the ``raise`` outcome raises it
    verbatim); for ``short``/``delay`` outcomes it carries the outcome
    parameters and ``FaultInjectingBackend`` interprets it instead of
    raising."""
    if error not in ERRNOS:
        raise ValueError(f"unknown fault error {error!r}; one of {sorted(ERRNOS)}")
    if error == "ECONNRESET":
        exc: OSError = ConnectionResetError(
            ERRNOS[error], "injected connection loss", path)
    else:
        exc = OSError(ERRNOS[error], f"injected {error}", path)
    exc.injected = True  # lets tests/ledgers distinguish chaos from real bugs
    exc.outcome = outcome
    exc.short_fraction = short_fraction
    exc.delay_s = delay_s
    return exc


@dataclass(frozen=True)
class FaultRule:
    """One failure clause.  A rule *matches* an op when every constraint
    holds; whether a matching call actually *fires* is then decided by the
    call-count window, ``probability`` (seeded plan RNG) and the remaining
    ``max_failures`` budget.

    ``outcome`` selects what firing does: ``"raise"`` (default) raises the
    errno, ``"short"`` makes a write land only ``short_fraction`` of its
    bytes and return the short count (torn op; matches write ops only),
    ``"delay"`` stalls the op ``delay_s`` seconds on the backend's clock
    and then lets it succeed (latency spike), ``"kill"`` raises
    ``ProcessKilled`` *before* the op applies and leaves the backend dead
    (preemption mid-flight: the admitted op never lands).  Fault matching
    is per
    *backend call*: N engine writes coalesced into one ``write_vec`` are a
    single matching call, and a short outcome tears the fused vector as a
    unit."""

    error: str = "EIO"
    ops: tuple[str, ...] | None = None   # op kinds to match; None = all
    path_glob: str | None = None         # fnmatch over the normalized path
    probability: float = 1.0             # chance a matching call fires
    after_count: int = 0                 # skip the first N matching calls
    max_failures: int | None = None      # stop firing after N failures
    outcome: str = "raise"               # "raise" | "short" | "delay" | "kill"
    short_fraction: float = 0.5          # of the payload, for "short"
    delay_s: float = 0.25                # stall length, for "delay"

    def __post_init__(self):
        if self.outcome not in OUTCOMES:
            raise ValueError(
                f"unknown outcome {self.outcome!r}; one of {OUTCOMES}")

    def matches(self, kind: str, path: str) -> bool:
        if self.outcome == "short" and kind != "write":
            return False  # only data writes can tear
        if self.ops is not None and kind not in self.ops:
            return False
        if self.path_glob is not None and not fnmatch.fnmatchcase(
                norm_path(path), self.path_glob):
            return False
        return True


class FaultPlan:
    """Seeded, thread-safe fault schedule.

    ``check(kind, path)`` returns the OSError to raise (or None).
    Probability draws are derived per (seed, rule, match-index) rather than
    from one shared sequential RNG, so the *number* of fires within any
    fixed count of matching calls is identical for a given seed no matter
    how worker threads interleave.  Exact ledger contents (which paths
    faulted) additionally require a deterministic execution order — a
    single worker, a drained step-by-step workload, or count/glob-based
    rules."""

    def __init__(self, rules: list[FaultRule] | None = None, *, seed: int = 0):
        self.rules = list(rules or [])
        self.seed = seed
        self._lock = threading.Lock()
        self._active = True
        self.match_counts = [0] * len(self.rules)
        self.fire_counts = [0] * len(self.rules)
        self.injected = 0                      # faults raised or torn
        self.injected_by_kind: dict[str, int] = {}
        self.delayed = 0                       # latency spikes fired
        self.delay_s_total = 0.0               # total injected stall time
        self.kills = 0                         # process deaths fired
        self.op_counts: dict[str, int] = {}    # trace: every op seen

    # -- schedule control -------------------------------------------------
    def expire(self) -> None:
        """Disable every rule (the 'transient outage ends' knob)."""
        with self._lock:
            self._active = False

    def reset(self, *, seed: int | None = None) -> None:
        """Re-arm all rules and counters (optionally reseeding)."""
        with self._lock:
            self._active = True
            if seed is not None:
                self.seed = seed
            self.match_counts = [0] * len(self.rules)
            self.fire_counts = [0] * len(self.rules)
            self.injected = 0
            self.injected_by_kind = {}
            self.delayed = 0
            self.delay_s_total = 0.0
            self.kills = 0
            self.op_counts = {}

    # -- the hot path -----------------------------------------------------
    def check(self, kind: str, path: str) -> OSError | None:
        with self._lock:
            self.op_counts[kind] = self.op_counts.get(kind, 0) + 1
            if not self._active:
                return None
            for i, rule in enumerate(self.rules):
                if not rule.matches(kind, path):
                    continue
                self.match_counts[i] += 1
                if self.match_counts[i] <= rule.after_count:
                    continue
                if (rule.max_failures is not None
                        and self.fire_counts[i] >= rule.max_failures):
                    continue
                if rule.probability < 1.0:
                    # per-(seed, rule, match-index) draw: fire counts are
                    # scheduling-independent (tuple-of-int hash is stable
                    # across processes, unlike str hashing)
                    draw = random.Random(
                        hash((self.seed, i, self.match_counts[i]))).random()
                    if draw >= rule.probability:
                        continue
                self.fire_counts[i] += 1
                if rule.outcome == "delay":
                    # a spike is a slow success, not a fault: counted apart
                    self.delayed += 1
                    self.delay_s_total += rule.delay_s
                elif rule.outcome == "kill":
                    self.kills += 1
                    self.injected += 1
                    self.injected_by_kind[kind] = \
                        self.injected_by_kind.get(kind, 0) + 1
                else:
                    self.injected += 1
                    self.injected_by_kind[kind] = \
                        self.injected_by_kind.get(kind, 0) + 1
                return make_fault(rule.error, path, outcome=rule.outcome,
                                  short_fraction=rule.short_fraction,
                                  delay_s=rule.delay_s)
        return None

    def stats(self) -> dict:
        with self._lock:
            return {
                "injected": self.injected,
                "injected_by_kind": dict(self.injected_by_kind),
                "delayed": self.delayed,
                "delay_s_total": self.delay_s_total,
                "kills": self.kills,
                "match_counts": list(self.match_counts),
                "fire_counts": list(self.fire_counts),
                "ops_seen": dict(self.op_counts),
            }


# ---------------------------------------------------------------------------


class FaultInjectingBackend(StorageBackend):
    """Decorator: consult a FaultPlan before delegating each primitive.

    Sits anywhere in the decorator stack; putting it outermost means the
    fault is charged *before* latency/quota are paid (a client-visible
    refusal), innermost means the op travelled to the 'server' first.

    ``clock`` serves the ``delay`` outcome (latency spikes): pass the same
    ``VirtualClock`` as the latency layer so spike schedules replay without
    real sleeps.  Defaults to real time."""

    def __init__(self, inner: StorageBackend, plan: FaultPlan,
                 clock: Clock | None = None,
                 kill_scope: str | None = None):
        self.inner = inner
        self.plan = plan
        self._fault_clock = clock or RealClock()
        self._dead = False
        # tenancy (PR 10): with ``kill_scope`` set (an fnmatch glob, e.g.
        # "tA/*"), a kill models the death of ONE tenant's worker process
        # sharing the mount — only calls on matching paths raise
        # ProcessKilled afterwards; neighbours' paths keep flowing.
        # Default None keeps the legacy whole-process semantics.
        self.kill_scope = kill_scope

    def __getattr__(self, name):  # delegate non-op attrs (snapshot, model…)
        return getattr(self.inner, name)

    def revive(self) -> None:
        """Clear the dead state: the 'fresh process re-attaches to the
        same storage' step of a preemption test.  The plan's counters are
        untouched — re-arm or expire it separately."""
        self._dead = False

    def _dead_for(self, path: str) -> bool:
        if not self._dead:
            return False
        if self.kill_scope is None:
            return True
        return fnmatch.fnmatchcase(norm_path(path), self.kill_scope)

    def cost_hint(self, op: str, nbytes: int = 0):
        # explicit inward delegation: the StorageBackend base defines
        # cost_hint (returning None), which would shadow __getattr__ —
        # faults add no cost of their own, the wrapped model answers
        return self.inner.cost_hint(op, nbytes)

    def _gate(self, kind: str, path: str) -> OSError | None:
        """Consult the plan.  Raise-outcome faults raise here; a delay
        outcome sleeps and clears; a short outcome is returned as a token
        for the write paths to interpret (torn op); a kill outcome flips
        the backend dead and raises ``ProcessKilled`` — as does every
        subsequent call, whatever the plan says (a dead process does not
        come back by retrying)."""
        if self._dead_for(path):
            exc = ProcessKilled(f"backend is dead (injected kill): "
                                f"{kind}({path})")
            exc.injected = True
            raise exc
        err = self.plan.check(kind, path)
        if err is None:
            return None
        outcome = getattr(err, "outcome", "raise")
        if outcome == "delay":
            self._fault_clock.sleep(err.delay_s)
            return None
        if outcome == "kill":
            # pre-apply death: the gated op was admitted but never lands
            self._dead = True
            exc = ProcessKilled(f"injected kill during {kind}({path})")
            exc.injected = True
            raise exc
        if outcome == "short":
            return err
        raise err

    @staticmethod
    def _tear(segments: list[tuple[int, bytes]],
              fraction: float) -> list[tuple[int, bytes]]:
        """Keep only the leading ``fraction`` of the vector's bytes —
        the torn prefix that 'reached the disk'."""
        budget = int(sum(len(d) for _, d in segments) * fraction)
        out: list[tuple[int, bytes]] = []
        for off, data in segments:
            take = min(len(data), budget)
            if take > 0:
                out.append((off, data[:take]))
            budget -= take
            if budget <= 0:
                break
        return out

    # namespace
    def mkdir(self, path): self._gate("mkdir", path); self.inner.mkdir(path)
    def rmdir(self, path): self._gate("rmdir", path); self.inner.rmdir(path)
    def create(self, path): self._gate("create", path); self.inner.create(path)
    def unlink(self, path): self._gate("unlink", path); self.inner.unlink(path)
    def rename(self, src, dst):
        # gate both endpoints so dst-targeting globs see renames *into*
        # their subtree (each counts as a matching call)
        self._gate("rename", src)
        self._gate("rename", dst)
        self.inner.rename(src, dst)
    def symlink(self, t, p): self._gate("symlink", p); self.inner.symlink(t, p)
    def link(self, s, d): self._gate("link", d); self.inner.link(s, d)
    def readlink(self, p): self._gate("readlink", p); return self.inner.readlink(p)
    # data — faults fire per backend call: one fused write_vec of N
    # coalesced writes is a single matching call for the plan
    def write_at(self, p, o, data):
        tok = self._gate("write", p)
        if tok is not None:   # torn op: land a prefix, return the short count
            torn = self._tear([(o, data)], tok.short_fraction)
            if torn:
                return self.inner.write_at(p, torn[0][0], torn[0][1])
            return 0
        return self.inner.write_at(p, o, data)

    def write_vec(self, p, segments):
        tok = self._gate("write", p)
        if tok is not None:
            torn = self._tear(segments, tok.short_fraction)
            return self.inner.write_vec(p, torn) if torn else 0
        return self.inner.write_vec(p, segments)
    def read_at(self, p, o, size):
        self._gate("read", p); return self.inner.read_at(p, o, size)
    def truncate(self, p, s): self._gate("truncate", p); self.inner.truncate(p, s)
    def fallocate(self, p, s): self._gate("fallocate", p); self.inner.fallocate(p, s)
    def fsync(self, p): self._gate("fsync", p); self.inner.fsync(p)
    # metadata
    def chmod(self, p, m): self._gate("chmod", p); self.inner.chmod(p, m)
    def chown(self, p, u, g): self._gate("chown", p); self.inner.chown(p, u, g)
    def utimens(self, p, a, m): self._gate("utimens", p); self.inner.utimens(p, a, m)
    def setxattr(self, p, k, v): self._gate("setxattr", p); self.inner.setxattr(p, k, v)
    def removexattr(self, p, k): self._gate("removexattr", p); self.inner.removexattr(p, k)
    def stat(self, p): self._gate("stat", p); return self.inner.stat(p)
    def readdir(self, p): self._gate("readdir", p); return self.inner.readdir(p)

    def readdir_plus(self, p):
        # one fused listing call = one matching "readdir" call for the
        # plan; per-entry stat rules do not fire (the warm-up is advisory
        # and must not condemn a region — cf. the prefetch-fault test)
        self._gate("readdir", p)
        return self.inner.readdir_plus(p)

    def readdir_plus_vec(self, paths):
        # per-fused-call semantics, mirroring write_vec/remove_tree: one
        # vectored batch of N listings is ONE matching "readdir" call,
        # gated on the batch's first path.  The caller (the speculative
        # prefetcher) treats a fired fault as advisory — the batch is
        # dropped and the walk falls back per-directory; nothing lands in
        # the ledger and no region is condemned.
        self._gate("readdir", paths[0] if paths else "")
        return self.inner.readdir_plus_vec(paths)

    def stat_vec(self, paths):
        # one fused batch of N existence probes is ONE matching "stat"
        # call, gated on the batch's first path (cf. readdir_plus_vec).
        # The existence batcher treats a fired fault as advisory: the
        # batch is dropped and each consumer falls back to its sync stat.
        self._gate("stat", paths[0] if paths else "")
        return self.inner.stat_vec(paths)

    def read_vec(self, p, spans):
        # one fused extent vector is ONE matching "read" call (cf.
        # write_vec): the read-ahead layer drops a faulted window and the
        # consumer's sync read re-gates it as its own matching call.
        self._gate("read", p)
        return self.inner.read_vec(p, spans)

    def remove_tree(self, p):
        # per-fused-op semantics, mirroring write_vec: N collapsed
        # unlinks/rmdirs are ONE matching "remove_tree" call
        self._gate("remove_tree", p)
        return self.inner.remove_tree(p)


# ---------------------------------------------------------------------------


class QuotaBackend(StorageBackend):
    """Byte- and inode-budget decorator: EDQUOT once cumulative file bytes
    exceed ``budget_bytes``; ENOSPC once ``max_inodes`` namespace entries
    (create/mkdir/symlink/link) are in flight.

    Accounting is by charged byte ranges per path (grow on write/truncate/
    fallocate past the previous high-water mark, release on unlink or
    shrinking truncate, move on rename) plus a charged-inode set (charge
    on create/mkdir/symlink/link, release on unlink/rmdir and on a bulk
    ``remove_tree``, move on rename).  Pre-existing entries written
    directly to the inner backend are not charged — the budget covers what
    flows *through* this decorator, which is the transaction's footprint.
    Charge and release are exception-safe and symmetric: a delegated op
    that raises uncharges, and rollback's removals release, which is why
    the paper's roll-back-and-resubmit loop converges."""

    def __init__(self, inner: StorageBackend, budget_bytes: int, *,
                 max_inodes: int | None = None):
        self.inner = inner
        self.budget_bytes = int(budget_bytes)
        self.max_inodes = None if max_inodes is None else int(max_inodes)
        self._qlock = threading.Lock()
        self._charged: dict[str, int] = {}   # path -> charged size
        self._inodes: set[str] = set()       # paths holding an inode charge
        self.used = 0
        self.inodes_used = 0
        self.edquot_count = 0
        self.enospc_count = 0

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def cost_hint(self, op: str, nbytes: int = 0):
        # explicit inward delegation (see FaultInjectingBackend.cost_hint)
        return self.inner.cost_hint(op, nbytes)

    @property
    def remaining(self) -> int:
        with self._qlock:
            return self.budget_bytes - self.used

    @property
    def inodes_remaining(self) -> int | None:
        if self.max_inodes is None:
            return None
        with self._qlock:
            return self.max_inodes - self.inodes_used

    def usage(self) -> dict:
        """One consistent snapshot of the budget state — the per-tenant
        observability accessor (PR 10), mirrored by ``TenantQuota.usage``
        and surfaced in the ``multi_tenant`` paper table."""
        with self._qlock:
            return {
                "budget_bytes": self.budget_bytes,
                "bytes_used": self.used,
                "bytes_remaining": self.budget_bytes - self.used,
                "max_inodes": self.max_inodes,
                "inodes_used": self.inodes_used,
                "inodes_remaining": (None if self.max_inodes is None
                                     else self.max_inodes - self.inodes_used),
                "edquot_count": self.edquot_count,
                "enospc_count": self.enospc_count,
            }

    # -- inode accounting ----------------------------------------------

    def _charge_inode(self, path: str) -> bool:
        """Charge one inode for ``path``; raise ENOSPC when exhausted.
        Returns True iff a new charge was taken (so a failed delegate can
        uncharge exactly what it charged — recharging an owned path, e.g.
        create-with-O_TRUNC over a charged file, is free)."""
        if self.max_inodes is None:
            return False
        path = norm_path(path)
        with self._qlock:
            if path in self._inodes:
                return False
            if self.inodes_used + 1 > self.max_inodes:
                self.enospc_count += 1
                # organic budget exhaustion, not scripted chaos: no
                # .injected tag (mirrors the EDQUOT path)
                raise OSError(_errno.ENOSPC, "inode quota exceeded", path)
            self._inodes.add(path)
            self.inodes_used += 1
            return True

    def _uncharge_inode(self, path: str, charged: bool) -> None:
        if not charged:
            return
        path = norm_path(path)
        with self._qlock:
            if path in self._inodes:
                self._inodes.discard(path)
                self.inodes_used -= 1

    def _release_inode(self, path: str) -> None:
        path = norm_path(path)
        with self._qlock:
            if path in self._inodes:
                self._inodes.discard(path)
                self.inodes_used -= 1

    def _grow(self, path: str, new_size: int) -> int:
        """Charge growth up to new_size; raise EDQUOT if over budget.
        Returns the bytes charged so a failed delegate can uncharge."""
        path = norm_path(path)
        with self._qlock:
            prev = self._charged.get(path, 0)
            growth = new_size - prev
            if growth <= 0:
                return 0
            if self.used + growth > self.budget_bytes:
                self.edquot_count += 1
                # no .injected tag: this is organic budget exhaustion, not
                # scripted chaos — keep the two distinguishable in stats
                raise OSError(_errno.EDQUOT, "disk quota exceeded", path)
            self._charged[path] = new_size
            self.used += growth
            return growth

    def _uncharge(self, path: str, growth: int) -> None:
        """Back out a charge whose delegated op raised — no bytes landed."""
        if growth <= 0:
            return
        path = norm_path(path)
        with self._qlock:
            cur = self._charged.get(path, 0) - growth
            if cur <= 0:
                self._charged.pop(path, None)
            else:
                self._charged[path] = cur
            self.used -= growth

    def _release(self, path: str, new_size: int = 0) -> None:
        path = norm_path(path)
        with self._qlock:
            prev = self._charged.get(path, 0)
            if new_size >= prev:
                return
            if new_size <= 0:
                self._charged.pop(path, None)
            else:
                self._charged[path] = new_size
            self.used -= prev - new_size

    # namespace (dir bytes are free; every new entry costs an inode)
    def mkdir(self, path):
        inode = self._charge_inode(path)
        try:
            self.inner.mkdir(path)
        except BaseException:
            self._uncharge_inode(path, inode)
            raise

    def rmdir(self, path):
        self.inner.rmdir(path)
        self._release_inode(path)

    def create(self, path):
        inode = self._charge_inode(path)
        try:
            self.inner.create(path)
        except BaseException:
            self._uncharge_inode(path, inode)
            raise
        self._release(path)   # create truncates (O_TRUNC): old bytes are gone

    def unlink(self, path):
        self.inner.unlink(path)
        self._release(path)
        self._release_inode(path)

    def rename(self, src, dst):
        self.inner.rename(src, dst)
        src, dst = norm_path(src), norm_path(dst)
        if src == dst:
            return
        with self._qlock:
            # an overwriting rename destroys the old destination file —
            # release its charge or `used` inflates forever
            prev = self._charged.pop(dst, None)
            if prev:
                self.used -= prev
            for p in [p for p in self._charged if is_under(p, src)]:
                self._charged[dst + p[len(src):]] = self._charged.pop(p)
            if dst in self._inodes:
                self._inodes.discard(dst)
                self.inodes_used -= 1
            for p in [p for p in self._inodes if is_under(p, src)]:
                self._inodes.discard(p)
                self._inodes.add(dst + p[len(src):])

    def symlink(self, t, p):
        inode = self._charge_inode(p)
        try:
            self.inner.symlink(t, p)
        except BaseException:
            self._uncharge_inode(p, inode)
            raise

    def link(self, src, dst):
        # charge the new name as if it were a copy: per-path accounting
        # over-counts shared storage, but the alternative (free links whose
        # unlink releases the charge) lets linked data escape the budget
        with self._qlock:
            src_charge = self._charged.get(norm_path(src), 0)
        inode = self._charge_inode(dst)
        growth = self._grow(dst, src_charge)
        try:
            self.inner.link(src, dst)
        except BaseException:
            self._uncharge(dst, growth)
            self._uncharge_inode(dst, inode)
            raise

    def readlink(self, p): return self.inner.readlink(p)

    def readdir_plus(self, p):
        # must delegate whole: the base loop would re-enter this
        # decorator's per-entry ops instead of the inner fused call
        return self.inner.readdir_plus(p)

    def readdir_plus_vec(self, paths):
        return self.inner.readdir_plus_vec(paths)

    def stat_vec(self, paths):
        # must delegate whole: the base loop would re-enter this
        # decorator per path instead of the inner fused call
        return self.inner.stat_vec(paths)

    def read_vec(self, p, spans):
        return self.inner.read_vec(p, spans)

    def remove_tree(self, path):
        """Bulk removal releases every byte and inode charge under the
        root in one sweep — the uncharge mirror of the fused call.  On a
        partial failure (inner raised mid-walk) nothing is released: the
        surviving paths keep their charges (conservative over-count until
        the retried removal converges)."""
        n = self.inner.remove_tree(path)
        root = norm_path(path)
        with self._qlock:
            for p in [p for p in self._charged if is_under(p, root)]:
                self.used -= self._charged.pop(p)
            for p in [p for p in self._inodes if is_under(p, root)]:
                self._inodes.discard(p)
                self.inodes_used -= 1
        return n

    # data
    def write_at(self, path, offset, data):
        growth = self._grow(path, offset + len(data))
        try:
            n = self.inner.write_at(path, offset, data)
        except BaseException:
            self._uncharge(path, growth)
            raise
        if n < len(data):
            # torn op: bytes past the achieved high-water mark never landed
            self._uncharge(path, min(growth, offset + len(data) - (offset + n)))
        return n

    def write_vec(self, path, segments):
        """Vectored write: the whole fused batch is charged (to its highest
        end offset) before one delegated call — EDQUOT decides per fused
        op, matching the fault-injection semantics."""
        if not segments:
            return 0
        end = max(off + len(data) for off, data in segments)
        total = sum(len(data) for _, data in segments)
        growth = self._grow(path, end)
        try:
            n = self.inner.write_vec(path, segments)
        except BaseException:
            self._uncharge(path, growth)
            raise
        if n < total:
            # back out the charge beyond the high-water offset the torn
            # vector actually reached (segments land in order)
            achieved, rem = 0, n
            for off, data in segments:
                take = min(len(data), rem)
                if take > 0:
                    achieved = max(achieved, off + take)
                rem -= take
                if rem <= 0:
                    break
            self._uncharge(path, min(growth, end - achieved))
        return n

    def read_at(self, p, o, size): return self.inner.read_at(p, o, size)

    def truncate(self, path, size):
        growth = self._grow(path, size)
        try:
            self.inner.truncate(path, size)
        except BaseException:
            self._uncharge(path, growth)
            raise
        self._release(path, size)

    def fallocate(self, path, size):
        growth = self._grow(path, size)
        try:
            self.inner.fallocate(path, size)
        except BaseException:
            self._uncharge(path, growth)
            raise

    def fsync(self, p): self.inner.fsync(p)
    # metadata
    def chmod(self, p, m): self.inner.chmod(p, m)
    def chown(self, p, u, g): self.inner.chown(p, u, g)
    def utimens(self, p, a, m): self.inner.utimens(p, a, m)
    def setxattr(self, p, k, v): self.inner.setxattr(p, k, v)
    def removexattr(self, p, k): self.inner.removexattr(p, k)
    def stat(self, p): return self.inner.stat(p)
    def readdir(self, p): return self.inner.readdir(p)
