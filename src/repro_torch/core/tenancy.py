"""Tenancy — N concurrent jobs on one eager engine (PR 10).

One ``CannyFS`` engine historically served exactly one job: the ledger,
poison flag, spill journal, rollback scope and in-flight budget were all
engine-global, so co-tenancy meant one tenant's fault storm rolled back
or poisoned everyone sharing the mount.  The ``Tenant`` handle turns the
per-job transaction boundary into a per-tenant isolation boundary:

* **namespace** — every op is confined to the tenant's ``root_prefix``
  (PermissionError outside it); commit/rollback clears the shared
  namespace overlay only under that prefix, leaving a neighbour's open
  optimization window intact.
* **failure domain** — ledger entries carry the tenant tag, the poison
  flag / rollback scope / retry+backoff bookkeeping / spill journal are
  per-tenant, and ``engine abort_on_error`` cancels only the faulting
  tenant's queued ops.
* **resources** — an optional ``TenantQuota`` (bytes + inodes) is
  charged synchronously at ACK time, and the scheduler dispatches ready
  lanes by deficit-weighted round-robin over the tenants' weights.
* **admission control** — at global budget saturation the scheduler
  sheds speculative lanes first, then backpressures only the over-share
  tenant's submits (see ``core/scheduler.py``).

``Tenant`` subclasses ``CannyFS`` but deliberately never calls its
``__init__``: it *shares* the parent's engine, backend and flags, and
overrides only the tenancy hooks the base class routes every public op
through.  A tenant handle is itself a full ``CannyFS`` — transactions,
spill/resume, walk/rmtree all work unchanged, scoped.
"""
from __future__ import annotations

import errno
import threading

from .backend import is_under, norm_path
from .durability import SpillManager
from .fs import CannyFS


class TenantQuota:
    """Synchronous byte + inode budget for one tenant.

    Mirrors ``QuotaBackend``'s accounting (high-water bytes per path,
    live inode set) but charges at *ACK time* in the submitting thread:
    an eager op's backend-side EDQUOT would land in the deferred ledger
    long after the ACK succeeded, whereas a tenant budget must reject the
    over-budget tenant's call immediately — and only that tenant's.

    Charges are idempotent high-water marks, so the fused-write fast path
    and the engine submit path may both charge one op safely.
    """

    def __init__(self, budget_bytes: int = 0, max_inodes: int | None = None):
        self.budget_bytes = int(budget_bytes)  # 0 = unbudgeted bytes
        self.max_inodes = max_inodes
        self._lock = threading.Lock()
        self._charged: dict[str, int] = {}     # path -> high-water bytes
        self._inodes: set[str] = set()
        self.used = 0
        self.edquot_count = 0
        self.enospc_count = 0

    # -- charging (raises to the caller BEFORE any state is mutated) --

    def _charge_inode_locked(self, p: str) -> None:
        if p in self._inodes:
            return
        if self.max_inodes is not None and len(self._inodes) >= self.max_inodes:
            self.enospc_count += 1
            raise OSError(errno.ENOSPC,
                          f"tenant inode budget ({self.max_inodes}) exhausted",
                          p)
        self._inodes.add(p)

    def _charge_bytes_locked(self, p: str, size: int) -> None:
        cur = self._charged.get(p, 0)
        if size <= cur:
            return
        delta = size - cur
        if self.budget_bytes and self.used + delta > self.budget_bytes:
            self.edquot_count += 1
            raise OSError(errno.EDQUOT,
                          f"tenant byte budget ({self.budget_bytes}) exhausted",
                          p)
        self._charged[p] = size
        self.used += delta

    def _release_locked(self, p: str) -> None:
        self.used -= self._charged.pop(p, 0)
        self._inodes.discard(p)

    def admit(self, kind: str, paths, cache_kw=None) -> None:
        """Charge (or release) one op's budget effect by kind.  Raises
        OSError(EDQUOT/ENOSPC) without mutating state when over budget."""
        kw = cache_kw or {}
        with self._lock:
            if kind in ("create", "mkdir", "symlink"):
                self._charge_inode_locked(paths[0])
            elif kind == "link":
                self._charge_inode_locked(paths[1])
            elif kind in ("write", "fallocate", "truncate"):
                p = paths[0]
                if kind == "write":
                    size = int(kw.get("offset", 0)) + int(kw.get("nbytes", 0))
                else:
                    size = int(kw.get("size", 0))
                self._charge_inode_locked(p)   # write_vec creates implicitly
                self._charge_bytes_locked(p, size)
            elif kind == "unlink":
                self._release_locked(paths[0])
            elif kind == "rmdir":
                self._inodes.discard(paths[0])
            elif kind == "remove_tree":
                root = paths[0]
                for p in [q for q in self._charged if is_under(q, root)]:
                    self._release_locked(p)
                self._inodes = {q for q in self._inodes
                                if not is_under(q, root)}
            elif kind == "rename":
                s, d = paths[0], paths[1]
                self._charge_inode_locked(d)   # may raise before the move
                moved = self._charged.pop(s, None)
                self._inodes.discard(s)
                if moved is not None:
                    # move the source's charge to the destination's
                    # high-water mark; the total never grows across a
                    # rename, so bytes cannot newly exceed the budget
                    self.used -= moved
                    cur = self._charged.get(d, 0)
                    if moved > cur:
                        self._charged[d] = moved
                        self.used += moved - cur
        # (reads/metadata kinds fall through uncharged)

    def release(self, path: str) -> None:
        """Rollback removed ``path`` behind the engine's back — refund."""
        with self._lock:
            self._release_locked(norm_path(path))

    def usage(self) -> dict:
        """Snapshot for observability (EngineStats.tenants / paper table)."""
        with self._lock:
            return {
                "budget_bytes": self.budget_bytes,
                "bytes_used": self.used,
                "bytes_remaining": (self.budget_bytes - self.used
                                    if self.budget_bytes else None),
                "max_inodes": self.max_inodes,
                "inodes_used": len(self._inodes),
                "inodes_remaining": (self.max_inodes - len(self._inodes)
                                     if self.max_inodes is not None else None),
                "edquot_count": self.edquot_count,
                "enospc_count": self.enospc_count,
            }

    def inodes_used(self) -> int:
        with self._lock:
            return len(self._inodes)


class Tenant(CannyFS):
    """A confined, isolated view over a shared ``CannyFS`` engine.

    Obtained via ``CannyFS.tenant(name, root_prefix, weight, quota)``.
    Shares the parent's engine/backend/flags (``__init__`` of the base
    class is deliberately not called) but owns:

    * a fresh transaction slot — each tenant runs its own concurrent
      ``Transaction`` / ``run_transaction`` with tenant-scoped rollback,
      ledger clear, poison reset and retry/backoff streams;
    * the scheduler-side tenant state — DWRR credit, budget-slice
      accounting, tenant poison flag;
    * an optional ``TenantQuota`` charged at ACK time;
    * its own spill journal slot (``enable_spill``/``resume`` arm the
      tenant's journal, never the shared engine one).
    """

    _ANCESTOR_OK = frozenset({"mkdir", "stat", "readdir"})

    def __init__(self, parent: CannyFS, name: str, root_prefix: str, *,
                 weight: float = 1.0, quota=None):
        self.parent = parent
        self.flags = parent.flags
        self.engine = parent.engine
        self.backend = parent.backend
        self.name = name
        self.root_prefix = norm_path(root_prefix)
        if not self.root_prefix:
            raise ValueError("tenant root_prefix must not be the fs root")
        self._txn_lock = threading.Lock()
        self._txn = None
        self._detached = threading.local()
        if isinstance(quota, int):
            quota = TenantQuota(quota)
        self.quota = quota
        self._tenant_state = self.engine.register_tenant(name, weight)
        if quota is not None:
            st = self._tenant_state.stats
            st.quota_bytes_budget = quota.budget_bytes

    # -- tenancy hooks (see CannyFS for the contract) -------------------

    def _check_paths(self, kind: str, paths) -> None:
        root = self.root_prefix
        for p in paths:
            if is_under(p, root):
                continue
            if kind in self._ANCESTOR_OK and (p == "" or is_under(root, p)):
                # probing/scaffolding the ancestor chain of the tenant's
                # own root (makedirs of the root itself, stat/readdir of
                # the fs root "") is namespace-neutral for neighbours —
                # allow it
                continue
            raise PermissionError(
                errno.EACCES,
                f"tenant {self.name!r} is confined to {root!r}", p)

    def _quota_admit(self, kind: str, paths, cache_kw=None) -> None:
        q = self.quota
        if q is None:
            return
        q.admit(kind, paths, cache_kw)
        st = self._tenant_state.stats
        st.quota_bytes_used = q.used
        st.quota_inodes_used = q.inodes_used()

    def _quota_release(self, paths) -> None:
        q = self.quota
        if q is None:
            return
        for p in paths:
            q.release(p)
        st = self._tenant_state.stats
        st.quota_bytes_used = q.used
        st.quota_inodes_used = q.inodes_used()

    def _backoff_salt(self) -> str:
        return self.name

    def _arm_spill(self, sp: SpillManager) -> None:
        self._tenant_state.spill = sp

    def _clear_window_caches(self, *, rollback: bool) -> None:
        eng = self.engine
        ov = eng.overlay
        if ov is not None:
            # prefix-scoped: the neighbour tenants' proven listings and
            # in-window membership survive this tenant's boundary
            ov.clear_under(self.root_prefix)
        if rollback and eng.readahead is not None:
            # read-ahead pages are pure caches — a global drop is
            # correctness-neutral for neighbours (their next read
            # re-primes) and guarantees no stale page survives the
            # direct-backend rollback sweep
            eng.readahead.clear()
        sb = eng.stat_batcher
        if sb is not None:
            sb.clear()

    # -- lifecycle ------------------------------------------------------

    @property
    def poisoned(self) -> bool:
        """True once THIS tenant's abort tripped (or the whole engine)."""
        return self._tenant_state.poisoned or self.engine.poisoned

    @property
    def tenant_stats(self):
        """This tenant's ``TenantStats`` sub-snapshot."""
        return self._tenant_state.stats

    def tenant_ledger(self):
        """Deferred errors attributed to this tenant only."""
        return self.engine.ledger.entries_for_tenant(self.name)

    def drain(self) -> None:
        sp = self._spill()
        if sp is not None:
            sp.finalize_all(self)
        self.engine.drain()

    def close(self) -> None:
        """Release the handle: settle this tenant's diverted streams and
        wait for the engine to drain — the shared engine itself is NEVER
        torn down by a tenant (the owning mount's close() does that)."""
        self.drain()
