"""Namespace overlay: the write-back directory-tree delta of the pending
op stream.

The optimizer's blind spot before this layer was `readdir`: every
namespace *read* was an observation point that sealed the pending chains
beneath it, so a readdir-driven `rmtree` — the paper's second headline
benchmark — forfeited elision and paid one backend op per entry.  The
overlay closes that gap by mirroring the engine's submitted mutations as
a per-directory membership delta:

* every namespace mutation (`mkdir`/`create`/`symlink`/`link`/`unlink`/
  `rmdir`/`rename`/`remove_tree`, plus implicit-create `write`s) is
  applied to the overlay at *admission* — the same instant the
  write-through stat cache learns it, strictly before the op can run;
* a directory is **complete** when its full membership is determined by
  the transaction's own writes (created inside the window) or by a cached
  backend listing (installed when a readdir miss executed);
* `readdir`/`stat`/`exists` become *overlay reads*: when the answer is
  fully determined by pending state + cache they return immediately and
  **do not seal** the chains below — observation-point classification is
  per-answer, not per-call.  An overlay miss still takes the sync path
  and seals, exactly as before.

Correctness contract (mirrors the stat cache's): the overlay answers
from *intended effects* in submission order.  A background op that later
fails invalidates every overlay claim on its paths (membership dropped,
parent completeness demoted), so the next read consults the backend; the
deferred-error ledger carries the truth either way.  A tolerant
`makedirs` mkdir that lands on a pre-existing directory demotes the
directory's completeness at execution (its real contents are unknown).

The overlay is also what makes **cross-path bulk-remove fusion** safe:
`Fuser.prepare_bulk_remove` may collapse the pending unlinks/rmdirs
under a directory into one vectored ``remove_tree`` backend call only
when the subtree is overlay-known — i.e. when the engine can prove the
directory ends empty from its own write stream (see fusion.py).

Lifecycle: populated at submission, invalidated per-path on op failure,
cleared wholesale by transaction rollback (which mutates the backend
behind the engine's back) and dropped at commit (the delta is spent once
the window closes).
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass

from .backend import StatResult, is_under, norm_path, parent_of

# membership kinds tracked per directory entry (None = present, kind
# not yet proven — enough for readdir, not enough for a bulk remove)
_DIR, _FILE, _LINK = "dir", "file", "link"


@dataclass(frozen=True)
class OverlayPolicy:
    """Which overlay answers are allowed.  This is where the engine's old
    ``mock_stat``/``readdir_prefetch``/``negative_stat_cache`` flags now
    live: ``CannyFS(overlay=None)`` derives a policy from the legacy
    flags, ``overlay=OverlayPolicy(...)`` supersedes them."""

    enabled: bool = True
    readdir_overlay: bool = True   # answer readdir from the overlay
    mock_stat: bool = True         # answer stat from the write-through cache
    negative_stat: bool = True     # ...including proven-absent answers
    prefetch: bool = True          # readdir misses warm the stat cache
    #                                (one vectored readdir_plus call)
    # LRU bound on directories whose completeness comes from a *cached
    # backend listing* (installed by an executed readdir miss).  Eviction
    # demotes completeness only — the pending membership delta (entries
    # created/unlinked through the mount) is never dropped, so a re-listed
    # directory still merges the transaction's own writes.  Directories
    # complete from in-window creation don't count against the bound.
    # <= 0 means unbounded.
    max_cached_listings: int = 4096

    @classmethod
    def off(cls) -> "OverlayPolicy":
        return cls(enabled=False, readdir_overlay=False, mock_stat=False,
                   negative_stat=False, prefetch=False)

    @classmethod
    def from_flags(cls, flags) -> "OverlayPolicy":
        """Fold the legacy EagerFlags knobs into an overlay policy; with
        every knob off (EagerFlags.all_off — the 'direct' baseline) the
        overlay is disabled outright and all reads hit the backend."""
        enabled = (flags.mock_stat or flags.readdir_prefetch
                   or flags.negative_stat_cache)
        return cls(enabled=enabled,
                   readdir_overlay=flags.readdir_prefetch,
                   mock_stat=flags.mock_stat,
                   negative_stat=flags.negative_stat_cache,
                   prefetch=flags.readdir_prefetch)


class _DirState:
    """One directory's delta: known-present children (name -> kind),
    known-absent names, and whether membership is complete.

    ``provisional`` completeness comes from an *unexecuted* mkdir's
    admit-time claim of a fresh empty directory.  Overlay reads may use
    it (the same intent-based approximation as the write-through stat
    cache, self-repairing at execution), but the bulk-remove pass must
    not: until the backend confirms the mkdir created the directory, a
    pre-existing directory with unknown contents is possible, and a fused
    ``remove_tree`` would silently delete data an unfused execution
    would have preserved behind ENOTEMPTY.

    ``speculative`` marks a completeness installed by the metadata
    prefetch pipeline (``install_speculative``) that no consumer has read
    yet — purely observability (``prefetch_hits``); the listing itself is
    executed backend truth, exactly like a sync readdir miss's."""

    __slots__ = ("children", "absent", "complete", "provisional",
                 "speculative")

    def __init__(self):
        self.children: dict[str, str | None] = {}
        self.absent: set[str] = set()
        self.complete = False
        self.provisional = False
        self.speculative = False


class SpeculationTicket:
    """One in-flight speculative listing's validity token.

    Registered by ``speculation_wanted`` when the prefetcher enqueues a
    directory; any racing *admitted* mutation that could make the fetched
    listing stale — rmdir/remove_tree/rename at or above the directory, a
    mkdir over it, an op failure invalidating it or its parent's
    membership, a transaction rollback — flips ``cancelled`` under the
    overlay lock, and ``install_speculative`` then refuses the listing.
    This is what keeps the prefetch pipeline *advisory*: a speculative
    read can warm the overlay only while nothing has moved underneath it,
    so observed semantics stay byte-identical to the unprefetched
    engine."""

    __slots__ = ("path", "cancelled")

    def __init__(self, path: str):
        self.path = path
        self.cancelled = False


class RemoveWitness:
    """Exec-time re-verification token for one fused bulk removal
    (ROADMAP item m).

    Registered by ``subtree_for_removal`` for every directory whose
    completeness was still *provisional* at fuse time (its mkdir admitted
    but not yet executed).  The overlay updates it as those mkdirs land:
    ``promote`` discards the dir from ``pending`` (created fresh — the
    claim holds), ``demote``/``invalidate`` set ``demoted`` (the dir
    pre-existed or its op failed: a fused unconditional removal could
    delete contents an unfused ENOTEMPTY would have preserved).  All
    mutation happens under the overlay's lock; the executor reads the
    verdict through ``resolve_witness``."""

    __slots__ = ("pending", "watched", "demoted")

    def __init__(self):
        self.pending: set[str] = set()   # dirs awaiting their mkdir's proof
        self.watched: set[str] = set()   # every dir ever registered (for
        #                                  watcher-list cleanup)
        self.demoted = False


class NamespaceOverlay:
    """Thread-safe directory-tree delta.  A leaf lock in the engine's
    lock order (nests under shard/op/control locks, holds no other)."""

    def __init__(self, policy: OverlayPolicy | None = None):
        self.policy = policy or OverlayPolicy()
        self._lock = threading.Lock()
        self._dirs: dict[str, _DirState] = {}
        # LRU over dirs whose completeness came from a cached backend
        # listing (insertion/refresh order = recency; see OverlayPolicy)
        self._listed: OrderedDict[str, None] = OrderedDict()
        # exec-time re-verification: provisional dir -> watching witnesses
        self._watchers: dict[str, list[RemoveWitness]] = {}
        # speculative prefetch tickets: path -> the (single) live ticket
        self._specs: dict[str, SpeculationTicket] = {}

    # ------------------------------------------------------------------
    # write side: mirror the op stream (called from submit's on_admit)
    # ------------------------------------------------------------------

    def _state(self, dirpath: str) -> _DirState:
        st = self._dirs.get(dirpath)
        if st is None:
            st = self._dirs[dirpath] = _DirState()
        return st

    # -- cached-listing LRU (all under self._lock) ---------------------

    def _touch_listing(self, path: str, *, cold: bool = False) -> None:
        """Mark a cached-listing dir most-recently-used — or, with
        ``cold``, least-recently-used — and evict past the policy bound.
        Eviction demotes completeness only: the membership delta (pending
        entries created/removed through the mount) stays.

        ``cold`` is the speculative-install recency: a prefetched listing
        enters at the LRU-cold end, so at capacity speculation evicts
        other speculation (or itself) and can never demote the hot
        in-use window; a dir already cached hot keeps its recency."""
        bound = self.policy.max_cached_listings
        if bound <= 0:
            return
        if cold:
            if path not in self._listed:
                self._listed[path] = None
                self._listed.move_to_end(path, last=False)
        else:
            self._listed[path] = None
            self._listed.move_to_end(path)
        while len(self._listed) > bound:
            victim, _ = self._listed.popitem(last=False)
            st = self._dirs.get(victim)
            if st is not None:
                st.complete = False
                st.provisional = False
                st.speculative = False

    def _drop_listed(self, path: str) -> None:
        self._listed.pop(path, None)

    def _demote_watchers_under(self, path: str) -> None:
        """A dir at/under ``path`` became unreliable: demote every fused
        removal whose proof rests on it."""
        for k, ws in self._watchers.items():
            if is_under(k, path):
                for w in ws:
                    w.demoted = True

    # -- speculative-prefetch tickets (all under self._lock) -----------

    def _cancel_specs_under(self, path: str) -> None:
        """A structural mutation at ``path``: every in-flight speculative
        listing at/under it would be stale on arrival — cancel them."""
        if not self._specs:
            return
        for k, t in self._specs.items():
            if is_under(k, path):
                t.cancelled = True

    def _cancel_spec_at(self, path: str) -> None:
        t = self._specs.get(path)
        if t is not None:
            t.cancelled = True

    def _add(self, dirpath: str, name: str, kind: str | None) -> None:
        st = self._state(dirpath)
        if name not in st.children:
            st.children[name] = kind
        elif st.children[name] is None and kind is not None:
            st.children[name] = kind   # first proven kind wins
        st.absent.discard(name)

    def _remove(self, dirpath: str, name: str) -> None:
        st = self._state(dirpath)
        st.children.pop(name, None)
        st.absent.add(name)

    @staticmethod
    def _split(path: str) -> tuple[str, str]:
        return parent_of(path), path.rsplit("/", 1)[-1]

    def on_op(self, kind: str, paths: tuple[str, ...], **kw) -> None:
        """Apply one admitted op's intended namespace effect."""
        with self._lock:
            if kind == "mkdir":
                p = paths[0]
                # a mkdir over a dir being speculatively listed changes
                # what the listing should say — the in-flight fetch loses
                self._cancel_spec_at(p)
                par, name = self._split(p)
                self._add(par, name, _DIR)
                # intended effect: a freshly created directory is empty,
                # hence complete — but only *provisionally* until the
                # mkdir executes (promote on success, demote on a
                # tolerant EEXIST, invalidate on error)
                st = self._state(p)
                if not st.complete:
                    st.complete = True
                    st.provisional = True
            elif kind in ("create", "write", "truncate"):
                par, name = self._split(paths[0])
                self._add(par, name, _FILE)
            elif kind == "symlink":
                par, name = self._split(paths[0])
                self._add(par, name, _LINK)
            elif kind == "link":
                par, name = self._split(paths[1] if len(paths) > 1
                                         else paths[0])
                self._add(par, name, _FILE)
            elif kind == "unlink":
                self._remove(*self._split(paths[0]))
            elif kind == "rmdir":
                p = paths[0]
                self._cancel_specs_under(p)
                self._remove(*self._split(p))
                self._dirs.pop(p, None)
                self._drop_listed(p)
            elif kind == "remove_tree":
                root = paths[0]
                self._cancel_specs_under(root)
                self._remove(*self._split(root))
                for k in [k for k in self._dirs if is_under(k, root)]:
                    del self._dirs[k]
                for k in [k for k in self._listed if is_under(k, root)]:
                    del self._listed[k]
            elif kind == "rename":
                src, dst = paths
                # in-flight listings anywhere under either endpoint would
                # land at paths that no longer mean the same directory
                self._cancel_specs_under(src)
                self._cancel_specs_under(dst)
                kind_src = None
                sp, sn = self._split(src)
                st = self._dirs.get(sp)
                if st is not None:
                    kind_src = st.children.get(sn)
                self._remove(sp, sn)
                # transfer the renamed subtree's dir states key-for-key
                moved_dir = False
                for k in [k for k in self._dirs if is_under(k, src)]:
                    self._dirs[dst + k[len(src):]] = self._dirs.pop(k)
                    moved_dir = moved_dir or k == src
                for k in [k for k in self._listed if is_under(k, src)]:
                    del self._listed[k]
                    self._listed[dst + k[len(src):]] = None
                dp, dn = self._split(dst)
                self._add(dp, dn, _DIR if moved_dir else kind_src)
            elif kind == "fallocate":
                # backends disagree on whether fallocate creates a missing
                # file (LocalBackend does, InMemory does not) — membership
                # under its parent is no longer provable, and a listing of
                # the parent already in flight must not re-prove it
                self._cancel_spec_at(parent_of(paths[0]))
                st = self._dirs.get(parent_of(paths[0]))
                if st is not None:
                    st.complete = False

    def _merge_listing_locked(self, path: str, listing) -> _DirState:
        """Merge a backend listing into ``path``'s base membership (names
        the overlay already has a delta for keep it — their ops are
        ordered around the listing and the listing agrees with every op
        ordered before it) and mark the dir complete."""
        st = self._state(path)
        for name, stt in listing:
            if name in st.children or name in st.absent:
                continue
            st.children[name] = (None if stt is None
                                 else _DIR if stt.is_dir
                                 else _LINK if stt.is_symlink
                                 else _FILE)
        st.complete = True
        st.provisional = False   # backend truth, not an intent claim
        return st

    def _removed_behind_locked(self, path: str) -> bool:
        """True when a rmdir/remove_tree/rename admitted after a listing
        of ``path`` was taken already popped the dir's state and marked
        it absent in its parent — installing the (older) listing would
        resurrect a complete overlay entry for a directory that no
        longer exists."""
        if not path:
            return False
        par, name = self._split(path)
        pst = self._dirs.get(par)
        return pst is not None and name in pst.absent

    def install_listing(self, path: str,
                        listing: list[tuple[str, StatResult | None]]) -> None:
        """Install a backend listing (from an executed readdir miss) as
        the directory's base membership, at hot LRU recency."""
        with self._lock:
            if self._removed_behind_locked(path):
                return
            self._merge_listing_locked(path, listing)
            self._touch_listing(path)

    # ------------------------------------------------------------------
    # speculative prefetch (core/prefetch.py rides these)
    # ------------------------------------------------------------------

    def speculation_wanted(self, path: str) -> SpeculationTicket | None:
        """Register intent to speculatively list ``path``; None when a
        fetch would be pointless (already complete, already being
        fetched, or pending removal/rename marked it absent)."""
        path = norm_path(path)
        if not self.policy.enabled:
            return None
        with self._lock:
            if path in self._specs:
                return None
            st = self._dirs.get(path)
            if st is not None and st.complete:
                return None
            if self._removed_behind_locked(path):
                return None
            t = SpeculationTicket(path)
            self._specs[path] = t
            return t

    def end_speculation(self, ticket: SpeculationTicket | None) -> None:
        """Unregister a ticket without installing (idempotent) — the
        fetch failed, was dropped, or its batch was cancelled."""
        if ticket is None:
            return
        with self._lock:
            if self._specs.get(ticket.path) is ticket:
                del self._specs[ticket.path]

    def install_speculative(self, ticket: SpeculationTicket,
                            listing, warm=None) -> str:
        """Install a speculatively fetched listing, atomically re-checking
        the ticket under the overlay lock.  ``warm`` (if given) runs
        *inside* the critical section on a successful install — the
        prefetcher warms the stat cache there, so a racing op-failure
        invalidation (which takes this lock first, then clears the stat
        cache) can never lose to a late warming write.  Returns the
        verdict:

        * ``"installed"`` — the listing is now the dir's base membership,
          inserted at LRU-*cold* recency (it can never evict the hot
          in-use window; see ``_touch_listing``);
        * ``"cancelled"`` — a racing admitted mutation invalidated the
          fetch (the prefetcher counts it, nothing was installed);
        * ``"stale"``     — the dir was already complete (a sync miss beat
          the speculation) or a pending removal marked it absent;
        * ``"evicted"``   — installed but immediately evicted by the
          cached-listings bound (the cache is full of hotter entries)."""
        path = ticket.path
        with self._lock:
            if self._specs.get(path) is ticket:
                del self._specs[path]
            if ticket.cancelled:
                return "cancelled"
            if self._removed_behind_locked(path):
                return "stale"
            st = self._dirs.get(path)
            if st is not None and st.complete:
                return "stale"
            st = self._merge_listing_locked(path, listing)
            st.speculative = True
            if warm is not None:
                warm()
            self._touch_listing(path, cold=True)
            if not st.complete:
                st.speculative = False
                return "evicted"
            return "installed"

    def was_speculative(self, path: str) -> bool:
        """True exactly once per consumed speculative listing: the first
        overlay read answered from it clears the flag (prefetch_hits)."""
        with self._lock:
            st = self._dirs.get(path)
            if st is not None and st.speculative:
                st.speculative = False
                return True
            return False

    # ------------------------------------------------------------------
    # read side
    # ------------------------------------------------------------------

    def readdir(self, path: str) -> list[str] | None:
        """The directory's full listing, or None when membership is not
        fully determined by pending state + cached listings (a miss: the
        caller must take the sync, sealing path)."""
        with self._lock:
            st = self._dirs.get(path)
            if st is None or not st.complete:
                return None
            if path in self._listed:
                self._touch_listing(path)   # LRU recency on cache hits
            return sorted(st.children)

    def listing_kinds(self, path: str) -> tuple[list[str], list[str]] | None:
        """(subdir names, file/link names) of a complete directory with
        every child's kind proven, or None (the walk fast path falls back
        to readdir + per-entry stat for this directory only)."""
        with self._lock:
            st = self._dirs.get(path)
            if st is None or not st.complete:
                return None
            dirs: list[str] = []
            files: list[str] = []
            for name in sorted(st.children):
                kind = st.children[name]
                if kind is None:
                    return None
                (dirs if kind == _DIR else files).append(name)
            if path in self._listed:
                self._touch_listing(path)
            return dirs, files

    def lookup(self, path: str) -> bool | None:
        """Presence of ``path``: True/False when provable, None otherwise.
        False needs either an explicit absence delta (unlinked/removed in
        the window) or a complete parent that does not list the name."""
        path = norm_path(path)
        if not path:
            return True
        with self._lock:
            par, name = self._split(path)
            st = self._dirs.get(par)
            if st is None:
                return None
            if name in st.children:
                return True
            if name in st.absent or st.complete:
                return False
            return None

    def subtree_for_removal(self, root: str, *, allow_provisional: bool
                            ) -> tuple[list[str], list[str],
                                       "RemoveWitness | None"] | None:
        """(files, dirs, witness) of *present* entries under ``root`` for
        the bulk-remove pass, or None when any reachable directory is
        incomplete or any kind unproven — the pass may only fire on an
        overlay-proven tree, because a fused remove_tree deletes
        unconditionally where an unfused rmdir would have failed
        ENOTEMPTY.

        Without ``allow_provisional`` a directory whose completeness is
        still an unexecuted mkdir's admit-time claim also returns None.
        With it, the scan tolerates such directories and returns a
        ``RemoveWitness`` watching them (registered atomically with the
        scan, so a promote/demote racing the fuse decision is never
        lost).  The witness is None when the whole tree was already
        backend-proven.  The caller must either attach the witness to the
        fused op (released by the engine at completion) or hand it back
        via ``release_witness`` when it declines to fuse."""
        with self._lock:
            prov: list[str] = []
            sub = self._subtree(root, prov if allow_provisional else None)
            if sub is None:
                return None
            files, dirs = sub
            if not prov:
                return files, dirs, None
            w = RemoveWitness()
            w.pending.update(prov)
            w.watched.update(prov)
            for d in prov:
                self._watchers.setdefault(d, []).append(w)
            return files, dirs, w

    def _subtree(self, root, provisional_out):
        """``provisional_out`` is None for strict (backend-proven only)
        scans, or a list collecting the provisional dirs encountered."""
        st = self._dirs.get(root)
        if st is None or not st.complete:
            return None
        if st.provisional:
            if provisional_out is None:
                return None
            provisional_out.append(root)
        files: list[str] = []
        dirs: list[str] = []
        for name, kind in st.children.items():
            p = f"{root}/{name}" if root else name
            if kind == _DIR:
                sub = self._subtree(p, provisional_out)
                if sub is None:
                    return None
                dirs.append(p)
                files.extend(sub[0])
                dirs.extend(sub[1])
            elif kind is None:
                return None
            else:
                files.append(p)
        return files, dirs

    # ------------------------------------------------------------------
    # exec-time re-verification witnesses (the bulk-remove pass under
    # provisional dirs: fusion.BulkRemovePayload carries one of these)
    # ------------------------------------------------------------------

    def merge_witness(self, parent: RemoveWitness | None,
                      child: RemoveWitness) -> RemoveWitness:
        """A parent fused removal absorbs a child's: the parent inherits
        every directory the child is still waiting on (and its verdict so
        far), so the rolled-up op re-verifies the whole subtree."""
        with self._lock:
            if parent is None:
                parent = RemoveWitness()
            parent.demoted = parent.demoted or child.demoted
            for d in child.pending:
                if d not in parent.watched:
                    parent.watched.add(d)
                    self._watchers.setdefault(d, []).append(parent)
                parent.pending.add(d)
            return parent

    def resolve_witness(self, w: RemoveWitness) -> str:
        """The exec-time verdict: ``"promoted"`` (every watched mkdir
        created its dir fresh — run the vectored removal), ``"demoted"``
        (any demotion/invalidation, or a mkdir somehow still unproven —
        take the byte-identical per-entry fallback), or ``"clean"`` (the
        witness never watched anything)."""
        with self._lock:
            if w.demoted or w.pending:
                return "demoted"
            return "promoted" if w.watched else "clean"

    def release_witness(self, w: RemoveWitness | None) -> None:
        """Unregister a witness from every watcher list (idempotent)."""
        if w is None:
            return
        with self._lock:
            for d in w.watched:
                lst = self._watchers.get(d)
                if lst is None:
                    continue
                try:
                    lst.remove(w)
                except ValueError:
                    pass
                if not lst:
                    del self._watchers[d]
            w.watched.clear()

    # ------------------------------------------------------------------
    # invalidation
    # ------------------------------------------------------------------

    def invalidate(self, path: str) -> None:
        """A background op on ``path`` failed (or was cancelled): every
        claim the overlay made about it is suspect.  Drop its membership
        entry, demote its parent's completeness, forget the state of any
        directory at or under it, and demote every fused removal whose
        re-verification watches a directory in that subtree."""
        path = norm_path(path)
        with self._lock:
            # a failed op's effects are unknown (a torn write may have
            # created the file after all): an in-flight listing of the
            # parent fetched before the failure must not re-prove its
            # membership, and nothing under the path can be trusted
            self._cancel_specs_under(path)
            if path:
                self._cancel_spec_at(parent_of(path))
                par, name = self._split(path)
                st = self._dirs.get(par)
                if st is not None:
                    st.children.pop(name, None)
                    st.absent.discard(name)
                    st.complete = False
            for k in [k for k in self._dirs if is_under(k, path)]:
                del self._dirs[k]
            for k in [k for k in self._listed if is_under(k, path)]:
                del self._listed[k]
            self._demote_watchers_under(path)

    def demote(self, path: str) -> None:
        """Keep the membership delta but drop completeness (a tolerant
        mkdir found the directory pre-existing: its base contents are
        unknown, the deltas recorded so far are still valid).  Any fused
        removal watching this directory loses its proof."""
        path = norm_path(path)
        with self._lock:
            self._cancel_spec_at(path)
            st = self._dirs.get(path)
            if st is not None:
                st.complete = False
                st.provisional = False
                st.speculative = False
            for w in self._watchers.get(path, ()):
                w.demoted = True

    def promote(self, path: str) -> None:
        """An executed mkdir confirmed it created ``path`` fresh: its
        provisional admit-time completeness is now backend-proven, and
        any fused removal watching the directory checks it off.  A state
        popped in the meantime (a rmdir admitted while the mkdir was
        pending) is deliberately NOT resurrected — but the witnesses are
        still settled: the fused removal that popped it is exactly the op
        waiting on this proof."""
        path = norm_path(path)
        with self._lock:
            st = self._dirs.get(path)
            if st is not None and st.complete:
                st.provisional = False
            for w in self._watchers.get(path, ()):
                w.pending.discard(path)

    def delta_summary(self) -> dict:
        """Snapshot of the membership delta this overlay is holding: how
        many directories are tracked, how many of those carry a full
        (complete) listing vs. a provisional or speculative one, and the
        totals of known-present children and known-absent names.  This is
        the view the durability layer reports after a resume reinstalls
        the delta from the spill journal (a resumed mount should show the
        same counts as the preempted one for the replayed prefix) — and a
        cheap invariant hook for tests that don't want to poke _dirs."""
        with self._lock:
            dirs = len(self._dirs)
            complete = provisional = speculative = 0
            children = absent = 0
            for st in self._dirs.values():
                if st.complete:
                    complete += 1
                if st.provisional:
                    provisional += 1
                if st.speculative:
                    speculative += 1
                children += len(st.children)
                absent += len(st.absent)
            return {
                "dirs": dirs,
                "complete": complete,
                "provisional": provisional,
                "speculative": speculative,
                "children": children,
                "absent": absent,
            }

    def clear(self) -> None:
        with self._lock:
            self._dirs.clear()
            self._listed.clear()
            # rollback mutates the backend behind the engine: no pending
            # fused removal may keep trusting its pre-rollback proof
            for ws in self._watchers.values():
                for w in ws:
                    w.demoted = True
            self._watchers.clear()
            # ...and no speculative listing fetched before the window
            # closed may install afterwards
            for t in self._specs.values():
                t.cancelled = True
            self._specs.clear()

    def clear_under(self, prefix: str) -> None:
        """Tenant-scoped window close (PR 10): drop every claim at or
        under ``prefix`` — directory states, cached listings, fused-
        removal proofs and in-flight speculative fetches — while claims
        about the rest of the namespace (the neighbour tenants' open
        optimization windows) stand untouched.  The prefix's own parent
        loses the child's membership claim too: a rollback may have
        removed the subtree's root itself."""
        prefix = norm_path(prefix)
        if not prefix:
            self.clear()
            return
        with self._lock:
            self._cancel_specs_under(prefix)
            self._cancel_spec_at(parent_of(prefix))
            par, name = self._split(prefix)
            st = self._dirs.get(par)
            if st is not None:
                # membership of the scoped root in its (shared) parent is
                # no longer proven either way
                st.children.pop(name, None)
                st.absent.discard(name)
                st.complete = False
            for k in [k for k in self._dirs if is_under(k, prefix)]:
                del self._dirs[k]
            for k in [k for k in self._listed if is_under(k, prefix)]:
                del self._listed[k]
            self._demote_watchers_under(prefix)


__all__ = ["NamespaceOverlay", "OverlayPolicy", "RemoveWitness",
           "SpeculationTicket"]
