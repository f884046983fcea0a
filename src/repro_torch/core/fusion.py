"""Optimizer layer: the transactional op-fusion pass.

The paper's thesis is that batch I/O is a transaction whose only
observation points are reads, barriers and commit.  Between observation
points the pending op stream is therefore not just deferrable — it is
*rewritable*: the engine may coalesce, fold and delete pending ops as long
as commit-visible state is unchanged.  This module implements that pass as
peephole rules over each path's pending chain:

* **coalesce** — adjacent ``write_at`` ops on one path merge into a single
  vectored ``write_vec`` backend call (contiguous segments concatenate
  without copying until execution);
* **fold** — adjacent same-kind ``chmod``/``utimens``/``truncate`` ops
  collapse to last-wins (only the final value is observable at commit);
* **elide** — a ``create``+``write``(+metadata) chain whose path is
  unlinked inside the same unobserved window never touches the backend at
  all (the extract-then-rmtree workload); the trailing unlink becomes
  tolerant of the file's absence so the stream stays error-free;
* **rename retarget** (cost-gated) — on storage where rename is a
  server-side copy+delete (object stores), a rename whose source's whole
  backend lifetime is still pending (create+write+metadata chain, all
  unexecuted) is rewritten to *build the file at the destination
  instead*: the source chain is captured atomically
  (``OpScheduler.capture_chain``) and its payloads replayed at the
  destination path, so the expensive copy+delete never happens.  The
  rule arms itself from the backend's ``cost_hint`` (``retarget_renames
  = "auto"``): it fires only when a rename costs at least
  ``rename_cost_ratio`` times a create, so POSIX-shaped media with a
  one-roundtrip rename are never rewritten;
* **bulk remove** (cross-path, keyed by directory prefix) — when an
  ``rmdir`` arrives and the namespace overlay proves its whole subtree is
  known *and* ends empty after the pending removals, those pending
  unlinks/rmdirs/child-``remove_tree``s are elided and replaced by ONE
  vectored ``remove_tree`` backend call on the common root.  Collapses
  roll up: leaf directories fuse first, parents then absorb their
  children's fused removals, so a readdir-driven ``rmtree`` converges to
  a single backend op for the whole tree.  Subtrees resting on
  *provisional* directories (mkdir admitted, not yet executed) fuse too:
  the fused op carries a ``RemoveWitness`` and re-verifies the claim at
  execution time, falling back per-entry byte-identically when a mkdir
  was demoted (``FusionPolicy.reverify_provisional``).

Safety comes from the scheduler's per-op flags: fusion only ever mutates
the pending *tip* op of a path while it is unclaimed (no executor owns
it), unsealed (no observation point waits on it) and in the same
transaction region (so a fused failure is attributed to exactly one
region's ledger scope).  Fault semantics are defined per *fused* backend
call: one ``write_vec`` of N coalesced writes is a single match for a
``FaultRule``, and a short (torn) outcome tears the fused op as a unit —
see ``faults.FaultInjectingBackend.write_vec``.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass

from .backend import is_under

# op kinds whose effects on a path are invisible at commit once the path
# is unlinked in the same unobserved window
ELIDABLE_KINDS = frozenset({
    "create", "write", "chmod", "utimens", "truncate", "fallocate",
    "setxattr",
})

# pending removal ops a bulk remove_tree on an ancestor subsumes: their
# whole duty transfers to the fused call, so they can leave the stream
REMOVAL_KINDS = frozenset({"unlink", "rmdir", "remove_tree"})

# pending ops the rename-retarget rule can replay at the destination:
# their payloads (WritePayload / MetaPayload / the bare create) carry the
# full arguments.  fallocate/setxattr are elidable-on-unlink but their
# submitted fns close over their args with no payload — not replayable.
RETARGET_KINDS = frozenset({"create", "write", "chmod", "utimens",
                            "truncate"})


@dataclass(frozen=True)
class FusionPolicy:
    """Which peephole rules run, and the coalescing bounds.

    ``max_segments``/``max_bytes`` cap one fused op's payload so a writer
    streaming into a single file still rotates ops (and re-enters the
    engine's in-flight budget) instead of growing one op without bound.

    With ``adaptive_max_bytes`` on and a backend that measures its own
    bandwidth-delay product (``LatencyBackend.bdp_bytes``), the effective
    write-coalescing cap is ``bdp_multiplier`` x BDP instead of the fixed
    ``max_bytes`` — one fused op is sized to keep the pipe full for about
    two round trips, no larger.  The policy bounds always win: the
    adaptive value is clamped to [``min_adaptive_bytes``, ``max_bytes``].
    Bulk-remove batching is clamped the same way (a fused ``remove_tree``
    covers at most ``bdp_multiplier`` x BDP worth of directory entries at
    ~256 bytes each, within [``min_remove_entries``,
    ``max_remove_entries``]).

    ``reverify_provisional`` lets the bulk-remove pass fuse under
    *provisional* directories (mkdir admitted, not yet executed); the
    fused op then re-verifies the overlay claim at execution time and
    falls back to per-entry removal byte-identically when any mkdir was
    demoted (see ``namespace.RemoveWitness``)."""

    enabled: bool = True
    coalesce_writes: bool = True
    fold_metadata: bool = True
    elide_unlinked: bool = True
    bulk_remove: bool = True     # cross-path unlink/rmdir -> remove_tree
    max_segments: int = 128
    max_bytes: int = 32 << 20
    # -- adaptive bandwidth-delay sizing (ROADMAP i) --
    adaptive_max_bytes: bool = True
    bdp_multiplier: float = 2.0
    min_adaptive_bytes: int = 64 << 10
    # -- bulk-remove batching bounds --
    max_remove_entries: int = 1 << 20
    min_remove_entries: int = 4096
    # -- exec-time re-verification for provisional subtrees (ROADMAP m) --
    reverify_provisional: bool = True
    # -- rule 5: cost-gated rename retarget (ROADMAP r) --
    # "auto": fire iff cost_hint says rename >= rename_cost_ratio x create
    # (object stores: copy+delete, ratio ~2 -> fires; POSIX media: ~1 ->
    # never).  True/False force the rule on/off regardless of cost.
    retarget_renames: object = "auto"
    rename_cost_ratio: float = 1.5

    @classmethod
    def off(cls) -> "FusionPolicy":
        return cls(enabled=False)


class WritePayload:
    """Segments of one (possibly fused) write op.

    Contiguous appends extend the previous segment as a chunk list —
    concatenation is deferred to ``segments()`` at execution time, so the
    hot ACK path never copies payload bytes.  Mutated only under the
    owning op's ``flock`` (scheduler guarantee); frozen once claimed."""

    __slots__ = ("_segs", "nbytes")

    def __init__(self, offset: int, data: bytes):
        self._segs: list[list] = [[offset, [data], len(data)]]
        self.nbytes = len(data)

    def add(self, offset: int, data: bytes) -> None:
        last = self._segs[-1]
        if offset == last[0] + last[2]:
            last[1].append(data)
            last[2] += len(data)
        else:
            self._segs.append([offset, [data], len(data)])
        self.nbytes += len(data)

    @property
    def n_segments(self) -> int:
        return len(self._segs)

    def segments(self) -> list[tuple[int, bytes]]:
        return [(off, chunks[0] if len(chunks) == 1 else b"".join(chunks))
                for off, chunks, _ in self._segs]


class MetaPayload:
    """Arguments of one foldable metadata op (chmod/utimens/truncate);
    last-wins replacement under the owning op's flock."""

    __slots__ = ("args",)

    def __init__(self, args: tuple):
        self.args = args


class BulkRemovePayload:
    """One fused cross-path removal: the root, the covered paths (the
    fused op's co-paths — dependency edges and error-invalidation scope),
    the per-entry manifest for the demoted fallback, and the overlay
    witness that re-verifies provisional directories at execution time.

    ``witness`` is None when the subtree was fully backend-proven at fuse
    time (the PR 3 case) — the fused ``remove_tree`` runs unconditionally.
    Otherwise the executor asks the overlay whether every watched mkdir
    was *promoted* (created its directory fresh): promoted -> the single
    vectored ``remove_tree``; demoted -> a byte-identical per-entry
    fallback over ``entries`` (children before parents, absence-tolerant,
    ENOTEMPTY propagating exactly as the unfused rmdir would have)."""

    __slots__ = ("root", "covered", "entries", "witness")

    def __init__(self, root: str, covered: list[str],
                 entries: dict[str, bool], witness):
        self.root = root
        self.covered = covered              # sorted co-paths of the op
        self.entries = entries              # path -> is_dir
        self.witness = witness              # namespace.RemoveWitness | None

    def fallback_order(self) -> list[tuple[str, bool]]:
        """Entries deepest-first so children go before their parents."""
        return sorted(self.entries.items(),
                      key=lambda kv: (-kv[0].count("/"), kv[0]))


class Fuser:
    """The peephole pass.  Stateless apart from its counters; the
    scheduler provides the locking context (``fuse_tip``/``elide_chain``).

    ``cost_source`` is the backend's CostModel entry point
    (``StorageBackend.cost_hint`` — may return None) and is the preferred
    sizing signal: each clamp asks for its own op *class* ("write",
    "remove_tree", "rename"), so a backend whose rename is structurally
    expensive sizes rename elision differently from write coalescing.
    ``bdp_source`` is the older single-number probe
    (``LatencyBackend.bdp_bytes``), kept as the fallback for backends
    predating the protocol."""

    def __init__(self, policy: FusionPolicy, stats, bdp_source=None,
                 cost_source=None):
        self.policy = policy
        self.stats = stats
        self._bdp = bdp_source
        self._cost = cost_source
        self._slock = threading.Lock()   # exact counters across shards

    # -- adaptive cost-model sizing ------------------------------------

    def _bdp_for(self, op: str):
        """Bandwidth-delay product for one op class: the cost hint when
        the backend has one, else the legacy scalar probe, else None."""
        if self._cost is not None:
            hint = self._cost(op, 0)
            if hint is not None:
                return hint.bdp_bytes()
        if self._bdp is not None:
            return self._bdp()
        return None

    def effective_max_bytes(self) -> int:
        """The write-coalescing byte cap for one fused op: ~2x the
        measured BDP, clamped so the policy bounds always win."""
        pol = self.policy
        if not pol.adaptive_max_bytes:
            return pol.max_bytes
        bdp = self._bdp_for("write")
        if not bdp:
            return pol.max_bytes
        eff = max(pol.min_adaptive_bytes,
                  min(int(pol.bdp_multiplier * bdp), pol.max_bytes))
        self.stats.adaptive_max_bytes = eff   # latest clamp, observability
        return eff

    def effective_remove_entries(self) -> int:
        """How many directory entries one fused ``remove_tree`` may cover:
        ~2x BDP worth of ~256-byte dirents, within the policy bounds."""
        pol = self.policy
        if not pol.adaptive_max_bytes:
            return pol.max_remove_entries
        bdp = self._bdp_for("remove_tree")
        if not bdp:
            return pol.max_remove_entries
        return max(pol.min_remove_entries,
                   min(int(pol.bdp_multiplier * bdp / 256),
                       pol.max_remove_entries))

    # -- rule 1: write coalescing --------------------------------------

    def absorb_write(self, sched, path: str, offset: int, data: bytes,
                     region: object, on_absorb=None) -> bool:
        """``on_absorb`` runs under the op's lock on success — the engine
        updates its write-through stat cache there, so a fast-failing
        fused op's error-path invalidation (at completion, strictly after
        the lock is released) always wins over the mocked entry."""
        pol = self.policy
        if not (pol.enabled and pol.coalesce_writes):
            return False

        def attempt(op) -> bool:
            pl = op.payload
            if (op.kind != "write" or not isinstance(pl, WritePayload)
                    or op.region is not region):
                return False
            if (pl.n_segments >= pol.max_segments
                    or pl.nbytes + len(data) > self.effective_max_bytes()):
                return False
            pl.add(offset, data)
            with self._slock:
                self.stats.fused_writes += 1
            if on_absorb is not None:
                on_absorb()
            return True

        return sched.fuse_tip(path, attempt)

    # -- rule 2: metadata folding --------------------------------------

    def absorb_meta(self, sched, kind: str, path: str, args: tuple,
                    region: object, on_absorb=None) -> bool:
        if not (self.policy.enabled and self.policy.fold_metadata):
            return False

        def attempt(op) -> bool:
            pl = op.payload
            if (op.kind != kind or not isinstance(pl, MetaPayload)
                    or op.region is not region):
                return False
            # truncate is only last-wins when it keeps shrinking: a shrink
            # followed by a grow zero-pads the cut region, which the grow
            # alone would not (chmod/utimens are pure last-wins)
            if kind == "truncate" and args[0] > pl.args[0]:
                return False
            pl.args = args
            with self._slock:
                self.stats.folded_meta += 1
            if on_absorb is not None:
                on_absorb()
            return True

        return sched.fuse_tip(path, attempt)

    # -- rule 3: unlink elision ----------------------------------------

    def elide_for_unlink(self, sched, path: str, region: object) -> bool:
        """Remove the pending create/write/metadata chain on ``path`` from
        the op stream ahead of its unlink.  Returns True iff anything was
        elided — the caller must then make the unlink tolerant of the
        file's absence (the create that would have produced it is gone,
        and an implicit-create write may be gone too)."""
        if not (self.policy.enabled and self.policy.elide_unlinked):
            return False

        def eligible(op) -> bool:
            return op.kind in ELIDABLE_KINDS and op.region is region

        elided = sched.elide_chain(path, eligible)
        if not elided:
            return False
        dropped = sum(op.payload.nbytes for op in elided
                      if isinstance(op.payload, WritePayload))
        with self._slock:
            self.stats.elided_ops += len(elided)
            self.stats.bytes_elided += dropped
        return True

    # -- rule 4: cross-path bulk remove --------------------------------

    def prepare_bulk_remove(self, sched, overlay, root: str,
                            region: object) -> BulkRemovePayload | None:
        """Collapse the pending removals under ``root`` into one vectored
        ``remove_tree`` backend call.

        Fires only when the namespace overlay proves the subtree: every
        reachable directory's membership is overlay-known, and no entry is
        still *present* (present entries carry no pending removal — an
        admitted unlink/rmdir marks its path absent immediately — so a
        present entry means the rmdir would correctly fail ENOTEMPTY and
        must not be rewritten).  Same-region pending unlink/rmdir/child-
        remove_tree ops directly under the known directories are elided —
        their removal duty transfers to the fused call; ineligible ones
        (sealed, claimed, another region's) simply run first, ordered by
        the fused op's dependency edges, and the tolerant ``remove_tree``
        mops up what remains.

        With ``reverify_provisional`` the proof may rest on *provisional*
        directories — mkdirs admitted but not yet executed (the
        extract-then-rmtree-in-one-breath shape).  The overlay then hands
        back a ``RemoveWitness`` watching those mkdirs; the fused op's DAG
        edges already order it after every one of them, so by execution
        time each has been promoted (created fresh) or demoted
        (pre-existing / failed) and the executor picks the vectored call
        or the byte-identical per-entry fallback accordingly.  A child
        fused removal absorbed by this one donates its witness: the
        parent inherits every still-unproven directory underneath.

        Returns the fused op's ``BulkRemovePayload`` (covered paths give
        it its dependency edges and error-invalidation scope), or None
        when the per-entry path must be taken."""
        pol = self.policy
        if not (pol.enabled and pol.bulk_remove):
            return None
        sub = overlay.subtree_for_removal(
            root, allow_provisional=pol.reverify_provisional)
        if sub is None:
            return None
        files, dirs, witness = sub

        def decline():
            if witness is not None:
                overlay.release_witness(witness)
            return None

        if files:
            return decline()  # will not be empty: plain rmdir reports it
        covered: set[str] = set()
        entries: dict[str, bool] = {}    # path -> is_dir, for the fallback
        candidates: dict[int, object] = {}
        for d in (root, *dirs):
            for op in sched.pending_structural_children(d):
                if op.kind not in REMOVAL_KINDS or id(op) in candidates:
                    continue
                if not all(p != root and is_under(p, root)
                           for p in op.paths):
                    continue
                candidates[id(op)] = op
                covered.update(op.paths)
                if op.kind == "unlink":
                    entries.setdefault(op.paths[0], False)
                elif op.kind == "rmdir":
                    entries[op.paths[0]] = True
                else:   # a child fused remove_tree: absorb its manifest
                    pl = op.payload
                    if isinstance(pl, BulkRemovePayload):
                        entries.update(pl.entries)
                        entries[pl.root] = True
                        if pl.witness is not None:
                            witness = overlay.merge_witness(witness,
                                                            pl.witness)
                    else:
                        entries[op.paths[0]] = True
        if dirs and not set(dirs) <= covered:
            return decline()  # a present dir with no pending removal
        if len(covered) > self.effective_remove_entries():
            return decline()  # batch larger than the adaptive clamp allows
        elided = 0
        for op in candidates.values():
            with op.flock:
                if (op.completed or op.claimed or op.sealed or op.cancelled
                        or op.elided or op.region is not region):
                    continue
                op.elided = True
                elided += 1
        if not elided:
            return decline()  # nothing rewritable: plain rmdir is as good
        with self._slock:
            self.stats.bulk_removes += 1
            self.stats.elided_ops += elided
        return BulkRemovePayload(root, sorted(covered), entries, witness)

    # -- rule 5: cost-gated rename retarget ----------------------------

    def rename_retarget_wanted(self) -> bool:
        """Is the retarget rule armed?  ``retarget_renames=True`` forces
        it, False disables it; the default ``"auto"`` consults the cost
        model: fire only when a rename round-trip genuinely costs at
        least ``rename_cost_ratio`` times a create (copy+delete media)."""
        pol = self.policy
        if not (pol.enabled and pol.elide_unlinked):
            return False
        if pol.retarget_renames is True:
            return True
        if pol.retarget_renames != "auto":
            return False
        if self._cost is None:
            return False
        rename = self._cost("rename", 0)
        create = self._cost("create", 0)
        if rename is None or create is None:
            return False
        base = create.cost_s() or 1e-9
        return rename.cost_s() >= pol.rename_cost_ratio * base

    def capture_for_rename(self, sched, path: str,
                           region: object) -> list | None:
        """Capture the source path's entire pending chain for a rename
        retarget: every pending op must be elidable and same-region, and
        the chain must bottom at the pending ``create`` (the file's whole
        backend lifetime is still unexecuted — nothing exists at the
        source for a backend rename to move).  All-or-nothing via
        ``OpScheduler.capture_chain``: on success the ops are already
        marked elided and returned oldest-first for the caller to replay
        at the destination; on any ineligible op nothing is touched and
        the plain backend rename proceeds."""
        def eligible(op) -> bool:
            return op.kind in RETARGET_KINDS and op.region is region

        chain = sched.capture_chain(path, eligible, anchor_kind="create")
        if not chain:
            return None
        with self._slock:
            self.stats.renames_retargeted += 1
            self.stats.elided_ops += len(chain)
        return chain
