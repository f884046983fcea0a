"""Durable optimization window: the transaction spill journal (PR 9).

The paper's whole premise is that an HPC job's I/O is one transaction
whose failure "will frequently warrant the resubmission of a full job" —
but a *preempted* job loses its entire optimization window (the region
journal and the namespace-overlay delta are memory-only) and must redo
every backend op from scratch, which is exactly the resubmission cost
CannyFS exists to hide.  This module makes the window itself durable:

* ``SpillManager`` incrementally persists the transaction's region
  journal (created paths → rollback scope) and the engine's op outcomes
  (admit / done / fail per op, with per-segment checksums for writes)
  into an append-only, checksummed, epoch-stamped record log on the
  *same* backend, following the checkpoint manager's COMMIT-marker
  discipline: records buffer in memory, flush in chunks that ride the
  scheduler's LOW-PRIORITY speculative lane (durability never serializes
  the hot path), and a **cut** at every ``barrier``/observation seal
  forces the outstanding chunks down and stamps the marker.  The log is
  monotone-prefix safe: offsets are reserved at chunking time, a reader
  stops at the first gap or corrupt line, and a later cut heals an
  earlier chunk whose speculative write was dropped.

* ``CannyFS.resume(spill_dir)`` (see ``fs.py``) re-proves the window on
  a fresh mount after a kill: ``load`` parses the log into a
  ``SpillImage`` (journal, durable op outcomes, uncertain in-flight
  ops), ``repair`` resolves the uncertainty directly against the
  backend (torn COPY+DELETE renames are merge-moved, a partially
  applied bulk DELETE is re-issued, landed-but-unjournaled creates
  whose probe record proves pre-op absence are journaled so rollback
  can never leak them), and the proven delta is
  replayed into the stat cache and namespace overlay without re-walking
  the tree.  The re-executed job body then consults the image: ops
  provably durable are **elided** (mkdir/unlink/metadata) or
  **diverted** (create+write streams buffer locally and are verified
  against the recorded segment checksums at close — a mismatch falls
  back to a plain rewrite), so a resumed job redoes only the ops that
  were genuinely in flight at the kill.

Epoch discipline: every transaction attempt is one epoch.  ``begin``
opens it, ``committed`` (followed by unlinking the log) closes it, and
rollback advances the epoch without a marker — the parser keeps only the
*last* epoch opened, so records from an abandoned attempt can never
resurrect rolled-back state.

Tenancy (PR 10): a ``Tenant`` arms its own ``SpillManager`` on a
distinct ``spill_dir`` via ``Tenant._arm_spill`` — the manager lands in
the tenant's scheduler-side slot (``_TenantState.spill``), not the
engine-global ``engine.spill``, so each tenant's window journals, cuts
and resumes independently: ``Tenant.resume(spill_dir)`` re-proves ONE
tenant's window on the live shared engine (replaying only its own
prefix-scoped events) while every neighbour's window stays open.  The
fs layer reaches the right manager through the ``CannyFS._spill()``
hook; both commit AND rollback must route through it — a tenant
rollback that missed its spill's ``on_rollback`` tombstone would leave
durable claims that wrongly elide re-creates of rolled-back files.

Nothing here imports the engine or fs layers; the manager holds a
reference to its engine and duck-types the payloads, so the module sits
beside ``faults.py`` at the bottom of the core dependency graph.
"""
from __future__ import annotations

import json
import threading
import zlib
from typing import Any, Optional

from .backend import is_under, norm_path

# op kinds worth spilling: everything that mutates the backend namespace
# or data.  Reads/stats prove nothing durable and are never recorded.
SPILL_KINDS = frozenset({
    "mkdir", "create", "write", "unlink", "rmdir", "rename", "symlink",
    "link", "truncate", "fallocate", "chmod", "chown", "utimens",
    "setxattr", "removexattr", "remove_tree",
})

REMOVAL_KINDS = frozenset({"unlink", "rmdir", "remove_tree"})

# metadata ops a resumed run may elide when the recorded last-wins
# arguments match the re-executed call exactly
META_KINDS = frozenset({"chmod", "chown", "utimens", "truncate",
                        "setxattr", "removexattr", "fallocate"})

JOURNAL_FILE = "journal.log"
CUT_FILE = "CUT"


def commit_marker_ok(data: bytes, expected: int) -> bool:
    """The COMMIT-marker validation shared with the checkpoint manager:
    a marker is proof only when its *content* names the expected step —
    an empty or garbage marker (crash between create and write) is not a
    commit."""
    try:
        return int(data.decode()) == expected
    except (ValueError, UnicodeDecodeError):
        return False


# ---------------------------------------------------------------------------
# record codec: one JSON object + crc32 per line, corruption-evident
# ---------------------------------------------------------------------------

def _enc(rec: dict) -> bytes:
    body = json.dumps(rec, sort_keys=True, separators=(",", ":"))
    crc = zlib.crc32(body.encode("utf-8")) & 0xFFFFFFFF
    return f"{body}|{crc:08x}\n".encode("utf-8")


def _dec(line: bytes) -> Optional[dict]:
    try:
        text = line.decode("utf-8")
        body, sep, crc_hex = text.rpartition("|")
        if not sep or len(crc_hex) != 8:
            return None
        if zlib.crc32(body.encode("utf-8")) & 0xFFFFFFFF != int(crc_hex, 16):
            return None
        rec = json.loads(body)
        return rec if isinstance(rec, dict) else None
    except (ValueError, UnicodeDecodeError):
        return None


def _replay_kw(kind: str, rec: dict) -> dict:
    """cache_kw-shaped view of a done record, for stat-cache/overlay
    replay at resume."""
    if kind == "write":
        segs = rec.get("segs") or []
        return {"offset": 0,
                "nbytes": max((o + n for o, n, _ in segs), default=0)}
    if kind in ("truncate", "fallocate"):
        args = rec.get("args") or [0]
        return {"size": args[0]}
    if kind == "chmod":
        args = rec.get("args") or [0]
        return {"mode": args[0]}
    return {}


def _assemble(buf: list[tuple[int, bytes]]) -> bytes:
    """Materialize a diverted write stream (offset, data) into the file
    content it would produce (later writes win, holes zero-fill — the
    backends' write_at semantics)."""
    end = max((off + len(d) for off, d in buf), default=0)
    out = bytearray(end)
    for off, d in buf:
        out[off:off + len(d)] = d
    return bytes(out)


def _verify(content: bytes, segs: list) -> bool:
    """Does the recorded durable segment set prove ``content`` is already
    on the backend?  Every recorded (offset, length, crc32) must match
    the corresponding slice of ``content`` and the segments must exactly
    cover [0, len).  Overwritten segments fail the crc check and force
    the safe rewrite fallback — verification is allowed to be
    conservative, never wrong."""
    covered: list[tuple[int, int]] = []
    for off, ln, crc in segs:
        if off < 0 or off + ln > len(content):
            return False
        if zlib.crc32(content[off:off + ln]) & 0xFFFFFFFF != crc:
            return False
        covered.append((off, off + ln))
    covered.sort()
    pos = 0
    for lo, hi in covered:
        if lo > pos:
            return False
        pos = max(pos, hi)
    return pos == len(content)


# ---------------------------------------------------------------------------
# the parsed log
# ---------------------------------------------------------------------------

class SpillImage:
    """What the spill log proves about the interrupted window.

    ``events`` is the ordered stream of non-elided done records (for
    overlay/stat-cache replay); ``durable_*`` index the same facts for
    the elision queries; ``uncertain`` maps (kind, paths) of ops whose
    admit record has no matching done/fail — the in-flight set the kill
    made ambiguous, resolved by ``SpillManager.repair``."""

    def __init__(self):
        self.epoch = 0
        self.began = False
        self.committed = False
        self.journal: dict[str, bool] = {}          # path -> is_dir
        self.events: list[tuple[str, tuple, dict]] = []
        self.fails: list[tuple[str, tuple]] = []
        self.durable_dirs: set[str] = set()
        self.durable_files: dict[str, dict] = {}    # path -> {"segs": [...]}
        self.durable_meta: dict[tuple, list] = {}   # (path, kind) -> args
        self.removed: set[str] = set()
        self.uncertain: dict[tuple, int] = {}
        self.removal_uncertain: set[str] = set()
        self.probed: dict[str, bool] = {}           # path -> existed pre-op
        self.end_offset = 0
        self.nrecords = 0

    # -- construction ---------------------------------------------------

    @classmethod
    def parse(cls, raw: bytes) -> "SpillImage":
        img = cls()
        admits: dict[tuple, int] = {}
        settles: dict[tuple, int] = {}
        pos = 0
        while pos < len(raw):
            nl = raw.find(b"\n", pos)
            if nl < 0:
                break  # torn final line: monotone-prefix stop
            rec = _dec(raw[pos:nl + 1].rstrip(b"\n"))
            if rec is None:
                break  # gap or corruption: everything after is ignored
            t = rec.get("t")
            if t == "begin":
                # a new attempt supersedes everything before it
                img.__init__()
                admits, settles = {}, {}
                img.began = True
                img.epoch = int(rec.get("e", 0))
            elif not img.began or int(rec.get("e", -1)) != img.epoch:
                break  # pre-window noise or epoch mismatch: stop
            elif t == "admit":
                key = (rec["k"], tuple(rec["p"]))
                admits[key] = admits.get(key, 0) + 1
            elif t == "done":
                key = (rec["k"], tuple(rec["p"]))
                settles[key] = settles.get(key, 0) + 1
                if not rec.get("el"):
                    img._apply_done(rec["k"], tuple(rec["p"]), rec)
            elif t == "fail":
                key = (rec["k"], tuple(rec["p"]))
                settles[key] = settles.get(key, 0) + 1
                img.fails.append((rec["k"], tuple(rec["p"])))
            elif t == "jrnl":
                img.journal[rec["p"]] = bool(rec["d"])
            elif t == "pre":
                # create/write existence probe, recorded before the
                # backend call ran: last probe wins (monotone prefix —
                # a surviving later record implies all earlier survive)
                img.probed[rec["p"]] = bool(rec["x"])
            elif t == "jmv":
                src, dst = rec["s"], rec["d"]
                for p in [p for p in img.journal
                          if p == src or is_under(p, src)]:
                    img.journal[dst + p[len(src):]] = img.journal.pop(p)
            elif t == "committed":
                img.committed = True
            elif t == "rolledback":
                # the attempt's outputs are being (or have been) physically
                # removed: none of its records may be trusted again.  A
                # later ``begin`` reopens a fresh window.
                img.__init__()
                admits, settles = {}, {}
            pos = nl + 1
            img.end_offset = pos
            img.nrecords += 1
        for key, n in admits.items():
            open_n = n - settles.get(key, 0)
            if open_n > 0:
                img.uncertain[key] = open_n
                if key[0] in REMOVAL_KINDS:
                    img.removal_uncertain.update(key[1])
        return img

    def _apply_done(self, kind: str, paths: tuple, rec: dict) -> None:
        p = paths[0]
        if kind == "mkdir":
            self.durable_dirs.add(p)
            self.removed.discard(p)
        elif kind == "create":
            self.durable_files[p] = {"segs": []}
            self.removed.discard(p)
        elif kind == "write":
            segs = rec.get("segs")
            if segs is None:
                # unverifiable payload: the path can never be diverted
                self.durable_files.pop(p, None)
            else:
                self.durable_files.setdefault(p, {"segs": []})["segs"] \
                    .extend([tuple(s) for s in segs])
            self.removed.discard(p)
        elif kind in ("truncate", "fallocate"):
            # content changed behind the recorded segments: unverifiable
            self.durable_files.pop(p, None)
            if rec.get("args") is not None:
                self.durable_meta[(p, kind)] = list(rec["args"])
        elif kind in META_KINDS or kind in ("symlink", "link"):
            if rec.get("args") is not None:
                self.durable_meta[(p, kind)] = list(rec["args"])
        elif kind == "unlink":
            self.removed.add(p)
            self.durable_files.pop(p, None)
            self.durable_meta = {k: v for k, v in self.durable_meta.items()
                                 if k[0] != p}
        elif kind == "rmdir":
            self.removed.add(p)
            self.durable_dirs.discard(p)
        elif kind == "remove_tree":
            root = p
            self.purge_under(root)
            self.removed.update(paths)
        elif kind == "rename":
            src, dst = paths[0], paths[1]
            self._rekey(src, dst)
        self.events.append((kind, paths, rec))

    def _rekey(self, src: str, dst: str) -> None:
        for coll in (self.durable_files,):
            for q in [q for q in coll if q == src or is_under(q, src)]:
                coll[dst + q[len(src):]] = coll.pop(q)
        for q in [q for q in self.durable_dirs
                  if q == src or is_under(q, src)]:
            self.durable_dirs.discard(q)
            self.durable_dirs.add(dst + q[len(src):])
        for k in [k for k in self.durable_meta
                  if k[0] == src or is_under(k[0], src)]:
            args = self.durable_meta.pop(k)
            self.durable_meta[(dst + k[0][len(src):], k[1])] = args
        self.removed.add(src)
        self.removed.discard(dst)

    def purge_under(self, root: str) -> tuple:
        """Drop every durable claim at/under ``root`` and mark the set
        removed.  Returns the affected paths (root first) so resume can
        replay the removal into the caches."""
        hit = [root]
        for q in [q for q in self.durable_files
                  if q == root or is_under(q, root)]:
            self.durable_files.pop(q)
            hit.append(q)
        for q in [q for q in self.durable_dirs
                  if q == root or is_under(q, root)]:
            self.durable_dirs.discard(q)
            hit.append(q)
        for k in [k for k in self.durable_meta
                  if k[0] == root or is_under(k[0], root)]:
            self.durable_meta.pop(k)
        self.removed.update(hit)
        return tuple(dict.fromkeys(hit))

    def vouches(self, p: str) -> bool:
        """Did the interrupted run provably reach this path?  Idempotent
        re-execution tolerance (EEXIST on mkdir, ENOENT on removals) is
        scoped to vouched paths: a mount-wide tolerance would mask
        genuine errors on paths run 1 never touched — a pre-existing
        directory, a removal target the job never owned."""
        if (p in self.journal or p in self.durable_dirs
                or p in self.durable_files or p in self.removed
                or p in self.removal_uncertain or p in self.probed):
            return True
        if any(k[0] == p for k in self.durable_meta):
            return True
        if any(p in paths for _, paths in self.uncertain):
            return True
        if any(p in paths for _, paths in self.fails):
            return True
        # under a bulk-removal root, or under a directory this window
        # created: nothing pre-existing can live below a created-in-window
        # dir, so the whole subtree is the run's own even where no
        # per-path record survived the kill
        return (any(is_under(p, r) for r in self.removed)
                or any(is_under(p, q)
                       for q, d in self.journal.items() if d))


# ---------------------------------------------------------------------------
# the manager
# ---------------------------------------------------------------------------

class SpillManager:
    """Per-mount spill state machine (``CannyFS.enable_spill`` /
    ``CannyFS.resume``).  Thread-safe: record hooks run on executor
    workers, cuts on barrier callers, elision queries on the submitting
    thread."""

    def __init__(self, engine, spill_dir: str, *, flush_records: int = 64,
                 max_outstanding: int = 8):
        self.engine = engine
        self.spill_dir = norm_path(spill_dir)
        self.journal_path = f"{self.spill_dir}/{JOURNAL_FILE}"
        self.marker_path = f"{self.spill_dir}/{CUT_FILE}"
        self.flush_records = max(int(flush_records), 1)
        self.max_outstanding = max(int(max_outstanding), 1)
        self._lock = threading.Lock()
        self._pending: list[bytes] = []            # encoded, unchunked
        self._outstanding: dict[int, tuple[int, bytes]] = {}
        self._chunk_seq = 0
        self._reserved = 0                         # next journal offset
        self._nrecords = 0
        self._cut_records = 0
        self.epoch = 0
        self._began = False
        self.txn = None
        # resume-session state
        self.image: Optional[SpillImage] = None
        self._resumed = False
        self._dirty: set[str] = set()              # real mutations this run
        self._bufs: dict[str, list[tuple[int, bytes]]] = {}
        self._removed_roots: list[tuple[str, tuple]] = []

    # ------------------------------------------------------------------
    # setup
    # ------------------------------------------------------------------

    def prepare(self) -> None:
        """Materialize the spill directory directly on the backend (the
        spill must not depend on the engine it protects)."""
        b = self.engine.backend
        cur = ""
        for part in self.spill_dir.split("/"):
            cur = f"{cur}/{part}" if cur else part
            try:
                b.mkdir(cur)
            except OSError:
                pass

    @property
    def resuming(self) -> bool:
        return self._resumed

    def removed_roots(self) -> list[tuple[str, tuple]]:
        return list(self._removed_roots)

    # ------------------------------------------------------------------
    # recording (hot path: called by the engine and the transaction)
    # ------------------------------------------------------------------

    def record_admit(self, kind: str, paths: tuple) -> None:
        if kind not in SPILL_KINDS or not self._began:
            return
        self._append({"t": "admit", "e": self.epoch, "k": kind,
                      "p": list(paths)})

    def record_done(self, op, elided: bool) -> None:
        if op.kind not in SPILL_KINDS or not self._began:
            return
        rec: dict[str, Any] = {"t": "done", "e": self.epoch, "k": op.kind,
                               "p": list(op.paths)}
        if elided:
            rec["el"] = 1
        else:
            pl = op.payload
            seg_fn = getattr(pl, "segments", None)
            if op.kind == "write":
                if callable(seg_fn):
                    rec["segs"] = [
                        [off, len(d), zlib.crc32(d) & 0xFFFFFFFF]
                        for off, d in seg_fn()]
                # a write without a WritePayload is unverifiable: parse
                # drops the path from the divertable set (segs absent)
            else:
                args = getattr(pl, "args", None)
                if args is not None:
                    try:
                        rec["args"] = list(args)
                        json.dumps(rec["args"])
                    except (TypeError, ValueError):
                        rec.pop("args", None)
        self._append(rec)

    def record_fail(self, op) -> None:
        if op.kind not in SPILL_KINDS or not self._began:
            return
        self._append({"t": "fail", "e": self.epoch, "k": op.kind,
                      "p": list(op.paths)})

    def record_journal(self, path: str, is_dir: bool) -> None:
        if not self._began:
            return
        self._append({"t": "jrnl", "e": self.epoch, "p": path,
                      "d": 1 if is_dir else 0})

    def record_preexist(self, path: str, existed: bool) -> None:
        """Admit-time existence, recorded by the create/write worker the
        moment its journaling probe settles — BEFORE the backend call
        runs.  On resume this is ``repair``'s only licence to journal an
        uncertain create/write that landed: without a surviving absence
        proof, a write_at to a pre-existing file is indistinguishable in
        the log from a landed-but-unjournaled create, and journaling it
        would put pre-transaction user data into rollback scope."""
        if not self._began:
            return
        self._append({"t": "pre", "e": self.epoch, "p": path,
                      "x": 1 if existed else 0})

    def record_journal_rename(self, src: str, dst: str) -> None:
        if not self._began:
            return
        self._append({"t": "jmv", "e": self.epoch, "s": src, "d": dst})

    def _append(self, rec: dict) -> None:
        line = _enc(rec)
        key = None
        with self._lock:
            self._pending.append(line)
            self._nrecords += 1
            self.engine.stats.spill_records += 1
            if len(self._pending) >= self.flush_records:
                key = self._chunk_locked()
        if key is not None:
            self._dispatch(key)

    def _chunk_locked(self) -> Optional[int]:
        if not self._pending:
            return None
        data = b"".join(self._pending)
        self._pending.clear()
        key = self._chunk_seq
        self._chunk_seq += 1
        self._outstanding[key] = (self._reserved, data)
        self._reserved += len(data)
        return key

    def _dispatch(self, key: int) -> None:
        """Hand one chunk to the low-priority speculative lane; when the
        lane refuses (poisoned/closed/budget-full) the chunk simply waits
        in ``_outstanding`` for the next cut.  If the lane is starved by
        an eager storm (too many unlanded chunks) escalate to a
        synchronous flush so durability lag stays bounded."""
        op = self.engine._sched.submit_speculative(
            "write", (self.journal_path,), lambda: self._write_chunk(key))
        del op  # refusal is fine: cut() owns the fallback
        with self._lock:
            over = len(self._outstanding) > self.max_outstanding
        if over:
            self._flush_outstanding()

    def _write_chunk(self, key: int) -> None:
        with self._lock:
            ent = self._outstanding.pop(key, None)
        if ent is None:
            return
        off, data = ent
        try:
            self.engine.backend.write_at(self.journal_path, off, data)
        except BaseException:
            # speculative ops must never reach the ledger: re-shelve the
            # chunk for the next cut and swallow (the journal stays a
            # contiguous prefix either way)
            with self._lock:
                self._outstanding[key] = (off, data)
            return
        with self._lock:
            self.engine.stats.spill_flushes += 1
            self.engine.stats.spill_bytes += len(data)

    def _flush_outstanding(self) -> None:
        with self._lock:
            items = sorted(self._outstanding.items(),
                           key=lambda kv: kv[1][0])
            for k, _ in items:
                self._outstanding.pop(k)
        for i, (k, (off, data)) in enumerate(items):
            try:
                self.engine.backend.write_at(self.journal_path, off, data)
            except Exception:
                with self._lock:  # keep the failed suffix for the next cut
                    for k2, (off2, data2) in items[i:]:
                        self._outstanding[k2] = (off2, data2)
                return
            with self._lock:
                self.engine.stats.spill_flushes += 1
                self.engine.stats.spill_bytes += len(data)

    def cut(self) -> None:
        """Observation seal: chunk whatever is buffered, force every
        outstanding chunk down synchronously, stamp the marker.  Failures
        are swallowed — a barrier must never start raising because the
        spill medium hiccuped; the un-landed suffix just isn't provable
        on resume."""
        with self._lock:
            self._chunk_locked()
            clean = (not self._outstanding
                     and self._nrecords == self._cut_records)
            nrec = self._nrecords
        if clean:
            return
        self._flush_outstanding()
        with self._lock:
            landed = not self._outstanding
        if not landed:
            # some chunks still haven't landed: a marker stamped now
            # would name records that are not durable.  Leave the old
            # stamp; the next cut re-tries the flush and stamps then.
            return
        marker = f"{self.epoch:08d}:{nrec:012d}".encode("ascii")
        try:
            self.engine.backend.write_at(self.marker_path, 0, marker)
        except Exception:
            return
        with self._lock:
            self._cut_records = nrec
            self.engine.stats.spill_cuts += 1

    # ------------------------------------------------------------------
    # transaction lifecycle
    # ------------------------------------------------------------------

    def attach_txn(self, txn) -> None:
        with self._lock:
            self.txn = txn
            fresh = not self._began
            self._began = True
            image = self.image if self._resumed else None
        if fresh:
            self._append({"t": "begin", "e": self.epoch})
            # sync-cut the begin record: from this point the journal
            # itself proves an open window, so a stale "committed" marker
            # from the *previous* transaction can never be misread as
            # this window's completion (no op of this window can land
            # before attach returns)
            self.cut()
        if image is not None:
            # reinstall the proven journal: rollback of the resumed
            # attempt must remove run-1 outputs too.  Direct seeding —
            # going through _record_create would re-emit jrnl records.
            with txn._lock:
                txn._created.update(image.journal)

    def on_commit(self) -> None:
        """Retire the window: committed record, final cut, then the
        journal is unlinked — but the marker is REWRITTEN as a committed
        proof, not removed.  Whatever instant a kill strikes, either the
        journal still carries the committed record or the marker names
        the committed epoch; a restart can always tell "this window
        finished" from "this window never started"."""
        self._append({"t": "committed", "e": self.epoch})
        self.cut()
        b = self.engine.backend
        try:
            b.write_at(self.marker_path, 0,
                       f"committed:{self.epoch:011d}".encode("ascii"))
        except Exception:
            pass
        try:
            b.unlink(self.journal_path)
        except OSError:
            pass
        self._reset_session(rewind=True)

    def on_rollback(self) -> None:
        """Called at the *start* of ``Transaction.rollback``, before any
        output is removed: the tombstone must hit the log first, so a
        kill striking mid-rollback can never leave a resume trusting
        durable claims whose files are half-deleted.  Flush, don't
        discard: dropping buffered chunks would leave a hole before the
        next epoch's begin record, making it unreachable to the
        monotone-prefix parser."""
        self._append({"t": "rolledback", "e": self.epoch})
        try:
            self.cut()
        except Exception:
            pass
        self._reset_session(rewind=False)

    def _reset_session(self, *, rewind: bool) -> None:
        with self._lock:
            self.epoch += 1
            self._began = False
            self.txn = None
            self._resumed = False
            self.image = None
            self._dirty.clear()
            self._bufs.clear()
            self._removed_roots = []
            self._pending.clear()
            self._outstanding.clear()
            if rewind:
                self._reserved = 0
                self._nrecords = 0
                self._cut_records = 0

    # ------------------------------------------------------------------
    # resume: load + repair
    # ------------------------------------------------------------------

    def load(self) -> dict:
        b = self.engine.backend
        try:
            raw = b.read_at(self.journal_path, 0, -1)
        except OSError:
            raw = b""
        img = SpillImage.parse(raw)
        marker = None
        try:
            marker = b.read_at(self.marker_path, 0, -1) \
                .decode("ascii", "replace")
        except OSError:
            pass
        committed_marker = (marker or "").startswith("committed:")
        if img.committed or (committed_marker and not img.began):
            # the window finished: either the journal still carries the
            # committed record (killed before retirement completed) or
            # retirement already ran and only the marker proof remains.
            # Finish the journal cleanup, keep the marker proof.
            try:
                b.unlink(self.journal_path)
            except OSError:
                pass
            with self._lock:
                self.epoch = img.epoch + 1
            return {"resumable": False, "committed": True, "marker": marker,
                    "records": img.nrecords}
        if img.end_offset < len(raw):
            # stale tail beyond the first gap: same-epoch records there
            # must not "reconnect" behind the appends we are about to make
            try:
                b.truncate(self.journal_path, img.end_offset)
            except OSError:
                pass
        with self._lock:
            self.image = img
            self.epoch = img.epoch
            self._reserved = img.end_offset
            self._nrecords = img.nrecords
            self._cut_records = img.nrecords
            self._began = img.began
            self._resumed = img.began
        return {
            "resumable": img.began, "committed": False, "marker": marker,
            "records": img.nrecords, "journal_paths": len(img.journal),
            "durable_dirs": len(img.durable_dirs),
            "durable_files": len(img.durable_files),
            "durable_meta": len(img.durable_meta),
            "removed": len(img.removed),
            "uncertain": sum(img.uncertain.values()),
        }

    def repair(self) -> dict:
        """Resolve the kill's in-flight ambiguity directly against the
        backend (the resume-time analogue of rollback's verification
        pass): re-issue uncertain bulk removals (healing a partially
        applied bulk DELETE), merge torn COPY+DELETE renames, probe
        uncertain removals, and journal any landed-but-unjournaled
        create so a later rollback cannot leak it."""
        if not self._resumed:
            return {"repairs": 0}
        b = self.engine.backend
        im = self.image
        repairs = 0
        for kind, paths in sorted(im.uncertain):
            p = paths[0]
            if kind == "remove_tree":
                try:
                    b.remove_tree(p)
                except FileNotFoundError:
                    pass   # the bulk DELETE fully applied before the kill
                except OSError:
                    continue
                self._removed_roots.append((p, im.purge_under(p)))
                repairs += 1
            elif kind in ("unlink", "rmdir"):
                try:
                    st = b.stat(p)
                except OSError:
                    continue
                if not st.exists:
                    im.durable_files.pop(p, None)
                    im.durable_dirs.discard(p)
                    im.removed.add(p)
                    self._removed_roots.append((p, (p,)))
            elif kind == "mkdir":
                try:
                    st = b.stat(p)
                except OSError:
                    continue
                if st.exists and st.is_dir:
                    im.durable_dirs.add(p)
                    if p not in im.journal:
                        im.journal[p] = True
                        self.record_journal(p, True)
                    repairs += 1
            elif kind in ("create", "write"):
                try:
                    st = b.stat(p)
                except OSError:
                    continue
                if not st.exists or p in im.journal:
                    continue
                if im.probed.get(p) is False:
                    # the op landed but its journal write did not, and a
                    # surviving probe record proves the path was absent
                    # before the op — it is truly this window's creation.
                    # Journal it, or rollback would *leak* the file (and
                    # a re-run's existence probe would wrongly memo it as
                    # pre-existing).
                    im.journal[p] = False
                    self.record_journal(p, False)
                    repairs += 1
                # no absence proof: leave the path unjournaled.  It may
                # be a pre-existing file whose write_at was in flight at
                # the kill; a leaked-on-rollback file is recoverable,
                # unlinking pre-transaction data is not.
            elif kind == "rename" and len(paths) == 2:
                if self._repair_rename(b, paths[0], paths[1]):
                    repairs += 1
        invalidated = self._validate_claims(b, im)
        with self._lock:
            self.engine.stats.resume_repairs += repairs
        return {"repairs": repairs, "invalidated": invalidated}

    def _validate_claims(self, b, im: "SpillImage") -> int:
        """Existence-check every durable claim.  A record proves the op
        was durable *at record time* — a structural op that landed after
        the last cut with no surviving record (rename, unlink, a bulk
        delete) may have invalidated it since.  One vectored stat batch
        over the proven set, no tree walk; a vanished path loses its
        claims (and its replay events), so the re-run executes it for
        real instead of eliding against a ghost."""
        probe = sorted(set(im.durable_files) | im.durable_dirs
                       | {k[0] for k in im.durable_meta})
        if not probe:
            return 0
        try:
            sts = b.stat_vec(probe)
        except OSError:
            sts = {}
        gone = set()
        for p in probe:
            st = sts.get(p)
            if st is None:
                try:
                    st = b.stat(p)
                except OSError:
                    continue
            if not st.exists:
                gone.add(p)
        if not gone:
            return 0
        dropped = 0
        for p in gone:
            if im.durable_files.pop(p, None) is not None:
                dropped += 1
            if p in im.durable_dirs:
                im.durable_dirs.discard(p)
                dropped += 1
        n_meta = len(im.durable_meta)
        im.durable_meta = {k: v for k, v in im.durable_meta.items()
                           if k[0] not in gone}
        dropped += n_meta - len(im.durable_meta)
        im.events = [(k, ps, r) for k, ps, r in im.events
                     if not any(q in gone for q in ps)]
        return dropped

    def _repair_rename(self, b, src: str, dst: str) -> bool:
        try:
            s_exists = b.stat(src).exists
            d_exists = b.stat(dst).exists
        except OSError:
            return False
        changed = False
        if s_exists and not d_exists:
            try:
                b.rename(src, dst)
                changed = True
            except OSError:
                return False
        elif s_exists and d_exists:
            # torn COPY+DELETE: keys live on both sides.  A key whose
            # dst copy is verified byte-identical to src is complete
            # (dst wins); any other dst — including a pre-existing
            # rename target whose COPY never ran — is overwritten from
            # src, never trusted.
            self._merge_move(b, src, dst)
            changed = True
        if not s_exists and not d_exists:
            return False
        # finish the journal's rekey exactly as _record_rename would have
        im = self.image
        for p in [p for p in im.journal if p == src or is_under(p, src)]:
            im.journal[dst + p[len(src):]] = im.journal.pop(p)
        self.record_journal_rename(src, dst)
        im._rekey(src, dst)
        return changed

    def _merge_move(self, b, src: str, dst: str) -> None:
        try:
            st = b.stat(src)
        except OSError:
            return
        if not st.exists:
            return
        if not st.is_dir:
            try:
                dstat = b.stat(dst)
            except OSError:
                return
            if not dstat.exists:
                try:
                    b.rename(src, dst)
                except OSError:
                    pass
                return
            # unlink src ONLY when dst is provably the completed copy
            # (same size, identical bytes).  When the rename target
            # pre-existed (rename-over-existing semantics) and the COPY
            # phase never started, dst holds the stale old content and
            # unlinking src would destroy the only copy of the moved
            # data — re-issue the rename instead (src wins); failing
            # that, keep both and dirty dst so the re-run rewrites it.
            same = dstat.size == st.size
            if same and st.size:
                try:
                    same = (zlib.crc32(b.read_at(src, 0, -1))
                            == zlib.crc32(b.read_at(dst, 0, -1)))
                except OSError:
                    same = False
            try:
                if same:
                    b.unlink(src)
                else:
                    b.rename(src, dst)
            except OSError:
                with self._lock:
                    self._dirty.add(dst)
            return
        try:
            b.mkdir(dst)
        except OSError:
            pass
        try:
            names = b.readdir(src)
        except OSError:
            names = []
        for name in names:
            self._merge_move(b, f"{src}/{name}", f"{dst}/{name}")
        try:
            b.rmdir(src)
        except OSError:
            pass

    # ------------------------------------------------------------------
    # resume-session elision / diversion queries (called by the fs layer)
    # ------------------------------------------------------------------

    def note_paths(self, fs, kind: str, paths: tuple) -> None:
        """Every *real* submitted mutation marks its paths dirty (no
        later elision may trust the stale image for them) and force-
        finalizes any diverted stream it touches, so op order around the
        diversion stays FIFO-correct."""
        if kind not in SPILL_KINDS:
            return
        flush = []
        with self._lock:
            for p in paths:
                if p in self._bufs:
                    flush.append(p)
                self._dirty.add(p)
        for p in flush:
            self.finalize(fs, p)

    def elide_mkdir(self, p: str) -> bool:
        if not self._resumed:
            return False
        with self._lock:
            return p in self.image.durable_dirs and p not in self._dirty

    def divert_create(self, p: str) -> bool:
        if not self._resumed:
            return False
        with self._lock:
            if (p in self._dirty or p in self._bufs
                    or p not in self.image.durable_files):
                return False
            self._bufs[p] = []
            return True

    def divert_write(self, p: str, offset: int, data: bytes) -> bool:
        if not self._resumed:
            return False
        with self._lock:
            buf = self._bufs.get(p)
            if buf is None:
                return False
            buf.append((offset, data))
            return True

    def elide_meta(self, kind: str, p: str, args: tuple) -> bool:
        if not self._resumed:
            return False
        with self._lock:
            if p in self._dirty or p in self._bufs:
                return False
            rec = self.image.durable_meta.get((p, kind))
            return rec is not None and list(rec) == list(args)

    def elide_unlink(self, p: str) -> bool:
        if not self._resumed:
            return False
        with self._lock:
            return (p in self.image.removed and p not in self._dirty
                    and p not in self._bufs)

    def elide_rmdir(self, p: str) -> bool:
        if not self._resumed:
            return False
        with self._lock:
            if p not in self.image.removed or p in self._dirty:
                return False
            return not any(is_under(q, p) for q in self._dirty)

    def elide_remove_root(self, p: str) -> bool:
        """May the whole ``rmtree(p)`` recursion be skipped?  Only when
        the removal is durably complete: the root is gone, nothing at or
        under it still holds a durable claim, and nothing under it was
        re-created for real this session."""
        if not self._resumed:
            return False
        with self._lock:
            im = self.image
            if p not in im.removed:
                return False
            if p in self._dirty or any(is_under(q, p) for q in self._dirty):
                return False
            if any(q == p or is_under(q, p) for q in im.durable_dirs):
                return False
            if any(q == p or is_under(q, p) for q in im.durable_files):
                return False
            return True

    def session_tolerant(self, p: str) -> bool:
        """Should a re-executed mkdir of ``p`` tolerate FileExistsError?
        Only on a resumed attempt, and only for paths the image vouches
        for (journaled, claimed, probed, uncertain, or under a subtree
        this window owns): the interrupted run's op may have landed
        without its record surviving the kill, so EEXIST there is the
        re-execution meeting run 1's own output.  Anywhere else the
        error is genuine — a fresh run would surface it too — and must
        not be masked."""
        if not self._resumed:
            return False
        with self._lock:
            return self.image is not None and self.image.vouches(p)

    def removal_tolerant(self, p: str) -> bool:
        """Should a re-executed unlink/rmdir tolerate absence?  Same
        scoping as ``session_tolerant``: the interrupted run's removal
        (or the repair pass) may already have taken a *vouched* path
        down without a surviving record; an ENOENT on a path run 1
        never touched is a real error."""
        if not self._resumed:
            return False
        with self._lock:
            return self.image is not None and self.image.vouches(p)

    # -- diverted-stream settlement -------------------------------------

    def finalize(self, fs, p: str) -> bool:
        """Settle one diverted create+write stream: verify the buffered
        content against the recorded durable segment checksums.  A match
        proves the backend already holds exactly these bytes — the whole
        stream is elided; any mismatch falls back to a plain rewrite
        (create + one covering write), marking the path dirty."""
        with self._lock:
            buf = self._bufs.pop(p, None)
            rec = (self.image.durable_files.get(p)
                   if self.image is not None else None)
        if buf is None:
            return False
        content = _assemble(buf)
        if rec is not None and _verify(content, rec["segs"]):
            with self._lock:
                self.engine.stats.resume_elided_ops += 1 + len(buf)
            return True
        with self._lock:
            self._dirty.add(p)
        fs.create(p)
        if content:
            fs._write_at(p, 0, content)
        return True

    def finalize_all(self, fs) -> None:
        while True:
            with self._lock:
                live = next(iter(self._bufs), None)
            if live is None:
                return
            self.finalize(fs, live)


__all__ = ["SPILL_KINDS", "SpillImage", "SpillManager", "commit_marker_ok"]
