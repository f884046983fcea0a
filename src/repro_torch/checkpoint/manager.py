"""Transactional checkpointing on the CannyFS engine — the paper's
technique as a first-class training feature.

Timeline of one save (the CannyFS mapping):

    train loop:  save(step, state)         <- returns after device→host copy
       engine:   [manifest + leaf writes eagerly ACKed, running in
                  background per-path queues while the next train steps run]
    finalizer:   drain() -> ledger clean? -> write COMMIT marker
                 (the transaction commit; a checkpoint without COMMIT is
                  invisible to restore and rolled back on startup)

Failure model = the paper's: any deferred I/O error means the whole
checkpoint transaction is discarded (rolled back) and retried at the next
save interval; the job itself restarts from the last *committed*
checkpoint.  The artifact is device-agnostic: restore puts the tensors on
whatever device the caller names.

The port's copy of the reference's manager: the same files, the same
COMMIT protocol, GC and finalizer; leaves are torch tensors, restore puts
them on a device and, given shardings, cuts this rank's shards from them.

On a mesh (``mesh=``) the artifact stays the same mesh-agnostic one:
``save(..., shardings=)`` gathers the full tensors leaf by leaf onto the
host of the rank at the mesh's origin (global rank 0), and that rank
alone writes through CannyFS (the step directory, every leaf, then COMMIT
once).  The other ranks hold the save as pending; the next
``wait_for_save`` (the next save, a restore, the end of a run) broadcasts
the writer's outcome, so no rank can go on to restore or restart from a
step whose COMMIT never landed.  On restore the writer picks the step and
broadcasts it (the other ranks never list the directory that the
writer's mount writes); every rank reads that step's files onto the host
and moves its own shards to the device, whatever mesh saved it.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Optional

import torch
import torch.distributed as dist

from repro_torch.core import CannyError, CannyFS, is_under, norm_path
from repro_torch.core.durability import commit_marker_ok
from repro_torch.parallel.sharding import (gather_tree_to_origin,
                                           origin_rank, place_tree)

# ledger kinds that cannot be a checkpoint write failure — a failed or
# cancelled readdir-prefetch stat on the step dir must not condemn a save
_READ_KINDS = frozenset({"stat", "readdir", "read", "readlink"})

from .serialization import (flatten_for_save, leaf_bytes, manifest_bytes,
                            parse_manifest, unflatten_from)

COMMIT_FILE = "COMMIT"
MANIFEST_FILE = "manifest.json"

# leaf payloads stream through CannyFile in bounded chunks: consecutive
# chunks coalesce in the engine's optimizer into one vectored write_vec
# backend call, so large shards pay one remote roundtrip without the
# manager ever materializing more than the source array
_WRITE_CHUNK = 4 << 20


@dataclass
class SaveResult:
    step: int
    directory: str
    ok: bool = False
    error: Optional[str] = None
    gc_error: Optional[str] = None   # GC hiccup after a durable commit
    ack_s: float = 0.0        # time the train loop was blocked
    commit_s: float = 0.0     # background time to durable commit
    bytes: int = 0


class TransactionalCheckpointManager:
    def __init__(self, fs: CannyFS, directory: str = "ckpt", *,
                 keep: int = 3, mesh=None):
        self.fs = fs
        self.dir = norm_path(directory)
        self.keep = keep
        self.mesh = mesh
        self.writer = mesh is None or dist.get_rank() == origin_rank(mesh)
        self._lock = threading.Lock()
        self._finalizer: Optional[threading.Thread] = None
        self._pending: Optional[SaveResult] = None
        self._results: list[SaveResult] = []
        # steps whose COMMIT this manager validated or wrote itself —
        # lets _gc use the validated list without re-reading markers
        self._committed_cache: set[int] = set()
        if self.writer:
            with fs.detached():   # the root is not any transaction's output
                if not fs.exists(self.dir):
                    fs.makedirs(self.dir)
            self.rollback_uncommitted()
            fs.drain()
        if mesh is not None:      # the others read the root after its repair
            dist.barrier()

    # ------------------------------------------------------------------

    def _step_dir(self, step: int) -> str:
        return f"{self.dir}/step_{step:010d}"

    def _under_dir(self, d: str):
        """Predicate over ledger entries: this manager's own (detached,
        untagged) write failures under ``d`` — a user transaction's entries
        under the step dir belong to its commit, and a failed or cancelled
        readdir-prefetch stat must not condemn a save."""
        def pred(e):
            return (e.region is None and e.kind not in _READ_KINDS
                    and any(is_under(p, d) for p in e.paths))
        return pred

    def _discard_step_dir(self, d: str, *, strict: bool = False) -> list:
        """The single step-dir rollback path (consolidates what used to be
        three copies: the ack-phase abort, the finalizer's error branch and
        startup recovery): un-poison the mount so cleanup I/O can run,
        remove the partial dir, then drop the manager's own deferred
        errors under it so a re-save of the same step starts from a clean
        ledger.  Returns the dropped cleanup entries (already echoed at
        record time) for error reporting.

        Save-path callers run best-effort (``strict=False``: a removal
        failure is absorbed — startup recovery is their backstop).
        Startup recovery itself runs ``strict=True``: it IS the backstop,
        so a dir it cannot remove must propagate, not be reported as
        rolled back with its errors cleared."""
        try:
            self.fs.engine.reset_poison()
            with self.fs.detached():
                if self.fs.exists(d):
                    self.fs.rmtree(d)
                    self.fs.drain()
        except (OSError, CannyError):
            if strict:
                raise
        return self.fs.ledger.clear_where(self._under_dir(d))

    def _is_committed(self, step: int) -> bool:
        """A COMMIT marker is only trusted if its content names the step —
        an empty/partial marker (write faulted after create) is not a
        commit.  Only a *missing* marker means uncommitted; any other read
        error propagates — treating a transient EIO as 'not committed'
        would let startup recovery delete a durable checkpoint."""
        if step in self._committed_cache:
            return True
        try:
            data = self.fs.read_file(f"{self._step_dir(step)}/{COMMIT_FILE}")
        except FileNotFoundError:
            return False
        # shared marker discipline with the durability spill's CUT file:
        # one validator, one notion of "content names the epoch/step"
        ok = commit_marker_ok(data, step)
        if ok:
            self._committed_cache.add(step)
        return ok

    def list_steps(self, *, committed_only: bool = True) -> list[int]:
        steps = []
        for name in self.fs.readdir(self.dir):
            if not name.startswith("step_"):
                continue
            try:
                step = int(name.split("_", 1)[1])
            except ValueError:
                continue
            if committed_only and not self._is_committed(step):
                continue
            steps.append(step)
        return sorted(steps)

    def rollback_uncommitted(self) -> list[int]:
        """Startup recovery: delete any checkpoint without a COMMIT marker
        (the paper's 'roll back the failed transaction')."""
        rolled = []
        committed = set(self.list_steps(committed_only=True))
        for step in self.list_steps(committed_only=False):
            if step not in committed:
                self._discard_step_dir(self._step_dir(step), strict=True)
                rolled.append(step)
        return rolled

    # ------------------------------------------------------------------

    def save(self, step: int, state: Any, *, block: bool = False,
             shardings: Any = None) -> SaveResult:
        """Eagerly-ACKed checkpoint save.  Returns as soon as all writes are
        queued (device→host copy included); a background finalizer commits.
        ``state`` is a tree of tensors (or numpy arrays) on any device; on a
        mesh, this rank's shards under ``shardings`` (every rank calls).
        """
        self.wait_for_save()          # one in-flight checkpoint at a time
        t0 = time.monotonic()
        d = self._step_dir(step)
        res = SaveResult(step=step, directory=d)
        if shardings is not None:
            state = gather_tree_to_origin(state, shardings, self.mesh)
        if self.mesh is not None:
            self._pending = res
        if not self.writer:
            res.ack_s = time.monotonic() - t0
            if block:
                self.wait_for_save()
            return res
        manifest, leaves = flatten_for_save(state)
        under_d = self._under_dir(d)

        def abort_save(e: BaseException) -> SaveResult:
            """Ack-phase failure (e.g. poisoned engine rejecting a queued
            write): report via SaveResult — never raise into the train
            loop — and best-effort roll the partial step dir back."""
            res.ok = False
            res.error = repr(e)
            res.ack_s = time.monotonic() - t0   # loop was blocked this long
            self._discard_step_dir(d)
            res.commit_s = time.monotonic() - t0
            with self._lock:
                self._results.append(res)
            return res

        # detached: checkpoint files belong to the manager's own commit
        # protocol — they must not be journaled into (or their failures
        # blamed on) whatever user Transaction is open on this mount
        try:
            with self.fs.detached():
                self.fs.makedirs(d)
                total = 0
                self.fs.write_file(f"{d}/{MANIFEST_FILE}",
                                   manifest_bytes(manifest))
                for key, arr in leaves:
                    fname = key.replace("/", "__") + ".bin"
                    # chunked stream: the optimizer coalesces these into
                    # one vectored write_vec per shard file
                    blob = leaf_bytes(arr)
                    with self.fs.open(f"{d}/{fname}", "wb") as f:
                        for lo in range(0, len(blob), _WRITE_CHUNK):
                            f.write(blob[lo:lo + _WRITE_CHUNK])
                    total += len(blob)
        except (OSError, CannyError) as e:
            return abort_save(e)
        res.bytes = total
        res.ack_s = time.monotonic() - t0

        def finalize():
            try:
                with self.fs.detached():
                    finalize_detached()
            except (OSError, CannyError) as e:
                # e.g. poisoned engine rejecting the COMMIT write, or a
                # sync-mode mount surfacing the fault directly — the
                # checkpoint is not durable, and the caller must hear it;
                # roll the partial dir back (a partial COMMIT marker would
                # otherwise make the step look durable)
                res.ok = False
                res.error = res.error or repr(e)
                self._discard_step_dir(d)
            finally:
                res.commit_s = time.monotonic() - t0
                with self._lock:
                    self._results.append(res)

        def finalize_detached():
            self.fs.drain()
            # path-scoped, not positional: a concurrent transaction
            # rollback can clear unrelated ledger entries, which would
            # shift a positional slice and hide this checkpoint's failures
            errs = [e for e in self.fs.ledger.entries() if under_d(e)]
            if not errs:
                self.fs.write_file(f"{d}/{COMMIT_FILE}", str(step).encode())
                self.fs.engine.barrier(f"{d}/{COMMIT_FILE}")
                # the COMMIT write itself can fail (eager => deferred);
                # re-scan or a lost marker gets reported as durable
                errs = [e for e in self.fs.ledger.entries() if under_d(e)]
            if errs:
                # handled (reported below + rolled back): clear exactly
                # the scanned entries by identity so a re-save of this
                # step works and other regions' entries are untouched
                handled = set(map(id, errs))
                self.fs.ledger.clear_where(lambda e: id(e) in handled)
                res.ok = False
                res.error = "; ".join(str(e) for e in errs[:4])
                # _discard_step_dir un-poisons *before* the rmtree (its
                # sync readdir would fail fast on a poisoned engine and
                # leak the partial step dir); the rollback's own deferred
                # errors under the step dir are cleared (stale entries
                # would fail every future save of this step) and reported
                # alongside the originals
                cleanup = self._discard_step_dir(d)
                if cleanup:
                    res.error += "; " + "; ".join(
                        str(e) for e in cleanup[:2])
            else:
                res.ok = True
                self._committed_cache.add(step)
                try:
                    self._gc()
                except (OSError, CannyError) as e:
                    # the checkpoint IS durable (COMMIT landed) — a GC
                    # hiccup must not flip ok; report it separately
                    res.gc_error = repr(e)

        if block:
            finalize()
            if self.mesh is not None:
                self.wait_for_save()
        else:
            self._finalizer = threading.Thread(target=finalize, daemon=True,
                                               name=f"ckpt-commit-{step}")
            self._finalizer.start()
        return res

    def wait_for_save(self) -> None:
        t = self._finalizer
        if t is not None:
            t.join()
            self._finalizer = None
        res, self._pending = self._pending, None
        if res is not None:          # on a mesh: the writer's outcome
            ok = bool(self._from_writer(int(res.ok)))
            if not self.writer:
                res.ok = ok
                res.error = None if ok else "the writer's save failed"
                with self._lock:
                    self._results.append(res)

    def _from_writer(self, value: int) -> int:
        """The writer's ``value`` on every rank of the mesh (as is without
        one)."""
        if self.mesh is None:
            return value
        dev = torch.device("cuda", torch.cuda.current_device()) \
            if self.mesh.device_type == "cuda" else torch.device("cpu")
        t = torch.tensor([value], dtype=torch.int64, device=dev)
        dist.broadcast(t, src=origin_rank(self.mesh))
        return int(t.item())

    def _gc(self) -> None:
        # validated list via the committed-step cache: zero marker reads
        # for steps committed (or once validated) by this process
        steps = self.list_steps()
        for step in steps[:-self.keep] if self.keep else []:
            self.fs.rmtree(self._step_dir(step))
            self._committed_cache.discard(step)

    @property
    def results(self) -> list[SaveResult]:
        with self._lock:
            return list(self._results)

    # ------------------------------------------------------------------

    def restore(self, like: Any, *, step: Optional[int] = None,
                device=None, shardings: Any = None) -> tuple[int, Any]:
        """Restore the latest (or given) committed checkpoint into the
        structure of ``like`` (only its structure is read: a tree of meta
        tensors will do), as tensors on ``device`` (None: the CPU), in the
        dtypes the manifest names.  ``shardings`` (a matching tree of
        ``NamedSharding``, None for a leaf kept whole) reshards on restore:
        the artifact is mesh-agnostic, so any mesh restores it; it is read
        onto the host and only this rank's shards reach ``device``."""
        self.wait_for_save()
        chosen = -1
        if self.writer:
            steps = self.list_steps()
            if steps:
                chosen = steps[-1] if step is None else step
        step = self._from_writer(chosen)
        if step < 0:
            raise FileNotFoundError("no committed checkpoint found")
        d = self._step_dir(step)
        manifest = parse_manifest(self.fs.read_file(f"{d}/{MANIFEST_FILE}"))
        blobs: dict[str, bytes] = {}
        for key in manifest["leaves"]:
            fname = key.replace("/", "__") + ".bin"
            blobs[key] = self.fs.read_file(f"{d}/{fname}")
        if shardings is None:
            return step, unflatten_from(manifest, blobs, like, device)
        return step, place_tree(unflatten_from(manifest, blobs, like),
                                shardings, device)
