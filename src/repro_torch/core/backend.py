"""Storage backends.

The engine interposes at the API level (the in-container analogue of the
paper's FUSE layer) and talks to a pluggable ``StorageBackend``:

* ``LocalBackend``   — a rooted local directory (the "fast" medium).
* ``InMemoryBackend``— dict-based filesystem; the property-test oracle.
* ``LatencyBackend`` — decorator injecting per-op latency + a bandwidth cap
  + bounded server concurrency, calibrated to the paper's NFS-over-GbE
  environment.  This is what the paper benchmarks run against.
"""
from __future__ import annotations

import heapq
import io
import os
import posixpath
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Iterable, Optional


def norm_path(path: str) -> str:
    """Normalize to a rooted-relative posix path ('' is the root)."""
    p = posixpath.normpath("/" + str(path).replace("\\", "/")).lstrip("/")
    return "" if p == "." else p


def parent_of(path: str) -> str:
    p = norm_path(path)
    if not p:
        return ""
    head = posixpath.dirname(p)
    return head


def is_under(path: str, root: str) -> bool:
    """True iff ``path`` is ``root`` or lies inside its subtree (both
    already normalized)."""
    return path == root or path.startswith(root + "/")


@dataclass(frozen=True)
class StatResult:
    exists: bool
    is_dir: bool = False
    is_symlink: bool = False
    size: int = 0
    mtime: float = 0.0
    mode: int = 0o644
    mocked: bool = False  # answered from the write-through cache


@dataclass(frozen=True)
class CostHint:
    """Per-op-class cost estimate a backend advertises to the optimizer.

    The CostModel protocol: ``backend.cost_hint(op, nbytes=0)`` returns a
    ``CostHint`` (or ``None`` when the backend has no opinion — local and
    in-memory storage — in which case callers fall back to their fixed
    policy bounds).  Decorator backends (latency, faults, quota) delegate
    the question inward so the hint always reflects the storage actually
    at the bottom of the stack.

    * ``rtt_s``                 — expected round-trip time for one request
      of this op class, excluding payload transfer.
    * ``bytes_per_s``           — achievable streaming rate for payload
      bytes once the request is in flight.
    * ``per_request_overhead_s``— fixed extra cost charged per wire
      request beyond the first (pipelined continuation pages, per-key
      sub-requests of a composite op such as rename-as-copy+delete).

    ``cost_s(nbytes)`` collapses the triple to one number so callers can
    *compare* op classes (is a rename materially more expensive than a
    create?) without caring which term dominates.
    """

    rtt_s: float
    bytes_per_s: float
    per_request_overhead_s: float = 0.0

    def cost_s(self, nbytes: int = 0) -> float:
        c = self.rtt_s + self.per_request_overhead_s
        if nbytes > 0 and self.bytes_per_s > 0:
            c += nbytes / self.bytes_per_s
        return c

    def bdp_bytes(self) -> float:
        """Bandwidth-delay product implied by this hint: the payload size
        past which streaming, not latency, dominates one request."""
        return (self.rtt_s + self.per_request_overhead_s) * self.bytes_per_s


class StorageBackend:
    """Synchronous primitive I/O operations (one per eagerness flag)."""

    # --- namespace ---
    def mkdir(self, path: str) -> None: raise NotImplementedError
    def rmdir(self, path: str) -> None: raise NotImplementedError
    def create(self, path: str) -> None: raise NotImplementedError
    def unlink(self, path: str) -> None: raise NotImplementedError
    def rename(self, src: str, dst: str) -> None: raise NotImplementedError
    def symlink(self, target: str, path: str) -> None: raise NotImplementedError
    def link(self, src: str, dst: str) -> None: raise NotImplementedError
    def readlink(self, path: str) -> str: raise NotImplementedError
    # --- data ---
    def write_at(self, path: str, offset: int, data: bytes) -> int: raise NotImplementedError

    def write_vec(self, path: str, segments: list[tuple[int, bytes]]) -> int:
        """Vectored write: apply (offset, data) segments in order; returns
        total bytes written.  The default is a loop over ``write_at`` so
        every backend (and every test double overriding ``write_at``)
        composes; a short segment write stops the vector and returns the
        partial total — callers treat that as a torn op.  Decorator
        backends override this to pay their cost once per *fused* call."""
        total = 0
        for off, data in segments:
            n = self.write_at(path, off, data)
            total += n
            if n < len(data):
                break
        return total

    def remove_tree(self, path: str) -> int:
        """Vectored subtree removal: delete everything at/under ``path``
        and return the number of entries removed.  Absence-tolerant by
        contract (``rm -rf`` semantics): a missing root or entries that
        vanished (e.g. their creating ops were elided) are not errors —
        the cross-path bulk-remove pass relies on this.  The default is a
        walk over the primitive ops so every backend (and every test
        double overriding ``unlink``/``rmdir``) composes; decorator
        backends override it to pay their cost once per *fused* call."""
        path = norm_path(path)
        try:
            st = self.stat(path)
        except OSError:
            return 0
        if not st.exists:
            return 0
        removed = 0
        if st.is_dir and not st.is_symlink:
            try:
                names = self.readdir(path)
            except FileNotFoundError:
                return 0
            for name in names:
                removed += self.remove_tree(f"{path}/{name}" if path else name)
            try:
                self.rmdir(path)
                removed += 1
            except FileNotFoundError:
                pass
        else:
            try:
                self.unlink(path)
                removed += 1
            except FileNotFoundError:
                pass
        return removed

    def read_at(self, path: str, offset: int, size: int) -> bytes: raise NotImplementedError
    def truncate(self, path: str, size: int) -> None: raise NotImplementedError
    def fallocate(self, path: str, size: int) -> None: raise NotImplementedError
    def fsync(self, path: str) -> None: raise NotImplementedError
    # --- metadata ---
    def chmod(self, path: str, mode: int) -> None: raise NotImplementedError
    def chown(self, path: str, uid: int, gid: int) -> None: raise NotImplementedError
    def utimens(self, path: str, atime: float, mtime: float) -> None: raise NotImplementedError
    def setxattr(self, path: str, key: str, value: bytes) -> None: raise NotImplementedError
    def removexattr(self, path: str, key: str) -> None: raise NotImplementedError
    def stat(self, path: str) -> StatResult: raise NotImplementedError
    def readdir(self, path: str) -> list[str]: raise NotImplementedError

    def readdir_plus(self, path: str) -> list[tuple[str, Optional[StatResult]]]:
        """Listing with attributes — the NFS READDIRPLUS analogue the
        overlay uses to warm membership *and* the stat cache in one
        backend call.  Per-entry stat failures are advisory (the entry is
        returned with ``None`` attrs); a failing ``readdir`` still
        raises.  Decorator backends override this to pay one roundtrip
        for the whole listing."""
        path = norm_path(path)
        out: list[tuple[str, Optional[StatResult]]] = []
        for name in self.readdir(path):
            child = f"{path}/{name}" if path else name
            try:
                out.append((name, self.stat(child)))
            except OSError:
                out.append((name, None))
        return out

    def readdir_plus_vec(
            self, paths: list[str],
    ) -> dict[str, list[tuple[str, Optional[StatResult]]]]:
        """Vectored READDIRPLUS: list several directories in one backend
        call — the speculative metadata prefetch pipeline's primitive
        (``core/prefetch.py``).  Returns ``{path: listing}`` keyed by the
        normalized path.  Per-*directory* failures are advisory (a
        directory that cannot be listed — removed, permission-denied — is
        simply omitted from the result), mirroring ``readdir_plus``'s
        per-entry tolerance: the whole batch is a speculative read and
        must never fail a caller.  The default is a loop over
        ``readdir_plus`` so every backend (and every test double
        overriding ``readdir``/``stat``) composes; decorator backends
        override it to pay their cost once per *fused* batch."""
        out: dict[str, list[tuple[str, Optional[StatResult]]]] = {}
        for p in paths:
            p = norm_path(p)
            try:
                out[p] = self.readdir_plus(p)
            except OSError:
                pass
        return out

    def stat_vec(self, paths: list[str]) -> dict[str, StatResult]:
        """Vectored stat: attributes for several paths in one backend
        call — the existence-batching primitive behind ``makedirs``
        parent probes and the write path's journaling stats
        (``core/readahead.py``).  Returns ``{path: StatResult}`` keyed by
        the normalized path.  Per-path failures are advisory (a path
        whose stat raises is simply omitted), mirroring
        ``readdir_plus_vec``: the whole batch is a speculative probe and
        must never fail a caller — a missing entry means "ask
        synchronously".  The default is a loop over ``stat`` so every
        backend (and every test double overriding ``stat``) composes;
        decorator backends override it to pay their cost once per
        *fused* batch."""
        out: dict[str, StatResult] = {}
        for p in paths:
            p = norm_path(p)
            try:
                out[p] = self.stat(p)
            except OSError:
                pass
        return out

    def read_vec(self, path: str, spans: list[tuple[int, int]]) -> list[bytes]:
        """Vectored read: fetch (offset, size) extents of one file in a
        single backend call — the read-ahead layer's primitive (the
        read-side mirror of ``write_vec``, after WTF's file-slice
        composition).  Returns one ``bytes`` per span, in order; a span
        past EOF comes back short or empty exactly as ``read_at`` would
        return it.  Unlike the speculative ``*_vec`` probes this CAN
        raise (a missing file is a real error the caller must see).  The
        default is a loop over ``read_at`` so every backend composes;
        decorator backends override it to pay their cost once per fused
        batch."""
        return [self.read_at(path, off, size) for off, size in spans]

    def cost_hint(self, op: str, nbytes: int = 0) -> Optional[CostHint]:
        """The CostModel protocol (see ``CostHint``).  ``op`` is an op
        *class* name (``"write"``, ``"read"``, ``"rename"``, ``"stat"``,
        ``"readdir"``, ``"remove_tree"``, ...); ``nbytes`` lets a backend
        whose cost structure is size-dependent specialize the hint.  The
        base returns ``None`` — local/in-memory storage has no cost
        opinion and callers keep their fixed policy bounds.  Decorator
        backends MUST override this with an explicit inward delegation:
        because they subclass ``StorageBackend``, this very definition
        would otherwise shadow their ``__getattr__`` fallthrough and
        silently hide the wrapped backend's model."""
        return None


# ---------------------------------------------------------------------------


class LocalBackend(StorageBackend):
    """Rooted local-directory backend (mirrors the host FS like the paper's
    fusexmp-derived passthrough)."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)

    def _abs(self, path: str) -> str:
        p = norm_path(path)
        out = os.path.join(self.root, p) if p else self.root
        # containment check — the mount must not escape its root
        if not os.path.abspath(out).startswith(self.root):
            raise PermissionError(f"path escapes mount root: {path}")
        return out

    def mkdir(self, path): os.mkdir(self._abs(path))
    def rmdir(self, path): os.rmdir(self._abs(path))

    def create(self, path):
        fd = os.open(self._abs(path), os.O_CREAT | os.O_WRONLY | os.O_TRUNC, 0o644)
        os.close(fd)

    def unlink(self, path): os.unlink(self._abs(path))
    def rename(self, src, dst): os.rename(self._abs(src), self._abs(dst))
    def symlink(self, target, path): os.symlink(target, self._abs(path))
    def link(self, src, dst): os.link(self._abs(src), self._abs(dst))
    def readlink(self, path): return os.readlink(self._abs(path))

    def write_at(self, path, offset, data):
        fd = os.open(self._abs(path), os.O_CREAT | os.O_WRONLY, 0o644)
        try:
            os.lseek(fd, offset, os.SEEK_SET)
            return os.write(fd, data)
        finally:
            os.close(fd)

    def write_vec(self, path, segments):
        # one open per fused batch instead of one per write — the local
        # analogue of the single-roundtrip win on remote backends
        fd = os.open(self._abs(path), os.O_CREAT | os.O_WRONLY, 0o644)
        total = 0
        try:
            for off, data in segments:
                n = os.pwrite(fd, data, off)
                total += n
                if n < len(data):
                    break
        finally:
            os.close(fd)
        return total

    def read_at(self, path, offset, size):
        fd = os.open(self._abs(path), os.O_RDONLY)
        try:
            os.lseek(fd, offset, os.SEEK_SET)
            if size < 0:
                chunks = []
                while True:
                    c = os.read(fd, 1 << 20)
                    if not c:
                        break
                    chunks.append(c)
                return b"".join(chunks)
            # a single os.read may return short of ``size`` (pipe-buffer
            # sized chunks on some filesystems) — accumulate until EOF or
            # the request is satisfied, like the size < 0 branch
            chunks = []
            remaining = size
            while remaining > 0:
                c = os.read(fd, min(remaining, 1 << 20))
                if not c:
                    break
                chunks.append(c)
                remaining -= len(c)
            return b"".join(chunks)
        finally:
            os.close(fd)

    def read_vec(self, path, spans):
        # one open per fused batch instead of one per read — the local
        # analogue of the single-roundtrip win on remote backends
        fd = os.open(self._abs(path), os.O_RDONLY)
        out = []
        try:
            for off, size in spans:
                chunks = []
                remaining = size
                while remaining > 0:
                    c = os.pread(fd, min(remaining, 1 << 20), off)
                    if not c:
                        break
                    chunks.append(c)
                    off += len(c)
                    remaining -= len(c)
                out.append(b"".join(chunks))
        finally:
            os.close(fd)
        return out

    def truncate(self, path, size):
        with open(self._abs(path), "r+b") as f:
            f.truncate(size)

    def fallocate(self, path, size):
        with open(self._abs(path), "ab") as f:
            f.truncate(max(size, os.fstat(f.fileno()).st_size))

    def fsync(self, path):
        fd = os.open(self._abs(path), os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)

    def chmod(self, path, mode): os.chmod(self._abs(path), mode)

    def chown(self, path, uid, gid):  # no-op off-root; permission-free CI
        pass

    def utimens(self, path, atime, mtime):
        os.utime(self._abs(path), (atime, mtime))

    def setxattr(self, path, key, value):
        try:
            os.setxattr(self._abs(path), f"user.{key}", value)
        except OSError:
            pass  # xattrs unsupported on some mounts — metadata-only op

    def removexattr(self, path, key):
        try:
            os.removexattr(self._abs(path), f"user.{key}")
        except OSError:
            pass

    def stat(self, path):
        try:
            st = os.lstat(self._abs(path))
        except FileNotFoundError:
            return StatResult(exists=False)
        import stat as stat_mod
        return StatResult(
            exists=True,
            is_dir=stat_mod.S_ISDIR(st.st_mode),
            is_symlink=stat_mod.S_ISLNK(st.st_mode),
            size=st.st_size,
            mtime=st.st_mtime,
            mode=stat_mod.S_IMODE(st.st_mode),
        )

    def readdir(self, path):
        return sorted(os.listdir(self._abs(path)))

    def readdir_plus(self, path):
        # one scandir pass: names + attrs without a stat syscall per entry
        import stat as stat_mod
        out = []
        with os.scandir(self._abs(path)) as it:
            for de in it:
                try:
                    st = de.stat(follow_symlinks=False)
                    out.append((de.name, StatResult(
                        exists=True,
                        is_dir=stat_mod.S_ISDIR(st.st_mode),
                        is_symlink=stat_mod.S_ISLNK(st.st_mode),
                        size=st.st_size,
                        mtime=st.st_mtime,
                        mode=stat_mod.S_IMODE(st.st_mode),
                    )))
                except OSError:
                    out.append((de.name, None))
        return sorted(out)

    # readdir_plus_vec: the StorageBackend loop default already pays one
    # scandir pass per directory through this class's readdir_plus

    def remove_tree(self, path):
        # one bottom-up walk instead of one syscall chain per engine op —
        # the local analogue of the single-roundtrip win on remote media
        root = self._abs(path)
        if os.path.islink(root) or os.path.isfile(root):
            try:
                os.unlink(root)
                return 1
            except FileNotFoundError:
                return 0
        if not os.path.isdir(root):
            return 0
        removed = 0
        for cur, dirs, files in os.walk(root, topdown=False):
            for name in files + [d for d in dirs
                                 if os.path.islink(os.path.join(cur, d))]:
                try:
                    os.unlink(os.path.join(cur, name))
                    removed += 1
                except FileNotFoundError:
                    pass
            for name in dirs:
                p = os.path.join(cur, name)
                if os.path.islink(p):
                    continue
                try:
                    os.rmdir(p)
                    removed += 1
                except FileNotFoundError:
                    pass
        try:
            os.rmdir(root)
            removed += 1
        except FileNotFoundError:
            pass
        return removed


# ---------------------------------------------------------------------------


class InMemoryBackend(StorageBackend):
    """Dict filesystem — the sequential oracle for property tests, and a
    zero-latency medium for engine micro-benchmarks.

    All methods raise the same OSErrors a POSIX fs would for the cases the
    engine/test-suite cares about (missing parent, missing file, non-empty
    rmdir)."""

    def __init__(self):
        self._lock = threading.RLock()
        self._files: dict[str, bytearray] = {}
        self._dirs: set[str] = {""}
        self._symlinks: dict[str, str] = {}
        self._meta: dict[str, dict] = {}
        # derived index: parent dir -> child basenames, kept in lockstep
        # with the three tables above so readdir/rmdir cost O(children)
        # instead of a full-table scan — the simulation sweeps walk
        # 10k-directory trees, where the scan is quadratic in tree size
        self._children: dict[str, set[str]] = {"": set()}

    # -- helpers --
    def _check_parent(self, path: str) -> None:
        par = parent_of(path)
        if par not in self._dirs:
            raise FileNotFoundError(f"no such directory: {par!r}")

    def _add_entry(self, path: str) -> None:
        self._children.setdefault(parent_of(path), set()).add(
            posixpath.basename(path))

    def _drop_entry(self, path: str) -> None:
        kids = self._children.get(parent_of(path))
        if kids is not None:
            kids.discard(posixpath.basename(path))

    def _scan_children(self, path: str) -> set[str]:
        """Brute-force recomputation of one directory's child basenames
        from the primary tables (tests cross-check the index with this)."""
        out = set()
        for pool in (self._files, self._dirs, self._symlinks):
            for k in pool:
                if k and parent_of(k) == path:
                    out.add(posixpath.basename(k))
        return out

    def _exists(self, path: str) -> bool:
        return path in self._files or path in self._dirs or path in self._symlinks

    def snapshot(self) -> dict:
        """Full state (for oracle comparison)."""
        with self._lock:
            return {
                "files": {k: bytes(v) for k, v in self._files.items()},
                "dirs": set(self._dirs),
                "symlinks": dict(self._symlinks),
            }

    # -- namespace --
    def mkdir(self, path):
        with self._lock:
            path = norm_path(path)
            self._check_parent(path)
            if self._exists(path):
                raise FileExistsError(path)
            self._dirs.add(path)
            self._add_entry(path)
            self._children.setdefault(path, set())

    def rmdir(self, path):
        with self._lock:
            path = norm_path(path)
            if path not in self._dirs:
                raise FileNotFoundError(path)
            if self._children.get(path):
                raise OSError(39, "directory not empty", path)
            self._dirs.discard(path)
            self._children.pop(path, None)
            self._drop_entry(path)

    def create(self, path):
        with self._lock:
            path = norm_path(path)
            self._check_parent(path)
            if path in self._dirs:
                raise IsADirectoryError(path)
            self._files[path] = bytearray()
            self._add_entry(path)

    def unlink(self, path):
        with self._lock:
            path = norm_path(path)
            if path in self._symlinks:
                del self._symlinks[path]
            elif path in self._files:
                del self._files[path]
            else:
                raise FileNotFoundError(path)
            self._drop_entry(path)

    def rename(self, src, dst):
        with self._lock:
            src, dst = norm_path(src), norm_path(dst)
            if not self._exists(src):
                raise FileNotFoundError(src)
            self._check_parent(dst)
            if src in self._files:
                self._files[dst] = self._files.pop(src)
                self._drop_entry(src)
                self._add_entry(dst)
            elif src in self._symlinks:
                self._symlinks[dst] = self._symlinks.pop(src)
                self._drop_entry(src)
                self._add_entry(dst)
            else:  # directory rename: move the whole subtree
                if self._exists(dst):
                    raise FileExistsError(dst)
                prefix = src + "/"
                for table in (self._files, self._symlinks):
                    for k in [k for k in table if k == src or k.startswith(prefix)]:
                        table[dst + k[len(src):]] = table.pop(k)
                for d in [d for d in self._dirs if d == src or d.startswith(prefix)]:
                    self._dirs.discard(d)
                    self._dirs.add(dst + d[len(src):])
                # the children index moves with the subtree: bucket keys
                # shift wholesale, membership only changes at the roots
                for k in [k for k in self._children
                          if k == src or k.startswith(prefix)]:
                    self._children[dst + k[len(src):]] = self._children.pop(k)
                self._drop_entry(src)
                self._add_entry(dst)

    def symlink(self, target, path):
        with self._lock:
            path = norm_path(path)
            self._check_parent(path)
            if self._exists(path):
                raise FileExistsError(path)
            self._symlinks[path] = target
            self._add_entry(path)

    def link(self, src, dst):
        with self._lock:
            src, dst = norm_path(src), norm_path(dst)
            if src not in self._files:
                raise FileNotFoundError(src)
            self._check_parent(dst)
            self._files[dst] = self._files[src]  # shared bytearray = hardlink
            self._add_entry(dst)

    def readlink(self, path):
        with self._lock:
            path = norm_path(path)
            if path not in self._symlinks:
                raise OSError(22, "not a symlink", path)
            return self._symlinks[path]

    # -- data --
    def write_at(self, path, offset, data):
        with self._lock:
            path = norm_path(path)
            if path not in self._files:
                self._check_parent(path)
                self._files[path] = bytearray()
                self._add_entry(path)
            buf = self._files[path]
            if len(buf) < offset:
                buf.extend(b"\0" * (offset - len(buf)))
            buf[offset:offset + len(data)] = data
            return len(data)

    def read_at(self, path, offset, size):
        with self._lock:
            path = norm_path(path)
            if path not in self._files:
                raise FileNotFoundError(path)
            buf = self._files[path]
            return bytes(buf[offset:] if size < 0 else buf[offset:offset + size])

    def truncate(self, path, size):
        with self._lock:
            path = norm_path(path)
            if path not in self._files:
                raise FileNotFoundError(path)
            buf = self._files[path]
            if len(buf) > size:
                del buf[size:]
            else:
                buf.extend(b"\0" * (size - len(buf)))

    def fallocate(self, path, size):
        with self._lock:
            path = norm_path(path)
            if path in self._files and len(self._files[path]) < size:
                self._files[path].extend(b"\0" * (size - len(self._files[path])))

    def fsync(self, path):
        pass

    # -- metadata --
    def _meta_set(self, path, **kw):
        path = norm_path(path)
        if not self._exists(path):
            raise FileNotFoundError(path)
        self._meta.setdefault(path, {}).update(kw)

    def chmod(self, path, mode):
        with self._lock:
            self._meta_set(path, mode=mode)

    def chown(self, path, uid, gid):
        with self._lock:
            self._meta_set(path, uid=uid, gid=gid)

    def utimens(self, path, atime, mtime):
        with self._lock:
            self._meta_set(path, mtime=mtime)

    def setxattr(self, path, key, value):
        with self._lock:
            self._meta_set(path, **{f"x:{key}": value})

    def removexattr(self, path, key):
        with self._lock:
            path = norm_path(path)
            self._meta.get(path, {}).pop(f"x:{key}", None)

    def stat(self, path):
        with self._lock:
            path = norm_path(path)
            meta = self._meta.get(path, {})
            if path in self._dirs:
                return StatResult(exists=True, is_dir=True,
                                  mode=meta.get("mode", 0o755),
                                  mtime=meta.get("mtime", 0.0))
            if path in self._files:
                return StatResult(exists=True, size=len(self._files[path]),
                                  mode=meta.get("mode", 0o644),
                                  mtime=meta.get("mtime", 0.0))
            if path in self._symlinks:
                return StatResult(exists=True, is_symlink=True,
                                  size=len(self._symlinks[path]))
            return StatResult(exists=False)

    def readdir(self, path):
        with self._lock:
            path = norm_path(path)
            if path not in self._dirs:
                raise FileNotFoundError(path)
            return sorted(self._children.get(path, ()))


# ---------------------------------------------------------------------------


METADATA_OPS = {
    "mkdir", "rmdir", "create", "unlink", "rename", "symlink", "link",
    "readlink", "truncate", "fallocate", "chmod", "chown", "utimens",
    "setxattr", "removexattr", "stat", "readdir", "fsync", "remove_tree",
}


class Clock:
    """Time source for latency simulation.  ``RealClock`` sleeps for real;
    ``VirtualClock`` only advances a counter, so latency+fault schedules
    replay deterministically and orders of magnitude faster in tests."""

    def now(self) -> float: raise NotImplementedError
    def sleep(self, dt: float) -> None: raise NotImplementedError


class RealClock(Clock):
    def now(self) -> float:
        return time.monotonic()

    def sleep(self, dt: float) -> None:
        if dt > 0:
            time.sleep(dt)


class VirtualClock(Clock):
    """Lock-protected simulated time.  ``sleep`` returns immediately after
    crediting the virtual elapsed time; ``now()`` is the total simulated
    seconds 'slept' so far across all threads (an upper bound on what a
    serial execution would have waited — per-op schedules stay exact).

    Virtual elapsed time is additionally accounted *per thread*:
    ``makespan()`` is the busiest single thread's accumulated wait, i.e.
    the parallel schedule's critical path when the executor keeps its
    workers balanced.  ``ops / makespan()`` is therefore a deterministic
    dispatch-throughput measure that genuinely rewards spreading ready
    ops across workers (the dispatch_guard benchmark) without a single
    real sleep."""

    def __init__(self, start: float = 0.0):
        self._lock = threading.Lock()
        self._now = float(start)
        self._per_thread: dict[int, float] = {}

    def now(self) -> float:
        with self._lock:
            return self._now

    def sleep(self, dt: float) -> None:
        if dt <= 0:
            return
        tid = threading.get_ident()
        with self._lock:
            self._now += dt
            self._per_thread[tid] = self._per_thread.get(tid, 0.0) + dt

    def makespan(self) -> float:
        """The longest per-thread accumulated virtual wait (0.0 when no
        thread has slept yet)."""
        with self._lock:
            return max(self._per_thread.values(), default=0.0)

    def thread_seconds(self) -> dict[int, float]:
        """Per-thread virtual seconds slept (thread ident -> seconds)."""
        with self._lock:
            return dict(self._per_thread)


@dataclass
class LatencyModel:
    """Calibrated to the paper's environment: NFSv3 over a single GbE port
    against NAS under varying cluster load.

    * per-op latency ~ lognormal(median=meta_ms, sigma=jitter_sigma)
    * data ops additionally pay size/bandwidth
    * the 'server' admits at most ``server_slots`` concurrent requests
      (client RPC slot table) — overlap beyond that queues, which is what
      bounds CannyFS's speedup to the bandwidth/concurrency roofline rather
      than letting it look infinitely good.
    * ``load`` scales the median (1.0 = quiet cluster; the paper's runs show
      ~5x spread between quiet and loaded — benchmark sweeps use 1..6).
    """

    meta_ms: float = 2.0
    data_ms: float = 2.0
    bandwidth_mb_s: float = 110.0   # GbE payload rate
    jitter_sigma: float = 0.45
    server_slots: int = 64
    load: float = 1.0
    seed: int = 0

    def latency_s(self, rng: random.Random, kind: str, nbytes: int) -> float:
        base_ms = self.meta_ms if kind in METADATA_OPS else self.data_ms
        lat = rng.lognormvariate(0.0, self.jitter_sigma) * base_ms * self.load / 1e3
        if nbytes > 0:
            lat += nbytes / (self.bandwidth_mb_s * 1e6)
        return lat


class LatencyBackend(StorageBackend):
    """Decorator that makes any backend behave like remote storage.

    Besides injecting the delays it also *measures* them: every executed
    call updates an EWMA of the round-trip time (metadata ops: the whole
    latency) and of the achieved bandwidth (data ops: payload over the
    service time past the RTT).  ``bdp_bytes()`` exposes the resulting
    bandwidth-delay product, which the optimizer uses to size write
    coalescing and bulk-remove batching to ~2x BDP instead of a fixed
    constant (ROADMAP item i) — the transactional window stays just wide
    enough that one fused op keeps the pipe full."""

    BDP_ALPHA = 0.2   # EWMA smoothing for the measured RTT / bandwidth

    def __init__(self, inner: StorageBackend, model: LatencyModel | None = None,
                 clock: Clock | None = None):
        self.inner = inner
        self.model = model or LatencyModel()
        self.clock = clock or RealClock()
        self._rng = random.Random(self.model.seed)
        self._rng_lock = threading.Lock()
        self._slots = threading.Semaphore(self.model.server_slots)
        # discrete-event mode (clock.discrete_event, core/simclock.py):
        # the semaphore would deadlock the cooperative scheduler (the one
        # running thread real-blocking on slot holders that only advance
        # when it yields), so server concurrency is modelled on the
        # virtual timeline instead — a heap of slot busy-until times; a
        # request arriving with all slots busy starts when the earliest
        # slot frees (M/G/c queueing, same roofline the semaphore enforced
        # in real time).  Guarded by _rng_lock like the other accounting.
        self._slot_heap: list[float] = []
        self.op_count = 0
        self.busy_s = 0.0  # total server-side service time (for utilization)
        # The RTT/bandwidth EWMAs are *seeded* from the model's nominal
        # figures (the lognormal's median RTT and the advertised payload
        # rate) rather than starting at None: before the seeding, the
        # fuser's first adaptive clamp saw a degenerate BDP and under-sized
        # the first cold fused batch.  Measured samples then pull the
        # estimate toward reality at BDP_ALPHA per op, exactly as before.
        self._rtt_ewma: Optional[float] = (
            self.model.meta_ms * self.model.load / 1e3)
        self._bw_ewma: Optional[float] = self.model.bandwidth_mb_s * 1e6

    def _delay(self, kind: str, nbytes: int = 0):
        a = self.BDP_ALPHA
        with self._rng_lock:
            lat = self.model.latency_s(self._rng, kind, nbytes)
            self.op_count += 1
            self.busy_s += lat
            if nbytes > 0:
                # bandwidth sample = payload over the service time past the
                # RTT; a jittered-down draw can land under the RTT EWMA,
                # and dividing by that sliver would explode the estimate —
                # skip non-positive samples instead
                svc = lat - (self._rtt_ewma or 0.0)
                if svc > 0:
                    bw = nbytes / svc
                    self._bw_ewma = (bw if self._bw_ewma is None
                                     else (1 - a) * self._bw_ewma + a * bw)
            else:
                self._rtt_ewma = (lat if self._rtt_ewma is None
                                  else (1 - a) * self._rtt_ewma + a * lat)
            if getattr(self.clock, "discrete_event", False):
                now = self.clock.now()
                heap = self._slot_heap
                while heap and heap[0] <= now:
                    heapq.heappop(heap)
                if len(heap) >= self.model.server_slots:
                    start = max(now, heapq.heappop(heap))
                else:
                    start = now
                heapq.heappush(heap, start + lat)
                wait = (start - now) + lat
            else:
                wait = -1.0
        if wait >= 0.0:
            self.clock.sleep(wait)
            return
        with self._slots:
            self.clock.sleep(lat)

    def bdp_bytes(self) -> Optional[float]:
        """Measured bandwidth-delay product in bytes.  The EWMAs are
        seeded from the model's nominal RTT and rate, so even the first
        cold call returns a usable estimate; measured samples refine it.
        Lock-free reads: float loads are atomic and a slightly stale EWMA
        only shifts the adaptive clamp by one smoothing step."""
        rtt = self._rtt_ewma
        if rtt is None:
            return None
        bw = self._bw_ewma
        if bw is None:
            bw = self.model.bandwidth_mb_s * 1e6
        return rtt * bw

    def cost_hint(self, op: str, nbytes: int = 0) -> Optional[CostHint]:
        """Per-op-class hint from the live EWMAs.  Data-plane classes use
        the calibrated bandwidth; metadata classes stream nothing.  The
        wrapped backend gets the first word: if the inner storage has its
        own cost model (object store behind a latency shaper), its
        structural costs (rename = copy+delete, paginated listings)
        dominate the shaper's uniform RTT and are what the fuser must
        hear about."""
        inner = getattr(self.inner, "cost_hint", None)
        if callable(inner):
            hint = inner(op, nbytes)
            if hint is not None:
                return hint
        rtt = self._rtt_ewma or (self.model.meta_ms * self.model.load / 1e3)
        bw = self._bw_ewma or (self.model.bandwidth_mb_s * 1e6)
        return CostHint(rtt_s=rtt, bytes_per_s=bw)

    def __getattr__(self, name):  # delegate non-op attrs
        return getattr(self.inner, name)

    # each primitive: pay the roundtrip, then do the real thing
    def mkdir(self, path): self._delay("mkdir"); self.inner.mkdir(path)
    def rmdir(self, path): self._delay("rmdir"); self.inner.rmdir(path)
    def create(self, path): self._delay("create"); self.inner.create(path)
    def unlink(self, path): self._delay("unlink"); self.inner.unlink(path)
    def rename(self, s, d): self._delay("rename"); self.inner.rename(s, d)
    def symlink(self, t, p): self._delay("symlink"); self.inner.symlink(t, p)
    def link(self, s, d): self._delay("link"); self.inner.link(s, d)
    def readlink(self, p): self._delay("readlink"); return self.inner.readlink(p)
    def write_at(self, p, o, data):
        self._delay("write", len(data)); return self.inner.write_at(p, o, data)
    def write_vec(self, p, segments):
        # one roundtrip for the whole fused vector: per-op latency is paid
        # once, bandwidth for the total payload — this is the coalescing win
        self._delay("write", sum(len(d) for _, d in segments))
        return self.inner.write_vec(p, segments)
    def read_at(self, p, o, size):
        out = self.inner.read_at(p, o, size)
        self._delay("read", len(out)); return out
    def truncate(self, p, s): self._delay("truncate"); self.inner.truncate(p, s)
    def fallocate(self, p, s): self._delay("fallocate"); self.inner.fallocate(p, s)
    def fsync(self, p): self._delay("fsync"); self.inner.fsync(p)
    def chmod(self, p, m): self._delay("chmod"); self.inner.chmod(p, m)
    def chown(self, p, u, g): self._delay("chown"); self.inner.chown(p, u, g)
    def utimens(self, p, a, m): self._delay("utimens"); self.inner.utimens(p, a, m)
    def setxattr(self, p, k, v): self._delay("setxattr"); self.inner.setxattr(p, k, v)
    def removexattr(self, p, k): self._delay("removexattr"); self.inner.removexattr(p, k)
    def stat(self, p): self._delay("stat"); return self.inner.stat(p)
    def readdir(self, p): self._delay("readdir"); return self.inner.readdir(p)
    def readdir_plus(self, p):
        # READDIRPLUS: one roundtrip returns names *and* attributes —
        # the overlay's whole-directory warm-up costs one op, not 1+N
        self._delay("readdir")
        return self.inner.readdir_plus(p)
    def readdir_plus_vec(self, paths):
        # ONE roundtrip for the whole batch of listings — the prefetch
        # pipeline's win: a cold walk pays dirs/batch RTTs, not dirs.
        # (The *batch width* is sized by the prefetcher from this
        # backend's live RTT/bandwidth EWMAs via bdp_bytes().)
        self._delay("readdir")
        return self.inner.readdir_plus_vec(paths)
    def stat_vec(self, paths):
        # ONE roundtrip for the whole batch of stats — the existence
        # batcher's win: a manifest-driven extract pays files/batch RTTs
        # for its journaling probes, not files (cf. readdir_plus_vec)
        self._delay("stat")
        return self.inner.stat_vec(paths)
    def read_vec(self, p, spans):
        # one roundtrip for the whole fused extent vector: per-op latency
        # once, bandwidth for the payload actually returned — the
        # read-side mirror of write_vec (ordering matches read_at: the
        # inner read resolves the true sizes, then the delay is paid)
        out = self.inner.read_vec(p, spans)
        self._delay("read", sum(len(b) for b in out))
        return out
    def remove_tree(self, p):
        # one roundtrip for the whole fused subtree removal — this is the
        # cross-path bulk-remove win (cf. write_vec for coalesced writes)
        self._delay("remove_tree")
        return self.inner.remove_tree(p)
