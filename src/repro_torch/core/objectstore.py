"""S3-style object-store backend.

``ObjectStoreBackend`` presents the POSIX-shaped ``StorageBackend``
surface the engine speaks while *costing* every call the way a flat-
keyspace object store would bill it:

* **no native rename** — ``rename`` is a server-side COPY per key plus a
  DELETE per key (a directory move pays it for every key under the
  prefix), which is why cost-aware fusion defers/elides renames far more
  aggressively here than on POSIX media;
* **whole-object PUT** — there is no ranged write: ``write_at`` that
  does not rewrite the object from offset 0 becomes a read-modify-write
  (GET the old object + PUT the new one), so ``write_vec`` coalescing is
  mandatory, not an optimization — one fused vector is exactly one
  whole-object PUT;
* **paginated listings** — there is no readdir: ``list_by_prefix``
  returns at most ``list_page_size`` keys per request with an S3-style
  continuation token (the last key returned; the next page is every key
  strictly greater — robust to keys inserted or deleted between pages),
  and ``readdir``/``remove_tree`` pay one LIST request per page;
* **per-request + per-byte cost model** — each wire request costs
  ``rtt_ms`` (or only ``per_request_ms`` when pipelined behind a
  previous request of the same call: continuation pages, HEAD batches,
  ranged-GET vectors), plus payload over ``bandwidth_mb_s``.

State semantics are delegated to an internal ``InMemoryBackend`` so the
property suites can compare an object-store run against the POSIX
oracle byte-for-byte (same errors, same final ``snapshot()``) — the
class adds *accounting* (``request_count``, ``requests_by_class``,
``whole_object_puts``, ``rmw_gets``) and deterministic clock charging,
never behavioral divergence.  There is no randomness: same op stream in,
same request stream and virtual timeline out.
"""
from __future__ import annotations

import math
import threading
from dataclasses import dataclass
from typing import Optional

from .backend import (Clock, CostHint, InMemoryBackend, StorageBackend,
                      VirtualClock, norm_path)


@dataclass(frozen=True)
class ObjectStoreModel:
    """Request-billing parameters (deterministic — no jitter).

    * ``rtt_ms``            — full round-trip for a fresh request.
    * ``per_request_ms``    — marginal cost of a request pipelined behind
      another in the same call (continuation LIST pages, HEADs past the
      first in a ``stat_vec`` batch, per-key COPY/DELETEs of a dir move).
    * ``bandwidth_mb_s``    — payload streaming rate once in flight.
    * ``list_page_size``    — max keys per LIST response.
    """

    rtt_ms: float = 25.0
    per_request_ms: float = 2.0
    bandwidth_mb_s: float = 200.0
    list_page_size: int = 1000

    @property
    def rtt_s(self) -> float:
        return self.rtt_ms / 1e3

    @property
    def per_request_s(self) -> float:
        return self.per_request_ms / 1e3

    @property
    def bytes_per_s(self) -> float:
        return self.bandwidth_mb_s * 1e6


_REQUEST_CLASSES = ("put", "get", "list", "delete", "copy", "head")


class ObjectStoreBackend(StorageBackend):
    """Flat-keyspace object store over an in-memory oracle (see module
    docstring for the request model)."""

    def __init__(self, inner: Optional[InMemoryBackend] = None,
                 model: Optional[ObjectStoreModel] = None,
                 clock: Optional[Clock] = None):
        self.inner = inner if inner is not None else InMemoryBackend()
        self.model = model or ObjectStoreModel()
        self.clock = clock or VirtualClock()
        self.list_page_size = self.model.list_page_size
        self._acct = threading.Lock()
        self.op_count = 0            # public StorageBackend calls
        self.request_count = 0       # wire requests those calls issued
        self.requests_by_class = {c: 0 for c in _REQUEST_CLASSES}
        self.whole_object_puts = 0   # data PUTs that rewrote a whole object
        self.rmw_gets = 0            # GETs forced by a non-covering write
        self.busy_s = 0.0            # total charged service time

    # -- accounting ---------------------------------------------------

    def _request(self, cls: str, nbytes: int = 0, *,
                 pipelined: bool = False) -> None:
        lat = self.model.per_request_s if pipelined else self.model.rtt_s
        if nbytes > 0:
            lat += nbytes / self.model.bytes_per_s
        with self._acct:
            self.request_count += 1
            self.requests_by_class[cls] += 1
            self.busy_s += lat
        self.clock.sleep(lat)

    def _call(self) -> None:
        with self._acct:
            self.op_count += 1

    def _size_of(self, path: str) -> int:
        try:
            st = self.inner.stat(path)
        except OSError:
            return 0
        return st.size if st.exists and not st.is_dir else 0

    def _keys_under(self, prefix: str) -> list[str]:
        """Every object key at/under ``prefix`` in the flat keyspace:
        file and symlink objects plus the ``dir/`` marker objects."""
        prefix = norm_path(prefix)
        snap = self.inner.snapshot()
        keys = list(snap["files"]) + list(snap["symlinks"])
        keys += [d + "/" for d in snap["dirs"] if d]
        if prefix:
            keys = [k for k in keys
                    if k == prefix or k.startswith(prefix + "/")
                    or k == prefix + "/"]
        return sorted(keys)

    # -- the paginated listing primitive ------------------------------

    def list_by_prefix(self, prefix: str, token: Optional[str] = None,
                       page_size: Optional[int] = None,
                       ) -> tuple[list[str], Optional[str]]:
        """One LIST request: up to ``page_size`` keys under ``prefix``
        strictly greater than ``token`` (S3 continuation semantics: the
        token is the last key of the previous page, so a key inserted
        before it is missed and one deleted after it simply never
        appears — exactly the anomaly the overlay's speculation tickets
        must catch).  Returns ``(keys, next_token)`` with ``next_token
        is None`` iff nothing remains.  The first page of a call pays the
        full RTT; continuation pages are requested a page ahead and pay
        only the pipelined per-request overhead."""
        self._call()
        page = int(page_size or self.list_page_size)
        keys = self._keys_under(prefix)
        if token is not None:
            keys = [k for k in keys if k > token]
        out = keys[:page]
        self._request("list", pipelined=token is not None)
        next_token = out[-1] if len(keys) > page else None
        return out, next_token

    def _list_all(self, prefix: str) -> tuple[list[str], int]:
        """Drain the paginated listing; returns (keys, n_pages)."""
        keys: list[str] = []
        token: Optional[str] = None
        pages = 0
        while True:
            page, token = self.list_by_prefix(prefix, token)
            with self._acct:      # inner pages are one public call
                self.op_count -= 1
            keys.extend(page)
            pages += 1
            if token is None:
                return keys, pages

    # -- namespace -----------------------------------------------------

    def mkdir(self, path):
        self._call()
        self.inner.mkdir(path)          # oracle errors before billing
        self._request("put")            # PUT the dir/ marker object

    def rmdir(self, path):
        self._call()
        self.inner.rmdir(path)
        self._request("list")           # emptiness probe (one page)
        self._request("delete", pipelined=True)   # drop the marker

    def create(self, path):
        self._call()
        self.inner.create(path)
        self._request("put")            # PUT an empty object

    def unlink(self, path):
        self._call()
        self.inner.unlink(path)
        self._request("delete")

    def symlink(self, target, path):
        self._call()
        self.inner.symlink(target, path)
        self._request("put", len(target))

    def link(self, src, dst):
        self._call()
        nbytes = self._size_of(src)
        self.inner.link(src, dst)
        self._request("copy", nbytes)   # no hardlinks: server-side copy

    def readlink(self, path):
        self._call()
        out = self.inner.readlink(path)
        self._request("get", len(out))
        return out

    def rename(self, src, dst):
        """No native rename: COPY + DELETE per key.  A file move is two
        requests; a directory move pays the pair for every key under the
        prefix plus the marker — the cost the fuser's rename-retarget
        rule exists to avoid."""
        self._call()
        src_n, dst_n = norm_path(src), norm_path(dst)
        try:
            st = self.inner.stat(src_n)
        except OSError:
            st = None
        if st is not None and st.exists and st.is_dir and not st.is_symlink:
            keys = self._keys_under(src_n)
        else:
            keys = [src_n]
        self.inner.rename(src, dst)     # oracle errors before billing
        first = True
        for key in keys:
            nbytes = 0 if key.endswith("/") else self._size_of(
                norm_path(dst_n + key[len(src_n):]) if key != src_n
                else dst_n)
            self._request("copy", nbytes, pipelined=not first)
            self._request("delete", pipelined=True)
            first = False

    # -- data ----------------------------------------------------------

    def write_at(self, path, offset, data):
        """Whole-object PUT.  A write that rewrites the object from
        offset 0 is one PUT; anything else is read-modify-write: GET the
        current object, splice, PUT the result."""
        self._call()
        prior = self._size_of(path)
        covering = offset == 0 and len(data) >= prior
        n = self.inner.write_at(path, offset, data)
        new_size = self._size_of(path)
        if not covering:
            with self._acct:
                self.rmw_gets += 1
            self._request("get", prior)
        with self._acct:
            self.whole_object_puts += 1
        self._request("put", new_size, pipelined=not covering)
        return n

    def write_vec(self, path, segments):
        """ONE whole-object PUT for the fused vector (the coalescing
        win this backend makes mandatory).  Still read-modify-write when
        the vector does not itself rebuild the object from offset 0."""
        self._call()
        prior = self._size_of(path)
        covering = self._covers(segments, prior)
        n = self.inner.write_vec(path, segments)
        new_size = self._size_of(path)
        if not covering:
            with self._acct:
                self.rmw_gets += 1
            self._request("get", prior)
        with self._acct:
            self.whole_object_puts += 1
        self._request("put", new_size, pipelined=not covering)
        return n

    @staticmethod
    def _covers(segments, prior_size: int) -> bool:
        """Does the segment vector rewrite the object from offset 0
        through at least its prior size, with no gaps?"""
        spans = sorted((off, off + len(d)) for off, d in segments)
        if not spans or spans[0][0] != 0:
            return False
        end = 0
        for lo, hi in spans:
            if lo > end:
                return False
            end = max(end, hi)
        return end >= prior_size

    def read_at(self, path, offset, size):
        self._call()
        out = self.inner.read_at(path, offset, size)
        self._request("get", len(out))
        return out

    def read_vec(self, path, spans):
        # ranged GETs pipelined on one connection: first span pays the
        # RTT, the rest only the per-request overhead — the read-ahead
        # layer's fused extent vector stays one round-trip wide
        self._call()
        out = self.inner.read_vec(path, spans)
        for i, chunk in enumerate(out):
            self._request("get", len(chunk), pipelined=i > 0)
        return out

    def truncate(self, path, size):
        self._call()
        prior = self._size_of(path)
        self.inner.truncate(path, size)
        if size > 0:
            with self._acct:
                self.rmw_gets += 1
            self._request("get", prior)
        with self._acct:
            self.whole_object_puts += 1
        self._request("put", self._size_of(path), pipelined=size > 0)

    def fallocate(self, path, size):
        self._call()
        prior = self._size_of(path)
        self.inner.fallocate(path, size)
        new = self._size_of(path)
        if new != prior:
            with self._acct:
                self.rmw_gets += 1
                self.whole_object_puts += 1
            self._request("get", prior)
            self._request("put", new, pipelined=True)

    def fsync(self, path):
        # PUTs are atomic + durable on completion — fsync is free wire-
        # wise, which is itself a cost signal the fuser can exploit
        self._call()
        self.inner.fsync(path)

    # -- metadata: billed as a self-COPY (S3 metadata is immutable per
    # object version, so changing it rewrites the object server-side) --

    def _meta_copy(self, path):
        self._request("copy", self._size_of(path))

    def chmod(self, path, mode):
        self._call(); self.inner.chmod(path, mode); self._meta_copy(path)

    def chown(self, path, uid, gid):
        self._call(); self.inner.chown(path, uid, gid); self._meta_copy(path)

    def utimens(self, path, atime, mtime):
        self._call(); self.inner.utimens(path, atime, mtime)
        self._meta_copy(path)

    def setxattr(self, path, key, value):
        self._call(); self.inner.setxattr(path, key, value)
        self._meta_copy(path)

    def removexattr(self, path, key):
        self._call(); self.inner.removexattr(path, key)
        self._meta_copy(path)

    # -- attributes / listing ------------------------------------------

    def stat(self, path):
        self._call()
        self._request("head")
        return self.inner.stat(path)

    def stat_vec(self, paths):
        # HEADs pipelined on one connection (first pays the RTT)
        self._call()
        for i in range(len(paths)):
            self._request("head", pipelined=i > 0)
        return self.inner.stat_vec(paths)

    def readdir(self, path):
        self._call()
        names = self.inner.readdir(path)
        self._charge_listing(len(names))
        return names

    def readdir_plus(self, path):
        # LIST responses carry size+mtime per key, so the plus variant
        # costs the same pages as the plain listing
        self._call()
        out = self.inner.readdir_plus(path)
        self._charge_listing(len(out))
        return out

    def readdir_plus_vec(self, paths):
        self._call()
        out = self.inner.readdir_plus_vec(paths)
        first = True
        for listing in out.values():
            self._charge_listing(len(listing), pipelined=not first)
            first = False
        return out

    def _charge_listing(self, n_entries: int, *,
                        pipelined: bool = False) -> None:
        pages = max(1, math.ceil(n_entries / self.list_page_size))
        for i in range(pages):
            self._request("list", pipelined=pipelined or i > 0)

    def remove_tree(self, path):
        """LIST the prefix (one request per page) then ONE unbounded
        bulk DELETE — ceil(keys/page) + 1 requests total, never a DELETE
        per key.  This is the bound ``benchmarks.backend_guard`` holds
        the engine to for extract→rmtree."""
        self._call()
        keys, pages = self._list_all(path)
        removed = self.inner.remove_tree(path)
        if keys:
            self._request("delete", pipelined=True)   # bulk multi-delete
        return removed

    # -- cost model ----------------------------------------------------

    def cost_hint(self, op: str, nbytes: int = 0) -> Optional[CostHint]:
        m = self.model
        if op == "rename":
            # copy+delete: two fresh-request RTTs before any payload
            return CostHint(rtt_s=2 * m.rtt_s, bytes_per_s=m.bytes_per_s,
                            per_request_overhead_s=m.per_request_s)
        if op in ("readdir", "list", "stat", "remove_tree"):
            # paginated / pipelined classes: continuation requests only
            # pay the per-request overhead
            return CostHint(rtt_s=m.rtt_s, bytes_per_s=m.bytes_per_s,
                            per_request_overhead_s=m.per_request_s)
        return CostHint(rtt_s=m.rtt_s, bytes_per_s=m.bytes_per_s)

    # -- plumbing ------------------------------------------------------

    def snapshot(self) -> dict:
        return self.inner.snapshot()

    def __getattr__(self, name):  # delegate anything else to the oracle
        return getattr(self.inner, name)
