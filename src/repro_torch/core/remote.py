"""SFTP/WebDAV-style remote-stream backend.

``RemoteStreamBackend`` is the second production-shaped member of the
backend zoo: POSIX semantics (native rename, real directories, ranged
reads/writes) but **every operation is a high-RTT round-trip** while
**payload streaming is cheap** once a request is in flight — the SFTP
profile, where the protocol chatters per op but the encrypted stream
saturates the link.

The consequences the engine must exploit (and the cost hints advertise):

* metadata round-trips dominate — batching/pipelining wins linearly, so
  the vectored ops (``readdir_plus_vec``, ``stat_vec``, ``write_vec``,
  ``read_vec``, ``remove_tree``) cost ONE round-trip plus a small
  pipelined per-item overhead, exactly the accounting ``walk_guard``'s
  roundtrip bound is written against (``op_count`` counts public calls,
  so a fused batch is one op);
* rename is native and cheap (one round-trip) — the fuser's
  rename-retarget rule must NOT fire here, unlike the object store;
* streaming is cheap — the read-ahead window and fused write batches
  should grow toward the (large) bandwidth-delay product.

State is delegated to an internal ``InMemoryBackend`` oracle; this class
adds deterministic round-trip charging (no randomness) and the
``op_count``/``busy_s`` accounting the guards read.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Optional

from .backend import (Clock, CostHint, InMemoryBackend, StorageBackend,
                      VirtualClock)


@dataclass(frozen=True)
class RemoteStreamModel:
    """Deterministic SFTP-shaped cost parameters.

    * ``rtt_ms``        — per-request round-trip (high: every op pays it).
    * ``per_item_ms``   — marginal cost per extra item pipelined inside a
      vectored call (the stream is already open; each item is one more
      protocol packet, not one more round-trip).
    * ``bandwidth_mb_s``— streaming payload rate (cheap relative to RTT).
    """

    rtt_ms: float = 40.0
    per_item_ms: float = 0.5
    bandwidth_mb_s: float = 110.0

    @property
    def rtt_s(self) -> float:
        return self.rtt_ms / 1e3

    @property
    def per_item_s(self) -> float:
        return self.per_item_ms / 1e3

    @property
    def bytes_per_s(self) -> float:
        return self.bandwidth_mb_s * 1e6


class RemoteStreamBackend(StorageBackend):
    """High-RTT, cheap-streaming POSIX remote (see module docstring)."""

    def __init__(self, inner: Optional[InMemoryBackend] = None,
                 model: Optional[RemoteStreamModel] = None,
                 clock: Optional[Clock] = None):
        self.inner = inner if inner is not None else InMemoryBackend()
        self.model = model or RemoteStreamModel()
        self.clock = clock or VirtualClock()
        self._acct = threading.Lock()
        self.op_count = 0   # round-trips: one per public call, fused or not
        self.busy_s = 0.0

    def _roundtrip(self, nbytes: int = 0, extra_items: int = 0) -> None:
        lat = (self.model.rtt_s + extra_items * self.model.per_item_s
               + (nbytes / self.model.bytes_per_s if nbytes > 0 else 0.0))
        with self._acct:
            self.op_count += 1
            self.busy_s += lat
        self.clock.sleep(lat)

    # -- namespace (native: one round-trip each, rename included) ------

    def mkdir(self, p): self._roundtrip(); self.inner.mkdir(p)
    def rmdir(self, p): self._roundtrip(); self.inner.rmdir(p)
    def create(self, p): self._roundtrip(); self.inner.create(p)
    def unlink(self, p): self._roundtrip(); self.inner.unlink(p)
    def rename(self, s, d): self._roundtrip(); self.inner.rename(s, d)
    def symlink(self, t, p): self._roundtrip(); self.inner.symlink(t, p)
    def link(self, s, d): self._roundtrip(); self.inner.link(s, d)

    def readlink(self, p):
        out = self.inner.readlink(p)
        self._roundtrip(len(out))
        return out

    # -- data ----------------------------------------------------------

    def write_at(self, p, o, data):
        self._roundtrip(len(data))
        return self.inner.write_at(p, o, data)

    def write_vec(self, p, segments):
        # one round-trip for the fused vector; each extra segment is one
        # pipelined packet on the open stream
        self._roundtrip(sum(len(d) for _, d in segments),
                        extra_items=max(0, len(segments) - 1))
        return self.inner.write_vec(p, segments)

    def read_at(self, p, o, size):
        out = self.inner.read_at(p, o, size)
        self._roundtrip(len(out))
        return out

    def read_vec(self, p, spans):
        out = self.inner.read_vec(p, spans)
        self._roundtrip(sum(len(b) for b in out),
                        extra_items=max(0, len(spans) - 1))
        return out

    def truncate(self, p, s): self._roundtrip(); self.inner.truncate(p, s)
    def fallocate(self, p, s): self._roundtrip(); self.inner.fallocate(p, s)
    def fsync(self, p): self._roundtrip(); self.inner.fsync(p)

    # -- metadata ------------------------------------------------------

    def chmod(self, p, m): self._roundtrip(); self.inner.chmod(p, m)
    def chown(self, p, u, g): self._roundtrip(); self.inner.chown(p, u, g)
    def utimens(self, p, a, m): self._roundtrip(); self.inner.utimens(p, a, m)
    def setxattr(self, p, k, v):
        self._roundtrip(len(v)); self.inner.setxattr(p, k, v)
    def removexattr(self, p, k): self._roundtrip(); self.inner.removexattr(p, k)

    def stat(self, p):
        self._roundtrip()
        return self.inner.stat(p)

    def readdir(self, p):
        out = self.inner.readdir(p)
        self._roundtrip(extra_items=max(0, len(out) - 1))
        return out

    def readdir_plus(self, p):
        out = self.inner.readdir_plus(p)
        self._roundtrip(extra_items=max(0, len(out) - 1))
        return out

    def readdir_plus_vec(self, paths):
        # the prefetch pipeline's win on this medium: one round-trip for
        # the whole batch of listings, per-directory packets pipelined
        out = self.inner.readdir_plus_vec(paths)
        items = sum(len(v) for v in out.values()) + len(paths)
        self._roundtrip(extra_items=max(0, items - 1))
        return out

    def stat_vec(self, paths):
        self._roundtrip(extra_items=max(0, len(paths) - 1))
        return self.inner.stat_vec(paths)

    def remove_tree(self, p):
        removed = self.inner.remove_tree(p)
        self._roundtrip(extra_items=max(0, removed - 1))
        return removed

    # -- cost model ----------------------------------------------------

    def cost_hint(self, op: str, nbytes: int = 0) -> Optional[CostHint]:
        m = self.model
        # every class, rename included, is one round-trip: the fuser's
        # cost comparison sees rename ≈ create and never retargets here
        return CostHint(rtt_s=m.rtt_s, bytes_per_s=m.bytes_per_s,
                        per_request_overhead_s=m.per_item_s)

    # -- plumbing ------------------------------------------------------

    def snapshot(self) -> dict:
        return self.inner.snapshot()

    def __getattr__(self, name):
        return getattr(self.inner, name)
