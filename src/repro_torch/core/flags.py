"""Per-operation eagerness flags.

The paper: "Individual flags are provided for the eagerness status for
approximately 20 different I/O operations, roughly corresponding to different
POSIX I/O primitives. The default setting is that all of these are on."

An *eager* operation is acknowledged to the caller immediately and executed
in the background; a non-eager one is still routed through the same per-path
queues (to keep ordering) but the caller blocks until it really completed and
sees its error directly.  Data reads can never be eager.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class EagerFlags:
    # -- structural / namespace ops ------------------------------------
    mkdir: bool = True
    rmdir: bool = True
    remove_tree: bool = True     # fused bulk removal (rides rmdir's mode)
    create: bool = True          # file creation (open with O_CREAT)
    unlink: bool = True
    rename: bool = True
    symlink: bool = True
    link: bool = True            # hard link
    # -- data ops -------------------------------------------------------
    write: bool = True           # pwrite-style block write
    truncate: bool = True
    flush: bool = True           # close()/flush barrier per file
    fsync: bool = True
    fallocate: bool = True
    # -- metadata writes --------------------------------------------------
    chmod: bool = True
    chown: bool = True
    utimens: bool = True
    setxattr: bool = True
    removexattr: bool = True
    # -- metadata reads (mocking / caching, not deferral) ------------------
    # These three now parameterize the namespace overlay (core/namespace.py)
    # via OverlayPolicy.from_flags; an explicit CannyFS(overlay=...) policy
    # supersedes them.
    mock_stat: bool = True       # answer stat from the write-through cache
    readdir_prefetch: bool = True  # answer/warm readdir via the overlay
    negative_stat_cache: bool = True  # cache ENOENT results from unlink/rmdir

    def replace(self, **kw) -> "EagerFlags":
        return dataclasses.replace(self, **kw)

    @classmethod
    def all_off(cls) -> "EagerFlags":
        """Fully synchronous mode — the 'direct' baseline through the same
        code path (useful to isolate engine overhead from eagerness wins)."""
        return cls(**{f.name: False for f in dataclasses.fields(cls)})

    def is_eager(self, kind: str) -> bool:
        return bool(getattr(self, kind, False))


N_FLAGS = len(dataclasses.fields(EagerFlags))  # ~20, as in the paper
