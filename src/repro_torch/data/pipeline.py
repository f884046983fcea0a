"""Data pipeline: the synthetic LM corpus, shards staged through CannyFS
and the eager prefetcher, as in the reference (numpy throughout, so the
batches are bit-identical to the JAX package's for one seed).

The prefetcher applies the paper's pattern on the read side: a background
worker races ahead of the consumer; ``next()`` waits only for the batch it
needs.
"""
from __future__ import annotations

import io
import queue
import threading
from dataclasses import dataclass
from typing import Any, Callable, Iterator, Optional

import numpy as np

from repro_torch.core import CannyFS
from repro_torch.models.config import ModelConfig


# ---------------------------------------------------------------------------
# synthetic corpora (self-contained: no external datasets in-container)
# ---------------------------------------------------------------------------

@dataclass
class SyntheticLM:
    """Markov-ish token stream: next-token structure so a trained model's
    loss actually falls (used by the e2e example)."""
    cfg: ModelConfig
    batch: int
    seq_len: int
    seed: int = 0

    def __iter__(self) -> Iterator[dict]:
        rng = np.random.default_rng(self.seed)
        V = self.cfg.vocab_size
        # random sparse bigram table: each token has 8 likely successors
        succ = rng.integers(0, V, size=(V, 8), dtype=np.int32)
        while True:
            toks = np.empty((self.batch, self.seq_len + 1), np.int32)
            toks[:, 0] = rng.integers(0, V, size=self.batch)
            for t in range(self.seq_len):
                pick = rng.integers(0, 8, size=self.batch)
                nxt = succ[toks[:, t], pick]
                noise = rng.random(self.batch) < 0.1
                nxt = np.where(noise, rng.integers(0, V, size=self.batch),
                               nxt)
                toks[:, t + 1] = nxt
            batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
            if self.cfg.modality == "audio_stub":
                batch["features"] = rng.standard_normal(
                    (self.batch, self.seq_len, 512)).astype(np.float32)
                batch["loss_mask"] = np.ones((self.batch, self.seq_len),
                                             bool)
            if self.cfg.modality == "vision_stub":
                n_img = min(self.cfg.frontend_tokens or 16, self.seq_len // 2)
                batch["vision_embeds"] = rng.standard_normal(
                    (self.batch, n_img, self.cfg.d_model)).astype(np.float32)
                vm = np.zeros((self.batch, self.seq_len), bool)
                vm[:, 1:1 + n_img] = True
                batch["vision_mask"] = vm
                pos = np.tile(np.arange(self.seq_len, dtype=np.int32),
                              (3, self.batch, 1))
                batch["positions3"] = pos
            yield batch


# ---------------------------------------------------------------------------
# CannyFS-staged shard reader (data staged from 'remote' storage)
# ---------------------------------------------------------------------------

def write_shards(fs: CannyFS, directory: str, it: Iterator[dict],
                 n_shards: int) -> list[str]:
    """Materialize n_shards batches as .npz-style shard files through the
    eager engine (a staging job — the paper's archive-extraction shape)."""
    fs.makedirs(directory)
    paths = []
    for i in range(n_shards):
        batch = next(it)
        buf = io.BytesIO()
        np.savez(buf, **batch)
        p = f"{directory}/shard_{i:05d}.npz"
        fs.write_file(p, buf.getvalue())
        paths.append(p)
    return paths


def read_shards(fs: CannyFS, directory: str,
                chunk: int = 256 << 10) -> Iterator[dict]:
    """readdir-prefetched shard sweep (the paper's traversal acceleration
    applies: one readdir prefetches every shard's stat).

    Each shard streams back in ``chunk``-byte sequential slices rather
    than one whole-file read: the stat (warmed by the listing) bounds the
    stream so the reader never runs past EOF, and the engine's read-ahead
    plane pipelines speculative ``read_vec`` windows ahead of the
    consumer — later chunks are served from pages already in flight."""
    for name in fs.readdir(directory):
        if not name.endswith(".npz"):
            continue
        p = f"{directory}/{name}"
        remaining = fs.stat(p).size
        pieces = []
        with fs.open(p, "rb") as f:
            while remaining > 0:
                piece = f.read(min(chunk, remaining))
                if not piece:
                    break
                pieces.append(piece)
                remaining -= len(piece)
        with np.load(io.BytesIO(b"".join(pieces))) as z:
            yield {k: z[k] for k in z.files}


# ---------------------------------------------------------------------------
# eager prefetcher
# ---------------------------------------------------------------------------

class Prefetcher:
    """Bounded background prefetch: depth batches in flight; the queue bound
    is the same backpressure idea as the engine's max_inflight."""

    def __init__(self, it: Iterator[dict], depth: int = 2,
                 transform: Optional[Callable[[dict], Any]] = None):
        self._it = it
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._transform = transform
        self._done = object()
        self._thread = threading.Thread(target=self._fill, daemon=True,
                                        name="data-prefetch")
        self._thread.start()

    def _fill(self):
        try:
            for item in self._it:
                if self._transform is not None:
                    item = self._transform(item)
                self._q.put(item)
        finally:
            self._q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            raise StopIteration
        return item
