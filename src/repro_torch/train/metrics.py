"""Metrics/log writer — an eager, write-only stream (the paper's best case:
"performs most consistently when a task creates files ... without ever
reading them back")."""
from __future__ import annotations

import json
import time
from typing import Any

from repro_torch.core import CannyFS


class MetricsWriter:
    def __init__(self, fs: CannyFS, path: str = "logs/metrics.jsonl"):
        self.fs = fs
        self.path = path
        parent = path.rsplit("/", 1)[0] if "/" in path else ""
        if parent:
            fs.makedirs(parent)
        self._f = fs.open(path, "wb")

    def write(self, step: int, metrics: dict[str, Any]) -> None:
        rec = {"step": step, "t": time.time()}
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = str(v)
        self._f.write((json.dumps(rec) + "\n").encode())

    def close(self) -> None:
        self._f.close()
