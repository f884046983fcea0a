"""Architecture registry: the 10 assigned configs + reduced smoke variants.

``get_config(name)`` returns the exact published configuration;
``get_smoke_config(name)`` returns a tiny same-family variant for CPU tests.
"""
from __future__ import annotations

import importlib

ARCH_IDS = [
    "qwen2-vl-2b",
    "hubert-xlarge",
    "stablelm-12b",
    "stablelm-3b",
    "qwen2-7b",
    "h2o-danube-3-4b",
    "mamba2-130m",
    "llama4-scout-17b-a16e",
    "moonshot-v1-16b-a3b",
    "recurrentgemma-9b",
]

_MODULES = {name: "repro_torch.configs." + name.replace("-", "_")
            for name in ARCH_IDS}


def _load(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_IDS}")
    return importlib.import_module(_MODULES[name])


def get_config(name: str):
    return _load(name).CONFIG


def get_smoke_config(name: str):
    return _load(name).SMOKE
