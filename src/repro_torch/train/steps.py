"""Serving steps: prefill and greedy decode, on one device.

The JAX versions also decide KV-cache sequence sharding over a mesh; on one
card there is none, so the steps only bind the config and the dtype.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models import ModelConfig, decode_step, prefill


def make_prefill_step(cfg: ModelConfig, *, dtype=torch.bfloat16) -> Callable:
    def prefill_step(params, batch_in, cache):
        return prefill(params, batch_in, cache, cfg, dtype=dtype)

    return prefill_step


def make_decode_step(cfg: ModelConfig, *, dtype=torch.bfloat16) -> Callable:
    def serve_step(params, tokens, cache):
        logits, cache = decode_step(params, tokens, cache, cfg, dtype=dtype)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        return next_tok, logits, cache

    return serve_step
