"""The raw kernel wrappers' guard against a silently dropped gradient.

A wrapper writes into a fresh tensor through ctypes, so its output has no
``grad_fn``: called on inputs that require a gradient, with grad mode on,
it would cut the graph and training would go on with zero gradients below
it.  So each raw wrapper refuses that call.  Every kernel is differentiated
through its ``torch.autograd.Function`` (``RMSNormFunction``,
``FlashAttentionFunction``, ``RGLRUFunction``, ``SSDFunction``), whose
forward runs with grad mode off; ``kernels/ops.py`` routes to them.
"""
from __future__ import annotations

import torch


def refuse_grad(name: str, tensors, remedy: str) -> None:
    """Raise if grad mode is on and any of ``tensors`` requires a grad."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no gradient of its own: called on inputs that "
            f"require grad it would drop them; {remedy}")
