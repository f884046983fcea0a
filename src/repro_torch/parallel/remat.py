"""Activation-checkpoint (remat) policies for the layer stack.

Policies (the reference's names and meanings):

    none          — save everything (max memory, min recompute)
    full          — save nothing inside the wrapped function (min memory,
                    max recompute)
    dots          — save the output of every matrix product (jax's
                    dots_saveable)
    dots_no_batch — save only the products without batch dims (jax's
                    dots_with_no_batch_dims_saveable, Megatron-style
                    'selective' checkpointing: saves projections,
                    recomputes attention/softmax)

Each is ``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``:
the backward reruns the wrapped function's forward where it needs a saved
tensor (the reentrant variant would drop the gradients of tensors passed
inside the dict of layer parameters).  The two selective policies keep the
outputs of the products the dispatcher sees: ``aten.mm`` / ``addmm`` and
``aten.bmm`` / ``baddbmm``.  ``x @ w`` on a (B, S, D) input that needs a
gradient folds to ``mm``; ``torch.einsum`` reaches ``bmm``, whose leading
dim is the product of the einsum's batch indices, 1 where it has none (the
MoE experts' stacked products and the CPU path's attention have them).

The kernels' ``autograd.Function``s (flash attention, RMSNorm, the RG-LRU
and SSD scans) launch through ctypes, so no dispatcher op carries their
outputs: under every policy but ``none`` the backward runs them again.
Under ``dots`` that differs from JAX, which would keep attention's score
products: the fused kernel forms none to keep.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

POLICIES = ("none", "full", "dots", "dots_no_batch")

_aten = torch.ops.aten
# each product op, and the index of the argument whose leading dim is the
# batch (None: the op has no batch dim)
_PRODUCTS = {_aten.mm.default: None, _aten.addmm.default: None,
             _aten.bmm.default: 0, _aten.baddbmm.default: 1}


def _save(keep: bool) -> CheckpointPolicy:
    return (CheckpointPolicy.MUST_SAVE if keep
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return _save(op in _PRODUCTS)


def _dots_no_batch(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    if op not in _PRODUCTS:
        return _save(False)
    batch = _PRODUCTS[op]
    return _save(batch is None or args[batch].shape[0] == 1)


_SELECTIVE = {"dots": _dots, "dots_no_batch": _dots_no_batch}


def wrap_remat(fn, policy: str):
    """``fn`` under ``policy``: ``fn`` itself for ``None`` / ``"none"``,
    else a function of the same arguments that runs it as one checkpoint.
    The model's forward draws no random numbers, so no RNG state is kept
    for the rerun."""
    if policy in (None, "none"):
        return fn
    if policy == "full":
        context_fn = noop_context_fn
    elif policy in _SELECTIVE:
        context_fn = functools.partial(create_selective_checkpoint_contexts,
                                       _SELECTIVE[policy])
    else:
        raise ValueError(f"unknown remat policy {policy!r}; options "
                         f"{POLICIES}")

    @functools.wraps(fn)
    def remat(*args, **kwargs):
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False, context_fn=context_fn,
                          **kwargs)

    return remat
