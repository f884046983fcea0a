"""Step factories on one device: training (forward + backward + AdamW),
evaluation, and serving (prefill / decode).

The JAX versions are jitted with shardings over a mesh; on one card there
is none, and PyTorch runs eagerly, so the factories only bind the config
and the settings.  On the card the forward runs the CUDA kernels and the
backward their CUDA backward kernels (``kernels/ops.py``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

import torch

from repro_torch.models import ModelConfig, decode_step, forward_train, prefill
from repro_torch.models.layers import cast_tree, cross_entropy
from repro_torch.optim import AdamWConfig, adamw_update
from repro_torch.parallel import POLICIES
from repro_torch.tree import tree_leaves, tree_map


@dataclass(frozen=True)
class TrainConfig:
    dtype: Any = torch.bfloat16
    remat_policy: str = "dots_no_batch"     # one of parallel.POLICIES
    z_loss: float = 1e-4
    peak_lr: float = 3e-4
    adamw: AdamWConfig = field(default_factory=AdamWConfig)
    loss_dtype: Any = torch.float32      # bfloat16: skip fp32 logits pass

    def __post_init__(self):
        if self.remat_policy not in POLICIES:
            raise ValueError(f"unknown remat policy {self.remat_policy!r}; "
                             f"options {POLICIES}")


def make_loss_and_grad(cfg: ModelConfig,
                       tc: TrainConfig = TrainConfig()) -> Callable:
    """``fn(params, batch) -> (total, (loss, aux), grads)``, as
    ``jax.value_and_grad(loss_fn, has_aux=True)`` gives them: the loss is
    CE (with z-loss) + ``router_aux_coef`` · aux, and ``grads`` has the
    structure of ``params``.  The cast to ``tc.dtype`` (the reference's
    per-call ``cast_tree``) sits inside the graph, so the gradients reach
    the fp32 leaves; in fp32 it is the identity.  The forward checkpoints
    each superblock under ``tc.remat_policy``."""
    def loss_and_grad(params, batch):
        leaves = {id(t): t.detach().requires_grad_()
                  for t in tree_leaves(params)}
        p = tree_map(lambda t: leaves[id(t)], params)
        with torch.enable_grad():
            logits, aux = forward_train(cast_tree(p, tc.dtype), batch, cfg,
                                        dtype=tc.dtype,
                                        remat_policy=tc.remat_policy)
            loss, _ = cross_entropy(logits, batch["labels"],
                                    batch.get("loss_mask"), z_loss=tc.z_loss,
                                    compute_dtype=tc.loss_dtype)
            total = loss + cfg.router_aux_coef * aux
            order = list(leaves.values())
            grads = torch.autograd.grad(total, order, allow_unused=True)
        by_id = {id(t): torch.zeros_like(t) if g is None else g
                 for t, g in zip(order, grads)}
        return (total.detach(), (loss.detach(), aux.detach()),
                tree_map(lambda t: by_id[id(t)], p))

    return loss_and_grad


def make_train_step(cfg: ModelConfig,
                    tc: TrainConfig = TrainConfig()) -> Callable:
    """``step(params, opt, batch, lr) -> (new_params, new_opt, metrics)``;
    the metric keys are the reference's."""
    loss_and_grad = make_loss_and_grad(cfg, tc)

    def train_step(params, opt, batch, lr):
        total, (loss, aux), grads = loss_and_grad(params, batch)
        with torch.no_grad():
            new_params, new_opt, om = adamw_update(grads, opt, params, lr,
                                                   tc.adamw)
        metrics = {"loss": loss, "aux_loss": aux, "total_loss": total,
                   "grad_norm": om["grad_norm"], "lr": lr}
        return new_params, new_opt, metrics

    return train_step


def make_eval_step(cfg: ModelConfig,
                   tc: TrainConfig = TrainConfig()) -> Callable:
    def eval_step(params, batch):
        with torch.no_grad():
            logits, _ = forward_train(cast_tree(params, tc.dtype), batch, cfg,
                                      dtype=tc.dtype)
            loss, _ = cross_entropy(logits, batch["labels"],
                                    batch.get("loss_mask"))
        return {"loss": loss}

    return eval_step


def make_encode_step(cfg: ModelConfig, *, dtype=torch.bfloat16) -> Callable:
    """Encoder-only forward (hubert's prefill_32k): ``encode(params, batch)
    -> logits`` (B, S, V), under ``no_grad``; the weights cast to ``dtype``
    as the reference casts them per call (a no-op on weights already in
    it)."""
    def encode_step(params, batch):
        with torch.no_grad():
            logits, _ = forward_train(cast_tree(params, dtype), batch, cfg,
                                      dtype=dtype)
        return logits

    return encode_step


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

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
