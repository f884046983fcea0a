"""Step factories: training (forward + backward + AdamW), evaluation,
and serving (prefill / decode); and the sharding bundles of a mesh.

The JAX versions are jitted with shardings over a mesh and GSPMD
partitions them.  Here each factory takes ``mesh=None``: without one the
step runs on one device, as it always has; with one (a ``DeviceMesh`` of
``launch.mesh``) every rank calls the step on its own shards
(``train_shardings`` / ``serve_shardings`` say which), and the step runs
the collectives explicitly: the model's tensor-parallel ones
(``ctx["constrain"]``), the data-parallel gradient sum (a token-weighted
mean: the CE numerator and denominator summed over the data axes), the
int8 pod sum under ``pod_grad_compress``, ZeRO-1's gather.  On the card
the forward runs the CUDA kernels on each rank's local shapes and the
backward their CUDA backward kernels (``kernels/ops.py``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

import torch

from repro_torch.models import (ModelConfig, decode_step, forward_train,
                                param_specs, prefill)
from repro_torch.models.layers import cast_tree, token_nll
from repro_torch.optim import AdamWConfig, adamw_update
from repro_torch.parallel import POLICIES
from repro_torch.parallel import collectives as C
from repro_torch.parallel.compress import compressed_grad_psum
from repro_torch.parallel.sharding import (P, activation_constrainer,
                                           batch_pspecs, cache_pspecs,
                                           dp_axes, make_shardings,
                                           param_pspecs, zero1_specs)
from repro_torch.tree import tree_leaves, tree_map


@dataclass(frozen=True)
class TrainConfig:
    dtype: Any = torch.bfloat16
    remat_policy: str = "dots_no_batch"     # one of parallel.POLICIES
    activation_mode: str = "dp"             # "dp" | "dp_sp"
    z_loss: float = 1e-4
    peak_lr: float = 3e-4
    adamw: AdamWConfig = field(default_factory=AdamWConfig)
    zero1: bool = True
    pod_grad_compress: bool = False      # int8 cross-pod gradient sum
    # the reference's scan over superblocks (False: unrolled, so XLA's cost
    # analysis counts every layer); eager torch has no compiled scan, so
    # the layer loop runs every layer under either value, and the dry-run
    # counts every layer either way
    scan_layers: bool = True
    loss_dtype: Any = torch.float32      # bfloat16: skip fp32 logits pass

    def __post_init__(self):
        if self.remat_policy not in POLICIES:
            raise ValueError(f"unknown remat policy {self.remat_policy!r}; "
                             f"options {POLICIES}")
        if self.activation_mode not in ("dp", "dp_sp"):
            raise ValueError(f"unknown activation mode "
                             f"{self.activation_mode!r}; options dp, dp_sp")


def make_loss_and_grad(cfg: ModelConfig, tc: TrainConfig = TrainConfig(),
                       *, mesh=None) -> Callable:
    """``fn(params, batch) -> (total, (loss, aux), grads)``, as
    ``jax.value_and_grad(loss_fn, has_aux=True)`` gives them: the loss is
    CE (with z-loss) + ``router_aux_coef`` · aux, and ``grads`` has the
    structure of ``params``.  The cast to ``tc.dtype`` (the reference's
    per-call ``cast_tree``) sits inside the graph, so the gradients reach
    the fp32 leaves; in fp32 it is the identity.  The forward checkpoints
    each superblock under ``tc.remat_policy``.

    On a ``mesh``: this rank's shards in, the loss of the global batch
    and this rank's shards of its gradient out (summed over the data
    axes; under ``pod_grad_compress`` averaged over ``pod`` by
    ``compressed_grad_psum``, each pod's loss its own batch's, as in the
    reference's pod ``shard_map``).  Without one the same body runs: the
    constrainer and the sums over no axes are identities."""
    pod = mesh is not None and _pod_compressed(mesh, tc)
    con = activation_constrainer(mesh, tc.activation_mode,
                                 exclude=("pod",) if pod else ())
    full = param_specs(cfg) if pod else None

    def loss_and_grad(params, batch):
        p, order = _grad_leaves(params)
        with torch.enable_grad():
            logits, aux = forward_train(cast_tree(p, tc.dtype), batch, cfg,
                                        dtype=tc.dtype,
                                        remat_policy=tc.remat_policy,
                                        constrain=con)
            num, den = _loss_sums(logits, batch, cfg, con, tc.z_loss,
                                  tc.loss_dtype)
            den = C.all_reduce(den, mesh, con.dp)[0].clamp(min=1.0)
            grads = _grads(num / den + cfg.router_aux_coef * aux, order, p)
        for g in tree_leaves(grads):
            C.all_reduce(g, mesh, con.dp)
        loss = C.all_reduce(num.detach().reshape(1), mesh, con.dp)[0] / den
        if pod:
            n = C.axis_size(mesh, "pod")
            scale_axes = tree_map(lambda s: ("model",) if s else (),
                                  model_sharded(params, full))
            grads = compressed_grad_psum(grads, mesh, "pod", n, scale_axes)
            loss = C.all_reduce(loss.reshape(1), mesh, ("pod",))[0] / n
        total = loss + cfg.router_aux_coef * aux.detach()
        return total, (loss, aux.detach()), grads

    return loss_and_grad


def _grad_leaves(params):
    """A copy of the tree whose leaves require grad, and those leaves."""
    leaves = {id(t): t.detach().requires_grad_()
              for t in tree_leaves(params)}
    return tree_map(lambda t: leaves[id(t)], params), list(leaves.values())


def _grads(total, order, p):
    grads = torch.autograd.grad(total, order, allow_unused=True)
    by_id = {id(t): torch.zeros_like(t) if g is None else g
             for t, g in zip(order, grads)}
    return tree_map(lambda t: by_id[id(t)], p)


def model_sharded(params, full) -> Any:
    """Which leaves of this rank's ``params`` are split over ``model``:
    those smaller than the whole tree's (``full``, e.g. ``param_specs``)."""
    return tree_map(lambda t, f: tuple(t.shape) != tuple(f.shape), params,
                    full)


def _pod_compressed(mesh, tc: TrainConfig) -> bool:
    return tc.pod_grad_compress and "pod" in mesh.mesh_dim_names


def _loss_sums(logits, batch, cfg: ModelConfig, con, z_loss: float = 0.0,
               compute_dtype=torch.float32):
    """This rank's CE numerator (sum over its tokens) and denominator."""
    vocab = con if logits.shape[-1] != cfg.vocab_size else None
    nll = token_nll(logits, batch["labels"], z_loss, compute_dtype, vocab)
    mask = batch.get("loss_mask")
    if mask is None:
        return nll.sum(), torch.full((1,), float(nll.numel()),
                                     device=nll.device)
    mask = mask.float()
    return (nll * mask).sum(), mask.sum().reshape(1)


def make_train_step(cfg: ModelConfig, tc: TrainConfig = TrainConfig(), *,
                    mesh=None) -> Callable:
    """``step(params, opt, batch, lr) -> (new_params, new_opt, metrics)``;
    the metric keys are the reference's.  On a ``mesh`` every argument is
    this rank's shard (moments split over ``data`` too under ZeRO-1, as
    ``train_shardings(..., zero1=True)`` places them)."""
    loss_and_grad = make_loss_and_grad(cfg, tc, mesh=mesh)
    full = param_specs(cfg) if mesh is not None else None

    def train_step(params, opt, batch, lr):
        total, (loss, aux), grads = loss_and_grad(params, batch)
        sharded = model_sharded(params, full) if mesh is not None else None
        with torch.no_grad():
            new_params, new_opt, om = adamw_update(
                grads, opt, params, lr, tc.adamw, mesh=mesh, sharded=sharded)
        metrics = {"loss": loss, "aux_loss": aux, "total_loss": total,
                   "grad_norm": om["grad_norm"], "lr": lr}
        return new_params, new_opt, metrics

    return train_step


def make_eval_step(cfg: ModelConfig, tc: TrainConfig = TrainConfig(), *,
                   mesh=None) -> Callable:
    con = activation_constrainer(mesh, tc.activation_mode)

    def eval_step(params, batch):
        with torch.no_grad():
            logits, _ = forward_train(cast_tree(params, tc.dtype), batch, cfg,
                                      dtype=tc.dtype, constrain=con)
            num, den = _loss_sums(logits, batch, cfg, con)
            both = C.all_reduce(torch.cat([num.reshape(1), den]), mesh,
                                con.dp)
        return {"loss": both[0] / both[1].clamp(min=1.0)}

    return eval_step


def make_encode_step(cfg: ModelConfig, *, dtype=torch.bfloat16,
                     mesh=None) -> Callable:
    """Encoder-only forward (hubert's prefill_32k): ``encode(params, batch)
    -> logits`` (B, S, V), under ``no_grad``; the weights cast to ``dtype``
    as the reference casts them per call (a no-op on weights already in
    it).  On a ``mesh``: this rank's batch rows, every word's logits."""
    con = activation_constrainer(mesh, "dp")

    def encode_step(params, batch):
        with torch.no_grad():
            logits, _ = forward_train(cast_tree(params, dtype), batch, cfg,
                                      dtype=dtype, constrain=con)
            if logits.shape[-1] != cfg.vocab_size:
                logits = con.gather_last(logits)
        return logits

    return encode_step


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def serve_extra_ctx(cfg: ModelConfig, mesh, batch: int, max_len: int) -> dict:
    """Decide KV-cache sequence sharding (-> distributed flash-decode).

    Heads shard on 'model' when divisible; otherwise the cache sequence dim
    is sharded — over 'model' only (batch still on dp) or over
    (data, model) when the batch itself is unshardable (long-context B=1).
    The port's context also carries ``max_len`` (a rank's cache holds a
    slice of the ring; the ring's length says which)."""
    msize = C.axis_size(mesh, "model")
    dp = dp_axes(mesh)
    dp_total = 1
    for a in dp:
        dp_total *= C.axis_size(mesh, a)
    extra: dict = {"mesh": mesh, "max_len": max_len}
    if cfg.num_kv_heads % msize == 0:
        return extra  # head-sharded KV; no seq sharding needed
    if batch % dp_total == 0 and batch > 1:
        if max_len % msize == 0:
            extra["kv_seq_axes"] = ("model",)
            extra["kv_batch_axes"] = dp
    else:
        axes = tuple(dp) + ("model",)
        if max_len % (dp_total * msize) == 0:
            extra["kv_seq_axes"] = axes
    return extra


def make_prefill_step(cfg: ModelConfig, *, dtype=torch.bfloat16, mesh=None,
                      batch: int | None = None,
                      max_len: int | None = None) -> Callable:
    """``prefill(params, batch_in, cache) -> (last logits, cache)``.  On a
    ``mesh``: this rank's shards of the parameters, batch and cache
    (``serve_shardings(..., batch, max_len)``), every word's logits."""
    con = activation_constrainer(mesh, "dp")
    extra = serve_extra_ctx(cfg, mesh, batch, max_len) \
        if mesh is not None else None

    def prefill_step(params, batch_in, cache):
        return prefill(params, batch_in, cache, cfg, dtype=dtype,
                       constrain=con, extra_ctx=extra)

    return prefill_step


def make_decode_step(cfg: ModelConfig, *, dtype=torch.bfloat16, mesh=None,
                     batch: int | None = None,
                     max_len: int | None = None) -> Callable:
    con = activation_constrainer(mesh, "dp")
    extra = serve_extra_ctx(cfg, mesh, batch, max_len) \
        if mesh is not None else None

    def serve_step(params, tokens, cache):
        logits, cache = decode_step(params, tokens, cache, cfg, dtype=dtype,
                                    constrain=con, extra_ctx=extra)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        return next_tok, logits, cache

    return serve_step


# ---------------------------------------------------------------------------
# sharding bundles (used by the trainer, the serving phase and checkpoint
# reshard)
# ---------------------------------------------------------------------------

def train_shardings(cfg: ModelConfig, mesh, params_shape, batch_shape, *,
                    zero1: bool = True, replicate_embed: bool = False):
    pspecs = param_pspecs(cfg, params_shape, mesh,
                          replicate_embed=replicate_embed)
    mv_specs = zero1_specs(pspecs, params_shape, mesh) if zero1 else pspecs
    opt_specs = {"m": mv_specs, "v": mv_specs, "count": P()}
    bspecs = batch_pspecs(cfg, batch_shape, mesh)
    return {
        "params": make_shardings(mesh, pspecs),
        "opt": make_shardings(mesh, opt_specs),
        "batch": make_shardings(mesh, bspecs),
        "pspecs": pspecs,
        "opt_specs": opt_specs,
        "batch_specs": bspecs,
    }


def serve_shardings(cfg: ModelConfig, mesh, params_shape, cache_shape,
                    batch: int, max_len: int):
    pspecs = param_pspecs(cfg, params_shape, mesh)
    extra = serve_extra_ctx(cfg, mesh, batch, max_len)
    cspecs = cache_pspecs(cfg, cache_shape, mesh,
                          seq_axes=extra.get("kv_seq_axes", ()))
    return {
        "params": make_shardings(mesh, pspecs),
        "cache": make_shardings(mesh, cspecs),
        "pspecs": pspecs,
        "cache_specs": cspecs,
    }
