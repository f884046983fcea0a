"""The port's training slice against the JAX package, on the CPU.

The loss, the schedules, AdamW, one train step (loss and gradients against
``jax.value_and_grad`` through bridged weights), the synthetic corpus and
the prefetcher, the engine copy and the training loop with transactional
checkpoints.  Inputs are made with numpy and handed to both packages.
Tolerances: the train step's loss and gradients 2e-4 relative to each
leaf's largest value (the JAX suite's decode-vs-forward bound), fp32;
AdamW 1e-6 on identical gradients; the corpus bit for bit.
"""
import dataclasses
import json
import random
import runpy
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
import repro.core as jax_core
from repro.data import Prefetcher as JaxPrefetcher
from repro.data import SyntheticLM as JaxSyntheticLM
from repro.data import read_shards as jax_read_shards
from repro.data import write_shards as jax_write_shards
from repro.models import cross_entropy as jax_cross_entropy
from repro.models import forward_train as jax_forward_train
from repro.models import init_params as jax_init_params
from repro.models.config import ModelConfig as JaxModelConfig
from repro.optim import adamw_update as jax_adamw_update
from repro.optim import constant as jax_constant
from repro.optim import cosine_with_warmup as jax_cosine
from repro.optim import init_opt_state as jax_init_opt_state
from repro_torch.configs import ARCH_IDS, get_smoke_config
import repro_torch.core as torch_core
from repro_torch.core import CannyFS, InMemoryBackend
from repro_torch.data import Prefetcher, SyntheticLM, read_shards, write_shards
from repro_torch.models import cross_entropy, forward_train, init_params
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.config import ModelConfig
from repro_torch.optim import (AdamWConfig, adamw_update, constant,
                               cosine_with_warmup, global_norm,
                               init_opt_state)
from repro_torch.train.loop import LoopConfig, Trainer, run_with_restarts
from repro_torch.train.steps import (TrainConfig, make_eval_step,
                                     make_loss_and_grad, make_train_step)
from repro_torch.tree import tree_leaves

ROOT = Path(__file__).resolve().parents[1]
REL = 2e-4
ENGINE_FILES = ("backend", "durability", "engine", "errors", "executor",
                "flags", "fusion", "namespace", "prefetch", "readahead",
                "scheduler", "simclock", "tenancy", "fs", "transaction",
                "faults", "objectstore", "remote")

sys.path.insert(0, str(ROOT / "examples"))
from train_lm_torch import PRESETS, preset_config  # noqa: E402

sys.path.pop(0)


def _jax_cfg(cfg: ModelConfig) -> JaxModelConfig:
    """The JAX package's config with the same fields."""
    return JaxModelConfig(**{f: getattr(cfg, f)
                             for f in cfg.__dataclass_fields__})


def _rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max()
                 / max(float(np.abs(want).max()), 1e-30))


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_cross_entropy_matches_jax(z_loss, with_mask, compute_dtype):
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((2, 16, 96)) * 3).astype(np.float32)
    labels = rng.integers(0, 96, (2, 16)).astype(np.int32)
    mask = rng.random((2, 16)) < 0.5 if with_mask else None
    loss_j, denom_j = jax_cross_entropy(
        jnp.asarray(logits), jnp.asarray(labels),
        None if mask is None else jnp.asarray(mask), z_loss=z_loss,
        compute_dtype=getattr(jnp, compute_dtype))
    loss_t, denom_t = cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(labels),
        None if mask is None else torch.from_numpy(mask), z_loss=z_loss,
        compute_dtype=getattr(torch, compute_dtype))
    tol = 1e-6 if compute_dtype == "float32" else 2e-2
    assert abs(float(loss_t) - float(loss_j)) <= tol * abs(float(loss_j))
    assert float(denom_t) == float(denom_j)


def test_cross_entropy_gradient_matches_jax():
    """The stop-gradient max and the masked gold logit: the gradient wrt
    the logits, with z-loss and a mask."""
    rng = np.random.default_rng(1)
    logits = (rng.standard_normal((2, 8, 64)) * 2).astype(np.float32)
    labels = rng.integers(0, 64, (2, 8)).astype(np.int32)
    mask = rng.random((2, 8)) < 0.7
    g_j = jax.grad(lambda x: jax_cross_entropy(
        x, jnp.asarray(labels), jnp.asarray(mask), z_loss=1e-2)[0])(
            jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    cross_entropy(x, torch.from_numpy(labels), torch.from_numpy(mask),
                  z_loss=1e-2)[0].backward()
    assert _rel(x.grad.numpy(), g_j) < 1e-5


def test_loss_mask_and_z_loss():
    """Twin of the JAX suite's test: a mask of 4 tokens in each of 2 rows
    counts 8, and the masked and unmasked losses are finite."""
    cfg = get_smoke_config("stablelm-3b")
    params = init_params(cfg, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 32),
                         generator=torch.Generator().manual_seed(0))
    logits, _ = forward_train(params, {"tokens": toks}, cfg,
                              dtype=torch.float32)
    loss_all, _ = cross_entropy(logits, toks)
    mask = torch.zeros(2, 32, dtype=torch.bool)
    mask[:, :4] = True
    loss_masked, denom = cross_entropy(logits, toks, mask, z_loss=1e-4)
    assert float(denom) == 8
    assert np.isfinite(float(loss_masked)) and np.isfinite(float(loss_all))
    _, denom0 = cross_entropy(logits, toks, torch.zeros_like(mask))
    assert float(denom0) == 1.0     # max(sum(mask), 1)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("step", [0, 3, 10, 11, 57, 100, 130])
def test_schedules_match_jax(step):
    kw = dict(peak_lr=3e-3, warmup=10, total=100)
    want = float(jax_cosine(jnp.asarray(step, jnp.float32), **kw))
    assert float(cosine_with_warmup(step, **kw)) == pytest.approx(want,
                                                                  rel=1e-6)
    assert float(constant(step, peak_lr=3e-3)) == float(
        jax_constant(step, peak_lr=3e-3))


@pytest.mark.parametrize("clip_norm", [1.0, 1e3])
def test_adamw_matches_jax_on_identical_gradients(clip_norm):
    """Three updates from the same parameters and the same numpy gradients
    (clipped and not): parameters, both moments and the metrics at 1e-6."""
    rng = np.random.default_rng(2)
    params = {"w": rng.standard_normal((6, 5)).astype(np.float32),
              "blocks": [{"norm": rng.standard_normal(5).astype(np.float32),
                          "b": rng.standard_normal((3, 2, 4)).astype(
                              np.float32)}]}
    cfg = AdamWConfig(clip_norm=clip_norm)
    p_j = jax.tree.map(jnp.asarray, params)
    p_t = jax.tree.map(torch.from_numpy, params)
    o_j, o_t = jax_init_opt_state(p_j), init_opt_state(p_t)
    for i in range(3):
        grads = jax.tree.map(
            lambda a: (rng.standard_normal(a.shape) * 0.3).astype(np.float32),
            params)
        lr = 1e-2 * (i + 1)
        p_j, o_j, m_j = jax_adamw_update(jax.tree.map(jnp.asarray, grads),
                                         o_j, p_j, jnp.float32(lr), cfg)
        p_t, o_t, m_t = adamw_update(jax.tree.map(torch.from_numpy, grads),
                                     o_t, p_t, torch.tensor(lr), cfg)
        for a, b in zip(tree_leaves(p_t) + tree_leaves(o_t["m"])
                        + tree_leaves(o_t["v"]),
                        jax.tree.leaves(p_j) + jax.tree.leaves(o_j["m"])
                        + jax.tree.leaves(o_j["v"])):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-6)
        assert int(o_t["count"]) == int(o_j["count"]) == i + 1
        for k in ("grad_norm", "clip_scale"):
            assert float(m_t[k]) == pytest.approx(float(m_j[k]), rel=1e-6)


def test_global_norm_and_decay_rule():
    """Decay reaches leaves of ndim >= 2 only, as in the reference."""
    p = {"m": torch.ones(2, 2), "v": torch.ones(3)}
    g = {"m": torch.zeros(2, 2), "v": torch.zeros(3)}
    assert float(global_norm({"a": torch.full((4,), 2.0)})) == 4.0
    new, _, _ = adamw_update(g, init_opt_state(p), p, torch.tensor(0.5),
                             AdamWConfig(weight_decay=0.1))
    assert torch.allclose(new["m"], torch.full((2, 2), 0.95))
    assert torch.equal(new["v"], torch.ones(3))


# ---------------------------------------------------------------------------
# the train step against jax.value_and_grad
# ---------------------------------------------------------------------------

def _lm(preset: str, layers: int) -> ModelConfig:
    return preset_config(preset, num_layers=layers)


@pytest.mark.parametrize("make_cfg", [
    lambda: get_smoke_config("stablelm-3b"),
    lambda: _lm("small", 2),
    lambda: _lm("100m", 2),
    lambda: get_smoke_config("mamba2-130m"),
    lambda: get_smoke_config("recurrentgemma-9b"),
], ids=["stablelm-3b-smoke", "small-2l", "100m-2l", "mamba2-130m-smoke",
        "recurrentgemma-9b-smoke"])
def test_train_step_loss_and_grads_match_jax(make_cfg):
    _step_matches_jax(make_cfg(), 32)


# mamba2-130m's smoke config with one head of 128 and states of 128: the
# shape the card's SSD backward took only once it cut P into slabs, at
# chunk 128 and at the upstream Mamba-2 module's 256 (which the card runs
# at a tile of 128), over a whole chunk of tokens so both packages take
# their chunked scans
@pytest.mark.parametrize("chunk", [128, 256])
def test_train_step_matches_jax_at_head_dim_128(chunk):
    cfg = dataclasses.replace(get_smoke_config("mamba2-130m"),
                              ssm_head_dim=128, ssm_state=128,
                              ssm_chunk=chunk)
    assert cfg.ssm_heads == 1
    _step_matches_jax(cfg, chunk)


def _step_matches_jax(cfg, seq: int):
    """The port's fp32 loss and gradients of one batch (2 x ``seq``)
    against ``jax.value_and_grad`` through the bridged weights, within
    ``REL`` of each leaf's largest value."""
    cfg_j = _jax_cfg(cfg)
    params_j = jax_init_params(jax.random.PRNGKey(3), cfg_j)
    params_t = params_from_numpy(jax.tree.map(np.asarray, params_j),
                                 device="cpu")
    toks = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, seq + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def loss_fn(p):
        logits, aux = jax_forward_train(
            p, jax.tree.map(jnp.asarray, batch), cfg_j, dtype=jnp.float32)
        loss, _ = jax_cross_entropy(logits, jnp.asarray(batch["labels"]),
                                    z_loss=1e-4)
        total = loss + cfg_j.router_aux_coef * aux
        return total, (loss, aux)

    (total_j, (loss_j, _)), grads_j = jax.value_and_grad(
        loss_fn, has_aux=True)(params_j)
    tc = TrainConfig(dtype=torch.float32, z_loss=1e-4)
    total_t, (loss_t, aux_t), grads_t = make_loss_and_grad(cfg, tc)(
        params_t, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(float(total_t) - float(total_j)) <= REL * abs(float(total_j))
    assert float(loss_t) == pytest.approx(float(loss_j), rel=REL)
    assert float(aux_t) == 0.0
    leaves_j = jax.tree_util.tree_flatten_with_path(grads_j)[0]
    leaves_t = tree_leaves(grads_t)
    assert len(leaves_t) == len(leaves_j)
    for (path, g_j), g_t in zip(leaves_j, leaves_t):
        assert g_t.shape == g_j.shape, path
        assert _rel(g_t.numpy(), g_j) < REL, (jax.tree_util.keystr(path),
                                             _rel(g_t.numpy(), g_j))


# the card's bf16 step against the CPU's (chip_smoke.py's
# TRAIN_CHECK_LIMITS[bfloat16]): the loss relative, each gradient leaf in
# relative L2 norm (single bf16 elements differ by whole bf16 steps
# between two orders of summation)
BF16_LOSS_REL, BF16_GRAD_L2 = 2e-2, 5e-2


# the RG-LRU gates' gradients of a bf16 step lie 4-10% (relative L2) from
# their fp32 values at the smoke width of 64, the JAX package's own as far
# as the port's (weights PRNGKey(5) / (7) / (9) / (11), tokens rng 6 / 8 /
# 10 / 12: the worst leaf, blocks' and rem's mixer a_param and a_gate_b,
# read 0.080 / 0.088 / 0.075 / 0.069 in JAX, 0.074 / 0.099 / 0.073 / 0.076
# in the port; the port's fp32 gradients match JAX's to 3.5e-6), so two
# bf16 steps differ there by as much as the limit (0.050-0.061 the worst
# leaf) and test_bf16_rglru_gradients_no_further_from_fp32_than_jax holds
# the width of 64; at 256 the worst leaf of four draws read 0.035-0.039
RGEMMA_BF16_WIDTH = dict(d_model=256, lru_width=256, d_ff=512)


def _both_steps(cfg, seq, seeds, dtype):
    """(loss, gradient leaves) of the JAX package's train step and of the
    port's ``make_loss_and_grad`` under ``TrainConfig()`` at ``dtype`` (the
    same cast, remat policy, z-loss and fp32 loss) on weights drawn from
    ``PRNGKey(seeds[0])`` and bridged, tokens from ``seeds[1]``: JAX's
    leaves as (path, fp32 array), the port's as fp32 tensors."""
    from repro.train.steps import TrainConfig as JaxTrainConfig
    cfg_j = _jax_cfg(cfg)
    tc_j = dataclasses.replace(JaxTrainConfig(),
                               dtype={torch.bfloat16: jnp.bfloat16,
                                      torch.float32: jnp.float32}[dtype])
    params_j = jax_init_params(jax.random.PRNGKey(seeds[0]), cfg_j)
    params_t = params_from_numpy(jax.tree.map(np.asarray, params_j),
                                 device="cpu")
    toks = np.random.default_rng(seeds[1]).integers(
        0, cfg.vocab_size, (2, seq + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def loss_fn(p):
        logits, aux = jax_forward_train(
            p, jax.tree.map(jnp.asarray, batch), cfg_j, dtype=tc_j.dtype,
            remat_policy=tc_j.remat_policy)
        loss, _ = jax_cross_entropy(logits, jnp.asarray(batch["labels"]),
                                    z_loss=tc_j.z_loss,
                                    compute_dtype=tc_j.loss_dtype)
        return loss + cfg_j.router_aux_coef * aux, loss

    (total_j, _), grads_j = jax.value_and_grad(loss_fn, has_aux=True)(
        params_j)
    tc = dataclasses.replace(TrainConfig(), dtype=dtype)
    assert tc.remat_policy == "dots_no_batch"
    total_t, _, grads_t = make_loss_and_grad(cfg, tc)(
        params_t, {k: torch.from_numpy(v) for k, v in batch.items()})
    leaves_j = [(path, np.asarray(g, np.float32)) for path, g in
                jax.tree_util.tree_flatten_with_path(grads_j)[0]]
    leaves_t = tree_leaves(grads_t)
    assert len(leaves_t) == len(leaves_j)
    return float(total_j), leaves_j, float(total_t), leaves_t


def _rel_l2(x: np.ndarray, y: np.ndarray) -> float:
    return float(np.linalg.norm(x - y) / max(float(np.linalg.norm(y)), 1e-30))


@pytest.mark.parametrize("arch,seq,widened", [
    ("recurrentgemma-9b", 64, RGEMMA_BF16_WIDTH),
    ("stablelm-12b", 64, {})])
def test_bf16_train_step_matches_jax(arch, seq, widened):
    """The bf16 slice as a whole: the port's ``make_loss_and_grad`` under
    ``TrainConfig()`` (bf16, ``dots_no_batch``) against the JAX package's
    bf16 train step's loss and ``jax.value_and_grad`` (the same cast, remat
    policy, z-loss and fp32 loss) on bridged weights, within the card's
    bf16 limits.  recurrentgemma-9b's smoke config (5 layers: a superblock
    and the remainder; its window of 16 biting at 64 tokens) at
    ``RGEMMA_BF16_WIDTH``; stablelm-12b's (GQA 4 : 2 at head dim 16)."""
    cfg = dataclasses.replace(get_smoke_config(arch), **widened)
    assert cfg.window in (0, 16) and seq > cfg.window
    assert TrainConfig().dtype == torch.bfloat16
    total_j, leaves_j, total_t, leaves_t = _both_steps(cfg, seq, (5, 6),
                                                       torch.bfloat16)
    assert abs(total_t - total_j) <= BF16_LOSS_REL * abs(total_j)
    for (path, g_j), g_t in zip(leaves_j, leaves_t):
        assert g_t.shape == g_j.shape and g_t.dtype == torch.float32, path
        rel = _rel_l2(g_t.numpy(), g_j)
        assert rel < BF16_GRAD_L2, (jax.tree_util.keystr(path), rel)


# how much further from its own fp32 gradients the port's bf16 step may
# lie than the JAX package's, by the worst leaf and by the mean over leaves
BF16_GAP_RATIO = 1.25


@pytest.mark.parametrize("seeds", [(5, 6), (7, 8)])
def test_bf16_rglru_gradients_no_further_from_fp32_than_jax(seeds):
    """recurrentgemma-9b's smoke config at its own width of 64, where the
    two packages' bf16 gradients differ by about ``BF16_GRAD_L2`` (see
    ``RGEMMA_BF16_WIDTH``): each package's bf16 step against its own fp32
    step on the same bridged weights and tokens.  The port's fp32 gradients
    match JAX's; its bf16 ones lie no further from them, by the worst leaf
    and by the mean over leaves, than ``BF16_GAP_RATIO`` times JAX's bf16
    ones from JAX's fp32 ones (1.13 and 1.03 the largest ratios read on
    these seeds), so a port that rounded more than the reference (say, its
    gates in bf16) fails here though the widened step passes."""
    cfg = get_smoke_config("recurrentgemma-9b")
    assert cfg.d_model == cfg.lru_width == 64 and 0 < cfg.window < 64
    _, bf_j, _, bf_t = _both_steps(cfg, 64, seeds, torch.bfloat16)
    _, fp_j, _, fp_t = _both_steps(cfg, 64, seeds, torch.float32)
    for (path, g_j), g_t in zip(fp_j, fp_t):
        assert _rel_l2(g_t.numpy(), g_j) < 1e-4, jax.tree_util.keystr(path)
    gap_j = np.array([_rel_l2(b, f) for (_, b), (_, f) in zip(bf_j, fp_j)])
    gap_t = np.array([_rel_l2(b.numpy(), f.numpy())
                      for b, f in zip(bf_t, fp_t)])
    assert gap_t.max() <= BF16_GAP_RATIO * gap_j.max(), (gap_t.max(),
                                                          gap_j.max())
    assert gap_t.mean() <= BF16_GAP_RATIO * gap_j.mean(), (gap_t.mean(),
                                                           gap_j.mean())


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_train_step(arch):
    """Twin of the JAX suite's test: one fwd + bwd + update on the CPU for
    every arch, its batch built by modality as the suite's ``make_batch``
    builds it: loss and grad norm finite, parameters moved."""
    cfg = get_smoke_config(arch)
    params = init_params(cfg, device="cpu")
    g = torch.Generator().manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (2, 32), generator=g)
    batch = {"tokens": toks, "labels": toks}
    if cfg.modality == "audio_stub":
        batch["features"] = torch.randn(2, 32, 512, generator=g)
        batch["loss_mask"] = torch.ones(2, 32, dtype=torch.bool)
    if cfg.modality == "vision_stub":
        batch["vision_embeds"] = torch.randn(2, 4, cfg.d_model, generator=g)
        batch["vision_mask"] = torch.zeros(2, 32, dtype=torch.bool)
        batch["vision_mask"][:, 2:6] = True
    step = make_train_step(cfg, TrainConfig(dtype=torch.float32))
    new_params, new_opt, metrics = step(
        params, init_opt_state(params), batch, torch.tensor(1e-3))
    assert np.isfinite(float(metrics["loss"]))
    assert np.isfinite(float(metrics["grad_norm"]))
    assert int(new_opt["count"]) == 1
    delta = sum(float((a - b).abs().sum()) for a, b in
                zip(tree_leaves(new_params), tree_leaves(params)))
    assert delta > 0
    assert set(metrics) == {"loss", "aux_loss", "total_loss", "grad_norm",
                            "lr"}


@pytest.mark.parametrize("arch", ["mamba2-130m", "recurrentgemma-9b"])
def test_multistep_training_stays_finite(arch):
    """Twin of the JAX suite's regression test: 5 optimizer steps at lr 3e-3
    through the SSD / RG-LRU chunked decays keep the loss and the gradient
    norm finite (the where-exp NaN trap), on the port's CPU path."""
    cfg = get_smoke_config(arch)
    params = init_params(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    opt = init_opt_state(params)
    toks = torch.randint(0, cfg.vocab_size, (2, 33),
                         generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    step = make_train_step(cfg, TrainConfig(dtype=torch.float32))
    for _ in range(5):
        params, opt, m = step(params, opt, batch, torch.tensor(3e-3))
    assert np.isfinite(float(m["loss"])), m
    assert np.isfinite(float(m["grad_norm"])), m


def test_tree_leaves_keeps_no_leaf_alive():
    """Flattening a tree leaves no reference cycle behind: a leaf is freed
    as soon as the caller drops it, without the cycle collector (a train
    step flattens its gradients, which a 1.45 B-parameter model holds in
    gigabytes)."""
    import gc
    import weakref
    t = torch.zeros(3)
    ref = weakref.ref(t)
    gc.disable()
    try:
        assert tree_leaves({"a": [t], "b": None})[0] is t
        del t
        assert ref() is None
    finally:
        gc.enable()


def test_eval_step_is_the_plain_cross_entropy():
    cfg = _lm("small", 1)
    params = init_params(cfg, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 16),
                         generator=torch.Generator().manual_seed(0))
    batch = {"tokens": toks, "labels": toks}
    loss = make_eval_step(cfg, TrainConfig(dtype=torch.float32))(
        params, batch)["loss"]
    logits, _ = forward_train(params, batch, cfg, dtype=torch.float32)
    assert float(loss) == float(cross_entropy(logits, toks)[0])


# ---------------------------------------------------------------------------
# data and the engine copy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("preset", ["small", "100m"])
def test_synthetic_lm_batches_are_the_jax_packages(preset):
    cfg = _lm(preset, 1)
    ours = iter(SyntheticLM(cfg, batch=4, seq_len=24, seed=5))
    theirs = iter(JaxSyntheticLM(_jax_cfg(cfg), batch=4, seq_len=24, seed=5))
    for _ in range(3):
        a, b = next(ours), next(theirs)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_prefetcher_keeps_order_like_the_jax_packages():
    items = [{"i": np.asarray(i)} for i in range(9)]
    ours = [int(b["i"]) for b in Prefetcher(iter(items), depth=2)]
    theirs = [int(b["i"]) for b in JaxPrefetcher(iter(items), depth=2)]
    assert ours == theirs == list(range(9))
    doubled = Prefetcher(iter(items), depth=3,
                         transform=lambda b: {"i": b["i"] * 2})
    assert [int(b["i"]) for b in doubled] == list(range(0, 18, 2))


@pytest.mark.parametrize("name", ENGINE_FILES)
def test_engine_copy_is_byte_identical(name):
    ours = ROOT / "src" / "repro_torch" / "core" / f"{name}.py"
    theirs = ROOT / "src" / "repro" / "core" / f"{name}.py"
    assert ours.read_bytes() == theirs.read_bytes()


def _op_stream(backend, seed: int, n: int = 300) -> list:
    """``n`` random StorageBackend calls on ``backend`` from ``seed``: what
    each returned, or the name of the error it raised."""
    rng = random.Random(seed)
    dirs, files, out = ["/d0", "/d1", "/d0/e"], [], []
    for d in dirs:
        backend.mkdir(d)
    for _ in range(n):
        op = rng.choice(["create", "write_at", "write_vec", "read_at",
                         "read_vec", "stat", "readdir", "rename", "unlink",
                         "truncate", "remove_tree", "mkdir"])
        path = rng.choice(files) if files and rng.random() < 0.8 else \
            f"{rng.choice(dirs)}/f{rng.randrange(12)}"
        try:
            if op == "create":
                backend.create(path)
                files.append(path)
                r = None
            elif op == "write_at":
                r = backend.write_at(path, rng.randrange(64),
                                     rng.randbytes(rng.randrange(1, 200)))
            elif op == "write_vec":
                r = backend.write_vec(path, [
                    (rng.randrange(256), rng.randbytes(rng.randrange(1, 64)))
                    for _ in range(rng.randrange(1, 4))])
            elif op == "read_at":
                r = backend.read_at(path, rng.randrange(64),
                                    rng.randrange(1, 128))
            elif op == "read_vec":
                r = backend.read_vec(path, [(0, 16), (rng.randrange(64), 32)])
            elif op == "stat":
                st = backend.stat(path)
                r = (st.size, st.is_dir)
            elif op == "readdir":
                r = sorted(backend.readdir(rng.choice(dirs)))
            elif op == "rename":
                dst = f"{rng.choice(dirs)}/g{rng.randrange(12)}"
                backend.rename(path, dst)
                files.append(dst)
                r = None
            elif op == "unlink":
                r = backend.unlink(path)
            elif op == "truncate":
                r = backend.truncate(path, rng.randrange(100))
            elif op == "remove_tree":
                r = backend.remove_tree(rng.choice(dirs[1:]))
            else:
                backend.mkdir(rng.choice(dirs))
                r = None
        except Exception as e:  # the same error on both packages' backends
            r = type(e).__name__
        out.append((op, r))
    return out


@pytest.mark.parametrize("name", ["ObjectStoreBackend",
                                  "RemoteStreamBackend"])
def test_remote_backends_match_the_jax_packages(name):
    """The object store and the SFTP-like stream, exported from the port's
    ``core``, on one seeded stream of calls: the same results, final state
    and public-call count as the JAX package's."""
    ours = getattr(torch_core, name)()
    theirs = getattr(jax_core, name)()
    assert _op_stream(ours, 7) == _op_stream(theirs, 7)
    assert ours.snapshot() == theirs.snapshot()
    assert ours.op_count == theirs.op_count > 200
    assert ours.clock.now() == theirs.clock.now()


def test_shards_round_trip_like_the_jax_packages():
    """``write_shards`` -> ``read_shards`` through the port's CannyFS gives
    the arrays the JAX package's pair gives through its own, from one
    ``SyntheticLM`` seed (arrays, not bytes: an .npz's zip headers carry a
    timestamp)."""
    cfg = _lm("small", 1)
    got = []
    for fs_cls, writer, reader, corpus, jcfg in (
            (CannyFS, write_shards, read_shards, SyntheticLM, cfg),
            (jax_core.CannyFS, jax_write_shards, jax_read_shards,
             JaxSyntheticLM, _jax_cfg(cfg))):
        inner = (InMemoryBackend if fs_cls is CannyFS
                 else jax_core.InMemoryBackend)()
        fs = fs_cls(inner, echo_errors=False)
        paths = writer(fs, "/shards", iter(corpus(jcfg, batch=3, seq_len=40,
                                                  seed=4)), 5)
        fs.drain()
        got.append((paths, list(reader(fs, "/shards", chunk=1000))))
        fs.close()
    (paths, ours), (jpaths, theirs) = got
    assert paths == jpaths and len(ours) == len(theirs) == 5
    for a, b in zip(ours, theirs):
        assert a.keys() == b.keys() == {"tokens", "labels"}
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


# ---------------------------------------------------------------------------
# the training loop (twins of tests/test_train_integration.py)
# ---------------------------------------------------------------------------

def _trainer(fs, cfg, total=20, ckpt_every=10, lr=1e-2, seq=32):
    data = Prefetcher(iter(SyntheticLM(cfg, batch=8, seq_len=seq, seed=1)),
                      depth=2)
    return Trainer(cfg, fs, data,
                   tc=TrainConfig(dtype=torch.float32, peak_lr=lr,
                                  z_loss=0.0),
                   lc=LoopConfig(total_steps=total, ckpt_every=ckpt_every,
                                 log_every=5, warmup=5),
                   device="cpu")


@pytest.mark.parametrize("make_cfg,lr,seq,below_ln_v", [
    (lambda: get_smoke_config("stablelm-3b"), 1e-2, 32, True),
    (lambda: _lm("small", 2), 3e-3, 64, False),
], ids=["stablelm-3b-smoke", "small-2l"])
def test_loss_decreases_and_checkpoints(make_cfg, lr, seq, below_ln_v):
    """The JAX suite's config and settings (the loss falls and ends below
    ln V), and the small preset at 2 layers with the example's peak lr: its
    untied head starts about 0.5 nats above ln V, more than 30 steps
    remove, so it is held to the fall alone."""
    cfg = make_cfg()
    fs = CannyFS(InMemoryBackend(), max_inflight=1000, workers=8)
    tr = _trainer(fs, cfg, total=30, lr=lr, seq=seq)
    tr.init_state(next(tr.data))
    metrics = tr.run()
    assert np.isfinite(metrics["loss"])
    assert tr.ckpt.list_steps(), "no committed checkpoints"
    fs.drain()
    log = [json.loads(line) for line in
           fs.read_file("logs/metrics.jsonl").decode().strip().splitlines()]
    losses = [r["loss"] for r in log if "loss" in r]
    assert len(losses) >= 3
    assert losses[-1] < losses[0] - 0.05, losses
    assert losses[-1] < np.log(cfg.vocab_size) or not below_ln_v, losses
    assert any("ckpt_ack_s" in r for r in log)
    fs.close()


def test_resume_from_committed_checkpoint():
    cfg = _lm("small", 1)
    fs = CannyFS(InMemoryBackend(), max_inflight=1000, workers=8)
    tr = _trainer(fs, cfg)
    tr.init_state(next(tr.data))
    tr.run(max_steps=10)
    assert tr.ckpt.list_steps() == [10]
    saved = {"params": tr.state["params"], "opt": tr.state["opt"]}
    tr2 = _trainer(fs, cfg)
    tr2.init_state(next(tr2.data))
    assert tr2.step == 10
    for a, b in zip(tree_leaves(saved),
                    tree_leaves({"params": tr2.state["params"],
                                 "opt": tr2.state["opt"]})):
        assert a.dtype == b.dtype and torch.equal(a, b)
    tr2.run()
    assert tr2.step == 20
    fs.close()


def test_run_with_restarts_recovers_from_crash():
    """A step fails at step 8 (after the commit of step 5, before that of
    step 10): the harness rolls back and the new trainer resumes at 5."""
    cfg = _lm("small", 1)
    fs = CannyFS(InMemoryBackend(), max_inflight=1000, workers=8)
    crashed = {"done": False}
    resumed_at = []

    class CrashingTrainer(Trainer):
        def init_state(self, sample_batch):
            super().init_state(sample_batch)
            resumed_at.append(self.step)
            step_fn = self.step_fn

            def failing(*args):
                if not crashed["done"] and self.step == 7:
                    crashed["done"] = True
                    self.ckpt.wait_for_save()   # step 5's COMMIT has landed
                    raise RuntimeError("simulated node failure")
                return step_fn(*args)
            self.step_fn = failing

    def factory():
        tr = _trainer(fs, cfg, total=12, ckpt_every=5)
        tr.__class__ = CrashingTrainer
        return tr

    metrics = run_with_restarts(factory, max_restarts=2)
    assert np.isfinite(metrics["loss"])
    assert resumed_at == [0, 5]
    fs.close()


def test_train_example_runs_on_cpu(monkeypatch, capsys, tmp_path):
    monkeypatch.setattr(sys, "argv", [
        "train_lm_torch.py", "--device", "cpu", "--steps", "4",
        "--ckpt-every", "2", "--io-latency-ms", "0",
        "--workdir", str(tmp_path)])
    runpy.run_path(str(ROOT / "examples" / "train_lm_torch.py"),
                   run_name="__main__")
    out = capsys.readouterr().out
    assert "final metrics:" in out and "ckpt_ack_s" in out
    assert set(PRESETS) == {"small", "100m"}


def test_launcher_trains_a_smoke_config_on_cpu(tmp_path, capsys):
    from repro_torch.launch.train import main
    metrics = main(["--arch", "stablelm-3b", "--smoke", "--steps", "3",
                    "--batch", "2", "--seq", "16", "--ckpt-every", "2",
                    "--workdir", str(tmp_path), "--device", "cpu"])
    assert np.isfinite(metrics["loss"])
    assert "[launch] done:" in capsys.readouterr().out


def test_launcher_trains_mamba2_smoke_on_cpu(tmp_path, capsys):
    """The launcher on the SSD family: a few steps of mamba2-130m's smoke
    config on the CPU, with a checkpoint, at a sequence of 2 chunks."""
    from repro_torch.launch.train import main
    metrics = main(["--arch", "mamba2-130m", "--smoke", "--steps", "3",
                    "--batch", "2", "--seq", "32", "--ckpt-every", "2",
                    "--workdir", str(tmp_path), "--device", "cpu"])
    assert np.isfinite(metrics["loss"])
    assert "[launch] done:" in capsys.readouterr().out
    assert (tmp_path / "ckpt").exists()
