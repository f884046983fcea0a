"""The port's MoE slice against the JAX package, on the CPU.

``moe_forward`` and its gradients, the MoE parameter tree, and the two MoE
configs (moonshot-v1-16b-a3b, llama4-scout-17b-a16e) served and trained at
their smoke sizes.  Weights come from the JAX init through
``bridge.params_from_numpy``, inputs from numpy with a seed.  Tolerances:
y within 2e-5 of (1 + max|y|) and the aux loss within 2e-5, fp32; gradients,
serving logits and the train step 2e-4 relative to the largest value (the
JAX suite's decode-vs-forward bound).

Routing near-ties: a route that flips between two runs changes the expert a
token goes to, and the error then looks like a fault.  Every comparison
here asserts the smallest top-k margin p_(k) - p_(k+1) it met exceeds
``MARGIN``, so that a flip cannot be the silent cause of a failure, and a
failure reports the margin.
"""
import dataclasses
import math
import runpy
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import cross_entropy as jax_cross_entropy
from repro.models import forward_train as jax_forward_train
from repro.models import init_params as jax_init_params
from repro.models import param_specs as jax_param_specs
from repro.models.blocks import init_moe as jax_init_moe
from repro.models.blocks import moe_forward as jax_moe_forward
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import (decode_step, forward_train, init_cache,
                                init_params, param_specs, prefill)
from repro_torch.models.blocks import (moe_forward, record_routes,
                                       routes_by_layer, routes_differ,
                                       topk_margin)
from repro_torch.models.bridge import params_from_numpy
from repro_torch.train.steps import TrainConfig, make_loss_and_grad
from repro_torch.tree import tree_leaves
from test_torch_serve import _serving_matches_jax, _shapes

ROOT = Path(__file__).resolve().parents[1]
MOE_ARCHS = ("moonshot-v1-16b-a3b", "llama4-scout-17b-a16e")
Y_TOL = 2e-5
REL = 2e-4
MARGIN = 1e-4


def _rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max()
                 / max(float(np.abs(want).max()), 1e-30))


def _margin(routes, k: int) -> float:
    return min(topk_margin(probs, k) for probs, _ in routes)


def _with_margin(fn, k: int):
    """``fn()`` with every route recorded; asserts the smallest top-k margin
    exceeds ``MARGIN`` and names it in any failure of ``fn``."""
    with record_routes() as routes:
        try:
            out = fn()
        except AssertionError as e:
            raise AssertionError(f"{e} (smallest top-{k} margin "
                                 f"{_margin(routes, k)})") from e
    margin = _margin(routes, k)
    assert margin > MARGIN, f"top-{k} margin {margin}: a route may flip"
    return out


def _moe_case(variant: str):
    """(JAX config, port config, JAX params, port params, x): moonshot-smoke
    widths, or at ``drops`` a capacity factor of 0.5, where experts
    overflow."""
    arch = "moonshot-v1-16b-a3b"
    kw = {"drops": dict(capacity_factor=0.5)}.get(variant, {})
    cfg_j = dataclasses.replace(jax_smoke(arch), **kw)
    cfg_t = dataclasses.replace(get_smoke_config(arch), **kw)
    p_j = jax_init_moe(jax.random.PRNGKey(0), cfg_j)
    p_t = params_from_numpy(jax.tree.map(np.asarray, p_j), device="cpu")
    x = np.random.default_rng(0).standard_normal(
        (2, 24, cfg_j.d_model)).astype(np.float32)
    return cfg_j, cfg_t, p_j, p_t, x


def _overflows(sel: torch.Tensor, cfg) -> int:
    """(token, k) pairs past their expert's capacity, over the batch."""
    B, S, k = sel.shape
    C = max(min(math.ceil(S * k * cfg.capacity_factor / cfg.num_experts),
                S * k), 1)
    counts = torch.zeros(B, cfg.num_experts, dtype=torch.long)
    counts.scatter_add_(1, sel.reshape(B, -1), torch.ones_like(
        sel.reshape(B, -1)))
    return int((counts - C).clamp(min=0).sum())


@pytest.mark.parametrize("variant", ["smoke", "drops"])
def test_moe_forward_matches_jax(variant):
    cfg_j, cfg_t, p_j, p_t, x = _moe_case(variant)
    y_j, aux_j = jax_moe_forward(p_j, jnp.asarray(x), {"cfg": cfg_j})
    with record_routes() as routes:
        y_t, aux_t = moe_forward(p_t, torch.from_numpy(x), {"cfg": cfg_t})
    margin = _margin(routes, cfg_t.experts_per_token)
    assert margin > MARGIN, margin
    dropped = _overflows(routes[0][1], cfg_t)
    assert (dropped > 0) == (variant == "drops"), dropped
    y_j = np.asarray(y_j)
    assert y_t.shape == y_j.shape and aux_t.dtype == torch.float32
    assert np.abs(y_t.numpy() - y_j).max() <= Y_TOL * (1 + np.abs(y_j).max())
    assert abs(float(aux_t) - float(aux_j)) <= Y_TOL


@pytest.mark.parametrize("variant", ["smoke", "drops"])
def test_moe_grads_match_jax(variant):
    """d(sum(y r) + aux) by x and by every MoE leaf against ``jax.grad``:
    the gradient through the scatter, the gather, the router weights and
    the aux loss."""
    cfg_j, cfg_t, p_j, p_t, x = _moe_case(variant)
    r = np.random.default_rng(1).standard_normal(x.shape).astype(np.float32)

    def loss_j(p, xx):
        y, aux = jax_moe_forward(p, xx, {"cfg": cfg_j})
        return jnp.sum(y * jnp.asarray(r)) + aux

    g_p_j, g_x_j = jax.grad(loss_j, argnums=(0, 1))(p_j, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    leaves = tree_leaves(p_t)
    for t in leaves:
        t.requires_grad_()
    with record_routes() as routes:
        y, aux = moe_forward(p_t, xt, {"cfg": cfg_t})
    assert _margin(routes, cfg_t.experts_per_token) > MARGIN
    (torch.sum(y * torch.from_numpy(r)) + aux).backward()
    assert _rel(xt.grad.numpy(), g_x_j) < REL
    flat_j = jax.tree_util.tree_flatten_with_path(g_p_j)[0]
    assert len(flat_j) == len(leaves) == 7
    for (path, g_j), t in zip(flat_j, leaves):
        assert t.grad.shape == g_j.shape, path
        assert _rel(t.grad.numpy(), g_j) < REL, (jax.tree_util.keystr(path),
                                                 _rel(t.grad.numpy(), g_j))


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_init_moe_tree_dtype_and_statistics(arch, dtype):
    cfg = get_smoke_config(arch)
    params = init_params(cfg, device="cpu", dtype=dtype,
                         generator=torch.Generator().manual_seed(0))
    assert _shapes(params) == _shapes(jax_param_specs(jax_smoke(arch)))
    moe = params["blocks"][0]["moe"]
    assert set(moe) == {"router", "w_gate", "w_up", "w_down", "shared"}
    assert "ffn" not in params["blocks"][0]
    assert all(t.dtype == dtype for t in tree_leaves(moe))
    D, F = cfg.d_model, cfg.moe_dff
    for w, fan_in in ((moe["router"], D), (moe["w_gate"], D),
                      (moe["w_up"], D), (moe["w_down"], F),
                      (moe["shared"]["down"], cfg.shared_expert_dff)):
        w = w.float()
        want = 0.98658 * fan_in ** -0.5    # the ±3σ truncation's std
        assert abs(float(w.std()) / want - 1) < 0.1
        assert float(w.abs().max()) <= 3 * fan_in ** -0.5 * 1.01


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_param_count_matches_tree(arch):
    cfg = get_smoke_config(arch)
    params = init_params(cfg, device="cpu")
    n = sum(int(np.prod(s)) for s in _shapes(params).values())
    assert n == cfg.param_count()


def test_full_moonshot_param_specs_on_meta():
    """The whole 48-layer tree, shapes only: 28.89 B parameters, 57.78 GB
    of bf16, which one 80 GB card holds."""
    cfg = get_config("moonshot-v1-16b-a3b")
    specs = param_specs(cfg, dtype=torch.bfloat16)
    nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(specs))
    assert nbytes == 2 * cfg.param_count()
    assert round(nbytes / 1e9, 2) == 57.78
    assert specs["blocks"][0]["moe"]["w_gate"].shape == (48, 64, 2048, 1408)
    assert specs["blocks"][0]["moe"]["shared"]["up"].shape == (48, 2048, 2816)


def test_first_k_dense_layers_match_jax():
    """``first_k_dense`` keeps the leading layers dense (the DeepSeek
    layout): a two-position pattern, one dense and one MoE layer."""
    arch = "moonshot-v1-16b-a3b"
    kw = dict(block_pattern=("attn", "attn"), first_k_dense=1)
    cfg_j = dataclasses.replace(jax_smoke(arch), **kw)
    cfg_t = dataclasses.replace(get_smoke_config(arch), **kw)
    params_j = jax_init_params(jax.random.PRNGKey(2), cfg_j)
    params_t = params_from_numpy(jax.tree.map(np.asarray, params_j),
                                 device="cpu")
    assert _shapes(init_params(cfg_t, device="cpu")) == _shapes(params_j)
    assert "ffn" in params_t["blocks"][0] and "moe" in params_t["blocks"][1]
    toks = np.random.default_rng(0).integers(0, cfg_t.vocab_size, (2, 16))
    logits_j, aux_j = jax_forward_train(params_j, {"tokens": jnp.asarray(
        toks)}, cfg_j, dtype=jnp.float32)
    logits_t, aux_t = _with_margin(lambda: forward_train(
        params_t, {"tokens": torch.from_numpy(toks)}, cfg_t,
        dtype=torch.float32), cfg_t.experts_per_token)
    assert _rel(logits_t.numpy(), logits_j) < REL
    assert float(aux_t) == pytest.approx(float(aux_j), rel=Y_TOL)
    with pytest.raises(ValueError, match="first_k_dense"):
        init_params(dataclasses.replace(cfg_t, block_pattern=("attn",)),
                    device="cpu")


@pytest.mark.parametrize("arch,S", [("moonshot-v1-16b-a3b", 16),
                                    ("llama4-scout-17b-a16e", 40)])
def test_moe_serving_matches_jax(arch, S):
    """forward_train (with its aux loss), prefill and 8 greedy decode steps
    against the JAX package.  llama4-scout-smoke's 40-token prompt crosses
    its 16-token chunk: the chunked layers' ring cache wraps, and decode's
    chunk mask crosses a boundary; its fourth layer is global and NoPE."""
    cfg_j, cfg_t = jax_smoke(arch), get_smoke_config(arch)
    assert cfg_t.chunk_size == 0 or S > cfg_t.chunk_size
    _, (cache_j, cache_t) = _with_margin(
        lambda: _serving_matches_jax(cfg_j, cfg_t, S, n_dec=8),
        cfg_t.experts_per_token)
    for c_t, c_j, kind in zip(cache_t["blocks"], cache_j["blocks"],
                              cfg_t.block_pattern):
        Sc = cfg_t.chunk_size if kind == "attn_chunked" else S + 16
        assert c_t["k"].shape[2] == Sc, kind
        assert np.array_equal(c_t["pos"].numpy(), np.asarray(c_j["pos"]))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_decode_matches_forward(arch):
    """The port's prefill + decode against its own forward, at a capacity
    factor of num_experts (capacity drops differ between a full forward and
    one token at a time by design), over 24 tokens: past llama4-scout's
    16-token chunk."""
    cfg = get_smoke_config(arch)
    cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.num_experts))
    gen = torch.Generator().manual_seed(1)
    params = init_params(cfg, device="cpu", generator=gen)
    toks = torch.randint(0, cfg.vocab_size, (2, 24), generator=gen)
    with record_routes() as routes:
        full, _ = forward_train(params, {"tokens": toks}, cfg,
                                dtype=torch.float32)
        cache = init_cache(cfg, 2, 64, torch.float32, device="cpu")
        pre = 16
        last, cache = prefill(params, {"tokens": toks[:, :pre]}, cache, cfg,
                              dtype=torch.float32)
        errs = [float((last - full[:, pre - 1]).abs().max())]
        for t in range(pre, 24):
            lg, cache = decode_step(params, toks[:, t:t + 1], cache, cfg,
                                    dtype=torch.float32)
            errs.append(float((lg - full[:, t]).abs().max()))
    flips = sum(routes_differ(f, s)
                for f, s in routes_by_layer(routes, 2 + 24 - pre))
    margin = _margin(routes, cfg.experts_per_token)
    rel = max(errs) / float(full.abs().max())
    assert rel < REL, (arch, rel, f"routes differ {flips}, margin {margin}")
    assert flips == 0 and margin > MARGIN, (flips, margin)


def test_moe_train_step_matches_jax():
    """One train step of moonshot-smoke: the CE loss, the aux loss, their
    total (CE + router_aux_coef · aux) and every gradient against
    ``jax.value_and_grad``."""
    arch = "moonshot-v1-16b-a3b"
    cfg_j, cfg_t = jax_smoke(arch), get_smoke_config(arch)
    params_j = jax_init_params(jax.random.PRNGKey(3), cfg_j)
    params_t = params_from_numpy(jax.tree.map(np.asarray, params_j),
                                 device="cpu")
    toks = np.random.default_rng(4).integers(
        0, cfg_t.vocab_size, (2, 33)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def loss_fn(p):
        logits, aux = jax_forward_train(
            p, jax.tree.map(jnp.asarray, batch), cfg_j, dtype=jnp.float32)
        loss, _ = jax_cross_entropy(logits, jnp.asarray(batch["labels"]),
                                    z_loss=1e-4)
        return loss + cfg_j.router_aux_coef * aux, (loss, aux)

    (total_j, (loss_j, aux_j)), grads_j = jax.value_and_grad(
        loss_fn, has_aux=True)(params_j)
    tc = TrainConfig(dtype=torch.float32, z_loss=1e-4)
    total_t, (loss_t, aux_t), grads_t = _with_margin(
        lambda: make_loss_and_grad(cfg_t, tc)(
            params_t, {k: torch.from_numpy(v) for k, v in batch.items()}),
        cfg_t.experts_per_token)
    assert float(aux_j) > 0
    for got, want in ((total_t, total_j), (loss_t, loss_j), (aux_t, aux_j)):
        assert abs(float(got) - float(want)) <= REL * abs(float(want))
    leaves_j = jax.tree_util.tree_flatten_with_path(grads_j)[0]
    leaves_t = tree_leaves(grads_t)
    assert len(leaves_t) == len(leaves_j)
    for (path, g_j), g_t in zip(leaves_j, leaves_t):
        assert g_t.shape == g_j.shape, path
        assert _rel(g_t.numpy(), g_j) < REL, (jax.tree_util.keystr(path),
                                             _rel(g_t.numpy(), g_j))


def test_topk_margin_and_routes_differ():
    probs = torch.tensor([[[0.5, 0.3, 0.15, 0.05]],
                          [[0.4, 0.1, 0.35, 0.15]]])
    assert topk_margin(probs, 1) == pytest.approx(0.05)
    assert topk_margin(probs, 2) == pytest.approx(0.15)
    a = torch.tensor([[[0, 1]], [[2, 0]]])
    assert routes_differ(a, torch.tensor([[[1, 0]], [[0, 2]]])) == 0
    assert routes_differ(a, torch.tensor([[[0, 3]], [[0, 2]]])) == 1


def test_routes_by_layer_joins_served_runs():
    """Two MoE layers: a forward over 3 tokens, then a prefill of 2 and one
    decode step; each layer's served routes are joined along the sequence
    and paired with the forward's."""
    sel = [torch.tensor([[[0, 1], [2, 3], [4, 5]]]) + 10 * layer
           for layer in range(2)]
    routes = [(None, s) for s in sel]                      # the forward
    routes += [(None, s[:, :2]) for s in sel]              # the prefill
    routes += [(None, s[:, 2:]) for s in sel]              # one decode step
    pairs = routes_by_layer(routes, 3)
    assert len(pairs) == 2
    for (fwd, served), want in zip(pairs, sel):
        assert torch.equal(fwd, want) and torch.equal(served, want)
    routes[-1] = (None, torch.tensor([[[4, 6]]]) + 10)
    assert [routes_differ(f, s) for f, s in routes_by_layer(routes, 3)] \
        == [0, 1]


def test_serve_example_runs_moonshot_on_cpu(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [
        "serve_batch_torch.py", "--device", "cpu", "--arch",
        "moonshot-v1-16b-a3b", "--requests", "3", "--batch", "2",
        "--max-new", "3"])
    runpy.run_path(str(ROOT / "examples" / "serve_batch_torch.py"),
                   run_name="__main__")
    out = capsys.readouterr().out
    assert "arch=moonshot-v1-16b-a3b" in out and "decode_throughput=" in out


def test_launcher_trains_moonshot_smoke_on_cpu(tmp_path, capsys):
    from repro_torch.launch.train import main
    metrics = main(["--arch", "moonshot-v1-16b-a3b", "--smoke", "--steps",
                    "2", "--batch", "2", "--seq", "16", "--ckpt-every", "2",
                    "--workdir", str(tmp_path), "--device", "cpu"])
    assert np.isfinite(metrics["loss"])
    assert metrics["aux_loss"] > 0
    assert metrics["total_loss"] == pytest.approx(
        metrics["loss"] + 0.01 * metrics["aux_loss"], rel=1e-5)
    assert "[launch] done:" in capsys.readouterr().out
