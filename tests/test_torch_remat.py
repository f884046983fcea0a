"""The port's activation-checkpoint policies against the JAX package, on
the CPU.

``repro_torch.parallel.wrap_remat`` and its four policies in the layer
stack (``models/model.py:_run_stack``), the train config and the launcher.
For each policy and each of four smoke configs (dense attention, the RG-LRU
family with its remainder layers, the SSD family and the MoE with its aux
loss): the loss and the gradients of ``make_loss_and_grad`` against
``jax.value_and_grad`` of the reference's ``forward_train(...,
remat_policy=policy)`` on bridged weights (fp32, 2e-4 relative to each
leaf's largest value, the JAX suite's decode-vs-forward bound); the same
bits as the port's ``none`` gradients; and what the backward reruns,
counted at the dispatcher.  A product is ``aten.mm`` / ``addmm`` (``x @ w``
on a (B, S, D) input) or ``aten.bmm`` / ``baddbmm`` (``torch.einsum``;
a batch of 1 is a product without batch dims).
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_smoke_config as jax_smoke
from repro.models import cross_entropy as jax_cross_entropy
from repro.models import forward_train as jax_forward_train
from repro.models import init_params as jax_init_params
from repro.parallel.remat import POLICIES as JAX_POLICIES
from repro.train.steps import TrainConfig as JaxTrainConfig
from repro_torch.configs import get_smoke_config
from repro_torch.models import (cross_entropy, forward_train, init_cache,
                                init_params, prefill)
from repro_torch.models.blocks import record_routes, topk_margin
from repro_torch.models.bridge import params_from_numpy
from repro_torch.parallel import POLICIES, remat, wrap_remat
from repro_torch.train.steps import (TrainConfig, make_eval_step,
                                     make_loss_and_grad)
from repro_torch.tree import tree_leaves, tree_map
from test_torch_moe import MARGIN

REL = 2e-4
ARCHS = ("stablelm-3b", "recurrentgemma-9b", "mamba2-130m",
         "moonshot-v1-16b-a3b")
REMAT = [p for p in POLICIES if p != "none"]

_aten = torch.ops.aten
_PRODUCTS = {_aten.mm.default: "mm", _aten.addmm.default: "mm",
             _aten.bmm.default: "bmm", _aten.baddbmm.default: "bmm"}


def _rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max()
                 / max(float(np.abs(want).max()), 1e-30))


def _case(arch: str):
    """(JAX config, port config, JAX params, bridged port params, batch)."""
    cfg_j, cfg_t = jax_smoke(arch), get_smoke_config(arch)
    params_j = jax_init_params(jax.random.PRNGKey(3), cfg_j)
    params_t = params_from_numpy(jax.tree.map(np.asarray, params_j),
                                 device="cpu")
    toks = np.random.default_rng(4).integers(
        0, cfg_t.vocab_size, (2, 33)).astype(np.int32)
    return cfg_j, cfg_t, params_j, params_t, {"tokens": toks[:, :-1],
                                              "labels": toks[:, 1:]}


def _port_step(cfg, params, batch, policy: str):
    """``make_loss_and_grad`` in fp32 under ``policy``, every route
    recorded (the forward's, then the backward's reruns)."""
    tc = TrainConfig(dtype=torch.float32, z_loss=1e-4, remat_policy=policy)
    fn = make_loss_and_grad(cfg, tc)
    with record_routes() as routes:
        out = fn(params, {k: torch.from_numpy(v) for k, v in batch.items()})
    return out, routes


# ---------------------------------------------------------------------------
# the policies, the config and the launcher
# ---------------------------------------------------------------------------

def test_policies_are_the_references():
    assert POLICIES == JAX_POLICIES


@pytest.mark.parametrize("policy", [None, "none"])
def test_wrap_remat_none_returns_the_function(policy):
    def fn(x):
        return x
    assert wrap_remat(fn, policy) is fn


@pytest.mark.parametrize("policy", ["selective", "Full", "dots_saveable"])
def test_wrap_remat_rejects_an_unknown_policy(policy):
    with pytest.raises(ValueError, match="unknown remat policy"):
        wrap_remat(lambda x: x, policy)


def test_train_config_rejects_an_unknown_policy():
    with pytest.raises(ValueError, match="unknown remat policy"):
        TrainConfig(remat_policy="selective")


def test_train_config_defaults_to_the_references_policy():
    assert TrainConfig().remat_policy == JaxTrainConfig().remat_policy
    assert TrainConfig().remat_policy == "dots_no_batch"


@pytest.mark.parametrize("policy", POLICIES)
def test_train_config_takes_every_policy(policy):
    assert TrainConfig(remat_policy=policy).remat_policy == policy


def test_launcher_trains_under_remat_on_cpu(tmp_path, capsys):
    from repro_torch.launch.train import main
    metrics = main(["--arch", "stablelm-3b", "--smoke", "--remat", "full",
                    "--steps", "3", "--batch", "2", "--seq", "16",
                    "--ckpt-every", "2", "--workdir", str(tmp_path),
                    "--device", "cpu"])
    assert np.isfinite(metrics["loss"])
    assert "[launch] done:" in capsys.readouterr().out


def test_launcher_defaults_to_no_remat(tmp_path, monkeypatch):
    """As the reference's launcher: ``--remat`` defaults to ``none`` (the
    train config's own default is ``dots_no_batch``), and an unknown name
    is refused by the parser."""
    from repro_torch.launch import train as launch
    seen = []

    def spy(**kw):
        seen.append(kw["remat_policy"])
        return TrainConfig(**kw)
    monkeypatch.setattr(launch, "TrainConfig", spy)
    launch.main(["--arch", "mamba2-130m", "--smoke", "--steps", "1",
                 "--batch", "1", "--seq", "16", "--ckpt-every", "5",
                 "--workdir", str(tmp_path), "--device", "cpu"])
    assert seen == ["none"]
    with pytest.raises(SystemExit):
        launch.main(["--arch", "mamba2-130m", "--smoke", "--remat",
                     "selective", "--device", "cpu"])


# ---------------------------------------------------------------------------
# parity with the reference, and with the port's own step under "none"
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_loss_and_grads_match_jax(arch, policy):
    cfg_j, cfg_t, params_j, params_t, batch = _case(arch)

    def loss_fn(p):
        logits, aux = jax_forward_train(
            p, jax.tree.map(jnp.asarray, batch), cfg_j, dtype=jnp.float32,
            remat_policy=policy)
        loss, _ = jax_cross_entropy(logits, jnp.asarray(batch["labels"]),
                                    z_loss=1e-4)
        return loss + cfg_j.router_aux_coef * aux, (loss, aux)

    (total_j, (loss_j, aux_j)), grads_j = jax.value_and_grad(
        loss_fn, has_aux=True)(params_j)
    (total_t, (loss_t, aux_t), grads_t), routes = _port_step(
        cfg_t, params_t, batch, policy)
    # a route that flips between the two packages would look like a fault:
    # every MoE comparison asserts the smallest top-k margin it met
    margin = min((topk_margin(p, cfg_t.experts_per_token) for p, _ in routes),
                 default=float("inf"))
    assert margin > MARGIN, f"top-k margin {margin}: a route may flip"
    for got, want in ((total_t, total_j), (loss_t, loss_j)):
        assert abs(float(got) - float(want)) <= REL * abs(float(want))
    assert float(aux_t) == pytest.approx(float(aux_j), rel=REL, abs=1e-12)
    assert (float(aux_j) > 0) == bool(cfg_t.num_experts)
    leaves_j = jax.tree_util.tree_flatten_with_path(grads_j)[0]
    leaves_t = tree_leaves(grads_t)
    assert len(leaves_t) == len(leaves_j)
    for (path, g_j), g_t in zip(leaves_j, leaves_t):
        assert g_t.shape == g_j.shape, path
        assert _rel(g_t.numpy(), g_j) < REL, (jax.tree_util.keystr(path),
                                             _rel(g_t.numpy(), g_j),
                                             f"top-k margin {margin}")


@pytest.mark.parametrize("policy", REMAT)
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gives_the_none_gradients_bit_for_bit(arch, policy):
    """Each policy's loss and gradients are the ``none`` step's bits: the
    backward's graph is the forward's, and the reruns give the same
    values.  For the MoE config the routes too: the backward reruns every
    MoE layer's router (``dots_no_batch`` and ``dots`` keep its product,
    ``full`` forms it again) and its top-k picks the forward's experts, so
    the capacity buffers are filled as they were."""
    _, cfg, _, params, batch = _case(arch)
    (total0, _, grads0), routes0 = _port_step(cfg, params, batch, "none")
    (total, _, grads), routes = _port_step(cfg, params, batch, policy)
    assert torch.equal(total, total0)
    for g, g0 in zip(tree_leaves(grads), tree_leaves(grads0)):
        assert torch.equal(g, g0)
    n_moe = len(routes0)
    assert n_moe == (cfg.num_layers if cfg.num_experts else 0)
    assert len(routes) == 2 * n_moe          # the forward's, the reruns'
    forward, reruns = routes[:n_moe], routes[n_moe:][::-1]
    for (p0, s0), (p1, s1), (p2, s2) in zip(routes0, forward, reruns):
        assert torch.equal(s1, s0) and torch.equal(p1, p0)
        assert torch.equal(s2, s0) and torch.equal(p2, p0)


# ---------------------------------------------------------------------------
# what each policy recomputes
# ---------------------------------------------------------------------------

class _CountProducts(TorchDispatchMode):
    """Counts the products the dispatcher sees: ``mm`` (with ``addmm``),
    ``bmm`` (with ``baddbmm``) over a batch of more than one, and ``bmm1``
    over a batch of one."""

    def __init__(self):
        super().__init__()
        self.n = {"mm": 0, "bmm": 0, "bmm1": 0}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kind = _PRODUCTS.get(func)
        if kind == "bmm":
            batch = args[1 if func is _aten.baddbmm.default else 0]
            kind = "bmm" if batch.shape[0] > 1 else "bmm1"
        if kind:
            self.n[kind] += 1
        return func(*args, **(kwargs or {}))


def _counts(cfg, params, batch, policy, early_stop: bool = True):
    """The products of the forward and of the backward under ``policy``."""
    p = tree_map(lambda t: t.detach().requires_grad_(), params)
    toks = {"tokens": torch.from_numpy(batch["tokens"])}
    with torch.utils.checkpoint.set_checkpoint_early_stop(early_stop):
        with _CountProducts() as fwd:
            logits, aux = forward_train(p, toks, cfg, dtype=torch.float32,
                                        remat_policy=policy)
            loss = cross_entropy(logits, torch.from_numpy(batch["labels"]))[0]
            loss = loss + cfg.router_aux_coef * aux
        with _CountProducts() as bwd:
            loss.backward()
    return fwd.n, bwd.n


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("arch", ARCHS)
def test_what_each_policy_recomputes(arch, policy):
    """With the checkpoints' early stop off (each rerun goes to the end of
    its superblock): under ``none`` the backward forms each forward
    product's two gradient products and reruns none; ``full`` reruns every
    product of the stack (all but the head's one ``mm``); ``dots`` reruns
    none; ``dots_no_batch`` reruns no ``mm`` and no ``bmm`` over a batch
    of one, and every ``bmm`` over a larger batch (attention's einsums on
    the CPU path, the SSD chunk products, the RG-LRU gates' block-diagonal
    einsums, the MoE experts' stacked products)."""
    _, cfg, _, params, batch = _case(arch)
    fwd, bwd = _counts(cfg, params, batch, policy, early_stop=False)
    reruns = {k: bwd[k] - 2 * fwd[k] for k in fwd}
    stack = dict(fwd, mm=fwd["mm"] - 1)
    assert fwd["bmm"] > 0 and fwd["mm"] > 1
    want = {"none": dict.fromkeys(fwd, 0), "full": stack,
            "dots": dict.fromkeys(fwd, 0),
            "dots_no_batch": dict(mm=0, bmm=fwd["bmm"], bmm1=0)}[policy]
    assert reruns == want, (fwd, bwd)


def test_early_stop_skips_each_checkpoints_last_product():
    """With the early stop on (PyTorch's default), a rerun ends as soon as
    every saved tensor of its superblock is formed again: the last thing
    a dense layer saves is the inputs of its FFN's down projection, which
    are packed before that product runs, so ``full`` reruns every product
    of the stack but one a superblock."""
    _, cfg, _, params, batch = _case("stablelm-3b")
    fwd, bwd = _counts(cfg, params, batch, "full")
    assert bwd["mm"] - 2 * fwd["mm"] == fwd["mm"] - 1 - cfg.n_superblocks
    assert bwd["bmm"] - 2 * fwd["bmm"] == fwd["bmm"]


@contextlib.contextmanager
def _checkpoints():
    """Counts the calls of ``torch.utils.checkpoint.checkpoint`` that
    ``wrap_remat`` makes."""
    calls = []
    inner = remat.checkpoint

    def counted(*args, **kw):
        calls.append(kw.get("context_fn"))
        return inner(*args, **kw)
    remat.checkpoint = counted
    try:
        yield calls
    finally:
        remat.checkpoint = inner


@pytest.mark.parametrize("policy", REMAT)
def test_remat_wraps_only_the_training_forward(policy):
    """One checkpoint a superblock and one a remainder layer (the
    recurrentgemma smoke config: one superblock of three layers, two
    remainder layers) in the training forward; none under ``no_grad``
    (``make_eval_step``), and none with a cache (prefill), whatever the
    policy."""
    cfg = get_smoke_config("recurrentgemma-9b")
    params = init_params(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 17),
                         generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    tc = TrainConfig(dtype=torch.float32, remat_policy=policy)
    with _checkpoints() as calls:
        make_loss_and_grad(cfg, tc)(params, batch)
    assert len(calls) == cfg.n_superblocks + len(cfg.remainder_pattern) == 3
    assert all((c is remat.noop_context_fn) == (policy == "full")
               for c in calls)
    with _checkpoints() as calls:
        make_eval_step(cfg, tc)(params, batch)
        with torch.no_grad():
            forward_train(params, batch, cfg, dtype=torch.float32,
                          remat_policy=policy)
        prefill(params, {"tokens": toks}, init_cache(
            cfg, 2, 32, torch.float32, device="cpu"), cfg,
            dtype=torch.float32)
    assert calls == []
