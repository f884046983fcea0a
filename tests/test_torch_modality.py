"""The port's modality stubs against the JAX package, on the CPU: M-RoPE,
the early-fusion vision scatter, the audio frontend, qwen2-vl-2b and
hubert-xlarge through ``forward_train`` (logits and gradients), serving
and the encode step, the launcher, and the data they are fed.

Identical weights come from the JAX ``init_params`` tree through
``bridge.params_from_numpy``; every input is made with numpy.  Tolerances:
M-RoPE's cos / sin 1e-6; the vision scatter bit for bit (it only moves
values); logits, gradients and decode 2e-4 relative to the largest value
(the JAX suite's decode-vs-forward bound, ``tests/test_models.py``), fp32.
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import \
    TransactionalCheckpointManager as JaxCheckpointManager
from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.data import SyntheticLM as JaxSyntheticLM
from repro.core import CannyFS as JaxCannyFS
from repro.core import LocalBackend as JaxLocalBackend
from repro.launch.mesh import make_debug_mesh
from repro.models import cross_entropy as jax_cross_entropy
from repro.models import decode_step as jax_decode_step
from repro.models import forward_train as jax_forward_train
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import prefill as jax_prefill
from repro.models import blocks as jax_blocks
from repro.models import model as jax_model
from repro.models.layers import act_fn as jax_act_fn
from repro.models.rope import mrope_cos_sin as jax_mrope_cos_sin
from repro.models.rope import text_positions3 as jax_text_positions3
from repro.train.steps import make_encode_step as jax_make_encode_step
from repro_torch.checkpoint import TransactionalCheckpointManager
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import CannyFS, LocalBackend
from repro_torch.data import SyntheticLM
from repro_torch.models import (decode_step, forward_train, init_cache,
                                init_params, prefill)
from repro_torch.models import blocks, model
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.layers import act_fn
from repro_torch.models.rope import mrope_cos_sin, text_positions3
from repro_torch.train import make_encode_step
from repro_torch.train.loop import Trainer
from repro_torch.train.steps import TrainConfig, make_loss_and_grad
from repro_torch.tree import tree_leaves

REL = 2e-4
B, S = 2, 32


def _rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max()
                 / max(float(np.abs(want).max()), 1e-30))


def _params(cfg_j, seed: int = 0):
    params_j = jax_init_params(jax.random.PRNGKey(seed), cfg_j)
    return params_j, params_from_numpy(jax.tree.map(np.asarray, params_j),
                                       device="cpu")


def _batch(cfg, rng, S: int = S, n_img: int = 4) -> dict:
    """Tokens and labels, and the modality's inputs: for the vision stub
    patch embeddings, a non-contiguous mask with one row short of n_img
    Trues, and non-degenerate 3-D positions; for the audio stub frame
    features and a loss mask."""
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.modality == "vision_stub":
        batch["vision_embeds"] = rng.standard_normal(
            (B, n_img, cfg.d_model)).astype(np.float32)
        mask = np.zeros((B, S), bool)
        mask[0, [2, 5, 6, 9]] = True          # n_img Trues, not contiguous
        mask[1, [3, 20]] = True               # fewer Trues than n_img
        batch["vision_mask"] = mask
        batch["positions3"] = rng.integers(0, 2 * S, (3, B, S)).astype(
            np.int32)
    if cfg.modality == "audio_stub":
        batch["features"] = rng.standard_normal((B, S, 512)).astype(
            np.float32)
        batch["loss_mask"] = rng.random((B, S)) < 0.7
    return batch


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# M-RoPE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("head_dim,sections", [(128, (16, 24, 24)),
                                               (16, (4, 2, 2))])
def test_mrope_cos_sin_matches_jax(head_dim, sections):
    """Random (t, h, w) ids that differ coordinate by coordinate, so every
    band's source shows; qwen2-vl-2b's sections and the smoke config's."""
    pos3 = np.random.default_rng(0).integers(0, 4096, (3, B, 40)).astype(
        np.int32)
    cos_j, sin_j = jax_mrope_cos_sin(jnp.asarray(pos3), head_dim, 1e6,
                                     sections)
    cos_t, sin_t = mrope_cos_sin(torch.from_numpy(pos3), head_dim, 1e6,
                                 sections)
    assert cos_t.shape == cos_j.shape == (B, 40, head_dim)
    assert cos_t.dtype == torch.float32
    np.testing.assert_allclose(cos_t.numpy(), np.asarray(cos_j), atol=1e-6)
    np.testing.assert_allclose(sin_t.numpy(), np.asarray(sin_j), atol=1e-6)


def test_text_positions3_matches_jax():
    pos = np.arange(24, dtype=np.int32).reshape(2, 12)
    np.testing.assert_array_equal(text_positions3(torch.from_numpy(pos)),
                                  np.asarray(jax_text_positions3(
                                      jnp.asarray(pos))))


# ---------------------------------------------------------------------------
# the stub frontends
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_img", [4, 6])
def test_vision_scatter_matches_jax_bit_for_bit(n_img):
    """The early-fusion scatter of ``_embed_inputs``: each row's j-th True
    position takes patch j; a row with fewer Trues than n_img keeps its
    token embedding where the target is False (both rows, at n_img 6)."""
    cfg_j, cfg_t = jax_smoke("qwen2-vl-2b"), get_smoke_config("qwen2-vl-2b")
    params_j, params_t = _params(cfg_j)
    batch = _batch(cfg_t, np.random.default_rng(1), n_img=n_img)
    x_j = jax_model._embed_inputs(params_j, _jax(batch), cfg_j, jnp.float32)
    x_t = model._embed_inputs(params_t, _torch(batch), cfg_t, torch.float32)
    np.testing.assert_array_equal(x_t.numpy(), np.asarray(x_j))
    # the scatter did something: row 0's Trues hold the patches
    np.testing.assert_array_equal(x_t[0, [2, 5, 6, 9]].numpy(),
                                  batch["vision_embeds"][0, :4])


def test_audio_frontend_matches_jax():
    cfg_j, cfg_t = jax_smoke("hubert-xlarge"), get_smoke_config(
        "hubert-xlarge")
    params_j, params_t = _params(cfg_j)
    batch = _batch(cfg_t, np.random.default_rng(2))
    x_j = jax_model._embed_inputs(params_j, _jax(batch), cfg_j, jnp.float32)
    x_t = model._embed_inputs(params_t, _torch(batch), cfg_t, torch.float32)
    assert x_t.shape == (B, S, cfg_t.d_model)
    assert _rel(x_t.numpy(), x_j) < 1e-6


def test_attn_bidir_block_and_gelu_match_jax():
    """hubert's block: attention with no causal mask (``attn_bidir``) and
    the tanh-approximated GELU of its FFN, one layer against the JAX
    block on the same weights and input."""
    cfg_j, cfg_t = jax_smoke("hubert-xlarge"), get_smoke_config(
        "hubert-xlarge")
    x = np.random.default_rng(3).standard_normal((B, S, cfg_t.d_model)) \
        .astype(np.float32)
    np.testing.assert_allclose(
        act_fn("gelu")(torch.from_numpy(x)).numpy(),
        np.asarray(jax_act_fn("gelu")(jnp.asarray(x))), rtol=1e-6, atol=1e-6)
    params_j, params_t = _params(cfg_j)
    layer_j = jax.tree.map(lambda a: a[0], params_j["blocks"][0])
    layer_t = model._layer(params_t["blocks"][0], 0)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    ctx_j = jax_model._make_ctx(cfg_j, jnp.asarray(pos), None, jnp.float32,
                                jnp.zeros((), jnp.int32), None)
    ctx_t = model._make_ctx(cfg_t, torch.from_numpy(pos.copy()), None, 0)
    y_j, _, _ = jax_blocks.apply_block("attn_bidir", layer_j, jnp.asarray(x),
                                       ctx_j, None)
    y_t, _ = blocks.apply_block("attn_bidir", layer_t, torch.from_numpy(x),
                                ctx_t, None)
    assert _rel(y_t.numpy(), y_j) < REL
    # the last query sees the first key only without the causal mask: a
    # change of the first key's input moves every row
    x2 = x.copy()
    x2[:, -1] += 1.0
    y2, _ = blocks.apply_block("attn_bidir", layer_t, torch.from_numpy(x2),
                               ctx_t, None)
    assert (y2[:, 0] - y_t[:, 0]).abs().max() > 1e-4


# ---------------------------------------------------------------------------
# the two configs through the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "hubert-xlarge"])
def test_forward_and_train_step_match_jax(arch):
    """Logits of ``forward_train`` and the train step's loss and every
    gradient leaf against ``jax.value_and_grad``: qwen2-vl-2b with vision
    inputs and random 3-D positions, hubert-xlarge with frame features and
    a loss mask."""
    cfg_j, cfg_t = jax_smoke(arch), get_smoke_config(arch)
    params_j, params_t = _params(cfg_j, seed=3)
    batch = _batch(cfg_t, np.random.default_rng(4))
    logits_j, _ = jax_forward_train(params_j, _jax(batch), cfg_j,
                                    dtype=jnp.float32)
    logits_t, _ = forward_train(params_t, _torch(batch), cfg_t,
                                dtype=torch.float32)
    assert logits_t.shape == logits_j.shape
    assert _rel(logits_t.numpy(), logits_j) < REL

    def loss_fn(p):
        logits, aux = jax_forward_train(p, _jax(batch), cfg_j,
                                        dtype=jnp.float32)
        loss, _ = jax_cross_entropy(logits, jnp.asarray(batch["labels"]),
                                    _jax(batch).get("loss_mask"),
                                    z_loss=1e-4)
        return loss + cfg_j.router_aux_coef * aux, loss

    (total_j, loss_j), grads_j = jax.value_and_grad(loss_fn, has_aux=True)(
        params_j)
    total_t, (loss_t, _), grads_t = make_loss_and_grad(
        cfg_t, TrainConfig(dtype=torch.float32))(params_t, _torch(batch))
    assert float(loss_t) == pytest.approx(float(loss_j), rel=REL)
    assert float(total_t) == pytest.approx(float(total_j), rel=REL)
    leaves_j = jax.tree_util.tree_flatten_with_path(grads_j)[0]
    leaves_t = tree_leaves(grads_t)
    assert len(leaves_t) == len(leaves_j)
    for (path, g_j), g_t in zip(leaves_j, leaves_t):
        assert g_t.shape == g_j.shape, path
        if np.abs(np.asarray(g_j)).max() == 0:   # hubert's unused embedding
            assert float(g_t.abs().max()) == 0, path
            continue
        assert _rel(g_t.numpy(), g_j) < REL, (jax.tree_util.keystr(path),
                                             _rel(g_t.numpy(), g_j))


def test_qwen2_vl_prefill_and_decode_match_jax():
    """A prompt with patch embeddings and 3-D positions, then greedy decode
    at text positions, as the reference decodes."""
    cfg_j, cfg_t = jax_smoke("qwen2-vl-2b"), get_smoke_config("qwen2-vl-2b")
    params_j, params_t = _params(cfg_j, seed=5)
    batch = _batch(cfg_t, np.random.default_rng(6))
    del batch["labels"]
    max_len = S + 4 + 8
    cache_j = jax_init_cache(cfg_j, B, max_len, jnp.float32)
    last_j, cache_j = jax_prefill(params_j, _jax(batch), cache_j, cfg_j,
                                  dtype=jnp.float32)
    cache_t = init_cache(cfg_t, B, max_len, torch.float32, device="cpu")
    last_t, cache_t = prefill(params_t, _torch(batch), cache_t, cfg_t,
                              dtype=torch.float32)
    scale = float(np.abs(np.asarray(last_j)).max())
    assert np.abs(last_t.numpy() - np.asarray(last_j)).max() / scale < REL
    tok_j = jnp.argmax(last_j, -1)[:, None].astype(jnp.int32)
    tok_t = torch.argmax(last_t, -1)[:, None].to(torch.int32)
    for _ in range(4):
        assert (tok_t.numpy() == np.asarray(tok_j)).all()
        logits_j, cache_j = jax_decode_step(params_j, tok_j, cache_j, cfg_j,
                                            dtype=jnp.float32)
        logits_t, cache_t = decode_step(params_t, tok_t, cache_t, cfg_t,
                                        dtype=torch.float32)
        assert np.abs(logits_t.numpy() - np.asarray(logits_j)).max() \
            / scale < REL
        tok_j = jnp.argmax(logits_j, -1)[:, None].astype(jnp.int32)
        tok_t = torch.argmax(logits_t, -1)[:, None].to(torch.int32)
    assert cache_t["t"] == int(cache_j["t"]) == S + 4


def test_encode_step_matches_jax():
    """hubert's encoder-only step against the reference's on a 1-device
    debug mesh: logits of frame features, no gradient kept."""
    cfg_j, cfg_t = jax_smoke("hubert-xlarge"), get_smoke_config(
        "hubert-xlarge")
    params_j, params_t = _params(cfg_j, seed=7)
    batch = _batch(cfg_t, np.random.default_rng(8))
    mesh = make_debug_mesh(1)
    with mesh:
        want = jax_make_encode_step(cfg_j, mesh, dtype=jnp.float32)(
            params_j, _jax(batch))
    got = make_encode_step(cfg_t, dtype=torch.float32)(
        {k: v for k, v in params_t.items()}, _torch(batch))
    assert not got.requires_grad
    assert got.shape == (B, S, cfg_t.vocab_size)
    assert _rel(got.numpy(), want) < REL


@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "hubert-xlarge"])
def test_synthetic_lm_modality_batches_are_the_jax_packages(arch):
    """The published configs' batches (qwen2-vl-2b's 1024 frontend tokens
    cut to half the sequence), bit for bit, with the modality keys."""
    cfg = get_config(arch)
    ours = iter(SyntheticLM(cfg, batch=2, seq_len=24, seed=5))
    theirs = iter(JaxSyntheticLM(jax_config(arch), batch=2, seq_len=24,
                                 seed=5))
    for _ in range(2):
        a, b = next(ours), next(theirs)
        assert a.keys() == b.keys()
        assert {"features", "vision_embeds"} & set(a)
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k])


def test_put_batch_moves_bool_and_int_leaves_unchanged():
    cfg = get_smoke_config("qwen2-vl-2b")
    batch = next(iter(SyntheticLM(cfg, batch=2, seq_len=16, seed=0)))
    batch["loss_mask"] = np.ones((2, 16), bool)
    moved = Trainer.put_batch(SimpleNamespace(device=torch.device("cpu")),
                              batch)
    assert moved.keys() == batch.keys()
    for k, v in batch.items():
        assert moved[k].dtype == torch.from_numpy(v).dtype, k
        np.testing.assert_array_equal(moved[k].numpy(), v)
    assert moved["vision_mask"].dtype == torch.bool
    assert moved["positions3"].dtype == torch.int32


@pytest.mark.parametrize("arch,dtype", [("qwen2-vl-2b", "bfloat16"),
                                        ("hubert-xlarge", "float32")])
def test_launcher_trains_the_modality_configs_on_cpu(arch, dtype, tmp_path,
                                                     capsys):
    from repro_torch.launch.train import main
    metrics = main(["--arch", arch, "--smoke", "--steps", "3", "--batch",
                    "2", "--seq", "16", "--ckpt-every", "2", "--dtype",
                    dtype, "--workdir", str(tmp_path), "--device", "cpu"])
    assert np.isfinite(metrics["loss"])
    assert "[launch] done:" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "hubert-xlarge"])
def test_bf16_forward_is_finite_on_cpu(arch):
    """The default TrainConfig (bf16) through the stubs on the CPU path."""
    cfg = get_smoke_config(arch)
    params_j, params_t = _params(jax_smoke(arch))
    batch = _batch(cfg, np.random.default_rng(9))
    total, _, grads = make_loss_and_grad(cfg, TrainConfig())(
        params_t, _torch(batch))
    assert np.isfinite(float(total))
    assert all(bool(torch.isfinite(g).all()) for g in tree_leaves(grads))


def test_hubert_weights_cross_the_checkpoint_with_frontend_proj(tmp_path):
    """hubert's tree, ``frontend_proj`` in it, saved by the JAX package's
    checkpoint manager and restored by the port's onto its own freshly
    initialised tree: every leaf bit for bit the bridged JAX weights, with
    no special case for the frontend."""
    cfg_j, cfg_t = jax_smoke("hubert-xlarge"), get_smoke_config(
        "hubert-xlarge")
    params_j, params_t = _params(cfg_j, seed=9)
    fs_j = JaxCannyFS(JaxLocalBackend(str(tmp_path)), workers=4)
    assert JaxCheckpointManager(fs_j, "ck").save(
        3, {"params": params_j}, block=True).ok
    fs_j.close()
    fresh = init_params(cfg_t, device="cpu",
                        generator=torch.Generator().manual_seed(1))
    assert "frontend_proj" in fresh
    fs = CannyFS(LocalBackend(str(tmp_path)), workers=4)
    step, out = TransactionalCheckpointManager(fs, "ck").restore(
        {"params": fresh})
    fs.close()
    assert step == 3
    assert torch.equal(out["params"]["frontend_proj"],
                       params_t["frontend_proj"])
    for a, b in zip(tree_leaves(out["params"]), tree_leaves(params_t)):
        assert a.dtype == b.dtype and torch.equal(a, b)
