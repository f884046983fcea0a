"""The port's serving slice against the JAX package, on the CPU.

Identical weights come from the JAX ``init_params`` tree through
``bridge.params_from_numpy``; tokens are made with numpy.  Logits are held
to the JAX suite's decode-vs-forward bound (``tests/test_models.py``):
2e-4 relative to the largest logit, in fp32; the RG-LRU state in the cache
to the suite's RG-LRU bound, 1e-4; the Mamba-2 cache (conv and SSD state)
to 2e-4 relative.
"""
import dataclasses
import re
import runpy
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.models.blocks import causal_conv1d as jax_causal_conv1d
from repro.models import decode_step as jax_decode_step
from repro.models import forward_train as jax_forward_train
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import param_specs as jax_param_specs
from repro.models import prefill as jax_prefill
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import (decode_step, forward_train, init_cache,
                                init_params, param_specs, prefill)
from repro_torch.models.blocks import causal_conv1d
from repro_torch.models.bridge import params_from_numpy
from repro_torch.train.steps import make_decode_step, make_prefill_step

ROOT = Path(__file__).resolve().parents[1]
REL = 2e-4
B = 2


def _widened(cfg):
    """d_model 256 with 2 heads over 1 KV head: dh 128 and D % 128 == 0, so
    the JAX side takes both Pallas kernels (at a 256-token prompt)."""
    return dataclasses.replace(cfg, d_model=256, num_heads=2, num_kv_heads=1)


def _serving_matches_jax(cfg_j, cfg_t, S: int, n_dec: int = 4):
    """forward_train, prefill and n_dec greedy decode steps of both packages
    from the same weights and tokens; returns (params, caches) of both."""
    params_j = jax_init_params(jax.random.PRNGKey(1), cfg_j)
    params_t = params_from_numpy(jax.tree.map(np.asarray, params_j),
                                 device="cpu")
    toks = np.random.default_rng(0).integers(
        0, cfg_j.vocab_size, (B, S)).astype(np.int32)

    full_j, aux_j = jax_forward_train(params_j,
                                      {"tokens": jnp.asarray(toks)}, cfg_j,
                                      dtype=jnp.float32)
    full_t, aux = forward_train(params_t, {"tokens": torch.from_numpy(toks)},
                                cfg_t, dtype=torch.float32)
    full_j = np.asarray(full_j)
    scale = float(np.abs(full_j).max())
    assert full_t.shape == full_j.shape
    # the MoE load-balance loss; 0 exactly in both where no layer has one
    assert abs(float(aux) - float(aux_j)) <= 2e-5 * abs(float(aux_j))
    assert np.abs(full_t.numpy() - full_j).max() / scale < REL

    max_len = S + n_dec + 8
    cache_j = jax_init_cache(cfg_j, B, max_len, jnp.float32)
    last_j, cache_j = jax_prefill(params_j, {"tokens": jnp.asarray(toks)},
                                  cache_j, cfg_j, dtype=jnp.float32)
    cache_t = init_cache(cfg_t, B, max_len, torch.float32, device="cpu")
    pre = make_prefill_step(cfg_t, dtype=torch.float32)
    dec = make_decode_step(cfg_t, dtype=torch.float32)
    last_t, cache_t = pre(params_t, {"tokens": torch.from_numpy(toks)},
                          cache_t)
    assert np.abs(last_t.numpy() - np.asarray(last_j)).max() / scale < REL

    tok_j = jnp.argmax(last_j, -1)[:, None].astype(jnp.int32)
    tok_t = torch.argmax(last_t, -1)[:, None].to(torch.int32)
    for _ in range(n_dec):
        assert (tok_t.numpy() == np.asarray(tok_j)).all()
        logits_j, cache_j = jax_decode_step(params_j, tok_j, cache_j, cfg_j,
                                            dtype=jnp.float32)
        tok_j = jnp.argmax(logits_j, -1)[:, None].astype(jnp.int32)
        tok_t, logits_t, cache_t = dec(params_t, tok_t, cache_t)
        err = np.abs(logits_t.numpy() - np.asarray(logits_j)).max()
        assert err / scale < REL
    assert (tok_t.numpy() == np.asarray(tok_j)).all()
    assert cache_t["t"] == int(cache_j["t"]) == S + n_dec
    return (params_j, params_t), (cache_j, cache_t)


@pytest.mark.parametrize("variant", ["smoke", "widened"])
def test_serving_matches_jax(variant, monkeypatch):
    cfg_j, cfg_t = jax_smoke("qwen2-7b"), get_smoke_config("qwen2-7b")
    S = 16
    if variant == "widened":
        cfg_j, cfg_t, S = _widened(cfg_j), _widened(cfg_t), 256
        monkeypatch.setenv("REPRO_KERNELS", "interpret")
    _serving_matches_jax(cfg_j, cfg_t, S)


def _rg_widened(cfg):
    """dh 256, D and W 512, one superblock: the JAX side takes all three
    Pallas kernels (rmsnorm, flash attention at dh 256, RG-LRU) at a
    256-token prompt."""
    return dataclasses.replace(cfg, d_model=512, num_heads=2, num_kv_heads=1,
                               lru_width=512, num_layers=3)


def _close(a, b, tol):
    return np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32)).max() \
        <= tol * (1 + np.abs(np.asarray(b, np.float32)).max())


@pytest.mark.parametrize("variant", ["smoke", "widened"])
def test_recurrentgemma_serving_matches_jax(variant, monkeypatch):
    """Prompts longer than the 16-token window, so the ring cache rolls;
    the caches (RG-LRU state and ring) are held too."""
    arch = "recurrentgemma-9b"
    cfg_j, cfg_t = jax_smoke(arch), get_smoke_config(arch)
    S = 24
    if variant == "widened":
        cfg_j, cfg_t, S = _rg_widened(cfg_j), _rg_widened(cfg_t), 256
        monkeypatch.setenv("REPRO_KERNELS", "interpret")
    assert S > cfg_t.window
    (params_j, params_t), (cache_j, cache_t) = _serving_matches_jax(
        cfg_j, cfg_t, S)
    mixer = params_t["blocks"][0]["mixer"]
    W, Hb = cfg_t.resolved_lru_width, cfg_t.num_heads
    n_sb = cfg_t.n_superblocks
    assert mixer["a_gate_w"].shape == (n_sb, Hb, W // Hb, W // Hb)
    assert mixer["a_param"].shape == (n_sb, W)
    assert mixer["conv_w"].shape == (n_sb, W, cfg_t.ssm_conv)
    assert np.array_equal(mixer["a_param"].numpy(),
                          np.asarray(params_j["blocks"][0]["mixer"]["a_param"]))
    for part in ("blocks", "rem"):
        for c_t, c_j, kind in zip(cache_t[part], cache_j[part],
                                  cfg_t.block_pattern):
            keys = ("h", "conv") if kind == "rglru" else ("k", "v", "pos")
            for key in keys:
                assert _close(c_t[key].numpy(), c_j[key], 1e-4), (part, key)


def _mamba2_widened(cfg):
    """d_model 128 (d_inner 256, so both norms are multiples of 128), P 32,
    N 32, chunk 32: at a 64-token prompt the JAX side takes the rmsnorm and
    SSD Pallas kernels."""
    return dataclasses.replace(cfg, d_model=128, ssm_head_dim=32,
                               ssm_state=32, ssm_chunk=32)


@pytest.mark.parametrize("variant", ["smoke", "widened"])
def test_mamba2_serving_matches_jax(variant, monkeypatch):
    """The smoke prompt (24 tokens, chunk 16) is ragged, so the port's CPU
    prefill runs ``ssd_sequential``; the widened one runs ``ssd_chunked``
    against the JAX Pallas kernels in interpret mode.  The prefill state
    comes from the scan here and from the JAX decode-step fold there."""
    arch = "mamba2-130m"
    cfg_j, cfg_t = jax_smoke(arch), get_smoke_config(arch)
    S = 24
    if variant == "widened":
        cfg_j, cfg_t, S = _mamba2_widened(cfg_j), _mamba2_widened(cfg_t), 64
        monkeypatch.setenv("REPRO_KERNELS", "interpret")
    (params_j, params_t), (cache_j, cache_t) = _serving_matches_jax(
        cfg_j, cfg_t, S)
    mixer = params_t["blocks"][0]["mixer"]
    for name in ("A_log", "D", "dt_bias", "norm", "conv_w", "in_proj"):
        assert np.array_equal(
            mixer[name].numpy(),
            np.asarray(params_j["blocks"][0]["mixer"][name])), name
    assert cache_t["rem"] == [] and len(cache_t["blocks"]) == 1
    c_t, c_j = cache_t["blocks"][0], cache_j["blocks"][0]
    assert c_t["state"].dtype == torch.float32
    for key in ("conv", "state"):
        assert c_t[key].shape == c_j[key].shape
        assert _close(c_t[key].numpy(), c_j[key], REL), key


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv1d_matches_jax(with_state):
    B, S, C, K = 2, 7, 12, 4
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, S, C)).astype(np.float32)
    w = rng.standard_normal((C, K)).astype(np.float32)
    b = rng.standard_normal(C).astype(np.float32)
    state = rng.standard_normal((B, K - 1, C)).astype(np.float32) \
        if with_state else None
    out_j, st_j = jax_causal_conv1d(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
        None if state is None else jnp.asarray(state))
    out_t, st_t = causal_conv1d(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
        None if state is None else torch.from_numpy(state))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(st_t.numpy(), np.asarray(st_j), rtol=2e-5,
                               atol=2e-5)
    # decode: one token against the carried state
    one, st1 = causal_conv1d(torch.from_numpy(x[:, :1]), torch.from_numpy(w),
                             torch.from_numpy(b), st_t)
    one_j, st1_j = jax_causal_conv1d(jnp.asarray(x[:, :1]), jnp.asarray(w),
                                     jnp.asarray(b), st_j)
    np.testing.assert_allclose(one.numpy(), np.asarray(one_j), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(st1.numpy(), np.asarray(st1_j), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("arch", ["qwen2-7b", "stablelm-3b", "stablelm-12b",
                                  "h2o-danube-3-4b", "recurrentgemma-9b",
                                  "mamba2-130m"])
def test_decode_matches_forward(arch):
    """The port's own prefill + decode against its full forward."""
    cfg = get_smoke_config(arch)
    gen = torch.Generator().manual_seed(1)
    params = init_params(cfg, device="cpu", generator=gen)
    toks = torch.randint(0, cfg.vocab_size, (B, 24), generator=gen)
    full, _ = forward_train(params, {"tokens": toks}, cfg, dtype=torch.float32)
    cache = init_cache(cfg, B, 64, torch.float32, device="cpu")
    pre = 16
    last, cache = prefill(params, {"tokens": toks[:, :pre]}, cache, cfg,
                          dtype=torch.float32)
    scale = float(full.abs().max())
    errs = [float((last - full[:, pre - 1]).abs().max())]
    for t in range(pre, 24):
        lg, cache = decode_step(params, toks[:, t:t + 1], cache, cfg,
                                dtype=torch.float32)
        errs.append(float((lg - full[:, t]).abs().max()))
    assert max(errs) / scale < REL, (arch, max(errs) / scale)


def _shapes(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _shapes(sub, f"{prefix}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _shapes(sub, f"{prefix}/{i}").items()}
    return {prefix: tuple(tree.shape)}


@pytest.mark.parametrize("arch", ["qwen2-7b", "stablelm-3b",
                                  "h2o-danube-3-4b"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_init_params_tree_dtype_and_statistics(arch, dtype):
    cfg = get_smoke_config(arch)
    params = init_params(cfg, device="cpu", dtype=dtype,
                         generator=torch.Generator().manual_seed(0))
    assert _shapes(params) == _shapes(jax_param_specs(jax_smoke(arch)))
    leaves = [params["embed"], params["final_norm"]]
    leaves += [t for blk in params["blocks"] for sub in blk.values()
               for t in (sub.values() if isinstance(sub, dict) else [sub])]
    assert all(t.dtype == dtype for t in leaves)
    # truncated normal at ±3σ has std 0.98658 of its untruncated σ
    D = cfg.d_model
    for w, fan_in in ((params["embed"], D),
                      (params["blocks"][0]["mixer"]["wq"], D),
                      (params["blocks"][0]["ffn"]["down"], cfg.d_ff)):
        w = w.float()
        want = 0.98658 * fan_in ** -0.5
        assert abs(float(w.std()) / want - 1) < 0.05
        assert float(w.abs().max()) <= 3 * fan_in ** -0.5 * 1.01
        assert abs(float(w.mean())) < 0.05 * want
    assert bool((params["final_norm"] == 1).all())
    assert bool((params["blocks"][0]["mixer"].get(
        "bq", torch.zeros(1)) == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_init_recurrentgemma_tree_dtype_and_statistics(dtype):
    arch = "recurrentgemma-9b"
    cfg = get_smoke_config(arch)
    params = init_params(cfg, device="cpu", dtype=dtype,
                         generator=torch.Generator().manual_seed(0))
    assert _shapes(params) == _shapes(jax_param_specs(jax_smoke(arch)))
    mixer = params["blocks"][0]["mixer"]
    assert all(t.dtype == dtype for t in mixer.values())
    W, bw = cfg.resolved_lru_width, cfg.resolved_lru_width // cfg.num_heads
    for w, fan_in in ((mixer["in_x"], cfg.d_model), (mixer["a_gate_w"], bw),
                      (mixer["conv_w"], cfg.ssm_conv), (mixer["out"], W)):
        w = w.float()
        want = 0.98658 * fan_in ** -0.5
        assert abs(float(w.std()) / want - 1) < 0.1
        assert float(w.abs().max()) <= 3 * fan_in ** -0.5 * 1.01
    for name in ("a_gate_b", "x_gate_b", "conv_b"):
        assert bool((mixer[name] == 0).all())
    a = torch.exp(-8 * torch.nn.functional.softplus(mixer["a_param"].float()))
    margin = 1e-6 if dtype == torch.float32 else 1e-2   # bf16's 8-bit mantissa
    assert bool((a > 0.9 - margin).all()) and bool((a < 0.999 + margin).all())
    assert float(a.max() - a.min()) > 0.05        # spread over the interval


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_init_mamba2_tree_dtype_and_statistics(dtype):
    arch = "mamba2-130m"
    cfg = get_smoke_config(arch)
    params = init_params(cfg, device="cpu", dtype=dtype,
                         generator=torch.Generator().manual_seed(0))
    assert _shapes(params) == _shapes(jax_param_specs(jax_smoke(arch)))
    assert set(params["blocks"][0]) == {"norm1", "mixer"}    # mixer-only
    mixer = params["blocks"][0]["mixer"]
    assert all(t.dtype == dtype for t in mixer.values())
    H, di, n_sb = cfg.ssm_heads, cfg.d_inner, cfg.n_superblocks
    for w, fan_in in ((mixer["in_proj"], cfg.d_model),
                      (mixer["conv_w"], cfg.ssm_conv),
                      (mixer["out_proj"], di)):
        w = w.float()
        want = 0.98658 * fan_in ** -0.5
        assert abs(float(w.std()) / want - 1) < 0.1
        assert float(w.abs().max()) <= 3 * fan_in ** -0.5 * 1.01
    f32 = torch.float32
    per_head = {
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, dtype=f32)),
        "D": torch.ones(H),
        "dt_bias": torch.log(torch.expm1(torch.linspace(1e-3, 0.1, H,
                                                        dtype=f32))),
    }
    for name, want in per_head.items():
        assert mixer[name].shape == (n_sb, H)
        assert torch.equal(mixer[name], want.to(dtype).expand(n_sb, H))
    assert bool((mixer["norm"] == 1).all()) and mixer["norm"].shape[-1] == di
    assert bool((mixer["conv_b"] == 0).all())
    # the decays exp(-exp(A_log)) span (e^-16, e^-1), the step sizes
    # softplus(dt_bias) span (1e-3, 0.1)
    dt = torch.nn.functional.softplus(mixer["dt_bias"].float())
    assert abs(float(dt.min()) - 1e-3) < 1e-4 and abs(float(dt.max()) - 0.1) < 1e-3


def test_full_mamba2_130m_cache_shapes():
    cfg = get_config("mamba2-130m")
    cache = init_cache(cfg, 4, 552, torch.bfloat16, device="meta")
    ssd = cache["blocks"][0]
    assert ssd["conv"].shape == (24, 4, 3, 1536 + 2 * 128)
    assert ssd["conv"].dtype == torch.bfloat16
    assert ssd["state"].shape == (24, 4, 24, 64, 128)
    assert ssd["state"].dtype == torch.float32
    assert cache["rem"] == []


def test_full_recurrentgemma_9b_cache_shapes():
    cfg = get_config("recurrentgemma-9b")
    Bc = 2
    for max_len, slots in ((552, 552), (4096, 2048)):
        cache = init_cache(cfg, Bc, max_len, torch.bfloat16, device="meta")
        rg, attn = cache["blocks"][0], cache["blocks"][2]
        assert rg["conv"].shape == (12, Bc, 3, 4096)
        assert rg["conv"].dtype == torch.bfloat16
        assert rg["h"].shape == (12, Bc, 4096)
        assert rg["h"].dtype == torch.float32
        assert cache["blocks"][1]["conv"].shape == (12, Bc, 3, 4096)
        assert attn["k"].shape == (12, Bc, slots, 1, 256)
        assert [c["conv"].shape for c in cache["rem"]] == [(Bc, 3, 4096)] * 2
        assert [c["h"].dtype for c in cache["rem"]] == [torch.float32] * 2


def test_param_count_matches_tree():
    cfg = get_smoke_config("qwen2-7b")
    params = init_params(cfg, device="cpu")
    n = sum(int(np.prod(s)) for s in _shapes(params).values())
    assert n == cfg.param_count()


def test_entry_points_need_cuda_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is valid here")
    cfg = get_smoke_config("qwen2-7b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_numpy({"w": np.ones(3, np.float32)})


@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "hubert-xlarge"])
def test_modality_configs_init_with_the_references_tree(arch):
    """The vision and audio stub configs initialise: the smoke config's
    weights and the published config's shapes (on "meta") have the
    reference's keys and shapes, hubert's ``frontend_proj`` (512, d_model)
    among them, drawn at std 512^-0.5."""
    cfg = get_smoke_config(arch)
    params = init_params(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    assert _shapes(params) == _shapes(jax_param_specs(jax_smoke(arch)))
    full = get_config(arch)
    assert _shapes(param_specs(full)) == _shapes(jax_param_specs(
        jax_config(arch)))
    if cfg.modality == "audio_stub":
        w = params["frontend_proj"]
        assert w.shape == (512, cfg.d_model)
        assert abs(float(w.std()) / (0.98658 * 512 ** -0.5) - 1) < 0.05
    else:
        assert "frontend_proj" not in params


def test_full_qwen2_7b_is_supported():
    cfg = get_config("qwen2-7b")
    meta = init_cache(cfg, 1, 8, torch.bfloat16, device="meta")
    assert meta["blocks"][0]["k"].shape == (28, 1, 8, 4, 128)


def test_serve_example_runs_on_cpu(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [
        "serve_batch_torch.py", "--device", "cpu", "--requests", "3",
        "--batch", "2", "--prompt-len", "8", "--max-new", "3"])
    runpy.run_path(str(ROOT / "examples" / "serve_batch_torch.py"),
                   run_name="__main__")
    out = capsys.readouterr().out
    assert "decode_throughput=" in out and "requests=3" in out


def test_serve_example_runs_recurrentgemma_on_cpu(monkeypatch, capsys):
    """A 24-token prompt over the smoke config's 16-token window."""
    monkeypatch.setattr(sys, "argv", [
        "serve_batch_torch.py", "--device", "cpu", "--arch",
        "recurrentgemma-9b", "--requests", "3", "--batch", "2",
        "--max-new", "3"])
    runpy.run_path(str(ROOT / "examples" / "serve_batch_torch.py"),
                   run_name="__main__")
    out = capsys.readouterr().out
    assert "arch=recurrentgemma-9b" in out and "decode_throughput=" in out


def test_serve_example_runs_mamba2_on_cpu(monkeypatch, capsys):
    """The default 24-token prompt over the smoke config's 16-token chunk:
    a ragged prefill."""
    monkeypatch.setattr(sys, "argv", [
        "serve_batch_torch.py", "--device", "cpu", "--arch", "mamba2-130m",
        "--requests", "3", "--batch", "2", "--max-new", "3"])
    runpy.run_path(str(ROOT / "examples" / "serve_batch_torch.py"),
                   run_name="__main__")
    out = capsys.readouterr().out
    assert "arch=mamba2-130m" in out and "decode_throughput=" in out


def test_serve_example_serves_qwen2_vl_and_refuses_hubert(monkeypatch,
                                                          capsys):
    """qwen2-vl-2b's text prompts (M-RoPE at text positions); hubert is
    encoder-only and refused, as the reference's example refuses it."""
    monkeypatch.setattr(sys, "argv", [
        "serve_batch_torch.py", "--device", "cpu", "--arch", "qwen2-vl-2b",
        "--requests", "3", "--batch", "2", "--max-new", "3"])
    runpy.run_path(str(ROOT / "examples" / "serve_batch_torch.py"),
                   run_name="__main__")
    out = capsys.readouterr().out
    assert "arch=qwen2-vl-2b" in out and "decode_throughput=" in out
    monkeypatch.setattr(sys, "argv", [
        "serve_batch_torch.py", "--device", "cpu", "--arch",
        "hubert-xlarge"])
    with pytest.raises(SystemExit, match="encoder-only"):
        runpy.run_path(str(ROOT / "examples" / "serve_batch_torch.py"),
                       run_name="__main__")


_FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|repro)\b(?!_)|[\"']repro\.", re.M)


def test_port_imports_neither_jax_nor_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py"]
    files += [ROOT / "examples" / name
              for name in ("serve_batch_torch.py", "train_lm_torch.py")]
    assert len(files) > 20
    # the mesh slice's modules are among them
    port = ROOT / "src" / "repro_torch"
    assert {port / "launch" / "mesh.py", port / "parallel" / "sharding.py",
            port / "parallel" / "compress.py",
            port / "parallel" / "flash_decode.py",
            port / "parallel" / "pipeline.py",
            port / "parallel" / "collectives.py"} <= set(files)
    offenders = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
                 for f in files for m in _FORBIDDEN.finditer(f.read_text())]
    assert offenders == []
