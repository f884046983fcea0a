"""The port's serving slice against the JAX package, on the CPU.

Identical weights come from the JAX ``init_params`` tree through
``bridge.params_from_numpy``; tokens are made with numpy.  Logits are held
to the JAX suite's decode-vs-forward bound (``tests/test_models.py``):
2e-4 relative to the largest logit, in fp32.
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

from repro.configs import get_smoke_config as jax_smoke
from repro.models import decode_step as jax_decode_step
from repro.models import forward_train as jax_forward_train
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import param_specs as jax_param_specs
from repro.models import prefill as jax_prefill
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import (decode_step, forward_train, init_cache,
                                init_params, prefill)
from repro_torch.models.bridge import params_from_numpy
from repro_torch.train.steps import make_decode_step, make_prefill_step

ROOT = Path(__file__).resolve().parents[1]
REL = 2e-4
B = 2


def _widened(cfg):
    """d_model 256 with 2 heads over 1 KV head: dh 128 and D % 128 == 0, so
    the JAX side takes both Pallas kernels (at a 256-token prompt)."""
    return dataclasses.replace(cfg, d_model=256, num_heads=2, num_kv_heads=1)


@pytest.mark.parametrize("variant", ["smoke", "widened"])
def test_serving_matches_jax(variant, monkeypatch):
    cfg_j, cfg_t = jax_smoke("qwen2-7b"), get_smoke_config("qwen2-7b")
    S, n_dec = 16, 4
    if variant == "widened":
        cfg_j, cfg_t, S = _widened(cfg_j), _widened(cfg_t), 256
        monkeypatch.setenv("REPRO_KERNELS", "interpret")
    params_j = jax_init_params(jax.random.PRNGKey(1), cfg_j)
    params_t = params_from_numpy(jax.tree.map(np.asarray, params_j),
                                 device="cpu")
    toks = np.random.default_rng(0).integers(
        0, cfg_j.vocab_size, (B, S)).astype(np.int32)

    full_j, _ = jax_forward_train(params_j, {"tokens": jnp.asarray(toks)},
                                  cfg_j, dtype=jnp.float32)
    full_t, aux = forward_train(params_t, {"tokens": torch.from_numpy(toks)},
                                cfg_t, dtype=torch.float32)
    full_j = np.asarray(full_j)
    scale = float(np.abs(full_j).max())
    assert full_t.shape == full_j.shape and float(aux) == 0.0
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


@pytest.mark.parametrize("arch", ["qwen2-7b", "stablelm-3b", "stablelm-12b",
                                  "h2o-danube-3-4b"])
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


@pytest.mark.parametrize("arch", ["mamba2-130m", "recurrentgemma-9b",
                                  "moonshot-v1-16b-a3b", "qwen2-vl-2b",
                                  "hubert-xlarge"])
def test_later_slices_raise(arch):
    with pytest.raises(NotImplementedError):
        init_params(get_smoke_config(arch), device="cpu")


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


_FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|repro)\b(?!_)|[\"']repro\.", re.M)


def test_port_imports_neither_jax_nor_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "examples" / "serve_batch_torch.py"]
    assert len(files) > 20
    offenders = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
                 for f in files for m in _FORBIDDEN.finditer(f.read_text())]
    assert offenders == []
