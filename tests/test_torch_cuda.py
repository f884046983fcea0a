"""The port's CUDA kernels on the card (each test skips without one).

Each kernel against its plain PyTorch version on the same inputs, at the
JAX suite's tolerances (fp32 2e-5, bf16 2e-2), and the serving path on the
card against the same path on the CPU.  This file imports no JAX, so it
runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""
import dataclasses

import pytest
import torch
from numpy.testing import assert_allclose

from repro_torch.configs import get_smoke_config
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import mha_ref
from repro_torch.kernels.rmsnorm.kernel import rmsnorm_cuda
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
from repro_torch.models import init_cache, init_params
from repro_torch.train.steps import make_decode_step, make_prefill_step

DTYPES = [torch.float32, torch.bfloat16]


def tol(dtype):
    t = 2e-2 if dtype == torch.bfloat16 else 2e-5
    return dict(rtol=t, atol=t)


def f32(t: torch.Tensor):
    return t.float().cpu().numpy()


@pytest.fixture
def cuda():
    """The card, or a skip: decided when the test runs, not at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(4, 3584), (3, 100, 512), (5, 130)])
def test_rmsnorm_kernel_matches_plain(cuda, dtype, shape):
    """(5, 130): a bf16 row of 260 bytes takes the scalar path."""
    g = torch.Generator(device=cuda).manual_seed(0)
    x, r = (torch.randn(shape, generator=g, device=cuda).to(dtype)
            for _ in range(2))
    s = torch.randn(shape[-1:], generator=g, device=cuda)
    for res in (None, r):
        before = rmsnorm_cuda.launches
        got = rmsnorm_cuda(x, s, residual=res)
        torch.cuda.synchronize()
        assert rmsnorm_cuda.launches == before + 1
        assert got.dtype == dtype
        assert_allclose(f32(got), f32(rmsnorm_ref(x, s, residual=res)),
                        **tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,H,K,dh,kw", [
    (2, 512, 28, 4, 128, dict(causal=True)),      # qwen2-7b heads
    (1, 200, 4, 2, 64, dict(causal=True)),        # ragged S
    (2, 24, 2, 1, 32, dict(causal=True)),
    (2, 256, 4, 2, 128, dict(causal=True, window=100)),
    (1, 256, 4, 2, 64, dict(causal=True, chunk=128)),
    (1, 130, 2, 2, 128, dict(causal=False)),
])
def test_flash_kernel_matches_plain(cuda, dtype, B, S, H, K, dh, kw):
    g = torch.Generator(device=cuda).manual_seed(1)
    q, k, v = (torch.randn(B, S, n, dh, generator=g, device=cuda).to(dtype)
               for n in (H, K, K))
    before = flash_attention_cuda.launches
    got = flash_attention_cuda(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    assert_allclose(f32(got), f32(mha_ref(q, k, v, **kw)), **tol(dtype))


def test_flash_kernel_reads_strided_inputs(cuda):
    """q/k/v as views of one fused projection, read through their strides."""
    B, S, H, K, dh = 2, 96, 4, 2, 64
    qkv = torch.randn(B, S, (H + 2 * K) * dh, device=cuda)
    q, k, v = qkv.split([H * dh, K * dh, K * dh], dim=-1)
    q, k, v = (t.unflatten(-1, (-1, dh)) for t in (q, k, v))
    assert not q.is_contiguous()
    assert_allclose(f32(flash_attention_cuda(q, k, v)),
                    f32(mha_ref(q, k, v)), **tol(torch.float32))


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    x = torch.ones(4, 256, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        rmsnorm_cuda(x[:, ::2], torch.ones(128, device=cuda))
    with pytest.raises(TypeError):
        rmsnorm_cuda(x.half(), torch.ones(256, device=cuda))
    q = torch.ones(1, 16, 2, 96, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_cuda(q, q, q)
    q = torch.ones(1, 16, 2, 64, device=cuda)
    with pytest.raises(ValueError, match="self-attention"):
        flash_attention_cuda(q, q[:, :8], q[:, :8])


def test_serving_on_card_matches_cpu(cuda):
    """prefill + greedy decode through both kernels against the same steps
    on the CPU (plain versions), fp32, 2e-4 relative."""
    cfg = dataclasses.replace(get_smoke_config("qwen2-7b"), d_model=256,
                              num_heads=2, num_kv_heads=1)   # dh 128
    params = init_params(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 200),
                         generator=torch.Generator().manual_seed(1))
    logits = {}
    for dev in ("cpu", cuda):
        p = _to(params, dev)
        cache = init_cache(cfg, 2, 216, torch.float32, device=dev)
        pre = make_prefill_step(cfg, dtype=torch.float32)
        dec = make_decode_step(cfg, dtype=torch.float32)
        last, cache = pre(p, {"tokens": toks.to(dev)}, cache)
        out = [last]
        tok = torch.argmax(last, -1)[:, None].to(torch.int32)
        for _ in range(4):
            tok, lg, cache = dec(p, tok, cache)
            out.append(lg)
        logits[str(dev)] = torch.stack(out).cpu()
    want = logits["cpu"]
    got = logits[str(cuda)]
    assert float((got - want).abs().max()) / float(want.abs().max()) < 2e-4


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)
