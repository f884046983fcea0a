"""The port's CUDA kernels on the card (each test skips without one).

Each kernel against its plain PyTorch version on the same inputs, at the
JAX suite's tolerances (fp32 2e-5, bf16 2e-2, the RG-LRU scan 1e-4 in fp32,
the SSD scan 2e-3 fp32 / 5e-2 bf16), and the serving path on the card
against the same path on the CPU.  The backward kernels against their plain
versions on the same inputs (RMSNorm and flash attention: autograd of the
forward in fp32; the scans: ``ssd_chunked_bwd`` and ``rglru_bwd``), and the
training step on the card against the same step on the CPU, for the dense
LM and the SSD and RG-LRU families; the remat policies' bf16 step against
the same step with no remat.  Each body of a kernel is held on its own
(flash attention's sm90, mma, mma_tf32x3 and fp32 bodies and its
backward's sm90, mma_bf16 and mma_tf32x3 bodies, rmsnorm's one-read
and generic bodies and its backward's warp_rows, cta_rows and generic
bodies, the SSD scan's mma, mma_tf32x3 and fma bodies both ways, the RG-LRU
scan's segmented and serial bodies), and the launch counts by body show
which one ran.  This file
imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""
import dataclasses
import runpy
import sys
from pathlib import Path

import pytest
import torch
from numpy.testing import assert_allclose

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import kernel as flash
from repro_torch.kernels.flash_attention.kernel import (
    flash_attention_bwd_cuda, flash_attention_cuda)
from repro_torch.kernels.flash_attention.ref import (attention_mask, lse_ref,
                                                    mha_grads_by_products,
                                                    mha_ref, tf32x3)
from repro_torch.kernels.rglru import kernel as lru
from repro_torch.kernels.rglru.kernel import rglru_bwd_cuda, rglru_cuda
from repro_torch.kernels.rglru.ref import (rglru_assoc, rglru_bwd,
                                           rglru_sequential)
from repro_torch.kernels.rmsnorm import kernel as rms
from repro_torch.kernels.rmsnorm.kernel import rmsnorm_bwd_cuda, rmsnorm_cuda
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
from repro_torch.kernels.ssd import kernel as ssd
from repro_torch.kernels.ssd.kernel import ssd_bwd_cuda, ssd_cuda
from repro_torch.kernels.ssd.ref import (split_bf16, ssd_chunk_scan,
                                         ssd_chunk_state, ssd_chunked,
                                         ssd_chunked_bwd, ssd_sequential,
                                         ssd_state_passing)
from repro_torch.models import init_cache, init_params
from repro_torch.models.blocks import (apply_block, init_attn, init_moe,
                                       record_routes, routes_differ,
                                       topk_margin)
from repro_torch.models.rope import rope_cos_sin
from repro_torch.optim import adamw_update, init_opt_state
from repro_torch.train.steps import (TrainConfig, make_decode_step,
                                     make_loss_and_grad, make_prefill_step,
                                     make_train_step)

ROOT = Path(__file__).resolve().parents[1]
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
    (2, 100, 4, 1, 16, dict(causal=True)),        # every smoke config
    (1, 130, 4, 2, 80, dict(causal=True)),        # stablelm-3b, hubert
    (1, 200, 4, 1, 120, dict(causal=True)),       # h2o-danube: padded to 128
    (1, 96, 2, 1, 160, dict(causal=True)),        # stablelm-12b
    (2, 300, 4, 1, 256, dict(causal=True, window=128)),   # recurrentgemma
    (1, 130, 2, 1, 256, dict(causal=False)),
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


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dh", [80, 256])
def test_flash_kernel_reads_unaligned_inputs(cuda, dtype, dh):
    """Views one element off a 16-byte boundary: the tile loads fall back
    from 16-byte vectors to single elements."""
    B, S, H, K = 2, 70, 2, 1
    g = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = (torch.randn(B, S, n * dh + 1, generator=g, device=cuda)
               .to(dtype)[..., 1:].unflatten(-1, (n, dh)) for n in (H, K, K))
    assert q.data_ptr() % 16
    assert_allclose(f32(flash_attention_cuda(q, k, v)), f32(mha_ref(q, k, v)),
                    **tol(dtype))


# the sm90 body (bf16, dh 80, 120, 128, 160 and 256): ragged S, GQA 7:1 and
# MQA 16:1, window and chunk edges inside tiles, no causal mask; at dh 80
# and 120 (tiles of 128 columns, the columns past dh zero-filled) MHA
# (hubert-xlarge, stablelm-3b) and GQA 4:1 (h2o-danube-3-4b) too; at dh 160
# (Sm90<160>: 64-key tiles, three slabs a row, columns 160-191
# zero-filled) stablelm-12b's GQA 32:8
SM90_CASES = [
    (1, 200, 16, 16, 80, dict(causal=True)),
    (1, 1000, 28, 4, 80, dict(causal=True)),
    (2, 512, 16, 2, 80, dict(causal=True, window=100)),
    (1, 512, 16, 4, 80, dict(causal=True, chunk=96)),
    (2, 300, 16, 16, 80, dict(causal=False)),
    (1, 700, 16, 1, 80, dict(causal=False)),
    (1, 200, 32, 8, 120, dict(causal=True)),
    (1, 1000, 28, 4, 120, dict(causal=True, window=300)),
    (1, 512, 32, 8, 120, dict(causal=True, chunk=96)),
    (2, 300, 16, 16, 120, dict(causal=False)),
    (1, 200, 28, 4, 128, dict(causal=True)),
    (1, 1000, 28, 4, 128, dict(causal=True)),
    (1, 200, 16, 1, 256, dict(causal=True)),
    (1, 1000, 16, 1, 256, dict(causal=True, window=2048)),
    (2, 512, 28, 4, 128, dict(causal=True, window=100)),
    (1, 1000, 16, 1, 256, dict(causal=True, window=300)),
    (1, 512, 28, 4, 128, dict(causal=True, chunk=96)),
    (1, 1000, 16, 1, 256, dict(causal=True, chunk=128)),
    (2, 300, 28, 4, 128, dict(causal=False)),
    (1, 200, 16, 1, 256, dict(causal=False)),
    (1, 200, 32, 8, 160, dict(causal=True)),
    (1, 1000, 32, 8, 160, dict(causal=True, window=300)),
    (1, 512, 16, 4, 160, dict(causal=True, chunk=96)),
    (2, 300, 16, 16, 160, dict(causal=False)),
    (1, 700, 16, 1, 160, dict(causal=True)),
]


@pytest.mark.parametrize("B,S,H,K,dh,kw", SM90_CASES)
def test_flash_sm90_body_matches_plain(cuda, B, S, H, K, dh, kw):
    g = torch.Generator(device=cuda).manual_seed(4)
    q, k, v = (torch.randn(B, S, n, dh, generator=g, device=cuda).bfloat16()
               for n in (H, K, K))
    before = flash_attention_cuda.launches_by_body["sm90"]
    got = flash_attention_cuda(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches_by_body["sm90"] == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert_allclose(f32(got), f32(mha_ref(q, k, v, **kw)),
                    **tol(torch.bfloat16))


@pytest.mark.parametrize("H,K,dh", [(28, 4, 128), (16, 1, 256), (16, 16, 80),
                                    (32, 8, 120), (32, 8, 160)])
def test_flash_sm90_reads_fused_projection_views(cuda, H, K, dh):
    """bf16 q/k/v as 16-byte aligned views of one fused projection: TMA
    reads them through their strides."""
    g = torch.Generator(device=cuda).manual_seed(5)
    qkv = torch.randn(2, 300, (H + 2 * K) * dh, generator=g,
                      device=cuda).bfloat16()
    q, k, v = (t.unflatten(-1, (-1, dh))
               for t in qkv.split([H * dh, K * dh, K * dh], dim=-1))
    assert not q.is_contiguous()
    before = flash_attention_cuda.launches_by_body["sm90"]
    got = flash_attention_cuda(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches_by_body["sm90"] == before + 1
    assert_allclose(f32(got), f32(mha_ref(q, k, v)), **tol(torch.bfloat16))


@pytest.mark.parametrize("B,S,H,K,kw", [
    (1, 300, 32, 8, dict(causal=True)),
    (1, 200, 8, 2, dict(causal=True, window=70)),
    (2, 130, 4, 4, dict(causal=False)),
])
def test_flash_mma_body_forced_at_dh_160_matches_plain(cuda, B, S, H, K, kw):
    """The mma body, the sm90 body's previous body at dh 160, still takes
    aligned bf16 there when forced (``body="mma"``): O within 2e-2 (1 +
    |o|) of mha_ref, its log-sum-exp within 2e-5 (1 + |lse|) of the plain
    one, and the sm90 body's O within the same limit of it."""
    g = torch.Generator(device=cuda).manual_seed(8)
    q, k, v = (torch.randn(B, S, n, 160, generator=g, device=cuda).bfloat16()
               for n in (H, K, K))
    before = dict(flash_attention_cuda.launches_by_body)
    out, lse = flash_attention_cuda(q, k, v, return_lse=True, body="mma",
                                    **kw)
    new = flash_attention_cuda(q, k, v, **kw)
    torch.cuda.synchronize()
    after = flash_attention_cuda.launches_by_body
    assert {b: after[b] - before[b] for b in after} == {
        "sm90": 1, "mma": 1, "mma_tf32x3": 0, "fp32": 0}
    assert_allclose(f32(out), f32(mha_ref(q, k, v, **kw)),
                    **tol(torch.bfloat16))
    assert _within(lse, lse_ref(q, k, **kw), 2e-5)
    assert _within(new, out, 2e-2)


def test_flash_launches_count_by_body(cuda):
    """Each input takes the body its dtype, head dim and alignment pick."""
    def make(dh, dtype, offset=0):
        t = torch.ones(1, 64, 2 * dh + offset, device=cuda, dtype=dtype)
        return t[..., offset:].unflatten(-1, (2, dh))

    for q, body in [(make(128, torch.bfloat16), "sm90"),
                    (make(256, torch.bfloat16), "sm90"),
                    (make(80, torch.bfloat16), "sm90"),
                    (make(160, torch.bfloat16), "sm90"),
                    (make(160, torch.bfloat16, offset=1), "mma"),
                    (make(128, torch.float32), "mma_tf32x3"),
                    (make(64, torch.float32, offset=1), "mma_tf32x3"),
                    (make(256, torch.float32), "mma_tf32x3"),
                    (make(64, torch.bfloat16), "mma"),
                    (make(128, torch.bfloat16, offset=1), "mma")]:
        before = dict(flash_attention_cuda.launches_by_body)
        total = flash_attention_cuda.launches
        flash_attention_cuda(q, q, q)
        torch.cuda.synchronize()
        after = flash_attention_cuda.launches_by_body
        assert flash_attention_cuda.launches == total + 1
        assert {b: after[b] - before[b] for b in after} == {
            b: int(b == body) for b in after}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows", [1, 4, 2048])
@pytest.mark.parametrize("D", [768, 1536, 3584, 4096])
def test_rmsnorm_one_read_body_matches_plain(cuda, D, rows, dtype):
    """The served widths (mamba2-130m 768 and its gated norm's 1536,
    qwen2-7b 3584, recurrentgemma-9b 4096), with and without a residual."""
    g = torch.Generator(device=cuda).manual_seed(6)
    x, r = (torch.randn(rows, D, generator=g, device=cuda).to(dtype)
            for _ in range(2))
    s = torch.randn(D, generator=g, device=cuda).to(dtype)
    for res in (None, r):
        before = rmsnorm_cuda.launches_by_body["one_read"]
        got = rmsnorm_cuda(x, s, residual=res)
        torch.cuda.synchronize()
        assert rmsnorm_cuda.launches_by_body["one_read"] == before + 1
        assert got.dtype == dtype
        assert_allclose(f32(got), f32(rmsnorm_ref(x, s, residual=res)),
                        **tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows", [4, 2048])
def test_rmsnorm_odd_width_takes_generic_body(cuda, dtype, rows):
    """D 130: a row that is not of 16-byte vectors."""
    g = torch.Generator(device=cuda).manual_seed(7)
    x, r = (torch.randn(rows, 130, generator=g, device=cuda).to(dtype)
            for _ in range(2))
    s = torch.randn(130, generator=g, device=cuda).to(dtype)
    for res in (None, r):
        before = rmsnorm_cuda.launches_by_body["generic"]
        got = rmsnorm_cuda(x, s, residual=res)
        torch.cuda.synchronize()
        assert rmsnorm_cuda.launches_by_body["generic"] == before + 1
        assert_allclose(f32(got), f32(rmsnorm_ref(x, s, residual=res)),
                        **tol(dtype))


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    x = torch.ones(4, 256, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        rmsnorm_cuda(x[:, ::2], torch.ones(128, device=cuda))
    with pytest.raises(TypeError):
        rmsnorm_cuda(x.half(), torch.ones(256, device=cuda))
    q = torch.ones(1, 16, 2, 264, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_cuda(q, q, q)
    q = torch.ones(1, 16, 2, 64, device=cuda)
    with pytest.raises(ValueError, match="self-attention"):
        flash_attention_cuda(q, q[:, :8], q[:, :8])
    la = torch.zeros(2, 4, 8, device=cuda)
    with pytest.raises(ValueError, match="h0"):
        rglru_cuda(la, la, torch.zeros(2, 8, device=cuda).bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        rglru_cuda(la.transpose(1, 2), la.transpose(1, 2))
    with pytest.raises(TypeError):
        rglru_cuda(la.half(), la.half())
    with pytest.raises(TypeError, match="one dtype"):
        rglru_cuda(la, la.bfloat16())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,W", [(4, 512, 4096), (2, 37, 200), (3, 1, 130)])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_kernel_matches_plain(cuda, dtype, B, S, W, with_h0):
    g = torch.Generator(device=cuda).manual_seed(2)
    la = -torch.nn.functional.softplus(
        torch.randn(B, S, W, generator=g, device=cuda)).to(dtype)
    gx = torch.randn(B, S, W, generator=g, device=cuda).to(dtype)
    h0 = torch.randn(B, W, generator=g, device=cuda) if with_h0 else None
    before = rglru_cuda.launches
    y, h_last = rglru_cuda(la, gx, h0)
    torch.cuda.synchronize()
    assert rglru_cuda.launches == before + 1
    assert y.dtype == dtype and h_last.dtype == torch.float32
    want_y, want_h = rglru_sequential(la, gx, h0)
    t = 2e-2 if dtype == torch.bfloat16 else 1e-4
    assert_allclose(f32(y), f32(want_y), rtol=t, atol=t)
    assert_allclose(f32(h_last), f32(want_h), rtol=1e-4, atol=1e-4)


def _ssd_inputs(dev, B, S, H, P, G, N, dtype, seed=4):
    """Inputs as the JAX suite draws them (``tests/test_kernels.py``)."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    x = randn(B, S, H, P).to(dtype)
    dt = torch.nn.functional.softplus(randn(B, S, H))
    A = -torch.exp(randn(H) * 0.5)
    Bm, Cm = ((randn(B, S, G, N) * 0.3).to(dtype) for _ in range(2))
    return x, dt, A, Bm, Cm, randn(H)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,H,P,G,N,chunk", [
    (2, 256, 4, 64, 1, 128, 128),     # mamba2-130m's head and state dims
    (1, 200, 4, 64, 1, 128, 128),     # ragged last chunk
    (2, 256, 4, 32, 2, 64, 64),       # two groups, chunk 64
    (1, 37, 2, 16, 1, 16, 16),        # the smoke config, ragged
    (1, 90, 3, 24, 3, 8, 20),         # chunk not a multiple of 4
    (1, 64, 2, 128, 1, 32, 32),       # P 128: two blocks over the head dim
    (1, 512, 2, 128, 1, 128, 256),    # chunk 256: a tile of 128
    (2, 300, 4, 64, 1, 128, 256),     # chunk 256, ragged
])
def test_ssd_kernel_matches_plain(cuda, dtype, B, S, H, P, G, N, chunk):
    args = _ssd_inputs(cuda, B, S, H, P, G, N, dtype)
    before = ssd_cuda.launches
    y, state = ssd_cuda(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_cuda.launches == before + 1
    assert y.dtype == dtype and state.dtype == torch.float32
    assert y.shape == (B, S, H, P) and state.shape == (B, H, P, N)
    want_y, want_state = (ssd_chunked(*args, chunk=chunk) if S % chunk == 0
                          else ssd_sequential(*args))
    t = 5e-2 if dtype == torch.bfloat16 else 2e-3
    assert_allclose(f32(y), f32(want_y), rtol=t, atol=t)
    assert_allclose(f32(state), f32(want_state), rtol=t, atol=t)


@pytest.mark.parametrize("B,S,H,P,G,N,chunk", [
    (8, 1024, 24, 64, 1, 128, 128), (2, 300, 4, 32, 2, 64, 64),
    (1, 17, 8, 128, 1, 64, 16), (8, 1024, 12, 128, 1, 128, 128),
    (2, 1000, 12, 72, 2, 128, 128)])
def test_ssd_twin_workspaces_are_the_librarys(cuda, B, S, H, P, G, N,
                                              chunk):
    """The workspace sizes the shape-only twins allocate (Python mirrors of
    ``csrc/ssd.cu``) against the library's own ``*_workspace_floats``."""
    shape = (B, S, H, P, G, N, chunk)
    assert ssd.fwd_tf32_workspace_floats(*shape) == \
        ssd._entry("ssd_fwd_mma_tf32_workspace_floats")(*shape)
    for body, name in (("fma", "ssd_bwd_workspace_floats"),
                       ("mma", "ssd_bwd_mma_workspace_floats")):
        assert ssd.bwd_workspace_floats(body, *shape) == \
            ssd._entry(name)(*shape)


def test_ssd_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    args = list(_ssd_inputs(cuda, 1, 32, 4, 16, 1, 16, torch.float32))
    x, dt, A, Bm, Cm, D = args
    with pytest.raises(ValueError, match="CUDA tensors"):
        ssd_cuda(*(t.cpu() for t in args), chunk=16)
    with pytest.raises(ValueError, match="divide"):
        ssd_cuda(x, dt, A, *(torch.ones(1, 32, 3, 16, device=cuda)
                             for _ in range(2)), D, chunk=16)
    with pytest.raises(ValueError, match="P=136"):
        ssd_cuda(torch.ones(1, 32, 4, 136, device=cuda), dt, A, Bm, Cm, D,
                 chunk=16)
    with pytest.raises(ValueError, match="N=136"):
        ssd_cuda(x, dt, A, *(torch.ones(1, 32, 1, 136, device=cuda)
                             for _ in range(2)), D, chunk=16)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_cuda(x.transpose(2, 3).contiguous().transpose(2, 3), dt, A, Bm,
                 Cm, D, chunk=16)
    with pytest.raises(ValueError, match="chunk"):
        ssd_cuda(x, dt, A, Bm, Cm, D, chunk=8)
    with pytest.raises(TypeError, match="one dtype"):
        ssd_cuda(x, dt, A, Bm.bfloat16(), Cm, D, chunk=16)


@pytest.mark.parametrize("B,S,H,P,G,N,chunk", [
    (4, 512, 24, 64, 1, 128, 128),    # mamba2-130m's serving shape
    (2, 1000, 24, 64, 1, 128, 128),   # ragged last chunk
    (2, 256, 8, 64, 2, 128, 64),      # two groups, chunk 64
    (1, 90, 3, 24, 3, 8, 20),         # chunk not a multiple of 16, N 8
    (1, 64, 2, 128, 1, 32, 32),       # P 128
    (1, 37, 2, 16, 1, 16, 16),        # the smoke config, ragged
    (2, 512, 4, 128, 1, 128, 128),    # P, N and chunk 128
    (2, 1000, 4, 128, 1, 128, 256),   # chunk 256, ragged: a tile of 128
])
def test_ssd_mma_body_matches_plain(cuda, B, S, H, P, G, N, chunk):
    args = _ssd_inputs(cuda, B, S, H, P, G, N, torch.bfloat16)
    before = ssd_cuda.launches_by_body["mma"]
    y, state = ssd_cuda(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_cuda.launches_by_body["mma"] == before + 1
    assert y.dtype == torch.bfloat16 and state.dtype == torch.float32
    want_y, want_state = (ssd_chunked(*args, chunk=chunk) if S % chunk == 0
                          else ssd_sequential(*args))
    assert_allclose(f32(y), f32(want_y), rtol=5e-2, atol=5e-2)
    assert_allclose(f32(state), f32(want_state), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("B,S,H,P,G,N,chunk", [
    (4, 512, 24, 64, 1, 128, 128),    # mamba2-130m's serving shape
    (2, 1000, 24, 64, 1, 128, 128),   # ragged last chunk
    (2, 256, 8, 64, 2, 128, 64),      # two groups, chunk 64
])
def test_ssd_mma_body_keeps_the_split_operands(cuda, B, S, H, P, G, N,
                                               chunk):
    """y within one bf16 step (2^-7) of the plain phases run with the fp32
    operands (w∘x, the scores, the state) split into bf16 hi + lo as the
    body splits them.  Rounding them to plain bf16 instead puts y further
    off than that (tests/test_torch_kernels.py), which the bf16 tolerance
    of 5e-2 against ``ssd_chunked`` does not show."""
    x, dt, A, Bm, Cm, D = args = _ssd_inputs(cuda, B, S, H, P, G, N,
                                             torch.bfloat16)
    y, _ = ssd_cuda(*args, chunk=chunk)
    states, cum = ssd_chunk_state(x, dt, A, Bm, chunk=chunk,
                                  round_operand=split_bf16)
    states_in, _ = ssd_state_passing(states, cum, chunk=chunk)
    want = ssd_chunk_scan(x, dt, Bm, Cm, D, cum, states_in, chunk=chunk,
                          round_operand=split_bf16)
    assert_allclose(f32(y), f32(want), rtol=2 ** -7, atol=2 ** -7)


def test_ssd_mma_body_reads_unaligned_views(cuda):
    """x, Bm and Cm one element off a 16-byte boundary: the wrapper hands
    the body aligned copies."""
    B, S, H, P, G, N = 1, 200, 4, 32, 1, 64
    args = list(_ssd_inputs(cuda, B, S, H, P, G, N, torch.bfloat16))
    for i in (0, 3, 4):
        t = args[i]
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)
        args[i] = flat[1:].view(t.shape).copy_(t)
        assert args[i].data_ptr() % 16 and args[i].is_contiguous()
    y, state = ssd_cuda(*args, chunk=64)
    want_y, want_state = ssd_sequential(*args)
    assert_allclose(f32(y), f32(want_y), rtol=5e-2, atol=5e-2)
    assert_allclose(f32(state), f32(want_state), rtol=2e-3, atol=2e-3)


def test_ssd_fma_body_forced_on_bf16_matches_mma(cuda):
    """``body="fma"`` runs the fp32-product body on bf16 inputs."""
    args = _ssd_inputs(cuda, 2, 300, 8, 64, 1, 128, torch.bfloat16)
    before = dict(ssd_cuda.launches_by_body)
    y_fma, s_fma = ssd_cuda(*args, body="fma")
    y_mma, s_mma = ssd_cuda(*args)
    torch.cuda.synchronize()
    assert {b: ssd_cuda.launches_by_body[b] - before[b]
            for b in before} == {"mma": 1, "mma_tf32x3": 0, "fma": 1}
    assert_allclose(f32(y_mma), f32(y_fma), rtol=5e-2, atol=5e-2)
    assert_allclose(f32(s_mma), f32(s_fma), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("B,S,H,P,G,N,chunk", [
    (8, 1024, 24, 64, 1, 128, 128),   # mamba2-130m's train step
    (2, 1000, 24, 64, 1, 128, 128),   # ragged last chunk
    (2, 256, 8, 64, 2, 128, 64),      # two groups, chunk 64
    (1, 90, 3, 24, 3, 8, 20),         # chunk not a multiple of 16, N 8
    (1, 384, 2, 128, 1, 128, 128),    # P, N and chunk 128: the largest blocks
    (1, 130, 2, 120, 2, 24, 16),
    (1, 37, 2, 16, 1, 16, 16),        # the smoke config, ragged
    (1, 512, 2, 128, 1, 128, 256),    # chunk 256: both bodies at a tile of 128
])
def test_ssd_mma_tf32x3_body_matches_plain(cuda, B, S, H, P, G, N, chunk):
    """The fp32 forward on the TF32 tensor cores against the plain scan and
    against the fma body forced on the same inputs, at 2e-3; two calls give
    the same bits."""
    args = _ssd_inputs(cuda, B, S, H, P, G, N, torch.float32)
    before = dict(ssd_cuda.launches_by_body)
    y, state = ssd_cuda(*args, chunk=chunk)
    y2, state2 = ssd_cuda(*args, chunk=chunk)
    y_fma, state_fma = ssd_cuda(*args, chunk=chunk, body="fma")
    torch.cuda.synchronize()
    assert {b: ssd_cuda.launches_by_body[b] - before[b] for b in before} \
        == {"mma": 0, "mma_tf32x3": 2, "fma": 1}
    assert torch.equal(y, y2) and torch.equal(state, state2)
    want_y, want_state = (ssd_chunked(*args, chunk=chunk) if S % chunk == 0
                          else ssd_sequential(*args))
    for got, want in ((y, want_y), (state, want_state), (y, y_fma),
                      (state, state_fma)):
        assert_allclose(f32(got), f32(want), rtol=2e-3, atol=2e-3)


FLASH_TF32_CASES = [
    (16, 256, 8, 4, 64, dict(causal=True)),        # the 100m step
    (2, 100, 4, 1, 16, dict(causal=True)),
    (2, 128, 8, 4, 32, dict(causal=True)),
    (1, 300, 32, 32, 80, dict(causal=True)),
    (2, 200, 8, 2, 64, dict(causal=True, window=50)),
    (2, 200, 8, 2, 64, dict(causal=True, chunk=48)),
    (1, 130, 4, 4, 80, dict(causal=False)),
    (2, 190, 16, 2, 64, dict(causal=True)),        # GQA 8, ragged S
    (1, 200, 4, 1, 120, dict(causal=True)),
    (1, 512, 8, 2, 128, dict(causal=True, window=100)),
    (1, 130, 4, 4, 128, dict(causal=False)),
    # 8 warps a CTA: stablelm-12b's 160 and recurrentgemma-9b's 256, GQA,
    # MQA, window and chunk masks, ragged S
    (2, 190, 8, 2, 160, dict(causal=True, window=70)),
    (1, 130, 4, 4, 160, dict(causal=True, chunk=48)),
    (4, 512, 16, 1, 256, dict(causal=True, window=2048)),
    (2, 300, 8, 1, 256, dict(causal=True, window=100)),
    (1, 200, 4, 2, 256, dict(causal=True, chunk=64)),
    (1, 100, 4, 1, 256, dict(causal=False)),
]


@pytest.mark.parametrize("B,S,H,K,dh,kw", FLASH_TF32_CASES)
def test_flash_mma_tf32x3_body_matches_plain(cuda, B, S, H, K, dh, kw):
    """The fp32 forward on the TF32 tensor cores at every head dim it
    takes, masks, GQA and ragged S: o against ``mha_ref`` and the fp32 FMA
    body forced on the same inputs, and its log-sum-exp, at 2e-5."""
    g = torch.Generator(device=cuda).manual_seed(6)
    q, k, v = (torch.randn(B, S, n, dh, generator=g, device=cuda)
               for n in (H, K, K))
    before = dict(flash_attention_cuda.launches_by_body)
    by_dh = flash_attention_cuda.launches_by_head_dim["mma_tf32x3"]
    before_dh = by_dh.get(dh, 0)
    out, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
    prev, prev_lse = flash_attention_cuda(q, k, v, return_lse=True,
                                          body="fp32", **kw)
    torch.cuda.synchronize()
    after = flash_attention_cuda.launches_by_body
    assert {b: after[b] - before[b] for b in after} == {
        "sm90": 0, "mma": 0, "mma_tf32x3": 1, "fp32": 1}
    assert by_dh[dh] == before_dh + 1
    for got, want in ((out, mha_ref(q, k, v, **kw)), (out, prev),
                      (lse, lse_ref(q, k, **kw)), (lse, prev_lse)):
        assert_allclose(f32(got), f32(want), **tol(torch.float32))


@pytest.mark.parametrize("which", ["ssd", "flash"])
def test_new_fp32_bodies_raise_rather_than_fall_back(cuda, which,
                                                     monkeypatch):
    """A failed launch of the mma_tf32x3 bodies raises and counts nothing;
    a failed build raises too: no other body runs in their place."""
    from repro_torch.kernels import _build
    if which == "ssd":
        args = _ssd_inputs(cuda, 1, 64, 2, 16, 1, 16, torch.float32)
        module, fn = ssd, lambda: ssd_cuda(*args, chunk=16)
    else:
        q = torch.randn(1, 64, 2, 64, device=cuda)
        module, fn = flash, lambda: flash_attention_cuda(q, q, q)
    wrapper = ssd_cuda if which == "ssd" else flash_attention_cuda
    real = module._entry
    monkeypatch.setattr(module, "_entry", lambda name, *a: (
        (lambda *args: 700) if "tf32" in name else real(name, *a)))
    before = dict(wrapper.launches_by_body)
    with pytest.raises(RuntimeError, match="mma_tf32x3"):
        fn()
    assert wrapper.launches_by_body == before
    monkeypatch.setattr(module, "_entry", real)

    def no_build(name):
        raise RuntimeError(f"nvcc failed for {name}")

    monkeypatch.setattr(_build, "load", no_build)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        fn()
    assert wrapper.launches_by_body == before


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,W", [(4, 512, 4096), (1, 2176, 4096),
                                   (2, 1000, 200), (2, 37, 200),
                                   (3, 64, 130)])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_segmented_body_matches_plain(cuda, dtype, B, S, W, with_h0):
    """The segmented body against both plain scans, at the serving shape,
    the serve_check prompt (2176), ragged S and W; S 37 forced (it takes
    every S; ``select_body`` sends it S >= 64)."""
    g = torch.Generator(device=cuda).manual_seed(8)
    la = -torch.nn.functional.softplus(
        torch.randn(B, S, W, generator=g, device=cuda)).to(dtype)
    gx = torch.randn(B, S, W, generator=g, device=cuda).to(dtype)
    h0 = torch.randn(B, W, generator=g, device=cuda) if with_h0 else None
    before = rglru_cuda.launches_by_body["segmented"]
    y, h_last = rglru_cuda(la, gx, h0, body="segmented")
    torch.cuda.synchronize()
    assert rglru_cuda.launches_by_body["segmented"] == before + 1
    assert y.dtype == dtype and h_last.dtype == torch.float32
    t = 2e-2 if dtype == torch.bfloat16 else 1e-4
    for want_y, want_h in (rglru_sequential(la, gx, h0),
                           rglru_assoc(la, gx, h0)):
        assert_allclose(f32(y), f32(want_y), rtol=t, atol=t)
        assert_allclose(f32(h_last), f32(want_h), rtol=1e-4, atol=1e-4)


def test_scan_launches_count_by_body(cuda):
    """bf16 SSD inputs take the mma body and fp32 the mma_tf32x3 body;
    RG-LRU prefill (S >= 64) takes the segmented body and decode the serial
    one."""
    def delta(fn, call):
        before, total = dict(fn.launches_by_body), fn.launches
        call()
        torch.cuda.synchronize()
        assert fn.launches == total + 1
        return {b: fn.launches_by_body[b] - before[b] for b in before}

    for dtype, body in ((torch.bfloat16, "mma"),
                        (torch.float32, "mma_tf32x3")):
        args = _ssd_inputs(cuda, 1, 64, 2, 16, 1, 16, dtype)
        assert delta(ssd_cuda, lambda: ssd_cuda(*args, chunk=16)) == {
            b: int(b == body) for b in ssd.BODIES}
    for S, body in ((64, "segmented"), (512, "segmented"), (63, "serial"),
                    (1, "serial")):
        la = torch.zeros(4, S, 4096, device=cuda)
        h0 = torch.zeros(4, 4096, device=cuda)
        assert delta(rglru_cuda, lambda: rglru_cuda(la, la, h0)) == {
            b: int(b == body) for b in ("segmented", "serial")}


def test_scan_wrappers_raise_on_a_body_that_does_not_take_the_inputs(cuda):
    args = _ssd_inputs(cuda, 1, 32, 2, 16, 1, 16, torch.float32)
    with pytest.raises(ValueError, match="body"):
        ssd_cuda(*args, chunk=16, body="mma")
    with pytest.raises(ValueError, match="body"):
        ssd_cuda(*args, chunk=16, body="wgmma")
    la = torch.zeros(1, 8, 16, device=cuda)
    with pytest.raises(ValueError, match="body"):
        rglru_cuda(la, la, body="parallel")


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


def test_recurrentgemma_serving_on_card_matches_cpu(cuda):
    """The smoke recurrentgemma (dh 16, window 16) with a 24-token prompt,
    so the ring cache rolls: RG-LRU, flash attention and rmsnorm kernels on
    the card against the plain versions on the CPU, fp32, 2e-4 relative.
    cuDNN's TF32 is off for the depthwise conv, as fp32 is compared."""
    cfg = get_smoke_config("recurrentgemma-9b")
    params = init_params(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 24),
                         generator=torch.Generator().manual_seed(1))
    logits, hs = {}, {}
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        for dev in ("cpu", cuda):
            p = _to(params, dev)
            cache = init_cache(cfg, 2, 40, torch.float32, device=dev)
            pre = make_prefill_step(cfg, dtype=torch.float32)
            dec = make_decode_step(cfg, dtype=torch.float32)
            last, cache = pre(p, {"tokens": toks.to(dev)}, cache)
            out = [last]
            tok = torch.argmax(last, -1)[:, None].to(torch.int32)
            for _ in range(4):
                tok, lg, cache = dec(p, tok, cache)
                out.append(lg)
            logits[str(dev)] = torch.stack(out).cpu()
            hs[str(dev)] = cache["rem"][1]["h"].cpu()
    want, got = logits["cpu"], logits[str(cuda)]
    assert float((got - want).abs().max()) / float(want.abs().max()) < 2e-4
    assert_allclose(f32(hs[str(cuda)]), f32(hs["cpu"]), rtol=1e-4, atol=1e-4)


def test_mamba2_serving_on_card_matches_cpu(cuda):
    """The smoke mamba2 (chunk 16) with a 24-token prompt, so the kernel pads
    its last chunk and hands its final state to the decode steps: the SSD
    and rmsnorm kernels on the card against the plain versions on the CPU,
    fp32, 2e-4 relative; the cache state at the SSD scan's 2e-3."""
    cfg = get_smoke_config("mamba2-130m")
    params = init_params(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 24),
                         generator=torch.Generator().manual_seed(1))
    logits, states = {}, {}
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        for dev in ("cpu", cuda):
            p = _to(params, dev)
            cache = init_cache(cfg, 2, 40, torch.float32, device=dev)
            pre = make_prefill_step(cfg, dtype=torch.float32)
            dec = make_decode_step(cfg, dtype=torch.float32)
            last, cache = pre(p, {"tokens": toks.to(dev)}, cache)
            out = [last]
            tok = torch.argmax(last, -1)[:, None].to(torch.int32)
            for _ in range(4):
                tok, lg, cache = dec(p, tok, cache)
                out.append(lg)
            logits[str(dev)] = torch.stack(out).cpu()
            states[str(dev)] = cache["blocks"][0]["state"].cpu()
    want, got = logits["cpu"], logits[str(cuda)]
    assert float((got - want).abs().max()) / float(want.abs().max()) < 2e-4
    assert_allclose(f32(states[str(cuda)]), f32(states["cpu"]), rtol=2e-3,
                    atol=2e-3)


@pytest.mark.parametrize("argv", [[], ["--arch", "recurrentgemma-9b"],
                                  ["--arch", "mamba2-130m"]])
def test_serve_example_runs_on_card(cuda, argv, monkeypatch, capsys):
    """The example at its defaults (smoke qwen2-7b, dh 16), on
    recurrentgemma and on mamba2, on the card."""
    monkeypatch.setattr(sys, "argv", ["serve_batch_torch.py", *argv,
                                      "--requests", "3", "--max-new", "3"])
    runpy.run_path(str(ROOT / "examples" / "serve_batch_torch.py"),
                   run_name="__main__")
    assert "decode_throughput=" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# backward kernels and training
# ---------------------------------------------------------------------------

def _within(got, want, t):
    """|got - want| <= t (1 + |want|) everywhere, on finite values."""
    got, want = got.float().cpu(), want.float().cpu()
    return bool(torch.isfinite(got).all()) and bool(
        ((got - want).abs() <= t * (1 + want.abs())).all())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows,D", [(4096, 512), (300, 256), (7, 64),
                                    (33, 130), (5, 3584), (6, 2048)])
def test_rmsnorm_bwd_kernel_matches_plain(cuda, dtype, rows, D):
    """dx and dscale against autograd of rmsnorm_ref in fp32 on the same
    inputs; (4096, 512) is the 100m preset's step (the warp_rows body),
    3584 and 2048 take the cta_rows body and 130 the generic body;
    dscale's order is fixed, so a second call gives the same bits."""
    g = torch.Generator(device=cuda).manual_seed(0)
    x, dy = (torch.randn(rows, D, generator=g, device=cuda).to(dtype)
             for _ in range(2))
    s = torch.randn(D, generator=g, device=cuda).to(dtype)
    body = rms.select_bwd_body(x, s, dy)[0]
    assert body == ("generic" if D == 130 else "warp_rows" if D <= 1024
                    else "cta_rows")
    before = dict(rmsnorm_bwd_cuda.launches_by_body)
    dx, ds = rmsnorm_bwd_cuda(x, s, dy)
    dx2, ds2 = rmsnorm_bwd_cuda(x, s, dy)
    torch.cuda.synchronize()
    assert rmsnorm_bwd_cuda.launches_by_body[body] == before[body] + 2
    assert dx.dtype == dtype and ds.dtype == dtype
    xf, sf = x.float().requires_grad_(), s.float().requires_grad_()
    rmsnorm_ref(xf, sf).backward(dy.float())
    t = 2e-5 if dtype == torch.float32 else 2e-2
    assert _within(dx, xf.grad, t) and _within(ds, sf.grad, t)
    assert torch.equal(dx, dx2) and torch.equal(ds, ds2)


@pytest.mark.parametrize("rows,D", [(8192, 768), (8192, 1536), (2048, 4096)])
def test_rmsnorm_bwd_holds_at_the_recurrent_train_shapes(cuda, rows, D):
    """fp32 dx and dscale at mamba2-130m's norm1 (warp_rows) and gated norm
    (cta_rows) and recurrentgemma-9b's norm (cta_rows) against a float64
    evaluation at 2e-5: at 8192 rows rmsnorm_ref's own fp32 dscale strays
    from the exact sum by more than that, so the kernel is held against
    the exact one."""
    g = torch.Generator(device=cuda).manual_seed(0)
    x, dy = (torch.randn(rows, D, generator=g, device=cuda)
             for _ in range(2))
    s = torch.randn(D, generator=g, device=cuda)
    body = rms.select_bwd_body(x, s, dy)[0]
    assert body == ("warp_rows" if D <= 1024 else "cta_rows")
    dx, ds = rmsnorm_bwd_cuda(x, s, dy)
    xd, sd, gd = x.double(), s.double(), dy.double()
    rstd = torch.rsqrt(xd.square().mean(-1, keepdim=True) + 1e-6)
    xh, gs = xd * rstd, gd * sd
    want_dx = rstd * (gs - xh * (gs * xh).mean(-1, keepdim=True))
    want_ds = (gd * xh).sum(0)
    for got, want in ((dx, want_dx), (ds, want_ds)):
        err = (got.double() - want).abs()
        assert bool((err <= 2e-5 * (1 + want.abs())).all())


def _rmsnorm_f64_grads(x, s, dy):
    """(dx, dscale) of rmsnorm_ref's function evaluated in float64."""
    xd, sd, gd = x.double(), s.double(), dy.double()
    rstd = torch.rsqrt(xd.square().mean(-1, keepdim=True) + 1e-6)
    xh, gs = xd * rstd, gd * sd
    return (rstd * (gs - xh * (gs * xh).mean(-1, keepdim=True)),
            (gd * xh).sum(0))


@pytest.mark.parametrize("rows,D,dtype", [
    (8192, 1536, torch.float32), (2048, 4096, torch.float32),
    (300, 5120, torch.float32), (64, 8192, torch.float32),
    (2048, 4096, torch.bfloat16), (37, 2560, torch.bfloat16)])
def test_rmsnorm_cta_rows_body_holds_and_repeats(cuda, rows, D, dtype):
    """The cta_rows body (rows of 1025-8192 elements) against a float64
    evaluation at 2e-5 fp32 / 2e-2 bf16, the same bits on a second call;
    the counts by body show it ran.  Beside it, an 8200-element fp32 row
    (past 8 warps of 32 floats a lane) on the generic body."""
    g = torch.Generator(device=cuda).manual_seed(1)
    t = 2e-5 if dtype == torch.float32 else 2e-2
    for D_, body in ((D, "cta_rows"), (8200, "generic")):
        x, dy = (torch.randn(rows if D_ == D else 16, D_, generator=g,
                             device=cuda).to(dtype) for _ in range(2))
        s = torch.randn(D_, generator=g, device=cuda).to(dtype)
        assert rms.select_bwd_body(x, s, dy)[0] == body
        before = rmsnorm_bwd_cuda.launches_by_body[body]
        got = rmsnorm_bwd_cuda(x, s, dy)
        again = rmsnorm_bwd_cuda(x, s, dy)
        torch.cuda.synchronize()
        assert rmsnorm_bwd_cuda.launches_by_body[body] == before + 2
        for a, b, want in zip(got, again, _rmsnorm_f64_grads(x, s, dy)):
            assert a.dtype == dtype and torch.equal(a, b)
            err = (a.double() - want).abs()
            assert bool((err <= t * (1 + want.abs())).all())


def test_rmsnorm_function_routes_wide_rows_to_cta_rows(cuda):
    """RMSNormFunction (ops.rmsnorm with inputs that require grad) at
    mamba2-130m's gated norm width runs the cta_rows backward."""
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn(512, 1536, generator=g, device=cuda, requires_grad=True)
    s = torch.randn(1536, generator=g, device=cuda, requires_grad=True)
    before = dict(rmsnorm_bwd_cuda.launches_by_body)
    ops.rmsnorm(x, s).square().sum().backward()
    torch.cuda.synchronize()
    after = rmsnorm_bwd_cuda.launches_by_body
    assert {b: after[b] - before[b] for b in before} == {
        "warp_rows": 0, "cta_rows": 1, "generic": 0}


FLASH_BWD_CASES = [
    (16, 256, 8, 4, 64, dict(causal=True)),         # the 100m preset
    (2, 100, 4, 1, 16, dict(causal=True)),          # smoke, ragged S
    (2, 128, 8, 4, 32, dict(causal=True)),
    (1, 300, 32, 32, 80, dict(causal=True)),        # stablelm-3b
    (1, 200, 4, 2, 64, dict(causal=True, window=50)),
    (1, 200, 4, 2, 64, dict(causal=True, chunk=48)),
    (2, 70, 4, 4, 80, dict(causal=False)),
    # GQA groups of 8 and S not a multiple of the 64-row tiles
    (2, 190, 16, 2, 64, dict(causal=True)),
    (1, 129, 8, 1, 16, dict(causal=True, chunk=40)),
    (1, 65, 16, 2, 80, dict(causal=True, window=33)),
    # the head dims above 80: h2o-danube-3-4b's 120 (padded to 128),
    # qwen2-7b's 128, stablelm-12b's 160, recurrentgemma-9b's 256 (MQA,
    # and a window of 2048 that bites at S 2200)
    (1, 150, 8, 2, 120, dict(causal=True)),
    (2, 190, 8, 2, 128, dict(causal=True, window=70)),
    (1, 130, 4, 4, 160, dict(causal=True, chunk=48)),
    (1, 100, 4, 4, 160, dict(causal=False)),
    (2, 200, 16, 1, 256, dict(causal=True)),
    (1, 2200, 4, 1, 256, dict(causal=True, window=2048)),
    # the pair kernels' GQA with a window and MQA with a chunk, ragged S
    (2, 190, 8, 2, 160, dict(causal=True, window=70)),
    (1, 129, 8, 1, 120, dict(causal=True, chunk=40)),
    (1, 200, 8, 2, 256, dict(causal=True, chunk=64)),
    # bf16 at dh 128 on the sm90 body: qwen2-vl-2b's group of 6, MHA, no
    # mask, a ragged S past two 128-key tiles
    (1, 300, 12, 2, 128, dict(causal=True)),
    (2, 257, 4, 4, 128, dict(causal=False)),
    # stablelm-3b's train step (bf16 on the sm90 body at dh 80)
    (4, 1024, 32, 32, 80, dict(causal=True)),
    # bf16 on the sm90 body's column halves: recurrentgemma-9b's MQA at dh
    # 256 with a window that bites at a ragged S (P in hi + lo),
    # stablelm-12b's GQA 32 : 8 at dh 160
    (1, 1100, 16, 1, 256, dict(causal=True, window=700)),
    (1, 300, 32, 8, 160, dict(causal=True)),
]


def _flash_bwd_inputs(cuda, B, S, H, K, dh, dtype):
    """q, k, v, do from one seed, and a function that gives q, k and v as
    tensors that require grad and one that reads their gradients.  bf16 q,
    k and v at the sm90 head dims are views of a fused projection one
    element wider than the heads (strides TMA cannot read), which the
    forward sends to its mma body, so that body's log-sum-exp feeds the
    backward here (the sm90 body's:
    ``test_flash_sm90_training_matches_plain``)."""
    g = torch.Generator(device=cuda).manual_seed(0)
    if dtype == torch.bfloat16 and dh in flash.SM90_HEAD_DIMS:
        def heads(t):
            return [x.unflatten(-1, (-1, dh)) for x in t[..., :-1].split(
                [H * dh, K * dh, K * dh], -1)]
        qkv = torch.randn(B, S, (H + 2 * K) * dh + 1, generator=g,
                          device=cuda).to(dtype)
        q, k, v = heads(qkv)
        base = qkv.clone().requires_grad_()
        leaves, grads = (lambda: heads(base)), (lambda: heads(base.grad))
    else:
        q = torch.randn(B, S, H, dh, generator=g, device=cuda).to(dtype)
        k, v = (torch.randn(B, S, K, dh, generator=g, device=cuda).to(dtype)
                for _ in range(2))
        ts = [a.clone().requires_grad_() for a in (q, k, v)]
        leaves, grads = (lambda: ts), (lambda: [a.grad for a in ts])
    do = torch.randn(B, S, H, dh, generator=g, device=cuda).to(dtype)
    return q, k, v, do, leaves, grads


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,H,K,dh,kw", FLASH_BWD_CASES)
def test_flash_bwd_kernel_matches_plain(cuda, dtype, B, S, H, K, dh, kw):
    """dq, dk, dv through FlashAttentionFunction against autograd of
    mha_ref in fp32 on the same inputs; the forward's log-sum-exp against
    the plain one; two backward calls give the same bits."""
    q, k, v, do, leaves, grads = _flash_bwd_inputs(cuda, B, S, H, K, dh,
                                                   dtype)
    t = 2e-5 if dtype == torch.float32 else 2e-2
    with torch.no_grad():
        out, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
    assert _within(lse, lse_ref(q, k, **kw), t)
    body = flash.select_bwd_body(q, k, v)
    assert body == ("mma_tf32x3" if dtype == torch.float32 else "sm90"
                    if dh in flash.SM90_BWD_HEAD_DIMS else "mma_bf16")
    before = flash_attention_bwd_cuda.launches_by_body[body]
    ops.flash_attention(*leaves(), **kw).backward(do)
    assert flash_attention_bwd_cuda.launches_by_body[body] == before + 1
    qf, kf, vf = (a.float().requires_grad_() for a in (q, k, v))
    mha_ref(qf, kf, vf, **kw).backward(do.float())
    for got, want in zip(grads(), (qf.grad, kf.grad, vf.grad)):
        assert got.dtype == dtype and _within(got, want, t)
    again = flash_attention_bwd_cuda(q, k, v, out, do, lse, **kw)
    first = flash_attention_bwd_cuda(q, k, v, out, do, lse, **kw)
    assert all(torch.equal(a, b) for a, b in zip(again, first))


@pytest.mark.parametrize("B,S,H,K,dh,kw,dtype", [
    *((*case, dtype) for dtype in DTYPES for case in (
        (2, 300, 8, 1, 256, dict(causal=True, window=100)),
        (1, 190, 8, 2, 128, dict(causal=True)),
        (1, 130, 4, 2, 120, dict(causal=False)))),
    # bf16 only: at dh 80 the fp32 body (mma_tf32x3's 4-warp kernels) has
    # no split
    (1, 1000, 28, 4, 80, dict(causal=True), torch.bfloat16)])
def test_flash_bwd_head_splits_agree(cuda, dtype, B, S, H, K, dh, kw):
    """The dK/dV launch with each KV head's query heads split over 1, 2
    and all of its group's CTAs (partial sums added in a fixed order by a
    third launch): each against autograd of ``mha_ref`` at the kernel
    tolerance, dq the same bits whatever the split, two calls the same
    bits.  At dh 80 only the sm90 body splits (bf16; a group of 7 takes
    1 and 7)."""
    q, k, v, do, _, _ = _flash_bwd_inputs(cuda, B, S, H, K, dh, dtype)
    with torch.no_grad():
        out, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
    qf, kf, vf = (a.float().requires_grad_() for a in (q, k, v))
    mha_ref(qf, kf, vf, **kw).backward(do.float())
    t = 2e-5 if dtype == torch.float32 else 2e-2
    runs = {}
    for split in sorted({s for s in (1, 2, H // K) if (H // K) % s == 0}):
        got = flash_attention_bwd_cuda(q, k, v, out, do, lse, head_split=split,
                                       **kw)
        again = flash_attention_bwd_cuda(q, k, v, out, do, lse,
                                         head_split=split, **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        for g, w in zip(got, (qf.grad, kf.grad, vf.grad)):
            assert _within(g, w, t)
        runs[split] = got
    assert all(torch.equal(r[0], runs[1][0]) for r in runs.values())


@pytest.mark.parametrize("B,S,H,K,dh,kw,split", [
    (2, 300, 8, 1, 256, dict(causal=True, window=100), 1),
    (2, 300, 8, 1, 256, dict(causal=True, window=100), 4),
    (2, 190, 8, 2, 160, dict(causal=True), 2),
    (1, 130, 4, 4, 160, dict(causal=False), 1),
    (1, 190, 8, 2, 128, dict(causal=True, chunk=48), 1),
    (1, 150, 8, 2, 120, dict(causal=True), 4)])
def test_flash_bwd_pair_body_matches_split_products(cuda, B, S, H, K, dh, kw,
                                                    split):
    """The fp32 pair kernels (above dh 80), at a head split, against the
    plain model of their products (``mha_grads_by_products`` with
    ``tf32x3``: every operand split into TF32 hi + lo, three products a
    step) and against autograd of ``mha_ref``, both within the fp32
    tolerance."""
    q, k, v, do, _, _ = _flash_bwd_inputs(cuda, B, S, H, K, dh, torch.float32)
    with torch.no_grad():
        out, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
    got = flash_attention_bwd_cuda(q, k, v, out, do, lse, head_split=split,
                                   **kw)
    model = mha_grads_by_products(q, k, v, do, **kw, matmul=tf32x3)
    qf, kf, vf = (a.clone().requires_grad_() for a in (q, k, v))
    mha_ref(qf, kf, vf, **kw).backward(do)
    for g, m, w in zip(got, model, (qf.grad, kf.grad, vf.grad)):
        assert _within(g, w, 2e-5) and _within(g, m, 2e-5)


@pytest.mark.parametrize("B,S,H,K,dh,kw", [
    (1, 300, 12, 2, 128, dict(causal=True)),        # qwen2-vl-2b's group
    (2, 200, 12, 4, 120, dict(causal=True, window=70)),
    (1, 257, 6, 1, 128, dict(causal=True, chunk=96)),
    (2, 190, 6, 2, 120, dict(causal=False)),
    (1, 300, 12, 2, 80, dict(causal=True, window=100)),
    # the column halves: MQA 16 : 1 at dh 256 (splits 1-16), GQA 4 at 160
    (1, 300, 16, 1, 256, dict(causal=True, window=100)),
    (2, 190, 8, 2, 160, dict(causal=True))])
def test_flash_bwd_sm90_head_splits_agree(cuda, B, S, H, K, dh, kw):
    """The sm90 body's dK/dV launch at every head split its group allows
    (any divisor: 3 and 6 too), on TMA-aligned bf16 inputs: each within
    2e-2 (1 + |x|) of autograd of ``mha_ref`` in fp32, dq the same bits at
    every split, two calls the same bits; the pair kernels forced beside
    it hold the same tolerance."""
    g = torch.Generator(device=cuda).manual_seed(8)
    q, k, v, do = (torch.randn(B, S, n, dh, generator=g,
                               device=cuda).bfloat16() for n in (H, K, K, H))
    with torch.no_grad():
        out, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
    qf, kf, vf = (a.float().requires_grad_() for a in (q, k, v))
    mha_ref(qf, kf, vf, **kw).backward(do.float())
    want = (qf.grad, kf.grad, vf.grad)
    before = flash_attention_bwd_cuda.launches_by_body["sm90"]
    splits = [d for d in range(1, H // K + 1) if (H // K) % d == 0]
    runs = {}
    for split in splits:
        got = flash_attention_bwd_cuda(q, k, v, out, do, lse, head_split=split,
                                       **kw)
        again = flash_attention_bwd_cuda(q, k, v, out, do, lse,
                                         head_split=split, **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        assert all(_within(a, w, 2e-2) for a, w in zip(got, want))
        runs[split] = got
    assert flash_attention_bwd_cuda.launches_by_body["sm90"] == \
        before + 2 * len(splits)
    assert all(torch.equal(r[0], runs[1][0]) for r in runs.values())
    pair = flash_attention_bwd_cuda(q, k, v, out, do, lse, body="mma_bf16",
                                    **kw)
    assert all(_within(a, w, 2e-2) for a, w in zip(pair, want))


def test_raw_wrappers_refuse_inputs_that_require_grad_on_card(cuda):
    x = torch.ones(4, 64, device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="no gradient of its own"):
        rmsnorm_cuda(x, torch.ones(64, device=cuda))
    with torch.no_grad():
        rmsnorm_cuda(x, torch.ones(64, device=cuda))


# qwen2-vl-2b's train step (batch 4 x 1024, 12 heads over 2, dh 128)
SM90_TRAIN_CASE = (4, 1024, 12, 2, 128, dict(causal=True))


@pytest.mark.parametrize("B,S,H,K,dh,kw", [*SM90_CASES, SM90_TRAIN_CASE])
def test_flash_sm90_lse_matches_plain(cuda, B, S, H, K, dh, kw):
    """The sm90 body's log-sum-exp against the plain one in fp32 from the
    same bf16 inputs, within 2e-5 (1 + |lse|) (+inf where a row sees no
    key); O bit for bit the same with and without it."""
    g = torch.Generator(device=cuda).manual_seed(6)
    q, k, v = (torch.randn(B, S, n, dh, generator=g, device=cuda).bfloat16()
               for n in (H, K, K))
    before = flash_attention_cuda.launches_by_body["sm90"]
    out, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
    plain = flash_attention_cuda(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches_by_body["sm90"] == before + 2
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32
    assert torch.equal(out, plain)
    assert _within(lse, lse_ref(q, k, **kw), 2e-5)


@pytest.mark.parametrize("B,S,H,K,dh,kw", [
    SM90_TRAIN_CASE,
    (2, 512, 32, 32, 80, dict(causal=True)),       # stablelm-3b's heads
    (1, 300, 16, 16, 80, dict(causal=False)),      # hubert-xlarge's
    (1, 300, 28, 4, 128, dict(causal=True, chunk=96)),
    (2, 512, 16, 1, 256, dict(causal=True, window=2048)),
    (1, 1000, 16, 1, 256, dict(causal=True, window=300)),
    (1, 200, 16, 1, 256, dict(causal=False)),
    (1, 1024, 32, 8, 160, dict(causal=True)),      # stablelm-12b's heads
    (1, 300, 8, 2, 160, dict(causal=True, window=100)),
    (1, 300, 8, 2, 160, dict(causal=True, chunk=96)),
    (2, 200, 4, 4, 160, dict(causal=False)),
])
def test_flash_sm90_training_matches_plain(cuda, B, S, H, K, dh, kw):
    """bf16 training at dh 80, 128, 160 and 256 on TMA-aligned inputs: the
    sm90 forward (its log-sum-exp) and the sm90 backward (column halves at
    160 and 256) through ``ops.flash_attention``; dq, dk, dv against
    autograd of mha_ref in fp32 on the same bf16 inputs, within 2e-2
    (1 + |x|)."""
    g = torch.Generator(device=cuda).manual_seed(7)
    q, k, v, do = (torch.randn(B, S, n, dh, generator=g,
                               device=cuda).bfloat16() for n in (H, K, K, H))
    assert flash.select_body(q, k, v) == "sm90"
    body = "sm90" if dh in flash.SM90_BWD_HEAD_DIMS else "mma_bf16"
    assert flash.select_bwd_body(q, k, v) == body
    fwd = flash_attention_cuda.launches_by_body["sm90"]
    bwd = flash_attention_bwd_cuda.launches_by_body[body]
    leaves = [a.clone().requires_grad_() for a in (q, k, v)]
    ops.flash_attention(*leaves, **kw).backward(do)
    assert flash_attention_cuda.launches_by_body["sm90"] == fwd + 1
    assert flash_attention_bwd_cuda.launches_by_body[body] == bwd + 1
    qf, kf, vf = (a.float().requires_grad_() for a in (q, k, v))
    mha_ref(qf, kf, vf, **kw).backward(do.float())
    for got, want in zip(leaves, (qf, kf, vf)):
        assert got.grad.dtype == torch.bfloat16
        assert _within(got.grad, want.grad, 2e-2)


SSD_BWD_CASES = [
    (8, 1024, 24, 64, 1, 128, 128),   # mamba2-130m's train step
    (2, 1000, 24, 64, 1, 128, 128),   # a ragged last chunk
    (2, 200, 4, 16, 2, 16, 64),       # grouped B/C, ragged
    (8, 1024, 12, 128, 1, 128, 128),  # its head dim 128: two slabs of P
    (2, 1000, 12, 128, 1, 128, 256),  # and its chunk of 256: a tile of 128
    (2, 300, 4, 72, 1, 128, 128),     # a ragged second slab (8 columns)
    (1, 300, 4, 120, 2, 64, 64),
]
# where the fma body's block fits too (at P 128 with N 128 only up to a
# tile of 64)
SSD_BWD_FMA_CASES = SSD_BWD_CASES[:3] + [
    (2, 1000, 12, 128, 1, 128, 64),   # head dim 128, chunk 64
    (2, 1000, 24, 64, 1, 128, 256),   # chunk 256 at head dim 64
    (2, 300, 4, 72, 1, 128, 128),
    (1, 300, 4, 120, 2, 64, 64),
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,H,P,G,N,chunk", SSD_BWD_CASES)
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_bwd_kernel_matches_plain(cuda, dtype, B, S, H, P, G, N, chunk,
                                      with_state):
    """dx, ddt, dA, dB, dC, dD through ``SSDFunction`` (``ops.ssd_scan`` with
    inputs that require grad) against ``ssd_chunked_bwd`` on the same inputs,
    at the SSD tolerances (2e-3 fp32, 5e-2 bf16), with and without a
    gradient of the final state; two backward calls give the same bits."""
    x, dt, A, Bm, Cm, D = _ssd_inputs(cuda, B, S, H, P, G, N, dtype)
    g = torch.Generator(device=cuda).manual_seed(5)
    dy = torch.randn(B, S, H, P, generator=g, device=cuda).to(dtype)
    ds = (torch.randn(B, H, P, N, generator=g, device=cuda) if with_state
          else None)
    leaves = [t.clone().requires_grad_() for t in (x, dt, A, Bm, Cm, D)]
    body = ssd.select_bwd_body(x, dt, A, Bm, Cm, D, dy, chunk, ds)
    assert body == "mma"
    before = (ssd_cuda.launches, ssd_bwd_cuda.launches_by_body[body])
    y, state = ops.ssd_scan(*leaves, chunk=chunk)
    loss = (y.float() * dy.float()).sum()
    if ds is not None:
        loss = loss + (state * ds).sum()
    loss.backward()
    torch.cuda.synchronize()
    assert (ssd_cuda.launches, ssd_bwd_cuda.launches_by_body[body]) == (
        before[0] + 1, before[1] + 1)
    want = ssd_chunked_bwd(x, dt, A, Bm, Cm, D, dy, ds, chunk=chunk)
    t = 2e-3 if dtype == torch.float32 else 5e-2
    for leaf, w in zip(leaves, want):
        assert leaf.grad.dtype == leaf.dtype and _within(leaf.grad, w, t)
    first = ssd_bwd_cuda(x, dt, A, Bm, Cm, D, dy, ds, chunk=chunk)
    again = ssd_bwd_cuda(x, dt, A, Bm, Cm, D, dy, ds, chunk=chunk)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,H,P,G,N,chunk", SSD_BWD_FMA_CASES)
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_bwd_mma_body_matches_fma_body(cuda, dtype, B, S, H, P, G, N,
                                           chunk, with_state):
    """The mma body (3xTF32 tensor cores) and the fma body forced on the
    same inputs, each against ``ssd_chunked_bwd`` at the SSD tolerances and
    the two against each other at the same tolerances; each gives the same
    bits on a second call."""
    args = _ssd_inputs(cuda, B, S, H, P, G, N, dtype)
    g = torch.Generator(device=cuda).manual_seed(6)
    dy = torch.randn(B, S, H, P, generator=g, device=cuda).to(dtype)
    ds = (torch.randn(B, H, P, N, generator=g, device=cuda) if with_state
          else None)
    before = dict(ssd_bwd_cuda.launches_by_body)
    mma = ssd_bwd_cuda(*args, dy, ds, chunk=chunk, body="mma")
    mma2 = ssd_bwd_cuda(*args, dy, ds, chunk=chunk)
    fma = ssd_bwd_cuda(*args, dy, ds, chunk=chunk, body="fma")
    fma2 = ssd_bwd_cuda(*args, dy, ds, chunk=chunk, body="fma")
    torch.cuda.synchronize()
    assert {b: ssd_bwd_cuda.launches_by_body[b] - before[b]
            for b in before} == {"mma": 2, "fma": 2}
    want = ssd_chunked_bwd(*args, dy, ds, chunk=chunk)
    t = 2e-3 if dtype == torch.float32 else 5e-2
    for a, a2, f, f2, w in zip(mma, mma2, fma, fma2, want):
        assert torch.equal(a, a2) and torch.equal(f, f2)
        assert _within(a, w, t) and _within(f, w, t) and _within(a, f, t)


RGLRU_BWD_CASES = [(4, 512, 4096), (2, 37, 200), (3, 1000, 130),
                   (2, 64, 33), (1, 1100, 4096)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,W", RGLRU_BWD_CASES)
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_bwd_kernel_matches_plain(cuda, dtype, B, S, W, with_h0):
    """d log_a, d gx and dh0 through ``RGLRUFunction`` (``ops.rglru_scan``
    with inputs that require grad) against ``rglru_bwd`` on the same inputs,
    with gradients of y and h_last, at 1e-4 fp32 / 2e-2 bf16, on the body
    ``select_bwd_body`` picks (segmented from 64 steps: one 512-step window,
    or three at S 1100); two backward calls give the same bits.  (4, 512,
    4096) is recurrentgemma-9b's."""
    g = torch.Generator(device=cuda).manual_seed(0)
    la = -torch.nn.functional.softplus(
        torch.randn(B, S, W, generator=g, device=cuda)).to(dtype)
    gx, dy = (torch.randn(B, S, W, generator=g, device=cuda).to(dtype)
              for _ in range(2))
    h0 = torch.randn(B, W, generator=g, device=cuda) if with_h0 else None
    dh = torch.randn(B, W, generator=g, device=cuda)
    leaves = [la.clone().requires_grad_(), gx.clone().requires_grad_()]
    if with_h0:
        leaves.append(h0.clone().requires_grad_())
    body = lru.select_bwd_body(la, gx, h0)
    assert body == ("segmented" if S >= 64 else "serial")
    before = rglru_bwd_cuda.launches_by_body[body]
    y, h_last = ops.rglru_scan(*leaves[:2], leaves[2] if with_h0 else None)
    ((y.float() * dy.float()).sum() + (h_last * dh).sum()).backward()
    torch.cuda.synchronize()
    assert rglru_bwd_cuda.launches_by_body[body] == before + 1
    want = rglru_bwd(la, gx, dy, h0, dh)
    t = 1e-4 if dtype == torch.float32 else 2e-2
    for leaf, w in zip(leaves, want):
        assert leaf.grad.dtype == leaf.dtype and _within(leaf.grad, w, t)
    first = rglru_bwd_cuda(la, gx, dy, h0, dh)
    again = rglru_bwd_cuda(la, gx, dy, h0, dh)
    assert all(a is None and b is None or torch.equal(a, b)
               for a, b in zip(first, again))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,W", [(4, 512, 4096), (3, 1000, 130)])
def test_rglru_bwd_segmented_body_matches_serial(cuda, dtype, B, S, W):
    """The segmented body and the serial body forced on the same inputs
    (h0 and a gradient of h_last), each against ``rglru_bwd`` at the scan's
    tolerance and each giving the same bits on a second call."""
    g = torch.Generator(device=cuda).manual_seed(1)
    la = -torch.nn.functional.softplus(
        torch.randn(B, S, W, generator=g, device=cuda)).to(dtype)
    gx, dy = (torch.randn(B, S, W, generator=g, device=cuda).to(dtype)
              for _ in range(2))
    h0, dh = (torch.randn(B, W, generator=g, device=cuda) for _ in range(2))
    before = dict(rglru_bwd_cuda.launches_by_body)
    seg = [rglru_bwd_cuda(la, gx, dy, h0, dh) for _ in range(2)]
    ser = [rglru_bwd_cuda(la, gx, dy, h0, dh, body="serial")
           for _ in range(2)]
    torch.cuda.synchronize()
    assert {b: rglru_bwd_cuda.launches_by_body[b] - before[b]
            for b in before} == {"segmented": 2, "serial": 2}
    want = rglru_bwd(la, gx, dy, h0, dh)
    t = 1e-4 if dtype == torch.float32 else 2e-2
    for runs in (seg, ser):
        for a, a2, w in zip(*runs, want):
            assert torch.equal(a, a2) and _within(a, w, t)


def test_scan_raw_wrappers_still_refuse_inputs_that_require_grad(cuda):
    """Grad mode on, an input that requires grad: the raw wrappers raise
    and name the Function that ``kernels.ops`` takes; under no_grad they
    run."""
    args = _ssd_inputs(cuda, 1, 32, 2, 16, 1, 16, torch.float32)
    x = args[0].clone().requires_grad_()
    with pytest.raises(RuntimeError, match="SSDFunction"):
        ssd_cuda(x, *args[1:], chunk=16)
    la = torch.zeros(1, 8, 16, device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="RGLRUFunction"):
        rglru_cuda(la, la)
    with torch.no_grad():
        ssd_cuda(x, *args[1:], chunk=16)
        rglru_cuda(la, la)


def _lm(layers, **kw):
    sys.path.insert(0, str(ROOT / "examples"))
    try:
        from train_lm_torch import preset_config
    finally:
        sys.path.pop(0)
    return preset_config(kw.pop("preset", "small"), num_layers=layers, **kw)


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, list):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def test_train_step_on_card_matches_cpu(cuda):
    """One train step of the small preset at 2 layers, fp32, on the card
    (CUDA forward and backward kernels) against the same step on the CPU
    (plain versions, autograd): loss and every gradient leaf within 2e-4
    of the largest value (the JAX suite's decode-vs-forward bound); AdamW
    on the card given the CPU's gradients lands on the CPU's parameters
    within 1e-6.  The card's own updated parameters may differ by up to
    2 lr where a gradient is near AdamW's eps (g / (|g| + eps) turns tiny
    differences into whole steps), which bounds them."""
    cfg = _lm(2)
    tc = TrainConfig(dtype=torch.float32)
    params = init_params(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    rng = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (4, 65), generator=rng,
                         dtype=torch.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    lr = torch.tensor(1e-3)
    out = {}
    for dev in ("cpu", cuda):
        p = _to(params, dev)
        b = {k: v.to(dev) for k, v in batch.items()}
        total, _, grads = make_loss_and_grad(cfg, tc)(p, b)
        new_p, _, m = make_train_step(cfg, tc)(p, init_opt_state(p), b, lr)
        out[str(dev)] = (total.cpu(), [g.cpu() for g in _leaves(grads)],
                         [t.cpu() for t in _leaves(new_p)], grads)
    cpu, card = out["cpu"], out[str(cuda)]
    assert abs(float(card[0]) - float(cpu[0])) <= 2e-4 * abs(float(cpu[0]))
    for got, want in zip(card[1], cpu[1]):
        assert float((got - want).abs().max()) <= 2e-4 * float(
            want.abs().max())
    for got, want in zip(card[2], cpu[2]):
        assert float((got - want).abs().max()) <= 2 * float(lr)
    p_card = _to(params, cuda)
    on_cpu_grads, _, _ = adamw_update(_to(cpu[3], cuda),
                                      init_opt_state(p_card), p_card, lr)
    for got, want in zip(_leaves(on_cpu_grads), cpu[2]):
        assert float((got.cpu() - want).abs().max()) <= 1e-6 * float(
            want.abs().max())


def test_train_step_launches_each_kernel_both_ways(cuda):
    """One step of the small preset at 2 layers with no remat: 2L + 1 = 5
    RMSNorm and L = 2 flash launches forward, the same backward."""
    cfg = _lm(2)
    params = init_params(cfg, device=cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 33), device=cuda)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    for module in (rms, flash):
        module.reset_counts()
    make_train_step(cfg, TrainConfig(dtype=torch.float32,
                                     remat_policy="none"))(
        params, init_opt_state(params), batch, torch.tensor(1e-3))
    torch.cuda.synchronize()
    assert (rmsnorm_cuda.launches, rmsnorm_bwd_cuda.launches) == (5, 5)
    assert (flash_attention_cuda.launches,
            flash_attention_bwd_cuda.launches) == (2, 2)
    assert flash_attention_cuda.launches_by_body["mma_tf32x3"] == 2
    assert rmsnorm_bwd_cuda.launches_by_body["warp_rows"] == 5
    assert flash_attention_bwd_cuda.launches_by_body["mma_tf32x3"] == 2


@pytest.mark.parametrize("arch,launches", [
    ("mamba2-130m", {"ssd": 2, "rmsnorm": 5}),
    ("recurrentgemma-9b", {"rglru": 4, "rmsnorm": 11, "flash": 1})])
def test_family_train_step_on_card_matches_cpu(cuda, arch, launches):
    """One fp32 train step of the SSD and RG-LRU families' smoke configs on
    the card against the CPU: loss and every gradient leaf within 2e-4 of
    the leaf's largest value; each kernel launched as many times backward
    as forward (mamba2: 2 SSD layers, 2L + 1 RMSNorms; recurrentgemma: 4
    RG-LRU layers and one local-attention layer, 2L + 1 RMSNorms), with no
    remat (under a policy the backward reruns the forward's kernels)."""
    cfg = get_smoke_config(arch)
    tc = TrainConfig(dtype=torch.float32, remat_policy="none")
    params = init_params(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 65),
                         generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for module in (rms, flash, lru, ssd):
        module.reset_counts()
    for dev in ("cpu", cuda):
        total, _, grads = make_loss_and_grad(cfg, tc)(
            _to(params, dev), {k: v.to(dev) for k, v in batch.items()})
        out[str(dev)] = (total.cpu(), [g.cpu() for g in _leaves(grads)])
    torch.cuda.synchronize()
    counts = {"ssd": (ssd_cuda.launches, ssd_bwd_cuda.launches),
              "rglru": (rglru_cuda.launches, rglru_bwd_cuda.launches),
              "rmsnorm": (rmsnorm_cuda.launches, rmsnorm_bwd_cuda.launches),
              "flash": (flash_attention_cuda.launches,
                        flash_attention_bwd_cuda.launches)}
    assert counts == {k: (launches.get(k, 0),) * 2 for k in counts}
    cpu, card = out["cpu"], out[str(cuda)]
    assert abs(float(card[0]) - float(cpu[0])) <= 2e-4 * abs(float(cpu[0]))
    for got, want in zip(card[1], cpu[1]):
        assert float((got - want).abs().max()) <= 2e-4 * float(
            want.abs().max())


def test_moonshot_moe_layer_on_card_matches_cpu(cuda):
    """One moonshot-v1-16b-a3b layer at full width (rmsnorm, attention at
    head dim 128, then the MoE: 64 experts, top-6, capacity factor 1.25,
    the shared expert), fp32, B 2 x S 256, on the card against the CPU: the
    output within 2e-5 of (1 + its largest value), the aux loss within
    2e-5, and no token routed to other experts on the card.  Over 512
    tokens of 64 experts the smallest top-6 margin is near 1e-6, below the
    CPU tests' 1e-4, so the routes themselves are held, and the margin is
    named in any failure."""
    cfg = dataclasses.replace(get_config("moonshot-v1-16b-a3b"),
                              num_layers=1)
    gen = torch.Generator().manual_seed(0)
    init = dict(device="cpu", dtype=torch.float32, generator=gen)
    p = {"norm1": torch.ones(cfg.d_model), "mixer": init_attn(cfg, **init),
         "norm2": torch.ones(cfg.d_model), "moe": init_moe(cfg, **init)}
    x = torch.randn(2, 256, cfg.d_model, generator=gen)
    pos = torch.arange(256).expand(2, 256)
    for module in (rms, flash):
        module.reset_counts()
    out, routes = {}, {}
    for dev in ("cpu", cuda):
        cos, sin = rope_cos_sin(pos.to(dev), cfg.resolved_head_dim,
                                cfg.rope_theta)
        ctx = {"cfg": cfg, "cos": cos, "sin": sin, "t": 0}
        with torch.inference_mode(), record_routes() as routes[str(dev)]:
            y, aux = apply_block("attn", _to(p, dev), x.to(dev), ctx)
        out[str(dev)] = (y.cpu(), float(aux))
    assert rmsnorm_cuda.launches == 2 and flash_attention_cuda.launches == 1
    (y_cpu, aux_cpu), (y_card, aux_card) = out["cpu"], out[str(cuda)]
    (probs, sel_cpu), = routes["cpu"]
    (_, sel_card), = routes[str(cuda)]
    why = (f"top-6 margin {topk_margin(probs, 6)}, routes that differ "
           f"{routes_differ(sel_cpu, sel_card)}")
    assert routes_differ(sel_cpu, sel_card) == 0, why
    err = float((y_card - y_cpu).abs().max())
    assert err <= 2e-5 * (1 + float(y_cpu.abs().max())), (err, why)
    assert abs(aux_card - aux_cpu) <= 2e-5, (aux_card, aux_cpu, why)


@pytest.mark.parametrize("policy", ["full", "dots", "dots_no_batch"])
def test_remat_on_card_gives_the_none_gradients(cuda, policy):
    """One bf16 step of qwen2-vl-2b at full width cut to 2 layers (sm90
    flash at dh 128 both ways, rmsnorm rows of 1536), batch 2 x 256, under
    each remat policy against the same step under ``none``: the same loss
    and gradient bits (every kernel on the path is deterministic, and the
    backward's graph is the forward's), and the launches: the backward
    reruns each layer's forward through the kernels' autograd Functions,
    so flash forwards 2L and RMSNorm forwards 4L + 1, the backwards L and
    2L + 1 as under ``none``."""
    cfg = dataclasses.replace(get_config("qwen2-vl-2b"), num_layers=2)
    L, dh = cfg.num_layers, cfg.resolved_head_dim
    params = init_params(cfg, device=cuda,
                         generator=torch.Generator(cuda).manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 257), device=cuda,
                         generator=torch.Generator(cuda).manual_seed(1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    out = {}
    for p in ("none", policy):
        for module in (rms, flash):
            module.reset_counts()
        total, _, grads = make_loss_and_grad(cfg, TrainConfig(
            remat_policy=p))(params, batch)
        torch.cuda.synchronize()
        out[p] = (total, _leaves(grads), (
            rmsnorm_cuda.launches, rmsnorm_bwd_cuda.launches,
            flash_attention_cuda.launches, flash_attention_bwd_cuda.launches,
            dict(flash_attention_cuda.launches_by_head_dim["sm90"]),
            flash_attention_bwd_cuda.launches_by_body["sm90"]))
    assert out["none"][2] == (2 * L + 1, 2 * L + 1, L, L, {dh: L}, L)
    assert out[policy][2] == (4 * L + 1, 2 * L + 1, 2 * L, L, {dh: 2 * L},
                              L)
    assert torch.equal(out[policy][0], out["none"][0])
    for g, g0 in zip(out[policy][1], out["none"][1]):
        assert torch.equal(g, g0)


def test_train_example_runs_on_card(cuda, monkeypatch, capsys, tmp_path):
    monkeypatch.setattr(sys, "argv", [
        "train_lm_torch.py", "--preset", "small", "--steps", "20",
        "--ckpt-every", "10", "--workdir", str(tmp_path)])
    runpy.run_path(str(ROOT / "examples" / "train_lm_torch.py"),
                   run_name="__main__")
    assert "final metrics:" in capsys.readouterr().out


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)
