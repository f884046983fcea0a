"""The port's kernel modules against the JAX package.

The plain PyTorch versions (``rmsnorm_ref``, ``mha_ref``,
``attention_mask``) against the JAX Pallas kernels run in interpret mode and
against the JAX references, on the same numpy inputs; the gradients of
``rmsnorm_ref`` and ``mha_ref`` (autograd) and the plain backwards of the
scans (``ssd_chunked_bwd``, ``rglru_bwd``) against ``jax.grad`` of the JAX
references, which the backward kernels are held to on the card through
them.  Tolerances are the
JAX suite's own (``tests/test_kernels.py``): fp32 2e-5, bf16 2e-2, RG-LRU
scan 1e-4, SSD scan 2e-3 fp32 / 5e-2 bf16 (its final state and decode step
1e-4).  The CUDA kernels against their plain versions are in
``test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro.kernels.flash_attention.kernel import flash_attention_pallas
from repro.kernels.flash_attention.ref import attention_mask as jax_mask
from repro.kernels.flash_attention.ref import mha_ref as jax_mha_ref
from repro.kernels.rglru.kernel import rglru_pallas
from repro.kernels.rglru.ref import rglru_assoc as jax_rglru_assoc
from repro.kernels.rglru.ref import rglru_gates as jax_rglru_gates
from repro.kernels.rglru.ref import rglru_sequential as jax_rglru_sequential
from repro.kernels.rmsnorm.kernel import rmsnorm_pallas
from repro.kernels.rmsnorm.ref import rmsnorm_ref as jax_rmsnorm_ref
from repro.kernels.ssd.kernel import ssd_pallas
from repro.kernels.ssd.ref import ssd_chunked as jax_ssd_chunked
from repro.kernels.ssd.ref import ssd_decode_step as jax_ssd_decode_step
from repro.kernels.ssd.ref import ssd_sequential as jax_ssd_sequential
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention.kernel import (SM90_BWD_SPLIT_GROUP,
                                                       flash_attention_cuda)
from repro_torch.kernels.flash_attention.ref import (attention_mask,
                                                     bf16_hilo, bf16_operands,
                                                     mha_fwd_by_products,
                                                     mha_grads_by_products,
                                                     mha_ref, split_product,
                                                     split_tf32, tf32x3,
                                                     tf32x3_trunc)
from repro_torch.kernels.rglru.kernel import rglru_cuda
from repro_torch.kernels.rglru.ref import (rglru_assoc, rglru_bwd,
                                           rglru_bwd_segmented, rglru_gates,
                                           rglru_sequential)
from repro_torch.kernels.rmsnorm.kernel import (bwd_grid, cta_grid,
                                                cta_shape, rmsnorm_cuda)
from repro_torch.kernels.rmsnorm.ref import (rmsnorm_dscale_ordered,
                                             rmsnorm_ref)
from repro_torch.kernels.ssd.kernel import BWD_SLAB_P, ssd_cuda
from repro_torch.kernels.ssd.ref import (_tree, split_bf16, split_einsum,
                                         ssd_chunk_scan,
                                         ssd_chunk_state, ssd_chunked,
                                         ssd_chunked_bwd, ssd_decode_step,
                                         ssd_sequential, ssd_state_passing,
                                         ssd_sum_ordered, ssd_sum_slabs,
                                         truncate_tf32)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=2e-5, atol=2e-5)


def both(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    jd, td = DTYPES[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


def f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


# ---------------------------------------------------------------------------
# rmsnorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(8, 128), (2, 17, 256), (3, 100, 512)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_residual", [False, True])
def test_rmsnorm_ref_matches_jax(shape, dtype, with_residual):
    rng = np.random.default_rng(0)
    xj, xt = both(rng.standard_normal(shape, np.float32), dtype)
    sj, st = both(rng.standard_normal(shape[-1:], np.float32), "float32")
    rj = rt = None
    if with_residual:
        rj, rt = both(rng.standard_normal(shape, np.float32), dtype)
    got = rmsnorm_ref(xt, st, residual=rt)
    assert got.dtype == xt.dtype and got.shape == xt.shape
    assert_allclose(f32(got), f32(rmsnorm_pallas(xj, sj, residual=rj,
                                                 interpret=True)), **tol(dtype))
    assert_allclose(f32(got), f32(jax_rmsnorm_ref(xj, sj, residual=rj)),
                    **tol(dtype))
    assert torch.equal(ops.rmsnorm(xt, st, residual=rt), got)


@pytest.mark.parametrize("shape", [(8, 64), (2, 17, 256), (3, 100, 512)])
@pytest.mark.parametrize("with_residual", [False, True])
def test_rmsnorm_ref_gradient_matches_jax(shape, with_residual):
    """dx, dscale (and d_residual) of rmsnorm_ref against jax.grad of the
    JAX reference, fp32, at the train widths 64, 256 and 512."""
    rng = np.random.default_rng(4)
    x, dy, r = (rng.standard_normal(shape).astype(np.float32)
                for _ in range(3))
    s = rng.standard_normal(shape[-1:]).astype(np.float32)
    res = r if with_residual else None

    def loss_j(x, s, r):
        y = jax_rmsnorm_ref(x, s, residual=r if with_residual else None)
        return jnp.sum(y * dy)

    want = jax.grad(loss_j, argnums=(0, 1, 2))(x, s, r)
    xt, st, rt = (torch.from_numpy(a).requires_grad_() for a in (x, s, r))
    rmsnorm_ref(xt, st, residual=rt if res is not None else None).backward(
        torch.from_numpy(dy))
    got = (xt.grad, st.grad, rt.grad if with_residual else None)
    for g, w in zip(got, want):
        if g is not None:
            assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("sms", [132, 16])
def test_rmsnorm_bwd_dscale_order_matches_jax(sms):
    """dscale summed in the warp-a-row backward kernel's order (per-warp
    running sums over its rows, a pairwise tree over a CTA's warps, strided
    running sums over the CTAs, a pairwise tree over those) against
    jax.grad of the JAX reference at 2e-5, on the 100m step's (4096, 512)
    where |dscale| reaches about 190: a plain running sum over the 4096
    rows misses there, so the order is what holds the tolerance.  The grid
    is the one the wrapper takes on a card of ``sms`` SMs."""
    rng = np.random.default_rng(4)
    x, dy = (rng.standard_normal((4096, 512)).astype(np.float32)
             for _ in range(2))
    s = rng.standard_normal(512).astype(np.float32)
    want = np.asarray(jax.grad(
        lambda s: jnp.sum(jax_rmsnorm_ref(x, s) * dy))(s))
    assert np.abs(want).max() > 150
    rows_per_warp, ctas = bwd_grid(4096, sms)
    assert ctas * 4 * rows_per_warp >= 4096
    got = rmsnorm_dscale_ordered(torch.from_numpy(x), torch.from_numpy(dy),
                                 rows_per_warp=rows_per_warp)
    assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    xt, dyt = torch.from_numpy(x), torch.from_numpy(dy)
    terms = dyt * (xt * torch.rsqrt(xt.square().mean(-1, keepdim=True)
                                    + 1e-6))
    running = torch.zeros(512)
    for row in terms:
        running = running + row
    assert not np.all(np.abs(running.numpy() - want)
                      <= 2e-5 * (1 + np.abs(want)))


@pytest.mark.parametrize("rows,D", [(8192, 768), (8192, 512)])
def test_rmsnorm_bwd_dscale_order_holds_at_8192_rows(rows, D):
    """The warp-a-row kernel's dscale order (its sums in fp64) at the
    mamba2-130m train step's rows, against a float64 evaluation at 2e-5:
    the same order in fp32 missed there on the card."""
    rng = np.random.default_rng(5)
    x, dy = (rng.standard_normal((rows, D)).astype(np.float32)
             for _ in range(2))
    xd = x.astype(np.float64)
    want = (dy.astype(np.float64) * xd
            / np.sqrt(np.mean(xd * xd, -1, keepdims=True) + 1e-6)).sum(0)
    rows_per_warp, _ = bwd_grid(rows, 132)
    got = rmsnorm_dscale_ordered(torch.from_numpy(x), torch.from_numpy(dy),
                                 rows_per_warp=rows_per_warp)
    assert got.dtype == torch.float32
    assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("sms", [132, 16])
def test_rmsnorm_cta_rows_dscale_order_matches_jax(sms):
    """dscale summed in the cta_rows body's order (each CTA's thread a
    running fp64 sum of its columns over the CTA's rows, then the partial
    rows' strided sums and pairwise tree) against jax.grad of the JAX
    reference at 2e-5, at recurrentgemma-9b's step (2048, 4096), where a
    plain running sum over the rows misses.  The grid is the wrapper's on
    a card of ``sms`` SMs."""
    rng = np.random.default_rng(6)
    x, dy = (rng.standard_normal((2048, 4096)).astype(np.float32)
             for _ in range(2))
    s = rng.standard_normal(4096).astype(np.float32)
    want = np.asarray(jax.grad(
        lambda s: jnp.sum(jax_rmsnorm_ref(x, s) * dy))(s))
    warps = cta_shape(4096, torch.float32)[0]
    per_cta, ctas = cta_grid(2048, sms, warps)
    assert ctas * per_cta >= 2048
    got = rmsnorm_dscale_ordered(torch.from_numpy(x), torch.from_numpy(dy),
                                 rows_per_warp=per_cta, warps_per_cta=1)
    assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    xt, dyt = torch.from_numpy(x), torch.from_numpy(dy)
    terms = dyt * (xt * torch.rsqrt(xt.square().mean(-1, keepdim=True)
                                    + 1e-6))
    running = torch.zeros(4096)
    for row in terms:
        running = running + row
    assert not np.all(np.abs(running.numpy() - want)
                      <= 2e-5 * (1 + np.abs(want)))


@pytest.mark.parametrize("sms", [132, 16])
def test_rmsnorm_cta_rows_dscale_order_holds_at_8192_rows(sms):
    """The cta_rows body's dscale order at mamba2-130m's gated norm (8192,
    1536), against a float64 evaluation at 2e-5.  (jax.grad of the JAX
    reference cannot be the reference there: its own fp32 dscale strays
    from the float64 value by 1.07x that tolerance at these inputs.)"""
    rng = np.random.default_rng(6)
    x, dy = (rng.standard_normal((8192, 1536)).astype(np.float32)
             for _ in range(2))
    xd = x.astype(np.float64)
    want = (dy.astype(np.float64) * xd
            / np.sqrt(np.mean(xd * xd, -1, keepdims=True) + 1e-6)).sum(0)
    per_cta, _ = cta_grid(8192, sms, cta_shape(1536, torch.float32)[0])
    got = rmsnorm_dscale_ordered(torch.from_numpy(x), torch.from_numpy(dy),
                                 rows_per_warp=per_cta, warps_per_cta=1)
    assert got.dtype == torch.float32
    assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

ATTN_CASES = [
    (1, 128, 4, 4, 64, dict(causal=True)),          # MHA, dh 64
    (1, 256, 4, 1, 128, dict(causal=True)),         # MQA, dh 128
    (2, 256, 4, 2, 128, dict(causal=True, window=100)),
    (1, 256, 4, 2, 64, dict(causal=True, chunk=128)),
    (1, 128, 2, 2, 128, dict(causal=False)),
    (1, 256, 2, 1, 256, dict(causal=True, window=16)),   # recurrentgemma
]


@pytest.mark.parametrize("B,S,H,K,dh,kw", ATTN_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mha_ref_matches_jax_flash_kernel(B, S, H, K, dh, kw, dtype):
    rng = np.random.default_rng(1)
    qj, qt = both(rng.standard_normal((B, S, H, dh), np.float32), dtype)
    kj, kt = both(rng.standard_normal((B, S, K, dh), np.float32), dtype)
    vj, vt = both(rng.standard_normal((B, S, K, dh), np.float32), dtype)
    got = mha_ref(qt, kt, vt, **kw)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    want = flash_attention_pallas(qj, kj, vj, interpret=True, **kw)
    assert_allclose(f32(got), f32(want), **tol(dtype))
    assert torch.equal(ops.flash_attention(qt, kt, vt, **kw), got)


@pytest.mark.parametrize("B,S,H,K,dh,kw", [
    (2, 64, 8, 4, 64, dict(causal=True)),          # the 100m preset's heads
    (2, 37, 4, 1, 16, dict(causal=True)),          # smoke, ragged S
    (1, 48, 8, 4, 32, dict(causal=True, window=9)),
    (1, 50, 4, 2, 80, dict(causal=True, chunk=16)),
    (1, 40, 2, 2, 64, dict(causal=False)),
    (1, 45, 4, 2, 120, dict(causal=True)),             # h2o-danube-3-4b
    (1, 40, 4, 1, 128, dict(causal=True, chunk=16)),   # qwen2-7b's width
    (1, 37, 4, 2, 160, dict(causal=False)),            # stablelm-12b
    (1, 50, 4, 1, 256, dict(causal=True)),             # recurrentgemma-9b
    (1, 70, 4, 1, 256, dict(causal=True, window=24)),  # MQA, a window
])
def test_mha_ref_gradient_matches_jax(B, S, H, K, dh, kw):
    """dq, dk, dv of mha_ref against jax.grad of the JAX reference, fp32,
    at the backward kernel's head dims (every one of the registry) and
    masks."""
    rng = np.random.default_rng(5)
    q, do = (rng.standard_normal((B, S, H, dh)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((B, S, K, dh)).astype(np.float32)
            for _ in range(2))
    want = jax.grad(lambda q, k, v: jnp.sum(jax_mha_ref(q, k, v, **kw) * do),
                    argnums=(0, 1, 2))(q, k, v)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    mha_ref(*leaves, **kw).backward(torch.from_numpy(do))
    for g, w in zip(leaves, want):
        assert_allclose(g.grad.numpy(), np.asarray(w), rtol=2e-5, atol=2e-5)


def test_split_tf32_rounds_as_cvt_rna():
    """10 explicit mantissa bits, to nearest, ties away from zero."""
    one = 1.0 + 2.0 ** -10                 # the TF32 step above 1
    v = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -12,
                      -(1.0 + 2.0 ** -11), 1.0 + 3 * 2.0 ** -11, 3.0e-3])
    got = split_tf32(v)
    assert got[:4].tolist() == [1.0, one, 1.0, -one]
    assert got[4].item() == 1.0 + 2 * 2.0 ** -10
    assert abs(got[5].item() - 3.0e-3) <= 3.0e-3 * 2.0 ** -11
    assert torch.equal(split_tf32(got), got)


@pytest.mark.parametrize("B,S,H,K,dh,kw", [
    (1, 256, 8, 4, 64, dict(causal=True)),         # the 100m step's heads
    (1, 50, 4, 2, 80, dict(causal=True, window=9)),
    (1, 50, 4, 2, 80, dict(causal=True, chunk=16)),
    (1, 200, 4, 2, 128, dict(causal=True)),        # 128 terms a product
    (1, 100, 4, 1, 256, dict(causal=True, window=40)),   # 256, MQA
    (1, 150, 8, 2, 120, dict(causal=True)),        # h2o-danube-3-4b, GQA 4
    (1, 130, 4, 4, 160, dict(causal=True, chunk=48)),    # stablelm-12b
])
def test_flash_bwd_split_products_hold_fp32_tolerance(B, S, H, K, dh, kw,
                                                       capsys):
    """The fp32 backward body's precision design, in plain torch: the five
    products (S, dP, dV = Pᵀ dO, dQ = dS K, dK = dSᵀ Q) with each operand
    split into TF32 hi + lo and the three-term product, against jax.grad
    of the JAX reference at 2e-5.  The bf16 hi + lo split (3 products at
    the bf16 rate) would have been taken at or under half of 2e-5 in every
    case; it is printed beside and is not (about 16 bits of mantissa), so
    the kernel takes 3xTF32."""
    rng = np.random.default_rng(5)
    q, do = (rng.standard_normal((B, S, H, dh)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((B, S, K, dh)).astype(np.float32)
            for _ in range(2))
    want = jax.grad(lambda q, k, v: jnp.sum(jax_mha_ref(q, k, v, **kw) * do),
                    argnums=(0, 1, 2))(q, k, v)
    args = [torch.from_numpy(a) for a in (q, k, v, do)]
    share = {}     # max |got - want| / (2e-5 (1 + |want|)) over dq, dk, dv
    for name, matmul in (
            ("tf32x3", tf32x3),
            ("bf16x3", lambda a, b: split_product(
                a, b, lambda t: t.bfloat16().float()))):
        got = mha_grads_by_products(*args, **kw, matmul=matmul)
        share[name] = max(float(np.max(
            np.abs(g.numpy() - np.asarray(w))
            / (2e-5 * (1 + np.abs(np.asarray(w)))))) for g, w in zip(got, want))
        if name == "tf32x3":
            for g, w in zip(got, want):
                assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5,
                                atol=2e-5)
    with capsys.disabled():
        print(f"\nflash backward split products at {(B, S, H, K, dh, kw)}, "
              f"share of the 2e-5 tolerance: {share}")
    assert share["tf32x3"] <= 0.5 < share["bf16x3"]


@pytest.mark.parametrize("B,S,H,K,dh,kw", [
    (1, 1024, 12, 2, 128, dict(causal=True)),          # qwen2-vl-2b's heads
    (1, 256, 32, 8, 120, dict(causal=True)),           # h2o-danube-3-4b's
    (1, 300, 12, 2, 128, dict(causal=True, window=100)),
    (1, 300, 16, 4, 120, dict(causal=True, chunk=96)),
    (1, 300, 16, 1, 120, dict(causal=True)),           # MQA: hi + lo
    (1, 1024, 32, 32, 80, dict(causal=True)),          # stablelm-3b's heads
    (1, 300, 16, 16, 80, dict(causal=False)),          # hubert-xlarge's
    (1, 300, 28, 4, 80, dict(causal=True, window=100)),  # GQA 7:1, a window
    # recurrentgemma-9b's heads: MQA 16 : 1 (P in hi + lo), a window that
    # bites; dh 256 at GQA 4; stablelm-12b's heads, GQA 32 : 8 at dh 160
    (1, 300, 16, 1, 256, dict(causal=True, window=100)),
    (1, 300, 8, 2, 256, dict(causal=True)),
    (1, 256, 32, 8, 160, dict(causal=True)),
])
def test_flash_bwd_sm90_bf16_products_hold_bf16_tolerance(B, S, H, K, dh,
                                                          kw, capsys):
    """The bf16 sm90 backward body's precision design, in plain torch: the
    five products with fp32 sums (q, k, v and dO bf16 already), P rounded
    to bf16 once for dV = Pᵀ dO (one wgmma chain, as SDPA's backward rounds
    it) and dS as bf16 hi + lo for dK and dQ (two chains), against jax.grad
    of the JAX reference in fp32 on the same bf16-valued inputs at 2e-2 (1
    + |x|), at dh 80, 120, 128, 160 and 256 (the body's products do not
    depend on the head dim but for their length; above dh 128 it cuts each
    sum into two column halves, which changes no sum's order: an element of
    dQ, dK or dV sums the same products in the same order as a whole-width
    body, and S and dP still run over the whole head dim).  Above
    ``SM90_BWD_SPLIT_GROUP`` query heads a KV head (MQA's 16 here) the body
    forms P as hi + lo too, and the model with it."""
    rng = np.random.default_rng(7)

    def bf16_valued(shape):
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        return x.bfloat16().float().numpy()

    q, do = bf16_valued((B, S, H, dh)), bf16_valued((B, S, H, dh))
    k, v = bf16_valued((B, S, K, dh)), bf16_valued((B, S, K, dh))
    want = jax.grad(lambda q, k, v: jnp.sum(jax_mha_ref(q, k, v, **kw) * do),
                    argnums=(0, 1, 2))(q, k, v)
    matmul = bf16_operands if H // K <= SM90_BWD_SPLIT_GROUP else bf16_hilo
    got = mha_grads_by_products(*(torch.from_numpy(a) for a in (q, k, v, do)),
                                **kw, matmul=matmul, ds_matmul=bf16_hilo)
    share = max(_share(g, w, 2e-2) for g, w in zip(got, want))
    with capsys.disabled():
        print(f"\nflash sm90 backward's bf16 products at {(B, S, H, K, dh, kw)}"
              f", share of the 2e-2 tolerance: {share:.3f}")
    for g, w in zip(got, want):
        assert_allclose(g.numpy(), np.asarray(w), rtol=2e-2, atol=2e-2)


def _share(got, want, t):
    """max |got - want| / (t (1 + |want|)): the share of the tolerance t."""
    got, want = f32(got).astype(np.float64), f32(want).astype(np.float64)
    return float(np.max(np.abs(got - want) / (t * (1 + np.abs(want)))))


@pytest.mark.parametrize("B,S,H,K,dh,kw", [
    (2, 256, 8, 4, 64, dict(causal=True)),         # the 100m step's heads
    (1, 100, 4, 1, 16, dict(causal=True)),         # smoke, ragged S
    (1, 130, 4, 2, 80, dict(causal=True, window=9)),
    (1, 130, 4, 2, 80, dict(causal=True, chunk=16)),
    (1, 70, 2, 2, 128, dict(causal=False)),
    (1, 128, 8, 2, 160, dict(causal=True)),             # stablelm-12b, GQA
    (1, 128, 4, 1, 256, dict(causal=True, window=40)),  # MQA, a window
    (1, 90, 4, 1, 256, dict(causal=True)),              # ragged S
])
def test_flash_fwd_split_products_hold_fp32_tolerance(B, S, H, K, dh, kw,
                                                       capsys):
    """The fp32 forward's mma_tf32x3 body in plain torch
    (``mha_fwd_by_products`` with ``tf32x3_trunc``: Q·Kᵀ and P·V each from
    TF32 hi + lo splits by truncation and three products, the softmax
    online over 32-key tiles in fp32, as the kernel runs dh <= 80 and
    160 / 256, where a pair of warps forms each tile's scores)
    against the JAX flash kernel in interpret mode and JAX's ``mha_ref`` at
    2e-5 (the Pallas kernel where its 64-row blocks divide S), and its
    log-sum-exp against a float64 evaluation; the same with operands cut
    once to TF32 (1xTF32, printed beside) misses."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((B, S, H, dh)).astype(np.float32)
    k, v = (rng.standard_normal((B, S, K, dh)).astype(np.float32)
            for _ in range(2))
    want = [f32(jax_mha_ref(q, k, v, **kw))]
    if S % 64 == 0:     # the Pallas kernel's blocks divide S
        want.append(f32(flash_attention_pallas(
            *map(jnp.asarray, (q, k, v)), interpret=True, block_q=64,
            block_k=64, **kw)))
    pos = torch.arange(S)
    logits = torch.einsum("bqkgd,bskd->bkgqs", torch.from_numpy(q).double()
                          .unflatten(2, (K, H // K)),
                          torch.from_numpy(k).double()) * dh ** -0.5
    want_lse = torch.logsumexp(logits.masked_fill(
        ~attention_mask(pos, pos, **kw), -torch.inf), -1).flatten(1, 2)
    args = [torch.from_numpy(a) for a in (q, k, v)]
    share = {}
    for name, matmul in (("tf32x3", tf32x3_trunc),
                         ("tf32", lambda a, b: split_tf32(a) @ split_tf32(b))):
        o, lse = mha_fwd_by_products(*args, **kw, matmul=matmul, block=32)
        share[name] = max([_share(o, w, 2e-5) for w in want]
                          + [_share(lse, want_lse, 2e-5)])
    with capsys.disabled():
        print(f"\nflash forward split products at {(B, S, H, K, dh, kw)}, "
              f"share of the 2e-5 tolerance: {share}")
    assert share["tf32x3"] <= 1.0 < share["tf32"]


@pytest.mark.parametrize("B,S,H,K,dh,kw", [
    (1, 128, 32, 8, 160, dict(causal=True)),        # stablelm-12b's GQA 32 : 8
    (1, 100, 8, 2, 160, dict(causal=True)),         # ragged S
    (1, 192, 4, 1, 160, dict(causal=True, window=40)),
    (1, 128, 8, 2, 160, dict(causal=True, chunk=48)),
    (2, 128, 4, 4, 160, dict(causal=False)),
])
def test_flash_sm90_fwd_bf16_products_hold_bf16_tolerance(B, S, H, K, dh, kw,
                                                          capsys):
    """The bf16 forward's sm90 body at dh 160 in plain torch
    (``mha_fwd_by_products`` with ``bf16_operands`` over 64-key tiles: Q·Kᵀ
    of bf16 operands summed in fp32, the softmax online over the tiles in
    fp32, P rounded to bf16 for P·V as the kernel packs it for its register
    operand) against the JAX flash kernel in interpret mode (where its
    64-row blocks divide S) and JAX's ``mha_ref`` on the same bf16 inputs
    at 2e-2 (1 + |o|), and its log-sum-exp against a float64 evaluation at
    2e-5 (1 + |lse|)."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, S, n, dh)).astype(
        np.float32)).bfloat16() for n in (H, K, K))
    jq, jk, jv = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                  for t in (q, k, v))
    want = [f32(jax_mha_ref(jq, jk, jv, **kw))]
    if S % 64 == 0:     # the Pallas kernel's blocks divide S
        want.append(f32(flash_attention_pallas(
            jq, jk, jv, interpret=True, block_q=64, block_k=64, **kw)))
    pos = torch.arange(S)
    logits = torch.einsum("bqkgd,bskd->bkgqs",
                          q.double().unflatten(2, (K, H // K)),
                          k.double()) * dh ** -0.5
    want_lse = torch.logsumexp(logits.masked_fill(
        ~attention_mask(pos, pos, **kw), -torch.inf), -1).flatten(1, 2)
    o, lse = mha_fwd_by_products(q, k, v, **kw, matmul=bf16_operands,
                                 block=64)
    share = dict(o=max(_share(o, w, 2e-2) for w in want),
                 lse=_share(lse, want_lse, 2e-5))
    with capsys.disabled():
        print(f"\nflash sm90 forward's bf16 products at {(B, S, H, K, dh, kw)}"
              f", shares of the tolerances: {share}")
    for w in want:
        assert_allclose(f32(o), w, rtol=2e-2, atol=2e-2)
    assert share["lse"] <= 1.0


@pytest.mark.parametrize("kw", [dict(causal=True), dict(causal=True, window=5),
                                dict(causal=True, chunk=4)])
def test_mha_ref_decode_positions_match_jax(kw):
    """Decode over a cache: explicit positions, unwritten slots at -1."""
    B, Sc, H, K, dh, t = 2, 12, 4, 2, 64, 8
    rng = np.random.default_rng(2)
    q = rng.standard_normal((B, 1, H, dh), np.float32)
    k = rng.standard_normal((B, Sc, K, dh), np.float32)
    v = rng.standard_normal((B, Sc, K, dh), np.float32)
    pos = np.where(np.arange(Sc) <= t, np.arange(Sc), -1).astype(np.int32)
    q_pos = np.full((B, 1), t, np.int32)
    k_pos = np.broadcast_to(pos, (B, Sc)).copy()
    want = jax_mha_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       q_positions=jnp.asarray(q_pos),
                       k_positions=jnp.asarray(k_pos), **kw)
    args = [torch.from_numpy(a) for a in (q, k, v)]
    pos_t = dict(q_positions=torch.from_numpy(q_pos),
                 k_positions=torch.from_numpy(k_pos))
    assert_allclose(f32(mha_ref(*args, **pos_t, **kw)), f32(want),
                    rtol=2e-5, atol=2e-5)
    assert_allclose(f32(ops.flash_attention(*args, **pos_t, **kw)),
                    f32(want), rtol=2e-5, atol=2e-5)
    # default decode positions: the query sits at the end of the history
    want_default = jax_mha_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               **kw)
    assert_allclose(f32(mha_ref(*args, **kw)), f32(want_default),
                    rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("kw", [dict(causal=True), dict(causal=False),
                                dict(causal=True, window=3),
                                dict(causal=False, chunk=4)])
def test_attention_mask_matches_jax(kw):
    q_pos = np.arange(10, dtype=np.int32)[None]
    k_pos = np.array([[-1, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, -1]], np.int32)
    want = np.asarray(jax_mask(jnp.asarray(q_pos), jnp.asarray(k_pos), **kw))
    got = attention_mask(torch.from_numpy(q_pos), torch.from_numpy(k_pos),
                         **kw).numpy()
    assert (got == want).all()


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------

def _rglru_inputs(B, S, W, seed=7):
    """log_a <= 0 and gx as the JAX suite draws them (softplus of normals)."""
    rng = np.random.default_rng(seed)
    la = -np.logaddexp(0.0, rng.standard_normal((B, S, W))).astype(np.float32)
    gx = rng.standard_normal((B, S, W)).astype(np.float32)
    h0 = rng.standard_normal((B, W)).astype(np.float32)
    return la, gx, h0


@pytest.mark.parametrize("S", [128, 256])
@pytest.mark.parametrize("W", [128, 256])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_sequential_matches_jax(S, W, with_h0):
    la, gx, h0 = _rglru_inputs(2, S, W)
    h0 = h0 if with_h0 else None
    jh0 = None if h0 is None else jnp.asarray(h0)
    th0 = None if h0 is None else torch.from_numpy(h0)
    y, h_last = rglru_sequential(torch.from_numpy(la), torch.from_numpy(gx),
                                 th0)
    assert y.dtype == torch.float32 and h_last.dtype == torch.float32
    for want_y, want_h in (
            jax_rglru_sequential(jnp.asarray(la), jnp.asarray(gx), jh0),
            rglru_pallas(jnp.asarray(la), jnp.asarray(gx), jh0,
                         interpret=True)):
        assert_allclose(f32(y), f32(want_y), rtol=1e-4, atol=1e-4)
        assert_allclose(f32(h_last), f32(want_h), rtol=1e-4, atol=1e-4)
    # from 64 steps on the CPU path is rglru_assoc, as the JAX package's
    y_ops, h_ops = ops.rglru_scan(torch.from_numpy(la), torch.from_numpy(gx),
                                  th0)
    y_assoc, h_assoc = rglru_assoc(torch.from_numpy(la),
                                   torch.from_numpy(gx), th0)
    assert torch.equal(y_ops, y_assoc) and torch.equal(h_ops, h_assoc)


@pytest.mark.parametrize("S", [64, 200, 384])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_assoc_matches_jax(S, with_h0):
    """The log-depth scan against JAX's ``rglru_assoc`` and both sequential
    scans, at 1e-4; ``ops.rglru_scan`` takes it on the CPU from 64 steps."""
    la, gx, h0 = _rglru_inputs(2, S, 96)
    h0 = h0 if with_h0 else None
    jh0 = None if h0 is None else jnp.asarray(h0)
    th0 = None if h0 is None else torch.from_numpy(h0)
    y, h_last = rglru_assoc(torch.from_numpy(la), torch.from_numpy(gx), th0)
    assert y.dtype == torch.float32 and h_last.dtype == torch.float32
    assert y.shape == (2, S, 96) and h_last.shape == (2, 96)
    for want_y, want_h in (
            jax_rglru_assoc(jnp.asarray(la), jnp.asarray(gx), jh0),
            jax_rglru_sequential(jnp.asarray(la), jnp.asarray(gx), jh0),
            rglru_sequential(torch.from_numpy(la), torch.from_numpy(gx), th0)):
        assert_allclose(f32(y), f32(want_y), rtol=1e-4, atol=1e-4)
        assert_allclose(f32(h_last), f32(want_h), rtol=1e-4, atol=1e-4)
    y_ops, h_ops = ops.rglru_scan(torch.from_numpy(la), torch.from_numpy(gx),
                                  th0)
    assert torch.equal(y_ops, y) and torch.equal(h_ops, h_last)


def test_rglru_cpu_path_below_64_steps_is_sequential():
    la, gx, h0 = _rglru_inputs(2, 63, 16)
    args = (torch.from_numpy(la), torch.from_numpy(gx), torch.from_numpy(h0))
    for got, want in zip(ops.rglru_scan(*args), rglru_sequential(*args)):
        assert torch.equal(got, want)


def test_rglru_assoc_keeps_gx_dtype():
    la, gx, _ = _rglru_inputs(1, 70, 8)
    y, h_last = rglru_assoc(torch.from_numpy(la),
                            torch.from_numpy(gx).bfloat16())
    assert y.dtype == torch.bfloat16 and h_last.dtype == torch.float32
    want_y, want_h = jax_rglru_assoc(jnp.asarray(la),
                                     jnp.asarray(gx).astype(jnp.bfloat16))
    assert_allclose(f32(y), f32(want_y), **tol("bfloat16"))
    assert_allclose(f32(h_last), f32(want_h), rtol=1e-4, atol=1e-4)


def test_rglru_sequential_keeps_gx_dtype_and_fp32_state():
    la, gx, _ = _rglru_inputs(1, 5, 8)
    y, h_last = rglru_sequential(torch.from_numpy(la),
                                 torch.from_numpy(gx).bfloat16())
    assert y.dtype == torch.bfloat16 and h_last.dtype == torch.float32
    want_y, want_h = jax_rglru_sequential(jnp.asarray(la),
                                          jnp.asarray(gx).astype(jnp.bfloat16))
    assert_allclose(f32(y), f32(want_y), **tol("bfloat16"))
    assert_allclose(f32(h_last), f32(want_h), rtol=1e-4, atol=1e-4)


def test_rglru_gates_match_jax():
    B, S, Hb, bw = 2, 9, 4, 16
    rng = np.random.default_rng(8)
    p = {"a_gate_w": rng.standard_normal((Hb, bw, bw)) * 0.1,
         "a_gate_b": rng.standard_normal((Hb, bw)) * 0.1,
         "x_gate_w": rng.standard_normal((Hb, bw, bw)) * 0.1,
         "x_gate_b": rng.standard_normal((Hb, bw)) * 0.1,
         "a_param": rng.standard_normal(Hb * bw)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((B, S, Hb * bw)).astype(np.float32)
    want = jax_rglru_gates(jnp.asarray(x),
                           {k: jnp.asarray(v) for k, v in p.items()})
    got = rglru_gates(torch.from_numpy(x),
                      {k: torch.from_numpy(v) for k, v in p.items()})
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert_allclose(f32(g), f32(w), rtol=2e-5, atol=2e-5)
    assert bool((got[0] <= 0).all())


# ---------------------------------------------------------------------------
# Mamba-2 SSD
# ---------------------------------------------------------------------------

def _ssd_inputs(B, S, H, P, G, N, seed=5):
    """x, dt, A, Bm, Cm, D as the JAX suite draws them (fp32 numpy)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P))
    dt = np.logaddexp(0.0, rng.standard_normal((B, S, H)))
    A = -np.exp(rng.standard_normal(H) * 0.5)
    Bm = rng.standard_normal((B, S, G, N)) * 0.3
    Cm = rng.standard_normal((B, S, G, N)) * 0.3
    D = rng.standard_normal(H)
    return [a.astype(np.float32) for a in (x, dt, A, Bm, Cm, D)]


def _ssd_both(arrays, dtype):
    """The inputs for JAX and torch, x/Bm/Cm in ``dtype``, the rest fp32."""
    jax_args, torch_args = [], []
    for i, a in enumerate(arrays):
        j, t = both(a, dtype if i in (0, 3, 4) else "float32")
        jax_args.append(j)
        torch_args.append(t)
    return jax_args, torch_args


def _ssd_tol(dtype):
    return dict(rtol=5e-2, atol=5e-2) if dtype == "bfloat16" \
        else dict(rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("B,S,H,P,G,N,chunk", [
    (1, 128, 2, 64, 1, 64, 64),
    (2, 256, 3, 64, 1, 128, 128),
    (1, 256, 4, 32, 2, 64, 128),      # grouped B/C
    (1, 256, 1, 128, 1, 128, 128),    # P, N and chunk 128
    (1, 512, 2, 64, 1, 128, 256),     # chunk 256: the kernels' tile is 128
    (1, 512, 1, 128, 1, 128, 256),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_refs_match_jax(B, S, H, P, G, N, chunk, dtype):
    """``test_ssd_sweep``'s shapes, and head and state dims of 128 at chunks
    of 128 and 256: both torch scans against JAX's scans and ``ssd_pallas``
    in interpret mode."""
    jax_args, torch_args = _ssd_both(_ssd_inputs(B, S, H, P, G, N), dtype)
    y_seq, state_seq = ssd_sequential(*torch_args)
    y_chk, state_chk = ssd_chunked(*torch_args, chunk=chunk)
    for y in (y_seq, y_chk):
        assert y.dtype == torch_args[0].dtype and y.shape == (B, S, H, P)
    want_seq = jax_ssd_sequential(*jax_args)
    for want in (want_seq, jax_ssd_chunked(*jax_args, chunk=chunk),
                 ssd_pallas(*jax_args, chunk=chunk, interpret=True)):
        assert_allclose(f32(y_chk), f32(want), **_ssd_tol(dtype))
    assert_allclose(f32(y_seq), f32(want_seq), **_ssd_tol(dtype))
    assert state_chk.dtype == torch.float32
    assert_allclose(f32(state_chk), f32(state_seq), rtol=1e-4, atol=1e-4)
    y_ops, state_ops = ops.ssd_scan(*torch_args, chunk=chunk)
    assert torch.equal(y_ops, y_chk) and torch.equal(state_ops, state_chk)


@pytest.mark.parametrize("P", [64, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_chunked_at_256_agrees_with_128(P, dtype):
    """The premise of the kernels' tile of 128 for a chunk of 256: the
    chunked scan computes one function at any chunk, so ``ssd_chunked`` at
    chunk 256 and at 128 agree within the SSD tolerance (2e-3 fp32, 5e-2
    bf16; y, and the final state at fp32's), as JAX's own scan at 256
    agrees with both."""
    jax_args, torch_args = _ssd_both(_ssd_inputs(2, 512, 2, P, 1, 128),
                                     dtype)
    y256, s256 = ssd_chunked(*torch_args, chunk=256)
    y128, s128 = ssd_chunked(*torch_args, chunk=128)
    assert_allclose(f32(y256), f32(y128), **_ssd_tol(dtype))
    assert_allclose(f32(s256), f32(s128), **_ssd_tol("float32"))
    want = jax_ssd_chunked(*jax_args, chunk=256)
    for y in (y256, y128):
        assert_allclose(f32(y), f32(want), **_ssd_tol(dtype))


@pytest.mark.parametrize("S,chunk", [(50, 16), (37, 128)])
def test_ssd_ragged_matches_jax_sequential(S, chunk):
    """S not a multiple of the chunk: the CPU path is ``ssd_sequential``."""
    arrays = _ssd_inputs(2, S, 4, 16, 2, 8)
    jax_args, torch_args = _ssd_both(arrays, "float32")
    y, state = ops.ssd_scan(*torch_args, chunk=chunk)
    assert_allclose(f32(y), f32(jax_ssd_sequential(*jax_args)),
                    **_ssd_tol("float32"))
    y_seq, state_seq = ssd_sequential(*torch_args)
    assert torch.equal(y, y_seq) and torch.equal(state, state_seq)


def _jax_fold(jax_args):
    """The JAX model's prefill state: ``ssd_decode_step`` folded over S."""
    x, dt, A, Bm, Cm, D = jax_args
    B, S, H, P = x.shape
    state = jnp.zeros((B, H, P, Bm.shape[-1]), jnp.float32)
    for t in range(S):
        state, _ = jax_ssd_decode_step(state, x[:, t], dt[:, t], A, Bm[:, t],
                                       Cm[:, t], D)
    return state


@pytest.mark.parametrize("S,chunk", [(64, 16), (40, 16)])
def test_ssd_final_state_matches_jax_fold(S, chunk):
    """The state the scans return is the state the JAX prefill computes by
    folding its decode step over the prompt."""
    jax_args, torch_args = _ssd_both(_ssd_inputs(2, S, 4, 16, 2, 16),
                                     "float32")
    want = f32(_jax_fold(jax_args))
    _, state = ops.ssd_scan(*torch_args, chunk=chunk)
    assert_allclose(f32(state), want, rtol=1e-4, atol=1e-4)
    assert_allclose(f32(ssd_sequential(*torch_args)[1]), want, rtol=1e-4,
                    atol=1e-4)


@pytest.mark.parametrize("G", [1, 2])
def test_ssd_decode_step_matches_jax(G):
    B, H, P, N = 2, 4, 16, 8
    rng = np.random.default_rng(9)
    state = rng.standard_normal((B, H, P, N)).astype(np.float32)
    arrays = [a[:, 0] if a.ndim > 1 else a
              for a in _ssd_inputs(B, 1, H, P, G, N, seed=10)]
    want_state, want_y = jax_ssd_decode_step(
        jnp.asarray(state), *(jnp.asarray(a) for a in arrays))
    got_state, got_y = ssd_decode_step(
        torch.from_numpy(state), *(torch.from_numpy(a) for a in arrays))
    assert got_state.dtype == torch.float32 and got_y.shape == (B, H, P)
    assert_allclose(f32(got_state), f32(want_state), rtol=1e-4, atol=1e-4)
    assert_allclose(f32(got_y), f32(want_y), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("S,chunk", [(256, 64), (200, 64), (90, 20)])
def test_ssd_phases_match_jax(S, chunk):
    """The three phases, composed, at any S (a ragged last chunk padded as
    the kernel pads it): y and the final state against JAX's sequential
    scan, and against JAX's chunked scan where S is whole chunks."""
    arrays = _ssd_inputs(2, S, 4, 24, 2, 16)
    jax_args, torch_args = _ssd_both(arrays, "float32")
    x, dt, A, Bm, Cm, D = torch_args
    states, cum = ssd_chunk_state(x, dt, A, Bm, chunk=chunk)
    nc = -(-S // chunk)
    assert states.shape == (2, nc, 4, 24, 16)
    assert cum.shape == (2, 4, nc * chunk)
    assert states.dtype == cum.dtype == torch.float32
    states_in, state = ssd_state_passing(states, cum, chunk=chunk)
    assert torch.equal(states_in[:, 0], torch.zeros_like(states_in[:, 0]))
    y = ssd_chunk_scan(x, dt, Bm, Cm, D, cum, states_in, chunk=chunk)
    assert y.shape == x.shape and y.dtype == x.dtype
    assert_allclose(f32(y), f32(jax_ssd_sequential(*jax_args)),
                    **_ssd_tol("float32"))
    assert_allclose(f32(state), f32(_jax_fold(jax_args)), rtol=1e-4,
                    atol=1e-4)
    if S % chunk == 0:
        assert_allclose(f32(y), f32(jax_ssd_chunked(*jax_args, chunk=chunk)),
                        **_ssd_tol("float32"))
        y_chk, state_chk = ssd_chunked(*torch_args, chunk=chunk)
        assert torch.equal(y_chk, y) and torch.equal(state_chk, state)


@pytest.mark.parametrize("B,S,H,P,G,N,chunk", [
    (1, 512, 4, 64, 1, 128, 128),     # mamba2-130m's head, state and chunk
    (1, 256, 4, 32, 2, 64, 64),       # grouped B/C
])
def test_ssd_mma_operand_rounding_holds_bf16_tolerance(B, S, H, P, G, N,
                                                       chunk, capsys):
    """The mma body's precision design, in plain torch: bf16 x, B and C (the
    served inputs, exact on the tensor cores) and the fp32 operands w∘x,
    the scores and the state split into bf16 hi + lo.  y against JAX's
    ``ssd_chunked`` at the bf16 tolerance 5e-2 and the final state at the
    fp32 one 2e-3; the split's error beside plain bf16 rounding's."""
    jax_args, (x, dt, A, Bm, Cm, D) = _ssd_both(
        _ssd_inputs(B, S, H, P, G, N), "bfloat16")
    want_y = f32(jax_ssd_chunked(*jax_args, chunk=chunk))
    # the exact fp32 function of these (bf16) inputs, before any rounding
    states, cum = ssd_chunk_state(x, dt, A, Bm, chunk=chunk)
    states_in, exact_state = ssd_state_passing(states, cum, chunk=chunk)
    exact_y = f32(ssd_chunk_scan(x.float(), dt, Bm, Cm, D, cum, states_in,
                                 chunk=chunk))
    errs = {}
    for name, rnd in (("split", split_bf16),
                      ("bf16", lambda v: v.bfloat16().float())):
        states, cum = ssd_chunk_state(x, dt, A, Bm, chunk=chunk,
                                      round_operand=rnd)
        states_in, state = ssd_state_passing(states, cum, chunk=chunk)
        y = ssd_chunk_scan(x, dt, Bm, Cm, D, cum, states_in, chunk=chunk,
                           round_operand=rnd)
        y_f32 = ssd_chunk_scan(x.float(), dt, Bm, Cm, D, cum, states_in,
                               chunk=chunk, round_operand=rnd)
        errs[name] = dict(
            y_vs_jax=float(np.abs(f32(y) - want_y).max()),
            y_before_store=float(np.abs(f32(y_f32) - exact_y).max()),
            state=float((state - exact_state).abs().max()))
        if name == "split":
            assert_allclose(f32(y), want_y, **_ssd_tol("bfloat16"))
            assert_allclose(f32(state), f32(exact_state),
                            **_ssd_tol("float32"))
    with capsys.disabled():
        print(f"\nssd mma operands at {(B, S, H, P, G, N, chunk)}, max abs "
              f"err: {errs}")
    # the split keeps the fp32 operands near fp32: far below plain bf16
    # rounding's error
    for key in ("y_before_store", "state"):
        assert errs["split"][key] < 0.05 * errs["bf16"][key]


@pytest.mark.parametrize("S", [256, 384, 200])
def test_ssd_fwd_split_products_hold_the_ssd_tolerance(S, capsys):
    """The fp32 forward's mma_tf32x3 body in plain torch: the three phases
    with every product of two tensors formed on the TF32 tensor cores' way
    (hi + lo splits by truncation, three products: ``split_einsum`` with
    ``truncate_tf32``) against JAX's ``ssd_chunked`` (its sequential scan at
    the ragged S = 200) at mamba2-130m's widths (H 24, P 64, N 128, one
    group, chunk 128) at the fp32 SSD tolerance 2e-3 (1 + |want|), and the
    final state against JAX's decode step folded over S at 1e-4; the same
    products from operands cut once to TF32 (1xTF32, printed beside) miss
    both."""
    H, P, G, N, chunk = 24, 64, 1, 128, 128
    jax_args, torch_args = _ssd_both(_ssd_inputs(1, S, H, P, G, N),
                                     "float32")
    x, dt, A, Bm, Cm, D = torch_args
    want_y = f32(jax_ssd_chunked(*jax_args, chunk=chunk) if S % chunk == 0
                 else jax_ssd_sequential(*jax_args))
    want_state = _jax_fold(jax_args)
    products = {
        "tf32x3": lambda eq, a, b: split_einsum(eq, a, b, truncate_tf32),
        "tf32": lambda eq, a, b: torch.einsum(eq, truncate_tf32(a),
                                              truncate_tf32(b))}
    share = {}
    for name, product in products.items():
        states, cum = ssd_chunk_state(x, dt, A, Bm, chunk=chunk,
                                      product=product)
        states_in, state = ssd_state_passing(states, cum, chunk=chunk)
        y = ssd_chunk_scan(x, dt, Bm, Cm, D, cum, states_in, chunk=chunk,
                           product=product)
        share[name] = dict(y=_share(y, want_y, 2e-3),
                           state=_share(state, want_state, 1e-4))
    with capsys.disabled():
        print(f"\nssd forward split products at S={S}, share of the "
              f"tolerance (y 2e-3, state 1e-4): {share}")
    assert share["tf32x3"]["y"] <= 1.0 and share["tf32x3"]["state"] <= 1.0
    assert share["tf32"]["y"] > 1.0 and share["tf32"]["state"] > 1.0


def test_ssd_one_bf16_step_tells_split_from_plain_bf16():
    """The limit at which the card holds the mma body's chunk scan against
    its plain phase with split operands (``chip_smoke.py``,
    ``test_ssd_mma_body_keeps_the_split_operands``): at mamba2-130m's
    widths, y of the exact fp32 operands lies within one bf16 step
    (|err| <= 2^-7 (1 + |y|)) of y of the split ones, and y of operands
    rounded to plain bf16 does not."""
    x, dt, A, Bm, Cm, D = _ssd_both(_ssd_inputs(1, 512, 24, 64, 1, 128),
                                    "bfloat16")[1]
    states, cum = ssd_chunk_state(x, dt, A, Bm, chunk=128)
    states_in, _ = ssd_state_passing(states, cum, chunk=128)

    def y(rnd):
        return ssd_chunk_scan(x, dt, Bm, Cm, D, cum, states_in, chunk=128,
                              round_operand=rnd).float()

    want = y(split_bf16)
    limit = 2 ** -7 * (1 + want.abs())
    assert bool(((y(None) - want).abs() <= limit).all())
    assert not bool(((y(lambda v: v.bfloat16().float()) - want).abs()
                     <= limit).all())


# ---------------------------------------------------------------------------
# the scans' plain backwards (the oracles of the backward kernels)
# ---------------------------------------------------------------------------

def _ssd_grad_inputs(B, S, H, P, G, N, seed=5):
    arrays = _ssd_inputs(B, S, H, P, G, N, seed=seed)
    rng = np.random.default_rng(seed + 100)
    dy = rng.standard_normal((B, S, H, P)).astype(np.float32)
    d_state = rng.standard_normal((B, H, P, N)).astype(np.float32)
    return arrays, dy, d_state


@pytest.mark.parametrize("S,P,N,chunk", [
    pytest.param(256, 16, 16, 64, id="256"),
    pytest.param(200, 16, 16, 64, id="200"),
    pytest.param(256, 128, 128, 128, id="256-p128-n128-c128"),
    pytest.param(512, 64, 128, 256, id="512-p64-n128-c256"),
    pytest.param(512, 128, 128, 256, id="512-p128-n128-c256"),
])
@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_bwd_ref_matches_jax_grad(S, P, N, chunk, G, dtype):
    """dx, ddt, dA, dB, dC, dD of ``ssd_chunked_bwd`` against ``jax.grad`` of
    JAX's chunked scan (its sequential scan at the ragged S = 200, where the
    plain backward pads the last chunk as the kernel does) and against
    autograd of the port's own scan, at the SSD tolerances (2e-3 fp32, 5e-2
    bf16); x, Bm, Cm and dy in ``dtype``, dt, A, D fp32.  Past P 64 also
    with the sums over P taken in the mma body's slabs of 64 columns
    (``slab=BWD_SLAB_P``); at chunk 256 the chunk the JAX package runs."""
    B, H = 2, 4
    arrays, dy, _ = _ssd_grad_inputs(B, S, H, P, G, N)
    jax_args, torch_args = _ssd_both(arrays, dtype)
    jdy, tdy = both(dy, dtype)
    if S % chunk == 0:
        def loss(*a):
            return jnp.sum(jax_ssd_chunked(*a, chunk=chunk).astype(jnp.float32)
                           * jdy.astype(jnp.float32))
    else:
        def loss(*a):
            return jnp.sum(jax_ssd_sequential(*a).astype(jnp.float32)
                           * jdy.astype(jnp.float32))
    want = jax.jit(jax.grad(loss, argnums=range(6)))(*jax_args)
    got = ssd_chunked_bwd(*torch_args, tdy, chunk=chunk)
    for g, w, t in zip(got, want, torch_args):
        assert g.dtype == t.dtype and g.shape == t.shape
        assert_allclose(f32(g), f32(w), **_ssd_tol(dtype))
    if P > BWD_SLAB_P:
        by_slabs = ssd_chunked_bwd(*torch_args, tdy, chunk=chunk,
                                   slab=BWD_SLAB_P)
        for g, w in zip(by_slabs, want):
            assert_allclose(f32(g), f32(w), **_ssd_tol(dtype))
    leaves = [t.clone().requires_grad_() for t in torch_args]
    y, _ = (ssd_chunked(*leaves, chunk=chunk) if S % chunk == 0
            else ssd_sequential(*leaves))
    (y.float() * tdy.float()).sum().backward()
    for g, leaf in zip(got, leaves):
        assert_allclose(f32(g), f32(leaf.grad), **_ssd_tol(dtype))


@pytest.mark.parametrize("B", [1, 2])
def test_ssd_bwd_split_products_hold_the_ssd_tolerance(B):
    """``ssd_chunked_bwd`` with every product of two tensors formed as the
    backward's mma body forms it on the TF32 tensor cores (hi + lo splits
    by truncation, three products: ``split_einsum`` with
    ``truncate_tf32``; the flash backward's round-to-nearest split
    ``split_tf32`` too) against ``jax.grad`` of JAX's chunked scan at
    mamba2-130m's widths (P 64, N 128, chunk 128) at the fp32 SSD
    tolerance, 2e-3; the same products from operands cut once to TF32 (the
    tensor cores' reading of an unsplit fp32 operand) miss it."""
    H, S, P, G, N, chunk = 4, 256, 64, 1, 128, 128
    arrays, dy, _ = _ssd_grad_inputs(B, S, H, P, G, N)
    jax_args, torch_args = _ssd_both(arrays, "float32")
    want = jax.jit(jax.grad(
        lambda *a: jnp.sum(jax_ssd_chunked(*a, chunk=chunk) * dy),
        argnums=range(6)))(*jax_args)

    def split(eq, a, b):
        return split_einsum(eq, a, b, truncate_tf32)

    def split_rna(eq, a, b):
        return split_einsum(eq, a, b, split_tf32)

    def plain(eq, a, b):
        return torch.einsum(eq, truncate_tf32(a), truncate_tf32(b))

    def within(product):
        got = ssd_chunked_bwd(*torch_args, torch.from_numpy(dy), chunk=chunk,
                              product=product)
        return [bool(np.all(np.abs(f32(g) - f32(w))
                            <= 2e-3 * (1 + np.abs(f32(w)))))
                for g, w in zip(got, want)]

    assert all(within(split)) and all(within(split_rna))
    assert not all(within(plain))


@pytest.mark.parametrize("S", [256, 200])
def test_ssd_bwd_ref_takes_the_final_state_gradient(S):
    """With a gradient of the final state too: against ``jax.grad`` of JAX's
    decode step folded over the sequence (its y and its state) and autograd
    of the port's scan, fp32, 2e-3."""
    B, H, P, G, N, chunk = 2, 4, 16, 2, 16, 64
    arrays, dy, d_state = _ssd_grad_inputs(B, S, H, P, G, N, seed=8)
    jax_args, torch_args = _ssd_both(arrays, "float32")

    def loss(x, dt, A, Bm, Cm, D):
        def step(state, inp):
            xt, dtt, bt, ct, dyt = inp
            state, y = jax_ssd_decode_step(state, xt, dtt, A, bt, ct, D)
            return state, jnp.sum(y * dyt)

        state, terms = jax.lax.scan(
            step, jnp.zeros((B, H, P, N), jnp.float32),
            tuple(jnp.moveaxis(a, 1, 0) for a in (x, dt, Bm, Cm, dy)))
        return jnp.sum(terms) + jnp.sum(state * d_state)

    want = jax.jit(jax.grad(loss, argnums=range(6)))(*jax_args)
    got = ssd_chunked_bwd(*torch_args, torch.from_numpy(dy),
                          torch.from_numpy(d_state), chunk=chunk)
    leaves = [t.clone().requires_grad_() for t in torch_args]
    y, state = (ssd_chunked(*leaves, chunk=chunk) if S % chunk == 0
                else ssd_sequential(*leaves))
    ((y * torch.from_numpy(dy)).sum()
     + (state * torch.from_numpy(d_state)).sum()).backward()
    for g, w, leaf in zip(got, want, leaves):
        assert_allclose(f32(g), f32(w), **_ssd_tol("float32"))
        assert_allclose(f32(g), f32(leaf.grad), **_ssd_tol("float32"))


def test_ssd_bwd_dD_over_8192_tokens_matches_jax():
    """dD = sum of x·dy over B·S = 8192 tokens a head, summed as the kernel
    sums it (a pairwise tree over each chunk's tokens, then
    ``ssd_sum_ordered`` over the chunks), against ``jax.grad`` at 2e-5."""
    B, S, H, P, G, N, chunk = 8, 1024, 2, 16, 1, 16, 128
    arrays, dy, _ = _ssd_grad_inputs(B, S, H, P, G, N, seed=0)
    want = jax.jit(jax.grad(
        lambda *a: jnp.sum(jax_ssd_chunked(*a, chunk=chunk) * dy),
        argnums=5))(*(jnp.asarray(a) for a in arrays))
    got = ssd_chunked_bwd(*(torch.from_numpy(a) for a in arrays),
                          torch.from_numpy(dy), chunk=chunk)[5]
    assert np.abs(np.asarray(want)).max() > 100
    assert_allclose(f32(got), f32(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("B,S,chunk", [(8, 1024, 128), (2, 4096, 64)])
def test_ssd_bwd_dA_order_holds_2e_5_on_8192_terms(B, S, chunk):
    """dA = the sum over B·S = 8192 tokens of dt·d(dt·A): fp32 terms whose
    running sums wander far from the total (the first half of the tokens
    drifts up, the second down) summed in the kernel's order (a pairwise
    tree over each chunk's tokens, then ``ssd_sum_ordered``) hold 2e-5
    against their float64 sum and JAX's ``jnp.sum`` of them, where a plain
    running sum misses.  (``jax.grad`` of the whole scan cannot be the
    reference at 2e-5: its own fp32 dA strays from the float64 value by up
    to 4.3e-5 at B·S = 8192, since the terms come out of the chunk's
    cancelling reverse cumsum.)"""
    H = 4
    rng = np.random.default_rng(1)
    dt = np.logaddexp(0.0, rng.standard_normal((B, S, H)))
    drift = np.where(np.arange(B * S).reshape(B, S, 1) < B * S // 2, 1.0,
                     -1.0)
    terms = (dt * (rng.standard_normal((B, S, H)) * 4 + drift)).astype(
        np.float32)
    exact = terms.astype(np.float64).sum((0, 1))
    got = ssd_sum_ordered(_tree(torch.from_numpy(terms).reshape(
        B, S // chunk, chunk, H), 2))
    assert_allclose(f32(got), exact, rtol=2e-5, atol=2e-5)
    assert_allclose(f32(got), f32(jnp.sum(jnp.asarray(terms), axis=(0, 1))),
                    rtol=2e-5, atol=2e-5)
    running = np.zeros(H, np.float32)
    for row in terms.reshape(-1, H):
        running = running + row
    assert not np.all(np.abs(running - exact) <= 2e-5 * (1 + np.abs(exact)))


def test_ssd_bwd_slab_order_holds_2e_5_on_8192_terms():
    """The mma body's slabs of P: dA's and dD's per-chunk parts of two
    slabs of 64 columns, interleaved chunk by chunk (``ssd_sum_slabs``),
    hold 2e-5 against their float64 sums over B·S = 8192 tokens: dD of
    ``ssd_chunked_bwd(..., slab=64)`` at P 128 against the float64 sum of
    x·dy, and drifting terms of d(dt·A) (as
    ``test_ssd_bwd_dA_order_holds_2e_5_on_8192_terms``) cut into two slabs'
    parts, where a plain running sum over the parts misses."""
    B, S, H, P, G, N, chunk = 8, 1024, 2, 128, 1, 16, 128
    arrays, dy, _ = _ssd_grad_inputs(B, S, H, P, G, N, seed=0)
    got = ssd_chunked_bwd(*(torch.from_numpy(a) for a in arrays),
                          torch.from_numpy(dy), chunk=chunk,
                          slab=BWD_SLAB_P)[5]
    exact = (arrays[0].astype(np.float64) * dy).sum((0, 1, 3))
    assert np.abs(exact).max() > 100
    assert_allclose(f32(got), exact, rtol=2e-5, atol=2e-5)

    rng = np.random.default_rng(2)
    dt = np.logaddexp(0.0, rng.standard_normal((2, B, S, H)))
    drift = np.where(np.arange(B * S).reshape(1, B, S, 1) < B * S // 2, 1.0,
                     -1.0)
    terms = (dt * (rng.standard_normal((2, B, S, H)) * 4 + drift)).astype(
        np.float32)
    exact = terms.astype(np.float64).sum((0, 1, 2))
    parts = [_tree(torch.from_numpy(t).reshape(B, S // chunk, chunk, H), 2)
             for t in terms]
    got = ssd_sum_slabs(parts)
    assert_allclose(f32(got), exact, rtol=2e-5, atol=2e-5)
    running = np.zeros(H, np.float32)
    for row in terms.transpose(1, 2, 0, 3).reshape(-1, H):
        running = running + row
    assert not np.all(np.abs(running - exact) <= 2e-5 * (1 + np.abs(exact)))


def test_ssd_sum_slabs_interleaves_the_slabs_chunk_by_chunk():
    parts = [torch.arange(2 * 300 * 2, dtype=torch.float32).reshape(2, 300, 2)
             * (1 + s) for s in range(2)]
    flat = torch.stack(parts, 2).reshape(1200, 2)
    assert torch.equal(flat[:2], torch.stack([parts[0][0, 0],
                                              parts[1][0, 0]]))
    assert torch.equal(ssd_sum_slabs(parts),
                       ssd_sum_ordered(flat.reshape(1, 1200, 2)))
    assert torch.equal(ssd_sum_slabs(parts[:1]), ssd_sum_ordered(parts[0]))


def test_ssd_sum_ordered_is_the_lanes_then_a_tree():
    parts = torch.arange(600 * 2, dtype=torch.float32).reshape(2, 300, 2)
    flat = parts.reshape(600, 2)
    lanes = torch.stack([flat[k::256].sum(0) for k in range(256)])
    assert torch.equal(ssd_sum_ordered(parts), _tree(lanes, 0))
    assert torch.equal(_tree(torch.arange(5.0), 0), torch.tensor(10.0))


def _rglru_grad_inputs(B, S, W, seed=11):
    la, gx, h0 = _rglru_inputs(B, S, W, seed=seed)
    rng = np.random.default_rng(seed + 100)
    dy = rng.standard_normal((B, S, W)).astype(np.float32)
    dh = rng.standard_normal((B, W)).astype(np.float32)
    return la, gx, h0, dy, dh


def _jax_rglru_grads(la, gx, h0, dy, dh, dtype):
    """jax.grad of JAX's scan (sequential below 64 steps, associative from
    64, as its CPU path) for y·dy (+ h_last·dh)."""
    scan = jax_rglru_sequential if la.shape[1] < 64 else jax_rglru_assoc
    jd = DTYPES[dtype][0]

    def loss(la, gx, h0):
        y, h_last = scan(la, gx, h0)
        out = jnp.sum(y.astype(jnp.float32) * dy)
        return out if dh is None else out + jnp.sum(h_last * dh)

    args = (jnp.asarray(la).astype(jd), jnp.asarray(gx).astype(jd),
            None if h0 is None else jnp.asarray(h0))
    if h0 is None:
        return (*jax.jit(jax.grad(lambda a, b: loss(a, b, None),
                                  argnums=(0, 1)))(*args[:2]), None)
    return jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*args)


@pytest.mark.parametrize("S", [37, 200])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("with_dh", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_bwd_ref_matches_jax_grad(S, with_h0, with_dh, dtype):
    """d log_a, d gx (and dh0) of ``rglru_bwd`` against ``jax.grad`` of JAX's
    scan and autograd of the port's, with and without h0 and a gradient of
    h_last, at 1e-4 fp32 / 2e-2 bf16; W 64."""
    la, gx, h0, dy, dh = _rglru_grad_inputs(2, S, 64)
    h0 = h0 if with_h0 else None
    dh = dh if with_dh else None
    t = dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=1e-4, atol=1e-4)
    want = _jax_rglru_grads(la, gx, h0, dy, dh, dtype)
    td = DTYPES[dtype][1]
    la_t, gx_t = (torch.from_numpy(a).to(td) for a in (la, gx))
    h0_t = None if h0 is None else torch.from_numpy(h0)
    dh_t = None if dh is None else torch.from_numpy(dh)
    got = rglru_bwd(la_t, gx_t, torch.from_numpy(dy).to(td), h0_t, dh_t)
    assert got[0].dtype == got[1].dtype == td
    assert (got[2] is None) == (h0 is None)
    for g, w in zip(got, want):
        if w is not None:
            assert_allclose(f32(g), f32(w), **t)
    leaves = [la_t.clone().requires_grad_(), gx_t.clone().requires_grad_()]
    if h0_t is not None:
        leaves.append(h0_t.clone().requires_grad_())
    scan = rglru_sequential if S < 64 else rglru_assoc
    y, h_last = scan(*leaves[:2], h0=leaves[2] if h0_t is not None else None)
    loss = (y.float() * torch.from_numpy(dy)).sum()
    if dh_t is not None:
        loss = loss + (h_last * dh_t).sum()
    loss.backward()
    for g, leaf in zip(got, leaves):
        assert_allclose(f32(g), f32(leaf.grad), **t)


# the segmented backward's windows: the kernel's (16 segments of 32 steps,
# one partial window at these S) and small ones (4 segments of 8 steps: S
# 200 crosses 7 windows), so that every composition runs
RGLRU_BWD_WINDOWS = [dict(), dict(steps=8, segments=4)]


@pytest.mark.parametrize("S", [37, 200])
@pytest.mark.parametrize("with_h0,with_dh", [(False, False), (True, True),
                                             (True, False), (False, True)])
@pytest.mark.parametrize("windows", RGLRU_BWD_WINDOWS,
                         ids=["kernel", "small"])
def test_rglru_bwd_segmented_matches_jax_grad(S, with_h0, with_dh, windows):
    """``rglru_bwd_segmented``, the plain model of the segmented backward
    body's composition order, against ``jax.grad`` of JAX's scan at 1e-4,
    fp32, with and without h0 and a gradient of h_last; W 64."""
    la, gx, h0, dy, dh = _rglru_grad_inputs(2, S, 64)
    h0 = h0 if with_h0 else None
    dh = dh if with_dh else None
    want = _jax_rglru_grads(la, gx, h0, dy, dh, "float32")
    got = rglru_bwd_segmented(
        *(None if a is None else torch.from_numpy(a)
          for a in (la, gx, dy, h0, dh)), **windows)
    assert (got[2] is None) == (h0 is None)
    for g, w in zip(got, want):
        if w is not None:
            assert_allclose(f32(g), f32(w), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("edge", [0.0, -1e-7, -1e-3])
@pytest.mark.parametrize("windows", RGLRU_BWD_WINDOWS,
                         ids=["kernel", "small"])
def test_rglru_bwd_segmented_at_the_clamp_edge(edge, windows):
    """The segmented model where β's clamp holds (log_a 0), where 1/β is
    near 2000 (-1e-7) and at -1e-3, every third step, against ``jax.grad``
    at 1e-4, as ``rglru_bwd`` is held there."""
    la, gx, h0, dy, dh = _rglru_grad_inputs(2, 37, 64, seed=3)
    la[:, ::3] = edge
    want = _jax_rglru_grads(la, gx, h0, dy, dh, "float32")
    got = rglru_bwd_segmented(*(torch.from_numpy(a)
                                for a in (la, gx, dy, h0, dh)), **windows)
    for g, w in zip(got, want):
        assert np.all(np.isfinite(f32(g)))
        assert_allclose(f32(g), f32(w), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("edge", [0.0, -1e-7, -1e-3])
def test_rglru_bwd_ref_at_the_clamp_edge(edge):
    """log_a at 0 (1 - a² = 0: the clamp holds β at 1e-6 and passes no
    gradient), -1e-7 (1/β near 2000) and -1e-3, every third step, against
    ``jax.grad`` at 1e-4."""
    la, gx, h0, dy, dh = _rglru_grad_inputs(2, 37, 64, seed=3)
    la[:, ::3] = edge
    want = _jax_rglru_grads(la, gx, h0, dy, dh, "float32")
    got = rglru_bwd(*(torch.from_numpy(a) for a in (la, gx, dy, h0, dh)))
    for g, w in zip(got, want):
        assert np.all(np.isfinite(f32(g)))
        assert_allclose(f32(g), f32(w), rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the CUDA wrappers refuse what their kernels do not take
# ---------------------------------------------------------------------------

def test_cuda_wrappers_refuse_cpu_tensors():
    x = torch.ones(4, 128)
    with pytest.raises(ValueError, match="CUDA tensors"):
        rmsnorm_cuda(x, torch.ones(128))
    q = torch.ones(1, 16, 2, 64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention_cuda(q, q, q)
    la = torch.zeros(1, 4, 8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        rglru_cuda(la, la)
    x, Bm, h = torch.ones(1, 16, 2, 8), torch.ones(1, 16, 1, 8), torch.ones(2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ssd_cuda(x, torch.ones(1, 16, 2), h, Bm, Bm, h, chunk=16)


def test_build_keys_each_library_on_its_sources():
    from repro_torch.kernels import _build
    assert _build.sources() == ["flash_attention", "rglru", "rmsnorm", "ssd"]
    paths = {name: _build.library_path(name) for name in _build.sources()}
    assert paths == {name: _build.library_path(name)
                     for name in _build.sources()}
    for name, path in paths.items():
        assert path.parent == _build.BUILD_DIR
        assert path.name.startswith(name + "-") and path.suffix == ".so"
    assert len(set(paths.values())) == 4
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_build_keeps_each_log_beside_its_library():
    """The compiler's output (ptxas registers and spills) lives beside the
    library it built, so a run that finds the library built reads it."""
    from repro_torch.kernels import _build
    for name in _build.sources():
        log = _build.log_path(name)
        assert log == _build.library_path(name).with_suffix(".log")
        assert log.parent == _build.BUILD_DIR
