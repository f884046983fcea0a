"""The port's kernel modules against the JAX package.

The plain PyTorch versions (``rmsnorm_ref``, ``mha_ref``,
``attention_mask``) against the JAX Pallas kernels run in interpret mode and
against the JAX references, on the same numpy inputs.  Tolerances are the
JAX suite's own (``tests/test_kernels.py``): fp32 2e-5, bf16 2e-2, RG-LRU
scan 1e-4.  The CUDA kernels against their plain versions are in
``test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro.kernels.flash_attention.kernel import flash_attention_pallas
from repro.kernels.flash_attention.ref import attention_mask as jax_mask
from repro.kernels.flash_attention.ref import mha_ref as jax_mha_ref
from repro.kernels.rglru.kernel import rglru_pallas
from repro.kernels.rglru.ref import rglru_gates as jax_rglru_gates
from repro.kernels.rglru.ref import rglru_sequential as jax_rglru_sequential
from repro.kernels.rmsnorm.kernel import rmsnorm_pallas
from repro.kernels.rmsnorm.ref import rmsnorm_ref as jax_rmsnorm_ref
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import attention_mask, mha_ref
from repro_torch.kernels.rglru.kernel import rglru_cuda
from repro_torch.kernels.rglru.ref import rglru_gates, rglru_sequential
from repro_torch.kernels.rmsnorm.kernel import rmsnorm_cuda
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

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
    y_ops, h_ops = ops.rglru_scan(torch.from_numpy(la), torch.from_numpy(gx),
                                  th0)
    assert torch.equal(y_ops, y) and torch.equal(h_ops, h_last)


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


def test_build_keys_each_library_on_its_sources():
    from repro_torch.kernels import _build
    assert _build.sources() == ["flash_attention", "rglru", "rmsnorm"]
    paths = {name: _build.library_path(name) for name in _build.sources()}
    assert paths == {name: _build.library_path(name)
                     for name in _build.sources()}
    for name, path in paths.items():
        assert path.parent == _build.BUILD_DIR
        assert path.name.startswith(name + "-") and path.suffix == ".so"
    assert len(set(paths.values())) == 3
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
