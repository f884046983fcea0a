"""The choice of kernel body, on CPU tensors.

``select_body`` of the flash-attention and rmsnorm wrappers is a pure
function of dtype, shape, base address and strides: these tests hold it
without a card, including the inputs that no body takes (which raise).  The
bodies themselves run in ``test_torch_cuda.py``.
"""
import pytest
import torch

from repro_torch.kernels.flash_attention.kernel import select_body as flash_body
from repro_torch.kernels.flash_attention.kernel import tma_strides
from repro_torch.kernels.rmsnorm.kernel import select_body as rms_body

BF16, F32 = torch.bfloat16, torch.float32


def qkv(B=2, S=64, H=4, K=2, dh=128, dtype=BF16):
    return (torch.zeros(B, S, H, dh, dtype=dtype),
            torch.zeros(B, S, K, dh, dtype=dtype),
            torch.zeros(B, S, K, dh, dtype=dtype))


def fused(H, K, dh, extra=0, dtype=BF16):
    """q, k, v as views of one (B, S, (H + 2K) dh + extra) projection."""
    t = torch.zeros(2, 64, (H + 2 * K) * dh + extra, dtype=dtype)
    return tuple(x.unflatten(-1, (-1, dh)) for x in
                 t[..., :(H + 2 * K) * dh].split([H * dh, K * dh, K * dh], -1))


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dh", [128, 256])
def test_flash_bf16_aligned_takes_sm90(dh):
    assert flash_body(*qkv(dh=dh)) == "sm90"


@pytest.mark.parametrize("H,K", [(28, 4), (16, 1), (4, 4)])
def test_flash_fused_projection_views_take_sm90(H, K):
    q, k, v = fused(H, K, 128)
    assert not q.is_contiguous()
    assert flash_body(q, k, v) == "sm90"


@pytest.mark.parametrize("dh", [16, 32, 64, 80, 120, 160])
def test_flash_other_head_dims_take_mma(dh):
    assert flash_body(*qkv(dh=dh)) == "mma"


@pytest.mark.parametrize("dh", [64, 128, 256])
def test_flash_fp32_takes_fp32(dh):
    assert flash_body(*qkv(dh=dh, dtype=F32)) == "fp32"


def test_flash_misaligned_base_takes_mma():
    """A view one element past a 16-byte boundary."""
    t = torch.zeros(2, 64, 4 * 128 + 1, dtype=BF16)
    q = t[..., 1:].unflatten(-1, (4, 128))
    assert q.data_ptr() % 16
    _, k, v = qkv(K=4)
    assert flash_body(q, k, v) == "mma"
    assert flash_body(*qkv()) == "sm90"


def test_flash_misaligned_strides_take_mma():
    """A sequence stride of (H + 2K) dh + 4 elements: 8 bytes off."""
    q, k, v = fused(4, 2, 128, extra=4)
    assert q.stride(1) % 8 and q.data_ptr() % 16 == 0
    assert flash_body(q, k, v) == "mma"


def test_flash_broadcast_batch_takes_mma():
    """A batch stride of 0 (an expanded tensor) is not a TMA stride."""
    q, k, v = qkv()
    k = k[:1].expand(2, -1, -1, -1)
    assert k.stride(0) == 0
    assert flash_body(q, k, v) == "mma"


def test_flash_size_one_dims_do_not_decide():
    """The stride of a dim of size 1 is never stepped over: a batch of one
    and a single kv head may have any stride there."""
    q = torch.zeros(1, 64, 1, 128, dtype=BF16).as_strided(
        (1, 64, 1, 128), (7, 128, 3, 1))
    assert tma_strides(q) == (64 * 128, 128, 128)
    assert flash_body(q, q, q) == "sm90"
    k = torch.zeros(2, 64, 1, 128, dtype=BF16).as_strided(
        (2, 64, 1, 128), (64 * 128, 128, 5, 1))
    assert tma_strides(k) == (64 * 128, 128, 128)
    assert flash_body(torch.zeros(2, 64, 4, 128, dtype=BF16), k, k) == "sm90"


@pytest.mark.parametrize("scale,want", [(None, "sm90"), (0.1, "sm90"),
                                        (0.0, "mma"), (-0.5, "mma")])
def test_flash_sm90_needs_a_positive_scale(scale, want):
    assert flash_body(*qkv(), scale=scale) == want


@pytest.mark.parametrize("make,exc,match", [
    (lambda: qkv(dh=264), ValueError, "head_dim"),
    (lambda: qkv(H=6, K=4), ValueError, "multiple"),
    (lambda: (qkv()[0], *qkv(S=32)[1:]), ValueError, "self-attention"),
    (lambda: qkv(dtype=torch.float16), TypeError, "float32/bfloat16"),
    (lambda: (qkv()[0], qkv(dtype=F32)[1], qkv()[2]), TypeError, "one dtype"),
    (lambda: (qkv()[0].transpose(2, 3).contiguous().transpose(2, 3),
              *qkv()[1:]), ValueError, "contiguous"),
    (lambda: (qkv()[0][0], *qkv()[1:]), ValueError, "expected"),
])
def test_flash_select_raises_on_what_no_body_takes(make, exc, match):
    with pytest.raises(exc, match=match):
        flash_body(*make())


# ---------------------------------------------------------------------------
# rmsnorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D,dtype,vpl", [
    (768, BF16, 4), (1536, BF16, 8), (3584, BF16, 16), (4096, BF16, 16),
    (768, F32, 8), (1536, F32, 16), (3584, F32, 32), (4096, F32, 32),
    (8192, BF16, 32), (64, F32, 1),
])
def test_rmsnorm_rows_of_vectors_take_one_read(D, dtype, vpl):
    x = torch.zeros(4, D, dtype=dtype)
    assert rms_body(x, torch.zeros(D, dtype=dtype)) == ("one_read", vpl)
    assert rms_body(x, torch.zeros(D, dtype=BF16 if dtype == F32 else F32),
                    torch.zeros_like(x)) == ("one_read", vpl)


@pytest.mark.parametrize("D,dtype", [(130, BF16), (130, F32), (8192, F32),
                                     (16384, BF16), (4, F32)])
def test_rmsnorm_other_rows_take_generic(D, dtype):
    """Rows not of 16-byte vectors, wider than 32 vectors a lane, or (D 4,
    fp32 x) with a bf16 scale of 8 bytes."""
    x = torch.zeros(3, D, dtype=dtype)
    assert rms_body(x, torch.zeros(D, dtype=BF16)) == ("generic", 0)


def test_rmsnorm_misaligned_inputs_take_generic():
    x = torch.zeros(4 * 3584 + 1, dtype=BF16)[1:].view(4, 3584)
    s = torch.zeros(3584, dtype=BF16)
    assert x.data_ptr() % 16
    assert rms_body(x, s) == ("generic", 0)
    assert rms_body(s.expand(4, -1).contiguous(), s,
                    residual=x) == ("generic", 0)
    assert rms_body(torch.zeros(4, 3584, dtype=BF16), s) == ("one_read", 16)


@pytest.mark.parametrize("make,exc,match", [
    (lambda: (torch.zeros(2, 8, dtype=torch.float16), torch.zeros(8)),
     TypeError, "float32/bfloat16"),
    (lambda: (torch.zeros(2, 8), torch.zeros(9)), ValueError, "match"),
    (lambda: (torch.zeros(8, 2).t(), torch.zeros(8)), ValueError,
     "contiguous"),
    (lambda: (torch.zeros(2, 8), torch.zeros(8), torch.zeros(2, 8,
                                                              dtype=BF16)),
     ValueError, "residual"),
])
def test_rmsnorm_select_raises_on_what_no_body_takes(make, exc, match):
    with pytest.raises(exc, match=match):
        rms_body(*make())
