"""The choice of kernel body, on CPU tensors.

``select_body`` of the flash-attention, rmsnorm, SSD and RG-LRU wrappers is
a pure function of dtype, shape, base address and strides: these tests hold
it without a card, including the inputs that no body takes (which raise).
So is each backward's ``select_bwd_body`` (flash attention's, rmsnorm's
and the SSD scan's, and rmsnorm's grid), and the raw wrappers' refusal of
inputs that require grad.  The bodies themselves run
in ``test_torch_cuda.py``.
"""
import pytest
import torch

from repro_torch.kernels.flash_attention import kernel as flash
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.kernel import select_body as flash_body
from repro_torch.kernels.flash_attention.kernel import tma_strides
from repro_torch.kernels.rglru import kernel as rglru
from repro_torch.kernels.rglru.kernel import select_body as rglru_body
from repro_torch.kernels.rmsnorm import kernel as rms
from repro_torch.kernels.rmsnorm.kernel import rmsnorm_cuda
from repro_torch.kernels.rmsnorm.kernel import select_body as rms_body
from repro_torch.kernels.rmsnorm.kernel import select_bwd_body as rms_bwd_body
from repro_torch.kernels.ssd import kernel as ssd
from repro_torch.kernels.ssd.kernel import select_body as ssd_body

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

@pytest.mark.parametrize("dh", [80, 120, 128, 160, 256])
def test_flash_bf16_aligned_takes_sm90(dh):
    assert flash.SM90_HEAD_DIMS == (80, 120, 128, 160, 256)
    assert flash_body(*qkv(dh=dh)) == "sm90"


@pytest.mark.parametrize("H,K", [(28, 4), (16, 1), (4, 4)])
def test_flash_fused_projection_views_take_sm90(H, K):
    q, k, v = fused(H, K, 128)
    assert not q.is_contiguous()
    assert flash_body(q, k, v) == "sm90"


@pytest.mark.parametrize("H,K", [(16, 16), (32, 8)])
def test_flash_fused_projection_views_take_sm90_at_dh_80(H, K):
    """hubert-xlarge's MHA layout (q's 16 heads of 80 and k's and v's 32
    in one projection: 160-byte heads, multiples of 16) and a GQA one."""
    q, k, v = fused(H, K, 80)
    assert not q.is_contiguous() and q.stride(1) == (H + 2 * K) * 80
    assert flash_body(q, k, v) == "sm90"


@pytest.mark.parametrize("H,K", [(32, 8), (16, 1)])
def test_flash_fused_projection_views_take_sm90_at_dh_160(H, K):
    """stablelm-12b's GQA 32 : 8 layout (320-byte heads) and an MQA one."""
    q, k, v = fused(H, K, 160)
    assert not q.is_contiguous() and q.stride(1) == (H + 2 * K) * 160
    assert flash_body(q, k, v) == "sm90"


@pytest.mark.parametrize("H,K", [(16, 16), (32, 8)])
def test_flash_fused_views_8_bytes_off_take_mma_at_dh_80(H, K):
    """A sequence stride of (H + 2K) 80 + 4 elements: 8 bytes off."""
    q, k, v = fused(H, K, 80, extra=4)
    assert q.stride(1) % 8 and q.data_ptr() % 16 == 0
    assert flash_body(q, k, v) == "mma"


@pytest.mark.parametrize("dh", [16, 32, 64])
def test_flash_other_head_dims_take_mma(dh):
    assert flash_body(*qkv(dh=dh)) == "mma"


@pytest.mark.parametrize("dh", [16, 32, 64, 80, 120, 128, 160, 256])
def test_flash_fp32_takes_fp32(dh):
    """float32, at every head dim of the registry, takes the TF32 tensor
    cores' body (mma_tf32x3: 4 warps a CTA up to 128, 8 at 160 and 256);
    the FMA body (``fp32``) stays reachable (``body="fp32"``) at every one.
    The backward takes every head dim the forward takes."""
    assert flash.TF32_HEAD_DIMS == (16, 32, 64, 80, 120, 128, 160, 256)
    assert flash.BWD_HEAD_DIMS == flash.HEAD_DIMS
    want = ("mma_tf32x3", "fp32")
    assert flash.bodies_for(*qkv(dh=dh, dtype=F32)) == want
    assert flash_body(*qkv(dh=dh, dtype=F32)) == want[0]


@pytest.mark.parametrize("B,S,H,K,dh", [(16, 256, 8, 4, 64), (2, 37, 4, 1, 16),
                                        (1, 300, 32, 32, 80)])
def test_flash_fp32_train_shapes_take_mma_tf32x3(B, S, H, K, dh):
    """The train paths' fp32 shapes (the 100m preset, the smoke config, dh
    80), contiguous or as views of one fused projection (any stride: the
    body stages unaligned rows 4 bytes a copy)."""
    assert flash_body(*qkv(B=B, S=S, H=H, K=K, dh=dh, dtype=F32)) \
        == "mma_tf32x3"
    assert flash_body(*fused(H, K, dh, extra=1, dtype=F32)) == "mma_tf32x3"


def test_flash_bf16_bodies_are_unchanged():
    assert flash.bodies_for(*qkv(dh=128)) == ("sm90", "mma")
    assert flash.bodies_for(*qkv(dh=80)) == ("sm90", "mma")
    assert flash.bodies_for(*qkv(dh=160)) == ("sm90", "mma")
    assert flash.bodies_for(*qkv(dh=64)) == ("mma",)


def test_flash_counts_start_at_zero_by_body():
    flash.flash_attention_cuda.launches = 3
    flash.reset_counts()
    assert flash.flash_attention_cuda.launches == 0
    assert flash.flash_attention_cuda.launches_by_body == {
        "sm90": 0, "mma": 0, "mma_tf32x3": 0, "fp32": 0}
    flash.flash_attention_cuda.launches_by_head_dim["mma_tf32x3"][256] = 2
    flash.reset_counts()
    assert flash.flash_attention_cuda.launches_by_head_dim == {
        "sm90": {}, "mma": {}, "mma_tf32x3": {}, "fp32": {}}


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


@pytest.mark.parametrize("D,dtype,vpl", [
    (64, F32, 1), (256, F32, 2), (512, F32, 4), (1024, F32, 8),
    (512, BF16, 2), (768, BF16, 4), (1024, BF16, 4),
])
def test_rmsnorm_bwd_rows_of_at_most_1024_take_warp_rows(D, dtype, vpl):
    """The train widths (64 smoke, 256 small, 512 100m) and any row of
    16-byte vectors whose dscale sums fit 32 floats a lane."""
    x = torch.zeros(4, D, dtype=dtype)
    assert rms_bwd_body(x, torch.zeros(D, dtype=dtype),
                        torch.zeros_like(x)) == ("warp_rows", vpl)
    assert rms_bwd_body(x, torch.zeros(D, dtype=BF16 if dtype == F32 else F32),
                        torch.zeros_like(x)) == ("warp_rows", vpl)


@pytest.mark.parametrize("D,dtype", [(8200, F32), (8208, BF16), (1030, F32),
                                     (130, BF16), (130, F32)])
def test_rmsnorm_bwd_other_rows_take_generic(D, dtype):
    """Rows wider than 8 warps of 32 floats a lane (past 8192 elements) and
    rows not of 16-byte vectors."""
    x = torch.zeros(3, D, dtype=dtype)
    assert rms_bwd_body(x, torch.zeros(D, dtype=dtype),
                        torch.zeros_like(x)) == ("generic", 0)


# every registry width above 1024 (d_model; mamba2-130m's gated norm is
# 1536 wide) with the (warps, vectors a lane) of the cta_rows body
CTA_ROWS = {F32: {1280: (2, 5), 1536: (2, 6), 2048: (2, 8), 2560: (3, 7),
                  3584: (4, 7), 3840: (4, 8), 4096: (4, 8), 5120: (5, 8)},
            BF16: {1280: (2, 3), 1536: (2, 3), 2048: (2, 4), 2560: (3, 4),
                   3584: (4, 4), 3840: (4, 4), 4096: (4, 4), 5120: (5, 4)}}


def test_rmsnorm_cta_rows_widths_are_the_registrys_past_1024():
    from repro_torch.configs import ARCH_IDS, get_config
    wide = {get_config(a).d_model for a in ARCH_IDS} - set(range(1025))
    mamba2 = get_config("mamba2-130m")
    assert mamba2.ssm_heads * mamba2.ssm_head_dim == 1536
    assert set(CTA_ROWS[F32]) == set(CTA_ROWS[BF16]) == wide | {1536}


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("D", sorted(CTA_ROWS[F32]))
def test_rmsnorm_bwd_wide_rows_take_cta_rows(D, dtype):
    """Rows of 16-byte vectors of 1025-8192 elements take the cta_rows body
    with at most 32 floats a lane, in either scale dtype; the forward's
    one_read limits do not decide (fp32 5120 is past them)."""
    warps, vpl = CTA_ROWS[dtype][D]
    assert rms.cta_shape(D, dtype) == (warps, vpl)
    assert vpl * 16 // (4 if dtype == F32 else 2) <= rms.BWD_LANE_FLOATS
    assert warps * 32 * vpl * 16 >= D * (4 if dtype == F32 else 2)
    x = torch.zeros(3, D, dtype=dtype)
    for s_dtype in (F32, BF16):
        assert rms_bwd_body(x, torch.zeros(D, dtype=s_dtype),
                            torch.zeros_like(x)) == ("cta_rows", vpl)


@pytest.mark.parametrize("dtype,D,want", [(F32, 8192, (8, 8)),
                                          (BF16, 8192, (8, 4)),
                                          (F32, 1028, (2, 5)),
                                          (BF16, 1032, (2, 3))])
def test_rmsnorm_cta_rows_spans_1025_to_8192(dtype, D, want):
    x = torch.zeros(2, D, dtype=dtype)
    assert rms.cta_shape(D, dtype) == want
    assert rms_bwd_body(x, torch.zeros(D), torch.zeros_like(x)) == (
        "cta_rows", want[1])


def test_rmsnorm_bwd_misaligned_wide_rows_take_generic():
    x = torch.zeros(4, 1536)
    dy = torch.zeros(4 * 1536 + 1)[1:].view(4, 1536)
    xm = torch.zeros(4 * 1536 + 2)[2:].view(4, 1536)
    s = torch.zeros(1536)
    assert rms_bwd_body(x, s, dy) == ("generic", 0)
    assert rms_bwd_body(xm, s, torch.zeros_like(x)) == ("generic", 0)
    assert rms_bwd_body(x, torch.zeros(1537)[1:], torch.zeros_like(x)) == (
        "generic", 0)


@pytest.mark.parametrize("rows,sms,warps,want", [
    (8192, 132, 2, (8, 1024)),    # mamba2-130m's gated norm on an H100
    (2048, 132, 4, (4, 512)),     # recurrentgemma-9b's norm
    (7, 132, 8, (1, 7)),
    (100000, 16, 5, (2084, 48)),
])
def test_rmsnorm_cta_grid_from_the_sm_count(rows, sms, warps, want):
    """About 16 warps an SM, each CTA a run of whole rows; the CTAs cover
    every row and the last one has rows to take."""
    per_cta, ctas = rms.cta_grid(rows, sms, warps)
    assert (per_cta, ctas) == want
    assert ctas * per_cta >= rows > (ctas - 1) * per_cta


def test_rmsnorm_bwd_misaligned_dy_takes_generic():
    x = torch.zeros(4, 512)
    dy = torch.zeros(4 * 512 + 1)[1:].view(4, 512)
    assert dy.data_ptr() % 16
    assert rms_bwd_body(x, torch.zeros(512), dy) == ("generic", 0)
    with pytest.raises(ValueError, match="does not match"):
        rms_bwd_body(x, torch.zeros(512), torch.zeros(4, 512, dtype=BF16))


@pytest.mark.parametrize("rows,sms,want", [
    (4096, 132, (4, 256)),      # the 100m step on an H100
    (4096, 16, (32, 32)),
    (7, 132, (1, 2)),
    (1, 132, (1, 1)),
    (100000, 132, (95, 264)),
])
def test_rmsnorm_bwd_grid_from_the_sm_count(rows, sms, want):
    """About 8 warps an SM, each a run of whole rows, 4 warps a CTA; the
    warps cover every row and the last CTA has rows to take."""
    per_warp, ctas = rms.bwd_grid(rows, sms)
    assert (per_warp, ctas) == want
    assert ctas * 4 * per_warp >= rows > (ctas - 1) * 4 * per_warp


def test_rmsnorm_bwd_counts_start_at_zero_by_body():
    rms.reset_counts()
    assert rms.rmsnorm_bwd_cuda.launches == 0
    assert rms.rmsnorm_bwd_cuda.launches_by_body == {"warp_rows": 0,
                                                     "cta_rows": 0,
                                                     "generic": 0}


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


# ---------------------------------------------------------------------------
# SSD scan
# ---------------------------------------------------------------------------

def ssd_args(B=2, S=512, H=24, P=64, G=1, N=128, dtype=BF16):
    return (torch.zeros(B, S, H, P, dtype=dtype), torch.zeros(B, S, H),
            torch.zeros(H), torch.zeros(B, S, G, N, dtype=dtype),
            torch.zeros(B, S, G, N, dtype=dtype), torch.zeros(H))


@pytest.mark.parametrize("S,chunk", [(512, 128), (1000, 128), (37, 16),
                                     (256, 64), (1, 128), (0, 128)])
def test_ssd_bf16_takes_mma_fp32_takes_fma(S, chunk):
    """bf16 takes the mma body and float32 the TF32 tensor cores' body
    (mma_tf32x3, in place of the fma body, which stays forceable)."""
    assert ssd_body(*ssd_args(S=S), chunk=chunk) == "mma"
    assert ssd_body(*ssd_args(S=S, dtype=F32), chunk=chunk) == "mma_tf32x3"


@pytest.mark.parametrize("B,S,H,P,G,N,chunk", [
    (8, 1024, 24, 64, 1, 128, 128),   # mamba2-130m's train step
    (2, 256, 24, 64, 1, 128, 128),    # its train_check
    (2, 1000, 24, 64, 1, 128, 128),   # a ragged last chunk
    (2, 256, 8, 64, 2, 128, 64),
    (1, 90, 3, 24, 3, 8, 20),
    (1, 64, 2, 128, 1, 128, 128),     # the largest blocks: P, N, chunk 128
    (1, 37, 2, 8, 1, 8, 16),
])
def test_ssd_fp32_takes_mma_tf32x3_at_every_shape(B, S, H, P, G, N, chunk):
    """Its blocks fit every shape the fma body takes (P and N up to 128,
    chunk 16-128), so no float32 shape is left to fma by shape."""
    args = ssd_args(B=B, S=S, H=H, P=P, G=G, N=N, dtype=F32)
    assert ssd_body(*args, chunk=chunk) == "mma_tf32x3"
    assert ssd.bodies_for(*args, chunk=chunk) == ("mma_tf32x3", "fma")


@pytest.mark.parametrize("dtype,want", [(BF16, ("mma", "fma")),
                                        (F32, ("mma_tf32x3", "fma"))])
def test_ssd_fma_stays_a_body_of_both_dtypes(dtype, want):
    """``body="fma"`` stays valid for bf16 (``phase_ssd_bodies`` forces it
    as the mma body's reference) and for float32 (the previous body)."""
    assert ssd.BODIES == ("mma", "mma_tf32x3", "fma")
    assert ssd.bodies_for(*ssd_args(dtype=dtype)) == want


@pytest.mark.parametrize("P,N,G", [(8, 8, 1), (24, 16, 3), (128, 128, 2),
                                   (64, 128, 24)])
def test_ssd_mma_takes_every_head_and_state_dim(P, N, G):
    assert ssd_body(*ssd_args(H=24, P=P, G=G, N=N)) == "mma"


@pytest.mark.parametrize("make,exc,match", [
    (lambda: ssd_args(dtype=torch.float16), TypeError, "float32/bfloat16"),
    (lambda: (*ssd_args()[:3], ssd_args(dtype=F32)[3], *ssd_args()[4:]),
     TypeError, "one dtype"),
    (lambda: ssd_args(H=24, G=5), ValueError, "divide"),
    (lambda: ssd_args(P=136), ValueError, "P=136"),
    (lambda: ssd_args(N=12), ValueError, "N=12"),
    (lambda: (ssd_args()[0][0], *ssd_args()[1:]), ValueError, "expected"),
    (lambda: (*ssd_args()[:2], torch.zeros(5), *ssd_args()[3:]), ValueError,
     "agree"),
    (lambda: (ssd_args()[0].transpose(2, 3).contiguous().transpose(2, 3),
              *ssd_args()[1:]), ValueError, "contiguous"),
    (lambda: ssd_args(B=65536, S=0), ValueError, "65535"),
])
def test_ssd_select_raises_on_what_no_body_takes(make, exc, match):
    with pytest.raises(exc, match=match):
        ssd_body(*make())


@pytest.mark.parametrize("chunk", [8])
def test_ssd_select_raises_on_a_chunk_outside_16_128(chunk):
    """A chunk below 16 is refused; past 128 is taken, at a tile of 128
    (``test_ssd_select_takes_a_chunk_past_128_at_a_tile_of_128``)."""
    with pytest.raises(ValueError, match="chunk"):
        ssd_body(*ssd_args(), chunk=chunk)


@pytest.mark.parametrize("chunk,tile", [(256, 128), (129, 128), (512, 128),
                                        (128, 128), (16, 16)])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_ssd_select_takes_a_chunk_past_128_at_a_tile_of_128(chunk, tile,
                                                            dtype):
    """Every chunk from 16 is taken by the body its dtype picks, forward and
    backward, and runs at the tile ``ssd_tile`` gives (the chunk up to 128);
    the twins' costs and workspaces charge that tile."""
    args = ssd_args(dtype=dtype, P=128, N=128, H=12)
    dy = torch.zeros_like(args[0])
    assert ssd_body(*args, chunk=chunk) == ("mma" if dtype == BF16
                                           else "mma_tf32x3")
    assert ssd.select_bwd_body(*args, dy, chunk) == "mma"
    assert ssd.ssd_tile(chunk) == tile
    shape = (2, 512, 12, 128, 1, 128)
    assert ssd.ssd_cost(*shape, chunk, dtype) == ssd.ssd_cost(*shape, tile,
                                                               dtype)
    assert ssd.ssd_bwd_cost(*shape, chunk, dtype) == ssd.ssd_bwd_cost(
        *shape, tile, dtype)


def test_ssd_counts_start_at_zero_by_body():
    ssd.ssd_cuda.launches = 5
    ssd.ssd_bwd_cuda.launches = 2
    ssd.reset_counts()
    assert ssd.ssd_cuda.launches == 0
    assert ssd.ssd_cuda.launches_by_body == {"mma": 0, "mma_tf32x3": 0,
                                             "fma": 0}
    assert ssd.ssd_bwd_cuda.launches == 0
    assert ssd.ssd_bwd_cuda.launches_by_body == {"mma": 0, "fma": 0}


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("S,P,N,chunk", [
    (1024, 64, 128, 128), (1000, 64, 128, 128), (37, 16, 16, 16),
    (200, 128, 128, 64)])
def test_ssd_bwd_takes_both_dtypes(dtype, S, P, N, chunk):
    args = ssd_args(S=S, P=P, N=N, dtype=dtype)
    assert ssd.check_bwd_inputs(*args, torch.zeros_like(args[0]), chunk,
                                torch.zeros(2, 24, P, N)) is None


def test_ssd_bwd_block_fits_227_kb_at_mamba2s_shape():
    """mamba2-130m's chunk 128, head dim 64 and state 128 fit; head dim 128
    at state 128 and chunk 128 does not."""
    assert ssd.bwd_smem_bytes(128, 64, 128) == 209920
    assert ssd.bwd_smem_bytes(128, 128, 128) > ssd.BWD_MAX_SMEM_BYTES


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("B,S,H,P,G,N,chunk,d_state", [
    (8, 1024, 24, 64, 1, 128, 128, False),   # mamba2-130m's train step
    (2, 1000, 24, 64, 1, 128, 128, True),    # the chip_smoke.py cases
    (2, 200, 4, 16, 2, 16, 64, True),
    (2, 37, 4, 8, 1, 8, 16, False),
    (8, 1024, 12, 128, 1, 128, 128, False),  # mamba2-130m at head dim 128
    (2, 1000, 12, 128, 1, 128, 256, True),   # and its chunk of 256
])
def test_ssd_bwd_takes_mma_where_its_tiles_fit(dtype, B, S, H, P, G, N,
                                              chunk, d_state):
    args = ssd_args(B=B, S=S, H=H, P=P, G=G, N=N, dtype=dtype)
    ds = torch.zeros(B, H, P, N) if d_state else None
    assert ssd.select_bwd_body(*args, torch.zeros_like(args[0]), chunk,
                               ds) == "mma"


@pytest.mark.parametrize("P,N,chunk", [(72, 128, 128), (128, 128, 64),
                                       (128, 64, 128), (96, 16, 32)])
def test_ssd_bwd_takes_fma_where_the_mma_tiles_do_not_fit(P, N, chunk):
    """Head dims past 64, which took the fma body before the mma body cut
    P into slabs of 64 columns, take the mma body; the fma body stays
    forcible there, its block fitting."""
    args = ssd_args(S=256, P=P, N=N, dtype=F32)
    dy = torch.zeros_like(args[0])
    assert ssd.bwd_smem_bytes(chunk, P, N) <= ssd.BWD_MAX_SMEM_BYTES
    assert ssd.select_bwd_body(*args, dy, chunk) == "mma"
    assert ssd.bwd_bodies_for(*args, dy, chunk) == ("mma", "fma")


@pytest.mark.parametrize("P,N,chunk", [(128, 128, 128), (128, 128, 256),
                                       (120, 128, 128)])
def test_ssd_bwd_fma_is_not_forcible_where_its_block_does_not_fit(P, N,
                                                                  chunk):
    """Where the fma body's block passes 227 KB (P 128 with N 128 at a tile
    of 128: 269 KB) only the mma body takes the shape."""
    args = ssd_args(S=256, P=P, N=N, H=12, dtype=F32)
    dy = torch.zeros_like(args[0])
    assert ssd.bwd_smem_bytes(ssd.ssd_tile(chunk), P, N) > \
        ssd.BWD_MAX_SMEM_BYTES
    assert ssd.bwd_bodies_for(*args, dy, chunk) == ("mma",)


@pytest.mark.parametrize("chunk", [16, 64, 128, 256])
def test_ssd_bwd_check_takes_every_head_and_state_dim(chunk):
    """The backward takes every shape the forward takes: P and N every
    multiple of 8 up to 128 at chunks 16, 64, 128 and 256, each on the mma
    body (P past 64 in slabs of 64 columns: ``bwd_slabs``)."""
    for P in range(8, 129, 8):
        for N in range(8, 129, 8):
            args = ssd_args(B=1, S=32, H=2, P=P, N=N, dtype=F32)
            dy = torch.zeros_like(args[0])
            assert ssd.check_bwd_inputs(*args, dy, chunk,
                                        torch.zeros(1, 2, P, N)) is None
            assert ssd.select_bwd_body(*args, dy, chunk) == "mma"
        assert ssd.bwd_slabs(P) == (1 if P <= 64 else 2)


@pytest.mark.parametrize("make,match", [
    (lambda a: (*a, torch.zeros_like(a[0], dtype=F32), 64, None), "dy"),
    (lambda a: (*a, torch.zeros_like(a[0]), 64, torch.zeros(2, 24, 128)),
     "d_state"),
])
def test_ssd_bwd_check_raises_on_what_it_does_not_take(make, match):
    args = ssd_args(P=128, N=128)
    with pytest.raises(ValueError, match=match):
        ssd.check_bwd_inputs(*make(args))
    with pytest.raises(ValueError, match="B, S, H >= 1"):
        a = ssd_args(S=0)
        ssd.check_bwd_inputs(*a, torch.zeros_like(a[0]))


# ---------------------------------------------------------------------------
# RG-LRU scan
# ---------------------------------------------------------------------------

def lru_args(B=4, S=512, W=4096, dtype=F32, h0=True):
    return (torch.zeros(B, S, W, dtype=dtype),
            torch.zeros(B, S, W, dtype=dtype),
            torch.zeros(B, W) if h0 else None)


@pytest.mark.parametrize("S,want", [(64, "segmented"), (512, "segmented"),
                                    (2176, "segmented"), (1000, "segmented"),
                                    (63, "serial"), (37, "serial"),
                                    (1, "serial"), (0, "serial")])
@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("h0", [False, True])
def test_rglru_prefill_takes_segmented_decode_takes_serial(S, want, dtype, h0):
    assert rglru_body(*lru_args(S=S, W=200, dtype=dtype, h0=h0)) == want


@pytest.mark.parametrize("make,exc,match", [
    (lambda: lru_args(dtype=torch.float16), TypeError, "float32/bfloat16"),
    (lambda: (lru_args()[0], lru_args(dtype=BF16)[1], None), TypeError,
     "one dtype"),
    (lambda: (*lru_args(W=8)[:2], torch.zeros(4, 8, dtype=BF16)), ValueError,
     "h0"),
    (lambda: (*lru_args(W=8)[:2], torch.zeros(4, 9)), ValueError, "h0"),
    (lambda: (lru_args(W=8)[0], lru_args(S=4, W=8)[1], None), ValueError,
     "one shape"),
    (lambda: (lru_args(W=8)[0].transpose(1, 2), lru_args(W=8)[1]
              .transpose(1, 2), None), ValueError, "contiguous"),
    (lambda: lru_args(B=65536, S=1, W=1), ValueError, "65535"),
])
def test_rglru_select_raises_on_what_no_body_takes(make, exc, match):
    with pytest.raises(exc, match=match):
        rglru_body(*make())


@pytest.mark.parametrize("S,want", [(64, "segmented"), (512, "segmented"),
                                    (513, "segmented"), (1000, "segmented"),
                                    (63, "serial"), (37, "serial"),
                                    (1, "serial")])
@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("h0", [False, True])
def test_rglru_bwd_body_follows_the_forward(S, want, dtype, h0):
    """The backward takes the body the forward took: segmented from 64
    steps (one window up to 512, more past it), serial below."""
    args = lru_args(S=S, W=200, dtype=dtype, h0=h0)
    assert rglru.select_bwd_body(*args) == rglru_body(*args) == want
    assert want in rglru.BWD_BODIES


@pytest.mark.parametrize("make,exc,match", [
    (lambda: lru_args(dtype=torch.float16), TypeError, "float32/bfloat16"),
    (lambda: (*lru_args(W=8)[:2], torch.zeros(4, 9)), ValueError, "h0"),
    (lambda: (lru_args(W=8)[0].transpose(1, 2), lru_args(W=8)[1]
              .transpose(1, 2), None), ValueError, "contiguous"),
])
def test_rglru_bwd_select_raises_on_what_no_body_takes(make, exc, match):
    with pytest.raises(exc, match=match):
        rglru.select_bwd_body(*make())


def test_rglru_counts_start_at_zero_by_body():
    rglru.rglru_cuda.launches = 3
    rglru.rglru_bwd_cuda.launches = 4
    rglru.reset_counts()
    assert rglru.rglru_cuda.launches == 0
    assert rglru.rglru_cuda.launches_by_body == {"segmented": 0, "serial": 0}
    assert rglru.rglru_bwd_cuda.launches == 0
    assert rglru.rglru_bwd_cuda.launches_by_body == {"segmented": 0,
                                                      "serial": 0}


# ---------------------------------------------------------------------------
# the gradient guard and the backward's body
# ---------------------------------------------------------------------------

def _grad_inputs():
    """CPU inputs of each raw wrapper, the first one requiring grad."""
    x = torch.zeros(2, 8, 64, requires_grad=True)
    q = torch.zeros(1, 16, 2, 64, requires_grad=True)
    kv = torch.zeros(1, 16, 1, 64)
    xs = torch.zeros(1, 16, 2, 8, requires_grad=True)
    dt = torch.zeros(1, 16, 2)
    bm = torch.zeros(1, 16, 1, 8)
    la = torch.zeros(1, 16, 32, requires_grad=True)
    return [
        (rmsnorm_cuda, (x, torch.ones(64)), {}),
        (flash_attention_cuda, (q, kv, kv), {}),
        (ssd.ssd_cuda, (xs, dt, torch.zeros(2), bm, bm, torch.zeros(2)),
         dict(chunk=16)),
        (rglru.rglru_cuda, (la, torch.zeros(1, 16, 32)), {}),
    ]


@pytest.mark.parametrize("case", range(4),
                         ids=["rmsnorm", "flash", "ssd", "rglru"])
def test_raw_wrappers_refuse_inputs_that_require_grad(case):
    """Outside their autograd.Function a raw wrapper would drop the
    gradient: with grad mode on it raises, before it looks at the device;
    under no_grad the device check speaks instead (no card here)."""
    fn, args, kw = _grad_inputs()[case]
    with pytest.raises(RuntimeError, match="no gradient of its own"):
        fn(*args, **kw)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA tensors"):
        fn(*args, **kw)


def test_scan_wrappers_name_the_roadmap_item():
    for fn, args, kw in _grad_inputs()[2:]:
        with pytest.raises(RuntimeError, match="Queue 1 item 7"):
            fn(*args, **kw)


@pytest.mark.parametrize("dh", flash.BWD_HEAD_DIMS)
@pytest.mark.parametrize("dtype,want", [(F32, "mma_tf32x3"),
                                       (BF16, "mma_bf16")])
def test_flash_bwd_body_by_dtype(dh, dtype, want):
    """Every head dim of the registry, both dtypes; bf16 at the sm90 head
    dims as views whose strides TMA cannot read, which the forward sends to
    its mma body (aligned ones take sm90, below).  The backward's choice
    does not look at strides (its wrapper makes every operand contiguous):
    bf16 at dh 80, 120, 128, 160 and 256 takes its sm90 body from any
    view."""
    args = (fused(4, 2, dh, extra=1) if dtype == BF16
            and dh in flash.SM90_HEAD_DIMS else qkv(dh=dh, dtype=dtype))
    assert flash_body(*args) in ("mma", "mma_tf32x3", "fp32")
    if dtype == BF16 and dh in flash.SM90_BWD_HEAD_DIMS:
        want = "sm90"
    assert flash.select_bwd_body(*args) == want


@pytest.mark.parametrize("B,S,H,K,dh,sms,want", [
    (4, 512, 16, 1, 256, 132, 16),   # recurrentgemma-9b's step: 64 CTAs
    (16, 256, 8, 4, 64, 132, 1),     # the 100m step: 256 CTAs
    (2, 256, 28, 4, 128, 132, 1),    # qwen2-7b's check: 4 x 4 x 1 x 2
    (2, 256, 16, 1, 256, 132, 16),   # 8 x 2 = 16 CTAs: all 16 heads
    (1, 65, 16, 2, 80, 132, 1),      # dh 80: no split below dh 120
    (1, 65, 16, 2, 120, 132, 8),     # the whole group of 8
    (1, 300, 32, 32, 128, 132, 1),   # MHA: nothing to split
    (4, 512, 16, 1, 256, 16, 2),     # a card of 16 SMs: 128 CTAs fill it
    (4, 512, 32, 8, 160, 132, 4),    # stablelm-12b: 256 CTAs, 2 an SM
    (2, 200, 6, 1, 160, 132, 2),     # a group of 6 halves, no further
])
def test_flash_bwd_head_split_fills_the_card(B, S, H, K, dh, sms, want):
    """The dK/dV launch splits a KV head's query heads over CTAs only above
    head dim 80, doubling while the split divides the group, up to
    ``BWD_FILL`` CTAs an SM."""
    split = flash.bwd_head_split(B, S, H, K, dh, sms)
    assert split == want and (H // K) % split == 0


@pytest.mark.parametrize("B,S,H,K,dh,sms,want", [
    (4, 1024, 12, 2, 128, 132, 2),   # qwen2-vl-2b's step: 128 CTAs -> 256
    (4, 512, 32, 8, 120, 132, 1),    # h2o-danube-3-4b's heads: 256 CTAs
    (1, 300, 12, 2, 128, 132, 6),    # 5 x 2 x 1: the whole group of 6
    (2, 512, 12, 2, 128, 132, 6),    # 8 x 2 x 2 = 32 CTAs: 6 give 192
    (4, 1024, 12, 2, 128, 16, 1),    # a card of 16 SMs: 128 CTAs fill it
    (1, 512, 28, 4, 128, 132, 7),    # qwen2-7b's group of 7: 7 or nothing
    # above dh 128 the column halves double the CTAs: recurrentgemma-9b's
    # train_4k step, 64 key tiles x 1 KV head x 2 halves = 128 CTAs, split
    # 2 (256); its batch 4 x 512, 8 x 4 x 2 = 64, split 4; stablelm-12b's
    # train_4k step, 64 x 8 x 2 = 1024, and at 4 x 512, 512: none
    (1, 4096, 16, 1, 256, 132, 2),
    (4, 512, 16, 1, 256, 132, 4),
    (1, 4096, 32, 8, 160, 132, 1),
    (4, 512, 32, 8, 160, 132, 1),
])
def test_flash_bwd_sm90_head_split_takes_any_divisor(B, S, H, K, dh, sms,
                                                     want):
    """The sm90 body's dK/dV launch (64 keys a CTA, one CTA a column half
    of dK and dV above dh 128) splits a KV head's query heads by the
    smallest divisor of the group, any divisor, that reaches
    ``SM90_BWD_FILL`` CTAs an SM, else by the whole group; the pair kernels
    keep their doubling rule (above)."""
    split = flash.bwd_head_split(B, S, H, K, dh, sms, "sm90")
    assert split == want and (H // K) % split == 0
    ctas = -(-S // flash.SM90_BWD_KV_TILE) * K * B * flash.sm90_bwd_halves(dh)
    assert ctas * split >= flash.SM90_BWD_FILL * sms or split == H // K
    assert all(ctas * d < flash.SM90_BWD_FILL * sms
               for d in range(1, split) if (H // K) % d == 0)


@pytest.mark.parametrize("B,S,H,K,dh,want,ctas", [
    (1, 1000, 28, 4, 80, 7, 448),      # GQA 7:1: 16 x 4 = 64 CTAs, split 7
    (4, 1024, 32, 32, 80, 1, 2048),    # stablelm-3b's step: 16 x 32 x 4
])
def test_flash_bwd_sm90_takes_its_own_head_split_at_dh_80(B, S, H, K, dh,
                                                          want, ctas):
    """At dh 80 the sm90 body's dK/dV launch takes the split that
    ``bwd_head_split`` gives it on 132 SMs (the default call's), which the
    mma bodies' 4-warp kernels at that head dim refuse."""
    split = flash.bwd_head_split(B, S, H, K, dh, 132, "sm90")
    assert split == want
    assert -(-S // flash.SM90_BWD_KV_TILE) * K * split * B == ctas
    flash.check_head_split(H, K, dh, split, "sm90")
    if split > 1:
        for body in ("mma_bf16", "mma_tf32x3"):
            with pytest.raises(ValueError, match="no split"):
                flash.check_head_split(H, K, dh, split, body)


@pytest.mark.parametrize("H,K,dh,split,body,refusal", [
    (28, 4, 80, 7, "sm90", None),
    (28, 4, 80, 7, "mma_bf16", "no split"),
    (28, 4, 80, 7, "mma_tf32x3", "no split"),
    (8, 2, 64, 2, "mma_bf16", "no split"),
    (28, 4, 80, 1, "mma_bf16", None),
    (12, 2, 128, 6, "sm90", None),
    (12, 2, 120, 3, "mma_bf16", None),
    (16, 1, 256, 16, "mma_tf32x3", None),
    (28, 4, 80, 3, "sm90", "does not divide"),
    (12, 2, 128, 4, "mma_bf16", "does not divide"),
    (28, 4, 80, 0, "sm90", "does not divide"),
])
def test_flash_bwd_head_split_validation(H, K, dh, split, body, refusal):
    """``check_head_split``, which the backward wrapper applies before a
    launch: a divisor of the group on every body; on the mma bodies, 1 at
    head dims up to 80; the sm90 body splits at each of its head dims."""
    if refusal is None:
        flash.check_head_split(H, K, dh, split, body)
    else:
        with pytest.raises(ValueError, match=refusal):
            flash.check_head_split(H, K, dh, split, body)


def test_flash_bwd_kv_slices_are_the_kernels():
    """The dK/dV launch's slices as csrc/flash_attention.cu cuts them:
    of the keys only on the mma bodies (BwdCfg up to dh 80,
    BwdPairCfg::kKvRows above), every CTA accumulating every column of dK
    and dV, so that each full-width product is formed once a pair of tiles
    (7); 64 keys in the sm90 body, and above dh 128 a column half of dK
    and dV a CTA (``Sm90Bwd::kHalves``), each CTA forming S and dP
    whole."""
    assert set(flash.BWD_KV_TILE) == set(flash.HEAD_DIMS)
    assert all(t in (32, 64) for t in flash.BWD_KV_TILE.values())
    assert flash.SM90_BWD_KV_TILE == 64
    assert [flash.sm90_bwd_halves(dh) for dh in flash.SM90_BWD_HEAD_DIMS] \
        == [1, 1, 1, 2, 2]


@pytest.mark.parametrize("dh,want", [(16, 64), (32, 64), (64, 64), (80, 64),
                                     (120, 64), (128, 64), (160, 64),
                                     (256, 32)])
def test_flash_bwd_kv_tile_by_head_dim(dh, want):
    """64 keys a dK/dV CTA, 32 at dh 256, where 4 warps share each
    16-key group to hold all 256 columns of dK and dV."""
    assert flash.BWD_KV_TILE[dh] == want


@pytest.mark.parametrize("B,S,H,K,dh,want_ctas", [
    (4, 512, 16, 1, 256, 1024),    # recurrentgemma-9b's step: 16 x 16 x 4
    (4, 512, 32, 8, 160, 1024),    # stablelm-12b's heads: 8 x 8 x 4 x 4
    (2, 256, 28, 4, 128, 32),      # qwen2-7b's check: a group of 7, no split
])
def test_flash_bwd_dkdv_grid_on_the_pair_kernels(B, S, H, K, dh, want_ctas):
    """The dK/dV launch's CTAs on the pair kernels' grid: key tiles x KV
    heads x head splits x batch, on a card of 132 SMs."""
    split = flash.bwd_head_split(B, S, H, K, dh, 132)
    assert -(-S // flash.BWD_KV_TILE[dh]) * K * split * B == want_ctas


def test_flash_bwd_takes_the_mma_forward_to_sm90():
    """bf16 at dh 160: aligned (stablelm-12b's bf16 train step), the mma
    body (the forward this step ran before the sm90 body took dh 160)
    still takes the inputs when forced, as the previous body; a view whose
    strides TMA cannot read takes the mma forward, which writes the
    log-sum-exp, and the sm90 backward, column halves of each sum, with
    mma_bf16 (the pair kernels) forcible beside it."""
    assert flash.bodies_for(*qkv(dh=160)) == ("sm90", "mma")
    q, k, v = fused(32, 8, 160, extra=1)
    assert q.stride(1) % 8
    assert flash.select_body(q, k, v) == "mma"
    assert flash.bodies_for(q, k, v) == ("mma",)
    assert flash.select_bwd_body(q, k, v) == "sm90"
    assert flash.bwd_bodies_for(q, k, v) == ("sm90", "mma_bf16")


@pytest.mark.parametrize("dh", [80, 120, 128, 160, 256])
def test_flash_bwd_takes_the_sm90_forward_to_sm90(dh):
    """bf16 at dh 80, 120, 128, 160 and 256, aligned (stablelm-3b's,
    qwen2-vl-2b's, stablelm-12b's and recurrentgemma-9b's bf16 train steps,
    hubert-xlarge's and h2o-danube-3-4b's heads): both
    ways on sm90, the backward's wgmma and TMA body, with the mma_bf16
    kernels (4 warps a CTA at 80, the pair kernels above) still forcible as
    its previous body."""
    q, k, v = qkv(dh=dh)
    assert flash.select_body(q, k, v) == "sm90"
    assert flash.select_bwd_body(q, k, v) == "sm90"
    assert flash.bwd_bodies_for(q, k, v) == ("sm90", "mma_bf16")


@pytest.mark.parametrize("dh", flash.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("scale", [None, 0.1, 0.0, -0.1])
def test_flash_bwd_sm90_only_bf16_at_120_128_scale_above_0(dh, dtype, scale):
    """sm90 takes bf16 at dh 80, 120, 128, 160 and 256 with a scale > 0
    (its softmax exponent folds the scale, as the sm90 forward's does);
    bf16 at every other head dim (16, 32, 64) or scale keeps mma_bf16,
    float32 mma_tf32x3."""
    takes = flash.bwd_bodies_for(*qkv(dh=dh, dtype=dtype), scale)
    if dtype == F32:
        assert takes == ("mma_tf32x3",)
    elif dh in (80, 120, 128, 160, 256) and (scale is None or scale > 0):
        assert takes == ("sm90", "mma_bf16")
    else:
        assert takes == ("mma_bf16",)


@pytest.mark.parametrize("dh,dtype,body,scale", [
    (128, F32, "sm90", None),
    (128, F32, "mma_bf16", None),
    (64, BF16, "sm90", None),
    (80, F32, "sm90", None),
    (80, BF16, "sm90", 0.0),
    (256, BF16, "sm90", 0.0),
    (128, BF16, "mma_tf32x3", None),
    (128, BF16, "sm90", -0.1),
    (120, BF16, "sliced", None),
])
def test_flash_bwd_forcing_a_body_that_does_not_take_raises(dh, dtype, body,
                                                            scale):
    """``body=`` names one of ``bwd_bodies_for`` the inputs, or the
    wrapper raises before it looks at the device."""
    q, k, v = qkv(dh=dh, dtype=dtype)
    lse = torch.zeros(q.shape[0], q.shape[2], q.shape[1])
    with pytest.raises(ValueError, match="does not take"):
        flash.flash_attention_bwd_cuda(q, k, v, q, q, lse, scale=scale,
                                       body=body)


@pytest.mark.parametrize("body", ["sm90", "mma_bf16", None])
def test_flash_bwd_forced_bodies_reach_the_device_check(body):
    """bf16 at dh 128 takes either bf16 body when forced (the pair kernels
    stay reachable as the previous body); without a card the device check
    then speaks."""
    q, k, v = qkv(dh=128)
    lse = torch.zeros(q.shape[0], q.shape[2], q.shape[1])
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash.flash_attention_bwd_cuda(q, k, v, q, q, lse, body=body)


def test_flash_bwd_counts_by_body_start_at_zero():
    """``reset_counts`` zeroes the backward's count of every body, sm90's
    among them, in ``BWD_BODIES``' order, and empties its count by body and
    head dim (``chip_smoke.py`` tells the sm90 body's dh-80 launches from
    its dh-128 ones by it)."""
    flash.reset_counts()
    assert flash.BWD_BODIES == ("mma_tf32x3", "mma_bf16", "sm90")
    assert flash.flash_attention_bwd_cuda.launches == 0
    assert flash.flash_attention_bwd_cuda.launches_by_body == {
        "mma_tf32x3": 0, "mma_bf16": 0, "sm90": 0}
    assert flash.flash_attention_bwd_cuda.launches_by_head_dim == {
        "mma_tf32x3": {}, "mma_bf16": {}, "sm90": {}}


@pytest.mark.parametrize("dh", [48, 96, 192, 512])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_flash_bwd_refuses_head_dims_no_forward_takes(dh, dtype):
    with pytest.raises(ValueError, match="head_dim"):
        flash.select_bwd_body(*qkv(dh=dh, dtype=dtype))


def test_flash_bwd_body_raises_on_what_no_forward_body_takes():
    q, k, v = qkv(dh=64, dtype=F32)
    with pytest.raises(ValueError, match="multiple of kv heads"):
        flash.select_bwd_body(q, torch.zeros(2, 64, 3, 64),
                              torch.zeros(2, 64, 3, 64))


def test_cpu_ops_differentiate_the_plain_versions():
    """On the CPU the dispatch wrappers take the plain versions, which
    autograd differentiates."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention.ref import mha_ref
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 64, generator=g, requires_grad=True)
    s = torch.randn(64, generator=g)
    ops.rmsnorm(x, s).sum().backward()
    x2 = x.detach().clone().requires_grad_()
    rmsnorm_ref(x2, s).sum().backward()
    assert torch.equal(x.grad, x2.grad)
    q = torch.randn(1, 8, 2, 16, generator=g, requires_grad=True)
    k = torch.randn(1, 8, 1, 16, generator=g)
    ops.flash_attention(q, k, k).sum().backward()
    q2 = q.detach().clone().requires_grad_()
    mha_ref(q2, k, k).sum().backward()
    assert torch.equal(q.grad, q2.grad)


def test_backward_wrappers_refuse_cpu_tensors():
    args = ssd_args(S=16, H=2, P=8, N=8, dtype=F32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ssd.ssd_bwd_cuda(*args, torch.zeros_like(args[0]), chunk=16)
    la = torch.zeros(1, 16, 32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        rglru.rglru_bwd_cuda(la, la, la)


def test_cpu_ops_differentiate_the_plain_scans():
    """On the CPU the scans' dispatch takes the plain versions, which
    autograd differentiates (their Functions are for the card)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.rglru.ref import rglru_sequential
    from repro_torch.kernels.ssd.ref import ssd_chunked
    g = torch.Generator().manual_seed(0)
    la = -torch.rand(2, 8, 16, generator=g)
    gx = torch.randn(2, 8, 16, generator=g, requires_grad=True)
    ops.rglru_scan(la, gx)[0].sum().backward()
    gx2 = gx.detach().clone().requires_grad_()
    rglru_sequential(la, gx2)[0].sum().backward()
    assert torch.equal(gx.grad, gx2.grad)
    x = torch.randn(1, 32, 2, 8, generator=g, requires_grad=True)
    dt, A = torch.rand(1, 32, 2, generator=g), -torch.rand(2, generator=g)
    bm = torch.randn(1, 32, 1, 8, generator=g)
    ops.ssd_scan(x, dt, A, bm, bm, torch.ones(2), chunk=16)[0].sum().backward()
    x2 = x.detach().clone().requires_grad_()
    ssd_chunked(x2, dt, A, bm, bm, torch.ones(2), chunk=16)[0].sum().backward()
    assert torch.equal(x.grad, x2.grad)


def test_cpu_ops_run_the_plain_versions_in_fp32(monkeypatch):
    """On the CPU, fp32 attention and SSD calls go to ``mha_ref`` and
    ``ssd_chunked`` (``ssd_sequential`` at a ragged S) and never reach a
    kernel wrapper, whatever body the card would take."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention.ref import mha_ref
    from repro_torch.kernels.ssd.ref import ssd_chunked, ssd_sequential

    def refuse(*a, **k):
        raise AssertionError("a kernel wrapper was called on the CPU")

    for name in ("flash_attention_cuda", "ssd_cuda"):
        monkeypatch.setattr(ops, name, refuse)
    monkeypatch.setattr(ops.FlashAttentionFunction, "apply", refuse)
    monkeypatch.setattr(ops.SSDFunction, "apply", refuse)
    g = torch.Generator().manual_seed(1)
    q = torch.randn(2, 70, 8, 64, generator=g)
    k, v = (torch.randn(2, 70, 4, 64, generator=g) for _ in range(2))
    assert flash_body(q, k, v) == "mma_tf32x3"
    assert torch.equal(ops.flash_attention(q, k, v), mha_ref(q, k, v))
    for S in (64, 50):
        x = torch.randn(1, S, 2, 8, generator=g)
        dt, A = torch.rand(1, S, 2, generator=g), -torch.rand(2, generator=g)
        bm = torch.randn(1, S, 1, 8, generator=g)
        args = (x, dt, A, bm, bm, torch.ones(2))
        assert ssd_body(*args, chunk=16) == "mma_tf32x3"
        want = ssd_chunked(*args, chunk=16) if S % 16 == 0 \
            else ssd_sequential(*args)
        for got, w in zip(ops.ssd_scan(*args, chunk=16), want):
            assert torch.equal(got, w)
