"""Forward flash attention as a CUDA kernel for Hopper.

The kernel is ``csrc/flash_attention.cu``; it replaces the TPU kernel
``flash_attention_pallas`` for the self-attention layout (training and
prefill: Sq == Sk, default positions, no softcap) at any S.  Its plain
version is ``ref.mha_ref``.

Three bodies, chosen by ``select_body`` from the dtype, the head dim and the
layout of q, k and v (never by trying one and falling back):

* ``sm90``: bf16 at dh 128 or 256 (the served archs) with 16-byte aligned
  bases and batch / sequence / head strides, as TMA needs, and a softmax
  scale > 0: wgmma, TMA and warp specialisation.
* ``mma``: every other bf16 input (the registry's other head dims, unaligned
  views): mma.sync tiles.
* ``fp32``: float32, on the FMA units.

``flash_attention_cuda.launches`` counts every launch and
``flash_attention_cuda.launches_by_body`` each body's.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# every head dim of the config registry (120 is padded to 128 in the kernel)
HEAD_DIMS = (16, 32, 64, 80, 120, 128, 160, 256)
SM90_HEAD_DIMS = (128, 256)
BODIES = ("sm90", "mma", "fp32")


def _entry(name: str, with_dtype: bool):
    fn = getattr(_build.load("flash_attention"), name)
    if fn.argtypes is None:
        P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [P, P, P, P, I, I, I, I, *([LL] * 9), I, I, I,
                       ctypes.c_float, I, *([I] if with_dtype else []), P]
        fn.restype = ctypes.c_int
    return fn


def tma_strides(t: torch.Tensor) -> tuple[int, int, int]:
    """Batch, sequence and head strides of a (B, S, heads, dh) tensor, with
    the stride of a dim of size 1 (never stepped over) replaced by its packed
    value, so that only the strides the kernel walks decide the body."""
    sb, ss, sh, _ = t.stride()
    B, S, n, dh = t.shape
    return (S * n * dh if B == 1 else sb, n * dh if S == 1 else ss,
            dh if n == 1 else sh)


def _tma_ok(t: torch.Tensor) -> bool:
    """TMA reads a bf16 tensor whose base and walked strides are positive
    multiples of 16 bytes."""
    sb, ss, sh = tma_strides(t)
    return (t.data_ptr() % 16 == 0 and sb > 0 and ss > 0 and sh > 0
            and sb % 8 == 0 and ss % 8 == 0 and sh % 8 == 0)


def select_body(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                scale: float | None = None) -> str:
    """The body that takes q (B,S,H,dh), k, v (B,S,K,dh) and the softmax
    scale (None: dh ** -0.5), one of ``BODIES``.

    A pure function of dtype, shape, base address, strides and the sign of
    the scale (the sm90 body takes the row max of the raw scores, which is
    the max of the scaled ones for a scale > 0), on any device.  Raises on
    what no body takes: another dtype, a head dim outside ``HEAD_DIMS``, H
    not a multiple of K, Sq != Sk, a last dim that is not contiguous."""
    qs, ks = q.shape, k.shape
    if len(qs) != 4 or len(ks) != 4 or ks != v.shape:
        raise ValueError(f"expected q (B,S,H,dh), k/v (B,S,K,dh); got "
                         f"{tuple(qs)}, {tuple(ks)}, {tuple(v.shape)}")
    B, S, H, dh = qs
    K = ks[2]
    if ks[0] != B or ks[1] != S or ks[3] != dh:
        raise ValueError("flash_attention_cuda takes self-attention shapes "
                         f"(Sq == Sk): q {tuple(qs)}, k {tuple(ks)}")
    if K == 0 or H % K:
        raise ValueError(f"num_heads {H} is not a multiple of kv heads {K}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"head_dim {dh} not in {HEAD_DIMS}")
    dtype = q.dtype
    if dtype not in _DTYPES or k.dtype != dtype or v.dtype != dtype:
        raise TypeError(f"flash_attention_cuda takes float32/bfloat16 of one "
                        f"dtype, got {dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention_cuda operands must share one device")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flash_attention_cuda needs a contiguous last dim")
    if dtype == torch.float32:
        return "fp32"
    if (dh in SM90_HEAD_DIMS and (scale is None or scale > 0) and _tma_ok(q)
            and _tma_ok(k) and _tma_ok(v)):
        return "sm90"
    return "mma"


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: int = 0, chunk: int = 0,
                         scale: float | None = None) -> torch.Tensor:
    """q (B,S,H,dh); k, v (B,S,K,dh) -> (B,S,H,dh) in ``q.dtype``.

    fp32 or bf16; dh one of ``HEAD_DIMS``; H a multiple of K; the last dim
    of each input contiguous (the others are read through strides).  Raises
    on anything else."""
    if not q.is_cuda:
        raise ValueError(f"flash_attention_cuda takes CUDA tensors, got "
                         f"{q.device}")
    body = select_body(q, k, v, scale)
    if window < 0 or chunk < 0:
        raise ValueError("window and chunk must be >= 0")
    B, S, H, dh = q.shape
    if B > 65535 or H > 65535:
        raise ValueError("batch and heads are limited to 65535")
    out = torch.empty((B, S, H, dh), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    scale = scale if scale is not None else dh ** -0.5
    if body == "sm90":
        fn, strides, tail = _entry("flash_attention_fwd_sm90", False), \
            [s for t in (q, k, v) for s in tma_strides(t)], ()
    else:
        fn, strides, tail = _entry("flash_attention_fwd", True), \
            [s for t in (q, k, v) for s in t.stride()[:3]], (_DTYPES[q.dtype],)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, S, H, k.shape[2], *strides, int(causal), window, chunk,
                 scale, dh, *tail, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed ({body} "
                           f"body): CUDA error {err}")
    flash_attention_cuda.launches += 1
    flash_attention_cuda.launches_by_body[body] += 1
    return out


def reset_counts() -> None:
    """Set the launch counts (total and by body) to 0."""
    flash_attention_cuda.launches = 0
    flash_attention_cuda.launches_by_body = dict.fromkeys(BODIES, 0)


reset_counts()
