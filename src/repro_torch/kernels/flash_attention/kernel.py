"""Forward flash attention as a CUDA kernel for Hopper.

The kernel is ``csrc/flash_attention.cu``; it replaces the TPU kernel
``flash_attention_pallas`` for the self-attention layout (training and
prefill: Sq == Sk, default positions, no softcap) at any S.  Its plain
version is ``ref.mha_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# every head dim of the config registry (120 is padded to 128 in the kernel)
HEAD_DIMS = (16, 32, 64, 80, 120, 128, 160, 256)


def _entry():
    fn = _build.load("flash_attention").flash_attention_fwd
    if fn.argtypes is None:
        P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [P, P, P, P, I, I, I, I, *([LL] * 9), I, I, I,
                       ctypes.c_float, I, I, P]
        fn.restype = ctypes.c_int
    return fn


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
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"expected q (B,S,H,dh), k/v (B,S,K,dh); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, H, dh = q.shape
    K = k.shape[2]
    if k.shape[0] != B or k.shape[1] != S or k.shape[3] != dh:
        raise ValueError("flash_attention_cuda takes self-attention shapes "
                         f"(Sq == Sk): q {tuple(q.shape)}, k {tuple(k.shape)}")
    if K == 0 or H % K:
        raise ValueError(f"num_heads {H} is not a multiple of kv heads {K}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"head_dim {dh} not in {HEAD_DIMS}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention_cuda takes float32/bfloat16 of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    for t in (k, v):
        if t.device != q.device:
            raise ValueError("flash_attention_cuda operands must share one "
                             "device")
    for t in (q, k, v):
        if t.stride(3) != 1:
            raise ValueError("flash_attention_cuda needs a contiguous last dim")
    if window < 0 or chunk < 0:
        raise ValueError("window and chunk must be >= 0")
    if B > 65535 or H > 65535:
        raise ValueError("batch and heads are limited to 65535")
    out = torch.empty((B, S, H, dh), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    scale = scale if scale is not None else dh ** -0.5
    fn = _entry()
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, S, H, K, *q.stride()[:3], *k.stride()[:3],
                 *v.stride()[:3], int(causal), window, chunk, scale, dh,
                 _DTYPES[q.dtype], torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
