"""Fused RMSNorm (+ optional residual add) as a CUDA kernel for Hopper.

The kernel is ``csrc/rmsnorm.cu``; it replaces the TPU kernel
``rmsnorm_pallas`` and is bounded by bytes (one read of x and the residual,
one write of y).  Its plain version is ``ref.rmsnorm_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _entry():
    fn = _build.load("rmsnorm").rmsnorm_fwd
    if fn.argtypes is None:
        P = ctypes.c_void_p
        fn.argtypes = [P, P, P, P, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_float, ctypes.c_int, ctypes.c_int, P]
        fn.restype = ctypes.c_int
    return fn


def rmsnorm_cuda(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6,
                 residual: torch.Tensor | None = None) -> torch.Tensor:
    """y = x * rsqrt(mean(x²) + eps) * scale (+ residual) on the card.

    x (..., D) fp32 or bf16, contiguous; scale (D,) fp32 or bf16; residual
    like x.  Output in ``x.dtype``.  Raises on anything else."""
    if not x.is_cuda:
        raise ValueError(f"rmsnorm_cuda takes CUDA tensors, got {x.device}")
    if x.dtype not in _DTYPES or scale.dtype not in _DTYPES:
        raise TypeError(f"rmsnorm_cuda takes float32/bfloat16, got x "
                        f"{x.dtype}, scale {scale.dtype}")
    if x.ndim < 1 or scale.shape != x.shape[-1:]:
        raise ValueError(f"scale {tuple(scale.shape)} does not match x "
                         f"{tuple(x.shape)}")
    tensors = [x, scale]
    if residual is not None:
        if residual.shape != x.shape or residual.dtype != x.dtype:
            raise ValueError("residual must match x in shape and dtype")
        tensors.append(residual)
    for t in tensors:
        if t.device != x.device:
            raise ValueError("rmsnorm_cuda operands must share one device")
        if not t.is_contiguous():
            raise ValueError("rmsnorm_cuda takes contiguous tensors")
    y = torch.empty_like(x)
    D = x.shape[-1]
    rows = x.numel() // D if D else 0
    if rows == 0:
        return y
    fn = _entry()
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), scale.data_ptr(),
                 None if residual is None else residual.data_ptr(),
                 y.data_ptr(), rows, D, eps, _DTYPES[x.dtype],
                 _DTYPES[scale.dtype], torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"rmsnorm kernel launch failed: CUDA error {err}")
    rmsnorm_cuda.launches += 1
    return y


rmsnorm_cuda.launches = 0
