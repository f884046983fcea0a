"""The RG-LRU scan as a CUDA kernel for Hopper.

The kernel is ``csrc/rglru.cu``; it replaces the TPU kernel
``rglru_pallas`` at any B, S and W, decode's S = 1 included, and is bounded
by bytes (one read of ``log_a`` and ``gx``, one write of ``y``).  Its plain
version is ``ref.rglru_sequential``.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _entry():
    fn = _build.load("rglru").rglru_fwd
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, P, I, I, I, I, P]
        fn.restype = ctypes.c_int
    return fn


def rglru_cuda(log_a: torch.Tensor, gx: torch.Tensor,
               h0: torch.Tensor | None = None):
    """log_a, gx (B,S,W) -> (y (B,S,W) in ``gx.dtype``, h_last (B,W) fp32).

    ``log_a`` and ``gx`` both fp32 or both bf16, contiguous; ``h0`` (B,W)
    fp32, contiguous, or None for a zero state.  Raises on anything else."""
    if not gx.is_cuda:
        raise ValueError(f"rglru_cuda takes CUDA tensors, got {gx.device}")
    if gx.ndim != 3 or log_a.shape != gx.shape:
        raise ValueError(f"expected log_a and gx (B,S,W) of one shape; got "
                         f"{tuple(log_a.shape)}, {tuple(gx.shape)}")
    if gx.dtype not in _DTYPES or log_a.dtype != gx.dtype:
        raise TypeError(f"rglru_cuda takes float32/bfloat16 of one dtype, "
                        f"got log_a {log_a.dtype}, gx {gx.dtype}")
    B, S, W = gx.shape
    tensors = [log_a, gx]
    if h0 is not None:
        if h0.shape != (B, W) or h0.dtype != torch.float32:
            raise ValueError(f"h0 must be float32 (B, W) = ({B}, {W}); got "
                             f"{h0.dtype} {tuple(h0.shape)}")
        tensors.append(h0)
    for t in tensors:
        if t.device != gx.device:
            raise ValueError("rglru_cuda operands must share one device")
        if not t.is_contiguous():
            raise ValueError("rglru_cuda takes contiguous tensors")
    if B > 65535:
        raise ValueError("batch is limited to 65535")
    y = torch.empty((B, S, W), dtype=gx.dtype, device=gx.device)
    h_last = torch.empty((B, W), dtype=torch.float32, device=gx.device)
    if B * W == 0:
        return y, h_last
    fn = _entry()
    with torch.cuda.device(gx.device):
        err = fn(log_a.data_ptr(), gx.data_ptr(),
                 None if h0 is None else h0.data_ptr(), y.data_ptr(),
                 h_last.data_ptr(), B, S, W, _DTYPES[gx.dtype],
                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"rglru kernel launch failed: CUDA error {err}")
    rglru_cuda.launches += 1
    return y, h_last


rglru_cuda.launches = 0
