"""The Mamba-2 SSD chunked scan as a CUDA kernel for Hopper.

The kernel is ``csrc/ssd.cu``; it replaces the TPU kernel ``ssd_pallas`` at
any S (the ragged last chunk is padded inside the kernel), computes
``ref.ssd_chunked``'s function and returns the fp32 state after the last
token beside y.  It is bounded by operations (fp32 products on the FMA
units).  Its plain versions are ``ref.ssd_chunked`` and
``ref.ssd_sequential``.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _entry():
    fn = _build.load("ssd").ssd_fwd
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P] * 8 + [I] * 8 + [P]
        fn.restype = ctypes.c_int
    return fn


def ssd_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, D: torch.Tensor, *,
             chunk: int = 128):
    """x (B,S,H,P), dt (B,S,H), A, D (H,), Bm/Cm (B,S,G,N) ->
    (y (B,S,H,P) in ``x.dtype``, state (B,H,P,N) fp32 after the last token).

    x, Bm and Cm contiguous, all float32 or all bfloat16; dt, A and D any
    float type (cast to float32 here).  Any S; chunk 16-128; P and N
    multiples of 8 up to 128; G dividing H.  Raises on anything else."""
    if not x.is_cuda:
        raise ValueError(f"ssd_cuda takes CUDA tensors, got {x.device}")
    if x.ndim != 4 or Bm.ndim != 4 or Cm.shape != Bm.shape:
        raise ValueError(f"expected x (B,S,H,P) and Bm, Cm (B,S,G,N) of one "
                         f"shape; got {tuple(x.shape)}, {tuple(Bm.shape)}, "
                         f"{tuple(Cm.shape)}")
    B, S, H, P = x.shape
    G, N = Bm.shape[2:]
    if Bm.shape[:2] != (B, S) or dt.shape != (B, S, H) \
            or A.shape != (H,) or D.shape != (H,):
        raise ValueError(f"shapes do not agree: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, Bm "
                         f"{tuple(Bm.shape)}, D {tuple(D.shape)}")
    if x.dtype not in _DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError(f"ssd_cuda takes x, Bm, Cm as float32/bfloat16 of one "
                        f"dtype, got {x.dtype}, {Bm.dtype}, {Cm.dtype}")
    if not all(t.is_floating_point() for t in (dt, A, D)):
        raise TypeError("dt, A and D must be floating point")
    if G < 1 or H % G:
        raise ValueError(f"groups G={G} must divide heads H={H}")
    for name, n in (("P", P), ("N", N)):
        if n % 8 or not 8 <= n <= 128:
            raise ValueError(f"{name}={n} must be a multiple of 8 up to 128")
    if not 16 <= chunk <= 128:
        raise ValueError(f"chunk {chunk} must lie in 16-128")
    for t in (x, dt, A, Bm, Cm, D):
        if t.device != x.device:
            raise ValueError("ssd_cuda operands must share one device")
    for t in (x, Bm, Cm):
        if not t.is_contiguous():
            raise ValueError("ssd_cuda takes contiguous x, Bm and Cm")
    dt, A, D = (t.to(torch.float32).contiguous() for t in (dt, A, D))
    y = torch.empty_like(x)
    state = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    if B * H == 0:
        return y, state
    fn = _entry()
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                 Cm.data_ptr(), D.data_ptr(), y.data_ptr(), state.data_ptr(),
                 B, S, H, P, G, N, chunk, _DTYPES[x.dtype],
                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"ssd kernel launch failed: CUDA error {err}")
    ssd_cuda.launches += 1
    return y, state


ssd_cuda.launches = 0
