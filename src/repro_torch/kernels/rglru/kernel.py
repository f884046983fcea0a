"""The RG-LRU scan as a CUDA kernel for Hopper.

The kernel is ``csrc/rglru.cu``; it replaces the TPU kernel
``rglru_pallas`` at any B, S and W, decode's S = 1 included, and is bounded
by bytes (one read of ``log_a`` and ``gx``, one write of ``y``).  Its plain
versions are ``ref.rglru_sequential`` and ``ref.rglru_assoc``.

Two bodies, chosen by ``select_body`` from S (never by trying one and
falling back):

* ``segmented``: S >= 64 (prefill): a block of 32 channels × 16 time
  segments, each segment composed in registers and scanned across the
  segments, the inputs read once; ``rglru_assoc``'s function.
* ``serial``: S < 64 (decode's S = 1): a thread a channel walks every step;
  ``rglru_sequential``'s function, bit for bit.

``rglru_cuda.launches`` counts every launch and
``rglru_cuda.launches_by_body`` each body's.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .._grad import refuse_grad

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BODIES = ("segmented", "serial")
MIN_SEGMENTED_STEPS = 64


def _entry(name: str):
    fn = getattr(_build.load("rglru"), name)
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P] * 5 + [I] * 4 + [P]
        fn.restype = ctypes.c_int
    return fn


def select_body(log_a: torch.Tensor, gx: torch.Tensor,
                h0: torch.Tensor | None = None) -> str:
    """The body that takes these inputs, one of ``BODIES``: ``segmented``
    for S >= 64, ``serial`` below.

    A pure function of dtype and shape, on any device.  Raises on what no
    body takes: shapes that do not agree, another dtype, an h0 that is not
    float32 (B, W), operands on two devices, non-contiguous operands, a
    batch above 65535."""
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
    return "segmented" if S >= MIN_SEGMENTED_STEPS else "serial"


def rglru_cuda(log_a: torch.Tensor, gx: torch.Tensor,
               h0: torch.Tensor | None = None, *, body: str | None = None):
    """log_a, gx (B,S,W) -> (y (B,S,W) in ``gx.dtype``, h_last (B,W) fp32).

    ``log_a`` and ``gx`` both fp32 or both bf16, contiguous; ``h0`` (B,W)
    fp32, contiguous, or None for a zero state.  ``body`` (default: the one
    ``select_body`` picks; both take every S) names the body to run.
    Raises on anything else."""
    refuse_grad("rglru_cuda", (log_a, gx, h0),
                "training the RG-LRU layers on the card waits for its "
                "backward kernel (ROADMAP.md Queue 1 item 7)")
    if not gx.is_cuda:
        raise ValueError(f"rglru_cuda takes CUDA tensors, got {gx.device}")
    picked = select_body(log_a, gx, h0)
    body = picked if body is None else body
    if body not in BODIES:
        raise ValueError(f"no body {body!r} (bodies: {BODIES})")
    B, S, W = gx.shape
    y = torch.empty((B, S, W), dtype=gx.dtype, device=gx.device)
    h_last = torch.empty((B, W), dtype=torch.float32, device=gx.device)
    if B * W == 0:
        return y, h_last
    args = (log_a.data_ptr(), gx.data_ptr(),
            None if h0 is None else h0.data_ptr(), y.data_ptr(),
            h_last.data_ptr(), B, S, W)
    name = "rglru_fwd_segmented" if body == "segmented" else "rglru_fwd"
    with torch.cuda.device(gx.device):
        err = _entry(name)(*args, _DTYPES[gx.dtype],
                           torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"rglru kernel launch failed ({body} body): CUDA "
                           f"error {err}")
    rglru_cuda.launches += 1
    rglru_cuda.launches_by_body[body] += 1
    return y, h_last


def reset_counts() -> None:
    """Set the launch counts (total and by body) to 0."""
    rglru_cuda.launches = 0
    rglru_cuda.launches_by_body = dict.fromkeys(BODIES, 0)


reset_counts()
