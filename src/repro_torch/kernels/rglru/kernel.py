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

The backward is a kernel too (``rglru_bwd_cuda``: d log_a, d gx and dh0 of
y and h_last by the reverse scan; its plain version is ``ref.rglru_bwd``),
behind ``RGLRUFunction``, the ``torch.autograd.Function`` whose forward is
``rglru_cuda``.  Two bodies, chosen by ``select_bwd_body`` from S as the
forward's are:

* ``segmented``: S >= 64, where the forward is segmented: the reverse carry
  composed by segments as the forward composes h, in windows of 512 steps
  (``BWD_WINDOW``), the inputs read once up to there;
  ``ref.rglru_bwd_segmented`` models its rounding order.
* ``serial``: S < 64, and the previous body of every S (``body="serial"``):
  a thread a channel, h recomputed from states saved every 16 steps.

``rglru_bwd_cuda.launches`` counts its calls and ``launches_by_body`` each
body's.  Called outside that Function, ``rglru_cuda`` refuses inputs that
require grad.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .._grad import refuse_grad
from .._twin import Cost, charge, count_launch, fake

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BODIES = ("segmented", "serial")
BWD_BODIES = ("segmented", "serial")
MIN_SEGMENTED_STEPS = 64
# steps between the states the serial backward saves (csrc/rglru.cu
# kBwdSegment)
BWD_SEGMENT_STEPS = 16
# the segmented backward's window: 16 segments of 32 steps (csrc/rglru.cu
# kBwdSegments x kBwdSteps); past one window it saves the state entering each
BWD_WINDOW = 512


def _entry(name: str):
    fn = getattr(_build.load("rglru"), name)
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([P] * 9 if name.startswith("rglru_bwd") else [P] * 5) \
            + [I] * 4 + [P]
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


def rglru_cost(B: int, S: int, W: int, dtype: torch.dtype,
               h0: bool = False) -> Cost:
    """One forward: log_a, gx (and h0) read once, y and h_last (fp32)
    written once; about 9 operations an element (2 exp, sqrt, max, sub, 3
    mul, add), in fp32."""
    n = B * S * W
    return Cost(bytes=3 * n * dtype.itemsize + (1 + h0) * B * W * 4,
                ops=9 * n, unit="fp32", flops=9 * n)


def rglru_bwd_cost(B: int, S: int, W: int, dtype: torch.dtype) -> Cost:
    """One backward: log_a, gx and dy read once, d log_a and d gx written
    once; about 30 operations an element (the recompute and the reverse
    step), in fp32."""
    n = B * S * W
    return Cost(bytes=5 * n * dtype.itemsize, ops=30 * n, unit="fp32",
                flops=30 * n)


def _saved_shape(body: str, B: int, S: int, W: int) -> tuple | None:
    """The backward's workspace of saved states: the serial body's every 16
    steps, the segmented body's at each 512-step window (none within
    one window)."""
    if body == "serial":
        return (B, -(-S // BWD_SEGMENT_STEPS), W)
    return (B, -(-S // BWD_WINDOW), W) if S > BWD_WINDOW else None


def rglru_cuda(log_a: torch.Tensor, gx: torch.Tensor,
               h0: torch.Tensor | None = None, *, body: str | None = None):
    """log_a, gx (B,S,W) -> (y (B,S,W) in ``gx.dtype``, h_last (B,W) fp32).

    ``log_a`` and ``gx`` both fp32 or both bf16, contiguous; ``h0`` (B,W)
    fp32, contiguous, or None for a zero state.  ``body`` (default: the one
    ``select_body`` picks; both take every S) names the body to run.
    Raises on anything else."""
    refuse_grad("rglru_cuda", (log_a, gx, h0),
                "call kernels.ops.rglru_scan, which differentiates it "
                "through RGLRUFunction (ROADMAP.md Queue 1 item 7)")
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
    if fake(gx):    # shape only (``_twin``): y and h_last, nothing launched
        charge("rglru", rglru_cost(B, S, W, gx.dtype, h0 is not None), body)
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
    count_launch(rglru_cuda, body)
    return y, h_last


def select_bwd_body(log_a: torch.Tensor, gx: torch.Tensor,
                    h0: torch.Tensor | None = None) -> str:
    """The backward body for these inputs, one of ``BWD_BODIES``: the body
    ``select_body`` picks for the forward (``segmented`` for S >= 64,
    ``serial`` below), on any device; raises as it does."""
    return select_body(log_a, gx, h0)


def rglru_bwd_cuda(log_a: torch.Tensor, gx: torch.Tensor, dy: torch.Tensor,
                   h0: torch.Tensor | None = None,
                   dh_last: torch.Tensor | None = None, *,
                   body: str | None = None):
    """(d log_a, d gx, dh0) of ``rglru_cuda``'s y and h_last, given dy (like
    gx) and ``dh_last`` (B,W) or None (h_last unused): d log_a and d gx in
    their inputs' dtypes, dh0 (B,W) fp32, or None without h0.

    The inputs ``rglru_cuda`` takes, none empty; h is recomputed in fp32.
    ``body`` (default: ``select_bwd_body``'s; both take every S) names the
    body to run.  Raises on anything else."""
    if not gx.is_cuda:
        raise ValueError(f"rglru_bwd_cuda takes CUDA tensors, got "
                         f"{gx.device}")
    picked = select_bwd_body(log_a, gx, h0)
    body = picked if body is None else body
    if body not in BWD_BODIES:
        raise ValueError(f"no backward body {body!r} (bodies: {BWD_BODIES})")
    dy = dy.contiguous()
    if dy.shape != gx.shape or dy.dtype != gx.dtype or dy.device != gx.device:
        raise ValueError(f"dy {dy.dtype} {tuple(dy.shape)} does not match gx "
                         f"{gx.dtype} {tuple(gx.shape)}")
    B, S, W = gx.shape
    if B * S * W == 0:
        raise ValueError("rglru_bwd_cuda takes B, S, W >= 1")
    if dh_last is not None:
        dh_last = dh_last.to(torch.float32).contiguous()
        if dh_last.shape != (B, W) or dh_last.device != gx.device:
            raise ValueError(f"dh_last must be (B, W) = ({B}, {W}); got "
                             f"{tuple(dh_last.shape)}")
    dla, dgx = torch.empty_like(log_a), torch.empty_like(gx)
    dh0 = None if h0 is None else torch.empty((B, W), dtype=torch.float32,
                                              device=gx.device)
    shape = _saved_shape(body, B, S, W)
    saved = None if shape is None else torch.empty(
        shape, dtype=torch.float32, device=gx.device)
    if fake(gx):    # shape only (``_twin``): nothing launched
        charge("rglru_bwd", rglru_bwd_cost(B, S, W, gx.dtype), body)
        return dla, dgx, dh0
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    name = "rglru_bwd_segmented" if body == "segmented" else "rglru_bwd"
    with torch.cuda.device(gx.device):
        err = _entry(name)(
            log_a.data_ptr(), gx.data_ptr(), dy.data_ptr(), ptr(h0),
            ptr(dh_last), ptr(saved), dla.data_ptr(), dgx.data_ptr(),
            ptr(dh0), B, S, W, _DTYPES[gx.dtype],
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"rglru backward launch failed ({body} body): "
                           f"CUDA error {err}")
    count_launch(rglru_bwd_cuda, body)
    return dla, dgx, dh0


class RGLRUFunction(torch.autograd.Function):
    """``rglru_cuda`` forward, ``rglru_bwd_cuda`` backward.  Grads are not
    materialized: an unused h_last costs no zero tensor."""

    @staticmethod
    def forward(ctx, log_a, gx, h0):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(log_a, gx, h0)
        return rglru_cuda(log_a, gx, h0)

    @staticmethod
    def backward(ctx, dy, dh_last):
        if dy is None and dh_last is None:
            return None, None, None
        log_a, gx, h0 = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(gx)
        return rglru_bwd_cuda(log_a, gx, dy, h0, dh_last)


def reset_counts() -> None:
    """Set the launch counts (forward and backward, total and by body)
    to 0."""
    rglru_cuda.launches = 0
    rglru_cuda.launches_by_body = dict.fromkeys(BODIES, 0)
    rglru_bwd_cuda.launches = 0
    rglru_bwd_cuda.launches_by_body = dict.fromkeys(BWD_BODIES, 0)


reset_counts()
