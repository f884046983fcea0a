"""The Mamba-2 SSD chunked scan as a CUDA kernel for Hopper.

The kernel is ``csrc/ssd.cu``; it replaces the TPU kernel ``ssd_pallas`` at
any S (the ragged last chunk is padded inside the kernel), computes
``ref.ssd_chunked``'s function and returns the fp32 state after the last
token beside y.  Its plain versions are ``ref.ssd_chunked`` (and its three
phases) and ``ref.ssd_sequential``.

Two bodies, chosen by ``select_body`` from the dtype (never by trying one and
falling back):

* ``mma``: bfloat16 (the served path): chunk-parallel on the tensor cores,
  three launches (``ref.ssd_chunk_state``, ``ref.ssd_state_passing``,
  ``ref.ssd_chunk_scan``) through a workspace of chunk states and cumsums
  that this wrapper allocates on the current stream.
* ``fma``: float32: one block a (batch, head) walks the chunks in order, the
  products in fp32 on the FMA units.

``ssd_cuda.launches`` counts every call and ``ssd_cuda.launches_by_body``
each body's.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .._grad import refuse_grad

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BODIES = ("mma", "fma")


def _entry(name: str):
    fn = getattr(_build.load("ssd"), name)
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = {"ssd_fwd": [P] * 8 + [I] * 8 + [P],
                       "ssd_chunk_state": [P] * 6 + [I] * 7 + [P],
                       "ssd_state_pass": [P] * 3 + [I] * 6 + [P],
                       "ssd_chunk_scan": [P] * 8 + [I] * 7 + [P]}[name]
        fn.restype = ctypes.c_int
    return fn


def select_body(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, D: torch.Tensor,
                chunk: int = 128) -> str:
    """The body that takes these inputs, one of ``BODIES``: ``mma`` for
    bfloat16, ``fma`` for float32.

    A pure function of dtype and shape, on any device.  Raises on what no
    body takes: shapes that do not agree, another dtype, G not dividing H,
    P or N not a multiple of 8 up to 128, a chunk outside 16-128, batch or
    heads above 65535, operands on two devices, non-contiguous x, Bm, Cm."""
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
    if B > 65535 or H > 65535:
        raise ValueError("batch and heads are limited to 65535")
    for t in (dt, A, Bm, Cm, D):
        if t.device != x.device:
            raise ValueError("ssd_cuda operands must share one device")
    for t in (x, Bm, Cm):
        if not t.is_contiguous():
            raise ValueError("ssd_cuda takes contiguous x, Bm and Cm")
    return "mma" if x.dtype == torch.bfloat16 else "fma"


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t itself, or a copy of it if its base is not 16-byte aligned (the mma
    body reads 16-byte vectors)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def ssd_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, D: torch.Tensor, *,
             chunk: int = 128, body: str | None = None):
    """x (B,S,H,P), dt (B,S,H), A, D (H,), Bm/Cm (B,S,G,N) ->
    (y (B,S,H,P) in ``x.dtype``, state (B,H,P,N) fp32 after the last token).

    x, Bm and Cm contiguous, all float32 or all bfloat16; dt, A and D any
    float type (cast to float32 here).  Any S; chunk 16-128; P and N
    multiples of 8 up to 128; G dividing H.  ``body`` (default: the one
    ``select_body`` picks) names the body to run, ``fma`` or, for bfloat16,
    ``mma``.  Raises on anything else."""
    refuse_grad("ssd_cuda", (x, dt, A, Bm, Cm, D),
                "training the SSD layers on the card waits for its "
                "backward kernel (ROADMAP.md Queue 1 item 7)")
    if not x.is_cuda:
        raise ValueError(f"ssd_cuda takes CUDA tensors, got {x.device}")
    picked = select_body(x, dt, A, Bm, Cm, D, chunk)
    body = picked if body is None else body
    if body not in BODIES or (body == "mma" and picked != "mma"):
        raise ValueError(f"body {body!r} does not take {x.dtype} inputs "
                         f"(bodies: {BODIES})")
    B, S, H, P = x.shape
    G, N = Bm.shape[2:]
    dt, A, D = (t.to(torch.float32).contiguous() for t in (dt, A, D))
    y = torch.empty_like(x)
    state = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    if B * H == 0:
        return y, state
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        if body == "fma":
            calls = [("ssd_fwd", (
                x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                Cm.data_ptr(), D.data_ptr(), y.data_ptr(), state.data_ptr(),
                B, S, H, P, G, N, chunk, _DTYPES[x.dtype]))]
        else:
            x, Bm, Cm = (_aligned(t) for t in (x, Bm, Cm))
            nc = -(-S // chunk)
            states = torch.empty((B, nc, H, P, N), dtype=torch.float32,
                                 device=x.device)
            cum = torch.empty((B, H, nc * chunk), dtype=torch.float32,
                              device=x.device)
            calls = [
                ("ssd_chunk_state", (
                    x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                    states.data_ptr(), cum.data_ptr(), B, S, H, P, G, N,
                    chunk)),
                ("ssd_state_pass", (
                    states.data_ptr(), cum.data_ptr(), state.data_ptr(), B, S,
                    H, P, N, chunk)),
                ("ssd_chunk_scan", (
                    x.data_ptr(), dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                    D.data_ptr(), cum.data_ptr(), states.data_ptr(),
                    y.data_ptr(), B, S, H, P, G, N, chunk))]
        for name, args in calls:
            err = _entry(name)(*args, stream)
            if err:
                raise RuntimeError(f"ssd kernel launch failed ({body} body, "
                                   f"{name}): CUDA error {err}")
    ssd_cuda.launches += 1
    ssd_cuda.launches_by_body[body] += 1
    return y, state


def reset_counts() -> None:
    """Set the launch counts (total and by body) to 0."""
    ssd_cuda.launches = 0
    ssd_cuda.launches_by_body = dict.fromkeys(BODIES, 0)


reset_counts()
