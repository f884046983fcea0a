"""The Mamba-2 SSD chunked scan as a CUDA kernel for Hopper.

The kernel is ``csrc/ssd.cu``; it replaces the TPU kernel ``ssd_pallas`` at
any S (the ragged last chunk is padded inside the kernel), computes
``ref.ssd_chunked``'s function and returns the fp32 state after the last
token beside y.  Its plain versions are ``ref.ssd_chunked`` (and its three
phases) and ``ref.ssd_sequential``.  It takes any chunk from 16 tokens and
runs it at a tile of ``ssd_tile(chunk)`` = min(chunk, 128) tokens: the
chunked scan computes the same function at any chunk (only the order of its
fp32 sums changes), so a chunk past 128 (256, the upstream Mamba-2 module's
default) launches the same kernels at 128.

Three bodies, chosen by ``select_body`` from the dtype (never by trying one
and falling back):

* ``mma``: bfloat16 (the served path): chunk-parallel on the tensor cores,
  three launches (``ref.ssd_chunk_state``, ``ref.ssd_state_passing``,
  ``ref.ssd_chunk_scan``) through a workspace of chunk states and cumsums
  that this wrapper allocates on the current stream.
* ``mma_tf32x3``: float32 (the training path), every shape the fma body
  takes: chunk-parallel on the TF32 tensor cores, every product from hi +
  lo operands split by truncation (3xTF32, as the backward's mma body; the
  plain phases with ``product=`` and ``split_einsum(..., truncate_tf32)``
  model it), four launches (chunk states, C·Bᵀ once a group, the state
  pass, the chunk scan) through a workspace this wrapper allocates.
* ``fma``: the previous float32 body, taking either dtype when forced
  (``body="fma"``): one block a (batch, head) walks the chunks in order, the
  products in fp32 on the FMA units.

``ssd_cuda.launches`` counts every call and ``ssd_cuda.launches_by_body``
each body's.

The backward is a kernel too (``ssd_bwd_cuda``: dx, ddt, dA, dB, dC and dD
of y and of the final state, computed in fp32 for both dtypes, six to eight
launches through a workspace this wrapper allocates; its plain version is
``ref.ssd_chunked_bwd``), behind ``SSDFunction``, the
``torch.autograd.Function`` whose forward is ``ssd_cuda``.  Two bodies:

* ``mma`` (``select_bwd_body``'s, for every shape the forward takes): the
  chunk states and the chunk gradients on the TF32 tensor cores, every fp32
  operand split into hi + lo (3xTF32), the Q x Q scores kept in registers;
  P past 64 in slabs of ``BWD_SLAB_P`` = 64 columns (``bwd_slabs``), a
  block each, whose parts of the sums over P the kernel adds in slab order
  (``ref.ssd_chunked_bwd(..., slab=64)`` models it).
* ``fma``: the previous body, forced by ``body="fma"`` where its block fits
  (``bwd_smem_bytes``): the products in fp32 on the FMA units, the scores
  through a device scratch.

``check_bwd_inputs`` refuses what the forward refuses.
``ssd_bwd_cuda.launches`` counts its calls and ``launches_by_body`` each
body's.  Called outside that Function, ``ssd_cuda`` refuses inputs that
require grad.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .._grad import refuse_grad
from .._twin import Cost, charge, count_launch, fake

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BODIES = ("mma", "mma_tf32x3", "fma")
BWD_BODIES = ("mma", "fma")
# the backward's chunk blocks: csrc/ssd.cu's bwd_smem_floats, kBwdVecs,
# kBwdThreads and kBwdMaxSmemBytes; the mma body's slab of P (kMmaP); the
# largest chunk an entry point takes (kMaxQ)
BWD_MAX_SMEM_BYTES = 232448
BWD_SLAB_P = 64
MAX_TILE = 128


def ssd_tile(chunk: int) -> int:
    """The tokens a chunk of the kernels holds for ``chunk``: the chunk
    itself up to 128, else 128 (the same function, its sums in another
    order)."""
    return min(chunk, MAX_TILE)


def bwd_slabs(P: int) -> int:
    """The backward mma body's slabs of P: 64 columns each, the last ragged
    (csrc/ssd.cu's bwd_slabs)."""
    return -(-P // BWD_SLAB_P)


def _entry(name: str):
    fn = getattr(_build.load("ssd"), name)
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = {"ssd_fwd": [P] * 8 + [I] * 8 + [P],
                       "ssd_fwd_mma_tf32": [P] * 9 + [I] * 7 + [P],
                       "ssd_fwd_mma_tf32_workspace_floats": [I] * 7,
                       "ssd_chunk_state": [P] * 6 + [I] * 7 + [P],
                       "ssd_state_pass": [P] * 3 + [I] * 6 + [P],
                       "ssd_chunk_scan": [P] * 8 + [I] * 7 + [P],
                       "ssd_bwd": [P] * 15 + [I] * 8 + [P],
                       "ssd_bwd_mma": [P] * 15 + [I] * 8 + [P],
                       "ssd_bwd_workspace_floats": [I] * 7,
                       "ssd_bwd_mma_workspace_floats": [I] * 7}[name]
        fn.restype = (ctypes.c_longlong if name.endswith("_workspace_floats")
                      else ctypes.c_int)
    return fn


def select_body(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, D: torch.Tensor,
                chunk: int = 128) -> str:
    """The body that takes these inputs, one of ``BODIES``: ``mma`` for
    bfloat16, ``mma_tf32x3`` for float32 (its blocks fit every shape below:
    no float32 shape is left to ``fma``, which stays the body forced by
    ``body="fma"``).

    A pure function of dtype and shape, on any device.  Raises on what no
    body takes: shapes that do not agree, another dtype, G not dividing H,
    P or N not a multiple of 8 up to 128, a chunk below 16 (any larger one
    runs at the tile ``ssd_tile(chunk)``), batch or heads above 65535,
    operands on two devices, non-contiguous x, Bm, Cm."""
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
    if chunk < 16:
        raise ValueError(f"chunk {chunk} must be at least 16")
    if B > 65535 or H > 65535:
        raise ValueError("batch and heads are limited to 65535")
    for t in (dt, A, Bm, Cm, D):
        if t.device != x.device:
            raise ValueError("ssd_cuda operands must share one device")
    for t in (x, Bm, Cm):
        if not t.is_contiguous():
            raise ValueError("ssd_cuda takes contiguous x, Bm and Cm")
    return "mma" if x.dtype == torch.bfloat16 else "mma_tf32x3"


def bodies_for(x, dt, A, Bm, Cm, D, chunk: int = 128) -> tuple[str, ...]:
    """The bodies that take these inputs, the one ``select_body`` picks
    first: ``mma`` (bfloat16) or ``mma_tf32x3`` (float32), then ``fma``,
    which takes either dtype when forced.  Raises as ``select_body``."""
    return (select_body(x, dt, A, Bm, Cm, D, chunk), "fma")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t itself, or a copy of it if its base is not 16-byte aligned (the mma
    body reads 16-byte vectors)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def ssd_macs(B, S, H, P, G, N, Q) -> int:
    """Multiply-adds one SSD scan needs, all fp32, at the tile the kernels
    run for chunk Q (``ssd_tile``): per (b, g, tile) C·Bᵀ on and below the
    diagonal; per (b, h, tile) scores @ x on and below it and Bᵀ @ x in
    full, and C @ state in every tile but the first (its incoming state is
    zero)."""
    Q = ssd_tile(Q)
    tri, n_chunks = Q * (Q + 1) // 2, -(-S // Q)
    return B * (n_chunks * (G * tri * N + H * (tri * P + Q * N * P))
                + (n_chunks - 1) * H * Q * N * P)


def ssd_split_macs(B, S, H, P, G, N, Q) -> int:
    """Multiply-adds the SSD scan's mma body needs on the bf16 tensor cores:
    those of ``ssd_macs``, with every product that has an fp32 operand
    (scores @ x, Bᵀ @ (w∘x), C @ state: all but C·Bᵀ) taken twice, once for
    the operand's bf16 hi and once for its lo."""
    Q = ssd_tile(Q)
    cb = B * -(-S // Q) * G * (Q * (Q + 1) // 2) * N
    return cb + 2 * (ssd_macs(B, S, H, P, G, N, Q) - cb)


def ssd_bwd_macs(B, S, H, P, G, N, Q) -> int:
    """Multiply-adds the SSD backward needs, all fp32, at the tile the
    kernels run for chunk Q (``ssd_tile``; "chunk" below is a tile): per
    (b, g, chunk) C·Bᵀ on and below the diagonal (recomputed); per (b, h,
    chunk) dy·xᵀ, the scores' transpose times dy, d(C·Bᵀ) times B and
    times C, on and below it, and in full the chunk's local state, its E =
    Σ exp(cum) dy Cᵀ, B·dSᵀ and x·dS; in every chunk but the first also W
    = dy·state_in, the inter-chunk term of dC (the state entering the first
    is zero; d cum's inter-chunk term dy·(C·state_inᵀ) is C·W, Q·N more,
    not counted).  The products of d(C·Bᵀ) with B and C that each slab of
    P past the first repeats are not counted: the function needs them
    once."""
    Q = ssd_tile(Q)
    tri, n_chunks, qnp = Q * (Q + 1) // 2, -(-S // Q), Q * N * P
    return B * (n_chunks * (G * tri * N + H * (2 * tri * P + 2 * tri * N
                                               + 4 * qnp))
                + (n_chunks - 1) * H * qnp)


def ssd_bwd_split_macs(B, S, H, P, G, N, Q) -> int:
    """Multiply-adds the SSD backward's mma body needs on the TF32 tensor
    cores: those of ``ssd_bwd_macs`` (all its products have an fp32
    operand), each formed from three TF32 products (hi·hi, hi·lo, lo·hi)."""
    return 3 * ssd_bwd_macs(B, S, H, P, G, N, Q)


def ssd_cost(B: int, S: int, H: int, P: int, G: int, N: int, Q: int,
             dtype: torch.dtype) -> Cost:
    """One forward: x, dt (fp32), Bm, Cm, A and D read once, y and the fp32
    state written once; the products of the body that takes ``dtype``: in
    bf16 the mma body's on the bf16 tensor cores, the split operands' twice
    (``ssd_split_macs``), in fp32 the mma_tf32x3 body's, three TF32 products
    each (``ssd_macs``); 2 operations a multiply-add."""
    e = dtype.itemsize
    n_bytes = (2 * B * S * H * P + 2 * B * S * G * N) * e + B * S * H * 4 \
        + 2 * 4 * H + B * H * P * N * 4
    flops = 2 * ssd_macs(B, S, H, P, G, N, Q)
    if dtype == torch.float32:
        return Cost(n_bytes, 3 * flops, "tf32", flops)
    return Cost(n_bytes, 2 * ssd_split_macs(B, S, H, P, G, N, Q), "bf16",
                flops)


def ssd_bwd_cost(B: int, S: int, H: int, P: int, G: int, N: int, Q: int,
                 dtype: torch.dtype) -> Cost:
    """One backward: x, dt, Bm, Cm, dy (A, D) read once, dx, ddt, dB, dC
    (dA, dD) written once; the mma body's products on the TF32 tensor
    cores (``ssd_bwd_split_macs``), 2 operations a multiply-add."""
    e = dtype.itemsize
    n_bytes = (3 * B * S * H * P + 4 * B * S * G * N) * e \
        + 2 * B * S * H * 4 + 4 * 4 * H
    return Cost(n_bytes, 2 * ssd_bwd_split_macs(B, S, H, P, G, N, Q), "tf32",
                2 * ssd_bwd_macs(B, S, H, P, G, N, Q))


def _round4(v: int) -> int:
    return (v + 3) & ~3


def _round16(v: int) -> int:
    return (v + 15) & ~15


def fwd_tf32_workspace_floats(B, S, H, P, G, N, Q) -> int:
    """Floats of the mma_tf32x3 body's workspace: ``csrc/ssd.cu``'s
    ``fwd_workspace`` (the chunk states, cum, C·Bᵀ a (b, chunk, group))."""
    nc = -(-S // Q)
    cum = _round4(B * nc * H * P * N)
    cb = _round4(cum + B * H * nc * Q)
    return cb + B * nc * G * _round16(Q) * _round16(Q)


def bwd_workspace_floats(body: str, B, S, H, P, G, N, Q) -> int:
    """Floats of the backward's workspace on ``body`` at the tile Q (a
    chunk the entry points take): ``csrc/ssd.cu``'s
    ``ssd_bwd_workspace_floats`` (fma) and ``ssd_bwd_mma_workspace_floats``
    (mma: the fma body's parts up to its scratch, dB, dC and the dA / dD
    parts once a slab of P, then C·Bᵀ and its transpose a (b, chunk,
    group), then with two slabs each slab's ddt)."""
    nc, Qp = -(-S // Q), (Q + 3) & ~3
    slabs = bwd_slabs(P) if body == "mma" else 1
    states = _round4(B * H * nc * Q)
    parts = states + 2 * B * nc * H * P * N + B * H * P * N \
        + 2 * slabs * B * S * H * N
    scratch = _round4(parts + 2 * B * nc * H * slabs)
    if body == "mma":
        ddt_parts = slabs * B * S * H if slabs > 1 else 0
        return scratch + B * nc * G * 2 * _round16(Q) * _round16(Q) \
            + ddt_parts
    return scratch + B * nc * H * (3 * Qp * Qp + (Qp // 4) * Qp
                                   + 2 * (N // 4) * Qp)


def ssd_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, D: torch.Tensor, *,
             chunk: int = 128, body: str | None = None):
    """x (B,S,H,P), dt (B,S,H), A, D (H,), Bm/Cm (B,S,G,N) ->
    (y (B,S,H,P) in ``x.dtype``, state (B,H,P,N) fp32 after the last token).

    x, Bm and Cm contiguous, all float32 or all bfloat16; dt, A and D any
    float type (cast to float32 here).  Any S; a chunk of 16 or more, run
    at the tile ``ssd_tile(chunk)`` (128 for any chunk past it); P and N
    multiples of 8 up to 128; G dividing H.  ``body`` (default: the one
    ``select_body`` picks) names one of ``bodies_for`` these inputs.
    Raises on anything else."""
    refuse_grad("ssd_cuda", (x, dt, A, Bm, Cm, D),
                "call kernels.ops.ssd_scan, which differentiates it through "
                "SSDFunction (ROADMAP.md Queue 1 item 7)")
    if not x.is_cuda:
        raise ValueError(f"ssd_cuda takes CUDA tensors, got {x.device}")
    takes = bodies_for(x, dt, A, Bm, Cm, D, chunk)
    body = takes[0] if body is None else body
    if body not in takes:
        raise ValueError(f"body {body!r} does not take {x.dtype} inputs "
                         f"(bodies: {BODIES})")
    B, S, H, P = x.shape
    G, N = Bm.shape[2:]
    chunk = ssd_tile(chunk)
    dt, A, D = (t.to(torch.float32).contiguous() for t in (dt, A, D))
    y = torch.empty_like(x)
    state = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    if B * H == 0:
        return y, state
    if fake(x):
        return _ssd_twin(body, x, y, state, G, N, chunk)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        if body == "fma":
            calls = [("ssd_fwd", (
                x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                Cm.data_ptr(), D.data_ptr(), y.data_ptr(), state.data_ptr(),
                B, S, H, P, G, N, chunk, _DTYPES[x.dtype]))]
        elif body == "mma_tf32x3":
            x, Bm, Cm = (_aligned(t) for t in (x, Bm, Cm))
            ws = torch.empty(_entry("ssd_fwd_mma_tf32_workspace_floats")(
                B, S, H, P, G, N, chunk), dtype=torch.float32, device=x.device)
            calls = [("ssd_fwd_mma_tf32", (
                x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                Cm.data_ptr(), D.data_ptr(), y.data_ptr(), state.data_ptr(),
                ws.data_ptr(), B, S, H, P, G, N, chunk))]
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
    count_launch(ssd_cuda, body)
    return y, state


def _ssd_twin(body, x, y, state, G, N, chunk):
    """``ssd_cuda`` on fake tensors, past the outputs: the workspace
    ``body`` allocates at the tile ``chunk``, the cost charged on ``body``;
    nothing launched."""
    B, S, H, P = x.shape
    f32, dev = torch.float32, x.device
    if body == "mma_tf32x3":
        torch.empty(fwd_tf32_workspace_floats(B, S, H, P, G, N, chunk),
                    dtype=f32, device=dev)
    elif body == "mma":
        nc = -(-S // chunk)
        states = torch.empty((B, nc, H, P, N), dtype=f32, device=dev)
        cum = torch.empty((B, H, nc * chunk), dtype=f32, device=dev)
        del states, cum
    charge("ssd", ssd_cost(B, S, H, P, G, N, chunk, x.dtype), body)
    return y, state


def bwd_smem_bytes(chunk: int, P: int, N: int) -> int:
    """Shared memory of the backward's chunk blocks: C, B, x and dy of a
    chunk in fp32 with padded rows, 8 vectors of 128 floats and a
    256-float buffer (``bwd_smem_floats`` in ``csrc/ssd.cu``)."""
    Qp = (chunk + 3) & ~3
    return 4 * (2 * Qp * (N + 4) + 2 * Qp * (P + 4) + 8 * 128 + 256)


def select_bwd_body(x, dt, A, Bm, Cm, D, dy, chunk: int = 128,
                    d_state=None) -> str:
    """The backward body for these inputs: ``mma`` for every shape the
    forward takes (its chunk block, 64 columns of P a slab and N up to 128,
    fits 227 KB of shared memory at every tile: 225 KB at 128).  Raises as
    ``check_bwd_inputs``.  A pure function of dtype and shape, on any
    device."""
    check_bwd_inputs(x, dt, A, Bm, Cm, D, dy, chunk, d_state)
    return "mma"


def bwd_bodies_for(x, dt, A, Bm, Cm, D, dy, chunk: int = 128,
                   d_state=None) -> tuple[str, ...]:
    """The backward bodies that take these inputs, the one
    ``select_bwd_body`` picks first: ``mma``, then ``fma`` where its chunk
    block at the tile ``ssd_tile(chunk)`` fits 227 KB of shared memory
    (``bwd_smem_bytes``; not at P = N = 128 with a tile of 128).  Raises as
    ``check_bwd_inputs``."""
    picked = select_bwd_body(x, dt, A, Bm, Cm, D, dy, chunk, d_state)
    fits = bwd_smem_bytes(ssd_tile(chunk), x.shape[-1],
                          Bm.shape[-1]) <= BWD_MAX_SMEM_BYTES
    return (picked, "fma") if fits else (picked,)


def check_bwd_inputs(x, dt, A, Bm, Cm, D, dy, chunk: int = 128,
                     d_state=None) -> None:
    """Check what the backward takes, on any device from dtype and shape.

    Raises on what the forward takes no body for, on a dy unlike x or a
    d_state that is not (B,H,P,N), and on empty inputs."""
    select_body(x, dt, A, Bm, Cm, D, chunk)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dy {dy.dtype} {tuple(dy.shape)} does not match x "
                         f"{x.dtype} {tuple(x.shape)}")
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    if d_state is not None and (d_state.shape != (B, H, P, N)
                                or d_state.device != x.device):
        raise ValueError(f"d_state must be (B, H, P, N) = {(B, H, P, N)}; "
                         f"got {tuple(d_state.shape)}")
    if B * S * H == 0:
        raise ValueError("the SSD backward takes B, S, H >= 1")


def ssd_bwd_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor, D: torch.Tensor,
                 dy: torch.Tensor, d_state: torch.Tensor | None = None, *,
                 chunk: int = 128, body: str | None = None):
    """(dx, ddt, dA, dBm, dCm, dD), each in its input's dtype, of
    ``ssd_cuda``'s y and final state, given dy (like x) and ``d_state``
    (B,H,P,N) or None (the final state unused).

    The inputs ``ssd_cuda`` takes, none empty (``check_bwd_inputs``), the
    chunk run at the tile ``ssd_tile(chunk)`` as the forward runs it;
    computed in fp32 from either dtype.  ``body`` (default: the one
    ``select_bwd_body`` picks, ``mma``) names one of ``bwd_bodies_for``
    these inputs.  Every sum has one owner and a fixed order: the same bits
    on every run on one card."""
    if not x.is_cuda:
        raise ValueError(f"ssd_bwd_cuda takes CUDA tensors, got {x.device}")
    dy = dy.contiguous()
    if d_state is not None:
        d_state = d_state.to(torch.float32).contiguous()
    takes = bwd_bodies_for(x, dt, A, Bm, Cm, D, dy, chunk, d_state)
    body = takes[0] if body is None else body
    chunk = ssd_tile(chunk)
    if body not in takes:
        raise ValueError(
            f"backward body {body!r} does not take P={x.shape[-1]}, "
            f"N={Bm.shape[-1]} at a tile of {chunk} (these take {takes}; the "
            f"fma body's block would need "
            f"{bwd_smem_bytes(chunk, x.shape[-1], Bm.shape[-1])} bytes of "
            "shared memory, 227 KB at most)")
    entry = "ssd_bwd_mma" if body == "mma" else "ssd_bwd"
    shape_only = fake(x)
    if body == "mma" and not shape_only:
        # it reads x, dy, Bm and Cm as 16-byte vectors
        x, Bm, Cm, dy = (_aligned(t) for t in (x, Bm, Cm, dy))
    B, S, H, P = x.shape
    G, N = Bm.shape[2:]
    f32 = torch.float32
    dtf, Af, Df = (t.to(f32).contiguous() for t in (dt, A, D))
    dx, dBm, dCm = (torch.empty_like(t) for t in (x, Bm, Cm))
    ddt = torch.empty((B, S, H), dtype=f32, device=x.device)
    dA, dD = (torch.empty(H, dtype=f32, device=x.device) for _ in range(2))
    if shape_only:  # the workspace and the cost; no launch
        torch.empty(bwd_workspace_floats(body, B, S, H, P, G, N, chunk),
                    dtype=f32, device=x.device)
        charge("ssd_bwd", ssd_bwd_cost(B, S, H, P, G, N, chunk, x.dtype),
               body)
        return (dx, ddt.to(dt.dtype), dA.to(A.dtype), dBm, dCm,
                dD.to(D.dtype))
    with torch.cuda.device(x.device):
        ws = torch.empty(_entry(entry + "_workspace_floats")(
            B, S, H, P, G, N, chunk), dtype=f32, device=x.device)
        err = _entry(entry)(
            x.data_ptr(), dtf.data_ptr(), Af.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), Df.data_ptr(), dy.data_ptr(),
            None if d_state is None else d_state.data_ptr(), dx.data_ptr(),
            ddt.data_ptr(), dA.data_ptr(), dBm.data_ptr(), dCm.data_ptr(),
            dD.data_ptr(), ws.data_ptr(), B, S, H, P, G, N, chunk,
            _DTYPES[x.dtype], torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"ssd backward launch failed ({body} body): CUDA "
                           f"error {err}")
    count_launch(ssd_bwd_cuda, body)
    return (dx, ddt.to(dt.dtype), dA.to(A.dtype), dBm, dCm, dD.to(D.dtype))


class SSDFunction(torch.autograd.Function):
    """``ssd_cuda`` forward, ``ssd_bwd_cuda`` backward.  Grads are not
    materialized: an unused final state costs no zero tensor."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, D, chunk):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, A, Bm, Cm, D)
        ctx.chunk = chunk
        return ssd_cuda(x, dt, A, Bm, Cm, D, chunk=chunk)

    @staticmethod
    def backward(ctx, dy, d_state):
        if dy is None and d_state is None:
            return (None,) * 7
        x, dt, A, Bm, Cm, D = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        return (*ssd_bwd_cuda(x, dt, A, Bm, Cm, D, dy, d_state,
                              chunk=ctx.chunk), None)


def reset_counts() -> None:
    """Set the launch counts (forward and backward, total and by body)
    to 0."""
    ssd_cuda.launches = 0
    ssd_cuda.launches_by_body = dict.fromkeys(BODIES, 0)
    ssd_bwd_cuda.launches = 0
    ssd_bwd_cuda.launches_by_body = dict.fromkeys(BWD_BODIES, 0)


reset_counts()
