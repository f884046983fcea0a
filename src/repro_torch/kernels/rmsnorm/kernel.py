"""Fused RMSNorm (+ optional residual add) as a CUDA kernel for Hopper.

The kernel is ``csrc/rmsnorm.cu``; it replaces the TPU kernel
``rmsnorm_pallas`` and is bounded by bytes (one read of x and the residual,
one write of y).  Its plain version is ``ref.rmsnorm_ref``.

Two bodies, chosen by ``select_body`` from the shape, the dtypes and the
alignment (never by trying one and falling back):

* ``one_read``: rows of 16-byte vectors, at most 32 a lane (bf16 up to D
  8192, fp32 up to 4096: every served width): a warp per row, the row read
  once into registers.
* ``generic``: any other row: a CTA per row, read twice.

``rmsnorm_cuda.launches`` counts every launch and
``rmsnorm_cuda.launches_by_body`` each body's.

The backward is a kernel too (``rmsnorm_bwd_cuda``: dx and a deterministic
dscale, the statistics recomputed from x), behind ``RMSNormFunction``, the
``torch.autograd.Function`` whose forward is ``rmsnorm_cuda``.  Three bodies,
chosen by ``select_bwd_body``:

* ``warp_rows``: rows of 16-byte vectors of at most 1024 elements (every
  train width): a warp a row, x and dy read once into registers, each
  lane's dscale sums kept in registers over its warp's rows; the grid comes
  from the SM count (``bwd_grid``), and a second kernel sums the CTAs'
  partial rows in a fixed tree; every dscale sum in fp64.
* ``cta_rows``: rows of 16-byte vectors of 1025 to 8192 elements (the wider
  train widths, 1280-5120, fp32 and bf16): the same design with a CTA of
  1-8 warps on a row (``cta_shape``), the row's sums reduced across the
  warps through shared memory with one barrier a row; the grid from the SM
  count (``cta_grid``).
* ``generic``: any other row: a CTA walks a run of rows, compensated sums.

``rmsnorm_bwd_cuda.launches`` counts its calls and ``launches_by_body``
each body's.  Called outside that Function, ``rmsnorm_cuda`` refuses
inputs that require grad (its output has no ``grad_fn``).
"""
from __future__ import annotations

import ctypes

import torch

from ...device import multiprocessors
from .. import _build
from .._grad import refuse_grad
from .._twin import H100_SMS, Cost, charge, count_launch, fake

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BODIES = ("one_read", "generic")
BWD_BODIES = ("warp_rows", "cta_rows", "generic")
# 16-byte vectors a lane of the one-read body (its template instances)
VECTORS_PER_LANE = (1, 2, 4, 8, 16, 32)


_SIZES = {torch.float32: 4, torch.bfloat16: 2}
_GENERIC = ("generic", 0)


_ENTRY = []   # the bound C entry point, once loaded: the launch path is hot
# CTAs of the backward's generic body at most: each sums its rows' dy * x^
# into its own partial row of dscale, which a second kernel adds up in order
BWD_MAX_BLOCKS = 256
# the warp_rows body: warps a CTA, warps an SM the grid aims at, and the
# most floats of dscale sums a lane holds (its row's vectors times their
# elements)
BWD_ROW_WARPS = 4
BWD_WARPS_PER_SM = 8
BWD_LANE_FLOATS = 32
# the cta_rows body: warps a row at most (so rows up to 8192 elements) and
# warps an SM the grid aims at
BWD_CTA_MAX_WARPS = 8
BWD_CTA_WARPS_PER_SM = 16


def _entry():
    if not _ENTRY:
        fn = _build.load("rmsnorm").rmsnorm_fwd
        P = ctypes.c_void_p
        fn.argtypes = [P, P, P, P, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_float, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, P]
        fn.restype = ctypes.c_int
        _ENTRY.append(fn)
    return _ENTRY[0]


def _bwd_entry(body: str):
    lib = _build.load("rmsnorm")
    fn = {"warp_rows": lib.rmsnorm_bwd_rows, "cta_rows": lib.rmsnorm_bwd_cta,
          "generic": lib.rmsnorm_bwd}[body]
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        tail = {"warp_rows": [I, I, I], "cta_rows": [I, I, I, I],
                "generic": [I]}[body]
        fn.argtypes = [P, P, P, P, P, P, ctypes.c_longlong, I,
                       ctypes.c_float, I, I, *tail, P]
        fn.restype = I
    return fn


def bwd_grid(rows: int, sms: int) -> tuple[int, int]:
    """(rows a warp, CTAs) of the warp_rows body on a card of ``sms`` SMs:
    about ``BWD_WARPS_PER_SM`` warps an SM, each a run of whole rows."""
    per_warp = -(-rows // (sms * BWD_WARPS_PER_SM))
    warps = -(-rows // per_warp)
    return per_warp, -(-warps // BWD_ROW_WARPS)


def cta_shape(D: int, dtype: torch.dtype) -> tuple[int, int]:
    """(warps a row, 16-byte vectors a lane) of the cta_rows body for rows
    of D elements of ``dtype``: the fewest warps that keep a lane at
    ``BWD_LANE_FLOATS`` floats, then the fewest vectors a lane that cover
    the row over them."""
    nvec = D * _SIZES[dtype] // 16
    most = BWD_LANE_FLOATS * _SIZES[dtype] // 16
    warps = -(-nvec // (32 * most))
    return warps, -(-nvec // (32 * warps))


def cta_grid(rows: int, sms: int, warps: int) -> tuple[int, int]:
    """(rows a CTA, CTAs) of the cta_rows body on a card of ``sms`` SMs,
    its CTAs of ``warps`` warps: about ``BWD_CTA_WARPS_PER_SM`` warps an
    SM, each CTA a run of whole rows."""
    per_cta = -(-rows // (sms * max(1, BWD_CTA_WARPS_PER_SM // warps)))
    return per_cta, -(-rows // per_cta)


def check_inputs(x: torch.Tensor, scale: torch.Tensor,
                 residual: torch.Tensor | None = None) -> None:
    """Raise on what no body takes: another dtype, a scale that does not
    match x's last dim, a residual unlike x, non-contiguous inputs, operands
    on two devices.  Reads no base address."""
    x_dtype, s_dtype = x.dtype, scale.dtype
    if x_dtype not in _DTYPES or s_dtype not in _DTYPES:
        raise TypeError(f"rmsnorm_cuda takes float32/bfloat16, got x "
                        f"{x_dtype}, scale {s_dtype}")
    shape = x.shape
    if not shape or scale.shape != shape[-1:]:
        raise ValueError(f"scale {tuple(scale.shape)} does not match x "
                         f"{tuple(shape)}")
    device = x.device
    if scale.device != device or (residual is not None
                                  and residual.device != device):
        raise ValueError("rmsnorm_cuda operands must share one device")
    if residual is not None and (residual.shape != shape
                                 or residual.dtype != x_dtype):
        raise ValueError("residual must match x in shape and dtype")
    if not (x.is_contiguous() and scale.is_contiguous()
            and (residual is None or residual.is_contiguous())):
        raise ValueError("rmsnorm_cuda takes contiguous tensors")


def body_for(D: int, x_dtype: torch.dtype,
             s_dtype: torch.dtype) -> tuple[str, int]:
    """(body, vectors a lane) of rows of D elements on 16-byte aligned
    bases: ``select_body``'s choice from the shape and dtypes alone."""
    row_bytes = D * _SIZES[x_dtype]
    # 16-byte vectors of x, scale and the residual, at most 32 a lane
    if (D == 0 or row_bytes % 16 or D * _SIZES[s_dtype] % 16
            or row_bytes > 16 * 32 * VECTORS_PER_LANE[-1]):
        return _GENERIC
    need = (row_bytes + 16 * 32 - 1) // (16 * 32)
    return "one_read", 1 << (need - 1).bit_length()


def select_body(x: torch.Tensor, scale: torch.Tensor,
                residual: torch.Tensor | None = None) -> tuple[str, int]:
    """(body, vectors a lane) for these inputs: ``("one_read", n)`` with n
    one of ``VECTORS_PER_LANE``, or ``("generic", 0)``.

    A pure function of dtype, shape and base addresses, on any device.
    Raises on what no body takes (``check_inputs``)."""
    check_inputs(x, scale, residual)
    if (x.data_ptr() % 16 or scale.data_ptr() % 16
            or (residual is not None and residual.data_ptr() % 16)):
        return _GENERIC
    return body_for(x.shape[-1], x.dtype, scale.dtype)


def select_bwd_body(x: torch.Tensor, scale: torch.Tensor,
                    dy: torch.Tensor) -> tuple[str, int]:
    """(body, vectors a lane) of the backward for these inputs:
    ``("warp_rows", n)`` (rows of 16-byte vectors up to 1024 elements),
    ``("cta_rows", n)`` (such rows of 1025 to 8192 elements) or
    ``("generic", 0)``.

    A pure function of dtype, shape and base addresses, on any device.
    Raises on what the forward takes no body for, and on a dy unlike x."""
    body, vpl = select_body(x, scale)
    _check_dy(x, dy)
    if not dy.is_contiguous() or dy.data_ptr() % 16:
        return _GENERIC
    return _bwd_body(body, vpl, x.shape[-1], x.dtype, scale.dtype,
                     x.data_ptr() % 16 == 0 and scale.data_ptr() % 16 == 0)


def _check_dy(x: torch.Tensor, dy: torch.Tensor) -> None:
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dy {dy.dtype} {tuple(dy.shape)} does not match x "
                         f"{x.dtype} {tuple(x.shape)}")


def _bwd_body(body: str, vpl: int, D: int, x_dtype, s_dtype,
              aligned: bool = True) -> tuple[str, int]:
    """The backward's body from the forward's (``body``, ``vpl``) for rows
    of D elements: bases 16-byte aligned unless ``aligned`` is False."""
    if (body == "one_read"
            and vpl * 16 // _SIZES[x_dtype] <= BWD_LANE_FLOATS):
        return "warp_rows", vpl
    # rows of 16-byte vectors of x, dy and scale past a warp's reach; the
    # forward's limits on one_read do not apply
    if D * _SIZES[x_dtype] % 16 or D * _SIZES[s_dtype] % 16 or not aligned:
        return _GENERIC
    warps, vpl = cta_shape(D, x_dtype)
    if 1 < warps <= BWD_CTA_MAX_WARPS:
        return "cta_rows", vpl
    return _GENERIC


def bwd_body_for(D: int, x_dtype: torch.dtype,
                 s_dtype: torch.dtype) -> tuple[str, int]:
    """``select_bwd_body``'s choice for rows of D elements on 16-byte
    aligned, contiguous operands, from the shape and dtypes alone."""
    return _bwd_body(*body_for(D, x_dtype, s_dtype), D, x_dtype, s_dtype)


def rmsnorm_cost(rows: int, D: int, dtype: torch.dtype,
                 scale_dtype: torch.dtype, residual: bool = False) -> Cost:
    """One forward over (rows, D): x (and the residual) and scale read
    once, y written once; about 4 operations an element (5 with the
    residual's add), the statistics in fp32."""
    n = rows * D
    return Cost(bytes=(2 + residual) * n * _SIZES[dtype]
                + D * _SIZES[scale_dtype],
                ops=(4 + residual) * n, unit="fp32",
                flops=(4 + residual) * n)


def rmsnorm_bwd_cost(rows: int, D: int, dtype: torch.dtype,
                     scale_dtype: torch.dtype) -> Cost:
    """One backward over (rows, D): x, dy and scale read once, dx and
    dscale written once; about 10 operations an element, in fp32."""
    n = rows * D
    return Cost(bytes=3 * n * _SIZES[dtype] + 2 * D * _SIZES[scale_dtype],
                ops=10 * n, unit="fp32", flops=10 * n)


def _partial_shape(body: str, rows: int, D: int, x_dtype,
                   sms: int) -> tuple[tuple, torch.dtype, tuple]:
    """(shape, dtype, the launch's grid arguments) of the backward's
    partial sums of dscale on ``body`` over a card of ``sms`` SMs."""
    if body == "warp_rows":
        per_warp, ctas = bwd_grid(rows, sms)
        return (ctas, D), torch.float64, (per_warp, ctas)
    if body == "cta_rows":
        warps = cta_shape(D, x_dtype)[0]
        per_cta, ctas = cta_grid(rows, sms, warps)
        return (ctas, D), torch.float64, (warps, per_cta, ctas)
    blocks = min(rows, BWD_MAX_BLOCKS)
    # each CTA's partial sums of dscale and their compensations
    return (2, blocks, D), torch.float32, (blocks,)


def rmsnorm_cuda(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6,
                 residual: torch.Tensor | None = None) -> torch.Tensor:
    """y = x * rsqrt(mean(x²) + eps) * scale (+ residual) on the card.

    x (..., D) fp32 or bf16, contiguous; scale (D,) fp32 or bf16; residual
    like x.  Output in ``x.dtype``.  Raises on anything else, and on inputs
    that require grad while grad mode is on (``RMSNormFunction`` takes
    those)."""
    refuse_grad("rmsnorm_cuda", (x, scale, residual),
                "call kernels.ops.rmsnorm, which differentiates it")
    if not x.is_cuda:
        raise ValueError(f"rmsnorm_cuda takes CUDA tensors, got {x.device}")
    if fake(x):
        return _rmsnorm_twin(x, scale, residual)
    body, vpl = select_body(x, scale, residual)
    y = torch.empty_like(x)
    D = x.shape[-1]
    rows = x.numel() // D if D else 0
    if rows == 0:
        return y
    args = (x.data_ptr(), scale.data_ptr(),
            None if residual is None else residual.data_ptr(), y.data_ptr(),
            rows, D, eps, _DTYPES[x.dtype], _DTYPES[scale.dtype], vpl)
    # A decode step launches this some 50 times, each bound by the host's
    # launch path: enter a device guard only when x is not on the current
    # device.
    if x.device.index == torch.cuda.current_device():
        err = _entry()(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(x.device):
            err = _entry()(*args, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"rmsnorm kernel launch failed ({body} body): "
                           f"CUDA error {err}")
    count_launch(rmsnorm_cuda, body)
    return y


def _rmsnorm_twin(x, scale, residual):
    """``rmsnorm_cuda`` on fake tensors: y, and the cost charged on the
    body the shapes select; nothing launched."""
    check_inputs(x, scale, residual)
    y = torch.empty_like(x)
    D = x.shape[-1]
    rows = x.numel() // D if D else 0
    if rows:
        charge("rmsnorm", rmsnorm_cost(rows, D, x.dtype, scale.dtype,
                                       residual is not None),
               body_for(D, x.dtype, scale.dtype)[0])
    return y


def rmsnorm_bwd_cuda(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                     *, eps: float = 1e-6):
    """(dx in ``x.dtype``, dscale in ``scale.dtype``) of
    y = x * rsqrt(mean(x²) + eps) * scale, given dy = dL/dy (like x).

    The inputs ``rmsnorm_cuda`` takes (any row the forward takes: every
    width, fp32 or bf16, statistics in fp32); dy is made contiguous.  A
    residual's gradient is dy itself and needs no kernel.  dscale is summed
    in a fixed order: the same bits on every run on one card."""
    if not x.is_cuda:
        raise ValueError(f"rmsnorm_bwd_cuda takes CUDA tensors, got "
                         f"{x.device}")
    dy = dy.contiguous()
    if fake(x):
        return _rmsnorm_bwd_twin(x, scale, dy)
    body, vpl = select_bwd_body(x, scale, dy)
    D = x.shape[-1]
    rows = x.numel() // D if D else 0
    if rows == 0:
        return torch.zeros_like(x), torch.zeros_like(scale)
    dx, dscale = torch.empty_like(x), torch.empty_like(scale)
    shape, dtype, grid = _partial_shape(body, rows, D, x.dtype,
                                        multiprocessors(x.device))
    partial = torch.empty(shape, dtype=dtype, device=x.device)
    tail = (vpl, *grid) if body != "generic" else grid
    args = (x.data_ptr(), scale.data_ptr(), dy.data_ptr(), dx.data_ptr(),
            dscale.data_ptr(), partial.data_ptr(), rows, D, eps,
            _DTYPES[x.dtype], _DTYPES[scale.dtype], *tail)
    if x.device.index == torch.cuda.current_device():
        err = _bwd_entry(body)(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(x.device):
            err = _bwd_entry(body)(*args,
                                   torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"rmsnorm backward launch failed ({body} body): "
                           f"CUDA error {err}")
    count_launch(rmsnorm_bwd_cuda, body)
    return dx, dscale


def _rmsnorm_bwd_twin(x, scale, dy):
    """``rmsnorm_bwd_cuda`` on fake tensors: dx, dscale and the partial sums
    the launch allocates (grids for ``H100_SMS``), the cost charged on the
    body the shapes select; nothing launched."""
    check_inputs(x, scale)
    _check_dy(x, dy)
    D = x.shape[-1]
    rows = x.numel() // D if D else 0
    if rows == 0:
        return torch.zeros_like(x), torch.zeros_like(scale)
    dx, dscale = torch.empty_like(x), torch.empty_like(scale)
    body = bwd_body_for(D, x.dtype, scale.dtype)[0]
    shape, dtype, _ = _partial_shape(body, rows, D, x.dtype, H100_SMS)
    torch.empty(shape, dtype=dtype, device=x.device)
    charge("rmsnorm_bwd", rmsnorm_bwd_cost(rows, D, x.dtype, scale.dtype),
           body)
    return dx, dscale


class RMSNormFunction(torch.autograd.Function):
    """``rmsnorm_cuda`` forward, ``rmsnorm_bwd_cuda`` backward (the
    residual's gradient is dy)."""

    @staticmethod
    def forward(ctx, x, scale, residual, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        ctx.has_residual = residual is not None
        return rmsnorm_cuda(x, scale, eps=eps, residual=residual)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dx, dscale = rmsnorm_bwd_cuda(x, scale, dy, eps=ctx.eps)
        return dx, dscale, dy if ctx.has_residual else None, None


def reset_counts() -> None:
    """Set the launch counts (forward and backward, total and by body)
    to 0."""
    rmsnorm_cuda.launches = 0
    rmsnorm_cuda.launches_by_body = dict.fromkeys(BODIES, 0)
    rmsnorm_bwd_cuda.launches = 0
    rmsnorm_bwd_cuda.launches_by_body = dict.fromkeys(BWD_BODIES, 0)


reset_counts()
