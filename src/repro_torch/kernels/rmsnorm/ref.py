"""Plain PyTorch RMSNorm: the CPU path and the oracle for the CUDA kernel.

``rmsnorm_dscale_ordered`` models the order in which the backward kernel's
warp_rows and cta_rows bodies sum dscale; the tests hold it against JAX,
nothing on the CPU path calls it."""
from __future__ import annotations

import torch


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6,
                residual: torch.Tensor | None = None) -> torch.Tensor:
    """y = x / rms(x) * scale, statistics in fp32; the optional residual is
    added after scaling (the fused epilogue case).  Output in ``x.dtype``."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * (var + eps) ** -0.5
    y = y * scale.float()
    if residual is not None:
        y = y + residual.float()
    return y.to(x.dtype)


def rmsnorm_dscale_ordered(x: torch.Tensor, dy: torch.Tensor, *,
                           eps: float = 1e-6, rows_per_warp: int,
                           warps_per_cta: int = 4,
                           reduce_warps: int = 32) -> torch.Tensor:
    """dscale = sum over rows of dy·x̂ (x̂ = x·rsqrt(mean(x²) + eps), in
    fp32), each term and every sum in fp64 and rounded to fp32 once at the
    end, summed in the order of the backward kernel's warp_rows body (and
    of its cta_rows body with ``rows_per_warp`` the rows a CTA and
    ``warps_per_cta=1``: a CTA's thread owns its columns over all its
    rows):

    1. warp w sums rows [w·rows_per_warp, (w+1)·rows_per_warp) in turn;
    2. each CTA adds its ``warps_per_cta`` warps' sums as a pairwise tree;
    3. per column, warp j of the reduction sums the CTA sums j,
       j + reduce_warps, ... in turn, and the ``reduce_warps`` results are
       added as a pairwise tree.

    Zero rows pad each stage to its shape (adding 0 changes no bit)."""
    D = x.shape[-1]
    xf, dyf = x.float().reshape(-1, D), dy.float().reshape(-1, D)
    rstd = torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    terms = dyf.double() * (xf * rstd).double()

    def padded(t, n):     # rows of t, zero-padded to a multiple of n
        pad = -t.shape[0] % n
        return torch.cat([t, t.new_zeros(pad, D)]) if pad else t

    def tree(t):          # (..., n, D), n a power of two: pairwise over n
        while t.shape[-2] > 1:
            half = t.shape[-2] // 2
            t = t[..., :half, :] + t[..., half:, :]
        return t[..., 0, :]

    rows = padded(terms, rows_per_warp).reshape(-1, rows_per_warp, D)
    warp = torch.zeros_like(rows[:, 0])
    for i in range(rows_per_warp):
        warp = warp + rows[:, i]
    cta = padded(warp, warps_per_cta).reshape(-1, warps_per_cta, D)
    cta = tree(cta)
    strided = padded(cta, reduce_warps).reshape(-1, reduce_warps, D)
    lane = torch.zeros_like(strided[0])
    for i in range(strided.shape[0]):
        lane = lane + strided[i]
    return tree(lane).float()
