"""Forward flash attention as a CUDA kernel for Hopper.

The kernel is ``csrc/flash_attention.cu``; it replaces the TPU kernel
``flash_attention_pallas`` for the self-attention layout (training and
prefill: Sq == Sk, default positions, no softcap) at any S.  Its plain
version is ``ref.mha_ref``.

Four bodies, chosen by ``select_body`` from the dtype, the head dim and the
layout of q, k and v (never by trying one and falling back):

* ``sm90``: bf16 at dh 80, 120, 128, 160 or 256 (``SM90_HEAD_DIMS``: the
  served archs, hubert-xlarge's encode, stablelm-3b, stablelm-12b,
  h2o-danube-3-4b) with 16-byte aligned bases and batch / sequence / head
  strides, as TMA needs, and a softmax scale > 0: wgmma, TMA and warp
  specialisation.  Each of the two consumer warpgroups owns 64 rows of a
  128-row query tile and all of O's columns, over 128-key tiles at dh 80,
  120 and 128 and 64-key tiles at dh 160 (O's 160 columns are 80 registers
  a thread); at dh 256 both take the same 64 rows and each owns half of
  O's columns.  A row is held as 64-column slabs, TMA zero-filling the
  columns past dh (dh 80, 120 and 160).
* ``mma``: every other bf16 input (dh 16, 32 and 64, unaligned views at
  any head dim, a scale <= 0): mma.sync tiles; the sm90 body's previous
  body, forced by ``body="mma"``.
* ``mma_tf32x3``: float32 at every head dim (``TF32_HEAD_DIMS``, the
  training path): FlashAttention-2 on mma.sync m16n8k8 TF32, Q·Kᵀ and P·V
  each three TF32 products from hi + lo splits by truncation
  (``ref.mha_fwd_by_products`` with ``tf32x3_trunc`` models it); at dh 160
  and 256 a CTA has 8 warps, two to each 16-row group, each forming half
  of a tile's scores and accumulating half of O's columns.
* ``fp32``: float32 on the FMA units, the previous body of every float32
  input, forced by ``body="fp32"``.

``flash_attention_cuda.launches`` counts every launch,
``flash_attention_cuda.launches_by_body`` each body's and
``flash_attention_cuda.launches_by_head_dim`` each body's by head dim.

Training: ``FlashAttentionFunction`` is the ``torch.autograd.Function``
whose forward is ``flash_attention_cuda(..., return_lse=True)`` (every
body also writes each row's log-sum-exp; the sm90 body from its epilogue,
O unchanged) and whose backward is ``flash_attention_bwd_cuda``:
FlashAttention-2 without atomics on the tensor cores, at every head dim of
``HEAD_DIMS``, each full-width product formed once a pair of tiles (7),
in one of three bodies (``select_bwd_body`` decides from the dtype, the
head dim and the sign of the scale, and raises on the rest):

* ``sm90``: bfloat16 at dh 80, 120, 128, 160 and 256
  (``SM90_BWD_HEAD_DIMS``: stablelm-3b's, qwen2-vl-2b's, recurrentgemma-9b's
  and stablelm-12b's bf16 train steps, hubert-xlarge's and
  h2o-danube-3-4b's heads) with a scale > 0: wgmma, TMA and warp
  specialisation, compiled for dh 80, 128, 160 and 256 (120 on the 128
  instance, TMA zero-filling the columns past dh), P rounded to bf16 once
  for dV and dS as bf16 hi + lo for dK and dQ (``ref.mha_grads_by_products``
  with ``bf16_operands`` and ``ds_matmul=bf16_hilo`` models it), P as hi +
  lo too where a KV head has more than ``SM90_BWD_SPLIT_GROUP`` query
  heads; the dK/dV launch's CTAs take 64 keys (``SM90_BWD_KV_TILE``), one
  warpgroup accumulating dV, the other dK.  Above dh 128 every sum is cut
  into two column halves (``sm90_bwd_halves``): the dQ launch's two
  warpgroups take the same 64 query rows (one forming S and P, the other
  dP and dS, handed across through shared memory), one half of dQ each,
  and the dK/dV launch has a grid axis of the two halves, each CTA forming
  S and dP whole and accumulating its half of dK and dV.
* ``mma_bf16``: every other bfloat16 input (dh 16-64, a scale <= 0),
  mma.sync with fp32 accumulation, above dh 80 P and dS in hi + lo bf16
  products; the sm90 body's previous body at dh 80-256, forced by
  ``body="mma_bf16"``.
* ``mma_tf32x3``: float32 (the training path), every operand split into
  TF32 hi + lo and each product formed from three TF32 products, which
  holds the fp32 tolerance (``ref.tf32x3`` models it).

The mma bodies run 4 warps a CTA up to dh 80 and above it CTAs of 8 warps
(120 padded to 128), two (four at 256) to each 16-row group splitting the
forming of S and dP.  Its calls are counted in
``flash_attention_bwd_cuda.launches`` (and ``launches_by_body``, and
``launches_by_head_dim`` each body's by head dim).
Called outside that Function, ``flash_attention_cuda`` refuses inputs that
require grad (its output has no ``grad_fn``).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ...device import multiprocessors
from .. import _build
from .._grad import refuse_grad
from .._twin import H100_SMS, Cost, charge, count_launch, fake

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# every head dim of the config registry (120 is padded to 128 in the kernel)
HEAD_DIMS = (16, 32, 64, 80, 120, 128, 160, 256)
SM90_HEAD_DIMS = (80, 120, 128, 160, 256)
BODIES = ("sm90", "mma", "mma_tf32x3", "fp32")
# the float32 head dims the mma_tf32x3 body takes (120 padded to 128): all
TF32_HEAD_DIMS = HEAD_DIMS
# the backward: every head dim the forward takes
BWD_HEAD_DIMS = HEAD_DIMS
BWD_BODIES = ("mma_tf32x3", "mma_bf16", "sm90")
SM90_BWD_HEAD_DIMS = (80, 120, 128, 160, 256)
# the mma bodies' dK/dV CTAs: one a (tile of keys, KV head, batch), every
# column of dK and dV, the tiles as csrc/flash_attention.cu cuts the keys
# (BwdCfg up to dh 80, BwdPairCfg::kKvRows above)
BWD_KV_TILE = {16: 64, 32: 64, 64: 64, 80: 64, 120: 64, 128: 64, 160: 64, 256: 32}
# the sm90 body's: 64 keys, one warpgroup accumulating dV, one dK (Sm90Bwd),
# each CTA a column half of them above dh 128 (sm90_bwd_halves)
SM90_BWD_KV_TILE = 64
# above this many query heads a KV head the sm90 body forms P in hi + lo
# bf16 products too (csrc/flash_attention.cu: kSm90SplitGroup)
SM90_BWD_SPLIT_GROUP = 8
# the dK/dV launch splits each KV head's group of query heads over CTAs
# until it has this many CTAs an SM (bwd_head_split): 6 gives
# recurrentgemma-9b's step 16 splits and stablelm-12b's heads 4, the
# fastest of the splits each group allows on the H100 (PERF.md)
BWD_FILL = 6
# the sm90 body's dK/dV launch: the smallest divisor of the group that
# reaches this many CTAs an SM: qwen2-vl-2b's step (128 CTAs unsplit) takes
# 2, h2o-danube-3-4b's heads (256) none, the fastest of each's splits on the
# H100 (kernels/ab.py --sm90-bwd, PERF.md)
SM90_BWD_FILL = 1.5


def sm90_bwd_halves(dh: int) -> int:
    """The column halves the sm90 backward cuts each 64 x dh sum into
    (``Sm90Bwd::kHalves``): 2 above dh 128, where a whole one does not fit
    a warpgroup's registers beside S and dP, else 1."""
    return 2 if dh > 128 else 1


def _entry(name: str):
    """A forward entry point: flash_attention_fwd (the mma and fp32 bodies:
    a dtype code and the lse pointer last), flash_attention_fwd_tf32 or
    flash_attention_fwd_sm90 (the lse pointer last)."""
    fn = getattr(_build.load("flash_attention"), name)
    if fn.argtypes is None:
        P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        tail = {"flash_attention_fwd": [I, P], "flash_attention_fwd_tf32": [P],
                "flash_attention_fwd_sm90": [P]}[name]
        fn.argtypes = [P, P, P, P, I, I, I, I, *([LL] * 9), I, I, I,
                       ctypes.c_float, I, *tail, P]
        fn.restype = ctypes.c_int
    return fn


def _bwd_entry(body: str):
    """The backward entry point of ``body``: flash_attention_bwd (the mma
    bodies; a dtype code picks one) or flash_attention_bwd_sm90, with the
    same arguments."""
    name = "flash_attention_bwd_sm90" if body == "sm90" else \
        "flash_attention_bwd"
    fn = getattr(_build.load("flash_attention"), name)
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [*([P] * 10), *([I] * 7), ctypes.c_float, I, I, I, P, P]
        fn.restype = I
    return fn


def bwd_head_split(B: int, S: int, H: int, K: int, dh: int, sms: int,
                   body: str = "mma_bf16") -> int:
    """The CTAs the backward's dK/dV launch splits each KV head's group of
    H / K query heads over, on a card of ``sms`` SMs.  On the mma bodies:
    1 at head dims up to 80 (those kernels have no split: their registers
    are at ptxas's limit), else the fewest, doubling, that reach
    ``BWD_FILL`` CTAs an SM while they divide the group.  On ``sm90``, at
    each of its head dims (80 too): the smallest divisor of the group (any,
    3 and 6 too) that reaches ``SM90_BWD_FILL`` CTAs an SM, else the whole
    group, the CTAs counted over both column halves above dh 128
    (``sm90_bwd_halves``).  recurrentgemma-9b's MQA step (B 4, S 512, 16
    heads, one KV head, dh 256) has, on the mma bodies, 16 x 4 = 64 CTAs of
    32 keys, each walking 16 heads, and the key tile at the diagonal's start
    sees 16 times the query tiles of the last: 16 splits, 1024 CTAs of one
    head; stablelm-12b's heads (32 over 8 KV heads, dh 160) 256 CTAs of 4
    heads, split 4 ways.  On sm90, stablelm-3b's MHA step (B 4, S 1024, 32
    heads, dh 80) has 16 x 32 x 4 = 2048 CTAs and nothing to split; a GQA
    28 / 4 group at S 1000, batch 1, 16 x 4 = 64 CTAs, split 7 ways (448
    CTAs); recurrentgemma-9b's step 8 x 4 x 2 = 64 CTAs, split 4 ways, and
    at its train_4k shape (B 1, S 4096) 64 x 2 = 128, split 2 ways;
    stablelm-12b's 512 and 1024, none."""
    G, split = H // K, 1
    if body == "sm90":
        ctas = -(-S // SM90_BWD_KV_TILE) * K * B * sm90_bwd_halves(dh)
        return next(d for d in range(1, G + 1)
                    if G % d == 0 and (ctas * d >= SM90_BWD_FILL * sms
                                       or d == G))
    ctas = -(-S // BWD_KV_TILE[dh]) * K * B
    if dh <= 80:
        return split
    while ctas * split < BWD_FILL * sms and G % (2 * split) == 0:
        split *= 2
    return split


def check_head_split(H: int, K: int, dh: int, head_split: int,
                     body: str) -> None:
    """Raise unless the dK/dV launch of ``body`` takes ``head_split``: a
    divisor of the H / K query heads of a KV head, and 1 on the mma bodies
    at head dims up to 80 (their 4-warp kernels have no split).  The sm90
    body splits at every head dim it takes."""
    if head_split < 1 or (H // K) % head_split:
        raise ValueError(f"head_split {head_split} does not divide the "
                         f"{H // K} query heads of a KV head")
    if body != "sm90" and dh <= 80 and head_split > 1:
        raise ValueError(f"head_split {head_split}: the {body} body has no "
                         f"split at head dim {dh} (at most 80)")


def tma_strides(t: torch.Tensor) -> tuple[int, int, int]:
    """Batch, sequence and head strides of a (B, S, heads, dh) tensor, with
    the stride of a dim of size 1 (never stepped over) replaced by its packed
    value, so that only the strides the kernel walks decide the body."""
    sb, ss, sh, _ = t.stride()
    B, S, n, dh = t.shape
    return (S * n * dh if B == 1 else sb, n * dh if S == 1 else ss,
            dh if n == 1 else sh)


def _tma_ok(t: torch.Tensor) -> bool:
    """TMA reads a bf16 tensor whose base and walked strides are positive
    multiples of 16 bytes."""
    sb, ss, sh = tma_strides(t)
    return (t.data_ptr() % 16 == 0 and sb > 0 and ss > 0 and sh > 0
            and sb % 8 == 0 and ss % 8 == 0 and sh % 8 == 0)


def select_body(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                scale: float | None = None) -> str:
    """The body that takes q (B,S,H,dh), k, v (B,S,K,dh) and the softmax
    scale (None: dh ** -0.5), one of ``BODIES``: the first of
    ``bodies_for``.

    A pure function of dtype, shape, base address, strides and the sign of
    the scale (the sm90 body takes the row max of the raw scores, which is
    the max of the scaled ones for a scale > 0), on any device.  Raises on
    what no body takes: another dtype, a head dim outside ``HEAD_DIMS``, H
    not a multiple of K, Sq != Sk, a last dim that is not contiguous."""
    return bodies_for(q, k, v, scale)[0]


def bodies_for(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               scale: float | None = None) -> tuple[str, ...]:
    """The bodies that take these inputs, the one ``select_body`` picks
    first: bfloat16 takes ``sm90`` (dh in ``SM90_HEAD_DIMS``, TMA-aligned,
    scale > 0) and ``mma``; float32 takes ``mma_tf32x3`` (dh in
    ``TF32_HEAD_DIMS``) and ``fp32``.  Raises as ``select_body``."""
    check_inputs(q, k, v)
    return _bodies(q.dtype, q.shape[3], scale,
                   lambda: _tma_ok(q) and _tma_ok(k) and _tma_ok(v))


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise on what no body takes: another dtype, a head dim outside
    ``HEAD_DIMS``, H not a multiple of K, Sq != Sk, a last dim that is not
    contiguous, operands on two devices.  Reads no base address."""
    qs, ks = q.shape, k.shape
    if len(qs) != 4 or len(ks) != 4 or ks != v.shape:
        raise ValueError(f"expected q (B,S,H,dh), k/v (B,S,K,dh); got "
                         f"{tuple(qs)}, {tuple(ks)}, {tuple(v.shape)}")
    B, S, H, dh = qs
    K = ks[2]
    if ks[0] != B or ks[1] != S or ks[3] != dh:
        raise ValueError("flash_attention_cuda takes self-attention shapes "
                         f"(Sq == Sk): q {tuple(qs)}, k {tuple(ks)}")
    if K == 0 or H % K:
        raise ValueError(f"num_heads {H} is not a multiple of kv heads {K}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"head_dim {dh} not in {HEAD_DIMS}")
    dtype = q.dtype
    if dtype not in _DTYPES or k.dtype != dtype or v.dtype != dtype:
        raise TypeError(f"flash_attention_cuda takes float32/bfloat16 of one "
                        f"dtype, got {dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention_cuda operands must share one device")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flash_attention_cuda needs a contiguous last dim")


def _bodies(dtype: torch.dtype, dh: int, scale: float | None,
            tma=None) -> tuple[str, ...]:
    """``bodies_for`` from the dtype, head dim, scale and ``tma``, asked
    last: a function that says whether TMA reads every operand (None for
    fake tensors, which have no base: taken to)."""
    if dtype == torch.float32:
        return ("mma_tf32x3", "fp32") if dh in TF32_HEAD_DIMS else ("fp32",)
    if (dh in SM90_HEAD_DIMS and (scale is None or scale > 0)
            and (tma is None or tma())):
        return ("sm90", "mma")
    return ("mma",)


def _bwd_bodies(dtype: torch.dtype, dh: int,
                scale: float | None) -> tuple[str, ...]:
    if dtype == torch.float32:
        return ("mma_tf32x3",)
    if dh in SM90_BWD_HEAD_DIMS and (scale is None or scale > 0):
        return ("sm90", "mma_bf16")
    return ("mma_bf16",)


@functools.lru_cache(maxsize=256)
def visible_pairs(S: int, causal: bool = True, window: int = 0,
                  chunk: int = 0) -> int:
    """The (query, key) pairs of one head that the mask lets attend at
    self-attention length S: ``attention_mask(pos, pos, ...).sum()``
    without forming the S x S mask."""
    q = np.arange(S, dtype=np.int64)
    lo = np.zeros(S, dtype=np.int64)
    hi = q.copy() if causal else np.full(S, S - 1, dtype=np.int64)
    if window:
        lo = np.maximum(lo, q - window + 1)
    if chunk:
        lo = np.maximum(lo, q // chunk * chunk)
        hi = np.minimum(hi, (q // chunk + 1) * chunk - 1)
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_attention_cost(B: int, S: int, H: int, K: int, dh: int,
                         dtype: torch.dtype, pairs: int,
                         lse: bool = False) -> Cost:
    """One forward over ``pairs`` visible pairs a head: q, k and v read
    once, O (and the lse, fp32) written once; the two products of the
    visible pairs (S = Q Kᵀ, O = P V), on the bf16 tensor cores in bf16,
    in fp32 as three TF32 products each (the mma_tf32x3 body)."""
    e = dtype.itemsize
    n_bytes = (2 * B * S * H + 2 * B * S * K) * dh * e \
        + (B * H * S * 4 if lse else 0)
    flops = 2 * 2 * B * H * pairs * dh
    if dtype == torch.float32:
        return Cost(n_bytes, 3 * flops, "tf32", flops)
    return Cost(n_bytes, flops, "bf16", flops)


def flash_bwd_split_macs(B: int, H: int, pairs: int, dh: int) -> int:
    """Multiply-adds the flash-attention backward's fp32 body needs on the
    TF32 tensor cores: the five products of ``pairs`` (query, key) pairs x
    dh a head (S = Q Kᵀ, dP = dO Vᵀ, dV = Pᵀ dO, dQ = dS K, dK = dSᵀ Q),
    each formed from three TF32 products (hi·hi, hi·lo, lo·hi)."""
    return 3 * 5 * B * H * pairs * dh


def flash_bwd_bf16_ops(B: int, H: int, pairs: int, dh: int) -> int:
    """Operations of the bf16 backward: the five products of
    ``flash_bwd_split_macs`` once each on the bf16 tensor cores, 2 a
    multiply-add."""
    return 2 * flash_bwd_split_macs(B, H, pairs, dh) // 3


def flash_attention_bwd_cost(B: int, S: int, H: int, K: int, dh: int,
                             dtype: torch.dtype, pairs: int) -> Cost:
    """One backward: q, k, v, O, dO and the lse read once, dq, dk and dv
    written once; the five products of the visible pairs, in fp32 as three
    TF32 products each (``flash_bwd_split_macs``), in bf16 once each
    (``flash_bwd_bf16_ops``)."""
    e = dtype.itemsize
    q_bytes, kv_bytes = B * S * H * dh * e, B * S * K * dh * e
    n_bytes = 2 * (q_bytes + 2 * kv_bytes) + 2 * q_bytes + B * H * S * 4
    flops = flash_bwd_bf16_ops(B, H, pairs, dh)
    if dtype == torch.float32:
        return Cost(n_bytes, 2 * flash_bwd_split_macs(B, H, pairs, dh),
                    "tf32", flops)
    return Cost(n_bytes, flops, "bf16", flops)


def select_bwd_body(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float | None = None) -> str:
    """The backward body for these inputs, one of ``BWD_BODIES``: the first
    of ``bwd_bodies_for``, on any device, whichever forward body wrote the
    log-sum-exp."""
    return bwd_bodies_for(q, k, v, scale)[0]


def bwd_bodies_for(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   scale: float | None = None) -> tuple[str, ...]:
    """The backward bodies that take these inputs, the one
    ``select_bwd_body`` picks first: float32 ``mma_tf32x3``; bfloat16
    ``sm90`` (dh in ``SM90_BWD_HEAD_DIMS``, scale > 0) and ``mma_bf16``.  A
    pure function of dtype, head dim and the sign of the scale: the wrapper
    makes every operand contiguous before the launch, so views and strides
    do not count.  Raises on what no forward body takes (``select_body``:
    a head dim outside ``HEAD_DIMS`` among them)."""
    select_body(q, k, v, scale)
    return _bwd_bodies(q.dtype, q.shape[3], scale)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: int = 0, chunk: int = 0,
                         scale: float | None = None,
                         return_lse: bool = False, body: str | None = None):
    """q (B,S,H,dh); k, v (B,S,K,dh) -> (B,S,H,dh) in ``q.dtype``, and with
    ``return_lse`` also each row's log-sum-exp of its scaled scores, (B,H,S)
    fp32 (every body writes it; O is the same with it or without).

    fp32 or bf16; dh one of ``HEAD_DIMS``; H a multiple of K; the last dim
    of each input contiguous (the others are read through strides).
    ``body`` (default: the one ``select_body`` picks) names one of
    ``bodies_for`` these inputs.  Raises on anything else, and on inputs
    that require grad while grad mode is on (``FlashAttentionFunction``
    takes those)."""
    refuse_grad("flash_attention_cuda", (q, k, v),
                "call kernels.ops.flash_attention, which differentiates it")
    if not q.is_cuda:
        raise ValueError(f"flash_attention_cuda takes CUDA tensors, got "
                         f"{q.device}")
    if fake(q):
        return _flash_twin(q, k, v, causal, window, chunk, scale, return_lse,
                           body)
    takes = bodies_for(q, k, v, scale)
    body = takes[0] if body is None else body
    if body not in takes:
        raise ValueError(f"body {body!r} does not take these inputs ({q.dtype}"
                         f", head dim {q.shape[3]}: {takes})")
    if window < 0 or chunk < 0:
        raise ValueError("window and chunk must be >= 0")
    B, S, H, dh = q.shape
    if B > 65535 or H > 65535:
        raise ValueError("batch and heads are limited to 65535")
    out = torch.empty((B, S, H, dh), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    scale = scale if scale is not None else dh ** -0.5
    lse_ptr = None if lse is None else lse.data_ptr()
    if body == "sm90":
        fn, strides, tail = _entry("flash_attention_fwd_sm90"), \
            [s for t in (q, k, v) for s in tma_strides(t)], (lse_ptr,)
    elif body == "mma_tf32x3":
        fn, strides, tail = _entry("flash_attention_fwd_tf32"), \
            [s for t in (q, k, v) for s in t.stride()[:3]], (lse_ptr,)
    else:
        fn, strides, tail = _entry("flash_attention_fwd"), \
            [s for t in (q, k, v) for s in t.stride()[:3]], \
            (_DTYPES[q.dtype], lse_ptr)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, S, H, k.shape[2], *strides, int(causal), window, chunk,
                 scale, dh, *tail, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed ({body} "
                           f"body): CUDA error {err}")
    _count(flash_attention_cuda, body, dh)
    return (out, lse) if return_lse else out


def _count(fn, body: str, dh: int) -> None:
    count_launch(fn, body)
    by_dh = fn.launches_by_head_dim[body]
    by_dh[dh] = by_dh.get(dh, 0) + 1


def _check_body(body: str, takes: tuple, what: str, q) -> str:
    picked = takes[0] if body is None else body
    if picked not in takes:
        raise ValueError(f"{what} {picked!r} does not take these inputs "
                         f"({q.dtype}, head dim {q.shape[3]}: {takes})")
    return picked


def _flash_twin(q, k, v, causal, window, chunk, scale, return_lse, body):
    """``flash_attention_cuda`` on fake tensors: O and the lse the launch
    allocates, the cost of the visible pairs charged on the body the
    shapes select (TMA taken to read every operand); nothing launched."""
    check_inputs(q, k, v)
    body = _check_body(body, _bodies(q.dtype, q.shape[3], scale), "body", q)
    if window < 0 or chunk < 0:
        raise ValueError("window and chunk must be >= 0")
    B, S, H, dh = q.shape
    out = torch.empty((B, S, H, dh), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if out.numel():
        charge("flash_attention", flash_attention_cost(
            B, S, H, k.shape[2], dh, q.dtype,
            visible_pairs(S, causal, window, chunk), return_lse), body)
    return (out, lse) if return_lse else out


def flash_attention_bwd_cuda(q, k, v, o, do, lse, *, causal: bool = True,
                             window: int = 0, chunk: int = 0,
                             scale: float | None = None,
                             head_split: int | None = None,
                             body: str | None = None):
    """(dq, dk, dv) of ``flash_attention_cuda(q, k, v, ...)``, given its
    output ``o`` and log-sum-exp ``lse`` (B,H,S) fp32 and ``do`` = dL/do.

    The inputs ``select_bwd_body`` takes; ``body`` (default: the one it
    picks) names one of ``bwd_bodies_for`` these inputs, and raises on
    another.  Every tensor is made contiguous (the kernels load tiles by
    16-byte copies or TMA and raise on a base that is not 16-byte
    aligned).  Two launches (dQ and D = rowsum(dO·O), then dK / dV), and a
    third that sums the dK / dV launch's partial sums in a fixed order
    where ``head_split`` (default ``bwd_head_split``'s for the body; a
    divisor of H / K) splits its heads, counted as one call; no atomics,
    so two runs give the same bits.  On fake tensors (``_twin``) the
    outputs, D and the partial sums are allocated for ``H100_SMS`` SMs and
    the cost charged; nothing launches."""
    shape_only = fake(q)
    if shape_only:
        check_inputs(q, k, v)
        takes = _bwd_bodies(q.dtype, q.shape[3], scale)
    else:
        takes = bwd_bodies_for(q, k, v, scale)
    body = _check_body(body, takes, "backward body", q)
    if not q.is_cuda:
        raise ValueError(f"flash_attention_bwd_cuda takes CUDA tensors, got "
                         f"{q.device}")
    B, S, H, dh = q.shape
    K = k.shape[2]
    if o.shape != q.shape or do.shape != q.shape or lse.shape != (B, H, S):
        raise ValueError(f"o {tuple(o.shape)}, do {tuple(do.shape)} or lse "
                         f"{tuple(lse.shape)} do not match q {tuple(q.shape)}")
    if o.dtype != q.dtype or do.dtype != q.dtype or lse.dtype != torch.float32:
        raise TypeError("o and do must have q's dtype, lse float32")
    if window < 0 or chunk < 0:
        raise ValueError("window and chunk must be >= 0")
    if B > 65535 or H > 65535:
        raise ValueError("batch and heads are limited to 65535")
    q, k, v, o, do, lse = (t.contiguous() for t in (q, k, v, o, do, lse))
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if dq.numel() == 0:
        return dq, dk, dv
    # D = rowsum(dO·O), written by the dQ launch for the dK/dV launch; the
    # sm90 body's holds lse·log2(e) too, rows padded to 128 for its bulk
    # copies
    delta = torch.empty((2, B, H, -(-S // 128) * 128) if body == "sm90"
                        else (B, H, S), dtype=torch.float32, device=q.device)
    scale = scale if scale is not None else dh ** -0.5
    if head_split is None:
        head_split = bwd_head_split(
            B, S, H, K, dh,
            H100_SMS if shape_only else multiprocessors(q.device), body)
    check_head_split(H, K, dh, head_split, body)
    partial = (torch.empty((2, head_split, B, S, K, dh), dtype=torch.float32,
                           device=q.device) if head_split > 1 else None)
    if shape_only:
        charge("flash_attention_bwd", flash_attention_bwd_cost(
            B, S, H, K, dh, q.dtype, visible_pairs(S, causal, window, chunk)),
            body)
        return dq, dk, dv
    with torch.cuda.device(q.device):
        err = _bwd_entry(body)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), B, S, H, K, int(causal), window,
            chunk, scale, dh, _DTYPES[q.dtype], head_split,
            None if partial is None else partial.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention backward launch failed ({body} "
                           f"body): CUDA error {err}")
    _count(flash_attention_bwd_cuda, body, dh)
    return dq, dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """``flash_attention_cuda`` forward (with its log-sum-exp),
    ``flash_attention_bwd_cuda`` backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, chunk, scale):
        # raise before the forward runs (a fake q has no base to select by)
        if fake(q):
            check_inputs(q, k, v)
        else:
            select_bwd_body(q, k, v, scale)
        out, lse = flash_attention_cuda(q, k, v, causal=causal, window=window,
                                        chunk=chunk, scale=scale,
                                        return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = dict(causal=causal, window=window, chunk=chunk,
                        scale=scale)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_cuda(q, k, v, out, do, lse,
                                              **ctx.mask)
        return dq, dk, dv, None, None, None, None


def reset_counts() -> None:
    """Set the launch counts (forward and backward, total, by body and by
    body and head dim) to 0."""
    flash_attention_cuda.launches = 0
    flash_attention_cuda.launches_by_body = dict.fromkeys(BODIES, 0)
    flash_attention_cuda.launches_by_head_dim = {b: {} for b in BODIES}
    flash_attention_bwd_cuda.launches = 0
    flash_attention_bwd_cuda.launches_by_body = dict.fromkeys(BWD_BODIES, 0)
    flash_attention_bwd_cuda.launches_by_head_dim = {b: {} for b in BWD_BODIES}


reset_counts()
