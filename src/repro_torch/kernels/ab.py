"""Time variants of the flash-attention backward (or, with ``--forward``,
of the fp32 forward's mma_tf32x3 body; with ``--sm90``, of the bf16
forward's sm90 body) on one card, in turns.

    PYTHONPATH=src python -m repro_torch.kernels.ab [--forward | --sm90 | --sm90-bwd] \
        [--shape 100m|rgemma|stablelm] [--only WORD ...] A.cu B.cu [...]

Each argument is a copy of ``csrc/flash_attention.cu`` (edited by hand, for
an A/B of one change).  Each is built with the port's nvcc flags into
``build/ab/`` (the compiler's output kept there as ``<name>.log``), loaded
with ctypes, and its ``flash_attention_bwd`` run (with
``bwd_head_split``'s split), at the shapes of ``--shape`` (``SHAPES``):
``100m`` (the default), the 100m preset's training shapes (q (16,256,8,64),
k/v (16,256,4,64), fp32, causal) and a GQA group of 8 with a ragged S (q
(2,190,16,64), k/v (2,190,2,64)); ``rgemma``, recurrentgemma-9b's train
step (q (4,512,16,256), k/v (4,512,1,256), causal, window 2048: MQA at dh
256); ``stablelm``, stablelm-12b's heads at that batch (q (4,512,32,160),
k/v (4,512,8,160), causal): its error against autograd of ``mha_ref`` as a share of
the fp32 tolerance (``|got - want| / (2e-5 (1 + |want|))``, at most 1 to
pass), then its device time by kernel under ``torch.profiler``, per call
over 20 calls, in turns (A, B, ..., then back), beside SDPA's backward on
the same inputs.  Prints the ptxas registers and spills of each variant's
fp32 backward kernels and one JSON line per shape and variant; needs a
card and ``nvcc``.  ``--forward`` does the same for
``flash_attention_fwd_tf32`` with the log-sum-exp: o against ``mha_ref``
and lse against a float64 evaluation as shares of the fp32 tolerance,
beside SDPA's fp32 forward.

``--sm90`` does it for the bf16 forward's sm90 body
(``flash_attention_fwd_sm90`` with the log-sum-exp) at each of its head
dims (``SM90_CHECKS``: dh 80, 120, 128, 160 and 256, ragged S, GQA, MHA
and MQA, causal, window, chunk and no mask; o as a share of the bf16
tolerance 2e-2 (1 + |o|), lse of 2e-5 (1 + |lse|), both against the plain
versions in fp32; then hubert-xlarge's encode layer, q drawn at std 4, on
its first and last 256 rows), then times it at ``SM90_SHAPES`` (those
whose label holds a word of ``--only``, if given: ``--only stablelm-12b``
takes its train_4k step and batch 4 x 512 at dh 160) in turns beside the
mma body of the first source (``flash_attention_fwd``) and SDPA's bf16
call, by the profiler and by CUDA events.

``--sm90-bwd`` does it for the bf16 backward's sm90 body
(``flash_attention_bwd_sm90``), on o and lse from the plain versions: at
``SM90_BWD_CHECKS`` (dh 80, 120, 128, 160 and 256, ragged S, MHA, GQA,
MQA, causal, window, chunk and no mask) dq, dk and dv as shares of the
bf16 tolerance 2e-2 (1 + |x|) against autograd of ``mha_ref`` in fp32,
and whether two runs give the same bits; then at ``SM90_BWD_SHAPES``
(qwen2-vl-2b's, stablelm-3b's, recurrentgemma-9b's and stablelm-12b's
train steps, the last two also at batch 4 x 512, and h2o-danube-3-4b's
heads) its device time by kernel at every head split the group allows, in
turns, beside the first source's mma_bf16 body (``flash_attention_bwd``:
the pair kernels at ``bwd_head_split``'s split, the 4-warp kernels at dh
80) and SDPA's bf16 backward (with the mask as a boolean ``attn_mask``
where a window bites).  ``--only WORD`` (repeatable) keeps the timed
shapes whose label holds one of the words.  It prints the ptxas lines of
each variant's sm90 backward kernels and exits non-zero on a failed check
(after the timings).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

from . import _build
from ..device import multiprocessors
from .flash_attention.kernel import bwd_head_split, flash_attention_cuda
from .flash_attention.ref import attention_mask, mha_ref

# (B, S, H, K, dh, mask) by --shape
SHAPES = {
    "100m": ((16, 256, 8, 4, 64, dict(causal=True)),
             (2, 190, 16, 2, 64, dict(causal=True))),
    "rgemma": ((4, 512, 16, 1, 256, dict(causal=True, window=2048)),),
    "stablelm": ((4, 512, 32, 8, 160, dict(causal=True)),),
}


# --sm90: hubert-xlarge's encode layer (no mask), then the causal prefill
# at batch 4 x 512 of stablelm-3b, h2o-danube-3-4b, qwen2-7b,
# recurrentgemma-9b (window 2048) and stablelm-12b, and stablelm-12b's
# train_4k step (1 x 4096)
SM90_SHAPES = {
    "hubert-xlarge": (1, 32768, 16, 16, 80, dict(causal=False)),
    "stablelm-3b": (4, 512, 32, 32, 80, dict(causal=True)),
    "h2o-danube-3-4b": (4, 512, 32, 8, 120, dict(causal=True)),
    "qwen2-7b": (4, 512, 28, 4, 128, dict(causal=True)),
    "recurrentgemma-9b": (4, 512, 16, 1, 256, dict(causal=True, window=2048)),
    "stablelm-12b 4x512": (4, 512, 32, 8, 160, dict(causal=True)),
    "stablelm-12b train_4k": (1, 4096, 32, 8, 160, dict(causal=True)),
}
SM90_CHECKS = [(B, S, H, K, dh, kw) for dh in (80, 120, 128, 160, 256)
               for B, S, H, K, kw in (
    (1, 200, 16, 16, dict(causal=True)),
    (1, 1000, 28, 4, dict(causal=True)),
    (2, 512, 16, 2, dict(causal=True, window=100)),
    (1, 512, 16, 2, dict(causal=True, chunk=96)),
    (2, 300, 16, 16, dict(causal=False)),
    (1, 700, 16, 1, dict(causal=False)))]


# --sm90-bwd: the checks (at dh 160 and 256 also recurrentgemma-9b's MQA
# 16 : 1 with a window that bites, P in hi + lo, and stablelm-12b's GQA 32
# : 8), then the timed shapes
SM90_BWD_CHECKS = [(B, S, H, K, dh, kw) for dh in (80, 120, 128, 160, 256)
                   for B, S, H, K, kw in (
    (1, 200, 12, 2, dict(causal=True)),
    (2, 333, 8, 8, dict(causal=True)),
    (1, 300, 16, 1, dict(causal=True)),     # a group of 16: hi + lo
    (2, 512, 12, 2, dict(causal=True, window=100)),
    (1, 512, 12, 4, dict(causal=True, chunk=96)),
    (2, 190, 6, 2, dict(causal=False)),
    (4, 1024, 12, 2, dict(causal=True)),    # qwen2-vl-2b's step, two draws
    (4, 1024, 12, 2, dict(causal=True)))] + [
    (1, 1100, 16, 1, 256, dict(causal=True, window=700)),
    (1, 1100, 32, 8, 160, dict(causal=True)),
    (1, 1100, 16, 1, 160, dict(causal=True, window=700))]
SM90_BWD_SHAPES = {
    "qwen2-vl-2b": (4, 1024, 12, 2, 128, dict(causal=True)),
    "stablelm-3b": (4, 1024, 32, 32, 80, dict(causal=True)),
    "h2o-danube-3-4b": (4, 512, 32, 8, 120, dict(causal=True)),
    "recurrentgemma-9b 4x512": (4, 512, 16, 1, 256,
                                dict(causal=True, window=2048)),
    "stablelm-12b 4x512": (4, 512, 32, 8, 160, dict(causal=True)),
    "recurrentgemma-9b train_4k": (1, 4096, 16, 1, 256,
                                   dict(causal=True, window=2048)),
    "stablelm-12b train_4k": (1, 4096, 32, 8, 160, dict(causal=True)),
}


def _build_variants(sources: list[str], forward: bool = False,
                    sm90: bool = False, sm90_bwd: bool = False) -> dict:
    """{name: bound flash_attention_bwd (or flash_attention_fwd_tf32, or
    (flash_attention_fwd_sm90, flash_attention_fwd))} of each source, built
    at once."""
    out = _build.BUILD_DIR.parent / "ab"
    out.mkdir(parents=True, exist_ok=True)
    jobs = {Path(src).stem: (subprocess.Popen(
        [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(out / f"{Path(src).stem}.so"),
         src], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for src in sources}
    fns = {}
    for name, job in jobs.items():
        log = job.communicate()[0]
        (out / f"{name}.log").write_text(log)  # ptxas's lines, kept beside the .so
        if job.returncode:
            raise RuntimeError(f"{name} did not build:\n{log[-4000:]}")
        lines = log.splitlines()
        key = ("flash_attn_sm90" if sm90 else "flash_attn_tf32" if forward
               else "_sm90_kernel" if sm90_bwd else "flash_bwd")
        for i, line in enumerate(lines[:-2]):
            if "Function properties for" in line and key in line \
                    and (forward or sm90 or sm90_bwd or "EfE" in line):
                print(name, line.split("Function properties for")[-1][:60],
                      lines[i + 1].strip(), lines[i + 2].split(": ")[-1])
        if sm90_bwd and "C7508" in log:
            raise RuntimeError(f"{name}: ptxas ignored setmaxnreg (C7508)")
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        if sm90_bwd:
            fns[name] = (lib.flash_attention_bwd_sm90, lib.flash_attention_bwd)
            for fn in fns[name]:
                fn.argtypes = [*([P] * 10), *([I] * 7), ctypes.c_float, I, I,
                               I, P, P]
                fn.restype = I
            continue
        if sm90:
            fn, mma = lib.flash_attention_fwd_sm90, lib.flash_attention_fwd
            fn.argtypes = [P, P, P, P, I, I, I, I, *([LL] * 9), I, I, I,
                           ctypes.c_float, I, P, P]
            mma.argtypes = [*fn.argtypes[:-2], I, P, P]
            fn.restype = mma.restype = I
            fns[name] = (fn, mma)
            continue
        if forward:
            fn = lib.flash_attention_fwd_tf32
            fn.argtypes = [P, P, P, P, I, I, I, I, *([LL] * 9), I, I, I,
                           ctypes.c_float, I, P, P]
            fn.restype = I
            fns[name] = fn
            continue
        fn = lib.flash_attention_bwd
        fn.argtypes = [*([P] * 10), *([I] * 7), ctypes.c_float, I, I, I, P, P]
        fn.restype = I
        fns[name] = fn
    return fns


def _ms_by_kernel(fn, iters: int = 20) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    ms = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            name = e.key.replace("(anonymous namespace)::", "")
            name = name.split("<")[0].split("(")[0].split()[-1]
            ms[name] = ms.get(name, 0.0) + e.self_device_time_total / iters / 1e3
    return ms


def _sdpa_mask(S: int, kw: dict, dev=None) -> dict:
    """SDPA's is_causal stands for the mask where the window does not
    bite (every shape of ``SHAPES``); given ``dev``, any other causal mask
    goes as a boolean ``attn_mask`` (S, S) on it."""
    window = kw.get("window", 0)
    if kw["causal"] and not kw.get("chunk") and not 0 < window < S:
        return dict(is_causal=True, enable_gqa=True)
    if dev is None:
        raise ValueError(f"no SDPA call for the mask {kw}")
    pos = torch.arange(S, device=dev)
    return dict(attn_mask=attention_mask(pos, pos, **kw), enable_gqa=True)


def main_forward(sources: list[str], shapes) -> None:
    fns = _build_variants(sources, forward=True)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    stream = torch.cuda.current_stream().cuda_stream
    for B, S, H, K, dh, kw in shapes:
        g = torch.Generator(device=dev).manual_seed(0)
        q = torch.randn(B, S, H, dh, generator=g, device=dev)
        k, v = (torch.randn(B, S, K, dh, generator=g, device=dev)
                for _ in range(2))
        want = mha_ref(q, k, v, **kw)
        logits = torch.einsum("bqkgd,bskd->bkgqs",
                              q.double().unflatten(2, (K, H // K)),
                              k.double()) * dh ** -0.5
        pos = torch.arange(S, device=dev)
        want_lse = torch.logsumexp(logits.masked_fill(
            ~attention_mask(pos, pos, **kw), -torch.inf), -1).flatten(1, 2)
        o = torch.empty_like(q)
        lse = torch.empty(B, H, S, device=dev)

        def call(fn):
            return lambda: fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              o.data_ptr(), B, S, H, K, *q.stride()[:3],
                              *k.stride()[:3], *v.stride()[:3],
                              int(kw["causal"]), kw.get("window", 0),
                              kw.get("chunk", 0), dh ** -0.5, dh,
                              lse.data_ptr(), stream)

        res = {}
        for name, fn in fns.items():
            if call(fn)():
                raise RuntimeError(f"{name}: launch failed")
            torch.cuda.synchronize()
            res[name] = dict(share=max(
                float(((got - w).abs() / (2e-5 * (1 + w.abs()))).max())
                for got, w in ((o, want), (lse.double(), want_lse))))
        order = list(fns) + list(fns)[::-1]
        for turn, name in enumerate(order):
            res[name][f"ms_by_kernel_{turn // len(fns)}"] = _ms_by_kernel(
                call(fns[name]))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib = _ms_by_kernel(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, **_sdpa_mask(S, kw)))
        for name, r in res.items():
            print(json.dumps(dict(shape=[B, S, H, K, dh], mask=kw,
                                  variant=name,
                                  sdpa_forward_ms=sum(lib.values()), **r)),
                  flush=True)


def _event_ms(fn, iters: int = 20) -> float:
    """CUDA-event time of one call, over ``iters`` calls after 3."""
    for _ in range(3):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _share(got, want, tol: float) -> float:
    """The largest |got - want| / (tol (1 + |want|)), +inf matching +inf."""
    got, want = got.double(), want.double()
    same = (got == want) & torch.isinf(want)
    err = torch.where(same, 0.0, (got - want).abs())
    return float((err / (tol * (1 + want.abs().nan_to_num(posinf=0))))
                 .nan_to_num(nan=float("inf")).max())


def main_sm90(sources: list[str], only: list[str] | None = None) -> None:
    from .flash_attention.ref import lse_ref
    fns = _build_variants(sources, sm90=True)
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    bf16 = torch.bfloat16

    def bind(fn, q, k, v, o, lse, kw, dtype_code=()):
        B, S, H, dh = q.shape
        return lambda: fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          o.data_ptr(), B, S, H, k.shape[2], *q.stride()[:3],
                          *k.stride()[:3], *v.stride()[:3],
                          int(kw["causal"]), kw.get("window", 0),
                          kw.get("chunk", 0), dh ** -0.5, dh, *dtype_code,
                          None if lse is None else lse.data_ptr(), stream)

    g = torch.Generator(device=dev).manual_seed(0)
    for B, S, H, K, dh, kw in SM90_CHECKS:
        q, k, v = (torch.randn(B, S, n, dh, generator=g, device=dev).to(bf16)
                   for n in (H, K, K))
        want, want_lse = mha_ref(q, k, v, **kw), lse_ref(q, k, **kw)
        for name, (fn, _) in fns.items():
            o, lse = torch.empty_like(q), torch.empty(B, H, S, device=dev)
            if bind(fn, q, k, v, o, lse, kw)():
                raise RuntimeError(f"{name}: launch failed")
            torch.cuda.synchronize()
            print(json.dumps(dict(check=[B, S, H, K, dh], mask=kw,
                                  variant=name,
                                  o_share=_share(o, want, 2e-2),
                                  lse_share=_share(lse, want_lse, 2e-5))),
                  flush=True)
    for label, (B, S, H, K, dh, kw) in SM90_SHAPES.items():
        if only and not any(word in label for word in only):
            continue
        q = (torch.randn(B, S, H, dh, generator=g, device=dev)
             * (4.0 if S > 4096 else 1.0)).to(bf16)
        k, v = (torch.randn(B, S, K, dh, generator=g, device=dev).to(bf16)
                for _ in range(2))
        rows = ([slice(0, 256), slice(S - 256, S)] if S > 4096
                else [slice(0, S)])
        wants = [mha_ref(q[:, r], k, v, **kw) for r in rows]
        o = torch.empty_like(q)
        res = {}
        for name, (fn, _) in fns.items():
            if bind(fn, q, k, v, o, None, kw)():
                raise RuntimeError(f"{name}: launch failed")
            torch.cuda.synchronize()
            res[name] = dict(o_share=max(_share(o[:, r], w, 2e-2)
                                         for r, w in zip(rows, wants)))
        del wants
        order = list(fns) + list(fns)[::-1]
        for turn, name in enumerate(order):
            call = bind(fns[name][0], q, k, v, o, None, kw)
            res[name][f"ms_{turn // len(fns)}"] = sum(
                _ms_by_kernel(call).values())
            res[name][f"event_ms_{turn // len(fns)}"] = _event_ms(call)
        mma = bind(next(iter(fns.values()))[1], q, k, v, o, None, kw, (1,))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=kw["causal"], enable_gqa=True)
        base = dict(mma_ms=sum(_ms_by_kernel(mma).values()),
                    mma_event_ms=_event_ms(mma),
                    sdpa_ms=sum(_ms_by_kernel(sdpa).values()),
                    sdpa_event_ms=_event_ms(sdpa))
        for name, r in res.items():
            print(json.dumps(dict(shape=label, dims=[B, S, H, K, dh],
                                  mask=kw, variant=name, **r, **base)),
                  flush=True)


def main_sm90_bwd(sources: list[str], only: list[str] | None = None) -> None:
    from .flash_attention.ref import lse_ref
    fns = _build_variants(sources, sm90_bwd=True)
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    bf16 = torch.bfloat16
    sms = multiprocessors(dev)

    def setup(B, S, H, K, dh, kw, g):
        q, do = (torch.randn(B, S, H, dh, generator=g, device=dev).to(bf16)
                 for _ in range(2))
        k, v = (torch.randn(B, S, K, dh, generator=g, device=dev).to(bf16)
                for _ in range(2))
        o, lse = mha_ref(q, k, v, **kw).contiguous(), lse_ref(q, k, **kw)
        return q, k, v, o, do, lse

    def bind(fn, t, kw, split, sm90=True):
        q, k, v, o, do, lse = t
        B, S, H, dh = q.shape
        K = k.shape[2]
        delta = torch.empty((2, B, H, -(-S // 128) * 128) if sm90
                            else (B, H, S), device=dev)
        grads = [torch.empty_like(x) for x in (q, k, v)]
        partial = (torch.empty((2, split, B, S, K, dh), device=dev)
                   if split > 1 else None)

        def call():
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                     do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                     *(x.data_ptr() for x in grads), B, S, H, K,
                     int(kw["causal"]), kw.get("window", 0), kw.get("chunk", 0),
                     dh ** -0.5, dh, 1, split,
                     None if partial is None else partial.data_ptr(), stream)
            if err:
                raise RuntimeError(f"launch failed: CUDA error {err}")
            return grads
        return call

    g = torch.Generator(device=dev).manual_seed(0)
    failed = []
    for B, S, H, K, dh, kw in SM90_BWD_CHECKS:
        t = setup(B, S, H, K, dh, kw, g)
        leaves = [x.float().requires_grad_() for x in t[:3]]
        want = torch.autograd.grad(mha_ref(*leaves, **kw), leaves,
                                   t[4].float())
        splits = [s for s in (1, H // K) if (H // K) % s == 0]
        if kw == dict(causal=True):  # SDPA's own bf16 gradient, same inputs
            lv = [x.clone().requires_grad_() for x in t[:3]]
            lib = torch.autograd.grad(F.scaled_dot_product_attention(
                *(x.transpose(1, 2) for x in lv), is_causal=True,
                enable_gqa=True), lv, t[4].transpose(1, 2))
            print(json.dumps(dict(check=[B, S, H, K, dh], mask=kw,
                                  variant="sdpa", shares=[
                                      _share(a, w, 2e-2) for a, w in zip(lib, want)],
                                  abs_err=[float((a.float() - w).abs().max())
                                           for a, w in zip(lib, want)])),
                  flush=True)
        for name, (fn, _) in fns.items():
            for split in sorted(set(splits)):
                call = bind(fn, t, kw, split)
                got = [x.clone() for x in call()]
                again = call()
                torch.cuda.synchronize()
                shares = [_share(a, w, 2e-2) for a, w in zip(got, want)]
                share = max(shares)
                same = all(torch.equal(a, b) for a, b in zip(got, again))
                # where the largest share of each gradient lies (b, s, head)
                where = [list(divmod(int(((a.double() - w.double()).abs() / (
                    1 + w.double().abs())).amax(-1).argmax()), S * a.shape[2]))
                    for a, w in zip(got, want)]
                print(json.dumps(dict(check=[B, S, H, K, dh], mask=kw,
                                      variant=name, head_split=split,
                                      share=share, shares=shares,
                                      abs_err=[float((a.float() - w).abs().max())
                                               for a, w in zip(got, want)],
                                      worst_at=where, deterministic=same)),
                      flush=True)
                if not (share <= 1 and same):
                    failed.append((name, B, S, H, K, dh, kw, split))
    for label, (B, S, H, K, dh, kw) in SM90_BWD_SHAPES.items():
        if only and not any(word in label for word in only):
            continue
        t = setup(B, S, H, K, dh, kw, g)
        G = H // K
        res = {}
        order = list(fns) + list(fns)[::-1]
        for turn, name in enumerate(order):
            for split in (d for d in range(1, G + 1) if G % d == 0):
                call = bind(fns[name][0], t, kw, split)
                r = res.setdefault(f"{name} split {split}", {})
                r[f"ms_by_kernel_{turn // len(fns)}"] = _ms_by_kernel(call)
                r[f"event_ms_{turn // len(fns)}"] = _event_ms(call)
        split = bwd_head_split(B, S, H, K, dh, sms)
        mma = bind(next(iter(fns.values()))[1], t, kw, split, sm90=False)
        leaves = [x.clone().requires_grad_() for x in t[:3]]
        out = F.scaled_dot_product_attention(
            *(x.transpose(1, 2) for x in leaves), **_sdpa_mask(S, kw, dev))
        dout = t[4].transpose(1, 2)

        def sdpa():
            return torch.autograd.grad(out, leaves, dout, retain_graph=True)
        base = dict(mma_bf16_split=split, mma_bf16_ms_by_kernel=_ms_by_kernel(mma),
                    mma_bf16_event_ms=_event_ms(mma),
                    sdpa_bwd_ms_by_kernel=_ms_by_kernel(sdpa),
                    sdpa_bwd_event_ms=_event_ms(sdpa))
        print(json.dumps(dict(shape=label, dims=[B, S, H, K, dh], mask=kw,
                              variants=res, **base)), flush=True)
    if failed:
        raise SystemExit(f"sm90 backward checks failed: {failed}")


def main(argv: list[str]) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--forward", action="store_true")
    ap.add_argument("--sm90", action="store_true")
    ap.add_argument("--sm90-bwd", action="store_true")
    ap.add_argument("--shape", choices=sorted(SHAPES), default="100m")
    ap.add_argument("--only", action="append")
    ap.add_argument("sources", nargs="+")
    args = ap.parse_args(argv)
    if args.forward:
        return main_forward(args.sources, SHAPES[args.shape])
    if args.sm90:
        return main_sm90(args.sources, args.only)
    if args.sm90_bwd:
        return main_sm90_bwd(args.sources, args.only)
    fns = _build_variants(args.sources)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    stream = torch.cuda.current_stream().cuda_stream
    for B, S, H, K, dh, kw in SHAPES[args.shape]:
        g = torch.Generator(device=dev).manual_seed(0)
        q, do = (torch.randn(B, S, H, dh, generator=g, device=dev)
                 for _ in range(2))
        k, v = (torch.randn(B, S, K, dh, generator=g, device=dev)
                for _ in range(2))
        with torch.no_grad():
            o, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        mha_ref(*leaves, **kw).backward(do)
        delta = torch.empty(B, H, S, device=dev)
        grads = [torch.empty_like(t) for t in (q, k, v)]
        split = bwd_head_split(B, S, H, K, dh, multiprocessors(dev))
        partial = torch.empty((2, split, B, S, K, dh), device=dev)

        def call(fn):
            return lambda: fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              o.data_ptr(), do.data_ptr(), lse.data_ptr(),
                              delta.data_ptr(),
                              *(t.data_ptr() for t in grads), B, S, H, K,
                              int(kw["causal"]), kw.get("window", 0),
                              kw.get("chunk", 0), dh ** -0.5, dh, 0, split,
                              partial.data_ptr(), stream)

        res = {}
        for name, fn in fns.items():
            if call(fn)():
                raise RuntimeError(f"{name}: launch failed")
            torch.cuda.synchronize()
            res[name] = dict(share=max(
                float(((a - w.grad).abs() / (2e-5 * (1 + w.grad.abs()))).max())
                for a, w in zip(grads, leaves)))
        order = list(fns) + list(fns)[::-1]
        for turn, name in enumerate(order):
            res[name][f"ms_by_kernel_{turn // len(fns)}"] = _ms_by_kernel(
                call(fns[name]))
        sdpa = F.scaled_dot_product_attention(
            *(t.transpose(1, 2) for t in leaves), **_sdpa_mask(S, kw))
        lib = _ms_by_kernel(lambda: torch.autograd.grad(
            sdpa, leaves, do.transpose(1, 2), retain_graph=True))
        for name, r in res.items():
            print(json.dumps(dict(shape=[B, S, H, K, dh], mask=kw,
                                  variant=name, head_split=split,
                                  sdpa_backward_ms=sum(lib.values()), **r)),
                  flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
