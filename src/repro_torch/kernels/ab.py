"""Time variants of the flash-attention backward (or, with ``--forward``,
of the fp32 forward's mma_tf32x3 body) on one card, in turns.

    PYTHONPATH=src python -m repro_torch.kernels.ab [--forward] \
        [--shape 100m|rgemma|stablelm] A.cu B.cu [...]

Each argument is a copy of ``csrc/flash_attention.cu`` (edited by hand, for
an A/B of one change).  Each is built with the port's nvcc flags into
``build/ab/``, loaded with ctypes, and its ``flash_attention_bwd`` run (with
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


def _build_variants(sources: list[str], forward: bool = False) -> dict:
    """{name: bound flash_attention_bwd (or flash_attention_fwd_tf32)} of
    each source, built at once."""
    out = _build.BUILD_DIR.parent / "ab"
    out.mkdir(parents=True, exist_ok=True)
    jobs = {Path(src).stem: (subprocess.Popen(
        [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(out / f"{Path(src).stem}.so"),
         src], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for src in sources}
    fns = {}
    for name, job in jobs.items():
        log = job.communicate()[0]
        if job.returncode:
            raise RuntimeError(f"{name} did not build:\n{log[-4000:]}")
        lines = log.splitlines()
        key = "flash_attn_tf32" if forward else "flash_bwd"
        for i, line in enumerate(lines[:-2]):
            if "Function properties for" in line and key in line \
                    and (forward or "EfE" in line):
                print(name, line.split(key)[-1][:40],
                      lines[i + 1].strip(), lines[i + 2].split(": ")[-1])
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
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


def _sdpa_mask(S: int, kw: dict) -> dict:
    """SDPA's is_causal stands for the mask where the window does not
    bite (every shape of ``SHAPES``)."""
    if not kw["causal"] or kw.get("chunk") or 0 < kw.get("window", 0) < S:
        raise ValueError(f"no SDPA call for the mask {kw}")
    return dict(is_causal=True, enable_gqa=True)


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


def main(argv: list[str]) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--forward", action="store_true")
    ap.add_argument("--shape", choices=sorted(SHAPES), default="100m")
    ap.add_argument("sources", nargs="+")
    args = ap.parse_args(argv)
    if args.forward:
        return main_forward(args.sources, SHAPES[args.shape])
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
