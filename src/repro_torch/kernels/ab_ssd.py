"""Time variants of the SSD backward's mma body on one card, in turns.

    PYTHONPATH=src python -m repro_torch.kernels.ab_ssd A.cu B.cu [...]

Each argument is a copy of ``csrc/ssd.cu`` (edited by hand, for an A/B of
one change).  Each is built with the port's nvcc flags into
``build/ab_ssd/``, loaded with ctypes, and its ``ssd_bwd_mma`` run at
mamba2-130m's training shape (x, dy (8,1024,24,64) fp32, Bm/Cm
(8,1024,1,128), chunk 128, no final-state gradient): its largest error
against ``ref.ssd_chunked_bwd`` as a share of the fp32 SSD tolerance
(``|got - want| / (2e-3 (1 + |want|))``, at most 1 to pass), then its
device time under ``torch.profiler`` (per call over 20 calls, the median of
3 windows) in two rounds (A, B, ..., then back), and by kernel.  Prints the
ptxas registers and spills of each variant's fp32 chunk-gradient kernels,
the opcodes of its compiled fp32 chunk-gradient kernel at mamba2-130m's
tile counts (``cuobjdump -sass``: instructions in all, HMMA among them),
and one JSON line per variant; needs a card and ``nvcc``.
"""
from __future__ import annotations

import collections
import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

from . import _build
from .ssd.ref import ssd_chunked_bwd

SHAPE = (8, 1024, 24, 64, 1, 128, 128)   # B, S, H, P, G, N, chunk


def _build_variants(sources: list[str]) -> dict:
    """{name: loaded library} of each source, built at once."""
    out = _build.BUILD_DIR.parent / "ab_ssd"
    out.mkdir(parents=True, exist_ok=True)
    jobs = {Path(src).stem: subprocess.Popen(
        [_build.nvcc(), *_build.NVCC_FLAGS, "-o",
         str(out / f"{Path(src).stem}.so"), src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src in sources}
    libs = {}
    for name, job in jobs.items():
        log = job.communicate()[0]
        if job.returncode:
            raise RuntimeError(f"{name} did not build:\n{log[-4000:]}")
        lines = log.splitlines()
        for i, line in enumerate(lines[:-2]):
            if "Function properties for" in line \
                    and "ssd_bwd_chunk_mma_kernelIf" in line:
                print(name, line.split("kernel")[-1][:24],
                      lines[i + 1].strip(), lines[i + 2].split(": ")[-1])
        print(name, "sass", json.dumps(_sass_opcodes(out / f"{name}.so")))
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.ssd_bwd_mma.argtypes = [*([P] * 15), *([I] * 8), P]
        lib.ssd_bwd_mma.restype = I
        lib.ssd_bwd_mma_workspace_floats.argtypes = [I] * 7
        lib.ssd_bwd_mma_workspace_floats.restype = ctypes.c_longlong
        libs[name] = lib
    return libs


def _sass_opcodes(lib: Path) -> dict:
    """Instructions of the fp32 chunk-gradient kernel at N 128, P 64 in the
    compiled library: the total, HMMA's share and the commonest opcodes."""
    sass = subprocess.run([str(Path(_build.nvcc()).parent / "cuobjdump"),
                           "-sass", str(lib)], capture_output=True,
                          text=True).stdout
    for block in re.split(r"\n\s*Function : ", sass):
        # the one-slab kernel at those tile counts (before slabs: no
        # third template argument)
        if re.search(r"ssd_bwd_chunk_mma_kernelIfLi16ELi8E(Li1E)?E",
                     block.split("\n")[0]):
            ops = collections.Counter(
                m.group(1).split(".")[0] for m in re.finditer(
                    r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                    r"([A-Z][A-Z0-9_.]+)", block))
            total = sum(ops.values())
            return dict(instructions=total, hmma_share=ops["HMMA"] / total,
                        top=ops.most_common(8))
    return {}


def _profile(fn, iters: int = 20) -> tuple[float, dict]:
    """(device ms of one call, {kernel: ms}) over ``iters`` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    by = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            name = e.key.replace("(anonymous namespace)::", "")
            name = name.split("<")[0].split("(")[0].split()[-1]
            ms = e.self_device_time_total / iters / 1e3
            by[name] = by.get(name, 0.0) + ms
    return sum(by.values()), by


def main(sources: list[str]) -> None:
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    libs = _build_variants(sources)
    B, S, H, P, G, N, Q = SHAPE
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)
    x, dy = randn(B, S, H, P), randn(B, S, H, P)
    dt, A = F.softplus(randn(B, S, H)), -torch.exp(randn(H) * 0.5)
    Bm, Cm = randn(B, S, G, N) * 0.3, randn(B, S, G, N) * 0.3
    D = randn(H)
    want = ssd_chunked_bwd(x, dt, A, Bm, Cm, D, dy, chunk=Q)
    stream = torch.cuda.current_stream().cuda_stream
    calls = {}
    for name, lib in libs.items():
        ws = torch.empty(lib.ssd_bwd_mma_workspace_floats(B, S, H, P, G, N, Q),
                         device=dev)
        out = [torch.empty_like(x), torch.empty(B, S, H, device=dev),
               torch.empty(H, device=dev), torch.empty_like(Bm),
               torch.empty_like(Cm), torch.empty(H, device=dev)]

        def call(lib=lib, ws=ws, out=out, name=name):
            err = lib.ssd_bwd_mma(
                x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                Cm.data_ptr(), D.data_ptr(), dy.data_ptr(), None,
                *(t.data_ptr() for t in out), ws.data_ptr(), B, S, H, P, G,
                N, Q, 0, stream)
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")
            return out
        calls[name] = call
    shares, times, by_kernel = {}, {n: [] for n in calls}, {}
    for name, call in calls.items():
        got = call()
        torch.cuda.synchronize()
        shares[name] = max(
            float(((a - w).abs() / (2e-3 * (1 + w.abs()))).max())
            for a, w in zip(got, want))
        for _ in range(3):
            call()
    for order in (list(calls), list(calls)[::-1]):
        for name in order:
            runs = [_profile(calls[name]) for _ in range(3)]
            times[name].append(statistics.median(r[0] for r in runs))
            by_kernel[name] = runs[-1][1]
    for name in calls:
        print(json.dumps(dict(variant=name, shape=SHAPE, ms=times[name],
                              tolerance_share=shares[name],
                              by_kernel=by_kernel[name])))


if __name__ == "__main__":
    main(sys.argv[1:])
