#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py [--seed N]

Phases, each printed as one JSON line:

1. ``env``: the card (``nvidia-smi``), torch / CUDA / nvcc versions, and the
   build of every CUDA kernel from ``src/repro_torch/csrc`` (one ``nvcc``
   per source, all at once, into ``build/repro_torch``).
2. ``kernels``: each kernel against its plain PyTorch version on the card,
   fp32 (tolerance 2e-5) and bf16 (2e-2), the JAX suite's own tolerances;
   then kernel, plain and library (``F.rms_norm`` / SDPA) times at the
   qwen2-7b serving shapes (CUDA events, median of 30 after warm-up) beside
   the least time the card could take (bytes over 3.35 TB/s or operations
   over the peak rate of their type).
3. ``serve_check``: qwen2-7b at full width and 4 layers, fp32, random
   weights from the seed: the last-position logits of ``prefill`` and 8
   ``decode_step``s against ``forward_train`` on the same tokens, within
   2e-4 relative.
4. ``serve``: full qwen2-7b (28 layers, bf16 weights and KV cache) through
   the ``serve_batch`` wave loop: 12 requests, 3 waves of batch 4, 512-token
   prompts, 32 greedy new tokens.  Both kernels' launch counters are reset
   just before and must equal the analytic counts just after.
5. ``profile``: one more prefill wave and 8 decode steps under
   ``torch.profiler``: wall time, summed kernel time, the card's idle share
   and the costliest kernels.

Then a ``kernels`` summary line, the card's name and power limit as
``nvidia-smi`` prints them, and ``{"ok": true, "device": {...}}`` last.
Any failed check exits non-zero; so does a machine without a card.
"""
import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
PEAK_OPS_PER_S = {torch.bfloat16: 989e12,   # dense tensor-core bf16
                  torch.float32: 67e12}     # fp32 outside the tensor cores
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
SERVE_REL = 2e-4


def emit(phase: str, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def check(cond, msg: str):
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def run(cmd) -> str:
    return subprocess.run(cmd, check=True, capture_output=True,
                          text=True).stdout.strip()


def time_ms(fn, iters: int = 30, warmup: int = 5) -> float:
    """Median device time of one call, by CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def bound(n_bytes: float, n_ops: float, dtype) -> tuple:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(got, want, dtype) -> tuple:
    """(max abs error, within tolerance) with |got - want| <= t + t·|want|."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    ok = bool(torch.isfinite(got).all()) and bool(
        (err <= TOL[dtype] * (1 + want.abs())).all())
    return float(err.max()), ok


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_env(build):
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).splitlines()[0]
    nvcc_version = run([build.nvcc(), "--version"]).splitlines()[-1]
    t0 = time.monotonic()
    logs = build.build()
    build_s = time.monotonic() - t0
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ptxas = {name: [ln.split("info    : ")[-1] for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, log in logs.items()}
    emit("env", nvidia_smi=smi, python=sys.version.split()[0],
         torch=torch.__version__, cuda=torch.version.cuda, nvcc=nvcc_version,
         built=sorted(logs), build_s=build_s, ptxas=ptxas)
    return smi


def phase_kernels(dev, gen):
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.kernels.flash_attention.ref import attention_mask, mha_ref
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm_cuda
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    cases, summary = [], {}

    # ---- rmsnorm: qwen2-7b D 3584, decode rows (4) and prefill rows (4·512)
    D, eps = 3584, 1e-6
    for dtype in (torch.float32, torch.bfloat16):
        for rows in (4, 4 * 512):
            x, s, r = randn(rows, D, dtype=dtype), randn(D, dtype=dtype), \
                randn(rows, D, dtype=dtype)
            for res in (None, r):
                err, ok = compare(rmsnorm_cuda(x, s, eps=eps, residual=res),
                                  rmsnorm_ref(x, s, eps=eps, residual=res),
                                  dtype)
                cases.append(dict(kernel="rmsnorm", dtype=str(dtype),
                                  rows=rows, D=D, residual=res is not None,
                                  max_abs_err=err, tol=TOL[dtype], ok=ok))
    timings = {}
    for rows in (4 * 512, 4):      # prefill rows first: the summary's shape
        x, s = randn(rows, D, dtype=torch.bfloat16), \
            randn(D, dtype=torch.bfloat16)
        t_bound, by = bound(2 * x.nbytes + s.nbytes, 4 * x.numel(),
                            torch.float32)
        timings[rows] = dict(
            ms=time_ms(lambda: rmsnorm_cuda(x, s, eps=eps)),
            plain_ms=time_ms(lambda: rmsnorm_ref(x, s, eps=eps)),
            library_ms=time_ms(lambda: F.rms_norm(x, (D,), s, eps)),
            bound_ms=t_bound, bound_by=by,
            max_abs_err=compare(rmsnorm_cuda(x, s, eps=eps),
                                rmsnorm_ref(x, s, eps=eps),
                                torch.bfloat16)[0])
    summary["rmsnorm"] = dict(
        name="rmsnorm", route="cuda", source="src/repro_torch/csrc/rmsnorm.cu",
        replaces="src/repro/kernels/rmsnorm/kernel.py:33",
        shape=f"x (2048, {D}) bf16, scale bf16", **timings[4 * 512])
    emit("kernels", kernel="rmsnorm",
         timings={f"rows={r} D={D} bf16": t for r, t in timings.items()})

    # ---- flash attention: qwen2-7b prefill shapes, ragged S, dh 32/64,
    # window and chunk
    attn_cases = [
        (4, 512, 28, 4, 128, dict(causal=True)),
        (1, 200, 28, 4, 128, dict(causal=True)),
        (2, 24, 28, 4, 128, dict(causal=True)),
        (2, 256, 8, 2, 32, dict(causal=True)),
        (2, 256, 8, 2, 64, dict(causal=True)),
        (1, 512, 8, 2, 128, dict(causal=True, window=100)),
        (1, 512, 8, 2, 128, dict(causal=True, chunk=128)),
    ]
    for B, S, H, K, dh, kw in attn_cases:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = randn(B, S, H, dh, dtype=dtype), \
                randn(B, S, K, dh, dtype=dtype), randn(B, S, K, dh, dtype=dtype)
            err, ok = compare(flash_attention_cuda(q, k, v, **kw),
                              mha_ref(q, k, v, **kw), dtype)
            cases.append(dict(kernel="flash_attention", dtype=str(dtype),
                              B=B, S=S, H=H, K=K, dh=dh, **kw,
                              max_abs_err=err, tol=TOL[dtype], ok=ok))
    B, S, H, K, dh = attn_cases[0][:5]
    q, k, v = randn(B, S, H, dh, dtype=torch.bfloat16), \
        randn(B, S, K, dh, dtype=torch.bfloat16), \
        randn(B, S, K, dh, dtype=torch.bfloat16)
    pos = torch.arange(S, device=dev)
    pairs = int(attention_mask(pos, pos, causal=True).sum())
    t_bound, by = bound(2 * q.nbytes + k.nbytes + v.nbytes,
                        4 * B * H * dh * pairs, torch.bfloat16)
    qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
    summary["flash_attention"] = dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:99",
        shape=f"q ({B},{S},{H},{dh}) k/v ({B},{S},{K},{dh}) bf16 causal",
        ms=time_ms(lambda: flash_attention_cuda(q, k, v, causal=True)),
        plain_ms=time_ms(lambda: mha_ref(q, k, v, causal=True)),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)),
        bound_ms=t_bound, bound_by=by,
        max_abs_err=compare(flash_attention_cuda(q, k, v, causal=True),
                            mha_ref(q, k, v, causal=True),
                            torch.bfloat16)[0])
    emit("kernels", cases=cases)
    bad = [c for c in cases if not c["ok"]]
    check(not bad, f"kernel disagrees with its plain version: {bad}")
    return summary


def phase_serve_check(dev, gen):
    from repro_torch.configs import get_config
    from repro_torch.models import (decode_step, forward_train, init_cache,
                                    init_params, prefill)
    cfg = dataclasses.replace(get_config("qwen2-7b"), num_layers=4)
    B, P, n_dec = 2, 128, 8
    params = init_params(cfg, device=dev, dtype=torch.float32, generator=gen)
    toks = torch.randint(0, cfg.vocab_size, (B, P + n_dec), generator=gen,
                         device=dev)
    with torch.inference_mode():
        full, _ = forward_train(params, {"tokens": toks}, cfg,
                                dtype=torch.float32)
        cache = init_cache(cfg, B, P + n_dec + 8, torch.float32, device=dev)
        last, cache = prefill(params, {"tokens": toks[:, :P]}, cache, cfg,
                              dtype=torch.float32)
        errs = [(last - full[:, P - 1]).abs().max()]
        for t in range(P, P + n_dec):
            logits, cache = decode_step(params, toks[:, t:t + 1], cache, cfg,
                                        dtype=torch.float32)
            errs.append((logits - full[:, t]).abs().max())
    scale = float(full.abs().max())
    rel = float(torch.stack(errs).max()) / scale
    finite = bool(torch.isfinite(full).all())
    emit("serve_check", arch="qwen2-7b", layers=cfg.num_layers,
         dtype="float32", batch=B, prompt=P, decode_steps=n_dec,
         max_rel_err=rel, bound=SERVE_REL, finite=finite)
    check(finite and rel < SERVE_REL,
          f"serve_check: decode vs forward rel err {rel} (bound {SERVE_REL})")


def phase_serve(dev, gen, seed):
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm_cuda
    from repro_torch.models import init_cache, init_params
    from repro_torch.train.steps import make_decode_step, make_prefill_step

    cfg = get_config("qwen2-7b")
    batch, requests, prompt_len, max_new = 4, 12, 512, 32
    max_len = prompt_len + max_new + 8
    dtype = torch.bfloat16
    t0 = time.monotonic()
    params = init_params(cfg, device=dev, dtype=dtype, generator=gen)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    weight_bytes = sum(t.nbytes for t in _leaves(params))
    rng = np.random.default_rng(seed)
    queue = [rng.integers(0, cfg.vocab_size, size=prompt_len).astype(np.int64)
             for _ in range(requests)]
    pre = make_prefill_step(cfg, dtype=dtype)
    dec = make_decode_step(cfg, dtype=dtype)

    torch.cuda.reset_peak_memory_stats()
    rmsnorm_cuda.launches = 0
    flash_attention_cuda.launches = 0
    prefill_ms, decode_s, outs = [], 0.0, []
    with torch.inference_mode():
        finite = torch.ones((), dtype=torch.bool, device=dev)
        while queue:
            wave = [queue.pop(0) for _ in range(min(batch, len(queue)))]
            toks = torch.from_numpy(np.stack(wave)).to(dev)
            cache = init_cache(cfg, batch, max_len, dtype, device=dev)
            torch.cuda.synchronize()
            t0 = time.monotonic()
            last, cache = pre(params, {"tokens": toks}, cache)
            torch.cuda.synchronize()
            t1 = time.monotonic()
            prefill_ms.append((t1 - t0) * 1e3)
            finite &= torch.isfinite(last).all()
            tok = torch.argmax(last, -1)[:, None].to(torch.int32)
            new = []
            for _ in range(max_new):
                tok, logits, cache = dec(params, tok, cache)
                finite &= torch.isfinite(logits).all()
                new.append(tok)
            torch.cuda.synchronize()
            decode_s += time.monotonic() - t1
            outs.append(torch.cat(new, 1).cpu())
    launches = {"rmsnorm": rmsnorm_cuda.launches,
                "flash_attention": flash_attention_cuda.launches}
    waves = len(outs)
    steps = waves * max_new
    want = {"rmsnorm": (2 * cfg.num_layers + 1) * (waves + steps),
            "flash_attention": cfg.num_layers * waves}
    tokens = torch.cat(outs)
    emit("serve", arch=cfg.name, layers=cfg.num_layers, dtype="bfloat16",
         requests=requests, waves=waves, batch=batch, prompt=prompt_len,
         new_tokens=max_new, init_s=init_s, prefill_ms=prefill_ms,
         decode_tok_per_s=batch * steps / decode_s,
         decode_ms_per_step=decode_s * 1e3 / steps,
         decode_bound_ms_per_step=weight_bytes / HBM_BYTES_PER_S * 1e3,
         weight_bytes=weight_bytes,
         peak_mem_bytes=torch.cuda.max_memory_allocated(),
         launches=launches, launches_expected=want,
         sample=tokens[0, :10].tolist())
    check(bool(finite), "serve: non-finite logits")
    check(tokens.shape == (requests, max_new)
          and int(tokens.min()) >= 0 and int(tokens.max()) < cfg.vocab_size,
          f"serve: bad tokens {tuple(tokens.shape)}")
    check(all(launches.values()) and launches == want,
          f"serve: launches {launches}, expected {want}")
    return launches, (cfg, params, pre, dec, toks, max_len)


def _profiled(fn) -> dict:
    """Wall time, summed kernel time, idle share and the costliest kernels
    of one call, from torch.profiler (device time "not measured" if the
    trace holds no kernel)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    kernels = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and e.self_device_time_total > 0), reverse=True)
    if not kernels:
        return dict(wall_ms=wall_ms, device_ms="not measured")
    device_ms = sum(k[0] for k in kernels)
    return dict(wall_ms=wall_ms, device_ms=device_ms,
                idle_share=1 - device_ms / wall_ms,
                top=[dict(ms=ms, count=n, kernel=name[:80])
                     for ms, n, name in kernels[:8]])


def phase_profile(dev, cfg, params, pre, dec, toks, max_len, n_dec: int = 8):
    """Where the serve phase's time goes: one prefill wave and ``n_dec``
    decode steps again, under the profiler (after the launch counts were
    read, so they do not count)."""
    from repro_torch.models import init_cache
    with torch.inference_mode():
        cache = init_cache(cfg, toks.shape[0], max_len, torch.bfloat16,
                           device=dev)
        state = {}

        def run_prefill():
            state["last"], _ = pre(params, {"tokens": toks}, cache)

        def run_decode():
            tok = torch.argmax(state["last"], -1)[:, None].to(torch.int32)
            for _ in range(n_dec):
                tok, _, _ = dec(params, tok, cache)

        emit("profile", prefill=_profiled(run_prefill),
             decode_steps=n_dec, decode=_profiled(run_decode))


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card; nothing to run", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    smi = phase_env(_build)
    summary = phase_kernels(dev, gen)
    phase_serve_check(dev, gen)
    torch.cuda.empty_cache()
    launches, served = phase_serve(dev, gen, args.seed)
    phase_profile(dev, *served)
    for name, entry in summary.items():
        entry["launches"] = launches[name]
    print(json.dumps({"kernels": list(summary.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
