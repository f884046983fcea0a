"""Batched serving on the PyTorch port: prefill a batch of prompts,
then greedy decode, wave by wave (the twin of ``serve_batch.py``).

    PYTHONPATH=src python examples/serve_batch_torch.py --arch qwen2-7b --requests 12

The port serves the attention archs with dense FFNs (qwen2-7b, stablelm-3b,
stablelm-12b, h2o-danube-3-4b), qwen2-vl-2b (M-RoPE; text prompts, on
which it degenerates to RoPE, as the reference's example serves it), the
MoE archs moonshot-v1-16b-a3b and llama4-scout-17b-a16e (chunked and
global NoPE attention), recurrentgemma-9b (RG-LRU and local attention) and
mamba2-130m (Mamba-2 SSD), each at its smoke size here; hubert-xlarge is
encoder-only and refused.  Runs on the card by default; ``--device cpu``
runs the plain PyTorch versions of the kernels on the CPU.
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.models import init_cache, init_params
from repro_torch.train.steps import make_decode_step, make_prefill_step


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen2-7b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = get_smoke_config(args.arch)
    if not cfg.supports_decode():
        raise SystemExit(f"{args.arch} is encoder-only; no decode")
    device = torch.device(args.device)
    max_len = args.prompt_len + args.max_new + 8
    params = init_params(cfg, device=device, dtype=torch.float32,
                         generator=torch.Generator(device=device).manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=args.prompt_len)
               .astype(np.int32) for _ in range(args.requests)]

    pre = make_prefill_step(cfg, dtype=torch.float32)
    dec = make_decode_step(cfg, dtype=torch.float32)

    queue = list(prompts)
    t0, new_tokens = time.monotonic(), 0
    with torch.inference_mode():
        while queue:
            wave = [queue.pop(0) for _ in range(min(args.batch, len(queue)))]
            while len(wave) < args.batch:          # pad the last wave
                wave.append(np.zeros(args.prompt_len, np.int32))
            batch_toks = torch.from_numpy(np.stack(wave)).to(device)
            cache = init_cache(cfg, args.batch, max_len, torch.float32,
                               device=device)
            last, cache = pre(params, {"tokens": batch_toks}, cache)
            tok = torch.argmax(last, -1)[:, None].to(torch.int32)
            outs = [[] for _ in range(args.batch)]
            for _ in range(args.max_new):
                tok, _, cache = dec(params, tok, cache)
                for b, t in enumerate(tok[:, 0].tolist()):
                    outs[b].append(t)
                new_tokens += args.batch
    dt = time.monotonic() - t0
    print(f"arch={args.arch}  requests={args.requests}  "
          f"decode_throughput={new_tokens / dt:.1f} tok/s  wall={dt:.1f}s")
    print("sample continuation:", outs[0][:10])


if __name__ == "__main__":
    main()
