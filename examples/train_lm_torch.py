"""End-to-end training on the PyTorch port: a ~100M-param LM on synthetic
data with transactional checkpointing, metrics streaming and crash
recovery (the twin of ``train_lm.py``: the same presets and flags, plus
``--device``).

    PYTHONPATH=src python examples/train_lm_torch.py --preset small --steps 120
    PYTHONPATH=src python examples/train_lm_torch.py --preset 100m --steps 300

The '100m' preset is the deliverable configuration; 'small' (~10M) runs
the identical pipeline in minutes on a CPU (``--device cpu``, where the
kernels' plain PyTorch versions run).  On the card (the default) the
forward and backward go through the port's CUDA kernels.
"""
import argparse
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch

from repro_torch.core import (CannyFS, LatencyBackend, LatencyModel,
                              LocalBackend)
from repro_torch.data import Prefetcher, SyntheticLM
from repro_torch.models.config import ModelConfig
from repro_torch.train.loop import LoopConfig, Trainer, run_with_restarts
from repro_torch.train.steps import TrainConfig

PRESETS = {
    "small": dict(num_layers=6, d_model=256, num_heads=8, num_kv_heads=4,
                  d_ff=1024, vocab_size=4096, batch=8, seq=128),
    "100m": dict(num_layers=12, d_model=512, num_heads=8, num_kv_heads=4,
                 d_ff=2048, vocab_size=32768, batch=16, seq=256),
}


def preset_config(name: str, **overrides) -> ModelConfig:
    """The dense-attention LM of preset ``name`` (fields overridable)."""
    p = PRESETS[name]
    kw = dict(name=f"lm-{name}", family="dense", num_layers=p["num_layers"],
              d_model=p["d_model"], num_heads=p["num_heads"],
              num_kv_heads=p["num_kv_heads"], d_ff=p["d_ff"],
              vocab_size=p["vocab_size"], block_pattern=("attn",))
    return ModelConfig(**{**kw, **overrides})


def make_fs(workdir: str, io_latency_ms: float) -> CannyFS:
    """CannyFS over a local directory, behind a simulated remote-storage
    latency when ``io_latency_ms`` > 0."""
    backend = LocalBackend(workdir)
    if io_latency_ms:
        backend = LatencyBackend(backend, LatencyModel(
            meta_ms=io_latency_ms, data_ms=io_latency_ms, jitter_sigma=0.2))
    return CannyFS(backend, max_inflight=4000, workers=32)


def train_config() -> TrainConfig:
    """The examples' step settings: fp32 (the card's fp32 matmuls stay
    fp32: TF32 is off by default), peak lr 3e-3, z-loss 1e-4."""
    return TrainConfig(dtype=torch.float32, remat_policy="none",
                       peak_lr=3e-3, z_loss=1e-4)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", choices=PRESETS, default="small")
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--ckpt-every", type=int, default=40)
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--io-latency-ms", type=float, default=1.0,
                    help="simulated remote-storage latency (0 = local)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    p = PRESETS[args.preset]
    cfg = preset_config(args.preset)
    print(f"model: {cfg.name}  params≈{cfg.param_count() / 1e6:.1f}M  "
          f"device: {args.device}")

    workdir = args.workdir or tempfile.mkdtemp(prefix="repro_train_")
    fs = make_fs(workdir, args.io_latency_ms)
    print(f"workdir: {workdir} (transactional I/O via CannyFS engine)")

    def factory():
        data = Prefetcher(iter(SyntheticLM(cfg, batch=p["batch"],
                                           seq_len=p["seq"], seed=0)),
                          depth=2)
        return Trainer(
            cfg, fs, data, tc=train_config(),
            lc=LoopConfig(total_steps=args.steps,
                          ckpt_every=args.ckpt_every, log_every=10,
                          warmup=20),
            device=args.device)

    metrics = run_with_restarts(factory, max_restarts=1)
    print("final metrics:", {k: round(v, 4) for k, v in metrics.items()})
    fs.drain()
    print("metrics log:")
    for line in fs.read_file("logs/metrics.jsonl").decode().splitlines()[-5:]:
        print("  ", line)
    fs.close()


if __name__ == "__main__":
    main()
