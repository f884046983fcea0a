"""Training launcher for the port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-3b \
        --smoke --steps 50 --workdir /tmp/run1

All host I/O (checkpoints, metrics) flows through the CannyFS
transactional engine; ``--restarts`` wraps the job in the
rollback-and-resubmit loop.  ``--remat`` picks the activation-checkpoint
policy (default ``none``, as the reference's launcher).

``--mesh {debug,pod,multipod}`` trains on a ``DeviceMesh``
(``launch.mesh``) over the ranks of the process group, with
``--act-mode {dp,dp_sp}``; run it once per rank under ``torchrun``:

    PYTHONPATH=src torchrun --nproc_per_node=4 -m repro_torch.launch.train \
        --arch qwen2-7b --smoke --mesh debug --workdir /tmp/run2

Without ``torchrun`` the mesh has one rank.  Without ``--mesh`` the job
runs on one device, as it always has.
"""
import argparse
import tempfile

import torch
import torch.distributed as dist

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core import (CannyFS, LatencyBackend, LatencyModel,
                              LocalBackend)
from repro_torch.data import Prefetcher, SyntheticLM
from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
from repro_torch.parallel import POLICIES
from repro_torch.train.loop import LoopConfig, Trainer, run_with_restarts
from repro_torch.train.steps import TrainConfig


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--mesh", default=None,
                    choices=("debug", "pod", "multipod"),
                    help="train on a DeviceMesh over the process group's "
                         "ranks (default: one device)")
    ap.add_argument("--act-mode", default="dp", choices=("dp", "dp_sp"))
    ap.add_argument("--remat", default="none", choices=POLICIES)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--restarts", type=int, default=1)
    ap.add_argument("--io-latency-ms", type=float, default=0.0)
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    mesh = None
    if args.mesh:
        started = not dist.is_initialized()
        mesh = {"debug": lambda: make_debug_mesh(device=args.device),
                "pod": lambda: make_production_mesh(device=args.device),
                "multipod": lambda: make_production_mesh(
                    multi_pod=True, device=args.device)}[args.mesh]()
    rank0 = mesh is None or dist.get_rank() == 0
    workdir = [args.workdir or (tempfile.mkdtemp(prefix="repro_run_")
                                if rank0 else None)]
    if mesh is not None:        # every rank writes through the same root
        dist.broadcast_object_list(workdir, src=0)
    workdir = workdir[0]
    backend = LocalBackend(workdir)
    if args.io_latency_ms:
        backend = LatencyBackend(backend, LatencyModel(
            meta_ms=args.io_latency_ms, data_ms=args.io_latency_ms))
    fs = CannyFS(backend, max_inflight=4000, workers=32)
    if rank0:
        print(f"[launch] arch={cfg.name} params≈{cfg.param_count()/1e6:.1f}M "
              f"device={args.device} workdir={workdir}" +
              (f" mesh={dict(zip(mesh.mesh_dim_names, mesh.shape))}"
               if mesh is not None else ""))

    tc = TrainConfig(dtype=getattr(torch, args.dtype),
                     remat_policy=args.remat,
                     activation_mode=args.act_mode, peak_lr=args.lr)
    lc = LoopConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                    log_every=10, warmup=min(20, args.steps // 5 + 1))

    def factory():
        data = Prefetcher(iter(SyntheticLM(cfg, batch=args.batch,
                                           seq_len=args.seq, seed=0)),
                          depth=2)
        return Trainer(cfg, fs, data, tc=tc, lc=lc, device=args.device,
                       mesh=mesh)

    metrics = run_with_restarts(factory, max_restarts=args.restarts)
    if rank0:
        print("[launch] done:", {k: round(float(v), 4)
                                 for k, v in metrics.items()})
    fs.close()
    if mesh is not None and started:
        dist.destroy_process_group()
    return metrics


if __name__ == "__main__":
    main()
