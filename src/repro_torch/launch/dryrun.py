"""Dry-run of the production cells: trace every (architecture × input
shape) cell's step on the production meshes, one rank standing for all,
on fake tensors over a fake process group; prove each cell's sharding is
coherent, and read its roofline terms and per-device peak memory.

Usage:
    python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--multi-pod-only|--single-pod-only]
    python -m repro_torch.launch.dryrun --all --out build/dryrun_torch

A ``"fake"`` default process group of 256 (16×16: data, model) or 512
(2×16×16: pod, data, model) ranks is started before the mesh is made
(``torch.testing._internal.distributed.fake_pg``: its collectives return at
once and move nothing), and ``launch.mesh.make_production_mesh`` builds the
mesh over it.  Under ``FakeTensorMode`` each cell then runs the step the
card would run, on rank 0's shards: ``make_train_step`` with
``train_shardings`` and ZeRO-1, ``make_encode_step`` for an encoder-only
prefill, ``make_prefill_step`` / ``make_decode_step`` with
``serve_shardings``.  On ``cuda`` fakes ``kernels/ops.py`` sends the
kernels' calls to their wrappers, whose shape-only twins
(``kernels/_twin.py``) allocate what each launch allocates and charge its
cost; nothing is launched and no card is asked.  ``--device cpu`` traces
the plain versions instead.

``--device`` defaults to ``cuda`` where this torch is built with CUDA and
to ``cpu`` where it is not: on a CPU-only build the autograd engine cannot
run a backward over fake CUDA tensors (it asks CUDA's device guard and
accelerator hooks, which such a build lacks, and aborts), so the train
cells could not be traced there.  Each record says which device it traced.

Per cell, while the step runs:
    FlopCounterMode   the products (forward and backward), plus each twin's
                      FLOPs (``flops_per_device``; ``flops_per_device_raw``
                      the products alone);
    OpBytes           every operation's input and output bytes, views
                      and allocations excluded: eager torch's unfused
                      traffic, plus each twin's bytes (its inputs read
                      once, its outputs written once) in
                      ``bytes_per_device``;
    CollectiveCounter the c10d operations' result bytes by kind;
    MemTracker        the peak of live tensor bytes on the device (the
                      inputs, the step's temporaries and its outputs).

Record keys: the reference's (arch, shape, mesh, status, reason,
``RooflineTerms.to_dict()``, n_params, scan_layers, memory_analysis,
flops_per_device_raw), with ``lower_s`` / ``compile_s`` replaced by
``trace_s``, and the port's own: device, world_size, kernels (each twin's
launches, by body too, FLOPs and bytes), ops (the operations ``OpBytes``
counted).
The reference's ``hlo_size`` and ``attn_flops_correction_per_device`` have
no counterpart and are dropped: no HLO, and the flash kernel's FLOPs come
from its own formula (``flash_attention_cost`` of the visible pairs), not
from an analytic remainder.  ``memory_analysis`` holds the tracker's peak
(``peak_bytes``), the step's inputs (``argument_bytes``) and the peak by
the tracker's kinds.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.kernels._twin import KernelCosts
from repro_torch.launch import specs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import (CollectiveCounter, OpBytes,
                                         RooflineTerms)
from repro_torch.models import param_specs
from repro_torch.parallel.sharding import batch_pspecs, shard_tree
from repro_torch.train.steps import (TrainConfig, make_decode_step,
                                     make_encode_step, make_prefill_step,
                                     make_train_step, serve_shardings,
                                     train_shardings)
from repro_torch.tree import tree_leaves, tree_map

DEFAULT_OUT = "build/dryrun_torch"


def default_device() -> str:
    """``cuda`` where this torch is built with CUDA, else ``cpu``."""
    return "cuda" if torch.backends.cuda.is_built() else "cpu"


def mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def start_fake_group(world_size: int) -> None:
    """A ``"fake"`` default process group of ``world_size`` ranks, this
    process rank 0; one of another size or backend is destroyed first."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if (dist.get_backend() == "fake"
                and dist.get_world_size() == world_size):
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def _materialize(tree, device, values: bool = False):
    """Tensors of ``tree``'s meta shapes and dtypes on ``device`` (fake
    ones, under ``FakeTensorMode``); with ``values``, real ones holding
    small normal floats, zero integers and true booleans.  Other leaves
    pass through."""
    def make(t):
        if not isinstance(t, torch.Tensor):
            return t
        if not values:
            return torch.empty(t.shape, dtype=t.dtype, device=device)
        if t.dtype.is_floating_point:
            return torch.randn(t.shape, device=device).mul(0.02).to(t.dtype)
        if t.dtype == torch.bool:
            return torch.ones(t.shape, dtype=t.dtype, device=device)
        return torch.zeros(t.shape, dtype=t.dtype, device=device)
    return tree_map(make, tree)


def cell_inputs(cfg, cell, mesh, tc: TrainConfig):
    """(step, rank 0's meta inputs, model FLOPs, the whole parameter tree
    on meta): the step the card would run on this cell and the local
    shards it takes."""
    B, S = cell.global_batch, cell.seq_len
    if cell.step == "train":
        full = param_specs(cfg)
        bspec = specs.batch_specs(cfg, S, B, training=True)
        sh = train_shardings(cfg, mesh, full, bspec, zero1=tc.zero1)
        moments = shard_tree(full, sh["opt"]["m"])
        opt = {"m": moments, "v": moments,
               "count": torch.empty((), dtype=torch.int32, device="meta")}
        args = (shard_tree(full, sh["params"]), opt,
                shard_tree(bspec, sh["batch"]), 3e-4)
        return (make_train_step(cfg, tc, mesh=mesh), args,
                cfg.model_flops(B * S, training=True, seq_len=S), full)
    full = param_specs(cfg, dtype=torch.bfloat16)
    if cell.step == "prefill" and not cfg.supports_decode():
        # encoder-only: prefill_32k is a pure encode forward (no cache)
        bspec = specs.batch_specs(cfg, S, B, training=False)
        sh = train_shardings(cfg, mesh, full, bspec, zero1=False)
        args = (shard_tree(full, sh["params"]),
                shard_tree(bspec, sh["batch"]))
        return (make_encode_step(cfg, mesh=mesh), args,
                cfg.model_flops(B * S, training=False, seq_len=S), full)
    cshape = specs.cache_specs(cfg, B, S)
    sh = serve_shardings(cfg, mesh, full, cshape, B, S)
    params, cache = shard_tree(full, sh["params"]), \
        shard_tree(cshape, sh["cache"])
    if cell.step == "prefill":
        bspec = specs.batch_specs(cfg, S, B, training=False)
        batch = shard_tree(bspec, batch_pspecs(cfg, bspec, mesh), mesh)
        return (make_prefill_step(cfg, mesh=mesh, batch=B, max_len=S),
                (params, batch, cache),
                cfg.model_flops(B * S, training=False, seq_len=S), full)
    tok = {"tokens": specs.decode_token_specs(B)}
    tok = shard_tree(tok, batch_pspecs(cfg, tok, mesh), mesh)["tokens"]
    return (make_decode_step(cfg, mesh=mesh, batch=B, max_len=S),
            (params, tok, cache),
            cfg.model_flops(B, training=False, kv_len=S), full)


def trace_step(step, args, device, *, fake: bool = True) -> dict:
    """Run ``step`` on fake tensors of ``args``' meta shapes on ``device``
    under the counters; returns what they read.  ``fake=False`` runs it on
    real tensors (``_materialize``'s values) under the same counters: what
    a trace must equal."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode
    device = torch.device(device)
    with FakeTensorMode() if fake else contextlib.nullcontext():
        fargs = _materialize(args, device, values=not fake)
        inputs = [t for t in tree_leaves(fargs) if isinstance(t, torch.Tensor)]
        tracker = MemTracker()
        tracker.track_external(*inputs)
        t0 = time.monotonic()
        with tracker, KernelCosts() as kernels, \
                FlopCounterMode(display=False) as flops, OpBytes() as ops, \
                CollectiveCounter() as coll:
            step(*fargs)
        trace_s = time.monotonic() - t0
        peak = tracker.get_tracker_snapshot("peak")
    at = next((v for k, v in peak.items()
               if torch.device(k).type == device.type), {"Total": 0})
    return dict(trace_s=trace_s, products=float(flops.get_total_flops()),
                kernels=kernels, op_bytes=float(ops.bytes), ops=ops.ops,
                coll=coll.collective_bytes(),
                peak=int(at["Total"]),
                peak_by_kind={str(getattr(k, "value", k)): int(v)
                              for k, v in at.items() if k != "Total"},
                argument_bytes=sum(t.numel() * t.element_size()
                                   for t in inputs))


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             train_cfg: TrainConfig | None = None,
             scan_layers: bool = False,
             cfg_overrides: dict | None = None,
             verbose: bool = True, device: str | None = None) -> dict:
    """One (arch × shape × mesh) cell on rank 0 of the production mesh (a
    fake group of its size is started if none is).

    scan_layers: the ``TrainConfig`` field; the port's layer loop runs
    every layer under either value, so the record differs in that key
    only.  cfg_overrides: ``dataclasses.replace`` overrides on the
    ModelConfig (a cut in depth, say)."""
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    cell = specs.SHAPES[shape_name]
    name = mesh_name(multi_pod)
    ok, reason = specs.cell_supported(cfg, shape_name)
    rec = {"arch": arch, "shape": shape_name, "mesh": name,
           "status": "skipped", "reason": reason}
    if not ok:
        return rec
    device = device or default_device()
    if torch.device(device).type == "cuda" and \
            not torch.backends.cuda.is_built():
        # a backward over fake CUDA tensors would abort the process
        raise ValueError("this torch is built without CUDA: trace on "
                         "device='cpu'")
    if not dist.is_initialized():
        start_fake_group(math.prod((2, 16, 16) if multi_pod else (16, 16)))
    mesh = make_production_mesh(multi_pod=multi_pod, device=device)
    chips = math.prod(mesh.shape)
    tc = train_cfg or TrainConfig()
    tc = dataclasses.replace(tc, scan_layers=scan_layers)

    step, args, model_flops, full = cell_inputs(cfg, cell, mesh, tc)
    n_params = sum(t.numel() for t in tree_leaves(full))
    got = trace_step(step, args, device)
    kc = got["kernels"]
    flops = got["products"] + kc.flops
    coll_total = sum(v for k, v in got["coll"].items()
                     if not k.startswith("n_"))
    terms = RooflineTerms(
        arch=arch, shape=shape_name, mesh=name, chips=chips,
        flops_per_device=flops, bytes_per_device=got["op_bytes"] + kc.bytes,
        coll_bytes_per_device=coll_total, coll_breakdown=got["coll"],
        model_flops=model_flops,
        peak_memory_per_device=float(got["peak"]))
    rec.update(terms.to_dict())
    rec.update({
        "status": "ok", "n_params": int(n_params),
        "trace_s": round(got["trace_s"], 2),
        "memory_analysis": {"peak_bytes": got["peak"],
                            "argument_bytes": got["argument_bytes"],
                            "peak_by_kind": got["peak_by_kind"]},
        "scan_layers": scan_layers,
        "flops_per_device_raw": got["products"],
        "device": torch.device(device).type, "world_size": chips,
        "kernels": kc.by_kernel, "ops": got["ops"],
    })
    if verbose:
        print(f"[dryrun] {arch} × {shape_name} × {name} ({rec['device']}): "
              f"traced in {got['trace_s']:.1f}s; "
              f"bottleneck={terms.bottleneck} "
              f"compute={terms.compute_s * 1e3:.2f}ms "
              f"memory={terms.memory_s * 1e3:.2f}ms "
              f"collective={terms.collective_s * 1e3:.2f}ms "
              f"useful_flops={terms.useful_flops_ratio:.2f} "
              f"peak={got['peak'] / 1e9:.2f}GB")
    return rec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(specs.SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--multi-pod-only", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--remat", default="dots_no_batch")
    ap.add_argument("--act-mode", default="dp")
    ap.add_argument("--scan-layers", action="store_true",
                    help="the reference's production scan variant; the "
                         "port traces every layer under either value")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="the device the fake tensors claim (default: "
                         "cuda where torch is built with CUDA, else cpu)")
    args = ap.parse_args()

    archs = [args.arch] if args.arch else ARCH_IDS
    shapes = [args.shape] if args.shape else list(specs.SHAPES)
    meshes = []
    if not args.multi_pod_only:
        meshes.append(False)
    if not args.single_pod_only:
        meshes.append(True)
    if not (args.all or args.arch):
        ap.error("pass --all or --arch")

    device = args.device or default_device()
    print(f"[dryrun] fake tensors on {device}")
    tc = TrainConfig(remat_policy=args.remat, activation_mode=args.act_mode)
    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    failures = []
    t0 = time.monotonic()
    # one process group a mesh size: every cell of a mesh, then the next
    for mp in meshes:
        name = mesh_name(mp)
        for arch in archs:
            for shape in shapes:
                path = outdir / f"{arch}__{shape}__{name}.json"
                if path.exists() and not args.force:
                    print(f"[dryrun] cached: {path}")
                    continue
                start_fake_group(math.prod((2, 16, 16) if mp else (16, 16)))
                try:
                    rec = run_cell(arch, shape, multi_pod=mp, train_cfg=tc,
                                   scan_layers=args.scan_layers,
                                   device=device)
                except Exception as e:
                    rec = {"arch": arch, "shape": shape, "mesh": name,
                           "status": "failed", "error": repr(e),
                           "traceback": traceback.format_exc()}
                    failures.append((arch, shape, name, repr(e)))
                    print(f"[dryrun] FAILED {arch} × {shape} × {name}: "
                          f"{e!r}")
                path.write_text(json.dumps(rec, indent=2))
    print(f"\n[dryrun] wall {time.monotonic() - t0:.1f}s")
    if failures:
        print(f"\n[dryrun] {len(failures)} FAILURES:")
        for f in failures:
            print("  ", *f)
        raise SystemExit(1)
    print("\n[dryrun] all requested cells traced OK")


if __name__ == "__main__":
    main()
