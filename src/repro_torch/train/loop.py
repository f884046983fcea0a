"""The training loop: steps + transactional checkpointing + metrics +
fault-tolerant restart, on one device or, given a mesh, on every rank of
it (each rank runs this loop on its shards; rank 0 alone writes the
checkpoints and the metrics).

Fault model (the paper's, applied to training), as in the reference:

* all host I/O (checkpoints, metrics) goes through CannyFS — eagerly
  ACKed, so the card never stalls on storage latency;
* a checkpoint is a transaction: COMMIT marker last, rollback of partial
  output, restart from the last committed step;
* ``run_with_restarts`` is the job harness: on any step-time failure it
  rolls the engine back, restores the last committed checkpoint and
  continues.

Nothing is jitted: the step is ``make_train_step``'s eager function.
Batches reach the card through pinned host memory and ``non_blocking``
copies, where the reference calls ``jax.device_put``; on a mesh each rank
keeps its rows of the batch and its shards of the parameters and moments
(``train_shardings``), as the reference's ``device_put`` places them.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch

from repro_torch.checkpoint import TransactionalCheckpointManager
from repro_torch.core import CannyFS
from repro_torch.device import resolve_device
from repro_torch.models import ModelConfig, init_params, param_specs
from repro_torch.optim import init_opt_state
from repro_torch.optim.schedule import cosine_with_warmup
from repro_torch.parallel.sharding import place_tree, shard_tree
from repro_torch.train.metrics import MetricsWriter
from repro_torch.train.steps import (TrainConfig, make_train_step,
                                     train_shardings)
from repro_torch.tree import tree_map


@dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    log_every: int = 10
    warmup: int = 10
    seed: int = 0
    keep_ckpts: int = 3


class Trainer:
    def __init__(self, cfg: ModelConfig, fs: CannyFS, data: Iterator[dict],
                 tc: TrainConfig = TrainConfig(),
                 lc: LoopConfig = LoopConfig(), ckpt_dir: str = "ckpt", *,
                 device="cuda", mesh=None):
        self.cfg = cfg
        self.fs = fs
        self.data = data
        self.tc = tc
        self.lc = lc
        self.device = resolve_device(device)
        self.mesh = mesh
        self.ckpt = TransactionalCheckpointManager(fs, ckpt_dir,
                                                   keep=lc.keep_ckpts,
                                                   mesh=mesh)
        self.metrics = MetricsWriter(fs) if self.ckpt.writer else None
        self.shardings: Optional[dict] = None
        self.step_fn: Optional[Callable] = None
        self.state: dict[str, Any] = {}
        self._state_sh: Optional[dict] = None
        self.step = 0

    # ------------------------------------------------------------------

    def init_state(self, sample_batch: dict) -> None:
        """Resume from the last committed checkpoint, or start cold from
        weights drawn with ``lc.seed``.  On a mesh ``sample_batch`` sizes
        the batch shardings, and the state is placed by
        ``train_shardings``: every rank draws the same weights from the
        seed on the host (a CPU generator, where the one-device path draws
        on its device) and moves only its shards to the device."""
        cfg, mesh = self.cfg, self.mesh
        self.step_fn = make_train_step(cfg, self.tc, mesh=mesh)
        pspec = param_specs(cfg)
        state_sh = None
        if mesh is not None:
            bshape = {k: torch.empty(np.shape(v), device="meta")
                      for k, v in sample_batch.items()}
            self.shardings = train_shardings(cfg, mesh, pspec, bshape,
                                             zero1=self.tc.zero1)
            state_sh = {"params": self.shardings["params"],
                        "opt": self.shardings["opt"], "step": None}
        self._state_sh = state_sh
        try:
            like = {"params": pspec, "opt": init_opt_state(pspec),
                    "step": torch.empty((), dtype=torch.int32,
                                        device="meta")}
            step_no, restored = self.ckpt.restore(like, device=self.device,
                                                  shardings=state_sh)
            self.state = restored
            self.step = int(restored["step"])
            if self.ckpt.writer:
                print(f"[trainer] restored committed checkpoint @ {step_no}")
        except FileNotFoundError:
            step = torch.zeros((), dtype=torch.int32, device=self.device)
            if state_sh is None:
                gen = torch.Generator(device=self.device).manual_seed(
                    self.lc.seed)
                params = init_params(cfg, device=self.device,
                                     dtype=torch.float32, generator=gen)
                self.state = {"params": params,
                              "opt": init_opt_state(params), "step": step}
            else:
                # drawn on the host and cut there: the device receives
                # only this rank's shards, and its moments are made at
                # their local (ZeRO-1) shapes
                params = init_params(
                    cfg, device="cpu", dtype=torch.float32,
                    generator=torch.Generator().manual_seed(self.lc.seed))
                local_opt = shard_tree(init_opt_state(pspec),
                                       state_sh["opt"])
                self.state = {
                    "params": place_tree(params, state_sh["params"],
                                         self.device),
                    "opt": tree_map(lambda t: torch.zeros(
                        t.shape, dtype=t.dtype, device=self.device),
                        local_opt),
                    "step": step}
            self.step = 0

    # ------------------------------------------------------------------

    def put_batch(self, batch: dict) -> dict:
        def put(v):
            t = torch.from_numpy(np.asarray(v))
            if self.device.type != "cuda":
                return t.to(self.device)
            return t.pin_memory().to(self.device, non_blocking=True)
        return {k: put(v) for k, v in batch.items()}

    def local_rows(self, batch: dict) -> dict:
        """This rank's rows of a global batch (``train_shardings``' batch
        specs); the batch itself without a mesh."""
        if self.mesh is None:
            return batch
        return shard_tree({k: torch.from_numpy(np.asarray(v))
                           for k, v in batch.items()},
                          self.shardings["batch"])

    def run(self, max_steps: Optional[int] = None) -> dict:
        lc = self.lc
        target = min(self.lc.total_steps,
                     self.step + (max_steps or self.lc.total_steps))
        last_metrics: dict = {}
        t_start = time.monotonic()
        while self.step < target:
            batch = self.put_batch(self.local_rows(next(self.data)))
            lr = cosine_with_warmup(self.step, peak_lr=self.tc.peak_lr,
                                    warmup=lc.warmup, total=lc.total_steps)
            params, opt, m = self.step_fn(
                self.state["params"], self.state["opt"], batch, lr)
            self.state = {"params": params, "opt": opt,
                          "step": torch.tensor(self.step + 1,
                                               dtype=torch.int32,
                                               device=self.device)}
            self.step += 1
            if self.step % lc.log_every == 0 or self.step == target:
                m = {k: float(v) for k, v in m.items()}
                m["steps_per_s"] = self.step / (time.monotonic() - t_start)
                if self.metrics:
                    self.metrics.write(self.step, m)
                last_metrics = m
            if self.step % lc.ckpt_every == 0 or self.step == target:
                res = self.ckpt.save(self.step, self.state,
                                     shardings=self._state_sh)
                if self.metrics:
                    self.metrics.write(self.step, {"ckpt_ack_s": res.ack_s})
        self.ckpt.wait_for_save()
        return last_metrics


def run_with_restarts(make_trainer: Callable[[], Trainer], *,
                      max_restarts: int = 2) -> dict:
    """The job harness: run; on failure, roll back and resubmit (restore
    from last committed checkpoint).  Matches the paper's transaction
    retry loop at job granularity."""
    attempt = 0
    while True:
        trainer = make_trainer()
        try:
            sample = next(trainer.data)
            trainer.init_state(sample)
            return trainer.run()
        except Exception:
            attempt += 1
            trainer.fs.engine.reset_poison()
            trainer.fs.ledger.clear()
            if attempt > max_restarts:
                raise
            print(f"[trainer] step failure; restart {attempt}/{max_restarts}"
                  " from last committed checkpoint")
