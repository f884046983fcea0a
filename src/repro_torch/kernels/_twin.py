"""Shape-only twins of the kernels' launches, and what each kernel costs.

A wrapper given a fake tensor (``torch._subclasses.fake_tensor.is_fake``:
a tensor of the dry-run's ``FakeTensorMode``, which holds no data) takes
its twin: the outputs, workspaces and partial sums the launch allocates,
of the same shapes and dtypes, with nothing launched, no body chosen from
base addresses and no card queried (grids are sized for the H100's
``H100_SMS``).  A twin's launch is counted in ``KernelCosts``, by kernel
and body, never on the wrapper's own counters (``launches``,
``launches_by_body``), which count the kernels the card ran.  This is
shape inference for tensors that hold no data, not a fallback: a real
CUDA tensor always launches or raises, and a CPU tensor never reaches a
wrapper (``ops.py`` sends it to the plain version).

Each kernel's cost is a pure function of its shapes beside its wrapper
(``rmsnorm_cost``, ``flash_attention_cost``, ...): a ``Cost`` of the bytes
it must move (each input read once, each output written once), the
operations its body runs and the unit they run on (the peak of
``launch.roofline.PEAK_OPS_PER_S`` that bounds them), and the FLOPs of its
function (its products at 2 a multiply-add, unsplit, or its elementwise
operations).  ``chip_smoke.py`` takes its bounds from these; each twin
charges its cost to every ``KernelCosts`` entered around it.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch._subclasses.fake_tensor import is_fake

# SMs of the H100 SXM (NVIDIA H100 80GB HBM3): the grids a twin sizes
# where the launch asks the card
H100_SMS = 132


def fake(t) -> bool:
    """Whether ``t`` is a fake tensor.  A plain ``torch.Tensor`` answers
    with one type check, so the card's path pays no more."""
    return type(t) is not torch.Tensor and is_fake(t)


@dataclass(frozen=True)
class Cost:
    bytes: int          # each input read once, each output written once
    ops: int            # the operations the body runs, splits included
    unit: str           # "bf16" | "tf32" | "fp32": the peak they run at
    flops: int          # the function's own: products unsplit, 2 a MAC


class KernelCosts:
    """What the twins stood in for while this is entered: their FLOPs,
    bytes and launches, in all and by kernel name (and its launches by
    body)."""

    def __init__(self):
        self.flops = 0
        self.bytes = 0
        self.by_kernel: dict[str, dict] = {}

    def __enter__(self):
        _OPEN.append(self)
        return self

    def __exit__(self, *exc):
        _OPEN.remove(self)

    def add(self, name: str, cost: Cost, body: str) -> None:
        self.flops += cost.flops
        self.bytes += cost.bytes
        k = self.by_kernel.setdefault(name, dict(launches=0, flops=0,
                                                 bytes=0, by_body={}))
        k["launches"] += 1
        k["flops"] += cost.flops
        k["bytes"] += cost.bytes
        k["by_body"][body] = k["by_body"].get(body, 0) + 1


_OPEN: list[KernelCosts] = []


def count_launch(fn, body: str) -> None:
    """One launch of the wrapper ``fn`` on ``body``: called where the
    kernel was launched, and nowhere else."""
    fn.launches += 1
    fn.launches_by_body[body] += 1


def charge(name: str, cost: Cost, body: str) -> None:
    """Add one launch of ``name`` on ``body`` at ``cost`` to every open
    counter."""
    for counter in _OPEN:
        counter.add(name, cost, body)
