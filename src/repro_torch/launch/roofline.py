"""Roofline terms of a traced step, with the H100's constants; and the
least time of a kernel's ``Cost``.

    compute term    = FLOPs / (chips × peak FLOP/s)
    memory term     = bytes / (chips × HBM bandwidth)
    collective term = collective bytes / (chips × link bandwidth)

The dry-run (``launch/dryrun.py``) traces one rank's step on fake tensors
and reads its FLOPs, bytes and collective bytes per device from three
counters: ``torch.utils.flop_counter.FlopCounterMode`` (the products) plus
each kernel twin's ``Cost`` (``kernels/_twin.py``); ``OpBytes`` (every
operation's input and output bytes, views and allocations excluded: eager
torch's unfused traffic) plus each twin's ``Cost.bytes`` (each kernel's
inputs read once and outputs written once); and ``CollectiveCounter`` (the
c10d operations the step issues: the reference parses the same from its
compiled HLO, ``collective_bytes(hlo_text)``, which has no input in torch).

Constants: NVIDIA H100 80GB HBM3 (H100 SXM), 700 W, from NVIDIA's data
sheet, the figures ``PERF.md``'s bounds use.  ``LINK_BW`` is NVLink 4's
450 GB/s a direction (900 GB/s both ways) within one node of eight cards,
the data sheet's figure: one card cannot measure it, and an axis of 16
ranks spans two nodes, whose links (InfiniBand, 50 GB/s a card at 400
Gb/s) are slower; one value is kept, as the reference keeps one
``ICI_BW``.  None of
the reference's v5e constants (197 TFLOP/s, 819 GB/s, 50 GB/s) is used.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

# NVIDIA H100 80GB HBM3, 700 W (H100 SXM data sheet)
PEAK_FLOPS = 989e12      # dense bf16 on the tensor cores
HBM_BW = 3.35e12         # HBM3, bytes a second
LINK_BW = 450e9          # NVLink 4, bytes a second a direction
# the peak of each unit a kernel's operations run on (``kernels._twin.Cost``)
PEAK_OPS_PER_S = {"bf16": PEAK_FLOPS,
                  "tf32": 494.7e12,     # dense TF32 on the tensor cores
                  "fp32": 67e12}        # fp32 outside the tensor cores
_UNITS = {torch.bfloat16: "bf16", torch.float32: "fp32"}

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute")
# the c10d operations the port issues (``parallel/collectives.py``,
# ``compress.py``, ``pipeline.py``), as the dispatcher names them, by the
# reference's kind; a send is the other half of a recv (whose received
# bytes are the result)
_C10D_KINDS = {"allreduce_": "all-reduce", "_allgather_base_": "all-gather",
               "_reduce_scatter_base_": "reduce-scatter",
               "alltoall_base_": "all-to-all",
               "recv_": "collective-permute"}


def bound_ms(n_bytes: float, n_ops: float, unit) -> tuple[float, str]:
    """(the least ms, "bytes" or "operations"): the larger of ``n_bytes``
    over HBM and ``n_ops`` over ``unit``'s peak ("bf16", "tf32", "fp32",
    or a torch dtype for its own)."""
    t_bytes = n_bytes / HBM_BW * 1e3
    t_ops = n_ops / PEAK_OPS_PER_S[_UNITS.get(unit, unit)] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cost_bound_ms(cost) -> tuple[float, str]:
    """``bound_ms`` of a kernel's ``Cost``."""
    return bound_ms(cost.bytes, cost.ops, cost.unit)


def _tensor_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_flatten(tree)[0]
               if isinstance(t, torch.Tensor))


class CollectiveCounter(TorchDispatchMode):
    """Per-kind result bytes a device of the c10d operations issued while
    entered (each its in-place or output tensors), and their counts."""

    def __init__(self):
        super().__init__()
        self.bytes = dict.fromkeys(COLLECTIVE_OPS, 0.0)
        self.counts = dict.fromkeys(COLLECTIVE_OPS, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "c10d":
            kind = _C10D_KINDS.get(func._opname)
            if kind is not None:
                self.bytes[kind] += _tensor_bytes(args[0])
                self.counts[kind] += 1
        return func(*args, **(kwargs or {}))

    def collective_bytes(self) -> dict[str, float]:
        """The reference's ``collective_bytes`` dict: the kinds with bytes,
        then ``n_<kind>`` for the kinds issued."""
        out = {k: v for k, v in self.bytes.items() if v}
        return {**out, **{f"n_{k}": v for k, v in self.counts.items() if v}}


# what moves no tensor bytes: collectives (``CollectiveCounter`` counts
# them), metadata queries (a fake tensor's ``prim.device``) and
# allocations (an output no one has written yet; a like-shaped input read
# for its shape only)
_NOT_PASSES = ("c10d", "prim")
_ALLOCATIONS = frozenset(("empty", "empty_like", "empty_strided",
                          "empty_permuted", "new_empty", "new_empty_strided"))


class OpBytes(TorchDispatchMode):
    """The bytes every operation reads and writes while entered (its tensor
    inputs and outputs), views, allocations, collectives and metadata
    queries excluded: what eager torch moves, each operation a pass over
    memory.  A kernel twin's own traffic is its ``Cost.bytes``
    (``KernelCosts``), not counted here."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if (func.namespace not in _NOT_PASSES and not func.is_view
                and func._opname not in _ALLOCATIONS):
            self.bytes += _tensor_bytes((args, kwargs)) + _tensor_bytes(out)
            self.ops += 1
        return out


@dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    coll_bytes_per_device: float
    coll_breakdown: dict = field(default_factory=dict)
    model_flops: float = 0.0
    peak_memory_per_device: float = 0.0

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.coll_bytes_per_device / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        global_flops = self.flops_per_device * self.chips
        return self.model_flops / global_flops if global_flops else 0.0

    @property
    def step_time_s(self) -> float:
        """Roofline step-time estimate: max of the three terms (perfect
        overlap assumption)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the pure-compute roofline achieved if the step ran at
        the max-term estimate and all traced FLOPs were useful model FLOPs:
        (model FLOPs / chips / peak) / step time."""
        ideal = self.model_flops / self.chips / PEAK_FLOPS
        return ideal / self.step_time_s if self.step_time_s else 0.0

    def to_dict(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "coll_bytes_per_device": self.coll_bytes_per_device,
            "coll_breakdown": self.coll_breakdown,
            "model_flops": self.model_flops,
            "peak_memory_per_device": self.peak_memory_per_device,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "step_time_s": self.step_time_s,
            "roofline_fraction": self.roofline_fraction,
        }
