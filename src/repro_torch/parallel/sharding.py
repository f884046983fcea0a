"""Sharding rules: parameter, optimizer-state, batch and cache partition
specs for every architecture on the production meshes, the reference's
rules entry for entry; and how a rank holds them: ``shard_tree`` cuts a
full tree to this rank's local shards (``place_tree`` also moves them to
the device), ``gather_tree`` puts them back together on every rank,
``gather_tree_to_origin`` on the origin rank's host alone.

Mesh axes:
    pod    — slowest links.  Data-parallel by default; only the gradient
             sum crosses it (optionally int8-compressed, ``compress.py``),
             or pipeline stages (``pipeline.py``).
    data   — data parallelism (+ ZeRO-1 optimizer sharding).
    model  — tensor parallelism.

Rules are Megatron-style:
    attn  : wq/wk/wv column-parallel (heads on model), wo row-parallel
    ffn   : gate/up column-parallel, down row-parallel
    moe   : experts on model (EP); shared expert like ffn
    rglru : width on model
    embed : vocab-sharded; lm_head vocab-sharded (column)
    ssd   : replicated (mamba2-130m is small)

The reference hands these specs to GSPMD; here they say which slice of
each tensor a rank holds, and the model (``activation_constrainer``'s
``Constrainer`` in ``ctx["constrain"]``) runs the collectives that the
partitioner would insert.  A mesh is a ``DeviceMesh`` or, for the rules
alone, an ``AbstractMesh`` (sizes and names, no devices).
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import TYPE_CHECKING, Any

import torch
import torch.distributed as dist

from repro_torch.tree import tree_map, tree_map_with_path
from . import collectives as C

if TYPE_CHECKING:
    from repro_torch.models.config import ModelConfig


def _entry(part):
    """A spec entry as jax's PartitionSpec keeps it: a 1-tuple of axes is
    its one name, an empty tuple is None."""
    if isinstance(part, (tuple, list)):
        part = tuple(part)
        if not part:
            return None
        return part[0] if len(part) == 1 else part
    return part


class P(tuple):
    """A partition spec: one entry per leading dim of a tensor, each None
    (not sharded), an axis name, or a tuple of axis names (the first
    major).  Dims past the last entry are not sharded."""

    def __new__(cls, *parts):
        return super().__new__(cls, tuple(_entry(p) for p in parts))

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(self)


def is_spec(x) -> bool:
    return isinstance(x, P)


@dataclass(frozen=True)
class AbstractMesh:
    """Axis sizes and names, no devices: what the rules read of a mesh."""
    shape: tuple
    mesh_dim_names: tuple


@dataclass(frozen=True)
class NamedSharding:
    mesh: Any
    spec: P


def dp_axes(mesh) -> tuple:
    """The data-parallel meta-axis: ('pod', 'data') on multi-pod meshes."""
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def _axis_size(mesh, name: str) -> int:
    return C.axis_size(mesh, name)


def _path_names(path: tuple) -> tuple:
    """The dict keys of a leaf's path (sequence indices dropped)."""
    return tuple(p for p in path if isinstance(p, str))


def _shape(leaf) -> tuple:
    return tuple(getattr(leaf, "shape", ()))


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------

def _param_rule(path: tuple, shape: tuple, cfg: ModelConfig, mesh,
                replicate_embed: bool = False) -> P:
    """path: dict keys along the tree; ``shape`` without the superblock
    axis (the caller prepends its None)."""
    name = path[-1]
    parent = path[-2] if len(path) >= 2 else ""
    m = "model"

    def ok(dim_size):  # only shard when divisible
        return dim_size % _axis_size(mesh, m) == 0

    # embeddings / head
    if name == "embed":
        if replicate_embed:
            return P(None, None)
        return P(m, None) if ok(shape[0]) else P()
    if name == "lm_head":
        return P(None, m) if ok(shape[1]) else P()
    if name == "frontend_proj":
        return P(None, m) if ok(shape[1]) else P()

    # attention
    if name in ("wq", "wk", "wv"):
        return P(None, m) if ok(shape[-1]) else P(None, None)
    if name in ("bq", "bk", "bv"):
        return P(m) if ok(shape[-1]) else P(None)
    if name == "wo":
        return P(m, None) if ok(shape[-2]) else P(None, None)

    # dense ffn / shared expert
    if parent in ("ffn", "shared"):
        if name in ("gate", "up"):
            return P(None, m) if ok(shape[-1]) else P(None, None)
        if name == "down":
            return P(m, None) if ok(shape[-2]) else P(None, None)

    # moe experts: EP on model
    if name in ("w_gate", "w_up", "w_down"):
        return P(m, None, None) if ok(shape[-3]) else P(None, None, None)
    if name == "router":
        return P(None, None)

    # rglru
    if name in ("in_x", "in_gate"):
        return P(None, m) if ok(shape[-1]) else P(None, None)
    if name in ("a_gate_w", "x_gate_w"):
        return P(m, None, None) if ok(shape[-3]) else P(None, None, None)
    if name in ("a_gate_b", "x_gate_b"):
        return P(m, None) if ok(shape[-2]) else P(None, None)
    if name == "a_param":
        return P(m) if ok(shape[-1]) else P(None)
    if name == "out":
        return P(m, None) if ok(shape[-2]) else P(None, None)

    # ssd (mamba2), norms, scalars, conv taps: replicate
    return P(*([None] * len(shape)))


def param_pspecs(cfg: ModelConfig, params_shape, mesh, *,
                 replicate_embed: bool = False):
    """params_shape: the parameter tree (meta tensors will do)."""
    def rule(path, leaf):
        names = _path_names(path)
        shape = _shape(leaf)
        # stacked superblock leaves carry a leading n_superblocks axis
        stacked = len(names) >= 1 and names[0] == "blocks"
        core = shape[1:] if stacked else shape
        spec = _param_rule(names, core, cfg, mesh,
                           replicate_embed=replicate_embed)
        return P(None, *spec) if stacked else spec
    return tree_map_with_path(rule, params_shape)


def zero1_specs(param_specs, params_shape, mesh):
    """ZeRO-1: extend each spec by sharding the largest unsharded dim over
    'data' when divisible (the optimizer moments only)."""
    dsize = _axis_size(mesh, "data")
    if dsize == 1:
        return param_specs

    def extend(spec: P, leaf):
        shape = _shape(leaf)
        parts = list(spec) + [None] * (len(shape) - len(spec))
        cand = [(shape[i], i) for i in range(len(shape))
                if parts[i] is None and shape[i] % dsize == 0 and shape[i] > 1]
        if not cand:
            return spec
        _, i = max(cand)
        parts[i] = "data"
        return P(*parts)

    return tree_map(extend, param_specs, params_shape, is_leaf=is_spec)


# ---------------------------------------------------------------------------
# batch / cache specs
# ---------------------------------------------------------------------------

def _prod(mesh, axes) -> int:
    return math.prod(_axis_size(mesh, a) for a in axes)


def batch_pspecs(cfg: ModelConfig, batch_shape: dict, mesh) -> dict:
    dp = dp_axes(mesh)
    out = {}
    for k, v in batch_shape.items():
        shape = _shape(v)
        nb = shape[0] if shape else 1
        lead = dp if nb % _prod(mesh, dp) == 0 else None
        out[k] = P(lead, *([None] * (len(shape) - 1)))
    return out


def cache_pspecs(cfg: ModelConfig, cache_shape, mesh, *,
                 seq_axes: tuple = ()):
    """Decode-cache specs.  KV layout (B, Sc, K, dh) (+ leading superblock
    axis when stacked).  Batch on dp when divisible; kv-heads on model when
    divisible, else the sequence dim over ``seq_axes`` (distributed
    flash-decode handles the softmax)."""
    dp = dp_axes(mesh)
    dp_total = _prod(mesh, dp)
    msize = _axis_size(mesh, "model")
    seq_total = _prod(mesh, seq_axes) if seq_axes else 1

    def rule(path, leaf):
        names = _path_names(path)
        name = names[-1]
        shape = _shape(leaf)
        stacked = names[0] == "blocks"
        core = shape[1:] if stacked else shape
        if name in ("k", "v"):
            B, Sc, K, dh = core
            bspec = dp if B % dp_total == 0 and B > 1 else None
            if K % msize == 0:
                spec = P(bspec, None, "model", None)
            elif seq_axes and Sc % seq_total == 0:
                sa = tuple(a for a in seq_axes
                           if bspec is None or a not in bspec)
                spec = P(bspec, sa, None, None)
            else:
                spec = P(bspec, None, None, None)
        elif name == "pos":
            if seq_axes and core[0] % seq_total == 0:
                spec = P(tuple(seq_axes))
            else:
                spec = P(None)
        elif name in ("conv", "state", "h"):
            B = core[0]
            bspec = dp if B % dp_total == 0 and B > 1 else None
            spec = P(bspec, *([None] * (len(core) - 1)))
        elif name == "t":
            spec = P()
        else:
            spec = P(*([None] * len(core)))
        return P(None, *spec) if stacked else spec

    return tree_map_with_path(rule, cache_shape)


def make_shardings(mesh, specs):
    return tree_map(lambda s: NamedSharding(mesh, s), specs, is_leaf=is_spec)


# ---------------------------------------------------------------------------
# local shards
# ---------------------------------------------------------------------------

def _axes_of(part) -> tuple:
    if part is None:
        return ()
    return part if isinstance(part, tuple) else (part,)


def _spec_of(sharding):
    return sharding.spec if isinstance(sharding, NamedSharding) else sharding


def shard_tensor(x: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """This rank's shard of the full tensor ``x`` under ``spec``: a
    contiguous copy where some dim is cut, ``x`` itself where none is."""
    cut = False
    for dim, part in enumerate(spec):
        axes = _axes_of(part)
        if axes:
            idx, n = C.axes_index(mesh, axes)
            x = C.local_slice(x, dim, idx, n)
            cut = True
    return x.contiguous() if cut else x


def gather_tensor(x: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """The full tensor from this rank's shard under ``spec`` (a collective:
    every rank of the mesh calls it)."""
    for dim, part in enumerate(spec):
        axes = _axes_of(part)
        if axes:
            x = C.all_gather(x, dim, mesh, axes)
    return x


def shard_tree(tree, shardings, mesh=None):
    """Full tensors -> this rank's shards.  ``shardings``: a matching tree
    of ``NamedSharding`` (or of specs, with ``mesh``); None leaves it
    whole.  Non-tensor leaves pass through."""
    def cut(x, sh):
        if sh is None or not isinstance(x, torch.Tensor):
            return x
        return shard_tensor(x, _spec_of(sh), getattr(sh, "mesh", mesh))
    return tree_map(cut, tree, shardings)


def gather_tree(tree, shardings, mesh=None):
    """This rank's shards -> the full tensors, on every rank."""
    def put(x, sh):
        if sh is None or not isinstance(x, torch.Tensor):
            return x
        return gather_tensor(x, _spec_of(sh), getattr(sh, "mesh", mesh))
    return tree_map(put, tree, shardings)


def place_tree(tree, shardings, device, mesh=None):
    """Full tensors (on the host) -> this rank's shards on ``device``, one
    leaf at a time, so ``device`` holds only this rank's shards."""
    def put(x, sh):
        if not isinstance(x, torch.Tensor):
            return x
        if sh is not None:
            x = shard_tensor(x, _spec_of(sh), getattr(sh, "mesh", mesh))
        return x if device is None else x.to(device)
    return tree_map(put, tree, shardings)


def origin_rank(mesh) -> int:
    """The global rank at the mesh's origin (0 along every axis)."""
    return int(mesh.mesh[(0,) * len(mesh.mesh_dim_names)])


def _rank_at(mesh, coords: dict) -> int:
    return int(mesh.mesh[tuple(coords.get(a, 0)
                               for a in mesh.mesh_dim_names)])


def gather_tensor_to_origin(x: torch.Tensor, spec: P, mesh):
    """The full tensor on the host of the origin rank, None on the others.
    Only the ranks whose shards differ send (those at 0 along every axis
    ``spec`` does not use), once each, point to point: no other rank
    builds the whole tensor, and the origin's device holds one shard more
    than its own at a time.  Every rank of the mesh calls it."""
    used = [a for part in spec for a in _axes_of(part)]
    me, origin = dist.get_rank(), origin_rank(mesh)
    if me != origin:
        coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
        if all(c == 0 for a, c in coord.items() if a not in used):
            dist.send(x.contiguous(), dst=origin)
        return None
    shape = list(x.shape)
    for dim, part in enumerate(spec):
        for a in _axes_of(part):
            shape[dim] *= C.axis_size(mesh, a)
    full = torch.empty(shape, dtype=x.dtype)
    for combo in itertools.product(*(range(C.axis_size(mesh, a))
                                     for a in used)):
        coords = dict(zip(used, combo))
        src = _rank_at(mesh, coords)
        if src == me:
            buf = x
        else:
            buf = torch.empty_like(x, memory_format=torch.contiguous_format)
            dist.recv(buf, src=src)
        view = full
        for dim, part in enumerate(spec):
            axes = _axes_of(part)
            if axes:
                idx = 0
                for a in axes:
                    idx = idx * C.axis_size(mesh, a) + coords[a]
                view = view.narrow(dim, idx * x.shape[dim], x.shape[dim])
        view.copy_(buf)
    return full


def gather_tree_to_origin(tree, shardings, mesh=None):
    """This rank's shards -> the full tensors on the origin rank's host,
    leaf by leaf (``gather_tensor_to_origin``); None leaves elsewhere.  A
    leaf with no sharding is the origin's own, copied to the host."""
    def put(x, sh):
        if not isinstance(x, torch.Tensor):
            return x
        m = getattr(sh, "mesh", mesh)
        return gather_tensor_to_origin(
            x, P() if sh is None else _spec_of(sh), m)
    return tree_map(put, tree, shardings)


# ---------------------------------------------------------------------------
# activation layout: the collectives the model runs (ctx["constrain"])
# ---------------------------------------------------------------------------

class Constrainer:
    """The activation layout of one mesh and mode, and the collectives that
    keep it.  ``dp``: the batch split over the data axes, activations whole
    along the sequence on every ``model`` rank.  ``dp_sp``: the residual
    stream also split on ``model`` along the sequence (Megatron sequence
    parallelism): gathered before the column-parallel products,
    reduce-scattered after the row-parallel ones.

    Without a mesh, or on a ``model`` axis of 1, every method is the
    identity, so the one-device path runs the same operations as before."""

    def __init__(self, mesh=None, mode: str = "dp", exclude=()):
        if mode not in ("dp", "dp_sp"):
            raise ValueError(f"unknown activation mode {mode!r}")
        self.mesh, self.mode = mesh, mode
        self.dp = tuple(a for a in dp_axes(mesh) if a not in exclude) \
            if mesh is not None else ()
        self.size = _axis_size(mesh, "model") if mesh is not None else 1
        self.index = C.axis_index(mesh, "model") if mesh is not None else 0
        self.dp_size = _prod(mesh, dp_axes(mesh)) if mesh is not None else 1
        self.sp = mode == "dp_sp" and self.size > 1

    # -- refusals ---------------------------------------------------------

    def refuse_tp(self, what: str) -> None:
        """A block that tensor parallelism does not cover yet."""
        if self.size > 1:
            raise NotImplementedError(
                f"{what} under tensor parallelism (model={self.size}) is not "
                "ported yet; run it on a mesh with model=1")

    def refuse_dp(self, what: str) -> None:
        if self.dp_size > 1:
            raise NotImplementedError(
                f"{what} needs global-batch statistics, which data "
                f"parallelism (data ranks {self.dp_size}) does not compute "
                "yet; run it on one data rank")

    # -- regions ----------------------------------------------------------

    def enter(self, h):
        """Before column-parallel products: the input whole along the
        sequence, its gradient summed over ``model``."""
        if self.size == 1:
            return h
        if self.sp:
            return C.gather_from(h, 1, self.mesh, "model", partial=True)
        return C.copy_to(h, self.mesh, "model")

    def exit(self, y):
        """After row-parallel products: the partial sums summed (``dp``),
        or summed and split along the sequence (``dp_sp``)."""
        if self.size == 1:
            return y
        if self.sp:
            return C.reduce_scatter_to(y, 1, self.mesh, "model")
        return C.reduce_from(y, self.mesh, "model")

    def norm_scale(self, w):
        """A norm's scale: under ``dp_sp`` each rank normalises its own
        positions, so the scale's gradient is summed over ``model``."""
        return C.copy_to(w, self.mesh, "model") if self.sp else w

    def param(self, w):
        """A replicated weight used for this rank's share of the work (a
        replicated ``wk`` feeding this rank's heads)."""
        return C.copy_to(w, self.mesh, "model") if self.size > 1 else w

    def gather_last(self, x):
        """The full last dim from column shards; gradient summed."""
        return C.gather_from(x, x.dim() - 1, self.mesh, "model",
                             partial=True)

    def reduce(self, x):
        """A sum over ``model`` in the forward, identity backward."""
        return C.reduce_from(x, self.mesh, "model")

    def max(self, x):
        """The largest over ``model`` (not differentiable)."""
        return C.all_reduce(x.detach().contiguous().clone(), self.mesh,
                            ("model",), dist.ReduceOp.MAX)

    def gather_sequence(self, x):
        """Under ``dp_sp``, the whole sequence for work done the same on
        every rank (its gradient: this rank's slice)."""
        if not self.sp:
            return x
        return C.gather_from(x, 1, self.mesh, "model", partial=False)

    def replicated(self, fn, x):
        """``fn`` computed whole on every ``model`` rank (a block whose
        weights the rules replicate): under ``dp_sp`` its input gathered
        along the sequence and its output cut back to this rank's
        positions."""
        if not self.sp:
            return fn(x)
        return C.scatter_to(fn(self.gather_sequence(x)), 1, self.mesh,
                            "model")

    def to_sequence_shard(self, x):
        """A tensor whole along the sequence and the same on every rank ->
        this rank's positions (``dp_sp``; identity otherwise)."""
        return C.scatter_to(x, 1, self.mesh, "model") if self.sp else x


WHOLE = Constrainer()   # no mesh: every collective the identity


def activation_constrainer(mesh, mode: str = "dp", exclude=()) -> Constrainer:
    """The activation layout hook threaded into the model
    (``ctx["constrain"]``).

    dp     — batch-only (B on dp)
    dp_sp  — sequence parallelism: the residual stream also split on model
             along the sequence in the norm and elementwise regions
    exclude — data axes the step handles itself ('pod' under the
              compressed pod sync)."""
    return Constrainer(mesh, mode, exclude)
