"""The port's dry-run slice (``launch/specs.py``, ``launch/roofline.py``,
``launch/dryrun.py``, the kernels' shape-only twins) against the JAX
package and against itself, on the CPU.

The specs are held cell for cell against the JAX package's (shapes, skips
and their reasons, tokens, the cache's leaves against ``jax.eval_shape``,
the parameter count); the roofline arithmetic against the reference's
``RooflineTerms`` with the reference's constants patched in.  The twins are
held against the plain versions' shapes and dtypes, and the cost functions
against the bounds ``chip_smoke.py`` printed at ``PERF.md``'s shapes (to
4 significant digits, as the table gives them).  The process-group tests
run in subprocesses (a fake group of 1-16 ranks each): the collective
counter, a traced step against the same step run on real CPU tensors
under the same counters (equal FLOPs, bytes, collectives and peak), the
mini dry-run (the twin of ``tests/test_distribution.py``'s) and
``scan_layers``.  A torch built without CUDA cannot differentiate fake
CUDA tensors, so the whole-step traces here run on CPU fakes
(``dryrun.default_device``); the CUDA fakes' trace runs in
``chip_smoke.py``'s dryrun phase.
"""
import json
import math
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import repro.launch.roofline as jax_roofline
import repro.launch.specs as jax_specs
from repro.configs import get_config as jax_get_config
from repro.models import param_specs as jax_param_specs
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.kernels import ops
from repro_torch.kernels._twin import KernelCosts
from repro_torch.kernels.flash_attention import kernel as flash
from repro_torch.kernels.flash_attention.ref import (attention_mask, lse_ref,
                                                     mha_ref)
from repro_torch.kernels.rglru import kernel as lru
from repro_torch.kernels.rglru.ref import rglru_assoc, rglru_bwd
from repro_torch.kernels.rmsnorm import kernel as rms
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
from repro_torch.kernels.ssd import kernel as ssd
from repro_torch.kernels.ssd.ref import ssd_chunked, ssd_chunked_bwd
from repro_torch.launch import roofline, specs
from repro_torch.models import param_specs

ROOT = Path(__file__).resolve().parents[1]
BF16, F32 = torch.bfloat16, torch.float32


def _run(code: str, timeout: int = 240) -> list:
    """Run ``code`` in a fresh interpreter on the repo's ``src``; the JSON
    of each line it prints that starts with ``OUT ``."""
    done = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(code)], cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "OMP_NUM_THREADS": "2"},
        capture_output=True, text=True, timeout=timeout)
    assert done.returncode == 0, done.stderr[-4000:]
    return [json.loads(line[4:]) for line in done.stdout.splitlines()
            if line.startswith("OUT ")]


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------

CELLS = [(a, s) for a in ARCH_IDS for s in specs.SHAPES]


def test_shapes_are_the_reference_cells():
    assert {k: (c.name, c.seq_len, c.global_batch, c.step)
            for k, c in specs.SHAPES.items()} == \
        {k: (c.name, c.seq_len, c.global_batch, c.step)
         for k, c in jax_specs.SHAPES.items()}


def _leaves(tree, path=()):
    """(path, shape, dtype name) of every array leaf of a dict / list tree."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _leaves(v, path + (i,))]
    if hasattr(tree, "shape"):
        return [(path, tuple(tree.shape), str(tree.dtype).split(".")[-1])]
    return []


@pytest.mark.parametrize("arch,shape", CELLS)
def test_specs_match_the_reference(arch, shape):
    """``cell_supported`` with its reason, ``cell_tokens``, the batch's
    shapes and, where the reference's dry-run builds a cache (prefill and
    decode of a decoder), every cache leaf's shape and dtype against
    ``jax.eval_shape`` of the reference's ``cache_specs`` (the step counter
    ``t`` aside: a Python int in the port)."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert specs.cell_supported(cfg, shape) == \
        jax_specs.cell_supported(jcfg, shape)
    assert specs.cell_tokens(shape) == jax_specs.cell_tokens(shape)
    cell = specs.SHAPES[shape]
    train = cell.step == "train"
    ours = specs.batch_specs(cfg, cell.seq_len, cell.global_batch,
                             training=train)
    theirs = jax_specs.batch_specs(jcfg, cell.seq_len, cell.global_batch,
                                   training=train)
    assert {k: tuple(v.shape) for k, v in ours.items()} == \
        {k: tuple(v.shape) for k, v in theirs.items()}
    assert all(v.device.type == "meta" for v in ours.values())
    if cell.step == "decode":
        assert tuple(specs.decode_token_specs(cell.global_batch).shape) == \
            tuple(jax_specs.decode_token_specs(cell.global_batch).shape)
    if train or not cfg.supports_decode() or \
            not specs.cell_supported(cfg, shape)[0]:
        return
    got = specs.cache_specs(cfg, cell.global_batch, cell.seq_len)
    want = jax.eval_shape(lambda: jax_specs.cache_specs(
        jcfg, cell.global_batch, cell.seq_len))
    assert got["t"] == 0
    got.pop("t")
    want = {k: v for k, v in want.items() if k != "t"}
    assert _leaves(got) == _leaves(want)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_n_params_matches_the_reference(arch):
    ours = sum(t.numel() for t in jax.tree.leaves(
        param_specs(get_config(arch)), is_leaf=lambda x: hasattr(x, "numel")))
    theirs = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(
        jax_param_specs(jax_get_config(arch))))
    assert ours == theirs


# ---------------------------------------------------------------------------
# roofline
# ---------------------------------------------------------------------------

def test_roofline_constants_are_the_h100s():
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == \
        (989e12, 3.35e12, 450e9)
    assert roofline.PEAK_OPS_PER_S == {"bf16": 989e12, "tf32": 494.7e12,
                                       "fp32": 67e12}
    assert roofline.COLLECTIVE_OPS == jax_roofline.COLLECTIVE_OPS


@pytest.mark.parametrize("numbers", [
    (256, 3.1e14, 2.2e11, 4.0e9, 7.9e16, 6.1e10),
    (512, 1.0e9, 9.0e11, 0.0, 2.0e11, 1.0e9),
    (1, 5.0e12, 1.0e9, 1.0e12, 0.0, 0.0)])
def test_roofline_arithmetic_matches_the_reference(numbers, monkeypatch):
    """Both packages' ``RooflineTerms`` from the same numbers, the port's
    constants patched to the reference's, give equal ``to_dict()``."""
    chips, flops, nbytes, coll, model, peak = numbers
    monkeypatch.setattr(roofline, "PEAK_FLOPS", jax_roofline.PEAK_FLOPS)
    monkeypatch.setattr(roofline, "HBM_BW", jax_roofline.HBM_BW)
    monkeypatch.setattr(roofline, "LINK_BW", jax_roofline.ICI_BW)
    kw = dict(arch="a", shape="s", mesh="16x16", chips=chips,
              flops_per_device=flops, bytes_per_device=nbytes,
              coll_bytes_per_device=coll,
              coll_breakdown={"all-reduce": coll, "n_all-reduce": 3},
              model_flops=model, peak_memory_per_device=peak)
    assert roofline.RooflineTerms(**kw).to_dict() == \
        jax_roofline.RooflineTerms(**kw).to_dict()


@pytest.mark.parametrize("shape,axes", [((2, 2), ("data", "model")),
                                        ((2, 2, 2), ("pod", "data", "model"))])
def test_collective_counter_bytes_and_counts(shape, axes):
    """A known set of all-reduce, all-gather, reduce-scatter, all-to-all and
    send / recv calls on a fake mesh: each kind's result bytes a device and
    its count, keyed as the reference's ``collective_bytes``.  A gather or
    reduce-scatter along a minor dim comes back contiguous, as the kernels
    take it (the card's multi-rank path; the dry-run found the views)."""
    out, contiguous = _run(f"""
        import json, torch, torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh
        from torch._subclasses.fake_tensor import FakeTensorMode
        from repro_torch.launch.dryrun import start_fake_group
        from repro_torch.launch.roofline import CollectiveCounter
        from repro_torch.parallel import collectives as C
        start_fake_group({math.prod(shape)})
        mesh = init_device_mesh("cpu", {shape}, mesh_dim_names={axes})
        with FakeTensorMode(), CollectiveCounter() as cc:
            x = torch.empty(4, 8)                  # 128 bytes
            C.all_reduce(x, mesh, ("pod", "data")) # one a data axis
            C.all_gather(x, 0, mesh, ("data", "model"))  # 256 + 512
            C.reduce_scatter(torch.empty(8, 8), 0, mesh, "model")  # 128
            dist.all_to_all_single(torch.empty(4, 8), x,
                                   group=mesh.get_group("model"))  # 128
            dist.send(x, dst=1)
            dist.recv(x, src=1)                    # 128, the received
        print("OUT " + json.dumps(cc.collective_bytes()))
        with FakeTensorMode():   # gathered / scattered on a minor dim
            x = torch.empty(3, 4, 8)
            print("OUT " + json.dumps([
                C.all_gather(x, 2, mesh, ("model",)).is_contiguous(),
                C.reduce_scatter(x, 2, mesh, "model").is_contiguous(),
                C.gather_from(x, 1, mesh, "model",
                              partial=True).is_contiguous()]))
        dist.destroy_process_group()
    """)
    assert contiguous == [True, True, True]
    n_reduce = 2 if "pod" in axes else 1
    assert out == {"all-gather": 768.0, "all-reduce": 128.0 * n_reduce,
                   "reduce-scatter": 128.0, "all-to-all": 128.0,
                   "collective-permute": 128.0, "n_all-gather": 2,
                   "n_all-reduce": n_reduce, "n_reduce-scatter": 1,
                   "n_all-to-all": 1, "n_collective-permute": 1}


# ---------------------------------------------------------------------------
# the kernels' twins and costs
# ---------------------------------------------------------------------------

def _specs_of(tensors):
    return [None if t is None else (tuple(t.shape), t.dtype)
            for t in tensors]


def _launches():
    """Every wrapper's count of launches: real launches only."""
    return [fn.launches for fn in (
        rms.rmsnorm_cuda, rms.rmsnorm_bwd_cuda, flash.flash_attention_cuda,
        flash.flash_attention_bwd_cuda, lru.rglru_cuda, lru.rglru_bwd_cuda,
        ssd.ssd_cuda, ssd.ssd_bwd_cuda)]


def _fake_and_real(make, run_twin, run_plain):
    """(the twin's outputs on fake CUDA tensors, the plain version's on
    CPU tensors of the same shapes) and what the twin charged.  Around the
    twin ``OpBytes`` counts nothing (its allocations are no traffic, its
    kernel's bytes are its ``Cost``'s), and no wrapper counts a launch."""
    for module in (rms, flash, lru, ssd):
        module.reset_counts()
    with FakeTensorMode():
        inputs = make("cuda")
        with KernelCosts() as costs, roofline.OpBytes() as op_bytes:
            got = run_twin(*inputs)
    assert op_bytes.bytes == 0
    assert _launches() == [0] * 8
    gen = torch.Generator().manual_seed(0)
    real = make("cpu", gen)
    want = run_plain(*real)
    return _specs_of(got), _specs_of(want), costs


def _charged(cost, body, n=1):
    return dict(launches=n, flops=n * cost.flops, bytes=n * cost.bytes,
                by_body={body: n})


def _randn(shape, dtype, device, gen):
    if device == "cpu" and gen is not None:
        return torch.randn(shape, generator=gen).to(dtype)
    return torch.empty(shape, dtype=dtype, device=device)


def _grads(fn, inputs, outputs_used=1):
    leaves = [t.clone().requires_grad_() if t.is_floating_point() else t
              for t in inputs]
    out = fn(*leaves)
    out = out if isinstance(out, tuple) else (out,)
    total = sum(o.float().sum() for o in out[:outputs_used])
    return torch.autograd.grad(total, [t for t in leaves if t.requires_grad])


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("backward", [False, True])
def test_rmsnorm_twin_matches_the_plain_shapes(dtype, backward):
    def make(dev, gen=None):
        return (_randn((2, 7, 256), dtype, dev, gen),
                _randn((256,), dtype, dev, gen),
                _randn((2, 7, 256), dtype, dev, gen))
    if backward:
        got, want, costs = _fake_and_real(
            make, lambda x, s, dy: rms.rmsnorm_bwd_cuda(x, s, dy),
            lambda x, s, dy: _grads(rmsnorm_ref, (x, s)))
        name, cost = "rmsnorm_bwd", rms.rmsnorm_bwd_cost(14, 256, dtype,
                                                         dtype)
        body = rms.bwd_body_for(256, dtype, dtype)[0]
    else:
        got, want, costs = _fake_and_real(
            make, lambda x, s, dy: (rms.rmsnorm_cuda(x, s),),
            lambda x, s, dy: (rmsnorm_ref(x, s),))
        name, cost = "rmsnorm", rms.rmsnorm_cost(14, 256, dtype, dtype)
        body = rms.body_for(256, dtype, dtype)[0]
    assert got == want
    assert costs.by_kernel == {name: _charged(cost, body)}


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("backward", [False, True])
def test_flash_twin_matches_the_plain_shapes(dtype, backward):
    """q (2, 96, 4, 128), k / v (2, 96, 2, 128), causal with a window: O
    and the lse (B, H, S) fp32, or dq, dk, dv; the autograd Function on
    fakes skips ``select_bwd_body`` (no base address to select by)."""
    kw = dict(causal=True, window=40)

    def make(dev, gen=None):
        return (_randn((2, 96, 4, 128), dtype, dev, gen),
                _randn((2, 96, 2, 128), dtype, dev, gen),
                _randn((2, 96, 2, 128), dtype, dev, gen))
    pairs = flash.visible_pairs(96, **kw)
    if backward:
        def twin(q, k, v):
            o, lse = flash.flash_attention_cuda(q, k, v, return_lse=True,
                                                **kw)
            return flash.flash_attention_bwd_cuda(q, k, v, o, o, lse, **kw)
        got, want, costs = _fake_and_real(
            make, twin, lambda q, k, v: _grads(
                lambda *a: mha_ref(*a, **kw), (q, k, v)))
        name = "flash_attention_bwd"
        cost = flash.flash_attention_bwd_cost(2, 96, 4, 2, 128, dtype, pairs)
        assert costs.by_kernel["flash_attention"]["launches"] == 1
        assert costs.by_kernel[name] == _charged(
            cost, flash._bwd_bodies(dtype, 128, None)[0])
    else:
        def twin(q, k, v):
            o, lse = flash.flash_attention_cuda(q, k, v, return_lse=True,
                                                **kw)
            with torch.no_grad():
                o2 = flash.FlashAttentionFunction.apply(q, k, v, True, 40, 0,
                                                        None)
            return o, lse, o2
        got, want, costs = _fake_and_real(
            make, twin, lambda q, k, v: (mha_ref(q, k, v, **kw),
                                         lse_ref(q, k, **kw),
                                         mha_ref(q, k, v, **kw)))
        want[1] = (want[1][0], F32)     # the kernel's lse is fp32
        cost = flash.flash_attention_cost(2, 96, 4, 2, 128, dtype, pairs,
                                          lse=True)
        assert costs.by_kernel["flash_attention"] == _charged(
            cost, flash._bodies(dtype, 128, None)[0], n=2)
    assert got == want


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("backward", [False, True])
def test_rglru_twin_matches_the_plain_shapes(dtype, backward):
    def make(dev, gen=None):
        return (_randn((2, 70, 64), dtype, dev, gen),
                _randn((2, 70, 64), dtype, dev, gen),
                _randn((2, 64), F32, dev, gen),
                _randn((2, 70, 64), dtype, dev, gen))
    if backward:
        got, want, costs = _fake_and_real(
            make, lambda la, gx, h0, dy: lru.rglru_bwd_cuda(la, gx, dy, h0),
            lambda la, gx, h0, dy: rglru_bwd(la, gx, dy, h0))
        name, cost = "rglru_bwd", lru.rglru_bwd_cost(2, 70, 64, dtype)
    else:
        got, want, costs = _fake_and_real(
            make, lambda la, gx, h0, dy: lru.rglru_cuda(la, gx, h0),
            lambda la, gx, h0, dy: rglru_assoc(la, gx, h0))
        name, cost = "rglru", lru.rglru_cost(2, 70, 64, dtype, h0=True)
    assert got == want
    body = lru.select_body(*make("cpu", torch.Generator())[:3])
    assert costs.by_kernel == {name: _charged(cost, body)}


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("backward", [False, True])
def test_ssd_twin_matches_the_plain_shapes(dtype, backward):
    B, S, H, P, G, N, Q = 2, 64, 4, 16, 1, 32, 32

    def make(dev, gen=None):
        return (_randn((B, S, H, P), dtype, dev, gen),
                _randn((B, S, H), F32, dev, gen).abs() if gen else
                _randn((B, S, H), F32, dev, gen),
                _randn((H,), F32, dev, gen),
                _randn((B, S, G, N), dtype, dev, gen),
                _randn((B, S, G, N), dtype, dev, gen),
                _randn((H,), F32, dev, gen),
                _randn((B, S, H, P), dtype, dev, gen))
    if backward:
        got, want, costs = _fake_and_real(
            make, lambda *a: ssd.ssd_bwd_cuda(*a[:6], a[6], chunk=Q),
            lambda *a: ssd_chunked_bwd(*a[:6], a[6], chunk=Q))
        name, cost = "ssd_bwd", ssd.ssd_bwd_cost(B, S, H, P, G, N, Q, dtype)
    else:
        got, want, costs = _fake_and_real(
            make, lambda *a: ssd.ssd_cuda(*a[:6], chunk=Q),
            lambda *a: ssd_chunked(*a[:6], chunk=Q))
        name, cost = "ssd", ssd.ssd_cost(B, S, H, P, G, N, Q, dtype)
    assert got == want
    real = make("cpu", torch.Generator())
    body = ssd.select_bwd_body(*real, Q) if backward else \
        ssd.select_body(*real[:6], Q)
    assert costs.by_kernel == {name: _charged(cost, body)}


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("D", [64, 130, 512, 1536, 2560, 3584, 5120, 8192])
def test_rmsnorm_twin_picks_the_wrappers_body(dtype, D):
    """On 16-byte aligned contiguous operands (what a fresh allocation is)
    the body a twin counts from the shape alone is the one the wrapper
    selects, forward and backward."""
    x, s = torch.zeros(8, D, dtype=dtype), torch.ones(D, dtype=dtype)
    assert x.data_ptr() % 16 == s.data_ptr() % 16 == 0
    assert rms.body_for(D, dtype, dtype) == rms.select_body(x, s)
    assert rms.bwd_body_for(D, dtype, dtype) == rms.select_bwd_body(x, s, x)


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("dh", flash.HEAD_DIMS)
def test_flash_twin_picks_the_wrappers_body(dtype, dh):
    q = torch.zeros(1, 64, 4, dh, dtype=dtype)
    k = torch.zeros(1, 64, 2, dh, dtype=dtype)
    for scale in (None, -1.0):
        assert flash._bodies(dtype, dh, scale) == \
            flash.bodies_for(q, k, k, scale)
        assert flash._bwd_bodies(dtype, dh, scale) == \
            flash.bwd_bodies_for(q, k, k, scale)


def test_ssd_workspace_mirrors_csrc():
    """The workspace sizes the twins allocate, against ``csrc/ssd.cu``'s
    formulas evaluated by hand at mamba2-130m's train shape."""
    B, S, H, P, G, N, Q = 8, 1024, 24, 64, 1, 128, 128
    nc = 8
    assert ssd.fwd_tf32_workspace_floats(B, S, H, P, G, N, Q) == \
        B * nc * H * P * N + B * H * nc * Q + B * nc * G * 128 * 128
    scratch = B * H * nc * Q + 2 * B * nc * H * P * N + B * H * P * N \
        + 2 * B * S * H * N + 2 * B * nc * H
    assert ssd.bwd_workspace_floats("mma", B, S, H, P, G, N, Q) == \
        scratch + B * nc * G * 2 * 128 * 128
    assert ssd.bwd_workspace_floats("fma", B, S, H, P, G, N, Q) == \
        scratch + B * nc * H * (3 * 128 * 128 + 32 * 128 + 2 * 32 * 128)


def test_ssd_workspace_mirrors_csrc_with_two_slabs():
    """The mma backward's workspace at mamba2-130m's train step with head
    dim 128 (``csrc/ssd.cu``'s formulas by hand): dB, dC and the dA / dD
    parts once a slab of P (two), then C·Bᵀ and its transpose, then each
    slab's ddt; the fma body's is unchanged (one slab)."""
    B, S, H, P, G, N, Q = 8, 1024, 12, 128, 1, 128, 128
    nc = 8
    assert ssd.bwd_slabs(P) == 2
    head = B * H * nc * Q + 2 * B * nc * H * P * N + B * H * P * N
    assert ssd.bwd_workspace_floats("mma", B, S, H, P, G, N, Q) == \
        head + 2 * 2 * B * S * H * N + 2 * B * nc * H * 2 \
        + B * nc * G * 2 * 128 * 128 + 2 * B * S * H
    assert ssd.bwd_workspace_floats("fma", B, S, H, P, G, N, Q) == \
        head + 2 * B * S * H * N + 2 * B * nc * H \
        + B * nc * H * (3 * 128 * 128 + 32 * 128 + 2 * 32 * 128)


@pytest.mark.parametrize("S,causal,window,chunk", [
    (96, True, 0, 0), (96, True, 40, 0), (96, False, 0, 0),
    (100, True, 0, 32), (130, False, 16, 0), (64, True, 100, 48)])
def test_visible_pairs_counts_the_mask(S, causal, window, chunk):
    pos = torch.arange(S)
    mask = attention_mask(pos, pos, causal=causal, window=window, chunk=chunk)
    assert flash.visible_pairs(S, causal, window, chunk) == int(
        mask.expand(S, S).sum())


def _pairs(S, **kw):
    return flash.visible_pairs(S, **kw)


# (name, cost, chip_smoke.py's former bytes and operations at that shape,
# the bound PERF.md's table gives there)
_E = {F32: 4, BF16: 2}
BOUNDS = [
    ("rmsnorm (2048, 3584) bf16", lambda: rms.rmsnorm_cost(
        2048, 3584, BF16, BF16), (2 * 2048 * 3584 * 2 + 3584 * 2,
                                  4 * 2048 * 3584), 0.008766),
    ("rmsnorm bwd (4096, 512) fp32", lambda: rms.rmsnorm_bwd_cost(
        4096, 512, F32, F32), (3 * 4096 * 512 * 4 + 2 * 512 * 4,
                               10 * 4096 * 512), 0.007513),
    ("rmsnorm bwd (8192, 1536) fp32", lambda: rms.rmsnorm_bwd_cost(
        8192, 1536, F32, F32), (3 * 8192 * 1536 * 4 + 2 * 1536 * 4,
                                10 * 8192 * 1536), 0.04508),
    ("flash qwen2-7b prefill", lambda: flash.flash_attention_cost(
        4, 512, 28, 4, 128, BF16, _pairs(512)),
     ((2 * 4 * 512 * 28 + 2 * 4 * 512 * 4) * 128 * 2,
      4 * 4 * 28 * 128 * _pairs(512)), 0.01002),
    ("flash recurrentgemma-9b train_4k, lse", lambda:
     flash.flash_attention_cost(1, 4096, 16, 1, 256, BF16,
                                _pairs(4096, window=2048), lse=True),
     ((2 * 4096 * 16 + 2 * 4096) * 256 * 2 + 16 * 4096 * 4,
      4 * 16 * 256 * _pairs(4096, window=2048)), 0.1042),
    ("flash fp32 100m, lse", lambda: flash.flash_attention_cost(
        16, 256, 8, 4, 64, F32, _pairs(256), lse=True),
     ((2 * 16 * 256 * 8 + 2 * 16 * 256 * 4) * 64 * 4 + 16 * 8 * 256 * 4,
      2 * 3 * 2 * 16 * 8 * _pairs(256) * 64), 0.00755),
    ("flash hubert 32k, no mask", lambda: flash.flash_attention_cost(
        1, 32768, 16, 16, 80, BF16, 32768 ** 2),
     (4 * 32768 * 16 * 80 * 2, 4 * 16 * 80 * 32768 ** 2), 5.559),
    ("flash stablelm-12b train_4k, lse", lambda: flash.flash_attention_cost(
        1, 4096, 32, 8, 160, BF16, _pairs(4096), lse=True),
     ((2 * 4096 * 32 + 2 * 4096 * 8) * 160 * 2 + 32 * 4096 * 4,
      4 * 32 * 160 * _pairs(4096)), 0.1738),
    ("flash bwd fp32 100m", lambda: flash.flash_attention_bwd_cost(
        16, 256, 8, 4, 64, F32, _pairs(256)),
     (2 * (16 * 256 * 8 + 2 * 16 * 256 * 4) * 64 * 4
      + 2 * 16 * 256 * 8 * 64 * 4 + 16 * 8 * 256 * 4,
      2 * 3 * 5 * 16 * 8 * _pairs(256) * 64), 0.01634),
    ("flash bwd bf16 dh 256 train_4k", lambda:
     flash.flash_attention_bwd_cost(1, 4096, 16, 1, 256, BF16,
                                    _pairs(4096, window=2048)),
     (2 * (4096 * 16 + 2 * 4096) * 256 * 2 + 2 * 4096 * 16 * 256 * 2
      + 16 * 4096 * 4, 2 * 5 * 16 * _pairs(4096, window=2048) * 256),
     0.2606),
    ("flash bwd bf16 dh 160 train_4k", lambda:
     flash.flash_attention_bwd_cost(1, 4096, 32, 8, 160, BF16,
                                    _pairs(4096)),
     (2 * (4096 * 32 + 2 * 4096 * 8) * 160 * 2 + 2 * 4096 * 32 * 160 * 2
      + 32 * 4096 * 4, 2 * 5 * 32 * _pairs(4096) * 160), 0.4344),
    ("flash bwd bf16 dh 128 qwen2-vl-2b", lambda:
     flash.flash_attention_bwd_cost(4, 1024, 12, 2, 128, BF16,
                                    _pairs(1024)),
     (2 * (4 * 1024 * 12 + 2 * 4 * 1024 * 2) * 128 * 2
      + 2 * 4 * 1024 * 12 * 128 * 2 + 4 * 12 * 1024 * 4,
      2 * 5 * 4 * 12 * _pairs(1024) * 128), 0.03260),
    ("rglru (4, 512, 4096) fp32, h0", lambda: lru.rglru_cost(
        4, 512, 4096, F32, h0=True),
     (3 * 4 * 512 * 4096 * 4 + 2 * 4 * 4096 * 4, 9 * 4 * 512 * 4096),
     0.03009),
    ("rglru bwd (4, 512, 4096) fp32", lambda: lru.rglru_bwd_cost(
        4, 512, 4096, F32), (5 * 4 * 512 * 4096 * 4, 30 * 4 * 512 * 4096),
     0.05008),
    ("ssd bf16 mamba2-130m prefill", lambda: ssd.ssd_cost(
        4, 512, 24, 64, 1, 128, 128, BF16),
     (2 * 4 * 512 * 24 * 64 * 2 + 4 * 512 * 24 * 4 + 2 * 4 * 512 * 128 * 2
      + 2 * 4 * 24 + 4 * 24 * 64 * 128 * 4,
      2 * ssd.ssd_split_macs(4, 512, 24, 64, 1, 128, 128)), 0.005067),
    ("ssd fp32 mamba2-130m step", lambda: ssd.ssd_cost(
        8, 1024, 24, 64, 1, 128, 128, F32),
     (2 * 8 * 1024 * 24 * 64 * 4 + 8 * 1024 * 24 * 4
      + 2 * 8 * 1024 * 128 * 4 + 2 * 4 * 24 + 8 * 24 * 64 * 128 * 4,
      2 * 3 * ssd.ssd_macs(8, 1024, 24, 64, 1, 128, 128)), 0.04729),
    ("ssd bwd fp32 mamba2-130m step", lambda: ssd.ssd_bwd_cost(
        8, 1024, 24, 64, 1, 128, 128, F32),
     (3 * 8 * 1024 * 24 * 64 * 4 + 2 * 8 * 1024 * 24 * 4
      + 4 * 8 * 1024 * 128 * 4 + 4 * 4 * 24,
      2 * ssd.ssd_bwd_split_macs(8, 1024, 24, 64, 1, 128, 128)), 0.1551),
]


@pytest.mark.parametrize("name,cost,former,perf_ms", BOUNDS,
                         ids=[b[0] for b in BOUNDS])
def test_cost_functions_give_chip_smokes_bounds(name, cost, former, perf_ms):
    """Each cost function returns the bytes and operations ``chip_smoke.py``
    computed inline at that shape before they moved into the package, and
    so the bound ``PERF.md``'s table prints."""
    c = cost()
    assert (c.bytes, c.ops) == former
    ms, _ = roofline.cost_bound_ms(c)
    assert float(f"{ms:.4g}") == pytest.approx(perf_ms, rel=2e-4)


def test_cpu_tensors_never_reach_a_twin():
    """Real CPU tensors through ``ops`` (forward and autograd's backward)
    charge no twin and count no launch; a wrapper given one raises; fake
    CPU tensors go to the plain versions too."""
    for module in (rms, flash, lru, ssd):
        module.reset_counts()
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(3, 5, 64, generator=gen, requires_grad=True)
    q = torch.randn(2, 16, 2, 32, generator=gen, requires_grad=True)
    with KernelCosts() as costs:
        y = ops.rmsnorm(x, torch.ones(64)).sum() \
            + ops.flash_attention(q, q, q).sum() \
            + ops.rglru_scan(-x.abs(), x)[0].sum()
        y.backward()
        with FakeTensorMode():
            ops.rmsnorm(torch.empty(4, 64), torch.empty(64))
            ops.flash_attention(*(torch.empty(1, 8, 2, 32),) * 3)
    assert costs.by_kernel == {}
    assert rms.rmsnorm_cuda.launches == flash.flash_attention_cuda.launches \
        == lru.rglru_cuda.launches == rms.rmsnorm_bwd_cuda.launches == 0
    with pytest.raises(ValueError, match="CUDA"):
        rms.rmsnorm_cuda(x.detach(), torch.ones(64))
    with pytest.raises(ValueError, match="CUDA"):
        flash.flash_attention_cuda(*(q.detach(),) * 3)


# ---------------------------------------------------------------------------
# the dry-run on fake process groups
# ---------------------------------------------------------------------------

def test_trace_equals_the_run():
    """A smoke config's train step on a world-size-1 mesh, on CPU fakes,
    counts what the same step counts run on real CPU tensors: the same
    products, bytes, collectives and peak of live bytes."""
    outs = _run("""
        import dataclasses, json
        import repro_torch.launch.dryrun as D
        from repro_torch.configs import get_smoke_config
        from repro_torch.launch.mesh import make_debug_mesh
        from repro_torch.launch.specs import ShapeCell
        from repro_torch.train.steps import TrainConfig
        D.start_fake_group(1)
        mesh = make_debug_mesh(1, device="cpu")
        for arch in ("qwen2-7b", "recurrentgemma-9b"):
            cfg = get_smoke_config(arch)
            step, args, _, _ = D.cell_inputs(
                cfg, ShapeCell("t", 64, 2, "train"), mesh, TrainConfig())
            for fake in (True, False):
                got = D.trace_step(step, args, "cpu", fake=fake)
                print("OUT " + json.dumps({k: got[k] for k in (
                    "products", "op_bytes", "ops", "coll", "peak",
                    "argument_bytes")}))
    """)
    assert len(outs) == 4
    for traced, run in (outs[:2], outs[2:]):
        assert traced == run
        assert traced["products"] > 0 and traced["peak"] > \
            traced["argument_bytes"] > 0


MINI = """
    import json, torch
    from torch.distributed.device_mesh import init_device_mesh
    import repro_torch.configs as C
    import repro_torch.launch.dryrun as D
    import repro_torch.launch.specs as S
    D.start_fake_group(16)
    D.make_production_mesh = lambda multi_pod=False, device="cpu": (
        init_device_mesh(device, (2, 2, 4) if multi_pod else (4, 4),
                         mesh_dim_names=("pod", "data", "model") if multi_pod
                         else ("data", "model")))
    # shrink the shape cells so a 16-rank trace is quick
    S.SHAPES = {"train_4k": S.ShapeCell("train_4k", 256, 16, "train"),
                "prefill_32k": S.ShapeCell("prefill_32k", 256, 16,
                                           "prefill"),
                "decode_32k": S.ShapeCell("decode_32k", 256, 16, "decode")}
    D.get_config = C.get_smoke_config
"""


def test_dryrun_cell_mini():
    """The twin of ``tests/test_distribution.py::test_dryrun_cell_mini``:
    ``run_cell`` on 16 fake ranks, the (4, 4) and (2, 2, 4) meshes, the
    smoke configs and shrunk cells: qwen2-7b train_4k and recurrentgemma-9b
    decode_32k, and hubert-xlarge's encode-only prefill_32k and
    moonshot-v1-16b-a3b's MoE train_4k.  Each reports ok and a coherent
    record."""
    recs = _run(MINI + """
    for mp in (False, True):
        for arch, shape in (("qwen2-7b", "train_4k"),
                            ("recurrentgemma-9b", "decode_32k"),
                            ("hubert-xlarge", "prefill_32k"),
                            ("moonshot-v1-16b-a3b", "train_4k")):
            rec = D.run_cell(arch, shape, multi_pod=mp, verbose=False)
            print("OUT " + json.dumps(rec))
    """)
    assert len(recs) == 8
    for rec in recs:
        assert rec["status"] == "ok", rec
        assert rec["chips"] == rec["world_size"] == 16
        assert rec["mesh"] in ("16x16", "2x16x16")
        assert rec["flops_per_device"] > 0 and rec["bytes_per_device"] > 0
        assert rec["peak_memory_per_device"] > \
            rec["memory_analysis"]["argument_bytes"] > 0
        assert rec["bottleneck"] in ("compute", "memory", "collective")
        assert rec["coll_bytes_per_device"] == sum(
            v for k, v in rec["coll_breakdown"].items()
            if not k.startswith("n_"))
        if rec["shape"] == "train_4k":   # the data-parallel gradient sum
            assert rec["coll_breakdown"]["n_all-reduce"] > 0


def test_scan_layers_changes_only_its_key():
    """``scan_layers`` True and False give the same record (the port's
    layer loop runs every layer under either), apart from that key and the
    trace's wall time."""
    a, b = _run(MINI + """
    for scan in (False, True):
        rec = D.run_cell("recurrentgemma-9b", "train_4k", multi_pod=False,
                         scan_layers=scan, verbose=False)
        print("OUT " + json.dumps(rec))
    """)
    assert (a["scan_layers"], b["scan_layers"]) == (False, True)
    for rec in (a, b):
        assert rec["status"] == "ok"
        del rec["scan_layers"], rec["trace_s"]
    assert a == b


def test_dryrun_skips_what_the_reference_skips():
    """Cells the reference's ``cell_supported`` refuses come back as
    ``skipped`` with its reason, before any process group is asked."""
    from repro_torch.launch.dryrun import run_cell
    for arch in ARCH_IDS:
        for shape in specs.SHAPES:
            ok, reason = jax_specs.cell_supported(jax_get_config(arch),
                                                  shape)
            if not ok:
                assert run_cell(arch, shape, multi_pod=False,
                                verbose=False) == {
                    "arch": arch, "shape": shape, "mesh": "16x16",
                    "status": "skipped", "reason": reason}


def test_every_reference_module_has_a_twin():
    """Every ``.py`` module of ``src/repro`` has a twin path under
    ``src/repro_torch`` (the JAX ``kernels/<name>/kernel.py`` files by the
    port's own ``kernel.py``)."""
    ref = ROOT / "src" / "repro"
    port = ROOT / "src" / "repro_torch"
    missing = [str(p.relative_to(ref)) for p in sorted(ref.rglob("*.py"))
               if "__pycache__" not in p.parts
               and not (port / p.relative_to(ref)).is_file()]
    assert missing == []
    for kernel in sorted((ref / "kernels").glob("*/kernel.py")):
        assert (port / kernel.relative_to(ref)).is_file()
