"""The port's mesh slice (``launch/mesh.py``, ``parallel/``, the mesh paths
of the steps, the trainer, the checkpoint manager and the launcher)
against the JAX package, on the CPU.

The spec rules are compared entry for entry with the JAX functions on the
production meshes, which need no devices (``jax.sharding.AbstractMesh``).
The multi-rank runs start 2-4 gloo ranks as subprocesses (``torch`` only
in them, one thread each, a file store in the test's temporary
directory), each under its own time limit, so that a hang fails one test;
the parent computes the JAX single-device reference in-process.  The
tolerances are those of ``tests/test_distribution.py``: the train step
1e-4 on the loss and 5e-4 on the parameters, the compressed pod sum 1e-3
and rtol 3e-2 / atol 3e-3, flash-decode 2e-5, the pipeline 2e-4; serving
2e-4 of the largest logit (``tests/test_models.py``'s decode bound).  The
gradients that the ranks sum (gathered from their shards) and the step's
``grad_norm`` are held against ``jax.grad`` of the reference's loss at
``tests/test_torch_train.py``'s 2e-4 (relative L2 a leaf): one AdamW step
from fresh moments is near lr · sign(g), so the parameters alone would not
see a gradient summed at the wrong scale.
"""
import dataclasses
import json
import os
import pickle
import subprocess
import sys
import textwrap
import time
from functools import lru_cache
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JaxAbstractMesh
from jax.sharding import PartitionSpec as JaxP

from repro.configs import ARCH_IDS
from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.kernels.flash_attention.ref import mha_ref as jax_mha_ref
from repro.launch.mesh import make_debug_mesh as jax_debug_mesh
from repro.models import cross_entropy as jax_cross_entropy
from repro.models import decode_step as jax_decode_step
from repro.models import forward_train as jax_forward_train
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import param_specs as jax_param_specs
from repro.models import prefill as jax_prefill
from repro.models.model import _make_ctx as jax_make_ctx
from repro.models.model import _run_stack as jax_run_stack
from repro.optim import init_opt_state as jax_init_opt_state
from repro.parallel import sharding as jsh
from repro.train.steps import TrainConfig as JaxTrainConfig
from repro.train.steps import make_train_step as jax_make_train_step
from repro.train.steps import train_shardings as jax_train_shardings
from repro_torch.checkpoint import TransactionalCheckpointManager
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import CannyFS, LocalBackend
from repro_torch.models import init_cache, param_specs
from repro_torch.models.bridge import params_from_numpy
from repro_torch.optim import init_opt_state
from repro_torch.parallel import sharding as tsh
from repro_torch.tree import tree_leaves

ROOT = Path(__file__).resolve().parents[1]
RANK_TIMEOUT_S = 120
GRAD_REL = 2e-4     # tests/test_torch_train.py's REL

# ---------------------------------------------------------------------------
# (a) the spec rules, entry for entry
# ---------------------------------------------------------------------------

MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}


def _jax_specs(tree) -> list:
    return [tuple(s) for s in jax.tree.leaves(
        tree, is_leaf=lambda x: isinstance(x, JaxP))]


def _port_specs(tree) -> list:
    return [tuple(s) for s in tree_leaves(tree, is_leaf=tsh.is_spec)]


def _meshes(kind):
    shape, names = MESHES[kind]
    return JaxAbstractMesh(shape, names), tsh.AbstractMesh(shape, names)


@pytest.mark.parametrize("kind", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_batch_specs_match_jax(arch, kind):
    """param_pspecs (with and without replicate_embed), zero1_specs and
    batch_pspecs at full size equal the reference's on both production
    meshes, leaf for leaf and entry for entry."""
    jm, tm = _meshes(kind)
    cfg_j, cfg_t = jax_config(arch), get_config(arch)
    shape_j, shape_t = jax_param_specs(cfg_j), param_specs(cfg_t)
    for rep in (False, True):
        sj = jsh.param_pspecs(cfg_j, shape_j, jm, replicate_embed=rep)
        st = tsh.param_pspecs(cfg_t, shape_t, tm, replicate_embed=rep)
        assert _port_specs(st) == _jax_specs(sj), (arch, kind, rep)
        assert _port_specs(tsh.zero1_specs(st, shape_t, tm)) == \
            _jax_specs(jsh.zero1_specs(sj, shape_j, jm))
    for B in (256, 3):
        bj = {k: jax.ShapeDtypeStruct((B, 64), jnp.int32)
              for k in ("tokens", "labels")}
        bt = {k: torch.empty((B, 64), device="meta")
              for k in ("tokens", "labels")}
        assert _port_specs(tsh.batch_pspecs(cfg_t, bt, tm)) == \
            _jax_specs(jsh.batch_pspecs(cfg_j, bj, jm))


def test_batch_specs_cut_positions3_along_its_batch():
    """M-RoPE's ``positions3`` (3, B, S) is cut along B over the data
    axes, where the reference's rule reads its 3 as the batch (GSPMD's
    global arrays make that harmless; the port's ranks hold local rows);
    every other leaf keeps the reference's spec."""
    cfg_j, cfg_t = jax_smoke("qwen2-vl-2b"), get_smoke_config("qwen2-vl-2b")
    jm, tm = _meshes("multipod")
    shapes = {"tokens": (64, 8), "vision_mask": (64, 8),
              "vision_embeds": (64, 4, 16), "positions3": (3, 64, 8)}
    got = tsh.batch_pspecs(cfg_t, {k: torch.empty(v, device="meta")
                                   for k, v in shapes.items()}, tm)
    want = jsh.batch_pspecs(cfg_j, {k: jax.ShapeDtypeStruct(v, jnp.int32)
                                    for k, v in shapes.items()}, jm)
    assert tuple(got["positions3"]) == (None, ("pod", "data"), None)
    for k in ("tokens", "vision_mask", "vision_embeds"):
        assert tuple(got[k]) == tuple(want[k]), k


@pytest.mark.parametrize("kind", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_match_jax(arch, kind):
    """cache_pspecs with no sequence axes, over ``model`` and over the
    data axes and ``model``, at a shardable batch and at batch 1."""
    jm, tm = _meshes(kind)
    cfg_j, cfg_t = jax_config(arch), get_config(arch)
    dp = jsh.dp_axes(jm)
    for B in (32, 1):
        cj = jax.eval_shape(lambda: jax_init_cache(cfg_j, B, 32768))
        ct = init_cache(cfg_t, B, 32768, device="meta")
        for seq in ((), ("model",), tuple(dp) + ("model",)):
            assert _port_specs(tsh.cache_pspecs(cfg_t, ct, tm,
                                                seq_axes=seq)) == \
                _jax_specs(jsh.cache_pspecs(cfg_j, cj, jm, seq_axes=seq)), \
                (arch, kind, B, seq)


# ---------------------------------------------------------------------------
# the one-rank mesh, in process
# ---------------------------------------------------------------------------

def test_one_rank_meshes():
    """Without torchrun: one rank on an in-process store; the debug mesh is
    (1, 1) (data, model), a production mesh refuses the world size."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
    assert not dist.is_initialized()
    try:
        mesh = make_debug_mesh(device="cpu")
        assert tuple(mesh.shape) == (1, 1)
        assert mesh.mesh_dim_names == ("data", "model")
        for multi in (False, True):
            with pytest.raises(ValueError, match="ranks"):
                make_production_mesh(multi_pod=multi, device="cpu")
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# (b) multi-rank runs
# ---------------------------------------------------------------------------

PRELUDE = '''
import os, pickle, sys
import numpy as np, torch, torch.distributed as dist
torch.set_num_threads(1)
RANK, WORLD = int(sys.argv[1]), int(sys.argv[2])
dist.init_process_group("gloo", init_method="file://" + sys.argv[3],
                        rank=RANK, world_size=WORLD)
with open(sys.argv[4], "rb") as f:
    IN = pickle.load(f)
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.tree import tree_map


def mesh_of(shape):
    names = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=names)


def numpy(tree):
    return tree_map(lambda t: t.detach().numpy() if torch.is_tensor(t) else t,
                    tree)


def emit(obj):
    with open(sys.argv[5] + "." + str(RANK), "wb") as f:
        pickle.dump(obj, f)
'''


# every rank has emitted its result; gloo's teardown can abort a process
# at exit (std::terminate from a worker thread) once its peers are gone,
# so the ranks meet and leave without running it
EPILOGUE = '''
dist.barrier()
sys.stdout.flush()
sys.stderr.flush()
os._exit(0)
'''


def run_ranks(body: str, n: int, inputs: dict, tmp: Path) -> list:
    """``body`` (after PRELUDE) in ``n`` gloo ranks; each rank's ``emit``,
    by rank.  Fails (and kills every rank) past RANK_TIMEOUT_S."""
    script = tmp / "rank.py"
    script.write_text(PRELUDE + textwrap.dedent(body) + EPILOGUE)
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump(inputs, f)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    logs = [open(tmp / f"rank{r}.log", "w+") for r in range(n)]
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(n), str(tmp / "store"),
         str(tmp / "in.pkl"), str(tmp / "out")], env=env, stdout=logs[r],
        stderr=subprocess.STDOUT, cwd=tmp) for r in range(n)]
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"ranks passed {RANK_TIMEOUT_S} s:\n" + _tails(logs))
    if any(p.returncode for p in procs):
        pytest.fail("a rank failed:\n" + _tails(logs))
    out = []
    for r in range(n):
        with open(f"{tmp / 'out'}.{r}", "rb") as f:
            out.append(pickle.load(f))
    return out


def _tails(logs) -> str:
    text = []
    for r, f in enumerate(logs):
        f.seek(0)
        text.append(f"--- rank {r}\n" + f.read()[-3000:])
    return "\n".join(text)


def _narrow_qwen2(kv: int = 4):
    """The qwen2-7b smoke config narrowed as the JAX suite narrows it."""
    return {name: dataclasses.replace(fn("qwen2-7b"), d_model=128,
                                      num_heads=8, num_kv_heads=kv,
                                      d_ff=256, vocab_size=256)
            for name, fn in (("jax", jax_smoke), ("torch", get_smoke_config))}


def _narrow_stablelm():
    return {name: dataclasses.replace(fn("stablelm-3b"), d_model=128,
                                      num_heads=4, num_kv_heads=4, d_ff=256,
                                      vocab_size=256)
            for name, fn in (("jax", jax_smoke), ("torch", get_smoke_config))}


def _batch(seed: int = 1, B: int = 8, S: int = 32, vocab: int = 256) -> dict:
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, vocab, (B, S)).astype(np.int32)
            for k in ("tokens", "labels")}


def _jax_grads(cfg, params, batch, z_loss: float):
    """``jax.grad`` of the reference's training loss."""
    def loss_fn(p):
        logits, aux = jax_forward_train(p, batch, cfg, dtype=jnp.float32)
        loss, _ = jax_cross_entropy(logits, batch["labels"],
                                    batch.get("loss_mask"), z_loss=z_loss)
        return loss + cfg.router_aux_coef * aux
    return jax.tree.map(np.asarray, jax.grad(loss_fn)(params))


@lru_cache(maxsize=None)
def _jax_step(arch: str, z_loss: float = 0.0) -> dict:
    """The reference: params, one fp32 step's new params, its loss and
    grad_norm on ``make_debug_mesh(1)``, as ``test_sharded_train_step
    _matches_single_device`` runs its single-device side; and the loss's
    gradient."""
    cfg = {"qwen2-7b": _narrow_qwen2, "stablelm-3b": _narrow_stablelm}[
        arch]()["jax"]
    params = jax_init_params(jax.random.PRNGKey(0), cfg)
    opt = jax_init_opt_state(params)
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    tc = JaxTrainConfig(dtype=jnp.float32, remat_policy="none",
                        z_loss=z_loss)
    mesh = jax_debug_mesh(1)
    bshape = {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
              for k, v in batch.items()}
    sh = jax_train_shardings(cfg, mesh, jax.eval_shape(lambda: params), bshape)
    step = jax.jit(jax_make_train_step(cfg, mesh, tc),
                   in_shardings=(sh["params"], sh["opt"], sh["batch"], None),
                   out_shardings=(sh["params"], sh["opt"], None))
    with mesh:
        p2, _, m = step(params, opt, batch, jnp.float32(1e-3))
    return dict(params=jax.tree.map(np.asarray, params),
                new=jax.tree.map(np.asarray, p2), loss=float(m["loss"]),
                grad_norm=float(m["grad_norm"]),
                grads=_jax_grads(cfg, params, batch, z_loss))


TRAIN_BODY = '''
from repro_torch.configs import get_smoke_config
from repro_torch.models import param_specs
from repro_torch.models.bridge import params_from_numpy
from repro_torch.optim import init_opt_state
from repro_torch.parallel.sharding import gather_tree, shard_tree
from repro_torch.train.steps import (TrainConfig, make_loss_and_grad,
                                     make_train_step, train_shardings)
from repro_torch.tree import tree_leaves
cfg = IN["cfg"]
mesh = mesh_of(IN["mesh"])
params = params_from_numpy(IN["params"], device="cpu")
batch = {k: torch.from_numpy(v).long() for k, v in IN["batch"].items()}
out = {}
for name, kw in IN["runs"].items():
    tc = TrainConfig(dtype=torch.float32, remat_policy="none",
                     **{"z_loss": 0.0, **kw})
    sh = train_shardings(cfg, mesh, param_specs(cfg), batch,
                         zero1=tc.zero1)
    local = shard_tree({"p": params, "o": init_opt_state(params),
                        "b": batch}, {"p": sh["params"], "o": sh["opt"],
                                      "b": sh["batch"]})
    p2, o2, m = make_train_step(cfg, tc, mesh=mesh)(
        local["p"], local["o"], local["b"], 1e-3)
    _, _, grads = make_loss_and_grad(cfg, tc, mesh=mesh)(local["p"],
                                                        local["b"])
    out[name] = dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                     params=numpy(gather_tree(p2, sh["params"])),
                     grads=numpy(gather_tree(grads, sh["params"])),
                     m_local=[tuple(t.shape) for t in tree_leaves(o2["m"])])
emit({**out, **globals().get("EXTRA", {})})
'''


def _train_on_ranks(tmp, arch, mesh, runs):
    params = _jax_step(arch)["params"]
    cfgs = {"qwen2-7b": _narrow_qwen2, "stablelm-3b": _narrow_stablelm}[
        arch]()
    n = int(np.prod(mesh))
    return run_ranks(TRAIN_BODY, n, dict(cfg=cfgs["torch"], mesh=mesh,
                                         params=params, batch=_batch(),
                                         runs=runs), tmp)


def _rel_l2(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(np.asarray(got, np.float64) - want)
                 / max(np.linalg.norm(want), 1e-30))


def _assert_grads_close(got: dict, ref: dict):
    """Every gathered gradient leaf and the step's grad_norm against
    ``jax.grad``'s, relative L2 a leaf."""
    pairs = jax.tree_util.tree_flatten_with_path(ref["grads"])[0]
    leaves = tree_leaves(got["grads"])
    assert len(leaves) == len(pairs)
    for (path, want), g in zip(pairs, leaves):
        assert g.shape == want.shape, jax.tree_util.keystr(path)
        assert _rel_l2(g, want) < GRAD_REL, (jax.tree_util.keystr(path),
                                             _rel_l2(g, want))
    assert abs(got["grad_norm"] - ref["grad_norm"]) < \
        GRAD_REL * ref["grad_norm"], (got["grad_norm"], ref["grad_norm"])


def _assert_step_close(got: dict, arch: str, loss_tol=1e-4, rtol=5e-4,
                       atol=5e-4, z_loss: float = 0.0, grads: bool = True):
    ref = _jax_step(arch, z_loss)
    assert abs(got["loss"] - ref["loss"]) < loss_tol, (got["loss"],
                                                       ref["loss"])
    a, b = tree_leaves(got["params"]), jax.tree.leaves(ref["new"])
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x, y, rtol=rtol, atol=atol)
    if grads:
        _assert_grads_close(got, ref)


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)])
def test_mesh_train_step_matches_jax(tmp_path, mesh):
    """One fp32 step of the narrowed qwen2-7b on (data 1, model 2) and
    (data 2, model 2) gloo ranks, ZeRO-1 on (the reference's default),
    against the reference step on one device: the loss, the gradients
    the ranks sum, grad_norm and the new parameters; without z-loss and
    with the default 1e-4 (on the vocabulary-parallel log-sum-exp)."""
    out = _train_on_ranks(tmp_path, "qwen2-7b", mesh,
                          {"dp": {}, "z": {"z_loss": 1e-4}})
    for rank in out:
        _assert_step_close(rank["dp"], "qwen2-7b")
        _assert_step_close(rank["z"], "qwen2-7b", z_loss=1e-4)


def test_dp_sp_step_equals_dp(tmp_path):
    """Sequence parallelism (the residual stream split along the sequence
    on ``model``) gives the dp step, both the reference's (gradients and
    grad_norm included)."""
    out = _train_on_ranks(tmp_path, "qwen2-7b", (2, 2),
                          {"dp": {}, "dp_sp": {"activation_mode": "dp_sp"}})
    got = out[0]
    _assert_step_close(got["dp_sp"], "qwen2-7b")
    assert abs(got["dp_sp"]["loss"] - got["dp"]["loss"]) < 1e-4
    for x, y in zip(tree_leaves(got["dp_sp"]["params"]),
                    tree_leaves(got["dp"]["params"])):
        np.testing.assert_allclose(x, y, rtol=5e-4, atol=5e-4)


def test_zero1_on_equals_off(tmp_path):
    """ZeRO-1 (moments split over ``data``) gives the step without it, and
    its moments are split; both the reference's (gradients and grad_norm
    included)."""
    out = _train_on_ranks(tmp_path, "qwen2-7b", (2, 2),
                          {"on": {"zero1": True}, "off": {"zero1": False}})
    got = out[0]
    _assert_step_close(got["on"], "qwen2-7b")
    _assert_step_close(got["off"], "qwen2-7b")
    assert got["on"]["m_local"] != got["off"]["m_local"]
    for x, y in zip(tree_leaves(got["on"]["params"]),
                    tree_leaves(got["off"]["params"])):
        np.testing.assert_allclose(x, y, rtol=5e-4, atol=5e-4)


COMPRESS_BODY = '''
import torch.distributed as dist
from repro_torch.parallel import compress
mesh = mesh_of((2, 1, 2))
# the wire of int8_psum: the dtype of every tensor handed to a collective
wire = []
real = {name: getattr(dist, name) for name in
        ("all_to_all_single", "all_gather_into_tensor", "all_reduce")}
def spy(name):
    def call(out, *args, **kw):
        src = args[0] if args and torch.is_tensor(args[0]) else out
        wire.append((name, src.element_size(), str(src.dtype)))
        return real[name](out, *args, **kw)
    return call
x = torch.from_numpy(IN["x"][RANK])
for name in real:
    setattr(dist, name, spy(name))
try:
    s = compress.int8_psum(x, mesh, "pod", scale_axes=("model",))
finally:
    for name, fn in real.items():
        setattr(dist, name, fn)
EXTRA = dict(wire=wire, sum=s.numpy())
''' + TRAIN_BODY


def test_pod_grad_compress_close_to_exact(tmp_path):
    """The int8-compressed pod sum on (pod 2, data 1, model 2): every
    payload at most 2 B an element (int8 exchanged, int16 sums gathered;
    only the scale's MAX is fp32), the sum exactly the integer sum of
    each pod's quantized values, and the compressed step within the
    reference's bounds of the exact one.  The gradients: without
    compression the pod mesh's are ``jax.grad``'s; with it each leaf is
    within half a quantization step (the largest magnitude over both pods'
    own gradients, over 127) of the mean of the pods' gradients, and
    grad_norm is the norm of what was summed."""
    ref = _jax_step("stablelm-3b")
    params = ref["params"]
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 6, 10)).astype(np.float32)
    out = run_ranks(COMPRESS_BODY, 4, dict(
        x=x, cfg=_narrow_stablelm()["torch"], mesh=(2, 1, 2),
        params=params, batch=_batch(),
        runs={"compress": {"pod_grad_compress": True}, "exact": {}}),
        tmp_path)
    for rank in out:
        payload = [w for w in rank["wire"] if w[0] != "all_reduce"]
        assert payload and all(size <= 2 for _, size, _ in payload), \
            rank["wire"]
        assert [w for w in rank["wire"] if w[0] == "all_reduce"] == \
            [("all_reduce", 4, "torch.float32")] * 2   # the scale, 2 axes
    # ranks (pod p, model m) = 2p + m; each pod's leaf is its two model
    # halves, so the scale is the max over the pods' whole leaves
    for m in range(2):
        pods = [x[2 * p + m] for p in range(2)]
        scale = max(np.abs(x).max(), 1e-30 * 127) / 127.0
        q = sum(np.clip(np.round(v / np.float32(scale)), -127, 127)
                for v in pods)
        for p in range(2):
            np.testing.assert_array_equal(out[2 * p + m]["sum"],
                                          q.astype(np.float32)
                                          * np.float32(scale))
    _assert_step_close(out[0]["compress"], "stablelm-3b", loss_tol=1e-3,
                       rtol=3e-2, atol=3e-3, grads=False)
    _assert_step_close(out[0]["exact"], "stablelm-3b")
    # each pod's gradient: its own rows' mean loss (batch split over pod)
    cfg_j = _narrow_stablelm()["jax"]
    batch = _batch()
    half = len(batch["tokens"]) // 2
    pods = [_jax_grads(cfg_j, jax.tree.map(jnp.asarray, params),
                       {k: jnp.asarray(v[p * half:(p + 1) * half])
                        for k, v in batch.items()}, 0.0) for p in range(2)]
    got = out[0]["compress"]
    leaves = tree_leaves(got["grads"])
    for g, g0, g1, exact in zip(leaves, jax.tree.leaves(pods[0]),
                                jax.tree.leaves(pods[1]),
                                jax.tree.leaves(ref["grads"])):
        step = max(np.abs(g0).max(), np.abs(g1).max()) / 127.0
        err = np.abs(g - (g0 + g1) / 2).max()
        assert err <= 0.5 * step * 1.01 + 1e-5 * np.abs(exact).max(), \
            (err, step)
    norm = np.sqrt(sum(float(np.square(g.astype(np.float64)).sum())
                       for g in leaves))
    assert abs(got["grad_norm"] - norm) < GRAD_REL * norm, (got["grad_norm"],
                                                            norm)


FLASH_DECODE_BODY = '''
from repro_torch.parallel.flash_decode import seq_sharded_decode_attention
from repro_torch.parallel.sharding import P, shard_tensor
mesh = mesh_of((2, 2))
q, k, v, k_pos = (torch.from_numpy(IN[n]) for n in ("q", "k", "v", "k_pos"))
kv = P("data", "model", None, None)
got = seq_sharded_decode_attention(
    mesh, ("model",), shard_tensor(q, P("data"), mesh),
    shard_tensor(k, kv, mesh), shard_tensor(v, kv, mesh),
    shard_tensor(k_pos, P("model"), mesh), 39, batch_axes=("data",),
    causal=True)
emit(dict(out=got.numpy(), data=mesh.get_local_rank("data")))
'''


def test_flash_decode_matches_mha_ref(tmp_path):
    """Distributed flash-decode on (data 2, model 2): the batch split over
    ``data``, a half-filled cache's slots over ``model``, against the
    reference's ``mha_ref`` (the JAX suite's case and bound)."""
    B, Sc, H, K, dh = 2, 64, 8, 1, 32
    rng = np.random.default_rng(0)
    q = rng.standard_normal((B, 1, H, dh)).astype(np.float32)
    k = rng.standard_normal((B, Sc, K, dh)).astype(np.float32)
    v = rng.standard_normal((B, Sc, K, dh)).astype(np.float32)
    k_pos = np.where(np.arange(Sc) < 40, np.arange(Sc), -1).astype(np.int32)
    want = np.asarray(jax_mha_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        q_positions=jnp.full((B, 1), 39, jnp.int32),
        k_positions=jnp.broadcast_to(jnp.asarray(k_pos)[None], (B, Sc))))
    out = run_ranks(FLASH_DECODE_BODY, 4, dict(q=q, k=k, v=v, k_pos=k_pos),
                    tmp_path)
    for rank in out:
        row = rank["data"]
        np.testing.assert_allclose(rank["out"], want[row:row + 1],
                                   rtol=2e-5, atol=2e-5)


PIPELINE_BODY = '''
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.model import _make_ctx
from repro_torch.parallel.pipeline import pp_forward, pp_stage_body
from repro_torch.parallel.sharding import P, shard_tree
cfg = IN["cfg"]
mesh = mesh_of((2, 1, 1))
stacked = params_from_numpy(IN["params"], device="cpu")["blocks"]
local = shard_tree(stacked, tree_map(lambda t: P("pod"), stacked), mesh)
x = torch.from_numpy(IN["x"])
mb, S = x.shape[1:3]
ctx = _make_ctx(cfg, torch.arange(S, dtype=torch.int32).expand(mb, S),
                None, 0)
got = pp_forward(mesh, pp_stage_body(cfg, ctx, torch.float32), local, x)
emit(dict(out=got.numpy(), layers=tree_map(lambda t: t.shape[0],
                                           local)[0]["norm1"]))
'''


def test_pp_forward_matches_sequential(tmp_path):
    """GPipe over 2 pod stages (2 superblocks each) against the reference's
    sequential stack, microbatch by microbatch."""
    cfg_j, cfg_t = (dataclasses.replace(fn("stablelm-3b"), num_layers=4,
                                        d_model=64)
                    for fn in (jax_smoke, get_smoke_config))
    params = jax_init_params(jax.random.PRNGKey(0), cfg_j)
    n_micro, mb, S = 4, 2, 16
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                     (n_micro, mb, S, cfg_j.d_model)))
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (mb, S))
    ctx = jax_make_ctx(cfg_j, pos, None, jnp.float32,
                       jnp.zeros((), jnp.int32), None)
    want = np.stack([np.asarray(jax_run_stack(
        params, jnp.asarray(x[i]), cfg_j, ctx, None, dtype=jnp.float32)[0])
        for i in range(n_micro)])
    out = run_ranks(PIPELINE_BODY, 2, dict(
        cfg=cfg_t, params=jax.tree.map(np.asarray, params), x=x), tmp_path)
    for rank in out:
        assert rank["layers"] == 2
        np.testing.assert_allclose(rank["out"], want, rtol=2e-4, atol=2e-4)


SERVE_BODY = '''
from repro_torch.models import init_cache, param_specs
from repro_torch.models.bridge import params_from_numpy
from repro_torch.parallel import flash_decode
from repro_torch.parallel.sharding import batch_pspecs, shard_tree
from repro_torch.train.steps import (make_decode_step, make_prefill_step,
                                     serve_shardings)
cfg, B, max_len = IN["cfg"], IN["B"], IN["max_len"]
mesh = mesh_of((1, 4))
calls = []
real = flash_decode.seq_sharded_decode_attention
def counted(*a, **kw):
    calls.append(1)
    return real(*a, **kw)
flash_decode.seq_sharded_decode_attention = counted
params = params_from_numpy(IN["params"], device="cpu")
cache = init_cache(cfg, B, max_len, torch.float32, device="cpu")
sh = serve_shardings(cfg, mesh, param_specs(cfg), cache, B, max_len)
tokens = {"tokens": torch.from_numpy(IN["tokens"]).long()}
lp, lc = shard_tree(params, sh["params"]), shard_tree(cache, sh["cache"])
lt = shard_tree(tokens, batch_pspecs(cfg, tokens, mesh), mesh)
kw = dict(dtype=torch.float32, mesh=mesh, batch=B, max_len=max_len)
last, lc = make_prefill_step(cfg, **kw)(lp, lt, lc)
logits, toks = [last.numpy()], []
tok = last.argmax(-1)[:, None].to(torch.int32)
dec = make_decode_step(cfg, **kw)
for _ in range(IN["steps"]):
    tok, lg, lc = dec(lp, tok, lc)
    logits.append(lg.numpy())
    toks.append(tok.numpy())
emit(dict(logits=np.stack(logits), tokens=np.concatenate(toks, 1),
          calls=len(calls), cache_k=tuple(lc["blocks"][0]["k"].shape),
          spec=tuple(sh["cache_specs"]["blocks"][0]["k"])))
'''


@pytest.mark.parametrize("max_len,split", [(32, True), (30, False)])
def test_kv_heads_below_model_axis_serving_matches_jax(tmp_path, max_len,
                                                       split):
    """K = 2 KV heads on model 4: the rules cut each KV head's columns over
    two ranks, so each rank gathers whole heads for its query heads.  With
    a cache length that divides over ``model`` the cache is split along the
    sequence and decode goes through ``flash_decode``; with one that does
    not, every rank holds the whole cache.  Prefill and 4 greedy decode
    steps against the reference's, on one device."""
    cfgs = _narrow_qwen2(kv=2)
    cfg_j = cfgs["jax"]
    B, S, steps = 2, 16, 4
    params = jax_init_params(jax.random.PRNGKey(1), cfg_j)
    toks = np.random.default_rng(0).integers(0, 256, (B, S)).astype(np.int32)
    cache = jax_init_cache(cfg_j, B, max_len, jnp.float32)
    last, cache = jax_prefill(params, {"tokens": jnp.asarray(toks)}, cache,
                              cfg_j, dtype=jnp.float32)
    want, want_toks = [np.asarray(last)], []
    tok = jnp.argmax(last, -1).astype(jnp.int32)[:, None]
    for _ in range(steps):
        lg, cache = jax_decode_step(params, tok, cache, cfg_j,
                                    dtype=jnp.float32)
        tok = jnp.argmax(lg, -1).astype(jnp.int32)[:, None]
        want.append(np.asarray(lg))
        want_toks.append(np.asarray(tok))
    want = np.stack(want)
    out = run_ranks(SERVE_BODY, 4, dict(
        cfg=cfgs["torch"], params=jax.tree.map(np.asarray, params),
        tokens=toks, B=B, max_len=max_len, steps=steps), tmp_path)
    scale = float(np.abs(want).max())
    for rank in out:
        assert rank["spec"] == (None, "data", "model" if split else None,
                                None, None)
        assert rank["cache_k"][2:4] == (max_len // 4 if split else max_len,
                                        2)
        assert rank["calls"] == (cfg_j.num_layers * steps if split else 0)
        assert np.abs(rank["logits"] - want).max() / scale < 2e-4
        np.testing.assert_array_equal(rank["tokens"],
                                      np.concatenate(want_toks, 1))


# ---------------------------------------------------------------------------
# the MoE, RG-LRU and modality blocks on a mesh
# ---------------------------------------------------------------------------

BLOCKS_BODY = """
from repro_torch.models import init_cache, param_specs
from repro_torch.models.bridge import params_from_numpy
from repro_torch.optim import init_opt_state
from repro_torch.parallel.sharding import batch_pspecs, gather_tree, shard_tree
from repro_torch.train.steps import (TrainConfig, make_decode_step,
                                     make_encode_step, make_loss_and_grad,
                                     make_prefill_step, make_train_step,
                                     serve_shardings, train_shardings)
mesh = mesh_of(IN["mesh"])
out = {}
for name, job in IN["jobs"].items():
    cfg = job["cfg"]
    params = params_from_numpy(job["params"], device="cpu")
    batch = {k: torch.from_numpy(v).long() if k in ("tokens", "labels")
             else torch.from_numpy(v) for k, v in job["batch"].items()}
    lb = shard_tree(batch, batch_pspecs(cfg, batch, mesh), mesh)
    if job["kind"] == "train":
        tc = TrainConfig(dtype=torch.float32, remat_policy="none",
                         z_loss=0.0, activation_mode=job["mode"])
        sh = train_shardings(cfg, mesh, param_specs(cfg), batch)
        lp = shard_tree(params, sh["params"])
        total, (_, aux), grads = make_loss_and_grad(cfg, tc, mesh=mesh)(lp,
                                                                        lb)
        _, _, m = make_train_step(cfg, tc, mesh=mesh)(
            lp, shard_tree(init_opt_state(params), sh["opt"]), lb, 1e-3)
        out[name] = dict(total=float(total), aux=float(aux),
                         step_total=float(m["total_loss"]),
                         grad_norm=float(m["grad_norm"]),
                         grads=numpy(gather_tree(grads, sh["params"])),
                         local={k: tuple(v.shape) for k, v in
                                lp["blocks"][0]["mixer"].items()}
                         | {k: tuple(v.shape) for k, v in
                            lp["blocks"][0].get("moe", {}).items()
                            if torch.is_tensor(v)})
    elif job["kind"] == "encode":
        sh = train_shardings(cfg, mesh, param_specs(cfg), batch)
        logits = make_encode_step(cfg, dtype=torch.float32, mesh=mesh)(
            shard_tree(params, sh["params"]), lb)
        out[name] = dict(logits=logits.numpy(), local=tuple(
            shard_tree(params, sh["params"])["frontend_proj"].shape))
    else:                                   # prefill, then greedy decode
        B, max_len = batch["tokens"].shape[0], job["max_len"]
        cache = init_cache(cfg, B, max_len, torch.float32, device="cpu")
        sh = serve_shardings(cfg, mesh, param_specs(cfg), cache, B, max_len)
        lp, lc = shard_tree(params, sh["params"]), shard_tree(cache,
                                                              sh["cache"])
        kw = dict(dtype=torch.float32, mesh=mesh, batch=B, max_len=max_len)
        last, lc = make_prefill_step(cfg, **kw)(lp, lb, lc)
        logits, toks = [last.numpy()], []
        tok = last.argmax(-1)[:, None].to(torch.int32)
        dec = make_decode_step(cfg, **kw)
        for _ in range(job["steps"]):
            tok, lg, lc = dec(lp, tok, lc)
            logits.append(lg.numpy())
            toks.append(tok.numpy())
        out[name] = dict(logits=np.stack(logits),
                         tokens=np.concatenate(toks, 1),
                         rows=(mesh.get_local_rank("data"),
                               mesh.size(0)),
                         cache=numpy(gather_tree(lc, sh["cache"])))
emit(out)
"""


def _smoke(arch: str, **changes) -> dict:
    """The smoke config of ``arch`` in both packages, with ``changes``."""
    return {name: dataclasses.replace(fn(arch), **changes)
            for name, fn in (("jax", jax_smoke), ("torch", get_smoke_config))}


def _block_batch(cfg, seed: int = 1, B: int = 4, S: int = 32) -> dict:
    """Tokens and labels, and for the vision stub patch embeddings over a
    mask whose image positions span both halves of the sequence (row 0
    twelve of them from 10 to 21, row 1 fewer Trues than patches) with
    random 3-D positions; for the audio stub frame features."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.modality == "vision_stub":
        n_img = 12
        batch["vision_embeds"] = rng.standard_normal(
            (B, n_img, cfg.d_model)).astype(np.float32)
        mask = np.zeros((B, S), bool)
        mask[0, 10:22] = True
        mask[1, [3, 15, 16, 30]] = True
        mask[2:, 14:26] = True
        batch["vision_mask"] = mask
        batch["positions3"] = rng.integers(0, 2 * S, (3, B, S)).astype(
            np.int32)
    if cfg.modality == "audio_stub":
        batch = {"features": rng.standard_normal((B, S, 512)).astype(
            np.float32)}
    return batch


def _jax_params(cfg_j, seed: int = 0):
    return jax.tree.map(np.asarray, jax_init_params(jax.random.PRNGKey(seed),
                                                    cfg_j))


def _jax_train_ref(cfg_j, params, batch) -> dict:
    """The reference's loss (CE + router_aux_coef · aux), its aux and
    ``jax.grad`` of the loss, on one device."""
    def loss_fn(p):
        logits, aux = jax_forward_train(p, batch, cfg_j, dtype=jnp.float32)
        loss, _ = jax_cross_entropy(logits, batch["labels"], None)
        return loss + cfg_j.router_aux_coef * aux, aux
    (total, aux), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jax.tree.map(jnp.asarray, params))
    return dict(total=float(total), aux=float(aux),
                grads=jax.tree.map(np.asarray, grads))


def _jax_serve_ref(cfg_j, params, tokens, max_len: int, steps: int) -> dict:
    """Prefill and ``steps`` greedy decode steps of the reference, the
    logits of each and the tokens, on one device."""
    p = jax.tree.map(jnp.asarray, params)
    cache = jax_init_cache(cfg_j, tokens.shape[0], max_len, jnp.float32)
    last, cache = jax.jit(lambda p, b, c: jax_prefill(
        p, b, c, cfg_j, dtype=jnp.float32))(
            p, {"tokens": jnp.asarray(tokens)}, cache)
    decode = jax.jit(lambda p, t, c: jax_decode_step(p, t, c, cfg_j,
                                                     dtype=jnp.float32))
    logits, toks = [np.asarray(last)], []
    tok = jnp.argmax(last, -1).astype(jnp.int32)[:, None]
    for _ in range(steps):
        lg, cache = decode(p, tok, cache)
        tok = jnp.argmax(lg, -1).astype(jnp.int32)[:, None]
        logits.append(np.asarray(lg))
        toks.append(np.asarray(tok))
    return dict(logits=np.stack(logits), tokens=np.concatenate(toks, 1))


@lru_cache(maxsize=None)
def _case(kind: str, arch: str, changes: tuple = ()) -> tuple:
    """(the ranks' job, the reference's result) of a train or serve job of
    ``arch``'s smoke config with ``changes`` ((field, value) pairs)."""
    cfgs = _smoke(arch, **dict(changes))
    if kind == "train":
        params = _jax_params(cfgs["jax"])
        batch = _block_batch(cfgs["torch"])
        return dict(kind="train", cfg=cfgs["torch"], params=params,
                    batch=batch, mode="dp"), _jax_train_ref(cfgs["jax"],
                                                            params, batch)
    params, max_len, steps = _jax_params(cfgs["jax"], seed=1), 32, 4
    tokens = _block_batch(cfgs["torch"], seed=2, S=16)["tokens"]
    return dict(kind="serve", cfg=cfgs["torch"], params=params,
                batch={"tokens": tokens}, max_len=max_len, steps=steps), \
        _jax_serve_ref(cfgs["jax"], params, tokens, max_len, steps)


def _assert_train_close(got: dict, ref: dict, names: tuple = ()):
    """The loss 1e-4, the aux loss too, each gradient leaf 2e-4 relative
    L2 of ``jax.grad``'s (the leaves named in ``names`` first, by path)
    and the step's grad_norm 2e-4 of the norm of those gradients."""
    assert abs(got["total"] - ref["total"]) < 1e-4, (got["total"],
                                                      ref["total"])
    assert abs(got["step_total"] - ref["total"]) < 1e-4
    assert abs(got["aux"] - ref["aux"]) < 1e-4, (got["aux"], ref["aux"])
    pairs = jax.tree_util.tree_flatten_with_path(ref["grads"])[0]
    leaves = tree_leaves(got["grads"])
    assert len(leaves) == len(pairs)
    by_path = {jax.tree_util.keystr(path): (g, want)
               for (path, want), g in zip(pairs, leaves)}
    for name in names:
        hits = [k for k in by_path if name in k]
        assert hits, name
        for k in hits:
            g, want = by_path[k]
            assert _rel_l2(g, want) < GRAD_REL, (k, _rel_l2(g, want))
    for k, (g, want) in by_path.items():
        assert g.shape == want.shape, k
        assert _rel_l2(g, want) < GRAD_REL, (k, _rel_l2(g, want))
    norm = np.sqrt(sum(float(np.square(np.asarray(w, np.float64)).sum())
                       for _, w in by_path.values()))
    assert abs(got["grad_norm"] - norm) < GRAD_REL * norm, (got["grad_norm"],
                                                            norm)


def _assert_serve_close(got: dict, ref: dict):
    """Serving within 2e-4 of the largest logit, the same tokens: this
    rank's rows of the reference's (the batch split over data)."""
    i, n = got["rows"]
    b = len(ref["tokens"]) // n
    rows = slice(i * b, (i + 1) * b)
    want = ref["logits"][:, rows]
    scale = float(np.abs(want).max())
    assert np.abs(got["logits"] - want).max() / scale < 2e-4
    np.testing.assert_array_equal(got["tokens"], ref["tokens"][rows])


MOE_ARCHS = ("moonshot-v1-16b-a3b", "llama4-scout-17b-a16e")
MOE_GRADS = ("'router'", "'norm2'", "'shared'")


@pytest.mark.parametrize("mesh", [(2, 1), (1, 2), (2, 2)])
def test_moe_train_step_matches_jax(tmp_path, mesh):
    """The moonshot and llama4-scout smoke configs' loss-and-gradient and
    train step (fp32, ZeRO-1) over data ranks and with their experts split
    over ``model`` (8 / 4 experts, 4 / 2 a rank on model 2), against the
    reference on one device: the loss and the aux loss (global-batch
    means: the batch's rows split over data), every gradient leaf (the
    router's, norm2's and the shared expert's named: the aux loss's
    gradient counted once over data and model) and grad_norm.  On (2, 2)
    moonshot also under ``dp_sp``, and served (prefill and 4 greedy decode
    steps, the batch over data, the experts over model)."""
    jobs, refs = {}, {}
    for arch in MOE_ARCHS:
        jobs[arch], refs[arch] = _case("train", arch)
    if mesh == (2, 2):
        jobs["dp_sp"] = dict(jobs[MOE_ARCHS[0]], mode="dp_sp")
        refs["dp_sp"] = refs[MOE_ARCHS[0]]
        jobs["serve"], serve_ref = _case("serve", MOE_ARCHS[0])
    out = run_ranks(BLOCKS_BODY, int(np.prod(mesh)),
                    dict(mesh=mesh, jobs=jobs), tmp_path)
    for rank in out:
        for name, ref in refs.items():
            _assert_train_close(rank[name], ref, MOE_GRADS)
        if mesh == (2, 2):
            _assert_serve_close(rank["serve"], serve_ref)
    for arch in MOE_ARCHS:
        E = get_smoke_config(arch).num_experts
        assert out[0][arch]["local"]["w_gate"][1] == E // mesh[1]


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)])
def test_rglru_width_split_matches_jax(tmp_path, mesh):
    """recurrentgemma-9b's smoke config with its RG-LRU width (64, 4
    heads) split over ``model``: the train step's loss and gradients, and
    prefill + 4 greedy decode steps (the conv and h states written back
    whole on every rank), against the reference on one device."""
    train, train_ref = _case("train", "recurrentgemma-9b")
    serve, serve_ref = _case("serve", "recurrentgemma-9b")
    out = run_ranks(BLOCKS_BODY, int(np.prod(mesh)), dict(
        mesh=mesh, jobs={"train": train, "serve": serve}), tmp_path)
    for rank in out:
        _assert_train_close(rank["train"], train_ref, ("'in_x'", "'conv_w'",
                                                       "'a_param'"))
        _assert_serve_close(rank["serve"], serve_ref)
        assert rank["train"]["local"]["in_x"][-1] == 64 // mesh[1]
        # the state whole on every rank: ranks agree on it
        for a, b in zip(tree_leaves(rank["serve"]["cache"]),
                        tree_leaves(out[0]["serve"]["cache"])):
            np.testing.assert_array_equal(a, b)


def test_audio_frontend_split_encode_matches_jax(tmp_path):
    """hubert-xlarge's smoke config through ``make_encode_step`` on (1, 2):
    ``frontend_proj`` column-parallel and gathered, bidirectional
    attention tensor-parallel; the logits within 2e-4 of the largest of the
    reference's forward."""
    cfgs = _smoke("hubert-xlarge")
    params = _jax_params(cfgs["jax"])
    batch = _block_batch(cfgs["torch"])
    want, _ = jax_forward_train(jax.tree.map(jnp.asarray, params),
                                {"features": jnp.asarray(batch["features"])},
                                cfgs["jax"], dtype=jnp.float32)
    want = np.asarray(want)
    job = dict(kind="encode", cfg=cfgs["torch"], params=params, batch=batch)
    out = run_ranks(BLOCKS_BODY, 2, dict(mesh=(1, 2), jobs={"enc": job}),
                    tmp_path)
    for rank in out:
        assert rank["enc"]["local"] == (512, cfgs["torch"].d_model // 2)
        assert np.abs(rank["enc"]["logits"] - want).max() / \
            np.abs(want).max() < 2e-4


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)])
def test_vision_scatter_on_model_split_matches_jax(tmp_path, mesh):
    """qwen2-vl-2b's smoke config with patch embeddings and 3-D positions
    on (1, 2) and (2, 2) under ``dp`` and ``dp_sp``: every row's image
    positions span both sequence shards (row 1 has fewer Trues than
    patches), so under ``dp_sp`` each rank writes the patches whose
    whole-row targets fall in its half; on (2, 2) each data rank holds its
    rows of ``positions3`` (3, B, S) too.  The train step's loss and
    gradients (the embedding's named) against the reference on one
    device."""
    job, ref = _case("train", "qwen2-vl-2b")
    out = run_ranks(BLOCKS_BODY, int(np.prod(mesh)), dict(mesh=mesh, jobs={
        "dp": job, "dp_sp": dict(job, mode="dp_sp")}), tmp_path)
    for rank in out:
        for mode in ("dp", "dp_sp"):
            _assert_train_close(rank[mode], ref, ("'embed'",))


def test_replicated_widths_match_jax(tmp_path):
    """Widths that do not divide over ``model`` 2, which the rules
    replicate: moonshot's smoke config with 3 experts, a 63-wide shared
    expert and attention of H·dh = 45 (3 heads of 15, no rotary embedding
    at an odd head dim) runs them whole on every rank (the train step, and
    serving with every KV head in a cache split along the sequence);
    recurrentgemma-9b's with 3 RG-LRU heads of 16 splits its width of 48
    but not its gates, which it computes on the gathered width.  Against
    the reference on one device."""
    moe = (("num_experts", 3), ("shared_expert_dff", 63), ("num_heads", 3),
           ("num_kv_heads", 3), ("head_dim", 15), ("pos_type", "none"))
    lru = (("d_model", 48), ("num_heads", 3), ("lru_width", 48))
    jobs, refs = {}, {}
    jobs["moe"], refs["moe"] = _case("train", "moonshot-v1-16b-a3b", moe)
    jobs["moe_serve"], refs["moe_serve"] = _case(
        "serve", "moonshot-v1-16b-a3b", moe)
    jobs["lru"], refs["lru"] = _case("train", "recurrentgemma-9b", lru)
    out = run_ranks(BLOCKS_BODY, 2, dict(mesh=(1, 2), jobs=jobs), tmp_path)
    for rank in out:
        _assert_train_close(rank["moe"], refs["moe"], MOE_GRADS)
        _assert_serve_close(rank["moe_serve"], refs["moe_serve"])
        _assert_train_close(rank["lru"], refs["lru"], ("'a_gate_w'",))
        assert rank["moe"]["local"]["w_gate"][1] == 3
        assert rank["moe"]["local"]["wq"][-1] == 45
        assert rank["lru"]["local"]["in_x"][-1] == 24
        assert rank["lru"]["local"]["a_gate_w"][1] == 3


CKPT_BODY = '''
from repro_torch.checkpoint import TransactionalCheckpointManager
from repro_torch.core import CannyFS, LocalBackend
from repro_torch.models import param_specs
from repro_torch.models.bridge import params_from_numpy
from repro_torch.optim import init_opt_state
from repro_torch.parallel.sharding import shard_tree
from repro_torch.train.steps import train_shardings
from repro_torch.tree import tree_leaves


class Counting(LocalBackend):
    commits = 0

    def create(self, path):
        if path.endswith("/COMMIT"):
            Counting.commits += 1
        return super().create(path)


cfg = IN["cfg"]
mesh = mesh_of(IN["mesh"])
params = params_from_numpy(IN["params"], device="cpu")
state = {"params": params, "opt": init_opt_state(params),
         "step": torch.tensor(1, dtype=torch.int32)}
sh = train_shardings(cfg, mesh, param_specs(cfg), {}, zero1=True)
state_sh = {"params": sh["params"], "opt": sh["opt"], "step": None}
local = shard_tree(state, state_sh)
pspec = param_specs(cfg)
like = {"params": pspec, "opt": init_opt_state(pspec),
        "step": torch.empty((), dtype=torch.int32, device="meta")}
fs = CannyFS(Counting(IN["dir"]), max_inflight=64, workers=4)
mgr = TransactionalCheckpointManager(fs, "ckpt", mesh=mesh)


def same(a, b):
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))


# saved on one rank (the parent), restored on these
n1, got1 = mgr.restore(like, step=1, shardings=state_sh)
local["step"] = torch.tensor(2, dtype=torch.int32)
res = mgr.save(2, local, shardings=state_sh)
mgr.wait_for_save()
n2, got2 = mgr.restore(like, shardings=state_sh)
emit(dict(n1=n1, same1=same(got1["params"], local["params"])
          and same(got1["opt"], local["opt"]),
          n2=n2, same2=same(got2, local), ok=res.ok,
          commits=Counting.commits, writer=mgr.writer,
          experts_local=local["params"]["blocks"][0].get("moe", {}).get(
              "w_gate", torch.empty(0, 0)).shape[1],
          m_local=[tuple(t.shape) for t in tree_leaves(local["opt"]["m"])]))
fs.close()
'''


@pytest.mark.parametrize("mesh", [(1, 2), (2, 1), (2, 2)])
def test_checkpoint_reshards_across_meshes(tmp_path, mesh):
    """A checkpoint saved on one rank restores on the mesh's ranks; one
    saved on them (parameters split over ``model``, moments over ``data``
    by ZeRO-1; on (2, 2) moonshot's smoke config, its 8 experts 4 a
    ``model`` rank) restores on them and on one rank, the same tensors.
    Only rank 0 writes, and COMMIT is created once."""
    cfgs = _smoke("moonshot-v1-16b-a3b") if mesh == (2, 2) else \
        _narrow_qwen2()
    params = _jax_params(cfgs["jax"])
    cfg = cfgs["torch"]
    full = params_from_numpy(params, device="cpu")
    state = {"params": full, "opt": init_opt_state(full),
             "step": torch.tensor(1, dtype=torch.int32)}
    root = tmp_path / "fs"
    root.mkdir()
    fs = CannyFS(LocalBackend(str(root)), max_inflight=64, workers=4)
    mgr = TransactionalCheckpointManager(fs, "ckpt")
    assert mgr.save(1, state, block=True).ok
    fs.close()

    n = int(np.prod(mesh))
    out = run_ranks(CKPT_BODY, n, dict(cfg=cfg, mesh=mesh, params=params,
                                       dir=str(root)), tmp_path)
    assert [r["writer"] for r in out] == [True] + [False] * (n - 1)
    assert sum(r["commits"] for r in out) == 1
    for r in out:
        assert (r["n1"], r["n2"]) == (1, 2)
        assert r["same1"] and r["same2"] and r["ok"]
    if mesh[0] > 1:         # ZeRO-1 split the moments over data
        assert out[0]["m_local"] != [tuple(t.shape) for t in
                                     tree_leaves(state["opt"]["m"])]
    if mesh == (2, 2):      # the experts split over model
        assert out[0]["experts_local"] == cfg.num_experts // 2

    fs = CannyFS(LocalBackend(str(root)), max_inflight=64, workers=4)
    pspec = param_specs(cfg)
    like = {"params": pspec, "opt": init_opt_state(pspec),
            "step": torch.empty((), dtype=torch.int32, device="meta")}
    step, got = TransactionalCheckpointManager(fs, "ckpt").restore(like)
    fs.close()
    state["step"] = torch.tensor(2, dtype=torch.int32)
    assert step == 2
    for a, b in zip(tree_leaves(got), tree_leaves(state)):
        assert torch.equal(a, b)


TRAINER_BODY = '''
from repro_torch.core import CannyFS, LocalBackend
from repro_torch.data import SyntheticLM
from repro_torch.models import init_params, param_specs
from repro_torch.optim import init_opt_state
from repro_torch.parallel.sharding import shard_tree
from repro_torch.train.loop import LoopConfig, Trainer
from repro_torch.train.steps import TrainConfig
from repro_torch.tree import tree_leaves
cfg = IN["cfg"]
mesh = mesh_of((2, 2))
sent = []
real_send = dist.send
def send(t, dst, *a, **kw):
    sent.append(t.numel())
    return real_send(t, dst, *a, **kw)
dist.send = send
fs = CannyFS(LocalBackend(IN["dir"]), max_inflight=64, workers=4)
tc = TrainConfig(dtype=torch.float32, remat_policy="none")
lc = LoopConfig(total_steps=2, ckpt_every=2, log_every=1, seed=3)


def trainer():
    return Trainer(cfg, fs, iter(SyntheticLM(cfg, batch=4, seq_len=16,
                                             seed=0)),
                   tc=tc, lc=lc, device="cpu", mesh=mesh)


def same(a, b):
    a, b = tree_leaves(a), tree_leaves(b)
    return len(a) == len(b) and all(x.shape == y.shape and torch.equal(x, y)
                                    for x, y in zip(a, b))


t = trainer()
t.init_state(next(t.data))
full = init_params(cfg, device="cpu", dtype=torch.float32,
                   generator=torch.Generator().manual_seed(3))
want_p = shard_tree(full, t.shardings["params"])
want_o = shard_tree(init_opt_state(param_specs(cfg)), t.shardings["opt"])
init = dict(params=same(t.state["params"], want_p),
            opt_shapes=[tuple(x.shape) for x in tree_leaves(t.state["opt"])]
            == [tuple(x.shape) for x in tree_leaves(want_o)],
            opt_zero=all(not x.any() for x in tree_leaves(t.state["opt"])))
t.run()
after = t.state
local = sum(x.numel() for x in tree_leaves(after))
t2 = trainer()
t2.init_state(next(t2.data))
emit(dict(init=init, local=local, sent=sum(sent), step=t2.step,
          restored=same(t2.state, after)))
fs.close()
'''


def test_trainer_on_mesh_holds_only_its_shards(tmp_path):
    """``Trainer(..., mesh=)`` on (data 2, model 2): the state it starts
    from is each rank's shards of the seed's weights (drawn on the host)
    and zero moments at their ZeRO-1 shapes; its checkpoint reaches the
    origin rank leaf by leaf with each distinct shard sent once (the
    origin's own not at all), and a new Trainer restores every rank's
    shards of it."""
    cfg = _narrow_qwen2()["torch"]
    root = tmp_path / "fs"
    root.mkdir()
    out = run_ranks(TRAINER_BODY, 4, dict(cfg=cfg, dir=str(root)), tmp_path)
    pspec = param_specs(cfg)
    whole = 3 * sum(x.numel() for x in tree_leaves(pspec)) + 2  # + counts
    for r in out:
        assert r["init"] == dict(params=True, opt_shapes=True,
                                 opt_zero=True), r["init"]
        assert r["local"] < whole
        assert r["step"] == 2 and r["restored"]
    assert out[0]["sent"] == 0
    assert sum(r["sent"] for r in out[1:]) == whole - out[0]["local"]


def test_launcher_two_ranks_loss_falls(tmp_path):
    """``torchrun --nproc_per_node=2 -m repro_torch.launch.train --mesh
    debug --device cpu``: a (data 2, model 1) mesh whose loss falls, rank
    0 alone writing the metrics and the checkpoints."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    work = tmp_path / "work"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node=2", "-m", "repro_torch.launch.train",
           "--arch", "qwen2-7b", "--smoke", "--mesh", "debug",
           "--device", "cpu", "--steps", "40", "--batch", "4", "--seq", "32",
           "--ckpt-every", "20", "--workdir", str(work)]
    try:
        done = subprocess.run(cmd, env=env, capture_output=True, text=True,
                              timeout=RANK_TIMEOUT_S, cwd=tmp_path)
    except subprocess.TimeoutExpired as e:
        pytest.fail(f"launcher passed {RANK_TIMEOUT_S} s: {e.stderr}")
    assert done.returncode == 0, done.stdout[-3000:] + done.stderr[-3000:]
    assert "mesh={'data': 2, 'model': 1}" in done.stdout
    records = [json.loads(line) for line in
               (work / "logs" / "metrics.jsonl").read_text().splitlines()]
    losses = [r["loss"] for r in records if "loss" in r]
    assert len(losses) == 4 and losses[-1] < losses[0], losses
    assert sorted(os.listdir(work / "ckpt")) == ["step_0000000020",
                                                 "step_0000000040"]
