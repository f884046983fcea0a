"""The port's checkpoint manager and engine copy: twins of the JAX suite's
checkpoint tests (``tests/test_checkpoint.py``) and crash-restart chaos
(``tests/test_checkpoint_chaos.py``), run on ``repro_torch``'s own copies,
and checkpoints read across the two packages bit for bit.

The chaos twins are the JAX suite's, word for word, on the port's manager
and engine: a process killed between the first shard write and the COMMIT
marker, at every injection point, leaves only committed checkpoints after
a restart; SIGKILL-equivalent aborts at every mutating call of a spilled
transaction (and of its resume) converge to the uninterrupted run's state.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis",
                    reason="hypothesis not installed (see requirements-dev.txt)")
import hypothesis.strategies as stx
from hypothesis import HealthCheck, given, settings

from repro.checkpoint import \
    TransactionalCheckpointManager as JaxCheckpointManager
from repro.core import CannyFS as JaxCannyFS
from repro.core import LocalBackend as JaxLocalBackend
from repro_torch.checkpoint import COMMIT_FILE, TransactionalCheckpointManager
from repro_torch.core import (CannyFS, EagerFlags, InMemoryBackend,
                              LatencyBackend, LatencyModel, LocalBackend)
from repro_torch.core.errors import ProcessKilled
from repro_torch.core.transaction import run_transaction
from repro_torch.tree import tree_leaves

ROOT = Path(__file__).resolve().parents[1]


def make_fs(backend=None):
    return CannyFS(backend or InMemoryBackend(), max_inflight=1000,
                   workers=8)


# ---------------------------------------------------------------------------
# twins of tests/test_checkpoint.py
# ---------------------------------------------------------------------------

def test_roundtrip_dtypes_and_structure():
    fs = make_fs()
    mgr = TransactionalCheckpointManager(fs, "ck")
    state = {
        "params": {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
                   "layers": [{"a": torch.ones(2, 2)},
                              {"a": torch.zeros(2, 2)}]},
        "bf16": torch.ones(5, dtype=torch.bfloat16) * 1.5,
        "step": torch.tensor(3, dtype=torch.int32),
        "np": np.arange(4, dtype=np.int64),
    }
    mgr.save(3, state, block=True)
    step, out = mgr.restore(state)
    assert step == 3
    for a, b in zip(tree_leaves(out), tree_leaves(state)):
        b = torch.as_tensor(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)
    fs.close()


def test_commit_marker_written_last():
    """COMMIT must not exist until every shard is durable: inject latency
    and poll the backing store while the save drains."""
    inner = InMemoryBackend()
    lat = LatencyBackend(inner, LatencyModel(meta_ms=2.0, data_ms=2.0,
                                             jitter_sigma=0.0))
    fs = CannyFS(lat, max_inflight=1000, workers=8)
    mgr = TransactionalCheckpointManager(fs, "ck")
    state = {"w": torch.ones(512)}
    mgr.save(1, state)
    seen_commit_early = False
    while mgr._finalizer is not None and mgr._finalizer.is_alive():
        snap = inner.snapshot()
        if any(COMMIT_FILE in p for p in snap["files"]):
            shard = [p for p in snap["files"] if p.endswith("w.bin")]
            if not shard:
                seen_commit_early = True
    mgr.wait_for_save()
    assert not seen_commit_early
    assert mgr.results[-1].ok
    fs.close()


def test_failed_save_rolls_back_and_next_succeeds():
    class Flaky(InMemoryBackend):
        fail = True

        def write_at(self, p, o, d):
            if self.fail and p.endswith("w.bin"):
                raise OSError(5, "io")
            return super().write_at(p, o, d)

    be = Flaky()
    fs = CannyFS(be)
    mgr = TransactionalCheckpointManager(fs, "ck")
    state = {"w": torch.ones(16)}
    mgr.save(1, state, block=True)
    assert not mgr.results[-1].ok
    assert mgr.list_steps() == []
    assert all("step_" not in p for p in be.snapshot()["files"])
    be.fail = False
    fs.ledger.clear()
    mgr.save(2, state, block=True)
    assert mgr.results[-1].ok and mgr.list_steps() == [2]
    step, out = mgr.restore(state)
    assert step == 2
    fs.close()


def test_gc_keeps_latest():
    fs = make_fs()
    mgr = TransactionalCheckpointManager(fs, "ck", keep=2)
    state = {"w": torch.ones(4)}
    for s in (1, 2, 3, 4):
        mgr.save(s, state, block=True)
    assert mgr.list_steps() == [3, 4]
    fs.close()


def test_restore_onto_a_device_from_meta_structure():
    """The saved artifact is device-agnostic: restore reads only the
    structure of ``like`` (meta tensors will do) and puts the tensors on
    the device asked for (the reference reshards onto a mesh instead)."""
    fs = make_fs()
    mgr = TransactionalCheckpointManager(fs, "ck")
    state = {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8)}
    mgr.save(1, state, block=True)
    like = {"w": torch.empty(8, 8, device="meta")}
    step, out = mgr.restore(like, device="cpu")
    assert out["w"].device.type == "cpu"
    assert torch.equal(out["w"], state["w"])
    fs.close()


@settings(max_examples=25, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(data=stx.dictionaries(
    keys=stx.text(alphabet="abcdef", min_size=1, max_size=6),
    values=stx.one_of(
        stx.integers(0, 255).map(
            lambda n: torch.arange(n, dtype=torch.float32)),
        stx.integers(1, 16).map(
            lambda n: torch.ones((n, 3), dtype=torch.int32)),
        stx.integers(0, 40).map(
            lambda n: torch.linspace(-3, 3, n).to(torch.bfloat16)),
    ),
    min_size=1, max_size=6))
def test_checkpoint_roundtrip_property(data):
    fs = make_fs()
    mgr = TransactionalCheckpointManager(fs, "ck")
    mgr.save(1, data, block=True)
    assert mgr.results[-1].ok
    _, out = mgr.restore(data)
    for k in data:
        assert out[k].dtype == data[k].dtype
        assert torch.equal(out[k], data[k])
    fs.close()


# ---------------------------------------------------------------------------
# across the two packages
# ---------------------------------------------------------------------------

def _state_np():
    rng = np.random.default_rng(7)
    return {"params": {"w": rng.standard_normal((3, 5)).astype(np.float32),
                       "blocks": [{"b": rng.standard_normal(4).astype(
                           np.float32)}]},
            "opt": {"count": np.asarray(4, np.int32)},
            "h": rng.standard_normal(6).astype(np.float32),
            "step": np.asarray(11, np.int32)}


def _files(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_jax_checkpoint_restores_bit_identically_in_the_port(tmp_path):
    """A bf16 leaf, an int32 scalar, nested lists: saved by the JAX
    package's manager, restored by the port's with the same bits; and the
    port writes the very same files for the same state."""
    state = _state_np()
    jstate = dict(state, h=jnp.asarray(state["h"], jnp.bfloat16))
    fs_j = JaxCannyFS(JaxLocalBackend(str(tmp_path / "a")), workers=4)
    assert JaxCheckpointManager(fs_j, "ck").save(11, jstate, block=True).ok
    fs_j.close()
    tstate = {"params": {"w": torch.from_numpy(state["params"]["w"]),
                         "blocks": [{"b": torch.from_numpy(
                             state["params"]["blocks"][0]["b"])}]},
              "opt": {"count": torch.tensor(4, dtype=torch.int32)},
              "h": torch.from_numpy(state["h"]).to(torch.bfloat16),
              "step": torch.tensor(11, dtype=torch.int32)}
    fs = CannyFS(LocalBackend(str(tmp_path / "a")), workers=4)
    step, out = TransactionalCheckpointManager(fs, "ck").restore(tstate)
    assert step == 11
    for a, b in zip(tree_leaves(out), tree_leaves(tstate)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert out["h"].view(torch.int16).numpy().tobytes() == np.asarray(
        jstate["h"]).tobytes()
    fs.close()
    fs_t = CannyFS(LocalBackend(str(tmp_path / "b")), workers=4)
    assert TransactionalCheckpointManager(fs_t, "ck").save(
        11, tstate, block=True).ok
    fs_t.close()
    assert _files(tmp_path / "a" / "ck") == _files(tmp_path / "b" / "ck")


def test_port_checkpoint_restores_bit_identically_in_jax(tmp_path):
    state = _state_np()
    tstate = {"params": {"w": torch.from_numpy(state["params"]["w"]),
                         "blocks": [{"b": torch.from_numpy(
                             state["params"]["blocks"][0]["b"])}]},
              "opt": {"count": torch.tensor(4, dtype=torch.int32)},
              "h": torch.from_numpy(state["h"]).to(torch.bfloat16),
              "step": torch.tensor(11, dtype=torch.int32)}
    fs_t = CannyFS(LocalBackend(str(tmp_path)), workers=4)
    assert TransactionalCheckpointManager(fs_t, "ck").save(
        11, tstate, block=True).ok
    fs_t.close()
    like = dict(state, h=jnp.zeros(6, jnp.bfloat16))
    fs_j = JaxCannyFS(JaxLocalBackend(str(tmp_path)), workers=4)
    step, out = JaxCheckpointManager(fs_j, "ck").restore(like)
    fs_j.close()
    assert step == 11
    assert np.asarray(out["h"]).dtype.name == "bfloat16"
    assert np.asarray(out["h"]).tobytes() == tstate["h"].view(
        torch.int16).numpy().tobytes()
    np.testing.assert_array_equal(out["params"]["w"], state["params"]["w"])
    np.testing.assert_array_equal(out["params"]["blocks"][0]["b"],
                                  state["params"]["blocks"][0]["b"])
    assert int(out["step"]) == 11 and out["step"].dtype == np.int32
    assert int(out["opt"]["count"]) == 4


def test_port_serialization_needs_no_ml_dtypes():
    """The chip machine has no ml_dtypes: with it blocked, a bf16 state
    still saves and restores, and no source of the package imports it."""
    code = (
        "import sys; sys.modules['ml_dtypes'] = None\n"
        "import torch\n"
        "from repro_torch.checkpoint import TransactionalCheckpointManager\n"
        "from repro_torch.core import CannyFS, InMemoryBackend\n"
        "fs = CannyFS(InMemoryBackend())\n"
        "m = TransactionalCheckpointManager(fs, 'ck')\n"
        "s = {'h': torch.linspace(-2, 2, 9).to(torch.bfloat16)}\n"
        "assert m.save(1, s, block=True).ok\n"
        "assert torch.equal(m.restore(s)[1]['h'], s['h'])\n"
        "fs.close()\n")
    subprocess.run([sys.executable, "-c", code], check=True,
                   env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    imports = re.compile(r"^\s*(import|from)\s+ml_dtypes\b", re.M)
    for f in (ROOT / "src" / "repro_torch").rglob("*.py"):
        assert not imports.search(f.read_text()), f


# ---------------------------------------------------------------------------
# twins of tests/test_checkpoint_chaos.py
# ---------------------------------------------------------------------------

class _Crash(BaseException):
    """Simulated process death.  Deliberately NOT an OSError/CannyError:
    the manager's own error handling must not see it — the partial step
    dir is left exactly as the dying process would leave it."""


class CrashingBackend(InMemoryBackend):
    """Raises _Crash on the k-th mutating call under the checkpoint root
    once armed.  Counting only ckpt-dir mutations makes injection point k
    deterministic and independent of unrelated traffic."""

    def __init__(self, root="ck"):
        super().__init__()
        self._root = root
        self.countdown = None     # None = disarmed

    def _tick(self, path):
        if self.countdown is None or not str(path).startswith(self._root):
            return
        if self.countdown == 0:
            self.countdown = None
            raise _Crash(path)
        self.countdown -= 1

    def mkdir(self, path):
        self._tick(path)
        super().mkdir(path)

    def create(self, path):
        self._tick(path)
        super().create(path)

    def write_at(self, path, offset, data):
        self._tick(path)
        return super().write_at(path, offset, data)

    def write_vec(self, path, segments):
        self._tick(path)
        return super().write_vec(path, segments)


def _sync_fs(be):
    # fully synchronous mount: every op runs in the caller's thread, so
    # _Crash propagates out of save() like a process dying mid-syscall
    # (nothing self-cleans; the partial dir survives on the backend)
    return CannyFS(be, flags=EagerFlags.all_off(), workers=2,
                   echo_errors=False)


def _ckpt_files(be, step):
    prefix = f"ck/step_{step:010d}/"
    return {p: bytes(d) for p, d in be.snapshot()["files"].items()
            if p.startswith(prefix)}


def test_crash_restart_at_every_injection_point():
    be = CrashingBackend("ck")
    state1 = {"w": np.arange(8, dtype=np.float32),
              "b": np.ones(3, np.float32)}
    state2 = {"w": np.arange(8, dtype=np.float32) * 2.0,
              "b": np.zeros(3, np.float32)}

    # seed one committed checkpoint (no chaos armed)
    fs0 = _sync_fs(be)
    mgr0 = TransactionalCheckpointManager(fs0, "ck")
    assert mgr0.save(1, state1, block=True).ok
    fs0.close()
    committed = _ckpt_files(be, 1)
    assert any(p.endswith(COMMIT_FILE) for p in committed)

    crash_points = 0
    k = 0
    while True:
        be.countdown = k
        fs = _sync_fs(be)
        crashed = False
        try:
            mgr = TransactionalCheckpointManager(fs, "ck")
            res = mgr.save(2, state2, block=True)
        except _Crash:
            crashed = True
        be.countdown = None
        fs.close()

        # restart: a fresh manager on the same backend runs recovery
        fs2 = _sync_fs(be)
        mgr2 = TransactionalCheckpointManager(fs2, "ck")
        if crashed:
            crash_points += 1
            # recovery discarded exactly the uncommitted step dir...
            assert mgr2.list_steps() == [1]
            assert _ckpt_files(be, 2) == {}
            assert all(not p.startswith("ck/step_0000000002")
                       for p in be.snapshot()["files"])
            # ...and the committed checkpoint is untouched and restorable
            assert _ckpt_files(be, 1) == committed
            step, out = mgr2.restore(state1)
            assert step == 1
            np.testing.assert_array_equal(out["w"], state1["w"])
            fs2.close()
            k += 1
            continue
        # chaos exhausted: the uninjected save must have committed
        assert res.ok, res.error
        assert mgr2.list_steps() == [1, 2]
        step, out = mgr2.restore(state2)
        assert step == 2
        np.testing.assert_array_equal(out["w"], state2["w"])
        fs2.close()
        break

    # the sweep covered the full window: root mkdir, manifest, both shard
    # streams and the COMMIT marker itself are all >1 mutating calls
    assert crash_points >= 5


def test_crash_after_commit_marker_is_durable():
    """A crash strictly *after* the COMMIT content landed loses nothing:
    restart sees a committed step (the marker names the step) and
    recovery discards nothing."""
    be = CrashingBackend("ck")
    state = {"w": np.ones(4, np.float32)}
    fs = _sync_fs(be)
    mgr = TransactionalCheckpointManager(fs, "ck")
    assert mgr.save(7, state, block=True).ok
    fs.close()
    before = be.snapshot()["files"]

    fs2 = _sync_fs(be)
    mgr2 = TransactionalCheckpointManager(fs2, "ck")
    assert mgr2.rollback_uncommitted() == []
    assert mgr2.list_steps() == [7]
    assert be.snapshot()["files"] == before
    fs2.close()


def test_partial_commit_marker_is_not_a_commit():
    """Crash between the COMMIT file's create and its content write: the
    empty marker must read as *uncommitted* and recovery must discard the
    step (an empty/garbage marker naming no step is not durable)."""
    be = CrashingBackend("ck")
    state = {"w": np.ones(4, np.float32)}
    fs = _sync_fs(be)
    mgr = TransactionalCheckpointManager(fs, "ck")
    assert mgr.save(1, state, block=True).ok
    fs.close()

    # forge the failure mode directly: step 2 fully written, marker empty
    d = "ck/step_0000000002"
    be.mkdir(d)
    be.create(f"{d}/manifest.json")
    be.write_at(f"{d}/manifest.json", 0, b"{}")
    be.create(f"{d}/{COMMIT_FILE}")          # created, never written

    fs2 = _sync_fs(be)
    mgr2 = TransactionalCheckpointManager(fs2, "ck")
    assert mgr2.list_steps() == [1]
    assert all(not p.startswith(d) for p in be.snapshot()["files"])
    fs2.close()


# ---------------------------------------------------------------------------
# kill-point sweep over the durability spill (transaction resume)
# ---------------------------------------------------------------------------

_MUTATING = ("mkdir", "create", "write_at", "write_vec", "unlink", "rmdir",
             "rename", "remove_tree", "chmod", "truncate")
_READS = ("stat", "stat_vec", "readdir", "readdir_plus", "readdir_plus_vec",
          "read_at", "read_vec", "readlink")


class KillingBackend(InMemoryBackend):
    """SIGKILL-equivalent chaos: the k-th mutating call (spill-journal
    writes included) raises ``ProcessKilled`` — before applying (``post=
    False``, the op never lands) or after (``post=True``, the op lands
    but nothing downstream of it runs) — and the backend stays dead
    (every later call, reads included, raises) until ``revive``."""

    def __init__(self, post=False):
        super().__init__()
        self.countdown = None      # None = disarmed
        self.post = post
        self.dead = False

    def revive(self):
        self.dead = False
        self.countdown = None

    def _strike(self, name):
        self.countdown = None
        self.dead = True
        raise ProcessKilled(f"kill point at {name}")

    def _gate(self, name):
        if self.dead:
            raise ProcessKilled(f"backend dead at {name}")
        if self.countdown is None:
            return False
        if self.countdown == 0:
            if not self.post:
                self._strike(name)
            return True            # apply the op, then strike
        self.countdown -= 1
        return False


def _wrap_mutating(name):
    base = getattr(InMemoryBackend, name)

    def op(self, *a, **kw):
        post = self._gate(name)
        out = base(self, *a, **kw)
        if post:
            self._strike(name)
        return out
    op.__name__ = name
    return op


def _wrap_read(name):
    base = getattr(InMemoryBackend, name)

    def op(self, *a, **kw):
        if self.dead:
            raise ProcessKilled(f"backend dead at {name}")
        return base(self, *a, **kw)
    op.__name__ = name
    return op


for _name in _MUTATING:
    setattr(KillingBackend, _name, _wrap_mutating(_name))
for _name in _READS:
    setattr(KillingBackend, _name, _wrap_read(_name))


def _spill_job(fs):
    """A small extract-transform-clean job touching every structural op
    class the spill records: mkdir chains, create+write streams,
    metadata, rename, a subtree removal and a file removal."""
    fs.makedirs("data/keep/deep")
    fs.makedirs("data/tmp")
    for i in range(3):
        fs.write_file(f"data/keep/f{i}.bin", bytes([65 + i]) * 64)
        fs.write_file(f"data/tmp/t{i}.bin", bytes([97 + i]) * 32)
    fs.write_file("data/keep/deep/d.bin", b"deep" * 8)
    fs.chmod("data/keep/f0.bin", 0o600)
    fs.rename("data/keep/f2.bin", "data/keep/g2.bin")
    fs.rmtree("data/tmp")
    fs.unlink("data/keep/f1.bin")


def _spill_fs(be):
    fs = CannyFS(be, flags=EagerFlags(flush=False), workers=2,
                 echo_errors=False)
    fs.enable_spill(".spill", flush_records=4)
    return fs


def _state(be):
    """Data-plane state (spill dir excluded): file bytes, dirs, modes."""
    snap = be.snapshot()
    files = {p: bytes(d) for p, d in snap["files"].items()
             if not p.startswith(".spill")}
    dirs = {d for d in snap["dirs"]
            if d and d != ".spill" and not d.startswith(".spill/")}
    modes = {p: be.stat(p).mode for p in files}
    return files, dirs, modes


def _run_to_completion(be, *, max_resumes=8):
    """Restart loop: resume + re-run until the job commits.  Returns the
    number of restarts it took."""
    restarts = 0
    while True:
        be.revive()
        fs = CannyFS(be, flags=EagerFlags(flush=False), workers=2,
                     echo_errors=False)
        try:
            report = fs.resume(".spill", flush_records=4)
            if report.get("committed"):
                fs.close()
                return restarts
            run_transaction(fs, _spill_job, retries=0)
            fs.close()
            return restarts
        except ProcessKilled:
            restarts += 1
            assert restarts <= max_resumes, "resume never converged"
            try:
                fs.close()
            except BaseException:
                pass


def _baseline_state():
    be = KillingBackend()
    fs = _spill_fs(be)
    run_transaction(fs, _spill_job, retries=0)
    fs.close()
    return _state(be)


@pytest.mark.parametrize("post", [False, True],
                         ids=["kill-before-apply", "kill-after-apply"])
def test_spill_kill_point_sweep_converges(post):
    """Kill at EVERY mutating backend call of the transaction (spill
    writes included), resume on a fresh mount, and require byte-identical
    convergence with the uninterrupted run — no leaked journal entries,
    no resurrected removed files, no lost writes."""
    baseline = _baseline_state()
    kill_points = 0
    k = 0
    while True:
        be = KillingBackend(post=post)
        be.countdown = k
        killed = False
        fs = None
        try:
            # the mount's own spill-dir setup is inside the kill window
            fs = _spill_fs(be)
            run_transaction(fs, _spill_job, retries=0)
        except ProcessKilled:
            killed = True
        if fs is not None:
            try:
                fs.close()
            except BaseException:
                pass
        if not killed and not be.dead:
            # chaos exhausted: the armed run outran the countdown
            assert _state(be) == baseline
            break
        kill_points += 1
        _run_to_completion(be)
        assert _state(be) == baseline, f"diverged at kill point {k}"
        k += 1
        assert k < 400, "sweep failed to terminate"
    # the sweep actually covered the window (dirs, writes, renames,
    # removals and the spill's own journal writes are all >10 calls)
    assert kill_points >= 10


def test_spill_kill_mid_resume_sweep_converges():
    """Preempt the job once, then kill at every mutating call of the
    RESUME pass itself (journal truncate, repair ops, re-executed
    suffix, recommit).  A second resume must still converge."""
    baseline = _baseline_state()
    k2 = 0
    covered = 0
    while True:
        be = KillingBackend()
        # first preemption at a fixed point deep in the job
        be.countdown = 12
        fs = _spill_fs(be)
        try:
            run_transaction(fs, _spill_job, retries=0)
            raise AssertionError("first run should have been killed")
        except ProcessKilled:
            pass
        try:
            fs.close()
        except BaseException:
            pass

        # resume pass, chaos re-armed
        be.revive()
        be.countdown = k2
        killed = False
        fs2 = CannyFS(be, flags=EagerFlags(flush=False), workers=2,
                      echo_errors=False)
        try:
            report = fs2.resume(".spill", flush_records=4)
            if not report.get("committed"):
                run_transaction(fs2, _spill_job, retries=0)
            fs2.close()
        except ProcessKilled:
            killed = True
            try:
                fs2.close()
            except BaseException:
                pass
        if not killed and not be.dead:
            assert _state(be) == baseline
            break
        covered += 1
        _run_to_completion(be)
        assert _state(be) == baseline, f"diverged at resume kill point {k2}"
        k2 += 1
        assert k2 < 400, "mid-resume sweep failed to terminate"
    assert covered >= 5


def test_spill_retired_after_converged_resume():
    """After convergence the spill journal is gone and the marker proves
    the committed window — a later mount must see nothing to resume."""
    be = KillingBackend()
    be.countdown = 10
    fs = _spill_fs(be)
    with pytest.raises(ProcessKilled):
        run_transaction(fs, _spill_job, retries=0)
    try:
        fs.close()
    except BaseException:
        pass
    _run_to_completion(be)
    assert not be.stat(".spill/journal.log").exists
    fs3 = CannyFS(be, flags=EagerFlags(flush=False), echo_errors=False)
    report = fs3.resume(".spill")
    assert report["committed"] and not report["resumable"]
    fs3.close()
