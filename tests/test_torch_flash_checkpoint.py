"""The port's flash checkpoint (dlrover_tpu_torch/agent/ckpt_saver.py,
common/multi_process.py, common/storage.py, trainer/flash_checkpoint/)
on the CPU: the JAX package's test classes (tests/test_flash_checkpoint.py:
IPC primitives, shm handler, engine end to end, crash survival,
retention) on the port, and the layout across packages both ways:
a checkpoint the port saves holds the keys and the bit-equal arrays of
JAX `flatten_state` of the same train state, and a checkpoint the JAX
package saves restores into the port bit-equal (AdamW and int8_adam).

Every test uses its own job name (the IPC socket) and a `tmp_path` shm
directory, and closes what it starts: the test files may run in
parallel (pytest-xdist), beside the JAX package's checkpoint tests.
"""

import itertools
import os
import pickle
import subprocess
import sys
import textwrap
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dlrover_tpu.models import llama as jllama
from dlrover_tpu.optim.low_precision import int8_adam as j_int8_adam
from dlrover_tpu.parallel.accelerate import Strategy as JStrategy
from dlrover_tpu.parallel.accelerate import accelerate as jaccelerate
from dlrover_tpu.parallel.mesh import MeshSpec
from dlrover_tpu.trainer.flash_checkpoint import engine as jengine
from dlrover_tpu_torch.agent.ckpt_saver import (
    AsyncCheckpointSaver,
    SharedMemoryHandler,
    ShmIntegrityError,
    read_tracker_step,
)
from dlrover_tpu_torch.common.multi_process import (
    LocalSocketServer,
    SharedDict,
    SharedLock,
    SharedMemorySegment,
    SharedQueue,
)
from dlrover_tpu_torch.common.storage import (
    KeepLatestStepStrategy,
    PosixDiskStorage,
)
from dlrover_tpu_torch.models import llama as tllama
from dlrover_tpu_torch.optim import bf16_adam, int8_adam
from dlrover_tpu_torch.parallel import amp
from dlrover_tpu_torch.parallel.accelerate import Strategy, accelerate
from dlrover_tpu_torch.trainer.flash_checkpoint import (
    CheckpointEngine,
    Checkpointer,
    FullCheckpointer,
    OrbaxCheckpointer,
    StorageType,
)
from dlrover_tpu_torch.trainer.flash_checkpoint.engine import (
    _extract_npz,
    flatten_state,
    state_leaves,
    train_state_from_numpy,
    unflatten_state,
)

_SEQ = itertools.count()


def _cpu_env():
    """A child Python's environment: this test's (its shm directory),
    on the CPU (site customization would otherwise reach for an
    accelerator)."""
    return {**os.environ, "DLROVER_TPU_FORCE_CPU": "1"}


def _job(tag: str) -> str:
    return f"torch_ckpt_{os.getpid()}_{tag}_{next(_SEQ)}"


@pytest.fixture(autouse=True)
def shm_dir(tmp_path, monkeypatch):
    d = tmp_path / "shm"
    d.mkdir()
    monkeypatch.setenv("DLROVER_TPU_SHM_DIR", str(d))
    return d


@pytest.fixture()
def job():
    return _job("ipc")


@pytest.fixture()
def ipc(job):
    server = LocalSocketServer(job)
    server.start()
    yield server
    server.stop()


# ---------------------------------------------------------------------------
# train states of both packages
# ---------------------------------------------------------------------------

JCFG = jllama.LlamaConfig.tiny(dtype=jnp.float32)
TCFG = tllama.LlamaConfig.tiny(dtype=torch.float32)


def _tree(seed=0):
    return jax.tree_util.tree_map(
        np.asarray, jllama.init_params(JCFG, jax.random.PRNGKey(seed)))


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, 256, size=(2, 17)).astype(np.int32)}


def _t_batch(batch):
    return {"tokens": torch.from_numpy(batch["tokens"]).long()}


def _adamw(params):
    return torch.optim.AdamW(params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)


OPTS = {
    "adamw": (lambda: optax.adamw(1e-3), lambda: _adamw),
    "int8_adam": (lambda: j_int8_adam(1e-3, weight_decay=1e-4),
                  lambda: int8_adam(1e-3, weight_decay=1e-4)),
}


def _port_acc(opt="adamw", seed=0, loss_scale=False):
    tree = _tree(seed)
    return accelerate(
        init_params=lambda g: tllama.params_from_numpy(
            TCFG, tree, device="cpu", dtype=torch.float32),
        loss_fn=lambda p, b: tllama.loss_fn(TCFG, p, b),
        optimizer=OPTS[opt][1]() if opt in OPTS else opt,
        strategy=Strategy(device="cpu", loss_scale=loss_scale),
    )


def _port_state(opt="adamw", steps=0, seed=0, loss_scale=False):
    acc = _port_acc(opt, seed, loss_scale)
    state = acc.init(torch.Generator().manual_seed(0))
    for i in range(steps):
        state, _ = acc.train_step(state, _t_batch(_batch(100 + i)))
    return state


def _jax_state(opt, steps):
    acc = jaccelerate(
        init_params=lambda k: jllama.init_params(JCFG, k),
        loss_fn=lambda p, b, m: jllama.loss_fn(JCFG, p, b, mesh=m),
        rules=jllama.partition_rules(JCFG),
        optimizer=OPTS[opt][0](),
        strategy=JStrategy(mesh=MeshSpec.fit(1)),
        devices=jax.devices()[:1],
    )
    state = acc.init(jax.random.PRNGKey(0))
    for i in range(steps):
        state, _ = acc.train_step(state, acc.shard_batch(_batch(100 + i)))
    return state


def _bits(a) -> np.ndarray:
    """An array's bytes, for bit-equality (NaN == NaN, -0 != +0)."""
    a = np.ascontiguousarray(np.asarray(a))
    return a.reshape(-1).view(np.uint8)


def _assert_bit_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.shape == w.shape and g.dtype == w.dtype, (k, g.shape,
                                                           g.dtype, w.dtype)
        assert np.array_equal(_bits(g), _bits(w)), k


def _leaf_bits(state) -> dict:
    return {k: _bits(v) for k, v in flatten_state(state)[0].items()}


# ---------------------------------------------------------------------------
# IPC primitives
# ---------------------------------------------------------------------------


class TestIPCPrimitives:
    def test_shared_dict_and_queue(self, ipc, job):
        d = SharedDict("d1", job)
        d.set("k", {"nested": 1})
        assert d.get("k") == {"nested": 1}
        q = SharedQueue("q1", job)
        q.put("event")
        assert q.get(timeout=1) == "event"
        assert q.empty()

    def test_shared_lock_across_clients(self, ipc, job):
        l1 = SharedLock("lk", job)
        l2 = SharedLock("lk", job)
        assert l1.acquire()
        assert not l2.acquire(blocking=False)
        l1.release()
        assert l2.acquire(blocking=False)
        l2.release()

    def test_lock_released_when_holder_dies(self, ipc, job):
        code = (
            "from dlrover_tpu_torch.common.multi_process import SharedLock\n"
            f"l = SharedLock('lk_dead', {job!r})\n"
            "assert l.acquire()\n"
            "import time\n"
            "print('held', flush=True)\n"
            "time.sleep(30)\n"
        )
        proc = subprocess.Popen([sys.executable, "-c", code],
                                stdout=subprocess.PIPE, env=_cpu_env())
        try:
            assert proc.stdout.readline().strip() == b"held"
            other = SharedLock("lk_dead", job)
            assert not other.acquire(blocking=False)
        finally:
            proc.kill()
            proc.wait()
        deadline = time.monotonic() + 10
        got = False
        while time.monotonic() < deadline:
            if other.acquire(blocking=False):
                got = True
                break
            time.sleep(0.1)
        assert got, "lock never reaped after holder death"
        other.release()

    def test_same_proxy_cross_thread_contention(self, ipc, job):
        lock = SharedLock("xthread", job)
        held = threading.Event()
        in_critical = [False]
        exclusion_ok = [False]

        def holder():
            with lock:
                in_critical[0] = True
                held.set()
                time.sleep(0.5)
                in_critical[0] = False

        def waiter():
            held.wait(timeout=5)
            with lock:
                exclusion_ok[0] = not in_critical[0]

        t1 = threading.Thread(target=holder, daemon=True)
        t2 = threading.Thread(target=waiter, daemon=True)
        t1.start()
        t2.start()
        t1.join(timeout=10)
        t2.join(timeout=10)
        assert not t1.is_alive() and not t2.is_alive(), "deadlocked"
        assert exclusion_ok[0], "waiter entered while holder held"

    def test_segment_survives_creator_close(self, shm_dir):
        seg = SharedMemorySegment("seg_test_x", size=64, create=True)
        assert seg.path == str(shm_dir / "seg_test_x")
        seg.buf[:4] = b"abcd"
        seg.close()
        seg2 = SharedMemorySegment("seg_test_x")
        assert bytes(seg2.buf[:4]) == b"abcd"
        seg2.unlink()
        assert not os.path.exists(seg.path)


# ---------------------------------------------------------------------------
# shm handler
# ---------------------------------------------------------------------------


class TestShmHandler:
    def test_flat_state_roundtrip(self, ipc, job):
        h = SharedMemoryHandler(job, node_rank=7)
        flat = {
            "a/b": np.arange(12, dtype=np.float32).reshape(3, 4),
            "c": np.array([1, 2], dtype=np.int32),
            "odd": np.arange(3, dtype=np.int8),   # leaves later offsets odd
            "d": np.array(5, dtype=np.int32),
        }
        h.save_flat_state(5, flat, save_path="/x", aux=b"aux!")
        meta, loaded = h.load_flat_state()
        assert meta.step == 5 and meta.aux == b"aux!"
        assert meta.save_path == "/x"
        _assert_bit_equal(loaded, flat)
        h.close(unlink=True)

    def test_read_completes_short_reads(self, ipc, job, monkeypatch):
        """A read returns at most ~2 GiB on Linux (an embedding's f32
        moment of a larger vocabulary is more): the handler loops until
        each leaf is whole. Here every read returns at most 7 bytes."""
        import dlrover_tpu_torch.agent.ckpt_saver as saver_mod

        real = os.preadv

        def short(fd, buffers, offset):
            return real(fd, [memoryview(buffers[0])[:7]], offset)

        h = SharedMemoryHandler(job, node_rank=12)
        flat = {"a": np.arange(1000, dtype=np.float32),
                "b": np.arange(77, dtype=np.int8)}
        h.save_flat_state(2, flat)
        monkeypatch.setattr(saver_mod.os, "preadv", short)
        meta, loaded = h.load_flat_state()
        _assert_bit_equal(loaded, flat)
        h.close(unlink=True)

    def test_grow_segment(self, ipc, job):
        h = SharedMemoryHandler(job, node_rank=8)
        h.save_flat_state(1, {"x": np.zeros(4, np.float32)})
        h.save_flat_state(2, {"x": np.zeros(4096, np.float32)})
        meta, loaded = h.load_flat_state()
        assert loaded["x"].shape == (4096,)
        h.close(unlink=True)

    def test_stale_mapping_reattaches_after_writer_grow(self, ipc, job):
        writer = SharedMemoryHandler(job, node_rank=9)
        reader = SharedMemoryHandler(job, node_rank=9)
        writer.save_flat_state(1, {"x": np.zeros(4, np.float32)})
        _, loaded = reader.load_flat_state()
        assert loaded["x"].shape == (4,)
        big = np.arange(8192, dtype=np.float32)
        writer.save_flat_state(2, {"x": big})
        meta, loaded = reader.load_flat_state()
        assert meta.step == 2
        np.testing.assert_array_equal(loaded["x"], big)
        reader.close()
        writer.close(unlink=True)

    def test_stale_mapping_detects_unlink_recreate(self, ipc, job):
        writer = SharedMemoryHandler(job, node_rank=11)
        reader = SharedMemoryHandler(job, node_rank=11)
        writer.save_flat_state(1, {"x": np.zeros(64, np.float32)})
        _, loaded = reader.load_flat_state()
        assert loaded["x"].sum() == 0
        writer.close(unlink=True)
        writer2 = SharedMemoryHandler(job, node_rank=11)
        new = np.full(64, 7.0, np.float32)
        writer2.save_flat_state(2, {"x": new})
        meta, loaded = reader.load_flat_state()
        assert meta.step == 2
        np.testing.assert_array_equal(loaded["x"], new)
        reader.close()
        writer2.close(unlink=True)

    def test_integrity_error_when_segment_truncated(self, ipc, job):
        h = SharedMemoryHandler(job, node_rank=10)
        h.save_flat_state(3, {"x": np.zeros(1024, np.float32)})
        path = h._segment.path
        h.close()
        os.truncate(path, 16)
        reader = SharedMemoryHandler(job, node_rank=10)
        with pytest.raises(ShmIntegrityError):
            reader.load_flat_state()
        reader.close()
        os.unlink(path)


# ---------------------------------------------------------------------------
# flatten / unflatten of the port's train state
# ---------------------------------------------------------------------------


class TestFlattenState:
    @pytest.mark.parametrize("opt", ["adamw", "int8_adam", "bf16_adam"])
    def test_roundtrip_into_a_fresh_state(self, opt):
        """Flatten a trained state, restore it into a fresh one from
        another seed: every leaf bit-equal, the optimizer bound to the
        fresh state's own params, and the next step of both equal."""
        factory = bf16_adam(1e-3) if opt == "bf16_adam" else opt
        src = _port_state(factory, steps=2, loss_scale=True)
        flat, aux = flatten_state(src)
        if opt == "bf16_adam":
            assert flat["opt_state/0/mu/layers/wq"].dtype == np.uint16
            assert pickle.loads(aux)["dtypes"][
                "opt_state/0/mu/layers/wq"] == "bfloat16"
        acc = _port_acc(factory, seed=1, loss_scale=True)
        dst = acc.init(torch.Generator().manual_seed(1))
        params_before = {id(p) for p in dst["opt_state"].param_groups[0][
            "params"]}
        out = unflatten_state(flat, aux, target=dst)
        assert out is dst and dst["step"] == 2
        assert {id(p) for p in dst["opt_state"].param_groups[0][
            "params"]} == params_before
        _assert_bit_equal(_leaf_bits(dst), _leaf_bits(src))
        b = _t_batch(_batch(7))
        src, m_src = _port_acc(factory, loss_scale=True).train_step(src, b)
        dst, m_dst = acc.train_step(dst, b)
        assert float(m_src["loss"]) == float(m_dst["loss"])
        _assert_bit_equal(_leaf_bits(dst), _leaf_bits(src))

    def test_adamw_before_its_first_step_has_the_optax_layout(self):
        """torch's AdamW has no state before its first step; optax has
        zero moments and count 0 from init: the port stages those, and
        a restore fills an empty optimizer state."""
        state = _port_state("adamw", steps=0)
        assert state["opt_state"].state == {}
        flat, aux = flatten_state(state)
        j_flat, _ = jengine.flatten_state(_jax_state("adamw", 0))
        assert sorted(flat) == sorted(j_flat)
        for k, v in flat.items():
            if k.startswith("opt_state"):
                assert not np.any(v), k
        trained = _port_state("adamw", steps=1)
        fresh = _port_state("adamw", steps=0, seed=2)
        train_state_from_numpy(fresh, *flatten_state(trained))
        opt = fresh["opt_state"]
        assert len(opt.state) == 12
        assert all(float(st["step"]) == 1.0 for st in opt.state.values())
        _assert_bit_equal(_leaf_bits(fresh), _leaf_bits(trained))

    def test_failed_restore_leaves_the_target_as_it_was(self):
        state = _port_state("adamw", steps=1)
        flat, aux = flatten_state(_port_state("adamw", steps=1, seed=3))
        before = _leaf_bits(state)
        bad = dict(flat)
        del bad["opt_state/0/nu/layers/wv"]
        with pytest.raises(KeyError, match="nu/layers/wv"):
            train_state_from_numpy(state, bad, aux)
        bad = dict(flat)
        bad["params/layers/wq"] = bad["params/layers/wq"][:1]
        with pytest.raises(ValueError, match="params/layers/wq"):
            train_state_from_numpy(state, bad, aux)
        _assert_bit_equal(_leaf_bits(state), before)

    def test_unflatten_without_a_target_builds_a_tree(self):
        flat, aux = flatten_state(_port_state("adamw", steps=1))
        tree = unflatten_state(flat, aux, device="cpu")
        np.testing.assert_array_equal(
            tree["params"]["layers"]["wq"].numpy(),
            flat["params/layers/wq"])
        assert int(tree["opt_state"]["0"]["count"]) == 1

    def test_unsupported_optimizer_raises(self):
        state = _port_state(lambda ps: torch.optim.SGD(ps, lr=0.1))
        with pytest.raises(NotImplementedError, match="SGD"):
            flatten_state(state)


# ---------------------------------------------------------------------------
# the layout across packages
# ---------------------------------------------------------------------------


class TestCrossPackageLayout:
    @pytest.mark.parametrize("opt", ["adamw", "int8_adam"])
    def test_port_npz_has_jax_flatten_state_keys_and_bits(self, tmp_path,
                                                          opt):
        """A JAX train state after 2 steps, carried into the port
        (`train_state_from_numpy`), saved by the port's engine: the
        host_0.npz that JAX's `_extract_npz` reads holds exactly JAX
        `flatten_state`'s keys and arrays, bit for bit."""
        j_state = _jax_state(opt, 2)
        j_flat, _ = jengine.flatten_state(j_state)
        state = train_state_from_numpy(_port_state(opt, seed=4), j_flat)
        # the carried state is the JAX one, read directly
        mu = (state["opt_state"].state[state["params"]["layers"]["wq"]]
              ["exp_avg" if opt == "adamw" else "q_mu"])
        want = (j_state["opt_state"][0].mu if opt == "adamw"
                else j_state["opt_state"][0].q_mu)["layers"]["wq"]
        assert np.array_equal(mu.numpy(), np.asarray(want))
        eng = CheckpointEngine(str(tmp_path / "ck"), job_name=_job("x"))
        try:
            eng.save_to_storage(2, state)
            assert eng.wait_for_persist(2, timeout=30)
        finally:
            eng.close()
        with open(tmp_path / "ck" / "2" / "host_0.npz", "rb") as f:
            got = jengine._extract_npz(f.read())
        _assert_bit_equal(got, j_flat)

    @pytest.mark.parametrize("opt", ["adamw", "int8_adam"])
    def test_jax_saved_checkpoint_restores_into_the_port(self, tmp_path,
                                                         opt):
        """The JAX engine saves a JAX train state; the port's engine
        loads that directory into a port state (its aux, a JAX treedef,
        is refused unread): every leaf bit-equal to JAX's
        `flatten_state`, and the restored state trains on."""
        j_state = _jax_state(opt, 2)
        j_flat, _ = jengine.flatten_state(j_state)
        ckpt = str(tmp_path / "jck")
        jeng = jengine.CheckpointEngine(ckpt, job_name=_job("jax"))
        try:
            jeng.save_to_storage(2, j_state)
            assert jeng.wait_for_persist(2, timeout=30)
        finally:
            jeng.shm_handler.close(unlink=True)
            jeng.close()
        eng = CheckpointEngine(ckpt, job_name=_job("port"))
        try:
            acc = _port_acc(opt, seed=5)
            state = acc.init(torch.Generator().manual_seed(0))
            step, restored = eng.load(target=state)
        finally:
            eng.close()
        assert step == 2 and restored is state and state["step"] == 2
        _assert_bit_equal(flatten_state(state)[0], j_flat)
        state, m = acc.train_step(state, _t_batch(_batch(9)))
        assert np.isfinite(float(m["loss"])) and state["step"] == 3


# ---------------------------------------------------------------------------
# engine end to end
# ---------------------------------------------------------------------------


class TestEngineEndToEnd:
    @pytest.fixture()
    def eng(self, tmp_path):
        e = CheckpointEngine(str(tmp_path / "ckpt"), job_name=_job("eng"))
        yield e
        e.close()

    def test_memory_save_load(self, eng):
        state = _port_state("adamw", steps=1)
        blocked = eng.save_to_memory(3, state)
        assert blocked < 5.0
        step, tree = eng.load_from_memory(device="cpu")
        assert step == 3
        np.testing.assert_array_equal(
            tree["params"]["layers"]["wq"].numpy(),
            state["params"]["layers"]["wq"].detach().numpy())

    def test_async_memory_save_load(self, eng):
        state = _port_state("adamw", steps=1)
        eng.save_to_memory_async(4, state)
        eng.wait_for_staging()
        assert eng.last_staged_bytes > 0
        fresh = _port_state("adamw", seed=6)
        step, restored = eng.load_from_memory(target=fresh)
        assert step == 4 and restored is fresh
        _assert_bit_equal(_leaf_bits(fresh), _leaf_bits(state))

    def test_async_save_stages_the_state_before_the_next_step(self, eng):
        """The next optimizer step overwrites params and moments in
        place right after the save returns: the staged bytes are still
        those of the saved step."""
        acc = _port_acc("adamw")
        state = acc.init(torch.Generator().manual_seed(0))
        state, _ = acc.train_step(state, _t_batch(_batch(1)))
        saved = _leaf_bits(state)
        eng.save_to_memory_async(1, state)
        state, _ = acc.train_step(state, _t_batch(_batch(2)))
        now = _leaf_bits(state)
        assert not np.array_equal(now["params/layers/wq"],
                                  saved["params/layers/wq"])
        eng.wait_for_staging()
        with eng.shm_handler.lock:
            meta, flat = eng.shm_handler.load_flat_state()
        assert meta.step == 1
        _assert_bit_equal({k: _bits(v) for k, v in flat.items()}, saved)

    def test_disk_save_commit_load(self, eng):
        state = _port_state("int8_adam", steps=1)
        eng.save_to_storage(9, state)
        assert eng.wait_for_persist(9, timeout=30)
        assert read_tracker_step(eng.storage, eng.checkpoint_dir) == 9
        fresh = _port_state("int8_adam", seed=7)
        step, restored = eng.load_from_storage(target=fresh)
        assert step == 9
        _assert_bit_equal(_leaf_bits(fresh), _leaf_bits(state))

    def test_load_falls_back_to_disk_on_torn_shm(self, eng):
        s1 = _port_state("adamw", steps=1)
        eng.save_to_storage(1, s1)
        assert eng.wait_for_persist(1, timeout=30)
        eng.save_to_memory(2, _port_state("adamw", steps=2))
        seg_path = eng.shm_handler._segment.path
        eng.shm_handler.close()
        os.truncate(seg_path, 8)
        target = _port_state("adamw", seed=8)
        step, restored = eng.load(target=target)
        assert step == 1
        _assert_bit_equal(_leaf_bits(target), _leaf_bits(s1))

    def test_load_prefers_newer_memory(self, eng):
        eng.save_to_storage(1, _port_state("adamw", steps=1))
        assert eng.wait_for_persist(1, timeout=30)
        s2 = _port_state("adamw", steps=2)
        eng.save_to_memory(2, s2)
        target = _port_state("adamw", seed=9)
        step, _ = eng.load(target=target)
        assert step == 2
        _assert_bit_equal(_leaf_bits(target), _leaf_bits(s2))

    def test_load_with_nothing_saved(self, eng):
        target = _port_state("adamw")
        before = _leaf_bits(target)
        assert eng.load(target=target) == (-1, None)
        _assert_bit_equal(_leaf_bits(target), before)

    def test_checkpointer_api(self, tmp_path):
        ck = Checkpointer(str(tmp_path / "ck"), job_name=_job("ckr"))
        try:
            state = _port_state("adamw", steps=1)
            blocked = ck.save_checkpoint(4, state, StorageType.MEMORY)
            assert blocked < 5.0
            step, _ = ck.load_checkpoint(target=_port_state("adamw", seed=1))
            assert step == 4
            ck.save_checkpoint(5, state, StorageType.DISK)
            assert ck.wait_latest_checkpoint(5, timeout=30)
        finally:
            ck.close()

    def test_close_persists_what_was_queued(self, tmp_path):
        """An in-process saver stops only after the persists queued
        before `close`: a DISK save right before it still commits."""
        eng = CheckpointEngine(str(tmp_path / "ck"), job_name=_job("cls"))
        eng.save_to_storage(6, _port_state("adamw", steps=1))
        eng.close()
        assert read_tracker_step(eng.storage, eng.checkpoint_dir) == 6
        assert not os.path.exists(eng._ipc.path)

    def test_replica_manager_raises(self, tmp_path):
        """The engine takes a replica manager (ported since); one whose
        backup raises leaves the save and the memory restore whole: the
        replica is best-effort, as in JAX."""
        class Raising:
            calls = 0

            def backup(self, step, flat, aux):
                Raising.calls += 1
                raise RuntimeError("master unreachable")

        eng = CheckpointEngine(str(tmp_path), job_name=_job("r"),
                               replica_manager=Raising())
        try:
            state = _port_state("adamw", steps=1)
            eng.save_to_memory(1, state)
            step, flat = eng.load_from_memory(device="cpu")
            assert step == 1 and flat is not None
        finally:
            eng.close()
        assert Raising.calls == 1


class TestFormats:
    def test_full_checkpointer_roundtrip(self, tmp_path):
        fc = FullCheckpointer(str(tmp_path / "full"))
        state = _port_state("int8_adam", steps=1)
        fc.save_checkpoint(3, state)
        with pytest.raises(ValueError, match="DISK"):
            fc.save_checkpoint(3, state, StorageType.MEMORY)
        target = _port_state("int8_adam", seed=2)
        step, restored = fc.load_checkpoint(target=target)
        assert step == 3 and restored is target
        _assert_bit_equal(_leaf_bits(target), _leaf_bits(state))
        assert FullCheckpointer(str(tmp_path / "none")).load_checkpoint() == (
            -1, None)

    def test_orbax_raises(self, tmp_path):
        with pytest.raises(NotImplementedError, match="item 9"):
            OrbaxCheckpointer(str(tmp_path))


# ---------------------------------------------------------------------------
# crash survival: the trainer in a subprocess that dies after staging
# ---------------------------------------------------------------------------

_TRAINER = textwrap.dedent("""
    import os, sys, torch
    from dlrover_tpu_torch.trainer.flash_checkpoint.engine import (
        CheckpointEngine)
    w = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    w.requires_grad_(True)
    opt = torch.optim.AdamW([w], lr=0.1)
    w.grad = torch.full_like(w, 0.5)
    opt.step()
    state = {"params": {"w": w}, "opt_state": opt, "step": 7}
    eng = CheckpointEngine(sys.argv[1], job_name=sys.argv[2])
    eng.save_to_memory(7, state)
    print("staged", flush=True)
    os._exit(0)   # dies: no close, no persist of its own
""")


def _crash_state():
    w = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    w.requires_grad_(True)
    opt = torch.optim.AdamW([w], lr=0.1)
    w.grad = torch.full_like(w, 0.5)
    opt.step()
    return {"params": {"w": w}, "opt_state": opt, "step": 7}


class TestCrashSurvival:
    def test_saver_persists_after_trainer_death(self, tmp_path, ipc, job):
        """The agent (server + saver, here) outlives a trainer process
        that staged step 7 and died: the saver persists it, and a new
        trainer restores it from memory and from disk."""
        ckpt = str(tmp_path / "ckpt")
        out = subprocess.run([sys.executable, "-c", _TRAINER, ckpt, job],
                             capture_output=True, text=True, timeout=120,
                             env=_cpu_env())
        assert out.returncode == 0 and "staged" in out.stdout, out.stderr
        saver = AsyncCheckpointSaver(job_name=job, node_rank=0)
        try:
            saver.save_shm_to_storage()
            assert read_tracker_step(saver.storage, ckpt) == 7
            assert os.path.exists(os.path.join(ckpt, "7", "host_0.npz"))
            want = _leaf_bits(_crash_state())
            eng = CheckpointEngine(ckpt, job_name=job, local_saver=False)
            try:
                assert eng._ipc is None   # the agent's server
                for source in ("memory", "storage"):
                    target = _crash_state()
                    with torch.no_grad():
                        target["params"]["w"].zero_()
                    load = (eng.load_from_memory if source == "memory"
                            else eng.load_from_storage)
                    step, _ = load(target=target)
                    assert step == 7, source
                    _assert_bit_equal(_leaf_bits(target), want)
            finally:
                eng.close()
        finally:
            saver.shm_handler.close(unlink=True)

    def test_stale_step_not_repersisted(self, tmp_path, ipc, job):
        ckpt = str(tmp_path / "ckpt")
        saver = AsyncCheckpointSaver(job_name=job, node_rank=0)
        trainer_h = SharedMemoryHandler(job, node_rank=0)
        flat, aux = flatten_state(_crash_state())
        trainer_h.save_flat_state(3, flat, save_path=ckpt, aux=aux)
        saver.save_step_checkpoint(3, ckpt)
        saver.last_persisted_step = 3
        mtime = os.path.getmtime(os.path.join(ckpt, "3", "host_0.npz"))
        saver.save_shm_to_storage()  # same step: no-op
        assert read_tracker_step(saver.storage, ckpt) == 3
        assert os.path.getmtime(
            os.path.join(ckpt, "3", "host_0.npz")) == mtime
        trainer_h.close()
        saver.shm_handler.close(unlink=True)


# ---------------------------------------------------------------------------
# retention
# ---------------------------------------------------------------------------


class TestRetention:
    def test_keep_latest(self, tmp_path):
        strat = KeepLatestStepStrategy(max_to_keep=2,
                                       checkpoint_dir=str(tmp_path))
        storage = PosixDiskStorage(strat)
        for step in (1, 2, 3):
            (tmp_path / str(step)).mkdir()
            storage.commit(step, True)
        assert not (tmp_path / "1").exists()
        assert (tmp_path / "2").exists() and (tmp_path / "3").exists()

    def test_max_to_keep_prunes_old_steps(self, tmp_path):
        eng = CheckpointEngine(str(tmp_path), job_name=_job("ret"),
                               max_to_keep=2)
        try:
            for step in (1, 2, 3, 4):
                state = _port_state("adamw", steps=0)
                state["step"] = step
                eng.save_to_storage(step, state)
                # one shm slot: the persist of this step lands before the
                # next save overwrites the staging area
                assert eng.wait_for_persist(step, timeout=30)
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                dirs = sorted(d for d in os.listdir(tmp_path) if d.isdigit())
                if dirs == ["3", "4"]:
                    break
                time.sleep(0.1)
            assert dirs == ["3", "4"], dirs
            target = _port_state("adamw", seed=1)
            step, _ = eng.load_from_storage(target=target)
            assert step == 4 and target["step"] == 4
        finally:
            eng.close()

    def test_retention_counts_preexisting_dirs(self, tmp_path):
        for old in (1, 2):
            os.makedirs(tmp_path / str(old))
        strat = KeepLatestStepStrategy(2, str(tmp_path))
        deleted = []
        strat.clean_up(3, lambda p: deleted.append(p))
        assert deleted == [str(tmp_path / "1")]
        strat.clean_up(4, lambda p: deleted.append(p))
        assert deleted == [str(tmp_path / "1"), str(tmp_path / "2")]

    def test_streamed_write_is_atomic(self, tmp_path):
        """`write` of a callable streams into the tmp file; a writer
        that fails leaves neither the target nor the tmp file."""
        storage = PosixDiskStorage()
        path = str(tmp_path / "d" / "f.npz")
        storage.write(lambda f: np.savez(f, a=np.arange(3)), path)
        assert _extract_npz(storage.read(path))["a"].tolist() == [0, 1, 2]

        def boom(f):
            f.write(b"partial")
            raise OSError("disk full")

        with pytest.raises(OSError):
            storage.write(boom, str(tmp_path / "d" / "g.npz"))
        assert sorted(os.listdir(tmp_path / "d")) == ["f.npz"]


def test_loss_scale_and_step_leaves_match_jax_paths():
    state = _port_state("adamw", loss_scale=True)
    leaves = state_leaves(state)
    assert list(leaves)[:3] == ["loss_scale/scale", "loss_scale/good_steps",
                                "opt_state/0/count"]
    assert leaves["loss_scale/good_steps"].dtype == torch.int32
    assert isinstance(state["loss_scale"], amp.LossScaleState)
