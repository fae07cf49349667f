"""The port's job master in one process (dlrover_tpu_torch/master/,
agent/master_client.py, common/comm.py) against the JAX package's.

Each scenario drives the same call sequence into JAX's LocalJobMaster
through JAX's MasterClient (gRPC) and into the port's through the
port's client (the stdlib transport), and returns plain values: message
dataclasses as `dataclasses.asdict` dicts (never `==` across packages,
whose classes differ), ints, strings, tuples. Integer outcomes must be
exactly equal: shard ranges, task ids, epochs, rendezvous rounds,
worlds and ranks, KV values, sync states, checkpoint steps, the four
restart cases of tests/test_master_restart.py. Shuffled shard orders
come from Python's global `random`, seeded before each package's
sequence (before the dataset's registration: the master's watch
thread may draw an epoch's order as soon as the dataset exists).

Then the transport on its own (concurrency, the frame cap, restart on
the same port, no fallback after the retries), the serving replica
pool registering through the port's master, and a tiny f32 Llama
through the port's `Trainer(master_client=...)`: its model-info report
against JAX's `_report_model_info` on the same config and batch, steps
and checkpoints reaching the master, and the `HangingDetector`'s
failure report.
"""

import contextlib
import dataclasses
import json
import os
import random
import threading
import time

import numpy as np
import pytest
import torch

from dlrover_tpu.agent.master_client import MasterClient as JClient
from dlrover_tpu.common import messages as jmsg
from dlrover_tpu.master.master import LocalJobMaster as JMaster
from dlrover_tpu.trainer.elastic.data import ShardingClient as JSharding
from dlrover_tpu_torch.agent.master_client import MasterClient as TClient
from dlrover_tpu_torch.common import comm as tcomm
from dlrover_tpu_torch.common import messages as tmsg
from dlrover_tpu_torch.master.master import LocalJobMaster as TMaster
from dlrover_tpu_torch.trainer.elastic.data import ShardingClient as TSharding


@dataclasses.dataclass
class Side:
    """One package's master, client and sharding-client classes."""

    Master: type
    Client: type
    Sharding: type
    msg: object


JAX = Side(JMaster, JClient, JSharding, jmsg)
PORT = Side(TMaster, TClient, TSharding, tmsg)


@contextlib.contextmanager
def _master(side, num_nodes=1, port=0):
    m = side.Master(port=port, num_nodes=num_nodes, poll_interval=0.05)
    m.start()
    try:
        yield m
    finally:
        m.stop()


@contextlib.contextmanager
def _clients(side, m, n=1, max_retries=5):
    cs = [side.Client(m.addr, node_id=i, max_retries=max_retries)
          for i in range(n)]
    try:
        yield cs
    finally:
        for c in cs:
            c.close()


def both(scenario, *args):
    """The scenario's plain result in JAX and in the port."""
    return tuple(scenario(side, *args) for side in (JAX, PORT))


def _task(t):
    d = dataclasses.asdict(t)
    d["exists"] = t.exists
    return d


def _drain(client, name):
    out = []
    while True:
        t = client.get_task(name)
        if not t.exists:
            return out
        out.append(_task(t))
        client.report_task_result(name, t.task_id, True)


# ---- dynamic data sharding --------------------------------------------------


def _exhaust(side, shuffle, storage):
    with _master(side) as m, _clients(side, m) as (c,):
        # seeded before the registration: the master's watch thread may
        # draw the first epoch's order (finished() refills) at any time
        random.seed(11)
        c.report_dataset_params("ds", 53, 7, num_epochs=2, shuffle=shuffle,
                                storage_type=storage)
        tasks = _drain(c, "ds")
        ep = c.get_dataset_epoch("ds")
        return tasks, dataclasses.asdict(ep), m.servicer.task_manager.finished()


@pytest.mark.parametrize("shuffle,storage", [(False, "table"),
                                             (True, "table"),
                                             (True, "text")])
def test_get_task_to_exhaustion_equals_jax(shuffle, storage):
    j, t = both(_exhaust, shuffle, storage)
    assert t == j
    tasks, epoch, finished = t
    assert len(tasks) == 2 * 8 and finished
    assert epoch == {"epoch": 2, "finished": True}
    if shuffle and storage == "table":
        first = [(x["shard_start"], x["shard_end"]) for x in tasks[:8]]
        assert first != sorted(first)          # the shards were permuted


def _recovery(side):
    """Node 0 fails a task, node 1 holds two when it is reported
    FAILED: both go back on the queue (report_task_result(False) at
    the head; recover_tasks for the dead node)."""
    with _master(side, num_nodes=2) as m, _clients(side, m, 2) as (a, b):
        for c in (a, b):
            c.register_node(rank=c.node_id)
            c.report_node_status("running")
        a.report_dataset_params("ds", 40, 5)
        ta = [a.get_task("ds") for _ in range(2)]
        tb = [b.get_task("ds") for _ in range(2)]
        ok = a.report_task_result("ds", ta[0].task_id, False).success
        a.report_task_result("ds", ta[1].task_id, True)
        b.report_node_status("failed", exit_reason="killed")
        node = m.servicer.node_manager.get_node("worker", 1)
        return (ok, [_task(t) for t in ta + tb], node.status,
                node.relaunch_count, _drain(a, "ds"))


def test_failed_task_and_dead_node_reissue_equal_jax():
    j, t = both(_recovery)
    assert t == j
    ok, issued, status, relaunches, rest = t
    assert ok and status == "pending" and relaunches == 1
    reissued = [(x["task_id"]) for x in rest[:3]]
    assert sorted(reissued) == [0, 2, 3]


def _checkpoint_roundtrip(side):
    with _master(side) as m, _clients(side, m) as (c,):
        random.seed(3)
        c.report_dataset_params("ds", 30, 4, num_epochs=2, shuffle=True)
        got = [c.get_task("ds") for _ in range(3)]
        c.report_task_result("ds", got[0].task_id, True)
        content = c.get_shard_checkpoint("ds")
        c.restore_shard_checkpoint("ds", content)
        random.seed(4)
        return json.loads(content), _drain(c, "ds")


def test_shard_checkpoint_roundtrip_equal_jax():
    j, t = both(_checkpoint_roundtrip)
    assert t == j
    content, rest = t
    assert content["completed"] == 1 and len(content["todo_shards"]) == 7
    # the two in-flight shards come back after the restore
    assert len(rest) == 7 + 8


# ---- rendezvous, KV, sync, steps, checkpoints -------------------------------


def _rendezvous(side):
    with _master(side, num_nodes=3) as m, _clients(side, m, 3) as cs:
        out = [cs[0].num_nodes_waiting()]
        rounds = []
        for c in cs:
            rounds.append(c.join_rendezvous(local_world_size=2 + c.node_id,
                                            node_addr=f"h{c.node_id}"))
            out.append(cs[0].num_nodes_waiting())
        worlds = [c.get_comm_world() for c in cs]
        state = dataclasses.asdict(cs[0].rdzv_state())
        # node 1 leaves and joins again: the next round
        again = cs[1].join_rendezvous(local_world_size=3)
        waiting = cs[1].num_nodes_waiting()
        return out, rounds, worlds, state, again, waiting


def test_three_node_rendezvous_equal_jax():
    j, t = both(_rendezvous)
    assert t == j
    waiting, rounds, worlds, state, again, rejoined = t
    # waiting counts nodes that wait beside a formed world only
    assert waiting == [0, 0, 0, 0] and rounds == [0, 0, 0]
    assert all(w == (1, 0, {0: (0, 2, "h0"), 1: (1, 3, "h1"),
                            2: (2, 4, "h2")}) for w in worlds)
    assert state == {"round": 1, "world_size": 3, "waiting_num": 0}
    assert again == 1 and rejoined == 1


def _kv_and_sync(side):
    with _master(side, num_nodes=2) as m, _clients(side, m, 2) as (a, b):
        a.kv_set("k", b"v1")
        a.kv_set("k", b"v2")
        kv = (b.kv_get("k"), b.kv_get("missing"))
        sync = [a.sync_join("barrier"), a.sync_finished("barrier"),
                b.sync_join("barrier"), a.sync_finished("barrier"),
                a.sync_finished("other")]
        a.report(side.msg.SyncFinish(sync_name="other"))
        sync.append(b.sync_finished("other"))
        return kv, sync, m.servicer.sync_service.members("barrier")


def test_kv_and_sync_equal_jax():
    j, t = both(_kv_and_sync)
    assert t == j
    assert t == ((b"v2", b""), [False, False, True, True, False, True],
                 [0, 1])


def _steps_and_ckpts(side):
    with _master(side) as m, _clients(side, m) as (c,):
        for step in (1, 5, 3):
            c.report_global_step(step, host_compute_ms=2.5)
        sm = m.servicer.speed_monitor
        c.report_ckpt_saved(4, "/ckpt")
        c.report_ckpt_saved(2, "/ckpt")
        c.report_ckpt_saved(7, "/other")
        steps = (c.get_ckpt_latest_step("/ckpt"),
                 c.get_ckpt_latest_step("/other"),
                 c.get_ckpt_latest_step("/none"))
        samples = {k: v[0] for k, v in sm.worker_compute_samples().items()}
        return (sm.global_step, sm.all_worker_steps(), samples, steps,
                c.get_job_stage())


def test_global_step_and_ckpt_steps_equal_jax():
    j, t = both(_steps_and_ckpts)
    assert t == j
    assert t == (5, {0: 3}, {0: 2.5}, (4, 7, -1), "running")


def _model_info(side):
    with _master(side) as m, _clients(side, m) as (c,):
        c.report_model_info(num_params=1000, flops_per_step=8e6,
                            batch_size_per_host=4, seq_len=100)
        model = m.servicer.metric_collector._model
        return dataclasses.asdict(model), m.servicer.run_configs["model_info"]


def test_model_info_reaches_the_collector_equal_jax():
    j, t = both(_model_info)
    assert t[0] == j[0]
    assert t[0]["flops_per_token"] == 8e6 / 400
    assert t[1] == j[1]     # the dataclass repr: same class name and fields


# ---- master restarts (tests/test_master_restart.py's four cases) ------------


def _restart_resume(side):
    """Case 1: a restarted master on the same port has no datasets; the
    client re-registers and restores its last pulled checkpoint."""
    port = tmsg.find_free_port()
    with _master(side, port=port) as m1, _clients(side, m1) as (c,):
        sc = side.Sharding("ds", dataset_size=64, shard_size=4,
                           master_client=c)
        sc.checkpoint_interval_s = 0.0
        consumed = []
        for _ in range(6):
            task = sc.fetch_shard()
            consumed.append((task.shard_start, task.shard_end))
            sc.report_done(task.task_id)
        m1.stop()
        time.sleep(0.3)
        with _master(side, port=port):
            remaining = [(t.shard_start, t.shard_end)
                         for t in sc.iter_shards()]
    return consumed, remaining


def test_restart_dataset_reregisters_and_resumes_equal_jax():
    j, t = both(_restart_resume)
    assert t == j
    consumed, remaining = t
    covered = {i for s, e in consumed + remaining for i in range(s, e)}
    assert covered == set(range(64)) and not set(consumed) & set(remaining)


def _unknown_not_exhausted(side):
    """Case 2: `dataset_known=False` is not end of data."""
    with _master(side) as m, _clients(side, m) as (c,):
        unknown = _task(c.get_task("never-registered"))
        unknown["known"] = c.get_task("never-registered").dataset_known
        sc = side.Sharding("tiny", dataset_size=8, shard_size=4,
                           master_client=c)
        return unknown, [_task(t) for t in sc.iter_shards()]


def test_restart_unknown_dataset_not_exhausted_equal_jax():
    j, t = both(_unknown_not_exhausted)
    assert t == j
    assert t[0]["known"] is False and len(t[1]) == 2


def _session_change(side):
    """Case 3: the heartbeat's `master_session` changes across a restart
    on the same port; the node re-registers and is RUNNING on the new
    master. (JAX's agent reacts to the change; the agent is not ported,
    so the client's own calls stand in for it on both sides.)"""
    port = tmsg.find_free_port()
    with _master(side, port=port) as m1, _clients(side, m1,
                                                  max_retries=10) as (c,):
        c.register_node(rank=0)
        s1 = c.report_heart_beat().master_session
        running1 = m1.servicer.node_manager.get_node("worker", 0).status
        m1.stop()
        time.sleep(0.3)
        with _master(side, port=port) as m2:
            s2 = c.report_heart_beat().master_session
            before = m2.servicer.node_manager.get_node("worker", 0)
            # the new master learnt the node from its heartbeat alone;
            # the re-registration gives it the node's rank and address
            c.register_node(rank=0, addr="host-0")
            c.report_node_status("running")
            node = m2.servicer.node_manager.get_node("worker", 0)
            return (bool(s1) and bool(s2) and s1 != s2, running1,
                    before is None, node.status, node.host_addr,
                    node.rank_index)


def test_restart_heartbeat_session_change_triggers_reregister_equal_jax():
    j, t = both(_session_change)
    assert t == j
    assert t[0] is True and t[1] == "running"
    assert t[3:] == ("running", "host-0", 0)


def _stale_restore(side):
    """Case 4: after a restart the first recovering worker's restore
    wins; a peer's stale restore is ignored."""
    port = tmsg.find_free_port()
    with _master(side, port=port) as m1, _clients(side, m1, 2) as (ca, cb):
        sa = side.Sharding("ds", dataset_size=32, shard_size=4,
                           master_client=ca, node_id=0)
        sb = side.Sharding("ds", dataset_size=32, shard_size=4,
                           master_client=cb, node_id=1)
        sa.checkpoint_interval_s = sb.checkpoint_interval_s = 0.0
        for sc in (sa, sb):
            for _ in range(2):
                sc.report_done(sc.fetch_shard().task_id)
        m1.stop()
        time.sleep(0.3)
        with _master(side, port=port) as m2:
            ta = sa.fetch_shard()
            tb = sb.fetch_shard()
            ds = m2.servicer.task_manager.get_dataset("ds")
            in_doing = ta.task_id in ds._doing
            sa.report_done(ta.task_id)
            sb.report_done(tb.task_id)
            rest = {n: [(t.shard_start, t.shard_end) for t in sc.iter_shards()]
                    for n, sc in (("a", sa), ("b", sb))}
            return (_task(ta), _task(tb), in_doing, rest,
                    ds.finished())


def test_restart_second_workers_stale_restore_ignored_equal_jax():
    j, t = both(_stale_restore)
    assert t == j
    ta, tb, in_doing, rest, finished = t
    assert in_doing and finished
    covered = {i for x in (ta, tb)
               for i in range(x["shard_start"], x["shard_end"])}
    covered |= {i for r in rest.values() for s, e in r for i in range(s, e)}
    # A's restore wins: its last pull (after its own 2 acks, before B
    # acked any) leaves shards 2-7; B's 2 acked shards are replayed
    assert covered == set(range(8, 32))


def test_client_raises_connection_error_after_the_retries(monkeypatch):
    """No fallback: with the master gone, `_call` sleeps JAX's backoff
    between tries (2 s, 4 s, ..., capped at 10) and raises
    ConnectionError from the transport's RpcError."""
    sleeps = []
    monkeypatch.setattr(time, "sleep", sleeps.append)
    port = tmsg.find_free_port()
    c = TClient(f"127.0.0.1:{port}", node_id=0, max_retries=4)
    with pytest.raises(ConnectionError, match="after 4 tries") as e:
        c.kv_get("k")
    assert isinstance(e.value.__cause__, tcomm.RpcError)
    assert e.value.__cause__.code() == "UNAVAILABLE"
    assert sleeps == [2.0, 4.0, 6.0]
    with pytest.raises(ConnectionError):
        c.report_global_step(1)
    c.close()


# ---- the transport ----------------------------------------------------------


class _SlowServicer(tcomm.MasterServicerBase):
    """`get` of "slow" blocks until released; everything else echoes."""

    def __init__(self):
        self.release = threading.Event()

    def get(self, env):
        if env.payload == "slow":
            self.release.wait(10)
        return tcomm.ReplyEnvelope(payload=(env.node_id, env.payload))

    def report(self, env):
        if env.payload == "boom":
            raise RuntimeError("boom")
        return tcomm.ReplyEnvelope(payload=len(env.payload or b""))


def _server(servicer=None):
    servicer = servicer or _SlowServicer()
    port = tmsg.find_free_port()
    server = tcomm.build_master_server(servicer, port)
    server.start()
    return servicer, server, f"127.0.0.1:{port}"


def test_transport_serves_calls_side_by_side():
    """A blocked call on one thread does not hold up the calls of other
    threads sharing the stub (a rendezvous poll against a heartbeat);
    every reply reaches the thread that asked."""
    import sys

    servicer, server, addr = _server()
    stub = tcomm.MasterStub(addr, timeout=10)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)      # interleave the threads' frames
    try:
        slow = threading.Thread(target=stub.get, args=("slow",))
        slow.start()
        time.sleep(0.05)
        results = {}
        n = 16

        def ask(i):
            results[i] = [stub.get(f"{i}-{k}", node_id=i).payload
                          for k in range(20)]

        threads = [threading.Thread(target=ask, args=(i,)) for i in range(n)]
        t0 = time.monotonic()
        for th in threads:
            th.start()
        for th in threads:
            th.join(10)
        assert not any(th.is_alive() for th in threads)
        assert time.monotonic() - t0 < 10 and slow.is_alive()
        for i in range(n):
            assert results[i] == [(i, f"{i}-{k}") for k in range(20)]
        sys.setswitchinterval(switch)
        servicer.release.set()
        slow.join(5)
        assert not slow.is_alive()
        # a handler that raises answers success=False, the server lives on
        bad = stub.report("boom")
        assert not bad.success and bad.reason == "boom"
        assert stub.report(b"abc").payload == 3
    finally:
        sys.setswitchinterval(switch)
        servicer.release.set()
        stub.close()
        server.stop()


def test_transport_caps_frames_and_times_out(monkeypatch):
    monkeypatch.setattr(tcomm, "MAX_MESSAGE_BYTES", 1024)
    servicer, server, addr = _server()
    stub = tcomm.MasterStub(addr, timeout=0.2)
    try:
        with pytest.raises(tcomm.RpcError) as e:
            stub.report(b"x" * 2048)
        assert e.value.code() == "RESOURCE_EXHAUSTED"
        assert stub.report(b"x" * 100).payload == 100
        with pytest.raises(tcomm.RpcError) as e:
            stub.get("slow")
        assert e.value.code() == "DEADLINE_EXCEEDED"
        servicer.release.set()
        assert stub.get("fast").payload == (-1, "fast")
    finally:
        servicer.release.set()
        stub.close()
        server.stop()


def test_transport_restart_rebinds_the_port_and_leaves_no_threads():
    """stop() closes the listener and every connection: a master on the
    same port binds at once, the stub's idle connection to the old one
    is dropped before its next call (which reaches the new servicer),
    and no server thread is left."""
    before = set(threading.enumerate())
    s1, server, addr = _server()
    port = int(addr.rsplit(":", 1)[1])
    stub = tcomm.MasterStub(addr, timeout=5)
    assert stub.get("a").payload == (-1, "a")
    server.stop()
    blocker = tcomm.build_master_server(s1, port)   # free again at once
    with pytest.raises(RuntimeError, match="cannot bind"):
        tcomm.build_master_server(s1, port)
    blocker.stop()

    class Other(_SlowServicer):
        def get(self, env):
            return tcomm.ReplyEnvelope(payload="new")

    server2 = tcomm.build_master_server(Other(), port)
    server2.start()
    assert stub.get("a").payload == "new"
    server2.stop()
    stub.close()
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline:
        left = [t for t in set(threading.enumerate()) - before
                if t.is_alive()]
        if not left:
            break
        time.sleep(0.02)
    assert not left


def test_distributed_master_and_role_pools_raise():
    from dlrover_tpu_torch.master.master import DistributedJobMaster
    from dlrover_tpu_torch.master.node_manager import JobNodeManager

    with pytest.raises(NotImplementedError, match="item 13"):
        DistributedJobMaster()
    with pytest.raises(NotImplementedError, match="item 13"):
        JobNodeManager().pool("worker")


# ---- the serving replica pool through the master ----------------------------


def test_replica_pool_registers_through_the_master():
    """ReplicaPool(kv=MasterClient): the registration and heartbeat
    records read back through the port's master equal those of a pool
    over the in-process KVStoreService (ts aside)."""
    from dlrover_tpu_torch.master.kv_store import KVStoreService
    from dlrover_tpu_torch.models import llama as tllama
    from dlrover_tpu_torch.serving import engine as teng
    from dlrover_tpu_torch.serving import replica as trep
    from dlrover_tpu_torch.serving import scheduler as tsched

    cfg = tllama.LlamaConfig.tiny(dtype=torch.float32)
    params = tllama.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    prompt = np.random.default_rng(2).integers(1, 250, size=13).tolist()

    def run(kv, read):
        eng = teng.ContinuousBatcher(cfg, params, device="cpu", n_slots=2,
                                     max_len=64, max_new_tokens=4, chunk=2,
                                     pad_id=-1, prefix_cache_rows=4,
                                     prefix_block=4)
        sched = tsched.RequestScheduler(
            eng, tsched.SloConfig(default_deadline_s=600.0),
            clock=lambda: 0.0)
        pool = trep.ReplicaPool(kv=kv, clock=lambda: 0.0)
        rep = trep.InferenceReplica("replica-0", sched)
        pool.add(rep)
        first = json.loads(read(trep.REPLICA_KEY_PREFIX + "replica-0"))
        sched.submit(prompt, max_new=3)
        while sched.pump():
            pass
        pool.check_replicas()
        beat = json.loads(read(rep.kv_key))
        pool.stop()
        return [{k: (v > 0 if k == "step_latency_s" else v)
                 for k, v in d.items() if k != "ts"} for d in (first, beat)]

    store = KVStoreService()
    local = run(store, store.get)
    with _master(PORT) as m, _clients(PORT, m) as (c,):
        remote = run(c, c.kv_get)
        assert m.servicer.kv_store.get(trep.REPLICA_KEY_PREFIX + "replica-0")
    assert remote == local
    assert len(remote[1]["prefix_digests"]) == 1


# ---- the Trainer, the saver and the hanging detector ------------------------


def _tiny_trainer_parts(seed=0):
    from dlrover_tpu_torch.models import llama as tllama
    from dlrover_tpu_torch.trainer.elastic.trainer import ElasticTrainer

    cfg = tllama.LlamaConfig.tiny(dtype=torch.float32)

    def opt(params):
        return torch.optim.AdamW(params, lr=1e-2, weight_decay=0.0)

    et = ElasticTrainer(
        lambda g: tllama.init_params(cfg, g, device="cpu",
                                     dtype=torch.float32),
        lambda p, b: tllama.loss_fn(cfg, p, b), opt,
        global_batch_size=4, max_per_replica_batch=2, device="cpu")
    return cfg, et, et.init_state(torch.Generator().manual_seed(seed))


def _wait(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.01)
    return pred()


def test_trainer_reports_model_info_and_steps_as_jax(tmp_path, monkeypatch):
    """The port's Trainer(master_client=...) on a tiny f32 Llama: the
    model-info report carries num_params, batch_size_per_host and
    seq_len as JAX's `_report_model_info` computes them on the same
    config and batch (flops 0.0 and no program stats, as JAX reports
    for a trainer without `profile_program`); every logging window's
    global step and host time reach the speed monitor."""
    import jax
    import jax.numpy as jnp

    from dlrover_tpu.models import llama as jllama
    from dlrover_tpu.trainer.trainer import Trainer as JTrainer
    from dlrover_tpu.trainer.trainer import TrainingArguments as JArgs
    from dlrover_tpu_torch.trainer.trainer import Trainer, TrainingArguments

    monkeypatch.setenv("DLROVER_TPU_RUNTIME_METRICS_PATH",
                       str(tmp_path / "runtime.json"))
    monkeypatch.setenv("DLROVER_TPU_CHIP_METRICS_PATH",
                       str(tmp_path / "chip.json"))
    tokens = np.random.default_rng(0).integers(0, 256, size=(4, 33))
    batch = {"tokens": tokens}

    class Recorder:
        def __init__(self):
            self.calls = []

        def report_model_info(self, **kw):
            self.calls.append(kw)

    rec = Recorder()
    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32)
    # shapes are all the report reads: trace the init, compute nothing
    jparams = jax.eval_shape(
        lambda: jllama.init_params(jcfg, jax.random.PRNGKey(0)))
    jt = JTrainer(object(), JArgs(resume=False), master_client=rec)
    jt._report_model_info({"params": jparams}, batch)
    assert _wait(lambda: rec.calls)
    want = rec.calls[0]

    cfg, et, state = _tiny_trainer_parts()
    with _master(PORT) as m, _clients(PORT, m) as (c,):
        tr = Trainer(et, TrainingArguments(max_steps=4, logging_steps=2,
                                           resume=False),
                     train_data=[batch] * 4, master_client=c)
        tr.train(state)
        coll = m.servicer.metric_collector
        assert _wait(lambda: coll._model is not None)
        model = coll._model
        sm = m.servicer.speed_monitor
        assert sm.global_step == 4 and sm.all_worker_steps() == {0: 4}
        assert sm.worker_compute_samples()[0][0] > 0
    assert want == dict(num_params=model.num_params, flops_per_step=0.0,
                        batch_size_per_host=model.batch_size,
                        seq_len=model.seq_len, program_stats="")
    assert model.num_params == sum(
        x.numel() for x in torch.utils._pytree.tree_leaves(state["params"]))
    assert (model.batch_size, model.seq_len) == (4, 33)


def test_trainer_resume_over_the_loader_and_saver_report(tmp_path,
                                                         monkeypatch):
    """Save to memory at step 3 of 6 with the saver reporting to the
    master (the DISK save at the end commits and reports step 6); a new
    Trainer resumes from memory over a new ElasticDataLoader and feeds
    the same batches from step 4 as the uninterrupted run."""
    from dlrover_tpu_torch.agent.ckpt_saver import AsyncCheckpointSaver
    from dlrover_tpu_torch.common.multi_process import LocalSocketServer
    from dlrover_tpu_torch.trainer.elastic.data import ElasticDataLoader
    from dlrover_tpu_torch.trainer.trainer import (
        Trainer,
        TrainerCallback,
        TrainingArguments,
    )

    job = f"torch-master-resume-{os.getpid()}"
    monkeypatch.setenv("DLROVER_TPU_SHM_DIR", str(tmp_path))
    monkeypatch.setenv("DLROVER_TPU_JOB_NAME", job)
    monkeypatch.setenv("DLROVER_TPU_RUNTIME_METRICS_PATH",
                       str(tmp_path / "runtime.json"))
    monkeypatch.setenv("DLROVER_TPU_CHIP_METRICS_PATH",
                       str(tmp_path / "chip.json"))
    data = np.random.default_rng(1).integers(0, 256, size=(24, 17))

    class Rows:
        def __init__(self):
            self.seen = []

        def __len__(self):
            return len(data)

        def __getitem__(self, i):
            self.seen.append(i)
            return {"tokens": data[i]}

    class Losses(TrainerCallback):
        def __init__(self):
            self.losses = []

        def on_log(self, trainer, state, logs):
            self.losses.append(logs["loss"])

    def run(steps, save, resume, seed):
        rows, rec = Rows(), Losses()
        loader = ElasticDataLoader(rows, batch_size=4)
        _, et, state = _tiny_trainer_parts(seed)
        trained = []
        step = et.step

        def recorded(st, batch):
            trained.append(batch["tokens"][:, 0].tolist())
            return step(st, batch)

        et.step = recorded
        tr = Trainer(et, TrainingArguments(
            output_dir=str(tmp_path), max_steps=steps, logging_steps=1,
            save_steps=save, save_storage="memory", resume=resume),
            train_data=loader, callbacks=[rec], master_client=c)
        tr.train(state)
        if tr.checkpointer is not None:
            tr.checkpointer.close()
        return rows.seen, trained, rec.losses

    agent = LocalSocketServer(job)
    agent.start()
    with _master(PORT) as m, _clients(PORT, m) as (c,):
        saver = AsyncCheckpointSaver(job_name=job, master_client=c)
        saver.start()
        try:
            full = run(6, 0, False, 0)
            first = run(3, 3, False, 0)
            path = str(tmp_path / "checkpoints")
            assert _wait(lambda: c.get_ckpt_latest_step(path) == 3, 30)
            resumed = run(6, 0, True, 5)
        finally:
            saver.stop()
            saver.join(timeout=10)
            saver.shm_handler.close()
            agent.stop()
        assert m.servicer.speed_monitor.global_step == 6
    assert first[0] == full[0][:12] and first[1:] == (full[1][:3],
                                                       full[2][:3])
    # the resumed Trainer skips 3 batches of the loader (JAX's rule for
    # a loader without load_state_dict), then trains on the same
    # batches as the uninterrupted run, with the same losses
    assert resumed[0] == full[0]
    assert resumed[1] == full[1][3:] and resumed[2] == full[2][3:]


def test_hanging_detector_reports_the_hang_to_the_master():
    """No step within the timeout: one failure report reaches each
    package's master, with the same fields (JAX's HangingDetector
    against the port's, each through its own client)."""
    from dlrover_tpu.utils.hanging_detector import HangingDetector as JHD
    from dlrover_tpu_torch.utils.hanging_detector import HangingDetector

    def scenario(side):
        cls = JHD if side is JAX else HangingDetector
        with _master(side) as m, _clients(side, m) as (c,):
            det = cls(timeout=0.05, check_interval=0.01, master_client=c)
            det.start()
            det.record_step(3)
            mon = m.servicer.error_monitor
            ok = _wait(lambda: bool(mon.recent()))
            time.sleep(0.1)          # still stalled: no second report
            det.stop()
            return ok, [(r.node_id, r.node_type, r.level, r.error_data,
                         r.restart_count) for r in mon.recent()]

    j, t = both(scenario)
    assert t == j
    assert t[0] and t[1] == [(0, "worker", "process", "hang: no step for 0s",
                              0)]
