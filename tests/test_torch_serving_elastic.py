"""Live elastic resize of the port's tensor-parallel serving replica
(dlrover_tpu_torch/serving/elastic.py with the engine, scheduler and
pool hooks), the oracles of JAX tests/test_serving_elastic.py.

A replica that loses a chip mid-decode re-forms live at the largest
valid smaller tp and completes every request with the streams of a run
that never lost it (greedy and sampled: the sampling generator's state
rides the replay), leaking no page; when the chip returns it grows
back to the constructed tp; a shrunk replica is degraded, never
ejected. Every fault comes from the port's seeded
serving/chaos.FaultInjector. The slice is
DLROVER_TPU_TORCH_FORCE_DEVICE_COUNT=8 CPU shards for this module (the
JAX package's tests force eight host devices).
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from dlrover_tpu.models import llama as jllama
from dlrover_tpu_torch import _device
from dlrover_tpu_torch.models import llama as tllama
from dlrover_tpu_torch.serving import elastic
from dlrover_tpu_torch.serving.chaos import ChipLost, FaultInjector
from dlrover_tpu_torch.serving.engine import ContinuousBatcher
from dlrover_tpu_torch.serving.failover import CLOSED
from dlrover_tpu_torch.serving.metrics import ServingMetrics
from dlrover_tpu_torch.serving.replica import InferenceReplica, ReplicaPool
from dlrover_tpu_torch.serving.scheduler import (
    RequestScheduler,
    RequestState,
    SloConfig,
)

FORCE = _device.FORCE_DEVICE_COUNT_ENV


@pytest.fixture(scope="module", autouse=True)
def eight_cpu_shards():
    """Eight virtual CPU devices and one intra-op thread, restored
    after the module."""
    old = os.environ.get(FORCE)
    os.environ[FORCE] = "8"
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    if old is None:
        os.environ.pop(FORCE, None)
    else:
        os.environ[FORCE] = old


def _tiny(**kw):
    """The tiny f32 config, params from the JAX package's init (seed 0)
    carried across as numpy."""
    jcfg = jllama.LlamaConfig.tiny(**kw)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    tcfg = tllama.LlamaConfig.tiny(dtype=torch.float32, **kw)
    return tcfg, tllama.params_from_numpy(tcfg, tree, device="cpu",
                                          dtype=torch.float32)


@pytest.fixture(scope="module")
def model():
    return _tiny()


@pytest.fixture(scope="module")
def model4():
    # 4 KV heads so tp=4 divides them (tiny() has 2)
    return _tiny(n_kv_heads=4)


def _prompts(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 250, size=n).tolist() for n in lengths]


def _engine(cfg, params, **kw):
    # chunk small against max_new, so a drain spans several steps for a
    # mid-decode fault to land on
    kw.setdefault("n_slots", 3)
    kw.setdefault("max_len", 64)
    kw.setdefault("max_new_tokens", 12)
    kw.setdefault("chunk", 2)
    kw.setdefault("pad_id", -1)
    return ContinuousBatcher(cfg, params, device="cpu", **kw)


def _oracle(cfg, params, prompts, **kw):
    return [list(map(int, o))
            for o in _engine(cfg, params, **kw).generate_all(prompts)]


def _drive(eng, prompts, max_iters=400):
    """Submit and run to completion, resizing live on chip loss:
    (continuations in submission order, resize reports)."""
    idxs = [eng.submit(pr) for pr in prompts]
    reports = []
    for _ in range(max_iters):
        if not eng.has_work():
            break
        try:
            eng.step()
        except ChipLost:
            reports.append(eng.resize(eng.surviving_chips()))
    else:
        raise AssertionError("engine did not drain")
    return [list(map(int, eng._requests[i].out)) for i in idxs], reports


def _pump_all(scheds, max_iters=600):
    scheds = scheds if isinstance(scheds, list) else [scheds]
    for _ in range(max_iters):
        if not any(s.pump() for s in scheds):
            return
    raise AssertionError("scheduler did not drain")


SHRINK_CASES = [
    # layout, temperature, feature, async_depth, seed (JAX's sweep)
    ("dense", 0.0, "plain", 0, 11),
    ("dense", 0.0, "spec", 1, 12),
    ("dense", 0.8, "prefix", 0, 13),
    ("dense", 0.8, "plain", 1, 14),
    ("paged", 0.0, "prefix", 1, 15),
    ("paged", 0.0, "spec", 0, 16),
    ("paged", 0.8, "plain", 0, 17),
    ("paged", 0.8, "prefix", 1, 18),
]


def _case_kw(layout, temperature, feature, async_depth):
    kw = dict(async_depth=async_depth)
    if layout == "paged":
        kw.update(kv_layout="paged")
    if temperature > 0.0:
        kw.update(temperature=temperature, top_k=5)
    if feature == "prefix":
        kw.update(prefix_cache_rows=4, prefix_block=8)
    if feature == "spec":
        kw.update(spec_draft_len=3)
    return kw


class TestShrinkParity:
    @pytest.mark.parametrize(
        "layout,temperature,feature,async_depth,seed", SHRINK_CASES)
    def test_tp2_to_tp1_mid_decode(self, model, layout, temperature,
                                   feature, async_depth, seed):
        cfg, params = model
        kw = _case_kw(layout, temperature, feature, async_depth)
        prompts = _prompts((6, 9, 13), seed=seed)
        want = _oracle(cfg, params, prompts, mesh_spec=2, **kw)

        fi = FaultInjector(seed=seed)
        step = fi.lose_chip("e", 1, between=(1, 4))
        eng = _engine(cfg, params, mesh_spec=2, chaos=fi, chaos_tag="e",
                      **kw)
        got, reports = _drive(eng, prompts)

        assert fi.fired == [("engine", "e", step)]
        assert [r.direction for r in reports] == ["shrink"]
        assert (reports[0].old_tp, reports[0].new_tp) == (2, 1)
        assert eng.mesh_tp == 1 and eng.mesh is None
        assert got == want, f"parity broke after shrink @step {step}"
        if layout == "paged":
            eng.allocator.check()
        stats = eng.elastic_stats()
        assert stats["resize_shrink"] == 1.0
        assert stats["tp"] == 1.0 and stats["full_tp"] == 2.0
        assert stats["resize_downtime_ms"] > 0.0

    @pytest.mark.parametrize("layout,temperature",
                             [("paged", 0.0), ("dense", 0.8)])
    def test_tp4_to_tp2_mid_decode(self, model4, layout, temperature):
        """Losing 1 of 4 chips leaves 3; 3 does not divide 4 KV heads,
        so the slice re-forms at 2."""
        cfg, params = model4
        kw = _case_kw(layout, temperature, "plain", 0)
        prompts = _prompts((6, 9, 13), seed=21)
        want = _oracle(cfg, params, prompts, mesh_spec=4, **kw)

        fi = FaultInjector(seed=21)
        fi.lose_chip("e", 1, at_step=2)
        eng = _engine(cfg, params, mesh_spec=4, chaos=fi, chaos_tag="e",
                      **kw)
        got, reports = _drive(eng, prompts)
        assert (reports[0].old_tp, reports[0].new_tp) == (4, 2)
        assert eng.mesh_tp == 2
        assert len(eng.params["layers"]["wq"].shards) == 2
        assert got == want
        if layout == "paged":
            eng.allocator.check()

    def test_double_loss_shrinks_again(self, model4):
        cfg, params = model4
        prompts = _prompts((6, 9), seed=31)
        want = _oracle(cfg, params, prompts, mesh_spec=4)
        fi = FaultInjector(seed=31)
        fi.lose_chip("e", 1, at_step=1)
        fi.lose_chip("e", 1, at_step=3)
        eng = _engine(cfg, params, mesh_spec=4, chaos=fi, chaos_tag="e")
        got, reports = _drive(eng, prompts)
        assert [r.direction for r in reports] == ["shrink", "noop"]
        assert got == want

    def test_tp2_equals_tp1_after_every_resize(self, model):
        """The unresized tp=2 streams equal tp=1's, so every oracle above
        is also the one-device engine's."""
        cfg, params = model
        prompts = _prompts((6, 9, 13), seed=11)
        assert (_oracle(cfg, params, prompts, mesh_spec=2)
                == _oracle(cfg, params, prompts))


class TestGrowBack:
    def test_tp2_round_trip(self, model):
        cfg, params = model
        batch1 = _prompts((6, 9, 13), seed=41)
        batch2 = _prompts((7, 11), seed=42)
        oracle = _engine(cfg, params, mesh_spec=2)
        want1 = [list(map(int, o)) for o in oracle.generate_all(batch1)]
        want2 = [list(map(int, o)) for o in oracle.generate_all(batch2)]

        fi = FaultInjector(seed=41)
        fi.lose_chip("e", 1, at_step=2)
        eng = _engine(cfg, params, mesh_spec=2, chaos=fi, chaos_tag="e",
                      kv_layout="paged", page_size=8, n_pages=32)
        got1, reports = _drive(eng, batch1)
        assert eng.mesh_tp == 1
        assert got1 == want1

        fi.restore_chip("e")
        report = eng.resize()
        assert report.direction == "grow"
        assert (report.old_tp, report.new_tp) == (1, 2)
        assert eng.mesh_tp == 2 and eng.mesh is not None
        assert isinstance(eng.page_pool, list) and len(eng.page_pool) == 2
        got2, more = _drive(eng, batch2)
        assert more == [] and got2 == want2
        eng.allocator.check()
        stats = eng.elastic_stats()
        assert stats["resize_shrink"] == 1.0
        assert stats["resize_grow"] == 1.0

    def test_tp4_round_trip(self, model4):
        cfg, params = model4
        batch1 = _prompts((6, 9), seed=43)
        batch2 = _prompts((8,), seed=44)
        oracle = _engine(cfg, params, mesh_spec=4)
        want1 = [list(map(int, o)) for o in oracle.generate_all(batch1)]
        want2 = [list(map(int, o)) for o in oracle.generate_all(batch2)]

        fi = FaultInjector(seed=43)
        fi.lose_chip("e", 2, at_step=1)
        eng = _engine(cfg, params, mesh_spec=4, chaos=fi, chaos_tag="e")
        got1, reports = _drive(eng, batch1)
        assert (reports[0].old_tp, reports[0].new_tp) == (4, 2)
        assert got1 == want1

        fi.restore_chip("e")
        report = eng.resize()
        assert (report.old_tp, report.new_tp) == (2, 4)
        got2, _ = _drive(eng, batch2)
        assert got2 == want2

    def test_grow_never_exceeds_constructed_tp(self, model):
        cfg, params = model
        eng = _engine(cfg, params, mesh_spec=2)
        report = eng.resize(8)
        assert report.direction == "noop"
        assert eng.mesh_tp == 2

    def test_resize_keeps_tier_entries_and_adapter_slots(self, model):
        """What a resize keeps: the host tier's entries (stored in the
        one-device layout) and the adapter id -> slot map."""
        from dlrover_tpu_torch.serving.adapters import AdapterRegistry

        cfg, params = model
        reg = AdapterRegistry(cfg, max_rank=4)
        rng = np.random.default_rng(3)
        sd = {"layers": {}}
        for t, (d_in, d_out) in (("wq", (64, 64)), ("wv", (64, 32))):
            sd["layers"][f"{t}_lora_a"] = rng.standard_normal(
                (cfg.n_layers, d_in, 2)).astype(np.float32) * 0.1
            sd["layers"][f"{t}_lora_b"] = rng.standard_normal(
                (cfg.n_layers, 2, d_out)).astype(np.float32) * 0.1
        reg.register("a", sd, alpha=4.0)
        prompts = _prompts((20, 24), seed=5)
        eng = _engine(cfg, params, mesh_spec=2, kv_layout="paged",
                      prefix_cache_rows=1, prefix_block=8,
                      kv_tier_bytes=1 << 20, adapter_registry=reg)
        base = ContinuousBatcher(cfg, params, device="cpu", n_slots=3,
                                 max_len=64, max_new_tokens=12, chunk=2,
                                 pad_id=-1, adapter_registry=reg)
        for e in (eng, base):
            e.submit(prompts[0], adapter_id="a")
            e.submit(prompts[1])
        want = [list(map(int, o)) for o in base.generate_all([])]
        got = [list(map(int, o)) for o in eng.generate_all([])]
        assert got == want
        slot = eng._adapter_cache.slot_of("a")
        entries = eng.kv_tier_stats()
        eng.resize(1)
        assert eng._adapter_cache.slot_of("a") == slot
        assert eng.kv_tier_stats()["entries"] == entries["entries"]
        eng.resize(2)
        assert eng._adapter_cache.slot_of("a") == slot


class TestSchedulerChipLoss:
    def _sched(self, cfg, params, fi, tag="r0", **kw):
        eng = _engine(cfg, params, mesh_spec=2, chaos=fi, chaos_tag=tag,
                      **kw)
        return RequestScheduler(eng, SloConfig(max_new_tokens=12))

    def test_pump_resizes_and_completes_every_request(self, model):
        cfg, params = model
        prompts = _prompts((6, 9, 13), seed=51)
        want = _oracle(cfg, params, prompts, mesh_spec=2)

        fi = FaultInjector(seed=51)
        step = fi.lose_chip("r0", 1, between=(1, 4))
        sched = self._sched(cfg, params, fi)
        reqs = [sched.submit(p, max_new=12) for p in prompts]
        _pump_all(sched)

        assert fi.fired == [("engine", "r0", step)]
        assert not sched.crashed
        assert [r.state for r in reqs] == [RequestState.DONE] * 3
        assert [list(map(int, r.tokens)) for r in reqs] == want
        assert sched.journal._keys == {}
        assert sched.engine.mesh_tp == 1
        assert sched.metrics.resize_total == {"shrink": 1, "grow": 0}

    def test_elastic_resize_off_falls_back_to_crash_path(self, model):
        cfg, params = model
        fi = FaultInjector(seed=52)
        fi.lose_chip("r0", 1, at_step=1)
        sched = self._sched(cfg, params, fi)
        sched.elastic_resize = False
        tickets = []
        sched.on_failure = lambda s, ts, exc: tickets.extend(ts)
        reqs = [sched.submit(p, max_new=12) for p in _prompts((6, 9))]
        for _ in range(50):
            if not sched.pump():
                break
        assert sched.crashed
        assert len(tickets) == len(reqs)
        assert sched.engine.mesh_tp == 2

    def test_total_chip_loss_falls_back_to_crash_path(self, model):
        cfg, params = model
        fi = FaultInjector(seed=54)
        fi.lose_chip("r0", 2, at_step=1)
        sched = self._sched(cfg, params, fi)
        tickets = []
        sched.on_failure = lambda s, ts, exc: tickets.extend(ts)
        sched.submit(_prompts((6,), 54)[0], max_new=12)
        for _ in range(50):
            if not sched.pump():
                break
        assert sched.crashed
        assert len(tickets) == 1

    def test_resize_engine_entry_point(self, model):
        cfg, params = model
        sched = self._sched(cfg, params, FaultInjector(seed=53))
        report = sched.resize_engine(1)
        assert (report.old_tp, report.new_tp) == (2, 1)
        assert sched.resize_engine(2).direction == "grow"


class TestDegradedPool:
    def test_shrunk_replica_degraded_not_ejected(self, model):
        cfg, params = model
        fi = FaultInjector(seed=61)
        fi.lose_chip("replica-0", 1, at_step=1)
        metrics = ServingMetrics()
        pool = ReplicaPool(metrics=metrics)
        eng = _engine(cfg, params, mesh_spec=2, chaos=fi,
                      chaos_tag="replica-0")
        sched = RequestScheduler(eng, SloConfig(max_new_tokens=12),
                                 metrics=metrics)
        rep = InferenceReplica("replica-0", sched, chaos=fi)
        pool.add(rep)
        try:
            reqs = [pool.submit(p, max_new=12)
                    for p in _prompts((6, 9), 61)]
            _pump_all(sched)
            assert [r.state for r in reqs] == [RequestState.DONE] * 2
            assert eng.mesh_tp == 1

            pool.check_replicas()
            breaker = pool.breakers["replica-0"]
            assert rep.degraded and rep.healthy
            assert breaker.state == CLOSED and breaker.strikes == 0
            assert pool.healthy_replicas() == [rep]
            assert metrics.replica_degradations == 1

            fi.restore_chip("replica-0")
            pool.check_replicas()
            assert not rep.degraded
            assert eng.mesh_tp == 2
            assert breaker.state == CLOSED and breaker.strikes == 0
        finally:
            pool.stop()

    def test_pool_check_resizes_without_a_pump_in_flight(self, model):
        cfg, params = model
        fi = FaultInjector(seed=62)
        eng = _engine(cfg, params, mesh_spec=2, chaos=fi,
                      chaos_tag="replica-0")
        sched = RequestScheduler(eng, SloConfig(max_new_tokens=12))
        rep = InferenceReplica("replica-0", sched, chaos=fi)
        pool = ReplicaPool()
        pool.add(rep)
        try:
            fi.lose_chip("replica-0", 1, at_step=0)
            with pytest.raises(ChipLost):
                fi.on_engine_step("replica-0", 0)
            pool.check_replicas()
            assert rep.degraded and rep.healthy
            assert eng.mesh_tp == 1
            req = sched.submit(_prompts((6,), 62)[0], max_new=12)
            _pump_all(sched)
            assert req.state is RequestState.DONE
        finally:
            pool.stop()

    def test_degraded_rides_health_meta(self, model):
        cfg, params = model
        eng = _engine(cfg, params, mesh_spec=2)
        rep = InferenceReplica("r", RequestScheduler(eng, SloConfig()))
        meta = json.loads(rep._meta())
        assert meta["mesh_shape"] == {"tp": 2} and meta["n_chips"] == 2
        rep.degraded = True
        assert json.loads(rep._meta())["degraded"] is True


def test_largest_serving_tp_lives_in_parallel_mesh():
    from dlrover_tpu_torch.parallel import mesh

    assert elastic.largest_serving_tp is mesh.largest_serving_tp
    assert elastic.largest_serving_tp(3, n_kv_heads=4, n_devices=8) == 2
