"""KV checksums, the preflight probe, straggler detection and fault
injection (dlrover_tpu_torch/serving/health.py, chaos.py, elastic.py and
the engine's hooks) against the JAX package, on the tiny f32 Llama.

- `kv_checksum` gives JAX's digest for the same bits: the same numpy
  dicts, and a bf16 torch tensor against the ml_dtypes array with the
  same 16-bit words; it changes with any byte, name, dtype or shape.
- The preflight probe stamps its golden digest once and reproduces it.
- `StragglerDetector` units (JAX test_serving_health.py's), each also
  run through the JAX detector.
- Corrupt in transit (JAX test_serving_health.py's sweeps): a byte
  flipped in a tier entry, a swapped run or a host handoff package is
  quarantined and the request replays; streams equal the no-fault run,
  and the quarantine counts and fault logs equal the JAX engine's.
- A `FaultInjector` with one seed draws and fires as JAX's does.
- `device_health` / `surviving_chips` under `lose_chip` and `resize()`
  at one card (the "noop" report) equal the JAX tp=1 engine's.
- The new engine knobs validate as JAX's do, and the port takes every
  keyword of the JAX engine's (`mesh_spec` at tp=1 since F7 closed;
  its matrix is in test_torch_mesh_spec.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from dlrover_tpu.models import llama as jllama
from dlrover_tpu.serving import chaos as jchaos
from dlrover_tpu.serving import handoff as jhandoff
from dlrover_tpu.serving import health as jhealth
from dlrover_tpu.serving.engine import ContinuousBatcher as JaxBatcher
from dlrover_tpu_torch.models import llama as tllama
from dlrover_tpu_torch.serving import chaos as tchaos
from dlrover_tpu_torch.serving import engine as teng
from dlrover_tpu_torch.serving import handoff as thandoff
from dlrover_tpu_torch.serving import health as thealth


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's engine runs many small ops: one intra-op thread keeps
    them fast beside the other test workers (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype=jnp.float32)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    tcfg = tllama.LlamaConfig.tiny(dtype=torch.float32)
    tparams = tllama.params_from_numpy(tcfg, tree, device="cpu")
    return jcfg, jparams, tcfg, tparams


ENGINE = dict(n_slots=1, max_len=64, max_new_tokens=6, chunk=4)


def _prompts(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 250, size=int(n)).tolist() for n in lengths]


def _jax(model, **kw):
    return JaxBatcher(model[0], model[1], **{**ENGINE, **kw})


def _port(model, **kw):
    return teng.ContinuousBatcher(model[2], model[3], device="cpu",
                                  **{**ENGINE, **kw})


def _churn(cb, rounds):
    return [[int(t) for t in cb.generate_all([p])[0]]
            for prompts in rounds for p in prompts]


# ---------------------------------------------------------------------------
# checksum primitives


def _payload():
    rng = np.random.default_rng(5)
    return {
        "k": rng.standard_normal((2, 8, 4)).astype(np.float32),
        "v": rng.standard_normal((2, 8, 4)).astype(np.float32),
        "k_scale": rng.integers(-3, 3, (2, 8, 1)).astype(np.int8),
    }


def test_checksum_equals_jax_on_numpy_and_tensors():
    d = _payload()
    want = jhealth.kv_checksum(d)
    assert thealth.kv_checksum(d) == want
    as_tensors = {k: torch.from_numpy(v) for k, v in d.items()}
    assert thealth.kv_checksum(as_tensors) == want
    assert len(want) == 2 * thealth.CHECKSUM_BYTES


def test_bf16_tensor_hashes_as_its_bits():
    """A bf16 torch tensor hashes as "bfloat16" over its raw 16-bit
    words: the digest of the ml_dtypes array with the same bits."""
    rng = np.random.default_rng(3)
    t = torch.from_numpy(rng.standard_normal((3, 5, 2)).astype(np.float32))
    t = t.bfloat16()
    words = t.view(torch.int16).numpy()
    arr = words.view(ml_dtypes.bfloat16)
    assert str(arr.dtype) == "bfloat16"
    got = thealth.kv_checksum({"k": t})
    assert got == jhealth.kv_checksum({"k": arr})
    # never through f32: the f32 widening hashes differently
    assert got != thealth.kv_checksum({"k": t.float()})


def test_deterministic_and_order_insensitive():
    d = _payload()
    a = thealth.kv_checksum(d)
    assert a == thealth.kv_checksum(d)
    assert a == thealth.kv_checksum({k: d[k] for k in reversed(list(d))})


@pytest.mark.parametrize("torch_side", [False, True], ids=["numpy", "torch"])
def test_byte_name_dtype_shape_sensitive(torch_side):
    d = _payload()
    if torch_side:
        d = {k: torch.from_numpy(v) for k, v in d.items()}
    a = thealth.kv_checksum(d)
    flipped = dict(d)
    if torch_side:
        flipped["v"] = d["v"].clone()
        flipped["v"].view(-1).view(torch.uint8)[17] ^= 0x01
    else:
        flipped["v"] = d["v"].copy()
        flipped["v"].view(np.uint8).flat[17] ^= 0x01
    assert not thealth.verify_checksum(flipped, a)
    renamed = {("kk" if k == "k" else k): v for k, v in d.items()}
    assert thealth.kv_checksum(renamed) != a
    view = (lambda v: v.view(torch.int32)) if torch_side else (
        lambda v: v.view(np.uint32))
    recast = {k: (view(v) if k == "k" else v) for k, v in d.items()}
    assert thealth.kv_checksum(recast) != a
    reshaped = {k: (v.reshape(2, 4, 8) if k == "k" else v)
                for k, v in d.items()}
    assert thealth.kv_checksum(reshaped) != a
    assert not thealth.verify_checksum(d, "")


# ---------------------------------------------------------------------------
# preflight


@pytest.fixture
def golden_guard():
    with thealth._PREFLIGHT_LOCK:
        saved = thealth._PREFLIGHT_GOLDEN
    yield
    with thealth._PREFLIGHT_LOCK:
        thealth._PREFLIGHT_GOLDEN = saved


def test_preflight_stamps_then_reproduces(golden_guard):
    thealth.reset_preflight_golden()
    assert thealth.run_preflight("cpu") is True     # stamps
    assert thealth.run_preflight("cpu") is True     # reproduces
    with thealth._PREFLIGHT_LOCK:
        thealth._PREFLIGHT_GOLDEN = "not-the-real-digest"
    assert thealth.run_preflight("cpu") is False    # fails closed
    # the probe runs on the device it is given: the engine's
    assert thealth.preflight_digest("cpu") == thealth.preflight_digest("cpu")


# ---------------------------------------------------------------------------
# straggler detector units, each through both detectors


def _detectors(**kw):
    return thealth.StragglerDetector(**kw), jhealth.StragglerDetector(**kw)


def test_straggler_knob_validation():
    for mod in (thealth, jhealth):
        with pytest.raises(ValueError):
            mod.StragglerDetector(ratio=1.0)
        with pytest.raises(ValueError):
            mod.StragglerDetector(patience=0)


def test_straggler_single_replica_never_flags():
    for det in _detectors(ratio=2.0, patience=1):
        det.observe("only", 99.0)
        for _ in range(5):
            det.evaluate()
        assert det.level("only") == thealth.LEVEL_OK


def test_straggler_graded_escalation_and_counters():
    runs = []
    for det in _detectors(ratio=2.0, patience=2):
        levels = []
        for i in range(4):
            det.observe("fast-a", 0.01)
            det.observe("fast-b", 0.012)
            det.observe("slow", 0.5)
            det.evaluate()
            levels.append((det.level("slow"), det.is_straggler("slow"),
                           det.stragglers()))
        runs.append((levels, det.stats(), det.level("fast-a")))
    assert runs[0] == runs[1]
    levels, st, fast = runs[0]
    assert [lv for lv, _, _ in levels] == [
        thealth.LEVEL_SUSPECT, thealth.LEVEL_FENCED, thealth.LEVEL_FENCED,
        thealth.LEVEL_EJECT]
    assert not levels[0][1] and levels[1][2] == ["slow"]
    assert st["stragglers_flagged"] == 1.0
    assert st["stragglers_flagged_total"] == 1.0
    assert st["straggler_ejections_total"] == 1.0
    assert fast == thealth.LEVEL_OK


def test_straggler_recovery_floor_and_forget():
    for det in _detectors(ratio=2.0, patience=3):
        for _ in range(2):
            det.observe("a", 0.01)
            det.observe("c", 0.012)
            det.observe("b", 0.5)
            det.evaluate()
        assert det.level("b") == thealth.LEVEL_SUSPECT
        det.observe("b", 0.011)          # back under the fence
        det.evaluate()
        assert det.level("b") == thealth.LEVEL_OK and det.stragglers() == []
    for det in _detectors(ratio=2.0, patience=1, min_latency_s=1e-3):
        det.observe("a", 1e-6)
        det.observe("b", 1e-5)           # 10x, under the absolute floor
        det.evaluate()
        assert det.level("b") == thealth.LEVEL_OK
    for det in _detectors(ratio=2.0, patience=1):
        det.observe("a", 0.01)
        det.observe("b", 0.5)
        det.evaluate()
        det.forget("b")
        assert det.level("b") == thealth.LEVEL_OK
        det.evaluate()                   # one survivor: no fleet, no flag
        assert det.stragglers() == []


# ---------------------------------------------------------------------------
# the fault injector


def _injector_script(mod):
    fi = mod.FaultInjector(seed=5)
    drawn = [
        fi.crash_replica("a", between=(0, 10)),
        fi.fail_engine_step("b", between=(2, 8)),
        fi.lose_chip("c", 2, between=(1, 6)),
        fi.corrupt_kv("d", "tier", between=(0, 3)),
        fi.corrupt_kv("d", "handoff", at_step=1),
    ]
    raised = []
    for step in range(12):
        for tag in "abc":
            try:
                fi.on_engine_step(tag, step)
            except mod.ChaosError as exc:
                raised.append((tag, step, type(exc).__name__))
    flips = []
    for where in ("tier", "tier", "tier", "handoff", "handoff"):
        d = _payload()
        out = fi.maybe_corrupt("d", where, d)
        flips.append(sorted(k for k in d if not np.array_equal(
            np.asarray(d[k]).view(np.uint8), np.asarray(out[k]).view(np.uint8))))
    state = (fi.chips_lost("c"), fi.is_crashed("a"), fi.crashed_tags(),
             fi.probe_ok("a"), fi.probe_ok("b"))
    fi.revive("a")
    fi.restore_chip("c")
    state += (fi.is_crashed("a"), fi.chips_lost("c"))
    return drawn, raised, flips, state, fi.fired


def test_fault_injector_fires_as_jax_does():
    got = _injector_script(tchaos)
    assert got == _injector_script(jchaos)
    drawn, raised, flips, _, fired = got
    assert any(r[0] == "a" for r in raised) and flips.count([]) == 3
    assert len([f for f in fired if f[0] == "corrupt"]) == 2


def test_maybe_corrupt_flips_the_same_byte_of_a_tensor():
    """The port's hook also takes CPU tensors (the tier's page-locked
    host copies) and flips the byte it would flip in the same numpy
    payload."""
    fa, fb = tchaos.FaultInjector(seed=2), tchaos.FaultInjector(seed=2)
    for fi in (fa, fb):
        fi.corrupt_kv("t", "swap", at_step=0)
    d = _payload()
    out_np = fa.maybe_corrupt("t", "swap", d)
    out_t = fb.maybe_corrupt("t", "swap",
                             {k: torch.from_numpy(v) for k, v in d.items()})
    for k in d:
        assert np.array_equal(out_np[k].view(np.uint8),
                              out_t[k].numpy().view(np.uint8)), k
    assert fa.fired == fb.fired


def test_chaos_kv_wraps_a_client():
    class Store(dict):
        def set(self, k, v):
            self[k] = v

    fi = tchaos.FaultInjector()
    kv = tchaos.ChaosKV(Store(), fi, tag="kv")
    fi.flaky_kv("kv", fail_next=1)
    with pytest.raises(tchaos.KVFlake):
        kv.set("x", b"1")
    kv.set("x", b"1")
    assert kv.get("x") == b"1" and fi.fired == [("kv", "kv", 0)]


# ---------------------------------------------------------------------------
# engine hooks: crash at a step, chip loss, device health, resize


def test_engine_crash_and_chip_loss_fire_at_the_jax_steps(model):
    prompts = _prompts((9, 14, 6), seed=8)
    seen = []
    for mod, make in ((tchaos, _port), (jchaos, _jax)):
        fi = mod.FaultInjector(seed=1)
        fi.lose_chip("e", 1, at_step=2)
        fi.fail_engine_step("e", at_step=4)
        eng = make(model, n_slots=2, chaos=fi, chaos_tag="e")
        for p in prompts:
            eng.submit(p)
        raised, health = [], []
        while eng.has_work():
            try:
                eng.step()
            except mod.ChaosError as exc:
                raised.append(type(exc).__name__)
                health.append((eng.device_health(), eng.surviving_chips()))
        with pytest.raises(ValueError):
            eng.resize()                 # no chip left to re-form on
        report = dataclasses.asdict(eng.resize(1))
        outs = [[int(t) for t in o] for o in eng.generate_all([])]
        seen.append((raised, health, report, outs, fi.fired,
                     eng.elastic_stats()))
    assert seen[0] == seen[1]
    raised, health, report, _, _, _ = seen[0]
    assert raised == ["ChipLost", "ChaosError"]
    assert health[0] == ({"chips_total": 1, "chips_lost": 1,
                          "chips_up": 0}, 0)
    assert report["direction"] == "noop" and report["new_tp"] == 1


def test_resize_at_one_card_is_the_noop_report(model):
    eng, jeng = _port(model), _jax(model)
    assert eng.device_health() == jeng.device_health() == {
        "chips_total": 1, "chips_lost": 0, "chips_up": 1}
    for n in (1, 2, 8):
        assert (dataclasses.asdict(eng.resize(n))
                == dataclasses.asdict(jeng.resize(n)))
    assert dataclasses.asdict(eng.resize()) == {
        "old_tp": 1, "new_tp": 1, "replayed": 0, "downtime_ms": 0.0,
        "direction": "noop"}


def test_crashed_engine_serves_again_after_revive_and_reset(model):
    prompts = _prompts((9, 14), seed=4)
    fi = tchaos.FaultInjector()
    fi.crash_replica("r", at_step=1)
    eng = _port(model, chaos=fi, chaos_tag="r", kv_layout="paged")
    for p in prompts:
        eng.submit(p)
    eng.step()
    with pytest.raises(tchaos.ReplicaCrashed):
        eng.step()
    with pytest.raises(tchaos.ReplicaCrashed):
        eng.step()                         # a crashed tag keeps raising
    assert not fi.probe_ok("r")
    fi.revive("r")
    eng.reset()
    assert eng.allocator.used_pages == 0 and not eng.has_work()
    got = [[int(t) for t in o] for o in eng.generate_all(prompts)]
    want = [[int(t) for t in o] for o in
            _port(model, kv_layout="paged").generate_all(prompts)]
    assert got == want


# ---------------------------------------------------------------------------
# corrupt in transit: every checksum site, against the no-fault run


@pytest.mark.parametrize(
    "kw",
    [{}, {"kv_layout": "paged"},
     {"kv_layout": "paged", "temperature": 0.7, "seed": 11}],
    ids=["dense", "paged-greedy", "paged-sampled"],
)
def test_tier_corruption_parity(model, kw):
    prompts = _prompts((20, 21, 22), seed=31)
    rounds = [prompts, prompts]
    oracle = _churn(_port(model, prefix_cache_rows=1, **kw), rounds)
    runs = []
    for mod, make in ((tchaos, _port), (jchaos, _jax)):
        fi = mod.FaultInjector(seed=0)
        fi.corrupt_kv("eng#kvtier", where="tier", at_step=0)
        cb = make(model, prefix_cache_rows=1, kv_tier_bytes=32 << 20,
                  kv_checksums=1, chaos=fi, chaos_tag="eng", **kw)
        runs.append((cb, _churn(cb, rounds), fi))
    (cb, got, fi), (jcb, want, jfi) = runs
    assert got == oracle
    if "temperature" not in kw:
        assert got == want
    hs = cb.health_stats()
    assert hs == jcb.health_stats()
    assert hs["integrity_quarantines"] >= 1
    assert hs["integrity_checks"] >= hs["integrity_quarantines"]
    assert fi.fired == jfi.fired and fi.fired[0][0] == "corrupt"
    assert cb.kv_tier_stats() == jcb.kv_tier_stats()
    assert cb.kv_tier_stats()["quarantines"] >= 1
    if kw:
        cb.allocator.check()
        cb.reset()
        assert cb.allocator.used_pages == 0


def test_swap_corruption_parity(model):
    """A corrupted swapped-out victim is quarantined at its swap-in
    read, and the victim resumes by replay instead."""
    prompts = _prompts(np.random.default_rng(7).integers(12, 30, size=8),
                       seed=41)
    kw = dict(n_slots=3, max_new_tokens=12, kv_layout="paged",
              page_size=8, n_pages=14)
    oracle = [[int(t) for t in o]
              for o in _port(model, **kw).generate_all(prompts)]
    runs = []
    for mod, make in ((tchaos, _port), (jchaos, _jax)):
        fi = mod.FaultInjector(seed=0)
        fi.corrupt_kv("eng#kvtier", where="swap", at_step=0)
        cb = make(model, kv_tier_bytes=64 << 20, kv_checksums=1, chaos=fi,
                  chaos_tag="eng", **kw)
        outs = [[int(t) for t in o] for o in cb.generate_all(prompts)]
        runs.append((cb, outs, fi))
    (cb, got, fi), (jcb, want, jfi) = runs
    assert got == oracle == want
    assert cb.kv_tier_stats()["swap_outs"] > 0
    assert cb.kv_tier_stats() == jcb.kv_tier_stats()
    assert cb.health_stats() == jcb.health_stats()
    assert cb.health_stats()["integrity_quarantines"] >= 1
    assert fi.fired == jfi.fired
    assert (cb._swap_resumes, cb._swap_preemptions) == (
        jcb._swap_resumes, jcb._swap_preemptions)
    cb.allocator.check()
    cb.reset()
    assert cb.allocator.used_pages == 0


def _handoff_pair(make, mod, handoff, checksum, prompts, temperature):
    """A prefill + decode pair over the host transport, driven at the
    engine level. A stamped package is verified before the decode engine
    takes it (the coordinator's ingress); one that fails is quarantined
    and its request replays on the prefill engine under its seed."""
    fi = mod.FaultInjector(seed=0)
    fi.corrupt_kv("ho-prefill", where="handoff", at_step=0)
    kw = dict(n_slots=3, max_new_tokens=8, chunk=2, pad_id=-1,
              temperature=temperature, kv_layout="paged", kv_checksums=1,
              chaos=fi)
    pre = make(replica_role="prefill", seed=7, chaos_tag="ho-prefill", **kw)
    dec = make(replica_role="decode", seed=99, chaos_tag="ho-decode", **kw)
    owner = {pre.submit(p, max_new=6): i for i, p in enumerate(prompts)}
    adopted, quarantined = [], 0
    while pre.has_work() or dec.has_work():
        pre.step()
        for req in pre.take_prefilled():
            pkg = handoff.export_run(pre, req.idx, transport="host")
            pre.retire(req.idx)
            who = owner.pop(req.idx)
            if not checksum(pkg.data, pkg.checksum):
                quarantined += 1
                replay = pre.submit(pkg.prompt, max_new=pkg.max_new,
                                    prng_key=pkg.prng_key)
                owner[replay] = who
                continue
            dec.submit_adopted(pkg)
            adopted.append(who)
        dec.step()
    outs = [None] * len(prompts)
    for i, o in zip(adopted, dec.generate_all([])):
        outs[i] = [int(t) for t in o]
    return outs, quarantined, dec, fi


@pytest.mark.parametrize("temperature", [0.0, 0.9],
                         ids=["greedy", "sampled"])
def test_handoff_corruption_parity(model, temperature):
    prompts = _prompts((7, 11, 5, 9), seed=3)
    make = lambda **kw: teng.ContinuousBatcher(  # noqa: E731
        model[2], model[3], device="cpu", max_len=64, **kw)
    jmake = lambda **kw: JaxBatcher(  # noqa: E731
        model[0], model[1], max_len=64, **kw)
    got, q, dec, fi = _handoff_pair(make, tchaos, thandoff,
                                    thealth.verify_checksum, prompts,
                                    temperature)
    want, jq, jdec, jfi = _handoff_pair(jmake, jchaos, jhandoff,
                                        jhealth.verify_checksum, prompts,
                                        temperature)
    # the no-fault colocated run
    coloc = make(n_slots=3, max_new_tokens=8, chunk=2, pad_id=-1, seed=7,
                 temperature=temperature, kv_layout="paged")
    for p in prompts:
        coloc.submit(p, max_new=6)
    oracle = [[int(t) for t in o] for o in coloc.generate_all([])]
    assert got == oracle
    if temperature == 0.0:
        assert got == want
    assert q == jq == 1
    assert fi.fired == jfi.fired
    # the corrupted package never reached the decode engine
    assert dec.health_stats() == jdec.health_stats()
    assert dec.health_stats()["integrity_quarantines"] == 0
    assert dec.health_stats()["integrity_checks"] == len(prompts)
    assert dec.allocator.used_pages == 0


def test_counters_monotone_across_rounds(model):
    prompts = _prompts((20, 21, 22), seed=31)
    fi = tchaos.FaultInjector(seed=0)
    fi.corrupt_kv("eng#kvtier", where="tier", at_step=0)
    cb = _port(model, prefix_cache_rows=1, kv_tier_bytes=32 << 20,
               kv_checksums=1, chaos=fi, chaos_tag="eng")
    _churn(cb, [prompts])
    first = cb.health_stats()
    _churn(cb, [prompts])
    second = cb.health_stats()
    assert second["integrity_checks"] >= first["integrity_checks"]
    assert second["integrity_quarantines"] >= first["integrity_quarantines"]
    assert second["integrity_quarantines"] >= 1


# ---------------------------------------------------------------------------
# knobs


BAD_KNOBS = [
    dict(kv_checksums=2),
    dict(kv_tier_bytes=-1),
    dict(kv_tier_promote="sometimes"),
    dict(replica_role="router"),
]


@pytest.mark.parametrize("bad", BAD_KNOBS,
                         ids=[next(iter(b)) for b in BAD_KNOBS])
def test_knob_validation_as_jax(model, bad):
    with pytest.raises(ValueError) as port_err:
        _port(model, **bad)
    with pytest.raises(ValueError) as jax_err:
        _jax(model, **bad)
    assert str(port_err.value) == str(jax_err.value)


def test_every_jax_keyword_but_mesh_spec(model):
    """The port's engine takes every keyword of the JAX engine's,
    mesh_spec included since F7 closed (tp=1 serves on one card; the
    knob matrix is held to JAX's in test_torch_mesh_spec.py)."""
    import inspect

    jax_kw = set(inspect.signature(JaxBatcher.__init__).parameters)
    port_kw = set(inspect.signature(teng.ContinuousBatcher.__init__)
                  .parameters)
    assert jax_kw - port_kw == set()
    assert _port(model, mesh_spec=1).mesh_tp == 1
    eng = _port(model, kv_layout="paged", kv_tier_bytes=1 << 20,
                swap_to_host=False, kv_tier_promote="swap_only",
                kv_checksums=1, replica_role="decode",
                chaos=tchaos.FaultInjector(), chaos_tag="x")
    assert eng.health_stats() == {"kv_checksums": 1.0,
                                  "integrity_checks": 0.0,
                                  "integrity_quarantines": 0.0}
    assert _port(model).health_stats() == {}
