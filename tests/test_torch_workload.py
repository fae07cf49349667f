"""The port's copies of serving/workload.py and serving/metrics.py
against the JAX package's.

workload.py is pure numpy: for every config and seed of JAX
tests/test_serving_workload.py the port's `generate_trace` gives the
same events field for field (floats bit-equal), the same system prompt
and arrival counts, and its SessionBook chains the same prompts; the
JAX file's properties are checked on the port's traces.

metrics.py: the same sequence of ingestion calls renders the same
Prometheus exposition, line for line. Help texts that named the TPU
package's mechanisms are reworded in the port, so `# HELP` lines are
compared by metric name only; the tokens/s gauge reads the wall clock
(`time.monotonic`), so only its key is compared. The JAX file's tier
exposition needles (tests/test_serving_tiers.py TestTierMetrics) are
checked on the port's render."""

import dataclasses
import inspect

import numpy as np
import pytest

from dlrover_tpu.serving import metrics as jmetrics
from dlrover_tpu.serving import workload as jwork
from dlrover_tpu_torch.serving import metrics as tmetrics
from dlrover_tpu_torch.serving import workload as twork
from dlrover_tpu_torch.serving.scheduler import TIERS

# (seed, horizon_s, base_rate, extra knobs): every config JAX's
# test_serving_workload.py draws, plus a default config
CONFIGS = [
    dict(seed=7, horizon_s=120.0, base_rate=0.5),
    dict(seed=8, horizon_s=120.0, base_rate=0.5),
    dict(seed=3, horizon_s=600.0, period_s=600.0, base_rate=0.4,
         burst_amplitude=0.9, turns_lo=1, turns_hi=1),
    dict(seed=5, horizon_s=300.0, base_rate=0.5),
    dict(seed=11, horizon_s=400.0, base_rate=0.6),
    dict(seed=11, horizon_s=400.0, base_rate=0.5, turns_lo=2, turns_hi=4),
    dict(seed=2, horizon_s=900.0, base_rate=0.5),
    dict(seed=9, horizon_s=400.0, base_rate=0.5, turns_lo=3, turns_hi=4),
    dict(seed=9, horizon_s=400.0, base_rate=0.5, turns_lo=2, turns_hi=3),
    dict(seed=4, horizon_s=200.0, base_rate=0.5, long_context_prob=1.0),
    dict(seed=4, horizon_s=200.0, base_rate=0.5, long_context_prob=0.0),
    dict(seed=6, horizon_s=300.0, base_rate=0.5, turns_lo=1, turns_hi=4),
    dict(),
]


def _pair(**kw):
    return (jwork.generate_trace(jwork.WorkloadConfig(**kw)),
            twork.generate_trace(twork.WorkloadConfig(**kw)))


def _events(trace):
    return [dataclasses.astuple(e) for e in trace.events]


@pytest.mark.parametrize("kw", CONFIGS, ids=[str(i) for i in range(len(CONFIGS))])
def test_trace_equal_jax(kw):
    j, t = _pair(**kw)
    assert _events(t) == _events(j)
    assert t.system_prompt == j.system_prompt
    assert t.n_sessions == j.n_sessions
    for n in (1, 6, 24):
        assert t.arrival_counts(n) == j.arrival_counts(n)
    assert dataclasses.astuple(t.config) == dataclasses.astuple(j.config)
    # the JAX file's properties, on the port's trace
    cfg = t.config
    times = [e.t for e in t.events]
    assert times == sorted(times)
    tiers = {}
    for e in t.events:
        assert e.tier in TIERS
        assert e.deadline_s == cfg.tier_deadline_s(e.tier) > 0
        assert 0 <= e.turn < e.n_turns
        assert cfg.turns_lo <= e.n_turns <= cfg.turns_hi
        tiers.setdefault(e.session, set()).add(e.tier)
        if cfg.long_context_prob == 1.0 and e.turn == 0:
            assert e.long_context
        if cfg.long_context_prob == 0.0:
            assert not e.long_context
    assert all(len(s) == 1 for s in tiers.values())


def test_determinism_and_tier_mix():
    a = twork.generate_trace(twork.WorkloadConfig(seed=7, horizon_s=120.0))
    b = twork.generate_trace(twork.WorkloadConfig(seed=7, horizon_s=120.0))
    c = twork.generate_trace(twork.WorkloadConfig(seed=8, horizon_s=120.0))
    assert a == b and len(a.events) > 0
    assert a.events != c.events
    big = twork.generate_trace(twork.WorkloadConfig(seed=2, horizon_s=900.0))
    assert {e.tier for e in big.events} == set(TIERS)
    with pytest.raises(dataclasses.FrozenInstanceError):
        a.config.seed = 1


def test_no_wall_clock_in_module():
    src = inspect.getsource(twork)
    for needle in ("import time", "import datetime", "time.time",
                   "time.monotonic", "date.today", "datetime.now"):
        assert needle not in src, needle


def test_rate_and_validation_equal_jax():
    kw = dict(base_rate=1.0, burst_amplitude=0.5, period_s=100.0)
    jc, tc = jwork.WorkloadConfig(**kw), twork.WorkloadConfig(**kw)
    for t in np.linspace(0, 100.0, 50):
        assert tc.rate(t) == jc.rate(t)
    for bad in (dict(burst_amplitude=1.5),
                dict(latency_frac=0.9, batch_frac=0.3)):
        with pytest.raises(ValueError) as te:
            twork.generate_trace(twork.WorkloadConfig(**bad))
        with pytest.raises(ValueError) as je:
            jwork.generate_trace(jwork.WorkloadConfig(**bad))
        assert str(te.value) == str(je.value)


@pytest.mark.parametrize("kw", [CONFIGS[7], CONFIGS[9]], ids=["chat", "long"])
def test_session_book_prompts_equal_jax(kw):
    """Replay with the same replies: every prompt equal, chained as
    prompt + reply + user tokens, clamped to max_prompt_tokens."""
    j, t = _pair(**kw)
    jb, tb = jwork.SessionBook(j), twork.SessionBook(t)
    prev = {}
    for je, te in zip(j.events, t.events):
        assert tb.ready(te) == jb.ready(je) is True
        tp = tb.prompt_for(te)
        assert tp.tolist() == jb.prompt_for(je).tolist()
        assert len(tp) <= t.config.max_prompt_tokens
        if te.turn > 0:
            chained = prev[te.session] + list(te.user_tokens)
            assert tp.tolist() == chained[-t.config.max_prompt_tokens:]
        reply = [int(x) for x in np.arange(te.max_new) + 1]
        prev[te.session] = tp.tolist() + reply
        tb.record_reply(te, reply)
        jb.record_reply(je, reply)


def test_session_book_gates():
    t = twork.generate_trace(twork.WorkloadConfig(
        seed=9, horizon_s=400.0, turns_lo=2, turns_hi=3))
    ev0 = next(e for e in t.events if e.n_turns > 1 and e.turn == 0)
    ev1 = next(e for e in t.events
               if e.session == ev0.session and e.turn == 1)
    book = twork.SessionBook(t)
    assert book.ready(ev0)
    book.prompt_for(ev0)
    assert not book.ready(ev1)
    book.record_reply(ev0, [1, 2])
    assert book.ready(ev1)
    with pytest.raises(ValueError, match="no pending prompt"):
        twork.SessionBook(t).record_reply(t.events[0], [1])


# ---- metrics -------------------------------------------------------------

# the wall-clock gauge: key compared, value not
WALL = ("serving_tokens_per_sec",)


def _script(m):
    """One sequence of every ingestion call, with fixed values."""
    for _ in range(5):
        m.request_submitted()
    m.request_rejected()
    for tier in ("latency", "batch", "bogus"):
        m.tier_admitted(tier)
    m.tier_preempted("batch")
    m.tier_escalated("batch")
    m.request_shed("standard")
    m.request_shed("bogus")
    m.request_completed()
    m.request_completed()
    m.request_failed()
    m.request_cancelled()
    m.failover()
    m.replica_ejected()
    m.replica_readmitted()
    for i, ms in enumerate((12.0, 30.5, 7.25, 18.0, 99.0)):
        m.observe_ttft(ms, tier=TIERS[i % 3])
        m.observe_tpot(ms / 10, tier=TIERS[(i + 1) % 3])
    m.observe_ttft(5.0)
    m.observe_tokens(7, 1.0)
    m.observe_tokens(3, 2.0)
    m.set_queue_depth(4)
    m.set_active_requests(2)
    m.update_prefix_cache(5, 3, 1, 80)
    m.update_prefix_cache(4, 3, 1, 70)          # never rewinds
    m.update_speculative(40, 17, 9, 26)
    m.update_step_timing(12.5, 3.25, 11, 0.4)
    m.update_paged({"occupancy": 0.5, "shared_ratio": 0.125,
                    "used_pages": 16, "n_pages": 33,
                    "pages_allocated": 40, "pages_freed": 24,
                    "pages_shared": 4, "cow_copies": 2,
                    "swap_preemptions": 3, "swap_resumes": 3})
    m.update_kv_tier({"bytes_used": 1024, "capacity_bytes": 4096,
                      "entries": 2, "promote_hit_rate": 0.5,
                      "demotions": 3, "promotions": 1, "swap_outs": 2,
                      "swap_ins": 2, "evictions": 1})
    m.update_kv_integrity({"integrity_checks": 6,
                           "integrity_quarantines": 1})
    m.update_weight_quant({"weight_quant_int8": 1.0,
                           "weight_bytes_device": 162048.0},
                          "int8_stochastic:reference")
    m.update_straggler({"stragglers_flagged": 1,
                        "stragglers_flagged_total": 2,
                        "straggler_ejections_total": 1})
    m.set_preflight_failed(1)
    m.set_mesh(1, 1)
    m.observe_handoff("device", 0.75)
    m.observe_handoff("host", 290.0)
    m.observe_handoff("carrier-pigeon", 1.0)
    m.set_role_queue_depth("prefill", 3)
    m.set_role_queue_depth("nobody", 9)
    m.replica_degraded()
    m.update_elastic({"resize_shrink": 0, "resize_grow": 0,
                      "refresh_committed": 2, "refresh_deferred": 1,
                      "refresh_rolled_back": 1, "resize_downtime_ms": 0.0,
                      "weight_version": 2})
    m.update_adapters({"hits": 4, "misses": 2, "evictions": 1,
                       "uploads": 2, "registered": 3, "resident": 2,
                       "pinned": 1, "slots": 4, "active_requests": 1})
    m.update_prefill({"prefill_chunk": 256, "admission_stall_ms": 12.5,
                      "prefill_chunks_total": 7, "prefilling_slots": 1})
    m.affinity_routed(True)
    m.affinity_routed(False)
    m.affinity_routed(True, capped=True)
    m.set_digest_map_size(12)
    m.forecast_emitted("up", 4)
    m.forecast_emitted("sideways", 9)
    m.update_kernel_path("kernel", 6)
    m.update_kernel_path("reference", 2)
    m.update_kernel_path("kernel", 3)           # never rewinds


def _split(text):
    """(sample and TYPE lines, {metric: HELP present}) of a render,
    with the wall-clock values masked."""
    lines, helps = [], set()
    for ln in text.splitlines():
        if ln.startswith("# HELP "):
            helps.add(ln.split()[2])
            continue
        if ln.startswith(WALL):
            ln = ln.rsplit(" ", 1)[0]
        lines.append(ln)
    return lines, helps


def render_equal(jm, tm):
    jl, jh = _split(jm.render())
    tl, th = _split(tm.render())
    assert tl == jl
    assert th == jh


def test_exposition_equal_jax_for_one_event_sequence():
    jm, tm = jmetrics.ServingMetrics(), tmetrics.ServingMetrics()
    render_equal(jm, tm)                 # fresh: every zero renders
    _script(jm)
    _script(tm)
    render_equal(jm, tm)
    for name in ("shed_total", "rejected_total", "requests_total",
                 "completed_total", "tokens_total", "failed_total",
                 "cancelled_total", "failovers_total",
                 "replica_ejections", "replica_readmissions",
                 "tier_admitted_total", "tier_preempted_total",
                 "tier_escalated_total", "tier_shed_total",
                 "prefix_hits", "spec_acceptance_rate",
                 "spec_tokens_per_step", "paged_occupancy", "mesh_tp",
                 "kernel_path_steps", "handoff_total", "role_queue_depth",
                 "weight_refresh_total", "adapter_hit_rate",
                 "forecast_events", "forecast_chip_demand"):
        assert getattr(tm, name) == getattr(jm, name), name
    assert tm.ttft_quantiles() == jm.ttft_quantiles()
    for tier in TIERS + ("bogus",):
        assert tm.tier_ttft_quantiles(tier) == jm.tier_ttft_quantiles(tier)


def test_tier_exposition_needles():
    m = tmetrics.ServingMetrics()
    m.tier_admitted("latency")
    m.tier_preempted("batch")
    m.tier_escalated("batch")
    m.request_shed("standard")
    m.observe_ttft(12.0, tier="latency")
    m.observe_tpot(3.0, tier="latency")
    text = m.render()
    for needle in (
        "# TYPE serving_tier_admitted_total counter",
        'serving_tier_admitted_total{tier="latency"} 1',
        'serving_tier_admitted_total{tier="batch"} 0',
        'serving_tier_preempted_total{tier="batch"} 1',
        'serving_tier_escalated_total{tier="batch"} 1',
        'serving_tier_shed_total{tier="standard"} 1',
        "# TYPE serving_tier_ttft_ms summary",
        'serving_tier_ttft_ms{tier="latency",quantile="0.5"}',
        'serving_tier_ttft_ms_count{tier="latency"} 1',
        'serving_tier_tpot_ms_count{tier="latency"} 1',
    ):
        assert needle in text, needle
    m2 = tmetrics.ServingMetrics()
    m2.request_shed("bogus")
    m2.tier_admitted("bogus")
    assert m2.shed_total == 1
    assert sum(m2.tier_shed_total.values()) == 0
    assert sum(m2.tier_admitted_total.values()) == 0


@pytest.mark.parametrize("n", [0, 1, 7, 600])
def test_window_quantiles_equal_jax(n):
    vals = np.random.default_rng(n).exponential(20.0, size=n).tolist()
    jw, tw = jmetrics._Window(), tmetrics._Window()
    for v in vals:
        jw.observe(v)
        tw.observe(v)
    assert tw.quantiles((0.5, 0.9, 0.95, 0.99)) == jw.quantiles(
        (0.5, 0.9, 0.95, 0.99))
    s = sorted(vals)
    for q in (0.0, 0.5, 1.0):
        if s:
            assert tmetrics._quantile(s, q) == jmetrics._quantile(s, q)
