"""Serving metrics: TTFT/TPOT/queue-depth/throughput counters with
Prometheus text exposition — a copy of dlrover_tpu/serving/metrics.py
(the exposition is the same, metric for metric; only help texts that
named the TPU package's mechanisms are reworded).

Follows master/monitor/speed_monitor.py conventions: one lock, plain
ingestion methods, sliding windows where a rate or percentile needs
recency (a serving TTFT quantile over the whole process lifetime would
hide a regression behind hours of healthy history).

No prometheus_client dependency — the text exposition format
(https://prometheus.io/docs/instrumenting/exposition_formats/) is a few
lines of string assembly, and the gateway serves it from /metrics.
"""

import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple


def _quantile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank quantile over an already-sorted sample."""
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, max(0, int(q * len(sorted_vals))))
    return sorted_vals[i]


class _Window:
    """Sliding sample window: count/sum forever, quantiles over the
    last `maxlen` observations."""

    def __init__(self, maxlen: int = 512):
        self.count = 0
        self.total = 0.0
        self.recent: Deque[float] = deque(maxlen=maxlen)

    def observe(self, v: float):
        self.count += 1
        self.total += v
        self.recent.append(v)

    def quantiles(self, qs=(0.5, 0.95)) -> Dict[float, float]:
        vals = sorted(self.recent)
        return {q: _quantile(vals, q) for q in qs}


class ServingMetrics:
    """Thread-safe serving counters; render() emits Prometheus text.

    TTFT = submit → first token out (queueing + prefill).
    TPOT = mean inter-token time after the first (decode rate).
    """

    # every counter/gauge/window below is written by scheduler pump
    # threads and read by gateway handler threads — all access goes
    # through self._lock
    GUARDED_FIELDS = frozenset(
        {
            "_ttft_ms",
            "_tpot_ms",
            "_queue_depth",
            "_active_requests",
            "_requests_total",
            "_completed_total",
            "_shed_total",
            "_rejected_total",
            "_tokens_total",
            "_failed_total",
            "_cancelled_total",
            "_failovers_total",
            "_replica_ejections",
            "_replica_readmissions",
            "_token_events",
            "_prefix_hits",
            "_prefix_misses",
            "_prefix_evictions",
            "_prefix_tokens_reused",
            "_spec_proposed",
            "_spec_accepted",
            "_spec_rounds",
            "_spec_emitted",
            "_step_host_ms",
            "_step_device_wait_ms",
            "_step_dispatches",
            "_step_overlap_ratio",
            "_paged_occupancy",
            "_paged_shared_ratio",
            "_paged_used_pages",
            "_paged_capacity",
            "_paged_pages_allocated",
            "_paged_pages_freed",
            "_paged_pages_shared",
            "_paged_cow_copies",
            "_paged_swap_preemptions",
            "_paged_swap_resumes",
            "_kv_tier_bytes",
            "_kv_tier_capacity",
            "_kv_tier_entries",
            "_kv_tier_demotions",
            "_kv_tier_promotions",
            "_kv_tier_swap_outs",
            "_kv_tier_swap_ins",
            "_kv_tier_evictions",
            "_kv_tier_promote_hit_rate",
            "_mesh_tp",
            "_replica_chips",
            "_kernel_path_steps",
            "_handoff_total",
            "_handoff_last_ms",
            "_role_queue_depth",
            "_resize_total",
            "_weight_refresh_total",
            "_resize_downtime_ms",
            "_weight_version",
            "_replica_degradations",
            "_adapter_hits",
            "_adapter_misses",
            "_adapter_evictions",
            "_adapter_uploads",
            "_adapter_registered",
            "_adapter_resident",
            "_adapter_pinned",
            "_adapter_slots",
            "_adapter_active",
            "_affinity_matched",
            "_affinity_unmatched",
            "_affinity_capped",
            "_digest_map_digests",
            "_forecast_events",
            "_forecast_chip_demand",
            "_tier_admitted",
            "_tier_preempted",
            "_tier_escalated",
            "_tier_shed",
            "_tier_ttft",
            "_tier_tpot",
            "_prefill_chunk",
            "_admission_stall_ms",
            "_prefill_chunks_total",
            "_prefilling_slots",
            "_kv_integrity_checks",
            "_kv_quarantines",
            "_stragglers_flagged",
            "_stragglers_flagged_total",
            "_straggler_ejections_total",
            "_preflight_failed",
        }
    )

    # SLO classes — fixed label set so every tier always renders
    # (zero until taken). Mirrors scheduler.TIERS; kept literal here
    # so the exposition layer never imports the policy layer.
    TIER_LABELS = ("latency", "standard", "batch")

    def __init__(self, window: int = 512):
        self._lock = threading.Lock()
        self._ttft_ms = _Window(window)
        self._tpot_ms = _Window(window)
        self._queue_depth = 0
        self._active_requests = 0
        self._requests_total = 0
        self._completed_total = 0
        self._shed_total = 0
        self._rejected_total = 0
        self._tokens_total = 0
        # failover / lifecycle counters
        self._failed_total = 0
        self._cancelled_total = 0
        self._failovers_total = 0
        self._replica_ejections = 0
        self._replica_readmissions = 0
        # (tokens, ts) window for the tokens/sec rate gauge
        self._token_events: Deque[Tuple[int, float]] = deque(maxlen=512)
        # prefix-cache counters: copied verbatim from the engine's
        # RadixPrefixCache (which owns the monotonic truth) each pump,
        # so the exposition needs no engine reference
        self._prefix_hits = 0
        self._prefix_misses = 0
        self._prefix_evictions = 0
        self._prefix_tokens_reused = 0
        # speculative-decoding counters: copied from the engine's
        # SpeculativeDecoder (the monotonic truth) each pump, same
        # contract as the prefix-cache block above
        self._spec_proposed = 0
        self._spec_accepted = 0
        self._spec_rounds = 0
        self._spec_emitted = 0
        # step-latency micro-stats: copied from the engine's
        # step_stats() each pump. host/wait are cumulative ms
        # counters; overlap_ratio is a gauge (hidden device span /
        # total device span — ~0 sync, toward 1 under async dispatch)
        self._step_host_ms = 0.0
        self._step_device_wait_ms = 0.0
        self._step_dispatches = 0
        self._step_overlap_ratio = 0.0
        # page-pool counters/gauges: copied from the engine's
        # paged_stats() each pump (kv_layout="paged" only — all zero
        # under the dense bank)
        self._paged_occupancy = 0.0
        self._paged_shared_ratio = 0.0
        self._paged_used_pages = 0
        self._paged_capacity = 0
        self._paged_pages_allocated = 0
        self._paged_pages_freed = 0
        self._paged_pages_shared = 0
        self._paged_cow_copies = 0
        self._paged_swap_preemptions = 0
        self._paged_swap_resumes = 0
        self._kv_tier_bytes = 0
        self._kv_tier_capacity = 0
        self._kv_tier_entries = 0
        self._kv_tier_demotions = 0
        self._kv_tier_promotions = 0
        self._kv_tier_swap_outs = 0
        self._kv_tier_swap_ins = 0
        self._kv_tier_evictions = 0
        self._kv_tier_promote_hit_rate = 0.0
        # mesh-slice gauges: copied from the engine's
        # mesh_shape/n_chips each pump. 1/1 is the un-meshed default
        # (a replica always occupies at least one device)
        self._mesh_tp = 1
        self._replica_chips = 1
        # decode-step counters split by attention body: copied from
        # the engine's kernel_path + step dispatch count each pump.
        # Both labels always render (zero until taken) so dashboards
        # can alert on "reference steps > 0" for a kernel deployment.
        self._kernel_path_steps = {"kernel": 0, "reference": 0}
        # MPMD phase-handoff counters: completed prefill→decode
        # migrations by transport, the last migration's end-to-end
        # latency (export already done; this is placement + adoption),
        # and per-role waiting depth. Fixed label sets so every label
        # always renders (zero until taken).
        self._handoff_total = {"device": 0, "host": 0}
        self._handoff_last_ms = 0.0
        self._role_queue_depth = {
            "prefill": 0, "decode": 0, "colocated": 0,
        }
        # elastic counters: copied from the engine's elastic_stats()
        # each pump. Fixed label sets so every label always renders
        # (zero until taken); the degradation counter is fed by the
        # pool's health thread, not the engine.
        self._resize_total = {"shrink": 0, "grow": 0}
        self._weight_refresh_total = {
            "committed": 0, "deferred": 0, "rolled_back": 0,
        }
        self._resize_downtime_ms = 0.0
        self._weight_version = 0
        self._replica_degradations = 0
        # multi-adapter serving: device-bank cache traffic (counters,
        # copied from the engine's adapter_stats() each pump with the
        # usual max() monotonic guard) and registry/residency gauges.
        # All zero when multi-adapter serving is off.
        self._adapter_hits = 0
        self._adapter_misses = 0
        self._adapter_evictions = 0
        self._adapter_uploads = 0
        self._adapter_registered = 0
        self._adapter_resident = 0
        self._adapter_pinned = 0
        self._adapter_slots = 0
        self._adapter_active = 0
        # fleet prefix-affinity routing: per-request placement
        # outcomes (fed by ReplicaPool.submit) and the digest-map
        # occupancy gauge (fed on heartbeat refresh). "capped" =
        # the digest matched but the imbalance cap voided it.
        self._affinity_matched = 0
        self._affinity_unmatched = 0
        self._affinity_capped = 0
        self._digest_map_digests = 0
        # predictive autoscaling: forecast hints emitted by direction
        # (fixed label set) and the latest chip-denominated demand
        self._forecast_events = {"up": 0, "down": 0}
        self._forecast_chip_demand = 0
        # priority tiers: admission/preemption/escalation/shed
        # counters and TTFT/TPOT windows per SLO class. Sheds are
        # attributed to the tier that missed (the tier analog of the
        # global _shed_total, which still counts everything).
        self._tier_admitted = {t: 0 for t in self.TIER_LABELS}
        self._tier_preempted = {t: 0 for t in self.TIER_LABELS}
        self._tier_escalated = {t: 0 for t in self.TIER_LABELS}
        self._tier_shed = {t: 0 for t in self.TIER_LABELS}
        self._tier_ttft = {t: _Window(window) for t in self.TIER_LABELS}
        self._tier_tpot = {t: _Window(window) for t in self.TIER_LABELS}
        # interleaved chunked prefill: TTFT decomposition telemetry,
        # copied from the engine's prefill_stats() each pump. The
        # stall counter is the admission time charged to the step
        # loop (what chunking exists to shrink); chunks_total counts
        # fused prefill+decode dispatches. Both rendered even at
        # prefill_chunk=0 so dashboards can difference the knob.
        self._prefill_chunk = 0
        self._admission_stall_ms = 0.0
        self._prefill_chunks_total = 0
        self._prefilling_slots = 0
        # health sentinel (serving/health.py): KV integrity
        # verifications/quarantines copied from the engine's
        # health_stats() each pump, straggler detector counters and
        # the currently-fenced gauge copied on the pool's health
        # pass, and the preflight-failure gauge. All zero with the
        # sentinel off.
        self._kv_integrity_checks = 0
        self._kv_quarantines = 0
        self._stragglers_flagged = 0
        self._stragglers_flagged_total = 0
        self._straggler_ejections_total = 0
        self._preflight_failed = 0
        # int8 weight quantization (engine weight_quant knob):
        # per-device served-weight bytes (gauge — decode streams these
        # from device memory every step), the on/off flag, and the traced
        # matmul-path string. Defaults match the knob off.
        self._weight_quant_on = 0
        self._weight_bytes_device = 0
        self._weight_quant_path = "none"

    # ---- ingestion -------------------------------------------------------

    def request_submitted(self):
        with self._lock:
            self._requests_total += 1

    def request_rejected(self):
        with self._lock:
            self._rejected_total += 1

    def request_shed(self, tier: str = "standard"):
        """One request shed past its deadline, attributed to the SLO
        class that missed. Unknown tiers still count globally."""
        with self._lock:
            self._shed_total += 1
            if tier in self._tier_shed:
                self._tier_shed[tier] += 1

    def tier_admitted(self, tier: str):
        if tier not in self.TIER_LABELS:
            return
        with self._lock:
            self._tier_admitted[tier] += 1

    def tier_preempted(self, tier: str):
        """One running request evicted by scheduler admission
        preemption, labelled with the VICTIM's tier."""
        if tier not in self.TIER_LABELS:
            return
        with self._lock:
            self._tier_preempted[tier] += 1

    def tier_escalated(self, tier: str):
        """One waiting request promoted a tier by the aging
        escalator, labelled with its base tier."""
        if tier not in self.TIER_LABELS:
            return
        with self._lock:
            self._tier_escalated[tier] += 1

    def request_completed(self):
        with self._lock:
            self._completed_total += 1

    def request_failed(self):
        with self._lock:
            self._failed_total += 1

    def request_cancelled(self):
        with self._lock:
            self._cancelled_total += 1

    def failover(self):
        """One in-flight request successfully re-admitted elsewhere
        after its replica died."""
        with self._lock:
            self._failovers_total += 1

    def replica_ejected(self):
        with self._lock:
            self._replica_ejections += 1

    def replica_readmitted(self):
        with self._lock:
            self._replica_readmissions += 1

    def observe_ttft(self, ms: float, tier: Optional[str] = None):
        with self._lock:
            self._ttft_ms.observe(ms)
            if tier in self._tier_ttft:
                self._tier_ttft[tier].observe(ms)

    def observe_tpot(self, ms: float, tier: Optional[str] = None):
        with self._lock:
            self._tpot_ms.observe(ms)
            if tier in self._tier_tpot:
                self._tier_tpot[tier].observe(ms)

    def observe_tokens(self, n: int, ts: Optional[float] = None):
        with self._lock:
            self._tokens_total += n
            self._token_events.append((n, ts or time.monotonic()))

    def set_queue_depth(self, depth: int):
        with self._lock:
            self._queue_depth = depth

    def set_active_requests(self, n: int):
        with self._lock:
            self._active_requests = n

    def update_prefix_cache(
        self, hits: int, misses: int, evictions: int,
        tokens_reused: int,
    ):
        """Refresh the prefix-cache counters from the engine's radix
        cache. Values are running totals; max() guards a multi-replica
        pool from a lagging replica rolling a shared exposition
        backwards (Prometheus counters must be monotonic)."""
        with self._lock:
            self._prefix_hits = max(self._prefix_hits, hits)
            self._prefix_misses = max(self._prefix_misses, misses)
            self._prefix_evictions = max(
                self._prefix_evictions, evictions
            )
            self._prefix_tokens_reused = max(
                self._prefix_tokens_reused, tokens_reused
            )

    def update_speculative(
        self, proposed: int, accepted: int, rounds: int, emitted: int
    ):
        """Refresh speculative-decoding counters from the engine's
        SpeculativeDecoder. Running totals with the same max() guard as
        update_prefix_cache (Prometheus counters must be monotonic)."""
        with self._lock:
            self._spec_proposed = max(self._spec_proposed, proposed)
            self._spec_accepted = max(self._spec_accepted, accepted)
            self._spec_rounds = max(self._spec_rounds, rounds)
            self._spec_emitted = max(self._spec_emitted, emitted)

    def update_step_timing(
        self, host_ms: float, device_wait_ms: float,
        dispatches: int, overlap_ratio: float,
    ):
        """Refresh step-latency stats from the engine's step_stats().
        The time totals and dispatch count get the same max() monotonic
        guard as the blocks above; overlap_ratio is a gauge and is set
        directly (it legitimately moves both ways as traffic shifts
        between sync-like and fully-hidden regimes)."""
        with self._lock:
            self._step_host_ms = max(self._step_host_ms, host_ms)
            self._step_device_wait_ms = max(
                self._step_device_wait_ms, device_wait_ms
            )
            self._step_dispatches = max(
                self._step_dispatches, int(dispatches)
            )
            self._step_overlap_ratio = overlap_ratio

    def update_paged(self, stats: Dict[str, float]):
        """Refresh page-pool telemetry from the engine's paged_stats().
        Occupancy/sharing are gauges (set directly); the page and swap
        totals are counters with the same max() monotonic guard as the
        blocks above."""
        with self._lock:
            self._paged_occupancy = float(stats.get("occupancy", 0.0))
            self._paged_shared_ratio = float(
                stats.get("shared_ratio", 0.0)
            )
            self._paged_used_pages = int(stats.get("used_pages", 0))
            self._paged_capacity = int(stats.get("n_pages", 0))
            self._paged_pages_allocated = max(
                self._paged_pages_allocated,
                int(stats.get("pages_allocated", 0)),
            )
            self._paged_pages_freed = max(
                self._paged_pages_freed, int(stats.get("pages_freed", 0))
            )
            self._paged_pages_shared = max(
                self._paged_pages_shared,
                int(stats.get("pages_shared", 0)),
            )
            self._paged_cow_copies = max(
                self._paged_cow_copies, int(stats.get("cow_copies", 0))
            )
            self._paged_swap_preemptions = max(
                self._paged_swap_preemptions,
                int(stats.get("swap_preemptions", 0)),
            )
            self._paged_swap_resumes = max(
                self._paged_swap_resumes,
                int(stats.get("swap_resumes", 0)),
            )

    def update_kv_tier(self, stats: Dict[str, float]):
        """Refresh host-DRAM KV tier telemetry from the engine's
        kv_tier_stats() (serving/kv_tier.py). Bytes/entries/hit-rate
        are gauges; the demotion/promotion/swap/eviction totals are
        counters under the same max() monotonic guard as update_paged
        — a restarted engine can reset its tier without the exposition
        ever showing a counter going backwards."""
        with self._lock:
            self._kv_tier_bytes = int(stats.get("bytes_used", 0))
            self._kv_tier_capacity = int(
                stats.get("capacity_bytes", 0)
            )
            self._kv_tier_entries = int(stats.get("entries", 0))
            self._kv_tier_promote_hit_rate = float(
                stats.get("promote_hit_rate", 0.0)
            )
            self._kv_tier_demotions = max(
                self._kv_tier_demotions, int(stats.get("demotions", 0))
            )
            self._kv_tier_promotions = max(
                self._kv_tier_promotions,
                int(stats.get("promotions", 0)),
            )
            self._kv_tier_swap_outs = max(
                self._kv_tier_swap_outs, int(stats.get("swap_outs", 0))
            )
            self._kv_tier_swap_ins = max(
                self._kv_tier_swap_ins, int(stats.get("swap_ins", 0))
            )
            self._kv_tier_evictions = max(
                self._kv_tier_evictions, int(stats.get("evictions", 0))
            )

    def update_kv_integrity(self, stats: Dict[str, float]):
        """Refresh KV integrity telemetry from the engine's
        health_stats() (serving/health.py checksums). Both values are
        running totals under the usual max() monotonic guard."""
        with self._lock:
            self._kv_integrity_checks = max(
                self._kv_integrity_checks,
                int(stats.get("integrity_checks", 0)),
            )
            self._kv_quarantines = max(
                self._kv_quarantines,
                int(stats.get("integrity_quarantines", 0)),
            )

    def update_weight_quant(
        self, stats: Dict[str, float], path: str = "none"
    ):
        """Refresh weight-quantization telemetry from the engine's
        weight_quant_stats(). Both values are gauges set directly: a
        weight refresh or elastic reshard legitimately changes the
        resident byte count, and a restarted engine may flip the
        mode."""
        with self._lock:
            self._weight_quant_on = int(
                stats.get("weight_quant_int8", 0)
            )
            self._weight_bytes_device = int(
                stats.get("weight_bytes_device", 0)
            )
            self._weight_quant_path = str(path)

    def update_straggler(self, stats: Dict[str, float]):
        """Refresh straggler-sentinel telemetry from the pool's
        detector stats(). The currently-fenced count is a gauge (a
        recovered straggler drops it); the flagged/ejected totals are
        counters under the max() monotonic guard."""
        with self._lock:
            self._stragglers_flagged = int(
                stats.get("stragglers_flagged", 0)
            )
            self._stragglers_flagged_total = max(
                self._stragglers_flagged_total,
                int(stats.get("stragglers_flagged_total", 0)),
            )
            self._straggler_ejections_total = max(
                self._straggler_ejections_total,
                int(stats.get("straggler_ejections_total", 0)),
            )

    def set_preflight_failed(self, n: int):
        """Replicas currently failing their preflight self-check
        (gauge — a passing re-probe clears it)."""
        with self._lock:
            self._preflight_failed = int(n)

    def set_mesh(self, tp: int, n_chips: int):
        """Refresh the replica's mesh-slice shape (gauges, set
        directly — a restarted engine may legitimately change them)."""
        with self._lock:
            self._mesh_tp = int(tp)
            self._replica_chips = int(n_chips)

    def observe_handoff(self, transport: str, ms: float):
        """One completed prefill→decode migration over `transport`
        ("device" | "host")."""
        if transport not in ("device", "host"):
            return
        with self._lock:
            self._handoff_total[transport] += 1
            self._handoff_last_ms = float(ms)

    def set_role_queue_depth(self, role: str, depth: int):
        """Waiting depth of one replica role's scheduler (gauge)."""
        if role not in ("prefill", "decode", "colocated"):
            return
        with self._lock:
            self._role_queue_depth[role] = int(depth)

    def replica_degraded(self):
        """One replica entered the degraded (shrunk-but-alive) state —
        distinct from ejection: it keeps serving."""
        with self._lock:
            self._replica_degradations += 1

    def update_elastic(self, stats: Dict[str, float]):
        """Refresh elastic resize / weight-refresh counters from the
        engine's elastic_stats(). Running totals get the same max()
        monotonic guard as the blocks above (a multi-replica pool may
        share one exposition); tp/chips already flow through
        set_mesh, and the weight version is a gauge."""
        with self._lock:
            self._resize_total["shrink"] = max(
                self._resize_total["shrink"],
                int(stats.get("resize_shrink", 0)),
            )
            self._resize_total["grow"] = max(
                self._resize_total["grow"],
                int(stats.get("resize_grow", 0)),
            )
            for outcome in ("committed", "deferred", "rolled_back"):
                self._weight_refresh_total[outcome] = max(
                    self._weight_refresh_total[outcome],
                    int(stats.get(f"refresh_{outcome}", 0)),
                )
            self._resize_downtime_ms = max(
                self._resize_downtime_ms,
                float(stats.get("resize_downtime_ms", 0.0)),
            )
            self._weight_version = int(
                stats.get("weight_version", self._weight_version)
            )

    def update_adapters(self, stats: Dict[str, float]):
        """Refresh multi-adapter serving telemetry from the engine's
        adapter_stats(). Cache traffic totals get the same max()
        monotonic guard as the blocks above; registry size, residency,
        pins, and live adaptered requests are gauges."""
        with self._lock:
            self._adapter_hits = max(
                self._adapter_hits, int(stats.get("hits", 0))
            )
            self._adapter_misses = max(
                self._adapter_misses, int(stats.get("misses", 0))
            )
            self._adapter_evictions = max(
                self._adapter_evictions,
                int(stats.get("evictions", 0)),
            )
            self._adapter_uploads = max(
                self._adapter_uploads, int(stats.get("uploads", 0))
            )
            self._adapter_registered = int(stats.get("registered", 0))
            self._adapter_resident = int(stats.get("resident", 0))
            self._adapter_pinned = int(stats.get("pinned", 0))
            self._adapter_slots = int(stats.get("slots", 0))
            self._adapter_active = int(
                stats.get("active_requests", 0)
            )

    def update_prefill(self, stats: Dict[str, float]):
        """Refresh interleaved chunked-prefill telemetry from the
        engine's prefill_stats(). Stall/chunk totals get the same
        max() monotonic guard as the blocks above (a restarted engine
        must not rewind the exposition); the knob and the mid-prefill
        slot count are gauges."""
        with self._lock:
            self._prefill_chunk = int(stats.get("prefill_chunk", 0))
            self._admission_stall_ms = max(
                self._admission_stall_ms,
                float(stats.get("admission_stall_ms", 0.0)),
            )
            self._prefill_chunks_total = max(
                self._prefill_chunks_total,
                int(stats.get("prefill_chunks_total", 0)),
            )
            self._prefilling_slots = int(
                stats.get("prefilling_slots", 0)
            )

    def affinity_routed(self, matched: bool, capped: bool = False):
        """One routed request's placement outcome: `matched` means it
        landed on a replica advertising a digest of its prefix;
        `capped` means a match existed but the imbalance cap spilled
        the request to a cooler replica."""
        with self._lock:
            if capped:
                self._affinity_capped += 1
            elif matched:
                self._affinity_matched += 1
            else:
                self._affinity_unmatched += 1

    def set_digest_map_size(self, n: int):
        """Distinct digests in the fleet digest map (gauge)."""
        with self._lock:
            self._digest_map_digests = int(n)

    def forecast_emitted(self, direction: str, chips: int):
        """One predictive scale hint left the pool: count it by
        direction and remember the chip-denominated demand (gauge)."""
        if direction not in ("up", "down"):
            return
        with self._lock:
            self._forecast_events[direction] += 1
            self._forecast_chip_demand = int(chips)

    def ttft_quantiles(self) -> Dict[float, float]:
        """TTFT quantiles over the sliding window — the pool's
        telemetry publisher reads p50 from here."""
        with self._lock:
            return self._ttft_ms.quantiles()

    def tier_ttft_quantiles(self, tier: str) -> Dict[float, float]:
        """TTFT quantiles for one SLO class (empty windows return
        zeros, unknown tiers an empty dict)."""
        with self._lock:
            win = self._tier_ttft.get(tier)
            return win.quantiles() if win is not None else {}

    def update_kernel_path(self, path: str, steps: int):
        """Refresh the per-attention-body decode-step counter from the
        engine's kernel_path and cumulative dispatch count. Same max()
        monotonic guard as the counter blocks above."""
        if path not in ("kernel", "reference"):
            return
        with self._lock:
            self._kernel_path_steps[path] = max(
                self._kernel_path_steps[path], int(steps)
            )

    # ---- queries ---------------------------------------------------------

    @property
    def shed_total(self) -> int:
        with self._lock:
            return self._shed_total

    @property
    def tier_admitted_total(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._tier_admitted)

    @property
    def tier_preempted_total(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._tier_preempted)

    @property
    def tier_escalated_total(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._tier_escalated)

    @property
    def tier_shed_total(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._tier_shed)

    @property
    def rejected_total(self) -> int:
        with self._lock:
            return self._rejected_total

    @property
    def requests_total(self) -> int:
        with self._lock:
            return self._requests_total

    @property
    def completed_total(self) -> int:
        with self._lock:
            return self._completed_total

    @property
    def tokens_total(self) -> int:
        with self._lock:
            return self._tokens_total

    @property
    def failed_total(self) -> int:
        with self._lock:
            return self._failed_total

    @property
    def cancelled_total(self) -> int:
        with self._lock:
            return self._cancelled_total

    @property
    def failovers_total(self) -> int:
        with self._lock:
            return self._failovers_total

    @property
    def replica_ejections(self) -> int:
        with self._lock:
            return self._replica_ejections

    @property
    def replica_readmissions(self) -> int:
        with self._lock:
            return self._replica_readmissions

    @property
    def queue_depth(self) -> int:
        with self._lock:
            return self._queue_depth

    @property
    def prefix_hits(self) -> int:
        with self._lock:
            return self._prefix_hits

    @property
    def prefix_misses(self) -> int:
        with self._lock:
            return self._prefix_misses

    @property
    def prefix_tokens_reused(self) -> int:
        with self._lock:
            return self._prefix_tokens_reused

    @property
    def spec_proposed(self) -> int:
        with self._lock:
            return self._spec_proposed

    @property
    def spec_accepted(self) -> int:
        with self._lock:
            return self._spec_accepted

    @property
    def spec_acceptance_rate(self) -> float:
        with self._lock:
            if not self._spec_proposed:
                return 0.0
            return self._spec_accepted / self._spec_proposed

    @property
    def spec_tokens_per_step(self) -> float:
        with self._lock:
            if not self._spec_rounds:
                return 0.0
            return self._spec_emitted / self._spec_rounds

    @property
    def step_host_ms(self) -> float:
        with self._lock:
            return self._step_host_ms

    @property
    def step_device_wait_ms(self) -> float:
        with self._lock:
            return self._step_device_wait_ms

    @property
    def step_dispatches(self) -> int:
        with self._lock:
            return self._step_dispatches

    @property
    def step_overlap_ratio(self) -> float:
        with self._lock:
            return self._step_overlap_ratio

    @property
    def paged_occupancy(self) -> float:
        with self._lock:
            return self._paged_occupancy

    @property
    def paged_shared_ratio(self) -> float:
        with self._lock:
            return self._paged_shared_ratio

    @property
    def paged_cow_copies(self) -> int:
        with self._lock:
            return self._paged_cow_copies

    @property
    def paged_swap_preemptions(self) -> int:
        with self._lock:
            return self._paged_swap_preemptions

    @property
    def paged_swap_resumes(self) -> int:
        with self._lock:
            return self._paged_swap_resumes

    @property
    def mesh_tp(self) -> int:
        with self._lock:
            return self._mesh_tp

    @property
    def replica_chips(self) -> int:
        with self._lock:
            return self._replica_chips

    @property
    def kernel_path_steps(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._kernel_path_steps)

    @property
    def handoff_total(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._handoff_total)

    @property
    def handoff_last_ms(self) -> float:
        with self._lock:
            return self._handoff_last_ms

    @property
    def role_queue_depth(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._role_queue_depth)

    @property
    def resize_total(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._resize_total)

    @property
    def weight_refresh_total(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._weight_refresh_total)

    @property
    def resize_downtime_ms(self) -> float:
        with self._lock:
            return self._resize_downtime_ms

    @property
    def weight_version(self) -> int:
        with self._lock:
            return self._weight_version

    @property
    def replica_degradations(self) -> int:
        with self._lock:
            return self._replica_degradations

    @property
    def adapter_hits(self) -> int:
        with self._lock:
            return self._adapter_hits

    @property
    def adapter_misses(self) -> int:
        with self._lock:
            return self._adapter_misses

    @property
    def adapter_evictions(self) -> int:
        with self._lock:
            return self._adapter_evictions

    @property
    def adapter_registered(self) -> int:
        with self._lock:
            return self._adapter_registered

    @property
    def adapter_hit_rate(self) -> float:
        with self._lock:
            looked = self._adapter_hits + self._adapter_misses
            return self._adapter_hits / looked if looked else 0.0

    @property
    def affinity_matched(self) -> int:
        with self._lock:
            return self._affinity_matched

    @property
    def affinity_unmatched(self) -> int:
        with self._lock:
            return self._affinity_unmatched

    @property
    def affinity_capped(self) -> int:
        with self._lock:
            return self._affinity_capped

    @property
    def digest_map_digests(self) -> int:
        with self._lock:
            return self._digest_map_digests

    @property
    def forecast_events(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._forecast_events)

    @property
    def forecast_chip_demand(self) -> int:
        with self._lock:
            return self._forecast_chip_demand

    def tokens_per_sec(self, horizon_s: float = 10.0) -> float:
        """Emission rate over the trailing `horizon_s` seconds."""
        now = time.monotonic()
        with self._lock:
            toks = sum(
                n for n, ts in self._token_events
                if now - ts <= horizon_s
            )
        return toks / horizon_s if toks else 0.0

    # ---- exposition ------------------------------------------------------

    def render(self) -> str:
        """Prometheus text exposition (version 0.0.4)."""
        with self._lock:
            ttft_q = self._ttft_ms.quantiles()
            tpot_q = self._tpot_ms.quantiles()
            lines = []

            def summary(name, help_, win: _Window, q: Dict):
                lines.append(f"# HELP {name} {help_}")
                lines.append(f"# TYPE {name} summary")
                for quant, val in q.items():
                    lines.append(
                        f'{name}{{quantile="{quant}"}} {val:.6g}'
                    )
                lines.append(f"{name}_sum {win.total:.6g}")
                lines.append(f"{name}_count {win.count}")

            def gauge(name, help_, val):
                lines.append(f"# HELP {name} {help_}")
                lines.append(f"# TYPE {name} gauge")
                lines.append(f"{name} {val:.6g}")

            def counter(name, help_, val):
                lines.append(f"# HELP {name} {help_}")
                lines.append(f"# TYPE {name} counter")
                lines.append(f"{name} {val}")

            summary(
                "serving_ttft_ms",
                "Time to first token (queueing + prefill), ms.",
                self._ttft_ms, ttft_q,
            )
            summary(
                "serving_tpot_ms",
                "Mean time per output token after the first, ms.",
                self._tpot_ms, tpot_q,
            )
            gauge(
                "serving_queue_depth",
                "Requests waiting for a slot.",
                self._queue_depth,
            )
            gauge(
                "serving_active_requests",
                "Requests currently decoding.",
                self._active_requests,
            )
            counter(
                "serving_requests_total",
                "Requests admitted.",
                self._requests_total,
            )
            counter(
                "serving_requests_completed_total",
                "Requests run to completion.",
                self._completed_total,
            )
            counter(
                "serving_requests_shed_total",
                "Requests shed past their deadline.",
                self._shed_total,
            )
            for fam, help_, store in (
                (
                    "serving_tier_admitted_total",
                    "Requests admitted, by SLO tier.",
                    self._tier_admitted,
                ),
                (
                    "serving_tier_preempted_total",
                    "Running requests evicted by admission "
                    "preemption, by victim tier.",
                    self._tier_preempted,
                ),
                (
                    "serving_tier_escalated_total",
                    "Waiting requests promoted by the aging "
                    "escalator, by base tier.",
                    self._tier_escalated,
                ),
                (
                    "serving_tier_shed_total",
                    "Requests shed past their deadline, by the tier "
                    "that missed.",
                    self._tier_shed,
                ),
            ):
                lines.append(f"# HELP {fam} {help_}")
                lines.append(f"# TYPE {fam} counter")
                for t in self.TIER_LABELS:
                    lines.append(f'{fam}{{tier="{t}"}} {store[t]}')
            for fam, help_, wins in (
                (
                    "serving_tier_ttft_ms",
                    "Time to first token by SLO tier, ms.",
                    self._tier_ttft,
                ),
                (
                    "serving_tier_tpot_ms",
                    "Mean time per output token by SLO tier, ms.",
                    self._tier_tpot,
                ),
            ):
                lines.append(f"# HELP {fam} {help_}")
                lines.append(f"# TYPE {fam} summary")
                for t in self.TIER_LABELS:
                    win = wins[t]
                    for quant, val in win.quantiles().items():
                        lines.append(
                            f'{fam}{{tier="{t}",'
                            f'quantile="{quant}"}} {val:.6g}'
                        )
                    lines.append(
                        f'{fam}_sum{{tier="{t}"}} {win.total:.6g}'
                    )
                    lines.append(
                        f'{fam}_count{{tier="{t}"}} {win.count}'
                    )
            counter(
                "serving_requests_rejected_total",
                "Requests rejected at admission.",
                self._rejected_total,
            )
            counter(
                "serving_requests_failed_total",
                "Requests failed after exhausting failover retries.",
                self._failed_total,
            )
            counter(
                "serving_requests_cancelled_total",
                "Requests cancelled (client disconnected).",
                self._cancelled_total,
            )
            counter(
                "serving_failovers_total",
                "In-flight requests re-admitted after replica death.",
                self._failovers_total,
            )
            counter(
                "serving_replica_ejections_total",
                "Replicas ejected by crash or circuit breaker.",
                self._replica_ejections,
            )
            counter(
                "serving_replica_readmissions_total",
                "Ejected replicas re-admitted after probation.",
                self._replica_readmissions,
            )
            counter(
                "serving_tokens_total",
                "Tokens emitted.",
                self._tokens_total,
            )
            counter(
                "serving_prefix_cache_hits_total",
                "Admissions that reused a cached prompt prefix.",
                self._prefix_hits,
            )
            counter(
                "serving_prefix_cache_misses_total",
                "Admissions with no usable cached prefix.",
                self._prefix_misses,
            )
            counter(
                "serving_prefix_cache_evictions_total",
                "Prefix pool rows evicted (LRU).",
                self._prefix_evictions,
            )
            counter(
                "serving_prefix_tokens_reused_total",
                "Prompt tokens whose prefill was skipped via the "
                "prefix cache.",
                self._prefix_tokens_reused,
            )
            counter(
                "serving_spec_proposed_total",
                "Draft tokens proposed by the n-gram drafter.",
                self._spec_proposed,
            )
            counter(
                "serving_spec_accepted_total",
                "Draft tokens accepted by target-model verification.",
                self._spec_accepted,
            )
            counter(
                "serving_spec_rounds_total",
                "Live slot verify rounds dispatched.",
                self._spec_rounds,
            )
            counter(
                "serving_spec_emitted_total",
                "Tokens emitted through the speculative path.",
                self._spec_emitted,
            )
            gauge(
                "serving_spec_acceptance_rate",
                "Fraction of proposed draft tokens accepted.",
                (self._spec_accepted / self._spec_proposed)
                if self._spec_proposed else 0.0,
            )
            gauge(
                "serving_spec_tokens_per_step",
                "Per-slot tokens emitted per verify dispatch "
                "(>1 means speculation is winning).",
                (self._spec_emitted / self._spec_rounds)
                if self._spec_rounds else 0.0,
            )
            counter(
                "serving_step_host_ms_total",
                "Host-side time inside engine step() (drafting, "
                "admission, event emission), ms, waits excluded.",
                f"{self._step_host_ms:.6g}",
            )
            counter(
                "serving_step_device_wait_ms_total",
                "Time the host spent blocked on device results "
                "(the step bubble), ms.",
                f"{self._step_device_wait_ms:.6g}",
            )
            counter(
                "serving_dispatches_total",
                "Device dispatches harvested.",
                self._step_dispatches,
            )
            gauge(
                "serving_step_overlap_ratio",
                "Fraction of device span hidden behind host work "
                "(~0 synchronous, toward 1 under async dispatch).",
                self._step_overlap_ratio,
            )
            counter(
                "serving_admission_stall_ms",
                "Time admissions blocked the step loop (prompt "
                "prefill + install), ms — the TTFT component "
                "interleaved chunked prefill shrinks.",
                f"{self._admission_stall_ms:.6g}",
            )
            counter(
                "serving_prefill_chunks_total",
                "Fused prefill+decode dispatches (interleaved "
                "chunked prefill).",
                self._prefill_chunks_total,
            )
            gauge(
                "serving_prefill_chunk_tokens",
                "prefill_chunk knob: prompt tokens budgeted per "
                "interleaved dispatch (0 = blocking admission).",
                self._prefill_chunk,
            )
            gauge(
                "serving_prefilling_slots",
                "Slots currently mid-prefill (partial write "
                "frontier short of the prompt end).",
                self._prefilling_slots,
            )
            gauge(
                "serving_paged_pool_occupancy",
                "Fraction of KV page pool in use (paged layout).",
                self._paged_occupancy,
            )
            gauge(
                "serving_paged_shared_ratio",
                "Fraction of used pages referenced by >1 run "
                "(copy-free prefix sharing).",
                self._paged_shared_ratio,
            )
            gauge(
                "serving_paged_used_pages",
                "KV pages currently allocated.",
                self._paged_used_pages,
            )
            gauge(
                "serving_paged_capacity_pages",
                "Allocatable KV pages (trash page excluded).",
                self._paged_capacity,
            )
            counter(
                "serving_paged_pages_allocated_total",
                "KV pages handed out.",
                self._paged_pages_allocated,
            )
            counter(
                "serving_paged_pages_freed_total",
                "KV pages returned to the free list.",
                self._paged_pages_freed,
            )
            counter(
                "serving_paged_pages_shared_total",
                "Page references added copy-free by prefix hits.",
                self._paged_pages_shared,
            )
            counter(
                "serving_paged_cow_copies_total",
                "Copy-on-write page copies (admission frontier only).",
                self._paged_cow_copies,
            )
            counter(
                "serving_paged_swap_preemptions_total",
                "Requests preempted-and-swapped to host under page "
                "pool pressure.",
                self._paged_swap_preemptions,
            )
            counter(
                "serving_paged_swap_resumes_total",
                "Preempted requests resumed by replay.",
                self._paged_swap_resumes,
            )
            gauge(
                "serving_kv_tier_bytes",
                "Host-DRAM KV tier bytes currently resident.",
                self._kv_tier_bytes,
            )
            gauge(
                "serving_kv_tier_capacity_bytes",
                "Host-DRAM KV tier capacity (0 = tier off).",
                self._kv_tier_capacity,
            )
            gauge(
                "serving_kv_tier_entries",
                "Entries (prefix rows + swap runs) in the host tier.",
                self._kv_tier_entries,
            )
            counter(
                "serving_kv_tier_demotions_total",
                "KV entries demoted device→host (evicted prefixes "
                "plus swapped-out victims).",
                self._kv_tier_demotions,
            )
            counter(
                "serving_kv_tier_promotions_total",
                "KV entries promoted host→device (prefix uploads "
                "plus swap-ins).",
                self._kv_tier_promotions,
            )
            counter(
                "serving_kv_tier_swap_outs_total",
                "Preempted page runs demoted to the host tier.",
                self._kv_tier_swap_outs,
            )
            counter(
                "serving_kv_tier_swap_ins_total",
                "Readmissions resumed from host-tier bytes instead "
                "of replay.",
                self._kv_tier_swap_ins,
            )
            counter(
                "serving_kv_tier_evictions_total",
                "Host-tier entries dropped by its byte-budget LRU.",
                self._kv_tier_evictions,
            )
            gauge(
                "serving_kv_tier_promote_hit_rate",
                "Fraction of tier lookups that found a promotable "
                "entry.",
                self._kv_tier_promote_hit_rate,
            )
            counter(
                "serving_kv_integrity_checks_total",
                "KV payload checksum verifications at tier/swap/"
                "handoff ingress.",
                self._kv_integrity_checks,
            )
            counter(
                "serving_kv_quarantines_total",
                "KV payloads quarantined on checksum mismatch "
                "(request fell back to replay).",
                self._kv_quarantines,
            )
            gauge(
                "serving_stragglers_flagged",
                "Replicas currently fenced by the straggler "
                "sentinel.",
                self._stragglers_flagged,
            )
            counter(
                "serving_stragglers_flagged_total",
                "Straggler fence events (EWMA over ratio x fleet "
                "median past patience).",
                self._stragglers_flagged_total,
            )
            counter(
                "serving_straggler_ejections_total",
                "Persistent stragglers escalated to breaker-open "
                "ejection.",
                self._straggler_ejections_total,
            )
            gauge(
                "serving_preflight_failed",
                "Replicas currently failing their preflight device "
                "self-check.",
                self._preflight_failed,
            )
            gauge(
                "serving_weight_bytes",
                "Served-weight bytes resident per device (the "
                "memory stream a decode step pays).",
                self._weight_bytes_device,
            )
            gauge(
                "serving_weight_quant_int8",
                "1 when the served matmul weights are per-block "
                "int8-quantized, 0 for full precision.",
                self._weight_quant_on,
            )
            lines.append(
                "# HELP serving_weight_quant_info Weight-quantization "
                "matmul path of this replica (info-style gauge)."
            )
            lines.append("# TYPE serving_weight_quant_info gauge")
            lines.append(
                f'serving_weight_quant_info'
                f'{{path="{self._weight_quant_path}"}} 1'
            )
            gauge(
                "serving_mesh_tp",
                "Tensor-parallel width of this replica's mesh slice.",
                self._mesh_tp,
            )
            gauge(
                "serving_replica_chips",
                "Devices this replica's mesh slice occupies.",
                self._replica_chips,
            )
            lines.append(
                "# HELP serving_kernel_path_steps_total Decode "
                "dispatches by attention body (paged-attention kernel "
                "vs reference)."
            )
            lines.append(
                "# TYPE serving_kernel_path_steps_total counter"
            )
            for path in ("kernel", "reference"):
                lines.append(
                    f'serving_kernel_path_steps_total{{path="{path}"}} '
                    f"{self._kernel_path_steps[path]}"
                )
            lines.append(
                "# HELP serving_handoff_total Prefill→decode KV "
                "migrations completed, by transport."
            )
            lines.append("# TYPE serving_handoff_total counter")
            for transport in ("device", "host"):
                lines.append(
                    f'serving_handoff_total{{transport="{transport}"}} '
                    f"{self._handoff_total[transport]}"
                )
            gauge(
                "serving_handoff_latency_ms",
                "Latency of the last prefill→decode migration "
                "(placement + adoption), ms.",
                self._handoff_last_ms,
            )
            lines.append(
                "# HELP serving_role_queue_depth Requests waiting, "
                "by replica role."
            )
            lines.append("# TYPE serving_role_queue_depth gauge")
            for role in ("prefill", "decode", "colocated"):
                lines.append(
                    f'serving_role_queue_depth{{role="{role}"}} '
                    f"{self._role_queue_depth[role]}"
                )
            lines.append(
                "# HELP serving_resize_total Live mesh resizes "
                "(chip loss shrink / probation grow-back), by "
                "direction."
            )
            lines.append("# TYPE serving_resize_total counter")
            for direction in ("shrink", "grow"):
                lines.append(
                    f'serving_resize_total{{direction="{direction}"}} '
                    f"{self._resize_total[direction]}"
                )
            lines.append(
                "# HELP serving_weight_refresh_total Live weight "
                "refreshes, by outcome."
            )
            lines.append("# TYPE serving_weight_refresh_total counter")
            for outcome in ("committed", "deferred", "rolled_back"):
                lines.append(
                    f'serving_weight_refresh_total'
                    f'{{outcome="{outcome}"}} '
                    f"{self._weight_refresh_total[outcome]}"
                )
            counter(
                "serving_resize_downtime_ms_total",
                "Cumulative quiesce-to-rebound downtime across live "
                "resizes, ms.",
                f"{self._resize_downtime_ms:.6g}",
            )
            gauge(
                "serving_weight_version",
                "Version of the currently served weights.",
                self._weight_version,
            )
            counter(
                "serving_replica_degradations_total",
                "Replicas that entered the degraded (shrunk-but-"
                "alive) state.",
                self._replica_degradations,
            )
            gauge(
                "serving_adapters_registered",
                "LoRA adapters in the registry.",
                self._adapter_registered,
            )
            gauge(
                "serving_adapter_bank_resident",
                "LoRA adapters resident in the device bank.",
                self._adapter_resident,
            )
            gauge(
                "serving_adapter_bank_pinned",
                "Resident adapters pinned by live requests.",
                self._adapter_pinned,
            )
            gauge(
                "serving_adapter_bank_slots",
                "Device adapter-bank cache slots.",
                self._adapter_slots,
            )
            gauge(
                "serving_adapter_active_requests",
                "Live requests decoding through an adapter.",
                self._adapter_active,
            )
            counter(
                "serving_adapter_cache_hits_total",
                "Adapter admissions served from the device bank.",
                self._adapter_hits,
            )
            counter(
                "serving_adapter_cache_misses_total",
                "Adapter admissions that required an upload.",
                self._adapter_misses,
            )
            counter(
                "serving_adapter_cache_evictions_total",
                "Adapter bank slots recycled (LRU).",
                self._adapter_evictions,
            )
            counter(
                "serving_adapter_uploads_total",
                "Host-to-device adapter weight uploads.",
                self._adapter_uploads,
            )
            counter(
                "serving_affinity_matched_total",
                "Requests routed to a replica advertising a digest "
                "of their prompt prefix.",
                self._affinity_matched,
            )
            counter(
                "serving_affinity_unmatched_total",
                "Requests routed with no usable digest match "
                "(least-loaded fallback).",
                self._affinity_unmatched,
            )
            counter(
                "serving_affinity_capped_total",
                "Digest matches voided by the imbalance cap (spilled "
                "to a cooler replica).",
                self._affinity_capped,
            )
            gauge(
                "serving_fleet_digest_map_digests",
                "Distinct prefix digests in the fleet digest map.",
                self._digest_map_digests,
            )
            lines.append(
                "# HELP serving_forecast_events_total Predictive "
                "scale hints emitted by the demand forecast, by "
                "direction."
            )
            lines.append(
                "# TYPE serving_forecast_events_total counter"
            )
            for direction in ("up", "down"):
                lines.append(
                    f'serving_forecast_events_total'
                    f'{{direction="{direction}"}} '
                    f"{self._forecast_events[direction]}"
                )
            gauge(
                "serving_forecast_chip_demand",
                "Chip-denominated demand of the latest forecast "
                "hint.",
                self._forecast_chip_demand,
            )
        # rate gauge takes the lock itself — outside the block above
        tps = self.tokens_per_sec()
        return "\n".join(
            lines
            + [
                "# HELP serving_tokens_per_sec "
                "Token emission rate (10s horizon).",
                "# TYPE serving_tokens_per_sec gauge",
                f"serving_tokens_per_sec {tps:.6g}",
                "",
            ]
        )
