"""Brain optimize algorithms — a copy of dlrover_tpu/brain/algorithms.py
(stdlib only), all ten registered; the replica pool's
`predictive_scale` runs `optimize_serving_replica_resource`.

One algorithm per (role, job stage).

Reference parity: dlrover/go/brain/pkg/optimizer/implementation/
optalgorithm/*.go — nine registered algorithms keyed by name:
ps create / cold-create / init-adjust / hot-adjust / oom / util,
worker create / create-oom / running-resource. Each takes the job's
persisted metrics and returns a resource plan delta.

TPU framing: "ps" = host-side embedding-shard servers (KvEmbedding),
"worker" = TPU hosts. CPU/memory heuristics carry over directly; worker
*count* decisions respect whole-host granularity and are driven by
per-host goodput exactly like the master's local optimizer."""

import statistics
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from dlrover_tpu_torch.brain.datastore import JobMetricsStore, RuntimeSample

# tuning constants (reference values from optalgorithm/*.go, rounded)
HOT_PS_CPU_THRESHOLD = 80.0       # % util that marks a PS "hot"
HOT_PS_CPU_TARGET = 50.0          # rebalance target after scale-up
OOM_MEMORY_FACTOR = 1.5
COLD_PS_DEFAULT_CPU = 8.0
COLD_PS_DEFAULT_MEM_MB = 8 * 1024
COLD_WORKER_DEFAULT_COUNT = 2
UTIL_LOW_THRESHOLD = 0.3          # sustained low util → shrink
DEGRADE_THRESHOLD = 0.85

# serving forecast (role="serving", fed by the replica pool's
# publish_telemetry): pressure is queue load normalized per replica
# capacity in [0, 1+] — scale ahead of the spike the trend predicts
SERVING_PRESSURE_HIGH = 0.8       # forecast above this → scale up
SERVING_PRESSURE_LOW = 0.15       # forecast below this → scale down
SERVING_PRESSURE_TARGET = 0.5     # size the move to land here
SERVING_FORECAST_HORIZON_S = 30.0  # how far ahead the trend is read
SERVING_EWMA_ALPHA = 0.4          # smoothing weight for the level
SERVING_MIN_WINDOW = 3            # samples before forecasting at all


@dataclass
class ResourceDelta:
    """What an algorithm suggests for one role group."""

    role: str = "worker"
    count: Optional[int] = None
    cpu: Optional[float] = None
    memory_mb: Optional[int] = None
    reason: str = ""
    # chip denomination (serving forecast): count × chips_per_replica
    # — what a chip-budgeted operator reads; None for training roles
    chips: Optional[int] = None

    @property
    def empty(self) -> bool:
        return self.count is None and self.cpu is None and (
            self.memory_mb is None
        )


@dataclass
class OptimizeContext:
    job_uuid: str
    store: JobMetricsStore
    current: Dict[str, Dict] = field(default_factory=dict)
    # current = {"worker": {"count": 4, "cpu": 8, "memory_mb": 16384}, ...}


Algorithm = Callable[[OptimizeContext], ResourceDelta]
ALGORITHMS: Dict[str, Algorithm] = {}


def register(name: str):
    def deco(fn: Algorithm) -> Algorithm:
        ALGORITHMS[name] = fn
        return fn

    return deco


def run_algorithm(name: str, ctx: OptimizeContext) -> ResourceDelta:
    if name not in ALGORITHMS:
        raise KeyError(f"unknown optimize algorithm: {name}")
    return ALGORITHMS[name](ctx)


def _latest(
    samples: List[RuntimeSample], n: int = 5
) -> List[RuntimeSample]:
    return samples[:n]  # store returns newest-first


# ---- PS (embedding host) algorithms ---------------------------------------


@register("optimize_job_ps_create_resource")
def ps_create(ctx: OptimizeContext) -> ResourceDelta:
    """Initial PS resources from similar completed jobs' peaks."""
    me = ctx.store.get_job(ctx.job_uuid)
    history = ctx.store.similar_jobs(
        me.job_name if me else "", me.user if me else ""
    )
    peaks_mem, need_cpu, counts = [], [], []
    for job in history:
        ss = ctx.store.samples(job.job_uuid, role="ps")
        if not ss:
            continue
        peaks_mem.append(max(s.memory_mb for s in ss))
        counts.append(max(s.num_nodes for s in ss))
        # utilization is a fraction of that job's ACTUAL allocation
        alloc = (
            ctx.store.job_resources(job.job_uuid)
            .get("ps", {})
            .get("cpu", COLD_PS_DEFAULT_CPU)
        )
        peak_pct = max(s.cpu_percent for s in ss)
        need_cpu.append(peak_pct / 100.0 * float(alloc))
    if not peaks_mem:
        return ps_cold_create(ctx)
    return ResourceDelta(
        role="ps",
        count=int(statistics.median(counts)),
        cpu=float(statistics.median(need_cpu)) * 1.2,
        memory_mb=int(statistics.median(peaks_mem) * 1.2),
        reason="sized from similar historical jobs",
    )


@register("optimize_job_ps_cold_create_resource")
def ps_cold_create(ctx: OptimizeContext) -> ResourceDelta:
    """No history: conservative defaults (cold-start plan)."""
    return ResourceDelta(
        role="ps",
        count=max(ctx.current.get("ps", {}).get("count", 1), 1),
        cpu=COLD_PS_DEFAULT_CPU,
        memory_mb=COLD_PS_DEFAULT_MEM_MB,
        reason="cold start defaults",
    )


@register("optimize_job_ps_init_adjust_resource")
def ps_init_adjust(ctx: OptimizeContext) -> ResourceDelta:
    """After the first runtime stats: right-size memory to observed
    usage with headroom (the init-adjust stage)."""
    ss = _latest(ctx.store.samples(ctx.job_uuid, role="ps"))
    if not ss:
        return ResourceDelta(role="ps")
    peak_mem = max(s.memory_mb for s in ss)
    cur = ctx.current.get("ps", {})
    want = int(peak_mem * 1.5)
    if cur.get("memory_mb") and want >= cur["memory_mb"]:
        return ResourceDelta(role="ps")
    return ResourceDelta(
        role="ps",
        memory_mb=want,
        reason=f"init adjust to observed peak {peak_mem:.0f}MB x1.5",
    )


@register("optimize_job_hot_ps_resource")
def hot_ps(ctx: OptimizeContext) -> ResourceDelta:
    """Sustained hot PS CPU → add PS shards to spread the hash ranges."""
    ss = _latest(ctx.store.samples(ctx.job_uuid, role="ps"))
    if not ss:
        return ResourceDelta(role="ps")
    avg_cpu = statistics.mean(s.cpu_percent for s in ss)
    if avg_cpu < HOT_PS_CPU_THRESHOLD:
        return ResourceDelta(role="ps")
    cur_count = max(
        ctx.current.get("ps", {}).get("count", ss[0].num_nodes), 1
    )
    target = max(
        cur_count + 1,
        int(round(cur_count * avg_cpu / HOT_PS_CPU_TARGET)),
    )
    return ResourceDelta(
        role="ps",
        count=target,
        reason=f"hot ps: avg cpu {avg_cpu:.0f}% >= "
        f"{HOT_PS_CPU_THRESHOLD:.0f}%",
    )


@register("optimize_job_ps_oom_resource")
def ps_oom(ctx: OptimizeContext) -> ResourceDelta:
    """PS OOMed → multiply memory."""
    cur = ctx.current.get("ps", {})
    base = cur.get("memory_mb", COLD_PS_DEFAULT_MEM_MB)
    return ResourceDelta(
        role="ps",
        memory_mb=int(base * OOM_MEMORY_FACTOR),
        reason="ps oom recovery",
    )


@register("optimize_job_ps_resource_util")
def ps_util(ctx: OptimizeContext) -> ResourceDelta:
    """Sustained low utilization → shrink allocation."""
    ss = _latest(
        ctx.store.samples(ctx.job_uuid, role="ps"), n=10
    )
    cur = ctx.current.get("ps", {})
    if len(ss) < 5 or not cur.get("memory_mb"):
        return ResourceDelta(role="ps")
    peak_mem = max(s.memory_mb for s in ss)
    util = peak_mem / cur["memory_mb"]
    if util >= UTIL_LOW_THRESHOLD:
        return ResourceDelta(role="ps")
    return ResourceDelta(
        role="ps",
        memory_mb=int(max(peak_mem * 2, 1024)),
        reason=f"memory util {util:.0%} < {UTIL_LOW_THRESHOLD:.0%}",
    )


# ---- worker (TPU host) algorithms -----------------------------------------


@register("optimize_job_worker_create_resource")
def worker_create(ctx: OptimizeContext) -> ResourceDelta:
    """Initial worker count from similar jobs' best goodput size."""
    me = ctx.store.get_job(ctx.job_uuid)
    history = ctx.store.similar_jobs(
        me.job_name if me else "", me.user if me else ""
    )
    best_counts = []
    for job in history:
        ss = ctx.store.samples(job.job_uuid, role="worker")
        if not ss:
            continue
        best = max(
            ss,
            key=lambda s: s.samples_per_sec / max(s.num_nodes, 1),
        )
        best_counts.append(best.num_nodes)
    if not best_counts:
        return ResourceDelta(
            role="worker",
            count=COLD_WORKER_DEFAULT_COUNT,
            reason="cold start worker count",
        )
    return ResourceDelta(
        role="worker",
        count=int(statistics.median(best_counts)),
        reason="best-goodput size of similar jobs",
    )


@register("optimize_job_worker_create_oom_resource")
def worker_create_oom(ctx: OptimizeContext) -> ResourceDelta:
    """Worker OOMed at startup → more host memory."""
    cur = ctx.current.get("worker", {})
    base = cur.get("memory_mb", 8 * 1024)
    return ResourceDelta(
        role="worker",
        memory_mb=int(base * OOM_MEMORY_FACTOR),
        reason="worker oom recovery",
    )


@register("optimize_job_worker_resource")
def worker_running(ctx: OptimizeContext) -> ResourceDelta:
    """Runtime worker-count tuning by per-host goodput (same rule as
    the master's local optimizer, but over the persisted series)."""
    ss = ctx.store.samples(ctx.job_uuid, role="worker", limit=50)
    if len(ss) < 2:
        return ResourceDelta(role="worker")
    latest = ss[0]
    best = max(
        ss, key=lambda s: s.samples_per_sec / max(s.num_nodes, 1)
    )
    per_latest = latest.samples_per_sec / max(latest.num_nodes, 1)
    per_best = best.samples_per_sec / max(best.num_nodes, 1)
    if (
        latest.num_nodes > best.num_nodes
        and per_latest < per_best * DEGRADE_THRESHOLD
    ):
        return ResourceDelta(
            role="worker",
            count=best.num_nodes,
            reason="scaling degraded per-host goodput; fall back",
        )
    if latest.num_nodes == best.num_nodes and per_latest >= per_best:
        return ResourceDelta(
            role="worker",
            count=latest.num_nodes + 1,
            reason="linear scaling so far; probe one more host",
        )
    return ResourceDelta(role="worker")


# ---- serving (inference replica) algorithms -------------------------------


def _ewma(values: List[float], alpha: float) -> float:
    """Exponentially-weighted level over values in time order."""
    level = values[0]
    for v in values[1:]:
        level = alpha * v + (1.0 - alpha) * level
    return level


def _slope(ts: List[float], values: List[float]) -> float:
    """Least-squares slope of values over ts (units per second);
    0 when the window is degenerate (single instant)."""
    n = len(ts)
    mean_t = sum(ts) / n
    mean_v = sum(values) / n
    var_t = sum((t - mean_t) ** 2 for t in ts)
    if var_t <= 0.0:
        return 0.0
    cov = sum(
        (t - mean_t) * (v - mean_v) for t, v in zip(ts, values)
    )
    return cov / var_t


@register("optimize_serving_replica_resource")
def serving_forecast(ctx: OptimizeContext) -> ResourceDelta:
    """Short-horizon demand forecast for the serving replica fleet:
    EWMA level + least-squares slope over the pool's telemetry
    window, extrapolated SERVING_FORECAST_HORIZON_S ahead, emitted as
    a chip-denominated delta — the predictive half of the fleet front
    door (the reactive half is the pool's queue-pressure hint). The
    point is to move BEFORE the spike: a rising trend that will cross
    SERVING_PRESSURE_HIGH at the horizon scales up while the current
    pressure still looks fine, and the scale-down leg is deliberately
    conservative (sustained LOW forecast, never on slope alone) so
    the forecast cannot flap against elastic shrink/grow — the
    advisor's hysteresis is the second gate."""
    ss = ctx.store.samples(ctx.job_uuid, role="serving", limit=64)
    if len(ss) < SERVING_MIN_WINDOW:
        return ResourceDelta(role="serving")
    ss = list(reversed(ss))  # store returns newest-first
    ts = [s.ts for s in ss]
    pressure = [s.cpu_percent / 100.0 for s in ss]
    level = _ewma(pressure, SERVING_EWMA_ALPHA)
    trend = _slope(ts, pressure)
    forecast = level + trend * SERVING_FORECAST_HORIZON_S
    cur = ctx.current.get("serving", {})
    n = max(int(cur.get("count", 1)), 1)
    cpr = max(int(cur.get("chips_per_replica", 1)), 1)
    if forecast > SERVING_PRESSURE_HIGH:
        # size the move so forecast demand lands at the target:
        # demand scales ~1/replicas at fixed arrival rate
        target = max(
            n + 1,
            -(-int(n * forecast * 1000)
              // int(SERVING_PRESSURE_TARGET * 1000)),
        )
        return ResourceDelta(
            role="serving",
            count=target,
            chips=target * cpr,
            reason=(
                f"forecast pressure {forecast:.2f} > "
                f"{SERVING_PRESSURE_HIGH} at +"
                f"{SERVING_FORECAST_HORIZON_S:.0f}s "
                f"(level {level:.2f}, slope {trend:+.4f}/s)"
            ),
        )
    if (
        n > 1
        and forecast < SERVING_PRESSURE_LOW
        and level < SERVING_PRESSURE_LOW
        and trend <= 0.0
    ):
        target = max(1, n - 1)
        return ResourceDelta(
            role="serving",
            count=target,
            chips=target * cpr,
            reason=(
                f"sustained low forecast {forecast:.2f} < "
                f"{SERVING_PRESSURE_LOW} (level {level:.2f}, "
                f"slope {trend:+.4f}/s)"
            ),
        )
    return ResourceDelta(role="serving")
