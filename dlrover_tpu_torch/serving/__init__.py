"""The serving stack — the counterpart of dlrover_tpu/serving/,
exporting the same public names (an engine spans one device or a
tensor-parallel slice, `mesh_spec`):

  gateway.py   — the stdlib HTTP front door: streaming NDJSON
                 generation, /healthz, Prometheus /metrics
  replica.py   — replicas registered in the master KV store, the pool
                 that health-checks them (circuit breakers, probation,
                 straggler fencing) and routes across them (phase tier,
                 prefix affinity, adapter residency, load), failover
                 and handoff wiring, scale hints and the brain forecast
  scheduler.py — SLO-aware admission control, per-tier EDF dispatch,
                 aging, tier preemption and deadline shedding over the
                 engine's slot bank
  engine.py    — the continuous-batching generation engine
                 (`ContinuousBatcher`, alias `GenerationEngine`)
  handoff.py   — prefill/decode KV packages and the coordinator that
                 places them on decode replicas
  metrics.py   — TTFT/TPOT/queue-depth counters, Prometheus exposition
  failover.py  — per-request resume journal, circuit breaker, crash
                 evacuation by replaying prompt+emitted
  workload.py  — seed-driven production-trace generator
  affinity.py  — prefix digests, the fleet digest map and the affinity
                 order
  prefix_cache.py, speculative.py, adapters.py, chaos.py, kv_tier.py,
  health.py    — prefix reuse, n-gram drafting, multi-adapter LoRA,
                 fault injection, the host KV tier, the health sentinel
"""

from dlrover_tpu_torch.serving.affinity import (
    FleetDigestMap,
    affinity_order,
    cache_digests,
    prefix_digest_chain,
)
from dlrover_tpu_torch.serving.adapters import (
    AdapterCacheFull,
    AdapterRegistry,
    DeviceAdapterCache,
)
from dlrover_tpu_torch.serving.chaos import (
    ChaosError,
    ChaosKV,
    FaultInjector,
    ReplicaCrashed,
)
from dlrover_tpu_torch.serving.engine import (
    ContinuousBatcher,
    GenerationEngine,
)
from dlrover_tpu_torch.serving.failover import (
    CircuitBreaker,
    FailoverManager,
    RequestJournal,
    ResumeTicket,
)
from dlrover_tpu_torch.serving.metrics import ServingMetrics
from dlrover_tpu_torch.serving.prefix_cache import RadixPrefixCache
from dlrover_tpu_torch.serving.scheduler import (
    TIERS,
    AdmissionError,
    RequestScheduler,
    RequestState,
    ServeRequest,
    SloConfig,
)
from dlrover_tpu_torch.serving.speculative import (
    NgramDrafter,
    SpecController,
    SpeculativeDecoder,
)
from dlrover_tpu_torch.serving.replica import (
    InferenceReplica,
    NoHealthyReplicasError,
    ReplicaPool,
)
from dlrover_tpu_torch.serving.gateway import ServingGateway
from dlrover_tpu_torch.serving.workload import (
    SessionBook,
    Trace,
    TraceEvent,
    WorkloadConfig,
    generate_trace,
)

__all__ = [
    "AdapterCacheFull",
    "AdapterRegistry",
    "AdmissionError",
    "ChaosError",
    "ChaosKV",
    "CircuitBreaker",
    "ContinuousBatcher",
    "DeviceAdapterCache",
    "FailoverManager",
    "FaultInjector",
    "FleetDigestMap",
    "GenerationEngine",
    "InferenceReplica",
    "NgramDrafter",
    "NoHealthyReplicasError",
    "RadixPrefixCache",
    "ReplicaCrashed",
    "ReplicaPool",
    "RequestJournal",
    "RequestScheduler",
    "RequestState",
    "ResumeTicket",
    "ServeRequest",
    "ServingGateway",
    "ServingMetrics",
    "SessionBook",
    "SloConfig",
    "SpecController",
    "SpeculativeDecoder",
    "TIERS",
    "Trace",
    "TraceEvent",
    "WorkloadConfig",
    "affinity_order",
    "cache_digests",
    "generate_trace",
    "prefix_digest_chain",
]
