"""The serving stack on one card — the counterpart of
dlrover_tpu/serving/, exporting the same public names, limited to what
the port has:

  scheduler.py — SLO-aware admission control, per-tier EDF dispatch,
                 aging, tier preemption and deadline shedding over the
                 engine's slot bank
  engine.py    — the continuous-batching generation engine
  metrics.py   — TTFT/TPOT/queue-depth counters, Prometheus exposition
  failover.py  — per-request resume journal, circuit breaker, crash
                 evacuation by replaying prompt+emitted
  workload.py  — seed-driven production-trace generator
  prefix_cache.py, speculative.py, adapters.py, chaos.py, affinity.py
               — prefix reuse, n-gram drafting, multi-adapter LoRA,
                 fault injection, prefix digests

The replica pool and the HTTP gateway (`replica.py`, `gateway.py`) and
the fleet digest map are not ported yet.
"""

from dlrover_tpu_torch.serving.affinity import (
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
from dlrover_tpu_torch.serving.engine import ContinuousBatcher
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
    "NgramDrafter",
    "RadixPrefixCache",
    "ReplicaCrashed",
    "RequestJournal",
    "RequestScheduler",
    "RequestState",
    "ResumeTicket",
    "ServeRequest",
    "ServingMetrics",
    "SessionBook",
    "SloConfig",
    "SpecController",
    "SpeculativeDecoder",
    "TIERS",
    "Trace",
    "TraceEvent",
    "WorkloadConfig",
    "cache_digests",
    "generate_trace",
    "prefix_digest_chain",
]
