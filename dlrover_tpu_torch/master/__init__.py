"""The job master — the counterpart of dlrover_tpu/master/ as it runs
in one process: `master.py` (`JobMaster`, `LocalJobMaster`) hosting
`servicer.py` over the stdlib transport of `common/comm.py`, with the
node manager, rendezvous, dynamic data sharding (`shard/`), the speed
and error monitors, the KV store and sync barriers, elastic PS
versioning, topology and the metric collector. The KV verbs the serving
replica pool speaks are in `kv_store.py`."""

from dlrover_tpu_torch.master.kv_store import (
    KVStoreService,
    PrefixDirectory,
    RetryingKV,
    SyncService,
)

__all__ = ["KVStoreService", "PrefixDirectory", "RetryingKV", "SyncService"]
