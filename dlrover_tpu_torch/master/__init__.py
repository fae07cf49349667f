"""The master's coordination store — the counterpart of
dlrover_tpu/master/, limited to the KV verbs the serving replica pool
speaks (`kv_store.py`). The job master, its gRPC servicer and the
named sync barriers are not ported."""

from dlrover_tpu_torch.master.kv_store import (
    KVStoreService,
    PrefixDirectory,
    RetryingKV,
)

__all__ = ["KVStoreService", "PrefixDirectory", "RetryingKV"]
