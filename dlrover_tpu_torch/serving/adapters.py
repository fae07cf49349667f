"""Multi-adapter LoRA serving — counterpart of
dlrover_tpu/serving/adapters.py: the host registry and the stacked
device adapter bank behind `ContinuousBatcher(adapter_registry=...)`.

Adapters live in a STACKED device bank — per attention target `t` a
pair `t_a [L, S, in, r]` / `t_b [L, S, r, out]` plus a `scale [S]`
vector, where S = `cache_slots` + 1 and slot 0 holds the all-zero
adapter — and every forward gathers each batch row's slices by the
engine's per-slot index vector, adding `scale[idx] * (x @ A[idx]) @
B[idx]` inside the projections (models/llama._slot_lora_delta), the
S-LoRA / Punica way. Heterogeneous adapters batch through ONE base-model
forward; `adapter_id=None` rows ride slot 0 and stay byte-identical to
the adapterless engine.

- `AdapterRegistry`: host-side store of adapter trees (numpy arrays),
  shared by every engine in a process; registration validates targets
  and shapes against the model config up front.
- `DeviceAdapterCache`: one per engine, the stacked bank and an LRU of
  which adapters occupy its slots. A slot is PINNED while any ledger
  entry references it (acquire/release refcounts) and only unpinned
  slots evict, least-recently-used first. The bank is allocated once
  and written in place; on the card an upload stages through
  page-locked host memory and copies without synchronizing the stream,
  ordered after any dispatch already enqueued (and eviction never takes
  a pinned slot, so no in-flight dispatch gathers a slot being
  written). On a tensor-parallel slice (`mesh`, tp > 1) the bank is
  placed by `parallel/mesh.serving_adapter_specs` (JAX engine
  `_adapter_bank_place`): wq/wk/wv's B banks split on their output
  columns (parallel/sharding.Sharded), the A banks, the wo pair and the
  scales replicated on the mesh's home device.
"""

import collections
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from dlrover_tpu_torch._device import DeviceLike, resolve_device
from dlrover_tpu_torch.models.lora import LORA_A, LORA_B, adapter_base

Params = Dict[str, Any]

# the serving bank covers the attention projections: the defaults of
# LoraConfig.targets and the only targets the decode delta path gathers
SERVING_TARGETS = ("wq", "wk", "wv", "wo")


class AdapterCacheFull(RuntimeError):
    """Every device cache slot is pinned by a live request: the caller
    keeps the request queued and retries after a release."""


def _target_dims(cfg) -> Dict[str, Tuple[int, int]]:
    """(in, out) of each attention projection: what adapter shapes must
    match and what the zero bank is sized from."""
    heads = cfg.n_heads
    kv = getattr(cfg, "n_kv_heads", None) or cfg.n_heads
    hd = cfg.head_dim
    return {
        "wq": (cfg.dim, heads * hd),
        "wk": (cfg.dim, kv * hd),
        "wv": (cfg.dim, kv * hd),
        "wo": (heads * hd, cfg.dim),
    }


def _host(v) -> np.ndarray:
    """A host numpy array of an adapter leaf (numpy, or a torch tensor
    on any device)."""
    if torch.is_tensor(v):
        return v.detach().float().cpu().numpy()
    return np.asarray(v)


class _HostAdapter:
    """One registered adapter: per-target host arrays + its scale."""

    __slots__ = ("a", "b", "rank", "scale", "version")

    def __init__(self, a, b, rank, scale, version):
        self.a = a          # {target: np [L, in, r]} (missing = zero)
        self.b = b          # {target: np [L, r, out]}
        self.rank = rank
        self.scale = scale  # alpha / rank
        self.version = version


class AdapterRegistry:
    """Host-side adapter store, safe to share across threads. Holds
    nothing on the device: residency is each engine's
    DeviceAdapterCache."""

    def __init__(self, cfg, max_rank: int = 8):
        if max_rank < 1:
            raise ValueError(f"max_rank must be >= 1, got {max_rank}")
        self.cfg = cfg
        self.max_rank = int(max_rank)
        self._dims = _target_dims(cfg)
        self._lock = threading.Lock()
        self._store: Dict[str, _HostAdapter] = {}
        self._version = 0

    def _validate(self, adapter_id, adapters):
        """Shape-check an adapter tree against the model config; returns
        ({target: a}, {target: b}, rank). A pure function of the
        arguments, called outside the lock."""
        if not isinstance(adapter_id, str) or not adapter_id:
            raise ValueError(
                f"adapter_id must be a non-empty string, got "
                f"{adapter_id!r}"
            )
        layers = adapters.get("layers") if isinstance(
            adapters, dict
        ) else None
        if not isinstance(layers, dict) or not layers:
            raise ValueError(
                "adapters must be an adapter_state_dict-style tree "
                "{'layers': {'<t>_lora_a': ..., '<t>_lora_b': ...}}"
            )
        a_arrs: Dict[str, np.ndarray] = {}
        b_arrs: Dict[str, np.ndarray] = {}
        for k, v in layers.items():
            if LORA_A in k:
                dest = a_arrs
            elif LORA_B in k:
                dest = b_arrs
            else:
                raise ValueError(
                    f"{k!r} is not an adapter leaf (expected "
                    f"'<target>{LORA_A}' / '<target>{LORA_B}')"
                )
            t = adapter_base(k)
            if t not in self._dims:
                raise ValueError(
                    f"adapter target {t!r} is not servable — the "
                    f"device bank covers {SERVING_TARGETS}"
                )
            dest[t] = _host(v)
        rank = None
        for t in sorted(set(a_arrs) | set(b_arrs)):
            if t not in a_arrs or t not in b_arrs:
                raise ValueError(
                    f"adapter target {t!r} is missing half its A/B pair"
                )
            d_in, d_out = self._dims[t]
            a, b = a_arrs[t], b_arrs[t]
            want_a = (self.cfg.n_layers, d_in)
            if a.ndim != 3 or (a.shape[0], a.shape[1]) != want_a:
                raise ValueError(
                    f"{t}{LORA_A} must be [L={want_a[0]}, "
                    f"in={want_a[1]}, r], got {a.shape}"
                )
            want_b = (self.cfg.n_layers, d_out)
            if b.ndim != 3 or (b.shape[0], b.shape[2]) != want_b:
                raise ValueError(
                    f"{t}{LORA_B} must be [L={want_b[0]}, r, "
                    f"out={want_b[1]}], got {b.shape}"
                )
            r = a.shape[2]
            if b.shape[1] != r:
                raise ValueError(f"{t}: A rank {r} != B rank {b.shape[1]}")
            if rank is None:
                rank = r
            elif r != rank:
                raise ValueError(
                    f"mixed ranks across targets ({rank} vs {r}): "
                    "the stacked bank scales per SLOT, so one "
                    "adapter must use one rank"
                )
        if rank > self.max_rank:
            raise ValueError(
                f"adapter rank {rank} exceeds the bank's max_rank "
                f"{self.max_rank} (registry knob)"
            )
        return a_arrs, b_arrs, rank

    def register(
        self, adapter_id: str, adapters: Params, alpha: float = 16.0
    ) -> int:
        """Validate and store an adapter tree (`lora.adapter_state_dict`
        form); returns its version. Re-registering an id bumps the
        version: device caches re-upload on their next acquire."""
        a_arrs, b_arrs, rank = self._validate(adapter_id, adapters)
        with self._lock:
            self._version += 1
            rec = _HostAdapter(
                a_arrs, b_arrs, rank, float(alpha) / rank, self._version,
            )
            self._store[adapter_id] = rec
            return rec.version

    def unregister(self, adapter_id: str) -> None:
        with self._lock:
            if adapter_id not in self._store:
                raise KeyError(f"unknown adapter {adapter_id!r}")
            del self._store[adapter_id]

    def get(self, adapter_id: str) -> _HostAdapter:
        with self._lock:
            rec = self._store.get(adapter_id)
        if rec is None:
            raise KeyError(f"unknown adapter {adapter_id!r}")
        return rec

    def __contains__(self, adapter_id) -> bool:
        with self._lock:
            return adapter_id in self._store

    def ids(self):
        with self._lock:
            return sorted(self._store)

    def __len__(self) -> int:
        with self._lock:
            return len(self._store)

    def version(self, adapter_id: str) -> int:
        return self.get(adapter_id).version


def init_adapter_bank(
    cfg, cache_slots: int, max_rank: int, dtype: torch.dtype,
    device: DeviceLike = None,
) -> Dict[str, torch.Tensor]:
    """The stacked zero bank on `device`: per target `t_a [L, S, in,
    max_rank]` and `t_b [L, S, max_rank, out]` in `dtype`, plus `scale
    [S]` f32, with S = cache_slots + 1 and slot 0 the permanent zero
    adapter. Rank padding is delta-exact: zero columns of A contribute
    zero to `x @ A`, zero rows of B multiply them by zero again."""
    dev = resolve_device(device)
    s = cache_slots + 1
    bank: Dict[str, torch.Tensor] = {}
    for t, (d_in, d_out) in _target_dims(cfg).items():
        bank[t + "_a"] = torch.zeros((cfg.n_layers, s, d_in, max_rank),
                                     dtype=dtype, device=dev)
        bank[t + "_b"] = torch.zeros((cfg.n_layers, s, max_rank, d_out),
                                     dtype=dtype, device=dev)
    bank["scale"] = torch.zeros((s,), dtype=torch.float32, device=dev)
    return bank


def _to_device(arr: np.ndarray, dtype: torch.dtype, device: torch.device):
    """A host array on `device` in `dtype`, cast on the host (float32 ->
    bfloat16 rounds to nearest even, as the JAX upload's astype does).
    On the card through page-locked memory and a non-blocking copy: the
    stream is not synchronized, and torch's host allocator reuses the
    page-locked block only after that copy has completed."""
    t = torch.from_numpy(np.ascontiguousarray(arr)).to(dtype)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def place_adapter_bank(bank: Dict[str, torch.Tensor], mesh=None):
    """The bank laid out over a serving mesh by `serving_adapter_specs`
    (the split B banks as Sharded, the rest on mesh.home); the bank as
    it is without a mesh of tp > 1."""
    if mesh is None or mesh.tp == 1:
        return bank
    from dlrover_tpu_torch.parallel.mesh import serving_adapter_specs
    from dlrover_tpu_torch.parallel.sharding import replicated, split_leaf

    specs = serving_adapter_specs(mesh)
    out = {}
    for name, arr in bank.items():
        dim = specs[name].split_dim()
        out[name] = (replicated(arr, mesh) if dim is None
                     else split_leaf(arr, mesh, dim))
    return out


def _bank_tensors(arr):
    """The device tensors holding one bank array: itself, a sharded
    array's whole, or its pieces."""
    from dlrover_tpu_torch.parallel.sharding import Sharded

    if not isinstance(arr, Sharded):
        return [arr]
    return [arr.whole] if arr.whole is not None else list(arr.shards)


def _bank_slot_write(bank: Dict[str, torch.Tensor], update, slot: int):
    """Write one adapter's stacked slices into bank slot `slot`, in
    place (the bank is never reallocated). `update` holds each array's
    [L, ...] slab as host numpy and the scale as a float. A sharded B
    bank takes each piece's columns of the slab."""
    for name, arr in bank.items():
        pieces = _bank_tensors(arr)
        if pieces[0].ndim == 1:  # the scale vector
            pieces[0][slot].fill_(float(update[name]))
            continue
        slabs = [update[name]]
        if len(pieces) > 1:
            slabs = np.split(update[name], len(pieces), axis=-1)
        for t, slab in zip(pieces, slabs):
            t[:, slot].copy_(_to_device(slab, t.dtype, t.device))
    return bank


class DeviceAdapterCache:
    """Per-engine device residency for registered adapters: the stacked
    bank plus an LRU slot map with pinned-while-referenced eviction (the
    prefix pool's refcount discipline). Single-threaded, as the engine
    is, so no lock lives here."""

    def __init__(
        self,
        cfg,
        registry: AdapterRegistry,
        cache_slots: int,
        dtype: Optional[torch.dtype] = None,
        device: DeviceLike = None,
        mesh=None,
    ):
        if cache_slots < 1:
            raise ValueError(
                f"adapter_cache_slots must be >= 1, got {cache_slots}"
            )
        self.cfg = cfg
        self.registry = registry
        self.cache_slots = int(cache_slots)
        self.max_rank = registry.max_rank
        self._dims = _target_dims(cfg)
        self._dtype = dtype if dtype is not None else cfg.dtype
        self.device = resolve_device(device)
        self.mesh = mesh
        self.bank = place_adapter_bank(init_adapter_bank(
            cfg, self.cache_slots, self.max_rank, self._dtype, self.device
        ), mesh)
        # id -> device slot, insertion order == recency (LRU front)
        self._resident: "collections.OrderedDict[str, int]" = (
            collections.OrderedDict()
        )
        self._uploaded_version: Dict[str, int] = {}
        self._pins: collections.Counter = collections.Counter()
        self._free = list(range(self.cache_slots, 0, -1))  # pop() -> 1
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.uploads = 0

    # -- residency -----------------------------------------------------

    def acquire(self, adapter_id: Optional[str]) -> int:
        """Pin `adapter_id` into the bank and return its device slot (0
        for None: the zero adapter needs no pin). Uploads on a miss or a
        stale version; raises KeyError for an unregistered id and
        AdapterCacheFull when every slot is pinned."""
        if adapter_id is None:
            return 0
        rec = self.registry.get(adapter_id)
        slot = self._resident.get(adapter_id)
        if (
            slot is not None
            and self._uploaded_version.get(adapter_id) == rec.version
        ):
            self.hits += 1
            self._resident.move_to_end(adapter_id)
            self._pins[adapter_id] += 1
            return slot
        self.misses += 1
        if slot is None:
            slot = self._take_slot()
            self._resident[adapter_id] = slot
        else:  # re-registered under the same id: refresh in place
            self._resident.move_to_end(adapter_id)
        self._upload(slot, rec)
        self._uploaded_version[adapter_id] = rec.version
        self._pins[adapter_id] += 1
        return slot

    def release(self, adapter_id: Optional[str]) -> None:
        """Drop one pin. The adapter STAYS resident (that is the cache);
        it only becomes evictable."""
        if adapter_id is None:
            return
        if self._pins[adapter_id] <= 0:
            raise RuntimeError(
                f"release() without a matching acquire() for "
                f"{adapter_id!r}"
            )
        self._pins[adapter_id] -= 1
        if self._pins[adapter_id] == 0:
            del self._pins[adapter_id]

    def _take_slot(self) -> int:
        if self._free:
            return self._free.pop()
        for victim, slot in self._resident.items():  # LRU first
            if self._pins.get(victim, 0) == 0:
                del self._resident[victim]
                del self._uploaded_version[victim]
                self.evictions += 1
                return slot
        raise AdapterCacheFull(
            f"all {self.cache_slots} adapter cache slots are pinned "
            f"by live requests"
        )

    # -- device writes -------------------------------------------------

    def _upload(self, slot: int, rec: _HostAdapter) -> None:
        """One adapter into bank slot `slot`, rank padded with zeros to
        the bank's max_rank, targets it lacks as zeros."""
        update = {"scale": np.float32(rec.scale)}
        for t, (d_in, d_out) in self._dims.items():
            a = np.zeros((self.cfg.n_layers, d_in, self.max_rank),
                         np.float32)
            b = np.zeros((self.cfg.n_layers, self.max_rank, d_out),
                         np.float32)
            if t in rec.a:
                a[:, :, : rec.rank] = rec.a[t]
                b[:, : rec.rank, :] = rec.b[t]
            update[t + "_a"] = a
            update[t + "_b"] = b
        _bank_slot_write(self.bank, update, slot)
        self.uploads += 1

    def rebuild(self, mesh=False) -> None:
        """After an engine reset: zero the bank in place (a reset
        trusts no device state) and re-upload every resident adapter
        into its existing slot, so the id -> slot map survives. Ids
        unregistered since their upload are dropped (their slots free)
        rather than served stale. `mesh` (an elastic resize's new slice,
        None for tp=1) re-mints the bank under that placement first."""
        if mesh is not False:
            self.mesh = mesh
            self.bank = place_adapter_bank(init_adapter_bank(
                self.cfg, self.cache_slots, self.max_rank, self._dtype,
                self.device), mesh)
        for arr in self.bank.values():
            for t in _bank_tensors(arr):
                t.zero_()
        for adapter_id in list(self._resident):
            try:
                rec = self.registry.get(adapter_id)
            except KeyError:
                slot = self._resident.pop(adapter_id)
                self._uploaded_version.pop(adapter_id, None)
                self._pins.pop(adapter_id, None)
                self._free.append(slot)
                continue
            self._upload(self._resident[adapter_id], rec)
            self._uploaded_version[adapter_id] = rec.version

    # -- introspection -------------------------------------------------

    def slot_of(self, adapter_id: Optional[str]) -> Optional[int]:
        if adapter_id is None:
            return 0
        return self._resident.get(adapter_id)

    def resident_ids(self):
        """Most recently used last."""
        return list(self._resident)

    def pinned_count(self) -> int:
        return sum(1 for v in self._pins.values() if v > 0)

    def bank_bytes(self) -> int:
        """Device bytes of the stacked bank (zero slot included)."""
        return sum(t.numel() * t.element_size()
                   for a in self.bank.values() for t in _bank_tensors(a))

    def stats(self) -> Dict[str, int]:
        return {
            "slots": self.cache_slots,
            "resident": len(self._resident),
            "pinned": self.pinned_count(),
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "uploads": self.uploads,
        }
