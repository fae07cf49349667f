"""Serving health sentinel — the port's copy of
dlrover_tpu/serving/health.py: KV content checksums, the preflight
device self-check and fleet-relative straggler detection.

``kv_checksum`` / ``verify_checksum``
    blake2b content digests over host-side KV bytes, stamped at every KV
    egress (tier finalize, host handoff export) and verified at every
    ingress (tier promote / swap-in, handoff adopt). A mismatch
    quarantines the payload and the caller falls back to
    resume-by-replay. A payload is a dict of numpy arrays or torch
    tensors; both hash the same name, dtype string, shape and raw bytes,
    so one set of bits gives one digest in either package (a bf16 tensor
    hashes as "bfloat16" over its 16-bit words, as an ml_dtypes bfloat16
    array does).

``run_preflight``
    A fixed-seed matmul + reduction on the device whose result digest is
    compared with a golden value stamped by the first run in the
    process. Failure fails closed.

``StragglerDetector``
    Per-replica step-latency EWMAs feed a fleet-relative outlier test
    with graded escalation (suspect -> fenced -> ejected). Host-only; the
    replica pool that fences on it is not ported yet.
"""

import hashlib
import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from dlrover_tpu_torch._device import DeviceLike, resolve_device

__all__ = [
    "CHECKSUM_BYTES",
    "KVIntegrityError",
    "kv_checksum",
    "verify_checksum",
    "preflight_digest",
    "run_preflight",
    "reset_preflight_golden",
    "StragglerDetector",
]

# ---------------------------------------------------------------------------
# KV content checksums
# ---------------------------------------------------------------------------

CHECKSUM_BYTES = 16


class KVIntegrityError(RuntimeError):
    """A KV payload failed content-checksum verification at ingress
    (handoff adopt); the caller falls back to resume-by-replay, so the
    corrupted bytes are never served."""


def _dtype_shape_bytes(v):
    """(dtype string, shape string, raw bytes) of an array or tensor,
    spelled as numpy spells them. A torch tensor is read through its
    bits (bf16 as int16 words): never converted. A card tensor is
    copied to the host first (a blocking read: the engine hashes only
    host copies)."""
    if isinstance(v, torch.Tensor):
        t = v.detach().contiguous()
        if t.device.type != "cpu":
            t = t.cpu()
        dtype = str(t.dtype).replace("torch.", "")
        shape = str(tuple(t.shape))
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return dtype, shape, t.numpy().tobytes()
    a = np.ascontiguousarray(v)
    return str(a.dtype), str(a.shape), a.tobytes()


def kv_checksum(data: Dict[str, object]) -> str:
    """Content digest of a KV payload (dict of arrays or tensors): name,
    dtype, shape and raw bytes of every entry in sorted name order, so
    the digest ignores insertion order but changes with any byte, shape
    or dtype."""
    h = hashlib.blake2b(digest_size=CHECKSUM_BYTES)
    for name in sorted(data):
        dtype, shape, raw = _dtype_shape_bytes(data[name])
        h.update(name.encode())
        h.update(b"\x00")
        h.update(dtype.encode())
        h.update(shape.encode())
        h.update(raw)
    return h.hexdigest()


def verify_checksum(data: Dict[str, object], expected: str) -> bool:
    """True iff `data` hashes to `expected`; an empty `expected` never
    verifies (an unstamped payload cannot be checked)."""
    if not expected:
        return False
    return kv_checksum(data) == expected


# ---------------------------------------------------------------------------
# Preflight device self-check
# ---------------------------------------------------------------------------

# Golden digest stamped by the first probe in the process; every later
# probe must reproduce it bit for bit.
_PREFLIGHT_GOLDEN: Optional[str] = None
_PREFLIGHT_LOCK = threading.Lock()

_PREFLIGHT_SEED = 0x5EED
_PREFLIGHT_N = 32


def _preflight_probe(device: DeviceLike = None) -> np.ndarray:
    """Fixed-seed matmul + reduction on `device` (the card unless the
    caller names the CPU)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(_PREFLIGHT_SEED)
    a = rng.standard_normal((_PREFLIGHT_N, _PREFLIGHT_N)).astype(np.float32)
    b = rng.standard_normal((_PREFLIGHT_N, _PREFLIGHT_N)).astype(np.float32)
    ta = torch.from_numpy(a).to(dev)
    tb = torch.from_numpy(b).to(dev)
    return torch.tanh(ta @ tb).sum(dim=0).cpu().numpy()


def preflight_digest(device: DeviceLike = None) -> str:
    """Digest of the probe result on `device`."""
    out = _preflight_probe(device)
    h = hashlib.blake2b(digest_size=CHECKSUM_BYTES)
    h.update(out.tobytes())
    return h.hexdigest()


def run_preflight(device: DeviceLike = None) -> bool:
    """Run the device self-check; True iff it matches the golden digest.
    The first call in the process stamps the golden value (and passes);
    every later call must reproduce it exactly."""
    global _PREFLIGHT_GOLDEN
    d = preflight_digest(device)
    with _PREFLIGHT_LOCK:
        if _PREFLIGHT_GOLDEN is None:
            _PREFLIGHT_GOLDEN = d
            return True
        return d == _PREFLIGHT_GOLDEN


def reset_preflight_golden() -> None:
    """Forget the golden digest (test hook)."""
    global _PREFLIGHT_GOLDEN
    with _PREFLIGHT_LOCK:
        _PREFLIGHT_GOLDEN = None


# ---------------------------------------------------------------------------
# Fleet-relative straggler detection
# ---------------------------------------------------------------------------

# Escalation levels returned by StragglerDetector.level().
LEVEL_OK = 0        # within the fleet envelope
LEVEL_SUSPECT = 1   # over the fence at least once: worth an extra probe
LEVEL_FENCED = 2    # over for >= patience passes: deprioritize in routing
LEVEL_EJECT = 3     # over for >= 2*patience passes: open the breaker


class StragglerDetector:
    """Fleet-relative outlier test over published step-latency EWMAs.

    The pool feeds each replica's latest EWMA into `observe` and calls
    `evaluate` once per health pass. A replica whose EWMA exceeds
    `ratio` x the fleet median gains a strike per pass (reset to zero
    once it is back inside the envelope); strikes map onto graded
    escalation. With fewer than two replicas reporting nothing is ever
    flagged; `min_latency_s` keeps idle fleets from flagging noise."""

    GUARDED_FIELDS = frozenset(
        {"_ewma", "_strikes", "flagged_total", "ejections_total"}
    )

    def __init__(
        self,
        ratio: float = 3.0,
        patience: int = 3,
        min_latency_s: float = 1e-4,
    ):
        if ratio <= 1.0:
            raise ValueError(f"straggler ratio must be > 1, got {ratio}")
        if patience < 1:
            raise ValueError(f"straggler patience must be >= 1, got {patience}")
        self.ratio = float(ratio)
        self.patience = int(patience)
        self.min_latency_s = float(min_latency_s)
        self._ewma: Dict[str, float] = {}
        self._strikes: Dict[str, int] = {}
        # monotone counters
        self.flagged_total = 0
        self.ejections_total = 0
        self._lock = threading.Lock()

    def observe(self, replica_id: str, ewma_s: Optional[float]) -> None:
        """Record a replica's latest published step-latency EWMA."""
        if ewma_s is None or ewma_s <= 0.0:
            return
        with self._lock:
            self._ewma[replica_id] = float(ewma_s)

    def forget(self, replica_id: str) -> None:
        """Drop a replica (ejected / removed) from the fleet view."""
        with self._lock:
            self._ewma.pop(replica_id, None)
            self._strikes.pop(replica_id, None)

    def evaluate(self) -> Dict[str, int]:
        """Run one fleet-relative pass; returns replica -> strike count."""
        with self._lock:
            if len(self._ewma) < 2:
                return dict(self._strikes)
            med = float(np.median(list(self._ewma.values())))
            fence = max(med * self.ratio, self.min_latency_s)
            for rid, e in self._ewma.items():
                if e > fence:
                    n = self._strikes.get(rid, 0) + 1
                    self._strikes[rid] = n
                    if n == self.patience:
                        self.flagged_total += 1
                    if n == 2 * self.patience:
                        self.ejections_total += 1
                else:
                    self._strikes[rid] = 0
            return dict(self._strikes)

    def level(self, replica_id: str) -> int:
        """Current escalation level of a replica."""
        with self._lock:
            n = self._strikes.get(replica_id, 0)
        if n >= 2 * self.patience:
            return LEVEL_EJECT
        if n >= self.patience:
            return LEVEL_FENCED
        if n >= 1:
            return LEVEL_SUSPECT
        return LEVEL_OK

    def is_straggler(self, replica_id: str) -> bool:
        """True once a replica has been fenced (>= patience strikes)."""
        return self.level(replica_id) >= LEVEL_FENCED

    def stragglers(self) -> List[str]:
        """Replica ids at or past the fenced level."""
        with self._lock:
            return sorted(
                rid for rid, n in self._strikes.items() if n >= self.patience
            )

    def stats(self) -> Dict[str, float]:
        with self._lock:
            flagged = sum(
                1 for n in self._strikes.values() if n >= self.patience
            )
            return {
                "stragglers_flagged": float(flagged),
                "stragglers_flagged_total": float(self.flagged_total),
                "straggler_ejections_total": float(self.ejections_total),
                "straggler_ratio": self.ratio,
                "straggler_patience": float(self.patience),
            }
