"""Continuous-batching generation engine — counterpart of the
`ContinuousBatcher` in dlrover_tpu/serving/engine.py, the subset that
serves colocated dense and paged traffic synchronously, for the Llama
family (dense or MoE) and for GPT-2 (models/decode.py's family
dispatch; GPT at tp > 1 raises NotImplementedError, and GPT takes no
adapters, as in JAX).

- A bank of `n_slots` rows, each at its OWN position: a dense KV bank
  [L, n_slots, max_len, KV, hd] (kv_layout="dense") or a global page
  pool with a per-slot page table (kv_layout="paged"; page ids are
  host-allocated by serving/paged_kv.py).
- Admission prefills a request's prompt (padded to a power-of-two
  bucket) into its slot: straight into the dense row, or into an exact
  working row whose cells are then installed into the slot's pages.
- Each dispatch decodes `chunk` steps for every slot; a finished slot
  is refilled from the queue at the next step(). The paged chunk runs
  `paged_decode_step` every step — the paged-attention kernel on the
  card, the gathered dense view on the CPU — with done rows routed to
  the trash page.
- prefix_cache_rows > 0: a radix tree over block-aligned prompt
  prefixes (serving/prefix_cache.py) whose exact K/V rows live in a
  prefix pool beside the bank. An admission installs the longest cached
  prefix and prefills only the suffix (through the position-masked
  cached attention, not flash); it publishes its own aligned prefix for
  the next arrival. Paged, the matched prefix's pages are shared by
  refcount and copied only where the slot writes (`_cow_frontier`).
- Paged, n_pages below the dense-equivalent pool: a dry pool evicts
  unreferenced prefix runs, then preempts the coldest live request
  (`_preempt_slot`): its pages are freed and it goes back to the front
  of the queue with its emitted tokens folded into its prompt, to be
  replayed under the same absolute cap.
- prefill_chunk > 0: an admission installs the slot frozen, with a
  write frontier, and each dispatch runs up to prefill_chunk prompt
  tokens of the oldest mid-prefill slot before its decode steps, until
  the frontier reaches the prompt end and the slot starts decoding.
- Greedy decoding is argmax. Sampling (temperature / top-k / top-p)
  draws from one torch.Generator per request, seeded from the engine
  seed at admission, so a request's stream depends only on its own
  generator, never on batch composition; a preempted request keeps its
  generator's state, and a chunked admission installs its generator
  only when it starts decoding.

- weight_quant="int8" re-stores the large matmul weights at install
  as output-major per-block int8 (`_quantize_params`, the quantize
  kernel on the card), and every projection, MLP and untied lm_head
  product of prefill and decode then runs the fused W8A16
  dequant-matmul kernel (the plain version on the CPU).
  weight_quant="int8_stochastic" stores the same layout, rounded
  stochastically at install (`stochastic_round_int8`, plain PyTorch on
  a per-leaf generator seeded from the engine seed), and serves through
  the same kernels.
- spec_draft_len = K > 0: speculative decoding. The host n-gram
  drafter (serving/speculative.py) proposes up to K tokens per live
  slot; one verify forward prices the carry token and the drafts of
  every slot at once (`verify_step` / `paged_verify_step`) and
  acceptance runs on the device (`_accept`), under the same eos /
  limit / done rules as a chunk, so spec and chunk dispatches
  interleave freely. The bank over-allocates K cells per slot (the
  verify window may reach K past the last valid cell). A dispatch with
  a slot mid-prefill, or with no draft at all, runs the plain chunk.

- adapter_registry: multi-adapter LoRA serving (serving/adapters.py).
  One stacked device bank whose slot 0 is the permanent zero adapter;
  `submit(adapter_id=...)` pins the adapter into a bank slot for the
  request's ledger life (an upload on a miss), every dispatch gathers
  each row's A/B slices by the per-slot index mirror `adapt`, and an
  adapted admission prefills through the adapted projections and
  bypasses the prefix cache both ways (published prefixes are base-model
  K/V). adapter_id=None rows add an exact zero: byte-identical to the
  adapterless engine.
- update_params: a versioned swap of the served weights (an RL
  trainer's policy, a promoted checkpoint). weight_refresh_mode
  "defer" stages it and commits at the next idle boundary, "raise"
  refuses it while work is in flight, "live" commits at once (the
  in-flight dispatch abandoned, int8 weights re-quantized behind the
  fence) and, with weight_refresh_replay, replays every live slot under
  the new version. A tree whose structure, shapes or dtypes differ from
  the constructed one raises with the old weights still serving.

The host keeps the slot state (tok/pos/done/limit) as numpy mirrors;
each dispatch uploads it (page-locked staging on the card), runs its
steps on the device, and fetches the emitted tokens and the new state
with one copy into a page-locked buffer the engine keeps, behind an
event. async_depth=0 waits for that copy in the same step();
async_depth=1 returns at once and harvests the dispatch at the start of
the next step(), before admitting and drafting from the refreshed
mirrors, so the dispatches (and the streams) are the same at either
depth and only the call on which events surface moves.

- kv_tier_bytes > 0: a host-DRAM KV tier (serving/kv_tier.py). An
  evicted published prefix demotes to page-locked host memory (a gather
  on the engine's stream, then a non-blocking copy on a side stream,
  completed by `drain()` at the top of the next step), and a later
  admission that the tier holds deeper than the radix cache promotes it
  back (upload, a fresh pool row, promoted pages). swap_to_host: a
  preempted decoding slot's page run demotes too, and its readmission
  scatters the stored pages back and resumes without a prefill;
  replay stays the fallback. kv_tier_promote "swap_only" / "never"
  limits promotion. kv_checksums=1 stamps and verifies a blake2b digest
  over KV bytes in transit (tier entries, host handoff packages); a
  mismatch quarantines the payload and the request replays.
- chaos / chaos_tag: a serving/chaos.py FaultInjector consulted at the
  top of every step() (and by the tier inside every demotion, tag
  "<chaos_tag>#kvtier"); device_health() reports its lost chips.
- replica_role="prefill": admissions are the prefill and the engine
  never decodes; each finished prefill waits (its slot held frozen) for
  `take_prefilled()` and serving/handoff.py `export_run`, and a
  "decode" engine installs the package by `submit_adopted(pkg)` in
  place of a prefill.

- mesh_spec: the serving slice's tp degree (an int, {"tp": n}, or an
  object with `.tensor`), validated as the JAX engine validates it
  (ValueError for a bool, extra axes, tp < 1, tp past the local device
  count, tp not dividing the KV heads). tp=1 (mesh None) is the
  one-device engine. tp > 1 serves on a `ServingMesh` of `tp` local
  devices (`_device.local_devices`: the cards, or
  DLROVER_TPU_TORCH_FORCE_DEVICE_COUNT virtual shards of one): wq/wk/wv
  split on their head columns (`_shard_params`), the dense bank, page
  pool, prefix pool and adapter B banks on their KV-head / output axis,
  attention per shard through the sharded kernel sites, everything
  else once on the mesh's home device (models/decode.py). Page tables,
  slot mirrors and the packed fetch stay single on the home device.
  `resize` (serving/elastic.py) re-forms the slice at another tp.
"""

import dataclasses
import hashlib
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from dlrover_tpu_torch._device import (
    DeviceLike,
    local_devices,
    resolve_device,
    upload,
)
from dlrover_tpu_torch.models.decode import (
    _check_positional_capacity,
    _is_gpt,
    _mask_top_k,
    _mask_top_p,
    categorical,
    decode_step,
    init_kv_cache,
    init_page_pool,
    install_exact_row,
    paged_decode_step,
    paged_install_row,
    paged_prefill_chunk,
    paged_verify_step,
    pool_copy_page,
    pool_put_row,
    pool_take_row,
    prefill_chunk_into_slot,
    prefill_exact_row,
    prefill_into_slot,
    prefill_suffix_row,
    spec_accept_greedy,
    spec_accept_sampled,
    verify_step,
)
from dlrover_tpu_torch.ops import paged_attention as _pa
from dlrover_tpu_torch.ops.quantization import (
    QuantizedWeight,
    quantize_int8,
    stochastic_round_int8,
    use_quant_matmul_kernel,
    weight_quant_block,
)
from dlrover_tpu_torch.parallel.mesh import (
    PartitionSpec,
    serving_mesh,
    serving_mesh_spec,
    serving_weight_quant_specs,
)
from dlrover_tpu_torch.parallel.sharding import Sharded, shard_tree
from dlrover_tpu_torch.serving import kv_tier as _kv_tier
from dlrover_tpu_torch.serving.adapters import DeviceAdapterCache
from dlrover_tpu_torch.serving.paged_kv import (
    TRASH_PAGE,
    OutOfPages,
    PageAllocator,
)
from dlrover_tpu_torch.serving.prefix_cache import RadixPrefixCache
from dlrover_tpu_torch.serving.speculative import SpeculativeDecoder

# The large matmul weights weight_quant="int8" re-stores as per-block
# int8 (ops/quantization.QuantizedWeight), by name on the stacked layer
# dict (the JAX engine's set, which also names the GPT family's fused
# wqkv). Norms and embeddings stay dense; the untied lm_head quantizes
# separately.
_WQ_LAYER_WEIGHTS = frozenset(
    ("wq", "wk", "wv", "wo", "wqkv", "w_gate", "w_up", "w_down")
)

# The serving slice's param layout (the JAX engine's): ONLY the QKV
# projections split, on their head (output) columns, so no contraction
# is ever split; wo, the MLP, the embedding, the head and the norms are
# replicated, run after the attention output is gathered. The int8
# tree's q8 / s8 follow `serving_weight_quant_specs` (their output axis
# is 1).
_SERVING_PARAM_RULES = (
    (r"layers/wq$", ("tp",)),
    (r"layers/wk$", ("tp",)),
    (r"layers/wv$", ("tp",)),
)


def _serving_param_rules():
    return [(pat, PartitionSpec(None, None, *axes))
            for pat, axes in _SERVING_PARAM_RULES] + list(
                serving_weight_quant_specs())


def _pad_bucket(n: int, lo: int = 16) -> int:
    """Next power-of-two bucket (>= lo)."""
    b = lo
    while b < n:
        b *= 2
    return b


def _lora_operand(bank: Dict[str, torch.Tensor], idx: torch.Tensor):
    """The `adapters` operand of models/decode.py from the stacked
    device bank and a per-row bank-slot vector."""
    return {
        "bank": {k: v for k, v in bank.items() if k != "scale"},
        "idx": idx,
        "scale": bank["scale"],
    }


def _seed_of(prng_key) -> int:
    """A request's sampling seed from `submit(prng_key=...)`: an int, or
    an array of 32-bit words (a JAX PRNGKey's two) folded high word
    first. The draws are torch's; the key only seeds them."""
    if isinstance(prng_key, (int, np.integer)):
        if prng_key < 0:
            raise ValueError(f"prng_key must be >= 0, got {prng_key}")
        return int(prng_key)
    seed = 0
    for word in np.asarray(prng_key).ravel():
        seed = (seed << 32) | (int(word) & 0xFFFFFFFF)
    return seed % 2**64


def _parse_mesh_tp(mesh_spec) -> int:
    """The `mesh_spec` knob: an int tp degree, a {"tp": n} dict, or an
    object with a `.tensor` attribute (a MeshSpec's tensor axis)."""
    if isinstance(mesh_spec, bool):
        raise ValueError(f"mesh_spec must be an int tp degree, a "
                         f"{{'tp': n}} dict or a MeshSpec, got "
                         f"{mesh_spec!r}")
    if isinstance(mesh_spec, int):
        return mesh_spec
    if isinstance(mesh_spec, dict):
        extra = set(mesh_spec) - {"tp"}
        if extra:
            raise ValueError(
                f"mesh_spec dict supports only the 'tp' axis for "
                f"serving, got extra axes {sorted(extra)}"
            )
        return int(mesh_spec.get("tp", 1))
    tensor = getattr(mesh_spec, "tensor", None)
    if tensor is not None:
        return int(tensor)
    raise ValueError(
        f"mesh_spec must be an int tp degree, a {{'tp': n}} dict or "
        f"a MeshSpec, got {mesh_spec!r}"
    )


def _wq_leaf_seed(seed: int, salt: int) -> int:
    """The generator seed of one weight leaf under
    weight_quant="int8_stochastic": the first 8 bytes (little-endian) of
    blake2b("<seed>/<salt>"), so every bit of the seed and the salt
    reaches the low 32 bits the CPU generator keeps (JAX folds the salt
    into PRNGKey(seed) instead; the draws are torch's)."""
    digest = hashlib.blake2b(f"{int(seed)}/{int(salt)}".encode(),
                             digest_size=8).digest()
    return int.from_bytes(digest, "little")


def _tree_signature(tree, path=()) -> List[Tuple[Tuple[str, ...], tuple]]:
    """(path, (shape, dtype)) of every leaf of a nested-dict param tree,
    keys sorted (the order JAX's tree_flatten walks a dict in); a leaf
    without a dtype (a QuantizedWeight) is typed by its class."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(_tree_signature(tree[k], path + (k,)))
        return out
    return [(path, (tuple(getattr(tree, "shape", ())),
                    getattr(tree, "dtype", type(tree).__name__)))]


@dataclasses.dataclass
class _Request:
    idx: int                 # submission order
    prompt: np.ndarray       # [P] true tokens
    max_new: int = 0         # per-request cap (0 = engine default)
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    seed: Optional[int] = None  # sampling seed, drawn at admission
    # set by preemption: the request gave its pages back and waits in
    # the queue for resume by replay (paged layout, pool pressure)
    preempted: bool = False
    # how many of `out` earlier preemptions folded into `prompt`
    folded: int = 0
    # the sampling generator's state when a decoding slot was preempted:
    # the replay continues it instead of seeding afresh
    gen_state: Optional[torch.Tensor] = None
    # weight versions whose dispatches emitted this request's tokens (one
    # under the deferred fence; a second only across a live swap)
    versions: set = dataclasses.field(default_factory=set)
    # multi-adapter serving: the registry id this request decodes under
    # (None = base model) and its bank slot, PINNED from submit to
    # retire / cancel (a preemption keeps it: the replay lands on the
    # same slot)
    adapter_id: Optional[str] = None
    adapter_slot: int = 0
    # a serving/handoff.py KVHandoff to install instead of a prefill
    # (cleared at admission: a later replay prefills like any request)
    adopted: Optional[object] = None


# one step() event: (request idx, tokens emitted this chunk, finished)
StepEvent = Tuple[int, List[int], bool]


@dataclasses.dataclass
class _Inflight:
    """One dispatched-but-not-harvested device step: where its outputs
    land on the host and the host context that turns them into
    events."""

    kind: str                     # "chunk" | "spec"
    old_pos: Optional[np.ndarray] = None    # chunk: pos at dispatch
    dlens: Optional[np.ndarray] = None      # spec: drafted lengths
    was_live: Optional[np.ndarray] = None   # spec: live at dispatch
    # interleaved chunk: the slots MID-PREFILL when it was built; their
    # fetched done=True is the freeze, not a finish
    pf_mask: Optional[np.ndarray] = None
    # set at enqueue: the fetched outputs' shapes in pack order, the
    # event recorded after their copy (None on the CPU), perf_counter
    shapes: List[Tuple[int, ...]] = dataclasses.field(default_factory=list)
    event: Optional["torch.cuda.Event"] = None
    dispatched_at: float = 0.0
    version: int = 0                # weight version at dispatch
    # sampled dispatches: (generator, state before its draws) per slot,
    # so an abandoned dispatch's draws can be taken back
    gens: Optional[list] = None


class ContinuousBatcher:
    """Greedy/sampling generation over a slot bank.

    generate_all(prompts) -> list of generated continuations (eos
    included when hit), in submission order."""

    def __init__(
        self,
        cfg,
        params,
        n_slots: int = 8,
        max_len: int = 512,
        max_new_tokens: int = 128,
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 1.0,
        eos_id: Optional[int] = None,
        pad_id: int = 0,
        chunk: int = 8,   # steps per dispatch; see _next_chunk_len
        seed: int = 0,
        kv_quant: bool = False,  # int8 KV cache
        prefix_cache_rows: int = 0,  # 0 disables the prefix cache
        prefix_block: int = 16,      # prefix match granularity (tokens)
        kv_layout: str = "dense",    # "dense" bank | "paged" pool
        page_size: int = 0,          # cells per page (0 = auto pow2)
        n_pages: int = 0,            # pool size (0 = dense-equivalent)
        swap_headroom: int = 1,      # free pages the scheduler keeps
        prefill_chunk: int = 0,  # tokens of prefill per interleaved
                                 # dispatch (0 = blocking admission)
        weight_quant: str = "none",  # | "int8": per-block int8 weights
        spec_draft_len: int = 0,     # speculative draft width K (0 = off)
        spec_ngram_max: int = 3,     # longest suffix n-gram the drafter tries
        spec_ngram_min: int = 1,     # shortest n-gram fallback
        spec_accept_threshold: float = 0.5,  # EMA acceptance to keep drafting
        spec_probe_interval: int = 32,  # rounds between disabled-slot probes
        async_depth: int = 0,        # 1 = one-deep pipelined dispatch
        weight_refresh_mode: str = "defer",  # | "live" | "raise"
        weight_refresh_replay: bool = True,  # live mode: replay slots
        adapter_registry=None,       # serving/adapters.AdapterRegistry
        adapter_cache_slots: int = 8,  # device adapter bank slots (LRU)
        chaos=None,                  # serving/chaos.py FaultInjector
        chaos_tag: str = "engine",   # this engine's tag in fault plans
        replica_role: str = "colocated",  # | "prefill" | "decode"
        kv_tier_bytes: int = 0,  # host-DRAM KV tier capacity (0 = off)
        swap_to_host: bool = True,   # preempted runs demote, not drop
        kv_tier_promote: str = "always",  # | "swap_only" | "never"
        kv_checksums: int = 0,   # 1 = content-verify KV in transit
        mesh_spec=None,          # tp degree | {"tp": n} | MeshSpec
        device: DeviceLike = None,
    ):
        if eos_id is not None and eos_id == pad_id:
            raise ValueError(
                "eos_id and pad_id must differ: the pad emitted by "
                "finished slots would re-trigger EOS detection"
            )
        if spec_draft_len < 0:
            raise ValueError(
                f"spec_draft_len must be >= 0, got {spec_draft_len}"
            )
        if spec_draft_len >= max_len:
            raise ValueError(
                f"spec_draft_len {spec_draft_len} must be < max_len "
                f"{max_len}"
            )
        if async_depth not in (0, 1):
            raise ValueError(
                f"async_depth must be 0 (sync) or 1 (one-deep "
                f"pipeline), got {async_depth}"
            )
        if not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        if top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {top_k}")
        if replica_role not in ("colocated", "prefill", "decode"):
            raise ValueError(
                f"replica_role must be 'colocated', 'prefill' or "
                f"'decode', got {replica_role!r}"
            )
        if prefill_chunk < 0:
            raise ValueError(
                f"prefill_chunk must be >= 0, got {prefill_chunk}"
            )
        if kv_tier_bytes < 0:
            raise ValueError(
                f"kv_tier_bytes must be >= 0, got {kv_tier_bytes}"
            )
        if kv_tier_promote not in ("always", "swap_only", "never"):
            raise ValueError(
                f"kv_tier_promote must be 'always', 'swap_only' or "
                f"'never', got {kv_tier_promote!r}"
            )
        if kv_checksums not in (0, 1):
            raise ValueError(
                f"kv_checksums must be 0 (off) or 1 (verify KV in "
                f"transit), got {kv_checksums}"
            )
        if kv_layout not in ("dense", "paged"):
            raise ValueError(
                f"kv_layout must be 'dense' or 'paged', got {kv_layout!r}"
            )
        if weight_quant not in ("none", "int8", "int8_stochastic"):
            raise ValueError(
                f"weight_quant must be 'none', 'int8' or "
                f"'int8_stochastic', got {weight_quant!r}"
            )
        if weight_refresh_mode not in ("live", "defer", "raise"):
            raise ValueError(
                f"weight_refresh_mode must be 'live', 'defer' or "
                f"'raise', got {weight_refresh_mode!r}"
            )
        _check_positional_capacity(cfg, max_len)
        self.device = resolve_device(device)
        self.cfg = cfg
        # the serving slice: validated even at tp 1, so a bad knob fails
        # here. tp 1 keeps mesh None (the one-device engine, bit for
        # bit); the constructed tp is also the largest a resize may grow
        # back to (serving/elastic.py)
        self.mesh = None
        self.mesh_tp = 1
        if mesh_spec is not None:
            tp = _parse_mesh_tp(mesh_spec)
            n_kv = getattr(cfg, "n_kv_heads", None) or cfg.n_heads
            devices = local_devices(self.device)
            serving_mesh_spec(tp, n_kv_heads=n_kv, n_devices=len(devices))
            if tp > 1 and _is_gpt(cfg):
                raise NotImplementedError(
                    "GPT serving at tp > 1 is not ported (ROADMAP queue 1, "
                    "item 13: GPT at tp > 1)")
            self.mesh_tp = tp
            if tp > 1:
                self.mesh = serving_mesh(tp, devices=devices,
                                         n_kv_heads=n_kv)
        self._full_tp = self.mesh_tp
        self._elastic_resize = {"shrink": 0, "grow": 0}
        self._elastic_downtime_ms = 0.0
        # fault injection: on_engine_step(chaos_tag, n) at every step()
        self.chaos = chaos
        self.chaos_tag = chaos_tag
        self._step_no = 0
        # KV integrity (serving/health.py): checks and quarantines at
        # the handoff ingress (the tier counts its own)
        self.kv_checksums = int(kv_checksums)
        self._integrity_checks = 0
        self._integrity_quarantines = 0
        # phase split: a "prefill" engine admits (the admission is the
        # prefill) and never decodes; finished prefills queue here for
        # export through serving/handoff.py. "decode" steps as
        # colocated does
        self.replica_role = replica_role
        self._prefill_ready: List[_Request] = []
        # versioned weight refresh (update_params)
        self.weight_refresh_mode = weight_refresh_mode
        self.weight_refresh_replay = weight_refresh_replay
        self._weight_version = 0
        self._staged_params = None
        self._elastic_refresh = {
            "committed": 0, "deferred": 0, "rolled_back": 0,
        }
        self._elastic_replayed = 0
        self.weight_quant = weight_quant
        self._wq_seed = seed
        self._wq_stats = {"leaves": 0, "skipped": 0}
        # refreshes arrive as DENSE trees: they validate against the
        # tree the engine was constructed with, before quantization
        self._refresh_skeleton = _tree_signature(params)
        self.params = self._shard_params(self._quantize_params(params))
        self.n_slots = n_slots
        self.max_len = max_len
        self.max_new = max_new_tokens
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.eos_id = eos_id
        self.pad_id = pad_id
        self.chunk = chunk
        self.kv_layout = kv_layout
        self._paged = kv_layout == "paged"
        self._kv_quant = kv_quant
        # the bank over-allocates by the draft width: a verify writes
        # K+1 cells at [pos, pos+K], and a slot near its cap (pos up to
        # max_len-2) must find them inside its row; the cells past
        # max_len-1 are dead by the position mask
        bank_len = max_len + spec_draft_len
        self.spec_draft_len = spec_draft_len
        self.cache = None
        if self._paged:
            # auto page size: the largest power of two <= 16 dividing
            # the bank length (and the prefix block, so a matched prefix
            # is always a whole number of pages)
            if page_size <= 0:
                page_size = 16
                while page_size > 1 and (
                    bank_len % page_size
                    or (prefix_cache_rows > 0 and prefix_block % page_size)
                ):
                    page_size //= 2
            if bank_len % page_size:
                raise ValueError(
                    f"page_size {page_size} must divide max_len + "
                    f"spec_draft_len = {bank_len}: a slot's logical "
                    "cells must map onto whole pages"
                )
            if prefix_cache_rows > 0 and prefix_block % page_size:
                raise ValueError(
                    f"page_size {page_size} must divide prefix_block "
                    f"{prefix_block}: shared prefixes must cover whole "
                    "pages or sharing cannot be copy-free"
                )
            per_slot = bank_len // page_size
            if n_pages <= 0:
                # dense-equivalent capacity (+ the trash page);
                # oversubscription comes from setting n_pages lower
                n_pages = n_slots * per_slot + 1
            if n_pages < per_slot + 1:
                raise ValueError(
                    f"n_pages {n_pages} cannot back a single maximal "
                    f"request ({per_slot} pages + the trash page)"
                )
            self.page_size = page_size
            self.n_pages = n_pages
            self.swap_headroom = max(0, swap_headroom)
            self._pages_per_slot = per_slot
            self._swap_preemptions = 0
            self._swap_resumes = 0
        # interleaved chunked prefill: a slot mid-prefill is occupied on
        # the host (done False) and frozen in the dispatches (done True)
        # until its frontier reaches the prompt end
        self._prefill_chunk = prefill_chunk
        self._prefilling = np.zeros(n_slots, bool)
        self._frontier = np.zeros(n_slots, np.int64)
        # prefill role with prefill_chunk > 0: slots whose prefill is
        # complete and wait for export. The interleaved dispatches keep
        # running for the other slots, so these ride them frozen (as
        # done) and harvest leaves them occupied with their pages
        self._export_hold = np.zeros(n_slots, bool)
        self._admission_stall_ms = 0.0   # time _admit blocked the loop
        self._prefill_chunks_total = 0   # interleaved chunks dispatched
        # the prefix cache: a radix tree over block-aligned prefixes and
        # an exact-dtype pool row per cached prefix (exact even when the
        # bank is int8: install quantizes, which keeps warm admissions
        # byte-identical to cold ones)
        self.prefix_cache: Optional[RadixPrefixCache] = None
        self.pool = None
        self._prefix_rows = prefix_cache_rows
        self._prefix_block = prefix_block
        # the host-DRAM KV tier: none at kv_tier_bytes=0, and then no
        # path below changes
        self.kv_tier: Optional[_kv_tier.HostKVTier] = None
        self._tier_swap = bool(swap_to_host)
        self._tier_promote = kv_tier_promote
        if kv_tier_bytes > 0:
            self.kv_tier = _kv_tier.HostKVTier(
                kv_tier_bytes, block=prefix_block, chaos=chaos,
                chaos_tag=f"{chaos_tag}#kvtier",
                checksums=bool(kv_checksums),
            )
        # the banks: the page pool with its allocator and tables, or the
        # dense bank; the prefix cache and its pool
        self._new_kv_state()
        # the engine seed only SEEDS per-request generators (one draw
        # per admission); sampling runs on the per-slot generators
        self._seed_gen = torch.Generator().manual_seed(seed)
        self._slot_gen: List[Optional[torch.Generator]] = [None] * n_slots
        # host mirrors of the slot state
        self.tok = np.full(n_slots, pad_id, np.int64)
        self.pos = np.zeros(n_slots, np.int64)
        self.limit = np.zeros(n_slots, np.int64)
        self.done = np.ones(n_slots, bool)   # all free initially
        # per-slot adapter-bank index (0 = the zero adapter), uploaded
        # with each dispatch's state when adapters are on
        self.adapt = np.zeros(n_slots, np.int64)
        self.slot_req: List[Optional[_Request]] = [None] * n_slots
        self._queue: deque = deque()
        self._requests: Dict[int, _Request] = {}
        self._pending: Dict[int, None] = {}
        self._next_idx = 0
        # speculative decoding: host drafter + adaptive controller
        self.spec: Optional[SpeculativeDecoder] = None
        self._spec_knobs = (spec_ngram_max, spec_ngram_min,
                            spec_accept_threshold, spec_probe_interval)
        self._make_spec()
        # multi-adapter LoRA serving: one stacked bank on the device;
        # without a registry every structure and path is the
        # adapterless engine's
        self.adapter_registry = adapter_registry
        self._adapter_cache: Optional[DeviceAdapterCache] = None
        if adapter_registry is not None:
            self._adapter_cache = DeviceAdapterCache(
                cfg, adapter_registry, adapter_cache_slots,
                device=self.device, mesh=self.mesh,
            )
        # the dispatch pipeline: the one dispatch not yet harvested, and
        # the page-locked buffer its outputs are copied into (one buffer
        # serves every dispatch: a dispatch's copy is enqueued only
        # after the one before it was harvested, or orphaned, and stream
        # order puts an orphan's copy first)
        self.async_depth = async_depth
        self._inflight: Optional[_Inflight] = None
        self._fetch_buf: Optional[torch.Tensor] = None
        # step-latency stats (step_stats): host work, time blocked on
        # the device, and the device span the host work hid
        self._stat_host_ms = 0.0
        self._stat_wait_ms = 0.0
        self._stat_span_ms = 0.0
        self._stat_overlap_ms = 0.0
        self._stat_dispatches = 0
        self._wait_this_step = 0.0
        # counters chip_smoke.py and the tests read
        self.admissions = 0
        self.decode_steps = 0     # chunk steps
        self.verify_steps = 0     # spec dispatches (one verify each)

    def _make_prefix_cache(self) -> RadixPrefixCache:
        """A fresh radix tree. Its eviction callback drops a paged
        prefix's page run and, with the tier on, demotes the row."""
        return RadixPrefixCache(
            self._prefix_rows, block=self._prefix_block,
            on_evict=(self._on_prefix_evict
                      if (self._paged or self.kv_tier is not None)
                      else None),
        )

    def _make_spec(self) -> None:
        """The host drafter and controller, fresh (None at K = 0)."""
        if self.spec_draft_len > 0:
            ng_max, ng_min, thresh, probe = self._spec_knobs
            self.spec = SpeculativeDecoder(
                self.n_slots, self.spec_draft_len, ngram_max=ng_max,
                ngram_min=ng_min, threshold=thresh, probe_interval=probe,
            )

    # The JAX engine keys its compiled programs on the adapter bank's
    # shape (`_adapter_tag`) and on the weight version; the port compiles
    # no programs, so neither has a counterpart here.

    def _adapter_args(self, rows: Optional[List[int]] = None):
        """The `adapters` operand of a forward: the bank and the index
        mirror of every slot (or of the slots `rows` only), uploaded
        now; None when multi-adapter serving is off."""
        if self._adapter_cache is None:
            return None
        idx = self.adapt if rows is None else self.adapt[rows]
        return _lora_operand(self._adapter_cache.bank, self._upload(idx))

    # -- weight quantization -----------------------------------------------

    def _quantize_params(self, params):
        """Install-time int8 weight quantization (the JAX engine's
        `_quantize_params`). Each matmul weight [.., K, O] re-stores
        OUTPUT-MAJOR as q8 int8 [.., O, K] + s8 f32 [.., O, K/block],
        one layer slice at a time straight from the stored tensor (the
        kernel reads bf16 or f32; an f32 copy of a whole stacked weight
        is never made). Weights whose K has no block
        (`weight_quant_block` 0) stay dense. Idempotent: a leaf that is
        already a QuantizedWeight passes through. weight_quant="none"
        returns `params` itself. The caller's dict is not modified.

        "int8_stochastic" rounds each value up or down at random in
        proportion to its fractional part (`stochastic_round_int8`,
        plain PyTorch, as JAX's is XLA) instead of to nearest. Each leaf
        draws from its own generator on the weight's device, seeded by
        `_wq_leaf_seed(seed, salt)` with JAX's salts (the index of the
        layer weight in sorted(params["layers"]), len(layers) for the
        untied lm_head), slice after slice in layer order: the same
        engine seed installs the same bytes, at every commit too."""
        if self.weight_quant == "none":
            return params
        if not isinstance(params, dict) or "layers" not in params:
            return params
        stochastic = self.weight_quant == "int8_stochastic"
        leaves = skipped = 0
        lay = dict(params["layers"])
        targets = [("layers", name, salt)
                   for salt, name in enumerate(sorted(lay))
                   if name in _WQ_LAYER_WEIGHTS]
        head = params.get("lm_head")
        if isinstance(head, dict) and "weight" in head:
            # untied unembed [D, V]: the largest weight read of a step
            head = dict(head)
            targets.append(("lm_head", "weight", len(lay)))
        for group, name, salt in targets:
            w = lay[name] if group == "layers" else head[name]
            if isinstance(w, QuantizedWeight):
                leaves += 1
                continue
            shape = tuple(w.shape)
            blk = weight_quant_block(shape[-2]) if len(shape) > 1 else 0
            if blk == 0:
                skipped += 1
                continue
            *lead, k_dim, o_dim = shape
            slices = w.reshape((-1, k_dim, o_dim))
            q8 = torch.empty((slices.shape[0], o_dim, k_dim),
                             dtype=torch.int8, device=w.device)
            s8 = torch.empty((slices.shape[0], o_dim, k_dim // blk),
                             dtype=torch.float32, device=w.device)
            gen = None
            if stochastic:
                gen = torch.Generator(device=w.device).manual_seed(
                    _wq_leaf_seed(self._wq_seed, salt))
            for i in range(slices.shape[0]):
                wt = slices[i].t().contiguous()
                if stochastic:
                    q, s = stochastic_round_int8(wt, blk, gen)
                else:
                    q, s = quantize_int8(wt, blk)
                q8[i].copy_(q)
                s8[i].copy_(s)
            qw = QuantizedWeight(
                q8.reshape(tuple(lead) + (o_dim, k_dim)),
                s8.reshape(tuple(lead) + (o_dim, k_dim // blk)), blk,
            )
            leaves += 1
            if group == "layers":
                lay[name] = qw
            else:
                head[name] = qw
        out = dict(params)
        out["layers"] = lay
        if isinstance(head, dict) and "weight" in head:
            out["lm_head"] = head
        self._wq_stats = {"leaves": leaves, "skipped": skipped}
        return out

    def weight_bytes_device(self) -> int:
        """Served-weight bytes resident per shard (the JAX engine's "per
        chip"): every tensor leaf of the served tree (a QuantizedWeight
        counts its q8 and s8) times its element size, a head-sharded
        leaf counting one shard's piece."""
        def walk(node):
            if isinstance(node, dict):
                return sum(walk(v) for v in node.values())
            if isinstance(node, Sharded):
                return node.nbytes_per_shard()
            if isinstance(node, QuantizedWeight):
                return walk(node.q8) + walk(node.s8)
            return node.numel() * node.element_size()
        return walk(self.params)

    @property
    def weight_quant_path(self) -> str:
        """Which matmul body the quantized weights run: "int8:kernel"
        (the fused dequant-matmul kernel, on the card at tp 1) or
        "int8:reference" (its plain version: on the CPU, and at tp > 1,
        where JAX's gate `use_quant_matmul_kernel` keeps the reference);
        "none" when quantization is off."""
        if self.weight_quant == "none":
            return "none"
        kind = ("kernel" if self.device.type == "cuda"
                and use_quant_matmul_kernel(self.mesh_tp) else "reference")
        return f"{self.weight_quant}:{kind}"

    def weight_quant_stats(self) -> Dict[str, float]:
        """Mode flag, device weight bytes and quantized / skipped leaf
        counts (the JAX engine's exposition keys)."""
        return {
            "weight_quant_int8": (
                0.0 if self.weight_quant == "none" else 1.0
            ),
            "weight_bytes_device": float(self.weight_bytes_device()),
            "weight_quant_leaves": float(self._wq_stats["leaves"]),
            "weight_quant_skipped": float(self._wq_stats["skipped"]),
        }

    # -- weight refresh ----------------------------------------------------

    @property
    def weight_version(self) -> int:
        """Monotonic version of the served weights; requests record the
        versions their tokens were produced under."""
        return self._weight_version

    def update_params(self, params, mode: Optional[str] = None) -> None:
        """Swap the served weights, version-tagged. `mode` (default: the
        engine's `weight_refresh_mode`) decides what happens when work
        is in flight:

        - "defer": stage the tree and commit at the next idle boundary,
          so every in-flight request completes under the version it
          started on (the fence). An idle engine commits at once.
        - "raise": refuse a swap while work is in flight (RuntimeError).
        - "live": commit now: the in-flight dispatch is abandoned, the
          version bumps, and with `weight_refresh_replay` every live
          slot is preempted and replayed under the new version;
          otherwise live requests keep their old-version KV and finish
          under the new weights. One dispatch carries one version.

        A tree whose structure, leaf shapes or dtypes differ from the
        constructed one raises with the old params and version still
        serving, and counts as rolled_back in `elastic_stats()`."""
        mode = mode or self.weight_refresh_mode
        if mode not in ("live", "defer", "raise"):
            raise ValueError(
                f"update_params mode must be 'live', 'defer' or "
                f"'raise', got {mode!r}"
            )
        busy = self.has_work()
        if mode == "raise" and busy:
            raise RuntimeError(
                "update_params while requests are in flight would mix "
                "policies mid-drain; finish the drain, or refresh "
                "with mode='defer' (fence) or mode='live' (versioned "
                "swap)"
            )
        if mode == "defer" and busy:
            try:
                self._check_refresh_tree(params)
            except Exception:
                self._elastic_refresh["rolled_back"] += 1
                raise
            self._staged_params = params
            self._elastic_refresh["deferred"] += 1
            return
        self._commit_refresh(
            params,
            replay=mode == "live" and busy and self.weight_refresh_replay,
        )

    def _check_refresh_tree(self, params) -> None:
        """Fail before any engine state changes unless `params` has the
        constructed tree's structure, leaf shapes and dtypes (the dense
        skeleton: int8 weights re-quantize behind the fence at
        commit)."""
        old = self._refresh_skeleton
        new = _tree_signature(params)
        if [p for p, _ in old] != [p for p, _ in new]:
            raise ValueError(
                "weight refresh rejected: parameter tree structure "
                "does not match the served params"
            )
        for (path, o), (_, n) in zip(old, new):
            if o != n:
                raise ValueError(
                    f"weight refresh rejected: leaf mismatch at "
                    f"{'/'.join(path)}: {n[0]}/{n[1]} vs served "
                    f"{o[0]}/{o[1]}"
                )

    def _commit_refresh(self, params, replay: bool = False) -> None:
        """Apply a refresh now: validate, abandon any in-flight dispatch,
        re-quantize (the quantize kernel on the card), bump the version.
        Any failure restores the old params and version. With `replay`
        every live slot is preempted, highest slot first, so the queue
        front comes out in ascending slot order."""
        old_params = self.params
        old_version = self._weight_version
        old_wq = self._wq_stats
        try:
            self._check_refresh_tree(params)
            self.drain_inflight()
            self.params = self._shard_params(self._quantize_params(params))
            self._weight_version = old_version + 1
        except Exception:
            self.params = old_params
            self._weight_version = old_version
            self._wq_stats = old_wq
            self._elastic_refresh["rolled_back"] += 1
            raise
        if replay:
            for slot in range(self.n_slots - 1, -1, -1):
                if self.slot_req[slot] is not None and not self.done[slot]:
                    self._preempt_slot(slot)
                    self._elastic_replayed += 1
        self._staged_params = None
        self._elastic_refresh["committed"] += 1

    def _maybe_commit_refresh(self) -> None:
        """Commit a deferred refresh once the engine is idle (nothing
        live, queued or in flight), so no request spans the swap.
        Checked at submit() and step()."""
        if self._staged_params is not None and not self.has_work():
            self._commit_refresh(self._staged_params)

    # -- serving slice ----------------------------------------------------

    def _shard_params(self, params):
        """Lay the served weights out over the serving mesh (JAX
        `_shard_params` :1846): wq/wk/wv (and their q8 / s8) split on
        their head columns, everything else replicated on the home
        device (`_SERVING_PARAM_RULES`). Without a mesh, a tree that was
        sharded is gathered back to one device (a resize to tp 1);
        otherwise the tree itself."""
        if self.mesh is None and not _has_sharded(params):
            return params
        return shard_tree(params, self.mesh, _serving_param_rules())

    def _new_kv_state(self) -> None:
        """Fresh KV state at the current slice (JAX `_shard_bank` of the
        fresh banks): the page pool with its allocator, tables and page
        runs, or the dense bank; the prefix cache and its pool."""
        cfg = self.cfg
        if self._paged:
            self.allocator = PageAllocator(self.n_pages, self.page_size)
            self.page_pool = init_page_pool(
                cfg, self.n_pages, self.page_size, quant=self._kv_quant,
                device=self.device, mesh=self.mesh,
            )
            # all rows start on the trash page; the chunk routes done
            # rows there itself, so the host writes rows only at
            # admission and copy-on-write
            self._table = torch.zeros(
                (self.n_slots, self._pages_per_slot), dtype=torch.int32,
                device=self.device,
            )
            self._slot_pages: List[List[int]] = [
                [] for _ in range(self.n_slots)]
            # published radix row -> its ref-counted page run
            self._row_pages: Dict[int, List[int]] = {}
        else:
            self.cache = init_kv_cache(
                cfg, self.n_slots, self.max_len + self.spec_draft_len,
                quant=self._kv_quant, device=self.device, mesh=self.mesh,
            )
        if self._prefix_rows > 0:
            self.prefix_cache = self._make_prefix_cache()
            self.pool = init_kv_cache(
                cfg, self._prefix_rows, self.max_len, device=self.device,
                mesh=self.mesh,
            )
        # pool row pinned per slot while its request is in flight
        self._slot_row: List[Optional[int]] = [None] * self.n_slots

    @property
    def mesh_shape(self) -> Dict[str, int]:
        """The replica's slice shape (heartbeat payload)."""
        return {"tp": self.mesh_tp}

    @property
    def n_chips(self) -> int:
        """Devices this replica occupies: the auto-scaler's unit."""
        return self.mesh_tp

    @property
    def kernel_path(self) -> str:
        """Which attention body the per-token paged decode step runs:
        "kernel" (the paged-attention kernel, per head shard at tp > 1)
        or "reference" (the gathered dense view), decided on the global
        shapes as the decode step decides it (`paged_attention.
        takes_kernel`, the per-shard gate at tp > 1; JAX
        `_probe_kernel_path` :1699). The dense layout and
        attn_impl="reference" always take the reference."""
        if not self._paged or getattr(self.cfg, "attn_impl",
                                      "auto") == "reference":
            return "reference"
        cfg = self.cfg
        q_shape = (self.n_slots, cfg.n_heads, cfg.head_dim)
        pages_shape = (self.n_pages, self.page_size, cfg.n_kv_heads,
                       cfg.head_dim)
        table_shape = tuple(self._table.shape)
        if _pa.takes_kernel(q_shape, pages_shape, table_shape, self.device,
                            tp=self.mesh_tp):
            return "kernel"
        return "reference"

    # -- elastic resize ----------------------------------------------------

    def device_health(self) -> Dict[str, int]:
        """The device set of this replica's slice: the injector's
        lose_chip plans supply the deficit (the JAX engine's own
        source)."""
        lost = 0
        if self.chaos is not None:
            lost = int(self.chaos.chips_lost(self.chaos_tag))
        total = int(self._full_tp)
        return {
            "chips_total": total,
            "chips_lost": min(lost, total),
            "chips_up": max(total - lost, 0),
        }

    def surviving_chips(self) -> int:
        return self.device_health()["chips_up"]

    def resize(self, n_chips: Optional[int] = None):
        """Re-form the slice live at the largest valid tp <= `n_chips`
        (default: what device_health reports), never past the
        constructed tp, preempting every live request for replay
        (serving/elastic.py). At the current tp a reported no-op."""
        from dlrover_tpu_torch.serving import elastic

        if n_chips is None:
            n_chips = self.surviving_chips()
        return elastic.resize(self, n_chips)

    def elastic_stats(self) -> Dict[str, float]:
        """The JAX engine's elastic counters: resizes by direction and
        their downtime, the refresh outcomes, the replays (of resizes
        and live refreshes), the version and the slice's tp."""
        return {
            "resize_shrink": float(self._elastic_resize["shrink"]),
            "resize_grow": float(self._elastic_resize["grow"]),
            "refresh_committed": float(self._elastic_refresh["committed"]),
            "refresh_deferred": float(self._elastic_refresh["deferred"]),
            "refresh_rolled_back": float(
                self._elastic_refresh["rolled_back"]),
            "resize_downtime_ms": self._elastic_downtime_ms,
            "replayed_requests": float(self._elastic_replayed),
            "weight_version": float(self._weight_version),
            "tp": float(self.mesh_tp),
            "full_tp": float(self._full_tp),
        }

    # -- admission ---------------------------------------------------------

    def submit(
        self,
        prompt: Sequence[int],
        max_new: Optional[int] = None,
        prng_key=None,
        adapter_id: Optional[str] = None,
    ) -> int:
        """Queue one request; returns its index in the output list.
        `max_new` caps THIS request's generation; default is the
        engine's. `prng_key` (an int, or a key's 32-bit words) seeds the
        request's sampling generator; a generator state (a torch.uint8
        tensor, as `live_request_keys` reports it) continues that
        stream instead, as a JAX key continues its split chain; omitted,
        the engine draws a seed at admission. `adapter_id` names a
        registered adapter to decode under (None: the base model)."""
        # a deferred refresh commits BEFORE the request enters the
        # queue: it starts (and fences) on the new version
        self._maybe_commit_refresh()
        arr = np.asarray(prompt, np.int64)
        if arr.ndim != 1 or arr.size == 0:
            raise ValueError("prompt must be a non-empty 1-D sequence")
        if max_new is not None and max_new < 1:
            raise ValueError(
                f"max_new must be >= 1, got {max_new} (omit it for "
                "the engine default)"
            )
        if arr.size + 1 > self.max_len:
            raise ValueError(
                f"prompt length {arr.size} leaves no room to generate "
                f"(max_len {self.max_len})"
            )
        if adapter_id is not None and self._adapter_cache is None:
            raise ValueError(
                "adapter_id requires an engine constructed with "
                "adapter_registry=... (multi-adapter serving is off)"
            )
        gen_state = None
        if isinstance(prng_key, torch.Tensor) and prng_key.dtype == torch.uint8:
            # a journaled generator state: no seed is drawn for it
            gen_state, seed = prng_key.clone(), 0
        else:
            seed = None if prng_key is None else _seed_of(prng_key)
        aslot = 0
        if adapter_id is not None:
            # pin the bank slot for the request's whole ledger life.
            # KeyError (unregistered id) and AdapterCacheFull (every
            # slot pinned) come before the request enters the ledger
            aslot = self._adapter_cache.acquire(adapter_id)
        req = _Request(
            idx=self._next_idx, prompt=arr, max_new=max_new or 0,
            seed=seed, adapter_id=adapter_id, adapter_slot=aslot,
            gen_state=gen_state,
        )
        self._next_idx += 1
        self._requests[req.idx] = req
        self._pending[req.idx] = None
        self._queue.append(req)
        return req.idx

    def submit_adopted(self, pkg) -> int:
        """Queue a request whose prompt KV was prefilled on another
        engine (a serving/handoff.py KVHandoff): its admission installs
        the shipped cells instead of running the prefill, and decodes
        under the package's seed as the colocated engine would."""
        idx = self.submit(pkg.prompt, max_new=pkg.max_new,
                          prng_key=pkg.prng_key)
        self._requests[idx].adopted = pkg
        return idx

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device, without synchronizing
        the stream (`_device.upload`)."""
        return upload(arr, self.device)

    def _pad_to(self, toks: np.ndarray, bucket: int) -> torch.Tensor:
        padded = np.full(bucket, self.pad_id, np.int64)
        padded[: len(toks)] = toks
        return self._upload(padded)

    def _admit(self, slot: int, req: _Request):
        p = len(req.prompt)
        # the stall this admission charges the step loop (with
        # prefill_chunk > 0 only host bookkeeping: the prefill moves
        # into the interleaved dispatches)
        t0 = time.perf_counter()
        pf_start: Optional[int] = None
        # set before the prefill, which gathers this slot's adapter
        self.adapt[slot] = req.adapter_slot
        if req.adopted is not None:
            # handoff: install the shipped KV and skip the prefill. The
            # package is single use: a later preemption replays
            from dlrover_tpu_torch.serving import handoff

            pkg, req.adopted = req.adopted, None
            handoff.adopt_into_slot(self, slot, pkg)
        elif self._prefill_chunk > 0:
            # a preempted readmission that raises OutOfPages goes back
            # to the queue still marked (see _admit_chunked_paged)
            pf_start = self._admit_chunked(slot, req, p)
            if self._paged and req.preempted:
                req.preempted = False
                self._swap_resumes += 1
        elif self._paged:
            if req.preempted:
                req.preempted = False
                self._swap_resumes += 1
            self._admit_paged(slot, req, p)
        elif req.adapter_id is not None:
            # adapted admission: the prompt K/V comes from the adapted
            # projections, and never from or into the prefix pool
            bucket = min(_pad_bucket(p), self.max_len)
            prefill_into_slot(self.cfg, self.params,
                              self._pad_to(req.prompt, bucket), self.cache,
                              slot, adapters=self._adapter_args([slot]),
                              mesh=self.mesh)
        elif self.prefix_cache is None:
            bucket = min(_pad_bucket(p), self.max_len)
            prefill_into_slot(self.cfg, self.params,
                              self._pad_to(req.prompt, bucket), self.cache,
                              slot, mesh=self.mesh)
        else:
            self._admit_with_prefix(slot, req, p)
        self.admissions += 1
        # carry = last REAL prompt token at its position: the first
        # chunk step recomputes its logits (identical K/V rewrite) and
        # samples the first new token from them
        self.tok[slot] = req.prompt[-1]
        self.pos[slot] = p - 1
        self.limit[slot] = min(p + (req.max_new or self.max_new), self.max_len)
        if req.seed is None:
            req.seed = int(
                torch.randint(0, 2**62, (1,), generator=self._seed_gen)
            )
        self.done[slot] = False
        self.slot_req[slot] = req
        if self.spec is not None:
            self.spec.begin_slot(slot, req.prompt)
        if pf_start is None:
            self._slot_gen[slot] = self._make_gen(req)
        else:
            # occupied, but frozen in the dispatches (and drawing
            # nothing) until _flip_to_decode
            self._prefilling[slot] = True
            self._frontier[slot] = pf_start
            self._slot_gen[slot] = None
        if self.replica_role == "prefill" and pf_start is None:
            # the prompt's KV is resident: the prefill is done. The
            # request waits for export; this role never decodes (a
            # chunked admission waits from _flip_to_decode instead)
            self._prefill_ready.append(req)
            if self._prefill_chunk > 0:
                # interleaved dispatches run on for the other slots:
                # hold this one frozen in them
                self._export_hold[slot] = True
        self._admission_stall_ms += (time.perf_counter() - t0) * 1e3

    def _make_gen(self, req: _Request) -> torch.Generator:
        """The request's sampling generator: its state at preemption
        when it is a replay of a decoding slot, else seeded afresh."""
        gen = torch.Generator(device=self.device)
        if req.gen_state is not None:
            gen.set_state(req.gen_state)
            return gen
        return gen.manual_seed(req.seed)

    def _admit_with_prefix(self, slot: int, req: _Request, p: int):
        """Prefix-cached dense admission: install the longest cached
        block-aligned prefix, prefill only the suffix bucket, publish the
        request's own aligned prefix for the next arrival."""
        pc = self.prefix_cache
        if self.kv_tier is not None:
            self._tier_promote_prefix(req)
        matched, row = pc.match(req.prompt)
        # a matched depth whose suffix bucket would overrun max_len
        # retreats block by block (the pool row stays valid for any
        # shallower start); start 0 degrades to a cold admission
        start = min(matched, p)
        while start > 0 and start + _pad_bucket(p - start) > self.max_len:
            start -= pc.block
        start = max(start, 0)
        work = None
        if start <= 0 or row is None:
            bucket = min(_pad_bucket(p), self.max_len)
            work = prefill_exact_row(self.cfg, self.params,
                                     self._pad_to(req.prompt, bucket),
                                     self.max_len, mesh=self.mesh)
            install_exact_row(self.cache, work, slot)
            pc.record_admission(0)
        else:
            # pinned for the life of the slot's occupancy
            pc.acquire(row)
            self._slot_row[slot] = row
            if start >= p:
                # a full-prefix hit: no prefill at all (the first chunk
                # step recomputes the last prompt token's logits)
                install_exact_row(self.cache, pool_take_row(self.pool, row),
                                  slot)
            else:
                suffix = self._pad_to(req.prompt[start:],
                                      _pad_bucket(p - start))
                work = prefill_suffix_row(self.cfg, self.params, suffix,
                                          pool_take_row(self.pool, row),
                                          start, mesh=self.mesh)
                install_exact_row(self.cache, work, slot)
            pc.record_admission(start)
        # publish at admission, not retire: the next request of this
        # very batch (the shared-system-prompt case) already hits
        publish_len = pc.aligned_len(p)
        if work is not None and publish_len > matched:
            new_row, is_new = pc.insert(req.prompt[:publish_len])
            if is_new:
                pool_put_row(self.pool, work, new_row)

    def _admit_chunked(self, slot: int, req: _Request, p: int):
        """Chunked admission (prefill_chunk > 0): run NO prompt forward
        here, only install any cached prefix. Returns the initial
        frontier (0 cold, the matched depth warm), or None for a full
        prefix hit (the slot then admits live). Chunked admissions never
        publish: that needs the exact work row a blocking prefill
        returns, which the chunked path never makes."""
        if self._paged:
            return self._admit_chunked_paged(slot, req, p)
        pc = self.prefix_cache
        start = 0
        # adapted requests bypass the prefix cache, as when blocking
        if pc is not None and req.adapter_id is None:
            if self.kv_tier is not None:
                self._tier_promote_prefix(req)
            matched, row = pc.match(req.prompt)
            start = min(matched, p)
            if start > 0 and row is not None:
                pc.acquire(row)
                self._slot_row[slot] = row
                # the whole cached row: cells past the matched depth are
                # dead, each chunk writes cell j before a query attends j
                install_exact_row(self.cache, pool_take_row(self.pool, row),
                                  slot)
                pc.record_admission(start)
                if start >= p:
                    return None
            else:
                start = 0
                pc.record_admission(0)
        return start

    def _admit_chunked_paged(self, slot: int, req: _Request, p: int):
        """Paged twin of _admit_chunked: allocate the slot's WHOLE page
        run up front (every chunk position must map to an owned page),
        share a matched prefix's leading pages copy-free, and report the
        frontier. No retreat loop: chunks are exact slices of the prompt.

        Only a never-preempted arrival may reclaim by preempting a live
        slot: a chunked admission installs only a frontier, so two
        requests that fit alone but not together would otherwise evict
        each other's zero-token frontiers forever. A preempted
        readmission that cannot allocate waits in the queue (step()
        puts it back) until a live slot retires."""
        pc = self.prefix_cache
        lora = req.adapter_id is not None
        if self.kv_tier is not None and self._tier_swap_in(slot, req, p):
            # a full swap-in: the run is resident and exclusively owned,
            # the slot admits live (the full-hit semantics)
            return None
        n_need = self._request_pages(req)
        matched, row, start = 0, None, 0
        if pc is not None and not lora:
            if self.kv_tier is not None:
                self._tier_promote_prefix(req)
            matched, row = pc.match(req.prompt)
            start = min(matched, p)
            if row is None or row not in self._row_pages:
                start = 0
        shared: List[int] = []
        if start > 0:
            pc.acquire(row)
            self._slot_row[slot] = row
            shared = self._row_pages[row][: start // self.page_size]
            self.allocator.share(shared)
        try:
            own = self._alloc_pages(
                n_need - len(shared), swap_ok=not req.preempted
            )
        except OutOfPages:
            if shared:
                self.allocator.free(shared)
                self._release_slot_row(slot)
            raise
        run = shared + own
        self._slot_pages[slot] = run
        full_hit = pc is not None and start >= p and start > 0
        if full_hit:
            # decode's first step rewrites cell p-1, inside a shared
            # page: copy it before the table row is built
            self._cow_frontier(slot, p)
        self._table[slot] = self._table_row(run)
        if pc is not None and not lora:
            pc.record_admission(start)
        if full_hit:
            return None
        # start is block-aligned and the block a page multiple, so the
        # first chunk write lands in an OWN page: no warm-path CoW
        return start

    def _release_slot_row(self, slot: int):
        row = self._slot_row[slot]
        if row is not None:
            self.prefix_cache.release(row)
            self._slot_row[slot] = None

    def _on_prefix_evict(self, row: int, blocks=()) -> None:
        """Radix eviction callback: a paged prefix's page run drops its
        reference (pages nobody else holds go back to the free list).
        With the tier on, the eviction demotes the row first: its exact
        bytes are gathered and their host copy started before the run
        is released."""
        run = self._row_pages.pop(row, None) if self._paged else None
        if self.kv_tier is not None and blocks:
            self._tier_demote_row(row, blocks)
        if run:
            self.allocator.free(run)

    # -- host-DRAM KV tier (serving/kv_tier.py) ----------------------------

    def _tier_demote_row(self, row: int, blocks) -> None:
        """Demote an evicted published prefix: gather its exact pool row
        (a pow2-bucket width) and hand the in-flight copies to the tier.
        Never raises into the eviction: a failed demotion (tier full, a
        fault mid-demotion) lets the prefix die as it would without the
        tier, and readmission prefills cold."""
        tokens = [t for blk in blocks for t in blk]
        depth = len(tokens)
        if depth <= 0 or self.pool is None:
            return
        w = min(_pad_bucket(depth), self.max_len)
        try:
            staged = _kv_tier.snapshot_row(self.pool, row, w)
            self.kv_tier.put_prefix(tokens, staged, depth)
        except Exception:  # the eviction must complete regardless
            self.kv_tier.note_demote_failure()

    def _tier_alloc(self, n: int, swap_ok: bool = True) -> List[int]:
        """_alloc_pages' promotion twin: the same reclaim loop, with the
        pages counted by allocator.promote()."""
        while True:
            try:
                return self.allocator.promote(n)
            except OutOfPages:
                if not self._reclaim_pages(swap_ok):
                    raise

    def _tier_promote_prefix(self, req: _Request) -> None:
        """Before an admission's match: when the tier holds a prefix of
        the prompt strictly deeper than the radix cache's, upload it into
        a fresh pool row (paged: and into promoted pages through
        paged_install_row) and re-publish it, so the match that follows
        hits it through the usual warm / full-hit paths."""
        tier, pc = self.kv_tier, self.prefix_cache
        if tier is None or pc is None or self._tier_promote != "always":
            return
        matched, _ = pc.match(req.prompt)
        ent = tier.match_prefix(req.prompt, min_depth=matched)
        if ent is None:
            return
        tier.acquire(ent)
        try:
            pages = None
            if self._paged:
                try:
                    pages = self._tier_alloc(ent.depth // self.page_size,
                                             swap_ok=not req.preempted)
                except OutOfPages:
                    return  # pool dry: the admission proceeds cold
            row, is_new = pc.insert(list(ent.tokens))
            if row is None or not is_new:
                # every row pinned, or the prefix is there already
                if pages:
                    self.allocator.free(pages)
                return
            dev_row = _kv_tier.upload_row(self.pool, ent, row)
            if pages is not None:
                w = next(iter(ent.data.values())).shape[2]
                _kv_tier.install_row_pages(self.page_pool, dev_row,
                                           self._table_row(pages), w)
                self._row_pages[row] = pages
            tier.note_promoted(ent)
        finally:
            tier.release(ent)

    def _tier_swap_in(self, slot: int, req: _Request, p: int) -> bool:
        """Swap-to-host readmission: when the tier holds this exact
        folded sequence's page run, promote fresh pages, scatter the
        stored bytes onto them and point the slot's table at them; the
        prefill is skipped and the admission tail resumes from the
        folded position. False: the caller admits by replay."""
        tier = self.kv_tier
        if tier is None or not self._tier_swap or self._tier_promote == "never":
            return False
        ent = tier.peek_swap(req.prompt, salt=req.adapter_id or "")
        if ent is None:
            return False
        n_need = self._request_pages(req)
        if ent.n_pages > n_need or ent.page_size != self.page_size:
            return False
        tier.acquire(ent)
        try:
            try:
                pages = self._tier_alloc(n_need, swap_ok=not req.preempted)
            except OutOfPages:
                return False  # the replay path may still fit by sharing
            self._slot_pages[slot] = pages
            _kv_tier.upload_pages(self.page_pool, ent, pages[:ent.n_pages])
            self._table[slot] = self._table_row(pages)
        finally:
            tier.release(ent)
        tier.consume(ent)
        return True

    def _tier_swap_out_slot(self, slot: int, tokens) -> None:
        """Swap-to-host demotion of a preempted victim: gather the pages
        covering its valid cells [0, len(tokens)) and start their host
        copies before the run is freed. Only a cleanly decoding slot
        qualifies (a mid-prefill one replays cheaply); any failure
        leaves replay as the fallback."""
        tier = self.kv_tier
        if (tier is None or not self._tier_swap or not self._paged
                or self._prefilling[slot] or self._export_hold[slot]):
            return
        p = len(tokens)
        if p <= 0 or int(self.pos[slot]) + 1 != p:
            return
        run = self._slot_pages[slot]
        n_keep = (p - 1) // self.page_size + 1
        if n_keep > len(run):
            return
        req = self.slot_req[slot]
        salt = (req.adapter_id or "") if req is not None else ""
        try:
            staged = _kv_tier.snapshot_pages(self.page_pool, run[:n_keep])
            tier.put_swap(tokens, staged, n_keep, self.page_size, salt=salt)
        except Exception:  # the preemption must complete regardless
            tier.note_demote_failure()

    def swap_out(self, idx: int) -> None:
        """cancel() with demotion (a scheduler's admission preemption):
        the victim's live page run swaps to host, and its readmission
        promotes it back instead of replaying the prefill. Exactly
        cancel() when the tier is off or the slot does not qualify."""
        req = self._requests.get(idx)
        if (req is not None and self.kv_tier is not None
                and self._tier_swap and self._paged):
            for slot in range(self.n_slots):
                if self.slot_req[slot] is req and not self.done[slot]:
                    tokens = list(req.prompt) + [
                        int(t) for t in req.out[req.folded:]
                    ]
                    self._tier_swap_out_slot(slot, tokens)
                    break
        self.cancel(idx)

    def kv_tier_stats(self) -> Dict[str, float]:
        """Host-tier telemetry (bytes, entries, demotion / promotion /
        swap / eviction counters, promote hit rate); {} when off."""
        if self.kv_tier is None:
            return {}
        return self.kv_tier.stats()

    def health_stats(self) -> Dict[str, float]:
        """KV-integrity telemetry: verifications and quarantines across
        every checksum site of this engine (tier ingress, handoff
        adopt); {} with the knob off and nothing ever verified."""
        checks = float(self._integrity_checks)
        quarantines = float(self._integrity_quarantines)
        if self.kv_tier is not None:
            ts = self.kv_tier.stats()
            checks += ts["integrity_checks"]
            quarantines += ts["quarantines"]
        if not self.kv_checksums and checks == 0 and quarantines == 0:
            return {}
        return {
            "kv_checksums": float(self.kv_checksums),
            "integrity_checks": checks,
            "integrity_quarantines": quarantines,
        }

    def _request_pages(self, req: _Request) -> int:
        """Exact page need: the request's OWN limit (prompt plus its
        budget, capped at max_len). The highest cell ever written is
        limit-1+K (a frozen done slot rewrites its last cell; a verify
        window extends K past it)."""
        p = len(req.prompt)
        limit = min(p + (req.max_new or self.max_new), self.max_len)
        return (limit - 1 + self.spec_draft_len) // self.page_size + 1

    def _table_row(self, run: List[int]) -> torch.Tensor:
        vals = np.full(self._pages_per_slot, TRASH_PAGE, np.int32)
        vals[: len(run)] = run
        return self._upload(vals)

    def _admit_paged(self, slot: int, req: _Request, p: int):
        """Paged admission: size the page run off the request's OWN
        limit, point the leading table entries at a matched prefix's
        pages copy-free, allocate the rest, and install only the cells
        the shared pages do not hold. A dry pool is resolved inline:
        evict unreferenced prefix runs, then preempt the coldest live
        request. An adapted request bypasses the prefix cache both ways:
        a published prefix holds base-model K/V, and its own K/V must
        never publish."""
        pc = self.prefix_cache
        lora = req.adapter_id is not None
        if self.kv_tier is not None and self._tier_swap_in(slot, req, p):
            # a full swap-in: the resumed run is resident and owned; the
            # admission tail restores carry / pos / limit / generator
            return
        n_need = self._request_pages(req)
        matched, row, start = 0, None, 0
        if pc is not None and not lora:
            if self.kv_tier is not None:
                self._tier_promote_prefix(req)
            matched, row = pc.match(req.prompt)
            start = min(matched, p)
            while (start > 0
                   and start + _pad_bucket(p - start) > self.max_len):
                start -= pc.block
            start = max(start, 0)
            if row is None or row not in self._row_pages:
                start = 0
        shared: List[int] = []
        if start > 0:
            # pin the matched row BEFORE any reclaim can run: an
            # eviction must never free the run being shared
            pc.acquire(row)
            self._slot_row[slot] = row
            shared = self._row_pages[row][: start // self.page_size]
            self.allocator.share(shared)
        try:
            own = self._alloc_pages(n_need - len(shared))
        except OutOfPages:
            if shared:
                self.allocator.free(shared)
                self._release_slot_row(slot)
            raise
        run = shared + own
        self._slot_pages[slot] = run
        full_hit = pc is not None and start >= p and start > 0
        if full_hit:
            # the write frontier (cell p-1, rewritten by the first chunk
            # step) sits in the last shared page: copy it now
            self._cow_frontier(slot, p)
        table_row = self._table_row(run)
        work = None
        if full_hit:
            # the table row is the only device write a full hit needs
            pc.record_admission(start)
        elif start > 0:
            suffix = self._pad_to(req.prompt[start:], _pad_bucket(p - start))
            work = prefill_suffix_row(self.cfg, self.params, suffix,
                                      pool_take_row(self.pool, row), start,
                                      mesh=self.mesh)
            paged_install_row(self.page_pool, work, table_row, start,
                              suffix.shape[0])
            pc.record_admission(start)
        elif lora:
            bucket = min(_pad_bucket(p), self.max_len)
            row_cache = prefill_exact_row(
                self.cfg, self.params, self._pad_to(req.prompt, bucket),
                self.max_len, adapters=self._adapter_args([slot]),
                mesh=self.mesh,
            )
            # `work` stays None: this row must never publish
            paged_install_row(self.page_pool, row_cache, table_row, 0,
                              bucket)
        else:
            bucket = min(_pad_bucket(p), self.max_len)
            work = prefill_exact_row(self.cfg, self.params,
                                     self._pad_to(req.prompt, bucket),
                                     self.max_len, mesh=self.mesh)
            paged_install_row(self.page_pool, work, table_row, 0, bucket)
            if pc is not None:
                pc.record_admission(0)
        self._table[slot] = table_row
        # publish AFTER install (the published pages must hold the
        # installed bytes): the run's leading pages become the radix
        # entry's run by refcount alone; the exact work row goes to the
        # prefix pool as the source of later suffix prefills
        if pc is not None and work is not None:
            publish_len = pc.aligned_len(p)
            if publish_len > matched:
                new_row, is_new = pc.insert(req.prompt[:publish_len])
                if is_new:
                    pub = list(run[: publish_len // self.page_size])
                    self.allocator.share(pub)
                    self._row_pages[new_row] = pub
                    pool_put_row(self.pool, work, new_row)
        # whoever now shares the frontier page (the publish of a
        # page-aligned prompt), the SLOT must own its copy before decode
        # rewrites cell p-1
        self._cow_frontier(slot, p)

    def _cow_frontier(self, slot: int, p: int) -> None:
        """Make the slot the only owner of the page holding its write
        frontier (cell p-1): a shared page is copied to a fresh one the
        slot then writes, and readers keep the original. The only CoW
        site: every cell the slot writes later lies past every
        published run."""
        run = self._slot_pages[slot]
        idx = (p - 1) // self.page_size
        if idx >= len(run):
            return
        page = run[idx]
        if self.allocator.refcount(page) <= 1:
            return
        while True:
            try:
                fresh, copied = self.allocator.cow(page)
                break
            except OutOfPages:
                if not self._reclaim_pages():
                    raise
        if copied:
            pool_copy_page(self.page_pool, page, fresh)
            run[idx] = fresh
            self._table[slot, idx] = fresh

    # -- reclaim (paged) ---------------------------------------------------

    def _alloc_pages(self, n: int, swap_ok: bool = True) -> List[int]:
        """Allocate with reclaim: on a dry pool evict LRU unreferenced
        prefix runs first, then preempt live requests until the
        allocation fits. swap_ok=False (a preempted chunked readmission)
        stops after eviction. Raises OutOfPages only when nothing is
        left to reclaim."""
        while True:
            try:
                return self.allocator.alloc(n)
            except OutOfPages:
                if not self._reclaim_pages(swap_ok):
                    raise

    def _reclaim_pages(self, swap_ok: bool = True) -> bool:
        """One reclaim step: eviction (no replay) before preemption."""
        pc = self.prefix_cache
        if pc is not None and pc.evict_lru():
            return True  # _on_prefix_evict freed the run
        if not swap_ok:
            return False
        slot = self._pick_preempt_slot()
        if slot is None:
            return False
        self._preempt_slot(slot)
        return True

    def _slot_progress(self, slot: int) -> int:
        """Preemption coldness of an occupied slot: mid-decode its pos
        (the resident cells a replay recomputes); mid-prefill NEGATIVE
        (frontier minus prompt length), so a slot that emitted nothing
        ranks colder than any decoding one."""
        if self._prefilling[slot]:
            return int(self._frontier[slot]) - len(self.slot_req[slot].prompt)
        return int(self.pos[slot])

    def _pick_preempt_slot(self) -> Optional[int]:
        """The coldest live slot (least progress; ties to the lowest
        slot index, so runs are reproducible)."""
        best, best_prog = None, None
        for slot in range(self.n_slots):
            req = self.slot_req[slot]
            if req is None or (self.done[slot] and not self._prefilling[slot]):
                continue
            prog = self._slot_progress(slot)
            if best_prog is None or prog < best_prog:
                best, best_prog = slot, prog
        return best

    def _preempt_slot(self, slot: int) -> None:
        """Swap a live request out: free its pages and put it back at
        the front of the queue for replay. Its emitted tokens fold into
        its prompt and it keeps the same absolute cap, so greedy replay
        gives the same tokens; a decoding slot's generator state rides
        along, so a sampled replay continues the same stream. A
        mid-prefill victim re-queues with nothing emitted and replays
        its admission from scratch."""
        req = self.slot_req[slot]
        emitted = np.asarray(req.out[req.folded:], np.int64)
        if emitted.size:
            req.prompt = np.concatenate([req.prompt, emitted])
        req.folded = len(req.out)
        req.max_new = max(int(self.limit[slot]) - len(req.prompt), 1)
        if self._slot_gen[slot] is not None:
            req.gen_state = self._slot_gen[slot].get_state()
        req.preempted = True
        if self.kv_tier is not None:
            # swap-to-host: the victim's valid cells demote before its
            # run is freed (replay stays the fallback)
            self._tier_swap_out_slot(slot, req.prompt)
        self._release_slot(slot)
        # a preempted prefill's KV is gone: it prefills again, it does
        # not export a dead page run
        self._unready(req)
        self._queue.appendleft(req)
        if self._paged:
            self._swap_preemptions += 1

    def _release_slot_pages(self, slot: int) -> None:
        """Drop a slot's page run: host accounting only, the chunk
        routes done rows through the trash page itself."""
        run = self._slot_pages[slot]
        if run:
            self.allocator.free(run)
            self._slot_pages[slot] = []

    def admission_headroom_ok(self) -> bool:
        """Memory-aware admission gate for a scheduler: True when a
        worst-case admission fits the free pool (plus swap_headroom
        slack) without evicting or preempting, counting the exact needs
        of the queued requests. Admission past a False still succeeds
        (the engine reclaims inline). Dense layout: always True."""
        if not self._paged:
            return True
        pending = sum(self._request_pages(r) for r in self._queue)
        want = min(
            self._pages_per_slot + self.swap_headroom,
            self.allocator.capacity,
        )
        return self.allocator.free_pages >= pending + want

    def paged_stats(self) -> Dict[str, float]:
        """Page-pool telemetry: occupancy, sharing, CoW copies and the
        preemption counters; {} under the dense layout."""
        if not self._paged:
            return {}
        s = self.allocator.stats()
        s["swap_preemptions"] = float(self._swap_preemptions)
        s["swap_resumes"] = float(self._swap_resumes)
        return s

    def adapter_stats(self) -> Dict[str, float]:
        """Adapter-serving telemetry: registry size, bank residency,
        hit / miss / eviction / upload counters and the ledger's
        adapted requests. {} when multi-adapter serving is off."""
        if self._adapter_cache is None:
            return {}
        s = {k: float(v) for k, v in self._adapter_cache.stats().items()}
        s["registered"] = float(len(self.adapter_registry))
        s["active_requests"] = float(sum(
            1 for r in self._requests.values() if r.adapter_id is not None
        ))
        return s

    def adapter_active(self) -> Dict[str, int]:
        """Ledger-live (queued, in a slot, or finished and not retired)
        request count per adapter id."""
        out: Dict[str, int] = {}
        for r in self._requests.values():
            if r.adapter_id is not None:
                out[r.adapter_id] = out.get(r.adapter_id, 0) + 1
        return out

    def adapter_residency(self) -> List[str]:
        """Adapter ids resident in the bank (most recently used last);
        [] when adapters are off."""
        if self._adapter_cache is None:
            return []
        return self._adapter_cache.resident_ids()

    def prefill_stats(self) -> Dict[str, float]:
        """Chunked-prefill telemetry: the knob, the admission stall
        charged to the step loop, interleaved chunks dispatched, and the
        slots mid-prefill now (zeros at prefill_chunk=0)."""
        return {
            "prefill_chunk": float(self._prefill_chunk),
            "admission_stall_ms": self._admission_stall_ms,
            "prefill_chunks_total": float(self._prefill_chunks_total),
            "prefilling_slots": float(int(self._prefilling.sum())),
        }

    # -- the loop ----------------------------------------------------------

    def has_work(self) -> bool:
        """True while any slot is live, the queue holds requests, or a
        dispatch is in flight (async_depth=1: its events have not
        surfaced yet, so one more step() is owed)."""
        return (bool(self._queue) or not self.done.all()
                or self._inflight is not None)

    def queue_len(self) -> int:
        """Requests waiting for a slot (excludes live slots)."""
        return len(self._queue)

    def active_count(self) -> int:
        """Slots currently occupied (decoding or mid-prefill)."""
        return int((~self.done).sum())

    def free_slots(self) -> int:
        return self.n_slots - self.active_count()

    def drain_inflight(self) -> None:
        """Abandon the dispatched-but-unharvested step, if any: its
        events never surface, and the host mirrors stay at the last
        harvested dispatch, from which the next dispatch runs again
        (rewriting the same cells). Each sampling generator goes back to
        its state before the abandoned draws, so the re-run (or a
        replay) draws what it drew, as JAX's key mirror does."""
        pend, self._inflight = self._inflight, None
        if pend is not None and pend.gens is not None:
            for slot, snap in enumerate(pend.gens):
                if snap is not None and self._slot_gen[slot] is snap[0]:
                    snap[0].set_state(snap[1])

    def _gen_snapshot(self) -> Optional[list]:
        """The slot generators' states before a sampled dispatch draws
        (host-side state: no device work); None when greedy."""
        if self.temperature <= 0.0:
            return None
        return [None if g is None else (g, g.get_state())
                for g in self._slot_gen]

    def step_stats(self) -> Dict[str, float]:
        """Cumulative step-latency stats: host_ms (host work inside
        step(), waits excluded), device_wait_ms (time blocked on a
        dispatch's results), dispatches, and overlap_ratio = the device
        span the host hid / the whole span from enqueue to harvest
        (~0 at depth 0)."""
        ratio = (self._stat_overlap_ms / self._stat_span_ms
                 if self._stat_span_ms > 0 else 0.0)
        return {
            "host_ms": self._stat_host_ms,
            "device_wait_ms": self._stat_wait_ms,
            "dispatches": float(self._stat_dispatches),
            "overlap_ratio": ratio,
        }

    def _next_chunk_len(self) -> int:
        """Dispatch size: `chunk` steps, shortened only when EVERY
        decoding slot's remaining cap (limit - pos - 1) is smaller; the
        tail quantizes down to a power of two (as the JAX engine does,
        where each distinct length is its own compiled program).
        Mid-prefill slots do not count; with only those occupied the
        decode half is one vacuous step."""
        live = ~self.done & ~self._prefilling & ~self._export_hold
        if not live.any():
            return 1
        rem = int((self.limit - self.pos - 1)[live].max())
        k_target = max(1, min(rem, self.chunk))
        if k_target == self.chunk:
            return k_target
        k = 1
        while k * 2 <= k_target:
            k *= 2
        return k

    def _pf_chunk_len(self, rem: int) -> int:
        """Prompt tokens of one interleaved dispatch: prefill_chunk, the
        tail quantized DOWN to a power of two and never padded (a pad
        tail would write pad K/V into real cells)."""
        c = min(self._prefill_chunk, rem)
        k = 1
        while k * 2 <= c:
            k *= 2
        return k

    def step(self) -> List[StepEvent]:
        """One engine iteration. async_depth=0: admit from the queue
        into free slots, run ONE dispatch, harvest it, return its
        events. async_depth=1: harvest the PREVIOUS dispatch first,
        admit and draft from the refreshed mirrors, enqueue the next
        dispatch without waiting for it, and return the harvested
        events. Both depths run the same dispatches on the same state;
        only the call on which events surface moves. [] when there is
        no work."""
        t0 = time.perf_counter()
        self._wait_this_step = 0.0
        self._maybe_commit_refresh()  # a deferred swap at the idle fence
        try:
            if self.chaos is not None:
                # before any admission or dispatch: an injected fault
                # leaves the queue, ledger and caches as they were
                step_no = self._step_no
                self._step_no += 1
                self.chaos.on_engine_step(self.chaos_tag, step_no)
            if self.kv_tier is not None:
                # complete the demotion copies started since the last
                # step (a whole dispatch ago: a completion, not a stall)
                self.kv_tier.drain()
            events = self._harvest()
            for slot in range(self.n_slots):
                if self.done[slot] and self._queue:
                    req = self._queue.popleft()
                    try:
                        self._admit(slot, req)
                    except OutOfPages:
                        # chunked admission only: a preempted
                        # readmission has no swap rights, so a dry pool
                        # means wait at the front of the queue while
                        # the live slots drain. Nothing live to wait on
                        # still raises.
                        if self._prefill_chunk == 0 or not any(
                            r is not None for r in self.slot_req
                        ):
                            raise
                        self._queue.appendleft(req)
                        break
            can_decode = (not self.done.all()
                          and self.replica_role != "prefill")
            pf_pending = bool(self._prefilling.any())
            if can_decode or pf_pending:
                if pf_pending:
                    # a verify carries no prefill half: drafting
                    # resumes once no slot is mid-prefill. A prefill
                    # engine dispatches these too (its chunked prefills
                    # advance only here; the decode half is vacuous)
                    self._dispatch_interleaved()
                elif self.spec is not None:
                    drafts, dlens = self._collect_drafts()
                    if int(dlens.max()) > 0:
                        self._dispatch_spec(drafts, dlens)
                    else:
                        # no live slot drafted: the plain chunk
                        self._dispatch_chunk()
                else:
                    self._dispatch_chunk()
                if self.async_depth == 0:
                    events = self._harvest()
        except Exception:
            # a raising step orphans its in-flight dispatch: its events
            # must never surface later, and its draws are taken back (a
            # replay after a live resize redraws them, as JAX's key
            # mirror does)
            self.drain_inflight()
            raise
        self._stat_host_ms += (
            (time.perf_counter() - t0) * 1e3 - self._wait_this_step
        )
        return events

    def _warp(self, logits: torch.Tensor) -> torch.Tensor:
        """Temperature, then top-k and top-p masks, over the last axis."""
        warped = logits / self.temperature
        if 0 < self.top_k < warped.shape[-1]:
            warped = _mask_top_k(warped, self.top_k)
        if self.top_p < 1.0:
            warped = _mask_top_p(warped, self.top_p)
        return warped

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        """Next token per row: argmax when greedy; else a draw from the
        warped distribution with each slot's own generator (free and
        mid-prefill slots take argmax: their token is discarded)."""
        if self.temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(self._warp(logits).float(), dim=-1)
        return _draw_rows(probs, self._slot_gen)

    def _advance(self, logits, tok, pos, done, limit):
        nxt = self._sample(logits)
        nxt = torch.where(done, self.pad_id, nxt)
        hit_eos = (
            nxt == self.eos_id
            if self.eos_id is not None
            else torch.zeros_like(done)
        )
        # tokens generated through this step = pos+2-prompt_len (carry
        # enters at prompt_len-1), so the cap limit = prompt_len +
        # max_new fires at pos+2 >= limit
        new_done = done | hit_eos | (pos + 2 >= limit)
        pos = torch.where(done, pos, pos + 1)
        tok = torch.where(done, tok, nxt)
        return tok, pos, new_done, nxt

    def _dispatch_state(self):
        """The slot state on the device: tok, pos, done (mid-prefill
        slots ride frozen, as done) and limit, and the page table with
        done-at-entry rows routed to the trash page (None when dense).
        Rows finishing MID-dispatch still own their pages: the host
        frees them only after harvesting it."""
        tok = self._upload(self.tok)
        pos = self._upload(self.pos)
        done = self._upload(self.done | self._prefilling | self._export_hold)
        limit = self._upload(self.limit)
        table = None
        if self._paged:
            table = torch.where(done[:, None], TRASH_PAGE, self._table)
        return tok, pos, done, limit, table

    def _dispatch_chunk(self, pf_mask: Optional[np.ndarray] = None):
        """Enqueue k decode steps for every slot and the fetch of the
        new (tok, pos, done) and the emitted tokens [B, k]. `pf_mask`:
        the slots mid-prefill in an interleaved dispatch."""
        k = self._next_chunk_len()
        tok, pos, done, limit, table = self._dispatch_state()
        ad = self._adapter_args()
        gens = self._gen_snapshot()
        emitted = []
        for _ in range(k):
            if self._paged:
                logits, _ = paged_decode_step(
                    self.cfg, self.params, tok, self.page_pool, table, pos,
                    adapters=ad, mesh=self.mesh,
                )
            else:
                logits, _ = decode_step(
                    self.cfg, self.params, tok, self.cache, pos, adapters=ad,
                    mesh=self.mesh,
                )
            tok, pos, done, nxt = self._advance(logits, tok, pos, done, limit)
            emitted.append(nxt)
        self.decode_steps += k
        self._enqueue_fetch(
            _Inflight("chunk", old_pos=self.pos.copy(), pf_mask=pf_mask,
                      version=self._weight_version, gens=gens),
            (tok, pos, done, torch.stack(emitted, dim=1)),
        )

    def _dispatch_interleaved(self):
        """One interleaved dispatch: up to prefill_chunk prompt tokens
        of the OLDEST mid-prefill slot (by request index), written
        through the slot's real table row (paged) or bank row (dense),
        then the usual decode steps with that slot frozen. When the
        chunk reaches the prompt end the slot flips to decoding for the
        next dispatch."""
        slot = min(
            (s for s in range(self.n_slots) if self._prefilling[s]),
            key=lambda s: self.slot_req[s].idx,
        )
        req = self.slot_req[slot]
        p = len(req.prompt)
        start = int(self._frontier[slot])
        plen = self._pf_chunk_len(p - start)
        ptoks = self._upload(req.prompt[start:start + plen])
        # the prefill half gathers only the prefilling slot's adapter
        ad1 = self._adapter_args([slot])
        if self._paged:
            paged_prefill_chunk(self.cfg, self.params, ptoks, self.page_pool,
                                self._table[slot], start, adapters=ad1,
                                mesh=self.mesh)
        else:
            prefill_chunk_into_slot(self.cfg, self.params, ptoks, self.cache,
                                    slot, start, adapters=ad1,
                                    mesh=self.mesh)
        # the slots mid-prefill DURING this dispatch, captured before the
        # flip: harvest must read their fetched done as the freeze
        self._dispatch_chunk(pf_mask=self._prefilling.copy())
        self._frontier[slot] = start + plen
        self._prefill_chunks_total += 1
        if start + plen >= p:
            self._flip_to_decode(slot)

    def _flip_to_decode(self, slot: int) -> None:
        """The frontier reached the prompt end: the slot decodes from
        the next dispatch on, with its generator installed now (it drew
        nothing while frozen). A prefill engine instead holds the slot
        frozen and queues the request for export."""
        self._prefilling[slot] = False
        if self.replica_role != "prefill":
            self._slot_gen[slot] = self._make_gen(self.slot_req[slot])
        else:
            self._export_hold[slot] = True
            self._prefill_ready.append(self.slot_req[slot])

    def _clear_prefill(self, slot: int) -> None:
        self._prefilling[slot] = False
        self._export_hold[slot] = False
        self._frontier[slot] = 0

    def _collect_drafts(self):
        """Padded drafts [n_slots, K] and their lengths [n_slots] of
        every live slot (speculative.py's batched drafting pass)."""
        return self.spec.draft_batch(self.done)

    def _dispatch_spec(self, drafts: np.ndarray, dlens: np.ndarray):
        """Enqueue one verify of the carry token and the drafts of every
        slot (K+1 positions a row), acceptance on the device, and the
        fetch of the new (tok, pos, done), the emitted tokens [B, K+1],
        n_emit and accepted. Rows that drafted nothing degenerate to
        one plain step inside the same verify."""
        tok, pos, done, limit, table = self._dispatch_state()
        gens = self._gen_snapshot()
        d = self._upload(drafts).long()
        dl = self._upload(dlens).long()
        tokens = torch.cat([tok[:, None], d], dim=1)
        # the adapted verify: each row's drafts are judged against the
        # adapter its slot decodes under
        ad = self._adapter_args()
        if self._paged:
            logits, _ = paged_verify_step(self.cfg, self.params, tokens,
                                          self.page_pool, table, pos,
                                          adapters=ad, mesh=self.mesh)
        else:
            logits, _ = verify_step(self.cfg, self.params, tokens,
                                    self.cache, pos, adapters=ad,
                                    mesh=self.mesh)
        self.verify_steps += 1
        self._enqueue_fetch(
            _Inflight("spec", dlens=dlens, was_live=~self.done,
                      version=self._weight_version, gens=gens),
            self._accept(logits, tok, pos, done, limit, d, dl),
        )

    def _accept(self, logits, tok, pos, done, limit, drafts, dlens):
        """Acceptance and the chunk's eos / limit / done rules over one
        verify: -> (tok, pos, done, emitted [B, K+1], n_emit, accepted).
        emitted holds the m accepted drafts, then the extra token (the
        correction on a rejection, the bonus on full acceptance), pad
        beyond; n_emit says how much is real, capped so a live slot
        emits positions pos+1..limit-1 only and cut after an eos.
        `accepted` counts the drafts that shipped. Sampled rows draw
        from their slot's generator; rows without one (free or done)
        emit nothing."""
        k = drafts.shape[1]
        if self.temperature <= 0.0:
            m, extra = spec_accept_greedy(logits, drafts, dlens)
        else:
            probs = torch.softmax(self._warp(logits).float(), dim=-1)
            m = torch.zeros_like(tok)
            extra = torch.zeros_like(tok)
            for row, gen in enumerate(self._slot_gen):
                if gen is not None:
                    mm, ee = spec_accept_sampled(
                        probs[row:row + 1], drafts[row:row + 1],
                        dlens[row:row + 1], gen,
                    )
                    m[row] = mm[0]
                    extra[row] = ee[0]
        idx = torch.arange(k + 1, device=drafts.device)[None, :]
        drafts_p = torch.cat([drafts, torch.zeros_like(drafts[:, :1])], 1)
        emitted = torch.where(
            idx < m[:, None], drafts_p,
            torch.where(idx == m[:, None], extra[:, None], self.pad_id),
        )
        n_emit = torch.minimum(m + 1, (limit - 1 - pos).clamp_min(0))
        if self.eos_id is not None:
            eos_mask = (emitted == self.eos_id) & (idx < n_emit[:, None])
            has_eos = eos_mask.any(dim=1)
            n_emit = torch.where(
                has_eos, torch.argmax(eos_mask.int(), dim=1) + 1, n_emit)
        else:
            has_eos = torch.zeros_like(done)
        n_emit = torch.where(done, 0, n_emit)
        emitted = torch.where(idx < n_emit[:, None], emitted, self.pad_id)
        last = torch.gather(emitted, 1, (n_emit - 1).clamp_min(0)[:, None])
        new_tok = torch.where(n_emit > 0, last[:, 0], tok)
        new_pos = pos + n_emit
        new_done = done | has_eos | (new_pos >= limit - 1)
        accepted = torch.minimum(m, (n_emit - 1).clamp_min(0))
        return new_tok, new_pos, new_done, emitted, n_emit, accepted

    def _enqueue_fetch(self, pend: _Inflight, outs) -> None:
        """Start the copy of a dispatch's outputs, packed into one int64
        vector, into the engine's page-locked buffer (non-blocking on
        the card, with an event recorded after it; immediate on the
        CPU), and hold the dispatch as in flight."""
        pend.shapes = [tuple(t.shape) for t in outs]
        packed = torch.cat([t.reshape(-1).long() for t in outs])
        n = packed.numel()
        cuda = packed.is_cuda
        if self._fetch_buf is None or self._fetch_buf.numel() < n:
            self._fetch_buf = torch.empty(n, dtype=torch.long,
                                          pin_memory=cuda)
        self._fetch_buf[:n].copy_(packed, non_blocking=cuda)
        if cuda:
            pend.event = torch.cuda.Event()
            pend.event.record()
        pend.dispatched_at = time.perf_counter()
        self._inflight = pend

    def _harvest(self) -> List[StepEvent]:
        """Wait for the in-flight dispatch's copy, refresh the host
        mirrors from it and turn it into events ([] when nothing is in
        flight). The wait is the step's bubble: device time the host
        had nothing to overlap with."""
        pend = self._inflight
        self._inflight = None
        if pend is None:
            return []
        w0 = time.perf_counter()
        if pend.event is not None:
            pend.event.synchronize()
        w1 = time.perf_counter()
        wait_ms = (w1 - w0) * 1e3
        span_ms = (w1 - pend.dispatched_at) * 1e3
        self._wait_this_step += wait_ms
        self._stat_wait_ms += wait_ms
        self._stat_span_ms += span_ms
        self._stat_overlap_ms += max(span_ms - wait_ms, 0.0)
        self._stat_dispatches += 1
        flat = self._fetch_buf.numpy()
        host, at = [], 0
        for shape in pend.shapes:
            n = int(np.prod(shape))
            host.append(flat[at:at + n].reshape(shape).copy())
            at += n
        tok, pos, done, emitted = host[:4]
        done = done.astype(bool)
        if pend.kind == "chunk":
            counts = pos - pend.old_pos
        else:
            n_emit, accepted = host[4:]
            counts = n_emit
            for slot in range(self.n_slots):
                if pend.was_live[slot]:
                    self.spec.record(slot, int(pend.dlens[slot]),
                                     int(accepted[slot]), int(n_emit[slot]))
        self.tok, self.pos = tok, pos
        return self._emit_events(emitted, counts, done, pend.version,
                                 pend.pf_mask)

    def _emit_events(self, emitted, counts, new_done, version: int = 0,
                     pf_mask=None) -> List[StepEvent]:
        """`counts[slot]` leading entries of `emitted[slot]` are the
        slot's new tokens. `pf_mask` marks the slots that were
        mid-prefill in the dispatch: their fetched done=True is the
        freeze, not a finish, so they neither emit nor release."""
        events: List[StepEvent] = []
        for slot in range(self.n_slots):
            req = self.slot_req[slot]
            if req is None or req.done:
                continue
            if pf_mask is not None and pf_mask[slot]:
                continue
            if self._export_hold[slot]:
                # prefill role: the fetched done is the hold, not a
                # finish; the pages must survive until export
                continue
            new_toks = [int(t) for t in emitted[slot][: int(counts[slot])]]
            req.out.extend(new_toks)
            if new_toks:
                # one dispatch carries one version
                req.versions.add(version)
            if self.spec is not None and new_toks:
                # whichever path emitted them, the drafter's context
                # must see every token
                self.spec.extend(slot, new_toks)
            finished = bool(new_done[slot])
            if finished:
                req.done = True
                self._slot_gen[slot] = None
                if self._paged:
                    # the tokens are on the host and the KV is dead:
                    # the pages back the NEXT admission
                    self._release_slot_pages(slot)
                if self.prefix_cache is not None:
                    self._release_slot_row(slot)
            if new_toks or finished:
                events.append((req.idx, new_toks, finished))
        self.done = new_done.copy()
        # a slot released while the dispatch was in flight (cancel,
        # retire) must stay free, whatever the dispatch's older done
        for slot in range(self.n_slots):
            if self.slot_req[slot] is None:
                self.done[slot] = True
            elif ((pf_mask is not None and pf_mask[slot])
                  or self._export_hold[slot]):
                # still occupied: the fetched done was the freeze
                self.done[slot] = False
            if self.done[slot]:
                self._park(slot)
        return events

    def _park(self, slot: int) -> None:
        """A free or finished slot's mirrors back to a fresh engine's
        (pad token, position 0, limit 0). A done row still rides every
        dispatch, and on the card its position sets how much work the
        paged kernel's even shares split: a stale one would make a live
        row's sums depend on what the slot served before, so an engine
        after a drain would not compute what a fresh one computes."""
        self.tok[slot] = self.pad_id
        self.pos[slot] = 0
        self.limit[slot] = 0

    def retire(self, idx: int) -> np.ndarray:
        """Drop a request from the ledger and return its continuation;
        the slot it holds, its pages and its prefix row are released."""
        if idx not in self._pending:
            raise KeyError(f"request {idx} is not pending")
        del self._pending[idx]
        req = self._requests.pop(idx)
        for slot in range(self.n_slots):
            if self.slot_req[slot] is req:
                self._release_slot(slot)
        self._unready(req)
        # unpin the adapter with the ledger entry: it stays resident
        # and becomes evictable once nothing else references it
        self._release_adapter(req)
        return np.asarray(req.out, np.int32)

    def _unready(self, req: _Request) -> None:
        """Take a request off the prefill role's export queue, if it is
        there."""
        try:
            self._prefill_ready.remove(req)
        except ValueError:
            pass

    def take_prefilled(self) -> List[_Request]:
        """Drain the prefill role's completion queue: requests whose
        prompt KV is resident and exportable. Each is still live in its
        slot: the caller exports it (serving/handoff.py) and then
        retire()s it, before the slot's pages can be reused."""
        out, self._prefill_ready = self._prefill_ready, []
        return out

    def request_progress(self, idx: int) -> Optional[int]:
        """Preemption coldness of a live request (the `_slot_progress`
        that `_pick_preempt_slot` orders by): pos mid-decode, negative
        mid-prefill; None when the request holds no slot."""
        for slot in range(self.n_slots):
            req = self.slot_req[slot]
            if req is not None and not self.done[slot] and req.idx == idx:
                return self._slot_progress(slot)
        return None

    def live_request_keys(self) -> Dict[int, torch.Tensor]:
        """idx -> the sampling generator state of every live request,
        from which a re-admission (`submit(prng_key=state)`) continues
        the same stream. As JAX's key mirror, it describes the last
        HARVESTED dispatch: with a sampled dispatch in flight
        (async_depth=1) a slot reports its state before that dispatch's
        draws. A slot that has not started decoding reports its
        admission state."""
        before = {}
        pend = self._inflight
        if pend is not None and pend.gens is not None:
            before = {slot: snap for slot, snap in enumerate(pend.gens)
                      if snap is not None}
        out: Dict[int, torch.Tensor] = {}
        for slot in range(self.n_slots):
            req = self.slot_req[slot]
            if req is not None and not req.done:
                gen = self._slot_gen[slot]
                snap = before.get(slot)
                if gen is not None and snap is not None and snap[0] is gen:
                    out[req.idx] = snap[1].clone()
                    continue
                if gen is None:
                    gen = self._make_gen(req)
                out[req.idx] = gen.get_state()
        return out

    def cancel(self, idx: int) -> None:
        """Abort a request wherever it is — queued, mid-prefill or
        decoding in a slot. A no-op for unknown or already-retired
        indices."""
        req = self._requests.pop(idx, None)
        self._pending.pop(idx, None)
        if req is None:
            return
        try:
            self._queue.remove(req)
        except ValueError:
            pass
        self._unready(req)
        req.done = True
        for slot in range(self.n_slots):
            if self.slot_req[slot] is req:
                self._release_slot(slot)
                break
        self._release_adapter(req)

    def _release_adapter(self, req: _Request) -> None:
        if req.adapter_id is not None:
            self._adapter_cache.release(req.adapter_id)

    def _release_slot(self, slot: int) -> None:
        """Free a slot whatever its state: its pages, its pinned prefix
        row and its mid-prefill state. Not the request's adapter pin:
        a preemption comes through here, and its replay must land on
        the same bank slot."""
        self.slot_req[slot] = None
        self.done[slot] = True
        self._park(slot)
        self._slot_gen[slot] = None
        if self._paged:
            self._release_slot_pages(slot)
        if self.prefix_cache is not None:
            self._release_slot_row(slot)
        self._clear_prefill(slot)

    def generate_all(self, prompts: Sequence[Sequence[int]]) -> List[np.ndarray]:
        """Run every queued prompt to completion; returns generated
        continuations (without the prompt) in submission order —
        including requests submit()ted beforehand and not yet
        returned."""
        for pr in prompts:
            self.submit(pr)
        while self.has_work():
            self.step()
        out = []
        for i in self._pending:
            req = self._requests.pop(i)
            self._release_adapter(req)
            out.append(np.asarray(req.out, np.int32))
        self._pending = {}
        return out

    def reset(self) -> None:
        """Rebuild the device state from scratch after a failure: the KV
        bank or page pool (with the allocator and tables), the prefix
        cache and its pool, and the drafter are made anew; the queue,
        the ledger, the export queue, the host tier's entries and the
        in-flight dispatch are dropped; every ledger pin is released and
        the adapter bank rebuilt from the registry.
        Request indices stay monotonic, so a stale event can never name
        a new request."""
        self._new_kv_state()
        self.tok[:] = self.pad_id
        self.pos[:] = 0
        self.limit[:] = 0
        self.done[:] = True
        self.adapt[:] = 0
        self._slot_gen = [None] * self.n_slots
        # mid-prefill state dies with the slots (the stall and chunk
        # counters are cumulative telemetry and survive)
        self._prefilling[:] = False
        self._export_hold[:] = False
        self._frontier[:] = 0
        if self._adapter_cache is not None:
            for req in self._requests.values():
                self._release_adapter(req)
            self._adapter_cache.rebuild()
        self._inflight = None
        if self.kv_tier is not None:
            # a fault mid-demotion may have left copies whose source
            # died with the engine: drop every entry
            self.kv_tier.clear()
        self._prefill_ready = []
        self._step_no = 0
        self.slot_req = [None] * self.n_slots
        self._queue.clear()
        self._requests.clear()
        self._pending.clear()
        self._make_spec()


def _has_sharded(tree) -> bool:
    if isinstance(tree, dict):
        return any(_has_sharded(v) for v in tree.values())
    return isinstance(tree, Sharded)


def _draw_rows(probs: torch.Tensor, gens: List[Optional[torch.Generator]]):
    """One categorical draw per row of `probs` [B, V], row b from
    generator gens[b] (argmax where gens[b] is None): `categorical`,
    torch.multinomial's draw without its device reads."""
    out = torch.argmax(probs, dim=-1)
    for row, gen in enumerate(gens):
        if gen is not None:
            out[row] = categorical(probs[row], gen)
    return out


# serving-facing name, as in the JAX package; ContinuousBatcher stays
# for existing callers
GenerationEngine = ContinuousBatcher
