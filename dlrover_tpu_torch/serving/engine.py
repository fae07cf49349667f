"""Continuous-batching generation engine — counterpart of the
`ContinuousBatcher` in dlrover_tpu/serving/engine.py, the subset that
serves colocated dense and paged traffic synchronously.

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
- Greedy decoding is argmax. Sampling (temperature / top-k / top-p)
  draws from one torch.Generator per request, seeded from the engine
  seed at admission, so a request's stream depends only on its own
  generator, never on batch composition.

- weight_quant="int8" re-stores the large matmul weights at install
  as output-major per-block int8 (`_quantize_params`, the quantize
  kernel on the card), and every projection, MLP and untied lm_head
  product of prefill and decode then runs the fused W8A16
  dequant-matmul kernel (the plain version on the CPU).

The host keeps the slot state (tok/pos/done/limit) as numpy mirrors;
each dispatch uploads it, runs its steps on the device, and fetches
the emitted tokens and the new state once.

Not ported yet (later slices): prefix cache, speculative decoding,
prefill_chunk, async_depth=1, adapters, weight_quant="int8_stochastic",
tp / mesh, resize / weight refresh, KV tier, handoff, health, chaos,
and page-pressure preemption (so n_pages must back every slot in full).
"""

import dataclasses
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from dlrover_tpu_torch._device import DeviceLike, resolve_device
from dlrover_tpu_torch.models.decode import (
    _mask_top_k,
    _mask_top_p,
    decode_step,
    init_kv_cache,
    init_page_pool,
    paged_decode_step,
    paged_install_row,
    prefill_exact_row,
    prefill_into_slot,
)
from dlrover_tpu_torch.ops.quantization import (
    QuantizedWeight,
    quantize_int8,
    weight_quant_block,
)
from dlrover_tpu_torch.serving.paged_kv import TRASH_PAGE, PageAllocator

# The large matmul weights weight_quant="int8" re-stores as per-block
# int8 (ops/quantization.QuantizedWeight), by name on the stacked layer
# dict (the JAX engine's set, which also names the GPT family's fused
# wqkv). Norms and embeddings stay dense; the untied lm_head quantizes
# separately.
_WQ_LAYER_WEIGHTS = frozenset(
    ("wq", "wk", "wv", "wo", "wqkv", "w_gate", "w_up", "w_down")
)


def _pad_bucket(n: int, lo: int = 16) -> int:
    """Next power-of-two bucket (>= lo)."""
    b = lo
    while b < n:
        b *= 2
    return b


@dataclasses.dataclass
class _Request:
    idx: int                 # submission order
    prompt: np.ndarray       # [P] true tokens
    max_new: int = 0         # per-request cap (0 = engine default)
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    seed: Optional[int] = None  # sampling seed, drawn at admission


# one step() event: (request idx, tokens emitted this chunk, finished)
StepEvent = Tuple[int, List[int], bool]


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
        kv_layout: str = "dense",    # "dense" bank | "paged" pool
        page_size: int = 0,          # cells per page (0 = auto pow2)
        n_pages: int = 0,            # pool size (0 = dense-equivalent)
        weight_quant: str = "none",  # | "int8": per-block int8 weights
        device: DeviceLike = None,
    ):
        if eos_id is not None and eos_id == pad_id:
            raise ValueError(
                "eos_id and pad_id must differ: the pad emitted by "
                "finished slots would re-trigger EOS detection"
            )
        if not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        if top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {top_k}")
        if kv_layout not in ("dense", "paged"):
            raise ValueError(
                f"kv_layout must be 'dense' or 'paged', got {kv_layout!r}"
            )
        if weight_quant == "int8_stochastic":
            raise NotImplementedError(
                "weight_quant='int8_stochastic' is not ported yet "
                "(ROADMAP queue 1: stochastic rounding needs a Philox "
                "counterpart of jax.random and a distributional oracle)"
            )
        if weight_quant not in ("none", "int8"):
            raise ValueError(
                f"weight_quant must be 'none' or 'int8', got "
                f"{weight_quant!r}"
            )
        self.device = resolve_device(device)
        self.cfg = cfg
        self.weight_quant = weight_quant
        self._wq_stats = {"leaves": 0, "skipped": 0}
        self.params = self._quantize_params(params)
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
        if self._paged:
            # auto page size: the largest power of two <= 16 dividing
            # max_len
            if page_size <= 0:
                page_size = 16
                while page_size > 1 and max_len % page_size:
                    page_size //= 2
            if max_len % page_size:
                raise ValueError(
                    f"page_size {page_size} must divide max_len = "
                    f"{max_len}: a slot's logical cells must map onto "
                    "whole pages"
                )
            per_slot = max_len // page_size
            dense_equiv = n_slots * per_slot + 1
            if n_pages <= 0:
                n_pages = dense_equiv
            if n_pages < dense_equiv:
                raise ValueError(
                    f"n_pages {n_pages} is below the dense-equivalent "
                    f"pool n_slots * max_len / page_size + 1 = "
                    f"{dense_equiv} (the +1 is the trash page): this "
                    "engine has no page-pressure preemption, so every "
                    "slot's run must always fit"
                )
            self.page_size = page_size
            self.n_pages = n_pages
            self._pages_per_slot = per_slot
            self.allocator = PageAllocator(n_pages, page_size)
            self.page_pool = init_page_pool(
                cfg, n_pages, page_size, quant=kv_quant, device=self.device
            )
            # all rows start on the trash page; the chunk routes done
            # rows there itself, so the host writes rows only at
            # admission
            self._table = torch.zeros(
                (n_slots, per_slot), dtype=torch.int32, device=self.device
            )
            self._slot_pages: List[List[int]] = [[] for _ in range(n_slots)]
            self.cache = None
        else:
            self.cache = init_kv_cache(
                cfg, n_slots, max_len, quant=kv_quant, device=self.device
            )
        # the engine seed only SEEDS per-request generators (one draw
        # per admission); sampling runs on the per-slot generators
        self._seed_gen = torch.Generator().manual_seed(seed)
        self._slot_gen: List[Optional[torch.Generator]] = [None] * n_slots
        # host mirrors of the slot state
        self.tok = np.full(n_slots, pad_id, np.int64)
        self.pos = np.zeros(n_slots, np.int64)
        self.limit = np.zeros(n_slots, np.int64)
        self.done = np.ones(n_slots, bool)   # all free initially
        self.slot_req: List[Optional[_Request]] = [None] * n_slots
        self._queue: deque = deque()
        self._requests: Dict[int, _Request] = {}
        self._pending: Dict[int, None] = {}
        self._next_idx = 0
        # counters chip_smoke.py and the tests read
        self.admissions = 0
        self.decode_steps = 0

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
        returns `params` itself. The caller's dict is not modified."""
        if self.weight_quant == "none":
            return params
        if not isinstance(params, dict) or "layers" not in params:
            return params
        leaves = skipped = 0
        lay = dict(params["layers"])
        targets = [("layers", name) for name in sorted(lay)
                   if name in _WQ_LAYER_WEIGHTS]
        head = params.get("lm_head")
        if isinstance(head, dict) and "weight" in head:
            # untied unembed [D, V]: the largest weight read of a step
            head = dict(head)
            targets.append(("lm_head", "weight"))
        for group, name in targets:
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
            for i in range(slices.shape[0]):
                q, s = quantize_int8(slices[i].t().contiguous(), blk)
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
        """Served-weight bytes on the device: every tensor leaf of the
        served tree (a QuantizedWeight counts its q8 and s8) times its
        element size."""
        def walk(node):
            if isinstance(node, dict):
                return sum(walk(v) for v in node.values())
            if isinstance(node, QuantizedWeight):
                return walk(node.q8) + walk(node.s8)
            return node.numel() * node.element_size()
        return walk(self.params)

    @property
    def weight_quant_path(self) -> str:
        """Which matmul body the quantized weights run: "int8:kernel"
        (the fused dequant-matmul kernel, on the card) or
        "int8:reference" (its plain version, on the CPU); "none" when
        quantization is off."""
        if self.weight_quant == "none":
            return "none"
        kind = "kernel" if self.device.type == "cuda" else "reference"
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

    # -- admission ---------------------------------------------------------

    def submit(self, prompt: Sequence[int], max_new: Optional[int] = None) -> int:
        """Queue one request; returns its index in the output list.
        `max_new` caps THIS request's generation; default is the
        engine's."""
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
        req = _Request(
            idx=self._next_idx, prompt=arr, max_new=max_new or 0,
        )
        self._next_idx += 1
        self._requests[req.idx] = req
        self._pending[req.idx] = None
        self._queue.append(req)
        return req.idx

    def _pad_to(self, toks: np.ndarray, bucket: int) -> torch.Tensor:
        padded = np.full(bucket, self.pad_id, np.int64)
        padded[: len(toks)] = toks
        return torch.from_numpy(padded).to(self.device)

    def _admit(self, slot: int, req: _Request):
        p = len(req.prompt)
        bucket = min(_pad_bucket(p), self.max_len)
        prompt = self._pad_to(req.prompt, bucket)
        if self._paged:
            self._admit_paged(slot, req, prompt)
        else:
            prefill_into_slot(self.cfg, self.params, prompt, self.cache, slot)
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
        gen = torch.Generator(device=self.device)
        self._slot_gen[slot] = gen.manual_seed(req.seed)
        self.done[slot] = False
        self.slot_req[slot] = req

    def _request_pages(self, req: _Request) -> int:
        """Exact page need: the request's OWN limit (prompt plus its
        budget, capped at max_len). The highest cell ever written is
        limit-1 (a frozen done slot rewrites its last cell)."""
        p = len(req.prompt)
        limit = min(p + (req.max_new or self.max_new), self.max_len)
        return (limit - 1) // self.page_size + 1

    def _admit_paged(self, slot: int, req: _Request, prompt: torch.Tensor):
        """Cold paged admission: allocate the request's page run,
        prefill into an exact row, install the prompt bucket's cells
        into the run's pages (pad cells past the run land on the trash
        page) and write the slot's table row."""
        run = self.allocator.alloc(self._request_pages(req))
        self._slot_pages[slot] = run
        vals = np.full(self._pages_per_slot, TRASH_PAGE, np.int32)
        vals[: len(run)] = run
        table_row = torch.from_numpy(vals).to(self.device)
        row = prefill_exact_row(self.cfg, self.params, prompt, self.max_len)
        paged_install_row(
            self.page_pool, row, table_row, 0, prompt.shape[0]
        )
        self._table[slot] = table_row

    def _release_slot_pages(self, slot: int) -> None:
        """Drop a slot's page run — host accounting only: the chunk
        routes done rows through the trash page itself."""
        run = self._slot_pages[slot]
        if run:
            self.allocator.free(run)
            self._slot_pages[slot] = []

    # -- the loop ----------------------------------------------------------

    def has_work(self) -> bool:
        """True while any slot is live or the queue holds requests."""
        return bool(self._queue) or not self.done.all()

    def queue_len(self) -> int:
        """Requests waiting for a slot (excludes live slots)."""
        return len(self._queue)

    def active_count(self) -> int:
        """Slots currently decoding."""
        return int((~self.done).sum())

    def free_slots(self) -> int:
        return self.n_slots - self.active_count()

    def _next_chunk_len(self) -> int:
        """Dispatch size: `chunk` steps, shortened only when EVERY live
        slot's remaining cap (limit - pos - 1) is smaller; the tail
        quantizes down to a power of two (as the JAX engine does, where
        each distinct length is its own compiled program)."""
        live = ~self.done
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

    def step(self) -> List[StepEvent]:
        """One engine iteration: admit from the queue into free slots,
        run ONE chunk dispatch, harvest it, return its events ([] when
        there is no work)."""
        for slot in range(self.n_slots):
            if self.done[slot] and self._queue:
                self._admit(slot, self._queue.popleft())
        if self.done.all():
            return []
        return self._harvest(*self._dispatch_chunk())

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        """Next token per row: argmax when greedy; else a draw from the
        warped distribution with each slot's own generator (free slots
        take argmax — their token is replaced by pad anyway)."""
        if self.temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        warped = logits / self.temperature
        if 0 < self.top_k < warped.shape[-1]:
            warped = _mask_top_k(warped, self.top_k)
        if self.top_p < 1.0:
            warped = _mask_top_p(warped, self.top_p)
        probs = torch.softmax(warped.float(), dim=-1)
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

    def _dispatch_chunk(self):
        """Run k decode steps for every slot on the device; returns the
        fetched (tok, pos, done, emitted [B, k]) and the entry pos."""
        k = self._next_chunk_len()
        dev = self.device
        old_pos = self.pos.copy()
        tok = torch.from_numpy(self.tok).to(dev)
        pos = torch.from_numpy(self.pos).to(dev)
        done = torch.from_numpy(self.done).to(dev)
        limit = torch.from_numpy(self.limit).to(dev)
        if self._paged:
            # done-at-entry rows read and write the trash page; rows
            # finishing MID-chunk still own their pages (the host frees
            # them only after harvesting this dispatch)
            table = torch.where(done[:, None], TRASH_PAGE, self._table)
        emitted = []
        for _ in range(k):
            if self._paged:
                logits, _ = paged_decode_step(
                    self.cfg, self.params, tok, self.page_pool, table, pos
                )
            else:
                logits, _ = decode_step(
                    self.cfg, self.params, tok, self.cache, pos
                )
            tok, pos, done, nxt = self._advance(logits, tok, pos, done, limit)
            emitted.append(nxt)
        self.decode_steps += k
        host = [
            t.cpu().numpy()
            for t in (tok, pos, done, torch.stack(emitted, dim=1))
        ]
        return host, old_pos

    def _harvest(self, host, old_pos) -> List[StepEvent]:
        """Refresh the host mirrors from a dispatch's fetched outputs
        and turn them into events. Live steps form a prefix of the
        chunk (done is sticky) and pos advances once per live step, so
        the first (new_pos - old_pos) emitted entries are the tokens."""
        tok, pos, done, emitted = host
        self.tok, self.pos = tok, pos
        return self._emit_events(emitted, pos - old_pos, done)

    def _emit_events(self, emitted, counts, new_done) -> List[StepEvent]:
        events: List[StepEvent] = []
        for slot in range(self.n_slots):
            req = self.slot_req[slot]
            if req is None or req.done:
                continue
            new_toks = [int(t) for t in emitted[slot][: int(counts[slot])]]
            req.out.extend(new_toks)
            finished = bool(new_done[slot])
            if finished:
                req.done = True
                self._slot_gen[slot] = None
                if self._paged:
                    # the tokens are on the host and the KV is dead:
                    # the pages back the NEXT admission
                    self._release_slot_pages(slot)
            if new_toks or finished:
                events.append((req.idx, new_toks, finished))
        self.done = new_done.copy()
        for slot in range(self.n_slots):
            if self.slot_req[slot] is None:
                self.done[slot] = True
        return events

    def retire(self, idx: int) -> np.ndarray:
        """Drop a request from the ledger and return its continuation."""
        if idx not in self._pending:
            raise KeyError(f"request {idx} is not pending")
        del self._pending[idx]
        req = self._requests.pop(idx)
        for slot in range(self.n_slots):
            if self.slot_req[slot] is req:
                self._free_slot(slot)
        return np.asarray(req.out, np.int32)

    def cancel(self, idx: int) -> None:
        """Abort a request wherever it is — queued or live in a slot.
        A no-op for unknown or already-retired indices."""
        req = self._requests.pop(idx, None)
        self._pending.pop(idx, None)
        if req is None:
            return
        try:
            self._queue.remove(req)
        except ValueError:
            pass
        req.done = True
        for slot in range(self.n_slots):
            if self.slot_req[slot] is req:
                self._free_slot(slot)
                break

    def _free_slot(self, slot: int) -> None:
        self.slot_req[slot] = None
        self.done[slot] = True
        self._slot_gen[slot] = None
        if self._paged:
            self._release_slot_pages(slot)

    def generate_all(self, prompts: Sequence[Sequence[int]]) -> List[np.ndarray]:
        """Run every queued prompt to completion; returns generated
        continuations (without the prompt) in submission order —
        including requests submit()ted beforehand and not yet
        returned."""
        for pr in prompts:
            self.submit(pr)
        while self.has_work():
            self.step()
        out = [
            np.asarray(self._requests.pop(i).out, np.int32)
            for i in self._pending
        ]
        self._pending = {}
        return out


def _draw_rows(probs: torch.Tensor, gens: List[Optional[torch.Generator]]):
    """One categorical draw per row of `probs` [B, V], row b from
    generator gens[b] (argmax where gens[b] is None)."""
    out = torch.argmax(probs, dim=-1)
    for row, gen in enumerate(gens):
        if gen is not None:
            out[row] = torch.multinomial(probs[row], 1, generator=gen)[0]
    return out
