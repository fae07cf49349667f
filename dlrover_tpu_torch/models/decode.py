"""KV-cache autoregressive decoding for the Llama family — counterpart
of dlrover_tpu/models/decode.py (the dense slot bank and the paged
pool that the serving engine drives).

Where the JAX package scans the stacked layers, this loops over them;
where it donates a cache buffer and returns the updated one, this
writes the cache or pool IN PLACE and returns the same dict (the
callers hold the only reference, exactly as donation assumes).

Prefill and decode share `_block` (S=P vs S=1) so there is exactly one
attention/cache implementation to keep correct. A cold prefill attends
with plain causal attention over the chunk (the flash kernel on the
card); warm (suffix) and chunked prefills and decode attend over the
whole buffer under the position mask (the dense bank), or over the
page pool (decode through the paged-attention kernel on the card, the
gathered dense view otherwise).

Multi-adapter LoRA serving (serving/adapters.py): every forward below
that JAX's takes `adapters` on takes an optional `adapters` operand,
{"bank": {"<t>_a": [L, S, in, r], "<t>_b": [L, S, r, out]}, "idx": [B]
int (each row's bank slot), "scale": [S] f32}. Each layer takes its own
[S, ...] slices and adds each row's delta inside the projections
(`llama._slot_lora_delta`). With adapters=None every function computes
exactly what it computes without the operand.
"""

from typing import Dict, Tuple

import torch

from dlrover_tpu_torch._device import DeviceLike, resolve_device
from dlrover_tpu_torch.models.llama import (
    LlamaConfig,
    _attn_qkv,
    _attn_residual,
    _compute_weights,
    _head_matrix,
    _mlp_residual,
    _rms_norm,
    _rope_tables,
    layer_params as _layer_params,
)
from dlrover_tpu_torch.ops import paged_attention as pa
from dlrover_tpu_torch.ops.attention import dot_product_attention
from dlrover_tpu_torch.ops.quantization import matmul_any

Cache = Dict[str, torch.Tensor]


def _kv_dtypes(cfg, quant: bool):
    if not quant:
        return {"k": cfg.dtype, "v": cfg.dtype}
    # bf16 scales: the quantum is 1/127 of the vector max, so the
    # scale's own 2^-8 relative error is noise
    return {"k": torch.int8, "v": torch.int8,
            "k_scale": torch.bfloat16, "v_scale": torch.bfloat16}


def _zeros(shape, dtypes, dev) -> Cache:
    out = {}
    for name, dt in dtypes.items():
        s = shape if not name.endswith("_scale") else shape[:-1] + (1,)
        out[name] = torch.zeros(s, dtype=dt, device=dev)
    return out


def init_kv_cache(
    cfg, batch: int, max_len: int, quant: bool = False,
    device: DeviceLike = None,
) -> Cache:
    """Fixed-size cache buffers [L, B, M, KV, hd]; dtype follows the
    compute dtype. quant=True stores K/V as symmetric per-vector int8
    plus one bf16 scale per [position, head]."""
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return _zeros(shape, _kv_dtypes(cfg, quant), resolve_device(device))


def _kv_quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-vector int8: one scale per [..., head] vector
    (max|x|/127). torch.round rounds half to even, as jnp.round does."""
    x32 = x.float()
    scale = x32.abs().amax(dim=-1, keepdim=True) / 127.0
    scale = torch.clamp_min(scale, 1e-8)
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def _cached_attention(q, layer_cache, q_positions, scale):
    """q [B,S,H,hd] attends over the whole cache [B,M,KV,hd] under the
    causal position mask (cache col j visible to query at position p
    iff j <= p). GQA runs as a grouped einsum against the unexpanded
    cache. Quantized caches dequantize here."""
    k_cache, v_cache = layer_cache["k"], layer_cache["v"]
    if "k_scale" in layer_cache:
        k_cache = k_cache.to(q.dtype) * layer_cache["k_scale"].to(q.dtype)
        v_cache = v_cache.to(q.dtype) * layer_cache["v_scale"].to(q.dtype)
    b, s, h, hd = q.shape
    m = k_cache.shape[1]
    kv = k_cache.shape[2]
    n_rep = h // kv
    qg = q.reshape(b, s, kv, n_rep, hd)
    # operands cast to f32: the exact f32-accumulated product the JAX
    # einsum's preferred_element_type asks for
    scores = torch.einsum(
        "bskrd,bmkd->bkrsm", qg.float(), k_cache.float()
    ) * scale
    cols = torch.arange(m, device=q.device)[None, None, None, None, :]
    rows = q_positions[:, None, None, :, None]
    scores = torch.where(cols <= rows, scores, float("-inf"))
    p = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkrsm,bmkd->bskrd", p, v_cache)
    return out.reshape(b, s, h, hd)


def _cache_write(cache_arr, update, start):
    """Write `update` [B,S,...] into `cache_arr` [B,M,...] at offset
    `start` — an int / 0-d tensor (all rows) or a [B] tensor (per row)
    — in place. The start is placed the way the JAX package's
    dynamic_update_slice places it: a negative start counts from the
    end (start + M), then it clamps to [0, M-S] so the update fits."""
    m, s = cache_arr.shape[1], update.shape[1]
    upd = update.to(cache_arr.dtype)
    if torch.is_tensor(start) and start.ndim == 1:
        st = torch.where(start < 0, start + m, start).clamp(0, m - s)
        idx = st[:, None] + torch.arange(s, device=st.device)[None, :]
        rows = torch.arange(cache_arr.shape[0], device=st.device)[:, None]
        cache_arr[rows, idx] = upd
    else:
        st = int(start)
        st = min(max(st + m if st < 0 else st, 0), m - s)
        cache_arr[:, st:st + s] = upd
    return cache_arr


def _write_cache_and_attend(
    q, k, v, layer_cache, positions, start, head_dim,
    attn_impl: str = "auto",
    plain_causal: bool = False,
):
    """Write this chunk's K/V into the cache at `start` and attend.

    `plain_causal` is the prefill fast path, asserted by the caller
    that owns the invariant (prefill(): start 0 and dense arange
    positions, so the chunk IS the whole valid prefix): plain causal
    attention over the chunk — the flash kernel on the card."""
    if "k_scale" in layer_cache:
        kq, ks = _kv_quantize(k)
        vq, vs = _kv_quantize(v)
        writes = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    else:
        writes = {"k": k, "v": v}
    for name, upd in writes.items():
        _cache_write(layer_cache[name], upd, start)
    if plain_causal:
        # honor an explicit 'reference'; otherwise 'auto' (the kernel
        # for CUDA tensors)
        impl = "reference" if attn_impl == "reference" else "auto"
        attn = dot_product_attention(q, k, v, causal=True, impl=impl)
    else:
        attn = _cached_attention(
            q, layer_cache, positions, float(head_dim) ** -0.5
        )
    return attn, layer_cache


def _block(cfg: LlamaConfig, x, layer_params, layer_cache, positions,
           start, plain_causal: bool = False, rope=None, lora=None):
    """One decoder block writing its K/V into the cache. `rope` is the
    forward's precomputed `_rope_tables` (computed here when None);
    `lora` is (this layer's bank slices, idx, scale) or None."""
    lp = _compute_weights(cfg, layer_params)
    h = _rms_norm(x, layer_params["attn_norm"], cfg.norm_eps)
    q, k, v = _attn_qkv(cfg, h, lp, positions, rope, lora=lora)
    attn, layer_cache = _write_cache_and_attend(
        q, k, v, layer_cache, positions, start, cfg.head_dim,
        attn_impl=cfg.attn_impl, plain_causal=plain_causal,
    )
    x = _attn_residual(cfg, x, attn, lp, lora=lora)
    x = _mlp_residual(cfg, x, layer_params, lp)
    return x, layer_cache


def _logits(cfg, params, x):
    x = _rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    return matmul_any(x, _head_matrix(cfg, params)).float()


def _check_adapters(cfg, adapters) -> None:
    """JAX refuses adapters on its GPT family (a fused wqkv has no
    per-target bank). The port has no GPT family yet (ROADMAP queue 1
    item 13, `gpt.py`): every config it serves takes adapters, so there
    is nothing to refuse until that lands."""


def _layer_lora(adapters, layer: int):
    """One layer's (bank slices [S, ...], idx, scale), or None."""
    if adapters is None:
        return None
    bank = {name: arr[layer] for name, arr in adapters["bank"].items()}
    return bank, adapters["idx"], adapters["scale"]


def _forward_cached(cfg, params, tokens, cache, positions, start,
                    plain_causal: bool = False, adapters=None):
    """tokens [B,S] -> logits [B,S,V], writing the cache at
    [start, start+S); `adapters` (module docstring) adds each row's
    LoRA delta."""
    _check_adapters(cfg, adapters)
    x = params["embed"]["weight"].to(cfg.dtype)[tokens]
    rope = _rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    for layer in range(cfg.n_layers):
        layer_cache = {name: arr[layer] for name, arr in cache.items()}
        x, _ = _block(
            cfg, x, _layer_params(params, layer), layer_cache, positions,
            start, plain_causal=plain_causal, rope=rope,
            lora=_layer_lora(adapters, layer),
        )
    return _logits(cfg, params, x), cache


def prefill(cfg, params, tokens, cache, adapters=None):
    """Fill the cache from a prompt [B, P]; returns (last-token logits,
    cache)."""
    b, p = tokens.shape
    positions = torch.arange(p, device=tokens.device).expand(b, p)
    logits, cache = _forward_cached(
        cfg, params, tokens, cache, positions, 0, plain_causal=p > 1,
        adapters=adapters,
    )
    return logits[:, -1], cache


def decode_step(cfg, params, token, cache, pos, adapters=None):
    """One cached step -> (next-token logits [B,V], cache). `pos` is a
    scalar (all rows) or a [B] vector (each row at its own position)."""
    b = token.shape[0]
    pos = torch.as_tensor(pos, dtype=torch.long, device=token.device)
    if pos.ndim == 1:
        positions = pos[:, None]
    else:
        positions = pos.reshape(1, 1).expand(b, 1)
    logits, cache = _forward_cached(
        cfg, params, token[:, None], cache, positions, pos,
        adapters=adapters,
    )
    return logits[:, 0], cache


def _verify_positions(tokens, pos):
    """[B, S] positions pos[b] + [0, S) of a verify's tokens."""
    pos = torch.as_tensor(pos, dtype=torch.long, device=tokens.device)
    return pos[:, None] + torch.arange(tokens.shape[1],
                                       device=tokens.device)[None, :]


def verify_step(cfg, params, tokens, cache, pos, adapters=None):
    """Batched speculative verify: tokens [B, S] (the carry token and
    S-1 drafts) at positions pos[b] + [0, S) in ONE forward -> (logits
    [B, S, V], cache). Each row's K/V is written first, then every
    query attends the whole buffer under the position mask, so draft j
    sees the carry and drafts 1..j exactly as stepped decoding would:
    logits[:, j] is the target distribution of the token after
    tokens[:, j]. The caller keeps pos + S within the buffer (the
    engine over-allocates its bank by the draft width)."""
    positions = _verify_positions(tokens, pos)
    return _forward_cached(cfg, params, tokens, cache, positions,
                           positions[:, 0], adapters=adapters)


def prefill_into_slot(cfg, params, prompt, cache, slot: int, adapters=None):
    """Run a single-sequence prefill of `prompt` [P] (a pad tail is
    fine: the decode mask hides cells past the slot's position) and
    install its K/V into row `slot` of a multi-slot cache. `adapters`
    carries a 1-row idx (the admitted request's bank slot): an adapted
    request's prompt K/V comes from the adapted projections."""
    p = prompt.shape[0]
    if cache["k"].shape[2] < p:
        raise ValueError(
            f"prompt chunk {p} exceeds cache max_len {cache['k'].shape[2]}"
        )
    mini = init_kv_cache(
        cfg, 1, p, quant="k_scale" in cache, device=prompt.device
    )
    _, mini = prefill(cfg, params, prompt[None], mini, adapters=adapters)
    for name, arr in cache.items():
        arr[:, slot, :p] = mini[name][:, 0].to(arr.dtype)
    return cache


# ---------------------------------------------------------------------------
# prefix-pool primitives (serving/engine.py's admission-time prefix cache)
#
# The prefix pool is a second KV bank beside the slot bank whose rows
# hold EXACT (unquantized) K/V of block-aligned prompt prefixes. An exact
# pool is what makes a cached admission token-for-token equal to a cold
# prefill even with an int8 slot bank: install quantizes the exact values
# with the `_kv_quantize` the cold write path uses, so the slot bytes
# come out the same either way.
# ---------------------------------------------------------------------------


def exact_row_cache(cfg, max_len: int, device: DeviceLike = None) -> Cache:
    """A single-sequence full-precision cache row [L, 1, M, KV, hd]."""
    return init_kv_cache(cfg, 1, max_len, quant=False, device=device)


def prefill_exact_row(cfg, params, prompt, max_len: int,
                      adapters=None) -> Cache:
    """Cold-admission prefill of `prompt` [P] into a fresh exact row.
    `adapters` (a 1-row idx) serves the paged cold admission of an
    adapted request; rows bound for the shared prefix pool pass None
    (published prefixes are base-model K/V by contract)."""
    row = exact_row_cache(cfg, max_len, device=prompt.device)
    _, row = prefill(cfg, params, prompt[None], row, adapters=adapters)
    return row


def _chunk_positions(start: int, n: int, device):
    return (int(start) + torch.arange(n, device=device))[None]


def prefill_suffix_row(cfg, params, suffix, row: Cache, start: int) -> Cache:
    """Warm-admission prefill: extend an exact row that holds K/V of
    positions [0, start) with `suffix` [S] at positions [start,
    start+S), in place. The suffix queries attend over the installed
    prefix and the suffix itself through the position-masked
    `_cached_attention` (each position is written before it is read),
    not flash. The caller keeps start + S within the row."""
    positions = _chunk_positions(start, suffix.shape[0], suffix.device)
    _forward_cached(cfg, params, suffix[None], row, positions, start)
    return row


def prefill_chunk_into_slot(cfg, params, chunk, cache: Cache, slot: int,
                            start: int, adapters=None) -> Cache:
    """Resume slot `slot`'s prefill at its write frontier: run `chunk`
    [C] (real tokens only, no pad tail) at positions [start, start+C),
    writing K/V straight into that row of the multi-slot bank, in place:
    `prefill_suffix_row` on a view of the row (for exact banks the K/V
    one blocking prefill writes; an int8 bank attends the dequantized
    earlier chunks). `adapters` carries the slot's 1-row idx."""
    positions = _chunk_positions(start, chunk.shape[0], chunk.device)
    _forward_cached(cfg, params, chunk[None],
                    {name: arr[:, slot:slot + 1]
                     for name, arr in cache.items()},
                    positions, start, adapters=adapters)
    return cache


def install_exact_row(cache: Cache, row: Cache, slot: int) -> Cache:
    """Write an exact row into slot `slot` of the (possibly int8) slot
    bank, in place, quantizing on the way in when the bank is int8 (the
    cold write path's per-vector scheme on the same exact values). A
    whole-row write: cells past the valid prefix are hidden by the
    decode position mask until generation overwrites them. A row
    shorter than the bank (a bank over-allocated by the draft width)
    fills its leading cells, as the JAX package's dynamic_update_slice
    does."""
    if "k_scale" in cache:
        kq, ks = _kv_quantize(row["k"])
        vq, vs = _kv_quantize(row["v"])
        row = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    for name, arr in cache.items():
        src = row[name][:, 0]
        arr[:, slot, :src.shape[1]] = src.to(arr.dtype)
    return cache


def pool_take_row(pool: Cache, row: int) -> Cache:
    """A copy of pool row `row` as a single-sequence exact cache."""
    return {name: arr[:, row:row + 1].clone() for name, arr in pool.items()}


def pool_put_row(pool: Cache, row_cache: Cache, row: int) -> Cache:
    """Publish an exact row into pool row `row` (whole-row write)."""
    for name, arr in pool.items():
        arr[:, row] = row_cache[name][:, 0].to(arr.dtype)
    return pool


# ---------------------------------------------------------------------------
# paged KV primitives (serving/engine.py's kv_layout="paged")
#
# A global page POOL [L, n_pages, page_size, KV, hd] plus a per-slot
# page TABLE [B, P] of physical page ids: logical cell m of slot b lives
# at pool[:, table[b, m // ps], m % ps]. Page id 0 is the TRASH page:
# done rows' tables point there so their frozen rewrites land where no
# live table reads.
# ---------------------------------------------------------------------------


def init_page_pool(
    cfg, n_pages: int, page_size: int, quant: bool = False,
    device: DeviceLike = None,
) -> Cache:
    """The global page pool [L, n_pages, page_size, KV, hd] (+ per
    [page, cell, head] bf16 scales when quant — the same per-vector
    int8 scheme as init_kv_cache)."""
    shape = (cfg.n_layers, n_pages, page_size, cfg.n_kv_heads, cfg.head_dim)
    return _zeros(shape, _kv_dtypes(cfg, quant), resolve_device(device))


def _paged_view(layer_pool: Cache, table) -> Cache:
    """One layer's pages gathered into the dense [B, M, KV, ...] view
    `_cached_attention` attends over."""
    return pa.gather_pages(layer_pool, table)


def _page_slots(table, positions, page_size: int):
    """(physical page ids, in-page offsets) [B, S] of each row's chunk
    positions — shared by every layer of a forward."""
    pids = torch.gather(table, 1, positions // page_size).long()
    return pids, positions % page_size


def _write_pages_and_attend(
    q, k, v, layer_pool, table, positions, head_dim,
    attn_impl: str = "auto", slots=None,
):
    """Scatter this chunk's K/V into the rows' pages (row b, chunk
    position s -> pool[table[b, pos//ps], pos%ps]), in place, and
    attend: S == 1 through the paged-attention kernel on the card,
    otherwise (and on the CPU) through the gathered dense view with the
    identical position-masked attention. Only done rows parked on the
    trash page collide in the scatter; no live mask reads those cells.
    `slots` is the forward's precomputed `_page_slots`."""
    if slots is None:
        slots = _page_slots(table, positions, layer_pool["k"].shape[1])
    pids, offs = slots
    if "k_scale" in layer_pool:
        kq, ks = _kv_quantize(k)
        vq, vs = _kv_quantize(v)
        writes = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    else:
        writes = {"k": k, "v": v}
    for name, upd in writes.items():
        arr = layer_pool[name]
        arr[pids, offs] = upd.to(arr.dtype)
    # attn_impl='reference' pins the gathered-view formulation even
    # where use_kernel would take the kernel
    if q.shape[1] == 1 and attn_impl != "reference":
        q1 = q[:, 0]
        if pa.use_kernel(q1, layer_pool, table):
            lengths = (positions[:, 0] + 1).to(torch.int32)
            attn = pa.paged_attention(
                q1, layer_pool, table, lengths,
                scale=float(head_dim) ** -0.5, impl="kernel",
            )
            return attn[:, None], layer_pool
    view = _paged_view(layer_pool, table)
    attn = _cached_attention(q, view, positions, float(head_dim) ** -0.5)
    return attn, layer_pool


def _block_paged(cfg, x, layer_params, layer_pool, table, positions,
                 rope=None, slots=None, lora=None):
    """Llama block over paged KV — identical projections/residuals to
    `_block` (the per-slot `lora` deltas included); only the cache
    write + attention differ."""
    lp = _compute_weights(cfg, layer_params)
    h = _rms_norm(x, layer_params["attn_norm"], cfg.norm_eps)
    q, k, v = _attn_qkv(cfg, h, lp, positions, rope, lora=lora)
    attn, layer_pool = _write_pages_and_attend(
        q, k, v, layer_pool, table, positions, cfg.head_dim,
        attn_impl=cfg.attn_impl, slots=slots,
    )
    x = _attn_residual(cfg, x, attn, lp, lora=lora)
    x = _mlp_residual(cfg, x, layer_params, lp)
    return x, layer_pool


def _forward_paged(cfg, params, tokens, pool, table, positions,
                   adapters=None):
    """tokens [B, S] -> logits [B, S, V] over the paged pool; the table
    is shared by every layer, and so is the optional `adapters`
    operand's idx."""
    _check_adapters(cfg, adapters)
    x = params["embed"]["weight"].to(cfg.dtype)[tokens]
    rope = _rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    slots = _page_slots(table, positions, pool["k"].shape[2])
    for layer in range(cfg.n_layers):
        layer_pool = {name: arr[layer] for name, arr in pool.items()}
        x, _ = _block_paged(
            cfg, x, _layer_params(params, layer), layer_pool, table,
            positions, rope=rope, slots=slots,
            lora=_layer_lora(adapters, layer),
        )
    return _logits(cfg, params, x), pool


def paged_decode_step(cfg, params, token, pool, table, pos, adapters=None):
    """One cached step over paged KV -> (logits [B, V], pool); `pos` is
    the [B] per-slot position vector."""
    pos = torch.as_tensor(pos, dtype=torch.long, device=token.device)
    logits, pool = _forward_paged(
        cfg, params, token[:, None], pool, table, pos[:, None],
        adapters=adapters,
    )
    return logits[:, 0], pool


def paged_verify_step(cfg, params, tokens, pool, table, pos, adapters=None):
    """The paged twin of `verify_step`: the K/V of tokens [B, S] goes
    straight into the rows' pages, and the queries attend through the
    gathered view (S > 1 never takes the paged-attention kernel). The
    engine sizes each request's page run for limit - 1 + draft_len
    cells, so the window lands in owned (or trash) pages."""
    return _forward_paged(cfg, params, tokens, pool, table,
                          _verify_positions(tokens, pos), adapters=adapters)


def paged_install_row(pool: Cache, row_cache: Cache, table_row, start: int,
                      length: int) -> Cache:
    """Install cells [start, start+length) of an exact cache row into
    the pages `table_row` maps them to, in place — quantizing on the
    way in when the pool is int8 (per-vector scales make quantizing the
    slice equal to slicing the quantized whole, so the bytes match the
    dense bank's). The slice start clamps so the window fits the row,
    as the JAX package's dynamic_slice does."""
    ps = pool["k"].shape[2]
    m = row_cache["k"].shape[2]
    dev = table_row.device
    positions = int(start) + torch.arange(length, device=dev)
    pids = table_row[positions // ps].long()
    offs = positions % ps
    st = min(max(int(start), 0), m - length)
    src = {n: row_cache[n][:, 0, st:st + length] for n in ("k", "v")}
    if "k_scale" in pool:
        kq, ks = _kv_quantize(src["k"])
        vq, vs = _kv_quantize(src["v"])
        src = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    for name, arr in pool.items():
        arr[:, pids, offs] = src[name].to(arr.dtype)
    return pool


def paged_prefill_chunk(cfg, params, chunk, pool: Cache, table_row,
                        start: int, adapters=None) -> Cache:
    """Paged twin of `prefill_chunk_into_slot`: run `chunk` [C] at
    positions [start, start+C), scattering its K/V through `table_row`
    [P], the slot's REAL page ids (never the trash-routed table a decode
    dispatch sees: a mid-prefill slot rides the decode half as a done
    row). The engine allocates the slot's whole page run at admission,
    so every chunk position maps to an owned page. `adapters` carries
    the slot's 1-row idx."""
    positions = _chunk_positions(start, chunk.shape[0], chunk.device)
    _forward_paged(cfg, params, chunk[None], pool, table_row[None],
                   positions, adapters=adapters)
    return pool


def pool_copy_page(pool: Cache, src: int, dst: int) -> Cache:
    """Copy physical page `src` onto `dst` in every layer, in place: the
    device half of copy-on-write."""
    for arr in pool.values():
        arr[:, dst] = arr[:, src]
    return pool


def _mask_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Keep the k highest logits per row; the rest become -inf. Tokens
    tied with the k-th logit all survive."""
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, float("-inf"), logits)


def _mask_top_p(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus filtering: keep the smallest prefix of the
    probability-sorted vocab whose mass reaches `p` (the top token
    always survives); tokens tied with the boundary logit all survive."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # a sorted position is kept while the mass BEFORE it is < p
    keep = torch.cat(
        [torch.ones_like(cum[..., :1], dtype=torch.bool), cum[..., :-1] < p],
        dim=-1,
    )
    kth = torch.where(keep, sorted_logits, float("inf")).amin(
        dim=-1, keepdim=True
    )
    return torch.where(logits < kth, float("-inf"), logits)


def categorical(probs: torch.Tensor, generator=None) -> torch.Tensor:
    """One draw per row of `probs` [..., V] (any nonnegative weights, a
    row need not sum to 1): torch.multinomial(probs, 1)'s own algorithm
    for one sample, argmax(p / E) with E ~ Exp(1) from `generator`, so
    the draws equal multinomial's on the same generator state, without
    its host-side validity checks (two reads of device values that
    would stall the card's stream). A zero-weight entry is never drawn
    while its row has any weight."""
    e = torch.empty_like(probs).exponential_(1, generator=generator)
    return torch.argmax(probs / e, dim=-1)


def spec_accept_greedy(logits, drafts, draft_len):
    """Greedy acceptance: draft j survives while it equals the target
    argmax at its position (and every earlier draft survived). logits
    [B, K+1, V], drafts [B, K], draft_len [B] -> (m, extra) [B]: m
    accepted drafts per row and the target's own token at the first
    divergence (the bonus token when all K were accepted), so the
    emitted prefix is exactly the target's greedy continuation."""
    k = drafts.shape[1]
    tgt = torch.argmax(logits, dim=-1)                    # [B, K+1]
    cols = torch.arange(k, device=drafts.device)[None, :]
    ok = (drafts == tgt[:, :k]) & (cols < draft_len[:, None])
    m = torch.cumprod(ok.long(), dim=1).sum(dim=1)
    extra = torch.gather(tgt, 1, m[:, None])[:, 0]
    return m, extra


def spec_accept_sampled(probs, drafts, draft_len, generator=None):
    """Speculative rejection sampling for a deterministic drafter (the
    n-gram lookup proposes a point mass q): draft d_j is accepted with
    probability min(1, p_j(d_j) / q_j(d_j)) = p_j(d_j), drawing u in
    [0, 1)^K; on the first rejection the replacement is drawn from the
    residual norm(max(p_j - q_j, 0)), p_j with d_j's mass removed; when
    every draft survives the bonus is drawn from p_{K+1}. The emitted
    marginal at each position is exactly p_j. probs [B, K+1, V] (warped
    target probabilities), drafts [B, K], draft_len [B]; every draw
    comes from `generator` -> (m, extra) [B]. A rejected row always has
    residual mass (u >= p(d) with u < 1 means p(d) < 1), and
    `categorical` never draws a zero-mass token."""
    b, kp1, v = probs.shape
    k = kp1 - 1
    dev = probs.device
    u = torch.rand((b, k), generator=generator, device=dev)
    d = drafts.long()
    p_draft = torch.gather(probs[:, :k], 2, d[..., None])[..., 0]
    cols = torch.arange(k, device=dev)[None, :]
    ok = (u < p_draft) & (cols < draft_len[:, None])
    m = torch.cumprod(ok.long(), dim=1).sum(dim=1)
    pm = probs[torch.arange(b, device=dev), m]            # [B, V]
    # the draft at the rejection index (the pad column keeps the gather
    # in bounds at m == K, where `rejected` is False)
    d_pad = torch.cat([d, torch.zeros_like(d[:, :1])], dim=1)
    d_at_m = torch.gather(d_pad, 1, m[:, None])
    rejected = m < draft_len
    vocab = torch.arange(v, device=dev)[None, :]
    resid = torch.where(rejected[:, None] & (vocab == d_at_m), 0.0, pm)
    return m, categorical(resid, generator)
