"""KV-cache autoregressive decoding for the Llama family — counterpart
of dlrover_tpu/models/decode.py (the dense slot bank and the paged
pool that the serving engine drives).

Where the JAX package scans the stacked layers, this loops over them;
where it donates a cache buffer and returns the updated one, this
writes the cache or pool IN PLACE and returns the same dict (the
callers hold the only reference, exactly as donation assumes).

Prefill and decode share `_block` (S=P vs S=1) so there is exactly one
attention/cache implementation to keep correct. Prefill attends with
plain causal attention over the chunk (the flash kernel on the card);
decode attends over the whole buffer under the position mask (the
dense bank), or over the page pool (the paged-attention kernel on the
card, the gathered dense view on the CPU).
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
           start, plain_causal: bool = False, rope=None):
    """One decoder block writing its K/V into the cache. `rope` is the
    forward's precomputed `_rope_tables` (computed here when None)."""
    lp = _compute_weights(cfg, layer_params)
    h = _rms_norm(x, layer_params["attn_norm"], cfg.norm_eps)
    q, k, v = _attn_qkv(cfg, h, lp, positions, rope)
    attn, layer_cache = _write_cache_and_attend(
        q, k, v, layer_cache, positions, start, cfg.head_dim,
        attn_impl=cfg.attn_impl, plain_causal=plain_causal,
    )
    x = _attn_residual(cfg, x, attn, lp)
    x = _mlp_residual(cfg, x, layer_params, lp)
    return x, layer_cache


def _logits(cfg, params, x):
    x = _rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    return matmul_any(x, _head_matrix(cfg, params)).float()


def _forward_cached(cfg, params, tokens, cache, positions, start,
                    plain_causal: bool = False):
    """tokens [B,S] -> logits [B,S,V], writing the cache at
    [start, start+S)."""
    x = params["embed"]["weight"].to(cfg.dtype)[tokens]
    rope = _rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    for layer in range(cfg.n_layers):
        layer_cache = {name: arr[layer] for name, arr in cache.items()}
        x, _ = _block(
            cfg, x, _layer_params(params, layer), layer_cache, positions,
            start, plain_causal=plain_causal, rope=rope,
        )
    return _logits(cfg, params, x), cache


def prefill(cfg, params, tokens, cache):
    """Fill the cache from a prompt [B, P]; returns (last-token logits,
    cache)."""
    b, p = tokens.shape
    positions = torch.arange(p, device=tokens.device).expand(b, p)
    logits, cache = _forward_cached(
        cfg, params, tokens, cache, positions, 0, plain_causal=p > 1,
    )
    return logits[:, -1], cache


def decode_step(cfg, params, token, cache, pos):
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
    )
    return logits[:, 0], cache


def prefill_into_slot(cfg, params, prompt, cache, slot: int):
    """Run a single-sequence prefill of `prompt` [P] (a pad tail is
    fine: the decode mask hides cells past the slot's position) and
    install its K/V into row `slot` of a multi-slot cache."""
    p = prompt.shape[0]
    if cache["k"].shape[2] < p:
        raise ValueError(
            f"prompt chunk {p} exceeds cache max_len {cache['k'].shape[2]}"
        )
    mini = init_kv_cache(
        cfg, 1, p, quant="k_scale" in cache, device=prompt.device
    )
    _, mini = prefill(cfg, params, prompt[None], mini)
    for name, arr in cache.items():
        arr[:, slot, :p] = mini[name][:, 0].to(arr.dtype)
    return cache


def exact_row_cache(cfg, max_len: int, device: DeviceLike = None) -> Cache:
    """A single-sequence full-precision cache row [L, 1, M, KV, hd]."""
    return init_kv_cache(cfg, 1, max_len, quant=False, device=device)


def prefill_exact_row(cfg, params, prompt, max_len: int) -> Cache:
    """Cold-admission prefill of `prompt` [P] into a fresh exact row."""
    row = exact_row_cache(cfg, max_len, device=prompt.device)
    _, row = prefill(cfg, params, prompt[None], row)
    return row


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
                 rope=None, slots=None):
    """Llama block over paged KV — identical projections/residuals to
    `_block`; only the cache write + attention differ."""
    lp = _compute_weights(cfg, layer_params)
    h = _rms_norm(x, layer_params["attn_norm"], cfg.norm_eps)
    q, k, v = _attn_qkv(cfg, h, lp, positions, rope)
    attn, layer_pool = _write_pages_and_attend(
        q, k, v, layer_pool, table, positions, cfg.head_dim,
        attn_impl=cfg.attn_impl, slots=slots,
    )
    x = _attn_residual(cfg, x, attn, lp)
    x = _mlp_residual(cfg, x, layer_params, lp)
    return x, layer_pool


def _forward_paged(cfg, params, tokens, pool, table, positions):
    """tokens [B, S] -> logits [B, S, V] over the paged pool; the table
    is shared by every layer."""
    x = params["embed"]["weight"].to(cfg.dtype)[tokens]
    rope = _rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    slots = _page_slots(table, positions, pool["k"].shape[2])
    for layer in range(cfg.n_layers):
        layer_pool = {name: arr[layer] for name, arr in pool.items()}
        x, _ = _block_paged(
            cfg, x, _layer_params(params, layer), layer_pool, table,
            positions, rope=rope, slots=slots,
        )
    return _logits(cfg, params, x), pool


def paged_decode_step(cfg, params, token, pool, table, pos):
    """One cached step over paged KV -> (logits [B, V], pool); `pos` is
    the [B] per-slot position vector."""
    pos = torch.as_tensor(pos, dtype=torch.long, device=token.device)
    logits, pool = _forward_paged(
        cfg, params, token[:, None], pool, table, pos[:, None],
    )
    return logits[:, 0], pool


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
