"""KV-cache autoregressive decoding for the Llama and GPT-2 families —
counterpart of dlrover_tpu/models/decode.py (the dense slot bank and the paged
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

`generate` samples a batch from one prompt tensor: a prefill, then
one `decode_step` a token (greedy, temperature, top-k / top-p, eos with
a pad tail), as JAX's one compiled scan does.

Multi-adapter LoRA serving (serving/adapters.py): every forward below
that JAX's takes `adapters` on takes an optional `adapters` operand,
{"bank": {"<t>_a": [L, S, in, r], "<t>_b": [L, S, r, out]}, "idx": [B]
int (each row's bank slot), "scale": [S] f32}. Each layer takes its own
[S, ...] slices and adds each row's delta inside the projections
(`llama._slot_lora_delta`). With adapters=None every function computes
exactly what it computes without the operand.

Tensor-parallel serving (`mesh`, a parallel/mesh.ServingMesh of tp > 1;
JAX's serving mesh and GSPMD): every entry JAX threads `mesh` through
takes it here. Only the attention splits by head. Each layer computes
q/k/v per shard from the replicated layer input (shards that share a
device in one product over their adjacent wq/wk/wv columns, the
`Sharded.whole` of parallel/sharding.py), writes each shard's heads
into its own KV bank, attends per shard (the sharded flash and paged
kernel sites), and gathers the outputs on the mesh's home device, where
wo, the MLP, the norms and the logits run once, as at tp=1. A sharded
cache, page pool or exact row is a list of per-shard dicts (the KV
heads of shard i in entry i); the host-planned operands (positions,
tables, lengths) are moved to each shard's device, a no-op where the
shards share it. No contraction is ever split, so tp > 1 computes what
tp = 1 computes, chunked by head; with mesh=None every function runs
the one-device code unchanged.
"""

from typing import Dict, List, Optional, Tuple, Union

import torch

from dlrover_tpu_torch._device import DeviceLike, resolve_device
from dlrover_tpu_torch.models import gpt as _gpt
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
from dlrover_tpu_torch.parallel.mesh import serving_mesh_tp
from dlrover_tpu_torch.parallel.sharding import Sharded

Cache = Dict[str, torch.Tensor]
# a bank, pool or row: one dict, or one dict per head shard (tp > 1)
AnyCache = Union[Cache, List[Cache]]


def kv_shards(cache: AnyCache) -> List[Cache]:
    """The per-shard dicts of a cache (a one-device cache is one shard)."""
    return list(cache) if isinstance(cache, (list, tuple)) else [cache]


def kv_read(cache: AnyCache, fn) -> Cache:
    """`fn(array)` of every array of a cache, in the one-device layout:
    a sharded cache's results concatenated on their KV-head axis (dim 3)
    on the first shard's device."""
    shards = kv_shards(cache)
    if len(shards) == 1:
        return {name: fn(arr) for name, arr in shards[0].items()}
    dev = next(iter(shards[0].values())).device
    return {name: torch.cat([fn(sh[name]).to(dev) for sh in shards], 3)
            for name in shards[0]}


def kv_write(cache: AnyCache, data: Cache, fn) -> None:
    """`fn(array, piece)` for every array of a cache, with `data` (the
    one-device layout) cut by head for each shard (`kv_split`)."""
    for sh, piece in zip(kv_shards(cache), kv_split(data, cache)):
        for name, arr in sh.items():
            fn(arr, piece[name])


def kv_split(cache: Cache, like: AnyCache) -> List[Cache]:
    """A one-device cache cut on its KV-head axis the way `like` is
    sharded, each piece on its shard's device (views where the devices
    match)."""
    shards = kv_shards(like)
    if len(shards) == 1:
        return [cache]
    widths = [sh["k"].shape[3] for sh in shards]
    out: List[Cache] = [{} for _ in shards]
    for name, arr in cache.items():
        for i, piece in enumerate(torch.split(arr, widths, 3)):
            out[i][name] = piece.to(shards[i][name].device)
    return out


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


def _sharded_zeros(cfg, rows: int, cells: int, quant: bool, device,
                   mesh) -> AnyCache:
    """[L, rows, cells, KV, hd] buffers; with a mesh of tp > 1 one dict
    per shard holding its KV / tp heads on its device
    (`serving_kv_spec`)."""
    tp = serving_mesh_tp(mesh)
    dtypes = _kv_dtypes(cfg, quant)
    if tp == 1:
        shape = (cfg.n_layers, rows, cells, cfg.n_kv_heads, cfg.head_dim)
        return _zeros(shape, dtypes, resolve_device(device))
    shape = (cfg.n_layers, rows, cells, cfg.n_kv_heads // tp, cfg.head_dim)
    return [_zeros(shape, dtypes, dev) for dev in mesh.devices]


def init_kv_cache(
    cfg, batch: int, max_len: int, quant: bool = False,
    device: DeviceLike = None, mesh=None,
) -> AnyCache:
    """Fixed-size cache buffers [L, B, M, KV, hd]; dtype follows the
    compute dtype. quant=True stores K/V as symmetric per-vector int8
    plus one bf16 scale per [position, head]. `mesh` (tp > 1): one dict
    per head shard."""
    return _sharded_zeros(cfg, batch, max_len, quant, device, mesh)


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
    mesh=None,
):
    """Write this chunk's K/V into the cache at `start` and attend.

    `plain_causal` is the prefill fast path, asserted by the caller
    that owns the invariant (prefill(): start 0 and dense arange
    positions, so the chunk IS the whole valid prefix): plain causal
    attention over the chunk — the flash kernel on the card.

    `mesh` (tp > 1): q/k/v and `layer_cache` are per-shard lists; each
    shard writes its heads and attends on its own device (prefill
    through the sharded flash site), and the output comes back
    gathered on mesh.home, ready for wo."""
    if serving_mesh_tp(mesh) > 1:
        for i, dev in enumerate(mesh.devices):
            st = _on(start, dev)
            _write_kv(layer_cache[i], k[i], v[i],
                      lambda arr, upd: _cache_write(arr, upd, st))
        if plain_causal:
            impl = "reference" if attn_impl == "reference" else "auto"
            parts = dot_product_attention(q, k, v, causal=True, impl=impl,
                                          tp=mesh.tp, mesh=mesh)
        else:
            parts = [_cached_attention(q[i], layer_cache[i],
                                       positions.to(dev),
                                       float(head_dim) ** -0.5)
                     for i, dev in enumerate(mesh.devices)]
        return mesh.gather(parts, 2), layer_cache
    _write_kv(layer_cache, k, v, lambda arr, upd: _cache_write(arr, upd,
                                                               start))
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


def _write_kv(layer_cache, k, v, write) -> None:
    """`write(arr, update)` of this chunk's K/V into each array of one
    layer's cache (int8 caches: the quantized values and their
    scales)."""
    if "k_scale" in layer_cache:
        kq, ks = _kv_quantize(k)
        vq, vs = _kv_quantize(v)
        writes = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    else:
        writes = {"k": k, "v": v}
    for name, upd in writes.items():
        write(layer_cache[name], upd)


def _on(x, dev):
    """A host-planned operand (a tensor, a tuple of them, or a plain
    number) on `dev`: the tensor itself where it is there already."""
    if torch.is_tensor(x):
        return x.to(dev)
    if isinstance(x, tuple):
        return tuple(_on(t, dev) for t in x)
    return x


def _shard_lora(lora, i: int, dev):
    """Shard i's (bank slices, idx, scale): its B columns, the
    replicated A banks and the row indices on its device."""
    if lora is None:
        return None
    bank, idx, scale = lora
    return ({n: (a.shards[i] if isinstance(a, Sharded) else a.to(dev))
             for n, a in bank.items()}, idx.to(dev), scale.to(dev))


def _qkv_sharded(cfg, h, lp, positions, rope, lora, mesh):
    """Per-shard q [B,S,H/tp,hd], k/v [B,S,KV/tp,hd] on their devices,
    from the replicated `h`. On a colocated mesh the shards' adjacent
    columns are one product on the stored whole (`Sharded.whole`): the
    per-shard products in one call, bit for bit the unsharded one."""
    tp = mesh.tp
    qkv = [lp[n] for n in ("wq", "wk", "wv")]
    if mesh.colocated and all(not isinstance(w, Sharded)
                              or w.whole is not None for w in qkv):
        lp_w = {n: (w.whole if isinstance(w, Sharded) else w)
                for n, w in lp.items()}
        lora_w = None
        if lora is not None:
            bank, idx, scale = lora
            lora_w = ({n: (a.whole if isinstance(a, Sharded) else a)
                       for n, a in bank.items()}, idx, scale)
        q, k, v = _attn_qkv(cfg, h, lp_w, positions, rope, lora=lora_w,
                            tp=tp)
        return mesh.split(q, 2), mesh.split(k, 2), mesh.split(v, 2)
    if not all(isinstance(w, Sharded) for w in qkv):
        raise ValueError("a slice across devices needs wq/wk/wv placed "
                         "by parallel/sharding.shard_tree")
    heads = (cfg.n_heads // tp, cfg.n_kv_heads // tp)
    qs, ks, vs = [], [], []
    for i, dev in enumerate(mesh.devices):
        lp_i = {n: lp[n].shards[i] for n in ("wq", "wk", "wv")}
        q, k, v = _attn_qkv(cfg, h.to(dev), lp_i, positions.to(dev),
                            _on(rope, dev), lora=_shard_lora(lora, i, dev),
                            heads=heads, tp=tp)
        qs.append(q)
        ks.append(k)
        vs.append(v)
    return qs, ks, vs


def _block(cfg: LlamaConfig, x, layer_params, layer_cache, positions,
           start, plain_causal: bool = False, rope=None, lora=None,
           mesh=None):
    """One decoder block writing its K/V into the cache. `rope` is the
    forward's precomputed `_rope_tables` (computed here when None);
    `lora` is (this layer's bank slices, idx, scale) or None. `mesh`
    (tp > 1): `layer_cache` is a per-shard list, q/k/v are computed per
    shard (`_qkv_sharded`), and wo, the MLP and the residuals run once
    on the gathered heads."""
    lp = _compute_weights(cfg, layer_params)
    h = _rms_norm(x, layer_params["attn_norm"], cfg.norm_eps)
    tp = serving_mesh_tp(mesh)
    if tp > 1:
        q, k, v = _qkv_sharded(cfg, h, lp, positions, rope, lora, mesh)
    else:
        q, k, v = _attn_qkv(cfg, h, lp, positions, rope, lora=lora)
    attn, layer_cache = _write_cache_and_attend(
        q, k, v, layer_cache, positions, start, cfg.head_dim,
        attn_impl=cfg.attn_impl, plain_causal=plain_causal, mesh=mesh,
    )
    x = _attn_residual(cfg, x, attn, lp, lora=lora, tp=tp)
    x, _aux = _mlp_residual(cfg, x, layer_params, lp, tp=tp)
    return x, layer_cache


def _block_gpt(cfg, x, lp, layer_cache, positions, start,
               plain_causal: bool = False):
    """GPT-2 pre-LN block writing its K/V into the cache, built from
    models/gpt.py's own pieces (the positions were consumed at the
    embedding)."""
    q, k, v = _gpt._attn_qkv(cfg, x, lp)
    attn, layer_cache = _write_cache_and_attend(
        q, k, v, layer_cache, positions, start, cfg.head_dim,
        attn_impl=cfg.attn_impl, plain_causal=plain_causal,
    )
    x = _gpt._attn_residual(cfg, x, attn, lp)
    return _gpt._mlp_residual(cfg, x, lp), layer_cache


def _is_gpt(cfg) -> bool:
    return isinstance(cfg, _gpt.GptConfig)


def _embed(cfg, params, tokens, positions):
    """The family's input embedding in the compute dtype. GPT adds its
    learned positions, gathered with JAX's clamp to the table (the
    engine's verify window may reach past a slot's cap; those cells
    are never read)."""
    if _is_gpt(cfg):
        pos = positions.clamp(0, cfg.max_seq_len - 1)
        return (params["wte"].to(cfg.dtype)[tokens]
                + params["wpe"].to(cfg.dtype)[pos])
    return params["embed"]["weight"].to(cfg.dtype)[tokens]


def _logits(cfg, params, x, tp: int = 1):
    """Final norm and head: GPT's LayerNorm and tied `wte`, Llama's
    RMSNorm and `_head_matrix`."""
    if _is_gpt(cfg):
        return _gpt.final_logits(cfg, params, x, tp)
    x = _rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    return matmul_any(x, _head_matrix(cfg, params), tp=tp).float()


def _layer_cache(cache: AnyCache, layer: int):
    """One layer's slices of a cache (of each shard's, when sharded)."""
    if isinstance(cache, (list, tuple)):
        return [{n: a[layer] for n, a in sh.items()} for sh in cache]
    return {name: arr[layer] for name, arr in cache.items()}


def _check_positional_capacity(cfg, max_len: int) -> None:
    """GPT's LEARNED position table stops at max_seq_len: decoding past
    it would reuse wpe[-1] (JAX clamps the gather) and emit garbage.
    RoPE (Llama) computes any position, so no bound applies there."""
    if _is_gpt(cfg) and max_len > cfg.max_seq_len:
        raise ValueError(
            f"decode length {max_len} exceeds the GPT position table "
            f"(max_seq_len={cfg.max_seq_len}); positions would clamp "
            "and produce wrong logits"
        )


def _check_adapters(cfg, adapters) -> None:
    if adapters is not None and _is_gpt(cfg):
        raise ValueError(
            "multi-adapter serving targets the llama attention "
            "projections; GPT's fused qkv has no per-target bank"
        )


def _layer_lora(adapters, layer: int):
    """One layer's (bank slices [S, ...], idx, scale), or None."""
    if adapters is None:
        return None
    bank = {name: arr[layer] for name, arr in adapters["bank"].items()}
    return bank, adapters["idx"], adapters["scale"]


def _forward_cached(cfg, params, tokens, cache, positions, start,
                    plain_causal: bool = False, adapters=None, mesh=None):
    """tokens [B,S] -> logits [B,S,V], writing the cache at
    [start, start+S); `adapters` (module docstring) adds each row's
    LoRA delta; `mesh` (tp > 1) runs the head-sharded blocks over a
    per-shard cache. Family dispatch: Llama (RoPE, GQA, RMSNorm) or
    GPT-2 (learned positions, pre-LN, the head tied to wte)."""
    _check_adapters(cfg, adapters)
    x = _embed(cfg, params, tokens, positions)
    if _is_gpt(cfg):
        for layer in range(cfg.n_layers):
            x, _ = _block_gpt(cfg, x, _layer_params(params, layer),
                              _layer_cache(cache, layer), positions, start,
                              plain_causal=plain_causal)
        return _logits(cfg, params, x), cache
    rope = _rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    for layer in range(cfg.n_layers):
        x, _ = _block(
            cfg, x, _layer_params(params, layer), _layer_cache(cache, layer),
            positions, start, plain_causal=plain_causal, rope=rope,
            lora=_layer_lora(adapters, layer), mesh=mesh,
        )
    return _logits(cfg, params, x, serving_mesh_tp(mesh)), cache


def prefill(cfg, params, tokens, cache, adapters=None, mesh=None):
    """Fill the cache from a prompt [B, P]; returns (last-token logits,
    cache)."""
    b, p = tokens.shape
    positions = torch.arange(p, device=tokens.device).expand(b, p)
    logits, cache = _forward_cached(
        cfg, params, tokens, cache, positions, 0, plain_causal=p > 1,
        adapters=adapters, mesh=mesh,
    )
    return logits[:, -1], cache


def decode_step(cfg, params, token, cache, pos, adapters=None, mesh=None):
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
        adapters=adapters, mesh=mesh,
    )
    return logits[:, 0], cache


def _verify_positions(tokens, pos):
    """[B, S] positions pos[b] + [0, S) of a verify's tokens."""
    pos = torch.as_tensor(pos, dtype=torch.long, device=tokens.device)
    return pos[:, None] + torch.arange(tokens.shape[1],
                                       device=tokens.device)[None, :]


def verify_step(cfg, params, tokens, cache, pos, adapters=None, mesh=None):
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
                           positions[:, 0], adapters=adapters, mesh=mesh)


def prefill_into_slot(cfg, params, prompt, cache, slot: int, adapters=None,
                      mesh=None):
    """Run a single-sequence prefill of `prompt` [P] (a pad tail is
    fine: the decode mask hides cells past the slot's position) and
    install its K/V into row `slot` of a multi-slot cache. `adapters`
    carries a 1-row idx (the admitted request's bank slot): an adapted
    request's prompt K/V comes from the adapted projections."""
    p = prompt.shape[0]
    first = kv_shards(cache)[0]
    if first["k"].shape[2] < p:
        raise ValueError(
            f"prompt chunk {p} exceeds cache max_len {first['k'].shape[2]}"
        )
    mini = init_kv_cache(
        cfg, 1, p, quant="k_scale" in first, device=prompt.device, mesh=mesh
    )
    _, mini = prefill(cfg, params, prompt[None], mini, adapters=adapters,
                      mesh=mesh)
    for sh, msh in zip(kv_shards(cache), kv_shards(mini)):
        for name, arr in sh.items():
            arr[:, slot, :p] = msh[name][:, 0].to(arr.dtype)
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


def exact_row_cache(cfg, max_len: int, device: DeviceLike = None,
                    mesh=None) -> AnyCache:
    """A single-sequence full-precision cache row [L, 1, M, KV, hd]."""
    return init_kv_cache(cfg, 1, max_len, quant=False, device=device,
                         mesh=mesh)


def prefill_exact_row(cfg, params, prompt, max_len: int,
                      adapters=None, mesh=None) -> AnyCache:
    """Cold-admission prefill of `prompt` [P] into a fresh exact row.
    `adapters` (a 1-row idx) serves the paged cold admission of an
    adapted request; rows bound for the shared prefix pool pass None
    (published prefixes are base-model K/V by contract)."""
    row = exact_row_cache(cfg, max_len, device=prompt.device, mesh=mesh)
    _, row = prefill(cfg, params, prompt[None], row, adapters=adapters,
                     mesh=mesh)
    return row


def _chunk_positions(start: int, n: int, device):
    return (int(start) + torch.arange(n, device=device))[None]


def prefill_suffix_row(cfg, params, suffix, row: AnyCache, start: int,
                       mesh=None) -> AnyCache:
    """Warm-admission prefill: extend an exact row that holds K/V of
    positions [0, start) with `suffix` [S] at positions [start,
    start+S), in place. The suffix queries attend over the installed
    prefix and the suffix itself through the position-masked
    `_cached_attention` (each position is written before it is read),
    not flash. The caller keeps start + S within the row."""
    positions = _chunk_positions(start, suffix.shape[0], suffix.device)
    _forward_cached(cfg, params, suffix[None], row, positions, start,
                    mesh=mesh)
    return row


def prefill_chunk_into_slot(cfg, params, chunk, cache: AnyCache, slot: int,
                            start: int, adapters=None,
                            mesh=None) -> AnyCache:
    """Resume slot `slot`'s prefill at its write frontier: run `chunk`
    [C] (real tokens only, no pad tail) at positions [start, start+C),
    writing K/V straight into that row of the multi-slot bank, in place:
    `prefill_suffix_row` on a view of the row (for exact banks the K/V
    one blocking prefill writes; an int8 bank attends the dequantized
    earlier chunks). `adapters` carries the slot's 1-row idx."""
    positions = _chunk_positions(start, chunk.shape[0], chunk.device)
    rows = [{name: arr[:, slot:slot + 1] for name, arr in sh.items()}
            for sh in kv_shards(cache)]
    _forward_cached(cfg, params, chunk[None],
                    rows if isinstance(cache, list) else rows[0],
                    positions, start, adapters=adapters, mesh=mesh)
    return cache


def install_exact_row(cache: AnyCache, row: AnyCache, slot: int) -> AnyCache:
    """Write an exact row into slot `slot` of the (possibly int8) slot
    bank, in place, quantizing on the way in when the bank is int8 (the
    cold write path's per-vector scheme on the same exact values). A
    whole-row write: cells past the valid prefix are hidden by the
    decode position mask until generation overwrites them. A row
    shorter than the bank (a bank over-allocated by the draft width)
    fills its leading cells, as the JAX package's dynamic_update_slice
    does. A sharded bank takes a sharded row, shard by shard."""
    for sh, rsh in zip(kv_shards(cache), kv_shards(row)):
        if "k_scale" in sh:
            kq, ks = _kv_quantize(rsh["k"])
            vq, vs = _kv_quantize(rsh["v"])
            rsh = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
        for name, arr in sh.items():
            src = rsh[name][:, 0]
            arr[:, slot, :src.shape[1]] = src.to(arr.dtype)
    return cache


def pool_take_row(pool: AnyCache, row: int) -> AnyCache:
    """A copy of pool row `row` as a single-sequence exact cache (one per
    shard when sharded)."""
    rows = [{name: arr[:, row:row + 1].clone() for name, arr in sh.items()}
            for sh in kv_shards(pool)]
    return rows if isinstance(pool, list) else rows[0]


def pool_put_row(pool: AnyCache, row_cache: AnyCache, row: int) -> AnyCache:
    """Publish an exact row into pool row `row` (whole-row write)."""
    for sh, rsh in zip(kv_shards(pool), kv_shards(row_cache)):
        for name, arr in sh.items():
            arr[:, row] = rsh[name][:, 0].to(arr.dtype)
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
    device: DeviceLike = None, mesh=None,
) -> AnyCache:
    """The global page pool [L, n_pages, page_size, KV, hd] (+ per
    [page, cell, head] bf16 scales when quant — the same per-vector
    int8 scheme as init_kv_cache). `mesh` (tp > 1): one pool per head
    shard, every shard holding every page of its heads."""
    return _sharded_zeros(cfg, n_pages, page_size, quant, device, mesh)


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
    attn_impl: str = "auto", slots=None, mesh=None,
):
    """Scatter this chunk's K/V into the rows' pages (row b, chunk
    position s -> pool[table[b, pos//ps], pos%ps]), in place, and
    attend: S == 1 through the paged-attention kernel on the card,
    otherwise (and on the CPU) through the gathered dense view with the
    identical position-masked attention. Only done rows parked on the
    trash page collide in the scatter; no live mask reads those cells.
    `slots` is the forward's precomputed `_page_slots`. `mesh` (tp > 1):
    q/k/v and `layer_pool` are per-shard lists (`_pages_sharded`)."""
    if serving_mesh_tp(mesh) > 1:
        return _pages_sharded(q, k, v, layer_pool, table, positions,
                              head_dim, attn_impl, slots, mesh)
    if slots is None:
        slots = _page_slots(table, positions, layer_pool["k"].shape[1])
    pids, offs = slots
    _write_kv(layer_pool, k, v, _page_write(pids, offs))
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


def _page_write(pids, offs):
    def write(arr, upd):
        arr[pids, offs] = upd.to(arr.dtype)
    return write


def _pages_sharded(q, k, v, layer_pools, table, positions, head_dim,
                   attn_impl, slots, mesh):
    """`_write_pages_and_attend` per head shard: each shard scatters its
    heads into its own pool through the one host-planned table; a
    decode step attends through the sharded paged kernel site
    (`paged_attention(..., mesh=)`) where JAX's gate takes it on the
    per-shard shapes, otherwise each shard through its gathered view.
    Returns the heads gathered on mesh.home."""
    if slots is None:
        slots = _page_slots(table, positions, layer_pools[0]["k"].shape[1])
    for i, dev in enumerate(mesh.devices):
        _write_kv(layer_pools[i], k[i], v[i], _page_write(*_on(slots, dev)))
    scale = float(head_dim) ** -0.5
    if q[0].shape[1] == 1 and attn_impl != "reference":
        q1 = [qi[:, 0] for qi in q]
        if pa.use_kernel(q1, layer_pools, table, tp=mesh.tp):
            lengths = (positions[:, 0] + 1).to(torch.int32)
            parts = pa.paged_attention(q1, layer_pools, table, lengths,
                                       scale=scale, impl="kernel", mesh=mesh)
            return mesh.gather(parts, 1)[:, None], layer_pools
    parts = [_cached_attention(q[i], _paged_view(layer_pools[i],
                                                 table.to(dev)),
                               positions.to(dev), scale)
             for i, dev in enumerate(mesh.devices)]
    return mesh.gather(parts, 2), layer_pools


def _block_paged(cfg, x, layer_params, layer_pool, table, positions,
                 rope=None, slots=None, lora=None, mesh=None):
    """Llama block over paged KV — identical projections/residuals to
    `_block` (the per-slot `lora` deltas included, per shard at tp > 1);
    only the cache write + attention differ."""
    lp = _compute_weights(cfg, layer_params)
    h = _rms_norm(x, layer_params["attn_norm"], cfg.norm_eps)
    tp = serving_mesh_tp(mesh)
    if tp > 1:
        q, k, v = _qkv_sharded(cfg, h, lp, positions, rope, lora, mesh)
    else:
        q, k, v = _attn_qkv(cfg, h, lp, positions, rope, lora=lora)
    attn, layer_pool = _write_pages_and_attend(
        q, k, v, layer_pool, table, positions, cfg.head_dim,
        attn_impl=cfg.attn_impl, slots=slots, mesh=mesh,
    )
    x = _attn_residual(cfg, x, attn, lp, lora=lora, tp=tp)
    x, _aux = _mlp_residual(cfg, x, layer_params, lp, tp=tp)
    return x, layer_pool


def _block_gpt_paged(cfg, x, lp, layer_pool, table, positions, slots=None):
    """GPT-2 block over paged KV: `_block_gpt` with the page write and
    the paged attention."""
    q, k, v = _gpt._attn_qkv(cfg, x, lp)
    attn, layer_pool = _write_pages_and_attend(
        q, k, v, layer_pool, table, positions, cfg.head_dim,
        attn_impl=cfg.attn_impl, slots=slots,
    )
    x = _gpt._attn_residual(cfg, x, attn, lp)
    return _gpt._mlp_residual(cfg, x, lp), layer_pool


def _forward_paged(cfg, params, tokens, pool, table, positions,
                   adapters=None, mesh=None):
    """tokens [B, S] -> logits [B, S, V] over the paged pool; the table
    is shared by every layer, and so is the optional `adapters`
    operand's idx. `mesh` (tp > 1): a per-shard pool. The family
    dispatch of `_forward_cached`."""
    _check_adapters(cfg, adapters)
    x = _embed(cfg, params, tokens, positions)
    slots = _page_slots(table, positions, kv_shards(pool)[0]["k"].shape[2])
    if _is_gpt(cfg):
        for layer in range(cfg.n_layers):
            x, _ = _block_gpt_paged(cfg, x, _layer_params(params, layer),
                                    _layer_cache(pool, layer), table,
                                    positions, slots=slots)
        return _logits(cfg, params, x), pool
    rope = _rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    for layer in range(cfg.n_layers):
        x, _ = _block_paged(
            cfg, x, _layer_params(params, layer), _layer_cache(pool, layer),
            table, positions, rope=rope, slots=slots,
            lora=_layer_lora(adapters, layer), mesh=mesh,
        )
    return _logits(cfg, params, x, serving_mesh_tp(mesh)), pool


def paged_decode_step(cfg, params, token, pool, table, pos, adapters=None,
                      mesh=None):
    """One cached step over paged KV -> (logits [B, V], pool); `pos` is
    the [B] per-slot position vector."""
    pos = torch.as_tensor(pos, dtype=torch.long, device=token.device)
    logits, pool = _forward_paged(
        cfg, params, token[:, None], pool, table, pos[:, None],
        adapters=adapters, mesh=mesh,
    )
    return logits[:, 0], pool


def paged_verify_step(cfg, params, tokens, pool, table, pos, adapters=None,
                      mesh=None):
    """The paged twin of `verify_step`: the K/V of tokens [B, S] goes
    straight into the rows' pages, and the queries attend through the
    gathered view (S > 1 never takes the paged-attention kernel). The
    engine sizes each request's page run for limit - 1 + draft_len
    cells, so the window lands in owned (or trash) pages."""
    return _forward_paged(cfg, params, tokens, pool, table,
                          _verify_positions(tokens, pos), adapters=adapters,
                          mesh=mesh)


def paged_install_row(pool: AnyCache, row_cache: AnyCache, table_row,
                      start: int, length: int) -> AnyCache:
    """Install cells [start, start+length) of an exact cache row into
    the pages `table_row` maps them to, in place — quantizing on the
    way in when the pool is int8 (per-vector scales make quantizing the
    slice equal to slicing the quantized whole, so the bytes match the
    dense bank's). The slice start clamps so the window fits the row,
    as the JAX package's dynamic_slice does. A sharded pool takes a
    sharded row, or a one-device row it cuts by head (`kv_split`)."""
    shards = kv_shards(pool)
    ps = shards[0]["k"].shape[2]
    rows = (kv_shards(row_cache) if isinstance(row_cache, list)
            else kv_split(row_cache, pool))
    m = rows[0]["k"].shape[2]
    dev = table_row.device
    positions = int(start) + torch.arange(length, device=dev)
    pids = table_row[positions // ps].long()
    offs = positions % ps
    st = min(max(int(start), 0), m - length)
    for sh, rsh in zip(shards, rows):
        src = {n: rsh[n][:, 0, st:st + length] for n in ("k", "v")}
        if "k_scale" in sh:
            kq, ks = _kv_quantize(src["k"])
            vq, vs = _kv_quantize(src["v"])
            src = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
        sdev = sh["k"].device
        for name, arr in sh.items():
            arr[:, pids.to(sdev), offs.to(sdev)] = src[name].to(arr.dtype)
    return pool


def paged_prefill_chunk(cfg, params, chunk, pool: AnyCache, table_row,
                        start: int, adapters=None, mesh=None) -> AnyCache:
    """Paged twin of `prefill_chunk_into_slot`: run `chunk` [C] at
    positions [start, start+C), scattering its K/V through `table_row`
    [P], the slot's REAL page ids (never the trash-routed table a decode
    dispatch sees: a mid-prefill slot rides the decode half as a done
    row). The engine allocates the slot's whole page run at admission,
    so every chunk position maps to an owned page. `adapters` carries
    the slot's 1-row idx."""
    positions = _chunk_positions(start, chunk.shape[0], chunk.device)
    _forward_paged(cfg, params, chunk[None], pool, table_row[None],
                   positions, adapters=adapters, mesh=mesh)
    return pool


def pool_copy_page(pool: AnyCache, src: int, dst: int) -> AnyCache:
    """Copy physical page `src` onto `dst` in every layer (and shard), in
    place: the device half of copy-on-write."""
    for sh in kv_shards(pool):
        for arr in sh.values():
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


def generate(
    cfg,
    params,
    prompt: torch.Tensor,
    max_new_tokens: int,
    temperature: float = 0.0,
    generator: Optional[torch.Generator] = None,
    max_len: Optional[int] = None,
    top_k: int = 0,
    top_p: float = 1.0,
    eos_id: Optional[int] = None,
    pad_id: int = 0,
    kv_quant: bool = False,
) -> torch.Tensor:
    """Greedy or temperature sampling over the KV cache: a prefill of
    `prompt` [B, P], then one `decode_step` a token. Returns [B, P +
    max_new_tokens] on the prompt's device.

    `top_k > 0` and / or `top_p < 1` filter the tempered distribution
    before each draw (temperature first, then the filters, HF / vLLM's
    order); greedy decoding (temperature <= 0) ignores them. `eos_id`
    stops each row at its first eos: the eos is emitted, every later
    position is `pad_id`, and the output keeps its static shape. Draws
    come from `generator` (default: a fresh one seeded 0 on the
    prompt's device) where JAX splits a key: greedy rows equal JAX's,
    sampled rows follow the same distribution with other draws."""
    b, p = prompt.shape
    m = max_len or (p + max_new_tokens)
    if m < p + max_new_tokens:
        raise ValueError(
            f"max_len {m} < prompt {p} + new {max_new_tokens}"
        )
    if not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    if top_k < 0:
        raise ValueError(f"top_k must be >= 0, got {top_k}")
    if eos_id is not None and eos_id == pad_id:
        raise ValueError(
            f"eos_id and pad_id must differ (both {eos_id}): the pad "
            "tail would re-trigger the done mask's eos detection"
        )
    _check_positional_capacity(cfg, p + max_new_tokens)
    if max_new_tokens == 0:
        return prompt
    dev = prompt.device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)

    def sample(logits):
        if temperature <= 0.0:
            return torch.argmax(logits, dim=-1).to(prompt.dtype)
        logits = logits.float() / temperature
        if 0 < top_k < logits.shape[-1]:
            logits = _mask_top_k(logits, top_k)
        if top_p < 1.0:
            logits = _mask_top_p(logits, top_p)
        return categorical(torch.softmax(logits, dim=-1),
                           generator).to(prompt.dtype)

    def emit(raw, done):
        """Finished rows emit pad; a fresh eos marks its row done after
        being emitted itself."""
        if eos_id is None:
            return raw, done
        tok = torch.where(done, torch.full_like(raw, pad_id), raw)
        return tok, done | (tok == eos_id)

    with torch.no_grad():
        cache = init_kv_cache(cfg, b, m, quant=kv_quant, device=dev)
        logits, cache = prefill(cfg, params, prompt, cache)
        tok, done = emit(sample(logits), torch.zeros(b, dtype=torch.bool,
                                                     device=dev))
        out = [tok]
        for t in range(max_new_tokens - 1):
            logits, cache = decode_step(cfg, params, tok, cache, p + t)
            tok, done = emit(sample(logits), done)
            out.append(tok)
    return torch.cat([prompt, torch.stack(out, dim=1)], dim=1)


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
