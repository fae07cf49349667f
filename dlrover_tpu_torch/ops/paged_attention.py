"""Paged-attention decode: a CUDA kernel for Hopper
(csrc/paged_attention.cu) and the dense-bank reference.

Counterpart of dlrover_tpu/ops/paged_attention.py. The serving
engine's paged KV layout stores K/V in a global page pool
`[n_pages, page_size, KV, hd]` per layer; each batch row owns a page
TABLE `[P]` of physical page ids covering logical positions
[i*page_size, (i+1)*page_size).

- `paged_attention(..., impl="reference")`: gather the pages into a
  dense [B, M, KV, hd] view and run EXACTLY the grouped-einsum masked
  softmax of models/decode.py's `_cached_attention` (same shapes, same
  ops). This is what makes the paged engine byte-identical to the
  dense bank on the CPU. It is also the kernel's plain version.
- `impl="kernel"`: the CUDA kernel for CUDA tensors (never
  materializes the dense view; int8 pools dequantize in the kernel),
  the reference for CPU tensors. Two kernels, chosen by shape
  (`kernel_variant`): the TMA-ring kernel (one launch over even shares
  of the live pages; counted under "paged_attention" and
  "paged_attention_tma") for bf16 queries, pages of 16 cells, head_dim
  64 or 128, GQA groups of 1, 2, 4 or 8, and the split kernel with its
  log-sum-exp combine for the rest (f32 queries, other pages, head dims
  and groups: every shape JAX's gate takes).
- `impl="auto"`: the kernel where the JAX package takes its kernel
  (`takes_kernel`: CUDA tensors within JAX's gate), else the reference.
"""

import ctypes
from typing import Dict, Optional

import torch

from dlrover_tpu_torch.ops import _build
from dlrover_tpu_torch.ops import flash_attention as fa

_NAME = "paged_attention"
_NAME_TMA = "paged_attention_tma"
_NAME_TMA_INT8 = "paged_attention_tma_int8"   # the int8-pool variant
_CHUNK = 32                # cells per warp step in the kernel (a lane each)
# 128 cells per block split: one chunk for each of the kernel's 4 warps
_CHUNKS_PER_SPLIT = 4
# the TMA-ring kernel: pages of 16 cells (a box of 16 rows, one k16
# step), head dims 64 and 128, GQA groups of 1, 2, 4 or 8, at most 1024
# rows (it scans their page counts in shared memory) and 32 KV heads for
# int8 pages (one bulk copy of a page's scales); two blocks an SM, the
# grid fixed by the table's capacity (B x KV x table pages), not by the
# lengths
_TMA_PAGE = 16
_TMA_HEAD_DIMS = (64, 128)
_TMA_REPS = (1, 2, 4, 8)
_TMA_MAX_ROWS = 1024
_TMA_MAX_KV_INT8 = 32
_TMA_BLOCKS_PER_SM = 2
_TMA_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 10
                 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_int,
                                         ctypes.c_void_p])


def supports(q, pages: Dict, table, tp: int = 1) -> bool:
    """Whether the kernels take these shapes: the JAX package's gate.
    `q` is the [B, H, hd] single-token query, `pages` the per-layer pool
    dict, `table` the [B, P] page table. The head_dim / GQA gate is
    flash's (head_dim a multiple of 8 in [32, 512], whole groups), pages
    hold at least 8 cells, and the table has a row per query. `tp` > 1
    judges the per-shard head counts of the GLOBAL shapes, what each
    shard's kernel sees (JAX `supports(..., tp=)` :55)."""
    return _gate(tuple(q.shape), tuple(pages["k"].shape),
                 tuple(table.shape), tp)


def _gate(q_shape, pages_shape, table_shape, tp: int) -> bool:
    b, h, d = q_shape
    _, page_size, kv, _ = pages_shape
    shard = fa.per_shard_heads(h, kv, tp)
    if shard is None:
        return False
    return (fa.heads_ok(shard[0], shard[1], d) and page_size >= 8
            and len(table_shape) == 2 and table_shape[0] == b)


def takes_kernel(q_shape, pages_shape, table_shape, device,
                 tp: int = 1) -> bool:
    """impl="auto"'s choice on shapes: the JAX package's `use_kernel`
    (its `supports` on the device, per shard at tp > 1). The kernel for
    a query on the card with head_dim a multiple of 8 in [32, 512],
    whole GQA groups, pages of at least 8 cells and a [B, P] table; the
    reference elsewhere, as JAX serves those shapes through its
    reference. On the card this equals `supports`: the kernels take
    every shape inside the gate."""
    if torch.device(device).type != "cuda":
        return False
    return _gate(tuple(q_shape), tuple(pages_shape), tuple(table_shape), tp)


def use_kernel(q, pages: Dict, table, tp: int = 1) -> bool:
    """`takes_kernel` on the operands: the engine's dispatch (JAX :89).
    On the CPU the reference, the byte-parity formulation that keeps
    the CPU parity tests exact. `q` / `pages` may be per-shard lists
    (their global shapes are judged)."""
    return takes_kernel(_global_q_shape(q), _global_pages_shape(pages),
                        tuple(table.shape), _first(q).device, tp)


def _first(x):
    return x[0] if isinstance(x, (list, tuple)) else x


def _global_q_shape(q):
    if not isinstance(q, (list, tuple)):
        return tuple(q.shape)
    b, _, d = q[0].shape
    return (b, sum(p.shape[1] for p in q), d)


def _global_pages_shape(pages):
    if not isinstance(pages, (list, tuple)):
        return tuple(pages["k"].shape)
    n, ps, _, d = pages[0]["k"].shape
    return (n, ps, sum(p["k"].shape[2] for p in pages), d)


def gather_pages(pages: Dict, table) -> Dict:
    """Materialize the dense [B, M, KV, ...] view of each row's pages
    (M = P * page_size). A pure read; rows pointing at the trash page
    (or stale pages) surface values the position mask hides."""
    out = {}
    for name, arr in pages.items():
        g = arr[table]  # [B, P, page_size, KV, ...]
        out[name] = g.reshape((g.shape[0], -1) + tuple(g.shape[3:]))
    return out


def _reference(q, pages, table, lengths, scale):
    """The dense-bank formulation on the gathered view — kept op for op
    identical to models/decode.py::_cached_attention. q: [B, H, hd],
    one decode query per row at position lengths-1."""
    view = gather_pages(pages, table)
    k_cache, v_cache = view["k"], view["v"]
    if "k_scale" in view:
        k_cache = k_cache.to(q.dtype) * view["k_scale"].to(q.dtype)
        v_cache = v_cache.to(q.dtype) * view["v_scale"].to(q.dtype)
    b, h, hd = q.shape
    m = k_cache.shape[1]
    kv = k_cache.shape[2]
    n_rep = h // kv
    qg = q.reshape(b, 1, kv, n_rep, hd)
    scores = torch.einsum(
        "bskrd,bmkd->bkrsm", qg.float(), k_cache.float()
    ) * scale
    cols = torch.arange(m, device=q.device)[None, None, None, None, :]
    rows = (lengths - 1)[:, None, None, None, None]
    scores = torch.where(cols <= rows, scores, float("-inf"))
    p = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkrsm,bmkd->bskrd", p, v_cache)
    return out.reshape(b, h, hd)


def kernel_variant(q_dtype, page_size: int, kv: int, hd: int, b: int,
                   quant: bool, n_table: int = 1,
                   sms: int = _build.H100_SMS, n_rep: int = 1) -> str:
    """Which CUDA kernel takes a decode step of these shapes: "tma" (the
    TMA-ring kernel) for bf16 queries over pages of 16 cells at head_dim
    64 or 128 and GQA groups (`n_rep`) of 1, 2, 4 or 8 (at most 1024
    rows; int8 pages at most 32 KV heads; the table's capacity times the
    grid within the kernel's 32-bit share arithmetic), else "split" (the
    split kernel and its combine)."""
    if (q_dtype == torch.bfloat16 and page_size == _TMA_PAGE
            and hd in _TMA_HEAD_DIMS and n_rep in _TMA_REPS
            and b <= _TMA_MAX_ROWS
            and (not quant or kv <= _TMA_MAX_KV_INT8)
            and b * kv * n_table * (tma_grid(b, kv, n_table, sms) + 1)
            < 2 ** 32):
        return "tma"
    return "split"


def tma_grid(b: int, kv: int, n_table: int, sms: int) -> int:
    """The TMA-ring kernel's grid: two blocks an SM, or one block per
    page the table can hold where that is fewer; fixed by capacity."""
    return max(1, min(_TMA_BLOCKS_PER_SM * sms, b * kv * n_table))


def _kernel(q, pages, table, lengths, scale, variant: str = "auto",
            shard=None):
    """q [B, H, hd] -> [B, H, hd]: the CUDA kernel for CUDA tensors (the
    one `kernel_variant` picks; variant="split" asks for the split kernel
    where it would pick the TMA-ring one, to time the two on the same
    inputs), its plain version (`_reference`) for CPU tensors.

    `shard` = (kv_all, g0): q and `pages` are one head shard (KV heads
    [g0, g0 + KV) of a slice of kv_all). The kernel is chosen as for the
    whole slice, and the TMA-ring one runs with the whole slice's work
    partition (its grid and unit sequence, taking only this shard's
    units), so the output is the unsharded launch's head slice bit for
    bit; the split kernel works a head at a time anyway."""
    if not q.is_cuda:
        return _reference(q, pages, table, lengths, scale)
    if variant not in ("auto", "split"):
        raise ValueError(f"unknown paged kernel variant {variant!r}")
    quant = "k_scale" in pages
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"paged kernel takes f32/bf16 q, got {q.dtype}")
    page_dtype = torch.int8 if quant else q.dtype
    tensors = {"q": q, "k": pages["k"], "v": pages["v"],
               "table": table, "lengths": lengths}
    if quant:
        tensors["k_scale"] = pages["k_scale"]
        tensors["v_scale"] = pages["v_scale"]
    want = {"q": q.dtype, "k": page_dtype, "v": page_dtype,
            "table": torch.int32, "lengths": torch.int32,
            "k_scale": torch.bfloat16, "v_scale": torch.bfloat16}
    for name, t in tensors.items():
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} must be on q's CUDA device")
        if t.dtype != want[name]:
            raise ValueError(
                f"paged kernel: {name}.dtype={t.dtype}, want {want[name]}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    b, h, hd = q.shape
    n_pages, page_size, kv, khd = pages["k"].shape
    if pages["v"].shape != pages["k"].shape or khd != hd:
        raise ValueError("k/v pages must be [n_pages, page_size, KV, hd]")
    if quant and pages["k_scale"].shape != (n_pages, page_size, kv, 1):
        raise ValueError("int8 pages need [n_pages, page_size, KV, 1] scales")
    if not supports(q, pages, table):
        raise ValueError(
            f"paged kernel does not take q{tuple(q.shape)} "
            f"pages{tuple(pages['k'].shape)} table{tuple(table.shape)}"
        )
    if lengths.shape != (b,):
        raise ValueError(f"lengths must be [{b}], got {tuple(lengths.shape)}")
    kv_all, g0 = shard or (kv, 0)
    if not 0 <= g0 <= kv_all - kv:
        raise ValueError(f"shard heads [{g0}, {g0 + kv}) outside {kv_all}")
    if (variant == "auto" and kernel_variant(
            q.dtype, page_size, kv_all, hd, b, quant, table.shape[1],
            _build.sm_count(q.get_device()), h // kv) == "tma"):
        return _kernel_tma(q, pages, table, lengths, scale, quant,
                           kv_all, g0)
    # the split over blocks covers a row's table capacity (lengths stay
    # on the device); splits past a row's length exit at once
    max_chunks = -(-table.shape[1] * page_size // _CHUNK)
    splits = max(1, -(-max_chunks // _CHUNKS_PER_SPLIT))
    out = torch.empty_like(q)
    part_ml = torch.empty((b, h, splits, 2), dtype=torch.float32,
                          device=q.device)
    part_acc = torch.empty((b, h, splits, hd), dtype=torch.float32,
                           device=q.device)
    null = ctypes.c_void_p(0)
    fn = _build.function(
        _NAME, "paged_attention_launch",
        [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 10
        + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p],
    )
    err = fn(
        0 if q.dtype == torch.float32 else 1, int(quant),
        q.data_ptr(), pages["k"].data_ptr(), pages["v"].data_ptr(),
        pages["k_scale"].data_ptr() if quant else null,
        pages["v_scale"].data_ptr() if quant else null,
        table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        part_ml.data_ptr(), part_acc.data_ptr(),
        b, table.shape[1], page_size, kv, h // kv, hd, splits,
        _CHUNKS_PER_SPLIT, float(scale),
        _build.current_stream(q.get_device()),
    )
    _build.count_launch(_NAME)
    _build.check(err, _NAME, f"q{tuple(q.shape)} pages{tuple(pages['k'].shape)}")
    return out


def _kernel_tma(q, pages, table, lengths, scale, quant, kv_all=None, g0=0):
    """The TMA-ring kernel on checked tensors (see `_kernel`); `kv_all`
    / `g0` place a head shard in its slice (default: unsharded)."""
    b, h, hd = q.shape
    n_pages, _, kv, _ = pages["k"].shape
    names = ("k", "v", "k_scale", "v_scale") if quant else ("k", "v")
    for name in ("q",) + names:
        t = q if name == "q" else pages[name]
        if t.data_ptr() % 16:
            raise ValueError(f"paged TMA kernel: {name} must be 16-byte "
                             "aligned")
    dev = q.get_device()
    kv_all = kv if kv_all is None else kv_all
    grid = tma_grid(b, kv_all, table.shape[1], _build.sm_count(dev))
    out = torch.empty_like(q)
    part = torch.empty((2 * grid, (h // kv) * hd + 16), dtype=torch.float32,
                       device=q.device)
    counters = _build.zeroed_counters(dev, b * kv)
    null = ctypes.c_void_p(0)
    fn = _build.function(_NAME, "paged_attention_tma_launch", _TMA_ARGTYPES)
    err = fn(
        int(quant), q.data_ptr(), pages["k"].data_ptr(),
        pages["v"].data_ptr(),
        pages["k_scale"].data_ptr() if quant else null,
        pages["v_scale"].data_ptr() if quant else null,
        table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        part.data_ptr(), counters.data_ptr(),
        b, table.shape[1], n_pages, kv, kv_all, g0, h // kv, hd,
        float(scale), grid, _build.current_stream(dev),
    )
    _build.count_launch(_NAME)
    _build.count_launch(_NAME_TMA)
    if quant:
        _build.count_launch(_NAME_TMA_INT8)
    _build.check(err, _NAME_TMA,
                 f"q{tuple(q.shape)} pages{tuple(pages['k'].shape)}")
    return out


def _sharded_kernel(q, pages, table, lengths, scale, mesh):
    """`_kernel` over a serving mesh's "tp" head split (JAX :287,
    shard_mapped there): shard i runs the unchanged kernel on its query
    heads and its KV-head slice of the pool, on its device; the page
    table and lengths are host-planned and read whole by every shard
    (held once per device). No collective. q is a per-shard list of
    [B, H/tp, hd] (or the global [B, H, hd], split here) and `pages` a
    per-shard list of pool dicts (or the global dict, split on its KV
    axis); returns the per-shard outputs. On one card the shards launch
    one after another on its stream."""
    q, pages = _shard_inputs(q, pages, mesh)
    tables = mesh.broadcast(table)
    lens = mesh.broadcast(lengths)
    kv_all = sum(pi["k"].shape[2] for pi in pages)
    out, g0 = [], 0
    for qi, pi, ti, li in zip(q, pages, tables, lens):
        out.append(_kernel(qi, pi, ti, li, scale, shard=(kv_all, g0)))
        g0 += pi["k"].shape[2]
    return out


def _shard_inputs(q, pages, mesh):
    """q and the pool as per-shard lists (`serving_head_specs`: q's
    heads at dim 1, the pool's KV heads at dim 2)."""
    from dlrover_tpu_torch.parallel.mesh import serving_head_specs

    specs = serving_head_specs(mesh)
    return (mesh.shards(q, specs["q1"].split_dim()),
            mesh.split_pool(pages, specs["pool"].split_dim()))


def paged_attention(
    q,                         # [B, H, hd] — one decode query per row
    pages,                     # the layer's pool dict
    table: torch.Tensor,       # [B, P] physical page ids
    lengths: torch.Tensor,     # [B] valid cells per row (query at len-1)
    scale: Optional[float] = None,
    impl: str = "auto",
    mesh=None,
):
    """Single-query attention over paged KV. impl: "reference" (the
    dense-bank formulation over a gathered view), "kernel" (the CUDA
    kernels; their plain version on CPU tensors; raises on CUDA tensors
    outside JAX's gate, `supports`), or "auto" (kernel when
    `use_kernel` passes, else reference).

    `mesh` (a serving mesh of tp > 1) runs it per head shard: the
    kernel path through `_sharded_kernel`, the reference per shard.
    `q` / `pages` are then per-shard lists (a list comes back) or the
    global query and pool (the output comes back gathered)."""
    tp = 1 if mesh is None else mesh.tp
    if tp > 1:
        return _paged_sharded(q, pages, table, lengths, scale, impl, mesh)
    if scale is None:
        scale = float(q.shape[-1]) ** -0.5
    # the kernels read a dense [B, H, hd] query; a fused qkv product's q
    # (GPT-2) is a strided view of it
    q = q.contiguous()
    if impl == "reference":
        return _reference(q, pages, table, lengths, scale)
    if impl == "kernel":
        return _kernel(q, pages, table, lengths, scale)
    if impl != "auto":
        raise ValueError(f"unknown impl {impl!r}")
    if use_kernel(q, pages, table):
        return _kernel(q, pages, table, lengths, scale)
    return _reference(q, pages, table, lengths, scale)


def _paged_sharded(q, pages, table, lengths, scale, impl, mesh):
    if impl not in ("auto", "kernel", "reference"):
        raise ValueError(f"unknown impl {impl!r}")
    was_global = not isinstance(q, (list, tuple))
    if scale is None:
        scale = float(_first(q).shape[-1]) ** -0.5
    q, pages = _shard_inputs(q, pages, mesh)
    if impl == "kernel" or (
            impl == "auto" and use_kernel(q, pages, table, tp=mesh.tp)):
        out = _sharded_kernel(q, pages, table, lengths, scale, mesh)
    else:
        tables, lens = mesh.broadcast(table), mesh.broadcast(lengths)
        out = [_reference(qi, pi, ti, li, scale)
               for qi, pi, ti, li in zip(q, pages, tables, lens)]
    return mesh.gather(out, 1) if was_global else out
