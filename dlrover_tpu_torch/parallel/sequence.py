"""Sequence parallelism: Ulysses all-to-all and ring attention —
counterpart of dlrover_tpu/parallel/sequence.py.

JAX runs both inside one `shard_map` over the mesh's "seq" axis on
global arrays. The port runs one process a card: each rank of the seq
group holds its contiguous chunk of the sequence ([B, S/sp, H, D]) and
the functions here take those chunks and the seq group.

- Ulysses (`ulysses_attention`): a differentiable all-to-all turns the
  sequence-sharded [B, S/sp, H, D] into head-sharded [B, S, H/sp, D],
  the attention runs on H/sp heads at the full sequence
  (`ops/attention.dot_product_attention`, which takes the flash kernels
  on the card), and the inverse all-to-all brings the chunk back. The
  backward of each all-to-all is the other one.
- Ring (`ring_attention`): K/V chunks rotate around the seq group
  (`runtime.ring_shift`, one `batch_isend_irecv` a step), folded into an
  f32 online softmax with causal masking in global coordinates, the
  arithmetic of JAX's ring. JAX derives the backward by autodiff
  through its scan; here an autograd Function runs a second ring that
  computes dQ locally and carries each chunk's dK / dV around with it
  until they come home. JAX's ring is XLA with no Pallas kernel, so
  this one is plain PyTorch.
"""

from typing import Callable, Optional

import torch

from dlrover_tpu_torch import runtime

NEG_INF = -1e30


def _axis_size(group) -> int:
    """The seq group's size (1 without a group)."""
    if group is None:
        return 1
    import torch.distributed as dist

    return dist.get_world_size(group)


def _axis_index(group) -> int:
    if group is None:
        return 0
    import torch.distributed as dist

    return dist.get_rank(group)


# ---------------------------------------------------------------------------
# Ulysses: scatter heads, gather sequence
# ---------------------------------------------------------------------------


def _h2s(x: torch.Tensor, group) -> torch.Tensor:
    """[B, S/sp, H, D] -> [B, S, H/sp, D]: head chunk j to rank j, the
    received sequence chunks concatenated in rank order."""
    sp = _axis_size(group)
    b, n, h, d = x.shape
    parts = x.reshape(b, n, sp, h // sp, d).permute(2, 0, 1, 3, 4)
    y = runtime.all_to_all_dim0(parts, group)   # [sp, B, n, H/sp, D]
    return y.permute(1, 0, 2, 3, 4).reshape(b, sp * n, h // sp, d)


def _s2h(x: torch.Tensor, group) -> torch.Tensor:
    """[B, S, H/sp, D] -> [B, S/sp, H, D]: sequence chunk j to rank j,
    the received head chunks concatenated in rank order."""
    sp = _axis_size(group)
    b, s, h, d = x.shape
    parts = x.reshape(b, sp, s // sp, h, d).permute(1, 0, 2, 3, 4)
    y = runtime.all_to_all_dim0(parts, group)   # [sp, B, S/sp, H/sp, D]
    return y.permute(1, 2, 0, 3, 4).reshape(b, s // sp, sp * h, d)


class _HeadsToSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _h2s(x, group)

    @staticmethod
    def backward(ctx, g):
        return _s2h(g, ctx.group), None


class _SeqToHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _s2h(x, group)

    @staticmethod
    def backward(ctx, g):
        return _h2s(g, ctx.group), None


def _heads_to_seq(x: torch.Tensor, group) -> torch.Tensor:
    """[B, S/sp, H, D] -> [B, S, H/sp, D] (one all-to-all)."""
    return _HeadsToSeq.apply(x, group)


def _seq_to_heads(x: torch.Tensor, group) -> torch.Tensor:
    """[B, S, H/sp, D] -> [B, S/sp, H, D] (the inverse all-to-all)."""
    return _SeqToHeads.apply(x, group)


def _kv_repeat_local(kv: torch.Tensor, n_rep: int) -> torch.Tensor:
    """KV heads [B, S, KV, D] -> [B, S, KV * n_rep, D], each head
    repeated in place (autograd sums the group's gradient back onto the
    shared head)."""
    if n_rep == 1:
        return kv
    b, s, h, d = kv.shape
    return kv[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)


def ulysses_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    group,
    attn_fn: Callable[..., torch.Tensor],
    causal: bool = True,
) -> torch.Tensor:
    """Ulysses attention on this rank's [B, S/sp, H, D] chunks: the
    all-to-all makes them head-sharded, `attn_fn` attends over the full
    sequence on H/sp heads, and the inverse all-to-all returns this
    rank's chunk. Needs H % sp == 0; KV heads that do not split over sp
    are repeated first (GQA with fewer KV heads than the seq degree)."""
    sp = _axis_size(group)
    h = q.shape[2]
    if h % sp:
        raise ValueError(f"ulysses needs n_heads % sp == 0 ({h} % {sp})")
    kv_h = k.shape[2]
    if kv_h % sp:
        rep = (h // kv_h) if h % kv_h == 0 else 1
        k = _kv_repeat_local(k, rep)
        v = _kv_repeat_local(v, rep)
        if k.shape[2] % sp:
            raise ValueError(
                f"ulysses: kv_heads {kv_h} not alignable to sp={sp}")
    q = _heads_to_seq(q, group)
    k = _heads_to_seq(k, group)
    v = _heads_to_seq(v, group)
    o = attn_fn(q, k, v, causal=causal)
    return _seq_to_heads(o, group)


# ---------------------------------------------------------------------------
# Ring attention: rotate KV chunks, blockwise online softmax
# ---------------------------------------------------------------------------


def _scores(qt, kb, scale, causal, rows, src):
    """f32 scores [B, H, Sq, Sk] of this rank's queries against the
    chunk held (global chunk `src`), masked in global coordinates."""
    s = torch.matmul(qt, kb.transpose(-1, -2)) * scale
    if causal:
        s_k = kb.shape[2]
        cols = src * s_k + torch.arange(s_k, device=s.device)
        s = s.masked_fill(rows[:, None] < cols[None, :], NEG_INF)
    return s


class _Ring(torch.autograd.Function):
    """Ring attention over `group` on [B, H, Sq, D] f32 operands (K/V
    with H heads already). Forward: JAX's online softmax, the chunk
    passed on after each fold. Backward: the FlashAttention-2 gradient
    from the saved log-sum-exp, K/V and their dK/dV accumulators
    rotating together, so after sp hops each chunk's dK/dV is home."""

    @staticmethod
    def forward(ctx, qt, kt, vt, group, causal, scale):
        sp, my = _axis_size(group), _axis_index(group)
        b, h, s_q, d = qt.shape
        rows = my * s_q + torch.arange(s_q, device=qt.device)
        m = torch.full((b, h, s_q, 1), NEG_INF, device=qt.device)
        l = torch.zeros((b, h, s_q, 1), device=qt.device)
        acc = torch.zeros((b, h, s_q, d), device=qt.device)
        kb, vb = kt, vt
        for t in range(sp):
            src = (my - t) % sp
            s = _scores(qt, kb, scale, causal, rows, src)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            # exactly 0 on masked entries: a fully masked chunk adds
            # nothing
            p = torch.where(s <= NEG_INF / 2, torch.zeros_like(s),
                            torch.exp(s - m_new))
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(-1, keepdim=True)
            acc = acc * alpha + torch.matmul(p, vb)
            m = m_new
            if t + 1 < sp:
                kb, vb = runtime.ring_shift([kb, vb], group)
        l = torch.where(l == 0.0, torch.ones_like(l), l)
        o = acc / l
        ctx.save_for_backward(qt, kt, vt, o, m + torch.log(l))
        ctx.group, ctx.causal, ctx.scale = group, causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        qt, kt, vt, o, lse = ctx.saved_tensors
        group, causal, scale = ctx.group, ctx.causal, ctx.scale
        sp, my = _axis_size(group), _axis_index(group)
        s_q = qt.shape[2]
        rows = my * s_q + torch.arange(s_q, device=qt.device)
        do = do.float()
        delta = (do * o).sum(-1, keepdim=True)
        dq = torch.zeros_like(qt)
        kb, vb = kt, vt
        dk, dv = torch.zeros_like(kt), torch.zeros_like(vt)
        for t in range(sp):
            src = (my - t) % sp
            s = _scores(qt, kb, scale, causal, rows, src)
            p = torch.where(s <= NEG_INF / 2, torch.zeros_like(s),
                            torch.exp(s - lse))
            dv = dv + torch.matmul(p.transpose(-1, -2), do)
            ds = p * (torch.matmul(do, vb.transpose(-1, -2)) - delta)
            dq = dq + torch.matmul(ds, kb) * scale
            dk = dk + torch.matmul(ds.transpose(-1, -2), qt) * scale
            if sp > 1:
                if t + 1 < sp:
                    kb, vb, dk, dv = runtime.ring_shift([kb, vb, dk, dv],
                                                        group)
                else:
                    dk, dv = runtime.ring_shift([dk, dv], group)
        return dq, dk, dv, None, None, None


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    group,
    causal: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Ring attention on this rank's [B, S/sp, H, D] chunks over the seq
    group: GQA (H % KV == 0) by repeating K/V heads, causal masking in
    global coordinates, f32 arithmetic, the output in q's dtype."""
    if scale is None:
        scale = float(q.shape[-1]) ** -0.5
    n_rep = q.shape[2] // k.shape[2]
    k = _kv_repeat_local(k, n_rep)
    v = _kv_repeat_local(v, n_rep)
    o = _Ring.apply(q.transpose(1, 2).float(), k.transpose(1, 2).float(),
                    v.transpose(1, 2).float(), group, causal, scale)
    return o.to(q.dtype).transpose(1, 2)


# ---------------------------------------------------------------------------
# mesh-level entry point
# ---------------------------------------------------------------------------


def sp_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh=None,
    mode: str = "ring",
    causal: bool = True,
    attn_fn: Optional[Callable] = None,
    seq_axis: str = "seq",
) -> torch.Tensor:
    """Sequence-parallel attention over `mesh`'s seq axis (a
    `TrainMesh`; default: the running train step's). q/k/v are this
    rank's [B, S/sp, H, D] chunks (JAX's are the global arrays that its
    shard_map cuts into these), and so is the output. `attn_fn` (Ulysses'
    local attention) defaults to `ops/attention.dot_product_attention`."""
    from dlrover_tpu_torch.parallel.sharding import active_scope

    if mode not in ("ring", "ulysses"):
        raise ValueError(f"unknown sp mode: {mode}")
    scope = active_scope()
    if mesh is None:
        if scope is None or scope.mesh is None:
            raise ValueError("sp_attention needs a mesh: none given and no "
                             "train step is running")
        mesh = scope.mesh
    if scope is not None:
        scope.seq_used = True
    group = mesh.group(seq_axis)
    if attn_fn is None:
        from dlrover_tpu_torch.ops.attention import dot_product_attention

        attn_fn = dot_product_attention
    if mode == "ulysses":
        return ulysses_attention(q, k, v, group, attn_fn, causal=causal)
    return ring_attention(q, k, v, group, causal=causal)


def seq_chunk_positions(s_local: int, mesh=None,
                        device=None) -> torch.Tensor:
    """The GLOBAL positions [S/sp] of this rank's chunk (RoPE must see
    them under sequence sharding): chunk `seq index` of the sequence.
    JAX's returns arange(S) of the global array, which its shard_map
    cuts into these."""
    idx = 0 if mesh is None else mesh.index("seq")
    return torch.arange(idx * s_local, (idx + 1) * s_local, device=device)
