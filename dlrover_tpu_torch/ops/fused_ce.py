"""Chunked (fused) cross entropy over a large vocabulary — counterpart of
dlrover_tpu/ops/fused_ce.py.

As in the JAX package there is no kernel: the win is a schedule. The
sequence is cut into chunks so the [B, S, V] logits are never formed;
each chunk's logits are reduced to (logsumexp, target logit) in the
forward, and the backward recomputes them to form (softmax - onehot)
locally. The layout is the JAX one (`_layout`): `nc` chunks of `cs`
tokens plus a tail, so next-token lengths such as 2047 (7 x 292 + 3)
are covered.

Precision: the head products take the operands in their own dtype and
accumulate and return f32 (JAX `preferred_element_type=f32`); on the
card a bf16 pair is one cuBLAS product with an f32 output
(`torch.mm(..., out_dtype=float32)`), not an f32 GEMM of upcast
operands. `dx` is (softmax - onehot) cast to x's dtype times head^T, as
in JAX. `dhead` is x^T times the same cast (softmax - onehot) with an
f32 output, where JAX multiplies f32 copies of both: for f32 inputs the
two are the same; for bf16 inputs the port's dlogits are rounded to
bf16 (2^-9 relative) before that product.

The backward keeps the bf16 dlogits of every chunk ([B, S, V] in x's
dtype, half the bytes of the f32 logits the unfused loss holds) and
takes dx and dhead as one product each over all tokens, where JAX adds
per-chunk products in its scan: per-chunk products of 2 x 292 tokens
run well below the card's rate, and an f32 dhead accumulated chunk by
chunk reads and writes its 2.1 GB (Llama-3's head) once a chunk. The
sums are the same; their order differs.
"""

from typing import Optional, Tuple

import torch


def _chunk_count(s: int, target: int = 256) -> int:
    """Number of `target`-sized chunks covering `s` (the `s % target`
    tail is processed separately)."""
    return max(s // target, 1) if s > target else 1


def _layout(s: int, num_chunks: int) -> Tuple[int, int, int]:
    """(nc, cs, tail): `nc` chunks of `cs` tokens plus a `tail`-token
    remainder (JAX `_layout`)."""
    if num_chunks:
        cs = max(s // num_chunks, 1)
        nc = s // cs
    else:
        nc = _chunk_count(s)
        cs = s // nc
    return nc, cs, s - nc * cs


def _spans(s: int, num_chunks: int):
    nc, cs, tail = _layout(s, num_chunks)
    spans = [(i * cs, (i + 1) * cs) for i in range(nc)]
    if tail:
        spans.append((nc * cs, s))
    return spans


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, K] @ b [K, N] -> f32, accumulated in f32 from operands in
    their own dtype."""
    if a.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    # the CPU has no mixed-dtype product; f32 copies of bf16 values
    # multiply and accumulate exactly as the card's product does
    return a.float() @ b.float()


def _chunk_logits(x: torch.Tensor, head: torch.Tensor, lo: int, hi: int):
    """[B * (hi - lo), V] f32 logits of tokens [lo, hi) of every row."""
    xc = x[:, lo:hi].reshape(-1, x.shape[-1])
    return xc, _mm_f32(xc, head)


class _FusedCrossEntropy(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, head, targets, mask, num_chunks):
        b, s, _ = x.shape
        loss = torch.zeros((), dtype=torch.float32, device=x.device)
        weight = torch.zeros((), dtype=torch.float32, device=x.device)
        lse = torch.empty((b, s), dtype=torch.float32, device=x.device)
        for lo, hi in _spans(s, num_chunks):
            _, logits = _chunk_logits(x, head, lo, hi)
            lse_c = torch.logsumexp(logits, dim=-1)
            t = targets[:, lo:hi].reshape(-1, 1).long()
            nll = lse_c - logits.gather(1, t).squeeze(1)
            if mask is not None:
                m = mask[:, lo:hi].reshape(-1).float()
                loss += (nll * m).sum()
                weight += m.sum()
            else:
                loss += nll.sum()
                weight += float(nll.numel())
            lse[:, lo:hi] = lse_c.view(b, hi - lo)
            del logits
        ctx.save_for_backward(x, head, targets, mask, lse)
        ctx.num_chunks = num_chunks
        ctx.mark_non_differentiable(weight)
        return loss, weight

    @staticmethod
    def backward(ctx, g_loss, _g_weight):
        x, head, targets, mask, lse = ctx.saved_tensors
        b, s, d = x.shape
        g = g_loss.float()
        # (softmax - onehot) * mask * g of every chunk, in x's dtype: the
        # chunks' f32 logits live one at a time; dx and dhead are then
        # each one product over all tokens (dhead the sum over chunks)
        dl = torch.empty((b, s, head.shape[1]), dtype=x.dtype,
                         device=x.device)
        for lo, hi in _spans(s, ctx.num_chunks):
            _, logits = _chunk_logits(x, head, lo, hi)
            logits.sub_(lse[:, lo:hi].reshape(-1, 1)).exp_()
            t = targets[:, lo:hi].reshape(-1, 1).long()
            logits.scatter_add_(1, t, torch.full_like(t, -1.0,
                                                      dtype=logits.dtype))
            if mask is not None:
                logits.mul_(mask[:, lo:hi].reshape(-1, 1).float())
            torch.mul(logits.view(b, hi - lo, -1), g, out=dl[:, lo:hi])
            del logits
        dl = dl.view(b * s, -1)
        xf = x.reshape(b * s, d)
        dx = _mm_f32(dl, head.T).to(x.dtype).view(b, s, d)
        dhead = _mm_f32(xf.T, dl)
        del dl
        return dx, dhead.to(head.dtype), None, None, None


def fused_cross_entropy(
    x: torch.Tensor,        # [B, S, D] final hidden states (pre-head)
    head: torch.Tensor,     # [D, V]
    targets: torch.Tensor,  # [B, S] int
    mask: Optional[torch.Tensor] = None,  # [B, S] float, or None
    num_chunks: int = 0,    # 0 = auto
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of the masked token NLLs, sum of the mask weights), both f32
    scalars; callers divide for the mean (mask None means all ones).
    Differentiable in `x` and `head` only: no gradient flows to
    `targets`, `mask` or the weight."""
    if x.dtype != head.dtype:
        raise ValueError(f"x is {x.dtype}, head is {head.dtype}")
    return _FusedCrossEntropy.apply(x, head, targets, mask, num_chunks)
