"""Flash attention forward: a CUDA kernel for Hopper (csrc/flash_fwd.cu)
and its plain PyTorch version.

Counterpart of the forward half of dlrover_tpu/ops/flash_attention.py
(`_fwd_kernel` launched by `_fwd`, and `flash_attention`). What the
TPU version needed and this one drops: the VMEM-sized `auto_blocks`
(the kernel tiles 64 x 64 and masks the ragged tail, so any sequence
length runs) and the 8-lane LSE pad (LSE is a plain [B, H, S] f32).
GQA runs inside the kernel by reading KV head h // n_rep; K/V are never
repeated. The backward kernels come with the training slice.

Layout contract: public API takes [batch, seq, heads, head_dim].
"""

import ctypes
from typing import Optional, Tuple

import torch

from dlrover_tpu_torch.ops import _build
from dlrover_tpu_torch.ops.attention import _kv_repeat

_NAME = "flash_fwd"


def heads_ok(h: int, kv: int, d: int) -> bool:
    """The head gate the flash and paged kernels share: head_dim a
    multiple of 8 in [32, 256] and whole GQA groups."""
    return d % 8 == 0 and 32 <= d <= 256 and h % kv == 0


def supports(q, k, segment_ids=None) -> bool:
    """Whether the kernel handles these shapes: the head gate, and
    either equal q/k lengths or the single-query (q_len == 1) decode
    shape."""
    if segment_ids is not None:
        return False
    s_q, s_k = q.shape[1], k.shape[1]
    if s_q != s_k and s_q != 1:
        return False
    return heads_ok(q.shape[2], k.shape[2], q.shape[3])


def _fwd_plain(q, k, v, causal: bool, scale: float):
    """The kernel's function in plain PyTorch: softmax in f32, P cast to
    V's dtype before the PV product (as the kernel feeds its tensor
    cores), top-left causal mask. Returns (o [B,S,H,D], lse [B,H,S])."""
    n_rep = q.shape[2] // k.shape[2]
    k = _kv_repeat(k, n_rep)
    v = _kv_repeat(v, n_rep)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        s_q, s_k = s.shape[-2], s.shape[-1]
        rows = torch.arange(s_q, device=s.device)[:, None]
        cols = torch.arange(s_k, device=s.device)[None, :]
        s = torch.where(rows >= cols, s, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    l = torch.where(l == 0.0, 1.0, l)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    o = o / l.permute(0, 2, 1, 3)
    lse = (m + torch.log(l)).squeeze(-1)
    return o.to(q.dtype), lse


def _fwd_cuda(q, k, v, causal: bool, scale: float):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} must be on q's CUDA device")
        if t.dtype != torch.bfloat16:
            raise ValueError(
                f"flash kernel takes bfloat16, got {name}.dtype={t.dtype}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    b, s_q, h, d = q.shape
    s_k, kvh = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k{tuple(k.shape)} / v{tuple(v.shape)} do not "
                         f"match q{tuple(q.shape)}")
    if causal and s_q != s_k:
        raise ValueError("causal flash needs q_len == k_len")
    if not supports(q, k):
        raise ValueError(
            f"flash kernel does not take q{tuple(q.shape)} k{tuple(k.shape)}"
        )
    o = torch.empty_like(q)
    lse = torch.empty((b, h, s_q), dtype=torch.float32, device=q.device)
    fn = _build.function(_NAME, "flash_fwd_bf16", [ctypes.c_void_p] * 5 + [
        ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), b, s_q, s_k, h, kvh, d, float(scale),
        int(causal), _build.current_stream(q.get_device()),
    )
    _build.count_launch(_NAME)
    _build.check(err, _NAME, f"q{tuple(q.shape)} k{tuple(k.shape)}")
    return o, lse


def _fwd(q, k, v, causal: bool, scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse): the kernel for CUDA tensors, its plain version for CPU
    tensors. LSE [B, H, S] f32 is what the backward slice will read."""
    if q.is_cuda:
        return _fwd_cuda(q, k, v, causal, scale)
    return _fwd_plain(q, k, v, causal, scale)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Flash attention on [B, S, H, D] tensors; returns [B, S, H, D]."""
    if causal and q.shape[1] != k.shape[1]:
        if q.shape[1] == 1:
            # single-query decode: the query sits at the bottom-right
            # row of the (1, s_k) score matrix, where the causal mask
            # keeps every column — run unmasked (identical math)
            causal = False
        else:
            raise ValueError(
                "flash_attention causal masking requires equal q/k "
                f"lengths (got {q.shape[1]} vs {k.shape[1]}) unless "
                "q_len == 1 (decode); use the reference path"
            )
    if not supports(q, k):
        raise ValueError(
            f"flash attention does not take q{tuple(q.shape)} "
            f"k{tuple(k.shape)}; use the reference path"
        )
    if scale is None:
        scale = float(q.shape[-1]) ** -0.5
    return _fwd(q, k, v, causal, scale)[0]
