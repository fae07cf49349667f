"""Flash attention: CUDA kernels for Hopper (csrc/flash_fwd.cu, the
forward, and csrc/flash_bwd.cu, the dQ and dK/dV backward, each in a
wgmma variant and an mma.sync one that `_fwd_variant` / `_bwd_variant`
pick by shape) and their plain PyTorch versions, joined by a
`torch.autograd.Function`.

Counterpart of dlrover_tpu/ops/flash_attention.py (`_fwd_kernel`
launched by `_fwd`, `_bwd_dq_kernel` and `_bwd_dkv_kernel` launched by
`_bwd`, the `_flash` custom VJP and `flash_attention`). What the TPU
version needed and this one drops: the VMEM-sized `auto_blocks` (the
kernels tile 64 or 128 rows and keys and mask the ragged tail, so any
sequence length runs) and the 8-lane LSE pad (LSE and delta are plain
[B, H, S] f32).
GQA runs inside the kernels by reading KV head h // n_rep; K/V are
never repeated, and the dK/dV kernel sums its group's gradients in f32
before one rounding (the JAX package repeats K/V outside the VJP and
lets autodiff sum the per-head, already rounded, gradients).

Layout contract: public API takes [batch, seq, heads, head_dim].
"""

import ctypes
from typing import Optional, Tuple

import torch

from dlrover_tpu_torch.ops import _build
from dlrover_tpu_torch.ops.attention import _kv_repeat

_NAME = "flash_fwd"
_BWD = "flash_bwd"


def heads_ok(h: int, kv: int, d: int) -> bool:
    """The head gate the flash and paged kernels share: head_dim a
    multiple of 8 in [32, 256] and whole GQA groups."""
    return d % 8 == 0 and 32 <= d <= 256 and h % kv == 0


def supports_shapes(q_shape, k_shape, segment_ids=None) -> bool:
    """Whether the kernels (forward and backward) take q / k of these
    [B, S, H, D] shapes: no `segment_ids`, the head gate, and either
    equal q/k lengths or the single-query (q_len == 1) decode shape."""
    if segment_ids is not None:
        return False
    s_q, s_k = q_shape[1], k_shape[1]
    if s_q != s_k and s_q != 1:
        return False
    return heads_ok(q_shape[2], k_shape[2], q_shape[3])


def supports(q, k, segment_ids=None) -> bool:
    """`supports_shapes` of two tensors."""
    return supports_shapes(q.shape, k.shape, segment_ids)


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


def _launch_args(q, k, causal, scale):
    b, s_q, h, d = q.shape
    return (b, s_q, k.shape[1], h, k.shape[2], d, float(scale), int(causal),
            _build.current_stream(q.get_device()))


_ARG_TAIL = [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int,
                                  ctypes.c_void_p]


def _fwd_variant(b: int, s_q: int, s_k: int, h: int, kv: int, d: int,
                 causal: bool) -> str:
    """Which forward kernel takes this shape: "wgmma" (the Hopper-native
    variant: TMA, mbarrier ring, warp-specialised wgmma) for head_dim
    64 or 128 with q_len == k_len, causal or not (the prefill and
    training shapes); "mma" (mma.sync) for every other shape the
    kernels take (other head_dims, the single-query decode shape)."""
    del b, h, kv, causal
    return "wgmma" if d in (64, 128) and s_q == s_k else "mma"


# the backward kernels split the shapes as the forward's do: its wgmma
# variants (`flash_bwd_dq_wgmma_kernel`, `flash_bwd_dkv_wgmma_kernel`)
# take head_dim 64 or 128 with q_len == k_len, the mma.sync kernels
# everything else up to head_dim 256
_bwd_variant = _fwd_variant


_FWD_SYMBOLS = {"wgmma": "flash_fwd_wgmma_bf16", "mma": "flash_fwd_bf16"}


def _fwd_launch(q, k, v, causal: bool, scale: float, variant: str):
    """Launch forward `variant` on inputs `_fwd_cuda` has checked. Every
    launch counts under "flash_fwd"; the wgmma variant's also under
    "flash_fwd_wgmma"."""
    b, s_q, h, _ = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, h, s_q), dtype=torch.float32, device=q.device)
    fn = _build.function(_NAME, _FWD_SYMBOLS[variant],
                         [ctypes.c_void_p] * 5 + _ARG_TAIL)
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), *_launch_args(q, k, causal, scale),
    )
    _build.count_launch(_NAME)
    if variant == "wgmma":
        _build.count_launch("flash_fwd_wgmma")
    _build.check(err, _NAME, f"{variant}: q{tuple(q.shape)} "
                 f"k{tuple(k.shape)}")
    return o, lse


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
    return _fwd_launch(q, k, v, causal, scale,
                       _fwd_variant(b, s_q, s_k, h, kvh, d, causal))


def _fwd(q, k, v, causal: bool, scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse): the kernel for CUDA tensors, its plain version for CPU
    tensors. LSE [B, H, S] f32 is what the backward reads."""
    if q.is_cuda:
        return _fwd_cuda(q, k, v, causal, scale)
    return _fwd_plain(q, k, v, causal, scale)


def _delta(o, do):
    """rowsum(dO * O) in f32, [B, H, S] (JAX `_bwd` :392)."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def _bwd_plain(q, k, v, o, lse, do, causal: bool, scale: float):
    """The backward kernels' function in plain PyTorch: P recomputed
    from Q, K and LSE, P rounded to dO's dtype before dV = P^T dO and
    dS = P (dP - delta) scale rounded to q's dtype before dQ = dS K and
    dK = dS^T Q, f32 products; a GQA group's dK/dV summed in f32 and
    rounded once, as the dK/dV kernel does. Returns (dq, dk, dv) in
    the inputs' layouts and dtypes."""
    b, s_q, h, d = q.shape
    kvh = k.shape[2]
    n_rep = h // kvh
    k32 = _kv_repeat(k, n_rep).float()
    v32 = _kv_repeat(v, n_rep).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k32) * scale
    if causal:
        rows = torch.arange(s_q, device=s.device)[:, None]
        cols = torch.arange(k.shape[1], device=s.device)[None, :]
        s = torch.where(rows >= cols, s, float("-inf"))
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v32)
    ds = p * (dp - _delta(o, do)[..., None]) * scale
    ds = ds.to(q.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k32)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    s_k = k.shape[1]
    dk = dk.reshape(b, s_k, kvh, n_rep, d).sum(3)
    dv = dv.reshape(b, s_k, kvh, n_rep, d).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _bwd_cuda(q, k, v, o, lse, do, causal: bool, scale: float):
    for name, t in (("q", q), ("k", k), ("v", v), ("o", o), ("do", do)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} must be on q's CUDA device")
        if t.dtype != torch.bfloat16:
            raise ValueError(
                f"flash backward takes bfloat16, got {name}.dtype={t.dtype}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    b, s_q, h, d = q.shape
    s_k, kvh = k.shape[1], k.shape[2]
    if (k.shape != v.shape or o.shape != q.shape or do.shape != q.shape
            or k.shape[0] != b or k.shape[3] != d):
        raise ValueError(
            f"q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)} "
            f"o{tuple(o.shape)} do{tuple(do.shape)} do not match"
        )
    if lse.shape != (b, h, s_q) or lse.dtype != torch.float32 or (
            lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"lse must be contiguous f32 [{b}, {h}, {s_q}] "
                         "on q's device")
    if causal and s_q != s_k:
        raise ValueError("causal flash needs q_len == k_len")
    if not heads_ok(h, kvh, d):
        raise ValueError(
            f"flash backward kernels do not take q{tuple(q.shape)} "
            f"k{tuple(k.shape)} (head_dim a multiple of 8 in [32, 256], "
            "whole GQA groups)"
        )
    delta = _delta(o, do)
    variant = _bwd_variant(b, s_q, s_k, h, kvh, d, causal)
    return (_bwd_dq_cuda(q, k, v, do, lse, delta, causal, scale, variant),
            *_bwd_dkv_cuda(q, k, v, do, lse, delta, causal, scale, variant))


_BWD_SYMBOLS = {
    ("dq", "wgmma"): "flash_bwd_dq_wgmma_bf16",
    ("dq", "mma"): "flash_bwd_dq_bf16",
    ("dkv", "wgmma"): "flash_bwd_dkv_wgmma_bf16",
    ("dkv", "mma"): "flash_bwd_dkv_bf16",
}


def _bwd_launch(kernel, variant, q, k, v, do, lse, delta, outs, causal,
                scale):
    """Launch backward `kernel` ("dq" or "dkv") in `variant` on inputs
    `_bwd_cuda` has checked, into `outs`. Every launch counts under
    "flash_bwd_<kernel>"; the wgmma variant's also under
    "flash_bwd_<kernel>_wgmma"."""
    name = f"flash_bwd_{kernel}"
    fn = _build.function(_BWD, _BWD_SYMBOLS[kernel, variant],
                         [ctypes.c_void_p] * (6 + len(outs)) + _ARG_TAIL)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), *(t.data_ptr() for t in outs),
             *_launch_args(q, k, causal, scale))
    _build.count_launch(name)
    if variant == "wgmma":
        _build.count_launch(f"{name}_wgmma")
    _build.check(err, name, f"{variant}: q{tuple(q.shape)} "
                 f"k{tuple(k.shape)}")


def _bwd_dq_cuda(q, k, v, do, lse, delta, causal, scale, variant):
    """dQ by the dq kernel's `variant`, on inputs `_bwd_cuda` has
    checked."""
    dq = torch.empty_like(q)
    _bwd_launch("dq", variant, q, k, v, do, lse, delta, (dq,), causal, scale)
    return dq


def _bwd_dkv_cuda(q, k, v, do, lse, delta, causal, scale, variant):
    """(dK, dV) by the dkv kernel's `variant`, on inputs `_bwd_cuda` has
    checked."""
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _bwd_launch("dkv", variant, q, k, v, do, lse, delta, (dk, dv), causal,
                scale)
    return dk, dv


def _bwd(q, k, v, o, lse, do, causal: bool, scale: float):
    """(dq, dk, dv): the two kernels for CUDA tensors, their plain
    version for CPU tensors."""
    if q.is_cuda:
        return _bwd_cuda(q, k, v, o, lse, do, causal, scale)
    return _bwd_plain(q, k, v, o, lse, do, causal, scale)


class _Flash(torch.autograd.Function):
    """The JAX `_flash` custom VJP: forward `_fwd`, saving q, k, v, o
    and lse; backward `_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        o, lse = _fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _bwd(q, k, v, o, lse, do.contiguous(), ctx.causal,
                          ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Flash attention on [B, S, H, D] tensors; returns [B, S, H, D],
    differentiable in q, k and v through the backward kernels (their
    plain version on CPU tensors)."""
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
    return _Flash.apply(q, k, v, causal, float(scale))
