"""Attention entry point: the flash kernels (ops/flash_attention.py) for
tensors on the card where they take the shapes, the plain f32-softmax
reference elsewhere.

Counterpart of dlrover_tpu/ops/attention.py. Shapes follow the JAX
package's layout [batch, seq, heads, head_dim].
"""

from typing import Optional

import torch

NEG_INF = -1e30


def _kv_repeat(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """Grouped-query attention: repeat KV heads to match Q heads."""
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    k = k[:, :, :, None, :].expand(b, s, h, n_rep, d)
    return k.reshape(b, s, h * n_rep, d)


def reference_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    scale: Optional[float] = None,
    segment_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain attention, softmax in f32. [B, S, H, D] in and out. The
    causal mask is bottom-right aligned (query i of q_len sits at key
    position i + k_len - q_len)."""
    orig_dtype = q.dtype
    n_rep = q.shape[2] // k.shape[2]
    k = _kv_repeat(k, n_rep)
    v = _kv_repeat(v, n_rep)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    # bf16 x bf16 products are exact in f32: casting the operands is
    # the f32-accumulating product the JAX einsum asks for
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    logits = logits * scale
    q_len, k_len = logits.shape[-2], logits.shape[-1]
    dev = logits.device
    if causal:
        q_pos = torch.arange(q_len, device=dev)[:, None] + (k_len - q_len)
        k_pos = torch.arange(k_len, device=dev)[None, :]
        logits = torch.where(q_pos >= k_pos, logits, NEG_INF)
    if segment_ids is not None:
        seg_mask = (
            segment_ids[:, None, :, None] == segment_ids[:, None, None, :]
        )
        logits = torch.where(seg_mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(orig_dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def takes_flash(q_shape, k_shape, segment_ids, device) -> bool:
    """impl="auto"'s choice (JAX `dot_product_attention`): the flash
    kernels for tensors on the card where `flash_attention.supports`
    passes, the reference everywhere else (CPU tensors, `segment_ids`,
    q_len != k_len unless q_len == 1, head_dims outside JAX's gate)."""
    if torch.device(device).type != "cuda":
        return False
    from dlrover_tpu_torch.ops import flash_attention as fa

    return fa.supports_shapes(q_shape, k_shape, segment_ids)


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    scale: Optional[float] = None,
    segment_ids: Optional[torch.Tensor] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Main entry. impl: 'auto' | 'flash' | 'reference'.

    'auto' takes the flash kernels where `takes_flash` says so and the
    reference otherwise, as the JAX package does on its accelerator.
    'flash' demands the kernels: a shape they refuse raises (on CPU
    tensors it runs their plain version)."""
    if impl == "reference":
        return reference_attention(q, k, v, causal, scale, segment_ids)
    if impl not in ("auto", "flash"):
        raise ValueError(f"unknown attention impl: {impl}")
    if impl == "auto" and not takes_flash(q.shape, k.shape, segment_ids,
                                          q.device):
        return reference_attention(q, k, v, causal, scale, segment_ids)
    if segment_ids is not None:
        raise ValueError(
            "flash attention does not support segment_ids yet; "
            "use impl='reference' for packed sequences"
        )
    from dlrover_tpu_torch.ops import flash_attention as fa

    return fa.flash_attention(q, k, v, causal=causal, scale=scale)
