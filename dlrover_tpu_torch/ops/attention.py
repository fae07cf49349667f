"""Attention entry point: the flash kernels (ops/flash_attention.py) for
tensors on the card where they take the shapes, the plain f32-softmax
reference elsewhere.

Counterpart of dlrover_tpu/ops/attention.py. Shapes follow the JAX
package's layout [batch, seq, heads, head_dim].
"""

from typing import List, Optional, Union

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


def takes_flash(q_shape, k_shape, segment_ids, device, tp: int = 1) -> bool:
    """impl="auto"'s choice (JAX `dot_product_attention`): the flash
    kernels for tensors on the card where `flash_attention.supports`
    passes (at tp > 1 on the per-shard heads of the GLOBAL shapes), the
    reference everywhere else (CPU tensors, `segment_ids`, q_len !=
    k_len unless q_len == 1, head_dims outside JAX's gate)."""
    if torch.device(device).type != "cuda":
        return False
    from dlrover_tpu_torch.ops import flash_attention as fa

    return fa.supports_shapes(q_shape, k_shape, segment_ids, tp)


def _global_shape(x, dim: int):
    """The global shape of a per-shard list split on `dim` (a tensor's
    own shape)."""
    if not isinstance(x, (list, tuple)):
        return tuple(x.shape)
    shape = list(x[0].shape)
    shape[dim] = sum(p.shape[dim] for p in x)
    return tuple(shape)


def _sharded_attention(q, k, v, causal, scale, segment_ids, impl, mesh):
    """`dot_product_attention` over a serving mesh's head split: the
    sharded flash kernel where JAX's gate takes it on the per-shard
    shapes, otherwise the reference, run per shard. Lists in, lists
    out; GLOBAL tensors in, the gathered tensor out on mesh.home."""
    from dlrover_tpu_torch.ops import flash_attention as fa
    from dlrover_tpu_torch.parallel.mesh import serving_head_specs

    tp = mesh.tp
    was_global = not isinstance(q, (list, tuple))
    gq, gk = _global_shape(q, 2), _global_shape(k, 2)
    dim = serving_head_specs(mesh)["qkv"].split_dim()
    q, k, v = (mesh.shards(x, dim) for x in (q, k, v))
    if impl == "flash" and not fa.supports_shapes(gq, gk, segment_ids, tp):
        raise ValueError(
            f"flash attention does not take q{gq} k{gk} at tp={tp}; use "
            "the reference path")
    if impl == "flash" or (
            impl == "auto"
            and takes_flash(gq, gk, segment_ids, q[0].device, tp)):
        out = fa.sharded_flash_attention(q, k, v, mesh, causal, scale)
    else:
        if scale is None:
            scale = q[0].shape[-1] ** -0.5
        seg = None if segment_ids is None else mesh.broadcast(segment_ids)
        out = [reference_attention(qi, ki, vi, causal, scale,
                                   None if seg is None else seg[i])
               for i, (qi, ki, vi) in enumerate(zip(q, k, v))]
    return mesh.gather(out, dim) if was_global else out


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    scale: Optional[float] = None,
    segment_ids: Optional[torch.Tensor] = None,
    impl: str = "auto",
    tp: int = 1,
    mesh=None,
) -> Union[torch.Tensor, List[torch.Tensor]]:
    """Main entry. impl: 'auto' | 'flash' | 'reference'.

    'auto' takes the flash kernels where `takes_flash` says so and the
    reference otherwise, as the JAX package does on its accelerator.
    'flash' demands the kernels: a shape they refuse raises (on CPU
    tensors it runs their plain version).

    `mesh` (a serving `ServingMesh` of tp > 1; `tp` is its size, as
    JAX's callers pass both) runs the attention per head shard: the
    sharded flash kernel (`sharded_flash_attention`) where the gate
    passes on the per-shard shapes, the reference per shard otherwise.
    q/k/v are then per-shard lists (returned as a list) or global
    tensors (returned gathered)."""
    if mesh is not None and mesh.tp > 1:
        if impl not in ("auto", "flash", "reference"):
            raise ValueError(f"unknown attention impl: {impl}")
        if tp not in (1, mesh.tp):
            raise ValueError(f"tp={tp} does not match the mesh's {mesh.tp}")
        return _sharded_attention(q, k, v, causal, scale, segment_ids,
                                  impl, mesh)
    if impl == "reference":
        return reference_attention(q, k, v, causal, scale, segment_ids)
    if impl not in ("auto", "flash"):
        raise ValueError(f"unknown attention impl: {impl}")
    # tp > 1 without a mesh: JAX's 'auto' keeps the reference (its
    # einsums split per head under GSPMD)
    if impl == "auto" and (tp > 1 or not takes_flash(
            q.shape, k.shape, segment_ids, q.device)):
        return reference_attention(q, k, v, causal, scale, segment_ids)
    if segment_ids is not None:
        raise ValueError(
            "flash attention does not support segment_ids yet; "
            "use impl='reference' for packed sequences"
        )
    from dlrover_tpu_torch.ops import flash_attention as fa

    return fa.flash_attention(q, k, v, causal=causal, scale=scale)
