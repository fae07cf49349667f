"""Mixture-of-experts feed-forward in PyTorch — counterpart of
dlrover_tpu/models/moe.py (GShard-style capacity-bounded top-k routing
over expert-stacked SwiGLU weights).

The formulation is JAX's, one-hot dispatch and combine tensors
[B, S, E, C] contracted by einsums: the router product in f32, top-k by
repeated argmax (the first index on a tie, as jnp.argmax), Mixtral
renormalization of the k gates, slots in selection order and then by
position (a cumsum over S), the tokens past an expert's capacity
dropped; the Switch load-balance loss plus the router z-loss; the
dispatch and the expert products in the compute dtype, the combine in
f32. The one-hot product is exact: each (expert, slot) holds at most
one token. JAX runs these einsums in XLA, not in a Pallas kernel, so
`torch.einsum` is their counterpart here. Expert parallelism (the
"expert" mesh axis) is not ported: `MeshSpec.check_world` refuses it.

Capacity is a function of the S of each call (`capacity`), so a
forward routes exactly as JAX's only when it is called with JAX's
shapes: the serving engine's prefill buckets, decode steps (S = 1),
prefill chunks and verifies all pass the S the JAX engine passes.
"""

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from dlrover_tpu_torch._device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class MoeConfig:
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    min_capacity: int = 4
    normalize_topk: bool = True      # Mixtral-style renorm of top-k gates
    aux_loss_weight: float = 0.01    # Switch load-balance loss
    z_loss_weight: float = 1e-3      # router logit z-loss


def capacity(cfg: MoeConfig, seq: int) -> int:
    c = int(math.ceil(cfg.top_k * seq * cfg.capacity_factor / cfg.n_experts))
    return max(c, cfg.min_capacity)


def _top_k_masks(gates: torch.Tensor, k: int) -> List[torch.Tensor]:
    """The k experts of each token by repeated argmax (the first index
    on a tie): k one-hot [B, S, E] f32 masks in selection order."""
    remaining = gates
    masks = []
    for _ in range(k):
        mask = F.one_hot(torch.argmax(remaining, dim=-1),
                         gates.shape[-1]).float()
        masks.append(mask)
        remaining = remaining * (1.0 - mask)
    return masks


def top_k_gating(
    cfg: MoeConfig, router_logits: torch.Tensor, cap: int,
) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """router_logits [B, S, E] -> (dispatch [B, S, E, C] 0/1 f32,
    combine [B, S, E, C] f32, metrics: the weighted `moe_aux_loss` ready
    to add to the loss, `moe_balance` and `moe_dropped_frac`)."""
    b, s, e = router_logits.shape
    logits32 = router_logits.float()
    gates = torch.softmax(logits32, dim=-1)

    masks = _top_k_masks(gates, cfg.top_k)
    gate_vals = [(gates * mask).sum(dim=-1) for mask in masks]

    if cfg.normalize_topk:
        denom = torch.clamp_min(sum(gate_vals), 1e-9)
        gate_vals = [g / denom for g in gate_vals]

    dispatch = router_logits.new_zeros((b, s, e, cap), dtype=torch.float32)
    combine = torch.zeros_like(dispatch)
    pos_offset = router_logits.new_zeros((b, 1, e), dtype=torch.float32)
    for mask, gv in zip(masks, gate_vals):
        pos = torch.cumsum(mask, dim=1) - 1.0 + pos_offset   # [B, S, E]
        pos_offset = pos_offset + mask.sum(dim=1, keepdim=True)
        keep = mask * (pos < cap)
        pos_i = torch.where(keep > 0, pos, 0.0).long()
        oh = F.one_hot(pos_i, cap).float() * keep[..., None]
        dispatch = dispatch + oh
        combine = combine + oh * gv[:, :, None, None]

    me = gates.mean(dim=(0, 1))
    ce = masks[0].mean(dim=(0, 1))
    aux = cfg.n_experts * (me * ce).sum()
    z = (torch.logsumexp(logits32, dim=-1) ** 2).mean()
    aux_loss = cfg.aux_loss_weight * aux + cfg.z_loss_weight * z
    dropped = 1.0 - dispatch.sum() / (b * s * cfg.top_k)
    metrics = {"moe_aux_loss": aux_loss, "moe_balance": aux,
               "moe_dropped_frac": dropped}
    return dispatch, combine, metrics


def init_moe_mlp(
    generator: torch.Generator, cfg: MoeConfig, dim: int, mlp_dim: int,
    n_layers: Optional[int] = None, dtype: torch.dtype = torch.float32,
    device: DeviceLike = None,
) -> Dict[str, torch.Tensor]:
    """Expert-stacked SwiGLU weights (leading [L?, E] axes) and the
    router [L?, D, E], normal / sqrt(fan_in), drawn on `device` from
    `generator`."""
    dev = resolve_device(device)
    lead = (cfg.n_experts,) if n_layers is None else (n_layers,
                                                      cfg.n_experts)
    rlead = () if n_layers is None else (n_layers,)

    def dense(shape, fan_in):
        w = torch.randn(shape, generator=generator, device=dev, dtype=dtype)
        return w.mul_(1.0 / math.sqrt(fan_in))

    return {
        "router": dense(rlead + (dim, cfg.n_experts), dim),
        "we_gate": dense(lead + (dim, mlp_dim), dim),
        "we_up": dense(lead + (dim, mlp_dim), dim),
        "we_down": dense(lead + (mlp_dim, dim), mlp_dim),
    }


def moe_mlp(
    cfg: MoeConfig,
    params: Dict[str, torch.Tensor],  # router [D,E], we_* [E,D,M]/[E,M,D]
    x: torch.Tensor,                  # [B, S, D]
    compute_dtype: torch.dtype = torch.bfloat16,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """SwiGLU MoE block: dispatch einsum -> [E, B, C, D], the batched
    expert products, the combine einsum back to [B, S, D] (in f32)."""
    s = x.shape[1]
    cap = capacity(cfg, s)
    router_logits = x.float() @ params["router"].float()
    dispatch, combine, metrics = top_k_gating(cfg, router_logits, cap)

    xd = x.to(compute_dtype)
    disp = dispatch.to(compute_dtype)
    expert_in = torch.einsum("bsec,bsd->ebcd", disp, xd)
    wg = params["we_gate"].to(compute_dtype)
    wu = params["we_up"].to(compute_dtype)
    wd = params["we_down"].to(compute_dtype)
    h = F.silu(torch.einsum("ebcd,edm->ebcm", expert_in, wg))
    h = h * torch.einsum("ebcd,edm->ebcm", expert_in, wu)
    out = torch.einsum("ebcm,emd->ebcd", h, wd)
    y = torch.einsum("bsec,ebcd->bsd", combine, out.float())
    return y.to(x.dtype), metrics
