"""Normalization layers — counterpart of dlrover_tpu/models/normalization.py.

Functional, over params dicts, with the statistics in f32 whatever the
input dtype and the result cast back to it, as the JAX functions do.
Variances are BIASED (the mean of squared deviations, jnp.var's
default). `batch_norm` keeps its running statistics in f32 at JAX's
momentum convention (new = momentum * old + (1 - momentum) * batch,
momentum 0.9) with the biased batch variance, and returns
`(y, new_params)`; that is not `nn.BatchNorm`, whose running variance
is unbiased and whose momentum weighs the batch. A batch that spans the
ranks of a `torch.distributed` world is not synchronized here: the JAX
function gets that from GSPMD, and the port's data-parallel step
(parallel/accelerate.py) holds each rank's rows only.
"""

from typing import Dict, Tuple

import torch

from dlrover_tpu_torch._device import DeviceLike, resolve_device

Params = Dict[str, torch.Tensor]


def init_batch_norm(dim: int, dtype=torch.float32,
                    device: DeviceLike = None) -> Params:
    dev = resolve_device(device)
    return {
        "scale": torch.ones((dim,), dtype=dtype, device=dev),
        "bias": torch.zeros((dim,), dtype=dtype, device=dev),
        "mean": torch.zeros((dim,), dtype=torch.float32, device=dev),
        "var": torch.ones((dim,), dtype=torch.float32, device=dev),
    }


def batch_norm(
    params: Params,
    x: torch.Tensor,
    training: bool = True,
    momentum: float = 0.9,
    eps: float = 1e-5,
) -> Tuple[torch.Tensor, Params]:
    """BatchNorm over all leading axes of [..., C]. Returns (y,
    new_params): new running statistics when training, `params` itself
    otherwise."""
    x32 = x.float()
    dims = tuple(range(x.ndim - 1))
    if training:
        var, mean = torch.var_mean(x32, dim=dims, unbiased=False)
        new_params = dict(params)
        new_params["mean"] = momentum * params["mean"] + (1 - momentum) * mean
        new_params["var"] = momentum * params["var"] + (1 - momentum) * var
    else:
        mean, var = params["mean"], params["var"]
        new_params = params
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype), new_params


def init_layer_norm(dim: int, dtype=torch.float32,
                    device: DeviceLike = None) -> Params:
    dev = resolve_device(device)
    return {
        "scale": torch.ones((dim,), dtype=dtype, device=dev),
        "bias": torch.zeros((dim,), dtype=dtype, device=dev),
    }


def layer_norm_gb(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
                  eps: float) -> torch.Tensor:
    """LayerNorm over the trailing axis with f32 statistics: the one
    definition the encoder stacks (models/gpt.py, models/bert.py) and
    the params-dict wrapper below call."""
    x32 = x.float()
    var, mu = torch.var_mean(x32, dim=-1, unbiased=False, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    y = y * g.float() + b.float()
    return y.to(x.dtype)


def layer_norm(params: Params, x: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the trailing axis, f32 statistics."""
    return layer_norm_gb(x, params["scale"], params["bias"], eps)


def init_rms_norm(dim: int, dtype=torch.float32,
                  device: DeviceLike = None) -> Params:
    return {"scale": torch.ones((dim,), dtype=dtype,
                                device=resolve_device(device))}


def rms_norm(params: Params, x: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm, the decoder stack's norm (models/llama.py `_rms_norm`)
    behind the params-dict convention."""
    from dlrover_tpu_torch.models.llama import _rms_norm

    return _rms_norm(x, params["scale"], eps)


def group_norm(params: Params, x: torch.Tensor, num_groups: int,
               eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over [..., C]: the channels split into `num_groups`
    groups, statistics per group (independent of the batch)."""
    *lead, c = x.shape
    if c % num_groups:
        raise ValueError(f"channels {c} not divisible by {num_groups}")
    x32 = x.float().reshape(*lead, num_groups, c // num_groups)
    var, mean = torch.var_mean(x32, dim=-1, unbiased=False, keepdim=True)
    y = ((x32 - mean) * torch.rsqrt(var + eps)).reshape(*lead, c)
    y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)
