"""GPT-2 / nanoGPT family in PyTorch — counterpart of
dlrover_tpu/models/gpt.py: learned positional embeddings, pre-LayerNorm
blocks, a GELU MLP (the tanh approximation, `jax.nn.gelu`'s default),
multi-head attention (no grouped KV heads) and an LM head tied to the
token embedding.

Layers are STACKED as in the JAX package (leading axis = n_layers);
`apply` loops over that axis where JAX scans it and, under `cfg.remat`,
checkpoints each layer whole (JAX's `nothing_saveable`: the "full"
policy of parallel/remat.py, a `torch.utils.checkpoint` per layer).
Every weight is cast to `cfg.dtype` before use, as in JAX; f32 storage
(what training keeps) gets f32 gradients through the casts. Every
product goes through `matmul_any`, so a weight the serving engine
quantized (weight_quant="int8": wqkv, wo, w_up and w_down) runs the
fused dequant kernel; the tied `wte` stays dense (the token gather
needs the table). The KV-cache decoder (models/decode.py) reuses
`_attn_qkv`, `_attn_residual` and `_mlp_residual`.

`n_kv_heads` is `n_heads` (a property: the caches, pools and the paged
kernel take the family at KV group 1), and `attn_impl` picks the
attention as `LlamaConfig.attn_impl` does (JAX's GPT has no such field
and always takes "auto").
"""

import dataclasses
import math
from functools import partial
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from dlrover_tpu_torch._device import DeviceLike, resolve_device
from dlrover_tpu_torch.models.llama import layer_slices
from dlrover_tpu_torch.models.normalization import layer_norm_gb as _layer_norm
from dlrover_tpu_torch.ops.attention import dot_product_attention
from dlrover_tpu_torch.ops.quantization import QuantizedWeight, matmul_any
from dlrover_tpu_torch.parallel.remat import apply_remat

Params = Dict[str, Any]

_LAYER_KEYS = (
    "ln1_g", "ln1_b", "wqkv", "b_qkv", "wo", "b_o",
    "ln2_g", "ln2_b", "w_up", "b_up", "w_down", "b_down",
)


@dataclasses.dataclass(frozen=True)
class GptConfig:
    vocab_size: int = 50304      # nanoGPT's padded GPT-2 vocab
    dim: int = 768
    n_layers: int = 12
    n_heads: int = 12
    max_seq_len: int = 1024
    dropout: float = 0.0         # kept for config parity; eval-mode 0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    remat: bool = True
    attn_impl: str = "auto"      # auto | flash | reference

    @property
    def head_dim(self) -> int:
        assert self.dim % self.n_heads == 0
        return self.dim // self.n_heads

    @property
    def mlp_dim(self) -> int:
        return 4 * self.dim

    @property
    def n_kv_heads(self) -> int:
        return self.n_heads

    @classmethod
    def gpt2(cls, **kw) -> "GptConfig":
        return cls(**kw)  # 124M

    @classmethod
    def gpt2_medium(cls, **kw) -> "GptConfig":
        return cls(dim=1024, n_layers=24, n_heads=16, **kw)

    @classmethod
    def gpt2_large(cls, **kw) -> "GptConfig":
        return cls(dim=1280, n_layers=36, n_heads=20, **kw)

    @classmethod
    def gpt2_xl(cls, **kw) -> "GptConfig":
        """GPT-2 XL, 1.5 B parameters: 48 layers of 25 heads of 64."""
        return cls(dim=1600, n_layers=48, n_heads=25, **kw)

    @classmethod
    def tiny(cls, **kw) -> "GptConfig":
        defaults = dict(
            vocab_size=256, dim=64, n_layers=2, n_heads=4,
            max_seq_len=128, remat=False,
        )
        defaults.update(kw)
        return cls(**defaults)


def init_params(
    cfg: GptConfig, generator: torch.Generator, device: DeviceLike = None,
    dtype: Optional[torch.dtype] = None,
) -> Params:
    """Random stacked-layer params drawn on `device` from `generator`
    (which must live there) in the JAX layout and scales: normal /
    sqrt(fan_in) projections, the residual projections (wo, w_down)
    scaled by a further 1/sqrt(2L), 0.02 * normal token and 0.01 *
    normal position tables, unit LayerNorm gains, zero biases; stored
    in `dtype` (default `cfg.dtype`; training passes
    `cfg.param_dtype`). Not JAX's numbers: parity tests carry JAX params
    across with `params_from_numpy`."""
    dev = resolve_device(device)
    L, D, M = cfg.n_layers, cfg.dim, cfg.mlp_dim
    dt = cfg.dtype if dtype is None else dtype
    res = 1.0 / math.sqrt(2 * L)

    def normal(shape, std):
        w = torch.randn(shape, generator=generator, device=dev, dtype=dt)
        return w.mul_(std)

    def dense(shape, fan_in, scale=1.0):
        return normal(shape, scale / math.sqrt(fan_in))

    def ones(*shape):
        return torch.ones(shape, device=dev, dtype=dt)

    def zeros(*shape):
        return torch.zeros(shape, device=dev, dtype=dt)

    return {
        "wte": normal((cfg.vocab_size, D), 0.02),
        "wpe": normal((cfg.max_seq_len, D), 0.01),
        "layers": {
            "ln1_g": ones(L, D),
            "ln1_b": zeros(L, D),
            "wqkv": dense((L, D, 3 * D), D),
            "b_qkv": zeros(L, 3 * D),
            "wo": dense((L, D, D), D, res),
            "b_o": zeros(L, D),
            "ln2_g": ones(L, D),
            "ln2_b": zeros(L, D),
            "w_up": dense((L, D, M), D),
            "b_up": zeros(L, M),
            "w_down": dense((L, M, D), M, res),
            "b_down": zeros(L, D),
        },
        "lnf_g": ones(D),
        "lnf_b": zeros(D),
    }


def params_from_numpy(
    cfg: GptConfig, tree: Dict, device: DeviceLike = None,
    dtype: Optional[torch.dtype] = None,
) -> Params:
    """The JAX param pytree (`dlrover_tpu.models.gpt.init_params`
    layout) as nested dicts of numpy arrays -> the port's params, every
    leaf cast to `dtype` (default `cfg.dtype`) on `device`."""
    dev = resolve_device(device)
    dtype = cfg.dtype if dtype is None else dtype

    def conv(a):
        return torch.from_numpy(np.array(a, copy=True)).to(
            device=dev, dtype=dtype)

    layers = tree["layers"]
    missing = [k for k in _LAYER_KEYS if k not in layers]
    if missing:
        raise ValueError(f"param tree lacks layers/{missing}")
    return {
        "wte": conv(tree["wte"]),
        "wpe": conv(tree["wpe"]),
        "layers": {k: conv(layers[k]) for k in _LAYER_KEYS},
        "lnf_g": conv(tree["lnf_g"]),
        "lnf_b": conv(tree["lnf_b"]),
    }


def partition_rules(cfg: GptConfig):
    """JAX's `partition_rules` (gpt.py:115): the tensor axis on the
    fused qkv, up and the embedding's vocab; no rule names fsdp, so
    under fsdp every GPT leaf stays whole on each rank."""
    from dlrover_tpu_torch.parallel.mesh import PartitionSpec as P

    return [
        (r"wte$", P("tensor", None)),
        (r"wpe$", P(None, None)),
        (r"layers/wqkv$", P(None, None, "tensor")),
        (r"layers/b_qkv$", P(None, "tensor")),
        (r"layers/wo$", P(None, "tensor", None)),
        (r"layers/b_o$", P(None, None)),
        (r"layers/w_up$", P(None, None, "tensor")),
        (r"layers/b_up$", P(None, "tensor")),
        (r"layers/w_down$", P(None, "tensor", None)),
        (r"layers/(ln1|ln2)_", P(None, None)),
        (r"layers/b_down$", P(None, None)),
        (r"ln[f]_", P(None)),
    ]


def _wcast(w, dtype):
    """Compute-dtype cast of a dense weight; a QuantizedWeight passes
    through (its dequant fuses into `matmul_any`)."""
    if isinstance(w, QuantizedWeight):
        return w
    return w.to(dtype)


def _attn_qkv(cfg: GptConfig, x, lp, tp: int = 1):
    """LN1 + the fused qkv projection: q, k, v [B, S, H, hd]."""
    b, s, _ = x.shape
    H, hd = cfg.n_heads, cfg.head_dim
    h = _layer_norm(x, lp["ln1_g"], lp["ln1_b"], cfg.norm_eps)
    qkv = matmul_any(h, _wcast(lp["wqkv"], cfg.dtype), tp=tp) + lp[
        "b_qkv"].to(cfg.dtype)
    q, k, v = torch.chunk(qkv, 3, dim=-1)
    return (q.reshape(b, s, H, hd), k.reshape(b, s, H, hd),
            v.reshape(b, s, H, hd))


def _attn_residual(cfg: GptConfig, x, attn, lp, tp: int = 1):
    b, s, _ = x.shape
    return x + (
        matmul_any(attn.reshape(b, s, cfg.dim), _wcast(lp["wo"], cfg.dtype),
                   tp=tp)
        + lp["b_o"].to(cfg.dtype)
    )


def _mlp_residual(cfg: GptConfig, x, lp, tp: int = 1):
    h = _layer_norm(x, lp["ln2_g"], lp["ln2_b"], cfg.norm_eps)
    up = matmul_any(h, _wcast(lp["w_up"], cfg.dtype), tp=tp) + lp[
        "b_up"].to(cfg.dtype)
    up = F.gelu(up, approximate="tanh")
    return x + matmul_any(up, _wcast(lp["w_down"], cfg.dtype),
                          tp=tp) + lp["b_down"].to(cfg.dtype)


def _block(cfg: GptConfig, x, lp):
    q, k, v = _attn_qkv(cfg, x, lp)
    attn = dot_product_attention(q, k, v, causal=True, impl=cfg.attn_impl)
    x = _attn_residual(cfg, x, attn, lp)
    return _mlp_residual(cfg, x, lp)


def embed(cfg: GptConfig, params: Params, tokens, positions):
    """Token plus learned position embeddings in the compute dtype
    (gather, then cast: JAX's cast-then-gather values, with the
    tables' gradients summed in their storage dtype)."""
    return (F.embedding(tokens, params["wte"]).to(cfg.dtype)
            + F.embedding(positions, params["wpe"]).to(cfg.dtype))


def final_logits(cfg: GptConfig, params: Params, x, tp: int = 1):
    """Final LayerNorm and the head tied to `wte` -> f32 logits."""
    x = _layer_norm(x, params["lnf_g"], params["lnf_b"], cfg.norm_eps)
    return matmul_any(x, params["wte"].to(cfg.dtype).T, tp=tp).float()


def apply(
    cfg: GptConfig,
    params: Params,
    tokens: torch.Tensor,
    positions: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """tokens [B, S] int -> logits [B, S, vocab] f32."""
    b, s = tokens.shape
    if s > cfg.max_seq_len:
        # the learned position table has max_seq_len rows: JAX's gather
        # would clamp every later token to wpe[-1]
        raise ValueError(
            f"sequence length {s} exceeds the GPT position table "
            f"(max_seq_len={cfg.max_seq_len})"
        )
    if positions is None:
        positions = torch.arange(s, device=tokens.device).expand(b, s)
    x = embed(cfg, params, tokens, positions)
    body = partial(_block, cfg)
    if cfg.remat:
        body = apply_remat(body, "full")
    for lp in layer_slices(params, cfg.n_layers):
        x = body(x, lp)
    return final_logits(cfg, params, x)


def loss_fn(
    cfg: GptConfig, params: Params, batch: Dict[str, torch.Tensor]
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross entropy; batch: tokens [B, S] (+ loss_mask
    [B, S - 1], over the targets, as JAX's takes it)."""
    tokens = batch["tokens"]
    logits = apply(cfg, params, tokens[:, :-1])
    targets = tokens[:, 1:]
    nll = F.cross_entropy(
        logits.flatten(0, 1), targets.flatten().long(), reduction="none"
    ).view(targets.shape)
    mask = batch.get("loss_mask")
    mask = (torch.ones_like(nll) if mask is None else mask.to(nll.dtype))
    w = mask.sum().clamp_min(1.0)
    loss = (nll * mask).sum() / w
    return loss, {"loss": loss, "loss_weight": w}


def num_params(cfg: GptConfig) -> int:
    D, L, M = cfg.dim, cfg.n_layers, cfg.mlp_dim
    # ln1(g+b) + wqkv + b_qkv + wo + b_o + ln2(g+b) + w_up + b_up
    # + w_down + b_down
    per_layer = 2 * D + (D * 3 * D) + 3 * D + D * D + D + 2 * D + (
        D * M) + M + (M * D) + D
    return cfg.vocab_size * D + cfg.max_seq_len * D + L * per_layer + 2 * D


def flops_per_token(cfg: GptConfig, seq_len: int) -> float:
    """Approximate training FLOPs a token: 6 N + 12 L S D (the full
    S x S score matrix credited, the PaLM convention)."""
    return 6.0 * num_params(cfg) + 12.0 * cfg.n_layers * cfg.dim * seq_len
