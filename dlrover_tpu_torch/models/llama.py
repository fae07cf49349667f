"""Llama-family decoder in PyTorch — counterpart of
dlrover_tpu/models/llama.py: the training forward and loss (`apply`,
`loss_fn`) and the pieces the serving decoder shares.

Layers are STACKED as in the JAX package (leading axis = n_layers);
`apply` and the decoder in models/decode.py loop over that axis where
JAX scans it, and `apply` checkpoints each layer under `cfg.remat`
(parallel/remat.py). The JAX path casts every matmul weight, embedding
and norm scale to `cfg.dtype` before use (`_compute_weights`,
`_rms_norm`, `_head_matrix`, the embedding gather), and so does this
one; the casts are differentiable, so f32 storage (`cfg.param_dtype`,
what training stores) gets f32 gradients. Serving stores the compute
dtype by default, which computes the same and saves the per-step casts.
Every matmul goes through `matmul_any`, so a weight the serving engine
quantized (`QuantizedWeight`, weight_quant="int8") runs the fused
dequant kernel.
"""

import dataclasses
import math
from functools import partial
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from dlrover_tpu_torch._device import DeviceLike, resolve_device
from dlrover_tpu_torch.ops.attention import dot_product_attention
from dlrover_tpu_torch.ops.fused_ce import fused_cross_entropy
from dlrover_tpu_torch.ops.quantization import QuantizedWeight, matmul_any
from dlrover_tpu_torch.parallel.remat import apply_remat

Params = Dict[str, Any]

_LAYER_KEYS = (
    "attn_norm", "wq", "wk", "wv", "wo", "mlp_norm",
    "w_gate", "w_up", "w_down",
)


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 32
    mlp_dim: int = 11008
    max_seq_len: int = 2048
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16   # compute dtype
    param_dtype: torch.dtype = torch.float32  # training storage dtype
    remat: bool = True                    # checkpoint each layer in apply
    # parallel/remat.py policy name: "full" recomputes everything
    remat_policy: str = "full"
    attn_impl: str = "auto"               # auto | flash | reference
    # chunked fused cross-entropy (ops/fused_ce.py): the [B, S, vocab]
    # logits are never formed
    fused_ce: bool = False
    tie_embeddings: bool = False
    n_experts: int = 0                    # MoE is not ported; must be 0

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    # ---- presets (the JAX package's sizes) ----
    @classmethod
    def llama2_7b(cls, **kw) -> "LlamaConfig":
        return cls(**kw)

    @classmethod
    def llama3_8b(cls, **kw) -> "LlamaConfig":
        """Llama-3 family: GQA (8 kv heads), 128k vocab, theta 500k."""
        defaults = dict(
            vocab_size=128256, dim=4096, n_layers=32, n_heads=32,
            n_kv_heads=8, mlp_dim=14336, max_seq_len=8192,
            rope_theta=500000.0,
        )
        defaults.update(kw)
        return cls(**defaults)

    @classmethod
    def tiny(cls, **kw) -> "LlamaConfig":
        """Test-size model: runs on the CPU in seconds."""
        defaults = dict(
            vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
            mlp_dim=128, max_seq_len=128, remat=False,
            attn_impl="reference",
        )
        defaults.update(kw)
        return cls(**defaults)


def _check_dense(cfg: LlamaConfig) -> None:
    if cfg.n_experts > 0:
        raise NotImplementedError(
            "MoE llama is not ported yet (dense SwiGLU only)"
        )


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_params(
    cfg: LlamaConfig, generator: torch.Generator, device: DeviceLike = None,
    dtype: Optional[torch.dtype] = None,
) -> Params:
    """Random stacked-layer params, drawn on `device` from `generator`
    (which must live on that device) in the JAX package's layout and
    scales: normal / sqrt(fan_in) matmul weights, 0.02 * normal
    embedding, unit norm scales, stored in `dtype` (default `cfg.dtype`,
    what serving stores; training passes `cfg.param_dtype`). Not the
    JAX package's numbers — its init draws from jax.random; parity
    tests carry JAX params across with `params_from_numpy`."""
    _check_dense(cfg)
    dev = resolve_device(device)
    L, D, M = cfg.n_layers, cfg.dim, cfg.mlp_dim
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = cfg.dtype if dtype is None else dtype

    def normal(shape, std):
        w = torch.randn(shape, generator=generator, device=dev, dtype=dt)
        return w.mul_(std)

    def dense(shape, fan_in):
        return normal(shape, 1.0 / math.sqrt(fan_in))

    params = {
        "embed": {"weight": normal((cfg.vocab_size, D), 0.02)},
        "layers": {
            "attn_norm": torch.ones((L, D), device=dev, dtype=dt),
            "wq": dense((L, D, H * hd), D),
            "wk": dense((L, D, KV * hd), D),
            "wv": dense((L, D, KV * hd), D),
            "wo": dense((L, H * hd, D), H * hd),
            "mlp_norm": torch.ones((L, D), device=dev, dtype=dt),
            "w_gate": dense((L, D, M), D),
            "w_up": dense((L, D, M), D),
            "w_down": dense((L, M, D), M),
        },
        "final_norm": {"scale": torch.ones((D,), device=dev, dtype=dt)},
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {"weight": dense((D, cfg.vocab_size), D)}
    return params


def params_from_numpy(
    cfg: LlamaConfig, tree: Dict, device: DeviceLike = None,
    dtype: Optional[torch.dtype] = None,
) -> Params:
    """The JAX param pytree (`dlrover_tpu.models.llama.init_params`
    layout) as nested dicts of numpy arrays -> the port's params, every
    leaf cast to `dtype` (default `cfg.dtype`, the cast the JAX path
    applies before each use; numpy float32 -> bfloat16 rounds to nearest
    even, as jnp's astype does) on `device`. A wider storage dtype
    computes the same thing (every use casts to `cfg.dtype`) and keeps
    the values the JAX engine's int8 install quantizes."""
    _check_dense(cfg)
    dev = resolve_device(device)
    dtype = cfg.dtype if dtype is None else dtype

    def conv(a):
        return torch.from_numpy(np.array(a, copy=True)).to(
            device=dev, dtype=dtype
        )

    layers = tree["layers"]
    missing = [k for k in _LAYER_KEYS if k not in layers]
    if missing:
        raise ValueError(f"param tree lacks layers/{missing}")
    params = {
        "embed": {"weight": conv(tree["embed"]["weight"])},
        "layers": {k: conv(layers[k]) for k in _LAYER_KEYS},
        "final_norm": {"scale": conv(tree["final_norm"]["scale"])},
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {"weight": conv(tree["lm_head"]["weight"])}
    return params


def layer_params(params: Params, layer: int) -> Dict[str, Any]:
    """One layer's slice of the stacked weights (views, no copy; a
    QuantizedWeight slices its q8 and s8)."""
    return {k: v[layer] for k, v in params["layers"].items()}


# ---------------------------------------------------------------------------
# forward pieces (shared with models/decode.py)
# ---------------------------------------------------------------------------


def _rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    rms = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (x32 * rms).to(x.dtype) * scale.to(x.dtype)


def _rope_tables(positions: torch.Tensor, d: int, theta: float):
    """(cos, sin) [B, S, 1, D/2] f32 for `positions` [B, S] — the same
    for every layer, so a forward computes them once."""
    freqs = torch.exp(
        -math.log(theta)
        * torch.arange(0, d, 2, dtype=torch.float32, device=positions.device)
        / d
    )
    angles = positions[:, :, None].float() * freqs  # [B, S, D/2]
    return torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]


def _rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
          tables=None) -> torch.Tensor:
    """Rotary embedding on [B, S, H, D], f32 math. `tables` are the
    precomputed `_rope_tables(positions, D, theta)`."""
    if tables is None:
        tables = _rope_tables(positions, x.shape[-1], theta)
    cos, sin = tables
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _compute_weights(cfg: LlamaConfig, layer_params) -> Dict:
    """Matmul weights in the compute dtype (norms skipped: _rms_norm
    casts its own). A QuantizedWeight passes through untouched: its
    dequant fuses into the matmul (`matmul_any`). No LoRA merge yet."""
    return {
        k: v if isinstance(v, QuantizedWeight) else v.to(cfg.dtype)
        for k, v in layer_params.items()
        if not k.endswith("_norm")
    }


def _attn_qkv(cfg: LlamaConfig, h, lp, positions, rope=None):
    """Projections + RoPE of one block: q [B,S,H,hd], k/v [B,S,KV,hd].
    `rope`: the forward's precomputed `_rope_tables`."""
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    b, s, _ = h.shape
    q = matmul_any(h, lp["wq"]).reshape(b, s, H, hd)
    k = matmul_any(h, lp["wk"]).reshape(b, s, KV, hd)
    v = matmul_any(h, lp["wv"]).reshape(b, s, KV, hd)
    q = _rope(q, positions, cfg.rope_theta, rope)
    k = _rope(k, positions, cfg.rope_theta, rope)
    return q, k, v


def _attn_residual(cfg: LlamaConfig, x, attn, lp):
    """Output projection + residual."""
    b, s, _ = x.shape
    attn = attn.reshape(b, s, cfg.n_heads * cfg.head_dim)
    return x + matmul_any(attn, lp["wo"])


def _mlp_residual(cfg: LlamaConfig, x, layer_params, lp):
    """Dense SwiGLU feed-forward + residual."""
    _check_dense(cfg)
    h = _rms_norm(x, layer_params["mlp_norm"], cfg.norm_eps)
    gate = F.silu(matmul_any(h, lp["w_gate"]))
    up = matmul_any(h, lp["w_up"])
    return x + matmul_any(gate * up, lp["w_down"])


def _head_matrix(cfg: LlamaConfig, params: Params):
    """The unembedding operand of `matmul_any(x, head)`. A tied head is
    never quantized (the token gather needs the dense table); an untied
    one may arrive as a QuantizedWeight and is returned as it is."""
    if cfg.tie_embeddings:
        return params["embed"]["weight"].to(cfg.dtype).T
    w = params["lm_head"]["weight"]
    if isinstance(w, QuantizedWeight):
        return w
    return w.to(cfg.dtype)


# ---------------------------------------------------------------------------
# training forward and loss
# ---------------------------------------------------------------------------


def _layer(cfg: LlamaConfig, x, layer_params, positions, rope=None):
    """One decoder block on [B, S, D] activations."""
    lp = _compute_weights(cfg, layer_params)
    h = _rms_norm(x, layer_params["attn_norm"], cfg.norm_eps)
    q, k, v = _attn_qkv(cfg, h, lp, positions, rope)
    attn = dot_product_attention(q, k, v, causal=True, impl=cfg.attn_impl)
    x = _attn_residual(cfg, x, attn, lp)
    return _mlp_residual(cfg, x, layer_params, lp)


def apply(
    cfg: LlamaConfig,
    params: Params,
    tokens: torch.Tensor,
    positions: Optional[torch.Tensor] = None,
    return_hidden: bool = False,
) -> torch.Tensor:
    """Forward pass: tokens [B, S] int -> logits [B, S, vocab] f32, or
    with return_hidden the post-final-norm hidden states [B, S, D]. One
    device, dense layers: no pipeline, no MoE (JAX `apply` :428)."""
    _check_dense(cfg)
    b, s = tokens.shape
    if positions is None:
        positions = torch.arange(s, device=tokens.device).expand(b, s)
    # gather, then cast: the same values as JAX's cast-then-gather, and
    # the embedding's gradient is summed in f32 instead of in cfg.dtype
    x = F.embedding(tokens, params["embed"]["weight"]).to(cfg.dtype)
    rope = _rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    body = partial(_layer, cfg)
    if cfg.remat:
        body = apply_remat(body, cfg.remat_policy)
    for i in range(cfg.n_layers):
        x = body(x, layer_params(params, i), positions, rope)
    x = _rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    if return_hidden:
        return x
    return matmul_any(x, _head_matrix(cfg, params)).float()


def loss_fn(
    cfg: LlamaConfig, params: Params, batch: Dict[str, torch.Tensor]
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross entropy. batch: tokens [B, S], optional
    loss_mask [B, S]. Returns (loss, {"loss", "loss_weight"}); the
    weight (valid target count) lets grad accumulation weight
    microbatches by tokens.

    With `cfg.fused_ce` the loss is the chunked `fused_cross_entropy`
    over the final hidden states and the head matrix (a tied head,
    `embed.T`, gets its gradient through the embedding). JAX takes that
    branch only without sequence parallelism; the port has none, so
    `fused_ce` alone decides."""
    tokens = batch["tokens"]
    targets = tokens[:, 1:]
    mask = batch.get("loss_mask")
    if cfg.fused_ce:
        hidden = apply(cfg, params, tokens[:, :-1], return_hidden=True)
        m = mask[:, 1:] if mask is not None else None
        loss_sum, weight = fused_cross_entropy(
            hidden, _head_matrix(cfg, params), targets, m
        )
        weight = weight.clamp_min(1.0)
        loss = loss_sum / weight
        return loss, {"loss": loss, "loss_weight": weight}
    logits = apply(cfg, params, tokens[:, :-1])
    nll = F.cross_entropy(
        logits.flatten(0, 1), targets.flatten().long(), reduction="none"
    ).view(targets.shape)
    if mask is not None:
        m = mask[:, 1:].to(nll.dtype)
        weight = m.sum().clamp_min(1.0)
        loss = (nll * m).sum() / weight
    else:
        loss = nll.mean()
        weight = torch.tensor(float(nll.numel()), device=nll.device)
    return loss, {"loss": loss, "loss_weight": weight}


def num_params(cfg: LlamaConfig) -> int:
    L, D, M, V = cfg.n_layers, cfg.dim, cfg.mlp_dim, cfg.vocab_size
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    per_layer = D * H * hd + 2 * D * KV * hd + H * hd * D + 3 * D * M + 2 * D
    total = V * D + L * per_layer + D
    if not cfg.tie_embeddings:
        total += D * V
    return total


def flops_per_token(
    cfg: LlamaConfig, seq_len: int, causal: bool = False
) -> float:
    """Approx training FLOPs/token: 6*N + attention term (for MFU).
    causal=False credits the full S x S score matrix (PaLM); causal=True
    only the lower triangle the causal kernels compute, (S+1)/2S of it."""
    n = num_params(cfg)
    attn = 12.0 * cfg.n_layers * cfg.dim * seq_len
    if causal:
        attn *= (seq_len + 1) / (2.0 * seq_len)
    return 6.0 * n + attn
