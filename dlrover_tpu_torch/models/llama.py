"""Llama-family decoder in PyTorch — counterpart of
dlrover_tpu/models/llama.py (the parts the serving path runs).

Layers are STACKED as in the JAX package (leading axis = n_layers); the
decoder in models/decode.py loops over that axis where JAX scans it.
Weights are stored in the compute dtype by default: the JAX path casts
every matmul weight, embedding and norm scale to `cfg.dtype` before use
(`_compute_weights`, `_rms_norm`, `_head_matrix`, the embedding
gather), and so does this one, so storing them cast is numerically
identical and saves the per-step casts. Every matmul goes through
`matmul_any`, so a weight the serving engine quantized
(`QuantizedWeight`, weight_quant="int8") runs the fused dequant kernel.
"""

import dataclasses
import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from dlrover_tpu_torch._device import DeviceLike, resolve_device
from dlrover_tpu_torch.ops.quantization import QuantizedWeight, matmul_any

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
    dtype: torch.dtype = torch.bfloat16   # compute (and storage) dtype
    attn_impl: str = "auto"               # auto | flash | reference
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
            mlp_dim=128, max_seq_len=128, attn_impl="reference",
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
    cfg: LlamaConfig, generator: torch.Generator, device: DeviceLike = None
) -> Params:
    """Random stacked-layer params, drawn on `device` from `generator`
    (which must live on that device) in the JAX package's layout and
    scales: normal / sqrt(fan_in) matmul weights, 0.02 * normal
    embedding, unit norm scales. Not the JAX package's numbers — its
    init draws from jax.random; parity tests carry JAX params across
    with `params_from_numpy`."""
    _check_dense(cfg)
    dev = resolve_device(device)
    L, D, M = cfg.n_layers, cfg.dim, cfg.mlp_dim
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = cfg.dtype

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


def num_params(cfg: LlamaConfig) -> int:
    L, D, M, V = cfg.n_layers, cfg.dim, cfg.mlp_dim, cfg.vocab_size
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    per_layer = D * H * hd + 2 * D * KV * hd + H * hd * D + 3 * D * M + 2 * D
    total = V * D + L * per_layer + D
    if not cfg.tie_embeddings:
        total += D * V
    return total
