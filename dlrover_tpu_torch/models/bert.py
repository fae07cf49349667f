"""BERT-family bidirectional encoder in PyTorch — counterpart of
dlrover_tpu/models/bert.py: learned token, position and segment
embeddings, post-LN blocks with the exact (erf) GELU, a masked-LM head
tied to the token embedding, and the [CLS] pooler.

Layers are STACKED as in the JAX package and looped over where JAX
scans them; every weight is cast to `cfg.dtype` before use. Padding
rides the attention dispatcher's `segment_ids` (1 = real, 0 = pad
keys), so a padded batch attends through the plain reference, as JAX's
gate sends it; an unpadded batch (`attention_mask` None) takes the
flash kernels non-causal on the card, forward and backward.
`mlm_loss_fn` reports `masked_tokens`, not `loss_weight`, so
parallel/accelerate.py weighs its microbatches alike, as JAX's does.
"""

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from dlrover_tpu_torch._device import DeviceLike, resolve_device
from dlrover_tpu_torch.models.llama import layer_slices
from dlrover_tpu_torch.models.normalization import layer_norm_gb as _layer_norm
from dlrover_tpu_torch.ops.attention import dot_product_attention

Params = Dict

_LAYER_KEYS = (
    "wqkv", "b_qkv", "wo", "b_o", "ln1_g", "ln1_b",
    "w_up", "b_up", "w_down", "b_down", "ln2_g", "ln2_b",
)
_TOP_KEYS = (
    "tok_emb", "pos_emb", "seg_emb", "emb_ln_g", "emb_ln_b",
    "mlm_dense", "mlm_dense_b", "mlm_ln_g", "mlm_ln_b", "mlm_bias",
    "pool_w", "pool_b",
)


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    dim: int = 768
    n_layers: int = 12
    n_heads: int = 12
    mlp_dim: int = 3072
    max_seq_len: int = 512
    n_segments: int = 2
    norm_eps: float = 1e-12
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    attn_impl: str = "auto"

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @classmethod
    def base(cls, **kw) -> "BertConfig":
        return cls(**kw)

    @classmethod
    def large(cls, **kw) -> "BertConfig":
        d = dict(dim=1024, n_layers=24, n_heads=16, mlp_dim=4096)
        d.update(kw)
        return cls(**d)

    @classmethod
    def tiny(cls, **kw) -> "BertConfig":
        d = dict(
            vocab_size=256, dim=64, n_layers=2, n_heads=4,
            mlp_dim=128, max_seq_len=64, attn_impl="reference",
        )
        d.update(kw)
        return cls(**d)


def init_params(
    cfg: BertConfig, generator: torch.Generator, device: DeviceLike = None,
    dtype: Optional[torch.dtype] = None,
) -> Params:
    """Random params in the JAX layout and scales, drawn on `device`
    from `generator`, stored in `dtype` (default `cfg.param_dtype`)."""
    dev = resolve_device(device)
    L, D, M = cfg.n_layers, cfg.dim, cfg.mlp_dim
    dt = cfg.param_dtype if dtype is None else dtype

    def normal(shape, std):
        w = torch.randn(shape, generator=generator, device=dev, dtype=dt)
        return w.mul_(std)

    def dense(shape, fan_in):
        return normal(shape, 1.0 / math.sqrt(fan_in))

    def ones(*shape):
        return torch.ones(shape, device=dev, dtype=dt)

    def zeros(*shape):
        return torch.zeros(shape, device=dev, dtype=dt)

    return {
        "tok_emb": normal((cfg.vocab_size, D), 0.02),
        "pos_emb": normal((cfg.max_seq_len, D), 0.01),
        "seg_emb": normal((cfg.n_segments, D), 0.01),
        "emb_ln_g": ones(D),
        "emb_ln_b": zeros(D),
        "layers": {
            "wqkv": dense((L, D, 3 * D), D),
            "b_qkv": zeros(L, 3 * D),
            "wo": dense((L, D, D), D),
            "b_o": zeros(L, D),
            "ln1_g": ones(L, D),
            "ln1_b": zeros(L, D),
            "w_up": dense((L, D, M), D),
            "b_up": zeros(L, M),
            "w_down": dense((L, M, D), M),
            "b_down": zeros(L, D),
            "ln2_g": ones(L, D),
            "ln2_b": zeros(L, D),
        },
        # MLM head: transform + LN; the decoder is tied to tok_emb
        "mlm_dense": dense((D, D), D),
        "mlm_dense_b": zeros(D),
        "mlm_ln_g": ones(D),
        "mlm_ln_b": zeros(D),
        "mlm_bias": zeros(cfg.vocab_size),
        # [CLS] pooler
        "pool_w": dense((D, D), D),
        "pool_b": zeros(D),
    }


def params_from_numpy(
    cfg: BertConfig, tree: Dict, device: DeviceLike = None,
    dtype: Optional[torch.dtype] = None,
) -> Params:
    """The JAX param pytree as nested dicts of numpy arrays -> the
    port's params in `dtype` (default `cfg.param_dtype`) on `device`."""
    dev = resolve_device(device)
    dtype = cfg.param_dtype if dtype is None else dtype

    def conv(a):
        return torch.from_numpy(np.array(a, copy=True)).to(
            device=dev, dtype=dtype)

    out = {k: conv(tree[k]) for k in _TOP_KEYS}
    out["layers"] = {k: conv(tree["layers"][k]) for k in _LAYER_KEYS}
    return out


def partition_rules(cfg: BertConfig):
    """JAX's `partition_rules` (bert.py:109): tensor-axis rules only, so
    under fsdp every BERT leaf stays whole on each rank."""
    from dlrover_tpu_torch.parallel.mesh import PartitionSpec as P

    return [
        (r"tok_emb$", P("tensor", None)),
        (r"(pos|seg)_emb$", P(None, None)),
        (r"layers/wqkv$", P(None, None, "tensor")),
        (r"layers/b_qkv$", P(None, "tensor")),
        (r"layers/b_o$", P(None, None)),
        (r"layers/wo$", P(None, "tensor", None)),
        (r"layers/w_up$", P(None, None, "tensor")),
        (r"layers/b_up$", P(None, "tensor")),
        (r"layers/w_down$", P(None, "tensor", None)),
        (r"layers/(ln1|ln2)_", P(None, None)),
        (r"layers/b_down$", P(None, None)),
        (r"(emb|mlm)_ln_", P(None)),
        (r"mlm_dense$", P(None, None)),
        (r"mlm_dense_b$", P(None)),
        (r"mlm_bias$", P("tensor")),
        (r"pool_w$", P(None, None)),
        (r"pool_b$", P(None)),
    ]


def _block(cfg: BertConfig, x, lp, pad_mask):
    """Post-LN encoder block. `pad_mask` [B, S] (1 real, 0 pad) rides
    the dispatcher's segment_ids: real tokens never attend to pads."""
    H, hd = cfg.n_heads, cfg.head_dim
    b, s, _ = x.shape
    cd = cfg.dtype
    qkv = x @ lp["wqkv"].to(cd) + lp["b_qkv"].to(cd)
    q, k, v = (t.reshape(b, s, H, hd) for t in torch.chunk(qkv, 3, dim=-1))
    attn = dot_product_attention(q, k, v, causal=False, impl=cfg.attn_impl,
                                 segment_ids=pad_mask)
    attn = attn.reshape(b, s, H * hd)
    x = _layer_norm(x + (attn @ lp["wo"].to(cd) + lp["b_o"].to(cd)),
                    lp["ln1_g"], lp["ln1_b"], cfg.norm_eps)
    # the exact (erf) GELU: BERT's convention, unlike GPT-2's tanh
    h = F.gelu(x @ lp["w_up"].to(cd) + lp["b_up"].to(cd))
    return _layer_norm(x + (h @ lp["w_down"].to(cd) + lp["b_down"].to(cd)),
                       lp["ln2_g"], lp["ln2_b"], cfg.norm_eps)


def apply(
    cfg: BertConfig,
    params: Params,
    tokens: torch.Tensor,                          # [B, S] int
    attention_mask: Optional[torch.Tensor] = None,  # [B, S] 1 real, 0 pad
    segments: Optional[torch.Tensor] = None,        # [B, S] int
) -> torch.Tensor:
    """-> the final hidden states [B, S, D] in the compute dtype."""
    s = tokens.shape[1]
    cd = cfg.dtype
    x = F.embedding(tokens, params["tok_emb"]).to(cd)
    x = x + params["pos_emb"][:s].to(cd)[None]
    if segments is not None:
        x = x + F.embedding(segments, params["seg_emb"]).to(cd)
    else:
        # HF adds token_type_embeddings[0] when the segments are
        # omitted; a trained seg_emb[0] is not zero
        x = x + params["seg_emb"][0].to(cd)
    x = _layer_norm(x, params["emb_ln_g"], params["emb_ln_b"], cfg.norm_eps)
    pad_mask = (attention_mask.to(torch.int32)
                if attention_mask is not None else None)
    for lp in layer_slices(params, cfg.n_layers):
        x = _block(cfg, x, lp, pad_mask)
    return x


def pool(cfg: BertConfig, params: Params, hidden: torch.Tensor):
    """[CLS] pooler: tanh(dense(hidden[:, 0]))."""
    cd = cfg.dtype
    return torch.tanh(hidden[:, 0] @ params["pool_w"].to(cd)
                      + params["pool_b"].to(cd))


def mlm_logits(cfg: BertConfig, params: Params, hidden: torch.Tensor):
    """Masked-LM head: transform + LN + the tied decoder -> [B, S, V]
    f32."""
    cd = cfg.dtype
    h = F.gelu(hidden @ params["mlm_dense"].to(cd)
               + params["mlm_dense_b"].to(cd))
    h = _layer_norm(h, params["mlm_ln_g"], params["mlm_ln_b"], cfg.norm_eps)
    logits = h @ params["tok_emb"].to(cd).T
    return logits.float() + params["mlm_bias"].float()


def mlm_loss_fn(
    cfg: BertConfig, params: Params, batch: Dict[str, torch.Tensor]
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Masked-LM cross entropy. batch: tokens [B, S] (the [MASK] ids
    substituted), labels [B, S] (the original ids), mlm_mask [B, S] (1
    at the masked positions), optional attention_mask / segments."""
    hidden = apply(cfg, params, batch["tokens"],
                   attention_mask=batch.get("attention_mask"),
                   segments=batch.get("segments"))
    logits = mlm_logits(cfg, params, hidden)
    labels = batch["labels"]
    nll = F.cross_entropy(logits.flatten(0, 1), labels.flatten().long(),
                          reduction="none").view(labels.shape)
    m = batch["mlm_mask"].float()
    total = m.sum().clamp_min(1.0)
    loss = (nll * m).sum() / total
    return loss, {"loss": loss, "masked_tokens": total}


def num_params(cfg: BertConfig) -> int:
    L, D, M, V = cfg.n_layers, cfg.dim, cfg.mlp_dim, cfg.vocab_size
    per_layer = D * 3 * D + 3 * D + D * D + D + 2 * D + D * M + M + M * D \
        + D + 2 * D
    top = (V * D + cfg.max_seq_len * D + cfg.n_segments * D + 2 * D
           + D * D + D + 2 * D + V + D * D + D)
    return top + L * per_layer


def flops_per_token(cfg: BertConfig, seq_len: int) -> float:
    """Approximate training FLOPs a token: 6 N + 12 L S D (bidirectional:
    the full score matrix is computed)."""
    return 6.0 * num_params(cfg) + 12.0 * cfg.n_layers * cfg.dim * seq_len
