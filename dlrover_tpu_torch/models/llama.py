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
dequant kernel. The layer's products and its attention output carry the
JAX model's `checkpoint_name` tags (`qkv_proj`, `attn_out`,
`attn_proj`, `mlp_gate`, `mlp_up`, `mlp_down`) where autograd records,
so every policy of parallel/remat.py (`cfg.remat_policy`) acts on the
tensors JAX's does. `partition_rules` are JAX's; in a train step of
sharded state (parallel/accelerate.py) each layer gathers its fsdp
pieces inside its body and the embedding exchanges rows
(parallel/sharding.py), and where the mesh cuts the sequence the
attention runs sequence-parallel (`cfg.seq_parallel`,
parallel/sequence.py) on the chunk's global positions.
"""

import dataclasses
import math
from functools import partial
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from dlrover_tpu_torch._device import DeviceLike, resolve_device
from dlrover_tpu_torch.models import moe as _moe
from dlrover_tpu_torch.ops.attention import dot_product_attention
from dlrover_tpu_torch.ops.fused_ce import fused_cross_entropy
from dlrover_tpu_torch.ops.quantization import QuantizedWeight, matmul_any
from dlrover_tpu_torch.parallel.mesh import PartitionSpec as P
from dlrover_tpu_torch.parallel.remat import (
    apply_remat,
    checkpoint_name,
    tagged_matmul,
)
from dlrover_tpu_torch.parallel.sharding import (
    active_scope,
    embed_rows,
    gathered,
    gathered_layer,
)

Params = Dict[str, Any]

_ATTN_KEYS = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm")
_DENSE_MLP_KEYS = ("w_gate", "w_up", "w_down")
_MOE_KEYS = ("router", "we_gate", "we_up", "we_down")


def _mlp_keys(cfg) -> Tuple[str, ...]:
    return _MOE_KEYS if cfg.n_experts > 0 else _DENSE_MLP_KEYS


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
    # parallel/remat.py policy name: "full" recomputes everything, "proj"
    # saves the projections, ... (every name of JAX's resolve_policy;
    # "none" under remat checkpoints as "full", as JAX's model does)
    remat_policy: str = "full"
    attn_impl: str = "auto"               # auto | flash | reference
    # sequence-parallel attention where the train step's mesh has seq > 1
    # (parallel/sequence.py): "ulysses" | "ring"; "none" refuses a cut
    # sequence
    seq_parallel: str = "none"
    # chunked fused cross-entropy (ops/fused_ce.py): the [B, S, vocab]
    # logits are never formed; off under sequence parallelism, as JAX's
    fused_ce: bool = False
    tie_embeddings: bool = False
    # MoE (0 experts = the dense SwiGLU MLP; models/moe.py)
    n_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    # LoRA delta scale (alpha; the rank comes from the adapter's shape),
    # read only where adapter leaves are present (models/lora.py)
    lora_alpha: float = 16.0

    @property
    def moe(self) -> "_moe.MoeConfig":
        return _moe.MoeConfig(
            n_experts=self.n_experts,
            top_k=self.moe_top_k,
            capacity_factor=self.moe_capacity_factor,
        )

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
    what serving stores; training passes `cfg.param_dtype`). An MoE
    config (`n_experts` > 0) holds the expert-stacked `router`,
    `we_gate`, `we_up` and `we_down` (models/moe.py `init_moe_mlp`) in
    place of the dense MLP. Not the JAX package's numbers — its init
    draws from jax.random; parity tests carry JAX params across with
    `params_from_numpy`."""
    dev = resolve_device(device)
    L, D, M = cfg.n_layers, cfg.dim, cfg.mlp_dim
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = cfg.dtype if dtype is None else dtype

    def normal(shape, std):
        w = torch.randn(shape, generator=generator, device=dev, dtype=dt)
        return w.mul_(std)

    def dense(shape, fan_in):
        return normal(shape, 1.0 / math.sqrt(fan_in))

    # drawn in this order: a seed gives the dense model the same weights
    # whatever the MoE branch draws
    embed = normal((cfg.vocab_size, D), 0.02)
    layers = {
        "attn_norm": torch.ones((L, D), device=dev, dtype=dt),
        "wq": dense((L, D, H * hd), D),
        "wk": dense((L, D, KV * hd), D),
        "wv": dense((L, D, KV * hd), D),
        "wo": dense((L, H * hd, D), H * hd),
        "mlp_norm": torch.ones((L, D), device=dev, dtype=dt),
    }
    if cfg.n_experts > 0:
        layers.update(_moe.init_moe_mlp(generator, cfg.moe, D, M, n_layers=L,
                                        dtype=dt, device=dev))
    else:
        layers.update(w_gate=dense((L, D, M), D), w_up=dense((L, D, M), D),
                      w_down=dense((L, M, D), M))
    params = {
        "embed": {"weight": embed},
        "layers": layers,
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
    the values the JAX engine's int8 install quantizes. An MoE tree
    carries its expert-stacked leaves (`_mlp_keys`)."""
    dev = resolve_device(device)
    dtype = cfg.dtype if dtype is None else dtype

    def conv(a):
        return torch.from_numpy(np.array(a, copy=True)).to(
            device=dev, dtype=dtype
        )

    layers = tree["layers"]
    keys = _ATTN_KEYS + _mlp_keys(cfg)
    missing = [k for k in keys if k not in layers]
    if missing:
        raise ValueError(f"param tree lacks layers/{missing}")
    params = {
        "embed": {"weight": conv(tree["embed"]["weight"])},
        "layers": {k: conv(layers[k]) for k in keys
                   + tuple(sorted(k for k in layers if "_lora_" in k))},
        "final_norm": {"scale": conv(tree["final_norm"]["scale"])},
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {"weight": conv(tree["lm_head"]["weight"])}
    return params


def layer_params(params: Params, layer: int) -> Dict[str, Any]:
    """One layer's slice of the stacked weights (views, no copy; a
    QuantizedWeight slices its q8 and s8)."""
    return {k: v[layer] for k, v in params["layers"].items()}


def layer_slices(params: Params, n_layers: int) -> List[Dict[str, Any]]:
    """Every layer's slice of the stacked weights, for a forward that
    autograd records: one `unbind` a stacked tensor, whose backward
    stacks the layers' gradients once. Indexing layer by layer instead
    gives each slice a backward that writes a zero gradient of the whole
    stack, L^2 of its bytes a step. Other leaves are indexed."""
    cols = {k: (v.unbind(0) if isinstance(v, torch.Tensor)
                else [v[i] for i in range(n_layers)])
            for k, v in params["layers"].items()}
    return [{k: c[i] for k, c in cols.items()} for i in range(n_layers)]


def partition_rules(cfg: LlamaConfig):
    """(path regex, PartitionSpec) of every leaf, JAX's
    `partition_rules` (llama.py:197): the stacked layer weights carry
    the leading L axis on "pipe", column-parallel wq/wk/wv/w_gate/w_up
    shard their input dim on fsdp and output dim on tensor, row-parallel
    wo/w_down the other way round; the embedding shards D only (the
    token gather stays local), lm_head D on fsdp and vocab on tensor.
    The MoE and LoRA rules come first, as there: `layers/wq_lora_a`
    would otherwise match `layers/wq`."""
    from dlrover_tpu_torch.models.lora import lora_partition_rules

    first = _moe.moe_partition_rules() if cfg.n_experts > 0 else []
    return first + lora_partition_rules() + [
        (r"embed/weight", P(None, ("fsdp", "tensor"))),
        (r"layers/wq", P("pipe", "fsdp", "tensor")),
        (r"layers/wk", P("pipe", "fsdp", "tensor")),
        (r"layers/wv", P("pipe", "fsdp", "tensor")),
        (r"layers/wo", P("pipe", "tensor", "fsdp")),
        (r"layers/w_gate", P("pipe", "fsdp", "tensor")),
        (r"layers/w_up", P("pipe", "fsdp", "tensor")),
        (r"layers/w_down", P("pipe", "tensor", "fsdp")),
        (r"layers/(attn|mlp)_norm", P("pipe", None)),
        (r"final_norm/scale", P(None)),
        (r"lm_head/weight", P("fsdp", "tensor")),
    ]


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
    dequant fuses into the matmul (`matmul_any`); serving LoRA on it is
    the per-slot delta added after the product (`_slot_lora_delta`).

    The LoRA merge site (models/lora.py): where `{k}_lora_a/b` leaves
    are present the effective weight W + (alpha/r) A@B is formed here,
    in the compute dtype, per layer, and the adapter leaves are
    skipped. The casts stay differentiable. A head-sharded serving
    weight (parallel/sharding.Sharded) is cast piece by piece, and its
    merge adds each piece's columns of A@B."""
    from dlrover_tpu_torch.parallel.sharding import Sharded

    out = {}
    for k, v in layer_params.items():
        # the MoE leaves are cast inside models/moe.py `moe_mlp`
        if k.endswith("_norm") or "_lora_" in k or k in _MOE_KEYS:
            continue
        if isinstance(v, Sharded):
            v = v.map(lambda s: s if isinstance(s, QuantizedWeight)
                      else s.to(cfg.dtype))
        if isinstance(v, QuantizedWeight) or (
                isinstance(v, Sharded)
                and isinstance(v.shards[0], QuantizedWeight)):
            out[k] = v
            continue
        w = v if isinstance(v, Sharded) else v.to(cfg.dtype)
        a = layer_params.get(k + "_lora_a")
        if a is not None:
            b = layer_params[k + "_lora_b"]
            # the scale rounded to the compute dtype first, as JAX's
            # jnp.asarray(alpha / r, cfg.dtype); the product of two
            # values of that dtype then rounds once, as there
            scale = float(torch.tensor(cfg.lora_alpha / a.shape[-1],
                                       dtype=cfg.dtype))
            delta = scale * (a.to(cfg.dtype) @ b.to(cfg.dtype))
            if isinstance(w, Sharded):
                cols = torch.split(delta, w.widths(), dim=w.dim)
                w = Sharded([p + c.to(p.device)
                             for p, c in zip(w.shards, cols)], w.dim)
            else:
                w = w + delta
        out[k] = w
    return out


def _slot_lora_delta(h, a, b, idx, scale):
    """Per-row LoRA delta gathered from a stacked adapter bank (the BGMV
    form of multi-adapter serving, serving/adapters.py): row i of `h`
    [B, S, in] uses bank slot idx[i], so the delta is
    scale[idx] * (h @ A[idx]) @ B[idx] with A [slots, in, r] and
    B [slots, r, out]. The gathered slices and the scale are cast to
    h's dtype first and each product rounds to it, where JAX's two
    einsums round. Slot 0 holds the all-zero adapter with scale 0, so
    an adapterless row adds an exact zero."""
    hr = torch.bmm(h, a[idx].to(h.dtype))
    d = torch.bmm(hr, b[idx].to(h.dtype))
    return scale[idx].to(h.dtype)[:, None, None] * d


def _matmul(x, w, name: str, tp: int):
    """A model product: `tagged_matmul` (the remat tag) at tp = 1; on a
    serving slice (tp > 1, never under autograd) `matmul_any` with the
    tp its int8 gate reads."""
    if tp == 1:
        return tagged_matmul(x, w, name)
    return matmul_any(x, w, tp=tp)


def _attn_qkv(cfg: LlamaConfig, h, lp, positions, rope=None, lora=None,
              heads=None, tp: int = 1):
    """Projections + RoPE of one block: q [B,S,H,hd], k/v [B,S,KV,hd].
    `rope`: the forward's precomputed `_rope_tables`. `lora` (serving
    only): a (bank, idx, scale) triple of one layer's stacked adapter
    slices; each row's delta is added to the raw projections before
    RoPE (RoPE is linear, so that equals rotating the merged-weight
    projection). On a serving slice (tp > 1) `lp` holds one shard's
    wq/wk/wv columns, `lora` its B columns, and `heads` = (q heads, KV
    heads) of the shard."""
    H, KV = heads or (cfg.n_heads, cfg.n_kv_heads)
    hd = cfg.head_dim
    b, s, _ = h.shape
    hq = _matmul(h, lp["wq"], "qkv_proj", tp)
    hk = _matmul(h, lp["wk"], "qkv_proj", tp)
    hv = _matmul(h, lp["wv"], "qkv_proj", tp)
    if lora is not None:
        bank, idx, scale = lora
        hq = hq + _slot_lora_delta(h, bank["wq_a"], bank["wq_b"], idx, scale)
        hk = hk + _slot_lora_delta(h, bank["wk_a"], bank["wk_b"], idx, scale)
        hv = hv + _slot_lora_delta(h, bank["wv_a"], bank["wv_b"], idx, scale)
    q = hq.reshape(b, s, H, hd)
    k = hk.reshape(b, s, KV, hd)
    v = hv.reshape(b, s, KV, hd)
    q = _rope(q, positions, cfg.rope_theta, rope)
    k = _rope(k, positions, cfg.rope_theta, rope)
    return q, k, v


def _attn_residual(cfg: LlamaConfig, x, attn, lp, lora=None, tp: int = 1):
    """Output projection + residual; `lora` adds each row's wo delta to
    the projection (the triple of `_attn_qkv`). `tp`: the serving
    slice's size (the int8 gate of `matmul_any`)."""
    b, s, _ = x.shape
    attn = checkpoint_name(attn.reshape(b, s, cfg.n_heads * cfg.head_dim),
                           "attn_out")
    o = _matmul(attn, lp["wo"], "attn_proj", tp)
    if lora is not None:
        bank, idx, scale = lora
        o = o + _slot_lora_delta(attn, bank["wo_a"], bank["wo_b"], idx, scale)
    return x + o


def _mlp_residual(cfg: LlamaConfig, x, layer_params, lp, tp: int = 1):
    """Dense SwiGLU or MoE feed-forward + residual -> (x, the layer's
    MoE aux loss, or None for the dense MLP). The MoE branch
    routes the [B, S] tokens of this call (models/moe.py: its capacity
    follows S) over the layer's own (uncast) expert leaves, as JAX's."""
    h = _rms_norm(x, layer_params["mlp_norm"], cfg.norm_eps)
    if cfg.n_experts > 0:
        ff, metrics = _moe.moe_mlp(cfg.moe, {k: layer_params[k]
                                             for k in _MOE_KEYS},
                                   h, compute_dtype=cfg.dtype)
        return x + ff, metrics["moe_aux_loss"]
    gate = F.silu(_matmul(h, lp["w_gate"], "mlp_gate", tp))
    up = _matmul(h, lp["w_up"], "mlp_up", tp)
    return x + _matmul(gate * up, lp["w_down"], "mlp_down", tp), None


def _head_matrix(cfg: LlamaConfig, params: Params):
    """The unembedding operand of `matmul_any(x, head)`. A tied head is
    never quantized (the token gather needs the dense table); an untied
    one may arrive as a QuantizedWeight and is returned as it is. In a
    train step of sharded state the fsdp piece is gathered first
    (`gathered`)."""
    if cfg.tie_embeddings:
        return gathered(params["embed"]["weight"], "embed/weight",
                        dtype=cfg.dtype).to(cfg.dtype).T
    w = params["lm_head"]["weight"]
    if isinstance(w, QuantizedWeight):
        return w
    return gathered(w, "lm_head/weight", dtype=cfg.dtype).to(cfg.dtype)


# ---------------------------------------------------------------------------
# training forward and loss
# ---------------------------------------------------------------------------


def _seq_parallel_live(cfg: LlamaConfig) -> bool:
    """True inside a train step whose mesh cuts the sequence (seq > 1):
    the SP branch then runs (JAX's `sp_live`); a config without a
    `seq_parallel` mode raises, since its attention would see only this
    rank's chunk."""
    scope = active_scope()
    if scope is None or not scope.seq:
        return False
    if cfg.seq_parallel not in ("ulysses", "ring"):
        raise ValueError(
            f"the mesh cuts the sequence over seq={scope.mesh.size('seq')} "
            f"ranks: LlamaConfig.seq_parallel must be 'ulysses' or 'ring', "
            f"not {cfg.seq_parallel!r}")
    return True


def _layer_aux(cfg: LlamaConfig, x, layer_params, positions, rope=None):
    """One decoder block on [B, S, D] activations -> (x, its MoE aux
    loss, or None for a dense model). In a train step of sharded state
    the layer's pieces are gathered here, inside the (checkpointed)
    body; where the mesh cuts the sequence the attention is
    sequence-parallel (JAX `_layer` :401-421), Ulysses reaching the
    flash kernels on its head shard."""
    layer_params = gathered_layer(layer_params, dtype=cfg.dtype)
    lp = _compute_weights(cfg, layer_params)
    h = _rms_norm(x, layer_params["attn_norm"], cfg.norm_eps)
    q, k, v = _attn_qkv(cfg, h, lp, positions, rope)
    if _seq_parallel_live(cfg):
        from dlrover_tpu_torch.parallel.sequence import sp_attention

        attn = sp_attention(q, k, v, mode=cfg.seq_parallel, causal=True)
    else:
        attn = dot_product_attention(q, k, v, causal=True,
                                     impl=cfg.attn_impl)
    x = _attn_residual(cfg, x, attn, lp)
    return _mlp_residual(cfg, x, layer_params, lp)


def _layer(cfg: LlamaConfig, x, layer_params, positions, rope=None):
    """One decoder block on [B, S, D] activations."""
    return _layer_aux(cfg, x, layer_params, positions, rope)[0]


def apply(
    cfg: LlamaConfig,
    params: Params,
    tokens: torch.Tensor,
    positions: Optional[torch.Tensor] = None,
    return_hidden: bool = False,
    return_aux: bool = False,
):
    """Forward pass: tokens [B, S] int -> logits [B, S, vocab] f32, or
    with return_hidden the post-final-norm hidden states [B, S, D]; with
    return_aux also the per-layer MoE aux losses summed (zero for a
    dense model), under every remat policy too. No pipeline (JAX
    `apply` :448; `pipe` > 1 waits for ROADMAP queue 1 item 13). In a
    train step that cuts the sequence, `tokens` is this rank's chunk and
    `positions` default to its global ones."""
    b, s = tokens.shape
    if positions is None:
        if _seq_parallel_live(cfg):
            # this rank's chunk of the sequence: its GLOBAL positions
            from dlrover_tpu_torch.parallel.sequence import (
                seq_chunk_positions,
            )

            positions = seq_chunk_positions(
                s, active_scope().mesh, tokens.device).expand(b, s)
        else:
            positions = torch.arange(s, device=tokens.device).expand(b, s)
    # gather, then cast: the same values as JAX's cast-then-gather, and
    # the embedding's gradient is summed in f32 instead of in cfg.dtype
    x = embed_rows(params["embed"]["weight"], tokens,
                   "embed/weight").to(cfg.dtype)
    rope = _rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    body = partial(_layer_aux, cfg)
    if cfg.remat:
        # JAX checkpoints the layer under every name: "none" resolves to
        # policy=None there, which saves nothing, as "full" does here
        body = apply_remat(body, cfg.remat_policy
                           if cfg.remat_policy != "none" else "full")
    aux = x.new_zeros((), dtype=torch.float32) if return_aux else None
    for lp in layer_slices(params, cfg.n_layers):
        x, layer_aux = body(x, lp, positions, rope)
        if aux is not None and layer_aux is not None:
            aux = aux + layer_aux
    x = _rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    out = x if return_hidden else matmul_any(
        x, _head_matrix(cfg, params)).float()
    return (out, aux) if return_aux else out


def loss_fn(
    cfg: LlamaConfig, params: Params, batch: Dict[str, torch.Tensor]
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross entropy. batch: tokens [B, S], optional
    loss_mask [B, S]. Returns (loss, {"loss", "loss_weight"}); the
    weight (valid target count) lets grad accumulation weight
    microbatches by tokens.

    With `cfg.fused_ce` the loss is the chunked `fused_cross_entropy`
    over the final hidden states and the head matrix (a tied head,
    `embed.T`, gets its gradient through the embedding). As JAX's, that
    branch is off under sequence parallelism (`seq_parallel` not
    "none"). In a train step whose mesh cuts the sequence, `tokens` is
    this rank's chunk plus the next token (`Accelerated.place_batch`),
    and the loss and its weight are the chunk's."""
    tokens = batch["tokens"]
    targets = tokens[:, 1:]
    mask = batch.get("loss_mask")
    moe = cfg.n_experts > 0
    aux = None
    if cfg.fused_ce and cfg.seq_parallel == "none":
        hidden = apply(cfg, params, tokens[:, :-1], return_hidden=True,
                       return_aux=moe)
        if moe:
            hidden, aux = hidden
        m = mask[:, 1:] if mask is not None else None
        loss_sum, weight = fused_cross_entropy(
            hidden, _head_matrix(cfg, params), targets, m
        )
        weight = weight.clamp_min(1.0)
        loss = loss_sum / weight
    else:
        logits = apply(cfg, params, tokens[:, :-1], return_aux=moe)
        if moe:
            logits, aux = logits
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
    metrics = {"loss": loss, "loss_weight": weight}
    if moe:
        loss = loss + aux
        metrics["moe_aux_loss"] = aux
    return loss, metrics


def num_params(cfg: LlamaConfig) -> int:
    L, D, M, V = cfg.n_layers, cfg.dim, cfg.mlp_dim, cfg.vocab_size
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if cfg.n_experts > 0:
        mlp = cfg.n_experts * 3 * D * M + D * cfg.n_experts
    else:
        mlp = 3 * D * M
    per_layer = D * H * hd + 2 * D * KV * hd + H * hd * D + mlp + 2 * D
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
