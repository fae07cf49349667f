"""HuggingFace -> port weight conversion — counterpart of
dlrover_tpu/models/convert.py, for the Llama, GPT-2 and BERT families.

Pure layout work, no numerics change:

- HF `nn.Linear` stores [out, in]; the port's products are `h @ W` with
  W [in, out], so Llama and BERT projections transpose. GPT-2's HF
  Conv1D already stores [in, out]: no transposes there.
- Per-layer HF weights stack along a leading n_layers axis.
- RoPE needs no permutation: both sides rotate halves.
- BERT's separate q / k / v fuse into the port's `wqkv` columns.

The config mappers refuse HF fields these architectures do not model
(an import would give silently wrong logits), as JAX's do. The
importers take a state dict of tensors or arrays (keys with or without
the usual prefix) and return the port's params in `cfg.param_dtype` on
`device` (default: the card). `transformers` is imported only inside
the `from_hf` wrappers, which load a model by path; the machine with
the card need not have it. `main` writes step 0 of a flash checkpoint
through the port's checkpoint engine, in JAX `flatten_state`'s keys,
and a `model_config.json` beside it.
"""

from typing import Any, Dict, Tuple

import numpy as np
import torch

from dlrover_tpu_torch._device import DeviceLike, resolve_device
from dlrover_tpu_torch.models.llama import LlamaConfig


def config_from_hf(hf_config, **overrides) -> LlamaConfig:
    """LlamaConfig from a transformers LlamaConfig(-like) object; raises
    ValueError for HF fields this architecture does not model."""
    rope_scaling = getattr(hf_config, "rope_scaling", None)
    if rope_scaling not in (None, {}) and (
        not isinstance(rope_scaling, dict)
        or rope_scaling.get("rope_type", rope_scaling.get("type"))
        != "default"
    ):
        raise ValueError(
            f"unsupported rope_scaling={rope_scaling!r}: only plain "
            "RoPE is modeled (Llama-3.1-style long-context scaling "
            "would silently change positional numerics)"
        )
    if getattr(hf_config, "attention_bias", False):
        raise ValueError(
            "attention_bias=True is not modeled for Llama imports "
            "(Qwen-style bias tensors would be silently dropped)"
        )
    if getattr(hf_config, "mlp_bias", False):
        raise ValueError(
            "mlp_bias=True is not modeled for Llama imports (the "
            "gate/up/down bias tensors would be silently dropped)"
        )
    hidden_act = getattr(hf_config, "hidden_act", "silu")
    if hidden_act not in ("silu", "swish"):
        raise ValueError(
            f"unsupported hidden_act={hidden_act!r}: the SwiGLU MLP "
            "hard-codes silu"
        )
    fields = dict(
        vocab_size=hf_config.vocab_size,
        dim=hf_config.hidden_size,
        n_layers=hf_config.num_hidden_layers,
        n_heads=hf_config.num_attention_heads,
        n_kv_heads=getattr(hf_config, "num_key_value_heads",
                           hf_config.num_attention_heads),
        mlp_dim=hf_config.intermediate_size,
        max_seq_len=hf_config.max_position_embeddings,
        norm_eps=hf_config.rms_norm_eps,
        rope_theta=getattr(hf_config, "rope_theta", 10000.0),
        tie_embeddings=getattr(hf_config, "tie_word_embeddings", False),
    )
    fields.update(overrides)
    return LlamaConfig(**fields)


# hf per-layer name -> (the port's layers key, transposed?), read by
# both directions so they cannot drift
_PER_LAYER = {
    "input_layernorm.weight": ("attn_norm", False),
    "self_attn.q_proj.weight": ("wq", True),
    "self_attn.k_proj.weight": ("wk", True),
    "self_attn.v_proj.weight": ("wv", True),
    "self_attn.o_proj.weight": ("wo", True),
    "post_attention_layernorm.weight": ("mlp_norm", False),
    "mlp.gate_proj.weight": ("w_gate", True),
    "mlp.up_proj.weight": ("w_up", True),
    "mlp.down_proj.weight": ("w_down", True),
}


def _to_numpy(t) -> np.ndarray:
    """A tensor or array -> f32 numpy, one tensor at a time (the peak
    extra host memory is one weight)."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().float().numpy()
    return np.asarray(t, dtype=np.float32)


class _StateDict:
    """A prefix-stripped HF state dict read as the port's tensors: each
    weight converted on its own to `dtype` on `device`."""

    def __init__(self, state_dict, prefix: str, model_name: str, dtype,
                 device, n_layers: int):
        self.sd = {k.removeprefix(prefix): v for k, v in state_dict.items()}
        self.model_name = model_name
        self.dtype, self.device, self.n_layers = dtype, device, n_layers

    def raw(self, key: str) -> np.ndarray:
        if key not in self.sd:
            raise KeyError(f"HF checkpoint is missing {key!r} — is this a "
                           f"{self.model_name} state dict?")
        return _to_numpy(self.sd[key])

    def tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            device=self.device, dtype=self.dtype)

    def get(self, key: str, transpose: bool = False) -> torch.Tensor:
        a = self.raw(key)
        return self.tensor(a.T if transpose else a)

    def stack(self, fmt: str, transpose: bool = False) -> torch.Tensor:
        """Per-layer weights -> one [L, ...] tensor ([out, in] -> [in,
        out] where `transpose`)."""
        return torch.stack([self.get(fmt.format(i=i), transpose)
                            for i in range(self.n_layers)])


def params_from_hf_state_dict(state_dict: Dict[str, Any], cfg: LlamaConfig,
                              device: DeviceLike = None) -> Dict:
    """HF LlamaForCausalLM state dict -> the port's Llama params. Raises
    KeyError naming the missing HF key of an incomplete dict."""
    sd = _StateDict(state_dict, "model.", "LlamaForCausalLM",
                    cfg.param_dtype, resolve_device(device), cfg.n_layers)
    params = {
        "embed": {"weight": sd.get("embed_tokens.weight")},
        "layers": {ours: sd.stack("layers.{i}." + hf, transpose)
                   for hf, (ours, transpose) in _PER_LAYER.items()},
        "final_norm": {"scale": sd.get("norm.weight")},
    }
    if not cfg.tie_embeddings:
        # lm_head lives outside the `model.` prefix
        head = sd.sd.get("lm_head.weight")
        if head is None:
            raise KeyError("HF checkpoint has no lm_head.weight and "
                           "cfg.tie_embeddings is False")
        params["lm_head"] = {"weight": sd.tensor(_to_numpy(head).T)}
    return params


def _load_hf(cls_name: str, model_or_path):
    if isinstance(model_or_path, str):
        import transformers

        return getattr(transformers, cls_name).from_pretrained(model_or_path)
    return model_or_path


def from_hf(model_or_path, device: DeviceLike = None,
            **cfg_overrides) -> Tuple[LlamaConfig, Dict]:
    """A transformers model instance or a local pretrained path ->
    (LlamaConfig, params); `cfg_overrides` pass to `config_from_hf`."""
    model = _load_hf("LlamaForCausalLM", model_or_path)
    cfg = config_from_hf(model.config, **cfg_overrides)
    return cfg, params_from_hf_state_dict(model.state_dict(), cfg, device)


def to_hf_state_dict(cfg: LlamaConfig, params: Dict) -> Dict[str, Any]:
    """The port's Llama params -> an HF LlamaForCausalLM state dict
    (numpy f32 values, the `model.` prefix): the reverse of
    `params_from_hf_state_dict`. Load with `hf_model.load_state_dict(
    {k: torch.tensor(v) for k, v in sd.items()})`."""
    layers = params["layers"]
    if any("_lora_" in k for k in layers):
        raise ValueError(
            "params still carry LoRA adapter leaves; export would "
            "silently drop the fine-tuned deltas — call "
            "lora.merge(cfg, params) first"
        )
    sd: Dict[str, Any] = {
        "model.embed_tokens.weight": _to_numpy(params["embed"]["weight"]),
        "model.norm.weight": _to_numpy(params["final_norm"]["scale"]),
    }
    for hf_name, (ours, transpose) in _PER_LAYER.items():
        stacked = _to_numpy(layers[ours])
        for i in range(cfg.n_layers):
            w = stacked[i]
            sd[f"model.layers.{i}.{hf_name}"] = w.T if transpose else w
    if cfg.tie_embeddings:
        sd["lm_head.weight"] = sd["model.embed_tokens.weight"]
    else:
        sd["lm_head.weight"] = _to_numpy(params["lm_head"]["weight"]).T
    return sd


# ---------------------------------------------------------------------------
# GPT-2 family
# ---------------------------------------------------------------------------


def gpt_config_from_hf(hf_config, **overrides):
    """GptConfig from a transformers GPT2Config; raises on activations
    and MLP widths models/gpt.py does not express."""
    from dlrover_tpu_torch.models.gpt import GptConfig

    act = getattr(hf_config, "activation_function", "gelu_new")
    if act != "gelu_new":
        raise ValueError(
            f"unsupported activation_function {act!r}: gpt.py "
            "hardcodes tanh-approx gelu (== HF gelu_new)"
        )
    n_inner = getattr(hf_config, "n_inner", None)
    if n_inner is not None and n_inner != 4 * hf_config.n_embd:
        raise ValueError(
            f"unsupported n_inner {n_inner}: GptConfig.mlp_dim is "
            f"fixed at 4*dim ({4 * hf_config.n_embd})"
        )
    fields = dict(
        vocab_size=hf_config.vocab_size,
        dim=hf_config.n_embd,
        n_layers=hf_config.n_layer,
        n_heads=hf_config.n_head,
        max_seq_len=hf_config.n_positions,
        norm_eps=hf_config.layer_norm_epsilon,
    )
    fields.update(overrides)
    return GptConfig(**fields)


# hf per-layer suffix -> the port's layers key (Conv1D: no transposes)
_GPT_PER_LAYER = {
    "ln_1.weight": "ln1_g",
    "ln_1.bias": "ln1_b",
    "attn.c_attn.weight": "wqkv",
    "attn.c_attn.bias": "b_qkv",
    "attn.c_proj.weight": "wo",
    "attn.c_proj.bias": "b_o",
    "ln_2.weight": "ln2_g",
    "ln_2.bias": "ln2_b",
    "mlp.c_fc.weight": "w_up",
    "mlp.c_fc.bias": "b_up",
    "mlp.c_proj.weight": "w_down",
    "mlp.c_proj.bias": "b_down",
}


def gpt_params_from_hf_state_dict(state_dict: Dict[str, Any], cfg,
                                  device: DeviceLike = None) -> Dict:
    """HF GPT2LMHeadModel state dict -> the port's GPT params (the head
    is tied to wte on both sides)."""
    sd = _StateDict(state_dict, "transformer.", "GPT2LMHeadModel",
                    cfg.param_dtype, resolve_device(device), cfg.n_layers)
    return {
        "wte": sd.get("wte.weight"),
        "wpe": sd.get("wpe.weight"),
        "layers": {ours: sd.stack("h.{i}." + hf)
                   for hf, ours in _GPT_PER_LAYER.items()},
        "lnf_g": sd.get("ln_f.weight"),
        "lnf_b": sd.get("ln_f.bias"),
    }


def gpt_from_hf(model_or_path, device: DeviceLike = None, **cfg_overrides):
    """A transformers GPT-2 model or local path -> (GptConfig, params)."""
    model = _load_hf("GPT2LMHeadModel", model_or_path)
    cfg = gpt_config_from_hf(model.config, **cfg_overrides)
    return cfg, gpt_params_from_hf_state_dict(model.state_dict(), cfg,
                                              device)


# ---------------------------------------------------------------------------
# BERT family
# ---------------------------------------------------------------------------


def bert_config_from_hf(hf_config, **overrides):
    """BertConfig from a transformers BertConfig; raises on what
    models/bert.py does not express."""
    from dlrover_tpu_torch.models.bert import BertConfig

    act = getattr(hf_config, "hidden_act", "gelu")
    if act != "gelu":
        raise ValueError(
            f"unsupported hidden_act {act!r}: bert.py hardcodes "
            "exact (erf) gelu (== HF 'gelu')"
        )
    pet = getattr(hf_config, "position_embedding_type", "absolute")
    if pet != "absolute":
        raise ValueError(
            f"unsupported position_embedding_type {pet!r}: bert.py "
            "implements absolute learned positions only"
        )
    if not getattr(hf_config, "tie_word_embeddings", True):
        raise ValueError(
            "unsupported tie_word_embeddings=False: mlm_logits ties "
            "the decoder to tok_emb, so an independent "
            "cls.predictions.decoder.weight would be silently dropped"
        )
    fields = dict(
        vocab_size=hf_config.vocab_size,
        dim=hf_config.hidden_size,
        n_layers=hf_config.num_hidden_layers,
        n_heads=hf_config.num_attention_heads,
        mlp_dim=hf_config.intermediate_size,
        max_seq_len=hf_config.max_position_embeddings,
        n_segments=hf_config.type_vocab_size,
        norm_eps=hf_config.layer_norm_eps,
    )
    fields.update(overrides)
    return BertConfig(**fields)


def bert_params_from_hf_state_dict(state_dict: Dict[str, Any], cfg,
                                   device: DeviceLike = None) -> Dict:
    """HF BertForMaskedLM state dict -> the port's BERT params. HF's
    q / k / v fuse into `wqkv` columns; the MLM decoder is tied to the
    word embeddings on both sides. BertForMaskedLM carries no pooler:
    `pool_w` / `pool_b` are zeros unless the dict holds one."""
    sd = _StateDict(state_dict, "bert.", "BertForMaskedLM",
                    cfg.param_dtype, resolve_device(device), cfg.n_layers)
    base = "encoder.layer.{i}.attention.self"
    layer = "encoder.layer.{i}."
    layers = {
        "wqkv": torch.cat([sd.stack(f"{base}.{n}.weight", True)
                           for n in ("query", "key", "value")], dim=-1),
        "b_qkv": torch.cat([sd.stack(f"{base}.{n}.bias")
                            for n in ("query", "key", "value")], dim=-1),
        "wo": sd.stack(layer + "attention.output.dense.weight", True),
        "b_o": sd.stack(layer + "attention.output.dense.bias"),
        "ln1_g": sd.stack(layer + "attention.output.LayerNorm.weight"),
        "ln1_b": sd.stack(layer + "attention.output.LayerNorm.bias"),
        "w_up": sd.stack(layer + "intermediate.dense.weight", True),
        "b_up": sd.stack(layer + "intermediate.dense.bias"),
        "w_down": sd.stack(layer + "output.dense.weight", True),
        "b_down": sd.stack(layer + "output.dense.bias"),
        "ln2_g": sd.stack(layer + "output.LayerNorm.weight"),
        "ln2_b": sd.stack(layer + "output.LayerNorm.bias"),
    }
    D = cfg.dim
    dev = resolve_device(device)
    params = {
        "tok_emb": sd.get("embeddings.word_embeddings.weight"),
        "pos_emb": sd.get("embeddings.position_embeddings.weight"),
        "seg_emb": sd.get("embeddings.token_type_embeddings.weight"),
        "emb_ln_g": sd.get("embeddings.LayerNorm.weight"),
        "emb_ln_b": sd.get("embeddings.LayerNorm.bias"),
        "layers": layers,
        # the MLM head's cls.* keys carry no bert. prefix
        "mlm_dense": sd.get("cls.predictions.transform.dense.weight", True),
        "mlm_dense_b": sd.get("cls.predictions.transform.dense.bias"),
        "mlm_ln_g": sd.get("cls.predictions.transform.LayerNorm.weight"),
        "mlm_ln_b": sd.get("cls.predictions.transform.LayerNorm.bias"),
        "mlm_bias": sd.get("cls.predictions.bias"),
        "pool_w": torch.zeros((D, D), dtype=cfg.param_dtype, device=dev),
        "pool_b": torch.zeros((D,), dtype=cfg.param_dtype, device=dev),
    }
    if "pooler.dense.weight" in sd.sd:
        params["pool_w"] = sd.get("pooler.dense.weight", True)
        params["pool_b"] = sd.get("pooler.dense.bias")
    return params


def bert_from_hf(model_or_path, device: DeviceLike = None, **cfg_overrides):
    """A transformers BERT MLM model or local path -> (BertConfig,
    params)."""
    model = _load_hf("BertForMaskedLM", model_or_path)
    cfg = bert_config_from_hf(model.config, **cfg_overrides)
    return cfg, bert_params_from_hf_state_dict(model.state_dict(), cfg,
                                               device)


# ---------------------------------------------------------------------------
# CLI: one-shot migration HF checkpoint -> flash-checkpoint dir
# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    """`python -m dlrover_tpu_torch.models.convert MODEL_PATH --out DIR
    [--family llama|gpt2|bert] [--device cpu|cuda]`: import an HF
    checkpoint and save it as step 0 of a flash checkpoint (params
    only, JAX `flatten_state`'s keys), with `model_config.json` beside
    it; then train elastically against DIR."""
    import argparse
    import dataclasses
    import json
    import os
    import sys

    p = argparse.ArgumentParser(
        description="HF checkpoint -> dlrover_tpu_torch flash checkpoint")
    p.add_argument("model", help="HF model path")
    p.add_argument("--out", required=True, help="checkpoint dir")
    p.add_argument("--family", choices=["llama", "gpt2", "bert"],
                   default="llama")
    p.add_argument("--device", default=None,
                   help="where the params are built (default: the card)")
    args = p.parse_args(argv)

    fam = {"llama": from_hf, "gpt2": gpt_from_hf,
           "bert": bert_from_hf}[args.family]
    cfg, params = fam(args.model, device=args.device)
    from dlrover_tpu_torch.trainer.flash_checkpoint.engine import (
        Checkpointer,
        StorageType,
    )

    ck = Checkpointer(args.out, job_name=f"convert_{args.family}")
    try:
        ck.save_checkpoint(0, params, storage_type=StorageType.DISK)
        persisted = ck.wait_latest_checkpoint(0, timeout=600.0)
    finally:
        ck.close()
    if not persisted:
        print(f"ERROR: checkpoint did not persist to {args.out} within "
              "600s — do not delete the HF source", file=sys.stderr)
        return 1
    # the checkpoint alone must be trainable against: the config rides
    # beside it (dtypes by name, e.g. "bfloat16")
    cfg_json = {
        k: (v if isinstance(v, (int, float, bool, str))
            else str(v).removeprefix("torch."))
        for k, v in dataclasses.asdict(cfg).items()
    }
    with open(os.path.join(args.out, "model_config.json"), "w") as f:
        json.dump({"family": args.family, **cfg_json}, f, indent=2)
    from torch.utils._pytree import tree_leaves

    n = sum(x.numel() for x in tree_leaves(params))
    print(f"converted {args.family} ({n / 1e6:.1f}M params) -> {args.out} "
          "(flash checkpoint, step 0 + model_config.json)")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
