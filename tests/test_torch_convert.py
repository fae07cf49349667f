"""The port's HF converter (dlrover_tpu_torch/models/convert.py) against
`transformers` and the JAX package's converter: tiny HF models built
from a config (no download), their logits equal to the port's after
the import (atol 2e-4 / rtol 2e-3, JAX tests/test_hf_convert.py's
tolerance: HF's and the port's f32 products summed in other orders) and
to the JAX converter's on the same state dict (atol 1e-4); the export
round trip; the guards; and the CLI's flash checkpoint, loaded back by
the port's checkpoint engine.
"""

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

import jax.numpy as jnp  # noqa: E402

from dlrover_tpu.models import bert as jbert  # noqa: E402
from dlrover_tpu.models import convert as jconvert  # noqa: E402
from dlrover_tpu.models import gpt as jgpt  # noqa: E402
from dlrover_tpu.models import llama as jllama  # noqa: E402
from dlrover_tpu_torch.models import bert as tbert  # noqa: E402
from dlrover_tpu_torch.models import convert  # noqa: E402
from dlrover_tpu_torch.models import gpt as tgpt  # noqa: E402
from dlrover_tpu_torch.models import llama as tllama  # noqa: E402

HF_ATOL, HF_RTOL = 2e-4, 2e-3
JAX_ATOL = 1e-4
F32 = dict(dtype=torch.float32, param_dtype=torch.float32, remat=False)
J_F32 = dict(dtype=jnp.float32, param_dtype=jnp.float32, remat=False)
TOKENS = np.array([[3, 17, 42, 9, 101, 55], [1, 2, 3, 4, 5, 6]], np.int64)


def _llama_hf(n_kv_heads=2, tie=False):
    cfg = transformers.LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=n_kv_heads, max_position_embeddings=64,
        rms_norm_eps=1e-5, rope_theta=10000.0, tie_word_embeddings=tie,
        attn_implementation="eager")
    torch.manual_seed(7)
    return transformers.LlamaForCausalLM(cfg).eval()


def _gpt_hf():
    cfg = transformers.GPT2Config(
        vocab_size=128, n_positions=32, n_embd=48, n_layer=2, n_head=4,
        attn_pdrop=0.0, embd_pdrop=0.0, resid_pdrop=0.0)
    torch.manual_seed(11)
    return transformers.GPT2LMHeadModel(cfg).eval()


def _bert_hf():
    cfg = transformers.BertConfig(
        vocab_size=128, hidden_size=48, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=64,
        max_position_embeddings=32, type_vocab_size=2,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    torch.manual_seed(13)
    return transformers.BertForMaskedLM(cfg).eval()


def _hf_logits(hf, **kw):
    with torch.no_grad():
        return hf(torch.from_numpy(TOKENS), **kw).logits.numpy()


@pytest.mark.parametrize("n_kv_heads,tie", [(2, False), (4, True)],
                         ids=["gqa", "mha-tied"])
def test_llama_logits_equal_hf_and_jax(n_kv_heads, tie):
    hf = _llama_hf(n_kv_heads, tie)
    cfg, params = convert.from_hf(hf, device="cpu", attn_impl="reference",
                                  **F32)
    assert cfg.n_kv_heads == n_kv_heads and cfg.tie_embeddings == tie
    ours = tllama.apply(cfg, params, torch.from_numpy(TOKENS)).numpy()
    np.testing.assert_allclose(ours, _hf_logits(hf), atol=HF_ATOL,
                               rtol=HF_RTOL)
    jcfg, jparams = jconvert.from_hf(hf, attn_impl="reference", **J_F32)
    want = np.asarray(jllama.apply(jcfg, jparams, jnp.asarray(TOKENS)))
    np.testing.assert_allclose(ours, want, atol=JAX_ATOL)


def test_gpt2_logits_equal_hf_and_jax():
    hf = _gpt_hf()
    cfg, params = convert.gpt_from_hf(hf, device="cpu", **F32)
    assert (cfg.dim, cfg.n_heads, cfg.max_seq_len) == (48, 4, 32)
    ours = tgpt.apply(cfg, params, torch.from_numpy(TOKENS)).numpy()
    np.testing.assert_allclose(ours, _hf_logits(hf), atol=HF_ATOL,
                               rtol=HF_RTOL)
    jcfg, jparams = jconvert.gpt_from_hf(hf, **J_F32)
    want = np.asarray(jgpt.apply(jcfg, jparams, jnp.asarray(TOKENS)))
    np.testing.assert_allclose(ours, want, atol=JAX_ATOL)


def test_bert_mlm_logits_equal_hf_and_jax():
    hf = _bert_hf()
    cfg, params = convert.bert_from_hf(
        hf, device="cpu", dtype=torch.float32, param_dtype=torch.float32,
        attn_impl="reference")
    segs = np.zeros_like(TOKENS)
    hf_logits = _hf_logits(hf, token_type_ids=torch.from_numpy(segs))
    toks = torch.from_numpy(TOKENS)
    for segments in (torch.from_numpy(segs), None):
        hidden = tbert.apply(cfg, params, toks, segments=segments)
        ours = tbert.mlm_logits(cfg, params, hidden).numpy()
        np.testing.assert_allclose(ours, hf_logits, atol=3e-4, rtol=HF_RTOL)
    jcfg, jparams = jconvert.bert_from_hf(
        hf, dtype=jnp.float32, param_dtype=jnp.float32,
        attn_impl="reference")
    want = np.asarray(jbert.mlm_logits(jcfg, jparams, jbert.apply(
        jcfg, jparams, jnp.asarray(TOKENS))))
    np.testing.assert_allclose(ours, want, atol=JAX_ATOL)
    # no pooler in BertForMaskedLM: zeros, as JAX's
    assert not params["pool_w"].any() and not params["pool_b"].any()


@pytest.mark.parametrize("tie,seed", [(False, 3), (True, 5)],
                         ids=["untied", "tied"])
def test_export_round_trip_through_an_hf_model(tie, seed):
    """The port's random params exported INTO a fresh HF model give the
    port's logits (so a model trained here serves on an HF stack), and
    re-importing the export gives the params back exactly."""
    hf = _llama_hf(2, tie)
    cfg = convert.config_from_hf(hf.config, attn_impl="reference", **F32)
    params = tllama.init_params(cfg, torch.Generator().manual_seed(seed),
                                device="cpu")
    if tie:
        assert "lm_head" not in params
    sd = convert.to_hf_state_dict(cfg, params)
    hf.load_state_dict({k: torch.tensor(v) for k, v in sd.items()})
    ours = tllama.apply(cfg, params, torch.from_numpy(TOKENS)).numpy()
    np.testing.assert_allclose(ours, _hf_logits(hf), atol=HF_ATOL,
                               rtol=HF_RTOL)
    back = convert.params_from_hf_state_dict(sd, cfg, device="cpu")
    for k, v in back["layers"].items():
        assert torch.equal(v, params["layers"][k]), k
    with pytest.raises(ValueError, match="LoRA"):
        convert.to_hf_state_dict(cfg, dict(params, layers=dict(
            params["layers"], wq_lora_a=params["layers"]["wq"])))


def test_guards_raise():
    base = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
                num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, max_position_embeddings=64)
    for kw, match in (
        (dict(rope_scaling={"rope_type": "llama3", "factor": 8.0,
                            "low_freq_factor": 1.0,
                            "high_freq_factor": 4.0,
                            "original_max_position_embeddings": 8192}),
         "rope_scaling"),
        (dict(attention_bias=True), "attention_bias"),
        (dict(mlp_bias=True), "mlp_bias"),
        (dict(hidden_act="gelu"), "hidden_act"),
    ):
        with pytest.raises(ValueError, match=match):
            convert.config_from_hf(transformers.LlamaConfig(**base, **kw))
    assert convert.config_from_hf(transformers.LlamaConfig(**base)).dim == 64
    with pytest.raises(ValueError, match="activation_function"):
        convert.gpt_config_from_hf(transformers.GPT2Config(
            n_embd=48, n_layer=2, n_head=4, activation_function="relu"))
    with pytest.raises(ValueError, match="n_inner"):
        convert.gpt_config_from_hf(transformers.GPT2Config(
            n_embd=48, n_layer=2, n_head=4, n_inner=100))
    with pytest.raises(ValueError, match="hidden_act"):
        convert.bert_config_from_hf(transformers.BertConfig(
            hidden_act="relu"))
    with pytest.raises(ValueError, match="position_embedding_type"):
        convert.bert_config_from_hf(transformers.BertConfig(
            position_embedding_type="relative_key"))
    hf = _llama_hf()
    sd = dict(hf.state_dict())
    sd.pop("model.layers.1.mlp.up_proj.weight")
    with pytest.raises(KeyError, match="up_proj"):
        convert.params_from_hf_state_dict(
            sd, convert.config_from_hf(hf.config), device="cpu")


def test_cli_writes_a_flash_checkpoint_the_port_loads(tmp_path,
                                                      monkeypatch):
    """The migration entry point: an HF directory -> step 0 of a flash
    checkpoint (JAX `flatten_state`'s keys) and model_config.json; the
    port's Checkpointer loads the params back bit for bit."""
    import json
    import shutil
    import tempfile

    from dlrover_tpu_torch.trainer.flash_checkpoint.engine import (
        Checkpointer,
    )

    # the CLI's job name is fixed: its socket and segment go to dirs of
    # this test's own (a short one for the socket path's length limit)
    (tmp_path / "shm").mkdir()
    monkeypatch.setenv("DLROVER_TPU_SHM_DIR", str(tmp_path / "shm"))
    sock = tempfile.mkdtemp(prefix="cv")
    monkeypatch.setenv("DLROVER_TPU_SOCK_DIR", sock)
    hf_dir = tmp_path / "hf"
    hf = _gpt_hf()
    hf.save_pretrained(str(hf_dir))
    out = tmp_path / "ckpt"
    rc = convert.main([str(hf_dir), "--out", str(out), "--family", "gpt2",
                       "--device", "cpu"])
    assert rc == 0
    meta = json.loads((out / "model_config.json").read_text())
    assert meta["family"] == "gpt2" and meta["dim"] == 48
    assert meta["dtype"] == "bfloat16"
    ck = Checkpointer(str(out), job_name="test_torch_cli_load")
    try:
        step, state = ck.load_checkpoint(device="cpu")
    finally:
        ck.close()
    assert step == 0
    _, want = convert.gpt_from_hf(hf, device="cpu")
    assert sorted(state) == sorted(want)
    for k in ("wte", "wpe", "lnf_g"):
        assert torch.equal(state[k], want[k]), k
    for k, v in want["layers"].items():
        assert torch.equal(state["layers"][k], v), k
    shutil.rmtree(sock, ignore_errors=True)
