"""PyTorch port's weight_quant="int8" serving (dlrover_tpu_torch/
serving/engine.py `_quantize_params` + the models' `matmul_any`)
against the JAX package's int8 engine on the same params.

f32 compute (the tiny config with dtype=float32): both engines quantize
the same f32 values, so every installed q8 / s8 must be byte-equal, the
weight byte counts equal, and the greedy token streams EXACTLY equal in
the dense and paged layouts, with and without the int8 KV cache. (The
random-init tiny model gives equal streams here; no trained fixture is
needed.)

bf16 compute (the main path's precision): the JAX engine quantizes its
f32-stored params, so the port stores them in f32 too
(`params_from_numpy(..., dtype=float32)`) and installs the same bytes;
its first logits are held to the JAX engine's within 2^-6 of the
largest logit (bf16 activations rounded in other orders), and greedy
streams are not compared (bf16 near-ties)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.models import llama as jllama
from dlrover_tpu.serving.engine import ContinuousBatcher as JaxBatcher
from dlrover_tpu_torch.models import llama as tllama
from dlrover_tpu_torch.ops.quantization import QuantizedWeight
from dlrover_tpu_torch.serving import engine as teng

ENGINE = dict(n_slots=3, max_len=64, max_new_tokens=10, chunk=4)
BF16_LOGIT_RTOL = 2 ** -6
LENGTHS = (3, 5, 20, 7, 12, 9, 33)
QUANTIZED = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype=jnp.float32)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    tcfg = tllama.LlamaConfig.tiny(dtype=torch.float32)
    tparams = tllama.params_from_numpy(tcfg, tree, device="cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(1)
    return [rng.integers(1, 250, size=n).tolist() for n in LENGTHS]


def _streams(engine, prompts):
    return [list(map(int, r)) for r in engine.generate_all(prompts)]


def _port(model, **kw):
    _, _, tcfg, tparams = model
    return teng.ContinuousBatcher(tcfg, tparams, device="cpu", **ENGINE, **kw)


def _jax(model, **kw):
    jcfg, jparams, _, _ = model
    return JaxBatcher(jcfg, jparams, **ENGINE, **kw)


def test_installed_tree_bytes_equal_jax(model):
    jeng = _jax(model, weight_quant="int8")
    teng_ = _port(model, weight_quant="int8")
    jl, tl = jeng.params["layers"], teng_.params["layers"]
    for name in QUANTIZED:
        tw, jw = tl[name], jl[name]
        assert isinstance(tw, QuantizedWeight), name
        assert tw.block == jw.block and tw.shape == tuple(jw.shape)
        assert tw.q8.dtype == torch.int8 and tw.s8.dtype == torch.float32
        assert tw.q8.numpy().tobytes() == np.asarray(jw.q8).tobytes(), name
        assert tw.s8.numpy().tobytes() == np.asarray(jw.s8).tobytes(), name
    th, jh = (e.params["lm_head"]["weight"] for e in (teng_, jeng))
    assert isinstance(th, QuantizedWeight)
    assert th.q8.numpy().tobytes() == np.asarray(jh.q8).tobytes()
    assert th.s8.numpy().tobytes() == np.asarray(jh.s8).tobytes()
    # norms and the embedding stay dense
    assert not isinstance(tl["attn_norm"], QuantizedWeight)
    assert torch.is_tensor(teng_.params["embed"]["weight"])
    assert teng_.weight_bytes_device() == jeng.weight_bytes_device()
    assert teng_.weight_quant_path == jeng.weight_quant_path
    assert teng_.weight_quant_path == "int8:reference"
    assert teng_.weight_quant_stats() == jeng.weight_quant_stats()
    assert teng_.weight_quant_stats()["weight_quant_leaves"] == 8.0


@pytest.mark.parametrize("kv_quant", [False, True], ids=["f32kv", "int8kv"])
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_int8_greedy_streams_equal_jax(model, prompts, layout, kv_quant):
    kw = dict(weight_quant="int8", kv_layout=layout, kv_quant=kv_quant)
    want = _streams(_jax(model, **kw), prompts)
    got = _streams(_port(model, **kw), prompts)
    assert got == want
    assert all(len(s) == ENGINE["max_new_tokens"] for s in got)


def test_int8_serves_the_quantized_weights(model, prompts):
    """The int8 engine really serves the quantized weights: its first
    logits differ from the f32 engine's (the streams may or may not)."""
    from dlrover_tpu_torch.models import decode as tdec

    _, _, tcfg, tparams = model
    q = _port(model, weight_quant="int8")
    tok = torch.tensor([prompts[0]])
    cache = tdec.init_kv_cache(tcfg, 1, 16, device="cpu")
    dense, _ = tdec.prefill(tcfg, tparams, tok, cache)
    cache = tdec.init_kv_cache(tcfg, 1, 16, device="cpu")
    quant, _ = tdec.prefill(tcfg, q.params, tok, cache)
    assert not torch.equal(dense, quant)
    assert torch.allclose(dense, quant, atol=0.1)


def test_none_leaves_params_untouched(model, prompts):
    _, _, _, tparams = model
    eng = _port(model, weight_quant="none")
    assert eng.params is tparams
    assert eng.weight_quant_path == "none"
    assert eng.weight_quant_stats()["weight_quant_int8"] == 0.0
    want = _streams(_jax(model), prompts)
    assert _streams(eng, prompts) == want
    assert _streams(_port(model), prompts) == want


def test_weight_quant_knob_validation(model):
    with pytest.raises(ValueError, match="weight_quant"):
        _port(model, weight_quant="int4")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _port(model, weight_quant="int8_stochastic")


def test_quantize_is_idempotent_and_leaves_caller_tree(model):
    _, _, _, tparams = model
    eng = _port(model, weight_quant="int8")
    again = eng._quantize_params(eng.params)
    for name in QUANTIZED:
        assert again["layers"][name] is eng.params["layers"][name]
    head = eng.params["lm_head"]["weight"]
    assert again["lm_head"]["weight"] is head
    assert eng._wq_stats == {"leaves": 8, "skipped": 0}
    # the caller's tree still holds its dense weights
    assert all(torch.is_tensor(tparams["layers"][n]) for n in QUANTIZED)
    assert torch.is_tensor(tparams["lm_head"]["weight"])


def test_unquantizable_k_stays_dense(model):
    """A weight whose contraction dim has no power-of-two block >= 8
    is skipped and counted, as in the JAX engine."""
    _, _, tcfg, tparams = model
    odd = dict(tparams)
    odd["layers"] = dict(tparams["layers"])
    odd["layers"]["wo"] = torch.zeros((tcfg.n_layers, 6, tcfg.dim))
    eng = teng.ContinuousBatcher(tcfg, odd, device="cpu",
                                 weight_quant="int8", **ENGINE)
    assert eng.params["layers"]["wo"] is odd["layers"]["wo"]
    assert eng._wq_stats == {"leaves": 7, "skipped": 1}


def test_stored_dtype_follows_the_argument(model):
    jcfg, jparams, _, _ = model
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    bcfg = tllama.LlamaConfig.tiny()          # bf16 compute
    stored = tllama.params_from_numpy(bcfg, tree, device="cpu")
    wide = tllama.params_from_numpy(bcfg, tree, device="cpu",
                                    dtype=torch.float32)
    assert stored["layers"]["wq"].dtype == torch.bfloat16
    assert wide["layers"]["wq"].dtype == torch.float32
    np.testing.assert_array_equal(
        wide["layers"]["wq"].numpy(), np.asarray(jparams["layers"]["wq"])
    )


def _assert_trees_bytes_equal(tparams, jparams):
    for name in QUANTIZED:
        tw, jw = tparams["layers"][name], jparams["layers"][name]
        assert tw.q8.numpy().tobytes() == np.asarray(jw.q8).tobytes(), name
        assert tw.s8.numpy().tobytes() == np.asarray(jw.s8).tobytes(), name
    th, jh = (p["lm_head"]["weight"] for p in (tparams, jparams))
    assert th.q8.numpy().tobytes() == np.asarray(jh.q8).tobytes()
    assert th.s8.numpy().tobytes() == np.asarray(jh.s8).tobytes()


def test_bf16_engine_installs_the_jax_bytes_from_f32_storage():
    """bf16 compute, as Llama-3-8B serves: with f32 storage the port's
    int8 install equals the JAX engine's byte for byte, and so do the
    weight bytes; bf16 storage (the default) would quantize rounded
    values and give other bytes. The first logits of the two int8
    trees then agree to bf16 precision."""
    from dlrover_tpu.models import decode as jdec
    from dlrover_tpu_torch.models import decode as tdec

    jcfg = jllama.LlamaConfig.tiny()               # bf16, f32 params
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    bcfg = tllama.LlamaConfig.tiny()
    wide = tllama.params_from_numpy(bcfg, tree, device="cpu",
                                    dtype=torch.float32)
    jeng = JaxBatcher(jcfg, jparams, weight_quant="int8", **ENGINE)
    teng_ = teng.ContinuousBatcher(bcfg, wide, device="cpu",
                                   weight_quant="int8", **ENGINE)
    _assert_trees_bytes_equal(teng_.params, jeng.params)
    assert teng_.weight_bytes_device() == jeng.weight_bytes_device()

    narrow = teng.ContinuousBatcher(
        bcfg, tllama.params_from_numpy(bcfg, tree, device="cpu"),
        device="cpu", weight_quant="int8", **ENGINE,
    )
    assert (narrow.params["layers"]["wq"].q8.numpy().tobytes()
            != np.asarray(jeng.params["layers"]["wq"].q8).tobytes())

    tokens = np.random.default_rng(0).integers(1, 250, size=(2, 16))
    jl, _ = jdec.prefill(jcfg, jeng.params, jnp.asarray(tokens, jnp.int32),
                         jdec.init_kv_cache(jcfg, 2, 32))
    tl, _ = tdec.prefill(bcfg, teng_.params, torch.from_numpy(tokens),
                         tdec.init_kv_cache(bcfg, 2, 32, device="cpu"))
    want = np.asarray(jl.astype(jnp.float32))
    np.testing.assert_allclose(
        tl.float().numpy(), want, rtol=0,
        atol=BF16_LOGIT_RTOL * float(np.abs(want).max()),
    )
