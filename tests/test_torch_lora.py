"""The port's LoRA module (dlrover_tpu_torch/models/lora.py) and the
model's LoRA merge site against the JAX package, on the same trees.

JAX's injected tree is carried across as numpy (`params_from_numpy`
takes its `_lora_` leaves along) instead of matching the two RNGs.
Tolerances: the adapter-only and loaded trees are held bit-equal (they
move arrays, nothing is computed); a merged leaf within 1e-6 relative
and absolute of JAX's (the same f32 values, the rank-4 f32 product A@B
summed in another order); f32 logits within 1e-5 (as JAX's own merge
test: the delta enters the weight in one sum order here, another there,
carried through 2 layers); bf16-compute logits within 2^-6 of the
largest |logit| (both round the merged weight to bf16 at the same
points, but the bf16 products accumulate in another order)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.models import llama as jllama
from dlrover_tpu.models import lora as jlora
from dlrover_tpu_torch.models import llama as tllama
from dlrover_tpu_torch.models import lora as tlora


def _jcfg(dtype=jnp.float32):
    return dataclasses.replace(jllama.LlamaConfig.tiny(), dtype=dtype)


def _tcfg(dtype=torch.float32, **kw):
    return tllama.LlamaConfig.tiny(dtype=dtype, **kw)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _to_torch(tree):
    """A nested dict of numpy arrays -> the same dict of f32 tensors."""
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True))


@pytest.fixture(scope="module")
def adapted():
    """JAX's (cfg, params) with wq / wv adapters of rank 4, alpha 8, and
    non-zero B (inject zeroes B, so the delta would be zero)."""
    cfg = _jcfg()
    params = jllama.init_params(cfg, jax.random.PRNGKey(0))
    lcfg, p = jlora.inject(cfg, params, jlora.LoraConfig(rank=4, alpha=8.0),
                           jax.random.PRNGKey(1))
    layers = dict(p["layers"])
    for i, t in enumerate(("wq", "wv", "wo")):
        layers[t + "_lora_b"] = jax.random.normal(
            jax.random.PRNGKey(3 + i), layers[t + "_lora_b"].shape) * 0.05
    p = dict(p)
    p["layers"] = layers
    return lcfg, p


def _tokens(b=4, s=17, seed=2):
    return np.random.default_rng(seed).integers(0, 256, size=(b, s))


def test_merge_matches_jax(adapted):
    jcfg, jp = adapted
    want = _np(jlora.merge(jcfg, jp))
    got = tlora.merge(_tcfg(lora_alpha=8.0), _to_torch(_np(jp)))
    assert sorted(got["layers"]) == sorted(want["layers"])
    assert not any("_lora_" in k for k in got["layers"])
    for k, w in want["layers"].items():
        np.testing.assert_allclose(got["layers"][k].numpy(), w,
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(got["embed"]["weight"].numpy(),
                                  want["embed"]["weight"])


def test_adapter_state_dict_matches_jax(adapted):
    _, jp = adapted
    want = _np(jlora.adapter_state_dict(jp))
    got = tlora.adapter_state_dict(_to_torch(_np(jp)))
    assert list(got) == ["layers"]
    assert sorted(got["layers"]) == sorted(want["layers"])
    for k, w in want["layers"].items():
        np.testing.assert_array_equal(got["layers"][k].numpy(), w)


def test_load_adapters_matches_jax(adapted):
    jcfg, jp = adapted
    base = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    sd = jlora.adapter_state_dict(jp)
    want = _np(jlora.load_adapters(base, sd))
    tbase = _to_torch(_np(base))
    got = tlora.load_adapters(tbase, _to_torch(_np(sd)))
    assert sorted(got["layers"]) == sorted(want["layers"])
    for k, w in want["layers"].items():
        np.testing.assert_array_equal(got["layers"][k].numpy(), w)
    # the caller's tree is not modified
    assert not any("_lora_" in k for k in tbase["layers"])


@pytest.mark.parametrize("bad,match", [
    ({"wq": np.zeros((2, 64, 64), np.float32)}, "not an adapter leaf"),
    ({"w_q_lora_a": np.zeros((2, 64, 4), np.float32)}, "no base weight"),
])
def test_load_adapters_rejections_match_jax(adapted, bad, match):
    jcfg, _ = adapted
    base = _np(jllama.init_params(jcfg, jax.random.PRNGKey(0)))
    with pytest.raises(KeyError, match=match):
        jlora.load_adapters(base, {"layers": bad})
    with pytest.raises(KeyError, match=match):
        tlora.load_adapters(_to_torch(base), {"layers": _to_torch(bad)})


def _stray(layers):
    layers["w_q_lora_a"] = layers.pop("wq_lora_a")
    layers["w_q_lora_b"] = layers.pop("wq_lora_b")


def _half(layers):
    del layers["wv_lora_b"]


@pytest.mark.parametrize("break_it,match", [
    (_stray, "no base weight"), (_half, "missing its pair"),
], ids=["stray_leaf", "half_pair"])
def test_merge_rejections_match_jax(adapted, break_it, match):
    """A typo'd target renamed by hand and half an A/B pair must fail
    loudly in both packages (JAX tests/test_lora.py :115, :125)."""
    jcfg, jp = adapted
    layers = dict(_np(jp)["layers"])
    break_it(layers)
    with pytest.raises(KeyError, match=match):
        jlora.merge(jcfg, {**_np(jp), "layers": layers})
    with pytest.raises(KeyError, match=match):
        tlora.merge(_tcfg(lora_alpha=8.0),
                    {**_to_torch(_np(jp)), "layers": _to_torch(layers)})


def test_inject_shapes_and_keys():
    cfg = _tcfg()
    params = tllama.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu", dtype=torch.float32)
    lc = tlora.LoraConfig(rank=4, alpha=8.0, targets=("wq", "wo", "w_up"))
    lcfg, p = tlora.inject(cfg, params, lc, torch.Generator().manual_seed(1))
    jcfg = _jcfg()
    _, jp = jlora.inject(jcfg, jllama.init_params(jcfg, jax.random.PRNGKey(0)),
                         jlora.LoraConfig(rank=4, alpha=8.0,
                                          targets=("wq", "wo", "w_up")),
                         jax.random.PRNGKey(1))
    want = {k: tuple(v.shape) for k, v in jp["layers"].items()}
    assert {k: tuple(v.shape) for k, v in p["layers"].items()} == want
    assert lcfg.lora_alpha == 8.0
    # base weights are the same objects: injection copies nothing
    assert p["layers"]["wq"] is params["layers"]["wq"]
    for t in lc.targets:
        assert not p["layers"][t + "_lora_b"].any()
        a = p["layers"][t + "_lora_a"]
        assert a.dtype == torch.float32
        # A ~ N(0, 1/r): std 0.5 at r = 4 over >= 512 draws
        assert abs(float(a.std()) - 0.5) < 0.1
    # B = 0: the injected model computes exactly the base model
    tok = torch.from_numpy(_tokens())
    np.testing.assert_array_equal(tllama.apply(lcfg, params, tok).numpy(),
                                  tllama.apply(lcfg, p, tok).numpy())


@pytest.mark.parametrize("targets,exc", [
    (("nope",), KeyError), (("attn_norm",), ValueError),
])
def test_inject_bad_target_raises_as_jax(targets, exc):
    jcfg = _jcfg()
    with pytest.raises(exc):
        jlora.inject(jcfg, jllama.init_params(jcfg, jax.random.PRNGKey(0)),
                     jlora.LoraConfig(rank=2, targets=targets),
                     jax.random.PRNGKey(1))
    cfg = _tcfg()
    params = tllama.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    with pytest.raises(exc):
        tlora.inject(cfg, params, tlora.LoraConfig(rank=2, targets=targets),
                     torch.Generator().manual_seed(1))


@pytest.mark.parametrize("kw,exc", [
    (dict(rank=0), ValueError), (dict(rank=2, dropout=0.1),
                                 NotImplementedError),
])
def test_lora_config_rejects_as_jax(kw, exc):
    with pytest.raises(exc):
        jlora.LoraConfig(**kw)
    with pytest.raises(exc):
        tlora.LoraConfig(**kw)


def test_apply_with_lora_leaves_matches_jax_and_merged(adapted):
    """llama.apply with `_lora_` leaves (the merge inside
    `_compute_weights`) against JAX's apply on the same tree, and
    against the port's apply on `lora.merge`'s tree."""
    jcfg, jp = adapted
    tok = _tokens()
    want = np.asarray(jllama.apply(jcfg, jp, jnp.asarray(tok)))
    tcfg = _tcfg(lora_alpha=8.0)
    tp = tllama.params_from_numpy(tcfg, _np(jp), device="cpu")
    assert "wq_lora_a" in tp["layers"]
    got = tllama.apply(tcfg, tp, torch.from_numpy(tok)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    merged = tllama.apply(tcfg, tlora.merge(tcfg, tp),
                          torch.from_numpy(tok)).numpy()
    np.testing.assert_allclose(got, merged, atol=1e-5, rtol=1e-5)


def test_apply_with_lora_leaves_bf16_matches_jax(adapted):
    """The same in bf16 compute: the merged weight W + (alpha/r) A@B is
    formed in bf16 on both sides (the scale rounded to bf16 first)."""
    jcfg, jp = adapted
    jcfg = dataclasses.replace(jcfg, dtype=jnp.bfloat16)
    tok = _tokens()
    want = np.asarray(jllama.apply(jcfg, jp, jnp.asarray(tok)), np.float32)
    tcfg = _tcfg(dtype=torch.bfloat16, lora_alpha=8.0)
    tp = tllama.params_from_numpy(tcfg, _np(jp), device="cpu",
                                  dtype=torch.float32)
    got = tllama.apply(tcfg, tp, torch.from_numpy(tok)).float().numpy()
    tol = 2 ** -6 * np.abs(want).max()
    assert np.abs(got - want).max() <= tol
