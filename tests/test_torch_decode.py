"""PyTorch port's Llama decoder (dlrover_tpu_torch/models/llama.py,
models/decode.py) against the JAX package on the same params: the JAX
tiny tree is carried across with `params_from_numpy`, inputs are drawn
with numpy, and prefill / decode_step / paged_decode_step logits and
the cache / pool they write are compared.

f32 (LlamaConfig.tiny with dtype=float32, as tests/test_serving_paged.py
uses it): logits atol 1e-4 (two layers of f32 matmuls summed in other
orders), cache contents atol 1e-5; int8 cache bytes must be EQUAL
(same f32 values, round-half-to-even on both sides)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.models import decode as jdec
from dlrover_tpu.models import llama as jllama
from dlrover_tpu_torch.models import decode as tdec
from dlrover_tpu_torch.models import llama as tllama

LOGIT_ATOL = 1e-4
CACHE_ATOL = 1e-5


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype=jnp.float32)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    tcfg = tllama.LlamaConfig.tiny(dtype=torch.float32)
    tparams = tllama.params_from_numpy(tcfg, tree, device="cpu")
    return jcfg, jparams, tcfg, tparams, tree


def _cmp_cache(jc, tc):
    for name in jc:
        want = np.asarray(jnp.asarray(jc[name]).astype(jnp.float32)) \
            if name.endswith("_scale") else np.asarray(jc[name])
        got = tc[name].float().numpy() if name.endswith("_scale") \
            else tc[name].numpy()
        if want.dtype == np.int8 or name.endswith("_scale"):
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            np.testing.assert_allclose(got, want, atol=CACHE_ATOL, err_msg=name)


def test_params_from_numpy_round_trip(model):
    _, _, tcfg, tparams, tree = model
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert len(flat) == 12
    for path, leaf in flat:
        node = tparams
        for key in path:
            node = node[key.key]
        assert node.dtype == torch.float32
        np.testing.assert_array_equal(node.numpy(), leaf)
    assert tllama.num_params(tcfg) == sum(l.size for _, l in flat)
    # bf16 storage rounds exactly as jnp's astype does
    bcfg = tllama.LlamaConfig.tiny()
    bparams = tllama.params_from_numpy(bcfg, tree, device="cpu")
    want = np.asarray(
        jnp.asarray(tree["layers"]["wq"]).astype(jnp.bfloat16)
        .astype(jnp.float32)
    )
    np.testing.assert_array_equal(
        bparams["layers"]["wq"].float().numpy(), want
    )


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_prefill_and_decode_step_match_jax(model, quant):
    jcfg, jparams, tcfg, tparams, _ = model
    rng = np.random.default_rng(0)
    tokens = rng.integers(1, 250, size=(2, 16)).astype(np.int32)
    jcache = jdec.init_kv_cache(jcfg, 2, 32, quant=quant)
    tcache = tdec.init_kv_cache(tcfg, 2, 32, quant=quant, device="cpu")
    jl, jcache = jdec.prefill(jcfg, jparams, jnp.asarray(tokens), jcache)
    tl, tcache = tdec.prefill(
        tcfg, tparams, torch.from_numpy(tokens).long(), tcache
    )
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL)
    _cmp_cache(jcache, tcache)
    # per-row positions, one of them rewriting an earlier cell
    tok = rng.integers(1, 250, size=2).astype(np.int32)
    pos = np.array([16, 9], np.int32)
    jl, jcache = jdec.decode_step(
        jcfg, jparams, jnp.asarray(tok), jcache, jnp.asarray(pos)
    )
    tl, tcache = tdec.decode_step(
        tcfg, tparams, torch.from_numpy(tok).long(), tcache,
        torch.from_numpy(pos).long(),
    )
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL)
    _cmp_cache(jcache, tcache)
    # scalar position (the lockstep path)
    jl, jcache = jdec.decode_step(jcfg, jparams, jnp.asarray(tok), jcache, 17)
    tl, tcache = tdec.decode_step(
        tcfg, tparams, torch.from_numpy(tok).long(), tcache, 17
    )
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL)
    _cmp_cache(jcache, tcache)


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_paged_decode_step_matches_jax(model, quant):
    """A random pool and table (live pages, stale pages, trash rows),
    one paged step on both sides: logits and every pool byte."""
    jcfg, jparams, tcfg, tparams, _ = model
    rng = np.random.default_rng(1)
    n_pages, ps = 11, 8
    shape = (tcfg.n_layers, n_pages, ps, tcfg.n_kv_heads, tcfg.head_dim)
    pool = {}
    for n in ("k", "v"):
        if quant:
            pool[n] = rng.integers(-127, 128, size=shape).astype(np.int8)
            s = rng.uniform(0.001, 0.05, size=shape[:-1] + (1,))
            pool[n + "_scale"] = np.array(
                jnp.asarray(s, jnp.float32).astype(jnp.bfloat16)
                .astype(jnp.float32)
            )
        else:
            pool[n] = rng.standard_normal(shape).astype(np.float32)
    table = np.array([[3, 7, 1, 0], [5, 2, 0, 0], [0, 0, 0, 0]], np.int32)
    pos = np.array([19, 8, 4], np.int32)   # row 2 parked on trash
    tok = rng.integers(1, 250, size=3).astype(np.int32)
    jpool = {
        n: jnp.asarray(a).astype(jnp.bfloat16) if n.endswith("_scale")
        else jnp.asarray(a) for n, a in pool.items()
    }
    tpool = {
        n: torch.from_numpy(a.copy()).to(torch.bfloat16)
        if n.endswith("_scale") else torch.from_numpy(a.copy())
        for n, a in pool.items()
    }
    jl, jpool = jdec.paged_decode_step(
        jcfg, jparams, jnp.asarray(tok), jpool, jnp.asarray(table),
        jnp.asarray(pos),
    )
    for impl in ("reference", "auto"):
        cfg = dataclasses.replace(tcfg, attn_impl=impl)
        tp = {n: a.clone() for n, a in tpool.items()}
        tl, tp = tdec.paged_decode_step(
            cfg, tparams, torch.from_numpy(tok).long(), tp,
            torch.from_numpy(table), torch.from_numpy(pos).long(),
        )
        np.testing.assert_allclose(
            tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL, err_msg=impl
        )
        _cmp_cache(jpool, tp)


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_admission_rows_match_jax(model, quant):
    """prefill_into_slot (dense) and prefill_exact_row +
    paged_install_row (paged) write the same bytes as the JAX
    package's admission primitives."""
    jcfg, jparams, tcfg, tparams, _ = model
    rng = np.random.default_rng(2)
    prompt = np.zeros(16, np.int32)
    prompt[:11] = rng.integers(1, 250, size=11)   # pad tail
    jcache = jdec.init_kv_cache(jcfg, 3, 32, quant=quant)
    tcache = tdec.init_kv_cache(tcfg, 3, 32, quant=quant, device="cpu")
    jcache = jdec.prefill_into_slot(
        jcfg, jparams, jnp.asarray(prompt), jcache, 1
    )
    tdec.prefill_into_slot(
        tcfg, tparams, torch.from_numpy(prompt).long(), tcache, 1
    )
    _cmp_cache(jcache, tcache)

    table_row = np.array([4, 2, 0, 0], np.int32)
    jrow = jdec.prefill_exact_row(jcfg, jparams, jnp.asarray(prompt), 32)
    trow = tdec.prefill_exact_row(
        tcfg, tparams, torch.from_numpy(prompt).long(), 32
    )
    _cmp_cache(jrow, trow)
    jpool = jdec.init_page_pool(jcfg, 6, 8, quant=quant)
    tpool = tdec.init_page_pool(tcfg, 6, 8, quant=quant, device="cpu")
    jpool = jdec.paged_install_row(
        jpool, jrow, jnp.asarray(table_row), 0, 16
    )
    tdec.paged_install_row(tpool, trow, torch.from_numpy(table_row), 0, 16)
    _cmp_cache(jpool, tpool)


def test_kv_quantize_bytes_match_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 8, 2, 32)).astype(np.float32)
    x[0, 0, 0] = 0.0                          # all-zero vector: 1e-8 floor
    x[1, 1, 1, :4] = [127.0, 63.5, -0.5, 1.5]  # exact .5 ties
    jq, js = jdec._kv_quantize(jnp.asarray(x))
    tq, ts = tdec._kv_quantize(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("start", [0, 5, 30, -3])
def test_cache_write_clamps_like_dynamic_update_slice(start):
    rng = np.random.default_rng(4)
    arr = rng.standard_normal((2, 32, 3)).astype(np.float32)
    upd = rng.standard_normal((2, 4, 3)).astype(np.float32)
    want = jdec._cache_write(jnp.asarray(arr), jnp.asarray(upd), start)
    got = tdec._cache_write(
        torch.from_numpy(arr.copy()), torch.from_numpy(upd), start
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    starts = np.array([start, 31], np.int32)
    want = jdec._cache_write(
        jnp.asarray(arr), jnp.asarray(upd), jnp.asarray(starts)
    )
    got = tdec._cache_write(
        torch.from_numpy(arr.copy()), torch.from_numpy(upd),
        torch.from_numpy(starts).long(),
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_masks_and_rms_rope_match_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 300, size=(2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        tllama._rope(torch.from_numpy(x), torch.from_numpy(pos), 500000.0)
        .numpy(),
        np.asarray(jllama._rope(jnp.asarray(x), jnp.asarray(pos), 500000.0)),
        atol=1e-5,
    )
    h = rng.standard_normal((2, 5, 64)).astype(np.float32)
    sc = rng.standard_normal(64).astype(np.float32)
    np.testing.assert_allclose(
        tllama._rms_norm(torch.from_numpy(h), torch.from_numpy(sc), 1e-5)
        .numpy(),
        np.asarray(jllama._rms_norm(jnp.asarray(h), jnp.asarray(sc), 1e-5)),
        atol=1e-6,
    )


def test_init_params_layout_and_device():
    cfg = tllama.LlamaConfig.tiny(dtype=torch.float32)
    g = torch.Generator().manual_seed(0)
    p = tllama.init_params(cfg, g, device="cpu")
    assert p["layers"]["wq"].shape == (2, 64, 64)
    assert p["layers"]["wk"].shape == (2, 64, 32)
    assert p["layers"]["w_down"].shape == (2, 128, 64)
    assert p["lm_head"]["weight"].shape == (64, 256)
    p2 = tllama.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(p["layers"]["w_up"], p2["layers"]["w_up"])
    with pytest.raises(NotImplementedError):
        tllama.init_params(
            tllama.LlamaConfig.tiny(n_experts=4), g, device="cpu"
        )
