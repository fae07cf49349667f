"""PyTorch port's ContinuousBatcher (dlrover_tpu_torch/serving/engine.py)
against the JAX package's on the same params.

Greedy token streams must be EXACTLY equal — dense and paged layouts,
with and without the int8 KV cache — under mixed prompt lengths, more
requests than slots, per-request max_new caps and an eos stop. In the
port, as in JAX, paged == dense holds byte for byte.

Sampled streams cannot match the JAX engine: it draws with threefry
keys, the port with one torch.Generator (Philox / mt19937) per request.
So sampling is held to three other things: the same seed gives the
same tokens (and the two layouts agree), the top-k / top-p masks equal
the JAX masks on the same logits, and the draws follow the warped
softmax probabilities (a frequency test on a small vocab)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.models import decode as jdec
from dlrover_tpu.models import llama as jllama
from dlrover_tpu.serving.engine import ContinuousBatcher as JaxBatcher
from dlrover_tpu_torch._device import resolve_device
from dlrover_tpu_torch.models import decode as tdec
from dlrover_tpu_torch.models import llama as tllama
from dlrover_tpu_torch.serving import engine as teng

ENGINE = dict(n_slots=3, max_len=64, max_new_tokens=10, chunk=4)
LENGTHS = (3, 5, 20, 7, 12, 9, 33)
CAPS = (None, 4, None, 7, None, None, 2)   # per-request max_new


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


def _serve(engine, prompts):
    for p, cap in zip(prompts, CAPS):
        engine.submit(p, max_new=cap)
    return [list(map(int, r)) for r in engine.generate_all([])]


def _port(model, prompts, **kw):
    _, _, tcfg, tparams = model
    eng = teng.ContinuousBatcher(tcfg, tparams, device="cpu", **ENGINE, **kw)
    return eng, _serve(eng, prompts)


@pytest.fixture(scope="module")
def eos_id(model, prompts):
    """An eos that really fires: the third token of request 0's greedy
    stream (chosen from the port's own run; both engines then stop on
    it)."""
    _, out = _port(model, prompts)
    tok = out[0][2]
    assert tok != 0
    return tok


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_greedy_streams_equal_jax(model, prompts, eos_id, layout, quant):
    jcfg, jparams, _, _ = model
    kw = dict(kv_layout=layout, kv_quant=quant, eos_id=eos_id)
    want = _serve(JaxBatcher(jcfg, jparams, **ENGINE, **kw), prompts)
    eng, got = _port(model, prompts, **kw)
    assert got == want
    # the caps and the eos really shaped the streams
    assert got[0][-1] == eos_id and len(got[0]) <= 3
    assert len(got[6]) <= 2 and len(got[1]) <= 4
    assert eng.admissions == len(prompts) and eng.decode_steps > 0
    if layout == "paged":
        _, dense = _port(model, prompts, kv_layout="dense", kv_quant=quant,
                         eos_id=eos_id)
        assert got == dense   # paged == dense, byte for byte
        eng.allocator.check()
        assert eng.allocator.free_pages == eng.allocator.capacity


def test_sampled_same_seed_same_tokens(model, prompts):
    kw = dict(temperature=0.8, top_k=20, top_p=0.9)
    _, a = _port(model, prompts, seed=3, **kw)
    _, b = _port(model, prompts, seed=3, **kw)
    _, paged = _port(model, prompts, seed=3, kv_layout="paged", **kw)
    _, other = _port(model, prompts, seed=4, **kw)
    assert a == b == paged
    assert a != other


@pytest.mark.parametrize("k", [1, 5, 17])
def test_mask_top_k_equals_jax(k):
    rng = np.random.default_rng(k)
    logits = rng.standard_normal((4, 50)).astype(np.float32)
    logits[0, :6] = 2.5   # ties at the boundary all survive
    want = np.asarray(jdec._mask_top_k(jnp.asarray(logits), k))
    got = tdec._mask_top_k(torch.from_numpy(logits), k).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("p", [0.1, 0.5, 0.9, 1.0])
def test_mask_top_p_equals_jax(p):
    rng = np.random.default_rng(int(p * 10))
    logits = (rng.standard_normal((4, 50)) * 3).astype(np.float32)
    logits[1] = 0.0   # flat row: the whole vocab ties
    want = np.asarray(jdec._mask_top_p(jnp.asarray(logits), p))
    got = tdec._mask_top_p(torch.from_numpy(logits), p).numpy()
    np.testing.assert_array_equal(got, want)


def test_sampling_frequencies_follow_warped_softmax(model):
    """4000 draws over a 6-token vocab with temperature 0.7, top_k 4,
    top_p 0.95: each token's frequency is within 5 standard errors of
    its warped softmax probability, and masked tokens never appear."""
    _, _, tcfg, tparams = model
    eng = teng.ContinuousBatcher(
        tcfg, tparams, n_slots=1, max_len=16, temperature=0.7, top_k=4,
        top_p=0.95, device="cpu",
    )
    logits = torch.tensor([[1.0, 0.2, -0.5, 2.0, 0.9, -3.0]])
    warped = tdec._mask_top_p(tdec._mask_top_k(logits / 0.7, 4), 0.95)
    probs = torch.softmax(warped, dim=-1)[0].numpy()
    eng._slot_gen = [torch.Generator().manual_seed(0)]
    n = 4000
    counts = np.zeros(6)
    for _ in range(n):
        counts[int(eng._sample(logits)[0])] += 1
    freq = counts / n
    se = np.sqrt(probs * (1 - probs) / n)
    assert np.all(np.abs(freq - probs) <= 5 * se + 1e-12), (freq, probs)
    assert counts[probs == 0].sum() == 0


def test_retire_cancel_release_pages(model, prompts):
    _, _, tcfg, tparams = model
    eng = teng.ContinuousBatcher(
        tcfg, tparams, kv_layout="paged", device="cpu", **ENGINE
    )
    ids = [eng.submit(p) for p in prompts[:5]]
    eng.step()
    assert eng.active_count() == 3 and eng.queue_len() == 2
    eng.cancel(ids[4])           # still queued
    eng.cancel(ids[0])           # live in a slot
    assert eng.queue_len() == 1 and eng.free_slots() == 1
    eng.cancel(12345)            # unknown: no-op
    while eng.has_work():
        eng.step()
    for i in ids[1:4]:
        assert len(eng.retire(i)) > 0
    with pytest.raises(KeyError):
        eng.retire(ids[0])
    eng.allocator.check()
    assert eng.allocator.free_pages == eng.allocator.capacity


def test_knob_validation(model):
    _, _, tcfg, tparams = model
    mk = teng.ContinuousBatcher
    with pytest.raises(ValueError, match="dense-equivalent"):
        mk(tcfg, tparams, n_slots=2, max_len=32, kv_layout="paged",
           n_pages=4, device="cpu")
    with pytest.raises(ValueError, match="differ"):
        mk(tcfg, tparams, eos_id=0, pad_id=0, device="cpu")
    with pytest.raises(ValueError, match="kv_layout"):
        mk(tcfg, tparams, kv_layout="ring", device="cpu")
    with pytest.raises(ValueError, match="divide"):
        mk(tcfg, tparams, max_len=40, page_size=16, kv_layout="paged",
           device="cpu")
    eng = mk(tcfg, tparams, max_len=16, device="cpu")
    with pytest.raises(ValueError, match="no room"):
        eng.submit(list(range(1, 17)))
    with pytest.raises(ValueError, match="max_new"):
        eng.submit([1, 2], max_new=0)


def test_default_device_is_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device(None)
    assert resolve_device("cpu").type == "cpu"
