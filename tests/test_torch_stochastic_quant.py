"""weight_quant="int8_stochastic" in the port (dlrover_tpu_torch/ops/
quantization.py `stochastic_round_int8`, the engine's `_quantize_params`)
against the JAX package's `stochastic_round_int8` and int8_stochastic
engine.

JAX draws its rounding bits from jax.random and the port from a
torch.Generator, so the oracle is distributional, not byte parity:

- the scales take no random bits: byte-equal to JAX's on the same f32
  weights (a true division amax / 127, which differs from the quantize
  kernel's amax * f32(1/127) in some blocks of the [64, 4096] case);
- every q8 is the floor or the ceiling of x / scale, clipped to +-127;
- over N = 256 generator seeds, the rate of rounding up matches the
  fractional part f and E[dequant] == x. Each draw is Bernoulli(f), so
  the bounds follow from its variance f(1 - f): per element Hoeffding,
  P(|mean - f| >= t) <= 2 exp(-2 N t^2), with t set so that the
  family-wise chance over all M elements is 1e-6; per bin of f and over
  all elements, Z = 6 standard deviations sqrt(N sum f(1 - f)) / (N M)
  of the mean over the bin's N M draws (N M >= 10^4, where the normal
  approximation holds). JAX's own draws (256 keys) meet the same
  bounds;
- one seed gives the same bytes, another seed other bytes;
- the engine serves with it on the CPU: installed scales byte-equal to
  the JAX int8_stochastic engine's, greedy streams equal to the port's
  dense engine over exactly the dequantized weights, and every
  projection (each layer slice of every quantized leaf, and the lm_head)
  runs through `matmul_any` on a QuantizedWeight."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.models import llama as jllama
from dlrover_tpu.ops import quantization as jq
from dlrover_tpu.serving.engine import ContinuousBatcher as JaxBatcher
from dlrover_tpu_torch.models import llama as tllama
from dlrover_tpu_torch.ops import quantization as tq
from dlrover_tpu_torch.serving import engine as teng

N_SEEDS = 256
Z = 6.0
FAMILY_P = 1e-6
ENGINE = dict(n_slots=3, max_len=64, max_new_tokens=8, chunk=4, pad_id=-1)
QUANTIZED = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype=jnp.float32)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    tcfg = tllama.LlamaConfig.tiny(dtype=torch.float32)
    tparams = tllama.params_from_numpy(tcfg, tree, device="cpu")
    return jcfg, jparams, tcfg, tparams


def _x(shape, seed, zero_rows=0):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    x[:zero_rows] = 0.0
    return x


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize(
    "shape,block,zero_rows",
    [((64, 4096), 256, 0), ((48, 512), 64, 3), ((16, 768), 256, 1)],
    ids=["64x4096-b256", "48x512-b64-zeros", "16x768-b256-zeros"],
)
def test_scales_byte_equal_jax(shape, block, zero_rows):
    x = _x(shape, 0, zero_rows)
    _, js = jq.stochastic_round_int8(jnp.asarray(x), jax.random.PRNGKey(0),
                                     block)
    _, ts = tq.stochastic_round_int8(torch.from_numpy(x), block, _gen(0))
    assert ts.dtype == torch.float32 and tuple(ts.shape) == js.shape
    assert ts.numpy().tobytes() == np.asarray(js).tobytes()
    if zero_rows:
        assert (ts[:zero_rows] == 1.0).all()
    if shape == (64, 4096):
        # the true division matters: the kernel's product formula
        # misses JAX's scale in some blocks
        _, ks = tq._quantize_plain(torch.from_numpy(x), block)
        assert not torch.equal(ks, ts)


def test_bf16_input_scales_equal_jax_on_its_f32_values():
    """The engine rounds bf16-stored weights; JAX rounds their f32
    values (its engine stores f32). The scales agree."""
    xb = torch.from_numpy(_x((32, 1024), 1)).to(torch.bfloat16)
    _, ts = tq.stochastic_round_int8(xb, 256, _gen(0))
    _, js = jq.stochastic_round_int8(jnp.asarray(xb.float().numpy()),
                                     jax.random.PRNGKey(0), 256)
    assert ts.numpy().tobytes() == np.asarray(js).tobytes()


def _floor_frac(x: torch.Tensor, s: torch.Tensor, block: int):
    xs = x.float() / s.repeat_interleave(block, dim=1)
    lo = torch.floor(xs)
    return lo, xs - lo


def test_every_q8_is_floor_or_ceiling():
    x = torch.from_numpy(_x((64, 1024), 2, zero_rows=2))
    x[5, :256] *= 1e-30  # tiny values: floor 0 or -1
    for seed in range(4):
        q, s = tq.stochastic_round_int8(x, 256, _gen(seed))
        lo, _ = _floor_frac(x, s, 256)
        q = q.float()
        ok = (q == torch.clamp(lo, -127, 127)) | (
            q == torch.clamp(lo + 1, -127, 127))
        assert bool(ok.all())
        assert int(q.abs().max()) <= 127
    # the block's largest magnitude sits exactly on +-127
    assert int(q.abs().amax()) == 127


def _hoeffding_t(n: int, m: int) -> float:
    return math.sqrt(math.log(2 * m / FAMILY_P) / (2 * n))


def _check_rates(up: np.ndarray, f: np.ndarray, what: str):
    """up [N, M] in {0, 1}: draws of Bernoulli(f[M])."""
    n, m = up.shape
    rate = up.mean(axis=0)
    t = _hoeffding_t(n, m)
    assert np.abs(rate - f).max() <= t, (what, np.abs(rate - f).max(), t)
    bins = np.minimum((f * 10).astype(int), 9)
    for b in range(10):
        sel = bins == b
        if sel.sum() * n < 10_000:
            continue
        sd = math.sqrt(n * float((f[sel] * (1 - f[sel])).sum())) / (
            n * sel.sum())
        dev = abs(float(up[:, sel].mean() - f[sel].mean()))
        assert dev <= Z * sd, (what, b, dev, Z * sd)
    sd = math.sqrt(n * float((f * (1 - f)).sum())) / (n * m)
    assert abs(float(up.mean() - f.mean())) <= Z * sd, what


def test_rounding_up_rate_and_unbiased_dequant_port_and_jax():
    block = 256
    x = torch.from_numpy(_x((16, 512), 3))
    # fractions spread over [0, 1): the draws, not the data, decide
    qs = []
    for seed in range(N_SEEDS):
        q, s = tq.stochastic_round_int8(x, block, _gen(seed))
        qs.append(q)
    q = torch.stack(qs).float()                      # [N, 16, 512]
    lo, f = _floor_frac(x, s, block)
    assert int(((q - lo) < 0).sum()) == 0 and int(((q - lo) > 1).sum()) == 0
    up = (q - lo).reshape(N_SEEDS, -1).numpy()
    fr = f.reshape(-1).numpy().astype(np.float64)
    _check_rates(up, fr, "port")
    # E[dequant] == x, element by element, within s * t
    srep = s.repeat_interleave(block, dim=1)
    err = (q.mean(dim=0) * srep - x).abs()
    t = _hoeffding_t(N_SEEDS, x.numel())
    assert bool((err <= srep * t + 1e-6).all())
    # and over all elements, in units of the scale
    rel = ((q.mean(dim=0) * srep - x) / srep).reshape(-1).numpy()
    sd = math.sqrt(N_SEEDS * float((fr * (1 - fr)).sum())) / (
        N_SEEDS * fr.size)
    assert abs(float(rel.mean())) <= Z * sd + 1e-7

    # JAX's draws, on the same values, meet the same bounds
    keys = jax.random.split(jax.random.PRNGKey(0), N_SEEDS)
    jqs, js = jax.vmap(
        lambda k: jq.stochastic_round_int8(jnp.asarray(x.numpy()), k, block)
    )(keys)
    assert np.asarray(js[0]).tobytes() == s.numpy().tobytes()
    jup = (np.asarray(jqs, np.float32) - lo.numpy()).reshape(N_SEEDS, -1)
    assert set(np.unique(jup)) <= {0.0, 1.0}
    _check_rates(jup, fr, "jax")


def test_same_seed_same_bytes_other_seed_other_bytes():
    x = torch.from_numpy(_x((8, 512), 4))
    a = tq.stochastic_round_int8(x, 256, _gen(11))
    b = tq.stochastic_round_int8(x, 256, _gen(11))
    c = tq.stochastic_round_int8(x, 256, _gen(12))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0]) and torch.equal(a[1], c[1])


def test_knob_refuses_bad_shapes():
    with pytest.raises(ValueError, match="n % block"):
        tq.stochastic_round_int8(torch.zeros(2, 100), 64)


def _port(model, **kw):
    _, _, tcfg, tparams = model
    return teng.ContinuousBatcher(tcfg, tparams, device="cpu", **ENGINE,
                                  **kw)


def _targets(params):
    lay = params["layers"]
    out = {name: lay[name] for name in QUANTIZED}
    out["lm_head"] = params["lm_head"]["weight"]
    return out


def test_engine_install_against_jax_and_seeded(model):
    jcfg, jparams, _, _ = model
    jeng = JaxBatcher(jcfg, jparams, weight_quant="int8_stochastic", seed=3,
                      **ENGINE)
    a = _port(model, weight_quant="int8_stochastic", seed=3)
    b = _port(model, weight_quant="int8_stochastic", seed=3)
    c = _port(model, weight_quant="int8_stochastic", seed=4)
    near = _port(model, weight_quant="int8")
    assert a.weight_quant_path == jeng.weight_quant_path
    assert a.weight_quant_path == "int8_stochastic:reference"
    assert a.weight_quant_stats() == jeng.weight_quant_stats()
    assert a.weight_bytes_device() == jeng.weight_bytes_device()
    jt, at, bt, ct, nt = (_targets(e.params) for e in (jeng, a, b, c, near))
    differs = 0
    for name, w in at.items():
        jw = jt[name]
        assert isinstance(w, tq.QuantizedWeight) and w.block == jw.block
        assert w.s8.numpy().tobytes() == np.asarray(jw.s8).tobytes(), name
        # both packages round each value to the floor or the ceiling
        jq8 = np.asarray(jw.q8, np.int16)
        assert np.abs(w.q8.numpy().astype(np.int16) - jq8).max() <= 1, name
        assert torch.equal(w.q8, bt[name].q8)
        differs += int(not torch.equal(w.q8, ct[name].q8))
        # stochastic rounding is not round-to-nearest
        assert not torch.equal(w.q8, nt[name].q8), name
    assert differs == len(at)


def _dequantized_tree(tparams, served):
    """The dense tree of exactly the installed int8 values: each
    QuantizedWeight [.., O, K] dequantized to f32 and laid out [.., K, O]
    again."""
    out = dict(tparams)
    lay = dict(tparams["layers"])
    for name in QUANTIZED:
        w = served["layers"][name]
        lay[name] = tq._dq_weight(w.q8, w.s8, w.block,
                                  torch.float32).transpose(-1, -2).contiguous()
    out["layers"] = lay
    h = served["lm_head"]["weight"]
    out["lm_head"] = {"weight": tq._dq_weight(
        h.q8, h.s8, h.block, torch.float32).t().contiguous()}
    return out


def test_engine_serves_the_rounded_weights(model, monkeypatch):
    _, _, tcfg, tparams = model
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, 250, size=n).tolist() for n in (5, 12, 3, 20)]
    eng = _port(model, weight_quant="int8_stochastic", seed=1)
    used = set()
    real = tq.quantized_matmul

    def spy(x, w, **kw):
        used.add(id(w))
        return real(x, w, **kw)

    monkeypatch.setattr(tq, "quantized_matmul", spy)
    got = [[int(t) for t in o] for o in eng.generate_all(prompts)]
    monkeypatch.undo()
    targets = _targets(eng.params)
    want_ids = {id(targets["lm_head"])}
    for name in QUANTIZED:
        want_ids |= {id(targets[name][layer])
                     for layer in range(tcfg.n_layers)}
    assert used == want_ids
    dense = teng.ContinuousBatcher(
        tcfg, _dequantized_tree(tparams, eng.params), device="cpu", **ENGINE)
    want = [[int(t) for t in o] for o in dense.generate_all(prompts)]
    assert got == want
    assert all(len(s) == ENGINE["max_new_tokens"] for s in got)
