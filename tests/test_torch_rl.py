"""The port's RLHF package (dlrover_tpu_torch/rl/) and
`models/decode.generate` against the JAX package (dlrover_tpu/rl/,
tests/test_rl_ppo.py, tests/test_decode.py::TestGenerate and
::TestCachedRolloutEngine) on the same numbers.

Params are drawn by JAX and carried across as numpy (`params_from_numpy`
for Llama trees, f32 tensors for the toy bigram models); prompts, GAE
and loss inputs come from numpy seeds. Sampled draws are torch's
(`torch.Generator`) where JAX splits a key, so sampled rows are held to
the distribution's support (tokens in vocab, prompts kept) and greedy
rows to JAX's exactly.

Tolerances:
- tokens, done masks, EOS masks, the replay order: exact;
- `compute_gae`, `ppo_loss` and its metrics: rtol 1e-5 (f32 on both
  sides, sums in another order);
- teacher-forced logprobs of the two rollout engines: atol 1e-5, as
  JAX's own test holds its two engines;
- one `PpoTrainer.step` (temperature 0, 2 epochs of 1 minibatch, Adam
  1e-4): its metrics within 1e-4 relative (the losses are sums of the
  same f32 logprobs through a 2-layer model), each updated leaf within
  1e-2 of how far JAX's step moved it (L2 norms: Adam divides each
  gradient by its own magnitude, so an element whose gradient is near
  zero moves by up to lr either way, as in tests/test_torch_train.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dlrover_tpu.models import decode as jdecode
from dlrover_tpu.models import llama as jllama
from dlrover_tpu.models import lora as jlora
from dlrover_tpu.rl import generate as jgen
from dlrover_tpu.rl import ppo as jppo
from dlrover_tpu.rl.model_engine import ModelEngine as JEngine
from dlrover_tpu.rl.model_engine import ModelSpec as JSpec
from dlrover_tpu.rl.replay_buffer import Experience as JExperience
from dlrover_tpu.rl.replay_buffer import ReplayBuffer as JBuffer
from dlrover_tpu_torch.models import decode as tdecode
from dlrover_tpu_torch.models import llama as tllama
from dlrover_tpu_torch.models import lora as tlora
from dlrover_tpu_torch.rl import (
    Experience,
    GaeConfig,
    ModelEngine,
    PpoConfig,
    PpoTrainer,
    ReplayBuffer,
    compute_gae,
    ppo_loss,
    sample_tokens,
)
from dlrover_tpu_torch.rl.generate import sample_tokens_cached
from dlrover_tpu_torch.rl.model_engine import ModelSpec

VOCAB = 8
DIM = 16
MAX_LEN = 12
TARGET = 3
RTOL = 1e-5
STEP_REL = 1e-4
ADAM_REL = 1e-2


# ---------------------------------------------------------------------------
# the toy models of JAX's tests/test_rl_ppo.py, in both packages
# ---------------------------------------------------------------------------


def _j_bigram(key):
    k1, k2 = jax.random.split(key)
    return {"embed": jax.random.normal(k1, (VOCAB, DIM)) * 0.1,
            "out": jax.random.normal(k2, (DIM, VOCAB)) * 0.1}


def _j_critic(key, vocab=VOCAB):
    return {"embed": jax.random.normal(key, (vocab, DIM)) * 0.1,
            "v": jnp.zeros((DIM,))}


def _j_lm_apply(params, tokens):
    return params["embed"][tokens] @ params["out"]


def _j_critic_apply(params, tokens):
    return params["embed"][tokens] @ params["v"]


def _j_reward(tokens, prompt_lens):
    pos = jnp.arange(tokens.shape[1])[None, :]
    gen = pos >= prompt_lens[:, None]
    return jnp.sum((tokens == TARGET) & gen, axis=1).astype(jnp.float32)


def _t_lm_apply(params, tokens):
    return params["embed"][tokens] @ params["out"]


def _t_critic_apply(params, tokens):
    return params["embed"][tokens] @ params["v"]


def _t_reward(tokens, prompt_lens):
    pos = torch.arange(tokens.shape[1])[None, :]
    gen = pos >= prompt_lens[:, None]
    return ((tokens == TARGET) & gen).sum(dim=1).float()


def _torch(tree):
    """A JAX / numpy tree -> the same nested dict of CPU tensors."""
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True))


def _leaves(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out.update(_leaves(tree[k], prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(tree[k])
    return out


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _jcfg():
    return dataclasses.replace(jllama.LlamaConfig.tiny(), dtype=jnp.float32)


TCFG = tllama.LlamaConfig.tiny(dtype=torch.float32)


def _llama_engines(seed=0, lora=None):
    """The same Llama actor and bigram critic in both packages (JAX's
    TestContinuousRollout._llama_engine), optionally LoRA-injected with
    a random B so the adapters act. Returns (jax cfg, jax engine, port
    cfg, port engine)."""
    jcfg = _jcfg()
    ka, kc = jax.random.split(jax.random.PRNGKey(seed))
    actor = jllama.init_params(jcfg, ka)
    tcfg = TCFG
    if lora is not None:
        jcfg, actor = jlora.inject(jcfg, actor, lora, jax.random.PRNGKey(9))
        layers = dict(actor["layers"])
        for i, t in enumerate(lora.targets):
            layers[t + "_lora_b"] = jax.random.normal(
                jax.random.PRNGKey(20 + i),
                layers[t + "_lora_b"].shape) * 0.05
        actor = dict(actor, layers=layers)
        tcfg = dataclasses.replace(TCFG, lora_alpha=lora.alpha)
    # a critic over the actor's vocab (JAX's test gives it VOCAB rows and
    # leans on JAX clamping the out-of-range gathers; torch raises), its
    # value head non-zero so the advantages, and the actor's step, are
    critic = dict(_j_critic(kc, vocab=jcfg.vocab_size),
                  v=jax.random.normal(jax.random.PRNGKey(seed + 50),
                                      (DIM,)))
    jeng = JEngine(
        actor=JSpec(lambda p, t: jllama.apply(jcfg, p, t), actor,
                    trainable=True, model_cfg=jcfg),
        critic=JSpec(_j_critic_apply, critic, trainable=True),
        reward_fn=_j_reward,
    )
    t_actor = tllama.params_from_numpy(tcfg, jax.device_get(actor),
                                       device="cpu", dtype=torch.float32)
    teng = ModelEngine(
        actor=ModelSpec(lambda p, t: tllama.apply(tcfg, p, t), t_actor,
                        trainable=True, model_cfg=tcfg),
        critic=ModelSpec(_t_critic_apply, _torch(jax.device_get(critic)),
                         trainable=True),
        reward_fn=_t_reward,
    )
    return jcfg, jeng, tcfg, teng


def _mixed_prompts(batch=6, seed=7):
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, 6, size=batch)
    prompts = np.zeros((batch, MAX_LEN), np.int32)
    for b, n in enumerate(lens):
        prompts[b, :n] = rng.integers(1, 250, size=n)
    return prompts, lens.astype(np.int32)


# ---------------------------------------------------------------------------
# GAE, the PPO loss and the replay buffer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("gamma,lam", [(1.0, 0.95), (0.99, 0.9), (1.0, 1.0)])
def test_compute_gae_matches_jax(gamma, lam):
    rng = np.random.default_rng(3)
    r = rng.normal(size=(5, 11)).astype(np.float32)
    v = rng.normal(size=(5, 11)).astype(np.float32)
    m = (rng.random((5, 11)) < 0.8).astype(np.float32)
    m[1, 7:] = 0.0                      # a padded tail
    cfg_j, cfg_t = jppo.GaeConfig(gamma, lam), GaeConfig(gamma, lam)
    j_adv, j_ret = jppo.compute_gae(jnp.asarray(r), jnp.asarray(v),
                                    jnp.asarray(m), cfg_j)
    t_adv, t_ret = compute_gae(torch.from_numpy(r), torch.from_numpy(v),
                               torch.from_numpy(m), cfg_t)
    np.testing.assert_allclose(_np(t_adv), np.asarray(j_adv), rtol=RTOL,
                               atol=1e-6)
    np.testing.assert_allclose(_np(t_ret), np.asarray(j_ret), rtol=RTOL,
                               atol=1e-6)


def test_gae_manual_cases():
    """JAX's TestGae on the port: one step by hand; a masked step
    contributes nothing to the step before it."""
    adv, ret = compute_gae(torch.tensor([[1.0, 2.0]]),
                           torch.tensor([[0.5, 0.25]]), torch.ones(1, 2),
                           GaeConfig(gamma=1.0, lam=1.0))
    a1 = 2.0 - 0.25
    a0 = 1.0 + 0.25 - 0.5 + a1
    np.testing.assert_allclose(_np(adv), [[a0, a1]], rtol=1e-6)
    np.testing.assert_allclose(_np(ret), _np(adv) + [[0.5, 0.25]],
                               rtol=1e-6)
    adv, _ = compute_gae(torch.tensor([[1.0, 5.0]]), torch.zeros(1, 2),
                         torch.tensor([[1.0, 0.0]]),
                         GaeConfig(gamma=1.0, lam=1.0))
    assert float(adv[0, 0]) == 1.0 and float(adv[0, 1]) == 0.0


@pytest.mark.parametrize("entropy_coef", [0.0, 0.01])
def test_ppo_loss_and_metrics_match_jax(entropy_coef):
    """The same bigram actor and critic, and one rollout's worth of
    numpy experience: loss and every metric within rtol 1e-5, and the
    gradients of both models too."""
    rng = np.random.default_rng(11)
    actor = jax.device_get(_j_bigram(jax.random.PRNGKey(2)))
    critic = jax.device_get(_j_critic(jax.random.PRNGKey(3)))
    critic["v"] = rng.normal(size=(DIM,)).astype(np.float32) * 0.1
    b, seq = 6, MAX_LEN
    batch = {
        "tokens": rng.integers(0, VOCAB, size=(b, seq)).astype(np.int32),
        "mask": (rng.random((b, seq - 1)) < 0.7).astype(np.float32),
        "logprobs": (-rng.random((b, seq - 1)) * 3).astype(np.float32),
        "values": rng.normal(size=(b, seq - 1)).astype(np.float32) * 0.1,
        "advantages": rng.normal(size=(b, seq - 1)).astype(np.float32),
        "returns": rng.normal(size=(b, seq - 1)).astype(np.float32),
    }
    cfg_j = jppo.PpoConfig(entropy_coef=entropy_coef)
    cfg_t = PpoConfig(entropy_coef=entropy_coef)

    def j_loss(ap, cp):
        return jppo.ppo_loss(ap, cp, _j_lm_apply, _j_critic_apply,
                             {k: jnp.asarray(v) for k, v in batch.items()},
                             cfg_j)

    (j_total, j_m), (j_ga, j_gc) = jax.value_and_grad(
        j_loss, argnums=(0, 1), has_aux=True)(actor, critic)
    t_actor = {k: v.requires_grad_(True) for k, v in _torch(actor).items()}
    t_critic = {k: v.requires_grad_(True)
                for k, v in _torch(critic).items()}
    t_batch = {k: torch.from_numpy(v).long() if k == "tokens"
               else torch.from_numpy(v) for k, v in batch.items()}
    t_total, t_m = ppo_loss(t_actor, t_critic, _t_lm_apply,
                            _t_critic_apply, t_batch, cfg_t)
    np.testing.assert_allclose(_np(t_total), np.asarray(j_total), rtol=RTOL)
    assert set(t_m) == set(j_m)
    for k in j_m:
        np.testing.assert_allclose(_np(t_m[k]), np.asarray(j_m[k]),
                                   rtol=RTOL, err_msg=k)
    grads = torch.autograd.grad(t_total, list(t_actor.values())
                                + list(t_critic.values()))
    want = list(j_ga.values()) + list(j_gc.values())
    for g, w in zip(grads, want):
        w = np.asarray(w)
        np.testing.assert_allclose(_np(g), w, rtol=RTOL,
                                   atol=RTOL * np.abs(w).max())


def _exp(n, seed=0):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(n, MAX_LEN - 1)).astype(np.float32)
    return dict(tokens=rng.integers(0, 99, size=(n, MAX_LEN)).astype(
                    np.int32),
                prompt_lens=np.arange(n, dtype=np.int32),
                logprobs=z, values=z + 1, advantages=z + 2, returns=z + 3,
                mask=np.ones_like(z))


@pytest.mark.parametrize("size,epochs,seed", [(4, 2, 0), (5, 3, 7),
                                              (32, 1, 1)])
def test_replay_minibatches_order_matches_jax(size, epochs, seed):
    """Two rollouts in the buffer; the same numpy seed gives the same
    minibatches in the same order, field by field."""
    jb, tb = JBuffer(), ReplayBuffer()
    for s in (1, 2):
        jb.add(JExperience(**_exp(8, s)))
        tb.add(Experience(**_exp(8, s)))
    j_mbs = list(jb.minibatches(size, np.random.default_rng(seed), epochs))
    t_mbs = list(tb.minibatches(size, np.random.default_rng(seed), epochs))
    assert len(t_mbs) == len(j_mbs) > 0
    for jm, tm in zip(j_mbs, t_mbs):
        for f in dataclasses.fields(Experience):
            assert np.array_equal(getattr(tm, f.name), getattr(jm, f.name))


def test_replay_buffer_capacity_and_cover():
    """JAX's TestReplayBuffer on the port."""
    buf = ReplayBuffer()
    buf.add(Experience(**_exp(8)))
    buf.add(Experience(**_exp(8)))
    mbs = list(buf.minibatches(4, epochs=2))
    assert len(mbs) == 8 and all(len(m) == 4 for m in mbs)
    buf = ReplayBuffer(capacity=10)
    buf.add(Experience(**_exp(8)))
    buf.add(Experience(**_exp(8)))
    assert len(buf) == 8
    assert list(ReplayBuffer().minibatches(4)) == []


# ---------------------------------------------------------------------------
# the samplers and decode.generate
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def llama_params():
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(n_heads=4,
                                                       n_kv_heads=2),
                               dtype=jnp.float32)
    tree = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = tllama.LlamaConfig.tiny(n_heads=4, n_kv_heads=2,
                                   dtype=torch.float32)
    return jcfg, tree, tcfg, tllama.params_from_numpy(
        tcfg, jax.device_get(tree), device="cpu", dtype=torch.float32)


@pytest.mark.parametrize("eos", ["none", "first", "zero"])
def test_samplers_greedy_match_jax(llama_params, eos):
    """Both lockstep samplers, greedy, ragged prompts: tokens and done
    masks equal JAX's sample_tokens (and the two port engines equal each
    other). "first": eos is the token row 0 emits first, so that row
    stops at once and the others run on."""
    jcfg, tree, tcfg, params = llama_params
    b, max_len = 3, 12
    prompts = np.asarray(jax.random.randint(
        jax.random.PRNGKey(3), (b, max_len), 0, jcfg.vocab_size))
    lens = np.array([3, 5, 4], np.int32)
    t_prompts = torch.tensor(prompts, dtype=torch.long)
    t_lens = torch.from_numpy(lens).long()

    def jax_run(eos_id):
        return jgen.sample_tokens(
            lambda p, t: jllama.apply(jcfg, p, t), tree,
            jnp.asarray(prompts), jnp.asarray(lens), max_len, greedy=True,
            eos_id=eos_id)

    eos_id = -1
    if eos == "first":
        eos_id = int(np.asarray(jax_run(-1)[0])[0, lens[0]])
    elif eos == "zero":
        eos_id = 0
    j_toks, j_done = jax_run(eos_id)
    t_toks, t_done = sample_tokens(
        lambda p, t: tllama.apply(tcfg, p, t), params, t_prompts, t_lens,
        max_len, greedy=True, eos_id=eos_id)
    c_toks, c_done = sample_tokens_cached(
        tcfg, params, t_prompts, t_lens, max_len, greedy=True,
        eos_id=eos_id)
    assert np.array_equal(_np(t_toks), np.asarray(j_toks))
    assert np.array_equal(_np(t_done), np.asarray(j_done))
    assert np.array_equal(_np(c_toks), np.asarray(j_toks))
    assert np.array_equal(_np(c_done), np.asarray(j_done))
    if eos == "first":
        assert bool(t_done[0])


def test_sampler_keeps_prompt_and_vocab():
    """JAX's TestSampler on the port: temperature draws keep the prompt
    and stay in vocab; greedy ignores the generator."""
    actor = _torch(jax.device_get(_j_bigram(jax.random.PRNGKey(0))))
    prompts = torch.zeros((4, MAX_LEN), dtype=torch.long)
    prompts[:, 0] = 1
    lens = torch.ones(4, dtype=torch.long)
    toks, done = sample_tokens(_t_lm_apply, actor, prompts, lens, MAX_LEN,
                               generator=torch.Generator().manual_seed(1))
    assert toks.shape == (4, MAX_LEN) and toks.dtype == torch.long
    assert bool((toks[:, 0] == 1).all()) and int(toks.max()) < VOCAB
    assert not bool(done.any())
    g1, _ = sample_tokens(_t_lm_apply, actor, prompts[:2], lens[:2],
                          MAX_LEN, greedy=True)
    g2, _ = sample_tokens(_t_lm_apply, actor, prompts[:2], lens[:2],
                          MAX_LEN, greedy=True,
                          generator=torch.Generator().manual_seed(9))
    assert torch.equal(g1, g2)


def test_generate_greedy_and_eos_tail_match_jax(llama_params):
    """decode.generate greedy equals JAX's token for token; with eos =
    the first greedy token of row 0, the eos is kept and the tail is
    pad in both; eos_id None and zero new tokens as JAX's."""
    jcfg, tree, tcfg, params = llama_params
    prompt = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 5),
                                           0, jcfg.vocab_size))
    tp = torch.tensor(prompt, dtype=torch.long)
    j_out = np.asarray(jdecode.generate(jcfg, tree, jnp.asarray(prompt), 6,
                                        temperature=0.0))
    t_out = tdecode.generate(tcfg, params, tp, 6, temperature=0.0)
    assert t_out.shape == (2, 11)
    assert np.array_equal(_np(t_out), j_out)
    first = int(j_out[0, 5])
    j_eos = np.asarray(jdecode.generate(jcfg, tree, jnp.asarray(prompt), 6,
                                        temperature=0.0, eos_id=first,
                                        pad_id=first + 1))
    t_eos = tdecode.generate(tcfg, params, tp, 6, temperature=0.0,
                             eos_id=first, pad_id=first + 1)
    assert np.array_equal(_np(t_eos), j_eos)
    assert int(t_eos[0, 5]) == first
    assert all(int(x) == first + 1 for x in t_eos[0, 6:])
    assert torch.equal(tdecode.generate(tcfg, params, tp, 6, eos_id=None),
                       t_out)
    assert torch.equal(tdecode.generate(tcfg, params, tp, 0), tp)
    # a cache buffer padded past what the tokens use changes nothing
    assert torch.equal(tdecode.generate(tcfg, params, tp, 6, max_len=16),
                       t_out)


def test_generate_sampling_knobs(llama_params):
    """top_k=1 at any temperature is greedy; top_p / top_k draws stay in
    vocab with the prompt kept; JAX's knob rejections, message for
    message."""
    _, _, tcfg, params = llama_params
    tp = torch.tensor(np.asarray(jax.random.randint(
        jax.random.PRNGKey(1), (2, 4), 0, tcfg.vocab_size)), dtype=torch.long)
    greedy = tdecode.generate(tcfg, params, tp, 5, temperature=0.0)
    k1 = tdecode.generate(tcfg, params, tp, 5, temperature=1.5, top_k=1,
                          generator=torch.Generator().manual_seed(3))
    assert torch.equal(k1, greedy)
    out = tdecode.generate(tcfg, params, tp, 5, temperature=0.9, top_p=0.8,
                           top_k=8, generator=torch.Generator().manual_seed(11))
    assert out.shape == (2, 9) and int(out.max()) < tcfg.vocab_size
    assert torch.equal(out[:, :4], tp)
    for kw, match in [(dict(eos_id=0, pad_id=0), "pad_id"),
                      (dict(top_p=0.0), "top_p"),
                      (dict(top_k=-1), "top_k"),
                      (dict(max_len=6), "max_len")]:
        with pytest.raises(ValueError, match=match):
            tdecode.generate(tcfg, params, tp[:1], 5 if "max_len" in kw
                             else 2, **kw)


# ---------------------------------------------------------------------------
# the PPO trainer
# ---------------------------------------------------------------------------


def _j_trainer(jeng, **kw):
    eos = kw.pop("eos_id", -1)
    return jppo.PpoTrainer(jeng, jppo.PpoConfig(max_len=MAX_LEN, **kw),
                           eos_id=eos)


def _t_trainer(teng, **kw):
    eos = kw.pop("eos_id", -1)
    return PpoTrainer(teng, PpoConfig(max_len=MAX_LEN, **kw), eos_id=eos,
                      device="cpu")


LORA = tlora.LoraConfig(rank=4, alpha=8.0)
J_LORA = jlora.LoraConfig(rank=4, alpha=8.0)


def test_continuous_and_lockstep_rollouts_match_jax():
    """JAX's TestContinuousRollout::test_greedy_tokens_match_lockstep and
    TestContinuousRolloutEosZero on both packages, with eos_id 0 (the
    engine's pad sits at -1, outside the vocab): at temperature 0 the
    four rollouts (lockstep and continuous, each package) give the same
    tokens and masks, logprobs within 1e-5. A LoRA-injected actor's
    continuous rollout is held to JAX's in `test_ppo_step_matches_jax`."""
    eos_id = 0
    _, jeng, _, teng = _llama_engines(seed=4)
    prompts, lens = _mixed_prompts(6)
    key = jax.random.PRNGKey(5)
    exps = {}
    for engine in ("auto", "continuous"):
        kw = dict(temperature=0.0, rollout_engine=engine, eos_id=eos_id)
        exps["jax", engine] = _j_trainer(jeng, **kw).make_experience(
            jnp.asarray(prompts), jnp.asarray(lens), key)
        exps["port", engine] = _t_trainer(teng, **kw).make_experience(
            prompts, lens, torch.Generator().manual_seed(5))
    want = exps["jax", "auto"]
    for k, exp in exps.items():
        assert np.array_equal(exp.tokens, want.tokens), k
        assert np.array_equal(exp.mask, want.mask), k
        np.testing.assert_allclose(exp.logprobs, want.logprobs, atol=1e-5,
                                   err_msg=str(k))
        np.testing.assert_allclose(exp.values, want.values, atol=1e-6,
                                   err_msg=str(k))
    assert exps["port", "auto"].tokens.shape == (len(lens), MAX_LEN)


def test_continuous_rollout_rejections_and_full_prompts():
    """JAX's generic-actor and unknown-engine rejections, and a prompt
    that fills the buffer generating nothing."""
    _, _, _, teng = _llama_engines(seed=2)
    bigram = ModelEngine(
        actor=ModelSpec(_t_lm_apply, _torch(jax.device_get(
            _j_bigram(jax.random.PRNGKey(0)))), trainable=True),
        critic=ModelSpec(_t_critic_apply, _torch(jax.device_get(
            _j_critic(jax.random.PRNGKey(1)))), trainable=True),
        reward_fn=_t_reward)
    prompts = np.zeros((4, MAX_LEN), np.int32)
    prompts[:, 0] = 1
    lens = np.ones(4, np.int32)
    with pytest.raises(ValueError, match="continuous"):
        _t_trainer(bigram, rollout_engine="continuous").make_experience(
            prompts, lens)
    with pytest.raises(ValueError, match="unknown rollout_engine"):
        _t_trainer(teng, rollout_engine="continous").make_experience(
            prompts, lens)
    rng = np.random.default_rng(9)
    full = rng.integers(1, 250, size=(3, MAX_LEN)).astype(np.int32)
    exp = _t_trainer(teng, temperature=0.0,
                     rollout_engine="continuous").make_experience(
        full, np.array([MAX_LEN, 2, MAX_LEN], np.int32))
    assert exp.mask[0].sum() == 0 and exp.mask[2].sum() == 0
    assert exp.mask[1].sum() > 0
    assert np.array_equal(exp.tokens[[0, 2]], full[[0, 2]])


def test_eos_credit_mask_stops_at_eos():
    """JAX's TestEosCredit on the port: positions after a row's first
    generated EOS are masked out."""
    teng = ModelEngine(
        actor=ModelSpec(_t_lm_apply, _torch(jax.device_get(
            _j_bigram(jax.random.PRNGKey(0)))), trainable=True),
        critic=ModelSpec(_t_critic_apply, _torch(jax.device_get(
            _j_critic(jax.random.PRNGKey(1)))), trainable=True),
        reward_fn=_t_reward)
    prompts = np.zeros((16, MAX_LEN), np.int32)
    prompts[:, 0] = 1
    exp = _t_trainer(teng, eos_id=TARGET).make_experience(
        prompts, np.ones(16, np.int32), torch.Generator().manual_seed(3))
    hits = 0
    for b in range(16):
        eos = np.where(exp.tokens[b, 1:] == TARGET)[0]
        if len(eos):
            hits += 1
            assert exp.mask[b, eos[0] + 1:].sum() == 0
            assert exp.mask[b, :eos[0] + 1].sum() == eos[0] + 1
    assert hits > 0


def test_ppo_step_matches_jax():
    """One `PpoTrainer.step` at temperature 0 through the continuous
    engine over a LoRA-injected actor (the engine serves the merged
    adapters on prefill and decode; 4 prompts, minibatch 4, 2 epochs,
    `lora_optimizer(Adam 1e-4)` for the actor, Adam 1e-4 for the
    critic): the same tokens as JAX's, metrics within 1e-4 relative,
    each updated leaf within 1e-2 of JAX's move, the base leaves
    bit-equal. Then the engine serves the updated actor: a second
    rollout through it (update_params) equals the lockstep rollout of
    the new params."""
    lora = J_LORA
    _, jeng, tcfg, teng = _llama_engines(seed=1, lora=lora)
    base = {k: v.clone() for k, v in tllama.layer_params(
        teng.actor.params, 0).items()}
    prompts, lens = _mixed_prompts(4)
    kw = dict(temperature=0.0, minibatch_size=4,
              rollout_engine="continuous")
    jt = jppo.PpoTrainer(jeng, jppo.PpoConfig(max_len=MAX_LEN, **kw),
                         actor_opt=jlora.lora_optimizer(optax.adam(1e-4)))
    tt = PpoTrainer(teng, PpoConfig(max_len=MAX_LEN, **kw),
                    actor_opt=tlora.lora_optimizer(
                        lambda ps: torch.optim.Adam(
                            ps, lr=1e-4, betas=(0.9, 0.999), eps=1e-8)),
                    device="cpu")
    j_init = _leaves(jax.device_get(jeng.actor.params))
    j_exp = jt.make_experience(jnp.asarray(prompts), jnp.asarray(lens),
                               jax.random.PRNGKey(0))
    jt.buffer.add(j_exp)
    j_m = jt.train_on_buffer()
    t_exp = tt.make_experience(prompts, lens)
    assert np.array_equal(t_exp.tokens, j_exp.tokens)
    tt.buffer.add(t_exp)
    t_m = tt.train_on_buffer()
    assert set(t_m) == set(j_m) == {"pg_loss", "vf_loss", "ratio_mean",
                                    "loss"}
    for k in j_m:
        assert abs(t_m[k] - j_m[k]) <= STEP_REL * max(abs(j_m[k]), 1e-3), (
            k, t_m[k], j_m[k])
    j_new = _leaves(jax.device_get(jeng.actor.params))
    t_new = jax.tree_util.tree_map(_np, teng.actor.params)
    moves = []
    for name, p in _leaves(t_new).items():
        moved = np.linalg.norm(j_new[name] - j_init[name])
        err = np.linalg.norm(p - j_new[name])
        assert err <= ADAM_REL * moved, (name, err, moved)
        moves.append(moved)
    assert max(moves) > 0
    for k, v in base.items():
        if not tlora.is_adapter_path(k):
            assert torch.equal(tllama.layer_params(
                teng.actor.params, 0)[k], v), k
    assert not torch.equal(teng.actor.params["layers"]["wq_lora_b"][0],
                           base["wq_lora_b"])
    assert len(tt.actor_opt_state.state) == 8
    # the second rollout goes through update_params on the same engine
    cb = tt._cb
    again = tt.make_experience(prompts, lens)
    assert tt._cb is cb and cb.weight_version == 1
    lock = _t_trainer(teng, temperature=0.0).make_experience(prompts, lens)
    assert np.array_equal(again.tokens, lock.tokens)


def test_ppo_policy_learns_target_token():
    """JAX's TestPpoEndToEnd on the port alone: the bigram actor learns
    to emit the rewarded token (its rate at a fixed seed rises by more
    than 0.2 in 12 PPO steps)."""
    teng = ModelEngine(
        actor=ModelSpec(_t_lm_apply, _torch(jax.device_get(
            _j_bigram(jax.random.PRNGKey(2)))), trainable=True),
        critic=ModelSpec(_t_critic_apply, _torch(jax.device_get(
            _j_critic(jax.random.PRNGKey(3)))), trainable=True),
        reward_fn=_t_reward)
    trainer = PpoTrainer(
        teng, PpoConfig(max_len=MAX_LEN, minibatch_size=8, epochs=2,
                        kl_coef=0.02),
        actor_opt=lambda ps: torch.optim.Adam(ps, lr=3e-2),
        critic_opt=lambda ps: torch.optim.Adam(ps, lr=1e-2), device="cpu")
    prompts = torch.zeros((16, MAX_LEN), dtype=torch.long)
    prompts[:, 0] = 1
    lens = torch.ones(16, dtype=torch.long)

    def target_rate():
        toks, _ = sample_tokens(_t_lm_apply, teng.actor.params, prompts,
                                lens, MAX_LEN,
                                generator=torch.Generator().manual_seed(100))
        return float((toks[:, 1:] == TARGET).float().mean())

    before = target_rate()
    for i in range(12):
        metrics = trainer.step(prompts, lens,
                               torch.Generator().manual_seed(i))
    after = target_rate()
    assert after > before + 0.2, (before, after, metrics)
    assert all(np.isfinite(v) for v in metrics.values())


def test_model_engine_ref_is_a_detached_snapshot():
    """The default ref is a copy of the actor at construction: training
    the actor leaves it, `sync_ref` re-anchors it."""
    actor = {"w": torch.ones(3, requires_grad=True)}
    eng = ModelEngine(ModelSpec(lambda p, t: p["w"], actor, True),
                      ModelSpec(lambda p, t: p["w"], {}, True),
                      reward_fn=None)
    assert eng.ref.params["w"] is not actor["w"]
    assert not eng.ref.params["w"].requires_grad
    with torch.no_grad():
        actor["w"].add_(1.0)
    assert torch.equal(eng.ref.params["w"], torch.ones(3))
    eng.sync_ref()
    assert torch.equal(eng.ref.params["w"], torch.full((3,), 2.0))
