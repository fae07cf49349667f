"""The port's mixture-of-experts (dlrover_tpu_torch/models/moe.py) and
the MoE Llama (models/llama.py with n_experts > 0: training, serving
through serving/engine.py, the PPO rollout of rl/ppo.py) against the
JAX package on the same numbers.

Routing parity: a last-bit difference in the f32 router product can
flip a near-tie in top-k and send a token to another expert. Dispatch
masks are compared EXACTLY wherever every choice of the token's top-k
is decided by a margin above 1e-5 (the gap between the chosen gate and
the best one left, at each of the k picks); the inputs below are drawn
so that every token passes, which the tests assert before comparing.
Tolerances otherwise: f32 outputs, logits and losses atol 1e-4;
gradients rtol 1e-4 / atol 1e-5; greedy token streams exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.models import llama as jllama
from dlrover_tpu.models import moe as jmoe
from dlrover_tpu.rl import ppo as jppo
from dlrover_tpu.rl.model_engine import ModelEngine as JEngine
from dlrover_tpu.rl.model_engine import ModelSpec as JSpec
from dlrover_tpu.serving.engine import ContinuousBatcher as JaxBatcher
from dlrover_tpu_torch.models import llama as tllama
from dlrover_tpu_torch.models import moe as tmoe
from dlrover_tpu_torch.rl import ModelEngine, PpoConfig, PpoTrainer
from dlrover_tpu_torch.rl.model_engine import ModelSpec
from dlrover_tpu_torch.serving.engine import ContinuousBatcher

ATOL = 1e-4
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
MARGIN = 1e-5
N_EXPERTS = 4
ENGINE = dict(n_slots=3, max_len=64, max_new_tokens=10, chunk=4)
LENGTHS = (3, 5, 20, 7, 12, 9, 33)


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _leaves(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out.update(_leaves(tree[k], prefix + k + "/"))
        else:
            out[prefix + k] = tree[k]
    return out


def _margins(logits: np.ndarray, k: int) -> np.ndarray:
    """[B, S] the smallest gap between the chosen gate and the best one
    left over the k argmax picks."""
    g = np.asarray(jax.nn.softmax(jnp.asarray(logits, jnp.float32), -1))
    s = -np.sort(-g, axis=-1)
    return np.min(s[..., :k] - s[..., 1:k + 1], axis=-1)


@pytest.fixture(scope="module")
def model():
    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32, n_experts=N_EXPERTS)
    tree = jax.tree_util.tree_map(
        np.asarray, jllama.init_params(jcfg, jax.random.PRNGKey(0)))
    tcfg = tllama.LlamaConfig.tiny(dtype=torch.float32, n_experts=N_EXPERTS)
    tparams = tllama.params_from_numpy(tcfg, tree, device="cpu")
    return jcfg, tree, tcfg, tparams


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cap,top_k,norm", [(3, 2, True), (8, 2, False),
                                            (2, 1, True)],
                         ids=["drops", "roomy-unnormalized", "top1-drops"])
def test_top_k_gating_matches_jax(cap, top_k, norm):
    cfg_kw = dict(n_experts=N_EXPERTS, top_k=top_k, normalize_topk=norm)
    rng = np.random.default_rng(0)
    logits = (2.0 * rng.standard_normal((2, 9, N_EXPERTS))).astype(
        np.float32)
    assert (_margins(logits, top_k) > MARGIN).all()
    jd, jc, jm = jmoe.top_k_gating(jmoe.MoeConfig(**cfg_kw),
                                   jnp.asarray(logits), cap)
    td, tc, tm = tmoe.top_k_gating(tmoe.MoeConfig(**cfg_kw),
                                   torch.from_numpy(logits), cap)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=1e-6,
                                   err_msg=k)
    if cap < 8:
        assert float(tm["moe_dropped_frac"]) > 0
    # each (row, expert, slot) holds at most one token
    assert td.sum(dim=1).max() <= 1


def test_capacity_matches_jax():
    for seq in (1, 4, 5, 32, 1000, 1024):
        for kw in (dict(), dict(n_experts=4, top_k=1,
                                capacity_factor=2.0)):
            assert tmoe.capacity(tmoe.MoeConfig(**kw), seq) == \
                jmoe.capacity(jmoe.MoeConfig(**kw), seq)


def test_moe_mlp_matches_jax():
    cfg_kw = dict(n_experts=N_EXPERTS, top_k=2)
    params = jax.tree_util.tree_map(np.asarray, jmoe.init_moe_mlp(
        jax.random.PRNGKey(1), jmoe.MoeConfig(**cfg_kw), 32, 48))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 12, 32)).astype(np.float32)
    logits = x @ params["router"]
    assert (_margins(logits, 2) > MARGIN).all()
    jy, jm = jmoe.moe_mlp(jmoe.MoeConfig(**cfg_kw), _jnp(params),
                          jnp.asarray(x), compute_dtype=jnp.float32)
    ty, tm = tmoe.moe_mlp(tmoe.MoeConfig(**cfg_kw),
                          {k: torch.from_numpy(v.copy())
                           for k, v in params.items()},
                          torch.from_numpy(x), compute_dtype=torch.float32)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=1e-6)
    init = tmoe.init_moe_mlp(torch.Generator().manual_seed(0),
                             tmoe.MoeConfig(**cfg_kw), 32, 48, n_layers=3,
                             device="cpu")
    assert {k: tuple(v.shape) for k, v in init.items()} == {
        "router": (3, 32, 4), "we_gate": (3, 4, 32, 48),
        "we_up": (3, 4, 32, 48), "we_down": (3, 4, 48, 32)}


# ---------------------------------------------------------------------------
# the MoE Llama
# ---------------------------------------------------------------------------


def test_moe_llama_layout_and_num_params(model):
    jcfg, tree, tcfg, tparams = model
    flat = _leaves(tree)
    got = _leaves(tparams)
    assert sorted(got) == sorted(flat)
    assert "layers/w_gate" not in got and "layers/we_gate" in got
    assert tllama.num_params(tcfg) == jllama.num_params(jcfg) == sum(
        v.size for v in flat.values())
    assert tcfg.moe == tmoe.MoeConfig(n_experts=N_EXPERTS)


@pytest.mark.parametrize("remat_on,policy", [(False, "full"),
                                             (True, "full"),
                                             (True, "proj")])
def test_apply_loss_aux_and_grads_match_jax(model, remat_on, policy):
    jcfg, tree, tcfg, _ = model
    jcfg = dataclasses.replace(jcfg, remat=remat_on, remat_policy=policy)
    tcfg = dataclasses.replace(tcfg, remat=remat_on, remat_policy=policy)
    rng = np.random.default_rng(2)
    batch = {"tokens": rng.integers(0, 256, size=(2, 17)).astype(np.int32)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (j_loss, j_m), j_grads = jax.value_and_grad(
        lambda p: jllama.loss_fn(jcfg, p, jb), has_aux=True)(_jnp(tree))
    j_logits, j_aux = jllama.apply(jcfg, _jnp(tree), jb["tokens"][:, :-1],
                                   return_aux=True)

    params = tllama.params_from_numpy(tcfg, tree, device="cpu")
    for p in _leaves(params).values():
        p.requires_grad_(True)
    loss, m = tllama.loss_fn(tcfg, params, {"tokens": torch.from_numpy(
        batch["tokens"])})
    loss.backward()
    with torch.no_grad():
        logits, aux = tllama.apply(
            tcfg, params, torch.from_numpy(batch["tokens"][:, :-1]).long(),
            return_aux=True)
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits),
                               atol=ATOL)
    np.testing.assert_allclose(aux.item(), float(j_aux), atol=1e-6)
    assert aux.item() > 0
    np.testing.assert_allclose(loss.item(), float(j_loss), atol=ATOL)
    assert set(m) == set(j_m) == {"loss", "loss_weight", "moe_aux_loss"}
    np.testing.assert_allclose(m["moe_aux_loss"].item(),
                               float(j_m["moe_aux_loss"]), atol=1e-6)
    jg = _leaves(j_grads)
    for name, p in _leaves(params).items():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jg[name]),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)


def test_moe_init_draws_the_dense_models_attention_first():
    """A seed gives the dense and the MoE config the same embedding and
    attention weights: the MLP (dense or experts) is drawn last, so the
    dense model's weights for a seed are what they were before MoE."""
    dense_cfg = tllama.LlamaConfig.tiny(dtype=torch.float32)
    moe_cfg = dataclasses.replace(dense_cfg, n_experts=N_EXPERTS)
    dense, moe = (tllama.init_params(c, torch.Generator().manual_seed(5),
                                     device="cpu")
                  for c in (dense_cfg, moe_cfg))
    assert torch.equal(dense["embed"]["weight"], moe["embed"]["weight"])
    for k in ("wq", "wk", "wv", "wo"):
        assert torch.equal(dense["layers"][k], moe["layers"][k]), k
    assert list(dense["layers"])[-3:] == ["w_gate", "w_up", "w_down"]


def test_dense_apply_aux_is_zero():
    cfg = tllama.LlamaConfig.tiny(dtype=torch.float32)
    params = tllama.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    tokens = torch.zeros((1, 5), dtype=torch.long)
    logits, aux = tllama.apply(cfg, params, tokens, return_aux=True)
    assert aux.item() == 0.0 and logits.shape == (1, 5, 256)
    _, m = tllama.loss_fn(cfg, params, {"tokens": tokens})
    assert "moe_aux_loss" not in m


# ---------------------------------------------------------------------------
# serving: capacity follows the S of each call, as in JAX's engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(1)
    return [rng.integers(1, 250, size=n).tolist() for n in LENGTHS]


@pytest.mark.parametrize("kw", [
    dict(kv_layout="dense"),
    dict(kv_layout="paged", prefill_chunk=8),
    dict(kv_layout="dense", spec_draft_len=3, prefix_cache_rows=4),
], ids=["dense", "paged-chunked", "spec-prefix"])
def test_engine_greedy_streams_equal_jax(model, prompts, kw):
    """Prefill buckets (S = P), decode steps (S = 1, capacity
    `min_capacity`), prefill chunks and speculative verifies (S = K + 1)
    each route their own S, as the JAX engine's do."""
    jcfg, tree, tcfg, tparams = model
    # five prompts over three slots: a queue, and (chunk 8) prompts of
    # one to three chunks
    prompts = prompts[:5]
    want = [list(map(int, r)) for r in JaxBatcher(
        jcfg, _jnp(tree), **ENGINE, **kw).generate_all(prompts)]
    got = [list(map(int, r)) for r in ContinuousBatcher(
        tcfg, tparams, device="cpu", **ENGINE, **kw).generate_all(prompts)]
    assert got == want


# ---------------------------------------------------------------------------
# RL: an MoE actor rolls out in lockstep
# ---------------------------------------------------------------------------


def test_ppo_over_an_moe_actor_takes_the_lockstep_rollout(model):
    """rl/ppo.py: an MoE actor's S = 1 decode logits are not the
    teacher-forced distribution the PPO ratio uses, so "auto" takes the
    lockstep rollout (full forwards, as JAX's) and "continuous" raises.
    The greedy rollout's tokens equal JAX's, logprobs within 1e-5."""
    jcfg, tree, tcfg, tparams = model
    max_len = 12
    rng = np.random.default_rng(3)
    prompts = np.zeros((3, max_len), np.int32)
    lens = np.array([2, 4, 3], np.int32)
    for b, n in enumerate(lens):
        prompts[b, :n] = rng.integers(1, 250, size=n)
    critic = {"embed": np.asarray(jax.random.normal(
        jax.random.PRNGKey(1), (256, 16))) * 0.1,
        "v": np.asarray(jax.random.normal(jax.random.PRNGKey(2), (16,)))}

    def reward(tokens, prompt_lens):
        return (tokens == 3).sum(1) * 1.0

    jeng = JEngine(
        actor=JSpec(lambda p, t: jllama.apply(jcfg, p, t), _jnp(tree),
                    trainable=True, model_cfg=jcfg),
        critic=JSpec(lambda p, t: p["embed"][t] @ p["v"], _jnp(critic),
                     trainable=True),
        reward_fn=lambda t, n: jnp.sum(t == 3, axis=1).astype(jnp.float32))
    teng = ModelEngine(
        actor=ModelSpec(lambda p, t: tllama.apply(tcfg, p, t), tparams,
                        trainable=True, model_cfg=tcfg),
        critic=ModelSpec(lambda p, t: p["embed"][t] @ p["v"],
                         {k: torch.from_numpy(v.copy())
                          for k, v in critic.items()}, trainable=True),
        reward_fn=lambda t, n: reward(t, n).float())
    want = jppo.PpoTrainer(
        jeng, jppo.PpoConfig(max_len=max_len, temperature=0.0),
        eos_id=-1).make_experience(jnp.asarray(prompts), jnp.asarray(lens),
                                   jax.random.PRNGKey(0))
    trainer = PpoTrainer(teng, PpoConfig(max_len=max_len, temperature=0.0),
                         eos_id=-1, device="cpu")
    called = []
    trainer._continuous_rollout = lambda *a, **k: called.append(1)
    got = trainer.make_experience(prompts, lens)
    assert not called
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    np.testing.assert_array_equal(got.mask, np.asarray(want.mask))
    np.testing.assert_allclose(got.logprobs, np.asarray(want.logprobs),
                               atol=1e-5)
    with pytest.raises(ValueError, match="MoE"):
        PpoTrainer(teng, PpoConfig(max_len=max_len, temperature=0.0,
                                   rollout_engine="continuous"),
                   eos_id=-1, device="cpu").make_experience(prompts, lens)
