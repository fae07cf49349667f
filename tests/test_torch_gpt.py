"""The port's GPT-2 family (dlrover_tpu_torch/models/gpt.py, its decode in
models/decode.py, serving through serving/engine.py, training through
parallel/accelerate.py and trainer/) and its normalization layers
(models/normalization.py) against the JAX package on the same numbers.
JAX params are carried across with `params_from_numpy`; inputs come
from numpy seeds.

Tolerances: f32 logits and losses atol 1e-4; gradients rtol 1e-4 /
atol 1e-5; normalization outputs atol 1e-5 (one f32 reduction in
another order); greedy token streams and the int8 install EXACT (f32
compute: both engines quantize the same f32 values).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dlrover_tpu.models import decode as jdec
from dlrover_tpu.models import gpt as jgpt
from dlrover_tpu.models import normalization as jnorm
from dlrover_tpu.parallel.mesh import MeshSpec
from dlrover_tpu.serving.engine import ContinuousBatcher as JaxBatcher
from dlrover_tpu.trainer.elastic.trainer import ElasticTrainer as JElastic
from dlrover_tpu.trainer.trainer import Trainer as JTrainer
from dlrover_tpu.trainer.trainer import TrainerCallback as JCallback
from dlrover_tpu.trainer.trainer import TrainingArguments as JArgs
from dlrover_tpu_torch.models import decode as tdec
from dlrover_tpu_torch.models import gpt as tgpt
from dlrover_tpu_torch.models import normalization as tnorm
from dlrover_tpu_torch.serving.engine import ContinuousBatcher
from dlrover_tpu_torch.trainer.elastic.trainer import ElasticTrainer
from dlrover_tpu_torch.trainer.trainer import (
    Trainer,
    TrainerCallback,
    TrainingArguments,
)

ATOL = 1e-4
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
NORM_ATOL = 1e-5
ENGINE = dict(n_slots=3, max_len=64, max_new_tokens=10, chunk=4)
LENGTHS = (3, 5, 20, 7, 12, 9, 33)


@pytest.fixture(scope="module")
def model():
    jcfg = jgpt.GptConfig.tiny(dtype=jnp.float32)
    tree = jax.tree_util.tree_map(
        np.asarray, jgpt.init_params(jcfg, jax.random.PRNGKey(0)))
    tcfg = tgpt.GptConfig.tiny(dtype=torch.float32)
    tparams = tgpt.params_from_numpy(tcfg, tree, device="cpu")
    return jcfg, tree, tcfg, tparams


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(1)
    return [rng.integers(1, 250, size=n).tolist() for n in LENGTHS]


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


# ---------------------------------------------------------------------------
# normalization
# ---------------------------------------------------------------------------


def _norm_params(rng, c):
    return {"scale": rng.standard_normal(c).astype(np.float32),
            "bias": rng.standard_normal(c).astype(np.float32)}


def _t(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_layer_and_group_and_rms_norm_match_jax(dtype):
    rng = np.random.default_rng(0)
    x = (3.0 * rng.standard_normal((4, 5, 32)) + 1.5).astype(np.float32)
    p = _norm_params(rng, 32)
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jx, tx = jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)
    atol = NORM_ATOL if dtype == "f32" else 2 ** -6 * 8
    cases = [
        (jnorm.layer_norm(p, jx), tnorm.layer_norm(_t(p), tx)),
        (jnorm.layer_norm_gb(jx, p["scale"], p["bias"], 1e-6),
         tnorm.layer_norm_gb(tx, _t(p)["scale"], _t(p)["bias"], 1e-6)),
        (jnorm.group_norm(p, jx, 4), tnorm.group_norm(_t(p), tx, 4)),
        (jnorm.rms_norm({"scale": p["scale"]}, jx),
         tnorm.rms_norm({"scale": _t(p)["scale"]}, tx)),
    ]
    for want, got in cases:
        assert got.dtype == tdt
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   atol=atol)
    with pytest.raises(ValueError, match="divisible"):
        tnorm.group_norm(_t(p), tx, 5)
    init = tnorm.init_layer_norm(32, device="cpu")
    assert set(init) == {"scale", "bias"} and init["scale"].sum() == 32


def test_batch_norm_running_statistics_match_jax():
    """Training steps update the f32 running mean and the BIASED
    variance at momentum 0.9 as JAX's does; eval normalizes by them and
    returns the params unchanged."""
    rng = np.random.default_rng(1)
    jp = jnorm.init_batch_norm(16)
    tp = tnorm.init_batch_norm(16, device="cpu")
    assert set(tp) == set(jp)
    for step in range(3):
        x = (2.0 * rng.standard_normal((6, 3, 16)) + step).astype(
            np.float32)
        jy, jp = jnorm.batch_norm(jp, jnp.asarray(x))
        ty, tp = tnorm.batch_norm(tp, torch.from_numpy(x))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy),
                                   atol=NORM_ATOL)
        for k in ("mean", "var"):
            assert tp[k].dtype == torch.float32
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       atol=NORM_ATOL, err_msg=k)
    x = rng.standard_normal((5, 16)).astype(np.float32)
    jy, jp2 = jnorm.batch_norm(jp, jnp.asarray(x), training=False)
    ty, tp2 = tnorm.batch_norm(tp, torch.from_numpy(x), training=False)
    assert tp2 is tp
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=NORM_ATOL)
    # not nn.BatchNorm: its running variance is the unbiased one
    bn = torch.nn.BatchNorm1d(16, momentum=0.1)
    bn(torch.from_numpy(x))
    assert not torch.allclose(
        bn.running_var, tnorm.batch_norm(
            tnorm.init_batch_norm(16, device="cpu"),
            torch.from_numpy(x))[1]["var"])


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def test_params_layout_and_presets(model):
    jcfg, tree, tcfg, tparams = model
    for name in ("gpt2", "gpt2_medium", "gpt2_large", "gpt2_xl", "tiny"):
        jc, tc = getattr(jgpt.GptConfig, name)(), getattr(
            tgpt.GptConfig, name)()
        for f in ("vocab_size", "dim", "n_layers", "n_heads",
                  "max_seq_len", "norm_eps", "remat", "head_dim",
                  "mlp_dim"):
            assert getattr(tc, f) == getattr(jc, f), (name, f)
        assert tgpt.num_params(tc) == jgpt.num_params(jc)
    assert tgpt.GptConfig.gpt2_xl().n_kv_heads == 25
    assert tgpt.num_params(tgpt.GptConfig.gpt2_xl()) == 1_557_686_400
    flat = _leaves(tree)
    got = _leaves(tparams)
    assert sorted(got) == sorted(flat)
    assert tgpt.num_params(tcfg) == sum(v.size for v in flat.values())
    for k, v in flat.items():
        np.testing.assert_array_equal(got[k].numpy(), v)
    init = tgpt.init_params(tcfg, torch.Generator().manual_seed(0),
                            device="cpu")
    assert {k: tuple(v.shape) for k, v in _leaves(init).items()} == {
        k: v.shape for k, v in flat.items()}
    # the residual projections carry the extra 1/sqrt(2L)
    assert init["layers"]["wo"].std() < init["layers"]["wqkv"].std()


@pytest.mark.parametrize("remat_on,mask", [(False, False), (True, True)])
def test_apply_loss_and_grads_match_jax(model, remat_on, mask):
    jcfg, tree, tcfg, _ = model
    jcfg = dataclasses.replace(jcfg, remat=remat_on)
    tcfg = dataclasses.replace(tcfg, remat=remat_on)
    rng = np.random.default_rng(2)
    batch = {"tokens": rng.integers(0, 256, size=(2, 33)).astype(np.int32)}
    if mask:
        batch["loss_mask"] = (rng.random((2, 32)) < 0.7).astype(np.float32)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (j_loss, j_m), j_grads = jax.value_and_grad(
        lambda p: jgpt.loss_fn(jcfg, p, jb), has_aux=True)(_jnp(tree))
    j_logits = jgpt.apply(jcfg, _jnp(tree), jb["tokens"][:, :-1])

    params = tgpt.params_from_numpy(tcfg, tree, device="cpu")
    for p in _leaves(params).values():
        p.requires_grad_(True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, m = tgpt.loss_fn(tcfg, params, tb)
    loss.backward()
    with torch.no_grad():
        logits = tgpt.apply(tcfg, params, tb["tokens"][:, :-1].long())
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits),
                               atol=ATOL)
    np.testing.assert_allclose(loss.item(), float(j_loss), atol=ATOL)
    assert float(m["loss_weight"]) == float(j_m["loss_weight"])
    jg = _leaves(j_grads)
    for name, p in _leaves(params).items():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jg[name]),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)


def test_apply_refuses_past_the_position_table(model):
    _, _, tcfg, tparams = model
    tokens = torch.zeros((1, tcfg.max_seq_len + 1), dtype=torch.long)
    with pytest.raises(ValueError, match="position table"):
        tgpt.apply(tcfg, tparams, tokens)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_teacher_forced_decode_equals_apply(model, layout):
    """Prefill then stepped decode (dense bank or page pool) give the
    training forward's logits at every position (JAX
    tests/test_decode.py's teacher-forcing check)."""
    _, _, tcfg, tparams = model
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(0, 256, size=(2, 24))).long()
    want = tgpt.apply(tcfg, tparams, toks)
    p = 8
    if layout == "dense":
        cache = tdec.init_kv_cache(tcfg, 2, 32, device="cpu")
        assert cache["k"].shape == (2, 2, 32, 4, 16)   # n_heads KV heads
        first, cache = tdec.prefill(tcfg, tparams, toks[:, :p], cache)
        got = [first]
        for t in range(p, 24):
            lg, cache = tdec.decode_step(tcfg, tparams, toks[:, t], cache, t)
            got.append(lg)
    else:
        pool = tdec.init_page_pool(tcfg, 9, 8, device="cpu")
        table = torch.arange(1, 9, dtype=torch.int32).reshape(2, 4)
        lg, pool = tdec._forward_paged(
            tcfg, tparams, toks[:, :p], pool, table,
            torch.arange(p).expand(2, p))
        got = [lg[:, -1]]
        for t in range(p, 24):
            lg, pool = tdec.paged_decode_step(
                tcfg, tparams, toks[:, t], pool, table,
                torch.full((2,), t))
            got.append(lg)
    got = torch.stack(got, dim=1)
    np.testing.assert_allclose(got.numpy(), want[:, p - 1:].numpy(),
                               atol=ATOL)


def test_greedy_generate_equals_jax(model):
    jcfg, tree, tcfg, tparams = model
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, 256, size=(2, 6)).astype(np.int32)
    want = np.asarray(jdec.generate(jcfg, _jnp(tree), jnp.asarray(prompt),
                                    12))
    got = tdec.generate(tcfg, tparams, torch.from_numpy(prompt).long(), 12)
    np.testing.assert_array_equal(got.numpy(), want)


def test_decode_refusals_match_jax(model, monkeypatch):
    """JAX tests/test_decode.py:251-311: a decode past the learned
    position table raises (also at engine construction), adapters on
    GPT raise, and GPT at tp > 1 is not served (NotImplementedError)."""
    jcfg, tree, tcfg, tparams = model
    prompt = torch.zeros((1, 120), dtype=torch.long)
    with pytest.raises(ValueError, match="position table"):
        tdec.generate(tcfg, tparams, prompt, 9)
    with pytest.raises(ValueError, match="position table"):
        jdec.generate(jcfg, _jnp(tree), jnp.zeros((1, 120), jnp.int32), 9)
    with pytest.raises(ValueError, match="position table"):
        ContinuousBatcher(tcfg, tparams, max_len=256, device="cpu")
    cache = tdec.init_kv_cache(tcfg, 1, 8, device="cpu")
    adapters = {"bank": {}, "idx": torch.zeros(1, dtype=torch.long),
                "scale": torch.zeros(1)}
    with pytest.raises(ValueError, match="fused qkv"):
        tdec.prefill(tcfg, tparams, prompt[:, :4], cache, adapters=adapters)
    monkeypatch.setenv("DLROVER_TPU_TORCH_FORCE_DEVICE_COUNT", "2")
    with pytest.raises(NotImplementedError, match="tp > 1"):
        ContinuousBatcher(tcfg, tparams, mesh_spec=2, device="cpu", **ENGINE)
    # tp = 1 through the same knob serves
    assert ContinuousBatcher(tcfg, tparams, mesh_spec=1, device="cpu",
                             **ENGINE).mesh is None


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def _streams(engine, prompts):
    return [list(map(int, r)) for r in engine.generate_all(prompts)]


@pytest.mark.parametrize("kw", [
    dict(kv_layout="dense"),
    dict(kv_layout="paged"),
    dict(kv_layout="dense", weight_quant="int8"),
    dict(kv_layout="paged", weight_quant="int8", prefix_cache_rows=4,
         async_depth=1),
    dict(kv_layout="paged", prefill_chunk=8),
], ids=["dense", "paged", "dense-int8", "paged-int8-prefix-async",
        "paged-chunk"])
def test_engine_greedy_streams_equal_jax(model, prompts, kw):
    jcfg, tree, tcfg, tparams = model
    jeng = JaxBatcher(jcfg, _jnp(tree), **ENGINE, **kw)
    teng = ContinuousBatcher(tcfg, tparams, device="cpu", **ENGINE, **kw)
    assert _streams(teng, prompts) == _streams(jeng, prompts)
    if kw.get("prefill_chunk"):
        # prompts of up to 33 tokens in chunks of 8: interleaved chunks ran
        chunks = teng.prefill_stats()["prefill_chunks_total"]
        assert chunks > 0
        assert chunks == jeng.prefill_stats()["prefill_chunks_total"]
    if kw.get("weight_quant") == "int8":
        jl, tl = jeng.params["layers"], teng.params["layers"]
        for name in ("wqkv", "wo", "w_up", "w_down"):
            assert tl[name].q8.numpy().tobytes() == np.asarray(
                jl[name].q8).tobytes(), name
            assert tl[name].s8.numpy().tobytes() == np.asarray(
                jl[name].s8).tobytes(), name
        # the tied wte, the position table and the biases stay dense
        assert torch.is_tensor(teng.params["wte"])
        assert torch.is_tensor(tl["b_qkv"])
        assert teng.weight_bytes_device() == jeng.weight_bytes_device()


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


class _Recorder(TrainerCallback):
    def __init__(self):
        self.losses = []

    def on_log(self, trainer, state, logs):
        self.losses.append(logs["loss"])


class _JRecorder(JCallback):
    def __init__(self):
        self.losses = []

    def on_log(self, trainer, state, logs):
        self.losses.append(logs["loss"])


def test_trainer_steps_match_jax(model, tmp_path, monkeypatch):
    """8 Trainer steps (global batch 4 in microbatches of 2, Adam at lr
    1e-2) on one repeated batch: the port's losses equal the JAX
    Trainer's within the f32 loss tolerance (atol 1e-4) and fall."""
    monkeypatch.setenv("DLROVER_TPU_RUNTIME_METRICS_PATH",
                       str(tmp_path / "runtime.json"))
    monkeypatch.setenv("DLROVER_TPU_CHIP_METRICS_PATH",
                       str(tmp_path / "chip.json"))
    jcfg, tree, tcfg, _ = model
    rng = np.random.default_rng(7)
    data = [{"tokens": rng.integers(0, 256, size=(4, 33)).astype(
        np.int32)}] * 8
    j_et = JElastic(
        lambda k: jgpt.init_params(jcfg, k),
        lambda p, b, m: jgpt.loss_fn(jcfg, p, b, mesh=m),
        jgpt.partition_rules(jcfg), optax.adam(1e-2),
        global_batch_size=4, max_per_replica_batch=2,
        mesh_spec=MeshSpec.fit(1), devices=jax.devices()[:1],
    )
    j_rec = _JRecorder()
    # PRNGKey(0) draws the fixture's tree
    JTrainer(j_et, JArgs(logging_steps=1, resume=False, save_steps=0),
             train_data=data, callbacks=[j_rec]).train(
        j_et.init_state(jax.random.PRNGKey(0)))

    et = ElasticTrainer(
        lambda g: tgpt.params_from_numpy(tcfg, tree, device="cpu",
                                         dtype=torch.float32),
        lambda p, b: tgpt.loss_fn(tcfg, p, b),
        lambda ps: torch.optim.Adam(ps, lr=1e-2),
        global_batch_size=4, max_per_replica_batch=2, device="cpu",
    )
    rec = _Recorder()
    Trainer(et, TrainingArguments(logging_steps=1, resume=False),
            train_data=data, callbacks=[rec]).train()
    assert len(rec.losses) == len(j_rec.losses) == 8
    np.testing.assert_allclose(rec.losses, j_rec.losses, rtol=0, atol=ATOL)
    assert rec.losses[-1] < rec.losses[0]


def test_train_gpt2_example_trains(monkeypatch, capsys):
    """dlrover_tpu_torch/examples/train_gpt2.py, in-process on the CPU:
    the loss falls over a few steps through the port's trainer."""
    from dlrover_tpu_torch.examples import train_gpt2

    monkeypatch.setenv("DLROVER_TPU_FORCE_CPU", "1")
    assert train_gpt2.main(["--steps", "6"]) == 0
    out = capsys.readouterr().out
    assert "done: restart_count=0" in out
