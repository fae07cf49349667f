"""The port's training path (dlrover_tpu_torch: models/llama.py `apply`
and `loss_fn`, parallel/accelerate.py, trainer/) against the JAX
package on the same numbers. Params are drawn by the JAX `init_params`
and carried across with `params_from_numpy(..., dtype=torch.float32)`
(f32 storage, as both packages train); tokens and masks come from a
numpy seed. Flash attention runs its plain versions on the CPU (the
port) and the Pallas kernels in interpret mode (JAX).

Tolerances, each relative to the largest |value| of the tensor compared:
- f32 compute: 1e-4 for logits, loss and gradients (f32 throughout on
  both sides; sums in another order, flash's online softmax against
  one pass).
- bf16 compute: 2^-5 for logits and loss, 2^-4 for gradients. Both
  sides round the same values to bf16, but at other points (XLA fuses
  and may keep f32 inside a fusion; the port's embedding gradient sums
  in f32 where JAX's gather-of-cast sums in bf16; the port's flash
  backward sums GQA groups in f32), and a value near a rounding
  boundary may round the other way; the differences carry through two
  layers and the backward.
- AdamW steps: loss and grad_norm 1e-5 relative; each param leaf's
  distance from JAX's within 1e-2 of the distance JAX's has moved from
  the initial values (L2 norms). Adam divides each gradient by its own
  magnitude, so a gradient element near zero, where the 1e-4 (of the
  largest) gradient agreement is no agreement at all, moves by up to
  lr either way; a norm over the leaf weighs those few elements by
  their share.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dlrover_tpu.models import llama as jllama
from dlrover_tpu.parallel.accelerate import Strategy as JStrategy
from dlrover_tpu.parallel.accelerate import accelerate as jaccelerate
from dlrover_tpu.parallel.mesh import MeshSpec
from dlrover_tpu.trainer.elastic.data import elastic_batch_plan as j_plan
from dlrover_tpu.trainer.elastic.trainer import ElasticTrainer as JElastic
from dlrover_tpu.trainer.trainer import Trainer as JTrainer
from dlrover_tpu.trainer.trainer import TrainerCallback as JCallback
from dlrover_tpu.trainer.trainer import TrainingArguments as JArgs
from dlrover_tpu_torch.models import llama as tllama
from dlrover_tpu_torch.parallel import amp, remat
from dlrover_tpu_torch.parallel.accelerate import Strategy, accelerate
from dlrover_tpu_torch.trainer.elastic.data import elastic_batch_plan
from dlrover_tpu_torch.trainer.elastic.trainer import ElasticTrainer
from dlrover_tpu_torch.trainer.trainer import (
    Trainer,
    TrainerCallback,
    TrainingArguments,
)

F32_REL = 1e-4
BF16_REL = 2 ** -5
BF16_GRAD_REL = 2 ** -4
ADAM_REL = 1e-2
SCALAR_REL = 1e-5
# head_dim 32 (the flash kernels' smallest), S = 128 (the JAX kernel's
# smallest block)
SHAPE = dict(vocab_size=256, dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
             mlp_dim=256)
SEQ = 128


def _cfgs(dtype="f32", attn="reference", remat_on=False):
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jcfg = jllama.LlamaConfig.tiny(**SHAPE, dtype=jdt, attn_impl=attn,
                                   remat=remat_on)
    tcfg = tllama.LlamaConfig.tiny(**SHAPE, dtype=tdt, attn_impl=attn,
                                   remat=remat_on)
    return jcfg, tcfg


def _jax_init(jcfg, seed=0):
    return jax.tree_util.tree_map(
        np.asarray, jllama.init_params(jcfg, jax.random.PRNGKey(seed))
    )


def _port_params(tcfg, tree):
    params = tllama.params_from_numpy(tcfg, tree, device="cpu",
                                      dtype=torch.float32)
    for x in _leaves(params).values():
        x.requires_grad_(True)
    return params


def _leaves(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out.update(_leaves(tree[k], prefix + k + "/"))
        else:
            out[prefix + k] = tree[k]
    return out


def _batch(seed, b=2, s=SEQ, vocab=256, mask=False):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, vocab, size=(b, s + 1)).astype(
        np.int32)}
    if mask:
        m = (rng.random((b, s + 1)) < 0.7).astype(np.float32)
        m[0, : s // 2] = 0.0      # rows with different valid counts
        batch["loss_mask"] = m
    return batch


def _t_batch(batch):
    return {k: torch.from_numpy(v).long() if k == "tokens"
            else torch.from_numpy(v) for k, v in batch.items()}


def _close(got, want, rel, what):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: max err {err} > {rel} x {scale}"


def _np(x):
    return x.detach().float().numpy()


@pytest.mark.parametrize(
    "dtype,attn,mask,remat_on",
    [
        ("f32", "reference", False, False),
        ("f32", "reference", True, True),
        ("f32", "flash", False, True),
        ("f32", "flash", True, False),
        ("bf16", "reference", True, False),
        ("bf16", "reference", False, True),
        ("bf16", "flash", False, True),
        ("bf16", "flash", True, False),
    ],
)
def test_apply_loss_and_grads_match_jax(dtype, attn, mask, remat_on):
    jcfg, tcfg = _cfgs(dtype, attn, remat_on)
    tree = _jax_init(jcfg)
    batch = _batch(1, mask=mask)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (j_loss, j_m), j_grads = jax.value_and_grad(
        lambda p: jllama.loss_fn(jcfg, p, jb), has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, tree))
    j_logits = jllama.apply(jcfg, tree, jb["tokens"][:, :-1])

    params = _port_params(tcfg, tree)
    tb = _t_batch(batch)
    loss, m = tllama.loss_fn(tcfg, params, tb)
    loss.backward()
    with torch.no_grad():
        logits = tllama.apply(tcfg, params, tb["tokens"][:, :-1])
    rel = F32_REL if dtype == "f32" else BF16_REL
    grad_rel = F32_REL if dtype == "f32" else BF16_GRAD_REL
    assert logits.dtype == torch.float32
    _close(_np(logits), j_logits, rel, "logits")
    _close(_np(loss), j_loss, rel, "loss")
    assert float(m["loss_weight"]) == float(j_m["loss_weight"])
    j_leaves = _leaves(j_grads)
    t_leaves = _leaves(params)
    assert sorted(j_leaves) == sorted(t_leaves)
    for name, p in t_leaves.items():
        assert p.grad is not None and p.grad.dtype == torch.float32, name
        _close(_np(p.grad), j_leaves[name], grad_rel, f"d{name}")


def _optimizer(lr=1e-4, weight_decay=1e-4):
    return lambda params: torch.optim.AdamW(
        params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
        weight_decay=weight_decay)


@pytest.mark.parametrize(
    "grad_accum,mask,loss_scale",
    [(1, False, False), (2, True, False), (1, True, True)],
    ids=["plain", "accum2-mask", "loss-scale"],
)
def test_accelerate_adamw_steps_match_jax(grad_accum, mask, loss_scale):
    jcfg, tcfg = _cfgs("f32")
    tree = _jax_init(jcfg)
    j_acc = jaccelerate(
        init_params=lambda k: jllama.init_params(jcfg, k),
        loss_fn=lambda p, b, m: jllama.loss_fn(jcfg, p, b, mesh=m),
        rules=jllama.partition_rules(jcfg),
        optimizer=optax.adamw(1e-4),
        strategy=JStrategy(mesh=MeshSpec.fit(1), grad_accum=grad_accum,
                           loss_scale=loss_scale),
        devices=jax.devices()[:1],
    )
    j_state = j_acc.init(jax.random.PRNGKey(0))
    t_acc = accelerate(
        init_params=lambda g: tllama.params_from_numpy(
            tcfg, tree, device="cpu", dtype=torch.float32),
        loss_fn=lambda p, b: tllama.loss_fn(tcfg, p, b),
        optimizer=_optimizer(),
        strategy=Strategy(device="cpu", grad_accum=grad_accum,
                          loss_scale=loss_scale),
    )
    t_state = t_acc.init(torch.Generator().manual_seed(0))
    for step in range(3):
        batch = _batch(10 + step, b=4, mask=mask)
        if grad_accum > 1:
            batch = {k: v.reshape((grad_accum, 4 // grad_accum)
                                  + v.shape[1:]) for k, v in batch.items()}
        j_state, j_m = j_acc.train_step(j_state, j_acc.shard_batch(batch))
        t_state, t_m = t_acc.train_step(t_state, _t_batch(batch))
        for key in ("loss", "grad_norm"):
            _close(_np(t_m[key]), j_m[key], SCALAR_REL, f"step {step} {key}")
        if loss_scale:
            assert float(t_m["loss_scale"]) == float(j_m["loss_scale"])
        j_leaves = _leaves(jax.device_get(j_state["params"]))
        for name, p in _leaves(t_state["params"]).items():
            want = np.asarray(j_leaves[name])
            moved = np.linalg.norm(want - _leaves(tree)[name])
            err = np.linalg.norm(_np(p) - want)
            assert err <= ADAM_REL * moved, (step, name, err, moved)
    assert t_state["step"] == 3


def test_loss_scale_skips_a_non_finite_step():
    """A scale that overflows the scaled gradients: the step leaves the
    params and the optimizer state as they were, backs the scale off,
    and counts the step, as the JAX step does."""
    _, tcfg = _cfgs("f32")
    tree = _jax_init(_cfgs("f32")[0])
    t_acc = accelerate(
        init_params=lambda g: tllama.params_from_numpy(
            tcfg, tree, device="cpu", dtype=torch.float32),
        loss_fn=lambda p, b: tllama.loss_fn(tcfg, p, b),
        optimizer=_optimizer(),
        strategy=Strategy(device="cpu", loss_scale=True),
    )
    state = t_acc.init(torch.Generator().manual_seed(0))
    state["loss_scale"] = amp.init_loss_scale(3e38, device="cpu")
    before = {k: v.detach().clone() for k, v in _leaves(state["params"]).items()}
    state, m = t_acc.train_step(state, _t_batch(_batch(3, b=2)))
    assert not torch.isfinite(m["grad_norm"])
    for name, p in _leaves(state["params"]).items():
        assert torch.equal(p.detach(), before[name]), name
    assert state["opt_state"].state == {}
    assert float(m["loss_scale"]) == pytest.approx(1.5e38)
    assert int(state["loss_scale"].good_steps) == 0 and state["step"] == 1
    want = amp.adjust_loss_scale(
        amp.init_loss_scale(2.0, device="cpu"), torch.tensor(True),
        growth_interval=1)
    assert float(want.scale) == 4.0 and int(want.good_steps) == 0


def test_init_loss_scale_defaults_to_the_card(monkeypatch):
    """F4: `init_loss_scale()` with no device resolves to the card, as
    every entry point of the port does, so it raises where CUDA is
    missing instead of running on the CPU; naming the CPU still works."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        amp.init_loss_scale()
    st = amp.init_loss_scale(8.0, device="cpu")
    assert st.scale.device.type == "cpu" and float(st.scale) == 8.0


def test_elastic_batch_plan_matches_jax():
    for global_bs in range(1, 49):
        for replicas in (1, 2, 3, 4, 8):
            for max_per in (1, 2, 3, 4, 8, 16):
                if global_bs % replicas:
                    with pytest.raises(ValueError):
                        elastic_batch_plan(global_bs, replicas, max_per)
                    continue
                assert elastic_batch_plan(global_bs, replicas, max_per) == (
                    j_plan(global_bs, replicas, max_per))


class _Recorder(TrainerCallback):
    def __init__(self):
        self.events, self.losses = [], []

    def on_train_begin(self, trainer, state):
        self.events.append("begin")

    def on_step_end(self, trainer, state, metrics):
        self.events.append(f"step{trainer.global_step}")

    def on_log(self, trainer, state, logs):
        self.events.append(f"log{logs['step']}")
        self.losses.append(logs["loss"])

    def on_evaluate(self, trainer, state, metrics):
        self.events.append(f"eval{trainer.global_step}")

    def on_train_end(self, trainer, state):
        self.events.append("end")


class _JRecorder(JCallback):
    def __init__(self):
        self.losses = []

    def on_log(self, trainer, state, logs):
        self.losses.append(logs["loss"])


def _memorize_batches(n):
    batch = _batch(7, b=4, s=32)
    return [batch] * n


def test_trainer_loop_matches_jax_and_memorizes(tmp_path, monkeypatch):
    """30 Trainer steps (global batch 4 in microbatches of 2, Adam at
    lr 1e-2 as examples/train_tiny_llama.py) on one repeated batch: the
    port's logged losses follow the JAX Trainer's and fall."""
    monkeypatch.setenv("DLROVER_TPU_RUNTIME_METRICS_PATH",
                       str(tmp_path / "runtime.json"))
    monkeypatch.setenv("DLROVER_TPU_CHIP_METRICS_PATH",
                       str(tmp_path / "chip.json"))
    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32)
    tcfg = tllama.LlamaConfig.tiny(dtype=torch.float32)
    tree = _jax_init(jcfg)
    data = _memorize_batches(30)

    j_et = JElastic(
        lambda k: jllama.init_params(jcfg, k),
        lambda p, b, m: jllama.loss_fn(jcfg, p, b, mesh=m),
        jllama.partition_rules(jcfg), optax.adam(1e-2),
        global_batch_size=4, max_per_replica_batch=2,
        mesh_spec=MeshSpec.fit(1), devices=jax.devices()[:1],
    )
    j_rec = _JRecorder()
    JTrainer(j_et, JArgs(logging_steps=1, resume=False, save_steps=0),
             train_data=data, callbacks=[j_rec]).train(
        j_et.init_state(jax.random.PRNGKey(0)))

    et = ElasticTrainer(
        lambda g: tllama.params_from_numpy(tcfg, tree, device="cpu",
                                           dtype=torch.float32),
        lambda p, b: tllama.loss_fn(tcfg, p, b),
        _optimizer(lr=1e-2, weight_decay=0.0),
        global_batch_size=4, max_per_replica_batch=2, device="cpu",
    )
    assert et.grad_accum == 2
    rec = _Recorder()
    Trainer(et, TrainingArguments(logging_steps=1, resume=False),
            train_data=data, callbacks=[rec]).train()
    assert len(rec.losses) == len(j_rec.losses) == 30
    np.testing.assert_allclose(rec.losses, j_rec.losses, rtol=1e-3)
    assert rec.losses[-1] < 0.5 * rec.losses[0]


def test_trainer_max_steps_callbacks_eval_and_metrics(tmp_path, monkeypatch):
    import json

    monkeypatch.setenv("DLROVER_TPU_RUNTIME_METRICS_PATH",
                       str(tmp_path / "runtime.json"))
    monkeypatch.setenv("DLROVER_TPU_CHIP_METRICS_PATH",
                       str(tmp_path / "chip.json"))
    tcfg = tllama.LlamaConfig.tiny(dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    et = ElasticTrainer(
        lambda g: tllama.init_params(tcfg, g, device="cpu",
                                     dtype=torch.float32),
        lambda p, b: tllama.loss_fn(tcfg, p, b),
        _optimizer(), global_batch_size=2, max_per_replica_batch=2,
        device="cpu",
    )
    rec = _Recorder()
    data = _memorize_batches(3)
    trainer = Trainer(
        et, TrainingArguments(max_steps=4, num_epochs=5, logging_steps=2,
                              eval_steps=3, resume=False),
        train_data=[{"tokens": b["tokens"][:2]} for b in data],
        eval_data=[{"tokens": data[0]["tokens"][:2]}], callbacks=[rec])
    state = trainer.train(et.init_state(gen))
    assert trainer.global_step == 4 and state["step"] == 4
    assert rec.events == ["begin", "step1", "step2", "log2", "step3",
                          "eval3", "step4", "log4", "end"]
    assert set(trainer.last_logs) == {"loss", "loss_weight", "grad_norm",
                                      "steps_per_sec", "step"}
    runtime = json.loads((tmp_path / "runtime.json").read_text())
    assert runtime["step"] == 4 and runtime["loss"] == rec.losses[-1]
    chip = json.loads((tmp_path / "chip.json").read_text())
    assert chip["chips"] == [] and "ts" in chip
    logs = trainer.evaluate(state)
    assert set(logs) == {"eval_loss", "eval_loss_weight"}


class _CountingElastic:
    """An elastic trainer whose step only counts and reports a loss: the
    Trainer loop around it is what is under test."""

    def __init__(self):
        self.steps = 0

    def step(self, state, batch):
        self.steps += 1
        return state, {"loss": 1.0}


def test_trainer_keeps_training_when_chip_metrics_cannot_be_written(
        tmp_path, monkeypatch):
    """The card-metrics file lies under a regular file, so it cannot be
    written: the JAX Trainer swallows the error and so does the port's.
    Both take all 3 steps (logging every step, so every step tries the
    write); the step-metrics file beside it is still written."""
    import json

    blocker = tmp_path / "a_file"
    blocker.write_text("")
    monkeypatch.setenv("DLROVER_TPU_CHIP_METRICS_PATH",
                       str(blocker / "chip.json"))
    monkeypatch.setenv("DLROVER_TPU_RUNTIME_METRICS_PATH",
                       str(tmp_path / "runtime.json"))
    data = [{"tokens": None}] * 3
    j_et, t_et = _CountingElastic(), _CountingElastic()
    jt = JTrainer(j_et, JArgs(logging_steps=1, resume=False, save_steps=0),
                  train_data=data)
    jt.train({})
    tt = Trainer(t_et, TrainingArguments(logging_steps=1, resume=False),
                 train_data=data)
    tt.train({})
    assert j_et.steps == t_et.steps == 3
    assert jt.global_step == tt.global_step == 3
    assert json.loads((tmp_path / "runtime.json").read_text())["step"] == 3


def test_not_ported_options_raise(tmp_path, monkeypatch):
    """What ROADMAP queue 1 has not ported raises: the Orbax format (item
    9) and a mesh with sharded state (item 13). Fused cross entropy
    (item 5), checkpoint save and resume (item 8), the named remat
    policies (item 6), the master client, a world change and the
    checkpoint replica (ported since) work: `resume` defaults to True
    as in JAX, a `master_client` reaches the HangingDetector, a world
    change with no world keeps the state and the plan, an engine takes
    a replica manager, every policy name resolves, and a loss under
    "proj" equals the plain one."""
    from dlrover_tpu_torch.trainer.flash_checkpoint import (
        CheckpointEngine,
        OrbaxCheckpointer,
    )

    monkeypatch.setenv("DLROVER_TPU_SHM_DIR", str(tmp_path))
    monkeypatch.setenv("DLROVER_TPU_JOB_NAME",
                       f"torch-train-options-{os.getpid()}")
    tcfg = tllama.LlamaConfig.tiny(dtype=torch.float32)
    et = ElasticTrainer(
        lambda g: tllama.init_params(tcfg, g, device="cpu"),
        lambda p, b: tllama.loss_fn(tcfg, p, b),
        _optimizer(), global_batch_size=2, max_per_replica_batch=2,
        device="cpu",
    )
    trainer = Trainer(et, TrainingArguments(output_dir=str(tmp_path)))
    assert trainer.args.resume is True and trainer.checkpointer is not None
    trainer.checkpointer.close()
    trainer = Trainer(et, TrainingArguments(output_dir=str(tmp_path),
                                            save_steps=5, resume=False))
    assert trainer.checkpointer is not None
    trainer.checkpointer.close()
    assert Trainer(et, TrainingArguments(resume=False)).checkpointer is None
    client = object()
    trainer = Trainer(et, TrainingArguments(resume=False),
                      master_client=client)
    assert trainer._mc is client and trainer._hang._mc is client
    state = et.init_state(torch.Generator().manual_seed(0))
    plan = dict(et.plan)
    assert et.on_world_change(state) is state and et.plan == plan
    CheckpointEngine(str(tmp_path), replica_manager=object()).close()
    with pytest.raises(NotImplementedError, match="item 9"):
        OrbaxCheckpointer(str(tmp_path))
    from dlrover_tpu_torch.parallel.mesh import MeshSpec

    with pytest.raises(NotImplementedError, match="item 13"):
        ElasticTrainer(
            lambda g: tllama.init_params(tcfg, g, device="cpu"),
            lambda p, b: tllama.loss_fn(tcfg, p, b), _optimizer(),
            global_batch_size=2, max_per_replica_batch=2, device="cpu",
            mesh_spec=MeshSpec(fsdp=2))
    for name in ("dots", "dots_no_batch", "proj", "proj_mlp", "save_names",
                 "offload_names"):
        assert callable(remat.resolve_policy(name))
    with pytest.raises(ValueError, match="unknown remat"):
        remat.resolve_policy("most")
    params = tllama.init_params(tcfg, torch.Generator().manual_seed(0),
                                device="cpu")
    batch = _t_batch(_batch(0, s=16))
    cfg = dataclasses.replace(tcfg, remat=True, remat_policy="proj")
    fused, _ = tllama.loss_fn(dataclasses.replace(tcfg, fused_ce=True),
                              params, batch)
    plain, _ = tllama.loss_fn(tcfg, params, batch)
    proj, _ = tllama.loss_fn(cfg, params, batch)
    assert torch.equal(proj, plain)
    _close(_np(fused), _np(plain), F32_REL, "fused_ce loss")


def _ckpt_trainer(tmp_path, max_steps, save_steps, resume, seed):
    tcfg = tllama.LlamaConfig.tiny(dtype=torch.float32)
    et = ElasticTrainer(
        lambda g: tllama.init_params(tcfg, g, device="cpu",
                                     dtype=torch.float32),
        lambda p, b: tllama.loss_fn(tcfg, p, b),
        _optimizer(lr=1e-3), global_batch_size=2, max_per_replica_batch=2,
        device="cpu",
    )
    data = [{"tokens": _batch(20 + i, b=2, s=16)["tokens"]}
            for i in range(10)]
    trainer = Trainer(et, TrainingArguments(
        output_dir=str(tmp_path), max_steps=max_steps, logging_steps=0,
        save_steps=save_steps, resume=resume, publish_step_metrics=False),
        train_data=data)
    return trainer, et.init_state(torch.Generator().manual_seed(seed))


def _state_bits(state):
    from dlrover_tpu_torch.trainer.flash_checkpoint.engine import (
        flatten_state,
    )

    return {k: v.tobytes() for k, v in flatten_state(state)[0].items()}


def test_trainer_save_resume_roundtrip(tmp_path, monkeypatch):
    """save_steps=2 over 4 steps (memory saves at 2 and 4, the DISK save
    at the end); a new Trainer from another seed with resume=True
    restores step 4 bit-equal on every leaf (memory first, and from
    disk once the segment is gone), skips the 4 consumed batches, and
    its steps 5 and 6 equal those of the Trainer that goes on."""
    monkeypatch.setenv("DLROVER_TPU_SHM_DIR", str(tmp_path))
    monkeypatch.setenv("DLROVER_TPU_JOB_NAME",
                       f"torch-train-resume-{os.getpid()}")
    from dlrover_tpu_torch.agent.ckpt_saver import AsyncCheckpointSaver
    from dlrover_tpu_torch.common.multi_process import LocalSocketServer

    # the agent: its IPC server holds the staged step across Trainers,
    # its saver persists
    agent = LocalSocketServer(os.environ["DLROVER_TPU_JOB_NAME"])
    agent.start()
    saver = AsyncCheckpointSaver(job_name=os.environ["DLROVER_TPU_JOB_NAME"])
    saver.start()
    try:
        saves = []

        class OnSave(TrainerCallback):
            def on_save(self, trainer, state, step):
                saves.append(step)

        tr, state = _ckpt_trainer(tmp_path, 4, 2, False, 0)
        tr.callbacks.append(OnSave())
        state = tr.train(state)
        assert saves == [2, 4, 4] and tr.global_step == 4
        assert tr.checkpointer.wait_latest_checkpoint(4, timeout=30)
        saved = _state_bits(state)
        tr.checkpointer.close()
        assert os.path.exists(tmp_path / "checkpoints" / "4" / "host_0.npz")

        tr_on, _ = _ckpt_trainer(tmp_path, 6, 0, False, 0)
        tr_on.global_step = 4
        on = tr_on.train(state)          # the uninterrupted steps 5, 6

        for source in ("memory", "disk"):
            tr2, st2 = _ckpt_trainer(tmp_path, 6, 0, True, 1)
            assert _state_bits(st2) != saved
            st2 = tr2._maybe_resume(st2)
            assert tr2.global_step == 4 and st2["step"] == 4, source
            assert _state_bits(st2) == saved, source
            if source == "memory":
                tr2.checkpointer.engine.shm_handler.close(unlink=True)
                tr2.checkpointer.close()
                continue
            tr2.global_step = 0          # train() resumes again
            st2 = tr2.train(st2)
            tr2.checkpointer.close()
            assert tr2.global_step == 6
            assert _state_bits(st2) == _state_bits(on)
    finally:
        saver.stop()
        assert saver.join(timeout=10)
        saver.shm_handler.close()
        agent.stop()


def test_resume_with_nothing_saved_is_a_no_op(tmp_path, monkeypatch):
    monkeypatch.setenv("DLROVER_TPU_SHM_DIR", str(tmp_path))
    monkeypatch.setenv("DLROVER_TPU_JOB_NAME",
                       f"torch-train-noop-{os.getpid()}")
    tr, state = _ckpt_trainer(tmp_path, 2, 0, True, 0)
    before = _state_bits(state)
    try:
        assert tr._maybe_resume(state) is state
        assert tr.global_step == 0 and _state_bits(state) == before
        state = tr.train(state)
        assert tr.global_step == 2 and state["step"] == 2
    finally:
        tr.checkpointer.close()
    assert not (tmp_path / "checkpoints").exists()


def test_hanging_detector_logs_one_hang_until_the_next_step(caplog):
    """No step for longer than the timeout: one error is logged (not one
    per check), and a step re-arms the detector."""
    import logging
    import time

    from dlrover_tpu_torch.utils.hanging_detector import HangingDetector

    def hangs():
        return [r.getMessage() for r in caplog.records
                if "training hang" in r.getMessage()]

    def wait_for(n):
        t0 = time.monotonic()
        while len(hangs()) < n and time.monotonic() - t0 < 10.0:
            time.sleep(0.01)

    port_logger = logging.getLogger("dlrover_tpu_torch")  # propagate=False
    port_logger.addHandler(caplog.handler)
    det = HangingDetector(timeout=0.05, check_interval=0.01)
    try:
        det.start()
        time.sleep(0.2)                    # no step yet: start-up, no hang
        assert hangs() == []
        det.record_step(1)
        wait_for(1)
        time.sleep(0.2)                    # ~20 more checks, still stalled
        assert len(hangs()) == 1 and "last step 1" in hangs()[0]
        det.record_step(2)
        assert det.stalled_seconds() < 0.05
        wait_for(2)
        assert len(hangs()) == 2 and "last step 2" in hangs()[1]
        det.stop()
        assert det._thread is None
    finally:
        det.stop()
        port_logger.removeHandler(caplog.handler)


def test_remat_full_recomputes_each_layer_in_backward(monkeypatch):
    """cfg.remat with policy "full" checkpoints every layer: the layer
    forward runs again in the backward (once per layer), and the
    gradients are those of the unchecked forward."""
    from dlrover_tpu_torch.ops import attention as tattn

    calls = []
    real = tattn.reference_attention
    monkeypatch.setattr(tattn, "reference_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    tcfg = tllama.LlamaConfig.tiny(dtype=torch.float32)
    tree = _jax_init(jllama.LlamaConfig.tiny())
    batch = _t_batch(_batch(5, s=16))
    grads = {}
    for on in (False, True):
        cfg = dataclasses.replace(tcfg, remat=on)
        params = _port_params(cfg, tree)
        calls.clear()
        loss, _ = tllama.loss_fn(cfg, params, batch)
        loss.backward()
        assert len(calls) == cfg.n_layers * (2 if on else 1)
        grads[on] = {k: v.grad for k, v in _leaves(params).items()}
    for name in grads[False]:
        torch.testing.assert_close(grads[True][name], grads[False][name])


def test_init_params_storage_dtype():
    tcfg = tllama.LlamaConfig.tiny()
    gen = torch.Generator().manual_seed(0)
    serve = tllama.init_params(tcfg, gen, device="cpu")
    train = tllama.init_params(tcfg, gen, device="cpu",
                               dtype=tcfg.param_dtype)
    assert {x.dtype for x in _leaves(serve).values()} == {torch.bfloat16}
    assert {x.dtype for x in _leaves(train).values()} == {torch.float32}
    assert tllama.flops_per_token(tcfg, 128, causal=True) == (
        jllama.flops_per_token(jllama.LlamaConfig.tiny(), 128, causal=True))
