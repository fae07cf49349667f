"""LoRA training in the port (dlrover_tpu_torch/models/lora.py
`lora_labels` / `lora_optimizer`, parallel/accelerate.py, the Trainer
and the flash checkpoint's layout for the frozen-base optimizer)
against the JAX package: JAX's tests/test_lora.py
TestFrozenBaseTraining and TestAdapterCheckpoint on the port, the train
state's keys and values against JAX's after the same steps, and
checkpoints saved by one package restored by the other.

The injected tree is JAX's, carried across as numpy (`params_from_numpy`
takes its `_lora_` leaves along); f32 storage and compute on both sides.

Tolerances: the frozen base, the restored states and the adapter round
trip bit-equal (nothing is computed on them); after 3 optimizer steps
every leaf of the train state within 1e-5 absolute of JAX's (f32 on both
sides: the updates of lr 1e-3 differ by the gradients' last bits, and a
step's gradient of exactly zero, the A leaves' at step 1 with B = 0,
stays zero in both), the loss and grad_norm within 1e-5 relative.
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
from dlrover_tpu.models import lora as jlora
from dlrover_tpu.parallel.accelerate import Strategy as JStrategy
from dlrover_tpu.parallel.accelerate import accelerate as jaccelerate
from dlrover_tpu.parallel.mesh import MeshSpec
from dlrover_tpu.trainer.flash_checkpoint import engine as jengine
from dlrover_tpu_torch.models import llama as tllama
from dlrover_tpu_torch.models import lora as tlora
from dlrover_tpu_torch.parallel.accelerate import (
    Strategy,
    accelerate,
    broadcast_state,
)
from dlrover_tpu_torch.trainer.elastic.trainer import ElasticTrainer
from dlrover_tpu_torch.trainer.flash_checkpoint import CheckpointEngine
from dlrover_tpu_torch.trainer.flash_checkpoint.engine import (
    flatten_state,
    train_state_from_numpy,
)
from dlrover_tpu_torch.trainer.trainer import (
    Trainer,
    TrainerCallback,
    TrainingArguments,
)

STEP_ATOL = 1e-5
SCALAR_REL = 1e-5
LC_J = jlora.LoraConfig(rank=4)
LC_T = tlora.LoraConfig(rank=4)
_SEQ = iter(range(10**6))


def _job(tag):
    return f"torch_lora_{os.getpid()}_{tag}_{next(_SEQ)}"


@pytest.fixture(autouse=True)
def shm_dir(tmp_path, monkeypatch):
    d = tmp_path / "shm"
    d.mkdir()
    monkeypatch.setenv("DLROVER_TPU_SHM_DIR", str(d))
    return d


def _jcfg():
    return dataclasses.replace(jllama.LlamaConfig.tiny(), dtype=jnp.float32)


def _tcfg():
    return tllama.LlamaConfig.tiny(dtype=torch.float32,
                                   lora_alpha=LC_T.alpha)


@pytest.fixture(scope="module")
def injected():
    """JAX's base and its injected tree (rank 4 on wq/wk/wv/wo), as
    numpy."""
    base = jllama.init_params(_jcfg(), jax.random.PRNGKey(0))
    _, p = jlora.inject(_jcfg(), base, LC_J, jax.random.PRNGKey(1))
    return jax.device_get(base), jax.device_get(p)


def _tokens(b=8, s=33, seed=2):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=(b, s)).astype(np.int32)


def _t_params(tree):
    return tllama.params_from_numpy(_tcfg(), tree, device="cpu",
                                    dtype=torch.float32)


def _adam(lr):
    return lambda ps: torch.optim.Adam(ps, lr=lr, betas=(0.9, 0.999),
                                       eps=1e-8)


def _adamw(lr):
    return lambda ps: torch.optim.AdamW(ps, lr=lr, betas=(0.9, 0.999),
                                        eps=1e-8, weight_decay=1e-4)


OPTS = {"adam": (optax.adam, _adam), "adamw": (optax.adamw, _adamw)}


def _port_acc(tree, opt="adam", lr=1e-3):
    return accelerate(
        init_params=lambda g: _t_params(tree),
        loss_fn=lambda p, b: tllama.loss_fn(_tcfg(), p, b),
        optimizer=tlora.lora_optimizer(OPTS[opt][1](lr)),
        strategy=Strategy(device="cpu"),
    )


def _jax_acc(tree, opt="adam", lr=1e-3):
    cfg = dataclasses.replace(_jcfg(), lora_alpha=LC_J.alpha)
    return jaccelerate(
        init_params=lambda k: jax.tree_util.tree_map(jnp.asarray, tree),
        loss_fn=lambda p, b, m: jllama.loss_fn(cfg, p, b, mesh=m),
        rules=jllama.partition_rules(cfg),
        optimizer=jlora.lora_optimizer(OPTS[opt][0](lr)),
        strategy=JStrategy(mesh=MeshSpec.fit(1)),
        devices=jax.devices()[:1],
    )


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a)).reshape(-1).view(np.uint8)


def _assert_bit_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.shape == w.shape and g.dtype == w.dtype, k
        assert np.array_equal(_bits(g), _bits(w)), k


# ---------------------------------------------------------------------------
# the frozen-base optimizer
# ---------------------------------------------------------------------------


def test_lora_labels_match_jax(injected):
    _, tree = injected
    want = jlora.lora_labels(jax.tree_util.tree_map(jnp.asarray, tree))
    assert tlora.lora_labels(_t_params(tree)) == want


def test_lora_optimizer_holds_the_adapters_only(injected):
    _, tree = injected
    params = _t_params(tree)
    opt = tlora.lora_optimizer(_adam(1e-2))(
        [t for t in jax.tree_util.tree_leaves(params)], params)
    held = {id(p) for g in opt.param_groups for p in g["params"]}
    layers = params["layers"]
    assert held == {id(v) for k, v in layers.items()
                    if tlora.is_adapter_path(k)}
    assert opt.multi_transform_label == "lora"
    base = tllama.params_from_numpy(_tcfg(), injected[0], device="cpu",
                                    dtype=torch.float32)
    with pytest.raises(ValueError, match="no adapter leaf"):
        tlora.lora_optimizer(_adam(1e-2))(
            jax.tree_util.tree_leaves(base), base)
    assert [(pat, tuple(spec)) for pat, spec in tlora.lora_partition_rules()
            ] == [(pat, tuple(spec)) for pat, spec in
                  jlora.lora_partition_rules()]


class _Losses(TrainerCallback):
    def __init__(self):
        self.losses = []

    def on_log(self, trainer, state, logs):
        self.losses.append(logs["loss"])


def test_only_adapters_update(injected, tmp_path):
    """JAX's TestFrozenBaseTraining::test_only_adapters_update through the
    port's Trainer -> ElasticTrainer -> accelerate -> loss_fn: 8 steps of
    lora_optimizer(Adam 1e-2), a global batch of 8 in microbatches of 4.
    Every base leaf bit-equal, the adapters moved, the loss fell."""
    base, tree = injected
    et = ElasticTrainer(
        lambda g: _t_params(tree),
        lambda p, b: tllama.loss_fn(_tcfg(), p, b),
        tlora.lora_optimizer(_adam(1e-2)), global_batch_size=8,
        max_per_replica_batch=4, device="cpu")
    rec = _Losses()
    trainer = Trainer(et, TrainingArguments(
        output_dir=str(tmp_path), max_steps=8, logging_steps=1,
        save_steps=0, resume=False, publish_step_metrics=False),
        train_data=[{"tokens": _tokens()}] * 8, callbacks=[rec])
    state = trainer.train(et.init_state(torch.Generator().manual_seed(0)))
    assert et.grad_accum == 2 and len(rec.losses) == 8
    params = state["params"]
    for k in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
              "attn_norm", "mlp_norm"):
        assert np.array_equal(params["layers"][k].detach().numpy(),
                              base["layers"][k]), k
    for path in ("embed/weight", "lm_head/weight", "final_norm/scale"):
        a, b = path.split("/")
        assert np.array_equal(params[a][b].detach().numpy(), base[a][b]), path
    assert float(params["layers"]["wq_lora_b"].detach().abs().max()) > 0
    assert rec.losses[-1] < rec.losses[0]


def test_no_moment_state_for_frozen(injected):
    """JAX's TestFrozenBaseTraining::test_no_moment_state_for_frozen: after
    a step, torch holds moments (and a step count each) for the 8
    adapter leaves alone, within 2 x adapter bytes + 4096 and below the
    params' bytes; the frozen leaves have no entry at all."""
    _, tree = injected
    acc = _port_acc(tree, lr=1e-2)
    state = acc.init(torch.Generator().manual_seed(0))
    state, _ = acc.train_step(state, {"tokens": torch.from_numpy(
        _tokens(4, 17)).long()})
    opt = state["opt_state"]
    moment_bytes = sum(t.numel() * t.element_size()
                       for st in opt.state.values() for t in st.values())
    adapters = tlora.adapter_state_dict(state["params"])
    adapter_bytes = sum(t.numel() * 4 for t in adapters["layers"].values())
    total = sum(t.numel() * 4 for t in jax.tree_util.tree_leaves(
        state["params"]))
    assert len(opt.state) == 8
    assert moment_bytes < total and moment_bytes <= 2 * adapter_bytes + 4096


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("opt", ["adam", "adamw"])
def test_train_state_matches_jax_after_3_steps(injected, opt):
    """The same injected tree, batches and lora_optimizer in both
    packages for 3 steps: loss and grad_norm (the global norm over every
    gradient, frozen ones included) at each step, then the saved train
    state's keys (JAX `flatten_state`'s, none for a frozen leaf's
    moments) and every value."""
    _, tree = injected
    j_acc, t_acc = _jax_acc(tree, opt), _port_acc(tree, opt)
    j_state = j_acc.init(jax.random.PRNGKey(0))
    t_state = t_acc.init(torch.Generator().manual_seed(0))
    for step in range(3):
        batch = {"tokens": _tokens(4, 17, seed=10 + step)}
        j_state, j_m = j_acc.train_step(j_state, j_acc.shard_batch(batch))
        t_state, t_m = t_acc.train_step(
            t_state, {"tokens": torch.from_numpy(batch["tokens"]).long()})
        for key in ("loss", "grad_norm"):
            want = float(j_m[key])
            assert abs(float(t_m[key]) - want) <= SCALAR_REL * abs(want), (
                step, key)
    j_flat, _ = jengine.flatten_state(j_state)
    t_flat, _ = flatten_state(t_state)
    assert sorted(t_flat) == sorted(j_flat)
    pre = "opt_state/inner_states/lora/inner_state/0/"
    assert {k for k in t_flat if k.startswith("opt_state")} == {
        pre + "count"} | {f"{pre}{m}/layers/{t}_lora_{ab}"
                          for m in ("mu", "nu") for t in LC_T.targets
                          for ab in "ab"}
    for k, want in j_flat.items():
        got = t_flat[k]
        assert got.shape == want.shape and got.dtype == want.dtype, k
        np.testing.assert_allclose(got, want, rtol=0, atol=STEP_ATOL,
                                   err_msg=k)


def _jax_state_after(tree, steps):
    j_acc = _jax_acc(tree)
    state = j_acc.init(jax.random.PRNGKey(0))
    for step in range(steps):
        state, _ = j_acc.train_step(state, j_acc.shard_batch(
            {"tokens": _tokens(4, 17, seed=10 + step)}))
    return state


def test_port_checkpoint_is_jax_flatten_state(injected, tmp_path):
    """A JAX LoRA train state after 2 steps carried into the port and
    saved by the port's engine: the host_0.npz holds exactly JAX's keys
    and arrays, bit for bit; a JAX-saved checkpoint of the same state
    restores into a fresh port state (another seed's adapters) bit-equal,
    and trains on."""
    _, tree = injected
    j_state = _jax_state_after(tree, 2)
    j_flat, _ = jengine.flatten_state(j_state)
    acc = _port_acc(tree)
    state = train_state_from_numpy(
        acc.init(torch.Generator().manual_seed(0)), j_flat)
    eng = CheckpointEngine(str(tmp_path / "ck"), job_name=_job("save"))
    try:
        eng.save_to_storage(2, state)
        assert eng.wait_for_persist(2, timeout=30)
    finally:
        eng.close()
    with open(tmp_path / "ck" / "2" / "host_0.npz", "rb") as f:
        _assert_bit_equal(jengine._extract_npz(f.read()), j_flat)

    ckpt = str(tmp_path / "jck")
    jeng = jengine.CheckpointEngine(ckpt, job_name=_job("jax"))
    try:
        jeng.save_to_storage(2, j_state)
        assert jeng.wait_for_persist(2, timeout=30)
    finally:
        jeng.shm_handler.close(unlink=True)
        jeng.close()
    eng = CheckpointEngine(ckpt, job_name=_job("load"))
    try:
        fresh = _port_acc(tree)
        target = fresh.init(torch.Generator().manual_seed(0))
        with torch.no_grad():
            target["params"]["layers"]["wq_lora_b"].add_(1.0)
        step, restored = eng.load(target=target, device="cpu")
    finally:
        eng.close()
    assert step == 2 and restored is target and target["step"] == 2
    _assert_bit_equal(flatten_state(target)[0], j_flat)
    target, m = fresh.train_step(target, {"tokens": torch.from_numpy(
        _tokens(4, 17, seed=12)).long()})
    assert np.isfinite(float(m["loss"])) and target["step"] == 3


def test_adapter_only_flash_roundtrip(injected, tmp_path):
    """JAX's TestAdapterCheckpoint on the port: the adapter sub-tree
    (random B) through `save_to_storage`, a fresh engine's `load`, and
    `load_adapters` onto a freshly injected base (other A draws):
    logits bit-equal to the trained tree's. The saved file holds JAX
    `flatten_state`'s keys and bits of the same sub-tree."""
    base, tree = injected
    tcfg = _tcfg()
    p = _t_params(tree)
    p["layers"]["wv_lora_b"] = torch.randn(
        p["layers"]["wv_lora_b"].shape,
        generator=torch.Generator().manual_seed(9)) * 0.1
    adapters = tlora.adapter_state_dict(p)
    eng = CheckpointEngine(str(tmp_path / "ckpt"), job_name=_job("ad"))
    try:
        eng.save_to_storage(7, adapters)
        assert eng.wait_for_persist(7, timeout=30)
    finally:
        eng.close()
    with open(tmp_path / "ckpt" / "7" / "host_0.npz", "rb") as f:
        saved = jengine._extract_npz(f.read())
    j_tree = dict(tree, layers=dict(
        tree["layers"], wv_lora_b=p["layers"]["wv_lora_b"].numpy()))
    j_ad = jlora.adapter_state_dict(jax.tree_util.tree_map(jnp.asarray,
                                                           j_tree))
    _assert_bit_equal(saved, jengine.flatten_state(j_ad)[0])
    eng2 = CheckpointEngine(str(tmp_path / "ckpt"), job_name=_job("ad2"))
    try:
        step, restored = eng2.load(device="cpu")
    finally:
        eng2.close()
    assert step == 7
    fresh_base = tllama.params_from_numpy(tcfg, base, device="cpu",
                                          dtype=torch.float32)
    _, fresh = tlora.inject(tcfg, fresh_base, LC_T,
                            torch.Generator().manual_seed(42))
    p2 = tlora.load_adapters(fresh, restored)
    tok = torch.from_numpy(_tokens(4, 17)).long()
    with torch.no_grad():
        assert torch.equal(tllama.apply(tcfg, p, tok),
                           tllama.apply(tcfg, p2, tok))


def test_world_of_one_restores_bit_equal(injected, tmp_path, monkeypatch):
    """`on_world_change` in a gloo world of one with the frozen-base
    optimizer (state for part of the leaves only): the state comes back
    bit-equal, and the next step equals the no-world step's."""
    import socket

    import torch.distributed as dist

    _, tree = injected
    batch = {"tokens": torch.from_numpy(_tokens(8, 17)).long()}

    def elastic():
        return ElasticTrainer(
            lambda g: _t_params(tree),
            lambda p, b: tllama.loss_fn(_tcfg(), p, b),
            tlora.lora_optimizer(_adam(1e-2)), global_batch_size=8,
            max_per_replica_batch=8, device="cpu")

    et = elastic()
    state = et.init_state(torch.Generator().manual_seed(0))
    state, _ = et.step(state, batch)
    bits = {k: _bits(v) for k, v in flatten_state(state)[0].items()}
    ref = elastic()
    ref_state = ref.init_state(torch.Generator().manual_seed(0))
    for _ in range(2):
        ref_state, _ = ref.step(ref_state, batch)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        state = et.on_world_change(state)
        assert {k: _bits(v) for k, v in
                flatten_state(state)[0].items()}.keys() == bits.keys()
        for k, v in flatten_state(state)[0].items():
            assert np.array_equal(_bits(v), bits[k]), k
        broadcast_state(state, dist.group.WORLD)
        state, _ = et.step(state, batch)
    finally:
        dist.destroy_process_group()
    for k, v in flatten_state(ref_state)[0].items():
        assert np.array_equal(_bits(flatten_state(state)[0][k]), _bits(v)), k


class _UnreachableReplica:
    """A checkpoint replica whose master is out of reach."""

    def peek_step(self):
        raise ConnectionError("master unreachable")

    def restore_state(self, target=None, device=None):
        raise ConnectionError("master unreachable")

    def backup(self, step, flat, aux):
        raise ConnectionError("master unreachable")


def test_unreachable_master_at_peek_falls_through_to_storage(injected,
                                                            tmp_path):
    """Where the port differs from JAX: with an empty shm and the master
    out of reach, JAX's `load` raises the ConnectionError of its
    `peek_step` call, the port's takes it as "no replica" and restores
    from storage."""
    _, tree = injected
    ckpt = str(tmp_path / "ck")
    acc = _port_acc(tree)
    state = acc.init(torch.Generator().manual_seed(0))
    state, _ = acc.train_step(state, {"tokens": torch.from_numpy(
        _tokens(4, 17)).long()})
    eng = CheckpointEngine(ckpt, job_name=_job("peek"))
    try:
        eng.save_to_storage(1, state)
        assert eng.wait_for_persist(1, timeout=30)
        eng.shm_handler.close(unlink=True)
    finally:
        eng.close()
    saved = {k: _bits(v) for k, v in flatten_state(state)[0].items()}

    jeng = jengine.CheckpointEngine(ckpt, job_name=_job("jpeek"),
                                    replica_manager=_UnreachableReplica())
    try:
        with pytest.raises(ConnectionError):
            jeng.load()
    finally:
        jeng.close()
    eng = CheckpointEngine(ckpt, job_name=_job("tpeek"),
                           replica_manager=_UnreachableReplica())
    try:
        target = _port_acc(tree).init(torch.Generator().manual_seed(0))
        step, restored = eng.load(target=target, device="cpu")
        assert eng.last_load_source == "storage"
    finally:
        eng.close()
    assert step == 1 and restored is target
    for k, v in flatten_state(target)[0].items():
        assert np.array_equal(_bits(v), saved[k]), k
