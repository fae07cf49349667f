"""The port's sharded training state (parallel/mesh.py `MeshSpec.build`,
parallel/sharding.py, parallel/accelerate.py, ElasticTrainer
`on_world_change`, the sharded flash checkpoint) held to the JAX
package on the conftest's 8-device CPU mesh.

Rules (no processes): every family's partition rules at two mesh
shapes, each leaf's filtered spec and each rank's piece against JAX's
`tree_shardings` and its device indices.

The world of four: one spawn of four gloo processes
(tests/_torch_sharded_worker.py, mode "train") runs tiny Llama under
MeshSpec(fsdp=4), (data=2, fsdp=2), (data=2, seq=2) with Ulysses and
with ring, and (fsdp=2, seq=2) with Ulysses: 3 AdamW steps each, grad
accumulation 2, masked batches; then the world changes. Meanwhile this
process runs JAX's ElasticTrainer with the same MeshSpec on the same
params (carried across as numpy) and batches.

Tolerances: f32 on both sides, sums in other orders (each rank's
weighted sums and the reduce-scatters against one global batch):
params, moments, losses and grad_norm rtol 1e-5 / atol 1e-6. A state
that moves without arithmetic (a re-shard, a checkpoint restore) is
held byte-equal. AdamW runs at lr 1e-3 with eps 1e-3 (optax's default
is 1e-8): Adam divides each moment by the root of its square, so where
a gradient lies within a few eps of zero the f32 noise of a sum taken
in another order becomes noise of the update, in proportion to lr. At
eps 1e-8 and lr 1e-2, JAX's own ElasticTrainer under MeshSpec(data=4)
and under (data=2, fsdp=2) ends 3 steps 6.4x this tolerance apart; at
eps 1e-3, 0.54x.
"""

import os
import socket
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from dlrover_tpu.models import bert as jbert
from dlrover_tpu.models import cnn as jcnn
from dlrover_tpu.models import gpt as jgpt
from dlrover_tpu.models import llama as jllama
from dlrover_tpu.models import lora as jlora
from dlrover_tpu.models import moe as jmoe
from dlrover_tpu.parallel import mesh as jmesh
from dlrover_tpu.parallel import sharding as jsharding
from dlrover_tpu.trainer.elastic.trainer import ElasticTrainer as JElastic
from dlrover_tpu_torch.models import bert as tbert
from dlrover_tpu_torch.models import cnn as tcnn
from dlrover_tpu_torch.models import gpt as tgpt
from dlrover_tpu_torch.models import llama as tllama
from dlrover_tpu_torch.models import lora as tlora
from dlrover_tpu_torch.models import moe as tmoe
from dlrover_tpu_torch.parallel import mesh as tmesh
from dlrover_tpu_torch.parallel import sharding as tsharding

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _torch_sharded_worker import Ranks as _Ranks  # noqa: E402

WORLD = 4
RTOL, ATOL = 1e-5, 1e-6
LR, WD, EPS = 1e-3, 1e-4, 1e-3
SEQ = 16

CASES = {
    "fsdp4": (dict(fsdp=4), "none"),
    "data2_fsdp2": (dict(data=2, fsdp=2), "none"),
    "data2_seq2_ulysses": (dict(data=2, seq=2), "ulysses"),
    "data2_seq2_ring": (dict(data=2, seq=2), "ring"),
    "fsdp2_seq2_ulysses": (dict(fsdp=2, seq=2), "ulysses"),
}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jcfg(sp="none"):
    return jllama.LlamaConfig.tiny(dtype=jnp.float32, seq_parallel=sp)


def _batch(rows, seed):
    """Masked next-token batches: every row keeps about 60% of its
    targets, and at least one."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 256, size=(rows, SEQ + 1)).astype(np.int32)
    mask = (rng.random((rows, SEQ + 1)) < 0.6).astype(np.float32)
    mask[:, 1] = 1.0
    return {"tokens": tokens, "loss_mask": mask}


def _inputs():
    params = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda k: jllama.init_params(_jcfg(), k))(jax.random.PRNGKey(0)))
    batches = {}
    for i, (name, (kw, _)) in enumerate(CASES.items()):
        rows = 4 * tmesh.MeshSpec(**kw).batch_shards
        batches[name] = [_batch(rows, 100 * i + s) for s in range(3)]
    batches["reshard"] = [_batch(8, 900 + s) for s in range(4)]
    return {"port": _free_port(), "port2": _free_port(),
            "port3": _free_port(), "port4": _free_port(),
            "params": params, "cases": CASES, "batches": batches}


@pytest.fixture(scope="module", autouse=True)
def ranks(tmp_path_factory):
    # autouse: the processes start with the module's first test and run
    # beside the JAX side of every test before the first `result()`
    run = _Ranks(str(tmp_path_factory.mktemp("sharded")), _inputs(), "train")
    yield run
    run.kill()


def _close(got, want, what, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


def _leaves(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out.update(_leaves(tree[k], prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(tree[k])
    return out


def _j_et(spec_kw, sp="none", global_batch=None):
    cfg = _jcfg(sp)
    spec = jmesh.MeshSpec(**spec_kw)
    return JElastic(lambda k: jllama.init_params(cfg, k),
                    lambda p, b, m: jllama.loss_fn(cfg, p, b, mesh=m),
                    jllama.partition_rules(cfg),
                    optax.adamw(LR, b1=0.9, b2=0.999, eps=EPS,
                                weight_decay=WD),
                    global_batch_size=global_batch or 4 * spec.batch_shards,
                    max_per_replica_batch=2, mesh_spec=spec)


def _with_params(state, params):
    return dict(state, params=jax.tree_util.tree_map(
        lambda x, like: jax.device_put(x, like.sharding), params,
        state["params"]))


def _jax_record(state):
    adam = state["opt_state"][0]
    return {"params": _leaves(jax.device_get(state["params"])),
            "mu": _leaves(jax.device_get(adam.mu)),
            "nu": _leaves(jax.device_get(adam.nu))}


def _check_record(got, want, what):
    for kind in ("params", "mu", "nu"):
        assert set(got[kind]) == set(want[kind]), (what, kind)
        for name, arr in got[kind].items():
            _close(arr, want[kind][name], f"{what} {kind} {name}")


# ---- the rules (no processes) -----------------------------------------------


def _family_trees():
    """(name, JAX abstract params, JAX rules, port rules) of each family."""
    out = []
    dense = _jcfg()
    out.append(("llama", jax.eval_shape(
        lambda k: jllama.init_params(dense, k), jax.random.PRNGKey(0)),
        jllama.partition_rules(dense),
        tllama.partition_rules(tllama.LlamaConfig.tiny())))
    moe = jllama.LlamaConfig.tiny(n_experts=4)
    out.append(("moe", jax.eval_shape(
        lambda k: jllama.init_params(moe, k), jax.random.PRNGKey(0)),
        jllama.partition_rules(moe),
        tllama.partition_rules(tllama.LlamaConfig.tiny(n_experts=4))))
    lparams = jax.eval_shape(
        lambda k: jlora.inject(dense, jllama.init_params(dense, k),
                               jlora.LoraConfig(rank=4, targets=(
                                   "wq", "wk", "wv", "wo", "w_gate", "w_up",
                                   "w_down")), k)[1], jax.random.PRNGKey(0))
    out.append(("lora", lparams, jllama.partition_rules(dense),
                tllama.partition_rules(tllama.LlamaConfig.tiny())))
    g = jgpt.GptConfig.tiny()
    out.append(("gpt", jax.eval_shape(lambda k: jgpt.init_params(g, k),
                                      jax.random.PRNGKey(0)),
                jgpt.partition_rules(g), tgpt.partition_rules(None)))
    b = jbert.BertConfig.tiny()
    out.append(("bert", jax.eval_shape(lambda k: jbert.init_params(b, k),
                                       jax.random.PRNGKey(0)),
                jbert.partition_rules(b), tbert.partition_rules(None)))
    c = jcnn.CnnConfig.tiny()
    out.append(("cnn", jax.eval_shape(lambda k: jcnn.init_params(c, k),
                                      jax.random.PRNGKey(0)),
                jcnn.partition_rules(c), tcnn.partition_rules(None)))
    return out


FAMILIES = _family_trees()
MESHES = [dict(fsdp=4), dict(data=2, fsdp=2, seq=2)]


def _rule_table(rules):
    return [(pat, tuple(spec)) for pat, spec in rules]


@pytest.mark.parametrize("fam", FAMILIES, ids=[f[0] for f in FAMILIES])
def test_partition_rules_equal_jax(fam):
    """The port's rule table is JAX's, regex for regex and spec for spec
    (the MoE and LoRA rules first, as there)."""
    _, _, jrules, trules = fam
    assert _rule_table(trules) == _rule_table(jrules)


def test_moe_and_lora_rules_equal_jax():
    assert _rule_table(tmoe.moe_partition_rules()) == _rule_table(
        jmoe.moe_partition_rules())
    assert _rule_table(tlora.lora_partition_rules()) == _rule_table(
        jlora.lora_partition_rules())


@pytest.mark.parametrize("kw", MESHES, ids=[str(m) for m in MESHES])
@pytest.mark.parametrize("fam", FAMILIES, ids=[f[0] for f in FAMILIES])
def test_every_leaf_spec_and_piece_equal_jax(fam, kw):
    """Each leaf's filtered spec is JAX's `tree_shardings` spec, and the
    slice each rank's piece holds (`ShardPlan.index_of`) is the index
    JAX's device of that rank holds."""
    _, tree, jrules, trules = fam
    spec = jmesh.MeshSpec(**kw)
    jm = spec.build(jax.devices()[:spec.num_devices])
    jsh = jax.tree_util.tree_leaves_with_path(
        jsharding.tree_shardings(tree, jm, jrules))
    shapes = {jsharding.path_str(p): tuple(x.shape) for p, x in
              jax.tree_util.tree_leaves_with_path(tree)}
    tspec = tmesh.MeshSpec(**kw)
    devices = list(jm.devices.flat)
    split = 0
    for r in range(tspec.num_devices):
        plan = tsharding.ShardPlan.from_shapes(
            tmesh.TrainMesh(tspec, r, {}), trules, shapes)
        for p, ns in jsh:
            path = jsharding.path_str(p)
            got = tsharding._filter_spec(
                tsharding.spec_for_path(path, trules), tspec, shapes[path])
            assert tuple(got) == tuple(ns.spec), (path, got, ns.spec)
            want = ns.devices_indices_map(shapes[path])[devices[r]]
            got_ix = plan.index_of(path)
            assert [(s.start or 0, s.stop if s.stop is not None else n)
                    for s, n in zip(want, shapes[path])] == [
                (s.start, s.stop) for s in got_ix], (path, r)
            split += plan.dim(path) is not None
    if fam[0] in ("llama", "moe", "lora"):
        assert split > 0


def test_mesh_rank_coords_equal_jax_devices():
    """Rank r's coordinates are those of JAX's device r in `build`."""
    for kw in (dict(data=2, fsdp=2, seq=2), dict(fsdp=2, seq=4),
               dict(data=4, fsdp=2)):
        spec = jmesh.MeshSpec(**kw)
        jm = spec.build(jax.devices()[:spec.num_devices])
        ids = np.vectorize(lambda d: d.id)(jm.devices)
        for r in range(spec.num_devices):
            c = tmesh.rank_coords(tmesh.MeshSpec(**kw), r)
            assert ids[tuple(c[a] for a in tmesh.AXIS_ORDER)] == (
                jax.devices()[r].id)


# ---- the world of four ------------------------------------------------------


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_case_equals_jax_elastic_trainer(ranks, name):
    """3 AdamW steps at grad accumulation 2 on masked batches: params,
    moments, losses and grad_norm of every rank within rtol 1e-5 / atol
    1e-6 of JAX's ElasticTrainer with the same MeshSpec; each rank
    stores only its pieces (fsdp leaves cut along their rule's dim,
    their moments too)."""
    kw, sp = CASES[name]
    j_et = _j_et(kw, sp)
    state = _with_params(j_et.init_state(jax.random.PRNGKey(0)),
                         ranks.inp["params"])
    losses, norms = [], []
    for batch in ranks.inp["batches"][name]:
        state, m = j_et.step(state, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    want = _jax_record(state)
    out = ranks.result()
    fsdp = kw.get("fsdp", 1)
    whole = {k: v.shape for k, v in want["params"].items()}
    tree = jax.eval_shape(lambda k: jllama.init_params(_jcfg(sp), k),
                          jax.random.PRNGKey(0))
    jm = jmesh.MeshSpec(**kw).build(jax.devices()[:WORLD])
    specs = {jsharding.path_str(p): tuple(s.spec) for p, s in
             jax.tree_util.tree_leaves_with_path(jsharding.tree_shardings(
                 tree, jm, jllama.partition_rules(_jcfg(sp))))}
    for r in range(WORLD):
        o = out[r][name]
        assert o["grad_accum"] == j_et.grad_accum == 2
        _close(o["losses"], losses, f"{name} rank {r} losses")
        _close(o["grad_norms"], norms, f"{name} rank {r} grad_norm")
        _check_record(o, want, f"{name} rank {r}")
        for path, shape in o["pieces"].items():
            spec = specs[path]
            cut = [n // fsdp if d < len(spec) and spec[d] == "fsdp" else n
                   for d, n in enumerate(whole[path])]
            assert shape == tuple(cut), (path, shape, cut)
            assert o["moment_pieces"][path] == shape
            assert o["state_shardings"][path] == spec
    # params + two moments, f32: the pieces' bytes, not the whole tree's
    stored = sum(12 * int(np.prod(s)) for s in out[0][name]["pieces"].values())
    assert out[0][name]["stored_bytes"] == stored
    if fsdp > 1:
        assert stored < sum(12 * a.size for a in want["params"].values())


@pytest.fixture(scope="module")
def jax_world_changes(ranks):
    """JAX's run of the worker's world changes: fsdp=2 for 2 steps, the
    state re-sharded onto fsdp=4 and one step, then onto fsdp=2 and one
    more (the losses and records of each stage)."""
    j_et = _j_et(dict(fsdp=2), global_batch=8)
    state = _with_params(j_et.init_state(jax.random.PRNGKey(0)),
                         ranks.inp["params"])
    batches = ranks.inp["batches"]["reshard"]
    out = {"losses": [], "grad_accum_2": j_et.grad_accum}
    for batch in batches[:2]:
        state, m = j_et.step(state, batch)
        out["losses"].append(float(m["loss"]))
    out["before"] = _jax_record(state)
    state = j_et.on_world_change(state, mesh_spec=jmesh.MeshSpec(fsdp=4))
    out["grad_accum_4"] = j_et.grad_accum
    state, out["m4"] = j_et.step(state, batches[2])
    out["after"] = _jax_record(state)
    state = j_et.on_world_change(state, mesh_spec=jmesh.MeshSpec(fsdp=2))
    state, out["m2"] = j_et.step(state, batches[3])
    out["restored"] = _jax_record(state)
    return out


def test_live_reshard_2_to_4_keeps_state_and_losses(ranks,
                                                    jax_world_changes):
    """fsdp=2 over ranks 0 and 1 for 2 steps, then a world of four:
    ranks 0 and 1 re-cut their state with on_world_change(fsdp=4),
    ranks 2 and 3 come fresh (another seed) and take it. The gathered
    state right after the change is the one before, byte for byte, on
    every rank, each holding a quarter; the next step within rtol 1e-5
    of JAX's fsdp=2 run re-sharded onto fsdp=4."""
    j = jax_world_changes
    m = j["m4"]
    out = ranks.result()
    ref = out[0]["world_changes"]["before"]
    _close(ref["losses"], j["losses"], "fsdp=2 losses")
    _check_record(ref, j["before"], "fsdp=2 state")
    for r in range(WORLD):
        wc = out[r]["world_changes"]["after"]
        assert wc["step"] == 2 and wc["grad_accum"] == j["grad_accum_4"] == 1
        for kind in ("params", "mu", "nu"):
            for k, v in wc["changed"][kind].items():
                assert v.tobytes() == ref[kind][k].tobytes(), (r, kind, k)
        assert wc["pieces"]["layers/wq"][1] == 16
        assert wc["pieces"]["embed/weight"][1] == 16
        _close(wc["loss"], m["loss"], f"rank {r} loss after the re-shard")
        _close(wc["grad_norm"], m["grad_norm"], f"rank {r} grad_norm")
        _check_record(wc, j["after"], f"rank {r} after the re-shard")


def test_sharded_checkpoint_stages_pieces_with_jax_shard_table(ranks):
    """Each rank stages its own pieces under `<path>#shard{rank}_0`
    with JAX's shard table (global shape, keys, the slices device r
    holds): a quarter of each split leaf's bytes."""
    out = ranks.result()
    tree = jax.eval_shape(lambda k: jllama.init_params(_jcfg(), k),
                          jax.random.PRNGKey(0))
    jm = jmesh.MeshSpec(fsdp=4).build(jax.devices()[:WORLD])
    sh = {jsharding.path_str(p): s for p, s in
          jax.tree_util.tree_leaves_with_path(jsharding.tree_shardings(
              tree, jm, jllama.partition_rules(_jcfg())))}
    devices = list(jm.devices.flat)
    for r in range(WORLD):
        wc = out[r]["world_changes"]
        assert "params/layers/wq#shard%d_0" % r in wc["staged_keys"]
        assert "opt_state/0/mu/layers/wq#shard%d_0" % r in wc["staged_keys"]
        assert "params/layers/attn_norm" in wc["staged_keys"]
        for path, (shape, keys, indices) in wc["shard_table"].items():
            param = path.split("/", 1)[1] if path.startswith(
                "params/") else path.split("/", 3)[3]
            want = sh[param].devices_indices_map(tuple(shape))[devices[r]]
            assert keys == [f"{path}#shard{r}_0"]
            assert [tuple(ix) for ix in indices[0]] == [
                (s.start or 0, s.stop if s.stop is not None else n)
                for s, n in zip(want, shape)], (path, r)
    staged = out[0]["world_changes"]["staged_bytes"]
    whole = sum(3 * np.prod(x.shape) * 4
                for x in jax.tree_util.tree_leaves(tree))
    assert staged < whole / 4 * 1.2


def test_shrink_that_lost_pieces_raises_then_restores(ranks,
                                                       jax_world_changes):
    """Ranks 2 and 3 leave with pieces 2 and 3: on_world_change onto
    fsdp=2 raises, naming the leaves it cannot re-cut. Fresh fsdp=2
    trainers restore the sharded checkpoint from storage (every rank's
    file stitched, the new pieces cut): every leaf byte-equal to the
    gathered saved state; the next step within rtol 1e-5 of JAX's
    fsdp=4 state re-sharded onto fsdp=2."""
    j = jax_world_changes
    out = ranks.result()
    for r in (0, 1):
        wc = out[r]["world_changes"]
        err = wc["lost_pieces_error"]
        assert err is not None and "[2, 3]" in err and "layers/wq" in err
        assert "flash checkpoint" in err
        rs = wc["restore"]
        assert rs["step"] == 3 and rs["source"] == "storage"
        assert rs["byte_equal"]
        _close(rs["loss"], j["m2"]["loss"], f"rank {r} loss after restore")
        _check_record(rs, j["restored"], f"rank {r} after the restore")
    assert all("restore" not in out[r]["world_changes"] for r in (2, 3))
    assert out[0]["backend"] == "gloo"
