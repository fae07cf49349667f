"""The port's data-parallel training (parallel/mesh.py, parallel/
accelerate.py, trainer/elastic/trainer.py `on_world_change`) and its
compressed collectives (ops/quantization.py) on four gloo processes
on the CPU, held to the JAX package's ElasticTrainer and collectives
on the 8-device CPU mesh (tests/conftest.py) with MeshSpec(data=4) and
Mesh(devices[:4], ("dp",)).

The port's side is one spawn of four processes (tests/_torch_dp_worker.py)
that runs every case and writes its results; they run while this
process runs the JAX side. Weights come from JAX's init, carried across
as numpy (`llama.params_from_numpy`); batches and contributions from
numpy seeds.

Tolerances: f32 throughout on both sides, sums taken in other orders
(the port reduces each rank's weighted sums, JAX one global batch):
params, losses, grad_norm and gradients rtol 1e-5 / atol 1e-6; the
collectives' outputs 1e-6 (their int8 payloads byte-equal). Bit
equality is checked where the arithmetic is the same: every rank's
state against rank 0's after every step.
"""

import os
import pickle
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from dlrover_tpu.models import llama as jllama
from dlrover_tpu.ops import quantization as jq
from dlrover_tpu.parallel import mesh as jmesh
from dlrover_tpu.trainer.elastic.trainer import ElasticTrainer as JElastic
from dlrover_tpu_torch.parallel import mesh as tmesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_dp_worker.py")
WORLD = 4
RTOL, ATOL = 1e-5, 1e-6
COLL_TOL = 1e-6
BLOCK = 32


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ---- inputs -----------------------------------------------------------------


def _tiny_init(key):
    """tests/test_trainer.py's model."""
    k1, k2 = jax.random.split(key)
    return {
        "w": jax.random.normal(k1, (4, 8)) * 0.1,
        "b": jnp.zeros((8,)),
        "head": jax.random.normal(k2, (8, 2)) * 0.1,
    }


def _tiny_loss(params, batch, mesh):
    h = jnp.tanh(batch["x"] @ params["w"] + params["b"])
    logits = h @ params["head"]
    loss = optax.softmax_cross_entropy_with_integer_labels(
        logits, batch["y"]).mean()
    return loss, {"loss": loss}


def _tiny_batch(n, seed):
    rng = np.random.RandomState(seed)
    return {"x": rng.randn(n, 4).astype(np.float32),
            "y": rng.randint(0, 2, size=(n,)).astype(np.int32)}


JCFG = jllama.LlamaConfig.tiny(dtype=jnp.float32)
SEQ = 16


def _llama_batch(seed):
    """16 rows whose valid-target counts differ by rank: rank r holds
    rows 2r, 2r+1, 8+2r, 8+2r+1 of the folded [2, 8] batch, and the
    mask keeps about 20 / 45 / 70 / 95% of each rank's targets."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, JCFG.vocab_size, size=(16, SEQ + 1)).astype(
        np.int32)
    keep = np.empty(16)
    for row in range(16):
        keep[row] = 0.2 + 0.25 * ((row % 8) // 2)
    mask = (rng.random((16, SEQ + 1)) < keep[:, None]).astype(np.float32)
    mask[:, 1] = 1.0          # every row keeps one target
    return {"tokens": tokens, "loss_mask": mask}


def _init(fn):
    """fn(PRNGKey(0)) as numpy: the params both sides start from (the
    JAX trainers' states take them in place of their own draw)."""
    return jax.tree_util.tree_map(np.asarray,
                                  jax.jit(fn)(jax.random.PRNGKey(0)))


def _with_params(state, params):
    """A JAX train state holding `params` (numpy), each leaf placed as
    the state's own."""
    return dict(state, params=jax.tree_util.tree_map(
        lambda x, like: jax.device_put(x, like.sharding), params,
        state["params"]))


def _inputs():
    rng = np.random.default_rng(5)
    return {
        "port": _free_port(), "port2": _free_port(),
        "tiny_params": _init(_tiny_init),
        "tiny_batches": [_tiny_batch(16, s) for s in (0, 1, 2)],
        "tiny_next": _tiny_batch(16, 3),
        "llama_params": _init(lambda k: jllama.init_params(JCFG, k)),
        "llama_batches": [_llama_batch(s) for s in (10, 11, 12)],
        "block": BLOCK,
        # a leaf that pads (185 values, blocks of 32) and one that does not
        "tree_contrib": {
            "a": rng.standard_normal((WORLD, 37, 5)).astype(np.float32),
            "b": rng.standard_normal((WORLD, 128)).astype(np.float32)},
        "ring_x": rng.standard_normal((WORLD, 2 * WORLD, 64)).astype(
            np.float32),
    }


class _Ranks:
    """The four worker processes, started at once; `result()` waits."""

    def __init__(self, tmp):
        self.inp = _inputs()
        self.tmp = tmp
        path = os.path.join(tmp, "inputs.pkl")
        with open(path, "wb") as f:
            pickle.dump(self.inp, f)
        env = dict(os.environ, DLROVER_TPU_FORCE_CPU="1",
                   OMP_NUM_THREADS="1")
        self.procs = [subprocess.Popen(
            [sys.executable, WORKER, path, str(r), tmp], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for r in range(WORLD)]
        self._out = None

    def result(self):
        if self._out is None:
            logs = []
            try:
                for p in self.procs:
                    logs.append(p.communicate(timeout=240)[0].decode())
            finally:
                for p in self.procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            codes = [p.returncode for p in self.procs]
            assert codes == [0] * WORLD, (codes, [lg[-3000:] for lg in logs])
            self._out = []
            for r in range(WORLD):
                with open(os.path.join(self.tmp, f"rank{r}.pkl"), "rb") as f:
                    self._out.append(pickle.load(f))
        return self._out


@pytest.fixture(scope="module", autouse=True)
def ranks(tmp_path_factory):
    # autouse: the processes start with the module's first test and run
    # beside the JAX side of every test before the first `result()`
    run = _Ranks(str(tmp_path_factory.mktemp("dp")))
    yield run
    for p in run.procs:
        if p.poll() is None:
            p.kill()
            p.wait()


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


def _tiny_et(spec=None):
    return JElastic(_tiny_init, _tiny_loss, [(r".*", (None,))],
                    optax.adam(1e-2), global_batch_size=16,
                    max_per_replica_batch=2,
                    mesh_spec=spec or jmesh.MeshSpec(data=WORLD))


# ---- MeshSpec (no processes) -----------------------------------------------


SPECS = [dict(data=2), dict(fsdp=4), dict(data=2, tensor=2, seq=2),
         dict(expert=2, pipe=3), dict()]


@pytest.mark.parametrize("kw", SPECS, ids=[str(k) for k in SPECS])
def test_mesh_spec_fields_equal_jax(kw):
    for j, t in ((jmesh.MeshSpec(**kw), tmesh.MeshSpec(**kw)),
                 (jmesh.MeshSpec(**kw).with_updates(data=3),
                  tmesh.MeshSpec(**kw).with_updates(data=3))):
        assert (j.axis_sizes, j.num_devices, j.batch_shards) == (
            t.axis_sizes, t.num_devices, t.batch_shards)
    for n in (1, 2, 4, 8, 12):
        j, t = jmesh.local_mesh_spec(n), tmesh.local_mesh_spec(n)
        assert j.axis_sizes == t.axis_sizes and j.batch_shards == n
    assert tmesh.AXIS_ORDER == jmesh.AXIS_ORDER
    assert tmesh.BATCH_AXES == jmesh.BATCH_AXES


@pytest.mark.parametrize("axis", ["fsdp", "tensor", "seq", "expert", "pipe"])
def test_mesh_axes_not_taken_raise(axis):
    """A training world spans data x fsdp x seq: fsdp and seq pass
    `check_world` for a world of their product with data and raise
    ValueError for another; tensor, expert and pipe raise
    NotImplementedError naming their ROADMAP item."""
    spec = tmesh.MeshSpec(**{axis: 2})
    if axis in ("fsdp", "seq"):
        assert spec.check_world(2) is spec
        assert spec.with_updates(data=2).check_world(4).num_devices == 4
        with pytest.raises(ValueError, match="world has 4"):
            spec.check_world(4)
    else:
        with pytest.raises(NotImplementedError, match="item 13"):
            spec.check_world(2)
    assert tmesh.MeshSpec(data=4).check_world(4).data == 4
    with pytest.raises(ValueError, match="world has 2"):
        tmesh.MeshSpec(data=4).check_world(2)


# ---- the world of four ------------------------------------------------------


def _jax_llama_global_grads(params, batch):
    """The gradient of JAX's masked mean over the whole global batch."""
    def f(p):
        return jllama.loss_fn(JCFG, p, batch)[0]

    return _leaves(jax.device_get(jax.jit(jax.grad(f))(params)))


def test_masked_llama_equals_jax_where_a_plain_mean_misses(ranks):
    """The 2-layer tiny Llama, masks that give the ranks different
    valid-token counts, optax.sgd(0.1) against torch SGD(lr=0.1), accum
    2: the gradient the port's optimizer sees at step 1, and params,
    losses and grad_norm after each of 3 steps, equal JAX's; a plain
    mean of the ranks' own gradients does not."""
    out = ranks.result()
    valid = [o["llama"]["valid_tokens"] for o in out]
    assert len(set(valid)) == WORLD, valid
    port = out[0]["llama"]
    names = port["leaf_names"]
    params0 = jax.tree_util.tree_map(jnp.asarray, ranks.inp["llama_params"])
    want = _jax_llama_global_grads(params0, ranks.inp["llama_batches"][0])
    miss = []
    for name, got, plain in zip(names, port["step1_grads"],
                                port["plain_mean"]):
        _close(got, want[name], f"step-1 gradient {name}")
        scale = np.abs(want[name]).max()
        miss.append(np.abs(plain - want[name]).max() / max(scale, 1e-30))
    # the weighting is what makes the port exact: the plain mean is off
    # by far more than the tolerance
    assert max(miss) > 100 * RTOL, miss

    j_et = JElastic(lambda k: jllama.init_params(JCFG, k),
                    lambda p, b, m: jllama.loss_fn(JCFG, p, b, mesh=m),
                    jllama.partition_rules(JCFG), optax.sgd(0.1),
                    global_batch_size=16, max_per_replica_batch=2,
                    mesh_spec=jmesh.MeshSpec(data=WORLD))
    assert j_et.grad_accum == port["grad_accum"] == 2
    state = _with_params(j_et.init_state(jax.random.PRNGKey(0)),
                         ranks.inp["llama_params"])
    for step, batch in enumerate(ranks.inp["llama_batches"]):
        state, m = j_et.step(state, batch)
        _close(port["losses"][step], m["loss"], f"step {step} loss")
        _close(port["grad_norms"][step], m["grad_norm"], f"step {step} norm")
        want = _leaves(jax.device_get(state["params"]))
        for name, got in _leaves(port["params"][step]).items():
            _close(got, want[name], f"step {step} {name}")


def test_tiny_model_steps_equal_jax_elastic_trainer(ranks):
    """tests/test_trainer.py's model, optax.adam(1e-2) against
    torch.optim.Adam(lr=1e-2), global 16 at 2 a replica (accum 2): 3
    steps, params, losses and grad_norm allclose to JAX's; the
    Trainer's per-host batch is the global one over the world size."""
    j_et = _tiny_et()
    assert j_et.grad_accum == 2
    state = _with_params(j_et.init_state(jax.random.PRNGKey(0)),
                         ranks.inp["tiny_params"])
    out = ranks.result()[0]["tiny"]
    assert out["grad_accum"] == 2
    # the Trainer's model-info report: the global batch's share a process
    assert out["batch_size_per_host"] == 16 // WORLD
    for step, batch in enumerate(ranks.inp["tiny_batches"]):
        state, m = j_et.step(state, batch)
        _close(out["losses"][step], m["loss"], f"step {step} loss")
        _close(out["grad_norms"][step], m["grad_norm"], f"step {step} norm")
        want = _leaves(jax.device_get(state["params"]))
        for name, got in _leaves(out["params"][step]).items():
            _close(got, want[name], f"step {step} {name}")


def test_ranks_bit_equal_after_every_step(ranks):
    """After the init broadcast and every step, each rank's params and
    optimizer state are rank 0's bit for bit (checked in the world by
    an all-gather), and the params each rank reported are the same."""
    out = ranks.result()
    for r in range(WORLD):
        assert out[r]["tiny"]["bit_equal"] == [True] * 3
        assert out[r]["llama"]["bit_equal"] == [True] * 3
        for case in ("tiny", "llama"):
            mine, zero = (_leaves(out[r][case]["params"][-1]),
                          _leaves(out[0][case]["params"][-1]))
            assert all(mine[k].tobytes() == zero[k].tobytes() for k in zero)


def test_world_change_4_to_2_keeps_state_and_global_batch(ranks):
    """JAX tests/test_trainer.py:76-94 across processes: ranks 2 and 3
    leave, ranks 0 and 1 join a world of two, rank 1 calling
    on_world_change(MeshSpec(data=2)) on its trained state and rank 0
    a replacement with a fresh trainer (initial params, Adam without
    moments, step 0): 2 replicas, per-replica batch x accum x 2 == 16,
    the trained params on both ranks and both bit-equal, and the next
    step allclose to JAX's continuation (which needs the trained
    moments). A second broadcast at one step makes rank 1's knocked-off
    state rank 0's and drops the entry rank 0 lacks."""
    j_et = _tiny_et()
    state = _with_params(j_et.init_state(jax.random.PRNGKey(0)),
                         ranks.inp["tiny_params"])
    for batch in ranks.inp["tiny_batches"]:
        state, _ = j_et.step(state, batch)
    state = j_et.on_world_change(state, mesh_spec=jmesh.MeshSpec(data=2))
    state, m = j_et.step(state, ranks.inp["tiny_next"])
    out = ranks.result()
    assert out[2]["world_change"] is None and out[3]["world_change"] is None
    for r in (0, 1):
        wc = out[r]["world_change"]
        assert wc["plan"] == j_et.plan and wc["plan"]["num_replicas"] == 2
        assert (wc["plan"]["per_replica_batch"] * wc["grad_accum"] * 2
                == 16)
        assert wc["params_kept"] and wc["bit_equal_after_change"]
        assert wc["bit_equal"]
        assert wc["stray_dropped"] and wc["bit_equal_after_rebroadcast"]
        assert all(
            got.tobytes() == want.tobytes() for got, want in zip(
                _leaves(wc["params_after_rebroadcast"]).values(),
                _leaves(out[0]["world_change"]["params"]).values()))
        _close(wc["loss"], m["loss"], "loss after the change")
        want = _leaves(jax.device_get(state["params"]))
        for name, got in _leaves(wc["params"]).items():
            _close(got, want[name], f"params after the change {name}")


def test_every_rank_keeps_its_shard_batch_rows(ranks):
    """Rank r's rows are those JAX's `shard_batch` places on device r of
    the data axis (the folded batch, slice r of dim 1); eval keeps the
    whole batch."""
    j_et = _tiny_et()
    inp = ranks.inp
    placed = j_et.acc.shard_batch(
        j_et._fold_microbatches(inp["tiny_batches"][0]))
    devices = list(j_et.mesh.devices.flat)
    out = ranks.result()
    for k, arr in placed.items():
        by_dev = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
        for r in range(WORLD):
            got = out[r]["rows"]["folded"][k]
            assert got.tobytes() == by_dev[devices[r]].tobytes(), (k, r)
    assert all(o["rows"]["whole_rows"] == 16 for o in out)
    assert all(o["rows"]["plan"] == j_et.plan for o in out)
    assert out[0]["backend"] == "gloo"


def _jax_ring_payloads(x, n, block):
    """JAX's ring (`_ring_reduce_scatter_q`) hop by hop on the host,
    through JAX's own quantize_any / dequantize_any: each rank's sent
    payloads and its final chunk."""
    chunks = x.shape[1] // n

    def chunk_at(r, i):
        return jnp.asarray(x[r, i * chunks:(i + 1) * chunks])

    shape = (chunks,) + x.shape[2:]
    pad = (-int(np.prod(shape))) % block
    quantize = jax.jit(lambda a: jq.quantize_any(a, block)[:2])
    dequantize = jax.jit(lambda q, s: jq.dequantize_any(q, s, shape, pad))
    acc = [chunk_at(r, (r + n - 1) % n) for r in range(n)]
    sent = [[] for _ in range(n)]
    for step in range(n - 1):
        wire = [quantize(acc[r]) for r in range(n)]
        for r in range(n):
            sent[r].append((np.asarray(wire[r][0]), np.asarray(wire[r][1])))
        acc = [dequantize(*wire[(r + n - 1) % n])
               + chunk_at(r, (r + n - 2 - step) % n) for r in range(n)]
    return sent, [np.asarray(a) for a in acc]


def test_compressed_collectives_equal_jax(ranks):
    """quantized_all_reduce_tree and quantized_reduce_scatter on the four
    ranks against JAX's on Mesh(devices[:4], ("dp",)): every int8
    payload and its scales byte-equal to JAX's, the outputs within
    1e-6 (bit equality reported), and JAX's ValueErrors."""
    inp = ranks.inp
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("dp",))
    dp = NamedSharding(mesh, P("dp"))
    contrib = inp["tree_contrib"]
    j_tree = jax.device_get(jax.jit(
        lambda g: jq.quantized_all_reduce_tree(g, mesh, "dp", BLOCK))(
        {k: jax.device_put(v, dp) for k, v in contrib.items()}))
    ring_global = inp["ring_x"].reshape(-1, inp["ring_x"].shape[-1])
    ring = jax.jit(lambda x: jq.quantized_reduce_scatter(x, mesh, "dp",
                                                         BLOCK))
    j_ring = np.asarray(ring(jax.device_put(ring_global, dp))).reshape(
        WORLD, -1, ring_global.shape[-1])
    quantize = jax.jit(lambda a: jq.quantize_any(a, BLOCK)[:2])
    want_sent, want_chunks = _jax_ring_payloads(inp["ring_x"], WORLD, BLOCK)
    out = ranks.result()
    bits = {}
    for r in range(WORLD):
        c = out[r]["collectives"]
        # the tree: each rank's one payload a leaf (sorted leaf order)
        for (q, s), k in zip(c["tree_sent"], sorted(contrib)):
            jq8, js8 = quantize(jnp.asarray(contrib[k][r]))
            assert q.tobytes() == np.asarray(jq8).tobytes(), (r, k)
            assert s.tobytes() == np.asarray(js8).tobytes(), (r, k)
        for k in contrib:
            _close(c["tree"][k], j_tree[k], f"tree {k} rank {r}",
                   rtol=COLL_TOL, atol=COLL_TOL)
            bits[f"tree {k} rank {r}"] = (
                c["tree"][k].tobytes() == np.asarray(j_tree[k]).tobytes())
        # the ring: n - 1 payloads a rank, hop by hop
        assert len(c["ring_sent"]) == WORLD - 1
        for (q, s), (jq8, js8) in zip(c["ring_sent"], want_sent[r]):
            assert q.tobytes() == jq8.tobytes() and s.tobytes() == (
                js8.tobytes()), r
        # the replay is JAX's ring (XLA may fuse the last dequantize and
        # add inside the jitted one, so only near the last bit)
        _close(want_chunks[r], j_ring[r], f"JAX ring, host replay, rank {r}",
               rtol=COLL_TOL, atol=COLL_TOL)
        _close(c["ring"], j_ring[r], f"ring rank {r}", rtol=COLL_TOL,
               atol=COLL_TOL)
        bits[f"ring rank {r}"] = c["ring"].tobytes() == j_ring[r].tobytes()
        assert "divisible by axis size (4)" in c["errors"]["ring"]
        assert "same shape" in c["errors"]["tree"]
    print("bit-equal to JAX:", bits)
    with pytest.raises(ValueError, match="divisible by axis size"):
        ring(jax.device_put(ring_global[:24], dp))
    with pytest.raises(ValueError, match="axis size"):
        jq.quantized_all_reduce_tree(
            {"a": jnp.zeros((3, 8))}, mesh, "dp", BLOCK)
