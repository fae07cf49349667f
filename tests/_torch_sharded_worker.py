"""One rank of tests/test_torch_sharded.py's and tests/test_torch_sequence.py's
worlds: four of these processes join a gloo world on the CPU, run the
port's sharded-state and sequence-parallel cases and write what they saw
to `<out>/rank<r>.pkl` for the test process, which holds it to the JAX
package. It imports torch and the port only.

    python tests/_torch_sharded_worker.py <inputs.pkl> <rank> <out dir> <mode>

mode "train": every MeshSpec case of ElasticTrainer (fsdp=4, data=2 x
fsdp=2, data=2 x seq=2 under Ulysses and ring, fsdp=2 x seq=2), then the
world changes: a live re-shard fsdp 2 -> 4 (ranks 2 and 3 fresh), a
sharded flash checkpoint, a shrink to fsdp=2 that lost two pieces
(on_world_change raises) and the restore from the checkpoint.
mode "seq": Ulysses and ring attention on a seq group of four.
"""

import os
import pickle
import subprocess
import sys

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from dlrover_tpu_torch import runtime  # noqa: E402
from dlrover_tpu_torch.models import llama  # noqa: E402
from dlrover_tpu_torch.ops.attention import reference_attention  # noqa: E402
from dlrover_tpu_torch.parallel import sequence  # noqa: E402
from dlrover_tpu_torch.parallel.mesh import MeshSpec  # noqa: E402
from dlrover_tpu_torch.parallel.sharding import flat_leaves  # noqa: E402
from dlrover_tpu_torch.trainer.elastic.trainer import (  # noqa: E402
    ElasticTrainer,
)

LR, WD, EPS = 1e-3, 1e-4, 1e-3


def _np(t):
    return t.detach().cpu().numpy().copy()


def _cfg(sp="none"):
    return llama.LlamaConfig.tiny(dtype=torch.float32, seq_parallel=sp)


def _trainer(inp, spec, sp="none", global_batch=None):
    cfg = _cfg(sp)
    return ElasticTrainer(
        lambda g: llama.params_from_numpy(cfg, inp["params"], device="cpu",
                                          dtype=torch.float32),
        lambda p, b: llama.loss_fn(cfg, p, b),
        lambda ps: torch.optim.AdamW(ps, lr=LR, betas=(0.9, 0.999),
                                     eps=EPS, weight_decay=WD),
        global_batch_size=global_batch or 4 * spec.batch_shards,
        max_per_replica_batch=2, device="cpu", mesh_spec=spec,
        rules=llama.partition_rules(cfg))


def _batch(b):
    return {"tokens": torch.from_numpy(b["tokens"]).long(),
            "loss_mask": torch.from_numpy(b["loss_mask"])}


def whole(state, tensors):
    """{path: the whole leaf} of `tensors` ({param path: this rank's
    tensor shaped like that param's piece}), the pieces all-gathered
    over the fsdp group."""
    plan = state["layout"]
    out = {}
    for path, t in sorted(tensors.items()):
        d = plan.dim(path)
        if d is not None:
            t = runtime.all_gather_dim(t.detach().contiguous(), d,
                                       plan.mesh.group("fsdp"))
        out[path] = _np(t)
    return out


def params_of(state):
    return {p: t for p, t in flat_leaves(state["params"])}


def moments_of(state, key):
    opt = state["opt_state"]
    by_id = {id(t): p for p, t in flat_leaves(state["params"])}
    return {by_id[id(p)]: opt.state[p][key]
            for g in opt.param_groups for p in g["params"]}


def record(state):
    return {"params": whole(state, params_of(state)),
            "mu": whole(state, moments_of(state, "exp_avg")),
            "nu": whole(state, moments_of(state, "exp_avg_sq"))}


def case_mesh(inp, name, spec_kw, sp):
    spec = MeshSpec(**spec_kw)
    et = _trainer(inp, spec, sp)
    state = et.init_state(torch.Generator().manual_seed(0))
    out = {"grad_accum": et.grad_accum,
           "pieces": {p: tuple(t.shape) for p, t in params_of(state).items()},
           "moment_pieces": {}, "losses": [], "grad_norms": [],
           "stored_bytes": 0}
    for b in inp["batches"][name]:
        state, m = et.step(state, _batch(b))
        out["losses"].append(float(m["loss"]))
        out["grad_norms"].append(float(m["grad_norm"]))
    out["moment_pieces"] = {p: tuple(t.shape) for p, t in
                            moments_of(state, "exp_avg").items()}
    out["stored_bytes"] = sum(
        t.numel() * t.element_size() for t in list(params_of(state).values())
        + list(moments_of(state, "exp_avg").values())
        + list(moments_of(state, "exp_avg_sq").values()))
    out.update(record(state))
    out["state_shardings"] = {p: tuple(s) for p, s in
                              et.acc.state_shardings["params"].items()}
    return out


def _rejoin(port, world, rank):
    if dist.is_initialized():
        dist.destroy_process_group()
    runtime.context().reset()
    runtime.join_world(f"127.0.0.1:{port}", world, rank)


def _engine(tmp, rank, num_nodes):
    from dlrover_tpu_torch.trainer.flash_checkpoint.engine import (
        CheckpointEngine,
    )

    return CheckpointEngine(os.path.join(tmp, "ckpt"),
                            job_name=f"sharded-{os.getpid()}-{rank}",
                            node_rank=rank, num_nodes=num_nodes)


def case_world_changes(inp, rank, tmp):
    """fsdp=2 over ranks 0 and 1 for 2 steps; then a world of four,
    ranks 0 and 1 calling on_world_change(MeshSpec(fsdp=4)) and ranks 2
    and 3 fresh trainers; one step. Then the sharded flash checkpoint
    of that state; ranks 2 and 3 leave, ranks 0 and 1 form a world of
    two and on_world_change(MeshSpec(fsdp=2)) raises (pieces 2 and 3
    died); fresh fsdp=2 trainers restore from the checkpoint (storage:
    every rank's file) and step once."""
    out = {}
    spec2 = MeshSpec(fsdp=2)
    if rank < 2:
        _rejoin(inp["port2"], 2, rank)
        et = _trainer(inp, spec2, global_batch=8)
        state = et.init_state(torch.Generator().manual_seed(0))
        out["before"] = {"grad_accum": et.grad_accum, "losses": []}
        for b in inp["batches"]["reshard"][:2]:
            state, m = et.step(state, _batch(b))
            out["before"]["losses"].append(float(m["loss"]))
        out["before"].update(record(state))
    _rejoin(inp["port3"], 4, rank)
    spec4 = MeshSpec(fsdp=4)
    if rank < 2:
        state = et.on_world_change(state, mesh_spec=spec4)
    else:
        et = _trainer(inp, spec4, global_batch=8)
        state = et.init_state(torch.Generator().manual_seed(1))
    out["after"] = {"grad_accum": et.grad_accum, "step": state["step"],
                    "pieces": {p: tuple(t.shape) for p, t in
                               params_of(state).items()}}
    out["after"]["changed"] = record(state)
    state, m = et.step(state, _batch(inp["batches"]["reshard"][2]))
    out["after"]["loss"] = float(m["loss"])
    out["after"]["grad_norm"] = float(m["grad_norm"])
    out["after"].update(record(state))

    # the sharded flash checkpoint of step 3, on every rank's storage
    eng = _engine(tmp, rank, 4)
    eng.save_to_storage(3, state)
    assert eng.wait_for_persist(3, timeout=120)
    dist.barrier()
    eng.close()
    from dlrover_tpu_torch.trainer.flash_checkpoint.engine import (
        _leaves_and_shards,
    )

    leaves, table = _leaves_and_shards(state)
    out["staged_keys"] = sorted(leaves)
    out["staged_bytes"] = sum(t.numel() * t.element_size()
                              for t in leaves.values())
    out["shard_table"] = {p: (e["shape"], e["keys"], e["indices"])
                          for p, e in table.items()}
    saved = record(state)
    if rank >= 2:
        dist.destroy_process_group()
        return out
    _rejoin(inp["port4"], 2, rank)
    try:
        et.on_world_change(state, mesh_spec=spec2)
        out["lost_pieces_error"] = None
    except RuntimeError as e:
        out["lost_pieces_error"] = str(e)
    et = _trainer(inp, spec2, global_batch=8)
    fresh = et.init_state(torch.Generator().manual_seed(2))
    eng = _engine(tmp, rank, 2)
    step, restored = eng.load(target=fresh)
    out["restore"] = {"step": step, "source": eng.last_load_source}
    eng.close()
    got = record(restored)
    out["restore"]["byte_equal"] = all(
        got[k][p].tobytes() == saved[k][p].tobytes()
        for k in saved for p in saved[k])
    restored, m = et.step(restored, _batch(inp["batches"]["reshard"][3]))
    out["restore"]["loss"] = float(m["loss"])
    out["restore"].update(record(restored))
    return out


def case_seq(inp, rank):
    """Ulysses and ring on a seq group of four, each on rank's chunk:
    the outputs and the gradients of sum(out * cotangent), all-gathered
    along the sequence."""
    mesh = MeshSpec(seq=4).build()
    group = mesh.group("seq")
    out = {}
    for name, x in inp["seq"].items():
        s = x["q"].shape[1] // 4
        chunk = slice(rank * s, (rank + 1) * s)
        q, k, v = (torch.from_numpy(x[n][:, chunk]).requires_grad_(True)
                   for n in ("q", "k", "v"))
        ct = torch.from_numpy(x["ct"][:, chunk])
        for mode in ("ulysses", "ring"):
            o = sequence.sp_attention(
                q, k, v, mesh, mode=mode, causal=x["causal"],
                attn_fn=lambda a, b, c, causal: reference_attention(
                    a, b, c, causal))
            g = torch.autograd.grad((o * ct).sum(), (q, k, v))
            res = [o] + list(g)
            out[(name, mode)] = [
                _np(runtime.all_gather_dim(t.detach(), 1, group))
                for t in res]
    return out


class Ranks:
    """The test side: the four worker processes of `mode`, started at
    once on `inp` (pickled into `tmp`); `result()` waits for them and
    returns each rank's output."""

    def __init__(self, tmp, inp, mode):
        self.inp = inp
        self.tmp = tmp
        path = os.path.join(tmp, "inputs.pkl")
        with open(path, "wb") as f:
            pickle.dump(inp, f)
        env = dict(os.environ, DLROVER_TPU_FORCE_CPU="1",
                   OMP_NUM_THREADS="1")
        self.procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), path, str(r), tmp,
             mode], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT)
            for r in range(4)]
        self._out = None

    def result(self):
        if self._out is None:
            logs = []
            try:
                for p in self.procs:
                    logs.append(p.communicate(timeout=300)[0].decode())
            finally:
                self.kill()
            codes = [p.returncode for p in self.procs]
            assert codes == [0] * 4, (codes, [lg[-3000:] for lg in logs])
            self._out = []
            for r in range(4):
                with open(os.path.join(self.tmp, f"rank{r}.pkl"), "rb") as f:
                    self._out.append(pickle.load(f))
        return self._out

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def main():
    inp_path, rank, out_dir, mode = (sys.argv[1], int(sys.argv[2]),
                                     sys.argv[3], sys.argv[4])
    torch.set_num_threads(1)
    os.environ["DLROVER_TPU_SOCK_DIR"] = os.path.join(out_dir, "sock")
    os.environ["DLROVER_TPU_SHM_DIR"] = os.path.join(out_dir, "shm")
    os.makedirs(os.environ["DLROVER_TPU_SOCK_DIR"], exist_ok=True)
    os.makedirs(os.environ["DLROVER_TPU_SHM_DIR"], exist_ok=True)
    with open(inp_path, "rb") as f:
        inp = pickle.load(f)
    runtime.join_world(f"127.0.0.1:{inp['port']}", 4, rank)
    out = {"backend": dist.get_backend()}
    if mode == "seq":
        out["seq"] = case_seq(inp, rank)
    else:
        for name, (kw, sp) in inp["cases"].items():
            out[name] = case_mesh(inp, name, kw, sp)
        out["world_changes"] = case_world_changes(inp, rank, out_dir)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
