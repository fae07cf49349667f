"""One rank of tests/test_torch_dp.py's world: four of these processes
join a gloo world on the CPU, run every data-parallel case of the port
and write what they saw to `<out>/rank<r>.pkl` for the test process,
which holds it to the JAX package. It imports torch and the port only.

    python tests/_torch_dp_worker.py <inputs.pkl> <rank> <out dir>

The inputs (numpy, made by the test from seeds) carry the ports of the
two worlds: the first of four ranks, then, after the world change, one
of ranks 0 and 1.
"""

import os
import pickle
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from dlrover_tpu_torch import runtime  # noqa: E402
from dlrover_tpu_torch.models import llama  # noqa: E402
from dlrover_tpu_torch.ops import quantization as Q  # noqa: E402
from dlrover_tpu_torch.parallel.accelerate import (  # noqa: E402
    broadcast_state,
)
from dlrover_tpu_torch.parallel.mesh import MeshSpec  # noqa: E402
from dlrover_tpu_torch.trainer.elastic.trainer import (  # noqa: E402
    ElasticTrainer,
)


def _np(t):
    return t.detach().cpu().numpy().copy()


def _tree_np(tree):
    return {k: _tree_np(v) if isinstance(v, dict) else _np(v)
            for k, v in tree.items()}


def _to_torch(tree):
    return {k: _to_torch(v) if isinstance(v, dict)
            else torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _same_on_every_rank(tensors) -> bool:
    """Every rank's tensors bit-equal to rank 0's."""
    flat = torch.cat([t.detach().reshape(-1).view(torch.uint8)
                      for t in tensors])
    got = [torch.empty_like(flat) for _ in range(dist.get_world_size())]
    dist.all_gather(got, flat)
    return all(torch.equal(g, got[0]) for g in got)


def _state_tensors(state):
    opt = state["opt_state"]
    out = llama_leaves(state["params"])
    for p in [p for g in opt.param_groups for p in g["params"]]:
        out += [v for _, v in sorted(opt.state.get(p, {}).items())
                if torch.is_tensor(v)]
    return out


def llama_leaves(tree):
    from torch.utils._pytree import tree_leaves

    return [t for t in tree_leaves(tree) if torch.is_tensor(t)]


def tiny_loss(p, b):
    """tests/test_trainer.py's model: tanh(x w + b) head, mean cross
    entropy."""
    h = torch.tanh(b["x"] @ p["w"] + p["b"])
    logits = h @ p["head"]
    loss = F.cross_entropy(logits, b["y"].long())
    return loss, {"loss": loss}


class RecordingSGD(torch.optim.SGD):
    """SGD that keeps a copy of the gradients of each step."""

    def __init__(self, params, lr):
        super().__init__(params, lr=lr)
        self.seen = []

    def step(self, closure=None):
        self.seen.append([_np(p.grad) for g in self.param_groups
                          for p in g["params"]])
        return super().step(closure)


def case_rows(inp, rank):
    """The rows place_batch keeps on this rank, folded and not."""
    et = ElasticTrainer(
        lambda g: _to_torch(inp["tiny_params"]), tiny_loss,
        lambda ps: torch.optim.Adam(ps, lr=1e-2),
        global_batch_size=16, max_per_replica_batch=2, device="cpu",
        mesh_spec=MeshSpec(data=4))
    folded = et._fold_microbatches(inp["tiny_batches"][0])
    placed = et.acc.place_batch(folded)
    whole = et.acc.place_batch(inp["tiny_batches"][0], shard=False)
    return {"folded": {k: _np(v) for k, v in placed.items()},
            "whole_rows": int(whole["x"].shape[0]),
            "grad_accum": et.grad_accum, "plan": dict(et.plan)}


def case_tiny(inp, rank):
    """3 steps of the tiny model under Adam(1e-2), global 16, max 2 a
    replica (accum 2). Returns the trainer and state for the world
    change."""
    et = ElasticTrainer(
        lambda g: _to_torch(inp["tiny_params"]), tiny_loss,
        lambda ps: torch.optim.Adam(ps, lr=1e-2),
        global_batch_size=16, max_per_replica_batch=2, device="cpu",
        mesh_spec=MeshSpec(data=4))
    state = et.init_state(torch.Generator().manual_seed(0))
    out = {"losses": [], "grad_norms": [], "params": [], "bit_equal": [],
           "grad_accum": et.grad_accum}
    for batch in inp["tiny_batches"]:
        state, m = et.step(state, batch)
        out["losses"].append(float(m["loss"]))
        out["grad_norms"].append(float(m["grad_norm"]))
        out["params"].append(_tree_np(state["params"]))
        out["bit_equal"].append(_same_on_every_rank(_state_tensors(state)))
    out["batch_size_per_host"] = reported_batch(et, state)
    return out, et, state


def reported_batch(et, state):
    """The per-host batch the Trainer reports to the master for a global
    batch of 16 rows (JAX divides by its process count)."""
    import time

    from dlrover_tpu_torch.trainer.trainer import Trainer, TrainingArguments

    class Recorder:
        calls = []

        def report_model_info(self, **kw):
            self.calls.append(kw)

    rec = Recorder()
    trainer = Trainer(et, TrainingArguments(resume=False), master_client=rec)
    trainer._report_model_info(state, {"tokens": np.zeros((16, 5))})
    deadline = time.monotonic() + 30
    while not rec.calls and time.monotonic() < deadline:
        time.sleep(0.01)
    return rec.calls[0]["batch_size_per_host"]


def case_llama(inp, rank):
    """3 SGD(0.1) steps of the 2-layer tiny Llama (f32) on masked
    batches whose ranks hold different valid-token counts, global 16,
    max 2 a replica (accum 2); the step-1 gradients the optimizer saw;
    and the plain mean over ranks of each rank's own masked-mean
    gradient at the initial params."""
    cfg = llama.LlamaConfig.tiny(dtype=torch.float32)
    et = ElasticTrainer(
        lambda g: llama.params_from_numpy(cfg, inp["llama_params"],
                                          device="cpu", dtype=torch.float32),
        lambda p, b: llama.loss_fn(cfg, p, b),
        lambda ps: RecordingSGD(ps, lr=0.1),
        global_batch_size=16, max_per_replica_batch=2, device="cpu",
        mesh_spec=MeshSpec(data=4))
    state = et.init_state(torch.Generator().manual_seed(0))
    batches = [{"tokens": torch.from_numpy(b["tokens"]).long(),
                "loss_mask": torch.from_numpy(b["loss_mask"])}
               for b in inp["llama_batches"]]
    # the plain mean: each rank's gradient of the masked mean over its
    # own rows of the first batch, averaged over the ranks
    mine = {k: v.reshape((-1,) + v.shape[2:]) for k, v in et.acc.place_batch(
        et._fold_microbatches(batches[0])).items()}
    leaves = llama_leaves(state["params"])
    loss, _ = llama.loss_fn(cfg, state["params"], mine)
    plain = torch.autograd.grad(loss, leaves)
    plain = [g.clone() for g in plain]
    for g in plain:
        dist.all_reduce(g)
        g.div_(dist.get_world_size())
    out = {"losses": [], "grad_norms": [], "params": [], "bit_equal": [],
           "grad_accum": et.grad_accum, "plain_mean": [_np(g) for g in plain],
           "valid_tokens": float(mine["loss_mask"][:, 1:].sum())}
    for batch in batches:
        state, m = et.step(state, batch)
        out["losses"].append(float(m["loss"]))
        out["grad_norms"].append(float(m["grad_norm"]))
        out["params"].append(_tree_np(state["params"]))
        out["bit_equal"].append(_same_on_every_rank(_state_tensors(state)))
    out["step1_grads"] = state["opt_state"].seen[0]
    out["leaf_names"] = leaf_paths(state["params"])
    return out


def leaf_paths(tree, prefix=""):
    """The tree's leaf paths in its flatten order (dict insertion)."""
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out += leaf_paths(v, prefix + k + "/")
        else:
            out.append(prefix + k)
    return out


def case_collectives(inp, rank):
    """The compressed collectives on this rank's contributions, with
    every int8 payload this rank put on the wire, and the ValueError
    cases."""
    sent = []
    quantize_any = Q.quantize_any

    def recording(x, block=Q.DEFAULT_BLOCK):
        q, s, shape, pad = quantize_any(x, block)
        sent.append((_np(q), _np(s)))
        return q, s, shape, pad

    Q.quantize_any = recording
    try:
        tree = {k: torch.from_numpy(v[rank])
                for k, v in inp["tree_contrib"].items()}
        total = Q.quantized_all_reduce_tree(tree, block=inp["block"])
        tree_sent = list(sent)
        sent.clear()
        x = torch.from_numpy(inp["ring_x"][rank])
        chunk = Q.quantized_reduce_scatter(x, block=inp["block"])
        ring_sent = list(sent)
    finally:
        Q.quantize_any = quantize_any
    errors = {}
    try:
        Q.quantized_reduce_scatter(x[:6], block=inp["block"])
    except ValueError as e:
        errors["ring"] = str(e)
    bad = {"a": tree["a"] if rank else tree["a"][:3]}
    try:
        Q.quantized_all_reduce_tree(bad, block=inp["block"])
    except ValueError as e:
        errors["tree"] = str(e)
    return {"tree": {k: _np(v) for k, v in total.items()},
            "tree_sent": tree_sent, "ring": _np(chunk),
            "ring_sent": ring_sent, "errors": errors}


def case_world_change(inp, rank, et, state):
    """Ranks 2 and 3 leave; ranks 0 and 1 join a new world of two. Rank
    1 keeps its trained state and calls on_world_change(MeshSpec(data=
    2)); rank 0 comes back as a replacement process would, a new
    trainer whose `init_state` draws the initial params and a fresh Adam
    (step 0, no moments), and so must take rank 1's state. One more
    step. Then both, at one step, broadcast again with rank 1's state
    knocked off rank 0's (floats moved, an entry rank 0 lacks): rank 1
    ends with rank 0's state and without that entry."""
    before = {"params": _tree_np(state["params"])}
    dist.destroy_process_group()
    runtime.context().reset()
    if rank >= 2:
        return None
    runtime.join_world(f"127.0.0.1:{inp['port2']}", 2, rank)
    if rank == 0:
        et = ElasticTrainer(
            lambda g: _to_torch(inp["tiny_params"]), tiny_loss,
            lambda ps: torch.optim.Adam(ps, lr=1e-2),
            global_batch_size=16, max_per_replica_batch=2, device="cpu",
            mesh_spec=MeshSpec(data=2))
        state = et.init_state(torch.Generator().manual_seed(1))
    else:
        state = et.on_world_change(state, mesh_spec=MeshSpec(data=2))
    out = {"plan": dict(et.plan), "grad_accum": et.grad_accum,
           "params_kept": all(
               np.array_equal(before["params"][k], _np(v))
               for k, v in state["params"].items()),
           "bit_equal_after_change": _same_on_every_rank(
               _state_tensors(state))}
    state, m = et.step(state, inp["tiny_next"])
    out["loss"] = float(m["loss"])
    out["params"] = _tree_np(state["params"])
    out["bit_equal"] = _same_on_every_rank(_state_tensors(state))
    opt = state["opt_state"]
    first = opt.param_groups[0]["params"][0]
    if rank == 1:
        with torch.no_grad():
            for t in _state_tensors(state):
                if t.is_floating_point():
                    t.add_(1.0)
        opt.state[first]["stray"] = torch.zeros(3)
    broadcast_state(state, dist.group.WORLD)
    out["stray_dropped"] = "stray" not in opt.state[first]
    out["bit_equal_after_rebroadcast"] = _same_on_every_rank(
        _state_tensors(state))
    out["params_after_rebroadcast"] = _tree_np(state["params"])
    return out


def main():
    inp_path, rank, out_dir = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(1)
    with open(inp_path, "rb") as f:
        inp = pickle.load(f)
    runtime.join_world(f"127.0.0.1:{inp['port']}", 4, rank)
    out = {"backend": dist.get_backend()}
    out["rows"] = case_rows(inp, rank)
    out["tiny"], et, state = case_tiny(inp, rank)
    out["llama"] = case_llama(inp, rank)
    out["collectives"] = case_collectives(inp, rank)
    out["world_change"] = case_world_change(inp, rank, et, state)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
