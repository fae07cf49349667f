"""Tiny-Llama memorization demo under the port's elastic launcher — the
counterpart of examples/train_tiny_llama.py.

A small model trained through the full stack: `python -m
dlrover_tpu_torch.trainer.elastic_run` starts a master and an agent,
the agent supervises this script, and this script trains a tiny Llama
with an `ElasticTrainer` on the card (on the CPU under
DLROVER_TPU_FORCE_CPU=1), reporting steps so the agent can relay them.
Under `--nnodes N` (N agents, one worker each) the workers join one
`torch.distributed` world and train data-parallel: each takes its rows
of the same global batch of 8, and one all-reduce a step keeps their
states equal. Two agents on one machine, on the CPU:

    python -m dlrover_tpu_torch.trainer.elastic_run --nnodes 2 \
        --node-id 0 ... (one agent per rank; see README.md)

Flags:
  --steps N          training steps (default 30)
  --crash-at-step K  kill this process at step K on the FIRST attempt
                     (restart-recovery demo; needs --max-restarts >= 1)
  --ckpt-dir DIR     enable flash checkpointing: stage to the agent's
                     shm every step, persist to DIR every 5 steps,
                     resume on restart (memory first)
  --fsdp N           the world's MeshSpec(data=world/(N*seq), fsdp=N,
                     seq=seq): each rank stores 1/N of the split leaves
                     (llama.partition_rules) and of their moments
  --seq N            cut the sequence over N ranks (MeshSpec seq=N)
  --seq-parallel M   the attention under --seq > 1: ulysses | ring
                     (default ulysses)
"""

import argparse
import os
import sys

sys.path.insert(
    0,
    os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ),
)


def main():
    import torch

    import dlrover_tpu_torch
    from dlrover_tpu_torch.agent.monitor import write_step_metrics
    from dlrover_tpu_torch.common.constants import NodeEnv
    from dlrover_tpu_torch.models import llama
    from dlrover_tpu_torch import runtime
    from dlrover_tpu_torch.parallel.mesh import MeshSpec
    from dlrover_tpu_torch.trainer.elastic.trainer import ElasticTrainer

    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--crash-at-step", type=int, default=-1)
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--fsdp", type=int, default=1)
    p.add_argument("--seq", type=int, default=1)
    p.add_argument("--seq-parallel", default="ulysses",
                   choices=("ulysses", "ring"))
    args = p.parse_args()

    restart_count = int(os.environ.get(NodeEnv.RESTART_COUNT, "0"))
    # join the world the agent rendezvoused for us (no-op on single-node
    # runs); installs the membership watch so this process restarts
    # itself when the world changes
    ctx = dlrover_tpu_torch.init()
    device = runtime.device()
    cfg = llama.LlamaConfig.tiny(
        seq_parallel=args.seq_parallel if args.seq > 1 else "none")
    spec = None
    if args.fsdp > 1 or args.seq > 1:
        world = max(ctx.node_num, 1)
        spec = MeshSpec(data=world // (args.fsdp * args.seq),
                        fsdp=args.fsdp, seq=args.seq)
    # the global batch of 8 split over the world's batch shards (every
    # rank draws the same params and tokens from the same seeds)
    et = ElasticTrainer(
        lambda g: llama.init_params(cfg, g, device=device),
        lambda pm, b: llama.loss_fn(cfg, pm, b),
        lambda ps: torch.optim.Adam(ps, lr=1e-2),
        global_batch_size=8, max_per_replica_batch=8, device=device,
        mesh_spec=spec, rules=llama.partition_rules(cfg),
    )
    print(f"world {et.acc.world_size} rank {et.acc.rank} backend "
          f"{ctx.backend or 'none'} grad_accum {et.grad_accum} "
          f"mesh {et.acc.mesh}", flush=True)
    state = et.init_state(torch.Generator(device=device).manual_seed(0))
    tokens = torch.randint(
        0, cfg.vocab_size, (8, 33), device=device,
        generator=torch.Generator(device=device).manual_seed(1),
    )
    batch = {"tokens": tokens}

    ckpt = None
    start_step = 0
    if args.ckpt_dir:
        from dlrover_tpu_torch.trainer.flash_checkpoint.engine import (
            Checkpointer,
            StorageType,
        )

        ckpt = Checkpointer(args.ckpt_dir)
        saved_step, saved = ckpt.load_checkpoint(target=state)
        if saved is not None:
            state, start_step = saved, saved_step
            print(f"resumed from step {start_step}", flush=True)
            print(f"restore source: {ckpt.engine.last_load_source}",
                  flush=True)

    first_loss = last_loss = None
    for step in range(start_step + 1, args.steps + 1):
        if step == args.crash_at_step and restart_count == 0:
            print(f"[demo] injected crash at step {step}", flush=True)
            os._exit(17)
        state, metrics = et.step(state, batch)
        loss = float(metrics["loss"])
        if first_loss is None:
            first_loss = loss
        last_loss = loss
        write_step_metrics(step)
        if ckpt is not None:
            kind = (
                StorageType.DISK
                if step % 5 == 0
                else StorageType.MEMORY
            )
            blocked = ckpt.save_checkpoint(step, state, kind)
            if step % 10 == 0:
                print(
                    f"ckpt step {step} staged in {blocked*1e3:.1f} ms",
                    flush=True,
                )
        if step % 10 == 0 or step == 1:
            print(f"step {step} loss {loss:.4f}", flush=True)
    if ckpt is not None:
        ckpt.close()  # the last staging lands before the process ends

    if first_loss is None:  # resumed at/past --steps: nothing to do
        print(f"done: already at step {start_step}", flush=True)
        return
    print(
        f"done: restart_count={restart_count} "
        f"first_loss={first_loss:.4f} last_loss={last_loss:.4f}",
        flush=True,
    )
    if last_loss >= first_loss:
        print("loss did not decrease", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
