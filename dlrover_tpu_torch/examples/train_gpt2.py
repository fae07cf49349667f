"""GPT-2 training under the port's elastic launcher — the counterpart of
examples/train_gpt2.py (the nanoGPT example).

The harness of train_tiny_llama.py (master, agent, an `ElasticTrainer`
on the card, on the CPU under DLROVER_TPU_FORCE_CPU=1) driving the GPT
family (learned positions, pre-LN, tied head) through the same trainer
machinery: a model is its (config, init, loss), so the family swap is
data, not code.

    python -m dlrover_tpu_torch.trainer.elastic_run --nnodes 1 \
        dlrover_tpu_torch/examples/train_gpt2.py --steps 30

Flags:
  --steps N          training steps (default 30)
  --crash-at-step K  kill this process at step K on the FIRST attempt
  --ckpt-dir DIR     flash checkpointing + resume
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


def main(argv=None):
    import torch

    import dlrover_tpu_torch
    from dlrover_tpu_torch import runtime
    from dlrover_tpu_torch.agent.monitor import write_step_metrics
    from dlrover_tpu_torch.common.constants import NodeEnv
    from dlrover_tpu_torch.models import gpt
    from dlrover_tpu_torch.trainer.elastic.trainer import ElasticTrainer

    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--crash-at-step", type=int, default=-1)
    p.add_argument("--ckpt-dir", default=None)
    args = p.parse_args(argv)

    restart_count = int(os.environ.get(NodeEnv.RESTART_COUNT, "0"))
    dlrover_tpu_torch.init()
    device = runtime.device()
    cfg = gpt.GptConfig.tiny()
    et = ElasticTrainer(
        lambda g: gpt.init_params(cfg, g, device=device,
                                  dtype=cfg.param_dtype),
        lambda pm, b: gpt.loss_fn(cfg, pm, b),
        lambda ps: torch.optim.Adam(ps, lr=1e-2),
        global_batch_size=8, max_per_replica_batch=8, device=device,
    )
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
        if ckpt is not None and step % 5 == 0:
            ckpt.save_checkpoint(step, state, StorageType.DISK)
        if step % 10 == 0 or step == 1:
            print(f"step {step} loss {loss:.4f}", flush=True)
    if ckpt is not None:
        ckpt.close()  # the last save lands before the process ends

    if first_loss is None:  # resumed at/past --steps: nothing to do
        print(f"done: already at step {start_step}", flush=True)
        return 0
    print(
        f"done: restart_count={restart_count} "
        f"first_loss={first_loss:.4f} last_loss={last_loss:.4f}",
        flush=True,
    )
    if last_loss >= first_loss:
        print("loss did not decrease", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
