"""High-level training loop — counterpart of dlrover_tpu/trainer/trainer.py
(reference atorch/atorch/trainer/atorch_trainer.py:136, `AtorchTrainer`).

The loop drives an `ElasticTrainer` (a fixed global batch on one card):
epochs, resume-skip of consumed batches, a logging window with
`steps_per_sec`, periodic evaluation, `max_steps`, step and card
metrics published for the agent, and a `HangingDetector` watching step
liveness. Callbacks mirror the HF `TrainerCallback` surface.

Not ported yet: the checkpoint half (`Checkpointer`, `save`, resume;
ROADMAP queue 1, item 8: flash checkpoint) and the control plane (the
master client; item 9). Arguments that ask for either raise
`NotImplementedError`; nothing is skipped quietly.
"""

import time
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional

import torch

from dlrover_tpu_torch.agent.monitor import (
    publish_chip_metrics,
    write_step_metrics,
)
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.utils.hanging_detector import HangingDetector

_NO_CHECKPOINT = (
    "checkpoint save and resume are not ported yet (ROADMAP queue 1, "
    "item 8: flash checkpoint); pass save_steps=0 and resume=False"
)


@dataclass
class TrainingArguments:
    """Reference: atorch/atorch/trainer/atorch_args.py (HF-style args).
    The JAX package's checkpoint fields (output_dir, save_storage,
    save_total_limit) and report_model_info come with the checkpoint
    and control-plane ports; until then `resume` defaults to False (in
    JAX it is True, a no-op where there is nothing to resume)."""

    max_steps: int = -1
    num_epochs: int = 1
    logging_steps: int = 10
    eval_steps: int = 0  # 0 = no periodic eval
    save_steps: int = 0  # 0 = no periodic save (> 0 is not ported)
    resume: bool = False  # True (the JAX default) is not ported yet
    hang_timeout: float = 1800.0
    publish_step_metrics: bool = True


class TrainerCallback:
    """Subclass-and-override hook points (HF TrainerCallback surface)."""

    def on_train_begin(self, trainer, state):  # noqa: D401
        pass

    def on_step_end(self, trainer, state, metrics: Dict):
        pass

    def on_log(self, trainer, state, logs: Dict):
        pass

    def on_save(self, trainer, state, step: int):
        pass

    def on_evaluate(self, trainer, state, metrics: Dict):
        pass

    def on_train_end(self, trainer, state):
        pass


def _sync(value) -> None:
    """Wait for the device to finish the work behind `value`."""
    if isinstance(value, torch.Tensor) and value.is_cuda:
        torch.cuda.synchronize(value.device)


class Trainer:
    """Train an ElasticTrainer-wrapped model.

    ``train_data`` yields host batches whose leading dim equals the
    elastic trainer's global batch size (any iterable); ``eval_data``
    likewise for evaluation.
    """

    def __init__(
        self,
        elastic_trainer,
        args: Optional[TrainingArguments] = None,
        train_data: Optional[Iterable] = None,
        eval_data: Optional[Iterable] = None,
        callbacks: Optional[List[TrainerCallback]] = None,
        master_client=None,
    ):
        self.et = elastic_trainer
        self.args = args or TrainingArguments()
        if self.args.save_steps > 0 or self.args.resume:
            raise NotImplementedError(_NO_CHECKPOINT)
        if master_client is not None:
            raise NotImplementedError(
                "the master client (control plane) is not ported yet "
                "(ROADMAP queue 1, item 9); pass master_client=None"
            )
        self.train_data = train_data
        self.eval_data = eval_data
        self.callbacks = list(callbacks or [])
        self.global_step = 0
        self.last_logs: Dict = {}
        self._hang = HangingDetector(timeout=self.args.hang_timeout)

    # -- evaluation --------------------------------------------------------

    def evaluate(self, state) -> Dict:
        if self.eval_data is None:
            return {}
        totals: Dict[str, float] = {}
        count = 0
        for batch in self.eval_data:
            metrics = self.et.eval_step(state, batch)
            for k, v in metrics.items():
                totals[k] = totals.get(k, 0.0) + float(v)
            count += 1
        logs = {
            f"eval_{k}": v / max(count, 1) for k, v in totals.items()
        }
        for cb in self.callbacks:
            cb.on_evaluate(self, state, logs)
        return logs

    # -- main loop ---------------------------------------------------------

    def train(self, state=None) -> Any:
        if state is None:
            state = self.et.init_state(
                torch.Generator(device=self.et.device).manual_seed(0)
            )
        self._hang.start()
        for cb in self.callbacks:
            cb.on_train_begin(self, state)

        # a second train() on the same Trainer does not replay the
        # batches the first consumed: fully consumed epochs are skipped,
        # the partial one skips to where it left off
        skip = 0
        start_epoch = 0
        if self.global_step > 0:
            try:
                n_batches = len(self.train_data)
            except TypeError:
                n_batches = 0
            if n_batches:
                start_epoch = self.global_step // n_batches
                skip = self.global_step % n_batches
            else:
                skip = self.global_step

        window_t0 = time.monotonic()
        window_steps = 0
        stop = False
        try:
            for epoch in range(start_epoch, self.args.num_epochs):
                if stop:
                    break
                if hasattr(self.train_data, "set_epoch"):
                    self.train_data.set_epoch(epoch)
                for batch in self.train_data:
                    if skip > 0:
                        skip -= 1
                        continue
                    state, metrics = self.et.step(state, batch)
                    _sync(metrics.get("loss"))
                    self.global_step += 1
                    window_steps += 1
                    self._hang.record_step(self.global_step)
                    for cb in self.callbacks:
                        cb.on_step_end(self, state, metrics)

                    a = self.args
                    if (
                        a.logging_steps
                        and self.global_step % a.logging_steps == 0
                    ):
                        dt = time.monotonic() - window_t0
                        logs = {k: float(v) for k, v in metrics.items()}
                        logs["steps_per_sec"] = window_steps / max(dt, 1e-9)
                        logs["step"] = self.global_step
                        self.last_logs = logs
                        logger.info("step %s", logs)
                        for cb in self.callbacks:
                            cb.on_log(self, state, logs)
                        if a.publish_step_metrics:
                            write_step_metrics(
                                self.global_step, loss=logs.get("loss", 0.0)
                            )
                            # card stats for the agent's chip collector:
                            # a file that cannot be written never stops
                            # training (the JAX Trainer swallows it too)
                            try:
                                publish_chip_metrics()
                            except Exception:  # noqa: BLE001
                                pass
                        window_t0 = time.monotonic()
                        window_steps = 0
                    if a.eval_steps and self.global_step % a.eval_steps == 0:
                        self.evaluate(state)
                    if a.max_steps > 0 and self.global_step >= a.max_steps:
                        stop = True
                        break
        finally:
            self._hang.stop()
        for cb in self.callbacks:
            cb.on_train_end(self, state)
        return state
