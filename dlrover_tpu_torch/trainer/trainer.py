"""High-level training loop — counterpart of dlrover_tpu/trainer/trainer.py
(reference atorch/atorch/trainer/atorch_trainer.py:136, `AtorchTrainer`).

The loop drives an `ElasticTrainer` (a fixed global batch, on one card
or data-parallel over the world `runtime.init()` joined: every rank
runs this loop on the same global batches, as every JAX process does):
epochs, resume of the latest flash checkpoint (memory first) with the
skip of consumed batches, a logging window with `steps_per_sec`,
periodic evaluation and saves (`save_steps`: the state staged to shm
asynchronously, persisted too under `save_storage=DISK`; a DISK save at
the end), `max_steps`, step and card metrics published for the agent,
and a `HangingDetector` watching step liveness. Callbacks mirror the HF
`TrainerCallback` surface.

With a `master_client` (the port's `agent/master_client.py`, talking to
a `LocalJobMaster`), the loop reports to the job master as JAX's does:
the model's size once a process after the first step
(`_report_model_info`, a daemon thread), the global step and the host
time per step at every logging window (the speed monitor), and a hang
through the `HangingDetector`. The port's `ElasticTrainer` has no
`profile_program` (XLA's cost analysis in JAX), so `flops_per_step` is
0.0 and `program_stats` empty, as JAX reports for a trainer without
one.
"""

import math
import os
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional

import torch
from torch.utils._pytree import tree_leaves

from dlrover_tpu_torch.agent.monitor import (
    publish_chip_metrics,
    write_step_metrics,
)
from dlrover_tpu_torch.common.log import default_logger as logger
from dlrover_tpu_torch.trainer.flash_checkpoint.engine import (
    Checkpointer,
    StorageType,
)
from dlrover_tpu_torch.utils.hanging_detector import HangingDetector


@dataclass
class TrainingArguments:
    """Reference: atorch/atorch/trainer/atorch_args.py (HF-style args).
    The JAX package's fields. `resume` (default True, as in JAX) restores the
    latest checkpoint under `output_dir/checkpoints`, a no-op where
    there is none; with `save_steps` or `resume` the Trainer holds a
    `Checkpointer` (`trainer.checkpointer`; its owner closes it)."""

    output_dir: str = "output"
    max_steps: int = -1
    num_epochs: int = 1
    logging_steps: int = 10
    eval_steps: int = 0  # 0 = no periodic eval
    save_steps: int = 0  # 0 = no periodic save
    save_storage: str = StorageType.DISK
    save_total_limit: int = 0  # kept by the storage deletion strategy
    resume: bool = True
    hang_timeout: float = 1800.0
    publish_step_metrics: bool = True
    # after the first step, send the model's size to the master's
    # metric collector
    report_model_info: bool = True


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
    """Wait for the training stream to finish the work behind `value`
    (that stream only: a checkpoint staging's copies on their own
    stream go on, as a JAX block_until_ready on the loss lets them)."""
    if isinstance(value, torch.Tensor) and value.is_cuda:
        torch.cuda.current_stream(value.device).synchronize()


class Trainer:
    """Train an ElasticTrainer-wrapped model with flash checkpointing.

    ``train_data`` yields host batches whose leading dim equals the
    elastic trainer's global batch size (an `ElasticDataLoader`, an
    `ElasticDataset.batches(...)` stream or any iterable); ``eval_data``
    likewise for evaluation.
    """

    def __init__(
        self,
        elastic_trainer,
        args: Optional[TrainingArguments] = None,
        train_data: Optional[Iterable] = None,
        eval_data: Optional[Iterable] = None,
        callbacks: Optional[List[TrainerCallback]] = None,
        checkpointer: Optional[Checkpointer] = None,
        master_client=None,
    ):
        self.et = elastic_trainer
        self.args = args or TrainingArguments()
        self.train_data = train_data
        self.eval_data = eval_data
        self.callbacks = list(callbacks or [])
        self._mc = master_client
        self.checkpointer = checkpointer
        if self.checkpointer is None and (
            self.args.save_steps > 0 or self.args.resume
        ):
            self.checkpointer = Checkpointer(
                os.path.join(self.args.output_dir, "checkpoints"),
                max_to_keep=self.args.save_total_limit,
            )
        self.global_step = 0
        self.last_logs: Dict = {}
        # once per PROCESS, not per job: a restarted or resumed worker
        # reports again (the master's collector is in memory)
        self._model_info_reported = False
        self._hang = HangingDetector(
            timeout=self.args.hang_timeout, master_client=master_client
        )

    def _report_model_info(self, state, batch):
        """One-shot after the first step: the model's size and the
        batch's shape to the master (JAX `Trainer._report_model_info`),
        in a daemon thread off the training path; a failed report is
        logged and dropped, as in JAX."""
        if self._mc is None or not self.args.report_model_info:
            return

        def _report():
            try:
                params = (
                    state.get("params")
                    if isinstance(state, dict)
                    else state
                )
                layout = (state.get("layout")
                          if isinstance(state, dict) else None)
                if layout is not None:
                    # fsdp pieces: the model's size, not this rank's share
                    num_params = int(sum(
                        math.prod(s) for s in layout.shapes.values()))
                else:
                    num_params = int(
                        sum(
                            x.numel()
                            for x in tree_leaves(params)
                            if isinstance(x, torch.Tensor)
                        )
                    )
                bsz = 0
                seq = 0
                tok = (
                    batch.get("tokens")
                    if isinstance(batch, dict)
                    else None
                )
                if tok is not None and getattr(tok, "ndim", 0) >= 2:
                    # train_data yields GLOBAL batches; the per-host
                    # share is what the master's resource estimates
                    # need (a host is a rank of the trainer's world,
                    # JAX's `jax.process_count()`)
                    bsz = int(tok.shape[0]) // self.et.acc.world_size
                    seq = int(tok.shape[1])
                # no program profile (XLA's cost analysis in JAX): no
                # FLOP count and no program stats, as JAX reports for
                # a trainer without `profile_program`
                self._mc.report_model_info(
                    num_params=num_params,
                    flops_per_step=0.0,
                    batch_size_per_host=bsz,
                    seq_len=seq,
                    program_stats="",
                )
            except Exception:  # noqa: BLE001 — never kill training
                logger.debug("model info report failed", exc_info=True)

        threading.Thread(
            target=_report, name="model-info-report", daemon=True
        ).start()

    # -- checkpoint --------------------------------------------------------

    def save(self, state, storage_type: Optional[str] = None) -> float:
        """Save `state` as `global_step`; returns the seconds the loop
        blocked (the on-device snapshot; staging and persisting run in
        the background)."""
        st = storage_type or self.args.save_storage
        blocked = self.checkpointer.save_checkpoint(
            self.global_step, state, storage_type=st
        )
        logger.info(
            "saved step %d to %s (blocked %.3f s)",
            self.global_step,
            st,
            blocked,
        )
        for cb in self.callbacks:
            cb.on_save(self, state, self.global_step)
        return blocked

    def _maybe_resume(self, state):
        """Restore the latest checkpoint into `state` in place (params,
        optimizer, step) and set `global_step`; a no-op with nothing
        saved."""
        if not (self.args.resume and self.checkpointer):
            return state
        step, restored = self.checkpointer.load_checkpoint(target=state)
        if restored is None:
            return state
        self.global_step = step
        logger.info("resumed from step %d", step)
        return restored

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
        state = self._maybe_resume(state)
        if self.args.save_steps and self.checkpointer:
            # the snapshot buffers and the page-locked segment, before
            # the first step rather than inside the first save
            self.checkpointer.prepare(state)
        self._hang.start()
        for cb in self.callbacks:
            cb.on_train_begin(self, state)

        # after a resume, or on a second train() of this Trainer, the
        # consumed batches are not replayed (fully consumed epochs are
        # skipped, the partial one skips to where it left off) unless
        # the loader restores its own position (`load_state_dict`)
        skip = 0
        start_epoch = 0
        if self.global_step > 0 and not hasattr(
            self.train_data, "load_state_dict"
        ):
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
        window_host_ms = 0.0
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
                    # host time = Python + launches, before the wait
                    # for the device: the runtime-straggler signal
                    t_host = time.monotonic()
                    state, metrics = self.et.step(state, batch)
                    window_host_ms += (time.monotonic() - t_host) * 1e3
                    _sync(metrics.get("loss"))
                    if not self._model_info_reported:
                        self._model_info_reported = True
                        self._report_model_info(state, batch)
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
                        if self._mc is not None:
                            # a lost step report never stops training
                            # (the JAX Trainer swallows it too)
                            try:
                                self._mc.report_global_step(
                                    self.global_step,
                                    host_compute_ms=(
                                        window_host_ms
                                        / max(window_steps, 1)
                                    ),
                                )
                            except Exception:  # noqa: BLE001
                                pass
                        window_t0 = time.monotonic()
                        window_steps = 0
                        window_host_ms = 0.0
                    if a.eval_steps and self.global_step % a.eval_steps == 0:
                        self.evaluate(state)
                    if a.save_steps and self.global_step % a.save_steps == 0:
                        self.save(state)
                    if a.max_steps > 0 and self.global_step >= a.max_steps:
                        stop = True
                        break
        finally:
            self._hang.stop()
        if self.args.save_steps and self.checkpointer:
            self.save(state, storage_type=StorageType.DISK)
        for cb in self.callbacks:
            cb.on_train_end(self, state)
        return state
