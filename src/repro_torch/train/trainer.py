"""Fault-tolerant training loop (the JAX package's ``train/trainer.py``).

  * checkpoint/restart: ``dist/checkpoint.py``'s ``CheckpointManager``
    (atomic, async, verified), under the reference's keys, so either
    package's ``Trainer`` resumes from the other's steps;
  * preemption: a SIGTERM/SIGINT handler checkpoints, then the loop exits;
  * straggler watchdog: a step slower than ``deadline_factor ×`` the
    trailing median (of up to 20 steps, once 5 exist) is logged and counted;
  * deterministic resume: data is (seed, step)-addressed, so restoring the
    params, the optimizer state and the step reproduces the exact batch
    sequence;
  * optional gradient compression with error feedback (``train/compress``).

Each step is ``train/step.py``'s ``train_wrap``, the body ``build_step``
and the launcher run, with the compression as its gradient hook; it splits
the batch into ``TrainerConfig.grad_accum`` microbatches (a port addition:
the JAX package's ``Trainer`` takes one batch a step, which is the default).

The loss function takes the params tree and a batch of tensors on the
params' device; ``batch_fn(step)`` may give NumPy arrays (a data pipeline's
batch), which the loop copies over.  ``jit`` is accepted for the JAX
package's signature and has no meaning here: each step runs eagerly.
"""
from __future__ import annotations

import dataclasses
import signal
import statistics
import time
from typing import Callable

import torch

from ..dist.checkpoint import CheckpointManager
from .compress import CompressionConfig, compress_grads, init_residual
from .functional import tree_leaves, tree_to_device
from .optimizer import OptConfig, adamw_init
from .step import train_wrap

__all__ = ["TrainerConfig", "Trainer"]


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = "checkpoints"
    ckpt_keep: int = 3
    log_every: int = 10
    deadline_factor: float = 3.0  # straggler threshold against the trailing median
    async_checkpoint: bool = True
    grad_accum: int = 1  # microbatches a step (``train_wrap``)
    opt: OptConfig = dataclasses.field(default_factory=OptConfig)
    compression: CompressionConfig = dataclasses.field(default_factory=CompressionConfig)


class Trainer:
    def __init__(
        self,
        loss_fn: Callable,  # (params, batch) -> (loss, metrics)
        params,
        batch_fn: Callable,  # step -> batch (deterministic)
        cfg: TrainerConfig,
        jit: bool = True,  # no meaning in torch (the module doc)
    ):
        self.cfg = cfg
        self.params = params
        self.device = tree_leaves(params)[0].device
        self.opt_state = adamw_init(params)
        self.batch_fn = batch_fn
        self.step = 0
        self.ckpt = CheckpointManager(cfg.ckpt_dir, keep=cfg.ckpt_keep)
        self.residual = init_residual(params) if cfg.compression.kind != "none" else None
        self.straggler_events: list = []
        self.history: list = []
        self._preempted = False
        self._step_fn = train_wrap(loss_fn, cfg.opt, cfg.grad_accum,
                                   grads_fn=self._compress if self.residual is not None else None)

    def _compress(self, grads):
        grads, self.residual = compress_grads(grads, self.residual, self.cfg.compression)
        return grads

    # ---------------------------------------------------------------- api --
    def install_preemption_handler(self):
        def handler(signum, frame):
            self._preempted = True

        signal.signal(signal.SIGTERM, handler)
        signal.signal(signal.SIGINT, handler)

    def _state(self) -> dict:
        return {"params": self.params, "opt": self.opt_state,
                "step": torch.tensor(self.step, dtype=torch.int32)}

    def load_state(self, state: dict) -> None:
        """Take ``{"params", "opt", "step"}`` (a restored or converted
        checkpoint, ``convert.trainer_state_from_reference``)."""
        self.params = state["params"]
        self.opt_state = state["opt"]
        self.step = int(state["step"])

    def try_resume(self) -> bool:
        if self.ckpt.latest_step() is None:
            return False
        restored, _ = self.ckpt.restore(self._state(), device=self.device)
        self.load_state(restored)
        return True

    def _checkpoint(self):
        if self.cfg.async_checkpoint:
            self.ckpt.save_async(self.step, self._state())
        else:
            self.ckpt.save(self.step, self._state())

    def run(self, steps: int | None = None) -> dict:
        steps = steps if steps is not None else self.cfg.total_steps
        durations: list = []
        t_start = time.perf_counter()
        end = self.step + steps
        while self.step < end and not self._preempted:
            batch = tree_to_device(self.batch_fn(self.step), self.device)
            t0 = time.perf_counter()
            self.params, self.opt_state, metrics = self._step_fn(
                self.params, self.opt_state, batch)
            loss = float(metrics["loss"])  # sync point (realistic pacing)
            dt = time.perf_counter() - t0
            # straggler watchdog
            if len(durations) >= 5:
                med = statistics.median(durations[-20:])
                if dt > self.cfg.deadline_factor * med:
                    self.straggler_events.append({"step": self.step, "dt": dt, "median": med})
            durations.append(dt)
            self.history.append({"step": self.step, "loss": loss, "dt": dt})
            self.step += 1
            if self.step % self.cfg.ckpt_every == 0:
                self._checkpoint()
        if self._preempted:
            self._checkpoint()
        self.ckpt.wait()
        return {
            "final_step": self.step,
            "final_loss": self.history[-1]["loss"] if self.history else float("nan"),
            "wall_s": time.perf_counter() - t_start,
            "stragglers": len(self.straggler_events),
            "preempted": self._preempted,
        }
