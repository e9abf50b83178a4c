"""Fault-tolerant training runtime — counterpart of
`repro.runtime.trainer`.

* checkpoint/restart — resume from the latest restorable checkpoint
  (params, optimizer state, data-iterator state; a stream with a ``step``
  attribute is kept at the trainer's step, so the state it saves says
  where the stream stands);
* preemption — SIGTERM (or ``preempted`` set by a hook) checkpoints and
  exits at the next step boundary;
* stragglers — a step over the deadline is logged and counted (its time is
  taken after the card has finished the step);
* retry — a transient step failure retries from the last good state, up to
  ``max_retries`` times (the optimizer returns new tensors, so the state a
  failed attempt started from is intact);
* mask-preserving sparse training — the Sense pruning masks are re-applied
  after every update (paper Fig. 5 retraining).

The step runs eagerly: ``loss_fn(params, batch)`` under autograd
(`optim.value_and_grad`), the optional error-feedback compression, then
`optim.adamw_update`.
"""
from __future__ import annotations

import dataclasses
import signal
import tempfile
import time
from pathlib import Path
from typing import Callable

import torch

from ..checkpoint import CheckpointManager
from ..distributed import compress
from ..optim import (AdamWConfig, adamw_init, adamw_update, apply_masks,
                     value_and_grad)


def _default_dir() -> str:
    return str(Path(tempfile.gettempdir()) / "repro_torch_ckpt")


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    checkpoint_every: int = 50
    checkpoint_dir: str = dataclasses.field(default_factory=_default_dir)
    step_deadline_s: float = 0.0       # 0 = no deadline
    max_retries: int = 2
    log_every: int = 10
    grad_compression: bool = False


class Trainer:
    def __init__(self, *, loss_fn: Callable, params, data,
                 opt_cfg: AdamWConfig | None = None,
                 cfg: TrainerConfig | None = None, masks=None):
        self.cfg = cfg or TrainerConfig()
        self.opt_cfg = opt_cfg or AdamWConfig()
        self.loss_fn = loss_fn
        self.data = data
        self.masks = masks
        self.params = params
        self.opt_state = adamw_init(params)
        self.step = 0
        self.metrics_log: list[dict] = []
        self.straggler_steps: list[int] = []
        self.preempted = False
        self._ckpt = CheckpointManager(self.cfg.checkpoint_dir,
                                       every=self.cfg.checkpoint_every)
        self._residuals = compress.zero_residuals(params) \
            if self.cfg.grad_compression else None
        self._sigterm = False

    def _on_sigterm(self, *_):
        self._sigterm = True

    def _train_step(self, params, opt_state, residuals, batch):
        loss, grads = value_and_grad(self.loss_fn, params, batch)
        if residuals is not None:
            grads, residuals = compress.compress_tree(grads, residuals)
        params, opt_state, metrics = adamw_update(self.opt_cfg, params,
                                                  grads, opt_state)
        if self.masks is not None:
            params = apply_masks(params, self.masks)
        return params, opt_state, residuals, loss, metrics

    # -- state (de)hydration ------------------------------------------------
    def _state(self):
        return {"params": self.params, "opt": self.opt_state}

    def resume(self) -> bool:
        step, tree, extra = self._ckpt.restore_latest(self._state())
        if step is None:
            return False
        self.step = step
        self.params = tree["params"]
        self.opt_state = tree["opt"]
        if extra.get("data_state") and hasattr(self.data, "load_state_dict"):
            self.data.load_state_dict(extra["data_state"])
        return True

    def _save(self, force=False):
        extra = {}
        if hasattr(self.data, "state_dict"):
            extra["data_state"] = self.data.state_dict()
        return self._ckpt.maybe_save(self.step, self._state(), extra=extra,
                                     force=force)

    # -- main loop -----------------------------------------------------------
    def run(self, *, fault_hook: Callable[[int], None] | None = None) -> dict:
        """Run to ``total_steps``.  ``fault_hook(step)`` may raise
        `TransientError` to simulate a transient failure: the step retries
        from the last good state.  SIGTERM is bound to the preemption flag
        while the run lasts (from the main thread) and the earlier handler
        is restored when it ends."""
        previous = signal.getsignal(signal.SIGTERM)
        try:
            signal.signal(signal.SIGTERM, self._on_sigterm)
            bound = True
        except ValueError:
            bound = False            # not the main thread
        try:
            return self._run(fault_hook)
        finally:
            if bound:
                signal.signal(signal.SIGTERM, previous
                              if previous is not None else signal.SIG_DFL)

    def _run(self, fault_hook) -> dict:
        while self.step < self.cfg.total_steps:
            if self._sigterm or self.preempted:
                self._save(force=True)
                return {"status": "preempted", "step": self.step}
            batch = self.data.batch_at(self.step) \
                if hasattr(self.data, "batch_at") else next(iter(self.data))
            t0 = time.monotonic()
            for attempt in range(self.cfg.max_retries + 1):
                try:
                    if fault_hook is not None:
                        fault_hook(self.step)
                    (self.params, self.opt_state, self._residuals, loss,
                     metrics) = self._train_step(
                        self.params, self.opt_state, self._residuals, batch)
                    break
                except TransientError:
                    if attempt == self.cfg.max_retries:
                        raise
            if loss.is_cuda:
                torch.cuda.synchronize(loss.device)
            dt = time.monotonic() - t0
            if self.cfg.step_deadline_s and dt > self.cfg.step_deadline_s:
                self.straggler_steps.append(self.step)
            self.step += 1
            if hasattr(self.data, "step"):
                self.data.step = self.step
            if self.step % self.cfg.log_every == 0 or \
                    self.step == self.cfg.total_steps:
                self.metrics_log.append({
                    "step": self.step, "loss": float(loss),
                    "grad_norm": float(metrics["grad_norm"]),
                    "lr": float(metrics["lr"]), "step_time_s": dt})
            self._save()
        self._save(force=True)
        return {"status": "done", "step": self.step,
                "final_loss": self.metrics_log[-1]["loss"]
                if self.metrics_log else None,
                "stragglers": len(self.straggler_steps)}


class TransientError(Exception):
    """Injectable transient failure (tests raise this from fault_hook)."""
