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

The step runs eagerly: ``loss_fn(params, batch)`` under autograd over
``grad_accum`` microbatches (`grad_step`), the optional error-feedback
compression, then `optim.adamw_update`.

On a live mesh (``mesh=``, with the params' ``specs``) the step is the
live twin of the reference's dry-run ``train_step``: the params, the
gradients and the AdamW moments are this rank's blocks by ``specs``, the
loss is a rank's share (`models.transformer._build_live`), the gradients
are summed over the axes each leaf is replicated on, and AdamW updates
the blocks with the mesh's global norm.  A trainer on a mesh takes no
checkpoint (``checkpoint_every`` 0: a sharded checkpoint is not ported)
and no gradient compression.
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
from ..distributed import sharding as shd
from ..optim import (AdamWConfig, adamw_init, adamw_update, apply_masks,
                     value_and_grad)
from ..tree import leaves, tree_map


def _default_dir() -> str:
    return str(Path(tempfile.gettempdir()) / "repro_torch_ckpt")


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    checkpoint_every: int = 50         # 0 = no checkpoints
    checkpoint_dir: str = dataclasses.field(default_factory=_default_dir)
    step_deadline_s: float = 0.0       # 0 = no deadline
    max_retries: int = 2
    log_every: int = 10
    grad_compression: bool = False
    grad_accum: int = 1                # microbatches per step


def grad_step(loss_fn: Callable, params, batch: dict, *, accum: int = 1,
              mesh=None, specs=None) -> tuple:
    """``(loss, grads)`` of one train step, as the reference's dry-run
    ``train_step`` takes them (reference launch/dryrun.py:184-198): with
    ``accum`` > 1 the batch is cut into ``accum`` microbatches of
    consecutive rows, each one's gradients summed in float32, and the
    sum and the loss divided by ``accum``.  On a live ``mesh`` each rank
    holds its share of the loss and the gradients of its blocks (laid
    out by ``specs``): the gradients are summed over the axes each leaf
    is replicated on (`distributed.sharding.reduce_replicated`) and the
    loss over every rank in rank order, so every rank returns the global
    loss and the blocks of the global gradients."""
    if accum == 1:
        loss, grads = value_and_grad(loss_fn, params, batch)
    else:
        grads, loss = None, 0.0
        for i in range(accum):
            mb = {k: v.reshape(accum, v.shape[0] // accum,
                               *v.shape[1:])[i] for k, v in batch.items()}
            mloss, g = value_and_grad(loss_fn, params, mb)
            g = tree_map(lambda x: x.float(), g)
            grads = g if grads is None else tree_map(torch.add, grads, g)
            loss = loss + mloss
        grads = tree_map(lambda g: g / accum, grads)
        loss = loss / accum
    if mesh is not None:
        grads = shd.reduce_replicated(grads, mesh, specs)
        loss = shd.sum_in_order(loss, mesh, mesh.axis_names)
    return loss, grads


class Trainer:
    def __init__(self, *, loss_fn: Callable, params, data,
                 opt_cfg: AdamWConfig | None = None,
                 cfg: TrainerConfig | None = None, masks=None, mesh=None,
                 specs=None):
        self.cfg = cfg or TrainerConfig()
        if mesh is not None and (self.cfg.checkpoint_every
                                 or self.cfg.grad_compression):
            raise ValueError("a trainer on a live mesh takes no checkpoint "
                             "(checkpoint_every must be 0) and no gradient "
                             "compression: neither is ported to the mesh")
        self.mesh, self.specs = mesh, specs
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
                                       every=self.cfg.checkpoint_every) \
            if self.cfg.checkpoint_every else None
        self._residuals = compress.zero_residuals(params) \
            if self.cfg.grad_compression else None
        self._sigterm = False

    def _on_sigterm(self, *_):
        self._sigterm = True

    def _train_step(self, params, opt_state, residuals, batch):
        loss, grads = grad_step(self.loss_fn, params, batch,
                                accum=self.cfg.grad_accum, mesh=self.mesh,
                                specs=self.specs)
        if residuals is not None:
            grads, residuals = compress.compress_tree(grads, residuals)
        params, opt_state, metrics = adamw_update(
            self.opt_cfg, params, grads, opt_state, mesh=self.mesh,
            specs=self.specs)
        metrics["grad_bytes"] = sum(g.numel() * g.element_size()
                                    for g in leaves(grads))
        if self.masks is not None:
            params = apply_masks(params, self.masks)
        return params, opt_state, residuals, loss, metrics

    # -- state (de)hydration ------------------------------------------------
    def _state(self):
        return {"params": self.params, "opt": self.opt_state}

    def resume(self) -> bool:
        if self._ckpt is None:
            return False
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
        if self._ckpt is None:
            return False
        extra = {}
        if hasattr(self.data, "state_dict"):
            extra["data_state"] = self.data.state_dict()
        return self._ckpt.maybe_save(self.step, self._state(), extra=extra,
                                     force=force)

    # -- main loop -----------------------------------------------------------
    def run(self, *, fault_hook: Callable[[int], None] | None = None,
            on_step: Callable[[int], None] | None = None) -> dict:
        """Run to ``total_steps``.  ``fault_hook(step)`` may raise
        `TransientError` to simulate a transient failure: the step retries
        from the last good state.  ``on_step(step)``, where given, is
        called after each step with the number of steps taken, once the
        step is logged and before its checkpoint.  SIGTERM is bound to
        the preemption flag while the run lasts (from the main thread) and
        the earlier handler is restored when it ends."""
        previous = signal.getsignal(signal.SIGTERM)
        try:
            signal.signal(signal.SIGTERM, self._on_sigterm)
            bound = True
        except ValueError:
            bound = False            # not the main thread
        try:
            return self._run(fault_hook, on_step)
        finally:
            if bound:
                signal.signal(signal.SIGTERM, previous
                              if previous is not None else signal.SIG_DFL)

    def _run(self, fault_hook, on_step) -> dict:
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
                    "lr": float(metrics["lr"]), "step_time_s": dt,
                    "grad_bytes": metrics["grad_bytes"]})
            if on_step is not None:
                on_step(self.step)
            self._save()
        self._save(force=True)
        return {"status": "done", "step": self.step,
                "final_loss": self.metrics_log[-1]["loss"]
                if self.metrics_log else None,
                "stragglers": len(self.straggler_steps)}


class TransientError(Exception):
    """Injectable transient failure (tests raise this from fault_hook)."""
