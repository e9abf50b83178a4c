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

On a live mesh (``mesh=``, with the params' ``specs``) the trainer is
the reference's `Trainer` on sharded arrays, every rank running it
together: the params, the gradients, the AdamW moments and the
compression's residuals are this rank's blocks by ``specs``; the loss is
a rank's share (the live bundles' ``train_loss``, every family), the
gradients are summed over the axes each leaf is replicated on, then
compressed as the whole leaves would be (`distributed.compress`), and
AdamW updates the blocks with the mesh's global norm.  A checkpoint is
each rank's blocks (`checkpoint.store`: a replicated block written
once), restored onto any mesh; resume continues each rank's rows of the
step-indexed stream.  Preemption is agreed at every step boundary (one
``all_reduce`` of the ranks' flags), so SIGTERM or ``preempted`` on one
rank stops every rank at the same step, which they checkpoint together.
A transient failure (``fault_hook``) must hit every rank alike.  As the
reference's `_state` (params and optimizer state), a checkpoint holds no
error-feedback residuals: a resumed compressed run starts them from
zero.
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


def state_specs(specs) -> dict:
    """The specs of a trainer's checkpointed state (``{"params", "opt":
    {"m", "v", "step"}}``) from its params' ``specs``: the moments placed
    as the params, the step count replicated (the reference's
    ``opt_sh``)."""
    return {"params": specs, "opt": {"m": specs, "v": specs,
                                     "step": shd.P()}}


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
        self._ckpt = CheckpointManager(
            self.cfg.checkpoint_dir, every=self.cfg.checkpoint_every,
            mesh=mesh, specs=None if mesh is None else state_specs(specs)) \
            if self.cfg.checkpoint_every else None
        self._residuals = compress.zero_residuals(params) \
            if self.cfg.grad_compression else None
        self._sigterm = False
        self._saved_step = None

    def _on_sigterm(self, *_):
        self._sigterm = True

    def _train_step(self, params, opt_state, residuals, batch):
        loss, grads = grad_step(self.loss_fn, params, batch,
                                accum=self.cfg.grad_accum, mesh=self.mesh,
                                specs=self.specs)
        if residuals is not None:
            grads, residuals = compress.compress_tree(
                grads, residuals, mesh=self.mesh, specs=self.specs)
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
        self.step = self._saved_step = step
        self.params = tree["params"]
        self.opt_state = tree["opt"]
        if extra.get("data_state") and hasattr(self.data, "load_state_dict"):
            self.data.load_state_dict(extra["data_state"])
        return True

    @property
    def checkpoints(self) -> dict:
        """What the checkpoints cost this rank: each save's step, bytes,
        files, seconds (on a mesh also its collectives) and the restore's
        step, bytes and seconds."""
        if self._ckpt is None:
            return {"saves": [], "restored": {}}
        return {"saves": self._ckpt.saves, "restored": self._ckpt.restored}

    def _save(self, force=False):
        if self._ckpt is None or self._saved_step == self.step:
            return False
        extra = {}
        if hasattr(self.data, "state_dict"):
            extra["data_state"] = self.data.state_dict()
        before = shd.COLLECTIVES.snapshot()
        saved = self._ckpt.maybe_save(self.step, self._state(), extra=extra,
                                      force=force)
        if saved:
            self._saved_step = self.step
            if self.mesh is not None:
                self._ckpt.saves[-1]["collectives"] = \
                    shd.COLLECTIVES.since(before)
        return saved

    def _stop(self) -> bool:
        """Whether to stop at this step boundary: SIGTERM or
        ``preempted`` here, on a mesh on any rank (one ``all_reduce`` of
        the flags, so every rank stops at the same step)."""
        stop = self._sigterm or self.preempted
        if self.mesh is None:
            return stop
        flag = torch.tensor([float(stop)])
        return bool(shd.all_reduce(flag, self.mesh,
                                   tuple(self.mesh.axis_names)).item())

    # -- main loop -----------------------------------------------------------
    def run(self, *, fault_hook: Callable[[int], None] | None = None,
            on_step: Callable[[int], None] | None = None) -> dict:
        """Run to ``total_steps``.  ``fault_hook(step)`` may raise
        `TransientError` to simulate a transient failure: the step retries
        from the last good state.  ``on_step(step)``, where given, is
        called after each step with the number of steps taken, once the
        step is logged and checkpointed.  SIGTERM is bound to
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
            if self._stop():
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
            self._save()
            if on_step is not None:
                on_step(self.step)
        self._save(force=True)
        return {"status": "done", "step": self.step,
                "final_loss": self.metrics_log[-1]["loss"]
                if self.metrics_log else None,
                "stragglers": len(self.straggler_steps)}


class TransientError(Exception):
    """Injectable transient failure (tests raise this from fault_hook)."""
