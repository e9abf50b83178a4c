"""Training launcher — counterpart of `repro.launch.train`:

    python -m repro_torch.launch.train --arch olmo-1b [--smoke] [--device cpu]

Trains any arch (the transformer families, rwkv6, zamba2) on the
synthetic Markov-chain LM stream with AdamW through the fault-tolerant
`runtime.Trainer`:
checkpoints every ``--ckpt-every`` steps and at the end, ``--resume``
picks up the newest restorable one, ``--grad-compression`` runs the int8
error-feedback compression.  ``--smoke`` takes the reduced config,
``--n-layers`` cuts the depth and keeps the published widths.  Runs on the
GPU unless ``--device cpu`` is given (a missing GPU raises), with TF32 off
so f32 matmuls are exact.
"""
from __future__ import annotations

import argparse
import dataclasses
import tempfile
from pathlib import Path

import torch

from ..configs import ARCHS, get_config, get_smoke
from ..data import DataConfig, SyntheticLMData
from ..device import resolve_device
from ..models import build_model
from ..optim import AdamWConfig
from ..runtime import Trainer, TrainerConfig
from ..tree import leaves


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCHS, default="olmo-1b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir",
                    default=str(Path(tempfile.gettempdir())
                                / "repro_torch_train"))
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut the depth to this many layers (default: the "
                         "config's); the widths stay as published")
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a GPU) or cpu")
    return ap


def config(args: argparse.Namespace):
    """The model config the arguments name, depth cut to ``--n-layers``."""
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    if args.n_layers is not None:
        if not 0 < args.n_layers <= cfg.n_layers:
            raise ValueError(f"--n-layers must be in [1, {cfg.n_layers}]")
        cfg = dataclasses.replace(cfg, n_layers=args.n_layers)
    return cfg


def build_trainer(args: argparse.Namespace) -> Trainer:
    """The model (seed-0 params), the data stream and the trainer the
    arguments name, on the device they name."""
    device = resolve_device(args.device)
    # exact f32 matmuls and convolutions in the backward as in the forward
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = config(args)
    bundle = build_model(cfg, device)
    params = bundle.init(0)
    n_params = sum(p.numel() for p in leaves(params))
    print(f"[train] arch={cfg.name} layers={cfg.n_layers} "
          f"params={n_params / 1e6:.2f}M steps={args.steps} on {device}")
    data = SyntheticLMData(DataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=args.seq,
                                      global_batch=args.batch),
                           device=device)
    return Trainer(
        loss_fn=bundle.train_loss, params=params, data=data,
        opt_cfg=AdamWConfig(lr=args.lr, warmup_steps=20,
                            total_steps=args.steps),
        cfg=TrainerConfig(total_steps=args.steps,
                          checkpoint_every=args.ckpt_every,
                          checkpoint_dir=args.ckpt_dir,
                          grad_compression=args.grad_compression))


def run(args: argparse.Namespace, trainer: Trainer | None = None) -> dict:
    """Resume if asked, train to ``--steps``, print the log; returns the
    trainer's result."""
    trainer = trainer or build_trainer(args)
    if args.resume and trainer.resume():
        print(f"[train] resumed from step {trainer.step}")
    result = trainer.run()
    for m in trainer.metrics_log:
        print(f"  step {m['step']:5d}  loss {m['loss']:.4f}  "
              f"lr {m['lr']:.2e}  {m['step_time_s'] * 1e3:.0f}ms")
    print(f"[train] {result}")
    return result


def main(argv=None) -> dict:
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
