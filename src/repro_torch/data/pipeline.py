"""Synthetic data pipeline with checkpointable iterator state —
counterpart of `repro.data.pipeline`.

Batches are generated by NumPy from ``(seed, step)``, byte for byte as the
reference generates them, so (a) the iterator state is one integer,
checkpointable and exactly resumable, and (b) a host generates only its
shard (the generator is indexed by global example id, not by host).  Only
the finished batch goes to the stream's device.

The LM stream follows a skip-gram-ish Markov chain, so a model trained on
it has learnable structure; the image stream is one low-frequency
prototype per class plus noise.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from ..device import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0


class SyntheticLMData:
    """Deterministic Markov-chain LM token stream; batches are
    ``{"tokens": int32 [B, S]}`` on ``device`` (None: the GPU)."""

    def __init__(self, cfg: DataConfig, *, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        rng = np.random.default_rng(cfg.seed)
        # each token prefers a small set of successors
        v = cfg.vocab_size
        self._succ = rng.integers(0, v, size=(v, 4))
        self.step = 0                      # checkpointable iterator state

    def state_dict(self) -> dict:
        return {"step": self.step, "seed": self.cfg.seed}

    def load_state_dict(self, state: dict):
        if state["seed"] != self.cfg.seed:
            raise ValueError(f"data seed mismatch on resume: checkpoint "
                             f"{state['seed']}, stream {self.cfg.seed}")
        self.step = int(state["step"])

    def batch_at(self, step: int, *, host_id: int = 0, n_hosts: int = 1
                 ) -> dict:
        """Generate (the host's shard of) the batch for ``step``."""
        cfg = self.cfg
        if cfg.global_batch % n_hosts:
            raise ValueError(f"global batch {cfg.global_batch} does not "
                             f"split over {n_hosts} hosts")
        per_host = cfg.global_batch // n_hosts
        out = np.empty((per_host, cfg.seq_len), np.int32)
        for i in range(per_host):
            ex_id = step * cfg.global_batch + host_id * per_host + i
            r = np.random.default_rng((cfg.seed, ex_id))
            toks = np.empty(cfg.seq_len, np.int32)
            toks[0] = r.integers(cfg.vocab_size)
            choices = r.integers(0, 4, size=cfg.seq_len)
            noise = r.random(cfg.seq_len) < 0.1
            rand_toks = r.integers(0, cfg.vocab_size, size=cfg.seq_len)
            for t in range(1, cfg.seq_len):
                toks[t] = (rand_toks[t] if noise[t]
                           else self._succ[toks[t - 1], choices[t]])
            out[i] = toks
        return {"tokens": torch.from_numpy(out).to(self.device)}

    def __iter__(self) -> Iterator[dict]:
        while True:
            b = self.batch_at(self.step)
            self.step += 1
            yield b


class SyntheticImageData:
    """Synthetic labeled images for the CNN prune -> retrain example:
    ``{"image": f32 NHWC [B, img, img, 3], "label": int32 [B]}`` on
    ``device`` (None: the GPU).  Class k's images are a k-dependent
    low-frequency pattern plus noise, so a small CNN reaches high accuracy
    quickly."""

    def __init__(self, *, img: int = 32, n_classes: int = 10,
                 batch: int = 64, seed: int = 0, device=None):
        self.img, self.n_classes, self.batch, self.seed = (
            img, n_classes, batch, seed)
        self.device = resolve_device(device)
        xs = np.linspace(0, 2 * np.pi, img)
        self._protos = np.stack([
            np.sin((k % 4 + 1) * xs)[:, None] * np.cos((k // 4 + 1) * xs)[None, :]
            for k in range(n_classes)])[..., None] * np.ones(3)
        self.step = 0

    def state_dict(self):
        return {"step": self.step, "seed": self.seed}

    def load_state_dict(self, state):
        self.step = int(state["step"])

    def batch_at(self, step: int) -> dict:
        r = np.random.default_rng((self.seed, step))
        labels = r.integers(0, self.n_classes, size=self.batch)
        imgs = (self._protos[labels]
                + 0.35 * r.standard_normal(
                    (self.batch, self.img, self.img, 3)))
        return {"image": torch.from_numpy(imgs.astype(np.float32)).to(
                    self.device),
                "label": torch.from_numpy(labels.astype(np.int32)).to(
                    self.device)}

    def __iter__(self):
        while True:
            b = self.batch_at(self.step)
            self.step += 1
            yield b
