"""Calibration data pipeline (PTQ regime: small, unlabeled, deterministic).

numpy only, and token for token the JAX package's loader.

The paper uses ~8K unlabeled images (0.7% of ImageNet).  For LLM QFT the
analogue is a few thousand unlabeled token sequences.  This pipeline:

- sources: synthetic (self-teaching: any token stream works since the FP
  teacher provides the target) or a binary token file (memory-mapped);
- deterministic, *seekable* iteration: ``skip_to(step)`` supports elastic
  restarts without repeating or dropping samples;
- epochs-over-small-set semantics (paper trains 12 epochs over the calib set);
- per-host sharding for multi-host DP (host h of H reads rows h::H).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass
class CalibConfig:
    n_samples: int = 8192            # paper's working point
    seq_len: int = 512
    batch_size: int = 16             # paper's batch size
    vocab: int = 32000
    seed: int = 0
    token_file: str | None = None    # optional memory-mapped .npy of tokens
    host_index: int = 0
    host_count: int = 1


class CalibDataset:
    """Deterministic epoch-shuffled loader over a fixed calibration set."""

    def __init__(self, cfg: CalibConfig):
        self.cfg = cfg
        if cfg.token_file:
            arr = np.load(cfg.token_file, mmap_mode="r")
            n = min(cfg.n_samples, arr.shape[0])
            self.tokens = np.asarray(arr[:n, : cfg.seq_len])
        else:
            rng = np.random.default_rng(cfg.seed)
            # synthetic markov-ish stream: enough structure for the teacher's
            # activations to be non-degenerate
            base = rng.integers(0, cfg.vocab, (cfg.n_samples, cfg.seq_len))
            drift = np.cumsum(rng.integers(0, 7, base.shape), axis=1)
            self.tokens = ((base + drift) % cfg.vocab).astype(np.int32)
        # host shard
        self.tokens = self.tokens[cfg.host_index:: cfg.host_count]
        self._step = 0

    @property
    def steps_per_epoch(self) -> int:
        return max(len(self.tokens) // self.cfg.batch_size, 1)

    def skip_to(self, step: int) -> None:
        """Elastic-restart support: resume mid-epoch without replays."""
        self._step = step

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        cfg = self.cfg
        spe = self.steps_per_epoch
        epoch, within = divmod(self._step, spe)
        rng = np.random.default_rng(cfg.seed + 1000 + epoch)
        perm = rng.permutation(len(self.tokens))
        idx = perm[within * cfg.batch_size:(within + 1) * cfg.batch_size]
        self._step += 1
        return {"tokens": self.tokens[idx]}
