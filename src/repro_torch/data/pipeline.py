"""Deterministic, restartable data pipeline (a copy of the reference's
`data/pipeline.py`, numpy only; its batches are bitwise equal to the
reference's).

SEDAR determinism contract: the batch for step s is a pure function of
(seed, s) — independent of wall clock, host, or restart count — so (a) both
replicas always see identical inputs, and (b) a rollback to step s replays
exactly the batches the failed execution saw (required for the paper's
"re-execution manifests the same fault" semantics AND for recovery to
converge to the fault-free trajectory).

Pipeline state is therefore just the step counter. Two sources:

  * SyntheticLM: splitmix64-hashed tokens — zero I/O, used by tests/benches.
  * MemmapCorpus: windows into a binary uint16/uint32 token file via
    np.memmap, window offsets hashed from (seed, step, slot).

Both emit {"tokens": (B, S), "targets": (B, S)} as numpy arrays; the
trainer uploads them to its device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np


def _splitmix64(x: np.ndarray) -> np.ndarray:
    x = (x + np.uint64(0x9E3779B97F4A7C15)).astype(np.uint64)
    z = x
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


@dataclass
class SyntheticLM:
    vocab_size: int
    global_batch: int
    seq_len: int
    seed: int = 0
    frontend_seq: int = 0
    frontend_dim: int = 0

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        B, S = self.global_batch, self.seq_len
        base = np.uint64(self.seed) * np.uint64(0x1000003) + np.uint64(step)
        idx = np.arange(B * (S + 1), dtype=np.uint64) + base * np.uint64(B * (S + 1))
        toks = (_splitmix64(idx) % np.uint64(self.vocab_size)).astype(np.int32)
        toks = toks.reshape(B, S + 1)
        out = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
        if self.frontend_seq:
            n = B * self.frontend_seq * self.frontend_dim
            fidx = np.arange(n, dtype=np.uint64) + (base + np.uint64(7)) * np.uint64(n)
            emb = (_splitmix64(fidx).astype(np.float64) / 2**64 - 0.5).astype(np.float32)
            out["frontend_embeds"] = 0.1 * emb.reshape(B, self.frontend_seq,
                                                       self.frontend_dim)
        return out

    # checkpointable state == step (the runtime stores it inside TrainState)
    def state(self, step: int) -> dict:
        return {"seed": self.seed, "step": step}


@dataclass
class MemmapCorpus:
    path: str
    vocab_size: int
    global_batch: int
    seq_len: int
    seed: int = 0
    dtype: str = "uint16"

    def __post_init__(self):
        self._data = np.memmap(self.path, dtype=self.dtype, mode="r")
        self._n = len(self._data) - (self.seq_len + 1)
        if self._n <= 0:
            raise ValueError("corpus shorter than seq_len")

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        B, S = self.global_batch, self.seq_len
        slot = np.arange(B, dtype=np.uint64)
        h = _splitmix64(slot + np.uint64(step) * np.uint64(B)
                        + np.uint64(self.seed) * np.uint64(0x9E3779B1))
        offs = (h % np.uint64(self._n)).astype(np.int64)
        toks = np.stack([np.asarray(self._data[o:o + S + 1], np.int32)
                         for o in offs])
        toks = np.clip(toks, 0, self.vocab_size - 1)
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}

    def state(self, step: int) -> dict:
        return {"seed": self.seed, "step": step, "path": self.path}


def make_pipeline(model_cfg, global_batch: int, seq_len: int, seed: int = 0,
                  corpus: Optional[str] = None):
    fe_seq = model_cfg.frontend_seq if model_cfg.frontend else 0
    fe_dim = model_cfg.frontend_dim if model_cfg.frontend else 0
    if corpus:
        return MemmapCorpus(corpus, model_cfg.vocab_size, global_batch,
                            seq_len, seed)
    return SyntheticLM(model_cfg.vocab_size, global_batch, seq_len, seed,
                       fe_seq, fe_dim)
