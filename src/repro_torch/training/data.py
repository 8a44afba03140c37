"""Synthetic LM data (port of ``repro/training/data.py``, numpy only).

Deterministic, seeded, learnable structure: a Markov chain over the vocab
with Zipf-distributed unigram marginals, so "loss decreases over a few
dozen steps" is a meaningful check rather than noise-fitting. The same
draws from the same generator as the reference: for one seed the batches,
frames included, equal the reference's byte for byte. Batches stream as
host numpy; the train loop moves them to the model's device.
"""

from __future__ import annotations

import numpy as np


class SyntheticLMData:
    def __init__(self, vocab: int, seq_len: int, batch: int, seed: int = 0,
                 frames_dim: int = 0, frames_len: int = 0):
        self.vocab = vocab
        self.seq_len = seq_len
        self.batch = batch
        self.frames_dim = frames_dim
        self.frames_len = frames_len
        rng = np.random.default_rng(seed)
        v_eff = min(vocab, 4096)            # transition table stays small
        self.v_eff = v_eff
        # Zipf marginal + sparse per-state transition kernels.
        marg = 1.0 / np.arange(1, v_eff + 1) ** 1.1
        self.marg = marg / marg.sum()
        self.n_succ = 8
        self.succ = rng.integers(0, v_eff, size=(v_eff, self.n_succ))
        self.rng = rng

    def _sample_tokens(self, n: int) -> np.ndarray:
        rng = self.rng
        out = np.empty((n, self.seq_len), np.int32)
        state = rng.choice(self.v_eff, size=n, p=self.marg)
        for t in range(self.seq_len):
            out[:, t] = state
            # 80%: follow the chain; 20%: resample from the marginal.
            follow = rng.random(n) < 0.8
            nxt = self.succ[state, rng.integers(0, self.n_succ, n)]
            resample = rng.choice(self.v_eff, size=n, p=self.marg)
            state = np.where(follow, nxt, resample)
        return out

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        tokens = self._sample_tokens(self.batch)
        batch = {"tokens": tokens}
        if self.frames_dim:
            batch["frames"] = self.rng.standard_normal(
                (self.batch, self.frames_len, self.frames_dim),
                dtype=np.float32)
        return batch
