"""Training data pipeline (a copy of ``repro.data.pipeline``: the port
imports nothing of ``repro``).

Deterministic synthetic corpus (Zipf-distributed token stream with
document structure) packed into fixed-length sequences with next-token
labels. Batches are numpy arrays, equal to the reference's for the same
``PipelineConfig``; the train step moves them to its device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np

from repro_torch.data.tokenizer import BOS, EOS


@dataclasses.dataclass
class PipelineConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    doc_len_mean: int = 512
    zipf_a: float = 1.2


class TokenPipeline:
    """Infinite iterator of {tokens, labels} numpy batches."""

    def __init__(self, cfg: PipelineConfig):
        self.cfg = cfg
        self._rng = np.random.default_rng(cfg.seed)
        self._buf = np.empty((0,), np.int32)
        self.n_tokens_emitted = 0

    def _sample_doc(self) -> np.ndarray:
        cfg = self.cfg
        n = max(8, int(self._rng.exponential(cfg.doc_len_mean)))
        # Zipf over the model vocab (clipped), shifted past specials
        toks = self._rng.zipf(cfg.zipf_a, size=n)
        toks = np.clip(toks + 2, 3, cfg.vocab - 1).astype(np.int32)
        return np.concatenate([[BOS], toks, [EOS]]).astype(np.int32)

    def _fill(self, need: int) -> None:
        chunks = [self._buf]
        have = len(self._buf)
        while have < need:
            doc = self._sample_doc()
            chunks.append(doc)
            have += len(doc)
        self._buf = np.concatenate(chunks)

    def next_batch(self) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        need = cfg.global_batch * (cfg.seq_len + 1)
        self._fill(need)
        flat, self._buf = self._buf[:need], self._buf[need:]
        arr = flat.reshape(cfg.global_batch, cfg.seq_len + 1)
        self.n_tokens_emitted += need
        return {"tokens": arr[:, :-1].copy(), "labels": arr[:, 1:].copy()}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next_batch()
