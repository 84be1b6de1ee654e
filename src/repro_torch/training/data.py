"""Deterministic, resumable synthetic data pipeline.

Batches are a pure function of (seed, step), so a restarted job resumes
mid-epoch exactly by restoring the step counter from the checkpoint — no
iterator state files needed. Sequences come from the same Markov chunk
generator the RAG substrate uses, giving the tiny quality-bench models a
learnable local structure.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.serving.rag import KnowledgeBase


@dataclass
class DataConfig:
    seq_len: int = 128
    global_batch: int = 8
    vocab_size: int = 512
    seed: int = 0
    kb_chunks: int = 64


class SyntheticLM:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self.kb = KnowledgeBase(num_chunks=cfg.kb_chunks,
                                vocab_size=cfg.vocab_size, seed=cfg.seed)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.cfg.seed, step))
        toks = np.stack([
            self.kb.sample_sequence(rng, self.cfg.seq_len + 1)
            for _ in range(self.cfg.global_batch)])
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    def iterate(self, start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.batch(step)
            step += 1
