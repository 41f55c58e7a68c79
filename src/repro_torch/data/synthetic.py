"""Deterministic synthetic language-model batches (the counterpart of the LM
part of ``repro/data/synthetic.py``).

``MarkovLM`` is a sparse first-order Markov chain over the vocabulary with a
known stationary entropy, so loss curves are meaningful and the achievable
floor is computable.  Its successor table and transition probabilities come
from ``np.random.default_rng(seed)`` exactly as in the reference, so they
are bit-identical.  Sampling draws from a ``torch.Generator`` with
``torch.multinomial``: the same distribution as the reference's
``jax.random.categorical``, not the same bits.  Batches are a pure function
of (seed, step, shard), so any process can regenerate any batch.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.device import default_device


@dataclasses.dataclass
class MarkovLM:
    """Sparse Markov chain: each token has ``branch`` likely successors."""

    vocab: int
    branch: int = 4
    seed: int = 1234

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        succ = rng.integers(0, self.vocab, size=(self.vocab, self.branch))
        logits = rng.normal(size=(self.vocab, self.branch)) * 1.0
        probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
        self.succ = succ.astype(np.int32)
        self.probs = probs.astype(np.float32)
        self._tables: Dict[torch.device, tuple] = {}

    def entropy(self) -> float:
        p = self.probs
        return float(-(p * np.log(p)).sum(-1).mean())

    def _on(self, device: torch.device):
        if device not in self._tables:
            self._tables[device] = (torch.from_numpy(self.succ).long().to(device),
                                    torch.from_numpy(self.probs).to(device))
        return self._tables[device]

    def sample(self, gen: torch.Generator, batch: int, seq: int) -> torch.Tensor:
        """[batch, seq + 1] token ids on ``gen.device``: a uniform first
        token, then ``seq`` transitions."""
        succ, probs = self._on(gen.device)
        tok = torch.randint(0, self.vocab, (batch,), generator=gen, device=gen.device)
        toks = [tok]
        for _ in range(seq):
            choice = torch.multinomial(probs[tok], 1, generator=gen)[:, 0]
            tok = succ[tok, choice]
            toks.append(tok)
        return torch.stack(toks, 1)


def chain_entropy(vocab: int, branch: int = 4, seed: int = 1234) -> float:
    return MarkovLM(vocab, branch, seed).entropy()


def batch_generator(seed: int, step: int, shard: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from (seed, step, shard) only."""
    s = int(np.random.SeedSequence([seed, step, shard]).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(s)


def lm_batch(chain: MarkovLM, seed: int, step: int, batch: int, seq: int,
             shard: int = 0, device=None) -> Dict[str, torch.Tensor]:
    """Causal LM batch: tokens + next-token labels, int64, on ``device``
    (the CUDA card unless given; raises when there is neither)."""
    toks = chain.sample(batch_generator(seed, step, shard, default_device(device)),
                        batch, seq)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
