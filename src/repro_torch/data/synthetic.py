"""Deterministic synthetic batches (the counterpart of
``repro/data/synthetic.py``).

* ``MarkovLM`` -- a sparse first-order Markov chain over the vocabulary with
  a known stationary entropy, so loss curves are meaningful and the
  achievable floor is computable.  Its successor table and transition
  probabilities come from ``np.random.default_rng(seed)`` exactly as in the
  reference, so they are bit-identical.  ``lm_batch`` (causal LM) and
  ``masked_lm_batch`` (BERT-style MLM) sample it.
* ``vision_batch`` -- class-conditional Gaussian patch patterns for DeiT.
* ``stub_frontend_inputs`` -- the VLM's image embeddings and the audio
  encoder's frames: ones, as the reference's launchers feed its stub
  frontends.

Sampling draws from a ``torch.Generator`` (``torch.multinomial``,
``torch.rand``, ``torch.randn``): the same distributions as the reference's
``jax.random`` draws, not the same bits.  Batches are a pure function of
(seed, step, shard), so any process can regenerate any batch.
"""
from __future__ import annotations

import dataclasses
import functools
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


def masked_lm_batch(chain: MarkovLM, seed: int, step: int, batch: int, seq: int,
                    mask_id: int, mask_rate: float = 0.15, shard: int = 0,
                    device=None) -> Dict[str, torch.Tensor]:
    """BERT-style MLM batch on ``device``: each position is replaced by
    ``mask_id`` with probability ``mask_rate``; labels hold the original
    token there and -1 elsewhere."""
    gen = batch_generator(seed, step, shard, default_device(device))
    toks = chain.sample(gen, batch, seq)[:, :seq]
    mask = torch.rand(toks.shape, generator=gen, device=gen.device) < mask_rate
    return {"tokens": torch.where(mask, mask_id, toks),
            "labels": torch.where(mask, toks, -1)}


@functools.lru_cache(maxsize=1)
def _prototypes(seed: int, n_classes: int, n_patches: int, patch_dim: int,
                device: torch.device) -> torch.Tensor:
    """The class prototypes: a pure function of the arguments, drawn once.
    One set is kept (DeiT-B's is 1000 x 196 x 768 f32, 602 MB); callers
    only read it."""
    gen = torch.Generator(device=device).manual_seed(seed + 77)
    return torch.randn((n_classes, n_patches, patch_dim), generator=gen,
                       device=device) * 0.5


def vision_batch(seed: int, step: int, batch: int, n_patches: int, patch_dim: int,
                 n_classes: int, shard: int = 0, device=None) -> Dict[str, torch.Tensor]:
    """Class-conditional Gaussian patch patterns on ``device``: uniform
    labels, each image its class prototype (fixed across steps for one
    seed, scale 0.5) plus unit noise."""
    dev = default_device(device)
    protos = _prototypes(seed, n_classes, n_patches, patch_dim, dev)
    gen = batch_generator(seed, step, shard, dev)
    labels = torch.randint(0, n_classes, (batch,), generator=gen, device=dev)
    noise = torch.randn((batch, n_patches, patch_dim), generator=gen, device=dev)
    return {"patches": protos[labels] + noise, "labels": labels}


def stub_frontend_inputs(cfg, batch: int, device) -> Dict[str, torch.Tensor]:
    """The stub frontends' inputs of ``batch`` rows: ``img_embeds`` [batch,
    n_image_tokens, vision_dim] for the VLM family, ``enc_frames`` [batch,
    encoder_seq, d_model] for the audio one, ones in the compute dtype (none
    for other families).  No pixels or audio are read: the frontends are
    stubs in the reference too."""
    if cfg.family == "vlm":
        shape = (batch, cfg.n_image_tokens, cfg.vision_dim or cfg.d_model)
        return {"img_embeds": torch.ones(shape, dtype=cfg.compute_dtype, device=device)}
    if cfg.family == "audio":
        shape = (batch, cfg.encoder_seq, cfg.d_model)
        return {"enc_frames": torch.ones(shape, dtype=cfg.compute_dtype, device=device)}
    return {}
