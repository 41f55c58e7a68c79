"""Public model facade + step builders (the counterpart of
``repro/models/api.py``: ``Model``, ``build_model``, ``make_train_step``,
``make_eval_loss``, ``init_train_state``, ``make_prefill_step``,
``make_paged_decode_step``).

The serving steps run under ``torch.inference_mode()``; the train step runs
with autograd on and updates the parameters and optimizer state in place.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch

from repro_torch.config import ModelConfig, TrainConfig
from repro_torch.kernels import dispatch as kdispatch
from repro_torch.models import lm as lm_lib
from repro_torch.optim import adamw_init, adamw_update
from repro_torch.param import flatten, init_tree, unflatten


@dataclasses.dataclass
class Model:
    cfg: ModelConfig

    def specs(self):
        return lm_lib.lm_specs(self.cfg)

    def paged_cache_specs(self, n_pages: int, page_size: int):
        return lm_lib.paged_cache_specs(self.cfg, n_pages, page_size)

    def init(self, gen: torch.Generator):
        """Random parameters on ``gen.device``, drawn from ``gen``."""
        return init_tree(gen, self.specs(), dtype=self.cfg.param_dtype)

    def loss(self, params, batch: Dict[str, torch.Tensor], z_loss: float = 0.0):
        """(loss, metrics) of a ``{"tokens", "labels"}`` batch."""
        out = lm_lib.lm_forward(params, batch["tokens"], self.cfg, mode="train")
        return lm_lib.lm_loss(out["logits"], batch["labels"], self.cfg, z_loss)

    def forward_logits(self, params, batch) -> torch.Tensor:
        return lm_lib.lm_forward(params, batch["tokens"], self.cfg, mode="train")["logits"]


def build_model(cfg: ModelConfig) -> Model:
    if cfg.kernel_backend:
        # fail fast on a typo'd backend instead of at the first attention call
        kdispatch.validate_backend(cfg.kernel_backend)
    if cfg.family == "vit":
        raise NotImplementedError(f"{cfg.name}: the ViT family is not ported")
    lm_lib.check_supported(cfg)
    return Model(cfg)


# ---------------------------------------------------------------------------
# step builders


def make_train_step(model: Model, tc: TrainConfig) -> Callable:
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics); ``params`` and ``opt_state`` are updated in place and returned.

    The batch moves to the parameters' device.  With ``tc.grad_accum > 1``
    the batch leaves carry a leading microbatch axis of size grad_accum; the
    step loops over it and averages gradients (f32) and metrics.  Metrics
    are device scalars except ``lr`` (a float).
    """

    def grads_of(leaves, params, micro):
        with torch.enable_grad():
            loss, metrics = model.loss(params, micro, z_loss=tc.z_loss)
            grads = torch.autograd.grad(loss, leaves)
        return list(grads), {k: v.detach() for k, v in metrics.items()}

    def train_step(params, opt_state, batch):
        leaves = list(flatten(params).values())
        for p in leaves:
            p.requires_grad_(True)
        dev = leaves[0].device
        batch = {k: v.to(dev) for k, v in batch.items()}
        if tc.grad_accum > 1:
            grads, metrics = grads_of(leaves, params, {k: v[0] for k, v in batch.items()})
            grads = [g.float() for g in grads]
            for i in range(1, tc.grad_accum):
                g_i, m_i = grads_of(leaves, params, {k: v[i] for k, v in batch.items()})
                grads = [a + b.float() for a, b in zip(grads, g_i)]
                metrics = {k: metrics[k] + m_i[k] for k in metrics}
            inv = 1.0 / tc.grad_accum
            grads = [g * inv for g in grads]
            metrics = {k: m * inv for k, m in metrics.items()}
        else:
            grads, metrics = grads_of(leaves, params, batch)
        grad_tree = unflatten(dict(zip(flatten(params).keys(), grads)))
        params, opt_state, om = adamw_update(params, grad_tree, opt_state, tc)
        return params, opt_state, {**metrics, **om}

    return train_step


def make_eval_loss(model: Model) -> Callable:
    """eval_loss(params, batch) -> metrics, without autograd."""

    @torch.no_grad()
    def eval_loss(params, batch):
        _, metrics = model.loss(params, batch)
        return metrics

    return eval_loss


def init_train_state(model: Model, tc: TrainConfig, gen: torch.Generator):
    """(params, opt_state): parameters drawn from ``gen`` on its device and
    zero AdamW moments."""
    params = model.init(gen)
    return params, adamw_init(params, tc)


def make_prefill_step(model: Model) -> Callable:
    """prefill_step(params, tokens [B,S]) -> (last_logits [B,V], caches)."""
    cfg = model.cfg

    @torch.inference_mode()
    def prefill_step(params, tokens):
        out = lm_lib.lm_forward(params, tokens, cfg, mode="prefill")
        return out["logits"][:, -1, :], out["caches"]

    return prefill_step


def make_paged_decode_step(model: Model) -> Callable:
    """step(params, pages, tokens [B,S], positions [B,S], block_tables [B,M])
    -> (last_logits [B,V], pages).

    Decode/extend against the shared page pool, which is updated IN PLACE
    and returned.  S==1 is the batched decode step; S>1 is the prefix-reuse
    "extend" step (left-padded rows carry positions == -1, which
    ``paged_write`` routes to the reserved null page).
    """
    cfg = model.cfg

    @torch.inference_mode()
    def paged_decode_step(params, pages, tokens, positions, block_tables):
        out = lm_lib.lm_forward(params, tokens, cfg, positions=positions,
                                mode="decode", caches=pages,
                                block_tables=block_tables)
        return out["logits"][:, -1, :], out["caches"]

    return paged_decode_step
