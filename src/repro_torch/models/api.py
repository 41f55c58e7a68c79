"""Public model facade + the serving step factories (the counterpart of
``repro/models/api.py``: ``Model``, ``build_model``, ``make_prefill_step``,
``make_paged_decode_step``).  Steps run under ``torch.inference_mode()``."""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels import dispatch as kdispatch
from repro_torch.models import lm as lm_lib
from repro_torch.param import init_tree


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


def build_model(cfg: ModelConfig) -> Model:
    if cfg.kernel_backend:
        # fail fast on a typo'd backend instead of at the first attention call
        kdispatch.validate_backend(cfg.kernel_backend)
    if cfg.family == "vit":
        raise NotImplementedError(f"{cfg.name}: the ViT family is not ported")
    lm_lib.check_supported(cfg)
    return Model(cfg)


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
