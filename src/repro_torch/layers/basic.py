"""Norms, activations, RoPE, embeddings (the counterpart of
``repro/layers/basic.py``, with its f32 upcasts in the same places).

On a "model" axis the token table and the output head hold a block of
vocabulary rows (``distributed/tensor_parallel.py``): the lookup sums the
processes' masked rows.  The serving steps gather the logits whole, so
every process takes the same argmax over the same columns; the training
loss keeps each process's block of columns (``unembed(vocab_split=True)``)
and meets the others in a max and a sum a row, never a gather of the
logits.  A tied table gets its local rows' gradient from both: the
lookup's masked rows and the logits' block."""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.param import Spec


def act_fn(name: str):
    # jax.nn.gelu defaults to the tanh approximation
    return {"silu": F.silu, "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "relu": F.relu}[name]


# ---------------------------------------------------------------------------
# norms


def norm_specs(cfg: ModelConfig, axis: str = "embed", dim: int = 0) -> Dict[str, Spec]:
    d = dim or cfg.d_model
    out = {"scale": Spec((d,), (axis,), ("out",), init="ones")}
    if cfg.norm == "layernorm":
        out["bias"] = Spec((d,), (axis,), ("out",), init="zeros")
    return out


def wide_dtype(dt: torch.dtype) -> torch.dtype:
    """The dtype of the reference's f32 islands (norms, recurrent states, the
    loss) for compute dtype ``dt``: f32, or ``dt`` itself where it is wider
    (f64, which the reference never runs)."""
    return torch.promote_types(dt, torch.float32)


def norm_apply(p: Dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    dt = x.dtype
    wt = wide_dtype(dt)
    xf = x.to(wt)
    if cfg.norm == "layernorm":
        mu = xf.mean(dim=-1, keepdim=True)
        var = (xf - mu).square().mean(dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
        y = y * p["scale"].to(wt) + p["bias"].to(wt)
    else:
        var = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + cfg.norm_eps) * p["scale"].to(wt)
    return y.to(dt)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    wt = wide_dtype(dt)
    xf = x.to(wt)
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.to(wt)).to(dt)


# ---------------------------------------------------------------------------
# RoPE


def rope_freqs(dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                         device=device) / dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., S, H, D] (D even), positions broadcastable to [..., S]."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)  # [D/2]
    ang = positions[..., None].float() * freqs  # [..., S, D/2]
    cos = torch.cos(ang)[..., None, :]  # [..., S, 1, D/2]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# embeddings


def embed_specs(cfg: ModelConfig) -> Dict[str, Spec]:
    out = {"tok": Spec((cfg.padded_vocab, cfg.d_model), ("vocab", "embed"), ("-", "out"),
                       init="embed")}
    if not cfg.tie_embeddings:
        out["head"] = Spec((cfg.d_model, cfg.padded_vocab), ("embed", "vocab"), ("in", "-"),
                           init="fan_in")
    return out


def embed_tokens(p: Dict, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    # gather, then cast: the same values as casting the table first, without
    # converting all of it per call
    return tp.vocab_embedding(p["tok"], tokens, cfg.padded_vocab).to(cfg.compute_dtype)


def unembed(p: Dict, x: torch.Tensor, cfg: ModelConfig, *,
            vocab_split: bool = False) -> Tuple[torch.Tensor, Tuple[str, ...]]:
    """(logits, axes): the logits of ``x`` and the mesh axes their last
    dimension is split over, ``()`` when it is whole.

    Where the head (or the tied ``tok`` table) holds a block of vocabulary
    columns over "model", each process computes its block.  By default the
    blocks are gathered whole (``[.., V]``, what the serving steps' argmax
    and a distillation loss read); ``vocab_split=True`` keeps this process's
    block (``[.., V/M]``, the training loss: ``models/lm.py::lm_loss`` takes
    the axes), so no logits are gathered."""
    w = p["tok"].t() if cfg.tie_embeddings else p["head"]
    axes = tp.MODEL if tp.is_split(w.shape[-1], cfg.padded_vocab) else ()
    if axes:  # the replicated stream enters the local vocabulary columns
        x = tp.enter_split(x, axes)
    logits = x @ w.to(cfg.compute_dtype)
    if axes and not vocab_split:
        return tp.all_gather_cat(logits, dim=-1, axes=axes), ()
    return logits, axes


def pos_embed_specs(max_seq: int, cfg: ModelConfig, axis: str = "seq") -> Dict[str, Spec]:
    """A learned absolute position table ``[max_seq, d_model]`` (the
    reference's; no model of either package builds it)."""
    return {"pos": Spec((max_seq, cfg.d_model), (axis, "embed"), ("-", "out"), init="normal",
                        scale=0.02)}
