"""Stage-based LM for training, prefill and decode (the counterpart of
``repro/models/lm.py``): causal ``attn`` blocks (GQA, or DeepSeek-V3's MLA
with ``attn_type="mla"``), the encoders' bidirectional ``enc_attn`` blocks,
the recurrent ``mamba``, ``mlstm`` and ``slstm`` mixers (Jamba mixes them
with attention), and the cross-attention blocks: Llama-3.2-Vision's gated
``cross_attn`` image layers and Whisper's ``dec_attn`` decoder layers (causal
self-attention, then cross-attention to the output of an ``enc_attn``
encoder stack, ``cfg.n_encoder_layers`` deep, which runs in train and
prefill and whose K/V decode reads from the cache); each with a dense, MoE
or no FFN.  MoE blocks add their load-balancing
loss to an ``aux`` total that the forward returns and ``lm_loss`` charges at
``router_aux_coef``.  With ``mtp_depth`` the train forward also runs
DeepSeek-V3's multi-token-prediction head (one unstacked attention + dense
block predicting token t + 2), which ``lm_loss`` charges at
``mtp_loss_weight``.

Parameters are stacked per stage-pattern position with a leading "layers"
axis, as in the reference; ``run_stages`` walks that axis in a Python loop.

In the FSDP train step (``distributed/fsdp.py``, per-layer gathers) each
process holds its data block of every leaf: ``_train_layer`` gathers a
block's leaves inside its checkpointed function, so a remat backward
re-gathers them, and ``lm_forward`` gathers the leaves outside the stacks
once where it starts.  A prefill in ``fsdp_ctx`` (the dry run's, on the
training layout) gathers each layer's leaves before it runs.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.config import BlockSpec, ModelConfig, Stage
from repro_torch.distributed import fsdp
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.distributed.sharding import cache_seq_ways
from repro_torch.layers import attention as attn
from repro_torch.layers import ffn as ffn_lib
from repro_torch.layers import ssm
from repro_torch.layers.basic import (embed_specs, embed_tokens, norm_apply, norm_specs,
                                      unembed, wide_dtype)
from repro_torch.param import Spec, tree_map

RECURRENT_MIXERS = tuple(ssm.MIXERS)  # mamba, mlstm, slstm
CROSS_MIXERS = ("cross_attn", "dec_attn")  # blocks that read a cross source
SUPPORTED_MIXERS = ("attn", "enc_attn") + CROSS_MIXERS + RECURRENT_MIXERS
SUPPORTED_FFNS = ("dense", "moe", "none")
SUPPORTED_ATTN = ("gqa", "mla")
SUPPORTED_REMAT = ("none", "full", "dots")
MTP_BLOCK = BlockSpec("attn", "dense")  # the MTP head's one block


def _stack(tree, n: int):
    return tree_map(lambda s: Spec((n,) + s.shape, ("layers",) + s.axes, ("-",) + s.roles,
                                   init=s.init, scale=s.scale, dtype=s.dtype), tree)


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for configs whose blocks the port lacks."""
    if cfg.attn_type not in SUPPORTED_ATTN:
        raise NotImplementedError(f"{cfg.name}: attn_type {cfg.attn_type!r} is not "
                                  f"ported {SUPPORTED_ATTN}")
    for st in cfg.stages:
        for bs in st.pattern:
            if bs.mixer not in SUPPORTED_MIXERS or bs.ffn not in SUPPORTED_FFNS:
                raise NotImplementedError(
                    f"{cfg.name}: block {bs.tag!r} is not ported (mixers "
                    f"{SUPPORTED_MIXERS}, ffns {SUPPORTED_FFNS})")
    if cfg.remat not in SUPPORTED_REMAT:
        raise NotImplementedError(f"{cfg.name}: remat {cfg.remat!r} is not ported "
                                  f"{SUPPORTED_REMAT}")


def block_specs(cfg: ModelConfig, bs: BlockSpec) -> Dict[str, Any]:
    """An attention block (causal, bidirectional, or a decoder block with
    cross-attention to the encoder), a gated image layer, or a recurrent
    block, with a dense, MoE or no FFN (``check_supported`` admits no
    other)."""
    s: Dict[str, Any] = {"norm1": norm_specs(cfg)}
    if bs.mixer in RECURRENT_MIXERS:
        s["mixer"] = ssm.MIXERS[bs.mixer][0](cfg)
    elif bs.mixer == "cross_attn":
        s["mixer"] = attn.cross_attn_specs(cfg, kv_axis="vision_embed",
                                           kv_dim=cfg.vision_dim or cfg.d_model)
    else:
        s["mixer"] = attn.mla_specs(cfg) if cfg.attn_type == "mla" else attn.gqa_specs(cfg)
        if bs.mixer == "dec_attn":
            s["norm_x"] = norm_specs(cfg)
            s["cross"] = attn.cross_attn_specs(cfg, kv_axis="embed")
    if bs.ffn != "none":
        s["norm2"] = norm_specs(cfg)
        s["ffn"] = ffn_lib.moe_specs(cfg) if bs.ffn == "moe" else ffn_lib.ffn_specs(cfg)
    return s


@functools.lru_cache(maxsize=64)
def _layer_layout(cfg: ModelConfig, bs: BlockSpec, mesh):
    """``fsdp.layout`` of one layer's specs on ``mesh``, for its per-layer
    gather: computed once per (config, block kind, mesh), not at every
    layer, microbatch and recompute."""
    return fsdp.layout(block_specs(cfg, bs), mesh)


@functools.lru_cache(maxsize=16)
def _outside_layout(cfg: ModelConfig, mesh):
    """``fsdp.layout`` of the leaves outside the stacks, gathered once a
    forward."""
    return fsdp.outside_stacks(fsdp.layout(lm_specs(cfg), mesh))


def block_cache_specs(cfg: ModelConfig, bs: BlockSpec, batch: int, max_seq: int,
                      n_cross_tokens: int = 0) -> Dict[str, Any]:
    """Dense decode-cache layout of one block: self-attention K/V (MLA: the
    latent and rope strips), the projected cross-attention K/V of
    ``n_cross_tokens`` source tokens, or a recurrent mixer's state (no
    sequence axis)."""
    if bs.mixer in RECURRENT_MIXERS:
        return {"ssm": ssm.MIXERS[bs.mixer][1](cfg, batch)}
    if bs.mixer not in ("attn",) + CROSS_MIXERS:
        raise NotImplementedError(
            f"decode caches support mixers 'attn', {CROSS_MIXERS} and {RECURRENT_MIXERS} "
            f"only, got {bs.mixer!r}")
    c: Dict[str, Any] = {}
    if bs.mixer != "cross_attn":
        c["self"] = (attn.mla_cache_specs(cfg, batch, max_seq) if cfg.attn_type == "mla"
                     else attn.gqa_cache_specs(cfg, batch, max_seq))
    if bs.mixer in CROSS_MIXERS:
        c["cross"] = attn.cross_kv_cache_specs(cfg, batch, n_cross_tokens)
    return c


def paged_block_cache_specs(cfg: ModelConfig, bs: BlockSpec, n_pages: int,
                            page_size: int) -> Dict[str, Any]:
    """Block-table layout for the serving page pool.  Only self-attention
    blocks page: a recurrent state is O(1) (nothing to page) and cross K/V
    belong to the request, so those families serve on the slots engine."""
    if bs.mixer != "attn":
        raise NotImplementedError(
            f"paged KV serving supports mixer 'attn' only, got {bs.mixer!r} "
            "(use --engine slots)")
    return {"self": (attn.mla_paged_cache_specs(cfg, n_pages, page_size)
                     if cfg.attn_type == "mla"
                     else attn.gqa_paged_cache_specs(cfg, n_pages, page_size))}


# ---------------------------------------------------------------------------
# per-block apply


def block_apply(
    p: Dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    bs: BlockSpec,
    *,
    positions: torch.Tensor,
    mode: str,  # train | prefill | decode
    cache: Optional[Dict] = None,  # decode: this layer's caches
    block_tables: Optional[torch.Tensor] = None,  # [B,M]: decode cache is paged, else dense
    cross_src: Optional[torch.Tensor] = None,  # [B,T,E]: image embeds or encoder output
) -> Tuple[torch.Tensor, Optional[Dict], torch.Tensor]:
    """Returns (x, cache, moe_aux): the cache is None in train mode, the
    fresh K/V (cross K/V projected from ``cross_src``) or recurrent state in
    prefill mode, the caches updated in place in decode mode (cross K/V are
    only read); moe_aux is the block's f32 load-balancing loss, or the float
    0.0 without an MoE FFN (no device op on that path)."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r} (train, prefill, decode)")
    decode = mode == "decode"
    h = norm_apply(p["norm1"], x, cfg)
    new_cache = None
    fresh: Dict = {}  # a prefill's cross K/V, projected once by the attention
    kv_out = fresh if mode == "prefill" else None
    if bs.mixer == "cross_attn":  # the VLM's gated image layer
        y = attn.cross_attn_apply(p["mixer"], h, cfg, kv_src=cross_src,
                                  kv_cache=cache["cross"] if decode else None, gated=True,
                                  kv_out=kv_out)
        if decode:
            new_cache = cache
        elif mode == "prefill":
            new_cache = {"cross": fresh}
    elif bs.mixer in RECURRENT_MIXERS:
        y, state = ssm.MIXERS[bs.mixer][2](p["mixer"], h, cfg,
                                           cache=cache["ssm"] if decode else None,
                                           return_state=mode == "prefill")
        if decode:  # advance the dense caches' state one token, in place
            for key, v in state.items():
                cache["ssm"][key].copy_(v)
            new_cache = cache
        elif mode == "prefill":
            new_cache = {"ssm": state}
    else:
        apply = attn.mla_apply if cfg.attn_type == "mla" else attn.gqa_apply
        y, c_new = apply(p["mixer"], h, cfg, positions=positions,
                         causal=bs.mixer != "enc_attn",
                         cache=cache["self"] if decode else None,
                         block_tables=block_tables, fill_cache=mode == "prefill")
        if mode != "train":
            new_cache = {"self": c_new if decode else _prefill_self_cache(c_new, cfg)}
        if bs.mixer == "dec_attn":  # then attend to the encoder's output
            x = x + y
            y = attn.cross_attn_apply(p["cross"], norm_apply(p["norm_x"], x, cfg), cfg,
                                      kv_src=cross_src,
                                      kv_cache=cache["cross"] if decode else None, gated=False,
                                      kv_out=kv_out)
            if decode:
                new_cache["cross"] = cache["cross"]
            elif mode == "prefill":
                new_cache["cross"] = fresh
    x = x + y
    if bs.ffn == "none":
        return x, new_cache, 0.0
    h = norm_apply(p["norm2"], x, cfg)
    if bs.ffn == "moe":
        y, aux = ffn_lib.moe_apply(p["ffn"], h, cfg)
    else:
        y, aux = ffn_lib.ffn_apply(p["ffn"], h, cfg), 0.0
    return x + y, new_cache, aux


def _prefill_self_cache(c: Dict, cfg: ModelConfig) -> Dict:
    """The decode cache a prefill leaves: the K/V (MLA: the latent and rope
    strips) its attention computed, as the reference's, whose compiled
    prefill computes the projections once.  Under the ``"cache_seq"`` rule
    (``sharding.cache_seq_ways``) each process keeps its chunk of the
    sequence, every K/V head of it (the local heads gathered whole where
    ``kv_heads`` split)."""
    if cfg.attn_type != "mla" and cache_seq_ways() > 1 and \
            tp.is_split(c["k"].shape[2], cfg.n_kv_heads):
        whole = tp.all_gather_cat(torch.stack([c["k"], c["v"]]), dim=3)
        c = {"k": whole[0], "v": whole[1]}
    return _seq_chunk(c)


def _seq_chunk(cache: Dict) -> Dict:
    """This process's chunk of the sequence (axis 1) of each prefill cache
    leaf under the ``"cache_seq"`` rule; the leaves as they are without it,
    or where the sequence does not split (the rule's drop)."""
    ways = cache_seq_ways()
    S = next(iter(cache.values())).shape[1]
    if ways == 1 or S % ways:
        return cache
    c = S // ways
    off = tp.model_rank() * c
    return {k: v[:, off:off + c].contiguous() for k, v in cache.items()}


# ---------------------------------------------------------------------------
# whole-model specs


def encoder_stages(cfg: ModelConfig) -> Tuple[Stage, ...]:
    """The encoder stack of an encoder-decoder config: ``n_encoder_layers``
    bidirectional blocks with dense FFNs (none without an encoder)."""
    if not cfg.n_encoder_layers:
        return ()
    return (Stage((BlockSpec("enc_attn", "dense"),), cfg.n_encoder_layers),)


def _stages_specs(cfg: ModelConfig, stages: Tuple[Stage, ...]) -> Dict[str, Any]:
    return {f"stage_{i}": {f"b{j}": _stack(block_specs(cfg, bsj), st.repeats)
                           for j, bsj in enumerate(st.pattern)}
            for i, st in enumerate(stages)}


def lm_specs(cfg: ModelConfig) -> Dict[str, Any]:
    check_supported(cfg)
    s: Dict[str, Any] = {
        "embed": embed_specs(cfg),
        "stages": _stages_specs(cfg, cfg.stages),
        "final_norm": norm_specs(cfg),
    }
    if cfg.n_encoder_layers:
        s["encoder"] = {"stages": _stages_specs(cfg, encoder_stages(cfg)),
                        "final_norm": norm_specs(cfg)}
    if cfg.mtp_depth:
        s["mtp"] = {
            "proj": Spec((2 * cfg.d_model, cfg.d_model), ("embed_cat2", "embed"), ("in", "out"),
                         init="fan_in"),
            "norm_h": norm_specs(cfg),
            "norm_e": norm_specs(cfg),
            "block": block_specs(cfg, MTP_BLOCK),
            "final_norm": norm_specs(cfg),
        }
    return s


def cache_specs(cfg: ModelConfig, batch: int, max_seq: int) -> Dict[str, Any]:
    """Whole-model dense decode caches, ``[layers, batch, max_seq, ...]``
    per stacked layer leaf (the slots engine); cross K/V span the image
    tokens or the encoder's frames."""
    n_cross = cfg.n_image_tokens or cfg.encoder_seq
    return {
        f"stage_{i}": {
            f"b{j}": _stack(block_cache_specs(cfg, bsj, batch, max_seq, n_cross), st.repeats)
            for j, bsj in enumerate(st.pattern)
        }
        for i, st in enumerate(cfg.stages)
    }


def paged_cache_specs(cfg: ModelConfig, n_pages: int, page_size: int) -> Dict[str, Any]:
    """Whole-model page-pool specs: one ``[n_pages, page_size, ...]`` pool per
    stacked layer leaf, shared across requests via per-request block tables.
    The speculative policy sizes its draft pool from the coalesced config
    this way."""
    return {
        f"stage_{i}": {
            f"b{j}": _stack(paged_block_cache_specs(cfg, bsj, n_pages, page_size),
                            st.repeats)
            for j, bsj in enumerate(st.pattern)
        }
        for i, st in enumerate(cfg.stages)
    }


# ---------------------------------------------------------------------------
# forward


# remat="dots" saves the outputs of the matrix products without a batch
# dimension (the reference's ``dots_with_no_batch_dims_saveable``): ``mm`` and
# ``addmm``, which ``@`` and ``F.linear`` fold into, and a ``bmm`` of batch 1,
# which is how ``torch.einsum`` folds a contraction without batch dimensions
# ("bsd,de->bse").  Everything else is recomputed in the backward: a ``bmm``
# over a real batch dimension (attention scores on the plain route, the MoE
# expert einsum over ``e``), the elementwise ops, and the flash kernels, whose
# launch is no aten op.
DOTS_SAVED_OPS = ("aten.mm.default", "aten.addmm.default", "aten.bmm.default[batch 1]")
_MM_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    if op in _MM_OPS or (op is torch.ops.aten.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    return create_selective_checkpoint_contexts(_dots_policy)


def _train_layer(p_l: Dict, x: torch.Tensor, cfg: ModelConfig, bs: BlockSpec,
                 positions: torch.Tensor,
                 cross_src: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One block in train mode, under ``cfg.remat``: "none" keeps its
    activations; "full" recomputes the block in the backward (the
    reference's ``jax.checkpoint`` of the scan body), so the flash forward
    runs twice per layer per step; "dots" recomputes it too but keeps the
    products of ``DOTS_SAVED_OPS`` (selective checkpointing).  Returns (x,
    moe_aux): the checkpointed function returns both, so the load-balancing
    gradient reaches the router through the recomputation.  ``cross_src`` is
    an input of the checkpointed function, as ``x`` is: the encoder's
    gradients arrive through it from every decoder layer.  A recurrent
    mixer's per-chunk checkpoints (``layers/ssm.py``) nest inside.  Under
    per-layer FSDP the block's data blocks are gathered first, inside the
    checkpointed function."""
    def fn(x, cross_src):
        mesh = fsdp.per_layer()
        p = fsdp.gather_tree(p_l, _layer_layout(cfg, bs, mesh), mesh) if mesh else p_l
        x, _, aux = block_apply(p, x, cfg, bs, positions=positions, mode="train",
                                cross_src=cross_src)
        return x, aux

    if cfg.remat not in SUPPORTED_REMAT:
        raise NotImplementedError(f"remat {cfg.remat!r} is not ported {SUPPORTED_REMAT}")
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn(x, cross_src)
    if cfg.remat == "dots":
        return checkpoint(fn, x, cross_src, use_reentrant=False, context_fn=_dots_context)
    return checkpoint(fn, x, cross_src, use_reentrant=False)


def run_stages(
    params: Dict,
    stages: Tuple[Stage, ...],
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,
    mode: str,
    caches: Optional[Dict] = None,  # decode: page pools or dense caches (written in place)
    block_tables: Optional[torch.Tensor] = None,  # [B,M] with page pools, else None
    cross_src: Optional[torch.Tensor] = None,  # [B,T,E] for the cross-attention blocks
) -> Tuple[torch.Tensor, Optional[Dict], torch.Tensor]:
    """Walk each stage's stacked ``layers`` axis.  Returns (x, caches,
    moe_aux summed over the layers: 0.0 without MoE blocks).  Train returns
    no caches; prefill returns fresh caches stacked like the parameters
    ([layers, B, S, ...]); decode returns the cache tree it was given (page
    pools, or dense ``[layers, B, max_seq, ...]`` caches), updated in
    place."""
    new_caches: Dict[str, Any] = {}
    aux_total = 0.0
    for i, st in enumerate(stages):
        p_st = params[f"stage_{i}"]
        c_st = caches[f"stage_{i}"] if mode == "decode" else None
        # unbind once per stage: its backward stacks the layers' gradients
        # in one pass (indexing per layer would scatter into a full-size
        # zero tensor per layer)
        p_layers = {f"b{j}": tree_map(lambda a: a.unbind(0), p_st[f"b{j}"])
                    for j in range(len(st.pattern))}
        per_layer: Dict[str, list] = {f"b{j}": [] for j in range(len(st.pattern))}
        for r in range(st.repeats):
            for j, bsj in enumerate(st.pattern):
                name = f"b{j}"
                p_l = tree_map(lambda a: a[r], p_layers[name])
                if mode == "train":
                    x, aux = _train_layer(p_l, x, cfg, bsj, positions, cross_src)
                    aux_total = aux_total + aux
                    continue
                c_l = tree_map(lambda a: a[r], c_st[name]) if c_st is not None else None
                mesh = fsdp.per_layer()
                if mesh is not None:  # an FSDP prefill: the layer's data blocks, gathered
                    p_l = fsdp.gather_tree(p_l, _layer_layout(cfg, bsj, mesh), mesh)
                x, c_new, aux = block_apply(p_l, x, cfg, bsj, positions=positions, mode=mode,
                                            cache=c_l, block_tables=block_tables,
                                            cross_src=cross_src)
                aux_total = aux_total + aux
                per_layer[name].append(c_new)
        if mode == "decode":
            new_caches[f"stage_{i}"] = c_st
        elif mode == "prefill":
            new_caches[f"stage_{i}"] = {
                name: tree_map(lambda *ls: torch.stack(ls), *cs)
                for name, cs in per_layer.items()}
    return x, (new_caches if mode != "train" else None), aux_total


def lm_forward(
    params: Dict,
    tokens: torch.Tensor,  # [B,S] int
    cfg: ModelConfig,
    *,
    positions: Optional[torch.Tensor] = None,  # [B,S]; default arange
    mode: str = "train",
    caches: Optional[Dict] = None,
    # [B,M]: decode caches are paged (None: dense).  S==1 is batched decode;
    # S>1 with explicit positions is a multi-token paged step, prefix extend
    # or speculative verify (positions == -1 mark padding: writes land on
    # the null page, attention is masked)
    block_tables: Optional[torch.Tensor] = None,
    img_embeds: Optional[torch.Tensor] = None,  # [B,N,vision_dim]: the VLM's stub frontend
    enc_frames: Optional[torch.Tensor] = None,  # [B,T,E]: the audio stub frontend
    enc_out: Optional[torch.Tensor] = None,  # [B,T,E]: a precomputed encoder output
    vocab_split: bool = False,
) -> Dict[str, Any]:
    """Logits (and caches, MoE aux, MTP logits) of ``tokens``.  An
    encoder-decoder config runs its encoder on ``enc_frames`` in train and
    prefill (unless ``enc_out`` is given), and returns its output as
    ``enc_out``; decode reads the cross K/V from the caches instead.  The
    VLM's image layers attend to ``img_embeds`` (train, prefill).

    ``vocab_split=True`` (the training and eval loss) keeps the logits and
    MTP logits as this process's block of vocabulary columns where the head
    is split over "model" (``layers/basic.py::unembed``); ``vocab_axes``
    names the axes they are split over (``()``: whole), which ``lm_loss``
    takes.  By default they are whole on every process."""
    B, S = tokens.shape
    if positions is None:
        positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    mesh = fsdp.per_layer()
    if mesh is not None:
        params = fsdp.gather_tree(params, _outside_layout(cfg, mesh), mesh)
    x = embed_tokens(params["embed"], tokens, cfg)
    cross_src = None if img_embeds is None else img_embeds.to(cfg.compute_dtype)
    if cfg.n_encoder_layers and mode != "decode":
        if enc_out is None:
            if enc_frames is None:
                raise ValueError(f"{cfg.name}: an encoder-decoder needs enc_frames or enc_out")
            e = enc_frames.to(cfg.compute_dtype)
            T = e.shape[1]
            e_pos = torch.arange(T, device=e.device)[None].expand(B, T)
            e, _, _ = run_stages(params["encoder"]["stages"], encoder_stages(cfg), e, cfg,
                                 positions=e_pos, mode="train")
            enc_out = norm_apply(params["encoder"]["final_norm"], e, cfg)
        cross_src = enc_out
    x, new_caches, aux = run_stages(params["stages"], cfg.stages, x, cfg,
                                    positions=positions, mode=mode, caches=caches,
                                    block_tables=block_tables, cross_src=cross_src)
    x = norm_apply(params["final_norm"], x, cfg)
    logits, vocab_axes = unembed(params["embed"], x, cfg, vocab_split=vocab_split)
    out = {"logits": logits, "vocab_axes": vocab_axes, "aux": aux, "caches": new_caches,
           "enc_out": enc_out}
    if cfg.mtp_depth and mode == "train":
        # DeepSeek-V3's multi-token prediction: one extra block predicting
        # t + 2 from [h_t ; emb(token_{t+1})] (the last position wraps to
        # token 0, as the reference's roll does; its label is -1).  Not
        # under remat, as in the reference.
        mp = params["mtp"]
        emb_next = embed_tokens(params["embed"], torch.roll(tokens, -1, dims=1), cfg)
        hcat = torch.cat([norm_apply(mp["norm_h"], x, cfg),
                          norm_apply(mp["norm_e"], emb_next, cfg)], dim=-1)
        h2 = hcat @ mp["proj"].to(cfg.compute_dtype)
        h2, _, _ = block_apply(mp["block"], h2, cfg, MTP_BLOCK, positions=positions,
                               mode="train")
        h2 = norm_apply(mp["final_norm"], h2, cfg)
        out["mtp_logits"], _ = unembed(params["embed"], h2, cfg, vocab_split=vocab_split)
    return out


# ---------------------------------------------------------------------------
# losses


def _ce(logits: torch.Tensor, labels: torch.Tensor, z_loss: float,
        axes: Tuple[str, ...] = ()) -> torch.Tensor:
    lg = logits.to(wide_dtype(logits.dtype))
    if not axes:
        lse = torch.logsumexp(lg, dim=-1)
        ll = torch.gather(lg, -1, labels.clamp_min(0).unsqueeze(-1)).squeeze(-1)
    else:  # this process's block of vocabulary columns
        v = lg.shape[-1]
        mx = tp.all_reduce_max(lg.detach().amax(dim=-1), axes)  # a constant for autograd
        t = labels.clamp_min(0) - tp.block_index(axes) * v
        inside = (t >= 0) & (t < v)
        ll = torch.gather(lg, -1, t.clamp(0, v - 1).unsqueeze(-1)).squeeze(-1)
        ll = torch.where(inside, ll, torch.zeros((), dtype=ll.dtype, device=ll.device))
        se = torch.exp(lg - mx.unsqueeze(-1)).sum(dim=-1)
        se, ll = tp.all_reduce_sum(torch.stack([se, ll]), axes).unbind(0)
        lse = mx + torch.log(se)
    mask = (labels >= 0).to(lg.dtype)
    nll = (lse - ll) * mask
    if z_loss:
        nll = nll + z_loss * lse.square() * mask
    # in the FSDP step the count is the global batch's over the processes,
    # so their losses average to the global mean
    count = fsdp.batch_mean(mask.sum())
    return nll.sum() / count.clamp_min(1.0 / fsdp.batch_ways())


def lm_loss(logits: torch.Tensor,  # [B,S,V]
            labels: torch.Tensor,  # [B,S] int, -1 = ignore
            cfg: ModelConfig,
            aux=0.0,  # the forward's summed MoE load-balancing loss
            mtp_logits: Optional[torch.Tensor] = None,
            mtp_labels: Optional[torch.Tensor] = None,
            z_loss: float = 0.0,
            vocab_axes: Tuple[str, ...] = ()) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean next-token cross-entropy in f32 (f64 for f64 logits) over the
    labels that are not -1, plus ``mtp_loss_weight * mtp_ce`` (metric
    ``mtp_ce``) where MTP logits and labels are given, plus ``router_aux_coef
    * aux`` (metric ``moe_aux``) for MoE models: the reference's ``lm_loss``.

    The logsumexp runs over every column of the padded vocabulary, the
    padding columns included, as in the reference; the label's logit is a
    gather, where the reference contracts with a one-hot (the same value).

    ``vocab_axes`` (``lm_forward(vocab_split=True)``'s) names the mesh axes
    the logits' last dimension is split over: each process then holds its
    block of columns, as the reference's loss keeps its ``act_vocab``
    sharding.  The row max is reduced with a max over those axes (a
    constant for autograd), the block's ``sum(exp(x - max))`` and the
    label's logit (zero on every block but the label's) with one sum, and
    ``lse = max + log(sum)``: the same loss on every process, whose
    gradient w.r.t. the block is the block of the whole gradient."""
    loss = _ce(logits, labels, z_loss, vocab_axes)
    metrics = {"ce": loss}
    if mtp_logits is not None and mtp_labels is not None:
        mtp = _ce(mtp_logits, mtp_labels, z_loss, vocab_axes)
        loss = loss + cfg.mtp_loss_weight * mtp
        metrics["mtp_ce"] = mtp
    if cfg.n_experts:
        loss = loss + cfg.router_aux_coef * aux
        metrics["moe_aux"] = aux
    metrics["loss"] = loss
    return loss, metrics
