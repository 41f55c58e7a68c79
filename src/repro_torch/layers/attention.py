"""GQA, MLA and cross attention for training, prefill and decode against
dense or paged caches (the counterpart of ``repro/layers/attention.py``).

Two attention computations:
  * ``plain_attention`` -- materialized scores; decode, short sequences, and
                           the paged multi-token steps (prefix extend,
                           speculative verify)
  * the flash op        -- ``kernels/dispatch.py::flash_attention``: the
                           CUDA kernels (forward and backward) on the card,
                           their plain versions on CPU

``run_attention`` keeps the reference's routing thresholds.  Softmax runs in
f32 with compute-dtype matmul inputs.

MLA (DeepSeek-V3) trains and prefills through the flash op with per-head K/V
expanded from the compressed latent (KH = H, query/key head dim nope + rope,
value head dim v), and decodes absorbed: the scores and the context are
taken in the latent space against a cache of latent and rope strips, dense
(``[batch, max_seq, ...]``) or paged, in f32 as the reference computes them.
No paged-decode kernel lies on that path.

On a "model" axis (``distributed/tensor_parallel.py``) a GQA or MLA layer
computes the heads of its local ``wq``/``wq_b`` block, reads the K/V heads
those heads read, and sums its ``wo`` block's partial output over the axis
before the output bias.  Where ``kv_heads`` split with ``heads`` the page
pools hold the local K/V heads; where they stay whole (too few to split)
every process writes all of them and attends with the ones its heads read.
MLA's latent pools have no head axis: every process writes the same
latents.  For the backward, the replicated input enters the split region
through ``tp.enter_split`` (GQA: the layer's input; MLA: its latents, after
the replicated ``q_lora``/``kv_lora`` projections), and so do the
replicated weights that a block of heads reads (``q_norm``/``k_norm``, and
the whole ``wk``/``wv`` beside split heads): each gets the whole gradient
on every process.

A training step whose GQA layer sets ``attn_seq_shard`` and keeps its
heads whole on a "model" axis (Qwen3-14B's 40 and Whisper's 20 heads on
3 processes) splits the query sequence instead (context parallelism,
``_gqa_context_parallel``); where the heads split, the head split is kept.

Inside ``mesh_ctx(dense_serving=True)`` (the dry run's serving cells, the
reference's ``"cache_seq"`` rule) a dense decode cache holds this process's
chunk of the sequence, every K/V head of it; decode attends every head over
the chunk and merges the chunks' partial softmaxes
(``_gqa_decode_seq_split``, ``_mla_decode_seq_split``).

Cross attention (Llama-3.2-Vision's gated image layers, Whisper's decoder)
attends non-causally from the token stream to K/V projected from a fixed
source (image embeddings, the encoder's output); prefill projects them once
into a ``[batch, n_src, KH, D]`` cache that decode reads back.  On a
"model" axis its heads split as GQA's do, the source entering the split
region beside the stream.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.distributed.sharding import cache_seq_ways, context_parallel_ways, shard_l
from repro_torch.kernels import dispatch as kdispatch
from repro_torch.layers.basic import apply_rope, rms_norm
from repro_torch.param import Spec

NEG_INF = -1e30
FLASH_IMPLS = ("blockwise", "pallas", "pairs")  # attn_impl values routed to flash


def paged_write(pages: torch.Tensor, new: torch.Tensor, positions: torch.Tensor,
                block_tables: torch.Tensor) -> torch.Tensor:
    """Scatter ``new`` [B,S,...] into ``pages`` [N,P,...] at absolute
    ``positions`` [B,S] routed through per-sequence ``block_tables`` [B,M].

    Writes IN PLACE and returns ``pages`` (the reference returns an updated
    copy).  Touches only the pages the written tokens land in.  Position -1
    marks a padding slot; its write goes to page 0, the pool's reserved null
    page that no request ever owns.
    """
    P = pages.shape[1]
    valid = positions >= 0
    pos = positions.clamp_min(0)
    page_ix = (pos // P).clamp_max(block_tables.shape[1] - 1)
    pid = torch.gather(block_tables, 1, page_ix)
    pid = torch.where(valid, pid, torch.zeros_like(pid))
    off = torch.where(valid, pos % P, torch.zeros_like(pos))
    pages[pid, off] = new.to(pages.dtype)
    return pages


def seq_masked_write(cache: torch.Tensor, new: torch.Tensor, pos: torch.Tensor,
                     offset: Optional[int] = None) -> torch.Tensor:
    """Write ``new`` [B,1,...] into ``cache`` [B,T,...] at per-example ``pos``
    [B], IN PLACE, and return ``cache``.  With an ``offset`` the cache is
    the chunk of positions ``[offset, offset + T)`` of a sequence-split
    cache: a row writes at ``pos - offset`` where that falls inside, and
    nothing elsewhere (the reference's masked select, which its
    sequence-sharded caches need)."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    val = new[:, 0].to(cache.dtype)
    if offset is None:
        cache[rows, pos] = val
        return cache
    t = pos - offset
    inside = ((t >= 0) & (t < cache.shape[1])).view((-1,) + (1,) * (val.ndim - 1))
    t = t.clamp(0, cache.shape[1] - 1)
    cache[rows, t] = torch.where(inside, val, cache[rows, t])
    return cache


# ---------------------------------------------------------------------------
# core attention computations


def _mask(qp: torch.Tensor, tp: torch.Tensor, causal: bool) -> torch.Tensor:
    """qp: [B,S] query positions, tp: [T] key positions -> [B,S,T] bool."""
    if not causal:
        return torch.ones(qp.shape + (tp.shape[0],), dtype=torch.bool, device=qp.device)
    return tp[None, None, :] <= qp[:, :, None]


def plain_attention(q, k, v, *, causal: bool, scale: float, q_positions=None) -> torch.Tensor:
    """q: [B,S,KH,G,Dq], k: [B,T,KH,Dq], v: [B,T,KH,Dv] -> [B,S,KH,G,Dv]."""
    B, S = q.shape[:2]
    T = k.shape[1]
    s = torch.einsum("bskgd,btkd->bkgst", q.float(), k.float()) * scale
    if q_positions is None:
        q_positions = torch.arange(S, device=q.device)[None].expand(B, S)
    m = _mask(q_positions, torch.arange(T, device=q.device), causal)  # [B,S,T]
    s = s.masked_fill(~m[:, None, None], NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgst,btkv->bskgv", p.to(v.dtype), v)


def _flash_attention(q, k, v, *, causal: bool, scale: float,
                     backend: Optional[str] = None, q_offset: int = 0) -> torch.Tensor:
    """Adapter from the layer layout [B,S,KH,G,D] to the flash op, the
    counterpart of the reference's ``_flash_pallas``.  The op takes the
    [B,S,H,D] layout as it is and reads kv head ``h // G`` itself, so no
    transpose and no GQA broadcast is made here; its backward sums dk/dv
    over the groups."""
    B, S, KH, G, D = q.shape
    out = kdispatch.flash_attention(q.reshape(B, S, KH * G, D), k, v, causal=causal,
                                    scale=scale, config=backend, q_offset=q_offset)
    return out.reshape(B, S, KH, G, -1)


def run_attention(q, k, v, cfg: ModelConfig, *, causal: bool, scale: float,
                  q_positions=None, decode: bool = False, q_offset: int = 0) -> torch.Tensor:
    """``q_offset``: the sequence index of ``q``'s first row among ``k``'s
    (a context-parallel chunk's), which the flash op's causal mask reads;
    the plain route masks by ``q_positions``, which the caller gives to
    match."""
    S, T = q.shape[1], k.shape[1]
    if decode or S <= 128 or T <= cfg.attn_block_k or cfg.attn_impl not in FLASH_IMPLS:
        return plain_attention(q, k, v, causal=causal, scale=scale, q_positions=q_positions)
    # every flash-style impl computes the same function; the kernel takes any
    # S and T (ragged tails masked), so there is no untileable fallback
    return _flash_attention(q, k, v, causal=causal, scale=scale,
                            backend=cfg.kernel_backend or None, q_offset=q_offset)


def chunk_attention(s: torch.Tensor, v: torch.Tensor, pattern: str):
    """(partial out, lse) of f32 scores ``s`` [..., T] (masked entries -inf)
    against a chunk's values: ``out = softmax(s) @ v`` over the chunk
    through ``pattern`` (an einsum of the probabilities and ``v``) and
    ``lse = logsumexp(s)``.  A fully masked chunk gives lse -inf and out 0."""
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse.nan_to_num(neginf=0.0)[..., None])
    return torch.einsum(pattern, p.to(v.dtype), v), lse


def merge_chunks(out: torch.Tensor, lse: torch.Tensor) -> torch.Tensor:
    """The softmax over every chunk from the chunks' partials, merged in
    block order (block 0 first, as the paged-decode merge kernel merges its
    splits): ``out`` [M, ..., Dv] and ``lse`` [M, ...] in f32 -> [..., Dv]."""
    m = lse.amax(dim=0)
    w = torch.exp(lse - m)
    num, den = w[0, ..., None] * out[0], w[0]
    for r in range(1, out.shape[0]):
        num = num + w[r, ..., None] * out[r]
        den = den + w[r]
    return num / den[..., None]


def gather_partials(out: torch.Tensor, lse: torch.Tensor) -> torch.Tensor:
    """Every block's (partial out, lse) over "model" in one all-gather, f32,
    merged: ``out`` [..., Dv], ``lse`` [...] -> [..., Dv] f32."""
    both = torch.cat([out.float(), lse[..., None]], dim=-1)[None]
    both = tp.all_gather_cat(both, dim=0)
    return merge_chunks(both[..., :-1], both[..., -1])


def gather_heads(*xs: torch.Tensor, split: Tuple[bool, ...]) -> Tuple[torch.Tensor, ...]:
    """Each ``[B, S, heads, ...]`` block of ``xs`` whose ``split`` is set,
    whole over "model", in one all-gather (one token a row at decode);
    the others as they are."""
    parts = [x for x, sp in zip(xs, split) if sp]
    if not parts:
        return xs
    B, S = parts[0].shape[:2]
    widths = [math.prod(x.shape[2:]) for x in parts]
    flat = torch.cat([x.reshape(B, S, 1, -1).to(parts[0].dtype) for x in parts], dim=-1)
    got = tp.all_gather_cat(flat, dim=2)  # [B, S, M, sum(widths)]
    n = got.shape[2]
    out, off, i = [], 0, 0
    for x, sp in zip(xs, split):
        if not sp:
            out.append(x)
            continue
        w = widths[i]
        out.append(got[..., off:off + w].reshape(B, S, n * x.shape[2], *x.shape[3:]).to(x.dtype))
        off += w
        i += 1
    return tuple(out)


def local_heads(x: torch.Tensor, h_local: int) -> torch.Tensor:
    """This process's block of ``h_local`` heads of ``x`` [B, S, H, ...]
    (axis 2), or ``x`` when it holds them all."""
    if x.shape[2] == h_local:
        return x
    h0 = tp.model_rank() * h_local
    return x[:, :, h0:h0 + h_local]


# ---------------------------------------------------------------------------
# GQA layer


def gqa_specs(cfg: ModelConfig) -> Dict[str, Spec]:
    E, H, KH, D = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    s = {
        "wq": Spec((E, H, D), ("embed", "heads", "head_dim"), ("in", "out", "-"), init="fan_in"),
        "wk": Spec((E, KH, D), ("embed", "kv_heads", "head_dim"), ("in", "out", "-"), init="fan_in"),
        "wv": Spec((E, KH, D), ("embed", "kv_heads", "head_dim"), ("in", "out", "-"), init="fan_in"),
        "wo": Spec((H, D, E), ("heads", "head_dim", "embed"), ("in", "-", "out"), init="fan_in"),
    }
    if cfg.qk_norm:
        s["q_norm"] = Spec((D,), ("head_dim",), ("-",), init="ones")
        s["k_norm"] = Spec((D,), ("head_dim",), ("-",), init="ones")
    if cfg.use_bias:
        s["bq"] = Spec((H, D), ("heads", "head_dim"), ("out", "-"), init="zeros")
        s["bk"] = Spec((KH, D), ("kv_heads", "head_dim"), ("out", "-"), init="zeros")
        s["bv"] = Spec((KH, D), ("kv_heads", "head_dim"), ("out", "-"), init="zeros")
        s["bo"] = Spec((E,), ("embed",), ("out",), init="zeros")
    return s


def gqa_cache_specs(cfg: ModelConfig, batch: int, max_seq: int) -> Dict[str, Spec]:
    """Dense K/V leaves ``[batch, max_seq, KH, D]``: one row per batch slot
    (the slots engine)."""
    KH, D = cfg.n_kv_heads, cfg.resolved_head_dim
    ax = ("batch", "cache_seq", "cache_kv_heads", "head_dim")
    dt = cfg.compute_dtype
    return {
        "k": Spec((batch, max_seq, KH, D), ax, init="zeros", dtype=dt),
        "v": Spec((batch, max_seq, KH, D), ax, init="zeros", dtype=dt),
    }


def gqa_paged_cache_specs(cfg: ModelConfig, n_pages: int, page_size: int) -> Dict[str, Spec]:
    """Page-pool K/V leaves: ``[n_pages, page_size, KH, D]`` shared across all
    sequences (block tables route each sequence to its pages)."""
    KH, D = cfg.n_kv_heads, cfg.resolved_head_dim
    ax = ("pages", "page_seq", "cache_kv_heads", "head_dim")
    dt = cfg.compute_dtype
    return {
        "k": Spec((n_pages, page_size, KH, D), ax, init="zeros", dtype=dt),
        "v": Spec((n_pages, page_size, KH, D), ax, init="zeros", dtype=dt),
    }


def _paged_gqa_attention(qg, cache_k, cache_v, cfg: ModelConfig, *,
                         positions: torch.Tensor, block_tables: torch.Tensor,
                         scale: float) -> torch.Tensor:
    """qg: [B,S,KH,G,D] against paged K/V [N,P,KH,D] -> [B,S,KH,G,D].

    S == 1 (decode) dispatches to the ``paged_attention_decode`` op; S > 1
    (prefix extend, speculative verify) gathers the table's pages and runs
    the plain masked attention.  Either way work scales with the pages the batch spans.
    """
    B, S = qg.shape[:2]
    P = cache_k.shape[1]
    M = block_tables.shape[1]
    if S == 1:
        lengths = positions[:, -1] + 1  # the just-written token is attendable
        out = kdispatch.dispatch("paged_attention_decode", qg[:, 0], cache_k, cache_v,
                                 block_tables, lengths, scale=scale,
                                 config=cfg.kernel_backend or None)
        return out[:, None]
    k = cache_k[block_tables].reshape(B, M * P, *cache_k.shape[2:])
    v = cache_v[block_tables].reshape(B, M * P, *cache_v.shape[2:])
    return plain_attention(qg, k, v, causal=True, scale=scale, q_positions=positions)


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bse,ehd->bshd") as one matmul."""
    B, S, E = x.shape
    return (x @ w.reshape(E, -1)).view(B, S, *w.shape[1:])


def _out_project(out: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bshd,hde->bse") as one matmul."""
    B, S = out.shape[:2]
    return out.reshape(B, S, -1) @ w.reshape(-1, w.shape[-1])


def _kv_heads_read(h_local: int, kh_local: int, cfg: ModelConfig) -> Tuple[int, int]:
    """``(k0, k1)``: the local K/V heads that this process's block of
    ``h_local`` query heads reads (query head h reads K/V head h // G).
    All of them unless ``heads`` split while ``kv_heads`` stay whole."""
    if not tp.is_split(h_local, cfg.n_heads) or tp.is_split(kh_local, cfg.n_kv_heads):
        return 0, kh_local
    g = cfg.n_heads // cfg.n_kv_heads
    if h_local % g and g % h_local:
        raise NotImplementedError(
            f"{cfg.name}: a block of {h_local} of {cfg.n_heads} query heads straddles "
            f"groups of {g}: the K/V heads it reads are not one block")
    h0 = tp.model_rank() * h_local
    return h0 // g, (h0 + h_local - 1) // g + 1


def _head_block(t: torch.Tensor, k0: int, k1: int) -> torch.Tensor:
    """Heads ``k0:k1`` of ``t`` (axis 2), contiguous for a kernel; ``t``
    itself when that is all of them."""
    if (k0, k1) == (0, t.shape[2]):
        return t
    return t[:, :, k0:k1].contiguous()


def _enter_replicated(p: Dict, names) -> Dict:
    """``p`` with the named leaves (those it has) passed through
    ``tp.enter_split``: replicated weights that a block of heads reads."""
    return {k: tp.enter_split(v) if k in names else v for k, v in p.items()}


def _row_parallel_out(y: torch.Tensor, split: bool, bias: Optional[torch.Tensor]):
    """A row-parallel output: the partial sum completed over "model" when
    the contraction was split, then the bias, once."""
    if split:
        y = tp.all_reduce_sum(y)
    return y if bias is None else y + bias


def gqa_apply(
    p: Dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,  # [B,S] absolute positions (rope + causal mask)
    causal: bool,
    use_rope: bool = True,
    cache: Optional[Dict] = None,
    block_tables: Optional[torch.Tensor] = None,  # [B,M]: cache is paged, else dense
    fill_cache: bool = False,  # no cache: return the fresh K/V (a prefill's)
) -> Tuple[torch.Tensor, Optional[Dict]]:
    B, S, E = x.shape
    # the local heads: a block of ``heads`` (and of ``kv_heads``) on a "model" axis
    H, KH, D = p["wq"].shape[1], p["wk"].shape[1], p["wq"].shape[2]
    k0, k1 = _kv_heads_read(H, KH, cfg)
    split = tp.is_split(H, cfg.n_heads)
    if cfg.attn_seq_shard and cache is None and not split:
        ways = context_parallel_ways(S)
        if ways > 1:
            return _gqa_context_parallel(p, x, cfg, ways, positions=positions,
                                         causal=causal, use_rope=use_rope)
    if split:  # the replicated input and the replicated weights a block of heads reads
        x = tp.enter_split(x)
        p = _enter_replicated(p, ("q_norm", "k_norm") if tp.is_split(KH, cfg.n_kv_heads)
                              else ("q_norm", "k_norm", "wk", "wv", "bk", "bv"))
    cdt = cfg.compute_dtype
    q = _project(x, p["wq"].to(cdt))
    k = _project(x, p["wk"].to(cdt))
    v = _project(x, p["wv"].to(cdt))
    if cfg.use_bias:
        q = q + p["bq"].to(cdt)
        k = k + p["bk"].to(cdt)
        v = v + p["bv"].to(cdt)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    q = shard_l(q, ("batch", "seq", "act_heads", "head_dim"))
    qg = q.reshape(B, S, k1 - k0, H // (k1 - k0), D)
    bo = p["bo"].to(cdt) if cfg.use_bias else None

    if cache is not None and block_tables is not None:
        # paged decode/extend: write the new tokens' K/V into their pages,
        # then attend through the block table
        ck = paged_write(cache["k"], k, positions, block_tables)
        cv = paged_write(cache["v"], v, positions, block_tables)
        out = _paged_gqa_attention(qg, _head_block(ck, k0, k1), _head_block(cv, k0, k1), cfg,
                                   positions=positions, block_tables=block_tables,
                                   scale=D ** -0.5)
        y = _row_parallel_out(_out_project(out, p["wo"].to(cdt)), split, bo)
        return shard_l(y, ("batch", "seq", "act_embed")), {"k": ck, "v": cv}

    new_cache = None
    if cache is not None and cache_seq_ways() > 1:
        return _gqa_decode_seq_split(p, q, k, v, cache, cfg, positions, H, KH, split, bo)
    if cache is not None:
        # dense decode: write the token's K/V at its row's position, then
        # attend over the whole [B, max_seq] cache (position-masked)
        pos0 = positions[:, 0]
        k = seq_masked_write(cache["k"], k, pos0)
        v = seq_masked_write(cache["v"], v, pos0)
        new_cache = {"k": k, "v": v}
    elif fill_cache:
        new_cache = {"k": k, "v": v}
    out = run_attention(qg, _head_block(k, k0, k1), _head_block(v, k0, k1), cfg,
                        causal=causal, scale=D ** -0.5, q_positions=positions,
                        decode=cache is not None)
    y = _row_parallel_out(_out_project(out, p["wo"].to(cdt)), split, bo)
    return shard_l(y, ("batch", "seq", "act_embed")), new_cache


def _gqa_decode_seq_split(p: Dict, q, k, v, cache: Dict, cfg: ModelConfig, positions,
                          H: int, KH: int, split: bool, bo) -> Tuple[torch.Tensor, Dict]:
    """Dense decode on a sequence-split cache (the reference's
    ``"cache_seq"`` rule, flash-decode context parallelism): on "model"
    coordinate c the cache holds positions ``[c Tc, (c+1) Tc)`` of every
    K/V head.  Heads and sequence share the axis, so the token's q (and
    its K/V, where ``kv_heads`` split) are gathered whole first, one token
    a row; the new K/V are written where the position falls in the chunk;
    every query head attends the chunk, giving a partial out and lse; the
    partials are gathered whole and merged in block order; the local
    heads' rows go through the row-parallel ``wo``."""
    B, S = q.shape[:2]
    if S != 1:
        raise ValueError(f"a sequence-split cache decodes one token a row, got {S}")
    cdt = cfg.compute_dtype
    q, k, v = gather_heads(q, k, v, split=(split, tp.is_split(KH, cfg.n_kv_heads),
                                           tp.is_split(KH, cfg.n_kv_heads)))
    Tc = cache["k"].shape[1]
    off = tp.model_rank() * Tc
    ck = seq_masked_write(cache["k"], k, positions[:, 0], offset=off)
    cv = seq_masked_write(cache["v"], v, positions[:, 0], offset=off)
    kh, D = ck.shape[2], q.shape[-1]
    qg = q.reshape(B, S, kh, cfg.n_heads // kh, D)
    s = torch.einsum("bskgd,btkd->bkgst", qg.float(), ck.float()) * D ** -0.5
    keys = off + torch.arange(Tc, device=q.device)
    s = s.masked_fill(~(keys[None, None, :] <= positions[:, :, None])[:, None, None],
                      float("-inf"))
    out, lse = chunk_attention(s, cv, "bkgst,btkv->bskgv")
    out = gather_partials(out, lse.permute(0, 3, 1, 2)).to(cdt)  # [B,S,KH,G,Dv]
    out = local_heads(out.reshape(B, S, cfg.n_heads, -1), H)
    y = _row_parallel_out(_out_project(out, p["wo"].to(cdt)), split, bo)
    return shard_l(y, ("batch", "seq", "act_embed")), {"k": ck, "v": cv}


CP_REPLICATED = ("wq", "wk", "wv", "wo", "bq", "bk", "bv", "q_norm", "k_norm")


def _gqa_context_parallel(p: Dict, x: torch.Tensor, cfg: ModelConfig, ways: int, *,
                          positions: torch.Tensor, causal: bool,
                          use_rope: bool) -> Tuple[torch.Tensor, None]:
    """Context-parallel attention (the reference's ``"attn_seq"`` rule):
    on model coordinate r of ``ways``, the query rows ``r*C:(r+1)*C`` (C =
    S / ways) attend every key, which each process projects whole (the
    reference's replicated K/V), so the attention itself needs no
    collective; the causal mask of the chunk starts at row ``r*C``.  The
    chunks' outputs, projected by ``wo``, are gathered along the sequence
    and ``bo`` is added once, after the gather.  The input and the weights
    the attention reads are replicated and enter the split region together:
    their gradients, partial sums over the chunks, are summed in one
    all-reduce a layer."""
    B, S, E = x.shape
    C = S // ways
    off = tp.model_rank() * C
    names = [k for k in CP_REPLICATED if k in p]
    x, *leaves = tp.enter_split_all([x] + [p[k] for k in names])
    p = dict(p, **dict(zip(names, leaves)))
    cdt = cfg.compute_dtype
    xq, q_pos = x[:, off:off + C], positions[:, off:off + C]
    q = _project(xq, p["wq"].to(cdt))
    k = _project(x, p["wk"].to(cdt))
    v = _project(x, p["wv"].to(cdt))
    if cfg.use_bias:
        q = q + p["bq"].to(cdt)
        k = k + p["bk"].to(cdt)
        v = v + p["bv"].to(cdt)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if use_rope:
        q = apply_rope(q, q_pos, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    H, KH, D = q.shape[2], k.shape[2], q.shape[3]
    out = run_attention(q.reshape(B, C, KH, H // KH, D), k, v, cfg, causal=causal,
                        scale=D ** -0.5, q_positions=q_pos, q_offset=off)
    y = tp.all_gather_cat(_out_project(out, p["wo"].to(cdt)), dim=1)
    if cfg.use_bias:
        y = y + p["bo"].to(cdt)
    return shard_l(y, ("batch", "seq", "act_embed")), None


# ---------------------------------------------------------------------------
# MLA layer (DeepSeek-V3)


def mla_specs(cfg: ModelConfig) -> Dict[str, Spec]:
    E, H = cfg.d_model, cfg.n_heads
    ql, kl = cfg.q_lora_rank, cfg.kv_lora_rank
    nope, rope_d, vd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    return {
        "wq_a": Spec((E, ql), ("embed", "q_lora"), ("in", "out"), init="fan_in"),
        "q_norm": Spec((ql,), ("q_lora",), ("out",), init="ones"),
        "wq_b": Spec((ql, H, nope + rope_d), ("q_lora", "heads", "head_dim"),
                     ("in", "out", "-"), init="fan_in"),
        "wkv_a": Spec((E, kl), ("embed", "kv_lora"), ("in", "out"), init="fan_in"),
        "wk_rope": Spec((E, rope_d), ("embed", "rope_dim"), ("in", "-"), init="fan_in"),
        "kv_norm": Spec((kl,), ("kv_lora",), ("out",), init="ones"),
        "wkv_b": Spec((kl, H, nope + vd), ("kv_lora", "heads", "head_dim"),
                      ("in", "out", "-"), init="fan_in"),
        "wo": Spec((H, vd, E), ("heads", "v_head_dim", "embed"), ("in", "-", "out"),
                   init="fan_in"),
    }


def mla_cache_specs(cfg: ModelConfig, batch: int, max_seq: int) -> Dict[str, Spec]:
    """Dense latent and rope strips ``[batch, max_seq, ...]`` (the slots
    engine)."""
    dt = cfg.compute_dtype
    return {
        "ckv": Spec((batch, max_seq, cfg.kv_lora_rank), ("batch", "cache_seq", "kv_lora"),
                    init="zeros", dtype=dt),
        "kpe": Spec((batch, max_seq, cfg.qk_rope_head_dim), ("batch", "cache_seq", "rope_dim"),
                    init="zeros", dtype=dt),
    }


def mla_paged_cache_specs(cfg: ModelConfig, n_pages: int, page_size: int) -> Dict[str, Spec]:
    """The latent and rope strips in the shared page pool ``[n_pages,
    page_size, ...]``: what absorbed decode reads."""
    dt = cfg.compute_dtype
    return {
        "ckv": Spec((n_pages, page_size, cfg.kv_lora_rank),
                    ("pages", "page_seq", "kv_lora"), init="zeros", dtype=dt),
        "kpe": Spec((n_pages, page_size, cfg.qk_rope_head_dim),
                    ("pages", "page_seq", "rope_dim"), init="zeros", dtype=dt),
    }


def mla_latent(p: Dict, x: torch.Tensor, cfg: ModelConfig,
               positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ckv [B,S,kv_lora] normed, kpe [B,S,rope] roped): what the cache holds."""
    cdt = cfg.compute_dtype
    ckv = rms_norm(x @ p["wkv_a"].to(cdt), p["kv_norm"], cfg.norm_eps)
    kpe = apply_rope((x @ p["wk_rope"].to(cdt))[:, :, None, :], positions,
                     cfg.rope_theta)[:, :, 0, :]
    return ckv, kpe


def mla_apply(
    p: Dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,
    causal: bool = True,
    cache: Optional[Dict] = None,
    block_tables: Optional[torch.Tensor] = None,  # [B,M]: cache is paged, else dense
    fill_cache: bool = False,  # no cache: return the fresh latents (a prefill's)
) -> Tuple[torch.Tensor, Optional[Dict]]:
    B, S, E = x.shape
    H = p["wq_b"].shape[1]  # the local heads: a block of ``heads`` on a "model" axis
    nope, rope_d, vd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    cdt = cfg.compute_dtype
    scale = (nope + rope_d) ** -0.5

    split = tp.is_split(H, cfg.n_heads)
    cq = rms_norm(x @ p["wq_a"].to(cdt), p["q_norm"], cfg.norm_eps)
    if split:  # the replicated latent enters the local heads
        cq = tp.enter_split(cq)
    q = _project(cq, p["wq_b"].to(cdt))  # [B,S,H,nope+rope]
    qn, qp = q[..., :nope], apply_rope(q[..., nope:], positions, cfg.rope_theta)
    ckv, kpe = mla_latent(p, x, cfg, positions)
    fresh = {"ckv": ckv, "kpe": kpe} if fill_cache and cache is None else None
    if split and cache is None:
        ckv, kpe = tp.enter_split(ckv), tp.enter_split(kpe)

    if cache is None:
        # training / prefill: expand per-head K, V and run standard attention
        kv = _project(ckv, p["wkv_b"].to(cdt))  # [B,S,H,nope+vd]
        k = torch.cat([kv[..., :nope], kpe[:, :, None, :].expand(B, S, H, rope_d)], -1)
        qg = torch.cat([qn, qp], -1)[:, :, :, None, :]  # KH == H, G == 1
        out = run_attention(qg, k, kv[..., nope:], cfg, causal=causal, scale=scale,
                            q_positions=positions)[:, :, :, 0, :]
        new_cache = fresh
    else:
        # absorbed decode: score and combine in the compressed latent space
        if block_tables is not None:
            # paged: gather this batch's rows through the block table; table
            # slot i covers positions [i P, (i + 1) P), so the position mask
            # below also hides the table's padding (page 0)
            cc = paged_write(cache["ckv"], ckv, positions, block_tables)
            ck = paged_write(cache["kpe"], kpe, positions, block_tables)
            new_cache = {"ckv": cc, "kpe": ck}
            M, P = block_tables.shape[1], cc.shape[1]
            cc = cc[block_tables].reshape(B, M * P, cc.shape[-1])
            ck = ck[block_tables].reshape(B, M * P, ck.shape[-1])
        elif cache_seq_ways() > 1:
            return _mla_decode_seq_split(p, qn, qp, ckv, kpe, cache, cfg, positions, H, split)
        else:
            pos0 = positions[:, 0]
            cc = seq_masked_write(cache["ckv"], ckv, pos0)
            ck = seq_masked_write(cache["kpe"], kpe, pos0)
            new_cache = {"ckv": cc, "kpe": ck}
        wkv_b = p["wkv_b"].to(cdt)
        q_eff = torch.einsum("bshn,lhn->bshl", qn, wkv_b[..., :nope])
        s = torch.einsum("bshl,btl->bhst", q_eff.float(), cc.float())
        s = s + torch.einsum("bshr,btr->bhst", qp.float(), ck.float())
        s = s * scale
        mask = (torch.arange(cc.shape[1], device=x.device)[None, None, :]
                <= positions[:, :, None])  # [B,S,T]
        s = s.masked_fill(~mask[:, None], NEG_INF)
        prob = torch.softmax(s, dim=-1)
        ctx = torch.einsum("bhst,btl->bshl", prob.to(cdt), cc)
        out = torch.einsum("bshl,lhv->bshv", ctx, wkv_b[..., nope:])

    y = _row_parallel_out(_out_project(out, p["wo"].to(cdt)), split, None)
    return shard_l(y, ("batch", "seq", "act_embed")), new_cache


def _mla_decode_seq_split(p: Dict, qn, qp, ckv, kpe, cache: Dict, cfg: ModelConfig,
                          positions, H: int, split: bool) -> Tuple[torch.Tensor, Dict]:
    """Absorbed decode on a sequence-split latent cache (see
    :func:`_gqa_decode_seq_split`): the local heads' absorbed queries and
    rope strips gathered whole, the token's latent written where it falls
    in the chunk, every head's partial context in the latent space and its
    lse gathered and merged in block order, then the local heads through
    ``wkv_b``'s value part and the row-parallel ``wo``."""
    B, S = qn.shape[:2]
    if S != 1:
        raise ValueError(f"a sequence-split cache decodes one token a row, got {S}")
    nope, rope_d = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    cdt = cfg.compute_dtype
    scale = (nope + rope_d) ** -0.5
    Tc = cache["ckv"].shape[1]
    off = tp.model_rank() * Tc
    cc = seq_masked_write(cache["ckv"], ckv, positions[:, 0], offset=off)
    ck = seq_masked_write(cache["kpe"], kpe, positions[:, 0], offset=off)
    wkv_b = p["wkv_b"].to(cdt)
    q_eff = torch.einsum("bshn,lhn->bshl", qn, wkv_b[..., :nope])
    q_eff, qp = gather_heads(q_eff, qp, split=(split, split))
    s = torch.einsum("bshl,btl->bhst", q_eff.float(), cc.float())
    s = (s + torch.einsum("bshr,btr->bhst", qp.float(), ck.float())) * scale
    keys = off + torch.arange(Tc, device=qn.device)
    s = s.masked_fill(~(keys[None, None, :] <= positions[:, :, None])[:, None], float("-inf"))
    ctx, lse = chunk_attention(s, cc, "bhst,btl->bshl")
    ctx = local_heads(gather_partials(ctx, lse.transpose(1, 2)).to(cdt), H)
    out = torch.einsum("bshl,lhv->bshv", ctx, wkv_b[..., nope:])
    y = _row_parallel_out(_out_project(out, p["wo"].to(cdt)), split, None)
    return shard_l(y, ("batch", "seq", "act_embed")), {"ckv": cc, "kpe": ck}


# ---------------------------------------------------------------------------
# cross attention (the VLM's image layers, the encoder-decoder's decoder)


def cross_attn_specs(cfg: ModelConfig, kv_axis: str = "embed", kv_dim: int = 0) -> Dict[str, Spec]:
    """Q from the stream, K/V from a source of width ``kv_dim`` (d_model
    unless given) on logical axis ``kv_axis``.  On any axis but "embed" the
    K/V inputs take role "-": the VLM's stub frontend width (the
    "vision_embed" axis) is fixed across levels.  ``gate`` (on the protected
    "mtp" axis, zeros at init) is Llama-3.2-Vision's tanh-gated residual."""
    E, H, KH, D = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    kvd = kv_dim or E
    kv_role = "in" if kv_axis == "embed" else "-"
    return {
        "wq": Spec((E, H, D), ("embed", "heads", "head_dim"), ("in", "out", "-"), init="fan_in"),
        "wk": Spec((kvd, KH, D), (kv_axis, "kv_heads", "head_dim"), (kv_role, "out", "-"),
                   init="fan_in"),
        "wv": Spec((kvd, KH, D), (kv_axis, "kv_heads", "head_dim"), (kv_role, "out", "-"),
                   init="fan_in"),
        "wo": Spec((H, D, E), ("heads", "head_dim", "embed"), ("in", "-", "out"), init="fan_in"),
        "gate": Spec((1,), ("mtp",), ("-",), init="zeros"),
    }


def cross_kv_cache_specs(cfg: ModelConfig, batch: int, n_kv_tokens: int) -> Dict[str, Spec]:
    """The projected source K/V ``[batch, n_kv_tokens, KH, D]``, written
    once by prefill."""
    KH, D = cfg.n_kv_heads, cfg.resolved_head_dim
    ax = ("batch", "img_seq", "cache_kv_heads", "head_dim")
    dt = cfg.compute_dtype
    return {
        "ck": Spec((batch, n_kv_tokens, KH, D), ax, init="zeros", dtype=dt),
        "cv": Spec((batch, n_kv_tokens, KH, D), ax, init="zeros", dtype=dt),
    }


def cross_attn_precompute(p: Dict, kv_src: torch.Tensor, cfg: ModelConfig) -> Dict:
    """K/V of the source ``kv_src`` [B,T,kv_dim] (no RoPE, no bias)."""
    cdt = cfg.compute_dtype
    return {"ck": _project(kv_src, p["wk"].to(cdt)), "cv": _project(kv_src, p["wv"].to(cdt))}


def cross_attn_apply(
    p: Dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    kv_src: Optional[torch.Tensor] = None,  # [B,T,kv_dim]: train and prefill
    kv_cache: Optional[Dict] = None,  # the projected K/V: decode
    gated: bool = True,
    kv_out: Optional[Dict] = None,  # filled with the K/V projected here (a prefill's)
) -> torch.Tensor:
    """Non-causal attention of ``x`` [B,S,E] over the source's K/V, through
    ``run_attention`` (flash past its thresholds; the plain route when the
    K/V come from the cache).  ``gated`` scales the output by tanh(gate).
    A prefill passes ``kv_out`` to keep the K/V for its cache.

    On a "model" axis the query and K/V heads split as in :func:`gqa_apply`:
    the stream and the cross source enter the split region, ``wo`` is
    row-parallel and summed, and the replicated gate scales the sum on every
    process alike."""
    B, S, E = x.shape
    H, KH, D = p["wq"].shape[1], p["wk"].shape[1], p["wq"].shape[2]
    k0, k1 = _kv_heads_read(H, KH, cfg)
    split = tp.is_split(H, cfg.n_heads)
    if split:
        x = tp.enter_split(x)
        if kv_src is not None:
            kv_src = tp.enter_split(kv_src)
        if not tp.is_split(KH, cfg.n_kv_heads):
            p = _enter_replicated(p, ("wk", "wv"))
    cdt = cfg.compute_dtype
    q = _project(x, p["wq"].to(cdt))
    kv = kv_cache if kv_cache is not None else cross_attn_precompute(p, kv_src, cfg)
    if kv_out is not None:
        kv_out.update(kv)
    out = run_attention(q.reshape(B, S, k1 - k0, H // (k1 - k0), D),
                        _head_block(kv["ck"], k0, k1), _head_block(kv["cv"], k0, k1), cfg,
                        causal=False, scale=D ** -0.5, decode=kv_cache is not None)
    y = _row_parallel_out(_out_project(out, p["wo"].to(cdt)), split, None)
    if gated:
        y = torch.tanh(p["gate"].to(cdt)) * y
    return y
