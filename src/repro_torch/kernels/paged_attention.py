"""Paged-attention decode: the CUDA kernel and its plain PyTorch version.

The counterpart of ``repro/kernels/paged_attention.py`` (the Pallas
``_paged_decode_kernel``): one query token per sequence attends the K/V of
its pages, found through its block-table row, in a shared
``[n_pages, page_size, KH, D]`` pool.  Positions >= length are masked and a
length-0 row (an idle decode slot) gives exact zeros.

The kernel source is ``csrc/paged_attention_decode.cu``: split-KV over the
positions a table row can address, then a merge of the splits in a fixed
order (flash-decoding); head dims 64 and 128 take its tiled split body, 16
and 32 (the reduced configs' heads) a narrow one.  Each launch, and each call of the meta form
(``paged_attention_decode_meta``), reports :func:`paged_attention_decode_cost`
to ``kernels/cost.py``.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from repro_torch.kernels import build, cost, ref
from repro_torch.kernels.flash_attention import DTYPE_CODES, check_cuda_inputs

SPLIT_SPAN = 64  # positions per split: kSplitSpan in csrc/paged_attention_decode.cu
# the head dims the kernel takes: 64 and 128 on its tiled split body, the
# reduced configs' 16 and 32 on its narrow one
HEAD_DIMS = (16, 32, 64, 128)
INDEX_CODES = {torch.int32: 0, torch.int64: 1}  # the kernel's IndexType


def split_plan(M: int, P: int) -> Tuple[int, int]:
    """(span, n_splits) of a table of M pages of P positions: split s covers
    positions [s * span, (s + 1) * span).  Shapes alone decide it, so the
    wrapper never reads ``lengths`` on the host."""
    return SPLIT_SPAN, -(-M * P // SPLIT_SPAN)


def paged_attention_decode_cost(B: int, KH: int, G: int, D: int, P: int, M: int,
                                lengths: Optional[Sequence[int]], *, itemsize: int = 2,
                                table_itemsize: int = 8, length_itemsize: int = 8
                                ) -> Tuple[float, float]:
    """(operations, bytes) of one decode step: 4 G D operations per position
    and kv head over the positions up to each row's length (clamped to the
    table's ``M * P``); K/V rows to each length, q and out, the table
    entries of the pages in use and the lengths, each read or written once.
    ``lengths`` None counts every row at the table's full extent (the meta
    form, which cannot read them)."""
    full = M * P
    ln = [full] * B if lengths is None else [min(max(int(n), 0), full) for n in lengths]
    n_tok = sum(ln)
    nbytes = (2 * n_tok * KH * D * itemsize + 2 * B * KH * G * D * itemsize
              + table_itemsize * sum(-(-n // P) for n in ln) + length_itemsize * B)
    return 4.0 * n_tok * KH * G * D, nbytes


def paged_attention_decode_torch(q, k_pages, v_pages, block_tables, lengths, *,
                                 scale: Optional[float] = None) -> torch.Tensor:
    """Plain version: gather through the tables, mask, one f32 softmax."""
    return ref.paged_attention_ref(q, k_pages, v_pages, block_tables, lengths,
                                   scale=scale)


def paged_attention_decode_cuda(q, k_pages, v_pages, block_tables, lengths, *,
                                scale: Optional[float] = None) -> torch.Tensor:
    """Launch ``paged_attention_decode`` (split and merge) on the current stream.

    q [B,KH,G,D], k_pages/v_pages [N,P,KH,D], block_tables [B,M], lengths [B]
    -> [B,KH,G,D].  Tables and lengths are read as they are, int64 or int32
    (lengths are cast only when their type differs from the tables').  No
    fallback: a bad input, a failed build or a refused launch raises.
    """
    check_cuda_inputs("paged_attention_decode", q, k_pages, v_pages,
                      block_tables, lengths)
    B, KH, G, D = q.shape
    N, P = k_pages.shape[:2]
    M = block_tables.shape[1]
    if k_pages.shape != (N, P, KH, D) or v_pages.shape != k_pages.shape:
        raise ValueError(f"paged_attention_decode: q {tuple(q.shape)}, pages "
                         f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)} do not "
                         f"agree (Dv must equal D)")
    if block_tables.shape != (B, M) or lengths.shape != (B,):
        raise ValueError(f"paged_attention_decode: tables {tuple(block_tables.shape)} "
                         f"/ lengths {tuple(lengths.shape)} for batch {B}")
    if D not in HEAD_DIMS:
        raise ValueError(f"paged_attention_decode: head_dim {D} unsupported {HEAD_DIMS}")
    if q.dtype not in DTYPE_CODES or k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise ValueError(f"paged_attention_decode: dtypes {q.dtype}/{k_pages.dtype}/"
                         f"{v_pages.dtype}; need one of {tuple(DTYPE_CODES)} for all three")
    if block_tables.dtype not in INDEX_CODES or lengths.dtype not in INDEX_CODES:
        raise ValueError(f"paged_attention_decode: index dtypes {block_tables.dtype}/"
                         f"{lengths.dtype}; need one of {tuple(INDEX_CODES)}")
    if not (q.is_contiguous() and k_pages.is_contiguous() and v_pages.is_contiguous()):
        raise ValueError("paged_attention_decode: q and the page pools must be contiguous")
    if q.data_ptr() % 16 or k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("paged_attention_decode: q and the page pools must start on a "
                         "16-byte boundary (the kernel loads 16-byte rows)")
    if B * KH > 65535:
        raise ValueError(f"paged_attention_decode: {B} x {KH} (sequence, kv head) "
                         f"pairs exceed the grid's 65535")
    scale = D ** -0.5 if scale is None else scale
    bt = block_tables.contiguous()
    ln = lengths.to(bt.dtype).contiguous()
    out = torch.empty_like(q)
    if B == 0:
        return out
    _, n_splits = split_plan(M, P)
    parts = B * KH * n_splits * G
    work = torch.empty(parts * (D + 2), dtype=torch.float32, device=q.device)
    lib = build.load_library()
    with torch.cuda.device(q.device):
        err = lib.paged_attention_decode(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), bt.data_ptr(),
            ln.data_ptr(), INDEX_CODES[bt.dtype], work.data_ptr(),
            work[parts * D:].data_ptr(), out.data_ptr(),
            DTYPE_CODES[q.dtype], B, KH, G, D, P, M, n_splits,
            float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "paged_attention_decode")
    paged_attention_decode_cuda.launches += 1
    if cost.active():  # the lengths are read on the host only while a recorder counts
        cost.record("paged_attention_decode", *paged_attention_decode_cost(
            B, KH, G, D, P, M, lengths.tolist(), itemsize=q.element_size(),
            table_itemsize=bt.element_size(), length_itemsize=lengths.element_size()))
    return out


paged_attention_decode_cuda.launches = 0


def paged_attention_decode_meta(q, k_pages, v_pages, block_tables, lengths, *,
                                scale: Optional[float] = None) -> torch.Tensor:
    """The meta form: what ``paged_attention_decode_cuda`` allocates (the
    tables and lengths in one index type, out, the splits' work buffer),
    nothing computed; reports the cost at the tables' full extent."""
    B, KH, G, D = q.shape
    N, P = k_pages.shape[:2]
    M = block_tables.shape[1]
    bt = block_tables.contiguous()
    ln = lengths.to(bt.dtype).contiguous()
    out = torch.empty_like(q)
    _, n_splits = split_plan(M, P)
    parts = B * KH * n_splits * G
    work = torch.empty(parts * (D + 2), dtype=torch.float32, device=q.device)
    cost.record("paged_attention_decode", *paged_attention_decode_cost(
        B, KH, G, D, P, M, None, itemsize=q.element_size(), table_itemsize=bt.element_size(),
        length_itemsize=lengths.element_size()))
    del ln, work
    return out
