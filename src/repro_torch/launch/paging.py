"""Page-pool bookkeeping for the paged KV serving engine: host-side, pure
Python, a copy of ``repro/launch/paging.py`` so the port's scheduler makes
the reference's decisions one for one.

``PagePool`` owns the page ids of the shared ``[n_pages, page_size, ...]``
cache leaves; ``BlockAllocator`` turns prompts into per-request block tables
(page-id lists), reusing refcounted prompt pages across requests that share a
prefix.  Prefix pages are keyed by a rolling blake2b digest of their token
blocks: the digest of page ``i`` commits to *all* tokens up to
``(i+1)*page_size``, so equal digests imply the causal K/V content of the
page is identical and may be shared.

Invariants:
  * a page is either free or held by >= 1 live request -- never both,
  * no page is handed to two requests except through refcounted reuse,
  * a shared prefix page is freed exactly when its last holder completes.
"""
from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

NULL_PAGE = 0  # reserved: never allocated; padding/inactive writes land here


class PagePool:
    """Free-list + refcounts over page ids ``1..n_pages-1`` (page 0 is the
    reserved null page that bucketed/inactive writes are routed to)."""

    def __init__(self, n_pages: int):
        if n_pages < 2:
            raise ValueError(f"need n_pages >= 2 (one null + one usable), got {n_pages}")
        self.n_pages = n_pages
        self._free: List[int] = list(range(n_pages - 1, 0, -1))  # pop() -> ascending
        self._ref: Dict[int, int] = {}
        self.in_use_peak = 0

    @property
    def capacity(self) -> int:
        return self.n_pages - 1

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_used(self) -> int:
        return self.capacity - len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """All-or-nothing: ``n`` fresh pages at refcount 1, or None."""
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        for pid in pages:
            self._ref[pid] = 1
        self.in_use_peak = max(self.in_use_peak, self.n_used)
        return pages

    def incref(self, pid: int) -> None:
        if pid not in self._ref:
            raise ValueError(f"incref on free page {pid}")
        self._ref[pid] += 1
        self.in_use_peak = max(self.in_use_peak, self.n_used)

    def decref(self, pid: int) -> bool:
        """Drop one reference; True when this freed the page."""
        if pid not in self._ref:
            raise ValueError(f"decref on free page {pid}")
        self._ref[pid] -= 1
        if self._ref[pid] == 0:
            del self._ref[pid]
            self._free.append(pid)
            return True
        return False

    def refcount(self, pid: int) -> int:
        return self._ref.get(pid, 0)


def page_digests(tokens: Sequence[int], page_size: int) -> List[str]:
    """Rolling blake2b chain over full ``page_size`` token blocks.

    ``d_i = blake2b(d_{i-1} || block_i)`` -- page i's key commits to the whole
    prefix, so two prompts share a digest iff they share all tokens through
    that page.  Only full pages get a digest (a partial tail page is never
    shareable: its remaining slots will be filled by request-specific tokens).
    """
    toks = np.ascontiguousarray(np.asarray(tokens, np.int32))
    out: List[str] = []
    d = b"prompt-page-v1"
    for i in range(len(toks) // page_size):
        h = hashlib.blake2b(d, digest_size=20)
        h.update(toks[i * page_size:(i + 1) * page_size].tobytes())
        d = h.digest()
        out.append(d.hex())
    return out


class PrefixCache:
    """digest -> live page id (valid only while the page's refcount > 0;
    ``BlockAllocator.complete`` evicts entries as their pages free)."""

    def __init__(self):
        self._by_digest: Dict[str, int] = {}
        self._by_page: Dict[int, str] = {}

    def lookup(self, digests: Sequence[str]) -> List[int]:
        """Page ids for the longest consecutive prefix of ``digests`` present."""
        pages: List[int] = []
        for d in digests:
            pid = self._by_digest.get(d)
            if pid is None:
                break
            pages.append(pid)
        return pages

    def insert(self, digest: str, pid: int) -> None:
        if digest in self._by_digest:  # first writer wins; content is identical
            return
        self._by_digest[digest] = pid
        self._by_page[pid] = digest

    def evict_page(self, pid: int) -> None:
        d = self._by_page.pop(pid, None)
        if d is not None:
            del self._by_digest[d]

    def clear(self) -> int:
        """Drop every entry; returns how many were dropped.

        The pages themselves stay live (their holders keep reading them) --
        they just stop being discoverable by new arrivals.
        """
        n = len(self._by_digest)
        self._by_digest.clear()
        self._by_page.clear()
        return n

    def __len__(self) -> int:
        return len(self._by_digest)


class BlockAllocator:
    """Admission bookkeeping: prompt -> block table, with prefix reuse.

    ``admit`` reserves the request's *worst-case* page count up front
    (``ceil(total_positions / page_size)``), so decode never allocates
    mid-flight and a admitted request can always run to completion.
    """

    def __init__(self, n_pages: int, page_size: int, prefix_reuse: bool = True):
        self.pool = PagePool(n_pages)
        self.page_size = page_size
        self.prefix: Optional[PrefixCache] = PrefixCache() if prefix_reuse else None
        self.live: Dict[int, List[int]] = {}  # rid -> block table
        self.reused_tokens_total = 0
        # per-request length bookkeeping for speculative decode (see
        # advance/mark_written/rollback): committed positions vs the
        # written high-water mark of in-flight (unverified) draft positions
        self.lengths: Dict[int, int] = {}      # rid -> committed positions
        self.written: Dict[int, int] = {}      # rid -> written high-water
        self.reserved: Dict[int, int] = {}     # rid -> worst-case positions
        self._prompt_len: Dict[int, int] = {}
        self.rolled_back_total = 0             # positions rewound across rollbacks
        self.invalidations_total = 0           # prefix-cache wipes (weight swaps)

    def pages_needed(self, total_positions: int) -> int:
        return -(-total_positions // self.page_size)

    def admit(self, rid: int, tokens: Sequence[int],
              total_positions: int) -> Optional[Tuple[List[int], int]]:
        """Reserve pages for a request; ``(block_table, reuse_len)`` or None
        when the pool can't cover the non-shared need right now.

        ``reuse_len`` tokens at the head of the prompt are served from shared
        (refcounted) pages and never re-prefilled.  Reuse is capped one token
        short of the prompt so the model still runs >= 1 fresh position (the
        last prompt token's logits seed decode).
        """
        if rid in self.live:
            raise ValueError(f"request {rid} already admitted")
        if total_positions < len(tokens):
            raise ValueError("total_positions must cover the prompt")
        P = self.page_size
        total_pages = self.pages_needed(total_positions)
        digests = page_digests(tokens, P)
        reused: List[int] = []
        if self.prefix is not None:
            cap = (len(tokens) - 1) // P  # leave >= 1 token of fresh tail
            reused = self.prefix.lookup(digests[:cap])
        new = self.pool.alloc(total_pages - len(reused))
        if new is None:
            return None
        for pid in reused:
            self.pool.incref(pid)
        table = reused + new
        if self.prefix is not None:
            # publish this prompt's own full pages for later arrivals
            for i in range(len(reused), len(tokens) // P):
                self.prefix.insert(digests[i], table[i])
        self.live[rid] = table
        self.reused_tokens_total += len(reused) * P
        self.lengths[rid] = len(tokens)
        self.written[rid] = len(tokens)
        self.reserved[rid] = total_positions
        self._prompt_len[rid] = len(tokens)
        return table, len(reused) * P

    # -- speculative-decode length protocol ---------------------------------
    # Committed positions only ever grow via ``advance`` (verified tokens);
    # speculation first raises the ``written`` high-water with
    # ``mark_written`` (the verify step writes k+1 unverified positions),
    # then ``rollback`` rewinds ``written`` to the committed length once the
    # accepted prefix is known.  The rejected positions' stale K/V needs no
    # physical erase: reads are position-masked (queries only attend
    # positions <= their own) and the next committed write at that position
    # overwrites it.  Shared prefix pages can never be touched: every
    # speculative write lands at a position >= the prompt length, while
    # prefix reuse is capped at ``(len(prompt)-1) // page_size`` pages --
    # so rollback cannot poison the PrefixCache.

    def advance(self, rid: int, n: int = 1) -> int:
        """Commit ``n`` more positions (verified/emitted tokens)."""
        new = self.lengths[rid] + n
        if new > self.reserved[rid]:
            raise ValueError(
                f"request {rid}: committing {new} positions exceeds the "
                f"admission reserve of {self.reserved[rid]}")
        self.lengths[rid] = new
        self.written[rid] = max(self.written[rid], new)
        return new

    def mark_written(self, rid: int, upto: int) -> None:
        """Record that positions ``[0, upto)`` now hold K/V, committed or not
        (the speculative verify step writes drafted positions eagerly)."""
        if upto > self.reserved[rid]:
            raise ValueError(
                f"request {rid}: speculative write through position {upto} "
                f"exceeds the admission reserve of {self.reserved[rid]}")
        self.written[rid] = max(self.written[rid], upto)

    def rollback(self, rid: int) -> int:
        """Rewind the written high-water to the committed length, i.e. drop
        the rejected drafted positions; returns how many were rolled back."""
        rolled = self.written[rid] - self.lengths[rid]
        assert rolled >= 0 and self.lengths[rid] >= self._prompt_len[rid]
        self.written[rid] = self.lengths[rid]
        self.rolled_back_total += rolled
        return rolled

    def invalidate_prefix(self) -> int:
        """Wipe the prefix cache after a weight swap; returns entries dropped.

        Cached prompt pages hold K/V computed under the *old* params, so a
        post-swap arrival must never match them: a digest commits to the
        token content of a prefix, not to the weights that encoded it.  Pages
        held by in-flight requests keep their refcounts (those requests
        finish under the old weights and still read them) -- the entries just
        leave the cache, exactly as ``complete`` would evict them one by one.
        """
        if self.prefix is None:
            return 0
        self.invalidations_total += 1
        return self.prefix.clear()

    def complete(self, rid: int) -> None:
        """Release the request's pages; a shared page survives until its last
        holder completes, and leaves the prefix cache the moment it frees."""
        for pid in self.live.pop(rid):
            if self.pool.decref(pid) and self.prefix is not None:
                self.prefix.evict_page(pid)
        for d in (self.lengths, self.written, self.reserved, self._prompt_len):
            d.pop(rid, None)
