"""Batched serving: prefill + paged decode with continuous batching.

The counterpart of ``repro/launch/serve.py`` for the paged engine and the
greedy policy.  The host-side scheduling is the reference's, decision for
decision (admission with its worst-case page reserve, pow2 buckets for the
decode table width and the extend length, idle rows at position -1, prefix
reuse through ``launch/paging.py``), so the two packages emit the same token
streams and stats from the same weights.  The device side is PyTorch: the
page pool is a tree of ``[layers, n_pages, page_size, KH, D]`` tensors
written in place, and decode attention runs the ``paged_attention_decode``
kernel through the block tables.

  * ``EngineCore`` -- the scheduler: queue, admission, token commit,
    retirement, ``reset`` and ``set_params`` (how tests load weights).
  * ``PagedServer`` -- the paged-KV engine: block tables over a shared page
    pool, cold prompts prefilled and scattered into their pages, prompts that
    share a cached prefix run a bucketed extend step over the tail only.
  * ``GreedyPolicy`` -- one full-model argmax per tick.

Not ported yet: the ``slots`` engine, the speculative policy, live reload
and mesh-sharded decode.

Run: ``python -m repro_torch.launch.serve --device cuda``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import default_device
from repro_torch.launch.paging import NULL_PAGE, BlockAllocator
from repro_torch.models import lm as lm_lib
from repro_torch.models.api import build_model, make_paged_decode_step, make_prefill_step
from repro_torch.param import tree_map, zeros_tree


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # [S] int
    max_new: int
    out: List[int] = dataclasses.field(default_factory=list)


def zeros_paged_cache(cfg, n_pages: int, page_size: int, device):
    return zeros_tree(lm_lib.paged_cache_specs(cfg, n_pages, page_size),
                      cfg.compute_dtype, device)


def _bucket(n: int, cap: Optional[int] = None) -> int:
    """Next power of two >= n (the reference bounds its jit retraces with
    these; here they keep the scheduler's shapes identical to it)."""
    b = 1
    while b < n:
        b *= 2
    return min(b, cap) if cap is not None else b


def make_write_prompt(page_size: int):
    """Scatter a prefill cache ([layers, 1, L, ...] leaves) into a page pool
    at ``page_ids`` ([n_pg], logical page order), in place."""

    @torch.inference_mode()
    def write_prompt(pages, prefill_cache, page_ids):
        n_pg = page_ids.shape[0]

        def one(pool, c):
            c = c[:, 0]  # [layers, L, ...]
            pad = n_pg * page_size - c.shape[1]
            if pad:
                c = torch.cat([c, c.new_zeros((c.shape[0], pad) + c.shape[2:])], dim=1)
            pool[:, page_ids] = c.reshape(c.shape[0], n_pg, page_size,
                                          *c.shape[2:]).to(pool.dtype)
            return pool

        return tree_map(one, pages, prefill_cache)

    return write_prompt


# ---------------------------------------------------------------------------
# decode policies


class DecodePolicy:
    """Strategy turning scheduler ticks into committed tokens.

    The scheduler (``EngineCore``) owns request lifecycle and calls ``tick``
    once per scheduling round; the policy hands accepted tokens back through
    ``eng.commit(row, tokens)``.
    """

    name = "base"

    def tick(self, eng: "EngineCore") -> None:
        raise NotImplementedError

    def stats(self) -> Dict[str, Any]:
        return {"policy": self.name}


class GreedyPolicy(DecodePolicy):
    """One full-model argmax token per tick."""

    name = "greedy"

    def tick(self, eng: "EngineCore") -> None:
        act = [i for i, r in enumerate(eng.active) if r is not None]
        nxt = eng.decode_once()
        for i in act:
            eng.commit(i, [nxt[i]])


# ---------------------------------------------------------------------------
# scheduler core + engine


class EngineCore:
    """Engine-agnostic scheduler: request queue, admission, token commit and
    retirement.  Engines supply cache placement (``_place`` / ``_retire`` /
    ``decode_once``); the bound ``DecodePolicy`` decides what each tick
    decodes."""

    engine_name = "base"

    def __init__(self, cfg, batch: int, max_seq: int,
                 policy: Optional[DecodePolicy] = None, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.model = build_model(cfg)
        self.batch = batch
        self.max_seq = max_seq
        gen = torch.Generator(device=self.device)
        gen.manual_seed(0)
        self.params = self.model.init(gen)
        self.prefill = make_prefill_step(self.model)
        self.pos = np.zeros((batch,), np.int64)
        self.last_tok = np.zeros((batch,), np.int64)
        self.active: List[Optional[Request]] = [None] * batch
        self.done: List[Request] = []
        self.rejected: List[Request] = []  # oversized prompts (see admit)
        self.policy = policy or GreedyPolicy()

    # -- engine hooks (overridden) ------------------------------------------
    def _fits_engine(self, req: Request) -> bool:
        return True

    def _place(self, row: int, req: Request) -> Optional[int]:
        """Reserve cache space for ``req`` in ``row`` and prefill; returns the
        first generated token, or None when resources are busy right now."""
        raise NotImplementedError

    def _retire(self, row: int, req: Request) -> None:
        pass

    def _reset_engine(self) -> None:
        pass

    def _on_params_engine(self) -> None:
        """Engine hook: serving params changed."""

    def decode_once(self) -> np.ndarray:
        """One full-model decode step over all rows -> next-token argmaxes
        ([batch]; inactive rows carry garbage the caller ignores)."""
        raise NotImplementedError

    def _admit_error(self, req: Request) -> str:
        return (f"prompt of length {len(req.prompt)} cannot be admitted: "
                f"max_seq={self.max_seq} leaves no room to decode "
                f"(need len(prompt) <= max_seq - 1)")

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.asarray(a, np.int64)).to(self.device)

    # -- continuous batching -------------------------------------------------
    def fits(self, req: Request) -> bool:
        """The admission invariant: decode must be able to write at least one
        token at a valid cache index (plus any engine capacity check)."""
        return len(req.prompt) <= self.max_seq - 1 and self._fits_engine(req)

    def admit(self, req: Request) -> bool:
        """Place ``req`` into a free row; False when rows/resources are busy
        right now.  Raises ``ValueError`` for prompts that can never fit."""
        if not self.fits(req):
            raise ValueError(self._admit_error(req))
        row = next((i for i, r in enumerate(self.active) if r is None), None)
        if row is None:
            return False
        first = self._place(row, req)
        if first is None:
            return False
        self.active[row] = req
        self.pos[row] = len(req.prompt)
        self.last_tok[row] = first
        return True

    def commit(self, row: int, toks) -> None:
        """Append policy-accepted tokens to ``row``'s request, advancing the
        decode cursor and retiring the request the moment it is finished."""
        req = self.active[row]
        for t in toks:
            req.out.append(int(t))
            # cap at the last valid cache index
            self.pos[row] = min(self.pos[row] + 1, self.max_seq - 1)
            self.last_tok[row] = int(t)
            self._on_token(row, req)
            if len(req.out) >= req.max_new or self.pos[row] >= self.max_seq - 1:
                self.done.append(req)
                self.active[row] = None
                self._retire(row, req)
                break

    def _on_token(self, row: int, req: Request) -> None:
        pass

    def step(self) -> None:
        if not any(r is not None for r in self.active):
            return
        self.policy.tick(self)

    def run(self, requests: List[Request], max_ticks: int = 10_000) -> List[Request]:
        """Drain ``requests``: admit into free rows, decode, recycle rows.
        Oversized prompts go to ``self.rejected``; a request that lacks
        resources now waits at the queue head for completions."""
        queue = list(requests)
        ticks = 0
        while (queue or any(self.active)) and ticks < max_ticks:
            while queue:
                if not self.fits(queue[0]):
                    req = queue.pop(0)
                    self.rejected.append(req)
                    print(f"[serve] rejected req {req.rid}: prompt length "
                          f"{len(req.prompt)} > max_seq-1 = {self.max_seq - 1}")
                    continue
                if not self.admit(queue[0]):
                    break
                queue.pop(0)
            self.step()
            ticks += 1
        return self.done

    def reset(self) -> None:
        """Clear request state but keep params.  Stale cache contents are
        safe: every admit overwrites its range before it is read, and decode
        reads are position-masked."""
        self.pos[:] = 0
        self.last_tok[:] = 0
        self.active = [None] * self.batch
        self.done, self.rejected = [], []
        self._reset_engine()

    def set_params(self, params) -> None:
        """Swap the serving weights now (a tree shaped like ``self.params``,
        moved to this engine's device); weight-derived caches are dropped."""
        self.params = tree_map(lambda t: t.to(self.device), params)
        self._on_params_engine()

    def stats(self) -> Dict[str, Any]:
        return dict(self.policy.stats())


class PagedServer(EngineCore):
    """Paged-KV engine: block tables over a shared page pool + prefix reuse.

    Admission reserves the request's worst-case page count up front
    (``ceil(min(len(prompt)+max_new, max_seq) / page_size)``), so an admitted
    request never stalls on allocation mid-decode.  Cache-hit prompts run a
    bucketed "extend" step over just the non-shared tail.
    """

    engine_name = "paged"

    def __init__(self, cfg, batch: int = 4, max_seq: int = 128,
                 page_size: int = 16, n_pages: Optional[int] = None,
                 prefix_reuse: bool = True,
                 policy: Optional[DecodePolicy] = None, device="cuda"):
        super().__init__(cfg, batch, max_seq, policy, device)
        self.page_size = page_size
        self.max_pages_per_req = -(-max_seq // page_size)
        if n_pages is None:
            # page-count parity with a dense [batch, max_seq] cache (+1 for
            # the reserved null page): admission is then row-bound
            n_pages = batch * self.max_pages_per_req + 1
        self.n_pages = n_pages
        self.paged_step = make_paged_decode_step(self.model)
        self._write_prompt = make_write_prompt(page_size)
        self.pages = zeros_paged_cache(cfg, n_pages, page_size, self.device)
        self.alloc = BlockAllocator(n_pages, page_size, prefix_reuse=prefix_reuse)
        self.tables: List[Optional[List[int]]] = [None] * batch
        self.prefill_tokens_computed = 0

    # -- stats ---------------------------------------------------------------
    @property
    def prefill_tokens_saved(self) -> int:
        return self.alloc.reused_tokens_total

    @property
    def pages_in_use_peak(self) -> int:
        return self.alloc.pool.in_use_peak

    def stats(self) -> Dict[str, Any]:
        return {
            "pages_in_use_peak": self.pages_in_use_peak,
            "pages_capacity": self.alloc.pool.capacity,
            "prefill_tokens_saved": self.prefill_tokens_saved,
            "prefill_tokens_computed": self.prefill_tokens_computed,
            "rolled_back_positions": self.alloc.rolled_back_total,
            **self.policy.stats(),
        }

    # -- engine hooks --------------------------------------------------------
    def _fits_engine(self, req: Request) -> bool:
        """Admissible-ever: a worst-case block table the pool could hold."""
        total = min(len(req.prompt) + req.max_new, self.max_seq)
        return self.alloc.pages_needed(total) <= self.alloc.pool.capacity

    def _admit_error(self, req: Request) -> str:
        return (f"prompt of length {len(req.prompt)} cannot be admitted: "
                f"max_seq={self.max_seq} leaves no room to decode "
                f"(need len(prompt) <= max_seq - 1 and a block table "
                f"<= {self.alloc.pool.capacity} pages)")

    def _place(self, row: int, req: Request) -> Optional[int]:
        L = len(req.prompt)
        total_positions = min(L + req.max_new, self.max_seq)
        got = self.alloc.admit(req.rid, req.prompt, total_positions)
        if got is None:
            return None
        table, reuse_len = got
        if reuse_len == 0:
            # cold prompt: prefill, then scatter its cache into our pages
            logits, pc = self.prefill(self.params, self._tensor(req.prompt)[None])
            n_pg = -(-L // self.page_size)
            self.pages = self._write_prompt(self.pages, pc, self._tensor(table[:n_pg]))
            first = int(torch.argmax(logits[0]))
            self.prefill_tokens_computed += L
        else:
            # warm prompt: run only the tail through a bucketed extend step;
            # reused pages are read through the block table (never rewritten)
            tail = np.asarray(req.prompt[reuse_len:], np.int64)
            S = len(tail)
            S_b = _bucket(S)
            toks = np.zeros((S_b,), np.int64)
            toks[S_b - S:] = tail
            positions = np.full((S_b,), -1, np.int64)  # left-pad -> null page
            positions[S_b - S:] = np.arange(reuse_len, L)
            M_b = _bucket(len(table), cap=self.max_pages_per_req)
            bt = np.full((M_b,), NULL_PAGE, np.int64)
            bt[:len(table)] = table
            logits, self.pages = self.paged_step(
                self.params, self.pages, self._tensor(toks)[None],
                self._tensor(positions)[None], self._tensor(bt)[None])
            first = int(torch.argmax(logits[0]))
            self.prefill_tokens_computed += S
        self.tables[row] = table
        return first

    def _on_token(self, row: int, req: Request) -> None:
        self.alloc.advance(req.rid)

    def _retire(self, row: int, req: Request) -> None:
        self.tables[row] = None
        self.alloc.complete(req.rid)

    def decode_once(self) -> np.ndarray:
        act = [i for i, r in enumerate(self.active) if r is not None]
        M_b = _bucket(max(len(self.tables[i]) for i in act), cap=self.max_pages_per_req)
        bt = np.full((self.batch, M_b), NULL_PAGE, np.int64)
        positions = np.full((self.batch, 1), -1, np.int64)  # idle row: len 0
        toks = np.zeros((self.batch, 1), np.int64)
        for i in act:
            bt[i, :len(self.tables[i])] = self.tables[i]
            positions[i, 0] = self.pos[i]
            toks[i, 0] = self.last_tok[i]
        logits, self.pages = self.paged_step(
            self.params, self.pages, self._tensor(toks), self._tensor(positions),
            self._tensor(bt))
        return torch.argmax(logits, -1).cpu().numpy()

    def _reset_engine(self) -> None:
        """Stale page contents are safe: decode reads are length-masked and
        every admit writes the prompt range of its fresh pages first."""
        self.alloc = BlockAllocator(self.n_pages, self.page_size,
                                    prefix_reuse=self.alloc.prefix is not None)
        self.tables = [None] * self.batch
        self.prefill_tokens_computed = 0

    def _on_params_engine(self) -> None:
        # cached prompt pages hold K/V computed under the old weights
        self.alloc.invalidate_prefix()


POLICIES = ("greedy",)
ENGINES = ("paged",)


def make_server(cfg, engine: str = "paged", batch: int = 4, max_seq: int = 128,
                page_size: int = 16, n_pages: Optional[int] = None,
                prefix_reuse: bool = True,
                policy: "str | DecodePolicy" = "greedy", device=None) -> PagedServer:
    if isinstance(policy, str):
        if policy != "greedy":
            raise ValueError(f"unknown policy {policy!r}; expected one of "
                             f"{POLICIES} or a DecodePolicy instance")
        pol: DecodePolicy = GreedyPolicy()
    elif isinstance(policy, DecodePolicy):
        pol = policy
    else:
        raise TypeError(f"policy must be one of {POLICIES} or a DecodePolicy "
                        f"instance, got {type(policy).__name__}")
    if engine != "paged":
        raise ValueError(f"unknown engine {engine!r}; expected one of {ENGINES}")
    return PagedServer(cfg, batch=batch, max_seq=max_seq, page_size=page_size,
                       n_pages=n_pages, prefix_reuse=prefix_reuse, policy=pol,
                       device=default_device(device))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction, default=True)
    ap.add_argument("--engine", choices=ENGINES, default="paged")
    ap.add_argument("--policy", choices=POLICIES, default="greedy")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--no-prefix-reuse", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; fails when absent)")
    args = ap.parse_args()

    cfg = get_config(args.arch, smoke=args.smoke)
    srv = make_server(cfg, engine=args.engine, batch=args.batch,
                      max_seq=args.max_seq, page_size=args.page_size,
                      prefix_reuse=not args.no_prefix_reuse,
                      policy=args.policy, device=args.device)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, size=rng.integers(4, 12)),
                    max_new=args.max_new) for i in range(args.requests)]
    t0 = time.time()
    done = srv.run(reqs)
    if srv.device.type == "cuda":
        torch.cuda.synchronize(srv.device)
    dt = time.time() - t0
    tok = sum(len(r.out) for r in done)
    print(f"[serve] engine={args.engine} policy={args.policy} device={srv.device}: "
          f"{len(done)} requests, {tok} tokens in {dt:.1f}s "
          f"({tok/max(dt,1e-9):.1f} tok/s, batch={args.batch})")
    print(f"[serve] {srv.stats()}")
    for r in done[:3]:
        print(f"  req {r.rid}: prompt[:4]={r.prompt[:4].tolist()} -> out[:8]={r.out[:8]}")


if __name__ == "__main__":
    main()
