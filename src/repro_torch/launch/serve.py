"""Batched serving: prefill + decode with continuous batching.

The counterpart of ``repro/launch/serve.py``.  The host-side
scheduling is the reference's, decision for decision (admission with its
worst-case page reserve, pow2 buckets for the decode table width and the
extend and verify lengths, idle rows at position -1, prefix reuse through
``launch/paging.py``, the speculative window, acceptance and rollback), so
the two packages emit the same token streams and stats from the same
weights.  The device side is PyTorch: caches are trees of tensors written in
place, and decode attention runs the ``paged_attention_decode`` kernel
through the block tables.

  * ``EngineCore`` -- the scheduler: queue, admission, token commit,
    retirement, ``reset``, ``set_params`` and live weight reload
    (``request_reload`` stages new weights, which swap in at the first tick
    boundary with no request in flight).  It calls the policy's lifecycle
    hooks (``bind``, ``on_admit``, ``on_complete``, ``on_reset``,
    ``on_params``).
  * ``PagedServer`` -- the paged-KV engine: block tables over a shared page
    pool, cold prompts prefilled and scattered into their pages, prompts that
    share a cached prefix run a bucketed extend step over the tail only.
  * ``Server`` -- the ``slots`` engine: dense ``[batch, max_seq]`` caches
    (and the recurrent mixers' states), one row per request, prefill
    spliced into a free row.  The oracle the paged engine is held to, and
    the engine of the recurrent families (the paged one refuses them).
  * ``GreedyPolicy`` -- one full-model argmax per tick (both engines).
  * ``SpeculativePolicy`` -- self-speculative decoding (paged engine): the
    level-1 coalesced model, a projection of the serving weights
    (``core/operators.py::make_draft_projection``), drafts up to k tokens per
    row over its own page pool, one full-model verify step scores them, and
    the agreeing prefix plus one full-model token is committed.  Every
    committed token is a full-model argmax, so the streams are greedy's.
  * ``ManifestWatcher`` -- the train-to-serve hand-off: polls a trainer's
    checkpoint directory and lands new level-0 weights by digest diff, so
    leaves that did not change are neither read nor moved.

MLA models (DeepSeek-V3) serve on every engine and policy: their caches
hold the compressed latent and rope strips, dense or paged, and decode
scores against them in the latent space (``layers/attention.py::mla_apply``),
so no paged-decode kernel runs on their path.

Mesh-sharded paged decode (``PagedServer(mesh=)``, ``--mesh DxM``): one
process per device, each holding its block of every parameter and page
pool as ``models/api.py::serve_shardings`` lays them out (K/V heads split
over "model"; MLA's latent pools whole; every other weight replicated over
the data axes, experts split over ("model", "data"), model-major), and
running the serving steps in ``mesh_ctx``, where the layers compute their
local heads, FFN columns, experts and vocabulary rows and meet at the
explicit collectives of ``distributed/tensor_parallel.py``.  The scheduler
runs on every process on the same host data (the reference's replicated
step inputs) and takes its decisions from the same gathered logits, so the
processes agree token for token and emit the unsharded server's streams.
The speculative policy runs on the mesh too: its draft is projected from
the gathered serving weights and cut to the draft's own serving layout.
Not on a mesh: the slots engine (the reference's refusal).  The serving
mesh never runs context-parallel attention, which is a training feature in
the reference.  ``--reload-local`` reads
``--reload-from`` as a per-host local checkpoint directory
(``CheckpointManager(local=True)``); a checkpoint that several training
processes wrote into local dirs keeps each rank's FSDP blocks in its own,
and ``--reload-peer-dirs`` names the others.

Run: ``python -m repro_torch.launch.serve --device cuda [--arch ID [--no-smoke]]
[--engine slots] [--policy speculative --draft-k 4] [--reload-from DIR
[--reload-local [--reload-peer-dirs DIR ...]]] [--mesh DxM --num-processes D*M --process-id I
--coordinator HOST:PORT]`` (one command per process);
``--arch`` takes a config of ``repro_torch.configs`` (the MoE
``phi3.5-moe-42b-a6.6b``, ``qwen3-4b``, ``deepseek-v3-671b`` with MLA, the
recurrent ``xlstm-125m`` with ``--engine slots``, ...).
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager, _flatten, _put, _unflatten_into
from repro_torch.config import MultiLevelConfig
from repro_torch.configs import get_config
from repro_torch.core import operators as ops
from repro_torch.data import stub_frontend_inputs
from repro_torch.device import default_device
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.distributed.multiprocess import ProcessShard, is_primary, put_global
from repro_torch.distributed.sharding import (local_slices, mesh_ctx, mesh_shape,
                                              split_factors)
from repro_torch.launch.paging import NULL_PAGE, BlockAllocator
from repro_torch.models import lm as lm_lib
from repro_torch.models.api import (build_model, make_paged_decode_step, make_prefill_step,
                                    make_serve_step, make_verify_step, serve_shardings)
from repro_torch.param import flatten, tree_map, zeros_tree


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # [S] int
    max_new: int
    out: List[int] = dataclasses.field(default_factory=list)


def zeros_cache(cfg, batch: int, max_seq: int, device):
    return zeros_tree(lm_lib.cache_specs(cfg, batch, max_seq), cfg.compute_dtype, device)


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
    at ``page_ids`` ([n_pg], logical page order), in place.  Shared by the
    paged engine's cold prompts and the speculative draft pool."""

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
    ``eng.commit(row, tokens)``.  The hooks below let a policy keep per-row
    state (the speculative draft pool) in step with the engine.
    """

    name = "base"

    def bind(self, eng: "EngineCore") -> None:
        """Attach once to a constructed engine (build steps, allocate
        policy-owned state).  Raise for an engine the policy cannot run on."""

    def tick(self, eng: "EngineCore") -> None:
        raise NotImplementedError

    def on_admit(self, eng: "EngineCore", row: int, req: Request) -> None:
        pass

    def on_complete(self, eng: "EngineCore", row: int, req: Request) -> None:
        pass

    def on_reset(self, eng: "EngineCore") -> None:
        pass

    def on_params(self, eng: "EngineCore") -> None:
        """Serving params changed (a reload); refresh derived state."""

    def stats(self) -> Dict[str, Any]:
        return {"policy": self.name}


class GreedyPolicy(DecodePolicy):
    """One full-model argmax token per tick (both engines)."""

    name = "greedy"

    def tick(self, eng: "EngineCore") -> None:
        act = [i for i, r in enumerate(eng.active) if r is not None]
        nxt = eng.decode_once()
        for i in act:
            eng.commit(i, [nxt[i]])


class SpeculativePolicy(DecodePolicy):
    """Self-speculative decoding from the coalesced level-1 draft model.

    Per tick and per active row: draft up to ``k`` tokens with the level-1
    model (its parameters are ``coalesce(serving params)``, refreshed by
    ``on_params``), score the run ``[last_tok, d_1..d_k]`` in ONE batched
    full-model verify step at positions ``pos..pos+k``, and commit the
    longest agreeing prefix plus the first disagreeing (or bonus) full-model
    argmax: at least one token per tick, up to k+1 per full-model step.

    Lossless: every committed token is ``argmax(verify logits)``; the draft
    only chooses which positions the verify step scores.

    Rollback: the verify step writes K/V for all k+1 positions in place.
    Rejected positions are rewound in the host's length bookkeeping only
    (``BlockAllocator.mark_written`` / ``rollback``): attention reads are
    position-masked and the next committed token overwrites the slot.  The
    draft pool is rewound the same way through ``draft_pos``.

    Paged engine only: the draft runs over its own page pool (never the
    main one) with the same block-table discipline.  On a mesh the draft is
    projected from the gathered serving weights and cut to its own
    ``serve_shardings`` (TinyLlama's level-1 draft: 16 query and 2 K/V
    heads, 8 and 1 a process on 1x2); its pool is laid out the same way and
    its steps and the verify step run in the engine's mesh context.  The
    bookkeeping stays on the host, identical on every process.
    """

    name = "speculative"

    def __init__(self, k: int = 4, ml: Optional[MultiLevelConfig] = None,
                 draft_width: bool = True, draft_depth: bool = True):
        if k < 1:
            raise ValueError(f"speculative draft length k must be >= 1, got {k}")
        self.k = k
        self.ml = ml or MultiLevelConfig()
        self.draft_width = draft_width
        self.draft_depth = draft_depth
        self._zero_stats()

    def _zero_stats(self) -> None:
        self.rounds = 0
        self.drafted_tokens = 0
        self.accepted_tokens = 0
        self.draft_time_s = 0.0
        self.verify_time_s = 0.0

    def bind(self, eng: "EngineCore") -> None:
        if not isinstance(eng, PagedServer):
            raise NotImplementedError(
                "speculative decoding requires the paged engine "
                "(engine='paged'); the slots oracle stays greedy-only")
        self.draft_cfg = ops.coalesce_config(eng.cfg, self.ml, width=self.draft_width,
                                             depth=self.draft_depth)
        self.draft_model = build_model(self.draft_cfg)
        # one worst-case table per batch row (+ the null page): draft
        # admission never fails while a row is free
        self._n_draft_pages = eng.batch * eng.max_pages_per_req + 1
        self._pool_sh, on_mesh = None, {}
        if eng.mesh is not None:
            psh, self._pool_sh, _ = serve_shardings(self.draft_model, eng.mesh,
                                                    n_pages=self._n_draft_pages,
                                                    page_size=eng.page_size)
            on_mesh = dict(in_shardings=eng._param_shardings, out_shardings=psh,
                           mesh=eng.mesh)
        _, self._project = ops.make_draft_projection(
            eng.model.specs(), eng.cfg, self.ml,
            width=self.draft_width, depth=self.draft_depth, **on_mesh)
        self.draft_params = self._project(eng.params)
        self.draft_prefill = make_prefill_step(self.draft_model)
        self.draft_step = make_paged_decode_step(self.draft_model)
        self.verify = make_verify_step(eng.model)
        if eng.mesh is not None:
            self.draft_prefill, self.draft_step, self.verify = map(
                eng._on_mesh, (self.draft_prefill, self.draft_step, self.verify))
        self._write_draft = make_write_prompt(eng.page_size)
        self._fresh(eng)

    def _fresh(self, eng: "PagedServer") -> None:
        self.draft_pages = eng._zeros_pool(self.draft_model, self._n_draft_pages,
                                           self._pool_sh)
        self.draft_alloc = BlockAllocator(self._n_draft_pages, eng.page_size,
                                          prefix_reuse=False)
        self.draft_tables: List[Optional[List[int]]] = [None] * eng.batch
        self.draft_pos = np.zeros((eng.batch,), np.int64)
        # the committed token at every position 0..pos, per row: the draft's
        # catch-up feed after a rejection
        self.hist: List[Optional[List[int]]] = [None] * eng.batch

    # -- lifecycle hooks ----------------------------------------------------
    def on_admit(self, eng: "PagedServer", row: int, req: Request) -> None:
        L = len(req.prompt)
        got = self.draft_alloc.admit(req.rid, req.prompt, min(L + req.max_new, eng.max_seq))
        if got is None:
            raise RuntimeError("the draft pool holds one table per row; admission failed")
        table, _ = got
        _, pc = self.draft_prefill(self.draft_params, eng._tensor(req.prompt)[None])
        n_pg = -(-L // eng.page_size)
        self.draft_pages = self._write_draft(self.draft_pages, pc,
                                             eng._tensor(table[:n_pg]))
        self.draft_tables[row] = table
        self.draft_pos[row] = L
        self.hist[row] = [int(t) for t in req.prompt] + [int(eng.last_tok[row])]

    def on_complete(self, eng: "PagedServer", row: int, req: Request) -> None:
        self.draft_alloc.complete(req.rid)
        self.draft_tables[row] = None
        self.draft_pos[row] = 0
        self.hist[row] = None

    def on_reset(self, eng: "PagedServer") -> None:
        self._fresh(eng)
        self._zero_stats()

    def on_params(self, eng: "PagedServer") -> None:
        # the draft is a pure function of the serving parameters
        self.draft_params = self._project(eng.params)

    # -- the speculative tick ----------------------------------------------
    def _draft_argmax(self, logits: torch.Tensor) -> np.ndarray:
        """Draft proposals from draft-step logits ([B, V] -> [B]).  A seam
        for tests: patching it to emit wrong tokens forces rejections
        without touching the verify path."""
        return torch.argmax(logits, -1).cpu().numpy()

    def _feed_token(self, eng: "PagedServer", i: int, p: int, proposals: List[int]) -> int:
        """Token at position ``p`` of row ``i``: committed history up to
        ``pos`` (catch-up), the row's own earlier proposal beyond it."""
        pos = int(eng.pos[i])
        if p <= pos:
            return self.hist[i][p]
        return proposals[p - pos - 1]

    def tick(self, eng: "PagedServer") -> None:
        act = [i for i, r in enumerate(eng.active) if r is not None]
        if not act:
            return
        self.rounds += 1
        # per-row window: never draft past the request's token budget or the
        # last cache index, so the verify writes stay inside the reserve
        k_i = {i: max(0, min(self.k,
                             eng.active[i].max_new - len(eng.active[i].out) - 1,
                             eng.max_seq - 1 - int(eng.pos[i])))
               for i in act}
        drafts: Dict[int, List[int]] = {i: [] for i in act}
        # draft phase: batched S=1 level-1 steps.  Row i feeds positions
        # draft_pos[i] .. pos[i]+k_i[i]-1: committed catch-up tokens first
        # (they overwrite rejected leftovers before a later query can attend
        # them), then its own fresh proposals.
        t0 = time.time()
        starts = {i: int(self.draft_pos[i]) for i in act}
        ends = {i: int(eng.pos[i]) + k_i[i] for i in act}
        M_b = _bucket(max(len(self.draft_tables[i]) for i in act), cap=eng.max_pages_per_req)
        for j in range(max(ends[i] - starts[i] for i in act)):
            rows = [i for i in act if starts[i] + j < ends[i]]
            if not rows:
                break
            toks = np.zeros((eng.batch, 1), np.int64)
            poss = np.full((eng.batch, 1), -1, np.int64)  # idle row: null page
            bt = np.full((eng.batch, M_b), NULL_PAGE, np.int64)
            for i in rows:
                p = starts[i] + j
                toks[i, 0] = self._feed_token(eng, i, p, drafts[i])
                poss[i, 0] = p
                bt[i, :len(self.draft_tables[i])] = self.draft_tables[i]
            logits, self.draft_pages = self.draft_step(
                self.draft_params, self.draft_pages, eng._tensor(toks), eng._tensor(poss),
                eng._tensor(bt))
            nxt = self._draft_argmax(logits)
            for i in rows:
                if starts[i] + j >= int(eng.pos[i]):  # predicts a position > pos
                    drafts[i].append(int(nxt[i]))
        for i in act:
            self.draft_pos[i] = ends[i]
        self.draft_time_s += time.time() - t0
        self.drafted_tokens += sum(k_i.values())
        # verify phase: ONE batched full-model step scores [last_tok, d_1..d_k]
        # at positions pos..pos+k through the block tables (right-padded
        # rows: positions -1, null-page writes, masked attention)
        t0 = time.time()
        S_b = _bucket(max(k_i[i] for i in act) + 1)
        toks = np.zeros((eng.batch, S_b), np.int64)
        poss = np.full((eng.batch, S_b), -1, np.int64)
        M_b = _bucket(max(len(eng.tables[i]) for i in act), cap=eng.max_pages_per_req)
        bt = np.full((eng.batch, M_b), NULL_PAGE, np.int64)
        for i in act:
            n = k_i[i] + 1
            toks[i, :n] = [int(eng.last_tok[i])] + drafts[i]
            poss[i, :n] = np.arange(int(eng.pos[i]), int(eng.pos[i]) + n)
            bt[i, :len(eng.tables[i])] = eng.tables[i]
            eng.alloc.mark_written(eng.active[i].rid, int(eng.pos[i]) + n)
        logits, eng.pages = self.verify(eng.params, eng.pages, eng._tensor(toks),
                                        eng._tensor(poss), eng._tensor(bt))
        full = torch.argmax(logits, -1).cpu().numpy()  # [B, S_b]
        self.verify_time_s += time.time() - t0
        # acceptance: the longest agreeing prefix + one full-model token
        for i in act:
            req = eng.active[i]
            g, d = full[i], drafts[i]
            m = 0
            while m < k_i[i] and g[m] == d[m]:
                m += 1
            # g[:m] matched the draft; g[m] is the bonus or the correction
            emitted = [int(t) for t in g[:m + 1]]
            self.accepted_tokens += m
            eng.commit(i, emitted)
            if eng.active[i] is req:  # still running: rewind the speculation
                self.hist[i].extend(emitted)
                eng.alloc.rollback(req.rid)
                self.draft_pos[i] = min(int(self.draft_pos[i]), int(eng.pos[i]))

    def stats(self) -> Dict[str, Any]:
        return {
            "policy": self.name,
            "draft_k": self.k,
            "spec_rounds": self.rounds,
            "drafted_tokens": self.drafted_tokens,
            "accepted_tokens": self.accepted_tokens,
            "accept_rate": (self.accepted_tokens / self.drafted_tokens
                            if self.drafted_tokens else 0.0),
            "draft_time_s": round(self.draft_time_s, 4),
            "verify_time_s": round(self.verify_time_s, 4),
        }


# ---------------------------------------------------------------------------
# live weight reload


class ManifestWatcher:
    """Polls a checkpoint directory's ``manifest.json`` and lands new serving
    weights by digest diff -- the train-to-serve hand-off.

    Per :meth:`poll`:

      1. ``mgr.latest()`` reads the current manifest (one small file).
      2. Steps already examined are skipped, as are steps whose ``params``
         tree does not match the serving model's shapes: a mid-V-cycle
         checkpoint carries COALESCED parameters, and only level-0 weights
         can be served.
      3. Each leaf's chunk digests are diffed against what the watcher
         landed last time; only changed leaves are read and moved to the
         device (``CheckpointManager.assemble_diff``).  Unchanged leaves keep
         the tensors landed before, by identity.  Leaves land on the
         like-tree's devices; with ``shardings`` (a spec tree) and ``mesh``,
         each as this process's block of the global leaf, the layout of a
         mesh-sharded server's parameters.

    A step directory removed by the trainer's keep-last GC between the
    manifest read and the assembly counts one ``poll_errors`` and is tried
    again on the next poll.  The result goes to
    ``EngineCore.request_reload``.
    """

    def __init__(self, mgr: CheckpointManager, like, shardings=None, mesh=None,
                 key: str = "params"):
        self.mgr = mgr
        self.key = key
        if shardings is not None:
            # local blocks as pieces of the global leaves: shapes compare
            # globally, and a landed leaf is cut to the block
            like = tree_map(lambda t, spec: _block_of(t, spec, mesh), like, shardings)
        self.like = like
        self._flat_like = _flatten(like)
        self.last_step = -1                # newest step actually landed
        self._seen = -1                    # newest step examined (skips too)
        self._sig: Dict[str, Tuple[str, ...]] = {}
        self._landed: Dict[str, Any] = {}
        self.steps_seen: List[int] = []
        self.steps_skipped: List[int] = []
        self.reload_history: List[Dict[str, Any]] = []
        self.last_reload_stats: Dict[str, Any] = {}
        self.poll_errors = 0

    def _shapes_match(self, entries) -> bool:
        if set(entries) != set(self._flat_like):
            return False
        return all(tuple(entries[k]["shape"]) == tuple(np.shape(self._flat_like[k]))
                   for k in entries)

    def poll(self) -> Optional[Tuple[int, Any]]:
        """``(step, params)`` when new weights landed, else None."""
        m = self.mgr.latest()
        if m is None or int(m["step"]) <= self._seen:
            return None
        step = int(m["step"])
        try:
            trees = self.mgr.step_manifest(m)
            if trees is None:
                raise ValueError(
                    "live reload needs the content-addressed (v3) checkpoint "
                    "layout; this step publishes no digest manifest to diff "
                    "(saved with dedup=False?)")
            entries = trees.get(self.key, {})
            if not self._shapes_match(entries):
                self._seen = step
                self.steps_skipped.append(step)
                return None
            sig = {k: tuple(ch["digest"] for ch in rec["chunks"])
                   for k, rec in entries.items()}
            changed = sorted(k for k in sig if self._sig.get(k) != sig[k])
            flat_new = self.mgr.assemble_diff(trees, self.key, changed)
        except FileNotFoundError as e:
            # the trainer's keep-last GC removed the step (or an object of
            # it) after the manifest read; a newer publish exists.  In a
            # local dir whose newest step still lacks an object, the object
            # is on another host: every rank keeps its own FSDP blocks
            if self.mgr.local and int((self.mgr.latest() or {"step": -1})["step"]) == step:
                raise FileNotFoundError(
                    f"step {step} in the local dir {self.mgr.dir} lacks an object that no "
                    f"pool read here holds ({e}): a checkpoint written by several "
                    "processes keeps each rank's blocks in its own local dir; name the "
                    "other ranks' dirs as peer_dirs (the serving CLI's "
                    "--reload-peer-dirs)") from e
            self.poll_errors += 1
            return None
        for k in changed:
            self._landed[k] = _put(flat_new[k], self._flat_like[k])
        self._sig = sig
        self._seen = self.last_step = step
        self.steps_seen.append(step)
        self.last_reload_stats = {
            "step": step, "leaves": len(sig), "changed": len(changed),
            "reused": len(sig) - len(changed),
            **{f"gather_{k}": v for k, v in self.mgr.last_gather_stats.items()}}
        self.reload_history.append(self.last_reload_stats)
        return step, _unflatten_into(dict(self._landed), self.like)


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
        # reload state: staged weights swap at a tick boundary once every
        # in-flight request has finished (request_reload / maybe_swap)
        self._pending_params = None
        self.reloads = 0
        self._watcher: Optional[ManifestWatcher] = None
        self._watch_every = 1
        # engines call self.policy.bind(self) once fully constructed

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

    def _place_params(self, params):
        """Engine hook: commit new params to the engine's layout (here: its
        device; the mesh-sharded paged engine cuts this process's blocks)."""
        return tree_map(lambda t: t.to(self.device), params)

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
        if self._pending_params is not None:
            # a staged swap drains the engine first: a request admitted now
            # would start on the OLD weights; it waits at the queue head
            return False
        row = next((i for i, r in enumerate(self.active) if r is None), None)
        if row is None:
            return False
        first = self._place(row, req)
        if first is None:
            return False
        self.active[row] = req
        self.pos[row] = len(req.prompt)
        self.last_tok[row] = first
        self.policy.on_admit(self, row, req)
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
                self.policy.on_complete(self, row, req)
                break

    def _on_token(self, row: int, req: Request) -> None:
        pass

    def step(self) -> None:
        # the tick boundary: a staged reload lands once the engine is drained,
        # before the idle early-out (or a pending swap with an empty engine
        # and a waiting queue would never land)
        self.maybe_swap()
        if not any(r is not None for r in self.active):
            return
        self.policy.tick(self)

    def run(self, requests: List[Request], max_ticks: int = 10_000) -> List[Request]:
        """Drain ``requests``: admit into free rows, decode, recycle rows.
        Oversized prompts go to ``self.rejected``; a request that lacks
        resources now waits at the queue head for completions.  An attached
        :class:`ManifestWatcher` is polled every ``poll_every`` ticks; what it
        lands is staged with :meth:`request_reload`."""
        queue = list(requests)
        ticks = 0
        while (queue or any(self.active)) and ticks < max_ticks:
            if (self._watcher is not None and not self.reload_pending()
                    and ticks % self._watch_every == 0):
                got = self._watcher.poll()
                if got is not None:
                    self.request_reload(got[1])
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
        # a reload staged on the last tick still lands: the next run starts
        # on the newest weights
        self.maybe_swap()
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
        self.policy.on_reset(self)

    def set_params(self, params) -> None:
        """Swap the serving weights NOW (the model's global tree, placed on
        this engine's layout by :meth:`_place_params`): in-flight rows
        decode their next token under the new weights.  Weight-derived
        caches are dropped and the policy refreshes its own.  Live serving
        goes through :meth:`request_reload`, which defers this to a drained
        tick."""
        self.params = self._place_params(params)
        self._on_params_engine()
        self.policy.on_params(self)

    # -- live weight reload ---------------------------------------------------
    def request_reload(self, params) -> bool:
        """Stage ``params`` for a tick-boundary swap; True when the engine was
        drained and the swap happened now.  In-flight requests finish under
        the weights they started on, new admissions wait until the swap, and
        nothing is dropped.  Re-staging before the swap replaces the staged
        tree: only the newest weights swap in."""
        self._pending_params = params
        return self.maybe_swap()

    def reload_pending(self) -> bool:
        return self._pending_params is not None

    def maybe_swap(self) -> bool:
        """Land a staged reload if no request is in flight; True on a swap."""
        if self._pending_params is None or any(r is not None for r in self.active):
            return False
        params, self._pending_params = self._pending_params, None
        self.set_params(params)
        self.reloads += 1
        return True

    def attach_watcher(self, watcher: ManifestWatcher, poll_every: int = 1) -> None:
        """Poll ``watcher`` from :meth:`run` every ``poll_every`` ticks."""
        self._watcher = watcher
        self._watch_every = max(1, poll_every)

    def stats(self) -> Dict[str, Any]:
        return dict(self.policy.stats())


class Server(EngineCore):
    """Fixed-slot engine over dense ``[batch, max_seq]`` caches -- the
    equivalence oracle of the paged engine."""

    engine_name = "slots"

    def __init__(self, cfg, batch: int = 4, max_seq: int = 128,
                 policy: Optional[DecodePolicy] = None, device="cuda"):
        super().__init__(cfg, batch, max_seq, policy, device)
        self.decode = make_serve_step(self.model)
        self.cache = zeros_cache(cfg, batch, max_seq, self.device)
        # the VLM's and the encoder-decoder's stub frontends: every prefill
        # attends to (or encodes) ones, as in the reference
        self._extras = stub_frontend_inputs(cfg, 1, self.device)
        self.policy.bind(self)

    def _place(self, row: int, req: Request) -> Optional[int]:
        logits, pc = self.prefill(self.params, self._tensor(req.prompt)[None], **self._extras)
        self.cache = self._splice(pc, row)
        return int(torch.argmax(logits[0]))

    @torch.inference_mode()
    def _splice(self, prefill_cache, slot: int):
        """Copy a prefill cache ([layers, 1, ...] leaves) into row ``slot`` of
        the dense caches, in place, by the reference's rule: a leaf whose
        axis 2 differs and whose trailing shapes agree is a K/V sequence
        (L tokens, zeros past L); any other leaf, a recurrent state or the
        cross K/V (axis 2 the source's length in both), is copied whole."""

        def one(b, s):
            L = s.shape[2]
            if L != b.shape[2] and s.shape[3:] == b.shape[3:]:
                b[:, slot, :L] = s[:, 0].to(b.dtype)
                b[:, slot, L:] = 0
            else:
                b[:, slot] = s[:, 0].to(b.dtype)
            return b

        return tree_map(one, self.cache, prefill_cache)

    def decode_once(self) -> np.ndarray:
        logits, self.cache = self.decode(self.params, self.cache,
                                         self._tensor(self.last_tok)[:, None],
                                         self._tensor(self.pos))
        return torch.argmax(logits, -1).cpu().numpy()


class PagedServer(EngineCore):
    """Paged-KV engine: block tables over a shared page pool + prefix reuse.

    Admission reserves the request's worst-case page count up front
    (``ceil(min(len(prompt)+max_new, max_seq) / page_size)``), so an admitted
    request never stalls on allocation mid-decode, and a speculative burst
    of k+1 writes always lands inside the reserve.  Cache-hit prompts run a
    bucketed "extend" step over just the non-shared tail.

    With a ``mesh`` (one process per device, ("data", "model") or ("pod",
    "data", "model")) this process holds its blocks of the parameters and
    page pools as ``serve_shardings`` lays them out and runs the prefill
    and paged steps in ``mesh_ctx``; the scheduling is unchanged, and every
    process runs it on the same tokens.
    """

    engine_name = "paged"

    def __init__(self, cfg, batch: int = 4, max_seq: int = 128,
                 page_size: int = 16, n_pages: Optional[int] = None,
                 prefix_reuse: bool = True,
                 policy: Optional[DecodePolicy] = None, device="cuda",
                 mesh=None):
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
        self.mesh = mesh
        self._param_shardings = None
        if mesh is not None:
            self._shard()
        self.policy.bind(self)

    def _shard(self) -> None:
        """Cut the parameters and pools to this process's blocks and run the
        steps in the mesh context (see the class docstring)."""
        self._param_shardings, csh, _ = serve_shardings(
            self.model, self.mesh, n_pages=self.n_pages, page_size=self.page_size)
        for key, spec in flatten(self._param_shardings).items():
            for entry in spec:  # the MoE computes experts over "model" or model-major
                if entry == "data" or (isinstance(entry, tuple) and "data" in entry
                                       and entry != tp.EXPERTS_SERVE):
                    raise NotImplementedError(
                        f"{self.cfg.name}: {key} splits over {entry} on the serving mesh "
                        f"{dict(mesh_shape(self.mesh))}; only experts over "
                        f"{tp.EXPERTS_SERVE} (model-major) are served")
        self.params = self._place_params(self.params)
        self.pages = self._zeros_pool(self.model, self.n_pages, csh)
        self.prefill = self._on_mesh(self.prefill)
        self.paged_step = self._on_mesh(self.paged_step)

    def _zeros_pool(self, model, n_pages: int, shardings):
        """Zero page pools of ``model`` for ``n_pages``: whole, or this
        process's blocks under ``shardings`` (a ``serve_shardings`` pool
        tree)."""
        if shardings is None:
            return zeros_paged_cache(model.cfg, n_pages, self.page_size, self.device)
        return tree_map(
            lambda s, spec: torch.zeros(_block_shape(s.shape, spec, self.mesh),
                                        dtype=s.dtype or model.cfg.compute_dtype,
                                        device=self.device),
            model.paged_cache_specs(n_pages, self.page_size), shardings)

    def _on_mesh(self, step):
        def run(*args, **kw):
            with mesh_ctx(self.mesh):
                return step(*args, **kw)

        return run

    # -- stats ---------------------------------------------------------------
    @property
    def prefill_tokens_saved(self) -> int:
        return self.alloc.reused_tokens_total

    @property
    def pages_in_use_peak(self) -> int:
        return self.alloc.pool.in_use_peak

    def stats(self) -> Dict[str, Any]:
        out = {
            "pages_in_use_peak": self.pages_in_use_peak,
            "pages_capacity": self.alloc.pool.capacity,
            "prefill_tokens_saved": self.prefill_tokens_saved,
            "prefill_tokens_computed": self.prefill_tokens_computed,
            "rolled_back_positions": self.alloc.rolled_back_total,
            **self.policy.stats(),
        }
        if self.mesh is not None:
            # the pools' whole size on the mesh, and this process's blocks of it
            specs = flatten(self.model.paged_cache_specs(self.n_pages, self.page_size))
            local = flatten(self.pages)
            out["mesh"] = "x".join(str(n) for n in mesh_shape(self.mesh).values())
            out["pool_bytes_global"] = sum(
                math.prod(s.shape) * local[k].element_size() for k, s in specs.items())
            out["pool_bytes_local"] = sum(t.numel() * t.element_size()
                                          for t in local.values())
        return out

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

    def _place_params(self, params):
        """Move ``params`` to the device; on a mesh, cut each global leaf to
        this process's block (a leaf that is the block already, as a
        ``ManifestWatcher`` with shardings lands it, only moves)."""
        if self.mesh is None:
            return super()._place_params(params)

        def one(x, spec, s):
            if tuple(x.shape) == tuple(s.shape):
                return put_global(x, spec, self.mesh, device=self.device)
            if tuple(x.shape) == _block_shape(s.shape, spec, self.mesh):
                return x.to(self.device)
            raise ValueError(f"a leaf of shape {tuple(x.shape)} is neither the global "
                             f"{tuple(s.shape)} nor this process's block of it")

        return tree_map(one, params, self._param_shardings, self.model.specs())

    def _on_params_engine(self) -> None:
        # cached prompt pages hold K/V computed under the old weights
        self.alloc.invalidate_prefix()


def _block_shape(shape, spec, mesh) -> Tuple[int, ...]:
    """The shape of one process's block of a ``shape`` array under ``spec``."""
    return tuple(d // n for d, n in zip(shape, split_factors(spec, mesh)))


def _block_of(t: torch.Tensor, spec, mesh) -> ProcessShard:
    """A local block ``t`` as this process's piece of its global leaf."""
    f = split_factors(spec, mesh)
    shape = tuple(d * n for d, n in zip(t.shape, f))
    return ProcessShard(t, shape, tuple(sl.start for sl in local_slices(shape, spec, mesh)))


POLICIES = ("greedy", "speculative")
ENGINES = ("paged", "slots")


def make_server(cfg, engine: str = "paged", batch: int = 4, max_seq: int = 128,
                page_size: int = 16, n_pages: Optional[int] = None,
                prefix_reuse: bool = True,
                policy: "str | DecodePolicy" = "greedy",
                draft_k: int = 4,
                draft_ml: Optional[MultiLevelConfig] = None,
                device=None, mesh=None) -> EngineCore:
    """An engine with its policy; ``mesh`` (paged engine only) serves with
    every parameter and page pool sharded over its "model" axis
    (``PagedServer``)."""
    if isinstance(policy, str):
        if policy == "greedy":
            pol: DecodePolicy = GreedyPolicy()
        elif policy == "speculative":
            pol = SpeculativePolicy(k=draft_k, ml=draft_ml)
        else:
            raise ValueError(f"unknown policy {policy!r}; expected one of "
                             f"{POLICIES} or a DecodePolicy instance")
    elif isinstance(policy, DecodePolicy):
        pol = policy
    else:
        raise TypeError(f"policy must be one of {POLICIES} or a DecodePolicy "
                        f"instance, got {type(policy).__name__}")
    if engine == "slots":
        if mesh is not None:
            raise ValueError("mesh-sharded decode requires the paged engine "
                             "(--engine paged); the slots oracle stays "
                             "single-device")
        return Server(cfg, batch=batch, max_seq=max_seq, policy=pol,
                      device=default_device(device))
    if engine == "paged":
        return PagedServer(cfg, batch=batch, max_seq=max_seq, page_size=page_size,
                           n_pages=n_pages, prefix_reuse=prefix_reuse, policy=pol,
                           device=default_device(device), mesh=mesh)
    raise ValueError(f"unknown engine {engine!r}; expected one of {ENGINES}")


def main(argv=None):
    """The serving CLI; returns ``(server, watcher or None, finished
    requests)``.  With ``--mesh`` the process group stays up for the
    returned server (the script's own entry point tears it down)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction, default=True)
    ap.add_argument("--engine", choices=ENGINES, default="paged")
    ap.add_argument("--policy", choices=POLICIES, default="greedy")
    ap.add_argument("--draft-k", type=int, default=4,
                    help="tokens the speculative policy drafts per round")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--no-prefix-reuse", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; fails when absent)")
    ap.add_argument("--mesh", default="",
                    help="DxM ('data', 'model') serving mesh, e.g. 1x2 or 2x2: the paged "
                         "engine's parameters and page pools sharded over 'model' and "
                         "replicated over 'data', experts over both; one process per "
                         "device (--num-processes D*M)")
    ap.add_argument("--coordinator", default="127.0.0.1:9876",
                    help="host:port of process 0's process-group store (several "
                         "processes), or file://PATH: process 0 binds a free port "
                         "and writes it there")
    ap.add_argument("--num-processes", type=int, default=1,
                    help="process count; every process runs the same command with its "
                         "own --process-id")
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--reload-from", default="",
                    help="checkpoint dir to poll for live weight reloads (a trainer's "
                         "--ckpt-dir); new level-0 steps swap in at tick boundaries "
                         "without dropping in-flight requests")
    ap.add_argument("--reload-local", action="store_true",
                    help="treat --reload-from as a per-host local checkpoint dir (no "
                         "shared filesystem; missing objects gather over the process "
                         "group's store)")
    ap.add_argument("--reload-peer-dirs", nargs="+", default=[], metavar="DIR",
                    help="with --reload-local: the other ranks' local dirs of a "
                         "checkpoint that several training processes wrote (each "
                         "keeps its own FSDP blocks), read directly")
    ap.add_argument("--poll-every", type=int, default=1,
                    help="poll the reload manifest every N scheduler ticks")
    args = ap.parse_args(argv)
    if args.num_processes > 1 and not args.mesh:
        ap.error("several processes serve one model on a mesh: give --mesh DxM")
    if args.reload_peer_dirs and not args.reload_local:
        ap.error("--reload-peer-dirs reads other ranks' local dirs: give --reload-local")

    cfg = get_config(args.arch, smoke=args.smoke)
    dev = default_device(args.device)
    mesh = None
    if args.mesh:
        from repro_torch.launch.mesh import init_distributed, make_cli_mesh, rank_device

        if args.num_processes > 1:
            dev = rank_device(dev, args.process_id)
            init_distributed(args.coordinator, args.num_processes, args.process_id,
                             device=dev)
        mesh = make_cli_mesh(args.mesh, num_processes=args.num_processes, device=dev)
    primary = is_primary()
    srv = make_server(cfg, engine=args.engine, batch=args.batch,
                      max_seq=args.max_seq, page_size=args.page_size,
                      prefix_reuse=not args.no_prefix_reuse,
                      policy=args.policy, draft_k=args.draft_k, device=dev, mesh=mesh)
    watcher = None
    if args.reload_from:
        mgr = CheckpointManager(args.reload_from, local=args.reload_local,
                                peer_dirs=args.reload_peer_dirs)
        watcher = ManifestWatcher(mgr, like=srv.params,
                                  shardings=getattr(srv, "_param_shardings", None), mesh=mesh)
        srv.attach_watcher(watcher, poll_every=args.poll_every)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, size=rng.integers(4, 12)),
                    max_new=args.max_new) for i in range(args.requests)]
    tp.reset_counts()
    t0 = time.time()
    done = srv.run(reqs)
    if srv.device.type == "cuda":
        torch.cuda.synchronize(srv.device)
    dt = time.time() - t0
    if not primary:
        return srv, watcher, done
    tok = sum(len(r.out) for r in done)
    where = f"device={srv.device}" + (f" mesh={args.mesh} collectives={tp.counts()}"
                                      if mesh is not None else "")
    print(f"[serve] engine={args.engine} policy={args.policy} {where}: "
          f"{len(done)} requests, {tok} tokens in {dt:.1f}s "
          f"({tok/max(dt,1e-9):.1f} tok/s, batch={args.batch})")
    print(f"[serve] {srv.stats()}")
    if watcher is not None:
        print(f"[serve] reloads={srv.reloads} steps_seen={watcher.steps_seen} "
              f"steps_skipped={watcher.steps_skipped} "
              f"last={watcher.last_reload_stats}")
    for r in done[:3]:
        print(f"  req {r.rid}: prompt[:4]={r.prompt[:4].tolist()} -> out[:8]={r.out[:8]}")
    return srv, watcher, done


if __name__ == "__main__":
    main()
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
