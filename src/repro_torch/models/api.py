"""Public model facade + step builders (the counterpart of
``repro/models/api.py``: ``Model``, ``build_model``, ``make_train_step``,
``make_eval_loss``, ``init_train_state``, ``train_state_specs``,
``train_state_shardings``, ``zero_train_state``, ``make_prefill_step``,
``make_serve_step``, ``make_paged_decode_step``, ``make_verify_step``,
``serve_shardings``).

The serving steps run under ``torch.inference_mode()``; the train step runs
with autograd on and updates the parameters and optimizer state in place.
On a mesh each process holds its blocks of the train state under the
training ``RULES`` (``train_state_shardings``): split over the data axes by
``embed`` (FSDP) and over "model" by the tensor and expert axes.  The step
runs in ``mesh_ctx``: the layers meet at the collectives of
``distributed/tensor_parallel.py`` (forward and backward) on weights whole
over the data axes, which ``distributed/fsdp.py`` gathers (per layer, per
step, or once at the entry of an explicit reduction), the metrics' mean
runs over the data axes, and the clipping norm sums every leaf over the
axes it is split on.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch
import torch.distributed as dist

from repro_torch.config import ModelConfig, TrainConfig
from repro_torch.distributed import fsdp
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.distributed.sharding import RULES, _entry_axes, mesh_ctx, mesh_shape
from repro_torch.kernels import dispatch as kdispatch
from repro_torch.models import lm as lm_lib
from repro_torch.models import vit as vit_lib
from repro_torch.device import default_device
from repro_torch.optim import adamw_init, adamw_init_specs, adamw_update
from repro_torch.optim.adamw import clip_scale, sum_squares
from repro_torch.param import flatten, init_tree, tree_map, unflatten, zeros_tree


@dataclasses.dataclass
class Model:
    cfg: ModelConfig

    def specs(self):
        if self.cfg.family == "vit":
            return vit_lib.vit_specs(self.cfg)
        return lm_lib.lm_specs(self.cfg)

    def cache_specs(self, batch: int, max_seq: int):
        return lm_lib.cache_specs(self.cfg, batch, max_seq)

    def paged_cache_specs(self, n_pages: int, page_size: int):
        return lm_lib.paged_cache_specs(self.cfg, n_pages, page_size)

    def init(self, gen: torch.Generator):
        """Random parameters on ``gen.device``, drawn from ``gen``."""
        return init_tree(gen, self.specs(), dtype=self.cfg.param_dtype)

    def projection_plan(self, ml=None, *, width: bool = True, depth: bool = True):
        """This model's :class:`~repro_torch.core.plans.ProjectionPlan` for
        one level transition: the family contract the V-cycle, the baselines
        and the serving draft projection share (coalescible axes, protected
        axes, role overrides, carried MoE scalars, ``small_cfg``)."""
        from repro_torch.core.plans import build_plan

        return build_plan(self.cfg, ml, width=width, depth=depth)

    def loss(self, params, batch: Dict[str, torch.Tensor], z_loss: float = 0.0):
        """(loss, metrics) of a ``{"tokens", "labels"}`` batch (plus
        ``img_embeds`` for the VLM family, ``enc_frames`` for the audio
        one), or of a ``{"patches", "labels"}`` batch for the ViT family.
        On a head split over "model" the logits stay split through the loss
        (``lm_forward(vocab_split=True)``): no process gathers them."""
        if self.cfg.family == "vit":
            logits = vit_lib.vit_forward(params, batch["patches"], self.cfg)
            return vit_lib.vit_loss(logits, batch["labels"])
        cfg = self.cfg
        out = lm_lib.lm_forward(params, batch["tokens"], cfg, mode="train",
                                img_embeds=batch.get("img_embeds"),
                                enc_frames=batch.get("enc_frames"), vocab_split=True)
        mtp_labels = None
        if cfg.mtp_depth:  # token t + 2: the labels shifted left, -1 at the end
            lbl = batch["labels"]
            mtp_labels = torch.cat([lbl[:, 1:], torch.full_like(lbl[:, :1], -1)], dim=1)
        return lm_lib.lm_loss(out["logits"], batch["labels"], cfg, out["aux"],
                              out.get("mtp_logits"), mtp_labels, z_loss,
                              vocab_axes=out["vocab_axes"])

    def forward_logits(self, params, batch) -> torch.Tensor:
        """The whole ``[B, S, V]`` logits on every process (gathered over
        "model" where the head is split), as a distillation loss reads
        them."""
        if self.cfg.family == "vit":
            return vit_lib.vit_forward(params, batch["patches"], self.cfg)
        return lm_lib.lm_forward(params, batch["tokens"], self.cfg, mode="train",
                                 img_embeds=batch.get("img_embeds"),
                                 enc_frames=batch.get("enc_frames"))["logits"]


def build_model(cfg: ModelConfig) -> Model:
    if cfg.kernel_backend:
        # fail fast on a typo'd backend instead of at the first attention call
        kdispatch.validate_backend(cfg.kernel_backend)
    lm_lib.check_supported(cfg)
    return Model(cfg)


# ---------------------------------------------------------------------------
# step builders


def make_train_step(model: Model, tc: TrainConfig, *, grad_reduce=None,
                    mesh=None, drain_flag=None) -> Callable:
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics); ``params`` and ``opt_state`` are updated in place and returned.

    The batch moves to the parameters' device.  With ``tc.grad_accum > 1``
    the batch leaves carry a leading microbatch axis of size grad_accum; the
    step loops over it and averages gradients (f32) and metrics.  Metrics
    are device scalars except ``lr`` (a float).

    With a ``mesh`` and no ``grad_reduce`` the step is the reference's plain
    step on its FSDP layout: ``params`` and ``opt_state`` are this process's
    blocks (``train_state_shardings``), ``batch`` its rows, and the weights
    are gathered per layer, or once a step with ``tc.pregather_params``
    (``distributed/fsdp.py``); see ``_make_fsdp_train_step``.

    With a ``grad_reduce`` strategy (``distributed/reduce.py``) and a
    ``mesh`` the step is the explicit-reduction one and 4-ary, as the
    reference's: ``train_step(params, opt_state, ef, batch) -> (params,
    opt_state, ef, metrics)``, ``ef`` the strategy's carried state (None for
    a stateless one); see ``_make_reduce_train_step``.

    On a mesh a ``drain_flag`` (``distributed.FusedDrainFlag``) rides the
    step's metrics all-reduce as one more element: the preemption OR over
    every process, at no extra collective.
    """
    if grad_reduce is not None:
        if mesh is None:
            raise ValueError("grad_reduce requires a mesh")
        return _make_reduce_train_step(model, tc, grad_reduce, drain_flag)
    if mesh is not None:
        return _make_fsdp_train_step(model, tc, mesh, drain_flag)
    if drain_flag is not None:
        raise ValueError("a drain flag rides the mesh step's all-reduce: it needs a mesh")
    grads_of = _grads_fn(model, tc)

    def train_step(params, opt_state, batch):
        keys = list(flatten(params))
        leaves = list(flatten(params).values())
        for p in leaves:
            p.requires_grad_(True)
        grads, metrics = _local_grads(grads_of, leaves, params, batch, tc)
        grad_tree = unflatten(dict(zip(keys, grads)))
        params, opt_state, om = adamw_update(params, grad_tree, opt_state, tc)
        return params, opt_state, {**metrics, **om}

    return train_step


def _grads_fn(model: Model, tc: TrainConfig) -> Callable:
    """grads_of(leaves, params, micro) -> (gradients of ``leaves``, metrics)."""

    def grads_of(leaves, params, micro):
        with torch.enable_grad():
            loss, metrics = model.loss(params, micro, z_loss=tc.z_loss)
            # a leaf the loss does not read (Whisper's ungated cross gate)
            # gets zeros, as the reference's gradient gives it
            grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
        return list(grads), {k: v.detach() for k, v in metrics.items()}

    return grads_of


def _local_grads(grads_of, leaves, params, batch, tc: TrainConfig):
    """(gradients, metrics) of this process's batch, averaged over the
    ``tc.grad_accum`` microbatches (accumulated in f32)."""
    dev = leaves[0].device
    batch = {k: v.to(dev) for k, v in batch.items()}
    if tc.grad_accum <= 1:
        return grads_of(leaves, params, batch)
    grads, metrics = grads_of(leaves, params, {k: v[0] for k, v in batch.items()})
    grads = [g.float() for g in grads]
    for i in range(1, tc.grad_accum):
        g_i, m_i = grads_of(leaves, params, {k: v[i] for k, v in batch.items()})
        grads = [a + b.float() for a, b in zip(grads, g_i)]
        metrics = {k: metrics[k] + m_i[k] for k in metrics}
    inv = 1.0 / tc.grad_accum
    return [g * inv for g in grads], {k: m * inv for k, m in metrics.items()}


class _Layout:
    """Where the leaves of ``model``'s parameters lie on ``mesh`` under the
    training rules: ``data[path]`` is ``fsdp.layout``'s (dimension, data
    axes) of a leaf split over data (None for one whole over them), and
    ``on_model[path]`` says whether it is split over "model"."""

    def __init__(self, model: Model, mesh):
        from repro_torch.distributed.reduce import axis_group
        from repro_torch.distributed.sharding import data_axes, param_shardings

        self.mesh = mesh
        specs = model.specs()
        self.data = fsdp.layout(specs, mesh)
        sizes = mesh_shape(mesh)
        self.n_model = sizes.get("model", 1)
        self.on_model = {k: self.n_model > 1 and any("model" in _entry_axes(e) for e in sp)
                         for k, sp in flatten(param_shardings(specs, mesh)).items()}
        self.data_axes = data_axes(mesh)
        self.n_data = 1
        for a in self.data_axes:
            self.n_data *= sizes[a]
        self.group = axis_group(mesh, self.data_axes) if self.n_data > 1 else None


def _clip_over_model(lay: _Layout, split, whole, drain, max_norm):
    """(the clipping pair, the drain flag summed over "model"): ``split``
    is the sum of squares of this process's blocks of the "model"-split
    leaves and ``whole`` that of the leaves whole over "model" (counted
    once), both already summed over the data axes.  On a "model" axis one
    sum over it completes ``split`` and carries ``drain`` (a device scalar
    or None)."""
    if lay.n_model > 1:
        flag = drain if drain is not None else torch.zeros_like(split)
        both = tp.all_reduce_sum(torch.stack([split, flag.to(split.dtype)]))
        split = both[0]
        if drain is not None:
            drain = both[1]
    return clip_scale(split + whole, max_norm), drain


def _metrics_and_drain(metrics, drain_flag, extra=()):
    """The metrics (and the drain flag's element, and ``extra`` tensors,
    flattened) as one vector in float32 or the widest of their types, for
    one all-reduce (an f64 model's loss is not rounded to f32 on the way)."""
    names = list(metrics)
    vals = [metrics[k].reshape(1) for k in names]
    if drain_flag is not None:
        vals.append(torch.full((1,), drain_flag.value(), device=vals[0].device))
    vals += [t.reshape(-1) for t in extra]
    wide = torch.float32
    for t in vals:
        wide = torch.promote_types(wide, t.dtype)
    return names, torch.cat([v.to(wide) for v in vals])


def _make_fsdp_train_step(model: Model, tc: TrainConfig, mesh, drain_flag=None) -> Callable:
    """The reference's plain step on its FSDP layout, spelled out: local
    gradients through the weight gathers of ``distributed/fsdp.py`` (per
    layer, re-gathered by a remat backward; or with ``tc.pregather_params``
    the whole tree cast to ``compute_dtype`` and gathered once before the
    microbatch loop, its gradient reduce-scattered once in ``compute_dtype``
    and cast to the parameters' dtype, as the reference's ``pull``).  Each
    process's loss is the global batch's loss on its rows
    (``fsdp.batch_mean`` takes the label count and the MoE routing
    statistics over the data axes), so the processes' losses average to the
    global loss; the reduce-scatters leave each process the sum of its
    blocks' gradients over the data axes, divided here by their size.
    Then ONE all-reduce over the data axes carries the gradients of the
    leaves that are whole over them (their mean), the metrics (their mean),
    the drain flag's element and the data-split leaves' sums of squares; on
    a "model" axis one more sum over "model" completes the clipping norm
    (and carries the flag), and AdamW updates each process's blocks."""
    lay = _Layout(model, mesh)
    grads_of = _grads_fn(model, tc)
    cdt = model.cfg.compute_dtype

    def pregathered(keys, blocks, batch):
        flat = dict(zip(keys, blocks))
        with torch.no_grad():
            use = fsdp.gather_leaves({k: v.detach().to(cdt) for k, v in flat.items()},
                                     lay.data, mesh)
        leaves = [use[k].requires_grad_(True) for k in keys]
        with fsdp.fsdp_ctx(mesh, gather_per_layer=False):
            grads, metrics = _local_grads(grads_of, leaves, unflatten(dict(zip(keys, leaves))),
                                          batch, tc)
        back = fsdp.reduce_scatter_leaves({k: g.to(cdt) for k, g in zip(keys, grads)},
                                          lay.data, mesh)
        return [back[k].to(p.dtype) for k, p in zip(keys, blocks)], metrics

    def train_step(params, opt_state, batch):
        keys = list(flatten(params))
        blocks = list(flatten(params).values())
        with mesh_ctx(mesh, train=True):
            if tc.pregather_params:
                grads, metrics = pregathered(keys, blocks, batch)
            else:
                for p in blocks:
                    p.requires_grad_(True)
                with fsdp.fsdp_ctx(mesh):
                    grads, metrics = _local_grads(grads_of, blocks, params, batch, tc)
            grads, metrics, drain, clip = _finish_fsdp(lay, keys, grads, metrics, drain_flag,
                                                       tc.grad_clip)
            params, opt_state, om = adamw_update(params, unflatten(dict(zip(keys, grads))),
                                                 opt_state, tc, clip=clip)
        if drain_flag is not None:
            drain_flag.observe(drain)
        return params, opt_state, {**metrics, **om}

    return train_step


def _finish_fsdp(lay: _Layout, keys, grads, metrics, drain_flag, max_norm):
    """(gradients as global means, metrics averaged over the data axes, the
    drain flag's sum over every process or None, the clipping pair) from the
    FSDP step's local gradients: the data-split leaves' reduce-scattered
    sums and the other leaves' local gradients (see
    ``_make_fsdp_train_step``)."""
    inv = 1.0 / lay.n_data
    split = [lay.data[k] is not None for k in keys]
    grads = [g * inv if s else g for g, s in zip(grads, split)]
    # the data-split leaves' sums of squares, by whether they split over "model" too
    d_parts = torch.stack([sum_squares([g for g, s, k in zip(grads, split, keys)
                                        if s and lay.on_model[k] == m], grads[0].device)
                           for m in (True, False)])
    whole = [i for i, s in enumerate(split) if not s]
    # the whole leaves' gradients ride the all-reduce only where there is one
    # (with one data shard they are the mean already; packing them would copy
    # the whole model's gradients into one f32 buffer for nothing)
    packed = whole if lay.n_data > 1 else []
    names, vec = _metrics_and_drain(metrics, drain_flag, [d_parts] + [grads[i] for i in packed])
    if lay.n_data > 1:
        dist.all_reduce(vec, op=dist.ReduceOp.SUM, group=lay.group)
    off = len(names)
    drain = vec[off] if drain_flag is not None else None
    off += drain_flag is not None
    d_parts = vec[off:off + 2].float()
    off += 2
    for i in packed:
        k = grads[i].numel()
        grads[i] = (vec[off:off + k] * inv).to(grads[i].dtype).view(grads[i].shape)
        off += k
    metrics = {k: (vec[j] * inv).to(metrics[k].dtype) for j, k in enumerate(names)}
    dev = d_parts.device
    split = sum_squares([grads[i] for i in whole if lay.on_model[keys[i]]], dev) + d_parts[0]
    rest = sum_squares([grads[i] for i in whole if not lay.on_model[keys[i]]], dev) + d_parts[1]
    clip, drain = _clip_over_model(lay, split, rest, drain, max_norm)
    return grads, metrics, drain, clip


def _make_reduce_train_step(model: Model, tc: TrainConfig, grad_reduce,
                            drain_flag=None) -> Callable:
    """The explicit-reduction step (reference ``_make_shardmap_train_step``)
    on the FSDP layout: the data-split blocks gathered whole at the entry in
    one all-gather (the reference's ``in_specs=P()``), local gradients of
    the whole leaves, ``grad_reduce.reduce`` over the data axes, the
    metrics averaged over the data axes in one all-reduce (with the drain
    flag's element summed in it), the clipping norm of the reduced
    gradients (summed over "model" in one collective that also carries the
    flag), and AdamW on this process's blocks of them: the same values as
    updating the whole leaves and cutting the result.  A stateful
    strategy's residual rows whose blocks split over the fast data axes
    are gathered for the reduction and cut back after it.
    ``tc.pregather_params`` is ignored here, as in the reference."""
    from repro_torch.distributed.reduce import axis_group

    mesh = grad_reduce.mesh
    lay = _Layout(model, mesh)
    group = axis_group(mesh, grad_reduce.data_axes)
    n_data = grad_reduce.axes_size(grad_reduce.data_axes)
    grads_of = _grads_fn(model, tc)
    ef_where = (grad_reduce.state_layout(train_state_shardings(model, tc, mesh)[0])
                if grad_reduce.stateful else None)

    def train_step(params, opt_state, ef, batch):
        keys = list(flatten(params))
        with mesh_ctx(mesh, train=True):
            with torch.no_grad():
                whole = fsdp.gather_leaves(flatten(params), lay.data, mesh)
            leaves = [whole[k].detach().requires_grad_(True) for k in keys]
            grads, metrics = _local_grads(grads_of, leaves, unflatten(dict(zip(keys, leaves))),
                                          batch, tc)
            if ef is not None and ef_where is not None:
                with torch.no_grad():
                    ef = unflatten(fsdp.gather_leaves(flatten(ef), ef_where, mesh))
            grads, ef = grad_reduce.reduce(unflatten(dict(zip(keys, grads))), ef)
            if ef is not None and ef_where is not None:
                ef = unflatten({k: v.contiguous() for k, v in
                                fsdp.cut_leaves(flatten(ef), ef_where, mesh).items()})
            names, m = _metrics_and_drain(metrics, drain_flag)
            if lay.n_model == 1 or n_data > 1:
                dist.all_reduce(m, op=dist.ReduceOp.SUM, group=group)
            drain = m[len(names)] if drain_flag is not None else None
            metrics = {k: (m[i] / n_data).to(metrics[k].dtype) for i, k in enumerate(names)}
            gs = list(flatten(grads).values())
            on = [lay.on_model[k] for k in keys]
            dev = gs[0].device
            clip, drain = _clip_over_model(
                lay, sum_squares([g for g, o in zip(gs, on) if o], dev),
                sum_squares([g for g, o in zip(gs, on) if not o], dev), drain, tc.grad_clip)
            mine = fsdp.cut_leaves(dict(zip(keys, gs)), lay.data, mesh)
            params, opt_state, om = adamw_update(params, unflatten(mine), opt_state, tc,
                                                 clip=clip)
        if drain_flag is not None:
            drain_flag.observe(drain)
        return params, opt_state, ef, {**metrics, **om}

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


def train_state_specs(model: Model, tc: TrainConfig):
    """(parameter specs, AdamW state specs) of ``model``'s train state."""
    ps = model.specs()
    return ps, adamw_init_specs(ps, tc)


def train_state_shardings(model: Model, tc: TrainConfig, mesh, rules=None,
                          grad_reduce=None):
    """(param, opt) spec trees of ``model``'s train state on ``mesh`` (every
    leaf's ``logical_spec`` under ``rules``, by default the training
    ``RULES``, FSDP included: the optimizer mirrors the parameters' logical
    axes), so every V-cycle level
    gets its own layout and a checkpoint written on one mesh restores onto
    another's (``CheckpointManager.restore(shardings=)``).  With a
    ``grad_reduce`` strategy a third tree: its carried state's specs (None
    for a stateless one)."""
    from repro_torch.distributed.sharding import param_shardings

    ps, opt_specs = train_state_specs(model, tc)
    rules = RULES if rules is None else rules
    psh = param_shardings(ps, mesh, rules)
    osh = param_shardings(opt_specs, mesh, rules)
    if grad_reduce is None:
        return psh, osh
    return psh, osh, grad_reduce.state_shardings(psh, mesh)


def zero_train_state(model: Model, tc: TrainConfig, device=None, grad_reduce=None):
    """Zero-filled (params, opt_state) with the structure, shapes and dtypes
    of ``init_train_state`` -- like-trees for a checkpoint restore, drawn
    from no generator -- on ``device`` (the CUDA card unless given; "meta"
    allocates nothing).  With a ``grad_reduce`` strategy a third tree: the
    zero EF state as the global ``[n_dcn, *shape]`` f32 tree, as the
    reference's (None for a stateless strategy)."""
    dev = default_device(device)
    ps, opt_specs = train_state_specs(model, tc)
    params = zeros_tree(ps, model.cfg.param_dtype, dev)
    opt = {"m": zeros_tree(opt_specs["m"], tc.opt_dtype, dev),
           "v": zeros_tree(opt_specs["v"], tc.opt_dtype, dev), "count": 0}
    if grad_reduce is None:
        return params, opt
    ef = None
    if grad_reduce.stateful:
        ef = tree_map(lambda p: torch.zeros((grad_reduce.dcn_size,) + tuple(p.shape),
                                            dtype=torch.float32, device=dev), params)
    return params, opt, ef


def _last_logits(out: Dict) -> torch.Tensor:
    """The last position's logits ``[B, V]`` of ``lm_forward(...,
    vocab_split=True)``'s output: this process's block of vocabulary columns
    at the last position, gathered whole over ``out["vocab_axes"]`` (a
    concatenation, so the same numbers as slicing the gathered ``[B, S, V]``
    logits, as the reference's sharded prefill keeps its logits split)."""
    last = out["logits"][:, -1, :]
    if out["vocab_axes"]:
        return tp.all_gather_cat(last, dim=-1, axes=out["vocab_axes"])
    return last


def make_prefill_step(model: Model) -> Callable:
    """prefill_step(params, tokens [B,S], img_embeds=None, enc_frames=None)
    -> (last_logits [B,V], caches); the VLM's and the encoder-decoder's
    caches carry the projected cross K/V of the given source."""
    cfg = model.cfg

    @torch.inference_mode()
    def prefill_step(params, tokens, img_embeds=None, enc_frames=None):
        out = lm_lib.lm_forward(params, tokens, cfg, mode="prefill",
                                img_embeds=img_embeds, enc_frames=enc_frames,
                                vocab_split=True)
        return _last_logits(out), out["caches"]

    return prefill_step


def make_serve_step(model: Model) -> Callable:
    """serve_step(params, caches, tokens [B,1], pos [B]) -> (logits [B,V],
    caches): one new token per row against dense ``[B, max_seq]`` caches,
    which are updated IN PLACE and returned (the slots engine)."""
    cfg = model.cfg

    @torch.inference_mode()
    def serve_step(params, caches, tokens, pos):
        out = lm_lib.lm_forward(params, tokens, cfg, positions=pos[:, None],
                                mode="decode", caches=caches)
        return out["logits"][:, -1, :], out["caches"]

    return serve_step


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
                                block_tables=block_tables, vocab_split=True)
        return _last_logits(out), out["caches"]

    return paged_decode_step


def make_verify_step(model: Model) -> Callable:
    """verify_step(params, pages, tokens [B,S], positions [B,S], block_tables
    [B,M]) -> (logits [B,S,V], pages).

    The speculative verifier: the forward of ``make_paged_decode_step``
    (the same paged reads and in-place writes) returning logits at EVERY
    position, so one full-model step scores a drafted run written at
    positions p..p+k.  ``logits[:, i]`` is the next-token distribution after
    the token at ``positions[:, i]``.  Right-padded rows carry positions -1
    (writes to the null page, attention masked); their logits are unread.
    """
    cfg = model.cfg

    @torch.inference_mode()
    def verify_step(params, pages, tokens, positions, block_tables):
        out = lm_lib.lm_forward(params, tokens, cfg, positions=positions,
                                mode="decode", caches=pages,
                                block_tables=block_tables)
        return out["logits"], out["caches"]

    return verify_step


def serve_shardings(model: Model, mesh, *, n_pages=None, page_size=None):
    """(parameter specs, page-pool specs, merged rules) for serving on
    ``mesh``: every leaf's ``logical_spec`` tuple under the training
    ``RULES`` overlaid with ``SERVE_RULES`` (read-only parameters replicate
    over the data axes, experts spread over every device) plus
    ``cache_kv_heads -> "model"``.  A GQA page pool so splits its K/V heads
    over "model" (where they divide); MLA's latent pools have no head axis
    and stay whole.  The pool tree is None unless ``n_pages`` is given.  The
    merged rules are returned as the reference returns them; the serving
    steps read only the mesh."""
    from repro_torch.distributed.sharding import RULES, SERVE_RULES, param_shardings

    merged = dict(RULES)
    merged.update(SERVE_RULES)
    merged["cache_kv_heads"] = "model"
    psh = param_shardings(model.specs(), mesh, merged)
    csh = None
    if n_pages is not None:
        csh = param_shardings(model.paged_cache_specs(n_pages, page_size), mesh, merged)
    return psh, csh, merged
