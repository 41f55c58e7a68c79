"""Public model facade + step builders (the counterpart of
``repro/models/api.py``: ``Model``, ``build_model``, ``make_train_step``,
``make_eval_loss``, ``init_train_state``, ``train_state_specs``,
``train_state_shardings``, ``zero_train_state``, ``make_prefill_step``,
``make_serve_step``, ``make_paged_decode_step``, ``make_verify_step``,
``serve_shardings``).

The serving steps run under ``torch.inference_mode()``; the train step runs
with autograd on and updates the parameters and optimizer state in place.
On a mesh with a "model" axis the train step runs in ``mesh_ctx``: each
process holds its blocks of the split leaves (``train_state_shardings``),
the layers meet at the collectives of ``distributed/tensor_parallel.py``
(forward and backward), the gradient reduction and the metrics' mean run
over the data axes only, and the clipping norm is summed over "model".
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch
import torch.distributed as dist

from repro_torch.config import ModelConfig, TrainConfig
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.distributed.sharding import TRAIN_RULES, mesh_ctx, mesh_shape
from repro_torch.kernels import dispatch as kdispatch
from repro_torch.models import lm as lm_lib
from repro_torch.models import vit as vit_lib
from repro_torch.device import default_device
from repro_torch.optim import adamw_init, adamw_init_specs, adamw_update
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

    def loss(self, params, batch: Dict[str, torch.Tensor], z_loss: float = 0.0):
        """(loss, metrics) of a ``{"tokens", "labels"}`` batch (plus
        ``img_embeds`` for the VLM family, ``enc_frames`` for the audio
        one), or of a ``{"patches", "labels"}`` batch for the ViT family."""
        if self.cfg.family == "vit":
            logits = vit_lib.vit_forward(params, batch["patches"], self.cfg)
            return vit_lib.vit_loss(logits, batch["labels"])
        cfg = self.cfg
        out = lm_lib.lm_forward(params, batch["tokens"], cfg, mode="train",
                                img_embeds=batch.get("img_embeds"),
                                enc_frames=batch.get("enc_frames"))
        mtp_labels = None
        if cfg.mtp_depth:  # token t + 2: the labels shifted left, -1 at the end
            lbl = batch["labels"]
            mtp_labels = torch.cat([lbl[:, 1:], torch.full_like(lbl[:, :1], -1)], dim=1)
        return lm_lib.lm_loss(out["logits"], batch["labels"], cfg, out["aux"],
                              out.get("mtp_logits"), mtp_labels, z_loss)

    def forward_logits(self, params, batch) -> torch.Tensor:
        if self.cfg.family == "vit":
            return vit_lib.vit_forward(params, batch["patches"], self.cfg)
        return lm_lib.lm_forward(params, batch["tokens"], self.cfg, mode="train",
                                 img_embeds=batch.get("img_embeds"),
                                 enc_frames=batch.get("enc_frames"))["logits"]


def check_model_axis(cfg: ModelConfig, n_model: int) -> None:
    """Raise ``NotImplementedError`` when ``cfg`` would train on a "model"
    axis of ``n_model`` > 1 with blocks that have no collectives yet: the
    recurrent mixers (their ``mamba_inner``/``xlstm_inner`` split would be
    computed wrong, silently) and the cross-attention blocks."""
    if n_model == 1:
        return
    mixers = {bs.mixer for st in cfg.stages for bs in st.pattern}
    outside = sorted(mixers & set(lm_lib.RECURRENT_MIXERS + lm_lib.CROSS_MIXERS))
    if outside:
        raise NotImplementedError(
            f"{cfg.name}: training on a 'model' axis larger than 1 is not ported for "
            f"blocks {outside} (the recurrent mixers and the cross-attention blocks): it "
            f"waits for port slice 17; train {cfg.name} on a --mesh Dx1")


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

    With a ``grad_reduce`` strategy (``distributed/reduce.py``) and a
    ``mesh`` the step is the data-parallel one and 4-ary, as the
    reference's: ``train_step(params, opt_state, ef, batch) -> (params,
    opt_state, ef, metrics)``.  ``batch`` is this process's rows; the local
    gradients go through ``grad_reduce.reduce`` (``ef`` is its carried state,
    None for a stateless strategy), the metrics are averaged over the data
    axes, and every process runs AdamW on the same reduced gradients, so
    the processes' parameters stay bit-identical.  A ``drain_flag``
    (``distributed.FusedDrainFlag``) rides that metrics all-reduce as one
    more element: the preemption OR over every process, at no extra
    collective.
    """
    if grad_reduce is not None:
        if mesh is None:
            raise ValueError("grad_reduce requires a mesh")
        check_model_axis(model.cfg, mesh_shape(mesh).get("model", 1))
        return _make_reduce_train_step(model, tc, grad_reduce, drain_flag)
    if drain_flag is not None:
        raise ValueError("a drain flag rides the data-parallel step: it needs grad_reduce")
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


def _make_reduce_train_step(model: Model, tc: TrainConfig, grad_reduce,
                            drain_flag=None) -> Callable:
    """The explicit-reduction step (reference ``_make_shardmap_train_step``):
    local gradients, ``grad_reduce.reduce`` over the data axes, the metrics
    averaged over the data axes in one all-reduce (with the drain flag's
    element summed in it), then AdamW on every process.  On a "model" axis
    the step runs in ``mesh_ctx``; the clipping norm's one sum over "model"
    also carries the drain flag's data-axis sum, so a notice on any process
    reaches every process without a collective of its own."""
    from repro_torch.distributed.reduce import axis_group

    mesh = grad_reduce.mesh
    group = axis_group(mesh, grad_reduce.data_axes)
    n_data = grad_reduce.axes_size(grad_reduce.data_axes)
    n_model = mesh_shape(mesh).get("model", 1)
    grads_of = _grads_fn(model, tc)
    whole = {k: tuple(s.shape) for k, s in flatten(model.specs()).items()}

    def train_step(params, opt_state, ef, batch):
        keys = list(flatten(params))
        leaves = list(flatten(params).values())
        for p in leaves:
            p.requires_grad_(True)
        with mesh_ctx(mesh):
            grads, metrics = _local_grads(grads_of, leaves, params, batch, tc)
            grads, ef = grad_reduce.reduce(unflatten(dict(zip(keys, grads))), ef)
            names = list(metrics)
            vals = [metrics[k].float() for k in names]
            if drain_flag is not None:
                vals.append(torch.full((), drain_flag.value(), device=vals[0].device))
            m = torch.stack(vals)
            if n_model == 1 or n_data > 1:
                dist.all_reduce(m, op=dist.ReduceOp.SUM, group=group)
            drain = m[-1] if drain_flag is not None else None
            m = m / n_data
            metrics = {k: m[i].to(metrics[k].dtype) for i, k in enumerate(names)}
            split = model_sum = None
            if n_model > 1:
                split = [tuple(p.shape) != whole[k] for k, p in zip(keys, leaves)]

                def model_sum(part):
                    nonlocal drain
                    extra = drain if drain is not None else torch.zeros_like(part)
                    both = tp.all_reduce_sum(torch.stack([part, extra.to(part.dtype)]))
                    drain = both[1] if drain is not None else None
                    return both[0]

            params, opt_state, om = adamw_update(params, grads, opt_state, tc, split=split,
                                                 model_sum=model_sum)
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
    leaf's ``logical_spec`` under ``rules``, by default ``TRAIN_RULES``: the
    optimizer mirrors the parameters' logical axes), so every V-cycle level
    gets its own layout and a checkpoint written on one mesh restores onto
    another's (``CheckpointManager.restore(shardings=)``).  With a
    ``grad_reduce`` strategy a third tree: its carried state's specs (None
    for a stateless one)."""
    from repro_torch.distributed.sharding import param_shardings

    ps, opt_specs = train_state_specs(model, tc)
    rules = TRAIN_RULES if rules is None else rules
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


def make_prefill_step(model: Model) -> Callable:
    """prefill_step(params, tokens [B,S], img_embeds=None, enc_frames=None)
    -> (last_logits [B,V], caches); the VLM's and the encoder-decoder's
    caches carry the projected cross K/V of the given source."""
    cfg = model.cfg

    @torch.inference_mode()
    def prefill_step(params, tokens, img_embeds=None, enc_frames=None):
        out = lm_lib.lm_forward(params, tokens, cfg, mode="prefill",
                                img_embeds=img_embeds, enc_frames=enc_frames)
        return out["logits"][:, -1, :], out["caches"]

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
                                block_tables=block_tables)
        return out["logits"][:, -1, :], out["caches"]

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
