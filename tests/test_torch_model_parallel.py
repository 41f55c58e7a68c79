"""The "model" axis in training: tensor- and expert-parallel train steps and
V-cycles on meshes of spawned gloo processes on the CPU, held to the
reference's UNSHARDED runs at f32 (the reference's own mesh tests fail under
jax 0.9, ROADMAP Queue 3).

* Spec parity: ``train_state_shardings`` (parameters, AdamW moments, the
  int8_ef residuals) of every registered config at the meshes 1x2, 2x2 and
  2x1x2 equal the reference's ``logical_spec`` under its ``RULES``, FSDP
  included; ``state_specs`` is the slow axis, and the residuals' other dims
  follow the parameter without it (no axis named twice).
* Spawn A, two ranks on ``--mesh 1x2``: (1) each collective of
  ``distributed/tensor_parallel.py`` forward and backward against the
  unsharded function; (2) one f32 train step of ``tiny_dense``,
  ``tiny_dense(n_kv_heads=1)`` (heads split, K/V heads whole), ``tiny_moe``,
  ``tiny_mla`` with the MTP head, a tiny BERT (MLM), a tiny DeiT, and the
  recurrent and cross-attention families: ``tiny_xlstm`` (mLSTM and sLSTM
  heads split), ``tiny_hybrid`` (Mamba's channels split), ``tiny_audio``
  (Whisper's encoder-decoder) and ``tiny_vlm`` (gated image layers, the
  gates at 0.5): loss, ``grad_norm``, every gathered gradient, parameter
  and AdamW moment within ``STEP_TOL`` of the reference's
  ``make_train_step``, each leaf split over "model" half its size, and the
  replicated leaves' gradients bit for bit the same on both ranks; (3) the
  2-level V-cycle of ``test_torch_resume.py``'s tiny dense model (head and
  FFN pairs straddle the ranks; level 1 keeps 1 K/V head whole beside
  split heads) against the reference's ``History``; (5) the same run, saved
  coordinated every 2 steps and killed at global step 6 in its upward
  sweep (the ``params_before`` stash in the checkpoint); (6) the 2-level
  V-cycle of ``tiny_hybrid`` at the same widths (Mamba coalesced across the
  ranks) against the reference's ``History``.
* Spawn B, two ranks on ``--mesh 2x1`` after A: the 1x2 save resumed to the
  end, and the uninterrupted dense and int8_ef runs (4).
* Spawn C, four ranks on ``--mesh 2x2``, beside A: dense and int8_ef (4).
* Here: the reference's uninterrupted run, and the 1x2 save resumed on one
  process.  Resumed and 2x2 dense runs follow the reference within
  ``VC_TOL``; 2x2 int8_ef stays within ``INT8_TOL`` of 2x1 int8_ef (each
  quantizes its own blocks); ranks agree where they hold the same leaves.
  B's ranks and the resume here read the 1x2 save at once and change no
  file of it.

Each spawn's rank 0 binds its store's port itself and writes it to a file
the other ranks read (``_coordinator``).

Measured on this container (printed by the tests): the steps' largest gaps
1.2e-7 (moe) to 8.6e-7 (deit) of a leaf's largest value, the sharded sums
running in other orders; the V-cycles' in ``VC_TOL``'s and ``INT8_TOL``'s
comments.  The step cases start from the port's init (the same numbers on
both sides) on seeded numpy batches; the V-cycle from the reference's init
on the reference's batches.  ~51 s alone, most of it the reference's jit
compiles, beside the ranks.
"""
import os
import subprocess
import sys
import textwrap
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import (tiny_audio, tiny_dense, tiny_hybrid, tiny_mla, tiny_moe, tiny_vlm,
                     tiny_xlstm)
from repro.config import MultiLevelConfig as JML
from repro.config import TrainConfig as JTC
from repro.configs import ASSIGNED
from repro.configs import PAPER_CONFIGS as J_PAPER
from repro.configs import get_config as jax_get_config
from repro.configs.paper_models import bert_proxy as jax_bert_proxy
from repro.configs.paper_models import deit_proxy as jax_deit_proxy
from repro.core import vcycle as jvc
from repro.data.synthetic import MarkovLM as JMarkovLM
from repro.data.synthetic import lm_batch as jax_lm_batch
from repro.distributed import sharding as jsh
from repro.models.api import build_model as jax_build_model
from repro.models.api import make_train_step as jax_make_train_step
from repro.optim import adamw_init as jax_adamw_init
from repro.models.vit import n_patches as jax_n_patches
from repro.models.vit import patch_dim as jax_patch_dim
from repro.param import is_spec as j_is_spec

from repro_torch.bridge import from_reference, to_reference
from repro_torch.checkpoint import CheckpointManager
from repro_torch.config import MultiLevelConfig, TrainConfig
from repro_torch.configs import get_config
from repro_torch.core.vcycle import VCycleRunner, VCycleState
from repro_torch.distributed import RULES, make_grad_reduce
from repro_torch.launch.train import restore_vcycle_state
from repro_torch.models.api import build_model, train_state_shardings, zero_train_state
from repro_torch.param import flatten, is_spec as t_is_spec, unflatten
from test_torch_resume import MLKW, TCKW, jax_cfg, port_cfg
from test_torch_ssm import one_thread  # noqa: F401 (autouse)

ROOT = os.path.join(os.path.dirname(__file__), "..")
# seconds a spawn's ranks may take from the end of the work here before them;
# spawn A, beside the reference's work and the suite's other workers, ran
# past 120 on a host loaded with more than the suite's six workers
TIMEOUT = 300
# one step against the reference: |got - want| <= STEP_TOL * max(1, max |want|)
# per leaf (gradients, parameters, moments) and for the loss and grad_norm
STEP_TOL = 1e-5
# the mLSTM config (atol, share of the largest |want|) per compared quantity:
# test_torch_ssm.py's tolerances for an mLSTM model against the reference,
# whose f32 arithmetic is ill-conditioned in both packages (that module's
# docstring): gradients its GRAD_TOL, a step's parameters and moments and
# the grad norm its STEP_TOL for xLSTM-125m, the loss STEP_TOL's
MLSTM_TOL = {"grads": (1e-5, 1e-3), "params": (1e-4, 0.0), "m": (1e-5, 2e-3),
             "v": (1e-5, 2e-3), "grad_norm": (1e-5, 1e-3), "loss": (1e-5, 0.0)}
# V-cycle losses and final parameters against the reference's unsharded run,
# absolute, as tests/test_torch_resume.py holds the one-process run (measured:
# 1x2 4.8e-7 and 7.9e-7, 2x2 dense 9.5e-7 and 7.2e-7, the resumes 9.5e-7 and
# 7.2e-7; the one-process port 9.5e-7 and 1.0e-6)
VC_TOL = 1e-5
# int8_ef runs against the reference's dense run and against each other, at
# peak_lr 3e-3: Adam moves an element that the int8 payload zeroes by up to
# the learning rate a step.  Measured: 2x1 2.2e-2 (parameters) and 1.1e-2
# (losses) from dense, 2x2 2.1e-2 and 7.2e-3, 2x2 from 2x1 1.8e-2 and
# 7.7e-3 (each quantizes with its own blocks' scales)
INT8_TOL = 5e-2
# the tiny hybrid's V-cycle (peak_lr 3e-3, Adam's eps 1e-4, 21 steps) moves
# with the order of its f32 sums: the port's ONE-process run parts from the
# reference's by 2.5e-5 (losses) and 9.6e-5 (parameters), and the 1x2 run,
# whose Mamba B/C/dt sums split over the ranks, from the one-process run by
# 7.2e-6 and 3.2e-5 and from the reference by 1.8e-5 and 7.8e-5 (measured on
# the CPU, torch 2.13); each is held within twice the largest of them
HYB_TOL = 2e-4
ARCHS = list(ASSIGNED) + list(J_PAPER)
SPEC_MESHES = [(1, 2), (2, 2), (2, 1, 2)]
STEP_TC = dict(steps=4, warmup_steps=1, peak_lr=1e-3, batch_size=4, seq_len=16, eps=1e-4)
KILL_AT = 6


def _ns_mesh(dims):
    axes = ("data", "model") if len(dims) == 2 else ("pod", "data", "model")
    return types.SimpleNamespace(axis_names=axes, shape=dict(zip(axes, dims)))


def _coordinator(out, name: str) -> str:
    """A spawn's coordinator: ``file://`` a fresh file in ``out``, where its
    rank 0 writes the port it binds itself (``launch/mesh.py::
    _coordinator_store``).  No port is picked, released and bound again
    while the suite's other workers and their ranks take ports."""
    path = os.path.join(str(out), f"{name}.coord")
    assert not os.path.exists(path), f"{path} was used by an earlier group"
    return f"file://{path}"


def _leaves(tree, is_leaf):
    out = {}

    def rec(t, path):
        if is_leaf(t):
            out[path] = t
        else:
            for k, v in t.items():
                rec(v, f"{path}/{k}")

    rec(tree, "")
    return out


# ---------------------------------------------------------------------------
# spec parity and the refusals (no processes)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_state_shardings_match_the_reference(arch):
    assert RULES == dict(jsh.RULES)
    tm, jm = build_model(get_config(arch)), jax_build_model(jax_get_config(arch))
    jl, tl = _leaves(jm.specs(), j_is_spec), _leaves(tm.specs(), t_is_spec)
    assert jl.keys() == tl.keys()
    tc = TrainConfig()
    for dims in SPEC_MESHES:
        mesh = _ns_mesh(dims)
        gr = make_grad_reduce("int8_ef", mesh)
        psh, osh, efsh = train_state_shardings(tm, tc, mesh, grad_reduce=gr)
        assert gr.state_specs() == (gr.dcn_axis,)
        is_t = lambda x: isinstance(x, tuple)
        got = {"p": _leaves(psh, is_t), "m": _leaves(osh["m"], is_t),
               "v": _leaves(osh["v"], is_t), "ef": _leaves(efsh, is_t)}
        assert osh["count"] == ()
        ef = _leaves(zero_train_state(tm, tc, device="meta", grad_reduce=gr)[2], torch.is_tensor)
        for k, s in jl.items():
            assert tuple(ef[k].shape) == (gr.dcn_size,) + tuple(s.shape), (dims, k)
            want = tuple(jsh.logical_spec(s.shape, s.axes, mesh, jsh.RULES))
            assert got["p"][k] == got["m"][k] == got["v"][k] == want, (dims, k)
            rows = []  # the parameter's spec without the slow axis
            for e in want:
                axes = tuple(a for a in ((e,) if isinstance(e, str) else e or ())
                             if a != gr.dcn_axis)
                rows.append(None if not axes else axes[0] if len(axes) == 1 else axes)
            assert got["ef"][k] == (gr.dcn_axis,) + tuple(rows), (dims, k)
            named = [a for e in got["ef"][k] for a in ((e,) if isinstance(e, str) else e or ())]
            assert len(named) == len(set(named)), (dims, k, got["ef"][k])


# ---------------------------------------------------------------------------
# the spawned ranks

# the step cases' configs on the port's side, field for field the reference's
CASES_SRC = textwrap.dedent("""
    def _port_case_cfg(name):
        from repro_torch.config import BlockSpec, ModelConfig, Stage, uniform_stages
        from repro_torch.configs.paper_models import bert_proxy, deit_proxy
        f32 = dict(compute_dtype=torch.float32)
        if name == "bert":
            return bert_proxy(d_model=64, n_layers=2, vocab=256).replace(**f32)
        if name == "deit":
            return deit_proxy(d_model=64, n_layers=2).replace(**f32)
        base = dict(name="t-dense", family="dense", d_model=64, n_heads=4, n_kv_heads=2,
                    d_ff=128, vocab_size=256,
                    stages=uniform_stages(3, BlockSpec("attn", "dense")), qk_norm=True,
                    remat="none", attn_impl="plain", **f32)
        if name == "kv1":
            base.update(n_kv_heads=1)
        elif name == "moe":
            base.update(name="t-moe", family="moe", n_experts=4, moe_top_k=2, moe_d_ff=64,
                        n_shared_experts=1,
                        stages=(Stage((BlockSpec("attn", "dense"),), 1),
                                Stage((BlockSpec("attn", "moe"),), 2)))
        elif name == "mla":
            base.update(name="t-mla", family="moe", attn_type="mla", q_lora_rank=32,
                        kv_lora_rank=16, qk_nope_head_dim=16, qk_rope_head_dim=8,
                        v_head_dim=16, qk_norm=False, n_kv_heads=4, mtp_depth=1)
        elif name == "xlstm":
            base.update(name="t-xl", family="ssm", n_kv_heads=4,
                        stages=(Stage((BlockSpec("mlstm", "none"),
                                       BlockSpec("slstm", "none")), 2),))
        elif name in ("jamba", "jamba_vc"):
            base.update(name="t-hyb", family="hybrid",
                        stages=(Stage((BlockSpec("mamba", "dense"),
                                       BlockSpec("attn", "dense")), 2),))
            if name == "jamba_vc":  # the V-cycle's widths (test_torch_resume.py's)
                base.update(d_model=32, d_ff=64, vocab_size=128)
        elif name == "whisper":
            base.update(name="t-audio", family="audio", n_encoder_layers=2, encoder_seq=12,
                        act="gelu", norm="layernorm", n_kv_heads=4, use_bias=True,
                        stages=uniform_stages(2, BlockSpec("dec_attn", "dense")))
        elif name == "vlm":
            base.update(name="t-vlm", family="vlm", n_image_tokens=8,
                        stages=(Stage((BlockSpec("cross_attn", "dense"),
                                       BlockSpec("attn", "dense")), 2),))
        return ModelConfig(**base)
""")
exec(CASES_SRC)
FAMILY_CASES = ("xlstm", "jamba", "whisper", "vlm")
STEP_CASES = ("dense", "kv1", "moe", "mla", "bert", "deit") + FAMILY_CASES


def _jax_case_cfg(name):
    f32 = dict(compute_dtype=jnp.float32)
    if name == "bert":
        return jax_bert_proxy(d_model=64, n_layers=2, vocab=256).replace(**f32)
    if name == "deit":
        return jax_deit_proxy(d_model=64, n_layers=2).replace(**f32)
    if name == "moe":
        return tiny_moe(**f32)
    if name == "mla":
        return tiny_mla(mtp_depth=1, **f32)
    if name == "xlstm":
        return tiny_xlstm(**f32)
    if name == "jamba":
        return tiny_hybrid(**f32)
    if name == "jamba_vc":
        return tiny_hybrid(d_model=32, d_ff=64, vocab_size=128, **f32)
    if name == "whisper":
        return tiny_audio(**f32)
    if name == "vlm":
        return tiny_vlm(**f32)
    return tiny_dense(**f32, **(dict(n_kv_heads=1) if name == "kv1" else {}))


def _case_batch(name, cfg, seed=0):
    """A seeded numpy batch of 4 rows: causal LM tokens and labels; BERT's
    MLM labels (-1 but at 15% of the positions); DeiT's patches and
    classes; Whisper's frames and the VLM's image embeddings beside its
    tokens."""
    rng = np.random.default_rng(seed)
    if name == "deit":
        n, d = jax_n_patches(cfg), jax_patch_dim(cfg)
        return {"patches": rng.standard_normal((4, n, d)).astype(np.float32),
                "labels": rng.integers(0, cfg.n_classes, 4).astype(np.int32)}
    tokens = rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)
    if name == "bert":
        labels = np.where(rng.random((4, 16)) < 0.15, tokens, -1).astype(np.int32)
    out = {"tokens": tokens, "labels": labels}
    if name == "whisper":
        out["enc_frames"] = rng.standard_normal((4, cfg.encoder_seq, cfg.d_model))
    if name == "vlm":
        out["img_embeds"] = rng.standard_normal((4, cfg.n_image_tokens,
                                                 cfg.vision_dim or cfg.d_model))
    return {k: v.astype(np.float32) if v.dtype == np.float64 else v for k, v in out.items()}


PRELUDE = textwrap.dedent("""
    import os, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    RANK, N, OUT = int(os.environ["RANK"]), int(os.environ["WORLD"]), os.environ["OUT"]
    from repro_torch.bridge import from_reference
    from repro_torch.config import MultiLevelConfig, TrainConfig
    from repro_torch.core.vcycle import VCycleRunner, VCycleState
    from repro_torch.distributed import (as_global_batch_fn, gather_global_tree,
                                         make_grad_reduce, put_global_tree,
                                         tensor_parallel as tp)
    from repro_torch.launch.mesh import init_distributed, make_cli_mesh
    from repro_torch.param import flatten, unflatten
    from test_torch_resume import MLKW, TCKW, port_cfg
    assert init_distributed(os.environ["COORD"], N, RANK, device="cpu") == "gloo"
    mesh = make_cli_mesh(os.environ["MESH"], num_processes=N, device="cpu")
    arena = np.load(f"{OUT}/arena.npz")
    INIT = unflatten({k[5:]: arena[k] for k in arena.files if k.startswith("init/")})
    BATCHES = [{k: arena[f"b{g}/{k}"] for k in ("tokens", "labels")} for g in range(21)]

    def whole_batch(g):
        return {k: torch.from_numpy(v.astype(np.int64)) for k, v in BATCHES[g].items()}

    batch_fn = as_global_batch_fn(whole_batch, mesh)  # a data coordinate's rows

    def run_vcycle(comp, state=None, params=None, opt=None, **kw):
        tc = TrainConfig(**dict(TCKW, grad_compression=comp))
        runner = VCycleRunner(port_cfg(), MultiLevelConfig(**MLKW), tc, batch_fn,
                              device="cpu", mesh=mesh)
        if params is None:
            params = put_global_tree(from_reference(INIT, port_cfg()),
                                     runner.level_shardings(0)[0], mesh)
        out = runner.run(state=state or VCycleState(), params=params, opt_state=opt, **kw)
        return runner, out

    def record(tag, runner, out):
        psh = runner.level_shardings(0)[0]
        whole = flatten(gather_global_tree(out.params, psh, mesh))
        torch.save({"loss": out.history.loss, "step": out.history.step,
                    "level": out.history.level, "flops": out.history.flops,
                    "params": {k: v.detach() for k, v in whole.items()},
                    "local": {k: v.detach() for k, v in flatten(out.params).items()},
                    "n_compiles": runner.n_compiles}, f"{OUT}/{tag}_rank{RANK}.pt")
""")

SPAWN_A = CASES_SRC + textwrap.dedent("""
    import torch.nn.functional as F
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.distributed.sharding import mesh_ctx
    from repro_torch.launch.train import make_vcycle_save_cb
    from repro_torch.models.api import build_model, make_train_step, train_state_shardings
    from repro_torch.optim import adamw_init

    # (1) the collectives, forward and backward
    g = torch.Generator().manual_seed(10 + RANK)
    rec = {}
    with mesh_ctx(mesh):
        x = torch.randn(3, 5, generator=g, requires_grad=True)
        w = torch.arange(15.0).reshape(3, 5)
        y = tp.all_reduce_sum(x)
        (y * w).sum().backward()
        rec["sum"] = (x.detach(), y.detach(), x.grad)
        x = torch.ones(3, 5, requires_grad=True)
        (tp.enter_split(x) * (RANK + 1) * w).sum().backward()
        rec["enter"] = x.grad
        x = torch.randn(3, 4, generator=g, requires_grad=True)
        y = tp.all_gather_cat(x, dim=1)
        (y * torch.arange(24.0).reshape(3, 8)).sum().backward()
        rec["gather"] = (x.detach(), y.detach(), x.grad)
        table = (torch.arange(8 * 3.0).reshape(8, 3) + 24 * RANK).requires_grad_(True)
        tokens = torch.tensor([[0, 9, 15, 3], [8, 8, 1, 12]])
        rows = tp.vocab_embedding(table, tokens, 16)
        (rows * torch.arange(24.0).reshape(2, 4, 3)).sum().backward()
        rec["embed"] = (rows.detach(), table.grad)
    rec["counts"] = tp.counts()
    torch.save(rec, f"{OUT}/collectives_rank{RANK}.pt")

    # (2) one train step of each config from the reference's init
    for name in os.environ["CASES"].split(","):
        cfg = _port_case_cfg(name)
        model = build_model(cfg)
        tc = TrainConfig(**STEP_TC)
        w = np.load(f"{OUT}/{name}_case.npz")
        params = from_reference(unflatten({k[2:]: w[k] for k in w.files if k[:2] == "p/"}), cfg)
        batch = {k[2:]: torch.from_numpy(w[k]) for k in w.files if k[:2] == "b/"}
        psh, osh = train_state_shardings(model, tc, mesh)
        local = put_global_tree(params, psh, mesh)
        keys, leaves = list(flatten(local)), list(flatten(local).values())
        for p in leaves:
            p.requires_grad_(True)
        with mesh_ctx(mesh):
            loss, _ = model.loss(local, batch)
            grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
        gtree = unflatten(dict(zip(keys, grads)))
        step = make_train_step(model, tc, grad_reduce=make_grad_reduce("dense", mesh),
                               mesh=mesh)
        for p in leaves:
            p.requires_grad_(False)
        local, opt, _, m = step(local, adamw_init(local, tc), None, batch)
        on_model = {k: any(e == "model" or isinstance(e, tuple) and "model" in e
                           for e in sp) for k, sp in flatten(psh).items()}
        torch.save({
            "grads": flatten(gather_global_tree(gtree, psh, mesh)),
            "replicated": {k: g for k, g in zip(keys, grads) if not on_model[k]},
            "split": [k for k in keys if on_model[k]],
            "local_shapes": {k: tuple(v.shape) for k, v in flatten(local).items()},
            "params": {k: v.detach() for k, v in
                       flatten(gather_global_tree(local, psh, mesh)).items()},
            "m": flatten(gather_global_tree(opt["m"], osh["m"], mesh)),
            "v": flatten(gather_global_tree(opt["v"], osh["v"], mesh)),
            "metrics": {k: float(v) for k, v in m.items()}}, f"{OUT}/{name}_rank{RANK}.pt")

    # (3) the V-cycle, uninterrupted; (5) saved every 2 steps, killed at KILL_AT
    record("vc12", *run_vcycle("none"))

    class Preempted(RuntimeError):
        pass

    cm = CheckpointManager(f"{OUT}/ck12")
    tc = TrainConfig(**TCKW)
    runner = VCycleRunner(port_cfg(), MultiLevelConfig(**MLKW), tc, batch_fn, device="cpu",
                          mesh=mesh)
    save_cb = make_vcycle_save_cb(cm, schedule=runner.plan, runner=runner)

    def killing_cb(state, params, opt_state):
        save_cb(state, params, opt_state)
        if state.global_step == KILL_AT:
            raise Preempted

    try:
        run_vcycle("none", ckpt_cb=killing_cb, ckpt_every=2)
        raise AssertionError("not killed")
    except Preempted:
        pass
    with open(f"{OUT}/ck12.done", "w"):
        pass

    # (6) the recurrent family's V-cycle from the reference's init
    hcfg = _port_case_cfg("jamba_vc")
    HINIT = unflatten({k[6:]: arena[k] for k in arena.files if k.startswith("hinit/")})
    runner = VCycleRunner(hcfg, MultiLevelConfig(**MLKW), TrainConfig(**TCKW), batch_fn,
                          device="cpu", mesh=mesh)
    params = put_global_tree(from_reference(HINIT, hcfg), runner.level_shardings(0)[0], mesh)
    record("vc12_hyb", runner, runner.run(state=VCycleState(), params=params))
    dist.destroy_process_group()
""")

SPAWN_B = textwrap.dedent("""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch.train import restore_vcycle_state
    tc = TrainConfig(**TCKW)
    runner = VCycleRunner(port_cfg(), MultiLevelConfig(**MLKW), tc, batch_fn, device="cpu",
                          mesh=mesh)
    state, params, opt = restore_vcycle_state(CheckpointManager(f"{OUT}/ck12"), runner, tc)
    assert (state.phase, state.level, state.global_step) == ("up", 1, KILL_AT), state
    record("resume21", runner, runner.run(state=state, params=params, opt_state=opt))
    for comp in ("dense", "int8_ef"):
        record(f"vc21_{comp}", *run_vcycle(comp))
    dist.destroy_process_group()
""")

SPAWN_C = textwrap.dedent("""
    for comp in ("dense", "int8_ef"):
        record(f"vc22_{comp}", *run_vcycle(comp))
    dist.destroy_process_group()
""")


def _start(body, n, mesh, out, **env):
    src = PRELUDE + f"KILL_AT = {KILL_AT}\nSTEP_TC = {STEP_TC!r}\n" + body
    coord = _coordinator(out, f"spawn_{mesh}")
    return [subprocess.Popen(
        [sys.executable, "-c", src], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=dict(os.environ, PYTHONPATH=os.pathsep.join(("src", "tests")),
                            OMP_NUM_THREADS="1", RANK=str(r), WORLD=str(n), OUT=str(out),
                            MESH=mesh, COORD=coord, **env))
        for r in range(n)]


def _finish(procs, what):
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, text) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"{what} rank {r} failed:\n{text}"


def _files(root) -> dict:
    """Every file under ``root``: its (size, mtime in ns), by relative path."""
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            st = os.stat(os.path.join(d, n))
            out[os.path.relpath(os.path.join(d, n), root)] = (st.st_size, st.st_mtime_ns)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Write the arena (the reference's init and batches) and each step
    case's weights and batch, start spawns A and C, compute the reference's
    steps and uninterrupted V-cycle meanwhile, start B once A saved, and
    resume A's save on one process here."""
    out = tmp_path_factory.mktemp("mp")
    jcfg = jax_cfg()
    chain = JMarkovLM(128)
    sample = jax.jit(lambda g: jax_lm_batch(chain, 0, g, 4, 16))
    batches = [jax.tree.map(np.asarray, sample(g)) for g in range(21)]
    init = jax.tree.map(np.asarray, jax_build_model(jcfg).init(jax.random.PRNGKey(0)))
    hjcfg = _jax_case_cfg("jamba_vc")
    hinit = jax.tree.map(np.asarray, jax_build_model(hjcfg).init(jax.random.PRNGKey(0)))
    np.savez(out / "arena.npz", **{f"init/{k}": v for k, v in flatten(init).items()},
             **{f"hinit/{k}": v for k, v in flatten(hinit).items()},
             **{f"b{g}/{k}": v for g, b in enumerate(batches) for k, v in b.items()})
    cases = {}
    for name in STEP_CASES:  # the port's init (drawn fast), the same for both
        c, tcfg = _jax_case_cfg(name), _port_case_cfg(name)
        p = to_reference(build_model(tcfg).init(torch.Generator().manual_seed(1)), tcfg)
        # the VLM's gates off their zero init, so its image layers contribute
        p = unflatten({k: np.full_like(v, 0.5) if k.endswith("/gate") else v
                       for k, v in flatten(p).items()})
        b = _case_batch(name, c)
        np.savez(out / f"{name}_case.npz", **{f"p/{k}": v for k, v in flatten(p).items()},
                 **{f"b/{k}": v for k, v in b.items()})
        cases[name] = (c, p, b)
    procs_a = _start(SPAWN_A, 2, "1x2", out, CASES=",".join(STEP_CASES))
    procs_c = _start(SPAWN_C, 4, "2x2", out)
    procs_b = []
    try:
        want = {}
        for name, (c, p, b) in cases.items():
            jm, jtc = jax_build_model(c), JTC(**STEP_TC)
            jp, jb = jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, b)
            step = jax_make_train_step(jm, jtc)
            grads, (p1, o1, m1) = jax.jit(lambda q, o, x: (
                jax.grad(lambda r: jm.loss(r, x)[0])(q), step(q, o, x)))(
                jp, jax_adamw_init(jp, jtc), jb)
            want[name] = {"grads": flatten(jax.tree.map(np.asarray, grads)),
                          "params": flatten(jax.tree.map(np.asarray, p1)),
                          "m": flatten(jax.tree.map(np.asarray, o1["m"])),
                          "v": flatten(jax.tree.map(np.asarray, o1["v"])),
                          "metrics": {k: float(v) for k, v in m1.items()}}
        jbf = lambda g: jax.tree.map(jnp.asarray, batches[g])
        ref = jvc.VCycleRunner(jcfg, JML(**MLKW), JTC(**TCKW), jbf, seed=0).run(
            state=jvc.VCycleState(), params=jax.tree.map(jnp.asarray, init))
        want["vcycle"] = {"loss": ref.history.loss, "step": ref.history.step,
                          "level": ref.history.level, "flops": ref.history.flops,
                          "params": flatten(jax.tree.map(np.asarray, ref.params))}
        ref = jvc.VCycleRunner(hjcfg, JML(**MLKW), JTC(**TCKW), jbf, seed=0).run(
            state=jvc.VCycleState(), params=jax.tree.map(jnp.asarray, hinit))
        want["vcycle_hyb"] = {"loss": ref.history.loss, "step": ref.history.step,
                              "level": ref.history.level, "flops": ref.history.flops,
                              "params": flatten(jax.tree.map(np.asarray, ref.params))}
        # the port's one-process run of it, the 1x2 run's nearer yardstick
        hcfg = _port_case_cfg("jamba_vc")
        bf = lambda g: {k: torch.from_numpy(v.astype(np.int64)) for k, v in batches[g].items()}
        one = VCycleRunner(hcfg, MultiLevelConfig(**MLKW), TrainConfig(**TCKW), bf,
                           device="cpu").run(state=VCycleState(),
                                             params=from_reference(hinit, hcfg))
        want["vcycle_hyb_one"] = {"loss": one.history.loss, "step": one.history.step,
                                  "level": one.history.level, "flops": one.history.flops,
                                  "params": {k: v.detach() for k, v in
                                             flatten(one.params).items()}}
        _finish(procs_a, "spawn A (1x2)")
        ck12 = [_files(out / "ck12")]  # read by B's ranks and here at once
        procs_b = _start(SPAWN_B, 2, "2x1", out)
        # the 1x2 save on one process, here
        tc = TrainConfig(**TCKW)
        runner = VCycleRunner(port_cfg(), MultiLevelConfig(**MLKW), tc, None, device="cpu")
        bf = lambda g: {k: torch.from_numpy(v.astype(np.int64)) for k, v in batches[g].items()}
        runner.batch_fn = bf
        state, params, opt = restore_vcycle_state(CheckpointManager(str(out / "ck12")),
                                                  runner, tc)
        assert (state.phase, state.level, state.global_step) == ("up", 1, KILL_AT)
        assert list(state.params_before) == [0]
        one = runner.run(state=state, params=params, opt_state=opt)
        one_rec = {"loss": one.history.loss, "step": one.history.step,
                   "level": one.history.level, "flops": one.history.flops,
                   "params": {k: v.detach() for k, v in flatten(one.params).items()}}
        _finish(procs_c, "spawn C (2x2)")
        _finish(procs_b, "spawn B (2x1)")
        ck12.append(_files(out / "ck12"))
    finally:
        for p in procs_a + procs_b + procs_c:
            if p.poll() is None:
                p.kill()
                p.wait()
    got = lambda tag, n=2: [torch.load(out / f"{tag}_rank{r}.pt", weights_only=False)
                            for r in range(n)]
    return {"want": want, "got": got, "one": one_rec, "out": out, "ck12": ck12}


def test_each_collective_forward_and_backward_on_two_ranks(runs):
    rec = runs["got"]("collectives")
    w = torch.arange(15.0).reshape(3, 5)
    xs = [r["sum"][0] for r in rec]
    for r in range(2):
        x, y, gx = rec[r]["sum"]
        assert torch.equal(y, xs[0] + xs[1]) and torch.equal(gx, w)  # identity backward
        assert torch.equal(rec[r]["enter"], 3 * w)  # the ranks' gradients summed: (1 + 2) w
        _, y, gx = rec[r]["gather"]
        assert torch.equal(y, torch.cat([rec[0]["gather"][0], rec[1]["gather"][0]], 1))
        assert torch.equal(gx, torch.arange(24.0).reshape(3, 8)[:, 4 * r:4 * r + 4])
    table = torch.cat([torch.arange(8 * 3.0).reshape(8, 3) + 24 * r for r in range(2)])
    table.requires_grad_(True)
    tokens = torch.tensor([[0, 9, 15, 3], [8, 8, 1, 12]])
    rows = torch.nn.functional.embedding(tokens, table)
    (rows * torch.arange(24.0).reshape(2, 4, 3)).sum().backward()
    for r in range(2):
        assert torch.equal(rec[r]["embed"][0], rows.detach())
        assert torch.equal(rec[r]["embed"][1], table.grad[8 * r:8 * r + 8])  # masked rows
        # sums: 1 forward, 1 backward (enter), 1 embedding; gathers: 1
        assert rec[r]["counts"] == {"all_reduce": 3, "all_gather": 1}


def _rel_gap(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max() / max(1.0, np.abs(want).max()))


def _step_share(name, what, got, want) -> float:
    """The gap as a share of its tolerance: ``STEP_TOL`` of ``max(1, max
    |want|)``, or for the mLSTM config ``MLSTM_TOL``'s."""
    want = np.asarray(want, np.float64)
    gap = float(np.abs(np.asarray(got, np.float64) - want).max())
    big = float(np.abs(want).max())
    if name != "xlstm":
        return gap / (STEP_TOL * max(1.0, big))
    atol, rel = MLSTM_TOL[what]
    return gap / (atol + rel * big)


@pytest.mark.parametrize("name", STEP_CASES)
def test_one_train_step_on_1x2_matches_the_reference_unsharded_step(runs, name):
    want = runs["want"][name]
    recs = runs["got"](name)
    worst = 0.0
    for r, rec in enumerate(recs):
        for what in ("grads", "params", "m", "v"):
            got = rec[what]
            assert got.keys() == want[what].keys(), (what, sorted(set(got) ^ set(want[what])))
            for k, v in got.items():
                share = _step_share(name, what, v.numpy(), want[what][k])
                worst = max(worst, share)
                assert share <= 1.0, (name, r, what, k, share)
        for k in ("loss", "grad_norm"):
            share = _step_share(name, k, rec["metrics"][k], want["metrics"][k])
            assert share <= 1.0, (name, k, share)
        # every split leaf is held as a block of half its size
        whole = {k: v.shape for k, v in rec["params"].items()}
        for k in rec["split"]:
            assert np.prod(rec["local_shapes"][k]) * 2 == np.prod(whole[k]), k
    assert recs[0]["split"] and recs[0]["replicated"].keys() == recs[1]["replicated"].keys()
    for k, g in recs[0]["replicated"].items():
        assert torch.equal(g, recs[1]["replicated"][k]), (name, k)
    assert recs[0]["metrics"] == recs[1]["metrics"]
    print(f"[{name}] 1x2 step: largest gap {worst:.3e} of its tolerance")


def _follows(rec, want, tol=VC_TOL, tag=""):
    assert rec["step"] == want["step"] and rec["level"] == want["level"]
    assert rec["flops"] == want["flops"]
    loss_gap = float(np.abs(np.asarray(rec["loss"]) - np.asarray(want["loss"])).max())
    assert rec["params"].keys() == want["params"].keys()
    param_gap = max(float(np.abs(v.numpy() - np.asarray(want["params"][k])).max())
                    for k, v in rec["params"].items())
    print(f"[{tag}] loss gap {loss_gap:.3e}, parameter gap {param_gap:.3e}")
    assert loss_gap <= tol and param_gap <= tol, (tag, loss_gap, param_gap)


def test_vcycle_on_1x2_follows_the_reference_unsharded_history(runs):
    recs = runs["got"]("vc12")
    want = runs["want"]["vcycle"]
    for r, rec in enumerate(recs):
        _follows(rec, want, tag=f"1x2 rank {r}")
        assert rec["n_compiles"] == 2
    # replicated leaves bit-identical; the blocks of split ones halves
    for k, v in recs[0]["local"].items():
        if v.shape == recs[0]["params"][k].shape:
            assert torch.equal(v, recs[1]["local"][k]), k
        else:
            assert 2 * v.numel() == recs[0]["params"][k].numel(), k
    assert recs[0]["loss"] == recs[1]["loss"]


def test_2x2_runs_follow_2x1_and_the_reference(runs):
    want = runs["want"]["vcycle"]
    d22, d21 = runs["got"]("vc22_dense", 4), runs["got"]("vc21_dense")
    for r, rec in enumerate(d22):
        _follows(rec, want, tag=f"2x2 dense rank {r}")
    _follows(d21[0], want, tag="2x1 dense")
    i22, i21 = runs["got"]("vc22_int8_ef", 4), runs["got"]("vc21_int8_ef")
    _follows(i21[0], want, INT8_TOL, "2x1 int8_ef against dense")
    _follows(i22[0], want, INT8_TOL, "2x2 int8_ef against dense")
    _follows(i22[0], i21[0], INT8_TOL, "2x2 int8_ef against 2x1")
    for runs_ in (d22, i22):  # every rank holds the same global leaves
        for rec in runs_[1:]:
            assert all(torch.equal(v, runs_[0]["params"][k]) for k, v in rec["params"].items())
            assert rec["loss"] == runs_[0]["loss"]


def test_1x2_save_mid_upward_sweep_resumes_on_2x1_and_on_one_process(runs):
    want = runs["want"]["vcycle"]
    for r, rec in enumerate(runs["got"]("resume21")):
        _follows(rec, want, tag=f"1x2 -> 2x1 rank {r}")
    _follows(runs["one"], want, tag="1x2 -> one process")
    mgr = CheckpointManager(str(runs["out"] / "ck12"))
    meta = mgr.latest()["meta"]
    assert (meta["phase"], meta["global_step"], meta["stashed_levels"]) == ("up", KILL_AT, [0])


def test_two_readers_of_the_1x2_save_write_nothing(runs):
    """Spawn B's two ranks and the one-process resume here restore the 1x2
    save at the same time: neither writes, moves or deletes a file of it."""
    before, after = runs["ck12"]
    assert before and after == before, sorted(set(before.items()) ^ set(after.items()))


def test_recurrent_vcycle_on_1x2_follows_the_reference_unsharded_history(runs):
    one = runs["want"]["vcycle_hyb_one"]
    _follows(one, runs["want"]["vcycle_hyb"], HYB_TOL, "hybrid one process against the reference")
    for r, rec in enumerate(runs["got"]("vc12_hyb")):
        _follows(rec, one, HYB_TOL, f"1x2 hybrid rank {r} against one process")
        _follows(rec, runs["want"]["vcycle_hyb"], HYB_TOL, f"1x2 hybrid rank {r}")
        assert rec["n_compiles"] == 2
