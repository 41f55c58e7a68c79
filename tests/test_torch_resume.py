"""Kill-and-resume of the port's V-cycle, and mid-V-cycle checkpoints across
the two packages, on the CPU.

* The port's cases of ``tests/test_resume.py``: a 2-level V-cycle killed in
  the middle of its upward sweep (so the de-coalesce and interpolation are
  replayed after the restore) ends with the parameters and ``History`` of an
  uninterrupted run -- bit for bit here, one process on the CPU -- and each
  level's step is built once; a checkpoint of another schedule is refused;
  the stopping step of a target-loss exit is never checkpointed.
* Across packages, from the reference's initial weights on the reference's
  batches (through numpy), f32, Adam's eps at 1e-4 as in
  ``tests/test_torch_vcycle.py``: a mid-upward-sweep checkpoint written by
  the reference resumes in the port and follows the reference's
  uninterrupted trace, and one written by the port resumes in the
  reference.  ``History.step``, ``.level`` and ``.flops`` exactly; losses and
  final parameters within 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import tiny_dense
from repro.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.config import MultiLevelConfig as JML
from repro.config import TrainConfig as JTC
from repro.core import vcycle as jvc
from repro.data import MarkovLM as JMarkovLM
from repro.data import lm_batch as jax_lm_batch
from repro.launch.train import make_vcycle_save_cb as jax_make_vcycle_save_cb
from repro.launch.train import restore_vcycle_state as jax_restore_vcycle_state
from repro.models.api import build_model as jax_build_model

from repro_torch.bridge import from_reference, to_reference
from repro_torch.checkpoint import CheckpointManager
from repro_torch.config import BlockSpec, ModelConfig, MultiLevelConfig, TrainConfig
from repro_torch.config import uniform_stages
from repro_torch.core.vcycle import VCycleRunner, VCycleState
from repro_torch.data import MarkovLM, lm_batch
from repro_torch.launch.train import make_vcycle_save_cb, restore_vcycle_state
from repro_torch.param import flatten
from test_torch_ssm import one_thread  # noqa: F401 (autouse)


class Preempted(RuntimeError):
    pass


TCKW = dict(steps=12, warmup_steps=1, peak_lr=3e-3, batch_size=4, seq_len=16,
            log_every=2, eps=1e-4)
MLKW = dict(n_levels=2, alpha=0.25, e_a_frac=0.25, e_small_frac=0.5)


def port_cfg():
    """``helpers.tiny_dense(d_model=32, d_ff=64, vocab_size=128)`` at f32."""
    return ModelConfig(name="t-dense", family="dense", d_model=32, n_heads=4, n_kv_heads=2,
                       d_ff=64, vocab_size=128,
                       stages=uniform_stages(3, BlockSpec("attn", "dense")), qk_norm=True,
                       remat="none", attn_impl="plain", compute_dtype=torch.float32)


def jax_cfg():
    return tiny_dense(d_model=32, d_ff=64, vocab_size=128, compute_dtype=jnp.float32)


def arena():
    tc = TrainConfig(**TCKW)
    chain = MarkovLM(128)
    bf = lambda step: lm_batch(chain, 0, step, tc.batch_size, tc.seq_len, device="cpu")
    return port_cfg(), MultiLevelConfig(**MLKW), tc, bf


def _kill_at(cm, runner, g, **run_kw):
    save_cb = make_vcycle_save_cb(cm, schedule=runner.plan)

    def killing_cb(state, params, opt_state):
        save_cb(state, params, opt_state)
        if state.global_step == g:
            raise Preempted

    with pytest.raises(Preempted):
        runner.run(ckpt_cb=killing_cb, ckpt_every=2, **run_kw)
    cm.wait()


def test_kill_and_resume_equivalence(tmp_path):
    cfg, ml, tc, bf = arena()
    # schedule: down L0 for 3 steps (g 1..3), up L1 for 6 (g 4..9), final 12
    ref = VCycleRunner(cfg, ml, tc, bf, device="cpu").run()
    cm = CheckpointManager(str(tmp_path))
    _kill_at(cm, VCycleRunner(cfg, ml, tc, bf, device="cpu"), 6)
    runner2 = VCycleRunner(cfg, ml, tc, bf, device="cpu")
    state, params, opt = restore_vcycle_state(cm, runner2, tc)
    assert (state.phase, state.level, state.global_step) == ("up", 1, 6)
    assert state.seg_step == 3 and state.seg_index == 1
    assert list(state.params_before) == [0]
    assert opt["count"] == 3
    out = runner2.run(state=state, params=params, opt_state=opt,
                      ckpt_cb=make_vcycle_save_cb(cm, schedule=runner2.plan), ckpt_every=2)
    got, want = flatten(out.params), flatten(ref.params)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert out.history.to_dict() == ref.history.to_dict()
    assert out.total_flops == ref.total_flops
    assert runner2.n_compiles == 2


def test_resume_rejects_schedule_mismatch(tmp_path):
    cfg, ml, tc, bf = arena()
    cm = CheckpointManager(str(tmp_path))
    _kill_at(cm, VCycleRunner(cfg, ml, tc, bf, device="cpu"), 4)
    tc2 = TrainConfig(**dict(TCKW, steps=30))
    with pytest.raises(ValueError, match="schedule"):
        restore_vcycle_state(cm, VCycleRunner(cfg, ml, tc2, bf, device="cpu"), tc2)


def test_no_checkpoint_on_early_stop_step(tmp_path):
    cfg, ml, tc, bf = arena()
    cm = CheckpointManager(str(tmp_path))
    runner = VCycleRunner(cfg, ml, tc, bf, target_loss=1e9, device="cpu")
    runner.run(ckpt_cb=make_vcycle_save_cb(cm, schedule=runner.plan), ckpt_every=1)
    cm.wait()
    # the target holds at the final segment's first log step (g = 10)
    assert runner.state.global_step == 10
    assert cm.latest()["step"] == 9


def test_restore_lands_on_the_runner_device_without_a_card(tmp_path, monkeypatch):
    """The like-trees are built on the runner's device, so a CPU runner
    restores with no card; without a device the restore raises."""
    cfg, ml, tc, bf = arena()
    cm = CheckpointManager(str(tmp_path))
    _kill_at(cm, VCycleRunner(cfg, ml, tc, bf, device="cpu"), 4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    state, params, opt = restore_vcycle_state(cm, VCycleRunner(cfg, ml, tc, bf,
                                                               device="cpu"), tc)
    assert all(t.device.type == "cpu" for t in flatten(params).values())
    from repro_torch.models.api import build_model, zero_train_state

    with pytest.raises(RuntimeError, match="no CUDA device"):
        zero_train_state(build_model(cfg), tc)


# ---------------------------------------------------------------------------
# across the packages


@pytest.fixture(scope="module")
def reference():
    """Reference batches and initial weights, and the reference's
    uninterrupted run."""
    jcfg = jax_cfg()
    chain = JMarkovLM(128)
    batches = [jax.tree.map(np.asarray, jax_lm_batch(chain, 0, g, 4, 16)) for g in range(21)]
    init = jax.tree.map(np.asarray, jax_build_model(jcfg).init(jax.random.PRNGKey(0)))
    jbf = lambda g: jax.tree.map(jnp.asarray, batches[g])
    ref = jvc.VCycleRunner(jcfg, JML(**MLKW), JTC(**TCKW), jbf, seed=0).run(
        state=jvc.VCycleState(), params=jax.tree.map(jnp.asarray, init))
    return jcfg, batches, init, jbf, ref


def _port_bf(batches):
    return lambda g: {k: torch.from_numpy(v.astype(np.int64)) for k, v in batches[g].items()}


def _follows(got_hist, ref, params_np):
    want = ref.history
    assert got_hist.step == want.step and got_hist.level == want.level
    assert got_hist.flops == want.flops
    np.testing.assert_allclose(got_hist.loss, want.loss, atol=1e-5, rtol=0)
    ref_flat = flatten(jax.tree.map(np.asarray, ref.params))
    got_flat = flatten(params_np)
    assert got_flat.keys() == ref_flat.keys()
    for k in ref_flat:
        np.testing.assert_allclose(got_flat[k], ref_flat[k], atol=1e-5, rtol=0, err_msg=k)


def test_reference_checkpoint_resumes_in_the_port(tmp_path, reference):
    jcfg, batches, init, jbf, ref = reference
    jcm = JaxCheckpointManager(str(tmp_path))
    jrunner = jvc.VCycleRunner(jcfg, JML(**MLKW), JTC(**TCKW), jbf, seed=0)
    save_cb = jax_make_vcycle_save_cb(jcm, schedule=jrunner.plan)

    def killing_cb(state, params, opt_state):
        save_cb(state, params, opt_state)
        if state.global_step == 6:
            raise Preempted

    with pytest.raises(Preempted):
        jrunner.run(state=jvc.VCycleState(), params=jax.tree.map(jnp.asarray, init),
                    ckpt_cb=killing_cb, ckpt_every=2)
    jcm.wait()

    cfg = port_cfg()
    tc = TrainConfig(**TCKW)
    runner = VCycleRunner(cfg, MultiLevelConfig(**MLKW), tc, _port_bf(batches), device="cpu")
    state, params, opt = restore_vcycle_state(CheckpointManager(str(tmp_path)), runner, tc)
    assert (state.phase, state.level, state.global_step, state.seg_step) == ("up", 1, 6, 3)
    assert list(state.params_before) == [0] and opt["count"] == 3
    out = runner.run(state=state, params=params, opt_state=opt)
    _follows(out.history, ref, to_reference(out.params, cfg))
    assert out.total_flops == ref.total_flops


def test_port_checkpoint_resumes_in_the_reference(tmp_path, reference):
    jcfg, batches, init, jbf, ref = reference
    cfg = port_cfg()
    tc = TrainConfig(**TCKW)
    cm = CheckpointManager(str(tmp_path))
    runner = VCycleRunner(cfg, MultiLevelConfig(**MLKW), tc, _port_bf(batches), device="cpu")
    _kill_at(cm, runner, 6, state=VCycleState(), params=from_reference(init, cfg))

    jrunner = jvc.VCycleRunner(jcfg, JML(**MLKW), JTC(**TCKW), jbf, seed=0)
    state, params, opt = jax_restore_vcycle_state(JaxCheckpointManager(str(tmp_path)),
                                                  jrunner, JTC(**TCKW))
    assert (state.phase, state.level, state.global_step, state.seg_step) == ("up", 1, 6, 3)
    assert list(state.params_before) == [0] and int(opt["count"]) == 3
    out = jrunner.run(state=state, params=params, opt_state=opt)
    _follows(out.history, ref, jax.tree.map(np.asarray, out.params))
    assert out.total_flops == ref.total_flops
