"""The port's training launcher (``python -m repro_torch.launch.train``) on
the CPU: the launcher cases of ``tests/test_system.py``.

The CLI runs with ``--device cpu`` on the TinyLlama smoke config, in three
subprocesses in all: a plain run that a second invocation resumes, a V-cycle
run stopped by SIGTERM in its upward sweep (exit 0 and a blocking
``[preempt]`` checkpoint), and a V-cycle run killed by SIGKILL once its first
checkpoint is published.  Each restart runs ``main`` in this process and
must resume; the SIGKILLed run's final parameters must equal an
uninterrupted run's, and a third invocation on the finished directory takes
no step.  The watchdog and the heartbeat cases, and the launcher refusing
to run without a card unless given ``--device cpu``, complete the file.
"""
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import repro_torch.launch.train as T
from repro_torch.checkpoint.manager import _read_leaves
from repro_torch.config import MultiLevelConfig, TrainConfig
from repro_torch.configs import get_config
from repro_torch.core.vcycle import segments
from repro_torch.param import flatten
from test_torch_ssm import one_thread  # noqa: F401 (autouse)

ROOT = os.path.join(os.path.dirname(__file__), "..")
SMOKE = ["--arch", "tinyllama-1.1b", "--smoke", "--batch", "2", "--seq", "16",
         "--device", "cpu"]
VCYCLE = SMOKE + ["--vcycle", "--levels", "2", "--steps", "40"]


def _cli(args):
    return [sys.executable, "-m", "repro_torch.launch.train", *args]


def _env():
    """The CLI's environment: one intra-op thread, as this module pins."""
    src = os.path.join(ROOT, "src")
    return dict(os.environ, PYTHONPATH=src, PYTHONUNBUFFERED="1", OMP_NUM_THREADS="1")


def _main(args, capsys):
    """``main(args)`` in this process, SIGTERM's handler restored after;
    returns what it printed."""
    saved = signal.getsignal(signal.SIGTERM)
    try:
        T.main(args)
    finally:
        signal.signal(signal.SIGTERM, saved)
    return capsys.readouterr().out


def _manifest(d):
    with open(os.path.join(d, "manifest.json")) as f:
        return json.load(f)


def test_train_launcher_resumes(tmp_path, capsys):
    args = SMOKE + ["--steps", "8", "--ckpt-dir", str(tmp_path), "--ckpt-every", "4"]
    r1 = subprocess.run(_cli(args), capture_output=True, text=True, env=_env(), cwd=ROOT,
                        timeout=300)
    assert r1.returncode == 0, r1.stderr[-1500:]
    assert _manifest(str(tmp_path))["meta"] == {"step": 8, "has_ef": False}
    out = _main(args + ["--steps", "10"], capsys)
    assert "resumed from step 8" in out
    assert _manifest(str(tmp_path))["step"] == 10


def test_watchdog_observes_slow_step():
    wd = T.Watchdog(factor=3.0)
    assert not any(wd.observe(0.01) for _ in range(10))
    assert wd.observe(0.1) is True
    assert wd.flagged == 1


def test_watchdog_median_excludes_current_sample():
    wd = T.Watchdog(factor=3.0)
    for _ in range(25):
        wd.observe(0.01)
    for _ in range(25):
        wd.observe(0.05)
    assert wd.observe(0.1) is True


def _smoke_cfg():
    return get_config("tinyllama-1.1b", smoke=True).replace(compute_dtype=torch.float32)


def test_vcycle_driver_heartbeats_every_step(monkeypatch):
    """Every step is observed except each segment's first."""
    seen = []
    orig = T.Watchdog.observe
    monkeypatch.setattr(T.Watchdog, "observe",
                        lambda self, dt: (seen.append(dt), orig(self, dt))[1])
    cfg = _smoke_cfg()
    tc = TrainConfig(steps=6, warmup_steps=1, batch_size=2, seq_len=16, log_every=10)
    ml = MultiLevelConfig(n_levels=2)
    T.train_vcycle_ckpt(cfg, ml, tc, ckpt=None, ckpt_every=0, verbose=False, device="cpu")
    plan = segments(cfg, ml, tc)
    assert len(seen) == sum(p.steps for p in plan) - len(plan)


def test_train_plain_heartbeats_every_step(monkeypatch):
    seen = []
    orig = T.Watchdog.observe
    monkeypatch.setattr(T.Watchdog, "observe",
                        lambda self, dt: (seen.append(dt), orig(self, dt))[1])
    tc = TrainConfig(steps=5, warmup_steps=1, batch_size=2, seq_len=16, log_every=10)
    T.train_plain(_smoke_cfg(), tc, ckpt=None, ckpt_every=0, verbose=False, device="cpu")
    assert len(seen) == 5


def test_vcycle_launcher_sigterm_checkpoints(tmp_path, capsys):
    """SIGTERM in the upward sweep: ONE final blocking checkpoint and exit 0,
    although the cadence (1000) never fires; the restart resumes from that
    save at its global step and ends with the terminal checkpoint."""
    # 100 steps: 3 + 50 + 100, so the upward sweep lasts 50 steps
    args = VCYCLE + ["--steps", "100", "--ckpt-dir", str(tmp_path), "--ckpt-every", "1000"]
    log = str(tmp_path / "run.log")
    with open(log, "w") as lf:
        p = subprocess.Popen(_cli(args), env=_env(), cwd=ROOT, stdout=lf,
                             stderr=subprocess.STDOUT)
        deadline = time.time() + 240
        stepping = False
        while time.time() < deadline and p.poll() is None and not stepping:
            with open(log) as f:
                stepping = "coalescing" in f.read()  # the upward sweep starts
            time.sleep(0.01)
        assert stepping, "run never reached the first transition"
        p.send_signal(signal.SIGTERM)
        assert p.wait(timeout=240) == 0, "SIGTERM exit was not clean"
    with open(log) as f:
        out = f.read()
    assert "[preempt] SIGTERM: blocking V-cycle checkpoint" in out, out[-1500:]
    meta = _manifest(str(tmp_path))["meta"]
    assert meta["phase"] == "up", meta
    g = meta["global_step"]
    restart = _main(args, capsys)
    assert (f"[vcycle] resumed at phase=up level=1 seg_step={meta['seg_step']} "
            f"global_step={g}") in restart, restart[-1500:]
    assert _manifest(str(tmp_path))["meta"]["phase"] == "done"


def test_vcycle_launcher_sigkill_resume(tmp_path, capsys):
    """SIGKILL once the first checkpoint lands; the restart with the same
    arguments resumes at (phase, level, step) and ends on the parameters of
    an uninterrupted run; another invocation takes no step."""
    ck = str(tmp_path / "ck")
    args = VCYCLE + ["--ckpt-dir", ck, "--ckpt-every", "3"]
    p = subprocess.Popen(_cli(args), env=_env(), cwd=ROOT, stdout=subprocess.DEVNULL,
                         stderr=subprocess.DEVNULL)
    manifest = os.path.join(ck, "manifest.json")
    deadline = time.time() + 240
    try:
        while time.time() < deadline and p.poll() is None and not os.path.exists(manifest):
            time.sleep(0.01)
        assert os.path.exists(manifest), "no checkpoint before timeout/exit"
    finally:
        if p.poll() is None:
            os.kill(p.pid, signal.SIGKILL)
        p.wait(timeout=60)
    assert "resumed at phase=" in _main(args, capsys)
    m = _manifest(ck)
    assert m["meta"]["phase"] == "done"
    got = _read_leaves(os.path.join(ck, m["dir"], "params"))

    ref_dir = str(tmp_path / "ref")
    _main(VCYCLE + ["--ckpt-dir", ref_dir, "--ckpt-every", "1000"], capsys)
    want = _read_leaves(os.path.join(ref_dir, _manifest(ref_dir)["dir"], "params"))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, rtol=0, err_msg=k)
    assert "checkpoint already complete" in _main(args, capsys)
    assert _manifest(ck) == m


def test_launcher_needs_a_card_unless_told_cpu(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = [a for a in SMOKE if a not in ("--device", "cpu")] + ["--steps", "1"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.main(args)
    assert "ProjectionPlan" in _main(args + ["--describe-plans"], capsys)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.train_vcycle_ckpt(_smoke_cfg(), MultiLevelConfig(), TrainConfig(steps=1),
                            ckpt=None, ckpt_every=0)


def test_deit_launcher_sets_the_sequence_to_its_tokens(monkeypatch):
    """For the ViT family the launcher trains at n_patches + 1 tokens
    whatever ``--seq`` says."""
    seen = {}
    monkeypatch.setattr(T, "train_plain",
                        lambda cfg, tc, **kw: seen.update(cfg=cfg, tc=tc))
    T.main(["--arch", "deit-proxy", "--seq", "999", "--steps", "1", "--device", "cpu"])
    from repro_torch.models.vit import n_patches

    assert seen["tc"].seq_len == n_patches(seen["cfg"]) + 1 == 17


def test_final_params_of_the_cli_are_the_library_run(tmp_path, capsys):
    """The CLI's terminal checkpoint holds what ``train_vcycle_ckpt`` returns
    for the same config, schedule and seed."""
    ck = str(tmp_path)
    _main(VCYCLE[:-2] + ["--steps", "10", "--ckpt-dir", ck, "--ckpt-every", "4"], capsys)
    got = _read_leaves(os.path.join(ck, _manifest(ck)["dir"], "params"))
    cfg = get_config("tinyllama-1.1b", smoke=True)
    tc = TrainConfig(steps=10, warmup_steps=1, peak_lr=1e-3, batch_size=2, seq_len=16)
    out = T.train_vcycle_ckpt(cfg, MultiLevelConfig(n_levels=2, alpha=0.25), tc, ckpt=None,
                              ckpt_every=0, verbose=False, device="cpu")
    want = flatten(out.params)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v.detach().numpy(), err_msg=k)
