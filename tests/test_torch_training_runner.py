"""The port's preemption-safe training runner (``repro_torch.runtime.
fault_tolerance``) and its CLI (``python -m repro_torch.launch.train``) on
the CPU: the reference's behaviours of ``tests/test_fault_tolerance.py``.

* 10 straight steps equal 4 steps, a checkpoint and 6 resumed steps, bit
  for bit (params, both Adam moments, the step and the data cursor);
* a SIGTERM'd CLI child checkpoints at its next step boundary, and the
  relaunched child ends at an uninterrupted run's params, bit for bit;
* the pipeline reshards with its cursor; step-time percentiles; the signal
  handlers chain and are restored.
"""

import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.configs.smoke import smoke_variant
from repro_torch.core import tree
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.optim import adamw
from repro_torch.runtime import fault_tolerance as FT
from repro_torch.runtime import train_loop as TL

ROOT = Path(__file__).resolve().parents[1]


def _mini_setup(tmp_path, steps=10, ckpt_every=4, schedule_steps=10):
    """``steps`` is where the RUN stops, ``schedule_steps`` the optimizer's
    horizon, so a cut run and its resume share the learning-rate path."""
    cfg = smoke_variant(get_config("bit-bert-base"))
    tcfg = TL.TrainConfig(
        optimizer=adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=schedule_steps)
    )
    step = TL.make_train_step(cfg, tcfg, device="cpu")
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4, seed=3))
    mgr = CheckpointManager(str(tmp_path), keep=2)
    runner = FT.TrainingRunner(
        step, pipe, mgr,
        FT.RunnerConfig(total_steps=steps, checkpoint_every=ckpt_every, log_every=100),
        log_fn=lambda *_: None,
    )
    params, opt = TL.init_train_state(0, cfg, device="cpu")
    return cfg, runner, params, opt, mgr, pipe


def _assert_trees_equal(a, b):
    la, lb = tree.leaves(a), tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_resume_is_bit_exact(tmp_path):
    """Train 10 straight vs train 4 + checkpoint + resume 6: identical."""
    _, runner, params, opt, _, pipe_a = _mini_setup(tmp_path / "a", steps=10)
    pa, oa, _ = runner.run(params, opt)

    _, runner1, params, opt, _, _ = _mini_setup(tmp_path / "b", steps=4)
    runner1.run(params, opt)
    _, runner2, params2, opt2, _, pipe_b = _mini_setup(tmp_path / "b", steps=10)
    start, pr, orr = runner2.try_restore(params2, opt2)
    assert start == 4 and pipe_b.cursor == 4
    assert isinstance(orr, adamw.OptState) and int(orr.step) == 4
    pb, ob, _ = runner2.run(pr, orr, start)

    _assert_trees_equal(pa, pb)
    _assert_trees_equal(oa, ob)
    assert pipe_a.cursor == pipe_b.cursor == 10


def _train_cmd(ckpt_dir, steps, every):
    return [sys.executable, "-m", "repro_torch.launch.train", "--arch", "bit-bert-base", "--smoke",
            "--device", "cpu", "--steps", str(steps), "--batch", "4", "--seq", "32",
            "--ckpt-dir", str(ckpt_dir), "--ckpt-every", str(every)]


def test_sigterm_preemption_subprocess(tmp_path):
    """SIGTERM a real CLI run after its first checkpoint; it checkpoints at
    the next boundary and exits.  A relaunch with the same flags resumes
    from there and ends at the params of an uninterrupted run."""
    steps, every = 40, 5
    # one thread a child: the test workers already hold the cores
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    cut = tmp_path / "cut"
    proc = subprocess.Popen(_train_cmd(cut, steps, every), env=env, cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.monotonic() + 120
        while not (cut / f"step_{every:09d}" / "_COMMITTED").exists():
            assert proc.poll() is None and time.monotonic() < deadline, "no first checkpoint"
            time.sleep(0.02)
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, out[-2000:]
    assert "exiting after preemption checkpoint" in out, out[-2000:]
    stopped = CheckpointManager(str(cut)).latest_step()
    assert stopped is not None and every <= stopped < steps, out[-2000:]

    resumed = subprocess.run(_train_cmd(cut, steps, every), env=env, cwd=ROOT, capture_output=True,
                             text=True, timeout=240)
    assert resumed.returncode == 0, resumed.stdout[-2000:] + resumed.stderr[-2000:]
    assert f"resumed from step {stopped}" in resumed.stdout, resumed.stdout[-2000:]

    # the uninterrupted run, in this process, with the CLI's settings
    cfg = smoke_variant(get_config("bit-bert-base"))
    tcfg = TL.TrainConfig(optimizer=adamw.AdamWConfig(lr=3e-4, warmup_steps=steps // 10, total_steps=steps))
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4, seed=0))
    runner = FT.TrainingRunner(TL.make_train_step(cfg, tcfg, device="cpu"), pipe,
                               CheckpointManager(str(tmp_path / "straight"), keep=1),
                               FT.RunnerConfig(total_steps=steps, checkpoint_every=steps, log_every=steps),
                               log_fn=lambda *_: None)
    params, opt = TL.init_train_state(0, cfg, device="cpu")
    want_p, want_o, _ = runner.run(params, opt)
    _, restored, extras = CheckpointManager(str(cut)).restore(steps, like={"params": want_p, "opt": want_o})
    _assert_trees_equal(restored["params"], want_p)
    _assert_trees_equal(restored["opt"], want_o)
    assert extras["pipeline"]["cursor"] == steps


def test_elastic_rescale_via_checkpoint(tmp_path):
    """Save from a 1-shard run, restore into a 2-shard pipeline."""
    _, runner, params, opt, mgr, pipe = _mini_setup(tmp_path, steps=4)
    p1, o1, _ = runner.run(params, opt)
    new_pipe = pipe.reshard(shard_index=1, num_shards=2)
    assert new_pipe.cursor == pipe.cursor and new_pipe.local_batch == 2
    step, restored, extras = mgr.restore(like={"params": p1, "opt": o1})
    assert step == 4 and extras["pipeline"]["cursor"] == pipe.cursor
    _assert_trees_equal(restored["params"], p1)


def test_straggler_metrics_exposed(tmp_path):
    _, runner, params, opt, _, _ = _mini_setup(tmp_path, steps=6)
    _, _, hist = runner.run(params, opt)
    assert len(runner.step_times) == 6
    assert runner.p50 > 0 and runner.p99 >= runner.p50
    assert hist[-1]["step"] == 6 and np.isfinite(hist[-1]["loss"]) and hist[-1]["step_time_s"] > 0


def test_signal_handlers_chain_and_restore(tmp_path):
    """install_signal_handlers saves, CHAINS and restores whatever the host
    process had installed."""
    _, runner, *_ = _mini_setup(tmp_path, steps=2)
    chained = []

    def host_handler(signum, frame):
        chained.append(signum)

    original = signal.signal(signal.SIGTERM, host_handler)
    try:
        runner.install_signal_handlers()
        assert signal.getsignal(signal.SIGTERM) is not host_handler
        runner_handler = signal.getsignal(signal.SIGTERM)
        runner.install_signal_handlers()  # idempotent: the saved originals stay
        assert signal.getsignal(signal.SIGTERM) is runner_handler

        signal.raise_signal(signal.SIGTERM)
        assert runner._preempted
        assert chained == [signal.SIGTERM]

        runner.restore_signal_handlers()
        assert signal.getsignal(signal.SIGTERM) is host_handler
        chained.clear()
        signal.raise_signal(signal.SIGTERM)
        assert chained == [signal.SIGTERM]
    finally:
        signal.signal(signal.SIGTERM, original)


def test_preempted_run_checkpoints_at_the_next_boundary(tmp_path):
    """A run marked preempted saves after its current step and stops."""
    _, runner, params, opt, mgr, pipe = _mini_setup(tmp_path, steps=10, ckpt_every=100)
    runner._preempted = True
    runner.run(params, opt)
    assert mgr.latest_step() == 1 and pipe.cursor == 1
