"""The port's training CLI across ranks on the CPU: ``python -m
repro_torch.launch.train --devices 2 --mesh 2x1 --device cpu`` trains 2
steps in two gloo ranks and rank 0 checkpoints the gathered leaves; the
same run relaunched on a 1x2 mesh resumes from that checkpoint (each rank
takes its slice under the new mesh) and carries on to step 4.  An MoE
model trains over 2 data ranks too (its routing over the global
microbatch)."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro_torch.launch import train as LT

ROOT = Path(__file__).resolve().parents[1]
ARGS = ["--arch", "bit-bert-base", "--smoke", "--device", "cpu", "--devices", "2", "--batch", "4",
        "--seq", "32", "--ckpt-every", "2", "--lr", "1e-3"]


def _run(ckpt: Path, *extra: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *ARGS, "--ckpt-dir", str(ckpt),
                           *extra], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)


def test_devices_and_mesh_train_checkpoint_and_resume_on_another_mesh(tmp_path):
    ckpt = tmp_path / "ckpt"
    first = _run(ckpt, "--mesh", "2x1", "--steps", "2")
    assert first.returncode == 0, first.stderr[-3000:]
    assert first.stdout.count("[runner] step") == 2  # rank 0 alone prints
    assert "[train] loss" in first.stdout and (ckpt / "step_000000002" / "_COMMITTED").exists()
    again = _run(ckpt, "--mesh", "1x2", "--steps", "4")
    assert again.returncode == 0, again.stderr[-3000:]
    assert "resumed from step 2" in again.stdout and again.stdout.count("[runner] step") == 2
    assert (ckpt / "step_000000004" / "_COMMITTED").exists()
    data = np.load(ckpt / "step_000000004" / "arrays.npz")
    assert all(np.isfinite(data[k]).all() for k in data.files if data[k].dtype.kind == "f")


def test_a_mesh_needs_devices():
    with pytest.raises(ValueError, match="exceeds 1 devices"):
        LT.train(LT.parse_args(["--arch", "bit-bert-base", "--smoke", "--device", "cpu", "--mesh", "2x1"]))
    assert LT.backend_for("cpu", 4) == "gloo"


def test_moe_model_trains_over_two_data_ranks(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    run = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch", "deepseek-v2-lite-16b",
                          "--smoke", "--device", "cpu", "--devices", "2", "--mesh", "2x1", "--steps", "2",
                          "--batch", "4", "--seq", "32", "--ckpt-every", "2", "--lr", "1e-3",
                          "--ckpt-dir", str(tmp_path / "ckpt")], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    assert run.stdout.count("[runner] step") == 2 and "[train] loss" in run.stdout
    assert (tmp_path / "ckpt" / "step_000000002" / "_COMMITTED").exists()
