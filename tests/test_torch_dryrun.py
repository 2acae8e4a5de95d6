"""The port's dry-run (``repro_torch.launch.dryrun``): the smoke cell's
per-device argument bytes equal the reference's compiled cell's (the
reference run in a subprocess with the 512 host devices its module asks
for), cached cells are not recomputed, refused steps are recorded with
their reasons beside the numbers the sharding rules give, and the kernel
wrappers' shape-only path on ``meta``."""

import json
import os
import subprocess
import sys

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.core import packing
from repro_torch.kernels import binary_qmm as K1
from repro_torch.kernels import popcount_qmm as K3
from repro_torch.launch import dryrun

REPO = os.path.normpath(os.path.join(os.path.dirname(__file__), ".."))
REFERENCE_TIMEOUT_S = 240


def _reference_smoke_cell(out_dir) -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512")
    run = subprocess.run([sys.executable, "-m", "repro.launch.dryrun", "--arch", "smoke", "--out", str(out_dir)],
                         cwd=REPO, env=env, capture_output=True, text=True, timeout=REFERENCE_TIMEOUT_S)
    assert run.returncode == 0, run.stderr[-2000:]
    with open(os.path.join(out_dir, "smoke__smoke__single.json")) as f:
        return json.load(f)


def test_smoke_cell_argument_bytes_equal_the_references(tmp_path):
    want = _reference_smoke_cell(tmp_path / "reference")
    assert want["status"] == "ok"
    got = dryrun.run_cell("smoke", "smoke", "single")
    assert got["memory"]["argument_size_in_bytes"] == want["memory"]["argument_size_in_bytes"]
    for key in ("params", "active_params", "seq_len", "global_batch", "kind", "mesh_shape"):
        assert got[key] == want[key], key
    # the rules' numbers stand; the port's mesh step has no sequence
    # parallelism, so 8 rows over 16 data ranks are refused, not guessed
    assert got["status"] == "error" and "does not split over 16 data ranks" in got["error"]
    assert "flops" not in got and got["collectives"]["all-gather"]["count"] == 2


def test_cached_cell_recomputes_nothing(tmp_path, monkeypatch, capsys):
    args = ["--arch", "smoke", "--shape", "decode_32k", "--out", str(tmp_path)]
    dryrun.main(args)
    path = dryrun.cell_path(str(tmp_path), "smoke", "decode_32k", "single")
    with open(path) as f:
        first = json.load(f)
    assert first["status"] == "ok" and first["schema"] == dryrun.SCHEMA and first["flops"] > 0

    def recompute(*a, **k):
        raise AssertionError("a cached cell was recomputed")

    monkeypatch.setattr(dryrun, "run_cell", recompute)
    dryrun.main(args)
    assert "[cached] smoke decode_32k single: ok" in capsys.readouterr().out
    with open(path) as f:
        assert json.load(f) == first


def test_refused_training_cells_keep_the_rules_numbers():
    pod = dryrun.run_cell("smoke", "train_4k", "multi")
    assert pod["status"] == "error" and "'pod' axis of 2 ranks" in pod["error"]
    assert pod["memory"]["argument_size_in_bytes"] > 0 and "flops" not in pod
    moe = dryrun.run_cell("deepseek-v2-lite-16b", "train_4k", "single")
    assert moe["status"] == "error" and "7.4b" in moe["error"]
    assert moe["memory"]["arguments"]["opt_state"] > moe["memory"]["arguments"]["params"] > 0


def test_serving_cells_count_a_ranks_share():
    single = dryrun.run_cell("smoke", "prefill_32k", "single")
    multi = dryrun.run_cell("smoke", "prefill_32k", "multi")
    assert single["status"] == multi["status"] == "ok"
    assert single["data_ranks"] == 16 and multi["data_ranks"] == 32
    assert single["flops"] == 2 * multi["flops"]  # 2 rows a rank against 1
    assert "collectives" not in single  # serving runs no mesh step


def test_kernel_wrappers_give_shapes_on_meta():
    """On ``meta`` a wrapper runs its plain version for the output's shape
    and dtype (no launch), and the flop counter counts its integer product
    as ``2 M K N``."""
    m, k, n = 5, 70, 9
    a = torch.empty((m, k), dtype=torch.int8, device="meta")
    w = torch.empty((packing.packed_len(k, 1), n), dtype=torch.int32, device="meta")
    before = K1.binary_qmm.launches, K3.popcount_qmm.launches
    with FlopCounterMode(display=False) as counter:
        out = K1.binary_qmm(a, w, k)
    assert out.device.type == "meta" and out.shape == (m, n) and out.dtype == torch.int32
    assert counter.get_total_flops() == 2 * m * k * n
    got = K3.popcount_qmm(torch.empty((m, 3), dtype=torch.int32, device="meta"), w[:3])
    assert got.shape == (m, n) and (K1.binary_qmm.launches, K3.popcount_qmm.launches) == before


@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
def test_skips_are_the_references(shape):
    rec = dryrun.run_cell("smoke", shape, "single")
    if shape == "long_500k":  # granite is not sub-quadratic
        assert rec["status"] == "skip" and "sub-quadratic" in rec["reason"]
    else:
        assert rec["status"] == "ok"


def test_mesh_step_refuses_a_pod_axis():
    """The mesh step reduces its fake-quant ranges and gradients over
    ``data`` alone, so it refuses a mesh with a ``pod`` axis of more than
    one rank (an MoE model over data ranks stays refused too, item 7.4b)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.smoke import smoke_variant
    from repro_torch.launch.mesh import abstract_mesh
    from repro_torch.runtime import train_loop as TL

    cfg = smoke_variant(get_config("granite-8b"))
    pods = abstract_mesh((2, 1, 1), ("pod", "data", "model"))
    with pytest.raises(NotImplementedError, match="'pod' axis of 2 ranks"):
        TL.make_train_step(cfg, TL.TrainConfig(), device="cpu", mesh=pods)
    assert TL.mesh_step_refusal(cfg, abstract_mesh((1, 2, 1), ("pod", "data", "model"))) is None
    moe = smoke_variant(get_config("deepseek-v2-lite-16b"))
    assert "7.4b" in TL.mesh_step_refusal(moe, abstract_mesh((2, 1), ("data", "model")))
    assert TL.mesh_step_refusal(moe, abstract_mesh((1, 2), ("data", "model"))) is None
