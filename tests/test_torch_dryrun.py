"""The port's dry-run (``repro_torch.launch.dryrun``): the smoke cell's
per-device argument bytes equal the reference's compiled cell's (the
reference run in a subprocess with the 512 host devices its module asks
for), cached cells are not recomputed, refused steps are recorded with
their reasons beside the numbers the sharding rules give, serving cells
count the sharded serving step, and the kernel wrappers' shape-only path
on ``meta``."""

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
    # a training cell: the smoke arch's serving cells are refused at the
    # production mesh's 16 model ranks (one kv head), and only completed
    # cells are cached
    args = ["--arch", "smoke", "--shape", "train_4k", "--out", str(tmp_path)]
    dryrun.main(args)
    path = dryrun.cell_path(str(tmp_path), "smoke", "train_4k", "single")
    with open(path) as f:
        first = json.load(f)
    assert first["status"] == "ok" and first["schema"] == dryrun.SCHEMA and first["flops"] > 0

    def recompute(*a, **k):
        raise AssertionError("a cached cell was recomputed")

    monkeypatch.setattr(dryrun, "run_cell", recompute)
    dryrun.main(args)
    assert "[cached] smoke train_4k single: ok" in capsys.readouterr().out
    with open(path) as f:
        assert json.load(f) == first


def test_a_serving_cell_that_splits_is_counted_and_cached(tmp_path, monkeypatch, capsys):
    """gemma3-27b's 32 query and 16 kv heads split over the production
    mesh's 16 model ranks: its prefill cell is not skipped (the reference
    lowers it too), is counted ``ok`` with its collectives, and is cached."""
    args = ["--arch", "gemma3-27b", "--shape", "prefill_32k", "--out", str(tmp_path)]
    dryrun.main(args)
    path = dryrun.cell_path(str(tmp_path), "gemma3-27b", "prefill_32k", "single")
    with open(path) as f:
        first = json.load(f)
    assert first["status"] == "ok" and first["kind"] == "prefill" and first["flops"] > 0
    assert first["collectives"]["all-reduce"]["bytes"] > 0 and first["collectives"]["all-gather"]["bytes"] > 0

    def recompute(*a, **k):
        raise AssertionError("a cached cell was recomputed")

    monkeypatch.setattr(dryrun, "run_cell", recompute)
    dryrun.main(args)
    assert "[cached] gemma3-27b prefill_32k single: ok" in capsys.readouterr().out
    with open(path) as f:
        assert json.load(f) == first


def test_refused_training_cells_keep_the_rules_numbers():
    pod = dryrun.run_cell("smoke", "train_4k", "multi")
    assert pod["status"] == "error" and "'pod' axis of 2 ranks" in pod["error"]
    assert pod["memory"]["argument_size_in_bytes"] > 0 and "flops" not in pod
    moe = dryrun.run_cell("deepseek-v2-lite-16b", "train_4k", "single")
    assert moe["status"] == "ok" and moe["flops"] > 0
    assert moe["memory"]["arguments"]["opt_state"] > moe["memory"]["arguments"]["params"] > 0
    # the routing's collectives, each MoE layer counted twice a step (the
    # forward and remat's recompute), the balance gradient once
    coll, layers = moe["collectives"], 26
    routing = coll["routing"]
    assert {k: v["count"] for k, v in routing.items()} == {"counts": 2 * layers, "buffer": 2 * layers,
                                                          "balance": 2 * layers, "balance_grad": layers}
    assert routing["counts"]["bytes"] == 2 * layers * 16 * 64 * 4  # (16 ranks, 64 experts) int32
    assert coll["all-reduce"]["bytes"] == 3 * layers * 64 * 4
    assert coll["total_bytes"] == sum(coll[op]["bytes"] for op in ("all-gather", "reduce-scatter", "all-reduce"))


def test_serving_cells_count_a_ranks_share():
    """A serving cell counts the sharded step (``serve_loop.MeshStep``) as
    it runs on ``meta``: gemma3-27b's decode over 16 data x 16 model ranks
    does a sixteenth of the matrix products of its 8 rows computed whole
    (every product splits one of its dims over ``model``: heads, FFN
    columns, K at the row-parallel sites, the vocabulary), and its
    collectives carry what the step hands them; the smoke arch (one kv
    head) is refused with its reason, beside its argument bytes."""
    from repro_torch.configs import get_config
    from repro_torch.models import model_zoo as Z

    cell = dryrun.run_cell("gemma3-27b", "decode_32k", "single")
    assert cell["status"] == "ok" and cell["data_ranks"] == 16
    cfg = get_config("gemma3-27b")
    rows, d, v, n = 128 // 16, cfg.d_model, cfg.vocab_size, cfg.n_layers
    params = Z.prepare_serving_params(Z.init_params(0, cfg, device="meta"), cfg)
    tokens = torch.empty((rows,), dtype=torch.int64, device="meta")
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        Z.decode_step(params, tokens, cfg, Z.init_cache(rows, 32768, cfg, device="meta"))
    assert 16 * cell["flops"] == counter.get_total_flops()
    # a layer: the query's grid, and at attn.o and ffn.down the per-token
    # ranges and the int32 product with its row sums; then the embedding's
    # rows (bf16 bytes), the vocabulary shards' logits, the data ranks'
    # logits, and the cache's whole-batch leaves (4 affines and the cursor
    # a layer) in one gather
    ranges, partials = 2 * rows * 4, (rows * d + rows) * 4
    assert cell["collectives"]["all-reduce"] == {"bytes": n * (3 * ranges + 2 * partials), "count": 5 * n}
    gathers = rows * d * 2 + rows * v // 16 * 4 + rows * v * 4 + n * 5 * rows * 4
    assert cell["collectives"]["all-gather"] == {"bytes": gathers, "count": 4}
    assert cell["collectives"]["total_bytes"] == gathers + n * (3 * ranges + 2 * partials)
    smoke = dryrun.run_cell("smoke", "prefill_32k", "single")
    assert smoke["status"] == "error" and "n_kv_heads 1 does not split over 16 'model' ranks" in smoke["error"]
    assert "ROADMAP item 7.8, follow-up 5" in smoke["error"]
    assert smoke["memory"]["argument_size_in_bytes"] > 0 and "flops" not in smoke


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


@pytest.mark.parametrize("shape", ["decode_32k", "long_500k", "deepseek-v3-671b:decode_32k"])
def test_skips_are_the_references(shape, tmp_path, capsys):
    arch, shape = shape.split(":") if ":" in shape else ("smoke", shape)
    if arch != "smoke":  # served over the production mesh, as the reference lowers it; cached
        args = ["--arch", arch, "--shape", shape, "--out", str(tmp_path)]
        dryrun.main(args)
        with open(dryrun.cell_path(str(tmp_path), arch, shape, "single")) as f:
            rec = json.load(f)
        assert rec["status"] == "ok" and rec["data_ranks"] == 16 and rec["flops"] > 0
        assert rec["collectives"]["total_bytes"] > 0
        capsys.readouterr()
        dryrun.main(args)
        assert f"[cached] {arch} {shape} single: ok" in capsys.readouterr().out
        return
    rec = dryrun.run_cell(arch, shape, "single")
    if shape == "long_500k":  # granite is not sub-quadratic
        assert rec["status"] == "skip" and "sub-quadratic" in rec["reason"]
    else:  # not skipped: counted, and refused by the sharded serving step (one kv head over 16)
        assert rec["status"] == "error" and "does not split over 16 'model' ranks" in rec["error"]
        assert "ROADMAP item 7.8, follow-up 5" in rec["error"]


def test_mesh_step_refuses_a_pod_axis():
    """The mesh step reduces its fake-quant ranges and gradients over
    ``data`` alone, so it refuses a mesh with a ``pod`` axis of more than
    one rank; an MoE model over data ranks routes the global microbatch and
    is not refused."""
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
    assert TL.mesh_step_refusal(moe, abstract_mesh((2, 1), ("data", "model"))) is None
    assert TL.mesh_step_refusal(moe, abstract_mesh((1, 2), ("data", "model"))) is None
    assert "'pod' axis of 2 ranks" in TL.mesh_step_refusal(moe, pods)
