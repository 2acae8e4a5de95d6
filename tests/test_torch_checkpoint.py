"""The port's checkpoint manager (``repro_torch.checkpoint``): the
reference's tests of ``tests/test_checkpoint.py`` on torch leaves, the
serving caches' dtypes bit for bit, and its JSON manifest."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import repro_torch.checkpoint.manager as CM
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.tree import leaves_with_paths
from torch_port_fixtures import release_jax_caches  # noqa: F401  (autouse)


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "a": torch.randn((16, 8), generator=g),
        "nested": {"b": torch.arange(10, dtype=torch.int32) + seed},
    }


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zeros_like(v) for v in tree]
    return torch.zeros_like(tree)


def _assert_equal(a, b):
    la, lb = leaves_with_paths(a), leaves_with_paths(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    bits = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
    for (_, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        as_bits = bits.get(x.dtype, x.dtype)  # NaNs compare by their bits
        assert torch.equal(x.view(as_bits), y.view(as_bits))


def test_save_restore_roundtrip(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=3)
    tree = _tree()
    m.save(5, tree, extras={"pipeline": {"cursor": 42, "seed": 0}})
    step, out, extras = m.restore(like=_zeros_like(tree))
    assert step == 5
    assert extras["pipeline"]["cursor"] == 42
    _assert_equal(out, tree)


def test_keep_k_prunes_old(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        m.save(s, _tree(s))
    steps = sorted(int(n.split("_")[1]) for n in os.listdir(tmp_path) if n.startswith("step_"))
    assert steps == [3, 4]


def test_latest_ignores_uncommitted(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=3)
    m.save(1, _tree())
    os.makedirs(tmp_path / "step_000000002")  # a torn write: no _COMMITTED
    assert m.latest_step() == 1


def test_restore_rejects_shape_mismatch_and_missing_leaf(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=1)
    m.save(1, _tree())
    with pytest.raises(ValueError, match="shape mismatch"):
        m.restore(like={"a": torch.zeros((4, 4)), "nested": {"b": torch.zeros(10, dtype=torch.int32)}})
    with pytest.raises(KeyError, match="missing leaf"):
        m.restore(like={"a": torch.zeros((16, 8)), "c": torch.zeros(3)})
    with pytest.raises(ValueError, match="like="):
        m.restore()
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(like=_tree())


def test_overwrite_replaces_content_without_residue(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=3)
    m.save(1, _tree(1), extras={"v": 1})
    m.save(1, _tree(2), extras={"v": 2})
    step, out, extras = m.restore(like=_zeros_like(_tree()))
    assert step == 1 and extras["v"] == 2
    _assert_equal(out, _tree(2))
    assert not [n for n in os.listdir(tmp_path) if ".old-" in n or ".tmp-" in n]


def test_overwrite_crash_between_renames_restores_old_step(tmp_path, monkeypatch):
    """Fail the tmp -> final rename of an overwrite: the step committed
    before stays restorable (renamed aside, then back)."""
    m = CheckpointManager(str(tmp_path), keep=3)
    t1 = _tree(1)
    m.save(7, t1, extras={"v": 1})
    real_rename = os.rename

    def failing_rename(src, dst):
        if os.path.basename(dst) == "step_000000007":
            raise OSError("injected crash between renames")
        return real_rename(src, dst)

    monkeypatch.setattr(CM.os, "rename", failing_rename)
    with pytest.raises(OSError, match="injected crash"):
        m.save(7, _tree(2), extras={"v": 2})
    monkeypatch.undo()
    m2 = CheckpointManager(str(tmp_path), keep=3)
    step, out, extras = m2.restore(like=_zeros_like(t1))
    assert step == 7 and extras["v"] == 1
    _assert_equal(out, t1)
    assert not [n for n in os.listdir(tmp_path) if ".old-" in n]


def test_recovery_renames_stranded_aside_back(tmp_path):
    """A hard crash between the two renames leaves only
    ``step_X.old-<nonce>`` (and a torn husk): recovery puts it back.  The
    inverse crash point (commit landed, aside not removed) drops the aside."""
    m = CheckpointManager(str(tmp_path), keep=3)
    t = _tree(3)
    m.save(2, t, extras={"v": 3})
    final = os.path.join(str(tmp_path), "step_000000002")
    os.rename(final, final + ".old-deadbeef")
    os.makedirs(final)
    with open(os.path.join(final, "arrays.npz"), "wb") as f:
        f.write(b"torn")
    m2 = CheckpointManager(str(tmp_path), keep=3)
    assert m2.latest_step() == 2
    _, out, extras = m2.restore(like=_zeros_like(t))
    assert extras["v"] == 3
    _assert_equal(out, t)
    assert not [n for n in os.listdir(tmp_path) if ".old-" in n]
    shutil.copytree(final, final + ".old-cafe0000")
    m3 = CheckpointManager(str(tmp_path), keep=3)
    assert m3.latest_step() == 2
    assert not [n for n in os.listdir(tmp_path) if ".old-" in n]


def _serving_leaves():
    """The dtypes of the port's serving caches: bf16 rows, int8 mantissas,
    packed 1-bit words (int32, every bit pattern), float32 affines, int32
    cursors, int64 next tokens."""
    g = torch.Generator().manual_seed(0)
    words = torch.randint(-(2**31), 2**31 - 1, (3, 5, 2, 4), generator=g, dtype=torch.int64)
    return {
        "layers": [
            {
                "k": (torch.randn((2, 6, 2, 8), generator=g) * 3).to(torch.bfloat16),
                "v": torch.randint(-128, 128, (2, 6, 2, 8), generator=g, dtype=torch.int8),
                "k_scale": torch.rand((2,), generator=g),
                "pos": torch.tensor([5, 0], dtype=torch.int32),
            },
            {"k": words.to(torch.int32), "pos": torch.tensor([1, 2, 3], dtype=torch.int32)},
        ],
        "special": torch.tensor([float("nan"), float("inf"), -0.0, 1e-40], dtype=torch.bfloat16),
        "cur": torch.tensor([7, 2**40], dtype=torch.int64),
    }


def test_serving_dtypes_roundtrip_bit_for_bit(tmp_path):
    tree = _serving_leaves()
    m = CheckpointManager(str(tmp_path), keep=1)
    m.save(3, tree)
    _, out, _ = m.restore(like=_zeros_like(tree))
    _assert_equal(out, tree)


def test_manifest_is_json_with_dtypes_and_paths(tmp_path):
    tree = _serving_leaves()
    m = CheckpointManager(str(tmp_path), keep=1)
    m.save(4, tree, extras={"serve": {"arch": "x", "queue_rids": [3, 1]}})
    d = tmp_path / "step_000000004"
    assert sorted(os.listdir(d)) == ["_COMMITTED", "arrays.npz", "manifest.json"]
    man = json.loads((d / "manifest.json").read_text())
    assert CM._read_manifest(str(d)) == man
    assert man["step"] == 4 and man["extras"]["serve"]["queue_rids"] == [3, 1]
    by_path = {e["path"]: e for e in man["leaves"]}
    assert by_path["/layers/0/k"] == {"path": "/layers/0/k", "dtype": "bfloat16", "shape": [2, 6, 2, 8],
                                      "stored_as": "uint16"}
    assert by_path["/layers/1/k"]["dtype"] == "int32" and "stored_as" not in by_path["/layers/1/k"]
    assert [by_path[p]["dtype"] for p in ("/layers/0/v", "/layers/0/k_scale", "/cur")] == [
        "int8", "float32", "int64"]
    arrays = np.load(d / "arrays.npz")
    assert arrays["a0"].dtype == np.uint16


def test_restore_takes_the_template_dtype(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=1)
    m.save(1, {"x": torch.arange(6, dtype=torch.int32)})
    _, out, _ = m.restore(like={"x": torch.zeros(6, dtype=torch.int64)})
    assert out["x"].dtype == torch.int64 and out["x"].tolist() == list(range(6))


def test_optimizer_state_roundtrips_as_a_namedtuple(tmp_path):
    """A training checkpoint ``{"params", "opt"}``: the AdamW state is a
    ``NamedTuple`` (rebuilt field by field, not from one generator) whose
    step is a 0-d int32 leaf (kept 0-d); a bf16 leaf keeps its bits."""
    from repro_torch.optim.adamw import OptState

    g = torch.Generator().manual_seed(4)
    params = {"w": torch.randn((8, 4), generator=g), "g": torch.randn((4,), generator=g).to(torch.bfloat16)}
    opt = OptState(mu={"w": torch.randn((8, 4), generator=g), "g": torch.randn((4,), generator=g)},
                   nu=[torch.rand((8, 4), generator=g), torch.rand((4,), generator=g).to(torch.bfloat16)],
                   step=torch.tensor(17, dtype=torch.int32))
    tree = {"params": params, "opt": opt}
    m = CheckpointManager(str(tmp_path), keep=1)
    m.save(3, tree, extras={"step": 3})
    like = {"params": _zeros_like(params), "opt": OptState(*_zeros_like(list(opt)))}
    step, out, _ = m.restore(like=like)
    assert step == 3
    assert type(out["opt"]) is OptState
    assert out["opt"].step.shape == () and int(out["opt"].step) == 17
    assert isinstance(out["opt"].nu, list)
    _assert_equal(out["params"], params)
    _assert_equal(list(out["opt"]), list(opt))
