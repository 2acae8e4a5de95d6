"""The port's examples (``examples/torch_*.py``) run on the CPU at a smoke
size through the functions their ``main`` calls, 2-4 steps each."""

import dataclasses
import importlib.util
import pathlib

import pytest

from repro_torch.configs import get_config
from repro_torch.configs.smoke import smoke_variant
from torch_port_fixtures import release_jax_caches  # noqa: F401  (autouse)

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"


def _load(name):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart():
    out = _load("torch_quickstart").run("cpu")
    assert out["flow_err"] < 1e-4 and out["act_act_err"] < 1e-4
    assert out["kernel_equal"] and out["pack_ratio"] == 32
    errs = [out["mode_err"][m] for m in ("W1A1", "W1A2", "W1A4", "W1A8")]
    assert errs == sorted(errs, reverse=True)  # more activation bits, less error


def test_serve_example():
    cfg = dataclasses.replace(smoke_variant(get_config("granite-8b")), n_layers=1)
    done = _load("torch_serve_binary_lm").run(cfg, steps=3, device="cpu")
    assert len(done) == 10 and all(len(r.output) == 3 and r.state == "ok" for r in done)


def test_train_example_checkpoints_and_resumes(tmp_path):
    T = _load("torch_train_binary_lm")
    cfg = T.build_cfg(d_model=32, layers=1, vocab=64)
    assert T.build_cfg().param_count() == 64_225_280
    hist = T.run(cfg, 2, "cpu", batch=2, seq=8, ckpt_dir=str(tmp_path))
    assert [h["step"] for h in hist] == [1, 2]
    assert sorted(p.name for p in tmp_path.iterdir() if p.name.startswith("step_"))
    more = T.run(cfg, 3, "cpu", batch=2, seq=8, ckpt_dir=str(tmp_path))
    assert [h["step"] for h in more] == [3]  # resumed from step 2


def test_precision_tradeoff_example():
    P = _load("torch_precision_tradeoff")
    cfg = dataclasses.replace(P.build_cfg(8), n_layers=1, d_model=32, d_ff=64, vocab_size=64, n_heads=2,
                              n_kv_heads=2)
    rows = P.run(cfg, 2, "cpu")
    assert [r[0] for r in rows] == ["W1A8", "W1A4", "W1A2", "W1A1"]
    effs = [r[3] for r in rows]
    assert effs == sorted(effs) and all(r[1] == r[1] for r in rows)  # finite losses


@pytest.mark.parametrize("name", ["torch_quickstart", "torch_serve_binary_lm", "torch_train_binary_lm",
                                  "torch_precision_tradeoff"])
def test_examples_default_to_the_card(name):
    src = (EXAMPLES / f"{name}.py").read_text()
    assert 'ap.add_argument("--device", default="cuda"' in src
