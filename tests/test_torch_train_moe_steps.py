"""AdamW and whole train steps on the MoE / MLA trees, against the JAX
reference on the CPU: the deepseek-v2-lite-16b and deepseek-v3-671b
smoke models (rank-3 stacked experts, the float32 router, v3's MTP head).
The loss and gradients are ``tests/test_torch_train_moe.py``.

* **The decay mask** equals the reference's rank-by-layout rule (ROADMAP
  section 3): every leaf of rank >= 2 in the reference's layout, where a
  period layer's leaves carry the stack's axis -- the ``"Mm"`` layer's
  experts, router and norm gains, ``mtp.proj``; not the prefix ``"Md"``
  layers' norms, nor the final norm.
* **One AdamW step** (op by op) bit for bit where the global norm is
  equal (the unclipped case; the norm itself within 4 float32 ulps),
  as ``tests/test_torch_train_step.py`` holds it.
* **Three steps** against the compiled reference (XLA's fused layers and
  fma, a 1 x 1 mesh): losses within 1e-3 relative (observed 1.9e-4), the
  balance loss within 1e-2 relative (observed 9.2e-4: the compiled
  router's float32 product drifts from the op-by-op one, and the routes
  near a tie move with it).

The port alone, for the four families this slice trains (deepseek-v2-lite,
deepseek-v3, recurrentgemma, mamba2): per-block remat changes no value,
the balance loss included; a run of 2 steps, a checkpoint and 2 resumed
steps equals 4 straight steps bit for bit (rank-3 expert leaves, the MTP
head, the aux metric); ``python -m repro_torch.launch.train`` trains each.
"""

import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs.smoke import smoke_variant as jsmoke
from repro.models import model_zoo as JZ
from repro.optim import adamw as JA
from repro.runtime import train_loop as JTL
from repro_torch import convert
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config as tget
from repro_torch.configs.smoke import smoke_variant as tsmoke
from repro_torch.core import tree
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.models import model_zoo as TZ
from repro_torch.launch import train as train_cli
from repro_torch.optim import adamw as TA
from repro_torch.runtime import fault_tolerance as FT
from repro_torch.runtime import train_loop as TTL
from torch_port_fixtures import release_jax_caches  # noqa: F401  (autouse)

NAMES = ["deepseek-v2-lite-16b", "deepseek-v3-671b"]
FAMILIES = NAMES + ["recurrentgemma-2b", "mamba2-130m"]
OPT = dict(lr=1e-3, warmup_steps=5, total_steps=30)


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


@pytest.fixture(scope="module")
def models():
    built = {}

    def get(name):
        if name not in built:
            jcfg, tcfg = jsmoke(jget(name)), tsmoke(tget(name))
            jparams = JZ.init_params(jax.random.PRNGKey(0), jcfg)
            built[name] = dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams,
                               tparams=convert.from_reference(_np_tree(jparams), tcfg, device="cpu"))
        return built[name]

    return get


@pytest.mark.parametrize("name", NAMES)
def test_decay_mask_is_the_reference_layouts(models, name):
    m = models(name)
    jmask = JA._decay_mask(m["jparams"])
    as_arrays = jax.tree.map(lambda p, d: np.full(p.shape, d, np.float32), m["jparams"], jmask)
    want = dict(tree.leaves_with_paths(convert.from_reference(as_arrays, m["tcfg"], device="cpu")))
    mine = dict(tree.leaves_with_paths(TA.decay_mask(m["tparams"], m["tcfg"])))
    assert set(mine) == set(want)
    for path, w in want.items():
        assert set(torch.unique(w).tolist()) == {mine[path]}, path
    moe = len(m["tcfg"].prefix_layers)  # the first period layer, "Mm"
    for leaf in ("moe/up/w", "moe/down/w", "moe/router/w", "ln1", "attn/kv_norm"):
        assert mine[f"/layers/{moe}/{leaf}"] == 1.0, leaf
    assert mine["/layers/0/ln1"] == mine["/layers/0/attn/kv_norm"] == mine["/final_norm"] == 0.0
    assert mine.get("/mtp/proj/w", 1.0) == 1.0


def test_apply_updates_matches_reference(models):
    """One AdamW step on the deepseek-v2-lite tree from a random state."""
    m = models(NAMES[0])
    rng = np.random.default_rng(0)

    def rand(scale, positive=False):
        return jax.tree.map(lambda p: jnp.asarray(
            (np.abs if positive else np.asarray)(rng.standard_normal(p.shape)).astype(np.float32) * scale),
            m["jparams"])

    grads = rand(1e-3)
    state = JA.OptState(mu=rand(1e-3), nu=rand(1e-4, positive=True), step=jnp.int32(7))
    with jax.disable_jit():
        want_p, want_s, want_m = JA.apply_updates(m["jparams"], grads, state, JA.AdamWConfig(**OPT))

    def cv(t):
        return convert.from_reference(_np_tree(t), m["tcfg"], device="cpu")

    tstate = TA.OptState(mu=cv(state.mu), nu=cv(state.nu), step=torch.tensor(7, dtype=torch.int32))
    got_p, got_s, got_m = TA.apply_updates(m["tparams"], cv(grads), tstate, TA.AdamWConfig(**OPT),
                                           TA.decay_mask(m["tparams"], m["tcfg"]))
    gnorm = np.float32(want_m["grad_norm"])
    assert abs(np.float32(got_m["grad_norm"].item()) - gnorm) <= 4 * np.spacing(gnorm)
    assert np.float32(got_m["lr"].item()) == np.float32(want_m["lr"])
    equal_norm = np.float32(got_m["grad_norm"].item()) == gnorm
    for got, want in ((got_p, want_p), (got_s.mu, want_s.mu), (got_s.nu, want_s.nu)):
        for (path, a), b in zip(tree.leaves_with_paths(got), tree.leaves(cv(want))):
            if equal_norm:
                assert torch.equal(a, b), path
            else:  # the clip factor an ulp apart: every leaf within 1e-6 of its scale
                assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max()), path


def test_three_steps_track_the_compiled_reference(models):
    """deepseek-v2-lite smoke, 3 steps of 4 x 32 tokens from the same
    params and stream, against the reference's compiled step."""
    m = models(NAMES[0])
    jcfg, tcfg = m["jcfg"], m["tcfg"]
    opt = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    jstep = JTL.make_train_step(jcfg, JTL.TrainConfig(optimizer=JA.AdamWConfig(**opt)), mesh,
                                {"tokens": jax.ShapeDtypeStruct((4, 32), jnp.int32)})
    jp, jo = m["jparams"], JA.init_state(m["jparams"])
    tp = m["tparams"]
    to = TA.init_state(tp)
    tstep = TTL.make_train_step(tcfg, TTL.TrainConfig(optimizer=TA.AdamWConfig(**opt)), device="cpu")
    data = dict(vocab_size=tcfg.vocab_size, seq_len=32, global_batch=4, seed=3)
    pj, pt = TokenPipeline(DataConfig(**data)), TokenPipeline(DataConfig(**data))
    for _ in range(3):
        jp, jo, jm = jstep(jp, jo, {"tokens": jnp.asarray(pj.next()["tokens"])})
        tp, to, tm = tstep(tp, to, pt.next())
        for key, rtol in (("loss", 1e-3), ("aux", 1e-2)):
            want = float(jm[key])
            assert abs(float(tm[key]) - want) <= rtol * abs(want), key
        assert np.isfinite(float(tm["grad_norm"]))
    assert int(to.step) == int(jo.step) == 3


@pytest.mark.parametrize("name", FAMILIES)
def test_remat_changes_no_value(name):
    cfg = tsmoke(tget(name))
    params = TZ.init_params(0, cfg, device="cpu")
    tokens = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=2, seed=1)).next()
    runs = [TTL.value_and_grad(params, {"tokens": torch.from_numpy(tokens["tokens"])}, cfg, TTL.TrainConfig(remat=r))
            for r in (True, False)]
    (m1, g1), (m2, g2) = runs
    assert all(torch.equal(m1[k], m2[k]) for k in m1)
    assert (float(m1["aux"]) > 0) == (cfg.moe is not None)
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(g1), tree.leaves(g2)))


def _runner(cfg, workdir, total: int, every: int):
    tcfg = TTL.TrainConfig(optimizer=TA.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4))
    return FT.TrainingRunner(
        TTL.make_train_step(cfg, tcfg, device="cpu"),
        TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=2, seed=2)),
        CheckpointManager(str(workdir), keep=1),
        FT.RunnerConfig(total_steps=total, checkpoint_every=every, log_every=10**6), log_fn=lambda *_: None)


def test_resume_is_bitwise_with_experts_and_mtp(tmp_path):
    """deepseek-v3 smoke: 4 straight steps against 2, a checkpoint, a
    restore into fresh trees and 2 more -- params (rank-3 experts, the MTP
    head) and AdamW state bit for bit, the aux metric in the history."""
    cfg = tsmoke(tget("deepseek-v3-671b"))
    p0, o0 = TTL.init_train_state(1, cfg, device="cpu")
    assert p0["layers"][3]["moe"]["up"]["w"].ndim == 3 and "mtp" in p0
    pa, oa, hist = _runner(cfg, tmp_path / "straight", 4, 10**6).run(p0, o0)
    assert all(h["aux"] > 0 for h in hist)
    _runner(cfg, tmp_path / "cut", 2, 2).run(p0, o0)
    resumed = _runner(cfg, tmp_path / "cut", 4, 10**6)
    fresh_p, fresh_o = TTL.init_train_state(2, cfg, device="cpu")
    start, pr, orr = resumed.try_restore(fresh_p, fresh_o)
    assert start == 2
    pb, ob, _ = resumed.run(pr, orr, start)
    for a, b in zip(tree.leaves((pa, oa)), tree.leaves((pb, ob))):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("name", FAMILIES)
def test_train_cli_trains_the_family(name, tmp_path, capsys):
    argv = ["train", "--arch", name, "--smoke", "--device", "cpu", "--steps", "2", "--batch", "2", "--seq", "16",
            "--ckpt-every", "2", "--ckpt-dir", str(tmp_path)]
    with mock.patch.object(sys, "argv", argv):
        train_cli.main()
    out = capsys.readouterr().out
    assert "[train] loss" in out and "nan" not in out
    assert CheckpointManager(str(tmp_path)).latest_step() == 2
