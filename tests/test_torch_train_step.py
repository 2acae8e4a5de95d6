"""QAT training on the CPU: the port's ``model_zoo.loss_fn`` and its
gradients, ``optim.adamw`` and ``runtime.train_loop`` against the JAX
reference, same params.

The oracle is the reference run op by op (``jax.disable_jit()``):
``jax.value_and_grad(model_zoo.loss_fn)`` and ``adamw.apply_updates``
called directly.  Params cross through ``repro_torch.convert`` (the
gradients too: they share the params' layout).  Tolerances, as observed on
the smoke variants here:

* **Loss** (``LOSS_RTOL``): relative 1e-6; observed 8.6e-8, one float32
  ulp, on all four models.  The cause: XLA's own ``exp`` and ``log`` in
  ``log_softmax`` and its order for the means.
* **Gradients** (``GRAD_TOL``): each leaf within 1e-2 of its largest
  magnitude; observed up to 7.5e-3 (gemma3-27b's first layer ``attn.q``),
  1.6e-3 on bit-bert-base W1A1's tables.  Every FFN weight's gradient is
  bit for bit: the fake quantizers, the float einsums and the gelu / silu
  backward (``layers._Gelu`` / ``_Silu``) mirror the reference's.  The
  gap enters at the float32 scores: XLA's ``exp`` in the softmax and its
  dot order move a float32 gradient by an ulp, which now and then flips
  the bf16 rounding of a q or k gradient.
* **AdamW**: bit for bit (params, both moments) where the reference's
  global norm is equal (the unclipped case here); the norm itself within
  4 float32 ulps (XLA sums in its own order), and where it differs (the
  clipped case) every leaf within 1e-6 of its largest magnitude.  The cosine schedule within 2
  ulps (observed 1): XLA's float32 ``cos`` is its own.
* **Blocks the port once refused**: a whisper-tiny cross-attention block
  in train mode and internvl2-2b's loss with a patch frontend
  (``tests/test_torch_train_encoder.py`` holds the encoder families
  whole).
* **Trajectory** against the compiled reference (``TL.make_train_step``
  on a 1x1 mesh, XLA's fused layers and fma): 3 losses within 1e-3
  relative; observed 2.4e-5 on bit-bert-base W1A1.
"""

import dataclasses

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
from repro_torch.configs import get_config as tget
from repro_torch.configs.smoke import smoke_variant as tsmoke
from repro_torch.core import tree
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.models import layers as TL
from repro_torch.models import model_zoo as TZ
from repro_torch.optim import adamw as TA
from repro_torch.runtime import train_loop as TTL
from torch_port_fixtures import release_jax_caches  # noqa: F401  (autouse)

NAMES = ["bit-bert-base", "bit-bert-base-a8", "granite-8b", "gemma3-27b"]
LOSS_RTOL = 1e-6
GRAD_TOL = 1e-2
BATCH, SEQ = 2, 16
OPT = dict(lr=1e-3, warmup_steps=5, total_steps=30)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _tokens(cfg, batch=BATCH, seed=1):
    return TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ, global_batch=batch,
                                    seed=seed)).next()["tokens"]


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


def _ref_value_and_grad(jcfg, jparams, tokens):
    with jax.disable_jit():
        (total, metrics), grads = jax.value_and_grad(
            lambda p: JZ.loss_fn(p, {"tokens": jnp.asarray(tokens)}, jcfg), has_aux=True)(jparams)
    return float(total), {k: float(v) for k, v in metrics.items()}, grads


@pytest.mark.parametrize("name", NAMES)
def test_loss_and_gradients_match_reference(models, name):
    m = models(name)
    tokens = _tokens(m["tcfg"])
    want_total, want_metrics, want_grads = _ref_value_and_grad(m["jcfg"], m["jparams"], tokens)
    metrics, grads = TTL.value_and_grad(m["tparams"], {"tokens": torch.from_numpy(tokens)}, m["tcfg"],
                                        TTL.TrainConfig())
    got = float(metrics["loss"])
    assert abs(got - want_total) <= LOSS_RTOL * abs(want_total), (got, want_total)
    assert float(metrics["aux"]) == want_metrics["aux"] == 0.0
    assert float(metrics["nll"]) == got
    want = dict(tree.leaves_with_paths(convert.from_reference(_np_tree(want_grads), m["tcfg"], device="cpu")))
    mine = dict(tree.leaves_with_paths(grads))
    assert set(mine) == set(want)
    for path, w in want.items():
        g = mine[path]
        assert g.dtype == w.dtype == torch.float32 and g.shape == w.shape, path
        scale = float(w.abs().max())
        assert float((g - w).abs().max()) <= GRAD_TOL * scale, (path, float((g - w).abs().max()), scale)
        if "/ffn/" in path:
            assert torch.equal(g, w), path


def test_remat_changes_no_value(models):
    m = models("granite-8b")
    batch = {"tokens": torch.from_numpy(_tokens(m["tcfg"]))}
    runs = [TTL.value_and_grad(m["tparams"], batch, m["tcfg"], TTL.TrainConfig(remat=r)) for r in (True, False)]
    (m1, g1), (m2, g2) = runs
    assert torch.equal(m1["loss"], m2["loss"])
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(g1), tree.leaves(g2)))


@pytest.mark.parametrize("name", ["gemma3-27b", "bit-bert-base"])
def test_decay_mask_is_the_reference_layouts(models, name):
    """The reference decays a leaf of rank >= 2 in its own layout, where a
    period layer's leaves are stacked: gemma3's prefix layers keep rank-1
    gains (not decayed), its period layers' and every bit-bert layer's
    gains are (n_periods, d) there (decayed), the final norm is not."""
    m = models(name)
    jmask = JA._decay_mask(m["jparams"])
    as_arrays = jax.tree.map(lambda p, d: np.full(p.shape, d, np.float32), m["jparams"], jmask)
    want = dict(tree.leaves_with_paths(convert.from_reference(as_arrays, m["tcfg"], device="cpu")))
    mine = dict(tree.leaves_with_paths(TA.decay_mask(m["tparams"], m["tcfg"])))
    assert set(mine) == set(want)
    for path, w in want.items():
        assert set(torch.unique(w).tolist()) == {mine[path]}, path
    n_prefix = len(m["tcfg"].prefix_layers)
    assert mine["/final_norm"] == 0.0
    assert all(mine[f"/layers/{i}/ln1"] == float(i >= n_prefix) for i in range(m["tcfg"].n_layers))


def test_schedule_matches_reference():
    jcfg, tcfg = JA.AdamWConfig(**OPT), TA.AdamWConfig(**OPT)
    for step in range(0, 36):
        with jax.disable_jit():
            want = np.float32(JA.cosine_schedule(jcfg, jnp.int32(step)))
        got = TA.cosine_schedule(tcfg, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        ulp = np.spacing(want)
        assert abs(np.float32(got.item()) - want) <= 2 * ulp, step


@pytest.mark.parametrize("grad_scale", [1e-3, 1.0])  # unclipped, clipped (norm ~560)
def test_apply_updates_matches_reference(models, grad_scale):
    m = models("gemma3-27b")
    rng = np.random.default_rng(0)

    def rand(scale, positive=False):
        return jax.tree.map(lambda p: jnp.asarray(
            (np.abs if positive else np.asarray)(rng.standard_normal(p.shape)).astype(np.float32) * scale),
            m["jparams"])

    grads = rand(grad_scale)
    state = JA.OptState(mu=rand(1e-3), nu=rand(1e-4, positive=True), step=jnp.int32(7))
    cfg = JA.AdamWConfig(**OPT)
    with jax.disable_jit():
        want_p, want_s, want_m = JA.apply_updates(m["jparams"], grads, state, cfg)

    def cv(tree):
        return convert.from_reference(_np_tree(tree), m["tcfg"], device="cpu")

    tstate = TA.OptState(mu=cv(state.mu), nu=cv(state.nu), step=torch.tensor(7, dtype=torch.int32))
    got_p, got_s, got_m = TA.apply_updates(m["tparams"], cv(grads), tstate, TA.AdamWConfig(**OPT),
                                           TA.decay_mask(m["tparams"], m["tcfg"]))
    gnorm = np.float32(want_m["grad_norm"])
    assert abs(np.float32(got_m["grad_norm"].item()) - gnorm) <= 4 * np.spacing(gnorm)
    assert np.float32(got_m["lr"].item()) == np.float32(want_m["lr"])
    assert int(got_s.step) == int(want_s.step) == 8 and got_s.step.dtype == torch.int32
    if np.float32(got_m["grad_norm"].item()) == gnorm:  # then everything is bit for bit
        for got, want in ((got_p, want_p), (got_s.mu, want_s.mu), (got_s.nu, want_s.nu)):
            for a, b in zip(tree.leaves(got), tree.leaves(cv(want))):
                assert torch.equal(a, b)
    else:  # the clip factor an ulp apart: every leaf within 1e-6 of its scale
        for got, want in ((got_p, want_p), (got_s.mu, want_s.mu), (got_s.nu, want_s.nu)):
            for a, b in zip(tree.leaves(got), tree.leaves(cv(want))):
                assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())
    # the inputs are left as they were
    assert int(tstate.step) == 7


def test_accum_steps_sum_microbatch_gradients(models):
    """``accum_steps=2``: the step equals the two microbatches' gradients
    summed from zero in float32 and halved, metrics averaged, then one
    update -- bit for bit -- and each microbatch's gradients are the
    reference's to ``GRAD_TOL``."""
    m = models("bit-bert-base")
    tokens = _tokens(m["tcfg"], batch=2 * BATCH, seed=4)
    tcfg = TTL.TrainConfig(optimizer=TA.AdamWConfig(**OPT), accum_steps=2)
    state = TA.init_state(m["tparams"])
    got_p, got_s, got_m = TTL.make_train_step(m["tcfg"], tcfg, device="cpu")(m["tparams"], state, {"tokens": tokens})
    halves = [TTL.value_and_grad(m["tparams"], {"tokens": torch.from_numpy(tokens[i * BATCH:(i + 1) * BATCH])},
                                 m["tcfg"], tcfg) for i in range(2)]
    summed = [torch.zeros_like(p) + a + b for p, a, b in zip(tree.leaves(m["tparams"]),
                                                           tree.leaves(halves[0][1]),
                                                           tree.leaves(halves[1][1]))]
    grads = tree.unflatten(m["tparams"], [g / 2 for g in summed])
    want_p, want_s, want_m = TA.apply_updates(m["tparams"], grads, state, tcfg.optimizer,
                                              TA.decay_mask(m["tparams"], m["tcfg"]))
    assert torch.equal(got_m["loss"], (halves[0][0]["loss"] + halves[1][0]["loss"]) / 2)
    assert torch.equal(got_m["grad_norm"], want_m["grad_norm"])
    for got, want in ((got_p, want_p), (got_s.mu, want_s.mu), (got_s.nu, want_s.nu)):
        assert all(torch.equal(a, b) for a, b in zip(tree.leaves(got), tree.leaves(want)))
    # the second microbatch's gradients against the reference, op by op
    _, _, ref = _ref_value_and_grad(m["jcfg"], m["jparams"], tokens[BATCH:])
    for g, w in zip(tree.leaves(halves[1][1]),
                    tree.leaves(convert.from_reference(_np_tree(ref), m["tcfg"], device="cpu"))):
        assert float((g - w).abs().max()) <= GRAD_TOL * float(w.abs().max())


def test_three_steps_track_the_compiled_reference():
    """bit-bert-base W1A1 smoke, 3 steps of batch 4 x 32 from the same
    params and stream, against the reference's compiled step."""
    name = "bit-bert-base"
    jcfg, tcfg = jsmoke(jget(name)), tsmoke(tget(name))
    opt = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    jstep = JTL.make_train_step(jcfg, JTL.TrainConfig(optimizer=JA.AdamWConfig(**opt)), mesh,
                                {"tokens": jax.ShapeDtypeStruct((4, 32), jnp.int32)})
    jp, jo = JTL.init_train_state(jax.random.PRNGKey(0), jcfg)
    tp = convert.from_reference(_np_tree(jp), tcfg, device="cpu")
    to = TA.init_state(tp)
    tstep = TTL.make_train_step(tcfg, TTL.TrainConfig(optimizer=TA.AdamWConfig(**opt)), device="cpu")
    data = dict(vocab_size=tcfg.vocab_size, seq_len=32, global_batch=4, seed=3)
    pj, pt = TokenPipeline(DataConfig(**data)), TokenPipeline(DataConfig(**data))
    for _ in range(3):
        jp, jo, jm = jstep(jp, jo, {"tokens": jnp.asarray(pj.next()["tokens"])})
        tp, to, tm = tstep(tp, to, pt.next())
        want = float(jm["loss"])
        assert abs(float(tm["loss"]) - want) <= 1e-3 * abs(want)
        assert np.isfinite(float(tm["grad_norm"]))
    assert int(to.step) == int(jo.step) == 3


@pytest.mark.parametrize("name", ["whisper-tiny"])
def test_unported_kinds_raise(name):
    """Once a refusal, now a parity case: a whisper-tiny decoder block
    (self-attention, cross-attention onto an encoder's output, FFN) trains.
    Its output bit for bit and every gradient (params, input, encoder
    output) within ``GRAD_TOL`` of their scale, under ``jax.vjp`` of the
    reference's ``block_apply``."""
    from repro.models import transformer as JT
    from repro_torch.models import transformer as TT

    jcfg, tcfg = jsmoke(jget(name)), tsmoke(tget(name))
    jparams = JZ.init_params(jax.random.PRNGKey(0), jcfg)
    pj = jax.tree.map(lambda a: a[0], jparams["stack"]["period"][0])
    pt = convert.from_reference(_np_tree(jparams), tcfg, device="cpu")["layers"][0]
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.standard_normal((BATCH, SEQ, tcfg.d_model)), jnp.bfloat16)
    enc = jnp.asarray(rng.standard_normal((BATCH, 24, tcfg.d_model)), jnp.bfloat16)
    ct = jnp.asarray(rng.standard_normal((BATCH, SEQ, tcfg.d_model)), jnp.bfloat16)
    pos = np.broadcast_to(np.arange(SEQ), (BATCH, SEQ))
    with jax.disable_jit():
        out, vjp = jax.vjp(lambda p, a, e: JT.block_apply(p, a, jcfg, "g", "train", jnp.asarray(pos), None, e)[0],
                           pj, x, enc)
        want = vjp(ct)

    def t(a):
        return torch.from_numpy(np.asarray(jnp.asarray(a).astype(jnp.float32))).to(torch.bfloat16)

    leaves = [a.detach().requires_grad_(True) for a in tree.leaves(pt)]
    xt, et = t(x).requires_grad_(True), t(enc).requires_grad_(True)
    got, aux = TT.block_apply(tree.unflatten(pt, leaves), xt, tcfg, "g", torch.from_numpy(pos.copy()), None, et,
                              mode="train")
    assert float(aux) == 0.0 and torch.equal(got.float(), t(out).float())
    grads = torch.autograd.grad(got, leaves + [xt, et], t(ct))
    for g, w in zip(grads, [*jax.tree.leaves(want[0]), want[1], want[2]]):
        w = torch.from_numpy(np.asarray(jnp.asarray(w).astype(jnp.float32)))
        assert float((g.float() - w).abs().max()) <= GRAD_TOL * float(w.abs().max())


def test_unported_paths_raise_directly():
    """Once a refusal, now a parity case: internvl2-2b smoke's loss with a
    patch frontend (12 projected rows spliced over a 16-token prompt)
    against the reference's op by op.  The unknown-mode check is
    ``test_unknown_mode_raises``."""
    jcfg, tcfg = jsmoke(jget("internvl2-2b")), tsmoke(tget("internvl2-2b"))
    jparams = JZ.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = convert.from_reference(_np_tree(jparams), tcfg, device="cpu")
    tokens = _tokens(tcfg)
    frontend = np.random.default_rng(2).standard_normal(
        (BATCH, tcfg.encoder.n_positions, tcfg.encoder.d_input), dtype=np.float32)
    with jax.disable_jit():
        want, _ = JZ.loss_fn(jparams, {"tokens": jnp.asarray(tokens), "frontend": jnp.asarray(frontend)}, jcfg)
    got, metrics = TZ.loss_fn(tparams, {"tokens": torch.from_numpy(tokens), "frontend": torch.from_numpy(frontend)},
                              tcfg)
    assert abs(float(got) - float(want)) <= LOSS_RTOL * abs(float(want))
    assert float(metrics["aux"]) == 0.0


def test_unknown_mode_raises():
    """A mode other than serve or train is refused; nothing falls back to
    the serving path."""
    from repro_torch.models import attention as TAT

    gcfg = tsmoke(tget("granite-8b"))
    with pytest.raises(ValueError, match="unknown mode"):
        TL.qlinear({"w": torch.zeros(64, 64)}, torch.zeros(2, 64), gcfg.quant, mode="float")
    params = TZ.init_params(0, gcfg, device="cpu")
    x = torch.zeros((1, 4, gcfg.d_model), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="unknown mode"):
        TAT.attention(params["layers"][0]["attn"], x, gcfg, "g", torch.arange(4)[None], mode="float")


def test_float_quant_trains_through_float_einsums(models):
    """With quantization off (``FLOAT_QUANT``) train mode is the reference's
    float einsum on the latent weight cast to bf16: loss within
    ``LOSS_RTOL`` of the reference's, gradients within ``GRAD_TOL``."""
    from repro.configs.base import FLOAT_QUANT as J_FLOAT
    from repro_torch.configs.base import FLOAT_QUANT as T_FLOAT

    m = models("granite-8b")
    jcfg = dataclasses.replace(m["jcfg"], quant=J_FLOAT)
    tcfg = dataclasses.replace(m["tcfg"], quant=T_FLOAT)
    tokens = _tokens(tcfg)
    want_total, _, want_grads = _ref_value_and_grad(jcfg, m["jparams"], tokens)
    metrics, grads = TTL.value_and_grad(m["tparams"], {"tokens": torch.from_numpy(tokens)}, tcfg,
                                        TTL.TrainConfig())
    assert abs(float(metrics["loss"]) - want_total) <= LOSS_RTOL * abs(want_total)
    for g, w in zip(tree.leaves(grads),
                    tree.leaves(convert.from_reference(_np_tree(want_grads), tcfg, device="cpu"))):
        assert float((g - w).abs().max()) <= GRAD_TOL * float(w.abs().max())
