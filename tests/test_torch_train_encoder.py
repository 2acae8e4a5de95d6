"""QAT training of the encoder frontends on the CPU: whisper-tiny's encoder
stack, its decoder's cross-attention and internvl2-2b's patch stub in
train mode, against the JAX reference on the same params.

The oracle is the reference run op by op (``jax.disable_jit()``):
``jax.value_and_grad(model_zoo.loss_fn)`` on a batch with a ``frontend``.
Params and gradients cross through ``repro_torch.convert`` (the encoder's
scanned stack unstacked into its layers).  Tolerances, as observed on the
smoke variants here (2 encoder layers, one decoder layer):

* **Loss** (``LOSS_RTOL``): relative 1e-6; observed 0 to 8.6e-8.
* **Gradients** (``GRAD_TOL``): each leaf within 1e-4 of its largest
  magnitude, tighter than the dense families' 1e-2 because it is met
  without frames and on internvl2 (observed 2.2e-7 and 1.8e-7), and given
  the reference's encoder output, for the decoder and the cotangent of
  that output (``test_decoder_given_the_reference_encoder_output``).
* **The float32 encoder** (``FRAMES_*``).  The pipeline's frames are
  float32, so the reference runs the whole encoder stack in float32, and
  there XLA's float32 ``exp``, ``rsqrt`` and ``tanh`` and its dots' and
  sums' order round otherwise than PyTorch's in the last bit.  Each 8-bit
  fake quantizer is a per-tensor grid: an ulp can carry a value across one
  of its bucket edges (the value moves a whole bucket), or put the tensor's
  largest value on the clip bound or off it (its gradient halves, as
  ``jnp.clip`` passes half at a tie).  So the encoder's output is held to
  ``FRAMES_RTOL`` of its scale (observed 8.3e-4 over 12 frames, 3.3e-3
  over 80), the whole model's gradients with frames to
  ``FRAMES_GRAD_TOL`` (observed 5.7e-2), its loss to ``LOSS_RTOL`` over
  the smoke's 12 frames and ``FRAMES_LOSS_RTOL`` over 80 (``LONG_FRAMES``,
  past XLA's 32-element reduction windows).
* **Cross-attention alone**: its output bit for bit, its gradients within
  ``CROSS_GRAD_TOL`` (the float32 scores' backward products, in XLA's
  order, move a bf16 gradient by an ulp now and then; observed 2.7e-3).
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
from repro.models import attention as JA
from repro.models import model_zoo as JZ
from repro.optim import adamw as JAW
from repro_torch import convert
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config as tget
from repro_torch.configs.smoke import smoke_variant as tsmoke
from repro_torch.core import tree
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.launch import train as train_cli
from repro_torch.models import attention as TA
from repro_torch.models import model_zoo as TZ
from repro_torch.optim import adamw as TAW
from repro_torch.runtime import train_loop as TTL
from torch_port_fixtures import release_jax_caches  # noqa: F401  (autouse)

LOSS_RTOL = 1e-6
GRAD_TOL = 1e-4
CROSS_GRAD_TOL = 1e-2
LONG_FRAMES = 80
FRAMES_LOSS_RTOL = 1e-4
FRAMES_RTOL = 1e-2
FRAMES_GRAD_TOL = 2e-1
BATCH, SEQ = 2, 16
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)


@pytest.fixture(autouse=True)
def flush_denormals():
    """XLA's CPU flushes subnormal float32 results to zero; so does PyTorch
    here, for the length of each test."""
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def _np(t):
    return jax.tree.map(np.asarray, t)


@pytest.fixture(scope="module")
def models():
    built = {}

    def get(name):
        if name not in built:
            jcfg, tcfg = jsmoke(jget(name)), tsmoke(tget(name))
            jparams = JZ.init_params(jax.random.PRNGKey(0), jcfg)
            built[name] = dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams,
                               tparams=convert.from_reference(_np(jparams), tcfg, device="cpu"))
        return built[name]

    return get


def _batch(cfg, frames, seed=1, batch=BATCH):
    """Tokens from the pipeline and, with ``frames``, float32 frontend
    rows (``frames`` x d_input) drawn with numpy."""
    out = {"tokens": TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ, global_batch=batch,
                                              seed=seed)).next()["tokens"]}
    if frames:
        rng = np.random.default_rng(seed)
        out["frontend"] = rng.standard_normal((batch, frames, cfg.encoder.d_input or cfg.d_model),
                                              dtype=np.float32)
    return out


def _ref_value_and_grad(jcfg, jparams, batch):
    with jax.disable_jit():
        (total, metrics), grads = jax.value_and_grad(
            lambda p: JZ.loss_fn(p, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg),
            has_aux=True)(jparams)
    return float(total), grads


def _port_value_and_grad(tparams, batch, tcfg, remat=True):
    return TTL.value_and_grad(tparams, {k: torch.from_numpy(v) for k, v in batch.items()}, tcfg,
                              TTL.TrainConfig(remat=remat))


def _gaps(grads, ref_grads, tcfg) -> dict:
    """Each leaf's largest gap, of the leaf's largest magnitude."""
    want = dict(tree.leaves_with_paths(convert.from_reference(_np(ref_grads), tcfg, device="cpu")))
    mine = dict(tree.leaves_with_paths(grads))
    assert set(mine) == set(want)
    out = {}
    for path, w in want.items():
        g = mine[path]
        assert g.dtype == w.dtype == torch.float32 and g.shape == w.shape, path
        out[path] = float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
    return out


CASES = {  # name -> (model, frames, gradient tolerance)
    "whisper-no-frontend": ("whisper-tiny", 0, GRAD_TOL),
    "whisper-frames": ("whisper-tiny", 12, FRAMES_GRAD_TOL),
    "internvl2-patches": ("internvl2-2b", 12, GRAD_TOL),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_and_gradients_match_reference(models, case):
    """The loss and every gradient leaf: whisper without a frontend (its
    blocks skip cross-attention; the encoder's gradients are zero), over
    its smoke's 12 frames, and internvl2 with 12 patch rows spliced over a
    16-token prompt."""
    name, frames, grad_tol = CASES[case]
    m = models(name)
    batch = _batch(m["tcfg"], frames)
    want, ref_grads = _ref_value_and_grad(m["jcfg"], m["jparams"], batch)
    metrics, grads = _port_value_and_grad(m["tparams"], batch, m["tcfg"])
    assert abs(float(metrics["loss"]) - want) <= LOSS_RTOL * abs(want), (float(metrics["loss"]), want)
    gaps = _gaps(grads, ref_grads, m["tcfg"])
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] <= grad_tol, (worst, gaps[worst])
    if name == "whisper-tiny" and not frames:
        assert all(float(g.abs().max()) == 0.0 for p, g in tree.leaves_with_paths(grads) if "encoder" in p)
    if name == "internvl2-2b":
        # the spliced positions' token embeddings get no gradient from the input side
        assert float(grads["encoder"]["stub_proj"]["w"].abs().max()) > 0


@pytest.mark.parametrize("frames", [12, LONG_FRAMES])
def test_run_encoder_in_train_mode(models, frames):
    """``_run_encoder(..., "train")`` and its gradients (params and frames)
    under one cotangent, against ``jax.vjp`` of the reference's, over the
    smoke's 12 frames and over 80, within the float32 encoder's bounds."""
    m = models("whisper-tiny")
    rng = np.random.default_rng(frames)
    fr = rng.standard_normal((BATCH, frames, m["tcfg"].d_model), dtype=np.float32)
    ct = rng.standard_normal((BATCH, frames, m["tcfg"].d_model), dtype=np.float32)
    with jax.disable_jit():
        out, vjp = jax.vjp(lambda p, f: JZ._run_encoder(p, f, m["jcfg"], "train"), m["jparams"], jnp.asarray(fr))
        ref_grads, ref_dfr = vjp(jnp.asarray(ct))
    leaves = [p.detach().requires_grad_(True) for p in tree.leaves(m["tparams"])]
    frt = torch.from_numpy(fr).requires_grad_(True)
    got = TZ._run_encoder(tree.unflatten(m["tparams"], leaves), frt, m["tcfg"], "train", remat=True)
    grads = torch.autograd.grad(got, leaves + [frt], torch.from_numpy(ct), allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads[:-1])] + [grads[-1]]
    out = torch.from_numpy(np.asarray(out))
    assert got.dtype == torch.float32
    assert float((got.detach() - out).abs().max()) <= FRAMES_RTOL * float(out.abs().max())
    dfr = torch.from_numpy(np.asarray(ref_dfr))
    assert float((grads[-1] - dfr).abs().max()) <= FRAMES_GRAD_TOL * float(dfr.abs().max())
    gaps = _gaps(tree.unflatten(m["tparams"], grads[:-1]), ref_grads, m["tcfg"])
    enc = {p: g for p, g in gaps.items() if p.startswith("/encoder")}
    assert max(enc.values()) <= FRAMES_GRAD_TOL, max(enc, key=enc.get)
    assert all(g == 0.0 for p, g in gaps.items() if not p.startswith("/encoder"))


@pytest.mark.parametrize("frames", [12, LONG_FRAMES])
def test_cross_attention_in_train_mode(models, frames):
    """One cross-attention call in train mode (``kv_override``: no rope,
    non-causal, q / k / probabilities fake-quantized) under ``jax.vjp``:
    bf16 queries against float32 keys and values, as a float32 encoder
    output projects them; the output bit for bit, every gradient within
    ``CROSS_GRAD_TOL`` of its scale."""
    m = models("whisper-tiny")
    cfg_j, cfg_t = m["jcfg"], m["tcfg"]
    pj = jax.tree.map(lambda a: a[0], m["jparams"]["stack"]["period"][0]["cross_attn"])
    pt = m["tparams"]["layers"][0]["cross_attn"]
    kvh, dh = cfg_t.n_kv_heads, cfg_t.d_head
    rng = np.random.default_rng(frames + 1)
    h = rng.standard_normal((BATCH, SEQ, cfg_t.d_model), dtype=np.float32)
    ck = rng.standard_normal((BATCH, frames, kvh, dh), dtype=np.float32)
    cv = rng.standard_normal((BATCH, frames, kvh, dh), dtype=np.float32)
    ct = rng.standard_normal((BATCH, SEQ, cfg_t.d_model), dtype=np.float32)
    hj = jnp.asarray(h, jnp.bfloat16)
    pos = np.broadcast_to(np.arange(SEQ), (BATCH, SEQ))

    def ref(p, x, k, v):
        return JA.attention(p, x, cfg_j, "g", "train", jnp.asarray(pos), kv_override=(k, v), causal=False)[0]

    with jax.disable_jit():
        out, vjp = jax.vjp(ref, pj, hj, jnp.asarray(ck), jnp.asarray(cv))
        gp, gh, gk, gv = vjp(jnp.asarray(ct, jnp.bfloat16))
    leaves = [a.detach().requires_grad_(True) for a in tree.leaves(pt)]
    x = torch.from_numpy(np.asarray(hj.astype(jnp.float32))).to(torch.bfloat16).requires_grad_(True)
    k, v = (torch.from_numpy(a.copy()).requires_grad_(True) for a in (ck, cv))
    got, cache = TA.attention(tree.unflatten(pt, leaves), x, cfg_t, "g", torch.from_numpy(pos.copy()),
                              kv_override=(k, v), causal=False, mode="train")
    assert cache is None and got.dtype == torch.bfloat16
    grads = torch.autograd.grad(got, leaves + [x, k, v],
                                torch.from_numpy(np.asarray(jnp.asarray(ct, jnp.bfloat16).astype(jnp.float32)))
                                .to(torch.bfloat16), allow_unused=True)
    grads = [torch.zeros_like(a) if g is None else g for a, g in zip(leaves + [x, k, v], grads)]

    def gap(a, b):
        b = torch.from_numpy(np.asarray(jnp.asarray(b).astype(jnp.float32)))
        return float((a.detach().float() - b).abs().max()) / max(float(b.abs().max()), 1e-30)

    assert gap(got, out) == 0.0
    assert max(gap(a, b) for a, b in zip(grads, [*jax.tree.leaves(gp), gh, gk, gv])) <= CROSS_GRAD_TOL


def test_decoder_given_the_reference_encoder_output(models):
    """The decoder, its cross-attention in every block and the loss, given
    the reference's own float32 encoder output over ``LONG_FRAMES``
    frames: the loss, every decoder gradient leaf and the cotangent of the
    encoder output (summed over every block's k and v projections) against
    the reference's."""
    m = models("whisper-tiny")
    batch = _batch(m["tcfg"], LONG_FRAMES)
    fr = jnp.asarray(batch["frontend"])
    with jax.disable_jit():
        enc = JZ._run_encoder(m["jparams"], fr, m["jcfg"], "train")

        def ref(p, e):
            with mock.patch.object(JZ, "_run_encoder", lambda *_: e):
                return JZ.loss_fn(p, {"tokens": jnp.asarray(batch["tokens"]), "frontend": fr}, m["jcfg"])[0]

        want, (ref_grads, ref_denc) = jax.value_and_grad(ref, argnums=(0, 1))(m["jparams"], enc)
    enc_t = torch.from_numpy(np.asarray(enc).copy()).requires_grad_(True)
    leaves = [p.detach().requires_grad_(True) for p in tree.leaves(m["tparams"])]
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    with mock.patch.object(TZ, "_run_encoder", lambda *_: enc_t):
        total, _ = TZ.loss_fn(tree.unflatten(m["tparams"], leaves), tbatch, m["tcfg"], remat=True)
    grads = torch.autograd.grad(total, leaves + [enc_t], allow_unused=True)
    assert abs(float(total.detach()) - float(want)) <= LOSS_RTOL * abs(float(want))
    denc, grads = grads[-1], [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads[:-1])]
    want_denc = torch.from_numpy(np.asarray(ref_denc))
    assert float((denc - want_denc).abs().max()) <= GRAD_TOL * float(want_denc.abs().max())
    gaps = _gaps(tree.unflatten(m["tparams"], grads), ref_grads, m["tcfg"])
    dec = {p: g for p, g in gaps.items() if not p.startswith("/encoder")}
    assert max(dec.values()) <= GRAD_TOL, max(dec, key=dec.get)


def test_long_frames_stay_within_the_stated_bound(models):
    """The whole whisper step over ``LONG_FRAMES`` float32 frames, as the
    pipeline emits them: the loss within ``FRAMES_LOSS_RTOL``, each
    gradient leaf within ``FRAMES_GRAD_TOL`` (the module docstring says
    why)."""
    m = models("whisper-tiny")
    batch = _batch(m["tcfg"], LONG_FRAMES)
    want, ref_grads = _ref_value_and_grad(m["jcfg"], m["jparams"], batch)
    metrics, grads = _port_value_and_grad(m["tparams"], batch, m["tcfg"])
    assert abs(float(metrics["loss"]) - want) <= FRAMES_LOSS_RTOL * abs(want)
    gaps = _gaps(grads, ref_grads, m["tcfg"])
    assert max(gaps.values()) <= FRAMES_GRAD_TOL, max(gaps, key=gaps.get)


def test_remat_changes_no_value(models):
    m = models("whisper-tiny")
    batch = _batch(m["tcfg"], 12)
    (m1, g1), (m2, g2) = (_port_value_and_grad(m["tparams"], batch, m["tcfg"], remat=r) for r in (True, False))
    assert torch.equal(m1["loss"], m2["loss"])
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(g1), tree.leaves(g2)))


@pytest.mark.parametrize("name", ["whisper-tiny", "internvl2-2b"])
def test_decay_mask_is_the_reference_layouts(models, name):
    """The reference decays a leaf of rank >= 2 in its own layout: the
    encoder stack is a scanned period (its layers' norm gains are (n, d),
    decayed), the stub projection is decayed, the encoder's final norm is
    not; a decoder period layer's ``ln_cross`` is decayed."""
    m = models(name)
    jmask = JAW._decay_mask(m["jparams"])
    as_arrays = jax.tree.map(lambda p, d: np.full(p.shape, d, np.float32), m["jparams"], jmask)
    want = dict(tree.leaves_with_paths(convert.from_reference(as_arrays, m["tcfg"], device="cpu")))
    mine = dict(tree.leaves_with_paths(TAW.decay_mask(m["tparams"], m["tcfg"])))
    assert set(mine) == set(want)
    for path, w in want.items():
        assert set(torch.unique(w).tolist()) == {mine[path]}, path
    assert mine["/encoder/stub_proj/w"] == 1.0
    if name == "whisper-tiny":
        assert mine["/encoder/layers/0/ln1"] == mine["/layers/0/ln_cross"] == 1.0
        assert mine["/encoder/final_norm"] == 0.0


def test_three_steps_match_the_reference(models):
    """Three AdamW steps of whisper smoke over the pipeline's 12 float32
    frames from the same params and stream, against the reference's loss,
    gradients and ``apply_updates`` op by op: each step's loss within
    ``FRAMES_LOSS_RTOL`` (the first within ``LOSS_RTOL``), and every param
    within ``2 * lr`` a step of the reference's: AdamW moves a coordinate
    about ``lr`` a step whatever its gradient's size, so where a gradient
    near zero takes the other sign (the float32 encoder's bounds) the
    coordinate moves the other way, and that is all that may differ."""
    m = models("whisper-tiny")
    cfg = m["tcfg"]
    jopt, topt = JAW.AdamWConfig(**OPT), TAW.AdamWConfig(**OPT)
    data = dict(vocab_size=cfg.vocab_size, seq_len=SEQ, global_batch=BATCH, seed=3,
                frontend_positions=cfg.encoder.n_positions, frontend_dim=cfg.d_model)
    jpipe, tpipe = TokenPipeline(DataConfig(**data)), TokenPipeline(DataConfig(**data))
    jp, jstate = m["jparams"], JAW.init_state(m["jparams"])
    tp, tstate = m["tparams"], TAW.init_state(m["tparams"])
    step = TTL.make_train_step(cfg, TTL.TrainConfig(optimizer=topt), device="cpu")
    for i in range(3):
        want, grads = _ref_value_and_grad(m["jcfg"], jp, jpipe.next())
        with jax.disable_jit():
            jp, jstate, _ = JAW.apply_updates(jp, grads, jstate, jopt)
        tp, tstate, metrics = step(tp, tstate, tpipe.next())
        rtol = LOSS_RTOL if i == 0 else FRAMES_LOSS_RTOL
        assert abs(float(metrics["loss"]) - want) <= rtol * abs(want), i
        want_p = convert.from_reference(_np(jp), cfg, device="cpu")
        gap = max(float((a - b).abs().max()) for a, b in zip(tree.leaves(tp), tree.leaves(want_p)))
        assert gap <= 2 * OPT["lr"] * (i + 1), (i, gap)
    assert int(tstate.step) == int(jstate.step) == 3


def test_train_cli_resumes_bitwise(tmp_path, capsys):
    """``python -m repro_torch.launch.train --arch whisper-tiny --smoke
    --device cpu``: the stream carries the encoder's frames.  A 6-step run
    checkpointing every 2 steps loses its last checkpoint (as a crash
    after step 4's would); relaunched with the same flags it resumes from
    step 4 and ends at the params and AdamW state of the uninterrupted
    run, bit for bit."""
    import shutil

    def cli(ckpt):
        argv = ["train", "--arch", "whisper-tiny", "--smoke", "--device", "cpu", "--steps", "6",
                "--batch", "2", "--seq", "16", "--ckpt-every", "2", "--ckpt-dir", str(ckpt)]
        with mock.patch.object(sys, "argv", argv):
            train_cli.main()
        return capsys.readouterr().out

    out = cli(tmp_path / "straight")
    assert "[train] loss" in out and "nan" not in out
    shutil.copytree(tmp_path / "straight", tmp_path / "cut")
    shutil.rmtree(tmp_path / "cut" / f"step_{6:09d}")
    assert "resumed from step 4" in cli(tmp_path / "cut")
    like = TZ.init_params(0, tsmoke(tget("whisper-tiny")), device="cpu")
    like = {"params": like, "opt": TAW.init_state(like)}
    _, a, _ = CheckpointManager(str(tmp_path / "cut")).restore(6, like=like)
    _, b, _ = CheckpointManager(str(tmp_path / "straight")).restore(6, like=like)
    assert all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(tree.leaves(a), tree.leaves(b)))


def test_frontend_shape_is_checked(models):
    m = models("internvl2-2b")
    cfg = m["tcfg"]
    too_many = torch.zeros((BATCH, SEQ + 1, cfg.encoder.d_input))
    with pytest.raises(ValueError, match="shorter than"):
        TZ.loss_fn(m["tparams"], {"tokens": torch.zeros((BATCH, SEQ), dtype=torch.int32),
                                  "frontend": too_many}, cfg)
    w = models("whisper-tiny")
    with pytest.raises(ValueError, match="frontend of shape"):
        TZ.loss_fn(w["tparams"], {"tokens": torch.zeros((BATCH, SEQ), dtype=torch.int32),
                                  "frontend": torch.zeros((BATCH, 12, 7))}, w["tcfg"])
