"""QAT training of the MoE / MLA family on the CPU, against the JAX
reference, same params: the deepseek-v2-lite-16b smoke model (one
``"Md"`` and one ``"Mm"`` layer, 8 experts top-2, the softmax router) and
the deepseek-v3-671b smoke model (three ``"Md"`` layers and one ``"Mm"``,
low-rank queries, the sigmoid router with ``route_scale``, the depth-1
multi-token-prediction head).  The optimizer on these trees and the
compiled reference are ``tests/test_torch_train_moe_steps.py``.

The oracle is the reference run op by op (``jax.disable_jit()``): its
``moe.expert_qlinear`` / ``moe.moe_ffn`` / ``attention.mla_attention`` in
train mode under ``jax.vjp``, and ``jax.value_and_grad(model_zoo.loss_fn)``.
Params and gradients cross through ``repro_torch.convert``.  What must
agree, as observed here:

* **Bit for bit**: the routes (``experts``, ``keep``, ``dest``), the
  train-mode ``expert_qlinear`` forward and its input and weight
  gradients, ``moe_ffn``'s output, its input gradient and every expert
  weight's (routed and shared), the MLA mixer's output, its input
  gradient and its projections' gradients (v3's ``k_up`` aside, below),
  and in the whole model every MoE FFN weight's gradient.  The combine
  weights' gradient is a bf16 row sum, which the port takes in XLA's
  order (``moe._ScaleRoutes``; PyTorch's float32 sum put 2.4e-2 on a
  gradient leaf of the v3 model).
* **The router** (``ROUTER_TOL``): its float32 ``td,de`` product sums in
  another order than XLA's CPU dot (ROADMAP section 3), so its weight's
  gradient is held to 1e-6 of its largest magnitude (observed 2.3e-7),
  the balance loss ``aux`` to 1e-6 relative (observed equal).
* **Float32 reductions in another order** (``NORM_TOL``): norm gains to
  1e-6 of their largest magnitude (observed 2.6e-7); v3's MLA ``k_up``
  gradient under the low-rank query to ``KUP_TOL`` 1e-3 (observed 7.8e-4:
  a float32 score gradient an ulp apart flips the bf16 rounding of a
  k_nope gradient).
* **The whole model**: the loss within ``LOSS_RTOL`` 1e-6 relative
  (observed 0 on v2-lite, 6.6e-8 on v3, its MTP term included), every
  gradient leaf within ``GRAD_TOL`` 1e-2 of its largest magnitude
  (observed 3.5e-4 on v2-lite, 9.2e-3 on v3's first layer: the float32
  scores of each MLA layer move a bf16 gradient by an ulp now and then,
  and v3 carries that through three layers more).
"""

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs.smoke import smoke_variant as jsmoke
from repro.models import attention as JAT
from repro.models import model_zoo as JZ
from repro.models import moe as JM
from repro_torch import convert
from repro_torch.configs import get_config as tget
from repro_torch.configs.smoke import smoke_variant as tsmoke
from repro_torch.core import tree
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.models import attention as TAT
from repro_torch.models import model_zoo as TZ
from repro_torch.models import moe as TM
from repro_torch.optim import adamw as TA
from repro_torch.runtime import train_loop as TTL
from torch_port_fixtures import release_jax_caches  # noqa: F401  (autouse)

NAMES = ["deepseek-v2-lite-16b", "deepseek-v3-671b"]
IDS = ["v2-lite-softmax-router", "v3-sigmoid-router-mtp"]
LOSS_RTOL = 1e-6
GRAD_TOL = 1e-2
ROUTER_TOL = 1e-6
NORM_TOL = 1e-6
KUP_TOL = 1e-3
BATCH, SEQ = 2, 16


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


def _t(a):
    return convert.to_tensor(np.asarray(a), device="cpu")


def _tokens(cfg, batch=BATCH, seq=SEQ, seed=1):
    return TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch,
                                    seed=seed)).next()["tokens"]


def _rel_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want.float()).abs().max()) / max(float(want.float().abs().max()), 1e-30)


def _bf16(rng, shape):
    return jnp.asarray(rng.standard_normal(shape).astype(np.float32)).astype(jnp.bfloat16)


@pytest.fixture(scope="module")
def models():
    """Each smoke model's reference params, their port copies, and the
    reference's loss and gradients on one batch, op by op, computed once
    (the op-by-op reference is most of this module's time)."""
    built = {}

    def get(name):
        if name not in built:
            jcfg, tcfg = jsmoke(jget(name)), tsmoke(tget(name))
            jparams = JZ.init_params(jax.random.PRNGKey(0), jcfg)
            tokens = _tokens(tcfg)
            with jax.disable_jit():
                (total, metrics), grads = jax.value_and_grad(
                    lambda p: JZ.loss_fn(p, {"tokens": jnp.asarray(tokens)}, jcfg), has_aux=True)(jparams)
            built[name] = dict(
                jcfg=jcfg, tcfg=tcfg, jparams=jparams, tokens=tokens,
                tparams=convert.from_reference(_np_tree(jparams), tcfg, device="cpu"),
                want_total=float(total), want_metrics={k: float(v) for k, v in metrics.items()},
                want_grads=dict(tree.leaves_with_paths(convert.from_reference(_np_tree(grads), tcfg,
                                                                               device="cpu"))))
        return built[name]

    return get


@pytest.mark.parametrize("name", NAMES, ids=IDS)
def test_loss_and_gradients_match_reference(models, name):
    m = models(name)
    metrics, grads = TTL.value_and_grad(m["tparams"], {"tokens": torch.from_numpy(m["tokens"])}, m["tcfg"],
                                        TTL.TrainConfig())
    want = m["want_metrics"]
    assert abs(float(metrics["loss"]) - want["loss"]) <= LOSS_RTOL * abs(want["loss"])
    assert want["aux"] > 0 and abs(float(metrics["aux"]) - want["aux"]) <= ROUTER_TOL * abs(want["aux"])
    assert float(metrics["nll"]) == float(metrics["loss"])
    total = float(metrics["loss"]) + 0.01 * float(metrics["aux"])
    assert abs(total - m["want_total"]) <= LOSS_RTOL * abs(m["want_total"])
    mine = dict(tree.leaves_with_paths(grads))
    assert set(mine) == set(m["want_grads"])
    assert ("/mtp/proj/w" in mine) == bool(m["tcfg"].mtp_depth)
    for path, w in m["want_grads"].items():
        g = mine[path]
        assert g.dtype == w.dtype == torch.float32 and g.shape == w.shape, path
        assert _rel_gap(g, w) <= GRAD_TOL, (path, _rel_gap(g, w))
        if "/moe/" in path and "router" not in path:  # routed and shared experts
            assert torch.equal(g, w), path


def test_mtp_head_crosses_and_trains(models):
    """deepseek-v3's latent tree keeps its MTP head through
    ``convert.from_reference`` and ``init_params`` builds one of the same
    shape; the head adds 0.3 times its NLL to ``loss``; a serving tree,
    the reference's through ``convert`` or the port's packer's, carries
    none."""
    m = models("deepseek-v3-671b")
    proj = m["tparams"]["mtp"]["proj"]["w"]
    assert torch.equal(proj, _t(m["jparams"]["mtp"]["proj"]["w"]))
    assert TZ.init_params(0, m["tcfg"], device="cpu")["mtp"]["proj"]["w"].shape == proj.shape == (128, 64)
    batch = {"tokens": torch.from_numpy(m["tokens"])}
    with torch.no_grad():
        with_head = TZ.loss_fn(m["tparams"], batch, m["tcfg"])[1]["loss"]
        without = TZ.loss_fn({k: v for k, v in m["tparams"].items() if k != "mtp"}, batch, m["tcfg"])[1]["loss"]
        hidden, _ = TZ._forward_hidden(m["tparams"], batch["tokens"], m["tcfg"])
        mtp = TZ._mtp_loss(m["tparams"], hidden, batch["tokens"], m["tcfg"])
    assert torch.equal(with_head, without + 0.3 * mtp) and float(mtp) > 0
    assert "mtp" not in TZ.prepare_serving_params(m["tparams"], m["tcfg"])
    serving = dict(_np_tree(m["jparams"]), mtp={"proj": {"w_packed": np.zeros((4, 64), np.uint32)}})
    assert "mtp" not in convert.from_reference(serving, m["tcfg"], device="cpu")


def test_expert_qlinear_train_bit_identical(models):
    """The smoke model's expert sites at C = 8 rows each: fake-binarized
    (E, K, N) weights, the buffer fake-quantized per tensor (a zero row,
    as an empty capacity slot leaves, included), the bf16 product, and the
    input and weight gradients under a random cotangent."""
    m = models(NAMES[0])
    rng = np.random.default_rng(3)
    e = m["tcfg"].moe
    k, n, c = m["tcfg"].d_model, e.d_expert_ff, 8
    w = jnp.asarray(rng.standard_normal((e.n_routed, k, n)).astype(np.float32) / np.sqrt(k))
    x = np.array(_bf16(rng, (e.n_routed, c, k)).astype(jnp.float32))
    x[1, 2] = 0.0
    x = jnp.asarray(x).astype(jnp.bfloat16)
    g = _bf16(rng, (e.n_routed, c, n))
    quant = m["jcfg"].quant
    with jax.disable_jit():
        out, vjp = jax.vjp(lambda p, x: JM.expert_qlinear(p, x, quant, "train", k), {"w": w}, x)
        gw, gx = vjp(g)
    tw, tx = _t(w).requires_grad_(True), _t(x).requires_grad_(True)
    got = TM.expert_qlinear({"w": tw}, tx, m["tcfg"].quant, k, mode="train")
    assert got.dtype == torch.bfloat16 and torch.equal(got, _t(out))
    got_w, got_x = torch.autograd.grad(got, (tw, tx), _t(g))
    assert torch.equal(got_w, _t(gw["w"])) and torch.equal(got_x, _t(gx))


def _spy(seen, key, real):
    def call(*args, **kwargs):
        out = real(*args, **kwargs)
        seen.setdefault(key, out)
        return out
    return call


@pytest.mark.parametrize("name", NAMES, ids=IDS)
def test_moe_ffn_train_bit_identical(models, name):
    """2 x 16 tokens through the smoke model's MoE (64 routes over 8
    experts at capacity 10, some dropped), under a random cotangent for
    the output and 1 for the balance loss."""
    m = models(name)
    jcfg, tcfg = m["jcfg"], m["tcfg"]
    e = tcfg.moe
    rng = np.random.default_rng(4)
    p = JM.init_moe(jax.random.PRNGKey(4), jcfg)
    x = _bf16(rng, (BATCH, SEQ, tcfg.d_model))
    g = _bf16(rng, (BATCH, SEQ, tcfg.d_model))
    jseen, tseen = {}, {}
    with jax.disable_jit(), mock.patch.object(JM, "_route", _spy(jseen, "route", JM._route)):
        (out, aux), vjp = jax.vjp(lambda p, x: JM.moe_ffn(p, x, jcfg, "train"), p, x)
        gp, gx = vjp((g, jnp.float32(1.0)))
    tp = jax.tree.map(_t, p)
    leaves = [leaf.requires_grad_(True) for leaf in tree.leaves(tp)]
    tx = _t(x).requires_grad_(True)
    with mock.patch.object(TM, "_route", _spy(tseen, "route", TM._route)), \
            mock.patch.object(TM, "_dispatch", _spy(tseen, "dispatch", TM._dispatch)):
        tout, taux = TM.moe_ffn(tp, tx, tcfg, mode="train")
    grads = torch.autograd.grad((tout, taux), leaves + [tx], (_t(g), torch.ones(())))

    ji, ti = np.asarray(jseen["route"][1]), tseen["route"][1]
    np.testing.assert_array_equal(ti.numpy(), ji)
    tk = BATCH * SEQ * e.top_k
    capacity = int(max(1, round(e.capacity_factor * tk / e.n_routed)))
    order = np.argsort(ji.reshape(tk), kind="stable")
    se = ji.reshape(tk)[order]
    pos = np.arange(tk) - np.searchsorted(se, se, side="left")
    keep = pos < capacity
    dest = np.where(keep, se * capacity + pos, e.n_routed * capacity)
    t_order, _, t_keep, t_dest = tseen["dispatch"]
    np.testing.assert_array_equal(t_order.numpy(), order)
    np.testing.assert_array_equal(t_keep.numpy(), keep)
    np.testing.assert_array_equal(t_dest.numpy(), dest)
    assert not keep.all(), "no route was dropped"
    assert tout.dtype == torch.bfloat16 and torch.equal(tout, _t(out))
    assert abs(float(taux) - float(aux)) <= ROUTER_TOL * abs(float(aux))
    want = dict(tree.leaves_with_paths(jax.tree.map(_t, gp)))
    for (path, _), got in zip(tree.leaves_with_paths(tp), grads):
        if path.startswith("/router"):
            assert _rel_gap(got, want[path]) <= ROUTER_TOL, (path, _rel_gap(got, want[path]))
        else:
            assert torch.equal(got, want[path]), path
    assert torch.equal(grads[-1], _t(gx))


@pytest.mark.parametrize("name", NAMES, ids=["v2-lite-q-proj", "v3-q-lora"])
def test_mla_attention_train_matches_reference(models, name):
    """The decompressed MLA mixer in train mode: output and input gradient
    bit for bit, every projection's gradient bit for bit (v3's ``k_up``
    within ``KUP_TOL``), the norm gains within ``NORM_TOL`` of their scale;
    a cache is refused."""
    m = models(name)
    jcfg, tcfg = m["jcfg"], m["tcfg"]
    rng = np.random.default_rng(5)
    p = JAT.init_mla(jax.random.PRNGKey(5), jcfg)
    x = _bf16(rng, (BATCH, SEQ, tcfg.d_model))
    g = _bf16(rng, (BATCH, SEQ, tcfg.d_model))
    pos = jnp.broadcast_to(jnp.arange(SEQ), (BATCH, SEQ))
    with jax.disable_jit():
        out, vjp = jax.vjp(lambda p, x: JAT.mla_attention(p, x, jcfg, "train", pos)[0], p, x)
        gp, gx = vjp(g)
    tp = jax.tree.map(_t, p)
    leaves = [leaf.requires_grad_(True) for leaf in tree.leaves(tp)]
    tx = _t(x).requires_grad_(True)
    tpos = torch.arange(SEQ).broadcast_to(BATCH, SEQ)
    tout, cache = TAT.mla_attention(tp, tx, tcfg, tpos, None, mode="train")
    assert cache is None and torch.equal(tout, _t(out))
    grads = torch.autograd.grad(tout, leaves + [tx], _t(g))
    for (path, w), got in zip(tree.leaves_with_paths(jax.tree.map(_t, gp)), grads):
        if "norm" in path:
            assert _rel_gap(got, w) <= NORM_TOL, (path, _rel_gap(got, w))
        elif path == "/k_up/w" and tcfg.mla.q_lora_rank:
            assert _rel_gap(got, w) <= KUP_TOL, (path, _rel_gap(got, w))
        else:
            assert torch.equal(got, w), path
    assert torch.equal(grads[-1], _t(gx))
    with pytest.raises(ValueError, match="without a cache"):
        TAT.mla_attention(tp, tx, tcfg, tpos, TAT.init_mla_cache(BATCH, 32, tcfg, device="cpu"), mode="train")


def test_accum_steps_average_the_balance_loss(models):
    """``accum_steps=2``: the step's ``aux`` and ``loss`` are the two
    microbatches' summed and halved, bit for bit, as the reference's scan
    accumulates its metrics."""
    m = models(NAMES[0])
    tokens = _tokens(m["tcfg"], batch=2 * BATCH, seed=4)
    tcfg = TTL.TrainConfig(optimizer=TA.AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=30), accum_steps=2)
    _, _, got = TTL.make_train_step(m["tcfg"], tcfg, device="cpu")(m["tparams"], TA.init_state(m["tparams"]),
                                                                  {"tokens": tokens})
    halves = [TTL.value_and_grad(m["tparams"], {"tokens": torch.from_numpy(tokens[i * BATCH:(i + 1) * BATCH])},
                                 m["tcfg"], tcfg)[0] for i in range(2)]
    for key in ("loss", "aux", "nll"):
        assert torch.equal(got[key], (halves[0][key] + halves[1][key]) / 2), key
    assert float(got["aux"]) > 0


@pytest.mark.parametrize("name", NAMES, ids=IDS)
def test_prebinarize_gather_matches_the_reference(models, name):
    """The reference's packed-gather QAT (``quant.prebinarize_gather``) on
    the deepseek smoke models, one device: ``prebinarize_params`` (rank-3
    routed experts, shared experts, MLA projections, v3's MTP head; never
    the router) bit for bit against the reference's on a 1x1 mesh, values
    and straight-through gradients (``jax.vjp`` with each value as its own
    cotangent)."""
    from repro.launch.mesh import make_host_mesh
    from repro.runtime import train_loop as JTL

    m = models(name)
    rhat = JTL.prebinarize_params(m["jparams"], m["jcfg"], make_host_mesh(1, 1))
    want = convert.from_reference(jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), rhat), m["tcfg"],
                                  device="cpu")
    leaves = [p.detach().requires_grad_(True) for p in tree.leaves(m["tparams"])]
    hat = TTL.prebinarize_params(tree.unflatten(m["tparams"], leaves), m["tcfg"])
    packed = [path for (path, got), src in zip(tree.leaves_with_paths(hat), leaves) if got is not src]
    assert any("/moe/up/" in p for p in packed) and not any("router" in p for p in packed)
    for (path, got), w in zip(tree.leaves_with_paths(hat), tree.leaves(want)):
        assert torch.equal(got.float(), w), path
    total = sum((x.float() * x.detach().float()).sum() for x in tree.leaves(hat))
    grads = torch.autograd.grad(total, leaves)
    _, vjp = jax.vjp(lambda p: JTL.prebinarize_params(p, m["jcfg"], make_host_mesh(1, 1)), m["jparams"])
    (rgrads,) = vjp(rhat)
    want_g = convert.from_reference(_np_tree(rgrads), m["tcfg"], device="cpu")
    for (path, g), w in zip(tree.leaves_with_paths(tree.unflatten(m["tparams"], list(grads))),
                            tree.leaves(want_g)):
        assert torch.equal(g, w), path


def test_prebinarize_gather_trains_as_the_reference(models):
    """deepseek-v2-lite smoke trained through ``prebinarize_params``.  A
    prebinarized weight is ``bf16(alpha) * sign(w)``, which is what the
    fake-binarized float32 weight becomes when a train-mode site casts it
    to the bf16 activations' dtype, and its gradient is the same ``g *
    alpha``: so the loss and every gradient are the plain train step's, bit
    for bit, and with it held to the reference's op-by-op loss and
    gradients as ``test_loss_and_gradients_match_reference`` holds that
    step.  (v3's MTP head takes float32 activations, where the bf16
    ``alpha`` does differ from the float32 one, in the reference alike.)"""
    m = models(NAMES[0])
    cfg = dataclasses.replace(m["tcfg"], quant=dataclasses.replace(m["tcfg"].quant, prebinarize_gather=True))
    tcfg = TTL.TrainConfig(remat=False)
    batch = {"tokens": torch.from_numpy(m["tokens"])}
    got_m, got_g = TTL.value_and_grad(m["tparams"], batch, cfg, tcfg,
                                      prepare=lambda p: TTL.prebinarize_params(p, cfg))
    plain_m, plain_g = TTL.value_and_grad(m["tparams"], batch, m["tcfg"], tcfg)
    assert all(torch.equal(got_m[k], plain_m[k]) for k in plain_m)
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(got_g), tree.leaves(plain_g)))
    assert abs(float(got_m["loss"]) - m["want_metrics"]["loss"]) <= LOSS_RTOL * abs(m["want_metrics"]["loss"])
    for path, g in tree.leaves_with_paths(got_g):
        assert _rel_gap(g, m["want_grads"][path]) <= GRAD_TOL, path
    # the whole step on the prebinarized path
    step = TTL.make_train_step(cfg, TTL.TrainConfig(optimizer=TA.AdamWConfig(lr=1e-3, warmup_steps=1)),
                               device="cpu")
    p2, _, met = step(m["tparams"], TA.init_state(m["tparams"]), batch)
    assert torch.equal(met["loss"], plain_m["loss"]) and bool(torch.isfinite(met["grad_norm"]))