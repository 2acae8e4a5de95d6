"""Multi-device QAT training of the port on the CPU: the mesh step
(``make_train_step(mesh=)``), the packed-weight gather
(``prebinarize_params``), the compressed data-parallel step, sharded
checkpoints and MoE layers routing the global microbatch over data ranks,
in one group of 4 gloo ranks (``torch_dist_workers.train_worker``, spawned
once for the module).

The oracle of a mesh step is the port's 1-rank step on the same global
batch, itself held to the reference's ``make_train_step``
(``tests/test_torch_train_step.py``).  The packed gather's values and
straight-through gradients are held to the reference's
``prebinarize_params`` on a 1x1 mesh, bit for bit.

Tolerances, with what was seen:

* a mesh with ``data = 1`` (1x2): bit for bit (compute replicated over
  ``model``; the gathers and scatters move values as they are);
* 2x2 against 2x1: bit for bit (the model axis adds gathers only);
* ``data = 2`` against 1 rank: every fake-quant range is the 1-rank
  step's bit for bit (the forward is the global batch's), but each rank's
  weight gradients come out of a bf16 product, rounded to bf16 before the
  ranks' sum, so AdamW's first moment (``0.1 g``) is held to ``2**-6`` of
  its leaf's largest value (5.3e-3 seen) and the loss to 4 float32 ulps
  (the mean of two shard means; 1 seen); params to ``2 lr`` (Adam's first
  step moves each element by ``lr`` times the sign of its gradient, which
  flips where the gradient is tiny).
* an MoE layer over ``data = 2``: its routes, ``keep``, ``dest`` and expert
  buffer ``h_in`` are the 1-rank step's bit for bit (the global dispatch);
  the balance loss ``aux`` within 4 float32 ulps (the router's
  probabilities summed a rank at a time; 1 seen), the loss and first
  moments as above.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs.smoke import smoke_variant as ref_smoke_variant
from repro.launch.mesh import make_host_mesh as ref_host_mesh
from repro.models import model_zoo as RZ
from repro.runtime import train_loop as RTL
from repro_torch import convert
from repro_torch.core import quantization as Q
from repro_torch.core import tree
from repro_torch.optim import adamw
from repro_torch.runtime import sharding as SH
from repro_torch.runtime import train_loop as TL
from torch_dist_workers import MOE_CASES, _cfg, moe_spy, moe_tcfg, run_ranks
from torch_port_fixtures import release_jax_caches  # noqa: F401  (autouse)

# the clip never engages (grad_clip 1e6), so a global norm that differs in
# its last bits (shards' sums of squares added in another order) leaves the
# update as it is; the norm itself is held to 1e-6 below
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10, grad_clip=1e6)
NAMES = ("granite-8b", "bit-bert-base")
MOE_NAMES = ("deepseek-v2-lite-16b", "deepseek-v3-671b")
BATCH, SEQ = 8, 16
ULP4 = 4 * np.finfo(np.float32).eps


def _batches() -> dict:
    out = {}
    for i, name in enumerate(NAMES + MOE_NAMES):
        rng = np.random.default_rng(10 + i)
        out[name] = {"tokens": rng.integers(0, _cfg(name).vocab_size, size=(BATCH, SEQ)).astype(np.int32)}
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh")
    return run_ranks("train_worker", 4, tmp, {"opt": OPT, "batch": _batches(), "ckpt_dir": str(tmp / "ckpt")})


def _tcfg():
    return TL.TrainConfig(optimizer=adamw.AdamWConfig(**OPT))


def _one_rank(name: str, **quant):
    cfg = _cfg(name, **quant)
    params, opt = TL.init_train_state(0, cfg, device="cpu")
    p2, o2, met = TL.make_train_step(cfg, _tcfg(), device="cpu")(params, opt, _batches()[name])
    return {"params": p2, "mu": o2.mu, "nu": o2.nu, "metrics": met}, params


def _equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(tree.leaves(a), tree.leaves(b)))


@pytest.mark.parametrize("name", NAMES)
def test_mesh_steps_equal_the_one_rank_step(ranks, name):
    """2x1, 1x2 and 2x2 against the 1-rank step on the global batch."""
    want, _ = _one_rank(name)
    by_mesh = {(2, 1): ranks[0][(name, (2, 1))], (1, 2): ranks[2][(name, (1, 2))],
               (2, 2): ranks[0][(name, (2, 2))]}
    one = by_mesh[(1, 2)]
    assert _equal(one["params"], want["params"]) and _equal(one["mu"], want["mu"])
    assert _equal(one["nu"], want["nu"])
    for k in ("loss", "aux", "nll", "lr"):
        assert torch.equal(one["metrics"][k], want["metrics"][k]), k
    two, four = by_mesh[(2, 1)], by_mesh[(2, 2)]
    for key in ("params", "mu", "nu"):
        assert _equal(two[key], four[key]), key
    for k in ("loss", "aux", "nll", "lr"):
        assert torch.equal(two["metrics"][k], four["metrics"][k]), k
    loss, ref_loss = float(two["metrics"]["loss"]), float(want["metrics"]["loss"])
    assert abs(loss - ref_loss) <= 4 * np.finfo(np.float32).eps * abs(ref_loss)
    ref_gn = float(want["metrics"]["grad_norm"])
    for m in (one, four):
        assert abs(float(m["metrics"]["grad_norm"]) - ref_gn) <= 1e-6 * ref_gn
    assert abs(float(two["metrics"]["grad_norm"]) - ref_gn) <= 2.0 ** -7 * ref_gn
    worst = 0.0
    for path, got in tree.leaves_with_paths(two["mu"]):
        ref_mu = dict(tree.leaves_with_paths(want["mu"]))[path]
        top = float(ref_mu.abs().max())
        gap = float((got - ref_mu).abs().max())
        assert gap <= 2.0 ** -6 * top + 1e-30, (path, gap, top)
        worst = max(worst, gap / max(top, 1e-30))
    assert worst > 0  # the bf16 rounding of each rank's share does show
    for got, ref_p in zip(tree.leaves(two["params"]), tree.leaves(want["params"])):
        assert float((got - ref_p).abs().max()) <= 2 * OPT["lr"] * (1 + 1e-3)
    # every rank of a mesh returned the same global trees
    assert _equal(ranks[1][(name, (2, 1))]["params"], two["params"])
    assert _equal(ranks[3][(name, (2, 2))]["params"], four["params"])


def test_fake_quant_ranges_span_the_global_batch(ranks):
    """A spy on ``fake_quant``'s calibration: at every site of the 2x1 step,
    forward and remat's recompute alike, both ranks use one range, equal
    bit for bit to the 1-rank step's on the global batch; each rank's own
    rows alone give another range at some sites."""
    seen = []
    calibrate = Q._calibrate

    def spy(xd):
        lo, hi = calibrate(xd)
        seen.append((lo.clone(), hi.clone()))
        return lo, hi

    Q._calibrate = spy
    try:
        _one_rank("granite-8b")
    finally:
        Q._calibrate = calibrate
    r0, r1 = ranks[0]["ranges"], ranks[1]["ranges"]
    assert len(r0) == len(r1) == len(seen) > 10
    differs = 0
    for (own0, g0), (own1, g1), want in zip(r0, r1, seen):
        assert torch.equal(g0[0], want[0]) and torch.equal(g0[1], want[1])
        assert torch.equal(g1[0], want[0]) and torch.equal(g1[1], want[1])
        assert torch.equal(torch.minimum(own0[0], own1[0]), want[0])
        assert torch.equal(torch.maximum(own0[1], own1[1]), want[1])
        differs += int(not (torch.equal(own0[0], want[0]) and torch.equal(own0[1], want[1])))
    assert differs > 0
    assert ranks[2]["ranges"] == [] and ranks[3]["ranges"] == []


def _ref_setup(name: str):
    cfg = _cfg(name)
    rcfg = ref_smoke_variant(ref_get_config(name))
    rcfg = dataclasses.replace(rcfg, n_layers=cfg.n_layers)
    rparams = RZ.init_params(jax.random.PRNGKey(0), rcfg)
    params = convert.from_reference(jax.tree.map(np.asarray, rparams), cfg, device="cpu")
    return cfg, rcfg, rparams, params


def test_prebinarized_weights_and_gradients_match_the_reference():
    """``prebinarize_params`` without a mesh against the reference's on a
    1x1 mesh: every QMM weight's bf16 ``alpha * sign(w)`` and its
    straight-through gradient (``g * alpha`` in float32) bit for bit; the
    router, norms and tables pass through as they are."""
    cfg, rcfg, rparams, params = _ref_setup("granite-8b")
    mesh = ref_host_mesh(1, 1)
    rng = np.random.default_rng(3)
    rhat = RTL.prebinarize_params(rparams, rcfg, mesh)
    want = convert.from_reference(jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), rhat), cfg,
                                  device="cpu")
    leaves = [p.detach().requires_grad_(True) for p in tree.leaves(params)]
    hat = TL.prebinarize_params(tree.unflatten(params, leaves), cfg)
    n_qmm = 0
    for (path, got), w, src in zip(tree.leaves_with_paths(hat), tree.leaves(want), leaves):
        if got is src:
            assert torch.equal(got, w), path
            continue
        n_qmm += 1
        assert got.dtype == torch.bfloat16 and torch.equal(got.float(), w), path
    assert n_qmm == 7 * cfg.n_layers
    # straight-through gradients of sum(hat * ct) against jax.vjp
    cts = [rng.standard_normal(tuple(x.shape)).astype(np.float32) for x in tree.leaves(hat)]
    total = sum((x.float() * torch.from_numpy(c)).sum() for x, c in zip(tree.leaves(hat), cts))
    grads = torch.autograd.grad(total, leaves)
    _, vjp = jax.vjp(lambda p: RTL.prebinarize_params(p, rcfg, mesh), rparams)
    # the same cotangents in the reference's layout (bf16 where its leaf is)
    ref_cts = _stack_like(rhat, cts, cfg)
    (rgrads,) = vjp(ref_cts)
    want_g = convert.from_reference(jax.tree.map(np.asarray, rgrads), cfg, device="cpu")
    for (path, g), w in zip(tree.leaves_with_paths(tree.unflatten(params, list(grads))), tree.leaves(want_g)):
        assert torch.equal(g, w), path


def _stack_like(ref_tree, port_leaves, cfg):
    """The port's per-layer leaves (in ``tree.leaves`` order of the port's
    layout) as a tree of the reference's layout like ``ref_tree``: each
    period position's layers stacked on a leading axis."""
    port_tree = tree.unflatten(convert.from_reference(jax.tree.map(np.asarray, ref_tree), cfg, device="cpu"),
                               [torch.from_numpy(c) for c in port_leaves])
    n_prefix, period = len(cfg.prefix_layers), len(cfg.pattern_period)

    def dtype_of(a):
        return a.dtype

    out = {}
    for k, v in ref_tree.items():
        if k == "stack":
            layers = port_tree["layers"]
            prefix = [jax.tree.map(lambda r, t: jnp.asarray(t.numpy()).astype(dtype_of(r)), rp, lp)
                      for rp, lp in zip(v["prefix"], layers[:n_prefix])]
            periods = []
            for j, rp in enumerate(v["period"]):
                group = layers[n_prefix + j::period]
                periods.append(jax.tree.map(
                    lambda r, *ts: jnp.stack([jnp.asarray(t.numpy()) for t in ts]).astype(dtype_of(r)), rp, *group))
            out[k] = {"prefix": prefix, "period": periods}
        else:
            out[k] = jax.tree.map(lambda r, t: jnp.asarray(t.numpy()).astype(dtype_of(r)), v, port_tree[k])
    return out


def test_prebinarized_mesh_step_gathers_packed_words(ranks):
    """The 2x2 step with ``prebinarize_gather``: each QMM weight's signs go
    over the wire as int32 words, 32 to a word (the reference's "32x"),
    its float leaves as they are; the loss within 4 float32 ulps of the
    1-rank prebinarized step's, the first moments within ``2**-6`` of each
    leaf's largest (K's partial |w| sums are added across ranks, and each
    rank's bf16 gradient share rounds, as above)."""
    got = ranks[0]["prebinarized"]
    want, _ = _one_rank("granite-8b", prebinarize_gather=True)
    g = got["gathered"]
    assert g["packed"] > 0 and g["latent_equiv"] == 32 * g["packed"]
    assert g["latent"] > 0
    loss, ref_loss = float(got["metrics"]["loss"]), float(want["metrics"]["loss"])
    assert abs(loss - ref_loss) <= 4 * np.finfo(np.float32).eps * abs(ref_loss)
    for path, mu in tree.leaves_with_paths(got["mu"]):
        ref_mu = dict(tree.leaves_with_paths(want["mu"]))[path]
        assert float((mu - ref_mu).abs().max()) <= 2.0 ** -6 * float(ref_mu.abs().max()) + 1e-30, path
    plain = ranks[0][("granite-8b", (2, 2))]["gathered"]
    assert plain["packed"] == 0 and plain["latent"] > 16 * g["packed"]


def test_dryrun_plan_equals_the_live_gathers(ranks):
    """The dry-run's account of a mesh step's gathers (``launch/dryrun.py``:
    the step's plan over shape-only shards of an abstract mesh) equals what
    the live 4-rank gathers counted, byte for byte, with and without the
    packed gather; the plan's reduce-scatter carries each rank's float32
    shards."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import abstract_mesh

    mesh = abstract_mesh((2, 2), ("data", "model"))
    for got, quant in ((ranks[0]["prebinarized"], dict(prebinarize_gather=True)),
                       (ranks[0][("granite-8b", (2, 2))], {})):
        plan = dryrun.collective_bytes(_cfg("granite-8b", **quant), mesh)
        assert plan["gathered"] == got["gathered"]
        assert plan["all-gather"]["count"] == (4 if quant else 2)
    shards = dryrun.argument_bytes(_cfg("granite-8b"), dryrun.SMOKE_SHAPE, mesh)["params"]
    assert plan["reduce-scatter"] == {"bytes": shards, "count": 1}


def test_compressed_dp_step_local_gradients_and_average(ranks):
    """Each rank's gradients, as ``compressed_psum`` receives them, are the
    single-device step's on its rows (local ranges), bit for bit; the
    step's params are AdamW on the int8 average of the two ranks' (built
    here from their gradients with ``compress``'s arithmetic), bit for bit,
    on both ranks; ``compress=False`` gives the same loss (the forward is
    the same)."""
    cfg = _cfg("bit-bert-base")
    tcfg = _tcfg()
    params, opt = TL.init_train_state(0, cfg, device="cpu")
    tokens = _batches()["bit-bert-base"]["tokens"]
    halves = []
    for r in range(2):
        _, g = TL.value_and_grad(params, {"tokens": torch.from_numpy(tokens[r * 4:(r + 1) * 4])}, cfg, tcfg)
        halves.append(g)
        assert _equal(ranks[r]["compressed"]["local"], g)
    _, whole = TL.value_and_grad(params, {"tokens": torch.from_numpy(tokens)}, cfg, tcfg)
    assert _equal(ranks[2]["compressed"]["local"], whole)  # 1x2: one data rank, the whole batch
    avg = []
    for a, b in zip(tree.leaves(halves[0]), tree.leaves(halves[1])):
        scale = torch.maximum(torch.maximum(a.abs().max(), b.abs().max()), torch.tensor(1e-12)) / 127.0
        qa = torch.clamp(torch.round(a / scale), -127, 127).to(torch.int32)
        qb = torch.clamp(torch.round(b / scale), -127, 127).to(torch.int32)
        avg.append(((qa + qb).to(torch.float32) * scale / 2.0).to(a.dtype))
    want, _, _ = adamw.apply_updates(params, tree.unflatten(params, avg), opt, tcfg.optimizer,
                                     adamw.decay_mask(params, cfg))
    for r in range(2):
        c = ranks[r]["compressed"]
        assert _equal(c["params"], want)
        assert torch.equal(c["metrics"]["loss"], c["plain_metrics"]["loss"])
        resid = [x - (torch.clamp(torch.round(x / s), -127, 127) * s) for x, s in
                 ((h, torch.maximum(torch.maximum(a.abs().max(), b.abs().max()), torch.tensor(1e-12)) / 127.0)
                  for h, a, b in zip(tree.leaves(halves[r]), tree.leaves(halves[0]), tree.leaves(halves[1])))]
        assert _equal(c["err"], tree.unflatten(params, resid))
    assert not _equal(ranks[0]["compressed"]["params"], ranks[0]["compressed"]["plain_params"])


def test_sharded_checkpoint_restores_onto_other_meshes(ranks):
    """A checkpoint saved by the 2x2 mesh (the leaves gathered to rank 0
    alone, in several buckets a dtype, and written there) restores onto
    2x1, 1x2 and 2x2: each rank's params are its slice of the saved global
    leaves under the new mesh's shardings."""
    saved = ranks[0][("granite-8b", (2, 2))]["params"]
    assert _equal(ranks[0]["gathered_to"]["params"], saved)
    assert _equal(ranks[0]["gathered_to"]["opt"].mu, ranks[0][("granite-8b", (2, 2))]["mu"])
    assert all(ranks[r]["gathered_to"] is None for r in (1, 2, 3))
    for r in range(4):
        for label in ("pair", "full"):
            got = ranks[r]["restored"][label]
            assert got["step"] == 7 and got["extras"] == {"note": "2x2"}
            mesh = _coords_mesh(label, r)
            for leaf, full, spec in zip(tree.leaves(got["params"]), tree.leaves(saved), got["specs"]):
                assert torch.equal(leaf, SH.local_shard(full, spec, mesh, got["coords"]))


def _coords_mesh(label: str, rank: int):
    from repro_torch.launch.mesh import abstract_mesh

    if label == "full":
        return abstract_mesh((2, 2), ("data", "model"))
    return abstract_mesh((2, 1) if rank < 2 else (1, 2), ("data", "model"))


# ---------------------------------------------------------------------------
# MoE layers over data ranks: the global microbatch's routing
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _moe_one_rank(key: str):
    """The 1-rank step of ``MOE_CASES[key]``'s model and config on the
    global batch, every MoE layer's routing spied as the ranks spy theirs."""
    name, _, fields, _ = MOE_CASES[key]
    cfg = _cfg(name)
    params, opt = TL.init_train_state(0, cfg, device="cpu")
    seen = []
    with moe_spy(seen):
        p2, o2, met = TL.make_train_step(cfg, moe_tcfg(OPT, **fields), device="cpu")(params, opt,
                                                                                     _batches()[name])
    return {"params": p2, "mu": o2.mu, "nu": o2.nu, "metrics": met, "seen": seen}


def _moe_run(ranks, key: str, rank: int):
    return ranks[rank]["moe"][key]


def _assert_dispatch_is_global(got: list, want: list, r: int, n: int):
    """Rank ``r`` of ``n``'s spied routing against the 1-rank step's: its
    rows' routes, and its sorted routes' keep and destinations as the
    1-rank step's sorted routes of its tokens; ``h_in`` whole."""
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        t = g["experts"].shape[0]
        assert w["experts"].shape[0] == n * t
        assert torch.equal(g["experts"], w["experts"][r * t:(r + 1) * t])
        mine = w["st"] // t == r
        assert torch.equal(g["st"] + r * t, w["st"][mine])
        assert torch.equal(g["keep"], w["keep"][mine])
        assert torch.equal(g["dest"], w["dest"][mine])
        assert torch.equal(g["h_in"], w["h_in"])


@pytest.mark.parametrize("key", ["v2_pair", "v2_full", "v3_pair", "v3_full"])
def test_moe_dispatch_over_data_ranks_is_the_one_rank_dispatch(ranks, key):
    """deepseek-v2-lite (softmax routing, shared experts) and deepseek-v3
    (sigmoid routing) smoke over 2x1 and 2x2: every MoE layer's routes,
    ``keep``, ``dest`` and expert buffer, forward and remat's recompute,
    are the 1-rank step's on the global batch, bit for bit; some routes
    are dropped at the global capacity."""
    want = _moe_one_rank(key)["seen"]
    for rank in (range(2) if key.endswith("pair") else range(4)):  # 2x2: data index rank // 2
        _assert_dispatch_is_global(_moe_run(ranks, key, rank)["seen"], want, rank if key.endswith("pair")
                                   else rank // 2, 2)
    assert any(not bool(w["keep"].all()) for w in want)


def _assert_bounded(got: dict, want: dict):
    """The module's bounds on a data = 2 step: loss and aux within 4 float32
    ulps, first moments within ``2**-6`` of each leaf's largest."""
    for k in ("loss", "aux"):
        a, b = float(got["metrics"][k]), float(want["metrics"][k])
        assert abs(a - b) <= ULP4 * abs(b), (k, a, b)
    for path, mu in tree.leaves_with_paths(got["mu"]):
        ref_mu = dict(tree.leaves_with_paths(want["mu"]))[path]
        assert float((mu - ref_mu).abs().max()) <= 2.0 ** -6 * float(ref_mu.abs().max()) + 1e-30, path


@pytest.mark.parametrize("name", ["v2", "v3"])
def test_moe_mesh_steps_are_bounded_and_2x2_equals_2x1(ranks, name):
    """The MoE models' 2x1 step within the module's bounds of the 1-rank
    step, its aux the global balance loss on both ranks alike; 2x2 equal to
    2x1 bit for bit (params, moments, metrics)."""
    want = _moe_one_rank(f"{name}_pair")
    two, four = _moe_run(ranks, f"{name}_pair", 0), _moe_run(ranks, f"{name}_full", 0)
    _assert_bounded(two, want)
    assert float(two["metrics"]["aux"]) > 0
    assert torch.equal(two["metrics"]["aux"], _moe_run(ranks, f"{name}_pair", 1)["metrics"]["aux"])
    for key in ("params", "mu", "nu"):
        assert _equal(two[key], four[key]), key
    for k in ("loss", "aux", "nll", "lr"):
        assert torch.equal(two["metrics"][k], four["metrics"][k]), k


def test_moe_over_one_data_rank_is_the_one_rank_step(ranks):
    """1x2 (one data rank, two model ranks) routes on one rank as the
    1-rank step does: params, moments and metrics bit for bit, no routing
    collective."""
    for key in ("v2_pair", "v3_pair"):
        want, one = _moe_one_rank(key), _moe_run(ranks, key, 2)
        for k in ("params", "mu", "nu"):
            assert _equal(one[k], want[k]), (key, k)
        for k in ("loss", "aux", "nll"):
            assert torch.equal(one["metrics"][k], want["metrics"][k]), (key, k)
        assert all(v == {"bytes": 0, "count": 0} for v in one["routing"].values())
        _assert_dispatch_is_global(one["seen"], want["seen"], 0, 1)


def test_moe_mesh_step_with_accumulation(ranks):
    """``accum_steps=2``: each microbatch's routing is the global
    microbatch's (capacity from its 2 x 4 rows' routes), bit for bit; the
    step within the bounds."""
    want = _moe_one_rank("v2_accum")
    for rank in range(2):
        _assert_dispatch_is_global(_moe_run(ranks, "v2_accum", rank)["seen"], want["seen"], rank, 2)
    _assert_bounded(_moe_run(ranks, "v2_accum", 0), want)


def test_moe_balance_gradient_is_summed_over_the_ranks(ranks):
    """``aux_weight=1.0``: the router's first moments stay within the
    bound.  With the balance statistics' backward left as the identity
    (each rank's probabilities given its own share of the gradient, ``n``
    times too small once the step averages the ranks) the loss is the same
    but the router's moments read beyond it."""
    want = _moe_one_rank("v2_aux")
    got, wrong = _moe_run(ranks, "v2_aux", 0), _moe_run(ranks, "v2_aux_identity", 0)
    _assert_bounded(got, want)
    assert torch.equal(wrong["metrics"]["loss"], got["metrics"]["loss"])
    router = [p for p, _ in tree.leaves_with_paths(want["mu"]) if "router" in p]
    assert router
    ref = dict(tree.leaves_with_paths(want["mu"]))
    gaps = [float((dict(tree.leaves_with_paths(wrong["mu"]))[p] - ref[p]).abs().max())
            / float(ref[p].abs().max()) for p in router]
    assert max(gaps) > 2.0 ** -6, gaps


def test_dryrun_plan_equals_the_live_routing(ranks):
    """The dry-run's routing bytes for deepseek-v2-lite smoke over 2x1
    (``dryrun.collective_bytes`` with the batch's shape: the counts, the
    buffer exchange, the balance statistics and their gradient, each MoE
    layer, remat's recompute counted again) equal the live step's counters
    on both ranks, with and without accumulation."""
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import abstract_mesh

    mesh = abstract_mesh((2, 1), ("data", "model"))
    shape = InputShape("smoke", SEQ, BATCH, "train")
    for key, accum in (("v2_pair", 1), ("v2_accum", 2)):
        plan = dryrun.collective_bytes(_cfg("deepseek-v2-lite-16b"), mesh, accum, shape)
        want = {part: {"bytes": v["bytes"], "count": v["count"]} for part, v in plan["routing"].items()}
        assert want["buffer"]["bytes"] > 0 and want["balance_grad"]["count"] == accum
        for rank in range(2):
            assert _moe_run(ranks, key, rank)["routing"] == want, (key, rank)
    assert plan["all-reduce"]["count"] == sum(v["count"] for k, v in want.items() if k.startswith("balance"))
