"""The mixture-of-experts FFN of the port (``repro_torch.models.moe``) and
the deepseek configs, against the JAX reference on the CPU.

What must agree, and how:

* every config field of deepseek-v2-lite-16b and deepseek-v3-671b, full
  and smoke, the ``mla`` / ``moe`` sub-configs field by field;
* the rank-3 expert pipeline: ``binarize_weight`` scales (reduced over
  axis 1, padded at each 32-row level as XLA pads it) and
  ``pack_experts_for_serving`` (packed words, scales, offsets, colsums),
  bit for bit at K = 2048, 1408, 7168 and 18432;
* ``expert_qlinear`` and ``moe_ffn`` in serve mode, bit for bit against
  the reference run op by op: the routes (experts; weights to
  ``ROUTER_ULPS`` float32 ulps, the router's ``td,de`` product being the
  one float reduction whose order XLA and torch do not share, and their
  bf16 combine weights
  exactly), ``keep`` and ``dest`` of the capacity dispatch, the rows each
  expert receives, and the output -- with a softmax and a sigmoid router,
  token counts that overflow the capacity, and tied router scores.
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
from repro.core import quantization as JQ
from repro.models import layers as JL
from repro.models import moe as JM
from repro_torch import convert
from repro_torch.configs import get_config as tget
from repro_torch.configs.smoke import smoke_variant as tsmoke
from repro_torch.core import quantization as TQ
from repro_torch.models import moe as TM
from torch_port_fixtures import release_jax_caches  # noqa: F401  (autouse)

NAMES = ["deepseek-v2-lite-16b", "deepseek-v3-671b"]
ROUTER_ULPS = 4  # float32 ulps between the two sides' route weights (see _check)


def _backend(cfg, backend):
    return dataclasses.replace(cfg, quant=dataclasses.replace(cfg.quant, backend=backend))


def _fields_equal(got, want, path=""):
    if dataclasses.is_dataclass(want):
        assert dataclasses.is_dataclass(got), path
        names = {f.name for f in dataclasses.fields(want)}
        assert {f.name for f in dataclasses.fields(got)} <= names, path
        for f in dataclasses.fields(got):
            _fields_equal(getattr(got, f.name), getattr(want, f.name), f"{path}.{f.name}")
        if hasattr(want, "shared_ff"):
            assert got.shared_ff == want.shared_ff, path
    else:
        assert got == want, path


@pytest.mark.parametrize("size", ["full", "smoke"])
@pytest.mark.parametrize("name", NAMES)
def test_config_fields_equal_reference(name, size):
    j, t = jget(name), tget(name)
    if size == "smoke":
        j, t = jsmoke(j), tsmoke(t)
    _fields_equal(t, j, name)
    assert t.layer_kinds == j.layer_kinds
    assert t.mla is not None and t.moe is not None
    for field in ("mla", "moe", "mtp_depth"):
        assert field in {f.name for f in dataclasses.fields(t)}, field


@pytest.mark.parametrize("k", [2048, 1408, 7168, 18432])
def test_rank3_binarize_and_pack_bit_identical(k):
    """Two experts of a narrow N: the scales reduce over axis 1 in XLA's
    padded 32-row levels, and the packed words, offsets and colsums equal
    the reference's."""
    w = np.random.default_rng(k).standard_normal((2, k, 5)).astype(np.float32)
    want_scale = np.asarray(JQ.binarize_weight(jnp.asarray(w)).scale)
    got = TQ.binarize_weight(torch.from_numpy(w))
    assert got.scale.shape == (2, 1, 5)
    np.testing.assert_array_equal(got.scale.numpy(), want_scale)
    quant = jget(NAMES[0]).quant
    want = JM.pack_experts_for_serving({"w": jnp.asarray(w)}, quant)
    mine = TM.pack_experts_for_serving({"w": torch.from_numpy(w)}, tget(NAMES[0]).quant)
    assert set(mine) == set(want)
    for key in want:
        ref = convert.to_tensor(np.asarray(want[key]), device="cpu")
        assert mine[key].dtype == ref.dtype and torch.equal(mine[key], ref), key
    assert mine["w_packed"].shape == (2, -(-k // 32), 5) and mine["w_colsum"].shape == (2, 5)


@pytest.mark.parametrize("backend", ["mxu", "pallas"])
def test_expert_qlinear_bit_identical(backend):
    """(E, C, K) bf16 tokens, each on its own activation grid, against the
    reference's serve-mode product; a row of zeros (an empty capacity
    slot) takes the 1e-8 scale floor."""
    rng = np.random.default_rng(3)
    e, c, k, n = 4, 3, 64, 40
    w = rng.standard_normal((e, k, n)).astype(np.float32)
    x = rng.standard_normal((e, c, k)).astype(np.float32)
    x[1, 2] = 0.0
    jq, tq = jget(NAMES[0]).quant, _backend(tget(NAMES[0]), backend).quant
    packed = JM.pack_experts_for_serving({"w": jnp.asarray(w)}, jq)
    packed_t = {key: convert.to_tensor(np.asarray(v), device="cpu") for key, v in packed.items()}
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    with jax.disable_jit():
        want = np.asarray(JM.expert_qlinear(packed, xb, jq, "serve", k).astype(jnp.float32))
    got = TM.expert_qlinear(packed_t, convert.to_tensor(np.asarray(xb), device="cpu"), tq, k)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.fixture(scope="module")
def moe_params():
    """Each smoke config's first MoE layer: the reference's latent params,
    packed by the reference, and their port copies."""
    built = {}

    def get(name):
        if name not in built:
            jcfg, tcfg = jsmoke(jget(name)), _backend(tsmoke(tget(name)), "pallas")
            p = JM.init_moe(jax.random.PRNGKey(1), jcfg)
            serving = {
                k: (JM.pack_experts_for_serving(v, jcfg.quant) if k in ("up", "gate", "down") else v)
                for k, v in p.items()
            }
            serving["shared"] = {s: JL.pack_linear_for_serving(v, jcfg.quant)
                                 for s, v in p["shared"].items()}
            built[name] = dict(jcfg=jcfg, tcfg=tcfg, serving=serving)
        return built[name]

    return get


def _to_port(tree):
    return jax.tree.map(lambda a: convert.to_tensor(np.asarray(a), device="cpu"), tree)


def _reference_dispatch(experts, e, t):
    """The reference's capacity dispatch (``repro/models/moe.py``, the lines
    between the router and the buffer), transcribed in jnp."""
    tk = t * e.top_k
    capacity = int(max(1, round(e.capacity_factor * tk / e.n_routed)))
    order = jnp.argsort(experts.reshape(tk))
    se = experts.reshape(tk)[order]
    pos = jnp.arange(tk) - jnp.searchsorted(se, se, side="left")
    keep = pos < capacity
    dest = jnp.where(keep, se * capacity + pos, e.n_routed * capacity)
    return capacity, np.asarray(order), np.asarray(keep), np.asarray(dest)


def _run_both(m, x, router=None):
    """The reference's and the port's ``moe_ffn`` on the same (B, S, D)
    input, op by op; each run's routes and the rows its experts receive are
    recorded."""
    jcfg, tcfg = m["jcfg"], m["tcfg"]
    serving = dict(m["serving"])
    if router is not None:
        serving["router"] = {"w": jnp.asarray(router)}
    serving_t = _to_port(serving)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    seen = {"j": {}, "t": {}}

    def spy(side, real, key):
        def call(*args, **kwargs):
            out = real(*args, **kwargs)
            seen[side].setdefault(key, out)
            return out
        return call

    def spy_in(side, real):
        def call(p, x, *args, **kwargs):
            seen[side].setdefault("h_in", x)
            return real(p, x, *args, **kwargs)
        return call

    with jax.disable_jit(), mock.patch.object(JM, "_route", spy("j", JM._route, "route")), \
            mock.patch.object(JM, "expert_qlinear", spy_in("j", JM.expert_qlinear)):
        want, _ = JM.moe_ffn(serving, xb, jcfg, "serve")
    with mock.patch.object(TM, "_route", spy("t", TM._route, "route")), \
            mock.patch.object(TM, "expert_qlinear", spy_in("t", TM.expert_qlinear)):
        got = TM.moe_ffn(serving_t, convert.to_tensor(np.asarray(xb), device="cpu"), tcfg)
    return want, got, seen


def _check(m, x, router=None, expect_drops=None):
    want, got, seen = _run_both(m, x, router)
    e, t = m["tcfg"].moe, x.shape[0] * x.shape[1]
    (jw, ji), (tw, ti) = seen["j"]["route"], seen["t"]["route"]
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    # The router's float32 ``td,de`` product is the one step not reachable
    # bit for bit: XLA's CPU dot accumulates in its own order (four
    # fused-multiply-add lanes), torch in another, so the logits differ in
    # their last bits and the normalised weights by up to ROUTER_ULPS.  The
    # combine weights ride in bf16, and those must be equal -- from there
    # on everything is bit for bit.
    jw = np.asarray(jw)
    ulps = np.abs(tw.numpy() - jw) / np.spacing(np.abs(jw))
    assert ulps.max() <= ROUTER_ULPS, f"router weights {ulps.max()} ulps apart"
    np.testing.assert_array_equal(tw.to(torch.bfloat16).float().numpy(),
                                  np.asarray(jnp.asarray(jw).astype(jnp.bfloat16).astype(jnp.float32)))
    capacity, order, keep, dest = _reference_dispatch(ji, e, t)
    t_order, _, t_keep, t_dest = TM._dispatch(ti, capacity, e.n_routed * capacity)
    np.testing.assert_array_equal(t_order.numpy(), order)
    np.testing.assert_array_equal(t_keep.numpy(), keep)
    np.testing.assert_array_equal(t_dest.numpy(), dest)
    h_in = seen["t"]["h_in"]
    assert h_in.shape == (e.n_routed, capacity, m["tcfg"].d_model)
    np.testing.assert_array_equal(h_in.float().numpy(), np.asarray(seen["j"]["h_in"].astype(jnp.float32)))
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    if expect_drops is not None:
        assert (not keep.all()) == expect_drops, f"routes dropped: {int((~keep).sum())}"
    return keep


# (batch, seq): 1 token (capacity 1, no drop possible for top-2 of 8
# distinct experts), a 4-slot decode step (capacity 1: drops wherever two
# rows share an expert), and prompts whose 2T routes overflow capacity
SHAPES = {"one-token": (1, 1), "decode-4-slots": (4, 1), "prefill-9": (1, 9), "prefill-24": (2, 12)}


@pytest.mark.parametrize("shape", list(SHAPES), ids=list(SHAPES))
@pytest.mark.parametrize("name", NAMES, ids=["softmax-router", "sigmoid-router"])
def test_moe_ffn_bit_identical(moe_params, name, shape):
    b, s = SHAPES[shape]
    m = moe_params(name)
    x = np.random.default_rng(b * 100 + s).standard_normal((b, s, m["tcfg"].d_model)).astype(np.float32)
    keep = _check(m, x, expect_drops=False if shape == "one-token" else None)
    if shape == "prefill-24":
        assert not keep.all(), "this case must overflow an expert's capacity"


@pytest.mark.parametrize("name", NAMES, ids=["softmax-router", "sigmoid-router"])
def test_moe_ffn_tied_router_scores(moe_params, name):
    """Two experts with identical router columns score every token alike;
    top-k must break the tie toward the lower index, as ``lax.top_k``
    does, and everything downstream follow."""
    m = moe_params(name)
    router = np.array(m["serving"]["router"]["w"])
    router[:, 5] = router[:, 2]
    router[:, 6] = router[:, 2]
    x = np.random.default_rng(8).standard_normal((1, 6, m["tcfg"].d_model)).astype(np.float32)
    _check(m, x, router=router)
    with torch.no_grad():
        _, idx = TM._route(torch.from_numpy(np.ones((1, 8), np.float32)), m["tcfg"].moe, 2)
    assert idx.tolist() == [[0, 1]]


def test_capacity_is_static_and_matches_reference_rounding():
    """The capacity is a Python int of the shapes alone (``round`` half to
    even, at least 1): no host sync in the step."""
    e = tget(NAMES[0]).moe
    for t, want in ((4, 1), (1, 1), (128, 15), (1500, 176), (2, 1)):
        assert int(max(1, round(e.capacity_factor * t * e.top_k / e.n_routed))) == want
