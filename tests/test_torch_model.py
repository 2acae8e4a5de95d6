"""granite-8b smoke through the port vs the JAX reference, same params.

Params come from the reference (``init_params`` -> ``prepare_serving_params``)
and cross through ``repro_torch.convert``.  What must agree, and how:

* packed weights, scales, offsets, colsums: bit for bit (the port's own
  ``prepare_serving_params`` on the converted latents);
* each ``qlinear`` site: bit for bit against the eager reference;
* int8 KV-cache mantissas and affines after a prefill and after a decode:
  bit for bit against the reference run op by op (``jax.disable_jit``),
  which also matches the port's logits to ``OPBYOP_ATOL``;
* logits against the compiled reference (``pallas`` backend, Pallas kernel
  in interpret mode): to ``TOL``.  Compiled, the reference fuses each layer
  and contracts mul+add into fma (see ``repro/kernels/fused_qmm.py``); a
  last-bit change in one product can flip a bf16 rounding (2**-8 relative)
  and then one 8-bit bucket of the next per-token quantization.  On this
  model that moves logits (|logit| < 1) by at most ~0.01 over 16 steps;
  ``TOL`` leaves a factor of three.  Greedy tokens must be identical, and
  where the top-5 order differs the test reports the two logits' margin.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs.smoke import smoke_variant as jsmoke
from repro.models import layers as JL
from repro.models import model_zoo as JZ
from repro_torch import convert
from repro_torch.configs import get_config as tget
from repro_torch.configs.smoke import smoke_variant as tsmoke
from repro_torch.models import layers as TL
from repro_torch.models import model_zoo as TZ
from torch_port_fixtures import release_jax_caches  # noqa: F401  (autouse)

TOL = 0.03
# float32 unembed over d_model=64 summed in another order: a few ulps of |logit| < 1
OPBYOP_ATOL = 1e-6
SITES = ["attn.q", "attn.k", "attn.v", "attn.o", "ffn.up", "ffn.gate", "ffn.down"]
CACHE_KEYS = ["k", "v", "k_scale", "k_offset", "v_scale", "v_offset", "pos"]


def _cfgs(backend):
    j, t = jsmoke(jget("granite-8b")), tsmoke(tget("granite-8b"))
    return (
        dataclasses.replace(j, quant=dataclasses.replace(j.quant, backend=backend)),
        dataclasses.replace(t, quant=dataclasses.replace(t.quant, backend=backend)),
    )


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = _cfgs("pallas")
    params = JZ.init_params(jax.random.PRNGKey(0), jcfg)
    serving = JZ.prepare_serving_params(params, jcfg)
    latent_t = convert.from_reference(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    serving_t = convert.from_reference(jax.tree.map(np.asarray, serving), tcfg, device="cpu")
    return jcfg, tcfg, serving, latent_t, serving_t


def _site(tree, site):
    block, lin = site.split(".")
    return tree[block][lin]


@pytest.mark.parametrize("site", SITES)
def test_prepare_serving_params_bit_identical(model, site):
    _, tcfg, _, latent_t, serving_t = model
    mine = TZ.prepare_serving_params(latent_t, tcfg)
    got, want = _site(mine["layers"][0], site), _site(serving_t["layers"][0], site)
    assert set(got) == set(want) == {"w_packed", "w_scale", "w_offset", "w_colsum"}
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert torch.equal(got[key], want[key]), f"{site}.{key} differs"


def test_prepare_serving_params_top_level(model):
    _, tcfg, _, latent_t, serving_t = model
    mine = TZ.prepare_serving_params(latent_t, tcfg)
    assert mine["embedding"].dtype == torch.bfloat16
    for key in ("embedding", "final_norm"):
        assert torch.equal(mine[key], serving_t[key]), key
    for key in ("ln1", "ln2"):
        assert torch.equal(mine["layers"][0][key], serving_t["layers"][0][key]), key


@pytest.mark.parametrize("site", SITES)
def test_qlinear_per_site_bit_identical(model, site):
    jcfg, tcfg, serving, _, serving_t = model
    k = 128 if site == "ffn.down" else 64
    x = (np.random.default_rng([3, len(site)]).standard_normal((2, 5, k)) * 2)
    xj = jnp.asarray(x, jnp.float32).astype(jnp.bfloat16)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(torch.bfloat16)
    jp = jax.tree.map(lambda a: a[0], serving["stack"]["period"][0])
    want = JL.qlinear(_site(jp, site), xj, jcfg.quant, "serve", name=site)
    got = TL.qlinear(_site(serving_t["layers"][0], site), xt, tcfg.quant, name=site)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


PROMPT = np.random.default_rng(0).integers(0, 256, size=(1, 8)).astype(np.int32)


def _snapshot(layer_cache):
    return {k: v.clone() for k, v in layer_cache.items()}


@pytest.fixture(scope="module")
def op_by_op(model):
    """One prefill and one decode through the reference run op by op, and
    the same through the port's ``pallas`` path.  The reference runs its
    ``mxu`` backend here: its backends agree exactly, and op by op the
    interpret-mode Pallas kernel would only cost time."""
    _, tcfg, serving, _, serving_t = model
    jcfg = _cfgs("mxu")[0]
    with jax.disable_jit():
        c = JZ.init_cache(1, 32, jcfg)
        jl, c = JZ.prefill(serving, jnp.asarray(PROMPT), jcfg, c)
        j_after_prefill = jax.tree.map(np.asarray, c["stack"]["period"][0])
        tok = int(np.argmax(np.asarray(jl)))
        jl2, c = JZ.decode_step(serving, jnp.asarray([tok], jnp.int32), jcfg, c)
        j_after_decode = jax.tree.map(np.asarray, c["stack"]["period"][0])
    tc = TZ.init_cache(1, 32, tcfg, device="cpu")
    tl, tc = TZ.prefill(serving_t, torch.from_numpy(PROMPT.astype(np.int64)), tcfg, tc)
    t_after_prefill = _snapshot(tc["layers"][0])
    tl2, tc = TZ.decode_step(serving_t, torch.tensor([tok]), tcfg, tc)
    return dict(
        j=(np.asarray(jl), np.asarray(jl2)), t=(tl.numpy(), tl2.numpy()),
        prefill=(j_after_prefill, t_after_prefill),
        decode=(j_after_decode, _snapshot(tc["layers"][0])),
    )


@pytest.mark.parametrize("when", ["prefill", "decode"])
def test_kv_cache_bit_identical(op_by_op, when):
    jc, tc = op_by_op[when]
    for key in CACHE_KEYS:
        want, got = jc[key][0], tc[key].numpy()  # reference leaves carry the layer axis
        assert got.dtype == want.dtype, key
        bad = np.argwhere(got != want)
        assert bad.size == 0, f"{when}: cache[{key!r}] differs at {bad[:5].tolist()}"


def test_logits_match_op_by_op_reference(op_by_op):
    for want, got in zip(op_by_op["j"], op_by_op["t"]):
        np.testing.assert_allclose(got, want, rtol=0, atol=OPBYOP_ATOL)


def _top5_report(step, want, got):
    wt, gt = np.argsort(-want)[:5], np.argsort(-got)[:5]
    for i, (a, b) in enumerate(zip(wt, gt)):
        if a != b:
            margin = abs(float(want[a]) - float(want[b]))
            assert margin <= TOL, (
                f"step {step}, layer 0 of 1: top-5 rank {i} is {b} (port) vs {a} "
                f"(reference); the reference separates them by {margin:.3g} > {TOL}"
            )


def test_greedy_decode_and_logits_vs_compiled_reference(model):
    """Prefill plus 16 greedy decode steps: logits within TOL at every step,
    tokens identical, top-5 order equal up to near-ties."""
    jcfg, tcfg, serving, _, serving_t = model
    prompt = np.random.default_rng(1).integers(0, 256, size=(1, 12)).astype(np.int32)
    jc = JZ.init_cache(1, 48, jcfg)
    tc = TZ.init_cache(1, 48, tcfg, device="cpu")
    jl, jc = JZ.prefill(serving, jnp.asarray(prompt), jcfg, jc)
    tl, tc = TZ.prefill(serving_t, torch.from_numpy(prompt.astype(np.int64)), tcfg, tc)
    jtoks, ttoks = [], []
    for step in range(17):
        want, got = np.asarray(jl)[0], tl.numpy()[0]
        gap = np.abs(want - got).max()
        assert gap <= TOL, f"step {step}: max |logit gap| {gap:.3g} > {TOL}"
        _top5_report(step, want, got)
        jtoks.append(int(np.argmax(want)))
        ttoks.append(int(np.argmax(got)))
        assert jtoks == ttoks, f"greedy tokens diverge at step {step}: {ttoks} vs {jtoks}"
        if step == 16:
            break
        jl, jc = JZ.decode_step(serving, jnp.asarray([jtoks[-1]], jnp.int32), jcfg, jc)
        tl, tc = TZ.decode_step(serving_t, torch.tensor([ttoks[-1]]), tcfg, tc)
    assert len(ttoks) == 17


def test_mxu_backend_logits(model):
    """The plain ``mxu`` backend against the reference's, and equal to the
    port's ``pallas`` path (same integer product, same epilogue order)."""
    jcfg, tcfg = _cfgs("mxu")
    _, tcfg_pallas, serving, _, serving_t = model
    tokens = torch.from_numpy(PROMPT.astype(np.int64))
    jl, _ = JZ.prefill(serving, jnp.asarray(PROMPT), jcfg, JZ.init_cache(1, 32, jcfg))
    tl, _ = TZ.prefill(serving_t, tokens, tcfg, TZ.init_cache(1, 32, tcfg, device="cpu"))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=TOL)
    tp, _ = TZ.prefill(serving_t, tokens, tcfg_pallas, TZ.init_cache(1, 32, tcfg, device="cpu"))
    assert torch.equal(tl, tp)


@pytest.mark.parametrize("backend", ["pallas", "fused"])
def test_cache_insert_and_reset(model, backend):
    """A batch-1 prefill copied into row 1 of a packed cache decodes like
    the batch-1 cache (to OPBYOP_ATOL: the float32 unembed product sums in an
    order that depends on the batch size; everything before it is
    per-row); reset restores the empty row."""
    _, tcfg = _cfgs(backend)
    serving_t = model[4]
    tokens = torch.from_numpy(PROMPT.astype(np.int64))
    slot = TZ.init_slot_cache(32, tcfg, device="cpu")
    l1, slot = TZ.prefill(serving_t, tokens, tcfg, slot)
    packed = TZ.init_cache(3, 32, tcfg, device="cpu")
    TZ.cache_insert(packed, slot, 1)
    tok = int(l1.argmax())
    want, _ = TZ.decode_step(serving_t, torch.tensor([tok]), tcfg, slot)
    got, _ = TZ.decode_step(serving_t, torch.tensor([0, tok, 0]), tcfg, packed)
    np.testing.assert_allclose(got[1].numpy(), want[0].numpy(), rtol=0, atol=OPBYOP_ATOL)
    for key in CACHE_KEYS:
        assert torch.equal(packed["layers"][0][key][1], slot["layers"][0][key][0]), key
    TZ.cache_reset(packed, 1, tcfg, 32)
    empty = TZ.init_cache(3, 32, tcfg, device="cpu")
    for key in CACHE_KEYS:
        assert torch.equal(packed["layers"][0][key][1], empty["layers"][0][key][1]), key


def test_init_serving_params_equals_init_then_prepare():
    """Building serving params one layer at a time (how the full-width
    model is made on the card) draws the same latents as ``init_params``
    and packs them exactly as ``prepare_serving_params`` does."""
    _, tcfg = _cfgs("pallas")
    tcfg = dataclasses.replace(tcfg, n_layers=2)
    want = TZ.prepare_serving_params(TZ.init_params(5, tcfg, device="cpu"), tcfg)
    got = TZ.init_serving_params(5, tcfg, device="cpu")
    assert len(got["layers"]) == 2
    for key in ("embedding", "final_norm"):
        assert torch.equal(got[key], want[key]), key
    for g, w in zip(got["layers"], want["layers"]):
        for site in SITES:
            for key, val in _site(w, site).items():
                assert torch.equal(_site(g, site)[key], val), f"{site}.{key}"
