"""Float serving in the port against the reference run op by op
(``jax.disable_jit()``), on the granite-8b smoke model (CPU):

* ``FLOAT_QUANT``: bf16 weights, the bf16 GQA ``k`` / ``v`` cache, float
  scores and P.V;
* W1A8 linears with ``quantize_attention=False`` (the int8 cache, read back
  dequantized by float attention);
* ``prefill(length=)``, the right-padded bucketed prefill: logits and
  cache leaves against the reference's, and the pads never leaking into
  the logits or the cache a request decodes from.

The latent (MLA) cases are ``tests/test_torch_float_mla.py``.  Every cache
leaf is compared bit for bit after the prefill and after each decode step,
and greedy tokens exactly.  Logits are held to 1e-6: the float32
unembedding sums in another order than XLA's (a few float32 ulps).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs.base import FLOAT_QUANT as J_FLOAT
from repro.configs.smoke import smoke_variant as jsmoke
from repro.models import model_zoo as JZ
from repro_torch import convert
from repro_torch.configs import get_config as tget
from repro_torch.configs.base import FLOAT_QUANT
from repro_torch.configs.smoke import smoke_variant as tsmoke
from repro_torch.models import model_zoo as Z
from repro_torch.runtime.serve_loop import Request, ServeEngine, serve_sequential
from torch_port_fixtures import release_jax_caches  # noqa: F401  (autouse)

MAX_LEN = 32
LOGIT_ATOL = 1e-6

CASES = {
    "granite-float": ("granite-8b", "float"),
    "granite-noquant-attention": ("granite-8b", "quantize_attention"),
    "deepseek-kv16": ("deepseek-v2-lite-16b", "kv16"),
    "deepseek-float": ("deepseek-v2-lite-16b", "float"),
}
#: bf16 ulps a cache leaf may differ by (ROADMAP section 3): deepseek's float
#: absorbed decode takes float32 einsums, which XLA sums in another order
BF16_ULPS = {"deepseek-float": 1}


def _variant(cfg, how: str, float_quant):
    if how == "float":
        return dataclasses.replace(cfg, quant=float_quant, name=cfg.name + "-fp")
    if how == "kv16":
        return dataclasses.replace(cfg, quant=dataclasses.replace(cfg.quant, kv_cache_bits=16))
    return dataclasses.replace(cfg, quant=dataclasses.replace(cfg.quant, quantize_attention=False))


_MODELS = {}


def models(name: str):
    if name not in _MODELS:
        arch, how = CASES[name]
        jcfg = _variant(jsmoke(jget(arch)), how, J_FLOAT)
        tcfg = _variant(tsmoke(tget(arch)), how, FLOAT_QUANT)
        js = JZ.prepare_serving_params(JZ.init_params(jax.random.PRNGKey(0), jcfg), jcfg)
        ts = convert.from_reference(jax.tree.map(np.asarray, js), tcfg, device="cpu")
        _MODELS[name] = (jcfg, js, tcfg, ts)
    return _MODELS[name]


def _assert_caches_equal(jcache, tcache, n_periods: int, bf16_ulps: int = 0):
    want = convert._unstack(jax.tree.map(np.asarray, jcache["stack"]), n_periods, "cpu")
    assert len(want) == len(tcache["layers"])
    for i, (w, g) in enumerate(zip(want, tcache["layers"])):
        assert w.keys() == g.keys(), (i, sorted(w), sorted(g))
        for k in g:
            assert w[k].dtype == g[k].dtype, (i, k, w[k].dtype, g[k].dtype)
            if bf16_ulps and g[k].dtype == torch.bfloat16:
                ulps = (w[k].view(torch.int16).int() - g[k].view(torch.int16).int()).abs().max()
                assert int(ulps) <= bf16_ulps, f"layer {i} leaf {k} differs by {int(ulps)} ulps"
            else:
                assert torch.equal(w[k], g[k]), f"layer {i} leaf {k} differs"


def run_op_by_op(name: str, n_decode: int = 5):
    """Prefill a 9-token prompt and ``n_decode`` greedy steps through both,
    every cache leaf and the logits compared at each step."""
    jcfg, js, tcfg, ts = models(name)
    prompt = np.random.default_rng(3).integers(0, tcfg.vocab_size, size=(1, 9)).astype(np.int32)
    with jax.disable_jit():
        jl, jc = JZ.prefill(js, jnp.asarray(prompt), jcfg, JZ.init_cache(1, MAX_LEN, jcfg))
        tl, tc = Z.prefill(ts, torch.as_tensor(prompt.astype(np.int64)), tcfg,
                           Z.init_cache(1, MAX_LEN, tcfg, device="cpu"))
        want_tokens, got_tokens = [], []
        for step in range(n_decode):
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=LOGIT_ATOL)
            _assert_caches_equal(jc, tc, tcfg.n_periods, BF16_ULPS.get(name, 0))
            want_tokens.append(int(np.argmax(np.asarray(jl)[0])))
            got_tokens.append(int(tl[0].argmax()))
            jl, jc = JZ.decode_step(js, jnp.asarray([want_tokens[-1]], jnp.int32), jcfg, jc)
            tl, tc = Z.decode_step(ts, torch.tensor([got_tokens[-1]]), tcfg, tc)
    assert got_tokens == want_tokens
    return tc


@pytest.mark.parametrize("name", ["granite-float", "granite-noquant-attention"])
def test_cache_leaves_and_greedy_tokens_op_by_op(name):
    tc = run_op_by_op(name)
    kinds = {leaf.dtype for layer in tc["layers"] for leaf in layer.values()}
    assert (torch.int8 in kinds) == (name == "granite-noquant-attention")


@pytest.mark.parametrize("seed", [29, 0, 1])
def test_float_linear_rounds_as_xla(seed):
    """A bf16 product accumulated in float32 and rounded once, as XLA's:
    at seed 29 PyTorch's CPU bf16 einsum rounds one element otherwise
    (fault 3.3, ROADMAP section 3)."""
    from repro_torch.models import layers as L

    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((9, 64)) * 1.5).astype(np.float32)
    w = (rng.standard_normal((64, 96)) / 8).astype(np.float32)
    want = jnp.einsum("...k,kn->...n", jnp.asarray(x).astype(jnp.bfloat16),
                      jnp.asarray(w).astype(jnp.bfloat16))
    got = L.float_linear({"w": torch.from_numpy(w).to(torch.bfloat16)},
                         torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def test_float_engine_equals_serve_sequential():
    """The engine over the bf16 cache (its replayed step eager on the CPU)
    gives serve_sequential's greedy tokens."""
    _, _, tcfg, ts = models("granite-float")

    def reqs():
        r = np.random.default_rng(5)
        return [Request(prompt=r.integers(0, 256, size=(int(r.integers(3, 12)),)).astype(np.int32),
                        max_new_tokens=int(r.integers(2, 7))) for _ in range(5)]

    want = serve_sequential(tcfg, ts, reqs(), max_len=MAX_LEN, seed=0, device="cpu")
    got = ServeEngine(tcfg, ts, batch_slots=2, max_len=MAX_LEN, seed=0, device="cpu").run(reqs())
    assert [g.output for g in got] == [w.output for w in want]
    assert all(g.state == "ok" for g in got)


# ---------------------------------------------------------------------------
# prefill(length=)
# ---------------------------------------------------------------------------


def _padded_batch(rng, lengths, width, vocab):
    toks = rng.integers(0, vocab, size=(len(lengths), width)).astype(np.int32)
    return toks, np.asarray(lengths, np.int32)


def test_padded_prefill_equals_reference():
    """A right-padded batch through ``prefill(length=)``: logits at each
    row's last real token and every cache leaf, cursors rewound to the
    lengths, as the reference's; one decode step from there too."""
    jcfg, js, tcfg, ts = models("granite-float")
    toks, lengths = _padded_batch(np.random.default_rng(7), [3, 8, 5], 8, tcfg.vocab_size)
    with jax.disable_jit():
        jl, jc = JZ.prefill(js, jnp.asarray(toks), jcfg, JZ.init_cache(3, MAX_LEN, jcfg),
                            length=jnp.asarray(lengths))
        tl, tc = Z.prefill(ts, torch.as_tensor(toks.astype(np.int64)), tcfg,
                           Z.init_cache(3, MAX_LEN, tcfg, device="cpu"),
                           length=torch.as_tensor(lengths))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=LOGIT_ATOL)
        _assert_caches_equal(jc, tc, tcfg.n_periods)
        assert all(layer["pos"].tolist() == lengths.tolist() for layer in tc["layers"])
        nxt = np.argmax(np.asarray(jl), -1).astype(np.int32)
        jl, jc = JZ.decode_step(js, jnp.asarray(nxt), jcfg, jc)
        tl, tc = Z.decode_step(ts, torch.as_tensor(nxt.astype(np.int64)), tcfg, tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=LOGIT_ATOL)
        _assert_caches_equal(jc, tc, tcfg.n_periods)


def _pad_isolation(plen: int, pad: int, seed: int):
    """Garbage in the pad region changes neither the last real token's
    logits nor the cache a request decodes from (the reference's property,
    ``tests/test_serve_slots.py``, at its tolerance)."""
    _, _, tcfg, ts = models("granite-float")
    rng = np.random.default_rng(seed)
    prompt = rng.integers(0, tcfg.vocab_size, size=(1, plen))
    garbage = rng.integers(0, tcfg.vocab_size, size=(1, pad))
    padded = np.concatenate([prompt, garbage], axis=1)
    exact_logits, exact_cache = Z.prefill(ts, torch.as_tensor(prompt), tcfg,
                                          Z.init_cache(1, MAX_LEN, tcfg, device="cpu"))
    pad_logits, pad_cache = Z.prefill(ts, torch.as_tensor(padded), tcfg,
                                      Z.init_cache(1, MAX_LEN, tcfg, device="cpu"),
                                      length=torch.tensor([plen]))
    np.testing.assert_allclose(pad_logits.numpy(), exact_logits.numpy(), rtol=1e-4, atol=1e-4)
    nxt = exact_logits.argmax(-1)
    d_exact, _ = Z.decode_step(ts, nxt, tcfg, exact_cache)
    d_pad, _ = Z.decode_step(ts, nxt, tcfg, pad_cache)
    np.testing.assert_allclose(d_pad.numpy(), d_exact.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("plen,pad,seed", [(1, 1, 0), (4, 6, 1), (10, 3, 2), (7, 1, 3)])
def test_right_padding_never_leaks_into_logits(plen, pad, seed):
    _pad_isolation(plen, pad, seed)


def test_right_padding_never_leaks_into_logits_property():
    hypothesis = pytest.importorskip("hypothesis")
    st = hypothesis.strategies

    @hypothesis.settings(max_examples=8, deadline=None)
    @hypothesis.given(plen=st.integers(min_value=1, max_value=10),
                      pad=st.integers(min_value=1, max_value=6),
                      seed=st.integers(min_value=0, max_value=2**16))
    def prop(plen, pad, seed):
        _pad_isolation(plen, pad, seed)

    prop()
