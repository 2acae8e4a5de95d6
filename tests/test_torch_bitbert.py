"""bit-bert-base (W1A1) and its precision ladder (W1A2 / A4 / A8) through the
port vs the JAX reference, same params, at a 2-layer smoke size.

Params come from the reference (``init_params`` -> ``prepare_serving_params``)
and cross through ``repro_torch.convert``.  The four variants share one
architecture, so one set of params serves all four.  What must agree, and
how:

* packed weights, scales, colsums, and the bf16 ``embedding`` /
  ``unembedding`` / ``pos_embedding`` tables: bit for bit;
* each ``qlinear`` site, and the whole gelu FFN: bit for bit against the
  eager reference at every precision;
* int8 KV-cache mantissas and affines after a prefill and after decode
  steps, and the greedy tokens: bit for bit against the reference run op by
  op (``jax.disable_jit``), which the port's logits match to
  ``OPBYOP_ATOL``;
* against the compiled reference (``pallas`` backend, Pallas kernels in
  interpret mode): logits to ``COMPILED_TOL[bits]`` at A4 and A8, and at
  A1 and A2 the first layer's KV cache.  Compiled, the reference fuses
  each layer and contracts mul+add into fma, so its own logits drift from
  its op-by-op run; a last-bit change in a quantizer's input flips a
  mantissa wherever it sits on a bucket edge, and the coarser the grid,
  the larger the step that flip makes.  Measured on this model (12 steps,
  3 prompts, reference vs itself): up to 0.007 at A8, 0.10 at A4, 0.37 at
  A2 and 0.54 at A1, with logits below 1.  The tolerances leave a factor
  of about three at A8 and A4; at A2 and A1 the drift reaches the logits'
  own scale, so no logit tolerance could tell a fault from it there, and
  the check moves to the first layer, where the drift has not yet reached
  a mantissa: its K/V mantissas and offsets equal the compiled
  reference's, its scales to one float32 ulp (the fma rounding).  At A2
  and A1 the drift also changes the compiled reference's own greedy token,
  so greedy tokens are held to the op-by-op reference there and to the
  compiled one at A4 and A8.
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
from repro.models import layers as JL
from repro.models import model_zoo as JZ
from repro.runtime import serve_loop as JS
from repro_torch import convert
from repro_torch.configs import get_config as tget
from repro_torch.configs.smoke import smoke_variant as tsmoke
from repro_torch.kernels import ops as TO
from repro_torch.models import layers as TL
from repro_torch.models import model_zoo as TZ
from repro_torch.runtime.serve_loop import Request, ServeEngine, serve_sequential
from torch_port_fixtures import release_jax_caches  # noqa: F401  (autouse)

NAMES = {1: "bit-bert-base", 2: "bit-bert-base-a2", 4: "bit-bert-base-a4", 8: "bit-bert-base-a8"}
BITS = sorted(NAMES)
COMPILED_TOL = {8: 0.03, 4: 0.3}
# float32 unembed over d_model=64 summed in another order: a few ulps of |logit| < 1
OPBYOP_ATOL = 1e-6
SITES = ["attn.q", "attn.k", "attn.v", "attn.o", "ffn.up", "ffn.down"]
CACHE_KEYS = ["k", "v", "k_scale", "k_offset", "v_scale", "v_offset", "pos"]
N_LAYERS = 2
MAX_LEN = 48


def _cfgs(bits, backend="pallas"):
    j = dataclasses.replace(jsmoke(jget(NAMES[bits])), n_layers=N_LAYERS)
    t = dataclasses.replace(tsmoke(tget(NAMES[bits])), n_layers=N_LAYERS)
    return (
        dataclasses.replace(j, quant=dataclasses.replace(j.quant, backend=backend)),
        dataclasses.replace(t, quant=dataclasses.replace(t.quant, backend=backend)),
    )


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = _cfgs(1)
    params = JZ.init_params(jax.random.PRNGKey(0), jcfg)
    serving = JZ.prepare_serving_params(params, jcfg)
    latent_np = jax.tree.map(np.asarray, params)
    serving_np = jax.tree.map(np.asarray, serving)
    latent_t = convert.from_reference(latent_np, tcfg, device="cpu")
    serving_t = convert.from_reference(serving_np, tcfg, device="cpu")
    return dict(serving=serving, serving_np=serving_np, latent_np=latent_np,
                latent_t=latent_t, serving_t=serving_t)


def _site(tree, site):
    block, lin = site.split(".")
    return tree[block][lin]


def test_configs_match_reference():
    for bits, name in NAMES.items():
        j, t = jget(name), tget(name)
        for f in dataclasses.fields(t):
            if f.name != "quant":
                assert getattr(t, f.name) == getattr(j, f.name), f"{name}.{f.name}"
        for f in dataclasses.fields(t.quant):
            assert getattr(t.quant, f.name) == getattr(j.quant, f.name), f"{name}.quant.{f.name}"
        assert t.quant.act_bits == t.quant.attn_act_bits == bits
    full = tget("bit-bert-base")
    assert (full.n_layers, full.d_model, full.n_heads, full.d_ff, full.vocab_size, full.max_seq) == (
        12, 768, 12, 3072, 30522, 512)
    assert not full.causal and not full.tie_embeddings and full.pos_embedding == "learned"


@pytest.mark.parametrize("key", ["embedding", "unembedding", "pos_embedding"])
def test_tables_cross_bit_for_bit(model, key):
    """``convert.from_reference`` carries the top-level tables across with
    their bits (latent float32 and serving bf16), and the port's own
    ``prepare_serving_params`` casts the latents to the same bf16 bits."""
    lat, srv = model["latent_np"][key], model["serving_np"][key]
    assert str(srv.dtype) == "bfloat16"
    got_lat, got_srv = model["latent_t"][key], model["serving_t"][key]
    assert got_lat.dtype == torch.float32 and got_srv.dtype == torch.bfloat16
    np.testing.assert_array_equal(got_lat.numpy(), lat)
    np.testing.assert_array_equal(got_srv.view(torch.int16).numpy(), srv.view(np.int16))
    mine = TZ.prepare_serving_params(model["latent_t"], _cfgs(1)[1])
    assert torch.equal(mine[key].view(torch.int16), got_srv.view(torch.int16))


@pytest.mark.parametrize("site", SITES)
def test_prepare_serving_params_bit_identical(model, site):
    tcfg = _cfgs(1)[1]
    mine = TZ.prepare_serving_params(model["latent_t"], tcfg)
    for layer in range(N_LAYERS):
        got, want = _site(mine["layers"][layer], site), _site(model["serving_t"]["layers"][layer], site)
        assert set(got) == set(want) == {"w_packed", "w_scale", "w_offset", "w_colsum"}
        for key in want:
            assert got[key].dtype == want[key].dtype, key
            assert torch.equal(got[key], want[key]), f"layer {layer} {site}.{key} differs"


def _bf16_pair(x):
    xj = jnp.asarray(x, jnp.float32).astype(jnp.bfloat16)
    return xj, torch.from_numpy(np.array(xj.astype(jnp.float32))).to(torch.bfloat16)


def _eq_bf16(got, want):
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("site", SITES)
def test_qlinear_per_site_bit_identical(model, bits, site):
    jcfg, tcfg = _cfgs(bits)
    k = 128 if site == "ffn.down" else 64
    xj, xt = _bf16_pair(np.random.default_rng([7, bits, len(site)]).standard_normal((2, 5, k)) * 2)
    jp = jax.tree.map(lambda a: a[0], model["serving"]["stack"]["period"][0])
    want = JL.qlinear(_site(jp, site), xj, jcfg.quant, "serve", name=site)
    got = TL.qlinear(_site(model["serving_t"]["layers"][0], site), xt, tcfg.quant, name=site)
    _eq_bf16(got, want)


@pytest.mark.parametrize("bits", BITS)
def test_gelu_ffn_bit_identical(model, bits):
    """up -> bf16 gelu -> down: ``ffn.down`` sees exactly the reference's
    activations."""
    jcfg, tcfg = _cfgs(bits)
    xj, xt = _bf16_pair(np.random.default_rng([8, bits]).standard_normal((2, 9, 64)) * 2)
    jp = jax.tree.map(lambda a: a[1], model["serving"]["stack"]["period"][0])
    want = JL.ffn(jp["ffn"], xj, "gelu", jcfg.quant, "serve")
    got = TL.ffn(model["serving_t"]["layers"][1]["ffn"], xt, "gelu", tcfg.quant)
    _eq_bf16(got, want)


def test_gelu_equals_reference_on_every_bf16():
    """All 65,536 bf16 inputs through the port's gelu and ``jax.nn.gelu``
    (compiled on the CPU).  Equal except where the result is subnormal
    (``|x| < 2.4e-38``), which XLA flushes to zero."""
    bits = np.arange(2**16, dtype=np.uint16)
    xb = bits.view(jnp.bfloat16)
    xf = xb.astype(np.float32)
    keep = np.isfinite(xf)
    want = np.asarray(jax.jit(jax.nn.gelu)(jnp.asarray(xb[keep]))).astype(np.float32)
    xt = torch.from_numpy(bits[keep].view(np.int16).copy()).view(torch.bfloat16)
    got = TL._act("gelu", xt).float().numpy()
    same = (got == want) | (np.isnan(got) & np.isnan(want))
    normal = np.abs(xf[keep]) >= 2.4e-38
    assert same[normal].all(), f"{int((~same[normal]).sum())} bf16 inputs differ"


PROMPT = np.random.default_rng(0).integers(0, 256, size=(1, 10)).astype(np.int32)
N_DECODE = 3


def _snapshot(cache):
    return [{k: v.clone() for k, v in layer.items()} for layer in cache["layers"]]


@pytest.fixture(scope="module")
def op_by_op(model):
    """A prefill and N_DECODE greedy decode steps through the reference run
    op by op (its ``mxu`` backend: the integer backends agree exactly, and
    op by op the interpret-mode Pallas kernels would only cost time), and the
    same through the port's ``pallas`` path, each following its own greedy
    tokens; at every precision."""
    runs = {}
    for bits in BITS:
        jcfg = _cfgs(bits, "mxu")[0]
        tcfg = _cfgs(bits)[1]
        j_logits, j_caches, j_toks = [], [], []
        with jax.disable_jit():
            c = JZ.init_cache(1, 32, jcfg)
            jl, c = JZ.prefill(model["serving"], jnp.asarray(PROMPT), jcfg, c)
            for step in range(N_DECODE + 1):
                j_logits.append(np.asarray(jl)[0])
                j_caches.append(jax.tree.map(np.asarray, c["stack"]["period"][0]))
                j_toks.append(int(np.argmax(j_logits[-1])))
                if step < N_DECODE:
                    jl, c = JZ.decode_step(model["serving"], jnp.asarray([j_toks[-1]], jnp.int32), jcfg, c)
        t_logits, t_caches, t_toks = [], [], []
        tc = TZ.init_cache(1, 32, tcfg, device="cpu")
        tl, tc = TZ.prefill(model["serving_t"], torch.from_numpy(PROMPT.astype(np.int64)), tcfg, tc)
        for step in range(N_DECODE + 1):
            t_logits.append(tl.numpy()[0])
            t_caches.append(_snapshot(tc))
            t_toks.append(int(np.argmax(t_logits[-1])))
            if step < N_DECODE:
                tl, tc = TZ.decode_step(model["serving_t"], torch.tensor([t_toks[-1]]), tcfg, tc)
        runs[bits] = dict(j=(j_logits, j_caches, j_toks), t=(t_logits, t_caches, t_toks))
    return runs


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("step", [0, N_DECODE], ids=["prefill", "decode"])
def test_kv_cache_bit_identical(op_by_op, bits, step):
    jc, tc = op_by_op[bits]["j"][1][step], op_by_op[bits]["t"][1][step]
    for layer in range(N_LAYERS):
        for key in CACHE_KEYS:
            want, got = jc[key][layer], tc[layer][key].numpy()  # reference leaves carry the layer axis
            assert got.dtype == want.dtype, key
            bad = np.argwhere(got != want)
            assert bad.size == 0, f"step {step}, layer {layer}: cache[{key!r}] differs at {bad[:5].tolist()}"


@pytest.mark.parametrize("bits", BITS)
def test_logits_and_greedy_tokens_match_op_by_op_reference(op_by_op, bits):
    run = op_by_op[bits]
    assert run["t"][2] == run["j"][2], "greedy tokens diverge from the op-by-op reference"
    for want, got in zip(run["j"][0], run["t"][0]):
        np.testing.assert_allclose(got, want, rtol=0, atol=OPBYOP_ATOL)


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("bits", BITS)
def test_logits_vs_compiled_reference(model, op_by_op, bits):
    """Prefill plus N_DECODE decode steps on the op-by-op greedy tokens,
    against the compiled reference at every step.  At A4 and A8: logits
    within COMPILED_TOL[bits], and the same greedy token.  At A2 and A1,
    where the compiled reference's drift is as large as the logits (module
    docstring): the first layer's K/V cache -- written through K3 at A1 --
    equals the compiled reference's, mantissas and offsets exactly, scales
    to one ulp.  The tokens there are held to the op-by-op run
    (``test_logits_and_greedy_tokens_match_op_by_op_reference``)."""
    jcfg, tcfg = _cfgs(bits)
    toks = op_by_op[bits]["j"][2]
    jc = JZ.init_cache(1, 32, jcfg)
    jl, jc = JZ.prefill(model["serving"], jnp.asarray(PROMPT), jcfg, jc)
    for step in range(N_DECODE + 1):
        if bits >= 4:
            want, got = np.asarray(jl)[0], op_by_op[bits]["t"][0][step]
            gap = np.abs(want - got).max()
            assert gap <= COMPILED_TOL[bits], f"step {step}: max |logit gap| {gap:.3g} > {COMPILED_TOL[bits]}"
            assert int(np.argmax(want)) == toks[step], f"step {step}: greedy token differs"
        else:
            want_c = jax.tree.map(np.asarray, jc["stack"]["period"][0])
            got_c = op_by_op[bits]["t"][1][step][0]
            for key in CACHE_KEYS:
                want, got = want_c[key][0], got_c[key].numpy()
                assert got.dtype == want.dtype, key
                if key.endswith("_scale"):
                    assert _ulps(got, want).max() <= 1, f"step {step}: layer 0 {key} {got} vs {want}"
                else:
                    bad = np.argwhere(got != want)
                    assert bad.size == 0, f"step {step}: layer 0 cache[{key!r}] differs at {bad[:5].tolist()}"
        if step < N_DECODE:
            jl, jc = JZ.decode_step(model["serving"], jnp.asarray([toks[step]], jnp.int32), jcfg, jc)


@pytest.mark.parametrize("bits", BITS)
def test_pallas_routes_every_qlinear(model, bits):
    """One forward of the ``pallas`` backend sends each of the 6 x N_LAYERS
    sites to K3 at W1A1 and to K1 at W1A2..A8, and nothing to the other
    kernels (counting stand-ins for the wrappers, which on the CPU run their
    plain versions)."""
    _, tcfg = _cfgs(bits)
    calls = {"popcount": 0, "binary": 0, "bitserial": 0}

    def counted(name, fn):
        def run(*args):
            calls[name] += 1
            return fn(*args)
        return run

    with mock.patch.object(TO._pq, "popcount_qmm", counted("popcount", TO._pq.popcount_qmm)), \
            mock.patch.object(TO._bq, "binary_qmm", counted("binary", TO._bq.binary_qmm)), \
            mock.patch.object(TO._bs, "bitserial_qmm", counted("bitserial", TO._bs.bitserial_qmm)):
        tc = TZ.init_cache(1, 32, tcfg, device="cpu")
        TZ.prefill(model["serving_t"], torch.from_numpy(PROMPT.astype(np.int64)), tcfg, tc)
    want = {"popcount": 0, "binary": 0, "bitserial": 0}
    want["popcount" if bits == 1 else "binary"] = 6 * N_LAYERS
    assert calls == want


def test_init_serving_params_equals_init_then_prepare():
    """Serving params built one layer at a time draw the same latents
    (tables included) as ``init_params`` and pack them as
    ``prepare_serving_params`` does."""
    tcfg = _cfgs(1)[1]
    want = TZ.prepare_serving_params(TZ.init_params(5, tcfg, device="cpu"), tcfg)
    got = TZ.init_serving_params(5, tcfg, device="cpu")
    assert set(got) == set(want) == {"embedding", "unembedding", "pos_embedding", "final_norm", "layers"}
    assert got["pos_embedding"].shape == (tcfg.max_seq, tcfg.d_model)
    for key in ("embedding", "unembedding", "pos_embedding", "final_norm"):
        assert torch.equal(got[key], want[key]), key
    for g, w in zip(got["layers"], want["layers"]):
        for site in SITES:
            for key, val in _site(w, site).items():
                assert torch.equal(_site(g, site)[key], val), f"{site}.{key}"


def test_learned_positions_refuse_max_len_past_max_seq(model):
    """Learned positions index a (max_seq, d) table: a cache longer than
    max_seq is refused before anything runs."""
    tcfg = _cfgs(1)[1]
    too_long = tcfg.max_seq + 1
    with pytest.raises(ValueError, match="max_seq"):
        ServeEngine(tcfg, model["serving_t"], max_len=too_long, device="cpu")
    with pytest.raises(ValueError, match="max_seq"):
        serve_sequential(tcfg, model["serving_t"], [], max_len=too_long, device="cpu")
    with pytest.raises(ValueError, match="max_seq"):
        TZ.init_cache(1, too_long, tcfg, device="cpu")
    TZ.init_cache(1, tcfg.max_seq, tcfg, device="cpu")


def _requests(n=4, seed=42, temperature=0.0, cls=Request):
    rng = np.random.default_rng(seed)
    return [
        cls(
            prompt=rng.integers(0, 256, size=(int(rng.integers(3, 11)),)).astype(np.int32),
            max_new_tokens=int(rng.integers(3, 7)),
            temperature=temperature,
        )
        for _ in range(n)
    ]


@pytest.mark.parametrize("temperature", [0.0, 1.1])
def test_engine_matches_sequential_oracle_w1a1(model, temperature):
    _, tcfg = _cfgs(1)
    want = serve_sequential(tcfg, model["serving_t"], _requests(temperature=temperature),
                            max_len=MAX_LEN, seed=0, device="cpu")
    engine = ServeEngine(tcfg, model["serving_t"], batch_slots=2, max_len=MAX_LEN, seed=0, device="cpu")
    got = engine.run(_requests(temperature=temperature))
    for g, w in zip(got, want):
        assert g.state == "ok"
        assert g.output == w.output, f"prompt_len={len(g.prompt)}: {g.output} != {w.output}"


def test_engine_greedy_equals_reference_engine(model):
    """The port's engine against the JAX engine, compiled, at A8.  Below A8
    the compiled engine's own drift (module docstring) changes tokens: at A4
    it changes the second request's second token on these requests.  At
    W1A1 the port's engine is held to the JAX engine run op by op
    (``test_engine_greedy_equals_op_by_op_reference_engine_w1a1``)."""
    jcfg, tcfg = _cfgs(8)
    want = JS.ServeEngine(jcfg, model["serving"], batch_slots=2, max_len=MAX_LEN, seed=0).run(
        _requests(cls=JS.Request))
    got = ServeEngine(tcfg, model["serving_t"], batch_slots=2, max_len=MAX_LEN, seed=0,
                      device="cpu").run(_requests())
    assert [r.output for r in got] == [r.output for r in want]


def test_engine_greedy_equals_op_by_op_reference_engine_w1a1(model):
    """W1A1, the paper's model and K3's path: the port's engine against the
    JAX engine run op by op (``jax.disable_jit``, integer ``mxu`` backend),
    token for token.  Two requests of three new tokens: op by op the JAX
    engine compiles each primitive at each new shape, about a minute."""
    jcfg, tcfg = _cfgs(1, "mxu")[0], _cfgs(1)[1]

    def requests(cls):
        reqs = _requests(n=2, cls=cls)
        for r in reqs:
            r.max_new_tokens = 3
        return reqs

    with jax.disable_jit():
        want = JS.ServeEngine(jcfg, model["serving"], batch_slots=2, max_len=MAX_LEN, seed=0).run(
            requests(JS.Request))
    got = ServeEngine(tcfg, model["serving_t"], batch_slots=2, max_len=MAX_LEN, seed=0,
                      device="cpu").run(requests(Request))
    assert all(r.state == "ok" for r in got)
    assert [r.output for r in got] == [r.output for r in want]
