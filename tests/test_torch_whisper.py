"""whisper-tiny -- the encoder over stub frame embeddings and the decoder's
cross-attention onto its output -- through the port against the JAX
reference, on the reference's own params of the smoke variant (2 encoder
layers over 12 frames, one decoder layer).

What must agree, and how:

* every config field, full and smoke, ``encoder`` included;
* ``prepare_serving_params`` on the converted latents: bit for bit, the
  stub projection kept float32, ``cross_attn`` packed, the encoder's
  layers unstacked from the reference's scan;
* the float32 stub projection and, over 1,500 rows at the smoke's head
  width, the stateless encoder attention and the float cross-attention:
  bit for bit;
* ``_sinusoidal``: XLA's CPU ``exp`` and ``sin`` / ``cos`` are not
  PyTorch's, and an ulp in a frequency moves an angle by an ulp of the
  angle, so it is held to ``SIN_ULPS`` float32 ulps of the largest angle;
* ``_run_encoder``'s float32 output: XLA's float32 ``tanh`` (the gelu)
  differs from PyTorch's in most elements by an ulp or so, so it is held
  to ``ENCODER_RTOL`` of its largest magnitude; its bf16 cast, the
  ``encoder_out`` cache leaf, bit for bit;
* every cache leaf after a prefill with a frontend and after each greedy
  decode step, against the reference run op by op (``jax.disable_jit``),
  bit for bit; logits to ``LOGIT_ATOL``; greedy tokens identical; the same
  for a prefill without a frontend (``encoder_out`` stays zero, and every
  decode step still cross-attends to it, as the reference's
  ``serve_sequential`` does);
* ``ServeEngine`` refuses the model; ``make_prefill`` takes the frontend
  and checks it; ``cache_insert`` / ``cache_reset`` carry ``encoder_out``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs.smoke import smoke_variant as jsmoke
from repro.models import attention as JA
from repro.models import model_zoo as JZ
from repro_torch import convert
from repro_torch.configs import get_config as tget
from repro_torch.configs.smoke import smoke_variant as tsmoke
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import model_zoo as TZ
from repro_torch.runtime.serve_loop import ServeEngine, make_decode_step, make_prefill
from test_torch_graph import _host_tensors_made, _prompt
from torch_port_fixtures import release_jax_caches  # noqa: F401  (autouse)

# frees JAX's executables after every module on each worker (see there)
pytest_plugins = ["jax_map_guard"]

NAME = "whisper-tiny"
SIN_ULPS = 2  # float32 ulps of the largest angle (t - 1 rad)
ENCODER_RTOL = 1e-6  # of the largest |encoder output|
LOGIT_ATOL = 1e-6  # tests/test_torch_dense_families.py
FRAMES = 1500  # the full model's encoder rows
PLEN, N_DECODE, MAX_LEN = 4, 5, 32  # Whisper's start-of-transcript sequence is 4 tokens


@pytest.fixture(autouse=True)
def flush_denormals():
    """XLA's CPU flushes subnormal float32 results to zero; so does PyTorch
    here, for the length of each test."""
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def _backend(cfg, backend):
    return dataclasses.replace(cfg, quant=dataclasses.replace(cfg.quant, backend=backend))


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = jsmoke(jget(NAME)), _backend(tsmoke(tget(NAME)), "pallas")
    params = JZ.init_params(jax.random.PRNGKey(0), jcfg)
    serving = JZ.prepare_serving_params(params, jcfg)
    return dict(
        jcfg=jcfg, tcfg=tcfg, serving=serving,
        latent_t=convert.from_reference(jax.tree.map(np.asarray, params), tcfg, device="cpu"),
        serving_t=convert.from_reference(jax.tree.map(np.asarray, serving), tcfg, device="cpu"),
    )


def _frames(seed: int, cfg, batch: int = 1) -> np.ndarray:
    enc = cfg.encoder
    shape = (batch, enc.n_positions, enc.d_input or cfg.d_model)
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _fields_equal(got, want, path=""):
    for field in dataclasses.fields(got):
        g, w = getattr(got, field.name), getattr(want, field.name)
        if dataclasses.is_dataclass(g):
            _fields_equal(g, w, f"{path}{field.name}.")
        else:
            assert g == w, f"{path}{field.name}"


def test_config_fields_equal_reference():
    """The full config and the smoke variant, each with its encoder's own
    config (``_encoder_cfg``)."""
    for j, t in ((jget(NAME), tget(NAME)), (jsmoke(jget(NAME)), tsmoke(tget(NAME)))):
        _fields_equal(t, j)
        assert t.layer_kinds == j.layer_kinds
        assert dataclasses.asdict(t.encoder) == dataclasses.asdict(j.encoder)
        enc_t, enc_j = TZ._encoder_cfg(t), JZ._encoder_cfg(j)
        _fields_equal(enc_t, enc_j)
        assert (enc_t.causal, enc_t.pos_embedding, enc_t.encoder) == (False, "sinusoidal", None)
    assert (t.encoder.n_positions, t.encoder.n_layers, t.encoder.d_input) == (12, 2, 0)


def _walk_equal(got, want, path):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _walk_equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _walk_equal(g, w, f"{path}[{i}]")
    else:
        assert got.dtype == want.dtype and torch.equal(got, want), path


def test_prepare_serving_params_bit_identical(model):
    tcfg = model["tcfg"]
    mine = TZ.prepare_serving_params(model["latent_t"], tcfg)
    _walk_equal(mine, model["serving_t"], "params")
    enc = mine["encoder"]
    assert set(enc["stub_proj"]) == {"w"} and enc["stub_proj"]["w"].dtype == torch.float32
    assert enc["stub_proj"]["w"].shape == (tcfg.d_model, tcfg.d_model)
    assert len(enc["layers"]) == tcfg.encoder.n_layers and "cross_attn" not in enc["layers"][0]
    for layer in mine["layers"]:
        assert set(layer["cross_attn"]) == {"q", "k", "v", "o"}
        assert all("w_packed" in site for site in layer["cross_attn"].values())
        assert layer["ln_cross"].dtype == torch.float32
    # drawn and packed a layer at a time, or all drawn then packed: the same
    _walk_equal(TZ.init_serving_params(3, tcfg, device="cpu"),
                TZ.prepare_serving_params(TZ.init_params(3, tcfg, device="cpu"), tcfg), "params")


def test_sinusoidal_within_ulps_of_reference():
    for d, t in ((64, 12), (384, FRAMES)):  # the smoke's and the full model's
        pos = np.broadcast_to(np.arange(t), (2, t)).astype(np.int32)
        with jax.disable_jit():
            want = np.asarray(JZ._sinusoidal(jnp.asarray(pos), d))
        got = TZ._sinusoidal(torch.from_numpy(pos.astype(np.int64)), d).numpy()
        assert got.dtype == want.dtype == np.float32 and got.shape == want.shape == (2, t, d)
        assert np.abs(got - want).max() <= SIN_ULPS * np.spacing(np.float32(t - 1)), (d, t)


def test_stateless_encoder_attention_over_1500_rows(model):
    """The encoder's self-attention without a cache: the integer path over
    every frame's keys and values, non-causal, at the full model's 1,500
    rows; float32 in and out."""
    jcfg, tcfg = model["jcfg"], model["tcfg"]
    jp = jax.tree.map(lambda a: a[0], model["serving"]["encoder"]["stack"]["period"][0])["attn"]
    tp = model["serving_t"]["encoder"]["layers"][0]["attn"]
    x = np.random.default_rng(2).standard_normal((2, FRAMES, tcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(FRAMES), (2, FRAMES)).astype(np.int32)
    with jax.disable_jit():
        want, _ = JA.attention(jp, jnp.asarray(x), JZ._encoder_cfg(jcfg), "g", "serve", jnp.asarray(pos))
    got, cache = TA.attention(tp, torch.from_numpy(x), TZ._encoder_cfg(tcfg), "g",
                              torch.from_numpy(pos.astype(np.int64)), None)
    assert cache is None and got.dtype == torch.float32
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_cross_attention_over_1500_rows(model):
    """Cross-attention from the decoder's bf16 stream onto 1,500 encoder
    rows: float32 scores, softmax, bf16 P.V; the prefill projects keys and
    values from the float32 encoder output, a decode step from the cache's
    bf16 copy."""
    for kv_dtype in ("float32", "bfloat16"):
        _cross_attention_over_1500_rows(model, kv_dtype)


def _cross_attention_over_1500_rows(model, kv_dtype):
    jcfg, tcfg = model["jcfg"], model["tcfg"]
    jp = jax.tree.map(lambda a: a[0], model["serving"]["stack"]["period"][0])["cross_attn"]
    tp = model["serving_t"]["layers"][0]["cross_attn"]
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 3, tcfg.d_model)).astype(np.float32)
    kv = [rng.standard_normal((2, FRAMES, tcfg.n_kv_heads, tcfg.d_head)).astype(np.float32) for _ in range(2)]
    pos = np.zeros((2, 3), np.int32)
    jdt, tdt = getattr(jnp, kv_dtype), getattr(torch, kv_dtype)
    with jax.disable_jit():
        want, _ = JA.attention(jp, jnp.asarray(x).astype(jnp.bfloat16), jcfg, "g", "serve", jnp.asarray(pos),
                               kv_override=tuple(jnp.asarray(a).astype(jdt) for a in kv), causal=False)
    got, cache = TA.attention(tp, torch.from_numpy(x).bfloat16(), tcfg, "g", torch.from_numpy(pos), None,
                              kv_override=tuple(torch.from_numpy(a).to(tdt) for a in kv), causal=False)
    assert cache is None and got.dtype == torch.bfloat16
    assert np.array_equal(got.view(torch.int16).numpy(), np.asarray(want).view(np.int16)), kv_dtype


def test_run_encoder_matches_reference(model):
    """The float32 stub projection bit for bit; the encoder's output to
    ENCODER_RTOL, its bf16 cast bit for bit."""
    jcfg, tcfg = model["jcfg"], model["tcfg"]
    fr = _frames(4, tcfg, batch=2)
    w = model["serving"]["encoder"]["stub_proj"]["w"]
    with jax.disable_jit():
        proj = np.asarray(jnp.einsum("...k,kn->...n", jnp.asarray(fr), w.astype(jnp.float32)))
    got = TL.float_linear(model["serving_t"]["encoder"]["stub_proj"], torch.from_numpy(fr))
    assert got.dtype == torch.float32 and np.array_equal(got.numpy(), proj)
    with jax.disable_jit():
        want = np.asarray(JZ._run_encoder(model["serving"], jnp.asarray(fr), jcfg, "serve"))
    got = TZ._run_encoder(model["serving_t"], torch.from_numpy(fr), tcfg)
    assert got.dtype == torch.float32 and got.shape == want.shape == (2, 12, tcfg.d_model)
    assert np.abs(got.numpy() - want).max() <= ENCODER_RTOL * np.abs(want).max()
    want16 = np.asarray(jnp.asarray(want).astype(jnp.bfloat16)).view(np.int16)
    assert np.array_equal(got.to(torch.bfloat16).view(torch.int16).numpy(), want16)


def _ref_cache(cache, jcfg):
    stack = cache["stack"]
    layers = [jax.tree.map(np.asarray, c) for c in stack["prefix"]]
    for i in range(jcfg.n_periods):
        layers += [{k: np.asarray(v)[i] for k, v in c.items()} for c in stack["period"]]
    return layers, np.asarray(cache["encoder_out"])


def _snapshot(cache):
    return [{k: v.numpy().copy() for k, v in layer.items()} for layer in cache["layers"]], \
        cache["encoder_out"].clone()


@pytest.fixture(scope="module", params=["frontend", "no frontend"])
def op_by_op(request, model):
    """A prefill (with stub frames, or without) and greedy decode steps
    through the reference run op by op (``mxu``: its backends agree
    exactly) and the port's ``pallas`` path, each fed the reference's
    greedy token; every cache leaf after each step."""
    jcfg, tcfg = _backend(model["jcfg"], "mxu"), model["tcfg"]
    prompt = np.random.default_rng(5).integers(0, 256, size=(1, PLEN)).astype(np.int32)
    fr = _frames(6, tcfg) if request.param == "frontend" else None
    steps = []
    with jax.disable_jit():
        jl, jc = JZ.prefill(model["serving"], jnp.asarray(prompt), jcfg, JZ.init_cache(1, MAX_LEN, jcfg),
                            None if fr is None else jnp.asarray(fr))
        tl, tc = TZ.prefill(model["serving_t"], torch.from_numpy(prompt.astype(np.int64)), tcfg,
                            TZ.init_cache(1, MAX_LEN, tcfg, device="cpu"),
                            None if fr is None else torch.from_numpy(fr))
        steps.append(("prefill", np.asarray(jl), tl.numpy(), _ref_cache(jc, jcfg), _snapshot(tc)))
        for i in range(N_DECODE):
            tok = int(np.argmax(np.asarray(jl)))
            jl, jc = JZ.decode_step(model["serving"], jnp.asarray([tok], jnp.int32), jcfg, jc)
            tl, tc = TZ.decode_step(model["serving_t"], torch.tensor([tok]), tcfg, tc)
            steps.append((f"decode {i}", np.asarray(jl), tl.numpy(), _ref_cache(jc, jcfg), _snapshot(tc)))
    return dict(frontend=fr is not None, tcfg=tcfg, steps=steps)


def test_cache_leaves_logits_and_tokens_match_op_by_op_reference(op_by_op):
    tcfg = op_by_op["tcfg"]
    for when, jl, tl, (jlayers, jenc), (tlayers, tenc) in op_by_op["steps"]:
        np.testing.assert_allclose(tl, jl, rtol=0, atol=LOGIT_ATOL, err_msg=when)
        assert int(np.argmax(tl)) == int(np.argmax(jl)), when
        assert len(jlayers) == len(tlayers) == tcfg.n_layers
        for i, (jc, tc) in enumerate(zip(jlayers, tlayers)):
            assert set(jc) == set(tc), f"{when}: layer {i} leaves"
            for key in jc:
                where = f"{when}: layer {i} cache[{key!r}]"
                assert tc[key].dtype == jc[key].dtype and np.array_equal(tc[key], jc[key]), where
        assert tenc.dtype == torch.bfloat16 and tenc.shape == jenc.shape == (1, 12, tcfg.d_model)
        assert np.array_equal(tenc.view(torch.int16).numpy(), jenc.view(np.int16)), f"{when}: encoder_out"
        assert bool(tenc.any()) == op_by_op["frontend"], f"{when}: encoder_out zero without a frontend"


def test_engine_refuses_an_encoder_stack(model):
    with pytest.raises(NotImplementedError, match="make_prefill"):
        ServeEngine(model["tcfg"], model["serving_t"], batch_slots=2, max_len=MAX_LEN, device="cpu")


def test_compiled_prefill_takes_and_checks_the_frontend(model):
    """``make_prefill`` of a model with a frontend: ``fn(params, tokens,
    cache, frontend)`` equals the eager prefill (the CPU runs it eagerly);
    a frontend of another shape, or none, is refused."""
    tcfg, params = model["tcfg"], model["serving_t"]
    fn = make_prefill(tcfg, 2, PLEN, MAX_LEN, device="cpu")
    assert fn.frontend_shape == (2, 12, tcfg.d_model)
    tokens = torch.from_numpy(np.random.default_rng(7).integers(0, 256, size=(2, PLEN)))
    fr = torch.from_numpy(_frames(8, tcfg, batch=2))
    cache = TZ.init_cache(2, MAX_LEN, tcfg, device="cpu")
    got, out = fn(params, tokens, cache, fr)
    want, want_cache = TZ.prefill(params, tokens, tcfg, TZ.init_cache(2, MAX_LEN, tcfg, device="cpu"), fr)
    assert out is cache and torch.equal(got, want) and TZ.caches_equal(cache, want_cache)
    with pytest.raises(ValueError, match="frontend of shape"):
        fn(params, tokens, cache, fr[:, :6])
    with pytest.raises(ValueError, match="takes a frontend"):
        fn(params, tokens, cache)
    with pytest.raises(ValueError, match="takes"):
        TZ.prefill(params, tokens, tcfg, cache, fr[:1])


def test_decode_step_checks_encoder_out_geometry(model):
    """A decode step's geometry includes ``encoder_out``: a cache whose
    encoder rows differ is refused."""
    tcfg, params = model["tcfg"], model["serving_t"]
    step = make_decode_step(tcfg, 2, MAX_LEN, device="cpu")
    cache = TZ.init_cache(2, MAX_LEN, tcfg, device="cpu")
    assert TZ.cache_rows(MAX_LEN, tcfg) == [MAX_LEN] * tcfg.n_layers + [12]
    assert TZ.cache_geometry(cache) == [(2, MAX_LEN)] * tcfg.n_layers + [(2, 12)]
    logits, _ = step(params, torch.zeros(2, dtype=torch.int64), cache)
    assert logits.shape == (2, tcfg.vocab_size)
    cache["encoder_out"] = cache["encoder_out"][:, :6]
    with pytest.raises(ValueError, match="max_len"):
        step(params, torch.zeros(2, dtype=torch.int64), cache)


def test_cache_insert_and_reset_carry_encoder_out(model):
    tcfg, params = model["tcfg"], model["serving_t"]
    cache = TZ.init_cache(2, MAX_LEN, tcfg, device="cpu")
    for row, seed in enumerate((9, 10)):
        slot = TZ.init_slot_cache(MAX_LEN, tcfg, device="cpu")
        TZ.prefill(params, torch.arange(PLEN)[None] + row, tcfg, slot, torch.from_numpy(_frames(seed, tcfg)))
        TZ.cache_insert(cache, slot, row)
        assert torch.equal(cache["encoder_out"][row], slot["encoder_out"][0])
        assert bool(slot["encoder_out"].any())
    other = TZ.cache_copy(cache)
    assert TZ.caches_equal(cache, other) and other["encoder_out"] is not cache["encoder_out"]
    TZ.cache_reset(cache, 0, tcfg, MAX_LEN)
    assert not cache["encoder_out"][0].any()
    assert torch.equal(cache["encoder_out"][1], other["encoder_out"][1])
    assert not TZ.caches_equal(cache, other)


def test_step_glue_makes_no_tensor_from_host_data(model):
    """The encoder -- the stub projection, the sinusoid, the stateless stack
    -- in a prefill, and the cross-attention onto ``encoder_out`` in a
    decode step make no tensor from host data after the warm-up call (a
    capture would refuse one)."""
    tcfg, params = model["tcfg"], model["serving_t"]
    tokens = torch.from_numpy(_prompt(7, PLEN).astype(np.int64))
    frontend = torch.from_numpy(_frames(12, tcfg))
    cache = TZ.init_cache(1, MAX_LEN, tcfg, device="cpu")
    TZ.prefill(params, tokens, tcfg, cache, frontend)
    step = torch.tensor([1])
    assert _host_tensors_made(lambda: TZ.decode_step(params, step, tcfg, cache)) == []
    assert _host_tensors_made(lambda: TZ.prefill(
        params, tokens, tcfg, TZ.init_cache(1, MAX_LEN, tcfg, device="cpu"), frontend)) == []
