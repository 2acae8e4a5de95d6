"""internvl2-2b -- a dense GQA decoder with a patch stub: projected patch
embeddings replace the first positions of the prompt -- through the port
against the JAX reference, on the reference's own params of the smoke
variant (one layer, 12 patches of 24).

What must agree, and how:

* every config field, full and smoke, ``encoder`` included;
* ``prepare_serving_params`` on the converted latents: bit for bit, the
  stub projection kept float32, no encoder stack and no cross-attention;
* the stub projection, run in bf16 (the frontend is cast to the
  embedding's dtype): bit for bit;
* every cache leaf after a prefill with patches and after each greedy
  decode step, against the reference run op by op (``jax.disable_jit``),
  bit for bit; logits to ``LOGIT_ATOL``; greedy tokens identical;
* a prompt shorter than its patches returns no result: the reference
  fails inside rope, the port raises a ``ValueError`` naming both lengths;
* ``ServeEngine`` serves the model text only, token for token as
  ``serve_sequential``; ``make_prefill`` takes the patches and checks them.
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
from repro_torch import convert
from repro_torch.configs import get_config as tget
from repro_torch.configs.smoke import smoke_variant as tsmoke
from repro_torch.models import layers as TL
from repro_torch.models import model_zoo as TZ
from repro_torch.runtime.serve_loop import Request, ServeEngine, make_prefill, serve_sequential
from test_torch_graph import _host_tensors_made, _prompt
from torch_port_fixtures import release_jax_caches  # noqa: F401  (autouse)

NAME = "internvl2-2b"
LOGIT_ATOL = 1e-6  # tests/test_torch_dense_families.py
PLEN, N_DECODE, MAX_LEN = 20, 5, 32  # 12 patches, then 8 text tokens


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


def _patches(seed: int, cfg, batch: int = 1) -> np.ndarray:
    enc = cfg.encoder
    shape = (batch, enc.n_positions, enc.d_input)
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _fields_equal(got, want, path=""):
    for field in dataclasses.fields(got):
        g, w = getattr(got, field.name), getattr(want, field.name)
        if dataclasses.is_dataclass(g):
            _fields_equal(g, w, f"{path}{field.name}.")
        else:
            assert g == w, f"{path}{field.name}"


@pytest.mark.parametrize("size", ["full", "smoke"])
def test_config_fields_equal_reference(size):
    j, t = jget(NAME), tget(NAME)
    if size == "smoke":
        j, t = jsmoke(j), tsmoke(t)
        assert (t.encoder.n_positions, t.encoder.n_layers, t.encoder.d_input) == (12, 0, 24)
    _fields_equal(t, j)
    assert t.layer_kinds == j.layer_kinds
    assert dataclasses.asdict(t.encoder) == dataclasses.asdict(j.encoder)


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
    assert set(mine["encoder"]) == {"stub_proj"}
    w = mine["encoder"]["stub_proj"]["w"]
    assert w.dtype == torch.float32 and w.shape == (24, tcfg.d_model)
    assert "unembedding" in mine and not any("cross_attn" in layer for layer in mine["layers"])
    _walk_equal(TZ.init_serving_params(3, tcfg, device="cpu"),
                TZ.prepare_serving_params(TZ.init_params(3, tcfg, device="cpu"), tcfg), "params")


def test_stub_projection_bf16_bit_identical(model):
    fr = _patches(1, model["tcfg"], batch=2)
    w = model["serving"]["encoder"]["stub_proj"]["w"]
    with jax.disable_jit():
        x = jnp.asarray(fr).astype(jnp.bfloat16)
        want = np.asarray(jnp.einsum("...k,kn->...n", x, w.astype(x.dtype)))
    got = TL.float_linear(model["serving_t"]["encoder"]["stub_proj"], torch.from_numpy(fr).bfloat16())
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.view(torch.int16).numpy(), want.view(np.int16))


def _ref_layers(cache, jcfg):
    stack = cache["stack"]
    out = [jax.tree.map(np.asarray, c) for c in stack["prefix"]]
    for i in range(jcfg.n_periods):
        out += [{k: np.asarray(v)[i] for k, v in c.items()} for c in stack["period"]]
    return out


@pytest.fixture(scope="module")
def op_by_op(model):
    """A prefill with patches and greedy decode steps through the reference
    run op by op (``mxu``: its backends agree exactly) and the port's
    ``pallas`` path, each fed the reference's greedy token."""
    jcfg, tcfg = _backend(model["jcfg"], "mxu"), model["tcfg"]
    prompt = np.random.default_rng(5).integers(0, 256, size=(1, PLEN)).astype(np.int32)
    fr = _patches(6, tcfg)
    steps = []
    with jax.disable_jit():
        jl, jc = JZ.prefill(model["serving"], jnp.asarray(prompt), jcfg, JZ.init_cache(1, MAX_LEN, jcfg),
                            jnp.asarray(fr))
        tl, tc = TZ.prefill(model["serving_t"], torch.from_numpy(prompt.astype(np.int64)), tcfg,
                            TZ.init_cache(1, MAX_LEN, tcfg, device="cpu"), torch.from_numpy(fr))
        snap = lambda c: [{k: v.numpy().copy() for k, v in layer.items()} for layer in c["layers"]]  # noqa: E731
        steps.append(("prefill", np.asarray(jl), tl.numpy(), _ref_layers(jc, jcfg), snap(tc), set(tc)))
        for i in range(N_DECODE):
            tok = int(np.argmax(np.asarray(jl)))
            jl, jc = JZ.decode_step(model["serving"], jnp.asarray([tok], jnp.int32), jcfg, jc)
            tl, tc = TZ.decode_step(model["serving_t"], torch.tensor([tok]), tcfg, tc)
            steps.append((f"decode {i}", np.asarray(jl), tl.numpy(), _ref_layers(jc, jcfg), snap(tc), set(tc)))
    # the patches changed the answer: a text-only prefill of the same tokens differs
    text, _ = TZ.prefill(model["serving_t"], torch.from_numpy(prompt.astype(np.int64)), tcfg,
                         TZ.init_cache(1, MAX_LEN, tcfg, device="cpu"))
    return dict(tcfg=tcfg, steps=steps, text=text.numpy())


def test_every_cache_leaf_matches_op_by_op_reference(op_by_op):
    for when, _, _, jlayers, tlayers, top in op_by_op["steps"]:
        assert top == {"layers"}, f"{when}: a patch stub keeps no encoder_out"
        assert len(jlayers) == len(tlayers) == op_by_op["tcfg"].n_layers
        for i, (jc, tc) in enumerate(zip(jlayers, tlayers)):
            assert set(jc) == set(tc), f"{when}: layer {i} leaves"
            for key in jc:
                where = f"{when}: layer {i} cache[{key!r}]"
                assert tc[key].dtype == jc[key].dtype and np.array_equal(tc[key], jc[key]), where


def test_logits_and_greedy_tokens_match_op_by_op_reference(op_by_op):
    for when, want, got, _, _, _ in op_by_op["steps"]:
        np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL, err_msg=when)
        assert int(np.argmax(got)) == int(np.argmax(want)), when
    assert np.abs(op_by_op["steps"][0][2] - op_by_op["text"]).max() > 1e-3


def test_prompt_shorter_than_its_patches_is_refused(model):
    """8 tokens under 12 patches: the reference fails (a broadcast inside
    rope), the port refuses before any work, naming both lengths."""
    jcfg, tcfg = model["jcfg"], model["tcfg"]
    prompt = np.arange(8, dtype=np.int32)[None]
    fr = _patches(7, tcfg)
    with pytest.raises(Exception):
        with jax.disable_jit():
            JZ.prefill(model["serving"], jnp.asarray(prompt), jcfg, JZ.init_cache(1, MAX_LEN, jcfg),
                       jnp.asarray(fr))
    cache = TZ.init_cache(1, MAX_LEN, tcfg, device="cpu")
    with pytest.raises(ValueError, match="8 tokens .* 12 patch"):
        TZ.prefill(model["serving_t"], torch.from_numpy(prompt.astype(np.int64)), tcfg, cache,
                   torch.from_numpy(fr))
    assert not any(int(layer["pos"][0]) for layer in cache["layers"])


def test_engine_serves_text_only_as_serve_sequential(model):
    tcfg, params = model["tcfg"], model["serving_t"]

    def requests():
        rng = np.random.default_rng(4)
        return [Request(prompt=rng.integers(0, 256, size=(int(n),)).astype(np.int64), max_new_tokens=int(k))
                for n, k in ((13, 5), (1, 4), (20, 3), (5, 6), (9, 2))]

    want = serve_sequential(tcfg, params, requests(), max_len=MAX_LEN, seed=0, device="cpu")
    got = ServeEngine(tcfg, params, batch_slots=2, max_len=MAX_LEN, seed=0, device="cpu").run(requests())
    assert [r.output for r in got] == [r.output for r in want]
    assert all(r.state == "ok" for r in got)


def test_compiled_prefill_takes_and_checks_the_patches(model):
    """``make_prefill``: ``fn(params, tokens, cache, frontend)`` equals the
    eager prefill with the same patches (the CPU runs it eagerly); patches
    of another shape, or none, are refused."""
    tcfg, params = model["tcfg"], model["serving_t"]
    fn = make_prefill(tcfg, 1, PLEN, MAX_LEN, device="cpu")
    assert fn.frontend_shape == (1, 12, 24)
    tokens = torch.from_numpy(np.random.default_rng(8).integers(0, 256, size=(1, PLEN)))
    fr = torch.from_numpy(_patches(9, tcfg))
    cache = TZ.init_cache(1, MAX_LEN, tcfg, device="cpu")
    got, out = fn(params, tokens, cache, fr)
    want, want_cache = TZ.prefill(params, tokens, tcfg, TZ.init_cache(1, MAX_LEN, tcfg, device="cpu"), fr)
    assert out is cache and torch.equal(got, want) and TZ.caches_equal(cache, want_cache)
    with pytest.raises(ValueError, match="frontend of shape"):
        fn(params, tokens, cache, fr[:, :6])
    with pytest.raises(ValueError, match="takes a frontend"):
        fn(params, tokens, cache)


def test_step_glue_makes_no_tensor_from_host_data(model):
    """The patch projection and splice in a prefill, and a decode step after
    it, make no tensor from host data after the warm-up call (a capture
    would refuse one)."""
    tcfg, params = model["tcfg"], model["serving_t"]
    tokens = torch.from_numpy(_prompt(7, PLEN).astype(np.int64))
    frontend = torch.from_numpy(_patches(12, tcfg))
    cache = TZ.init_cache(1, MAX_LEN, tcfg, device="cpu")
    TZ.prefill(params, tokens, tcfg, cache, frontend)
    step = torch.tensor([1])
    assert _host_tensors_made(lambda: TZ.decode_step(params, step, tcfg, cache)) == []
    assert _host_tensors_made(lambda: TZ.prefill(
        params, tokens, tcfg, TZ.init_cache(1, MAX_LEN, tcfg, device="cpu"), frontend)) == []
