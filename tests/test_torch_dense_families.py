"""The dense GQA families beside granite-8b -- mistral-nemo-12b, qwen3-32b
(qk-norm) and gemma3-27b (qk-norm, a second rope theta, and sliding-window
``"l"`` layers whose cache is a ring buffer) -- through the port against
the JAX reference, on the reference's own params of each smoke variant.

What must agree, and how (as in ``tests/test_torch_model.py``):

* every config field of the port equals the reference's, full and smoke;
* ``prepare_serving_params`` on the converted latents: bit for bit,
  ``q_norm`` / ``k_norm`` included (kept float32, unpacked);
* every KV-cache leaf of every layer after the prefill and after each
  decode step: bit for bit against the reference run op by op
  (``jax.disable_jit``), logits to ``OPBYOP_ATOL``;
* greedy tokens over a prefill and 12 decode steps: identical to the
  compiled reference's, logits within ``TOL``.

gemma3's smoke window is 8.  Here its prompt is longer than the window
(the prefill fills the ring and keeps the last 8 tokens, position ``p`` in
row ``p % 8``) and its decode crosses a multiple of the window;
``tests/test_torch_gemma3_window.py`` holds its other window cases (a
prompt shorter than and equal to the window, the clipped local layer) and
its greedy run against the compiled reference, so that the two files'
reference compilations run side by side under ``--dist loadfile``.
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
from repro_torch.models import model_zoo as TZ
from torch_port_fixtures import release_jax_caches  # noqa: F401  (autouse)

TOL = 0.03  # tests/test_torch_model.py
OPBYOP_ATOL = 1e-6
NAMES = ["mistral-nemo-12b", "qwen3-32b", "gemma3-27b"]
W = 8  # the smoke variants' window
CACHE_KEYS = ["k", "v", "k_scale", "k_offset", "v_scale", "v_offset", "pos"]


def _backend(cfg, backend):
    return dataclasses.replace(cfg, quant=dataclasses.replace(cfg.quant, backend=backend))


@pytest.fixture(scope="module")
def models():
    """Each smoke model built once: reference serving params and their port
    copies, latent and packed."""
    built = {}

    def get(name):
        if name not in built:
            jcfg, tcfg = jsmoke(jget(name)), _backend(tsmoke(tget(name)), "pallas")
            params = JZ.init_params(jax.random.PRNGKey(0), jcfg)
            serving = JZ.prepare_serving_params(params, jcfg)
            built[name] = dict(
                jcfg=jcfg, tcfg=tcfg, serving=serving,
                latent_t=convert.from_reference(jax.tree.map(np.asarray, params), tcfg, device="cpu"),
                serving_t=convert.from_reference(jax.tree.map(np.asarray, serving), tcfg, device="cpu"),
            )
        return built[name]

    return get


@pytest.mark.parametrize("size", ["full", "smoke"])
@pytest.mark.parametrize("name", NAMES)
def test_config_fields_equal_reference(name, size):
    j, t = jget(name), tget(name)
    if size == "smoke":
        j, t = jsmoke(j), tsmoke(t)
    for field in dataclasses.fields(t):
        got, want = getattr(t, field.name), getattr(j, field.name)
        if field.name == "quant":
            for qf in dataclasses.fields(got):
                assert getattr(got, qf.name) == getattr(want, qf.name), f"quant.{qf.name}"
        else:
            assert got == want, field.name
    assert t.layer_kinds == j.layer_kinds


@pytest.mark.parametrize("name", NAMES)
def test_prepare_serving_params_bit_identical(models, name):
    """Every leaf of every layer, in the reference's layer order (gemma3:
    the ``(l, l)`` prefix, then each ``(l, l, l, l, l, g)`` period)."""
    m = models(name)
    tcfg = m["tcfg"]
    mine = TZ.prepare_serving_params(m["latent_t"], tcfg)
    want = m["serving_t"]
    assert len(mine["layers"]) == len(want["layers"]) == tcfg.n_layers
    for key in ("embedding", "final_norm"):
        assert torch.equal(mine[key], want[key]), key
    assert ("unembedding" in want) == (not tcfg.tie_embeddings)

    def walk(got, ref, path):
        if isinstance(ref, dict):
            assert set(got) == set(ref), path
            for k in ref:
                walk(got[k], ref[k], f"{path}.{k}")
        else:
            assert got.dtype == ref.dtype and torch.equal(got, ref), path

    for i, (g, w) in enumerate(zip(mine["layers"], want["layers"])):
        walk(g, w, f"layers[{i}]")
        attn = w["attn"]
        assert ("q_norm" in attn) == ("k_norm" in attn) == tcfg.qk_norm
        if tcfg.qk_norm:
            assert attn["q_norm"].dtype == torch.float32 and attn["q_norm"].shape == (tcfg.d_head,)


def _ref_layers(cache, jcfg):
    """The reference's stacked cache cut into per-layer dicts, in layer order."""
    stack = cache["stack"]
    out = [jax.tree.map(np.asarray, c) for c in stack["prefix"]]
    for i in range(jcfg.n_periods):
        out += [{k: np.asarray(v)[i] for k, v in c.items()} for c in stack["period"]]
    return out


def _snapshot(cache):
    return [{k: v.numpy().copy() for k, v in layer.items()} for layer in cache["layers"]]


def run_op_by_op(m, plen: int, n_decode: int, max_len: int) -> dict:
    """A prefill and ``n_decode`` greedy decode steps through the reference
    run op by op (its ``mxu`` backend: its backends agree exactly) and
    through the port's ``pallas`` path; every layer's cache after each
    step."""
    jcfg, tcfg, serving, serving_t = _backend(m["jcfg"], "mxu"), m["tcfg"], m["serving"], m["serving_t"]
    prompt = np.random.default_rng(plen).integers(0, 256, size=(1, plen)).astype(np.int32)
    steps = []
    with jax.disable_jit():
        jl, jc = JZ.prefill(serving, jnp.asarray(prompt), jcfg, JZ.init_cache(1, max_len, jcfg))
        tl, tc = TZ.prefill(serving_t, torch.from_numpy(prompt.astype(np.int64)), tcfg,
                            TZ.init_cache(1, max_len, tcfg, device="cpu"))
        steps.append(("prefill", np.asarray(jl), tl.numpy(), _ref_layers(jc, jcfg), _snapshot(tc)))
        for i in range(n_decode):
            tok = int(np.argmax(np.asarray(jl)))
            jl, jc = JZ.decode_step(serving, jnp.asarray([tok], jnp.int32), jcfg, jc)
            tl, tc = TZ.decode_step(serving_t, torch.tensor([tok]), tcfg, tc)
            steps.append((f"decode {i} at position {plen + i}", np.asarray(jl), tl.numpy(),
                          _ref_layers(jc, jcfg), _snapshot(tc)))
    return dict(plen=plen, max_len=max_len, tcfg=tcfg, steps=steps)


def check_caches(run: dict) -> None:
    """Every cache leaf of every layer, after every step, bit for bit; each
    layer with its own rows (``cache_rows``)."""
    tcfg = run["tcfg"]
    rows = TZ.cache_rows(run["max_len"], tcfg)
    for when, _, _, jlayers, tlayers in run["steps"]:
        assert len(jlayers) == len(tlayers) == tcfg.n_layers
        for i, (jc, tc) in enumerate(zip(jlayers, tlayers)):
            assert tc["k"].shape[1] == rows[i], f"layer {i} ({tcfg.layer_kinds[i]}): rows"
            for key in CACHE_KEYS:
                want, got = jc[key], tc[key]
                assert got.dtype == want.dtype and got.shape == want.shape, f"{when}: layer {i} {key}"
                bad = np.argwhere(got != want)
                assert bad.size == 0, (f"{when}: layer {i} ({tcfg.layer_kinds[i]}) cache[{key!r}] "
                                       f"differs at {bad[:5].tolist()}")


def check_logits(run: dict) -> None:
    for when, want, got, _, _ in run["steps"]:
        np.testing.assert_allclose(got, want, rtol=0, atol=OPBYOP_ATOL, err_msg=when)


def check_geometry(run: dict) -> None:
    """Each layer's rows and cursor: a local layer holds ``min(max_len,
    W)`` rows, every other ``max_len``; every cursor is absolute."""
    tcfg, plen, max_len = run["tcfg"], run["plen"], run["max_len"]
    last = run["steps"][-1][4]
    for kind, layer in zip(tcfg.layer_kinds, last):
        assert layer["k"].shape[1] == (min(max_len, W) if kind == "l" else max_len), kind
        assert int(layer["pos"][0]) == plen + len(run["steps"]) - 1


# (name, prompt length, decode steps, max_len)
CASES = {
    "mistral": ("mistral-nemo-12b", 9, 3, 32),
    "qwen3": ("qwen3-32b", 9, 3, 32),
    # prompt > W: the prefill keeps the last 8 tokens, rolled; decode at
    # 13..16 crosses 16
    "gemma3-ring-long-prompt-rolls": ("gemma3-27b", 13, 4, 32),
}


@pytest.fixture(scope="module", params=list(CASES), ids=list(CASES))
def op_by_op(request, models):
    name, plen, n_decode, max_len = CASES[request.param]
    return run_op_by_op(models(name), plen, n_decode, max_len)


def test_kv_cache_bit_identical_to_op_by_op_reference(op_by_op):
    check_caches(op_by_op)


def test_logits_match_op_by_op_reference(op_by_op):
    check_logits(op_by_op)


def test_cache_geometry_and_cursors(op_by_op):
    check_geometry(op_by_op)


def greedy_vs_compiled(m) -> None:
    """Prefill of 12 tokens (past gemma3's window) and 12 greedy decode
    steps at max_len 32 against the compiled reference: logits within TOL
    at every step, tokens identical."""
    jcfg, tcfg, serving, serving_t = _backend(m["jcfg"], "mxu"), m["tcfg"], m["serving"], m["serving_t"]
    prompt = np.random.default_rng(1).integers(0, 256, size=(1, 12)).astype(np.int32)
    prefill = jax.jit(lambda p, t, c: JZ.prefill(p, t, jcfg, c))
    decode = jax.jit(lambda p, t, c: JZ.decode_step(p, t, jcfg, c))
    jl, jc = prefill(serving, jnp.asarray(prompt), JZ.init_cache(1, 32, jcfg))
    tl, tc = TZ.prefill(serving_t, torch.from_numpy(prompt.astype(np.int64)), tcfg,
                        TZ.init_cache(1, 32, tcfg, device="cpu"))
    jtoks, ttoks = [], []
    for step in range(13):
        want, got = np.asarray(jl)[0], tl.numpy()[0]
        gap = np.abs(want - got).max()
        assert gap <= TOL, f"step {step}: max |logit gap| {gap:.3g} > {TOL}"
        jtoks.append(int(np.argmax(want)))
        ttoks.append(int(np.argmax(got)))
        assert jtoks == ttoks, f"greedy tokens diverge at step {step}: {ttoks} vs {jtoks}"
        if step == 12:
            break
        jl, jc = decode(serving, jnp.asarray([jtoks[-1]], jnp.int32), jc)
        tl, tc = TZ.decode_step(serving_t, torch.tensor([ttoks[-1]]), tcfg, tc)


@pytest.mark.parametrize("name", NAMES[:2])
def test_greedy_decode_and_logits_vs_compiled_reference(models, name):
    greedy_vs_compiled(models(name))
