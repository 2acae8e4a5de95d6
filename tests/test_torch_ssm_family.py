"""The recurrent families -- recurrentgemma-2b (RG-LRU ``"r"`` layers beside
sliding-window attention ``"l"``) and mamba2-130m (SSD ``"s"`` layers) --
through the port against the JAX reference, on the reference's own params
of each smoke variant (mamba2 at ``n_layers=2``).

What must agree, and how:

* every config field, full and smoke, ``ssm`` included;
* ``prepare_serving_params`` on the converted latents: bit for bit, the
  recurrent blocks' float32 leaves (``conv_w``, ``A_log``, ``D``,
  ``dt_bias``, ``norm_g``, ``lambda_p``) kept unpacked;
* every cache leaf of every layer after the prefill and after each decode
  step, against the reference run op by op (``jax.disable_jit``): the KV
  ring, the conv windows and every cursor bit for bit; the float32
  recurrent states to the tolerances of ``tests/test_torch_ssm.py`` (the
  SSD's dots and XLA's own exp / tanh / sqrt, see there), ``h`` in float32
  ulps, ``ssm`` relative to its largest magnitude; logits to
  ``LOGIT_ATOL``; greedy tokens identical;
* ``ServeEngine`` tokens equal ``serve_sequential``'s (a row's state does
  not depend on its batch);
* ``CompiledStep`` takes a cache of its own geometry (a state layer has
  no rows) and refuses another.
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
from repro_torch.runtime.serve_loop import Request, ServeEngine, make_decode_step, serve_sequential
from torch_port_fixtures import release_jax_caches  # noqa: F401  (autouse)

NAMES = ["recurrentgemma-2b", "mamba2-130m"]
RGLRU_ULPS = 8  # float32 ulps on h, after several layers (tests/test_torch_ssm.py: 4 for one)
SSD_RTOL = 1e-6  # of the largest |ssm| (tests/test_torch_ssm.py)
LOGIT_ATOL = 1e-6  # tests/test_torch_dense_families.py
# (prompt length, decode steps, max_len): recurrentgemma's 13-token prompt
# rolls its window-8 ring, and its decode crosses position 16; mamba2's 37
# tokens are 3 chunks of 16, padded
RUNS = {"recurrentgemma-2b": (13, 6, 32), "mamba2-130m": (37, 6, 64)}


@pytest.fixture(autouse=True)
def flush_denormals():
    """XLA's CPU flushes subnormal float32 results to zero; so does PyTorch
    here, for the length of each test."""
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def _smoke(cfg, smoke):
    cfg = smoke(cfg)
    return dataclasses.replace(cfg, n_layers=2) if cfg.ssm is not None else cfg


def _backend(cfg, backend):
    return dataclasses.replace(cfg, quant=dataclasses.replace(cfg.quant, backend=backend))


@pytest.fixture(scope="module")
def models():
    built = {}

    def get(name):
        if name not in built:
            jcfg, tcfg = _smoke(jget(name), jsmoke), _backend(_smoke(tget(name), tsmoke), "pallas")
            params = JZ.init_params(jax.random.PRNGKey(0), jcfg)
            serving = JZ.prepare_serving_params(params, jcfg)
            built[name] = dict(
                jcfg=jcfg, tcfg=tcfg, serving=serving,
                latent_t=convert.from_reference(jax.tree.map(np.asarray, params), tcfg, device="cpu"),
                serving_t=convert.from_reference(jax.tree.map(np.asarray, serving), tcfg, device="cpu"),
            )
        return built[name]

    return get


def _fields_equal(got, want, path=""):
    for field in dataclasses.fields(got):
        g, w = getattr(got, field.name), getattr(want, field.name)
        if dataclasses.is_dataclass(g):
            _fields_equal(g, w, f"{path}{field.name}.")
        else:
            assert g == w, f"{path}{field.name}"


@pytest.mark.parametrize("size", ["full", "smoke"])
@pytest.mark.parametrize("name", NAMES)
def test_config_fields_equal_reference(name, size):
    j, t = jget(name), tget(name)
    if size == "smoke":
        j, t = jsmoke(j), tsmoke(t)
    _fields_equal(t, j)
    assert t.layer_kinds == j.layer_kinds
    assert (t.ssm is None) == (j.ssm is None)
    if t.ssm is not None:
        assert t.ssm.d_inner(t.d_model) == j.ssm.d_inner(j.d_model)
        assert t.ssm.n_heads(t.d_model) == j.ssm.n_heads(j.d_model)


@pytest.mark.parametrize("name", NAMES)
def test_prepare_serving_params_bit_identical(models, name):
    m = models(name)
    mine = TZ.prepare_serving_params(m["latent_t"], m["tcfg"])
    want = m["serving_t"]

    def walk(got, ref, path):
        if isinstance(ref, dict):
            assert set(got) == set(ref), path
            for k in ref:
                walk(got[k], ref[k], f"{path}.{k}")
        elif isinstance(ref, list):
            assert len(got) == len(ref), path
            for i, (g, r) in enumerate(zip(got, ref)):
                walk(g, r, f"{path}[{i}]")
        else:
            assert got.dtype == ref.dtype and torch.equal(got, ref), path

    walk(mine, want, "params")
    floats = {"rglru": ("conv_w", "lambda_p"), "ssd": ("conv_w", "A_log", "D", "dt_bias", "norm_g")}
    for layer in mine["layers"]:
        for block, leaves in floats.items():
            for leaf in leaves if block in layer else ():
                assert layer[block][leaf].dtype == torch.float32, f"{block}.{leaf}"


def _ref_layers(cache, jcfg):
    stack = cache["stack"]
    out = [jax.tree.map(np.asarray, c) for c in stack["prefix"]]
    for i in range(jcfg.n_periods):
        out += [{k: np.asarray(v)[i] for k, v in c.items()} for c in stack["period"]]
    return out


def _snapshot(cache):
    return [{k: v.numpy().copy() for k, v in layer.items()} for layer in cache["layers"]]


@pytest.fixture(scope="module", params=NAMES)
def op_by_op(request, models):
    """A prefill and greedy decode steps through the reference run op by op
    (``mxu``: its backends agree exactly) and the port's ``pallas`` path,
    each fed the reference's greedy token; every layer's cache after each
    step."""
    name = request.param
    m = models(name)
    plen, n_decode, max_len = RUNS[name]
    jcfg, tcfg = _backend(m["jcfg"], "mxu"), m["tcfg"]
    prompt = np.random.default_rng(plen).integers(0, 256, size=(1, plen)).astype(np.int32)
    steps = []
    with jax.disable_jit():
        jl, jc = JZ.prefill(m["serving"], jnp.asarray(prompt), jcfg, JZ.init_cache(1, max_len, jcfg))
        tl, tc = TZ.prefill(m["serving_t"], torch.from_numpy(prompt.astype(np.int64)), tcfg,
                            TZ.init_cache(1, max_len, tcfg, device="cpu"))
        steps.append(("prefill", np.asarray(jl), tl.numpy(), _ref_layers(jc, jcfg), _snapshot(tc)))
        for i in range(n_decode):
            tok = int(np.argmax(np.asarray(jl)))
            jl, jc = JZ.decode_step(m["serving"], jnp.asarray([tok], jnp.int32), jcfg, jc)
            tl, tc = TZ.decode_step(m["serving_t"], torch.tensor([tok]), tcfg, tc)
            steps.append((f"decode {i} at position {plen + i}", np.asarray(jl), tl.numpy(),
                          _ref_layers(jc, jcfg), _snapshot(tc)))
    return dict(name=name, tcfg=tcfg, plen=plen, max_len=max_len, steps=steps)


def _ulps(a, b) -> np.ndarray:
    def line(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(line(a) - line(b))


def test_every_cache_leaf_matches_op_by_op_reference(op_by_op):
    tcfg = op_by_op["tcfg"]
    for when, _, _, jlayers, tlayers in op_by_op["steps"]:
        assert len(jlayers) == len(tlayers) == tcfg.n_layers
        for i, (kind, jc, tc) in enumerate(zip(tcfg.layer_kinds, jlayers, tlayers)):
            assert set(jc) == set(tc), f"{when}: layer {i} ({kind}) leaves"
            for key in jc:
                want, got = jc[key], tc[key]
                where = f"{when}: layer {i} ({kind}) cache[{key!r}]"
                assert got.dtype == want.dtype and got.shape == want.shape, where
                if key == "h":
                    assert _ulps(got, want).max() <= RGLRU_ULPS, where
                elif key == "ssm":
                    assert np.abs(got - want).max() <= SSD_RTOL * np.abs(want).max(), where
                else:
                    bad = np.argwhere(got != want)
                    assert bad.size == 0, f"{where} differs at {bad[:5].tolist()}"


def test_logits_and_greedy_tokens_match_op_by_op_reference(op_by_op):
    for when, want, got, _, _ in op_by_op["steps"]:
        np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL, err_msg=when)
        assert int(np.argmax(got)) == int(np.argmax(want)), when


def test_state_geometry_and_cursors(op_by_op):
    """A state layer has no rows (``cache_rows`` None, geometry ``(1,
    None)``); a ring layer holds the window; every cursor is absolute."""
    tcfg, max_len = op_by_op["tcfg"], op_by_op["max_len"]
    last = op_by_op["steps"][-1][4]
    want_rows = [None if k in ("r", "s") else min(max_len, tcfg.window_size) for k in tcfg.layer_kinds]
    assert TZ.cache_rows(max_len, tcfg) == want_rows
    cache = {"layers": [{k: torch.from_numpy(v) for k, v in layer.items()} for layer in last]}
    assert TZ.cache_geometry(cache) == [(1, rows) for rows in want_rows]
    for layer in last:
        assert int(layer["pos"][0]) == op_by_op["plen"] + len(op_by_op["steps"]) - 1


def _requests(vocab: int):
    rng = np.random.default_rng(4)
    return [Request(prompt=rng.integers(0, vocab, size=(int(n),)).astype(np.int64), max_new_tokens=int(k))
            for n, k in ((13, 5), (1, 4), (20, 3), (5, 6), (9, 2))]


@pytest.mark.parametrize("name", NAMES)
def test_engine_equals_serve_sequential(models, name):
    """Greedy requests of ragged prompts (one of a single token, which takes
    the mixers' decode branch) through 2 slots, admitted as slots free up,
    against one request at a time."""
    m = models(name)
    tcfg, params = m["tcfg"], m["serving_t"]
    want = serve_sequential(tcfg, params, _requests(tcfg.vocab_size), max_len=32, seed=0, device="cpu")
    engine = ServeEngine(tcfg, params, batch_slots=2, max_len=32, seed=0, device="cpu")
    got = engine.run(_requests(tcfg.vocab_size))
    assert [r.output for r in got] == [r.output for r in want]
    assert all(r.state == "ok" for r in got)


@pytest.mark.parametrize("name", NAMES)
def test_cache_insert_and_reset_cover_the_state(models, name):
    """``cache_insert`` copies a prefilled slot's whole state into its row;
    ``cache_reset`` zeroes that row's state and cursor and leaves the
    other rows as they were."""
    m = models(name)
    tcfg, params = m["tcfg"], m["serving_t"]
    cache = TZ.init_cache(2, 32, tcfg, device="cpu")
    for row, n in enumerate((7, 3)):
        slot = TZ.init_slot_cache(32, tcfg, device="cpu")
        TZ.prefill(params, torch.arange(n)[None] + 1, tcfg, slot)
        TZ.cache_insert(cache, slot, row)
        for got, want in zip(cache["layers"], slot["layers"]):
            assert all(torch.equal(got[k][row], want[k][0]) for k in want)
    other = TZ.cache_copy(cache)
    TZ.cache_reset(cache, 0, tcfg, 32)
    for kind, layer, before in zip(tcfg.layer_kinds, cache["layers"], other["layers"]):
        for key, leaf in layer.items():
            assert torch.equal(leaf[1], before[key][1]), f"{kind} {key}: row 1 changed"
            if key in ("h", "ssm", "conv", "pos"):
                assert not leaf[0].any(), f"{kind} {key}: row 0 not zeroed"


@pytest.mark.parametrize("name", NAMES)
def test_compiled_step_checks_state_geometry(models, name):
    """A step takes a cache of its own batch (and, where a ring layer has
    one, its rows) and refuses another batch or ring length."""
    m = models(name)
    tcfg, params = m["tcfg"], m["serving_t"]
    step = make_decode_step(tcfg, 2, 16, device="cpu")
    cache = TZ.init_cache(2, 16, tcfg, device="cpu")
    tokens = torch.zeros(2, dtype=torch.int64)
    logits, out = step(params, tokens, cache)
    assert out is cache and logits.shape == (2, tcfg.vocab_size)
    assert all([int(p) for p in layer["pos"]] == [1, 1] for layer in cache["layers"])
    with pytest.raises(ValueError, match="max_len"):
        step(params, tokens, TZ.init_cache(1, 16, tcfg, device="cpu"))
    if "l" in tcfg.layer_kinds:  # a 4-row ring instead of the window's 8 rows
        with pytest.raises(ValueError, match="max_len"):
            step(params, tokens, TZ.init_cache(2, 4, tcfg, device="cpu"))
