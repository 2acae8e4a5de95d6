"""The compiled serving steps of the port (``make_decode_step`` /
``make_prefill``) and the engine that replays them, on the CPU.

On the CPU a compiled step runs its eager step, so here it must equal
``model_zoo.decode_step`` / ``prefill`` bit for bit, and agree with the
reference's own jitted steps (``repro.runtime.serve_loop.make_decode_step``
/ ``make_prefill`` on a one-device CPU mesh) as the other parity tests hold
the port to the compiled reference: granite-8b smoke logits to ``TOL``
with equal greedy tokens; bit-bert-base smoke at A8 likewise, and at A1
(where the compiled reference drifts from its own op-by-op run as far as
the logits reach, ``tests/test_torch_bitbert.py``) the first layer's KV
cache, up to the one-step mantissa flips that drift makes there.  Replay
on the card is held to the eager step in ``tests/test_torch_cuda.py``.

A CUDA graph cannot capture a tensor made from host data, so a guard runs
the step glue a second time and counts every ``torch.tensor`` /
``torch.as_tensor`` call on a Python number, list or numpy array: there
must be none (the kernel wrappers are stubbed out of the count, since on the
CPU they run their plain versions, which are never captured).
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
from repro.launch.mesh import make_host_mesh
from repro.models import model_zoo as JZ
from repro.runtime import serve_loop as JS
from repro_torch import convert
from repro_torch.configs import get_config as tget
from repro_torch.configs.smoke import smoke_variant as tsmoke
from repro_torch.kernels import ops as TO
from repro_torch.models import model_zoo as TZ
from repro_torch.runtime.serve_loop import (
    Request,
    ServeEngine,
    make_decode_step,
    make_prefill,
    serve_sequential,
)
from torch_port_fixtures import release_jax_caches  # noqa: F401  (autouse)

TOL = 0.03  # tests/test_torch_model.py, and tests/test_torch_bitbert.py's COMPILED_TOL[8]
# At A1 the compiled reference moves a projection by one float32 ulp (fma
# contraction) even in the first layer, and an int8 cache mantissa on a
# bucket edge then flips by one step.  On this test's prompt 1 of 3,072 K
# and 1 of 3,072 V mantissas of layer 0 flip, the same under the jitted
# step and the unjitted ``prefill``, while the port equals the reference run
# op by op bit for bit (tests/test_torch_bitbert.py).  The share allowed:
A1_FLIPS = 0.002
CACHE_KEYS = ["k", "v", "k_scale", "k_offset", "v_scale", "v_offset", "pos"]
MAX_LEN = 48
N_TICKS = 4
MODELS = ["granite", "bitbert-a1", "bitbert-a8"]
NAMES = {"granite": "granite-8b", "bitbert-a1": "bit-bert-base", "bitbert-a8": "bit-bert-base-a8"}


def _cfgs(model, backend="pallas"):
    j, t = jsmoke(jget(NAMES[model])), tsmoke(tget(NAMES[model]))
    if model != "granite":  # tests/test_torch_bitbert.py's 2-layer smoke
        j, t = dataclasses.replace(j, n_layers=2), dataclasses.replace(t, n_layers=2)
    return (
        dataclasses.replace(j, quant=dataclasses.replace(j.quant, backend=backend)),
        dataclasses.replace(t, quant=dataclasses.replace(t.quant, backend=backend)),
    )


@pytest.fixture(scope="module")
def params():
    """Reference serving params and their port copies, one set per
    architecture (bit-bert's A1 and A8 share theirs)."""
    out = {}
    for arch, model in (("granite", "granite"), ("bitbert", "bitbert-a1")):
        jcfg, tcfg = _cfgs(model)
        serving = JZ.prepare_serving_params(JZ.init_params(jax.random.PRNGKey(0), jcfg), jcfg)
        out[arch] = serving, convert.from_reference(jax.tree.map(np.asarray, serving), tcfg, device="cpu")
    return out


def _params(params, model):
    return params["granite" if model == "granite" else "bitbert"]


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(0, 256, size=(1, n)).astype(np.int32)


def _packed_cache(tcfg, serving_t, prompts):
    """A len(prompts)-row cache, each row prefilled with its own prompt."""
    cache = TZ.init_cache(len(prompts), MAX_LEN, tcfg, device="cpu")
    firsts = []
    for i, p in enumerate(prompts):
        slot = TZ.init_slot_cache(MAX_LEN, tcfg, device="cpu")
        logits, slot = TZ.prefill(serving_t, torch.from_numpy(p.astype(np.int64)), tcfg, slot)
        TZ.cache_insert(cache, slot, i)
        firsts.append(int(logits.argmax()))
    return cache, firsts


@pytest.mark.parametrize("model", MODELS)
def test_decode_step_equals_eager_on_cpu(params, model):
    """N_TICKS packed ticks: logits and every cache leaf bit for bit."""
    tcfg = _cfgs(model)[1]
    serving_t = _params(params, model)[1]
    eager, toks = _packed_cache(tcfg, serving_t, [_prompt(1, 6), _prompt(2, 9)])
    compiled = TZ.cache_copy(eager)
    step = make_decode_step(tcfg, 2, MAX_LEN, device="cpu")
    for tick in range(N_TICKS):
        tokens = torch.tensor(toks)
        want, eager = TZ.decode_step(serving_t, tokens, tcfg, eager)
        got, out_cache = step(serving_t, tokens, compiled)
        assert out_cache is compiled
        assert got.dtype == want.dtype and torch.equal(got, want), f"tick {tick}: logits differ"
        assert TZ.caches_equal(compiled, eager), f"tick {tick}: caches differ"
        toks = want.argmax(-1).tolist()
    assert (step.captures, step.replays) == (0, 0)  # the CPU has no graphs


@pytest.mark.parametrize("model", MODELS)
def test_prefill_equals_eager_on_cpu(params, model):
    tcfg = _cfgs(model)[1]
    serving_t = _params(params, model)[1]
    prompt = torch.from_numpy(_prompt(3, 11).astype(np.int64))
    want, eager = TZ.prefill(serving_t, prompt, tcfg, TZ.init_cache(1, MAX_LEN, tcfg, device="cpu"))
    fn = make_prefill(tcfg, 1, 11, MAX_LEN, device="cpu")
    got, compiled = fn(serving_t, prompt, TZ.init_cache(1, MAX_LEN, tcfg, device="cpu"))
    assert torch.equal(got, want)
    assert TZ.caches_equal(compiled, eager), "prefill: caches differ"


def test_steps_refuse_other_shapes(params):
    tcfg = _cfgs("granite")[1]
    serving_t = params["granite"][1]
    step = make_decode_step(tcfg, 2, MAX_LEN, device="cpu")
    with pytest.raises(ValueError, match="tokens of shape"):
        step(serving_t, torch.zeros(3, dtype=torch.int64), TZ.init_cache(2, MAX_LEN, tcfg, device="cpu"))
    with pytest.raises(ValueError, match="max_len"):
        step(serving_t, torch.zeros(2, dtype=torch.int64), TZ.init_cache(2, 32, tcfg, device="cpu"))
    fn = make_prefill(tcfg, 1, 5, MAX_LEN, device="cpu")
    with pytest.raises(ValueError, match="tokens of shape"):
        fn(serving_t, torch.zeros((1, 6), dtype=torch.int64), TZ.init_cache(1, MAX_LEN, tcfg, device="cpu"))


@pytest.fixture(scope="module")
def mesh():
    return make_host_mesh()


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("model", MODELS)
def test_compiled_steps_vs_reference_compiled_steps(params, mesh, model):
    """The reference's jitted ``make_prefill`` then ``make_decode_step``
    against the port's, on the reference's greedy tokens: logits within
    TOL and the same greedy token at every step (granite, A8); at A1 the
    first layer's K/V cache: mantissas within one step at no more than
    A1_FLIPS of them, scales and offsets to one float32 ulp, cursors
    equal."""
    jcfg, tcfg = _cfgs(model)
    serving, serving_t = _params(params, model)
    prompt = _prompt(4, 10)
    j_pre = JS.make_prefill(jcfg, mesh, 1, prompt.shape[1], MAX_LEN)
    j_dec = JS.make_decode_step(jcfg, mesh, 1, MAX_LEN)
    t_pre = make_prefill(tcfg, 1, prompt.shape[1], MAX_LEN, device="cpu")
    t_dec = make_decode_step(tcfg, 1, MAX_LEN, device="cpu")
    jl, jc = j_pre(serving, jnp.asarray(prompt), JZ.init_cache(1, MAX_LEN, jcfg))
    tl, tc = t_pre(serving_t, torch.from_numpy(prompt.astype(np.int64)),
                   TZ.init_cache(1, MAX_LEN, tcfg, device="cpu"))
    for step in range(N_TICKS + 1):
        want, got = np.asarray(jl)[0], tl.numpy()[0]
        tok = int(np.argmax(want))
        if model == "bitbert-a1":
            want_c = jax.tree.map(np.asarray, jc["stack"]["period"][0])
            for key in CACHE_KEYS:
                w, g = want_c[key][0], tc["layers"][0][key].numpy()
                assert g.dtype == w.dtype, key
                if key in ("k", "v"):
                    d = np.abs(g.astype(np.int32) - w.astype(np.int32))
                    assert d.max() <= 1 and (d > 0).mean() <= A1_FLIPS, (
                        f"step {step}: layer 0 cache[{key!r}]: {(d > 0).sum()} mantissas differ, "
                        f"by up to {d.max()}")
                elif key == "pos":
                    assert np.array_equal(g, w), f"step {step}: cursor {g} vs {w}"
                else:
                    assert _ulps(g, w).max() <= 1, f"step {step}: layer 0 {key} {g} vs {w}"
        else:
            gap = np.abs(want - got).max()
            assert gap <= TOL, f"step {step}: max |logit gap| {gap:.3g} > {TOL}"
            assert int(np.argmax(got)) == tok, f"step {step}: greedy token differs"
        if step < N_TICKS:
            jl, jc = j_dec(serving, jnp.asarray([tok], jnp.int32), jc)
            tl, tc = t_dec(serving_t, torch.tensor([tok]), tc)


_WRAPPERS = [(TO._bq, "binary_qmm"), (TO._fq, "fused_qmm"), (TO._pq, "popcount_qmm"),
             (TO._bs, "bitserial_qmm")]


def _host_tensors_made(run) -> list:
    """Call ``run`` once to warm up (it makes the step's constants), then
    again, listing every ``torch.tensor`` / ``torch.as_tensor`` call on a
    Python number, list or numpy array outside the kernel wrappers."""
    run()  # warm-up: makes the step's constants
    seen, inside = [], [0]
    real_tensor, real_as_tensor = torch.tensor, torch.as_tensor

    def counting(real):
        def make(data, *args, **kwargs):
            if not inside[0] and not isinstance(data, torch.Tensor):
                seen.append(f"{real.__name__}({data!r})")
            return real(data, *args, **kwargs)
        return make

    def stubbed(fn):
        def call(*args, **kwargs):
            inside[0] += 1
            try:
                return fn(*args, **kwargs)
            finally:
                inside[0] -= 1
        return call

    patches = [mock.patch.object(mod, name, stubbed(getattr(mod, name))) for mod, name in _WRAPPERS]
    patches += [mock.patch.object(torch, "tensor", counting(real_tensor)),
                mock.patch.object(torch, "as_tensor", counting(real_as_tensor))]
    for p in patches:
        p.start()
    try:
        run()
    finally:
        for p in reversed(patches):
            p.stop()
    return seen


@pytest.mark.parametrize("model,backend", [
    ("granite", "pallas"), ("granite", "fused"), ("granite", "mxu"),
    ("bitbert-a1", "pallas"), ("bitbert-a8", "pallas"),
])
@pytest.mark.parametrize("which", ["decode", "prefill"])
def test_step_glue_makes_no_tensor_from_host_data(params, model, backend, which):
    """After one warm-up call, a second call of the step makes no tensor
    from host data (a host-to-device copy, which a capture refuses)."""
    tcfg = _cfgs(model, backend)[1]
    serving_t = _params(params, model)[1]
    if which == "decode":
        cache, toks = _packed_cache(tcfg, serving_t, [_prompt(5, 7), _prompt(6, 4)])
        tokens = torch.tensor(toks)

        def run():
            TZ.decode_step(serving_t, tokens, tcfg, cache)
    else:
        tokens = torch.from_numpy(_prompt(7, 9).astype(np.int64))

        def run():
            TZ.prefill(serving_t, tokens, tcfg, TZ.init_cache(1, MAX_LEN, tcfg, device="cpu"))

    seen = _host_tensors_made(run)
    assert seen == [], f"tensors made from host data inside the step: {seen[:5]}"


def _requests(n=4, seed=11):
    rng = np.random.default_rng(seed)
    return [
        Request(prompt=rng.integers(0, 256, size=(int(rng.integers(3, 11)),)).astype(np.int32),
                max_new_tokens=int(rng.integers(3, 7)))
        for _ in range(n)
    ]


@pytest.mark.parametrize("model", ["granite", "bitbert-a1"])
def test_engine_runs_twice_with_one_cache(params, model):
    """The engine keeps its packed cache (and on the card its captured
    step) across ``run`` calls: a second run of the same greedy requests
    gives the same tokens, and both equal ``serve_sequential``."""
    tcfg = _cfgs(model)[1]
    serving_t = _params(params, model)[1]
    want = serve_sequential(tcfg, serving_t, _requests(), max_len=MAX_LEN, seed=0, device="cpu")
    engine = ServeEngine(tcfg, serving_t, batch_slots=2, max_len=MAX_LEN, seed=0, device="cpu")
    cache = engine._cache
    first = [r.output for r in engine.run(_requests())]
    second = [r.output for r in engine.run(_requests())]
    assert engine._cache is cache
    assert first == second == [r.output for r in want]


def test_engine_resets_a_free_row_before_its_cursor_leaves_the_cache(params):
    """A free row still advances its cursor every tick.  One request at a
    time keeps row 1 free across runs; the engine resets it before its
    cursor reaches max_len (where the cache write would fall outside the
    cache), and the tokens still equal ``serve_sequential``."""
    tcfg = _cfgs("granite")[1]
    serving_t = params["granite"][1]
    max_len = 16

    def one(seed):
        p = np.random.default_rng(seed).integers(0, 256, size=(4,)).astype(np.int32)
        return [Request(prompt=p, max_new_tokens=12)]

    engine = ServeEngine(tcfg, serving_t, batch_slots=2, max_len=max_len, seed=0, device="cpu")
    resets = 0
    for seed in range(3):
        got = engine.run(one(seed))
        want = serve_sequential(tcfg, serving_t, one(seed), max_len=max_len, seed=0, device="cpu")
        assert got[0].output == want[0].output
        resets += sum(e["kind"] == "reset" and e["rid"] is None for e in engine.last_events)
    assert resets >= 1


# ---- gemma3-27b smoke: ring-buffer local layers (window 8) beside global ones

GEMMA3_MAX_LEN = 24  # > the window: every local layer is an 8-row ring


@pytest.fixture(scope="module")
def gemma3():
    tcfg = tsmoke(tget("gemma3-27b"))
    tcfg = dataclasses.replace(tcfg, quant=dataclasses.replace(tcfg.quant, backend="pallas"))
    return tcfg, TZ.init_serving_params(0, tcfg, device="cpu")


def test_gemma3_engine_equals_serve_sequential_across_the_ring(gemma3):
    """Greedy requests through the engine's packed ticks equal the
    one-at-a-time oracle: one prompt longer than the window (the ring
    wraps inside its prefill), one that decodes across the wrap, and short
    ones beside them."""
    tcfg, params = gemma3
    assert tcfg.window_size == 8 and TZ.cache_rows(GEMMA3_MAX_LEN, tcfg)[0] == 8

    def requests():
        rng = np.random.default_rng(4)
        return [Request(prompt=rng.integers(0, 256, size=(n,)).astype(np.int32), max_new_tokens=new)
                for n, new in ((13, 5), (6, 7), (3, 4), (4, 9))]

    want = serve_sequential(tcfg, params, requests(), max_len=GEMMA3_MAX_LEN, seed=0, device="cpu")
    engine = ServeEngine(tcfg, params, batch_slots=2, max_len=GEMMA3_MAX_LEN, seed=0, device="cpu")
    got = engine.run(requests())
    assert [r.output for r in got] == [r.output for r in want]
    assert all(r.state == "ok" for r in got)


def test_gemma3_compiled_step_checks_every_layer_geometry(gemma3):
    """The step holds each layer to its own rows: a ring layer's window,
    a global layer's max_len.  A cache made for another max_len has the
    same 8-row rings (layer 0 included) but other global layers, and is
    refused."""
    tcfg, params = gemma3
    step = make_decode_step(tcfg, 2, GEMMA3_MAX_LEN, device="cpu")
    cache = TZ.init_cache(2, GEMMA3_MAX_LEN, tcfg, device="cpu")
    rows = {layer["k"].shape[1] for layer in cache["layers"]}
    assert rows == {8, GEMMA3_MAX_LEN}
    tokens = torch.zeros(2, dtype=torch.int64)
    logits, out = step(params, tokens, cache)
    assert out is cache and logits.shape == (2, tcfg.vocab_size)
    other = TZ.init_cache(2, GEMMA3_MAX_LEN + 8, tcfg, device="cpu")
    assert other["layers"][0]["k"].shape == cache["layers"][0]["k"].shape
    with pytest.raises(ValueError, match="max_len"):
        step(params, tokens, other)
    with pytest.raises(ValueError, match="max_len"):
        step(params, tokens, TZ.init_cache(1, GEMMA3_MAX_LEN, tcfg, device="cpu"))


def test_gemma3_engine_resets_a_free_row_at_max_len(gemma3):
    """With ring layers beside global ones, a free row is still reset
    before its cursor reaches max_len (where a global layer's write would
    leave the cache; a ring's wraps), and tokens equal the oracle."""
    tcfg, params = gemma3
    max_len = 12

    def one(seed):
        p = np.random.default_rng(seed).integers(0, 256, size=(3,)).astype(np.int32)
        return [Request(prompt=p, max_new_tokens=9)]

    engine = ServeEngine(tcfg, params, batch_slots=2, max_len=max_len, seed=0, device="cpu")
    resets = 0
    for seed in range(3):
        got = engine.run(one(seed))
        want = serve_sequential(tcfg, params, one(seed), max_len=max_len, seed=0, device="cpu")
        assert got[0].output == want[0].output
        resets += sum(e["kind"] == "reset" and e["rid"] is None for e in engine.last_events)
    assert resets >= 1


@pytest.mark.parametrize("which", ["decode", "prefill"])
def test_gemma3_step_glue_makes_no_tensor_from_host_data(gemma3, which):
    """The ring's slot and mask arithmetic, qk-norm and the local rope
    theta make no tensor from host data after the warm-up call."""
    tcfg, params = gemma3
    if which == "decode":
        cache = TZ.init_cache(2, GEMMA3_MAX_LEN, tcfg, device="cpu")
        for row, n in enumerate((11, 5)):  # row 0 past the window, row 1 about to wrap
            slot = TZ.init_slot_cache(GEMMA3_MAX_LEN, tcfg, device="cpu")
            TZ.prefill(params, torch.from_numpy(_prompt(n, n).astype(np.int64)), tcfg, slot)
            TZ.cache_insert(cache, slot, row)
        tokens = torch.tensor([1, 2])

        def run():
            TZ.decode_step(params, tokens, tcfg, cache)
    else:
        tokens = torch.from_numpy(_prompt(7, 13).astype(np.int64))

        def run():
            TZ.prefill(params, tokens, tcfg, TZ.init_cache(1, GEMMA3_MAX_LEN, tcfg, device="cpu"))

    assert _host_tensors_made(run) == []


def test_compiled_step_checks_mla_cache_rows():
    """An MLA layer's rows are its latent cache's (``ckv``; it has no
    ``k``): a step refuses an MLA cache made for another max_len or batch,
    and takes its own."""
    tcfg = tsmoke(tget("deepseek-v2-lite-16b"))
    tcfg = dataclasses.replace(tcfg, quant=dataclasses.replace(tcfg.quant, backend="pallas"))
    params = TZ.init_serving_params(0, tcfg, device="cpu")
    step = make_decode_step(tcfg, 2, 16, device="cpu")
    cache = TZ.init_cache(2, 16, tcfg, device="cpu")
    assert all("k" not in layer and layer["ckv"].shape[:2] == (2, 16) for layer in cache["layers"])
    tokens = torch.zeros(2, dtype=torch.int64)
    logits, out = step(params, tokens, cache)
    assert out is cache and logits.shape == (2, tcfg.vocab_size)
    assert [int(p) for p in cache["layers"][1]["pos"]] == [1, 1]
    with pytest.raises(ValueError, match="max_len"):
        step(params, tokens, TZ.init_cache(2, 24, tcfg, device="cpu"))
    with pytest.raises(ValueError, match="max_len"):
        step(params, tokens, TZ.init_cache(1, 16, tcfg, device="cpu"))


@pytest.mark.parametrize("which", ["decode", "prefill"])
def test_mla_moe_step_glue_makes_no_tensor_from_host_data(which):
    """MLA (latent writes, the absorbed decode) and the MoE dispatch make no
    tensor from host data after the warm-up call: the capacity is a Python
    int, and the sorts and scatters stay on the device."""
    tcfg = tsmoke(tget("deepseek-v3-671b"))
    tcfg = dataclasses.replace(tcfg, quant=dataclasses.replace(tcfg.quant, backend="pallas"))
    params = TZ.init_serving_params(0, tcfg, device="cpu")
    if which == "decode":
        cache = TZ.init_cache(2, 16, tcfg, device="cpu")
        for row, n in enumerate((5, 3)):
            slot = TZ.init_slot_cache(16, tcfg, device="cpu")
            TZ.prefill(params, torch.from_numpy(_prompt(n, n).astype(np.int64)), tcfg, slot)
            TZ.cache_insert(cache, slot, row)
        tokens = torch.tensor([1, 2])

        def run():
            TZ.decode_step(params, tokens, tcfg, cache)
    else:
        tokens = torch.from_numpy(_prompt(7, 9).astype(np.int64))

        def run():
            TZ.prefill(params, tokens, tcfg, TZ.init_cache(1, 16, tcfg, device="cpu"))

    assert _host_tensors_made(run) == []


@pytest.mark.parametrize("name", ["recurrentgemma-2b", "mamba2-130m"])
@pytest.mark.parametrize("which", ["decode", "prefill"])
def test_recurrent_step_glue_makes_no_tensor_from_host_data(name, which):
    """The RG-LRU and SSD mixers -- conv windows, the associative scan, the
    chunked SSD with its padding and cumulative sums -- make no tensor from
    host data after the warm-up call."""
    tcfg = tsmoke(tget(name))
    tcfg = dataclasses.replace(tcfg, quant=dataclasses.replace(tcfg.quant, backend="pallas"))
    params = TZ.init_serving_params(0, tcfg, device="cpu")
    if which == "decode":
        cache = TZ.init_cache(2, 32, tcfg, device="cpu")
        for row, n in enumerate((11, 3)):
            slot = TZ.init_slot_cache(32, tcfg, device="cpu")
            TZ.prefill(params, torch.from_numpy(_prompt(n, n).astype(np.int64)), tcfg, slot)
            TZ.cache_insert(cache, slot, row)
        tokens = torch.tensor([1, 2])

        def run():
            TZ.decode_step(params, tokens, tcfg, cache)
    else:
        tokens = torch.from_numpy(_prompt(7, 19).astype(np.int64))  # 2 chunks of 16, padded

        def run():
            TZ.prefill(params, tokens, tcfg, TZ.init_cache(1, 32, tcfg, device="cpu"))

    assert _host_tensors_made(run) == []
