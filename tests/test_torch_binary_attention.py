"""Bitwise attention through the port vs the JAX reference: the scores
backend family, its two scores functions, and the bit-bert-base smoke model
served with a scores-only backend at ``attn.qk``.

What must agree, and how:

* every scores core (``binary`` -- the CUDA kernel's plain version on the
  CPU --, ``mxu``, ``float``) with the reference's jnp core
  ``binary_attn_scores_planes`` and its numpy oracle
  ``ref.binary_attn_scores_ref``: bit for bit, at the reference's shapes
  (square; odd S with ``dh % 32 != 0`` and GQA; T past the 256-key chunk);
* ``_scores_binary`` / ``_scores_binary_latent`` with the reference's,
  which run op by op outside ``jit``: bit for bit (the float32 epilogue is
  evaluated in the reference's order);
* the packed K leaf (the reference's uint32 words viewed as int32),
  ``k_scale`` / ``k_offset`` and every V leaf after a prefill and decode
  steps, and the greedy tokens: bit for bit against the reference run op by
  op (``jax.disable_jit``); its logits to ``OPBYOP_ATOL``, the float32
  unembed summed in another order, as ``tests/test_torch_bitbert.py``
  states.  (granite-8b's and deepseek-v2-lite's smoke models are held so
  in ``tests/test_torch_binary_attention_families.py``.)

``"binary"`` leaves the core to measured dispatch (``"auto"``).  Unless a
test says otherwise both sides run with ``REPRO_QMM_AUTOTUNE=0``, where
"auto" resolves to the ``binary`` core on both: the cores are exact, so
which one runs changes no bit, and the reference's timing would cost time.
"""

import dataclasses
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs.smoke import smoke_variant as jsmoke
from repro.core import packing as JP
from repro.kernels import binary_attn as JBA
from repro.kernels import ref as JREF
from repro.models import attention as JA
from repro.models import model_zoo as JZ
from repro_torch import convert
from repro_torch.configs import get_config as tget
from repro_torch.configs.smoke import smoke_variant as tsmoke
from repro_torch.core import backend_registry, dispatch
from repro_torch.core import quantization as TQ
from repro_torch.kernels import binary_attn as TBA
from repro_torch.kernels import ops as K_ops
from repro_torch.kernels import ref
from repro_torch.models import attention as TA
from repro_torch.models import model_zoo as TZ
from repro_torch.runtime.serve_loop import Request, ServeEngine, serve_sequential
from torch_port_fixtures import release_jax_caches  # noqa: F401  (autouse)

NO_TUNING = {"REPRO_QMM_AUTOTUNE": "0"}
OPBYOP_ATOL = 1e-6
CACHE_KEYS = ["k", "v", "k_scale", "k_offset", "v_scale", "v_offset", "pos"]
N_DECODE = 5
MAX_LEN = 32


@pytest.fixture(autouse=True)
def _no_tuning():
    with mock.patch.dict(os.environ, NO_TUNING):
        dispatch.reset_cache()
        yield
        dispatch.reset_cache()


def _override(cfg, site, backend):
    quant = dataclasses.replace(cfg.quant, backend_overrides=cfg.quant.backend_overrides + ((site, backend),))
    return dataclasses.replace(cfg, quant=quant)


def _planes(b, heads, s, dh, seed):
    """Random {0,1} bits packed by the reference: (uint32 numpy, int32 tensor)."""
    bits = np.random.default_rng(seed).integers(0, 2, size=(b, heads, s, dh)).astype(np.uint32)
    words = np.asarray(JP.pack_bits(jnp.asarray(bits), 1, axis=-1))
    return words, torch.from_numpy(words.view(np.int32).copy())


# ---------------------------------------------------------------------------
# 1. the scores cores
# ---------------------------------------------------------------------------

# (B, H, G, S, T, dh): the reference's -- square; odd S, dh % 32 != 0 and
# GQA; T past the 256-key chunk; decode-shaped S = 1 with two words
PARITY_SHAPES = [
    (1, 4, 4, 8, 8, 32),
    (2, 4, 2, 5, 7, 48),
    (1, 8, 2, 3, 300, 16),
    (2, 6, 3, 1, 9, 64),
]


def test_scores_family_is_registered_as_in_reference():
    from repro.core import backend_registry as JR

    assert backend_registry.backend_names(family="scores") == JR.backend_names(family="scores") == (
        "mxu", "binary", "float")
    assert backend_registry.backend_names(family="qmm") == JR.backend_names(family="qmm")
    assert backend_registry.get_backend("binary").run_scores is TBA.binary_attn_scores_planes


@pytest.mark.parametrize("backend", ["binary", "mxu", "float"])
@pytest.mark.parametrize("shape", PARITY_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_scores_core_bit_exact_vs_reference(backend, shape):
    b, h, g, s, t, dh = shape
    qn, qt = _planes(b, h, s, dh, seed=[1, *shape])
    kn, kt = _planes(b, g, t, dh, seed=[2, *shape])
    want = JREF.binary_attn_scores_ref(qn, kn, dh)
    np.testing.assert_array_equal(np.asarray(JBA.binary_attn_scores_planes(
        jnp.asarray(qn), jnp.asarray(kn), dh=dh)), want)
    got = K_ops.binary_attn_scores(qt, kt, dh=dh, backend=backend)
    assert got.dtype == torch.int32 and got.shape == (b, h, s, t)
    np.testing.assert_array_equal(got.numpy(), want)
    if backend == "binary":  # the kernel's plain version, called directly
        np.testing.assert_array_equal(ref.binary_attn_scores_ref(qt, kt, dh).numpy(), want)


def test_plain_version_reads_strided_operands():
    """The kernel's plain version on the layouts the model hands it: Q as
    a transposed view, K as the packed cache ``(B, T, kvH, dw)`` permuted."""
    qn, _ = _planes(2, 6, 5, 40, seed=3)
    kn, _ = _planes(2, 3, 11, 40, seed=4)
    q_view = torch.from_numpy(qn.view(np.int32).transpose(0, 2, 1, 3).copy()).transpose(1, 2)
    k_view = torch.from_numpy(kn.view(np.int32).transpose(0, 2, 1, 3).copy()).permute(0, 2, 1, 3)
    assert not q_view.is_contiguous() and not k_view.is_contiguous()
    got = TBA.binary_attn_scores_planes(q_view, k_view, dh=40)
    np.testing.assert_array_equal(got.numpy(), JREF.binary_attn_scores_ref(qn, kn, 40))
    assert TBA.binary_attn_scores_planes.launches == 0  # the CPU runs the plain version


def test_scores_auto_dispatch_bit_exact():
    b, h, g, s, t, dh = 2, 4, 2, 6, 11, 48
    qn, qt = _planes(b, h, s, dh, seed=7)
    kn, kt = _planes(b, g, t, dh, seed=8)
    with mock.patch.dict(os.environ, {"REPRO_QMM_AUTOTUNE": "1"}):
        for times in ([1.0, 2.0, 3.0], [3.0, 1.0, 2.0], [3.0, 2.0, 1.0]):
            cache = dispatch.reset_cache(dispatch.AutotuneCache(timer=lambda fn, it=iter(times): next(it)))
            got = K_ops.binary_attn_scores(qt, kt, dh=dh, backend="auto", tag="decode")
            np.testing.assert_array_equal(got.numpy(), JREF.binary_attn_scores_ref(qn, kn, dh))
            (key, rec), = cache.entries.items()
            assert (key.m, key.k, key.n, key.family, key.tag) == (64, dh, t, "scores", "decode")
            assert rec.backend == ("mxu", "binary", "float")[times.index(1.0)]


def test_scores_core_rejects_malformed_operands():
    _, good = _planes(1, 2, 4, 32, seed=3)
    with pytest.raises(TypeError):
        K_ops.binary_attn_scores(good.to(torch.int64), good, dh=32, backend="binary")
    with pytest.raises(ValueError):  # word count inconsistent with dh
        K_ops.binary_attn_scores(good, good, dh=64, backend="binary")
    with pytest.raises(ValueError):  # H not a multiple of G
        _, bad_k = _planes(1, 3, 4, 32, seed=4)
        K_ops.binary_attn_scores(good, bad_k, dh=32, backend="binary")
    with pytest.raises(ValueError):  # a qmm-family name is not a scores core
        K_ops.binary_attn_scores(good, good, dh=32, backend="fused")


def test_qmm_rejects_scores_only_backend():
    from repro_torch.core import qmm as QE

    rng = np.random.default_rng(0)
    xq, yq = (TQ.quantize_activation(torch.from_numpy(rng.standard_normal(s).astype(np.float32)), 8)
              for s in ((4, 32), (32, 4)))
    for name in ("float", "binary"):
        with pytest.raises(ValueError, match="families"):
            QE.qmm(xq, yq, backend=name)


# ---------------------------------------------------------------------------
# 2. the two scores functions, op by op
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,s,h,kvh,t,dh", [(2, 5, 4, 2, 9, 48), (3, 1, 6, 3, 300, 64)])
def test_scores_binary_matches_reference(b, s, h, kvh, t, dh):
    rng = np.random.default_rng([b, s, t])
    q = rng.standard_normal((b, s, h, dh)).astype(np.float32) * 2
    kn, kt = _planes(b, kvh, t, dh, seed=[9, t])
    k_sc = (rng.random(b) + 0.1).astype(np.float32)
    k_off = rng.standard_normal(b).astype(np.float32)
    want = JA._scores_binary(jnp.asarray(q), jnp.asarray(kn), jnp.asarray(k_sc), jnp.asarray(k_off),
                             dh, "attn.qk", "binary")
    k_view = kt.permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3)  # the cache's strides
    got = TA._scores_binary(torch.from_numpy(q), k_view, torch.from_numpy(k_sc),
                            torch.from_numpy(k_off), dh, "binary")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("b,s,h,r,t", [(2, 1, 4, 16, 7), (3, 1, 16, 512, 40)])
def test_scores_binary_latent_matches_reference(b, s, h, r, t):
    rng = np.random.default_rng([b, r, t])
    q_abs = rng.standard_normal((b, s, h, r)).astype(np.float32)
    ckv = rng.integers(-128, 128, size=(b, t, r)).astype(np.int8)
    sc = (rng.random(b) * 0.1 + 0.01).astype(np.float32)
    off = rng.standard_normal(b).astype(np.float32)
    want = JA._scores_binary_latent(jnp.asarray(q_abs), jnp.asarray(ckv), jnp.asarray(sc),
                                    jnp.asarray(off), "attn.qk_latent", "binary")
    got = TA._scores_binary_latent(*(torch.from_numpy(a) for a in (q_abs, ckv, sc, off)), "binary")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# 3. served models against the reference, op by op
# ---------------------------------------------------------------------------


def _models(name, n_layers, site="attn.qk", backend="binary"):
    j = _override(dataclasses.replace(jsmoke(jget(name)), n_layers=n_layers), site, backend)
    t = _override(dataclasses.replace(tsmoke(tget(name)), n_layers=n_layers), site, backend)
    serving = JZ.prepare_serving_params(JZ.init_params(jax.random.PRNGKey(0), j), j)
    return j, t, serving, convert.from_reference(jax.tree.map(np.asarray, serving), t, device="cpu")


def _layer_caches(jcache, cfg):
    """The reference's stacked cache leaves as one numpy dict per layer,
    packed uint32 words viewed as int32."""
    stack = jcache["stack"]
    out = [jax.tree.map(np.asarray, c) for c in stack["prefix"]]
    for i in range(cfg.n_periods):
        for per in stack["period"]:
            out.append(jax.tree.map(lambda a: np.asarray(a)[i], per))
    views = {"uint32": np.int32, "bfloat16": np.int16}
    return [{k: v.view(views.get(v.dtype.name, v.dtype)) for k, v in c.items()} for c in out]


def _leaf_np(v: torch.Tensor) -> np.ndarray:
    return (v.view(torch.int16) if v.dtype == torch.bfloat16 else v).clone().numpy()


def _run_both(j, t, serving, serving_t, prompt, n_decode):
    """Prefill ``prompt`` and ``n_decode`` greedy steps on both sides, each
    on its own tokens (the reference op by op).  Returns per step (logits,
    layer caches, token) for each."""
    runs = {"j": [], "t": []}
    with jax.disable_jit():
        c = JZ.init_cache(1, MAX_LEN, j)
        jl, c = JZ.prefill(serving, jnp.asarray(prompt, jnp.int32), j, c)
        for step in range(n_decode + 1):
            tok = int(np.argmax(np.asarray(jl)[0]))
            runs["j"].append((np.asarray(jl)[0], _layer_caches(c, j), tok))
            if step < n_decode:
                jl, c = JZ.decode_step(serving, jnp.asarray([tok], jnp.int32), j, c)
    tc = TZ.init_cache(1, MAX_LEN, t, device="cpu")
    tl, tc = TZ.prefill(serving_t, torch.from_numpy(np.asarray(prompt, np.int64)), t, tc)
    for step in range(n_decode + 1):
        tok = int(tl.argmax())
        runs["t"].append((tl.numpy()[0], [{k: _leaf_np(v) for k, v in layer.items()}
                                           for layer in tc["layers"]], tok))
        if step < n_decode:
            tl, tc = TZ.decode_step(serving_t, torch.tensor([tok]), t, tc)
    return runs


PROMPT = np.random.default_rng(0).integers(0, 256, size=(1, 10))


@pytest.fixture(scope="module")
def bitbert():
    with mock.patch.dict(os.environ, NO_TUNING):
        j, t, serving, serving_t = _models("bit-bert-base", 2)
        return dict(j=j, t=t, serving_t=serving_t,
                    runs=_run_both(j, t, serving, serving_t, PROMPT, N_DECODE))


@pytest.mark.parametrize("step", [0, N_DECODE], ids=["prefill", "decode5"])
def test_bitbert_cache_leaves_bit_identical(bitbert, step):
    (_, jc, _), (_, tc, _) = bitbert["runs"]["j"][step], bitbert["runs"]["t"][step]
    dw = -(-bitbert["t"].d_head // 32)
    for layer, (want, got) in enumerate(zip(jc, tc)):
        assert got["k"].dtype == np.int32 and got["k"].shape[-1] == dw
        for key in CACHE_KEYS:
            assert got[key].dtype == want[key].dtype, key
            bad = np.argwhere(got[key] != want[key])
            assert bad.size == 0, f"step {step}, layer {layer}: cache[{key!r}] differs at {bad[:5].tolist()}"


def test_bitbert_greedy_tokens_and_logits_match_reference(bitbert):
    j, t = bitbert["runs"]["j"], bitbert["runs"]["t"]
    assert [s[2] for s in t] == [s[2] for s in j]
    for (jl, _, _), (tl, _, _) in zip(j, t):
        np.testing.assert_allclose(tl, jl, rtol=0, atol=OPBYOP_ATOL)


def test_binary_cache_layout(bitbert):
    """Packed int32 K rows, ceil(dh/32) words; V int8; 8x fewer K bytes than
    the int8 cache at bit-bert-base's d_head 64 (2 words, 8 bytes a row)."""
    t = bitbert["t"]
    cache = TZ.init_cache(1, 16, t, device="cpu")["layers"][0]
    base = TA.init_kv_cache(1, 16, dataclasses.replace(t, quant=dataclasses.replace(
        t.quant, backend_overrides=())), device="cpu")
    assert cache["k"].dtype == torch.int32 and cache["k"].shape == (1, 16, t.n_kv_heads, 1)
    assert cache["v"].dtype == base["k"].dtype == torch.int8
    full = _override(tget("bit-bert-base"), "attn.qk", "binary")
    k = TA.init_kv_cache(4, 512, full, device="meta")["k"]
    assert k.shape == (4, 512, 12, 2) and 8 * k.numel() * 4 == 4 * 512 * 12 * 64


# ---------------------------------------------------------------------------
# 4. the engine and the cores, on the port alone
# ---------------------------------------------------------------------------


def _requests(cfg, n=4, seed=0):
    rng = np.random.default_rng(seed)
    return [Request(prompt=rng.integers(0, cfg.vocab_size, size=(int(rng.integers(3, 11)),)),
                    max_new_tokens=int(rng.integers(3, 7))) for _ in range(n)]


def _tokens(done):
    return [r.output for r in done]


def test_engine_matches_sequential_and_float_core(bitbert):
    """The engine (2 slots, continuous batching) equals ``serve_sequential``
    with the binary engagement, and pinning the core to ``float`` gives the
    same tokens."""
    t, params = bitbert["t"], bitbert["serving_t"]
    eng = ServeEngine(t, params, batch_slots=2, max_len=48, seed=0, device="cpu")
    got = _tokens(eng.run(_requests(t, n=5, seed=1)))
    seq = _tokens(serve_sequential(t, params, _requests(t, n=5, seed=1), max_len=48, device="cpu"))
    assert got == seq and all(got)
    tf = _override(bitbert["t"], "attn.qk", "float")
    assert tf.quant.backend_for("attn.qk") == "binary"  # the first match wins
    tf = dataclasses.replace(tf, quant=dataclasses.replace(tf.quant, backend_overrides=(("attn.qk", "float"),)))
    assert _tokens(serve_sequential(tf, params, _requests(t, n=5, seed=1), max_len=48, device="cpu")) == seq


def test_binary_differs_from_int8_path(bitbert):
    t, params = bitbert["t"], bitbert["serving_t"]
    int8 = dataclasses.replace(t, quant=dataclasses.replace(t.quant, backend_overrides=()))
    a = _tokens(serve_sequential(t, params, _requests(t), max_len=MAX_LEN, device="cpu"))
    b = _tokens(serve_sequential(int8, params, _requests(t), max_len=MAX_LEN, device="cpu"))
    assert a != b


def test_stale_cache_rows_are_invisible(bitbert):
    """Garbage in the packed K rows past the cursor (whole words, tail bits
    included) leaves the decode logits bit-identical."""
    t, params = bitbert["t"], bitbert["serving_t"]
    cache = TZ.init_cache(1, 24, t, device="cpu")
    _, cache = TZ.prefill(params, torch.from_numpy(PROMPT[:, :6]), t, cache)
    dirty = TZ.cache_copy(cache)
    gen = torch.Generator().manual_seed(3)
    for layer in dirty["layers"]:
        garbage = torch.randint(-2**31, 2**31 - 1, layer["k"].shape, generator=gen, dtype=torch.int64)
        layer["k"][:, 7:] = garbage[:, 7:].to(torch.int32)  # rows past prompt 6 + this decode's write
    tok = torch.tensor([5])
    la, _ = TZ.decode_step(params, tok, t, cache)
    lb, _ = TZ.decode_step(params, tok, t, dirty)
    assert torch.equal(la, lb)


@pytest.mark.parametrize("which", ["decode", "prefill"])
def test_binary_step_glue_makes_no_tensor_from_host_data(bitbert, which):
    """After a warm-up call the binary-attention step makes no tensor from
    host data, which a CUDA graph capture would refuse (as
    ``tests/test_torch_graph.py`` holds the int8 path)."""
    t, params = bitbert["t"], bitbert["serving_t"]
    cache = TZ.init_cache(2, MAX_LEN, t, device="cpu")
    if which == "decode":
        tokens = torch.from_numpy(np.array([3, 4]))

        def run():
            TZ.decode_step(params, tokens, t, cache)
    else:
        prompt = torch.from_numpy(PROMPT[:, :7])

        def run():
            TZ.prefill(params, prompt, t, TZ.init_cache(1, MAX_LEN, t, device="cpu"))
    run()
    seen = []
    real_tensor, real_as_tensor = torch.tensor, torch.as_tensor

    def counting(real):
        def make(data, *args, **kwargs):
            if not isinstance(data, torch.Tensor):
                seen.append(f"{real.__name__}({data!r})")
            return real(data, *args, **kwargs)
        return make

    with mock.patch.object(torch, "tensor", counting(real_tensor)), \
            mock.patch.object(torch, "as_tensor", counting(real_as_tensor)):
        run()
    assert seen == []


def test_engine_autotuned_cache_file_round_trip(bitbert, tmp_path):
    """With autotuning on (a fake timer), the engine's tokens equal the
    untuned run's, and its cache file is saved; a second engine that loads
    it times nothing and serves the same tokens."""
    t, params = bitbert["t"], bitbert["serving_t"]
    path = str(tmp_path / "autotune.json")
    want = _tokens(serve_sequential(t, params, _requests(t), max_len=MAX_LEN, device="cpu"))
    with mock.patch.dict(os.environ, {"REPRO_QMM_AUTOTUNE": "1"}):
        first = dispatch.reset_cache(dispatch.AutotuneCache(timer=lambda fn: 1.0))
        got = _tokens(ServeEngine(t, params, batch_slots=2, max_len=MAX_LEN, device="cpu",
                                  autotune_cache_path=path).run(_requests(t)))
        assert got == want and first.timing_runs > 0 and os.path.exists(path)
        assert {k.family for k in first.entries} == {"scores"}
        assert {k.tag for k in first.entries} == {"prefill", "decode"}

        def no_timing(fn):
            raise AssertionError("a loaded cache must not time")

        second = dispatch.reset_cache(dispatch.AutotuneCache(timer=no_timing))
        again = _tokens(ServeEngine(t, params, batch_slots=2, max_len=MAX_LEN, device="cpu",
                                    autotune_cache_path=path).run(_requests(t)))
    assert again == want and second.timing_runs == 0 and len(second) == len(first)
