"""The port's recurrent mixers (``repro_torch/models/ssm.py``) against the
reference's (``repro/models/ssm.py``) run op by op (``jax.disable_jit``),
on the same inputs made from a numpy seed and the reference's own params.

Where exactness is at risk, and what is held:

* ``jnp.cumsum`` (``_segsum``, the SSD's chunk decay): XLA's CPU rewrites
  a cumulative sum past 16 elements into blocks of 16; the port mirrors the
  rewrite, bit for bit at every length (chunk 16 never reaches it, chunk
  128 and a 300-token row do).
* ``lax.associative_scan`` (the RG-LRU prefill): the port mirrors jax's
  odd/even recursion, bit for bit.  XLA's CPU flushes subnormal results to
  zero and PyTorch's does not, so the module runs with PyTorch's flush on
  (``torch.set_flush_denormal``): long products of decays underflow.
* The float32 dots (the SSD's ``cb``, ``y_diag``, chunk-state and carried-
  state contractions, the decode's ``C h``): the port contracts in jax's
  pairwise order, but XLA's CPU dot sums each contraction in another order
  than PyTorch's.  Held to ``SSD_RTOL`` of the largest magnitude.
* exp, log1p, tanh, sigmoid and sqrt: XLA's CPU has its own
  approximations, a few float32 ulps from PyTorch's on some inputs
  (``test_float32_activations_*``).  The RG-LRU's ``h`` is held to
  ``RGLRU_ULPS``.
* Everything bf16 or integer downstream -- mixer outputs, the conv
  windows (bf16 values stored in float32) and the cursors -- bit for bit.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs.smoke import smoke_variant as jsmoke
from repro.models import layers as JL
from repro.models import ssm as JS
from repro_torch import convert
from repro_torch.configs import get_config as tget
from repro_torch.configs.smoke import smoke_variant as tsmoke
from repro_torch.models import layers as TL
from repro_torch.models import ssm as TS
from torch_port_fixtures import release_jax_caches  # noqa: F401  (autouse)

SSD_RTOL = 1e-6  # |port - reference| <= SSD_RTOL * max |reference| (measured <= 1.2e-7)
RGLRU_ULPS = 4  # float32 ulps on the RG-LRU state h (measured <= 1)


@pytest.fixture(autouse=True)
def flush_denormals():
    """XLA's CPU flushes subnormal float32 results to zero; so does PyTorch
    here, for the length of each test."""
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def _bits_equal(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a.view(np.uint8), b.view(np.uint8))


def _ulps(a, b) -> np.ndarray:
    """Distance in float32 ulps (on the ordered integer line)."""
    def line(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(line(a) - line(b))


def _assert_rel(got, want, rtol, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, what
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= rtol * float(np.abs(want).max()), f"{what}: max |diff| {err}, max |ref| {np.abs(want).max()}"


# ---------------------------------------------------------------------------
# the scans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 16, 17, 31, 32, 33, 40, 128, 129, 256, 300, 1000])
def test_cumsum_is_xlas_order(n):
    x = (np.random.default_rng(n).standard_normal((2, 3, n)) * -0.3).astype(np.float32)
    with jax.disable_jit():
        want = np.asarray(jnp.cumsum(jnp.asarray(x), axis=-1))
    assert _bits_equal(TS._cumsum(torch.from_numpy(x)).numpy(), want)


def _ssd_inputs(s: int, h: int = 8, p: int = 16, n: int = 16, seed: int = 0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((1, s, h)))).astype(np.float32)
    a = (-np.exp(rng.standard_normal(h) * 0.5)).astype(np.float32)
    bm = rng.standard_normal((1, s, 1, n)).astype(np.float32)
    cm = rng.standard_normal((1, s, 1, n)).astype(np.float32)
    init = rng.standard_normal((1, h, p, n)).astype(np.float32)
    return x, dt, a, bm, cm, init


@pytest.mark.parametrize("chunk", [16, 128])
def test_segsum_bit_identical(chunk):
    """300 tokens padded to whole chunks, as ``ssd_mixer`` pads them."""
    _, dt, a, *_ = _ssd_inputs(300)
    s = -(-300 // chunk) * chunk
    a_bar = np.pad(dt, ((0, 0), (0, s - 300), (0, 0)))[0].T.reshape(8, -1, chunk) * a[:, None, None]
    with jax.disable_jit():
        want = np.asarray(JS._segsum(jnp.asarray(a_bar)))
    assert _bits_equal(TS._segsum(torch.from_numpy(a_bar)).numpy(), want)


@pytest.mark.parametrize("chunk", [16, 128])
def test_ssd_chunked_matches_reference(chunk):
    """A 300-token sequence padded to whole chunks (3 at chunk 128, 19 at
    16, past the 16-block rewrite of the chunk-count cumulative sums), from
    a carried state."""
    x, dt, a, bm, cm, init = _ssd_inputs(300, seed=chunk)
    s = -(-300 // chunk) * chunk
    pad = lambda t: np.pad(t, [(0, 0), (0, s - 300)] + [(0, 0)] * (t.ndim - 2))
    x, dt, bm, cm = pad(x), pad(dt), pad(bm), pad(cm)
    with jax.disable_jit():
        jy, jf = JS._ssd_chunked(*map(jnp.asarray, (x, dt, a, bm, cm)), chunk, jnp.asarray(init))
    ty, tf = TS._ssd_chunked(*map(torch.from_numpy, (x, dt, a, bm, cm)), chunk, torch.from_numpy(init))
    _assert_rel(ty.numpy(), np.asarray(jy), SSD_RTOL, "y")
    _assert_rel(tf.numpy(), np.asarray(jf), SSD_RTOL, "final state")


def _combine(left, right):
    a1, b1 = left
    a2, b2 = right
    return a1 * a2, a2 * b1 + b2


@pytest.mark.parametrize("n", [1, 2, 7, 300])
def test_associative_scan_mirror_bit_identical(n):
    rng = np.random.default_rng(n)
    a = rng.uniform(0.5, 1.0, (2, n, 5)).astype(np.float32)
    b = rng.standard_normal((2, n, 5)).astype(np.float32)
    with jax.disable_jit():
        ja, jb = jax.lax.associative_scan(_combine, (jnp.asarray(a), jnp.asarray(b)), axis=1)
    ta, tb = TS._associative_scan(torch.from_numpy(a), torch.from_numpy(b))
    assert _bits_equal(ta.numpy(), ja) and _bits_equal(tb.numpy(), jb)


# ---------------------------------------------------------------------------
# float32 activations on the mixers' inputs: float32 values of bf16 numbers
# ---------------------------------------------------------------------------


def _bf16_values() -> np.ndarray:
    """Every finite bf16 number that is not subnormal, as float32."""
    x = (np.arange(65536, dtype=np.uint32) << 16).view(np.float32)
    return x[np.isfinite(x) & ((np.abs(x) >= np.finfo(np.float32).tiny) | (x == 0))]


# (port function, reference function, float32 ulps of the reference's value,
# absolute floor): over every bf16 input, |port - reference| <= ulps x
# spacing(|reference|) + floor.  The floors: below about -87 exp and the
# sigmoid underflow, and XLA flushes the subnormal result to zero where
# PyTorch's threads may keep it (softplus and sigmoid differ by < 2e-38
# there, silu by x times that, < 2e-36); XLA's tanh saturates to -1 past
# |argument| 7.9, so gelu is -0 there where PyTorch's is down to -6e-7.
ACTIVATIONS = {
    "softplus": (TS._softplus, jax.nn.softplus, 3, 2e-38),  # XLA's exp and log1p
    "sigmoid": (torch.sigmoid, jax.nn.sigmoid, 2, 2e-38),
    "silu": (TS._silu, jax.nn.silu, 2, 2e-36),
    "gelu": (TL.gelu, jax.nn.gelu, 4, 1e-6),  # XLA's tanh
}


@pytest.mark.parametrize("name", sorted(ACTIVATIONS))
def test_float32_activations_within_ulps_of_reference(name):
    mine, ref, ulps, floor = ACTIVATIONS[name]
    x = _bf16_values()
    with jax.disable_jit():
        want = np.asarray(ref(jnp.asarray(x)))
    got = mine(torch.from_numpy(x.copy())).numpy()
    assert got.dtype == np.float32
    allowed = ulps * np.spacing(np.abs(want)) + floor
    bad = np.abs(got - want) > allowed
    assert not bad.any(), f"{name} at {x[bad][:5]}: {got[bad][:5]} vs {want[bad][:5]}"


def test_softplus_is_logaddexp_past_20():
    """Past 20, ``torch.nn.functional.softplus`` switches to ``x``; the
    port evaluates jax's ``logaddexp(x, 0)`` everywhere."""
    x = torch.tensor([19.5, 20.5, 25.0, 40.0, -30.0], dtype=torch.float32)
    with jax.disable_jit():
        want = np.asarray(jax.nn.softplus(jnp.asarray(x.numpy())))
    assert _bits_equal(TS._softplus(x).numpy(), want)
    assert math.isclose(float(TS._softplus(x)[-1]), math.log1p(math.exp(-30.0)), rel_tol=1e-6)


# ---------------------------------------------------------------------------
# the mixers: a prefill, then decode steps, every state leaf
# ---------------------------------------------------------------------------


def _pack(tree, quant):
    if isinstance(tree, dict):
        if set(tree) == {"w"}:
            return JL.pack_linear_for_serving(tree, quant)
        return {k: _pack(v, quant) for k, v in tree.items()}
    return tree


def _cfgs(name: str, chunk=None):
    j, t = jsmoke(jget(name)), tsmoke(tget(name))
    if chunk:
        j = dataclasses.replace(j, ssm=dataclasses.replace(j.ssm, chunk=chunk))
        t = dataclasses.replace(t, ssm=dataclasses.replace(t.ssm, chunk=chunk))
    return j, dataclasses.replace(t, quant=dataclasses.replace(t.quant, backend="pallas"))


MIXERS = {  # kind -> (reference init, state, mixer; port state, mixer; float32 state leaf)
    "s": (JS.init_ssd, JS.init_ssd_state, JS.ssd_mixer, TS.init_ssd_state, TS.ssd_mixer, "ssm"),
    "r": (JS.init_rglru, JS.init_rglru_state, JS.rglru_mixer, TS.init_rglru_state, TS.rglru_mixer, "h"),
}


def _run_mixer(kind: str, name: str, chunk, plen: int, n_decode: int = 3):
    jinit, jstate, jmix, tstate, tmix, _ = MIXERS[kind]
    jcfg, tcfg = _cfgs(name, chunk)
    params = _pack(jinit(jax.random.PRNGKey(plen), jcfg), jcfg.quant)
    params_t = jax.tree.map(lambda a: convert.to_tensor(np.asarray(a), "cpu"), params)
    rng = np.random.default_rng(plen)
    xs = [rng.standard_normal((1, plen, jcfg.d_model)).astype(np.float32)]
    xs += [rng.standard_normal((1, 1, jcfg.d_model)).astype(np.float32) for _ in range(n_decode)]
    js, ts, steps = jstate(1, jcfg), tstate(1, tcfg, device="cpu"), []
    with jax.disable_jit():
        for x in xs:
            jo, js = jmix(params, jnp.asarray(x).astype(jnp.bfloat16), jcfg, "serve", js)
            to, ts = tmix(params_t, torch.from_numpy(x).to(torch.bfloat16), tcfg, ts)
            steps.append((np.asarray(jo.astype(jnp.float32)), to.float().numpy(),
                          {k: np.asarray(v) for k, v in js.items()},
                          {k: v.numpy().copy() for k, v in ts.items()}))
    return steps


def _check_mixer(kind: str, steps) -> None:
    state_leaf = MIXERS[kind][5]
    for i, (jo, to, js, ts) in enumerate(steps):
        when = "prefill" if i == 0 else f"decode {i}"
        assert _bits_equal(to, jo), f"{when}: bf16 output differs at {np.argwhere(to != jo)[:5].tolist()}"
        assert set(ts) == set(js)
        for key in js:
            if key == state_leaf:
                if kind == "r":
                    assert ts[key].dtype == js[key].dtype and _ulps(ts[key], js[key]).max() <= RGLRU_ULPS, when
                else:
                    _assert_rel(ts[key], js[key], SSD_RTOL, f"{when}: {key}")
            else:
                assert _bits_equal(ts[key], js[key]), f"{when}: state[{key!r}]"


@pytest.mark.parametrize("chunk,plen", [
    (16, 37),  # 3 chunks of 16, padded
    (16, 300),  # 19 chunks
    (128, 300),  # 3 chunks of 128, padded: the 16-block cumsum rewrite
    (128, 40),  # q = min(chunk, s) = 40
    (128, 1),  # a one-token prompt takes the decode branch
])
def test_ssd_mixer_prefill_then_decode(chunk, plen):
    _check_mixer("s", _run_mixer("s", "mamba2-130m", chunk, plen))


@pytest.mark.parametrize("plen", [1, 2, 7, 37, 300])
def test_rglru_mixer_prefill_then_decode(plen):
    _check_mixer("r", _run_mixer("r", "recurrentgemma-2b", None, plen))
