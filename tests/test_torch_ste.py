"""The port's straight-through quantizers (``repro_torch.core.quantization``:
``ste_round``, ``fake_quant``, ``fake_binarize_weight``) against the
reference's, run op by op (``jax.disable_jit``): values bit for bit and
gradients (``jax.vjp``) bit for bit, at 1 / 2 / 4 / 8 bits on float32 and
bf16.

Every input puts elements on both clip bounds: the tensor's minimum and
maximum are its own calibration bounds, and ``jnp.clip`` passes half the
gradient at a tie (``torch.clamp`` would pass all of it), so a wrong
clip shows in two elements of every case.  Inputs with repeated extremes
and a constant tensor (scale at its 1e-8 floor) are cases too."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantization as JQ
from repro_torch.core import quantization as TQ
from torch_port_fixtures import release_jax_caches  # noqa: F401  (autouse)

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _vjp_ref(fn, x, g):
    with jax.disable_jit():
        y, vjp = jax.vjp(fn, x)
        (dx,) = vjp(g)
    return _np(y), _np(dx)


def _vjp_port(fn, x, g):
    x = x.detach().requires_grad_(True)
    y = fn(x)
    (dx,) = torch.autograd.grad(y, x, g)
    return y.detach().float().numpy(), dx.float().numpy()


def _inputs(kind: str, shape, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    if kind == "repeated_extremes":
        x.reshape(-1)[:3] = x.min()
        x.reshape(-1)[3:5] = x.max()
    elif kind == "constant":
        x[...] = 0.75
    return x


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("kind", ["normal", "repeated_extremes", "constant"])
def test_fake_quant_bitwise(bits, dtype, kind):
    jdt, tdt = DTYPES[dtype]
    x = _inputs(kind, (3, 7, 64), seed=bits)
    g = np.random.default_rng(100 + bits).standard_normal(x.shape).astype(np.float32)
    want_y, want_dx = _vjp_ref(lambda a: JQ.fake_quant(a, bits), jnp.asarray(x, jdt), jnp.asarray(g, jdt))
    got_y, got_dx = _vjp_port(lambda a: TQ.fake_quant(a, bits), torch.from_numpy(x).to(tdt),
                              torch.from_numpy(g).to(tdt))
    np.testing.assert_array_equal(got_y, want_y)
    np.testing.assert_array_equal(got_dx, want_dx)
    if kind == "normal":
        # the halved gradient at the two bound ties is part of the reference
        xs = _np(jnp.asarray(x, jdt))
        tie = (xs == xs.min()) | (xs == xs.max())
        assert tie.sum() >= 2
        np.testing.assert_array_equal(got_dx[tie], _np(jnp.asarray(g, jdt))[tie] * 0.5)


@pytest.mark.parametrize("shape", [(64, 48), (100, 33), (768, 96), (3, 40, 8)])
def test_fake_binarize_weight_bitwise(shape):
    """Zeros (+0 and -0) binarize to +1; alpha is the reference's ordered
    mean over axis -2 (K = 100 pads its reduction levels), detached, and
    the gradient is ``g * alpha``."""
    rng = np.random.default_rng(shape[-2])
    w = rng.standard_normal(shape).astype(np.float32)
    w.reshape(-1)[:4] = [0.0, -0.0, 0.0, -0.0]
    g = rng.standard_normal(shape).astype(np.float32)
    want_y, want_dx = _vjp_ref(JQ.fake_binarize_weight, jnp.asarray(w), jnp.asarray(g))
    got_y, got_dx = _vjp_port(TQ.fake_binarize_weight, torch.from_numpy(w), torch.from_numpy(g))
    np.testing.assert_array_equal(got_y, want_y)
    np.testing.assert_array_equal(got_dx, want_dx)
    assert np.all(np.sign(got_y.reshape(-1)[:4]) == 1)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_ste_round_value_and_identity_gradient(dtype):
    """``x + (round(x) - x)``, half to even, with an identity gradient."""
    jdt, tdt = DTYPES[dtype]
    x = np.concatenate([np.arange(-4, 4.5, 0.5), np.random.default_rng(0).standard_normal(47) * 40])
    x = x.astype(np.float32)
    g = np.random.default_rng(1).standard_normal(x.shape).astype(np.float32)
    want_y, want_dx = _vjp_ref(JQ.ste_round, jnp.asarray(x, jdt), jnp.asarray(g, jdt))
    got_y, got_dx = _vjp_port(TQ.ste_round, torch.from_numpy(x).to(tdt), torch.from_numpy(g).to(tdt))
    np.testing.assert_array_equal(got_y, want_y)
    np.testing.assert_array_equal(got_dx, want_dx)
    np.testing.assert_array_equal(got_dx, _np(jnp.asarray(g, jdt)))


def test_fake_quant_matches_serving_quantizer_grid():
    """The train-mode forward lands on the serving quantizer's grid: its
    value is ``q * scale + offset`` of ``quantize_activation``'s per-tensor
    mantissa."""
    x = torch.from_numpy(_inputs("normal", (5, 64), seed=3))
    for bits in (1, 2, 4, 8):
        q = TQ.quantize_activation(x, bits)
        torch.testing.assert_close(TQ.fake_quant(x, bits), q.mantissa.float() * q.scale + q.offset,
                                   rtol=0, atol=1e-6)
