"""Port quantization and flow abstraction vs the JAX reference.

Mantissas, colsums and integer products must be exact.  The float outputs
are compared exactly too: run eagerly, the reference evaluates each
operation on its own (no fusion, no fma contraction), and the port mirrors
its order, so the two agree bit for bit -- any difference at all is a
divergence of the port, not rounding noise.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import flow_abstraction as JFA
from repro.core import quantization as JQ
from repro_torch.core import flow_abstraction as TFA
from repro_torch.core import quantization as TQ
from torch_port_fixtures import release_jax_caches  # noqa: F401  (autouse)

RNG = np.random.default_rng(5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("shape", [(1, 64), (5, 100), (12, 4096)])
def test_quantize_activation_per_row_exact(bits, shape):
    x = (RNG.standard_normal(shape) * 3).astype(np.float32)
    j = JQ.quantize_activation(jnp.asarray(x), bits, per_channel_axis=0)
    t = TQ.quantize_activation(_t(x), bits, per_channel_axis=0)
    _eq(t.mantissa, j.mantissa)
    _eq(t.scale, j.scale)
    _eq(t.offset, j.offset)
    jr, tr = JQ.recenter(j), TQ.recenter(t)
    assert tr.mantissa.dtype == torch.int8
    _eq(tr.mantissa, jr.mantissa)
    _eq(tr.offset, jr.offset)


def test_quantize_activation_rounds_half_to_even():
    x = np.array([[0.0, 0.5, 1.5, 2.5, 3.0]], np.float32)
    t = TQ.quantize_activation(_t(x), 2, scale=torch.tensor(1.0), offset=torch.tensor(0.0))
    assert t.mantissa.tolist() == [[0, 0, 2, 2, 3]]


# Every reduction width of the served configs (bit-bert-base 768 / 3072,
# granite-8b 4096 / 14336), and widths that are not a multiple of 32 at some
# level of the window sum, where the reference pads a level at both ends
# (1056: an odd pad of 31).
@pytest.mark.parametrize(
    "k,n",
    [(32, 5), (64, 48), (128, 16), (768, 8), (3072, 8), (4096, 8), (14336, 8)]
    + [(k, 8) for k in (100, 1000, 1056, 1408, 1536, 2560, 5376, 7680, 10944)],
)
def test_binarize_weight_exact(k, n):
    """Scales too: the port sums |w| in the reference's compiled order."""
    w = (RNG.standard_normal((k, n)) * 0.05).astype(np.float32)
    j = JQ.binarize_weight(jnp.asarray(w))
    t = TQ.binarize_weight(_t(w))
    _eq(t.mantissa, j.mantissa)
    _eq(t.scale, j.scale)
    _eq(t.offset, j.offset)
    _eq(TFA.weight_corrections(t), JFA.weight_corrections(j))
    jp, tp = j.pack(axis=0), t.pack(axis=0)
    np.testing.assert_array_equal(tp.mantissa.numpy().view(np.uint32), np.asarray(jp.mantissa))


@pytest.mark.parametrize("act_bits", [2, 4, 8])
@pytest.mark.parametrize("m,k,n", [(1, 64, 16), (9, 96, 33), (16, 256, 64)])
def test_qmm_flow_act_weight_exact(act_bits, m, k, n):
    x = (RNG.standard_normal((m, k)) * 2).astype(np.float32)
    w = (RNG.standard_normal((k, n)) * 0.1).astype(np.float32)
    jx = JQ.quantize_activation(jnp.asarray(x), act_bits, per_channel_axis=0)
    tx = TQ.quantize_activation(_t(x), act_bits, per_channel_axis=0)
    jw = JQ.binarize_weight(jnp.asarray(w)).pack(axis=0)
    tw = TQ.binarize_weight(_t(w)).pack(axis=0)
    jcol = JFA.weight_corrections(jw)
    want = JFA.qmm_flow(jx, jw, w_colsum=jcol)
    _eq(TFA.qmm_flow(tx, tw, w_colsum=TFA.weight_corrections(tw)), want)
    _eq(TFA.qmm_flow(tx, tw), want)


def test_qmm_flow_act_act_batched_exact():
    """Act x act with per-tensor scales over a batch dim (attention's shape)."""
    a = (RNG.standard_normal((2, 5, 24)) * 2).astype(np.float32)
    b = (RNG.standard_normal((2, 24, 7)) * 2).astype(np.float32)
    ja, jb = JQ.quantize_activation(jnp.asarray(a), 8), JQ.quantize_activation(jnp.asarray(b), 8)
    ta, tb = TQ.quantize_activation(_t(a), 8), TQ.quantize_activation(_t(b), 8)
    _eq(TFA.qmm_flow(ta, tb), JFA.qmm_flow(ja, jb))


@pytest.mark.parametrize("x_bits,y_bits,k", [(8, 1, 300), (8, 8, 70000)])
def test_default_int_matmul_exact(x_bits, y_bits, k):
    """int32 accumulation; the second case passes _INT32_SAFE and takes the
    chunked path whose partials combine in float32."""
    lo = -(2 ** (x_bits - 1))
    x = RNG.integers(lo, -lo, size=(3, k)).astype(np.int8)
    ylo = -(2 ** (y_bits - 1)) if y_bits > 1 else 0
    y = RNG.integers(ylo, max(-ylo, 2), size=(k, 2)).astype(np.int8)
    want = JFA.default_int_matmul(jnp.asarray(x), jnp.asarray(y), x_bits, y_bits)
    got = TFA.default_int_matmul(_t(x), _t(y), x_bits, y_bits)
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    _eq(got, want)


def test_exact_int_matmul_rejects_unsafe_bound():
    with pytest.raises(ValueError):
        TFA.exact_int_matmul(torch.zeros(1, 1), torch.zeros(1, 1), 2**54)
