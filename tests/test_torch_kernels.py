"""The port's kernel modules vs the JAX reference.

On the CPU each wrapper runs its kernel's plain version, so these tests
hold the plain versions (``repro_torch.kernels.ref``) and the QuantTensor
entry points (``repro_torch.kernels.ops``) against the reference oracles
(``repro.kernels.ref``) and the reference's Pallas kernels in interpret
mode.  K1 (binary_qmm) is integer: exact.  K2 (fused_qmm) is bit-exact
under dyadic scales, where every epilogue term is exactly representable
(the contract of tests/test_fused_qmm.py); with real quantizer scales the
reference compiles its epilogue with fma contraction, so there the
agreement is to a few float32 ulps of the largest epilogue term.

The CUDA kernels themselves run only on the card: see
``tests/test_torch_cuda.py``.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import packing as JP
from repro.core import quantization as JQ
from repro.core.quantization import QuantTensor as JQT
from repro.kernels import ops as JO
from repro.kernels import ref as JR
from repro_torch.core import quantization as TQ
from repro_torch.core.quantization import QuantTensor as TQT
from repro_torch.kernels import binary_qmm as TBQ
from repro_torch.kernels import fused_qmm as TFQ
from repro_torch.kernels import ops as TO
from repro_torch.kernels import ref as TR

RNG = np.random.default_rng(11)
# M=1 (one live decode slot), block-aligned, ragged everything
SHAPES = [(1, 32, 1), (4, 64, 48), (128, 512, 128), (37, 300, 45), (130, 513, 129)]
# where the reference's Pallas kernel also runs (interpret mode compiles for
# seconds per shape, and tests/test_kernels.py sweeps it against the oracle)
INTERPRET_SHAPES = {(1, 32, 1), (37, 300, 45)}


def _t(a):
    return torch.from_numpy(np.array(a))


def _packed_weight(w):
    """Binarize + pack in the reference, and hand the port the same words and
    coefficients (the scale's sum order matches the reference only where K
    is a multiple of 32; this keeps ragged-K tests about the kernel path)."""
    jw = JQ.binarize_weight(jnp.asarray(w)).pack(axis=0)
    tw = TQT(mantissa=_t(np.asarray(jw.mantissa).view(np.int32)), scale=_t(jw.scale),
             offset=_t(jw.offset), bits=1, packed=True, packed_axis=0, length=w.shape[0])
    return jw, tw


def _k1_operands(m, k, n):
    a = RNG.integers(-128, 128, size=(m, k)).astype(np.int8)
    wbits = RNG.integers(0, 2, size=(k, n)).astype(np.uint32)
    wp = np.asarray(JP.pack_bits(jnp.asarray(wbits), 1, axis=0))
    return a, wp


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_binary_qmm_plain_matches_oracle_and_interpret_kernel(m, k, n):
    a, wp = _k1_operands(m, k, n)
    want = np.asarray(JR.binary_qmm_ref(jnp.asarray(a), jnp.asarray(wp), k))
    if (m, k, n) in INTERPRET_SHAPES:
        kernel = JO.binary_qmm_int(jnp.asarray(a), jnp.asarray(wp), k, interpret=True)
        np.testing.assert_array_equal(np.asarray(kernel), want)
    before = TBQ.binary_qmm.launches
    got = TBQ.binary_qmm(_t(a), _t(wp.view(np.int32)), k)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(TR.binary_qmm_ref(_t(a), _t(wp.view(np.int32)), k).numpy(), want)
    assert TBQ.binary_qmm.launches == before  # CPU tensors take the plain path


def _dyadic(shape, bits, scale_shape):
    mant = RNG.integers(0, 2**bits, size=shape).astype(np.uint8)
    scale = (2.0 ** RNG.integers(-4, 3, size=scale_shape)).astype(np.float32)
    offset = (-scale * (2 ** (bits - 1))).astype(np.float32)
    j = JQT(mantissa=jnp.asarray(mant), scale=jnp.asarray(scale), offset=jnp.asarray(offset), bits=bits)
    t = TQT(mantissa=_t(mant), scale=_t(scale), offset=_t(offset), bits=bits)
    return j, t


def _planes(j, bits, axis):
    return np.asarray(JP.pack_bitplanes(j.mantissa.astype(jnp.uint32), bits, axis=axis))


# W1A8 (the serving mode) over every shape; W1A4 and A8xA8 where the
# reference's interpret-mode kernel stays cheap
FUSED_CASES = [(s, 8, 1) for s in SHAPES] + [
    (s, a, w) for s in SHAPES[:2] + SHAPES[3:4] for a, w in ((4, 1), (8, 8))
]


@pytest.mark.parametrize("shape,act_bits,weight_bits", FUSED_CASES)
def test_fused_qmm_plain_bit_exact_under_dyadic_scales(shape, act_bits, weight_bits):
    m, k, n = shape
    jx, tx = _dyadic((m, k), act_bits, (m, 1))
    jw, tw = _dyadic((k, n), weight_bits, (1, n))
    ap, bp = _planes(jx, act_bits, -1), _planes(jw, weight_bits, -2)
    args = [jx.scale, jx.offset, jw.scale, jw.offset]
    want = np.asarray(JR.fused_qmm_ref(jnp.asarray(ap), jnp.asarray(bp), *args, k))
    if shape in INTERPRET_SHAPES and weight_bits == 1:
        np.testing.assert_array_equal(np.asarray(JO.qmm_fused(jx, jw, interpret=True)), want)
    targs = [_t(np.asarray(a)) for a in args]
    before = TFQ.fused_qmm.launches
    got = TFQ.fused_qmm(_t(ap.view(np.int32)), _t(bp.view(np.int32)), *targs, k)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(TO.qmm_fused(tx, tw).numpy(), want)
    assert TFQ.fused_qmm.launches == before


@pytest.mark.parametrize("m,k,n", [(1, 64, 16), (37, 300, 45)])
def test_fused_packed_weight_path_real_scales(m, k, n):
    """The serving shape of the fused backend: per-token quantized acts,
    packed binarized weights with real (non-dyadic) scales."""
    x = (RNG.standard_normal((m, k)) * 2).astype(np.float32)
    w = (RNG.standard_normal((k, n)) * 0.1).astype(np.float32)
    jx = JQ.quantize_activation(jnp.asarray(x), 8, per_channel_axis=0)
    tx = TQ.quantize_activation(_t(x), 8, per_channel_axis=0)
    jw, tw = _packed_weight(w)
    want = np.asarray(JO.qmm_fused(jx, jw, interpret=True))
    got = TO.qmm_fused(tx, tw).numpy()
    # |terms| bound the fma-vs-rounded-product difference of the epilogue
    terms = np.abs(np.asarray(JO.qmm_pallas(jx, jw, interpret=True))).max() + 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=8 * np.finfo(np.float32).eps * terms * k**0.5)
    # and the port's two kernel paths agree with each other to the same bound
    np.testing.assert_allclose(got, TO.qmm_pallas(tx, tw).numpy(), rtol=0,
                               atol=8 * np.finfo(np.float32).eps * terms * k**0.5)


@pytest.mark.parametrize("act_bits", [2, 4, 8])
@pytest.mark.parametrize("m,k,n", [(1, 32, 1), (37, 300, 45), (8, 128, 256)])
def test_qmm_pallas_exact_vs_reference(act_bits, m, k, n):
    """Staged path: K1 integer product + epilogue.  The reference applies the
    epilogue op by op outside its kernel, so the two agree bit for bit."""
    x = (RNG.standard_normal((m, k)) * 2).astype(np.float32)
    w = (RNG.standard_normal((k, n)) * 0.1).astype(np.float32)
    jx = JQ.quantize_activation(jnp.asarray(x), act_bits, per_channel_axis=0)
    tx = TQ.quantize_activation(_t(x), act_bits, per_channel_axis=0)
    jw, tw = _packed_weight(w)
    want = np.asarray(JO.qmm_pallas(jx, jw, interpret=True))
    np.testing.assert_array_equal(TO.qmm_pallas(tx, tw).numpy(), want)


def test_qmm_pallas_refuses_unported_branches():
    t = TQT(mantissa=torch.zeros(2, 32, dtype=torch.uint8), scale=torch.tensor(1.0),
            offset=torch.tensor(0.0), bits=1)
    w = TQT(mantissa=torch.zeros(32, 4, dtype=torch.uint8), scale=torch.tensor(1.0),
            offset=torch.tensor(0.0), bits=1)
    with pytest.raises(NotImplementedError, match="popcount_qmm"):
        TO.qmm_pallas(t, w)


def test_wrappers_validate_operands():
    a = torch.zeros(2, 64, dtype=torch.int8)
    with pytest.raises(ValueError):
        TBQ.binary_qmm(a, torch.zeros(3, 4, dtype=torch.int32), 64)  # 3 words != 2
    with pytest.raises(ValueError):
        TBQ.binary_qmm(a.to(torch.int32), torch.zeros(2, 4, dtype=torch.int32), 64)
    with pytest.raises(ValueError):
        TFQ.fused_qmm(torch.zeros(8, 2, 2, dtype=torch.int32), torch.zeros(1, 2, 4, dtype=torch.int32),
                      torch.ones(2, 1), torch.zeros(2, 1), torch.ones(4), torch.zeros(1, 4), 64)
