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

K3 (popcount_qmm) and K4 (bitserial_qmm) are integer: exact, against the
oracles and the reference's kernels in interpret mode; the ``pallas``
W1A1 and act x act branches and the plain ``popcount`` backend equal the
reference's bit for bit (same integer product, same epilogue order).

The CUDA kernels themselves run only on the card: see
``tests/test_torch_cuda.py``.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import flow_abstraction as JFA
from repro.core import packing as JP
from repro.core import qmm as JQE
from repro.core import quantization as JQ
from repro.core.quantization import QuantTensor as JQT
from repro.kernels import ops as JO
from repro.kernels import ref as JR
from repro_torch.core import flow_abstraction as TFA
from repro_torch.core import qmm as TQE
from repro_torch.core import quantization as TQ
from repro_torch.core.quantization import QuantTensor as TQT
from repro_torch.kernels import binary_qmm as TBQ
from repro_torch.kernels import bitserial_qmm as TBS
from repro_torch.kernels import fused_qmm as TFQ
from repro_torch.kernels import popcount_qmm as TPQ
from repro_torch.kernels import ops as TO
from repro_torch.kernels import ref as TR
from torch_port_fixtures import release_jax_caches  # noqa: F401  (autouse)

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
] + [  # the CUDA kernel's tile edges (M = 16 / 17, K past a word, N = 72) and odd plane counts
    (s, a, w) for s in ((16, 1000, 72), (17, 100, 33)) for a, w in ((8, 1), (3, 5), (1, 1))
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


def _packed_bits(shape, axis):
    bits = RNG.integers(0, 2, size=shape).astype(np.uint32)
    return np.asarray(JP.pack_bits(jnp.asarray(bits), 1, axis=axis))


@pytest.mark.parametrize("m,k,n", SHAPES + [(7, 100, 33), (4, 768, 3072)])
def test_popcount_qmm_plain_matches_oracle_and_interpret_kernel(m, k, n):
    ap, bp = _packed_bits((m, k), -1), _packed_bits((k, n), 0)
    want = np.asarray(JR.popcount_qmm_ref(jnp.asarray(ap), jnp.asarray(bp), k))
    if (m, k, n) in INTERPRET_SHAPES | {(7, 100, 33)}:
        kernel = JO.popcount_qmm_int(jnp.asarray(ap), jnp.asarray(bp), interpret=True)
        np.testing.assert_array_equal(np.asarray(kernel), want)
    ta, tb = _t(ap.view(np.int32)), _t(bp.view(np.int32))
    before = TPQ.popcount_qmm.launches
    got = TPQ.popcount_qmm(ta, tb)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(TR.popcount_qmm_ref(ta, tb, k).numpy(), want)
    # the plain popcount backend's core counts the same bits another way
    np.testing.assert_array_equal(TQE.and_popcount_matmul(ta, tb).numpy(), want)
    assert TPQ.popcount_qmm.launches == before  # CPU tensors take the plain path


def _planes_of(shape, bits, axis):
    mant = RNG.integers(0, 2**bits, size=shape).astype(np.uint32)
    return np.asarray(JP.pack_bitplanes(jnp.asarray(mant), bits, axis=axis))


@pytest.mark.parametrize("a_bits,b_bits", [(2, 2), (4, 4), (8, 8), (1, 4)])
@pytest.mark.parametrize("m,k,n", [(1, 32, 1), (7, 100, 33), (37, 300, 45)])
def test_bitserial_qmm_plain_matches_oracle_and_interpret_kernel(a_bits, b_bits, m, k, n):
    ap, bp = _planes_of((m, k), a_bits, -1), _planes_of((k, n), b_bits, -2)
    want = np.asarray(JO.bitserial_qmm_int(jnp.asarray(ap), jnp.asarray(bp), interpret=True))
    np.testing.assert_array_equal(
        np.asarray(JR.bitserial_qmm_ref(jnp.asarray(ap), jnp.asarray(bp), k)), want)
    ta, tb = _t(ap.view(np.int32)), _t(bp.view(np.int32))
    before = TBS.bitserial_qmm.launches
    got = TBS.bitserial_qmm(ta, tb)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(TR.bitserial_qmm_ref(ta, tb, k).numpy(), want)
    assert TBS.bitserial_qmm.launches == before


def test_bitserial_refuses_int32_overflow():
    """8 x 8 planes over K = 33,056 could sum past 2**31: refused, not wrapped."""
    kw = 1033
    a = torch.zeros(8, 1, kw, dtype=torch.int32)
    b = torch.zeros(8, kw, 1, dtype=torch.int32)
    with pytest.raises(ValueError, match="wrap"):
        TBS.bitserial_qmm(a, b)
    TBS.bitserial_qmm(a[:, :, :1032], b[:, :1032])  # 33,024 fits


def _quant_operands(m, k, n, x_bits, w_bits, packed_w):
    x = (RNG.standard_normal((m, k)) * 2).astype(np.float32)
    jx = JQ.quantize_activation(jnp.asarray(x), x_bits, per_channel_axis=0)
    tx = TQ.quantize_activation(_t(x), x_bits, per_channel_axis=0)
    if packed_w:
        return jx, tx, *_packed_weight((RNG.standard_normal((k, n)) * 0.1).astype(np.float32))
    y = (RNG.standard_normal((k, n)) * 2).astype(np.float32)
    jw = JQ.quantize_activation(jnp.asarray(y), w_bits, per_channel_axis=-1)
    tw = TQ.quantize_activation(_t(y), w_bits, per_channel_axis=-1)
    return jx, tx, jw, tw


def test_qmm_pallas_refuses_unported_branches():
    """No branch of ``qmm_pallas`` is refused any more: the W1A1 branch (K3)
    and the multi-bit act x act branch (K4), which raised before they were
    ported, run and equal the reference's ``qmm_pallas`` bit for bit."""
    for x_bits, w_bits, packed in ((1, 1, True), (1, 1, False), (4, 4, False), (1, 4, False)):
        jx, tx, jw, tw = _quant_operands(7, 100, 33, x_bits, w_bits, packed)
        want = np.asarray(JO.qmm_pallas(jx, jw, interpret=True))
        np.testing.assert_array_equal(TO.qmm_pallas(tx, tw).numpy(), want)


@pytest.mark.parametrize("x_bits,w_bits", [(1, 1), (2, 2), (4, 4), (8, 8), (1, 4)])
@pytest.mark.parametrize("m,k,n", [(1, 32, 1), (37, 300, 45), (8, 64, 128)])
def test_qmm_pallas_w1a1_and_act_act_exact_vs_reference(x_bits, w_bits, m, k, n):
    """K3 (1 x 1, packed binarized weights) and K4 (act x act) branches of the
    staged path: the reference applies its epilogue op by op outside the
    kernel, so the two agree bit for bit; the plain ``popcount`` backend
    equals both (same unsigned integer product, same epilogue)."""
    jx, tx, jw, tw = _quant_operands(m, k, n, x_bits, w_bits, packed_w=w_bits == 1)
    want = np.asarray(JO.qmm_pallas(jx, jw, interpret=True))
    np.testing.assert_array_equal(TO.qmm_pallas(tx, tw).numpy(), want)
    np.testing.assert_array_equal(TQE.qmm(tx, tw, backend="popcount").numpy(), want)


@pytest.mark.parametrize("x_bits,w_bits,packed_w", [
    (1, 1, True), (2, 1, True), (8, 1, True), (2, 2, False), (4, 4, False), (8, 8, False),
])
def test_popcount_backend_exact_vs_reference(x_bits, w_bits, packed_w):
    """``qmm(backend="popcount")``: plain AND-popcount over the raw unsigned
    planes under ``qmm_flow(recenter=False)``, with and without a given
    weight colsum, equal to the reference's popcount backend."""
    jx, tx, jw, tw = _quant_operands(37, 300, 45, x_bits, w_bits, packed_w)
    want = np.asarray(JQE.qmm(jx, jw, backend="popcount"))
    np.testing.assert_array_equal(TQE.qmm(tx, tw, backend="popcount").numpy(), want)
    if packed_w:
        jcol = JFA.weight_corrections(jw)
        tcol = TFA.weight_corrections(tw)
        np.testing.assert_array_equal(tcol.numpy(), np.asarray(jcol))
        want = np.asarray(JQE.qmm(jx, jw, backend="popcount", w_colsum=jcol))
        got = TQE.qmm(tx, tw, backend="popcount", w_colsum=tcol)
        np.testing.assert_array_equal(got.numpy(), want)


def test_popcount_backend_batched_act_act():
    """Rank-4 act x act (attention-shaped, batch and heads leading) through
    the plain popcount core, against the reference's."""
    x = (RNG.standard_normal((2, 3, 5, 40)) * 2).astype(np.float32)
    y = (RNG.standard_normal((2, 3, 40, 6)) * 2).astype(np.float32)
    jx = JQ.quantize_activation(jnp.asarray(x), 4)
    jy = JQ.quantize_activation(jnp.asarray(y), 4)
    tx = TQ.quantize_activation(_t(x), 4)
    ty = TQ.quantize_activation(_t(y), 4)
    want = np.asarray(JQE.qmm(jx, jy, backend="popcount"))
    np.testing.assert_array_equal(TQE.qmm(tx, ty, backend="popcount").numpy(), want)


def test_wrappers_validate_operands():
    a = torch.zeros(2, 64, dtype=torch.int8)
    with pytest.raises(ValueError):
        TBQ.binary_qmm(a, torch.zeros(3, 4, dtype=torch.int32), 64)  # 3 words != 2
    with pytest.raises(ValueError):
        TBQ.binary_qmm(a.to(torch.int32), torch.zeros(2, 4, dtype=torch.int32), 64)
    with pytest.raises(ValueError):
        TFQ.fused_qmm(torch.zeros(8, 2, 2, dtype=torch.int32), torch.zeros(1, 2, 4, dtype=torch.int32),
                      torch.ones(2, 1), torch.zeros(2, 1), torch.ones(4), torch.zeros(1, 4), 64)
    with pytest.raises(ValueError):
        TPQ.popcount_qmm(torch.zeros(2, 3, dtype=torch.int32), torch.zeros(2, 4, dtype=torch.int32))
    with pytest.raises(ValueError):
        TPQ.popcount_qmm(torch.zeros(2, 2, dtype=torch.int64), torch.zeros(2, 4, dtype=torch.int32))
    with pytest.raises(ValueError):
        TBS.bitserial_qmm(torch.zeros(9, 2, 2, dtype=torch.int32), torch.zeros(1, 2, 4, dtype=torch.int32))
    with pytest.raises(ValueError):
        TBS.bitserial_qmm(torch.zeros(2, 2, 2, dtype=torch.int32), torch.zeros(2, 3, 4, dtype=torch.int32))
