"""The public names the port lacked beside its reference modules, held to
the reference on the CPU: the config counts and ``InputShape`` grid
(``configs/base.py``), ``dequantize`` (``core/quantization.py``), the naive
flow and op counts (``core/flow_abstraction.py``), and the registry's
``traffic_model`` capability with ``register_backend`` / ``unregister`` /
``backend_specs`` (``core/backend_registry.py``), and ``layernorm``
(``models/layers.py``).  Counts and traffic are integers and equal
exactly; the naive flow's float32 product and layernorm's float32 means sum
in another order than XLA's, and are held to 1e-5 and 1e-6 of their
scale."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as JB
from repro.configs import get_config as j_get_config
from repro.configs import list_configs as j_list_configs
from repro.configs.smoke import smoke_variant as j_smoke
from repro.core import backend_registry as JBR
from repro.core import flow_abstraction as JFA
from repro.core import quantization as JQ
from repro.models import layers as JL
from repro_torch.configs import base as B
from repro_torch.configs import get_config
from repro_torch.configs.smoke import smoke_variant
from repro_torch.core import backend_registry as BR
from repro_torch.core import flow_abstraction as FA
from repro_torch.core import quantization as Q
from repro_torch.models import layers as L
from torch_port_fixtures import release_jax_caches  # noqa: F401  (autouse)

CONFIGS = j_list_configs()


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("name", CONFIGS)
def test_config_counts_equal_reference(name, smoke):
    want, got = j_get_config(name), get_config(name)
    if smoke:
        want, got = j_smoke(want), smoke_variant(got)
    assert got.param_count() == want.param_count()
    assert got.active_param_count() == want.active_param_count()
    assert got._ffn_params(got.d_ff) == want._ffn_params(want.d_ff)
    assert got.has_decoder == want.has_decoder
    assert got.is_sub_quadratic == want.is_sub_quadratic
    assert got.quant.mode_name == want.quant.mode_name


def test_input_shapes_equal_reference():
    assert [dataclasses.astuple(s) for s in B.LM_SHAPES] == [dataclasses.astuple(s) for s in JB.LM_SHAPES]
    assert {k: dataclasses.astuple(v) for k, v in B.SHAPES_BY_NAME.items()} == {
        k: dataclasses.astuple(v) for k, v in JB.SHAPES_BY_NAME.items()}
    assert B.InputShape("x", 8, 2, "decode") == B.InputShape("x", 8, 2, "decode")


GRID = [(1, 1, 1), (8, 64, 64), (7, 100, 33), (128, 768, 3072), (4, 4096, 14336)]


@pytest.mark.parametrize("m,k,n", GRID)
def test_op_counts_equal_reference(m, k, n):
    assert FA.op_counts_naive(m, k, n) == JFA.op_counts_naive(m, k, n)
    for static in (True, False):
        assert FA.op_counts_abstracted(m, k, n, weight_static=static) == JFA.op_counts_abstracted(
            m, k, n, weight_static=static)


def _operands(bits: int, seed: int):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((8, 96)).astype(np.float32)
    w = rng.standard_normal((96, 40)).astype(np.float32)
    return x, w


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_dequantize_bitwise(bits):
    x, w = _operands(bits, 10 + bits)
    got = Q.quantize_activation(torch.from_numpy(x), bits)
    want = JQ.quantize_activation(jnp.asarray(x), bits)
    np.testing.assert_array_equal(got.dequantize().numpy(), np.asarray(want.dequantize()))
    np.testing.assert_array_equal(Q.dequantize(got).numpy(), np.asarray(JQ.dequantize(want)))
    # a packed binarized weight (unpacked first) and a multi-bit one
    gw, jw = Q.binarize_weight(torch.from_numpy(w)).pack(axis=0), JQ.binarize_weight(jnp.asarray(w)).pack(axis=0)
    np.testing.assert_array_equal(gw.dequantize().numpy(), np.asarray(jw.dequantize()))
    gw, jw = Q.quantize_weight(torch.from_numpy(w), bits), JQ.quantize_weight(jnp.asarray(w), bits)
    np.testing.assert_array_equal(gw.dequantize().numpy(), np.asarray(jw.dequantize()))


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_qmm_dequant_reference_matches(bits):
    x, w = _operands(bits, 20 + bits)
    got = FA.qmm_dequant_reference(Q.quantize_activation(torch.from_numpy(x), bits),
                                   Q.binarize_weight(torch.from_numpy(w)))
    want = np.asarray(JFA.qmm_dequant_reference(JQ.quantize_activation(jnp.asarray(x), bits),
                                                JQ.binarize_weight(jnp.asarray(w))))
    assert got.dtype == torch.float32 and got.shape == want.shape
    scale = float(np.abs(want).max())
    assert float(np.abs(got.numpy() - want).max()) <= 1e-5 * scale
    # act x act, both operands activations
    y = np.random.default_rng(bits).standard_normal((96, 12)).astype(np.float32)
    got = FA.qmm_dequant_reference(Q.quantize_activation(torch.from_numpy(x), bits),
                                   Q.quantize_activation(torch.from_numpy(y), bits))
    want = np.asarray(JFA.qmm_dequant_reference(JQ.quantize_activation(jnp.asarray(x), bits),
                                                JQ.quantize_activation(jnp.asarray(y), bits)))
    assert float(np.abs(got.numpy() - want).max()) <= 1e-5 * float(np.abs(want).max())


SHARED = [n for n in BR.backend_names() if n in JBR.backend_names()]
TRAFFIC_SHAPES = [(1, 1, 1), (4, 4096, 14336), (128, 768, 3072), (7, 100, 33), (1536, 64, 128)]
PRECISIONS = [(1, 1), (2, 1), (4, 1), (8, 1), (4, 4), (8, 8), (1, 4)]


def test_every_backend_is_shared_and_modelled():
    assert set(BR.backend_names()) == set(JBR.backend_names())
    assert all(s.traffic_model is not None for s in BR.backend_specs())


@pytest.mark.parametrize("name", SHARED)
def test_traffic_models_equal_reference(name):
    mine, theirs = BR.get_backend(name).traffic_model, JBR.get_backend(name).traffic_model
    for m, k, n in TRAFFIC_SHAPES:
        for ab, wb in PRECISIONS:
            got, want = mine(m, k, n, ab, wb), theirs(m, k, n, ab, wb)
            assert isinstance(got, int) and got == want, (name, m, k, n, ab, wb, got, want)


def test_register_backend_and_unregister():
    @BR.register_backend("tmp-gap", description="a test backend", rank2_only=True,
                         traffic_model=lambda m, k, n, ab, wb: 7)
    def run(x, w, *, w_colsum=None, out_dtype=torch.float32):
        return None

    try:
        spec = BR.get_backend("tmp-gap")
        assert spec.run is run and spec.rank2_only and spec.traffic_model(1, 1, 1, 1, 1) == 7
        assert spec in BR.backend_specs() and "tmp-gap" in B.QuantConfig.known_backends()
        with pytest.raises(ValueError, match="already registered"):
            BR.register_backend("tmp-gap")(run)
    finally:
        BR.unregister("tmp-gap")
    assert "tmp-gap" not in BR.backend_names()
    BR.unregister("tmp-gap")  # absent: a no-op
    assert [s.name for s in BR.backend_specs()] == list(BR.backend_names())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_reference(dtype):
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((4, 7, 96)) * 3 + 1).astype(np.float32)
    g, b = rng.standard_normal(96).astype(np.float32), rng.standard_normal(96).astype(np.float32)
    jx = jnp.asarray(x, dtype=getattr(jnp, dtype))
    want = np.asarray(JL.layernorm({"g": jnp.asarray(g), "b": jnp.asarray(b)}, jx).astype(jnp.float32))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = L.layernorm({"g": torch.from_numpy(g), "b": torch.from_numpy(b)}, tx)
    assert got.dtype == tx.dtype
    scale = float(np.abs(want).max())
    # bf16 results round from float32 values that agree to 1e-6: at most one bf16 ulp
    tol = 1e-6 * scale if dtype == "float32" else 2.0 ** -7 * scale
    assert float(np.abs(got.float().numpy() - want).max()) <= tol
