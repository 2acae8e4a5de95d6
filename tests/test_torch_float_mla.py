"""The latent (MLA) cache in bf16 against the reference run op by op, on
the deepseek-v2-lite smoke model (CPU): ``kv_cache_bits=16`` under W1A8
linears, and ``FLOAT_QUANT`` (bf16 weights, the float MoE experts, the
float absorbed decode).  ``FLOAT_QUANT``'s bf16 leaves are held to 1 bf16
ulp: its absorbed decode's float32 einsums sum in another order than XLA's
(ROADMAP section 3); greedy tokens exactly."""

import pytest
import torch

from test_torch_float_serving import run_op_by_op
from torch_port_fixtures import release_jax_caches  # noqa: F401  (autouse)


@pytest.mark.parametrize("name", ["deepseek-kv16", "deepseek-float"])
def test_latent_cache_leaves_and_greedy_tokens_op_by_op(name):
    tc = run_op_by_op(name)
    for layer in tc["layers"]:
        assert layer["ckv"].dtype == torch.bfloat16 and "ckv_scale" not in layer
