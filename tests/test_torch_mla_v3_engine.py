"""The port's ``ServeEngine`` against the reference's on deepseek-v3-671b's
smoke variant (q-LoRA queries, three dense prefix layers, the sigmoid
router): the check of ``tests/test_torch_mla_engine.py``, in a file of its
own so the two run side by side under ``--dist loadfile``."""

import pytest

from test_torch_mla_engine import engine_vs_reference_engine
from test_torch_mla_family import build
from torch_port_fixtures import release_jax_caches  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def model():
    return build("deepseek-v3-671b")


def test_engine_equals_reference_engine(model):
    engine_vs_reference_engine(model)
