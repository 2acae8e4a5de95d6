"""Fixtures shared by the port's parity tests (``tests/test_torch_*.py``).

``release_jax_caches``: the parity tests run the JAX reference, often op by
op, and each executable XLA compiles on the CPU keeps its own memory
mappings until its cache entry goes.  A test worker that runs several such
modules and then a compile-heavy reference test passes the kernel's limit
on mappings (``vm.max_map_count``, 65,530 here) and the next compile
crashes the worker (seen in ``tests/test_serve_robustness.py``'s SIGKILL
test after ``tests/test_torch_bitbert.py``, 55,243 mappings before it).
Each module that imports this fixture drops the executables it compiled
when it ends.
"""

import jax
import pytest


@pytest.fixture(scope="module", autouse=True)
def release_jax_caches():
    yield
    jax.clear_caches()
