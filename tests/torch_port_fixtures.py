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

The same fixture keeps what those modules compile on disk while they run
(JAX's persistent compilation cache under ``build/``, every executable
however quick to compile), so an operation
the reference runs op by op at a shape another port module has run is
read back instead of compiled again, in any test worker.  A cached
executable is the one XLA compiled: no result changes.  Outside these
modules (the reference package's own tests) the cache is off, as JAX
leaves it.
"""

from pathlib import Path

import jax
import pytest
from jax._src import compilation_cache

CACHE_DIR = Path(__file__).resolve().parents[1] / "build" / "jax-compile-cache"
_ON = {
    "jax_compilation_cache_dir": str(CACHE_DIR),
    "jax_persistent_cache_min_compile_time_secs": 0.0,
    "jax_persistent_cache_min_entry_size_bytes": 0,
    "jax_enable_compilation_cache": True,
}
_OFF = {name: jax.config.values[name] for name in _ON}


def _persistent_cache(settings: dict) -> None:
    for name, value in settings.items():
        jax.config.update(name, value)
    compilation_cache.reset_cache()


@pytest.fixture(scope="module", autouse=True)
def release_jax_caches():
    _persistent_cache(_ON)
    yield
    jax.clear_caches()
    _persistent_cache(_OFF)
