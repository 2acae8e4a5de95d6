"""A pytest plugin that keeps test workers under the kernel's limit on
memory mappings: after the last test of every module, it drops JAX's
caches.

Each executable XLA compiles on the CPU keeps its own memory mappings until
its cache entry goes, and a process may hold at most ``vm.max_map_count``
of them (65,530 here); past it, the next compile crashes the worker, and
pytest-xdist then waits for it until the run's time limit.
``tests/test_serve_robustness.py`` alone climbs to ~56,400 mappings, so a
worker that reaches it holding more than ~9,000 crashes -- as one did after
``tests/test_binary_attention.py`` (25,782) and would after
``tests/test_arch_smoke.py`` (24,321) -- and which modules share a worker
changes with every test file added.  Dropping the caches changes no
result: a later call compiles again.

Loaded by ``pytest_plugins = ["jax_map_guard"]`` in a test module; every
xdist worker collects every module, so it is active on each before any
test runs.
"""

import sys

import pytest


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_teardown(item, nextitem):
    yield
    jax = sys.modules.get("jax")
    if jax is not None and (nextitem is None or nextitem.module is not item.module):
        jax.clear_caches()
