"""Pytest settings shared by the test files: marker registration only."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU and nvcc; skipped (from inside the test) without them",
    )
