# ruff: noqa
"""Known-bad lint fixture (PyTorch): every rule of
``repro_torch.analysis.lint`` must fire at least once on this file.

Never imported -- parsed only.  Lives outside ``src/repro_torch`` so the
port's lint sweep never sees it.  tests/test_torch_analysis_lint.py and the
CLI ``--self-test`` assert each rule id below is detected.
"""

import time

import numpy as np
import torch


def bad_rng001():
    np.random.seed(0)  # RNG001: global process-wide NumPy RNG state
    return np.random.randn(4)  # RNG001


def bad_rng002(x):
    torch.manual_seed(42)  # RNG002: seeds the global torch RNG
    x.normal_()  # RNG002: draws from the global RNG
    return torch.randn(4)  # RNG002: no generator=


def bad_time001(step, x):
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        t0 = time.perf_counter()  # TIME001: runs once, at capture; a replay never reads it
        y = step(x)
    return y, t0


def bad_trace001(x):
    if torch.any(x > 0):  # TRACE001: a host sync on a tensor reduction
        return x
    while x.max().item() < 1.0:  # TRACE001: .item() syncs and breaks capture
        x = x * 2
    return x


def bad_dtype001(x):
    return x.to(torch.bfloat16)  # DTYPE001: hardcoded low-precision literal


def bad_mut001(x, acc=[]):  # MUT001: mutable default
    acc.append(x)
    return acc


def bad_mut001_kw(x, *, table={}):  # MUT001 (kw-only default)
    return table.get(x)
