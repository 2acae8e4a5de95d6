"""Known-good lint fixture (PyTorch): the clean counterpart of every
lint_bad.py hit.

The lint pass must report ZERO findings here -- each function shows the
idiom the rule's fix hint prescribes.
"""

import time

import numpy as np
import torch


def good_rng001(seed):
    rng = np.random.default_rng(seed)  # explicit Generator, no global state
    return rng.standard_normal(4)


def good_rng002(seed, x):
    gen = torch.Generator()
    gen.manual_seed(seed)  # a generator of its own, threaded from the caller
    x.normal_(generator=gen)
    return torch.randn(4, generator=gen)


def good_rng002_meta():
    # shape-only: a draw on the meta device produces no values (exempt)
    return torch.randn((4, 4), device="meta")


def good_time001(step, x):
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        y = step(x)
    t0 = time.perf_counter()  # the caller owns the clock, around replays
    g.replay()
    return y, time.perf_counter() - t0


def good_trace001(x):
    return torch.where(torch.any(x > 0), x, x * 2)  # a device select, no host branch


def good_dtype001(x, cache):
    return x.to(cache["k"].dtype)  # dtype derives from the target leaf


def good_mut001(x, acc=None):
    if acc is None:
        acc = []
    acc.append(x)
    return acc
