"""gemma3-27b's sliding-window (``"l"``) layers through the port against
the JAX reference, on the reference's own params of the smoke variant
(window W = 8; checks as in ``tests/test_torch_dense_families.py``, which
holds its case of a prompt longer than the window).

Cases (prompt length, decode steps, ``max_len``):

* a prompt shorter than the window, decoded across it: positions 5..9
  write ring rows 5, 6, 7, 0, 1;
* a prompt equal to the window, which fills the ring exactly; decode
  overwrites rows 0 and 1;
* ``max_len`` equal to the window: still a ring (the reference's test is
  ``window_size == cache rows``);
* ``max_len`` below the window: the clipped local layer, ``max_len`` rows
  written at their positions and masked to the window.

Then 12 greedy steps against the compiled reference, the ring's layer-0
cursor, and the ring's slot arithmetic against a plain model of it.
"""

import numpy as np
import pytest
import torch

from repro_torch.models import attention as TA
from repro_torch.models import model_zoo as TZ
from test_torch_dense_families import (  # noqa: F401  (``models`` is a fixture)
    W,
    check_caches,
    check_geometry,
    check_logits,
    greedy_vs_compiled,
    models,
    run_op_by_op,
)
from torch_port_fixtures import release_jax_caches  # noqa: F401  (autouse)

CASES = {
    "ring-short-prompt-wraps": (5, 5, 32),
    "ring-prompt-equals-window": (8, 2, 32),
    "ring-max-len-equals-window": (5, 3, W),
    "clipped-local-layer": (5, 2, 7),
}


@pytest.fixture(scope="module", params=list(CASES), ids=list(CASES))
def op_by_op(request, models):  # noqa: F811
    return run_op_by_op(models("gemma3-27b"), *CASES[request.param])


def test_kv_cache_bit_identical_to_op_by_op_reference(op_by_op):
    check_caches(op_by_op)


def test_logits_match_op_by_op_reference(op_by_op):
    check_logits(op_by_op)


def test_cache_geometry_and_cursors(op_by_op):
    check_geometry(op_by_op)


def test_greedy_decode_and_logits_vs_compiled_reference(models):  # noqa: F811
    greedy_vs_compiled(models("gemma3-27b"))


def test_layer_zero_is_local_and_its_cursor_absolute(models):  # noqa: F811
    """Decode positions come from layer 0's cursor.  gemma3's layer 0 is a
    ring layer; its cursor counts absolute positions past the window, as
    the global layers' do."""
    m = models("gemma3-27b")
    tcfg, serving_t = m["tcfg"], m["serving_t"]
    assert tcfg.layer_kinds[0] == "l" and "g" in tcfg.layer_kinds
    prompt = torch.from_numpy(np.random.default_rng(3).integers(0, 256, size=(1, 11)))
    _, cache = TZ.prefill(serving_t, prompt, tcfg, TZ.init_cache(1, 24, tcfg, device="cpu"))
    for _ in range(3):
        TZ.decode_step(serving_t, torch.tensor([1]), tcfg, cache)
    assert cache["layers"][0]["k"].shape[1] == W
    assert {int(layer["pos"][0]) for layer in cache["layers"]} == {14}


@pytest.mark.parametrize("s", [3, 8, 13, 21])
def test_ring_prefill_write_keeps_the_last_window(s):
    """Position p of the prompt lands in ring row p % W; a prompt of at
    least W rows leaves exactly its last W there."""
    k = torch.arange(s, dtype=torch.int8).reshape(1, s, 1, 1)
    cache = {"k": torch.full((1, W, 1, 1), -1, dtype=torch.int8), "v": torch.zeros((1, W, 1, 1), dtype=torch.int8),
             "pos": torch.zeros((1,), dtype=torch.int32)}
    for key in ("k_scale", "k_offset", "v_scale", "v_offset"):
        cache[key] = torch.zeros((1,))
    one = torch.ones((1,))
    TA._write_prefill_cache(cache, k, k, s, True, one, one, one, one)
    want = [-1] * W
    for p in range(s):
        want[p % W] = p
    assert cache["k"].flatten().tolist() == want
    assert int(cache["pos"][0]) == s


MASK_CASES = (
    [("ring", True, W, W, pos) for pos in (0, 3, 7, 8, 9, 15, 16, 23, 100)]
    + [("clipped", False, 6, W, pos) for pos in range(6)]
    + [("global", False, 32, 0, pos) for pos in (0, 7, 8, 31)]
)


@pytest.mark.parametrize("geometry,windowed,t,window,pos", MASK_CASES)
def test_decode_mask_is_the_last_window_of_positions(geometry, windowed, t, window, pos):
    """After this step's row is written, row j of a ring holds the latest
    position up to ``pos`` congruent to j mod W; the valid rows are exactly
    those holding a position in (pos - W, pos].  A clipped local layer or a
    global layer holds position j in row j."""
    valid = TA._decode_valid(torch.tensor([pos]), t, window, windowed)[0].tolist()
    if windowed:
        held = [max((p for p in range(pos + 1) if p % t == j), default=None) for j in range(t)]
    else:
        held = list(range(t))
    want = [p is not None and p <= pos and (not window or p > pos - window) for p in held]
    assert valid == want, geometry
