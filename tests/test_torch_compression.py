"""int8 error-feedback gradient compression (``repro_torch.optim.compression``)
against the reference's ``repro.optim.compression``.

``compress`` / ``decompress`` bit for bit on the same inputs; then
``compressed_psum`` in 4 gloo ranks against the reference's own
``compressed_psum`` under ``jax.vmap(..., axis_name="data")`` over the 4
ranks' inputs stacked (one CPU device runs the reference's collectives
there): the averaged gradients and every rank's new residual bit for bit,
compressed and plain.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import compression as RC
from repro_torch.optim import compression as C
from torch_dist_workers import run_ranks
from torch_port_fixtures import release_jax_caches  # noqa: F401  (autouse)

RANKS = 4
SHAPES = {"w": (64, 48), "b": (48,), "big": (3, 32, 40), "zero": (8, 8)}


def _inputs(seed: int = 0):
    rng = np.random.default_rng(seed)
    grads, errs = {}, {}
    for k, shape in SHAPES.items():
        scale = 0.0 if k == "zero" else 10.0 ** rng.uniform(-4, 1)
        grads[k] = (rng.standard_normal((RANKS,) + shape) * scale).astype(np.float32)
        errs[k] = (rng.standard_normal((RANKS,) + shape) * scale * 0.01).astype(np.float32)
    errs["zero"][:] = 0.0
    return grads, errs


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compress_and_decompress_bit_for_bit(seed):
    grads, errs = _inputs(seed)
    for k in SHAPES:
        g, e = grads[k][seed % RANKS], errs[k][seed % RANKS]
        rq, rs, rr = RC.compress(jnp.asarray(g), jnp.asarray(e))
        q, s, r = C.compress(torch.from_numpy(g), torch.from_numpy(e))
        assert q.dtype == torch.int8 and np.array_equal(q.numpy(), np.asarray(rq)), k
        assert np.array_equal(s.numpy(), np.asarray(rs)), k
        assert np.array_equal(r.numpy(), np.asarray(rr)), k
        assert np.array_equal(C.decompress(q, s).numpy(), np.asarray(RC.decompress(rq, rs))), k
    init = C.init_error_state({"a": torch.zeros(3, dtype=torch.bfloat16)})
    assert init["a"].dtype == torch.float32 and init["a"].shape == (3,)
    assert C.payload_bytes({"a": torch.zeros(10, 4), "b": torch.zeros(6)}) == (46, 184)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    grads, errs = _inputs(7)
    return grads, errs, run_ranks("psum_worker", RANKS, tmp_path_factory.mktemp("psum"),
                                  {"grads": grads, "errs": errs})


def test_compressed_psum_in_four_ranks_equals_the_vmapped_reference(ranks):
    """The shared scale (an all-reduce MAX), the int32 sum of the int8
    payloads, the rescaled average and each rank's residual: bit for bit
    the reference's vmapped ``compressed_psum``; with ``enabled=False`` the
    float32 mean of the 4 ranks within ``2**-22 * mean_r |g_r|`` per element
    (gloo adds the 4 ranks' float32 values in its own order, XLA in its:
    two roundings of partial sums apart at most) and the error state
    unchanged."""
    grads, errs, out = ranks

    def ref(g, e, enabled):
        return RC.compressed_psum(g, e, "data", enabled=enabled)

    gj = {k: jnp.asarray(v) for k, v in grads.items()}
    ej = {k: jnp.asarray(v) for k, v in errs.items()}
    for enabled, key in ((True, "on"), (False, "off")):
        ravg, rerr = jax.vmap(lambda g, e: ref(g, e, enabled), axis_name="data")(gj, ej)
        for r in range(RANKS):
            avg, err = out[r][key]
            for k in SHAPES:
                want = np.asarray(ravg[k])[r]
                if enabled:
                    assert np.array_equal(avg[k].numpy(), want), (key, r, k)
                else:
                    bound = 2.0 ** -22 * np.abs(grads[k]).mean(axis=0)
                    assert np.all(np.abs(avg[k].numpy() - want) <= bound), (key, r, k)
                assert np.array_equal(err[k].numpy(), np.asarray(rerr[k])[r]), (key, r, k)
        # every rank ends with the same average
        for k in SHAPES:
            assert all(torch.equal(out[0][key][0][k], out[r][key][0][k]) for r in range(RANKS))
    assert torch.equal(out[2]["gathered"], torch.tensor([[0, 0], [1, 10], [2, 20], [3, 30]], dtype=torch.int32))


def test_compressed_psum_carries_int32_sums(ranks):
    """What a rank hands to the collectives (``collectives.BYTES``): the
    int8 mantissas go to the all-reduce as int32, as the reference sums
    them, so the compressed call carries the float32 call's bytes and a
    scale a leaf more (plus the rank count's 4 bytes in each)."""
    grads, _, out = ranks
    n = sum(int(np.prod(SHAPES[k])) for k in SHAPES)
    for r in range(RANKS):
        assert out[r]["carried"]["on"] == {"all_reduce": 4 + 4 * len(SHAPES) + 4 * n}
        assert out[r]["carried"]["off"] == {"all_reduce": 4 + 4 * n}
    assert C.payload_bytes({k: torch.from_numpy(v[0]) for k, v in grads.items()}) == (n, 4 * n)


def test_compressed_average_is_close_to_the_plain_one(ranks):
    """The int8 average within half a quantization step of the exact mean
    of the residual-corrected gradients ``g + e`` (the shared scale
    ``max|g + e| / 127``; each rank rounds to it, and the mean of 4
    roundings stays within half a step), and zero gradients stay exactly
    zero."""
    grads, errs, out = ranks
    for k in SHAPES:
        corrected = grads[k].astype(np.float64) + errs[k]
        step = max(float(np.abs(corrected).max()), 1e-12) / 127.0
        gap = float(np.abs(out[0]["on"][0][k].numpy() - corrected.mean(axis=0)).max())
        assert gap <= 0.5 * step * (1 + 1e-5), (k, gap, step)
    assert not out[0]["on"][0]["zero"].any()


def test_host_staged_collectives_equal_the_direct_ones(tmp_path):
    """Gloo's path for a CUDA tensor (copied to the host in pieces, reduced
    there, copied back) gives the direct path's results: sum, max, gather,
    reduce-scatter and the gather to the first rank (``None`` on the other)
    of a 6 x 5 tensor in 2 ranks, in 7-element pieces."""
    out = run_ranks("staged_worker", 2, tmp_path)
    inputs = [r["input"] for r in out]
    want = [inputs[0] + inputs[1], torch.maximum(inputs[0], inputs[1]), torch.stack(inputs)]
    for r in range(2):
        wants = want + [(inputs[0] + inputs[1])[3 * r:3 * r + 3]]
        for got, direct, w in zip(out[r]["staged"][:4], out[r]["direct"][:4], wants):
            assert torch.equal(got, direct) and torch.equal(got, w)
    for path in ("staged", "direct"):
        assert torch.equal(out[0][path][4], torch.stack(inputs))
    assert out[1]["staged"][4] is None and out[1]["direct"][4] is None
