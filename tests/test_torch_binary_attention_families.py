"""Bitwise attention on the GQA and MLA families, port vs the JAX reference:
granite-8b's smoke model (4 query heads a kv head) with ``attn.qk ->
binary``, and deepseek-v2-lite's (multi-head latent attention), whose
absorbed decode scores take the bitwise path only where its own site
``attn.qk_latent`` names a scores-only backend.

As in ``tests/test_torch_binary_attention.py`` (whose helpers these use):
the reference runs op by op (``jax.disable_jit``), both sides with
``REPRO_QMM_AUTOTUNE=0``; cache leaves and greedy tokens bit for bit,
logits to ``OPBYOP_ATOL``.
"""

import os
from unittest import mock

import numpy as np
import torch

from repro_torch.configs import get_config as tget
from repro_torch.configs.smoke import smoke_variant as tsmoke
from repro_torch.models import attention as TA
from repro_torch.models import model_zoo as TZ
from test_torch_binary_attention import (
    CACHE_KEYS,
    NO_TUNING,
    OPBYOP_ATOL,
    PROMPT,
    _models,
    _override,
    _run_both,
)
from torch_port_fixtures import release_jax_caches  # noqa: F401  (autouse)


def test_gqa_granite_matches_reference():
    """G = 4 query heads a kv head (granite-8b's smoke grouping): packed K
    leaves, every other leaf and greedy tokens, op by op."""
    with mock.patch.dict(os.environ, NO_TUNING):
        j, t, serving, serving_t = _models("granite-8b", 1)
        assert t.n_heads // t.n_kv_heads == 4
        runs = _run_both(j, t, serving, serving_t, PROMPT[:, :5], 1)
    assert [s[2] for s in runs["t"]] == [s[2] for s in runs["j"]]
    for (_, jc, _), (_, tc, _) in zip(runs["j"], runs["t"]):
        for want, got in zip(jc, tc):
            for key in CACHE_KEYS:
                np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def _mla_spies():
    seen = {"binary": 0, "int": 0}
    real_b, real_i = TA._scores_binary_latent, TA._scores_int_latent

    def spy_b(*a, **kw):
        seen["binary"] += 1
        return real_b(*a, **kw)

    def spy_i(*a, **kw):
        seen["int"] += 1
        return real_i(*a, **kw)

    return seen, mock.patch.multiple(TA, _scores_binary_latent=spy_b, _scores_int_latent=spy_i)


def test_qk_override_does_not_reach_latent_site():
    """``attn.qk`` and ``attn.qk_latent`` are separate sites: an ``attn.qk``
    override leaves MLA's absorbed decode on the int8 path."""
    cfg = _override(tsmoke(tget("deepseek-v2-lite-16b")), "attn.qk", "binary")
    params = TZ.init_serving_params(0, cfg, device="cpu")
    cache = TZ.init_cache(1, 16, cfg, device="cpu")
    seen, patch = _mla_spies()
    with patch:
        logits, cache = TZ.prefill(params, torch.tensor([[3, 1, 4]]), cfg, cache)
        TZ.decode_step(params, logits.argmax(-1), cfg, cache)
    assert seen == {"binary": 0, "int": cfg.n_layers}


def test_latent_site_engages_and_matches_reference_tokens():
    """``attn.qk_latent -> binary`` runs the bitwise absorbed scores at every
    MLA layer's decode, and serves the reference's greedy tokens (op by op)."""
    with mock.patch.dict(os.environ, NO_TUNING):
        j, t, serving, serving_t = _models("deepseek-v2-lite-16b", 1, site="attn.qk_latent")
        seen, patch = _mla_spies()
        with patch:
            runs = _run_both(j, t, serving, serving_t, PROMPT[:, :4], 2)
    assert seen == {"binary": 2 * t.n_layers, "int": 0}
    assert [s[2] for s in runs["t"]] == [s[2] for s in runs["j"]]
    for (jl, _, _), (tl, _, _) in zip(runs["j"], runs["t"]):
        np.testing.assert_allclose(tl, jl, rtol=0, atol=OPBYOP_ATOL)
