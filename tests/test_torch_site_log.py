"""The port's QMM site log (``repro_torch.core.site_log``) against the
reference's: the records a prefill and a decode step emit, every field, in
order, for the smoke variants of granite-8b (dense GQA), bit-bert-base at
W1A1 with ``attn.qk -> binary`` (the bitwise-attention site) and
deepseek-v2-lite-16b (MLA's latent sites).  The reference records at trace
time, under ``jax.eval_shape``; the port runs its forward eagerly on the
CPU.  Every smoke variant here has one period, so the reference's scanned
period body is traced once per layer, as the port's loop runs it."""

import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs.smoke import smoke_variant as ref_smoke_variant
from repro.core import site_log as ref_site_log
from repro.models import model_zoo as RZ
from repro_torch.configs import get_config
from repro_torch.configs.smoke import smoke_variant
from repro_torch.core import site_log
from repro_torch.models import model_zoo as Z
from torch_port_fixtures import release_jax_caches  # noqa: F401  (autouse)

B, T, S = 2, 32, 16
CASES = {
    "granite-8b": (),
    "bit-bert-base": (("attn.qk", "binary"),),
    "deepseek-v2-lite-16b": (),
}


def _with_overrides(cfg, overrides):
    if not overrides:
        return cfg
    return dataclasses.replace(cfg, quant=dataclasses.replace(cfg.quant, backend_overrides=overrides))


def _reference_records(name):
    cfg = _with_overrides(ref_smoke_variant(ref_get_config(name)), CASES[name])
    sds = jax.ShapeDtypeStruct
    sp = jax.eval_shape(lambda k: RZ.prepare_serving_params(RZ.init_params(k, cfg), cfg), sds((2,), jnp.uint32))
    cache = jax.eval_shape(lambda: RZ.init_cache(B, T, cfg))
    out = {}
    with ref_site_log.recording() as sites:
        jax.eval_shape(lambda p, t, c: RZ.prefill(p, t, cfg, c), sp, sds((B, S), jnp.int32), cache)
    out["prefill"] = list(sites)
    with ref_site_log.recording() as sites:
        jax.eval_shape(lambda p, t, c: RZ.decode_step(p, t, cfg, c), sp, sds((B,), jnp.int32), cache)
    out["decode"] = list(sites)
    return out


def _port_records(name):
    cfg = _with_overrides(smoke_variant(get_config(name)), CASES[name])
    params = Z.prepare_serving_params(Z.init_params(0, cfg, device="cpu"), cfg)
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen)
    out = {}
    with torch.no_grad():
        cache = Z.init_cache(B, T, cfg, device="cpu")
        with site_log.recording() as sites:
            Z.prefill(params, tokens, cfg, cache)
        out["prefill"] = list(sites)
        with site_log.recording() as sites:
            Z.decode_step(params, tokens[:, -1], cfg, cache)
        out["decode"] = list(sites)
    return out


@pytest.fixture(autouse=True)
def _no_timing(monkeypatch):
    # the scores site's "auto" core resolves without timing runs, as in the
    # reference's trace
    monkeypatch.setenv("REPRO_QMM_AUTOTUNE", "0")


@pytest.mark.parametrize("name", list(CASES))
def test_site_records_equal_the_references(name):
    got, want = _port_records(name), _reference_records(name)
    for step in ("prefill", "decode"):
        assert want[step], f"the reference recorded no site in its {step}"
        assert got[step] == want[step], step


def test_recording_off_records_nothing():
    assert not site_log.is_recording()
    site_log.record(kind="qlinear", site="x")  # a no-op
    with site_log.recording() as outer:
        with site_log.recording() as inner:
            site_log.record(kind="attn", site="attn.qk")
        assert inner == [{"kind": "attn", "site": "attn.qk"}] and outer == []
    assert not site_log.is_recording()


def test_dtype_names_are_numpys():
    assert [site_log.dtype_name(d) for d in (torch.uint8, torch.int8, torch.int32)] == [
        "uint8", "int8", "int32"]
