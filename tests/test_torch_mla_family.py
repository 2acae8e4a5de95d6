"""The deepseek family -- multi-head latent attention (MLA) and the mixture
of experts -- through the port against the JAX reference, on the
reference's own params of the deepseek-v2-lite-16b smoke variant (one
``"Md"`` layer: MLA with a dense FFN; one ``"Mm"``: MLA with 8 routed
experts, top-2, and 2 shared).  ``tests/test_torch_mla_v3.py`` holds
deepseek-v3-671b's smoke variant (q-LoRA queries, three dense prefix
layers, the sigmoid router) to the same checks, in a file of its own so
that the two reference compilations run side by side under ``--dist
loadfile``.

What must agree, and how:

* ``prepare_serving_params`` on the converted latents: bit for bit, the
  rank-3 packed experts and the float32 router included;
* every latent-cache leaf (``ckv``, ``ckv_scale``, ``ckv_offset``,
  ``k_rope``, ``pos``) of every layer after the prefill and after each
  decode step: bit for bit against the reference run op by op
  (``jax.disable_jit``), logits to ``OPBYOP_ATOL``.  The float einsums
  XLA and torch sum in different orders (the decompressed prefill's
  scores, the absorbed decode's ``q_abs`` and context, the router's
  ``td,de``; ``tests/test_torch_moe.py``) move values by ulps before a
  quantization or a bf16 cast absorbs them: no cache leaf differs here;
* over a prefill and 12 greedy decode steps against the compiled
  reference: logits within ``TOL``, greedy tokens identical.
  (The compiled reference drifts from its own op-by-op run, ~0.01 on these
  logits; on deepseek-v3's run it flips its own argmax once, and
  ``tests/test_torch_mla_v3.py`` holds those tokens to the op-by-op run.)

The engines (the port's ``ServeEngine`` against the reference's, 4 slots)
are compared in ``tests/test_torch_mla_engine.py`` and
``tests/test_torch_mla_v3_engine.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs.smoke import smoke_variant as jsmoke
from repro.models import model_zoo as JZ
from repro_torch import convert
from repro_torch.configs import get_config as tget
from repro_torch.configs.smoke import smoke_variant as tsmoke
from repro_torch.models import model_zoo as TZ
from torch_port_fixtures import release_jax_caches  # noqa: F401  (autouse)

TOL = 0.03  # tests/test_torch_model.py
OPBYOP_ATOL = 1e-6
CACHE_KEYS = ["ckv", "ckv_scale", "ckv_offset", "k_rope", "pos"]
NAME = "deepseek-v2-lite-16b"


def _backend(cfg, backend):
    return dataclasses.replace(cfg, quant=dataclasses.replace(cfg.quant, backend=backend))


def build(name: str) -> dict:
    """A smoke model: reference serving params and their port copies,
    latent and packed."""
    jcfg, tcfg = jsmoke(jget(name)), _backend(tsmoke(tget(name)), "pallas")
    params = JZ.init_params(jax.random.PRNGKey(0), jcfg)
    serving = JZ.prepare_serving_params(params, jcfg)
    return dict(
        jcfg=jcfg, tcfg=tcfg, serving=serving,
        latent_t=convert.from_reference(jax.tree.map(np.asarray, params), tcfg, device="cpu"),
        serving_t=convert.from_reference(jax.tree.map(np.asarray, serving), tcfg, device="cpu"),
    )


@pytest.fixture(scope="module")
def model():
    return build(NAME)


def check_serving_params(m) -> None:
    tcfg = m["tcfg"]
    mine = TZ.prepare_serving_params(m["latent_t"], tcfg)
    want = m["serving_t"]
    assert len(mine["layers"]) == len(want["layers"]) == tcfg.n_layers
    assert set(mine) == set(want) == {"embedding", "unembedding", "final_norm", "layers"}
    for key in ("embedding", "unembedding", "final_norm"):
        assert torch.equal(mine[key], want[key]), key

    def walk(got, ref, path):
        if isinstance(ref, dict):
            assert set(got) == set(ref), path
            for k in ref:
                walk(got[k], ref[k], f"{path}.{k}")
        else:
            assert got.dtype == ref.dtype and torch.equal(got, ref), path

    e = tcfg.moe
    for i, (kind, g, w) in enumerate(zip(tcfg.layer_kinds, mine["layers"], want["layers"])):
        walk(g, w, f"layers[{i}]")
        if kind == "Mm":
            moe = g["moe"]
            assert moe["router"]["w"].dtype == torch.float32 and set(moe["router"]) == {"w"}
            kw = -(-tcfg.d_model // 32)
            assert moe["up"]["w_packed"].shape == (e.n_routed, kw, e.d_expert_ff)
            assert moe["down"]["w_colsum"].shape == (e.n_routed, tcfg.d_model)
        else:
            assert "ffn" in g and "moe" not in g


def test_prepare_serving_params_bit_identical(model):
    check_serving_params(model)


def test_init_serving_params_equals_init_then_prepare(model):
    """Packing each expert site as it is drawn gives the params of drawing
    all, then packing."""
    tcfg = model["tcfg"]
    got = TZ.init_serving_params(5, tcfg, device="cpu")
    want = TZ.prepare_serving_params(TZ.init_params(5, tcfg, device="cpu"), tcfg)
    flat_got, flat_want = [], []
    for tree, out in ((got, flat_got), (want, flat_want)):
        def walk(node, path, out=out):
            if isinstance(node, dict):
                for k in sorted(node):
                    walk(node[k], path + (k,))
            elif isinstance(node, list):
                for i, v in enumerate(node):
                    walk(v, path + (i,))
            else:
                out.append((path, node))
        walk(tree, ())
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (path, a), (_, b) in zip(flat_got, flat_want):
        assert a.dtype == b.dtype and torch.equal(a, b), path


def _ref_layers(cache, jcfg):
    """The reference's stacked cache cut into per-layer dicts, in layer order."""
    stack = cache["stack"]
    out = [jax.tree.map(np.asarray, c) for c in stack["prefix"]]
    for i in range(jcfg.n_periods):
        out += [{k: np.asarray(v)[i] for k, v in c.items()} for c in stack["period"]]
    return out


def _snapshot(cache):
    return [{k: v.clone() for k, v in layer.items()} for layer in cache["layers"]]


def run_op_by_op(m, plen: int, n_decode: int, max_len: int) -> list:
    """A prefill and ``n_decode`` greedy decode steps through the reference
    run op by op (its ``mxu`` backend) and the port's ``pallas`` path;
    (when, reference logits, port logits, reference caches, port caches)
    after each step."""
    jcfg, tcfg, serving, serving_t = _backend(m["jcfg"], "mxu"), m["tcfg"], m["serving"], m["serving_t"]
    prompt = np.random.default_rng(plen).integers(0, 256, size=(1, plen)).astype(np.int32)
    steps = []
    with jax.disable_jit():
        jl, jc = JZ.prefill(serving, jnp.asarray(prompt), jcfg, JZ.init_cache(1, max_len, jcfg))
        tl, tc = TZ.prefill(serving_t, torch.from_numpy(prompt.astype(np.int64)), tcfg,
                            TZ.init_cache(1, max_len, tcfg, device="cpu"))
        steps.append(("prefill", np.asarray(jl), tl.numpy(), _ref_layers(jc, jcfg), _snapshot(tc)))
        for i in range(n_decode):
            tok = int(np.argmax(np.asarray(jl)))
            jl, jc = JZ.decode_step(serving, jnp.asarray([tok], jnp.int32), jcfg, jc)
            tl, tc = TZ.decode_step(serving_t, torch.tensor([tok]), tcfg, tc)
            steps.append((f"decode {i} at position {plen + i}", np.asarray(jl), tl.numpy(),
                          _ref_layers(jc, jcfg), _snapshot(tc)))
    return steps


def _as_numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def check_caches(steps, tcfg, max_len: int) -> None:
    """Every latent-cache leaf of every layer, after every step, bit for
    bit (bf16 ``k_rope`` compared as its bits), in its own geometry."""
    m = tcfg.mla
    for when, _, _, jlayers, tlayers in steps:
        assert len(jlayers) == len(tlayers) == tcfg.n_layers
        for i, (jc, tc) in enumerate(zip(jlayers, tlayers)):
            assert set(tc) == set(jc) == set(CACHE_KEYS), f"layer {i} leaves"
            assert tc["ckv"].shape == (1, max_len, m.kv_lora_rank) and tc["ckv"].dtype == torch.int8
            assert tc["k_rope"].shape == (1, max_len, m.qk_rope_dim) and tc["k_rope"].dtype == torch.bfloat16
            for key in CACHE_KEYS:
                want = np.asarray(jc[key])
                want = want.view(np.int16) if want.dtype.name == "bfloat16" else want
                got = _as_numpy(tc[key])
                assert got.dtype == want.dtype and got.shape == want.shape, f"{when}: layer {i} {key}"
                bad = np.argwhere(got != want)
                assert bad.size == 0, (f"{when}: layer {i} ({tcfg.layer_kinds[i]}) cache[{key!r}] "
                                       f"differs at {bad[:5].tolist()}")


def check_logits(steps) -> None:
    for when, want, got, _, _ in steps:
        np.testing.assert_allclose(got, want, rtol=0, atol=OPBYOP_ATOL, err_msg=when)


@pytest.fixture(scope="module")
def op_by_op(model):
    # prompt 9: the prefill's MoE routes 18 tokens into capacity 3 per expert
    return run_op_by_op(model, 9, 3, 24)


def test_latent_cache_bit_identical_to_op_by_op_reference(model, op_by_op):
    check_caches(op_by_op, model["tcfg"], 24)


def test_logits_match_op_by_op_reference(op_by_op):
    check_logits(op_by_op)


def greedy_vs_compiled(m, strict: bool = True) -> int:
    """Prefill of 12 tokens and 12 greedy decode steps at max_len 32
    against the compiled reference, both fed the port's greedy tokens:
    logits within TOL at every step, and the same greedy token at every
    step where the compiled reference's top two logits lie more than twice
    that step's largest logit gap apart (where two runs that close cannot
    rank them differently); with ``strict``, the same greedy token at
    every step.  Returns the number of steps closer than that."""
    jcfg, tcfg, serving, serving_t = _backend(m["jcfg"], "mxu"), m["tcfg"], m["serving"], m["serving_t"]
    prompt = np.random.default_rng(1).integers(0, 256, size=(1, 12)).astype(np.int32)
    prefill = jax.jit(lambda p, t, c: JZ.prefill(p, t, jcfg, c))
    decode = jax.jit(lambda p, t, c: JZ.decode_step(p, t, jcfg, c))
    jl, jc = prefill(serving, jnp.asarray(prompt), JZ.init_cache(1, 32, jcfg))
    tl, tc = TZ.prefill(serving_t, torch.from_numpy(prompt.astype(np.int64)), tcfg,
                        TZ.init_cache(1, 32, tcfg, device="cpu"))
    close = 0
    for step in range(13):
        want, got = np.asarray(jl)[0], tl.numpy()[0]
        gap = np.abs(want - got).max()
        assert gap <= TOL, f"step {step}: max |logit gap| {gap:.3g} > {TOL}"
        top2 = np.sort(want)[-2:]
        if strict or top2[1] - top2[0] > 2 * gap:
            assert int(np.argmax(got)) == int(np.argmax(want)), f"greedy tokens differ at step {step}"
        else:
            close += 1
        if step == 12:
            break
        tok = int(np.argmax(got))
        jl, jc = decode(serving, jnp.asarray([tok], jnp.int32), jc)
        tl, tc = TZ.decode_step(serving_t, torch.tensor([tok]), tcfg, tc)
    return close


def test_greedy_decode_and_logits_vs_compiled_reference(model):
    greedy_vs_compiled(model)


def test_mla_cache_refuses_unported_cases(model):
    """Non-rotary positions are refused; ``kv_cache_bits=16`` gives the bf16
    latent cache (``ckv`` bf16, no affines; once refused); the
    binary-scores latent site is configurable (its scores-only backends are
    in the port's registry) and leaves the latent cache's layout as it is,
    while an unknown backend name is still refused."""
    from repro_torch.models import attention as TA

    tcfg = model["tcfg"]
    with pytest.raises(ValueError, match="unknown backend"):
        dataclasses.replace(tcfg.quant, backend_overrides=(("attn.qk_latent", "no-such-core"),))
    bcfg = dataclasses.replace(tcfg, quant=dataclasses.replace(
        tcfg.quant, backend_overrides=(("attn.qk_latent", "binary"),)))
    assert TA.init_kv_cache(1, 8, bcfg, "Md", device="cpu")["ckv"].dtype == torch.int8
    bf16 = TA.init_kv_cache(1, 8, dataclasses.replace(
        tcfg, quant=dataclasses.replace(tcfg.quant, kv_cache_bits=16)), "Md", device="cpu")
    assert bf16["ckv"].dtype == torch.bfloat16 and "ckv_scale" not in bf16
    with pytest.raises(NotImplementedError):
        TA.init_kv_cache(1, 8, dataclasses.replace(tcfg, pos_embedding="learned"), "Mm", device="cpu")
    assert TZ.cache_rows(24, tcfg) == [24, 24]
    assert TZ.cache_geometry(TZ.init_cache(3, 24, tcfg, device="cpu")) == [(3, 24), (3, 24)]
