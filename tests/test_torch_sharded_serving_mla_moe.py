"""The deepseek family's serving steps over a ``(data, model)`` mesh
(``serve_loop.MeshStep``: MLA with the latent cache's columns over
``model``, the routed experts over ``model``, the batch routed globally over
the data ranks) in 4 gloo ranks on the CPU
(``torch_dist_workers.mla_moe_serve_worker``, spawned once for the module;
the ranks import no JAX), held to the reference run op by op
(``jax.disable_jit()``) on the params ``convert.py`` carries across.

Cases (``MLA_MOE_CASES``): deepseek-v2-lite-16b smoke and deepseek-v3-671b
smoke (q LoRA, sigmoid routing, one shared expert) over 1x2, 2x1 and 2x2,
and deepseek-v2-lite-16b smoke with ``attn.qk_latent -> binary`` over 1x2
and 2x1.  The v3 smoke's one shared expert is 32 wide, so over 2 model
ranks its ``ffn.down`` K of 16 would not split on 32-bit words (the step
refuses it, see ``REFUSALS``): both sides take ``d_shared_ff=64``.  The
smokes' latent is 16 wide, so a rank holds 8 columns, one partly filled
word when packed.  A prefill of 4 prompts and 4 greedy decode steps; the
2x1 decode steps route 4 tokens' 8 routes at capacity 1.  What must hold:

* every cache leaf of every rank (the int8 latent columns, the bf16 rope
  key, the per-row affines, the cursors), after the prefill and at the
  end, is the rank's shard of the reference's cache bit for bit;
* greedy tokens are equal; logits within ``LOGITS_ATOL``, the one-card
  port's bound against the reference (ROADMAP section 3);
* every MoE layer's routes, ``keep`` and ``dest`` on a rank are the
  one-card step's for that rank's routes; routing each data rank's rows
  alone differs where the one-card step drops routes;
* the absorbed decode's ``q_abs`` on a rank is the one-card step's bit for
  bit (float32 products on a rank's heads alone take another order in
  cuBLAS at some shapes, so they run for all heads through whole copies
  of ``k_up`` / ``v_up``; on the CPU both forms are bitwise);
* the dry-run's plan (``dryrun.serving_counts``) equals the bytes each
  rank's collectives carried, call by call.
"""

import dataclasses
import os
from unittest import mock

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
from repro_torch.configs.base import InputShape
from repro_torch.configs.smoke import smoke_variant as tsmoke
from repro_torch.core import dispatch, tree
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import abstract_mesh
from repro_torch.models import tensor_parallel as TP
from repro_torch.runtime import sharding as SH
from repro_torch.runtime.serve_loop import make_decode_step, make_prefill
from torch_dist_workers import MLA_MOE_CASES, absorbed_products_by_heads, latent_spy, moe_spy, run_ranks, serve_greedy
from torch_port_fixtures import release_jax_caches  # noqa: F401  (autouse)

NO_TUNING = {"REPRO_QMM_AUTOTUNE": "0"}
LOGITS_ATOL = 1e-6
N_DECODE = 4
BATCH, PROMPT = 4, 6
MAX_LEN = 16
MODELS = {"v2": "deepseek-v2-lite-16b", "v3": "deepseek-v3-671b", "v2bin": "deepseek-v2-lite-16b"}


def _cfg(get, smoke, model: str, backend: str):
    cfg = smoke(get(MODELS[model]))
    quant = dataclasses.replace(cfg.quant, backend=backend)
    if model == "v3":  # the shared FFN's down K splits on words over 2 model ranks
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, d_shared_ff=64))
    if model == "v2bin":
        quant = dataclasses.replace(quant, backend_overrides=(("attn.qk_latent", "binary"),))
    return dataclasses.replace(cfg, quant=quant)


def _ref_cache(cache, jcfg) -> dict:
    """The reference's stacked cache as the port's per-layer tree."""
    stack = cache["stack"]
    layers = [jax.tree.map(np.asarray, c) for c in stack["prefix"]]
    for i in range(jcfg.n_periods):
        layers += [{k: np.asarray(v)[i] for k, v in c.items()} for c in stack["period"]]
    return {"layers": [{k: convert.to_tensor(v, "cpu") for k, v in c.items()} for c in layers]}


def _reference(jcfg, serving, prompts) -> dict:
    """A prefill and ``N_DECODE`` greedy steps of the reference op by op."""
    logits, fed = [], []
    with jax.disable_jit():
        jl, c = JZ.prefill(serving, jnp.asarray(prompts, jnp.int32), jcfg, JZ.init_cache(BATCH, MAX_LEN, jcfg))
        after_prefill = _ref_cache(c, jcfg)
        for _ in range(N_DECODE):
            logits.append(np.asarray(jl))
            tok = np.argmax(np.asarray(jl), -1).astype(np.int32)
            fed.append(tok)
            jl, c = JZ.decode_step(serving, jnp.asarray(tok), jcfg, c)
        logits.append(np.asarray(jl))
    return {"logits": logits, "fed": fed, "prefill": after_prefill, "end": _ref_cache(c, jcfg)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    with mock.patch.dict(os.environ, NO_TUNING):
        dispatch.reset_cache()
        cfgs, params, prompts, want, one = {}, {}, {}, {}, {}
        for i, model in enumerate(MODELS):
            jcfg = _cfg(jget, jsmoke, model, "mxu")
            cfgs[model] = _cfg(tget, tsmoke, model, "pallas")
            serving = JZ.prepare_serving_params(JZ.init_params(jax.random.PRNGKey(0), jcfg), jcfg)
            params[model] = convert.from_reference(jax.tree.map(np.asarray, serving), cfgs[model], device="cpu")
            prompts[model] = np.random.default_rng(30 + i).integers(0, 256, size=(BATCH, PROMPT)).astype(np.int64)
            want[model] = _reference(jcfg, serving, prompts[model])
            routes, lat = [], []  # the one-card port step's routing and q_abs
            with moe_spy(routes), latent_spy(lat):
                res = serve_greedy(make_prefill, make_decode_step, cfgs[model], params[model], prompts[model],
                                   N_DECODE, MAX_LEN)
            one[model] = dict(res, routes=routes, q_abs=lat)
        ranks = run_ranks("mla_moe_serve_worker", 4, tmp_path_factory.mktemp("mla_moe"), {
            "cfgs": cfgs, "params": params, "prompts": prompts, "n_decode": N_DECODE, "max_len": MAX_LEN})
        dispatch.reset_cache()
    return {"cfgs": cfgs, "want": want, "one": one, "ranks": ranks}


def _on(case: str):
    return MLA_MOE_CASES[case][2]


def _shard(runs, case: str, when: str, coords) -> dict:
    model, shape, _ = MLA_MOE_CASES[case]
    whole = runs["want"][model][when]
    mesh = abstract_mesh(shape, ("data", "model"))
    c_sh = SH.cache_shardings(whole, mesh, BATCH, runs["cfgs"][model])
    return dict(tree.leaves_with_paths(SH.shard_tree(whole, c_sh, coords)))


@pytest.mark.parametrize("when", ["prefill", "end"])
@pytest.mark.parametrize("case", list(MLA_MOE_CASES))
def test_cache_shards_equal_the_references(runs, case, when):
    """Each rank's cache, after the prefill and after the last decode
    step, is its shard of the reference's cache, bit for bit and dtype for
    dtype: the model ranks hold different latent columns and the same
    rope key, the data ranks different rows."""
    shards = []
    for r in _on(case):
        got = runs["ranks"][r][case]
        want = _shard(runs, case, when, got["coords"])
        have = dict(tree.leaves_with_paths(got[when]))
        assert have.keys() == want.keys()
        for path, g in have.items():
            w = want[path]
            assert g.dtype == w.dtype and g.shape == w.shape, (r, path, g.shape, w.shape)
            assert torch.equal(g, w), f"rank {r}: cache leaf {path} differs from the reference's shard"
        shards.append(have)
    model, shape, _ = MLA_MOE_CASES[case]
    r_lat = runs["cfgs"][model].mla.kv_lora_rank
    if shape[1] == 2:  # the model ranks split the latent's columns and share the rope key
        assert shards[0]["/layers/1/ckv"].shape[-1] == r_lat // 2
        assert not torch.equal(shards[0]["/layers/1/ckv"], shards[1]["/layers/1/ckv"])
        assert torch.equal(shards[0]["/layers/1/k_rope"], shards[1]["/layers/1/k_rope"])


@pytest.mark.parametrize("case", list(MLA_MOE_CASES))
def test_greedy_tokens_and_logits_equal_the_references(runs, case):
    """Every rank returns the whole batch's logits, within ``LOGITS_ATOL``
    of the reference's, and the same greedy tokens; the gloo steps run
    eagerly."""
    model = MLA_MOE_CASES[case][0]
    want = runs["want"][model]
    for r in _on(case):
        got = runs["ranks"][r][case]
        assert got["modes"] == ("eager", "eager")
        assert [t.tolist() for t in got["fed"]] == [t.tolist() for t in want["fed"]]
        for g, w in zip(got["logits"], want["logits"]):
            assert g.shape == (BATCH, runs["cfgs"][model].vocab_size)
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=LOGITS_ATOL)


def _rank_routes(one: dict, got: dict, n: int, r: int, t: int) -> None:
    """A data rank's (r of n, t tokens) routes, keep and destinations are
    the one-card step's for its tokens."""
    assert torch.equal(got["experts"], one["experts"][r * t:(r + 1) * t])
    mine = one["st"] // t == r
    for key in ("keep", "dest"):
        assert torch.equal(got[key], one[key][mine]), key


@pytest.mark.parametrize("case", [c for c in MLA_MOE_CASES if not c.startswith("v2bin")])
def test_routes_equal_the_one_card_steps(runs, case):
    """Each MoE layer of each call (a prefill, then the decode steps) on a
    rank routes as the one-card step does: the router is replicated over
    ``model`` and the data ranks route the global batch (capacity from the
    global token count, a route's position offset by the ranks before)."""
    model, shape, _ = MLA_MOE_CASES[case]
    one = runs["one"][model]["routes"]
    n = shape[0]
    for r in _on(case):
        got = runs["ranks"][r][case]
        d = got["coords"]["data"]
        assert len(got["routes"]) == len(one) == 1 + N_DECODE  # one MoE layer a call
        for call, (g, w) in enumerate(zip(got["routes"], one)):
            t = w["experts"].shape[0] // n
            _rank_routes(w, g, n, d, t)


@pytest.mark.parametrize("model", ["v2", "v3"])
def test_routing_a_ranks_rows_alone_differs(runs, model):
    """Over 2 data ranks with each rank's rows routed alone (capacity from
    its own 12 of the prefill's 24 tokens, no offsets), the prefill's MoE
    layer, which sees the same router logits, keeps or drops other routes
    than the one-card step: the global routing is what keeps them equal."""
    one = runs["one"][model]["routes"][0]  # the prefill's MoE layer
    differs = False
    for r in _on(f"{model}_2x1"):
        alone = runs["ranks"][r][f"{model}_2x1_alone"]["routes"][0]
        d = runs["ranks"][r][f"{model}_2x1"]["coords"]["data"]
        t = one["experts"].shape[0] // 2
        assert torch.equal(alone["experts"], one["experts"][d * t:(d + 1) * t])  # the router alike
        assert not bool(alone["keep"].all())  # a case with drops
        differs |= not torch.equal(alone["keep"], one["keep"][one["st"] // t == d])
    assert differs


@pytest.mark.parametrize("case", [c for c in MLA_MOE_CASES if MLA_MOE_CASES[c][1][1] == 2])
def test_absorbed_query_equals_the_one_card_steps(runs, case):
    """The absorbed decode's ``q_abs = q_nope . w_uk`` on a rank that holds
    half the heads is the one-card step's bit for bit (its data rank's
    rows): the step gathers every head's query and folds it through the
    whole ``k_up`` (``w_uk``), so the float32 product has the one-card
    shapes."""
    model, shape, _ = MLA_MOE_CASES[case]
    one = runs["one"][model]["q_abs"]
    assert len(one) == runs["cfgs"][model].n_layers * N_DECODE  # every layer is MLA
    for r in _on(case):
        got = runs["ranks"][r][case]
        d, rows = got["coords"]["data"], BATCH // shape[0]
        assert len(got["q_abs"]) == len(one)
        for g, w in zip(got["q_abs"], one):
            assert g.shape == w[d * rows:(d + 1) * rows].shape
            assert torch.equal(g, w[d * rows:(d + 1) * rows])


SMOKE_MLA = dict(dn=16, dr=8, r=16, dv=16)


@pytest.mark.parametrize("b,h,ranks,widths", [(4, 16, 2, {}), (2, 16, 2, {}), (4, 128, 16, {}),
                                              (4, 4, 2, SMOKE_MLA), (2, 4, 2, SMOKE_MLA)])
def test_absorbed_products_on_a_ranks_heads_on_the_cpu(b, h, ranks, widths):
    """On the CPU the absorbed decode's float32 products on a rank's heads
    alone (``q_abs`` through the rank's columns of ``k_up``, the context
    through its columns of ``v_up``) are the one-card step's bit for bit,
    and so is the gathered form the step runs.  The card's cuBLAS is not
    (``tests/test_torch_cuda.py::test_absorbed_products_on_a_ranks_heads``,
    ROADMAP section 3): the step gathers on both."""
    got = absorbed_products_by_heads(b, h, ranks, **widths)
    assert all(got["q_heads"]) and all(got["ctx_heads"]) and got["q_gathered"], got


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("case", ["v2_1x2", "v3_2x1", "v2bin_1x2", "v2_2x2", "v3_2x2"])
def test_dryrun_plan_equals_the_live_step_bytes(runs, case, kind):
    """The dry-run's account of the MLA and MoE step's collectives (the
    step run on ``meta`` through counting stand-ins) equals the bytes each
    rank's live step handed to gloo, op by op, for the prefill and for
    every decode step."""
    model, shape, _ = MLA_MOE_CASES[case]
    seq = PROMPT if kind == "prefill" else MAX_LEN
    plan = dryrun.serving_counts(runs["cfgs"][model], InputShape("t", seq, BATCH, kind),
                                 abstract_mesh(shape, ("data", "model")))
    want = {op: v["bytes"] for op, v in plan["collectives"].items() if op != "total_bytes"}
    for r in _on(case):
        carried = runs["ranks"][r][case]["bytes"]
        for got in (carried[:1] if kind == "prefill" else carried[1:]):
            assert {op.replace("_", "-"): n for op, n in got.items()} == want


@pytest.mark.parametrize("name", ["deepseek-v2-lite-16b", "deepseek-v3-671b"])
@pytest.mark.parametrize("shape", [(1, 2), (2, 1), (2, 2), (16, 16), (2, 16, 16)])
def test_full_configs_are_served_where_widths_divide(name, shape):
    """The full configs over the test meshes, and deepseek-v3-671b over the
    production meshes (every width divides there); deepseek-v2-lite-16b's
    dense d_ff of 10,944 does not split over 16 model ranks on words."""
    names = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    reason = SH.serve_mesh_refusal(tget(name), abstract_mesh(shape, names), 128)
    if name == "deepseek-v2-lite-16b" and shape[-1] == 16:
        assert "does not split over 16 'model' ranks" in reason
    else:
        assert reason is None


def test_local_config_keeps_the_latent_and_the_experts_whole():
    """A rank's config: its heads, and the global latent widths and expert
    count that the weights and the router use."""
    cfg = tget("deepseek-v3-671b")
    loc = TP.local_config(cfg, 16)
    assert (loc.n_heads, loc.n_kv_heads, loc.d_ff) == (8, 8, 1152)
    assert loc.mla == cfg.mla and loc.moe == cfg.moe


@pytest.mark.parametrize("name,shape", [("deepseek-v2-lite-16b", (1, 2)), ("deepseek-v2-lite-16b", (2, 1)),
                                        ("deepseek-v3-671b", (16, 16))])
def test_dryrun_params_bytes_are_what_a_rank_holds(name, shape):
    """The dry-run's serving params a rank (``argument_bytes``: its shards
    and its whole copies) are the bytes of what ``MeshStep.shard_params``
    gives rank (0, 0) on ``meta``: over more than one model rank, every
    MLA layer's whole ``k_up`` / ``v_up`` beside the shards
    (``serve_loop.whole_copies``)."""
    from repro_torch.models import model_zoo as Z
    from repro_torch.runtime.serve_loop import MeshStep, whole_copies

    cfg, b, t = tget(name), 32, 512
    mesh = abstract_mesh(shape, ("data", "model"))
    step = MeshStep(Z.decode_step, cfg, mesh, b, t, (b,), device="meta", comm=dryrun._CountingComm(mesh),
                    coords={"data": 0, "model": 0})
    whole = Z.prepare_serving_params(Z.init_params(0, cfg, device="meta"), cfg)
    held = sum(x.numel() * x.element_size() for x in tree.leaves(step.shard_params(whole)))
    copies = sum(x.numel() * x.element_size() for c in whole_copies(whole, shape[1]) for x in tree.leaves(c))
    args = dryrun.argument_bytes(cfg, InputShape("decode", t, b, "decode"), mesh)
    assert args["params"] + args["whole_copies"] == held
    assert args["whole_copies"] == copies and (copies > 0) == (shape[1] > 1)
