"""The serving steps over a ``(data, model)`` mesh (``serve_loop.MeshStep``:
``make_prefill`` / ``make_decode_step`` with ``mesh=``) in 4 gloo ranks on
the CPU (``torch_dist_workers.serve_worker``, spawned once for the module;
the ranks import no JAX), held to the reference run op by op
(``jax.disable_jit()``) on the params ``convert.py`` carries across.

Cases (``SERVE_CASES``): granite-8b smoke with 2 kv heads (the smoke
variant has one, which does not split) over 2x1, 1x2 and 2x2; gemma3-27b
smoke (local ring layers, qk-norm) and bit-bert-base smoke W1A1 with
``attn.qk -> binary`` over 1x2.  A prefill of 2 prompts and 4 greedy
decode steps.  What must hold:

* every cache leaf of every rank (int8 k / v, the packed 1-bit K, the
  per-row affines, the cursors), after the prefill and at the end, is the
  rank's shard of the reference's cache bit for bit;
* greedy tokens are equal; logits are within ``LOGITS_ATOL`` (ROADMAP
  section 3): the port's float32 unembedding product against XLA's, the
  bound the port's one-card step is held to, which the vocabulary split
  keeps (0 to 1.2e-7 apart from the one-card step seen).

Also: calibrating attention on a rank's own heads would change the int8
cache (the all-reduce is what keeps the bits); a rank's query heads meet
the kv heads they meet on one card; every refusal of
``sharding.serve_mesh_refusal`` (the deepseek family's widths among them:
its MLA and MoE layers are served over a mesh,
``tests/test_torch_sharded_serving_mla_moe.py``); the dry-run's planned
serving collectives equal the live 2x2 step's bytes.
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
from repro_torch.configs.base import FLOAT_QUANT, InputShape
from repro_torch.configs.smoke import smoke_variant as tsmoke
from repro_torch.core import dispatch, tree
from repro_torch.core import flow_abstraction as FA
from repro_torch.core import quantization as Q
from repro_torch.kernels import ops as K_ops
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import abstract_mesh
from repro_torch.models import attention as A
from repro_torch.models import layers as TL
from repro_torch.models import model_zoo as TZ
from repro_torch.models import tensor_parallel as TP
from repro_torch.runtime import sharding as SH
from repro_torch.runtime.serve_loop import make_decode_step
from torch_dist_workers import SERVE_CASES, run_ranks
from torch_port_fixtures import release_jax_caches  # noqa: F401  (autouse)

NO_TUNING = {"REPRO_QMM_AUTOTUNE": "0"}
LOGITS_ATOL = 1e-6
N_DECODE = 4
BATCH, PROMPT = 2, 6
MAX_LEN = 16  # gemma3's local layers keep a ring of 8 rows: decode crosses it
MODELS = {"granite": "granite-8b", "gemma3": "gemma3-27b", "bert": "bit-bert-base"}


def _cfg(get, smoke, model: str, backend: str):
    cfg = smoke(get(MODELS[model]))
    quant = dataclasses.replace(cfg.quant, backend=backend)
    if model == "granite":
        cfg = dataclasses.replace(cfg, n_kv_heads=2)
    if model == "bert":
        cfg = dataclasses.replace(cfg, n_layers=2)
        quant = dataclasses.replace(quant, backend_overrides=(("attn.qk", "binary"),))
    return dataclasses.replace(cfg, quant=quant)


def _ref_cache(cache, jcfg) -> dict:
    """The reference's stacked cache as the port's per-layer tree (packed
    uint32 words as int32, bit for bit)."""
    stack = cache["stack"]
    layers = [jax.tree.map(np.asarray, c) for c in stack["prefix"]]
    for i in range(jcfg.n_periods):
        layers += [{k: np.asarray(v)[i] for k, v in c.items()} for c in stack["period"]]
    return {"layers": [{k: convert.to_tensor(v, "cpu") for k, v in c.items()} for c in layers]}


def _reference(model: str, serving, prompts) -> dict:
    """A prefill and ``N_DECODE`` greedy steps of the reference op by op
    (its ``mxu`` backend: its backends agree exactly)."""
    jcfg = _cfg(jget, jsmoke, model, "mxu")
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
        cfgs, params, prompts, want = {}, {}, {}, {}
        for i, model in enumerate(MODELS):
            jcfg = _cfg(jget, jsmoke, model, "mxu")
            cfgs[model] = _cfg(tget, tsmoke, model, "pallas")
            serving = JZ.prepare_serving_params(JZ.init_params(jax.random.PRNGKey(0), jcfg), jcfg)
            params[model] = convert.from_reference(jax.tree.map(np.asarray, serving), cfgs[model], device="cpu")
            prompts[model] = np.random.default_rng(20 + i).integers(0, 256, size=(BATCH, PROMPT)).astype(np.int64)
            want[model] = _reference(model, serving, prompts[model])
        ranks = run_ranks("serve_worker", 4, tmp_path_factory.mktemp("serve"), {
            "cfgs": cfgs, "params": params, "prompts": prompts, "n_decode": N_DECODE,
            "max_len": dict.fromkeys(MODELS, MAX_LEN)})
        dispatch.reset_cache()
    return {"cfgs": cfgs, "want": want, "ranks": ranks}


def _on(case: str):
    return SERVE_CASES[case][2]


def _shard(runs, case: str, when: str, coords) -> dict:
    """The rank at ``coords``' shard of the reference's cache, by leaf path."""
    model, shape, _ = SERVE_CASES[case]
    whole = runs["want"][model][when]
    mesh = abstract_mesh(shape, ("data", "model"))
    c_sh = SH.cache_shardings(whole, mesh, BATCH, runs["cfgs"][model])
    return dict(tree.leaves_with_paths(SH.shard_tree(whole, c_sh, coords)))


@pytest.mark.parametrize("when", ["prefill", "end"])
@pytest.mark.parametrize("case", list(SERVE_CASES))
def test_cache_shards_equal_the_references(runs, case, when):
    """Each rank's cache, after the prefill and after the last decode
    step, is its shard of the reference's cache, bit for bit and dtype for
    dtype; the model ranks hold different kv heads, the data ranks
    different rows."""
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
        shards.append(have["/layers/0/k"])
    if SERVE_CASES[case][1] != (2, 1):  # the model ranks split the kv heads
        assert not torch.equal(shards[0], shards[1])


@pytest.mark.parametrize("case", list(SERVE_CASES))
def test_greedy_tokens_and_logits_equal_the_references(runs, case):
    """Every rank returns the whole batch's logits, within ``LOGITS_ATOL``
    of the reference's, and the same greedy tokens; gloo's collectives are
    host calls, so the steps run eagerly (``mode``)."""
    model = SERVE_CASES[case][0]
    want = runs["want"][model]
    for r in _on(case):
        got = runs["ranks"][r][case]
        assert got["modes"] == ("eager", "eager")
        assert [t.tolist() for t in got["fed"]] == [t.tolist() for t in want["fed"]]
        for g, w in zip(got["logits"], want["logits"]):
            assert g.shape == (BATCH, runs["cfgs"][model].vocab_size)
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=LOGITS_ATOL)


def test_calibrating_on_a_ranks_own_heads_changes_the_int8_cache(runs):
    """With the per-row ranges of attention's calibrations left to each
    rank's own heads (``_row_ranges`` -> None), granite 1x2's prefill
    writes other int8 k / v rows and affines than the reference: the
    all-reduce of ``(-lo, hi)`` is what keeps the cache's bits."""
    differs = set()
    for r in _on("granite_1x2"):  # a rank whose heads hold a row's extremes keeps that row's bits
        got = dict(tree.leaves_with_paths(runs["ranks"][r]["own_heads"]))
        want = _shard(runs, "granite_1x2", "prefill", runs["ranks"][r]["granite_1x2"]["coords"])
        differs |= {path.split("/")[-1] for path, g in got.items() if not torch.equal(g, want[path])}
    assert differs == {"k", "v", "k_scale", "k_offset", "v_scale", "v_offset"}


class _SeenComm:
    """Collectives over ranks computed one after another in one process:
    a reduction answers with the value every rank handed in (given)."""

    def __init__(self, answers):
        self.answers = answers

    def all_reduce(self, t, op, axis):
        return self.answers.pop(0)

    def all_gather(self, t, axis):
        raise AssertionError("no gather expected")


@pytest.mark.parametrize("m", [2, 4])
def test_gqa_heads_meet_their_kv_heads(m):
    """Rank ``r``'s column shards of q and k hold query heads ``[r H/m,
    (r+1) H/m)`` and kv heads ``[r kvH/m, ...)``, so ``_scores_int``'s
    grouping ``h // (H / kvH)`` on a rank's heads gives the one-card
    scores' rows of those heads bit for bit, given the query's global
    grid (the all-reduce's answer)."""
    cfg = dataclasses.replace(tsmoke(tget("granite-8b")), n_heads=8, n_kv_heads=4)
    h, kvh, dh, b, s, t = cfg.n_heads, cfg.n_kv_heads, cfg.d_head, 2, 3, 5
    p = TZ.prepare_serving_params(TZ.init_params(0, cfg, device="cpu"), cfg)["layers"][0]["attn"]
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((b, s, cfg.d_model))).to(torch.bfloat16)
    q = TL.qlinear(p["q"], x, cfg.quant, name="attn.q").reshape(b, s, h, dh)
    k = TL.qlinear(p["k"], x.repeat(1, 2, 1)[:, :t], cfg.quant, name="attn.k").reshape(b, t, kvh, dh)
    k_sc, k_off = A._calibrate_rows(k)
    k_m = A._quantize_to_cache(k, k_sc, k_off)
    whole = A._scores_int(q, k_m, k_sc, k_off, 8)
    q32 = q.to(torch.float32).reshape(b, -1)
    mesh = abstract_mesh((1, m), ("data", "model"))
    specs = SH.params_shardings({"q": p["q"], "k": p["k"]}, mesh, cfg)
    for r in range(m):
        shard = SH.shard_tree({"q": p["q"], "k": p["k"]}, specs, {"data": 0, "model": r})
        q_r = TL.qlinear(shard["q"], x, cfg.quant, name="attn.q").reshape(b, s, h // m, dh)
        assert torch.equal(q_r, q[:, :, r * h // m:(r + 1) * h // m])
        k_r = TL.qlinear(shard["k"], x.repeat(1, 2, 1)[:, :t], cfg.quant, name="attn.k")
        assert torch.equal(k_r.reshape(b, t, kvh // m, dh), k[:, :, r * kvh // m:(r + 1) * kvh // m])
        ranges = torch.cat([-q32.amin(1), q32.amax(1)])
        with TP.sharded(TP.ModelParallel(_SeenComm([ranges]), m, r)):
            got = A._scores_int(q_r, k_m[:, :, r * kvh // m:(r + 1) * kvh // m], k_sc, k_off, 8)
        assert torch.equal(got, whole[:, r * h // m:(r + 1) * h // m])


def _granite(**changes):
    cfg = dataclasses.replace(tsmoke(tget("granite-8b")), n_kv_heads=2)
    return dataclasses.replace(cfg, **changes)


def _quant(cfg, **changes):
    return dataclasses.replace(cfg, quant=dataclasses.replace(cfg.quant, **changes))


def _deepseek(name="deepseek-v2-lite-16b", mla=(), moe=()):
    """A deepseek smoke config with its MLA / MoE widths changed."""
    cfg = tsmoke(tget(name))
    return dataclasses.replace(cfg, mla=dataclasses.replace(cfg.mla, **dict(mla)),
                               moe=dataclasses.replace(cfg.moe, **dict(moe)))


#: (config, mesh shape, batch, words of the reason)
REFUSALS = {
    "mla": (lambda: _deepseek(mla=dict(kv_lora_rank=17)), (1, 2), 2, "kv_lora_rank 17 does not split over 2"),
    "moe": (lambda: _deepseek(moe=dict(n_routed=9)), (1, 2), 2, "n_routed 9 does not split over 2"),
    "rope": (lambda: _deepseek(mla=dict(qk_rope_dim=6)), (1, 4), 4, "qk_rope_dim 6 does not split over 4"),
    "q_lora": (lambda: _deepseek("deepseek-v3-671b", mla=dict(q_lora_rank=9), moe=dict(d_shared_ff=64)),
               (1, 2), 2, "q_lora_rank 9 does not split over 2"),
    "shared_words": (lambda: _deepseek("deepseek-v3-671b"), (1, 2), 2,
                     "the shared experts' ffn.down's K of 32 does not split over 2 'model' ranks on 32-bit word"),
    "mla_float_scores": (lambda: _quant(_deepseek(), quantize_attention=False), (1, 2), 2,
                         "MLA's latent cache split over 'model' needs quantized attention"),
    "ssm": (lambda: tsmoke(tget("mamba2-130m")), (1, 2), 2, "SSM and RG-LRU state"),
    "rglru": (lambda: tsmoke(tget("recurrentgemma-2b")), (1, 2), 2, "SSM and RG-LRU state"),
    "encoder": (lambda: tsmoke(tget("whisper-tiny")), (1, 2), 2, "encoder frontend"),
    "float": (lambda: dataclasses.replace(_granite(), quant=FLOAT_QUANT), (1, 2), 2, "quantization is off"),
    "kv_heads": (lambda: _granite(n_kv_heads=1), (1, 2), 2, "n_kv_heads 1 does not split over 2 'model' ranks "
                 "(the cache rule would split d_head instead, which the sharded step does not compute: "
                 "ROADMAP item 7.8, follow-up 5)"),
    "heads": (lambda: _granite(n_heads=6, n_kv_heads=4), (1, 4), 4, "n_heads 6 does not split over 4"),
    "d_ff": (lambda: _granite(d_ff=129), (1, 2), 2, "d_ff 129 does not split over 2"),
    "vocab": (lambda: _granite(vocab_size=255), (1, 2), 2, "vocab_size 255 does not split over 2"),
    "words": (lambda: _granite(d_ff=160), (1, 2), 2, "ffn.down's K of 160 does not split"),
    "batch": (lambda: _granite(), (2, 1), 3, "a batch of 3 rows does not split over 2 data ranks"),
    "fused": (lambda: _quant(_granite(), backend="fused"), (1, 2), 2, "fused_qmm applies its epilogue"),
    "auto": (lambda: _quant(_granite(), backend_overrides=(("ffn.*", "auto"),)), (1, 2), 2,
             "ranks that time their candidates apart"),
}
#: the ROADMAP item 7.8 follow-up that each family or width refusal names
FOLLOW_UPS = {"ssm": 3, "rglru": 3, "encoder": 4, "kv_heads": 5, "fused": 6, "auto": 6}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_serve_mesh_refusals(case):
    """Each reason raises from the step's maker with its words, never a
    replicated compute; the same config is served on one card or, where
    only the split is at fault, over a mesh of one rank."""
    make, shape, batch, words = REFUSALS[case]
    cfg = make()
    mesh = abstract_mesh(shape, ("data", "model"))
    reason = SH.serve_mesh_refusal(cfg, mesh, batch)
    assert words in reason
    if case in FOLLOW_UPS:
        assert f"ROADMAP item 7.8, follow-up {FOLLOW_UPS[case]}" in reason
    with pytest.raises(NotImplementedError, match=words.replace("(", r"\(").replace(")", r"\)")):
        make_decode_step(cfg, batch, 8, device="cpu", mesh=mesh)
    if case in ("kv_heads", "heads", "d_ff", "vocab", "words", "fused", "auto", "mla", "moe", "rope", "q_lora",
                "shared_words", "mla_float_scores"):
        assert SH.serve_mesh_refusal(cfg, abstract_mesh((1, 1), ("data", "model")), batch) is None


def test_fused_kernel_refuses_a_rank_part():
    """K2 applies its epilogue inside the kernel, so within a row-parallel
    site's partial sums it raises rather than return a rank's float part."""
    x = Q.quantize_activation(torch.randn(3, 64), 8, per_channel_axis=0)
    w = Q.quantize_weight(torch.randn(64, 5), 1).pack(axis=0)
    with FA.partial_sums_reduced(lambda xy, row, k: (xy, row, k)), \
            pytest.raises(NotImplementedError, match="epilogue inside the kernel"):
        K_ops.qmm_fused(x, w)


def test_a_rank_part_needs_the_whole_colsum():
    """Within a row-parallel site's partial sums the epilogue's colsum
    term must be the weight's over the whole K: without ``w_colsum`` the
    flow would count it over the rank's slice, so it raises."""
    x = Q.quantize_activation(torch.randn(3, 64), 8, per_channel_axis=0)
    w = Q.quantize_weight(torch.randn(64, 5), 1)
    with FA.partial_sums_reduced(lambda xy, row, k: (xy, row, k)):
        with pytest.raises(NotImplementedError, match="colsum over the whole K"):
            FA.qmm_flow(x, w)
        got = FA.qmm_flow(x, w, w_colsum=FA.weight_corrections(w))
    assert torch.equal(got, FA.qmm_flow(x, w))


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_dryrun_plan_equals_the_live_step_bytes(runs, kind):
    """The dry-run's account of a serving step's collectives
    (``dryrun.serving_counts``: the step run on ``meta`` through counting
    stand-ins) equals the bytes the live 2x2 step handed to gloo
    (``collectives.BYTES``) on every rank, op by op."""
    cfg = runs["cfgs"]["granite"]
    seq = PROMPT if kind == "prefill" else MAX_LEN
    plan = dryrun.serving_counts(cfg, InputShape("t", seq, BATCH, kind), abstract_mesh((2, 2), ("data", "model")))
    want = {op: v["bytes"] for op, v in plan["collectives"].items() if op != "total_bytes"}
    for r in range(4):
        carried = runs["ranks"][r]["granite_2x2"]["bytes"]
        got = carried[0] if kind == "prefill" else carried[1]
        assert {op.replace("_", "-"): n for op, n in got.items()} == want
