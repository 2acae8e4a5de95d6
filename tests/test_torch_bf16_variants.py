"""The reference's bf16 variants of the attention scores and the training
logits (``ArchConfig.attn_scores_dtype`` / ``logits_dtype = "bf16"``, set
through ``dataclasses.replace`` as the reference's dry-run variants set
them) and the float math under them, against the JAX reference run op by
op (``jax.disable_jit()``), same params.

* ``layers.softmax`` / ``log_softmax`` are ``jax.nn.softmax`` /
  ``log_softmax`` with their backward: in bf16 bit for bit over rows of
  12, 80 and 1,500 (the whisper encoder's length), across XLA's
  32-element reduction windows; in float32 within ``F32_SOFTMAX_ULPS``.
  The reference differentiates the softmax as ``e / sum(e)``
  (``jax_softmax_custom_jvp`` is off), and so does the port.
* bf16 scores in a prefill: granite-8b smoke's GQA over an int8 cache,
  deepseek-v2-lite's MLA decompressed form, whisper-tiny's stateless
  encoder pass and cross-attention over 80 rows: outputs and every cache
  leaf bit for bit.
* bf16 scores and logits in ``loss_fn`` (granite-8b smoke), each and
  both: the loss to ``LOSS_RTOL`` and every gradient leaf to
  ``GRAD_TOL`` of its scale.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs.smoke import smoke_variant as jsmoke
from repro.models import attention as JA
from repro.models import model_zoo as JZ
from repro_torch import convert
from repro_torch.configs import get_config as tget
from repro_torch.configs.smoke import smoke_variant as tsmoke
from repro_torch.core import tree
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import model_zoo as TZ
from repro_torch.runtime import train_loop as TTL
from torch_port_fixtures import release_jax_caches  # noqa: F401  (autouse)

LOSS_RTOL = 1e-6
# float32 softmax / log_softmax against jax's: XLA's CPU ``exp`` is its own
# (Cephes' polynomial, an ulp off PyTorch's in ~9% of inputs) and sums in
# its own order; values and gradients within this of the tensor's largest
# magnitude (observed 3.6e-7)
F32_SOFTMAX_RTOL = 1e-5
# met, tighter than the dense families' 1e-2: observed up to 2.2e-4 (bf16
# logits: XLA's bf16 unembed backward sums its float32 products in its own
# order, an ulp of a bf16 hidden-state gradient now and then), 1.9e-7 else
GRAD_TOL = 1e-3
BF16_SCORES = dict(attn_scores_dtype="bf16")
BF16_LOGITS = dict(logits_dtype="bf16")


@pytest.fixture(autouse=True)
def flush_denormals():
    """XLA's CPU flushes subnormal float32 results to zero; so does PyTorch
    here, for the length of each test."""
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def _np(t):
    return jax.tree.map(np.asarray, t)


def _bits(a) -> np.ndarray:
    """The bits of a numpy / jax / torch array (bf16 as int16)."""
    if isinstance(a, torch.Tensor):
        a = a.detach()
        return a.view(torch.int16).numpy() if a.dtype == torch.bfloat16 else a.numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _torch(a, dtype) -> torch.Tensor:
    return torch.from_numpy(np.asarray(jnp.asarray(a).astype(jnp.float32))).to(dtype)


@pytest.fixture(scope="module")
def models():
    built = {}

    def get(name, **variant):
        key = (name, tuple(sorted(variant.items())))
        if key not in built:
            jcfg = dataclasses.replace(jsmoke(jget(name)), **variant)
            tcfg = dataclasses.replace(tsmoke(tget(name)), **variant)
            jparams = JZ.init_params(jax.random.PRNGKey(0), jcfg)
            built[key] = dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams,
                              tparams=convert.from_reference(_np(jparams), tcfg, device="cpu"))
        return built[key]

    return get


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [12, 80, 1500])
def test_softmax_forward_and_backward_match_jax(dtype, t):
    """``softmax`` and ``log_softmax``, values and vector-Jacobian products
    under a dense cotangent: in bf16 bit for bit; in float32, where XLA's
    ``exp`` and sum order are its own, within ``F32_SOFTMAX_RTOL`` of the
    tensor's largest magnitude."""
    rng = np.random.default_rng(t)
    x = jnp.asarray(rng.standard_normal((2, 3, 5, t)) * 3, getattr(jnp, dtype))
    g = jnp.asarray(rng.standard_normal((2, 3, 5, t)), getattr(jnp, dtype))
    for jfn, tfn in ((jax.nn.softmax, TL.softmax), (jax.nn.log_softmax, TL.log_softmax)):
        with jax.disable_jit():
            y, vjp = jax.vjp(lambda a, jfn=jfn: jfn(a, axis=-1), x)
            (dx,) = vjp(g)
        xt = _torch(x, getattr(torch, dtype)).requires_grad_(True)
        yt = tfn(xt)
        (dxt,) = torch.autograd.grad(yt, xt, _torch(g, getattr(torch, dtype)))
        for got, want in ((yt, y), (dxt, dx)):
            if dtype == "bfloat16":
                assert np.array_equal(_bits(got), _bits(want)), jfn.__name__
            else:
                want = np.asarray(want)
                gap = np.abs(got.detach().numpy() - want).max()
                assert gap <= F32_SOFTMAX_RTOL * np.abs(want).max(), (jfn.__name__, gap)


def _serving(m):
    """``m``'s configs on the reference's ``mxu`` backend and the port's
    ``pallas``, and the port's packed params (``prepare_serving_params``,
    bit for bit the reference's: ``tests/test_torch_model.py``)."""
    jcfg = dataclasses.replace(m["jcfg"], quant=dataclasses.replace(m["jcfg"].quant, backend="mxu"))
    tcfg = dataclasses.replace(m["tcfg"], quant=dataclasses.replace(m["tcfg"].quant, backend="pallas"))
    return jcfg, tcfg, TZ.prepare_serving_params(m["tparams"], tcfg)


def _to_jax(node):
    """A port param subtree as the reference holds it: packed words as
    uint32, bf16 kept."""
    if isinstance(node, dict):
        return {k: (jnp.asarray(v.numpy().view(np.uint32)) if k == "w_packed" else _to_jax(v))
                for k, v in node.items()}
    if node.dtype == torch.bfloat16:
        return jnp.asarray(node.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(node.numpy())


def _rows(rng, shape, dtype=jnp.bfloat16):
    return jnp.asarray(rng.standard_normal(shape), dtype)


def _positions(b, s):
    return np.broadcast_to(np.arange(s), (b, s))


def _same_cache(jc, tc):
    assert set(jc) == set(tc)
    for key in jc:
        assert np.array_equal(_bits(tc[key]), _bits(jc[key])), key


def test_gqa_prefill_with_bf16_scores(models):
    """granite-8b smoke's attention prefilling an int8 cache over 40 rows,
    the integer scores cast to bf16 after their epilogue, scaled, masked
    and softmaxed in bf16: the output and every cache leaf bit for bit."""
    jcfg, tcfg, serving_t = _serving(models("granite-8b", **BF16_SCORES))
    b, s = 1, 40
    x, pos = _rows(np.random.default_rng(5), (b, s, tcfg.d_model)), _positions(b, s)
    with jax.disable_jit():
        out, jc = JA.attention(_to_jax(serving_t["layers"][0]["attn"]), x, jcfg, "g", "serve", jnp.asarray(pos),
                               JA.init_kv_cache(b, 48, jcfg))
    got, tc = TA.attention(serving_t["layers"][0]["attn"], _torch(x, torch.bfloat16), tcfg, "g",
                           torch.from_numpy(pos.copy()), TA.init_kv_cache(b, 48, tcfg, device="cpu"))
    assert np.array_equal(_bits(got), _bits(out))
    _same_cache(jc, tc)


def test_mla_decompressed_prefill_with_bf16_scores(models):
    """deepseek-v2-lite smoke's MLA prefill over 40 rows with bf16 scores
    (two bf16 products summed, scaled by the bf16 scale, masked and
    softmaxed in bf16): the output and every latent-cache leaf bit for
    bit."""
    jcfg, tcfg, serving_t = _serving(models("deepseek-v2-lite-16b", **BF16_SCORES))
    b, s = 1, 40
    x, pos = _rows(np.random.default_rng(6), (b, s, tcfg.d_model)), _positions(b, s)
    with jax.disable_jit():
        out, jc = JA.mla_attention(_to_jax(serving_t["layers"][0]["attn"]), x, jcfg, "serve", jnp.asarray(pos),
                                   JA.init_mla_cache(b, 48, jcfg))
    got, tc = TA.mla_attention(serving_t["layers"][0]["attn"], _torch(x, torch.bfloat16), tcfg,
                               torch.from_numpy(pos.copy()), TA.init_mla_cache(b, 48, tcfg, device="cpu"))
    assert np.array_equal(_bits(got), _bits(out))
    _same_cache(jc, tc)


@pytest.mark.parametrize("path", ["stateless", "cross"])
def test_encoder_attention_with_bf16_scores(models, path):
    """whisper-tiny smoke's attention with bf16 scores over 80 encoder
    rows: the encoder's stateless integer pass over float32 rows (the
    encoder runs in its frames' float32) and the decoder's float
    cross-attention of 4 bf16 queries onto them: the output bit for
    bit."""
    jcfg, tcfg, serving_t = _serving(models("whisper-tiny", **BF16_SCORES))
    rng = np.random.default_rng(8)
    b, t = 1, 80
    if path == "stateless":
        x, pos = _rows(rng, (b, t, tcfg.d_model), jnp.float32), _positions(b, t)
        with jax.disable_jit():
            out, _ = JA.attention(_to_jax(serving_t["encoder"]["layers"][0]["attn"]), x, JZ._encoder_cfg(jcfg), "g",
                                  "serve", jnp.asarray(pos))
        got, _ = TA.attention(serving_t["encoder"]["layers"][0]["attn"], _torch(x, torch.float32),
                              TZ._encoder_cfg(tcfg), "g", torch.from_numpy(pos.copy()))
    else:
        x, pos = _rows(rng, (b, 4, tcfg.d_model)), _positions(b, 4)
        kv = tuple(_rows(rng, (b, t, tcfg.n_kv_heads, tcfg.d_head)) for _ in "kv")
        with jax.disable_jit():
            out, _ = JA.attention(_to_jax(serving_t["layers"][0]["cross_attn"]), x, jcfg, "g", "serve",
                                  jnp.asarray(pos),
                                  kv_override=kv, causal=False)
        got, _ = TA.attention(serving_t["layers"][0]["cross_attn"], _torch(x, torch.bfloat16), tcfg, "g",
                              torch.from_numpy(pos.copy()), kv_override=tuple(_torch(a, torch.bfloat16) for a in kv),
                              causal=False)
    assert np.array_equal(_bits(got), _bits(out))


@pytest.mark.parametrize("variant", ["scores", "logits", "scores+logits"])
def test_loss_and_gradients_with_bf16_variants(models, variant):
    """granite-8b smoke's ``loss_fn`` with bf16 scores (GQA in train mode,
    q / k / probabilities fake-quantized around bf16 scores), bf16 logits
    (a bf16 unembed product, ``log_softmax`` in bf16, the mean NLL in
    float32) and both, over 40 tokens: the loss and every gradient leaf
    against the reference's."""
    kw = dict(**(BF16_LOGITS if "logits" in variant else {}), **(BF16_SCORES if "scores" in variant else {}))
    m = models("granite-8b", **kw)
    tokens = TokenPipeline(DataConfig(vocab_size=m["tcfg"].vocab_size, seq_len=40, global_batch=2,
                                      seed=1)).next()["tokens"]
    with jax.disable_jit():
        (want, _), ref = jax.value_and_grad(lambda p: JZ.loss_fn(p, {"tokens": jnp.asarray(tokens)}, m["jcfg"]),
                                            has_aux=True)(m["jparams"])
    metrics, grads = TTL.value_and_grad(m["tparams"], {"tokens": torch.from_numpy(tokens)}, m["tcfg"],
                                        TTL.TrainConfig())
    assert abs(float(metrics["loss"]) - float(want)) <= LOSS_RTOL * abs(float(want))
    want_g = convert.from_reference(_np(ref), m["tcfg"], device="cpu")
    for (path, g), w in zip(tree.leaves_with_paths(grads), tree.leaves(want_g)):
        assert float((g - w).abs().max()) <= GRAD_TOL * float(w.abs().max()), path


def test_unknown_dtypes_are_refused():
    cfg = tsmoke(tget("granite-8b"))
    for field in ("attn_scores_dtype", "logits_dtype"):
        with pytest.raises(ValueError, match=field):
            dataclasses.replace(cfg, **{field: "f16"})
