"""QAT training of the recurrent families on the CPU: the port's SSD and
RG-LRU mixers in train mode (stateless, full-sequence) and the
recurrentgemma-2b and mamba2-130m smoke models' loss and gradients,
against the JAX reference run op by op, same params.

XLA's CPU flushes subnormal float32 results to zero and PyTorch's does
not, so this module runs with PyTorch's flush on, as
``tests/test_torch_ssm.py`` does (long products of decays underflow).

What must agree, as observed here:

* **Bit for bit**: every projection's gradient (``qlinear`` sites, the
  FFNs, local attention's), the depthwise conv taps' gradient (a bf16
  sum over the B x S rows, which the port takes in XLA's order up to 32
  rows, the shapes here: ``ssm._DepthwiseConv``; PyTorch's float32 sum
  put 1.5e-2 on mamba2's ``conv_w``), and in the mixers alone their bf16
  output and the input's gradient.
* **Float32 leaves** (``FLOAT_TOL``, 1e-5 of a leaf's largest
  magnitude): the norm gains, ``lambda_p``, ``A_log``, ``D``,
  ``dt_bias`` and the tables, whose gradients are float32 reductions
  summed in another order than XLA's, through XLA's own exp / log1p /
  sigmoid / sqrt (ROADMAP section 3); observed up to 2.3e-6 (mamba2's
  ``A_log``).
* **The whole model**: the loss within ``LOSS_RTOL`` 1e-6 relative
  (observed 8.7e-8 on recurrentgemma, 2.6e-7 on mamba2), every gradient
  leaf within ``GRAD_TOL`` 1e-2 of its largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs.smoke import smoke_variant as jsmoke
from repro.models import model_zoo as JZ
from repro.models import ssm as JS
from repro_torch import convert
from repro_torch.configs import get_config as tget
from repro_torch.configs.smoke import smoke_variant as tsmoke
from repro_torch.core import tree
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.models import ssm as TS
from repro_torch.runtime import train_loop as TTL
from torch_port_fixtures import release_jax_caches  # noqa: F401  (autouse)

NAMES = ["recurrentgemma-2b", "mamba2-130m"]
LOSS_RTOL = 1e-6
GRAD_TOL = 1e-2
FLOAT_TOL = 1e-5
BATCH, SEQ = 2, 16


@pytest.fixture(autouse=True)
def flush_denormals():
    """XLA's CPU flushes subnormal float32 results to zero; so does PyTorch
    while this is on."""
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def _t(a):
    return convert.to_tensor(np.asarray(a), device="cpu")


def _rel_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want.float()).abs().max()) / max(float(want.float().abs().max()), 1e-30)


def _bitwise_leaf(path: str) -> bool:
    """A linear's weight or the conv taps: the gradients held bit for bit."""
    return path.endswith("/w") or path.endswith("conv_w")


@pytest.mark.parametrize("name", NAMES)
def test_loss_and_gradients_match_reference(name):
    jcfg, tcfg = jsmoke(jget(name)), tsmoke(tget(name))
    jparams = JZ.init_params(jax.random.PRNGKey(0), jcfg)
    tokens = TokenPipeline(DataConfig(vocab_size=tcfg.vocab_size, seq_len=SEQ, global_batch=BATCH,
                                      seed=1)).next()["tokens"]
    with jax.disable_jit():
        (total, _), jgrads = jax.value_and_grad(
            lambda p: JZ.loss_fn(p, {"tokens": jnp.asarray(tokens)}, jcfg), has_aux=True)(jparams)
    tparams = convert.from_reference(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    metrics, grads = TTL.value_and_grad(tparams, {"tokens": torch.from_numpy(tokens)}, tcfg, TTL.TrainConfig())
    want_total = float(total)
    assert abs(float(metrics["loss"]) - want_total) <= LOSS_RTOL * abs(want_total)
    assert float(metrics["aux"]) == 0.0
    want = dict(tree.leaves_with_paths(convert.from_reference(jax.tree.map(np.asarray, jgrads), tcfg,
                                                              device="cpu")))
    mine = dict(tree.leaves_with_paths(grads))
    assert set(mine) == set(want)
    for path, w in want.items():
        g = mine[path]
        assert g.dtype == w.dtype == torch.float32 and g.shape == w.shape, path
        assert _rel_gap(g, w) <= GRAD_TOL, (path, _rel_gap(g, w))
        if _bitwise_leaf(path):
            assert torch.equal(g, w), path
        else:
            assert _rel_gap(g, w) <= FLOAT_TOL, (path, _rel_gap(g, w))


# mixer -> (model, reference init, reference mixer, port mixer, (B, S)): the
# SSD at one row of 20 tokens, padded to two chunks of 16; the RG-LRU at the
# model tests' shape, whose compiled reference ops it shares
MIXERS = {
    "ssd": ("mamba2-130m", JS.init_ssd, JS.ssd_mixer, TS.ssd_mixer, (1, 20)),
    "rglru": ("recurrentgemma-2b", JS.init_rglru, JS.rglru_mixer, TS.rglru_mixer, (BATCH, SEQ)),
}


@pytest.mark.parametrize("mixer", sorted(MIXERS))
def test_mixer_train_matches_reference(mixer):
    """The mixer in train mode from no state, under a random cotangent:
    output and the input's gradient bit for bit, every leaf's gradient as
    the module docstring states; a state is refused."""
    name, init, jmix, tmix, (b, s) = MIXERS[mixer]
    jcfg, tcfg = jsmoke(jget(name)), tsmoke(tget(name))
    rng = np.random.default_rng(6)
    p = init(jax.random.PRNGKey(6), jcfg)
    x = jnp.asarray(rng.standard_normal((b, s, tcfg.d_model)).astype(np.float32)).astype(jnp.bfloat16)
    g = jnp.asarray(rng.standard_normal((b, s, tcfg.d_model)).astype(np.float32)).astype(jnp.bfloat16)
    with jax.disable_jit():
        out, vjp = jax.vjp(lambda p, x: jmix(p, x, jcfg, "train")[0], p, x)
        gp, gx = vjp(g)
    tp = jax.tree.map(_t, p)
    leaves = [leaf.requires_grad_(True) for leaf in tree.leaves(tp)]
    tx = _t(x).requires_grad_(True)
    tout, state = tmix(tp, tx, tcfg, None, mode="train")
    assert state is None and tout.dtype == torch.bfloat16 and torch.equal(tout, _t(out))
    grads = torch.autograd.grad(tout, leaves + [tx], _t(g))
    for (path, w), got in zip(tree.leaves_with_paths(jax.tree.map(_t, gp)), grads):
        if _bitwise_leaf(path):
            assert torch.equal(got, w), path
        else:
            assert _rel_gap(got, w) <= FLOAT_TOL, (path, _rel_gap(got, w))
    assert torch.equal(grads[-1], _t(gx))
    init_state = TS.init_ssd_state if mixer == "ssd" else TS.init_rglru_state
    with pytest.raises(ValueError, match="no state"):
        tmix(tp, tx, tcfg, init_state(b, tcfg, device="cpu"), mode="train")
