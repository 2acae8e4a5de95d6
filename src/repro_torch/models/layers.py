"""Quantization-aware building blocks (port of ``repro.models.layers``).

Two execution modes thread through the layers (``mode``): ``"serve"``
(the default, the BETA datapath below) and ``"train"`` (QAT: the latent
float32 weights fake-binarized and the activations fake-quantized with
straight-through gradients, the products float so gradients flow).

Serving params are plain dicts of tensors: a packed linear is
``{"w_packed", "w_scale", "w_offset", "w_colsum"}`` and a float one
``{"w"}``: the linears the reference keeps full precision (a frontend's
stub projection, through ``float_linear``), and under a config whose
quantization is off (``FLOAT_QUANT``) every linear, its weight in bf16.  Every cast of the reference is mirrored (float32 before
quantizing, back to the activation dtype after each product).

Inside a tensor-parallel serving step (``models/tensor_parallel.py``)
``qlinear`` computes a rank's part of its site: a column-parallel site its
own columns, a row-parallel one (``ROW_SITES``) its slice of K with the
per-token ranges and the int32 partial sums reduced over the model ranks;
``embed`` and ``unembed`` work on a vocabulary-sharded table.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch

from repro_torch.configs.base import QuantConfig
from repro_torch.core import flow_abstraction as FA
from repro_torch.core.constants import scalar
from repro_torch.core import qmm as QE
from repro_torch.core import quantization as Q
from repro_torch.core import site_log
from repro_torch.models import tensor_parallel as TP

__all__ = [
    "init_linear",
    "pack_linear_for_serving",
    "qlinear",
    "train_weight",
    "float_linear",
    "float_einsum",
    "softmax",
    "log_softmax",
    "rmsnorm",
    "layernorm",
    "rope",
    "ffn",
    "gelu",
    "init_ffn",
    "embed",
    "unembed",
]

_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)


def init_linear(gen: torch.Generator, d_in: int, d_out: int, scale: float = 1.0) -> dict:
    """Latent float32 weight ``(d_in, d_out)``, std ``scale / sqrt(d_in)``,
    on the generator's device."""
    std = scale / (d_in**0.5)
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32, device=gen.device)
    return {"w": w * std}


def pack_linear_for_serving(p: dict, quant: QuantConfig) -> dict:
    """Offline weight pipeline: binarize, bit-pack along K, precompute
    colsum; with quantization off, the weight in bf16."""
    if not quant.enabled:
        return {"w": p["w"].to(torch.bfloat16)}
    wq = Q.quantize_weight(p["w"], quant.weight_bits)
    colsum = FA.weight_corrections(wq)
    packed = wq.pack(axis=0)
    return {
        "w_packed": packed.mantissa,  # int32 words (K/32, N)
        "w_scale": packed.scale.to(torch.float32),  # (1, N)
        "w_offset": packed.offset.to(torch.float32),
        "w_colsum": colsum.to(torch.int32),  # (N,)
    }


def qlinear(
    p: dict,
    x: torch.Tensor,
    quant: QuantConfig,
    *,
    mode: str = "serve",
    act_bits: Optional[int] = None,
    name: str = "",
) -> torch.Tensor:
    """``x (..., K) @ W (K, N)`` in the given execution mode.

    ``"serve"``: the serving datapath on packed weights.  Per-token
    calibration on the flattened ``(M, K)`` view keeps co-batched slots
    numerically independent; ``name`` selects per-site backend overrides.
    ``"train"``: the latent ``{"w"}`` fake-binarized, ``x`` fake-quantized
    per tensor, their product a float einsum in ``x.dtype``
    (``float_einsum``, so the backward's products also accumulate in
    float32 and round once).  With quantization off either mode is the
    reference's float einsum (``float_linear``).
    """
    if not quant.enabled:
        return float_linear(p, x)
    bits = act_bits or quant.act_bits
    if mode == "train":
        w_hat = train_weight(p, quant)
        return float_einsum("...k,kn->...n", Q.fake_quant(x, bits), w_hat.to(x.dtype))
    if mode != "serve":
        raise ValueError(f"unknown mode {mode!r}")
    k = x.shape[-1]
    wq = Q.QuantTensor(
        mantissa=p["w_packed"],
        scale=p["w_scale"],
        offset=p["w_offset"],
        bits=quant.weight_bits,
        packed=True,
        packed_axis=0,
        length=k,
    )
    lead = x.shape[:-1]
    tp = TP.current()
    row = tp if tp is not None and name in TP.ROW_SITES else None
    xq = Q.quantize_activation(x.to(torch.float32).reshape(-1, k), bits, per_channel_axis=0,
                               range_reduce=None if row is None else row.ranges)
    if site_log.is_recording():
        site_log.record(kind="qlinear", site=name, bits=bits, cfg_bits=quant.act_bits,
                        mantissa_dtype=site_log.dtype_name(xq.mantissa.dtype),
                        backend=quant.backend_for(name))
    with contextlib.nullcontext() if row is None else FA.partial_sums_reduced(row.sum_partials):
        out = QE.qmm(xq, wq, backend=quant.backend_for(name), w_colsum=p.get("w_colsum"))
    return out.reshape(*lead, -1).to(x.dtype)


def train_weight(p: dict, quant: QuantConfig) -> torch.Tensor:
    """A train-mode site's latent ``{"w"}`` (``(K, N)``, or stacked experts
    ``(E, K, N)``) fake-binarized over K.  With ``prebinarize_gather`` the
    weight arrives binarized already (``runtime.train_loop.prebinarize_params``:
    packed before the multi-device gather, a bf16 ``alpha * sign(w)``) and
    is used as it is, as the reference does."""
    if quant.prebinarize_gather:
        return p["w"]
    return Q.fake_binarize_weight(p["w"])


def float_einsum(spec: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``einsum`` of two operands of one dtype, accumulated in float32 and
    rounded once to that dtype, as XLA computes a bf16 dot.  A CUDA bf16
    GEMM accumulates in float32 itself (the package turns off its
    reduced-precision split-K reductions); the CPU's bf16 product rounds
    otherwise (one ulp off in some elements), so there both operands go to
    float32 first."""
    if a.dtype == torch.float32 or a.device.type == "cuda":
        return torch.einsum(spec, a, b)
    return torch.einsum(spec, a.to(torch.float32), b.to(torch.float32)).to(a.dtype)


def float_linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    """``x (..., K) @ W (K, N)`` in full precision, as the reference's
    ``qlinear(..., mode="float")``: the weight cast to ``x.dtype`` and the
    product taken in that dtype (``float_einsum``)."""
    return float_einsum("...k,kn->...n", x, p["w"].to(x.dtype))


def _row_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over its last axis in its own dtype, keepdims: a bf16
    row on the CPU in the order XLA's CPU reduces it, rounding at every add
    (``quantization._tree_sum_rows``: windows of 32 in sequence)."""
    if x.dtype == torch.float32 or x.device.type == "cuda":
        return x.sum(dim=-1, keepdim=True)
    return Q._tree_sum_rows(x[..., None])[..., 0, :]


def _sum_last(x: torch.Tensor) -> torch.Tensor:
    """``jnp.sum(x, -1, keepdims=True)``: a bf16 row summed in float32 and
    rounded once, as jnp upcasts a half-precision sum."""
    return x.to(torch.float32).sum(dim=-1, keepdim=True).to(x.dtype)


def _softmax_value(x: torch.Tensor):
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    w = _sum_last(e)
    return e / w, e, w


class _Softmax(torch.autograd.Function):
    """``jax.nn.softmax`` differentiated.  In bf16 as the reference
    differentiates it: its custom JVP is off by default
    (``jax_softmax_custom_jvp``), so the backward is the transpose of ``e /
    w`` (``e = exp(x - max)``, ``w = sum(e)``), op by op: ``(g / w -
    sum((g * w**-2) * e)) * e``, ``w**-2`` as ``1 / (w * w)``, the sum a
    bf16 reduce (``_row_sum``); so it is bit for bit the reference's.  In
    float32, where XLA's ``exp`` is its own anyway, the transpose of the
    custom JVP ``y * (t - sum(y * t))``, ``y*g + y*(-sum(y*g))``: it
    cancels less than the other form, which kept a deepseek-v3 smoke step
    on the card within 1e-2 of the CPU's, where the other form took a leaf
    to 1.2e-2."""

    @staticmethod
    def forward(ctx, x):
        y, e, w = _softmax_value(x)
        ctx.save_for_backward(*((y,) if x.dtype == torch.float32 else (e, w)))
        return y

    @staticmethod
    def backward(ctx, g):
        if g.dtype == torch.float32:
            (y,) = ctx.saved_tensors
            yg = y * g
            return yg + y * -yg.sum(dim=-1, keepdim=True)
        e, w = ctx.saved_tensors
        one = scalar(1.0, w.dtype, w.device)
        z = (g * (one / (w * w))) * e
        return (g / w + -_row_sum(z)) * e


class _LogSoftmax(torch.autograd.Function):
    """``jax.nn.log_softmax`` (``s - log(w)``, ``s = x - max``, ``e =
    exp(s)``, ``w = sum(e)``) and its backward, the transpose of those
    steps: ``g + (sum(-g) / w) * e``, the sum in the order XLA's CPU
    reduces a row (``_row_sum``)."""

    @staticmethod
    def forward(ctx, x):
        shifted = x - x.amax(dim=-1, keepdim=True)
        e = torch.exp(shifted)
        w = _sum_last(e)
        ctx.save_for_backward(e, w)
        return shifted - torch.log(w)

    @staticmethod
    def backward(ctx, g):
        e, w = ctx.saved_tensors
        return g + (_row_sum(-g) / w) * e


def softmax(x: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis as ``jax.nn.softmax`` evaluates it, in
    ``x.dtype`` (float32, or bf16 with every step rounded and the row sum
    taken in float32), and differentiated as it is (``_Softmax``) where
    gradients are recorded."""
    if x.requires_grad and torch.is_grad_enabled():
        return _Softmax.apply(x)
    return _softmax_value(x)[0]


def log_softmax(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_softmax`` over the last axis, each step in ``x.dtype``
    and the sum in float32, differentiated as the reference differentiates
    it (``_LogSoftmax``) where gradients are recorded."""
    if x.requires_grad and torch.is_grad_enabled():
        return _LogSoftmax.apply(x)
    shifted = x - x.amax(dim=-1, keepdim=True)
    return shifted - torch.log(_sum_last(torch.exp(shifted)))


def rmsnorm(g: torch.Tensor, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * (1.0 + g.to(torch.float32))).to(x.dtype)


def layernorm(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm with gain ``p["g"]`` and bias ``p["b"]``, in float32 (no
    served model of either package calls it)."""
    x32 = x.to(torch.float32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    centered = x32 - mu
    var = torch.mean(centered * centered, dim=-1, keepdim=True)
    y = centered * torch.rsqrt(var + eps)
    return (y * p["g"].to(torch.float32) + p["b"].to(torch.float32)).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding.  x: ``(..., S, H, D)`` or ``(..., S, D)``; positions ``(..., S)``."""
    d = x.shape[-1]
    half = d // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freqs = torch.pow(scalar(theta, torch.float32, x.device), exps)
    angles = positions.to(torch.float32)[..., None] * freqs
    if x.ndim == angles.ndim + 1:  # head axis present
        angles = angles[..., None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    """The FFN activation, evaluated as the reference's compiled bf16 code
    does: op by op, every step rounded to ``x.dtype``.

    * ``gelu*``: ``jax.nn.gelu``'s default tanh form,
      ``x * (0.5 * (1 + tanh(c * (x + 0.044715 * x**3))))`` with
      ``c = sqrt(2/pi)`` and every constant rounded to ``x.dtype`` first
      (``x**3`` is ``x * (x * x)``).  Over all 65,536 bf16 inputs this equals
      the reference's CPU result, compiled or op by op, except for the 508
      with ``|x| < 2.4e-38``, where XLA flushes a subnormal to zero;
      ``torch.nn.functional.gelu(approximate="tanh")`` differs in 1,518.
    * ``silu*``: ``x * sigmoid(x)`` with the sigmoid expanded as
      ``1 / (1 + exp(-x))``; a bf16 silu rounded once differs from the
      reference's in about a third of the elements.

    Where gradients are recorded, the backward is the transpose of JAX's
    JVP of the same expression, op by op in ``x.dtype`` (``_Gelu``,
    ``_Silu``); PyTorch's own autograd of these expressions rounds
    otherwise in about half the elements.
    """
    if name.startswith("gelu"):
        fn = _Gelu
    elif name.startswith("silu"):
        fn = _Silu
    else:
        raise NotImplementedError(f"activation of ffn_type {name!r} is not ported yet")
    if x.requires_grad and torch.is_grad_enabled():
        return fn.apply(x)
    return fn.value(x)[0]


class _Gelu(torch.autograd.Function):
    """Tanh gelu ``x * cdf``, ``cdf = 0.5 * (1 + tanh(c * (x + 0.044715 *
    x**3)))``; its backward transposes JAX's JVP:
    ``g*cdf + S*t + ((0.044715*S*t) * 3x**2)`` with ``u = 0.5*(x*g) *
    (1 - e)``, ``t = u + u*e`` and ``e`` the tanh, each step rounded."""

    @staticmethod
    def value(x):
        def c(v: float) -> torch.Tensor:
            return scalar(v, x.dtype, x.device)

        inner = x + c(0.044715) * (x * x * x)
        e = torch.tanh(c(_SQRT_2_OVER_PI) * inner)
        cdf = c(0.5) * (c(1.0) + e)
        return x * cdf, e, cdf

    @staticmethod
    def forward(ctx, x):
        y, e, cdf = _Gelu.value(x)
        ctx.save_for_backward(x, e, cdf)
        return y

    @staticmethod
    def backward(ctx, g):
        x, e, cdf = ctx.saved_tensors

        def c(v: float) -> torch.Tensor:
            return scalar(v, x.dtype, x.device)

        u = (c(0.5) * (x * g)) * (c(1.0) - e)
        t = u + u * e
        ct_c = c(_SQRT_2_OVER_PI) * t
        return (g * cdf + ct_c) + (c(0.044715) * ct_c) * (c(3.0) * (x * x))


class _Silu(torch.autograd.Function):
    """``x * sigmoid(x)``, the sigmoid as ``1 / (1 + exp(-x))``; its
    backward transposes JAX's JVP: ``g*sig + (x*g) * (sig * (1 - sig))``."""

    @staticmethod
    def value(x):
        sig = 1.0 / (1.0 + torch.exp(-x))
        return x * sig, sig

    @staticmethod
    def forward(ctx, x):
        y, sig = _Silu.value(x)
        ctx.save_for_backward(x, sig)
        return y

    @staticmethod
    def backward(ctx, g):
        x, sig = ctx.saved_tensors
        one = scalar(1.0, x.dtype, x.device)
        return g * sig + (x * g) * (sig * (one - sig))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (its tanh form), evaluated as ``_act`` evaluates the
    FFN's: every constant and step in ``x.dtype``."""
    return _act("gelu", x)


def init_ffn(gen: torch.Generator, ffn_type: str, d_model: int, d_ff: int) -> dict:
    p = {
        "up": init_linear(gen, d_model, d_ff),
        "down": init_linear(gen, d_ff, d_model, scale=0.5),
    }
    if ffn_type.endswith("glu"):
        p["gate"] = init_linear(gen, d_model, d_ff)
    return p


def ffn(p: dict, x: torch.Tensor, ffn_type: str, quant: QuantConfig, name: str = "ffn",
        mode: str = "serve"):
    up = qlinear(p["up"], x, quant, mode=mode, name=f"{name}.up")
    if ffn_type.endswith("glu"):
        gate = qlinear(p["gate"], x, quant, mode=mode, name=f"{name}.gate")
        h = _act(ffn_type, gate) * up
    else:
        h = _act(ffn_type, up)
    return qlinear(p["down"], h, quant, mode=mode, name=f"{name}.down")


def embed(p: dict, tokens: torch.Tensor, d_model: int, dtype=torch.bfloat16) -> torch.Tensor:
    """Scaled rows of the embedding table; inside a tensor-parallel step a
    vocabulary shard's, each token's row taken from its owner."""
    scale = scalar(d_model**0.5, dtype, tokens.device)
    tp = TP.current()
    rows = p["embedding"][tokens] if tp is None else tp.lookup(p["embedding"], tokens)
    return rows.to(dtype) * scale


def unembed(p: dict, x: torch.Tensor, tied: bool, dtype=torch.float32) -> torch.Tensor:
    """Logits ``x @ table.T`` in ``dtype``: float32, or bf16 as the
    reference's bf16 dot computes it (``float_einsum``).  Inside a
    tensor-parallel step each rank computes its vocabulary shard's logits
    and they are gathered along the vocabulary."""
    table = p["embedding"] if tied else p["unembedding"]
    if dtype == torch.float32:
        logits = torch.matmul(x.to(dtype), table.to(dtype).T)
    else:
        logits = float_einsum("...d,vd->...v", x.to(dtype), table.to(dtype))
    tp = TP.current()
    return logits if tp is None else tp.gather_cols(logits)[0]
