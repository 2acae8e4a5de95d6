"""Quantization-aware building blocks, serve mode (port of ``repro.models.layers``).

Serving params are plain dicts of tensors: a packed linear is
``{"w_packed", "w_scale", "w_offset", "w_colsum"}`` and a float one
``{"w"}``: the linears the reference keeps full precision (a frontend's
stub projection, through ``float_linear``), and under a config whose
quantization is off (``FLOAT_QUANT``) every linear, its weight in bf16.  Every cast of the reference is mirrored (float32 before
quantizing, back to the activation dtype after each product).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import QuantConfig
from repro_torch.core import flow_abstraction as FA
from repro_torch.core.constants import scalar
from repro_torch.core import qmm as QE
from repro_torch.core import quantization as Q

__all__ = [
    "init_linear",
    "pack_linear_for_serving",
    "qlinear",
    "float_linear",
    "float_einsum",
    "softmax",
    "rmsnorm",
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
    act_bits: Optional[int] = None,
    name: str = "",
) -> torch.Tensor:
    """``x (..., K) @ W (K, N)`` on the serving datapath.

    Per-token calibration on the flattened ``(M, K)`` view keeps co-batched
    slots numerically independent; ``name`` selects per-site backend
    overrides.  With quantization off it is the reference's float einsum
    (``float_linear``).
    """
    if not quant.enabled:
        return float_linear(p, x)
    bits = act_bits or quant.act_bits
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
    xq = Q.quantize_activation(x.to(torch.float32).reshape(-1, k), bits, per_channel_axis=0)
    out = QE.qmm(xq, wq, backend=quant.backend_for(name), w_colsum=p.get("w_colsum"))
    return out.reshape(*lead, -1).to(x.dtype)


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


def softmax(x: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis as ``jax.nn.softmax`` evaluates it."""
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def rmsnorm(g: torch.Tensor, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * (1.0 + g.to(torch.float32))).to(x.dtype)


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
    """
    if name.startswith("gelu"):
        def c(v: float) -> torch.Tensor:
            return scalar(v, x.dtype, x.device)

        inner = x + c(0.044715) * (x * x * x)
        return x * (c(0.5) * (c(1.0) + torch.tanh(c(_SQRT_2_OVER_PI) * inner)))
    if name.startswith("silu"):
        return x * (1.0 / (1.0 + torch.exp(-x)))
    raise NotImplementedError(f"activation of ffn_type {name!r} is not ported yet")


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


def ffn(p: dict, x: torch.Tensor, ffn_type: str, quant: QuantConfig, name: str = "ffn"):
    up = qlinear(p["up"], x, quant, name=f"{name}.up")
    if ffn_type.endswith("glu"):
        gate = qlinear(p["gate"], x, quant, name=f"{name}.gate")
        h = _act(ffn_type, gate) * up
    else:
        h = _act(ffn_type, up)
    return qlinear(p["down"], h, quant, name=f"{name}.down")


def embed(p: dict, tokens: torch.Tensor, d_model: int, dtype=torch.bfloat16) -> torch.Tensor:
    scale = scalar(d_model**0.5, dtype, tokens.device)
    return p["embedding"][tokens].to(dtype) * scale


def unembed(p: dict, x: torch.Tensor, tied: bool, dtype=torch.float32) -> torch.Tensor:
    table = p["embedding"] if tied else p["unembedding"]
    return torch.matmul(x.to(dtype), table.to(dtype).T)
