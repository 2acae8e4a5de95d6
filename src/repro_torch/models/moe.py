"""Mixture-of-Experts FFN (port of ``repro.models.moe``): deepseek-style
shared experts plus routed top-k experts, in serve mode and in train mode
(QAT).

Dispatch is capacity-based, as in the reference: each token's ``k`` routes
are sorted by expert (a stable sort), placed at their position within the
expert's ``capacity`` rows, and routes past the capacity go to a drop slot
and are lost.  The routed experts then run as one stacked product ``(E, C,
K) x (E, K, N)`` of binary weights; the router stays float32.

Routing depends on the batch: every row of a step competes for the same
capacity (a 4-slot decode step has ``capacity`` 1 at deepseek-v2-lite's
64 experts, top-6), so a request's tokens can depend on what shares its
step, in the reference as here.

Serving keeps everything on the device: the capacity is a Python int from
static shapes, and the sorts, ``searchsorted`` and scatters need no host
sync, so the step captures as a CUDA graph.

Train mode (``mode="train"``) runs the same routing and dispatch on the
latent float32 experts: each expert fake-binarized (scales per expert and
output column), the ``(E, C, K)`` buffer fake-quantized per tensor, their
product a float einsum; gradients flow through the gather into the
buffer, the bf16 combine weights and the combine, and ``moe_ffn`` also
returns the reference's Switch-style load-balance loss.  Nothing on the
autograd path is written in place.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, MoEConfig, QuantConfig
from repro_torch.core import flow_abstraction as FA
from repro_torch.core import quantization as Q
from repro_torch.core.constants import scalar
from repro_torch.kernels import ops
from repro_torch.models import layers as L

__all__ = ["init_experts", "init_moe", "pack_experts_for_serving", "expert_qlinear", "moe_ffn"]


def init_experts(gen: torch.Generator, n_experts: int, d_in: int, d_out: int, scale: float = 1.0) -> dict:
    """Latent float32 stacked weights ``(n_experts, d_in, d_out)``, std
    ``scale / sqrt(d_in)``, on the generator's device."""
    std = scale / (d_in**0.5)
    w = torch.randn((n_experts, d_in, d_out), generator=gen, dtype=torch.float32, device=gen.device)
    return {"w": w * std}


def pack_experts_for_serving(p: dict, quant: QuantConfig) -> dict:
    """Binarize each expert (scales per expert and output column, reduced
    over K), bit-pack along K (axis 1) and precompute the colsums; with
    quantization off, the stacked weights in bf16."""
    if not quant.enabled:
        return {"w": p["w"].to(torch.bfloat16)}
    wq = Q.binarize_weight(p["w"])  # scale (E, 1, N)
    colsum = FA.weight_corrections(wq)  # (E, N)
    packed = wq.pack(axis=1)
    return {
        "w_packed": packed.mantissa,  # int32 words (E, K/32, N)
        "w_scale": packed.scale.to(torch.float32),
        "w_offset": packed.offset.to(torch.float32),
        "w_colsum": colsum.to(torch.int32),
    }


def _experts_k1(x: Q.QuantTensor, w: Q.QuantTensor) -> torch.Tensor:
    """The stacked integer product on K1: one ``binary_qmm`` launch per
    expert, each writing its slice of one ``(E, C, N)`` int32 buffer."""
    a8 = x.mantissa  # (E, C, K) int8, re-centered
    e, c, k = a8.shape
    out = torch.empty((e, c, w.mantissa.shape[-1]), dtype=torch.int32, device=a8.device)
    for i in range(e):
        ops.binary_qmm_int(a8[i], w.mantissa[i], k, out=out[i])
    return out


def expert_qlinear(p: dict, x: torch.Tensor, quant: QuantConfig, k: int,
                   mode: str = "serve") -> torch.Tensor:
    """``x (E, C, K) @ W (E, K, N)`` per expert.

    ``"serve"``: each routed token keeps its own ``(E, C, 1)`` activation
    grid, so its quantization does not depend on the tokens that share its
    expert.  With ``quant.backend == "pallas"`` the integer product runs on
    K1, one launch per expert; otherwise it is the plain integer product,
    the reference's own path (which has no kernel here).  The
    flow-abstraction epilogue then runs once, batched over the experts.
    ``"train"``: the latent ``(E, K, N)`` weights fake-binarized (scales
    ``(E, 1, N)``), the whole buffer fake-quantized per tensor at
    ``act_bits``, their product a float einsum in ``x.dtype``.  With
    quantization off either mode is the reference's float einsum."""
    if not quant.enabled:
        return L.float_einsum("eck,ekn->ecn", x, p["w"].to(x.dtype))
    if mode == "train":
        w_hat = L.train_weight(p, quant)
        return L.float_einsum("eck,ekn->ecn", Q.fake_quant(x, quant.act_bits), w_hat.to(x.dtype))
    if mode != "serve":
        raise ValueError(f"unknown mode {mode!r}")
    wq = Q.QuantTensor(
        mantissa=p["w_packed"],
        scale=p["w_scale"],
        offset=p["w_offset"],
        bits=quant.weight_bits,
        packed=True,
        packed_axis=1,
        length=k,
    )
    x32 = x.to(torch.float32)
    lo = x32.amin(dim=-1, keepdim=True)
    hi = x32.amax(dim=-1, keepdim=True)
    sc = torch.clamp((hi - lo) / float(2**quant.act_bits - 1), min=1e-8)
    xq = Q.quantize_activation(x32, quant.act_bits, scale=sc, offset=lo)
    int_matmul = _experts_k1 if quant.backend == "pallas" and quant.weight_bits == 1 else None
    out = FA.qmm_flow(xq, wq, w_colsum=p["w_colsum"], int_matmul=int_matmul)
    return out.to(x.dtype)


def init_moe(gen: torch.Generator, cfg: ArchConfig, site=lambda p: p) -> dict:
    """Router, the routed experts' up / gate / down and the shared experts.
    Each expert site passes through ``site`` as soon as it is drawn (packing
    it there keeps one site's float32 latents alive at a time)."""
    e, d = cfg.moe, cfg.d_model
    router = torch.randn((d, e.n_routed), generator=gen, dtype=torch.float32, device=gen.device)
    p = {
        "router": {"w": router * 0.02},
        "up": site(init_experts(gen, e.n_routed, d, e.d_expert_ff)),
        "gate": site(init_experts(gen, e.n_routed, d, e.d_expert_ff)),
        "down": site(init_experts(gen, e.n_routed, e.d_expert_ff, d, scale=0.5)),
    }
    if e.n_shared:
        p["shared"] = L.init_ffn(gen, cfg.ffn_type, d, e.shared_ff)
    return p


def _top_k(scores: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest along the last axis, ties to the
    lower index (a stable descending sort keeps equal scores in index
    order)."""
    values, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _route(logits: torch.Tensor, e: MoEConfig, top_k: int):
    """Router logits (T, E) -> (weights (T, k), experts (T, k)), float32."""
    if e.router_scoring == "sigmoid":  # deepseek-v3
        one = scalar(1.0, torch.float32, logits.device)
        scores = one / (one + torch.exp(-logits))  # as XLA expands the logistic
        w, idx = _top_k(scores, top_k)
        w = w / (w.sum(dim=-1, keepdim=True) + 1e-20) * e.route_scale
    else:
        w, idx = _top_k(L.softmax(logits), top_k)
    return w, idx


def _dispatch(experts: torch.Tensor, capacity: int, drop: int):
    """Capacity-based dispatch of the routes ``experts`` (T, k): sort them
    by expert (stable), place each at its position within its expert's
    ``capacity`` rows, and send the overflow to the drop slot ``drop``.
    Returns (order, token of each sorted route, keep, destination row)."""
    tk = experts.numel()
    dev = experts.device
    flat_expert = experts.reshape(tk)
    order = torch.argsort(flat_expert, stable=True)
    se = flat_expert[order]
    st = order // experts.shape[-1]  # route j belongs to token j // k
    pos = torch.arange(tk, device=dev) - torch.searchsorted(se, se, side="left")
    keep = pos < capacity
    dest = torch.where(keep, se * capacity + pos, torch.full_like(pos, drop))
    return order, st, keep, dest


def _balance_loss(logits: torch.Tensor, experts: torch.Tensor, e: MoEConfig) -> torch.Tensor:
    """The Switch-style load-balance loss ``E * sum_e f_e * p_e``: ``f_e``
    the share of the routes sent to expert ``e`` (counted, no gradient),
    ``p_e`` the mean router probability of ``e`` over the tokens (a softmax
    of its own, whatever the scoring, as the reference's)."""
    dev = logits.device
    probs_mean = L.softmax(logits).mean(dim=0)  # (E,)
    counts = torch.bincount(experts.reshape(-1), minlength=e.n_routed).to(torch.float32)
    frac = counts / scalar(float(experts.numel()), torch.float32, dev)
    return scalar(float(e.n_routed), torch.float32, dev) * torch.sum(frac * probs_mean)


class _ScaleRoutes(torch.autograd.Function):
    """``rows * w[:, None]``: each route's bf16 output row times its bf16
    combine weight.  The backward is the reference's: the rows' gradient
    ``g * w``, and each weight's the bf16 sum over its row of ``g * rows``
    in the order XLA's CPU reduces a bf16 row (windows of 32 elements,
    each summed in sequence and rounded at every add, then the window
    sums; ``quantization._tree_sum_rows``).  PyTorch's own backward sums
    the row in float32 and rounds once, a bf16 ulp or more away, which
    moved a gradient leaf of the deepseek-v3 smoke model by 2.4e-2 of its
    scale."""

    @staticmethod
    def forward(ctx, rows, w):
        ctx.save_for_backward(rows, w)
        return rows * w[:, None]

    @staticmethod
    def backward(ctx, g):
        rows, w = ctx.saved_tensors
        return g * w[:, None], Q._tree_sum_rows((rows * g).transpose(0, 1))[0]


def moe_ffn(p: dict, x: torch.Tensor, cfg: ArchConfig, mode: str = "serve"):
    """The MoE FFN of ``x`` (B, S, D) -> (B, S, D).  Serving computes no
    load-balance loss (the reference's aux term is for training); train mode
    returns ``(out, aux)``, aux the float32 balance loss."""
    e, quant = cfg.moe, cfg.quant
    train = mode == "train"
    b, s, d = x.shape
    t = b * s
    dev = x.device
    xf = x.reshape(t, d)
    logits = xf.to(torch.float32) @ p["router"]["w"].to(torch.float32)
    weights, experts = _route(logits, e, e.top_k)

    capacity = int(max(1, round(e.capacity_factor * t * e.top_k / e.n_routed)))
    drop = e.n_routed * capacity
    order, st, keep, dest = _dispatch(experts, capacity, drop)
    sw = weights.reshape(-1)[order].to(x.dtype)  # combine weights ride in bf16
    buf = torch.zeros((drop + 1, d), dtype=x.dtype, device=dev)
    if train:
        buf = buf.index_copy(0, dest, xf[st])
    else:
        buf.index_copy_(0, dest, xf[st])  # duplicate writes land in the drop slot
    h_in = buf[:drop].reshape(e.n_routed, capacity, d)

    up = expert_qlinear(p["up"], h_in, quant, d, mode=mode)
    gate = expert_qlinear(p["gate"], h_in, quant, d, mode=mode)
    h = L._act("silu", gate.to(torch.float32)).to(x.dtype) * up
    out_e = expert_qlinear(p["down"], h, quant, e.d_expert_ff, mode=mode)

    # combine: each token adds its k contributions in bf16 one at a time, in
    # the order of the sorted routes (ascending expert), as the reference's
    # scatter-add does; no atomics, so the sum is deterministic
    out_flat = torch.cat([out_e.reshape(drop, d), torch.zeros((1, d), dtype=x.dtype, device=dev)])
    gathered = _ScaleRoutes.apply(out_flat[dest], sw)
    gathered = torch.where(keep[:, None], gathered, torch.zeros_like(gathered))
    inv = torch.empty_like(order).scatter_(0, order, torch.arange(order.numel(), device=dev))
    slots = inv.reshape(t, e.top_k).sort(dim=-1).values
    combined = torch.zeros((t, d), dtype=x.dtype, device=dev)
    for j in range(e.top_k):
        combined = combined + gathered[slots[:, j]]

    if "shared" in p:
        combined = combined + L.ffn(p["shared"], xf, cfg.ffn_type, quant, mode=mode)
    out = combined.reshape(b, s, d)
    return (out, _balance_loss(logits, experts, e)) if train else out
