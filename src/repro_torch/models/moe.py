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

**Over data ranks** (``routing_global``, entered by the mesh training
step and by the serving step over a mesh, ``serve_loop.MeshStep``): the
reference's SPMD step routes the global microbatch (in serving, the global
batch), so its capacity, positions, drops, expert buffer and balance loss
span every data rank's rows.  Rank ``r`` of ``n`` holds the ``t``
contiguous tokens ``[r t, (r+1) t)`` of the microbatch's ``n t``, so its
stable sort by expert is the global sort restricted to its routes: a route's global
position within its expert is its local one plus the routes the ranks
before ``r`` sent to that expert (one all-gather of the ``(n, E)``
counts).  Every rank then builds the global ``(E, C, D)`` buffer from the
ranks' rows and destinations (one all-gather; rows are copied, so the
buffer equals the 1-rank step's bit for bit, ``-0.0`` included, where an
all-reduce of the ranks' disjoint buffers would turn ``-0.0`` into
``+0.0`` and carry ``k`` times the capacity factor as many rows: 7.5x at
deepseek-v2-lite's top-6 and 1.25), runs the experts over it and combines
only its own routes.  The training step runs every expert (replicated over
``model``); its backward moves nothing: a rank's rows get their gradient
from its own combine alone.  The balance loss takes the global counts (the
gathered ones, summed) and the all-reduced sum of the router's
probabilities, whose backward all-reduces the gradient (the step averages
the ranks' gradients, and every rank's loss holds the global aux term).

**Over model ranks** (``tensor_parallel.sharded``, the serving step over a
mesh): the experts split over ``model`` (expert parallelism, the
reference's rule: the stacks' E over ``model``).  Model rank ``i`` of
``m`` holds experts ``[i E/m, (i+1) E/m)`` and runs them on their rows of
the whole buffer (``E/m`` K1 launches a site), and their ``(E/m, C, D)``
outputs are gathered over ``model`` in rank order
(``tensor_parallel.gather_rows``: copies).  The router stays replicated
over ``model``, so every model rank routes alike; the buffer is already
whole on every model rank, so an all-to-all of the routed rows would move
no fewer bytes than this gather, and the gather keeps every row a copy.
The shared experts are a dense FFN (``ffn.*`` sites), column- and
row-parallel over ``model`` as the dense blocks' FFN is.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable

import torch

from repro_torch.configs.base import ArchConfig, MoEConfig, QuantConfig
from repro_torch.core import flow_abstraction as FA
from repro_torch.core import quantization as Q
from repro_torch.core.constants import scalar
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import tensor_parallel as TP

__all__ = ["init_experts", "init_moe", "pack_experts_for_serving", "expert_qlinear", "moe_ffn",
           "GlobalRouting", "routing_global", "ROUTING", "ROUTING_OPS", "clear_routing_traffic",
           "routing_traffic"]

#: the routing collectives by part: the ``(n, E)`` route counts, the
#: buffer exchange (each rank's rows and its routes' destinations), the
#: router's summed probabilities and, in the backward, their gradient
ROUTING_OPS = {"counts": "all-gather", "buffer": "all-gather", "balance": "all-reduce",
               "balance_grad": "all-reduce"}

#: what the routing collectives moved for this rank since last cleared, by
#: part: each call's result bytes (an all-gather's ``n`` pieces, an
#: all-reduce's one) and the calls
ROUTING = {part: {"bytes": 0, "count": 0} for part in ROUTING_OPS}


def clear_routing_traffic() -> None:
    for v in ROUTING.values():
        v.update(bytes=0, count=0)


@dataclasses.dataclass(frozen=True)
class GlobalRouting:
    """Rank ``r`` of ``n`` data ranks and their collectives: ``all_gather(t)
    -> (n, *t.shape)``, the ranks' ``t`` in rank order, and ``all_reduce(t)``,
    their sum.  The mesh step passes a process group's; the dry-run passes
    shape-only stand-ins on ``meta``."""

    n: int
    r: int
    all_gather: Callable
    all_reduce: Callable

    def gather(self, part: str, *ts: torch.Tensor) -> list:
        """Each of ``ts`` from every rank, ``(n, *t.shape)``, in one
        all-gather of their bytes."""
        flat = torch.cat([t.contiguous().reshape(-1).view(torch.uint8) for t in ts])
        got = self.all_gather(flat)  # (n, bytes)
        ROUTING[part]["bytes"] += got.numel()
        ROUTING[part]["count"] += 1
        out, o = [], 0
        for t in ts:
            nb = t.numel() * t.element_size()
            out.append(got[:, o:o + nb].contiguous().view(t.dtype).view((self.n,) + tuple(t.shape)))
            o += nb
        return out

    def reduce(self, part: str, t: torch.Tensor) -> torch.Tensor:
        out = self.all_reduce(t)
        ROUTING[part]["bytes"] += out.numel() * out.element_size()
        ROUTING[part]["count"] += 1
        return out


#: the routing over data ranks while ``routing_global`` is entered
_routing = None


@contextlib.contextmanager
def routing_global(routing: GlobalRouting):
    """Within the block every ``moe_ffn`` routes the global microbatch (in
    serving, the global batch) of ``routing.n`` ranks' rows (capacity,
    positions, drops, buffer and, in training, balance loss), in the
    forward and in remat's recompute alike, as
    ``quantization.ranges_reduced`` does for the ranges."""
    global _routing
    prev, _routing = _routing, routing
    try:
        yield
    finally:
        _routing = prev


def routing_traffic(cfg: ArchConfig, tokens: int, n: int, remat: bool, act_bytes: int) -> dict:
    """What the routing collectives move for a rank in one forward and
    backward of a microbatch of ``tokens`` tokens a rank over ``n`` data
    ranks, by part (``ROUTING``'s): every MoE layer gathers its counts and
    buffer (its rows, ``act_bytes`` an element, and its routes' int32
    destinations) and all-reduces its probabilities once a forward (twice
    with remat: the recompute runs them again) and their gradient once."""
    out = {part: {"op": op, "bytes": 0, "count": 0} for part, op in ROUTING_OPS.items()}
    layers = sum(k == "Mm" for k in cfg.layer_kinds) if cfg.moe is not None and n > 1 else 0
    if not layers:
        return out
    e = cfg.moe
    passes = 2 if remat else 1
    each = {"counts": n * e.n_routed * 4, "buffer": n * tokens * (cfg.d_model * act_bytes + e.top_k * 4),
            "balance": e.n_routed * 4, "balance_grad": e.n_routed * 4}
    for part, nbytes in each.items():
        calls = layers * (1 if part == "balance_grad" else passes)
        out[part].update(bytes=calls * nbytes, count=calls)
    return out


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


def _dispatch(experts: torch.Tensor, capacity: int, drop: int, offsets=None):
    """Capacity-based dispatch of the routes ``experts`` (T, k): sort them
    by expert (stable), place each at its position within its expert's
    ``capacity`` rows, and send the overflow to the drop slot ``drop``.
    ``offsets`` (E,): routes that precede these in each expert's global
    order (the ranks before this one), added to every position.
    Returns (order, token of each sorted route, keep, destination row)."""
    tk = experts.numel()
    dev = experts.device
    flat_expert = experts.reshape(tk)
    order = torch.argsort(flat_expert, stable=True)
    se = flat_expert[order]
    st = order // experts.shape[-1]  # route j belongs to token j // k
    pos = torch.arange(tk, device=dev) - torch.searchsorted(se, se, side="left")
    if offsets is not None:
        pos = pos + offsets[se]
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


def _expert_counts(experts: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Routes to each expert, int32 (E,) (a scatter, which ``meta`` runs)."""
    flat = experts.reshape(-1)
    counts = torch.zeros((n_experts,), dtype=torch.int64, device=flat.device)
    return counts.scatter_add_(0, flat, torch.ones_like(flat)).to(torch.int32)


def _global_offsets(counts_all: torch.Tensor, r: int) -> torch.Tensor:
    """Each expert's routes on the ranks before ``r`` (the exclusive prefix
    over ranks of the gathered ``(n, E)`` counts)."""
    return counts_all[:r].to(torch.int64).sum(dim=0)


class _GlobalBuffer(torch.autograd.Function):
    """The global ``(E C + 1, D)`` buffer from this rank's rows ``xf`` (t,
    D) and its sorted routes (``order``, ``dest``): one all-gather of every
    rank's rows and its routes' destinations (in route order), then each
    rank's rows copied to their destinations, as the 1-rank step copies the
    global batch's.  Backward: this rank's rows' gradients alone, read at
    its own destinations and summed over each token's routes, as autograd
    differentiates ``buf.index_copy(0, dest, xf[st])``; no other rank's rows
    get one here (they get theirs from their own combine), so nothing
    moves."""

    @staticmethod
    def forward(ctx, xf, order, dest, routing, size):
        t, k = xf.shape[0], dest.numel() // xf.shape[0]
        by_route = torch.empty_like(dest).scatter_(0, order, dest).to(torch.int32)
        rows, dests = routing.gather("buffer", xf, by_route)
        token = torch.arange(routing.n * t * k, device=xf.device) // k
        buf = torch.zeros((size, xf.shape[1]), dtype=xf.dtype, device=xf.device)
        buf.index_copy_(0, dests.reshape(-1).to(torch.int64), rows.reshape(-1, xf.shape[1])[token])
        ctx.save_for_backward(order, dest)
        ctx.k = k
        return buf

    @staticmethod
    def backward(ctx, g):
        order, dest = ctx.saved_tensors
        st = order // ctx.k
        rows = g.index_select(0, dest)
        gx = torch.zeros((st.numel() // ctx.k, g.shape[1]), dtype=g.dtype, device=g.device)
        return gx.index_put_((st,), rows, accumulate=True), None, None, None, None


class _SumOverRanks(torch.autograd.Function):
    """The sum of ``x`` over the data ranks (an all-reduce).  Every rank's
    loss holds the term it feeds, and the step averages the ranks'
    gradients, so the backward all-reduces the incoming gradient too: an
    identity backward would leave this rank's inputs ``n`` times too
    small a gradient."""

    @staticmethod
    def forward(ctx, x, routing):
        ctx.routing = routing
        return routing.reduce("balance", x)

    @staticmethod
    def backward(ctx, g):
        return ctx.routing.reduce("balance_grad", g), None


def _global_balance_loss(logits: torch.Tensor, counts_all: torch.Tensor, e: MoEConfig,
                         routing: GlobalRouting) -> torch.Tensor:
    """``_balance_loss`` over the global microbatch: the ranks' counts
    summed, the router's probabilities summed over every rank's tokens."""
    dev = logits.device
    n_tokens = routing.n * logits.shape[0]
    probs_mean = _SumOverRanks.apply(L.softmax(logits).sum(dim=0), routing) / scalar(
        float(n_tokens), torch.float32, dev)
    counts = counts_all.to(torch.int64).sum(dim=0).to(torch.float32)
    frac = counts / scalar(float(n_tokens * e.top_k), torch.float32, dev)
    return scalar(float(e.n_routed), torch.float32, dev) * torch.sum(frac * probs_mean)


def _place(xf: torch.Tensor, experts: torch.Tensor, e: MoEConfig, glob, train: bool):
    """The capacity, the dispatch (``_dispatch``'s four) and the ``(E C + 1,
    D)`` expert buffer of rows ``xf`` (T, D) routed to ``experts`` (T, k):
    the single device's, or with ``glob`` (a ``GlobalRouting``) the global
    microbatch's, with the ranks' gathered ``(n, E)`` counts (else None)."""
    t, d = xf.shape
    n = 1 if glob is None else glob.n
    capacity = int(max(1, round(e.capacity_factor * n * t * e.top_k / e.n_routed)))
    drop = e.n_routed * capacity
    if glob is not None:
        (counts_all,) = glob.gather("counts", _expert_counts(experts, e.n_routed))
        routes = _dispatch(experts, capacity, drop, _global_offsets(counts_all, glob.r))
        return capacity, routes, _GlobalBuffer.apply(xf, routes[0], routes[3], glob, drop + 1), counts_all
    order, st, keep, dest = _dispatch(experts, capacity, drop)
    buf = torch.zeros((drop + 1, d), dtype=xf.dtype, device=xf.device)
    if train:
        buf = buf.index_copy(0, dest, xf[st])
    else:
        buf.index_copy_(0, dest, xf[st])  # duplicate writes land in the drop slot
    return capacity, (order, st, keep, dest), buf, None


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
    returns ``(out, aux)``, aux the float32 balance loss.  Within
    ``routing_global`` it routes the global batch of which ``x`` is this
    rank's rows; inside a tensor-parallel serving step
    (``tensor_parallel.sharded``) it runs this model rank's experts and
    gathers every rank's outputs."""
    e, quant = cfg.moe, cfg.quant
    train = mode == "train"
    glob = _routing
    tp = None if train else TP.split()
    b, s, d = x.shape
    t = b * s
    dev = x.device
    xf = x.reshape(t, d)
    logits = xf.to(torch.float32) @ p["router"]["w"].to(torch.float32)
    weights, experts = _route(logits, e, e.top_k)

    capacity, (order, st, keep, dest), buf, counts_all = _place(xf, experts, e, glob, train)
    drop = e.n_routed * capacity
    sw = weights.reshape(-1)[order].to(x.dtype)  # combine weights ride in bf16
    h_in = buf[:drop].reshape(e.n_routed, capacity, d)
    if tp is not None:  # this model rank's experts
        h_in = h_in[tp.cols(e.n_routed)]

    up = expert_qlinear(p["up"], h_in, quant, d, mode=mode)
    gate = expert_qlinear(p["gate"], h_in, quant, d, mode=mode)
    h = L._act("silu", gate.to(torch.float32)).to(x.dtype) * up
    out_e = expert_qlinear(p["down"], h, quant, e.d_expert_ff, mode=mode)
    if tp is not None:  # every rank's experts' rows, in rank order
        out_e = tp.gather_rows(out_e)

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
    if not train:
        return out
    aux = _balance_loss(logits, experts, e) if glob is None else _global_balance_loss(logits, counts_all, e, glob)
    return out, aux
