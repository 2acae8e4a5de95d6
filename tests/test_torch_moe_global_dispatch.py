"""The global dispatch of ``models/moe.py`` without processes: the
prefix-offset rule that places a rank's routes where the global stable
sort puts them, the balance statistics summed over rank slices, and a
train-mode MoE layer over 1-4 ranks run one after another (each
collective answered with the ranks' inputs to the same call, rounds
repeated until none changes) against the whole microbatch's layer."""

import dataclasses
import itertools

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.configs import get_config
from repro_torch.configs.smoke import smoke_variant
from repro_torch.core import quantization as Q
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from torch_dist_workers import moe_spy

ULP4 = 4 * np.finfo(np.float32).eps


def _experts(seed: int, tokens: int, n_experts: int, k: int) -> torch.Tensor:
    """(tokens, k) distinct experts a token, as ``_route``'s top-k gives."""
    rng = np.random.default_rng(seed)
    rows = [rng.permutation(n_experts)[:k] for _ in range(tokens)]
    return torch.as_tensor(np.stack(rows), dtype=torch.int64)


def _sliced(experts: torch.Tensor, n: int, capacity: int, drop: int) -> list:
    """Each rank's dispatch of its slice of ``experts`` by the prefix-offset
    rule, over the ranks' gathered counts."""
    t = experts.shape[0] // n
    slices = [experts[r * t:(r + 1) * t] for r in range(n)]
    counts = torch.stack([M._expert_counts(s, _n_experts(experts)) for s in slices])
    return [M._dispatch(s, capacity, drop, M._global_offsets(counts, r)) for r, s in enumerate(slices)]


def _n_experts(experts: torch.Tensor) -> int:
    """The experts a route array names (its largest index + 1)."""
    return int(experts.max()) + 1


def _restricted(whole, r: int, t: int, k: int):
    """The whole dispatch's sorted routes of rank ``r``'s tokens, in the
    rank's own numbering."""
    order, st_, keep, dest = whole
    mine = st_ // t == r
    return order[mine] - r * t * k, st_[mine] - r * t, keep[mine], dest[mine]


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), n=st.integers(1, 4), t=st.integers(1, 12),
       n_experts=st.integers(2, 8), k=st.integers(1, 3), cf=st.sampled_from([0.25, 0.5, 0.75, 1.0]))
def test_prefix_offsets_give_the_whole_dispatch(seed, n, t, n_experts, k, cf):
    """Cut the routes into ``n`` rank slices of ``t`` tokens: each slice's
    dispatch with the exclusive prefix of the ranks' per-expert counts is
    ``_dispatch`` of the whole array restricted to its tokens, element for
    element (order, token, keep, destination), at capacity factors that
    force overflow."""
    k = min(k, n_experts)
    experts = _experts(seed, n * t, n_experts, k)
    e = max(n_experts, _n_experts(experts))
    capacity = int(max(1, round(cf * n * t * k / e)))
    drop = e * capacity
    whole = M._dispatch(experts, capacity, drop)
    counts = torch.stack([M._expert_counts(experts[r * t:(r + 1) * t], e) for r in range(n)])
    for r in range(n):
        got = M._dispatch(experts[r * t:(r + 1) * t], capacity, drop, M._global_offsets(counts, r))
        for a, b in zip(got, _restricted(whole, r, t, k)):
            assert torch.equal(a, b)


def test_rank_zero_fills_an_expert_and_rank_one_is_dropped():
    """Rank 0 sends expert 0 its 3 routes, the global capacity: rank 1's two
    routes to expert 0 are dropped, though local routing (capacity 2 for its
    3 routes) would keep them; its route to expert 1 lands in expert 1's
    first row."""
    experts = torch.tensor([[0], [0], [0], [0], [1], [0]])
    capacity, drop = 3, 2 * 3
    r1 = _sliced(experts, 2, capacity, drop)[1]
    order, st_, keep, dest = r1
    assert st_.tolist() == [0, 2, 1] and keep.tolist() == [False, False, True]
    assert dest.tolist() == [drop, drop, 1 * capacity + 0]
    local = M._dispatch(experts[3:], 2, 2 * 2)
    assert local[2].tolist() == [True, True, True]


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), n=st.integers(1, 4), t=st.integers(1, 16))
def test_balance_statistics_sum_over_slices(seed, n, t):
    """The ranks' expert counts sum to the whole's exactly; the router's
    probabilities summed a slice at a time are the whole's sum to 4 ulps of
    its scale (softmax is by row, so the slices' rows are the whole's)."""
    gen = torch.Generator().manual_seed(seed)
    logits = torch.randn((n * t, 8), generator=gen) * 3
    experts = _experts(seed, n * t, 8, 2)
    counts = sum(M._expert_counts(experts[r * t:(r + 1) * t], 8).to(torch.int64) for r in range(n))
    assert torch.equal(counts, torch.bincount(experts.reshape(-1), minlength=8))
    probs = L.softmax(logits)
    sliced = sum(L.softmax(logits[r * t:(r + 1) * t]).sum(dim=0) for r in range(n))
    whole = probs.sum(dim=0)
    assert float((sliced - whole).abs().max()) <= ULP4 * float(whole.abs().max())


def _rank_by_rank(n: int, fn):
    """``fn(r, routing, ranges)`` for every rank ``r`` of ``n``, run one
    after another: each collective call (the routing's, and the fake-quant
    ranges' MIN / MAX) returns the ranks' inputs to that call as the last
    round left them; rounds repeat until no rank's input to any call
    changes.  Returns the results and ``again(r)``, which runs rank ``r``
    once more on the settled inputs."""
    inputs = {}
    changed = [False]

    def collectives(r):
        calls = itertools.count()

        def take(t):
            row = inputs.setdefault(next(calls), [None] * n)
            if row[r] is None or row[r].shape != t.shape or not torch.equal(row[r], t):
                row[r] = t.detach().clone()
                changed[0] = True
            return torch.stack([torch.zeros_like(t) if x is None or x.shape != t.shape else x for x in row])

        def ranges(lo, hi):
            both = take(torch.stack([-lo.to(torch.float32), hi.to(torch.float32)]))
            return (-both[:, 0].max()).to(lo.dtype), both[:, 1].max().to(hi.dtype)

        routing = M.GlobalRouting(n=n, r=r, all_gather=take, all_reduce=lambda t: take(t).sum(dim=0))
        return routing, ranges

    def again(r):
        return fn(r, *collectives(r))

    for _ in range(10):
        changed[0] = False
        results = [again(r) for r in range(n)]
        if not changed[0]:
            return results, again
    raise AssertionError("the ranks' collective inputs did not settle")


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_layer_over_ranks_equals_the_whole_microbatch(n):
    """deepseek-v2-lite smoke's MoE layer in train mode (capacity factor
    0.75, so routes drop), the microbatch of ``n`` x 3 rows split over
    ``n`` ranks with their fake-quant ranges reduced: each rank's routes,
    ``keep`` and ``dest`` are the whole layer's restricted to its tokens,
    its expert buffer and output rows the whole layer's bit for bit, its
    balance loss within 4 float32 ulps.  Backward of ``sum(out * ct) + aux
    / n`` (the mesh step divides the ranks' summed gradients by ``n``):
    each rank's input gradient is the whole layer's rows of it, bit for
    bit where ``n`` is a power of 2.  One rank's routing collectives carry
    what ``routing_traffic`` plans (one pass, no remat; none over one
    rank, which the mesh step routes as one device)."""
    cfg = smoke_variant(get_config("deepseek-v2-lite-16b"))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=0.75))
    gen = torch.Generator().manual_seed(n)
    p = M.init_moe(gen, cfg)
    b, s = 3, 5
    x = torch.randn((n * b, s, cfg.d_model), generator=gen).to(torch.bfloat16)
    ct = torch.randn((n * b, s, cfg.d_model), generator=gen).to(torch.bfloat16)

    def layer(xs, cts, aux_scale):
        xs = xs.detach().requires_grad_(True)
        seen = []
        with moe_spy(seen):
            out, aux = M.moe_ffn(p, xs, cfg, mode="train")
        ((out.float() * cts.float()).sum() + aux * aux_scale).backward()
        return out.detach(), aux.detach(), xs.grad, seen[0]

    want_out, want_aux, want_gx, want = layer(x, ct, 1.0)
    assert not bool(want["keep"].all())

    def rank(r, routing, ranges):
        rows = slice(r * b, (r + 1) * b)
        with M.routing_global(routing), Q.ranges_reduced(ranges):
            return layer(x[rows], ct[rows], 1.0 / n)

    runs, again = _rank_by_rank(n, rank)
    t = b * s
    for r, (out, aux, gx, got) in enumerate(runs):
        rows = slice(r * b, (r + 1) * b)
        assert torch.equal(out, want_out[rows])
        assert abs(float(aux) - float(want_aux)) <= ULP4 * float(want_aux)
        assert torch.equal(got["experts"], want["experts"][r * t:(r + 1) * t])
        mine = want["st"] // t == r
        for key in ("keep", "dest"):
            assert torch.equal(got[key], want[key][mine]), key
        assert torch.equal(got["h_in"], want["h_in"])
        if n in (1, 2, 4):
            assert torch.equal(gx, want_gx[rows])
        else:
            assert float((gx.float() - want_gx[rows].float()).abs().max()) <= 2.0 ** -7 * float(
                want_gx.float().abs().max())
    M.clear_routing_traffic()
    again(n - 1)
    plan = M.routing_traffic(cfg, t, n, remat=False, act_bytes=x.element_size())
    live = {part: {"op": M.ROUTING_OPS[part], **v} for part, v in M.ROUTING.items()}
    if n > 1:
        assert live == plan and plan["buffer"]["count"] == 1
    else:  # the mesh step routes one data rank as one device does: no collective
        assert all(v["count"] == 0 for v in plan.values())
