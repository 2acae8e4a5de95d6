"""Recurrent mixers (port of ``repro.models.ssm``): the Mamba-2 SSD mixer
(block kind ``"s"``, mamba2) and the RG-LRU (``"r"``, recurrentgemma), in
serve mode and in train mode.

The in / out / gate projections are binary-weight ``qlinear`` sites like
any dense layer (K1 on the ``pallas`` backend).  The recurrences are
float32 elementwise and matmul math, plain PyTorch here as plain jnp in the
reference (no ``pallas_call`` there).

Each layer's state is a dict updated IN PLACE, so a replayed CUDA graph
keeps its addresses:

* SSD: ``ssm`` (B, H, P, N) float32, ``conv`` (B, d_conv - 1, C) float32,
  ``pos`` (B,) int32;
* RG-LRU: ``h`` (B, d) float32, ``conv`` (B, 3, d) float32, ``pos`` (B,)
  int32.

The conv window is stored in float32 and computed in the activation dtype
(bf16), as in the reference.  A call with S == 1 is a decode step from the
state; as in the reference, a one-token prompt takes that branch too.  A
call with S > 1 is a prefill: its conv window starts from zeros, and it
carries the recurrent state it is given (zeros after a reset).

Train mode (``mode="train"``, QAT) takes no state: the full-sequence form
from zeros (the zero-padded causal conv, the chunked SSD from a zero state
with the sequence padded to whole chunks, the RG-LRU's associative scan
with no initial ``h``), every projection a train-mode ``qlinear``, and no
tensor on the autograd path written in place.

Float order, mirrored from the reference run op by op on the CPU:

* ``jnp.cumsum``: XLA rewrites a cumulative sum longer than 16 into
  sequential sums over blocks of 16 plus an exclusive cumulative sum of the
  block totals (``_cumsum``);
* ``lax.associative_scan``: its odd/even recursion (``_associative_scan``);
* the three-operand einsums: jax's pairwise order (an elementwise product,
  then the contraction over ``s`` for the chunk states; the contraction
  over ``n``, then the decay product for the carried state's output);
* ``jax.nn.softplus``: ``max(x, 0) + log1p(exp(-|x|))`` (``logaddexp``);
* the bf16 depthwise conv: one rounded product and add at a time, from 0.

Not mirrored: the order in which XLA's CPU dot sums a float32 contraction,
and the transcendental functions (exp, log1p, tanh, sigmoid, sqrt), which
XLA's CPU evaluates with approximations of its own, a float32 ulp or a few
from PyTorch's on some inputs.  ``tests/test_torch_ssm.py`` states the
tolerances.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core import quantization as Q
from repro_torch.models import layers as L

__all__ = [
    "init_ssd",
    "init_ssd_state",
    "ssd_mixer",
    "init_rglru",
    "init_rglru_state",
    "rglru_mixer",
]

_CUMSUM_BLOCK = 16  # XLA's CPU rewrite of a long cumulative sum
_RGLRU_C = 8.0
_RGLRU_CONV = 4


def _randn(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)


# ---------------------------------------------------------------------------
# float order of the reference's scans
# ---------------------------------------------------------------------------


def _seq_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Cumulative sum over the last axis, one add at a time from +0."""
    acc = x[..., 0] + 0.0
    out = [acc]
    for i in range(1, x.shape[-1]):
        acc = acc + x[..., i]
        out.append(acc)
    return torch.stack(out, dim=-1)


def _cumsum(x: torch.Tensor) -> torch.Tensor:
    """``jnp.cumsum(x, axis=-1)`` in the order XLA's CPU computes it: up to
    16 elements in sequence; longer, padded at the end to blocks of 16,
    each block in sequence, plus the exclusive cumulative sum of the block
    totals (itself rewritten the same way past 16 blocks)."""
    n = x.shape[-1]
    if n <= _CUMSUM_BLOCK:
        return _seq_cumsum(x)
    nb = -(-n // _CUMSUM_BLOCK)
    xp = F.pad(x, (0, nb * _CUMSUM_BLOCK - n))
    inner = _seq_cumsum(xp.reshape(*x.shape[:-1], nb, _CUMSUM_BLOCK))
    excl = F.pad(_cumsum(inner[..., -1])[..., :-1], (1, 0))
    return (inner + excl[..., None]).reshape(*x.shape[:-1], nb * _CUMSUM_BLOCK)[..., :n]


def _associative_scan(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.associative_scan`` of ``(a1, b1) . (a2, b2) = (a1 a2, a2 b1 + b2)``
    over axis 1, with jax's recursion: combine adjacent pairs, scan those,
    then fill in the even positions; the interleave adds +0 to every
    element, as jax's pad-and-add does."""
    n = a.shape[1]
    if n < 2:
        return a, b

    def combine(left, right):
        (a1, b1), (a2, b2) = left, right
        return a1 * a2, a2 * b1 + b2

    odd = _associative_scan(*combine((a[:, 0:-1:2], b[:, 0:-1:2]), (a[:, 1::2], b[:, 1::2])))
    if n % 2 == 0:
        even = combine((odd[0][:, :-1], odd[1][:, :-1]), (a[:, 2::2], b[:, 2::2]))
    else:
        even = combine(odd, (a[:, 2::2], b[:, 2::2]))

    def interleave(first, e, o):
        # positions 0, 2, 4, ... from ``first[:, 0]`` and ``e``, the odd ones
        # from ``o``; no tensor written in place, so autograd runs through it
        evens = torch.cat([first[:, :1], e], dim=1)
        if n % 2:
            o = torch.cat([o, torch.zeros_like(evens[:, :1])], dim=1)
        out = torch.stack([evens, o], dim=2).reshape(first.shape[0], -1, *first.shape[2:])
        return out[:, :n] + 0.0

    return interleave(a, even[0], odd[0]), interleave(b, even[1], odd[1])


class _Softplus(torch.autograd.Function):
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` evaluated as jax writes it,
    ``max(x, 0) + log1p(exp(-|x|))`` (``torch.nn.functional.softplus``
    returns ``x`` past 20 instead), differentiated as jax's ``logaddexp``
    is: ``g * exp(x - softplus(x))``.  PyTorch's own backward of the
    expression passes the whole gradient at ``x == 0``, where the
    reference passes half (an exact zero ``dt`` pre-activation happens on
    the SSD's quantized grids)."""

    @staticmethod
    def forward(ctx, x):
        y = torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-x.abs()))
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        return g * torch.exp(x - y)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return _Softplus.apply(x)


def _silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` on float32 (``x * logistic(x)``)."""
    return x * torch.sigmoid(x)


class _DepthwiseConv(torch.autograd.Function):
    """``sum(conv_in[:, i : i + S] * w[i] for i in range(k))`` over a
    (B, S + k - 1, C) window and (k, C) taps, both in the activation dtype,
    each product and add rounded as the reference's Python ``sum`` rounds
    them.  The backward is the reference's: the window's gradient
    accumulated from the last tap to the first, and each tap's the bf16
    sum over the B x S rows of ``conv_in * g``, each add rounded
    (``quantization._tree_sum_rows``: windows of 32 rows in sequence,
    then the window sums).  Up to 32 rows that is the order of XLA's CPU,
    bit for bit; past it XLA's order for a reduce over two axes is its
    own, and the two differ by bf16 ulps.  PyTorch's own backward sums the
    rows in float32 and rounds once (1.5e-2 of the largest tap gradient
    from the reference's on the mamba2 smoke model)."""

    @staticmethod
    def forward(ctx, conv_in, w):
        ctx.save_for_backward(conv_in, w)
        s = conv_in.shape[1] - w.shape[0] + 1
        return sum(conv_in[:, i : i + s] * w[i] for i in range(w.shape[0]))

    @staticmethod
    def backward(ctx, g):
        conv_in, w = ctx.saved_tensors
        k, s = w.shape[0], g.shape[1]
        g_in = torch.zeros_like(conv_in)
        for i in reversed(range(k)):
            g_in[:, i : i + s] = g_in[:, i : i + s] + g * w[i]
        taps = torch.stack([conv_in[:, i : i + s] * g for i in range(k)])  # (k, B, S, C)
        g_w = Q._tree_sum_rows(taps.reshape(k, -1, taps.shape[-1]))[:, 0]
        return g_in, g_w


def _causal_conv(w: torch.Tensor, x: torch.Tensor, window: Optional[torch.Tensor],
                 decode: bool) -> torch.Tensor:
    """Depthwise causal conv of width ``w.shape[0]`` over ``x`` (B, S, C) in
    ``x``'s dtype, each product and add rounded as the reference's Python
    ``sum`` rounds them.  A decode step reads the stored window; a prefill
    starts from zeros.  The window of the last positions is written back
    into ``window`` (float32) in place; train mode passes none."""
    k = w.shape[0]
    b, s, c = x.shape
    if decode:
        conv_in = torch.cat([window.to(x.dtype), x], dim=1)
        window.copy_(conv_in[:, 1:])
    else:
        conv_in = torch.cat([torch.zeros((b, k - 1, c), dtype=x.dtype, device=x.device), x], dim=1)
        if window is not None:
            window.copy_(conv_in[:, -(k - 1):])
    return _DepthwiseConv.apply(conv_in, w.to(x.dtype))


# ---------------------------------------------------------------------------
# Mamba-2 SSD
# ---------------------------------------------------------------------------


def init_ssd(gen: torch.Generator, cfg: ArchConfig) -> dict:
    s = cfg.ssm
    d = cfg.d_model
    di, nh = s.d_inner(d), s.n_heads(d)
    gz = s.n_groups * s.d_state
    zeros = dict(dtype=torch.float32, device=gen.device)
    return {
        # fused input projection, split as [z (di), xBC (di + 2 gz), dt (nh)]
        "in_proj": L.init_linear(gen, d, 2 * di + 2 * gz + nh),
        "out_proj": L.init_linear(gen, di, d, scale=0.5),
        "conv_w": _randn(gen, (s.d_conv, di + 2 * gz)) * 0.2,
        "A_log": torch.zeros((nh,), **zeros),  # A = -exp(A_log)
        "D": torch.ones((nh,), **zeros),
        "dt_bias": torch.zeros((nh,), **zeros),
        "norm_g": torch.zeros((di,), **zeros),  # gated RMSNorm before out_proj
    }


def init_ssd_state(batch: int, cfg: ArchConfig, device="cuda") -> dict:
    s = cfg.ssm
    nh, di = s.n_heads(cfg.d_model), s.d_inner(cfg.d_model)
    gz = s.n_groups * s.d_state
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "ssm": torch.zeros((batch, nh, s.head_dim, s.d_state), **f32),
        "conv": torch.zeros((batch, s.d_conv - 1, di + 2 * gz), **f32),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """(..., T) -> (..., T, T): ``out[i, j] = sum_{j < k <= i} a[k]`` as the
    difference of cumulative sums, -inf above the diagonal."""
    t = a.shape[-1]
    cum = _cumsum(a)
    diff = cum[..., :, None] - cum[..., None, :]
    i = torch.arange(t, device=a.device)
    return torch.where(i[:, None] >= i[None, :], diff, float("-inf"))


def _ssd_chunked(x, dt, a_coef, b_mat, c_mat, chunk: int, init_state: Optional[torch.Tensor] = None):
    """Chunked SSD (mamba2's ``ssd_minimal``), float32.

    x (B, S, H, P), dt (B, S, H), a_coef (H,), b_mat / c_mat (B, S, G, N)
    with G == 1, S a multiple of ``chunk``; init_state (B, H, P, N) or None.
    Returns (y (B, S, H, P), final state (B, H, P, N))."""
    b, s, h, p = x.shape
    g, n = b_mat.shape[-2], b_mat.shape[-1]
    if g != 1:
        raise NotImplementedError("chunked SSD is implemented for n_groups == 1")
    q = chunk
    nc = s // q
    hg = h // g
    xc = x.reshape(b, nc, q, h, p)
    dtc = dt.reshape(b, nc, q, h)
    bc = b_mat.reshape(b, nc, q, g, n)
    cc = c_mat.reshape(b, nc, q, g, n)

    a_bar = (dtc * a_coef[None, None, None, :]).permute(0, 3, 1, 2)  # (B, H, NC, Q)
    a_cum = _cumsum(a_bar)

    # intra-chunk
    l_mat = torch.exp(_segsum(a_bar))  # (B, H, NC, Q, Q)
    cb = torch.einsum("bclgn,bcsgn->bcgls", cc, bc)
    cb = torch.repeat_interleave(cb, hg, dim=2)  # (B, NC, H, Q, Q)
    lh = l_mat.permute(0, 2, 1, 3, 4)
    dt_x = xc * dtc[..., None]  # (B, NC, Q, H, P)
    y_diag = torch.einsum("bcshp,bchls->bchpl", dt_x, cb * lh).permute(0, 1, 4, 2, 3)

    # chunk states: the decay product first, then the contraction over s
    decay_states = torch.exp(a_cum[..., -1:] - a_cum)  # (B, H, NC, Q)
    weighted = decay_states.permute(0, 2, 3, 1)[..., None] * dt_x  # (B, NC, Q, H, P)
    states = torch.einsum("bcshp,bcsn->bchpn", weighted, bc.sum(dim=3))

    # inter-chunk recurrence, in sequence over the chunks
    chunk_decay = torch.exp(a_cum[..., -1])  # (B, H, NC)
    carry = init_state if init_state is not None else x.new_zeros((b, h, p, n))
    prev = []
    for i in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, :, i, None, None] + states[:, i]
    prev_states = torch.stack(prev, dim=1)  # (B, NC, H, P, N): the state before each chunk

    # the carried state's output: the contraction over n, then the decay
    state_decay = torch.exp(a_cum)  # (B, H, NC, Q)
    c_h = torch.repeat_interleave(cc, hg, dim=3)  # (B, NC, Q, H, N)
    y_off = torch.einsum("bchpn,bclhn->bchpl", prev_states, c_h)
    y_off = state_decay.permute(0, 2, 3, 1)[..., None] * y_off.permute(0, 1, 4, 2, 3)

    return (y_diag + y_off).reshape(b, s, h, p), carry


def _check_state(state: Optional[dict], mode: str) -> bool:
    """Whether ``mode`` is train mode, which takes no state (serve mode
    needs one)."""
    if mode == "train":
        if state is not None:
            raise ValueError("train mode is the full-sequence form from zeros; it takes no state")
        return True
    if mode != "serve":
        raise ValueError(f"unknown mode {mode!r}")
    return False


def ssd_mixer(p: dict, x: torch.Tensor, cfg: ArchConfig, state: Optional[dict],
              mode: str = "serve") -> Tuple[torch.Tensor, Optional[dict]]:
    """The mamba2 block's mixer: in_proj -> conv -> SSD -> gated norm ->
    out_proj.  x (B, S, D) bf16.  Returns (out (B, S, D), state), the state
    updated in place; in train mode (``state=None``) (out, None)."""
    train = _check_state(state, mode)
    s_cfg = cfg.ssm
    di, nh = s_cfg.d_inner(cfg.d_model), s_cfg.n_heads(cfg.d_model)
    gz = s_cfg.n_groups * s_cfg.d_state
    b, s, _ = x.shape
    decode = not train and s == 1

    zxbcdt = L.qlinear(p["in_proj"], x, cfg.quant, mode=mode, name="ssm.in_proj")
    z, xbc, dt_raw = torch.split(zxbcdt, [di, di + 2 * gz, nh], dim=-1)
    conv_out = _causal_conv(p["conv_w"], xbc, None if train else state["conv"], decode)
    xbc = _silu(conv_out.to(torch.float32)).to(x.dtype)

    xs, b_mat, c_mat = torch.split(xbc, [di, gz, gz], dim=-1)
    xh = xs.reshape(b, s, nh, s_cfg.head_dim)
    bm = b_mat.reshape(b, s, s_cfg.n_groups, s_cfg.d_state)
    cm = c_mat.reshape(b, s, s_cfg.n_groups, s_cfg.d_state)
    dt = _softplus(dt_raw.to(torch.float32) + p["dt_bias"])  # (B, S, H)
    a_coef = -torch.exp(p["A_log"])

    if decode:
        # h' = exp(dt A) h + dt B x;  y = C h' + D x
        st = state["ssm"]
        dec = torch.exp(dt[:, 0] * a_coef[None, :])  # (B, H)
        rep = nh // s_cfg.n_groups
        bm0 = torch.repeat_interleave(bm[:, 0], rep, dim=1)  # (B, H, N)
        cm0 = torch.repeat_interleave(cm[:, 0], rep, dim=1)
        upd = (dt[:, 0, :, None] * xh[:, 0])[..., None] * bm0[:, :, None, :]
        new_st = st * dec[..., None, None] + upd
        y = torch.einsum("bhpn,bhn->bhp", new_st, cm0.to(torch.float32))
        y = y + p["D"][None, :, None] * xh[:, 0].to(torch.float32)
        y = y.reshape(b, 1, di)
        st.copy_(new_st)
    else:
        q = min(s_cfg.chunk, s)
        pad_len = (-s) % q
        if pad_len:
            xh, bm, cm, dt = (F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad_len)) for t in (xh, bm, cm, dt))
        y, fin = _ssd_chunked(xh.to(torch.float32), dt, a_coef, bm.to(torch.float32),
                              cm.to(torch.float32), q, None if train else state["ssm"])
        y = y[:, :s]
        y = y + p["D"][None, None, :, None] * xh[:, :s].to(torch.float32)
        y = y.reshape(b, s, di)
        if not train:
            state["ssm"].copy_(fin)
    if not train:
        state["pos"] += s

    # gated RMSNorm, then the output projection
    gated = y.to(x.dtype) * _silu(z.to(torch.float32)).to(x.dtype)
    y = L.rmsnorm(p["norm_g"], gated, cfg.norm_eps)
    return L.qlinear(p["out_proj"], y, cfg.quant, mode=mode, name="ssm.out_proj"), state


# ---------------------------------------------------------------------------
# RG-LRU (recurrentgemma's recurrent block)
# ---------------------------------------------------------------------------


def init_rglru(gen: torch.Generator, cfg: ArchConfig) -> dict:
    d = cfg.d_model  # the recurrence is d_model wide
    return {
        "in_x": L.init_linear(gen, d, d),
        "in_gate": L.init_linear(gen, d, d),
        "conv_w": _randn(gen, (_RGLRU_CONV, d)) * 0.2,
        "gate_a": L.init_linear(gen, d, d),  # recurrence gate r_t
        "gate_i": L.init_linear(gen, d, d),  # input gate i_t
        "lambda_p": torch.full((d,), 4.0, dtype=torch.float32, device=gen.device),  # a = sigmoid(lambda)
        "out": L.init_linear(gen, d, d, scale=0.5),
    }


def init_rglru_state(batch: int, cfg: ArchConfig, device="cuda") -> dict:
    d = cfg.d_model
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "h": torch.zeros((batch, d), **f32),
        "conv": torch.zeros((batch, _RGLRU_CONV - 1, d), **f32),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def rglru_mixer(p: dict, x: torch.Tensor, cfg: ArchConfig, state: Optional[dict],
                mode: str = "serve") -> Tuple[torch.Tensor, Optional[dict]]:
    """RG-LRU block (Griffin / recurrentgemma): two branches, conv1d(4) on
    one, the gated linear recurrence, the gelu-gated output.  x (B, S, D)
    bf16.  Returns (out (B, S, D), state), the state updated in place; in
    train mode (``state=None``) (out, None), the scan from no initial
    ``h``."""
    train = _check_state(state, mode)
    quant = cfg.quant
    s = x.shape[1]
    decode = not train and s == 1
    xb = L.qlinear(p["in_x"], x, quant, mode=mode, name="rglru.in_x")
    gate = L.qlinear(p["in_gate"], x, quant, mode=mode, name="rglru.in_gate")
    xb = _causal_conv(p["conv_w"], xb, None if train else state["conv"], decode)

    # gates: float32, elementwise
    r = torch.sigmoid(L.qlinear(p["gate_a"], xb, quant, mode=mode, name="rglru.gate_a").to(torch.float32))
    i_g = torch.sigmoid(L.qlinear(p["gate_i"], xb, quant, mode=mode, name="rglru.gate_i").to(torch.float32))
    log_a = (-_RGLRU_C * _softplus(p["lambda_p"]))[None, None, :] * r
    a = torch.exp(log_a)
    gated_x = xb.to(torch.float32) * i_g
    mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))

    if decode:
        h = a[:, 0] * state["h"] + mult[:, 0] * gated_x[:, 0]
        y = h[:, None]
    else:
        # the linear recurrence h_t = a_t h_{t-1} + b_t as an associative scan
        a_scan, y = _associative_scan(a, mult * gated_x)
        if not train:
            y = y + a_scan * state["h"][:, None, :]
            h = y[:, -1]
    if not train:
        state["h"].copy_(h)
        state["pos"] += s

    out = y.to(x.dtype) * L.gelu(gate.to(torch.float32)).to(x.dtype)
    return L.qlinear(p["out"], out, quant, mode=mode, name="rglru.out"), state
