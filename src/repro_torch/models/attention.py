"""GQA and MLA attention (port of ``repro.models.attention`` for ``kind``
``"g"``, ``"l"``, ``"Md"`` and ``"Mm"``), in serve mode and in train mode.

Train mode (QAT, ``mode="train"``): full-sequence attention over the
in-flight keys and values (or, for cross-attention, an encoder's), no
cache; under quantized attention q, k and the probabilities are
fake-quantized per tensor at ``attn_act_bits`` around the float scores
and a float P.V, as the reference trains.  MLA trains in its decompressed
form (``mla_attention``): q_nope and the up-projected k_nope
fake-quantized, the rope parts not.

``cfg.attn_scores_dtype="bf16"``: every full-sequence pass (a prefill, a
stateless or cross-attention pass, training; GQA and MLA's decompressed
form) takes its scores, their scaling and mask and the softmax in bf16,
as the reference's variant does: the float scores as a bf16 product, the
integer ones cast after their epilogue.  A decode step over the cache
keeps float32 scores.

With quantized attention QK^T and PV run as activation x activation
integer products through the flow abstraction, grouped over kv heads;
softmax stays float32.  The int8 cache holds re-centered mantissas with
per-row (per-slot) affines and cursors, so co-batched requests never share
a quantization grid.

Float caches: where the config's quantization is off (``FLOAT_QUANT``) or
``kv_cache_bits`` is 16, the GQA cache holds bf16 ``k`` / ``v`` rows and
MLA's latent ``ckv`` is bf16, with only the cursor beside them.  Scores and
context are then float, as the reference computes them: float32 scores,
float32 softmax, P.V in the activation dtype; MLA's absorbed decode runs
its two products in float32.  ``quantize_attention=False`` under quantized
linears keeps the int8 cache but takes the float path over it,
dequantized.

Unlike the reference, the cache is updated IN PLACE (``index_copy_`` /
``index_put_``): prefill and decode return the same dict they were given.

Positions are rotary or learned (added at the embedding, so nothing here);
prefill is causal or not as ``cfg.causal`` says.  ``cfg.qk_norm`` applies a
per-head RMSNorm to q and k before rope.  A ``"l"`` (local) layer attends
over the last ``cfg.window_size`` positions, rotated with
``cfg.local_rope_theta`` when that is set; its cache is a RING BUFFER of
``window_size`` rows when ``max_len`` exceeds the window (position ``p``
lives in row ``p % window_size``), else ``max_len`` rows masked to the
window.  The cursor ``pos`` is absolute in every layer.

Multi-head latent attention (MLA, deepseek v2/v3; layer kinds ``"Md"`` and
``"Mm"``) keeps one head-shared latent per token instead of per-head keys
and values: an int8 latent ``ckv`` (B, L, kv_lora_rank) with per-row
affines and a bf16 rope key ``k_rope`` (B, L, qk_rope_dim).  Its prefill
runs the decompressed form (keys and values up-projected from the float
latent, float scores, the causal mask); its decode runs the absorbed form,
two act x act integer products against the latent cache with the heads
folded into M.

Without a cache (``cache=None``) GQA attention is stateless: the integer
path over the in-flight keys and values of the whole sequence, nothing
written (an encoder's self-attention).  Cross-attention passes the
encoder's keys and values as ``kv_override``: no rope and no cache, float32
scores and a float P.V in the activation dtype, as the reference computes
it.  Sinusoidal positions are added at an encoder's input, so attention
applies rope only for ``"rope"``.

Bitwise attention: a scores-only backend (``"binary"``, ``"float"``) named
for the site ``"attn.qk"`` binarizes Q per call and K at the prompt
(BiT's elastic 1-bit grid, per row) and stores K as PACKED 1-bit rows,
int32 words ``(B, L, kvH, ceil(dh/32))``; the scores are AND-popcount
counts from the scores family (``kernels.ops.binary_attn_scores``; under
``"binary"`` its core is ``"auto"``, under ``"float"`` the float core) and
an affine epilogue; V stays int8.  MLA's absorbed decode scores take the
same path where ``"attn.qk_latent"`` names one, its int8 latent cache
re-binarized at its grid midpoint.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig, QuantConfig
from repro_torch.core import backend_registry, packing, site_log
from repro_torch.core import flow_abstraction as FA
from repro_torch.core import quantization as Q
from repro_torch.core.constants import scalar
from repro_torch.kernels import ops as K_ops
from repro_torch.models import layers as L

__all__ = [
    "init_attention",
    "cache_rows",
    "init_kv_cache",
    "attention",
    "init_mla",
    "init_mla_cache",
    "mla_attention",
]

MLA_KINDS = ("Md", "Mm")

_NEG_INF = -1e30


def init_attention(gen: torch.Generator, cfg: ArchConfig) -> dict:
    h, kvh, dh, d = cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.d_model
    p = {
        "q": L.init_linear(gen, d, h * dh),
        "k": L.init_linear(gen, d, kvh * dh),
        "v": L.init_linear(gen, d, kvh * dh),
        "o": L.init_linear(gen, h * dh, d, scale=0.5),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((dh,), dtype=torch.float32, device=gen.device)
        p["k_norm"] = torch.zeros((dh,), dtype=torch.float32, device=gen.device)
    return p


def _check_supported(cfg: ArchConfig, kind: str) -> None:
    if kind not in ("g", "l") + MLA_KINDS:
        raise NotImplementedError(
            f"attention kind {kind!r} is not ported yet (only 'g', 'l', 'Md', 'Mm')")
    if kind in MLA_KINDS and (cfg.mla is None or cfg.pos_embedding != "rope"):
        raise NotImplementedError(f"{kind!r} layers need cfg.mla and rotary positions")
    if cfg.pos_embedding not in ("rope", "learned", "sinusoidal"):
        raise NotImplementedError(f"attention with pos_embedding {cfg.pos_embedding!r}")


def cache_rows(max_len: int, cfg: ArchConfig, kind: str) -> int:
    """Rows of a ``kind`` layer's cache for ``max_len`` positions: a local
    layer never needs more than its window (the ring buffer); a global or
    MLA layer holds ``max_len``."""
    if kind == "l" and cfg.window_size:
        return min(max_len, cfg.window_size)
    return max_len


def _quantized_cache(quant: QuantConfig) -> bool:
    return quant.enabled and quant.kv_cache_bits in (4, 8)


def init_kv_cache(
    batch: int, max_len: int, cfg: ArchConfig, kind: str = "g", device="cuda"
) -> dict:
    """KV cache with per-row ``pos`` cursors, ``cache_rows(max_len, cfg,
    kind)`` rows (an MLA kind gets its latent cache, ``init_mla_cache``):
    int8 with per-row calibration affines where the config quantizes its
    cache, else bf16.  Where ``"attn.qk"`` engages bitwise attention, K
    holds packed 1-bit rows, int32 ``(batch, rows, kvH, ceil(dh/32))``."""
    _check_supported(cfg, kind)
    if kind in MLA_KINDS:
        return init_mla_cache(batch, max_len, cfg, device=device)
    kvh, dh = cfg.n_kv_heads, cfg.d_head
    rows = cache_rows(max_len, cfg, kind)
    if not _quantized_cache(cfg.quant):
        bf16 = dict(dtype=torch.bfloat16, device=device)
        return {
            "k": torch.zeros((batch, rows, kvh, dh), **bf16),
            "v": torch.zeros((batch, rows, kvh, dh), **bf16),
            "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
        }
    f32 = dict(dtype=torch.float32, device=device)
    if _binary_scores_site(cfg.quant, "attn.qk") is not None:
        k = torch.zeros((batch, rows, kvh, packing.packed_len(dh, 1)), dtype=torch.int32, device=device)
    else:
        k = torch.zeros((batch, rows, kvh, dh), dtype=torch.int8, device=device)
    return {
        "k": k,
        "v": torch.zeros((batch, rows, kvh, dh), dtype=torch.int8, device=device),
        "k_scale": torch.ones((batch,), **f32),
        "k_offset": torch.zeros((batch,), **f32),
        "v_scale": torch.ones((batch,), **f32),
        "v_offset": torch.zeros((batch,), **f32),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def _per_row(s: torch.Tensor, ndim: int) -> torch.Tensor:
    """Broadcast a per-row ``(B,)`` affine against a rank-``ndim`` operand."""
    return s.reshape(s.shape + (1,) * (ndim - 1))


def _calibrate_rows(x: torch.Tensor):
    """Per-row min / (max-min)/255 over every axis but the batch row."""
    x32 = x.to(torch.float32).reshape(x.shape[0], -1)
    off = x32.amin(dim=-1)
    sc = torch.clamp((x32.amax(dim=-1) - off) / 255.0, min=1e-8)
    return sc, off


def _quantize_to_cache(x: torch.Tensor, scale, offset) -> torch.Tensor:
    """Quantize with a fixed (prefill-calibrated) affine, re-centered int8."""
    scale = _per_row(scale, x.ndim)
    offset = _per_row(offset, x.ndim)
    q = torch.clamp(torch.round((x.to(torch.float32) - offset) / scale), 0.0, 255.0)
    return (q - 128.0).to(torch.int8)


def _dequantize_from_cache(m: torch.Tensor, scale, offset, dtype) -> torch.Tensor:
    """Re-centered int8 mantissas back to values, in ``dtype``."""
    scale = _per_row(scale, m.ndim)
    offset = _per_row(offset, m.ndim)
    return ((m.to(torch.float32) + 128.0) * scale + offset).to(dtype)


def _int_einsum(spec: str, a: torch.Tensor, b: torch.Tensor, k: int) -> torch.Tensor:
    """int8 x int8 einsum with exact integer results (int32).

    Runs in float64 (CUDA has no integer einsum, and float32 is exact only
    below 2**24: PV partial sums reach ``t * 2**14``, past 2**24 beyond
    t = 1024).  ``k`` is the contraction length; the bound is asserted.
    """
    bound = k * 2**14
    if bound > 2**53:
        raise ValueError(f"int einsum bound {bound} exceeds 2**53")
    out = torch.einsum(spec, a.to(torch.float64), b.to(torch.float64))
    return out.to(torch.int32)


def _scores_int(q, k_mantissa, k_scale, k_offset, attn_bits: int, backend: str = "auto"):
    """Integer QK^T, grouped over kv heads.

    q: (B,S,H,dh) float, quantized per row to ``attn_bits`` (at 1 bit the
    {0, 1} mantissa passes re-centering unchanged).  k_mantissa:
    (B,T,kvH,dh) int8 re-centered cache mantissas.  ``backend`` is the
    site's configured name (the site log's record only).  Returns float32
    (B,H,S,T).
    """
    b, s, h, dh = q.shape
    t, kvh = k_mantissa.shape[1], k_mantissa.shape[2]
    g = h // kvh
    qq = Q.quantize_activation(q.to(torch.float32), attn_bits, per_channel_axis=0)
    qr = Q.recenter(qq)
    if site_log.is_recording():
        site_log.record(kind="attn", site="attn.qk", bits=attn_bits,
                        mantissa_dtype=site_log.dtype_name(qr.mantissa.dtype), backend=backend)
    x1 = qr.mantissa.reshape(b, s, kvh, g, dh)
    x2 = k_mantissa
    xy = _int_einsum("bskgd,btkd->bkgst", x1, x2, dh).to(torch.float32)
    a1 = qr.scale.reshape(b, 1, 1, 1, 1)
    g1 = qr.offset.reshape(b, 1, 1, 1, 1)
    a2 = _per_row(k_scale, 5)
    g2 = _per_row(k_offset, 5) + 128.0 * a2  # cache mantissa re-centered by 128
    row = torch.sum(x1, dim=-1, dtype=torch.int32).to(torch.float32)  # (B,S,kvH,G)
    row = row.permute(0, 2, 3, 1)[..., None]  # (B,kvH,G,S,1)
    col = torch.sum(x2, dim=-1, dtype=torch.int32).to(torch.float32)  # (B,T,kvH)
    col = col.permute(0, 2, 1)[:, :, None, None, :]  # (B,kvH,1,1,T)
    out = xy * (a1 * a2) + (a1 * g2) * row + (g1 * a2) * col + g1 * g2 * dh
    return out.reshape(b, h, s, t)


def _pv_int(p_probs, v_mantissa, v_scale, v_offset):
    """Integer P @ V, grouped over kv heads.  Probabilities are quantized
    exactly onto the W8 grid (scale 1/255, offset 0)."""
    b, h, s, t = p_probs.shape
    kvh, dh = v_mantissa.shape[2], v_mantissa.shape[3]
    g = h // kvh
    pm = torch.clamp(torch.round(p_probs * 255.0), 0, 255.0)
    x1 = (pm - 128.0).to(torch.int8).reshape(b, kvh, g, s, t)
    dev = p_probs.device
    a1 = scalar(1.0 / 255.0, torch.float32, dev)
    g1 = scalar(128.0 / 255.0, torch.float32, dev)
    x2 = v_mantissa
    a2 = _per_row(v_scale, 5)
    g2 = _per_row(v_offset, 5) + 128.0 * a2
    xy = _int_einsum("bkgst,btkd->bkgsd", x1, x2, t).to(torch.float32)
    row = torch.sum(x1, dim=-1, dtype=torch.int32)[..., None].to(torch.float32)
    col = torch.sum(x2, dim=1, dtype=torch.int32).to(torch.float32)  # (B,kvH,dh)
    col = col[:, :, None, None, :]
    out = xy * (a1 * a2) + (a1 * g2) * row + (g1 * a2) * col + g1 * g2 * t
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, dh)


# ---------------------------------------------------------------------------
# bitwise attention (Bitformer scores through the scores backend family)
# ---------------------------------------------------------------------------


def _binary_scores_site(quant: QuantConfig, site: str) -> Optional[str]:
    """The scores-only backend configured for ``site``, or None: only such
    a name engages bitwise attention there (binarizing K is a precision
    choice, so ``"auto"`` and qmm-family names leave the int8 path)."""
    if not (quant.enabled and quant.quantize_attention):
        return None
    name = quant.backend_for(site)
    if name == "auto":
        return None
    spec = backend_registry.get_backend(name)
    return name if "scores" in spec.families and "qmm" not in spec.families else None


def _scores_core(site_backend: str) -> str:
    """``"binary"`` engages the family and leaves its core to measured
    dispatch (every scores core is exact); any other scores-only name pins
    its own core."""
    return "auto" if site_backend == "binary" else site_backend


def _cache_binary(cache: Optional[dict], dh: int) -> bool:
    """Does this cache hold packed 1-bit K rows (int32, ceil(dh/32) words)?"""
    return (cache is not None and cache["k"].dtype == torch.int32
            and cache["k"].shape[-1] == packing.packed_len(dh, 1))


def _binarize_rows(x: torch.Tensor) -> Q.QuantTensor:
    """Per-row elastic 1-bit grid (BiT), min / max over every axis but the
    batch row: co-batched requests never share a grid."""
    return Q.quantize_activation(x.to(torch.float32), 1, per_channel_axis=0)


def _binarize_to_cache(k: torch.Tensor, scale, offset) -> torch.Tensor:
    """Binarize with a fixed (prefill-calibrated) affine and pack: a decode
    step's packed K row."""
    scale = _per_row(scale, k.ndim)
    offset = _per_row(offset, k.ndim)
    bit = torch.clamp(torch.round((k.to(torch.float32) - offset) / scale), 0.0, 1.0)
    return packing.pack_bits(bit, 1, axis=-1)


def _pack_q_heads(bits: torch.Tensor) -> torch.Tensor:
    """(B, S, H, dh) {0, 1} mantissas -> (B, H, S, dw) packed words (a view)."""
    return packing.pack_bits(bits, 1, axis=-1).transpose(1, 2)


def _plane_popcounts(planes: torch.Tensor) -> torch.Tensor:
    """Set bits of each packed row, float32 (exact: packing zeroes the tail)."""
    return packing.popcount32(planes).sum(dim=-1, dtype=torch.int32).to(torch.float32)


def _scores_binary(q, k_planes_t, k_scale, k_offset, dh: int, backend: str):
    """Bitwise QK^T: 1-bit Q (binarized here, per row) against packed K.

    AND-popcount counts from the scores family, then the affine epilogue in
    the reference's order:
    ``counts*(a1*a2) + (a1*g2)*row + (g1*a2)*col + g1*g2*dh``.
    q: (B,S,H,dh) float.  k_planes_t: (B,kvH,T,dw) packed key rows (a
    strided view of the cache).  k_scale / k_offset: (B,) the keys' 1-bit
    grid (no re-centering shift, unlike the int8 cache).  Returns float32
    (B,H,S,T).
    """
    b, s, h, _ = q.shape
    g = h // k_planes_t.shape[1]
    qq = _binarize_rows(q)
    if site_log.is_recording():
        site_log.record(kind="attn", site="attn.qk", bits=1,
                        mantissa_dtype=site_log.dtype_name(qq.mantissa.dtype), backend=backend)
    q_planes = _pack_q_heads(qq.mantissa)  # (B,H,S,dw)
    counts = K_ops.binary_attn_scores(
        q_planes, k_planes_t, dh=dh, backend=_scores_core(backend)
    ).to(torch.float32)
    row = _plane_popcounts(q_planes)[..., None]  # (B,H,S,1)
    kvh, t = k_planes_t.shape[1], k_planes_t.shape[2]
    col = _plane_popcounts(k_planes_t)[:, :, None, :].expand(b, kvh, g, t).reshape(b, h, 1, t)
    a1 = qq.scale.reshape(b, 1, 1, 1)
    g1 = qq.offset.reshape(b, 1, 1, 1)
    a2 = _per_row(k_scale, 4)
    g2 = _per_row(k_offset, 4)
    return counts * (a1 * a2) + (a1 * g2) * row + (g1 * a2) * col + g1 * g2 * dh


def _scores_binary_latent(q_abs, ckv_m, ckv_scale, ckv_offset, backend: str):
    """Bitwise absorbed-MLA scores against the int8 latent cache, which
    keeps its layout (it feeds the P.V product too): each mantissa is
    re-binarized at its grid midpoint, ``bit = (m >= 0)``, with the induced
    affine ``ak = 128*sc``, ``gk = off + 64*sc``.  q_abs (B,S,H,R) float;
    returns float32 (B,H,S,T)."""
    b, s, h, r = q_abs.shape
    qq = _binarize_rows(q_abs)
    if site_log.is_recording():
        site_log.record(kind="attn", site="attn.qk_latent", bits=1,
                        mantissa_dtype=site_log.dtype_name(qq.mantissa.dtype), backend=backend)
    q_planes = _pack_q_heads(qq.mantissa)  # (B,H,S,rw)
    k_planes = packing.pack_bits(ckv_m >= 0, 1, axis=-1)[:, None]  # (B,1,T,rw)
    counts = K_ops.binary_attn_scores(
        q_planes, k_planes, dh=r, backend=_scores_core(backend)
    ).to(torch.float32)
    row = _plane_popcounts(q_planes)[..., None]  # (B,H,S,1)
    col = _plane_popcounts(k_planes)[:, :, None, :]  # (B,1,1,T)
    sc = ckv_scale.to(torch.float32)
    off = ckv_offset.to(torch.float32)
    a1 = qq.scale.reshape(b, 1, 1, 1)
    g1 = qq.offset.reshape(b, 1, 1, 1)
    a2 = _per_row(128.0 * sc, 4)
    g2 = _per_row(off + 64.0 * sc, 4)
    return counts * (a1 * a2) + (a1 * g2) * row + (g1 * a2) * col + g1 * g2 * r


def _scores_float(q, k, dtype=torch.float32):
    """Grouped scores in ``dtype`` (float32, or a bf16 product through
    ``float_einsum``): q (B,S,H,dh) x k (B,T,kvH,dh) -> (B,H,S,T), head
    ``h`` against kv head ``h // (H / kvH)``."""
    b, s, h, dh = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, s, kvh, h // kvh, dh).to(dtype)
    out = L.float_einsum("bskgd,btkd->bkgst", qg, k.to(dtype))
    return out.reshape(b, h, s, k.shape[1])


def _scores_dtype(cfg: ArchConfig) -> torch.dtype:
    """The full-sequence scores' dtype, ``cfg.attn_scores_dtype``."""
    return torch.bfloat16 if cfg.attn_scores_dtype == "bf16" else torch.float32


def _full_probs(scores, mask, dh: int, sdt: torch.dtype):
    """The full-sequence probabilities as the reference takes them:
    ``softmax(scores.astype(sdt) / sqrt(sdt(dh)) + mask.astype(sdt))``."""
    sqrt_dh = torch.sqrt(scalar(float(dh), sdt, scores.device))
    return L.softmax(scores.to(sdt) / sqrt_dh + mask.to(sdt))


def _pv_float(probs, v, dtype):
    """Grouped context in ``dtype``: probs (B,H,S,T) x v (B,T,kvH,dh) ->
    (B,S,H,dh)."""
    b, h, s, t = probs.shape
    kvh = v.shape[2]
    pg = probs.reshape(b, kvh, h // kvh, s, t).to(dtype)
    ctx = L.float_einsum("bkgst,btkd->bskgd", pg, v.to(dtype))
    return ctx.reshape(b, s, h, v.shape[3])


def _mask(s_q: int, s_k: int, causal: bool, window: int, device) -> torch.Tensor:
    """(s_q, s_k) additive mask for a prefill starting at position 0; a
    nonzero ``window`` keeps only the last ``window`` positions."""
    qi = torch.arange(s_q, device=device)[:, None]
    kj = torch.arange(s_k, device=device)[None, :]
    ok = torch.ones((s_q, s_k), dtype=torch.bool, device=device)
    if causal:
        ok &= kj <= qi
    if window:
        ok &= kj > qi - window
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(ok, zero, torch.full_like(zero, _NEG_INF))


def _write_prefill_cache(cache, k_m, v_m, s, windowed, k_sc, k_off, v_sc, v_off) -> None:
    """Write prefilled rows into the cache, in place.

    A ring (``windowed``) that the prompt fills keeps the last ``cache_len``
    tokens, absolute position ``p`` in row ``p % cache_len``; otherwise the
    rows go to ``[pos, pos + s)``.  All batch rows share row 0's cursor
    (prefill runs on a freshly reset cache)."""
    cache_len = cache["k"].shape[1]
    dev = k_m.device
    if windowed and s >= cache_len:
        idx = torch.arange(s - cache_len, s, device=dev) % cache_len
        k_m, v_m = k_m[:, s - cache_len:], v_m[:, s - cache_len:]
    else:
        idx = cache["pos"][0].to(torch.int64) + torch.arange(s, device=dev)
    cache["k"].index_copy_(1, idx, k_m)
    cache["v"].index_copy_(1, idx, v_m)
    cache["pos"] += s
    if k_sc is not None:
        for key, val in (("k_scale", k_sc), ("k_offset", k_off), ("v_scale", v_sc), ("v_offset", v_off)):
            cache[key].copy_(val)


def _decode_valid(pos: torch.Tensor, t: int, window: int, windowed: bool) -> torch.Tensor:
    """(B, t) cache rows a decode at per-row position ``pos`` (B,) attends to.

    A ring's row ``j`` holds absolute position ``j + t * floor((pos - j) /
    t)`` once this step's row is written; elsewhere row ``j`` is position
    ``j``, limited to the last ``window`` positions when ``window`` is set."""
    j = torch.arange(t, device=pos.device)[None, :]
    posc = pos[:, None]
    if windowed:
        slot_abs = j + t * torch.div(posc - j, t, rounding_mode="floor")
        return (slot_abs >= 0) & (slot_abs > posc - window) & (slot_abs <= posc)
    valid = j <= posc
    if window:
        valid &= j > posc - window
    return valid


def attention(
    p: dict,
    x: torch.Tensor,
    cfg: ArchConfig,
    kind: str,
    positions: torch.Tensor,
    cache: Optional[dict] = None,
    kv_override: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    causal: Optional[bool] = None,
    mode: str = "serve",
) -> Tuple[torch.Tensor, Optional[dict]]:
    """One GQA mixer application (``mode`` ``"serve"`` or ``"train"``).

    x: (B, S, D); positions: (B, S) absolute positions.  With a cache,
    ``S > 1`` is a prefill from an empty cache and ``S == 1`` a decode step
    at each row's own cursor, which attends to every cached position up to
    its own.  With ``cache=None`` the whole sequence attends over its own
    keys and values and nothing is stored.  A prefill or stateless pass is
    causal as ``causal`` says (default ``cfg.causal``); ``kind`` ``"l"``
    limits attention to the last ``cfg.window_size`` positions.

    ``kv_override=(k, v)``, each (B, T, kvH, dh), is cross-attention onto
    an encoder's T rows: float scores and context, no rope, no cache.  A
    bf16 cache, or quantized linears with ``quantize_attention=False``, take
    the same float scores and context (over the int8 cache dequantized).
    Returns (out (B, S, D), cache), the cache updated in place.

    ``mode="train"`` takes no cache: the float full-sequence path over
    the in-flight keys and values or ``kv_override``'s, with q, k and the
    probabilities fake-quantized under quantized attention.
    """
    _check_supported(cfg, kind)
    train = mode == "train"
    if train and cache is not None:
        raise ValueError("train mode is full-sequence attention without a cache")
    if mode not in ("serve", "train"):
        raise ValueError(f"unknown mode {mode!r}")
    quant = cfg.quant
    h, kvh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    b, s, _ = x.shape
    bits = quant.attn_act_bits
    causal = cfg.causal if causal is None else causal
    window = cfg.window_size if kind == "l" else 0

    q = L.qlinear(p["q"], x, quant, mode=mode, name="attn.q").reshape(b, s, h, dh)
    if kv_override is None:
        k = L.qlinear(p["k"], x, quant, mode=mode, name="attn.k").reshape(b, s, kvh, dh)
        v = L.qlinear(p["v"], x, quant, mode=mode, name="attn.v").reshape(b, s, kvh, dh)
    else:
        k, v = kv_override
    if cfg.qk_norm:
        q = L.rmsnorm(p["q_norm"], q, cfg.norm_eps)
        if kv_override is None:
            k = L.rmsnorm(p["k_norm"], k, cfg.norm_eps)
    # learned and sinusoidal positions were added to x at the input
    if cfg.pos_embedding == "rope" and kv_override is None:
        theta = cfg.local_rope_theta if kind == "l" and cfg.local_rope_theta else cfg.rope_theta
        q = L.rope(q, positions, theta)
        k = L.rope(k, positions, theta)
    sqrt_dh = torch.sqrt(scalar(float(dh), torch.float32, x.device))
    quantized = cache is not None and "k_scale" in cache
    # integer scores and P.V: quantized attention over the in-flight k / v
    # or an int8 cache; else float, over a bf16 or dequantized int8 cache
    use_int = (not train and quant.enabled and quant.quantize_attention and kv_override is None
               and (cache is None or quantized))
    # bitwise scores where "attn.qk" names a scores-only backend (and the
    # cache, if any, holds packed K rows)
    qk_backend = _binary_scores_site(quant, "attn.qk")
    qk_name = quant.backend_for("attn.qk")  # the site log's record
    use_binary = use_int and qk_backend is not None and (cache is None or _cache_binary(cache, dh))
    # a local layer's cache is a ring when it holds exactly the window
    windowed = cache is not None and kind == "l" and 0 < cfg.window_size == cache["k"].shape[1]

    sdt = _scores_dtype(cfg)
    if kv_override is not None or (not use_int and (s > 1 or cache is None)):
        # cross-attention, a float prefill / stateless pass, or training
        fake = train and quant.enabled and quant.quantize_attention
        qf, kf = (Q.fake_quant(q, bits), Q.fake_quant(k, bits)) if fake else (q, k)
        mask = _mask(s, k.shape[1], causal, window, x.device)
        probs = _full_probs(_scores_float(qf, kf, sdt), mask, dh, sdt)
        if fake:
            probs = Q.fake_quant(probs, bits)
        ctx = _pv_float(probs, v, x.dtype)
        if cache is not None and kv_override is None:
            if quantized:
                k_sc, k_off = _calibrate_rows(k)
                v_sc, v_off = _calibrate_rows(v)
                k_m, v_m = _quantize_to_cache(k, k_sc, k_off), _quantize_to_cache(v, v_sc, v_off)
            else:
                k_m, v_m = k.to(cache["k"].dtype), v.to(cache["v"].dtype)
                k_sc = k_off = v_sc = v_off = None
            _write_prefill_cache(cache, k_m, v_m, s, windowed, k_sc, k_off, v_sc, v_off)
    elif s > 1 or cache is None:
        v_sc, v_off = _calibrate_rows(v)
        v_m = _quantize_to_cache(v, v_sc, v_off)
        if use_binary:
            kq = _binarize_rows(k)
            k_sc, k_off = kq.scale.reshape(b), kq.offset.reshape(b)
            k_m = packing.pack_bits(kq.mantissa, 1, axis=-1)
            scores = _scores_binary(q, k_m.permute(0, 2, 1, 3), k_sc, k_off, dh, qk_backend)
        else:
            k_sc, k_off = _calibrate_rows(k)
            k_m = _quantize_to_cache(k, k_sc, k_off)
            scores = _scores_int(q, k_m, k_sc, k_off, bits, qk_name)
        probs = _full_probs(scores, _mask(s, s, causal, window, x.device), dh, sdt)
        ctx = _pv_int(probs.to(torch.float32), v_m, v_sc, v_off)
        if cache is not None:
            _write_prefill_cache(cache, k_m, v_m, s, windowed, k_sc, k_off, v_sc, v_off)
    else:
        # each row writes at, and attends up to, its own cursor
        cache_len = cache["k"].shape[1]
        pos = cache["pos"].to(torch.int64)  # a copy: the cursor advances below
        slot = pos % cache_len if windowed else pos
        rows = torch.arange(b, device=x.device)
        if quantized:
            k_sc, k_off = cache["k_scale"], cache["k_offset"]
            v_sc, v_off = cache["v_scale"], cache["v_offset"]
            write_k = _binarize_to_cache if use_binary else _quantize_to_cache
            k_row, v_row = write_k(k, k_sc, k_off), _quantize_to_cache(v, v_sc, v_off)
        else:
            k_row, v_row = k.to(cache["k"].dtype), v.to(cache["v"].dtype)
        cache["k"].index_put_((rows, slot), k_row[:, 0])
        cache["v"].index_put_((rows, slot), v_row[:, 0])
        cache["pos"] += 1
        valid = _decode_valid(pos, cache_len, window, windowed)
        if use_binary:
            k_t = cache["k"].permute(0, 2, 1, 3)  # (B,kvH,T,dw), read in place
            scores = _scores_binary(q, k_t, k_sc, k_off, dh, qk_backend) / sqrt_dh
        elif use_int:
            scores = _scores_int(q, cache["k"], k_sc, k_off, bits, qk_name) / sqrt_dh
        else:
            src_k, src_v = cache["k"], cache["v"]
            if quantized:
                src_k = _dequantize_from_cache(src_k, k_sc, k_off, x.dtype)
                src_v = _dequantize_from_cache(src_v, v_sc, v_off, x.dtype)
            scores = _scores_float(q, src_k) / sqrt_dh
        scores = torch.where(
            valid[:, None, None, :], scores, torch.full_like(scores, _NEG_INF)
        )
        probs = L.softmax(scores)
        ctx = _pv_int(probs, cache["v"], v_sc, v_off) if use_int else _pv_float(probs, src_v, x.dtype)

    ctx = ctx.reshape(b, s, h * dh).to(x.dtype)
    return L.qlinear(p["o"], ctx, quant, mode=mode, name="attn.o"), cache


# ---------------------------------------------------------------------------
# MLA -- multi-head latent attention (deepseek v2/v3)
# ---------------------------------------------------------------------------


def init_mla(gen: torch.Generator, cfg: ArchConfig) -> dict:
    """Projections of the latent attention: q directly (``q_proj``) or
    through a low-rank ``q_down`` / RMSNorm / ``q_up`` when
    ``mla.q_lora_rank``; the latent ``kv_down`` and its norm, the shared
    rope key ``k_rope``, the up-projections ``k_up`` / ``v_up`` and ``o``."""
    m, d, h = cfg.mla, cfg.d_model, cfg.n_heads
    qd = m.qk_nope_dim + m.qk_rope_dim

    def zeros(n):
        return torch.zeros((n,), dtype=torch.float32, device=gen.device)

    p = {}
    if m.q_lora_rank:
        p["q_down"] = L.init_linear(gen, d, m.q_lora_rank)
        p["q_norm_lora"] = zeros(m.q_lora_rank)
        p["q_up"] = L.init_linear(gen, m.q_lora_rank, h * qd)
    else:
        p["q_proj"] = L.init_linear(gen, d, h * qd)
    p["kv_down"] = L.init_linear(gen, d, m.kv_lora_rank)
    p["kv_norm"] = zeros(m.kv_lora_rank)
    p["k_rope"] = L.init_linear(gen, d, m.qk_rope_dim)
    p["k_up"] = L.init_linear(gen, m.kv_lora_rank, h * m.qk_nope_dim)
    p["v_up"] = L.init_linear(gen, m.kv_lora_rank, h * m.v_head_dim)
    p["o"] = L.init_linear(gen, h * m.v_head_dim, d, scale=0.5)
    return p


def init_mla_cache(batch: int, max_len: int, cfg: ArchConfig, device="cuda") -> dict:
    """The latent cache: ``ckv`` int8 (re-centered mantissas) with per-row
    ``ckv_scale`` / ``ckv_offset`` where the config quantizes its cache,
    else bf16; a bf16 ``k_rope`` and the per-row cursor ``pos``."""
    m = cfg.mla
    shape = (batch, max_len, m.kv_lora_rank)
    if not _quantized_cache(cfg.quant):
        ckv = {"ckv": torch.zeros(shape, dtype=torch.bfloat16, device=device)}
    else:
        f32 = dict(dtype=torch.float32, device=device)
        ckv = {
            "ckv": torch.zeros(shape, dtype=torch.int8, device=device),
            "ckv_scale": torch.ones((batch,), **f32),
            "ckv_offset": torch.zeros((batch,), **f32),
        }
    return {
        **ckv,
        "k_rope": torch.zeros((batch, max_len, m.qk_rope_dim), dtype=torch.bfloat16, device=device),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def _mla_q(p, x, cfg: ArchConfig, positions, mode: str = "serve"):
    """Queries -> (q_nope (B,S,H,dn), q_rope (B,S,H,dr) rotated)."""
    m, h = cfg.mla, cfg.n_heads
    if m.q_lora_rank:
        qc = L.qlinear(p["q_down"], x, cfg.quant, mode=mode, name="attn.q_down")
        qc = L.rmsnorm(p["q_norm_lora"], qc, cfg.norm_eps)
        q = L.qlinear(p["q_up"], qc, cfg.quant, mode=mode, name="attn.q_up")
    else:
        q = L.qlinear(p["q_proj"], x, cfg.quant, mode=mode, name="attn.q")
    q = q.reshape(*x.shape[:-1], h, m.qk_nope_dim + m.qk_rope_dim)
    q_nope, q_rope = q[..., : m.qk_nope_dim], q[..., m.qk_nope_dim :]
    return q_nope, L.rope(q_rope, positions, cfg.rope_theta)


def _serving_dense(p: dict, k: int, quant: QuantConfig) -> torch.Tensor:
    """A small packed weight ``(k, N)`` back in float32 (the absorbed
    decode's up-projections)."""
    wq = Q.QuantTensor(
        mantissa=p["w_packed"], scale=p["w_scale"], offset=p["w_offset"],
        bits=quant.weight_bits, packed=True, packed_axis=0, length=k,
    )
    m = wq.unpack(dtype=torch.float32).mantissa
    return m * wq.scale.to(torch.float32) + wq.offset.to(torch.float32)


def _scores_int_latent(q_abs, ckv_m, ckv_scale, ckv_offset, attn_bits: int, backend: str = "auto"):
    """Absorbed scores as one act x act integer product against the
    head-shared latent cache, heads folded into M: ``(b, s*h, r) x (b, r,
    t)``.  q_abs (B,S,H,R) float, quantized per row; ``backend`` is the
    site's configured name (the site log's record only); returns float32
    (B,H,S,T)."""
    b, s, h, r = q_abs.shape
    t = ckv_m.shape[1]
    qq = Q.quantize_activation(q_abs.to(torch.float32), attn_bits, per_channel_axis=0)
    qr = Q.recenter(qq)
    if site_log.is_recording():
        site_log.record(kind="attn", site="attn.qk_latent", bits=attn_bits,
                        mantissa_dtype=site_log.dtype_name(qr.mantissa.dtype), backend=backend)
    x1 = qr.mantissa.reshape(b, s * h, r)
    x2 = ckv_m.transpose(-1, -2)  # (b, r, t)
    xy = FA.default_int_matmul(x1, x2, attn_bits, 8).to(torch.float32)
    a1 = qr.scale.reshape(b, 1, 1)
    g1 = qr.offset.reshape(b, 1, 1)
    a2 = _per_row(ckv_scale, 3)
    g2 = _per_row(ckv_offset, 3) + 128.0 * a2  # cache mantissa re-centered by 128
    row = torch.sum(x1, dim=-1, dtype=torch.int32)[..., None].to(torch.float32)
    col = torch.sum(x2, dim=-2, dtype=torch.int32)[..., None, :].to(torch.float32)
    out = xy * (a1 * a2) + (a1 * g2) * row + (g1 * a2) * col + g1 * g2 * r
    return out.reshape(b, s, h, t).permute(0, 2, 1, 3)


def _pv_int_latent(p_probs, ckv_m, ckv_scale, ckv_offset):
    """Absorbed context as an act x act integer product ``P (B,H,S,T) @
    ckv (B,T,R)``, heads folded into M; probabilities on the W8 grid
    (scale 1/255, re-centered by 128).  Returns float32 (B,S,H,R)."""
    b, h, s, t = p_probs.shape
    r = ckv_m.shape[-1]
    pm = torch.clamp(torch.round(p_probs * 255.0), 0.0, 255.0)
    x1 = (pm - 128.0).to(torch.int8).permute(0, 2, 1, 3).reshape(b, s * h, t)
    dev = p_probs.device
    a1 = scalar(1.0 / 255.0, torch.float32, dev)
    g1 = scalar(128.0 / 255.0, torch.float32, dev)
    a2 = _per_row(ckv_scale, 3)
    g2 = _per_row(ckv_offset, 3) + 128.0 * a2
    xy = FA.default_int_matmul(x1, ckv_m, 8, 8).to(torch.float32)
    row = torch.sum(x1, dim=-1, dtype=torch.int32)[..., None].to(torch.float32)
    col = torch.sum(ckv_m, dim=-2, dtype=torch.int32)[..., None, :].to(torch.float32)
    out = xy * (a1 * a2) + (a1 * g2) * row + (g1 * a2) * col + g1 * g2 * t
    return out.reshape(b, s, h, r)


def _write_latent(cache: dict, c_m, r_u, s: int) -> None:
    """Write the latent (in the cache's form) and rope key in place: a prefill (``s >
    1``) at row 0's cursor (it runs on a freshly reset cache), a decode
    step each row at its own cursor; then advance the cursors."""
    if s > 1:
        idx = cache["pos"][0].to(torch.int64) + torch.arange(s, device=c_m.device)
        cache["ckv"].index_copy_(1, idx, c_m)
        cache["k_rope"].index_copy_(1, idx, r_u)
    else:
        rows = torch.arange(c_m.shape[0], device=c_m.device)
        slot = cache["pos"].to(torch.int64)
        cache["ckv"].index_put_((rows, slot), c_m[:, 0])
        cache["k_rope"].index_put_((rows, slot), r_u[:, 0])
    cache["pos"] += s


def _mla_decompressed(p, x, ckv, q_nope, q_rope, k_rope, cfg: ArchConfig, scale, mode: str):
    """The full-sequence form over the in-flight latent ``ckv`` (B, S, R):
    keys and values up-projected through ``qlinear``, the scores in
    ``cfg.attn_scores_dtype`` (two products summed, then scaled and masked
    in that dtype), the causal mask, a float P.V in the activation dtype.
    In train mode under quantized attention q_nope, k_nope and the
    probabilities are fake-quantized at ``attn_act_bits``.  Returns the
    context (B, S, H * v_head_dim)."""
    m, h, quant = cfg.mla, cfg.n_heads, cfg.quant
    b, s, _ = x.shape
    sdt = _scores_dtype(cfg)
    k_nope = L.qlinear(p["k_up"], ckv, quant, mode=mode, name="attn.k_up").reshape(b, s, h, m.qk_nope_dim)
    v = L.qlinear(p["v_up"], ckv, quant, mode=mode, name="attn.v_up").reshape(b, s, h, m.v_head_dim)
    fake = mode == "train" and quant.enabled and quant.quantize_attention
    if fake:
        q_nope = Q.fake_quant(q_nope, quant.attn_act_bits)
        k_nope = Q.fake_quant(k_nope, quant.attn_act_bits)
    scores = (
        L.float_einsum("bshd,bthd->bhst", q_nope.to(sdt), k_nope.to(sdt))
        + L.float_einsum("bshd,btd->bhst", q_rope.to(sdt), k_rope.to(sdt))
    ) * scale.to(sdt)
    scores = scores + _mask(s, s, cfg.causal, 0, x.device).to(sdt)
    probs = L.softmax(scores)
    if fake:
        probs = Q.fake_quant(probs, quant.attn_act_bits)
    ctx = L.float_einsum("bhst,bthd->bshd", probs.to(x.dtype), v)
    return ctx.reshape(b, s, h * m.v_head_dim)


def mla_attention(
    p: dict, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor, cache: Optional[dict],
    mode: str = "serve",
) -> Tuple[torch.Tensor, Optional[dict]]:
    """One MLA mixer application over the latent cache (int8 or bf16), or,
    in train mode, over the whole sequence without one.

    ``S > 1`` is a prefill from an empty cache in the decompressed form:
    keys and values up-projected from the float latent through ``qlinear``,
    float32 scores, the causal mask; the prompt's
    latent calibrates the row's cache affine.  ``S == 1`` is a decode step
    in the absorbed form: q_nope folded through ``k_up`` (dequantized when
    packed), the integer score and context products against an int8 cache
    under quantized attention (``_scores_int_latent`` / ``_pv_int_latent``)
    or float32 ones against the cache's values otherwise, and the context
    unfolded through ``v_up``.  Returns (out (B, S, D), cache), the cache
    updated in place.

    ``mode="train"`` takes no cache: the decompressed form over the whole
    sequence (``_mla_decompressed``) on latent weights, every projection a
    train-mode ``qlinear``; returns (out, None).
    """
    train = mode == "train"
    if train and cache is not None:
        raise ValueError("train mode is full-sequence attention without a cache")
    if mode not in ("serve", "train"):
        raise ValueError(f"unknown mode {mode!r}")
    m, h = cfg.mla, cfg.n_heads
    b, s, _ = x.shape
    quant = cfg.quant
    dev = x.device
    qd = m.qk_nope_dim + m.qk_rope_dim
    scale = torch.div(scalar(1.0, torch.float32, dev), torch.sqrt(scalar(float(qd), torch.float32, dev)))

    q_nope, q_rope = _mla_q(p, x, cfg, positions, mode)
    ckv = L.qlinear(p["kv_down"], x, quant, mode=mode, name="attn.kv_down")
    ckv = L.rmsnorm(p["kv_norm"], ckv, cfg.norm_eps)
    k_rope = L.qlinear(p["k_rope"], x, quant, mode=mode, name="attn.k_rope")  # (B, S, dr)
    k_rope = L.rope(k_rope, positions, cfg.rope_theta)
    if train:
        ctx = _mla_decompressed(p, x, ckv, q_nope, q_rope, k_rope, cfg, scale, mode)
        return L.qlinear(p["o"], ctx.to(x.dtype), quant, mode=mode, name="attn.o"), None

    quantized = "ckv_scale" in cache
    if not quantized:
        c_m = ckv.to(cache["ckv"].dtype)
    else:
        if s > 1:
            sc, off = _calibrate_rows(ckv)
            cache["ckv_scale"].copy_(sc)
            cache["ckv_offset"].copy_(off)
        else:
            sc, off = cache["ckv_scale"], cache["ckv_offset"]
        c_m = _quantize_to_cache(ckv, sc, off)
    _write_latent(cache, c_m, k_rope.to(cache["k_rope"].dtype), s)

    if s == 1:
        # ---- absorbed decode over the latent cache
        t = cache["ckv"].shape[1]
        w_uk, w_uv = (
            (p[n]["w"] if "w" in p[n] else _serving_dense(p[n], m.kv_lora_rank, quant)).to(torch.float32)
            for n in ("k_up", "v_up")
        )
        w_uk = w_uk.reshape(m.kv_lora_rank, h, m.qk_nope_dim)
        w_uv = w_uv.reshape(m.kv_lora_rank, h, m.v_head_dim)
        q_abs = torch.einsum("bshd,rhd->bshr", q_nope.to(torch.float32), w_uk)
        use_int = quantized and quant.quantize_attention
        lat_backend = _binary_scores_site(quant, "attn.qk_latent")
        if use_int and lat_backend is not None:
            scores_lat = _scores_binary_latent(q_abs, cache["ckv"], sc, off, lat_backend)
        elif use_int:
            scores_lat = _scores_int_latent(q_abs, cache["ckv"], sc, off, quant.attn_act_bits,
                                            quant.backend_for("attn.qk_latent"))
        else:
            ckv_all = cache["ckv"]
            if quantized:
                ckv_all = _dequantize_from_cache(ckv_all, sc, off, torch.float32)
            ckv_all = ckv_all.to(torch.float32)
            scores_lat = torch.einsum("bshr,btr->bhst", q_abs, ckv_all)
        scores_rope = torch.einsum(
            "bshd,btd->bhst", q_rope.to(torch.float32), cache["k_rope"].to(torch.float32)
        )
        scores = (scores_lat + scores_rope) * scale
        valid = torch.arange(t, device=dev)[None, :] < cache["pos"].reshape(-1, 1)
        scores = torch.where(valid[:, None, None, :], scores, torch.full_like(scores, _NEG_INF))
        probs = L.softmax(scores)
        if use_int:
            ctx_lat = _pv_int_latent(probs, cache["ckv"], sc, off)
        else:
            ctx_lat = torch.einsum("bhst,btr->bshr", probs, ckv_all)
        ctx = torch.einsum("bshr,rhd->bshd", ctx_lat, w_uv)
    else:
        ctx = _mla_decompressed(p, x, ckv, q_nope, q_rope, k_rope, cfg, scale, mode)
    ctx = ctx.reshape(b, s, h * m.v_head_dim).to(x.dtype)
    return L.qlinear(p["o"], ctx, quant, name="attn.o"), cache
