"""Public model API of the port (counterpart of ``repro.models.model_zoo``),
serving subset for dense GQA decoders -- global (``"g"``) and
sliding-window (``"l"``) layers, as granite-8b, mistral-nemo-12b, qwen3-32b
and gemma3-27b have them --, bidirectional encoders (bit-bert-base:
learned positions, non-causal prefill), the deepseek family (MLA layers
``"Md"`` / ``"Mm"``, the latter with a mixture of experts) and the
recurrent families (RG-LRU layers ``"r"`` beside local attention in
recurrentgemma-2b, SSD layers ``"s"`` in mamba2-130m).

Params are plain dicts: ``{"embedding", "final_norm", "layers": [block,
...]}``, plus ``"unembedding"`` when the embeddings are untied and
``"pos_embedding"`` ``(max_seq, d)`` for learned positions, with one block
per layer in ``cfg.layer_kinds`` order (the reference's scanned ``period``
stack, unstacked).  An MoE block's routed experts are rank-3 ``(E, K, N)``
linears, packed along K; its router stays float32 (``{"w"}``), as the
reference keeps it; a recurrent block's float leaves (``conv_w``,
``A_log``, ``D``, ``dt_bias``, ``norm_g``, ``lambda_p``) stay float32.
deepseek-v3's multi-token-prediction head serves only the reference's
training loss, so serving params carry none.  Caches are ``{"layers":
[cache, ...]}``, one per layer: an int8 KV cache, an MLA layer's latent
cache (``ckv``, ``k_rope``), or a recurrent layer's state (``models/ssm.py``:
``h`` / ``ssm`` and ``conv``, no rows axis); a ``"l"`` layer's cache holds
``min(max_len, window_size)`` rows (its ring buffer), every other
attention layer's ``max_len`` (``cache_rows``).  Every layer's cursor
``pos`` is absolute, so a decode step reads its positions from layer 0's,
whatever its kind.

Entry points:

* ``init_params(seed, cfg)``           -- latent float32 params
* ``prepare_serving_params(params)``   -- binarize, bit-pack, colsums
* ``init_serving_params(seed, cfg)``   -- the two above one layer at a time,
  so a full-width model never holds every latent weight at once
* ``init_cache`` / ``init_slot_cache`` / ``cache_insert`` / ``cache_reset``
* ``cache_rows`` / ``cache_geometry`` -- each layer's rows for a
  ``max_len`` (None for a recurrent layer's state), and the ``(batch,
  rows)`` a cache holds
* ``cache_copy`` / ``caches_equal`` -- a snapshot of a cache, and bitwise
  equality of two
* ``prefill`` (exact length) / ``decode_step``

Caches are updated IN PLACE: ``prefill``, ``decode_step``, ``cache_insert``
and ``cache_reset`` return the dict they were given, mutated.  Entry points
that create tensors take ``device="cuda"`` unless the caller asks for the
CPU.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import transformer as T

__all__ = [
    "init_params",
    "prepare_serving_params",
    "init_serving_params",
    "check_max_len",
    "cache_rows",
    "cache_geometry",
    "init_cache",
    "init_slot_cache",
    "cache_insert",
    "cache_reset",
    "cache_copy",
    "caches_equal",
    "prefill",
    "decode_step",
]


def _generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


#: top-level float tables, kept full precision and cast to bf16 for serving
_TABLES = ("embedding", "unembedding", "pos_embedding")


def check_max_len(cfg: ArchConfig, max_len: int) -> None:
    """Learned positions index a ``(max_seq, d)`` table, so no cache may hold
    more than ``cfg.max_seq`` positions: past it the reference's gather
    clamps, and an index on the card faults."""
    if cfg.pos_embedding == "learned" and max_len > cfg.max_seq:
        raise ValueError(
            f"max_len {max_len} exceeds {cfg.name}'s max_seq {cfg.max_seq} "
            "(learned positions)"
        )


def _init_top(gen: torch.Generator, cfg: ArchConfig) -> dict:
    """Embedding, untied unembedding and learned positions (std 0.02 each,
    drawn in that order) and the final norm gain."""
    def table(rows: int) -> torch.Tensor:
        return torch.randn((rows, cfg.d_model), generator=gen, device=gen.device) * 0.02

    top = {
        "embedding": table(cfg.vocab_size),
        "final_norm": torch.zeros((cfg.d_model,), dtype=torch.float32, device=gen.device),
    }
    if not cfg.tie_embeddings:
        top["unembedding"] = table(cfg.vocab_size)
    if cfg.pos_embedding == "learned":
        top["pos_embedding"] = table(cfg.max_seq)
    return top


def _serving_top(params: dict) -> dict:
    """The top-level leaves for serving: tables in bf16, the rest as they are."""
    return {
        k: v.to(torch.bfloat16) if k in _TABLES else v
        for k, v in params.items()
        if k != "layers"
    }


def init_params(seed: int, cfg: ArchConfig, device="cuda") -> dict:
    """Latent float32 params from ``torch.Generator(device).manual_seed(seed)``."""
    gen = _generator(seed, device)
    p = _init_top(gen, cfg)
    p["layers"] = [T.init_block(gen, cfg, kind) for kind in cfg.layer_kinds]
    return p


#: linears kept full precision in serving (the reference's ``_FP_LEAF_PATHS``)
_FP_LINEARS = ("router",)


def _pack_site(node: dict, cfg: ArchConfig) -> dict:
    """One latent linear ``{"w"}``: rank 2 packs as a linear, rank 3 as
    stacked experts."""
    if node["w"].ndim == 3:
        return M.pack_experts_for_serving(node, cfg.quant)
    return L.pack_linear_for_serving(node, cfg.quant)


def _pack_tree(node, cfg: ArchConfig, path=()):
    if isinstance(node, dict):
        if set(node) == {"w"}:
            if any(k in path for k in _FP_LINEARS):
                return {"w": node["w"].to(torch.float32)}
            return _pack_site(node, cfg)
        return {k: _pack_tree(v, cfg, path + (k,)) for k, v in node.items()}
    if isinstance(node, list):
        return [_pack_tree(v, cfg, path) for v in node]
    return node


def prepare_serving_params(params: dict, cfg: ArchConfig) -> dict:
    """Binarize and bit-pack every linear (stacked experts per expert);
    the embedding, unembedding and position tables go to bf16, norm gains
    and the MoE router stay float32, as in the reference."""
    out = _serving_top(params)
    out["layers"] = _pack_tree(params["layers"], cfg)
    return out


def init_serving_params(seed: int, cfg: ArchConfig, device="cuda") -> dict:
    """Serving params built one layer at a time: each layer's latent
    weights are drawn, packed at once and freed, so the peak holds one
    layer of float32 latents (about 0.9 GB at granite-8b width, 1.65 GB at
    gemma3-27b's) besides the packed model.  An MoE layer's routed experts
    are packed one site as soon as it is drawn (a (64, 2048, 1408) float32
    site is 0.74 GB at deepseek-v2-lite-16b's width)."""
    gen = _generator(seed, device)
    out = _serving_top(_init_top(gen, cfg))
    out["layers"] = []
    for kind in cfg.layer_kinds:
        block = T.init_block(gen, cfg, kind, site=lambda p: _pack_site(p, cfg))
        out["layers"].append(_pack_tree(block, cfg))
    return out


def cache_rows(max_len: int, cfg: ArchConfig) -> list:
    """Rows of each layer's cache, in layer order, for ``max_len``
    positions; None for a recurrent layer, whose state has no rows."""
    return [None if kind in T.RECURRENT_KINDS else A.cache_rows(max_len, cfg, kind)
            for kind in cfg.layer_kinds]


def _layer_geometry(layer: dict) -> tuple:
    for rows in ("ckv", "k"):
        if rows in layer:
            return tuple(layer[rows].shape[:2])
    return (layer["pos"].shape[0], None)


def cache_geometry(cache: dict) -> list:
    """``(batch, rows)`` of each layer's cache, in layer order, read from
    the layer's own rows: ``ckv`` for an MLA layer, ``k`` for a GQA one; a
    recurrent layer's state has no rows, ``(batch, None)``."""
    return [_layer_geometry(layer) for layer in cache["layers"]]


def init_cache(batch: int, max_len: int, cfg: ArchConfig, device="cuda") -> dict:
    check_max_len(cfg, max_len)
    return {
        "layers": [
            T.init_block_cache(batch, max_len, cfg, kind, device=device)
            for kind in cfg.layer_kinds
        ]
    }


def init_slot_cache(max_len: int, cfg: ArchConfig, device="cuda") -> dict:
    """A batch-1 cache for ``cache_insert``; shares ``max_len`` with the
    packed cache so every leaf lines up except the batch axis (ring layers
    included: their rows follow from ``max_len``)."""
    return init_cache(1, max_len, cfg, device=device)


def cache_insert(cache: dict, slot_cache: dict, slot: int) -> dict:
    """Copy a batch-1 ``slot_cache`` into row ``slot`` of a packed cache, in
    place -- including the per-row cursor and calibration affines, and a
    recurrent layer's whole state."""
    for dst, src in zip(cache["layers"], slot_cache["layers"]):
        idx = torch.tensor([slot], device=dst["pos"].device)
        for key, leaf in dst.items():
            leaf.index_copy_(0, idx, src[key].to(leaf.dtype))
    return cache


def cache_reset(cache: dict, slot: int, cfg: ArchConfig, max_len: int) -> dict:
    """Reset row ``slot`` (cursor 0, identity affines, zero mantissas and
    recurrent state)."""
    device = cache["layers"][0]["pos"].device
    return cache_insert(cache, init_slot_cache(max_len, cfg, device=device), slot)


def cache_copy(cache: dict) -> dict:
    """A copy of every leaf of ``cache``, at new addresses."""
    return {"layers": [{k: v.clone() for k, v in layer.items()} for layer in cache["layers"]]}


def caches_equal(a: dict, b: dict) -> bool:
    """Whether two caches hold the same leaves, bit for bit and of the same
    dtypes."""
    return len(a["layers"]) == len(b["layers"]) and all(
        x.keys() == y.keys() and all(x[k].dtype == y[k].dtype and torch.equal(x[k], y[k]) for k in x)
        for x, y in zip(a["layers"], b["layers"])
    )


def _embed_inputs(params: dict, tokens: torch.Tensor, cfg: ArchConfig, positions) -> torch.Tensor:
    """Scaled bf16 token embedding plus, for learned positions, the bf16
    position rows added in bf16 (``positions`` < ``cfg.max_seq``: the
    caches are sized so)."""
    x = L.embed(params, tokens, cfg.d_model)
    if cfg.pos_embedding == "learned":
        x = x + params["pos_embedding"][positions].to(x.dtype)
    return x.to(torch.bfloat16)


def prefill(params: dict, tokens: torch.Tensor, cfg: ArchConfig, cache: dict) -> Tuple[torch.Tensor, dict]:
    """Process whole prompts (exact length, no padding) from an empty cache.

    tokens: (B, S) int.  Returns (last-position logits (B, V) float32, cache).
    """
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device).broadcast_to(b, s)
    x = _embed_inputs(params, tokens, cfg, positions)
    x, _ = T.stack_apply(params["layers"], x, cfg, positions, cache["layers"])
    x = L.rmsnorm(params["final_norm"], x[:, -1:], cfg.norm_eps)
    return L.unembed(params, x, cfg.tie_embeddings)[:, 0], cache


def decode_step(params: dict, tokens: torch.Tensor, cfg: ArchConfig, cache: dict) -> Tuple[torch.Tensor, dict]:
    """One decode step.  tokens (B,) -> logits (B, V) float32 + cache."""
    b = tokens.shape[0]
    # a copy: the first layer advances its cursor in place
    positions = cache["layers"][0]["pos"].to(torch.int64, copy=True).reshape(b, 1)
    x = _embed_inputs(params, tokens[:, None], cfg, positions)
    x, _ = T.stack_apply(params["layers"], x, cfg, positions, cache["layers"])
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return L.unembed(params, x, cfg.tie_embeddings)[:, 0], cache
