"""Block assembly (port of ``repro.models.transformer``), serve mode.

The reference scans one stacked ``period`` of params with ``lax.scan``;
here the stack is a Python loop over per-layer param dicts, in
``cfg.layer_kinds`` order (the prefix layers, then each period in turn).
Block kinds ``"g"`` (global attention) and ``"l"`` (sliding-window
attention), each with a dense FFN.  Pre-norm residual blocks (RMSNorm).
"""

from __future__ import annotations

from typing import List

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L

__all__ = ["init_block", "block_apply", "stack_apply"]


def init_block(gen: torch.Generator, cfg: ArchConfig, kind: str) -> dict:
    if kind not in ("g", "l"):
        raise NotImplementedError(f"block kind {kind!r} is not ported yet (only 'g', 'l')")
    d = cfg.d_model
    zeros = dict(dtype=torch.float32, device=gen.device)
    return {
        "ln1": torch.zeros((d,), **zeros),
        "attn": A.init_attention(gen, cfg),
        "ln2": torch.zeros((d,), **zeros),
        "ffn": L.init_ffn(gen, cfg.ffn_type, d, cfg.d_ff),
    }


def block_apply(p: dict, x, cfg: ArchConfig, kind: str, positions, cache: dict):
    """Pre-norm residual block.  Returns (x, cache) (cache updated in place)."""
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    mix, cache = A.attention(p["attn"], h, cfg, kind, positions, cache)
    x = x + mix
    h = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + L.ffn(p["ffn"], h, cfg.ffn_type, cfg.quant), cache


def stack_apply(layers: List[dict], x, cfg: ArchConfig, positions, caches: List[dict]):
    """Apply every layer in order; returns (x, caches)."""
    for p, kind, c in zip(layers, cfg.layer_kinds, caches):
        x, _ = block_apply(p, x, cfg, kind, positions, c)
    return x, caches
