"""Reduced smoke variants (port of ``repro.configs.smoke``) for CPU tests.

Only the dense-decoder branch is ported: the reference's MLA / MoE / SSM /
encoder shrinking has no counterpart until those families are ported.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig


def smoke_variant(cfg: ArchConfig) -> ArchConfig:
    """Shrink a full config to laptop scale, keeping its block pattern
    (one period + prefix), head grouping ratio and feature set."""
    n_layers = len(cfg.prefix_layers) + len(cfg.pattern_period)
    heads = max(2, min(cfg.n_heads, 4))
    kv = max(1, heads * cfg.n_kv_heads // cfg.n_heads)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=n_layers,
        d_model=64,
        n_heads=heads,
        n_kv_heads=kv,
        d_head=16,
        d_ff=max(1, 128 if cfg.d_ff else 0),
        vocab_size=256,
        window_size=8 if cfg.window_size else 0,
        max_seq=128,
    )
