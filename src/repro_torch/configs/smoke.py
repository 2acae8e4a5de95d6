"""Reduced smoke variants (port of ``repro.configs.smoke``) for CPU tests:
the dense-decoder, MLA, MoE, SSM and encoder branches of the reference."""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig, EncoderConfig, MLAConfig, MoEConfig, SSMConfig


def smoke_variant(cfg: ArchConfig) -> ArchConfig:
    """Shrink a full config to laptop scale, keeping its block pattern
    (one period + prefix), head grouping ratio and feature set."""
    n_layers = len(cfg.prefix_layers) + len(cfg.pattern_period)
    heads = max(2, min(cfg.n_heads, 4))
    kv = max(1, heads * cfg.n_kv_heads // cfg.n_heads)
    changes = dict(
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
    if cfg.mla is not None:
        changes["mla"] = MLAConfig(
            kv_lora_rank=16,
            q_lora_rank=8 if cfg.mla.q_lora_rank else 0,
            qk_nope_dim=16,
            qk_rope_dim=8,
            v_head_dim=16,
        )
    if cfg.moe is not None:
        changes["moe"] = MoEConfig(
            n_routed=8,
            n_shared=min(cfg.moe.n_shared, 2),
            top_k=2,
            d_expert_ff=32,
            router_scoring=cfg.moe.router_scoring,
            route_scale=cfg.moe.route_scale,
        )
    if cfg.ssm is not None:
        changes["ssm"] = SSMConfig(
            d_state=16, d_conv=4, expand=2, head_dim=16, n_groups=1, chunk=16
        )
        changes["n_heads"] = (changes["d_model"] * 2) // 16
        changes["n_kv_heads"] = changes["n_heads"]
        changes["d_ff"] = 0
    if cfg.encoder is not None:
        changes["encoder"] = EncoderConfig(
            kind=cfg.encoder.kind,
            n_positions=12,
            n_layers=min(cfg.encoder.n_layers, 2),
            d_input=24 if cfg.encoder.d_input else 0,
        )
    return dataclasses.replace(cfg, **changes)
