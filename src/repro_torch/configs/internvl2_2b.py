"""internvl2-2b -- InternViT frontend (stub) + InternLM2-1.8b LM backbone.

[arXiv:2404.16821; hf]  24L d_model=2048 16H (GQA kv=8) d_ff=8192
vocab=92553, untied.  The vision frontend is a STUB: the caller supplies
precomputed patch embeddings (InternViT-300M's 1024-dim pooled patches for
one 448x448 tile -> 256 tokens), which one float projection maps over the
first 256 positions of the prompt.  Same values as
``repro/configs/internvl2_2b.py``.
"""

from repro_torch.configs.base import ArchConfig, EncoderConfig, QuantConfig, register

CONFIG = register(
    ArchConfig(
        name="internvl2-2b",
        family="vlm",
        n_layers=24,
        d_model=2048,
        n_heads=16,
        n_kv_heads=8,
        d_ff=8192,
        vocab_size=92553,
        pattern_period=("g",),
        ffn_type="silu_glu",
        rope_theta=1000000.0,
        tie_embeddings=False,
        encoder=EncoderConfig(kind="patch_stub", n_positions=256, d_input=1024),
        quant=QuantConfig(act_bits=8, attn_act_bits=8),
        max_seq=32768,
        source="[arXiv:2404.16821; hf]",
    )
)
