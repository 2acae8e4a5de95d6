"""granite-8b: llama-architecture dense decoder (IBM Granite code models).

[arXiv:2405.04324; hf]  36L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=49152, tied embeddings, rope_theta=1e7.  Same values as
``repro/configs/granite_8b.py``.
"""

from repro_torch.configs.base import ArchConfig, QuantConfig, register

CONFIG = register(
    ArchConfig(
        name="granite-8b",
        family="dense",
        n_layers=36,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_head=128,
        d_ff=14336,
        vocab_size=49152,
        pattern_period=("g",),
        ffn_type="silu_glu",
        rope_theta=10000000.0,
        tie_embeddings=True,
        quant=QuantConfig(act_bits=8, attn_act_bits=8),
        max_seq=131072,
        source="[arXiv:2405.04324; hf]",
    )
)
