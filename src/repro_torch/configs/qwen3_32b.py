"""qwen3-32b -- dense GQA decoder with qk-norm.

[hf:Qwen/Qwen3-8B; hf]  64L d_model=5120 64H (GQA kv=8) d_ff=25600
vocab=151936, head_dim=128, per-head RMSNorm on q and k before rope.
Same values as ``repro/configs/qwen3_32b.py``.
"""

from repro_torch.configs.base import ArchConfig, QuantConfig, register

CONFIG = register(
    ArchConfig(
        name="qwen3-32b",
        family="dense",
        n_layers=64,
        d_model=5120,
        n_heads=64,
        n_kv_heads=8,
        d_head=128,
        d_ff=25600,
        vocab_size=151936,
        pattern_period=("g",),
        qk_norm=True,
        ffn_type="silu_glu",
        rope_theta=1000000.0,
        quant=QuantConfig(act_bits=8, attn_act_bits=8),
        max_seq=131072,
        source="[hf:Qwen/Qwen3-8B; hf]",
    )
)
