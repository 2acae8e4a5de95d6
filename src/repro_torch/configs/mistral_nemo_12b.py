"""mistral-nemo-12b -- dense GQA decoder, 128k context.

[hf:mistralai/Mistral-Nemo-Base-2407; hf]  40L d_model=5120 32H (GQA kv=8)
d_ff=14336 vocab=131072, head_dim=128 (explicit -- 32*128 != 5120),
rope theta 1e6.  Same values as ``repro/configs/mistral_nemo_12b.py``.
"""

from repro_torch.configs.base import ArchConfig, QuantConfig, register

CONFIG = register(
    ArchConfig(
        name="mistral-nemo-12b",
        family="dense",
        n_layers=40,
        d_model=5120,
        n_heads=32,
        n_kv_heads=8,
        d_head=128,
        d_ff=14336,
        vocab_size=131072,
        pattern_period=("g",),
        ffn_type="silu_glu",
        rope_theta=1000000.0,
        quant=QuantConfig(act_bits=8, attn_act_bits=8),
        max_seq=131072,
        source="[hf:mistralai/Mistral-Nemo-Base-2407; hf]",
    )
)
