"""mamba2-130m -- attention-free SSM with SSD (state-space duality) mixers.

[arXiv:2405.21060; unverified]  24L d_model=768 vocab=50280 tied,
d_state=128, expand=2 (d_inner 1536), head_dim=64 (24 SSD heads), conv
width 4, chunk 128.  Every layer is an ``"s"`` block (norm + mixer, no
FFN); no positions and no attention, so ``quantize_attention=False`` is
never consulted.  Same values as ``repro/configs/mamba2_130m.py``.
"""

from repro_torch.configs.base import ArchConfig, QuantConfig, SSMConfig, register

CONFIG = register(
    ArchConfig(
        name="mamba2-130m",
        family="ssm",
        n_layers=24,
        d_model=768,
        n_heads=24,  # SSD heads (d_inner / head_dim)
        n_kv_heads=24,
        d_head=64,
        d_ff=0,  # no separate FFN in mamba2 blocks
        vocab_size=50280,
        pattern_period=("s",),
        ffn_type="gelu",
        pos_embedding="none",
        tie_embeddings=True,
        ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1),
        quant=QuantConfig(act_bits=8, attn_act_bits=8, quantize_attention=False),
        max_seq=1 << 20,
        source="[arXiv:2405.21060; unverified]",
    )
)
