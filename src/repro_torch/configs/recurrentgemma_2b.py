"""recurrentgemma-2b -- hybrid RG-LRU + local attention, 1 attention : 2 recurrent.

[arXiv:2402.19427; hf]  26L d_model=2560 10H (MQA kv=1) d_head=256
d_ff=7680 (gelu-glu) vocab=256000 tied, local-attention window 2048,
period (r, r, l).  26 = 3*8 + 2 -> period x8 after an (r, r) prefix.  An
``"r"`` layer's recurrence is d_model wide.  Same values as
``repro/configs/recurrentgemma_2b.py``.
"""

from repro_torch.configs.base import ArchConfig, QuantConfig, register

CONFIG = register(
    ArchConfig(
        name="recurrentgemma-2b",
        family="hybrid",
        n_layers=26,
        d_model=2560,
        n_heads=10,
        n_kv_heads=1,
        d_head=256,
        d_ff=7680,
        vocab_size=256000,
        prefix_layers=("r", "r"),
        pattern_period=("r", "r", "l"),
        window_size=2048,
        ffn_type="gelu_glu",
        pos_embedding="rope",
        rope_theta=10000.0,
        tie_embeddings=True,
        quant=QuantConfig(act_bits=8, attn_act_bits=8),
        max_seq=1 << 20,
        source="[arXiv:2402.19427; hf]",
    )
)
